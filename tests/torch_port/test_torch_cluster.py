"""The port's `SimCluster` / `run_workload` against the reference's, bit for
bit, on analytic clusters (deterministic virtual service times).

Each case builds the same seeded cluster and router in both packages (the
port's on the CPU), drives the same closed loop through `run_workload` and
requires equal metrics, per-record agent / payment / cost / hits / latency
/ quality / tokens, equal accounts and the same settlement-ledger head:

* IEMAS with ``mcmf``, ``dense`` and ``dense-torch`` (the reference's
  ``dense-jax``) at 1 and 2 hubs, warm starts on and off;
* every baseline of `BASELINES`;
* every strategic policy of `POLICIES` through `AdversaryMix`;
* failures and stragglers (the cluster's draw order);
* elastic ``add_agent`` / ``remove_agent`` mid-run.

Real engines: one ``SimCluster.execute`` pair on weights carried from the
reference's engine gives the same tokens, hits, cost and quality, and a
3-agent real-mode run of the port completes with a warm cache and a
non-negative surplus.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _serving_parity import PORT_SOLVER, assert_same_run  # noqa: E402
from repro.configs import iemas_cluster as ref_cfg  # noqa: E402
from repro.core import mechanism as ref_mech  # noqa: E402
from repro.core.adversary import AdversaryMix as RefMix  # noqa: E402
from repro.core.baselines import BASELINES as REF_BASELINES  # noqa: E402
from repro.serving import cluster as ref_cluster  # noqa: E402
from repro.serving import workload as ref_wl  # noqa: E402
from repro_torch.configs import iemas_cluster as port_cfg  # noqa: E402
from repro_torch.core import mechanism as port_mech  # noqa: E402
from repro_torch.core.adversary import POLICIES, AdversaryMix  # noqa: E402
from repro_torch.core.baselines import BASELINES  # noqa: E402
from repro_torch.models.carry import params_from_reference  # noqa: E402
from repro_torch.serving import cluster as port_cluster  # noqa: E402
from repro_torch.serving import workload as port_wl  # noqa: E402

N_AGENTS = 6
LOOP = {"max_new_tokens": 3, "batch_per_round": 4, "max_rounds": 3000}


def _dialogues(wl, workloads, n_dialogues, seed):
    """``n_dialogues`` scripts of each workload family, interleaved (two
    families put two domains, so two hubs, in each batch)."""
    per = [wl.generate(wl.WorkloadSpec(name, n_dialogues, seed=seed))
           for name in workloads]
    return [d for group in zip(*per) for d in group]


def _both(cluster_kw=None, router=("iemas", {}), n_dialogues=5,
          workloads=("coqa_like", "hotpot_like"), seed=0, mix=None,
          on_round=None):
    """One seeded closed-loop run in each package; returns two
    (metrics, cluster, router) triples, the reference's first."""
    out = []
    for pkg, cl, wl, baselines, mix_cls in (
            ("ref", ref_cluster, ref_wl, REF_BASELINES, RefMix),
            ("port", port_cluster, port_wl, BASELINES, AdversaryMix)):
        kw = dict(n_agents=N_AGENTS, seed=seed, max_new_tokens=3,
                  engine_mode="analytic", **(cluster_kw or {}))
        if mix is not None:
            kw["adversary_mix"] = mix_cls(**mix)
        if pkg == "port":
            kw["device"] = "cpu"
        cluster = cl.SimCluster(**kw)
        name, rkw = router
        if name == "iemas":
            rkw = dict(rkw)
            if pkg == "port":
                rkw["solver"] = PORT_SOLVER.get(rkw["solver"], rkw["solver"])
            r = cl.make_router(cluster, audit_ledger=True, **rkw)
        else:
            r = baselines[name](cluster.agent_infos(), seed=seed)
        dialogues = _dialogues(wl, workloads, n_dialogues, seed + 1)
        cb = None if on_round is None else (
            lambda n, c, r=r, pkg=pkg: on_round(n, c, r, pkg))
        m = cl.run_workload(cluster, r, dialogues, on_round=cb, **LOOP)
        out.append((m, cluster, r))
    return out


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("hubs", [1, 2])
@pytest.mark.parametrize("solver", ["mcmf", "dense", "dense-jax"])
def test_iemas_run_workload_matches_reference(solver, hubs, warm):
    ref, port = _both(router=("iemas", {"solver": solver, "n_hubs": hubs,
                                        "warm_start": warm}))
    assert ref[0]["n"] > 0 and not ref[0]["truncated"]
    assert_same_run(ref, port, solver=solver)
    if warm and solver != "mcmf":
        assert port[0]["warm_start"]["warm_hits"] > 0


@pytest.mark.parametrize("name", sorted(REF_BASELINES))
def test_baselines_match_reference(name):
    assert sorted(BASELINES) == sorted(REF_BASELINES)
    ref, port = _both(router=(name, {}), n_dialogues=6)
    assert ref[0]["n"] > 0
    assert_same_run(ref, port)
    assert port[2].name == name


@pytest.mark.parametrize("policy", POLICIES)
def test_adversaries_match_reference(policy):
    mix = {"policy": policy, "fraction": 0.34, "theta": 0.4, "seed": 3}
    ref, port = _both(router=("iemas", {"solver": "dense", "n_hubs": 2,
                                        "warm_start": True}), mix=mix,
                      n_dialogues=6)
    assert sorted(ref[1].adversaries) == sorted(port[1].adversaries) != []
    assert_same_run(ref, port)
    assert ref[2].pool.reputations() == port[2].pool.reputations()


def test_faults_and_stragglers_match_reference():
    ref, port = _both(cluster_kw={"fail_prob": 0.15, "straggle_prob": 0.2},
                      router=("iemas", {"solver": "dense", "n_hubs": 2}),
                      n_dialogues=6, seed=4)
    assert ref[2].settlement.audit(ref[2].accounts)["faults"] > 0
    assert_same_run(ref, port)


def test_elastic_membership_matches_reference():
    """An agent leaves at round 3 and a new one joins at round 6, told to
    both the cluster and the router (hub recut, cold price book)."""
    def on_round(n, cluster, router, pkg):
        if n == 3:
            cluster.remove_agent("agent-1", router)
        elif n == 6:
            cfg = ref_cfg if pkg == "ref" else port_cfg
            cluster.add_agent(cfg.agent_profiles(N_AGENTS + 1)[-1], router)

    ref, port = _both(router=("iemas", {"solver": "dense", "n_hubs": 2,
                                        "warm_start": True}),
                      n_dialogues=6, on_round=on_round)
    for _, cluster, router in (ref, port):
        assert "agent-1" not in cluster.agents
        assert [a.agent_id for a in router.agents][-1] == f"agent-{N_AGENTS}"
    assert_same_run(ref, port)


def test_make_router_takes_the_cluster_device():
    cluster = port_cluster.SimCluster(3, engine_mode="analytic",
                                      device="cpu")
    router = port_cluster.make_router(cluster)
    assert router.device == torch.device("cpu") == cluster.device
    assert router.solver == "cuda"      # the port's RouterConfig default


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cuda_cluster_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cluster.SimCluster(3, engine_mode="analytic")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cluster.SimCluster(1, engine_mode="real")


def test_real_execute_matches_reference_on_carried_weights():
    """A fresh turn then its extension through ``SimCluster.execute`` on one
    llama3-7b-class agent: the reference's JAX engine and the port's CPU
    engine on the same weights give the same tokens, hits, cost and
    quality (latency is measured wall clock, so it is not compared)."""
    kw = dict(n_agents=1, seed=0, max_new_tokens=3, engine_mode="real")
    ref = ref_cluster.SimCluster(**kw)
    port = port_cluster.SimCluster(device="cpu", **kw)
    for aid, rt in port.agents.items():
        rt.engine.params = params_from_reference(
            jax.device_get(ref.agents[aid].engine.params))
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, 255, 37).astype(np.int32)
    got = {"ref": [], "port": []}
    for turn in range(2):
        for tag, cl, mech in (("ref", ref, ref_mech), ("port", port,
                                                       port_mech)):
            req = mech.Request(f"r{turn}", "d0", prompt, turn=turn,
                               domain="dialogue", max_new_tokens=3,
                               meta={"difficulty": 0.4})
            dec = mech.RouteDecision(req, "agent-0", 0.5, None, 1.0, 0)
            rec = cl.execute(dec, router=None)
            got[tag].append((rec.output_tokens.tolist(), rec.n_prompt,
                             rec.n_hit, rec.n_gen, rec.cost, rec.quality))
        prompt = np.concatenate([prompt, np.asarray(got["ref"][-1][0],
                                                    np.int32),
                                 rng.integers(1, 255, 9).astype(np.int32)])
    assert got["ref"] == got["port"]
    assert got["port"][1][2] > 0            # the extension hit the cache


def test_real_mode_run_completes_on_cpu():
    cluster = port_cluster.SimCluster(3, seed=0, max_new_tokens=3,
                                      device="cpu")
    router = port_cluster.make_router(cluster, audit_ledger=True)
    dialogues = port_wl.generate(port_wl.WorkloadSpec("coqa_like", 3,
                                                      seed=1))
    m = port_cluster.run_workload(cluster, router, dialogues,
                                  max_new_tokens=3)
    assert not m["truncated"] and m["n"] == m["completed_turns"] > 0
    assert m["kv_hit_rate"] > 0.5
    assert router.accounts["surplus"] >= 0
    # the replay audit raises on any divergence from the booked accounts
    assert router.settlement.audit(router.accounts)["settled"] == m["n"]

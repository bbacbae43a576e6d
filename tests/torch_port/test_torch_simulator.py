"""The port's event-driven simulator against the reference's, bit for bit,
on analytic clusters.

Each case runs the same seeded `EventSimulator` (the port's router on the
CPU) in both packages and requires equal metrics — every key except the
wall-clock ones, left out by name: ``wall_time_s``,
``routing.routing_wall_s``, ``routing.overhead_frac`` and each profiler
phase's ``wall_s`` / ``frac_of_engine`` — equal records, accounts and
settlement-ledger head.  Cases: open-loop Poisson and synchronous
arrivals, the quantised synchronous run against `run_workload`, both DAG
workloads (parent sessions through the engines and the router), the
incremental mode, the admission window and a truncated run.
"""
import warnings

import pytest

torch = pytest.importorskip("torch")

from _serving_parity import (assert_same_run, comparable,  # noqa: E402
                             records)
from repro import serving as ref_serving  # noqa: E402
from repro.core import mechanism as ref_mech  # noqa: E402
from repro_torch import serving as port_serving  # noqa: E402
from repro_torch.core import mechanism as port_mech  # noqa: E402

PACKAGES = (("ref", ref_serving, ref_mech), ("port", port_serving, port_mech))


def _sim_both(*, workload="coqa_like", n_dialogues=10, arrivals="poisson",
              rate=6.0, n_agents=6, router_kw=None, cluster_kw=None,
              expect_warning=False, **sim_kw):
    """One seeded `EventSimulator` run in each package; returns two
    (metrics, cluster, router) triples, the reference's first."""
    out = []
    for pkg, sv, mech in PACKAGES:
        kw = dict(n_agents=n_agents, seed=2, max_new_tokens=3,
                  engine_mode="analytic", **(cluster_kw or {}))
        if pkg == "port":
            kw["device"] = "cpu"
        cluster = sv.SimCluster(**kw)
        rkw = {"solver": "dense", "n_hubs": 2, "warm_start": True,
               "audit_ledger": True, **(router_kw or {})}
        if pkg == "port":
            rkw["device"] = "cpu"
        router = mech.IEMASRouter(cluster.agent_infos(), **rkw)
        spec = sv.WorkloadSpec(workload, n_dialogues, seed=7)
        arr = (sv.PoissonArrivals(rate=rate, seed=11) if arrivals == "poisson"
               else sv.SyncArrivals())
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            m = sv.EventSimulator(cluster, router, sv.iter_dialogues(spec),
                                  arrivals=arr, max_new_tokens=3,
                                  profiler=sv.RoutingProfiler(),
                                  **sim_kw).run()
        assert any(issubclass(w.category, RuntimeWarning)
                   for w in caught) == expect_warning
        out.append((m, cluster, router))
    return out


@pytest.mark.parametrize("solver", ["mcmf", "dense"])
@pytest.mark.parametrize("arrivals", ["poisson", "sync"])
def test_event_simulator_matches_reference(arrivals, solver):
    ref, port = _sim_both(arrivals=arrivals, router_kw={"solver": solver},
                          batch_cap=6, batch_window=0.02)
    m = port[0]
    assert m["dialogues_completed"] == 10 and not m["truncated"]
    assert m["routing"]["empty_route_calls"] == 0
    # the wall-clock keys are there (and left out of the comparison)
    assert "wall_time_s" in m and "routing_wall_s" in m["routing"]
    assert_same_run(ref, port)


def test_quantised_sync_run_matches_run_workload():
    """Synchronous arrivals on round ticks: the port's simulator gives the
    port's closed loop's decisions, and both give the reference's."""
    sims = _sim_both(arrivals="sync", batch_cap=4, quantize=0.05,
                     max_rounds=3000)
    loops = []
    for pkg, sv, mech in PACKAGES:
        cluster = sv.SimCluster(n_agents=6, seed=2, max_new_tokens=3,
                                engine_mode="analytic",
                                **({"device": "cpu"} if pkg == "port"
                                   else {}))
        router = mech.IEMASRouter(
            cluster.agent_infos(), solver="dense", n_hubs=2,
            warm_start=True, audit_ledger=True,
            **({"device": "cpu"} if pkg == "port" else {}))
        m = sv.run_workload(cluster, router, sv.generate(
            sv.WorkloadSpec("coqa_like", 10, seed=7)), max_rounds=3000,
            max_new_tokens=3, batch_per_round=4)
        loops.append((m, cluster, router))
    assert_same_run(*loops)
    for (m_sim, c_sim, _), (m_loop, c_loop, _) in zip(sims, loops):
        assert records(c_sim) == records(c_loop)
        for key in ("n", "kv_hit_rate", "latency_ms_mean", "cost_mean",
                    "quality_mean", "completed_turns",
                    "dispatched_requests"):
            assert m_sim[key] == m_loop[key], key
    assert_same_run(*sims)


@pytest.mark.parametrize("workload", ["dag_orchestrator", "dag_handoff"])
def test_dag_workloads_match_reference(workload):
    ref, port = _sim_both(workload=workload, n_dialogues=6, rate=4.0,
                          batch_cap=8)
    assert port[0]["dialogues_completed"] == 6
    assert any(r.request.meta.get("parent_sessions")
               for r in port[1].records)
    assert_same_run(ref, port)


def test_incremental_mode_matches_reference():
    ref, port = _sim_both(incremental=True, batch_cap=6, rate=8.0)
    assert port[0]["incremental_dispatched"] > 0
    assert port[2].accounts["incremental_routed"] > 0
    assert_same_run(ref, port)


def test_admission_window_matches_reference():
    ref, port = _sim_both(n_dialogues=12, rate=20.0, max_inflight=3,
                          batch_cap=4)
    assert port[0]["peak_inflight"] == 3
    assert_same_run(ref, port)


def test_truncation_matches_reference():
    ref, port = _sim_both(max_rounds=6, batch_cap=4, expect_warning=True)
    assert port[0]["truncated"] and port[0]["unfinished_dialogues"] > 0
    assert comparable(ref[0]) == comparable(port[0])
    assert_same_run(ref, port)


def test_simulate_workload_profiles_by_default():
    cluster = port_serving.SimCluster(4, max_new_tokens=3,
                                      engine_mode="analytic", device="cpu")
    router = port_serving.make_router(cluster, solver="dense")
    m = port_serving.simulate_workload(
        cluster, router, port_serving.generate(
            port_serving.WorkloadSpec("coqa_like", 3, seed=1)))
    phases = m["routing"]["phases"]
    assert {"route_batch", "phase1_predict", "phase2_solve[dense]",
            "phase4_feedback"} <= set(phases)
    assert m["routing"]["route_requests"] == m["dispatched_requests"]

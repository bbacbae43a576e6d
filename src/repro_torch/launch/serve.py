"""Serving launcher of the port: IEMAS (or a baseline) routing over the
simulated cluster, on the card.

``python -m repro_torch.launch.serve --router iemas --workload coqa_like``

The port of the reference's ``python -m repro.launch.serve``: the same flags,
checks and printed JSON keys, with the port's names where they differ —
``--solver`` takes the port's registry (``cuda``, the default and the
staged column auction as one CUDA launch per solve; ``dense-torch``;
``dense``; ``mcmf``, the reference's default), ``--predictor-backend
torch`` is the reference's ``jax``, and ``--device {cuda,cpu}`` (default
``cuda``) says where the real engines and the router run.  Without a card
``--device cuda`` raises; nothing moves to the CPU unless asked.

Two serving loops:

  * ``--sim-mode closed`` (default) — the closed-loop `run_workload` round
    loop over real engines (`repro_torch.serving.engine.AgentEngine` on
    the attention kernels): the bit-comparable small-run oracle.
  * ``--sim-mode event`` — the event-driven open-loop
    `repro_torch.serving.simulator.EventSimulator`: Poisson arrivals at
    ``--arrival-rate``, streaming admission (``--max-inflight``), analytic
    engines by default, and a `RoutingProfiler` report attributing routing
    wall-clock per phase against simulated engine compute.  Scale example::

        python -m repro_torch.launch.serve --sim-mode event --agents 128 \\
            --n-dialogues 10000 --arrival-rate 96 --hubs 8 --warm-start

``--super-hubs K`` (event mode) federates the simulator itself: K
super-hub shards, each with its own router (on ``--device``), price book
and event heap, advance independently and synchronize every ``--epoch``
virtual seconds via price-book gossip, cross-super-hub spill and
exactly-once dialogue migration (`repro_torch.serving.federation`);
``--federation-parallel process`` gives each shard its own process (and,
on the card, its own CUDA context).  Federation scale example (the
SCALE_1K preset's shape)::

    python -m repro_torch.launch.serve --sim-mode event --agents 1024 \\
        --n-dialogues 100000 --arrival-rate 768 --warm-start \\
        --super-hubs 8 --epoch 0.5 --federation-parallel process \\
        --max-inflight 2048
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core.adversary import POLICIES, AdversaryMix
from repro_torch.core.baselines import BASELINES
from repro_torch.core.mechanism import IEMASRouter
from repro_torch.core.solvers import available_solvers
from repro_torch.serving import (DAG_WORKLOADS, EventSimulator,
                                 RoutingProfiler, SimCluster, WorkloadSpec,
                                 build_federation, generate, iter_dialogues,
                                 load_trace, make_arrivals, run_workload)


def build_router(name: str, infos, *, n_hubs: int = 1, payment_mode="warmstart",
                 solver: str = "cuda", warm_start: bool = False,
                 spill: bool = True, batched: bool = True,
                 predictor_backend: str = "numpy", seed: int = 0,
                 reputation: bool = True, audit_ledger: bool = False,
                 fused: bool = False, explore_bonus: float = 0.0,
                 device="cuda"):
    """Build the IEMAS router on ``device`` (or a named baseline, which
    runs on the host) over ``infos``."""
    if name == "iemas":
        kw = {}
        if explore_bonus:
            kw["predictor_kw"] = {"explore": explore_bonus}
        return IEMASRouter(infos, n_hubs=n_hubs, payment_mode=payment_mode,
                           solver=solver, warm_start=warm_start, spill=spill,
                           batched=batched,
                           predictor_backend=predictor_backend,
                           reputation=reputation, audit_ledger=audit_ledger,
                           fused=fused, device=device, **kw)
    return BASELINES[name](infos, seed=seed)


def main(argv=None) -> dict:
    """Parse CLI flags (``argv``, default ``sys.argv[1:]``), build
    cluster+router, run one serving simulation; prints the metrics JSON and
    returns the metrics."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--router", default="iemas",
                    choices=["iemas", *BASELINES])
    ap.add_argument("--workload", default="coqa_like")
    ap.add_argument("--agents", type=int, default=9)
    ap.add_argument("--dialogues", "--n-dialogues", dest="dialogues",
                    type=int, default=16)
    ap.add_argument("--sim-mode", default="closed",
                    choices=["closed", "event"],
                    help="closed: lockstep run_workload oracle loop; "
                         "event: open-loop event-driven simulator "
                         "(repro_torch.serving.simulator) with per-phase "
                         "routing "
                         "overhead attribution")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="event mode: Poisson dialogue arrivals per virtual "
                         "second (default: synchronous, all at t=0)")
    ap.add_argument("--trace-file", default=None,
                    help="event mode: replay arrival timestamps from a file "
                         "(one virtual-second float per line, # comments "
                         "allowed); overrides --arrival-rate")
    ap.add_argument("--max-inflight", type=int, default=256,
                    help="event mode: streaming-admission window (max "
                         "concurrently active dialogues)")
    ap.add_argument("--batch-cap", type=int, default=16,
                    help="event mode: micro-batch size per router call")
    ap.add_argument("--batch-window", type=float, default=0.02,
                    help="event mode: batching delay in virtual seconds")
    ap.add_argument("--fused", action="store_true",
                    help="run the whole routing step (affinity, prediction, "
                         "values, column auction) as one device step "
                         "(core/routing_fused); needs --hubs 1 and a staged "
                         "solver (cuda or dense-torch)")
    ap.add_argument("--incremental", action="store_true",
                    help="event mode: newly ready work bids into the "
                         "standing per-agent duals and dispatches "
                         "provisionally instead of waiting out the "
                         "batch window (needs --warm-start)")
    ap.add_argument("--super-hubs", type=int, default=1,
                    help="event mode: shard the fleet into K super-hubs, "
                         "each with its own router/price-book/event heap "
                         "advancing independently between epochs "
                         "(serving/federation.py); 1 = the single-heap "
                         "EventSimulator (bit-exact oracle)")
    ap.add_argument("--epoch", type=float, default=0.25,
                    help="federation: virtual seconds between "
                         "synchronization boundaries (price-book gossip, "
                         "cross-super-hub spill, dialogue migration)")
    ap.add_argument("--federation-parallel", default="inline",
                    choices=["inline", "process"],
                    help="federation: advance shards inline, or give each "
                         "super-hub its own OS process with the epoch "
                         "advances overlapped (bit-identical either way)")
    ap.add_argument("--explore-bonus", type=float, default=0.0,
                    help="optimism bonus on predicted quality, "
                         "explore/sqrt(1+n_obs): breaks KV-affinity "
                         "entrenchment of cold-start mismatches "
                         "(0.0 = exact no-op)")
    ap.add_argument("--engine-mode", default=None,
                    choices=["real", "analytic"],
                    help="engine backend (default: real in closed mode, "
                         "analytic in event mode)")
    ap.add_argument("--hubs", type=int, default=1,
                    help="shard Phase 2 across K proxy hubs (§4.4); each "
                         "batch is auctioned per hub block")
    ap.add_argument("--solver", default="cuda",
                    choices=available_solvers(),
                    help="Phase-2 backend from the core/solvers registry "
                         "(cuda: the staged column auction, one CUDA launch "
                         "per solve, its plain version for a CPU router; "
                         "mcmf: the reference's default)")
    ap.add_argument("--warm-start", action="store_true",
                    help="seed each hub's dense auction from the previous "
                         "round's slot prices (cold-starts on membership "
                         "changes; warm-start-capable solvers only)")
    ap.add_argument("--no-spill", action="store_true",
                    help="disable the cross-hub spill re-auction of "
                         "requests a saturated hub left unmatched")
    ap.add_argument("--payment-mode", default="warmstart",
                    choices=["warmstart", "naive"])
    ap.add_argument("--scalar-phase1", action="store_true",
                    help="per-pair scalar QoS loop (oracle) instead of the "
                         "batched Phase-1 tensor path")
    ap.add_argument("--predictor-backend", default="numpy",
                    choices=["numpy", "torch"],
                    help="Phase-1b forests: NumPy on the host, or torch "
                         "float32 on the router's device (the reference's "
                         "jax)")
    ap.add_argument("--adversary", default="none",
                    choices=["none", *POLICIES],
                    help="inject a strategic-agent population "
                         "(core/adversary.py): published-profile/QoS "
                         "misreports or membership churn, on a seeded "
                         "fraction of the fleet")
    ap.add_argument("--adversary-fraction", type=float, default=0.25,
                    help="fleet fraction assigned the adversary policy")
    ap.add_argument("--adversary-theta", type=float, default=0.4,
                    help="adversary intensity (price/quality misreport "
                         "magnitude)")
    ap.add_argument("--audit-ledger", action="store_true",
                    help="attach the append-only hash-chained settlement "
                         "ledger (core/ledger.py); the report includes "
                         "verify_chain + the replay audit")
    ap.add_argument("--no-reputation", action="store_true",
                    help="disable reputation-weighted priors (the audit "
                         "residual no longer decays an inflating agent's "
                         "predicted QoS)")
    ap.add_argument("--fail-prob", type=float, default=0.0)
    ap.add_argument("--straggle-prob", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the real engines and the router run (cuda "
                         "raises without a card)")
    args = ap.parse_args(argv)

    if args.fused:
        from repro_torch.core.routing_fused import FUSED_SOLVERS
        if args.router != "iemas":
            ap.error("--fused is an IEMAS routing path; baselines have no "
                     "fused step")
        if args.hubs != 1 or args.solver not in FUSED_SOLVERS:
            ap.error("--fused runs one global device-resident column market; "
                     "pass --hubs 1 with a staged solver "
                     f"({', '.join(FUSED_SOLVERS)})")
        if args.incremental:
            ap.error("--fused batches whole rounds through one program and "
                     "cannot dispatch provisionally; drop --incremental")
    if args.super_hubs > 1:
        if args.sim_mode != "event":
            ap.error("--super-hubs federates the event-driven simulator; "
                     "pass --sim-mode event")
        if args.router != "iemas":
            ap.error("federation shards the IEMAS router's price books; "
                     "baselines run single-heap only")
        if args.fused:
            ap.error("--fused runs one global device-resident market and "
                     "cannot be sharded across super-hub event heaps; "
                     "drop one of the two")
        if args.adversary != "none":
            ap.error("--adversary seeds its population over one global "
                     "cluster; strategic-agent studies run single-heap")
    if args.incremental:
        from repro_torch.core.solvers import get_solver
        if args.sim_mode != "event":
            ap.error("--incremental requires --sim-mode event")
        if not (args.warm_start
                and get_solver(args.solver).supports_warm_start):
            ap.error("--incremental bids into the standing per-agent duals "
                     "and would silently route nothing without them; pass "
                     "--warm-start with a warm-capable solver "
                     "(e.g. --solver dense)")

    engine_mode = args.engine_mode or (
        "analytic" if args.sim_mode == "event" else "real")
    spec = WorkloadSpec(args.workload, n_dialogues=args.dialogues,
                        seed=args.seed + 1)
    if args.workload in DAG_WORKLOADS and args.sim_mode != "event":
        ap.error(f"workload {args.workload!r} is a workflow DAG; precedence "
                 f"scheduling needs --sim-mode event")
    arrivals = None
    if args.sim_mode == "event":
        if args.trace_file:
            arrivals = make_arrivals("trace",
                                     trace=load_trace(args.trace_file))
        else:
            arrivals = make_arrivals(
                "poisson" if args.arrival_rate else "sync",
                rate=args.arrival_rate or 8.0, seed=args.seed + 2)

    if args.super_hubs > 1:
        # hubs-of-hubs: the federation builds its own per-shard
        # cluster/router/loop triples on --device (serving/federation.py)
        rkw = dict(payment_mode=args.payment_mode, solver=args.solver,
                   warm_start=args.warm_start, spill=not args.no_spill,
                   batched=not args.scalar_phase1,
                   predictor_backend=args.predictor_backend,
                   reputation=not args.no_reputation,
                   audit_ledger=args.audit_ledger)
        if args.hubs != 1:      # default: recut each shard by agents_per_hub
            rkw["n_hubs"] = args.hubs
        if args.explore_bonus:
            rkw["predictor_kw"] = {"explore": args.explore_bonus}
        fed = build_federation(
            iter_dialogues(spec), n_agents=args.agents,
            super_hubs=args.super_hubs, arrivals=arrivals, seed=args.seed,
            engine_mode=engine_mode, max_inflight=args.max_inflight,
            router_kwargs=rkw,
            loop_kwargs=dict(batch_cap=args.batch_cap,
                             batch_window=args.batch_window,
                             incremental=args.incremental, lean=True),
            cluster_kwargs=dict(fail_prob=args.fail_prob,
                                straggle_prob=args.straggle_prob),
            epoch=args.epoch, parallel=args.federation_parallel,
            device=args.device)
        metrics = fed.run()
        print(json.dumps(metrics, indent=2, default=float))
        if args.json:
            with open(args.json, "w") as f:
                json.dump(metrics, f, indent=2, default=float)
        return metrics

    mix = None
    if args.adversary != "none":
        mix = AdversaryMix(policy=args.adversary,
                           fraction=args.adversary_fraction,
                           theta=args.adversary_theta, seed=args.seed + 3)
    cluster = SimCluster(n_agents=args.agents, seed=args.seed,
                         fail_prob=args.fail_prob,
                         straggle_prob=args.straggle_prob,
                         warmup=not args.no_warmup and engine_mode == "real",
                         engine_mode=engine_mode,
                         adversary_mix=mix, device=args.device)
    router = build_router(args.router, cluster.agent_infos(), n_hubs=args.hubs,
                          payment_mode=args.payment_mode, solver=args.solver,
                          warm_start=args.warm_start,
                          spill=not args.no_spill,
                          batched=not args.scalar_phase1,
                          predictor_backend=args.predictor_backend,
                          seed=args.seed,
                          reputation=not args.no_reputation,
                          audit_ledger=args.audit_ledger,
                          fused=args.fused,
                          explore_bonus=args.explore_bonus,
                          device=cluster.device)
    if args.sim_mode == "event":
        sim = EventSimulator(cluster, router, iter_dialogues(spec),
                             arrivals=arrivals, batch_cap=args.batch_cap,
                             batch_window=args.batch_window,
                             incremental=args.incremental,
                             max_inflight=args.max_inflight,
                             profiler=RoutingProfiler(), lean=True)
        metrics = sim.run()
    else:
        metrics = run_workload(cluster, router, generate(spec))
    if hasattr(router, "accounts"):
        metrics["accounts"] = dict(router.accounts)
    if mix is not None:
        metrics["adversaries"] = sorted(cluster.adversaries)
        if hasattr(router, "pool"):
            metrics["reputation"] = router.pool.reputations()
    if getattr(router, "settlement", None) is not None:
        metrics["ledger"] = router.settlement.audit(router.accounts)
        metrics["ledger"]["head"] = router.settlement.head
    print(json.dumps(metrics, indent=2, default=float))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(metrics, f, indent=2, default=float)
    return metrics


if __name__ == "__main__":
    main()

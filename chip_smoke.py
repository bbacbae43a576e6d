#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root, on a machine with a CUDA device and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, in order (any failure raises and ends the run with a non-zero exit):

1. Device report: ``nvidia-smi`` name and power limit, torch and CUDA
   versions.
2. Build: both kernels from ``src/repro_torch/kernels/csrc`` with one
   ``nvcc`` each, started together; prints the ``-Xptxas -v`` report.
3. Kernels against their plain PyTorch versions, bit for bit, at the main
   path's shapes (LCP at prompts [64, 1024] x ledgers [64, 128, 1024] and
   at a width that is not a multiple of 32; the bidding round at (64, 128),
   (1024, 128) and (64, 16), with ties), each timed with CUDA events.
4. Router lockstep: two ``IEMASRouter``s over the 128-agent ``SCALE_128``
   fleet (one hub, warm starts, settlement ledger), one on the card with
   the kernels and one on the CPU with the plain versions, route the same
   seeded coqa_like + quac_like closed loop (batches of <= 64, >= 300
   requests) served on the port's analytic engines.  Decisions, accounts
   and the ledger head must be identical, and the kernel launch counters
   must grow on every batch.  Prints route_batch latency, throughput, the
   ledger tile's host-to-device copy time and bid rounds per solve.
5. Each kernel against its plain version again, and timed, at the inputs
   of every call the main path made to it in phase 4 (recorded there);
   then the card line, the JSON line of kernel records and the device line
   last.

Without a CUDA device, or outside the repository, it exits non-zero before
printing any result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12              # same, float32 outside the tensor cores
N_AGENTS = 128
MIN_REQUESTS = 300
BIG = 3.4028234663852886e38 / 4    # float32 max / 4, the no-bid price
# the per-kernel figures of the JSON line that phase 5 measures
MEASURED = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, timed
    with CUDA events after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# ---------------------------------------------------------------- inputs --
def lcp_inputs(n, m, length, seed, dev):
    """Prompts and ledger rows with shared prefixes of seeded lengths,
    absent rows (all padding) and full matches."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    plen = rng.integers(length // 4, length + 1, n)
    prompts = np.full((n, length), -1, np.int32)
    ledgers = np.full((n, m, length), -2, np.int32)
    for j in range(n):
        prompts[j, :plen[j]] = rng.integers(1, 255, plen[j])
        shared = rng.integers(0, plen[j] + 1, m)
        for i in range(m):
            if i % 5 == 0:
                continue
            ledgers[j, i, :shared[i]] = prompts[j, :shared[i]]
            ledgers[j, i, shared[i]:plen[j]] = rng.integers(
                1, 255, plen[j] - shared[i])
        ledgers[j, 1, :plen[j]] = prompts[j, :plen[j]]
    return (torch.from_numpy(prompts).to(dev),
            torch.from_numpy(ledgers).to(dev))


def bid_inputs(n, m, seed, dev):
    """Seeded bidding-round inputs with tied profits and tied bids."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    W = np.maximum(rng.uniform(-1, 4, (n, m)), 0.0).astype(np.float32)
    ask = rng.uniform(0, 3, m).astype(np.float32)
    ask2 = (ask + rng.uniform(0, 2, m)).astype(np.float32)
    ask2 = np.where(rng.random(m) < 0.2, np.float32(BIG), ask2)
    W[:, 1] = W[:, 0] - ask[0] + ask[1]
    W[1::2] = W[::2][: n // 2]
    active = rng.random(n) < 0.8
    tensors = [torch.from_numpy(x).to(dev) for x in (W, ask, ask2, active)]
    return (*tensors, np.float32(rng.uniform(1e-4, 0.5)))


# ---------------------------------------------------------------- bounds --
def lcp_work(prompts, ledgers, lcp) -> tuple[int, int]:
    """(bytes, operations) this data needs: each pair's ledger tokens up
    to its first mismatch, each prompt's tokens up to the furthest such
    point over its pairs, the [n, m] int32 output; one comparison per
    ledger token read."""
    length = prompts.shape[1]
    need = (lcp.long() + 1).clamp(max=length)
    nbytes = 4 * (int(need.sum()) + int(need.amax(dim=1).sum())
                  + lcp.numel())
    return nbytes, int(need.sum())


def bid_work(W, ask, ask2, active, eps) -> tuple[int, int]:
    """(bytes, operations) one round needs: the W rows of the active
    requests (an inactive row is never read and changes nothing), all of
    ask, ask2 only at each active row's favourite agent, the active mask,
    and the three outputs; per W element read, one subtraction and two
    comparisons (the top and the runner-up profit)."""
    import torch

    n, m = W.shape
    rows = int(active.sum())
    k1 = (W[active] - ask[None, :]).argmax(dim=1)
    nbytes = (4 * m * rows + 4 * m + 4 * int(torch.unique(k1).numel()) + n
              + 4 * m + 4 * m + n)
    return nbytes, 3 * m * rows


def roofline(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time in ms for this work, and what bounds it: bytes over
    the HBM rate or operations over the float32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def exact_diff(a, b) -> float:
    """0.0 when the tensors are bit-identical, else the max abs error."""
    import torch

    if a.dtype == torch.float32:
        if torch.equal(a.view(torch.int32), b.view(torch.int32)):
            return 0.0
    elif torch.equal(a, b):
        return 0.0
    return float((a.double() - b.double()).abs().max())


# ----------------------------------------------------------------- phases --
def phase_kernels(dev) -> dict:
    """Kernel vs plain version on synthetic inputs at the main path's
    shapes, with ties and corner cases."""
    from repro_torch.kernels.auction_bid import (auction_bid_cuda,
                                                 auction_bid_plain)
    from repro_torch.kernels.lcp_affinity import (lcp_affinity_cuda,
                                                  lcp_affinity_plain)

    for length in (1024, 1000):
        p, led = lcp_inputs(64, N_AGENTS, length, length, dev)
        got = lcp_affinity_cuda(p, led)
        err = exact_diff(got, lcp_affinity_plain(p, led))
        check(err == 0.0, f"lcp kernel != plain at L={length}")
        ms = cuda_time_ms(lambda: lcp_affinity_cuda(p, led))
        plain_ms = cuda_time_ms(lambda: lcp_affinity_plain(p, led), 20, 3)
        bound, by = roofline(*lcp_work(p, led, got))
        print(f"lcp_affinity [64,{length}]x[64,{N_AGENTS},{length}]: "
              f"bit-exact, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound:.7f} ms ({by})")
    for n, m in ((64, N_AGENTS), (1024, N_AGENTS), (64, 16)):
        args = bid_inputs(n, m, n + m, dev)
        got = auction_bid_cuda(*args)
        want = auction_bid_plain(*args)
        err = max(exact_diff(g, w) for g, w in zip(got, want))
        check(err == 0.0, f"auction_bid kernel != plain at ({n}, {m})")
        ms = cuda_time_ms(lambda: auction_bid_cuda(*args))
        plain_ms = cuda_time_ms(lambda: auction_bid_plain(*args))
        bound, by = roofline(*bid_work(*args))
        print(f"auction_bid ({n}, {m}) synthetic: bit-exact, kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.7f} ms "
              f"({by})")


class ClosedLoop:
    """Seeded coqa_like + quac_like dialogues in FIFO micro-batches; every
    matched request is served on its agent's analytic engine and both
    routers receive the same completion."""

    def __init__(self, profiles, batch_cap: int, max_new: int, seed: int):
        import numpy as np

        from repro_torch.serving.analytic import AnalyticEngine
        from repro_torch.serving.workload import WorkloadSpec, generate

        scripts = generate(WorkloadSpec("coqa_like", 48, seed=seed)) + \
            generate(WorkloadSpec("quac_like", 48, seed=seed))
        self.scripts = {s.dialogue_id: s for s in scripts}
        self.turn = {d: 0 for d in self.scripts}
        self.history = {d: np.zeros(0, np.int32) for d in self.scripts}
        self.ready = list(self.scripts)
        self.engines = {p.agent_id: AnalyticEngine(
            p.model_class, seed=i, speed=p.speed, cache_slots=p.cache_slots,
            max_new_tokens=max_new) for i, p in enumerate(profiles)}
        self.profile = {p.agent_id: p for p in profiles}
        self.batch_cap = batch_cap
        self.max_new = max_new
        self.rid = 0
        self.now = 0.0

    def next_batch(self):
        from repro_torch.core.mechanism import Request

        import numpy as np

        reqs = []
        for did in self.ready[: self.batch_cap]:
            s = self.scripts[did]
            toks = np.concatenate([self.history[did],
                                   s.turns[self.turn[did]]]).astype(np.int32)
            reqs.append(Request(f"r{self.rid}", did, toks, self.turn[did],
                                s.domain, self.max_new,
                                {"difficulty": s.difficulty}))
            self.rid += 1
        self.ready = self.ready[self.batch_cap:]
        return reqs

    def complete(self, decisions, routers) -> None:
        """Serve every matched request and feed both routers."""
        import numpy as np

        from repro_torch.core.mechanism import CompletionObs

        back = []
        self.now += 0.5
        for d in decisions:
            req = d.request
            if d.agent_id is None:
                back.append(req.dialogue_id)
                continue
            res = self.engines[d.agent_id].serve(req.dialogue_id, req.tokens,
                                                 now=self.now)
            prof = self.profile[d.agent_id]
            quality = min(1.0, max(0.0, 0.25 + 0.05 * prof.scale
                                   + 0.15 * (req.domain in prof.domains)
                                   - 0.3 * float(req.meta["difficulty"])))
            obs = CompletionObs(res.ttft, res.n_prompt, res.n_hit, res.n_gen,
                                quality)
            for r in routers:
                r.on_complete(req.request_id, obs)
            self.history[req.dialogue_id] = np.concatenate(
                [req.tokens, res.output_tokens])
            self.turn[req.dialogue_id] += 1
            if self.turn[req.dialogue_id] < len(
                    self.scripts[req.dialogue_id].turns):
                self.ready.append(req.dialogue_id)
        self.ready = back + self.ready


class Recorder:
    """Stands in for an op of `repro_torch.kernels.ops` during the main
    path's run.  It passes every call on to the op unchanged and keeps the
    inputs of each call made on the card, so that phase 5 can check and
    time the kernel at the main path's own inputs.  The router makes fresh
    input tensors for every call and never writes them afterwards, so a
    reference is enough.  The op's launch count is untouched by this."""

    def __init__(self, op):
        self.op = op
        self.calls = []

    def __call__(self, *args):
        if args[0].is_cuda:
            self.calls.append(args)
        return self.op(*args)


@contextmanager
def recording(ops, names):
    """Replace each named op of module ``ops`` by a Recorder, and put the
    op back afterwards."""
    ops_before = {name: getattr(ops, f"{name}_op") for name in names}
    recorders = {name: Recorder(op) for name, op in ops_before.items()}
    for name, rec in recorders.items():
        setattr(ops, f"{name}_op", rec)
    try:
        yield recorders
    finally:
        for name, op in ops_before.items():
            setattr(ops, f"{name}_op", op)


class PhaseClock:
    """Host wall-clock per router phase, through the router's duck-typed
    ``profiler.phase(name)`` hook (the CUDA router's phases end with their
    results on the host, so the host clock covers their device work)."""

    def __init__(self):
        self.ms: dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.ms[name] = self.ms.get(name, 0.0) + \
                (time.perf_counter() - t) * 1e3


def same_decisions(a_list, b_list) -> bool:
    if len(a_list) != len(b_list):
        return False
    for a, b in zip(a_list, b_list):
        if (a.request.request_id, a.agent_id, a.hub_id, a.payment,
                a.welfare_weight) != (b.request.request_id, b.agent_id,
                                      b.hub_id, b.payment, b.welfare_weight):
            return False
        if (a.estimate is None) != (b.estimate is None):
            return False
        if a.estimate is not None and (
                a.estimate.latency, a.estimate.cost, a.estimate.quality) != (
                b.estimate.latency, b.estimate.cost, b.estimate.quality):
            return False
    return True


def phase_router(dev, cpu="cpu") -> dict:
    """CUDA router vs CPU router in lockstep over the closed loop; returns
    the run's figures and the inputs of every kernel call it made."""
    import torch

    from repro_torch.configs.iemas_cluster import (SCALE_128, RouterConfig,
                                                   agent_infos,
                                                   agent_profiles,
                                                   make_router)
    from repro_torch.kernels import ops

    profiles = agent_profiles(SCALE_128.n_agents)
    infos = agent_infos(profiles)
    cfg = RouterConfig(solver=SCALE_128.solver, n_hubs=1,
                       warm_start=SCALE_128.warm_start, audit_ledger=True)
    gpu = make_router(infos, cfg, device=dev)
    ref = make_router(infos, cfg, device=cpu)
    gpu.profiler = PhaseClock()
    loop = ClosedLoop(profiles, SCALE_128.batch_cap,
                      SCALE_128.max_new_tokens, seed=0)
    lat, ref_lat, routed, bid_launches, batches_with_edge = [], [], 0, 0, 0
    with recording(ops, ("auction_bid", "lcp_affinity")) as rec:
        ops.reset_launch_counts()          # the main path's run starts here
        while routed < MIN_REQUESTS or len(lat) < 5:
            reqs = loop.next_batch()
            check(bool(reqs), "closed loop ran dry before enough requests")
            before = ops.launch_counts()
            telemetry = {"router_inflight": len(reqs), "router_rps": 2.0}
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = gpu.route_batch(reqs, telemetry)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            after = ops.launch_counts()
            t0 = time.perf_counter()
            want = ref.route_batch(
                [type(r)(r.request_id, r.dialogue_id, r.tokens.copy(),
                         r.turn, r.domain, r.max_new_tokens, dict(r.meta))
                 for r in reqs], telemetry)
            ref_lat.append(time.perf_counter() - t0)
            check(same_decisions(got, want), "CUDA and CPU routers decided "
                  f"differently at batch {len(lat)}")
            edge = any(d.agent_id is not None for d in got)
            if dev.type == "cuda":
                check(after["lcp_affinity"] == before["lcp_affinity"] + 1,
                      "lcp_affinity kernel did not launch once per batch")
                check(not edge
                      or after["auction_bid"] > before["auction_bid"],
                      "auction_bid kernel did not launch on a batch with an "
                      "edge")
            bid_launches += after["auction_bid"] - before["auction_bid"]
            batches_with_edge += edge
            routed += len(reqs)
            loop.complete(got, [gpu, ref])
            check(gpu.accounts == ref.accounts, "accounts diverged")
            check(gpu.settlement.head == ref.settlement.head,
                  "settlement ledger heads diverged")
        counts = ops.launch_counts()       # ... and ends here
    gpu.settlement.audit(gpu.accounts)
    check(gpu.accounts["matched"] > 0, "nothing was matched")
    ms = sorted(x * 1e3 for x in lat)
    return {"counts": counts, "route_ms": ms, "routed": routed,
            "cpu_route_ms": sorted(x * 1e3 for x in ref_lat),
            "phase_ms": {k: v / len(lat)
                         for k, v in gpu.profiler.ms.items()},
            "batches": len(lat), "matched": gpu.accounts["matched"],
            "bid_rounds_per_solve": bid_launches / max(1, batches_with_edge),
            "calls": {name: r.calls for name, r in rec.items()},
            "req_per_s": routed / sum(lat), "head": gpu.settlement.head}


def replay(calls, kernel, plain, work, iters: int, plain_iters: int) -> dict:
    """Every recorded call once through the kernel and its plain version,
    bit for bit, then each timed over the whole recorded sequence.  Times
    and the bound are per call, averaged over the calls; the bound counts
    the bytes and operations each call's own data needs."""
    import torch

    check(bool(calls), "no kernel call was recorded on the main path")
    err, nbytes, nops = 0.0, 0, 0
    for args in calls:
        got, want = kernel(*args), plain(*args)
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        err = max(err, *(exact_diff(g, w) for g, w in zip(got, want)))
        b, o = work(args, got)
        nbytes, nops = nbytes + b, nops + o
    check(err == 0.0, f"{kernel.__name__} != plain at a main-path input")
    ms = cuda_time_ms(lambda: [kernel(*a) for a in calls], iters, 1)
    plain_ms = cuda_time_ms(lambda: [plain(*a) for a in calls],
                            plain_iters, 1)
    bound, by = roofline(nbytes / len(calls), nops / len(calls))
    shapes = sorted({tuple(tuple(a.shape) for a in args
                           if isinstance(a, torch.Tensor))[:2]
                     for args in calls})
    return {"calls": len(calls), "shapes": shapes, "max_abs_err": err,
            "ms": ms / len(calls), "plain_ms": plain_ms / len(calls),
            "bound_ms": bound, "bound_by": by}


def percentile(sorted_ms, q: float) -> float:
    k = min(len(sorted_ms) - 1, max(0, int(round(q * (len(sorted_ms) - 1)))))
    return sorted_ms[k]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.auction_bid import (auction_bid_cuda,
                                                 auction_bid_plain)
    from repro_torch.kernels.lcp_affinity import (lcp_affinity_cuda,
                                                  lcp_affinity_plain)

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {card} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    reports = build.build()
    print(f"[2] built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in sorted(reports.items()):
        for line in log.splitlines():
            if "ptxas" in line:
                print(f"    {name}: {line.strip()}")

    print("[3] kernels against their plain versions")
    phase_kernels(dev)

    print("[4] router lockstep, CUDA vs CPU, SCALE_128 fleet")
    run = phase_router(dev)
    counts = run["counts"]
    check(counts["lcp_affinity"] > 0 and counts["auction_bid"] > 0,
          f"a kernel of the main path never launched: {counts}")
    ms = run["route_ms"]
    print(f"    {run['routed']} requests in {run['batches']} batches, "
          f"{run['matched']} matched, identical decisions/accounts/ledger "
          f"head {run['head'][:16]}")
    print(f"    route_batch p50 {percentile(ms, 0.5):.2f} ms, p90 "
          f"{percentile(ms, 0.9):.2f} ms, {run['req_per_s']:.1f} requests/s "
          f"(CUDA router, host clock, synchronised)")
    cpu_ms = run["cpu_route_ms"]
    print(f"    CPU router (plain versions): p50 {percentile(cpu_ms, 0.5):.2f}"
          f" ms, p90 {percentile(cpu_ms, 0.9):.2f} ms")
    print("    CUDA router per batch: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in sorted(run["phase_ms"].items())))
    print(f"    launches: {counts}; auction_bid launches per solve "
          f"{run['bid_rounds_per_solve']:.1f}")

    calls = run["calls"]
    lmat = calls["lcp_affinity"][-1][1].cpu()   # the last batch's tile
    copy = []
    for _ in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lmat.to(dev)
        torch.cuda.synchronize()
        copy.append((time.perf_counter() - t) * 1e3)
    print(f"    ledger tile {tuple(lmat.shape)} int32 "
          f"({lmat.numel() * 4 / 2**20:.1f} MiB) host->device copy: median "
          f"{statistics.median(copy):.3f} ms")

    print("[5] kernels at the inputs of every main-path call")
    lcp = replay(calls["lcp_affinity"], lcp_affinity_cuda, lcp_affinity_plain,
                 lambda args, out: lcp_work(*args, out[0]), 50, 10)
    bid = replay(calls["auction_bid"], auction_bid_cuda, auction_bid_plain,
                 lambda args, out: bid_work(*args), 5, 2)
    for name, r in (("lcp_affinity", lcp), ("auction_bid", bid)):
        print(f"    {name} over {r['calls']} calls {r['shapes']}: bit-exact, "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.7f} ms ({r['bound_by']}) per call")

    kernels = [
        {"name": "lcp_affinity", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lcp_affinity.cu",
         "replaces": "src/repro/kernels/lcp_affinity.py:40",
         "launches": counts["lcp_affinity"],
         **{k: lcp[k] for k in MEASURED},
         "library_ms": None},
        {"name": "auction_bid", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/auction_bid.cu",
         "replaces": "src/repro/kernels/auction_bid.py:112",
         "launches": counts["auction_bid"],
         **{k: bid[k] for k in MEASURED},
         "library_ms": None},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

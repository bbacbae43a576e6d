"""The hand-written CUDA kernels against their plain versions at the main
paths' shapes (the staged auction solve bit for bit against the host-driven
staged market: one market, a hub batch, a tripped budget, ties), short
CUDA-vs-CPU router locksteps (one hub and 8 hubs with spill), the fused
routing step's two kernels and the fused CUDA router against the fused CPU
router (bit for bit, one launch of each kernel per batch), the hubs-of-hubs
federation on the card against the CPU one and its process shards (each
with its own CUDA context) against its inline shards, and reduced
CUDA-vs-CPU serving-engine locksteps (dense, RWKV-6, zamba2, MoE with MLA
or GQA) and MoE / MLA blocks, the attention kernels at the head groups
of the reference's larger dense and MoE configs, and the encoder-decoder
and patch-input models (their attention shapes and modes, and reduced
CUDA-vs-CPU model locksteps), and training: the forward kernel's saved
row log-sum-exp against the plain one (its output the same bits with and
without it), the flash-attention backward kernel, fed that LSE, against
its plain version at the training paths' shapes (float32
within 1e-4 and bf16 within 3e-2 of each output's largest plain
magnitude), bit for bit from run to run, the WKV6 and SSD backward
kernels against their plain versions (autograd through the plain
forwards) under the same gates, each row (a token and head; a token of
dB / dC) within 2e-2 of its own largest plain value, the scan forwards'
bits the same with and without their saved states, the scan ops under
grad never reaching a plain version, the reduced models' gradients (the
recurrent families' too) on the card against the CPU's, and the kernel
ops without a backward raising under grad.  These need an NVIDIA GPU
(and ``nvcc`` to build the kernels); where none is present they skip,
deciding inside the fixture.  Attention tolerances are the reference's:
2e-5 in float32, 3e-2 in bfloat16.  WKV6 and SSD: 1e-3 in float32 (the
reference's); in bfloat16 the output within one bf16 rounding of the plain
version's (|got - want| <= 2^-7·|want| + 1e-3: both round float32 sums
that differ in their last bits) and the float32 state within 1e-3."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _serving_parity import comparable  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.auction_bid import (auction_bid_cuda,  # noqa: E402
                                             auction_bid_plain,
                                             auction_solve_cuda,
                                             auction_solve_plain,
                                             pack_markets, unpack_solution)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_cuda, decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_attention_plain)
from repro_torch.kernels.lcp_affinity import (lcp_affinity_cuda,  # noqa: E402
                                              lcp_affinity_plain,
                                              lcp_gather_cuda,
                                              lcp_gather_plain)
from repro_torch.kernels.ssd import ssd_cuda, ssd_plain  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6_cuda, wkv6_plain  # noqa: E402

pytestmark = pytest.mark.cuda
BIG = np.float32(np.finfo(np.float32).max / 4)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
SYNC_WARNING = "called a synchronizing CUDA operation"   # sync debug mode's


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def lcp_inputs(n, m, length, seed, dev):
    """Prompts/ledgers with shared prefixes of seeded lengths, absent rows
    and full matches."""
    rng = np.random.default_rng(seed)
    plen = rng.integers(0, length + 1, n)
    prompts = np.full((n, length), -1, np.int32)
    ledgers = np.full((n, m, length), -2, np.int32)
    for j in range(n):
        prompts[j, :plen[j]] = rng.integers(1, 255, plen[j])
        shared = rng.integers(0, plen[j] + 1, m)
        for i in range(m):
            if i % 7 == 0:
                continue                            # absent entry
            ledgers[j, i, :shared[i]] = prompts[j, :shared[i]]
            tail = int(rng.integers(0, length - shared[i] + 1))
            ledgers[j, i, shared[i]:shared[i] + tail] = \
                rng.integers(1, 255, tail)
        ledgers[j, 1, :plen[j]] = prompts[j, :plen[j]]   # full match
    return (torch.from_numpy(prompts).to(dev),
            torch.from_numpy(ledgers).to(dev))


@pytest.mark.parametrize("length", [1024, 1000, 31])
def test_lcp_kernel_matches_plain(dev, length):
    prompts, ledgers = lcp_inputs(64, 128, length, length, dev)
    got = lcp_affinity_cuda(prompts, ledgers)
    torch.cuda.synchronize()
    assert torch.equal(got, lcp_affinity_plain(prompts, ledgers))


def bid_inputs(n, m, seed, dev):
    rng = np.random.default_rng(seed)
    W = np.maximum(rng.uniform(-1, 4, (n, m)), 0.0).astype(np.float32)
    ask = rng.uniform(0, 3, m).astype(np.float32)
    ask2 = (ask + rng.uniform(0, 2, m)).astype(np.float32)
    ask2 = np.where(rng.random(m) < 0.2, BIG, ask2)
    W[:, 1] = W[:, 0] - ask[0] + ask[1]              # tied profits
    W[1::2] = W[::2][: n // 2]                       # tied bids
    active = rng.random(n) < 0.8
    t = [torch.from_numpy(x).to(dev) for x in (W, ask, ask2, active)]
    return (*t, np.float32(rng.uniform(1e-4, 0.5)))


@pytest.mark.parametrize("n,m", [(64, 128), (1024, 128), (64, 16)])
def test_bid_kernel_bit_exact_with_plain(dev, n, m):
    args = bid_inputs(n, m, n + m, dev)
    got = auction_bid_cuda(*args)
    want = auction_bid_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


def solve_market(n, m, cmax, seed, *, warm=False, tie=False, cap=200_000):
    """A seeded market for ``auction_solve``: cold (zero grid, ε₀ = wmax/5)
    or warm (seeded prices, ε₀ = wmax/125), ``tie`` repeating columns and
    rows."""
    from repro_torch.core.solvers.dense_common import float32_eps_final

    rng = np.random.default_rng(seed)
    W = np.maximum(rng.uniform(-1, 4, (n, m)), 0.0).astype(np.float32)
    if tie:
        W[:, 1::2] = W[:, 0::2][:, : m // 2]
        W[1::2] = W[0::2][: n // 2]
    counts = rng.integers(0, cmax + 1, m).astype(np.int32)
    counts[0] = cmax
    wmax = float(W[:, counts > 0].max())
    eps_f = float32_eps_final(wmax, np.float32)
    p0, eps0 = np.zeros((m, cmax), np.float32), max(wmax / 5.0, eps_f)
    if warm:
        p0 = (rng.uniform(0, 3, (m, cmax)) * (np.arange(cmax)[None, :]
                                               < counts[:, None])
              ).astype(np.float32)
        eps0 = max(wmax / 125.0, eps_f)
    return W, counts, p0, eps0, eps_f, 5.0, cap


def assert_solve_matches_plain(markets, dev):
    """One launch against the plain staged market on the host, bit for bit
    (the packed result holds prices, assignment and rounds); returns the
    rounds per market."""
    fbuf, ibuf, meta = pack_markets(markets)
    got = auction_solve_cuda(torch.from_numpy(fbuf).to(dev),
                             torch.from_numpy(ibuf).to(dev), meta)
    torch.cuda.synchronize()
    want = auction_solve_plain(torch.from_numpy(fbuf),
                               torch.from_numpy(ibuf), meta)
    assert torch.equal(got.cpu(), want)
    return [r[3] for r in unpack_solution(want.numpy(), meta)]


@pytest.mark.parametrize("warm", [False, True])
def test_solve_kernel_single_market(dev, warm):
    rounds = assert_solve_matches_plain(
        [solve_market(64, 128, 12, int(warm), warm=warm)], dev)
    assert rounds[0] > 0


def test_solve_kernel_hub_batch(dev):
    shapes = [(8, 16, 8), (3, 16, 3), (12, 16, 12), (1, 16, 1), (20, 16, 12),
              (9, 15, 5), (16, 17, 12), (5, 16, 2)]
    rounds = assert_solve_matches_plain(
        [solve_market(n, m, c, 10 + h, warm=h % 2 == 1)
         for h, (n, m, c) in enumerate(shapes)], dev)
    assert len(set(rounds)) > 1


def test_solve_kernel_budget_trip_and_ties(dev):
    rounds = assert_solve_matches_plain(
        [solve_market(64, 128, 12, 2, warm=True, cap=20),
         solve_market(64, 128, 12, 3, tie=True)], dev)
    assert rounds[0] == 20


def test_solve_kernel_with_w_in_global_memory(dev):
    assert_solve_matches_plain([solve_market(200, 400, 12, 4)], dev)


@pytest.mark.parametrize("lp,la", [(1024, 1024), (1000, 1024), (1100, 1024),
                                   (37, 64)])
def test_lcp_gather_kernel_matches_plain(dev, lp, la):
    rng = np.random.default_rng(lp + la)
    n, m, s = 64, 128, 300
    arena = np.full((s, la), -2, np.int32)
    for r in range(1, s):
        k = int(rng.integers(0, la + 1))
        arena[r, :k] = rng.integers(1, 4, k)
    rows = rng.integers(0, s, (n, m)).astype(np.int32)
    prompts = np.full((n, lp), -1, np.int32)
    for j in range(n):
        k = int(rng.integers(lp // 4, lp + 1))
        prompts[j, :k] = rng.integers(1, 4, k)
        src = arena[rows[j, 1], :min(k, la)]
        prompts[j, :len(src)] = np.where(src >= 0, src, prompts[j, :len(src)])
    args = [torch.from_numpy(x).to(dev) for x in (prompts, arena, rows)]
    got = lcp_gather_cuda(*args)
    torch.cuda.synchronize()
    want = lcp_gather_plain(*args)
    assert torch.equal(got, want) and int(want.max()) > 0


def test_ops_count_kernel_launches(dev):
    ops.reset_launch_counts()
    ops.auction_bid_op(*bid_inputs(8, 4, 0, dev))
    ops.lcp_affinity_op(*lcp_inputs(2, 3, 40, 0, dev))
    ops.lcp_affinity_op(*lcp_inputs(2, 3, 40, 0, "cpu"))      # plain: uncounted
    fbuf, ibuf, meta = pack_markets([solve_market(8, 4, 2, 0)])
    ops.auction_solve_op(torch.from_numpy(fbuf).to(dev),
                         torch.from_numpy(ibuf).to(dev), meta)
    ops.auction_solve_op(torch.from_numpy(fbuf), torch.from_numpy(ibuf), meta)
    prompts, ledgers = lcp_inputs(2, 3, 40, 0, dev)
    ops.lcp_gather_op(prompts, ledgers[0],
                      torch.zeros((2, 3), dtype=torch.int32, device=dev))
    ops.wkv6_op(*wkv6_inputs(1, 20, 2, 16, torch.float32, True, dev, 0))
    ops.ssd_op(*ssd_inputs(1, 20, 2, 16, 8, torch.float32, False, dev, 0))
    ops.wkv6_op(*wkv6_inputs(1, 20, 2, 16, torch.float32, True, "cpu", 0))
    assert ops.launch_counts() == {"auction_bid": 1, "auction_solve": 1,
                                   "auction_fused": 0, "fused_phase1": 0,
                                   "lcp_affinity": 1, "lcp_gather": 1,
                                   "flash_attention": 0,
                                   "flash_attention_bwd": 0,
                                   "decode_attention": 0, "wkv6": 1,
                                   "wkv6_bwd": 0, "ssd": 1,
                                   "ssd_bwd": 0}


def _router_lockstep(dev, n_agents, cfg, batches, n_req):
    from repro_torch.configs.iemas_cluster import (agent_infos,
                                                   agent_profiles,
                                                   make_router)
    from repro_torch.core.mechanism import CompletionObs, Request

    infos = agent_infos(agent_profiles(n_agents))
    gpu = make_router(infos, cfg, device=dev)
    cpu = make_router(infos, cfg, device="cpu")
    rng = np.random.default_rng(0)
    domains = ("dialogue", "code", "math", "longctx", "reasoning")
    ops.reset_launch_counts()
    for t in range(batches):
        reqs = [(f"r{t}_{j}", f"d{j}", rng.integers(1, 50, 20 + 10 * t),
                 domains[j % len(domains)]) for j in range(n_req)]
        out = [r.route_batch([Request(a, b, c.astype(np.int32), t, d)
                              for a, b, c, d in reqs], {})
               for r in (gpu, cpu)]
        for a, b in zip(*out):
            assert (a.agent_id, a.payment, a.hub_id) == \
                (b.agent_id, b.payment, b.hub_id)
            if a.agent_id is not None:
                obs = CompletionObs(0.05, len(a.request.tokens), 0, 6, 0.7)
                gpu.on_complete(a.request.request_id, obs)
                cpu.on_complete(b.request.request_id, obs)
    assert gpu.accounts == cpu.accounts
    assert gpu.settlement.head == cpu.settlement.head
    counts = ops.launch_counts()
    assert counts["lcp_gather"] == batches and counts["auction_solve"] > 0
    assert counts["auction_bid"] == 0 and counts["lcp_affinity"] == 0
    return gpu


def test_cuda_router_matches_cpu_router(dev):
    from repro_torch.configs.iemas_cluster import RouterConfig

    _router_lockstep(dev, 16, RouterConfig(warm_start=True,
                                           audit_ledger=True), 4, 12)


def test_cuda_router_matches_cpu_router_at_8_hubs(dev):
    import dataclasses

    from repro_torch.configs.iemas_cluster import SCALE_128

    cfg = dataclasses.replace(SCALE_128.router_config(), audit_ledger=True)
    gpu = _router_lockstep(dev, 128, cfg, 4, 64)
    assert len(gpu.hubs) == 8


# ------------------------------------------------------ the fused step --
FUSED_TELEMETRY = {"router_inflight": 2, "router_rps": 1.0,
                   "agent_inflight": {"a0": 1}, "agent_rps": {"a1": 0.5}}


def _fused_router(device, **kw):
    """tests/test_routing_fused.py's heterogeneous 5-agent fleet (a
    recurrent agent, an LRU-capped one), the optimism bonus on two."""
    from repro_torch.core.mechanism import AgentInfo, IEMASRouter
    from repro_torch.core.pricing import TokenPrices

    agents = [AgentInfo(f"a{i}", TokenPrices(0.01 * (1 + i / 5),
                                             0.001 * (1 + i / 5),
                                             0.03 * (1 + i / 5)), 2,
                        ("dialogue",) if i % 2 == 0
                        else ("dialogue", "reasoning"), scale=4.0 + i,
                        recurrent=(i == 3), cache_slots=2 if i == 1 else 0)
              for i in range(5)]
    r = IEMASRouter(agents, device=device, fused=True, **kw)
    for aid in ("a0", "a2"):
        r.pool[aid].explore = 0.05
    return r


def _fused_batch(n, t, seed, parents=False):
    from repro_torch.core.mechanism import Request

    rng = np.random.default_rng(seed * 1000 + t)
    return [Request(f"r{t}_{j}", f"d{j % 4}",
                    rng.integers(0, 50, int(rng.integers(5, 30))), turn=t,
                    domain="dialogue" if j % 2 == 0 else "reasoning",
                    meta={"parent_sessions": (f"d{(j + 1) % 4}",
                                              f"d{(j + 2) % 4}")}
                    if parents and j % 3 == 1 else {})
            for j in range(n)]


def _train(routers, seed, n_obs=700):
    """The same observations and ledger entries into every router, so
    their trees split."""
    from repro_torch.core.predictor import PredictorInput

    rng = np.random.default_rng(seed)
    for k in range(n_obs):
        x = rng.uniform(0, 1, 10) * np.array([30, 4, 1, 3, 2, 2, 1, 2, 1, 1])
        for r in routers:
            r.pool[f"a{k % 5}"].update(PredictorInput(*x),
                                       0.02 + 0.3 * (x[0] > 15),
                                       0.01 + 2.0 * (x[2] > 0.5),
                                       float(x[9] > 0.5))
    for k in range(12):
        toks = rng.integers(0, 50, int(rng.integers(5, 30)))
        for r in routers:
            r.ledger.update(f"a{k % 5}", f"d{k % 4}", toks)


def test_fused_phase1_kernel_matches_plain(dev, monkeypatch):
    """``fused_phase1_kernel`` against the plain pass at the inputs the
    fused CPU router gave it (cold agents, trained trees, parents, the
    optimism bonus, padding), bit for bit, W and wmax included."""
    from repro_torch.kernels.routing_fused import (fused_phase1_cuda,
                                                   fused_phase1_plain)

    calls = []
    real = ops.fused_phase1_op

    def rec(args, out, lay):
        calls.append((args.map(torch.clone), lay))
        return real(args, out, lay)

    monkeypatch.setattr(ops, "fused_phase1_op", rec)
    cpu = _fused_router("cpu", solver="cuda", n_hubs=1)
    cpu.route_batch(_fused_batch(3, 0, 2), dict(FUSED_TELEMETRY))
    _train([cpu], seed=4)
    cpu.route_batch(_fused_batch(6, 1, 2, parents=True),
                    dict(FUSED_TELEMETRY))
    assert len(calls) == 2 and calls[1][0].cb > 0
    for args, lay in calls:
        want = fused_phase1_plain(args, torch.zeros(lay.total), lay)
        got = fused_phase1_cuda(args.map(lambda t: t.to(dev)),
                                torch.zeros(lay.total, device=dev), lay)
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))


@pytest.mark.parametrize("case", ["cold", "warm", "tripped", "global"])
def test_auction_fused_kernel_matches_plain(dev, case):
    """The fused mode of the solve against its plain version: the ε
    schedule from wmax, the warm attempt, a tripped budget and its cold
    re-solve in the same launch, and a market whose W does not fit in
    shared memory, bit for bit."""
    from repro_torch.core.solvers.dense_common import THETA
    from repro_torch.kernels.auction_bid import (auction_fused_cuda,
                                                 auction_fused_plain,
                                                 auction_solve_plan)
    from repro_torch.kernels.routing_fused import packed_layout

    nb, mb, cbu = (256, 512, 4) if case == "global" else (64, 128, 16)
    n, m = nb * 25 // 32, mb * 25 // 32
    rng = np.random.default_rng(6)
    W = np.zeros((nb, mb), np.float32)
    W[:n, :m] = rng.uniform(0, 4, (n, m)) * (rng.random((n, m)) > 0.3)
    counts = np.zeros(mb, np.int32)
    counts[:m] = rng.integers(0, cbu + 1, m)
    grid = np.zeros((mb, cbu), np.float32)
    if case in ("warm", "tripped"):
        grid[:m] = rng.uniform(0, 2, (m, cbu))
    lay = packed_layout(nb, mb, cbu)
    out = torch.zeros(lay.total)
    out[0] = float(W[:, counts > 0].max())
    out[lay.W:lay.W + nb * mb] = torch.from_numpy(W.ravel())
    kw = dict(budget=5 if case == "tripped" else 10_000, max_rounds=200_000,
              warm=case in ("warm", "tripped"), theta=THETA)
    want = auction_fused_plain(out.clone(), torch.from_numpy(counts),
                               torch.from_numpy(grid.ravel()), lay, **kw)
    got = auction_fused_cuda(out.to(dev), torch.from_numpy(counts).to(dev),
                             torch.from_numpy(grid.ravel()).to(dev), lay,
                             **kw)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert bool(want.view(torch.int32)[2]) == (case == "tripped")
    assert auction_solve_plan(np.array([[nb, mb, cbu]]))[0] == \
        (case != "global")


@pytest.mark.parametrize("warm", [False, True])
def test_fused_cuda_router_matches_cpu_router(dev, warm):
    """The fused router on the card against the fused router on the CPU:
    decisions, payments, estimates and accounts bit for bit; per batch one
    launch each of ``lcp_gather``, ``fused_phase1`` and ``auction_fused``,
    none of the staged kernels."""
    kw = dict(solver="cuda", n_hubs=1, warm_start=warm)
    cpu, gpu = _fused_router("cpu", **kw), _fused_router(dev, **kw)
    _train([cpu, gpu], seed=9)
    rng = np.random.default_rng(7)
    for t in range(5):
        n = int(rng.integers(2, 9))
        ops.reset_launch_counts()
        dg = gpu.route_batch(_fused_batch(n, t, 8, parents=t % 2 == 1),
                             dict(FUSED_TELEMETRY))
        counts = ops.launch_counts()
        dc = cpu.route_batch(_fused_batch(n, t, 8, parents=t % 2 == 1),
                             dict(FUSED_TELEMETRY))
        assert (counts["lcp_gather"], counts["fused_phase1"],
                counts["auction_fused"], counts["auction_bid"],
                counts["lcp_affinity"]) == (1, 1, 1, 0, 0)
        for a, b in zip(dg, dc):
            assert (a.agent_id, a.payment, a.welfare_weight) == \
                (b.agent_id, b.payment, b.welfare_weight)
            if b.estimate is not None:
                assert (a.estimate.latency, a.estimate.cost,
                        a.estimate.quality) == (b.estimate.latency,
                                                b.estimate.cost,
                                                b.estimate.quality)
        for d in dc:
            if d.agent_id:
                from repro_torch.core.mechanism import CompletionObs

                obs = CompletionObs(latency=0.03 + 0.01 * rng.random(),
                                    n_prompt=len(d.request.tokens), n_hit=0,
                                    n_gen=20, quality=0.7)
                gpu.on_complete(d.request.request_id, obs)
                cpu.on_complete(d.request.request_id, obs)
        assert gpu.accounts == cpu.accounts


def test_fused_step_syncs_only_at_its_copy(dev, monkeypatch):
    """From the fused step's first launch until its fused solve returns no
    call synchronizes with the host (PyTorch's sync debug mode "error"
    raises on one); after it, the step makes exactly one synchronizing call,
    its device-to-host copy (counted in "warn" mode)."""
    import warnings

    gpu = _fused_router(dev, solver="cuda", n_hubs=1, warm_start=True)
    _train([gpu], seed=9)
    gather, fused = ops.lcp_gather_op, ops.auction_fused_op

    def first(*a):
        torch.cuda.set_sync_debug_mode("error")
        return gather(*a)

    def last(*a, **k):
        out = fused(*a, **k)
        torch.cuda.set_sync_debug_mode("warn")
        return out

    monkeypatch.setattr(ops, "lcp_gather_op", first)
    monkeypatch.setattr(ops, "auction_fused_op", last)
    step, tail = gpu._fused.step, []

    def guarded(*args, **kw):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            try:
                return step(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                tail.append(sum(SYNC_WARNING in str(w.message)
                                for w in seen))

    gpu._fused.step = guarded
    for t in range(4):
        gpu.route_batch(_fused_batch(5, t, 8, parents=t % 2 == 1),
                        dict(FUSED_TELEMETRY))
    assert tail == [1, 1, 1, 1]


def _normal(shape, dtype, dev, rng):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,h,hkv,d,causal,win", [
    (2, 64, 4, 2, 32, True, 0), (1, 100, 4, 4, 16, True, 0),
    (2, 128, 8, 2, 64, True, 48), (1, 37, 2, 1, 32, False, 0),
    (1, 100, 4, 4, 72, True, 0),
    (1, 16, 32, 8, 128, True, 0), (1, 128, 32, 8, 128, True, 0),
    (1, 512, 32, 8, 128, True, 0), (1, 1024, 32, 8, 128, True, 0),
    (1, 61, 32, 32, 112, True, 0), (1, 512, 32, 32, 112, True, 0),
    (1, 314, 32, 32, 112, True, 0), (1, 1000, 32, 8, 128, True, 0),
    (1, 200, 8, 2, 64, True, 40), (1, 200, 4, 2, 64, False, 0),
    (2, 130, 8, 4, 128, True, 0), (1, 90, 4, 2, 20, True, 0),
    (2, 70, 4, 1, 100, True, 24)])
def test_flash_kernel_matches_plain(dev, b, sq, h, hkv, d, causal, win,
                                    dtype):
    rng = np.random.default_rng(sq + d)
    q = _normal((b, sq, h, d), dtype, dev, rng)
    k = _normal((b, sq, hkv, d), dtype, dev, rng)
    v = _normal((b, sq, hkv, d), dtype, dev, rng)
    got = flash_attention_cuda(q, k, v, causal=causal, window=win)
    want = flash_attention_plain(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert float((got.float() - want.float()).abs().max()) < ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,causal,win", [
    (70, 200, True, 0), (70, 200, False, 0), (200, 70, True, 0),
    (100, 300, True, 50)])
def test_flash_kernel_matches_plain_when_sq_differs_from_sk(dev, sq, sk,
                                                           causal, win,
                                                           dtype):
    rng = np.random.default_rng(sq + sk)
    q = _normal((1, sq, 8, 128), dtype, dev, rng)
    k = _normal((1, sk, 2, 128), dtype, dev, rng)
    v = _normal((1, sk, 2, 128), dtype, dev, rng)
    got = flash_attention_cuda(q, k, v, causal=causal, window=win)
    want = flash_attention_plain(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) < ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,d,m", [
    (2, 4, 2, 32, 100), (1, 8, 8, 64, 257), (3, 6, 2, 16, 48),
    (1, 32, 8, 128, 1024), (1, 4, 4, 72, 1024), (1, 32, 32, 112, 1024),
    (1, 32, 8, 128, 1000), (1, 16, 1, 128, 1024), (2, 32, 2, 64, 300),
    (1, 4, 2, 20, 70)])
def test_decode_kernel_matches_plain(dev, b, h, hkv, d, m, dtype):
    rng = np.random.default_rng(m + d)
    q = _normal((b, h, d), dtype, dev, rng)
    kc = _normal((b, m, hkv, d), dtype, dev, rng)
    vc = _normal((b, m, hkv, d), dtype, dev, rng)
    valid = rng.random((b, m)) < 0.7
    valid[:, 0] = True
    valid = torch.from_numpy(valid).to(dev)
    got = decode_attention_cuda(q, kc, vc, valid)
    want = decode_attention_plain(q, kc, vc, valid)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert float((got.float() - want.float()).abs().max()) < ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,d,m,lens", [
    (1, 32, 8, 128, 1024, (600,)), (1, 32, 32, 112, 1024, (314,)),
    (2, 4, 2, 32, 1000, (1, 999)), (1, 16, 1, 64, 1024, (33,))])
def test_decode_kernel_valid_prefix(dev, b, h, hkv, d, m, lens, dtype):
    """The engine's pattern: the valid slots of a contiguous cache are a
    prefix, so most split ranges hold none and are skipped."""
    rng = np.random.default_rng(m + d + lens[0])
    q = _normal((b, h, d), dtype, dev, rng)
    kc = _normal((b, m, hkv, d), dtype, dev, rng)
    vc = _normal((b, m, hkv, d), dtype, dev, rng)
    valid = torch.arange(m, device=dev)[None, :] < torch.tensor(
        lens, device=dev)[:, None]
    got = decode_attention_cuda(q, kc, vc, valid)
    want = decode_attention_plain(q, kc, vc, valid)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) < ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_row_without_valid_slot(dev, dtype):
    """A row with no valid slot gets a uniform softmax over all M slots, as
    the plain version does: the mean of V of its KV head."""
    rng = np.random.default_rng(3)
    b, h, hkv, d, m = 2, 32, 8, 128, 1024
    q = _normal((b, h, d), dtype, dev, rng)
    kc = _normal((b, m, hkv, d), dtype, dev, rng)
    vc = _normal((b, m, hkv, d), dtype, dev, rng)
    valid = torch.zeros((b, m), dtype=torch.bool, device=dev)
    valid[0, :100] = True                        # row 1 has none
    got = decode_attention_cuda(q, kc, vc, valid)
    want = decode_attention_plain(q, kc, vc, valid)
    torch.cuda.synchronize()
    mean_v = vc[1].float().mean(0).repeat_interleave(h // hkv, dim=0)
    assert float((got.float() - want.float()).abs().max()) < ATTN_TOL[dtype]
    assert float((got[1].float() - mean_v).abs().max()) < ATTN_TOL[dtype]


def test_cuda_engine_matches_cpu_engine(dev):
    """Reduced qwen3-8b in float32: the same weights on the card (kernels)
    and on the CPU (plain versions) give the same greedy tokens and cache
    accounting, and the card's run goes through both kernels."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.serving.engine import AgentEngine

    cfg = get_config("qwen3-8b").scaled(dtype="float32")
    kw = {"max_len": 128, "max_new_tokens": 4, "cache_slots": 2}
    gpu = AgentEngine(cfg, seed=0, device=dev, **kw)
    cpu = AgentEngine(cfg, device="cpu",
                      params=copy.deepcopy(gpu.params).cpu(), **kw)
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, 255, 40).astype(np.int32)
    ops.reset_launch_counts()
    for did in ("a", "a", "a", "b", "c"):
        a, b = (e.serve(did, prompt) for e in (gpu, cpu))
        np.testing.assert_array_equal(a.output_tokens, b.output_tokens)
        assert (a.n_hit, a.n_prompt) == (b.n_hit, b.n_prompt)
        prompt = np.concatenate([prompt, a.output_tokens,
                                 rng.integers(1, 255, 5).astype(np.int32)])
    assert gpu.evictions == cpu.evictions == 1
    counts = ops.launch_counts()
    assert counts["flash_attention"] == cfg.n_layers * 3     # a, b, c fresh
    assert counts["decode_attention"] == cfg.n_layers * 5 * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,win", [(40, 0), (48, 64), (56, 0), (64, 0)])
def test_attention_kernels_at_the_new_head_groups(dev, h, win, dtype):
    """The head layouts of qwen2.5-32b (40 / 8: group 5), mixtral-8x22b
    (48 / 8: group 6, a sliding window), deepseek-coder-33b (56 / 8: group
    7) and qwen2-72b (64 / 8), heads of 128: flash over a window that
    slides, decode over a ring that has wrapped (every slot valid)."""
    rng = np.random.default_rng(h + win)
    s, m = 300, 256
    q = _normal((1, s, h, 128), dtype, dev, rng)
    k = _normal((1, s, 8, 128), dtype, dev, rng)
    v = _normal((1, s, 8, 128), dtype, dev, rng)
    got = flash_attention_cuda(q, k, v, causal=True, window=win)
    want = flash_attention_plain(q, k, v, causal=True, window=win)
    assert float((got.float() - want.float()).abs().max()) < ATTN_TOL[dtype]
    from repro_torch.models.attention import _slot

    pos = torch.tensor([700], device=dev)             # past 256: wrapped
    slot_pos = torch.full((1, m), -1, dtype=torch.int32, device=dev)
    past = torch.arange(700 - m + 1, 701, device=dev)
    slot_pos[0, _slot(past, m, m)] = past.to(torch.int32)
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None]) \
        & ((pos[:, None] - slot_pos) < m)
    assert bool(valid.all())
    qd = _normal((1, h, 128), dtype, dev, rng)
    kc = _normal((1, m, 8, 128), dtype, dev, rng)
    vc = _normal((1, m, 8, 128), dtype, dev, rng)
    got = decode_attention_cuda(qd, kc, vc, valid)
    want = decode_attention_plain(qd, kc, vc, valid)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) < ATTN_TOL[dtype]


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x22b"])
def test_cuda_moe_mla_blocks_match_cpu(dev, arch, monkeypatch):
    """Reduced MoE blocks (MLA attention for deepseek, sliding-window GQA
    for mixtral) in float32: prefill and one decode step on the card equal
    the CPU's on the same weights (1e-4 of the output's scale; TF32 off)."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_config(arch).scaled(dtype="float32", sliding_window=0)
    gen = torch.Generator().manual_seed(1)
    p_cpu = blocks.attn_block_init(cfg, torch.float32, generator=gen,
                                   ffn_kind="moe")
    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        return tree.to(dev)

    p_gpu = to(p_cpu)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 24, cfg.d_model))
                         .astype(np.float32))
    lens = torch.tensor([24], dtype=torch.int32)
    for mode in ("sort", "onehot"):
        a, kv_a = blocks.attn_block_parallel(p_gpu, x.to(dev), cfg,
                                             ffn_kind="moe",
                                             lens=lens.to(dev),
                                             moe_mode=mode)
        b, kv_b = blocks.attn_block_parallel(p_cpu, x, cfg, ffn_kind="moe",
                                             lens=lens, moe_mode=mode)
        scale = float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) < 1e-4 * scale
    keys = ("ckv", "krope") if cfg.attn_kind == "mla" else ("k", "v")
    m = 32
    cache = {kk: torch.cat([t, t.new_zeros((1, m - 24, *t.shape[2:]))], 1)
             for kk, t in zip(keys, kv_b)}
    cache.update(slot_pos=torch.cat([torch.arange(24, dtype=torch.int32),
                                     torch.full((m - 24,), -1,
                                                dtype=torch.int32)])[None],
                 pos=torch.tensor([24], dtype=torch.int32))
    xd = x[:, -1] * 0.5
    a, nc_a = blocks.attn_block_decode(
        p_gpu, xd.to(dev), {k: v.to(dev) for k, v in cache.items()}, cfg,
        ffn_kind="moe")
    b, nc_b = blocks.attn_block_decode(p_cpu, xd, cache, cfg,
                                       ffn_kind="moe")
    assert float((a.cpu() - b).abs().max()) < 1e-4 * float(b.abs().max())
    for kk in keys:
        assert float((nc_a[kk].cpu() - nc_b[kk]).abs().max()) < 1e-4 * \
            float(nc_b[kk].abs().max())


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x22b",
                                  "qwen2.5-32b"])
def test_cuda_moe_mla_engine_matches_cpu_engine(dev, arch, monkeypatch):
    """Reduced engines in float32 on the same weights, the card's against
    the CPU's: fresh, exact extension, a prefix hit (truncate, extend,
    decode), identical repeat.  MLA launches no attention kernel; GQA one
    flash launch per layer of each fresh prefill.  Mixtral's window is 16,
    so the dialogue wraps its ring and the window masks."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.serving.engine import AgentEngine

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    over = {"sliding_window": 16} if arch == "mixtral-8x22b" else {}
    cfg = get_config(arch).scaled(dtype="float32", **over)
    kw = {"max_len": 128, "max_new_tokens": 4, "cache_slots": 2}
    gpu = AgentEngine(cfg, seed=0, device=dev, **kw)
    cpu = AgentEngine(cfg, device="cpu",
                      params=copy.deepcopy(gpu.params).cpu(), **kw)
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, 255, 40).astype(np.int32)
    ops.reset_launch_counts()
    fresh = 0
    for step in range(4):
        a, b = (e.serve("a", prompt) for e in (gpu, cpu))
        np.testing.assert_array_equal(a.output_tokens, b.output_tokens)
        assert (a.n_hit, a.n_prompt) == (b.n_hit, b.n_prompt)
        fresh += a.n_hit == 0
        full = gpu.sessions["a"].prompt
        prompt = (np.concatenate([full, rng.integers(1, 255, 5)])
                  if step == 0 else
                  np.concatenate([full[:30], rng.integers(1, 255, 7)])
                  if step == 1 else full).astype(np.int32)
    counts = ops.launch_counts()
    if cfg.sliding_window:
        assert int(gpu.sessions["a"].cache["pos"].max()) > cfg.sliding_window
    mla = cfg.attn_kind == "mla"
    assert counts["flash_attention"] == (0 if mla else cfg.n_layers * fresh)
    assert (counts["decode_attention"] == 0) == mla


def assert_scan_close(got, want):
    """(output, state) of a kernel against its plain version: float32
    within 1e-3; a bf16 output within one bf16 rounding (module doc)."""
    (go, gs), (wo, ws) = got, want
    assert go.dtype == wo.dtype and gs.dtype == torch.float32
    err = (go.float() - wo.float()).abs()
    if go.dtype == torch.bfloat16:
        assert bool((err <= 2.0 ** -7 * wo.float().abs() + 1e-3).all())
    else:
        assert float(err.max()) < 1e-3
    assert float((gs - ws).abs().max()) < 1e-3


def wkv6_inputs(b, s, h, dk, dtype, state, dev, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (_normal((b, s, h, dk), dtype, dev, rng) for _ in range(3))
    lw = np.clip(-np.exp(rng.standard_normal((b, s, h, dk))), -4.0, -1e-3)
    u = _normal((h, dk), torch.float32, dev, rng)
    s0 = _normal((b, h, dk, dk), torch.float32, dev, rng) if state else None
    return (r, k, v, torch.from_numpy(lw.astype(np.float32)).to(dev), u, s0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("b,s,h,dk", [
    (2, 48, 3, 16), (1, 35, 2, 32), (2, 16, 1, 8), (1, 37, 4, 24),
    (1, 61, 40, 64), (1, 512, 40, 64)])
def test_wkv6_kernel_matches_plain(dev, b, s, h, dk, state, dtype):
    args = wkv6_inputs(b, s, h, dk, dtype, state, dev, s + dk)
    got = wkv6_cuda(*args)
    want = wkv6_plain(*args)
    torch.cuda.synchronize()
    assert_scan_close(got, want)


def ssd_inputs(b, s, h, hd, ds, dtype, state, dev, seed):
    rng = np.random.default_rng(seed)
    x = _normal((b, s, h, hd), dtype, dev, rng)
    bm = _normal((b, s, ds), dtype, dev, rng)
    cm = _normal((b, s, ds), dtype, dev, rng)
    dt = np.abs(rng.standard_normal((b, s, h))).astype(np.float32) * 0.5
    a_log = _normal((h,), torch.float32, dev, rng) * 0.3
    dsk = _normal((h,), torch.float32, dev, rng)
    s0 = _normal((b, h, hd, ds), torch.float32, dev, rng) if state else None
    return (x, bm, cm, torch.from_numpy(dt).to(dev), a_log, dsk, s0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("b,s,h,hd,ds", [
    (2, 48, 3, 16, 8), (1, 37, 2, 32, 16), (1, 35, 4, 24, 40),
    (1, 61, 112, 64, 64), (1, 512, 112, 64, 64)])
def test_ssd_kernel_matches_plain(dev, b, s, h, hd, ds, state, dtype):
    args = ssd_inputs(b, s, h, hd, ds, dtype, state, dev, s + hd)
    got = ssd_cuda(*args)
    want = ssd_plain(*args)
    torch.cuda.synchronize()
    assert_scan_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [16, 17, 64, 65])
def test_scan_kernels_at_chunk_boundaries(dev, s, dtype):
    """Lengths that end exactly on a chunk of 16 and one token past it."""
    args = wkv6_inputs(1, s, 4, 64, dtype, True, dev, s)
    assert_scan_close(wkv6_cuda(*args), wkv6_plain(*args))
    args = ssd_inputs(1, s, 4, 64, 64, dtype, True, dev, s)
    assert_scan_close(ssd_cuda(*args), ssd_plain(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernels_start_from_zero_without_a_state(dev, dtype):
    """s0=None (no buffer filled) gives what an explicit zero state
    gives, bit for bit."""
    args = wkv6_inputs(1, 37, 4, 64, dtype, False, dev, 1)
    zero = torch.zeros((1, 4, 64, 64), dtype=torch.float32, device=dev)
    for got, want in zip(wkv6_cuda(*args[:5], None),
                         wkv6_cuda(*args[:5], zero)):
        assert torch.equal(got, want)
    args = ssd_inputs(1, 37, 4, 64, 64, dtype, False, dev, 2)
    for got, want in zip(ssd_cuda(*args[:6], None),
                         ssd_cuda(*args[:6], zero)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernels_stay_finite_under_strong_decays(dev, dtype):
    """Decays far past the usual clip: log_w down to -50, dt up to 20."""
    rng = np.random.default_rng(5)
    args = list(wkv6_inputs(1, 70, 4, 64, dtype, True, dev, 3))
    args[3] = torch.from_numpy(np.clip(-np.exp(
        rng.standard_normal((1, 70, 4, 64)) * 2.0 + 1.0), -50.0,
        -1e-3).astype(np.float32)).to(dev)
    got = wkv6_cuda(*args)
    assert all(bool(torch.isfinite(x.float()).all()) for x in got)
    assert_scan_close(got, wkv6_plain(*args))
    args = list(ssd_inputs(1, 70, 4, 64, 64, dtype, True, dev, 4))
    args[0] = args[0] * 0.05    # dt·x of order one, as in chip_smoke.py
    args[3] = torch.from_numpy(np.minimum(np.abs(rng.standard_normal(
        (1, 70, 4))) * 10.0, 20.0).astype(np.float32)).to(dev)
    got = ssd_cuda(*args)
    assert all(bool(torch.isfinite(x.float()).all()) for x in got)
    assert_scan_close(got, ssd_plain(*args))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_cuda_recurrent_engine_matches_cpu_engine(dev, arch):
    """Reduced recurrent engines in float32: the card's (kernels) and the
    CPU's (plain versions) give the same tokens and hits, through fresh
    prefills, the no-op repeat and, for rwkv, exact extensions."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.serving.engine import AgentEngine

    cfg = get_config(arch).scaled(dtype="float32")
    kw = {"max_len": 128, "max_new_tokens": 4, "cache_slots": 2}
    gpu = AgentEngine(cfg, seed=0, device=dev, **kw)
    cpu = AgentEngine(cfg, device="cpu",
                      params=copy.deepcopy(gpu.params).cpu(), **kw)
    rng = np.random.default_rng(0)
    new = lambda n: rng.integers(1, 255, n).astype(np.int32)  # noqa: E731
    plan = (["extend", "repeat", "extend"] if arch == "rwkv6-3b"
            else ["repeat", "other", "repeat"])
    prompt = new(37)
    ops.reset_launch_counts()
    for step in ["fresh"] + plan:
        if step != "fresh":
            full = gpu.sessions["a"].prompt
            prompt = {"extend": lambda: np.concatenate([full, new(5)]),
                      "repeat": lambda: full,
                      "other": lambda: np.concatenate([full[:20], new(9)])
                      }[step]()
        a, b = (e.serve("a", prompt) for e in (gpu, cpu))
        np.testing.assert_array_equal(a.output_tokens, b.output_tokens)
        assert (a.n_hit, a.n_prompt) == (b.n_hit, b.n_prompt)
        assert (a.n_hit == 0) == (step in ("fresh", "other"))
    counts = ops.launch_counts()
    if arch == "rwkv6-3b":
        assert counts["wkv6"] == cfg.n_layers * 3           # 1 fresh, 2 extend
    else:
        assert counts["ssd"] == cfg.n_layers * 2            # 2 fresh
        assert counts["flash_attention"] == cfg.n_layers // cfg.attn_every * 2


def _serving_run(device, *, solver="cuda", n_hubs=2, fused=False):
    """An analytic 16-agent cluster and its router on ``device``: a seeded
    open-loop `EventSimulator` run over 24 coqa_like + quac_like
    dialogues; returns (metrics, router, records)."""
    from repro_torch.serving import (EventSimulator, PoissonArrivals,
                                     RoutingProfiler, SimCluster,
                                     WorkloadSpec, iter_dialogues,
                                     make_router)

    cluster = SimCluster(16, seed=3, engine_mode="analytic", device=device)
    router = make_router(cluster, solver=solver, n_hubs=n_hubs,
                         warm_start=True, audit_ledger=True, fused=fused)
    dialogues = [d for pair in zip(
        iter_dialogues(WorkloadSpec("coqa_like", 12, seed=4)),
        iter_dialogues(WorkloadSpec("quac_like", 12, seed=4))) for d in pair]
    m = EventSimulator(cluster, router, dialogues,
                       arrivals=PoissonArrivals(rate=12.0, seed=5),
                       batch_cap=16, batch_window=0.05,
                       profiler=RoutingProfiler(), lean=True).run()
    recs = [(r.request.request_id, r.agent_id, r.payment, r.n_hit,
             r.latency) for r in cluster.records]
    return m, router, recs


@pytest.mark.parametrize("n_hubs,fused", [(2, False), (1, True)])
def test_cuda_serving_run_matches_cpu_run(dev, n_hubs, fused):
    """The event simulator over an analytic cluster: the CUDA router and
    the CPU router give the same metrics (wall clock aside), records,
    accounts and settlement-ledger head; the router's kernels launched."""
    ops.reset_launch_counts()
    m_gpu, r_gpu, rec_gpu = _serving_run(dev, n_hubs=n_hubs, fused=fused)
    counts = ops.launch_counts()
    m_cpu, r_cpu, rec_cpu = _serving_run("cpu", n_hubs=n_hubs, fused=fused)
    wall = ("wall_time_s", "routing")
    assert {k: v for k, v in m_gpu.items() if k not in wall} == \
        {k: v for k, v in m_cpu.items() if k not in wall}
    assert rec_gpu == rec_cpu and not m_gpu["truncated"]
    assert r_gpu.accounts == r_cpu.accounts
    assert r_gpu.settlement.head == r_cpu.settlement.head
    batches = m_gpu["routing"]["phases"]["route_batch"]["calls"]
    assert counts["lcp_gather"] == batches > 0
    assert counts["auction_bid"] == counts["lcp_affinity"] == 0
    if fused:
        assert counts["fused_phase1"] == counts["auction_fused"] == batches
    else:
        assert counts["auction_solve"] > 0


def test_real_engine_cluster_runs_on_the_card(dev):
    """A 3-agent real-mode cluster on the card serves three coqa_like
    dialogues through the CUDA router: every dialogue finishes, the cache
    is warm, the budget balances, and the attention kernels launched as
    many times as the engines' fresh prefills and decode steps need."""
    from repro_torch.configs.iemas_cluster import MODEL_CLASSES
    from repro_torch.serving import (SimCluster, WorkloadSpec, generate,
                                     make_router, run_workload)

    cluster = SimCluster(3, seed=0, max_new_tokens=3, device=dev)
    router = make_router(cluster, audit_ledger=True)
    served = []
    for rt in cluster.agents.values():
        def serve(*args, _serve=rt.engine.serve, _rt=rt, **kw):
            res = _serve(*args, **kw)
            served.append((_rt.profile.model_class, res))
            return res
        rt.engine.serve = serve
    ops.reset_launch_counts()
    m = run_workload(cluster, router, generate(WorkloadSpec("coqa_like", 3,
                                                            seed=1)),
                     max_new_tokens=3)
    counts = ops.launch_counts()
    assert not m["truncated"] and m["kv_hit_rate"] > 0.5
    assert router.accounts["surplus"] >= 0
    router.settlement.audit(router.accounts)
    layers = {c: MODEL_CLASSES[c][0] for c, _ in served}
    fresh = sum(layers[c] for c, r in served if r.n_hit == 0)
    steps = sum(layers[c] * (r.n_gen + (r.n_hit == r.n_prompt))
                for c, r in served)
    assert counts["flash_attention"] == fresh > 0
    assert counts["decode_attention"] == steps > 0
    assert counts["lcp_gather"] > 0


def _federation(device, *, parallel="inline", n_dialogues=40):
    """The overloaded S=3 federation of the reference's federation tests
    (12 agents, every coqa_like dialogue in one domain, Poisson 300/s,
    faults, spill) on the ``cuda`` solver with warm starts and ledgers,
    every shard's router on ``device``."""
    from repro_torch.serving import (PoissonArrivals, WorkloadSpec,
                                     build_federation, generate)

    dlg = generate(WorkloadSpec("coqa_like", n_dialogues=n_dialogues,
                                seed=1))
    dom = sorted({d.domain for d in dlg})[0]
    dlg = [type(d)(d.dialogue_id, dom, d.turns, d.difficulty) for d in dlg]
    return build_federation(
        dlg, n_agents=12, super_hubs=3,
        arrivals=PoissonArrivals(rate=300.0, seed=2), seed=0,
        router_kwargs=dict(solver="cuda", warm_start=True, audit_ledger=True),
        loop_kwargs=dict(batch_cap=32, batch_window=0.05, max_new_tokens=4),
        cluster_kwargs=dict(max_new_tokens=4, fail_prob=0.1),
        max_inflight=900, epoch=0.25, spill_min_wait=0.2,
        parallel=parallel, device=device).run()


def test_cuda_federation_matches_cpu_federation(dev):
    """The overloaded federation with every shard's router on the card
    equals the same federation on the CPU (reports, accounts, every
    shard's ledger head); it migrates, settles exactly once, and gathers
    the LCP once per Phase-1 pass, never in the federation's spill round."""
    from repro_torch.core.mechanism import IEMASRouter

    passes = []
    phase1 = IEMASRouter._phase1

    def counted(self, *args):
        passes.append(self.device.type)
        return phase1(self, *args)

    IEMASRouter._phase1 = counted
    try:
        ops.reset_launch_counts()
        gpu = _federation(dev)
        counts = ops.launch_counts()
    finally:
        IEMASRouter._phase1 = phase1
    cpu = _federation("cpu")
    assert comparable(gpu) == comparable(cpu)
    assert gpu["federation"]["spill_migrated"] > 0
    assert gpu["federation"]["exactly_once"]["ok"]
    assert counts["lcp_gather"] == passes.count("cuda") == len(passes) > 0
    assert counts["auction_solve"] > 0
    assert counts["auction_bid"] == counts["lcp_affinity"] == 0


def test_cuda_process_shards_match_inline(dev):
    """Each shard in a spawned process with its own CUDA context gives the
    inline run's report, accounts and ledger heads."""
    inline = _federation(dev)
    proc = _federation(dev, parallel="process")
    assert comparable(proc) == comparable(inline)
    assert proc["federation"]["exactly_once"]["ok"]


# ------------------- the encoder-decoder and patch-input models' shapes --
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,h,hkv,d,causal", [
    (1024, 1024, 16, 16, 64, False),     # seamless's encoder
    (16, 1024, 16, 16, 64, False),       # its cross-attention, bucket 16
    (512, 1024, 16, 16, 64, False),      # ... bucket 512
    (1000, 1024, 16, 16, 64, False),     # a prompt that is no tile multiple
    (3008, 3008, 56, 8, 128, True)])     # llava: 2,880 patches + 128 text
def test_flash_kernel_at_encdec_and_patch_shapes(dev, sq, sk, h, hkv, d,
                                                 causal, dtype):
    """The modes the encoder-decoder adds (non-causal, Sq = Sk and Sq !=
    Sk) and llava's patched prefill, the longest causal one."""
    rng = np.random.default_rng(sq + sk + h)
    q = _normal((1, sq, h, d), dtype, dev, rng)
    k = _normal((1, sk, hkv, d), dtype, dev, rng)
    v = _normal((1, sk, hkv, d), dtype, dev, rng)
    got = flash_attention_cuda(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.shape == (1, sq, h, d)
    assert float((got.float() - want.float()).abs().max()) < ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,d,m,n_valid", [
    (16, 16, 64, 1024, 1024),            # seamless's cross decode
    (16, 16, 64, 1024, 40),              # its self-attention decode
    (56, 8, 128, 4096, 3072)])           # llava after its patched prompt
def test_decode_kernel_at_encdec_and_patch_shapes(dev, h, hkv, d, m,
                                                  n_valid, dtype):
    rng = np.random.default_rng(m + n_valid)
    q = _normal((1, h, d), dtype, dev, rng)
    kc = _normal((1, m, hkv, d), dtype, dev, rng)
    vc = _normal((1, m, hkv, d), dtype, dev, rng)
    valid = torch.arange(m, device=dev)[None, :] < n_valid
    got = decode_attention_cuda(q, kc, vc, valid)
    want = decode_attention_plain(q, kc, vc, valid)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) < ATTN_TOL[dtype]


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "llava-next-34b"])
def test_cuda_encdec_and_patch_models_match_cpu(dev, arch, monkeypatch):
    """Reduced models in float32 on the same weights, the card's against
    the CPU's: a prefill with 0.1 · N(0, 1) frames or patches, three decode
    steps (and llava's extend), logits within 2e-3 of their max; then the
    launches: seamless one flash call per encoder layer and two per
    decoder layer (self, cross) a prefill and two decode calls per decoder
    layer a step, llava one and one per layer."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_config(arch).scaled(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    cpu_params = copy.deepcopy(params).cpu()
    rng = np.random.default_rng(0)
    side = ({"frames": (cfg.src_len, cfg.d_model)} if cfg.is_encdec
            else {"patches": (cfg.n_patches, cfg.d_model)})
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 24)),
             "lens": np.array([24, 17]),
             **{k: 0.1 * rng.standard_normal((2, *sh))
                for k, sh in side.items()}}
    batch = {k: torch.from_numpy(v.astype(np.int32 if v.dtype.kind == "i"
                                          else np.float32))
             for k, v in batch.items()}
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, 2)
                              .astype(np.int32)) for _ in range(3)]
    ext = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8))
                           .astype(np.int32))
    lens_new = torch.tensor([8, 5], dtype=torch.int32)

    def run(p, device):
        on = {k: v.to(device) for k, v in batch.items()}
        logits, cache = model.prefill(p, {**on, "max_len": 64})
        out = [logits]
        for tok in steps:
            logits, cache = model.decode_step(p, cache, tok.to(device))
            out.append(logits)
        if not cfg.is_encdec:
            logits, cache = model.extend(p, cache, ext.to(device),
                                         lens_new.to(device))
            out.append(logits)
        return [x.double().cpu() for x in out]

    ops.reset_launch_counts()
    got = run(params, dev)
    counts = ops.launch_counts()
    want = run(cpu_params, "cpu")
    for g, w in zip(got, want):
        assert float((g - w).abs().max() / w.abs().max()) < 2e-3
    flash, per_step = ((cfg.enc_layers + 2 * cfg.n_layers, 2)
                       if cfg.is_encdec else (cfg.n_layers, 1))
    assert counts["flash_attention"] == flash
    assert counts["decode_attention"] == per_step * cfg.n_layers * 3


# ---------------------------------------------------------- training --

BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# each row (a query and head of dQ, a key and KV head of dK / dV) within
# BWD_ROW_TOL of its own largest plain value, counted as at least
# BWD_ROW_FLOOR of the output's largest (dQ's first row under a causal mask
# is exactly 0: both versions hold rounding noise there); chip_smoke.py's
# ATTN_ROW_TOL and BWD_ROW_FLOOR
BWD_ROW_TOL, BWD_ROW_FLOOR = 2e-2, 1e-3


def _bwd_inputs(b, sq, sk, h, hkv, d, causal, win, dtype, dev, seed):
    """q, k, v, the forward kernel's o, a seeded dO and the forward's
    LSE, in the backward's argument order."""
    rng = np.random.default_rng(seed)
    q = _normal((b, sq, h, d), dtype, dev, rng)
    k = _normal((b, sk, hkv, d), dtype, dev, rng)
    v = _normal((b, sk, hkv, d), dtype, dev, rng)
    o, lse = flash_attention_cuda(q, k, v, causal=causal, window=win,
                                  return_lse=True)
    do = _normal((b, sq, h, d), dtype, dev, rng)
    return q, k, v, o, do, lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,win", [
    (2, 512, 512, 32, 8, 128, True, 0),       # phase 24 qwen3-8b
    (2, 512, 512, 48, 8, 128, True, 16),      # phase 24 mixtral, window 16
    (2, 512, 1024, 16, 16, 64, False, 0),     # phase 25 seamless cross
    (1, 100, 100, 6, 1, 12, True, 7), (1, 70, 30, 8, 2, 100, False, 0)])
def test_flash_lse_keeps_the_output_bits_and_matches_plain(
        dev, b, sq, sk, h, hkv, d, causal, win, dtype):
    """The forward's output is the same bits with and without its LSE, and
    the LSE is within 1e-5 of the plain one relative to max(|lse|, 1) in
    float32, within 1e-4 absolute for bf16 inputs (a float32 LSE)."""
    from repro_torch.kernels.flash_attention import attention_lse_ref

    rng = np.random.default_rng(sq + sk + d)
    q = _normal((b, sq, h, d), dtype, dev, rng)
    k = _normal((b, sk, hkv, d), dtype, dev, rng)
    v = _normal((b, sk, hkv, d), dtype, dev, rng)
    kw = dict(causal=causal, window=win)
    out = flash_attention_cuda(q, k, v, **kw)
    again, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    want = attention_lse_ref(q, k, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    err = (lse - want).abs()
    if dtype == torch.float32:
        assert bool((err <= 1e-5 * want.abs().clamp_min(1.0)).all())
    else:
        assert float(err.max()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,win", [
    (2, 512, 512, 32, 8, 128, True, 0),       # phase 24 qwen3-8b
    (2, 512, 512, 48, 8, 128, True, 16),      # phase 24 mixtral, window 16
    (2, 256, 256, 16, 16, 64, False, 0),      # phase 24 seamless encoder
    (2, 512, 256, 16, 16, 64, False, 0),      # ... its cross-attention
    (1, 4096, 4096, 32, 8, 128, True, 0),     # phase 25 qwen3-8b
    (2, 1024, 1024, 16, 16, 64, False, 0),    # phase 25 seamless encoder
    (2, 512, 1024, 16, 16, 64, False, 0),     # ... its cross-attention
    (2, 512, 512, 16, 16, 64, True, 0),       # ... its decoder
    (1, 100, 100, 6, 1, 12, True, 7), (2, 37, 61, 4, 2, 20, False, 9),
    (1, 70, 30, 8, 2, 100, False, 0), (3, 33, 33, 2, 2, 4, True, 0)])
def test_flash_bwd_kernel_matches_plain(dev, b, sq, sk, h, hkv, d, causal,
                                        win, dtype):
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain)

    args = _bwd_inputs(b, sq, sk, h, hkv, d, causal, win, dtype, dev,
                       sq + sk + d)
    kw = dict(causal=causal, window=win)
    got = flash_attention_bwd_cuda(*args, **kw)
    want = flash_attention_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, w, x in zip(got, want, args[:3]):
        assert g.dtype == dtype and g.shape == x.shape
        err = float((g.float() - w.float()).abs().max())
        assert err <= BWD_TOL[dtype] * float(w.float().abs().max())
        g, w = g.float(), w.float()
        least = BWD_ROW_FLOOR * float(w.abs().max())
        rows = (g - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(least)
        assert float(rows.max()) <= BWD_ROW_TOL
    again = flash_attention_bwd_cuda(*args, **kw)
    for g, a in zip(got, again):
        assert torch.equal(g, a)               # no atomics: the same bits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,hkv,d,q_offset,win", [
    (1, 2048, 4096, 32, 8, 128, 2048, 0),    # phase 27: the second rank
    (1, 2048, 4096, 32, 8, 128, 1000, 0),    # an offset off the tiles
    (2, 100, 300, 8, 2, 64, 37, 0), (2, 100, 300, 8, 2, 64, 200, 0),
    (1, 100, 300, 4, 4, 128, 64, 50), (2, 61, 200, 6, 2, 20, 77, 24),
    (1, 33, 80, 4, 1, 112, 47, 0)])
def test_flash_kernels_with_offset_match_plain(dev, b, sq, sk, h, hkv, d,
                                               q_offset, win, dtype):
    """A block of query rows at ``q_offset`` (a rank of a sequence split):
    the forward within the attention gate of its plain version, its LSE
    within the LSE test's gate, the backward within BWD_TOL of each
    output's largest plain value and each row within BWD_ROW_TOL; and an
    offset of 0 gives the same bits as the call without one."""
    from repro_torch.kernels.flash_attention import (
        attention_lse_ref, flash_attention_bwd_cuda,
        flash_attention_bwd_plain)

    rng = np.random.default_rng(sq + sk + q_offset)
    q = _normal((b, sq, h, d), dtype, dev, rng)
    k = _normal((b, sk, hkv, d), dtype, dev, rng)
    v = _normal((b, sk, hkv, d), dtype, dev, rng)
    do = _normal((b, sq, h, d), dtype, dev, rng)
    kw = dict(causal=True, window=win, q_offset=q_offset)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    want_lse = attention_lse_ref(q, k, **kw)
    got = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    want_g = flash_attention_bwd_plain(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    assert float((o.float() - want.float()).abs().max()) < ATTN_TOL[dtype]
    err = (lse - want_lse).abs()
    if dtype == torch.float32:
        assert bool((err <= 1e-5 * want_lse.abs().clamp_min(1.0)).all())
    else:
        assert float(err.max()) <= 1e-4
    for g, w in zip(got, want_g):
        g, w = g.float(), w.float()
        assert float((g - w).abs().max()) <= BWD_TOL[dtype] * float(
            w.abs().max())
        least = BWD_ROW_FLOOR * float(w.abs().max())
        rows = (g - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(least)
        assert float(rows.max()) <= BWD_ROW_TOL
    zero = dict(causal=True, window=win)
    o0, lse0 = flash_attention_cuda(q, k, v, return_lse=True, q_offset=0,
                                    **zero)
    o1, lse1 = flash_attention_cuda(q, k, v, return_lse=True, **zero)
    assert torch.equal(o0, o1) and torch.equal(lse0, lse1)
    g0 = flash_attention_bwd_cuda(q, k, v, o1, do, lse1, q_offset=0, **zero)
    g1 = flash_attention_bwd_cuda(q, k, v, o1, do, lse1, **zero)
    assert all(torch.equal(x, y) for x, y in zip(g0, g1))


def test_flash_offset_outside_the_keys_raises(dev):
    q = torch.zeros((1, 64, 4, 32), device=dev)
    k = torch.zeros((1, 128, 2, 32), device=dev)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention_cuda(q, k, k, q_offset=65)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention_cuda(q, k, k, causal=False, q_offset=8)


@pytest.mark.parametrize("arch", ["qwen3-8b", "mixtral-8x22b",
                                  "seamless-m4t-medium", "rwkv6-3b",
                                  "zamba2-7b"])
def test_cuda_gradients_match_cpu(dev, arch):
    """A reduced float32 model's loss and gradients on the card (the flash
    and scan kernels behind their autograd Functions, TF32 off) against
    the CPU's plain autograd on the same weights, with 2·L forward and L
    backward launches of each kernel under remat (L its calls in one
    forward: attention layers, encoder and decoder calls, the scan layers,
    zamba2's shared-block applications)."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training.loop import loss_and_grads
    from repro_torch.utils.tree import tree_leaves

    over = {"sliding_window": 16} if arch == "mixtral-8x22b" else {}
    cfg = get_config(arch).scaled(dtype="float32", **over)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    cpu_params = copy.deepcopy(params).cpu()
    for p in (*tree_leaves(params), *tree_leaves(cpu_params)):
        p.requires_grad_(True)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32))}
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy((0.1 * rng.standard_normal(
            (2, cfg.src_len, cfg.d_model))).astype(np.float32))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ops.reset_launch_counts()
        loss, grads = loss_and_grads(model, params,
                                     {k: v.to(dev) for k, v in batch.items()})
        counts = ops.launch_counts()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want_loss, want = loss_and_grads(model, cpu_params, batch)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        assert float((g.cpu() - w).abs().max()) \
            <= 1e-4 * float(w.abs().max()) + 1e-12
    if cfg.is_encdec:
        calls = {"flash_attention": cfg.enc_layers + 2 * cfg.n_layers}
    elif cfg.ssm_kind == "rwkv6":
        calls = {"wkv6": cfg.n_layers, "flash_attention": 0}
    elif cfg.ssm_kind == "mamba2":
        calls = {"ssd": cfg.n_layers,
                 "flash_attention": cfg.n_layers // cfg.attn_every}
    else:
        calls = {"flash_attention": cfg.n_layers}
    for op, n in calls.items():
        assert counts[op] == 2 * n and counts[f"{op}_bwd"] == n, counts


def test_kernel_ops_without_a_backward_raise_under_grad(dev):
    rng = np.random.default_rng(0)
    q = _normal((1, 2, 16), torch.float32, dev, rng).requires_grad_(True)
    cache = _normal((1, 8, 2, 16), torch.float32, dev, rng)
    valid = torch.ones((1, 8), dtype=torch.bool, device=dev)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ops.decode_attention_op(q, cache, cache, valid)
    with torch.no_grad():                     # the serving path runs it
        out = ops.decode_attention_op(q, cache, cache, valid)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.grad_fn is None


def test_flash_op_without_grad_launches_only_the_forward(dev):
    rng = np.random.default_rng(0)
    q = _normal((1, 64, 4, 32), torch.float32, dev, rng).requires_grad_(True)
    k = _normal((1, 64, 2, 32), torch.float32, dev, rng)
    ops.reset_launch_counts()
    with torch.no_grad():
        out = ops.flash_attention_op(q, k, k)
    assert out.grad_fn is None
    assert ops.launch_counts()["flash_attention"] == 1
    out = ops.flash_attention_op(q, k, k)
    assert out.grad_fn is not None
    out.sum().backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 2
    assert counts["flash_attention_bwd"] == 1
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())


# the scans' backward kernels: rwkv6-3b's and zamba2-7b's head layouts at
# the lockstep's and train_4k's lengths, ragged and narrow shapes

def _scan_bwd_gates(got, want, rows, dtype):
    """Each gradient within BWD_TOL of its largest plain magnitude and, for
    the ``rows`` ones (last axis a row), each row within BWD_ROW_TOL of its
    own largest plain value, floored at BWD_ROW_FLOOR."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert bool(torch.isfinite(g.float()).all()), i
        g, w = g.float(), w.float()
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= BWD_TOL[dtype] * scale, i
        if i in rows:
            least = BWD_ROW_FLOOR * scale
            err = (g - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(least)
            assert float(err.max()) <= BWD_ROW_TOL, i


def _strong_wkv6(args, dev, seed):
    rng = np.random.default_rng(seed)
    lw = np.clip(-np.exp(rng.standard_normal(tuple(args[3].shape)) * 2.0
                         + 1.0), -50.0, -1e-3).astype(np.float32)
    return (*args[:3], torch.from_numpy(lw).to(dev), *args[4:])


def _strong_ssd(args, dev, seed):
    rng = np.random.default_rng(seed)
    dt = np.minimum(np.abs(rng.standard_normal(tuple(args[3].shape)))
                    * 10.0, 20.0).astype(np.float32)
    return (args[0] * 0.05, *args[1:3], torch.from_numpy(dt).to(dev),
            *args[4:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,dk,state,grad_st,strong", [
    (2, 61, 40, 64, True, True, False),       # rwkv6-3b, ragged
    (2, 512, 40, 64, False, False, False),    # phase 24's lockstep
    (1, 4096, 40, 64, False, False, False),   # train_4k
    (2, 512, 40, 64, True, True, True),       # log_w down to -50
    (2, 37, 3, 16, True, False, False), (1, 100, 2, 24, False, True, True)])
def test_wkv6_bwd_kernel_matches_plain(dev, b, s, h, dk, state, grad_st,
                                       strong, dtype):
    from repro_torch.kernels.wkv6 import wkv6_bwd_cuda, wkv6_bwd_plain

    args = wkv6_inputs(b, s, h, dk, dtype, state, dev, s + dk)
    if strong:
        args = _strong_wkv6(args, dev, s)
    rng = np.random.default_rng(dk)
    do = _normal((b, s, h, dk), dtype, dev, rng)
    dst = _normal((b, h, dk, dk), torch.float32, dev, rng) if grad_st \
        else None
    _, s_t, states = wkv6_cuda(*args, return_states=True)
    got = wkv6_bwd_cuda(*args[:5], states, s_t, do, dst, want_ds0=True)
    want = wkv6_bwd_plain(*args, do, dst)
    torch.cuda.synchronize()
    _scan_bwd_gates(got, want, {0, 1, 2, 3}, dtype)
    again = wkv6_bwd_cuda(*args[:5], states, s_t, do, dst, want_ds0=True)
    for g, a in zip(got, again):
        assert torch.equal(g, a)               # no atomics: the same bits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hd,ds,state,grad_st,strong", [
    (2, 61, 112, 64, 64, True, True, False),      # zamba2-7b, ragged
    (2, 512, 112, 64, 64, False, False, False),   # phase 24's lockstep
    (1, 4096, 112, 64, 64, False, False, False),  # train_4k
    (2, 512, 112, 64, 64, True, True, True),      # dt up to 20
    (2, 37, 3, 24, 16, True, False, False),
    (1, 100, 9, 32, 40, False, True, True)])
def test_ssd_bwd_kernel_matches_plain(dev, b, s, h, hd, ds, state, grad_st,
                                      strong, dtype):
    from repro_torch.kernels.ssd import ssd_bwd_cuda, ssd_bwd_plain

    args = ssd_inputs(b, s, h, hd, ds, dtype, state, dev, s + hd)
    if strong:
        args = _strong_ssd(args, dev, s)
    rng = np.random.default_rng(hd)
    dy = _normal((b, s, h, hd), dtype, dev, rng)
    dst = _normal((b, h, hd, ds), torch.float32, dev, rng) if grad_st \
        else None
    _, _, states = ssd_cuda(*args, return_states=True)
    got = ssd_bwd_cuda(*args[:6], states, dy, dst, want_ds0=True)
    want = ssd_bwd_plain(*args, dy, dst)
    torch.cuda.synchronize()
    _scan_bwd_gates(got, want, {0, 1, 2}, dtype)
    again = ssd_bwd_cuda(*args[:6], states, dy, dst, want_ds0=True)
    for g, a in zip(got, again):
        assert torch.equal(g, a)               # no atomics: the same bits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_forwards_keep_their_bits_with_states(dev, dtype):
    """The forward kernels give the same output and final state with and
    without ``return_states``, and the saved states are the plain chunked
    recurrence's incoming states (chunk 0's is s0)."""
    args = wkv6_inputs(2, 61, 40, 64, dtype, True, dev, 7)
    o, s_t = wkv6_cuda(*args)
    o2, s_t2, states = wkv6_cuda(*args, return_states=True)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(s_t, s_t2)
    assert states.shape == (2, 40, 4, 64, 64)
    assert torch.equal(states[:, :, 0], args[5])
    tail = [a[:, 48:] for a in args[:4]]
    _, want = wkv6_plain(*tail, args[4], states[:, :, 3])
    assert float((want - s_t).abs().max()) < 1e-3
    args = ssd_inputs(2, 61, 112, 64, 64, dtype, True, dev, 8)
    y, s_t = ssd_cuda(*args)
    y2, s_t2, states = ssd_cuda(*args, return_states=True)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(s_t, s_t2)
    assert torch.equal(states[:, :, 0], args[6])
    tail = [a[:, 48:] for a in args[:4]]
    _, want = ssd_plain(*tail, *args[4:6], states[:, :, 3])
    assert float((want - s_t).abs().max()) < 1e-3


def test_scan_ops_under_grad_never_reach_a_plain_version(dev, monkeypatch):
    """On the card, wkv6_op and ssd_op under grad run the kernels forward
    and backward: with every plain version patched to raise, the gradients
    still come, with one forward and one backward launch each."""
    from repro_torch.kernels import ssd as ssd_mod
    from repro_torch.kernels import wkv6 as wkv6_mod

    def refuse(*args, **kw):
        raise AssertionError("a plain version ran on the card")

    for mod, names in ((ops, ("wkv6_plain", "ssd_plain")),
                       (wkv6_mod, ("wkv6_plain", "wkv6_bwd_plain")),
                       (ssd_mod, ("ssd_plain", "ssd_bwd_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    ops.reset_launch_counts()
    args = [a.requires_grad_(True) if a.dtype == torch.float32 else a
            for a in wkv6_inputs(1, 40, 4, 64, torch.float32, True, dev, 9)]
    o, _ = ops.wkv6_op(*args)
    grads = torch.autograd.grad(o.sum(), args)
    args = [a.requires_grad_(True)
            for a in ssd_inputs(1, 40, 4, 64, 64, torch.float32, True, dev,
                                10)]
    y, _ = ops.ssd_op(*args)
    grads += torch.autograd.grad(y.sum(), args)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    counts = ops.launch_counts()
    assert [counts[k] for k in ("wkv6", "wkv6_bwd", "ssd", "ssd_bwd")] \
        == [1, 1, 1, 1]


@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-7b"])
def test_policy_training_on_one_card_matches_plain(dev, arch):
    """``train_loop`` under the training policy on a one-card mesh (a
    one-rank group over a HashStore) is the plain loop bit for bit: every
    placement is Replicate.  Both launch the same kernels."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.elastic import remesh
    from repro_torch.distributed.sharding import (TRAIN_PARAM_RULES,
                                                  TRAIN_RULES, ShardingPolicy,
                                                  apply_policy)
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig, SyntheticLM, train_loop
    from repro_torch.training.loop import gathered
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config(arch).scaled(dtype="float32")
    model = build_model(cfg)
    data = SyntheticLM(cfg.vocab_size, 64, 2, seed=0)
    opt = OptConfig(lr=3e-3, warmup_steps=1, total_steps=3)
    runs = []
    try:
        for placed in (False, True):
            policy = (ShardingPolicy(remesh(1, device_type="cuda"),
                                     acts=TRAIN_RULES,
                                     params=TRAIN_PARAM_RULES)
                      if placed else None)
            ops.reset_launch_counts()
            with apply_policy(policy):
                out = train_loop(model, data, steps=3, opt_cfg=opt,
                                 log_every=1, device=dev)
            torch.cuda.synchronize()
            runs.append((out["losses"], gathered(out["params"]),
                         ops.launch_counts()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    (l0, p0, c0), (l1, p1, c1) = runs
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p0),
                                                 tree_leaves(p1)))
    assert c0 == c1 and c1["flash_attention_bwd"] > 0

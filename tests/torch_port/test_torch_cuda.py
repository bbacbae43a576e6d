"""The hand-written CUDA kernels against their plain versions at the main
path's shapes, and a short CUDA-vs-CPU router lockstep.  These need an
NVIDIA GPU (and ``nvcc`` to build the kernels); where none is present they
skip, deciding inside the fixture."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.auction_bid import (auction_bid_cuda,  # noqa: E402
                                             auction_bid_plain)
from repro_torch.kernels.lcp_affinity import (lcp_affinity_cuda,  # noqa: E402
                                              lcp_affinity_plain)

pytestmark = pytest.mark.cuda
BIG = np.float32(np.finfo(np.float32).max / 4)


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


def test_ops_count_kernel_launches(dev):
    ops.reset_launch_counts()
    ops.auction_bid_op(*bid_inputs(8, 4, 0, dev))
    ops.lcp_affinity_op(*lcp_inputs(2, 3, 40, 0, dev))
    ops.lcp_affinity_op(*lcp_inputs(2, 3, 40, 0, "cpu"))      # plain: uncounted
    assert ops.launch_counts() == {"auction_bid": 1, "lcp_affinity": 1}


def test_cuda_router_matches_cpu_router(dev):
    from repro_torch.configs.iemas_cluster import (RouterConfig, agent_infos,
                                                   agent_profiles,
                                                   make_router)
    from repro_torch.core.mechanism import CompletionObs, Request

    infos = agent_infos(agent_profiles(16))
    cfg = RouterConfig(warm_start=True, audit_ledger=True)
    gpu = make_router(infos, cfg, device=dev)
    cpu = make_router(infos, cfg, device="cpu")
    rng = np.random.default_rng(0)
    ops.reset_launch_counts()
    for t in range(4):
        reqs = [(f"r{t}_{j}", f"d{j}", rng.integers(1, 50, 20 + 10 * t),
                 "dialogue" if j % 2 else "code") for j in range(12)]
        out = [r.route_batch([Request(a, b, c.astype(np.int32), t, d)
                              for a, b, c, d in reqs], {})
               for r in (gpu, cpu)]
        for a, b in zip(*out):
            assert (a.agent_id, a.payment) == (b.agent_id, b.payment)
            if a.agent_id is not None:
                obs = CompletionObs(0.05, len(a.request.tokens), 0, 6, 0.7)
                gpu.on_complete(a.request.request_id, obs)
                cpu.on_complete(b.request.request_id, obs)
    assert gpu.accounts == cpu.accounts
    assert gpu.settlement.head == cpu.settlement.head
    counts = ops.launch_counts()
    assert counts["lcp_affinity"] == 4 and counts["auction_bid"] > 0

"""The port's plain kernel versions (`repro_torch.kernels.ref`, what a CPU
tensor runs) against the reference's oracles and its interpret-mode Pallas
kernel: LCP exactly, the auction bidding round bit for bit."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.lcp_affinity import lcp_affinity  # noqa: E402
from repro.kernels.ref import auction_bid_ref as jax_bid_ref  # noqa: E402
from repro.kernels.ref import lcp_ref as jax_lcp_ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import auction_bid_ref, lcp_ref  # noqa: E402

BIG = np.float32(np.finfo(np.float32).max / 4)
# one compiled program per shape instead of one per eager op
jax_bid = jax.jit(jax_bid_ref)


def _lcp_instance(seed: int, n: int = 5, m: int = 6, length: int = 45):
    """Prompts padded with -1 and ledger rows padded with -2 whose shared
    prefixes have seeded lengths; row 0 is an empty prompt, every request
    has one all-pad (absent) ledger row and one full match."""
    rng = np.random.default_rng(seed)
    prompts = np.full((n, length), -1, np.int32)
    ledgers = np.full((n, m, length), -2, np.int32)
    for j in range(n):
        plen = 0 if j == 0 else int(rng.integers(1, length + 1))
        prompts[j, :plen] = rng.integers(1, 6, plen)
        for i in range(m):
            if i == 0:
                continue                       # absent entry: all padding
            if i == 1:
                ledgers[j, i] = prompts[j]     # full match (padding differs)
                ledgers[j, i, plen:] = -2
                continue
            llen = int(rng.integers(0, length + 1))
            shared = min(int(rng.integers(0, plen + 1)), llen)
            ledgers[j, i, :shared] = prompts[j, :shared]
            ledgers[j, i, shared:llen] = rng.integers(1, 6, llen - shared)
    return prompts, ledgers


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lcp_plain_matches_reference_oracle_and_pallas(seed):
    prompts, ledgers = _lcp_instance(seed)
    got = lcp_ref(torch.from_numpy(prompts), torch.from_numpy(ledgers))
    assert got.dtype == torch.int32
    want = jax_lcp_ref(prompts, ledgers)
    pallas = np.asarray(lcp_affinity(prompts, ledgers, interpret=True))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), pallas)
    # the dispatcher takes the plain version for CPU tensors, uncounted
    ops.reset_launch_counts()
    via_op = ops.lcp_affinity_op(torch.from_numpy(prompts),
                                 torch.from_numpy(ledgers))
    assert np.array_equal(via_op.numpy(), want)
    assert ops.launch_counts() == {"auction_bid": 0, "auction_solve": 0,
                                   "auction_fused": 0, "fused_phase1": 0,
                                   "lcp_affinity": 0, "lcp_gather": 0,
                                   "flash_attention": 0,
                                   "flash_attention_bwd": 0,
                                   "decode_attention": 0, "wkv6": 0,
                                   "ssd": 0}


def test_lcp_plain_edge_widths():
    """Full-width match (LCP = L), zero width, a single token."""
    p = np.array([[3, 4, 5]], np.int32)
    led = np.array([[[3, 4, 5], [3, 9, 5], [-2, -2, -2]]], np.int32)
    got = lcp_ref(torch.from_numpy(p), torch.from_numpy(led)).numpy()
    assert got.tolist() == [[3, 1, 0]] == jax_lcp_ref(p, led).tolist()
    empty = lcp_ref(torch.zeros((2, 0), dtype=torch.int32),
                    torch.zeros((2, 3, 0), dtype=torch.int32))
    assert empty.shape == (2, 3) and not empty.any()
    one = lcp_ref(torch.tensor([[7]], dtype=torch.int32),
                  torch.tensor([[[7], [8]]], dtype=torch.int32))
    assert one.tolist() == [[1, 0]]


def _bid_instance(seed: int):
    """The reference kernel test's instance family, with injected ties: a
    duplicated weight column (two agents at one profit) and a duplicated
    row (two requests at one bid)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 48))
    m = int(rng.integers(2, 72))
    W = np.maximum(rng.uniform(-1, 4, (n, m)), 0.0).astype(np.float32)
    ask = rng.uniform(0, 3, m).astype(np.float32)
    ask2 = (ask + rng.uniform(0, 2, m)).astype(np.float32)
    ask2 = np.where(rng.random(m) < 0.2, BIG, ask2)  # single-unit agents
    W[:, 1] = W[:, 0] - ask[0] + ask[1]
    W[1] = W[0]
    active = rng.random(n) > rng.uniform(0, 1)
    active[:2] = True
    eps = np.float32(rng.uniform(1e-4, 0.5))
    return W, ask, ask2, active, eps


def _check_bid(W, ask, ask2, active, eps):
    got = auction_bid_ref(torch.from_numpy(W), torch.from_numpy(ask),
                          torch.from_numpy(ask2), torch.from_numpy(active),
                          eps)
    want = jax_bid(W, ask, ask2, active, eps)
    for g, w, name in zip(got, want, ("best", "winner", "wants")):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, name
        assert np.array_equal(g, w), f"{name}: {g} vs {w}"
        if g.dtype == np.float32:
            assert np.array_equal(g.view(np.int32), w.view(np.int32)), name


@pytest.mark.parametrize("seed", range(6))
def test_bid_plain_bit_exact_with_reference(seed):
    _check_bid(*_bid_instance(seed))


def test_bid_plain_degenerate_inputs():
    """Single request / single agent / nobody active / all-zero weights /
    total ties — the reference kernel test's degenerate cases."""
    cases = [
        (np.ones((1, 1), np.float32), np.zeros(1, np.float32),
         np.full(1, BIG, np.float32), np.ones(1, bool)),
        (np.zeros((4, 3), np.float32), np.zeros(3, np.float32),
         np.zeros(3, np.float32), np.ones(4, bool)),
        (np.ones((5, 2), np.float32), np.ones(2, np.float32),
         np.ones(2, np.float32), np.zeros(5, bool)),
        (np.full((3, 7), 2.5, np.float32), np.zeros(7, np.float32),
         np.zeros(7, np.float32), np.ones(3, bool)),
    ]
    for W, ask, ask2, active in cases:
        _check_bid(W, ask, ask2, active, np.float32(0.1))


def test_ops_reject_other_devices():
    meta = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.lcp_affinity_op(meta, torch.zeros((2, 1, 3), dtype=torch.int32,
                                              device="meta"))

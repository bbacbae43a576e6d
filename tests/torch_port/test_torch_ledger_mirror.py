"""The prefix ledger's arena on the device: the port's `PaddedLedgerStore`
dirty tracking against the reference's, op for op; its `LedgerMirror` (on
the CPU here) against the store after every sync; the row-gather LCP's
plain version against `lcp_ref` on the dense tile; and the router's
affinity matrix through the gather path against the per-pair host loop and
the reference ledger."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.affinity import PaddedLedgerStore as RefStore  # noqa: E402
from repro.core.affinity import PrefixLedger as RefLedger  # noqa: E402
from repro_torch.core.affinity import (LedgerMirror,  # noqa: E402
                                       PaddedLedgerStore, PrefixLedger)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import lcp_gather_ref, lcp_ref  # noqa: E402


def _ops(seed: int, count: int = 60):
    """Seeded puts (new keys, overwrites, long rows that regrow the width)
    and drops (whose rows are recycled by later puts)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        key = (f"a{rng.integers(0, 4)}", f"d{rng.integers(0, 9)}")
        if rng.random() < 0.25:
            out.append(("drop", key, None))
        else:
            length = int(rng.integers(0, 40 if rng.random() < 0.9 else 90))
            out.append(("put", key, rng.integers(0, 50, length,
                                                 dtype=np.int32)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_store_dirty_rows_match_reference(seed):
    port, ref = PaddedLedgerStore(), RefStore()
    mirror = LedgerMirror(port, "cpu")
    for what, key, toks in _ops(seed):
        if what == "put":
            assert port.put(key, toks) == ref.put(key, toks)
        else:
            port.drop(key)
            ref.drop(key)
        assert port.shape_version == ref.shape_version
        assert port.version == ref.version
        assert sorted(port._dirty) == sorted(ref._dirty)
        assert np.array_equal(port.tokens, ref.tokens)
        assert np.array_equal(port.lens, ref.lens)
        if what == "drop":
            # drain both (the mirror drains the port's store)
            mirror.sync()
            ref.consume_dirty()
            assert not port._dirty
            assert torch.equal(mirror.tokens, torch.from_numpy(port.tokens))
            assert torch.equal(mirror.lens, torch.from_numpy(port.lens))
    assert ref.shape_version > 1                 # the arena regrew
    assert sorted(port.consume_dirty()) == sorted(ref.consume_dirty())


def test_mirror_sends_only_dirty_rows_until_a_regrow():
    store = PaddedLedgerStore()
    mirror = LedgerMirror(store, "cpu")
    store.put(("a", "d0"), np.arange(5, dtype=np.int32))
    mirror.sync()
    full = store.tokens.nbytes + store.lens.nbytes
    assert mirror.bytes_sent == full
    store.put(("a", "d1"), np.arange(3, dtype=np.int32))
    store.put(("a", "d0"), np.arange(4, dtype=np.int32))   # overwrite
    mirror.sync()
    width = store.tokens.shape[1]
    assert mirror.bytes_sent == full + 2 * (8 + 4 * width + 4)
    assert torch.equal(mirror.tokens, torch.from_numpy(store.tokens))
    mirror.sync()                                           # nothing dirty
    assert mirror.bytes_sent == full + 2 * (8 + 4 * width + 4)
    store.put(("b", "d0"), np.arange(100, dtype=np.int32))  # regrows width
    sent = mirror.bytes_sent
    mirror.sync()
    assert mirror.bytes_sent == sent + store.tokens.nbytes + store.lens.nbytes
    assert torch.equal(mirror.tokens, torch.from_numpy(store.tokens))
    assert torch.equal(mirror.lens, torch.from_numpy(store.lens))


@pytest.mark.parametrize("lp,la", [(40, 64), (64, 64), (100, 64), (31, 8)])
def test_gather_plain_is_lcp_on_the_dense_tile(lp, la):
    """Arena rows recycled across requests, row 0 the all-pad sentinel,
    prompts narrower and wider than the arena."""
    rng = np.random.default_rng(lp + la)
    n, m, s = 6, 5, 12
    arena = np.full((s, la), -2, np.int32)
    for r in range(1, s):
        k = int(rng.integers(0, la + 1))
        arena[r, :k] = rng.integers(0, 4, k)
    prompts = np.full((n, lp), -1, np.int32)
    rows = rng.integers(0, s, (n, m)).astype(np.int32)
    for j in range(n):
        k = int(rng.integers(0, lp + 1))
        prompts[j, :k] = rng.integers(0, 4, k)
        src = arena[rows[j, 0], :min(k, la)]
        prompts[j, :len(src)] = np.where(src >= 0, src, prompts[j, :len(src)])
    tile = np.full((n, m, lp), -2, np.int32)
    tile[:, :, :min(lp, la)] = arena[rows][:, :, :min(lp, la)]
    want = lcp_ref(torch.from_numpy(prompts), torch.from_numpy(tile))
    got = lcp_gather_ref(torch.from_numpy(prompts), torch.from_numpy(arena),
                         torch.from_numpy(rows))
    assert torch.equal(got, want)
    assert int(want.max()) > 0
    ops.reset_launch_counts()
    via_op = ops.lcp_gather_op(torch.from_numpy(prompts),
                               torch.from_numpy(arena),
                               torch.from_numpy(rows))
    assert torch.equal(via_op, want)
    assert ops.launch_counts()["lcp_gather"] == 0      # plain: uncounted


def test_affinity_matrix_through_the_mirror_is_unchanged():
    """Batches of updates and evictions; after each, the gather path's
    matrix equals the per-pair host loop and the reference ledger's, with
    extension-only agents, and the mirror equals the store."""
    rng = np.random.default_rng(7)
    port, ref = PrefixLedger(), RefLedger()
    agents = [f"a{i}" for i in range(5)]
    ext = [False, True, False, True, False]
    sessions = [f"d{j}" for j in range(8)]
    history = {d: rng.integers(0, 30, int(rng.integers(1, 20)),
                               dtype=np.int32) for d in sessions}
    for step in range(6):
        for _ in range(6):
            a = agents[int(rng.integers(0, 5))]
            d = sessions[int(rng.integers(0, 8))]
            for led in (port, ref):
                led.update(a, d, history[d])
            history[d] = np.concatenate(
                [history[d], rng.integers(0, 30, int(rng.integers(1, 30)),
                                          dtype=np.int32)])
        if step == 3:
            for led in (port, ref):
                led.evict("a2")
        reqs = [sessions[int(k)] for k in rng.integers(0, 8, 7)]
        prompts = [history[d] if k % 3 else history[d][:5]
                   for k, d in enumerate(reqs)]
        got = port.affinity_matrix(prompts, reqs, agents, ext,
                                   use_kernel=True, device="cpu")
        loop = port.affinity_matrix(prompts, reqs, agents, ext)
        want = ref.affinity_matrix(prompts, reqs, agents, ext)
        assert np.array_equal(got, loop)
        assert np.array_equal(got, want)
        assert got.any()
        mirror = port.mirror("cpu")
        assert torch.equal(mirror.tokens, torch.from_numpy(port.store.tokens))
        assert torch.equal(mirror.lens, torch.from_numpy(port.store.lens))
    assert port.bytes_sent > 0
    assert port.mirror(torch.device("cpu")) is mirror     # one per ledger

"""The dry run's bytes per fused region (`launch/traffic.py`), on the CPU.

Checked:

* ops that move nothing count nothing: ``prim.device`` (which autograd
  asks of every tensor, and which the unfused rule counted as a read of
  the whole tensor), ``_unsafe_view``, ``lift_fresh``; a tiny backward
  counted by hand;
* the rule against XLA's ``bytes accessed`` of the reference's compiled
  functions: the FFN (three matmuls and one elementwise region) and a
  cast-and-bias chain (one region), exactly;
* each kernel op (`kernels/ops.py`) counts its kernel's bytes
  (`kernels/work.py`) and none of its plain version's: forward, and under
  grad forward and backward, with what the forward keeps for the
  backward kernel (the attention's row LSE, a scan's kept states);
* whole cells' bytes affine in the sequence length (qwen3-8b, rwkv6-3b,
  zamba2-7b at reduced width, train and prefill);
* AdamW: 30 B a bf16 element, 36 B a float32 element, plus its scalars;
  the micro-batches' gradient sums by hand;
* ``attended_pairs`` against the mask the bound column counted before.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models.layers import ffn_apply as jax_ffn_apply  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.kernels import ops, work  # noqa: E402
from repro_torch.kernels.wkv6 import CHUNK, kept_stride  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.launch.traffic import ByteCounter, kernel_regions  # noqa: E402
from repro_torch.models.layers import ffn_apply  # noqa: E402
from repro_torch.training.optimizer import (OptConfig, adamw_init,  # noqa: E402
                                            adamw_update)

M11 = AbstractMesh((1, 1), ("data", "model"))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _counted(fn, *args):
    """(fn's result, the bytes it moves under a fresh counter, its result
    kept)."""
    counter = ByteCounter()
    with counter:
        out = fn(*args)
        counter.keep(out)
    return out, counter.bytes


# ------------------------------------------------------- moving nothing --

class _Unfused(torch.utils._python_dispatch.TorchDispatchMode):
    """The unfused rule the dry run counted with before: every op's tensor
    arguments and results, views, ``detach`` and ``alias`` aside."""

    def __init__(self):
        super().__init__()
        self.by_op: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func.overloadpacket in (
                torch.ops.aten.detach, torch.ops.aten.alias)):
            leaves = torch.utils._pytree.tree_leaves((args, kwargs, out))
            nb = sum(t.numel() * t.element_size() for t in leaves
                     if isinstance(t, torch.Tensor))
            name = str(func.overloadpacket)
            self.by_op[name] = self.by_op.get(name, 0) + nb
        return out


def _tiny_backward(mode):
    """x [4, 8] @ w [8, 3], summed, and its gradient, under fake tensors
    as the dry run traces."""
    x = torch.empty(4, 8).requires_grad_()
    w = torch.empty(8, 3).requires_grad_()
    with mode:
        loss = (x @ w).sum()
        if isinstance(mode, ByteCounter):
            mode.next_pass()
        grads = torch.autograd.grad(loss, (x, w))
        if isinstance(mode, ByteCounter):
            mode.keep(loss, grads)


def test_a_tiny_backward_counts_no_device_query():
    """x [4, 8] @ w [8, 3], summed, and its gradient in float32, under
    fake tensors.  The unfused rule counted autograd's ``prim.device``
    queries as reads of whole tensors; the fused count, by hand: the
    product reads x (128 B) and w (96) and writes y (48); the sum reads y
    and writes the loss (4); the backward's seed, a one (4), is broadcast
    into both products of the backward, each reading it once (4), with w
    or x (96, 128), and writing dx (128) or dw (96)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        old = _Unfused()
        _tiny_backward(old)
        counter = ByteCounter()
        _tiny_backward(counter)
    assert old.by_op["prim.device"] > 0
    assert counter.bytes == (128 + 96 + 48) + (48 + 4) + 4 \
        + (4 + 96 + 128) + (128 + 4 + 96)


def test_ops_that_move_nothing_count_nothing():
    x = torch.randn(16, 8)
    counter = ByteCounter()
    with counter:
        assert torch.ops.prim.device(x) == x.device
        y = torch.ops.aten._unsafe_view(x, (8, 16))
        z = torch.ops.aten.lift_fresh(x)
        x.dim(), x.shape, x.dtype
        counter.keep(y, z)
    assert counter.bytes == 0
    assert counter.largest == 16 * 8 * 4    # the unfused rule's largest


# ------------------------------------------------------- XLA's bytes ----

def _xla_bytes(fn, *args) -> float:
    cost = jax.jit(fn).lower(*args).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    return cost["bytes accessed"]


def test_ffn_counts_xla_bytes():
    """S = 256, D = 512, F = 1,024, float32: three matmuls, each reading
    its operands and writing its result, and one region (silu·u) reading
    g and u and writing h: 14,155,776 B, XLA's count for the reference's
    ``ffn_apply``."""
    rng = np.random.default_rng(0)
    shapes = {"wg": (512, 1024), "wu": (512, 1024), "wd": (1024, 512)}
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in shapes.items()}
    x = rng.standard_normal((256, 512), dtype=np.float32)
    want = _xla_bytes(jax_ffn_apply, {k: jnp.asarray(v) for k, v in
                                      p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    out, got = _counted(ffn_apply, tp, torch.from_numpy(x))
    assert got == want == 14_155_776
    ref = np.asarray(jax_ffn_apply({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_cast_and_bias_chain_is_one_region():
    """(x.astype(bf16) * 2).astype(f32) + b on x [256, 512] and b [512],
    float32: x and b read, the result written, 1,050,624 B, as XLA
    counts it."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((256, 512), dtype=np.float32)
    b = rng.standard_normal((512,), dtype=np.float32)
    want = _xla_bytes(
        lambda x, b: (x.astype(jnp.bfloat16) * 2).astype(jnp.float32) + b,
        jnp.asarray(x), jnp.asarray(b))
    _, got = _counted(lambda x, b: (x.to(torch.bfloat16) * 2).to(
        torch.float32) + b, torch.from_numpy(x), torch.from_numpy(b))
    assert got == want == 1_050_624


# ------------------------------------------------------ kernel regions --

def _normal(g, *shape, scale=1.0):
    return torch.randn(*shape, generator=g) * scale


def _states(x, width):
    """A stand-in for the float32 states a scan's forward keeps."""
    b, s, h, rows = x.shape
    n = -(-s // CHUNK)
    return torch.empty((b, h, n // kept_stride(n), rows, width))


def _flash_case(g, sq, sk, causal, window, q_offset):
    q = _normal(g, 2, sq, 4, 8)
    k, v = _normal(g, 2, sk, 2, 8), _normal(g, 2, sk, 2, 8)
    kw = {"causal": causal, "window": window, "q_offset": q_offset}
    fwd = work.flash_work(q, k, v, **kw)[0]

    def bwd(args, outs, grads):
        lse = torch.empty(2, 4, sq)
        return 4 * lse.numel(), work.bwd_work(*args, outs[0], grads[0], lse,
                                              **kw)[0]
    return ops.flash_attention_op, (q, k, v), kw, fwd, bwd


def _wkv6_case(g, s, with_s0):
    b, h, dk = 1, 2, 8
    r, k, v = (_normal(g, b, s, h, dk, scale=0.5) for _ in range(3))
    log_w = -torch.exp(_normal(g, b, s, h, dk, scale=0.5))
    u = _normal(g, h, dk, scale=0.5)
    s0 = _normal(g, b, h, dk, dk, scale=0.1) if with_s0 else None
    args = (r, k, v, log_w, u, s0)

    def bwd(args, outs, grads):
        states = _states(r, dk)
        return 4 * states.numel(), work.wkv6_bwd_work(
            *args[:5], states, grads[0], grads[1], want_ds0=with_s0)[0]
    return ops.wkv6_op, args, {}, work.wkv6_work(*args)[0], bwd


def _ssd_case(g, s, with_s0):
    b, h, hd, ds = 1, 2, 8, 4
    x = _normal(g, b, s, h, hd, scale=0.5)
    bmat, cmat = _normal(g, b, s, ds, scale=0.5), _normal(g, b, s, ds,
                                                          scale=0.5)
    dt = torch.nn.functional.softplus(_normal(g, b, s, h))
    a_log, d_skip = _normal(g, h, scale=0.5), _normal(g, h)
    s0 = _normal(g, b, h, hd, ds, scale=0.1) if with_s0 else None
    args = (x, bmat, cmat, dt, a_log, d_skip, s0)

    def bwd(args, outs, grads):
        states = _states(x, ds)
        return 4 * states.numel(), work.ssd_bwd_work(
            *args[:6], states, grads[0], grads[1], want_ds0=with_s0)[0]
    return ops.ssd_op, args, {}, work.ssd_work(*args)[0], bwd


KERNEL_CASES = {
    "flash_causal": lambda g: _flash_case(g, 40, 40, True, 0, 0),
    "flash_window_offset": lambda g: _flash_case(g, 16, 40, True, 8, 24),
    "flash_noncausal": lambda g: _flash_case(g, 16, 40, False, 0, 0),
    "wkv6": lambda g: _wkv6_case(g, 40, False),
    "wkv6_s0_checkpoints": lambda g: _wkv6_case(g, 512, True),
    "ssd": lambda g: _ssd_case(g, 40, False),
    "ssd_s0_checkpoints": lambda g: _ssd_case(g, 512, True),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_kernel_op_counts_its_kernels_bytes(case):
    """One call without grad counts its work function's bytes; under grad
    the forward also writes what its backward kernel reads, and the
    backward counts the backward's work function with the final state's
    gradient where one is given: nothing of the plain version, which runs
    here (its outputs are those of the call without the probe)."""
    g = torch.Generator().manual_seed(0)
    op, args, kw, fwd, bwd = KERNEL_CASES[case](g)
    plain = op(*args, **kw)
    counter = ByteCounter()
    with counter, kernel_regions(counter):
        out = op(*args, **kw)
        counter.keep(out)
    assert counter.bytes == fwd
    for a, b in zip(torch.utils._pytree.tree_leaves(out),
                    torch.utils._pytree.tree_leaves(plain)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    leaves = [a.detach().requires_grad_() if isinstance(a, torch.Tensor)
              else a for a in args]
    outs = op(*leaves, **kw)
    outs = outs if isinstance(outs, tuple) else (outs,)
    seeds = [torch.randn(o.shape, generator=g) for o in outs]
    counter = ByteCounter()
    with counter, kernel_regions(counter):
        got = op(*leaves, **kw)
        got = got if isinstance(got, tuple) else (got,)
        counter.next_pass()
        wanted = [t for t in leaves if isinstance(t, torch.Tensor)]
        grads = torch.autograd.grad(got, wanted, seeds)
        counter.keep(got, grads)
    saved, back = bwd(args, got, seeds)
    assert counter.bytes == fwd + saved + back
    want = torch.autograd.grad(outs, wanted, seeds)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_decode_attention_counts_the_valid_rows():
    g = torch.Generator().manual_seed(3)
    q = _normal(g, 2, 4, 8)
    kc, vc = _normal(g, 2, 32, 2, 8), _normal(g, 2, 32, 2, 8)
    valid = torch.rand(2, 32, generator=g) < 0.6
    counter = ByteCounter()
    with counter, kernel_regions(counter):
        counter.keep(ops.decode_attention_op(q, kc, vc, valid))
    nvalid = int(valid.sum())
    assert counter.bytes == work.decode_work(q, kc, vc, valid)[0] \
        == 2 * q.numel() * 4 + 2 * nvalid * 2 * 8 * 4 + valid.numel()


@pytest.mark.parametrize("causal,window,q_offset,sq,sk", [
    (True, 0, 0, 64, 64), (True, 16, 0, 64, 64), (True, 0, 40, 24, 64),
    (True, 16, 40, 24, 64), (False, 0, 0, 24, 64), (False, 16, 8, 24, 64)])
def test_attended_pairs_match_the_mask(causal, window, q_offset, sq, sk):
    qpos = torch.arange(sq)[:, None] + q_offset
    kpos = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= (qpos - kpos) < window
    assert work.attended_pairs(sq, sk, causal=causal, window=window,
                               q_offset=q_offset) == int(mask.sum())


# ---------------------------------------------------------- whole cells --

def _narrow(arch):
    cfg = get_config(arch)
    over = {"n_layers": 2}
    if cfg.attn_every:
        over.update(n_layers=4, attn_every=2)
    return cfg.scaled(dtype="float32", **over)


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-3b", "zamba2-7b"])
def test_cell_bytes_affine_in_sequence_length(arch, kind):
    """S, 2S and 4S tokens: the second step's bytes are twice the first's
    (below 32 chunks, where the scans keep every chunk's state)."""
    cfg = _narrow(arch)
    policy = dryrun.build_policy(M11, kind, "t")
    got = [dryrun.trace_cell(cfg, ShapeConfig("t", kind, s, 2), policy,
                             accum=1)["bytes"] for s in (32, 64, 128)]
    assert got[0] > 0
    assert got[2] - got[1] == 2 * (got[1] - got[0])


# --------------------------------------------------------------- AdamW --

def test_adamw_moves_30_bytes_a_bf16_and_36_a_float32_element():
    """Each leaf's in-place passes one region: the gradient, m, v and the
    master weight read, m, v, the master and the parameter written (28 B
    a bf16 element, 32 a float32 one), and the global norm one reduction
    reading the gradient again; plus the scalars: each leaf's float32 sum
    of squares written and read (8 B a leaf), and 28 B of the step's (the
    int32 step read by the schedule and by its successor, that successor
    written, the summed squares written and read, the norm and the
    learning rate written)."""
    g = torch.Generator().manual_seed(0)
    leaves = [torch.randn(64, 32, generator=g).to(torch.bfloat16),
              torch.randn(128, generator=g).to(torch.bfloat16),
              torch.randn(32, 16, generator=g), torch.randn(7, generator=g)]
    grads = [torch.randn(p.shape, generator=g).to(p.dtype) for p in leaves]
    state = adamw_init(leaves)
    counter = ByteCounter()
    with counter:
        _, new, stats = adamw_update(leaves, grads, state, OptConfig())
        counter.keep(new["step"], stats)
    n16 = 64 * 32 + 128
    n32 = 32 * 16 + 7
    assert counter.bytes == 30 * n16 + 36 * n32 + 8 * len(leaves) + 28


@pytest.mark.parametrize("accum", [1, 2, 4])
def test_update_bytes_sum_the_micro_batches(accum):
    """``update_bytes`` on a bf16 leaf of 64 x 32: AdamW alone for one
    micro-batch; for more, the first sum reads the gradient and writes
    the running sum (its zeros a constant), each later one but the last
    reads both and writes the sum, and the last fuses with the scale and
    AdamW, which (with the norm) read the running sum and the gradient in
    the scaled gradient's place: (3 * accum - 2) more bf16 tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.layers import ParamTree

    class One:
        @staticmethod
        def param_axes():
            return {"w": "embed ff"}

    with FakeTensorMode():
        params = ParamTree({"w": torch.empty(64, 32, dtype=torch.bfloat16)})
        got = dryrun.update_bytes(One, params, dryrun.build_policy(
            M11, "train", "t"), accum)
    n = 64 * 32
    extra = 0 if accum == 1 else (3 * accum - 2) * 2 * n
    assert got == 30 * n + 8 + 28 + extra

"""The attention kernels' plain versions against the JAX package: the
reference's oracles (`repro.kernels.ref`) at the shapes of
``tests/test_kernels.py``, and its Pallas kernels (interpret mode) at two
small shapes each.  Inputs are drawn with numpy and handed to both.

Tolerances are the reference's kernel-test ones: 2e-5 in float32 (the sums
run in another order), 3e-2 in bfloat16 (one bf16 rounding of the output).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention import decode_attention  # noqa: E402
from repro.kernels.flash_attention import flash_attention  # noqa: E402
from repro.kernels.ref import attention_ref, decode_attention_ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_cuda, decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_attention_plain)
from repro_torch.models.carry import tensor_from_numpy  # noqa: E402

# one compiled program per shape instead of one per jnp op
attention_ref = jax.jit(attention_ref, static_argnames=("causal", "window"))
decode_attention_ref = jax.jit(decode_attention_ref)
TOL = {np.float32: 2e-5, jnp.bfloat16: 3e-2}
FLASH_SHAPES = [(2, 64, 4, 2, 32, True, 0), (1, 100, 4, 4, 16, True, 0),
                (2, 128, 8, 2, 64, True, 48), (1, 37, 2, 1, 32, False, 0),
                (1, 256, 4, 4, 128, True, 0)]
DECODE_SHAPES = [(2, 4, 2, 32, 100), (1, 8, 8, 64, 257), (3, 6, 2, 16, 48)]


def flash_inputs(b, sq, h, hkv, d, dtype, rng):
    return (rng.standard_normal((b, sq, h, d)).astype(dtype),
            rng.standard_normal((b, sq, hkv, d)).astype(dtype),
            rng.standard_normal((b, sq, hkv, d)).astype(dtype))


def decode_inputs(b, h, hkv, d, m, rng):
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kc = rng.standard_normal((b, m, hkv, d)).astype(np.float32)
    vc = rng.standard_normal((b, m, hkv, d)).astype(np.float32)
    valid = rng.random((b, m)) < 0.7
    valid[:, 0] = True
    return q, kc, vc, valid


def max_err(port, ref) -> float:
    return float(np.max(np.abs(port.float().numpy()
                               - np.asarray(ref, np.float32))))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("b,sq,h,hkv,d,causal,win", FLASH_SHAPES)
def test_flash_plain_matches_reference_oracle(b, sq, h, hkv, d, causal, win,
                                              dtype, rng):
    q, k, v = flash_inputs(b, sq, h, hkv, d, dtype, rng)
    got = flash_attention_plain(*map(tensor_from_numpy, (q, k, v)),
                                causal=causal, window=win)
    want = attention_ref(q, k, v, causal=causal, window=win)
    assert got.dtype == tensor_from_numpy(q).dtype
    assert max_err(got, want) < TOL[dtype]


@pytest.mark.parametrize("b,h,hkv,d,m", DECODE_SHAPES)
def test_decode_plain_matches_reference_oracle(b, h, hkv, d, m, rng):
    q, kc, vc, valid = decode_inputs(b, h, hkv, d, m, rng)
    got = decode_attention_plain(*map(tensor_from_numpy, (q, kc, vc, valid)))
    want = decode_attention_ref(q, kc, vc, jnp.asarray(valid))
    assert max_err(got, want) < 2e-5


@pytest.mark.parametrize("b,sq,h,hkv,d,causal,win",
                         [FLASH_SHAPES[0], FLASH_SHAPES[2]])
def test_flash_plain_matches_pallas_interpret(b, sq, h, hkv, d, causal, win,
                                              rng):
    q, k, v = flash_inputs(b, sq, h, hkv, d, np.float32, rng)
    want = flash_attention(q, k, v, causal=causal, window=win, bq=32, bk=32)
    got = flash_attention_plain(*map(tensor_from_numpy, (q, k, v)),
                                causal=causal, window=win)
    assert max_err(got, want) < 2e-5


@pytest.mark.parametrize("b,h,hkv,d,m,bk", [(2, 4, 2, 32, 100, 32),
                                            (3, 6, 2, 16, 48, 16)])
def test_decode_plain_matches_pallas_interpret(b, h, hkv, d, m, bk, rng):
    q, kc, vc, valid = decode_inputs(b, h, hkv, d, m, rng)
    want = decode_attention(q, kc, vc, jnp.asarray(valid), bk=bk)
    got = decode_attention_plain(*map(tensor_from_numpy, (q, kc, vc, valid)))
    assert max_err(got, want) < 2e-5


def test_ops_take_the_plain_versions_for_cpu_tensors(rng):
    q, k, v = (tensor_from_numpy(x) for x in
               flash_inputs(1, 20, 4, 2, 16, np.float32, rng))
    qd, kc, vc, valid = (tensor_from_numpy(x) for x in
                         decode_inputs(1, 4, 2, 16, 30, rng))
    ops.reset_launch_counts()
    assert torch.equal(ops.flash_attention_op(q, k, v, window=5),
                       flash_attention_plain(q, k, v, window=5))
    assert torch.equal(ops.decode_attention_op(qd, kc, vc, valid),
                       decode_attention_plain(qd, kc, vc, valid))
    counts = ops.launch_counts()
    assert counts["flash_attention"] == counts["decode_attention"] == 0
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention_op(q.to("meta"), k.to("meta"), v.to("meta"))


def test_kernel_wrappers_refuse_cpu_tensors(rng):
    """On a CPU tensor the CUDA wrappers raise before building anything:
    nothing falls back to the plain versions."""
    q, k, v = (tensor_from_numpy(x) for x in
               flash_inputs(1, 8, 2, 1, 16, np.float32, rng))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    qd, kc, vc, valid = (tensor_from_numpy(x) for x in
                         decode_inputs(1, 2, 1, 16, 8, rng))
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(qd, kc, vc, valid)

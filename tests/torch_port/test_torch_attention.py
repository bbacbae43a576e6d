"""The attention kernels' plain versions against the JAX package: the
reference's oracles (`repro.kernels.ref`) at the shapes of
``tests/test_kernels.py``, and its Pallas kernels (interpret mode) at two
small shapes each, and flash also in the encoder-decoder's
cross-attention mode (non-causal, Sq != Sk).  Inputs are drawn with numpy
and handed to both.  Also the numerics of the bf16 tensor-core flash kernel (a float32 emulation of
its recipe against the JAX oracle) and the decode kernel's split plan,
which the CUDA tests cannot reach here.

Tolerances are the reference's kernel-test ones: 2e-5 in float32 (the sums
run in another order), 3e-2 in bfloat16 (one bf16 rounding of the output).
"""
import math

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
    H100_SMS, TILE, decode_attention_cuda, decode_attention_plain,
    split_plan)
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


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,bq,bk", [
    (2, 16, 32, 4, 4, 16, 16, 32),       # seamless's cross-attention
    (1, 24, 40, 4, 2, 32, 8, 16)])       # ragged tiles on both sides
def test_flash_plain_matches_pallas_interpret_cross(b, sq, sk, h, hkv, d, bq,
                                                    bk, rng):
    """The encoder-decoder's cross-attention mode: non-causal, the
    decoder's prompt (Sq) against the encoder's frames (Sk != Sq)."""
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    want = flash_attention(q, k, v, causal=False, bq=bq, bk=bk)
    got = flash_attention_plain(*map(tensor_from_numpy, (q, k, v)),
                                causal=False)
    assert got.shape == (b, sq, h, d)
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


def flash_tc_emulation(q, k, v, *, causal=True, window=0):
    """What the bf16 kernel of ``csrc/flash_attention.cu`` computes, in
    float32 on the CPU: 64-row query tiles and 64-key tiles (K and V
    zero-padded to whole tiles, padding keys masked), tiles wholly above
    the diagonal or behind the window skipped, scores times scale·log2 e
    with -1e30 for a masked key, an online softmax in exp2 with one rescale
    per tile, the sum l of the float32 P, P rounded to bf16 before P·V with
    float32 accumulation, and o = acc / max(l, 1e-30)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    pad = -sk % 64
    qf = q.float().permute(0, 2, 1, 3)                        # [B, H, Sq, d]
    kf, vf = (torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
              .repeat_interleave(h // hkv, dim=2).permute(0, 2, 1, 3)
              for x in (k, v))                                 # [B, H, Sk', d]
    scale_log2 = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) \
        * torch.tensor(1.4426950408889634, dtype=torch.float32)
    out = torch.empty((b, h, sq, d), dtype=torch.float32)
    for q0 in range(0, sq, 64):
        rows = torch.arange(q0, min(q0 + 64, sq))
        k_end = min(sk, q0 + 64) if causal else sk
        k_begin = max(0, q0 - window + 1) // 64 * 64 if window else 0
        m = torch.full((b, h, len(rows)), -1e30)
        l = torch.zeros((b, h, len(rows)))
        acc = torch.zeros((b, h, len(rows), d))
        for k0 in range(k_begin, k_end, 64):
            keys = torch.arange(k0, k0 + 64)
            s = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2) * scale_log2
            ok = (keys[None, :] < sk).expand(len(rows), -1)
            if causal:
                ok = ok & (keys[None, :] <= rows[:, None])
            if window:
                ok = ok & (rows[:, None] - keys[None, :] < window)
            s = torch.where(ok, s, torch.tensor(-1e30))
            mx = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - mx)
            p = torch.exp2(s - mx[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] \
                + p.bfloat16().float() @ vf[:, :, keys]
            m = mx
        out[:, :, rows] = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("sq,h,hkv,d,causal,win", [
    (130, 32, 8, 128, True, 0),       # qwen3-8b heads, a ragged third tile
    (130, 32, 32, 112, True, 0),      # zamba2-7b's shared block
    (150, 32, 8, 128, True, 40),      # a window edge inside a 64-row tile
    (100, 32, 8, 128, False, 0)])     # no causal mask, two key tiles
def test_flash_tensor_core_recipe_matches_reference_oracle(sq, h, hkv, d,
                                                           causal, win, rng):
    """The bf16 kernel's numerics are settled before the card: its recipe,
    emulated in float32, stays within the bf16 tolerance (3e-2) of the
    JAX package's oracle at the engines' head shapes."""
    q, k, v = flash_inputs(1, sq, h, hkv, d, jnp.bfloat16, rng)
    got = flash_tc_emulation(*map(tensor_from_numpy, (q, k, v)),
                             causal=causal, window=win)
    want = attention_ref(q, k, v, causal=causal, window=win)
    assert got.dtype == torch.bfloat16
    assert max_err(got, want) < TOL[jnp.bfloat16]


@pytest.mark.parametrize("m,bhkv", [(1024, 8), (1000, 8), (1024, 32),
                                    (48, 6), (1, 1), (257, 8), (1024, 200),
                                    (4096, 1)])
def test_decode_split_plan_covers_the_cache_once_in_one_wave(m, bhkv):
    chunk, splits = split_plan(m, bhkv)
    assert chunk % TILE == 0
    cover = np.zeros(m, np.int64)
    for i in range(splits):
        lo, hi = i * chunk, min((i + 1) * chunk, m)
        assert lo < hi
        cover[lo:hi] += 1
    assert (cover == 1).all()
    blocks = bhkv * splits
    tiles = -(-m // TILE)
    assert blocks <= max(H100_SMS, bhkv)                  # one wave at most
    assert blocks >= min(H100_SMS, bhkv * tiles) // 2     # ... and most of one
    if (m, bhkv) == (1024, 8):                            # qwen3-8b's decode
        assert (chunk, splits) == (64, 16)

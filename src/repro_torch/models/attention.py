"""Attention: GQA / sliding-window / MLA, parallel (prefill), cached-decode
and chunked-extend forms.

Conventions (the reference's, `repro.models.attention`)
-------------------------------------------------------
* Parallel form (prefill): q, k, v are [B, S, H(kv), hd], causal (+ an
  optional sliding window); the encoder-decoder's encoder and
  cross-attention call it non-causal, with Sq != Sk for the latter.
* Decode form: q is [B, H, hd] for ONE new token per sequence; the cache of
  a layer is k/v [B, M, Hkv, hd] with a per-slot absolute-position array
  ``slot_pos`` ([B, M], -1 = empty).  Sliding-window caches are ring
  buffers of size W; ``slot_pos`` makes ring masking exact.
* On a CUDA tensor `attend_parallel` runs the flash-attention kernel and
  `attend_decode` the decode-attention kernel (`kernels/ops.py`); on a CPU
  tensor their plain versions.
* Under a sequence split (`distributed/seq_parallel.py`, the training
  step over a ``model`` axis above 1) `gqa_parallel` and zamba2's shared
  block hold one block of each sequence: `rope_attend` rotates q and k
  at the block's global positions, gathers K and V over the axis and
  attends its rows at ``q_offset = rank · S_local``, as the reference's
  dense path keeps q sharded by sequence and gathers only the grouped
  K/V.  `attend_mixed` (chunked prefill over a
  cache) has no kernel in the reference either and is plain PyTorch on
  both devices.
* MLA (DeepSeek-V2) has no kernel: its prefill attends with q/k of width
  nope + rope and v of another width, its absorbed decode over the latent
  (lora + rope wide), and neither fits the ported kernels (k and v of one
  width, at most 128), nor is either a Pallas kernel in the reference.  So
  MLA attention is plain PyTorch on both devices, written as the reference
  writes it (`attend_parallel_plain`, einsums and a float32 softmax).
  Under a sequence split `mla_parallel` gathers the compressed latent
  over the axis (ckv normed and krope rotated, lora + rope values a
  token, where the expanded K/V would be H · (nope + rope + vd)),
  expands K/V for every key and attends its rows at their offset.
* Functional caches: `cache_append`, `prefill_cache_layout`,
  `cache_extend` and the MLA forms return new tensors and never write
  their inputs, as the reference's immutable arrays.  The serving engine
  relies on that: a session forked from a DAG parent and the engine's
  no-op decode step leave the stored caches untouched.  A step copies its
  layer's cache (2·M·Hkv·hd elements, or MLA's latents) once.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed import seq_parallel
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, normal_init, rms_norm

NEG_INF = -1e30


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B, S, H, hd] -> [B, S, Kv, G, hd]."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def attend_parallel(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """Causal (+ sliding-window) or bidirectional attention over a whole
    prompt.

    q: [B, Sq, H, hd]; k, v: [B, Sk, Hkv, hd] (Sq = Sk when causal, but
    for a block of query rows at ``q_offset``: row i of q sits at key
    position i + q_offset, q_offset + Sq <= Sk, as in the reference).  The
    reference also masks keys at or past each sequence's valid length
    (``kv_valid_len``).  Under the causal mask that changes only rows at
    or past the valid length, which nothing reads (`prefill_cache_layout`
    drops their K/V and the logits come from the last valid row).  The
    non-causal callers pass no valid length in the reference either: the
    encoder's frames are all ``src_len`` valid, and a cross-attention's
    keys are those frames, while its padded decoder rows are never read.
    So the kernel is called as the TPU kernel is, with the causal and
    window masks only.
    """
    return ops.flash_attention_op(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  window=window, q_offset=q_offset)


def attend_parallel_plain(q, k, v, *, kv_valid_len=None, q_offset: int = 0):
    """The reference's dense causal parallel attention (`repro.models.
    attention.attend_parallel` below its long-context threshold), plain
    PyTorch on both devices: q [B, Sq, H, dk], k [B, Sk, Hkv, dk], v [B, Sk,
    Hkv, dv] with dk and dv free, the scale 1/sqrt(dk), scores and softmax
    in float32, keys at or past ``kv_valid_len`` [B] masked; row i of q at
    key position i + ``q_offset`` (a split rank's block).  MLA's prefill
    runs here (the flash kernel takes one width for k and v)."""
    b, sq, h, hd = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    dev = q.device
    k_pos = torch.arange(sk, device=dev)
    q_pos = torch.arange(q_offset, q_offset + sq, device=dev)
    m = k_pos[None, :] <= q_pos[:, None]
    s = torch.einsum("bskgd,btkd->bkgst", _group(q, n_kv), k).float() \
        * (1.0 / math.sqrt(hd))
    s = torch.where(m[None, None, None], s, NEG_INF)
    if kv_valid_len is not None:
        kmask = k_pos[None, :] < kv_valid_len[:, None]              # [B, Sk]
        s = torch.where(kmask[:, None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", p, v)
    return out.reshape(b, sq, h, v.shape[-1])


def attend_decode(q, k_cache, v_cache, slot_pos, pos, *, window: int = 0):
    """One-token attention against a cache.

    q: [B, H, hd]; k_cache/v_cache: [B, M, Hkv, hd]; slot_pos: [B, M]
    absolute positions (-1 empty); pos: [B] current query positions.  The
    validity mask is built on the tensors' device.
    """
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window:
        valid &= (pos[:, None] - slot_pos) < window
    return ops.decode_attention_op(q.contiguous(), k_cache.contiguous(),
                                   v_cache.contiguous(), valid.contiguous())


def _slot(pos, m: int, window: int):
    """Cache slot of absolute position ``pos``: the ring slot with a window,
    else clamped to the last slot (the reference's convention)."""
    return pos % m if window else pos.clamp(max=m - 1)


def cache_append(k_cache, v_cache, slot_pos, k_new, v_new, pos, *,
                 window: int = 0):
    """Append one token's k, v at per-sequence positions (ring buffer if
    window).  k_new/v_new: [B, Hkv, hd]; pos: [B].  Returns new (k, v,
    slot_pos); the inputs are left as they were."""
    b, m = slot_pos.shape
    slot = _slot(pos, m, window).long()
    rows = torch.arange(b, device=pos.device)
    k_cache, v_cache, slot_pos = k_cache.clone(), v_cache.clone(), \
        slot_pos.clone()
    k_cache[rows, slot] = k_new
    v_cache[rows, slot] = v_new
    slot_pos[rows, slot] = pos.to(slot_pos.dtype)
    return k_cache, v_cache, slot_pos


def prefill_cache_layout(k, v, lens, max_len: int, *, window: int = 0):
    """Lay prefill K/V into a decode cache.  k, v: [B, S, Hkv, hd]; lens: [B].

    Returns (k_cache, v_cache, slot_pos) of length M = max_len (or W for
    SWA).  For sliding windows the last W positions land in ring order.
    """
    b, s, hkv, hd = k.shape
    dev = k.device
    m = min(window, max_len) if window else max_len
    pos = torch.arange(s, device=dev)
    if not window and m >= s:
        # fast path (no ring wrap): the cache is the masked, padded K/V
        keep = pos[None, :] < lens[:, None]
        k_cache = torch.zeros((b, m, hkv, hd), dtype=k.dtype, device=dev)
        v_cache = torch.zeros_like(k_cache)
        k_cache[:, :s] = torch.where(keep[..., None, None], k, 0.0)
        v_cache[:, :s] = torch.where(keep[..., None, None], v, 0.0)
        slot_pos = torch.full((b, m), -1, dtype=torch.int32, device=dev)
        slot_pos[:, :s] = torch.where(keep, pos[None, :], -1)
        return k_cache, v_cache, slot_pos
    slot = _slot(pos, m, window)
    # only the last m valid positions of each sequence live in the ring;
    # each ring slot then receives at most one kept position, so adding
    # into zeroed caches is exact whatever the order
    keep = (pos[None, :] < lens[:, None]) & (pos[None, :] >= lens[:, None] - m)
    k_cache = torch.zeros((b, m, hkv, hd), dtype=k.dtype, device=dev)
    v_cache = torch.zeros_like(k_cache)
    k_cache.index_add_(1, slot, torch.where(keep[..., None, None], k, 0.0))
    v_cache.index_add_(1, slot, torch.where(keep[..., None, None], v, 0.0))
    slot_pos = torch.full((b, m), -1, dtype=torch.int32, device=dev)
    slot_pos.scatter_reduce_(
        1, slot[None, :].expand(b, s),
        torch.where(keep, pos[None, :], -1).to(torch.int32), "amax")
    return k_cache, v_cache, slot_pos


def attend_mixed(q, k_new, v_new, k_cache, v_cache, slot_pos, pos0,
                 lens_new, *, window: int = 0):
    """Chunked-prefill attention: new tokens attend to (cache + new block).

    q, k_new, v_new: [B, Sn, H(kv), hd]; caches: [B, M, Hkv, hd]; pos0: [B]
    absolute position of the first new token; lens_new: [B].  The serving
    engine's multi-turn KV reuse (the paper's o_ij).  Plain PyTorch: the
    reference has no kernel for it.
    """
    b, sn, h, hd = q.shape
    n_kv = k_new.shape[2]
    dev = q.device
    qg = _group(q, n_kv)
    t_idx = torch.arange(sn, device=dev)
    q_pos = pos0[:, None] + t_idx[None, :]                       # [B, Sn]

    # scores against the cache slots
    sc = torch.einsum("bskgd,bmkd->bkgsm", qg, k_cache).float() \
        / math.sqrt(hd)
    valid_c = (slot_pos >= 0)[:, None, :] \
        & (slot_pos[:, None, :] <= q_pos[..., None])
    if window:
        valid_c &= (q_pos[..., None] - slot_pos[:, None, :]) < window
    sc = torch.where(valid_c[:, None, None], sc, NEG_INF)

    # scores against the new block (causal within it, length-masked)
    sb = torch.einsum("bskgd,btkd->bkgst", qg, k_new).float() \
        / math.sqrt(hd)
    mask_b = t_idx[None, :, None] >= t_idx[None, None, :]
    mask_b = mask_b & (t_idx[None, None, :] < lens_new[:, None, None])
    if window:
        mask_b = mask_b & ((t_idx[None, :, None] - t_idx[None, None, :])
                           < window)
    sb = torch.where(mask_b[:, None, None], sb, NEG_INF)

    scores = torch.cat([sc, sb], dim=-1)                # [B,Kv,G,Sn,M+Sn]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    v_all = torch.cat([v_cache, v_new], dim=1)
    out = torch.einsum("bkgsm,bmkd->bskgd", probs, v_all)
    return out.reshape(b, sn, h, v_new.shape[-1])


def cache_extend(k_cache, v_cache, slot_pos, k_new, v_new, pos0, lens_new,
                 *, window: int = 0):
    """Scatter a block of new K/V into the cache at positions pos0 ..
    pos0 + lens_new (keep-last-W semantics under ring wraparound).  Returns
    new (k, v, slot_pos); the inputs are left as they were."""
    b, sn, hkv, hd = k_new.shape
    m = k_cache.shape[1]
    dev = k_new.device
    t = torch.arange(sn, device=dev)
    pos = pos0[:, None] + t[None, :]                              # [B, Sn]
    slot = _slot(pos, m, window).long()
    keep = (t[None, :] < lens_new[:, None]) \
        & (pos >= pos0[:, None] + lens_new[:, None] - m)
    # clear the slots a kept position overwrites, then add: each slot
    # receives at most one kept position, so the sum is that position.
    # Scatters only: a boolean-mask index would wait for the device.
    hit = torch.zeros((b, m), dtype=torch.int32, device=dev).scatter_reduce(
        1, slot, keep.to(torch.int32), "amax").bool()
    k_cache = torch.where(hit[..., None, None], 0.0, k_cache)
    v_cache = torch.where(hit[..., None, None], 0.0, v_cache)
    slot_pos = torch.where(hit, -1, slot_pos)
    index = slot[..., None, None].expand(b, sn, hkv, hd)
    k_cache.scatter_add_(1, index, torch.where(keep[..., None, None], k_new,
                                               0.0))
    v_cache.scatter_add_(1, index, torch.where(keep[..., None, None], v_new,
                                               0.0))
    slot_pos = slot_pos.scatter_reduce(
        1, slot, torch.where(keep, pos, -1).to(torch.int32), "amax")
    return k_cache, v_cache, slot_pos


# ---------------- parameterized attention ----------------

def gqa_init(cfg, dtype, *, generator: torch.Generator) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev = generator.device
    p = {
        "wq": normal_init((d, h, hd), d, dtype, generator=generator),
        "wk": normal_init((d, kv, hd), d, dtype, generator=generator),
        "wv": normal_init((d, kv, hd), d, dtype, generator=generator),
        "wo": normal_init((h, hd, d), h * hd, dtype, generator=generator,
                          scale=1.0 / max(2 * cfg.n_layers, 1) ** 0.5),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv, hd), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
    return p


def gqa_axes(cfg):
    ax = {
        "wq": "embed heads head_dim",
        "wk": "embed kv_heads head_dim",
        "wv": "embed kv_heads head_dim",
        "wo": "heads head_dim embed",
    }
    if cfg.qkv_bias:
        ax.update(bq="heads head_dim", bk="kv_heads head_dim",
                  bv="kv_heads head_dim")
    if cfg.qk_norm:
        ax.update(q_norm="head_dim", k_norm="head_dim")
    return ax


def _qkv(p, x, cfg):
    q = torch.einsum("...d,dhk->...hk", x, p["wq"])
    k = torch.einsum("...d,dhk->...hk", x, p["wk"])
    v = torch.einsum("...d,dhk->...hk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def rope_attend(q, k, v, cfg, *, window: int = 0):
    """q, k, v [B, S, H(kv), hd] of a whole prompt, or of this rank's
    block under a sequence split -> (o [B, S, H, hd], k rotated): RoPE at
    the rows' global positions and causal attention over the whole
    sequence's keys (gathered over the split's axis, the module
    docstring)."""
    split = seq_parallel.current()
    offset = split.offset if split else 0
    pos = torch.arange(offset, offset + q.shape[1], device=q.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    k_all, v_all = seq_parallel.gather_seq((k, v), split) if split \
        else (k, v)
    return attend_parallel(q, k_all, v_all, window=window,
                           q_offset=offset), k


def gqa_parallel(p, x, cfg):
    """x: [B, S, D] -> (out [B, S, D], (k, v) for the cache layout).
    Under a sequence split x is this rank's block of each sequence, and
    its rows attend to the whole sequence's keys (`rope_attend`)."""
    q, k, v = _qkv(p, x, cfg)
    o, k = rope_attend(q, k, v, cfg, window=cfg.sliding_window)
    out = torch.einsum("...hk,hkd->...d", o, p["wo"])
    return out, (k, v)


def gqa_decode(p, x, cache_layer, cfg):
    """x: [B, D] one token; cache_layer: dict(k, v, slot_pos, pos [B])."""
    pos = cache_layer["pos"]
    q, k, v = _qkv(p, x[:, None, :], cfg)                  # [B, 1, H, hd]
    q = apply_rope(q, pos[:, None], cfg.rope_theta)[:, 0]
    k = apply_rope(k, pos[:, None], cfg.rope_theta)[:, 0]
    v = v[:, 0]
    kc, vc, sp = cache_append(cache_layer["k"], cache_layer["v"],
                              cache_layer["slot_pos"], k, v, pos,
                              window=cfg.sliding_window)
    o = attend_decode(q, kc, vc, sp, pos, window=cfg.sliding_window)
    out = torch.einsum("bhk,hkd->bd", o, p["wo"])
    return out, {"k": kc, "v": vc, "slot_pos": sp, "pos": pos + 1}


def gqa_extend(p, x, cache_layer, cfg, lens_new):
    """A block of new tokens attending to cache + block (multi-turn).

    x: [B, Sn, D]; cache_layer: dict(k, v, slot_pos, pos).  Returns
    (out [B, Sn, D], new cache_layer with pos advanced by lens_new).
    """
    pos0 = cache_layer["pos"]
    q, k, v = _qkv(p, x, cfg)
    pos = pos0[:, None] + torch.arange(x.shape[1], device=x.device)[None, :]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    o = attend_mixed(q, k, v, cache_layer["k"], cache_layer["v"],
                     cache_layer["slot_pos"], pos0, lens_new,
                     window=cfg.sliding_window)
    kc, vc, sp = cache_extend(cache_layer["k"], cache_layer["v"],
                              cache_layer["slot_pos"], k, v, pos0, lens_new,
                              window=cfg.sliding_window)
    out = torch.einsum("...hk,hkd->...d", o, p["wo"])
    return out, {"k": kc, "v": vc, "slot_pos": sp, "pos": pos0 + lens_new}


# ---------------- MLA (DeepSeek-V2) ----------------

def mla_init(cfg, dtype, *, generator: torch.Generator) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    nope, rope_d, vd, lora = (cfg.qk_nope_dim, cfg.qk_rope_dim,
                              cfg.v_head_dim, cfg.kv_lora_rank)
    return {
        "wq": normal_init((d, h, nope + rope_d), d, dtype,
                          generator=generator),
        "wdkv": normal_init((d, lora + rope_d), d, dtype,
                            generator=generator),
        "kv_norm": torch.ones((lora,), dtype=dtype, device=generator.device),
        "wuk": normal_init((lora, h, nope), lora, dtype, generator=generator),
        "wuv": normal_init((lora, h, vd), lora, dtype, generator=generator),
        "wo": normal_init((h, vd, d), h * vd, dtype, generator=generator,
                          scale=1.0 / max(2 * cfg.n_layers, 1) ** 0.5),
    }


def mla_axes(cfg):
    return {
        "wq": "embed heads qk_dim",
        "wdkv": "embed kv_lora",
        "kv_norm": "kv_lora",
        "wuk": "kv_lora heads qk_dim",
        "wuv": "kv_lora heads head_dim",
        "wo": "heads head_dim embed",
    }


def _mla_qkv_from_latent(p, ckv, krope, cfg):
    """Expand cached latents to per-head K/V.  ckv: [..., lora], krope:
    [..., rope] -> (k [..., H, nope + rope], v [..., H, vd])."""
    k_nope = torch.einsum("...l,lhn->...hn", ckv, p["wuk"])
    v = torch.einsum("...l,lhv->...hv", ckv, p["wuv"])
    k_rope = krope[..., None, :].expand(*k_nope.shape[:-1], cfg.qk_rope_dim)
    return torch.cat([k_nope, k_rope], dim=-1), v


def _mla_q(p, x, pos, cfg):
    """Queries with RoPE on their rope part: x [..., S, D] -> (q, q_nope,
    q_rope) [..., S, H, *]."""
    q = torch.einsum("...d,dhk->...hk", x, p["wq"])
    q_nope, q_rope = torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim], -1)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    return torch.cat([q_nope, q_rope], dim=-1), q_nope, q_rope


def _mla_latent(p, x, pos, cfg):
    """The compressed latent and the shared rope key of x [..., S, D]:
    (ckv [..., S, lora] normed, krope [..., S, rope] rotated)."""
    dkv = torch.einsum("...d,dl->...l", x, p["wdkv"])
    ckv, krope = torch.split(dkv, [cfg.kv_lora_rank, cfg.qk_rope_dim], -1)
    ckv = rms_norm(ckv, p["kv_norm"], cfg.norm_eps)
    krope = apply_rope(krope[..., None, :], pos, cfg.rope_theta)[..., 0, :]
    return ckv, krope


def mla_parallel(p, x, cfg, *, lens=None, pos0: int = 0):
    """x: [B, S, D] at positions pos0 + (0 .. S) -> (out [B, S, D], (ckv,
    krope) for the cache).  Under a sequence split x is this rank's block
    at ``offset`` more: its latent is gathered over the axis, expanded
    for every key, and its rows attend at their offset (the module
    docstring); the returned latents are the block's."""
    split = seq_parallel.current()
    offset = split.offset if split else 0
    pos = torch.arange(pos0 + offset, pos0 + offset + x.shape[1],
                       device=x.device)
    q, _, _ = _mla_q(p, x, pos, cfg)
    ckv, krope = _mla_latent(p, x, pos, cfg)
    ckv_all, krope_all = seq_parallel.gather_seq((ckv, krope), split) \
        if split else (ckv, krope)
    k, v = _mla_qkv_from_latent(p, ckv_all, krope_all, cfg)
    o = attend_parallel_plain(q, k, v, kv_valid_len=lens, q_offset=offset)
    return torch.einsum("bshv,hvd->bsd", o, p["wo"]), (ckv, krope)


# Absorbed MLA decode (DeepSeek-V2 "absorb"): W_uk folds into the query and
# W_uv into the output, so attention runs in the compressed latent space.
# On by default, as in the reference; the naive form expands every cached
# latent to per-head K/V each step.
MLA_ABSORBED = True


def mla_decode(p, x, cache_layer, cfg, *, absorbed: bool | None = None):
    """x: [B, D] one token; cache_layer: dict(ckv [B, M, lora], krope
    [B, M, rope], slot_pos, pos [B]).  Returns (out [B, D], new cache
    layer); the given one is left as it was."""
    if absorbed is None:
        absorbed = MLA_ABSORBED
    pos = cache_layer["pos"]
    q, q_nope, q_rope = (t[:, 0] for t in _mla_q(p, x[:, None], pos[:, None],
                                                 cfg))
    ckv_new, krope_new = (t[:, 0] for t in _mla_latent(p, x[:, None],
                                                       pos[:, None], cfg))
    b, m = cache_layer["slot_pos"].shape
    slot = pos.clamp(max=m - 1).long()
    rows = torch.arange(b, device=x.device)
    ckv_c = cache_layer["ckv"].clone()
    kr_c = cache_layer["krope"].clone()
    sp = cache_layer["slot_pos"].clone()
    ckv_c[rows, slot] = ckv_new
    kr_c[rows, slot] = krope_new
    sp[rows, slot] = pos.to(sp.dtype)

    valid = (sp >= 0) & (sp <= pos[:, None])
    scale = 1.0 / math.sqrt(q.shape[-1])
    if absorbed:
        # scores = q_nope^T W_uk ckv + q_rope^T k_rope, all in latent space
        q_abs = torch.einsum("bhn,lhn->bhl", q_nope, p["wuk"])   # [B, H, lora]
        scores = (torch.einsum("bhl,bml->bhm", q_abs, ckv_c)
                  + torch.einsum("bhr,bmr->bhm", q_rope, kr_c)).float()
        scores = torch.where(valid[:, None, :], scores * scale, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        o_lat = torch.einsum("bhm,bml->bhl", probs, ckv_c)      # [B, H, lora]
        o = torch.einsum("bhl,lhv->bhv", o_lat, p["wuv"])
    else:
        k, v = _mla_qkv_from_latent(p, ckv_c, kr_c, cfg)      # [B, M, H, *]
        scores = torch.einsum("bhk,bmhk->bhm", q, k).float() * scale
        scores = torch.where(valid[:, None, :], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        o = torch.einsum("bhm,bmhv->bhv", probs, v)
    out = torch.einsum("bhv,hvd->bd", o, p["wo"])
    return out, {"ckv": ckv_c, "krope": kr_c, "slot_pos": sp,
                 "pos": pos + 1}


def mla_extend(p, x, cache_layer, cfg, lens_new):
    """A block of new tokens x [B, Sn, D] against an MLA latent cache
    (multi-turn).  Returns (out [B, Sn, D], new cache layer with pos
    advanced by lens_new); the given one is left as it was."""
    sn = x.shape[1]
    pos0 = cache_layer["pos"]
    t = torch.arange(sn, device=x.device)
    pos = pos0[:, None] + t[None, :]
    q, _, _ = _mla_q(p, x, pos, cfg)
    ckv_new, krope_new = _mla_latent(p, x, pos, cfg)
    k_new, v_new = _mla_qkv_from_latent(p, ckv_new, krope_new, cfg)
    k_cache, v_cache = _mla_qkv_from_latent(p, cache_layer["ckv"],
                                            cache_layer["krope"], cfg)
    o = attend_mixed(q, k_new, v_new, k_cache, v_cache,
                     cache_layer["slot_pos"], pos0, lens_new)

    # The new latents are ADDED into their slots, which are not cleared
    # first: the reference's `mla_extend` (src/repro/models/attention.py:
    # 535-539) does so, unlike `cache_extend`.  After a truncation or a
    # padded prefill the slots still hold stale latents, and the next
    # decode reads their sums.  Reproduced on purpose (ROADMAP §3).
    b, m = cache_layer["slot_pos"].shape
    slot = pos.clamp(max=m - 1).long()
    keep = t[None, :] < lens_new[:, None]

    def add(cache, new):
        index = slot[..., None].expand(b, sn, new.shape[-1])
        return cache.clone().scatter_add_(
            1, index, torch.where(keep[..., None], new, 0.0))

    sp = cache_layer["slot_pos"].scatter_reduce(
        1, slot, torch.where(keep, pos, -1).to(torch.int32), "amax")
    out = torch.einsum("bshv,hvd->bsd", o, p["wo"])
    return out, {"ckv": add(cache_layer["ckv"], ckv_new),
                 "krope": add(cache_layer["krope"], krope_new),
                 "slot_pos": sp, "pos": pos0 + lens_new}

"""GQA attention: parallel (prefill), cached-decode and chunked-extend forms.

Conventions (the reference's, `repro.models.attention`)
-------------------------------------------------------
* Parallel form (prefill): q, k, v are [B, S, H(kv), hd], causal (+ an
  optional sliding window).
* Decode form: q is [B, H, hd] for ONE new token per sequence; the cache of
  a layer is k/v [B, M, Hkv, hd] with a per-slot absolute-position array
  ``slot_pos`` ([B, M], -1 = empty).  Sliding-window caches are ring
  buffers of size W; ``slot_pos`` makes ring masking exact.
* On a CUDA tensor `attend_parallel` runs the flash-attention kernel and
  `attend_decode` the decode-attention kernel (`kernels/ops.py`); on a CPU
  tensor their plain versions.  `attend_mixed` (chunked prefill over a
  cache) has no kernel in the reference either and is plain PyTorch on
  both devices.
* Functional caches: `cache_append`, `prefill_cache_layout` and
  `cache_extend` return new tensors and never write their inputs, as the
  reference's immutable arrays.  The serving engine relies on that: a
  session forked from a DAG parent and the engine's no-op decode step
  leave the stored caches untouched.  A step copies its layer's cache
  (2·M·Hkv·hd elements) once.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, normal_init, rms_norm

NEG_INF = -1e30


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B, S, H, hd] -> [B, S, Kv, G, hd]."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def attend_parallel(q, k, v, *, window: int = 0):
    """Causal (+ sliding-window) attention over a whole prompt.

    q: [B, S, H, hd]; k, v: [B, S, Hkv, hd].  The reference also masks keys
    at or past each sequence's valid length (``kv_valid_len``); under the
    causal mask that changes only rows at or past the valid length, which
    nothing reads (`prefill_cache_layout` drops their K/V and the logits
    come from the last valid row), so the kernel is called as the TPU
    kernel is, with the causal and window masks only.
    """
    return ops.flash_attention_op(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=True, window=window)


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
    if cfg.attn_kind != "gqa":
        raise NotImplementedError(f"attention kind {cfg.attn_kind!r}: the "
                                  "port builds GQA only; MLA waits for its "
                                  "family slice")
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


def gqa_parallel(p, x, cfg):
    """x: [B, S, D] -> (out [B, S, D], (k, v) for the cache layout)."""
    q, k, v = _qkv(p, x, cfg)
    pos = torch.arange(x.shape[1], device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    o = attend_parallel(q, k, v, window=cfg.sliding_window)
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

"""Block assembly of the port's families (the reference's
`repro.models.blocks`): attention blocks (GQA or MLA attention, a dense or
MoE FFN), RWKV-6 blocks, Mamba-2 blocks and zamba2's shared attention
block with per-invocation LoRA.  The reference's sharding constraints
(``shard``/``_res``) constrain nothing on one card and are left out."""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import (FFN_AXES, apply_rope, ffn_apply,
                                       ffn_init, normal_init, rms_norm)


def attn_block_init(cfg, dtype, *, generator: torch.Generator,
                    ffn_kind: str = "dense", d_ff: int | None = None) -> dict:
    """ffn_kind: dense | moe; the attention is MLA or GQA by
    ``cfg.attn_kind``."""
    dev = generator.device
    init = attn.mla_init if cfg.attn_kind == "mla" else attn.gqa_init
    p = {"ln1": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
         "attn": init(cfg, dtype, generator=generator),
         "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=dev)}
    if ffn_kind == "dense":
        p["mlp"] = ffn_init(cfg.d_model, d_ff or cfg.d_ff, dtype,
                            generator=generator)
    else:
        p["moe"] = moe_mod.moe_init(cfg, dtype, generator=generator)
    return p


def attn_block_axes(cfg, *, ffn_kind: str):
    a = attn.mla_axes(cfg) if cfg.attn_kind == "mla" else attn.gqa_axes(cfg)
    ax = {"ln1": "embed", "attn": a, "ln2": "embed"}
    if ffn_kind == "dense":
        ax["mlp"] = dict(FFN_AXES)
    else:
        ax["moe"] = moe_mod.moe_axes(cfg)
    return ax


def ffn(p, h, cfg, ffn_kind: str, moe_mode: str = "sort"):
    """The block's FFN on h [B, S, D]: SwiGLU or the MoE layer."""
    if ffn_kind == "dense":
        return ffn_apply(p["mlp"], h)
    return moe_mod.moe_ffn(p["moe"], h, cfg, mode=moe_mode)


def attn_block_parallel(p, x, cfg, *, ffn_kind: str = "dense", lens=None,
                        moe_mode: str = "sort"):
    """Returns (x, kv) where kv are the cacheables of this layer.  ``lens``
    masks MLA's keys past each prompt's length, as in the reference; GQA
    calls the flash kernel with the causal mask only (see
    `attention.attend_parallel`)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        o, kv = attn.mla_parallel(p["attn"], h, cfg, lens=lens)
    else:
        o, kv = attn.gqa_parallel(p["attn"], h, cfg)
    x = x + o
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + ffn(p, h, cfg, ffn_kind, moe_mode), kv


def attn_block_decode(p, x, cache_layer, cfg, *, ffn_kind: str = "dense",
                      moe_mode: str = "sort"):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        o, new_cache = attn.mla_decode(p["attn"], h, cache_layer, cfg)
    else:
        o, new_cache = attn.gqa_decode(p["attn"], h, cache_layer, cfg)
    x = x + o
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if ffn_kind == "dense":
        return x + ffn_apply(p["mlp"], h), new_cache
    return x + moe_mod.moe_ffn(p["moe"], h[:, None, :], cfg,
                               mode=moe_mode)[:, 0], new_cache


# ---------------- RWKV-6 block ----------------

def rwkv_block_init(cfg, dtype, *, generator: torch.Generator) -> dict:
    dev = generator.device
    return {"ln1": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            "mix": ssm.rwkv6_init(cfg, dtype, generator=generator)}


def rwkv_block_axes(cfg):
    return {"ln1": "embed", "ln2": "embed", "mix": ssm.rwkv6_axes(cfg)}


def rwkv_block_parallel(p, x, cfg, state=None):
    """state: (shift_t [B, D], wkv [B, H, hd, hd], shift_c [B, D]) or None
    (zeros).  Returns (x, new state)."""
    shift_t, wkv, shift_c = state if state is not None else (None, None,
                                                             None)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    o, (new_shift_t, new_wkv) = ssm.rwkv6_time_mix(
        p["mix"], h, cfg, shift_state=shift_t, wkv_state=wkv, parallel=True)
    x = x + o
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    o, new_shift_c = ssm.rwkv6_channel_mix(p["mix"], h, shift_state=shift_c,
                                           parallel=True)
    return x + o, (new_shift_t, new_wkv, new_shift_c)


def rwkv_block_step(p, x, cfg, state):
    shift_t, wkv, shift_c = state
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    o, (new_shift_t, new_wkv) = ssm.rwkv6_time_mix(
        p["mix"], h, cfg, shift_state=shift_t, wkv_state=wkv, parallel=False)
    x = x + o
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    o, new_shift_c = ssm.rwkv6_channel_mix(p["mix"], h, shift_state=shift_c,
                                           parallel=False)
    return x + o, (new_shift_t, new_wkv, new_shift_c)


# ---------------- Mamba-2 block (the zamba2 backbone) ----------------

def mamba_block_init(cfg, dtype, *, generator: torch.Generator) -> dict:
    return {"ln": torch.ones((cfg.d_model,), dtype=dtype,
                             device=generator.device),
            "mix": ssm.mamba2_init(cfg, dtype, generator=generator)}


def mamba_block_axes(cfg):
    return {"ln": "embed", "mix": ssm.mamba2_axes(cfg)}


def mamba_block_parallel(p, x, cfg, state=None):
    """state: (conv [B, 3, 2D], ssm [B, H, hd, ds]) or None (zeros)."""
    conv, ssm_state = state if state is not None else (None, None)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    o, new_state = ssm.mamba2_block(p["mix"], h, cfg, conv_state=conv,
                                    ssm_state=ssm_state, parallel=True)
    return x + o, new_state


def mamba_block_step(p, x, cfg, state):
    conv, ssm_state = state
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    o, new_state = ssm.mamba2_block(p["mix"], h, cfg, conv_state=conv,
                                    ssm_state=ssm_state, parallel=False)
    return x + o, new_state


# ---------------- zamba2 shared attention block (+ per-invocation LoRA) ----

LORA_SHARED = 64


def shared_attn_init(cfg, dtype, *, generator: torch.Generator,
                     n_groups: int) -> dict:
    """One shared GQA+MLP block, with one q/k/v LoRA per invocation: a
    list of ``n_groups`` trees where the reference stacks them (the B
    halves start at zero)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev = generator.device
    base = attn_block_init(cfg, dtype, generator=generator)
    a = lambda: normal_init((d, LORA_SHARED), d, dtype,  # noqa: E731
                            generator=generator)
    zeros = lambda heads: torch.zeros((LORA_SHARED, heads, hd),  # noqa: E731
                                      dtype=dtype, device=dev)
    lora = [{"qa": a(), "qb": zeros(h), "ka": a(), "kb": zeros(kv),
             "va": a(), "vb": zeros(kv)} for _ in range(n_groups)]
    return {"block": base, "lora": lora}


def shared_attn_axes(cfg, n_groups: int):
    """The reference's table with its ``groups`` prefix on the LoRA
    dropped: one table per invocation, as `shared_attn_init` lays them."""
    lora = {"qa": "embed lora_rank", "qb": "lora_rank heads head_dim",
            "ka": "embed lora_rank", "kb": "lora_rank kv_heads head_dim",
            "va": "embed lora_rank", "vb": "lora_rank kv_heads head_dim"}
    return {"block": attn_block_axes(cfg, ffn_kind="dense"),
            "lora": [dict(lora) for _ in range(n_groups)]}


def _lora_qkv_delta(lora_g, h):
    """Per-invocation low-rank q/k/v deltas.  h: [..., D]."""
    return tuple(torch.einsum("...r,rhk->...hk", h @ lora_g[f"{n}a"],
                              lora_g[f"{n}b"]) for n in ("q", "k", "v"))


def shared_attn_parallel(p, lora_g, x, cfg):
    """The shared block over a whole prompt, or this rank's block of it
    under a sequence split (`attention.rope_attend`; the flash-attention
    kernel on the card).  Returns (x, (k, v)) for the cache layout.  The
    reference also masks keys past each prompt's length; the recurrent
    engine's prompts are exact-length, so the causal mask alone is the
    same."""
    blk = p["block"]
    h = rms_norm(x, blk["ln1"], cfg.norm_eps)
    q, k, v = attn._qkv(blk["attn"], h, cfg)
    dq, dk, dv = _lora_qkv_delta(lora_g, h)
    q, k, v = q + dq, k + dk, v + dv
    o, k = attn.rope_attend(q, k, v, cfg)
    x = x + torch.einsum("...hk,hkd->...d", o, blk["attn"]["wo"])
    h = rms_norm(x, blk["ln2"], cfg.norm_eps)
    return x + ffn_apply(blk["mlp"], h), (k, v)


def shared_attn_decode(p, lora_g, x, cache_layer, cfg):
    """One token through the shared block against its group's KV cache
    (the decode-attention kernel on the card).  cache_layer: dict(k, v,
    slot_pos, pos).  Returns (x, new cache layer); the given one is left
    as it was."""
    blk = p["block"]
    pos = cache_layer["pos"]
    h = rms_norm(x, blk["ln1"], cfg.norm_eps)
    q, k, v = attn._qkv(blk["attn"], h[:, None, :], cfg)
    dq, dk, dv = _lora_qkv_delta(lora_g, h[:, None, :])
    q, k, v = q + dq, k + dk, v + dv
    q = apply_rope(q, pos[:, None], cfg.rope_theta)[:, 0]
    k = apply_rope(k, pos[:, None], cfg.rope_theta)[:, 0]
    kc, vc, sp = attn.cache_append(cache_layer["k"], cache_layer["v"],
                                   cache_layer["slot_pos"], k, v[:, 0], pos)
    o = attn.attend_decode(q, kc, vc, sp, pos)
    x = x + torch.einsum("bhk,hkd->bd", o, blk["attn"]["wo"])
    h = rms_norm(x, blk["ln2"], cfg.norm_eps)
    return x + ffn_apply(blk["mlp"], h), {"k": kc, "v": vc, "slot_pos": sp,
                                          "pos": pos + 1}

"""Block assembly of the port's families (the reference's
`repro.models.blocks`): dense GQA attention blocks, RWKV-6 blocks, Mamba-2
blocks and zamba2's shared attention block with per-invocation LoRA.  The
reference's sharding constraints (``shard``/``_res``) constrain nothing on
one card and are left out; MoE blocks wait for their slice."""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import (apply_rope, ffn_apply, ffn_init,
                                       normal_init, rms_norm)


def attn_block_init(cfg, dtype, *, generator: torch.Generator,
                    ffn_kind: str = "dense", d_ff: int | None = None) -> dict:
    if ffn_kind != "dense":
        raise NotImplementedError(f"ffn kind {ffn_kind!r}: MoE blocks wait "
                                  "for the MoE slice")
    dev = generator.device
    return {"ln1": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            "attn": attn.gqa_init(cfg, dtype, generator=generator),
            "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            "mlp": ffn_init(cfg.d_model, d_ff or cfg.d_ff, dtype,
                            generator=generator)}


def attn_block_parallel(p, x, cfg):
    """Returns (x, kv) where kv are the cacheables of this layer."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    o, kv = attn.gqa_parallel(p["attn"], h, cfg)
    x = x + o
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + ffn_apply(p["mlp"], h), kv


def attn_block_decode(p, x, cache_layer, cfg):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    o, new_cache = attn.gqa_decode(p["attn"], h, cache_layer, cfg)
    x = x + o
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + ffn_apply(p["mlp"], h), new_cache


# ---------------- RWKV-6 block ----------------

def rwkv_block_init(cfg, dtype, *, generator: torch.Generator) -> dict:
    dev = generator.device
    return {"ln1": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            "mix": ssm.rwkv6_init(cfg, dtype, generator=generator)}


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


def _lora_qkv_delta(lora_g, h):
    """Per-invocation low-rank q/k/v deltas.  h: [..., D]."""
    return tuple(torch.einsum("...r,rhk->...hk", h @ lora_g[f"{n}a"],
                              lora_g[f"{n}b"]) for n in ("q", "k", "v"))


def shared_attn_parallel(p, lora_g, x, cfg):
    """The shared block over a whole prompt (the flash-attention kernel on
    the card).  Returns (x, (k, v)) for the cache layout.  The reference
    also masks keys past each prompt's length; the recurrent engine's
    prompts are exact-length, so the causal mask alone is the same."""
    blk = p["block"]
    h = rms_norm(x, blk["ln1"], cfg.norm_eps)
    q, k, v = attn._qkv(blk["attn"], h, cfg)
    dq, dk, dv = _lora_qkv_delta(lora_g, h)
    q, k, v = q + dq, k + dk, v + dv
    pos = torch.arange(x.shape[1], device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    o = attn.attend_parallel(q, k, v)
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

"""Dense GQA transformer blocks (the reference's `attn_block_*` for the dense
FFN).  The reference's sharding constraints (``shard``/``_res``) constrain
nothing on one card and are left out; MoE blocks wait for their slice."""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import ffn_apply, ffn_init, rms_norm


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

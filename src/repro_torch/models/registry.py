"""Model registry: config -> `Model`, a record of plain functions over a
parameter tree (`layers.ParamTree`), plus the dry run's input specs per
shape cell (shapes and dtypes; nothing is allocated)."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


class Model(NamedTuple):
    config: ModelConfig
    init: Callable          # (generator) -> params (a ParamTree)
    param_axes: Callable    # () -> logical axes, in init's tree layout
    forward: Callable       # (params, batch, *, collect[, init_state],
                            # remat=False) -> (x, parts)
    loss: Callable          # (params, batch) -> scalar float32
    prefill: Callable       # (params, batch) -> (logits [B, V], cache)
    decode_step: Callable   # (params, cache, tokens [B]) -> (logits, cache)
    extend: Callable        # (params, cache, tokens [B, Sn], lens_new) -> ...
    init_cache: Callable    # (b, max_len, device) -> cache
    family: str
    extras: dict            # the family's other functions (encdec: encode)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.is_encdec:
        from repro_torch.models.encdec import build_encdec as build
    else:
        from repro_torch.models.lm import build_lm as build
    fns = build(cfg)
    extras = {k: v for k, v in fns.items() if k not in Model._fields}
    return Model(config=cfg, extras=extras,
                 **{k: v for k, v in fns.items() if k in Model._fields})


class TensorSpec(NamedTuple):
    """A tensor's shape and dtype (the reference's ``ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """`TensorSpec`s of every model input of a dry-run cell.

    As in the reference: a patch-input model's seq_len counts its
    n_patches patch embeddings [B, P, D] and the text tokens after them;
    the encoder-decoder's seq_len is the decoder's, its encoder reading
    src_len frames [B, src, D]; a decode cell's inputs are the cache
    (`decode_state_specs`) and one token per sequence.
    """
    b, s = shape.global_batch, shape.seq_len
    dtype = getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        return {"tokens": TensorSpec((b, max(s - cfg.n_patches, 1)),
                                     torch.int32),
                "patches": TensorSpec((b, cfg.n_patches, cfg.d_model),
                                      dtype)}
    batch = {"tokens": TensorSpec((b, s), torch.int32)}
    if cfg.is_encdec:
        batch["frames"] = TensorSpec((b, cfg.src_len, cfg.d_model), dtype)
    return batch


def decode_state_specs(model: Model, shape: ShapeConfig):
    """(cache specs, token spec) for a decode cell: ``init_cache``'s tree
    of `TensorSpec`s, traced on the meta device (nothing allocated)."""
    b, s = shape.global_batch, shape.seq_len
    cache = model.init_cache(b, s, torch.device("meta"))
    specs = _map(cache, lambda t: TensorSpec(tuple(t.shape), t.dtype))
    return specs, TensorSpec((b,), torch.int32)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def cache_axes(model: Model):
    """Logical-axis strings mirroring ``init_cache``'s tree, whose
    per-layer lists stand where the reference stacks a ``layers`` (and
    zamba's ``groups``) dim."""
    cfg = model.config
    kv = "batch cache_seq kv_heads head_dim"
    if cfg.is_encdec:
        cross = "batch src_seq kv_heads head_dim"
        n = cfg.n_layers
        return {"k": [kv] * n, "v": [kv] * n, "xk": [cross] * n,
                "xv": [cross] * n, "slot_pos": "batch cache_seq",
                "pos": "batch"}
    if model.family == "rwkv":
        return {"pos": "batch",
                "states": [("batch embed", "batch heads head_dim state",
                            "batch embed")] * cfg.n_layers}
    if model.family == "zamba":
        from repro_torch.models.lm import _zamba_groups
        g, per, tail = _zamba_groups(cfg)
        layer = ("batch conv_k inner", "batch heads head_dim state")
        mamba = {"groups": [[layer] * per for _ in range(g)],
                 "tail": [layer] * tail}     # the port's cache always has it
        return {"pos": "batch", "slot_pos": "batch cache_seq",
                "mamba": mamba, "attn_k": [kv] * g, "attn_v": [kv] * g}
    from repro_torch.models.lm import _make_stacks
    ax: dict = {"pos": "batch", "slot_pos": "batch cache_seq"}
    for i, spec in enumerate(_make_stacks(cfg)):
        if cfg.attn_kind == "mla":
            ax[f"stack{i}"] = {"ckv": ["batch cache_seq kv_lora"]
                               * spec.n_layers,
                               "krope": ["batch cache_seq qk_dim"]
                               * spec.n_layers}
        else:
            ax[f"stack{i}"] = {"k": [kv] * spec.n_layers,
                               "v": [kv] * spec.n_layers}
    return ax

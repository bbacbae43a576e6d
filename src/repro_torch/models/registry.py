"""Model registry: config -> `Model`, a record of plain functions over a
parameter tree (`layers.ParamTree`)."""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.configs.base import ModelConfig


class Model(NamedTuple):
    config: ModelConfig
    init: Callable          # (generator) -> params (a ParamTree)
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

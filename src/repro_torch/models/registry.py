"""Model registry: config -> `Model`, a record of plain functions over a
parameter tree (`layers.ParamTree`)."""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.configs.base import ModelConfig


class Model(NamedTuple):
    config: ModelConfig
    init: Callable          # (generator) -> params (a ParamTree)
    forward: Callable       # (params, batch, *, collect[, init_state])
                            # -> (x, parts)
    prefill: Callable       # (params, batch) -> (logits [B, V], cache)
    decode_step: Callable   # (params, cache, tokens [B]) -> (logits, cache)
    extend: Callable        # (params, cache, tokens [B, Sn], lens_new) -> ...
    init_cache: Callable    # (b, max_len, device) -> cache
    family: str


def build_model(cfg: ModelConfig) -> Model:
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models wait "
                                  "for the seamless-m4t slice")
    from repro_torch.models.lm import build_lm

    fns = build_lm(cfg)
    return Model(config=cfg, **fns)

"""Decoder-only language model of the dense GQA family (the reference's
`repro.models.lm`, ``family == "attn"`` with one dense stack).

* The reference stacks homogeneous layers (leading dim L) and drives them
  with ``lax.scan`` / ``fori_loop``; here each stack is a ``ModuleList`` of
  per-layer parameter trees walked by a Python loop, and a cache holds one
  k and one v tensor per layer, so a decode step copies one layer's cache
  at a time instead of the stack.
* ``extend`` is the multi-turn entry point the serving engine uses for
  KV-prefix reuse, the physical substrate of the paper's affinity o_ij.
* Caches are dicts ``{"pos": [B] int32, "slot_pos": [B, M] int32,
  "stack0": {"k": [L x [B, M, Hkv, hd]], "v": [...]}}``; every function
  returns a new cache and leaves the one it was given as it was.
* RWKV-6, zamba2, MoE stacks, MLA and patch inputs raise
  ``NotImplementedError`` naming the slice that ports them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.models import attention as attn
from repro_torch.models import blocks as blk
from repro_torch.models.layers import (ParamTree, ffn_apply, normal_init,
                                       rms_norm)


@dataclass(frozen=True)
class StackSpec:
    n_layers: int
    ffn_kind: str  # dense (moe waits for its slice)
    d_ff: int


def _make_stacks(cfg) -> list[StackSpec]:
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: MoE stacks wait for the MoE "
                                  "slice")
    return [StackSpec(cfg.n_layers, "dense", cfg.d_ff)]


def _check_family(cfg) -> None:
    if cfg.ssm_kind == "rwkv6":
        raise NotImplementedError(f"{cfg.name}: the RWKV-6 family (wkv6) "
                                  "waits for the rwkv6-3b slice")
    if cfg.attn_every or cfg.ssm_kind:
        raise NotImplementedError(f"{cfg.name}: the Mamba-2 hybrid (ssd) "
                                  "waits for the zamba2-7b slice")
    if cfg.attn_kind != "gqa":
        raise NotImplementedError(f"{cfg.name}: attention kind "
                                  f"{cfg.attn_kind!r} (MLA) waits for its "
                                  "family slice")
    if cfg.n_patches:
        raise NotImplementedError(f"{cfg.name}: patch inputs wait for the "
                                  "VLM slice")


def build_lm(cfg):
    _check_family(cfg)
    dtype = getattr(torch, cfg.dtype)
    stacks = _make_stacks(cfg)
    window = cfg.sliding_window

    # ---------------- init ----------------
    def init(generator: torch.Generator) -> ParamTree:
        """Parameters drawn from ``generator`` on its device (float32 draws
        cast to the config's dtype).  A torch generator gives other numbers
        than the reference's ``jax.random`` key of the same seed."""
        params = {
            "embed": normal_init((cfg.vocab_size, cfg.d_model), cfg.d_model,
                                 dtype, generator=generator),
            "final_norm": torch.ones((cfg.d_model,), dtype=dtype,
                                     device=generator.device),
            "lm_head": normal_init((cfg.d_model, cfg.vocab_size),
                                   cfg.d_model, dtype, generator=generator),
        }
        for i, spec in enumerate(stacks):
            sub = dataclasses.replace(cfg, d_ff=spec.d_ff)
            params[f"stack{i}"] = [
                blk.attn_block_init(sub, dtype, generator=generator,
                                    ffn_kind=spec.ffn_kind)
                for _ in range(spec.n_layers)]
        return ParamTree(params)

    def _head(params, x):
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x @ params["lm_head"]

    def _last(x, lens):
        rows = torch.arange(x.shape[0], device=x.device)
        return x[rows, (lens - 1).clamp(min=0).long()]

    # ---------------- parallel forward (fresh prefill) ----------------
    def forward(params, batch, *, collect: bool):
        """Returns (x_final [B, S, D], {stack: [(k, v) per layer]} or {})."""
        x = params["embed"][batch["tokens"].long()]
        parts = {}
        for i, _spec in enumerate(stacks):
            kvs = []
            for p_l in params[f"stack{i}"]:
                x, kv = blk.attn_block_parallel(p_l, x, cfg)
                if collect:
                    kvs.append(kv)
            if collect:
                parts[f"stack{i}"] = kvs
        return x, parts

    # ---------------- caches ----------------
    def init_cache(b: int, max_len: int, device) -> dict:
        m = min(window, max_len) if window else max_len
        c = {"pos": torch.zeros((b,), dtype=torch.int32, device=device),
             "slot_pos": torch.full((b, m), -1, dtype=torch.int32,
                                    device=device)}
        for i, spec in enumerate(stacks):
            c[f"stack{i}"] = {
                kk: [torch.zeros((b, m, cfg.n_kv_heads, cfg.hd), dtype=dtype,
                                 device=device)
                     for _ in range(spec.n_layers)]
                for kk in ("k", "v")}
        return c

    # ---------------- fresh prefill ----------------
    def prefill(params, batch):
        """batch: tokens [B, S] (+ lens [B] for right-padded prompts, +
        max_len).  Returns (last-token logits [B, V], cache)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        lens = batch.get("lens")
        if lens is None:
            lens = torch.full((b,), s, dtype=torch.int32,
                              device=tokens.device)
        max_len = int(batch.get("max_len", s))
        x, parts = forward(params, batch, collect=True)
        logits = _head(params, _last(x, lens))
        cache = {"pos": lens.to(torch.int32)}
        for i, _spec in enumerate(stacks):
            ks, vs = [], []
            for k_l, v_l in parts[f"stack{i}"]:
                kc, vc, sp = attn.prefill_cache_layout(k_l, v_l, lens,
                                                       max_len, window=window)
                ks.append(kc)
                vs.append(vc)
                cache.setdefault("slot_pos", sp)
            cache[f"stack{i}"] = {"k": ks, "v": vs}
        return logits, cache

    # ---------------- decode step ----------------
    def decode_step(params, cache, tokens):
        """tokens: [B] -> (logits [B, V], new cache)."""
        x = params["embed"][tokens.long()]
        pos = cache["pos"]
        new_cache = dict(cache)
        sp_out = cache["slot_pos"]
        for i, _spec in enumerate(stacks):
            st = cache[f"stack{i}"]
            ks, vs = [], []
            for l, p_l in enumerate(params[f"stack{i}"]):
                cl = {"k": st["k"][l], "v": st["v"][l],
                      "slot_pos": cache["slot_pos"], "pos": pos}
                x, nc = blk.attn_block_decode(p_l, x, cl, cfg)
                ks.append(nc["k"])
                vs.append(nc["v"])
                sp_out = nc["slot_pos"]
            new_cache[f"stack{i}"] = {"k": ks, "v": vs}
        new_cache["slot_pos"] = sp_out
        new_cache["pos"] = pos + 1
        return _head(params, x), new_cache

    # ---------------- multi-turn extend (serving KV reuse) -------------
    def extend(params, cache, tokens, lens_new):
        """A new block of tokens [B, Sn] (lens_new [B] valid) against an
        existing cache: chunked prefill over the KV cache."""
        x = params["embed"][tokens.long()]
        pos0 = cache["pos"]
        new_cache = dict(cache)
        sp_out = cache["slot_pos"]
        for i, spec in enumerate(stacks):
            st = cache[f"stack{i}"]
            ks, vs = [], []
            for l, p_l in enumerate(params[f"stack{i}"]):
                h = rms_norm(x, p_l["ln1"], cfg.norm_eps)
                cl = {"k": st["k"][l], "v": st["v"][l],
                      "slot_pos": cache["slot_pos"], "pos": pos0}
                o, nc = attn.gqa_extend(p_l["attn"], h, cl, cfg, lens_new)
                x = _block_ffn(p_l, x + o, cfg, spec.ffn_kind)
                ks.append(nc["k"])
                vs.append(nc["v"])
                if l == 0:
                    sp_out = nc["slot_pos"]
            new_cache[f"stack{i}"] = {"k": ks, "v": vs}
        new_cache["slot_pos"] = sp_out
        new_cache["pos"] = pos0 + lens_new
        return _head(params, _last(x, lens_new)), new_cache

    return {"init": init, "forward": forward, "prefill": prefill,
            "decode_step": decode_step, "extend": extend,
            "init_cache": init_cache, "family": "attn"}


def _block_ffn(p_l, y, cfg, ffn_kind):
    if ffn_kind != "dense":
        raise NotImplementedError("MoE FFN waits for the MoE slice")
    h = rms_norm(y, p_l["ln2"], cfg.norm_eps)
    return y + ffn_apply(p_l["mlp"], h)

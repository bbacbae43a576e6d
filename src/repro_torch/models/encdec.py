"""Encoder-decoder LM (the seamless-m4t backbone; the reference's
`repro.models.encdec`).

The speech frontend is a stub, as in the reference: the model consumes
precomputed frame embeddings ``frames`` [B, src_len, D].  The encoder is
bidirectional (RoPE on the frame positions); the decoder is causal, with a
cross-attention over the encoder's output in every layer.  The cross K/V
are the session-reusable state of the serving engine.

* The reference stacks each group's layers (leading dim L) and scans them;
  here ``encoder`` and ``decoder`` are lists of per-layer parameter trees
  walked by a Python loop, and a cache holds per-layer lists: ``{"k",
  "v": [L x [B, M, Hkv, hd]], "xk", "xv": [L x [B, src_len, Hkv, hd]],
  "slot_pos": [B, M] int32, "pos": [B] int32}``.  Every function returns a
  new cache and leaves the one it was given as it was.
* On a CUDA tensor the encoder's self-attention and a prefill's
  cross-attention (the decoder's prompt against the src_len frames, Sq !=
  Sk) run the flash-attention kernel non-causal, the decoder's
  self-attention runs it causal, and a decode step's cross-attention runs
  the decode-attention kernel over all src_len frames, every slot valid
  (``slot_pos`` zeros, ``pos`` = src_len, as the reference calls it).
* ``extend`` raises, as the reference's does; its serving engine has no
  fallback, so a turn that is neither fresh, a repeat nor a truncation of
  the stored prompt raises (ROADMAP §3).
* ``loss`` checkpoints every encoder and decoder layer (``remat``, as in
  `lm.py`) and reads ``batch["frames"]``: a batch without frames raises
  KeyError, as the reference's does.
* Under a sequence split (`distributed/seq_parallel.py`) a rank holds its
  block of the frames (src_len / M) and of the tokens (S / M).  The
  encoder runs under a split of its own (the same ranks, its block of
  frames): each layer rotates at the block's global frame positions and
  gathers K/V over the axis to attend non-causally.  Each decoder layer
  projects the cross K/V of its rank's encoder output and gathers them
  (one all-gather a layer, the projections' FLOPs split), and its
  self-attention attends at its block's offset (`attention.rope_attend`).
  Under the split step's parameter binding each encoder and decoder layer
  gathers its leaves inside its checkpoint, as `lm.py`'s layers do, and
  ``frame_proj`` and ``enc_norm`` are gathered where they are read.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed import param_gather, seq_parallel
from repro_torch.models import attention as attn
from repro_torch.models.layers import (FFN_AXES, ParamTree, apply_rope,
                                       ffn_apply, ffn_init, normal_init,
                                       rms_norm)
from repro_torch.models.lm import (_embed, _head_loss, _last, _lens,
                                   _lm_head, _remat, _stack_axes)


def _ones(cfg, dtype, device) -> torch.Tensor:
    return torch.ones((cfg.d_model,), dtype=dtype, device=device)


def _enc_block_init(cfg, dtype, *, generator: torch.Generator) -> dict:
    dev = generator.device
    return {"ln1": _ones(cfg, dtype, dev),
            "attn": attn.gqa_init(cfg, dtype, generator=generator),
            "ln2": _ones(cfg, dtype, dev),
            "mlp": ffn_init(cfg.d_model, cfg.d_ff, dtype,
                            generator=generator)}


def _dec_block_init(cfg, dtype, *, generator: torch.Generator) -> dict:
    dev = generator.device
    return {"ln1": _ones(cfg, dtype, dev),
            "attn": attn.gqa_init(cfg, dtype, generator=generator),
            "lnx": _ones(cfg, dtype, dev),
            "xattn": attn.gqa_init(cfg, dtype, generator=generator),
            "ln2": _ones(cfg, dtype, dev),
            "mlp": ffn_init(cfg.d_model, cfg.d_ff, dtype,
                            generator=generator)}


def _block_axes(cfg, cross: bool):
    ax = {"ln1": "embed", "attn": attn.gqa_axes(cfg), "ln2": "embed",
          "mlp": dict(FFN_AXES)}
    if cross:
        ax["lnx"] = "embed"
        ax["xattn"] = attn.gqa_axes(cfg)
    return ax


def _enc_block(p, x, cfg):
    """One bidirectional encoder layer over x [B, src_len, D], or under a
    sequence split over this rank's block of the frames, whose rows
    attend to every rank's K/V (gathered over the axis)."""
    split = seq_parallel.current()
    offset = split.offset if split else 0
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = attn._qkv(p["attn"], h, cfg)
    pos = torch.arange(offset, offset + x.shape[1], device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    if split:
        k, v = seq_parallel.gather_seq((k, v), split)
    o = attn.attend_parallel(q, k, v, causal=False)
    x = x + torch.einsum("...hk,hkd->...d", o, p["attn"]["wo"])
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + ffn_apply(p["mlp"], h)


def _cross_kv(p, enc_out):
    """A decoder layer's cross K/V of the encoder output [B, src_len, D];
    under a sequence split ``enc_out`` is this rank's block of frames,
    whose K/V are gathered over the axis into every frame's."""
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["xattn"]["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["xattn"]["wv"])
    split = seq_parallel.current()
    return seq_parallel.gather_seq((k, v), split) if split else (k, v)


def _cross_attend(p, h, xk, xv):
    """h [B, S, D] (a prompt) or [B, D] (a decode step) against the cross
    K/V [B, src_len, Hkv, hd]; no RoPE, as in the reference."""
    q = torch.einsum("...d,dhk->...hk", h, p["xattn"]["wq"])
    if h.dim() == 2:  # decode step: every frame is a valid slot
        b, src = xk.shape[:2]
        o = attn.attend_decode(
            q, xk, xv, torch.zeros((b, src), dtype=torch.int32,
                                   device=h.device),
            torch.full((b,), src, dtype=torch.int32, device=h.device))
    else:
        o = attn.attend_parallel(q, xk, xv, causal=False)
    return torch.einsum("...hk,hkd->...d", o, p["xattn"]["wo"])


def _dec_block_parallel(p, x, xk, xv, cfg):
    """Returns (x, (k, v) of the self-attention for the cache layout)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    o, kv = attn.gqa_parallel(p["attn"], h, cfg)
    x = x + o
    h = rms_norm(x, p["lnx"], cfg.norm_eps)
    x = x + _cross_attend(p, h, xk, xv)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + ffn_apply(p["mlp"], h), kv


def _dec_block_step(p, x, cache_layer, xk, xv, cfg):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    o, nc = attn.gqa_decode(p["attn"], h, cache_layer, cfg)
    x = x + o
    h = rms_norm(x, p["lnx"], cfg.norm_eps)
    x = x + _cross_attend(p, h, xk, xv)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + ffn_apply(p["mlp"], h), nc


def build_encdec(cfg):
    dtype = getattr(torch, cfg.dtype)

    def init(generator: torch.Generator) -> ParamTree:
        """Parameters drawn from ``generator`` on its device (float32 draws
        cast to the config's dtype); other numbers than the reference's
        ``jax.random`` key of the same seed."""
        d, dev = cfg.d_model, generator.device
        return ParamTree({
            "embed": normal_init((cfg.vocab_size, d), d, dtype,
                                 generator=generator),
            "frame_proj": normal_init((d, d), d, dtype, generator=generator),
            "encoder": [_enc_block_init(cfg, dtype, generator=generator)
                        for _ in range(cfg.enc_layers)],
            "enc_norm": _ones(cfg, dtype, dev),
            "decoder": [_dec_block_init(cfg, dtype, generator=generator)
                        for _ in range(cfg.n_layers)],
            "final_norm": _ones(cfg, dtype, dev),
            "lm_head": normal_init((d, cfg.vocab_size), d, dtype,
                                   generator=generator),
        })

    def param_axes():
        return {
            "embed": "vocab embed",
            "frame_proj": "embed embed",
            "encoder": _stack_axes(_block_axes(cfg, cross=False),
                                   cfg.enc_layers),
            "enc_norm": "embed",
            "decoder": _stack_axes(_block_axes(cfg, cross=True),
                                   cfg.n_layers),
            "final_norm": "embed",
            "lm_head": "embed vocab",
        }

    def encode(params, frames, *, remat: bool = False):
        """frames [B, src_len, D] (any float dtype) -> the normed encoder
        output [B, src_len, D] in the model's dtype.  Under a sequence
        split ``frames`` is this rank's block, and the layers run under a
        split of the same ranks whose S_local is the block's frames."""
        split = seq_parallel.current()
        x = frames.to(dtype) @ param_gather.whole(params["frame_proj"])
        with seq_parallel.split(split and dataclasses.replace(
                split, s_local=frames.shape[1])):
            layer = _remat(lambda p_l, x: _enc_block(p_l, x, cfg), remat)
            for p_l in params["encoder"]:
                x = layer(p_l, x)
        return rms_norm(x, param_gather.whole(params["enc_norm"]),
                        cfg.norm_eps)

    def _decoder_layer(p_l, x, enc_out):
        xk, xv = _cross_kv(p_l, enc_out)
        x, kv = _dec_block_parallel(p_l, x, xk, xv, cfg)
        return x, kv, (xk, xv)

    def forward(params, batch, *, collect: bool, remat: bool = False):
        """batch: tokens [B, S], frames [B, src_len, D].  Returns (x_final
        [B, S, D], {"kv": [per layer (k, v)], "cross": [per layer (xk,
        xv)]} or {})."""
        enc_out = encode(params, batch["frames"], remat=remat)
        x = _embed(params, batch["tokens"])
        layer = _remat(_decoder_layer, remat)
        kvs, cross = [], []
        for p_l in params["decoder"]:
            x, kv, xkv = layer(p_l, x, enc_out)
            if collect:
                kvs.append(kv)
                cross.append(xkv)
        return x, ({"kv": kvs, "cross": cross} if collect else {})

    def init_cache(b: int, max_len: int, device) -> dict:
        def zeros(m):
            return [torch.zeros((b, m, cfg.n_kv_heads, cfg.hd), dtype=dtype,
                                device=device) for _ in range(cfg.n_layers)]

        return {"k": zeros(max_len), "v": zeros(max_len),
                "xk": zeros(cfg.src_len), "xv": zeros(cfg.src_len),
                "slot_pos": torch.full((b, max_len), -1, dtype=torch.int32,
                                       device=device),
                "pos": torch.zeros((b,), dtype=torch.int32, device=device)}

    def prefill(params, batch):
        """batch: tokens [B, S] (+ lens [B] for right-padded prompts, +
        max_len), frames [B, src_len, D].  Returns (last-token logits
        [B, V], cache)."""
        lens = _lens(batch)
        max_len = int(batch.get("max_len", batch["tokens"].shape[1]))
        x, parts = forward(params, batch, collect=True)
        cache = {"k": [], "v": [], "xk": [], "xv": [], "pos": lens}
        for (k, v), (xk, xv) in zip(parts["kv"], parts["cross"]):
            kc, vc, sp = attn.prefill_cache_layout(k, v, lens, max_len)
            cache["k"].append(kc)
            cache["v"].append(vc)
            cache["xk"].append(xk)
            cache["xv"].append(xv)
            cache["slot_pos"] = sp
        return _lm_head(params, _last(x, lens), cfg), cache

    def decode_step(params, cache, tokens):
        """tokens: [B] -> (logits [B, V], new cache)."""
        x = params["embed"][tokens.long()]
        pos = cache["pos"]
        ks, vs, sp = [], [], cache["slot_pos"]
        for l, p_l in enumerate(params["decoder"]):
            cl = {"k": cache["k"][l], "v": cache["v"][l],
                  "slot_pos": cache["slot_pos"], "pos": pos}
            x, nc = _dec_block_step(p_l, x, cl, cache["xk"][l],
                                    cache["xv"][l], cfg)
            ks.append(nc["k"])
            vs.append(nc["v"])
            sp = nc["slot_pos"]
        new_cache = dict(cache)
        new_cache.update(k=ks, v=vs, slot_pos=sp, pos=pos + 1)
        return _lm_head(params, x, cfg), new_cache

    def extend(params, cache, tokens, lens_new):
        # the reference's own gap, reproduced: its engine has no fallback
        raise NotImplementedError(
            "enc-dec extend: cross-cache is session-static; the engine "
            "re-prefills the decoder (see serving/engine.py)")

    def loss(params, batch):
        """The decoder's next-token loss over batch["tokens"] [B, S] given
        batch["frames"] [B, src_len, D]; under a sequence split the batch
        holds this rank's blocks of both (`lm._head_loss`)."""
        x, _ = forward(params, batch, collect=False, remat=True)
        return _head_loss(params, x, batch, cfg)

    return {"init": init, "forward": forward, "prefill": prefill,
            "decode_step": decode_step, "extend": extend,
            "init_cache": init_cache, "loss": loss, "family": "encdec",
            "param_axes": param_axes, "encode": encode}

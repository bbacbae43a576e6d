"""Decoder-only language models of three families (the reference's
`repro.models.lm`): ``attn`` (the attention decoder: GQA or MLA attention,
one dense stack, or for MoE configs a dense stack of
``first_dense_layers`` and then the MoE stack), ``rwkv`` (RWKV-6) and
``zamba`` (Mamba-2 layers in groups, each followed by one shared attention
block).

* The reference stacks homogeneous layers (leading dim L) and drives them
  with ``lax.scan`` / ``fori_loop``; here each stack is a ``ModuleList`` of
  per-layer parameter trees walked by a Python loop, and a cache holds one
  k and one v tensor per layer, so a decode step copies one layer's cache
  at a time instead of the stack.
* ``extend`` is the multi-turn entry point the serving engine uses for
  KV-prefix reuse, the physical substrate of the paper's affinity o_ij.
* Caches hold per-layer lists of tensors in place of the reference's
  stacked ``[L, ...]`` arrays: ``{"pos": [B] int32, "slot_pos": [B, M]
  int32, "stack<i>": {"k": [L x [B, M, Hkv, hd]], "v": [...]}}`` for GQA,
  ``{"ckv": [L x [B, M, lora]], "krope": [L x [B, M, rope]]}`` per stack
  for MLA (the compressed latent, no ring); per-layer state tuples for
  rwkv and zamba (see `_build_rwkv`, `_build_zamba`).  Every function
  returns a new cache and leaves the one it was given as it was.
* For the recurrent families the parallel forms run from a stored state,
  so rwkv's ``extend`` is a prefill of the new tokens from the cache;
  zamba's ``extend`` raises, as the reference's does.
* Patch inputs (llava-next-34b, the attention decoder): a prefill batch's
  ``patches`` [B, P, D] are prepended to the token embeddings, so the
  prompt's positions, ``lens`` and the cache start with the P patches,
  and decode and extend go on from ``lens + P``.
* Training: ``loss`` runs ``forward`` with ``remat=True``, each layer (a
  group of layers and its shared block, for zamba) under
  ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): its
  forward runs once keeping only its inputs, and once more in the
  backward.  On the card every attention call therefore launches the
  flash kernel twice per step and its backward kernel once, and every
  RWKV-6 or Mamba-2 layer its scan kernel twice and the scan's backward
  kernel once (a zamba group's re-run forward keeps the saved states of
  its layers until the group's backward has read them).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.distributed import seq_parallel
from repro_torch.models import attention as attn
from repro_torch.models import blocks as blk
from repro_torch.models.layers import (ParamTree, next_token_loss,
                                       normal_init, rms_norm)
from repro_torch.models.scan_config import checkpointed


@dataclass(frozen=True)
class StackSpec:
    n_layers: int
    ffn_kind: str  # dense | moe
    d_ff: int


def _make_stacks(cfg) -> list[StackSpec]:
    if cfg.is_moe:
        nd = cfg.first_dense_layers
        stacks = []
        if nd:
            stacks.append(StackSpec(nd, "dense", cfg.dense_d_ff or cfg.d_ff))
        stacks.append(StackSpec(cfg.n_layers - nd, "moe",
                                cfg.moe_d_ff or cfg.d_ff))
        return stacks
    return [StackSpec(cfg.n_layers, "dense", cfg.d_ff)]


def _family(cfg) -> str:
    """The reference's family switch: rwkv, zamba (Mamba-2 + shared
    attention) or attn (the attention decoder, dense or MoE)."""
    if cfg.ssm_kind == "rwkv6":
        return "rwkv"
    return "zamba" if cfg.attn_every else "attn"


def _remat(fn, remat: bool):
    """``fn``, or ``fn`` under activation checkpointing (non-reentrant, so
    closures over parameters get their gradients), its re-run under the
    sequence split of its forward (`seq_parallel.bound`)."""
    return checkpointed(seq_parallel.bound(fn)) if remat else fn


def _stack_axes(ax, n: int) -> list:
    """The reference's ``_prefix_axes(ax, "layers")`` for a stack of ``n``
    layers: where the reference names the stacked leading dim, the port
    keeps one table per layer, as it keeps one tree per layer."""
    return [ax] * n


def _head_axes() -> dict:
    return {"embed": "vocab embed", "final_norm": "embed",
            "lm_head": "embed vocab"}


def build_lm(cfg):
    family = _family(cfg)
    if family == "rwkv":
        return _build_rwkv(cfg)
    if family == "zamba":
        return _build_zamba(cfg)
    dtype = getattr(torch, cfg.dtype)
    stacks = _make_stacks(cfg)
    window = cfg.sliding_window
    mla = cfg.attn_kind == "mla"
    keys = ("ckv", "krope") if mla else ("k", "v")    # a layer's cache

    # ---------------- init ----------------
    def init(generator: torch.Generator) -> ParamTree:
        """Parameters drawn from ``generator`` on its device (float32 draws
        cast to the config's dtype).  A torch generator gives other numbers
        than the reference's ``jax.random`` key of the same seed."""
        params = _embed_and_head(cfg, dtype, generator)
        for i, spec in enumerate(stacks):
            sub = dataclasses.replace(cfg, d_ff=spec.d_ff)
            params[f"stack{i}"] = [
                blk.attn_block_init(sub, dtype, generator=generator,
                                    ffn_kind=spec.ffn_kind)
                for _ in range(spec.n_layers)]
        return ParamTree(params)

    def param_axes():
        """Logical axes of every leaf, in `init`'s tree layout."""
        ax = _head_axes()
        for i, spec in enumerate(stacks):
            sub = dataclasses.replace(cfg, d_ff=spec.d_ff)
            ax[f"stack{i}"] = _stack_axes(
                blk.attn_block_axes(sub, ffn_kind=spec.ffn_kind),
                spec.n_layers)
        return ax

    # ---------------- parallel forward (fresh prefill) ----------------
    def forward(params, batch, *, collect: bool, lens=None,
                remat: bool = False):
        """Returns (x_final [B, S, D], {stack: [cacheables per layer]} or
        {}): (k, v) for GQA, (ckv, krope) for MLA."""
        x = _embed_inputs(params, batch, cfg)
        parts = {}
        for i, spec in enumerate(stacks):
            kvs = []
            layer = _remat(lambda p_l, x, _kind=spec.ffn_kind:
                           blk.attn_block_parallel(p_l, x, cfg,
                                                   ffn_kind=_kind,
                                                   lens=lens), remat)
            for p_l in params[f"stack{i}"]:
                x, kv = layer(p_l, x)
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
        shapes = (((b, m, cfg.kv_lora_rank), (b, m, cfg.qk_rope_dim)) if mla
                  else ((b, m, cfg.n_kv_heads, cfg.hd),) * 2)
        for i, spec in enumerate(stacks):
            c[f"stack{i}"] = {
                kk: [torch.zeros(sh, dtype=dtype, device=device)
                     for _ in range(spec.n_layers)]
                for kk, sh in zip(keys, shapes)}
        return c

    def _mla_layout(ckv, krope, lens, max_len: int):
        """The reference's MLA prefill layout: latents padded to max_len
        (padded positions' latents kept, only ``slot_pos`` marks them
        invalid: a pad, not a masked copy), no ring."""
        b, s = ckv.shape[:2]
        pad = lambda t: torch.cat(  # noqa: E731
            [t, t.new_zeros((b, max_len - s, t.shape[-1]))], dim=1)
        pos = torch.arange(s, device=ckv.device)
        sp = torch.full((b, max_len), -1, dtype=torch.int32,
                        device=ckv.device)
        sp[:, :s] = torch.where(pos[None, :] < lens[:, None], pos[None, :],
                                -1)
        return pad(ckv), pad(krope), sp

    # ---------------- fresh prefill ----------------
    def prefill(params, batch):
        """batch: tokens [B, S] (+ lens [B] for right-padded prompts, +
        max_len, + patches [B, P, D] ahead of the tokens: lens and the
        default max_len then count the P patches too).  Returns (last-token
        logits [B, V], cache)."""
        lens = _lens(batch)
        s = batch["tokens"].shape[1]
        if cfg.n_patches and "patches" in batch:
            lens = lens + cfg.n_patches
            s += cfg.n_patches
        max_len = int(batch.get("max_len", s))
        x, parts = forward(params, batch, collect=True, lens=lens)
        logits = _lm_head(params, _last(x, lens), cfg)
        cache = {"pos": lens}
        for i, _spec in enumerate(stacks):
            st = {kk: [] for kk in keys}
            for a, c in parts[f"stack{i}"]:
                if mla:
                    a, c, sp = _mla_layout(a, c, lens, max_len)
                else:
                    a, c, sp = attn.prefill_cache_layout(
                        a, c, lens, max_len, window=window)
                st[keys[0]].append(a)
                st[keys[1]].append(c)
                cache.setdefault("slot_pos", sp)
            cache[f"stack{i}"] = st
        return logits, cache

    # ---------------- decode step ----------------
    def decode_step(params, cache, tokens):
        """tokens: [B] -> (logits [B, V], new cache)."""
        x = params["embed"][tokens.long()]
        pos = cache["pos"]
        new_cache = dict(cache)
        sp_out = cache["slot_pos"]
        for i, spec in enumerate(stacks):
            st = cache[f"stack{i}"]
            new = {kk: [] for kk in keys}
            for l, p_l in enumerate(params[f"stack{i}"]):
                cl = {kk: st[kk][l] for kk in keys}
                cl.update(slot_pos=cache["slot_pos"], pos=pos)
                x, nc = blk.attn_block_decode(p_l, x, cl, cfg,
                                              ffn_kind=spec.ffn_kind)
                for kk in keys:
                    new[kk].append(nc[kk])
                sp_out = nc["slot_pos"]
            new_cache[f"stack{i}"] = new
        new_cache["slot_pos"] = sp_out
        new_cache["pos"] = pos + 1
        return _lm_head(params, x, cfg), new_cache

    # ---------------- multi-turn extend (serving KV reuse) -------------
    def extend(params, cache, tokens, lens_new):
        """A new block of tokens [B, Sn] (lens_new [B] valid) against an
        existing cache: chunked prefill over the KV or latent cache."""
        x = params["embed"][tokens.long()]
        pos0 = cache["pos"]
        new_cache = dict(cache)
        sp_out = cache["slot_pos"]
        attn_extend = attn.mla_extend if mla else attn.gqa_extend
        for i, spec in enumerate(stacks):
            st = cache[f"stack{i}"]
            new = {kk: [] for kk in keys}
            for l, p_l in enumerate(params[f"stack{i}"]):
                h = rms_norm(x, p_l["ln1"], cfg.norm_eps)
                cl = {kk: st[kk][l] for kk in keys}
                cl.update(slot_pos=cache["slot_pos"], pos=pos0)
                o, nc = attn_extend(p_l["attn"], h, cl, cfg, lens_new)
                x = _block_ffn(p_l, x + o, cfg, spec.ffn_kind)
                for kk in keys:
                    new[kk].append(nc[kk])
                if l == 0:
                    sp_out = nc["slot_pos"]
            new_cache[f"stack{i}"] = new
        new_cache["slot_pos"] = sp_out
        new_cache["pos"] = pos0 + lens_new
        return _lm_head(params, _last(x, lens_new), cfg), new_cache

    # ---------------- loss ----------------
    def loss(params, batch):
        """The next-token loss over batch["tokens"] [B, S] (+ patches).
        With ``n_patches`` in the config, the reference prepends that many
        -100 targets whether or not the batch holds patches, so a batch
        without them raises, as the reference's does (ROADMAP §3).  Under
        a sequence split the batch is a rank's block and also holds its
        ``targets`` [B, S_local] and each row's ``target_count`` over the
        whole sequence (`training.loop`; `layers.next_token_loss`)."""
        x, _ = forward(params, batch, collect=False, remat=True)
        tokens = batch["tokens"]
        if "targets" in batch:
            return next_token_loss(_lm_head(params, x, cfg), tokens,
                                   targets=batch["targets"],
                                   count=batch["target_count"].sum())
        if cfg.n_patches:
            tokens = torch.cat([torch.full(
                (tokens.shape[0], cfg.n_patches), -100, dtype=tokens.dtype,
                device=tokens.device), tokens], dim=1)
        return next_token_loss(_lm_head(params, x, cfg), tokens)

    return {"init": init, "forward": forward, "prefill": prefill,
            "decode_step": decode_step, "extend": extend,
            "init_cache": init_cache, "loss": loss, "family": "attn",
            "param_axes": param_axes}


def _block_ffn(p_l, y, cfg, ffn_kind):
    h = rms_norm(y, p_l["ln2"], cfg.norm_eps)
    return y + blk.ffn(p_l, h, cfg, ffn_kind)


# ---------------- shared by the families ----------------

def _embed_and_head(cfg, dtype, generator: torch.Generator) -> dict:
    return {
        "embed": normal_init((cfg.vocab_size, cfg.d_model), cfg.d_model,
                             dtype, generator=generator),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype,
                                 device=generator.device),
        "lm_head": normal_init((cfg.d_model, cfg.vocab_size), cfg.d_model,
                               dtype, generator=generator),
    }


def _embed(params, tokens):
    """Token embeddings through ``F.embedding``: the same values as
    indexing, but its backward sums each row's gradient in a fixed order
    on both devices, where indexing's accumulates with atomics on the CPU,
    so a resumed training run repeats an uninterrupted one bit for bit."""
    return torch.nn.functional.embedding(tokens.long(), params["embed"])


def _embed_inputs(params, batch, cfg):
    """The token embeddings [B, S, D], after the batch's patch embeddings
    [B, P, D] (cast to the model's dtype) where the config takes them."""
    x = _embed(params, batch["tokens"])
    if cfg.n_patches and "patches" in batch:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    return x


def _lm_head(params, x, cfg):
    return rms_norm(x, params["final_norm"], cfg.norm_eps) @ params["lm_head"]


def _last(x, lens):
    """Each sequence's row at its last valid position: x [B, S, D]."""
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows, (lens - 1).clamp(min=0).long()]


def _lens(batch) -> torch.Tensor:
    tokens = batch["tokens"]
    lens = batch.get("lens")
    if lens is None:
        lens = torch.full((tokens.shape[0],), tokens.shape[1],
                          dtype=torch.int32, device=tokens.device)
    return lens.to(torch.int32)


# ---------------- RWKV-6 (attention-free, O(1) state) ----------------

def _rwkv_zero_state(cfg, b: int, dtype, device) -> list:
    """One (shift_t [B, D], wkv [B, H, hd, hd] float32, shift_c [B, D])
    per layer."""
    h, hd, d = cfg.ssm_heads, cfg.ssm_state, cfg.d_model
    return [(torch.zeros((b, d), dtype=dtype, device=device),
             torch.zeros((b, h, hd, hd), dtype=torch.float32, device=device),
             torch.zeros((b, d), dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]


def _build_rwkv(cfg):
    """The reference's ``family == "rwkv"``.  A cache is ``{"pos": [B]
    int32, "states": [per layer (shift_t, wkv, shift_c)]}``; the parallel
    form runs from a stored state, so an extend is a prefill of the new
    tokens from the cache (exact-extension semantics)."""
    dtype = getattr(torch, cfg.dtype)

    def init(generator: torch.Generator) -> ParamTree:
        params = _embed_and_head(cfg, dtype, generator)
        params["layers"] = [blk.rwkv_block_init(cfg, dtype,
                                                generator=generator)
                            for _ in range(cfg.n_layers)]
        return ParamTree(params)

    def forward(params, batch, *, collect: bool, init_state=None,
                remat: bool = False):
        """Returns (x_final [B, S, D], {"states": [per layer]} or {})."""
        x = _embed(params, batch["tokens"])
        states = init_state if init_state is not None else _rwkv_zero_state(
            cfg, x.shape[0], x.dtype, x.device)
        layer = _remat(lambda p_l, x, st: blk.rwkv_block_parallel(
            p_l, x, cfg, state=st), remat)
        new = []
        for p_l, st in zip(params["layers"], states):
            x, st = layer(p_l, x, st)
            new.append(st)
        return x, ({"states": new} if collect else {})

    def init_cache(b: int, max_len: int, device) -> dict:
        return {"pos": torch.zeros((b,), dtype=torch.int32, device=device),
                "states": _rwkv_zero_state(cfg, b, dtype, device)}

    def prefill(params, batch):
        """batch: exact-length tokens [B, S] (+ lens, max_len, unused by the
        state).  Returns (last-token logits [B, V], cache)."""
        lens = _lens(batch)
        x, parts = forward(params, batch, collect=True)
        return (_lm_head(params, _last(x, lens), cfg),
                {"pos": lens, "states": parts["states"]})

    def decode_step(params, cache, tokens):
        x = params["embed"][tokens.long()]
        new = []
        for p_l, st in zip(params["layers"], cache["states"]):
            x, st = blk.rwkv_block_step(p_l, x, cfg, st)
            new.append(st)
        return _lm_head(params, x, cfg), {"pos": cache["pos"] + 1,
                                          "states": new}

    def extend(params, cache, tokens, lens_new):
        """The new tokens [B, Sn] run in parallel from the stored state."""
        x, parts = forward(params, {"tokens": tokens}, collect=True,
                           init_state=cache["states"])
        return (_lm_head(params, _last(x, lens_new), cfg),
                {"pos": cache["pos"] + lens_new, "states": parts["states"]})

    def loss(params, batch):
        x, _ = forward(params, batch, collect=False, remat=True)
        return next_token_loss(_lm_head(params, x, cfg), batch["tokens"])

    return {"init": init, "forward": forward, "prefill": prefill,
            "decode_step": decode_step, "extend": extend,
            "init_cache": init_cache, "loss": loss, "family": "rwkv",
            "param_axes": lambda: {**_head_axes(), "layers": _stack_axes(
                blk.rwkv_block_axes(cfg), cfg.n_layers)}}


# ---------------- zamba2 (Mamba-2 + one shared attention block) ---------

def _zamba_groups(cfg) -> tuple[int, int, int]:
    """(groups, Mamba-2 layers per group, tail layers): the shared block
    runs after each group, not after the tail."""
    g = cfg.n_layers // cfg.attn_every
    return g, cfg.attn_every, cfg.n_layers - g * cfg.attn_every


def _zamba_zero_state(cfg, b: int, dtype, device) -> dict:
    """{"groups": [[(conv [B, 3, 2D], ssm [B, H, hd, ds] float32) per
    layer] per group], "tail": [per tail layer]}."""
    g, per, tail = _zamba_groups(cfg)
    di, h, ds = 2 * cfg.d_model, cfg.ssm_heads, cfg.ssm_state

    def layer():
        return (torch.zeros((b, 3, di), dtype=dtype, device=device),
                torch.zeros((b, h, di // h, ds), dtype=torch.float32,
                            device=device))

    return {"groups": [[layer() for _ in range(per)] for _ in range(g)],
            "tail": [layer() for _ in range(tail)]}


def _build_zamba(cfg):
    """The reference's ``family == "zamba"``: 13 × [6 Mamba-2 layers + the
    shared block] + 3 for zamba2-7b.  A cache is ``{"pos", "slot_pos"
    [B, M], "mamba": _zamba_zero_state's layout, "attn_k"/"attn_v": [per
    group [B, M, Hkv, hd]]}``.  As in the reference, ``extend`` raises."""
    dtype = getattr(torch, cfg.dtype)
    g, per, tail = _zamba_groups(cfg)

    def init(generator: torch.Generator) -> ParamTree:
        params = _embed_and_head(cfg, dtype, generator)
        mamba = lambda: blk.mamba_block_init(  # noqa: E731
            cfg, dtype, generator=generator)
        params["groups"] = [[mamba() for _ in range(per)] for _ in range(g)]
        if tail:
            params["tail"] = [mamba() for _ in range(tail)]
        params["shared"] = blk.shared_attn_init(cfg, dtype,
                                                generator=generator,
                                                n_groups=g)
        return ParamTree(params)

    def param_axes():
        mamba = blk.mamba_block_axes(cfg)
        ax = {**_head_axes(), "groups": [_stack_axes(mamba, per)] * g}
        if tail:
            ax["tail"] = _stack_axes(mamba, tail)
        ax["shared"] = blk.shared_attn_axes(cfg, g)
        return ax

    def _mamba_run(layers, x, states, step: bool):
        fn = blk.mamba_block_step if step else blk.mamba_block_parallel
        new = []
        for p_l, st in zip(layers, states):
            x, st = fn(p_l, x, cfg, st)
            new.append(st)
        return x, new

    def forward(params, batch, *, collect: bool, init_state=None,
                remat: bool = False):
        """Returns (x_final [B, S, D], {"mamba": states, "kv": [per group
        (k, v)]} or {}).  With ``remat`` each group (its Mamba-2 layers and
        the shared block) and each tail layer is checkpointed, as the
        reference checkpoints its group and tail bodies."""
        x = _embed(params, batch["tokens"])
        st = init_state if init_state is not None else _zamba_zero_state(
            cfg, x.shape[0], x.dtype, x.device)

        def group(p_g, lora_g, x, st_g):
            x, ms = _mamba_run(p_g, x, st_g, step=False)
            x, kv = blk.shared_attn_parallel(params["shared"], lora_g, x,
                                             cfg)
            return x, ms, kv

        group = _remat(group, remat)
        tail_layer = _remat(lambda p_l, x, st_l: blk.mamba_block_parallel(
            p_l, x, cfg, st_l), remat)
        groups, kvs = [], []
        for gi in range(g):
            x, ms, kv = group(params["groups"][gi],
                              params["shared"]["lora"][gi], x,
                              st["groups"][gi])
            groups.append(ms)
            kvs.append(kv)
        tail_st = []
        for p_l, st_l in zip(params["tail"] if tail else [], st["tail"]):
            x, st_l = tail_layer(p_l, x, st_l)
            tail_st.append(st_l)
        if not collect:
            return x, {}
        return x, {"mamba": {"groups": groups, "tail": tail_st}, "kv": kvs}

    def init_cache(b: int, max_len: int, device) -> dict:
        shape = (b, max_len, cfg.n_kv_heads, cfg.hd)
        return {"pos": torch.zeros((b,), dtype=torch.int32, device=device),
                "slot_pos": torch.full((b, max_len), -1, dtype=torch.int32,
                                       device=device),
                "mamba": _zamba_zero_state(cfg, b, dtype, device),
                "attn_k": [torch.zeros(shape, dtype=dtype, device=device)
                           for _ in range(g)],
                "attn_v": [torch.zeros(shape, dtype=dtype, device=device)
                           for _ in range(g)]}

    def prefill(params, batch):
        """batch: exact-length tokens [B, S] (+ lens, + max_len: the shared
        block's cache length).  Returns (last-token logits [B, V], cache)."""
        s = batch["tokens"].shape[1]
        lens = _lens(batch)
        max_len = int(batch.get("max_len", s))
        x, parts = forward(params, batch, collect=True)
        cache = {"pos": lens, "mamba": parts["mamba"], "attn_k": [],
                 "attn_v": []}
        for k, v in parts["kv"]:
            kc, vc, sp = attn.prefill_cache_layout(k, v, lens, max_len)
            cache["attn_k"].append(kc)
            cache["attn_v"].append(vc)
            cache["slot_pos"] = sp
        return _lm_head(params, _last(x, lens), cfg), cache

    def decode_step(params, cache, tokens):
        x = params["embed"][tokens.long()]
        pos = cache["pos"]
        groups, ks, vs = [], [], []
        sp = cache["slot_pos"]
        for gi in range(g):
            x, ms = _mamba_run(params["groups"][gi], x,
                               cache["mamba"]["groups"][gi], step=True)
            cl = {"k": cache["attn_k"][gi], "v": cache["attn_v"][gi],
                  "slot_pos": cache["slot_pos"], "pos": pos}
            x, nc = blk.shared_attn_decode(
                params["shared"], params["shared"]["lora"][gi], x, cl, cfg)
            groups.append(ms)
            ks.append(nc["k"])
            vs.append(nc["v"])
            sp = nc["slot_pos"]
        x, tail_st = _mamba_run(params["tail"] if tail else [], x,
                                cache["mamba"]["tail"], step=True)
        return _lm_head(params, x, cfg), {
            "pos": pos + 1, "slot_pos": sp, "attn_k": ks, "attn_v": vs,
            "mamba": {"groups": groups, "tail": tail_st}}

    def extend(params, cache, tokens, lens_new):
        # the reference's own gap, reproduced: its engine has no fallback
        raise NotImplementedError(
            "zamba2 extend: use prefill from scratch (engine falls back)")

    def loss(params, batch):
        x, _ = forward(params, batch, collect=False, remat=True)
        return next_token_loss(_lm_head(params, x, cfg), batch["tokens"])

    return {"init": init, "forward": forward, "prefill": prefill,
            "decode_step": decode_step, "extend": extend,
            "init_cache": init_cache, "loss": loss, "family": "zamba",
            "param_axes": param_axes}

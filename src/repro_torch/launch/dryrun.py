"""Dry run of the port: every (arch x shape x mesh) cell costed per card,
with nothing allocated (the reference's `repro.launch.dryrun`).

The reference lowers and compiles each cell on 256 (512) forced host
devices and reads XLA's memory and cost analyses.  The port traces each
cell under ``FakeTensorMode`` (tensors with shapes and dtypes, no
storage) on the plain path (its FLOPs, as the reference costs its jnp
forms and not its kernels; its bytes, the card's kernels' where it has
one), and counts:

  * parameter and AdamW bytes per card at full depth, from the leaves'
    shapes and the policy's placements (`distributed.sharding`); on a
    mesh above one card the split step's whole copies (`state_bytes`:
    the largest layer's leaves gathered in its forward and in its re-run
    and its whole gradient, the leaves read outside the layers whole all
    step, the vocab-sharded table and head never whole, a rank's kept
    experts whole over the other axes only, `distributed.param_gather`);
  * FLOPs (``FlopCounterMode``; a checkpointed layer's forward counted
    again, since the backward runs it again) over the per-card block;
  * the bytes the step moves per fused region (`launch/traffic.py`), as
    the reference reads XLA's ``bytes accessed`` of its fused step: each
    kernel op (attention, decode attention, the scans, their backwards)
    its kernel's own reads and writes (`kernels/work.py`), each
    elementwise chain once, a reduction reading the chain that feeds it,
    views and metadata queries nothing; a checkpointed layer's forward
    twice; for a train cell also the micro-batches' gradient sums and
    AdamW's update over the card's shards (`update_bytes`).  So
    ``roofline``'s memory term bounds the step as its compute term does;
  * for a train cell, the activation bytes the step keeps for the
    backward (``saved_tensors_hooks``): what the graph saves outside the
    checkpointed layers, each checkpoint's inputs, and the largest saved
    set of one layer, which its re-run holds during its backward; for a
    prefill or decode cell, the largest tensor the trace makes (these two
    largest figures a max over the variants, the rest extrapolated);
  * collective wire bytes per card from the placements (`utils.hlo`);
  * ``model_flops`` and, for a skipped cell, ``cell_supported``'s reason.

Per card means the block of the batch a card holds (the batch split over
its mesh axes by the policy).  A train cell whose sequence the training
rules split over ``model`` is traced as one rank of that split runs it
(`distributed.seq_parallel`: its block of each sequence, of the patches
and tokens together for a patch-input model, of the frames beside the
tokens for the encoder-decoder; the K/V, the cross K/V, MLA's latent,
the MoE's pair counts, the token shifts' rows and the scan states
crossing the ranks by emulated all-gathers; where the experts divide
over the split, the rank's experts over the gathered rows, its partial
outputs reduce-scattered back, `models.moe`), so its activations are the
ones a card holds, and its per-layer collectives are counted
(`split_halos`, `utils.hlo`).  Any other ``model`` axis above 1, which
the port's step does not run (serving is not tensor-parallel), is taken
as an even split of the block's work.  A full-depth trace of a long
sequence takes minutes on the plain path (the scans loop over chunks),
so each cell traces the reference's L = 1 / L = 2 variants
(`variant_plan`) and extrapolates: every counted quantity is affine in
the layer count, so the extrapolation is the full-depth trace's figure.

Records go to ``<out>/<arch>__<shape>__<mesh>.json`` in the reference's
layout, ``full`` holding the extrapolated full-depth figures.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all                # single pod
  python -m repro_torch.launch.dryrun --all --multi-pod    # 512 cards
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import (SHAPES, cell_supported, get_config,
                                 list_archs, model_flops, param_counts)
from repro_torch.distributed import seq_parallel
from repro_torch.distributed.sharding import (DECODE_PARAM_RULES,
                                              DECODE_RULES, TRAIN_PARAM_RULES,
                                              TRAIN_RULES, ShardingPolicy,
                                              axes_by_path, local_shape,
                                              mesh_shape, param_shardings,
                                              spec_axes)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.traffic import ByteCounter, kernel_regions
from repro_torch.models import build_model
from repro_torch.models.registry import (cache_axes, decode_state_specs,
                                         input_specs)
from repro_torch.models.scan_config import remat_probe
from repro_torch.training.loop import split_rows
from repro_torch.training.optimizer import (OptConfig, adamw_init,
                                            adamw_update)
from repro_torch.utils.hlo import collective_wire_bytes, step_collectives

TRAIN_ACCUM = 4        # the reference's micro-batches a train step
OPT_BYTES = 12         # AdamW: float32 master weights, m and v


def build_policy(mesh, kind: str, shape_name: str) -> ShardingPolicy:
    if kind == "train":
        acts, params = dict(TRAIN_RULES), dict(TRAIN_PARAM_RULES)
    else:
        acts, params = dict(DECODE_RULES), dict(DECODE_PARAM_RULES)
        if kind == "prefill":
            acts["seq"] = "model"  # sequence-parallel residual stream
        # long caches shard on sequence (8 KV heads can't divide 16)
        acts["cache_seq"] = "model"
        acts["kv_heads"] = None
    return ShardingPolicy(mesh, acts=acts, params=params)


def variant_plan(cfg) -> list[tuple[dict, float]]:
    """[(config overrides, coefficient)]; corrected = sum coeff * C(variant)."""
    if cfg.is_encdec:
        le, ld = cfg.enc_layers, cfg.n_layers
        return [({"enc_layers": 1, "n_layers": 1}, 1.0 - (le - 1) - (ld - 1)),
                ({"enc_layers": 2, "n_layers": 1}, float(le - 1)),
                ({"enc_layers": 1, "n_layers": 2}, float(ld - 1))]
    if cfg.attn_every:  # zamba: unit = group of attn_every mamba + shared attn
        g = cfg.n_layers // cfg.attn_every
        tail = cfg.n_layers - g * cfg.attn_every
        units = g + tail / cfg.attn_every  # tail ~ fractional group
        return [({"n_layers": cfg.attn_every}, 2.0 - units),
                ({"n_layers": 2 * cfg.attn_every}, units - 1.0)]
    lf = cfg.n_layers
    return [({"n_layers": 1}, 2.0 - lf), ({"n_layers": 2}, float(lf - 1))]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _storage(t):
    return t.untyped_storage()._cdata


class _SavedCounter:
    """Activation bytes a training trace keeps for the backward (see the
    module docstring), parameters left out; every saved tensor and each
    checkpoint's inputs also escape their region in ``counter``, and each
    checkpointed layer's forward is one the card runs again."""

    def __init__(self, params, flops, counter: ByteCounter):
        self.params = {_storage(p) for p in params}
        self.flops = flops
        self.counter = counter
        self.outer: dict = {}
        self.kept: dict = {}
        self.layer_peak = 0
        self.recompute_flops = 0

    def _pack_into(self, into: dict):
        def pack(t):
            key = _storage(t)
            if key not in self.params:
                into[key] = t.untyped_storage().nbytes()
            self.counter.keep(t)
            return t
        return pack

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(
            self._pack_into(self.outer), lambda t: t)

    def probe(self, fn, args):
        for t in pytree.tree_leaves(args):
            if isinstance(t, torch.Tensor) and _storage(t) not in self.params:
                self.kept[_storage(t)] = t.untyped_storage().nbytes()
        self.counter.keep(args)
        layer: dict = {}
        before = self.flops.get_total_flops()
        with torch.autograd.graph.saved_tensors_hooks(
                self._pack_into(layer), lambda t: t), self.counter.rerun():
            out = fn(*args)
        self.recompute_flops += self.flops.get_total_flops() - before
        self.layer_peak = max(self.layer_peak, sum(layer.values()))
        return out

    def kept_bytes(self) -> int:
        """What the step keeps through its whole backward."""
        return sum(self.outer.values()) + sum(self.kept.values())


def _fake_params(model):
    params = model.init(torch.Generator().manual_seed(0))
    return params, list(params.parameters())


def _batch_split(policy, shape, accum: int):
    """(per-card micro-batch rows, the mesh axes the batch is split over)."""
    rows = shape.global_batch // accum
    spec = policy.act_spec(("batch", "seq"), (rows, shape.seq_len))
    axes = spec_axes(spec)
    split = [a for a, d in axes.items() if d == 0]
    sizes = mesh_shape(policy.mesh)
    n = 1
    for a in split:
        n *= sizes[a]
    return max(rows // n, 1), split


def _seq_split(cfg, shape, policy, accum: int):
    """One rank's share of the sequence split a train cell's step makes
    (its collectives emulated: no group), or None.  A patch-input
    model's ``seq_len`` counts its patches (`input_specs`), the sequence
    its split cuts."""
    if shape.kind != "train":
        return None
    rows = shape.global_batch // accum
    spec = policy.act_spec(("batch", "seq"), (rows, shape.seq_len))
    sizes = mesh_shape(policy.mesh)
    m = 1
    for axis, dim in spec_axes(spec).items():
        if dim == 1:
            m *= sizes[axis]
    if m == 1:
        return None
    return seq_parallel.SeqSplit(None, 0, m, shape.seq_len // m)


def split_halos(cfg, rows: int, size: int,
                experts_kept: bool = False) -> tuple[int, dict[str, int],
                                                     dict[str, int]]:
    """What one rank's forward sends over a sequence split over ``size``
    ranks, layer by layer (`distributed.seq_parallel`), the MoE's token
    rows aside (`split_tokens`): (the attention
    layers, each gathering its K/V over the sequence, or MLA's latent
    (`split_kv_bytes`); {name: one rank's operand bytes} of the other
    gathers with a gradient: an RWKV-6 layer's two token shifts (a row of
    the residual stream each) and its WKV6 state with its decay; a
    Mamba-2 layer's conv rows (CONV_WIDTH - 1 of the inner stream) and its
    SSD state with its decay, in float32; an encoder layer's K/V and a
    decoder layer's cross K/V over its block of the frames; {name: one
    rank's operand bytes} of the gathers without a gradient: an MoE
    layer's pair counts per (row, expert), int64, where every rank holds
    every expert, none where ``experts_kept``)."""
    from repro_torch.models.ssm import CONV_WIDTH

    item = getattr(torch, cfg.dtype).itemsize
    d, h, ds = cfg.d_model, cfg.ssm_heads, cfg.ssm_state
    halos = {}
    if cfg.ssm_kind == "rwkv6":
        for i in range(cfg.n_layers):
            halos[f"rwkv{i}.shift_t"] = rows * d * item
            halos[f"rwkv{i}.state"] = rows * h * (ds * ds + ds) * 4
            halos[f"rwkv{i}.shift_c"] = rows * d * item
        return 0, halos, {}
    if cfg.ssm_kind == "mamba2":
        hd = 2 * d // h
        for i in range(cfg.n_layers):
            halos[f"mamba{i}.conv"] = rows * (CONV_WIDTH - 1) * 2 * d * item
            halos[f"mamba{i}.state"] = rows * h * (hd * ds + 1) * 4
        return cfg.n_layers // cfg.attn_every, halos, {}
    if cfg.is_encdec:
        frames = split_kv_bytes(cfg, rows, cfg.src_len) // size
        halos = {**{f"enc{i}.kv": frames for i in range(cfg.enc_layers)},
                 **{f"cross{i}.kv": frames for i in range(cfg.n_layers)}}
    counts = {} if experts_kept else {
        f"moe{i}.counts": rows * cfg.n_experts * 8 for i in _moe_layers(cfg)}
    return cfg.n_layers, halos, counts


def _moe_layers(cfg):
    return range(cfg.first_dense_layers, cfg.n_layers) if cfg.is_moe else ()


def split_tokens(cfg, rows: int, seq: int) -> dict[str, int]:
    """{name: a card's whole rows [rows, seq, d_model] in bytes} of each
    MoE layer, which gathers them to its rank's experts and
    reduce-scatters its partial outputs back where the ranks keep their
    experts (`models.moe`)."""
    whole = rows * seq * cfg.d_model * getattr(torch, cfg.dtype).itemsize
    return {f"moe{i}.rows": whole for i in _moe_layers(cfg)}


def kept_experts(policy, specs: dict, seq_axes) -> set:
    """The MoE expert leaves whose dim 0 the (one) mesh axis splitting
    the sequence shards (`ParamGather.expert_axis`): each rank keeps its
    experts and brings the rows' tokens to them (`models.moe`)."""
    from repro_torch.distributed.param_gather import EXPERT_LEAVES

    sizes = mesh_shape(policy.mesh)
    out = set()
    for name, spec in specs.items():
        parts = name.split(".")
        if parts[-2:-1] != ["moe"] or parts[-1] not in EXPERT_LEAVES:
            continue
        entry = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
        axes = [a for a in entry if a is not None and sizes[a] > 1]
        if len(axes) == 1 and axes[0] in seq_axes:
            out.add(name)
    return out


def split_kv_bytes(cfg, rows: int, seq: int) -> int:
    """The bytes an attention layer's gather makes whole on a card over a
    sequence split: K and V of every key, or MLA's latent (ckv and the
    rope key)."""
    width = (cfg.kv_lora_rank + cfg.qk_rope_dim if cfg.attn_kind == "mla"
             else cfg.n_kv_heads * 2 * cfg.hd)
    return rows * seq * width * getattr(torch, cfg.dtype).itemsize


def _fake_batch(cfg, shape, rows: int, split=None) -> dict:
    out = {}
    for name, spec in input_specs(cfg, shape).items():
        out[name] = torch.zeros((rows, *spec.shape[1:]), dtype=spec.dtype)
    if split is not None:          # a rank's block, as `training.loop` cuts
        out = split_rows(out, split.rank, split.size)[0]
    return out


def trace_cell(cfg, shape, policy, *, accum: int = TRAIN_ACCUM) -> dict:
    """One trace of ``cfg`` (any depth) at ``shape``'s per-card block
    under ``policy``, per card: {"flops", "bytes", "act", "peak"}.  For a
    train cell ``act`` is the bytes kept through the backward and
    ``peak`` the largest layer's saved set, and ``bytes`` holds the
    micro-batches' gradient sums and AdamW's update over the card's
    shards (`update_bytes`); for prefill and decode ``act`` is 0 and
    ``peak`` the largest tensor made.  All but ``peak`` are affine in the
    layer count; ``peak`` is a max over layers."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    model = build_model(cfg)
    kind = shape.kind
    accum = accum if kind == "train" else 1
    seq_split = _seq_split(cfg, shape, policy, accum)
    split = 1 if seq_split else mesh_shape(policy.mesh).get("model", 1)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params, leaves = _fake_params(model)
        rows, _ = _batch_split(policy, shape, accum)
        counter = ByteCounter()
        update = 0
        with FlopCounterMode(display=False) as flops:
            if kind == "train":
                for p in leaves:
                    p.requires_grad_(True)
                saved = _SavedCounter(leaves, flops, counter)
                batch = _fake_batch(cfg, shape, rows, seq_split)
                with counter, kernel_regions(counter), saved.hooks(), \
                        remat_probe(saved.probe), \
                        seq_parallel.split(seq_split):
                    loss = model.loss(params, batch)
                    counter.next_pass()
                    grads = torch.autograd.grad(loss, leaves)
                    counter.keep(loss, grads)
                act, peak = saved.kept_bytes(), saved.layer_peak
                extra = saved.recompute_flops
            elif kind == "prefill":
                batch = _fake_batch(cfg, shape, rows)
                with counter, kernel_regions(counter), torch.no_grad():
                    counter.keep(model.prefill(params, batch))
                act, peak, extra = 0, counter.largest, 0
            else:
                cache = model.init_cache(rows, shape.seq_len,
                                         torch.device("cpu"))
                tok = torch.zeros((rows,), dtype=torch.int32)
                with counter, kernel_regions(counter), torch.no_grad():
                    counter.keep(model.decode_step(params, cache, tok))
                act, peak, extra = 0, counter.largest, 0
            total = flops.get_total_flops() + extra
        if kind == "train":
            update = update_bytes(model, params, policy, accum)
    return {"flops": float(total * accum / split),
            "bytes": float(counter.bytes * accum / split + update),
            "act": float(act / split), "peak": float(peak / split)}


def update_bytes(model, params, policy, accum: int) -> int:
    """Bytes a train step moves after its micro-batches' backwards, over
    the card's shards of ``params`` (fake tensors): the gradient sums
    ``training.loop.loss_and_grads`` forms over ``accum`` micro-batches
    (each micro-batch's sum a pass of its own, as its forward and backward
    lie between) and ``training.optimizer.adamw_update`` (each leaf's
    in-place passes one region, the global norm one reduction)."""
    specs = param_shardings(policy, params, model.param_axes())
    leaves = [torch.empty(local_shape(policy.mesh, specs[n], tuple(p.shape)),
                          dtype=p.dtype)
              for n, p in params.named_parameters()]
    grads = [torch.empty_like(p) for p in leaves]
    state = adamw_init(leaves)
    counter = ByteCounter()
    with counter:
        if accum > 1:
            acc = [torch.zeros_like(p) for p in leaves]
            for i in range(accum):
                if i:
                    counter.next_pass()
                acc = [a + g for a, g in zip(acc, grads)]
            grads = [a * (1.0 / accum) for a in acc]
        _, new, stats = adamw_update(leaves, grads, state, OptConfig())
        counter.keep(new["step"], stats)
    return counter.bytes


def layer_unit(path: str):
    """The checkpointed layer a leaf (its dotted path) is gathered in, or
    None for a leaf read outside the layers: a stack's list element
    (``stack0.3``, ``layers.5``, ``encoder.2``; a zamba2 group ``groups.1``
    with its shared block's LoRA ``shared.lora.1``)."""
    parts = path.split(".")
    for i, part in enumerate(parts):
        if part.isdigit():
            if parts[:2] == ["shared", "lora"]:
                return f"groups.{part}"
            return ".".join(parts[:i + 1])
    return None


def vocab_axis(policy, spec):
    """The mesh axis above one card that shards the head's ``vocab`` dim
    (``spec`` its resolved spec), or None."""
    sizes = mesh_shape(policy.mesh)
    axes = spec[1] if len(spec) > 1 else None
    axes = axes if isinstance(axes, tuple) else (axes,)
    big = [a for a in axes if a is not None and sizes[a] > 1]
    return big[0] if big else None


def state_bytes(cfg, shape, policy, *, accum: int = TRAIN_ACCUM) -> dict:
    """Per-card bytes that follow from shapes and placements alone, at
    the config's full depth, and the step's collectives.  A train step on
    more than one card holds its shards and, whole, what its layers gather
    (`distributed.param_gather`): ``gathered`` is the largest layer's
    leaves less its shards twice (its forward copy and its re-run's) and
    the leaves read outside the layers (the norms, the frame projection,
    zamba2's shared block) less theirs, whole all step; ``grads`` the
    shards' gradients (twice with the accumulator) and, whole, the
    largest layer's and the outside leaves'.  The vocab-sharded table and
    head add no whole term, and an MoE expert leaf a rank keeps
    (`kept_experts`) only its copy gathered over the other axes.  On one
    card the gradients are the leaves' and nothing is gathered."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    model = build_model(cfg)
    kind = shape.kind
    with FakeTensorMode(allow_non_fake_inputs=True):
        params, _ = _fake_params(model)
        specs = param_shardings(policy, params, model.param_axes())
        named = dict(params.named_parameters())
        full = {n: _nbytes(p) for n, p in named.items()}
        n_local = {n: _numel(local_shape(policy.mesh, specs[n],
                                         tuple(p.shape)))
                   for n, p in named.items()}
        local = {n: n_local[n] * p.element_size() for n, p in named.items()}
        cache = 0
        if kind != "train":
            cspecs, _ = decode_state_specs(model, shape)
            axes = axes_by_path(cache_axes(model))
            for path, spec in _flat_specs(cspecs).items():
                s = policy.act_spec(axes[path], spec.shape)
                cache += _numel(local_shape(policy.mesh, s, spec.shape)) \
                    * spec.dtype.itemsize
    rows, batch_axes = _batch_split(policy, shape,
                                    accum if kind == "train" else 1)
    batch = 0
    for spec in input_specs(cfg, shape).values():
        batch += rows * _numel(spec.shape[1:]) * spec.dtype.itemsize
    p_local, p_full = sum(local.values()), sum(full.values())
    n_elems = sum(n_local.values())
    acc = 2 if accum > 1 else 1
    vaxis = vocab_axis(policy, specs["lm_head"])
    split = _seq_split(cfg, shape, policy, accum) if kind == "train" \
        else None
    seq_axes = ("model",) if split else ()
    kept = kept_experts(policy, specs, seq_axes)
    units: dict = {}
    outside = [0, 0]
    for n in named:
        if vaxis is not None and n in ("embed", "lm_head"):
            continue
        unit = layer_unit(n)
        into = outside if unit is None else units.setdefault(unit, [0, 0])
        # a kept expert leaf is gathered over the other axes only
        into[0] += full[n] // (split.size if n in kept else 1)
        into[1] += local[n]
    l_full, l_local = max(units.values(), default=[0, 0])
    many = _numel(mesh_shape(policy.mesh).values()) > 1
    out = {"params": p_local, "batch": batch, "cache": cache,
           "opt": n_elems * OPT_BYTES if kind == "train" else 0,
           "grads": 0, "gathered": 0}
    if kind == "train":
        out["grads"] = (p_local * acc + l_full + outside[0] if many
                        else p_full * acc)
        out["gathered"] = (2 * (l_full - l_local) + outside[0] - outside[1]
                           if many else 0)
    coll = []
    if kind == "train":
        attn_layers, halos, counts = split_halos(
            cfg, rows, split.size, bool(kept)) if split else (0, {}, {})
        vocab = None
        if vaxis is not None:
            positions = rows * shape.seq_len
            vocab = {"axis": vaxis, "leaves": ("embed", "lm_head"),
                     "rows": positions * cfg.d_model
                     * getattr(torch, cfg.dtype).itemsize,
                     "tokens": positions * 8, "stats": positions * 4}
        coll = step_collectives(
            policy.mesh, specs, full, batch_axes, seq_axes=seq_axes,
            attn_layers=attn_layers,
            kv_bytes=split_kv_bytes(cfg, rows, shape.seq_len), halos=halos,
            counts=counts,
            layer_leaves={n for n in named if layer_unit(n)}, vocab=vocab,
            experts={"axis": "model", "leaves": kept} if kept else None,
            tokens=split_tokens(cfg, rows, shape.seq_len) if kept else None)
    out["collectives"] = collective_wire_bytes(coll)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _flat_specs(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list) or (isinstance(tree, tuple)
                                    and not hasattr(tree, "_fields")):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat_specs(v, f"{prefix}{k}."))
    return out


def cost_cell(cfg, shape, mesh, *, accum: int = TRAIN_ACCUM) -> dict:
    """The record's figures for one supported cell (see `run_cell`)."""
    policy = build_policy(mesh, shape.kind, shape.name)
    state = state_bytes(cfg, shape, policy, accum=accum)
    vcosts = []
    for overrides, coeff in variant_plan(cfg):
        c = trace_cell(dataclasses.replace(cfg, **overrides), shape,
                       policy, accum=accum)
        vcosts.append({"overrides": overrides, "coeff": coeff, **c})
    rec: dict = {"variants": vcosts}
    cost = {k: sum(v["coeff"] * v[k] for v in vcosts)
            for k in ("flops", "bytes", "act")}
    cost["peak"] = max(v["peak"] for v in vcosts)   # the variants hold
    # every kind of layer the full depth has
    coll = state.pop("collectives")
    rec["state"] = state
    rec["full"] = {
        "flops": cost["flops"], "bytes": cost["bytes"], "collectives": coll,
        "memory": {"argument": state["params"] + state["opt"]
                   + state["batch"] + (state["cache"]
                                       if shape.kind == "decode" else 0),
                   "temp": (cost["act"] + cost["peak"] + state["grads"]
                            + state["gathered"]),
                   "output": state["cache"] if shape.kind != "train" else 0,
                   "alias": 0}}
    rec["full"]["memory"]["activations"] = cost["act"] + cost["peak"]
    rec["corrected"] = {"flops": cost["flops"], "bytes": cost["bytes"],
                        "coll": coll["total"]}
    return rec


def mesh_name(mesh) -> str:
    return "mesh" + "x".join(str(s) for s in mesh_shape(mesh).values())


def run_cell(arch: str, shape_name: str, mesh, *,
             out_dir: str = "artifacts/dryrun_torch", verbose: bool = True,
             cfg=None, shape=None, accum: int = TRAIN_ACCUM) -> dict:
    """Cost one cell and save its record; ``cfg`` / ``shape`` stand in
    for the registry's (a cut depth, a per-card batch)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    name = mesh_name(mesh)
    ok, reason = cell_supported(cfg, shape)
    chips = _numel(mesh_shape(mesh).values())
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": name,
                 "chips": chips, "kind": shape.kind, "supported": ok}
    if not ok:
        rec["skip_reason"] = reason
        _save(rec, out_dir)
        return rec
    counts = param_counts(cfg)
    rec["params_total"] = counts["total"]
    rec["params_active"] = counts["active"]
    rec["model_flops"] = model_flops(cfg, shape)
    rec["accum"] = accum if shape.kind == "train" else 1
    try:
        t0 = time.time()
        rec.update(cost_cell(cfg, shape, mesh, accum=accum))
        rec["trace_s"] = round(time.time() - t0, 1)
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug report
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    _save(rec, out_dir)
    if verbose:
        if rec.get("ok"):
            mem = rec["full"]["memory"]
            tot = (mem["argument"] + mem["temp"] + mem["output"]) / 1e9
            print(f"[dryrun] {arch:22s} {shape_name:12s} {name:10s} OK "
                  f"flops/dev={rec['full']['flops']:.2e} mem/dev={tot:.1f}GB "
                  f"coll/dev={rec['full']['collectives']['total']/1e9:.2f}GB "
                  f"({rec['trace_s']}s)", flush=True)
        elif not rec["supported"]:
            print(f"[dryrun] {arch:22s} {shape_name:12s} {name:10s} SKIP "
                  f"({rec['skip_reason'][:60]}...)", flush=True)
        else:
            print(f"[dryrun] {arch:22s} {shape_name:12s} {name:10s} FAIL "
                  f"{rec['error'][:160]}", flush=True)
    return rec


def _save(rec: dict, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)

    mesh = make_production_mesh(multi_pod=args.multi_pod, abstract=True)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    t0 = time.time()
    results = []
    for arch in archs:
        for shape_name in shapes:
            results.append(run_cell(arch, shape_name, mesh,
                                    out_dir=args.out))
    n_ok = sum(1 for r in results if r.get("ok"))
    n_skip = sum(1 for r in results if not r["supported"])
    n_fail = len(results) - n_ok - n_skip
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_fail} FAILED "
          f"in {time.time() - t0:.0f}s")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())

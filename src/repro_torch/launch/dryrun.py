"""Dry run of the port: every (arch x shape x mesh) cell costed per card,
with nothing allocated (the reference's `repro.launch.dryrun`).

The reference lowers and compiles each cell on 256 (512) forced host
devices and reads XLA's memory and cost analyses.  The port traces each
cell under ``FakeTensorMode`` (tensors with shapes and dtypes, no
storage) on the plain path, as the reference costs its jnp forms and not
its kernels, and counts:

  * parameter and AdamW bytes per card at full depth, from the leaves'
    shapes and the policy's placements (`distributed.sharding`);
  * FLOPs (``FlopCounterMode``; a checkpointed layer's forward counted
    again, since the backward runs it again) and the bytes each op reads
    and writes (views move nothing), over the per-card block: the plain
    path's unfused traffic, which the card's fused kernels undercut, so
    ``roofline``'s memory term is no bound;
  * for a train cell, the activation bytes the step keeps for the
    backward (``saved_tensors_hooks``): what the graph saves outside the
    checkpointed layers, each checkpoint's inputs, and the largest saved
    set of one layer, which its re-run holds during its backward; for a
    prefill or decode cell, the largest tensor the trace makes (these two
    largest figures a max over the variants, the rest extrapolated);
  * collective wire bytes per card from the placements (`utils.hlo`);
  * ``model_flops`` and, for a skipped cell, ``cell_supported``'s reason.

Per card means the block of the batch a card holds (the batch split over
its mesh axes by the policy).  A train cell of a dense GQA decoder whose
sequence the training rules split over ``model`` is traced as one rank of
that split runs it (`distributed.seq_parallel`: its block of each
sequence, the K/V gathered to the whole sequence by an emulated
all-gather), so its activations are the ones a card holds, and its
per-layer K/V collectives are counted (`utils.hlo`).  Any other ``model``
axis above 1, which the port's step does not run (the other families
cannot split a sequence yet; serving is not tensor-parallel), is taken
as an even split of the block's work.  A full-depth trace of a long sequence takes minutes on the
plain path (the scans loop over chunks), so each cell traces the
reference's L = 1 / L = 2 variants (`variant_plan`) and extrapolates:
every counted quantity is affine in the layer count, so the extrapolation
is the full-depth trace's figure.

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
from torch.utils._python_dispatch import TorchDispatchMode

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
from repro_torch.models import build_model
from repro_torch.models.registry import (cache_axes, decode_state_specs,
                                         input_specs)
from repro_torch.models.scan_config import remat_probe
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


class _ByteCounter(TorchDispatchMode):
    """Bytes every op reads and writes (its tensor arguments and
    results; views and metadata ops move nothing), and the largest
    tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func.overloadpacket in _FREE):
            ins = [t for t in pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            outs = [t for t in pytree.tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            if outs:
                self.largest = max(self.largest, *map(_nbytes, outs))
        return out


_FREE = {torch.ops.aten.detach, torch.ops.aten.alias}


class _SavedCounter:
    """Activation bytes a training trace keeps for the backward (see the
    module docstring), parameters left out."""

    def __init__(self, params, flops):
        self.params = {_storage(p) for p in params}
        self.flops = flops
        self.outer: dict = {}
        self.kept: dict = {}
        self.layer_peak = 0
        self.recompute_flops = 0

    def _pack_into(self, into: dict):
        def pack(t):
            key = _storage(t)
            if key not in self.params:
                into[key] = t.untyped_storage().nbytes()
            return t
        return pack

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(
            self._pack_into(self.outer), lambda t: t)

    def probe(self, fn, args):
        for t in pytree.tree_leaves(args):
            if isinstance(t, torch.Tensor) and _storage(t) not in self.params:
                self.kept[_storage(t)] = t.untyped_storage().nbytes()
        layer: dict = {}
        before = self.flops.get_total_flops()
        with torch.autograd.graph.saved_tensors_hooks(
                self._pack_into(layer), lambda t: t):
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
    (its collectives emulated: no group), or None."""
    if shape.kind != "train" or seq_parallel.unsupported(cfg):
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


def _fake_batch(cfg, shape, rows: int, split=None) -> dict:
    out = {}
    for name, spec in input_specs(cfg, shape).items():
        out[name] = torch.zeros((rows, *spec.shape[1:]), dtype=spec.dtype)
    if split is not None:          # a rank's block, as `training.loop` cuts
        tokens = out["tokens"][:, :split.s_local]
        out = {"tokens": tokens, "targets": torch.zeros_like(tokens),
               "target_count": torch.zeros((rows,), dtype=torch.int64)}
    return out


def trace_cell(cfg, shape, policy, *, accum: int = TRAIN_ACCUM) -> dict:
    """One trace of ``cfg`` (any depth) at ``shape``'s per-card block
    under ``policy``, per card: {"flops", "bytes", "act", "peak"}.  For a
    train cell ``act`` is the bytes kept through the backward and
    ``peak`` the largest layer's saved set; for prefill and decode
    ``act`` is 0 and ``peak`` the largest tensor made.  All but ``peak``
    are affine in the layer count; ``peak`` is a max over layers."""
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
        counter = _ByteCounter()
        with FlopCounterMode(display=False) as flops:
            if kind == "train":
                for p in leaves:
                    p.requires_grad_(True)
                saved = _SavedCounter(leaves, flops)
                batch = _fake_batch(cfg, shape, rows, seq_split)
                with counter, saved.hooks(), remat_probe(saved.probe), \
                        seq_parallel.split(seq_split):
                    loss = model.loss(params, batch)
                    torch.autograd.grad(loss, leaves)
                act, peak = saved.kept_bytes(), saved.layer_peak
                extra = saved.recompute_flops
            elif kind == "prefill":
                batch = _fake_batch(cfg, shape, rows)
                with counter, torch.no_grad():
                    model.prefill(params, batch)
                act, peak, extra = 0, counter.largest, 0
            else:
                cache = model.init_cache(rows, shape.seq_len,
                                         torch.device("cpu"))
                tok = torch.zeros((rows,), dtype=torch.int32)
                with counter, torch.no_grad():
                    model.decode_step(params, cache, tok)
                act, peak, extra = 0, counter.largest, 0
            total = flops.get_total_flops() + extra
    return {"flops": float(total * accum / split),
            "bytes": float(counter.bytes * accum / split),
            "act": float(act / split), "peak": float(peak / split)}


def state_bytes(cfg, shape, policy, *, accum: int = TRAIN_ACCUM) -> dict:
    """Per-card bytes that follow from shapes and placements alone, at
    the config's full depth, and the step's collectives."""
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
    out = {"params": p_local, "batch": batch, "cache": cache,
           "opt": n_elems * OPT_BYTES if kind == "train" else 0,
           "grads": p_full * (2 if accum > 1 else 1) if kind == "train"
           else 0,
           "gathered": p_full - p_local if kind == "train" else 0}
    coll = []
    if kind == "train":
        split = _seq_split(cfg, shape, policy, accum)
        kv = (rows * shape.seq_len * cfg.n_kv_heads * 2 * cfg.hd
              * getattr(torch, cfg.dtype).itemsize)
        coll = step_collectives(
            policy.mesh, specs, full, batch_axes,
            seq_axes=("model",) if split else (),
            attn_layers=cfg.n_layers if split else 0, kv_bytes=kv)
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

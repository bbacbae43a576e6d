"""Layer-loop control for the dry run's cost method (the reference's
`repro.models.scan_config`), and the models' activation checkpoint.

The reference drives its stacked layers with ``lax.scan``, whose body
XLA's cost analysis counts once whatever the trip count, so its dry run
compiles unrolled L = 1 / L = 2 variants under ``unrolled()`` and
extrapolates.  The port's models walk per-layer lists in Python loops, so
every layer is traced and counted; the functions below keep the
reference's signatures as plain loops over a leading axis (``xs`` a tensor
or a pytree of tensors), always unrolled, so ``unrolled()`` changes
nothing.  The dry run (`repro_torch.launch.dryrun`) still traces the
L = 1 / L = 2 variants and extrapolates: a full-depth trace of a long
sequence on the plain path takes minutes a cell.

``checkpointed(fn)`` is the activation checkpoint the models' ``loss``
wraps each layer in (non-reentrant ``torch.utils.checkpoint``, so closures
over parameters get their gradients).  Under ``remat_probe(probe)`` it
calls ``probe(fn, args)`` instead: the dry run sees there what each
checkpoint keeps (its inputs) and what the layer saves when the backward
runs it again.

``chunk_scan_checkpointed`` is the reference's recursive checkpoint of a
chunked scan, which the scans' CPU route under grad runs
(`kernels/wkv6.wkv6_checkpointed`, `kernels/ssd.ssd_checkpointed`): each
segment of 16 chunk steps is a `torch.autograd.Function` that saves its
inputs as ordinary saved tensors, so inside a checkpointed layer the dry
run's probe counts each segment's inputs once, and its backward's
recompute runs under identity hooks that no outer hook sees.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

_REMAT_PROBE = None


@contextlib.contextmanager
def unrolled():
    """The reference's switch to unrolled layer scans; the port's loops
    are unrolled already."""
    yield


def _stack(ys: list):
    if not ys or ys[0] is None:
        return None
    return pytree.tree_map(lambda *t: torch.stack(t), *ys)


def layer_scan(f, init, xs, length=None):
    """``carry, y = f(carry, x)`` over the leading axis of ``xs`` (or
    ``length`` times with ``xs`` None) -> (carry, the ys stacked)."""
    n = length if xs is None else pytree.tree_leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in range(n):
        x = None if xs is None else pytree.tree_map(lambda t: t[i], xs)
        carry, y = f(carry, x)
        ys.append(y)
    return carry, _stack(ys)


def indexed_layer_loop(n: int, body, carry):
    """``carry = body(l, carry)`` for l in 0..n-1, the full state as the
    carry (the reference's ``fori_loop``)."""
    for i in range(n):
        carry = body(i, carry)
    return carry


class _Segment(torch.autograd.Function):
    """``layer_scan(step, state, xs)`` over one segment, keeping for the
    backward only its inputs (the incoming state and the segment's
    operands, saved as autograd saved tensors, so saved-tensor hooks
    such as the dry run's see them) and running the segment again in the
    backward.  ``step`` may close over constants only: a tensor that
    needs a gradient enters as an input."""

    @staticmethod
    def forward(ctx, step, specs, n_state, *flat):
        ctx.step, ctx.specs, ctx.n_state = step, specs, n_state
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*flat)
        final, ys = _run_segment(step, specs, n_state, flat)
        return (*final, *ys)

    @staticmethod
    def backward(ctx, *grads):
        flat = ctx.saved_tensors
        needs = ctx.needs_input_grad[3:]
        # the segment again, its saves kept from any outer hooks: this
        # recompute lives only inside this backward
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                lambda t: t, lambda t: t):
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(flat, needs)]
            final, ys = _run_segment(ctx.step, ctx.specs, ctx.n_state,
                                     leaves)
            pairs = [(o, g) for o, g in zip((*final, *ys), grads)
                     if g is not None and o.requires_grad]
            wanted = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], wanted, [g for _, g in pairs],
                allow_unused=True) if pairs and wanted else ())
        return (None, None, None,
                *(next(got, None) if need else None for need in needs))


def _run_segment(step, specs, n_state, flat):
    """(the final state's leaves, the stacked ys' leaves) of
    ``layer_scan(step, state, xs)`` over the flat leaves of (state, xs);
    ``specs`` is (the state's structure, the xs', a dict that receives the
    ys' under "ys")."""
    state_spec, xs_spec, out = specs
    state = pytree.tree_unflatten(list(flat[:n_state]), state_spec)
    xs = pytree.tree_unflatten(list(flat[n_state:]), xs_spec)
    final, ys = layer_scan(step, state, xs)
    leaves, out["ys"] = pytree.tree_flatten(ys)
    return pytree.tree_leaves(final), leaves


def chunk_scan_checkpointed(step, init, xs, n: int, super_size: int = 16):
    """``layer_scan(step, init, xs)`` over ``n`` chunk steps, keeping for
    the backward only every ``super_size``-th state: each segment of
    ``super_size`` steps keeps its inputs and runs again in the backward
    (`_Segment`), as the reference's ``jax.checkpoint`` of each super-step.
    As in the reference, a scan shorter than two segments or of a ragged
    length runs plain.  ``step`` may close over constants only (a tensor
    that needs a gradient enters through ``xs`` or ``init``)."""
    if n < 2 * super_size or n % super_size != 0:
        return layer_scan(step, init, xs)
    leaves, spec = pytree.tree_flatten(xs)
    state, init_spec = pytree.tree_flatten(init)
    specs = (init_spec, spec, {})
    outs = []
    for s in range(0, n, super_size):
        seg = [t[s:s + super_size] for t in leaves]
        out = _Segment.apply(step, specs, len(state), *state, *seg)
        out = out if isinstance(out, tuple) else (out,)
        state = list(out[:len(state)])
        outs.append(out[len(state):])
    ys = [torch.cat(t) for t in zip(*outs)]
    return (pytree.tree_unflatten(state, init_spec),
            pytree.tree_unflatten(ys, specs[2]["ys"]))


@contextlib.contextmanager
def remat_probe(probe):
    """Route every ``checkpointed`` call to ``probe(fn, args)``."""
    global _REMAT_PROBE
    prev = _REMAT_PROBE
    _REMAT_PROBE = probe
    try:
        yield
    finally:
        _REMAT_PROBE = prev


def checkpointed(fn):
    """``fn`` under activation checkpointing: its forward keeps only its
    inputs and runs again in the backward."""
    def run(*args):
        if _REMAT_PROBE is not None:
            return _REMAT_PROBE(fn, args)
        return checkpoint(fn, *args, use_reentrant=False)
    return run

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


def chunk_scan_checkpointed(step, init, xs, n: int, super_size: int = 16):
    """``layer_scan(step, init, xs)`` over ``n`` chunk steps, keeping for
    the backward only every ``super_size``-th state: each segment of
    ``super_size`` steps runs under a checkpoint and is recomputed in the
    backward.  As in the reference, a scan shorter than two segments or
    of a ragged length runs plain."""
    if n < 2 * super_size or n % super_size != 0:
        return layer_scan(step, init, xs)
    leaves, spec = pytree.tree_flatten(xs)
    n_init = len(pytree.tree_leaves(init))
    init_spec = pytree.tree_structure(init)

    def segment(*flat):
        state = pytree.tree_unflatten(list(flat[:n_init]), init_spec)
        seg = pytree.tree_unflatten(list(flat[n_init:]), spec)
        final, ys = layer_scan(step, state, seg)
        return pytree.tree_leaves(final), ys

    state, ys = init, []
    for s in range(0, n, super_size):
        seg = [t[s:s + super_size] for t in leaves]
        final, y = checkpoint(segment, *pytree.tree_leaves(state), *seg,
                              use_reentrant=False)
        state = pytree.tree_unflatten(final, init_spec)
        ys.append(y)
    if ys[0] is None:
        return state, None
    return state, pytree.tree_map(lambda *t: torch.cat(t), *ys)


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

"""Training loop: gradient accumulation, compression, checkpoint/restart
(the reference's `repro.training.loop`).

``make_train_step`` builds the step: the model's ``loss`` and its gradient
by PyTorch's autograd (on the card the gradients of the attention and of
the WKV6 and SSD scans are hand-written backward kernels,
`kernels/ops.py`), optional compression, then
AdamW; ``train_loop`` adds the fault-tolerance shell (periodic atomic
checkpoints, resume-from-latest, an optional injected crash for tests).
The reference jits its step and donates its buffers; here the step runs
eagerly and updates the parameters and the optimizer's state in place.

Under a sharding policy (``apply_policy``, as the reference's launcher
sets one over several devices) the loop is data-parallel over the mesh,
one card a rank (`place_state`, `make_train_step(policy=...)`): the
parameters and AdamW's moments and master weights are DTensors placed by
the policy's parameter rules (FSDP: the ``embed`` dim over ``data``);
each step gathers the parameters whole (``full_tensor``), runs the model,
its kernels and their backward kernels on plain local tensors and on this
rank's rows of the batch (split over ``data`` by the activation rules),
reduces each gradient onto its parameter's placement (a mean over the
batch's ranks: a reduce-scatter where the parameter is sharded) and
updates each shard in place, the clipping norm taken over the whole
gradient.  The loss is the mean of the ranks' losses, which is the global
batch's when every rank's rows hold as many targets (as synthetic batches
do).  On a mesh of one card every placement is ``Replicate`` and the run
is the plain loop's bit for bit.  A ``model`` axis above 1 (tensor
parallelism) raises: it is not ported.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch.training.checkpoint import (latest_step, restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.compress import (CompressionConfig,
                                           compress_with_feedback,
                                           init_feedback)
from repro_torch.training.optimizer import (OptConfig, adamw_init,
                                            adamw_update)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

TENSOR_PARALLEL_TODO = ("a mesh whose model axis is above 1 needs tensor "
                        "parallelism through the hand-written kernels, "
                        "which the port has not yet (ROADMAP.md, queue 1, "
                        "'Tensor parallelism')")


def loss_and_grads(model, params, batch: dict, accum_steps: int = 1):
    """(loss, grads): the model's loss on ``batch`` and its gradient, a
    tree of ``params``' structure; every parameter must require grad.
    With ``accum_steps`` > 1 the batch's leading axis is split into that
    many micro-batches, run one after another, whose losses and gradients
    are summed and scaled by 1 / accum_steps, in the reference's order."""
    leaves = tree_leaves(params)

    def value_and_grad(b):
        loss = model.loss(params, b)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    if accum_steps == 1:
        loss, grads = value_and_grad(batch)
        return loss, tree_unflatten(params, grads)
    n = next(iter(batch.values())).shape[0] // accum_steps
    loss_acc, g_acc = 0.0, [torch.zeros_like(p) for p in leaves]
    for i in range(accum_steps):
        loss, grads = value_and_grad({k: v[i * n:(i + 1) * n]
                                      for k, v in batch.items()})
        loss_acc = loss_acc + loss
        g_acc = [a + g for a, g in zip(g_acc, grads)]
    scale = 1.0 / accum_steps
    return loss_acc * scale, tree_unflatten(params, [g * scale
                                                     for g in g_acc])


def _batch_specs(policy, batch: dict) -> dict:
    """{input name: its spec} under the policy's activation rules."""
    axes = {"tokens": ("batch", "seq"), "patches": ("batch", "patches",
                                                    "embed"),
            "frames": ("batch", "src_seq", "embed")}
    return {k: policy.act_spec(axes[k], tuple(v.shape))
            for k, v in batch.items()}


def place_state(model, policy, params, opt_state):
    """(params, opt_state) placed on the policy's mesh as DTensors (see
    the module docstring); the step counter and compression's feedback
    stay plain."""
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.distributed.sharding import mesh_shape

    if mesh_shape(policy.mesh).get("model", 1) > 1:
        raise ValueError(TENSOR_PARALLEL_TODO)
    axes = model.param_axes()

    def place(tree):
        return reshard_state(tree, axes, policy.mesh, policy.acts,
                             policy.params)

    adam = opt_state["adam"]
    placed = {"adam": {"master": place(adam["master"]), "m": place(adam["m"]),
                       "v": place(adam["v"]), "step": adam["step"]}}
    if "feedback" in opt_state:
        placed["feedback"] = opt_state["feedback"]
    return place(params), placed


def gathered(tree):
    """A placed tree's leaves whole (``full_tensor``); plain ones as
    they are."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                    else x, tree)


def _local(tree):
    """Each DTensor leaf's local shard (its storage, so in-place updates
    write the placed tensor)."""
    return tree_map(lambda x: x.to_local(), tree)


def _placed_step(model, opt_cfg, compression, accum_steps, policy):
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.distributed.sharding import local_block, mesh_shape
    from repro_torch.utils.tree import tree_global_norm

    mesh = policy.mesh
    sizes = mesh_shape(mesh)
    compress = compression is not None and compression.enabled

    def reduce(t, axes, to):
        """``t`` (this rank's share) averaged over the mesh axes ``axes``
        and placed as ``to``; no collective over an axis of one card."""
        src = tuple(Partial("avg") if a in axes and n > 1 else Replicate()
                    for a, n in sizes.items())
        return DTensor.from_local(t, mesh, src).redistribute(mesh, to)

    def train_step(params, opt_state, batch):
        specs = _batch_specs(policy, batch)
        axes = {a for s in specs.values() for e in s[:1]
                for a in (e if isinstance(e, tuple) else (e,)) if a}
        local = {k: local_block(v, mesh, specs[k]) for k, v in batch.items()}
        full = gathered(params)
        for p in tree_leaves(full):
            p.requires_grad_(True)
        loss, grads = loss_and_grads(model, full, local, accum_steps)
        rep = (Replicate(),) * len(sizes)
        loss = reduce(loss, axes, rep).to_local()
        placed = tree_leaves(params)
        if compress:
            grads = tree_unflatten(full, [reduce(g, axes, rep).to_local()
                                          for g in tree_leaves(grads)])
            grads, fb = compress_with_feedback(grads, opt_state["feedback"],
                                               compression)
            axes = set()
        grads = [reduce(g, axes, p.placements)
                 for g, p in zip(tree_leaves(grads), placed)]
        gnorm = tree_global_norm(grads).full_tensor()
        adam = opt_state["adam"]
        local_adam = {"master": _local(adam["master"]), "m": _local(adam["m"]),
                      "v": _local(adam["v"]), "step": adam["step"]}
        _, new_opt, stats = adamw_update(
            _local(params), [g.to_local() for g in grads], local_adam,
            opt_cfg, grad_norm=gnorm)
        out_state = {"adam": {**adam, "step": new_opt["step"]}}
        if compress:
            out_state["feedback"] = fb
        elif "feedback" in opt_state:
            out_state["feedback"] = opt_state["feedback"]
        return params, out_state, {"loss": loss, **stats}

    return train_step


def make_train_step(model, opt_cfg: OptConfig,
                    compression: CompressionConfig | None = None,
                    accum_steps: int = 1, policy=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), ``metrics`` holding ``loss``, ``grad_norm`` and ``lr`` (0-d
    float32 tensors on the parameters' device).  The parameters (which must
    require grad) and the state are updated in place.  With a ``policy``
    the step takes `place_state`'s placed state and every rank's whole
    batch (the module docstring says what it runs)."""
    if policy is not None:
        return _placed_step(model, opt_cfg, compression, accum_steps, policy)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model, params, batch, accum_steps)
        compress = compression is not None and compression.enabled
        if compress:
            grads, fb = compress_with_feedback(grads, opt_state["feedback"],
                                               compression)
        new_params, new_opt, stats = adamw_update(params, grads,
                                                  opt_state["adam"], opt_cfg)
        out_state = {"adam": new_opt}
        if compress:
            out_state["feedback"] = fb
        elif "feedback" in opt_state:
            out_state["feedback"] = opt_state["feedback"]
        return new_params, out_state, {"loss": loss, **stats}

    return train_step


def init_opt_state(params, compression: CompressionConfig | None = None):
    state = {"adam": adamw_init(params)}
    if compression is not None and compression.enabled:
        state["feedback"] = init_feedback(params)
    return state


def train_loop(model, data, *, steps: int, opt_cfg: OptConfig | None = None,
               compression: CompressionConfig | None = None,
               accum_steps: int = 1, ckpt_dir: str | None = None,
               ckpt_every: int = 50, resume: bool = True, seed: int = 0,
               crash_at_step: int | None = None, log_every: int = 10,
               donate: bool = True, device="cuda") -> dict:
    """Run (or resume) training on ``device`` (CUDA unless the caller asks
    for the CPU; a missing card raises); returns {losses, grad_norms,
    final_step, params, opt_state, wall_s}, ``losses`` and ``grad_norms``
    as (step, value) every ``log_every`` steps and at the last.

    The parameters come from ``model.init`` on a generator of ``device``
    seeded with ``seed``, or from the latest checkpoint in ``ckpt_dir``.
    ``data.batch_at(step)`` gives each step's batch (NumPy arrays or
    tensors).  ``crash_at_step`` raises after that step's checkpoint
    window, to prove bitwise-identical resume.  ``donate`` is the
    reference's buffer donation: the port's step updates in place either
    way.  Under an active sharding policy (``apply_policy``) the state is
    placed on its mesh and the loop runs data-parallel (the module
    docstring); the returned params and state are then DTensors
    (`gathered` makes them whole), and rank 0 writes the checkpoints.
    """
    from repro_torch.distributed.sharding import current_policy

    del donate
    dev = resolve_device(device)
    policy = current_policy()
    opt_cfg = opt_cfg or OptConfig(total_steps=steps)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    opt_state = init_opt_state(params, compression)
    start = 0
    if ckpt_dir and resume:
        last = latest_step(ckpt_dir)
        if last is not None:
            (params, opt_state), _, start = restore_checkpoint(
                ckpt_dir, last, (params, opt_state))
    if policy is None:
        for p in tree_leaves(params):
            p.requires_grad_(True)
    else:
        params, opt_state = place_state(model, policy, params, opt_state)

    step_fn = make_train_step(model, opt_cfg, compression, accum_steps,
                              policy)
    losses, grad_norms = [], []
    t0 = time.perf_counter()
    for step in range(start, steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch_at(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == steps - 1:
            losses.append((step, float(metrics["loss"])))
            grad_norms.append((step, float(metrics["grad_norm"])))
        if ckpt_dir and ((step + 1) % ckpt_every == 0 or step == steps - 1):
            _save(ckpt_dir, step + 1, params, opt_state,
                  float(metrics["loss"]), policy)
        if crash_at_step is not None and step + 1 >= crash_at_step:
            raise RuntimeError(f"injected crash after step {step + 1}")
    return {"losses": losses, "grad_norms": grad_norms,
            "final_step": steps, "params": params,
            "opt_state": opt_state,
            "wall_s": time.perf_counter() - t0}


def _save(ckpt_dir, step, params, opt_state, loss, policy):
    if policy is None:
        save_checkpoint(ckpt_dir, step, (params, opt_state), {"loss": loss})
        return
    whole = (gathered(params), {k: (gathered(v) if k == "adam" else v)
                                for k, v in opt_state.items()})
    if dist.get_rank() == 0:
        save_checkpoint(ckpt_dir, step, whole, {"loss": loss})
    dist.barrier()

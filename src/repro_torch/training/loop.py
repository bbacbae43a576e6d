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
"""
from __future__ import annotations

import time

import torch

from repro_torch.training.checkpoint import (latest_step, restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.compress import (CompressionConfig,
                                           compress_with_feedback,
                                           init_feedback)
from repro_torch.training.optimizer import (OptConfig, adamw_init,
                                            adamw_update)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves, tree_unflatten


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


def make_train_step(model, opt_cfg: OptConfig,
                    compression: CompressionConfig | None = None,
                    accum_steps: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), ``metrics`` holding ``loss``, ``grad_norm`` and ``lr`` (0-d
    float32 tensors on the parameters' device).  The parameters (which must
    require grad) and the state are updated in place."""

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
    for the CPU; a missing card raises); returns {losses, final_step,
    params, opt_state, wall_s}.

    The parameters come from ``model.init`` on a generator of ``device``
    seeded with ``seed``, or from the latest checkpoint in ``ckpt_dir``.
    ``data.batch_at(step)`` gives each step's batch (NumPy arrays or
    tensors).  ``crash_at_step`` raises after that step's checkpoint
    window, to prove bitwise-identical resume.  ``donate`` is the
    reference's buffer donation: the port's step updates in place either
    way.
    """
    del donate
    dev = resolve_device(device)
    opt_cfg = opt_cfg or OptConfig(total_steps=steps)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    opt_state = init_opt_state(params, compression)
    start = 0
    if ckpt_dir and resume:
        last = latest_step(ckpt_dir)
        if last is not None:
            (params, opt_state), _, start = restore_checkpoint(
                ckpt_dir, last, (params, opt_state))
    for p in tree_leaves(params):
        p.requires_grad_(True)

    step_fn = make_train_step(model, opt_cfg, compression, accum_steps)
    losses = []
    t0 = time.perf_counter()
    for step in range(start, steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch_at(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == steps - 1:
            losses.append((step, float(metrics["loss"])))
        if ckpt_dir and ((step + 1) % ckpt_every == 0 or step == steps - 1):
            save_checkpoint(ckpt_dir, step + 1, (params, opt_state),
                            {"loss": float(metrics["loss"])})
        if crash_at_step is not None and step + 1 >= crash_at_step:
            raise RuntimeError(f"injected crash after step {step + 1}")
    return {"losses": losses, "final_step": steps, "params": params,
            "opt_state": opt_state,
            "wall_s": time.perf_counter() - t0}

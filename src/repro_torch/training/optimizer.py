"""AdamW over the port's parameter trees (the reference's
`repro.training.optimizer`, no ``torch.optim``): float32 master weights and
moments, and the reference's exact update.

The state mirrors the parameter tree (`utils/tree.py`): ``{"master",
"m", "v"}`` are trees of float32 tensors of the parameters' structure and
``"step"`` an int32 scalar.  The reference's arrays are immutable and its
step donates them; here ``adamw_update`` writes the moments, the master
weights and the parameters in place (a fresh copy of each would double the
optimizer's memory at full width), with two float32 temporaries of one
leaf at a time, in the reference's order of operations.  The learning
rate, the clip scale and the bias corrections are float32 tensors, as in
the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.utils.tree import (tree_global_norm, tree_leaves, tree_map,
                                    tree_zeros_like_f32)


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def lr_schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine to 0 at ``total_steps``;
    ``step`` an int or an integer tensor, the result float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * (step + 1) / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * 0.5 * (1.0 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params) -> dict:
    # a copy: the master weights must never alias the parameters, which
    # ``.to(torch.float32)`` would return as they are for a float32 model
    def master(p):
        return p.detach().to(torch.float32, copy=True)

    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return {"master": tree_map(master, params),
            "m": tree_zeros_like_f32(params),
            "v": tree_zeros_like_f32(params),
            "step": step}


@torch.no_grad()
def adamw_update(params, grads, opt_state: dict, cfg: OptConfig,
                 grad_norm: torch.Tensor | None = None):
    """One AdamW step with global-norm clipping.  ``grads`` is a tree (or
    the list of leaves) in the parameters' order.  Writes the moments, the
    master weights and ``params`` (cast to each parameter's dtype) in
    place; returns (params, the new state, {"grad_norm", "lr"}).  A caller
    holding each leaf's shard passes the whole gradient's ``grad_norm``."""
    step = opt_state["step"]
    lr = lr_schedule(cfg, step)
    gnorm = tree_global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.minimum(torch.ones_like(gnorm),
                          cfg.grad_clip / torch.clamp(gnorm, min=1e-9))
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32) + 1.0
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)

    for p, g, m, v, w in zip(tree_leaves(params), tree_leaves(grads),
                             tree_leaves(opt_state["m"]),
                             tree_leaves(opt_state["v"]),
                             tree_leaves(opt_state["master"])):
        g = g.to(torch.float32, copy=True).mul_(scale)
        t = g * (1 - b1)
        m.mul_(b1).add_(t)                            # b1·m + (1-b1)·g
        torch.mul(g, 1 - b2, out=t)
        v.mul_(b2).add_(t.mul_(g))                    # b2·v + (1-b2)·g·g
        torch.div(m, bc1, out=g)                      # mhat
        torch.div(v, bc2, out=t).sqrt_().add_(cfg.eps)
        g.div_(t)                                     # mhat/(sqrt(vhat)+eps)
        torch.mul(w, cfg.weight_decay, out=t)
        w.sub_(g.add_(t).mul_(lr))
        p.copy_(w)
    new_state = {"master": opt_state["master"], "m": opt_state["m"],
                 "v": opt_state["v"], "step": step + 1}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}

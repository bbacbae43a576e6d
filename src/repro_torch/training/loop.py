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
sets one over several devices) the loop runs over the policy's mesh, one
card a rank (`place_state`, `make_train_step(policy=...)`): the
parameters and AdamW's moments and master weights are DTensors placed by
the policy's parameter rules (``TRAIN_PARAM_RULES``: ``embed`` over
``data``, ``heads``, ``kv_heads``, ``ff``, ``vocab`` and ``expert`` over
``model``). Each step splits the batch by its resolved ``("batch",
"seq")`` spec (the rows over ``data``; under ``TRAIN_RULES`` each
sequence over ``model``, `distributed/seq_parallel.py`) and hands the
model the rank's local shards under a parameter binding
(`distributed/param_gather.py`): each checkpointed layer gathers its
leaves whole where it runs, in the forward and again in its re-run, and
its gradient is reduced to the rank's shards when autograd reaches the
gather: a sum over the mesh axes that split ``seq`` (each rank's part of
the loss is its rows'), a mean over those that split ``batch``, a
reduce-scatter over an axis that both reduces and shards the leaf. The
embedding and the head stay vocab-sharded over ``model``, and the loss
is then the whole sequence's on every ``model`` rank, so only the
batch's axes reduce it. Where the divisibility fallback leaves ``seq``
whole, the ``model`` ranks compute the same thing and only the batch's
axes reduce. The gradients of ``torch.autograd.grad`` with respect to
the shards come out reduced; each shard is updated in place, and the
clipping norm is taken over the whole gradient. Under compression the
gradients are gathered whole for it (its feedback is whole) and cut back
after. The collectives are `seq_parallel`'s, which run on NCCL and on
gloo (on the CPU, and on CUDA tensors for ranks that share a card). The
loss is the mean of the batch ranks' losses, which is the global batch's
when every rank's rows hold as many targets (as synthetic batches do).
On a mesh of one card every placement is ``Replicate``, no binding is
made, and the run is the plain loop's bit for bit. A ``model`` axis
above 1 takes every architecture: the MoE models' experts are placed
over ``model`` and gathered with their layer; a patch-input model's
split is of its patches and tokens together, an encoder-decoder's of its
frames beside its tokens (`split_rows`).
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch.distributed import param_gather, seq_parallel
from repro_torch.training.checkpoint import (latest_step, restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.compress import (CompressionConfig,
                                           compress_with_feedback,
                                           init_feedback)
from repro_torch.training.optimizer import (OptConfig, adamw_init,
                                            adamw_update)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

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
    """{input name: its spec} under the policy's activation rules; the
    tokens' at the length of the sequence the model splits: with patches
    ahead of them, patches and tokens together (the reference shards the
    concatenated embeddings, `repro.models.lm._embed_inputs`)."""
    axes = {"tokens": ("batch", "seq"), "patches": ("batch", "patches",
                                                    "embed"),
            "frames": ("batch", "src_seq", "embed")}
    shapes = {k: tuple(v.shape) for k, v in batch.items()}
    if "patches" in batch:
        b, t = shapes["tokens"]
        shapes["tokens"] = (b, batch["patches"].shape[1] + t)
    return {k: policy.act_spec(axes[k], shapes[k]) for k in batch}


def _placer(model, policy):
    """The function that places a tree of the parameters' structure on
    the policy's mesh."""
    from repro_torch.distributed.elastic import reshard_state

    axes = model.param_axes()
    return lambda tree: reshard_state(tree, axes, policy.mesh, policy.acts,
                                      policy.params)


def place_state(model, policy, params, opt_state):
    """(params, opt_state) placed on the policy's mesh as DTensors (see
    the module docstring); the step counter and compression's feedback
    stay plain."""
    place = _placer(model, policy)
    adam = opt_state["adam"]
    placed = {"adam": {"master": place(adam["master"]), "m": place(adam["m"]),
                       "v": place(adam["v"]), "step": adam["step"]}}
    if "feedback" in opt_state:
        placed["feedback"] = opt_state["feedback"]
    return place(params), placed


def _whole(x):
    """A DTensor's full value, gathered over each mesh axis that shards
    it (the minor axis first, undoing `sharding.local_block`); a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    t, mesh = x.to_local(), x.device_mesh
    for i in reversed(range(mesh.ndim)):
        p = x.placements[i]
        if p.is_shard() and mesh.size(i) > 1:
            t = seq_parallel.all_gather(t, p.dim, mesh.get_group(i),
                                        mesh.size(i))
    return t


def gathered(tree):
    """A placed tree's leaves whole; plain ones as they are."""
    return tree_map(_whole, tree)


def _local(tree):
    """Each DTensor leaf's local shard (its storage, so in-place updates
    write the placed tensor)."""
    return tree_map(lambda x: x.to_local(), tree)


def _placed_like(tree, like):
    """Each leaf of ``tree`` (a local shard) placed as ``like``'s."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t, x: DTensor.from_local(
        t, x.device_mesh, x.placements, shape=x.shape, stride=x.stride()),
        tree, like)


IGNORE = -100                      # `next_token_loss`'s left-out target


def _entry_axes(entry, sizes) -> tuple:
    """The mesh axes above one card in a spec entry."""
    return tuple(a for a in (entry if isinstance(entry, tuple) else (entry,))
                 if a is not None and sizes[a] > 1)


def split_rows(batch: dict, rank: int, size: int) -> tuple[dict, int]:
    """Block ``rank`` of ``size`` of each sequence of ``batch`` (whole
    rows), as a split rank's model takes it, and its length S_local.

    The block is of the sequence the model runs: ``tokens`` [B, T], or
    with ``patches`` [B, P, D] the concatenation [patches; tokens], so the
    block holds its slice of the patches and its slice of the tokens
    (either may be empty).  Its ``targets`` [B, S_local] are the next
    position's target (-100 over the patches, ``IGNORE`` after the
    sequence's end) and ``target_count`` each row's targets over the
    whole sequence that are not -100 (the last patch's, the first token,
    counts, as in the reference's loss).  ``frames`` [B, src_len, D] are
    cut into their own block beside the tokens'.  A length that does not
    divide by ``size`` raises ValueError; any other input raises too."""
    extra = set(batch) - {"tokens"}
    if len(extra) > 1 or extra - {"patches", "frames"}:
        raise ValueError(f"a sequence split of a batch of {sorted(batch)} "
                         "is not ported")
    tokens = batch["tokens"]
    b, t = tokens.shape
    p = batch["patches"].shape[1] if "patches" in batch else 0
    src = batch["frames"].shape[1] if "frames" in batch else 0
    if (p + t) % size:
        raise ValueError(f"a sequence of {f'{p} patches + ' if p else ''}"
                         f"{t} tokens does not split over {size} ranks")
    if src % size:
        raise ValueError(f"{src} frames do not split over {size} ranks")
    sl = (p + t) // size
    lo, hi = rank * sl, (rank + 1) * sl
    whole = torch.cat([tokens.new_full((b, p), IGNORE), tokens], dim=1)
    after = torch.cat([whole[:, 1:], whole.new_full((b, 1), IGNORE)], dim=1)
    local = {"tokens": tokens[:, max(lo - p, 0):max(hi - p, 0)],
             "targets": after[:, lo:hi],
             "target_count": (whole[:, 1:] != IGNORE).sum(dim=1)}
    if p:
        local["patches"] = batch["patches"][:, min(lo, p):min(hi, p)]
    if "frames" in batch:
        fl = src // size
        local["frames"] = batch["frames"][:, rank * fl:(rank + 1) * fl]
    return local, sl


def _split_batch(policy, batch: dict):
    """(this rank's batch, the sequence split or None, the batch's mesh
    axes, the sequence's mesh axes) under the policy's activation rules.
    A split rank's batch is its block of each of its rows (`split_rows`)."""
    from repro_torch.distributed.sharding import local_block, mesh_shape

    mesh = policy.mesh
    sizes = mesh_shape(mesh)
    specs = _batch_specs(policy, batch)
    batch_axes = tuple(dict.fromkeys(
        a for sp in specs.values() if sp for a in _entry_axes(sp[0], sizes)))
    rows = {k: local_block(v, mesh, specs[k][:1]) for k, v in batch.items()}
    tok = specs["tokens"]
    seq_axes = _entry_axes(tok[1], sizes) if len(tok) > 1 else ()
    if not seq_axes:
        return rows, None, batch_axes, ()
    if len(seq_axes) > 1:
        raise ValueError(f"a sequence split over {seq_axes} is not ported")
    axis = seq_axes[0]
    m, r = sizes[axis], mesh.get_local_rank(axis)
    local, sl = split_rows(rows, r, m)
    split = seq_parallel.SeqSplit(mesh.get_group(axis), r, m, sl)
    return local, split, batch_axes, seq_axes


def _placed_step(model, opt_cfg, compression, accum_steps, policy):
    from repro_torch.distributed.sharding import param_shardings, spec_axes

    mesh = param_gather.StepMesh.of(policy.mesh)
    sizes = mesh.sizes
    compress = compression is not None and compression.enabled
    specs = None

    def global_norm(grads, leaf_specs):
        """The whole gradient's norm from the ranks' blocks: each block's
        float32 sum of squares over the ranks that hold it, summed over
        the mesh."""
        sums = []
        for g, spec in zip(grads, leaf_specs):
            held = 1
            for a, n in sizes.items():
                if a not in spec_axes(spec):
                    held *= n
            sums.append(torch.sum(torch.square(g.float())) / held)
        total = torch.sum(torch.stack(sums))
        if policy.mesh.size() > 1:
            total = seq_parallel.all_reduce(total, None)   # every rank
        return torch.sqrt(total)

    def train_step(params, opt_state, batch):
        nonlocal specs
        if specs is None:
            specs = list(param_shardings(policy, params,
                                         model.param_axes()).values())
        local, split, means, sums = _split_batch(policy, batch)
        shards = _local(params)
        leaves = tree_leaves(shards)
        for p in leaves:
            p.requires_grad_(True)
        binding = (param_gather.ParamGather(mesh, leaves, specs, sums, means)
                   if policy.mesh.size() > 1 else None)
        with seq_parallel.split(split), param_gather.bind(binding):
            loss, grads = loss_and_grads(model, shards, local, accum_steps)
        if binding is not None:
            missed = binding.missed(leaves)
            if missed:
                raise RuntimeError(f"leaves {missed} were never gathered: "
                                   "their gradients are not reduced")
            sums = binding.loss_axes(shards["lm_head"])
        loss = mesh.reduce(loss, (), sums, means)
        grads = tree_leaves(grads)
        if compress:
            whole = [mesh.whole(g, spec) for g, spec in zip(grads, specs)]
            whole, fb = compress_with_feedback(
                tree_unflatten(shards, whole), opt_state["feedback"],
                compression)
            grads = [mesh.reduce(g, spec)
                     for g, spec in zip(tree_leaves(whole), specs)]
        gnorm = global_norm(grads, specs)
        adam = opt_state["adam"]
        local_adam = {"master": _local(adam["master"]), "m": _local(adam["m"]),
                      "v": _local(adam["v"]), "step": adam["step"]}
        _, new_opt, stats = adamw_update(_local(params), grads, local_adam,
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
    placed on its mesh and the loop runs over it (the module docstring);
    the returned params and state are then DTensors (`gathered` makes
    them whole), and rank 0 writes the checkpoints.
    """
    from repro_torch.distributed.sharding import current_policy

    del donate
    dev = resolve_device(device)
    policy = current_policy()
    opt_cfg = opt_cfg or OptConfig(total_steps=steps)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    start = 0
    last = latest_step(ckpt_dir) if ckpt_dir and resume else None
    if policy is not None and last is None:
        # AdamW's state made from the placed parameters: no rank holds
        # the whole of it
        placed = _placer(model, policy)(params)
        adam = adamw_init(_local(placed))
        opt_state = {"adam": {**{k: _placed_like(adam[k], placed)
                                 for k in ("master", "m", "v")},
                              "step": adam["step"]}}
        if compression is not None and compression.enabled:
            opt_state["feedback"] = init_feedback(params)
        params = placed
    else:
        opt_state = init_opt_state(params, compression)
        if last is not None:
            (params, opt_state), _, start = restore_checkpoint(
                ckpt_dir, last, (params, opt_state))
        if policy is None:
            for p in tree_leaves(params):
                p.requires_grad_(True)
        else:
            params, opt_state = place_state(model, policy, params,
                                            opt_state)

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

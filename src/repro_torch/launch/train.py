"""Training launcher of the port: ``python -m repro_torch.launch.train
--arch qwen3-8b ...``.

The reference's ``python -m repro.launch.train`` with its flags and printed
lines, plus ``--device {cuda,cpu}`` (default ``cuda``): without a card
``--device cuda`` raises, and nothing moves to the CPU unless asked.
``--smoke`` trains the reduced config of the same family (float32, widths
64 · ``--scale``).  Every architecture trains on the card: the kernels on
its path (flash attention, the WKV6 and SSD scans) have backward kernels
(`kernels/ops.py`).  Fault tolerance: atomic checkpoints and
resume-from-latest (``--ckpt-dir``).

Several ranks train under the reference's sharding policy, one process a
rank, as the reference trains over several devices: launched by
``torchrun --nproc-per-node N -m repro_torch.launch.train ...`` (or with
``WORLD_SIZE``, ``RANK`` and ``MASTER_ADDR``/``MASTER_PORT`` set), the
launcher joins the process group and builds ``ShardingPolicy(mesh,
TRAIN_RULES, TRAIN_PARAM_RULES)`` (`training.loop`: the rows over
``data``, each sequence over ``model``, the parameters placed by the
rules).  The dense GQA decoders get the reference's mesh, ``remesh(N)``
at its default ratio: (1, 2) on two ranks, (2, 2) on four.  The other
families cannot split a sequence yet (`distributed.seq_parallel.
unsupported`): they get (N, 1), data-parallel, and the launcher says that
this departs from the reference's mesh.  The backend is NCCL with one
card a rank, gloo with ``--device cpu`` and where the ranks share a card
(fewer visible cards than local ranks; gloo then runs on CUDA tensors).
Rank 0 prints.  One process that sees several cards trains on one and
says how to use them all.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.distributed.seq_parallel import unsupported
from repro_torch.distributed.sharding import (TRAIN_PARAM_RULES, TRAIN_RULES,
                                              ShardingPolicy, apply_policy)
from repro_torch.models import build_model
from repro_torch.training.compress import CompressionConfig
from repro_torch.training.data import SyntheticLM
from repro_torch.training.loop import train_loop
from repro_torch.training.optimizer import OptConfig
from repro_torch.utils.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the same family (CPU-runnable)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="width multiplier on the reduced config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains (cuda: the hand-written "
                         "kernels; cpu: their plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        backend = "gloo"
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", "0"))
            cards = torch.cuda.device_count()
            dev = torch.device("cuda", local % cards)
            torch.cuda.set_device(dev)
            if int(os.environ.get("LOCAL_WORLD_SIZE",
                                  os.environ["WORLD_SIZE"])) <= cards:
                backend = "nccl"
        dist.init_process_group(backend)
    cfg = get_config(args.arch)
    if args.smoke:
        s = args.scale
        cfg = cfg.scaled(dtype="float32",
                         d_model=int(64 * s), d_ff=int(128 * s),
                         head_dim=int(16 * s))
    model = build_model(cfg)
    data = SyntheticLM(cfg.vocab_size, args.seq_len, args.batch,
                       seed=args.seed)
    comp = CompressionConfig(enabled=args.compress)
    opt = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                    total_steps=args.steps)

    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    policy = None
    if n_dev > 1:
        policy = ShardingPolicy(train_mesh(cfg, n_dev, dev.type),
                                acts=TRAIN_RULES, params=TRAIN_PARAM_RULES)
    elif dev.type == "cuda" and torch.cuda.device_count() > 1:
        print(f"{torch.cuda.device_count()} CUDA devices visible; training "
              f"on one ({dev}): launch one process a card (torchrun "
              "--nproc-per-node) to train over them")
    with apply_policy(policy):
        out = train_loop(model, data, steps=args.steps, opt_cfg=opt,
                         compression=comp, accum_steps=args.accum,
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         seed=args.seed, device=dev)
    if dist.is_initialized() and dist.get_rank() != 0:
        return out
    for step, loss in out["losses"]:
        print(f"step {step:5d}  loss {loss:.4f}")
    print(f"done: {args.steps} steps in {out['wall_s']:.1f}s "
          f"({args.steps * args.batch * args.seq_len / out['wall_s']:.0f} "
          "tok/s)")
    return out


def train_mesh(cfg, n_dev: int, device_type: str):
    """The mesh of ``n_dev`` ranks: the reference's ``remesh(n_dev)`` for
    a model whose sequences can split over ``model``, else (n_dev, 1),
    said on rank 0."""
    from repro_torch.distributed.elastic import remesh

    reason = unsupported(cfg)
    if reason is None:
        return remesh(n_dev, device_type=device_type)
    if dist.get_rank() == 0:
        print(f"training data-parallel on a ({n_dev}, 1) mesh, not the "
              f"reference's remesh({n_dev}): {reason}")
    return remesh(n_dev, data_model_ratio=n_dev, device_type=device_type)


if __name__ == "__main__":
    main()

"""Training launcher of the port: ``python -m repro_torch.launch.train
--arch qwen3-8b ...``.

The reference's ``python -m repro.launch.train`` with its flags and printed
lines, plus ``--device {cuda,cpu}`` (default ``cuda``): without a card
``--device cuda`` raises, and nothing moves to the CPU unless asked.
``--smoke`` trains the reduced config of the same family (float32, widths
64 · ``--scale``).  Fault tolerance: atomic checkpoints and
resume-from-latest (``--ckpt-dir``).  The reference shards over several
devices through its mesh and sharding policy, which the port has not yet;
with several cards visible it trains on one and says so.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
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

    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n_dev > 1:
        print(f"{n_dev} CUDA devices visible; training on one ({dev}): "
              "the port has no sharding policy yet")
    out = train_loop(model, data, steps=args.steps, opt_cfg=opt,
                     compression=comp, accum_steps=args.accum,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     seed=args.seed, device=dev)
    for step, loss in out["losses"]:
        print(f"step {step:5d}  loss {loss:.4f}")
    print(f"done: {args.steps} steps in {out['wall_s']:.1f}s "
          f"({args.steps * args.batch * args.seq_len / out['wall_s']:.0f} "
          "tok/s)")
    return out


if __name__ == "__main__":
    main()

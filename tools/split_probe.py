"""A full-width split cell's peak memory and step time a rank, at any
depth, for any checkout of the repository.

Runs ``launch/train.py`` in two processes at (1, 2), as phases 27c-30c
of ``chip_smoke.py`` do (the checkout's own ``chip_smoke.SplitRun`` and
``SPLIT_WORKER``: gloo on the card's CUDA tensors where the two ranks
share it, bf16, 2 steps, train_4k's 4,096 positions at batch 1, or
seamless-m4t-medium at phase 25's 2 × 512 tokens and 1,024 frames), one
cell after another, and prints each rank's peak GiB, its step ms after
the first, its collectives, and the card's name and power limit.  A cell
whose ranks fail (out of memory) is printed as such and the next one
runs.  It compares two commits on one card: unpack the other with ``git
archive`` into a directory ``.gitignore`` lists and run this script from
each checkout's root in one call.

Run from a checkout's root on a machine with a CUDA card:

    PYTHONPATH=src:. python3 tools/split_probe.py qwen3-8b:2 \\
        llava-next-34b:5 [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import chip_smoke as cs


def cell_spec(arch: str, depth: int) -> dict:
    """SPLIT_WORKER's spec of ``arch`` at ``depth`` layers at its phase's
    positions and batch."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    seq, batch = ((cs.TRAIN_SEQ, cs.TRAIN_BATCH) if arch == cs.SEAMLESS
                  else (cs.TRAIN_4K, 1))
    return {"arch": arch, "over": {"n_layers": depth}, "grads": False,
            "args": ["--arch", arch, "--steps", str(cs.SPLIT_FULL_STEPS),
                     "--lr", str(cs.TRAIN_LR[arch]), "--seq-len",
                     str(seq - cfg.n_patches), "--batch", str(batch)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="+", help="arch:layers")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from repro_torch.kernels import build

    build.build()
    card = cs.card_line()
    print(card, flush=True)
    out = {"card": card, "cells": {}}
    for cell in args.cells:
        arch, depth = cell.split(":")
        t0 = time.perf_counter()
        run = cs.SplitRun(cell_spec(arch, int(depth)), 2, f"probe_{arch}")
        try:
            ranks = run.wait()
        except Exception as e:     # noqa: BLE001 — a cell that did not fit
            print(f"{cell}: the ranks failed ({type(e).__name__}: {e})",
                  flush=True)
            out["cells"][cell] = None
            continue
        peaks = [r["peak_gib"] for r in ranks]
        steps = [statistics.mean(r["step_ms"][1:]) for r in ranks]
        out["cells"][cell] = {"peak_gib": peaks, "step_ms": steps,
                              "collectives": ranks[0]["collectives"]}
        print(f"{cell}: peak {max(peaks):.2f} GiB a rank ({peaks}), step "
              f"{statistics.mean(steps):.1f} ms a rank ({steps}), "
              f"collectives {ranks[0]['collectives']}; "
              f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

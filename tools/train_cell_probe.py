"""Phase 25's full-width recurrent training cells, for any checkout of the
repository: rwkv6-3b whole and zamba2-7b at ``ZAMBA_TRAIN_LAYERS`` layers,
bf16, train_4k's 4,096 tokens at batch 1, through the checkout's own
``chip_smoke.train_full_width`` (``train_loop``, its exact launch gates,
its falling-loss gate, one step under the profiler, the scan backward
replayed at its recorded calls).  Prints each cell's step ms after the
first, its peak GiB and the backward's device ms a call, with the card's
name and power limit.  It compares two commits on one card: unpack the
other with ``git archive`` into a directory ``.gitignore`` lists and run
this script from each checkout's root in one call, in turns.

Run from a checkout's root on a machine with a CUDA card:

    PYTHONPATH=src:. python3 tools/train_cell_probe.py [--label L] \\
        [--out FILE]
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import chip_smoke as cs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    out = {"label": args.label, "card": card, "cells": {}}
    zamba = dataclasses.replace(get_config(cs.ZAMBA),
                                n_layers=cs.ZAMBA_TRAIN_LAYERS)
    for cfg, op in ((get_config(cs.RWKV), "wkv6_bwd"), (zamba, "ssd_bwd")):
        counts, replays = cs.train_full_width(cfg, dev, cs.TRAIN_4K, 1)
        r = replays[op]
        out["cells"][cfg.name] = {
            "step_ms": r["step_ms"], "peak_gib": r["peak_gib"],
            "bwd_device_ms": r["device_ms"], "bwd_ms": r["ms"],
            "launches": dict(counts)}
        print(f"[{args.label}] {cfg.name}: step {r['step_ms']:.1f} ms after "
              f"the first, peak {r['peak_gib']:.2f} GiB, {op} "
              f"{r['device_ms']:.4f} ms a call ({r['device_ms_from']}); "
              f"{card}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

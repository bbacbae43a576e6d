#!/usr/bin/env python3
"""The scans' backward from the checkpoints, pass by pass, beside the
backward from every state; the SASS of their kernels.

Builds the scan libraries of the checkout whose ``src`` is first on
``PYTHONPATH``, prints each backward library's kernel instances'
registers and spills (``-Xptxas -v``) and an opcode count of their SASS
(``cuobjdump -sass``).  Then, at the training shapes (rwkv6-3b: 40 heads
of 64; zamba2-7b: 112 heads of 64, state 64; 4,096 tokens), batch 1 and 2,
in float32 and bf16, for each scan: the device ms of one backward call from
every chunk's state and from the checkpoints (CUDA events around calls
queued behind a spin, so passes that run side by side count once), the
checkpointed call's gradients against the whole-state call's bit for bit
(a difference fails the run), each kernel's device ms a call (its mean
launch in a ``torch.profiler`` trace times its launches a call), the share
of the recompute's kernel time that falls inside a chunk or reverse pass,
and each call's scratch (device bytes beyond its outputs at its peak).
Needs one CUDA card.  It compares two commits on one card: unpack the
other with ``git archive`` into a directory ``.gitignore`` lists and run
this script, from this checkout's root, against each checkout's ``src`` in
one call, in turns:

    PYTHONPATH=src:. python3 tools/scan_bwd_probe.py [--out DIR] [--label L]

With ``--out`` the whole SASS of both libraries is written there as
``<label>_<kernel>.sass``, and the figures as ``<label>.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
from collections import Counter
from pathlib import Path

os.environ.setdefault("TEARDOWN_CUPTI", "0")   # before torch loads CUPTI

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd import ssd_bwd_cuda, ssd_cuda  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6_bwd_cuda, wkv6_cuda  # noqa: E402

# after the checkout's modules: chip_smoke puts its own src first on the
# path, and what is imported already stays
import chip_smoke as cs  # noqa: E402

OPCODES = ("LDG", "STG", "LDS", "STS", "LDSM", "LDGSTS", "HMMA", "FFMA",
           "FMUL", "FADD", "MUFU", "F2F", "PRMT", "BAR", "SHFL")


def sass_stats(lib: Path, out: Path | None, label: str, name: str) -> None:
    """Opcode counts per kernel function of ``lib``."""
    sass = subprocess.run([cs.cuda_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    if out is not None:
        (out / f"{label}_{name}.sass").write_text(sass)
    fn, counts = None, {}
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            fn = m.group(1)
            counts[fn] = Counter()
        elif fn and (m := re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                                    r"([A-Z][A-Z0-9_]*)", line)):
            counts[fn]["all"] += 1
            counts[fn][m.group(1).split(".")[0]] += 1
    for fn, c in counts.items():
        shown = ", ".join(f"{k} {c[k]}" for k in OPCODES if c[k])
        print(f"  {fn[:70]}: {c['all']} instructions; {shown}")


def one(label, scan, fwd, kernel, bwd, dout, iters=10) -> dict:
    """One backward's figures from every state and from the checkpoints."""
    _, _, every = kernel(*fwd, return_states=True)
    _, _, ckpt = kernel(*fwd, return_states=True, keep_every=16)
    whole_args, args = (*fwd, every, dout), (*fwd, ckpt, dout)
    whole, whole_scr = cs.bwd_scratch(lambda: bwd(*whole_args))
    got, scr = cs.bwd_scratch(lambda: bwd(*args))
    same = all((g is None and w is None) or torch.equal(g, w)
               for g, w in zip(got, whole))
    del got, whole
    f = {"whole_ms": cs.queued_event_ms([lambda: bwd(*whole_args)] * iters)
         / iters,
         "ms": cs.queued_event_ms([lambda: bwd(*args)] * iters) / iters,
         "bit_for_bit": same, "scratch_bytes": scr,
         "whole_scratch_bytes": whole_scr}
    kernels = cs.traced_kernels(lambda: [bwd(*args) for _ in range(5)])
    f["passes_ms"] = {k: v / 5 for k, v in cs.kernel_totals(kernels).items()}
    f["recompute_inside"] = cs.overlap_share(kernels, cs.RECOMPUTE_KERNEL,
                                             cs.BWD_PASS_KERNEL)
    whole_k = cs.traced_kernels(lambda: [bwd(*whole_args) for _ in range(5)])
    f["whole_passes_ms"] = {k: v / 5
                            for k, v in cs.kernel_totals(whole_k).items()}
    print(f"[{label}] {scan} {fwd[0].dtype} b={fwd[0].shape[0]}: from the "
          f"checkpoints {f['ms']:.4f} ms (events), from every state "
          f"{f['whole_ms']:.4f} ({f['ms'] / f['whole_ms']:.3f}x); bit for "
          f"bit {same}; passes (profiler, ms a call) "
          + ", ".join(f"{k} {v:.4f}" for k, v in f["passes_ms"].items())
          + f"; recompute inside chunk / reverse passes "
          f"{f['recompute_inside']:.3f}; scratch {scr} B (every state "
          f"{whole_scr} B); every state's passes "
          + ", ".join(f"{k} {v:.4f}" for k, v in f["whole_passes_ms"].items()))
    return f


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    reports = build.build(("wkv6", "ssd", "wkv6_bwd", "ssd_bwd"))
    for name in ("wkv6_bwd", "ssd_bwd"):
        print(f"[{args.label}] {name}: ptxas")
        for line in cs.ptxas_report(reports.get(name, "")):
            print("   ", line)
        print(f"[{args.label}] {name}: SASS")
        sass_stats(build.library_path(name), args.out, args.label, name)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def normal(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    s, figures = 4096, {}
    for b in (1, 2):
        for dtype in (torch.float32, torch.bfloat16):
            key = f"{str(dtype).removeprefix('torch.')} b={b}"
            h, dk = 40, 64
            lw = torch.clamp(-torch.exp(normal((b, s, h, dk))), -4.0, -1e-3)
            fwd = (normal((b, s, h, dk), dtype), normal((b, s, h, dk), dtype),
                   normal((b, s, h, dk), dtype), lw, normal((h, dk)))
            figures["wkv6_bwd", key] = one(args.label, "wkv6_bwd", fwd,
                                           wkv6_cuda, wkv6_bwd_cuda,
                                           normal((b, s, h, dk), dtype))
            del fwd, lw
            h, hd, ds = 112, 64, 64
            fwd = (normal((b, s, h, hd), dtype), normal((b, s, ds), dtype),
                   normal((b, s, ds), dtype), normal((b, s, h)).abs() * 0.5,
                   normal((h,), scale=0.3), normal((h,)))
            figures["ssd_bwd", key] = one(args.label, "ssd_bwd", fwd,
                                          ssd_cuda, ssd_bwd_cuda,
                                          normal((b, s, h, hd), dtype))
            del fwd
            torch.cuda.empty_cache()
    card = cs.card_line()
    print(f"[{args.label}] card: {card}")
    if args.out is not None:
        (args.out / f"{args.label}.json").write_text(json.dumps(
            {"card": card, "figures": {" ".join(k): v
                                       for k, v in figures.items()}},
            indent=1))
    return 0 if all(f["bit_for_bit"] for f in figures.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())

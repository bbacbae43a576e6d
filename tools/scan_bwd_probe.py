#!/usr/bin/env python3
"""Per-kernel device times and SASS of the scans' backward kernels.

Builds ``csrc/wkv6_bwd.cu`` and ``csrc/ssd_bwd.cu`` of the checkout it is
run from, prints each kernel instance's registers and spills (``-Xptxas
-v``) and an opcode count of its SASS (``cuobjdump -sass``), then times
each kernel of one backward call from every chunk's state (the
checkpointed call adds the forward's passes a segment: `chip_smoke.py`
phase 23b) with ``torch.profiler`` at the training shapes (rwkv6-3b: 40
heads of 64; zamba2-7b: 112 heads of 64, state 64; 4,096 tokens), batch 1
and 2, in float32 and bf16.  Needs one CUDA card:

    PYTHONPATH=src python3 tools/scan_bwd_probe.py [--out DIR] [--label L]

With ``--out`` the whole SASS of both libraries is written there as
``<label>_<kernel>.sass``.
"""
from __future__ import annotations

import argparse
import re
import subprocess
from collections import Counter
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd import ssd_bwd_cuda, ssd_cuda
from repro_torch.kernels.wkv6 import wkv6_bwd_cuda, wkv6_cuda

OPCODES = ("LDG", "STG", "LDS", "STS", "LDSM", "LDGSTS", "HMMA", "FFMA",
           "FMUL", "FADD", "MUFU", "F2F", "PRMT", "BAR", "SHFL")


def sass_stats(lib: Path, out: Path | None, label: str, name: str) -> None:
    """Opcode counts per backward kernel function of ``lib``."""
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True).stdout
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


def kernel_means(fn, stem: str, calls: int = 5) -> dict[str, float]:
    """Mean device ms of each kernel whose name holds ``stem``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if stem in e.key and e.count:
            m = re.search(r"(\w+_kernel)", e.key)
            name = m.group(1) if m else e.key[:40]
            out[name] = out.get(name, 0.0) + \
                e.device_time_total / e.count / 1e3
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    reports = build.build(("wkv6_bwd", "ssd_bwd"))
    for name in ("wkv6_bwd", "ssd_bwd"):
        print(f"[{args.label}] {name}: ptxas")
        for line in reports.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                print("   ", line.strip()[:150])
        print(f"[{args.label}] {name}: SASS")
        sass_stats(build.library_path(name), args.out, args.label, name)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def normal(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    s = 4096
    for b in (1, 2):
        for dtype in (torch.float32, torch.bfloat16):
            h, dk = 40, 64
            lw = torch.clamp(-torch.exp(normal((b, s, h, dk))), -4.0, -1e-3)
            fwd = (normal((b, s, h, dk), dtype), normal((b, s, h, dk), dtype),
                   normal((b, s, h, dk), dtype), lw, normal((h, dk)))
            _, _, states = wkv6_cuda(*fwd, return_states=True)
            do = normal((b, s, h, dk), dtype)
            means = kernel_means(lambda: wkv6_bwd_cuda(*fwd, states, do),
                                 "wkv6_bwd")
            print(f"[{args.label}] wkv6_bwd b={b} {dtype}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in means.items())
                  + f"; total {sum(means.values()):.4f} ms")
            del fwd, states, do, lw
            h, hd, ds = 112, 64, 64
            fwd = (normal((b, s, h, hd), dtype), normal((b, s, ds), dtype),
                   normal((b, s, ds), dtype), normal((b, s, h)).abs() * 0.5,
                   normal((h,), scale=0.3), normal((h,)))
            _, _, states = ssd_cuda(*fwd, return_states=True)
            dy = normal((b, s, h, hd), dtype)
            means = kernel_means(lambda: ssd_bwd_cuda(*fwd, states, dy),
                                 "ssd_bwd")
            print(f"[{args.label}] ssd_bwd b={b} {dtype}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in means.items())
                  + f"; total {sum(means.values()):.4f} ms")
            del fwd, states, dy
            torch.cuda.empty_cache()
    print(f"[{args.label}] card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())


if __name__ == "__main__":
    main()

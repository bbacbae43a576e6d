"""Roofline analysis from the port's dry-run records (the reference's
`repro.roofline`, with an H100's constants in place of a TPU's).

Per (arch, shape, mesh) cell, three per-step times from the
variant-extrapolated costs (all numbers per card):

    t_compute    = flops_dev / PEAK_FLOPS          (989 TFLOP/s bf16, dense)
    t_memory     = bytes_dev / HBM_BW              (3.35 TB/s)
    t_collective = wire_bytes_dev / NVLINK_BW      (450 GB/s a direction)

All three are lower bounds on the step.  The dry run's bytes are the
step's traffic per fused region (`launch/traffic.py`), as the reference
reads XLA's ``bytes accessed`` of its fused step: each hand-written
kernel's own reads and writes, each elementwise chain once, the
micro-batches' gradient sums and AdamW's update.  The largest term is
reported as ``dominant`` and "roofline fraction" = useful model flops /
(cards * PEAK * t_dominant), as in the reference.  ``fits_hbm80`` holds
the resident bytes against one card's 80 GB.

Usage: ``python -m repro_torch.roofline [artifacts/dryrun_torch]
[--mesh mesh16x16] [--json rows.json]``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

# H100 SXM5, NVIDIA's data sheet: bf16 dense on the tensor cores, HBM3,
# fourth-generation NVLink (900 GB/s both directions, 450 each way).
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
HBM_BYTES = 80e9

CHIPS = {"mesh16x16": 256, "mesh2x16x16": 512}


def analyze(rec: dict) -> dict | None:
    if not rec.get("ok"):
        return None
    chips = rec.get("chips") or CHIPS.get(rec["mesh"], 256)
    full = {"flops": rec["full"]["flops"], "bytes": rec["full"]["bytes"],
            "coll": rec["full"]["collectives"]["total"]}
    src = rec.get("corrected") or full
    flops = max(src["flops"], full["flops"], 0.0)
    hbytes = max(src["bytes"], full["bytes"], 0.0)
    coll = max(src["coll"], full["coll"], 0.0)
    t_c = flops / PEAK_FLOPS
    t_m = hbytes / HBM_BW
    t_x = coll / NVLINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    dominant = max(terms, key=terms.get)
    t_dom = terms[dominant]
    model_fl = rec.get("model_flops", 0.0)
    useful_ratio = model_fl / (flops * chips) if flops else 0.0
    mfu_at_roofline = (model_fl / (chips * PEAK_FLOPS * t_dom)) if t_dom else 0.0
    mem = rec["full"]["memory"]
    resident = mem["argument"] + mem["temp"] + mem["output"] - mem["alias"]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "kind": rec["kind"],
        "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_x,
        "dominant": dominant,
        "model_flops": model_fl,
        "hlo_flops_total": flops * chips,
        "useful_flops_ratio": useful_ratio,
        "mfu_at_roofline": mfu_at_roofline,
        "mem_resident_gb": resident / 1e9,
        "fits_hbm80": resident <= HBM_BYTES,
    }


def load_all(art_dir: str, mesh: str = "mesh16x16") -> list[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(art_dir, f"*__{mesh}.json"))):
        with open(path) as f:
            rec = json.load(f)
        if not rec.get("supported", True):
            out.append({"arch": rec["arch"], "shape": rec["shape"],
                        "mesh": rec["mesh"], "skip": rec["skip_reason"]})
            continue
        row = analyze(rec)
        if row:
            out.append(row)
        else:
            out.append({"arch": rec["arch"], "shape": rec["shape"],
                        "mesh": rec["mesh"],
                        "fail": rec.get("error", "?")})
    return out


def format_table(rows: list[dict]) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'t_comp':>9s} {'t_mem':>9s} "
           f"{'t_coll':>9s} {'dom':>5s} {'useful':>7s} {'MFU@roof':>8s} "
           f"{'mem GB':>7s} fit")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if "skip" in r:
            lines.append(f"{r['arch']:22s} {r['shape']:12s} SKIP: {r['skip'][:70]}")
            continue
        if "fail" in r:
            lines.append(f"{r['arch']:22s} {r['shape']:12s} FAIL: {r['fail'][:70]}")
            continue
        lines.append(
            f"{r['arch']:22s} {r['shape']:12s} {r['t_compute_s']:9.2e} "
            f"{r['t_memory_s']:9.2e} {r['t_collective_s']:9.2e} "
            f"{r['dominant'][:4]:>5s} {r['useful_flops_ratio']:7.3f} "
            f"{r['mfu_at_roofline']:8.3f} {r['mem_resident_gb']:7.1f} "
            f"{'y' if r['fits_hbm80'] else 'N'}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("artifacts", nargs="?", default="artifacts/dryrun_torch")
    ap.add_argument("--mesh", default="mesh16x16")
    ap.add_argument("--json", default=None, help="also dump rows as JSON")
    args = ap.parse_args(argv)
    rows = load_all(args.artifacts, args.mesh)
    print(format_table(rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()

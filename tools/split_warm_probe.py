"""Where a fresh training process spends its first step.

Runs ``chip_smoke.SPLIT_WORKER`` (``launch/train.py`` as one process,
mixtral-8x22b at full width and 1 layer, bf16, 4,096 tokens, 2 steps),
three times, each in a fresh process after a different prelude: none, a
bf16 4,096² GEMM, and one training step of a narrow mixtral (d_model 256,
1 layer) on the card.  Prints each run's step times.  On an H100 machine
the first step took ~10 s after no prelude and after the GEMM, and ~0.4 s
(the second step's time) after the narrow step, which itself took ~11 s:
a fresh process loads what the training path runs on its first training
step, which is why phases 27c-29c of ``chip_smoke.py`` warm a
one-process run up while the run before it holds the card.

Run from the repository root on a machine with a CUDA card:

    PYTHONPATH=src:. python3 tools/split_warm_probe.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import chip_smoke as cs

PRELUDES = {
    "none": "",
    "gemm": ("a = torch.randn(4096, 4096, device='cuda', "
             "dtype=torch.bfloat16)\n(a @ a).sum().item()\n"),
    "narrow": (
        "_c = dataclasses.replace(get_config(spec['arch']), n_layers=1, "
        "d_model=256, d_ff=256, moe_d_ff=256, n_heads=4, n_kv_heads=2, "
        "vocab_size=512)\n"
        "from repro_torch.models import build_model as _bm\n"
        "_m = _bm(_c)\n"
        "_p = _m.init(torch.Generator(device='cuda').manual_seed(0))\n"
        "for _x in tree_leaves(_p):\n    _x.requires_grad_(True)\n"
        "_t = torch.randint(0, 512, (1, 4096), device='cuda')\n"
        "torch.autograd.grad(_m.loss(_p, {'tokens': _t}), "
        "tree_leaves(_p))\ntorch.cuda.synchronize()\n"),
}
SPEC = {"arch": cs.MIXTRAL, "over": {"n_layers": 1}, "grads": False,
        "args": ["--arch", cs.MIXTRAL, "--steps", "2", "--lr", "1e-4",
                 "--seq-len", "4096", "--batch", "1"]}
HOOK = "ops.reset_launch_counts()\nseq_parallel"


def main() -> int:
    """Build the kernels, then run the worker after each prelude."""
    import torch

    from repro_torch.kernels import build

    build.build()
    print(cs.card_line(), flush=True)
    env = dict(os.environ, PYTHONPATH=f"{cs.ROOT / 'src'}:{cs.ROOT}")
    for name, prelude in PRELUDES.items():
        code = cs.SPLIT_WORKER.replace(
            HOOK, "t_pre = time.perf_counter()\n" + prelude
            + "print('prelude', time.perf_counter() - t_pre, flush=True)\n"
            + HOOK, 1)
        out = cs.ROOT / "build" / f"warm_{name}.pt"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code, json.dumps(SPEC),
                               str(out)], env=env, cwd=cs.ROOT,
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout[-2000:], proc.stderr[-2000:])
            return proc.returncode
        rec = torch.load(out)
        out.unlink()
        print(f"{name}: steps {[round(x, 1) for x in rec['step_ms']]} ms, "
              f"process {time.perf_counter() - t0:.1f} s; "
              f"{proc.stdout.splitlines()[0]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

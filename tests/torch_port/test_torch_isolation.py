"""The port stands alone: importing every `repro_torch` module (the MoE
module `models/moe.py`, the encoder-decoder `models/encdec.py`, the
training package `training/*`, the training CLI `launch/train.py` and
`utils/tree.py`, the sharding, mesh, dry-run and roofline tooling among
them) and ``chip_smoke.py`` loads neither JAX nor anything of the
reference package `repro`."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[2]
SRC = REPO / "src"

PROBE = r"""
import importlib, pkgutil, runpy, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                      "repro_torch."))
for name in names:
    importlib.import_module(name)
runpy.run_path(sys.argv[1], run_name="chip_smoke_import_probe")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
for need in ("models.moe", "models.encdec", "training.checkpoint",
             "training.compress", "training.data", "training.loop",
             "training.optimizer", "launch.train", "utils.tree",
             "distributed.sharding", "distributed.seq_parallel",
             "launch.mesh", "launch.dryrun",
             "models.scan_config", "roofline", "utils.hlo"):
    assert "repro_torch." + need in names, (need, names)
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_reference():
    out = subprocess.run(
        [sys.executable, "-c", PROBE, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(SRC)}, cwd=REPO)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 20
    assert bad == "[]", f"the port imported {bad}"

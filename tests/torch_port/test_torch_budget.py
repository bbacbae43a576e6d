"""Slow-marker audit for the port's tests (the top-level audit in
``tests/test_marker_audit.py`` globs ``tests/test_*.py`` only): every
``test_torch_*.py`` in this directory is either vetted for tier-1 below or
carries a module-level ``pytestmark = pytest.mark.slow``.  The directory's
tier-1 budget is 60 s in one CPU process."""
import re
from pathlib import Path

PORT_TESTS = Path(__file__).parent

TIER1_MODULES = {
    "test_torch_affinity_predictor",
    "test_torch_attention",
    "test_torch_backends",
    "test_torch_budget",
    "test_torch_cluster",
    "test_torch_cuda",
    "test_torch_dryrun",
    "test_torch_dryrun_fused",
    "test_torch_encdec_vlm",
    "test_torch_engine",
    "test_torch_federation",
    "test_torch_flash_bwd_design",
    "test_torch_fused",
    "test_torch_isolation",
    "test_torch_kernels_ref",
    "test_torch_ledger_mirror",
    "test_torch_models",
    "test_torch_moe_mla",
    "test_torch_param_gather",
    "test_torch_recurrent",
    "test_torch_router",
    "test_torch_scan_bwd",
    "test_torch_scan_checkpoint",
    "test_torch_scan_design",
    "test_torch_seq_parallel",
    "test_torch_seq_parallel_encdec_vlm",
    "test_torch_seq_parallel_moe",
    "test_torch_seq_parallel_recurrent",
    "test_torch_serve",
    "test_torch_sharding",
    "test_torch_simulator",
    "test_torch_solver",
    "test_torch_ssm",
    "test_torch_training",
    "test_torch_truthfulness",
}

SLOW_RE = re.compile(r"^pytestmark\s*=.*pytest\.mark\.slow", re.MULTILINE)


def test_every_port_module_is_budgeted():
    unbudgeted = [p.stem for p in sorted(PORT_TESTS.glob("test_*.py"))
                  if p.stem not in TIER1_MODULES
                  and not SLOW_RE.search(p.read_text())]
    assert not unbudgeted, (
        f"modules {unbudgeted} are neither slow-marked nor vetted for tier-1; "
        "add `pytestmark = pytest.mark.slow` or list them in TIER1_MODULES")


def test_port_vetted_list_is_current():
    existing = {p.stem for p in PORT_TESTS.glob("test_*.py")}
    assert not TIER1_MODULES - existing, \
        f"TIER1_MODULES lists removed modules: {TIER1_MODULES - existing}"

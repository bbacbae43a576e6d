"""The port's dry run, roofline and collective costing against the JAX
package's, on the CPU.

Checked:

* ``variant_plan`` and ``build_policy`` for all ten archs and every
  shape kind against the reference's, read in a subprocess:
  ``import repro.launch.dryrun`` sets ``XLA_FLAGS`` (512 host devices)
  at import, which must not reach this process's JAX;
* the variant extrapolation (L = 1 / L = 2, zamba2's groups, the
  encoder-decoder's three variants) equal to a direct trace at the
  cell's depth, for every arch at a reduced width and a train, a
  prefill and a decode shape: FLOPs, bytes and kept activations by the
  coefficients, the largest layer's saved set (or tensor) as the
  variants' max;
* ``state_bytes`` against a hand count from the leaves' shapes and the
  policy's specs, at meshes (1, 1) and (16, 16), and every arch's
  decode-cell cache by hand; a full-width qwen3-8b train cell's FLOPs
  against ``model_flops``;
* ``roofline.analyze`` against the reference's on one record, the
  reference's constants swapped for the H100's; ``load_all`` and
  ``format_table`` over the CLI's records;
* the ring formulas (``utils.hlo.CollectiveOp``) against the reference's
  parser on ``tests/test_sharding.py::test_hlo_collective_parser``'s HLO,
  and ``step_collectives`` against hand counts, data-parallel and with
  each sequence split over ``model`` at (1, 2) and (2, 2); a split train
  cell traced as one rank (half the FLOPs, its activations);
* the CLIs: ``python -m repro_torch.launch.dryrun`` and
  ``python -m repro_torch.roofline`` write and read the reference's
  record layout; a skipped cell keeps ``cell_supported``'s reason.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import roofline as jax_roofline  # noqa: E402
from repro.utils.hlo import parse_collectives  # noqa: E402
from repro_torch import roofline  # noqa: E402
from repro_torch.configs import (SHAPES, ShapeConfig, cell_supported,  # noqa: E402
                                 get_config, list_archs, model_flops)
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.utils.hlo import (CollectiveOp,  # noqa: E402
                                   collective_wire_bytes, step_collectives)

ROOT = Path(__file__).resolve().parents[2]
M11 = AbstractMesh((1, 1), ("data", "model"))
M16 = AbstractMesh((16, 16), ("data", "model"))

sys.path.insert(0, str(ROOT / "tests"))
from test_sharding import HLO_SAMPLE  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def reference_plans():
    """The reference dry run's variant plans and policies, from a
    subprocess (its import forces 512 host devices)."""
    code = """
import json
from types import SimpleNamespace
from repro.configs import get_config, list_archs
from repro.launch import dryrun
mesh = SimpleNamespace(shape={"data": 16, "model": 16})
out = {"plans": {a: dryrun.variant_plan(get_config(a)) for a in list_archs()},
       "policies": {k: [dryrun.build_policy(mesh, k, n).acts,
                        dryrun.build_policy(mesh, k, n).params]
                    for k, n in (("train", "train_4k"),
                                 ("prefill", "prefill_32k"),
                                 ("decode", "decode_32k"))}}
print(json.dumps(out))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _listed(x):
    return json.loads(json.dumps(x))


def test_variant_plans_match_reference(reference_plans):
    assert sorted(reference_plans["plans"]) == list_archs()
    for arch, plan in reference_plans["plans"].items():
        assert _listed(dryrun.variant_plan(get_config(arch))) == plan, arch


def test_build_policy_matches_reference(reference_plans):
    for kind, (acts, params) in reference_plans["policies"].items():
        name = {"train": "train_4k", "prefill": "prefill_32k",
                "decode": "decode_32k"}[kind]
        p = dryrun.build_policy(M16, kind, name)
        assert _listed(p.acts) == acts and _listed(p.params) == params


# ------------------------------------------------------ extrapolation --

def _reduced(arch):
    cfg = get_config(arch)
    over = {"n_layers": 4}
    if cfg.is_encdec:
        over["enc_layers"] = 3
    if cfg.attn_every:
        # three groups: the reference's plan counts a tail layer as a
        # fraction of a group, which is no exact extrapolation
        over.update(n_layers=6, attn_every=2)
    return cfg.scaled(dtype="float32", **over)


CELLS = [ShapeConfig("t", "train", 48, 4), ShapeConfig("p", "prefill", 40, 2),
         ShapeConfig("d", "decode", 48, 2)]


@pytest.mark.parametrize("arch", list_archs())
def test_variant_extrapolation_equals_full_depth_trace(arch):
    cfg = _reduced(arch)
    if cfg.n_patches:
        cfg = dataclasses.replace(cfg, n_patches=8)
    for shape in CELLS:
        policy = dryrun.build_policy(M11, shape.kind, shape.name)
        direct = dryrun.trace_cell(cfg, shape, policy, accum=2)
        plan = dryrun.variant_plan(cfg)
        parts = [(c, dryrun.trace_cell(dataclasses.replace(cfg, **o), shape,
                                       policy, accum=2)) for o, c in plan]
        assert max(v["peak"] for _, v in parts) == direct["peak"], arch
        for key in ("flops", "bytes", "act"):
            got = sum(c * v[key] for c, v in parts)
            assert got == pytest.approx(direct[key], rel=1e-12, abs=1e-6), \
                (arch, shape.kind, key)
        assert direct["flops"] > 0 and direct["bytes"] > 0
        assert (direct["act"] > 0) == (shape.kind == "train")


def test_state_bytes_by_hand():
    """Parameters, AdamW and the collectives from the leaves' shapes and
    specs, summed by hand."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import build_model

    cfg = get_config("qwen3-8b").scaled(dtype="bfloat16", n_layers=3)
    shape = ShapeConfig("t", "train", 64, 64)
    with FakeTensorMode():
        params = build_model(cfg).init(torch.Generator().manual_seed(0))
        leaves = [(n, tuple(p.shape)) for n, p in params.named_parameters()]
    axes = sharding.axes_by_path(build_model(cfg).param_axes())
    for mesh, k in ((M11, 1), (M16, 16)):
        policy = dryrun.build_policy(mesh, "train", "t")
        got = dryrun.state_bytes(cfg, shape, policy, accum=4)
        n_full = n_local = 0
        for name, dims in leaves:
            spec = policy.param_spec(axes[name], dims)
            local = sharding.local_shape(mesh, spec, dims)
            n_full += torch.Size(dims).numel()
            n_local += torch.Size(local).numel()
        assert got["params"] == 2 * n_local and got["opt"] == 12 * n_local
        assert got["grads"] == 2 * 2 * n_full      # with the accumulator
        assert got["gathered"] == 2 * (n_full - n_local)
        assert got["batch"] == 64 // 4 // k * 64 * 4
        coll = got["collectives"]
        if k == 1:
            assert n_local == n_full and coll["total"] == 0
        else:
            assert n_local < n_full and coll["count"] > 0
            # each sequence split over model: per layer, the K/V of the
            # card's row (64 tokens x 2 KV heads x 2·16, bf16) gathered
            # twice (forward, remat) and its gradient reduce-scattered once
            attn = 3 * (64 * 2 * 32 * 2) * 15 / 16
            assert coll["all-gather"] - 2 * attn == pytest.approx(
                coll["reduce-scatter"] - attn)


@pytest.mark.parametrize("arch", list_archs())
def test_decode_cell_cache_bytes_by_hand(arch):
    """A decode cell's per-card cache: every ``init_cache`` leaf under the
    decode rules' ``cache_axes`` spec (the batch over ``data``, a long
    cache's sequence over ``model``), counted by hand."""
    from repro_torch.models import build_model
    from repro_torch.models.registry import cache_axes, decode_state_specs

    cfg = _reduced(arch)
    shape = ShapeConfig("d", "decode", 64, 32)
    rec = dryrun.cost_cell(cfg, shape, M16)
    model = build_model(cfg)
    policy = dryrun.build_policy(M16, "decode", "d")
    specs, _ = decode_state_specs(model, shape)
    axes = sharding.axes_by_path(cache_axes(model))
    want = 0
    for path, spec in dryrun._flat_specs(specs).items():
        local = sharding.local_shape(M16, policy.act_spec(axes[path],
                                                          spec.shape),
                                     spec.shape)
        want += torch.Size(local).numel() * spec.dtype.itemsize
    assert rec["state"]["cache"] == want > 0
    mem = rec["full"]["memory"]
    assert mem["output"] == want and mem["argument"] >= want


def test_full_width_train_flops_against_model_flops():
    """qwen3-8b at full width, 2 layers, train_4k's 4,096 tokens, batch
    1: the traced FLOPs (forward, backward, remat's second forward) sit
    between 6·N·T's and 8·N·T's of the layers plus the head."""
    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=2)
    shape = ShapeConfig("train_4k", "train", 4096, 1)
    rec = dryrun.cost_cell(cfg, shape, M11, accum=1)
    mf = model_flops(cfg, shape)
    assert 0.7 * mf < rec["full"]["flops"] < 1.6 * mf
    mem = rec["full"]["memory"]
    n = sum(torch.Size(s).numel() for s in [(151936, 4096)] * 2)
    assert mem["argument"] > 16 * n - 2 * n      # params + AdamW, at least
    assert rec["full"]["collectives"]["total"] == 0


# ------------------------------------------------------------ roofline --

def _record(mesh="mesh16x16"):
    return {"arch": "qwen3-8b", "shape": "train_4k", "mesh": mesh,
            "kind": "train", "supported": True, "ok": True,
            "model_flops": 4.0e16,
            "full": {"flops": 2.0e14, "bytes": 9.0e11,
                     "collectives": {"total": 3.0e10, "count": 5},
                     "memory": {"argument": 3.0e9, "temp": 5.0e9,
                                "output": 1.0e9, "alias": 2.0e9}},
            "corrected": {"flops": 2.5e14, "bytes": 8.0e11, "coll": 3.5e10}}


def test_roofline_analyze_matches_reference(monkeypatch):
    monkeypatch.setattr(jax_roofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jax_roofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jax_roofline, "ICI_BW", roofline.NVLINK_BW)
    monkeypatch.setattr(jax_roofline, "CHIPS", roofline.CHIPS)
    for rec in (_record(), dict(_record(), corrected=None),
                dict(_record(), mesh="mesh2x16x16")):
        got, want = roofline.analyze(rec), jax_roofline.analyze(rec)
        resident = want.pop("mem_resident_gb") * 1e9
        assert got.pop("fits_hbm80") == (resident <= 80e9)
        del want["fits_hbm16"]
        assert got.pop("mem_resident_gb") * 1e9 == pytest.approx(resident)
        assert got == want
    assert roofline.analyze({"ok": False}) is None
    one = dict(_record("mesh1x1"), chips=1)
    assert roofline.analyze(one)["hlo_flops_total"] == 2.5e14


# --------------------------------------------------------- collectives --

def test_ring_formulas_match_reference_parser():
    ref = parse_collectives(HLO_SAMPLE)
    ours = [CollectiveOp(c.op, c.result_bytes, c.operand_bytes,
                         c.group_size) for c in ref]
    assert [c.wire_bytes for c in ours] == [c.wire_bytes for c in ref]
    from repro.utils.hlo import collective_wire_bytes as ref_totals
    assert collective_wire_bytes(ours) == ref_totals(HLO_SAMPLE)
    # all-to-all and a group of one, which the sample has not
    assert CollectiveOp("all-to-all", 8, 64, 4).wire_bytes == 48.0
    assert CollectiveOp("all-reduce", 8, 8, 1).wire_bytes == 0.0


@pytest.mark.parametrize("n_data", [1, 2])
def test_split_step_collectives_by_hand(n_data):
    """A (n_data, 2) mesh splitting each sequence over ``model``: ``w``
    sharded over model (gathered, its gradient reduce-scattered over
    model, all-reduced over data), ``b`` replicated (its gradient
    all-reduced over both), two attention layers' K/V gathered twice and
    reduced once over model, the loss all-reduced over both."""
    mesh = AbstractMesh((n_data, 2), ("data", "model"))
    specs = {"w": (None, "model"), "b": ()}
    batch = ["data"] if n_data > 1 else []
    ops = step_collectives(mesh, specs, {"w": 4096, "b": 64}, batch,
                           seq_axes=("model",), attn_layers=2,
                           kv_bytes=1024)
    kinds = sorted((c.op, c.computation, c.group_size) for c in ops)
    want = [("all-gather", "attn0.kv", 2), ("all-gather", "attn0.kv (remat)",
                                            2),
            ("all-gather", "attn1.kv", 2), ("all-gather", "attn1.kv (remat)",
                                            2),
            ("all-gather", "w", 2), ("all-reduce", "b", 2 * n_data),
            ("all-reduce", "loss", 2 * n_data),
            ("reduce-scatter", "attn0.dkv", 2),
            ("reduce-scatter", "attn1.dkv", 2), ("reduce-scatter", "w", 2)]
    if n_data > 1:
        want.append(("all-reduce", "w", 2))
    assert kinds == sorted(want)
    totals = collective_wire_bytes(ops)
    ring = (2 * n_data - 1) / (2 * n_data)
    assert totals["all-gather"] == (4 * 1024 + 4096) / 2
    assert totals["reduce-scatter"] == (2 * 1024 + 4096) / 2
    assert totals["all-reduce"] == 2 * (64 + 4) * ring + (
        2 * 2048 / 2 if n_data > 1 else 0)


def test_split_train_cell_traces_one_rank():
    """A train cell split over model = 2 traces one rank's block: half the
    one-card FLOPs (every matmul per token, the plain attention's scores
    S/2 x S), activations between half and all of the one card's (the
    gathered K/V are the whole sequence's)."""
    cfg = get_config("qwen3-8b").scaled(dtype="float32", n_layers=2)
    shape = ShapeConfig("t", "train", 64, 4)
    one = dryrun.trace_cell(cfg, shape, dryrun.build_policy(M11, "train",
                                                            "t"), accum=1)
    m12 = AbstractMesh((1, 2), ("data", "model"))
    split = dryrun.trace_cell(cfg, shape, dryrun.build_policy(m12, "train",
                                                              "t"), accum=1)
    assert split["flops"] == one["flops"] / 2
    assert one["act"] / 2 < split["act"] < one["act"]
    assert one["bytes"] / 2 < split["bytes"] < one["bytes"]


def test_step_collectives_by_hand():
    mesh = AbstractMesh((4, 1), ("data", "model"))
    specs = {"w": ("data",), "b": ()}
    ops = step_collectives(mesh, specs, {"w": 4096, "b": 64}, ["data"])
    kinds = sorted((c.op, c.computation) for c in ops)
    assert kinds == [("all-gather", "w"), ("all-reduce", "b"),
                     ("all-reduce", "loss"), ("reduce-scatter", "w")]
    totals = collective_wire_bytes(ops)
    assert totals["all-gather"] == 4096 * 3 / 4
    assert totals["reduce-scatter"] == 4096 * 3 / 4
    assert totals["all-reduce"] == 2 * (64 + 4) * 3 / 4


# ----------------------------------------------------------------- CLIs --

def test_dryrun_and_roofline_clis(tmp_path, capsys):
    out = tmp_path / "dry"
    assert dryrun.main(["--arch", "qwen3-8b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    rec = json.loads((out / "qwen3-8b__long_500k__mesh16x16.json")
                     .read_text())
    assert rec["supported"] is False
    assert rec["skip_reason"] == cell_supported(get_config("qwen3-8b"),
                                                SHAPES["long_500k"])[1]
    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=2)
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=1024)
    rec = dryrun.run_cell("qwen3-8b", "decode_32k", dryrun.make_production_mesh(
        abstract=True), cfg=cfg, shape=shape, out_dir=str(out))
    assert rec["ok"], rec.get("traceback")
    for key in ("arch", "shape", "mesh", "kind", "supported", "params_total",
                "params_active", "model_flops", "full", "variants",
                "corrected", "ok"):
        assert key in rec
    assert set(rec["full"]) == {"flops", "bytes", "collectives", "memory"}
    assert {"argument", "temp", "output", "alias"} <= set(
        rec["full"]["memory"])
    capsys.readouterr()
    roofline.main([str(out), "--json", str(tmp_path / "rows.json")])
    table = capsys.readouterr().out
    assert "qwen3-8b" in table and "SKIP" in table
    rows = json.loads((tmp_path / "rows.json").read_text())
    assert {r["shape"] for r in rows} == {"decode_32k", "long_500k"}
    decode = next(r for r in rows if r["shape"] == "decode_32k")
    assert decode["fits_hbm80"] and decode["dominant"] == "memory"

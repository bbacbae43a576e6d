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
  variants' max; the direct trace's FLOPs, kept activations and largest
  saved set (or tensor) the values the unfused byte counter's trace gave
  (the fused count, `launch/traffic.py`, changes the bytes only);
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
  cell traced as one rank (half the FLOPs, its activations); the split's
  per-layer gathers and reduce-scatters (K/V, the recurrent families'
  token shifts and scan states) against the ones a traced rank counts;
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

# the direct trace of each arch's CELLS above, counted by the unfused
# rule: (FLOPs, act, peak) per kind
PINNED = {
    "deepseek-coder-33b": {"train": (283115520, 272718, 574464),
                           "prefill": (26935296, 0, 51200),
                           "decode": (753664, 0, 12288)},
    "deepseek-v2-lite-16b": {"train": (3596746752, 272718, 17200512),
                             "prefill": (371941376, 0, 3502080),
                             "decode": (9702400, 0, 131072)},
    "llava-next-34b": {"train": (283115520, 272590, 574464),
                       "prefill": (26935296, 0, 51200),
                       "decode": (753664, 0, 12288)},
    "mixtral-8x22b": {"train": (322437120, 272718, 1224848),
                      "prefill": (31031296, 0, 131072),
                      "decode": (1118208, 0, 131072)},
    "qwen2-72b": {"train": (283115520, 272718, 574464),
                  "prefill": (26935296, 0, 51200),
                  "decode": (753664, 0, 12288)},
    "qwen2.5-32b": {"train": (283115520, 272718, 574464),
                    "prefill": (26935296, 0, 51200),
                    "decode": (753664, 0, 12288)},
    "qwen3-8b": {"train": (283115520, 272718, 650496),
                 "prefill": (26935296, 0, 51200),
                 "decode": (753664, 0, 12288)},
    "rwkv6-3b": {"train": (489160704, 272718, 1963008),
                 "prefill": (49610752, 0, 131072),
                 "decode": (1261568, 0, 8192)},
    "seamless-m4t-medium": {"train": (557842432, 387662, 748416),
                            "prefill": (59441152, 0, 51200),
                            "decode": (1015808, 0, 24576)},
    "zamba2-7b": {"train": (651165696, 248142, 2358536),
                  "prefill": (67158016, 0, 93440),
                  "decode": (1632256, 0, 24576)},
}


@pytest.mark.parametrize("arch", list_archs())
def test_variant_extrapolation_equals_full_depth_trace(arch):
    cfg = _reduced(arch)
    if cfg.n_patches:
        cfg = dataclasses.replace(cfg, n_patches=8)
    for shape in CELLS:
        policy = dryrun.build_policy(M11, shape.kind, shape.name)
        direct = dryrun.trace_cell(cfg, shape, policy, accum=2)
        assert (direct["flops"], direct["act"], direct["peak"]) == \
            PINNED[arch][shape.kind], (arch, shape.kind)
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
    specs, summed by hand; on (16, 16) the split step's whole copies:
    each layer's leaves (``stack0.<layer>.*``) gathered in its forward
    and its re-run with its whole gradient, the final norm whole all
    step, the vocab-sharded table and head never whole."""
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
        layers, norm = {}, (0, 0)
        for name, dims in leaves:
            spec = policy.param_spec(axes[name], dims)
            local = sharding.local_shape(mesh, spec, dims)
            n_full += torch.Size(dims).numel()
            n_local += torch.Size(local).numel()
            if name.startswith("stack0."):
                layer = layers.setdefault(name.split(".")[1], [0, 0])
                layer[0] += torch.Size(dims).numel()
                layer[1] += torch.Size(local).numel()
            elif name == "final_norm":
                norm = torch.Size(dims).numel() - torch.Size(local).numel()
                norm = (torch.Size(dims).numel(), norm)
        assert got["params"] == 2 * n_local and got["opt"] == 12 * n_local
        if k == 1:                      # the leaves' own gradients
            assert got["grads"] == 2 * 2 * n_full  # with the accumulator
            assert got["gathered"] == 0
        else:
            assert len(layers) == 3 and policy.param_spec(
                axes["lm_head"], (64, cfg.vocab_size))[1] == "model"
            l_full, l_local = max(layers.values())
            assert got["grads"] == 2 * (2 * n_local + l_full + norm[0])
            assert got["gathered"] == 2 * (2 * (l_full - l_local) + norm[1])
            # below the whole model less its shards
            assert got["gathered"] < 2 * (n_full - n_local)
        assert got["batch"] == 64 // 4 // k * 64 * 4
        coll = got["collectives"]
        if k == 1:
            assert n_local == n_full and coll["total"] == 0
        else:
            assert n_local < n_full and coll["count"] > 0
            # each sequence split over model: per layer, the K/V of the
            # card's row (64 tokens x 2 KV heads x 2·16, bf16) gathered
            # twice (forward, remat) and its gradient reduce-scattered
            # once; each layer's leaves gathered once more (the re-run)
            # than their gradients are reduce-scattered; the
            # vocab-sharded embedding and loss over the card's row (64
            # int64 ids, 64 rows of 64 bf16): the ids and targets, the
            # embedding's gradient and the normed rows gathered, the
            # embedding's rows and the rows' gradient reduce-scattered
            attn = 3 * (64 * 2 * 32 * 2) * 15 / 16
            again = sum(2 * (f - m) for f, m in layers.values())
            ids, rows = 64 * 8, 64 * 64 * 2
            assert coll["all-gather"] - 2 * attn - again - (
                2 * ids + 2 * rows) * 15 / 16 == pytest.approx(
                coll["reduce-scatter"] - attn - 2 * rows * 15 / 16)


@pytest.mark.parametrize("arch,layers", [("mixtral-8x22b", 1),
                                         ("deepseek-v2-lite-16b", 3)])
def test_split_moe_state_bytes_keep_the_experts(arch, layers):
    """Full width, cut depth, ``train_4k``'s 4,096 tokens, batch 1, on
    (1, 2), as phase 29c's dry run: the experts' dim 0 is sharded over
    ``model``, which splits the sequence, so each rank keeps its experts
    and ``gathered`` holds the largest layer's other leaves less their
    shards (twice) and the final norm less its shard, by hand; the
    collectives gather no expert leaf, and each MoE layer's rows
    [1, 4,096, d_model] bf16 are gathered three times (the forward, the
    re-run, the outputs' gradient) and reduce-scattered twice (their
    gradient, the outputs)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    shape = ShapeConfig("train_4k", "train", 4096, 1)
    mesh = AbstractMesh((1, 2), ("data", "model"))
    policy = dryrun.build_policy(mesh, "train", "train_4k")
    got = dryrun.state_bytes(cfg, shape, policy, accum=1)
    model = build_model(cfg)
    with FakeTensorMode():
        leaves = [(n, tuple(p.shape)) for n, p in model.init(
            torch.Generator().manual_seed(0)).named_parameters()]
    axes = sharding.axes_by_path(model.param_axes())
    units, norm, experts, shards, ops = {}, (0, 0), 0, 0, 0
    for name, dims in leaves:
        spec = policy.param_spec(axes[name], dims)
        full = 2 * torch.Size(dims).numel()
        local = 2 * torch.Size(sharding.local_shape(mesh, spec,
                                                     dims)).numel()
        shards += local
        if name in ("embed", "lm_head"):         # vocab-sharded: no ops
            continue
        if name.split(".")[-2:-1] == ["moe"] and name.endswith(
                (".wg", ".wu", ".wd")):
            assert spec[0] == "model"             # E divides over 2
            experts += full
            full = local                # kept: no ops, no whole copy
        else:
            # over model: gathered (twice in a layer) and reduce-scattered;
            # else all-reduced
            ops += (2 if name.startswith("stack") else 1) + 1 \
                if "model" in sharding.spec_axes(spec) else 1
        if name.startswith("stack"):
            unit = units.setdefault(".".join(name.split(".")[:2]), [0, 0])
            unit[0] += full
            unit[1] += local
        else:
            assert name == "final_norm"
            norm = (full, local)
    l_full, l_local = max(units.values())
    assert got["params"] == shards
    assert got["gathered"] == 2 * (l_full - l_local) + norm[0] - norm[1]
    assert got["grads"] == shards + l_full + norm[0]
    # the experts are most of a MoE layer's bytes (96 % of mixtral's
    # layer, 93 % of deepseek's at 7 layers), now never made whole
    assert 0 < got["gathered"] < 0.1 * experts
    # per layer the attention's K/V (3 ops), per MoE layer its rows (5:
    # gathered in the forward and the re-run, the outputs reduce-scattered
    # once, each mirrored in the backward), the vocab ops (8)
    moe = cfg.n_layers - cfg.first_dense_layers
    coll = got["collectives"]
    assert coll["count"] == ops + 3 * cfg.n_layers + 5 * moe + 8
    rows = 4096 * cfg.d_model * 2            # [1, 4,096, d_model] bf16
    plain = dryrun.state_bytes(dataclasses.replace(cfg, n_experts=3),
                               shape, policy, accum=1)["collectives"]
    assert coll["reduce-scatter"] >= 2 * moe * rows / 2 and plain[
        "reduce-scatter"] > coll["reduce-scatter"] - 2 * moe * rows / 2


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
    """A (n_data, 2) mesh splitting each sequence over ``model``: ``w``, a
    layer's leaf sharded over model (gathered in the layer's forward and
    again in its re-run, its gradient reduce-scattered over model once,
    all-reduced over data), ``b`` replicated (its gradient all-reduced
    over both), ``head`` vocab-sharded over model (no gather or reduction
    over model; its gradient all-reduced over data), two attention
    layers' K/V gathered twice and reduced once over model; the
    vocab-sharded embedding's and loss's collectives over model (the
    tokens and targets gathered, the embedding's rows reduce-scattered
    and their gradient gathered, the normed rows gathered and their
    gradient reduce-scattered, the rows' maxima and sums all-reduced);
    the loss all-reduced over data alone."""
    mesh = AbstractMesh((n_data, 2), ("data", "model"))
    specs = {"w": (None, "model"), "b": (), "head": (None, "model")}
    batch = ["data"] if n_data > 1 else []
    vocab = {"axis": "model", "leaves": ("head",), "rows": 512,
             "tokens": 64, "stats": 32}
    ops = step_collectives(mesh, specs, {"w": 4096, "b": 64, "head": 256},
                           batch, seq_axes=("model",), attn_layers=2,
                           kv_bytes=1024, layer_leaves={"w"}, vocab=vocab)
    kinds = sorted((c.op, c.computation, c.group_size) for c in ops)
    want = [("all-gather", "attn0.kv", 2), ("all-gather", "attn0.kv (remat)",
                                            2),
            ("all-gather", "attn1.kv", 2), ("all-gather", "attn1.kv (remat)",
                                            2),
            ("all-gather", "w", 2), ("all-gather", "w (remat)", 2),
            ("all-reduce", "b", 2 * n_data),
            ("reduce-scatter", "attn0.dkv", 2),
            ("reduce-scatter", "attn1.dkv", 2), ("reduce-scatter", "w", 2),
            ("all-gather", "embed.tokens", 2),
            ("reduce-scatter", "embed.rows", 2),
            ("all-gather", "embed.drows", 2), ("all-gather", "head.rows", 2),
            ("reduce-scatter", "head.drows", 2),
            ("all-gather", "head.targets", 2), ("all-reduce", "head.max", 2),
            ("all-reduce", "head.sums", 2)]
    if n_data > 1:
        want += [("all-reduce", "w", 2), ("all-reduce", "head", 2),
                 ("all-reduce", "loss", 2)]
    assert kinds == sorted(want)
    totals = collective_wire_bytes(ops)
    ring = (2 * n_data - 1) / (2 * n_data)
    assert totals["all-gather"] == (4 * 1024 + 2 * 4096 + 2 * 64
                                    + 2 * 512) / 2
    assert totals["reduce-scatter"] == (2 * 1024 + 4096 + 2 * 512) / 2
    assert totals["all-reduce"] == 2 * 64 * ring + 32 + 64 + (
        2 * 2048 / 2 + 128 + 4 if n_data > 1 else 0)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b", "qwen3-8b",
                                  "mixtral-8x22b", "deepseek-v2-lite-16b",
                                  "llava-next-34b", "seamless-m4t-medium"])
def test_split_collectives_match_the_counted_step(arch):
    """A train cell split over model = 2: the plan's per-layer gathers
    (`dryrun.split_halos`: the K/V or MLA's latent, the recurrent halos,
    the MoE's pair counts where the experts do not divide over the ranks,
    the encoder's K/V and the cross K/V over a block of frames;
    `dryrun.split_tokens`: the MoE's rows gathered to each rank's experts
    and the outputs reduce-scattered back where they do) are the ones
    one rank's traced step issues (`seq_parallel.collective_counts`; the
    trace runs each layer once, so the plan's re-run gathers are not in
    it), each reduce-scatter of the plan one of the step's (the counts
    have none), and the bytes a layer by hand."""
    from repro_torch.distributed import seq_parallel

    base = _reduced(arch)
    shape = ShapeConfig("t", "train", 64, 4)
    mesh = AbstractMesh((1, 2), ("data", "model"))
    policy = dryrun.build_policy(mesh, "train", "t")
    # an MoE model's 4 experts divide over 2 ranks (each keeps its own and
    # the rows come to them); 3 do not (the counts path)
    for cfg in [base] + ([dataclasses.replace(base, n_experts=3)]
                         if base.is_moe else []):
        kept = cfg.is_moe and cfg.n_experts % 2 == 0
        seq_parallel.reset_collective_counts()
        dryrun.trace_cell(cfg, shape, policy, accum=1)
        counted = seq_parallel.collective_counts()
        attn_layers, halos, counts = dryrun.split_halos(cfg, 4, 2, kept)
        tokens = dryrun.split_tokens(cfg, 4, 64) if kept else {}
        ops = step_collectives(mesh, {}, {}, [], seq_axes=("model",),
                               attn_layers=attn_layers, kv_bytes=1024,
                               halos=halos, counts=counts, tokens=tokens)
        gathers = [c for c in ops if c.op == "all-gather"]
        assert counted == {
            "all_gather": sum("(remat)" not in c.computation
                              for c in gathers),
            "reduce_scatter": sum(c.op == "reduce-scatter" for c in ops),
            "all_reduce": 0}
        # the re-run repeats every forward gather; the backward's gather of
        # the MoE outputs' gradient has no twin
        remat = [c for c in gathers if "(remat)" in c.computation]
        assert len(remat) == counted["all_gather"] - len(tokens) > 0
        moe_layers = [f"moe{i}" for i in range(cfg.first_dense_layers,
                                                 cfg.n_layers)] \
            if cfg.is_moe else []
        if kept:          # the card's rows [B, S, D] a layer, float32
            assert counts == {} and list(tokens) == [
                f"{n}.rows" for n in moe_layers]
            assert set(tokens.values()) == {4 * 64 * cfg.d_model * 4}
            assert sorted(c.computation for c in ops
                          if c.op == "reduce-scatter" and "rows" in
                          c.computation) == sorted(
                x for n in moe_layers for x in (f"d{n}.rows",
                                                f"{n}.rows.out"))
        elif cfg.is_moe:  # [B, E] int64 a layer past the dense ones
            assert list(counts) == [f"{n}.counts" for n in moe_layers]
            assert set(counts.values()) == {4 * cfg.n_experts * 8}
            assert not [c for c in ops if c.op == "reduce-scatter"
                        and "counts" in c.computation]
        else:
            assert counts == {} and tokens == {}
    cfg = base
    h, ds = cfg.ssm_heads, cfg.ssm_state
    if arch == "rwkv6-3b":       # [B, H, dk, dk] and [B, H, dk], float32
        assert halos["rwkv0.state"] == 4 * h * (ds * ds + ds) * 4
        assert halos["rwkv0.shift_t"] == 4 * cfg.d_model * 4
    elif arch == "zamba2-7b":    # [B, H, hd, ds] and [B, H], float32
        hd = 2 * cfg.d_model // h
        assert halos["mamba0.state"] == 4 * h * (hd * ds + 1) * 4
        assert halos["mamba0.conv"] == 4 * 3 * 2 * cfg.d_model * 4
        assert attn_layers == cfg.n_layers // cfg.attn_every
    elif cfg.is_encdec:          # K and V [B, src_len / 2, Hkv, hd]
        frames = 4 * (cfg.src_len // 2) * 2 * cfg.n_kv_heads * cfg.hd * 4
        assert halos == {**{f"enc{i}.kv": frames
                            for i in range(cfg.enc_layers)},
                         **{f"cross{i}.kv": frames
                            for i in range(cfg.n_layers)}}
        assert attn_layers == cfg.n_layers
    else:
        assert halos == {} and attn_layers == cfg.n_layers
    # the bytes an attention layer's gather makes whole: K/V, or the latent
    width = (cfg.kv_lora_rank + cfg.qk_rope_dim if cfg.attn_kind == "mla"
             else 2 * cfg.n_kv_heads * cfg.hd)
    assert dryrun.split_kv_bytes(cfg, 4, 64) == 4 * 64 * width * 4


@pytest.mark.parametrize("arch", ["qwen3-8b", "seamless-m4t-medium"])
def test_split_train_cell_traces_one_rank(arch):
    """A train cell split over model = 2 traces one rank's block: half the
    one-card FLOPs (every matmul per token, the plain attention's scores
    S/2 x S; seamless's frames split beside its tokens), activations
    between half and all of the one card's (the gathered K/V are the
    whole sequence's)."""
    cfg = get_config(arch).scaled(dtype="float32", n_layers=2)
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

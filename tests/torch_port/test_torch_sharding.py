"""The port's configs, logical-axes tables, sharding policy, meshes,
elastic re-placement, layer loops and the launcher's policy path against the
JAX package's, on the CPU.

Checked:

* ``ModelConfig.subquadratic`` / ``has_decode`` and ``cell_supported``
  (flag and reason) for all ten archs x the four ``SHAPES``, and the
  configs package's exports;
* every parameter leaf's logical axes equal the reference's through the
  carry's unstacking (its ``layers`` / ``groups`` prefixes dropped, one
  table per layer), and each table names exactly the ``ParamTree``'s
  leaves with one name a dim; ``cache_axes`` mirrors ``init_cache`` and
  ``input_specs`` the reference's;
* every arch's resolved ``param_spec`` / ``act_spec`` of each leaf at its
  full width, under the training and the decode rule sets, at meshes
  (1,1), (2,2), (16,16) and (2,16,16), equal to the reference's (driven
  through a ``SimpleNamespace(shape=...)`` mesh, as
  ``tests/test_sharding.py`` does), and their DTensor placements;
* ``remesh``'s factorization for n = 1..16 against the reference's, run
  in a subprocess with 16 forced host devices; a one-rank mesh and
  ``reshard_state`` placing a state as DTensors and back bit for bit;
* ``layer_scan``, ``indexed_layer_loop`` and ``chunk_scan_checkpointed``
  (segments, the short and the ragged fallback) against the reference's:
  outputs and gradients on one step function;
* ``launch/train.py``'s policy path in two gloo processes (reduced
  qwen3-8b, its mesh built as (2, 1) in place of the launcher's (1, 2),
  3 steps): each step's loss and gradient norm within 1e-6 relative of
  the one-process run, its parameters sharded, and gathered after the 3
  steps within 1e-4 of the one-process run's, at most 1 element in
  10,000 past 1e-6 (the (1, 2) and (2, 2) meshes the launcher builds are
  held in ``test_torch_seq_parallel.py``).
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.distributed import sharding as jax_sharding  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.models import scan_config as jax_scan  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import SHAPES, cell_supported, get_config  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.elastic import (mesh_factors,  # noqa: E402
                                             reshard_state)
from repro_torch.launch.mesh import AbstractMesh, make_local_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import scan_config  # noqa: E402
from repro_torch.models.registry import (TensorSpec, cache_axes,  # noqa: E402
                                         decode_state_specs, input_specs)

ROOT = Path(__file__).resolve().parents[2]
ARCHS = sorted(configs.ARCHS)
MESHES = [{"data": 1, "model": 1}, {"data": 2, "model": 2},
          {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]
RULE_SETS = {"train": ("TRAIN_RULES", "TRAIN_PARAM_RULES"),
             "decode": ("DECODE_RULES", "DECODE_PARAM_RULES")}
_STACKED = ("layers", "tail", "encoder", "decoder")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------- configs --

@pytest.mark.parametrize("arch", ARCHS)
def test_config_properties_and_cells_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_configs.get_config(arch)
    assert cfg.subquadratic == jcfg.subquadratic
    assert cfg.has_decode == jcfg.has_decode
    for name in SHAPES:
        assert SHAPES[name] == SHAPES[name].__class__(
            **dataclasses.asdict(JAX_SHAPES[name]))
        assert cell_supported(cfg, SHAPES[name]) == \
            jax_configs.cell_supported(jcfg, JAX_SHAPES[name])


def test_config_package_exports_match_reference():
    assert sorted(configs.__all__) == sorted(jax_configs.__all__)
    assert [cell_supported(get_config(a), SHAPES["long_500k"])[0]
            for a in ARCHS].count(True) == 3   # rwkv6, mixtral, zamba2


# ------------------------------------------------------- axes tables --

def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def _drop(axes: str, prefix: tuple) -> str:
    words = axes.split()
    assert tuple(words[:len(prefix)]) == prefix, (axes, prefix)
    return " ".join(words[len(prefix):])


def _leading(tree, depth=1) -> tuple:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tuple(tree.shape[:depth])


def unstacked_reference_axes(ref_axes: dict, ref_shapes: dict) -> dict:
    """The reference's table in the port's layout: the carry's unstacking
    (`repro_torch.models.carry`) applied to the axes strings."""
    out = {}
    for key, sub in ref_axes.items():
        if key.startswith("stack") or key in _STACKED:
            (n,) = _leading(ref_shapes[key])
            for i in range(n):
                for path, ax in _flat(sub).items():
                    out[f"{key}.{i}.{path}"] = _drop(ax, ("layers",))
        elif key == "groups":
            g, per = _leading(ref_shapes[key], 2)
            for i in range(g):
                for j in range(per):
                    for path, ax in _flat(sub).items():
                        out[f"{key}.{i}.{j}.{path}"] = _drop(
                            ax, ("groups", "layers"))
        elif key == "shared":
            for path, ax in _flat(sub["block"]).items():
                out[f"shared.block.{path}"] = ax
            (g,) = _leading(ref_shapes["shared"]["lora"])
            for i in range(g):
                for path, ax in _flat(sub["lora"]).items():
                    out[f"shared.lora.{i}.{path}"] = _drop(ax, ("groups",))
        else:
            assert isinstance(sub, str), key
            out[key] = sub
    return out


def reference_shapes(jcfg) -> dict:
    jm = jax_build_model(jcfg)
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0)), jm


def _cases():
    for arch in ARCHS:
        yield arch, {}
    yield "zamba2-7b", {"n_layers": 5}          # a tail layer


@pytest.mark.parametrize("arch,over", list(_cases()),
                         ids=[*ARCHS, "zamba2-7b-tail"])
def test_param_axes_match_reference(arch, over):
    """At the reduced width (the tree built), and the table alone at the
    full config."""
    for full in (False, True):
        cfg = get_config(arch)
        jcfg = jax_configs.get_config(arch)
        if not full:
            cfg = cfg.scaled(dtype="float32", **over)
            jcfg = jcfg.scaled(dtype="float32", **over)
        shapes, jm = reference_shapes(jcfg)
        model = build_model(cfg)
        table = _flat(model.param_axes())
        assert table == unstacked_reference_axes(jm.param_axes(), shapes)
        assert sharding.axes_by_path(model.param_axes()) == {
            k: tuple(v.split()) for k, v in table.items()}
        if full:
            continue
        params = model.init(torch.Generator().manual_seed(0))
        leaves = dict(params.named_parameters())
        assert set(leaves) == set(table)
        assert all(len(table[n].split()) == p.ndim
                   for n, p in leaves.items())


def _leaves(tree, prefix=""):
    """{path: leaf}: a list's index (a layer's) left out of the path, a
    tuple's (a layer state's slot) and a dict's key kept, so that a port
    leaf's path is the reference's stacked leaf's."""
    if isinstance(tree, dict):
        items = [(f"{k}.", v) for k, v in tree.items()]
    elif isinstance(tree, list):
        items = [("", v) for v in tree]
    elif isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        items = [(f"{i}.", v) for i, v in enumerate(tree)]
    else:
        return [(prefix[:-1], tree)]
    return [leaf for key, v in items for leaf in _leaves(v, prefix + key)]


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_match_reference(arch):
    cfg = get_config(arch).scaled(dtype="float32")
    jcfg = jax_configs.get_config(arch).scaled(dtype="float32")
    model, jm = build_model(cfg), jax_build_model(jcfg)
    for name, shape in SHAPES.items():
        got = input_specs(cfg, shape)
        want = jax_registry.input_specs(jcfg, JAX_SHAPES[name])
        assert list(got) == list(want)
        for k in got:
            assert got[k].shape == tuple(want[k].shape)
            assert str(got[k].dtype) == f"torch.{want[k].dtype}"
    small = dataclasses.replace(SHAPES["decode_32k"], seq_len=64,
                                global_batch=2)
    specs, tok = decode_state_specs(model, small)
    assert tok == TensorSpec((2,), torch.int32)
    jspecs, _ = jax_registry.decode_state_specs(
        jm, JAX_SHAPES["decode_32k"].__class__("d", "decode", 64, 2))
    jaxes = dict(_leaves(jax_registry.cache_axes(jm)))
    want = {path: (tuple(spec.shape), jaxes[path].split(), str(spec.dtype))
            for path, spec in _leaves(jspecs)}
    assert set(jaxes) == set(want)
    axes_of = dict(_leaves(cache_axes(model)))
    got = _leaves(specs)
    assert {p for p, _ in got} == set(want) == set(axes_of)
    for path, spec in got:
        axes = axes_of[path]
        shape, jaxes, dtype = want[path]
        lead = len(shape) - len(spec.shape)     # the stacked dims
        assert shape[lead:] == spec.shape, path
        assert jaxes[lead:] == axes.split(), path
        assert {"layers", "groups"} >= set(jaxes[:lead]), path
        assert str(spec.dtype) == f"torch.{dtype}", path


# ------------------------------------------------------ the policy --

def _leaf_cases(arch):
    """[(path, logical axes, full-width dims)] of every parameter leaf."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    model = build_model(get_config(arch))
    axes = sharding.axes_by_path(model.param_axes())
    with FakeTensorMode():
        params = model.init(torch.Generator().manual_seed(0))
        return [(n, axes[n], tuple(p.shape))
                for n, p in params.named_parameters()]


@pytest.mark.parametrize("arch", ARCHS)
def test_resolved_specs_match_reference(arch):
    leaves = _leaf_cases(arch)
    cfg = get_config(arch)
    acts = [(("batch", "seq"), (256, 4096)),
            (("batch", "seq", "embed"), (32, 32768, cfg.d_model)),
            (("batch", "cache_seq", "kv_heads", "head_dim"),
             (128, 32768, cfg.n_kv_heads, cfg.hd)),
            (("batch",), (1,))]
    for shape in MESHES:
        for acts_name, params_name in RULE_SETS.values():
            port = sharding.ShardingPolicy(
                AbstractMesh(tuple(shape.values()), tuple(shape)),
                acts=dict(getattr(sharding, acts_name)),
                params=dict(getattr(sharding, params_name)))
            ref = jax_sharding.ShardingPolicy(
                SimpleNamespace(shape=dict(shape)),
                acts=dict(getattr(jax_sharding, acts_name)),
                params=dict(getattr(jax_sharding, params_name)))
            for name, axes, dims in leaves:
                want = tuple(ref.param_spec(axes, dims))
                assert port.param_spec(axes, dims) == want, (name, shape)
                assert port.act_spec(axes, dims) == \
                    tuple(ref.act_spec(axes, dims)), (name, shape)
                pl = sharding.placements(port.mesh, want)
                by_axis = sharding.spec_axes(want)
                for a, p in zip(shape, pl):
                    if a in by_axis and shape[a] > 1:
                        assert p.is_shard(by_axis[a]), (name, a, p)
                    else:
                        assert p.is_replicate(), (name, a, p)
                local = sharding.local_shape(port.mesh, want, dims)
                assert all(d % l == 0 for d, l in zip(dims, local))
            for axes, dims in acts:
                assert port.act_spec(axes, dims) == \
                    tuple(ref.act_spec(axes, dims)), (axes, shape)


def test_policy_helpers():
    mesh = AbstractMesh((2, 4), ("data", "model"))
    p = sharding.ShardingPolicy(mesh, acts=dict(sharding.TRAIN_RULES),
                                params=dict(sharding.TRAIN_PARAM_RULES))
    q = p.with_rules(params={"embed": None})
    assert p.param_spec(("embed", "ff"), (64, 128)) == ("data", "model")
    assert q.param_spec(("embed", "ff"), (64, 128)) == (None, "model")
    assert p.params["embed"] == "data"
    assert sharding.current_policy() is None
    x = torch.zeros(2, 3)
    assert sharding.shard(x, "batch") is x          # no policy: no check
    with sharding.apply_policy(p):
        assert sharding.current_policy() is p
        assert sharding.shard(x, "batch", "embed") is x
        with pytest.raises(ValueError):
            sharding.shard(x, "batch")
    assert sharding.current_policy() is None


# ----------------------------------------------- meshes and elastic --

def test_remesh_factorization_matches_reference():
    code = ("from repro.distributed.elastic import remesh; import json; "
            "print(json.dumps([list(remesh(n).shape.values()) "
            "for n in range(1, 17)]))")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=16",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    want = [tuple(x) for x in json.loads(out.stdout.strip().splitlines()[-1])]
    assert [mesh_factors(n) for n in range(1, 17)] == want
    # the reference's first-found-on-a-tie and its -1.0 floor, kept
    assert mesh_factors(14) == (1, 14)
    assert mesh_factors(2, data_model_ratio=2) == (2, 1)


@pytest.fixture
def one_rank():
    import torch.distributed as dist

    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_one_rank_mesh_and_reshard_state(one_rank):
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.elastic import remesh
    from repro_torch.training.loop import gathered
    from repro_torch.utils.tree import tree_leaves

    mesh = remesh(1, device_type="cpu")
    assert tuple(mesh.shape) == (1, 1)
    assert mesh.mesh_dim_names == ("data", "model")
    assert make_local_mesh(1, 1, "cpu").mesh_dim_names == ("data", "model")
    cfg = get_config("qwen3-8b").scaled(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    placed = reshard_state(params, model.param_axes(), mesh,
                           sharding.TRAIN_RULES, sharding.TRAIN_PARAM_RULES)
    assert all(isinstance(p, DTensor) and all(
        q.is_replicate() for q in p.placements) for p in tree_leaves(placed))
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(gathered(placed)), tree_leaves(params)))


# -------------------------------------------------------- layer loops --

def _step_fns(w):
    def jstep(state, x):
        new = jnp.tanh(state @ jnp.asarray(w) + x["a"]) * x["b"]
        return new, {"y": new * 2.0, "z": jnp.sum(new)}

    def tstep(state, x):
        new = torch.tanh(state @ torch.from_numpy(w) + x["a"]) * x["b"]
        return new, {"y": new * 2.0, "z": torch.sum(new)}

    return jstep, tstep


@pytest.mark.parametrize("n", [32, 48, 20, 16])
def test_chunk_scan_checkpointed_matches_reference(n):
    """Two and three segments of 16, a ragged and a short scan (both run
    plain): the final state, the outputs and the gradients of their
    weighted sum by the initial state and the inputs."""
    rng = np.random.default_rng(n)
    w = (0.5 * rng.standard_normal((6, 6))).astype(np.float32)
    init = rng.standard_normal((3, 6)).astype(np.float32)
    xs = {"a": rng.standard_normal((n, 3, 6)).astype(np.float32),
          "b": (1 + 0.1 * rng.standard_normal((n, 3, 6))).astype(np.float32)}
    cy = rng.standard_normal((n, 3, 6)).astype(np.float32)
    jstep, tstep = _step_fns(w)

    def jloss(init, xs):
        final, ys = jax_scan.chunk_scan_checkpointed(jstep, init, xs, n)
        return (jnp.sum(final) + jnp.sum(ys["y"] * cy)
                + jnp.sum(ys["z"])), (final, ys)

    (jl, (jf, jys)), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(init, xs)
    t_init = torch.from_numpy(init).requires_grad_(True)
    t_xs = {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in xs.items()}
    final, ys = scan_config.chunk_scan_checkpointed(tstep, t_init, t_xs, n)
    loss = (final.sum() + (ys["y"] * torch.from_numpy(cy)).sum()
            + ys["z"].sum())
    grads = torch.autograd.grad(loss, [t_init, t_xs["a"], t_xs["b"]])
    close = lambda a, b: np.testing.assert_allclose(  # noqa: E731
        np.asarray(a.detach()), np.asarray(b), rtol=2e-5, atol=2e-5)
    close(final, jf)
    close(ys["y"], jys["y"])
    close(ys["z"], jys["z"])
    close(loss, jl)
    for got, want in zip(grads, (jg[0], jg[1]["a"], jg[1]["b"])):
        close(got, want)


def test_layer_scan_and_indexed_loop_match_reference():
    rng = np.random.default_rng(3)
    w = (0.5 * rng.standard_normal((4, 4))).astype(np.float32)
    init = rng.standard_normal((2, 4)).astype(np.float32)
    xs = {"a": rng.standard_normal((5, 2, 4)).astype(np.float32),
          "b": np.ones((5, 2, 4), np.float32)}
    jstep, tstep = _step_fns(w)
    jf, jys = jax_scan.layer_scan(jstep, init, xs)
    with scan_config.unrolled():
        tf, tys = scan_config.layer_scan(
            tstep, torch.from_numpy(init),
            {k: torch.from_numpy(v) for k, v in xs.items()})
    # float32 tanh and matmul of two libraries: a few ulps apart
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tys["y"].numpy(), np.asarray(jys["y"]),
                               rtol=1e-5, atol=1e-6)
    body_j = lambda i, c: c * 0.5 + i  # noqa: E731
    want = jax_scan.indexed_layer_loop(4, body_j, jnp.ones(3))
    got = scan_config.indexed_layer_loop(4, body_j, torch.ones(3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want))


# -------------------------------------------- the launcher's policy --

_WORKER = """
import functools, json, sys
import torch
torch.set_num_threads(1)
from torch.distributed.tensor import DTensor
from repro_torch.distributed.elastic import remesh
from repro_torch.launch import train
from repro_torch.training import loop
from repro_torch.utils.tree import tree_leaves
train.train_loop = functools.partial(loop.train_loop, log_every=1)
# the data-parallel (N, 1) mesh, where the launcher would build (1, N)
train.train_mesh = lambda cfg, n, device_type: remesh(
    n, data_model_ratio=n, device_type=device_type)
out = train.main(sys.argv[3:])
leaves = tree_leaves(out["params"])
torch.save([p.detach().clone() for p in tree_leaves(loop.gathered(
    out["params"]))], sys.argv[2])
json.dump({"losses": out["losses"], "grad_norms": out["grad_norms"],
           "sharded": sum(isinstance(p, DTensor) and any(
               q.is_shard() for q in p.placements) for p in leaves),
           "mesh": [list(p.device_mesh.shape) for p in leaves
                    if isinstance(p, DTensor)][:1]},
          open(sys.argv[1], "w"))
"""


def test_two_process_policy_training_matches_one_process(tmp_path):
    """``launch/train.py`` as ``torchrun --nproc-per-node 2`` starts it
    (WORLD_SIZE, RANK, MASTER_ADDR/PORT on localhost), gloo on the CPU,
    with its mesh built data-parallel, (2, 1), against one process: each
    step's loss and gradient norm (which a
    gradient summed over the ranks instead of averaged would double,
    though AdamW's update would not change) and every parameter gathered
    after 3 steps."""
    args = ["--arch", "qwen3-8b", "--smoke", "--steps", "3", "--batch", "4",
            "--seq-len", "32", "--device", "cpu"]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(tmp_path / f"r{r}.json"),
         str(tmp_path / f"r{r}.pt"), *args],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    single = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    single.pop("WORLD_SIZE", None)
    subprocess.run([sys.executable, "-c", _WORKER, str(tmp_path / "one.json"),
                    str(tmp_path / "one.pt"), *args], env=single, check=True,
                   timeout=240, capture_output=True)
    ranks = [json.loads((tmp_path / f"r{r}.json").read_text())
             for r in range(2)]
    one = json.loads((tmp_path / "one.json").read_text())
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert ranks[0]["grad_norms"] == ranks[1]["grad_norms"]
    assert ranks[0]["mesh"] == [[2, 1]] and ranks[0]["sharded"] > 0
    assert one["sharded"] == 0 and one["mesh"] == []
    for key in ("losses", "grad_norms"):
        assert [s for s, _ in ranks[0][key]] == [0, 1, 2]
        for (s2, x2), (s1, x1) in zip(ranks[0][key], one[key]):
            assert s1 == s2 and abs(x2 - x1) <= 1e-6 * abs(x1), (key, s1)
    placed = [torch.load(tmp_path / f"r{r}.pt") for r in range(2)]
    plain = torch.load(tmp_path / "one.pt")
    assert len(plain) == len(placed[0]) == len(placed[1])
    # Two ranks sum the batch's gradient in another order, and AdamW's
    # m / sqrt(v) turns that float32 noise, in an element whose gradient
    # is near 0, into a parameter difference (here 2 of 106,880 elements
    # past 1e-6, the largest 1.25e-5).  A shard updated wrongly or not at
    # all is off by about one update, the launcher's lr of 3e-3.
    diff = torch.cat([(a - c).abs().flatten()
                      for a, c in zip(placed[0], plain)])
    assert all(torch.equal(a, b) for a, b in zip(*placed))
    assert diff.max() <= 1e-4 and (diff > 1e-6).sum() <= diff.numel() // 10**4
    assert "step     1  loss" in logs[0] and "loss" not in logs[1]

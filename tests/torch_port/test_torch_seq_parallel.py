"""Training with each sequence split over a ``model`` axis above 1, held
against the JAX package on the CPU.

Checked:

* the plain flash forward and backward with a query offset
  (``flash_attention_plain`` / ``flash_attention_bwd_plain``, the
  kernels' oracles and the CPU path) against the reference's
  ``attend_parallel(q_offset=...)`` and ``jax.vjp`` of it, within 2e-5:
  causal and windowed, offsets on the kernels' tile sizes (32, 64) and
  off them; the plain LSE with an offset against JAX's ``logsumexp``;
* ``launch/train.py`` as ``torchrun`` starts it, in two gloo processes
  on a (1, 2) mesh and four on (2, 2), reduced qwen3-8b, 3 steps, from
  the reference's own initial weights (carried), against the reference's
  launcher path on 2 and 4 forced XLA host devices (``remesh(n)``, its
  training rules, its jitted step; in a subprocess): each step's loss and
  gradient norm within 2e-6 relative; every parameter after the 3 steps
  within the two-process gate of ``test_torch_sharding.py`` of the port's
  one-process run from the same weights, and within the train-step gate
  of ``test_torch_training.py`` (``assert_steps_close``) of the
  reference's; every rank issues the collectives counted by hand;
* a split step's backward on a thread of its own (as a CUDA backward
  runs on the autograd engine's device thread): the checkpointed layers
  re-run under their forward's split;
* a family outside the slice: rwkv6-3b raises under a ``model`` axis
  above 1 with its ROADMAP item, and the launcher gives it (N, 1).
"""
import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.attention import attend_parallel as jax_attend  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_lse_ref, flash_attention_bwd_plain, flash_attention_plain)
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.carry import params_from_reference  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--arch", "qwen3-8b", "--smoke", "--steps", "3", "--batch", "4",
        "--seq-len", "32"]


# ------------------------------------------------ flash with an offset --

# (Sq, Sk, q_offset, window): offsets on the float32 kernel's 32-row and the
# bf16 kernel's 64-row tiles and off them, the last rank's block (offset
# Sk - Sq), windows that a block's first rows reach past and its last rows
# do not
OFFSET_CASES = [(48, 128, 0, 0), (48, 128, 32, 0), (48, 128, 64, 0),
                (48, 128, 37, 0), (64, 128, 64, 0), (40, 128, 88, 0),
                (48, 128, 37, 24), (64, 128, 64, 40), (48, 96, 13, 7)]


@pytest.mark.parametrize("sq,sk,q_offset,window", OFFSET_CASES)
def test_plain_flash_with_offset_matches_reference(sq, sk, q_offset, window):
    rng = np.random.default_rng(sq * 1000 + q_offset * 10 + window)
    b, h, hkv, d = 2, 4, 2, 16
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)

    def ref(q, k, v):
        return jax_attend(q, k, v, causal=True, window=window,
                          q_offset=q_offset)

    want, vjp = jax.vjp(ref, q, k, v)
    want_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = flash_attention_plain(tq, tk, tv, causal=True, window=window,
                                q_offset=q_offset)
    grads = flash_attention_bwd_plain(tq, tk, tv, got, torch.from_numpy(do),
                                      causal=True, window=window,
                                      q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)
    # the plain LSE with the offset: log-sum-exp of the reference's masked
    # scores
    qpos = np.arange(sq)[:, None] + q_offset
    kpos = np.arange(sk)[None, :]
    mask = kpos <= qpos
    if window:
        mask &= (qpos - kpos) < window
    s = np.einsum("bskgd,btkd->bkgst", q.reshape(b, sq, hkv, h // hkv, d),
                  k) / np.sqrt(d)
    lse = jax.nn.logsumexp(jnp.where(mask, s, -1e30), axis=-1)
    np.testing.assert_allclose(
        attention_lse_ref(tq, tk, window=window, q_offset=q_offset).numpy(),
        np.asarray(lse).reshape(b, h, sq), rtol=2e-5, atol=2e-5)
    if q_offset == 0:        # offset 0 is the call without one, bit for bit
        assert torch.equal(got, flash_attention_plain(tq, tk, tv,
                                                      window=window))


# --------------------------------------- the launcher against the reference --

_REFERENCE = """
import json, pickle, sys
import jax, numpy as np
from repro.configs import get_config
from repro.distributed.elastic import remesh
from repro.distributed.sharding import (TRAIN_PARAM_RULES, TRAIN_RULES,
                                        ShardingPolicy, apply_policy)
from repro.models import build_model
from repro.training.data import SyntheticLM
from repro.training.loop import init_opt_state, make_train_step
from repro.training.optimizer import OptConfig
n, steps, batch, seq, out = (int(sys.argv[1]), 3, 4, 32, sys.argv[2])
assert len(jax.devices()) == n
# launch/train.py --arch qwen3-8b --smoke --steps 3 --batch 4 --seq-len 32
cfg = get_config("qwen3-8b").scaled(dtype="float32", d_model=64, d_ff=128,
                                    head_dim=16)
model = build_model(cfg)
data = SyntheticLM(cfg.vocab_size, seq, batch, seed=0)
opt = OptConfig(lr=3e-3, warmup_steps=max(steps // 10, 1), total_steps=steps)
params = model.init(jax.random.PRNGKey(0))
init = jax.device_get(params)
mesh = remesh(n)
policy = ShardingPolicy(mesh, acts=TRAIN_RULES, params=TRAIN_PARAM_RULES)
losses, norms = [], []
with apply_policy(policy):
    step_fn = jax.jit(make_train_step(model, opt), donate_argnums=(0, 1))
    state = init_opt_state(params)
    for s in range(steps):
        batch_s = {k: jax.numpy.asarray(v)
                   for k, v in data.batch_at(s).items()}
        params, state, m = step_fn(params, state, batch_s)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
pickle.dump({"init": init, "final": jax.device_get(params),
             "losses": losses, "grad_norms": norms,
             "mesh": [int(x) for x in mesh.shape.values()]},
            open(out, "wb"))
"""

_PORT = """
import functools, json, pickle, sys
import torch
torch.set_num_threads(1)
from torch.distributed.tensor import DTensor
from repro_torch.distributed import seq_parallel
from repro_torch.launch import train
from repro_torch.models.carry import params_from_reference
from repro_torch.training import loop
from repro_torch.utils.tree import tree_leaves
init = pickle.load(open(sys.argv[3], "rb"))["init"]
build = train.build_model
train.build_model = lambda cfg: build(cfg)._replace(
    init=lambda gen: params_from_reference(init))
train.train_loop = functools.partial(loop.train_loop, log_every=1)
seq_parallel.reset_collective_counts()
out = train.main(sys.argv[4:])
counts = seq_parallel.collective_counts()
leaves = tree_leaves(out["params"])
torch.save([p.detach().clone() for p in tree_leaves(loop.gathered(
    out["params"]))], sys.argv[2])
json.dump({"losses": out["losses"], "grad_norms": out["grad_norms"],
           "counts": counts,
           "sharded": sum(isinstance(p, DTensor) and any(
               q.is_shard() for q in p.placements) for p in leaves),
           "mesh": [list(p.device_mesh.shape) for p in leaves
                    if isinstance(p, DTensor)][:1]},
          open(sys.argv[1], "w"))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_reference(n: int, tmp_path) -> dict:
    out = tmp_path / f"ref{n}.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")
    subprocess.run([sys.executable, "-c", _REFERENCE, str(n), str(out)],
                   env=env, check=True, capture_output=True, timeout=240)
    return pickle.loads(out.read_bytes())


def run_ranks(n: int, tmp_path, ref_pkl) -> tuple[list, list, list]:
    """``n`` gloo processes of the launcher from the reference's initial
    weights, then one process with no process group: (each run's record,
    its gathered parameters, its output), the one process's last."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(n), OMP_NUM_THREADS="1")
    single = {k: v for k, v in env.items() if k != "WORLD_SIZE"}

    def start(name, env):
        return subprocess.Popen(
            [sys.executable, "-c", _PORT, str(tmp_path / f"{name}.json"),
             str(tmp_path / f"{name}.pt"), str(ref_pkl), *ARGS, "--device",
             "cpu"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    procs = [start(f"r{r}", dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(n)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    one = start("one", single)
    logs.append(one.communicate(timeout=240)[0])
    procs.append(one)
    assert [p.returncode for p in procs] == [0] * (n + 1), logs
    names = [f"r{r}" for r in range(n)] + ["one"]
    recs = [json.loads((tmp_path / f"{m}.json").read_text()) for m in names]
    params = [torch.load(tmp_path / f"{m}.pt") for m in names]
    return recs, params, logs


def expected_counts(n_model: int, n_data: int) -> dict:
    """The collectives a rank of the reduced qwen3-8b step issues in 3
    steps: per step, each attention layer's K/V all-gather in the forward
    and again in its checkpointed re-run and its dK/dV reduce-scatter; per
    parameter and mesh axis above one card, a gather of the parameter
    over an axis that shards it, a reduce-scatter of its gradient over an
    axis that shards and reduces it, an all-reduce over one that only
    reduces it (every axis reduces here: ``data`` the batch, ``model`` the
    sequence); the loss's all-reduce per axis and the norm's one."""
    from repro_torch.distributed.sharding import (TRAIN_PARAM_RULES,
                                                  TRAIN_RULES,
                                                  ShardingPolicy,
                                                  param_shardings,
                                                  spec_axes)

    cfg = get_config("qwen3-8b").scaled(dtype="float32", d_model=64,
                                        d_ff=128, head_dim=16)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    mesh = AbstractMesh((n_data, n_model), ("data", "model"))
    policy = ShardingPolicy(mesh, acts=TRAIN_RULES, params=TRAIN_PARAM_RULES)
    specs = param_shardings(policy, params, model.param_axes())
    sizes = {"data": n_data, "model": n_model}
    axes = [a for a in ("data", "model") if sizes[a] > 1]
    per_step = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}
    for spec in specs.values():
        split = [a for a in spec_axes(spec) if sizes[a] > 1]
        per_step["all_gather"] += len(split)
        per_step["reduce_scatter"] += len(split)
        per_step["all_reduce"] += len(axes) - len(split)
    per_step["all_gather"] += 2 * cfg.n_layers
    per_step["reduce_scatter"] += cfg.n_layers
    per_step["all_reduce"] += len(axes) + 1
    return {k: 3 * v for k, v in per_step.items()}


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 2)])
def test_split_launcher_matches_reference_mesh(tmp_path, n_data, n_model):
    n = n_data * n_model
    ref = run_reference(n, tmp_path)
    assert ref["mesh"] == [n_data, n_model]
    recs, params, logs = run_ranks(n, tmp_path, tmp_path / f"ref{n}.pkl")
    one, one_params = recs.pop(), params.pop()
    assert one["mesh"] == [] and one["counts"] == {
        "all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}
    want_counts = expected_counts(n_model, n_data)
    for r, rec in enumerate(recs):
        assert rec["mesh"] == [[n_data, n_model]] and rec["sharded"] > 0
        assert rec["losses"] == recs[0]["losses"], r
        assert rec["grad_norms"] == recs[0]["grad_norms"], r
        assert rec["counts"] == want_counts, (r, rec["counts"])
    for key in ("losses", "grad_norms"):
        got = recs[0][key]
        assert [s for s, _ in got] == [0, 1, 2]
        for (step, x), want in zip(got, ref[key]):
            assert abs(x - want) <= 2e-6 * abs(want), (key, step, x, want)
    final = [p.detach() for p in tree_leaves(params_from_reference(
        ref["final"]))]
    assert all(len(p) == len(final) for p in (*params, one_params))
    assert all(torch.equal(a, b) for p in params[1:]
               for a, b in zip(p, params[0]))
    # the two-process gate (test_torch_sharding.py), between runs of the
    # port: AdamW's first steps turn float32 noise in a near-zero gradient
    # into an O(lr) move
    diff = torch.cat([(a - c).abs().flatten()
                      for a, c in zip(params[0], one_params)])
    assert diff.max() <= 1e-4 and (diff > 1e-6).sum() <= diff.numel() // 10**4
    # against the reference, the train-step gate of test_torch_training.py
    # (`assert_steps_close`): the two packages' float32 noise, which AdamW
    # amplifies the same way, moves more elements past 1e-6 than the
    # two-process gate allows, already between one process of each
    for a, c in zip(params[0], final):
        d = (a - c).abs()
        assert int((d > 1e-5 * c.abs().max()).sum()) <= max(
            1e-3 * d.numel(), 4)
        assert float(d.max()) <= 2 * 3 * 3e-3
    assert "step     1  loss" in logs[0]
    assert all("loss" not in log for log in logs[1:-1])


# ---------------------------------------- the backward on another thread --

def test_checkpointed_layers_rerun_under_their_split():
    """A split step's backward on a thread of its own, as the autograd
    engine runs a CUDA backward on its device thread, where the thread's
    split is not set: each checkpointed layer re-runs under the split of
    its forward (one rank, collectives emulated), so its recomputed K/V
    have the gathered shapes the forward saved."""
    import threading

    from repro_torch.distributed import seq_parallel

    cfg = get_config("qwen3-8b").scaled(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 17),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens[:, 8:16], "targets": tokens[:, 9:17],
             "target_count": torch.full((2,), 15)}
    with seq_parallel.split(seq_parallel.SeqSplit(None, 1, 2, 8)):
        loss = model.loss(params, batch)
    out = {}

    def backward():
        try:
            out["grads"] = torch.autograd.grad(loss, leaves)
        except Exception as e:          # noqa: BLE001 — reported below
            out["error"] = e

    worker = threading.Thread(target=backward)
    worker.start()
    worker.join()
    assert "error" not in out, out.get("error")
    assert all(bool(torch.isfinite(g).all()) for g in out["grads"])


# ------------------------------------------------ families outside it --

def test_recurrent_family_raises_and_trains_on_data_only(monkeypatch,
                                                         capsys):
    from repro_torch.distributed import elastic
    from repro_torch.launch import train
    from repro_torch.training.loop import place_state

    cfg = get_config("rwkv6-3b").scaled(dtype="float32")
    model = build_model(cfg)
    policy = sharding.ShardingPolicy(AbstractMesh((1, 2), ("data", "model")),
                                     acts=sharding.TRAIN_RULES,
                                     params=sharding.TRAIN_PARAM_RULES)
    with pytest.raises(ValueError, match="'Recurrent state passing'"):
        place_state(model, policy, None, None)
    asked = []
    monkeypatch.setattr(elastic, "remesh",
                        lambda n, **kw: asked.append((n, kw)) or n)
    monkeypatch.setattr(train.dist, "get_rank", lambda: 0)
    train.train_mesh(cfg, 4, "cpu")
    train.train_mesh(get_config("qwen3-8b"), 4, "cpu")
    assert asked == [(4, {"data_model_ratio": 4, "device_type": "cpu"}),
                     (4, {"device_type": "cpu"})]
    assert "(4, 1) mesh, not the reference's remesh(4)" in capsys.readouterr(
    ).out
    assert elastic.mesh_factors(4, data_model_ratio=4) == (4, 1)
    assert elastic.mesh_factors(4) == (2, 2)

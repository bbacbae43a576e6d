"""Shared helpers of the sequence-split launcher tests: ``launch/train.py``
in gloo processes on the CPU, as ``torchrun`` starts them, against the
reference's launcher path on forced XLA host devices, both from the
reference's own initial weights.

`Reference` runs the reference's path in a subprocess: ``remesh(n)``, its
training rules, its jitted step, ``--smoke --steps 3 --batch 4 --seq-len
32``.  `run_ranks` runs the port's launcher in ``n`` processes of one
process group, and in one process without a group, from the same weights
(`reference_init`, drawn in the test process with the reference's key, so
all of them start at once).  Both sides feed the launcher's data through
``chip_smoke.FramedData``, which adds the patches or frames that
llava-next-34b's and seamless-m4t-medium's losses read (the reference's
launcher feeds tokens alone, and their losses raise there), as the chip
smoke's training phases do.  `expected_counts` reckons by hand the
collectives a rank issues; `split_runs` runs all of them and checks what
every case shares.
"""
import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from chip_smoke import FramedData  # noqa: E402,F401  (the tests' data)


STEPS = 3
SMOKE = ["--smoke", "--steps", str(STEPS), "--batch", "4", "--seq-len",
         "32"]

_REFERENCE = """
import pickle, sys
import jax, numpy as np
from repro.configs import get_config
from repro.distributed.elastic import remesh
from repro.distributed.sharding import (TRAIN_PARAM_RULES, TRAIN_RULES,
                                        ShardingPolicy, apply_policy)
from repro.models import build_model
from repro.training.data import SyntheticLM
from repro.training.loop import init_opt_state, make_train_step
from repro.training.optimizer import OptConfig
from chip_smoke import FramedData
arch, n, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
steps, batch, seq = 3, 4, 32
assert len(jax.devices()) == n
# launch/train.py --arch <arch> --smoke --steps 3 --batch 4 --seq-len 32
cfg = get_config(arch).scaled(dtype="float32", d_model=64, d_ff=128,
                              head_dim=16)
model = build_model(cfg)
data = FramedData(cfg, seq, batch, seed=0,
                  lm=SyntheticLM(cfg.vocab_size, seq, batch, seed=0))
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
from chip_smoke import FramedData
init = pickle.load(open(sys.argv[3], "rb"))
build, made = train.build_model, []
train.build_model = lambda cfg: made.append(cfg) or build(cfg)._replace(
    init=lambda gen: params_from_reference(init))
train.SyntheticLM = lambda vocab, seq, batch, seed: FramedData(
    made[-1], seq, batch, seed)
train.train_loop = functools.partial(loop.train_loop, log_every=1)
grads, lag = [], loop.loss_and_grads


def first_grads(model, params, batch, accum_steps=1):
    loss, g = lag(model, params, batch, accum_steps)
    if not grads:
        grads.extend(x.detach().clone() for x in tree_leaves(g))
    return loss, g


loop.loss_and_grads = first_grads
seq_parallel.reset_collective_counts()
out = train.main(sys.argv[4:])
counts = seq_parallel.collective_counts()
leaves = tree_leaves(out["params"])
if isinstance(leaves[0], DTensor):     # a rank's reduced shards, gathered
    grads = loop.gathered(loop._placed_like(grads, out["params"]))
torch.save({"params": [p.detach().clone() for p in tree_leaves(
    loop.gathered(out["params"]))], "grads": grads}, sys.argv[2])
json.dump({"losses": out["losses"], "grad_norms": out["grad_norms"],
           "counts": counts,
           "sharded": sum(isinstance(p, DTensor) and any(
               q.is_shard() for q in p.placements) for p in leaves),
           "mesh": [list(p.device_mesh.shape) for p in leaves
                    if isinstance(p, DTensor)][:1]},
          open(sys.argv[1], "w"))
"""


def smoke_config(arch: str, package):
    """``--smoke``'s config of ``arch`` from ``package``'s registry
    (`repro.configs` or `repro_torch.configs`)."""
    return package.get_config(arch).scaled(dtype="float32", d_model=64,
                                           d_ff=128, head_dim=16)


def reference_init(arch: str, path: Path) -> Path:
    """The reference launcher's initial weights of ``arch --smoke``
    (``model.init(PRNGKey(0))``), pickled to ``path``."""
    from repro import configs
    from repro.models import build_model

    model = build_model(smoke_config(arch, configs))
    path.write_bytes(pickle.dumps(jax.device_get(
        model.init(jax.random.PRNGKey(0)))))
    return path


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Reference:
    """The reference's launcher path on ``n`` forced XLA host devices, in
    a subprocess started at construction; ``result`` waits for it."""

    def __init__(self, arch: str, n: int, tmp_path):
        self.out = tmp_path / f"ref_{arch}_{n}.pkl"
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=f"{ROOT / 'src'}:{ROOT}",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, arch, str(n), str(self.out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)

    def result(self) -> dict:
        log = self.proc.communicate(timeout=240)[0]
        assert self.proc.returncode == 0, log
        return pickle.loads(self.out.read_bytes())


def run_ranks(arch: str, n: int, tmp_path, init_pkl,
              beside=None) -> tuple[list, list, list]:
    """``n`` gloo processes of the launcher from the weights pickled in
    ``init_pkl``, and beside them one process with no process group:
    (each run's record, its gathered parameters and the gradient of its
    first step's loss, its output), the one process's last; the outputs
    end with what ``beside(initial weights)`` returns, called while the
    processes run."""
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}",
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(n), OMP_NUM_THREADS="1")
    single = {k: v for k, v in env.items() if k != "WORLD_SIZE"}

    def start(name, env):
        return subprocess.Popen(
            [sys.executable, "-c", _PORT, str(tmp_path / f"{name}.json"),
             str(tmp_path / f"{name}.pt"), str(init_pkl), "--arch", arch,
             *SMOKE, "--device", "cpu"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    names = [f"r{r}" for r in range(n)] + ["one"]
    procs = [start(f"r{r}", dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(n)] + [start("one", single)]
    extra = beside(pickle.loads(init_pkl.read_bytes())) if beside else None
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * (n + 1), logs
    recs = [json.loads((tmp_path / f"{m}.json").read_text()) for m in names]
    params = [torch.load(tmp_path / f"{m}.pt") for m in names]
    return recs, params, [*logs, extra]


def split_layers(cfg) -> int:
    """The layers of one forward that each cross the ranks of a sequence
    split in one all-gather with a gradient: an attention layer its K/V
    (MLA its latent); an RWKV-6 layer its two token shifts and its WKV6
    state; a Mamba-2 layer its conv's rows and its SSD state; zamba2's
    shared block its K/V once a group; an encoder layer its K/V and a
    decoder layer its self-attention's and its cross K/V."""
    if cfg.ssm_kind == "rwkv6":
        return 3 * cfg.n_layers
    if cfg.ssm_kind == "mamba2":
        return 2 * cfg.n_layers + cfg.n_layers // cfg.attn_every
    if cfg.is_encdec:
        return cfg.enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def moe_layers(cfg) -> int:
    """The MoE layers of one forward."""
    return cfg.n_layers - cfg.first_dense_layers if cfg.is_moe else 0


def experts_kept(cfg, n_model: int) -> bool:
    """Whether the training rules shard the experts over a ``model`` axis
    of ``n_model`` ranks, each MoE rank then keeping its experts and
    bringing the row's tokens to them (`models.moe`)."""
    return cfg.is_moe and n_model > 1 and cfg.n_experts % n_model == 0


def count_layers(cfg, n_model: int) -> int:
    """The layers of one forward that gather without a gradient: each MoE
    layer its pair counts per (row, expert), where every rank holds every
    expert."""
    return 0 if experts_kept(cfg, n_model) else moe_layers(cfg)


def token_layers(cfg, n_model: int) -> int:
    """The layers of one forward that gather the row's tokens and
    reduce-scatter the outputs back: each MoE layer, where the ranks keep
    their experts."""
    return moe_layers(cfg) if experts_kept(cfg, n_model) else 0


def in_layer(path: str) -> bool:
    """Whether a leaf (its dotted path) belongs to a checkpointed layer,
    which gathers it in its forward and again in its re-run: one list
    element of a stack of layers (zamba2's groups and its shared block's
    per-group LoRA among them); the embedding, the head, the norms
    outside the layers, the frame projection and zamba2's shared block
    are read once a step."""
    return any(part.isdigit() for part in path.split("."))


def expected_counts(arch: str, n_model: int, n_data: int) -> dict:
    """The collectives a rank of the reduced ``arch`` step issues in 3
    steps, reckoned by hand: per step, each of `split_layers`'
    all-gathers in the forward and again in its checkpointed re-run, and
    its gradient's reduce-scatter, each of `count_layers`' gathers twice
    and no reduce-scatter, each of `token_layers`' gather twice and its
    reduce-scatter once (the re-run stops at the layer's last saved
    tensor, before the reduce-scatter: non-reentrant checkpointing's early
    stop), each mirrored once in the backward; per parameter and mesh
    axis above one card, a
    gather of the parameter over an axis that shards it where its layer
    runs (twice for a layer's leaf, `in_layer`: the forward and the
    re-run; once for the others), a reduce-scatter of its gradient over
    an axis that shards and reduces it, an all-reduce over one that only
    reduces it (every axis reduces here: ``data`` the batch, ``model``
    the sequence); the embedding and the head, vocab-sharded over
    ``model``, take no gather or reduction over it, nor do the experts
    where `experts_kept` (each rank's are its own); the embedding
    gathers the tokens and reduce-scatters its rows (its backward
    gathers their gradient), and the loss gathers the normed rows (a
    reduce-scatter back) and the targets and all-reduces the rows'
    maxima and their sums; the loss's all-reduce over ``data`` (over
    ``model`` it is whole already) and the norm's one."""
    from repro_torch import configs
    from repro_torch.distributed.sharding import (TRAIN_PARAM_RULES,
                                                  TRAIN_RULES,
                                                  ShardingPolicy,
                                                  param_shardings,
                                                  spec_axes)
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import build_model

    cfg = smoke_config(arch, configs)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    mesh = AbstractMesh((n_data, n_model), ("data", "model"))
    policy = ShardingPolicy(mesh, acts=TRAIN_RULES, params=TRAIN_PARAM_RULES)
    specs = param_shardings(policy, params, model.param_axes())
    sizes = {"data": n_data, "model": n_model}
    axes = [a for a in ("data", "model") if sizes[a] > 1]
    per_step = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}
    vocab = spec_axes(specs["lm_head"]).get("model") == 1 and n_model > 1
    kept = experts_kept(cfg, n_model)
    for name, spec in specs.items():
        split = [a for a in spec_axes(spec) if sizes[a] > 1]
        reducing = axes
        expert = kept and name.rsplit(".", 2)[-2:] in (
            ["moe", "wg"], ["moe", "wu"], ["moe", "wd"])
        if (vocab and name in ("embed", "lm_head")) or expert:
            split = [a for a in split if a != "model"]
            reducing = [a for a in axes if a != "model"]
        per_step["all_gather"] += (2 if in_layer(name) else 1) * len(split)
        per_step["reduce_scatter"] += len(split)
        per_step["all_reduce"] += len(reducing) - len(split)
    if n_model > 1:
        per_step["all_gather"] += 2 * (split_layers(cfg)
                                       + count_layers(cfg, n_model)) \
            + 3 * token_layers(cfg, n_model)
        per_step["reduce_scatter"] += split_layers(cfg) \
            + 2 * token_layers(cfg, n_model)
    if vocab:
        per_step["all_gather"] += 2 + 2     # tokens, dX; rows, targets
        per_step["reduce_scatter"] += 1 + 1     # embeddings; d rows
        per_step["all_reduce"] += 2             # maxima, sums
    per_step["all_reduce"] += len(axes) - vocab + 1
    return {k: STEPS * v for k, v in per_step.items()}


def split_runs(arch: str, n_data: int, n_model: int, tmp_path,
               beside=None):
    """The port's launcher in ``n_data · n_model`` gloo processes and in
    one process, and the reference's on as many XLA devices, all from the
    reference's initial weights, held to what every case shares: the
    reference's mesh, the same initial weights, every rank sharded, the
    ranks' losses, gradient norms and parameters the same bits, each
    rank's collectives `expected_counts`, none in the one process, every
    step logged, by rank 0 only.  Returns (the reference's record, rank
    0's record, rank 0's and the one process's gathered parameters and
    first-step gradients (`run_ranks`; a rank's reduced to its shards by
    the step, gathered whole after it), rank 0's first-step gradients
    (every rank's the same bits): the whole batch's,
    and what ``beside(initial weights)`` returns, run while the processes
    run)."""
    n = n_data * n_model
    ref_run = Reference(arch, n, tmp_path)      # draws its own weights
    init = reference_init(arch, tmp_path / f"init_{arch}.pkl")
    recs, runs, logs = run_ranks(arch, n, tmp_path, init, beside)
    extra = logs.pop()
    ref = ref_run.result()
    assert ref["mesh"] == [n_data, n_model]
    for a, b in zip(jax.tree_util.tree_leaves(ref["init"]),
                    jax.tree_util.tree_leaves(pickle.loads(
                        init.read_bytes()))):
        assert (a == b).all()
    one, one_run = recs.pop(), runs.pop()
    assert one["mesh"] == [] and one["counts"] == {
        "all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}
    want_counts = expected_counts(arch, n_model, n_data)
    for r, rec in enumerate(recs):
        assert rec["mesh"] == [[n_data, n_model]] and rec["sharded"] > 0
        assert rec["losses"] == recs[0]["losses"], r
        assert rec["grad_norms"] == recs[0]["grad_norms"], r
        assert rec["counts"] == want_counts, (r, rec["counts"], want_counts)
    assert [s for s, _ in recs[0]["losses"]] == list(range(STEPS))
    assert all(len(run["params"]) == len(one_run["params"]) for run in runs)
    assert all(torch.equal(a, b) for run in runs[1:]
               for a, b in zip(run["params"], runs[0]["params"]))
    assert "step     1  loss" in logs[0]
    assert all("loss" not in log for log in logs[1:-1])
    assert all(torch.equal(a, b) for run in runs[1:]
               for a, b in zip(run["grads"], runs[0]["grads"]))
    whole = runs[0]["grads"]
    return ref, recs[0], runs[0], one, one_run, whole, extra

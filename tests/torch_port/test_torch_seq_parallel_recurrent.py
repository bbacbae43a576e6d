"""The recurrent families trained with each sequence split over a
``model`` axis above 1, held against the JAX package on the CPU.

Checked:

* (a) the fold (`seq_parallel.fold_states`) against the reference's
  whole-sequence scans: the port's WKV6 and SSD (their plain versions)
  run block by block, m ∈ {2, 4} blocks of S_local ∈ {16, 24, 37}
  tokens, each block from zeros for its final state L and its decay D,
  the stacks of (L, D) built by hand, then each block from its folded
  state, against ``wkv6_chunked`` / ``ssd_chunked`` of
  ``src/repro/models/ssm.py`` over the whole sequence: outputs and final
  state within 2e-5 of the largest magnitude, the gradients of every
  input (through the fold's hand-written backward) within 1e-4 of each
  input's largest ``jax.vjp`` value; the fold's backward against
  ``torch.autograd.gradcheck`` in float64;
* (b) the halos: ``rwkv6_time_mix``, ``rwkv6_channel_mix`` and
  ``mamba2_block`` split over 2 ranks of 37 tokens and 4 of 16 (gloo
  groups over a ``HashStore``, one thread a rank, so the shift's and the
  state's gathers and reduce-scatters run for real) against the reference's
  functions over the whole sequence, under (a)'s gates, the parameters'
  gradients summed over the ranks;
* (c) ``launch/train.py --smoke`` for rwkv6-3b at (1, 2) and (2, 2) and
  zamba2-7b at (1, 2), in gloo processes, against the reference's
  launcher on 2 and 4 forced XLA host devices and against one process
  of the port (`_split_launcher.py`): the mesh, the counts of every
  collective reckoned by hand, the ranks' bits equal; the first step's
  loss within 2e-6 relative of the reference's and its gradient norm
  within 2e-6 relative of the float64 oracle's (`test_torch_training.
  float64_oracle`: the reference's own float32 norm is 1.5e-6 (rwkv6)
  and 3.5e-6 (zamba2) from it); the ranks' first-step gradient, summed,
  within 1e-4 of each leaf's largest oracle value; every step's loss
  within 2e-6 relative of the one process's, and every parameter after
  the 3 steps within 1e-4 of it.  The later steps are not held to the
  reference's, nor the parameters to the count of elements past 1e-6
  that the dense decoders meet: AdamW's first step moves each element by
  ±lr whatever its gradient's size, so an element whose gradient sits at
  float32's noise floor takes a sign that the rounding order picks, and
  the trajectories part.  The reference does not meet a 2e-6 gate
  against itself across meshes (ROADMAP.md §3 has the figures);
* (d) a recurrent model's split backward on a thread of its own (as a
  CUDA backward runs on the autograd engine's device thread): the
  checkpointed layers re-run their collectives under their forward's
  split.
"""
import threading
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.training.data import SyntheticLM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import seq_parallel  # noqa: E402
from repro_torch.models import build_model, ssm  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402
from _split_launcher import (smoke_config, split_layers,  # noqa: E402
                             split_runs)
from test_torch_ssm import (draw_params, run, ssd_inputs,  # noqa: E402
                            to_port, wkv6_inputs)
from test_torch_training import float64_oracle  # noqa: E402

OUT_TOL = 2e-5          # outputs and states, of the largest magnitude
GRAD_TOL = 1e-4         # gradients, of each input's largest
STEP_TOL = 2e-6         # launcher figures, relative


def rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / (np.max(np.abs(want)) + 1e-30))


def leaves_of(arrays) -> list:
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ----------------------------------------------- (a) the fold, by hand --

def wkv6_decay(r, k, v, log_w, u):
    return torch.exp(log_w.float().sum(dim=1))


def ssd_decay(x, bmat, cmat, dt, a_log, d_skip):
    return torch.exp(-torch.exp(a_log.float()) * dt.sum(dim=1))


SCANS = {"wkv6": (ssm.wkv6_chunked, jax_ssm.wkv6_chunked, wkv6_decay,
                  lambda b, s, seed: wkv6_inputs(b, s, 2, 16, seed)),
         "ssd": (ssm.ssd_chunked, jax_ssm.ssd_chunked, ssd_decay,
                 lambda b, s, seed: ssd_inputs(b, s, 3, 8, 16, seed))}


def blockwise(scan, decay_of, args, zeros, m: int):
    """``scan`` over m blocks of the sequence (dim 1 of the per-token
    inputs): each block from zeros for its final state and its decay,
    then from the state the earlier blocks fold into.  Returns (the
    blocks' outputs concatenated, the last block's final state)."""
    n_tok = sum(1 for a in args if a.dim() >= 3)   # the per-token inputs
    blocks = [[a.chunk(m, 1)[j] if i < n_tok else a
               for i, a in enumerate(args)] for j in range(m)]
    l_stack = torch.stack([scan(*blk, zeros)[1] for blk in blocks])
    d_stack = torch.stack([decay_of(*blk) for blk in blocks])
    outs = []
    for j, blk in enumerate(blocks):
        o, s_t = scan(*blk, seq_parallel.fold_states(l_stack, d_stack, j))
        outs.append(o)
    return torch.cat(outs, 1), s_t


@pytest.mark.parametrize("s_local", [16, 24, 37])
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", list(SCANS))
def test_fold_matches_whole_sequence_scan(name, m, s_local):
    port_scan, jax_scan, decay_of, inputs = SCANS[name]
    seed = 100 * m + s_local
    *args, s0 = inputs(2, m * s_local, seed)
    rng = np.random.default_rng(seed + 1)
    d_out = rng.standard_normal(args[0].shape).astype(np.float32)
    d_st = rng.standard_normal(s0.shape).astype(np.float32)

    def reference(args, cot):
        out, vjp = jax.vjp(lambda *a: jax_scan(*a, s0), *args)
        return out, vjp(cot)

    (want, want_st), want_grads = jax.jit(reference)(args, (d_out, d_st))
    targs = [t.requires_grad_(True) for t in leaves_of(args)]
    got, got_st = blockwise(port_scan, decay_of, targs,
                            torch.from_numpy(s0), m)
    assert rel(got.detach(), want) <= OUT_TOL
    assert rel(got_st.detach(), want_st) <= OUT_TOL
    grads = torch.autograd.grad((got, got_st), targs, (
        torch.from_numpy(d_out), torch.from_numpy(d_st)))
    assert len(grads) == len(want_grads) == len(args)
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        assert rel(g, w) <= GRAD_TOL, (i, rel(g, w))


@pytest.mark.parametrize("rank", [0, 1, 3])
@pytest.mark.parametrize("decay_dims", [2, 3])
def test_fold_backward_matches_gradcheck(rank, decay_dims):
    """`_Fold`'s hand-written backward against finite differences in
    float64, both decay layouts (SSD's [m, B, H], WKV6's [m, B, H, p]);
    the slots from ``rank`` on get zeros, rank 0's all of them."""
    rng = np.random.default_rng(rank * 10 + decay_dims)
    l_stack = torch.from_numpy(rng.standard_normal((4, 2, 3, 4, 5))
                               ).requires_grad_(True)
    d_stack = torch.from_numpy(rng.uniform(size=(4, 2, 3, 4)[
        :decay_dims + 1])).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b: seq_parallel.fold_states(a, b, rank), (l_stack, d_stack))
    g = torch.autograd.grad(seq_parallel.fold_states(l_stack, d_stack, rank)
                            .sum(), (l_stack, d_stack))
    assert all(bool((x[rank:] == 0).all()) for x in g)


# --------------------------------------------- (b) the halos, over ranks --

def over_ranks(m: int, s_local: int, fn):
    """``fn(rank)`` on m threads, each under the split of its rank (of
    ``s_local`` tokens) over a gloo group of the m threads (a
    ``HashStore`` between them); the results in rank order."""
    store = dist.PrefixStore(f"halo{m}", dist.HashStore())
    out, errors = [None] * m, []

    def worker(r):
        try:
            group = dist.ProcessGroupGloo(store, r, m, timedelta(seconds=60))
            with seq_parallel.split(seq_parallel.SeqSplit(group, r, m,
                                                          s_local)):
                out[r] = fn(r)
        except Exception as e:           # noqa: BLE001 — reported below
            errors.append((r, e))

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(m)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    return out


HALO_FNS = {
    "rwkv6_time_mix": (
        "rwkv6-3b", jax_blocks.rwkv_block_init,
        lambda p, x, cfg: jax_ssm.rwkv6_time_mix(p, x, cfg)[0],
        lambda p, x, cfg: ssm.rwkv6_time_mix(p, x, cfg)[0]),
    "rwkv6_channel_mix": (
        "rwkv6-3b", jax_blocks.rwkv_block_init,
        lambda p, x, cfg: jax_ssm.rwkv6_channel_mix(p, x)[0],
        lambda p, x, cfg: ssm.rwkv6_channel_mix(p, x)[0]),
    "mamba2_block": (
        "zamba2-7b", jax_blocks.mamba_block_init,
        lambda p, x, cfg: jax_ssm.mamba2_block(p, x, cfg)[0],
        lambda p, x, cfg: ssm.mamba2_block(p, x, cfg)[0]),
}


@pytest.mark.parametrize("m,s_local", [(2, 37), (4, 16)])
@pytest.mark.parametrize("name", list(HALO_FNS))
def test_split_mixers_match_whole_sequence(name, m, s_local):
    arch, init, jax_fn, port_fn = HALO_FNS[name]
    jcfg = jax_configs.get_config(arch).scaled(dtype="float32")
    pcfg = configs.get_config(arch).scaled(dtype="float32")
    rng = np.random.default_rng(7 * m + s_local)
    jp = draw_params(jax.device_get(run(init, jax.random.PRNGKey(m),
                                        cfg=jcfg, dtype=jnp.float32)),
                     rng)["mix"]
    x = rng.standard_normal((2, m * s_local, pcfg.d_model)).astype(
        np.float32)
    d_out = rng.standard_normal(x.shape).astype(np.float32)

    def reference(p, x, cot):
        out, vjp = jax.vjp(lambda p, x: jax_fn(p, x, jcfg), p, x)
        return out, vjp(cot)

    want, (want_dp, want_dx) = jax.jit(reference)(jp, x, d_out)
    blocks_x = np.split(x, m, axis=1)
    blocks_d = np.split(d_out, m, axis=1)

    def rank_step(r):
        p = {k: v.requires_grad_(True) for k, v in to_port(jp).items()}
        xr = torch.from_numpy(blocks_x[r]).requires_grad_(True)
        out = port_fn(p, xr, pcfg)
        names = sorted(p)
        grads = torch.autograd.grad(out, [xr, *(p[k] for k in names)],
                                    torch.from_numpy(blocks_d[r]),
                                    allow_unused=True,
                                    materialize_grads=True)
        return out.detach(), grads[0], dict(zip(names, grads[1:]))

    seq_parallel.reset_collective_counts()
    res = over_ranks(m, s_local, rank_step)
    counts = seq_parallel.collective_counts()
    # each rank one gather a crossing (the shift, and the state where the
    # mixer scans) and its reduce-scatter
    crossings = {"rwkv6_time_mix": 2, "rwkv6_channel_mix": 1,
                 "mamba2_block": 2}[name]
    assert counts == {"all_gather": m * crossings,
                      "reduce_scatter": m * crossings, "all_reduce": 0}
    assert rel(torch.cat([o for o, _, _ in res], 1), want) <= OUT_TOL
    assert rel(torch.cat([g for _, g, _ in res], 1), want_dx) <= GRAD_TOL
    for k, w in want_dp.items():
        got = sum(dp[k] for _, _, dp in res)
        assert rel(got, w) <= GRAD_TOL, (k, rel(got, w))


# ---------------------------------------- (c) the launcher, both families --

def first_step_oracle(arch: str, init_params):
    """The float64 oracle's gradient (a port tree) of the reference
    launcher's first step at its initial weights."""
    jcfg = smoke_config(arch, jax_configs)
    batch = {k: np.asarray(v) for k, v in SyntheticLM(
        jcfg.vocab_size, 32, 4, seed=0).batch_at(0).items()}
    return float64_oracle(jcfg, init_params, batch)


@pytest.mark.parametrize("arch,n_data,n_model", [
    ("rwkv6-3b", 1, 2), ("rwkv6-3b", 2, 2), ("zamba2-7b", 1, 2)])
def test_split_launcher_trains_recurrent_family(tmp_path, arch, n_data,
                                                n_model):
    ref, rec, run_, one, one_run, whole, oracle = split_runs(
        arch, n_data, n_model, tmp_path,
        beside=lambda init: tree_leaves(first_step_oracle(arch, init)))
    (_, loss0), (_, norm0) = rec["losses"][0], rec["grad_norms"][0]
    assert abs(loss0 - ref["losses"][0]) <= STEP_TOL * ref["losses"][0]
    exact = float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                                 for g in oracle)))
    assert abs(norm0 - exact) <= STEP_TOL * exact, (norm0, exact)
    for i, (g, o) in enumerate(zip(whole, oracle)):
        assert rel(g, o) <= GRAD_TOL, (i, rel(g, o))
    for (step, x), (_, y) in zip(rec["losses"], one["losses"]):
        assert abs(x - y) <= STEP_TOL * abs(y), (step, x, y)
    # the two-process bound of test_torch_seq_parallel.py (its count of
    # elements past 1e-6 does not hold here: the module docstring)
    diff = torch.cat([(a - c).abs().flatten()
                      for a, c in zip(run_["params"], one_run["params"])])
    assert float(diff.max()) <= 1e-4


# ------------------------------------- (d) the backward on another thread --

@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_recurrent_layers_rerun_under_their_split(arch):
    """A split step's backward on a thread of its own, where the thread's
    split is not set: each checkpointed layer re-runs its shift and state
    gathers under the split of its forward (one rank of two, collectives
    emulated), and the backward's reduce-scatters follow."""
    cfg = configs.get_config(arch).scaled(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 33)))
    batch = {"tokens": tokens[:, 16:32], "targets": tokens[:, 17:33],
             "target_count": torch.full((2,), 31)}
    seq_parallel.reset_collective_counts()
    with seq_parallel.split(seq_parallel.SeqSplit(None, 1, 2, 16)):
        loss = model.loss(params, batch)
    forward = seq_parallel.collective_counts()
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
    n = split_layers(cfg)
    assert forward == {"all_gather": n, "reduce_scatter": 0,
                       "all_reduce": 0}
    assert seq_parallel.collective_counts() == {
        "all_gather": 2 * n, "reduce_scatter": n, "all_reduce": 0}

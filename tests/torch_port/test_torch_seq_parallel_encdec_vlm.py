"""The patch-input model (llava-next-34b) and the encoder-decoder
(seamless-m4t-medium) trained with each sequence split over a ``model``
axis above 1, held against the JAX package on the CPU.

Checked:

* (a) llava's split: a reduced llava (2 layers, d_model 64, 28 patches
  ahead of 20 tokens, batch 2) over 2 ranks (blocks of 24: all patches,
  then 4 patches and 20 tokens) and 4 (blocks of 12: patches, patches,
  4 patches and 8 tokens, tokens), gloo groups over a ``HashStore``, one
  thread a rank; each rank's block as `training.loop.split_rows` cuts it
  (its patch and token slices, its targets, the whole rows' target
  count); each rank's logits at every position of its block against the
  port's one process over the whole sequence within 1e-6 of the largest
  magnitude (the port's one process is itself 1.6e-6 from the
  reference's logits, the same math summed in another order); each
  rank's loss against the reference's terms of its block (their logits
  from the reference's prefill, one row a target with the target's
  position last) within 1e-6 relative of the whole loss (a block of
  patches alone: exactly 0), and the ranks' losses summed against the
  reference's ``loss``; the ranks' gradients summed
  against ``jax.value_and_grad`` within 1e-5 of each leaf's largest, and
  the all-patch rank's own gradient not zero (its K/V reach the later
  ranks' rows); per rank and layer three K/V gathers (the logits'
  forward, the loss's forward and its re-run) and one reduce-scatter;
* (b) seamless's encoder layer (``_enc_block``) and cross-attention
  (``_cross_kv`` + ``_cross_attend``, 24 decoder rows against 40 frames)
  split over 2 and 4 ranks against the reference's over the whole
  sequence, at (a)'s tolerances: outputs, every input's gradient and the
  ranks' parameter gradients summed; one K/V gather and one
  reduce-scatter a rank;
* (c) ``launch/train.py --smoke`` for both models at (1, 2) and (2, 2), in
  gloo processes, against the reference's jitted step under ``remesh(2)``
  / ``remesh(4)`` with ``TRAIN_RULES`` on forced XLA host devices and one
  process of the port, both fed the same patches or frames
  (``chip_smoke.FramedData``), at the gates of
  `test_torch_seq_parallel_recurrent.py`: the first step's loss within
  2e-6 relative of the reference's and its gradient norm within 2e-6
  relative of the float64 oracle's, the ranks' summed first-step gradient
  within 1e-4 of each leaf's largest oracle value, every step's loss
  within 2e-6 relative of the one process's and every parameter after 3
  steps within 1e-4 of it; the collectives reckoned by hand
  (`expected_counts`: an encoder layer's K/V, a decoder layer's self and
  cross K/V);
* (d) a split step's backward on a thread of its own (as a CUDA backward
  runs on the autograd engine's device thread): the encoder's layers
  re-run under the encoder's split, the decoder's under the decoder's;
* `split_rows` refuses lengths that do not divide and inputs it does not
  know; a rank's block of a batch without llava's patches or seamless's
  frames raises in the port's loss as the whole batch does in the
  reference's (the launcher's faults (a) and (b), ROADMAP §3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import encdec as jax_encdec  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import seq_parallel  # noqa: E402
from repro_torch.models import encdec, lm  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.carry import params_from_reference  # noqa: E402
from repro_torch.training.loop import IGNORE, split_rows  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402
from _split_launcher import (FramedData, smoke_config,  # noqa: E402
                             split_layers, split_runs)
from test_torch_encdec_vlm import numpy_params, reduced  # noqa: E402
from test_torch_moe_mla import draw  # noqa: E402
from test_torch_seq_parallel_moe import (  # noqa: E402
    assert_close, split_against_whole)
from test_torch_seq_parallel_recurrent import (  # noqa: E402
    STEP_TOL, over_ranks, rel)
from test_torch_training import float64_oracle  # noqa: E402

OUT_TOL = 1e-6          # outputs and losses, of the largest magnitude
GRAD_TOL = 1e-5         # gradients, of each one's largest
ORACLE_TOL = 1e-4       # the launcher's first-step gradient, of the oracle's
LLAVA, SEAMLESS = "llava-next-34b", "seamless-m4t-medium"
PATCHES, TEXT = 28, 20  # llava's reduced sequence in (a)


# ----------------------------------------------- (a) llava's patch prefix --

def block_kind(local) -> str:
    p, t = local["patches"].shape[1], local["tokens"].shape[1]
    return "patches" if not t else "tokens" if not p else "mixed"


def reference_logits(jm, jp, batch) -> np.ndarray:
    """The reference's logits [B, T, V] of each target: row j of a row's
    targets is token j, scored at position P - 1 + j, the last position
    of a prefill whose ``lens`` is j."""
    b, t = batch["tokens"].shape
    rep = {k: np.repeat(v, t, axis=0) for k, v in batch.items()}
    rep["lens"] = np.tile(np.arange(t, dtype=np.int32), b)
    logits, _ = jax.jit(jm.prefill)(jp, rep)
    return np.asarray(logits).reshape(b, t, -1)


@pytest.mark.parametrize("m", [2, 4])
def test_split_patch_prefix_matches_whole_sequence(m):
    jcfg, pcfg = (dataclasses.replace(c, n_patches=PATCHES)
                  for c in reduced(LLAVA))
    jm = jax_build_model(jcfg)
    jp = numpy_params(jm, seed=m)
    rng = np.random.default_rng(10 + m)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, TEXT))
             .astype(np.int32),
             "patches": (0.1 * rng.standard_normal(
                 (2, PATCHES, jcfg.d_model))).astype(np.float32)}
    want_loss, want_grads = jax.jit(jax.value_and_grad(jm.loss))(jp, batch)
    want_logits = reference_logits(jm, jp, batch)
    lse = jax.nn.logsumexp(want_logits, axis=-1)
    picked = np.take_along_axis(want_logits, batch["tokens"][..., None],
                                -1)[..., 0]
    nll = np.asarray(lse - picked, np.float64)      # [B, T]
    sl = (PATCHES + TEXT) // m
    owner = (PATCHES - 1 + np.arange(TEXT)) // sl   # each target's rank
    whole = {k: torch.from_numpy(v) for k, v in batch.items()}
    pm = build_model(pcfg)
    with torch.no_grad():       # one process's logits, every position
        x, _ = pm.forward(params_from_reference(jp), whole, collect=False)
        one = lm._lm_head(params_from_reference(jp), x, pcfg)

    def rank_step(r):
        local, s_local = split_rows(whole, r, m)
        assert s_local == sl
        params = params_from_reference(jp)
        leaves = tree_leaves(params)
        with torch.no_grad():
            x, _ = pm.forward(params, local, collect=False)
            logits = lm._lm_head(params, x, pcfg)
        for p in leaves:
            p.requires_grad_(True)
        loss = pm.loss(params, local)
        return local, logits, loss.detach(), torch.autograd.grad(loss,
                                                                 leaves)

    seq_parallel.reset_collective_counts()
    res = over_ranks(m, sl, rank_step)
    assert seq_parallel.collective_counts() == {
        "all_gather": 3 * m * pcfg.n_layers,
        "reduce_scatter": m * pcfg.n_layers, "all_reduce": 0}
    kinds = [block_kind(local) for local, *_ in res]
    assert kinds[0] == "patches" and "mixed" in kinds
    assert m == 2 or "tokens" in kinds
    scale = float(one.abs().max())
    for r, (local, logits, loss, grads) in enumerate(res):
        lo = r * sl
        assert local["patches"].shape[1] + local["tokens"].shape[1] == sl
        assert local["targets"].shape == (2, sl)
        assert (local["target_count"] == TEXT).all()
        mine = np.flatnonzero(owner == r)
        assert int((local["targets"] != IGNORE).sum()) == 2 * mine.size
        assert float((logits - one[:, lo:lo + sl]).abs().max()) \
            <= OUT_TOL * scale, r
        want_r = nll[:, mine].sum() / (2 * TEXT)
        assert abs(float(loss) - want_r) <= OUT_TOL * float(want_loss), r
        if kinds[r] == "patches":
            assert float(loss) == 0.0
            assert any(bool(g.abs().max() > 0) for g in grads)
    assert abs(sum(float(x[2]) for x in res) - float(want_loss)) \
        <= OUT_TOL * float(want_loss)
    summed = [sum(gs) for gs in zip(*(x[3] for x in res))]
    want = tree_leaves(params_from_reference(jax.device_get(want_grads)))
    assert len(summed) == len(want)
    for i, (g, w) in enumerate(zip(summed, want)):
        assert rel(g, w) <= GRAD_TOL, (i, rel(g, w))


# ------------------------------------------- (b) seamless's frames split --

@pytest.mark.parametrize("m", [2, 4])
def test_split_encoder_layer_matches_whole_sequence(m):
    jcfg, pcfg = reduced(SEAMLESS)
    shapes = jax.eval_shape(lambda key: jax_encdec._enc_block_init(
        key, jcfg, jnp.float32), jax.random.PRNGKey(0))
    jp = draw(shapes, 20 + m)
    rng = np.random.default_rng(30 + m)
    x = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    d_out = rng.standard_normal(x.shape).astype(np.float32)
    counts, *figures = split_against_whole(
        m, [x], d_out, lambda p, x: jax_encdec._enc_block(p, x, jcfg), jp,
        lambda p, x: encdec._enc_block(p, x, pcfg))
    # the K/V's gather a rank, and its gradient's reduce-scatter
    assert counts == {"all_gather": m, "reduce_scatter": m,
                      "all_reduce": 0}
    assert_close(*figures)


@pytest.mark.parametrize("m", [2, 4])
def test_split_cross_attention_matches_whole_sequence(m):
    """24 decoder rows against 40 frames: each rank's rows (S / M) and
    frames (src_len / M), its cross K/V projected and gathered."""
    jcfg, pcfg = reduced(SEAMLESS)
    shapes = jax.eval_shape(lambda key: jax_attn.gqa_init(
        key, jcfg, jnp.float32), jax.random.PRNGKey(0))
    jp = draw({"xattn": shapes}, 40 + m)
    rng = np.random.default_rng(50 + m)
    h = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    d_out = rng.standard_normal(h.shape).astype(np.float32)
    counts, *figures = split_against_whole(
        m, [h, enc], d_out,
        lambda p, h, e: jax_encdec._cross_attend(
            p, h, *jax_encdec._cross_kv(p, e, jcfg), jcfg), jp,
        lambda p, h, e: encdec._cross_attend(p, h, *encdec._cross_kv(p, e)))
    assert counts == {"all_gather": m, "reduce_scatter": m,
                      "all_reduce": 0}
    assert_close(*figures)


# ------------------------------------------------- (c) the launcher --

def first_step_oracle(arch: str, init_params):
    """The float64 oracle's gradient (a port tree) of the first step of
    the reference's jitted step at its initial weights, on the launcher's
    first batch with its patches or frames (`FramedData`)."""
    jcfg = smoke_config(arch, jax_configs)
    return float64_oracle(jcfg, init_params,
                          FramedData(jcfg, 32, 4, seed=0).batch_at(0))


@pytest.mark.parametrize("arch,n_data,n_model", [
    (LLAVA, 1, 2), (LLAVA, 2, 2), (SEAMLESS, 1, 2), (SEAMLESS, 2, 2)])
def test_split_launcher_trains_encdec_and_vlm(tmp_path, arch, n_data,
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
        assert rel(g, o) <= ORACLE_TOL, (i, rel(g, o))
    for (step, x), (_, y) in zip(rec["losses"], one["losses"]):
        assert abs(x - y) <= STEP_TOL * abs(y), (step, x, y)
    diff = torch.cat([(a - c).abs().flatten()
                      for a, c in zip(run_["params"], one_run["params"])])
    assert float(diff.max()) <= 1e-4


# ------------------------------------- (d) the backward on another thread --

@pytest.mark.parametrize("arch", [LLAVA, SEAMLESS])
def test_layers_rerun_under_their_split(arch):
    """A split step's backward on a thread of its own, where the thread's
    split is not set: each checkpointed layer re-runs its gathers under
    the split of its forward (one rank of two, collectives emulated):
    seamless's encoder layers under the encoder's, at its block of
    frames."""
    import threading

    cfg = smoke_config(arch, configs)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    whole = {k: torch.from_numpy(v) for k, v in FramedData(
        cfg, 32, 2, seed=1).batch_at(0).items()}
    local, sl = split_rows(whole, 1, 2)
    seq_parallel.reset_collective_counts()
    with seq_parallel.split(seq_parallel.SeqSplit(None, 1, 2, sl)):
        loss = model.loss(params, local)
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


# ------------------------------------------------------ the refusals --

@pytest.mark.parametrize("batch,match", [
    ({"tokens": (2, 30), "patches": (2, 9, 4)}, "9 patches \\+ 30 tokens"),
    ({"tokens": (2, 30)}, "a sequence of 30 tokens"),
    ({"tokens": (2, 32), "frames": (2, 30, 4)}, "30 frames"),
    ({"tokens": (2, 32), "lens": (2,)}, "'lens'")])
def test_split_rows_refuses(batch, match):
    """Lengths that do not divide over the ranks raise with the lengths,
    rather than drop rows; an input the split does not know raises."""
    made = {k: torch.zeros(v) if k in ("patches", "frames")
            else torch.zeros(v, dtype=torch.int64) for k, v in batch.items()}
    with pytest.raises(ValueError, match=match):
        split_rows(made, 0, 4)


@pytest.mark.parametrize("arch,missing,error", [
    (LLAVA, "patches", ValueError), (SEAMLESS, "frames", KeyError)])
def test_split_block_without_its_inputs_raises(arch, missing, error):
    """The launcher feeds tokens alone (ROADMAP §3, training faults (a)
    and (b)): the reference's loss raises on such a batch, and so does
    the port's on a rank's block of it, rather than score the text
    alone at positions that skip the patch prefix."""
    jcfg, pcfg = reduced(arch)
    jm = jax_build_model(jcfg)
    jp = numpy_params(jm, seed=0)
    batch = FramedData(jcfg, 32, 2, seed=0).batch_at(0)
    del batch[missing]
    with pytest.raises(error):
        jax.jit(jm.loss)(jp, batch)
    for r in (0, 1):
        local, sl = split_rows({k: torch.from_numpy(v)
                                for k, v in batch.items()}, r, 2)
        with seq_parallel.split(seq_parallel.SeqSplit(None, r, 2, sl)):
            with pytest.raises(error):
                build_model(pcfg).loss(params_from_reference(jp), local)

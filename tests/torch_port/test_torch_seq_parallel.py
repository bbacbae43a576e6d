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
  training rules, its jitted step; in a subprocess; the shared helpers
  are `_split_launcher.py`'s): each step's loss and
  gradient norm within 2e-6 relative; every parameter after the 3 steps
  within the two-process gate of ``test_torch_sharding.py`` of the port's
  one-process run from the same weights, and within the train-step gate
  of ``test_torch_training.py`` (``assert_steps_close``) of the
  reference's; every rank issues the collectives counted by hand;
* a split step's backward on a thread of its own (as a CUDA backward
  runs on the autograd engine's device thread): the checkpointed layers
  re-run under their forward's split;
* every one of the ten architectures gets the reference's ``remesh(N)``
  from the launcher, which says nothing of another mesh, and a rank's
  block of its batch runs its loss and gradient under a split
  (`test_torch_seq_parallel_recurrent.py`,
  `test_torch_seq_parallel_moe.py` and
  `test_torch_seq_parallel_encdec_vlm.py` train the other families so).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.attention import attend_parallel as jax_attend  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_lse_ref, flash_attention_bwd_plain, flash_attention_plain)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.carry import params_from_reference  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402
from _split_launcher import split_runs  # noqa: E402

ARCH = "qwen3-8b"


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

@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 2)])
def test_split_launcher_matches_reference_mesh(tmp_path, n_data, n_model):
    ref, rec, run, _, one_run, _, _ = split_runs(ARCH, n_data, n_model,
                                                 tmp_path)
    for key in ("losses", "grad_norms"):
        for (step, x), want in zip(rec[key], ref[key]):
            assert abs(x - want) <= 2e-6 * abs(want), (key, step, x, want)
    final = [p.detach() for p in tree_leaves(params_from_reference(
        ref["final"]))]
    params, one_params = run["params"], one_run["params"]
    assert len(params) == len(final)
    # the two-process gate (test_torch_sharding.py), between runs of the
    # port: AdamW's first steps turn float32 noise in a near-zero gradient
    # into an O(lr) move
    diff = torch.cat([(a - c).abs().flatten()
                      for a, c in zip(params, one_params)])
    assert diff.max() <= 1e-4 and (diff > 1e-6).sum() <= diff.numel() // 10**4
    # against the reference, the train-step gate of test_torch_training.py
    # (`assert_steps_close`): the two packages' float32 noise, which AdamW
    # amplifies the same way, moves more elements past 1e-6 than the
    # two-process gate allows, already between one process of each
    for a, c in zip(params, final):
        d = (a - c).abs()
        assert int((d > 1e-5 * c.abs().max()).sum()) <= max(
            1e-3 * d.numel(), 4)
        assert float(d.max()) <= 2 * 3 * 3e-3


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


# ------------------------------------------------ every architecture --

@pytest.mark.parametrize("n,factors", [(2, (1, 2)), (4, (2, 2))])
def test_every_architecture_trains_on_the_reference_mesh(monkeypatch,
                                                         capsys, n,
                                                         factors):
    """The launcher gives every architecture ``remesh(N)`` at its default
    ratio, (1, 2) on two ranks and (2, 2) on four: `train_mesh` takes no
    config, and prints nothing (no "(N, 1)" departure from the
    reference's mesh).  That each architecture's split step matches the
    reference is held in the seq_parallel modules."""
    import inspect

    from repro_torch.distributed import elastic
    from repro_torch.launch import train

    assert list(inspect.signature(train.train_mesh).parameters) == [
        "n_dev", "device_type"]
    asked = []
    monkeypatch.setattr(elastic, "remesh",
                        lambda n, **kw: asked.append((n, kw)) or n)
    assert train.train_mesh(n, "cpu") == n
    assert asked == [(n, {"device_type": "cpu"})]
    assert capsys.readouterr().out == ""
    assert elastic.mesh_factors(n) == factors

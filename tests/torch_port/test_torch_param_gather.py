"""The split step's parameters kept as each rank's shards
(`repro_torch.distributed.param_gather`), on 2 and 4 gloo ranks in
threads of one process (gloo groups over a ``HashStore``, one per mesh
axis and row of the mesh, as `torch.distributed`'s ``DeviceMesh`` makes
them).

Checked:

* (a) the per-layer gather: its forward the leaf whole and its backward
  the step's reduction of each rank's whole gradient (a sum over
  ``model``, which splits the sequence, a mean over ``data``, which
  splits the batch, a reduce-scatter over an axis that shards the leaf),
  bit for bit against gathering whole and applying that reduction
  (`StepMesh.whole`, `StepMesh.reduce`) and against a hand reduction,
  for leaves sharded over ``data``, ``model``, both and neither;
* (b) memory: the most whole-parameter bytes alive on a rank during a
  reduced step's loss and gradient (weak references to the gather's
  outputs, read at every gather and at every gather's backward) at or
  under three times the largest layer's whole bytes and its shards, for
  qwen3-8b, zamba2-7b (its shared block, gathered once a step, counted
  once) and llava-next-34b; every leaf gathered, and the step's
  gradients the whole gradient's blocks;
* (c) the vocab-sharded pieces: the embedding equal to ``F.embedding``
  on the whole table bit for bit (a patch prefix ahead of the tokens
  too), and the loss and its gradients against the reference's
  ``repro.models.layers.next_token_loss`` on the same logits from numpy
  seeds within 1e-6 relative, with ``ignore`` targets among the tokens,
  llava's -100 patch rows, and a rank whose block holds patches only;
* (d) the dry run: ``state_bytes``' ``gathered`` and ``grads`` by hand
  for a reduced zamba2-7b (its groups with their LoRA the layers, its
  shared block outside them), and qwen2-72b's ``train_4k`` on 16 × 16
  at no more than three times its largest layer.
"""
import uuid
import weakref
from datetime import timedelta
from threading import Thread

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.models.layers import next_token_loss as jax_next_token_loss
from repro_torch import configs
from repro_torch.distributed import param_gather, seq_parallel
from repro_torch.distributed.param_gather import ParamGather, StepMesh
from repro_torch.distributed.sharding import (TRAIN_PARAM_RULES, TRAIN_RULES,
                                              ShardingPolicy,
                                              param_shardings, spec_axes)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models import build_model
from repro_torch.training.loop import IGNORE, split_rows
from repro_torch.utils.tree import tree_leaves, tree_unflatten

from _split_launcher import FramedData, smoke_config

torch.set_num_threads(1)


def on_mesh(n_data: int, n_model: int, fn):
    """``fn(mesh, d, m)`` on n_data · n_model threads, each a rank at
    (d, m) of a (data, model) mesh with a gloo group per axis above one;
    the results in rank order (data-major)."""
    store, tag = dist.HashStore(), uuid.uuid4().hex
    n = n_data * n_model
    out, errors = [None] * n, []

    def worker(r):
        try:
            d, m = divmod(r, n_model)
            groups = {}
            if n_model > 1:
                groups["model"] = dist.ProcessGroupGloo(dist.PrefixStore(
                    f"{tag}m{d}", store), m, n_model, timedelta(seconds=60))
            if n_data > 1:
                groups["data"] = dist.ProcessGroupGloo(dist.PrefixStore(
                    f"{tag}d{m}", store), d, n_data, timedelta(seconds=60))
            ranks = {a: {"data": d, "model": m}[a] for a in groups}
            mesh = StepMesh({"data": n_data, "model": n_model}, groups, ranks)
            out[r] = fn(mesh, d, m)
        except Exception as e:           # noqa: BLE001 — reported below
            errors.append((r, e))

    threads = [Thread(target=worker, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    return out


def block(x, spec, mesh: StepMesh):
    """This rank's block of ``x`` under ``spec`` (major axis first)."""
    for dim, entry in enumerate(spec):
        for a in mesh.axes(entry):
            x = x.tensor_split(mesh.sizes[a], dim)[mesh.ranks[a]]
    return x


def reductions(mesh: StepMesh) -> tuple[tuple, tuple]:
    """(sums, means): ``model`` splits the sequence, ``data`` the batch."""
    return (tuple(a for a in ("model",) if mesh.sizes[a] > 1),
            tuple(a for a in ("data",) if mesh.sizes[a] > 1))


# ------------------------------------------------ (a) gather and reduce --

SPECS = {"data": ("data",), "model": (None, "model"),
         "both": ("data", "model"), "neither": ()}


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("kind", list(SPECS))
def test_gather_and_reduce_match_whole_then_reduce(kind, n_data, n_model):
    spec = SPECS[kind]
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    # each rank's whole gradient: integers, so every order of summing
    # them gives the same bits
    grads = torch.from_numpy(rng.integers(-999, 999, (n_data, n_model, 4, 6))
                             .astype(np.float32))

    def rank(mesh, d, m):
        sums, means = reductions(mesh)
        shard = block(w, spec, mesh).clone().requires_grad_(True)
        g = ParamGather(mesh, [shard], [spec], sums, means)
        seq_parallel.reset_collective_counts()
        with param_gather.bind(g):
            out = param_gather.whole({"w": shard})["w"]
        assert torch.equal(out, w) and torch.equal(out, mesh.whole(
            shard.detach(), spec))
        (got,) = torch.autograd.grad(out, shard, grads[d, m])
        want = mesh.reduce(grads[d, m].clone(), spec, sums, means)
        by_hand = block(grads.sum(dim=1).sum(dim=0) / n_data, spec, mesh)
        assert g.missed([shard]) == []
        return got, want, by_hand

    for got, want, by_hand in on_mesh(n_data, n_model, rank):
        assert torch.equal(got, want) and torch.equal(got, by_hand)


def test_no_binding_is_the_identity():
    """Outside a binding the tree comes back as it went in, and the
    vocab ops are the plain ones."""
    tree = {"a": torch.ones(3), "b": [torch.zeros(2)]}
    assert param_gather.whole(tree) is tree
    table = torch.randn(10, 4)
    tokens = torch.tensor([[1, 9, 0]])
    assert torch.equal(param_gather.embedding(table, tokens),
                       torch.nn.functional.embedding(tokens, table))
    assert not param_gather.vocab_sharded(table, 0)


# ----------------------------------------------------------- (b) memory --

def units_of(names_and_leaves) -> dict:
    """{layer: whole bytes} of the leaves a checkpointed layer gathers
    (zamba2's shared LoRA of group g with group g)."""
    units = {}
    for name, p in names_and_leaves:
        unit = dryrun.layer_unit(name)
        if unit is not None:
            units[unit] = units.get(unit, 0) + p.numel() * p.element_size()
    return units


@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-7b", "llava-next-34b"])
def test_whole_bytes_stay_within_three_layers(arch, monkeypatch):
    cfg = smoke_config(arch, configs)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    named = list(params.named_parameters())
    policy = ShardingPolicy(AbstractMesh((1, 2), ("data", "model")),
                            acts=TRAIN_RULES, params=TRAIN_PARAM_RULES)
    specs = list(param_shardings(policy, params, model.param_axes()).values())
    whole_batch = {k: torch.from_numpy(v) for k, v in FramedData(
        cfg, 32, 2, seed=0).batch_at(0).items()}
    for p in params.parameters():
        p.requires_grad_(True)
    one = torch.autograd.grad(model.loss(params, whole_batch),
                              list(params.parameters()))
    largest = max(units_of(named).values())
    # the part of a layer a gather makes whole: its leaves split over model
    split_layer = max(units_of([(n, p) for (n, p), s in zip(named, specs)
                                if "model" in spec_axes(s)]).values())
    shared = sum(p.numel() * p.element_size() for n, p in named
                 if n.startswith("shared.block."))
    alive, peak = {0: [], 1: []}, {0: 0, 1: 0}
    forward, backward = (param_gather._GatherLeaf.forward,
                         param_gather._GatherLeaf.backward)

    def sample():
        r = seq_parallel.current().rank
        now = sum(t.numel() * t.element_size()
                  for t in (ref() for ref in alive[r]) if t is not None)
        peak[r] = max(peak[r], now)

    def watched_forward(ctx, shard, *args):
        out = forward(ctx, shard, *args)
        if out.numel() > shard.numel():        # a whole copy
            alive[seq_parallel.current().rank].append(weakref.ref(out))
        sample()
        return out

    def watched_backward(ctx, g):
        sample()
        return backward(ctx, g)

    monkeypatch.setattr(param_gather._GatherLeaf, "forward",
                        staticmethod(watched_forward))
    monkeypatch.setattr(param_gather._GatherLeaf, "backward",
                        staticmethod(watched_backward))

    def rank(mesh, d, m):
        local, sl = split_rows(whole_batch, m, 2)
        tree = tree_unflatten(params, [block(p.detach(), s, mesh)
                                       for (_, p), s in zip(named, specs)])
        leaves = tree_leaves(tree)
        for t in leaves:
            t.requires_grad_(True)
        g = ParamGather(mesh, leaves, specs, ("model",), ())
        split = seq_parallel.SeqSplit(mesh.groups["model"], m, 2, sl)
        with seq_parallel.split(split), param_gather.bind(g):
            grads = torch.autograd.grad(model.loss(tree, local), leaves)
        wants = [block(w, s, mesh) for w, s in zip(one, specs)]
        return (g.missed(leaves), peak[m],
                sum(t.numel() * t.element_size() for t in leaves),
                grads, wants)

    for missed, top, shard_bytes, grads, wants in on_mesh(1, 2, rank):
        assert missed == []
        assert split_layer <= top <= 3 * largest + shared + shard_bytes, (
            top, largest, shared)
        # the split's gradient gate against one process: 1e-4 of each
        # leaf's largest value (the sequence's rows summed in another
        # order; zamba2's float32 gradient is ill-conditioned)
        for (name, _), gr, w in zip(named, grads, wants):
            assert float((gr - w).abs().max()) <= 1e-4 * max(
                float(w.abs().max()), 1e-30), name


# ---------------------------------------------- (c) the vocab-sharded ops --

def vocab_mesh_fn(m, fn):
    """``fn(mesh, m)`` under a binding whose only leaves the callers make,
    on a (1, m) mesh."""
    return on_mesh(1, m, lambda mesh, d, r: fn(mesh, r))


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("lead", [0, 5, 8])
def test_vocab_sharded_embedding_is_f_embedding(m, lead):
    """Each rank's rows of the embedding of its block: the same bits as
    ``F.embedding`` of its tokens on the whole table; rank 0's block
    holds ``lead`` patches ahead of its tokens (8: patches only)."""
    rng = np.random.default_rng(11)
    v, dm, sl = 24, 8, 8
    table = torch.from_numpy(rng.standard_normal((v, dm)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, v, (2, m * sl)))

    def rank(mesh, r):
        shard = block(table, ("model",), mesh).clone().requires_grad_(True)
        g = ParamGather(mesh, [shard], [("model",)], ("model",), ())
        pad = lead if r == 0 else 0
        mine = tokens[:, r * sl + pad:(r + 1) * sl]
        split = seq_parallel.SeqSplit(mesh.groups["model"], r, m, sl)
        with seq_parallel.split(split), param_gather.bind(g):
            got = param_gather.embedding(shard, mine, pad)
        return got, torch.nn.functional.embedding(mine, table)

    for got, want in vocab_mesh_fn(m, rank):
        assert got.shape == want.shape and torch.equal(got, want)


def reference_loss_and_grads(h, w, tokens):
    """The reference's `next_token_loss` of logits h @ w over tokens
    (-100 the left-out targets) and its gradient in h and w (float64
    numpy out)."""
    def f(h, w):
        return jax_next_token_loss(jnp.einsum("bsd,dv->bsv", h, w), tokens)

    loss, (dh, dw) = jax.value_and_grad(f, argnums=(0, 1))(h, w)
    return float(loss), np.asarray(dh, np.float64), np.asarray(dw, np.float64)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("patches", [0, 20])
def test_vocab_sharded_loss_matches_reference(m, patches):
    """The rows h [B, S, D] of a sequence of ``patches`` patch rows (their
    targets -100, as llava's) and tokens with ``ignore`` targets among
    them: each rank's `vocab_nll` over its block of rows (`split_rows`'
    targets and count) and its vocab slice of the head is the
    reference's loss over the whole sequence's logits on every rank, its
    gradient in its rows and in its head slice the reference's; with 20
    patches of 32 positions rank 0's block is all patches."""
    rng = np.random.default_rng(13 + patches)
    b, s, dm, v = 2, 32, 16, 40
    t = s - patches
    h = rng.standard_normal((b, s, dm)).astype(np.float32)
    w = (0.5 * rng.standard_normal((dm, v))).astype(np.float32)
    tokens = rng.integers(0, v, (b, t))
    tokens[rng.random((b, t)) < 0.2] = IGNORE
    whole = np.concatenate([np.full((b, patches), IGNORE), tokens], axis=1)
    ref_loss, ref_dh, ref_dw = reference_loss_and_grads(h, w, whole)
    batch = {"tokens": torch.from_numpy(tokens)}
    if patches:
        batch["patches"] = torch.zeros((b, patches, dm))
    sl = s // m

    def rank(mesh, r):
        local, n = split_rows(batch, r, m)
        assert n == sl
        head = block(torch.from_numpy(w), (None, "model"), mesh).clone() \
            .requires_grad_(True)
        rows = torch.from_numpy(h[:, r * sl:(r + 1) * sl]).requires_grad_(True)
        g = ParamGather(mesh, [head], [(None, "model")], ("model",), ())
        split = seq_parallel.SeqSplit(mesh.groups["model"], r, m, sl)
        with seq_parallel.split(split), param_gather.bind(g):
            loss = param_gather.vocab_nll(rows, head, local["targets"],
                                          local["target_count"].sum())
            dh, dw = torch.autograd.grad(loss, (rows, head))
        kind = ("patches" if patches >= (r + 1) * sl else "mixed")
        return float(loss.detach()), dh, dw, kind

    res = vocab_mesh_fn(m, rank)
    assert patches == 0 or res[0][3] == "patches"
    for r, (loss, dh, dw, _) in enumerate(res):
        assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss), (r, loss)
        want_dh = ref_dh[:, r * sl:(r + 1) * sl]
        want_dw = ref_dw[:, r * (v // m):(r + 1) * (v // m)]
        assert np.abs(dh.numpy() - want_dh).max() <= 1e-6 * np.abs(
            ref_dh).max(), r
        assert np.abs(dw.numpy() - want_dw).max() <= 1e-6 * np.abs(
            ref_dw).max(), r
        if patches >= (r + 1) * sl:        # a block of patches: no target
            assert np.abs(want_dh).max() == 0 and dh.abs().max() == 0


@pytest.mark.parametrize("m", [2, 4])
def test_vocab_sharded_ops_with_the_sequence_whole(m):
    """Where the divisibility fallback leaves each sequence whole on the
    vocab's ranks (no split), every rank holds the same rows: the
    embedding is ``F.embedding`` bit for bit (the ranks' rows summed), and
    the loss and its gradients in the rows and in the rank's head slice
    are the reference's within 1e-6 relative."""
    rng = np.random.default_rng(17)
    b, s, dm, v = 2, 33, 16, 40
    table = torch.from_numpy(rng.standard_normal((v, dm)).astype(np.float32))
    h = rng.standard_normal((b, s, dm)).astype(np.float32)
    w = (0.5 * rng.standard_normal((dm, v))).astype(np.float32)
    tokens = rng.integers(0, v, (b, s))
    tokens[rng.random((b, s)) < 0.2] = IGNORE
    ref_loss, ref_dh, ref_dw = reference_loss_and_grads(h, w, tokens)
    ids = torch.from_numpy(np.where(tokens == IGNORE, 0, tokens))

    def rank(mesh, r):
        shards = [block(table, ("model",), mesh).clone().requires_grad_(),
                  block(torch.from_numpy(w), (None, "model"), mesh).clone()
                  .requires_grad_()]
        g = ParamGather(mesh, shards, [("model",), (None, "model")])
        rows = torch.from_numpy(h).requires_grad_(True)
        with param_gather.bind(g):
            emb = param_gather.embedding(shards[0], ids)
            loss = param_gather.vocab_nll(rows[:, :-1], shards[1],
                                          torch.from_numpy(tokens[:, 1:]))
            dh, dw = torch.autograd.grad(loss, (rows, shards[1]))
        return emb, float(loss.detach()), dh, dw

    for r, (emb, loss, dh, dw) in enumerate(vocab_mesh_fn(m, rank)):
        assert torch.equal(emb, torch.nn.functional.embedding(ids, table))
        assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss), (r, loss)
        assert np.abs(dh.numpy() - ref_dh).max() <= 1e-6 * np.abs(
            ref_dh).max(), r
        assert np.abs(dw.numpy() - ref_dw[:, r * (v // m):(r + 1) * (
            v // m)]).max() <= 1e-6 * np.abs(ref_dw).max(), r


# ------------------------------------------------------- (d) the dry run --

def test_dry_run_split_terms_by_hand():
    """A reduced zamba2-7b on (2, 2): the layers are its groups, each with
    its shared block's LoRA of that group, and its tail layers; the
    leaves read outside them are the final norm and the shared block
    (gathered once a step, whole all step); the table and the head are
    vocab-sharded.  ``gathered`` = 2 × (the largest layer less its shards)
    + the outside leaves less theirs; ``grads`` = the shards' gradients +
    the largest layer's and the outside leaves' whole."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed import sharding

    cfg = smoke_config("zamba2-7b", configs).scaled(dtype="bfloat16",
                                                    n_layers=5)
    mesh = AbstractMesh((2, 2), ("data", "model"))
    policy = dryrun.build_policy(mesh, "train", "t")
    shape = ShapeConfig("t", "train", 64, 8)
    got = dryrun.state_bytes(cfg, shape, policy, accum=1)
    model = build_model(cfg)
    with FakeTensorMode():
        named = [(n, tuple(p.shape), p.element_size()) for n, p in
                 model.init(torch.Generator().manual_seed(0))
                 .named_parameters()]
    axes = sharding.axes_by_path(model.param_axes())
    layers, outside, shards = {}, [0, 0], 0
    for name, dims, item in named:
        spec = policy.param_spec(axes[name], dims)
        full = item * torch.Size(dims).numel()
        local = item * torch.Size(sharding.local_shape(mesh, spec,
                                                       dims)).numel()
        shards += local
        parts = name.split(".")
        if name in ("embed", "lm_head"):
            assert spec_axes(spec)["model"] == {"embed": 0, "lm_head": 1}[
                name]
            continue
        if parts[0] == "groups":
            key = f"g{parts[1]}"
        elif parts[:2] == ["shared", "lora"]:
            key = f"g{parts[2]}"
        elif parts[0] == "tail":
            key = f"t{parts[1]}"
        else:
            assert name == "final_norm" or parts[:2] == ["shared", "block"]
            outside[0] += full
            outside[1] += local
            continue
        unit = layers.setdefault(key, [0, 0])
        unit[0] += full
        unit[1] += local
    assert sorted(layers) == ["g0", "g1", "t0"]
    l_full, l_local = max(layers.values())
    assert got["params"] == shards
    assert got["gathered"] == 2 * (l_full - l_local) + outside[0] - outside[1]
    assert got["grads"] == shards + l_full + outside[0]


def test_dry_run_qwen2_72b_gathers_one_layer():
    """qwen2-72b's ``train_4k`` on 16 × 16: the whole copies a card holds
    are at most three of its largest layer, not the whole model."""
    from repro_torch.configs import SHAPES, get_config

    cfg = get_config("qwen2-72b")
    mesh = make_production_mesh(multi_pod=False, abstract=True)
    policy = dryrun.build_policy(mesh, "train", "train_4k")
    got = dryrun.state_bytes(cfg, SHAPES["train_4k"], policy)
    from torch._subclasses.fake_tensor import FakeTensorMode

    model = build_model(cfg)
    with FakeTensorMode():
        named = list(model.init(
            torch.Generator().manual_seed(0)).named_parameters())
    layer = max(units_of(named).values())
    whole = sum(p.numel() * p.element_size() for _, p in named)
    assert 0 < got["gathered"] <= 3 * layer
    assert got["gathered"] < whole / 20
    assert got["grads"] - 2 * got["params"] <= 3 * layer

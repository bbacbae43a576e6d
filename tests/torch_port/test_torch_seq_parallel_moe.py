"""The MoE models (mixtral-8x22b, deepseek-v2-lite-16b) trained with each
sequence split over a ``model`` axis above 1, held against the JAX
package on the CPU.

Checked:

* (a) the MoE mixer: ``moe_ffn_sort`` split over 2 ranks of 37 tokens
  and 4 of 16 (gloo groups over a ``HashStore``, one thread a rank, so
  the collectives run for real), at mixtral's 8 experts top-2 and
  deepseek's 64 top-6 with 2 shared experts, the capacity factor cut to
  0.75 and one expert made popular, so that pairs that a rank's own
  counts would keep are dropped for the pairs of the ranks before it
  (asserted from the reference's routes: the test cannot pass without
  such a drop), each against the reference's ``moe_ffn_sort`` over the
  whole sequence: outputs within 1e-6 of the largest magnitude, dx and
  gradients within 1e-5 of each one's largest.  With whole weights on
  every rank (no binding), the ranks' summed parameter gradients; one
  counts gather a rank and no reduce-scatter.  Under a ``ParamGather``
  binding with the training rules' specs (the experts sharded over
  ``model``), each rank's shard gradients against the matching slices
  of ``jax.vjp``'s; each owner's bucket the reference's bucket cut to
  its experts, bit for bit; a token gather and a reduce-scatter a call,
  mirrored in the backward, beside the leaf gathers, and no expert leaf
  gathered over ``model``.  With 6 experts on 4 ranks (the training
  rules leave the expert dim whole) the binding takes the counts path.
  ``moe_ffn_onehot`` under the expert layout against the reference's,
  and its raise where the layout does not apply;
* (b) MLA: ``attend_parallel_plain`` with a query offset at MLA's widths
  (dk != dv) against the reference's ``attend_parallel(q_offset=...)``,
  offset 0 the same bits as the call without one; ``mla_parallel`` on
  each rank's block (the latent gathered, K/V expanded for every key)
  against the reference's ``mla_parallel`` over the whole sequence at
  the block's rows, forward within 1e-6 and gradients within 1e-5, one
  gather and one reduce-scatter a rank;
* (c) mixtral's attention layer (``gqa_parallel``) with its window cut to
  16 over 64 tokens on 2 and 4 ranks (blocks of 32 and 16: the window
  masks keys of the earlier ranks' blocks) against the reference's over
  the whole sequence, at (b)'s tolerances;
* (d) ``launch/train.py --smoke`` for both models at (1, 2) and (2, 2),
  in gloo processes, against the reference's launcher on 2 and 4 forced
  XLA host devices and one process of the port (`_split_launcher.py`),
  at `test_torch_seq_parallel_recurrent.py`'s gates: the first step's
  loss within 2e-6 relative of the reference's and its gradient norm
  within 2e-6 relative of the float64 oracle's, the ranks' summed
  first-step gradient within 1e-4 of each leaf's largest oracle value,
  every step's loss within 2e-6 relative of the one process's and every
  parameter after 3 steps within 1e-4 of it; the collectives reckoned
  by hand (`expected_counts`: two counts gathers a MoE layer and step,
  each MoE layer's token gather and reduce-scatter in its forward, its
  re-run and its backward, its experts gathered over ``data`` alone,
  MLA's latent as an attention layer's K/V).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import param_gather, seq_parallel  # noqa: E402
from repro_torch.distributed.param_gather import (ParamGather,  # noqa: E402
                                                  StepMesh)
from repro_torch.distributed.sharding import (TRAIN_PARAM_RULES,  # noqa: E402
                                              TRAIN_RULES, ShardingPolicy,
                                              axes_by_path)
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402
from _split_launcher import split_runs  # noqa: E402
from test_torch_moe_mla import draw, to_port  # noqa: E402
from test_torch_seq_parallel_recurrent import (  # noqa: E402
    STEP_TOL, first_step_oracle, over_ranks, rel)

OUT_TOL = 1e-6          # outputs, of the largest magnitude
GRAD_TOL = 1e-5         # gradients, of each one's largest
ORACLE_TOL = 1e-4       # the launcher's first-step gradient, of the oracle's
MIXTRAL, DEEPSEEK = "mixtral-8x22b", "deepseek-v2-lite-16b"
SPLITS = [(2, 37), (4, 16)]


def both(arch, **over):
    """The same reduced float32 config from both packages."""
    return (jax_configs.get_config(arch).scaled(dtype="float32", **over),
            configs.get_config(arch).scaled(dtype="float32", **over))


def flat(tree, pre: str = "") -> dict:
    """A nested dict's leaves by dotted path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{pre}{k}."))
        else:
            out[pre + k] = v
    return out


def split_against_whole(m, xs, d_out, jax_fn, jp, port_fn):
    """``port_fn(params, *blocks)`` on each of m ranks' blocks of the
    inputs ``xs`` (each cut on dim 1 into m blocks) with the block's share
    of the cotangent, against ``jax_fn(params, *xs)`` over the whole
    sequences and its ``jax.vjp``: (the collectives, the blocks' outputs
    concatenated, each input's gradient concatenated, the ranks'
    parameter gradients summed, the reference's output, input gradients
    and parameter gradients), the parameter gradients as dicts by
    path."""
    def reference(p, xs, cot):
        out, vjp = jax.vjp(jax_fn, p, *xs)
        return out, vjp(cot)

    want, (want_dp, *want_dx) = jax.jit(reference)(jp, xs, d_out)
    blocks = [np.split(x, m, axis=1) for x in xs]
    d_blocks = np.split(d_out, m, axis=1)

    def rank_step(r):
        p = {k: v.requires_grad_(True) for k, v in flat(to_port(jp)).items()}
        xr = [torch.from_numpy(b[r]).requires_grad_(True) for b in blocks]
        out = port_fn(unflat(p), *xr)
        names = sorted(p)
        grads = torch.autograd.grad(out, [*xr, *(p[k] for k in names)],
                                    torch.from_numpy(d_blocks[r]),
                                    allow_unused=True,
                                    materialize_grads=True)
        return (out.detach(), grads[:len(xr)],
                dict(zip(names, grads[len(xr):])))

    seq_parallel.reset_collective_counts()
    res = over_ranks(m, d_out.shape[1] // m, rank_step)
    counts = seq_parallel.collective_counts()
    got = torch.cat([o for o, _, _ in res], 1)
    got_dx = [torch.cat([dx[i] for _, dx, _ in res], 1)
              for i in range(len(xs))]
    got_dp = {k: sum(dp[k] for _, _, dp in res) for k in res[0][2]}
    return counts, got, got_dx, got_dp, want, want_dx, flat(want_dp)


def unflat(leaves: dict) -> dict:
    """`flat`'s inverse."""
    out = {}
    for path, v in leaves.items():
        *heads, last = path.split(".")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def assert_close(got, got_dx, got_dp, want, want_dx, want_dp):
    assert rel(got, want) <= OUT_TOL, rel(got, want)
    for i, (g, w) in enumerate(zip(got_dx, want_dx)):
        assert rel(g, w) <= GRAD_TOL, (i, rel(g, w))
    assert sorted(got_dp) == sorted(want_dp)
    for k, w in want_dp.items():
        assert rel(got_dp[k], w) <= GRAD_TOL, (k, rel(got_dp[k], w))


# --------------------------------------------------- (a) the MoE mixer --

MIXERS = {MIXTRAL: dict(n_experts=8, top_k=2, n_shared_experts=0),
          DEEPSEEK: dict(n_experts=64, top_k=6, n_shared_experts=2)}
CF = 0.75


def straddling_drops(idx, m: int, c: int, e: int) -> tuple[int, int]:
    """From the whole sequence's routes ``idx`` [B, S, k] cut into m
    blocks: (the dropped pairs, the pairs on a rank above 0 that its own
    counts would keep, a local rank below C, but the pairs of the ranks
    before it drop)."""
    b, s, k = idx.shape
    per = np.stack([np.stack([np.bincount(blk[i].ravel(), minlength=e)
                              for i in range(b)])
                    for blk in np.split(idx, m, axis=1)])      # [m, B, E]
    before = np.cumsum(per, axis=0) - per
    dropped = int(np.maximum(per.sum(0) - c, 0).sum())
    lo = np.maximum(c - before, 0)          # the first local rank dropped
    straddle = int((np.minimum(per, c) - np.minimum(lo, per))[1:].clip(0)
                   .sum())
    return dropped, straddle


def mixer_inputs(arch, m, s_local, **over):
    """(reference config, port config, reference parameters, x, the
    output's cotangent) of (a)'s mixer at ``arch`` over m ranks of
    ``s_local`` tokens, one expert made popular, with drops that straddle
    a rank boundary (asserted)."""
    jcfg, pcfg = both(arch, capacity_factor=CF, **{**MIXERS[arch], **over})
    shapes = jax.eval_shape(lambda key: jax_moe.moe_init(key, jcfg,
                                                         jnp.float32),
                            jax.random.PRNGKey(0))
    seed = 10 * m + s_local
    jp = draw({"moe": shapes}, seed)["moe"]
    jp["router"][:, 1] += 0.15       # a popular expert: its bucket fills
    rng = np.random.default_rng(seed + 1)
    x = (rng.standard_normal((2, m * s_local, jcfg.d_model)) + 0.3) \
        .astype(np.float32)
    d_out = rng.standard_normal(x.shape).astype(np.float32)

    _, idx = jax_moe._route(jp, jnp.asarray(x), jcfg)
    c = moe._capacity(m * s_local, jcfg.top_k, jcfg.n_experts, CF)
    dropped, straddle = straddling_drops(np.asarray(idx), m, c,
                                         jcfg.n_experts)
    assert dropped > 0 and straddle > 0, (dropped, straddle)
    return jcfg, pcfg, jp, x, d_out


@pytest.mark.parametrize("m,s_local", SPLITS)
@pytest.mark.parametrize("arch", list(MIXERS))
def test_split_moe_matches_whole_sequence_dispatch(arch, m, s_local):
    jcfg, pcfg, jp, x, d_out = mixer_inputs(arch, m, s_local)
    counts, *figures = split_against_whole(
        m, [x], d_out,
        lambda p, x: jax_moe.moe_ffn_sort(p, x, jcfg), jp,
        lambda p, x: moe.moe_ffn_sort(p, x, pcfg))
    # one gather of the counts a rank, and nothing to scatter back
    assert counts == {"all_gather": m, "reduce_scatter": 0,
                      "all_reduce": 0}
    assert_close(*figures)


def expert_specs(pcfg, m: int) -> dict:
    """{dotted path: spec} of the MoE leaves under the training rules on a
    (1, m) mesh, as the step resolves them."""
    policy = ShardingPolicy(AbstractMesh((1, m), ("data", "model")),
                            acts=TRAIN_RULES, params=TRAIN_PARAM_RULES)
    axes = axes_by_path({"moe": moe.moe_axes(pcfg)})
    leaves = flat(moe.moe_init(pcfg, torch.float32,
                               generator=torch.Generator().manual_seed(0)))
    return {k: policy.param_spec(axes[f"moe.{k}"], tuple(v.shape))
            for k, v in leaves.items()}


def rank_block(t, spec, m: int, r: int):
    """Rank r's block of ``t`` under ``spec`` on a (1, m) mesh."""
    for dim, entry in enumerate(spec):
        if entry == "model" or (isinstance(entry, tuple) and "model" in entry):
            t = t.tensor_split(m, dim)[r]
    return t


def bound_split_against_whole(m, x, d_out, jax_fn, jp, port_fn, specs,
                              monkeypatch):
    """``port_fn(p, block)`` on each of m ranks' blocks of ``x`` with the
    block's share of the cotangent, the rank handed its shards of ``jp``
    under ``specs`` in a `ParamGather` binding (the sequence split over
    ``model``) and the layer's leaves made whole by `param_gather.whole`,
    against ``jax_fn(params, x)`` over the whole sequence and its
    ``jax.vjp``: (the collectives, the ranks' keep axes of each leaf's
    gathers, the blocks' outputs concatenated, dx concatenated, each
    rank's shard gradients, the reference's output, dx and parameter
    gradients by path)."""
    def reference(p, x, cot):
        out, vjp = jax.vjp(jax_fn, p, x)
        return out, vjp(cot)

    want, (want_dp, want_dx) = jax.jit(reference)(jp, x, d_out)
    blocks, d_blocks = np.split(x, m, axis=1), np.split(d_out, m, axis=1)
    keeps: dict = {}
    gather = ParamGather.gather

    def recorded(self, t, keep=None):
        name = [k for k, v in self.names.items() if v is t][0]
        keeps.setdefault(seq_parallel.current().rank, []).append(
            (name, keep))
        return gather(self, t, keep)

    monkeypatch.setattr(ParamGather, "gather", recorded)

    def rank_step(r):
        group = seq_parallel.current().group
        mesh = StepMesh({"data": 1, "model": m}, {"model": group},
                        {"model": r})
        shards = {k: rank_block(v, specs[k], m, r).clone()
                  .requires_grad_(True)
                  for k, v in flat(to_port(jp)).items()}
        names = sorted(shards)
        g = ParamGather(mesh, [shards[k] for k in names],
                        [specs[k] for k in names], ("model",), ())
        g.names = shards
        xr = torch.from_numpy(blocks[r]).requires_grad_(True)
        with param_gather.bind(g):
            out = port_fn(param_gather.whole(unflat(shards)), xr)
        grads = torch.autograd.grad(out, [xr, *(shards[k] for k in names)],
                                    torch.from_numpy(d_blocks[r]))
        assert g.missed([shards[k] for k in names]) == []
        return out.detach(), grads[0], dict(zip(names, grads[1:]))

    seq_parallel.reset_collective_counts()
    res = over_ranks(m, x.shape[1] // m, rank_step)
    counts = seq_parallel.collective_counts()
    return (counts, keeps, torch.cat([o for o, _, _ in res], 1),
            torch.cat([dx for _, dx, _ in res], 1), [dp for _, _, dp in res],
            want, want_dx, flat(want_dp))


def reference_bucket(jp, x, jcfg, monkeypatch) -> np.ndarray:
    """The reference's ``moe_ffn_sort`` bucket xe [B, E, C, D] over the
    whole sequence."""
    seen = []
    with monkeypatch.context() as mp:
        ffn = jax_moe._expert_ffn
        mp.setattr(jax_moe, "_expert_ffn",
                   lambda p, xe: seen.append(np.asarray(xe)) or ffn(p, xe))
        jax_moe.moe_ffn_sort(jp, jnp.asarray(x), jcfg)
    return seen[0]


def expert_buckets(monkeypatch) -> dict:
    """{rank: (the bucket xe its experts ran over, its experts' wg)},
    filled by the port's ``moe._expert_ffn`` as the ranks call it."""
    seen = {}
    ffn = moe._expert_ffn

    def recorded(w, xe):
        seen[seq_parallel.current().rank] = (xe.detach().clone(),
                                             w["wg"].detach())
        return ffn(w, xe)

    monkeypatch.setattr(moe, "_expert_ffn", recorded)
    return seen


def leaf_collectives(specs, keep: bool) -> tuple[int, int]:
    """The leaf collectives over ``model`` a rank's call makes, the experts
    left out where ``keep``: (the leaves ``model`` shards, each gathered
    and its gradient reduce-scattered, the others, each gradient
    all-reduced)."""
    split = [k for k in specs
             if not (keep and k in param_gather.EXPERT_LEAVES)]
    n = sum(1 for k in split if "model" in sharding_axes(specs[k]))
    return n, len(split) - n


def sharding_axes(spec) -> set:
    return {a for e in spec for a in (e if isinstance(e, tuple) else (e,))
            if a is not None}


@pytest.mark.parametrize("m,s_local", SPLITS)
@pytest.mark.parametrize("arch", list(MIXERS))
def test_expert_layout_brings_the_row_to_each_ranks_experts(
        arch, m, s_local, monkeypatch):
    """The training rules shard the experts over ``model``: each rank runs
    its E / M experts over the whole row's bucket, the reference's cut to
    them bit for bit, and reduce-scatters the outputs back."""
    jcfg, pcfg, jp, x, d_out = mixer_inputs(arch, m, s_local)
    e = jcfg.n_experts
    specs = expert_specs(pcfg, m)
    assert all(specs[k][0] == "model" for k in param_gather.EXPERT_LEAVES)
    bucket = reference_bucket(jp, x, jcfg, monkeypatch)
    seen = expert_buckets(monkeypatch)
    (counts, keeps, got, got_dx, got_dp, want, want_dx,
     want_dp) = bound_split_against_whole(
        m, x, d_out, lambda p, x: jax_moe.moe_ffn_sort(p, x, jcfg), jp,
        lambda p, x: moe.moe_ffn_sort(p, x, pcfg), specs, monkeypatch)
    assert rel(got, want) <= OUT_TOL, rel(got, want)
    assert rel(got_dx, want_dx) <= GRAD_TOL, rel(got_dx, want_dx)
    for r, dp in enumerate(got_dp):
        for k, g in dp.items():
            w = rank_block(torch.from_numpy(np.array(want_dp[k])),
                           specs[k], m, r)
            assert g.shape == w.shape and rel(g, w) <= GRAD_TOL, (
                r, k, rel(g, w))
        xe, wg = seen[r]
        assert wg.shape[0] == e // m
        assert torch.equal(xe, torch.from_numpy(np.array(
            bucket[:, r * e // m:(r + 1) * e // m])))
        # the experts gathered over data alone (none here), never model
        assert sorted(k for k, keep in keeps[r] if keep == "model") == \
            sorted(param_gather.EXPERT_LEAVES)
    # a token gather and a reduce-scatter a call, each mirrored in the
    # backward, beside each other leaf's gather and reduce-scatter
    n, whole = leaf_collectives(specs, keep=True)
    assert counts == {"all_gather": m * (2 + n),
                      "reduce_scatter": m * (2 + n), "all_reduce": m * whole}


def test_expert_layout_needs_the_experts_to_divide(monkeypatch):
    """6 experts on 4 ranks: the training rules leave the expert dim
    whole, every rank gathers the experts whole and runs all of them on
    its own kept pairs, ranked after the earlier ranks' counts."""
    m, s_local = 4, 16
    jcfg, pcfg, jp, x, d_out = mixer_inputs(MIXTRAL, m, s_local,
                                            n_experts=6)
    specs = expert_specs(pcfg, m)
    assert all(specs[k][0] is None for k in param_gather.EXPERT_LEAVES)
    seen = expert_buckets(monkeypatch)
    (counts, keeps, got, got_dx, got_dp, want, want_dx,
     want_dp) = bound_split_against_whole(
        m, x, d_out, lambda p, x: jax_moe.moe_ffn_sort(p, x, jcfg), jp,
        lambda p, x: moe.moe_ffn_sort(p, x, pcfg), specs, monkeypatch)
    assert rel(got, want) <= OUT_TOL, rel(got, want)
    assert rel(got_dx, want_dx) <= GRAD_TOL, rel(got_dx, want_dx)
    for r, dp in enumerate(got_dp):
        for k, g in dp.items():
            w = rank_block(torch.from_numpy(np.array(want_dp[k])),
                           specs[k], m, r)
            assert rel(g, w) <= GRAD_TOL, (r, k, rel(g, w))
        assert seen[r][1].shape[0] == 6
        assert all(keep is None for _, keep in keeps[r])
    # each leaf model shards gathered whole (the router's gradient, whole,
    # all-reduced), and the counts gathered once
    n, whole = leaf_collectives(specs, keep=False)
    assert whole == 1 and counts == {"all_gather": m * (1 + n),
                                     "reduce_scatter": m * n,
                                     "all_reduce": m * whole}


@pytest.mark.parametrize("arch", list(MIXERS))
def test_onehot_dispatch_on_a_split_matches_reference(arch, monkeypatch):
    """The reference's comparison path under the expert layout: the
    one-hot positions over the gathered row for the rank's experts."""
    m, s_local = 2, 37
    jcfg, pcfg, jp, x, d_out = mixer_inputs(arch, m, s_local)
    (counts, keeps, got, got_dx, got_dp, want, want_dx,
     want_dp) = bound_split_against_whole(
        m, x, d_out, lambda p, x: jax_moe.moe_ffn_onehot(p, x, jcfg), jp,
        lambda p, x: moe.moe_ffn(p, x, pcfg, mode="onehot"),
        expert_specs(pcfg, m), monkeypatch)
    assert rel(got, want) <= OUT_TOL, rel(got, want)
    assert rel(got_dx, want_dx) <= GRAD_TOL, rel(got_dx, want_dx)
    specs = expert_specs(pcfg, m)
    for r, dp in enumerate(got_dp):
        for k, g in dp.items():
            w = rank_block(torch.from_numpy(np.array(want_dp[k])),
                           specs[k], m, r)
            assert rel(g, w) <= GRAD_TOL, (r, k, rel(g, w))
    n, whole = leaf_collectives(specs, keep=True)
    assert counts == {"all_gather": m * (2 + n),
                      "reduce_scatter": m * (2 + n), "all_reduce": m * whole}


def test_onehot_dispatch_raises_without_the_expert_layout():
    """Where every rank holds every expert (no binding, E not divisible
    by the split), a block would get a capacity and positions of its
    own: the one-hot path raises, and names that case."""
    jcfg, pcfg = both(MIXTRAL, n_experts=6)
    shapes = jax.eval_shape(lambda key: jax_moe.moe_init(key, jcfg,
                                                         jnp.float32),
                            jax.random.PRNGKey(0))
    p = to_port(draw({"moe": shapes}, 0)["moe"])
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 8, pcfg.d_model)).astype(np.float32))
    moe.moe_ffn(p, x, pcfg, mode="onehot")            # whole: runs
    with seq_parallel.split(seq_parallel.SeqSplit(None, 1, 4, 8)):
        with pytest.raises(NotImplementedError,
                           match="runs only where the step's binding "
                                 "shards the experts"):
            moe.moe_ffn(p, x, pcfg, mode="onehot")


# ----------------------------------------------------------- (b) MLA --

@pytest.mark.parametrize("sq,sk,q_offset", [(20, 48, 0), (20, 48, 13),
                                            (16, 64, 48), (48, 48, 0)])
def test_plain_attention_with_offset_matches_reference(sq, sk, q_offset):
    """MLA's widths (dk = nope + rope != dv): the rows at ``q_offset``
    against the reference's ``attend_parallel``; offset 0 is the call
    without one, bit for bit."""
    rng = np.random.default_rng(sq + sk + q_offset)
    q = rng.standard_normal((2, sq, 4, 24)).astype(np.float32)
    k = rng.standard_normal((2, sk, 4, 24)).astype(np.float32)
    v = rng.standard_normal((2, sk, 4, 16)).astype(np.float32)
    want = jax_attn.attend_parallel(q, k, v, causal=True, q_offset=q_offset)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = attn.attend_parallel_plain(tq, tk, tv, q_offset=q_offset)
    assert rel(got, want) <= OUT_TOL
    if q_offset == 0:
        assert torch.equal(got, attn.attend_parallel_plain(tq, tk, tv))


@pytest.mark.parametrize("m,s_local", SPLITS)
def test_split_mla_matches_whole_sequence(m, s_local):
    jcfg, pcfg = both(DEEPSEEK)
    shapes = jax.eval_shape(lambda key: jax_attn.mla_init(key, jcfg,
                                                          jnp.float32),
                            jax.random.PRNGKey(0))
    jp = draw({"attn": shapes}, 3 * m + s_local)["attn"]
    rng = np.random.default_rng(m + s_local)
    x = rng.standard_normal((2, m * s_local, jcfg.d_model)).astype(
        np.float32)
    d_out = rng.standard_normal(x.shape).astype(np.float32)
    counts, *figures = split_against_whole(
        m, [x], d_out,
        lambda p, x: jax_attn.mla_parallel(p, x, jcfg)[0], jp,
        lambda p, x: attn.mla_parallel(p, x, pcfg)[0])
    # the latent's gather a rank, and its gradient's reduce-scatter
    assert counts == {"all_gather": m, "reduce_scatter": m,
                      "all_reduce": 0}
    assert_close(*figures)


# ------------------------------------- (c) mixtral's windowed attention --

@pytest.mark.parametrize("m", [2, 4])
def test_split_windowed_attention_matches_whole_sequence(m):
    jcfg, pcfg = both(MIXTRAL, sliding_window=16)
    shapes = jax.eval_shape(lambda key: jax_attn.gqa_init(key, jcfg,
                                                          jnp.float32),
                            jax.random.PRNGKey(0))
    jp = draw({"attn": shapes}, 40 + m)["attn"]
    rng = np.random.default_rng(50 + m)
    x = rng.standard_normal((2, 64, jcfg.d_model)).astype(np.float32)
    d_out = rng.standard_normal(x.shape).astype(np.float32)
    counts, *figures = split_against_whole(
        m, [x], d_out,
        lambda p, x: jax_attn.gqa_parallel(p, x, jcfg)[0], jp,
        lambda p, x: attn.gqa_parallel(p, x, pcfg)[0])
    assert counts == {"all_gather": m, "reduce_scatter": m,
                      "all_reduce": 0}
    assert_close(*figures)


# ------------------------------------------------- (d) the launcher --

@pytest.mark.parametrize("arch,n_data,n_model", [
    (MIXTRAL, 1, 2), (MIXTRAL, 2, 2), (DEEPSEEK, 1, 2), (DEEPSEEK, 2, 2)])
def test_split_launcher_trains_moe_model(tmp_path, arch, n_data, n_model):
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

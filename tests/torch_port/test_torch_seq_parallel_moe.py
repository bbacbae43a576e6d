"""The MoE models (mixtral-8x22b, deepseek-v2-lite-16b) trained with each
sequence split over a ``model`` axis above 1, held against the JAX
package on the CPU.

Checked:

* (a) the MoE mixer: ``moe_ffn_sort`` split over 2 ranks of 37 tokens
  and 4 of 16 (gloo groups over a ``HashStore``, one thread a rank, so
  the counts' gathers run for real), at mixtral's 8 experts top-2 and
  deepseek's 64 top-6 with 2 shared experts, the capacity factor cut to
  0.75 and one expert made popular, so that pairs that a rank's own
  counts would keep are dropped for the pairs of the ranks before it
  (asserted from the reference's routes: the test cannot pass without
  such a drop); each rank's output against the reference's
  ``moe_ffn_sort`` over the whole sequence within 1e-6 of its largest
  magnitude, dx and the ranks' summed parameter gradients against
  ``jax.vjp`` within 1e-5 of each one's largest; one counts gather a
  rank and no reduce-scatter;
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
from repro_torch.distributed import seq_parallel  # noqa: E402
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


@pytest.mark.parametrize("m,s_local", SPLITS)
@pytest.mark.parametrize("arch", list(MIXERS))
def test_split_moe_matches_whole_sequence_dispatch(arch, m, s_local):
    jcfg, pcfg = both(arch, capacity_factor=CF, **MIXERS[arch])
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

    counts, *figures = split_against_whole(
        m, [x], d_out,
        lambda p, x: jax_moe.moe_ffn_sort(p, x, jcfg), jp,
        lambda p, x: moe.moe_ffn_sort(p, x, pcfg))
    # one gather of the counts a rank, and nothing to scatter back
    assert counts == {"all_gather": m, "reduce_scatter": 0,
                      "all_reduce": 0}
    assert_close(*figures)


def test_onehot_dispatch_raises_on_a_split():
    """The reference's comparison path has no split form: it raises with
    its ROADMAP item rather than give a block a capacity of its own."""
    jcfg, pcfg = both(MIXTRAL)
    shapes = jax.eval_shape(lambda key: jax_moe.moe_init(key, jcfg,
                                                         jnp.float32),
                            jax.random.PRNGKey(0))
    p = to_port(draw({"moe": shapes}, 0)["moe"])
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 8, pcfg.d_model)).astype(np.float32))
    moe.moe_ffn(p, x, pcfg, mode="onehot")            # whole: runs
    with seq_parallel.split(seq_parallel.SeqSplit(None, 1, 2, 8)):
        with pytest.raises(NotImplementedError,
                           match="'One-hot dispatch on a split'"):
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

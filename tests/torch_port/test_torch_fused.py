"""The port's fused routing step (`core/routing_fused.py`) against the port's
staged router and the reference's fused router, on the CPU.

Every case of the reference's ``tests/test_routing_fused.py``, with its
``hetero_agents``, ``make_batch``, lockstep and two-tier gate (``PAY_TOL``
1e-5, ``EST_TOL`` 1e-4): the fused router (``solver="cuda"`` on the CPU:
the plain versions of ``lcp_gather``, ``fused_phase1`` and
``auction_fused``) routes the same batches as the port's staged router
and, where the case says so, the reference's fused router, all fed the
staged router's Phase-4 observations; a lockstep stops at the first batch
whose assignment differs (tier 2), as the reference's does, since feedback
then lands on different agents.  The reference's compiled fused programs
are shared across its routers here (its per-router program cache is
wrapped by a module-level one), which only saves compile time.

Beside the gate: the plain Phase-1 pass against the reference program's
lat/cst/qual/values/X on the same trained state within ``EST_TOL`` (the
largest difference seen is 9.5e-7, one float32 ulp of the values: the
reference's XLA program on the CPU contracts ``delta * qual - (1 -
delta) * lat / lscale`` into a fused multiply-add, which the port does
not); the plain
pass against a float32 NumPy emulation of ``csrc/routing_fused.cu``'s
per-thread steps, bit for bit; the fused mode of the auction against the
reference's staged solver on the padded market, ε schedule, a tripped warm
budget and its cold re-solve bit for bit.  The card's cases (both kernels
and the CUDA fused router against the CPU ones, bit for bit) are in
``test_torch_cuda.py``, which imports nothing of JAX, so that they run on
a machine with a card and no JAX."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.routing_fused as ref_fused  # noqa: E402
from repro.core import mechanism as ref_mech  # noqa: E402
from repro.core.predictor import PredictorInput as RefInput  # noqa: E402
from repro.core.pricing import TokenPrices as RefPrices  # noqa: E402
from repro.core.solvers.dense_jax import _get_jax_solver  # noqa: E402
from repro_torch.core import mechanism as pm  # noqa: E402
from repro_torch.core.pricing import TokenPrices  # noqa: E402
from repro_torch.core.routing_fused import FUSED_SOLVERS  # noqa: E402
from repro_torch.core.solvers.dense_common import THETA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.auction_bid import (auction_fused_plain,  # noqa: E402
                                             fused_eps)
from repro_torch.kernels.routing_fused import (fused_phase1_plain,  # noqa: E402,E501
                                               packed_layout)

PAY_TOL = 1e-5          # float32 welfare -> float64 Clarke pivot drift
EST_TOL = 1e-4          # QoS estimate drift (relative scale ~1)
TELEMETRY = {"router_inflight": 2, "router_rps": 1.0,
             "agent_inflight": {"a0": 1}, "agent_rps": {"a1": 0.5}}


@pytest.fixture(scope="module", autouse=True)
def _shared_reference_programs():
    """One compiled reference program per variant for the whole module."""
    build = ref_fused._build_program
    ref_fused._build_program = functools.lru_cache(maxsize=None)(build)
    yield
    ref_fused._build_program = build


def hetero_agents(mech, m: int = 5, cap: int = 2):
    """Distinct per-agent prices => unique welfare optimum (no ties)."""
    prices = TokenPrices if mech is pm else RefPrices
    out = []
    for i in range(m):
        pr = prices(0.01 * (1 + i / m), 0.001 * (1 + i / m),
                    0.03 * (1 + i / m))
        out.append(mech.AgentInfo(f"a{i}", pr, cap,
                                  ("dialogue",) if i % 2 == 0
                                  else ("dialogue", "reasoning"),
                                  scale=4.0 + i, recurrent=(i == 3),
                                  cache_slots=2 if i == 1 else 0))
    return out


def make_batch(n: int, t: int, seed: int, parents: bool = False):
    """The reference's batches, as plain tuples for either package."""
    rng = np.random.default_rng(seed * 1000 + t)
    reqs = []
    for j in range(n):
        meta = {}
        if parents and j % 3 == 1:
            meta["parent_sessions"] = (f"d{(j + 1) % 4}", f"d{(j + 2) % 4}")
        reqs.append((f"r{t}_{j}", f"d{j % 4}",
                     rng.integers(0, 50, int(rng.integers(5, 30))), t,
                     "dialogue" if j % 2 == 0 else "reasoning", meta))
    return reqs


def requests(mech, batch):
    return [mech.Request(rid, did, toks.copy(), turn, dom, meta=dict(meta))
            for rid, did, toks, turn, dom, meta in batch]


def router(mech, agents_kw=None, **kw):
    if mech is pm:
        kw.setdefault("device", "cpu")
    return mech.IEMASRouter(hetero_agents(mech, **(agents_kw or {})), **kw)


def lockstep(ref, others, n_batches: int, seed: int, parents: bool = False):
    """Route identical batches through every router with the staged
    router's Phase-4 observations; yields (batch index, staged decisions,
    the others' decisions)."""
    rng = np.random.default_rng(seed + 99)
    for t in range(n_batches):
        batch = make_batch(int(rng.integers(2, 9)), t, seed, parents=parents)
        dr = ref.route_batch(requests(pm, batch), dict(TELEMETRY))
        ds = [r.route_batch(requests(pm if isinstance(r, pm.IEMASRouter)
                                     else ref_mech, batch), dict(TELEMETRY))
              for r in others]
        yield t, dr, ds
        for d in dr:
            if d.agent_id:
                kw = dict(latency=0.03 + 0.01 * rng.random(),
                          n_prompt=len(d.request.tokens), n_hit=0, n_gen=20,
                          quality=0.7)
                for r in [ref, *others]:
                    mech = pm if isinstance(r, pm.IEMASRouter) else ref_mech
                    r.on_complete(d.request.request_id,
                                  mech.CompletionObs(**kw))


def assert_decisions_match(t, dr, df):
    """The reference's two-tier gate: identical assignments => payments
    and estimates within float32 tolerance; a different assignment must be
    welfare-equivalent within the auction's ε-optimality gap.  Returns
    whether tier 1 held."""
    a_r = [d.agent_id for d in dr]
    a_f = [d.agent_id for d in df]
    w_r = sum(d.welfare_weight for d in dr)
    w_f = sum(d.welfare_weight for d in df)
    if a_f != a_r:
        assert abs(w_f - w_r) <= 1e-5 * max(1.0, abs(w_r)), \
            f"batch {t}: fused {a_f} (welfare {w_f}) != staged {a_r} " \
            f"(welfare {w_r}) beyond the ε-optimality gap"
        return False
    for r, f in zip(dr, df):
        assert abs(r.payment - f.payment) < PAY_TOL, \
            f"batch {t}: payment {f.payment} vs {r.payment}"
        if r.agent_id:
            assert abs(r.estimate.latency - f.estimate.latency) < EST_TOL
            assert abs(r.estimate.cost - f.estimate.cost) < EST_TOL
            assert abs(r.estimate.quality - f.estimate.quality) < EST_TOL
    return True


def run_gated(staged, fused, n_batches, seed, *, parents=False,
              reference=None):
    """Lockstep under the two-tier gate against the staged router (and the
    reference's fused router when given); stops at the first tier 2."""
    others = [fused] + ([reference] if reference is not None else [])
    tiers = []
    for t, dr, ds in lockstep(staged, others, n_batches, seed, parents):
        ok = assert_decisions_match(t, dr, ds[0])
        if reference is not None:
            ok = assert_decisions_match(t, ds[1], ds[0]) and ok
        tiers.append(ok)
        if not ok:
            break   # post-divergence feedback lands on different agents
    return tiers


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("warm", [False, True])
def test_fused_matches_staged(seed, warm):
    """Decision parity vs the port's staged router over randomized
    lockstep batches, cold and warm-started."""
    kw = dict(solver="cuda", n_hubs=1, warm_start=warm)
    run_gated(router(pm, **kw), router(pm, fused=True, **kw), 5, seed)


@pytest.mark.parametrize("warm", [False, True])
def test_fused_matches_reference_fused(warm):
    """The same gate against the reference's fused router as well."""
    kw = dict(n_hubs=1, warm_start=warm)
    run_gated(router(pm, solver="cuda", **kw),
              router(pm, solver="cuda", fused=True, **kw), 5, seed=1,
              reference=router(ref_mech, solver="dense-jax", fused=True,
                               **kw))


def test_fused_matches_staged_with_parent_credit():
    """DAG parent-session credit (the max over the candidate rows inside
    the Phase-1 pass) keeps parity with the staged ``parent_credit`` host
    path, and with the reference's fused router."""
    kw = dict(solver="cuda", n_hubs=1, warm_start=True)
    run_gated(router(pm, **kw), router(pm, fused=True, **kw), 5, seed=7,
              parents=True,
              reference=router(ref_mech, solver="dense-jax", n_hubs=1,
                               warm_start=True, fused=True))


def test_fused_matches_staged_dense_torch():
    """The other fused solver name (the reference's pallas case): the
    plain single-market solver composes into the step the same way."""
    kw = dict(n_hubs=1, warm_start=False)
    run_gated(router(pm, agents_kw=dict(m=4), solver="dense-torch", **kw),
              router(pm, agents_kw=dict(m=4), solver="dense-torch",
                     fused=True, **kw), 2, seed=3)


@pytest.mark.parametrize("ref_solver", ["mcmf", "dense"])
def test_fused_welfare_within_gap_of_reference(ref_solver):
    """The host solvers that cannot compose into the step are covered by
    the ε-scaling optimality gap."""
    kw = dict(n_hubs=1, warm_start=False)
    ref = router(pm, solver=ref_solver, use_kernel_affinity=False, **kw)
    fused = router(pm, solver="cuda", fused=True, **kw)
    for t, dr, (df,) in lockstep(ref, [fused], 4, seed=5):
        w_r = sum(d.welfare_weight for d in dr)
        w_f = sum(d.welfare_weight for d in df)
        assert abs(w_f - w_r) <= 1e-3 * max(1.0, w_r), \
            f"batch {t}: fused welfare {w_f} vs {ref_solver} {w_r}"
        if [d.agent_id for d in dr] != [d.agent_id for d in df]:
            break   # states drift once feedback lands on different agents


def test_fused_init_requires_single_hub():
    with pytest.raises(ValueError, match="n_hubs=1"):
        router(pm, solver="cuda", n_hubs=2, fused=True)


@pytest.mark.parametrize("solver", ["mcmf", "dense"])
def test_fused_init_requires_staged_solver(solver):
    assert solver not in FUSED_SOLVERS
    with pytest.raises(ValueError, match="fused=True requires a solver"):
        router(pm, solver=solver, n_hubs=1, fused=True)


def test_fused_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.IEMASRouter(hetero_agents(pm), solver="cuda", fused=True)


def test_fused_shape_buckets_bound_buffers():
    """Every batch size inside one pow-2 bucket reuses the step's device
    buffers, even with Phase-4 feedback growing the forests: fleet 16,
    batches 9..16 (the reference's retrace bound, headroom 2)."""
    fused = router(pm, agents_kw=dict(m=16, cap=2), solver="cuda", n_hubs=1,
                   warm_start=False, fused=True)
    rng = np.random.default_rng(11)

    def route(n, t):
        for d in fused.route_batch(requests(pm, make_batch(n, t, seed=13)),
                                   dict(TELEMETRY)):
            if d.agent_id:
                fused.on_complete(
                    d.request.request_id,
                    pm.CompletionObs(latency=0.02 + 0.01 * rng.random(),
                                     n_prompt=len(d.request.tokens), n_hit=0,
                                     n_gen=16, quality=0.75))

    route(12, 0)
    before = fused._fused.cache_size()
    for t, n in enumerate(range(9, 17)):
        route(n, t + 1)
    grew = fused._fused.cache_size() - before
    assert grew <= 2, f"the fused step took {grew} new shape keys in a bucket"


class CountingProfiler:
    """Duck-typed profiler: ``phase()`` and ``note_fused_step()``."""

    def __init__(self):
        self.phases = []
        self.host_transfers = self.mid_syncs = self.retraces = 0

    def phase(self, name):
        self.phases.append(name)
        return __import__("contextlib").nullcontext()

    def note_fused_step(self, host_transfers, mid_syncs, retraces):
        self.host_transfers += host_transfers
        self.mid_syncs += mid_syncs
        self.retraces += retraces


def test_fused_profiler_counters():
    """Each step notes exactly one host transfer and zero mid-step syncs,
    under the ``fused_route`` phase."""
    fused = router(pm, solver="cuda", n_hubs=1, fused=True)
    fused.profiler = prof = CountingProfiler()
    for t in range(3):
        fused.route_batch(requests(pm, make_batch(4, t, seed=17)),
                          dict(TELEMETRY))
    assert (prof.host_transfers, prof.mid_syncs) == (3, 0)
    assert prof.retraces >= 1
    assert prof.phases.count("fused_route") == 3
    assert "phase1_predict" not in prof.phases


# ------------------------------------------- the Phase-1 pass, directly --
def _train_both(port, ref, seed: int, n_obs: int = 700):
    """The same ledger entries and predictor observations into a port and
    a reference router, so their trees split identically."""
    rng = np.random.default_rng(seed)
    for k in range(n_obs):
        aid = f"a{k % 5}"
        x = rng.uniform(0, 1, 10) * np.array([30, 4, 1, 3, 2, 2, 1, 2, 1, 1])
        lat = 0.02 + 0.3 * (x[0] > 15)
        cost = 0.01 + 2.0 * (x[2] > 0.5)
        q = float(x[9] > 0.5)
        port.pool[aid].update(pm.PredictorInput(*x), lat, cost, q)
        ref.pool[aid].update(RefInput(*x), lat, cost, q)
    for k in range(12):
        toks = rng.integers(0, 50, int(rng.integers(5, 30)))
        for r in (port, ref):
            r.ledger.update(f"a{k % 5}", f"d{k % 4}", toks)


def _steps(port, ref, batch):
    live_p = [a for a in port.agents if a.agent_id not in port.quarantined]
    live_r = [a for a in ref.agents if a.agent_id not in ref.quarantined]
    caps = [a.capacity for a in live_p]
    got = port._fused.step(requests(pm, batch), live_p, dict(TELEMETRY),
                           caps)
    want = ref._fused.step(requests(ref_mech, batch), live_r,
                           dict(TELEMETRY), caps)
    return got, want


@pytest.mark.parametrize("parents", [False, True])
def test_phase1_pass_matches_reference_program(parents):
    """The plain Phase-1 pass against the reference program's outputs on
    the same trained state (split trees, a recurrent agent, an LRU-capped
    agent, the optimism bonus on): lat, cst, qual, X equal, the values
    within EST_TOL (largest difference seen 9.5e-7, one float32
    ulp of values near 8)."""
    port = router(pm, solver="cuda", n_hubs=1, fused=True)
    ref = router(ref_mech, solver="dense-jax", n_hubs=1, fused=True)
    _explorers(port, ref)
    _train_both(port, ref, seed=3)
    assert port.pool["a0"].lat.compiled().depth >= 1
    worst = 0.0
    for t in range(3):
        batch = make_batch(7, t, seed=21, parents=parents)
        got, want = _steps(port, ref, batch)
        for g, w in zip(got[:5], want[:5]):
            assert g.shape == w.shape
            worst = max(worst, float(np.abs(g - w).max()))
        for k in (0, 1, 2, 4):          # lat, cst, qual, X
            assert np.array_equal(got[k], want[k])
    assert worst < EST_TOL


def _emulate_phase1(a, lay):
    """``fused_phase1_kernel`` step by step in float32 NumPy (every step
    rounded, nothing fused), per pair, in the CUDA source's order."""
    f = np.float32
    nb, mb, cb = a.nb, a.mb, a.cb
    g = {k: getattr(a, k).numpy() for k in (
        "lcp", "rows", "alen", "plen", "cj", "keep", "ckeep", "ext",
        "req_mask", "agent_mask", "counts", "turns", "dom", "router",
        "inflight", "rps", "caps", "blend", "val_cfg")}
    forests = [{k: getattr(fo, k).numpy() for k in (
        "feature", "left", "right", "roots", "threshold", "value")}
        | {"depth": fo.depth} for fo in a.forests]

    def affinity(raw, llen, pl, ext):
        lcp = min(raw, pl, llen)
        pl1 = f(max(pl, 1))
        if ext:
            return f(f(llen) / pl1) if (lcp == llen and llen > 0) else f(0)
        return f(f(lcp) / pl1)

    out = {k: np.zeros((nb, mb), np.float32)
           for k in ("lat", "cst", "qual", "values", "W")}
    X = np.zeros((nb, mb, 10), np.float32)
    wmax = f(0)
    for j in range(nb):
        for i in range(mb):
            pl, ext = int(g["plen"][j]), bool(g["ext"][i])
            o = affinity(int(g["lcp"][j, i]),
                         int(g["alen"][g["rows"][j, i]]), pl, ext) \
                if g["keep"][j, i] else f(0)
            for c in range(cb):
                if g["cj"][c] != j:
                    continue
                cred = affinity(int(g["lcp"][nb + c, i]),
                                int(g["alen"][g["rows"][nb + c, i]]), pl,
                                ext) if g["ckeep"][c, i] else f(0)
                o = max(o, cred)
            x = np.array([f(pl), g["turns"][j], o, g["router"][0],
                          g["router"][1], g["inflight"][i], g["rps"][i],
                          g["caps"][i],
                          f(g["inflight"][i] / max(f(1), g["caps"][i])),
                          g["dom"][j, i]], np.float32)
            raw = []
            for fo in forests:
                cur = int(fo["roots"][i])
                for _ in range(fo["depth"]):
                    ft = int(fo["feature"][cur])
                    if ft < 0:
                        break
                    cur = int(fo["left"][cur] if x[ft] <= fo["threshold"][cur]
                              else fo["right"][cur])
                raw.append(fo["value"][cur])
            (lpt, lb, miss, hit, out_, ewma, n_obs, warm_n, prior_q, rep,
             expl) = g["blend"][:, i]
            uncached = f(x[0] * f(f(1) - x[2]))
            prior_lat = f(f(lb + f(lpt * uncached)) * f(f(1) + x[8]))
            npmt = f(np.trunc(x[0]))
            nhit = f(x[2] * npmt)
            prior_cst = f(f(f(miss * f(npmt - nhit)) + f(hit * nhit))
                          + f(out_ * ewma))
            wgt = f(min(f(1), f(n_obs / f(60))) * rep)
            keep_w = f(f(1) - wgt)
            lat = f(f(keep_w * prior_lat) + f(wgt * max(f(0), raw[0])))
            cst = f(f(keep_w * prior_cst) + f(wgt * max(f(0), raw[1])))
            cold = n_obs < warm_n
            if cold:
                lat, cst = prior_lat, prior_cst
            qual = f(prior_q * rep) if cold else \
                f(min(max(raw[2], f(0)), f(1)) * rep)
            if expl != 0:
                qual = min(f(1), f(qual + f(expl / np.sqrt(f(f(1) + n_obs)))))
            delta, lscale, vscale = g["val_cfg"]
            value = f(vscale * f(f(delta * min(max(qual, f(0)), f(1)))
                                 - f(f(f(f(1) - delta) * lat) / lscale)))
            w = f(value - cst)
            w = w if w > 0 else f(0)
            if not (g["req_mask"][j] and g["agent_mask"][i]):
                w = f(0)
            if g["counts"][i] > 0:
                wmax = max(wmax, w)
            for k, v in (("lat", lat), ("cst", cst), ("qual", qual),
                         ("values", value), ("W", w)):
                out[k][j, i] = v
            X[j, i] = x
    return out, X, wmax


def _record_phase1(monkeypatch, sink):
    real = ops.fused_phase1_op

    def rec(args, out, lay):
        res = real(args, out, lay)
        # the step's buffers and the ledger arena are reused: keep copies
        sink.append((args.map(torch.clone), out.clone(), lay))
        return res

    monkeypatch.setattr(ops, "fused_phase1_op", rec)


def test_phase1_plain_equals_float32_emulation_of_the_kernel(monkeypatch):
    """The plain pass (PyTorch on the CPU) equals, bit for bit, a per-pair
    float32 NumPy emulation of the CUDA kernel's steps, on the main path's
    own calls: cold and trained agents, parents, padding, the optimism
    bonus.  What the card adds on top is checked by the cuda cases."""
    calls = []
    _record_phase1(monkeypatch, calls)
    port = router(pm, solver="cuda", n_hubs=1, fused=True)
    ref = router(ref_mech, solver="dense-jax", n_hubs=1, fused=True)
    _explorers(port, ref)
    port.route_batch(requests(pm, make_batch(3, 0, seed=2)), dict(TELEMETRY))
    _train_both(port, ref, seed=4, n_obs=500)
    port.route_batch(requests(pm, make_batch(6, 1, seed=2, parents=True)),
                     dict(TELEMETRY))
    assert len(calls) == 2 and calls[1][0].cb > 0
    for args, out, lay in calls:
        want, X, wmax = _emulate_phase1(args, lay)
        for k, v in want.items():
            at = getattr(lay, k)
            got = out[at:at + lay.pairs].numpy().reshape(lay.nb, lay.mb)
            assert np.array_equal(got.view(np.int32), v.view(np.int32)), k
        gotX = out[lay.X:lay.X + 10 * lay.pairs].numpy().reshape(X.shape)
        assert np.array_equal(gotX.view(np.int32), X.view(np.int32))
        assert out[0].item() == float(wmax)


def _explorers(*routers):
    """The optimism bonus on two agents of each router, off elsewhere."""
    for r in routers:
        for aid in ("a0", "a2"):
            r.pool[aid].explore = 0.05


# -------------------------------------------- the auction's fused mode --
def _padded_market(seed, nb=16, mb=8, cbu=4, m=6, n=11):
    rng = np.random.default_rng(seed)
    W = np.zeros((nb, mb), np.float32)
    W[:n, :m] = rng.uniform(0, 4, (n, m)) * (rng.random((n, m)) > 0.3)
    counts = np.zeros(mb, np.int32)
    counts[:m] = rng.integers(1, cbu + 1, m)
    return W, counts


def _reference_eps(W, counts, grid, warm):
    """Lines 308-320 of the reference's fused program, in jnp float32."""
    import jax.numpy as jnp

    Wj = jnp.asarray(W)
    wmax = jnp.max(jnp.where(jnp.asarray(counts)[None, :] > 0, Wj, 0.0))
    anchor = jnp.maximum(wmax, 1.0)
    eps_final = jnp.maximum(1e-5 * anchor,
                            64.0 * float(np.finfo(np.float32).eps) * anchor)
    theta = jnp.asarray(THETA, jnp.float32)
    cold_eps0 = jnp.maximum(wmax / theta, eps_final)
    fine = jnp.maximum(wmax / theta ** 3, eps_final)
    eps0 = jnp.where(jnp.asarray(grid).max() > fine, fine, cold_eps0) \
        if warm else cold_eps0
    return (np.float32(eps0), np.float32(eps_final), np.float32(cold_eps0),
            np.float32(wmax))


@pytest.mark.parametrize("case", ["cold", "warm", "tripped"])
def test_auction_fused_plain_matches_reference_solver(case):
    """The fused mode's plain version: its ε schedule equals the reference
    program's, and its warm attempt, trip and cold re-solve equal the
    reference's staged solver on the padded market, bit for bit."""
    nb, mb, cbu = 16, 8, 4
    W, counts = _padded_market(5)
    warm = case != "cold"
    grid = np.zeros((mb, cbu), np.float32)
    if warm:
        first = _get_jax_solver(200_000, batched=False)(
            W, counts, grid, *(_reference_eps(W, counts, grid, False)[:2]),
            THETA)
        grid = np.asarray(first[0]) * np.float32(1.3)
    budget = 3 if case == "tripped" else 2_000
    eps0, eps_final, cold_eps0, wmax = _reference_eps(W, counts, grid, warm)
    assert fused_eps(wmax, grid.max(), warm=warm, theta=THETA) == \
        (eps0, eps_final, cold_eps0)
    want = _get_jax_solver(budget if warm else 200_000, batched=False)(
        W, counts, grid, eps0, eps_final, THETA)
    tripped = warm and int(want[3]) >= budget
    assert tripped == (case == "tripped")
    if tripped:
        want = _get_jax_solver(200_000, batched=False)(
            W, counts, np.zeros_like(grid), cold_eps0, eps_final, THETA)
    lay = packed_layout(nb, mb, cbu)
    out = torch.zeros(lay.total)
    out[0] = float(wmax)
    out[lay.W:lay.W + nb * mb] = torch.from_numpy(W.ravel())
    auction_fused_plain(out, torch.from_numpy(counts),
                        torch.from_numpy(grid.ravel()), lay, budget=budget,
                        max_rounds=200_000, warm=warm, theta=THETA)
    ints = out.view(torch.int32)
    price = out[lay.price:lay.price + mb * cbu].numpy().reshape(mb, cbu)
    assert np.array_equal(price.view(np.int32),
                          np.asarray(want[0]).view(np.int32))
    assert np.array_equal(ints[lay.agent_of:lay.agent_of + nb].numpy(),
                          np.asarray(want[1]))
    assert np.array_equal(ints[lay.unit_of:lay.unit_of + nb].numpy(),
                          np.asarray(want[2]))
    assert (int(ints[1]), bool(ints[2]), np.float32(out[3].item())) == \
        (int(want[3]), tripped, eps_final)

"""The reference's truthfulness battery (``tests/test_truthfulness.py``) on
the port, held against the reference.

Four backend pairs, port against reference: ``dense`` / ``dense``,
``mcmf`` / ``mcmf``, ``dense-torch`` / ``dense-jax`` and ``cuda`` (its
plain staged market on the CPU) / ``dense-jax``.  Checked:

* `client_utilities` equals the reference's on the same results;
* the spill-round DSIC caveat (`core/mechanism.py`, Phase 2: Clarke pivots
  are per market, so a request that tanks round 1 buys uncontested
  residual capacity in the cross-hub spill round), with spill on and off
  on every pair: the same utilities and rounds in both packages, the
  caveat reproduced with spill on and closed with spill off;
* per-round DSIC on degenerate 5 x 3 markets (column caps down to 0):
  the port's assignments and payments equal the reference's exactly, and
  honesty dominates within the reference's slack;
* the settlement ledger reconciles under spill and injected faults, and
  its accounts and head equal the reference's on the same run.
"""
import numpy as np
import pytest
from _hypothesis_compat import given, settings, strategies as st

pytest.importorskip("torch")

import repro.serving as ref_serving  # noqa: E402
import repro_torch.serving as port_serving  # noqa: E402
from repro.configs.iemas_cluster import RouterConfig as RefRouterConfig  # noqa
from repro.core import auction as ref_auction  # noqa: E402
from repro.serving import workload as ref_wl  # noqa: E402
from repro_torch.configs.iemas_cluster import RouterConfig  # noqa: E402
from repro_torch.core.auction import (SPILL_HUB, client_utilities,  # noqa
                                      run_auction, run_sharded_auction)
from repro_torch.serving import workload as port_wl  # noqa: E402

ATOL = 1e-6
PAIRS = [("dense", "dense"), ("mcmf", "mcmf"), ("dense-torch", "dense-jax"),
         ("cuda", "dense-jax")]


def port_sharded(*args, **kw):
    return run_sharded_auction(*args, device="cpu", **kw)


def port_auction(*args, **kw):
    return run_auction(*args, device="cpu", **kw)


def same_result(port, ref) -> None:
    assert list(port.assignment) == list(ref.assignment)
    assert [float(p) for p in port.payments] == \
        [float(p) for p in ref.payments]


# ------------------------------------------------- the spill-round caveat --
# hub 0 owns only agent 0; both requests are pinned there, agent 1 is pure
# residual capacity only the spill round can reach.
_SPILL_VALUES = np.array([[4.9, 0.0], [5.0, 4.8]])
_SPILL_COSTS = np.zeros((2, 2))
_SPILL_CAPS = [1, 1]
_SPILL_BLOCKS = {0: ([0, 1], [0])}


def _true_utility(sharded, reported, solver, *, spill):
    """Request 1's utility at TRUE values in the sharded market (and the
    round, if any, that served it)."""
    res = sharded(reported, _SPILL_COSTS, _SPILL_CAPS, _SPILL_BLOCKS,
                  solver=solver, spill=spill, spill_agents=[0, 1])
    reqs, ags = _SPILL_BLOCKS[0]
    for bj, bi in enumerate(res[0].assignment):
        if reqs[bj] == 1 and bi >= 0:
            return _SPILL_VALUES[1, ags[bi]] - res[0].payments[bj], "round1"
    if spill and SPILL_HUB in res:
        sp = res[SPILL_HUB]
        meta = sp.solver_stats["spill"]
        for bj, bi in enumerate(sp.assignment):
            if meta["r_idx"][bj] == 1 and bi >= 0:
                return (_SPILL_VALUES[1, meta["a_idx"][bi]]
                        - sp.payments[bj], "spill")
    return 0.0, "unmatched"


def _tanked():
    lied = _SPILL_VALUES.copy()
    lied[1, 0] = 0.0            # tank the contested in-hub bid
    return lied


@pytest.mark.parametrize("port_solver,ref_solver", PAIRS)
def test_spill_round_dsic_caveat_regression(port_solver, ref_solver):
    """spill=True: request 1 tanks its in-hub bid, loses round 1 on
    purpose and buys agent 1's residual slot for free in the spill round
    (utility 4.8 against 0.1 honest), in both packages alike."""
    out = {}
    for tag, sharded, solver in (
            ("port", port_sharded, port_solver),
            ("ref", ref_auction.run_sharded_auction, ref_solver)):
        out[tag] = (_true_utility(sharded, _SPILL_VALUES, solver, spill=True),
                    _true_utility(sharded, _tanked(), solver, spill=True))
    assert out["port"] == out["ref"]
    (u_honest, how_h), (u_lied, how_l) = out["port"]
    assert how_h == "round1" and u_honest == pytest.approx(0.1)
    assert how_l == "spill" and u_lied == pytest.approx(4.8)
    assert u_lied > u_honest + 1.0


@pytest.mark.parametrize("port_solver,ref_solver", PAIRS)
def test_no_spill_restores_strict_dsic_on_caveat_instance(port_solver,
                                                          ref_solver):
    """spill=False closes the loophole on every pair: the same tank
    strands request 1, so honesty dominates again."""
    out = {}
    for tag, sharded, solver in (
            ("port", port_sharded, port_solver),
            ("ref", ref_auction.run_sharded_auction, ref_solver)):
        out[tag] = (_true_utility(sharded, _SPILL_VALUES, solver,
                                  spill=False),
                    _true_utility(sharded, _tanked(), solver, spill=False))
    assert out["port"] == out["ref"]
    (u_honest, _), (u_lied, how) = out["port"]
    assert how == "unmatched"
    assert u_lied <= u_honest + ATOL


# ------------------------------------------------------- per-round DSIC --
@st.composite
def degenerate_markets(draw):
    """5 x 3 markets with capacitated columns down to cap 0 (dead agents);
    the shape is fixed so that the reference's jitted solver traces
    once."""
    n, m = 5, 3
    values = np.array([[round(draw(st.floats(0, 5, allow_nan=False)), 3)
                        for _ in range(m)] for _ in range(n)])
    costs = np.array([[round(draw(st.floats(0, 3, allow_nan=False)), 3)
                       for _ in range(m)] for _ in range(n)])
    caps = [draw(st.integers(0, 2)) for _ in range(m)]
    return values, costs, caps


def _slack(solver, *results):
    """The reference's DSIC slack: ATOL for the exact backends, the
    certified ε-gap on top for the float32 staged ones."""
    if solver in ("mcmf", "dense"):
        return ATOL
    gap = sum(float(r.solver_stats.get("gap_bound", 0.0)) for r in results)
    return max(ATOL, gap + 1e-4)


@settings(max_examples=25, deadline=None)
@given(degenerate_markets(), st.integers(0, 4), st.floats(-2, 2))
def test_dsic_every_backend_degenerate_caps(mkt, j_idx, deviation):
    """Honest utility >= every misreport, per round, on every pair; the
    port's results and utilities equal the reference's."""
    values, costs, caps = mkt
    j = j_idx % values.shape[0]
    lied = values.copy()
    lied[j] = np.maximum(lied[j] + deviation, 0.0)
    for port_solver, ref_solver in PAIRS:
        honest = port_auction(values, costs, caps, solver=port_solver)
        strategic = port_auction(lied, costs, caps, solver=port_solver)
        same_result(honest, ref_auction.run_auction(values, costs, caps,
                                                    solver=ref_solver))
        ref_strategic = ref_auction.run_auction(lied, costs, caps,
                                                solver=ref_solver)
        same_result(strategic, ref_strategic)
        u_honest = client_utilities(honest, values)[j]
        u_lied = client_utilities(strategic, values)[j]   # at TRUE values
        np.testing.assert_array_equal(
            client_utilities(strategic, values),
            ref_auction.client_utilities(ref_strategic, values))
        assert u_lied <= u_honest + _slack(port_solver, honest, strategic), \
            port_solver


def test_all_caps_zero_routes_nothing():
    """A fully dead market matches and charges nobody on every backend."""
    values = np.array([[3.0, 1.0], [2.0, 2.5]])
    for port_solver, _ in PAIRS:
        r = port_auction(values, np.zeros((2, 2)), [0, 0],
                         solver=port_solver)
        assert list(r.assignment) == [-1, -1], port_solver
        assert all(p == 0.0 for p in r.payments), port_solver
        np.testing.assert_array_equal(client_utilities(r, values), 0.0)


# ------------------------------------------------------------ the ledger --
def _ledger_run(serving, router_config, wl, **kw):
    """The reference test's run (8 agents, faults, spill on, 2 hubs, warm
    starts, audit ledger) through one package's serving stack: its
    router."""
    cluster = serving.SimCluster(8, seed=3, fail_prob=0.15,
                                 engine_mode="analytic", **kw)
    router = serving.make_router(cluster, router_config(
        solver="dense", n_hubs=2, warm_start=True, spill=True,
        audit_ledger=True))
    serving.run_workload(cluster, router, wl.generate(
        wl.WorkloadSpec("coqa_like", n_dialogues=8, seed=4)),
        max_new_tokens=4)
    return router


def test_ledger_reconciles_under_spill_and_faults():
    """The sharded router with the spill round live and injected faults:
    the hash chain verifies, the ledger's replay equals the router's
    accounts to the bit, and the accounts and the ledger's head equal the
    reference's on the same run."""
    router = _ledger_run(port_serving, RouterConfig, port_wl, device="cpu")
    led = router.settlement
    assert led.verify_chain()
    balances = led.audit(router.accounts)      # raises on any divergence
    assert balances["settled"] + balances["faults"] == \
        router.accounts["matched"]
    assert balances["faults"] > 0              # the fault path fired
    assert balances["payments"] == router.accounts["payments"]
    assert balances["welfare_realized"] == \
        router.accounts["welfare_realized"]
    ref = _ledger_run(ref_serving, RefRouterConfig, ref_wl)
    assert dict(router.accounts) == dict(ref.accounts)
    assert len(led) == len(ref.settlement)
    assert led.head == ref.settlement.head

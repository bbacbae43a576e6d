"""Carry a running router's state into a port router.

``router_from_reference_state`` builds a `repro_torch` router in the state
that a plain-data dict describes — NumPy arrays, numbers, strings, tuples
and dicts, nothing that needs the reference package to read.  A caller
(for example a test holding a live reference router) walks its objects into
that dict; the port never imports the reference.

The dict, taken at a quiescent point (no request in flight), holds:

* ``ledger``: the `PaddedLedgerStore` arena (``tokens``, ``lens``,
  ``row_of`` as ((agent, session), row) pairs, ``free``, ``next``) and the
  per-agent session order (``by_agent``: (agent, ((session, clock), ...))
  in recency order) with the ledger ``clock``;
* ``predictors``: per agent, ``n_obs``, ``ewma_gen``, ``reputation`` and
  the three trees ``lat``/``cost``/``quality`` (see `tree_from_state`),
  plus ``rep_ledger``, the parked reputations of departed identities;
* ``price_book``: ``entries`` as (hub, version, agent ids, capacities,
  ((agent, ascending unit prices), ...)) and the ``warm_hits``,
  ``cold_starts`` and ``stores`` counters;
* ``accounts``, ``quarantined``, ``agent_set_version``;
* ``settlement`` (optional): the hash-chained entries as field dicts, so
  the chain continues from the same head.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.iemas_cluster import RouterConfig, make_router
from repro_torch.core.hoeffding import _LeafStats, _Node
from repro_torch.core.ledger import SettlementEntry

__all__ = ["router_from_reference_state", "tree_from_state"]

_STATS = ("n", "s", "ss", "cls", "bins_lo", "bins_hi", "bin_n", "bin_s",
          "bin_ss", "bin_cls")


def _node_from_state(nodes, pos: int, n_feat: int) -> tuple[_Node, int]:
    """Rebuild the subtree whose preorder starts at ``nodes[pos]``; returns
    it and the position after it."""
    spec = nodes[pos]
    node = _Node(n_feat, int(spec["depth"]))
    node.feature = int(spec["feature"])
    node.threshold = float(spec["threshold"])
    if node.feature < 0:
        st = spec["stats"]
        stats = _LeafStats(n_feat, int(st["n_bins"]))
        for k in _STATS:
            v = st[k]
            setattr(stats, k, np.array(v, dtype=np.float64)
                    if isinstance(v, np.ndarray) else v)
        node.stats = stats
        return node, pos + 1
    node.stats = None
    node.left, pos = _node_from_state(nodes, pos + 1, n_feat)
    node.right, pos = _node_from_state(nodes, pos, n_feat)
    return node, pos


def tree_from_state(tree, spec: dict) -> None:
    """Load a Hoeffding tree in place from ``spec``: ``nodes`` in preorder
    (``feature``, ``threshold``, ``depth`` and, for a leaf, ``stats`` with
    the leaf's sufficient statistics), ``n_seen``, ``y_min``, ``y_max`` and
    the regressor's ``global_s`` or the classifier's ``global_cls``."""
    root, end = _node_from_state(spec["nodes"], 0, tree.n_features)
    if end != len(spec["nodes"]):
        raise ValueError("tree spec has nodes outside the preorder walk")
    tree.root = root
    tree.n_seen = int(spec["n_seen"])
    tree._y_min = float(spec["y_min"])
    tree._y_max = float(spec["y_max"])
    if tree.classification:
        tree._global_cls = np.array(spec["global_cls"], dtype=np.float64)
    else:
        tree._global_s = float(spec["global_s"])
    tree._version += 1
    tree._struct_version += 1        # the compiled form is rebuilt on use


def router_from_reference_state(state: dict, infos: list,
                                 cfg: RouterConfig | None = None,
                                 device="cuda"):
    """A port router over ``infos`` (built from ``cfg`` on ``device``) in
    the state ``state`` describes; see the module docstring."""
    router = make_router(infos, cfg, device)

    led = state["ledger"]
    store = router.ledger.store
    store.tokens = np.array(led["tokens"], dtype=np.int32)
    store.lens = np.array(led["lens"], dtype=np.int32)
    store.row_of = {tuple(k): int(r) for k, r in led["row_of"]}
    store._free = [int(r) for r in led["free"]]
    store._next = int(led["next"])
    router.ledger._by_agent = {aid: {d: int(c) for d, c in sessions}
                               for aid, sessions in led["by_agent"]}
    router.ledger._clock = int(led["clock"])

    for aid, ps in state["predictors"].items():
        pred = router.pool[aid]
        pred.n_obs = int(ps["n_obs"])
        pred.ewma_gen = float(ps["ewma_gen"])
        pred.reputation = float(ps["reputation"])
        for name in ("lat", "cost", "quality"):
            tree_from_state(getattr(pred, name), ps[name])
    router.pool._rep_ledger = dict(state.get("rep_ledger", {}))
    router.pool._stacks.clear()

    book = router.price_book
    pb = state["price_book"]
    book._book = {
        int(h): (int(version), tuple(ids), tuple(int(c) for c in caps),
                 {aid: np.array(p, dtype=np.float64) for aid, p in prices})
        for h, version, ids, caps, prices in pb["entries"]}
    book.warm_hits = int(pb["warm_hits"])
    book.cold_starts = int(pb["cold_starts"])
    book.stores = int(pb["stores"])

    router.accounts = dict(state["accounts"])
    router.quarantined = set(state["quarantined"])
    router.agent_set_version.version = int(state["agent_set_version"])
    if router.settlement is not None and state.get("settlement"):
        router.settlement.entries = [SettlementEntry(**e)
                                     for e in state["settlement"]]
    return router

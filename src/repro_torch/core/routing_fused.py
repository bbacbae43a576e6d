"""Fused routing step: Phase 1 to the settled auction as one device step.

The port's counterpart of the reference's ``repro.core.routing_fused``.  The
staged router (`core/mechanism.py`) runs a batch as a chain: the Eq.-4 LCP
on the device, the Eq.-5 features and the forests' descent in NumPy on the
host, then the auction on the device.  The fused step keeps everything
from the ledger gather to the settled auction on the router's device and
crosses to the host once per batch:

    (a) the Eq.-4 LCP: one ``lcp_gather`` launch over the batch's request
        rows and parent-candidate rows stacked, against the ledger arena's
        device copy (``PrefixLedger.mirror``, synced by dirty rows);
    (b) ``fused_phase1`` (`kernels/routing_fused.py`), one launch: the
        Eq.-4 scores with the LRU keep mask and the parent credit, the
        Eq.-5 features, the three stacked forests (device copies refreshed
        only when tree versions move), the cold-start prior blend, the
        Eq.-1 values, the pruned and masked welfare W and its wmax;
    (c) ``auction_fused`` (`kernels/auction_bid.py`), one launch: the ε
        schedule from wmax, the warm attempt under its round budget and the
        cold re-solve if it trips;
    (d) one device-to-host copy of one packed buffer (lat, cst, qual,
        values, X, the unit prices, the assignment, the rounds, the trip
        flag, ε_final and wmax), then the host packaging the staged path
        uses (`materialize_staged`, `package_dense` with float64 Clarke
        payments).

On a CUDA device (a) to (c) are the hand-written kernels; on the CPU their
plain versions, bit for bit the same, which is how the CPU tests hold the
step against the reference.

Shapes: the batch, the fleet, the parent candidates, the node pools, the
walk depth and the unit count are padded to pow-2 buckets
(`core/buckets.pow2_bucket`) exactly as the reference pads them, and the
auction runs on the padded market (its rounds and the warm budget depend
on the padded shapes, as the reference's do).  Each new padded shape key
allocates the step's device buffers once; ``cache_size`` counts the keys,
the counterpart of the reference's traced-program count.

Precision: float32, as the reference's fused program, while the staged
Phase 1 is float64 NumPy.  Assignments agree except where two
assignments' total welfare lands within the auction's ε-optimality gap;
payments and estimates agree to ~1e-6 relative whenever the assignment
matches.  A feature within float32 rounding of a tree threshold can flip a
leaf (the caveat of ``hoeffding.descend_torch``).  Matched pairs learn from
the float32 features, so after the first batch whose assignment differs a
fused router's trees drift from a staged router's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.affinity import PAD_PROMPT
from repro_torch.core.buckets import pow2_bucket
from repro_torch.core.solvers.dense_common import (THETA, _price_grid,
                                                   check_start_prices,
                                                   column_counts,
                                                   empty_result,
                                                   materialize_staged,
                                                   package_dense,
                                                   warm_round_budget)
from repro_torch.kernels import ops
from repro_torch.kernels.routing_fused import (BLEND_ROWS, N_FEATURES,
                                               Forest, Phase1Args,
                                               packed_layout)

__all__ = ["FUSED_SOLVERS", "FusedRoutingStep"]

#: solver backends whose staged solve runs inside the fused step (the
#: counterparts of the reference's ``("dense-jax", "pallas")``)
FUSED_SOLVERS = ("dense-torch", "cuda")


class _ForestMirror:
    """Device copy of one target's stacked Hoeffding forest.

    Piggybacks on `PredictorPool._stacked_forest` (the host's incremental
    restack) and re-uploads at two speeds: a structure change (a split or a
    membership change, seen as a new node count or agent-id key, or a new
    ``mb``) uploads every node array padded to the pow-2 node bucket
    (padded nodes are leaves, padded agents root at tree 0); leaf-value
    drift alone (tree versions moved, node count unchanged) uploads only
    the values.
    """

    def __init__(self, device):
        self.device = device
        self._key = None
        self._versions = None
        self.ints = None      # feature, left, right [kb] each, roots [mb]
        self.floats = None    # threshold, value [kb] each
        self.kb = 0

    def sync(self, pool, name: str, agent_ids: list, mb: int) -> Forest:
        stacked, roots = pool._stacked_forest(name, agent_ids)
        versions = tuple(getattr(pool._preds[a], name)._version
                         for a in agent_ids)
        n_nodes = len(stacked.feature)
        kb = pow2_bucket(n_nodes)
        key = (tuple(agent_ids), n_nodes, mb)
        if key != self._key:
            ints = np.zeros(3 * kb + mb, np.int32)
            ints[:kb] = -1                          # padded nodes are leaves
            ints[:n_nodes] = stacked.feature
            ints[kb:kb + n_nodes] = stacked.left
            ints[2 * kb:2 * kb + n_nodes] = stacked.right
            ints[3 * kb:3 * kb + len(roots)] = roots   # padded agents: tree 0
            floats = np.zeros(2 * kb, np.float32)
            floats[:n_nodes] = stacked.threshold
            floats[kb:kb + n_nodes] = stacked.value
            self.ints = torch.from_numpy(ints).to(self.device)
            self.floats = torch.from_numpy(floats).to(self.device)
            self.kb = kb
            self._key = key
            self._versions = versions
        elif versions != self._versions:
            val = np.zeros(kb, np.float32)
            val[:n_nodes] = stacked.value
            self.floats[kb:].copy_(torch.from_numpy(val))
            self._versions = versions
        i, f = self.ints, self.floats
        return Forest(i[:kb], i[kb:2 * kb], i[2 * kb:3 * kb], i[3 * kb:],
                      f[:kb], f[kb:], pow2_bucket(stacked.depth + 1, floor=4))


def _pack(parts, dtype):
    """Concatenate named host arrays; returns (flat array, {name: (offset,
    shape)})."""
    at, where = 0, {}
    for name, a in parts:
        where[name] = (at, a.shape)
        at += a.size
    flat = np.empty(at, dtype)
    for name, a in parts:
        off, _ = where[name]
        flat[off:off + a.size] = a.ravel()
    return flat, where


def _views(buf, where):
    return {name: buf[off:off + int(np.prod(shape))].view(shape)
            for name, (off, shape) in where.items()}


class FusedRoutingStep:
    """One device step per ``route_batch`` call (see the module docstring).

    Owned by an `IEMASRouter` constructed with ``fused=True`` (which checks
    ``n_hubs == 1`` and a `FUSED_SOLVERS` backend).  ``step`` replaces the
    staged ``_phase1`` and ``run_sharded_auction`` pair for the single
    global market; the spill round, the price-book splice and the Phase-3
    payments stay on the shared host path, so fused and staged results
    package identically.
    """

    def __init__(self, router, max_rounds: int = 200_000):
        self.router = router
        self.device = router.device
        if router.solver == "dense-torch" and self.device.type != "cpu":
            raise ValueError("dense-torch runs the plain versions on the "
                             "CPU; use solver='cuda' on a CUDA device")
        self.max_rounds = max_rounds
        self.forests = {name: _ForestMirror(self.device)
                        for name in ("lat", "cost", "quality")}
        self._buffers: dict = {}
        self._cache_seen = 0

    def cache_size(self) -> int:
        """The number of padded shape keys seen (warm, parents, budget, the
        batch, fleet, unit, candidate, node-pool and depth buckets, the
        arena width), each of which allocated the step's device buffers
        once: the retrace-bound signal of the reference's fused program."""
        return len(self._buffers)

    def _buffer(self, key, n_int: int, n_float: int, total: int):
        bufs = self._buffers.get(key)
        if bufs is None:
            dev = self.device
            bufs = (torch.empty(n_int, dtype=torch.int32, device=dev),
                    torch.empty(n_float, dtype=torch.float32, device=dev),
                    torch.empty(total, dtype=torch.float32, device=dev))
            self._buffers[key] = bufs
        return bufs

    def step(self, requests, live, telemetry, caps, start_prices=None):
        """Run the fused step for one batch.

        ``requests``/``live``/``telemetry``/``caps`` exactly as
        `IEMASRouter.route_batch` prepares them; ``start_prices`` is the
        hub-0 flat warm-start seed (or None).  Returns ``(lat, cst, qual,
        values, X, result)``: float64 host matrices shaped like the staged
        ``_phase1`` outputs and the packaged
        :class:`~repro_torch.core.solvers.base.AuctionResult`.
        """
        r = self.router
        n, m = len(requests), len(live)
        nb, mb = pow2_bucket(n), pow2_bucket(m)
        agent_ids = [a.agent_id for a in live]
        sess = [req.meta.get("session", req.dialogue_id) for req in requests]
        ledger = r.ledger
        store = ledger.store

        # ---- host-side assembly: small index and parameter arrays only
        mirror = ledger.mirror(self.device)
        mirror.sync()
        L = store.width
        lrows = np.zeros((nb, mb), np.int32)
        lrows[:n, :m] = store.rows_for(sess, agent_ids)
        pmat = np.full((nb, L), PAD_PROMPT, np.int32)
        plen = np.zeros(nb, np.int32)
        for j, req in enumerate(requests):
            t = np.asarray(req.tokens, np.int32)
            k = min(len(t), L)          # LCP is clamped by entry length <= L
            pmat[j, :k] = t[:k]
            plen[j] = len(t)
        slots = [a.cache_slots for a in live]
        keep = np.zeros((nb, mb), np.int32)
        keep[:n, :m] = ledger.keep_mask(sess, agent_ids, slots)

        parents = [req.meta.get("parent_sessions", ()) for req in requests]
        cand = [(j, s) for j, ps in enumerate(parents) for s in ps]
        has_parents = bool(cand)
        cb = pow2_bucket(len(cand)) if has_parents else 8
        crows = np.zeros((cb, mb), np.int32)
        cj = np.full(cb, nb, np.int32)          # nb: no request (padding)
        ckeep = np.zeros((cb, mb), np.int32)
        if has_parents:
            csess = [s for _, s in cand]
            crows[: len(cand), :m] = store.rows_for(csess, agent_ids)
            cj[: len(cand)] = [j for j, _ in cand]
            ck = np.ones((len(cand), m), bool)
            for i, (aid, sl) in enumerate(zip(agent_ids, slots)):
                if sl > 0:
                    recent = ledger.recent_sessions(aid, int(sl))
                    ck[:, i] = [s in recent for s in csess]
            ckeep[: len(cand), :m] = ck

        inflight = telemetry.get("agent_inflight", {})
        agent_rps = telemetry.get("agent_rps", {})
        turns = np.zeros(nb, np.float32)
        turns[:n] = [float(req.turn) for req in requests]
        dom = np.zeros((nb, mb), np.float32)
        dom_rows: dict[str, np.ndarray] = {}
        for j, req in enumerate(requests):
            row = dom_rows.get(req.domain)
            if row is None:
                row = dom_rows[req.domain] = np.array(
                    [float(req.domain in a.domains) for a in live],
                    np.float32)
            dom[j, :m] = row
        req_mask = np.zeros(nb, np.int32)
        req_mask[:n] = 1
        agent_mask = np.zeros(mb, np.int32)
        agent_mask[:m] = 1
        a_inflight = np.zeros(mb, np.float32)
        a_rps = np.zeros(mb, np.float32)
        caps_f = np.zeros(mb, np.float32)
        ext = np.zeros(mb, np.int32)
        for i, a in enumerate(live):
            a_inflight[i] = float(inflight.get(a.agent_id, 0))
            a_rps[i] = float(agent_rps.get(a.agent_id, 0.0))
            caps_f[i] = float(a.capacity)
            ext[i] = a.recurrent
        router_scalars = np.array(
            [float(telemetry.get("router_inflight", 0)),
             float(telemetry.get("router_rps", 0.0))], np.float32)

        # per-agent blend parameters (padded agents: all-zero params with
        # warm_n=1 -> cold prior-only -> value 0, masked out regardless)
        blend = np.zeros((BLEND_ROWS, mb), np.float32)
        for i, aid in enumerate(agent_ids):
            p = r.pool[aid]
            blend[:, i] = (p.prior_lpt, p.prior_lb, p.prices.miss,
                           p.prices.hit, p.prices.out, p.ewma_gen,
                           p.n_obs, p.warm_n, p.prior_q, p.reputation,
                           p.explore)
        blend[7, m:] = 1.0

        forests = tuple(self.forests[name].sync(r.pool, name, agent_ids, mb)
                        for name in ("lat", "cost", "quality"))

        vc = r.valuation
        val_cfg = np.array([vc.delta, vc.latency_scale, vc.value_scale],
                           np.float32)

        counts_np = column_counts(caps, n)
        K = int(counts_np.sum())
        cmax = int(counts_np.max()) if m else 0
        cbu = pow2_bucket(max(cmax, 1))
        counts = np.zeros(mb, np.int32)
        counts[:m] = counts_np
        warm = start_prices is not None and K > 0
        grid = np.zeros((mb, cbu), np.float32)
        if warm:
            p0 = check_start_prices(start_prices, K)
            grid[:m, :cmax] = _price_grid(p0, counts_np, cmax)
        budget = warm_round_budget(nb, mb * cbu, self.max_rounds) \
            if warm else 0

        # ---- the batch's inputs go to the device in two copies
        rows = np.concatenate([lrows, crows]) if has_parents else lrows
        prompts = np.concatenate([pmat, pmat[np.minimum(cj, nb - 1)]]) \
            if has_parents else pmat
        ibuf, iwhere = _pack([
            ("rows", rows), ("prompts", prompts), ("plen", plen),
            ("cj", cj), ("keep", keep), ("ckeep", ckeep), ("ext", ext),
            ("req_mask", req_mask), ("agent_mask", agent_mask),
            ("counts", counts)], np.int32)
        fbuf, fwhere = _pack([
            ("turns", turns), ("dom", dom), ("router", router_scalars),
            ("inflight", a_inflight), ("rps", a_rps), ("caps", caps_f),
            ("blend", blend), ("val_cfg", val_cfg), ("p0", grid)],
            np.float32)
        lay = packed_layout(nb, mb, cbu)
        key = (warm, has_parents, budget, nb, mb, cbu, cb,
               *(self.forests[name].kb for name in ("lat", "cost",
                                                    "quality")),
               *(f.depth for f in forests), L)
        idev, fdev, out = self._buffer(key, ibuf.size, fbuf.size, lay.total)
        idev.copy_(torch.from_numpy(ibuf))
        fdev.copy_(torch.from_numpy(fbuf))
        iv, fv = _views(idev, iwhere), _views(fdev, fwhere)

        # ---- (a) LCP over the request rows and the candidate rows
        lcp = ops.lcp_gather_op(iv["prompts"], mirror.tokens, iv["rows"])
        # ---- (b) Phase 1 into the packed buffer
        args = Phase1Args(
            lcp=lcp, rows=iv["rows"], alen=mirror.lens, plen=iv["plen"],
            cj=iv["cj"], keep=iv["keep"], ckeep=iv["ckeep"], ext=iv["ext"],
            req_mask=iv["req_mask"], agent_mask=iv["agent_mask"],
            counts=iv["counts"], turns=fv["turns"], dom=fv["dom"],
            router=fv["router"], inflight=fv["inflight"], rps=fv["rps"],
            caps=fv["caps"], blend=fv["blend"], val_cfg=fv["val_cfg"],
            forests=forests, nb=nb, mb=mb, cb=cb if has_parents else 0)
        ops.fused_phase1_op(args, out, lay)
        # ---- (c) the auction: warm attempt, cold fallback, one launch
        ops.auction_fused_op(out, iv["counts"], fv["p0"], lay, budget=budget,
                             max_rounds=self.max_rounds, warm=warm,
                             theta=THETA)
        # ---- (d) the batch's ONE device->host copy
        host = out[:lay.host].cpu().numpy()
        hint = host.view(np.int32)
        wmax = float(host[0])
        rounds_h, tripped, eps_f = int(hint[1]), bool(hint[2]), \
            float(host[3])

        def grid_of(at, *shape):
            size = int(np.prod(shape))
            return host[at:at + size].reshape(shape)

        lat = grid_of(lay.lat, nb, mb)[:n, :m].astype(np.float64)
        cst = grid_of(lay.cst, nb, mb)[:n, :m].astype(np.float64)
        qual = grid_of(lay.qual, nb, mb)[:n, :m].astype(np.float64)
        values = grid_of(lay.values, nb, mb)[:n, :m].astype(np.float64)
        X = grid_of(lay.X, nb, mb, N_FEATURES)[:n, :m].astype(np.float64)
        prof = getattr(r, "profiler", None)
        if prof is not None and hasattr(prof, "note_fused_step"):
            # the step's design, as the reference notes it: one copy, no
            # sync between the launches (chip_smoke.py's phase 15 and
            # tests/torch_port/test_torch_cuda.py measure both on a card)
            c = self.cache_size()
            prof.note_fused_step(host_transfers=1, mid_syncs=0,
                                 retraces=max(0, c - self._cache_seen))
            self._cache_seen = c

        # host packaging — the staged backends' helpers, float64 weights
        # recomputed on the host for the Clarke payments (auction._prune)
        w64 = values - cst
        w64 = np.where(w64 > 0.0, w64, 0.0)
        if n == 0 or K == 0 or wmax <= 0.0:
            dres = empty_result(n, counts_np)
        else:
            if rounds_h >= self.max_rounds:
                raise RuntimeError(
                    f"dense auction (fused/{r.solver}) failed to converge "
                    f"in {self.max_rounds} rounds (n={n}, m={m})")
            up = grid_of(lay.price, mb, cbu)[:m, :cmax].astype(np.float64)
            dres = materialize_staged(
                w64, counts_np, up, hint[lay.agent_of:lay.agent_of + n],
                hint[lay.unit_of:lay.unit_of + n], rounds_h, eps_f,
                warm_started=warm, fallback=warm and tripped)
        result = package_dense(r.solver, w64, cst, caps, dres)
        return lat, cst, qual, values, X, result

"""Prefix ledger + cache-affinity scores o_ij (Eq. 4).

The proxy maintains, per (agent, dialogue-session), the token sequence of the
last prompt that agent executed. Affinity of a new prompt p_j to agent i is

    o_ij = LCP(p_j, ledger[i, d(j)]) / max(1, |p_j|)          (Eq. 4)

Arch-aware semantics: attention agents can reuse ANY common prefix;
recurrent agents (rwkv/zamba backbones) can only reuse an EXACT extension of
the previous prompt (the state cannot be rewound), so their affinity is
|prev| / |p_j| if p_j extends prev, else 0.

Entries live in a persistent padded token arena (`PaddedLedgerStore`): one
(S, L) int32 host matrix whose rows are (agent, session) entries, updated in
place on ``update``/``evict``.  ``affinity_matrix`` computes the full N x M
request-agent matrix; with ``use_kernel=True`` it runs on ``device``
against a copy of the arena that stays there (`LedgerMirror`, synced by
dirty rows, as the reference's fused step mirrors it), through the row
gather LCP (`repro_torch.kernels.ops.lcp_gather_op`: the CUDA kernel for a
CUDA device, its plain version for the CPU).
"""
from __future__ import annotations

import heapq

import numpy as np

from .buckets import pow2_bucket

PAD_PROMPT = -1   # prompt padding token (never a real token)
PAD_LEDGER = -2   # ledger padding token (never matches PAD_PROMPT)


def lcp_length(a: np.ndarray, b: np.ndarray) -> int:
    """Length of the longest common prefix of two token arrays."""
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if len(neq) else n


class PaddedLedgerStore:
    """Persistent padded token arena behind `PrefixLedger`.

    One ``(S, L)`` int32 matrix holds every (agent, session) ledger entry as
    a row (padded with ``PAD_LEDGER``), plus a parallel ``lens`` vector. Rows
    are written in place on record and recycled on evict; both dimensions
    grow by pow-2 doubling (`core/buckets.pow2_bucket`) so the arena's shape
    — and therefore every padded tile built from it — changes O(log) times
    over a run, not per batch.

    Row 0 is a reserved all-pad sentinel with length 0: batch gathers map
    "no entry for this (agent, session)" to row 0, which scores affinity 0
    through the shared LCP post-processing without any masking.

    ``consume_dirty`` hands out the rows written since the last drain so a
    device mirror (`LedgerMirror`) can copy just the changed rows instead of
    re-uploading the arena; ``shape_version`` bumps on regrow (and whenever
    the arrays are replaced wholesale), signalling the mirror to re-upload.
    """

    def __init__(self, floor_rows: int = 8, floor_width: int = 8):
        self.tokens = np.full((floor_rows, floor_width), PAD_LEDGER, np.int32)
        self.lens = np.zeros((floor_rows,), np.int32)
        self.row_of: dict[tuple, int] = {}
        self._free: list[int] = []
        self._next = 1                       # row 0 = absent sentinel
        self._dirty: set[int] = set()
        self.version = 0                     # bumps on every write
        self.shape_version = 0               # bumps on regrow

    @property
    def width(self) -> int:
        """Current padded token width L of the arena."""
        return self.tokens.shape[1]

    def _regrow(self, rows: int, width: int) -> None:
        """Reallocate the arena to at least (rows, width), pow-2 bucketed."""
        s = pow2_bucket(max(rows, self.tokens.shape[0]))
        w = pow2_bucket(max(width, self.width))
        if (s, w) == self.tokens.shape:
            return
        grown = np.full((s, w), PAD_LEDGER, np.int32)
        grown[: self.tokens.shape[0], : self.width] = self.tokens
        self.tokens = grown
        self.lens = np.concatenate(
            [self.lens, np.zeros((s - len(self.lens),), np.int32)])
        self.shape_version += 1
        self.version += 1
        # every row moved to a fresh buffer: device mirrors must re-upload
        self._dirty = set(range(self._next))

    def put(self, key: tuple, toks: np.ndarray) -> int:
        """Write (or overwrite) the entry for ``key``; returns its row."""
        k = len(toks)
        row = self.row_of.get(key)
        if row is None:
            row = self._free.pop() if self._free else self._next
            if row == self._next:
                self._next += 1
            self.row_of[key] = row
        self._regrow(self._next, max(k, 1))
        self.tokens[row, :k] = toks
        self.tokens[row, k:] = PAD_LEDGER    # clear stale tail on row reuse
        self.lens[row] = k
        self._dirty.add(row)
        self.version += 1
        return row

    def drop(self, key: tuple) -> None:
        """Recycle the row for ``key`` (no-op if absent)."""
        row = self.row_of.pop(key, None)
        if row is None:
            return
        self.lens[row] = 0
        self.tokens[row, :] = PAD_LEDGER
        self._free.append(row)
        self._dirty.add(row)
        self.version += 1

    def get(self, key: tuple) -> np.ndarray | None:
        """The stored token row for ``key`` (a view), or None."""
        row = self.row_of.get(key)
        if row is None:
            return None
        return self.tokens[row, : self.lens[row]]

    def rows_for(self, sessions: list, agent_ids: list) -> np.ndarray:
        """(len(sessions), len(agent_ids)) row indices; 0 where absent."""
        out = np.zeros((len(sessions), len(agent_ids)), np.int32)
        get = self.row_of.get
        for i, a in enumerate(agent_ids):
            for j, d in enumerate(sessions):
                out[j, i] = get((a, d), 0)
        return out

    def consume_dirty(self) -> np.ndarray:
        """Rows written since the last drain (then clears the set)."""
        rows = np.fromiter(self._dirty, np.int32, len(self._dirty))
        self._dirty.clear()
        return rows


class LedgerMirror:
    """A copy of a `PaddedLedgerStore` arena (tokens and lengths) on one
    device, the counterpart of the reference fused step's ``_LedgerMirror``.

    ``sync`` drains the store's dirty rows and copies just those into the
    device tensors (``index_copy_``); a new ``shape_version`` (the arena
    regrew or was replaced) re-uploads the whole arena instead.
    ``bytes_sent`` counts what went to the device.
    """

    def __init__(self, store: PaddedLedgerStore, device):
        self.store = store
        self.device = device
        self.tokens = None
        self.lens = None
        self._shape_version = -1
        self.bytes_sent = 0

    def sync(self) -> None:
        """Bring the device arena up to date with the host store."""
        import torch

        st = self.store
        if self.tokens is None or self._shape_version != st.shape_version:
            st.consume_dirty()          # the full upload covers everything
            self.tokens = torch.from_numpy(st.tokens).to(self.device,
                                                         copy=True)
            self.lens = torch.from_numpy(st.lens).to(self.device, copy=True)
            self._shape_version = st.shape_version
            self.bytes_sent += st.tokens.nbytes + st.lens.nbytes
            return
        rows = st.consume_dirty()
        if rows.size == 0:
            return
        rows.sort()
        idx = torch.from_numpy(rows.astype(np.int64)).to(self.device)
        toks, lens = st.tokens[rows], st.lens[rows]
        self.tokens.index_copy_(0, idx, torch.from_numpy(toks).to(
            self.device))
        self.lens.index_copy_(0, idx, torch.from_numpy(lens).to(self.device))
        self.bytes_sent += rows.size * 8 + toks.nbytes + lens.nbytes


class PrefixLedger:
    """Per-(agent, dialogue) record of the last prompt each agent served.

    Entries are indexed per agent (``_by_agent``) so the hot-path queries —
    ``recent_sessions`` every batch, ``evict``/``sessions`` on membership
    events — cost O(sessions of that agent), not O(every ledger entry ever
    written): at 10k streamed dialogues the flat scan made Phase 1 grow
    quadratically over a serving run. Token payloads live in the persistent
    padded arena ``store`` (`PaddedLedgerStore`), updated incrementally on
    ``update``/``evict`` so batch paths gather rows instead of rebuilding
    padded tiles from dicts.

    ``max_sessions_per_agent`` (None = unbounded, the default) LRU-caps the
    tracked sessions per agent, bounding ledger memory on streamed runs.
    Setting it to at least the agent's published ``cache_slots`` is
    behavior-neutral on the router path: any session older than the
    ``cache_slots`` most recent is presumed backend-evicted and has its
    affinity zeroed by ``apply_lru`` anyway, so dropping its ledger entry
    changes nothing the auction sees (the router sizes the cap from the
    live agents' published cache capacities).
    """

    def __init__(self, max_sessions_per_agent: int | None = None):
        self.store = PaddedLedgerStore()
        self._mirror: LedgerMirror | None = None  # see `mirror`
        self.bytes_sent = 0     # host -> device bytes of the kernel path
        # agent_id -> {dialogue_id: last-touch clock}, kept in sync with
        # the store (the per-agent LRU index; insertion order tracks recency
        # because every touch deletes + reinserts)
        self._by_agent: dict[str, dict[str, int]] = {}
        self.max_sessions_per_agent = max_sessions_per_agent
        self._clock = 0

    def update(self, agent_id: str, dialogue_id: str, prompt_tokens) -> None:
        """Record the prompt agent ``agent_id`` just executed (Phase 4)."""
        self._clock += 1
        self.store.put((agent_id, dialogue_id),
                       np.asarray(prompt_tokens, dtype=np.int32))
        touched = self._by_agent.setdefault(agent_id, {})
        touched.pop(dialogue_id, None)   # re-insert at the recent end
        touched[dialogue_id] = self._clock
        cap = self.max_sessions_per_agent
        if cap is not None and len(touched) > cap:
            victim = next(iter(touched))  # oldest (dict preserves order)
            del touched[victim]
            self.store.drop((agent_id, victim))

    def recent_sessions(self, agent_id: str, limit: int) -> set:
        """The ``limit`` most-recently-served sessions of an agent — a local
        LRU model of the backend's cache (the hub's 'compact cache-state
        summary', §4.4). Sessions beyond it are presumed evicted."""
        touched = self._by_agent.get(agent_id)
        if touched is None:
            return set()
        if len(touched) <= limit:
            return set(touched)
        return {d for d, _ in heapq.nlargest(limit, touched.items(),
                                             key=lambda kv: kv[1])}

    def keep_mask(self, dialogue_ids: list, agent_ids: list,
                  cache_slots: list) -> np.ndarray:
        """(n, m) bool: True where agent i still has session j resident
        under the LRU cache model (always True for unbounded agents)."""
        n, m = len(dialogue_ids), len(agent_ids)
        keep = np.ones((n, m), bool)
        for i, (aid, slots) in enumerate(zip(agent_ids, cache_slots)):
            if slots > 0:
                recent = self.recent_sessions(aid, slots)
                keep[:, i] = np.fromiter((d in recent for d in dialogue_ids),
                                         dtype=bool, count=n)
        return keep

    def apply_lru(self, o: np.ndarray, dialogue_ids: list,
                  agent_ids: list, cache_slots: list) -> np.ndarray:
        """LRU cache model (§4.4 published cache summaries): zero, in place,
        the affinity of sessions each agent has presumably evicted — only
        the ``cache_slots[i]`` most-recent sessions keep their score
        (``cache_slots[i] <= 0`` means unbounded). One column masking per
        agent instead of the per-(request, agent) Python loop."""
        keep = self.keep_mask(dialogue_ids, agent_ids, cache_slots)
        o[:] = np.where(keep, o, 0.0)
        return o

    def parent_credit(self, o: np.ndarray, prompts: list,
                      parent_sessions: list, agent_ids: list,
                      extension_only_mask=None,
                      cache_slots=None) -> np.ndarray:
        """Precedence-aware affinity (workflow-DAG handoffs): raise, in
        place, ``o[j, i]`` to the best affinity over request j's *parent
        step* sessions still resident on agent i.

        A DAG step's prompt begins with its parents' contexts, so an agent
        that served a parent step holds a usable KV prefix even though the
        child runs under a fresh session key — without this credit the
        auction sees a cold cache at every handoff and co-placement never
        pays.  ``parent_sessions[j]`` lists request j's parent session ids
        (empty for linear dialogues — their rows are untouched).  Parent
        entries are LRU-masked exactly like own-session affinity: with
        ``cache_slots[i] > 0`` only agent i's ``cache_slots[i]``
        most-recent sessions can contribute (§4.4 published cache
        summaries).

        Vectorized: all (row, parent) candidate pairs are flattened, their
        ledger rows gathered from the padded arena, the LCP matrix computed
        in one batched pass, and the per-row maximum folded into ``o`` with
        a masked segment-max (``np.maximum.at``).
        """
        cand = [(j, s) for j, ps in enumerate(parent_sessions) for s in ps]
        if not cand:
            return o
        cj = np.array([j for j, _ in cand], np.int64)
        sess = [s for _, s in cand]
        crows = self.store.rows_for(sess, agent_ids)          # (C, m)
        clen = self.store.lens[crows]
        plens = np.array([len(prompts[j]) for j in cj], np.int64)
        width = max(int(plens.max()), self.store.width)
        pmat = np.full((len(cand), width), PAD_PROMPT, np.int32)
        for r, j in enumerate(cj):
            pmat[r, : plens[r]] = prompts[j]
        ctoks = np.full((len(cand), len(agent_ids), width), PAD_LEDGER,
                        np.int32)
        ctoks[:, :, : self.store.width] = self.store.tokens[crows]
        raw = np.logical_and.accumulate(
            pmat[:, None, :] == ctoks, axis=-1).sum(-1)
        lcp = np.minimum(raw, np.minimum(plens[:, None], clen))
        cred = lcp / np.maximum(plens[:, None], 1)
        if extension_only_mask is not None:
            ext = np.asarray(extension_only_mask, bool)[None, :]
            full_prev = (lcp == clen) & (clen > 0)
            cred = np.where(
                ext, np.where(full_prev,
                              clen / np.maximum(plens[:, None], 1), 0.0),
                cred)
        if cache_slots is not None:
            slots = np.asarray(cache_slots)
            for i, aid in enumerate(agent_ids):
                if slots[i] > 0:
                    recent = self.recent_sessions(aid, int(slots[i]))
                    live = np.fromiter((s in recent for s in sess),
                                       dtype=bool, count=len(sess))
                    cred[:, i] = np.where(live, cred[:, i], 0.0)
        np.maximum.at(o, cj, cred)
        return o

    def get(self, agent_id: str, dialogue_id: str):
        """The last recorded prompt for this (agent, dialogue), or None."""
        return self.store.get((agent_id, dialogue_id))

    def evict(self, agent_id: str, dialogue_id: str | None = None) -> None:
        """Drop ledger entries (agent cache eviction resync, Appx C.2.2)."""
        if dialogue_id is not None:
            self.store.drop((agent_id, dialogue_id))
            touched = self._by_agent.get(agent_id)
            if touched is not None:
                touched.pop(dialogue_id, None)
        else:
            for d in list(self._by_agent.get(agent_id, ())):
                self.store.drop((agent_id, d))
            self._by_agent.pop(agent_id, None)

    def sessions(self, agent_id: str) -> list[str]:
        """Dialogue ids with a live ledger entry for this agent."""
        return list(self._by_agent.get(agent_id, ()))

    def affinity(self, agent_id: str, dialogue_id: str, prompt_tokens,
                 *, extension_only: bool = False) -> float:
        """o_ij of one (agent, request) pair (Eq. 4; arch-aware)."""
        prev = self.get(agent_id, dialogue_id)
        p = np.asarray(prompt_tokens, dtype=np.int32)
        if prev is None or len(p) == 0:
            return 0.0
        if extension_only:
            if len(prev) <= len(p) and lcp_length(prev, p) == len(prev):
                return len(prev) / max(1, len(p))
            return 0.0
        return lcp_length(p, prev) / max(1, len(p))

    def affinity_matrix(self, prompts: list, dialogue_ids: list,
                        agent_ids: list, extension_only_mask=None,
                        use_kernel: bool = False,
                        device="cuda") -> np.ndarray:
        """o[j, i] for every (request j, agent i).  ``use_kernel=True`` runs
        the batched LCP on ``device``; the default is the per-pair host
        loop (the semantic oracle)."""
        n, m = len(prompts), len(agent_ids)
        if use_kernel:
            return self._affinity_matrix_kernel(prompts, dialogue_ids,
                                                agent_ids, extension_only_mask,
                                                device)
        out = np.zeros((n, m))
        for j, (p, d) in enumerate(zip(prompts, dialogue_ids)):
            for i, a in enumerate(agent_ids):
                ext = bool(extension_only_mask[i]) if extension_only_mask is not None else False
                out[j, i] = self.affinity(a, d, p, extension_only=ext)
        return out

    def mirror(self, device) -> LedgerMirror:
        """The arena's copy on ``device``.  The ledger keeps one: mirrors
        drain the store's one set of dirty rows, so a second would miss the
        rows the first drained.  Asked for another device, it makes a new
        mirror, whose first sync uploads the whole arena."""
        import torch

        device = torch.device(device)
        if self._mirror is None or self._mirror.device != device:
            self._mirror = LedgerMirror(self.store, device)
        return self._mirror

    def _affinity_matrix_kernel(self, prompts, dialogue_ids, agent_ids,
                                extension_only_mask, device):
        """Batched LCP on ``device`` through the row-gather op: the arena's
        device copy is synced by dirty rows, and per batch only the padded
        prompts, their lengths and the (n, m) row indices cross to the
        device.  The post-processing (min with the lengths, the float64
        division, the extension-only branch) runs on the device and one
        (n, m) float64 matrix comes back."""
        import torch

        from repro_torch.kernels.ops import lcp_gather_op

        n = len(prompts)
        mirror = self.mirror(device)
        sent = mirror.bytes_sent
        mirror.sync()
        rows = self.store.rows_for(dialogue_ids, agent_ids)   # (n, m)
        width = max(max((len(p) for p in prompts), default=1), 8)
        pmat = np.full((n, width), PAD_PROMPT, np.int32)
        plen = np.zeros((n,), np.int32)
        for j, p in enumerate(prompts):
            pmat[j, : len(p)] = p
            plen[j] = len(p)
        ext = None if extension_only_mask is None \
            else np.asarray(extension_only_mask, bool)
        self.bytes_sent += (mirror.bytes_sent - sent + pmat.nbytes
                            + plen.nbytes + rows.nbytes
                            + (0 if ext is None else ext.nbytes))
        rows_t = torch.from_numpy(rows).to(device)
        plen_t = torch.from_numpy(plen).to(device)[:, None]
        llen_t = mirror.lens[rows_t.long()]
        lcp = lcp_gather_op(torch.from_numpy(pmat).to(device), mirror.tokens,
                            rows_t)                               # [N, M]
        lcp = torch.minimum(lcp, torch.minimum(plen_t, llen_t))
        denom = plen_t.clamp(min=1).to(torch.float64)
        o = lcp.to(torch.float64) / denom
        if ext is not None:
            full_prev = (lcp == llen_t) & (llen_t > 0)
            o = torch.where(torch.from_numpy(ext).to(device)[None, :],
                            torch.where(full_prev,
                                        llen_t.to(torch.float64) / denom,
                                        0.0), o)
        return o.cpu().numpy()

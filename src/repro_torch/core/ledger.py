"""Append-only hash-chained settlement ledger (the market's audit layer).

Reference design: the blockchain-driven incentive-compatibility line in
PAPERS.md — verifiable settlement without the chain consensus.  Every
request the router settles (Phase 4) appends exactly one entry carrying
the economically meaningful quantities of that settlement: the Clarke
payment, the cost booked at the agent's *published* prices, the reported
vs audited QoS, the client value the welfare account realized, and the
reputation transition the report caused.  Entries are chained by SHA-256
over a canonical serialization (floats rendered with ``float.hex`` so the
chain commits to exact bit patterns, not printf roundings), which makes
two audits mechanical:

* ``verify_chain()`` — recompute every hash and its linkage; any mutation,
  insertion, deletion or reordering of a past entry breaks the chain.
* ``replay_balances()`` / ``audit(accounts)`` — recompute the router's
  account balances from the ledger alone, in append order.  Because the
  ledger is appended inside ``IEMASRouter.on_complete`` with the exact
  floats the accounts accumulated, and float addition is replayed in the
  same order, the replay is *exactly* equal to ``accounts`` — the audit
  tolerance exists only as a guard rail, not as slack for drift.

The ledger records faults too (``kind="fault"``: no payment, agent
quarantined) so the audit trail covers every completion the router saw,
not just the paid ones.
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass

#: hash of the empty chain (the genesis predecessor)
GENESIS = "0" * 64

#: account keys the replay audit must reproduce exactly
AUDITED_KEYS = ("payments", "agent_costs", "surplus", "welfare_realized")


@dataclass(frozen=True)
class SettlementEntry:
    """One immutable settlement record (hash-chained to its predecessor).

    ``kind`` is ``"settle"`` for a paid completion or ``"fault"`` for a
    failed one (no payment, agent quarantined).  ``cost`` is the cost
    booked at the agent's published prices — under a misreporting agent it
    deliberately differs from the cluster's ground-truth cost, which is
    the whole point of auditing.  ``audited_quality`` equals
    ``reported_quality`` whenever no audit channel was attached.
    """

    seq: int
    kind: str
    request_id: str
    agent_id: str
    payment: float
    cost: float
    reported_quality: float
    audited_quality: float
    true_value: float
    reputation_before: float
    reputation_after: float
    prev_hash: str
    entry_hash: str = ""

    def payload(self) -> str:
        """Canonical serialization covered by ``entry_hash``.

        Floats are rendered with ``float.hex`` so the hash commits to the
        exact IEEE-754 values the accounts accumulated — a replay that
        verifies is bit-faithful, not approximately faithful.
        """
        return "|".join((
            str(self.seq), self.kind, self.request_id, self.agent_id,
            float(self.payment).hex(), float(self.cost).hex(),
            float(self.reported_quality).hex(),
            float(self.audited_quality).hex(),
            float(self.true_value).hex(),
            float(self.reputation_before).hex(),
            float(self.reputation_after).hex(),
            self.prev_hash,
        ))


def _hash(payload: str) -> str:
    """SHA-256 hex digest of one canonical entry payload."""
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()


class SettlementLedger:
    """Append-only hash-chained log of every settlement the router made.

    Attach one to ``IEMASRouter(audit_ledger=True)`` and it receives one
    entry per completed request (paid or faulted).  See the module
    docstring for the two audits it supports.
    """

    def __init__(self):
        self.entries: list[SettlementEntry] = []

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def head(self) -> str:
        """Hash of the newest entry (``GENESIS`` when the chain is empty)."""
        return self.entries[-1].entry_hash if self.entries else GENESIS

    def append(self, *, kind: str, request_id: str, agent_id: str,
               payment: float = 0.0, cost: float = 0.0,
               reported_quality: float = 0.0, audited_quality: float = 0.0,
               true_value: float = 0.0, reputation_before: float = 1.0,
               reputation_after: float = 1.0) -> SettlementEntry:
        """Chain one settlement record and return the sealed entry."""
        entry = SettlementEntry(
            seq=len(self.entries), kind=kind, request_id=request_id,
            agent_id=agent_id, payment=float(payment), cost=float(cost),
            reported_quality=float(reported_quality),
            audited_quality=float(audited_quality),
            true_value=float(true_value),
            reputation_before=float(reputation_before),
            reputation_after=float(reputation_after), prev_hash=self.head)
        entry = dataclasses.replace(entry, entry_hash=_hash(entry.payload()))
        self.entries.append(entry)
        return entry

    def verify_chain(self) -> bool:
        """True iff every hash and linkage recomputes — i.e. no entry was
        mutated, inserted, deleted or reordered since it was appended."""
        prev = GENESIS
        for k, e in enumerate(self.entries):
            if e.seq != k or e.prev_hash != prev:
                return False
            if _hash(e.payload()) != e.entry_hash:
                return False
            prev = e.entry_hash
        return True

    def replay_balances(self) -> dict:
        """Recompute the router's account balances from entries alone.

        Summation runs in append order — the same order (and the same
        floats) ``on_complete`` accumulated into ``accounts`` — so the
        replayed balances are exactly equal, not merely close.
        """
        bal = {k: 0.0 for k in AUDITED_KEYS}
        bal["settled"] = 0
        bal["faults"] = 0
        for e in self.entries:
            if e.kind != "settle":
                bal["faults"] += 1
                continue
            bal["payments"] += e.payment
            bal["agent_costs"] += e.cost
            bal["surplus"] += e.payment - e.cost
            bal["welfare_realized"] += e.true_value - e.cost
            bal["settled"] += 1
        return bal

    def revenue_by_agent(self) -> dict[str, float]:
        """Settled payment totals per agent (revenue attribution)."""
        out: dict[str, float] = {}
        for e in self.entries:
            if e.kind == "settle":
                out[e.agent_id] = out.get(e.agent_id, 0.0) + e.payment
        return out

    def audit(self, accounts: dict, *, atol: float = 1e-9) -> dict:
        """Full replay audit against the router's live ``accounts``.

        Verifies the hash chain, replays the balances, and raises
        ``ValueError`` on any divergence (``atol`` is a guard rail — the
        replay is exact by construction).  Returns the replayed balances.
        """
        if not self.verify_chain():
            raise ValueError("settlement ledger hash chain failed to verify")
        bal = self.replay_balances()
        for key in AUDITED_KEYS:
            if abs(bal[key] - accounts[key]) > atol:
                raise ValueError(
                    f"ledger replay diverges from accounts on {key!r}: "
                    f"replayed {bal[key]!r} vs booked {accounts[key]!r}")
        return bal

"""Serving-side elasticity: the agent-set version stamp.

Agents joining or leaving the market go through
``repro_torch.core.mechanism.IEMASRouter.add_agent``/``remove_agent``, which
stamp every membership change with an :class:`AgentSetVersion` — the version
gates cross-round warm-start state (hub slot prices) so nothing learned
about one agent set is replayed against another.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class AgentSetVersion:
    """Monotonic stamp for the serving market's agent membership.

    The router bumps it on every agent join/leave/hub-rebuild; consumers of
    per-agent-set caches (e.g. `repro_torch.core.hub.SlotPriceBook`) key
    their entries by the version at store time and treat any mismatch as a
    cold start.  ``fingerprint`` additionally binds an exact agent-id tuple,
    for caches that must also invalidate on *subset* changes (quarantine
    flips the live set without changing membership, so a version alone is
    not enough).
    """

    version: int = 0

    def bump(self) -> int:
        """Advance to (and return) the next version."""
        self.version += 1
        return self.version

    def fingerprint(self, agent_ids) -> tuple[int, tuple[str, ...]]:
        """(version, exact id tuple) — the full warm-start cache key."""
        return self.version, tuple(agent_ids)

"""Router/agent telemetry (Eq. 5 load features): inflight, RPS EWMAs, TTFT.

Also accumulates per-agent busy seconds (virtual engine time, reported by
the cluster on dispatch) so the event simulator can compute fleet
utilization and the profiler's engine-compute denominator from the same
source the router's load features come from.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class TelemetryTracker:
    """Decaying per-agent load state the proxy layer exposes to the router."""

    rps_halflife: float = 5.0  # seconds of virtual time
    router_inflight: int = 0
    agent_inflight: dict = field(default_factory=lambda: defaultdict(int))
    agent_busy: dict = field(default_factory=lambda: defaultdict(float))
    _router_rps: float = 0.0
    _agent_rps: dict = field(default_factory=lambda: defaultdict(float))
    _last_t: float = 0.0

    def _decay(self, now: float):
        dt = max(0.0, now - self._last_t)
        if dt > 0:
            f = 0.5 ** (dt / self.rps_halflife)
            self._router_rps *= f
            for k in self._agent_rps:
                self._agent_rps[k] *= f
            self._last_t = now

    def on_dispatch(self, agent_id: str, now: float):
        """Record one request entering an agent's queue at virtual ``now``."""
        self._decay(now)
        self.router_inflight += 1
        self.agent_inflight[agent_id] += 1
        self._router_rps += 1.0 / self.rps_halflife
        self._agent_rps[agent_id] += 1.0 / self.rps_halflife

    def on_busy(self, agent_id: str, seconds: float):
        """Accumulate one dispatch's virtual engine-busy seconds."""
        self.agent_busy[agent_id] += float(seconds)

    def on_complete(self, agent_id: str, now: float):
        """Record one request leaving an agent at virtual ``now``."""
        self._decay(now)
        self.router_inflight = max(0, self.router_inflight - 1)
        self.agent_inflight[agent_id] = max(0, self.agent_inflight[agent_id] - 1)

    def busy_seconds(self) -> float:
        """Total virtual engine-busy seconds across the fleet."""
        return float(sum(self.agent_busy.values()))

    def snapshot(self, now: float) -> dict:
        """The per-round telemetry dict Phase 1 consumes (Eq. 5 features)."""
        self._decay(now)
        return {
            "router_inflight": self.router_inflight,
            "router_rps": self._router_rps,
            "agent_inflight": dict(self.agent_inflight),
            "agent_rps": dict(self._agent_rps),
        }

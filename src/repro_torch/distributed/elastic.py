"""Elastic scaling: re-mesh and re-place the train state when the device
pool changes, and the serving side's agent-set version stamp.

Checkpoints store full (unsharded) arrays, so elasticity is: rebuild the
mesh at the new size (`remesh`), re-derive placements from the same
logical-axis rules (divisibility fallback handles non-power-of-two
survivors), and place the restored state (`reshard_state`: DTensors of
each rank's block, cut from the full copy every rank holds).  torch is imported lazily: the membership side of
this module is consumed by the routing core.

Agents joining or leaving the market go through
``repro_torch.core.mechanism.IEMASRouter.add_agent``/``remove_agent``, which
stamp every membership change with an :class:`AgentSetVersion` — the version
gates cross-round warm-start state (hub slot prices) so nothing learned
about one agent set is replayed against another.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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


def mesh_factors(n: int, data_model_ratio: float = 1.0) -> tuple[int, int]:
    """The (data, model) factorization of ``n`` whose data/model ratio is
    nearest ``data_model_ratio`` in log scale, the first found on a tie
    (the reference's ``np.log``, so its rounding picks as the reference
    does)."""
    best, best_score = (1, n), -1.0
    for d in range(1, n + 1):
        if n % d:
            continue
        m = n // d
        score = -abs(np.log((d / m) / data_model_ratio))
        if score > best_score:
            best, best_score = (d, m), score
    return best


def remesh(n_devices: int, *, data_model_ratio: float = 1.0,
           device_type: str | None = None):
    """Largest (data, model) mesh of n_devices cards, preferring
    square-ish factorizations scaled by ``data_model_ratio`` (=
    data/model); a DeviceMesh over the process group's ranks."""
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(mesh_factors(n_devices, data_model_ratio),
                     ("data", "model"), device_type)


def reshard_state(state, param_axes, mesh, rules_acts: dict,
                  rules_params: dict):
    """``state`` (a `ParamTree`, or a tree of its structure such as
    AdamW's moments) placed on ``mesh`` by the logical rules: a tree of
    the same kind whose leaves are DTensors, each rank's block cut from
    the full copy every rank holds (no collective: a checkpoint or a
    seeded init gives every rank the same copy)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import (ShardingPolicy,
                                                  local_block,
                                                  param_shardings,
                                                  placements)
    from repro_torch.utils.tree import tree_map

    policy = ShardingPolicy(mesh, acts=rules_acts, params=rules_params)
    specs = iter(param_shardings(policy, state, param_axes).values())

    def place(x):
        spec = next(specs)
        return DTensor.from_local(
            local_block(x.detach(), mesh, spec).clone(), mesh,
            placements(mesh, spec), shape=x.shape, stride=x.stride())

    return tree_map(place, state)

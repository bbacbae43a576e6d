"""The paper's own experimental setup (§5.1) as a cluster config.

The paper profiles vLLM on RTX 4090 / RTX 6000 nodes serving LLaMA-3-7B,
Qwen-4B and Qwen-8B, with a concurrent batch buffer of 12 and constrained
GPU memory (frequent cache evictions). Here the same *population structure*
is expressed as agent profiles; the port's `SimCluster` serves them on real
engines (reduced models of the three classes, on the card) or on the
analytic engine (`repro_torch.serving.analytic`).

``agent_profiles(n_agents)`` tiles the three model classes across agents with
heterogeneous domains, capacities and token pricing; ``make_router`` builds
the port's router for them from a :class:`RouterConfig`.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AgentProfile:
    agent_id: str
    model_class: str      # which reduced model config the engine runs
    scale: float          # S_i, relative model scale (paper: parameter size)
    domains: tuple[str, ...]  # K_i, specialization tags
    capacity: int         # B_i, max concurrent tasks (paper buffer: 12)
    price_miss: float     # pi_miss per uncached prompt token
    price_hit: float      # pi_hit per cached prompt token
    price_out: float      # pi_out per generated token
    cache_slots: int = 12  # cached sessions ~ the paper's concurrent buffer (12)
    speed: float = 1.0    # relative hardware speed (4090 vs 6000 heterogeneity)


@dataclass(frozen=True)
class RouterConfig:
    """Mechanism-side knobs plumbed from configs into IEMASRouter.

    ``solver`` names a backend in the ``repro_torch.core.solvers`` registry:
    ``"cuda"`` is the staged float32 column auction, one CUDA launch per
    solve and hub blocks batched (the plain staged market for a CPU
    router), ``"dense-torch"`` the same single-market solver on the CPU,
    ``"dense"`` the float64 NumPy auction and ``"mcmf"`` the exact
    pure-Python oracle (both on the host).  ``use_kernel_affinity`` runs the Eq.-4 LCP as one batched op on the
    router's device against a device copy of the ledger arena (the CUDA
    kernel on a card) instead of the per-pair host loop.

    ``n_hubs`` shards Phase 2 across proxy hubs (§4.4); ``warm_start=True``
    reuses each hub's final slot prices as the next round's ε-scaling seed
    (the router cold-starts any hub whose live agent set changed);
    ``spill=True`` re-auctions requests a saturated hub left unmatched over
    every hub's residual capacity.

    ``batched`` picks the Phase-1 QoS path: True (default) scores the full
    (n, m, F) feature tensor through the stacked Hoeffding forests in one
    pass; False keeps the per-pair scalar loop (the semantic oracle).
    ``predictor_backend`` is ``"numpy"`` (bit-exact vs the scalar path) or
    ``"torch"`` (the forests walked in float32 on the router's device; the
    reference's ``"jax"``).

    ``reputation`` enables the reputation-weighted priors (exactly neutral
    without an audit channel); ``audit_ledger`` attaches the append-only
    hash-chained settlement ledger (`repro_torch.core.ledger`).
    ``fused=True`` runs the per-batch routing step (ledger gather, Eq.-4
    affinity, Eq.-5 prediction, Eq.-1 values and the column auction) as one
    device step with one device-to-host copy
    (`repro_torch.core.routing_fused`); it requires ``n_hubs == 1`` and
    solver ``cuda`` or ``dense-torch``.  ``explore_bonus`` is the predictor optimism
    knob: predicted quality is lifted by ``explore_bonus / sqrt(1 + n_obs)``
    (0.0 is an exact no-op)."""
    solver: str = "cuda"
    payment_mode: str = "warmstart"
    n_hubs: int = 1
    hub_scheme: str = "domain"
    warm_start: bool = False
    spill: bool = True
    use_kernel_affinity: bool = True
    batched: bool = True
    predictor_backend: str = "numpy"
    reputation: bool = True
    audit_ledger: bool = False
    fused: bool = False
    explore_bonus: float = 0.0

    def router_kwargs(self) -> dict:
        """Keyword arguments of ``IEMASRouter`` for this config."""
        import dataclasses

        kw = dataclasses.asdict(self)
        # IEMASRouter takes the predictor knob via predictor_kw
        explore = kw.pop("explore_bonus")
        if explore:
            kw["predictor_kw"] = {"explore": explore}
        return kw


DEFAULT_ROUTER = RouterConfig()


@dataclass(frozen=True)
class ClusterScaleConfig:
    """Preset for open-loop scale runs (`repro_torch.serving.simulator`).

    Bundles the population size with the serving-loop knobs a scale run
    needs: analytic engines, an open-loop Poisson arrival rate scaled per
    agent (so every fleet size runs a comparable virtual-time window), the
    streaming-admission window, the micro-batch cap and window, and the
    reference's hub cut: Phase 2 sharded into ``n_agents // agents_per_hub``
    warm-started hubs.  ``super_hubs`` and ``epoch`` are the hubs-of-hubs
    federation's (`repro_torch.serving.federation`): the number of
    independently-advancing super-hub shards and the virtual seconds
    between their gossip and spill boundaries (``super_hubs=1`` is the
    single-heap `EventSimulator`)."""

    n_agents: int = 128
    n_dialogues: int = 10_000
    engine_mode: str = "analytic"
    rate_per_agent: float = 0.75   # Poisson dialogues/s per agent
    max_inflight: int = 256        # streaming admission window
    batch_cap: int = 64            # micro-batch size per router invocation
    batch_window: float = 0.05     # batching delay, seconds
    max_new_tokens: int = 6
    agents_per_hub: int = 16       # n_hubs = max(1, n_agents // this)
    solver: str = "cuda"
    warm_start: bool = True
    # hubs-of-hubs federation (repro_torch.serving.federation): number of
    # independently-advancing super-hub shards and the virtual seconds
    # between price-book-gossip / cross-super-hub-spill boundaries.
    # super_hubs=1 is the single-heap EventSimulator (bit-exact oracle).
    super_hubs: int = 1
    epoch: float = 0.25

    def arrival_rate(self, n_agents: int | None = None) -> float:
        """Open-loop arrival rate (dialogues/s) for a given fleet size."""
        return self.rate_per_agent * (n_agents or self.n_agents)

    def n_hubs(self, n_agents: int | None = None) -> int:
        """Hub count for a given fleet size (inner hubs per shard when
        federated: each super-hub recuts its slice by ``agents_per_hub``)."""
        return max(1, (n_agents or self.n_agents) // self.agents_per_hub)

    def router_config(self, n_agents: int | None = None) -> RouterConfig:
        """The matching mechanism-side RouterConfig."""
        return RouterConfig(solver=self.solver, n_hubs=self.n_hubs(n_agents),
                            warm_start=self.warm_start)


#: the 128-agent / 10k-dialogue headline scale preset
SCALE_128 = ClusterScaleConfig()

#: the federation scale preset: a 1024-agent fleet serving 100k dialogues
#: across 8 super-hub shards — the regime one event heap cannot sustain
SCALE_1K = ClusterScaleConfig(n_agents=1024, n_dialogues=100_000,
                              max_inflight=2048, super_hubs=8, epoch=0.5)

MODEL_CLASSES = {
    # name: (n_layers, d_model, n_heads, d_ff, relative scale); the analytic
    # engine derives its per-token FLOPs from these widths
    "llama3-7b": (6, 256, 4, 768, 7.0),
    "qwen-8b": (6, 288, 4, 864, 8.0),
    "qwen-4b": (4, 192, 4, 576, 4.0),
}

DOMAINS = ("dialogue", "longctx", "reasoning", "code", "math")


def agent_profiles(n_agents: int = 9, seed: int = 0) -> list[AgentProfile]:
    """``n_agents`` profiles tiling the model classes, with seeded domains
    and hardware speeds."""
    import random

    rng = random.Random(seed)
    classes = list(MODEL_CLASSES.items())
    profiles = []
    for i in range(n_agents):
        cname, (_, _, _, _, scale) = classes[i % len(classes)]
        doms = tuple(rng.sample(DOMAINS, k=2))
        # larger models cost more per token; cached tokens ~10x cheaper
        base = 0.002 * scale
        profiles.append(
            AgentProfile(
                agent_id=f"agent-{i}",
                model_class=cname,
                scale=scale,
                domains=doms,
                capacity=12,
                price_miss=base,
                price_hit=base * 0.1,
                price_out=base * 3.0,
                cache_slots=12,
                speed=rng.choice([0.8, 1.0, 1.25]),
            )
        )
    return profiles


def agent_infos(profiles: list[AgentProfile]) -> list:
    """The published ``AgentInfo`` of each profile (attention engines: no
    extension-only cache semantics)."""
    from repro_torch.core.mechanism import AgentInfo
    from repro_torch.core.pricing import TokenPrices

    return [AgentInfo(agent_id=p.agent_id,
                      prices=TokenPrices(p.price_miss, p.price_hit,
                                         p.price_out),
                      capacity=p.capacity, domains=p.domains, scale=p.scale,
                      recurrent=False, cache_slots=p.cache_slots)
            for p in profiles]


def make_router(infos: list, cfg: RouterConfig | None = None,
                device="cuda", **overrides):
    """The port's IEMAS router for ``infos`` from a RouterConfig, on
    ``device`` (raises for ``"cuda"`` without a card).  ``overrides`` land
    on top of the config."""
    from repro_torch.core.mechanism import IEMASRouter

    kwargs = (cfg or DEFAULT_ROUTER).router_kwargs()
    kwargs.update(overrides)
    return IEMASRouter(infos, device=device, **kwargs)

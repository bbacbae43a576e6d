"""The paper's own experimental setup (§5.1) as a cluster config.

The paper profiles vLLM on RTX 4090 / RTX 6000 nodes serving LLaMA-3-7B,
Qwen-4B and Qwen-8B, with a concurrent batch buffer of 12 and constrained
GPU memory (frequent cache evictions). Here the same *population structure*
is expressed as agent profiles; the port serves them on the analytic engine
(`repro_torch.serving.analytic`).

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
    ``"cuda"`` is the staged float32 column auction with the CUDA bidding
    kernel (the plain round for a CPU router), ``"dense-torch"`` the same
    solver with the plain round on the CPU.  ``use_kernel_affinity`` runs
    the Eq.-4 LCP as one batched op on the router's device (the CUDA kernel
    on a card) instead of the per-pair host loop.

    ``n_hubs`` shards Phase 2 across proxy hubs (§4.4); ``warm_start=True``
    reuses each hub's final slot prices as the next round's ε-scaling seed
    (the router cold-starts any hub whose live agent set changed);
    ``spill=True`` re-auctions requests a saturated hub left unmatched over
    every hub's residual capacity.

    ``reputation`` enables the reputation-weighted priors (exactly neutral
    without an audit channel); ``audit_ledger`` attaches the append-only
    hash-chained settlement ledger (`repro_torch.core.ledger`).  ``fused``
    is the one device-resident routing step, which the port does not have
    yet (the router raises).  ``explore_bonus`` is the predictor optimism
    knob: predicted quality is lifted by ``explore_bonus / sqrt(1 + n_obs)``
    (0.0 is an exact no-op)."""
    solver: str = "cuda"
    payment_mode: str = "warmstart"
    n_hubs: int = 1
    hub_scheme: str = "domain"
    warm_start: bool = False
    spill: bool = True
    use_kernel_affinity: bool = True
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
    """Preset for scale runs: the fleet size plus the serving-loop knobs a
    run at that size uses (micro-batch cap, generated tokens per turn,
    solver and warm starts).  The reference's preset also shards Phase 2
    into ``n_agents // 16`` hubs; the port's hub-batched solve is later
    work, so its scale runs use one hub."""

    n_agents: int = 128
    batch_cap: int = 64            # micro-batch size per router invocation
    max_new_tokens: int = 6
    solver: str = "cuda"
    warm_start: bool = True


#: the 128-agent headline scale preset
SCALE_128 = ClusterScaleConfig()

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

"""Model configuration schema of the port.

``ModelConfig`` is the reference's frozen dataclass (`repro.configs.base`)
field for field, with the derived ``hd``, ``subquadratic`` and
``has_decode``, the ``scaled()`` reduction the CPU tests use, the analytic
``param_counts`` and ``model_flops``, and the reference's shape cells
(``ShapeConfig``, ``SHAPES``, ``cell_supported``: the dry run's skips).  The port builds
every family of the reference from it (`repro_torch.models`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention
    attn_kind: str = "gqa"  # gqa | mla | none
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int = 0  # 0 = full attention
    rope_theta: float = 10000.0

    # MLA (deepseek-v2)
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # expert hidden size when different from d_ff
    first_dense_layers: int = 0
    dense_d_ff: int = 0  # FFN size of the leading dense layers (0 -> d_ff)
    capacity_factor: float = 1.25  # MoE dispatch capacity factor

    # SSM / hybrid
    ssm_kind: str = ""  # rwkv6 | mamba2
    ssm_state: int = 0
    ssm_heads: int = 0
    attn_every: int = 0  # zamba2: shared attention applied after every k ssm layers

    # encoder-decoder (seamless-m4t)
    enc_layers: int = 0
    src_len: int = 0  # encoder source length convention (audio frames)

    # vlm
    n_patches: int = 0  # anyres patch embeddings prepended to the prompt

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    source: str = ""  # provenance tag from the assignment table

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def subquadratic(self) -> bool:
        """Can this arch hold a 500k-token context?  A recurrent state or a
        sliding attention window keeps its decode state bounded."""
        return self.ssm_kind != "" or (self.sliding_window > 0
                                       and self.attn_kind != "none")

    @property
    def has_decode(self) -> bool:
        return True  # all ten archs decode (the encoder-decoder included)

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced config of the same family for CPU smoke tests."""
        base = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            name=self.name + "-smoke",
        )
        if self.is_moe:
            base.update(n_experts=4, top_k=2, moe_d_ff=64,
                        n_shared_experts=min(self.n_shared_experts, 1),
                        first_dense_layers=min(self.first_dense_layers, 1))
        if self.attn_kind == "mla":
            base.update(kv_lora_rank=32, qk_rope_dim=8, qk_nope_dim=16, v_head_dim=16)
        if self.ssm_kind:
            base.update(ssm_state=16, ssm_heads=4)
        if self.attn_every:
            base.update(n_layers=4, attn_every=2)
        if self.is_encdec:
            base.update(enc_layers=2, src_len=32)
        if self.n_patches:
            base.update(n_patches=8)
        if self.sliding_window:
            base.update(sliding_window=32)
        base.update(overrides)
        return dataclasses.replace(self, **base)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell; reason when skipped."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: 500k-token decode context exceeds "
                       "per-chip HBM for the KV cache and is architecturally "
                       "out of scope (see DESIGN.md §4)")
    return True, ""


# ---------------- parameter / FLOP accounting (analytic) ----------------

def param_counts(cfg: ModelConfig) -> dict:
    """Analytic parameter counts: total and active-per-token (MoE-aware)."""
    d, hd = cfg.d_model, cfg.hd
    qkv_out = cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd
    if cfg.attn_kind == "mla":
        q_dim = cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
        attn = (d * q_dim                                  # W_q
                + d * (cfg.kv_lora_rank + cfg.qk_rope_dim)  # W_dkv (+ rope key)
                + cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
                + cfg.n_heads * cfg.v_head_dim * d)         # W_o
    elif cfg.attn_kind == "none":
        attn = 0
    else:
        attn = d * qkv_out + cfg.n_heads * hd * d
        if cfg.qkv_bias:
            attn += qkv_out

    ffn_dense = 3 * d * cfg.d_ff
    if cfg.is_moe:
        e_ff = cfg.moe_d_ff or cfg.d_ff
        ffn_moe_total = cfg.n_experts * 3 * d * e_ff + cfg.n_shared_experts * 3 * d * e_ff
        ffn_moe_active = cfg.top_k * 3 * d * e_ff + cfg.n_shared_experts * 3 * d * e_ff
        router = d * cfg.n_experts
    else:
        ffn_moe_total = ffn_moe_active = router = 0

    if cfg.ssm_kind == "rwkv6":
        # r,k,v,g,w projections + output + time-mix loras (approx, matches models/ssm.py)
        tmix = 5 * d * d + d * d + 5 * (d * 32 + 32 * d) + 2 * d
        cmix = 2 * d * cfg.d_ff + d * d
        per_layer_total = per_layer_active = tmix + cmix
    elif cfg.ssm_kind == "mamba2" and cfg.family == "hybrid":
        d_inner = 2 * d
        mamba = d * (2 * d_inner + 2 * cfg.ssm_state + cfg.ssm_heads) + d_inner * d
        per_layer_total = per_layer_active = mamba
    else:
        dense_l = max(cfg.first_dense_layers, 0)
        moe_l = cfg.n_layers - dense_l if cfg.is_moe else 0
        n_dense = cfg.n_layers - moe_l
        per_layer_total = attn + (ffn_dense if not cfg.is_moe else 0)
        per_layer_active = per_layer_total
        total = (cfg.n_layers * attn + n_dense * ffn_dense
                 + moe_l * (ffn_moe_total + router))
        active = (cfg.n_layers * attn + n_dense * ffn_dense
                  + moe_l * (ffn_moe_active + router))
        emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
        if cfg.is_encdec:
            total += cfg.enc_layers * (attn + ffn_dense) + cfg.n_layers * (attn)  # cross-attn
            active = total
        return {"total": total + emb, "active": active + emb, "embedding": emb}

    # ssm / hybrid path
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    total = cfg.n_layers * per_layer_total
    if cfg.attn_every:
        # one shared attention block (+ lora deltas folded in approx)
        total += attn + ffn_dense
    return {"total": total + emb, "active": total + emb, "embedding": emb}


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS per step: 6*N*D for training, 2*N_active*D forward-only.

    N excludes embeddings-as-lookup but includes the LM head matmul via the
    embedding term when tied (standard 6ND convention keeps it simple).
    """
    counts = param_counts(cfg)
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * counts["active"] * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * counts["active"] * tokens
    # decode: one new token per sequence
    tokens = shape.global_batch
    return 2.0 * counts["active"] * tokens

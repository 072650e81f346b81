"""Model configuration for all assigned architectures.

One ``ModelConfig`` describes any member of the supported families:
  dense   — llama-style decoder-only transformer (GQA/MQA, SWA optional)
  moe     — dense + mixture-of-experts FFN (top-k routing, shared experts)
  ssm     — Mamba2 / SSD attention-free stack
  hybrid  — Mamba2 backbone + shared (weight-tied) attention blocks (Zamba2)
  encdec  — encoder-decoder transformer (Whisper); frontend stubbed
  vlm     — decoder-only backbone consuming text tokens + precomputed patch
            embeddings (LLaVA-NeXT); vision tower stubbed

The assigned input-shape cells are also defined here (``SHAPE_CELLS``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None        # default: d_model // num_heads
    # §Perf "pad_heads": allocate this many q heads (>= num_heads, grouped
    # per KV head) so head count divides the TP axis; heads beyond
    # num_heads are dead (wo rows masked to zero -> function-identical).
    padded_heads: Optional[int] = None
    qkv_bias: bool = False                # qwen1.5
    swa_window: Optional[int] = None      # sliding-window attention (mistral-like)
    use_rope: bool = True                 # whisper uses sinusoidal embeds instead
    scale_embed: bool = False             # gemma multiplies embeds by sqrt(D)
    rope_theta: float = 10_000.0
    mlp_kind: str = "swiglu"              # swiglu | geglu | gelu
    norm_kind: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = True

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                     # per-expert hidden size
    capacity_factor: float = 1.25

    # --- MLA (DeepSeek-V2) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_kernel: int = 4

    # --- hybrid (Zamba2) ---
    attn_every: int = 0                   # shared attn block applied every K layers

    # --- encoder-decoder (Whisper) ---
    num_encoder_layers: int = 0
    encoder_seq: int = 1500               # Whisper 30s spectrogram frames

    # --- VLM (LLaVA) ---
    num_patches: int = 0                  # precomputed patch embeddings per image

    # --- numerics ---
    compute_dtype: str = "bfloat16"       # matmul/activation dtype (roofline target)
    param_dtype: str = "float32"          # master weights
    logit_chunk: int = 1024               # sequence chunking for the CE loss head

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(
                self, "head_dim",
                self.d_model // max(self.num_heads, 1) if self.num_heads else 0,
            )

    # ------------------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if decode memory is sub-quadratic in context (SSM / hybrid).

        Pure full-attention archs skip the long_500k cell (see DESIGN.md).
        Hybrid qualifies: its attention KV is needed only at 1/attn_every
        density and its decode state is O(1) in the Mamba path.
        """
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def gqa_groups(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Total parameter count N (for MODEL_FLOPS = 6*N*D roofline term)."""
        return _count_params(self)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: shared + top-k experts only)."""
        return _count_params(self, active_only=True)


def _count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    D, V = cfg.d_model, cfg.vocab_size
    total = V * D  # embedding
    if not cfg.tie_embeddings:
        total += V * D

    def attn_params() -> int:
        hd = cfg.head_dim
        if cfg.use_mla:
            # q proj, kv down (lora), kv up, rope key, out proj
            qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
            p = D * cfg.num_heads * qk_dim                       # wq
            p += D * (cfg.kv_lora_rank + cfg.qk_rope_dim)        # kv down + k_pe
            p += cfg.kv_lora_rank * cfg.num_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
            p += cfg.num_heads * cfg.v_head_dim * D              # wo
            return p
        p = D * cfg.num_heads * hd + 2 * D * cfg.num_kv_heads * hd
        p += cfg.num_heads * hd * D
        if cfg.qkv_bias:
            p += (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
        return p

    def mlp_params(d_ff: int) -> int:
        if cfg.mlp_kind in ("swiglu", "geglu"):
            return 3 * D * d_ff
        return 2 * D * d_ff

    def moe_layer_params() -> int:
        router = D * cfg.num_experts
        shared = cfg.num_shared_experts * 3 * D * cfg.moe_d_ff
        if active_only:
            routed = cfg.experts_per_token * 3 * D * cfg.moe_d_ff
        else:
            routed = cfg.num_experts * 3 * D * cfg.moe_d_ff
        return router + shared + routed

    def mamba_params() -> int:
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        p = D * (2 * di + 2 * N + H)     # in_proj -> z, x, B, C, dt
        p += cfg.conv_kernel * (di + 2 * N)  # depthwise conv over x, B, C
        p += H * 2                        # A_log, D skip (per head)
        p += di * D                       # out proj
        p += di                           # gate norm
        return p

    norm = 2 * D  # two pre-norms per block (approx; ssm blocks have one)

    if cfg.family in ("dense", "vlm"):
        total += cfg.num_layers * (attn_params() + mlp_params(cfg.d_ff) + norm)
    elif cfg.family == "moe":
        total += cfg.num_layers * (attn_params() + moe_layer_params() + norm)
    elif cfg.family == "ssm":
        total += cfg.num_layers * (mamba_params() + D)
    elif cfg.family == "hybrid":
        total += cfg.num_layers * (mamba_params() + D)
        # one weight-tied attention + mlp block (counted once)
        total += attn_params() + mlp_params(cfg.d_ff) + norm
    elif cfg.family == "encdec":
        enc = cfg.num_encoder_layers * (attn_params() + mlp_params(cfg.d_ff) + norm)
        dec = cfg.num_layers * (2 * attn_params() + mlp_params(cfg.d_ff) + 3 * D)
        total += enc + dec
    total += D  # final norm
    return int(total)


# ---------------------------------------------------------------------------
# Assigned input-shape cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPE_CELLS: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {c.name: c for c in SHAPE_CELLS}


def cell_is_applicable(cfg: ModelConfig, cell: ShapeCell) -> bool:
    """long_500k requires sub-quadratic attention (SSM/hybrid only)."""
    if cell.name == "long_500k":
        return cfg.supports_long_context
    return True

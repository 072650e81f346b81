"""zamba2-2.7b [hybrid]: Mamba2 backbone + one weight-tied (shared)
attention block applied every 6 layers. [arXiv:2411.15242; hf]
54L d_model=2560 32H (kv=32) d_ff=10240 ssm_state=64 vocab=32000.
54 layers / attn_every=6 -> 9 groups, each = shared attn block + 6 mamba."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    attn_every=6,
    mlp_kind="swiglu",
)

"""mixtral-8x7b [moe]: 8 experts top-2, SWA. [arXiv:2401.04088; hf]
32L d_model=4096 32H (GQA kv=8) expert d_ff=14336 vocab=32000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=0,
    vocab_size=32000,
    num_experts=8,
    experts_per_token=2,
    num_shared_experts=0,
    moe_d_ff=14336,
    swa_window=4096,
    mlp_kind="swiglu",
    rope_theta=1_000_000.0,
)

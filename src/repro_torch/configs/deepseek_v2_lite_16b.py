"""deepseek-v2-lite-16b [moe]: MLA (kv_lora=512) + 64 routed experts top-6
with 2 shared experts, expert d_ff=1408. [arXiv:2405.04434; hf]
27L d_model=2048 16H vocab=102400.

Per the assigned pool header we use 64 routed experts top-6 (the "160
routed" aside describes full V2, not Lite — see DESIGN.md §5).  All layers
are MoE (the real model's single dense first layer is not in the assigned
config)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=0,
    vocab_size=102_400,
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    mlp_kind="swiglu",
)

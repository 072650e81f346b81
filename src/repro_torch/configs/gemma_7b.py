"""gemma-7b [dense]: GeGLU, head_dim=256, embeds scaled by sqrt(D).
[arXiv:2403.08295; hf]  28L d_model=3072 16H (kv=16: MHA) d_ff=24576
vocab=256000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256_000,
    mlp_kind="geglu",
    scale_embed=True,
    norm_eps=1e-6,
)

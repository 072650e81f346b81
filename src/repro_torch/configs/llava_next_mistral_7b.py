"""llava-next-mistral-7b [vlm]: mistral-7b backbone; anyres vision tower is
a STUB (input_specs provides precomputed patch embeddings, 576 per tile).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    num_patches=576,
    mlp_kind="swiglu",
    rope_theta=1_000_000.0,
)

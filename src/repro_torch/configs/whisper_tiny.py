"""whisper-tiny [audio]: enc-dec transformer backbone; conv frontend is a
STUB (input_specs provides precomputed frame embeddings).
[arXiv:2212.04356; unverified]  4L enc + 4L dec, d_model=384 6H d_ff=1536
vocab=51865, 1500 encoder frames (30 s), GELU MLP, LayerNorm, sinusoidal
positions (no RoPE)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,
    num_encoder_layers=4,
    encoder_seq=1500,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    mlp_kind="gelu",
    norm_kind="layernorm",
    use_rope=False,
)

"""h2o-danube3-4b [dense]: llama+mistral mix with SWA.
[arXiv:2401.16818; unverified]  24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000.  head_dim = 3840/32 = 120 (not 128-aligned; noted in the
roofline analysis).  Sliding window 4096 (danube family default)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    swa_window=4096,
    mlp_kind="swiglu",
    rope_theta=10_000.0,
)

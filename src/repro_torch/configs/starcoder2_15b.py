"""starcoder2-15b [dense]: 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE. [arXiv:2402.19173; hf]"""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    activation="gelu",
    qkv_bias=True,
    rope_theta=100_000.0,
    remat="full",
)

SMOKE = ModelConfig(
    name="starcoder2-smoke",
    family="dense",
    n_layers=3,
    d_model=96,
    n_heads=8,
    n_kv_heads=2,
    d_ff=384,
    vocab=512,
    activation="gelu",
    qkv_bias=True,
)

"""gemma-7b [dense]: 28L d_model=3072 16H (MHA kv=16) d_ff=24576
vocab=256000 — GeGLU, head_dim=256. [arXiv:2403.08295; hf]"""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab=256000,
    activation="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    remat="full",
)

SMOKE = ModelConfig(
    name="gemma-smoke",
    family="dense",
    n_layers=3,
    d_model=96,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=384,
    vocab=512,
    activation="geglu",
    tie_embeddings=True,
)

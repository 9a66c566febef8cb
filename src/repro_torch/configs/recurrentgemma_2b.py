"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, 1 attn per 2 recurrent blocks.
[arXiv:2402.19427; hf]

Sub-quadratic (local window 2048) -> runs the long_500k cell."""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    block_types=("rglru", "rglru", "local_attn"),
    local_window=2048,
    lru_width=2560,
    conv1d_width=4,
    activation="geglu",
    tie_embeddings=True,
    remat="full",
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    n_layers=5,
    d_model=80,
    n_heads=4,
    n_kv_heads=1,
    head_dim=20,
    d_ff=240,
    vocab=512,
    block_types=("rglru", "rglru", "local_attn"),
    local_window=16,
    lru_width=80,
    activation="geglu",
    tie_embeddings=True,
)

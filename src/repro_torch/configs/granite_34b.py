"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-arch code model. [arXiv:2405.04324; hf]

Deepest assigned model: the scan-over-layers requirement exists for
this config (88 layers x 512-way mesh must compile on one CPU core)."""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    activation="gelu",
    rope_theta=10_000.0,
    remat="full",
)

SMOKE = ModelConfig(
    name="granite-34b-smoke",
    family="dense",
    n_layers=4,
    d_model=96,
    n_heads=8,
    n_kv_heads=1,
    d_ff=384,
    vocab=512,
    activation="gelu",
)

"""mamba2-1.3b [ssm]: 48L d_model=2048 attention-free vocab=50280,
SSD with state=128. [arXiv:2405.21060; unverified]

Attention-free -> the MATCH pattern tables for attention never fire
(DESIGN.md Arch-applicability); sub-quadratic -> runs long_500k."""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=64,  # d_inner(4096) / ssm_head_dim(64)
    vocab=50280,
    block_types=("ssd",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    pos_kind="none",
    tie_embeddings=True,
    remat="full",
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=3,
    d_model=64,
    n_heads=8,
    vocab=512,
    block_types=("ssd",),
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    pos_kind="none",
    tie_embeddings=True,
)

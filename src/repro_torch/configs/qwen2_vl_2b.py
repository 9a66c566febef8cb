"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

Backbone only per the brief; the vision frontend is a stub
(input_specs provide precomputed patch embeddings)."""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    activation="swiglu",
    qkv_bias=True,
    pos_kind="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    frontend_stub=True,  # vision tower stubbed: train on precomputed patch embeds
    remat="full",
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab=512,
    activation="swiglu",
    qkv_bias=True,
    pos_kind="mrope",
    mrope_sections=(2, 3, 3),
    tie_embeddings=True,
    frontend_stub=True,
)

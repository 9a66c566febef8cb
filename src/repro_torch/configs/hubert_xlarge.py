"""hubert-xlarge [audio]: 48L d_model=1280 16H (MHA) d_ff=5120 vocab=504
— encoder-only (wav2vec2 arch). [arXiv:2106.07447; unverified]

Per the brief the conv waveform frontend is a stub: input_specs provide
precomputed frame embeddings (B, T, d_model); training predicts the 504
cluster labels per frame.  Encoder-only -> decode shape cells skipped."""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    activation="gelu",
    pos_kind="none",  # conv positional embedding lives in the stub
    frontend_stub=True,
    remat="full",
)

SMOKE = ModelConfig(
    name="hubert-smoke",
    family="audio",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=64,
    causal=False,
    activation="gelu",
    pos_kind="none",
    frontend_stub=True,
)

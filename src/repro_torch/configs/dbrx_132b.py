"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) per-expert d_ff=10752
vocab=100352, fine-grained MoE 16 experts top-4.
[hf:databricks/dbrx-base; unverified]"""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=0,
    vocab=100352,
    n_experts=16,
    top_k=4,
    moe_d_ff=10752,
    activation="swiglu",
    rope_theta=500_000.0,
    remat="full",
)

SMOKE = ModelConfig(
    name="dbrx-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=0,
    vocab=512,
    n_experts=4,
    top_k=2,
    moe_d_ff=64,
    activation="swiglu",
)

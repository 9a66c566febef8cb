"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8)
per-expert d_ff=512 vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

40 experts do NOT divide the 16-way "model" mesh axis -> the autoshard
dispatcher must pick TP-sharded expert hidden (d_ff 512/16=32) over EP
(the cost-model arbitration case called out in DESIGN.md)."""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=0,
    vocab=49155,
    n_experts=40,
    top_k=8,
    moe_d_ff=512,
    activation="swiglu",
    tie_embeddings=True,
    remat="full",
)

SMOKE = ModelConfig(
    name="granite-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=0,
    vocab=512,
    n_experts=5,  # non-divisible expert count, like the parent
    top_k=2,
    moe_d_ff=48,
    activation="swiglu",
    tie_embeddings=True,
)

"""granite-4.0-h-small [hybrid moe]: 40L d_model=4096, 36 Mamba-2 blocks
(128 heads of 64, d_state 128, one group, conv 4 with bias, expand 2) and
4 GQA attention blocks (32 query / 8 KV heads of 128, NoPE) at layers 5,
15, 25, 35; every block is followed by a dropless MoE of 72 SwiGLU
experts of width 768, top-10, beside one shared expert of width 1536.
vocab=100352 tied.  Multipliers: embedding 12, residual 0.22, attention
1/128, logits divided by 16.  32B total, 9B active.
[hf:ibm-granite/granite-4.0-h-small config.json, model_type granitemoehybrid]

The pattern's period is 10 layers, so ``block_types`` holds one period and
the layers form one stack of 4 repeats.  Not in ``ALL_ARCHS``: that list
is the ten architectures the JAX package also holds.  ``get_config`` /
``get_smoke`` resolve it by id."""

from repro_torch.models import GraniteConfig

PERIOD = ("ssd",) * 5 + ("attn",) + ("ssd",) * 4

CONFIG = GraniteConfig(
    name="granite-4.0-h-small",
    family="moe",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    vocab=100352,
    block_types=PERIOD,
    pos_kind="none",
    n_experts=72,
    top_k=10,
    moe_d_ff=768,
    moe_shared_d_ff=1536,
    moe_dropless=True,
    activation="swiglu",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_conv_bias=True,
    ssd_mlp=True,
    embed_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    attn_scale=1.0 / 128,
    norm_eps=1e-5,
    tie_embeddings=True,
    remat="full",
)

# one period at small widths; the attention scale stays 1/head_dim, as
# granite's 1/128 is for heads of 128
SMOKE = CONFIG.replace(
    name="granite-4.0-h-smoke",
    n_layers=10,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    vocab=512,
    n_experts=8,
    top_k=2,
    moe_d_ff=32,
    moe_shared_d_ff=48,
    ssm_state=16,
    ssm_head_dim=16,
    attn_scale=1.0 / 16,
    remat="none",
)

"""Model configuration covering the ten assigned architectures.

One dataclass describes every LM family in the pool: dense decoders
(starcoder2, granite-34b, qwen2.5, gemma), MoE decoders (dbrx,
granite-moe), a VLM backbone (qwen2-vl, M-RoPE), an encoder-only audio
model (hubert), a hybrid recurrent model (recurrentgemma, RG-LRU + local
attention 1:2) and an attention-free SSM (mamba2, SSD).  The port adds
granite-4.0-h (Mamba-2 and NoPE attention blocks, each followed by a
dropless MoE with a shared expert, and the four granite multipliers).

``layer_pattern()`` expands the per-layer block types; contiguous runs of
the same type are scanned (``jax.lax.scan``) so HLO size and compile time
stay O(1) in depth — required to compile granite-34b's 88 layers for a
512-chip mesh on this container's single CPU core.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import ClassVar, Literal, Sequence

__all__ = ["GraniteConfig", "ModelConfig"]

BlockType = Literal["attn", "local_attn", "rglru", "ssd"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    vocab: int
    d_ff: int = 0
    n_kv_heads: int = 0  # 0 -> = n_heads (MHA)
    head_dim: int = 0  # 0 -> d_model // n_heads

    # block composition
    block_types: tuple[str, ...] = ("attn",)  # repeating pattern
    causal: bool = True  # False for encoder-only (hubert)
    local_window: int = 2048  # for local_attn blocks

    # MLP
    activation: str = "swiglu"  # swiglu | geglu | gelu
    qkv_bias: bool = False

    # positions
    rope_theta: float = 10_000.0
    pos_kind: str = "rope"  # rope | mrope | none
    mrope_sections: tuple[int, ...] = (16, 24, 24)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden (fine-grained MoE)
    capacity_factor: float = 1.25
    moe_combine: str = "gather"  # gather | scatter (see EXPERIMENTS §Perf)
    moe_dispatch: str = "token"  # token | unique_k (§Perf A7: refuted, kept for the log)

    # SSM (mamba2 SSD)
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4

    # RG-LRU (recurrentgemma)
    lru_width: int = 0  # 0 -> d_model
    conv1d_width: int = 4

    # norms / dtypes
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    # training
    remat: str = "none"  # none | full | dots  (activation checkpointing)
    scan_layers: bool = True

    # modality frontend stub (vlm/audio): inputs are precomputed embeddings
    frontend_stub: bool = False

    # granite-4.0-h's settings: fields of GraniteConfig alone, so that this
    # class keeps the reference's fields; every other family reads these
    moe_shared_d_ff: ClassVar[int] = 0
    moe_dropless: ClassVar[bool] = False
    ssm_conv_bias: ClassVar[bool] = False
    ssd_mlp: ClassVar[bool] = False
    embed_multiplier: ClassVar[float] = 0.0
    residual_multiplier: ClassVar[float] = 1.0
    logits_scaling: ClassVar[float] = 1.0
    attn_scale: ClassVar[float] = 0.0

    # ------------------------------------------------------------------
    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attention_free(self) -> bool:
        return all(t in ("ssd", "rglru") for t in self.block_types)

    @property
    def sub_quadratic(self) -> bool:
        """True when no block attends over the full sequence."""
        return all(t in ("ssd", "rglru", "local_attn") for t in self.block_types)

    @property
    def decoder(self) -> bool:
        return self.causal

    def has_ffn(self, btype: str) -> bool:
        """Whether a block of type ``btype`` ends in the MLP / MoE half."""
        return btype != "ssd" or self.ssd_mlp

    def layer_pattern(self) -> tuple[str, ...]:
        """Expand block_types to n_layers entries."""
        pat = []
        i = 0
        while len(pat) < self.n_layers:
            pat.append(self.block_types[i % len(self.block_types)])
            i += 1
        return tuple(pat)

    def scan_groups(self) -> list[tuple[str, int]]:
        """Contiguous runs of identical block types: [(type, count), ...].

        For repeating heterogeneous patterns (recurrentgemma RRA), the
        model scans over *super-blocks* instead; see transformer.py.
        """
        groups: list[tuple[str, int]] = []
        for t in self.layer_pattern():
            if groups and groups[-1][0] == t:
                groups[-1] = (t, groups[-1][1] + 1)
            else:
                groups.append((t, 1))
        return groups

    def n_params(self) -> int:
        """Parameter count (embedding included once)."""
        d, v = self.d_model, self.vocab
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d  # lm head
        hd, nh, nkv = self.head_dim_, self.n_heads, self.kv_heads
        for t in self.layer_pattern():
            total += 2 * d  # norms
            if t in ("attn", "local_attn"):
                total += d * nh * hd + 2 * d * nkv * hd + nh * hd * d
                if self.qkv_bias:
                    total += (nh + 2 * nkv) * hd
            elif t == "rglru":
                w = self.lru_width or d
                total += d * w * 2 + w * d + w * self.conv1d_width + 2 * w  # proj + gates
            elif t == "ssd":
                d_in = self.ssm_expand * d
                nh_s = d_in // self.ssm_head_dim
                total += d * (2 * d_in + 2 * self.ssm_state + nh_s) + d_in * d
                total += self.ssm_conv * (d_in + 2 * self.ssm_state)
                if self.ssm_conv_bias:
                    total += d_in + 2 * self.ssm_state
            if not self.has_ffn(t):
                continue  # mamba2 blocks have no separate MLP
            if self.is_moe:
                total += self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
                total += 3 * d * self.moe_shared_d_ff
            else:
                n_mats = 3 if self.activation in ("swiglu", "geglu") else 2
                total += n_mats * d * self.d_ff
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only top_k experts, and the
        shared expert)."""
        if not self.is_moe:
            return self.n_params()
        n_moe = sum(self.has_ffn(t) for t in self.layer_pattern())
        idle = n_moe * (self.n_experts - self.top_k) * 3 * self.d_model * self.moe_d_ff
        return self.n_params() - idle

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class GraniteConfig(ModelConfig):
    """granite-4.0-h (``granitemoehybrid``): the blocks of a
    :class:`ModelConfig` and the settings the reference's families lack."""

    moe_shared_d_ff: int = 0  # >0: one shared SwiGLU expert of this width beside the routed ones, weight 1
    moe_dropless: bool = False  # the capacity holds every routed pair: no token is dropped
    ssm_conv_bias: bool = False  # the causal conv adds a per-channel bias
    ssd_mlp: bool = False  # ssd blocks are followed by the MLP / MoE half, not alone (mamba2)
    embed_multiplier: float = 0.0  # 0 -> sqrt(d_model), the gemma-style input scale
    residual_multiplier: float = 1.0  # each block's update is scaled by it before the residual add
    logits_scaling: float = 1.0  # the logits are divided by it
    attn_scale: float = 0.0  # the softmax scale of q.k; 0 -> 1/sqrt(head_dim)

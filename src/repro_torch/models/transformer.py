"""The LM for the ``attn``, ``local_attn``, ``rglru`` and ``ssd`` blocks — in PyTorch.

The port of ``repro.models.transformer``.  One class, :class:`LM`, an
``nn.Module`` holding its own parameters, for stacks of
* ``attn`` blocks with a dense MLP (gemma-7b, granite-34b, qwen2.5-3b,
  starcoder2-15b) or a top-k MoE (granite-moe-3b-a800m, dbrx-132b),
* mamba2 ``ssd`` blocks, which carry no MLP (mamba2-1.3b), and
* Griffin ``rglru`` blocks and windowed ``local_attn`` blocks, each with
  an MLP, in recurrentgemma-2b's (rglru, rglru, local_attn) pattern.
M-RoPE (qwen2-vl) and the frontend stub (hubert) raise
``NotImplementedError`` naming the ROADMAP item that ports them.

What changes against the reference:

* The reference scans stacked per-layer parameters with ``lax.scan``;
  here a Python loop walks ``LM.layers``, one module per layer, whose
  parameters are the slices of the reference's stacked leaves.
  :meth:`LM.param_specs` and :meth:`LM.param_shapes` still describe the
  stacked tree, and :func:`params_from_jax` loads one into the module.
* The cache keeps the reference's tree and layout: per stack and
  ``attn`` block ``{"k", "v": (layers, B, L, KV, hd), "pos": (layers,
  L)}`` with ``L = S_max`` and the ``pos`` leaf tagging each slot; a
  ``local_attn`` block the same with ``L = min(S_max, local_window)``, a
  ring buffer that decode writes at slot ``position % L``; per ``rglru``
  block ``{"h": (layers, B, W) fp32, "conv": (layers, B, conv-1, W)}``;
  per ``ssd`` block ``{"h": (layers, B, H, P, N) fp32, "conv_x",
  "conv_B", "conv_C": (layers, B, conv-1, ...)}``.  ``prefill`` and
  ``decode_step`` write it in place (no copy of the cache per step) and
  return it.
* The reference's ring mapping is right only when the prompt fits the
  ring or fills it a whole number of times (``S <= L`` or ``S % L ==
  0``); otherwise decode overwrites slots still inside the window
  (ROADMAP C-ref-6).  The port reproduces that, slot for slot.
* Prefill attention runs through the flash kernel
  (:func:`repro_torch.models.attention.attention_kv`) and reuses its k/v
  for the cache, where the reference projects them a second time.  The
  MoE expert GEMMs run through the ``moe_gmm`` kernel
  (:mod:`repro_torch.models.moe`), the SSD core of prefill and forward
  through the ``ssd_scan`` kernel (:mod:`repro_torch.models.ssd`), the
  RG-LRU recurrence through the ``rglru_scan`` kernel
  (:mod:`repro_torch.models.rglru`).

Entry points:
  forward(tokens | embeds)            -> (logits (B,S,V), MoE aux)
  prefill(tokens, max_len)            -> (last_logits (B,V), cache)
  decode_step(cache, tokens, position)-> (logits (B,V), cache)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import attention_kv, rope_tables
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    ParamSpec,
    embed_params,
    init_from_specs,
    map_specs,
    mlp,
    mlp_params,
    rmsnorm,
    spec_shapes,
    torch_dtype,
)
from repro_torch.models.moe import moe_ffn, moe_params
from repro_torch.models.rglru import rglru_block, rglru_decode_step, rglru_params, rglru_state_init
from repro_torch.models.ssd import ssd_block, ssd_decode_step, ssd_params, ssd_state_init

__all__ = ["LM", "StackSpec", "params_from_jax"]


@dataclass(frozen=True)
class StackSpec:
    """One stack: a block pattern repeated ``repeats`` times."""

    pattern: tuple[str, ...]  # e.g. ("attn",) or ("rglru","rglru","attn")
    repeats: int


def _plan_stacks(cfg: ModelConfig) -> list[StackSpec]:
    pat = cfg.layer_pattern()
    period = len(cfg.block_types)
    if period > 1:
        reps = len(pat) // period
        rem = len(pat) % period
        stacks = [StackSpec(tuple(cfg.block_types), reps)]
        if rem:
            stacks.append(StackSpec(tuple(pat[-rem:]), 1))
        return stacks
    return [StackSpec((pat[0],), len(pat))]


def _stack_specs(specs, n: int):
    """Add a leading 'layers' axis of size n to every ParamSpec."""
    return map_specs(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.dtype, s.init, s.scale), specs)


# logical axes of each block type's cache leaves (the reference's)
_KV_AXES = {
    "k": ("layers", "batch", None, "kv_heads", None),
    "v": ("layers", "batch", None, "kv_heads", None),
    "pos": ("layers", None),
}
_CACHE_AXES = {
    "attn": _KV_AXES,
    "local_attn": _KV_AXES,
    "rglru": {
        "h": ("layers", "batch", "ffn"),
        "conv": ("layers", "batch", None, "ffn"),
    },
    "ssd": {
        "h": ("layers", "batch", "heads", None, None),
        "conv_x": ("layers", "batch", None, "ffn"),
        "conv_B": ("layers", "batch", None, None),
        "conv_C": ("layers", "batch", None, None),
    },
}


def _check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet, naming its ROADMAP item."""
    missing = []
    if cfg.pos_kind == "mrope":
        missing.append("M-RoPE positions for qwen2-vl (ROADMAP A11)")
    if cfg.frontend_stub:
        missing.append("the modality frontend stub (ROADMAP A11)")
    if missing:
        raise NotImplementedError(f"{cfg.name}: the port does not run " + "; ".join(missing) + " yet")


class _Params(nn.Module):
    """A nested dict of tensors, registered as (frozen) parameters."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Params(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def tree(self) -> dict:
        out: dict[str, Any] = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class LM(nn.Module):
    """The reference ``LM`` with its parameters inside.

    ``device=None`` means the CUDA device (raising without a card); the
    weights are drawn from ``generator`` (default: a generator on
    ``device`` seeded 0) with the reference's distribution.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, generator: torch.Generator | None = None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.stacks = _plan_stacks(cfg)
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        tree = init_from_specs(self.param_specs(), generator, dev)
        layers = []
        for i, st in enumerate(self.stacks):
            stack = tree.pop(f"stack{i}")
            for r in range(st.repeats):
                for j, bt in enumerate(st.pattern):
                    layers.append(_Params(_index(stack[f"b{j}_{bt}"], r)))
        self.layers = nn.ModuleList(layers)
        # the block type of each entry of self.layers
        self.block_types = [bt for st in self.stacks for _ in range(st.repeats) for bt in st.pattern]
        self.top = _Params(tree)  # embed, final_norm (and lm_head)

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------
    def _block_specs(self, btype: str) -> dict:
        cfg = self.cfg
        d = cfg.d_model
        out: dict[str, Any] = {"norm1": ParamSpec((d,), ("embed",), "float32", init="zeros")}
        if btype == "ssd":
            out["ssd"] = ssd_params(cfg)
            return out  # mamba2 blocks carry no separate MLP
        if btype == "rglru":
            out["rglru"] = rglru_params(cfg)
        else:
            out["attn"] = attn_mod.attention_params(cfg)
        out["norm2"] = ParamSpec((d,), ("embed",), "float32", init="zeros")
        if cfg.is_moe:
            out["moe"] = moe_params(cfg)
        else:
            out["mlp"] = mlp_params(d, cfg.d_ff, cfg.activation, cfg.dtype)
        return out

    def param_specs(self) -> dict:
        """The reference's parameter tree: stacked ``stack{i}`` leaves with
        a leading ``layers`` axis."""
        cfg = self.cfg
        specs: dict[str, Any] = {"embed": embed_params(cfg.vocab, cfg.d_model, cfg.dtype)}
        for i, st in enumerate(self.stacks):
            blk = {f"b{j}_{bt}": self._block_specs(bt) for j, bt in enumerate(st.pattern)}
            specs[f"stack{i}"] = _stack_specs(blk, st.repeats)
        specs["final_norm"] = ParamSpec((cfg.d_model,), ("embed",), "float32", init="zeros")
        if not cfg.tie_embeddings:
            specs["lm_head"] = ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"), cfg.dtype)
        return specs

    def param_shapes(self):
        """Tree of ``(shape, dtype name)`` parallel to :meth:`param_specs`."""
        return spec_shapes(self.param_specs())

    @property
    def device(self) -> torch.device:
        return self.top.embed.device

    def _params(self) -> tuple[dict, list[dict]]:
        """The parameters as the reference's dicts: top level, and one per layer."""
        return self.top.tree(), [layer.tree() for layer in self.layers]

    # ------------------------------------------------------------------
    # Blocks
    # ------------------------------------------------------------------
    def _embed_in(self, top: dict, tokens: torch.Tensor | None, embeds: torch.Tensor | None):
        cfg = self.cfg
        if embeds is not None:
            return embeds.to(torch_dtype(cfg.dtype))
        x = top["embed"][tokens]
        # gemma-style scale: sqrt in float32, then rounded to the weights' dtype
        scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32))
        return x * scale.to(device=x.device, dtype=x.dtype)

    def _rope_for(self, positions: torch.Tensor | None, S: int):
        cfg = self.cfg
        if cfg.pos_kind == "none":
            return (None, None)
        if positions is None:
            positions = torch.arange(S, device=self.device)
        return rope_tables(positions, cfg.head_dim_, cfg.rope_theta)

    def _head(self, top: dict, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(x, top["final_norm"], self.cfg.norm_eps)
        head = top["embed"] if self.cfg.tie_embeddings else top["lm_head"]
        return x @ head.t()

    def _block(self, bt: str, bp: dict, x: torch.Tensor, rope, lc: dict | None = None):
        """One block; with ``lc`` it also fills that layer's cache.
        Returns (x, the MoE aux loss or None)."""
        cfg = self.cfg
        h = rmsnorm(x, bp["norm1"], cfg.norm_eps)
        if bt == "ssd":
            y, state = ssd_block(bp["ssd"], h, cfg, return_state=True)
            if lc is not None:
                _copy_state(lc, state)
            return x + y, None
        if bt == "rglru":
            y, state = rglru_block(bp["rglru"], h, cfg, return_state=True)
            if lc is not None:
                _copy_state(lc, state)
            return self._ffn(bp, x + y)
        sin, cos = rope
        y, k, v = attention_kv(bp["attn"], h, cfg, sin=sin, cos=cos, window=self._window(bt))
        if lc is not None:
            _fill_layer_cache(lc, k, v)
        return self._ffn(bp, x + y)

    def _window(self, bt: str) -> int | None:
        return self.cfg.local_window if bt == "local_attn" else None

    def _ffn(self, bp: dict, x: torch.Tensor):
        """The residual MLP or MoE half of an attention or ``rglru`` block:
        (x, aux or None)."""
        cfg = self.cfg
        h2 = rmsnorm(x, bp["norm2"], cfg.norm_eps)
        if cfg.is_moe:
            y, aux = moe_ffn(bp["moe"], h2, cfg)
            return x + y, aux
        return x + mlp(bp["mlp"], h2, cfg.activation), None

    # ------------------------------------------------------------------
    # Training / encoder forward
    # ------------------------------------------------------------------
    def forward(
        self,
        tokens: torch.Tensor | None = None,
        *,
        embeds: torch.Tensor | None = None,
        positions: torch.Tensor | None = None,
        last_only: bool = False,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward; returns (logits (B,S,V), the MoE aux
        losses summed over layers (0 without MoE))."""
        top, layers = self._params()
        x = self._embed_in(top, tokens, embeds)
        rope = self._rope_for(positions, x.shape[1])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for bt, bp in zip(self.block_types, layers):
            x, a = self._block(bt, bp, x, rope)
            if a is not None:
                aux = aux + a
        if last_only:
            x = x[:, -1:]
        return self._head(top, x), aux

    # ------------------------------------------------------------------
    # Serving: cache init / prefill / decode
    # ------------------------------------------------------------------
    def _layer_cache(self, btype: str, n: int, batch: int, max_len: int) -> dict:
        """One block's cache leaves, stacked over ``n`` layers."""
        cfg = self.cfg
        dt, dev = torch_dtype(cfg.dtype), self.device
        if btype in ("ssd", "rglru"):
            init = ssd_state_init if btype == "ssd" else rglru_state_init
            return {k: v.new_zeros((n, *v.shape)) for k, v in init(cfg, batch, dev).items()}
        kv, hd = cfg.kv_heads, cfg.head_dim_
        length = min(max_len, cfg.local_window) if btype == "local_attn" else max_len
        return {
            "k": torch.zeros((n, batch, length, kv, hd), dtype=dt, device=dev),
            "v": torch.zeros((n, batch, length, kv, hd), dtype=dt, device=dev),
            "pos": torch.full((n, length), -1, dtype=torch.int32, device=dev),
        }

    def init_cache(self, batch: int, max_len: int) -> dict:
        return {
            f"stack{i}": {
                f"b{j}_{bt}": self._layer_cache(bt, st.repeats, batch, max_len) for j, bt in enumerate(st.pattern)
            }
            for i, st in enumerate(self.stacks)
        }

    def cache_axes(self) -> dict:
        """Tree of logical-axes tuples parallel to :meth:`init_cache`."""
        return {
            f"stack{i}": {f"b{j}_{bt}": dict(_CACHE_AXES[bt]) for j, bt in enumerate(st.pattern)}
            for i, st in enumerate(self.stacks)
        }

    def _layer_caches(self, cache: dict) -> list[dict]:
        """Per-layer views (``{"k", "v", "pos"}`` or the rglru or ssd state
        leaves) into the stacked cache, in the order of ``self.layers``."""
        out = []
        for i, st in enumerate(self.stacks):
            sc = cache[f"stack{i}"]
            for r in range(st.repeats):
                for j, bt in enumerate(st.pattern):
                    out.append({name: leaf[r] for name, leaf in sc[f"b{j}_{bt}"].items()})
        return out

    def _decode_attn(self, bt: str, ap: dict, x: torch.Tensor, lc: dict, position: int):
        """Single-token attention over the ``pos``-tagged cache slots;
        writes ``lc`` in place.  ``local_attn`` writes its ring buffer at
        ``position % L`` and keeps the keys inside its window."""
        cfg = self.cfg
        q, k_new, v_new = attn_mod._qkv(ap, x, cfg)
        if cfg.pos_kind != "none":
            pos = torch.tensor([position], dtype=torch.int32, device=x.device)
            sin, cos = rope_tables(pos, cfg.head_dim_, cfg.rope_theta)
            q = attn_mod.apply_rope(q, sin, cos)
            k_new = attn_mod.apply_rope(k_new, sin, cos)
        L = lc["k"].shape[1]
        # attn: lax.dynamic_update_slice clamps the slot into the buffer
        slot = position % L if bt == "local_attn" else min(max(position, 0), L - 1)
        lc["k"][:, slot] = k_new[:, 0]
        lc["v"][:, slot] = v_new[:, 0]
        lc["pos"][slot] = position
        posbuf = lc["pos"]
        valid = (posbuf >= 0) & (posbuf <= position)
        window = self._window(bt)
        if window is not None:
            valid &= posbuf > position - window
        out = attn_mod._attend_cache(q, lc["k"], lc["v"], valid, cfg, x.dtype)
        return out @ ap["wo"], lc

    def decode_step(
        self,
        cache: dict,
        tokens: torch.Tensor,  # (B,) int
        position: int,
    ) -> tuple[torch.Tensor, dict]:
        """One autoregressive step: logits for the next token; the cache is
        updated in place and returned."""
        cfg = self.cfg
        position = int(position)
        top, layers = self._params()
        x = self._embed_in(top, tokens[:, None], None)
        for bt, bp, lc in zip(self.block_types, layers, self._layer_caches(cache)):
            h = rmsnorm(x, bp["norm1"], cfg.norm_eps)
            if bt == "ssd":
                out, state = ssd_decode_step(bp["ssd"], h, lc, cfg)
                _copy_state(lc, state)
                x = x + out
                continue
            if bt == "rglru":
                out, state = rglru_decode_step(bp["rglru"], h, lc, cfg)
                _copy_state(lc, state)
            else:
                out, _ = self._decode_attn(bt, bp["attn"], h, lc, position)
            x, _ = self._ffn(bp, x + out)
        return self._head(top, x)[:, 0], cache

    def prefill(self, tokens: torch.Tensor, max_len: int | None = None) -> tuple[torch.Tensor, dict]:
        """One pass over the prompt filling the cache; returns
        (last-token logits (B,V), cache)."""
        B, S = tokens.shape
        max_len = max_len or S
        assert max_len >= S
        top, layers = self._params()
        x = self._embed_in(top, tokens, None)
        rope = self._rope_for(None, S)
        cache = self.init_cache(B, max_len)
        x = self._forward_filling(layers, x, rope, cache)
        return self._head(top, x[:, -1:])[:, 0], cache

    def _forward_filling(self, layers: list[dict], x: torch.Tensor, rope, cache: dict) -> torch.Tensor:
        """Forward pass that also writes each layer's cache entry (attention
        k/v, or the rglru or ssd block's final recurrent and conv states)."""
        for bt, bp, lc in zip(self.block_types, layers, self._layer_caches(cache)):
            x, _ = self._block(bt, bp, x, rope, lc)
        return x


def _copy_state(lc: dict, state: dict) -> None:
    """Write an rglru or ssd block's new state tensors into its cache views."""
    for k, v in state.items():
        lc[k].copy_(v)


def _fill_layer_cache(lc: dict, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write a prompt's k/v (B, S, KV, hd) into one layer's cache views."""
    S = k.shape[1]
    L = lc["k"].shape[1]
    if L <= S:
        # ring buffer (local_attn) or exactly-sized cache: keep the last L
        # entries; decode's ring slots follow only if S % L == 0 (C-ref-6)
        lc["k"].copy_(k[:, -L:])
        lc["v"].copy_(v[:, -L:])
        lc["pos"].copy_(torch.arange(S - L, S, dtype=torch.int32, device=k.device))
    else:
        # head-room for decode: prompt in slots [0, S); the rest stays 0 / -1
        lc["k"][:, :S] = k
        lc["v"][:, :S] = v
        lc["pos"][:S] = torch.arange(S, dtype=torch.int32, device=k.device)


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


@torch.no_grad()
def params_from_jax(lm: LM, params: dict) -> LM:
    """Load the reference ``LM.init`` tree into ``lm``.

    ``params`` is that tree with numpy leaves (``jax.tree.map(np.asarray,
    ...)``): ``stack{i}`` leaves carry a leading ``layers`` axis and
    weights are stored ``(in, out)``, the orientation the port keeps, so
    nothing is transposed.  Each leaf goes through float32 numpy (lossless
    for bf16) and is cast to the parameter's dtype.  Every parameter must
    be given, with its exact shape.
    """
    top, layers = lm._params()

    def load(dst: dict, src: dict, where: str) -> None:
        if set(dst) != set(src):
            raise ValueError(f"{where}: port keys {sorted(dst)} != given {sorted(src)}")
        for k in dst:
            if isinstance(dst[k], dict):
                load(dst[k], src[k], f"{where}/{k}")
                continue
            arr = np.asarray(src[k])
            if tuple(arr.shape) != tuple(dst[k].shape):
                raise ValueError(f"{where}/{k}: shape {arr.shape} != {tuple(dst[k].shape)}")
            dst[k].copy_(torch.from_numpy(arr.astype(np.float32)))

    stacks = {f"stack{i}" for i in range(len(lm.stacks))}
    load(top, {k: v for k, v in params.items() if k not in stacks}, "")
    n = 0
    for i, st in enumerate(lm.stacks):
        sp = params[f"stack{i}"]
        for r in range(st.repeats):
            for j, bt in enumerate(st.pattern):
                load(layers[n], _index(sp[f"b{j}_{bt}"], r), f"stack{i}[{r}]/b{j}_{bt}")
                n += 1
    return lm

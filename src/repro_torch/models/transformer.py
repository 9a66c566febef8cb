"""The LM for the ``attn``, ``local_attn``, ``rglru`` and ``ssd`` blocks — in PyTorch.

The port of ``repro.models.transformer``.  One class, :class:`LM`, an
``nn.Module`` holding its own parameters, for stacks of
* ``attn`` blocks with a dense MLP (gemma-7b, granite-34b, qwen2.5-3b,
  starcoder2-15b) or a top-k MoE (granite-moe-3b-a800m, dbrx-132b),
* mamba2 ``ssd`` blocks, which carry no MLP (mamba2-1.3b),
* Griffin ``rglru`` blocks and windowed ``local_attn`` blocks, each with
  an MLP, in recurrentgemma-2b's (rglru, rglru, local_attn) pattern, and
* granite-4.0-h's period of ten: ``ssd`` and NoPE ``attn`` blocks, each
  followed by a dropless MoE with a shared expert (``cfg.ssd_mlp``), the
  embedding, residual and logit multipliers of the configuration, and
  its attention scale,
with M-RoPE positions (qwen2-vl) and the modality frontend stub, one
projection of precomputed embeddings (qwen2-vl, hubert).

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
* A MoE half in ``forward`` and ``prefill`` records the span
  ``model.moe`` (:mod:`repro_torch.obs`) where the tracer is on.
* Prefill attention runs through the flash kernel
  (:func:`repro_torch.models.attention.attention_kv`) and reuses its k/v
  for the cache, where the reference projects them a second time.  The
  MoE expert GEMMs run through the ``moe_gmm`` kernel
  (:mod:`repro_torch.models.moe`), the SSD core of prefill and forward
  through the ``ssd_scan`` kernel (:mod:`repro_torch.models.ssd`), the
  RG-LRU recurrence through the ``rglru_scan`` kernel
  (:mod:`repro_torch.models.rglru`).

* Training: the parameters are created with ``requires_grad=False`` (the
  serving engines run under ``torch.inference_mode()``); the trainer
  (:mod:`repro_torch.training`) turns them on.  ``cfg.remat`` maps the
  reference's ``jax.checkpoint`` of one scan body to
  ``torch.utils.checkpoint`` of one layer: ``"full"`` recomputes the
  layer in the backward, ``"dots"`` keeps the outputs of its matmuls
  without batch dims (``mm``, ``addmm``: the reference's
  ``dots_with_no_batch_dims_saveable``) and recomputes the rest,
  ``"none"`` saves everything.  Each kernel wrapper has its own backward
  (``repro_torch.kernels``).
* :func:`params_to_jax` is the inverse of :func:`params_from_jax`, and
  :meth:`LM.reference_tree` / :meth:`LM.named_from_reference` carry any
  per-parameter tensors (AdamW's moments and master weights too) to the
  reference's stacked layout and back, for checkpoints both packages read.

Entry points:
  forward(tokens | embeds)            -> (logits (B,S,V), MoE aux)
  loss(batch)                         -> scalar (+ 0.01 MoE aux)
  prefill(tokens, max_len)            -> (last_logits (B,V), cache)
  decode_step(cache, tokens, position)-> (logits (B,V), cache)
"""

from __future__ import annotations

import functools
from collections import Counter
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch import obs
from repro_torch._device import resolve_device, upcast
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import attention_kv, mrope_tables, rope_tables
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

__all__ = ["LM", "StackSpec", "cache_axes", "param_specs", "params_from_jax", "params_to_jax"]


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


# remat="dots": the matmuls without batch dims keep their outputs
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


# each remat mode's context around a checkpointed layer's two passes
_REMAT_CONTEXT = {
    "full": noop_context_fn,
    "dots": functools.partial(create_selective_checkpoint_contexts, _dots_policy),
}


def _block_specs(cfg: ModelConfig, btype: str) -> dict:
    d = cfg.d_model
    out: dict[str, Any] = {"norm1": ParamSpec((d,), ("embed",), "float32", init="zeros")}
    if btype == "ssd":
        out["ssd"] = ssd_params(cfg)
        if not cfg.has_ffn(btype):
            return out  # mamba2 blocks carry no separate MLP
    elif btype == "rglru":
        out["rglru"] = rglru_params(cfg)
    else:
        out["attn"] = attn_mod.attention_params(cfg)
    out["norm2"] = ParamSpec((d,), ("embed",), "float32", init="zeros")
    if cfg.is_moe:
        out["moe"] = moe_params(cfg)
    else:
        out["mlp"] = mlp_params(d, cfg.d_ff, cfg.activation, cfg.dtype)
    return out


def param_specs(cfg: ModelConfig) -> dict:
    """The reference's ``LM(cfg).param_specs()``, no tensor made: stacked
    ``stack{i}`` leaves with a leading ``layers`` axis."""
    specs: dict[str, Any] = {"embed": embed_params(cfg.vocab, cfg.d_model, cfg.dtype)}
    if cfg.frontend_stub:
        # modality frontend stub: a single projection from precomputed
        # frame/patch embeddings
        specs["frontend"] = ParamSpec((cfg.d_model, cfg.d_model), ("embed", None), cfg.dtype)
    for i, st in enumerate(_plan_stacks(cfg)):
        blk = {f"b{j}_{bt}": _block_specs(cfg, bt) for j, bt in enumerate(st.pattern)}
        specs[f"stack{i}"] = _stack_specs(blk, st.repeats)
    specs["final_norm"] = ParamSpec((cfg.d_model,), ("embed",), "float32", init="zeros")
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"), cfg.dtype)
    return specs


def cache_axes(cfg: ModelConfig) -> dict:
    """The reference's ``LM(cfg).cache_axes()``: logical-axes tuples
    parallel to :meth:`LM.init_cache`."""
    return {
        f"stack{i}": {f"b{j}_{bt}": dict(_CACHE_AXES[bt]) for j, bt in enumerate(st.pattern)}
        for i, st in enumerate(_plan_stacks(cfg))
    }


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
        # the input scale (gemma-style sqrt(d_model) unless the configuration
        # sets a multiplier) in float32, rounded to the weights' dtype; made
        # once, so no step copies it from the host
        scale = (torch.tensor(cfg.embed_multiplier, dtype=torch.float32) if cfg.embed_multiplier
                 else torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32)))
        scale = scale.to(torch_dtype(cfg.dtype))
        self.register_buffer("embed_scale", scale.to(dev), persistent=False)

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------
    def param_specs(self) -> dict:
        """The reference's parameter tree: stacked ``stack{i}`` leaves with
        a leading ``layers`` axis (:func:`param_specs`)."""
        return param_specs(self.cfg)

    def param_shapes(self):
        """Tree of ``(shape, dtype name)`` parallel to :meth:`param_specs`."""
        return spec_shapes(self.param_specs())

    @property
    def device(self) -> torch.device:
        return self.top.embed.device

    def _params(self) -> tuple[dict, list[dict]]:
        """The parameters as the reference's dicts: top level, and one per layer."""
        return self.top.tree(), [layer.tree() for layer in self.layers]

    def _reference_paths(self) -> dict[str, tuple[tuple[str, ...], int | None]]:
        """Each parameter's name -> (its leaf's path in the reference tree,
        its index along that leaf's ``layers`` axis, or None at the top)."""
        paths = {f"top.{name}": (tuple(name.split(".")), None) for name, _ in self.top.named_parameters()}
        n = 0
        for i, st in enumerate(self.stacks):
            for r in range(st.repeats):
                for j, bt in enumerate(st.pattern):
                    for name, _ in self.layers[n].named_parameters():
                        paths[f"layers.{n}.{name}"] = ((f"stack{i}", f"b{j}_{bt}", *name.split(".")), r)
                    n += 1
        return paths

    def reference_tree(self, named: dict[str, torch.Tensor]) -> dict:
        """Tensors keyed by this module's parameter names (as
        ``named_parameters()`` gives them) -> the reference's tree: top-level
        leaves as given, each stack's leaves stacked over its repeats (a
        new tensor)."""
        tree: dict[str, Any] = {}
        stacked: dict[tuple[str, ...], dict[int, torch.Tensor]] = {}
        for name, (path, r) in self._reference_paths().items():
            if r is None:
                _set_path(tree, path, named[name])
            else:
                stacked.setdefault(path, {})[r] = named[name]
        for path, by_r in stacked.items():
            _set_path(tree, path, torch.stack([by_r[r] for r in range(len(by_r))]))
        return tree

    def named_from_reference(self, tree: dict) -> dict[str, Any]:
        """The inverse of :meth:`reference_tree`: a reference tree (tensors
        or numpy leaves) -> each parameter's slice, keyed by its name."""
        out = {}
        for name, (path, r) in self._reference_paths().items():
            leaf = tree
            for k in path:
                leaf = leaf[k]
            out[name] = leaf if r is None else leaf[r]
        return out

    # ------------------------------------------------------------------
    # Blocks
    # ------------------------------------------------------------------
    def _embed_in(self, top: dict, tokens: torch.Tensor | None, embeds: torch.Tensor | None):
        cfg = self.cfg
        if embeds is not None:
            x = embeds.to(torch_dtype(cfg.dtype))
            return x @ top["frontend"] if cfg.frontend_stub else x
        x = top["embed"][tokens]
        return x * self.embed_scale.to(x.dtype)

    def _rope_for(self, positions: torch.Tensor | None, B: int, S: int):
        cfg = self.cfg
        if cfg.pos_kind == "none":
            return (None, None)
        if positions is None:
            positions = torch.arange(S, device=self.device)
        if cfg.pos_kind == "mrope":
            if positions.dim() == 1:
                positions = positions.expand(3, B, S)
            return mrope_tables(positions, cfg.mrope_sections, cfg.head_dim_, cfg.rope_theta)
        return rope_tables(positions, cfg.head_dim_, cfg.rope_theta)

    def _head(self, top: dict, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(x, top["final_norm"], self.cfg.norm_eps)
        head = top["embed"] if self.cfg.tie_embeddings else top["lm_head"]
        logits = x @ head.t()
        return logits if self.cfg.logits_scaling == 1.0 else logits / self.cfg.logits_scaling

    def _add(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The residual add of a block's update ``y``, scaled by the
        configuration's residual multiplier."""
        m = self.cfg.residual_multiplier
        return x + y if m == 1.0 else x + y * m

    def _block(self, bt: str, bp: dict, x: torch.Tensor, rope, lc: dict | None = None):
        """One block; with ``lc`` it also fills that layer's cache.
        Returns (x, the MoE aux loss or None)."""
        cfg = self.cfg
        h = rmsnorm(x, bp["norm1"], cfg.norm_eps)
        if bt == "ssd":
            y, state = ssd_block(bp["ssd"], h, cfg, return_state=True)
        elif bt == "rglru":
            y, state = rglru_block(bp["rglru"], h, cfg, return_state=True)
        else:
            sin, cos = rope
            y, k, v = attention_kv(bp["attn"], h, cfg, sin=sin, cos=cos, window=self._window(bt))
            state = None
        if lc is not None:
            if state is None:
                _fill_layer_cache(lc, k, v)
            else:
                _copy_state(lc, state)
        x = self._add(x, y)
        if not cfg.has_ffn(bt):
            return x, None
        if cfg.is_moe:
            with obs.span("model.moe", cat="model", tokens=x.shape[0] * x.shape[1]):
                return self._ffn(bp, x)
        return self._ffn(bp, x)

    def _window(self, bt: str) -> int | None:
        return self.cfg.local_window if bt == "local_attn" else None

    def _ffn(self, bp: dict, x: torch.Tensor):
        """The residual MLP or MoE half of a block (``cfg.has_ffn``):
        (x, aux or None)."""
        cfg = self.cfg
        h2 = rmsnorm(x, bp["norm2"], cfg.norm_eps)
        if cfg.is_moe:
            y, aux = moe_ffn(bp["moe"], h2, cfg)
            return self._add(x, y), aux
        return self._add(x, mlp(bp["mlp"], h2, cfg.activation)), None

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
        rope = self._rope_for(positions, x.shape[0], x.shape[1])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = self.cfg.remat if torch.is_grad_enabled() else "none"
        for bt, bp in zip(self.block_types, layers):
            if remat == "none":
                x, a = self._block(bt, bp, x, rope)
            else:
                x, a = checkpoint(self._block, bt, bp, x, rope, use_reentrant=False, context_fn=_REMAT_CONTEXT[remat])
            if a is not None:
                aux = aux + a
        if last_only:
            x = x[:, -1:]
        return self._head(top, x), aux

    def loss(self, batch: dict) -> torch.Tensor:
        """Mean next-token (or frame-label) cross-entropy + 0.01 x the MoE
        aux, as the reference's: logits in fp32, logsumexp minus the gold
        logit, averaged over ``batch["mask"]`` where given (at least 1)."""
        logits, aux = self.forward(batch.get("tokens"), embeds=batch.get("embeds"), positions=batch.get("positions"))
        logits = upcast(logits)
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
        nll = logz - gold
        mask = batch.get("mask")
        if mask is not None:
            nll = nll * mask
            denom = torch.clamp_min(torch.sum(mask), 1.0)
        else:
            denom = nll.numel()
        return torch.sum(nll) / denom + 0.01 * aux

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
        return cache_axes(self.cfg)

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

    def _decode_attn(self, bt: str, ap: dict, x: torch.Tensor, lc: dict, pos: torch.Tensor):
        """Single-token attention over the ``pos``-tagged cache slots;
        writes ``lc`` in place.  ``pos`` is a 0-d int32 tensor on the
        device: rope, the slot, the tag and the mask are computed there,
        as the reference's traced ``jnp.int32`` position is.  ``local_attn``
        writes its ring buffer at ``pos % L`` and keeps the keys inside its
        window; ``attn`` clamps the slot into the buffer, as
        ``lax.dynamic_update_slice`` does."""
        cfg = self.cfg
        q, k_new, v_new = attn_mod._qkv(ap, x, cfg)
        pos1 = pos.reshape(1)
        if cfg.pos_kind != "none":
            sin, cos = rope_tables(pos1, cfg.head_dim_, cfg.rope_theta)
            q = attn_mod.apply_rope(q, sin, cos)
            k_new = attn_mod.apply_rope(k_new, sin, cos)
        L = lc["k"].shape[1]
        slot = (pos1 % L if bt == "local_attn" else pos1.clamp(0, L - 1)).long()
        lc["k"].index_copy_(1, slot, k_new.to(lc["k"].dtype))
        lc["v"].index_copy_(1, slot, v_new.to(lc["v"].dtype))
        lc["pos"].index_copy_(0, slot, pos1)
        posbuf = lc["pos"]
        valid = (posbuf >= 0) & (posbuf <= pos)
        window = self._window(bt)
        if window is not None:
            valid &= posbuf > pos - window
        out = attn_mod._attend_cache(q, lc["k"], lc["v"], valid, cfg, x.dtype)
        return out @ ap["wo"], lc

    def decode_step(
        self,
        cache: dict,
        tokens: torch.Tensor,  # (B,) int
        position: int | torch.Tensor,
    ) -> tuple[torch.Tensor, dict]:
        """One autoregressive step: logits for the next token; the cache is
        updated in place and returned.

        ``position`` is an int or a 0-d integer tensor on the model's
        device; both take one path, with the position on the device, and
        the step makes no host sync, so a CUDA graph can capture it with
        static ``cache``, ``tokens`` and ``position`` tensors
        (:class:`repro_torch.serving.ServeEngine`)."""
        cfg = self.cfg
        pos = torch.as_tensor(position, device=self.device).to(torch.int32)
        top, layers = self._params()
        x = self._embed_in(top, tokens[:, None], None)
        for bt, bp, lc in zip(self.block_types, layers, self._layer_caches(cache)):
            h = rmsnorm(x, bp["norm1"], cfg.norm_eps)
            if bt == "ssd":
                out, state = ssd_decode_step(bp["ssd"], h, lc, cfg)
                _copy_state(lc, state)
            elif bt == "rglru":
                out, state = rglru_decode_step(bp["rglru"], h, lc, cfg)
                _copy_state(lc, state)
            else:
                out, _ = self._decode_attn(bt, bp["attn"], h, lc, pos)
            x = self._add(x, out)
            if cfg.has_ffn(bt):
                x, _ = self._ffn(bp, x)
        return self._head(top, x)[:, 0], cache

    def prefill(self, tokens: torch.Tensor, max_len: int | None = None) -> tuple[torch.Tensor, dict]:
        """One pass over the prompt filling the cache; returns
        (last-token logits (B,V), cache)."""
        B, S = tokens.shape
        max_len = max_len or S
        assert max_len >= S
        top, layers = self._params()
        x = self._embed_in(top, tokens, None)
        rope = self._rope_for(None, B, S)
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


def _set_path(tree: dict, path: tuple[str, ...], leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


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
    be given, with its exact shape, and nothing else.
    """
    paths = lm._reference_paths()
    want = {path for path, _ in paths.values()}
    given = set(_leaf_paths(params))
    if want != given:
        raise ValueError(f"missing leaves {sorted('/'.join(p) for p in want - given)}, "
                         f"unexpected leaves {sorted('/'.join(p) for p in given - want)}")
    named = dict(lm.named_parameters())
    repeats = Counter(path for path, r in paths.values() if r is not None)
    for name, (path, r) in paths.items():
        leaf = params
        for k in path:
            leaf = leaf[k]
        shape = tuple(named[name].shape) if r is None else (repeats[path], *named[name].shape)
        if tuple(np.shape(leaf)) != shape:
            raise ValueError(f"{'/'.join(path)}: shape {np.shape(leaf)} != {shape}")
    for name, arr in lm.named_from_reference(params).items():
        named[name].copy_(torch.from_numpy(np.asarray(arr).astype(np.float32)))
    return lm


def _leaf_paths(tree, prefix: tuple[str, ...] = ()):
    if not isinstance(tree, dict):
        yield prefix
        return
    for k, v in tree.items():
        yield from _leaf_paths(v, (*prefix, k))


@torch.no_grad()
def params_to_jax(lm: LM) -> dict:
    """The inverse of :func:`params_from_jax`: ``lm``'s parameters as the
    reference ``LM.init`` tree (``stack{i}`` leaves stacked over their
    layers), with numpy leaves.  bfloat16 leaves come back widened to
    float32 (numpy has no bfloat16; the widening is exact, as in the
    reference's checkpoints), the rest in their own dtype."""
    tree = lm.reference_tree(dict(lm.named_parameters()))
    return _map_tree(lambda t: (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy(), tree)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)

"""Token-choice top-k MoE with capacity — in PyTorch.

The port of ``repro.models.moe``: the reference's routing step for step,
and its default formulation (``moe_dispatch="token"``,
``moe_combine="gather"``), whose alternatives compute the same function
(``tests/test_moe_properties.py``).

* Router product in fp32; K rounds of max / first-index argmax over the
  remaining probabilities; a capacity position from a cumulative sum over
  the sequence, per batch row (the group is the batch row); a token is
  kept where its position is below the capacity ``C``, and the kept gates
  are renormalised by ``max(sum, 1e-9)``.
* Dispatch gathers the kept (token, k) rows straight into expert-major
  order ``(E, B*C, D)``: the batch rows are folded into the kernel's
  capacity axis, so nothing is transposed.  Slots that no token fills
  hold zeros (the reference fills them with a clipped token's row); no
  output reads them.  Routing, dispatch and combine make no host sync
  (no boolean-mask indexing), so a CUDA graph captures a decode step.
* The three expert products run through :func:`repro_torch.kernels.moe_gmm`
  (the hand-written CUDA kernel on the card), where the reference has
  ``jnp.einsum``.  They take the routing's per-expert counts (on the
  device), so the kernel skips every tile of slots that no pair filled:
  a decode step reads the weights of the experts its tokens went to.
* Combine gathers each token's K slots back through one zero pad row, so
  dropped tokens contribute zero, and sums them weighted by their gates.
* The Switch/GShard load-balancing aux loss.
* granite-4.0-h's two additions: a shared SwiGLU expert beside the
  routed ones (``cfg.moe_shared_d_ff``), added with weight 1, and dropless
  routing (``cfg.moe_dropless``, :func:`_dropless_capacity`).  Granite
  takes the softmax of the top-k router logits; the softmax over all of
  them renormalised over the top k is the same function.

The port does not shard: the reference's ``constrain`` calls are dropped.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch._device import upcast
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec, mlp, mlp_params

__all__ = ["moe_params", "moe_ffn", "moe_capacity"]


def moe_params(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": ParamSpec((d, e), ("embed", None), "float32", scale=0.1),
        "wi_gate": ParamSpec((e, d, f), ("experts", "embed", "moe_ffn"), cfg.dtype),
        "wi_up": ParamSpec((e, d, f), ("experts", "embed", "moe_ffn"), cfg.dtype),
        "wo": ParamSpec((e, f, d), ("experts", "moe_ffn", "embed"), cfg.dtype),
    }
    if cfg.moe_shared_d_ff:
        p["shared"] = mlp_params(d, cfg.moe_shared_d_ff, "swiglu", cfg.dtype)
    return p


def _pad8(c: int) -> int:
    return max(8, -(-c // 8) * 8)  # pad to sublane multiple


def moe_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    if cfg.moe_dropless:
        # a token sends an expert at most one pair, so no expert can receive
        # more pairs than the group has tokens
        return _pad8(tokens_per_group)
    return _pad8(math.ceil(tokens_per_group * cfg.top_k * cfg.capacity_factor / cfg.n_experts))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` as int32, without its range check (a host
    sync on the CPU)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.int32)


def _route(probs: torch.Tensor, K: int, C: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing with per-expert capacity: (slots, gates), each
    (B, S, K), and counts (B, E) int32, the slots each expert filled in
    each batch row (positions 0 .. count - 1, at most ``C``).  A slot is
    ``expert * C + position`` or -1 (dropped)."""
    B, S, E = probs.shape
    remaining = probs
    counts = torch.zeros((B, E), dtype=torch.int32, device=probs.device)
    slots, gates = [], []
    for _ in range(K):
        gate = remaining.amax(dim=-1)  # (B, S)
        idx = remaining.argmax(dim=-1)  # first index on ties, as jnp.argmax
        oh = _one_hot(idx, E)  # (B, S, E)
        pos = torch.cumsum(oh, dim=1, dtype=torch.int32) - 1 + counts[:, None, :]
        counts = counts + oh.sum(dim=1, dtype=torch.int32)
        my_pos = (pos * oh).sum(dim=-1, dtype=torch.int32)  # (B, S)
        keep = my_pos < C
        slots.append(torch.where(keep, idx.to(torch.int32) * C + my_pos, -1))
        gates.append(torch.where(keep, gate, torch.zeros_like(gate)))
        remaining = remaining * (1 - oh.to(remaining.dtype))
    slots_t = torch.stack(slots, dim=-1)
    gates_t = torch.stack(gates, dim=-1)
    gates_t = gates_t / torch.clamp_min(gates_t.sum(dim=-1, keepdim=True), 1e-9)
    return slots_t, gates_t, torch.clamp_max(counts, C)


def _dropless_capacity(c_idx: torch.Tensor, kept: torch.Tensor, C: int, pairs: int) -> int:
    """The capacity a dropless layer lays its experts out at, and its
    ``moe.routed_pairs`` and ``moe.dropped`` counters.

    Routing at :func:`moe_capacity`'s bound ``C`` keeps every pair.  An
    eager call with more than 8 tokens a group (a prefill) then lays the
    experts out at the power of two, 8 or more, that holds the most pairs
    any one received (at most ``C``): one host read a layer, which also
    counts the pairs dropped.  The few sizes this gives let every prompt
    reuse a layout an earlier one allocated.  A call with at most
    8 (a decode step), or one a CUDA graph is capturing, keeps ``C`` and
    reads nothing.  Counted: ``moe.routed_pairs`` (the pairs kept) and
    ``moe.dropped``; under replay :mod:`repro_torch._graphs` adds the
    counts of the capture.  ``moe.rows_computed`` (the rows the expert
    products run, the padding of the tiles that run included) is the
    products' device tally."""
    dropped = 0
    if C > 8 and not (c_idx.is_cuda and torch.cuda.is_current_stream_capturing()):
        most, dropped = torch.stack([c_idx.amax().long(), (~kept).sum()]).tolist()
        C = min(C, max(8, 1 << most.bit_length()))
    obs.counter("moe.routed_pairs").inc(pairs - dropped)
    obs.counter("moe.dropped").inc(dropped)
    return C


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss).  Group = batch row (standard)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = moe_capacity(cfg, S)

    logits = upcast(x) @ params["router"]  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    slots, gates, counts = _route(probs, K, C)

    # ---- dispatch: rows of (x | zero pad row) gathered in (E, B, C) order --
    kept = slots >= 0
    e_idx, c_idx = torch.div(slots, C, rounding_mode="floor"), slots % C
    tally = None
    if cfg.moe_dropless:
        C = _dropless_capacity(c_idx, kept, C, B * S * K)
        tally = obs.device_tally("moe.rows_computed", x.device)
    b_idx = torch.arange(B, device=x.device)[:, None, None].expand(B, S, K)
    s_idx = torch.arange(S, device=x.device)[None, :, None].expand(B, S, K)
    dst = (e_idx * B + b_idx) * C + c_idx  # row of (E, B*C); every kept one is unique
    # every (b, s, k) is scattered, a dropped one onto a spare last row that
    # is cut off: no mask selects, so nothing waits on the host
    spare = E * B * C
    src_for_slot = torch.full((spare + 1,), B * S, dtype=torch.int64, device=x.device).scatter(
        0, torch.where(kept, dst, spare).reshape(-1), (b_idx * S + s_idx).reshape(-1)
    )
    xpad = torch.cat([x.reshape(B * S, D), x.new_zeros((1, D))])
    dispatched = xpad[src_for_slot[:spare]].reshape(E, B * C, D)

    # ---- expert computation (the only FLOP-heavy part) -------------------
    # only the tiles that hold a pair run; the first product counts them
    g = moe_gmm(dispatched, params["wi_gate"], counts, tally=tally)
    u = moe_gmm(dispatched, params["wi_up"], counts)
    h = F.silu(g) * u
    eo = moe_gmm(h, params["wo"], counts).reshape(E * B * C, D)

    # ---- combine: each token's K slots back through one zero pad row -------
    eo_pad = torch.cat([eo, eo.new_zeros((1, D))])
    gather = torch.where(kept, dst, spare)  # (B, S, K)
    tok_out = eo_pad[gather]  # (B, S, K, D)
    y = torch.sum(tok_out * gates[..., None].to(tok_out.dtype), dim=2).to(x.dtype)
    if "shared" in params:
        y = y + mlp(params["shared"], x, "swiglu")

    # ---- load-balancing aux loss (Switch/GShard) --------------------------
    me = probs.mean(dim=(0, 1))  # (E,)
    ce = _one_hot(logits.argmax(dim=-1), E).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)
    return y, aux

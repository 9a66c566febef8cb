"""Train step construction: loss and gradients + AdamW — in PyTorch.

The port of ``repro.training.train_loop``.  :func:`make_train_step`
returns a function ``(opt_state, batch) -> (opt_state, metrics)`` that
updates the model's parameters in place (the reference's step is pure and
returns new params; the port's module owns its parameters).  It turns the
model's parameters' ``requires_grad`` on.  Options:

* ``accum_steps`` — the batch split into microbatches along its leading
  axis; each one's gradients are summed into fp32 buffers, as the
  reference's ``lax.scan`` sums them into fp32 zeros, then divided (the
  parameters' ``.grad`` would sum in their own dtype, bf16).
* ``compress_grads`` — int8 quantization then dequantization of the
  gradient tree (:mod:`repro_torch.distributed.compression`) before the
  optimizer, as the reference applies it: one scale per leaf of the
  reference's stacked tree, shared by every layer of a stack.

:class:`TrainState` and the helpers :func:`state_tree`, :func:`state_like`
and :func:`load_state_tree` carry the parameters and the optimizer state
to and from the reference's checkpoint tree ``{"params", "opt"}``, in its
stacked layout (``LM.reference_tree``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.distributed.compression import dequantize_tree, quantize_tree
from repro_torch.models.transformer import LM

from .optimizer import OptConfig, adamw_update

__all__ = ["TrainState", "make_train_step", "state_tree", "state_like", "load_state_tree"]


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    for k, x in batch.items():
        assert x.shape[0] % n == 0, f"batch {x.shape[0]} % accum {n} ({k})"
    return [{k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i] for k, x in batch.items()} for i in range(n)]


def make_train_step(
    model: LM,
    opt_cfg: OptConfig,
    *,
    accum_steps: int = 1,
    compress_grads: bool = False,
) -> Callable:
    """``step(opt_state, batch) -> (opt_state, metrics)`` for ``model``, with
    ``opt_state`` from ``adamw_init(dict(model.named_parameters()))``;
    metrics ``{"loss", "grad_norm", "lr"}`` as 0-d tensors."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def grads_of(batch):
        loss = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        return loss.detach(), dict(zip(params, grads))

    def train_step(opt_state, batch):
        if accum_steps > 1:
            acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()}
            loss_sum = torch.zeros((), dtype=torch.float32, device=next(iter(params.values())).device)
            for mb in _split_microbatches(batch, accum_steps):
                loss, g = grads_of(mb)
                for k, gk in g.items():
                    if gk is not None:
                        acc[k] += gk
                loss_sum += loss
            grads = {k: a / accum_steps for k, a in acc.items()}
            loss = loss_sum / accum_steps
        else:
            loss, grads = grads_of(batch)

        if compress_grads:
            # one scale per leaf of the reference's stacked tree: every
            # repeat of a stack's parameter shares it, as in the reference
            grads = {k: torch.zeros_like(p, dtype=torch.float32) if g is None else g for (k, g), p in
                     zip(grads.items(), params.values())}
            grads = model.named_from_reference(dequantize_tree(quantize_tree(model.reference_tree(grads))))

        metrics = adamw_update(grads, opt_state, params, opt_cfg)
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step


def state_tree(model: LM, opt_state: dict) -> dict:
    """The reference's checkpoint tree ``{"params", "opt": {"m", "v",
    "master", "step"}}`` of ``model``'s parameters and ``opt_state``, each
    per-parameter tree restacked into the reference's layout."""
    params = {k: p.detach() for k, p in model.named_parameters()}
    return {
        "params": model.reference_tree(params),
        "opt": {
            "m": model.reference_tree(opt_state["m"]),
            "v": model.reference_tree(opt_state["v"]),
            "master": model.reference_tree(opt_state["master"]),
            "step": opt_state["step"],
        },
    }


def state_like(model: LM) -> dict:
    """The shapes and dtypes of :func:`state_tree` (meta tensors: no memory),
    the ``like`` a restore reads a checkpoint into."""
    meta = {k: torch.empty(p.shape, dtype=p.dtype, device="meta") for k, p in model.named_parameters()}
    f32 = {k: torch.empty(p.shape, dtype=torch.float32, device="meta") for k, p in model.named_parameters()}
    tree = model.reference_tree(f32)
    return {
        "params": model.reference_tree(meta),
        "opt": {"m": tree, "v": tree, "master": tree, "step": torch.empty((), dtype=torch.int32, device="meta")},
    }


@torch.no_grad()
def load_state_tree(model: LM, opt_state: dict, tree: dict) -> None:
    """Copy a restored :func:`state_tree` into ``model``'s parameters and
    ``opt_state``, in place."""
    for k, v in model.named_from_reference(tree["params"]).items():
        model.get_parameter(k).copy_(v)
    for part in ("m", "v", "master"):
        for k, v in model.named_from_reference(tree["opt"][part]).items():
            opt_state[part][k].copy_(v)
    opt_state["step"].copy_(tree["opt"]["step"])

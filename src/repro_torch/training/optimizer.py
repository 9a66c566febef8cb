"""AdamW with fp32 master weights and bf16 compute params — in PyTorch.

The port of ``repro.training.optimizer``: the reference's schedule
(:func:`lr_at`, linear warm-up then cosine to ``min_lr_ratio``), its
global-norm clipping and its update, in its order, in plain torch ops
(the reference's AdamW is plain jnp, not a kernel; ``torch.optim.AdamW``
keeps no master weights and does not clip in this order).

* A tree of parameters is a dict (nested or flat) of tensors; the
  optimizer state is the reference's ``{"m", "v", "master", "step"}``, m,
  v and the master weights fp32 trees parallel to the parameters, ``step``
  a 0-d int32 tensor on the parameters' device.
* The step, learning rate, clipping scale and both bias corrections are
  0-d fp32 tensors on the device: nothing waits on the host.
* :func:`adamw_update` updates in place, leaf by leaf: the moments, the
  master weight, then the parameter (the master cast to its dtype).  The
  reference returns new arrays (its train step donates the old ones); here
  the largest transient is one leaf's fp32 temporaries.  A gradient of
  None (a parameter the loss does not reach) counts as zeros, as the
  reference's zero cotangent does: weight decay still moves it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = ["OptConfig", "adamw_init", "adamw_update", "lr_at", "global_norm"]


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _leaves(tree) -> list:
    """The leaves of a tree of dicts, in key order at every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in fp32."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params) -> dict:
    """Zero fp32 moments and fp32 master copies (new tensors, never views of
    an fp32 parameter) of a tree of parameters; step 0."""
    leaves = _leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {
        "m": _map(zeros, params),
        "v": _map(zeros, params),
        "master": _map(lambda p: p.detach().to(torch.float32, copy=True), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (None counts as zeros), fp32."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32) for g in _leaves(tree) if g is not None]
    if not norms:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(torch.sum(torch.stack(norms) ** 2))


@torch.no_grad()
def adamw_update(grads, opt_state: dict, params, cfg: OptConfig) -> dict:
    """One AdamW step, in place on ``params`` and ``opt_state`` (trees of the
    same structure; ``grads`` may hold None).  Returns the metrics
    ``{"grad_norm", "lr"}`` as 0-d tensors."""
    opt_state["step"] += 1
    step = opt_state["step"].float()
    gnorm = global_norm(grads).to(step.device)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = lr_at(cfg, step)
    b1c = 1 - torch.full((), cfg.b1, dtype=torch.float32, device=step.device) ** step
    b2c = 1 - torch.full((), cfg.b2, dtype=torch.float32, device=step.device) ** step
    for g, m, v, master, p in zip(
        _leaves(grads), _leaves(opt_state["m"]), _leaves(opt_state["v"]), _leaves(opt_state["master"]),
        _leaves(params),
    ):
        g = torch.zeros_like(m) if g is None else g.float() * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * master
        master.sub_(lr * update)
        p.copy_(master)
    return {"grad_norm": gnorm, "lr": lr}

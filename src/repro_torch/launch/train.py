"""End-to-end training driver.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_1_3b --smoke \
      --steps 6 --device cpu

The port of ``repro.launch.train``, with the same flags plus ``--device``
(default: the CUDA card; there is no fallback to the CPU): data pipeline
-> train step (loss, gradients through the kernels' backwards, optional
int8 gradient compression, AdamW with fp32 master weights) -> metrics ->
periodic atomic checkpoints in the reference's format -> preemption-safe
shutdown -> resume-on-restart, with the same log lines and the same
returned dict (``final_step``, ``first_loss``, ``final_loss``).

Weights are drawn from a ``torch.Generator`` on the device seeded
``--seed``; batches come from the reference's pipeline (numpy, the same
batches for the same seed and step) and are moved to the device, token
ids as int64.  ``main`` also takes a ``PreemptionGuard`` (to stop a run
from outside, as a cluster manager's signal would) and an ``on_step``
callback called after every step with ``(step, metrics)``.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, get_smoke
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.models import LM
from repro_torch.training import OptConfig, make_train_step
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.fault_tolerance import PreemptionGuard
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_loop import load_state_tree, state_like, state_tree


def to_device(batch: dict, device: torch.device) -> dict:
    """A pipeline batch (numpy) on ``device``: integer arrays (token ids,
    labels) as int64 for indexing, the rest as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def main(
    argv=None, *, guard: PreemptionGuard | None = None, on_step: Callable[[int, dict], None] | None = None
) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    model = LM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(args.seed))
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1), total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg, accum_steps=args.accum, compress_grads=args.compress_grads)

    opt_state = adamw_init(dict(model.named_parameters()))
    start_step = 0

    ckpt = CheckpointManager(args.ckpt_dir, keep=2, async_save=False) if args.ckpt_dir else None
    if ckpt is not None:
        got = ckpt.restore_latest(state_like(model), device=dev)
        if got[0] is not None:
            start_step = got[0]
            load_state_tree(model, opt_state, got[1])
            print(f"[train] resumed from step {start_step}")

    data = SyntheticTokenPipeline(
        DataConfig(
            vocab=cfg.vocab,
            seq_len=args.seq,
            global_batch=args.batch,
            seed=args.seed,
            embeds_dim=cfg.d_model if cfg.frontend_stub else 0,
        )
    ).start(from_step=start_step)

    own_guard = guard is None
    guard = PreemptionGuard() if own_guard else guard
    losses = []
    t0 = time.time()
    step = start_step
    try:
        while step < args.steps:
            if guard.should_stop:
                print(f"[train] preemption signal at step {step}: checkpoint + clean exit")
                if ckpt is not None:
                    ckpt.save(step, state_tree(model, opt_state))
                break
            _, batch = data.next()
            opt_state, metrics = step_fn(opt_state, to_device(batch, dev))
            step += 1
            losses.append(float(metrics["loss"]))
            if on_step is not None:
                on_step(step, metrics)
            if step % args.log_every == 0:
                dt = (time.time() - t0) / max(step - start_step, 1)
                print(
                    f"[train] step {step:5d} loss {losses[-1]:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} lr {float(metrics['lr']):.2e} "
                    f"{dt*1e3:.0f} ms/step",
                    flush=True,
                )
            if ckpt is not None and step % args.ckpt_every == 0:
                ckpt.save(step, state_tree(model, opt_state))
    finally:
        data.stop()
        if own_guard:
            guard.restore()

    result = {
        "final_step": step,
        "first_loss": losses[0] if losses else None,
        "final_loss": float(np.mean(losses[-5:])) if losses else None,
    }
    print(f"[train] done: {result}")
    return result


if __name__ == "__main__":
    main()

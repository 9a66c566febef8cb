"""Serving entry point: batched requests through the ServeEngine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_3b --smoke \
      --device cpu --requests 6 --max-new 12

The port of ``repro.launch.serve``, with the same flags plus ``--device``
(default: the CUDA card; there is no fallback to the CPU).  Weights are
drawn from a ``torch.Generator`` on the device, seeded 0; prompts from
``np.random.default_rng(0)``, as in the reference.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, get_smoke
from repro_torch.models import LM
from repro_torch.serving import Request, ServeEngine

MAX_LEN = 256


def build_engine(cfg, device=None, *, slots: int = 4, eager: bool = False) -> ServeEngine:
    """The LM of ``cfg`` on ``device`` (weights from a generator seeded 0)
    inside a ``ServeEngine`` with ``max_len=256``; ``eager`` as the
    engine's (decode op by op instead of by graph replay on the card)."""
    assert cfg.decoder, f"{cfg.name} is encoder-only; nothing to decode"
    dev = resolve_device(device)
    model = LM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    return ServeEngine(model, batch_slots=slots, max_len=MAX_LEN, eager=eager)


def submit_requests(eng: ServeEngine, cfg, n: int, max_new: int, temperature: float = 0.0) -> None:
    """``n`` requests with prompt lengths in [4, 24) and random tokens."""
    rng = np.random.default_rng(0)
    for i in range(n):
        plen = int(rng.integers(4, 24))
        eng.submit(
            Request(
                rid=i,
                prompt=rng.integers(0, cfg.vocab, plen).astype(np.int32),
                max_new_tokens=max_new,
                temperature=temperature,
            )
        )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--eager", action="store_true", help="decode op by op, not by CUDA graph replay")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    eng = build_engine(cfg, args.device, slots=args.slots, eager=args.eager)

    t0 = time.time()
    submit_requests(eng, cfg, args.requests, args.max_new, args.temperature)
    done = eng.run()
    dt = time.time() - t0
    total_new = sum(len(r.out_tokens) for r in done)
    for r in done:
        print(f"[serve] rid={r.rid} prompt_len={len(r.prompt)} out={r.out_tokens}")
    print(f"[serve] {len(done)} requests, {total_new} tokens in {dt:.2f}s ({total_new/dt:.1f} tok/s)")
    return done


if __name__ == "__main__":
    main()

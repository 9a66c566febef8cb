"""Deterministic, shardable, prefetching token pipeline.

Design constraints from 1000-node training:

* **determinism across restarts** — batch contents are a pure function
  of (seed, step, host_shard): resuming from step N replays exactly the
  data the crashed run would have seen (no sample skew after failover).
* **host sharding** — each host materializes only its slice of the
  global batch (``host_index`` / ``host_count``).
* **prefetch** — a daemon thread keeps ``prefetch`` batches ready so
  the accelerator never waits on the host (overlap of input pipeline
  with compute).

The generator is synthetic (structured pseudo-text: Zipfian tokens with
local repetition so losses are learnable); swapping in a real tokenized
corpus only replaces ``_gen_batch``.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

__all__ = ["DataConfig", "SyntheticTokenPipeline"]


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    prefetch: int = 2
    embeds_dim: int = 0  # >0: emit frame/patch embeddings (stub frontends)


class SyntheticTokenPipeline:
    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.host_count == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.host_count
        self._q: queue.Queue = queue.Queue(maxsize=max(cfg.prefetch, 1))
        self._step = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- deterministic generation ---------------------------------------
    def _gen_batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_index])
        )
        B, S, V = self.local_batch, cfg.seq_len, cfg.vocab
        # zipfian marginals + local repetition: learnable structure
        base = rng.zipf(1.3, size=(B, S)).astype(np.int64) % V
        rep = rng.random((B, S)) < 0.3
        shifted = np.roll(base, 1, axis=1)
        tokens = np.where(rep, shifted, base).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        batch = {"tokens": tokens, "labels": labels}
        if cfg.embeds_dim:
            emb = rng.standard_normal((B, S, cfg.embeds_dim), dtype=np.float32)
            batch = {"embeds": emb, "labels": labels % V}
        return batch

    # -- prefetch machinery ----------------------------------------------
    def start(self, from_step: int = 0) -> "SyntheticTokenPipeline":
        self._step = from_step
        self._stop.clear()

        def worker():
            s = self._step
            while not self._stop.is_set():
                try:
                    self._q.put(( s, self._gen_batch(s)), timeout=0.1)
                    s += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        return self

    def next(self) -> tuple[int, dict]:
        if self._thread is None:
            b = self._gen_batch(self._step)
            self._step += 1
            return self._step - 1, b
        return self._q.get()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None

    def batch_at(self, step: int) -> dict:
        """Random access (determinism tests / replay)."""
        return self._gen_batch(step)

"""Batched serving engine: slot-based continuous batching (lite) — in PyTorch.

The port of ``repro.serving.engine``, behaviour for behaviour:

* Requests queue up; the engine packs up to ``batch_slots`` prompts,
  left-pads them with token 0 (no pad mask) to a common prefill length,
  prefills once, then decodes all slots in lock-step with per-slot stop
  handling.
* Finished slots are refilled from the queue between decode steps: a new
  request re-prefills as a single row, left-padded to the lock-step
  position, and is merged into its row of the shared cache by
  ``model.cache_axes()``.  A queued prompt longer than the current
  position parks in ``_pending`` and opens the next batch instead.
* A request that hits ``max_len`` before ``max_new_tokens`` is returned
  with ``truncated=True`` and a :class:`TruncationWarning`.
* Greedy or temperature sampling on the host, from
  ``np.random.default_rng(rng_seed)``, so sampled runs draw the
  reference's numbers.

The model is a :class:`repro_torch.models.LM`, which holds its own
parameters and device (the card unless it was built with
``device="cpu"``).  The engine runs under ``torch.inference_mode()``;
the cache is updated in place.

Decode is the reference's compiled step (``jax.jit(model.decode_step)``,
called with ``jnp.int32(pos)``).  On a CUDA model each lock-step decode
is one replay of a CUDA graph, captured at first use per (batch rows,
``max_len``) over static token, position, cache and logits tensors
(:mod:`repro_torch._graphs`): the batch prefill's cache is copied into
the static cache, refills merge rows into it in place, and the logits
are sampled after each replay, before the next.  Prefill and refills run
eagerly.  A step that cannot be captured raises; nothing falls back.  A
CPU model, or ``eager=True``, runs ``decode_step`` op by op.

With the tracer on (:mod:`repro_torch.obs`) a batch's prefill records the
span ``serve.prefill`` (the prefill, its copy into the decode graph's
cache and the first token's sampling) and each lock-step decode
``serve.decode_step`` (a replay or eager step, and its sampling); both end
with the logits in host memory.  A request built with ``logits=[]`` gets
the host logits each of its tokens was sampled from.
"""

from __future__ import annotations

import queue
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import obs
from repro_torch._graphs import CapturedGraph, capture
from repro_torch.models import LM
from repro_torch.obs.log import MatchWarning
from repro_torch.obs.log import warn as obs_warn

__all__ = ["Request", "ServeEngine", "TruncationWarning"]


class TruncationWarning(MatchWarning):
    """A request ran out of cache headroom (``pos >= max_len``) before
    producing ``max_new_tokens``; its ``truncated`` flag is set."""


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    out_tokens: list[int] = field(default_factory=list)
    done: bool = False
    truncated: bool = False
    # a list: the engine appends the float32 host logits (V,) each token was sampled from
    logits: list | None = None


def _leaves(tree) -> list:
    """Leaves of a nested dict in sorted key order (the reference's
    pytree order); tuples are leaves."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


@dataclass
class _DecodeGraph:
    """One captured decode step and the static tensors it replays over."""

    tokens: torch.Tensor  # (B,) int64
    position: torch.Tensor  # 0-d int32
    cache: dict
    step: CapturedGraph  # its output: the logits (B, V)


class ServeEngine:
    """Slot-refill serving of ``model``.

    ``eager=True`` runs every decode step op by op, as the reference runs
    under ``jax.disable_jit()``: the comparison the graph is held to.  By
    default a CUDA model decodes by graph replay; a CPU model always runs
    eagerly.
    """

    def __init__(
        self,
        model: LM,
        *,
        batch_slots: int = 4,
        max_len: int = 256,
        rng_seed: int = 0,
        eager: bool = False,
    ):
        self.model = model
        self.batch_slots = batch_slots
        self.max_len = max_len
        self.rng = np.random.default_rng(rng_seed)
        self.eager = eager or model.device.type != "cuda"
        self._graphs: dict[tuple[int, int], _DecodeGraph] = {}
        self._queue: "queue.Queue[Request]" = queue.Queue()
        self._pending: list[Request] = []  # popped but not yet slotted
        # serving counters: decode iterations paid and slots recycled
        self.decode_steps = 0
        self.refills = 0

    def submit(self, req: Request) -> None:
        self._queue.put(req)

    def _pop(self) -> Request | None:
        """One queued request, or None — never empty()-then-get(): with
        concurrent submitters the queue can drain between the two calls,
        and get() would then block forever."""
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            return None

    def _take_batch(self) -> list[Request]:
        out = self._pending[: self.batch_slots]
        del self._pending[: len(out)]
        while len(out) < self.batch_slots:
            r = self._pop()
            if r is None:
                break
            out.append(r)
        return out

    def _next_fitting(self, pos: int) -> Request | None:
        """A waiting request whose prompt fits the lock-step position
        (left-padded to width ``pos``); longer prompts park in
        ``_pending`` for the next batch."""
        for j, r in enumerate(self._pending):
            if len(r.prompt) <= pos:
                return self._pending.pop(j)
        while True:
            r = self._pop()
            if r is None:
                return None
            if len(r.prompt) <= pos:
                return r
            self._pending.append(r)

    def run(self) -> list[Request]:
        """Serve everything currently queued; returns finished requests."""
        finished: list[Request] = []
        with torch.inference_mode():
            while True:
                batch = self._take_batch()
                if not batch:
                    return finished
                finished.extend(self._serve_batch(batch))

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(toks, np.int64)).to(self.model.device)

    # -- the compiled decode step ----------------------------------------
    @property
    def capture_ms(self) -> dict[tuple[int, int], float]:
        """Host ms each captured decode graph took (warm-up included), by
        (batch rows, ``max_len``)."""
        return {key: g.step.capture_ms for key, g in self._graphs.items()}

    def capture(self, rows: int) -> None:
        """Capture the decode graph of ``rows`` batch rows now, not at its
        first use; nothing on an eager engine."""
        if not self.eager:
            self._graph_for(rows)

    def _graph_for(self, rows: int) -> _DecodeGraph:
        """The decode graph of ``rows`` batch rows, captured at first use
        on a zero cache (its warm-up step writes nothing that the prefill's
        copy does not overwrite)."""
        key = (rows, self.max_len)
        g = self._graphs.get(key)
        if g is None:
            dev = self.model.device
            tokens = torch.zeros(rows, dtype=torch.int64, device=dev)
            position = torch.zeros((), dtype=torch.int32, device=dev)
            cache = self.model.init_cache(rows, self.max_len)
            step = capture(lambda: self.model.decode_step(cache, tokens, position)[0], dev)
            g = self._graphs[key] = _DecodeGraph(tokens, position, cache, step)
        return g

    def _decode_cache(self, cache, rows: int):
        """The cache the decode steps use: the prefill's own when eager,
        else the static cache of the graph for ``rows`` batch rows with the
        prefill's copied in."""
        if self.eager:
            return cache
        g = self._graph_for(rows)
        for dst, src in zip(_leaves(g.cache), _leaves(cache)):
            dst.copy_(src)
        return g.cache

    def _decode(self, cache, cur: np.ndarray, pos: int) -> torch.Tensor:
        """One lock-step decode at position ``pos``; returns the logits
        (B, V), which the next call overwrites when decoding by graph."""
        if self.eager:
            logits, _ = self.model.decode_step(cache, self._tokens(cur), pos)
            return logits
        g = self._graphs[(len(cur), self.max_len)]
        if cache is not g.cache:
            raise RuntimeError("decode by graph replay needs the graph's static cache")
        g.tokens.copy_(torch.from_numpy(np.ascontiguousarray(cur, np.int64)))
        g.position.fill_(pos)
        return g.step.replay()

    # -- single-row prefill path (slot refill) --------------------------
    def _merge_row(self, cache, row_cache, i: int):
        """Write ``row_cache`` (batch 1) into row ``i`` of the shared
        cache, in place.  Batch rows are independent everywhere except the
        position-count leaves, which carry no batch axis and agree by
        construction (both covers span positions ``0..pos-1``)."""
        axes = self.model.cache_axes()
        for leaf, row_leaf, ax in zip(_leaves(cache), _leaves(row_cache), _leaves(axes)):
            if "batch" in ax:
                b = ax.index("batch")
                leaf[(slice(None),) * b + (i,)] = row_leaf.select(b, 0)
        return cache

    def _refill_slot(self, req: Request, i: int, pos: int, cache):
        """Prefill ``req`` as a single row (left-padded to the lock-step
        width ``pos``), splice it into slot ``i``, and return its first
        sampled token plus the updated cache."""
        row = np.zeros((1, pos), np.int32)
        row[0, pos - len(req.prompt) :] = req.prompt
        logits, row_cache = self.model.prefill(self._tokens(row), max_len=self.max_len)
        cache = self._merge_row(cache, row_cache, i)
        tok = int(self._sample(logits, [req])[0])
        self.refills += 1
        return tok, cache

    def _serve_batch(self, reqs: list[Request]) -> list[Request]:
        B = len(reqs)
        plen = max(len(r.prompt) for r in reqs)
        # left-pad with token 0; positions still 0..plen-1 (pad tokens
        # attend causally; there is no pad mask, as in the reference)
        toks = np.zeros((B, plen), np.int32)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt) :] = r.prompt

        slots = list(reqs)
        with obs.span("serve.prefill", cat="serve", rows=B, tokens=plen):
            logits, cache = self.model.prefill(self._tokens(toks), max_len=self.max_len)
            cache = self._decode_cache(cache, B)
            cur = self._sample(logits, slots)
        pos = plen
        live = [True] * B
        served: list[Request] = []
        for i, r in enumerate(slots):
            r.out_tokens.append(int(cur[i]))

        while True:
            # retire finished slots and refill them from the queue before
            # paying the next lock-step decode; fixpoint, because a
            # refilled request can itself already be satisfied
            changed = True
            while changed:
                changed = False
                for i, r in enumerate(slots):
                    if live[i] and len(r.out_tokens) >= r.max_new_tokens:
                        live[i] = False
                        r.done = True
                        served.append(r)
                        changed = True
                        if pos < self.max_len:
                            nxt = self._next_fitting(pos)
                            if nxt is not None:
                                tok, cache = self._refill_slot(nxt, i, pos, cache)
                                slots[i] = nxt
                                live[i] = True
                                cur[i] = tok
                                nxt.out_tokens.append(tok)
            if not any(live):
                return served
            if pos >= self.max_len:
                trunc = [slots[i].rid for i in range(B) if live[i]]
                for i in range(B):
                    if live[i]:
                        slots[i].truncated = True
                        slots[i].done = True
                        served.append(slots[i])
                obs_warn(
                    f"requests {trunc} hit max_len={self.max_len} at "
                    f"position {pos} before max_new_tokens; returned "
                    "truncated (raise max_len or shorten prompts)",
                    TruncationWarning,
                )
                return served
            with obs.span("serve.decode_step", cat="serve"):
                logits = self._decode(cache, cur, pos)
                cur = self._sample(logits, slots)
            self.decode_steps += 1
            pos += 1
            for i, r in enumerate(slots):
                if live[i] and len(r.out_tokens) < r.max_new_tokens:
                    r.out_tokens.append(int(cur[i]))

    def _sample(self, logits: torch.Tensor, reqs: list[Request]) -> np.ndarray:
        lg = logits.float().cpu().numpy()
        out = np.zeros(len(reqs), np.int32)
        for i, r in enumerate(reqs):
            if r.logits is not None and not r.done and len(r.out_tokens) < r.max_new_tokens:
                r.logits.append(lg[i])  # a row that gives the request a token
            if r.temperature <= 0:
                out[i] = int(np.argmax(lg[i]))
            else:
                p = lg[i] / r.temperature
                p = np.exp(p - p.max())
                p /= p.sum()
                out[i] = int(self.rng.choice(len(p), p=p))
        return out

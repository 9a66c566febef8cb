"""Cross-request batch packing: fold the request slots into the batch axis.

The port of ``repro.serve.batching``.  The reference serves ``B``
concurrent users by stacking their inputs along a leading *slot* axis and
``jax.vmap``-ing every segment executor over it.  The port has no vmap
over its executors; it folds the slot axis into the batch axis instead.
Every graph input is ``(1, ...)``, so a stacked operand ``(B, n, ...)``
becomes ``(B·n, ...)`` for the segment and its output is unfolded back to
``(B, ...)`` after it.

This is sound because every op of the segment executors treats axis 0 as
independent rows: :func:`repro_torch.cnn.execute.apply_node` (convs,
pools and the ``dense`` flatten ``x.reshape(x.shape[0], -1)`` act per
row, elementwise ops broadcast over trailing axes, ``concat`` joins the
last axis), the banded conv (bands split OY, never N), the fused conv
route (one block row of its grid per batch row), and the GEMM route
(``a8 = x.reshape(x.shape[0], -1)``), where the rows become the GEMM's M:
``matmul_requant`` runs at M = B.  Per-request outputs therefore stay
bit-exact with ``CompiledModel.run`` one request at a time (held by
tests/test_torch_serve.py and, on the card, by tests/test_torch_cuda.py's
``test_sixteen_slot_server_bit_exact_on_card``).

Two execution surfaces, as in the reference:

* :meth:`BatchedModel.batched_segments` — folding per-segment executors
  (same ``LoweredSegment`` dataclass, folding ``fn``), which a batched
  :class:`~repro_torch.pipeline.runtime.PipelinedModel` runs;
* :meth:`BatchedModel.run_batch` — the whole batched graph as ONE CUDA
  graph per batch shape: a :class:`~repro_torch.backend.aot.AotModel` over
  a clone whose segments are the folding ones, one capture per (params
  identity, stacked input signature), so a steady-state replica pays one
  replay per batch of users.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import TYPE_CHECKING, Callable, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import to_tensor

if TYPE_CHECKING:  # repro_torch.backend stays import-light; duck-typed at runtime
    from repro_torch.backend.lower import LoweredSegment
    from repro_torch.backend.runtime import CompiledModel

__all__ = ["BatchedModel"]


def _folded(fn: Callable) -> Callable:
    """``fn`` over ``(B, n, ...)``-stacked operands: each folded to
    ``(B·n, ...)``, the output unfolded to ``(B, rows // B, ...)``."""

    def run(seg_params: dict, *xs):
        b = xs[0].shape[0]
        out = fn(seg_params, *[x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]) for x in xs])
        return out.reshape(b, out.shape[0] // b, *out.shape[1:])

    return run


class BatchedModel:
    """A CompiledModel's executors folded over a request-slot axis."""

    def __init__(self, compiled: "CompiledModel"):
        self.compiled = compiled
        self._batched_segments: list["LoweredSegment"] | None = None
        self._aot = None  # the AotModel over the folded clone, built on first use
        # (params id, input signature) -> (params ref, AotEntry, stats row);
        # the strong params ref keeps id() stable, as in the AotModel
        self._entries: dict[tuple, tuple[dict, object, dict]] = {}
        self._lock = threading.Lock()

    @property
    def graph(self):
        return self.compiled.graph

    @property
    def device(self) -> torch.device:
        return self.compiled.device

    # -- folding per-segment executors ------------------------------------
    def batched_segments(self) -> list["LoweredSegment"]:
        """Per-segment executors accepting ``(B, ...)``-stacked operands.

        Params stay unbatched: every slot shares the one model, exactly
        like rows of a serving batch share weights.
        """
        if self._batched_segments is None:
            self._batched_segments = [
                dataclasses.replace(ls, fn=_folded(ls.fn)) for ls in self.compiled.segments
            ]
        return self._batched_segments

    def batched_compiled(self) -> "CompiledModel":
        """A shallow clone of the compiled model whose segments are the
        folding ones: the same mapping, memory plan and device."""
        return dataclasses.replace(
            self.compiled, segments=self.batched_segments(), _aot=None, _last_timings=[]
        )

    # -- stacking -------------------------------------------------------
    def stack(self, inputs_list: Sequence[dict]) -> dict:
        """Stack per-request input dicts along a new leading slot axis, on
        the model's device (host data in one copy per input name)."""
        if not inputs_list:
            raise ValueError("cannot stack an empty batch")
        dev = self.device
        out = {}
        for k in self.graph.inputs:
            vals = [x[k] for x in inputs_list]
            if any(isinstance(v, torch.Tensor) for v in vals):
                out[k] = torch.stack([to_tensor(v, dev) for v in vals])
            else:
                out[k] = to_tensor(np.stack([np.asarray(v) for v in vals]), dev)
        return out

    @staticmethod
    def unstack(outputs: dict, n: int) -> list[dict]:
        """Split stacked graph outputs back into per-request dicts: row
        ``i`` of every output, a view (no copy, no launch)."""
        return [{k: v[i] for k, v in outputs.items()} for i in range(n)]

    # -- one captured graph per batch shape ------------------------------
    @staticmethod
    def _signature(stacked: dict) -> tuple:
        return tuple(
            (k, tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in sorted(stacked.items())
        )

    def entry(self, params: dict, stacked: dict):
        """The captured whole-batched-graph entry (an
        :class:`~repro_torch.backend.aot.AotEntry`) for this ``(params,
        batch shape)`` signature, captured on first use."""
        sig = (id(params), self._signature(stacked))
        with self._lock:
            hit = self._entries.get(sig)
            if hit is not None and hit[0] is params:
                obs.counter("serve.entry_hits").inc()
                return hit[1]
            if self._aot is None:
                from repro_torch.backend.aot import AotModel

                self._aot = AotModel(self.batched_compiled())
        entry = self._aot.warmup(params, stacked)
        obs.counter("serve.entry_misses").inc()
        row = {
            "batch": int(next(iter(stacked.values())).shape[0]),
            "signature": [list(map(str, s)) for s in sig[1]],
            # the warm-up (params conversion and the eager shape pass), the
            # counterpart of tracing; the capture, None on the CPU
            "trace_us": entry.trace_us,
            "compile_us": entry.compile_us,
        }
        with self._lock:
            self._entries[sig] = (params, entry, row)
        return entry

    def run_batch(self, params: dict, inputs_list: Sequence[dict]) -> list[dict]:
        """Serve ``inputs_list`` as one packed batch (one replay); returns
        per-request output dicts, row ``i`` bit-exact with
        ``CompiledModel.run(params, inputs_list[i])``."""
        return self.unstack(self.run_batch_async(params, inputs_list), len(inputs_list))

    def run_batch_async(self, params: dict, inputs_list: Sequence[dict]) -> dict:
        """Launch a packed batch without waiting: returns the stacked
        output dict, copies that no later batch overwrites, still being
        computed on the current stream — the server's in-flight window
        waits on them in completion order."""
        stacked = self.stack(inputs_list)
        self.entry(params, stacked)
        return self._aot.run(params, stacked)

    def entry_stats(self) -> list[dict]:
        """JSON-safe warm-up/capture cost per batch entry."""
        with self._lock:
            return [dict(row) for (_, _, row) in self._entries.values()]

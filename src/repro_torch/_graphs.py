"""Capture a fixed sequence of launches in one CUDA graph, and replay it.

The port's counterpart of the reference's compiled entry points: where
the JAX package hands a whole decode step (``jax.jit(decode_step)``) or a
whole lowered CNN (``backend.aot.AotModel``) to XLA as one program, the
port records the same launches once into a ``torch.cuda.CUDAGraph`` and
replays them with one host call.  A graph reads and writes fixed
addresses, so its callers keep static input, state and output tensors
and copy new data into them between replays.

:func:`capture`

* runs the callable once (``warmup``) on a side stream first, as
  ``torch.cuda.graphs`` requires: that loads every kernel's library and
  lets cuBLAS and cuDNN pick their algorithms outside the capture;
* records, during the capture, how far each kernel wrapper's
  ``launches`` counter moved (the six port kernels of
  :data:`COUNTED`), and each :mod:`repro_torch.obs` counter that moved,
  then puts every counter back where it stood before the warm-up
  (:func:`uncounted`): a capture launches nothing that a user asked for;
* returns a :class:`CapturedGraph` whose :meth:`~CapturedGraph.replay`
  adds those increases back, so the counters stay exact under replay;
* keeps Python's cyclic collector off while it captures: a dead cycle
  that holds another graph, collected then, would destroy that graph in
  the middle of the capture and so invalidate it (``torch.cuda.graph``
  no longer collects before a capture).

A counter that device code raises through an :func:`repro_torch.obs.device_tally`
moves by itself under replay; reading the counters folds the warm-up's
part in before :func:`uncounted` puts them back.

A callable that cannot be captured (a host sync, a pageable copy, an
allocation outside the graph's pool) raises :class:`GraphCaptureError`.
Nothing falls back to running it eagerly: a CPU model never captures,
and its callers run it op by op.
"""

from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch import obs
from repro_torch.kernels.conv_requant import conv_requant
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.matmul_requant import matmul_requant
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.ssd_scan import ssd_scan

__all__ = ["COUNTED", "CapturedGraph", "GraphCaptureError", "add_launches", "capture", "launch_counts", "uncounted"]

# the kernel wrappers that count their launches in ``<wrapper>.launches``
COUNTED = (matmul_requant, conv_requant, flash_attention, moe_gmm, ssd_scan, rglru_scan)


class GraphCaptureError(RuntimeError):
    """A callable could not be captured in a CUDA graph."""


def launch_counts() -> dict[str, int]:
    """Every counted wrapper's ``launches``, by the wrapper's name."""
    return {fn.__name__: fn.launches for fn in COUNTED}


def add_launches(delta: dict[str, int]) -> None:
    """Add ``delta[name]`` to the counter of each wrapper it names."""
    for fn in COUNTED:
        fn.launches += delta.get(fn.__name__, 0)


def _obs_counts() -> dict[str, int]:
    return obs.metrics_dict()["counters"]


@contextlib.contextmanager
def uncounted():
    """Launches inside the block leave every counter as it was, the
    :mod:`repro_torch.obs` counters too: a warm-up or a capture is paid to
    build a graph, not asked for."""
    before, before_obs = launch_counts(), _obs_counts()
    try:
        yield
    finally:
        for fn in COUNTED:
            fn.launches = before[fn.__name__]
        for name, value in _obs_counts().items():
            if value != before_obs.get(name, 0):
                obs.counter(name).value = before_obs.get(name, 0)


@dataclass
class CapturedGraph:
    """One captured graph, the tensors its callable returned during the
    capture (rewritten in place by every replay), and the kernel launches
    each replay makes."""

    graph: Any  # torch.cuda.CUDAGraph
    output: Any
    launches: dict[str, int]
    capture_ms: float
    counts: tuple = ()  # (obs Counter, its increase in the capture) of each counter that moved

    def replay(self) -> Any:
        """Launch the captured sequence on the current stream; returns
        :attr:`output`, which holds this replay's results once the stream
        reaches them."""
        self.graph.replay()
        add_launches(self.launches)
        for c, n in self.counts:
            c.inc(n)
        return self.output


def capture(fn: Callable[[], Any], device: torch.device, *, warmup: int = 1) -> CapturedGraph:
    """Capture ``fn()`` on ``device`` (a CUDA device) after ``warmup``
    eager calls on a side stream.

    ``fn`` must read and write only tensors that outlive the graph (the
    caller's static tensors) or that it allocates itself; those it returns
    become :attr:`CapturedGraph.output`.  The warm-up calls really run, so
    state that ``fn`` updates in place is updated ``warmup`` times: the
    caller writes its state after capturing.  Each graph keeps a private
    memory pool.
    """
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
    t0 = time.perf_counter()
    try:
        with uncounted():
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(warmup):
                    fn()
            torch.cuda.current_stream(device).wait_stream(side)
            torch.cuda.synchronize(device)
            start, start_obs = launch_counts(), _obs_counts()
            graph = torch.cuda.CUDAGraph()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph):
                    output = fn()
            finally:
                if collecting:
                    gc.enable()
            end, end_obs = launch_counts(), _obs_counts()
            torch.cuda.synchronize(device)
    except Exception as e:
        raise GraphCaptureError(f"capture of {getattr(fn, '__qualname__', fn)} on {device} failed: {e}") from e
    launches = {k: end[k] - start[k] for k in end}
    counts = tuple((obs.counter(k), v - start_obs.get(k, 0)) for k, v in end_obs.items() if v != start_obs.get(k, 0))
    return CapturedGraph(graph, output, launches, (time.perf_counter() - t0) * 1e3, counts)

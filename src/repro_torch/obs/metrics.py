"""Process-wide metrics registry.

Counters, gauges and histograms that every subsystem increments as it
works — DSE query volume and schedule-cache hit rates from the
dispatcher, lowering-route tallies, memory-planner spills, AOT
executable-cache hits and donation fallbacks, per-segment latency
histograms from timed runs.  :func:`metrics_dict` snapshots the whole
registry as plain JSON-safe data; ``CompiledModel.report_dict()["obs"]``
embeds it so a single report answers "which cache missed".

Unlike the tracer there is no off switch: a counter bump is one dict
lookup + integer add, far below measurement noise, and having the
numbers always-on is what makes cache-hit-rate regressions visible in
ordinary test runs.  Thread safety is one process-wide lock taken only
on first-registration and on histogram observes; counter/gauge updates
ride on atomic-under-the-GIL int/float stores.

A counter that device code raises keeps a device tally
(:func:`device_tally`: an int64 that a kernel adds to, as ``moe_gmm``
adds the rows it runs), so a captured CUDA graph's replays count with no
host read.  :func:`metrics_dict` folds each tally into its counter, one
host read a tally; :func:`reset_metrics` zeroes them.

Stdlib-only at import, like the rest of ``repro_torch.obs``.
"""

from __future__ import annotations

import math
import threading

from .sketch import QuantileSketch

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "counter",
    "device_tally",
    "gauge",
    "histogram",
    "metrics_dict",
    "reset_metrics",
]


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def to_value(self):
        return self.value


class Gauge:
    """Last-write-wins scalar (peak bytes, hit rate, ...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def to_value(self):
        return self.value


class Histogram:
    """Streaming summary: count/sum/min/max, log2-spaced buckets, and a
    :class:`repro_torch.obs.sketch.QuantileSketch` for approximate quantiles.

    Buckets are powers of two over the observed unit (microseconds for
    the latency histograms) — coarse, but enough to distinguish "one
    slow segment" from "everything slow" without storing samples.  The
    embedded sketch adds p50/p90/p99 to :meth:`to_value` with a
    1% relative-accuracy guarantee, still without storing samples.
    """

    __slots__ = ("name", "count", "total", "min", "max", "buckets", "sketch",
                 "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: dict[int, int] = {}  # floor(log2(v)) -> count
        self.sketch = QuantileSketch(relative_accuracy=0.01, max_buckets=512)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        b = math.frexp(v)[1] - 1 if v > 0 else 0  # floor(log2(v)), cheap
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            self.buckets[b] = self.buckets.get(b, 0) + 1
            self.sketch.add(v)

    def quantile(self, q: float) -> float:
        with self._lock:
            return self.sketch.quantile(q)

    def to_value(self):
        if not self.count:
            return {"count": 0}
        with self._lock:
            qs = self.sketch.quantiles()
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.total / self.count,
            "min": self.min,
            "max": self.max,
            **qs,
            "quantile_accuracy": self.sketch.relative_accuracy,
            # JSON keys must be strings; "le_2^k" reads as an upper bound
            "buckets": {f"le_2^{b + 1}": n for b, n in sorted(self.buckets.items())},
        }


_LOCK = threading.Lock()
_COUNTERS: dict[str, Counter] = {}
_GAUGES: dict[str, Gauge] = {}
_HISTOGRAMS: dict[str, Histogram] = {}
# (counter name, device) -> the int64 torch tensor that device code adds to
_TALLIES: dict[tuple[str, str], object] = {}


def _get(table: dict, cls, name: str):
    m = table.get(name)
    if m is None:
        with _LOCK:
            m = table.setdefault(name, cls(name))
    return m


def counter(name: str) -> Counter:
    """The process-wide counter called ``name`` (created on first use)."""
    return _get(_COUNTERS, Counter, name)


def gauge(name: str) -> Gauge:
    return _get(_GAUGES, Gauge, name)


def histogram(name: str) -> Histogram:
    return _get(_HISTOGRAMS, Histogram, name)


def device_tally(name: str, device) -> object:
    """The int64 tensor on ``device`` that device code adds to on behalf
    of the counter ``name``: zero at first use, then kept at one address
    for the process (a CUDA graph captures its pointer), so first use it
    outside a capture."""
    import torch

    device = torch.device(device)
    key = (name, str(device))
    t = _TALLIES.get(key)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the device tally of {name!r} is first used inside a capture: warm up first")
        with _LOCK, torch.inference_mode(False):
            t = _TALLIES.setdefault(key, torch.zeros((), dtype=torch.int64, device=device))
    return t


def metrics_dict() -> dict:
    """JSON-safe snapshot of every registered metric, sorted by name,
    once each device tally is folded into its counter (a host read that
    waits for the device work queued before it; not inside a capture)."""
    with _LOCK:
        for (name, _), t in _TALLIES.items():
            n = int(t)
            if n:
                _COUNTERS.setdefault(name, Counter(name)).inc(n)
                t.zero_()
        return {
            "counters": {k: m.to_value() for k, m in sorted(_COUNTERS.items())},
            "gauges": {k: m.to_value() for k, m in sorted(_GAUGES.items())},
            "histograms": {k: m.to_value() for k, m in sorted(_HISTOGRAMS.items())},
        }


def reset_metrics() -> None:
    """Drop every metric (tests; never called by the library itself)."""
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()
        _HISTOGRAMS.clear()
        for t in _TALLIES.values():
            t.zero_()

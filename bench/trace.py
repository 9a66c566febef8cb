"""The traced stretch: ``torch.profiler`` over a steady part of the window,
reduced to device intervals and set against the harness's host spans.

Host spans are taken with ``time.perf_counter`` on any thread.  The
profiler records CUDA activity alone (kernels, copies, memsets and the
runtime calls), so it adds no cost to each of the host's tensor ops.  Its
clock is tied to ``perf_counter`` by a few ``torch.cuda.mem_get_info``
calls as the stretch starts: each is one ``cudaMemGetInfo`` in the trace,
which lies inside the ``perf_counter`` readings taken around it, and
together they pin the offset to some microseconds.  Device intervals are
the activity of cat ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` in the
exported Chrome trace.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from bisect import bisect_right
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

__all__ = ["Stretch", "TraceReading", "stopping", "stretch_bounds", "union_s"]

TRACE_AT = 0.4  # the traced stretch starts this share into the window
TRACE_S = 0.5  # and lasts this long, or 30 % of the window if that is shorter
SYNC = "cudaMemGetInfo"
SYNC_CALLS = 8
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def union_s(intervals: list[tuple[float, float]]) -> tuple[float, list[tuple[float, float]]]:
    """Length of the union of ``intervals`` and the union itself, sorted."""
    merged: list[tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return sum(b - a for a, b in merged), merged


@dataclass
class TraceReading:
    """What the stretch's device trace says, in seconds."""

    window_s: float
    busy_s: float  # union of all device activity
    kernel_s: float  # union of kernels alone
    device_ops: list = field(default_factory=list)  # [[name, seconds]], most time first
    idle_gaps: list = field(default_factory=list)  # [[host span, seconds]], most time first
    events: int = 0
    sync_error_us: float | None = None  # half the width of the clock offset's bracket


def stretch_bounds(t_start: float, seconds: float) -> tuple[float, float]:
    """When the traced stretch of a window opened at ``t_start`` starts, and
    how long it lasts."""
    return t_start + TRACE_AT * seconds, min(TRACE_S, 0.3 * seconds)


@contextmanager
def stopping(stretch: "Stretch | None"):
    """Leave no profiler running, whatever the window raised."""
    try:
        yield
    finally:
        if stretch is not None and stretch.t0 is not None:
            stretch.stop()


class Stretch:
    """Profile from :meth:`start` to :meth:`stop` on the device ``dev``
    (no profiler on the CPU: the stretch is then marked, not traced)."""

    def __init__(self, dev):
        self.dev = dev
        self.prof = None
        self.t0 = self.t1 = None  # the stretch
        self.a = self.b = None  # the part the profiler disturbs: start() entry to stop() exit
        self.sync_perf: list[tuple[float, float]] = []  # perf_counter around each sync call
        self.stopped = False
        self.sync_error_us: float | None = None

    def prime(self) -> None:
        """Start and stop a profiler once, outside the window: the first
        start in a process loads and initialises CUPTI, which takes a
        second or more."""
        if self.dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]):
                import torch

                torch.cuda.mem_get_info(self.dev)
                torch.cuda.synchronize(self.dev)

    def start(self) -> None:
        import torch

        self.a = time.perf_counter()
        if self.dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            torch.cuda.synchronize(self.dev)
            for _ in range(SYNC_CALLS):
                a = time.perf_counter()
                torch.cuda.mem_get_info(self.dev)
                self.sync_perf.append((a, time.perf_counter()))
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        """End the stretch; safe to call twice."""
        import torch

        if self.t1 is None:
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
            self.t1 = time.perf_counter()
        if self.prof is not None and not self.stopped:
            self.stopped = True
            self.prof.stop()
        if self.b is None:
            self.b = time.perf_counter()

    def disturbed_s(self) -> float:
        return self.b - self.a

    def read(self, host_spans: list[tuple[str, float, float]]) -> TraceReading | None:
        """Reduce the trace to the stretch ``[t0, t1]``; ``host_spans`` are
        (label, start, end) on ``perf_counter``.  ``None`` on the CPU, or
        where the trace holds no device activity."""
        if self.prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        syncs = sorted(float(e["ts"]) for e in events if e.get("name") == SYNC and e.get("cat") == "cuda_runtime")
        durs = {float(e["ts"]): float(e.get("dur", 0.0)) for e in events if e.get("name") == SYNC}
        if len(syncs) < len(self.sync_perf):
            raise RuntimeError(f"the profiler's trace holds {len(syncs)} of the stretch's {len(self.sync_perf)} "
                               f"{SYNC} calls")
        # each call lies inside its perf_counter readings: trace - perf lies in [ts + dur - after, ts - before]
        lo, hi = -float("inf"), float("inf")
        for ts, (before, after) in zip(syncs[-len(self.sync_perf):], self.sync_perf):
            lo, hi = max(lo, ts + durs[ts] - after * 1e6), min(hi, ts - before * 1e6)
        base = (lo + hi) / 2
        self.sync_error_us = (hi - lo) / 2  # negative: the calls disagree

        def to_s(ts_us: float) -> float:
            return (ts_us - base) * 1e-6

        device, kernels = [], []
        by_name: dict[str, float] = defaultdict(float)
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            a = to_s(float(e["ts"]))
            b = a + float(e.get("dur", 0.0)) * 1e-6
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            device.append((a, b))
            by_name[e["name"]] += b - a
            if e["cat"] == "kernel":
                kernels.append((a, b))
        if not device:
            return None
        busy, merged = union_s(device)
        kernel_s, _ = union_s(kernels)
        return TraceReading(
            window_s=self.t1 - self.t0,
            busy_s=busy,
            kernel_s=kernel_s,
            device_ops=[[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
            idle_gaps=self._gaps(merged, host_spans),
            events=len(device),
            sync_error_us=self.sync_error_us,
        )

    def _gaps(self, merged: list[tuple[float, float]], host_spans: list[tuple[str, float, float]]) -> list:
        """Idle device time by the host span its middle fell in."""
        spans = sorted((a, b, label) for label, a, b in host_spans if b > self.t0 and a < self.t1)
        starts = [s[0] for s in spans]
        edges = [self.t0] + [x for iv in merged for x in iv] + [self.t1]
        by_label: dict[str, float] = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            # the harness's spans never overlap: the latest one to start covers mid, or none does
            i = bisect_right(starts, mid) - 1
            label = spans[i][2] if i >= 0 and spans[i][1] > mid else "none"
            by_label[label] += b - a
        return [[n, s] for n, s in sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]]

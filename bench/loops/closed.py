"""MLPerf LoadGen's SingleStream: one client in a closed loop at batch 1.

Each request is timed by the client's host clock from the call, with its
input in host memory, to its outputs readable in host memory (``.cpu()``
of what ``AotModel.run`` returned); the next request is issued when the
last one's outputs are on the host.  The entry is ``compile_aot(cm)`` at
its defaults.

A mix names its loop by ``loop``; a loop is a file of ``bench/loops/``
with ``prepare(cm, feed, mix)`` (the capture of the cell's own signature,
timed as compile), ``warm(entry, feed, mix)`` (set-up), ``drive(run,
entry, feed, mix)`` (the window) and, optionally, ``close(entry)``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from bench.trace import Stretch, stopping, stretch_bounds


def prepare(cm, feed, mix: dict):
    from repro_torch.backend import compile_aot

    am = compile_aot(cm)
    am.warmup(feed.params, {feed.name: feed.samples[0]})
    return am


def warm(am, feed, mix: dict) -> None:
    with torch.inference_mode():
        for p in feed.warm_order:
            {k: v.cpu() for k, v in am.run(feed.params, {feed.name: feed.samples[p]}).items()}


def drive(run, am, feed, mix: dict) -> None:
    """Requests back to back until the window closes."""
    seq, params, name, samples, keep = feed.order, feed.params, feed.name, feed.samples, feed.keep
    mask = len(seq) - 1
    lat = run.latencies_s
    stretch = Stretch(feed.dev) if feed.trace else None
    t_start = time.perf_counter()
    deadline = t_start + run.seconds
    trace_at, trace_len = stretch_bounds(t_start, run.seconds)
    i = 0
    with torch.inference_mode(), stopping(stretch):
        while True:
            t0 = time.perf_counter()
            if t0 >= deadline:
                break
            p = seq[i & mask]
            if stretch is None:
                out = am.run(params, {name: samples[p]})
                host = {k: v.cpu() for k, v in out.items()}
                lat.append(time.perf_counter() - t0)
            else:
                if stretch.t0 is None and t0 >= trace_at:
                    stretch.start()
                    t0 = time.perf_counter()
                x = {name: samples[p]}
                t1 = time.perf_counter()
                out = am.run(params, x)
                t2 = time.perf_counter()
                host = {k: v.cpu() for k, v in out.items()}
                t3 = time.perf_counter()
                lat.append(t3 - t0)
                if stretch.t0 is not None and stretch.t1 is None:
                    run.spans += [("client", t0, t1), ("AotModel.run", t1, t2), ("client output copy", t2, t3)]
                    run.stretch_rows.append(1)
                    if t3 >= stretch.t0 + trace_len:
                        stretch.stop()
                else:
                    run.host_calls_s.append(t2 - t1)
            keep.offer((p, host))
            i += 1
    run.window_s = time.perf_counter() - t_start
    run.attempted = run.samples = i
    q = [np.median(part) * 1e3 for part in np.array_split(np.asarray(lat), 4) if len(part)]
    print("bench: p50 ms by quarter of the window: " + " ".join(f"{v:.5f}" for v in q), file=sys.stderr)
    if stretch is not None:
        if stretch.t1 is None:
            raise RuntimeError("the window closed before the traced stretch ended: lengthen --seconds")
        run.stretch_s = stretch.t1 - stretch.t0
        run.outside_s = run.window_s - stretch.disturbed_s()
        run.outside_samples = len(run.host_calls_s)
        run.trace = stretch.read(run.spans)

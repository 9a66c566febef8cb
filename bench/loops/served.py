"""One client in a closed loop at batch 1, through the port's ``ServeEngine``.

Each request is a pool prompt and the configuration's number of new
tokens, greedy, with no stop token, submitted to the engine and served by
``ServeEngine.run``: its prefill, then one decode-graph replay a token,
each token sampled on the host.  A request is timed by the client's host
clock from its submission to its last token in host memory; the next is
submitted when the last one returns.  The program is the builder's
``Served`` (:mod:`bench.graphs.granite_hybrid`); ``prepare`` captures the
engine's decode graph of one row.

Each answer is the request's tokens and the host logits each was sampled
from.  The window offers every answer to the reservoir as the engine's
lists; :func:`close` stacks the kept ones into tensors.

A traced run turns the program's tracer on for the window.  Once the
window has closed the loop takes the means of the spans ``serve.prefill``,
``serve.decode_step`` and ``model.moe`` recorded outside the profiler's
part (``run.served_spans``, seconds), and every run prints the program's
``moe.*`` counters.
"""

import sys
import time
from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch

from bench.trace import Stretch, stopping, stretch_bounds

SPANS = ("serve.prefill", "serve.decode_step", "model.moe")
COUNTERS = ("moe.routed_pairs", "moe.rows_computed", "moe.dropped")


@dataclass
class Entry:
    served: object  # the builder's Served
    prompts: list  # the pool as int32 numpy rows
    kept: list  # the reservoir's items, stacked by close()


def prepare(served, feed, mix: dict) -> Entry:
    served.engine.capture(1)
    prompts = [s.reshape(-1).numpy().astype(np.int32) for s in feed.samples]
    return Entry(served, prompts, feed.keep.items)


def _request(entry: Entry, rid: int, p: int):
    """Serve pool prompt ``p``; returns the finished request."""
    from repro_torch.serving import Request

    req = Request(rid, entry.prompts[p], max_new_tokens=entry.served.new_tokens, logits=[])
    entry.served.engine.submit(req)
    (done,) = entry.served.engine.run()
    return done


def warm(entry: Entry, feed, mix: dict) -> None:
    """The mix's warm-up requests, uncounted."""
    for i, p in enumerate(feed.warm_order):
        _request(entry, -1 - i, p)


def drive(run, entry: Entry, feed, mix: dict) -> None:
    """Requests back to back until the window closes."""
    from repro_torch import obs

    seq, keep, lat = feed.order, feed.keep, run.latencies_s
    mask = len(seq) - 1
    stretch = Stretch(feed.dev) if feed.trace else None
    tracer = obs.get_tracer()
    if feed.trace:
        tracer.clear()
        obs.enable_tracing()
    t_start = time.perf_counter()
    deadline = t_start + run.seconds
    trace_at, trace_len = stretch_bounds(t_start, run.seconds)
    i = failed = 0
    try:
        with torch.inference_mode(), stopping(stretch):
            while True:
                t0 = time.perf_counter()
                if t0 >= deadline:
                    break
                p = seq[i & mask]
                if stretch is not None and stretch.t0 is None and t0 >= trace_at:
                    stretch.start()
                    t0 = time.perf_counter()
                req = _request(entry, i, p)
                t1 = time.perf_counter()
                lat.append(t1 - t0)
                failed += req.truncated or len(req.out_tokens) != entry.served.new_tokens
                if stretch is not None:
                    if stretch.t0 is not None and stretch.t1 is None:
                        run.spans.append(("ServeEngine request", t0, t1))
                        run.stretch_rows.append(1)
                        if t1 >= stretch.t0 + trace_len:
                            stretch.stop()
                    else:
                        run.host_calls_s.append(t1 - t0)
                keep.offer((p, {"tokens": req.out_tokens, "logits": req.logits}))
                i += 1
    finally:
        if feed.trace:
            obs.disable_tracing()
    run.window_s = time.perf_counter() - t_start
    run.attempted = run.samples = i
    run.failed = failed
    q = [np.median(part) * 1e3 for part in np.array_split(np.asarray(lat), 4) if len(part)]
    print("bench: p50 ms by quarter of the window: " + " ".join(f"{v:.3f}" for v in q), file=sys.stderr)
    counters = obs.metrics_dict()["counters"]
    print("bench: " + ", ".join(f"{k} {counters.get(k)}" for k in COUNTERS), file=sys.stderr)
    if stretch is not None:
        if stretch.t1 is None:
            raise RuntimeError("the window closed before the traced stretch ended: lengthen --seconds")
        run.stretch_s = stretch.t1 - stretch.t0
        run.outside_s = run.window_s - stretch.disturbed_s()
        run.outside_samples = len(run.host_calls_s)
        run.trace = stretch.read(run.spans)
        run.served_spans = _span_means(tracer, stretch)
        tracer.clear()
        print("bench: span means, ms: " + ", ".join(f"{k} {v * 1e3:.4f}" for k, v in run.served_spans.items()),
              file=sys.stderr)


def _span_means(tracer, stretch: Stretch) -> dict:
    """Mean seconds of each of :data:`SPANS` that lies outside the part
    the profiler disturbed."""
    epoch, lo, hi = tracer.epoch_s, stretch.a, stretch.b
    by_name = defaultdict(list)
    for e in tracer.chrome_trace()["traceEvents"]:
        if e.get("ph") == "X" and e.get("name") in SPANS:
            a = epoch + e["ts"] * 1e-6
            b = a + e["dur"] * 1e-6
            if b < lo or a > hi:
                by_name[e["name"]].append(b - a)
    return {k: sum(v) / len(v) for k, v in by_name.items()}


def close(entry: Entry) -> None:
    """Stack each kept answer's tokens and logits into tensors."""
    for j, (p, out) in enumerate(entry.kept):
        if isinstance(out["tokens"], list):
            entry.kept[j] = (p, {"tokens": torch.tensor(out["tokens"], dtype=torch.int64),
                                 "logits": torch.from_numpy(np.stack(out["logits"]))})

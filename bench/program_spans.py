"""The program's own spans and counters (``repro_torch.obs``), and the
device kernels they launched: what the per-layer metrics of set-up's DSE
and capture, of the phases of ``AotModel.run`` and of the conv segments'
kernels read.

The run's set-up, window and traced stretch keep the program's tracer
off, as they always have, so none of the readings the benchmark had moves.
The program's view is taken in a pass of its own, once the window has
closed and the run's program is freed, in the same process on the same
card:

1. set-up again with the tracer on: the configuration's graph dispatched
   with the process's schedule cache cleared, so that the DSE searches as
   cold as in set-up, then lowered and captured by ``compile_aot`` (the
   ``dispatch.*`` and ``aot.capture`` spans);
2. window C, requests back to back for ``min(0.5 s, 10 % of the window)``
   with no profiler, in alternate blocks with the tracer on and off: the
   four phase spans of ``AotModel.run``, free of CUPTI's slowdown of the
   host, and what recording them costs, the two kinds of block taken in
   the same state of the host;
3. stretch B, as long, with the profiler and the tracer both on.  It opens
   with one eager ``CompiledModel.run`` of the net, which is no request:
   each of its launches belongs to the segment span and ``node:<op>`` span
   its runtime call falls in, and through the launch's CUPTI correlation
   id so do the kernels it launched, which gives each segment's kernel
   sequence in order.  Each replay's kernels carry the correlation id of
   its graph launch and are matched in order against that sequence; a
   replay whose kernels differ in count or name is left out, and said so,
   and where fewer than 99 % match, the readers of the replays' kernels
   read ``None``.

Program spans are put on ``perf_counter`` by the tracer's ``epoch_s``.  The
profiler's host calls are tied to ``perf_counter`` as :mod:`bench.trace`
ties them, by bracketed ``cudaMemGetInfo`` calls; its device events, whose
clock drifts from the host calls' in the trace, by the launches and the
copies to host memory around them (:func:`device_trace`); and the eager
run's launches alone are shifted within the bracket's error to where the
most of them fall inside the spans (a shift of microseconds, printed).

A program without ``Tracer.epoch_s`` has none of these spans: every reader
then reads ``None``, and the pass does not run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback
from bisect import bisect_left, bisect_right
from collections import defaultdict
from dataclasses import dataclass, field

from bench import spec
from bench.trace import DEVICE_CATS, SYNC, Stretch, stopping, union_s

__all__ = ["Reading", "Span", "read_stretch_b", "reading", "spans_of"]

PHASES = ("aot.prepare", "aot.input_copy", "aot.replay", "aot.output_clone")
DISPATCH = ("dispatch.enumerate", "dispatch.dse_flush", "dispatch.resolve", "dispatch.viterbi",
            "dispatch.makespan_rerank")
PART_S, PART_SHARE = 0.5, 0.1  # window C and stretch B each last min(PART_S, PART_SHARE x the window)
WARM = 50  # requests on the pass's own entry before window C, tracer off
POOL = 16  # inputs the pass draws
BLOCK = 32  # window C's requests alternate between blocks this long with the tracer on and off
API_CATS = ("cuda_runtime", "cuda_driver")
FIT_MARGIN_US = 10.0  # the eager launches' shift is sought this far beyond the bracket's error
GAP_S = 1e-3  # host time between the eager run's end and the first replay
SKEW_WINDOW_S = 1e-3  # the device clock's offset is bounded by the launches this near a copy to the host
TOP = 10
MATCHED_SHARE = 0.99  # the replay readers read None where fewer of stretch B's replays match the eager run
_MEMO = "_program_spans"  # the run's attribute that holds the pass's reading


@dataclass
class Span:
    """One complete span of the program's tracer, on ``perf_counter`` seconds."""

    name: str
    lane: str | None
    a: float
    b: float
    args: dict = field(default_factory=dict)


@dataclass
class Launch:
    """A runtime or driver call that put work on the device."""

    name: str
    t: float  # perf_counter seconds
    end: float
    corr: int


@dataclass
class Dev:
    """A kernel, copy or memset on the device."""

    cat: str
    name: str
    a: float
    b: float
    corr: int


@dataclass
class DeviceTrace:
    device: list[Dev]  # by start, on the host's clock
    launches: list[Launch]  # by time; calls with device work only
    sync_error_us: float  # the host calls' clock: half the width of the sync calls' bracket
    device_error_us: float | None = None  # the device events': median half-width of their brackets


@dataclass
class Label:
    """Where a device event's launch came from: its segment and, where the
    segment wrote node spans, the node's place in the chain (0: anchor)."""

    segment: str
    route: str
    node: int | None = None
    op: str | None = None


@dataclass
class StretchB:
    """What stretch B says."""

    window: tuple = (0.0, 0.0)  # the replays' part read: to the trace's last device event
    eager_launches: int = 0
    eager_in_spans: int = 0
    shift_us: float = 0.0
    sequence: list = field(default_factory=list)  # [(device event name, Label)] of the eager run, in order
    replays: int = 0
    matched: list = field(default_factory=list)  # per matched replay: [(Dev, Label)]
    why: list = field(default_factory=list)  # one line per replay left out
    first_after_start: int = 0  # matched replays whose first kernel starts after their aot.replay span
    idle_in_aot_pct: float | None = None
    idle_gaps: list = field(default_factory=list)  # [[innermost span, seconds]], most first
    by_segment: list = field(default_factory=list)  # [[segment, route, s, anchor s, epilogue s]], most first
    tiled_conv_roofline_pct: float | None = None


@dataclass
class Reading:
    """The pass's readings; ``None`` where it had nothing to read."""

    phase_us: dict = field(default_factory=dict)  # window C: mean of each phase span
    run_us: float | None = None  # window C: mean aot.run:<graph> span
    dse_s: float | None = None
    capture_s: float | None = None
    dse_candidates: int | None = None
    b: StretchB | None = None


# -- reading traces ---------------------------------------------------------------


def spans_of(trace: dict, epoch_s: float) -> list[Span]:
    """The complete spans of a tracer's Chrome trace, by start."""
    lanes = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    out = [Span(e["name"], lanes.get(e["tid"]), epoch_s + e["ts"] * 1e-6, epoch_s + (e["ts"] + e["dur"]) * 1e-6,
                e.get("args", {}))
           for e in trace["traceEvents"] if e.get("ph") == "X"]
    return sorted(out, key=lambda s: s.a)


def device_trace(events: list[dict], sync_perf: list[tuple[float, float]]) -> DeviceTrace:
    """The profiler's events on ``perf_counter``.

    The host calls' clock is tied by the ``cudaMemGetInfo`` calls that
    ``sync_perf`` brackets, as :meth:`bench.trace.Stretch.read` ties it.
    The device events' timestamps drift from the host calls' in the trace
    (by up to milliseconds over half a second on the card), so each is put
    on the host's clock by the launches around it: a device event starts
    after the call that launched it started, and a copy to pageable host
    memory ends before its call returns.  Around each such copy, within
    :data:`SKEW_WINDOW_S`, the two bound the offset; the offset at a launch
    is interpolated between the copies, and its events move by it."""
    syncs = sorted((float(e["ts"]), float(e.get("dur", 0.0))) for e in events
                   if e.get("name") == SYNC and e.get("cat") == "cuda_runtime")
    if len(syncs) < len(sync_perf):
        raise RuntimeError(f"the profiler's trace holds {len(syncs)} of {len(sync_perf)} {SYNC} calls")
    lo, hi = -float("inf"), float("inf")
    for (ts, dur), (before, after) in zip(syncs[-len(sync_perf):], sync_perf):
        lo, hi = max(lo, ts + dur - after * 1e6), min(hi, ts - before * 1e6)
    base = (lo + hi) / 2

    def corr(e) -> int | None:
        c = e.get("args", {}).get("correlation")
        return int(c) if c is not None else None

    by_corr: dict[int, list[Dev]] = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and corr(e) is not None:
            a = (float(e["ts"]) - base) * 1e-6
            by_corr[corr(e)].append(Dev(e["cat"], e["name"], a, a + float(e.get("dur", 0.0)) * 1e-6, corr(e)))
    launches = sorted((Launch(e["name"], (float(e["ts"]) - base) * 1e-6,
                              (float(e["ts"]) + float(e.get("dur", 0.0)) - base) * 1e-6, corr(e))
                       for e in events if e.get("ph") == "X" and e.get("cat") in API_CATS and corr(e) in by_corr),
                      key=lambda x: x.t)
    skew, err = _device_skew(launches, by_corr)
    device = []
    for c in launches:
        off = skew(c.t)
        device += [Dev(d.cat, d.name, d.a - off, d.b - off, d.corr) for d in by_corr.pop(c.corr, [])]
    for evs in by_corr.values():  # no call in the trace launched these
        device += [Dev(d.cat, d.name, d.a - skew(d.a), d.b - skew(d.a), d.corr) for d in evs]
    device.sort(key=lambda d: d.a)
    return DeviceTrace(device, launches, (hi - lo) / 2, err)


def _device_skew(launches: list[Launch], by_corr: dict[int, list[Dev]]):
    """The device clock's offset from the host calls' as a function of the
    host's time, and the median half-width of its brackets in us."""
    ts = [c.t for c in launches]
    upper = [min(d.a for d in by_corr[c.corr]) - c.t for c in launches]  # offset <= this
    anchors = []
    for c in launches:
        evs = by_corr[c.corr]
        if all(d.cat == "gpu_memcpy" and "DtoH" in d.name and "Pageable" in d.name for d in evs):
            lo = max(d.b for d in evs) - c.end  # offset >= this
            hi = min(upper[bisect_left(ts, c.t - SKEW_WINDOW_S) : bisect_right(ts, c.t + SKEW_WINDOW_S)])
            anchors.append((c.t, (lo + hi) / 2 if lo <= hi else hi, (hi - lo) / 2))
    if not anchors:
        return (lambda t: 0.0), None
    at = [t for t, _, _ in anchors]
    halves = sorted(h for _, _, h in anchors)

    def skew(t: float) -> float:
        i = bisect_right(at, t)
        if i == 0:
            return anchors[0][1]
        if i == len(anchors):
            return anchors[-1][1]
        (t0, s0, _), (t1, s1, _) = anchors[i - 1], anchors[i]
        return s0 + (s1 - s0) * (t - t0) / (t1 - t0) if t1 > t0 else s0

    return skew, halves[len(halves) // 2] * 1e6


def fit_shift(times: list[float], leaves: list[tuple[float, float]], reach: float) -> tuple[float, int]:
    """The shift within ``[-reach, reach]`` that puts the most of ``times``
    inside ``leaves`` (disjoint, by start), and how many it puts there: of
    the shifts that put the most, the nearest to 0, then the widest run."""
    starts, ends = [a for a, _ in leaves], [b for _, b in leaves]
    marks = []
    for t in times:
        for i in range(bisect_left(ends, t - reach), bisect_right(starts, t + reach)):
            lo, hi = max(starts[i] - t, -reach), min(ends[i] - t, reach)
            if lo <= hi:
                marks += [(lo, 1), (hi, -1)]
    if not marks:
        return 0.0, 0
    marks.sort(key=lambda m: (m[0], -m[1]))
    best, count = None, 0
    for k, (x, d) in enumerate(marks):
        count += d
        nxt = marks[k + 1][0] if k + 1 < len(marks) else reach
        if nxt <= x:
            continue
        dist = 0.0 if x <= 0.0 <= nxt else min(abs(x), abs(nxt))
        key = (count, -dist, nxt - x)
        if best is None or key > best[0]:
            best = (key, (x + nxt) / 2)
    return best[1], best[0][0]


def _innermost(spans: list[Span], starts: list[float], t: float, depth: int = 16) -> Span | None:
    """The innermost of ``spans`` (nested, by start; ``starts`` their
    starts) that covers ``t``: the latest to start of those that cover it.
    Requests follow one another, so a span that covers ``t`` is among the
    ``depth`` latest to start before it."""
    i = bisect_right(starts, t) - 1
    for s in spans[max(0, i - depth + 1) : i + 1][::-1]:
        if s.b >= t:
            return s
    return None


def _eager_labels(dt: DeviceTrace, spans: list[Span], e0: float, e1: float, out: StretchB) -> dict[int, Label]:
    """The eager run's launches, by correlation id, labelled with the
    segment span and node span their call falls in."""
    segs = [s for s in spans if "route" in s.args and e0 <= s.a and s.b <= e1]
    nodes = [s for s in spans if s.name.startswith("node:") and e0 <= s.a and s.b <= e1]
    label_of_node: dict[int, Label] = {}
    leaves: list[tuple[float, float, Label]] = []
    for seg in segs:
        mine = [n for n in nodes if n.lane == seg.lane and seg.a <= n.a and n.b <= seg.b]
        for i, n in enumerate(mine):
            label_of_node[id(n)] = Label(seg.name, seg.args["route"], i, n.name.removeprefix("node:"))
            leaves.append((n.a, n.b, label_of_node[id(n)]))
        if not mine:
            leaves.append((seg.a, seg.b, Label(seg.name, seg.args["route"])))
    leaves.sort(key=lambda x: x[0])
    reach = max(dt.sync_error_us, 0.0) * 1e-6 + FIT_MARGIN_US * 1e-6
    calls = [c for c in dt.launches if e0 - reach <= c.t <= e1 + reach]
    shift, inside = fit_shift([c.t for c in calls], [(a, b) for a, b, _ in leaves], reach)
    out.eager_launches, out.eager_in_spans, out.shift_us = len(calls), inside, shift * 1e6
    starts = [a for a, _, _ in leaves]
    labels: dict[int, Label] = {}
    for c in calls:
        i = bisect_right(starts, c.t + shift) - 1
        if i >= 0 and leaves[i][1] >= c.t + shift:
            labels[c.corr] = leaves[i][2]
    return labels


def read_stretch_b(dt: DeviceTrace, spans: list[Span], eager: tuple[float, float], window: tuple[float, float],
                   harness_spans: list[tuple[str, float, float]], need_by_segment: dict[str, float]) -> StretchB:
    """Stretch B read: ``eager`` is the eager run's host interval,
    ``window`` the replays' (their requests issued from its start, the
    device synchronised at its end), ``harness_spans`` the client's
    (label, start, end) of each request, ``need_by_segment`` each
    segment's least device seconds for one request."""
    out = StretchB()
    e0, e1 = eager
    r0, r1 = window
    # the trace can lose its last device events: read only as far as it holds them
    r1 = min(r1, max((d.b for d in dt.device if d.a >= r0), default=r0))
    out.window = (r0, r1)
    labels = _eager_labels(dt, spans, e0, e1, out)
    by_corr: dict[int, list[Dev]] = defaultdict(list)
    for d in dt.device:
        by_corr[d.corr].append(d)
    out.sequence = [(d.name, labels[d.corr]) for d in dt.device if d.corr in labels]
    names = [n for n, _ in out.sequence]

    # each replay is the graph launch its aot.replay span holds (the trace can miss a launch, or its kernels)
    replay_spans = [s for s in spans if s.name == "aot.replay" and r0 <= s.a and s.b <= r1]
    graph_calls = [c for c in dt.launches if "GraphLaunch" in c.name and c.t >= r0 - GAP_S / 2]
    call_at = [c.t + out.shift_us * 1e-6 for c in graph_calls]
    out.replays = len(replay_spans)
    err = max(dt.sync_error_us, 0.0) * 1e-6
    reach = err + FIT_MARGIN_US * 1e-6
    for k, sp in enumerate(replay_spans):
        i = bisect_left(call_at, sp.a - reach)
        if i == len(call_at) or call_at[i] > sp.b + reach:
            out.why.append(f"replay {k}: no graph launch with device work in the trace inside its aot.replay span")
            continue
        evs = by_corr.get(graph_calls[i].corr, [])
        got = [d.name for d in evs]
        if got != names:
            if len(got) != len(names):
                out.why.append(f"replay {k}: {len(got)} device events, the eager run {len(names)}")
            else:
                j = next(j for j, (a, b) in enumerate(zip(got, names)) if a != b)
                out.why.append(f"replay {k}: event {j} is {got[j]!r}, the eager run's {names[j]!r}")
            continue
        out.matched.append([(d, lab) for d, (_, lab) in zip(evs, out.sequence)])
        out.first_after_start += bool(evs) and evs[0].a >= sp.a - err

    # idle device time in the replays' window, by the innermost program span, else the client's
    busy, merged = union_s([(max(d.a, r0), min(d.b, r1)) for d in dt.device if d.b > r0 and d.a < r1])
    prog = [s for s in spans if s.b > r0 and s.a < r1]
    aot = union_s([(max(s.a, r0), min(s.b, r1)) for s in prog if s.name.startswith("aot.")])[1]
    edges = [r0] + [x for iv in merged for x in iv] + [r1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    client = sorted((Span(label, None, a, b) for label, a, b in harness_spans), key=lambda s: s.a)
    prog_at, client_at = [s.a for s in prog], [s.a for s in client]
    by_label: dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        inner = _innermost(prog, prog_at, mid) or _innermost(client, client_at, mid)
        by_label[inner.name if inner else "none"] += b - a
    out.idle_gaps = [[n, s] for n, s in sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]]
    if r1 > r0:
        out.idle_in_aot_pct = 100.0 * _overlap_s(gaps, aot) / (r1 - r0)

    if out.matched and len(out.matched) >= MATCHED_SHARE * out.replays:
        seg_s: dict[str, list] = {}
        for replay in out.matched:
            for d, lab in replay:
                row = seg_s.setdefault(lab.segment, [lab.segment, lab.route, 0.0, 0.0, 0.0])
                row[2] += d.b - d.a
                if lab.node is not None:
                    row[3 if lab.node == 0 else 4] += d.b - d.a
        out.by_segment = sorted(seg_s.values(), key=lambda r: -r[2])[:TOP]
        conv = [(d, lab) for replay in out.matched for d, lab in replay if lab.route == "tiled_conv"]
        kernel_s, _ = union_s([(d.a, d.b) for d, _ in conv if d.cat == "kernel"])
        conv_segments = {lab.segment for _, lab in out.sequence if lab.route == "tiled_conv"}
        need = sum(need_by_segment.get(s, 0.0) for s in conv_segments)
        if kernel_s > 0 and need > 0 and conv_segments <= set(need_by_segment):
            out.tiled_conv_roofline_pct = 100.0 * need * len(out.matched) / kernel_s
    return out


def _overlap_s(a: list[tuple[float, float]], b: list[tuple[float, float]]) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


# -- the pass ---------------------------------------------------------------------


def reading(run) -> Reading | None:
    """The pass's reading of ``run``, made at the first call."""
    if not hasattr(run, _MEMO):
        setattr(run, _MEMO, _read(run))
    return getattr(run, _MEMO)


def _read(run) -> Reading | None:
    from repro_torch import obs

    tr = obs.get_tracer()
    if not hasattr(tr, "epoch_s"):
        print("bench: the program's tracer has no epoch_s: no program spans to read", file=sys.stderr, flush=True)
        return None
    t0 = time.perf_counter()
    try:
        out = _pass(run, tr)
        print(f"bench: the program-span pass took {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
        return out
    except Exception:
        print("bench: the program-span pass failed:\n" + traceback.format_exc(), file=sys.stderr, flush=True)
        return None
    finally:
        obs.disable_tracing()
        tr.clear()


def _seed() -> int:
    """The run's ``--seed``, where the process was started with one."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_known_args(sys.argv[1:])[0].seed


def _mean(xs) -> float | None:
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


def _need_by_segment(run, graph, cm) -> dict[str, float]:
    """Each segment's least device seconds for one request: the need of
    the configuration's layers whose anchor node the segment holds."""
    cfg, counts = run.config, run.counts
    layers = cfg["layers"]
    anchors = [n for n in graph.nodes if n.op in {layer["op"] for layer in layers}]
    if [n.op for n in anchors] != [layer["op"] for layer in layers] or not hasattr(counts, "layer_counts"):
        return {}
    peak, hbm = run.peaks[cfg["precision"]["peak"]], run.peaks["hbm_bytes_s"]
    need_of = {}
    for n, layer, (i, o) in zip(anchors, layers, counts.shapes(layers, cfg["input"]["shape"])):
        c = counts.layer_counts(layer, i, o, 1)
        need_of[n.name] = max(c["bytes"] / hbm, c["ops"] / peak)
    return {ls.name: sum(need_of.get(n.name, 0.0) for n in ls.segment.nodes) for ls in cm.segments}


def _pass(run, tr) -> Reading:
    import torch
    from repro_torch import obs
    from repro_torch.backend import compile_aot, lower
    from repro_torch.core import clear_schedule_cache, dispatch

    cfg = run.config
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    builder = spec.named(spec.BENCH, "graphs", cfg["graph"])
    drawn = builder.draw(cfg, _seed(), POOL, dev)
    params = builder.program_params(cfg, drawn)
    name = cfg["input"]["name"]
    samples = [x.to(getattr(torch, cfg["input"]["dtype"])) for x in drawn.pool]
    graph = builder.build_graph(cfg)
    part = min(PART_S, PART_SHARE * run.seconds)
    out = Reading(dse_candidates=obs.counter("dse.candidates").value)  # the set-up's one dispatch

    # 1. set-up again, traced
    clear_schedule_cache()
    tr.clear()
    obs.enable_tracing()
    t0 = time.perf_counter()
    mapped = dispatch(graph, cfg["target"], **cfg["dispatch"])
    cm = lower(mapped, device=dev)
    am = compile_aot(cm)
    am.warmup(params, {name: samples[0]})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    compile_s = time.perf_counter() - t0
    obs.disable_tracing()
    setup = spans_of(tr.chrome_trace(), tr.epoch_s)
    tr.clear()
    first = {}
    for s in setup:
        first.setdefault(s.name, s)
    if "dispatch.dse_flush" in first:
        out.dse_s = first["dispatch.dse_flush"].b - first["dispatch.dse_flush"].a
    if "aot.capture" in first:
        out.capture_s = first["aot.capture"].b - first["aot.capture"].a
    parts = ", ".join(f"{n} {first[n].b - first[n].a:.4f} s" if n in first else f"{n} absent" for n in DISPATCH)
    flush_args = first["dispatch.dse_flush"].args if "dispatch.dse_flush" in first else {}
    lower_s = first["lower"].b - first["lower"].a if "lower" in first else float("nan")
    print(f"bench: set-up again, tracer on, schedule cache cleared: {parts}; dse candidates "
          f"{flush_args.get('candidates')} (set-up's dse.candidates {out.dse_candidates}); lower {lower_s:.4f} s; "
          f"aot.capture {out.capture_s if out.capture_s is None else round(out.capture_s, 4)} s; "
          f"compile {compile_s:.4f} s (set-up's, tracer off, {run.compile_s:.4f} s)",
          file=sys.stderr, flush=True)

    # 2. window C: no profiler; blocks of requests with the tracer on, and as many off between them
    calls = {True: [], False: []}
    with torch.inference_mode():
        for i in range(WARM):
            {k: v.cpu() for k, v in am.run(params, {name: samples[i % POOL]}).items()}
        end = time.perf_counter() + part
        i = 0
        while time.perf_counter() < end:
            on = (i // BLOCK) % 2 == 0
            tr.enabled = on
            x = {name: samples[i % POOL]}
            t1 = time.perf_counter()
            o = am.run(params, x)
            calls[on].append(time.perf_counter() - t1)
            {k: v.cpu() for k, v in o.items()}
            i += 1
        obs.disable_tracing()
    c_spans = spans_of(tr.chrome_trace(), tr.epoch_s)
    tr.clear()
    for p in PHASES:
        m = _mean(s.b - s.a for s in c_spans if s.name == p)
        if m is not None:
            out.phase_us[p] = m * 1e6
    run_us = _mean(s.b - s.a for s in c_spans if s.name.startswith("aot.run:"))
    out.run_us = run_us * 1e6 if run_us is not None else None
    on_us, off_us, outside = (1e6 * (_mean(v) or float("nan")) for v in (calls[True], calls[False], run.host_calls_s))
    phase_sum = sum(out.phase_us.values())
    print(f"bench: window C, no profiler: {len(calls[True])} requests with the tracer on, {len(calls[False])} off, "
          f"in alternate blocks of {BLOCK}, {part:.3f} s; "
          + ", ".join(f"{p} {v:.3f} us" for p, v in out.phase_us.items())
          + f"; sum {phase_sum:.3f} us of aot.run {out.run_us} us"
          + (f" ({100.0 * phase_sum / out.run_us:.2f} %)" if out.run_us else "")
          + f"; AotModel.run {on_us:.3f} us a call with the tracer on, {off_us:.3f} us off, {outside:.3f} us "
          f"outside the profiler in the window; {len(c_spans) / max(1, len(calls[True])):.2f} spans a request",
          file=sys.stderr, flush=True)

    # 3. stretch B: the profiler and the tracer on
    if dev.type == "cuda":
        out.b = _stretch_b(tr, cm, am, params, name, samples, part, dev, _need_by_segment(run, graph, cm))
    return out


def _stretch_b(tr, cm, am, params, name, samples, part, dev, need_by_segment) -> StretchB:
    import torch
    from repro_torch import obs

    from repro_torch.cnn.execute import params_to_torch

    tparams = params_to_torch(params, dev)  # the eager run's weights, on the card before the stretch
    stretch = Stretch(dev)
    client = []
    with torch.inference_mode(), stopping(stretch):
        stretch.start()
        obs.enable_tracing()
        # not read: the trace can miss the first device events after its start, and a first eager call
        # can launch what later ones do not
        cm.run(tparams, {name: samples[0]})
        torch.cuda.synchronize(dev)
        e0 = time.perf_counter()
        cm.run(tparams, {name: samples[0]})
        torch.cuda.synchronize(dev)
        e1 = time.perf_counter()
        while time.perf_counter() < e1 + GAP_S:
            pass
        r0 = time.perf_counter()
        i = 0
        while (t0 := time.perf_counter()) < r0 + part:
            x = {name: samples[i % POOL]}
            t1 = time.perf_counter()
            o = am.run(params, x)
            t2 = time.perf_counter()
            {k: v.cpu() for k, v in o.items()}
            t3 = time.perf_counter()
            client += [("client", t0, t1), ("AotModel.run", t1, t2), ("client output copy", t2, t3)]
            i += 1
        obs.disable_tracing()
        stretch.stop()
    t_read = time.perf_counter()
    spans = spans_of(tr.chrome_trace(), tr.epoch_s)
    tr.clear()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        stretch.prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    dt = device_trace(events, stretch.sync_perf)
    b = read_stretch_b(dt, spans, (e0, e1), (r0, stretch.t1), client, need_by_segment)
    n = len(b.matched)
    print(f"bench: stretch B, profiler and tracer on: eager run {b.eager_launches} launches, {b.eager_in_spans} "
          f"inside segment or node spans (shift {b.shift_us:.3f} us, clock error {dt.sync_error_us:.3f} us), "
          f"{len(b.sequence)} device events; {i} requests in {stretch.t1 - r0:.4f} s, the trace's device events "
          f"to {b.window[1] - r0:.4f} s: {b.replays} replays, {n} matched, "
          f"{b.replays - n} unmatched; clock check: {b.first_after_start} of {n} matched replays' first kernel "
          f"starts after their aot.replay span's start less {dt.sync_error_us:.3f} us (device events' clock "
          f"error {dt.device_error_us} us); read in {time.perf_counter() - t_read:.3f} s", file=sys.stderr, flush=True)
    for line in b.why[:TOP]:
        print(f"bench: stretch B left out: {line}", file=sys.stderr)
    print("bench: stretch B idle gaps by program span: " + json.dumps(b.idle_gaps), file=sys.stderr)
    print("bench: stretch B device by segment [segment, route, s, anchor s, epilogue s]: "
          + json.dumps(b.by_segment), file=sys.stderr, flush=True)
    return b

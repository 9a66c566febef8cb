"""``python -m repro_torch.obs`` — offline views over obs artifacts.

Four subcommands, all pure-JSON consumers (no jax, no compile):

``summarize <trace.json>``
    Aggregate a Chrome trace produced via ``MATCH_TRACE`` /
    ``obs.save_trace()``: per-(category, name) span counts and total/max
    microseconds, plus the lane inventory — a terminal answer to "where
    did compile time go" without opening Perfetto.

``drift <report.json>``
    Read a ``CompiledModel.report_dict()`` JSON (e.g. from
    ``examples/compile_cnn_match.py --json``) and print per-module
    predicted-vs-measured drift ratios from its timed segments, with a
    threshold verdict matching :mod:`repro_torch.obs.drift`.

``slo <report.json>``
    Print every registered SLO engine's burn-rate verdict from a
    ``report_dict()`` JSON's ``["obs"]["slo"]`` payload (spec, kind,
    windowed value vs threshold, ok/warn/breach state).  Exit code 1
    when any objective is breached — CI-gateable.

``flight <incident.json>``
    Summarize a flight-recorder incident dump (``MATCH_FLIGHT`` /
    ``obs.get_flight().dump()``): trigger reason + timeline, captured
    span/request volume, slowest requests, final SLO states.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from collections import defaultdict
from pathlib import Path

from .drift import drift_threshold


def _load(path: str) -> dict:
    try:
        return json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise SystemExit(f"error: cannot read {path}: {e}")


def cmd_summarize(path: str) -> int:
    doc = _load(path)
    events = doc.get("traceEvents", doc if isinstance(doc, list) else [])
    lanes: dict[tuple, str] = {}
    agg: dict[tuple, list[float]] = defaultdict(lambda: [0, 0.0, 0.0])  # n, total, max
    spans = instants = 0
    for ev in events:
        ph = ev.get("ph")
        if ph == "M" and ev.get("name") == "thread_name":
            lanes[(ev.get("pid"), ev.get("tid"))] = ev.get("args", {}).get("name", "?")
        elif ph == "X":
            spans += 1
            a = agg[(ev.get("cat", ""), ev.get("name", "?"))]
            dur = float(ev.get("dur", 0.0))
            a[0] += 1
            a[1] += dur
            if dur > a[2]:
                a[2] = dur
        elif ph == "i":
            instants += 1
    print(f"{path}: {spans} spans, {instants} instants, {len(lanes)} named lanes")
    if lanes:
        print("\nlanes:")
        for (pid, _tid), name in sorted(lanes.items(), key=lambda kv: (kv[0][0], kv[1])):
            kind = "predicted" if pid == 2 else "live"
            print(f"  [{kind:9s}] {name}")
    if agg:
        print(f"\n{'cat':<12} {'span':<28} {'count':>6} {'total_ms':>10} {'max_ms':>9}")
        for (cat, name), (n, total, mx) in sorted(
            agg.items(), key=lambda kv: -kv[1][1]
        ):
            print(f"{cat:<12} {name:<28} {n:>6} {total / 1e3:>10.3f} {mx / 1e3:>9.3f}")
    return 0


def cmd_drift(path: str) -> int:
    doc = _load(path)
    segments = doc.get("segments", [])
    timings = doc.get("timings") or [
        s.get("timing") for s in segments if isinstance(s.get("timing"), dict)
    ]
    groups: dict[str, list[float]] = defaultdict(list)
    for t in timings:
        if not isinstance(t, dict):
            continue
        hz = float(t.get("frequency_hz") or 0.0)
        predicted = float(t.get("predicted_cycles") or 0.0)
        us = float(t.get("measured_us") or 0.0)
        if hz <= 0.0 or predicted <= 0.0 or us <= 0.0:
            continue
        groups[t.get("module", "?")].append(us * 1e-6 * hz / predicted)
    if not groups:
        # report_dict only ships timings after a timed run
        print(f"{path}: no timed segments (run with timed=True / --json after a timed run)")
        return 1
    threshold = drift_threshold()
    tname = doc.get("target", "?")
    print(f"{path}: target={tname} threshold={threshold:g}x")
    print(f"\n{'module':<12} {'n':>4} {'geomean':>9} {'min':>8} {'max':>8}  verdict")
    worst = 1.0
    for module, ratios in sorted(groups.items()):
        geo = math.exp(sum(math.log(r) for r in ratios) / len(ratios))
        drifted = geo > threshold or geo < 1.0 / threshold
        if max(geo, 1.0 / geo) > max(worst, 1.0 / worst):
            worst = geo
        verdict = "DRIFTED — re-fit (python -m repro_torch.calibrate)" if drifted else "ok"
        print(
            f"{module:<12} {len(ratios):>4} {geo:>8.2f}x {min(ratios):>7.2f}x "
            f"{max(ratios):>7.2f}x  {verdict}"
        )
    return 0


def cmd_slo(path: str) -> int:
    doc = _load(path)
    payload = doc.get("obs", {}).get("slo", doc if "engines" in doc else {})
    engines = payload.get("engines", {})
    if not engines:
        print(f"{path}: no registered SLO engines (serve with ModelServer(slo=[...]))")
        return 0
    print(f"{path}: {len(engines)} SLO engine(s)")
    print(f"\n{'engine':<16} {'spec':<14} {'kind':<20} {'value':>12} "
          f"{'threshold':>10} {'burn':>6}  state")
    breached = False
    for ename, e in sorted(engines.items()):
        for sname, s in sorted(e.get("specs", {}).items()):
            state = s.get("state", "?")
            breached = breached or state == "breach"
            marker = {"ok": "", "warn": "  <- warn", "breach": "  <- BREACH"}.get(state, "")
            print(
                f"{ename:<16} {sname:<14} {s.get('kind', '?'):<20} "
                f"{s.get('value', 0.0):>12.3f} {s.get('threshold', 0.0):>10.3f} "
                f"{s.get('burn', 0.0):>5.2f}x  {state}{marker}"
            )
    print(f"\nverdict: {'BREACHED' if breached else 'ok'} "
          f"(window {next(iter(engines.values())).get('window_s', '?')}s)")
    return 1 if breached else 0


def cmd_flight(path: str) -> int:
    doc = _load(path)
    meta = doc.get("metadata", {})
    events = doc.get("traceEvents", [])
    by_ph: dict[str, int] = defaultdict(int)
    reqs: list[tuple[float, str, dict]] = []
    for ev in events:
        by_ph[ev.get("ph", "?")] += 1
        if ev.get("cat") == "serve" and ev.get("ph") == "X":
            reqs.append((float(ev.get("dur", 0.0)), ev.get("name", "?"),
                         ev.get("args", {})))
    print(f"{path}: incident dump, reason={meta.get('reason', '?')!r}")
    print(f"events: {by_ph.get('X', 0)} spans, {by_ph.get('i', 0)} instants, "
          f"{by_ph.get('C', 0)} counter samples, {by_ph.get('M', 0)} metadata")
    triggers = meta.get("triggers", [])
    if triggers:
        print(f"\ntriggers ({len(triggers)}):")
        for t in triggers[-10:]:
            print(f"  {t.get('ts_us', 0.0):>14.1f} us  {t.get('reason', '?'):<18} "
                  f"{t.get('attrs', {})}")
    if reqs:
        reqs.sort(reverse=True)
        print(f"\nslowest requests (of {len(reqs)} captured):")
        for dur, name, args in reqs[:5]:
            print(f"  {name:<10} {dur:>12.1f} us  status={args.get('status', '?')} "
                  f"priority={args.get('priority', '?')}")
    slo = meta.get("slo", {}).get("engines", {})
    for ename, e in sorted(slo.items()):
        states = {n: s.get("state") for n, s in sorted(e.get("specs", {}).items())}
        print(f"\nSLO {ename}: worst={e.get('worst_state', '?')} {states}")
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.obs", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("summarize", help="aggregate a Chrome trace JSON")
    s.add_argument("trace", help="trace file (MATCH_TRACE output)")
    d = sub.add_parser("drift", help="predicted-vs-measured drift from a report_dict JSON")
    d.add_argument("report", help="report_dict() JSON (compile_cnn_match.py --json)")
    o = sub.add_parser("slo", help="SLO burn-rate verdicts from a report_dict JSON")
    o.add_argument("report", help="report_dict() JSON carrying obs.slo")
    f = sub.add_parser("flight", help="summarize a flight-recorder incident dump")
    f.add_argument("dump", help="incident JSON (MATCH_FLIGHT / get_flight().dump())")
    args = p.parse_args(argv)
    if args.cmd == "summarize":
        return cmd_summarize(args.trace)
    if args.cmd == "slo":
        return cmd_slo(args.report)
    if args.cmd == "flight":
        return cmd_flight(args.dump)
    return cmd_drift(args.report)


if __name__ == "__main__":
    sys.exit(main())

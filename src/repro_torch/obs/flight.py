"""Incident flight recorder.

Traces answer "what happened in the run I *chose* to record"; the
flight recorder answers "what happened in the seconds *before* the
incident nobody chose".  It is an always-on set of bounded ring
buffers — recent spans (mirrored off the tracer's existing hot path
when tracing is enabled), per-request serving records, SLO evaluations
and round-level metric marks — so recording costs one ``deque.append``
of already-computed values per event and memory stays fixed no matter
how long the process serves.

:meth:`FlightRecorder.dump` writes a Perfetto-loadable incident JSON:
mirrored spans, request lanes per replica, the SLO burn-rate timeline
as counter tracks, trigger instants, plus a metadata block carrying the
trigger reason, the SLO verdicts and a metrics snapshot.  Dumps fire
automatically — rate-limited — on :class:`repro_torch.serve.QueueFullError`,
SLO breach transitions, verify divergence, or ``SIGUSR2``, whenever the
recorder is *armed* with an output path (``MATCH_FLIGHT=path`` in the
environment, or :func:`arm_flight`).  Unarmed, triggers are still
recorded in-ring (they show up in the next manual ``dump()``) but no
file is written: always-on capture, opt-in persistence.

Stdlib-only at import; anything needing sibling modules
(:func:`repro_torch.obs.slo.slo_dict`, the tracer's lane table) is imported
lazily inside :meth:`dump` so ``trace.py`` can mirror spans here
without an import cycle.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from collections import deque
from pathlib import Path

__all__ = [
    "FLIGHT_ENV",
    "FlightRecorder",
    "arm_flight",
    "disarm_flight",
    "get_flight",
]

FLIGHT_ENV = "MATCH_FLIGHT"

# ring capacities: enough for several seconds of heavy serving, small
# enough that a wedged process holds a few MB of history, not gigabytes
_SPANS = 4096
_REQUESTS = 4096
_SLO = 1024
_MARKS = 1024
_TRIGGERS = 256

# incident dumps render as their own process rows next to the tracer's
# pid 1 "match" / pid 2 "predicted" convention
_PID_SPANS = 1
_PID_SERVE = 3
_PID_SLO = 4
_PID_FLIGHT = 5


class FlightRecorder:
    """Always-on bounded capture of recent spans / requests / SLO state.

    All ``record_*`` methods are one ``deque.append`` of an
    already-built tuple (atomic under the GIL — no lock on any record
    path); the only lock guards arm/dump bookkeeping.
    """

    def __init__(
        self,
        *,
        span_capacity: int = _SPANS,
        request_capacity: int = _REQUESTS,
        min_dump_interval_s: float = 30.0,
    ):
        self._spans: deque = deque(maxlen=span_capacity)
        self._requests: deque = deque(maxlen=request_capacity)
        self._slo: deque = deque(maxlen=_SLO)
        self._marks: deque = deque(maxlen=_MARKS)
        self._triggers: deque = deque(maxlen=_TRIGGERS)
        self.path: str | None = None  # armed dump target (None = unarmed)
        self.min_dump_interval_s = float(min_dump_interval_s)
        self.dumps = 0
        self.triggers = 0
        self._last_dump = -float("inf")
        self._lock = threading.Lock()

    # -- record (hot paths: one deque.append each) -----------------------
    def record_span(self, name, cat, ts, dur, pid, tid, attrs) -> None:
        """Mirror of one tracer event (called from ``Tracer._append``)."""
        self._spans.append((name, cat, ts, dur, pid, tid, attrs))

    def record_request(
        self,
        *,
        rid: int,
        replica: str,
        arrival_us: float,
        latency_us: float,
        priority: float,
        status: str,
        batch: int = 0,
    ) -> None:
        """One served / missed / shed request, values precomputed by the
        serving layer's existing resolve bookkeeping."""
        self._requests.append(
            (rid, replica, arrival_us, latency_us, priority, status, batch)
        )

    def record_slo(
        self, t_us: float, engine: str, spec: str, state: str, value: float, burn: float
    ) -> None:
        """One SLO evaluation point (the burn-rate timeline)."""
        self._slo.append((t_us, engine, spec, state, value, burn))

    def record_mark(self, t_us: float, lane: str, **values: float) -> None:
        """A round-level metric mark (queue depth, completion counts) —
        rendered as Perfetto counter tracks in the dump."""
        self._marks.append((t_us, lane, values))

    # -- triggers --------------------------------------------------------
    def trigger(self, reason: str, **attrs) -> Path | None:
        """Record an incident trigger; auto-dump when armed.

        Always appends to the trigger ring (so even unarmed incidents
        are visible in a later manual dump).  When armed, writes the
        incident file unless one was written within
        ``min_dump_interval_s`` (a breach storm produces one dump, not
        thousands).  Returns the written path, or ``None``.
        """
        self.triggers += 1
        self._triggers.append((_now_us(), reason, attrs or None))
        with self._lock:
            path = self.path
            if path is None:
                return None
            now = time.monotonic()
            if now - self._last_dump < self.min_dump_interval_s:
                return None
            self._last_dump = now
        try:
            return self.dump(path, reason=reason)
        except OSError:  # incident capture must never take the server down
            return None

    # -- export ----------------------------------------------------------
    def chrome_trace(self, reason: str = "manual") -> dict:
        """The Perfetto-loadable incident payload."""
        from . import metrics  # lazy: keep record paths import-light

        events: list[dict] = []
        for pid, pname in (
            (_PID_SPANS, "match"),
            (2, "predicted"),
            (_PID_SERVE, "serve"),
            (_PID_SLO, "slo"),
            (_PID_FLIGHT, "flight"),
        ):
            events.append(
                {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                 "args": {"name": pname}}
            )

        # lane names for mirrored spans come from the live tracer
        try:
            from .trace import get_tracer

            tr = get_tracer()
            for lane, tid in sorted(tr._lanes.items()):
                pid = 2 if lane in tr._predicted else _PID_SPANS
                events.append(
                    {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                     "args": {"name": lane}}
                )
            for ident, tname in tr._thread_names.items():
                events.append(
                    {"ph": "M", "name": "thread_name", "pid": _PID_SPANS,
                     "tid": ident, "args": {"name": tname}}
                )
        except Exception:  # tracer state is best-effort decoration
            pass

        for name, cat, ts, dur, pid, tid, attrs in list(self._spans):
            ev: dict = {"name": name, "cat": cat or "match", "pid": pid,
                        "tid": tid, "ts": ts}
            if dur < 0.0:
                ev["ph"], ev["s"] = "i", "t"
            else:
                ev["ph"], ev["dur"] = "X", dur
            if attrs:
                ev["args"] = {k: _json_safe(v) for k, v in attrs.items()}
            events.append(ev)

        lanes: dict[str, int] = {}

        def lane_tid(pid: int, lane: str) -> int:
            key = f"{pid}:{lane}"
            tid = lanes.get(key)
            if tid is None:
                tid = lanes[key] = len(lanes) + 1
                events.append(
                    {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                     "args": {"name": lane}}
                )
            return tid

        for rid, replica, arrival, lat, priority, status, batch in list(self._requests):
            events.append(
                {"name": f"req{rid}", "cat": "serve", "ph": "X",
                 "pid": _PID_SERVE, "tid": lane_tid(_PID_SERVE, f"serve:{replica}"),
                 "ts": arrival, "dur": max(lat, 0.0),
                 "args": {"rid": rid, "priority": priority, "status": status,
                          "batch": batch}}
            )

        for t_us, engine, spec, state, value, burn in list(self._slo):
            tid = lane_tid(_PID_SLO, f"{engine}/{spec}")
            events.append(
                {"name": f"{engine}/{spec} burn", "cat": "slo", "ph": "C",
                 "pid": _PID_SLO, "tid": tid, "ts": t_us,
                 "args": {"burn": burn}}
            )
            if state != "ok":
                events.append(
                    {"name": f"{spec}:{state}", "cat": "slo", "ph": "i", "s": "t",
                     "pid": _PID_SLO, "tid": tid, "ts": t_us,
                     "args": {"value": value, "burn": burn, "state": state}}
                )

        for t_us, lane, values in list(self._marks):
            events.append(
                {"name": lane, "cat": "flight", "ph": "C",
                 "pid": _PID_FLIGHT, "tid": lane_tid(_PID_FLIGHT, lane),
                 "ts": t_us, "args": {k: _json_safe(v) for k, v in values.items()}}
            )

        triggers = []
        for t_us, t_reason, attrs in list(self._triggers):
            events.append(
                {"name": f"trigger:{t_reason}", "cat": "flight", "ph": "i",
                 "s": "g", "pid": _PID_FLIGHT, "tid": lane_tid(_PID_FLIGHT, "triggers"),
                 "ts": t_us,
                 "args": {k: _json_safe(v) for k, v in (attrs or {}).items()}}
            )
            triggers.append(
                {"ts_us": t_us, "reason": t_reason,
                 "attrs": {k: _json_safe(v) for k, v in (attrs or {}).items()}}
            )

        try:
            from .slo import slo_dict

            slo_payload = slo_dict()
        except Exception:
            slo_payload = {"engines": {}}

        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {
                "kind": "match-incident-dump",
                "reason": reason,
                "dumped_at_us": _now_us(),
                "triggers": triggers,
                "slo": slo_payload,
                "metrics": metrics.metrics_dict(),
            },
        }

    def dump(self, path: str | os.PathLike | None = None, *, reason: str = "manual") -> Path:
        """Write the incident JSON (defaults to the armed path)."""
        target = path or self.path or "incident_dump.json"
        p = Path(target).expanduser()
        if p.parent != Path("."):
            p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.chrome_trace(reason)))
        self.dumps += 1
        return p

    def clear(self) -> None:
        """Drop recorded history (tests; triggers/dump counters too)."""
        self._spans.clear()
        self._requests.clear()
        self._slo.clear()
        self._marks.clear()
        self._triggers.clear()
        self.dumps = 0
        self.triggers = 0
        self._last_dump = -float("inf")

    def __len__(self) -> int:
        return (
            len(self._spans) + len(self._requests) + len(self._slo)
            + len(self._marks) + len(self._triggers)
        )


def _now_us() -> float:
    """The tracer's timebase, so mirrored spans and flight events share
    one clock in the dump (lazy import: no cycle with trace.py)."""
    from .trace import get_tracer

    return get_tracer().now_us()


def _json_safe(v):
    if isinstance(v, (str, int, float, bool, type(None))):
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    return repr(v)


# ---------------------------------------------------------------------------
# Process-wide recorder
# ---------------------------------------------------------------------------

_RECORDER = FlightRecorder()
_signal_installed = False


def get_flight() -> FlightRecorder:
    return _RECORDER


def _install_sigusr2() -> None:
    """kill -USR2 <pid> -> incident dump, the classic wedged-server
    escape hatch.  Best-effort: only from the main thread, only where
    the platform has SIGUSR2, never twice."""
    global _signal_installed
    if _signal_installed or not hasattr(signal, "SIGUSR2"):
        return
    if threading.current_thread() is not threading.main_thread():
        return
    try:
        signal.signal(
            signal.SIGUSR2, lambda *_: _RECORDER.trigger("sigusr2")
        )
        _signal_installed = True
    except (ValueError, OSError):  # embedded interpreters may refuse
        pass


def arm_flight(path: str | os.PathLike, *, min_dump_interval_s: float | None = None) -> FlightRecorder:
    """Arm the recorder: triggers now auto-dump incident JSON to
    ``path``; also installs the ``SIGUSR2`` dump handler when possible."""
    _RECORDER.path = str(path)
    if min_dump_interval_s is not None:
        _RECORDER.min_dump_interval_s = float(min_dump_interval_s)
    _install_sigusr2()
    return _RECORDER


def disarm_flight() -> None:
    """Stop writing dump files; recording in-ring continues (always-on)."""
    _RECORDER.path = None


# MATCH_FLIGHT=path arms the recorder for the whole process.
if os.environ.get(FLIGHT_ENV):
    arm_flight(os.environ[FLIGHT_ENV])

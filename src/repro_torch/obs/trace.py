"""Structured span tracing for the compile -> run pipeline.

A deliberately tiny tracer: spans are recorded as Chrome trace-event
``"X"`` (complete) entries — name, category, microsecond timestamp +
duration, a *lane* (rendered as a thread row in Perfetto / chrome://
tracing) and an optional attribute dict.  Three lane kinds coexist in
one file, which is the whole point:

* **compile-phase spans** (``cat="compile"``) on the calling thread's
  lane: dispatch candidate enumeration, DSE flushes with cache hit/miss
  attribution, the Viterbi DP, lowering per segment, memory planning,
  AOT trace/compile;
* **measured runtime lanes** (``cat="runtime"``), one per execution
  module (``run:<module>`` for the sequential runtime,
  ``pipeline:<module>`` for the threaded one, worker thread ids in the
  args), showing where wall-clock actually went; and
* **predicted lanes** (``cat="predicted"``, via :func:`Tracer.slice` /
  :func:`trace_predicted_schedule`), the :class:`PipelineSchedule`
  Gantt converted to microseconds on each module's declared clock — so
  predicted and measured render side by side.

Zero overhead when disabled is a hard contract (enforced by
``benchmarks/obs_overhead.py``'s <=3% gate and a unit test): every
entry point checks ``tracer.enabled`` first and returns a shared
``_NULL_SPAN`` singleton — no span object, no attribute dict, no lock
is ever allocated on a disabled hot path.  When enabled, the hot path
(:meth:`Tracer.complete`) is two ``perf_counter`` reads and one
``deque.append`` (thread-safe without a lock).

Enable via ``MATCH_TRACE=path`` (auto-saves at interpreter exit) or
programmatically::

    from repro_torch import obs
    obs.enable_tracing("trace.json")
    ... compile + run ...
    obs.save_trace()            # -> Perfetto-loadable JSON
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import deque
from pathlib import Path

from . import flight as _flight

__all__ = [
    "TRACE_ENV",
    "Span",
    "Tracer",
    "disable_tracing",
    "enable_tracing",
    "get_tracer",
    "save_trace",
    "span",
    "trace_predicted_schedule",
    "tracing_enabled",
]

TRACE_ENV = "MATCH_TRACE"

# synthetic lane ids start far above real thread idents' low range is
# irrelevant — they live in their own pid row (see chrome_trace())
_PID_LIVE = 1  # real spans: compile phases + measured runtime lanes
_PID_PREDICTED = 2  # cost-model lanes (schedule Gantt)


class _NullSpan:
    """The shared do-nothing span a disabled tracer hands out.

    A singleton on purpose: the disabled hot path must not allocate
    (tested), and ``tracer.span(...) is tracer.span(...)`` holding true
    is the cheapest possible proof of that.
    """

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class Span:
    """One live span; records a Chrome ``"X"`` event on exit."""

    __slots__ = ("_tracer", "name", "cat", "lane", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, lane, attrs):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.lane = lane
        self.attrs = attrs
        self._t0 = 0.0

    def set(self, **attrs) -> "Span":
        """Attach attributes discovered mid-span (cache stats, counts)."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._t0 = self._tracer.now_us()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        tr._append(
            self.name,
            self.cat,
            self._t0,
            tr.now_us() - self._t0,
            tr._tid(self.lane),
            self.attrs,
        )
        return False


class Tracer:
    """Thread-safe span recorder exporting Chrome trace-event JSON."""

    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self.path: str | None = None
        self._events: deque = deque()  # (name, cat, ts, dur, pid, tid, attrs)
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()
        self._lanes: dict[str, int] = {}  # lane name -> synthetic tid
        self._predicted: set[str] = set()  # lanes that live in the predicted pid
        self._thread_names: dict[int, str] = {}

    # -- time ------------------------------------------------------------
    @property
    def epoch_s(self) -> float:
        """The ``time.perf_counter()`` second at which timestamps start:
        a span at ``ts`` microseconds began at ``epoch_s + ts * 1e-6`` on
        ``perf_counter``, the clock other traces (a device profile) can be
        tied to."""
        return self._epoch

    def now_us(self) -> float:
        """Microseconds since this tracer's epoch (trace timebase)."""
        return (time.perf_counter() - self._epoch) * 1e6

    # -- lanes -----------------------------------------------------------
    def _tid(self, lane: str | None) -> int:
        """Thread row for an event: the calling thread by default, a
        named synthetic lane otherwise (created on first use)."""
        if lane is None:
            ident = threading.get_ident()
            if ident not in self._thread_names:
                self._thread_names[ident] = threading.current_thread().name
            return ident
        tid = self._lanes.get(lane)
        if tid is None:
            with self._lock:
                tid = self._lanes.setdefault(lane, 1 + len(self._lanes))
        return tid

    # -- recording -------------------------------------------------------
    def _append(self, name, cat, ts, dur, tid, attrs, pid: int = _PID_LIVE) -> None:
        # deque.append is atomic under the GIL: the enabled hot path
        # never takes a lock.  The same tuple is mirrored into the
        # flight recorder's bounded ring (one more lock-free append) so
        # incident dumps carry the spans that led up to the trigger.
        ev = (name, cat, float(ts), float(dur), pid, tid, attrs)
        self._events.append(ev)
        _flight._RECORDER._spans.append(ev)

    def span(self, name: str, cat: str = "", lane: str | None = None, **attrs):
        """Context manager recording one complete span.  Returns the
        shared null singleton when disabled — callers pay one branch."""
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, cat, lane, attrs or None)

    def complete(
        self,
        name: str,
        t0_us: float,
        *,
        cat: str = "",
        lane: str | None = None,
        attrs: dict | None = None,
        end_us: float | None = None,
    ) -> None:
        """Record a span that started at ``t0_us`` (from :meth:`now_us`)
        and ends now, or at ``end_us`` — the manual begin/end pair for hot
        loops where even a context-manager frame is too much."""
        if not self.enabled:
            return
        end = self.now_us() if end_us is None else end_us
        self._append(name, cat, t0_us, end - t0_us, self._tid(lane), attrs)

    def instant(self, name: str, cat: str = "", lane: str | None = None, **attrs) -> None:
        """A zero-duration marker event (divergences, cache decisions)."""
        if not self.enabled:
            return
        self._append(name, cat, self.now_us(), -1.0, self._tid(lane), attrs or None)

    def slice(
        self,
        lane: str,
        name: str,
        ts_us: float,
        dur_us: float,
        cat: str = "predicted",
        **attrs,
    ) -> None:
        """An explicitly-timed slice on a synthetic lane — how predicted
        (cost-model) Gantt lanes are written next to measured ones."""
        if not self.enabled:
            return
        self._predicted.add(lane)
        self._append(
            name, cat, ts_us, max(dur_us, 0.0), self._tid(lane), attrs or None,
            pid=_PID_PREDICTED,
        )

    def clear(self) -> None:
        self._events.clear()

    def __len__(self) -> int:
        return len(self._events)

    # -- export ----------------------------------------------------------
    def chrome_trace(self) -> dict:
        """The Chrome trace-event / Perfetto JSON payload."""
        events: list[dict] = []
        for pid, pname in ((_PID_LIVE, "match"), (_PID_PREDICTED, "predicted")):
            events.append(
                {
                    "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "args": {"name": pname},
                }
            )
        for lane, tid in sorted(self._lanes.items()):
            pid = _PID_PREDICTED if lane in self._predicted else _PID_LIVE
            events.append(
                {
                    "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                    "args": {"name": lane},
                }
            )
        for ident, tname in self._thread_names.items():
            events.append(
                {
                    "ph": "M", "name": "thread_name", "pid": _PID_LIVE,
                    "tid": ident, "args": {"name": tname},
                }
            )
        for name, cat, ts, dur, pid, tid, attrs in list(self._events):
            ev: dict = {"name": name, "cat": cat or "match", "pid": pid, "tid": tid, "ts": ts}
            if dur < 0.0:
                ev["ph"], ev["s"] = "i", "t"
            else:
                ev["ph"], ev["dur"] = "X", dur
            if attrs:
                ev["args"] = {k: _json_safe(v) for k, v in attrs.items()}
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str | os.PathLike | None = None) -> Path:
        """Write the Chrome trace JSON; defaults to the enable-time path."""
        target = path or self.path or "match_trace.json"
        p = Path(target).expanduser()
        if p.parent != Path("."):
            p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.chrome_trace()))
        return p


def _json_safe(v):
    if isinstance(v, (str, int, float, bool, type(None))):
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    return repr(v)


# ---------------------------------------------------------------------------
# Process-wide tracer
# ---------------------------------------------------------------------------

_TRACER = Tracer()
_atexit_registered = False

# MATCH_TRACE=path in the environment turns tracing on for the whole
# process (compile + run spans accumulate) and saves at exit.
if os.environ.get(TRACE_ENV):
    _TRACER.enabled = True
    _TRACER.path = os.environ[TRACE_ENV]
    atexit.register(lambda: _TRACER.save() if _TRACER.enabled and len(_TRACER) else None)
    _atexit_registered = True


def get_tracer() -> Tracer:
    return _TRACER


def tracing_enabled() -> bool:
    return _TRACER.enabled


def enable_tracing(path: str | os.PathLike | None = None, *, autosave: bool = False) -> Tracer:
    """Turn on the process tracer; ``path`` sets the default save target.
    ``autosave=True`` registers an atexit save (what ``MATCH_TRACE``
    does) for callers that cannot reach a shutdown hook."""
    global _atexit_registered
    _TRACER.enabled = True
    if path is not None:
        _TRACER.path = str(path)
    if autosave and not _atexit_registered:
        atexit.register(
            lambda: _TRACER.save() if _TRACER.enabled and len(_TRACER) else None
        )
        _atexit_registered = True
    return _TRACER


def disable_tracing() -> None:
    _TRACER.enabled = False


def save_trace(path: str | os.PathLike | None = None) -> Path:
    return _TRACER.save(path)


def span(name: str, cat: str = "", lane: str | None = None, **attrs):
    """Module-level shorthand for ``get_tracer().span(...)``."""
    if not _TRACER.enabled:
        return _NULL_SPAN
    return Span(_TRACER, name, cat, lane, attrs or None)


# ---------------------------------------------------------------------------
# Predicted Gantt lanes
# ---------------------------------------------------------------------------


def trace_predicted_schedule(schedule, target, *, t0_us: float | None = None) -> int:
    """Write a :class:`repro_torch.pipeline.schedule.PipelineSchedule`'s Gantt
    as ``predicted:<module>`` lanes, one slice per scheduled segment,
    cycles converted to microseconds on each module's declared clock —
    so the *predicted* timeline renders side by side with the *measured*
    runtime lanes in the same Perfetto view.

    Duck-typed on purpose (``entries`` with name/module/start/finish,
    ``target.module(name).frequency_hz``): ``repro_torch.obs`` never imports
    ``repro_torch.pipeline``.  Returns the number of slices written.
    """
    tr = _TRACER
    if not tr.enabled:
        return 0
    base = tr.now_us() if t0_us is None else float(t0_us)
    n = 0
    for e in schedule.entries:
        hz = float(target.module(e.module).frequency_hz) or 1.0
        scale = 1e6 / hz  # cycles -> us on this module's clock
        tr.slice(
            f"predicted:{e.module}",
            e.name,
            base + e.start * scale,
            (e.finish - e.start) * scale,
            cycles=e.compute_cycles,
            transfer_cycles=e.transfer_cycles,
            module=e.module,
        )
        n += 1
    return n

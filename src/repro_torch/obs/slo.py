"""Declarative SLOs with burn-rate evaluation.

A :class:`SloSpec` states an objective the serving stack must hold —
"p99 latency under 2 ms", "deadline-miss rate under 1%", "queue depth
under 32" — and a :class:`SloEngine` evaluates a set of them over a
rolling window (per-interval :class:`~repro_torch.obs.sketch.WindowedSketch`
for latency, a matching counter ring for rates), driving a burn-rate
state machine per spec:

    burn = value / threshold
    ok (burn < warn_ratio)  ->  warn (warn_ratio <= burn < 1)  ->  breach

Transitions — not states — emit: entering ``warn`` or ``breach`` fires
one :class:`SloBreachWarning` through :func:`repro_torch.obs.warn` (so
``MATCH_LOG`` surfaces it and one ``pytest.warns`` clause catches it),
re-armed only by recovery; entering ``breach`` additionally fires the
engine's optional ``on_breach`` callback (how ``ModelServer`` learns to
start shedding) and a flight-recorder trigger so the incident dump
captures the window that broke.  Recovery back to ``ok`` logs quietly.

Engines register in a process-wide table; :func:`slo_dict` snapshots
them all as JSON-safe data, which ``CompiledModel.report_dict()`` merges
under ``["obs"]["slo"]``.  Stdlib-only, like the rest of ``repro_torch.obs``.

Supported spec kinds (``value`` source in parentheses):

* ``latency_p99_us`` — windowed latency sketch p99 (``record_request``);
* ``deadline_miss_rate`` — missed / completed over the window;
* ``rejection_rate`` — rejected / (completed + rejected + shed) over
  the window (``record("rejected")`` from the admission queue path);
* ``queue_depth`` — instantaneous depth passed to :meth:`evaluate`;
* ``drift_ratio`` — worst calibration drift factor for the evaluated
  target (max of geomean and its inverse across
  :func:`repro_torch.obs.drift.drift_dict` groups).

Timestamps are caller-supplied monotonic seconds (``now_s``), matching
:class:`WindowedSketch` — tests drive the clock, the serving layer
reuses the tracer timestamp it already read.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from . import flight as _flight
from .log import MatchWarning, get_logger, warn
from .sketch import WindowedSketch

__all__ = [
    "SLO_KINDS",
    "SloBreachWarning",
    "SloEngine",
    "SloSpec",
    "register_engine",
    "reset_slo",
    "slo_dict",
]

SLO_KINDS = (
    "latency_p99_us",
    "deadline_miss_rate",
    "rejection_rate",
    "queue_depth",
    "drift_ratio",
)

_OK, _WARN, _BREACH = "ok", "warn", "breach"
_RANK = {_OK: 0, _WARN: 1, _BREACH: 2}


class SloBreachWarning(MatchWarning):
    """A service objective entered ``warn`` or ``breach``.  Emitted once
    per state transition (re-armed by recovery), never per evaluation."""


@dataclass(frozen=True)
class SloSpec:
    """One declarative objective: ``kind``'s windowed value must stay
    under ``threshold``; ``warn_ratio`` is the early-warning fraction."""

    name: str
    kind: str
    threshold: float
    warn_ratio: float = 0.75
    description: str = ""

    def __post_init__(self):
        if self.kind not in SLO_KINDS:
            raise ValueError(
                f"unknown SLO kind {self.kind!r}; expected one of {SLO_KINDS}"
            )
        if self.threshold <= 0.0:
            raise ValueError(f"SLO threshold must be > 0, got {self.threshold}")
        if not 0.0 < self.warn_ratio <= 1.0:
            raise ValueError(
                f"warn_ratio must be in (0, 1], got {self.warn_ratio}"
            )

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "threshold": self.threshold,
            "warn_ratio": self.warn_ratio,
            "description": self.description,
        }


class _WindowCounts:
    """Ring of per-interval event counters, same epoch mechanics as
    :class:`WindowedSketch`: O(1) add, merge-on-read over the window."""

    __slots__ = ("_interval_s", "_intervals", "_ring", "_lock")

    def __init__(self, window_s: float, intervals: int):
        self._interval_s = window_s / intervals
        self._intervals = intervals
        self._ring: list = [None] * intervals  # slot -> (epoch, {event: n})
        self._lock = threading.Lock()

    def _epoch(self, now_s: float) -> int:
        return int(now_s / self._interval_s)

    def add(self, event: str, n: int, now_s: float) -> None:
        epoch = self._epoch(now_s)
        slot = epoch % self._intervals
        entry = self._ring[slot]
        if entry is None or entry[0] != epoch:
            with self._lock:
                entry = self._ring[slot]
                if entry is None or entry[0] != epoch:
                    entry = (epoch, {})
                    self._ring[slot] = entry
        d = entry[1]
        d[event] = d.get(event, 0) + n

    def totals(self, now_s: float) -> dict[str, int]:
        epoch = self._epoch(now_s)
        with self._lock:
            live = [e for e in self._ring if e is not None]
        out: dict[str, int] = {}
        for e_epoch, d in live:
            if epoch - self._intervals < e_epoch <= epoch:
                for k, n in d.items():
                    out[k] = out.get(k, 0) + n
        return out


class _Tracker:
    """Burn-rate state machine for one spec."""

    __slots__ = ("spec", "state", "value", "burn", "transitions", "breaches",
                 "last_change_s")

    def __init__(self, spec: SloSpec):
        self.spec = spec
        self.state = _OK
        self.value = 0.0
        self.burn = 0.0
        self.transitions = 0
        self.breaches = 0
        self.last_change_s: float | None = None

    def update(self, value: float, now_s: float) -> tuple[str, str] | None:
        """Fold one evaluation in; returns ``(old, new)`` on transition."""
        self.value = float(value)
        self.burn = self.value / self.spec.threshold
        new = (
            _BREACH if self.burn >= 1.0
            else _WARN if self.burn >= self.spec.warn_ratio
            else _OK
        )
        if new == self.state:
            return None
        old, self.state = self.state, new
        self.transitions += 1
        self.last_change_s = now_s
        if new == _BREACH:
            self.breaches += 1
        return (old, new)

    def to_dict(self) -> dict:
        return {
            **self.spec.to_dict(),
            "state": self.state,
            "value": self.value,
            "burn": self.burn,
            "transitions": self.transitions,
            "breaches": self.breaches,
            "last_change_s": self.last_change_s,
        }


class SloEngine:
    """Evaluate a set of :class:`SloSpec` over one rolling window.

    Feed it from the serving loop (:meth:`record_request`,
    :meth:`record`), call :meth:`evaluate` once per round (or on any
    cadence); read :meth:`to_dict` for the JSON-safe verdict.  All
    specs share the engine's window — per-spec windows would need one
    ring each for no observed benefit.
    """

    def __init__(
        self,
        specs,
        *,
        name: str = "slo",
        window_s: float = 60.0,
        intervals: int = 12,
        relative_accuracy: float = 0.01,
        on_breach=None,
        register: bool = True,
    ):
        specs = tuple(specs)
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO spec names: {names}")
        self.name = name
        self.window_s = float(window_s)
        self.specs = specs
        self.on_breach = on_breach
        self._sketch = WindowedSketch(
            window_s=window_s, intervals=intervals,
            relative_accuracy=relative_accuracy,
        )
        self._counts = _WindowCounts(window_s, intervals)
        self._trackers = {s.name: _Tracker(s) for s in specs}
        if register:
            register_engine(self)

    # -- feeding ---------------------------------------------------------
    def _now_s(self, now_s: float | None) -> float:
        return time.monotonic() if now_s is None else float(now_s)

    def record_request(
        self,
        latency_us: float,
        *,
        missed: bool = False,
        now_s: float | None = None,
    ) -> None:
        """One completed request: latency into the windowed sketch,
        completion (and miss) counts into the window ring.  O(1)."""
        now = self._now_s(now_s)
        self._sketch.add(latency_us, now_s=now)
        self._counts.add("completed", 1, now)
        if missed:
            self._counts.add("missed", 1, now)

    def record(self, event: str, n: int = 1, *, now_s: float | None = None) -> None:
        """Count a windowed event (``rejected``, ``shed``, ...)."""
        self._counts.add(event, n, self._now_s(now_s))

    # -- evaluation ------------------------------------------------------
    def _spec_value(self, spec, merged, totals, queue_depth, target) -> float:
        if spec.kind == "latency_p99_us":
            return merged.quantile(0.99)
        if spec.kind == "deadline_miss_rate":
            done = totals.get("completed", 0)
            return totals.get("missed", 0) / done if done else 0.0
        if spec.kind == "rejection_rate":
            rej = totals.get("rejected", 0)
            denom = totals.get("completed", 0) + totals.get("shed", 0) + rej
            return rej / denom if denom else 0.0
        if spec.kind == "queue_depth":
            return float(queue_depth or 0)
        # drift_ratio: worst multiplicative drift for this target
        from .drift import drift_dict

        worst = 1.0
        for grp in drift_dict(target).get("groups", {}).values():
            geo = grp.get("geomean_ratio") or 1.0
            worst = max(worst, geo, 1.0 / geo if geo > 0 else 1.0)
        return worst

    def evaluate(
        self,
        *,
        queue_depth: int | None = None,
        target: str | None = None,
        now_s: float | None = None,
    ) -> dict:
        """Evaluate every spec over the current window, drive the state
        machines, emit transition warnings / callbacks / flight events.
        Returns ``{spec_name: {"state", "value", "burn"}}``."""
        now = self._now_s(now_s)
        merged = self._sketch.merged(now_s=now)
        totals = self._counts.totals(now)
        fl = _flight.get_flight()
        log = get_logger("slo")
        out: dict = {}
        for spec in self.specs:
            value = self._spec_value(spec, merged, totals, queue_depth, target)
            tr = self._trackers[spec.name]
            transition = tr.update(value, now)
            fl.record_slo(now * 1e6, self.name, spec.name, tr.state, value, tr.burn)
            if transition is not None:
                old, new = transition
                if _RANK[new] > _RANK[old]:
                    warn(
                        f"SLO {self.name}/{spec.name} ({spec.kind}) "
                        f"{'BREACHED' if new == _BREACH else 'entered warn'}: "
                        f"value {value:g} vs threshold {spec.threshold:g} "
                        f"(burn {tr.burn:.2f}x) over the last "
                        f"{self.window_s:g}s window",
                        SloBreachWarning,
                        stacklevel=3,
                        logger="slo",
                    )
                else:
                    log.info(
                        "SLO %s/%s recovered to %s (value %g, burn %.2fx)",
                        self.name, spec.name, new, value, tr.burn,
                    )
                if new == _BREACH:
                    fl.trigger(
                        "slo_breach", engine=self.name, spec=spec.name,
                        kind=spec.kind, value=value, threshold=spec.threshold,
                    )
                    if self.on_breach is not None:
                        self.on_breach(spec, value)
            out[spec.name] = {"state": tr.state, "value": value, "burn": tr.burn}
        return out

    # -- export ----------------------------------------------------------
    @property
    def worst_state(self) -> str:
        states = [t.state for t in self._trackers.values()] or [_OK]
        return max(states, key=_RANK.__getitem__)

    def to_dict(self) -> dict:
        """JSON-safe verdict: last-evaluated state per spec."""
        return {
            "name": self.name,
            "window_s": self.window_s,
            "worst_state": self.worst_state,
            "breached": self.worst_state == _BREACH,
            "specs": {n: t.to_dict() for n, t in sorted(self._trackers.items())},
        }


# ---------------------------------------------------------------------------
# Process-wide registry (the report_dict()["obs"]["slo"] payload)
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_ENGINES: dict[str, SloEngine] = {}


def register_engine(engine: SloEngine) -> SloEngine:
    """Publish an engine into the process-wide table (last write wins
    per name — replica restarts re-register under the same name)."""
    with _LOCK:
        _ENGINES[engine.name] = engine
    return engine


def slo_dict() -> dict:
    """JSON-safe snapshot of every registered engine's verdict — the
    ``report_dict()["obs"]["slo"]`` payload (present even when empty,
    so report consumers never branch on a missing key)."""
    with _LOCK:
        engines = sorted(_ENGINES.items())
    out = {n: e.to_dict() for n, e in engines}
    return {
        "engines": out,
        "breached": any(d["breached"] for d in out.values()),
    }


def reset_slo() -> None:
    """Forget every registered engine (tests)."""
    with _LOCK:
        _ENGINES.clear()

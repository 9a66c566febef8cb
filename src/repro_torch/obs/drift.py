"""Predicted-vs-measured drift monitoring.

Every ``CompiledModel.run(timed=True)`` produces per-segment wall-clock
measurements next to the cost model's predicted cycles.  This module
turns that into a continuous calibration signal: each timed run feeds
:func:`observe_timings`, which aggregates a drift ratio

    measured_cycles / predicted_cycles

per ``(target, module)`` (geometric mean — drift is multiplicative, and
a 4x-over / 4x-under pair should cancel, not average to 2x).  When a
group with enough samples geo-means past the threshold (default 4.0,
``MATCH_DRIFT_THRESHOLD`` env), a :class:`CalibrationDriftWarning` fires
once per group suggesting a calibration re-fit — the
calibration loop, closed continuously instead of one-shot in CI.

The default threshold is deliberately generous: host wall-clock stands
in for modeled hardware cycles on this stack, so absolute ratios are
expected to be far from 1 until a calibration profile is fitted.
The warning is about *drift from whatever the model currently claims*,
not absolute accuracy.

Stdlib-only at import; measured cycles are computed here from
``measured_us`` + the module clock rather than via
``SegmentTiming.measured_cycles`` so observing drift never re-triggers
``UnsetFrequencyWarning`` (unset clocks are simply skipped).
"""

from __future__ import annotations

import math
import os
import threading

from .log import MatchWarning, get_logger, warn

__all__ = [
    "CalibrationDriftWarning",
    "DRIFT_THRESHOLD_ENV",
    "drift_dict",
    "drift_threshold",
    "observe_timings",
    "reset_drift",
]

DRIFT_THRESHOLD_ENV = "MATCH_DRIFT_THRESHOLD"
_DEFAULT_THRESHOLD = 4.0
_MIN_SAMPLES = 3  # don't warn off a single noisy segment


class CalibrationDriftWarning(MatchWarning):
    """Cost-model predictions have drifted from timed-run measurements
    for some (target, module) group beyond the configured threshold —
    re-fit a calibration profile."""


class _Group:
    __slots__ = ("count", "log_sum", "min_ratio", "max_ratio", "warned")

    def __init__(self):
        self.count = 0
        self.log_sum = 0.0
        self.min_ratio = math.inf
        self.max_ratio = 0.0
        self.warned = False

    def add(self, ratio: float) -> None:
        self.count += 1
        self.log_sum += math.log(ratio)
        if ratio < self.min_ratio:
            self.min_ratio = ratio
        if ratio > self.max_ratio:
            self.max_ratio = ratio

    def geomean(self) -> float:
        return math.exp(self.log_sum / self.count) if self.count else 1.0


_LOCK = threading.Lock()
_GROUPS: dict[tuple[str, str], _Group] = {}


def drift_threshold() -> float:
    """Warn when a group's geomean drift exceeds this factor (either
    direction).  ``MATCH_DRIFT_THRESHOLD`` overrides the default 4.0;
    values <= 1 are clamped to 1 (warn on any drift)."""
    raw = os.environ.get(DRIFT_THRESHOLD_ENV, "").strip()
    try:
        return max(1.0, float(raw)) if raw else _DEFAULT_THRESHOLD
    except ValueError:
        return _DEFAULT_THRESHOLD


def observe_timings(target_name: str, timings) -> int:
    """Fold one timed run's :class:`SegmentTiming` list into the
    per-(target, module) drift aggregates; warn on threshold crossings.

    ``timings`` is any iterable with ``module``, ``predicted_cycles``,
    ``measured_us`` and ``frequency_hz`` attributes (duck-typed — this
    module never imports ``repro_torch.backend``).  Segments with an unset
    clock or a zero prediction are skipped.  Returns the number of
    segments observed.
    """
    log = get_logger("drift")
    threshold = drift_threshold()
    n = 0
    to_warn: list[tuple[str, _Group]] = []
    for t in timings:
        hz = float(getattr(t, "frequency_hz", 0.0) or 0.0)
        predicted = float(getattr(t, "predicted_cycles", 0.0) or 0.0)
        measured_us = float(getattr(t, "measured_us", 0.0) or 0.0)
        if hz <= 0.0 or predicted <= 0.0 or measured_us <= 0.0:
            continue
        measured_cycles = measured_us * 1e-6 * hz
        ratio = measured_cycles / predicted
        key = (target_name, t.module)
        with _LOCK:
            g = _GROUPS.get(key)
            if g is None:
                g = _GROUPS[key] = _Group()
            g.add(ratio)
            geo = g.geomean()
            drifted = geo > threshold or geo < 1.0 / threshold
            if drifted and not g.warned and g.count >= _MIN_SAMPLES:
                g.warned = True
                to_warn.append((t.module, g))
        log.debug(
            "drift %s/%s segment=%s ratio=%.3f (measured=%.0fcy predicted=%.0fcy)",
            target_name, t.module, getattr(t, "name", "?"), ratio,
            measured_cycles, predicted,
        )
        n += 1
    for module, g in to_warn:
        warn(
            f"cost-model drift on {target_name}/{module}: measured/predicted "
            f"geomean {g.geomean():.2f}x over {g.count} segments exceeds "
            f"threshold {threshold:g}x — consider re-fitting a calibration "
            f"profile (python -m repro_torch.calibrate sweep/fit)",
            CalibrationDriftWarning,
            stacklevel=3,
            logger="drift",
        )
    return n


def drift_dict(target: str | None = None) -> dict:
    """JSON-safe snapshot of the drift aggregates: per-(target, module)
    sample count, geomean/min/max ratio and whether it warned."""
    threshold = drift_threshold()
    with _LOCK:
        items = sorted(_GROUPS.items())
    out: dict = {"threshold": threshold, "groups": {}}
    for (tname, module), g in items:
        if target is not None and tname != target:
            continue
        geo = g.geomean()
        out["groups"][f"{tname}/{module}"] = {
            "target": tname,
            "module": module,
            "count": g.count,
            "geomean_ratio": geo,
            "min_ratio": g.min_ratio if g.count else None,
            "max_ratio": g.max_ratio if g.count else None,
            "exceeds_threshold": bool(geo > threshold or geo < 1.0 / threshold),
            "warned": g.warned,
        }
    return out


def reset_drift() -> None:
    """Forget all aggregates and re-arm the once-per-group warnings."""
    with _LOCK:
        _GROUPS.clear()

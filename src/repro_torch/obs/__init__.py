"""repro_torch.obs — observability for the compile -> run -> serve pipeline.

One import surface over the observability modules:

* :mod:`repro_torch.obs.trace` — thread-safe span tracer exporting Chrome
  trace-event / Perfetto JSON, with predicted-schedule Gantt lanes
  rendered next to measured runtime lanes (``MATCH_TRACE=path``);
* :mod:`repro_torch.obs.metrics` — process-wide counters/gauges/histograms
  (DSE queries, cache hit rates, spills, per-segment latencies),
  snapshot via :func:`metrics_dict`, embedded in
  ``CompiledModel.report_dict()["obs"]``;
* :mod:`repro_torch.obs.drift` — continuous predicted-vs-measured drift
  aggregation per (target, module) with :class:`CalibrationDriftWarning`
  pointing back at the calibration loop;
* :mod:`repro_torch.obs.sketch` — mergeable DDSketch-style streaming quantile
  sketches: O(1) insert, bounded memory, relative-accuracy
  p50/p90/p99, plus the rolling-window variant the serving stack uses;
* :mod:`repro_torch.obs.slo` — declarative :class:`SloSpec` objectives
  evaluated over rolling windows with a burn-rate ok→warn→breach state
  machine, :class:`SloBreachWarning` on transitions, JSON-safe
  :func:`slo_dict` merged into ``report_dict()["obs"]["slo"]``;
* :mod:`repro_torch.obs.flight` — an always-on bounded incident flight
  recorder whose Perfetto-loadable ``dump()`` fires automatically on
  queue-full, SLO breach, verify divergence or SIGUSR2
  (``MATCH_FLIGHT=path`` arms persistence);
* :mod:`repro_torch.obs.log` — the shared ``repro_torch`` logger (``MATCH_LOG``)
  and the :class:`MatchWarning` base every repo warning derives from.

The package is stdlib-only at import time: ``repro_torch.core`` and
``repro_torch.backend`` import it at module load, so importing them back here
would cycle.  Anything needing repo types (``trace_predicted_schedule``)
is duck-typed instead.

The artifacts are the reference's formats.  CLI: ``python -m
repro_torch.obs summarize <trace.json>`` / ``drift <report.json>`` /
``slo <report.json>`` / ``flight <incident.json>``.
"""

from __future__ import annotations

from .drift import (
    DRIFT_THRESHOLD_ENV,
    CalibrationDriftWarning,
    drift_dict,
    drift_threshold,
    observe_timings,
    reset_drift,
)
from .flight import (
    FLIGHT_ENV,
    FlightRecorder,
    arm_flight,
    disarm_flight,
    get_flight,
)
from .log import LOG_ENV, MatchWarning, get_logger, log_level, warn
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    counter,
    gauge,
    histogram,
    metrics_dict,
    reset_metrics,
)
from .sketch import QuantileSketch, WindowedSketch
from .slo import (
    SLO_KINDS,
    SloBreachWarning,
    SloEngine,
    SloSpec,
    register_engine,
    reset_slo,
    slo_dict,
)
from .trace import (
    TRACE_ENV,
    Span,
    Tracer,
    disable_tracing,
    enable_tracing,
    get_tracer,
    save_trace,
    span,
    trace_predicted_schedule,
    tracing_enabled,
)

__all__ = [
    "DRIFT_THRESHOLD_ENV",
    "FLIGHT_ENV",
    "LOG_ENV",
    "SLO_KINDS",
    "TRACE_ENV",
    "CalibrationDriftWarning",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MatchWarning",
    "QuantileSketch",
    "SloBreachWarning",
    "SloEngine",
    "SloSpec",
    "Span",
    "Tracer",
    "WindowedSketch",
    "arm_flight",
    "counter",
    "disable_tracing",
    "disarm_flight",
    "drift_dict",
    "drift_threshold",
    "enable_tracing",
    "gauge",
    "get_flight",
    "get_logger",
    "get_tracer",
    "histogram",
    "log_level",
    "metrics_dict",
    "observe_timings",
    "register_engine",
    "reset_drift",
    "reset_metrics",
    "reset_slo",
    "save_trace",
    "slo_dict",
    "span",
    "trace_predicted_schedule",
    "tracing_enabled",
    "warn",
]

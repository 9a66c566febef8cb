"""CompiledModel: the deployable artifact lowering produces.

The port of ``repro.backend.runtime``.  Executes the lowered segments in
topological (dispatch) order, one fused call per segment, on the model's
device, with optional per-segment timing.  ``report()`` is the deployment
summary the paper's generated runtime prints: per-module predicted
cycles, the static memory plan, and a predicted-vs-measured table once a
timed run has happened.

Bit-exactness contract: ``run(params, inputs)`` returns exactly what
``repro_torch.cnn.execute_graph(graph, params, inputs, device="cpu")``
returns — and what ``repro.cnn.execute_graph`` returns.  ``verify``
checks it against the CPU interpreter, so on the card the comparison
never shares the conv or GEMM it is meant to check.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import torch

from repro_torch import obs
from repro_torch._device import to_tensor
from repro_torch.cnn.execute import params_to_torch
from repro_torch.core import MappedGraph
from repro_torch.obs.log import MatchWarning
from repro_torch.obs.log import warn as obs_warn

if TYPE_CHECKING:  # avoid a circular import with .lower
    from .lower import LoweredSegment
    from .memory import MemoryPlan

__all__ = [
    "CompiledModel",
    "DivergenceReport",
    "SegmentDivergence",
    "SegmentTiming",
    "UnsetFrequencyWarning",
    "as_input_array",
]

_CPU = torch.device("cpu")


def as_input_array(v, device) -> torch.Tensor:
    """Coerce one runtime input onto ``device``, *preserving* its dtype.

    Integer/quantized inputs (an int8 camera frame) reach the segment
    executors as the caller typed them; only bare Python data without a
    dtype defaults to float32.  64-bit numpy data narrows to 32 bits, as
    in the JAX reference.  A tensor already on ``device`` passes through.
    """
    return to_tensor(v, device)


def _max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.to(_CPU, torch.float64), b.to(_CPU, torch.float64)
    return float((a - b).abs().max()) if a.numel() else 0.0


class UnsetFrequencyWarning(MatchWarning, RuntimeWarning):
    """A SegmentTiming converted wall-clock to cycles with no clock set.

    ``frequency_hz`` defaults to 0.0, which silently turns every
    ``measured_cycles`` into 0 — a poisoned sample that would drag a
    calibration fit toward zero.  The conversion warns so it can never
    happen unnoticed.
    """


@dataclass(frozen=True)
class SegmentTiming:
    """Measured time for one segment of one timed run (device time from
    CUDA events on the card, host clock on the CPU)."""

    name: str
    module: str
    route: str
    predicted_cycles: float
    measured_us: float
    # the executing module's clock, so measured time converts into the
    # cycle domain the cost model predicts in
    frequency_hz: float = 0.0

    @property
    def measured_cycles(self) -> float:
        if self.frequency_hz <= 0.0:
            obs_warn(
                f"SegmentTiming[{self.name}]: frequency_hz is unset "
                f"({self.frequency_hz}); measured_cycles is 0 and would "
                "poison a calibration fit",
                UnsetFrequencyWarning,
                stacklevel=2,
                logger="runtime",
            )
            return 0.0
        return self.measured_us * 1e-6 * self.frequency_hz

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "module": self.module,
            "route": self.route,
            "predicted_cycles": self.predicted_cycles,
            "measured_us": self.measured_us,
            "frequency_hz": self.frequency_hz,
            "measured_cycles": self.measured_cycles,
        }


@dataclass(frozen=True)
class SegmentDivergence:
    """Per-segment output deviation vs the reference interpreter."""

    name: str
    module: str
    route: str
    output_name: str
    max_abs_err: float

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "module": self.module,
            "route": self.route,
            "output_name": self.output_name,
            "max_abs_err": self.max_abs_err,
        }


@dataclass(frozen=True)
class DivergenceReport:
    """Localized bit-exactness check: every segment's output compared
    against the interpreter's value for the same node, in execution
    order — so a broken kernel names itself instead of hiding behind a
    single global max-abs number."""

    max_abs_err: float
    segments: tuple[SegmentDivergence, ...]

    @property
    def exact(self) -> bool:
        return self.max_abs_err == 0.0

    @property
    def first_divergent(self) -> SegmentDivergence | None:
        """The first segment (execution order) whose output deviates —
        downstream errors are usually just this one propagating."""
        for s in self.segments:
            if s.max_abs_err > 0.0:
                return s
        return None

    def summary(self) -> str:
        first = self.first_divergent
        if first is None:
            return f"bit-exact across {len(self.segments)} segments"
        return (
            f"max |err| {self.max_abs_err}; first divergence at segment "
            f"{first.name} ({first.module}/{first.route}): "
            f"|{first.output_name} - ref| = {first.max_abs_err}"
        )

    def to_dict(self) -> dict:
        """JSON-safe payload; also what the trace instant carries when
        ``verify(per_segment=True)`` finds a deviation."""
        first = self.first_divergent
        return {
            "max_abs_err": self.max_abs_err,
            "exact": self.exact,
            "first_divergent": first.to_dict() if first is not None else None,
            "segments": [s.to_dict() for s in self.segments],
        }


@dataclass
class CompiledModel:
    """A MappedGraph lowered to fused, memory-planned segment executors
    that run on ``device``."""

    mapped: MappedGraph
    segments: list["LoweredSegment"]
    memory_plan: "MemoryPlan"
    device: torch.device
    attrs: dict = field(default_factory=dict)
    _last_timings: list[SegmentTiming] = field(default_factory=list, repr=False)
    _aot: object = field(default=None, repr=False)

    @property
    def graph(self):
        return self.mapped.graph

    @property
    def target(self):
        return self.mapped.target

    # -- execution ------------------------------------------------------
    def _timed_call(self, ls: "LoweredSegment", seg_params: dict, xs: list):
        """One steady-state call of ``ls`` and its time in microseconds:
        CUDA events around the call on the card (they replace the
        reference's ``block_until_ready``), the host clock on the CPU."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = ls.fn(seg_params, *xs)
            end.record()
            end.synchronize()
            return out, start.elapsed_time(end) * 1e3
        t0 = time.perf_counter()
        out = ls.fn(seg_params, *xs)
        return out, (time.perf_counter() - t0) * 1e6

    def run(self, params: dict, inputs: dict, *, timed: bool = False) -> dict:
        """Execute all segments in order; returns {output_name: tensor}.

        ``params`` is the reference's numpy dict or its
        :func:`~repro_torch.cnn.execute.params_to_torch` form (convert
        once to keep the weights on the device between runs).  Inputs
        keep the dtype the caller supplied.  ``timed=True`` runs each
        segment once untimed first, then times a second call and records
        a :class:`SegmentTiming` row (see ``last_timings``).
        """
        tparams = params_to_torch(params, self.device)
        env: dict[str, torch.Tensor] = {
            k: as_input_array(v, self.device) for k, v in inputs.items()
        }
        tr = obs.get_tracer()
        tracing = tr.enabled
        timings: list[SegmentTiming] = []
        for ls in self.segments:
            xs = [env[name] for name in ls.input_names]
            seg_params = ls.params_slice(tparams)
            if timed:
                ls.fn(seg_params, *xs)  # warm: the first call may build a kernel
                out, us = self._timed_call(ls, seg_params, xs)
                timings.append(
                    SegmentTiming(
                        ls.name,
                        ls.module,
                        ls.route,
                        ls.segment.cycles,
                        us,
                        frequency_hz=self.target.module(ls.module).frequency_hz,
                    )
                )
                obs.histogram(f"runtime.segment_us.{ls.module}").observe(us)
                if tracing:
                    # re-anchor the measured window onto the module lane
                    end = tr.now_us()
                    tr.complete(
                        ls.name, end - us, cat="runtime", lane=f"run:{ls.module}",
                        attrs={"route": ls.route, "predicted_cycles": ls.segment.cycles},
                    )
            elif tracing:
                t0_us = tr.now_us()
                out = ls.fn(seg_params, *xs)
                # asynchronous launch on the card: the span covers host
                # dispatch, not device compute (timed=True gives that)
                tr.complete(
                    ls.name, t0_us, cat="runtime", lane=f"run:{ls.module}",
                    attrs={"route": ls.route, "async": True},
                )
            else:
                out = ls.fn(seg_params, *xs)
            env[ls.output_name] = out
        if timed:
            self._last_timings = timings
            obs.observe_timings(self.target.name, timings)
        return {o: env[o] for o in self.graph.outputs}

    @property
    def last_timings(self) -> list[SegmentTiming]:
        return list(self._last_timings)

    def verify(self, params: dict, inputs: dict, *, per_segment: bool = False):
        """Max abs deviation vs the CPU interpreter (0.0 = bit-exact).

        ``per_segment=True`` returns a :class:`DivergenceReport` instead
        of the bare float: every segment output compared against the
        interpreter's value for that node, localizing the *first*
        deviating segment.
        """
        if per_segment:
            return self._verify_per_segment(params, inputs)
        from repro_torch.cnn.execute import execute_graph

        ref = execute_graph(self.graph, params, inputs, device=_CPU)
        got = self.run(params, inputs)
        return max((_max_abs_diff(ref[k], got[k]) for k in ref), default=0.0)

    def _verify_per_segment(self, params: dict, inputs: dict) -> DivergenceReport:
        from repro_torch.cnn.execute import apply_node

        # full CPU interpreter env: every node's reference value, not just
        # the graph outputs (segment boundaries are internal nodes)
        cpu_params = params_to_torch(params, _CPU)
        ref_env: dict[str, torch.Tensor] = {
            k: to_tensor(v, _CPU, torch.float32) for k, v in inputs.items()
        }
        for n in self.graph.nodes:
            ref_env[n.name] = apply_node(
                n, cpu_params.get(n.name, {}), [ref_env[i] for i in n.inputs]
            )
        tparams = params_to_torch(params, self.device)
        env: dict[str, torch.Tensor] = {
            k: as_input_array(v, self.device) for k, v in inputs.items()
        }
        rows: list[SegmentDivergence] = []
        worst = 0.0
        for ls in self.segments:
            out = ls.fn(ls.params_slice(tparams), *[env[nm] for nm in ls.input_names])
            env[ls.output_name] = out
            err = _max_abs_diff(ref_env[ls.output_name], out)
            worst = max(worst, err)
            rows.append(
                SegmentDivergence(ls.name, ls.module, ls.route, ls.output_name, err)
            )
        report = DivergenceReport(max_abs_err=worst, segments=tuple(rows))
        first = report.first_divergent
        if first is not None:
            obs.counter("verify.divergences").inc()
            # localizable from the trace alone: the instant carries the
            # first deviating segment and the full per-segment table
            obs.get_tracer().instant(
                f"divergence:{first.name}", cat="verify", **report.to_dict()
            )
            # a divergence is an incident: when the flight recorder is
            # armed this writes a Perfetto dump of the lead-up
            obs.get_flight().trigger(
                "verify_divergence", segment=first.name, module=first.module,
                route=first.route, max_abs_err=report.max_abs_err,
            )
        return report

    # -- accounting -----------------------------------------------------
    def predicted_cycles(self) -> float:
        return self.mapped.total_cycles()

    def predicted_latency_s(self) -> float:
        return self.mapped.latency_s()

    def cycles_by_module(self) -> dict[str, float]:
        return self.mapped.cycles_by_module()

    def fused_node_count(self) -> int:
        return sum(len(ls.segment.nodes) for ls in self.segments)

    def routes(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for ls in self.segments:
            out[ls.route] = out.get(ls.route, 0) + 1
        return out

    # -- AOT ------------------------------------------------------------
    def to_aot(self, **kw):
        """The whole-graph AOT executor for this model
        (:func:`repro_torch.backend.aot.compile_aot`): all segments
        captured in one CUDA graph on the card, bit-exact with :meth:`run`
        by construction.  Cached — repeated calls with no overrides return
        the same :class:`~repro_torch.backend.aot.AotModel`, whose stats
        then ship in ``report_dict()["aot"]``."""
        from .aot import compile_aot  # no cycle: late import

        if self._aot is None or kw:
            self._aot = compile_aot(self, **kw)
        return self._aot

    def pipeline_schedule(self):
        """The concurrent multi-module schedule of this model's mapping
        (:func:`repro_torch.pipeline.schedule.schedule_pipeline`) — per-segment
        start/finish on each module's clock and the predicted makespan.
        Pure cost-model arithmetic, computed on demand."""
        from repro_torch.pipeline.schedule import schedule_pipeline  # no cycle: late

        return schedule_pipeline(self.mapped)

    def predicted_makespan(self) -> float:
        """End-to-end cycles when modules run concurrently; equals
        ``predicted_cycles()`` exactly on single-module mappings and is
        never larger."""
        return self.pipeline_schedule().makespan

    def serve_dict(self, stream_requests: int = 4) -> dict:
        """Request-level serving predictions (:mod:`repro_torch.serve`).

        Steady-state throughput is bounded by the busiest module, not by
        end-to-end latency: once the pipeline fills, a new request
        completes every *initiation interval* = max per-module busy
        cycles.  ``stream`` carries the unit-weight
        :func:`~repro_torch.pipeline.schedule.schedule_stream` numbers for
        ``stream_requests`` concurrent requests — the quantity
        ``dispatch(..., objective="wct")`` re-ranks segmentations by.
        ``engine`` is the live :class:`~repro_torch.serve.engine.ModelServer`
        stats when a replica has served this model (else ``None``).
        """
        from repro_torch.pipeline.schedule import schedule_stream  # no cycle: late

        ps = self.pipeline_schedule()
        busy = ps.module_busy()
        ii = max(busy.values()) if busy else ps.makespan
        ss = schedule_stream(self.mapped, (1.0,) * max(1, stream_requests))
        f = self.target.fallback.frequency_hz
        return {
            "initiation_interval_cycles": ii,
            "bottleneck_module": max(busy, key=busy.get) if busy else None,
            "predicted_requests_per_s": (f / ii) if ii > 0 else 0.0,
            "predicted_stream_speedup": (ps.makespan / ii) if ii > 0 else 1.0,
            "stream": {
                "requests": int(max(1, stream_requests)),
                "makespan_cycles": ss.makespan,
                "weighted_completion_cycles": ss.attrs["weighted_completion"],
                "request_order": list(ss.attrs["request_order"]),
            },
            "engine": self.attrs.get("serve"),
        }

    def report_dict(self) -> dict:
        """Machine-readable companion of :meth:`report`: predicted cycles,
        memory plan, and any measured timings in one JSON-safe payload.
        The reference's keys plus ``device``; ``aot`` once :meth:`to_aot`
        has built one."""
        g, t = self.graph, self.target
        measured = {tm.name: tm for tm in self._last_timings}
        segments = []
        for ls in self.segments:
            seg = ls.segment
            cost = seg.schedule.cost if seg.schedule is not None else None
            row = {
                "name": ls.name,
                "module": ls.module,
                "route": ls.route,
                "pattern": seg.pattern,
                "nodes": [n.name for n in seg.nodes],
                "predicted_cycles": seg.cycles,
                "transfer_cycles": seg.transfer_cycles,
                "l_ops": cost.l_ops if cost else 0.0,
                "l_mem": cost.l_mem if cost else 0.0,
            }
            tm = measured.get(ls.name)
            if tm is not None:
                row["measured_us"] = tm.measured_us
                row["measured_cycles"] = tm.measured_cycles
            segments.append(row)
        out = {
            "graph": g.name,
            "target": t.name,
            "device": str(self.device),
            "calibration": t.attrs.get("calibration"),
            "segments": segments,
            "routes": self.routes(),
            "predicted_total_cycles": self.predicted_cycles(),
            "predicted_latency_s": self.predicted_latency_s(),
            "cycles_by_module": self.cycles_by_module(),
            "memory_plan": self.memory_plan.to_dict(),
            # Gantt-style concurrent schedule (repro_torch.pipeline):
            # per-module lanes with start/finish plus the predicted makespan
            "pipeline": self.pipeline_schedule().timeline_dict(),
            # request-level serving: steady-state initiation interval +
            # stream WCT predictions, and live replica stats once a
            # repro_torch.serve.ModelServer has served this model
            "serve": self.serve_dict(),
            "obs": {
                "metrics": obs.metrics_dict(),
                "drift": obs.drift_dict(t.name),
                "slo": obs.slo_dict(),
            },
        }
        if self._aot is not None:
            # capture cost, plan coverage, staging and measured dispatch
            # overhead of the whole-graph AOT executor
            out["aot"] = self._aot.stats()
        if measured:
            out["measured_total_us"] = sum(tm.measured_us for tm in self._last_timings)
            out["timings"] = [tm.to_dict() for tm in self._last_timings]
        return out

    def report(self) -> str:
        """Deployment report: segments, per-module cycles, memory plan,
        and predicted-vs-measured when a ``run(..., timed=True)`` exists."""
        g, t = self.graph, self.target
        lines = [
            f"CompiledModel[{g.name} on {t.name}, torch {self.device}] — "
            f"{len(self.segments)} segments / {self.fused_node_count()} nodes, "
            f"routes {self.routes()}"
        ]
        measured = {tm.name: tm for tm in self._last_timings}
        header = f"  {'segment':<28s} {'module':<9s} {'route':<11s} {'pred cyc':>12s}"
        if measured:
            header += f" {'meas us':>10s}"
        lines.append(header)
        for ls in self.segments:
            row = (
                f"  {ls.name:<28.28s} {ls.module:<9s} {ls.route:<11s}"
                f" {ls.segment.cycles:>12.0f}"
            )
            tm = measured.get(ls.name)
            if measured:
                row += f" {tm.measured_us:>10.1f}" if tm else f" {'-':>10s}"
            lines.append(row)
        mods = ", ".join(
            f"{m}={c:.0f}" for m, c in sorted(self.cycles_by_module().items())
        )
        lines.append(
            f"  predicted total {self.predicted_cycles():.0f} cycles"
            f" ({self.predicted_latency_s()*1e3:.3f} ms @ module clock): {mods}"
        )
        if measured:
            total_us = sum(tm.measured_us for tm in self._last_timings)
            clock = "CUDA events" if self.device.type == "cuda" else "host clock"
            lines.append(f"  measured {total_us:.1f} us ({clock}, torch on {self.device})")
        lines.append(self.memory_plan.report())
        return "\n".join(lines)

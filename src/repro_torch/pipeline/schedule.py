"""Event-driven concurrent scheduling of a MappedGraph (HEFT-style).

The Viterbi dispatcher minimises the *sum* of segment cycles — correct
for a runtime that executes one segment at a time, pessimal for an SoC
whose execution modules have independent job queues.  This module prices
the concurrent execution: every module is a resource with its own clock,
segments become ready when their producing segments finish, and the
**makespan** — not the cycle sum — is the predicted end-to-end latency.

The scheduling rule is deliberately a *list schedule in dispatch order*:
segments are visited in the topological order the dispatcher emitted and
each starts at ``max(module_free[its module], latest dependency
finish)``.  Two properties follow, both load-bearing for the tests:

* **Degenerate exactness** — when every segment lands on one module the
  schedule serialises and the makespan accumulates ``seg.total_cycles``
  in dispatch order, reproducing ``MappedGraph.total_cycles()`` bit for
  bit (same float additions in the same order).
* **Never worse than sequential** — by induction every segment finishes
  no later than it would in the sequential schedule, so
  ``makespan <= total_cycles()`` for every mapping.

Cross-module edges are already priced into each consumer segment's
``transfer_cycles`` (the DP charged them per consuming segment); the
scheduler charges that transfer on the consumer's module immediately
before its compute — the DMA-in serialises on the consumer, matching the
:func:`repro_torch.core.cost_model.transfer_cost` derivation.  Same-module
back-to-back segments carry ``transfer_cycles == 0`` and cost nothing
extra.  All times are in the cost model's cycle domain (module clocks
are treated as comparable, exactly as ``total_cycles()`` already does).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core import MappedGraph

__all__ = [
    "PipelineSchedule",
    "PipelineScheduleError",
    "ScheduledSegment",
    "schedule_pipeline",
    "schedule_stream",
    "segment_deps",
]

# slack tolerated by validate() before calling two intervals overlapping
# (float accumulation over a few hundred segments stays far below this)
_TOL = 1e-6


class PipelineScheduleError(RuntimeError):
    """The schedule violates a dependency or a module's serial order."""


@dataclass(frozen=True)
class ScheduledSegment:
    """One segment placed on its module's timeline."""

    index: int  # position in MappedGraph.segments (dispatch topo order)
    name: str  # anchor node name
    module: str
    start: float
    transfer_cycles: float  # input DMA charged at the start of the slot
    compute_cycles: float
    finish: float
    deps: tuple[int, ...]  # producing segment indices
    # the segment this one waited on: a dependency or the previous
    # segment on the same module (None when it starts at t=0) — walking
    # blockers from the last-finishing segment yields the critical path
    blocker: int | None = None

    def to_dict(self) -> dict:
        return {
            "index": self.index,
            "name": self.name,
            "module": self.module,
            "start": self.start,
            "finish": self.finish,
            "transfer_cycles": self.transfer_cycles,
            "compute_cycles": self.compute_cycles,
            "deps": list(self.deps),
            "blocker": self.blocker,
        }


def segment_deps(mapped: MappedGraph) -> list[tuple[int, ...]]:
    """Per-segment producing-segment indices (the segment-level DAG).

    Segment j depends on segment i when any of j's external inputs is a
    node inside i.  Graph inputs (no producing segment) impose nothing.
    """
    node_seg: dict[str, int] = {}
    for i, seg in enumerate(mapped.segments):
        for nd in seg.nodes:
            node_seg[nd.name] = i
    deps: list[tuple[int, ...]] = []
    for i, seg in enumerate(mapped.segments):
        ext = {
            node_seg[p]
            for p in seg.external_inputs(mapped.graph)
            if p in node_seg
        }
        ext.discard(i)
        deps.append(tuple(sorted(ext)))
    return deps


@dataclass
class PipelineSchedule:
    """Concurrent execution plan for one MappedGraph."""

    graph_name: str
    target_name: str
    entries: list[ScheduledSegment]
    makespan: float
    attrs: dict = field(default_factory=dict)

    # -- per-module views ------------------------------------------------
    def modules(self) -> list[str]:
        seen: dict[str, None] = {}
        for e in self.entries:
            seen.setdefault(e.module, None)
        return list(seen)

    def lanes(self) -> dict[str, list[ScheduledSegment]]:
        """Entries grouped by module, each lane sorted by start time."""
        out: dict[str, list[ScheduledSegment]] = {m: [] for m in self.modules()}
        for e in self.entries:
            out[e.module].append(e)
        for lane in out.values():
            lane.sort(key=lambda e: (e.start, e.index))
        return out

    def module_busy(self) -> dict[str, float]:
        """Cycles each module spends executing (transfer + compute)."""
        busy: dict[str, float] = {}
        for e in self.entries:
            busy[e.module] = busy.get(e.module, 0.0) + (e.finish - e.start)
        return busy

    def occupancy(self) -> dict[str, float]:
        """busy / makespan per module — 1.0 means the module never idles."""
        span = self.makespan
        if span <= 0.0:
            return {m: 0.0 for m in self.modules()}
        return {m: b / span for m, b in self.module_busy().items()}

    def sequential_cycles(self) -> float:
        """What the one-at-a-time runtime would take (== total_cycles())."""
        return sum((e.finish - e.start) for e in self.entries)

    def speedup(self) -> float:
        """Predicted sequential/concurrent ratio (1.0 = no overlap won)."""
        return self.sequential_cycles() / self.makespan if self.makespan > 0 else 1.0

    def critical_path(self) -> list[int]:
        """Segment indices of one blocking chain ending at the makespan."""
        if not self.entries:
            return []
        cur: int | None = max(
            self.entries, key=lambda e: (e.finish, e.index)
        ).index
        path: list[int] = []
        while cur is not None:
            path.append(cur)
            cur = self.entries[cur].blocker
        path.reverse()
        return path

    # -- integrity -------------------------------------------------------
    def validate(self) -> None:
        """Raise PipelineScheduleError on dependency or overlap violations."""
        finish = {e.index: e.finish for e in self.entries}
        for e in self.entries:
            if e.start < -_TOL or e.finish < e.start - _TOL:
                raise PipelineScheduleError(f"segment {e.name}: bad interval")
            for d in e.deps:
                if e.start < finish[d] - _TOL:
                    raise PipelineScheduleError(
                        f"segment {e.name} starts at {e.start} before its "
                        f"dependency (segment {d}) finishes at {finish[d]}"
                    )
        for module, lane in self.lanes().items():
            for a, b in zip(lane, lane[1:]):
                if b.start < a.finish - _TOL:
                    raise PipelineScheduleError(
                        f"module {module}: segments {a.name} and {b.name} overlap"
                    )

    # -- reporting -------------------------------------------------------
    def timeline_dict(self) -> dict:
        """Gantt-style JSON payload (ships in CompiledModel.report_dict)."""
        occ = self.occupancy()
        busy = self.module_busy()
        return {
            "graph": self.graph_name,
            "target": self.target_name,
            "makespan_cycles": self.makespan,
            "sequential_cycles": self.sequential_cycles(),
            "speedup": self.speedup(),
            "critical_path": [self.entries[i].name for i in self.critical_path()],
            "modules": {
                m: {
                    "busy_cycles": busy.get(m, 0.0),
                    "occupancy": occ.get(m, 0.0),
                    "segments": [e.to_dict() for e in lane],
                }
                for m, lane in self.lanes().items()
            },
        }

    def gantt(self, width: int = 64) -> str:
        """ASCII Gantt chart, one lane per module."""
        span = max(self.makespan, 1e-9)
        lines = [
            f"PipelineSchedule[{self.graph_name} on {self.target_name}] "
            f"makespan {self.makespan:.0f} cyc "
            f"(sequential {self.sequential_cycles():.0f}, "
            f"{self.speedup():.2f}x)"
        ]
        occ = self.occupancy()
        for module, lane in self.lanes().items():
            row = ["."] * width
            for e in lane:
                lo = min(width - 1, int(e.start / span * width))
                hi = min(width, max(lo + 1, int(e.finish / span * width)))
                for p in range(lo, hi):
                    row[p] = "#"
            lines.append(
                f"  {module:<10s} |{''.join(row)}| "
                f"{len(lane):3d} seg, {100.0 * occ.get(module, 0.0):5.1f}% busy"
            )
        return "\n".join(lines)


def schedule_pipeline(mapped: MappedGraph) -> PipelineSchedule:
    """List-schedule ``mapped`` concurrently across its target's modules."""
    segments = mapped.segments
    deps = segment_deps(mapped)
    finish: list[float] = [0.0] * len(segments)
    module_free: dict[str, float] = {}
    module_last: dict[str, int] = {}
    entries: list[ScheduledSegment] = []
    for i, seg in enumerate(segments):
        ready = 0.0
        blocker: int | None = None
        prev = module_last.get(seg.module)
        if prev is not None:
            ready = module_free[seg.module]
            blocker = prev
        for d in deps[i]:
            if finish[d] > ready:
                ready = finish[d]
                blocker = d
        start = ready
        # one accumulation per segment, in dispatch order — the exact
        # float sum total_cycles() computes in the single-module case
        fin = start + seg.total_cycles
        finish[i] = fin
        module_free[seg.module] = fin
        module_last[seg.module] = i
        entries.append(
            ScheduledSegment(
                index=i,
                name=seg.anchor.name,
                module=seg.module,
                start=start,
                transfer_cycles=seg.transfer_cycles,
                compute_cycles=seg.cycles,
                finish=fin,
                deps=deps[i],
                blocker=blocker,
            )
        )
    return PipelineSchedule(
        graph_name=mapped.graph.name,
        target_name=mapped.target.name,
        entries=entries,
        makespan=max(finish, default=0.0),
        attrs={"policy": "list-topo"},
    )


def schedule_stream(
    mapped: MappedGraph,
    weights: tuple[float, ...] | list[float] = (1.0,),
    *,
    order: str = "smith",
) -> PipelineSchedule:
    """Schedule a *stream* of requests through the pipeline, minimising
    weighted completion time instead of single-input makespan.

    ``weights`` gives one priority weight per request (all requests run
    the same graph, so every job has identical processing time).  Under
    ``order="smith"`` requests enter the per-module lanes in
    weight-descending order — Smith's rule, optimal for
    ``1 | | sum w_j C_j`` with identical jobs — so a high-priority
    request jumps the lane order of every module without ever violating
    happens-before: its own segment dependencies still gate each start,
    and the schedule stays a valid :class:`PipelineSchedule`
    (``validate()`` checks both).  ``order="fifo"`` keeps arrival order,
    the baseline the serving tests compare against.

    The result's ``attrs`` carry the serving-side economics:
    ``completion`` (per-request completion cycles, keyed by the original
    request position), ``weighted_completion`` (``sum w_r * C_r`` — the
    quantity ``dispatch(..., objective="wct")`` re-ranks segmentations
    by), and ``request_order`` (the lane order chosen).  With one
    unit-weight request this reproduces :func:`schedule_pipeline`'s
    makespan bit for bit (same float accumulations in the same order).
    """
    if order not in ("smith", "fifo"):
        raise ValueError(f"unknown stream order {order!r} (smith | fifo)")
    ws = [float(w) for w in weights]
    if not ws:
        raise ValueError("schedule_stream needs at least one request weight")
    if any(w < 0 for w in ws):
        raise ValueError(f"request weights must be >= 0, got {ws}")
    if order == "smith":
        # identical processing times: Smith's w/p ratio collapses to the
        # weight; arrival position breaks ties so equal-priority requests
        # keep FIFO fairness
        req_order = sorted(range(len(ws)), key=lambda r: (-ws[r], r))
    else:
        req_order = list(range(len(ws)))

    segments = mapped.segments
    deps = segment_deps(mapped)
    entries: list[ScheduledSegment] = []
    finish: dict[tuple[int, int], float] = {}
    gidx: dict[tuple[int, int], int] = {}
    module_free: dict[str, float] = {}
    module_last: dict[str, int] = {}
    completion: dict[int, float] = {}
    for r in req_order:
        done_r = 0.0
        for i, seg in enumerate(segments):
            ready = 0.0
            blocker: int | None = None
            prev = module_last.get(seg.module)
            if prev is not None:
                ready = module_free[seg.module]
                blocker = prev
            for d in deps[i]:
                if finish[(r, d)] > ready:
                    ready = finish[(r, d)]
                    blocker = gidx[(r, d)]
            fin = ready + seg.total_cycles
            gi = len(entries)
            finish[(r, i)] = fin
            gidx[(r, i)] = gi
            module_free[seg.module] = fin
            module_last[seg.module] = gi
            done_r = max(done_r, fin)
            entries.append(
                ScheduledSegment(
                    index=gi,
                    name=f"{seg.anchor.name}@r{r}",
                    module=seg.module,
                    start=ready,
                    transfer_cycles=seg.transfer_cycles,
                    compute_cycles=seg.cycles,
                    finish=fin,
                    deps=tuple(gidx[(r, d)] for d in deps[i]),
                    blocker=blocker,
                )
            )
        completion[r] = done_r
    return PipelineSchedule(
        graph_name=f"{mapped.graph.name}x{len(ws)}",
        target_name=mapped.target.name,
        entries=entries,
        makespan=max(finish.values(), default=0.0),
        attrs={
            "policy": f"stream-{order}",
            "weights": ws,
            "request_order": req_order,
            "completion": {str(r): c for r, c in sorted(completion.items())},
            "weighted_completion": sum(
                ws[r] * completion[r] for r in range(len(ws))
            ),
        },
    )

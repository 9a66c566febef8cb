"""Static memory planning for compiled MappedGraphs (paper Sec. IV-C).

MATCH ships ``static_mem_plan``: every inter-segment activation gets a
fixed offset in a flat arena sized at compile time, so the generated C
never calls malloc.  This module reproduces that design over the repro_torch
graph IR:

* **Liveness** — each segment output (and each graph input) is a buffer
  live from the segment that produces it to the last segment that reads
  it; chain-internal tensors never materialize (that is the fusion win).
* **Offset assignment** — first-fit into a flat arena at the target's
  shared home level (L2 on the MCUs), then a bounded hill-climb over the
  allocation order, keeping any permutation that shrinks the arena peak —
  the same shape as the real repo's hill-climb allocator.
* **Validation** — per-segment L1 working sets are recomputed from each
  segment's winning schedule via
  :func:`repro_torch.core.cost_model.tile_working_set` and checked against the
  module's declared ``MemoryLevel`` capacities: exactly the constraint the
  LOMA DSE priced, re-enforced at deployment time.  A segment whose
  working set no longer fits (e.g. after an L1-rescaling ablation) either
  raises :class:`MemoryPlanError` or is recorded as a *spill* — it streams
  from the home level instead of running tiled-resident.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from repro_torch import obs
from repro_torch.core import MappedGraph, tile_working_set

__all__ = [
    "ArenaView",
    "BufferAlloc",
    "MemoryPlan",
    "MemoryPlanError",
    "plan_memory",
]


class MemoryPlanError(RuntimeError):
    """A buffer or working set exceeds a declared MemoryLevel capacity."""


@dataclass(frozen=True)
class BufferAlloc:
    """One planned activation buffer in the home-level arena."""

    name: str
    nbytes: int
    offset: int
    # live interval, [start, end): segment indices in the sequential
    # plan, schedule times (cycles) in the pipeline-aware plan — the
    # packer and the overlap checks only ever compare them
    start: float
    end: float

    def overlaps_time(self, other: "BufferAlloc") -> bool:
        return not (self.end <= other.start or other.end <= self.start)

    def overlaps_space(self, other: "BufferAlloc") -> bool:
        return not (
            self.offset + self.nbytes <= other.offset
            or other.offset + other.nbytes <= self.offset
        )


@dataclass(frozen=True)
class ArenaView:
    """The home-level byte arena re-addressed for a fixed-width runtime.

    The plan's offsets are byte-addressed with each buffer's declared
    ``elem_bytes``; the jax host runtime materializes every tensor at a
    uniform ``elem_bytes`` (float32 = 4).  Scaling *every* byte
    coordinate by that width — i.e. reading each planned byte offset as
    an element offset — preserves the first-fit/hill-climb layout and
    the pairwise-disjointness proof verbatim: buffer b's byte interval
    ``[off, off+nbytes)`` becomes the element interval of the same
    numbers, and a tensor of ``nbytes / declared_width`` elements always
    fits inside it because declared widths are >= 1 byte.  The cost is
    up to ``elem_bytes``x the modeled footprint, paid in *host* memory
    only — the byte plan (what deployment validates against the declared
    capacities) is untouched.
    """

    home_level: str
    length_elems: int  # arena length, in runtime elements
    elem_bytes: int
    offsets: dict[str, int]  # buffer -> element offset (== planned byte offset)
    capacities_elems: dict[str, int]  # buffer -> element capacity (== nbytes)


@dataclass
class MemoryPlan:
    """Static allocation result for one MappedGraph."""

    graph_name: str
    target_name: str
    home_level: str
    buffers: dict[str, BufferAlloc]
    arena_bytes: dict[str, int]  # level name -> bytes the plan needs there
    capacities: dict[str, int]  # level name -> declared size_bytes
    l1_by_segment: list[dict[str, int]]  # per segment: level -> working set
    weight_bytes: int = 0
    spills: tuple[str, ...] = ()
    attrs: dict = field(default_factory=dict)

    @property
    def fits(self) -> bool:
        return all(self.arena_bytes[l] <= self.capacities[l] for l in self.arena_bytes)

    @property
    def home_total_bytes(self) -> int:
        """Arena + resident weights: the deployability number of the
        paper's Table III OoM criterion."""
        return self.arena_bytes.get(self.home_level, 0) + self.weight_bytes

    def validate(self) -> None:
        """Raise MemoryPlanError on any per-level capacity overflow."""
        bad = [
            f"{l}: {self.arena_bytes[l]} > {self.capacities[l]} bytes"
            for l in self.arena_bytes
            if self.arena_bytes[l] > self.capacities[l]
        ]
        if bad:
            raise MemoryPlanError(
                f"{self.graph_name} on {self.target_name}: " + "; ".join(bad)
            )

    def check_no_overlap(self) -> bool:
        """Planner self-check: no two live-range-overlapping buffers share
        arena bytes (used by the tests)."""
        allocs = list(self.buffers.values())
        for i, a in enumerate(allocs):
            for b in allocs[i + 1 :]:
                if a.overlaps_time(b) and a.overlaps_space(b):
                    return False
        return True

    def arena_view(self, elem_bytes: int = 4) -> ArenaView:
        """The plan's home arena re-addressed for a uniform-width runtime
        (see :class:`ArenaView`) — what the whole-graph AOT executor
        (``repro_torch.backend.aot``, ``memory="arena"``) threads through the
        jitted program so the first-fit/hill-climb offsets survive into
        the executable instead of being re-derived by XLA."""
        return ArenaView(
            home_level=self.home_level,
            length_elems=self.arena_bytes.get(self.home_level, 0),
            elem_bytes=int(elem_bytes),
            offsets={n: b.offset for n, b in self.buffers.items()},
            capacities_elems={n: b.nbytes for n, b in self.buffers.items()},
        )

    def aliasing_summary(self) -> dict:
        """The plan's buffer-aliasing decisions, summarized: how many
        buffer pairs share home-arena bytes (lifetimes disjoint, offsets
        overlapping) and how many bytes that reuse saves over a
        no-aliasing layout — the number the AOT donation-coverage report
        compares XLA's own buffer assignment against."""
        allocs = list(self.buffers.values())
        pairs = 0
        for i, a in enumerate(allocs):
            for b in allocs[i + 1 :]:
                if a.overlaps_space(b) and not a.overlaps_time(b):
                    pairs += 1
        total = sum(a.nbytes for a in allocs)
        peak = self.arena_bytes.get(self.home_level, 0)
        return {
            "aliased_pairs": pairs,
            "sum_buffer_bytes": total,
            "arena_peak_bytes": peak,
            "bytes_saved_by_aliasing": max(0, total - peak),
        }

    def to_dict(self) -> dict:
        """JSON-safe summary (consumed by ``CompiledModel.report_dict``)."""
        return {
            "graph": self.graph_name,
            "target": self.target_name,
            "home_level": self.home_level,
            "arena_bytes": dict(self.arena_bytes),
            "capacities": dict(self.capacities),
            "weight_bytes": self.weight_bytes,
            "home_total_bytes": self.home_total_bytes,
            "fits": self.fits,
            "spills": list(self.spills),
            "buffers": {
                name: {
                    "nbytes": b.nbytes,
                    "offset": b.offset,
                    "start": b.start,
                    "end": b.end,
                }
                for name, b in sorted(self.buffers.items())
            },
        }

    def report(self) -> str:
        lines = [f"MemoryPlan[{self.graph_name} on {self.target_name}]"]
        for lvl in sorted(self.arena_bytes):
            used, cap = self.arena_bytes[lvl], self.capacities[lvl]
            kind = "arena" if lvl == self.home_level else "peak working set"
            flag = "" if used <= cap else "  ** OVERFLOW **"
            lines.append(
                f"  {lvl:<8s} {kind:<17s} {used:>9d} B / {cap:>9d} B"
                f" ({100.0 * used / max(cap, 1):5.1f}%){flag}"
            )
        lines.append(
            f"  {self.home_level:<8s} + resident weights {self.weight_bytes} B"
            f" -> total {self.home_total_bytes} B"
        )
        if self.spills:
            lines.append(f"  spilled segments (stream from {self.home_level}): "
                         + ", ".join(self.spills))
        lines.append(f"  {len(self.buffers)} planned buffers, fits={self.fits}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Offset assignment: first-fit + hill-climb over the allocation order
# ---------------------------------------------------------------------------


def _first_fit(
    order: list[str],
    lives: dict[str, tuple[int, float, float]],
    conflicts=None,
) -> tuple[dict[str, int], int]:
    """Place buffers in ``order``; returns (offsets, arena peak bytes).

    Two buffers may share arena bytes unless they *conflict*.  The
    default relation is live-interval overlap (sound for the sequential
    plan, where intervals are segment indices and execution follows
    them); the pipeline plan passes an explicit happens-before-based
    predicate instead, because the concurrent runtime is dependency-
    driven and predicted schedule times carry no execution guarantee.
    """
    if conflicts is None:
        def conflicts(a: str, b: str) -> bool:
            _, s1, e1 = lives[a]
            _, s2, e2 = lives[b]
            return not (e1 <= s2 or e2 <= s1)

    placed: list[tuple[str, int, int]] = []  # (name, offset, nbytes)
    offsets: dict[str, int] = {}
    peak = 0
    for name in order:
        nb = lives[name][0]
        spans = sorted(
            (o, o + n) for nm, o, n in placed if conflicts(name, nm)
        )
        off = 0
        for lo, hi in spans:
            if off + nb <= lo:
                break
            off = max(off, hi)
        offsets[name] = off
        placed.append((name, off, nb))
        peak = max(peak, off + nb)
    return offsets, peak


def _hill_climb(
    order: list[str],
    lives: dict[str, tuple[int, float, float]],
    iters: int,
    seed: int,
    conflicts=None,
    stats: dict | None = None,
) -> tuple[dict[str, int], int]:
    """Bounded stochastic hill-climb over the first-fit allocation order.

    ``stats`` (optional out-param, so the return shape stays a 2-tuple
    for existing callers) receives iteration/improvement counts and the
    first-fit baseline peak for the trace.
    """
    rng = random.Random(seed)
    best_order = list(order)
    best_offsets, best_peak = _first_fit(best_order, lives, conflicts)
    if stats is not None:
        stats.update(iters=0, improvements=0, first_fit_peak=best_peak)
    if len(order) < 2:
        return best_offsets, best_peak
    improvements = 0
    for it in range(iters):
        i, j = rng.sample(range(len(best_order)), 2)
        cand = list(best_order)
        cand[i], cand[j] = cand[j], cand[i]
        offsets, peak = _first_fit(cand, lives, conflicts)
        if peak < best_peak:
            best_order, best_offsets, best_peak = cand, offsets, peak
            improvements += 1
    if stats is not None:
        stats.update(iters=iters, improvements=improvements)
    return best_offsets, best_peak


# ---------------------------------------------------------------------------
# Pipeline-aware liveness (repro_torch.pipeline)
# ---------------------------------------------------------------------------


def _schedule_preds(schedule) -> list[set[int]]:
    """preds[j]: direct predecessors the pipelined runtime enforces for
    segment j — data dependencies (futures) plus per-module lane order
    (each module's worker walks its lane in order).  Both edge kinds
    point from lower to higher segment index."""
    entries = sorted(schedule.entries, key=lambda e: e.index)
    preds = [set(e.deps) for e in entries]
    for lane in schedule.lanes().values():
        for a, b in zip(lane, lane[1:]):
            preds[b.index].add(a.index)
    return preds


def _virtual_times(schedule) -> tuple[dict[int, float], dict[int, float]]:
    """Order-respecting (start, finish) per segment for liveness intervals.

    Predicted schedule times can *tie*: a zero-duration structural
    segment starts and finishes at the same timestamp as whatever its
    lane runs next, so raw times cannot express "n01s is dead before
    n03t begins" even when the runtime guarantees it.  Virtual times
    repair exactly that: each segment starts no earlier than every
    enforced predecessor's virtual finish and occupies at least one
    cycle, so runtime-ordered segments always get disjoint half-open
    intervals while genuinely concurrent ones keep their overlap.
    """
    start = {e.index: e.start for e in schedule.entries}
    finish = {e.index: e.finish for e in schedule.entries}
    preds = _schedule_preds(schedule)
    vstart: dict[int, float] = {}
    vfinish: dict[int, float] = {}
    for j in sorted(start):
        s = max([start[j]] + [vfinish[p] for p in preds[j]])
        vstart[j] = s
        # a zero-cost structural slot still needs its buffer for a moment
        vfinish[j] = max(finish[j], s + 1.0)
    return vstart, vfinish


def _pipeline_lives(
    seq_lives: dict,
    mapped: MappedGraph,
    schedule,
    stream_depth: int,
) -> dict:
    """Re-express buffer liveness on the pipeline schedule's timeline.

    A buffer is live from its producing segment's *start* (the executor
    materializes the output during the slot) to its last consumer's
    *finish*; graph inputs are live from t=0, graph outputs to past the
    makespan.  Segments the scheduler overlaps therefore conflict in the
    arena even when their sequential segment indices would not.  With
    ``stream_depth`` > 1 every buffer gets one rotating copy per extra
    in-flight input (``name@q1``...), all sharing the interval — the
    steady-state inter-stage queues of ``run_stream``.

    Endpoints are the ``_virtual_times`` of the producing/consuming
    segments, which embeds the runtime's happens-before order into the
    intervals: whenever ``_pipeline_conflict_fn`` lets X and Y alias (X
    provably dead before Y's producer P starts), every user of X
    precedes P, so X's virtual end <= P's virtual start and the
    half-open intervals are disjoint.  Interval overlap is therefore a
    sound over-approximation of the aliasing relation — the planner's
    ``check_no_overlap`` self-check can never contradict a sound offset
    assignment (a fuzz-found defect of the raw-timestamp intervals).
    """
    graph, segments = mapped.graph, mapped.segments
    vstart, vfinish = _virtual_times(schedule)
    horizon = max([schedule.makespan, 1.0, *vfinish.values()])
    node_seg = {nd.name: i for i, seg in enumerate(segments) for nd in seg.nodes}
    consumed_by: dict[str, list[int]] = {}
    for i, seg in enumerate(segments):
        for src in seg.external_inputs(graph):
            consumed_by.setdefault(src, []).append(i)
    outputs = set(graph.outputs)
    out: dict[str, tuple[int, float, float]] = {}
    for name, (nb, _s, _e) in seq_lives.items():
        prod_seg = node_seg.get(name)
        t0 = 0.0 if prod_seg is None else vstart[prod_seg]
        ends = [vfinish[c] for c in consumed_by.get(name, [])]
        if prod_seg is not None:
            ends.append(vfinish[prod_seg])
        t1 = (horizon + 1.0) if name in outputs else max(ends, default=t0)
        for q in range(stream_depth):
            out[name if q == 0 else f"{name}@q{q}"] = (nb, t0, t1)
    return out


def _happens_before(schedule) -> list[set[int]]:
    """before[j]: segment indices guaranteed complete before segment j
    starts at RUNTIME.

    The pipelined runtime enforces exactly two orderings: data
    dependencies (futures) and per-module lane serialisation
    (``_schedule_preds``).  Predicted schedule *times* guarantee
    nothing — host wall-clock is unrelated to modeled cycles — so
    soundness arguments must use this relation, never the intervals.
    Both edge kinds point from lower to higher segment index, so one
    pass in index order closes the relation transitively.
    """
    preds = _schedule_preds(schedule)
    before: list[set[int]] = [set() for _ in preds]
    for j in range(len(preds)):
        for p in preds[j]:
            before[j] |= before[p]
            before[j].add(p)
    return before


def _pipeline_conflict_fn(mapped: MappedGraph, before: list[set[int]]):
    """Happens-before-based buffer conflict relation for the concurrent
    plan: buffers X and Y may share arena bytes only when one is
    provably dead (all its users complete) before the other's producer
    can start.  Rotating stream copies (``name@qN``) belong to different
    in-flight inputs, between which no ordering exists: cross-slot pairs
    always conflict; same-slot pairs belong to the same input and use
    the happens-before rule."""
    graph, segments = mapped.graph, mapped.segments
    users: dict[str, set[int]] = {name: set() for name in graph.inputs}
    producer: dict[str, int] = {}
    for i, seg in enumerate(segments):
        out = seg.output_node.name
        users[out] = {i}
        producer[out] = i
    for i, seg in enumerate(segments):
        for src in seg.external_inputs(graph):
            if src in users:
                users[src].add(i)
    eternal = set(graph.outputs)

    def split(n: str) -> tuple[str, int]:
        base, sep, q = n.rpartition("@q")
        if sep and q.isdigit():
            return base, int(q)
        return n, 0

    def dead_before(base: str, q) -> bool:
        if q is None or base in eternal:
            return False
        return all(u in before[q] for u in users.get(base, ()))

    def conflicts(a: str, b: str) -> bool:
        ba, qa = split(a)
        bb, qb = split(b)
        if qa != qb:
            return True
        return not (
            dead_before(ba, producer.get(bb)) or dead_before(bb, producer.get(ba))
        )

    return conflicts


def _concurrent_level_peaks(
    segments,
    usages: list[dict[str, int]],
    before: list[set[int]],
    stream_depth: int,
) -> dict[str, int]:
    """Per-level peak working-set bytes under concurrent execution.

    Levels are keyed by name, exactly as ``level_caps``/``level_peaks``
    are: two modules declaring the same level name share the physical
    memory (gap9 declares one ``L1`` object for cluster and NE16).  At
    any instant each module runs at most one segment (lanes are
    serial), so the resident set is one working set per module.

    * ``stream_depth == 1`` — happens-before bound: for each segment i,
      charge i's working set plus, per *other* module, the largest
      working set among segments unordered with i (those are the only
      ones the runtime could co-schedule).  This dominates every
      realisable antichain: if A is the worst concurrent set and i its
      largest member, every other member of A is unordered with i and
      counted at (or below) its module's max.
    * ``stream_depth > 1`` — steady-state streaming bound: segments of
      different in-flight inputs have no ordering at all, so each
      level's peak is the sum over modules of that module's largest
      working set.
    """
    per_mod: dict[str, dict[str, int]] = {}
    for i, u in enumerate(usages):
        m = segments[i].module
        for lvl, b in u.items():
            d = per_mod.setdefault(lvl, {})
            d[m] = max(d.get(m, 0), b)
    if stream_depth > 1:
        return {lvl: sum(d.values()) for lvl, d in per_mod.items()}

    def unordered(i: int, j: int) -> bool:
        return i not in before[j] and j not in before[i]

    peaks: dict[str, int] = {}
    for i, ui in enumerate(usages):
        for lvl, b in ui.items():
            co: dict[str, int] = {}
            for j, uj in enumerate(usages):
                if j == i or segments[j].module == segments[i].module:
                    continue  # lane-serialised with i's module
                if lvl in uj and unordered(i, j):
                    m = segments[j].module
                    co[m] = max(co.get(m, 0), uj[lvl])
            peaks[lvl] = max(peaks.get(lvl, 0), b + sum(co.values()))
    return peaks


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def plan_memory(
    mapped: MappedGraph,
    *,
    allow_spill: bool = True,
    hill_climb_iters: int = 200,
    seed: int = 0,
    schedule=None,
    stream_depth: int = 1,
) -> MemoryPlan:
    """Plan static memory for ``mapped``'s segment execution order.

    ``schedule`` (a :class:`repro_torch.pipeline.schedule.PipelineSchedule`)
    switches the plan to *concurrent-execution* semantics: two buffers
    may share arena bytes only when one provably dies before the other
    is born under what the pipelined runtime actually enforces — data
    dependencies plus per-module lane order (``_happens_before``), never
    the predicted schedule times (host wall-clock owes them nothing).
    Working sets of modules sharing a level by name are summed over
    co-schedulable segments, spilling the largest contributor on
    overflow.  ``stream_depth`` > 1 (``PipelinedModel.run_stream``)
    additionally reserves one rotating queue copy per in-flight input
    for every buffer (``name@q1`` ...), the double-buffered inter-stage
    queues of classic software pipelining; cross-input pairs always
    conflict and shared levels charge every module's maximum at once.
    """
    graph, target = mapped.graph, mapped.target
    segments = mapped.segments
    n = len(segments)
    home = target.fallback.memories[-1]
    if stream_depth < 1:
        raise ValueError(f"stream_depth must be >= 1, got {stream_depth}")
    if stream_depth > 1 and schedule is None:
        raise ValueError("stream_depth > 1 needs the pipeline schedule")

    # ---- liveness over the segment order --------------------------------
    # (nbytes, start, end); graph inputs are live from the start, graph
    # outputs to the end.  Start/end are segment indices in the
    # sequential plan and schedule times (cycles) in the pipeline plan —
    # the packer below only ever compares them.
    lives: dict[str, tuple[int, float, float]] = {}
    consumer_elem = {
        name: max(
            (int(c.attr("elem_bytes", 1) or 1) for c in graph.consumers(name)),
            default=1,
        )
        for name in graph.inputs
    }
    for name, shape in graph.inputs.items():
        nb = consumer_elem[name]
        for d in shape:
            nb *= int(d)
        lives[name] = (max(nb, 1), 0, 1)
    for i, seg in enumerate(segments):
        out = seg.output_node
        # edge_bytes (not output_bytes) so structural segment outputs
        # (reshape, ...) are sized by the tensor flowing through them
        lives[out.name] = (max(graph.edge_bytes(out.name), 1), i, i + 1)
    for i, seg in enumerate(segments):
        for src in seg.external_inputs(graph):
            if src in lives:
                nb, s, _ = lives[src]
                lives[src] = (nb, s, max(lives[src][2], i + 1))
    for o in graph.outputs:
        if o in lives:
            nb, s, _ = lives[o]
            lives[o] = (nb, s, n + 1)

    plan_attrs: dict = {"hill_climb_iters": hill_climb_iters}
    conflict_fn = None
    before: list[set[int]] = []
    if schedule is not None:
        lives = _pipeline_lives(lives, mapped, schedule, stream_depth)
        # aliasing decisions must follow what the dependency-driven
        # runtime guarantees (happens-before), not the predicted times —
        # the intervals above are kept for reporting and self-checks,
        # and _pipeline_lives builds them on virtual times so interval
        # overlap over-approximates the happens-before conflicts (the
        # self-check can never contradict the offsets chosen here)
        before = _happens_before(schedule)
        conflict_fn = _pipeline_conflict_fn(mapped, before)
        plan_attrs.update(
            pipeline=True,
            stream_depth=stream_depth,
            makespan_cycles=schedule.makespan,
        )

    # ---- home-level arena: first-fit + hill-climb -----------------------
    order = sorted(lives, key=lambda k: (lives[k][1], -lives[k][0], k))
    hc_stats: dict = {}
    with obs.span("plan_memory.pack", cat="compile", buffers=len(lives)) as sp:
        offsets, peak = _hill_climb(
            order, lives, hill_climb_iters, seed, conflict_fn, stats=hc_stats
        )
        sp.set(arena_peak=peak, **hc_stats)
    buffers = {
        name: BufferAlloc(name, lives[name][0], offsets[name], lives[name][1], lives[name][2])
        for name in lives
    }

    # ---- per-segment L1 working sets from the winning schedules ---------
    l1_by_segment: list[dict[str, int]] = []
    level_caps: dict[str, int] = {home.name: home.size_bytes}
    level_peaks: dict[str, int] = {home.name: peak}
    spills: list[str] = []
    for seg in segments:
        usage: dict[str, int] = {}
        if seg.workload is not None and seg.schedule is not None:
            module = target.module(seg.module)
            tiles = dict(seg.schedule.mapping.tiles)
            try:
                usage = tile_working_set(seg.workload, tiles, module)
            except KeyError:
                usage = {}
            over = [
                lvl
                for lvl in module.memories[:-1]
                if usage.get(lvl.name, 0) > lvl.size_bytes
            ]
            for lvl in module.memories[:-1]:
                level_caps.setdefault(lvl.name, lvl.size_bytes)
            if over:
                names = ", ".join(
                    f"{l.name} ({usage[l.name]} > {l.size_bytes} B)" for l in over
                )
                if not allow_spill:
                    raise MemoryPlanError(
                        f"segment {seg.anchor.name} on {seg.module}: "
                        f"working set exceeds {names}"
                    )
                spills.append(seg.anchor.name)
                usage = {}  # streams from home instead of running resident
        l1_by_segment.append(usage)

    if schedule is None:
        # sequential execution: one segment resident at a time, so each
        # level's peak is the largest single working set
        for usage in l1_by_segment:
            for lvl_name, used in usage.items():
                level_peaks[lvl_name] = max(level_peaks.get(lvl_name, 0), used)
    else:
        # concurrent execution: modules sharing a level (same name, e.g.
        # gap9's cluster + NE16 on one L1) occupy it SIMULTANEOUSLY, so
        # concurrently-scheduled working sets sum.  When the summed peak
        # overflows, the largest contributor spills (streams from home,
        # same semantics as the per-segment rule above) until it fits.
        while True:
            peaks = _concurrent_level_peaks(
                segments, l1_by_segment, before, stream_depth
            )
            over = sorted(
                (lvl, b)
                for lvl, b in peaks.items()
                if b > level_caps.get(lvl, b)
            )
            if not over:
                level_peaks.update(peaks)
                break
            lvl, b = over[0]
            if not allow_spill:
                raise MemoryPlanError(
                    f"{graph.name} on {target.name}: concurrent working "
                    f"sets exceed {lvl} ({b} > {level_caps[lvl]} B) under "
                    f"the pipeline schedule (stream_depth={stream_depth})"
                )
            victim = max(
                range(len(l1_by_segment)),
                key=lambda i: l1_by_segment[i].get(lvl, 0),
            )
            spills.append(segments[victim].anchor.name)
            l1_by_segment[victim] = {}

    if spills:
        obs.counter("memory.spills").inc(len(spills))
        obs.get_tracer().instant(
            "memory.spills", cat="compile", segments=list(spills)
        )
    from repro_torch.cnn.analysis import weight_bytes  # graph-generic, no cycle

    return MemoryPlan(
        graph_name=graph.name,
        target_name=target.name,
        home_level=home.name,
        buffers=buffers,
        arena_bytes=level_peaks,
        capacities=level_caps,
        l1_by_segment=l1_by_segment,
        weight_bytes=weight_bytes(graph),
        spills=tuple(spills),
        attrs=plan_attrs,
    )

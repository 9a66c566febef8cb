"""Cost-driven heterogeneous graph partitioning (paper Sec. IV-B).

The paper's claim (Table IV "Full") is that choosing *which execution
module runs each graph segment* jointly — NE16 and the 8-core cluster on
the same network — beats any single-accelerator mapping.  This module
implements that decision as a **DP shortest path over the graph IR**
rather than the greedy per-node walk of early MATCH/HTVM flows:

1. *Candidate enumeration* — every pattern match of every module's
   pattern table anchored at every node (all fusion lengths, not just the
   largest), plus the target's fallback module per node.
2. *Batched DSE* — all (workload, module) LOMA queries are collected,
   deduped by geometry key and evaluated through a
   :class:`~repro_torch.core.loma.SchedulePlanner` (thread pool + optional
   persistent JSON cache, so a warm re-compile skips the search).
3. *Transfer-aware DP* — a Viterbi-style pass over the topological order
   picks the segmentation *and* the module assignment minimising
   ``sum(segment cycles) + sum(cross-module transfer cycles)``, where
   transfers are priced by :func:`~repro_torch.core.cost_model.transfer_cost`
   from the edge's activation bytes and the target's
   :class:`~repro_torch.core.target.Interconnect`.  The DP state at a segment
   boundary is the module of every still-live producer edge — exact on
   chains and on the bounded-width residual branches of the MLPerf-Tiny
   nets, beam-limited (``beam``) when branch points proliferate.

``dispatch(graph, target)`` keeps its `MappedGraph` contract for
``cnn/execute.py``, ``examples/`` and ``benchmarks/``; the old greedy
policy survives as ``dispatch(..., policy="greedy")`` for baselines (its
result is annotated with the same transfer accounting so predicted
latencies stay comparable).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from repro_torch import obs

from .cost_model import evaluate_mapping, transfer_cost
from .graph import Graph, Node
from .loma import SchedulePlanner, ScheduleResult, TemporalMapping, search_schedule
from .patterns import PatternMatch, default_workload, find_matches
from .target import ExecutionModule, MatchTarget
from .workload import Workload

__all__ = ["MappedSegment", "MappedGraph", "dispatch"]


@dataclass(frozen=True)
class MappedSegment:
    """A fused group of nodes mapped onto one execution module."""

    nodes: tuple[Node, ...]
    module: str
    schedule: ScheduleResult | None  # None for zero-cost structural ops
    workload: Workload | None
    pattern: str = ""
    # cycles to bring this segment's external inputs across a module
    # boundary (0 when every producer ran on the same module)
    transfer_cycles: float = 0.0

    @property
    def cycles(self) -> float:
        if self.schedule is None:
            return 0.0
        return self.schedule.latency_cycles

    @property
    def total_cycles(self) -> float:
        return self.cycles + self.transfer_cycles

    @property
    def anchor(self) -> Node:
        return self.nodes[0]

    # -- lowering metadata (consumed by repro_torch.backend) ------------------
    @property
    def output_node(self) -> Node:
        """The node whose tensor leaves the segment (fusion chains are
        single-consumer, so only the last node is externally visible)."""
        return self.nodes[-1]

    @property
    def epilogue(self) -> tuple[Node, ...]:
        """The fused nodes after the anchor (bias/requant/relu chains)."""
        return self.nodes[1:]

    def external_inputs(self, graph: Graph) -> tuple[str, ...]:
        """Producer names feeding this segment from outside it, in first-use
        order (graph inputs included) — the executor's argument order."""
        inside = {n.name for n in self.nodes}
        out: list[str] = []
        for n in self.nodes:
            for inp in n.inputs:
                if inp not in inside and inp not in out:
                    out.append(inp)
        return tuple(out)


@dataclass
class MappedGraph:
    """Dispatch result: full partitioning of a graph over a target."""

    graph: Graph
    target: MatchTarget
    segments: list[MappedSegment]
    attrs: dict = field(default_factory=dict)

    def total_cycles(self) -> float:
        """Predicted end-to-end cycles, cross-module transfers included."""
        return sum(s.total_cycles for s in self.segments)

    def compute_cycles(self) -> float:
        return sum(s.cycles for s in self.segments)

    def transfer_cycles(self) -> float:
        return sum(s.transfer_cycles for s in self.segments)

    def latency_s(self, frequency_hz: float | None = None) -> float:
        f = frequency_hz or self.target.fallback.frequency_hz
        return self.total_cycles() / f

    def cycles_by_module(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for s in self.segments:
            out[s.module] = out.get(s.module, 0.0) + s.cycles
        return out

    def module_of(self, node_name: str) -> str:
        for s in self.segments:
            if any(n.name == node_name for n in s.nodes):
                return s.module
        raise KeyError(node_name)

    def macs_per_cycle(self) -> float:
        macs = self.graph.total_macs()
        cyc = self.total_cycles()
        return macs / cyc if cyc > 0 else 0.0

    def summary(self) -> str:
        lines = [f"MappedGraph[{self.graph.name} on {self.target.name}]"]
        for s in self.segments:
            names = "+".join(n.name for n in s.nodes)
            xfer = f" +{s.transfer_cycles:.0f} xfer" if s.transfer_cycles else ""
            lines.append(
                f"  {names:<40s} -> {s.module:<10s} {s.cycles:>14.0f} cyc{xfer}"
                + (f"  ({s.pattern})" if s.pattern else "")
            )
        lines.append(
            f"  TOTAL {self.total_cycles():.0f} cycles"
            f" ({self.transfer_cycles():.0f} in transfers),"
            f" {self.macs_per_cycle():.2f} MACs/cyc"
        )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Candidate enumeration
# ---------------------------------------------------------------------------


@dataclass
class _Candidate:
    """One (segment, module) option anchored at a topological position."""

    nodes: tuple[Node, ...]
    module: ExecutionModule
    workload: Workload | None
    pattern: str
    schedule: ScheduleResult | None = None

    @property
    def cycles(self) -> float:
        return self.schedule.latency_cycles if self.schedule is not None else 0.0


def _untiled_stream_schedule(wl: Workload, module: ExecutionModule) -> ScheduleResult:
    """The always-feasible 'stream every element' mapping for the fallback
    CPU — the paper's un-matched -> plain TVM path must never fail."""
    tiles = {l.name: 1 for l in wl.loops}
    cost = evaluate_mapping(wl, tiles, tuple(wl.dim_names), module)
    return ScheduleResult(wl.name, module.name, TemporalMapping(tiles, tuple(wl.dim_names)), cost, 1)


def _enumerate_candidates(
    graph: Graph,
    target: MatchTarget,
    planner: SchedulePlanner,
    budget: int,
) -> list[list[_Candidate]]:
    """All candidate segments per topo position + registered DSE queries.

    Matches are kept only when their node chain is contiguous in the topo
    order (true for single-consumer fusion chains built by the netlists),
    which keeps the DP a clean segmentation over the node list.  Each
    position always retains the fallback candidate so the DP never dead-ends.
    """
    nodes = graph.nodes
    cands: list[list[_Candidate]] = [[] for _ in nodes]
    for i, node in enumerate(nodes):
        for module in target.modules:
            for m in find_matches(graph, node, module.patterns):
                if m.nodes != tuple(nodes[i : i + len(m.nodes)]):
                    continue  # non-contiguous chain: not a DP segment
                wl = m.workload()  # built once: reused for DSE + the segment
                planner.request(wl, module, budget=budget)
                cands[i].append(_Candidate(m.nodes, module, wl, m.pattern.name))
        wl = default_workload(node)
        if wl is not None:
            planner.request(wl, target.fallback, budget=budget)
            cands[i].append(_Candidate((node,), target.fallback, wl, "fallback"))
        else:
            # structural ops (reshape, ...) cost ~0 on *any* module: offer
            # every placement so the DP can keep them transfer-transparent
            # inside a same-module run instead of pinning them to the CPU
            # and pricing phantom round trips on both sides.
            for module in target.all_modules():
                cands[i].append(_Candidate((node,), module, None, "structural"))
    return cands


def _resolve_schedules(
    cands: list[list[_Candidate]],
    planner: SchedulePlanner,
    budget: int,
) -> list[list[_Candidate]]:
    """Attach DSE results; drop infeasible matches, rescue the fallback."""
    out: list[list[_Candidate]] = []
    for options in cands:
        kept: list[_Candidate] = []
        for c in options:
            if c.workload is None:
                kept.append(c)  # structural: zero cost by construction
                continue
            sched = planner.get(c.workload, c.module, budget=budget)
            if not sched.feasible:
                if c.pattern == "fallback":
                    sched = _untiled_stream_schedule(c.workload, c.module)
                else:
                    continue
            c.schedule = sched
            kept.append(c)
        out.append(kept)
    return out


# ---------------------------------------------------------------------------
# Transfer accounting
# ---------------------------------------------------------------------------


def _external_inputs(graph: Graph, seg_nodes: Sequence[Node]) -> dict[str, int]:
    """producer-name -> edge bytes for inputs produced outside the segment
    by another graph node (graph inputs live in shared memory already)."""
    inside = {n.name for n in seg_nodes}
    edges: dict[str, int] = {}
    for n in seg_nodes:
        for inp in n.inputs:
            if inp in inside or not graph.has(inp):
                continue
            edges[inp] = graph.edge_bytes(inp)
    return edges


def _edges_transfer(
    edges: dict[str, int],
    module: ExecutionModule,
    mod_of: dict[str, str],
    target: MatchTarget,
    modmap: dict[str, ExecutionModule],
) -> float:
    total = 0.0
    for producer, nbytes in edges.items():
        src = modmap[mod_of[producer]]
        total += transfer_cost(nbytes, src, module, target.interconnect)
    return total


def _segment_transfer(
    graph: Graph,
    seg_nodes: Sequence[Node],
    module: ExecutionModule,
    mod_of: dict[str, str],
    target: MatchTarget,
    modmap: dict[str, ExecutionModule],
) -> float:
    return _edges_transfer(_external_inputs(graph, seg_nodes), module, mod_of, target, modmap)


# ---------------------------------------------------------------------------
# The DP (Viterbi) partitioner
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _State:
    cost: float
    segments: tuple[MappedSegment, ...]
    mod_of: dict  # node name -> module name for every covered node


# complete segmentations the DP keeps for makespan re-ranking: enough
# beam survivors that a sum-suboptimal but overlap-friendly mapping is
# still on the table, small enough that scheduling them all is free
_FINALS_KEPT = 64

# requests in the synthetic unit-weight stream the "wct" objective prices
# each candidate segmentation against: deep enough that the steady-state
# initiation interval dominates (C_k ~ makespan + (k-1)*II, so the sum
# weighs II (depth-1)/2 times per request), shallow enough to stay free
_WCT_STREAM_DEPTH = 4


def _dispatch_dp(
    graph: Graph,
    target: MatchTarget,
    planner: SchedulePlanner,
    budget: int,
    beam: int,
    verbose: bool,
    objective: str = "cycles",
) -> MappedGraph:
    nodes = graph.nodes
    n = len(nodes)
    if n == 0:
        return MappedGraph(graph, target, [])

    with obs.span("dispatch.enumerate", cat="compile") as sp:
        cands = _enumerate_candidates(graph, target, planner, budget)
        sp.set(positions=n, candidates=sum(len(c) for c in cands))
    stats0 = dict(planner.stats)
    with obs.span("dispatch.dse_flush", cat="compile") as sp:
        candidates = planner.flush()
        # cache hit/miss attribution for this dispatch: the planner is
        # shared across compiles, so report the delta, not the totals
        sp.set(candidates=candidates, **{k: planner.stats[k] - stats0.get(k, 0) for k in planner.stats})
    with obs.span("dispatch.resolve", cat="compile"):
        cands = _resolve_schedules(cands, planner, budget)

    modmap = {m.name: m for m in target.all_modules()}

    # last topo position that still consumes each node's output
    last_use = {nd.name: -1 for nd in nodes}
    for i, nd in enumerate(nodes):
        for inp in nd.inputs:
            if inp in last_use:
                last_use[inp] = max(last_use[inp], i)
    # live[j]: producers whose edge crosses segment boundary j
    live: list[tuple[str, ...]] = [()] * (n + 1)
    for j in range(1, n + 1):
        live[j] = tuple(
            nd.name for nd in nodes[:j] if last_use[nd.name] >= j
        )

    def state_key(j: int, mod_of: dict) -> tuple:
        return tuple((p, mod_of[p]) for p in live[j])

    states: list[dict[tuple, _State]] = [dict() for _ in range(n + 1)]
    states[0][()] = _State(0.0, (), {})
    # complete segmentations keyed by (boundaries, modules): the state key
    # at position n collapses to () (nothing stays live), which would keep
    # exactly one survivor — the makespan objective needs the runners-up.
    # Under objective="cycles" only the running minimum is kept (no
    # signature bookkeeping in the DP hot loop).
    track_finals = objective in ("makespan", "wct")
    finals: dict[tuple, _State] = {}
    best_final: _State | None = None

    viterbi_span = obs.span("dispatch.viterbi", cat="compile", nodes=n, beam=beam)
    viterbi_span.__enter__()
    for i in range(n):
        here = states[i]
        if not here:
            continue
        ranked = sorted(here.values(), key=lambda s: s.cost)[: max(1, beam)]
        for c in cands[i]:
            # the producer -> bytes map is state-independent: hoist it out
            # of the beam loop (only the per-producer module varies)
            edges = _external_inputs(graph, c.nodes)
            for st in ranked:
                j = i + len(c.nodes)
                xfer = _edges_transfer(edges, c.module, st.mod_of, target, modmap)
                seg = MappedSegment(
                    c.nodes,
                    c.module.name,
                    c.schedule,
                    c.workload,
                    pattern=c.pattern,
                    transfer_cycles=xfer,
                )
                cost = st.cost + seg.cycles + xfer
                mod_of = dict(st.mod_of)
                for nd in c.nodes:
                    mod_of[nd.name] = c.module.name
                key = state_key(j, mod_of)
                cur = states[j].get(key)
                if cur is None or cost < cur.cost:
                    states[j][key] = _State(cost, st.segments + (seg,), mod_of)
                if j == n:
                    if track_finals:
                        done = _State(cost, st.segments + (seg,), mod_of)
                        sig = tuple(
                            (s.anchor.name, s.module, len(s.nodes))
                            for s in done.segments
                        )
                        old = finals.get(sig)
                        if old is None or done.cost < old.cost:
                            finals[sig] = done
                    elif best_final is None or cost < best_final.cost:
                        best_final = _State(cost, st.segments + (seg,), mod_of)

    viterbi_span.set(final_states=len(finals) if track_finals else 1).__exit__(
        None, None, None
    )

    attrs = {"policy": "dp", "objective": objective, "planner_stats": dict(planner.stats)}
    if track_finals:
        # re-rank the surviving complete segmentations by a schedule-level
        # objective: "makespan" scores the concurrent single-input
        # schedule; "wct" scores the weighted completion time of a
        # unit-weight request stream (repro_torch.pipeline.schedule_stream), so
        # a serving-friendly segmentation — one whose steady-state
        # initiation interval, not just its latency, is small — wins.
        # Ties fall back to makespan then the cycle sum, so chains with
        # no overlap opportunity reproduce the cycles objective.
        from repro_torch.pipeline.schedule import (  # no cycle: late import
            schedule_pipeline,
            schedule_stream,
        )

        with obs.span("dispatch.makespan_rerank", cat="compile") as sp:
            ranked = sorted(finals.values(), key=lambda s: s.cost)[:_FINALS_KEPT]
            best: _State | None = None
            best_key: tuple[float, ...] | None = None
            best_span: float = 0.0
            for st in ranked:
                mg = MappedGraph(graph, target, list(st.segments))
                ps = schedule_pipeline(mg)
                if objective == "wct":
                    ss = schedule_stream(mg, (1.0,) * _WCT_STREAM_DEPTH)
                    key = (ss.attrs["weighted_completion"], ps.makespan, st.cost)
                else:
                    key = (ps.makespan, st.cost)
                if best_key is None or key < best_key:
                    best, best_key, best_span = st, key, ps.makespan
            final = best
            sp.set(candidates=len(ranked), makespan=best_span)
        attrs["predicted_makespan"] = best_span
        attrs["candidates_reranked"] = len(ranked)
        if objective == "wct":
            attrs["predicted_weighted_completion"] = best_key[0]
            attrs["wct_stream_depth"] = _WCT_STREAM_DEPTH
    else:
        final = best_final
    if verbose:
        for s in final.segments:
            print(
                f"  dispatch {s.anchor.name} -> {s.module}"
                f" ({s.cycles:.0f} cyc + {s.transfer_cycles:.0f} xfer)"
            )
    return MappedGraph(graph, target, list(final.segments), attrs=attrs)


# ---------------------------------------------------------------------------
# Greedy baseline (the seed policy, kept for ablation benchmarks)
# ---------------------------------------------------------------------------


def _fallback_segment(
    target: MatchTarget, nodes: tuple[Node, ...], budget: int
) -> MappedSegment:
    wl = default_workload(nodes[0]) if len(nodes) == 1 else None
    if wl is None:
        return MappedSegment(nodes, target.fallback.name, None, None, pattern="structural")
    sched = search_schedule(wl, target.fallback, budget=budget)
    if not sched.feasible:
        sched = _untiled_stream_schedule(wl, target.fallback)
    return MappedSegment(nodes, target.fallback.name, sched, wl, pattern="fallback")


def _dispatch_greedy(
    graph: Graph, target: MatchTarget, budget: int, verbose: bool
) -> MappedGraph:
    """Largest-match-first, transfer-blind per-node walk (HTVM-style)."""
    segments: list[MappedSegment] = []
    consumed: set[str] = set()

    for node in graph.nodes:
        if node.name in consumed:
            continue

        per_module: list[tuple[ExecutionModule, PatternMatch]] = []
        for module in target.modules:
            for m in find_matches(graph, node, module.patterns):
                per_module.append((module, m))

        chosen: MappedSegment | None = None
        if per_module:
            max_len = max(len(m.nodes) for _, m in per_module)
            for length in range(max_len, 0, -1):
                cands = [(mod, m) for mod, m in per_module if len(m.nodes) == length]
                best: tuple[ExecutionModule, PatternMatch, Workload, ScheduleResult] | None = None
                for mod, m in cands:
                    wl = m.workload()  # built once per match
                    sched = search_schedule(wl, mod, budget=budget)
                    if not sched.feasible:
                        continue
                    if best is None or sched.latency_cycles < best[3].latency_cycles:
                        best = (mod, m, wl, sched)
                if best is not None:
                    mod, m, wl, sched = best
                    chosen = MappedSegment(m.nodes, mod.name, sched, wl, pattern=m.pattern.name)
                    break

        if chosen is None:
            chosen = _fallback_segment(target, (node,), budget)

        segments.append(chosen)
        consumed |= {n.name for n in chosen.nodes}
        if verbose:
            print(f"  dispatch {chosen.anchor.name} -> {chosen.module} ({chosen.cycles:.0f} cyc)")

    # annotate the greedy result with the same transfer accounting the DP
    # optimises, so predicted latencies are directly comparable
    modmap = {m.name: m for m in target.all_modules()}
    mod_of = {n.name: s.module for s in segments for n in s.nodes}
    import dataclasses

    annotated = [
        dataclasses.replace(
            s,
            transfer_cycles=_segment_transfer(
                graph, s.nodes, modmap[s.module], mod_of, target, modmap
            ),
        )
        for s in segments
    ]
    return MappedGraph(graph, target, annotated, attrs={"policy": "greedy"})


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


# "no profile argument given" (mirrors repro_torch.targets.registry): the
# MATCH_CALIBRATION_PROFILE env default may apply; ``profile=None``
# explicitly forces the declared (uncalibrated) model.
_PROFILE_UNSET = object()


def dispatch(
    graph: Graph,
    target: MatchTarget | str,
    *,
    budget: int = 4000,
    policy: str = "dp",
    objective: str = "cycles",
    beam: int = 12,
    planner: SchedulePlanner | None = None,
    cache_path=None,
    profile=_PROFILE_UNSET,
    verbose: bool = False,
) -> MappedGraph:
    """Partition ``graph`` across ``target``'s execution modules.

    ``target`` is a :class:`MatchTarget` or a registered target *name*
    (resolved through :mod:`repro_torch.targets.registry` — the agile
    retargeting entry point).
    ``policy="dp"`` (default) runs the transfer-aware DP partitioner;
    ``policy="greedy"`` keeps the legacy largest-match walk as a baseline.
    ``objective`` selects what the DP minimises: ``"cycles"`` (default)
    keeps the sequential sum of compute + transfer cycles;
    ``"makespan"`` re-ranks the DP's surviving complete segmentations by
    their *concurrently scheduled* makespan
    (:func:`repro_torch.pipeline.schedule.schedule_pipeline` — each execution
    module a resource with its own clock), so independent branches are
    worth spreading across modules.  Ties fall back to the cycle sum,
    which keeps skipless chains identical under both objectives.
    ``"wct"`` extends the makespan re-rank to *serving*: candidates are
    scored by the weighted completion time of a unit-weight request
    stream (:func:`repro_torch.pipeline.schedule.schedule_stream`), which
    prices the steady-state initiation interval on top of the one-shot
    latency — the segmentation a loaded replica should run.
    ``planner`` / ``cache_path`` control schedule batching and the
    persistent DSE cache (see :class:`~repro_torch.core.loma.SchedulePlanner`).
    ``profile`` applies a :class:`~repro_torch.calibrate.CalibrationProfile`
    (or a path to one) on top of the declared target, so the DSE ranks
    candidates with measured — not assumed — hardware constants; for
    target *names* it follows ``get_target`` semantics (omitted = the
    ``MATCH_CALIBRATION_PROFILE`` env default, ``None`` = explicitly
    uncalibrated), while a :class:`MatchTarget` *instance* is taken
    as-is unless a profile is explicitly passed (the env default never
    mutates an instance the caller built).  A profile fitted for a
    different target is rejected with :class:`ValueError` on both paths.
    """
    if isinstance(target, str):
        # late import: repro_torch.targets depends on repro_torch.core, not vice versa
        # (and an explicit MatchTarget instance must keep working even if
        # the targets package cannot import)
        from repro_torch.targets.registry import get_target

        if profile is _PROFILE_UNSET:
            target = get_target(target)
        else:
            target = get_target(target, profile=profile)
    elif profile is not _PROFILE_UNSET and profile is not None:
        from repro_torch.calibrate.profile import (
            apply_profile,
            coerce_profile,
            profile_matches_target,
        )

        prof = coerce_profile(profile)
        if prof is not None and not profile_matches_target(prof, target.name):
            raise ValueError(
                f"calibration profile is for target {prof.target!r}, "
                f"not {target.name!r}"
            )
        target = apply_profile(target, prof)
    if objective not in ("cycles", "makespan", "wct"):
        raise ValueError(f"unknown dispatch objective {objective!r}")
    if policy == "greedy":
        if planner is not None or cache_path is not None:
            raise ValueError(
                "policy='greedy' searches serially and does not use the "
                "schedule planner; drop planner=/cache_path= (DP only)"
            )
        if objective != "cycles":
            raise ValueError(
                "policy='greedy' picks segments locally and cannot optimise "
                "a schedule-level objective; use policy='dp' for makespan"
            )
        return _dispatch_greedy(graph, target, budget, verbose)
    if policy != "dp":
        raise ValueError(f"unknown dispatch policy {policy!r}")
    if planner is not None and cache_path is not None:
        raise ValueError(
            "pass either planner= (already bound to its cache file) or "
            "cache_path= (a planner is created for you), not both"
        )
    if planner is None:
        planner = SchedulePlanner(cache_path=cache_path)
    obs.counter("dispatch.calls").inc()
    with obs.span(
        "dispatch", cat="compile",
        graph=graph.name, target=target.name, objective=objective,
    ):
        return _dispatch_dp(graph, target, planner, budget, beam, verbose, objective)

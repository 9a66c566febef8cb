"""The differential oracle: one generated graph x one target -> verdicts.

The port of ``repro.fuzz.oracle``, with the same battery, stage names and
failure classification.  For a spec on a registered target the oracle
runs ``dispatch -> lower`` onto ``device`` (the CUDA card unless the
caller passes ``device="cpu"``) and checks the full invariant battery
the stack promises:

==============  ============================================================
invariant       contract checked
==============  ============================================================
``cover``       segments form a contiguous, complete partition of the
                topo-ordered node list
``makespan``    ``schedule_pipeline(mapped)`` validates and its makespan
                never exceeds the sequential ``total_cycles()``
``cache``       dispatch through a fresh planner reproduces the shared
                (warm) planner's segmentation — the warm==cold
                schedule-cache roundtrip
``memory``      the sequential plan, the overlap-aware pipeline plan and
                the stream_depth=2 plan all pack without byte overlap and
                within every declared MemoryLevel
``json``        ``CompiledModel.report_dict()`` survives ``json.dumps``
``bitexact``    the CPU interpreter vs ``CompiledModel.run`` vs AOT vs
                ``PipelinedModel.run``/``run_stream`` vs ``BatchedModel``
                on ``device`` agree bit-for-bit on every graph output
==============  ============================================================

Failures are classified by ``(invariant, stage)``; an exception anywhere
becomes invariant ``crash`` with the stage that raised.  ``invariants=``
restricts the battery (the shrinker re-runs only the failing one).

Every path is held against ``repro_torch.cnn.execute_graph(...,
device="cpu")``, the port's plain interpreter, which shares no conv or
GEMM with the card; holding the port against the JAX reference's
interpreter is the tests' job (this package never imports it).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.core import Graph, dispatch
from repro_torch.core.loma import SchedulePlanner

from .generate import build_graph, random_inputs

__all__ = ["INVARIANTS", "CaseReport", "FuzzFailure", "check_case"]

INVARIANTS = ("cover", "makespan", "cache", "memory", "json", "bitexact")

# how many distinct input tensors the streaming / batched checks push
_STREAM_INPUTS = 2


@dataclass(frozen=True)
class FuzzFailure:
    """One broken contract, classified by invariant and pipeline stage."""

    invariant: str   # one of INVARIANTS, or "crash"
    stage: str       # e.g. "dispatch", "memory.stream", "exec.aot"
    target: str
    message: str

    def as_dict(self) -> dict:
        return {
            "invariant": self.invariant,
            "stage": self.stage,
            "target": self.target,
            "message": self.message,
        }


@dataclass
class CaseReport:
    """Everything the oracle learned about one (spec, target) case."""

    spec: dict
    target: str
    io_seed: int
    n_nodes: int = 0
    invariants_checked: tuple[str, ...] = ()
    failures: list[FuzzFailure] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures

    def as_dict(self) -> dict:
        return {
            "target": self.target,
            "io_seed": self.io_seed,
            "n_nodes": self.n_nodes,
            "invariants_checked": list(self.invariants_checked),
            "failures": [f.as_dict() for f in self.failures],
        }


def _host(v) -> np.ndarray:
    """A tensor (on any device) or array as a CPU numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _diff_msg(name: str, a, b) -> str | None:
    """None when bit-identical, else a located first-divergence message."""
    a = _host(a)
    b = _host(b)
    if a.shape != b.shape:
        return f"{name}: shape {a.shape} vs {b.shape}"
    if np.array_equal(a, b):
        return None
    d = np.abs(a - b)
    idx = np.unravel_index(int(np.argmax(d)), d.shape)
    return (f"{name}: max |diff| {float(np.max(d)):g} at {tuple(map(int, idx))} "
            f"({float(a[idx]):g} vs {float(b[idx]):g})")


def _compare(ref: dict, got: dict, stage: str, target: str, fails: list) -> None:
    for k in ref:
        if k not in got:
            fails.append(FuzzFailure("bitexact", stage, target, f"missing output {k}"))
            continue
        msg = _diff_msg(k, ref[k], got[k])
        if msg is not None:
            fails.append(FuzzFailure("bitexact", stage, target, msg))


def _segmentation_sig(mapped) -> tuple:
    return tuple(
        (s.anchor.name, s.module, len(s.nodes), round(float(s.cycles), 6))
        for s in mapped.segments
    )


def _check_cover(graph: Graph, mapped, target: str, fails: list) -> None:
    flat = [n.name for s in mapped.segments for n in s.nodes]
    want = [n.name for n in graph.nodes]
    if flat != want:
        fails.append(FuzzFailure(
            "cover", "dispatch", target,
            f"segments cover {flat} but topo order is {want}",
        ))


def check_case(
    spec: dict,
    target,
    *,
    io_seed: int = 0,
    invariants=None,
    budget: int = 120,
    planner: SchedulePlanner | None = None,
    target_obj=None,
    device=None,
) -> CaseReport:
    """Run the invariant battery for ``spec`` on ``target``.

    ``target`` is a registered target name; ``target_obj`` overrides the
    instance (how unit tests induce failures on a deliberately broken
    target).  ``invariants`` restricts which contracts are checked —
    ``bitexact`` is by far the most expensive (it runs the graph five
    ways and captures it twice on the card), so bulk runs subsample it.
    ``device`` is where the compiled paths run: CUDA unless the caller
    asks for ``"cpu"``; without a card the default raises here, before
    the battery (it is never reported as a crash of the case).
    """
    want = tuple(invariants) if invariants else INVARIANTS
    for iv in want:
        if iv not in INVARIANTS:
            raise ValueError(f"unknown invariant {iv!r} (have {INVARIANTS})")
    dev = resolve_device(device)
    tname = target if isinstance(target, str) else target.name
    rep = CaseReport(spec=spec, target=tname, io_seed=io_seed,
                     invariants_checked=want)
    fails = rep.failures

    obs.counter("fuzz.cases").inc()
    with obs.span("fuzz.case", cat="fuzz", target=tname,
                  invariants=",".join(want)):
        _run_battery(spec, tname, target_obj, want, io_seed, budget,
                     planner, dev, rep, fails)
    if fails:
        obs.counter("fuzz.failures").inc(len(fails))
    return rep


def _run_battery(spec, tname, target_obj, want, io_seed, budget,
                 planner, dev, rep: CaseReport, fails: list) -> None:
    from repro_torch.backend.memory import MemoryPlanError

    stage = "build"
    try:
        graph = build_graph(spec)
        rep.n_nodes = len(graph.nodes)
        if not graph.topo_check():
            fails.append(FuzzFailure("cover", stage, tname, "graph failed topo_check"))
            return

        if target_obj is not None:
            t = target_obj
        else:
            from repro_torch.targets.registry import get_target

            t = get_target(tname)
        planner = planner or SchedulePlanner()

        stage = "dispatch"
        mapped = dispatch(graph, t, budget=budget, planner=planner)

        if "cover" in want:
            _check_cover(graph, mapped, tname, fails)

        if "makespan" in want:
            stage = "schedule"
            from repro_torch.pipeline.schedule import schedule_pipeline

            ps = schedule_pipeline(mapped)
            ps.validate()
            total = mapped.total_cycles()
            if ps.makespan > total * (1 + 1e-9) + 1e-6:
                fails.append(FuzzFailure(
                    "makespan", stage, tname,
                    f"makespan {ps.makespan:.3f} > total_cycles {total:.3f}",
                ))
        else:
            ps = None

        if "cache" in want:
            stage = "cache"
            cold = dispatch(graph, t, budget=budget, planner=SchedulePlanner())
            sa, sb = _segmentation_sig(mapped), _segmentation_sig(cold)
            if sa != sb:
                fails.append(FuzzFailure(
                    "cache", stage, tname,
                    f"warm planner chose {sa} but a cold planner chose {sb}",
                ))

        needs_lower = any(iv in want for iv in ("memory", "json", "bitexact"))
        if not needs_lower:
            return
        stage = "lower"
        from repro_torch.backend import lower

        compiled = lower(mapped, t, device=dev)

        if "memory" in want:
            stage = "memory.plan"
            plan = compiled.memory_plan
            if not plan.check_no_overlap():
                fails.append(FuzzFailure("memory", stage, tname,
                                         "sequential plan has overlapping buffers"))
            try:
                plan.validate()
            except MemoryPlanError as e:
                fails.append(FuzzFailure("memory", stage, tname, str(e)))

            from repro_torch.backend.memory import plan_memory
            from repro_torch.pipeline.schedule import schedule_pipeline

            ps2 = ps or schedule_pipeline(mapped)
            for depth, sub in ((1, "memory.pipeline"), (2, "memory.stream")):
                stage = sub
                p2 = plan_memory(mapped, schedule=ps2, stream_depth=depth)
                if not p2.check_no_overlap():
                    fails.append(FuzzFailure(
                        "memory", stage, tname,
                        f"stream_depth={depth} plan has overlapping buffers"))
                try:
                    p2.validate()
                except MemoryPlanError as e:
                    fails.append(FuzzFailure("memory", stage, tname, str(e)))

        if "json" in want:
            stage = "report"
            try:
                json.dumps(compiled.report_dict())
            except (TypeError, ValueError) as e:
                fails.append(FuzzFailure("json", stage, tname,
                                         f"report_dict not JSON-safe: {e}"))

        if "bitexact" in want:
            _check_bitexact(spec, graph, compiled, tname, io_seed, fails)
    except Exception as e:  # noqa: BLE001 — every crash is a verdict
        fails.append(FuzzFailure(
            "crash", stage, tname, f"{type(e).__name__}: {e}",
        ))


def _check_bitexact(spec, graph, compiled, tname, io_seed, fails) -> None:
    from repro_torch.cnn.execute import execute_graph, init_graph_params, params_to_torch
    from repro_torch.pipeline.runtime import PipelinedModel
    from repro_torch.serve.batching import BatchedModel

    params = init_graph_params(graph, seed=io_seed)
    inputs = [random_inputs(spec, io_seed + q) for q in range(_STREAM_INPUTS)]

    ref = [execute_graph(graph, params, x, device="cpu") for x in inputs]
    # the weights cross to the device once for the eager paths (the AOT
    # and batched entries convert and keep their own copies)
    dev_params = params_to_torch(params, compiled.device)

    got = compiled.run(dev_params, inputs[0])
    _compare(ref[0], got, "exec.compiled", tname, fails)

    aot = compiled.to_aot()
    _compare(ref[0], aot.run(params, inputs[0]), "exec.aot", tname, fails)

    pipe = PipelinedModel(compiled)
    _compare(ref[0], pipe.run(dev_params, inputs[0]), "exec.pipeline", tname, fails)
    for r, o in zip(ref, pipe.run_stream(dev_params, inputs, depth=2)):
        _compare(r, o, "exec.stream", tname, fails)

    bm = BatchedModel(compiled)
    for r, o in zip(ref, bm.run_batch(params, inputs)):
        _compare(r, o, "exec.batched", tname, fails)

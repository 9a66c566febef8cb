"""Whole-graph AOT executor: kill per-segment host dispatch — on the card.

The port of ``repro.backend.aot``.  ``CompiledModel.run`` walks the
lowered segments in a Python loop, one host dispatch (and on the card
several kernel launches) per segment, so on sub-millisecond MLPerf-Tiny
nets the host dominates end-to-end latency.  Where the reference fuses
all segments into one XLA program, the port captures the same sequence
of segment calls once into a CUDA graph (:mod:`repro_torch._graphs`)
and replays it with one host call.

Design points, each the reference's where the card allows:

* **Segment bodies are reused, never re-derived.**  The capture calls
  the exact per-segment ``LoweredSegment.fn`` executors, so bit-exactness
  with ``CompiledModel.run`` — and therefore with the interpreter — holds
  by construction.  The int8 GEMM segments run the ``matmul_requant``
  kernel inside the graph; each replay counts its launches.
* **Weights are baked.**  Params are converted to device tensors once,
  at warm-up, and held by the entry; scalars such as the requant
  ``shift`` are Python floats read at capture, as the reference reads
  them at trace time.  Entries are cached per (params identity, input
  signature); a different params dict captures afresh.
* **Capture, paid once.**  :meth:`AotModel.warmup` converts the params,
  runs the segments once eagerly on static input tensors (the shape
  pass, which also loads every kernel and lets cuDNN pick its
  algorithms), and captures; :meth:`AotModel.run` copies the inputs into
  the static inputs, replays, and returns copies of the outputs that a
  later run cannot overwrite.
* **The static MemoryPlan survives into the graph.**  ``memory="arena"``
  keeps one flat float32 device tensor: every planned buffer is a view at
  its :meth:`MemoryPlan.arena_view` offset (byte coordinates scaled to the
  float32 element), updated in place across runs.  ``memory="xla"`` (the
  default; the name kept) leaves intermediates to ordinary tensors in the
  graph's private memory pool.
* **Cross-module boundaries are double-buffer staged.**  In arena mode a
  boundary tensor whose only consumer is the next segment lands in one of
  two alternating staging slots appended to the arena, and ``stats()``
  carries the predicted transfer/compute overlap either way.

On the CPU nothing is captured: both modes run the segments in sequence
(the arena's stores and loads included), which is what the CPU tests
hold against the reference ``AotModel``.  A CUDA model that cannot be
captured raises :class:`AotCompileError`; nothing falls back to the
per-segment loop.

What has no counterpart on the card reads ``None`` in ``stats()``, never
an invented value: XLA's executable statistics (a CUDA graph exposes no
code or buffer sizes), buffer donation (the arena is updated in place,
and inputs are copied into the static inputs, so nothing is donated),
and on the CPU the capture time (nothing is captured).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import to_tensor
from repro_torch._graphs import CapturedGraph, capture, uncounted
from repro_torch.cnn.execute import params_to_torch

if TYPE_CHECKING:  # avoid circular imports at module load
    from .lower import LoweredSegment
    from .runtime import CompiledModel

__all__ = [
    "AotCompileError",
    "AotEntry",
    "AotModel",
    "ChainExecutor",
    "compile_aot",
    "build_chains",
    "make_chain_executor",
]


class AotCompileError(RuntimeError):
    """The compiled model cannot be fused into one AOT executable."""


def _as_input(v) -> torch.Tensor:
    """Input coercion shared with ``CompiledModel.run`` (the caller's dtype
    kept, 64-bit narrowed, bare Python data float32), left where it is: a
    tensor stays on its device, numpy data lands on the CPU, and the copy
    into the static inputs moves it."""
    return to_tensor(v, v.device if isinstance(v, torch.Tensor) else torch.device("cpu"))


def _sig_of(inputs: dict) -> tuple:
    """Hashable (name, shape, dtype) input signature, the AOT cache key;
    dtypes by the reference's names (``"int8"``, ``"float32"``)."""
    return tuple(
        sorted((k, tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in inputs.items())
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class AotEntry:
    """One captured graph for one (params, input-signature) pair.

    ``trace_us`` is the warm-up: the params' conversion and the eager
    shape pass.  ``compile_us`` is the capture, ``None`` on the CPU
    (nothing is captured there).  :meth:`to_dict` keeps the reference's
    keys; ``donation_honored`` and ``executable`` hold ``None`` there:
    nothing is donated on the card, and a CUDA graph exposes no
    counterpart of XLA's executable statistics.
    """

    signature: tuple
    run_fn: Callable = field(repr=False)  # the whole sequence over the static tensors
    inputs: dict = field(repr=False)  # static input tensors
    trace_us: float
    compile_us: float | None
    params: dict = field(repr=False)  # strong ref: keeps the bake valid
    graph: CapturedGraph | None = field(default=None, repr=False)
    arena: torch.Tensor | None = field(default=None, repr=False)  # arena mode
    arena_elems: int = 0
    arena_fallbacks: tuple[str, ...] = ()
    calls: int = 0

    def to_dict(self) -> dict:
        return {
            "inputs": [list(s) for s in self.signature],
            "trace_us": self.trace_us,
            "compile_us": self.compile_us,
            "arena_elems": self.arena_elems,
            "arena_fallbacks": list(self.arena_fallbacks),
            "donation_honored": None,
            "calls": self.calls,
            "executable": None,
        }


class AotModel:
    """A CompiledModel captured as one CUDA graph per input signature.

    ``memory="xla"`` (default) leaves intermediate buffers to the graph's
    own pool; ``memory="arena"`` expresses the static :class:`MemoryPlan`
    literally (one flat arena, every buffer at its planned offset,
    cross-module boundaries staged through two alternating double-buffer
    slots).
    """

    def __init__(self, compiled: "CompiledModel", *, memory: str = "xla"):
        if memory not in ("xla", "arena"):
            raise ValueError(f"memory must be 'xla' or 'arena', got {memory!r}")
        self.compiled = compiled
        self.memory = memory
        self._entries: dict[tuple, AotEntry] = {}
        self._lock = threading.Lock()
        self._dispatch_overhead: dict | None = None
        self._span_name = f"aot.run:{compiled.graph.name}"  # the traced run's span, named once
        self._span_attrs = {"memory": memory}
        # static accounting: cross-module boundaries in execution order,
        # mirroring the pipeline scheduler's transfer-at-consumer-start
        # derivation — with double buffering, boundary k's input DMA can
        # overlap boundary k-1's producing compute.
        segs = compiled.mapped.segments
        self._boundaries: list[dict] = []
        for i in range(len(segs) - 1):
            a, b = segs[i], segs[i + 1]
            if a.module != b.module:
                self._boundaries.append(
                    {
                        "producer": a.anchor.name,
                        "consumer": b.anchor.name,
                        "modules": [a.module, b.module],
                        "tensor": a.output_node.name,
                        "slot": len(self._boundaries) % 2,
                        "transfer_cycles": b.transfer_cycles,
                        "overlap_cycles": min(b.transfer_cycles, a.cycles),
                    }
                )

    # -- introspection ---------------------------------------------------
    @property
    def graph(self):
        return self.compiled.graph

    @property
    def target(self):
        return self.compiled.target

    @property
    def device(self) -> torch.device:
        return self.compiled.device

    def predicted_overlap_cycles(self) -> float:
        """Transfer cycles the double-buffered staging can hide behind the
        preceding segment's compute (scheduler-consistent accounting)."""
        return sum(b["overlap_cycles"] for b in self._boundaries)

    # -- compilation -----------------------------------------------------
    def warmup(self, params: dict, inputs: dict) -> AotEntry:
        """Convert ``params``, run the shape pass and capture the graph for
        these input shapes and dtypes.  Idempotent per (params identity,
        signature); ``run`` calls it implicitly on a cache miss.  Its
        launches are not counted: the graph's are, at each replay."""
        coerced = {k: _as_input(v) for k, v in inputs.items()}
        sig = _sig_of(coerced)
        # params are baked, so an entry is valid only for the dict it was
        # captured with; it holds a strong ref so the id is never recycled
        key = (id(params), sig)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                return entry
            obs.counter("aot.cache_misses").inc()
            with uncounted():
                entry = self._compile(params, coerced, sig)
            self._entries[key] = entry
            return entry

    def _compile(self, params: dict, inputs: dict, sig: tuple) -> AotEntry:
        dev = self.device
        with obs.span(
            "aot.compile", cat="compile", graph=self.graph.name,
            target=self.target.name, memory=self.memory,
        ) as sp:
            t0 = time.perf_counter()
            tparams = params_to_torch(params, dev)
            static = {k: v.to(dev).clone() for k, v in inputs.items()}
            try:
                env = self._run_segments(tparams, dict(static), keep_all=True)
            except Exception as e:
                raise AotCompileError(
                    f"whole-graph shape pass failed for {self.graph.name} on {self.target.name}: {e}"
                ) from e
            shapes = {name: (tuple(t.shape), t.dtype) for name, t in env.items()}
            arena, arena_elems, fallbacks = None, 0, ()
            if self.memory == "arena":
                fn, arena, fallbacks = self._build_arena_fn(tparams, static, shapes)
                arena_elems = arena.numel()
            else:
                fn = self._build_xla_fn(tparams, static)
            _sync(dev)
            t1 = time.perf_counter()
            graph, compile_us = None, None
            if dev.type == "cuda":
                try:
                    with obs.span("aot.capture", cat="compile"):
                        graph = capture(fn, dev)
                except Exception as e:
                    raise AotCompileError(
                        f"whole-graph capture failed for {self.graph.name} on {self.target.name}: {e}"
                    ) from e
                compile_us = (time.perf_counter() - t1) * 1e6
            sp.set(trace_us=(t1 - t0) * 1e6, compile_us=compile_us, arena_fallbacks=list(fallbacks))
        if fallbacks:
            obs.counter("aot.arena_fallbacks").inc(len(fallbacks))
        return AotEntry(
            signature=sig,
            run_fn=fn,
            inputs=static,
            trace_us=(t1 - t0) * 1e6,
            compile_us=compile_us,
            params=params,
            graph=graph,
            arena=arena,
            arena_elems=arena_elems,
            arena_fallbacks=tuple(fallbacks),
        )

    def _run_segments(self, tparams: dict, env: dict, *, keep_all: bool = False) -> dict:
        """The segments in schedule order over ``env``; the graph outputs,
        or with ``keep_all`` every tensor (the shape pass)."""
        for ls in self.compiled.segments:
            env[ls.output_name] = ls.fn(ls.params_slice(tparams), *[env[nm] for nm in ls.input_names])
        return env if keep_all else {o: env[o] for o in self.graph.outputs}

    def _build_xla_fn(self, tparams: dict, static: dict) -> Callable:
        """Whole sequence with intermediates as ordinary tensors."""
        return lambda: self._run_segments(tparams, dict(static))

    def _build_arena_fn(self, tparams: dict, static: dict, shapes: dict):
        """Whole sequence through the planned arena: every buffer at its
        first-fit/hill-climb offset, cross-module boundary tensors staged
        through two alternating double-buffer slots.  Returns the function,
        the arena and the buffers that fell back to ordinary tensors."""
        graph = self.graph
        segments = self.compiled.segments
        view = self.compiled.memory_plan.arena_view()

        def elems(name: str) -> int:
            return int(np.prod(shapes[name][0])) if shapes[name][0] else 1

        # planned placement; a tensor larger than its planned slot (the
        # plan sized it in declared elem_bytes) falls back to a tensor
        place: dict[str, int] = {}
        fallbacks: list[str] = []
        for name in shapes:
            off = view.offsets.get(name)
            if off is None:
                continue
            if elems(name) <= view.capacities_elems.get(name, 0):
                place[name] = off
            else:
                fallbacks.append(name)

        # double-buffer staging slots for cross-module boundary tensors
        # whose only consumer is the next segment (classic handoff shape)
        consumers_of: dict[str, set[int]] = {}
        for i, ls in enumerate(segments):
            for nm in ls.input_names:
                consumers_of.setdefault(nm, set()).add(i)
        staged: dict[str, int] = {}
        for b in self._boundaries:
            t = b["tensor"]
            nxt = next(i for i, ls in enumerate(segments) if ls.name == b["consumer"])
            if t in place and consumers_of.get(t, set()) == {nxt} and t not in graph.outputs:
                staged[t] = b["slot"]
        slot_elems = [0, 0]
        for t, s in staged.items():
            slot_elems[s] = max(slot_elems[s], elems(t))
        slot_off = [view.length_elems, view.length_elems + slot_elems[0]]
        arena_elems = max(1, view.length_elems + slot_elems[0] + slot_elems[1])
        arena = torch.zeros(arena_elems, dtype=torch.float32, device=self.device)
        storage = arena.untyped_storage().data_ptr()

        def offset_of(name: str) -> int | None:
            if name in staged:
                return slot_off[staged[name]]
            return place.get(name)

        def whole() -> dict:
            loose: dict[str, torch.Tensor] = {}  # fallbacks and unplanned tensors

            def store(name: str, val: torch.Tensor) -> None:
                off = offset_of(name)
                if off is None:
                    loose[name] = val
                    return
                if val.untyped_storage().data_ptr() == storage:
                    val = val.clone()  # a segment that returned its input's arena view
                arena[off : off + elems(name)].copy_(val.reshape(-1))

            def load(name: str) -> torch.Tensor:
                off = offset_of(name)
                if off is None:
                    return loose[name]
                shape, dtype = shapes[name]
                return arena[off : off + elems(name)].view(shape).to(dtype)

            for name, val in static.items():
                store(name, val)
            for ls in segments:
                xs = [load(nm) for nm in ls.input_names]
                store(ls.output_name, ls.fn(ls.params_slice(tparams), *xs))
            return {o: load(o) for o in graph.outputs}

        return whole, arena, fallbacks

    # -- execution -------------------------------------------------------
    def run(self, params: dict, inputs: dict) -> dict:
        """Execute the whole graph with one replay (on the CPU, one pass
        of the sequence).

        Bit-exact with ``CompiledModel.run(params, inputs)``.  The first
        call per (params, input signature) pays :meth:`warmup`; the
        outputs are copies, which no later run overwrites.
        """
        tr = obs.get_tracer()
        if tr.enabled:
            return self._run_traced(tr, params, inputs)
        coerced = {k: _as_input(v) for k, v in inputs.items()}
        return self._run_entry(self.warmup(params, coerced), coerced)

    def _run_entry(self, entry: AotEntry, coerced: dict) -> dict:
        with self._lock:  # the static inputs and the arena are single-owner state
            entry.calls += 1
            for k, v in coerced.items():
                entry.inputs[k].copy_(v)
            out = entry.graph.replay() if entry.graph is not None else entry.run_fn()
            return {k: v.clone() for k, v in out.items()}

    def _run_traced(self, tr, params: dict, inputs: dict) -> dict:
        """:meth:`run`'s work in the same order, each phase a span on lane
        ``run:aot`` inside ``aot.run:<graph>``: ``aot.prepare`` (coercion,
        signature, entry lookup and the lock), ``aot.input_copy``,
        ``aot.replay`` (asynchronous on the card: the launch, not the
        device's work) and ``aot.output_clone``."""
        t0 = tr.now_us()
        try:
            coerced = {k: _as_input(v) for k, v in inputs.items()}
            entry = self.warmup(params, coerced)
            with self._lock:
                entry.calls += 1
                t1 = tr.now_us()
                for k, v in coerced.items():
                    entry.inputs[k].copy_(v)
                t2 = tr.now_us()
                out = entry.graph.replay() if entry.graph is not None else entry.run_fn()
                t3 = tr.now_us()
                res = {k: v.clone() for k, v in out.items()}
                t4 = tr.now_us()
            for name, a, b in (("aot.prepare", t0, t1), ("aot.input_copy", t1, t2), ("aot.replay", t2, t3),
                               ("aot.output_clone", t3, t4)):
                tr.complete(name, a, cat="runtime", lane="run:aot", end_us=b)
            return res
        finally:
            tr.complete(self._span_name, t0, cat="runtime", lane="run:aot", attrs=self._span_attrs)

    def verify(self, params: dict, inputs: dict) -> float:
        """Max |AOT - per-segment CompiledModel.run| over graph outputs
        (0.0 = bit-exact)."""
        ref = self.compiled.run(params, inputs)
        got = self.run(params, inputs)
        err = 0.0
        for k in ref:
            diff = (ref[k].to("cpu", torch.float64) - got[k].to("cpu", torch.float64)).abs()
            err = max(err, float(diff.max()) if diff.numel() else 0.0)
        return err

    # -- measurement -----------------------------------------------------
    def measure_dispatch_overhead(self, params: dict, inputs: dict, *, repeats: int = 7) -> dict:
        """Quantify the per-segment host-dispatch cost this executor
        eliminates: median host-clock µs of the per-segment loop against
        one AOT run (both warm, each ended by ``torch.cuda.synchronize()``
        on the card), divided by the segment count.  Recorded and shipped
        in ``stats()`` / ``report_dict()["aot"]``."""
        self.warmup(params, inputs)
        tparams = params_to_torch(params, self.device)

        def once(fn, p) -> float:
            t0 = time.perf_counter()
            fn(p, inputs)
            _sync(self.device)
            return (time.perf_counter() - t0) * 1e6

        once(self.compiled.run, tparams), once(self.run, params)  # warm both paths
        seg_us = float(np.median([once(self.compiled.run, tparams) for _ in range(repeats)]))
        aot_us = float(np.median([once(self.run, params) for _ in range(repeats)]))
        n = max(1, len(self.compiled.segments))
        self._dispatch_overhead = {
            "repeats": repeats,
            "segments": n,
            "per_segment_path_us": seg_us,
            "aot_us": aot_us,
            "dispatch_overhead_us": seg_us - aot_us,
            "dispatch_overhead_per_segment_us": (seg_us - aot_us) / n,
            "speedup": seg_us / max(aot_us, 1e-9),
        }
        return dict(self._dispatch_overhead)

    def stats(self) -> dict:
        """JSON-safe AOT report with the reference's keys: capture cost,
        plan coverage, staging accounting, measured dispatch overhead (the
        ``report_dict()["aot"]`` payload).  Donation keys hold ``None``:
        nothing is donated on the card."""
        plan = self.compiled.memory_plan
        io_names = set(self.graph.inputs) | set(self.graph.outputs)
        total = sum(b.nbytes for b in plan.buffers.values())
        internal = sum(b.nbytes for n, b in plan.buffers.items() if n not in io_names)
        if self.memory == "arena":
            fell_back = {n for e in self._entries.values() for n in e.arena_fallbacks}
            covered = sum(b.nbytes for n, b in plan.buffers.items() if n not in fell_back)
            donation = {
                "mode": "arena",
                "plan_bytes": total,
                "covered_bytes": covered,
                "coverage": covered / max(total, 1),
                "arena_donation_honored": None,
                "fallback_buffers": sorted(fell_back),
            }
        else:
            donation = {
                "mode": "xla",
                "plan_bytes": total,
                # intermediates never leave the graph: its memory pool owns
                # them (the aliasing the plan decided is re-derived by the
                # caching allocator instead of imposed)
                "covered_bytes": internal,
                "coverage": internal / max(total, 1),
                "inputs_donated": None,
                "fallback_buffers": sorted(io_names & set(plan.buffers)),
            }
        return {
            "mode": self.memory,
            "segments": len(self.compiled.segments),
            "staging": {
                "enabled": True,
                "slots": 2,
                "boundaries": [dict(b) for b in self._boundaries],
                "predicted_overlap_cycles": self.predicted_overlap_cycles(),
            },
            "donation": donation,
            "plan_aliasing": plan.aliasing_summary(),
            "entries": [e.to_dict() for e in self._entries.values()],
            "dispatch_overhead": self._dispatch_overhead,
        }


def compile_aot(compiled: "CompiledModel", *, memory: str = "xla") -> AotModel:
    """Fuse a :class:`CompiledModel` into one whole-graph executor.

    The returned :class:`AotModel` captures lazily: on
    :meth:`AotModel.warmup` (or the first :meth:`AotModel.run`) for each
    (params, input shapes/dtypes) signature, then cached.  See the module
    docstring for the ``memory`` modes.
    """
    return AotModel(compiled, memory=memory)


# ---------------------------------------------------------------------------
# Lane chaining: the PipelinedModel fast path
# ---------------------------------------------------------------------------


@dataclass
class ChainExecutor:
    """One executor for a dependency-closed run of lane segments.

    ``fn(*xs)`` takes the chain's external inputs (first-use order) and
    returns one output per member segment, so a pipelined worker resolves
    every member from a single call.
    """

    segments: tuple["LoweredSegment", ...]
    ext_inputs: tuple[str, ...]
    fn: Callable

    @property
    def output_names(self) -> tuple[str, ...]:
        return tuple(ls.output_name for ls in self.segments)


def build_chains(lane: Sequence["LoweredSegment"], graph_inputs: Sequence[str]) -> list[list["LoweredSegment"]]:
    """Group a module lane into maximal dependency-closed runs.

    A segment joins the current chain when every one of its external
    inputs is either a graph input (resolved before the stream starts)
    or produced by an earlier member of the same chain — i.e. collapsing
    the run into one call never has to *wait* mid-chain on another
    lane's result.  Anything else starts a new chain.
    """
    always = set(graph_inputs)
    chains: list[list["LoweredSegment"]] = []
    for ls in lane:
        if chains:
            produced = {c.output_name for c in chains[-1]}
            if all(nm in produced or nm in always for nm in ls.input_names):
                chains[-1].append(ls)
                continue
        chains.append([ls])
    return chains


def make_chain_executor(chain: Sequence["LoweredSegment"], params: dict) -> ChainExecutor:
    """One callable running ``chain``'s members in order, with the same
    outputs as the per-segment loop.  ``params`` (numpy or tensors) are
    converted once per device, at the first call on it.  Capturing a chain
    in a CUDA graph belongs to the pipelined runtime that replays it."""
    chain = tuple(chain)
    internal = {ls.output_name for ls in chain}
    ext: list[str] = []
    for ls in chain:
        for nm in ls.input_names:
            if nm not in internal and nm not in ext:
                ext.append(nm)
    ext_t = tuple(ext)
    seg_params: dict[torch.device, list[dict]] = {}

    def run(*xs):
        dev = xs[0].device
        if dev not in seg_params:
            tp = params_to_torch(params, dev)
            seg_params[dev] = [ls.params_slice(tp) for ls in chain]
        env = dict(zip(ext_t, xs))
        for ls, sp in zip(chain, seg_params[dev]):
            env[ls.output_name] = ls.fn(sp, *[env[nm] for nm in ls.input_names])
        return tuple(env[ls.output_name] for ls in chain)

    return ChainExecutor(chain, ext_t, run)

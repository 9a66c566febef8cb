"""PipelinedModel: concurrent multi-module execution of a CompiledModel — on the card.

The port of ``repro.pipeline.runtime``.  The reference runs one worker
thread per execution module, each tensor a future, so a segment starts
once its inputs resolve and its module is free.  On the card the device
does that scheduling itself: **one CUDA stream per module lane** takes
the place of a worker thread.

* One host thread enqueues every input's steps in the schedule's start
  order (a topological order: a consumer never starts before its
  producers finish) onto their lanes' streams.  A lane's stream runs its
  steps in lane order, so it executes a segment only when the module is
  free.
* A cross-lane edge is a CUDA event recorded on the producer's stream
  after the producing step, which the consumer's stream waits on
  (``Stream.wait_event``).  The device then starts a segment when its
  inputs are ready and its lane is free — the reference's semantics,
  without host threads contending for the interpreter lock.
* ``run_stream`` pipelines across inputs: at most ``depth`` inputs are in
  flight, input k+depth is enqueued only once every step of input k has
  completed (its events waited on, within ``timeout_s``).  Every tensor
  of an input stays referenced until then, so the caching allocator can
  never hand a block that another lane still reads to new work: the
  ``depth`` live copies are the rotating queue copies the streaming
  memory plan reserves.
* Errors raised while enqueueing propagate (after the streams drain); a
  device fault surfaces at the wait.

``aot=True`` collapses each lane into dependency-closed chains
(:func:`repro_torch.backend.aot.build_chains`) and captures each chain in
a CUDA graph (:func:`repro_torch._graphs.capture`), replayed on its lane's
stream.  A replay rewrites the graph's static outputs, so each chain keeps
``stream_depth`` captured instances, used in rotation by input index: an
instance is reused only after the input it last served completed.  Graph
outputs are copied out of the static outputs; launch counts stay exact
under replay.  Params are converted once per params dict (the reference
caches chain executors by ``id(params)``) and captures once per input
signature.

Bit-exactness holds by construction: every step calls the same fused
``LoweredSegment.fn`` executors on the same operands the sequential
``CompiledModel.run`` loop would.  On the CPU the same code runs the
steps in the same order with no streams, no events and no capture.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Sequence

import torch

from repro_torch import obs
from repro_torch._graphs import capture, uncounted
from repro_torch.cnn.execute import params_to_torch

from .schedule import PipelineSchedule, schedule_pipeline

if TYPE_CHECKING:  # import cycle: repro_torch.backend never imports repro_torch.pipeline
    from repro_torch.backend.lower import LoweredSegment
    from repro_torch.backend.runtime import CompiledModel

__all__ = ["PipelinedModel", "wait_event"]


def wait_event(event: torch.cuda.Event, timeout_s: float, what: str) -> None:
    """Return once the device has passed ``event``; raise
    :class:`TimeoutError` after ``timeout_s`` seconds.  Polls, yielding
    the interpreter lock between polls with ``sleep(0)``: on the card's
    host a short nonzero sleep lasts far longer than asked."""
    if event.query():
        return
    deadline = time.monotonic() + timeout_s
    while not event.query():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what} did not complete within {timeout_s}s")
        time.sleep(0)


@dataclass
class _Step:
    """One unit of a lane's work: one segment, or one chain (aot)."""

    module: str
    ext_inputs: tuple[str, ...]
    output_names: tuple[str, ...]
    call: Callable  # call(k, *xs) -> tuple of outputs, one per output name


@dataclass
class _InFlight:
    """What one enqueued input holds until it is collected."""

    k: int
    env: dict  # every tensor of the input, referenced until its steps completed
    done: dict = field(default_factory=dict)  # lane -> event after its last step
    spans: list = field(default_factory=list)  # (name, module, start, end) events


class PipelinedModel:
    """A CompiledModel executing concurrently across execution modules.

    ``schedule`` defaults to :func:`schedule_pipeline` over the compiled
    mapping; its per-module lane order is the order each lane's stream
    executes its segments in, and its start times the order the host
    enqueues them.  ``stream_depth`` bounds in-flight inputs for
    ``run_stream`` (2 = classic double buffering) and sizes the rotating
    inter-stage queue copies in the pipeline-aware memory plan.
    ``validate_memory=True`` fails fast (``MemoryPlanError``) when an
    overlap-aware plan no longer fits the declared capacities — the
    single-input plan at construction, the streaming plan on the first
    ``run_stream`` call.  ``timeout_s`` bounds every wait on the device.
    ``aot=True`` replays one captured CUDA graph per lane chain (see the
    module docstring).
    """

    def __init__(
        self,
        compiled: "CompiledModel",
        schedule: PipelineSchedule | None = None,
        *,
        stream_depth: int = 2,
        validate_memory: bool = True,
        timeout_s: float = 600.0,
        aot: bool = False,
    ):
        from repro_torch.backend.memory import plan_memory

        if stream_depth < 1:
            raise ValueError(f"stream_depth must be >= 1, got {stream_depth}")
        self.compiled = compiled
        self.schedule = schedule if schedule is not None else schedule_pipeline(compiled.mapped)
        self.schedule.validate()
        # an externally supplied schedule must describe THIS mapping —
        # lanes index into compiled.segments, so a foreign schedule would
        # silently skip segments and leave their consumers unfed
        segs = compiled.mapped.segments
        if (
            {e.index for e in self.schedule.entries} != set(range(len(segs)))
            or len(self.schedule.entries) != len(segs)  # no duplicate indices
            or any(
                e.name != segs[e.index].anchor.name
                or e.module != segs[e.index].module
                for e in self.schedule.entries
            )
        ):
            raise ValueError(
                "schedule does not match the compiled mapping "
                f"({self.schedule.graph_name!r} vs {compiled.graph.name!r}); "
                "pass schedule_pipeline(compiled.mapped) or None"
            )
        self.stream_depth = int(stream_depth)
        self.timeout_s = float(timeout_s)
        lowered = compiled.segments
        self._lanes: dict[str, list["LoweredSegment"]] = {}
        for module, lane in self.schedule.lanes().items():
            self._lanes[module] = [lowered[e.index] for e in lane]
        # enqueue order: scheduled start, ties by dispatch (topological) index
        self._start = {e.index: (e.start, e.index) for e in self.schedule.entries}
        self._validate_memory = bool(validate_memory)
        self.memory_plan = plan_memory(compiled.mapped, schedule=self.schedule)
        if self._validate_memory:
            self.memory_plan.validate()
        self._streaming_plan = None
        self.aot = bool(aot)
        self._chain_lanes: dict[str, list] = {}
        if self.aot:
            from repro_torch.backend.aot import build_chains

            graph_inputs = set(compiled.graph.inputs)
            for module, lane in self._lanes.items():
                self._chain_lanes[module] = build_chains(lane, graph_inputs)
        # (params id, input signature) -> (params ref, steps): the strong
        # params ref keeps id() stable for the entry's life
        self._chain_cache: dict[tuple, tuple[dict, list[_Step]]] = {}
        self._streams: dict[str, torch.cuda.Stream] = {}

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

    def predicted_makespan(self) -> float:
        return self.schedule.makespan

    def predicted_speedup(self) -> float:
        return self.schedule.speedup()

    def streaming_plan(self):
        """The overlap-aware memory plan for ``run_stream`` — the
        single-input plan plus ``stream_depth`` rotating queue copies
        per buffer.  Built (and validated, when the model was
        constructed with ``validate_memory=True``) on first use."""
        if self._streaming_plan is None:
            from repro_torch.backend.memory import plan_memory

            self._streaming_plan = plan_memory(
                self.compiled.mapped,
                schedule=self.schedule,
                stream_depth=self.stream_depth,
            )
            if self._validate_memory:
                self._streaming_plan.validate()
        return self._streaming_plan

    # -- execution -------------------------------------------------------
    def run(self, params: dict, inputs: dict) -> dict:
        """Execute one input concurrently; bit-exact with the sequential
        ``CompiledModel.run`` (independent branches overlap across
        modules, chains serialise on their dependencies)."""
        return self._execute(params, [inputs], depth=1)[0]

    def run_stream(
        self,
        params: dict,
        inputs: Sequence[dict],
        *,
        depth: int | None = None,
    ) -> list[dict]:
        """Software-pipelined streaming execution of many inputs.

        At most ``depth`` (default ``self.stream_depth``) inputs are in
        flight, so early pipeline stages start input k+1 while late
        stages finish input k.  ``depth`` may not exceed
        ``self.stream_depth`` — the memory plan reserved exactly that many
        rotating queue copies.  Outputs are returned in input order, each
        bit-exact with a sequential ``run`` of that input.
        """
        d = self.stream_depth if depth is None else int(depth)
        if not 1 <= d <= self.stream_depth:
            raise ValueError(
                f"depth must be in [1, stream_depth={self.stream_depth}], "
                f"got {d} — construct the model with a larger stream_depth "
                "to admit more in-flight inputs"
            )
        if d > 1:
            self.streaming_plan()  # reserve + validate the queue copies
        return self._execute(params, list(inputs), depth=d)

    def _segment_steps(self, params: dict) -> list[_Step]:
        """One step per segment, params converted once for this call."""
        tparams = params_to_torch(params, self.device)
        steps = []
        for module, lane in self._lanes.items():
            for ls in lane:
                sp = ls.params_slice(tparams)
                steps.append(
                    _Step(
                        module,
                        tuple(ls.input_names),
                        (ls.output_name,),
                        (lambda sp, f: lambda k, *xs: (f(sp, *xs),))(sp, ls.fn),
                    )
                )
        return self._ordered(steps)

    def _ordered(self, steps: list[_Step]) -> list[_Step]:
        index = {ls.output_name: ls.index for ls in self.compiled.segments}
        return sorted(steps, key=lambda s: self._start[index[s.output_names[0]]])

    def _chain_steps(self, params: dict, example: dict) -> list[_Step]:
        """One step per lane chain (aot), built once per params dict and
        input signature: on the card ``stream_depth`` captured instances
        per chain, on the CPU the chain executor itself."""
        from repro_torch.backend.aot import make_chain_executor

        sig = tuple(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in example.items()))
        key = (id(params), sig)
        hit = self._chain_cache.get(key)
        if hit is not None and hit[0] is params:
            return hit[1]
        dev = self.device
        tparams = params_to_torch(params, dev)
        env: dict = {}
        if dev.type == "cuda":
            # the shape pass: every tensor a chain reads, from one eager run
            with uncounted():
                env = dict(example)
                for ls in self.compiled.segments:
                    env[ls.output_name] = ls.fn(
                        ls.params_slice(tparams), *[env[nm] for nm in ls.input_names]
                    )
        steps = []
        for module, chains in self._chain_lanes.items():
            for chain in chains:
                ce = make_chain_executor(chain, tparams)
                if dev.type == "cuda":
                    call = self._captured_chain(ce, [env[nm] for nm in ce.ext_inputs])
                else:
                    call = (lambda fn: lambda k, *xs: fn(*xs))(ce.fn)
                steps.append(_Step(module, ce.ext_inputs, ce.output_names, call))
        steps = self._ordered(steps)
        self._chain_cache[key] = (params, steps)
        return steps

    def _captured_chain(self, ce, examples: list) -> Callable:
        """``stream_depth`` captured graphs of one chain; input k replays
        instance ``k % stream_depth`` on the current (lane) stream after
        copying its operands into that instance's static inputs."""
        instances = []
        for _ in range(self.stream_depth):
            static = [x.clone() for x in examples]
            graph = capture((lambda s: lambda: ce.fn(*s))(static), self.device)
            instances.append((static, graph))

        def call(k, *xs):
            static, graph = instances[k % len(instances)]
            for s, x in zip(static, xs):
                s.copy_(x)
            return graph.replay()

        return call

    def _stream(self, module: str) -> torch.cuda.Stream:
        s = self._streams.get(module)
        if s is None:
            s = self._streams[module] = torch.cuda.Stream(self.device)
        return s

    def _execute(self, params: dict, inputs_list: list[dict], *, depth: int) -> list[dict]:
        from repro_torch.backend.runtime import as_input_array

        n_inputs = len(inputs_list)
        if n_inputs == 0:
            return []
        dev = self.device
        cuda = dev.type == "cuda"
        coerced = [{k: as_input_array(v, dev) for k, v in x.items()} for x in inputs_list]
        steps = self._chain_steps(params, coerced[0]) if self.aot else self._segment_steps(params)
        outputs = set(self.graph.outputs)
        tracer = obs.get_tracer()
        tracing = tracer.enabled
        ref = None
        if tracing and cuda:
            # the host time of one device event: device spans are placed
            # relative to it
            ref = torch.cuda.Event(enable_timing=True)
            ref.record()
            ref.synchronize()
            ref = (ref, tracer.now_us())
        signals = self._signals(steps) if cuda else []
        results: list[dict] = [{} for _ in range(n_inputs)]
        pending: deque[_InFlight] = deque()
        try:
            for k in range(n_inputs):
                if len(pending) >= depth:
                    self._collect(pending.popleft(), results, ref)
                pending.append(self._enqueue(k, coerced[k], steps, signals, outputs, tracing))
            while pending:
                self._collect(pending.popleft(), results, ref)
        except BaseException:
            if cuda:  # let in-flight work finish before its tensors go
                for s in self._streams.values():
                    s.synchronize()
            raise
        return results

    @staticmethod
    def _signals(steps: list[_Step]) -> list[bool]:
        """Which steps record an event: those with an output another lane
        reads, and each lane's last step (its completion)."""
        index_of = {nm: i for i, st in enumerate(steps) for nm in st.output_names}
        signals = [False] * len(steps)
        for st in steps:
            for nm in st.ext_inputs:
                i = index_of.get(nm)
                if i is not None and steps[i].module != st.module:
                    signals[i] = True
        for i in {st.module: i for i, st in enumerate(steps)}.values():
            signals[i] = True
        return signals

    def _enqueue(
        self, k: int, inputs: dict, steps: list[_Step], signals: list[bool], outputs: set, tracing: bool
    ) -> _InFlight:
        """Enqueue every step of input ``k`` onto its lane (run it, on the
        CPU)."""
        fl = _InFlight(k, dict(inputs))
        env = fl.env
        if self.device.type != "cuda":
            tracer = obs.get_tracer()
            for st in steps:
                t0_us = tracer.now_us() if tracing else 0.0
                env.update(zip(st.output_names, st.call(k, *[env[nm] for nm in st.ext_inputs])))
                if tracing:
                    tracer.complete(
                        f"{st.output_names[0]}@{k}", t0_us, cat="runtime",
                        lane=f"pipeline:{st.module}", attrs={"input": k},
                    )
            return fl
        made_on: dict[str, str] = {}  # tensor -> lane that produced it
        after: dict[str, torch.cuda.Event] = {}  # tensor -> event after its step
        started: set[str] = set()
        caller = cur = torch.cuda.current_stream(self.device)
        inputs_ready = torch.cuda.Event()
        inputs_ready.record(caller)
        try:
            for st, signal in zip(steps, signals):
                stream = self._stream(st.module)
                if stream != cur:  # switched only when the lane changes
                    torch.cuda.set_stream(stream)
                    cur = stream
                if st.module not in started:
                    stream.wait_event(inputs_ready)  # the inputs, and the caller's earlier work
                    started.add(st.module)
                for nm in st.ext_inputs:
                    lane = made_on.get(nm)
                    if lane is not None and lane != st.module:
                        stream.wait_event(after[nm])
                if tracing:
                    t0 = torch.cuda.Event(enable_timing=True)
                    t0.record(stream)
                outs = st.call(k, *[env[nm] for nm in st.ext_inputs])
                if self.aot:  # the captured outputs are rewritten by the instance's next replay
                    outs = tuple(o.clone() if nm in outputs else o for nm, o in zip(st.output_names, outs))
                if signal or tracing:
                    done = torch.cuda.Event(enable_timing=tracing)
                    done.record(stream)
                    if tracing:
                        fl.spans.append((f"{st.output_names[0]}@{k}", st.module, t0, done))
                    fl.done[st.module] = done
                    for nm in st.output_names:
                        after[nm] = done
                for nm in st.output_names:
                    made_on[nm] = st.module
                env.update(zip(st.output_names, outs))
        finally:
            torch.cuda.set_stream(caller)
        return fl

    def _collect(self, fl: _InFlight, results: list[dict], ref) -> None:
        """Wait for every lane's last step of one input, then hand out its
        outputs and release the rest of its tensors."""
        for module, ev in fl.done.items():
            wait_event(ev, self.timeout_s, f"input {fl.k} on lane {module!r}")
        if ref is not None:
            tracer = obs.get_tracer()
            ref_ev, ref_us = ref
            for name, module, t0, t1 in fl.spans:
                start = ref_us + ref_ev.elapsed_time(t0) * 1e3
                # the tracer's public calls end a span now; a span timed by
                # CUDA events is appended with its own start and duration
                tracer._append(
                    name, "runtime", start, t0.elapsed_time(t1) * 1e3,
                    tracer._tid(f"pipeline:{module}"), {"input": fl.k},
                )
        results[fl.k] = {o: fl.env[o] for o in self.graph.outputs}

    # -- verification ----------------------------------------------------
    def verify(self, params: dict, inputs: dict) -> float:
        """Max |pipelined - sequential| over graph outputs (0.0 = exact).

        On divergence, ``CompiledModel.verify(..., per_segment=True)``
        localizes the first deviating segment against the interpreter.
        """
        ref = self.compiled.run(params, inputs)
        got = self.run(params, inputs)
        err = 0.0
        for k in ref:
            diff = (ref[k].to("cpu", torch.float64) - got[k].to("cpu", torch.float64)).abs()
            err = max(err, float(diff.max()) if diff.numel() else 0.0)
        return err

    def report(self) -> str:
        lines = [self.schedule.gantt()]
        lines.append(self.memory_plan.report())
        return "\n".join(lines)

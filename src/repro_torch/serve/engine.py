"""ModelServer: request-level serving over a compiled pipeline — on the card.

The port of ``repro.serve.engine``.  One replica loop, on its own host
thread:

* an :class:`~repro_torch.serve.queue.AdmissionQueue` bounds waiting work
  (reject/backpressure) and pops in Smith's-rule priority order, the
  same order :func:`repro_torch.pipeline.schedule.schedule_stream` proves
  valid (every round's stream schedule is re-built from the round's
  actual priorities and ``validate()``-checked, so priority jumps never
  violate happens-before);
* :class:`~repro_torch.serve.batching.BatchedModel` packs up to
  ``batch_slots`` requests into one execution (the slots folded into the
  batch axis), with one captured CUDA graph per batch shape;
* batches flow through an in-flight window of ``stream_depth`` —
  :meth:`PipelinedModel.run_stream` in ``mode="pipeline"`` (one CUDA
  stream per execution module, admission bounding in-flight inputs), or
  ``stream_depth`` replayed batches in ``mode="aot"``, each finished by a
  CUDA event waited on in completion order;
* every request gets a span on the ``serve:<replica>`` trace lane and
  feeds the ``serve.*`` metrics (`queue_depth`, `rejected`,
  `latency_us`, `p99_us`) that ship in ``report_dict()["obs"]``; the
  replica's aggregate stats land in ``report_dict()["serve"]``;
* latency quantiles come from a rolling
  :class:`repro_torch.obs.WindowedSketch` — O(1) per request, bounded
  memory, merge-on-read; pass ``slo=[SloSpec(...)]`` for rolling
  burn-rate SLO evaluation per round (verdicts in
  ``report_dict()["obs"]["slo"]``) and ``shed_expired=True`` to resolve
  already-expired requests with :class:`DeadlineExceededError` at round
  build instead of running them.  Every request also lands in the
  always-on flight recorder, so an armed process dumps a Perfetto
  incident JSON on queue-full or SLO breach.

Bit-exactness: a served output is a row of the same fused executors
``CompiledModel.run`` calls, run over the folded batch — held
per-request by tests/test_torch_serve.py and, on the card, by
tests/test_torch_cuda.py's ``test_sixteen_slot_server_bit_exact_on_card``.
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from concurrent.futures import Future
from typing import TYPE_CHECKING

import torch

from repro_torch import obs

from repro_torch.pipeline.runtime import wait_event

from .batching import BatchedModel
from .queue import (
    AdmissionQueue,
    DeadlineExceededError,
    QueueFullError,
    ServeHandle,
    ServeRequest,
)

if TYPE_CHECKING:
    from repro_torch.backend.runtime import CompiledModel

__all__ = ["ModelServer", "ServeDrainWarning"]


class ServeDrainWarning(obs.MatchWarning):
    """``close()`` timed out joining a replica's worker loop: a wedged
    daemon thread is leaking and the stamped stats are mid-flight."""

# how long the serving loop waits on an empty queue before re-checking
# for shutdown; bounds close() latency, not request latency (a waiting
# take() wakes immediately on submit)
_IDLE_WAIT_S = 0.05


class ModelServer:
    """One serving replica over a ``CompiledModel`` and fixed params.

    ``batch_slots`` requests share one folded execution;
    ``stream_depth`` batches may be in flight at once; ``queue_capacity``
    + ``policy`` ("reject" | "block") set the admission valve.
    ``mode="aot"`` (default) replays one captured batch graph per group;
    ``mode="pipeline"`` runs batches through a batched
    :class:`~repro_torch.pipeline.runtime.PipelinedModel.run_stream` so
    execution modules overlap *within* each batch too.

    ``slo`` takes :class:`repro_torch.obs.SloSpec` objectives evaluated once
    per round over a ``slo_window_s`` rolling window (breach transitions
    warn once and fire ``on_breach``); ``shed_expired=True`` resolves
    requests whose deadline passed before their round with
    :class:`DeadlineExceededError` instead of running them.
    """

    def __init__(
        self,
        compiled: "CompiledModel",
        params: dict,
        *,
        batch_slots: int = 4,
        stream_depth: int = 2,
        queue_capacity: int = 64,
        policy: str = "reject",
        mode: str = "aot",
        replica: str = "r0",
        pad_to_slots: bool = True,
        timeout_s: float = 600.0,
        slo=None,
        slo_window_s: float = 60.0,
        on_breach=None,
        shed_expired: bool = False,
    ):
        if batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {batch_slots}")
        if stream_depth < 1:
            raise ValueError(f"stream_depth must be >= 1, got {stream_depth}")
        if mode not in ("aot", "pipeline"):
            raise ValueError(f"unknown serve mode {mode!r} (aot | pipeline)")
        self.compiled = compiled
        self.params = params
        self.batch_slots = int(batch_slots)
        self.stream_depth = int(stream_depth)
        self.mode = mode
        self.replica = replica
        # pad partial groups to batch_slots (rows repeat the last
        # request): every batch then shares ONE captured graph, trading
        # a little wasted compute for zero mid-load captures
        self.pad_to_slots = bool(pad_to_slots)
        self.timeout_s = float(timeout_s)
        self.batched = BatchedModel(compiled)
        self.queue = AdmissionQueue(queue_capacity, policy)
        self._rids = itertools.count()
        self._thread: threading.Thread | None = None
        self._start_lock = threading.Lock()
        self._calls: deque[tuple] = deque()  # (fn, Future) to run on the loop's thread
        self._pipelined = None
        # per-replica aggregates (the process-wide serve.* metrics are
        # shared across replicas; stats() must stay attributable)
        self._submitted = 0
        self._completed = 0
        self._rejected = 0
        self._deadline_misses = 0
        self._shed = 0
        self._rounds = 0
        self._batches = 0
        self._drained = True
        # rolling latency window: O(1) insert per request, quantiles by
        # merge-on-read
        self._lat_sketch = obs.WindowedSketch(
            window_s=float(slo_window_s), intervals=12, relative_accuracy=0.01
        )
        self._last_round: dict = {}
        # declarative service objectives, evaluated once per round over
        # the same rolling window; verdicts publish process-wide into
        # report_dict()["obs"]["slo"] under this replica's engine name
        self.shed_expired = bool(shed_expired)
        specs = tuple(slo) if slo else ()
        self.slo = (
            obs.SloEngine(
                specs,
                name=f"serve:{replica}",
                window_s=float(slo_window_s),
                on_breach=on_breach,
            )
            if specs
            else None
        )

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "ModelServer":
        with self._start_lock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name=f"serve-{self.replica}"
                )
                self._thread.start()
        return self

    def close(self) -> None:
        """Stop admitting, drain everything queued, join the loop, and
        stamp the final stats into ``compiled.attrs["serve"]``.

        A worker that outlives ``timeout_s`` is a wedged replica, not a
        slow one: it is reported (``ServeDrainWarning`` + ``drained:
        False`` in :meth:`stats`) instead of silently leaking a daemon
        thread behind stats stamped mid-flight."""
        self.queue.close()
        t = self._thread
        if t is not None:
            t.join(self.timeout_s)
            if t.is_alive():
                self._drained = False
                obs.counter("serve.drain_timeouts").inc()
                obs.warn(
                    f"serve replica {self.replica!r}: worker loop did not "
                    f"drain within timeout_s={self.timeout_s:g}s — a wedged "
                    "daemon thread is leaking and the stamped stats are "
                    "mid-flight (drained: false)",
                    ServeDrainWarning,
                    logger="serve",
                )
        self._stamp()

    def warmup(self, example_inputs: dict) -> "ModelServer":
        """Capture the full-batch graph (in pipeline mode: stream
        ``stream_depth`` batches through the pipelined clone, which also
        builds its streaming memory plan) before load arrives, so the first
        round pays no capture and no planning.  ``example_inputs`` is one
        request's input dict; the result is discarded.

        It runs on the serving loop's own thread: cuDNN keeps its
        execution plans per thread, so a warm-up on the caller's thread
        leaves the loop's first round to build them again."""
        batch = [example_inputs] * self.batch_slots
        if self.mode == "pipeline":
            stacked = [self.batched.stack(batch)] * self.stream_depth
            self._on_loop(lambda: self._pipelined_model().run_stream(self.params, stacked))
        else:
            self._on_loop(lambda: self.batched.run_batch(self.params, batch))
        return self

    def _on_loop(self, fn) -> None:
        """Run ``fn()`` on the serving loop's thread (picked up within one
        idle wait) and return once it has, re-raising what it raised."""
        self.start()
        if not self._thread.is_alive():
            raise RuntimeError(f"serve replica {self.replica!r} is closed")
        fut: Future = Future()
        self._calls.append((fn, fut))
        fut.result(self.timeout_s)

    def __enter__(self) -> "ModelServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- client side -----------------------------------------------------
    def submit(
        self,
        inputs: dict,
        *,
        priority: float = 1.0,
        deadline_us: float | None = None,
    ) -> ServeHandle:
        """Admit one request; returns its :class:`ServeHandle`.

        ``priority`` is the Smith weight (higher jumps the lane order);
        ``deadline_us`` is relative to now — a completion past it counts
        as a miss in the stats, it does not cancel the request.  Raises
        :class:`QueueFullError` past the admission bound under
        ``policy="reject"``.
        """
        self.start()
        now = obs.get_tracer().now_us()
        req = ServeRequest(
            rid=next(self._rids),
            inputs=inputs,
            priority=float(priority),
            deadline_us=None if deadline_us is None else now + float(deadline_us),
            arrival_us=now,
        )
        req.handle = ServeHandle(req.rid)
        obs.counter("serve.submitted").inc()
        self._submitted += 1
        try:
            self.queue.put(req, timeout=self.timeout_s)
        except QueueFullError:
            self._rejected += 1
            if self.slo is not None:
                self.slo.record("rejected", now_s=now * 1e-6)
            raise
        return req.handle

    # -- serving loop ----------------------------------------------------
    def _loop(self) -> None:
        # inference mode is per thread: the loop's own thread enters it
        with torch.inference_mode():
            self._serve_forever()

    def _serve_forever(self) -> None:
        while True:
            while self._calls:
                fn, fut = self._calls.popleft()
                try:
                    fut.set_result(fn())
                except Exception as e:  # the caller of _on_loop re-raises it
                    fut.set_exception(e)
            reqs = self.queue.take(
                self.batch_slots * self.stream_depth, timeout=_IDLE_WAIT_S
            )
            if not reqs:
                if self.queue.closed:
                    return
                continue
            try:
                self._serve_round(reqs)
            except BaseException as e:  # resolve, don't kill the replica
                for r in reqs:
                    if not r.handle.done():
                        r.handle._future.set_exception(e)

    def _serve_round(self, reqs: list[ServeRequest]) -> None:
        # the round's stream schedule: requests in the queue's pop order
        # with their real weights — Smith order by construction, and
        # validate() proves priority jumps never break happens-before or
        # per-module serialisation
        from repro_torch.pipeline.schedule import schedule_stream

        if self.shed_expired:
            reqs = self._shed_expired(reqs)
            if not reqs:
                self._finish_round()
                return
        ss = schedule_stream(
            self.compiled.mapped, [r.priority for r in reqs], order="smith"
        )
        ss.validate()
        self._rounds += 1
        self._last_round = {
            "requests": len(reqs),
            "rids": [r.rid for r in reqs],
            "weighted_completion_cycles": ss.attrs["weighted_completion"],
            "makespan_cycles": ss.makespan,
        }
        groups = [
            reqs[i : i + self.batch_slots]
            for i in range(0, len(reqs), self.batch_slots)
        ]
        self._batches += len(groups)
        if self.mode == "pipeline":
            self._serve_pipelined(groups)
        else:
            self._serve_aot(groups)
        self._finish_round()

    def _shed_expired(self, reqs: list[ServeRequest]) -> list[ServeRequest]:
        """Drop requests whose deadline already passed *before* spending
        a batch slot on them: the future resolves with
        :class:`DeadlineExceededError` now instead of a dead result
        later.  Runs at round build, off the queue's pop order."""
        now = obs.get_tracer().now_us()
        fl = obs.get_flight()
        keep: list[ServeRequest] = []
        for r in reqs:
            if r.deadline_us is not None and now > r.deadline_us:
                self._shed += 1
                obs.counter("serve.shed").inc()
                fl.record_request(
                    rid=r.rid, replica=self.replica, arrival_us=r.arrival_us,
                    latency_us=now - r.arrival_us, priority=r.priority,
                    status="shed",
                )
                if self.slo is not None:
                    self.slo.record("shed", now_s=now * 1e-6)
                r.handle._future.set_exception(
                    DeadlineExceededError(
                        f"request {r.rid} expired "
                        f"{now - r.deadline_us:.0f} us before its round "
                        f"(shed_expired=True on replica {self.replica!r})"
                    )
                )
            else:
                keep.append(r)
        return keep

    def _finish_round(self) -> None:
        """Round epilogue: evaluate the SLO specs over the rolling
        window, mark the flight recorder's round counters, stamp."""
        now_us = obs.get_tracer().now_us()
        if self.slo is not None:
            self.slo.evaluate(
                queue_depth=self.queue.depth,
                target=self.compiled.target.name,
                now_s=now_us * 1e-6,
            )
        obs.get_flight().record_mark(
            now_us, f"serve:{self.replica}",
            queue_depth=self.queue.depth, completed=self._completed,
            shed=self._shed, rejected=self._rejected,
        )
        self._stamp()

    def _serve_aot(self, groups: list[list[ServeRequest]]) -> None:
        """One graph replay per group, ``stream_depth`` batches in flight
        (a replay returns before the device finishes; each batch is
        finished by a CUDA event, waited on in completion order)."""
        inflight: deque[tuple[list[ServeRequest], dict, object]] = deque()
        for g in groups:
            if len(inflight) >= self.stream_depth:
                self._finish(*inflight.popleft())
            outs = self.batched.run_batch_async(self.params, self._padded(g))
            done = None
            if self.compiled.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
            inflight.append((g, outs, done))
        while inflight:
            self._finish(*inflight.popleft())

    def _padded(self, g: list[ServeRequest]) -> list[dict]:
        inputs = [r.inputs for r in g]
        if self.pad_to_slots and len(inputs) < self.batch_slots:
            inputs = inputs + [inputs[-1]] * (self.batch_slots - len(inputs))
        return inputs

    def _serve_pipelined(self, groups: list[list[ServeRequest]]) -> None:
        """Feed stacked batches through ``PipelinedModel.run_stream`` —
        module-concurrent within a batch, software-pipelined across
        batches, at most ``stream_depth`` in flight."""
        pm = self._pipelined_model()
        stacked = [self.batched.stack(self._padded(g)) for g in groups]
        outs = pm.run_stream(self.params, stacked)
        for g, out in zip(groups, outs):
            self._resolve(g, out)

    def _pipelined_model(self):
        if self._pipelined is None:
            from repro_torch.pipeline.runtime import PipelinedModel

            # a shallow clone whose executors take (B, ...) operands: the
            # folding fns are batch-size-agnostic, so one PipelinedModel
            # serves every group size.  Memory validation stays on the
            # unbatched model — the slot axis multiplies the true
            # footprint by B, which the single-slot plan does not claim
            # to bound (stats() records batch_slots for capacity math).
            self._pipelined = PipelinedModel(
                self.batched.batched_compiled(),
                stream_depth=self.stream_depth,
                validate_memory=False,
                timeout_s=self.timeout_s,
            )
        return self._pipelined

    def _finish(self, g: list[ServeRequest], outs: dict, done) -> None:
        if done is not None:
            wait_event(done, self.timeout_s, f"a batch of replica {self.replica!r}")
        self._resolve(g, outs)

    def _resolve(self, g: list[ServeRequest], stacked_outs: dict) -> None:
        tracer = obs.get_tracer()
        fl = obs.get_flight()
        rows = BatchedModel.unstack(stacked_outs, len(g))
        now = tracer.now_us()
        now_s = now * 1e-6
        lat_hist = obs.histogram("serve.latency_us")
        for r, out in zip(g, rows):
            r.handle._future.set_result(out)
            lat = now - r.arrival_us
            lat_hist.observe(lat)
            self._lat_sketch.add(lat, now_s=now_s)
            self._completed += 1
            obs.counter("serve.completed").inc()
            missed = r.deadline_us is not None and now > r.deadline_us
            if missed:
                self._deadline_misses += 1
                obs.counter("serve.deadline_misses").inc()
            if self.slo is not None:
                self.slo.record_request(lat, missed=missed, now_s=now_s)
            fl.record_request(
                rid=r.rid, replica=self.replica, arrival_us=r.arrival_us,
                latency_us=lat, priority=r.priority,
                status="missed" if missed else "ok", batch=len(g),
            )
            tracer.complete(
                f"req{r.rid}",
                r.arrival_us,
                cat="serve",
                lane=f"serve:{self.replica}",
                attrs={"rid": r.rid, "priority": r.priority, "batch": len(g)},
            )
        obs.gauge("serve.p99_us").set(self._quantile(0.99))

    # -- reporting -------------------------------------------------------
    @staticmethod
    def _now_s() -> float:
        # the latency window lives on the tracer's timebase (seconds):
        # adds and merge-on-read must agree on the epoch
        return obs.get_tracer().now_us() * 1e-6

    def _quantile(self, q: float) -> float:
        """Rolling-window latency quantile from the shared sketch —
        O(buckets) merge-on-read, never a sort of raw samples."""
        return self._lat_sketch.quantile(q, now_s=self._now_s())

    def stats(self) -> dict:
        """JSON-safe per-replica serving stats (also stamped into
        ``compiled.attrs["serve"]`` → ``report_dict()["serve"]["engine"]``)."""
        return {
            "replica": self.replica,
            "mode": self.mode,
            "batch_slots": self.batch_slots,
            "stream_depth": self.stream_depth,
            "queue_capacity": self.queue.capacity,
            "policy": self.queue.policy,
            "submitted": self._submitted,
            "completed": self._completed,
            "rejected": self._rejected,
            "deadline_misses": self._deadline_misses,
            "shed": self._shed,
            "rounds": self._rounds,
            "batches": self._batches,
            "queue_depth": self.queue.depth,
            "drained": self._drained,
            "latency_us": self._latency_stats(),
            "slo": self.slo.to_dict() if self.slo is not None else None,
            "last_round": dict(self._last_round),
            "entries": self.batched.entry_stats(),
        }

    def _latency_stats(self) -> dict:
        """The ``stats()["latency_us"]`` payload: same count/p50/p99/mean
        keys as ever, now from the rolling sketch window (plus p90 and
        the sketch's declared accuracy)."""
        merged = self._lat_sketch.merged(now_s=self._now_s())
        return {
            "count": merged.count,
            "p50": merged.quantile(0.50),
            "p90": merged.quantile(0.90),
            "p99": merged.quantile(0.99),
            "mean": merged.mean,
            "window_s": self._lat_sketch.window_s,
            "relative_accuracy": merged.relative_accuracy,
        }

    def _stamp(self) -> None:
        self.compiled.attrs["serve"] = self.stats()

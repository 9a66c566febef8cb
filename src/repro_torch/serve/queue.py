"""Admission-controlled request queue for the serving layer.

A bounded priority queue is the backpressure valve the north star's
"heavy traffic" leg needs: past ``capacity`` waiting requests the
replica is *already* saturated, and accepting more only moves the wait
from the client into an unbounded buffer.  Two policies:

* ``"reject"`` (default) — ``submit`` raises :class:`QueueFullError`
  immediately (load-shedding; the client retries elsewhere).  Every
  shed request increments the ``serve.rejected`` counter.
* ``"block"`` — ``submit`` waits until a slot frees (backpressure; the
  producing thread slows to the replica's service rate).

Ordering is Smith's rule for identical jobs: priority-descending with
FIFO arrival tiebreak, deadline (earliest first) between equal
priorities — the same order :func:`repro_torch.pipeline.schedule.schedule_stream`
assigns lanes under ``order="smith"``, so the queue's pop order IS the
validated stream schedule's request order.

No ``empty()``/``get()`` polling anywhere: every operation holds the
condition lock (the seed engine's empty-then-get race is exactly what
this class exists to not reintroduce).
"""

from __future__ import annotations

import heapq
import itertools
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any

from repro_torch import obs

__all__ = [
    "AdmissionQueue",
    "DeadlineExceededError",
    "QueueFullError",
    "ServeHandle",
    "ServeRequest",
]


class QueueFullError(RuntimeError):
    """The bounded admission queue is full and the policy is "reject"."""


class DeadlineExceededError(RuntimeError):
    """The request's deadline passed before it ran; under
    ``ModelServer(shed_expired=True)`` the server resolves the handle
    with this instead of spending a batch slot on a dead request."""


class ServeHandle:
    """Caller-side future for one submitted request."""

    def __init__(self, rid: int):
        self.rid = rid
        self._future: Future = Future()

    def result(self, timeout: float | None = None) -> dict:
        """The per-request output dict (blocks until served)."""
        return self._future.result(timeout)

    def done(self) -> bool:
        return self._future.done()


@dataclass
class ServeRequest:
    """One admitted request: inputs plus its scheduling metadata."""

    rid: int
    inputs: dict
    priority: float = 1.0
    deadline_us: float | None = None  # absolute, in the tracer's timebase
    arrival_us: float = 0.0
    handle: ServeHandle = field(default=None)  # type: ignore[assignment]

    def sort_key(self, seq: int) -> tuple:
        # Smith's rule for identical jobs: weight-descending, then EDF
        # between equal weights, then arrival order
        dl = self.deadline_us if self.deadline_us is not None else float("inf")
        return (-self.priority, dl, seq)


class AdmissionQueue:
    """Bounded priority queue with reject/block admission control."""

    def __init__(self, capacity: int = 64, policy: str = "reject"):
        if capacity < 1:
            raise ValueError(f"queue capacity must be >= 1, got {capacity}")
        if policy not in ("reject", "block"):
            raise ValueError(f"unknown admission policy {policy!r} (reject | block)")
        self.capacity = int(capacity)
        self.policy = policy
        self._heap: list[tuple[tuple, int, ServeRequest]] = []
        self._seq = itertools.count()
        self._cond = threading.Condition()
        self._closed = False

    def __len__(self) -> int:
        with self._cond:
            return len(self._heap)

    @property
    def depth(self) -> int:
        return len(self)

    def put(self, req: ServeRequest, timeout: float | None = None) -> None:
        """Admit ``req`` or shed it per the policy.

        Raises :class:`QueueFullError` when full under ``"reject"`` (or
        when a ``"block"`` wait times out) — the shed is counted in the
        ``serve.rejected`` metric either way.
        """
        with self._cond:
            if self.policy == "block":
                ok = self._cond.wait_for(
                    lambda: len(self._heap) < self.capacity or self._closed,
                    timeout,
                )
                if not ok:
                    obs.counter("serve.rejected").inc()
                    obs.get_flight().trigger(
                        "queue_full", capacity=self.capacity,
                        policy=self.policy, depth=len(self._heap),
                    )
                    raise QueueFullError(
                        f"queue still full after {timeout}s (capacity "
                        f"{self.capacity}, policy=block)"
                    )
            if self._closed:
                raise RuntimeError("queue is closed")
            if len(self._heap) >= self.capacity:
                obs.counter("serve.rejected").inc()
                # incident capture: the flight recorder snapshots the
                # spans/requests that led here (auto-dumps when armed)
                obs.get_flight().trigger(
                    "queue_full", capacity=self.capacity,
                    policy=self.policy, depth=len(self._heap),
                )
                raise QueueFullError(
                    f"admission queue full ({self.capacity} waiting requests); "
                    "request rejected (policy=reject)"
                )
            seq = next(self._seq)
            heapq.heappush(self._heap, (req.sort_key(seq), seq, req))
            obs.gauge("serve.queue_depth").set(len(self._heap))
            self._cond.notify_all()

    def take(self, n: int, timeout: float | None = None) -> list[ServeRequest]:
        """Up to ``n`` requests in priority order; blocks (up to
        ``timeout``) for the first one, never for the rest.  Returns
        ``[]`` on timeout or when the queue closed empty."""
        with self._cond:
            self._cond.wait_for(lambda: self._heap or self._closed, timeout)
            out: list[ServeRequest] = []
            while self._heap and len(out) < n:
                out.append(heapq.heappop(self._heap)[2])
            obs.gauge("serve.queue_depth").set(len(self._heap))
            if out:
                self._cond.notify_all()  # wake blocked producers
            return out

    def close(self) -> None:
        """Stop admitting; wake every waiter (pending items still drain)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

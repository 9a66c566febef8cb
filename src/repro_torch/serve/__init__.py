"""repro_torch.serve — request-level serving over the compiled pipeline.

The port of ``repro.serve``.  A :class:`ModelServer` replica fronts a
``CompiledModel`` on the card with:

* :class:`AdmissionQueue` — a bounded priority queue (reject /
  backpressure policies) so heavy traffic sheds at the door instead of
  growing an unbounded buffer (a copy of the reference's);
* :class:`BatchedModel` — cross-request batch packing, the request slots
  folded into the batch axis of every segment executor, one captured
  CUDA graph per batch shape, per-request outputs bit-exact with
  sequential ``CompiledModel.run``;
* priority/deadline-aware rounds whose lane order is the
  :func:`repro_torch.pipeline.schedule.schedule_stream` Smith order,
  checked by ``PipelineSchedule.validate()``;
* per-request spans on the ``serve:<replica>`` lane plus ``serve.*``
  metrics, with replica stats in ``report_dict()["serve"]``;
* service objectives: pass :class:`repro_torch.obs.SloSpec` lists to
  ``ModelServer(slo=[...])`` for rolling burn-rate evaluation, turn on
  ``shed_expired=True`` to resolve already-expired requests with
  :class:`DeadlineExceededError` instead of running them, and arm the
  flight recorder (``MATCH_FLIGHT=path``) for automatic incident dumps
  on :class:`QueueFullError` / SLO breach.

The LM token-serving loop lives in :mod:`repro_torch.serving`; this
package serves whole-graph requests (one inference per request) over any
compiled target.
"""

from .batching import BatchedModel
from .engine import ModelServer, ServeDrainWarning
from .queue import (
    AdmissionQueue,
    DeadlineExceededError,
    QueueFullError,
    ServeHandle,
    ServeRequest,
)

__all__ = [
    "AdmissionQueue",
    "BatchedModel",
    "DeadlineExceededError",
    "ModelServer",
    "QueueFullError",
    "ServeDrainWarning",
    "ServeHandle",
    "ServeRequest",
]

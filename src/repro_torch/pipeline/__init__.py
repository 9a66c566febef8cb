"""repro_torch.pipeline — makespan-aware concurrent multi-module execution.

* :mod:`repro_torch.pipeline.schedule` — a copy of the reference's
  event-driven list scheduler (pure Python): a :class:`PipelineSchedule`
  (per-segment start/finish, module occupancy, predicted makespan) from
  any ``MappedGraph``, and the Smith's-rule request stream.
* :mod:`repro_torch.pipeline.runtime` — :class:`PipelinedModel`, a
  ``CompiledModel`` wrapper with one CUDA stream per module lane plus
  ``run_stream`` inter-input software pipelining.

``dispatch(..., objective="makespan"|"wct")`` (repro_torch.core) re-ranks
the DP's surviving segmentations through this package.
"""

from .schedule import (
    PipelineSchedule,
    PipelineScheduleError,
    ScheduledSegment,
    schedule_pipeline,
    schedule_stream,
    segment_deps,
)
from .runtime import PipelinedModel

__all__ = [
    "PipelineSchedule",
    "PipelineScheduleError",
    "PipelinedModel",
    "ScheduledSegment",
    "schedule_pipeline",
    "schedule_stream",
    "segment_deps",
]

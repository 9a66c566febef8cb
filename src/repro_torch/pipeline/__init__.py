"""repro_torch.pipeline — the makespan-aware list scheduler.

* :mod:`repro_torch.pipeline.schedule` — a copy of the reference's
  event-driven list scheduler (pure Python): a :class:`PipelineSchedule`
  (per-segment start/finish, module occupancy, predicted makespan) from
  any ``MappedGraph``, and the Smith's-rule request stream.

``dispatch(..., objective="makespan"|"wct")`` (repro_torch.core) re-ranks
the DP's surviving segmentations through this package.  The reference's
``PipelinedModel`` runtime is not ported yet.
"""

from .schedule import (
    PipelineSchedule,
    PipelineScheduleError,
    ScheduledSegment,
    schedule_pipeline,
    schedule_stream,
    segment_deps,
)

__all__ = [
    "PipelineSchedule",
    "PipelineScheduleError",
    "ScheduledSegment",
    "schedule_pipeline",
    "schedule_stream",
    "segment_deps",
]

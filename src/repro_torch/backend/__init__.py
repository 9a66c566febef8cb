"""repro_torch.backend — lowering + runtime: MappedGraphs become code that
runs on the card.

The port of ``repro.backend``'s main path.  It walks a
:class:`~repro_torch.core.dispatcher.MappedGraph` and

* **lowers** every mapped segment into one fused executor over tensors,
  parameterized by its winning LOMA schedule (:mod:`.lower`),
* **plans memory statically** — a copy of the reference planner
  (:mod:`.memory`), validated against each module's ``MemoryLevel``
  capacities,
* **runs** the result on its device with per-segment timing and a
  predicted-vs-measured report, checked bit-exact against the CPU
  interpreter (:mod:`.runtime`).

The reference's AOT executor (``repro.backend.aot``) is not ported yet.
"""

from .lower import LoweredSegment, LoweringError, lower
from .memory import ArenaView, BufferAlloc, MemoryPlan, MemoryPlanError, plan_memory
from .runtime import (
    CompiledModel,
    DivergenceReport,
    SegmentDivergence,
    SegmentTiming,
    UnsetFrequencyWarning,
    as_input_array,
)

__all__ = [
    "lower",
    "LoweredSegment",
    "LoweringError",
    "plan_memory",
    "ArenaView",
    "MemoryPlan",
    "MemoryPlanError",
    "BufferAlloc",
    "CompiledModel",
    "DivergenceReport",
    "SegmentDivergence",
    "SegmentTiming",
    "UnsetFrequencyWarning",
    "as_input_array",
]

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
  interpreter (:mod:`.runtime`), and
* **captures the whole graph in one CUDA graph** — all segments in
  schedule order, zero per-segment host dispatch, the static memory plan
  expressible as one flat arena with double-buffered cross-module
  staging (:mod:`.aot`).
"""

from .aot import (
    AotCompileError,
    AotEntry,
    AotModel,
    ChainExecutor,
    build_chains,
    compile_aot,
    make_chain_executor,
)
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
    "AotCompileError",
    "AotEntry",
    "AotModel",
    "ChainExecutor",
    "build_chains",
    "compile_aot",
    "make_chain_executor",
]

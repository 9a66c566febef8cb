"""repro_torch.core — the MATCH engine: model-aware compilation as data + search.

The paper's primary contribution, reimplemented as a composable library:

* Workload / LoopDim / Operand  — operator loop-nest abstraction
* MemoryLevel / ExecutionModule / MatchTarget — declarative HW models
* search_schedule / ScheduleResult — LOMA temporal-mapping DSE
* evaluate_mapping / CostBreakdown — analytical latency model
* Graph / Node / Pattern / dispatch — graph IR + heterogeneous dispatch
* KernelSchedule / schedule_for_kernel — DSE output -> Pallas BlockSpecs
"""

from .cost_model import (
    CostBreakdown,
    evaluate_mapping,
    operand_traffic,
    tile_chunks,
    tile_working_set,
    transfer_cost,
)
from .dispatcher import MappedGraph, MappedSegment, dispatch
from .graph import Graph, Node, apply_transforms
from .loma import (
    ScheduleCacheWarning,
    SchedulePlanner,
    ScheduleResult,
    TemporalMapping,
    clear_schedule_cache,
    divisors,
    prime_factors,
    search_schedule,
)
from .patterns import Pattern, PatternMatch, default_workload, find_matches
from .schedule import KernelSchedule, schedule_for_kernel, schedule_from_result, tpu_align
from .target import (
    ComputeModel,
    ExecutionModule,
    Interconnect,
    MatchTarget,
    MemoryLevel,
    SpatialUnrolling,
)
from .workload import (
    LoopDim,
    Operand,
    Workload,
    attention_workload,
    conv2d_workload,
    dense_workload,
    depthwise_conv2d_workload,
    matmul_workload,
    scan_workload,
)

__all__ = [
    "CostBreakdown",
    "evaluate_mapping",
    "operand_traffic",
    "tile_chunks",
    "tile_working_set",
    "transfer_cost",
    "MappedGraph",
    "MappedSegment",
    "dispatch",
    "Graph",
    "Node",
    "apply_transforms",
    "ScheduleCacheWarning",
    "SchedulePlanner",
    "ScheduleResult",
    "TemporalMapping",
    "clear_schedule_cache",
    "divisors",
    "prime_factors",
    "search_schedule",
    "Pattern",
    "PatternMatch",
    "default_workload",
    "find_matches",
    "KernelSchedule",
    "schedule_for_kernel",
    "schedule_from_result",
    "tpu_align",
    "ComputeModel",
    "ExecutionModule",
    "Interconnect",
    "MatchTarget",
    "MemoryLevel",
    "SpatialUnrolling",
    "LoopDim",
    "Operand",
    "Workload",
    "attention_workload",
    "conv2d_workload",
    "dense_workload",
    "depthwise_conv2d_workload",
    "matmul_workload",
    "scan_workload",
]

"""repro_torch.distributed — the port of ``repro.distributed``.

* sharding:    logical-axis rules -> PartitionSpec / DTensor placements on
               a ``DeviceMesh``, the parameter and activation placement API
* autoshard:   MATCH-style cost-model search over sharding strategies
* compression: int8 gradient compression with error feedback
"""

from .compression import dequantize, dequantize_tree, error_feedback_update, quantize, quantize_tree
from .sharding import (
    ShardingRules,
    constrain,
    current_rules,
    logical_to_spec,
    param_shardings,
    use_rules,
)

__all__ = [
    "ShardingRules",
    "constrain",
    "current_rules",
    "logical_to_spec",
    "param_shardings",
    "use_rules",
    "quantize",
    "dequantize",
    "quantize_tree",
    "dequantize_tree",
    "error_feedback_update",
]

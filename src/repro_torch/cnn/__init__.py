"""repro_torch.cnn — the paper's workload domain.

Graph builders for the four MLPerf-Tiny networks (copies of
``repro.cnn.nets`` / ``analysis``) and the PyTorch interpreter that
executes them with integer-exact float32 arithmetic.
"""

from .analysis import fits_memory, network_memory, peak_activation_bytes, weight_bytes
from .execute import apply_node, execute_graph, init_graph_params, params_to_torch
from .nets import (
    conv_block_graph,
    dae_graph,
    dscnn_graph,
    mlperf_tiny_networks,
    mobilenet_v1_graph,
    resnet8_graph,
)

__all__ = [
    "fits_memory",
    "network_memory",
    "peak_activation_bytes",
    "weight_bytes",
    "apply_node",
    "execute_graph",
    "init_graph_params",
    "params_to_torch",
    "conv_block_graph",
    "dae_graph",
    "dscnn_graph",
    "mlperf_tiny_networks",
    "mobilenet_v1_graph",
    "resnet8_graph",
]

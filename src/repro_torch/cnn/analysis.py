"""Whole-network memory analysis for CNN graphs.

The paper's Table III reports MobileNet as OoM on DIANA: total weights +
peak activations exceed the 512 kB L2.  This module computes that same
deployability check from the graph IR (weights resident for the whole
inference + peak concurrent activation footprint from a simple liveness
walk), so the Table III benchmark can reproduce the OoM entry.
"""

from __future__ import annotations

from repro_torch.core import Graph, Node
from repro_torch.core.workload import prod

__all__ = ["weight_bytes", "peak_activation_bytes", "fits_memory", "network_memory"]


def _pad(v: int, q: int) -> int:
    return -(-v // q) * q if q > 1 else v


def _out_elems(n: Node, pad_to: int = 1) -> int:
    ch = int(n.attr("K", 0) or 0) or int(n.attr("C", 1) or 1)
    if n.op in ("conv2d", "dwconv2d", "dense"):
        ch = _pad(ch, pad_to)
    return int(n.attr("B", 1)) * ch * int(n.attr("OY", 1) or 1) * int(n.attr("OX", 1) or 1)


def weight_bytes(graph: Graph, pad_to: int = 1) -> int:
    """Total resident weight bytes; ``pad_to`` models HW-aware channel
    padding (DIANA: K and OX multiples of 16 => padded weight tensors)."""
    total = 0
    for n in graph.nodes:
        eb = int(n.attr("elem_bytes", 1))
        if n.op == "conv2d":
            k = _pad(int(n.attr("K", 1)), pad_to)
            c = _pad(int(n.attr("C", 1)), pad_to)
            total += eb * k * c * int(n.attr("FY", 1)) * int(n.attr("FX", 1))
            total += 4 * k  # int32 bias
        elif n.op == "dwconv2d":
            c = _pad(int(n.attr("C", 1)), pad_to)
            total += eb * c * int(n.attr("FY", 1)) * int(n.attr("FX", 1))
            total += 4 * c
        elif n.op == "dense":
            k = _pad(int(n.attr("K", 1)), pad_to)
            total += eb * k * int(n.attr("C", 1))
            total += 4 * k
    return total


def peak_activation_bytes(graph: Graph, pad_to: int = 1) -> int:
    """Peak concurrent activation footprint via last-use liveness."""
    last_use: dict[str, int] = {}
    for i, n in enumerate(graph.nodes):
        for src in n.inputs:
            last_use[src] = i
    for o in graph.outputs:
        last_use[o] = len(graph.nodes)

    size: dict[str, int] = {}
    for name, shape in graph.inputs.items():
        if len(shape) == 4 and pad_to > 1:
            # NHWC conv input: channel dim padded by the HW-aware pass
            shape = shape[:-1] + (_pad(shape[-1], pad_to),)
        size[name] = prod(shape)  # int8 inputs
    for n in graph.nodes:
        size[n.name] = _out_elems(n, pad_to) * int(n.attr("elem_bytes", 1))

    cur = sum(size[k] for k in graph.inputs)
    peak = cur
    for i, n in enumerate(graph.nodes):
        cur += size[n.name]
        peak = max(peak, cur)
        for src in set(n.inputs):
            if last_use.get(src) == i:
                cur -= size.get(src, 0)
    return peak


def network_memory(graph: Graph, pad_to: int = 1, runtime_reserve: int = 0) -> dict:
    """Deployment memory picture.

    ``pad_to`` models the target's channel-padding transformations (16 on
    DIANA); ``runtime_reserve`` accounts for code + stack + graph-runtime
    structures that share L2 with tensors on an OS-less MCU.
    """
    w = weight_bytes(graph, pad_to)
    a = peak_activation_bytes(graph, pad_to)
    return {
        "weights": w,
        "peak_activations": a,
        "runtime": runtime_reserve,
        "total": w + a + runtime_reserve,
    }


def fits_memory(graph: Graph, l2_bytes: int, pad_to: int = 1, runtime_reserve: int = 0) -> bool:
    """Deployability: resident weights + peak activations + runtime must
    fit L2 (the paper's OoM criterion — Table III MobileNet on DIANA)."""
    return network_memory(graph, pad_to, runtime_reserve)["total"] <= l2_bytes

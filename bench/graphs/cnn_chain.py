"""A configuration's layer list, one layer after the other, as the
program's graph and parameters.

Each MAC layer becomes the MLPerf-Tiny integer idiom of the port's graph
IR: the anchor (``conv2d``, ``dwconv2d`` or ``dense``), then ``bias_add``,
``requant`` and, where the layer has one, ``relu``; ``avgpool`` stands
alone.  Nodes are named as ``repro_torch.cnn.nets`` names them (op and a
running count, or the layer's own ``name``), every node carries the
layer's geometry, batch 1 and 1-byte elements.

The program is that graph dispatched to the configuration's target and
lowered (:func:`compile_graph`), the ``CompiledModel`` the loop captures.
A configuration names its graph builder by ``graph``; :mod:`bench.spec`
lists what a builder holds.
"""

from __future__ import annotations

import time

import torch
from repro_torch.backend import lower
from repro_torch.core import Graph, Node, dispatch
from repro_torch.targets import register_h100_target

from bench.data import Draw, draw
from bench.reference.cnn_int import MAC_OPS

__all__ = ["build_graph", "build_program", "compile_graph", "draw", "prepare_device", "program_params"]

_NOT_GEOMETRY = ("op", "relu", "name")


def _layer_nodes(config: dict) -> list[list[Node]]:
    nodes_of: list[list[Node]] = []
    prev = config["input"]["name"]
    count = 0

    def node(op: str, inputs: tuple[str, ...], geom: dict, name: str | None = None) -> Node:
        nonlocal count
        if name is None:
            count += 1
            name = f"{op}{count}"
        return Node(name, op, inputs, {"elem_bytes": 1, **geom})

    for layer in config["layers"]:
        geom = {"B": 1, **{k: v for k, v in layer.items() if k not in _NOT_GEOMETRY}}
        if layer["op"] in MAC_OPS:
            chain = [node(layer["op"], (prev,), geom, layer.get("name"))]
            for op in ("bias_add", "requant") + (("relu",) if layer["relu"] else ()):
                chain.append(node(op, (chain[-1].name,), geom))
        else:
            chain = [node(layer["op"], (prev,), geom)]
        nodes_of.append(chain)
        prev = chain[-1].name
    return nodes_of


def build_graph(config: dict) -> Graph:
    """The port's graph of the configuration's net, batch 1."""
    nodes = [n for chain in _layer_nodes(config) for n in chain]
    inp = config["input"]
    g = Graph(config["name"], nodes, {inp["name"]: tuple(inp["shape"])}, (nodes[-1].name,))
    if not g.topo_check():
        raise ValueError(f"configuration {config['name']} does not make a graph in order")
    return g


def compile_graph(graph: Graph, config: dict, device: torch.device):
    """``graph`` dispatched to the configuration's target with its
    ``dispatch`` settings and lowered on ``device``, and the host seconds
    of the two stages."""
    t0 = time.perf_counter()
    mapped = dispatch(graph, config["target"], **config["dispatch"])
    t1 = time.perf_counter()
    cm = lower(mapped, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return cm, {"dispatch": t1 - t0, "lower": time.perf_counter() - t1}


def build_program(config: dict, params: dict, device: torch.device):
    return compile_graph(build_graph(config), config, device)


def program_params(config: dict, drawn: Draw) -> dict:
    """The program's parameter dict: float32 copies of the drawn weights
    and biases on their device, and each requant's shift."""
    params: dict[str, dict] = {}
    for chain, w, b, s in zip(_layer_nodes(config), drawn.weights, drawn.biases, drawn.shifts):
        if w is None:
            continue
        anchor, bias, requant = chain[:3]
        params[anchor.name] = {"w": w.float()}
        params[bias.name] = {"b": b.float()}
        params[requant.name] = {"shift": float(s)}
    return params


def prepare_device(config: dict, dev: torch.device) -> None:
    """Register the h100 target and load the kernel libraries the net's
    segments use before the compile clock starts: a cold build of the
    GEMM, and cuDNN's and cuBLAS's first use, are set-up that no compile of
    the net should be charged with."""
    if config["target"] == "h100":
        register_h100_target()
    if dev.type != "cuda":
        return
    if any(layer["op"] == "dense" for layer in config["layers"]):
        from repro_torch.kernels import _build

        _build.load("matmul_requant")
    x = torch.zeros(1, 1, 4, 4, device=dev)
    torch.nn.functional.conv2d(x, torch.zeros(1, 1, 3, 3, device=dev))
    torch.zeros(4, 4, device=dev) @ torch.zeros(4, 4, device=dev)

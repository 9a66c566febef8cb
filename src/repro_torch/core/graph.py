"""Lightweight operator-graph IR (the Relay analogue of paper Sec. IV-A).

MATCH consumes DNNs as graphs of high-level tensor ops.  In the paper the
graph is TVM Relay; here it is a minimal topologically-ordered node list —
enough to express the MLPerf-Tiny CNNs and per-block LM layer graphs, to
run HW-agnostic / HW-aware transformation passes over, and to pattern-match
against execution-module pattern tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Iterable, Mapping, Sequence

__all__ = ["Node", "Graph", "GraphTransform", "apply_transforms", "PASSTHROUGH_OPS"]

# Structural ops whose output is (a view of) their first input: element
# count AND element width are preserved, so a transfer edge out of them
# is as big as the tensor flowing *through* them.  (A width-changing
# ``cast`` deliberately does not qualify: pricing it with the producer's
# elem_bytes would mis-size the edge.)
PASSTHROUGH_OPS = ("reshape", "flatten", "squeeze", "expand_dims", "identity")


@dataclass(frozen=True)
class Node:
    """One operation over tensors.

    ``op``: operator type, e.g. ``conv2d``, ``dwconv2d``, ``dense``,
    ``add``, ``avgpool``, ``maxpool``, ``relu``, ``requant``, ``bias_add``,
    ``softmax``, ``reshape``, ``matmul``, ``attention``, ``moe_ffn``,
    ``rglru``, ``ssd`` ...
    ``inputs``: names of producer nodes (or graph inputs).
    ``attrs``: operator hyper-parameters (paper notation for convs:
    K/C/OY/OX/FY/FX/stride, plus dtype bytes).
    """

    name: str
    op: str
    inputs: tuple[str, ...] = ()
    attrs: Mapping[str, object] = field(default_factory=dict)

    def attr(self, key: str, default=None):
        return self.attrs.get(key, default)

    def with_attrs(self, **kw) -> "Node":
        a = dict(self.attrs)
        a.update(kw)
        return replace(self, attrs=a)

    # -- output tensor sizing (used to size cross-module transfers) -----
    def has_geometry(self) -> bool:
        """True when the node carries tensor-shape attrs (K/C/OY/OX).

        Structural ops (reshape, ...) usually don't; their real output
        size is their producer's, which ``Graph.edge_bytes`` resolves by
        walking the passthrough chain."""
        return any(self.attr(k) for k in ("K", "C", "OY", "OX"))

    def output_elems(self) -> int:
        """Elements of this node's output tensor, from geometry attrs.

        Convs/denses produce B x K x OY x OX; depthwise convs, pools and
        elementwise ops keep the channel count C.  A node without geometry
        reports 1 element — callers that know the graph should size such
        edges via ``Graph.edge_bytes``, which propagates the producing
        tensor's true size through structural passthrough chains.
        """
        b = int(self.attr("B", 1) or 1)
        ch = int(self.attr("K", 0) or 0)
        if self.op in ("dwconv2d", "avgpool", "maxpool") or not ch:
            ch = int(self.attr("C", 1) or 1)
        oy = int(self.attr("OY", 1) or 1)
        ox = int(self.attr("OX", 1) or 1)
        return max(1, b * ch * oy * ox)

    def output_bytes(self) -> int:
        return self.output_elems() * int(self.attr("elem_bytes", 1) or 1)


@dataclass
class Graph:
    """Topologically ordered DAG of Nodes."""

    name: str
    nodes: list[Node]
    inputs: dict[str, tuple[int, ...]] = field(default_factory=dict)
    outputs: tuple[str, ...] = ()
    attrs: dict = field(default_factory=dict)

    def __post_init__(self):
        self._index = {n.name: i for i, n in enumerate(self.nodes)}

    def node(self, name: str) -> Node:
        return self.nodes[self._index[name]]

    def has(self, name: str) -> bool:
        return name in self._index

    def consumers(self, name: str) -> list[Node]:
        return [n for n in self.nodes if name in n.inputs]

    def edge_bytes(self, producer: str) -> int:
        """Bytes flowing along the edge out of the ``producer`` node,
        sized from its geometry attrs.  Graph inputs return 0: they start
        in the shared home memory, so no cross-module transfer is due.

        Structural passthrough ops (reshape, ...) carry no geometry of
        their own, yet the full producing tensor still flows through them
        — so the chain is walked back to the nearest node that *does*
        declare geometry (pricing such edges at 1 element would let the
        DP move real tensors across modules for free)."""
        cur = producer
        seen: set[str] = set()
        while self.has(cur) and cur not in seen:
            seen.add(cur)
            n = self.node(cur)
            if n.has_geometry() or n.op not in PASSTHROUGH_OPS or not n.inputs:
                return n.output_bytes()
            cur = n.inputs[0]
        return 0

    def single_consumer(self, name: str) -> Node | None:
        cs = self.consumers(name)
        return cs[0] if len(cs) == 1 else None

    def replace_nodes(self, nodes: Sequence[Node]) -> "Graph":
        return Graph(self.name, list(nodes), dict(self.inputs), tuple(self.outputs), dict(self.attrs))

    def topo_check(self) -> bool:
        seen: set[str] = set(self.inputs)
        for n in self.nodes:
            for i in n.inputs:
                if i not in seen:
                    return False
            seen.add(n.name)
        return True

    def total_macs(self) -> float:
        from .workload import prod

        total = 0.0
        for n in self.nodes:
            if n.op in ("conv2d",):
                total += prod(int(n.attr(k, 1)) for k in ("B", "K", "C", "OY", "OX", "FY", "FX"))
            elif n.op in ("dwconv2d",):
                total += prod(int(n.attr(k, 1)) for k in ("B", "C", "OY", "OX", "FY", "FX"))
            elif n.op in ("dense",):
                total += prod(int(n.attr(k, 1)) for k in ("B", "K", "C"))
        return total


# ---------------------------------------------------------------------------
# Transformation passes (paper Sec. IV-A, Table II)
# ---------------------------------------------------------------------------

GraphTransform = Callable[[Graph], Graph]


def apply_transforms(graph: Graph, passes: Iterable[GraphTransform]) -> Graph:
    g = graph
    for p in passes:
        g = p(g)
        assert g.topo_check(), f"pass {getattr(p, '__name__', p)} broke topological order"
    return g


# -- a small library of reusable passes -------------------------------------


def dead_node_elimination(graph: Graph) -> Graph:
    """Remove nodes whose outputs are never consumed (paper Table II)."""
    live: set[str] = set(graph.outputs)
    keep: list[Node] = []
    for n in reversed(graph.nodes):
        if n.name in live:
            keep.append(n)
            live |= set(n.inputs)
    keep.reverse()
    return graph.replace_nodes(keep)


def fold_requant_div(graph: Graph) -> Graph:
    """HW-aware rewrite (paper Table II, GAP9): mul-add-div requant chains
    become a single ``requant`` node implementing (x*M + B) >> S.

    The chain's constants (mul ``scale``, add ``addend``, div ``divisor`` /
    rshift ``shift``) are carried onto the fused node so the requant
    computes the same affine transform the unfolded ops would (rounding
    tightens from the div/rshift semantics to requant's round-half-even —
    that IS the paper's integerization rewrite).  A ``div`` by a
    non-power-of-two cannot become a shift and is left unfolded.
    """
    import math

    nodes: list[Node] = []
    skip: set[str] = set()
    for n in graph.nodes:
        if n.name in skip:
            continue
        if n.op == "mul":
            c1 = graph.single_consumer(n.name)
            if c1 is not None and c1.op == "add":
                c2 = graph.single_consumer(c1.name)
                if c2 is not None and c2.op in ("div", "rshift"):
                    if c2.op == "div":
                        d = float(c2.attr("divisor", 1.0) or 1.0)
                        s = math.log2(d) if d > 0 else -1.0
                        if s < 0 or s != int(s):
                            nodes.append(n)
                            continue  # not a power of two: keep the chain
                        shift = float(int(s))
                    else:
                        shift = float(c2.attr("shift", 0.0) or 0.0)
                    fused = Node(
                        c2.name,
                        "requant",
                        inputs=n.inputs,
                        attrs={
                            **n.attrs,
                            "scale": float(n.attr("scale", 1.0) or 1.0),
                            "addend": float(c1.attr("addend", 0.0) or 0.0),
                            "shift": shift,
                            "folded_from": (n.name, c1.name, c2.name),
                        },
                    )
                    nodes.append(fused)
                    skip |= {c1.name, c2.name}
                    continue
        nodes.append(n)
    return graph.replace_nodes(nodes)


def layout_to(layout: str) -> GraphTransform:
    """Annotate every tensor-op with the activation layout the backend
    kernels require (paper: NHWC for PULP-NN / NE16)."""

    def _pass(graph: Graph) -> Graph:
        return graph.replace_nodes(
            [n.with_attrs(layout=layout) if n.op in ("conv2d", "dwconv2d", "dense", "add", "avgpool", "maxpool") else n for n in graph.nodes]
        )

    _pass.__name__ = f"layout_to_{layout}"
    return _pass


def pad_spatial_to(multiple_of: int, dims: tuple[str, ...] = ("K", "OX")) -> GraphTransform:
    """HW-aware pad pass (paper: DIANA needs K, OX multiples of 16).

    Records the padded sizes in node attrs; the runtime pads/slices around
    the matched segment, as described in the paper (static, no runtime
    overhead for weights).
    """

    def _pass(graph: Graph) -> Graph:
        out = []
        for n in graph.nodes:
            if n.op in ("conv2d", "dense"):
                pads = {}
                for d in dims:
                    v = int(n.attr(d, 0) or 0)
                    if v:
                        pads[f"{d}_padded"] = -(-v // multiple_of) * multiple_of
                out.append(n.with_attrs(**pads) if pads else n)
            else:
                out.append(n)
        return graph.replace_nodes(out)

    _pass.__name__ = f"pad_spatial_to_{multiple_of}"
    return _pass


def integerize(bytes_per_elem: int = 1) -> GraphTransform:
    """Quantize ops/weights to int8 (paper Table II 'Integerization')."""

    def _pass(graph: Graph) -> Graph:
        return graph.replace_nodes([n.with_attrs(elem_bytes=bytes_per_elem) for n in graph.nodes])

    _pass.__name__ = "integerize"
    return _pass

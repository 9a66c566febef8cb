"""Pattern tables and the pattern matcher (paper Sec. IV-B).

Each execution module lists the operator patterns it can run.  A pattern
is a linear chain of op types (anchor first), an optional constraint on
the matched nodes (layouts, quantization, hyper-parameters — e.g. NE16
rejects the DSCNN 4x10 rectangular first-layer filter), and a builder
turning the matched nodes into a :class:`~repro_torch.core.workload.Workload`
for the DSE engine.

The matcher walks the graph in topological order, follows single-consumer
chains, and — when patterns are nested — keeps the **largest** match
(paper: "node fusion is always convenient").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

from .graph import Graph, Node
from .workload import (
    Workload,
    conv2d_workload,
    dense_workload,
    depthwise_conv2d_workload,
)

__all__ = ["Pattern", "PatternMatch", "match_at", "find_matches", "default_workload"]


ConstraintFn = Callable[[Sequence[Node]], bool]
WorkloadFn = Callable[[Sequence[Node]], Workload]


@dataclass(frozen=True)
class Pattern:
    """A chain of fusable ops an execution module supports."""

    name: str
    ops: tuple[str, ...]  # anchor op first, then the fused epilogue chain
    make_workload: WorkloadFn
    constraint: ConstraintFn | None = None

    def __len__(self) -> int:
        return len(self.ops)


@dataclass(frozen=True)
class PatternMatch:
    pattern: Pattern
    nodes: tuple[Node, ...]

    @property
    def anchor(self) -> Node:
        return self.nodes[0]

    def workload(self) -> Workload:
        return self.pattern.make_workload(self.nodes)


def match_at(graph: Graph, node: Node, pattern: Pattern) -> PatternMatch | None:
    """Try to match ``pattern`` with its anchor at ``node``.

    Follows single-consumer edges so fusion never duplicates work; any
    branch (multi-consumer intermediate) stops the chain, exactly like
    TVM's dominator-based pattern matching in spirit.
    """
    if node.op != pattern.ops[0]:
        return None
    chain = [node]
    cur = node
    for want in pattern.ops[1:]:
        nxt = graph.single_consumer(cur.name)
        if nxt is None or nxt.op != want:
            return None
        chain.append(nxt)
        cur = nxt
    if pattern.constraint is not None and not pattern.constraint(chain):
        return None
    return PatternMatch(pattern, tuple(chain))


def find_matches(graph: Graph, node: Node, patterns: Sequence[Pattern]) -> list[PatternMatch]:
    """All pattern matches anchored at ``node``, longest first."""
    out = [m for p in patterns if (m := match_at(graph, node, p)) is not None]
    out.sort(key=lambda m: -len(m.nodes))
    return out


# ---------------------------------------------------------------------------
# Default workload builders (used by pattern tables and the CPU fallback)
# ---------------------------------------------------------------------------


def _int_attr(n: Node, k: str, default: int = 1) -> int:
    v = n.attr(k, default)
    return int(v if v is not None else default)


def default_workload(node: Node) -> Workload | None:
    """Build a Workload for a single un-fused node (fallback path).

    Returns None for structural ops (reshape, ...) that carry no
    arithmetic worth scheduling — those cost ~0 on any module.  A
    ``concat`` that declares its output geometry (C = sum of the input
    channel counts) is priced as an elementwise copy of its output so
    join graphs get a schedulable fallback segment on every target; a
    geometry-less concat stays structural.
    """
    eb = _int_attr(node, "elem_bytes", 1)
    if node.op == "conv2d":
        return conv2d_workload(
            name=node.name,
            B=_int_attr(node, "B"),
            K=_int_attr(node, "K"),
            C=_int_attr(node, "C"),
            OY=_int_attr(node, "OY"),
            OX=_int_attr(node, "OX"),
            FY=_int_attr(node, "FY"),
            FX=_int_attr(node, "FX"),
            stride=_int_attr(node, "stride"),
            in_bytes=eb,
            w_bytes=eb,
            out_bytes=eb,
            layout=str(node.attr("layout", "NHWC")),
            attrs=dict(node.attrs),
        )
    if node.op == "dwconv2d":
        return depthwise_conv2d_workload(
            name=node.name,
            B=_int_attr(node, "B"),
            C=_int_attr(node, "C"),
            OY=_int_attr(node, "OY"),
            OX=_int_attr(node, "OX"),
            FY=_int_attr(node, "FY"),
            FX=_int_attr(node, "FX"),
            stride=_int_attr(node, "stride"),
            in_bytes=eb,
            w_bytes=eb,
            out_bytes=eb,
            attrs=dict(node.attrs),
        )
    if node.op == "dense":
        return dense_workload(
            name=node.name,
            B=_int_attr(node, "B"),
            K=_int_attr(node, "K"),
            C=_int_attr(node, "C"),
            in_bytes=eb,
            w_bytes=eb,
            out_bytes=eb,
            attrs=dict(node.attrs),
        )
    if node.op == "concat" and not node.has_geometry():
        return None  # no declared output shape: keep the structural path
    if node.op in ("add", "relu", "requant", "bias_add", "mul", "clip", "concat"):
        # elementwise over the *output* geometry (channels = K when the
        # node sits after a conv/dense producer, else C)
        from .workload import LoopDim, Operand, Workload as W

        ch = _int_attr(node, "K", 0) or _int_attr(node, "C", 1)
        elems = _int_attr(node, "B", 1) * ch * _int_attr(node, "OY", 1) * _int_attr(node, "OX", 1)
        loops = (LoopDim("E", max(elems, 1)),)
        ops = (
            Operand("I", dims=("E",), elem_bytes=eb, layout=("E",)),
            Operand("O", dims=("E",), elem_bytes=eb, is_output=True, layout=("E",)),
        )
        return W(node.name, loops, ops, op_type="elementwise", attrs=dict(node.attrs))
    if node.op in ("avgpool", "maxpool"):
        from .workload import LoopDim, Operand, Workload as W

        loops = (
            LoopDim("B", _int_attr(node, "B")),
            LoopDim("C", _int_attr(node, "C")),
            LoopDim("OY", _int_attr(node, "OY")),
            LoopDim("OX", _int_attr(node, "OX")),
            LoopDim("FY", _int_attr(node, "FY"), "reduction"),
            LoopDim("FX", _int_attr(node, "FX"), "reduction"),
        )
        ops = (
            Operand("I", dims=("B", "C", "OY", "OX", "FY", "FX"), elem_bytes=eb, layout=("B", "OY", "OX", "C")),
            Operand("O", dims=("B", "C", "OY", "OX"), elem_bytes=eb, is_output=True, layout=("B", "OY", "OX", "C")),
        )
        return W(node.name, loops, ops, op_type="pool", attrs=dict(node.attrs))
    return None


# Convenience constructors for common CNN pattern tables -------------------


def conv_chain_pattern(name: str, epilogue: tuple[str, ...], constraint: ConstraintFn | None = None) -> Pattern:
    def mk(nodes: Sequence[Node]) -> Workload:
        w = default_workload(nodes[0])
        assert w is not None
        return w.with_attrs(fused=tuple(n.op for n in nodes[1:]))

    return Pattern(name, ("conv2d",) + epilogue, mk, constraint)


def dwconv_chain_pattern(name: str, epilogue: tuple[str, ...], constraint: ConstraintFn | None = None) -> Pattern:
    def mk(nodes: Sequence[Node]) -> Workload:
        w = default_workload(nodes[0])
        assert w is not None
        return w.with_attrs(fused=tuple(n.op for n in nodes[1:]))

    return Pattern(name, ("dwconv2d",) + epilogue, mk, constraint)


def dense_chain_pattern(name: str, epilogue: tuple[str, ...], constraint: ConstraintFn | None = None) -> Pattern:
    def mk(nodes: Sequence[Node]) -> Workload:
        w = default_workload(nodes[0])
        assert w is not None
        return w.with_attrs(fused=tuple(n.op for n in nodes[1:]))

    return Pattern(name, ("dense",) + epilogue, mk, constraint)


def eltwise_chain_pattern(name: str, anchor: str, epilogue: tuple[str, ...] = (), constraint: ConstraintFn | None = None) -> Pattern:
    """Elementwise anchor (add/relu/requant) + optional fused epilogue."""

    def mk(nodes: Sequence[Node]) -> Workload:
        w = default_workload(nodes[0])
        assert w is not None
        return w.with_attrs(fused=tuple(n.op for n in nodes[1:]))

    return Pattern(name, (anchor,) + epilogue, mk, constraint)


def pool_pattern(name: str, op: str = "avgpool", constraint: ConstraintFn | None = None) -> Pattern:
    def mk(nodes: Sequence[Node]) -> Workload:
        w = default_workload(nodes[0])
        assert w is not None
        return w

    return Pattern(name, (op,), mk, constraint)

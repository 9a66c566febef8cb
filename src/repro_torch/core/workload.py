"""Workload abstraction for the MATCH DSE engine.

A :class:`Workload` is the ZigZag-style description of one operator's loop
nest: a set of named loop dimensions, and per-operand footprint / relevance
information.  The LOMA engine (``repro_torch.core.loma``) searches over *temporal
mappings* of a workload — tile sizes and loop orders — and the analytical
cost models (``repro_torch.core.cost_model``) score each candidate.

This file is hardware-agnostic: the same ``Workload`` objects describe a
3x3 conv scheduled for the DIANA 16x16 PE array and a transformer GEMM
scheduled for a TPU v5e MXU; only the target model differs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from functools import reduce
from typing import Callable, Mapping, Sequence

__all__ = [
    "LoopDim",
    "Operand",
    "Workload",
    "conv2d_workload",
    "depthwise_conv2d_workload",
    "dense_workload",
    "matmul_workload",
    "attention_workload",
    "scan_workload",
    "prod",
]


def prod(xs) -> int:
    return reduce(lambda a, b: a * b, xs, 1)


@dataclass(frozen=True)
class LoopDim:
    """One loop of the operator nest.

    ``kind`` is ``"spatial"`` for loops that index the output and
    ``"reduction"`` for loops reduced away (e.g. C/FY/FX of a conv, the K
    dim of a GEMM).  Reduction loops placed above an output tile's cut
    force read-modify-write traffic on the output operand.
    """

    name: str
    size: int
    kind: str = "spatial"  # "spatial" | "reduction"

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"loop {self.name} has size {self.size} < 1")
        if self.kind not in ("spatial", "reduction"):
            raise ValueError(f"loop kind {self.kind!r} invalid")


# A footprint function maps {dim_name: tile_size} -> number of elements the
# operand occupies for that tile.  The default is the product of the tile
# sizes of the operand's relevant dims; convs override it to model halos
# (IX = (OX-1)*stride + FX).
FootprintFn = Callable[[Mapping[str, int]], int]


@dataclass(frozen=True)
class Operand:
    """One tensor touched by the workload (inputs, weights, outputs)."""

    name: str
    dims: tuple[str, ...]  # loop dims this operand's data depends on
    elem_bytes: int = 1
    is_output: bool = False
    # memory layout, outer -> inner, over the *tensor's own* axes expressed
    # as loop-dim names (used for DMA-chunk contiguity estimation).
    layout: tuple[str, ...] = ()
    footprint_fn: FootprintFn | None = None
    # axes of the underlying tensor whose full extent differs from the loop
    # size (conv halos): maps dim -> callable(tile)->extent
    extent_fns: Mapping[str, Callable[[Mapping[str, int]], int]] = field(
        default_factory=dict
    )

    def footprint(self, tiles: Mapping[str, int]) -> int:
        if self.footprint_fn is not None:
            return self.footprint_fn(tiles)
        return prod(self.axis_extent(d, tiles) for d in self.dims)

    def axis_extent(self, dim: str, tiles: Mapping[str, int]) -> int:
        fn = self.extent_fns.get(dim)
        if fn is not None:
            return fn(tiles)
        return int(tiles.get(dim, 1))

    def footprint_bytes(self, tiles: Mapping[str, int]) -> int:
        return self.footprint(tiles) * self.elem_bytes

    def relevant(self, dim: str) -> bool:
        return dim in self.dims


@dataclass(frozen=True)
class Workload:
    """A full operator loop nest with operand access information."""

    name: str
    loops: tuple[LoopDim, ...]
    operands: tuple[Operand, ...]
    macs_per_iter: float = 1.0
    op_type: str = "generic"
    attrs: Mapping[str, object] = field(default_factory=dict)

    # ---- helpers -----------------------------------------------------
    def loop(self, name: str) -> LoopDim:
        for l in self.loops:
            if l.name == name:
                return l
        raise KeyError(name)

    @property
    def dim_sizes(self) -> dict[str, int]:
        return {l.name: l.size for l in self.loops}

    @property
    def dim_names(self) -> tuple[str, ...]:
        return tuple(l.name for l in self.loops)

    @property
    def reduction_dims(self) -> tuple[str, ...]:
        return tuple(l.name for l in self.loops if l.kind == "reduction")

    def total_macs(self) -> float:
        return prod(l.size for l in self.loops) * self.macs_per_iter

    def operand(self, name: str) -> Operand:
        for o in self.operands:
            if o.name == name:
                return o
        raise KeyError(name)

    @property
    def output(self) -> Operand:
        for o in self.operands:
            if o.is_output:
                return o
        raise ValueError(f"workload {self.name} has no output operand")

    def total_bytes(self) -> int:
        full = self.dim_sizes
        return sum(o.footprint_bytes(full) for o in self.operands)

    def with_attrs(self, **kw) -> "Workload":
        attrs = dict(self.attrs)
        attrs.update(kw)
        return replace(self, attrs=attrs)


# ---------------------------------------------------------------------------
# Workload builders
# ---------------------------------------------------------------------------


def _conv_in_extent(out_dim: str, f_dim: str, stride: int):
    def fn(tiles: Mapping[str, int]) -> int:
        o = int(tiles.get(out_dim, 1))
        f = int(tiles.get(f_dim, 1))
        return (o - 1) * stride + f

    return fn


def conv2d_workload(
    *,
    name: str = "conv2d",
    B: int = 1,
    K: int,
    C: int,
    OY: int,
    OX: int,
    FY: int,
    FX: int,
    stride: int = 1,
    in_bytes: int = 1,
    w_bytes: int = 1,
    out_bytes: int = 1,
    layout: str = "NHWC",
    attrs: Mapping[str, object] | None = None,
) -> Workload:
    """Standard 2D convolution, paper notation (Sec. IV): IX/IY/C in,
    OX/OY/K out, FX/FY filter."""
    loops = (
        LoopDim("B", B),
        LoopDim("K", K),
        LoopDim("OY", OY),
        LoopDim("OX", OX),
        LoopDim("C", C, "reduction"),
        LoopDim("FY", FY, "reduction"),
        LoopDim("FX", FX, "reduction"),
    )
    iy = _conv_in_extent("OY", "FY", stride)
    ix = _conv_in_extent("OX", "FX", stride)
    if layout == "NHWC":
        in_layout = ("B", "OY", "OX", "C")
        out_layout = ("B", "OY", "OX", "K")
    else:  # NCHW
        in_layout = ("B", "C", "OY", "OX")
        out_layout = ("B", "K", "OY", "OX")
    operands = (
        Operand(
            "I",
            dims=("B", "C", "OY", "OX", "FY", "FX"),
            elem_bytes=in_bytes,
            layout=in_layout,
            extent_fns={"OY": iy, "OX": ix, "FY": lambda t: 1, "FX": lambda t: 1},
        ),
        Operand("W", dims=("K", "C", "FY", "FX"), elem_bytes=w_bytes, layout=("K", "FY", "FX", "C")),
        Operand("O", dims=("B", "K", "OY", "OX"), elem_bytes=out_bytes, is_output=True, layout=out_layout),
    )
    a = {"stride": stride, "FY": FY, "FX": FX, "layout": layout}
    if attrs:
        a.update(attrs)
    return Workload(name, loops, operands, op_type="conv2d", attrs=a)


def depthwise_conv2d_workload(
    *,
    name: str = "dwconv2d",
    B: int = 1,
    C: int,
    OY: int,
    OX: int,
    FY: int,
    FX: int,
    stride: int = 1,
    in_bytes: int = 1,
    w_bytes: int = 1,
    out_bytes: int = 1,
    attrs: Mapping[str, object] | None = None,
) -> Workload:
    """Depthwise conv: channel dim is spatial (per-channel independent)."""
    loops = (
        LoopDim("B", B),
        LoopDim("C", C),
        LoopDim("OY", OY),
        LoopDim("OX", OX),
        LoopDim("FY", FY, "reduction"),
        LoopDim("FX", FX, "reduction"),
    )
    iy = _conv_in_extent("OY", "FY", stride)
    ix = _conv_in_extent("OX", "FX", stride)
    operands = (
        Operand(
            "I",
            dims=("B", "C", "OY", "OX", "FY", "FX"),
            elem_bytes=in_bytes,
            layout=("B", "OY", "OX", "C"),
            extent_fns={"OY": iy, "OX": ix, "FY": lambda t: 1, "FX": lambda t: 1},
        ),
        Operand("W", dims=("C", "FY", "FX"), elem_bytes=w_bytes, layout=("FY", "FX", "C")),
        Operand("O", dims=("B", "C", "OY", "OX"), elem_bytes=out_bytes, is_output=True, layout=("B", "OY", "OX", "C")),
    )
    a = {"stride": stride, "FY": FY, "FX": FX, "depthwise": True}
    if attrs:
        a.update(attrs)
    return Workload(name, loops, operands, op_type="dwconv2d", attrs=a)


def dense_workload(
    *,
    name: str = "dense",
    B: int = 1,
    K: int,
    C: int,
    in_bytes: int = 1,
    w_bytes: int = 1,
    out_bytes: int = 1,
    attrs: Mapping[str, object] | None = None,
) -> Workload:
    """Fully-connected layer: out[B,K] += in[B,C] * w[K,C]."""
    loops = (
        LoopDim("B", B),
        LoopDim("K", K),
        LoopDim("C", C, "reduction"),
    )
    operands = (
        Operand("I", dims=("B", "C"), elem_bytes=in_bytes, layout=("B", "C")),
        Operand("W", dims=("K", "C"), elem_bytes=w_bytes, layout=("K", "C")),
        Operand("O", dims=("B", "K"), elem_bytes=out_bytes, is_output=True, layout=("B", "K")),
    )
    return Workload(name, loops, operands, op_type="dense", attrs=dict(attrs or {}))


def matmul_workload(
    *,
    name: str = "matmul",
    M: int,
    N: int,
    KD: int,
    a_bytes: int = 2,
    b_bytes: int = 2,
    out_bytes: int = 2,
    attrs: Mapping[str, object] | None = None,
) -> Workload:
    """GEMM O[M,N] += A[M,KD] B[KD,N] — the TPU MXU-facing workload."""
    loops = (
        LoopDim("M", M),
        LoopDim("N", N),
        LoopDim("KD", KD, "reduction"),
    )
    operands = (
        Operand("A", dims=("M", "KD"), elem_bytes=a_bytes, layout=("M", "KD")),
        Operand("B", dims=("KD", "N"), elem_bytes=b_bytes, layout=("KD", "N")),
        Operand("O", dims=("M", "N"), elem_bytes=out_bytes, is_output=True, layout=("M", "N")),
    )
    return Workload(name, loops, operands, op_type="matmul", attrs=dict(attrs or {}))


def attention_workload(
    *,
    name: str = "attention",
    B: int,
    H: int,
    SQ: int,
    SK: int,
    D: int,
    q_bytes: int = 2,
    kv_bytes: int = 2,
    out_bytes: int = 2,
    causal: bool = True,
    attrs: Mapping[str, object] | None = None,
) -> Workload:
    """Flash-attention style workload.

    Loop nest (one softmax-rescaled pass): B, H, SQ (query blocks),
    SK (key blocks; online-softmax reduction), D head dim.  MACs per
    iteration = 2 (QK^T and PV both touch each (sq, sk, d) triple).
    """
    loops = (
        LoopDim("B", B),
        LoopDim("H", H),
        LoopDim("SQ", SQ),
        LoopDim("SK", SK, "reduction"),
        LoopDim("D", D, "reduction"),
    )
    operands = (
        Operand("Q", dims=("B", "H", "SQ", "D"), elem_bytes=q_bytes, layout=("B", "SQ", "H", "D")),
        Operand("K", dims=("B", "H", "SK", "D"), elem_bytes=kv_bytes, layout=("B", "SK", "H", "D")),
        Operand("V", dims=("B", "H", "SK", "D"), elem_bytes=kv_bytes, layout=("B", "SK", "H", "D")),
        Operand("O", dims=("B", "H", "SQ", "D"), elem_bytes=out_bytes, is_output=True, layout=("B", "SQ", "H", "D")),
    )
    a = {"causal": causal}
    if attrs:
        a.update(attrs)
    return Workload(name, loops, operands, macs_per_iter=2.0, op_type="attention", attrs=a)


def scan_workload(
    *,
    name: str = "scan",
    B: int,
    T: int,
    D: int,
    state: int = 1,
    elem_bytes: int = 2,
    attrs: Mapping[str, object] | None = None,
) -> Workload:
    """Linear-recurrence workload (RG-LRU / SSD chunk scan).

    T is sequential (cannot be tiled arbitrarily without chunked state
    passing); expressed here so the DSE can still pick chunk sizes and
    channel tiling; ``state`` multiplies the per-step work.
    """
    loops = (
        LoopDim("B", B),
        LoopDim("D", D),
        LoopDim("T", T, "reduction"),
    )
    operands = (
        Operand("X", dims=("B", "T", "D"), elem_bytes=elem_bytes, layout=("B", "T", "D")),
        Operand("G", dims=("B", "T", "D"), elem_bytes=elem_bytes, layout=("B", "T", "D")),
        Operand("O", dims=("B", "T", "D"), elem_bytes=elem_bytes, is_output=True, layout=("B", "T", "D")),
    )
    a = {"state": state, "sequential": ("T",)}
    if attrs:
        a.update(attrs)
    return Workload(name, loops, operands, macs_per_iter=float(state), op_type="scan", attrs=a)

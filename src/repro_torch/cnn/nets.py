"""MLPerf-Tiny network graphs (paper Sec. VI-B) + micro-bench blocks.

All four networks of the paper's end-to-end evaluation, expressed in the
repro_torch.core graph IR at int8 (elem_bytes=1), NHWC — the post-transformation
form that reaches the pattern matcher on GAP9/DIANA:

* ResNet-V1 (8 conv backbone) — CIFAR-10 image classification
* MobileNetV1 x0.25 — Visual Wake Words person detection
* DS-CNN — Speech-Commands keyword spotting (4x10 first filter!)
* FC AutoEncoder (DAE) — DCASE2020 anomaly detection

Shapes follow the MLPerf-Tiny reference models.
"""

from __future__ import annotations

from repro_torch.core import Graph, Node

__all__ = [
    "conv_block_graph",
    "resnet8_graph",
    "mobilenet_v1_graph",
    "dscnn_graph",
    "dae_graph",
    "mlperf_tiny_networks",
]


class _G:
    """Tiny helper accumulating nodes with quantized-op idioms."""

    def __init__(self, name: str):
        self.name = name
        self.nodes: list[Node] = []
        self.inputs: dict[str, tuple[int, ...]] = {}
        self.counter = 0

    def _n(self, prefix: str) -> str:
        self.counter += 1
        return f"{prefix}{self.counter}"

    def add_input(self, name: str, shape: tuple[int, ...]):
        self.inputs[name] = shape
        return name

    def node(self, op: str, inputs: tuple[str, ...], **attrs) -> str:
        name = attrs.pop("name", None) or self._n(op)
        self.nodes.append(Node(name, op, inputs, {"elem_bytes": 1, **attrs}))
        return name

    def qconv(
        self,
        x: str,
        *,
        K: int,
        C: int,
        OY: int,
        OX: int,
        FY: int,
        FX: int,
        stride: int = 1,
        relu: bool = True,
        B: int = 1,
        name: str | None = None,
    ) -> str:
        geom = dict(B=B, K=K, C=C, OY=OY, OX=OX, FY=FY, FX=FX, stride=stride)
        c = self.node("conv2d", (x,), name=name, **geom)
        b = self.node("bias_add", (c,), **geom)
        r = self.node("requant", (b,), **geom)
        if relu:
            return self.node("relu", (r,), **geom)
        return r

    def qdwconv(self, x: str, *, C: int, OY: int, OX: int, FY: int = 3, FX: int = 3, stride: int = 1, B: int = 1) -> str:
        geom = dict(B=B, C=C, OY=OY, OX=OX, FY=FY, FX=FX, stride=stride)
        c = self.node("dwconv2d", (x,), **geom)
        b = self.node("bias_add", (c,), **geom)
        r = self.node("requant", (b,), **geom)
        return self.node("relu", (r,), **geom)

    def qdense(self, x: str, *, K: int, C: int, relu: bool = True, B: int = 1) -> str:
        geom = dict(B=B, K=K, C=C)
        d = self.node("dense", (x,), **geom)
        b = self.node("bias_add", (d,), **geom)
        r = self.node("requant", (b,), **geom)
        if relu:
            return self.node("relu", (r,), **geom)
        return r

    def add(self, a: str, b: str, **geom) -> str:
        s = self.node("add", (a, b), **geom)
        return self.node("requant", (s,), **geom)

    def avgpool(self, x: str, *, C: int, FY: int, FX: int, OY: int = 1, OX: int = 1, B: int = 1) -> str:
        return self.node("avgpool", (x,), B=B, C=C, OY=OY, OX=OX, FY=FY, FX=FX)

    def build(self, outputs: tuple[str, ...]) -> Graph:
        g = Graph(self.name, self.nodes, self.inputs, outputs)
        assert g.topo_check()
        return g


def conv_block_graph(
    *,
    IX: int,
    IY: int,
    C: int,
    K: int,
    FY: int = 3,
    FX: int = 3,
    stride: int = 1,
    depthwise: bool = False,
    B: int = 1,
) -> Graph:
    """Micro-benchmark block (paper Sec. VI-A): conv + bias + requant.

    Padding of 1 on all corners, stride 1, like the paper sweep — so
    OY=IY, OX=IX at stride 1.
    """
    oy, ox = IY // stride, IX // stride
    g = _G(f"{'dw' if depthwise else ''}conv_{C}x{IY}x{IX}_k{K}")
    x = g.add_input("x", (B, IY, IX, C))
    if depthwise:
        geom = dict(B=B, C=C, OY=oy, OX=ox, FY=FY, FX=FX, stride=stride)
        c = g.node("dwconv2d", (x,), **geom)
    else:
        geom = dict(B=B, K=K, C=C, OY=oy, OX=ox, FY=FY, FX=FX, stride=stride)
        c = g.node("conv2d", (x,), **geom)
    b = g.node("bias_add", (c,), **geom)
    r = g.node("requant", (b,), **geom)
    return g.build((r,))


def resnet8_graph(B: int = 1) -> Graph:
    """MLPerf-Tiny ResNet-V1: 8-conv backbone on 32x32x3 CIFAR-10."""
    g = _G("resnet8")
    x = g.add_input("x", (B, 32, 32, 3))
    # stem
    s = g.qconv(x, K=16, C=3, OY=32, OX=32, FY=3, FX=3, name="stem")
    # stack 1 (16ch, 32x32)
    c1 = g.qconv(s, K=16, C=16, OY=32, OX=32, FY=3, FX=3)
    c2 = g.qconv(c1, K=16, C=16, OY=32, OX=32, FY=3, FX=3, relu=False)
    a1 = g.add(s, c2, B=B, K=16, C=16, OY=32, OX=32)
    # stack 2 (32ch, 16x16), projection shortcut 1x1/2
    c3 = g.qconv(a1, K=32, C=16, OY=16, OX=16, FY=3, FX=3, stride=2)
    c4 = g.qconv(c3, K=32, C=32, OY=16, OX=16, FY=3, FX=3, relu=False)
    p2 = g.qconv(a1, K=32, C=16, OY=16, OX=16, FY=1, FX=1, stride=2, relu=False)
    a2 = g.add(p2, c4, B=B, K=32, C=32, OY=16, OX=16)
    # stack 3 (64ch, 8x8)
    c5 = g.qconv(a2, K=64, C=32, OY=8, OX=8, FY=3, FX=3, stride=2)
    c6 = g.qconv(c5, K=64, C=64, OY=8, OX=8, FY=3, FX=3, relu=False)
    p3 = g.qconv(a2, K=64, C=32, OY=8, OX=8, FY=1, FX=1, stride=2, relu=False)
    a3 = g.add(p3, c6, B=B, K=64, C=64, OY=8, OX=8)
    # head
    ap = g.avgpool(a3, C=64, FY=8, FX=8, B=B)
    fc = g.qdense(ap, K=10, C=64, relu=False, B=B)
    return g.build((fc,))


def mobilenet_v1_graph(B: int = 1) -> Graph:
    """MLPerf-Tiny MobileNetV1 x0.25 on 96x96x3 (Visual Wake Words)."""
    g = _G("mobilenet_v1_025")
    x = g.add_input("x", (B, 96, 96, 3))
    # stem conv 3x3/2 -> 8ch 48x48
    h = g.qconv(x, K=8, C=3, OY=48, OX=48, FY=3, FX=3, stride=2, name="stem")
    # (out_ch, stride) for the 13 depthwise-separable blocks at alpha=0.25
    blocks = [
        (16, 1),
        (32, 2),
        (32, 1),
        (64, 2),
        (64, 1),
        (128, 2),
        (128, 1),
        (128, 1),
        (128, 1),
        (128, 1),
        (128, 1),
        (256, 2),
        (256, 1),
    ]
    c_in, hw = 8, 48
    for k_out, s in blocks:
        hw_out = hw // s
        h = g.qdwconv(h, C=c_in, OY=hw_out, OX=hw_out, stride=s, B=B)
        h = g.qconv(h, K=k_out, C=c_in, OY=hw_out, OX=hw_out, FY=1, FX=1, B=B)
        c_in, hw = k_out, hw_out
    ap = g.avgpool(h, C=c_in, FY=hw, FX=hw, B=B)
    fc = g.qdense(ap, K=2, C=c_in, relu=False, B=B)
    return g.build((fc,))


def dscnn_graph(B: int = 1) -> Graph:
    """MLPerf-Tiny DS-CNN keyword spotting on 49x10x1 MFCC.

    First conv uses the 4x10 rectangular filter the paper calls out as
    NOT offloadable to NE16 (Sec. VI-C) -> it must land on the cluster.
    """
    g = _G("dscnn")
    x = g.add_input("x", (B, 49, 10, 1))
    # conv (10,4), stride (2,2) -> 25x5x64
    h = g.qconv(x, K=64, C=1, OY=25, OX=5, FY=10, FX=4, stride=2, name="conv_4x10")
    for _ in range(4):
        h = g.qdwconv(h, C=64, OY=25, OX=5, B=B)
        h = g.qconv(h, K=64, C=64, OY=25, OX=5, FY=1, FX=1, B=B)
    ap = g.avgpool(h, C=64, FY=25, FX=5, B=B)
    fc = g.qdense(ap, K=12, C=64, relu=False, B=B)
    return g.build((fc,))


def dae_graph(B: int = 1) -> Graph:
    """MLPerf-Tiny FC AutoEncoder (DCASE2020 ToyCar): all-dense.

    Paper Sec. VI-C: entirely fully-connected => never maps to NE16;
    NE16+CPU config equals CPU-only.
    """
    g = _G("dae")
    x = g.add_input("x", (B, 640))
    h = x
    c = 640
    for k in (128, 128, 128, 128, 8, 128, 128, 128, 128):
        h = g.qdense(h, K=k, C=c, B=B)
        c = k
    out = g.qdense(h, K=640, C=c, relu=False, B=B)
    return g.build((out,))


def mlperf_tiny_networks(B: int = 1) -> dict[str, Graph]:
    return {
        "MobileNet": mobilenet_v1_graph(B),
        "ResNet": resnet8_graph(B),
        "DSCNN": dscnn_graph(B),
        "DAE": dae_graph(B),
    }

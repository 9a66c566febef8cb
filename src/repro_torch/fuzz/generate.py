"""Seeded random quantized-DAG generation over the repro_torch.core graph IR.

Two layers, so minimization can operate on a declarative description:

* a **spec dict** — JSON-safe, fully describing one graph: the input
  tensor shape plus a list of ops, each naming its source *values* by
  index (value 0 is the graph input; op ``i`` produces value ``i+1``).
* :func:`build_graph` — a deterministic expansion of a spec into a
  :class:`repro_torch.core.graph.Graph`.  Anchor ops (conv/dwconv/dense)
  expand to the quantized idiom the netlists use — anchor (+bias_add)
  + requant (+relu) — and elementwise joins always requant, so every
  value stays int8-ranged and the float32 integer simulation stays
  exact (the same invariant ``repro_torch.cnn.nets`` relies on).  Invalid
  specs raise :class:`SpecError`; the shrinker uses that to discard
  broken minimization candidates.

:func:`sample_spec` drives generation from a seed and
:class:`FuzzKnobs` (fan-out degree, residual-ladder depth, join arity,
shape ranges); the same seed always yields byte-identical specs, and
:func:`random_inputs` derives the input tensors from the same seed.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.graph import Graph, Node

__all__ = [
    "SPEC_VERSION",
    "FuzzKnobs",
    "SpecError",
    "build_graph",
    "graph_for_seed",
    "random_inputs",
    "sample_spec",
]

SPEC_VERSION = 1

# every op kind a spec may contain (documentation + validation)
OP_KINDS = (
    "conv", "dwconv", "dense",          # parametric anchors (quantized idiom)
    "add", "mul",                        # n-ary elementwise joins (+ requant)
    "concat",                            # channel concatenation
    "relu", "clip", "requant",           # unary elementwise
    "reshape",                           # structural passthrough
    "avgpool", "maxpool",                # pooling
)


class SpecError(ValueError):
    """The spec does not describe a buildable graph."""


@dataclass(frozen=True)
class FuzzKnobs:
    """Generation knobs.  All sampling flows from these plus the seed."""

    min_ops: int = 3
    max_ops: int = 10
    batch_choices: tuple[int, ...] = (1, 1, 1, 2)
    spatial_range: tuple[int, int] = (4, 12)     # input H and W
    channel_range: tuple[int, int] = (2, 8)      # input C and conv K
    elem_bytes: int = 1                          # activation dtype width
    input_range: tuple[int, int] = (-128, 127)   # input value range
    fan_out_p: float = 0.35        # P(consume an older value, not the latest)
    ladder_p: float = 0.5          # P(an add is a residual add-back)
    join_extra_p: float = 0.35     # P(grow a join's arity by one more src)
    max_join_arity: int = 4
    concat_max_channels: int = 48
    dense_max_flat: int = 8192     # keeps int accumulations < 2^24 (exact fp32)
    # op kind -> sampling weight (kinds may repeat for emphasis)
    op_weights: tuple[tuple[str, int], ...] = (
        ("conv", 6), ("dwconv", 3), ("dense", 2),
        ("add", 4), ("mul", 2), ("concat", 3),
        ("relu", 2), ("clip", 1), ("requant", 1),
        ("reshape", 2), ("avgpool", 1), ("maxpool", 2),
    )


# ---------------------------------------------------------------------------
# Spec -> Graph (deterministic)
# ---------------------------------------------------------------------------


@dataclass
class _Value:
    """Shape-tracking entry for one spec value during expansion."""

    name: str                    # producing node name (or graph input name)
    shape: tuple[int, ...]       # (B, H, W, C) spatial or (B, C) flat

    @property
    def spatial(self) -> bool:
        return len(self.shape) == 4


def _geom_attrs(shape: tuple[int, ...], eb: int) -> dict:
    """Elementwise-node geometry attrs for a value of this shape."""
    if len(shape) == 4:
        b, h, w, c = shape
        return {"B": b, "C": c, "OY": h, "OX": w, "elem_bytes": eb}
    b, c = shape
    return {"B": b, "C": c, "OY": 1, "OX": 1, "elem_bytes": eb}


def build_graph(spec: dict, name: str | None = None) -> Graph:
    """Deterministically expand ``spec`` into a topo-ordered Graph.

    Raises :class:`SpecError` on any malformed spec (bad src index,
    shape mismatch at a join, non-divisible stride/pool, ...), which is
    what lets the shrinker probe candidate simplifications safely.
    """
    try:
        b = int(spec["B"])
        h = int(spec["H"])
        w = int(spec["W"])
        c = int(spec["C"])
        ops = spec["ops"]
    except (KeyError, TypeError, ValueError) as e:
        raise SpecError(f"malformed spec header: {e}") from e
    if b < 1 or h < 1 or w < 1 or c < 1:
        raise SpecError(f"non-positive input shape {(b, h, w, c)}")
    if not isinstance(ops, list) or not ops:
        raise SpecError("spec needs a non-empty op list")
    eb = int(spec.get("elem_bytes", 1))

    values: list[_Value] = [_Value("x", (b, h, w, c))]
    nodes: list[Node] = []
    consumed: set[int] = set()

    def src_value(op: dict, key: str = "src") -> tuple[int, _Value]:
        try:
            idx = int(op[key])
        except (KeyError, TypeError, ValueError) as e:
            raise SpecError(f"op {op!r}: bad {key}: {e}") from e
        if not 0 <= idx < len(values):
            raise SpecError(f"op {op!r}: src {idx} out of range")
        return idx, values[idx]

    def srcs_values(op: dict) -> tuple[list[int], list[_Value]]:
        raw = op.get("srcs")
        if not isinstance(raw, list) or len(raw) < 2:
            raise SpecError(f"op {op!r}: join needs >= 2 srcs")
        idxs, vals = [], []
        for r in raw:
            i = int(r)
            if not 0 <= i < len(values):
                raise SpecError(f"op {op!r}: src {i} out of range")
            idxs.append(i)
            vals.append(values[i])
        return idxs, vals

    for i, op in enumerate(ops):
        if not isinstance(op, dict) or "kind" not in op:
            raise SpecError(f"op {i} is not a dict with a 'kind'")
        kind = op["kind"]
        pre = f"n{i:02d}"
        out: _Value

        if kind in ("conv", "dwconv"):
            si, sv = src_value(op)
            if not sv.spatial:
                raise SpecError(f"op {i}: {kind} needs a spatial src")
            bb, hh, ww, cc = sv.shape
            f = int(op.get("F", 3))
            stride = int(op.get("stride", 1))
            if f < 1 or stride < 1:
                raise SpecError(f"op {i}: bad F/stride")
            if hh % stride or ww % stride:
                raise SpecError(f"op {i}: stride {stride} does not divide {hh}x{ww}")
            oy, ox = hh // stride, ww // stride
            if kind == "conv":
                k = int(op.get("K", cc))
                if k < 1:
                    raise SpecError(f"op {i}: bad K")
                anchor_op, ch_out = "conv2d", k
            else:
                anchor_op, ch_out = "dwconv2d", cc
            geom = {
                "B": bb, "K": ch_out, "C": cc, "OY": oy, "OX": ox,
                "FY": f, "FX": f, "stride": stride, "elem_bytes": eb,
            }
            if kind == "dwconv":
                geom.pop("K")  # dwconv keeps C channels; K would mis-size it
            nodes.append(Node(f"{pre}c", anchor_op, (sv.name,), dict(geom)))
            last = f"{pre}c"
            epi = {k2: v for k2, v in geom.items() if k2 not in ("FY", "FX", "stride")}
            if op.get("bias", True):
                nodes.append(Node(f"{pre}b", "bias_add", (last,), dict(epi)))
                last = f"{pre}b"
            nodes.append(Node(f"{pre}q", "requant", (last,), dict(epi)))
            last = f"{pre}q"
            if op.get("relu", False):
                nodes.append(Node(f"{pre}r", "relu", (last,), dict(epi)))
                last = f"{pre}r"
            out = _Value(last, (bb, oy, ox, ch_out))
            consumed.add(si)

        elif kind == "dense":
            si, sv = src_value(op)
            flat = 1
            for d in sv.shape[1:]:
                flat *= d
            k = int(op.get("K", 8))
            if k < 1:
                raise SpecError(f"op {i}: bad K")
            bb = sv.shape[0]
            geom = {"B": bb, "K": k, "C": flat, "OY": 1, "OX": 1, "elem_bytes": eb}
            nodes.append(Node(f"{pre}c", "dense", (sv.name,), dict(geom)))
            last = f"{pre}c"
            if op.get("bias", True):
                nodes.append(Node(f"{pre}b", "bias_add", (last,), dict(geom)))
                last = f"{pre}b"
            nodes.append(Node(f"{pre}q", "requant", (last,), dict(geom)))
            last = f"{pre}q"
            if op.get("relu", False):
                nodes.append(Node(f"{pre}r", "relu", (last,), dict(geom)))
                last = f"{pre}r"
            out = _Value(last, (bb, k))
            consumed.add(si)

        elif kind in ("add", "mul"):
            idxs, vals = srcs_values(op)
            shape = vals[0].shape
            for v in vals[1:]:
                if v.shape != shape:
                    raise SpecError(f"op {i}: join over mismatched shapes "
                                    f"{[v.shape for v in vals]}")
            geom = _geom_attrs(shape, eb)
            nodes.append(Node(f"{pre}j", kind, tuple(v.name for v in vals), dict(geom)))
            nodes.append(Node(f"{pre}q", "requant", (f"{pre}j",), dict(geom)))
            last = f"{pre}q"
            if op.get("relu", False):
                nodes.append(Node(f"{pre}r", "relu", (last,), dict(geom)))
                last = f"{pre}r"
            out = _Value(last, shape)
            consumed.update(idxs)

        elif kind == "concat":
            idxs, vals = srcs_values(op)
            lead = vals[0].shape[:-1]
            for v in vals[1:]:
                if v.shape[:-1] != lead:
                    raise SpecError(f"op {i}: concat over mismatched shapes "
                                    f"{[v.shape for v in vals]}")
            ch = sum(v.shape[-1] for v in vals)
            shape = lead + (ch,)
            geom = _geom_attrs(shape, eb)
            nodes.append(Node(f"{pre}t", "concat", tuple(v.name for v in vals), dict(geom)))
            out = _Value(f"{pre}t", shape)
            consumed.update(idxs)

        elif kind in ("relu", "clip", "requant"):
            si, sv = src_value(op)
            geom = _geom_attrs(sv.shape, eb)
            if kind == "clip":
                geom.update(clip_min=-128.0, clip_max=127.0)
            nodes.append(Node(f"{pre}e", kind, (sv.name,), dict(geom)))
            out = _Value(f"{pre}e", sv.shape)
            consumed.add(si)

        elif kind == "reshape":
            si, sv = src_value(op)
            # structural passthrough: deliberately geometry-less, so the
            # stack must size its edge by walking to the real producer
            nodes.append(Node(f"{pre}s", "reshape", (sv.name,), {"elem_bytes": eb}))
            out = _Value(f"{pre}s", sv.shape)
            consumed.add(si)

        elif kind == "avgpool":
            si, sv = src_value(op)
            if not sv.spatial:
                raise SpecError(f"op {i}: avgpool needs a spatial src")
            bb, hh, ww, cc = sv.shape
            geom = {"B": bb, "C": cc, "OY": 1, "OX": 1, "FY": hh, "FX": ww,
                    "elem_bytes": eb}
            nodes.append(Node(f"{pre}p", "avgpool", (sv.name,), dict(geom)))
            out = _Value(f"{pre}p", (bb, 1, 1, cc))
            consumed.add(si)

        elif kind == "maxpool":
            si, sv = src_value(op)
            if not sv.spatial:
                raise SpecError(f"op {i}: maxpool needs a spatial src")
            bb, hh, ww, cc = sv.shape
            f = int(op.get("F", 2))
            if f < 1 or hh % f or ww % f:
                raise SpecError(f"op {i}: pool {f} does not divide {hh}x{ww}")
            geom = {"B": bb, "C": cc, "OY": hh // f, "OX": ww // f,
                    "FY": f, "FX": f, "elem_bytes": eb}
            nodes.append(Node(f"{pre}p", "maxpool", (sv.name,), dict(geom)))
            out = _Value(f"{pre}p", (bb, hh // f, ww // f, cc))
            consumed.add(si)

        else:
            raise SpecError(f"op {i}: unknown kind {kind!r}")

        values.append(out)

    # graph outputs = sink values: unconsumed values are never fused
    # inside a segment, so they are always addressable at runtime
    outputs = tuple(v.name for j, v in enumerate(values)
                    if j not in consumed and j > 0)
    if not outputs:
        raise SpecError("spec has no sink value")
    g = Graph(
        name or spec.get("name", "fuzz"),
        nodes,
        {"x": (b, h, w, c)},
        outputs,
    )
    if not g.topo_check():  # by construction; belt and braces
        raise SpecError("built graph failed topo_check")
    return g


# ---------------------------------------------------------------------------
# Seeded spec sampling
# ---------------------------------------------------------------------------


def sample_spec(seed: int, knobs: FuzzKnobs | None = None) -> dict:
    """Sample one JSON-safe graph spec.  Same seed -> identical spec."""
    kn = knobs or FuzzKnobs()
    rng = random.Random(int(seed))
    b = rng.choice(kn.batch_choices)
    h = rng.randint(*kn.spatial_range)
    w = rng.randint(*kn.spatial_range)
    c = rng.randint(*kn.channel_range)
    n_ops = rng.randint(kn.min_ops, kn.max_ops)

    # mirror of build_graph's value table: (shape tuple, spatial flag)
    shapes: list[tuple[int, ...]] = [(b, h, w, c)]
    ops: list[dict] = []

    def pick_src(pool: list[int]) -> int:
        """Latest-biased source choice; fan_out_p re-consumes older values."""
        if len(pool) > 1 and rng.random() < kn.fan_out_p:
            return rng.choice(pool[:-1])
        return pool[-1]

    weighted = [k for k, wt in kn.op_weights for _ in range(wt)]
    for _ in range(n_ops):
        spatial = [i for i, s in enumerate(shapes) if len(s) == 4]
        kind = None
        # rejection-sample a feasible kind (bounded: 'dense' always fits
        # something once the flat cap is checked, 'add' always fits)
        for _try in range(32):
            kk = rng.choice(weighted)
            if kk in ("conv", "dwconv", "relu", "clip", "requant",
                      "reshape", "avgpool", "concat") and not spatial:
                continue
            if kk == "maxpool" and not any(
                shapes[i][1] % 2 == 0 and shapes[i][2] % 2 == 0 for i in spatial
            ):
                continue
            if kk == "dense" and not any(
                int(np.prod(s[1:])) <= kn.dense_max_flat for s in shapes
            ):
                continue
            kind = kk
            break
        if kind is None:
            kind = "add"

        if kind in ("conv", "dwconv"):
            si = pick_src(spatial)
            _, hh, ww, _ = shapes[si]
            f = rng.choice((1, 3, 3))
            stride = 2 if (hh % 2 == 0 and ww % 2 == 0 and rng.random() < 0.3) else 1
            op = {"kind": kind, "src": si, "F": f, "stride": stride,
                  "bias": rng.random() < 0.8, "relu": rng.random() < 0.5}
            if kind == "conv":
                op["K"] = rng.randint(*kn.channel_range)
            shape = (shapes[si][0], hh // stride, ww // stride,
                     op.get("K", shapes[si][3]))
        elif kind == "dense":
            pool = [i for i, s in enumerate(shapes)
                    if int(np.prod(s[1:])) <= kn.dense_max_flat]
            si = pick_src(pool)
            op = {"kind": "dense", "src": si, "K": rng.randint(*kn.channel_range),
                  "bias": rng.random() < 0.8, "relu": rng.random() < 0.3}
            shape = (shapes[si][0], op["K"])
        elif kind in ("add", "mul"):
            base = pick_src(list(range(len(shapes))))
            same = [i for i, s in enumerate(shapes) if s == shapes[base]]
            srcs = [base]
            if rng.random() < kn.ladder_p and len(same) > 1:
                # residual add-back: join the newest same-shape value with
                # an explicitly older one (ladder depth grows as convs
                # preserve shape down the trunk)
                srcs.append(rng.choice([i for i in same if i != base]))
            else:
                srcs.append(rng.choice(same))  # may repeat base: x+x is legal
            while (len(srcs) < kn.max_join_arity
                   and rng.random() < kn.join_extra_p):
                srcs.append(rng.choice(same))
            op = {"kind": kind, "srcs": srcs, "relu": rng.random() < 0.3}
            shape = shapes[base]
        elif kind == "concat":
            base = pick_src(spatial)
            lead = shapes[base][:-1]
            same = [i for i in spatial if shapes[i][:-1] == lead]
            srcs = [base, rng.choice(same)]
            while (len(srcs) < kn.max_join_arity
                   and rng.random() < kn.join_extra_p):
                srcs.append(rng.choice(same))
            ch = sum(shapes[i][-1] for i in srcs)
            while ch > kn.concat_max_channels and len(srcs) > 2:
                ch -= shapes[srcs.pop()][-1]
            if ch > kn.concat_max_channels:
                srcs = [base, base]
                ch = 2 * shapes[base][-1]
            op = {"kind": "concat", "srcs": srcs}
            shape = lead + (ch,)
        elif kind in ("relu", "clip", "requant"):
            si = pick_src(list(range(len(shapes))))
            op = {"kind": kind, "src": si}
            shape = shapes[si]
        elif kind == "reshape":
            si = pick_src(list(range(len(shapes))))
            op = {"kind": "reshape", "src": si}
            shape = shapes[si]
        elif kind == "avgpool":
            si = pick_src(spatial)
            op = {"kind": "avgpool", "src": si}
            shape = (shapes[si][0], 1, 1, shapes[si][3])
        else:  # maxpool
            pool = [i for i in spatial
                    if shapes[i][1] % 2 == 0 and shapes[i][2] % 2 == 0]
            si = pick_src(pool)
            op = {"kind": "maxpool", "src": si, "F": 2}
            shape = (shapes[si][0], shapes[si][1] // 2,
                     shapes[si][2] // 2, shapes[si][3])

        ops.append(op)
        shapes.append(shape)

    return {
        "version": SPEC_VERSION,
        "name": f"fuzz_s{int(seed)}",
        "B": b, "H": h, "W": w, "C": c,
        "elem_bytes": kn.elem_bytes,
        "input_range": list(kn.input_range),
        "ops": ops,
    }


def graph_for_seed(seed: int, knobs: FuzzKnobs | None = None) -> Graph:
    """``build_graph(sample_spec(seed))`` — the one-call entry point."""
    return build_graph(sample_spec(seed, knobs))


def random_inputs(spec: dict, seed: int) -> dict:
    """Integer-valued float32 input tensors derived from ``seed``."""
    lo, hi = spec.get("input_range", (-128, 127))
    rng = np.random.default_rng(int(seed))
    shape = (int(spec["B"]), int(spec["H"]), int(spec["W"]), int(spec["C"]))
    return {"x": rng.integers(int(lo), int(hi) + 1, size=shape).astype(np.float32)}

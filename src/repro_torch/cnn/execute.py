"""Runnable PyTorch execution of repro_torch.core CNN graphs.

The port of ``repro.cnn.execute``.  Integer inference is simulated in
float32 with integer-valued tensors: conv/dense accumulate int8 x int8
products exactly (every partial sum stays below 2^24, and
:func:`repro_torch._device.resolve_device` turns TF32 off on the card),
and ``requant`` applies the paper's rewritten arithmetic
f(x) = (x*M + B) >> S (Table II) via round-half-even + clip.

Tensors are NHWC and weights keep the reference layouts (HWIO conv
weights, ``(K, C)`` dense weights), so both packages compute the same
thing from the same numpy parameter dict.  ``apply_node`` is the single
source of truth for per-op semantics: the interpreter below and the fused
segment executors of :mod:`repro_torch.backend.lower` both call it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device, to_tensor
from repro_torch.core import Graph, Node
from repro_torch.kernels.tiled_conv import tiled_conv2d

__all__ = ["apply_node", "init_graph_params", "execute_graph", "params_to_torch"]


def _geom(n: Node, k: str, d: int = 1) -> int:
    return int(n.attr(k, d) or d)


def init_graph_params(graph: Graph, seed: int = 0) -> dict:
    """Random int8-valued weights for every parametric node (numpy,
    reference layouts; the same generator calls as ``repro.cnn``, so the
    same seed gives the same weights)."""
    rng = np.random.default_rng(seed)
    params: dict[str, dict] = {}
    for n in graph.nodes:
        if n.op == "conv2d":
            k, c, fy, fx = (_geom(n, a) for a in ("K", "C", "FY", "FX"))
            params[n.name] = {"w": rng.integers(-4, 5, size=(fy, fx, c, k)).astype(np.float32)}
        elif n.op == "dwconv2d":
            c, fy, fx = (_geom(n, a) for a in ("C", "FY", "FX"))
            # HWIO with feature_group_count=C: I=1, O=C
            params[n.name] = {"w": rng.integers(-4, 5, size=(fy, fx, 1, c)).astype(np.float32)}
        elif n.op == "dense":
            k, c = _geom(n, "K"), _geom(n, "C")
            params[n.name] = {"w": rng.integers(-4, 5, size=(k, c)).astype(np.float32)}
        elif n.op == "bias_add":
            k = _geom(n, "K", _geom(n, "C"))
            params[n.name] = {"b": rng.integers(-16, 17, size=(k,)).astype(np.float32)}
        elif n.op == "requant":
            # (x * M + B) >> S with M=1, B=0: divide by 2^S, round, clip.
            # A folded requant (fold_requant_div) carries the chain's shift
            # in its attrs — honor it instead of clobbering with 5.
            s = n.attr("shift", None)
            params[n.name] = {"shift": np.float32(5.0 if s is None else float(s))}
    return params


def params_to_torch(params: dict, device) -> dict:
    """The reference's parameter dict with every array as a tensor on
    ``device``, layouts unchanged (HWIO conv, ``(K, C)`` dense, ``b``).

    Scalars (``shift``, ``scale``, ``addend``, ...) become Python floats
    holding their float32 value: kernels take them as launch arguments,
    so they never sit on the device.  Idempotent — tensors already on
    ``device`` pass through, so callers convert once and reuse.
    """
    dev = torch.device(device)
    out: dict[str, dict] = {}
    for name, p in params.items():
        q = {}
        for k, v in p.items():
            if isinstance(v, float) or np.ndim(v) == 0:
                q[k] = float(np.float32(float(v)))
            else:
                q[k] = to_tensor(v, dev)
        out[name] = q
    return out


def _scalar(p: dict, n: Node, key: str, default: float) -> float:
    """Per-node scalar constant: params win over node attrs over default."""
    if key in p:
        return float(np.float32(float(p[key])))
    v = n.attr(key, None)
    return float(np.float32(float(default if v is None else v)))


def _conv(x, w, stride, depthwise):
    groups = x.shape[-1] if depthwise else 1
    return tiled_conv2d(x, w, stride=stride, feature_groups=groups)


def apply_node(n: Node, p: dict, xs: list) -> torch.Tensor:
    """Evaluate one graph node given its params ``p`` and inputs ``xs``.

    Shared by ``execute_graph`` and the fused segment executors of
    ``repro_torch.backend``; any semantics change here changes both paths.
    ``p`` holds tensors on the inputs' device (:func:`params_to_torch`).
    """
    if n.op == "conv2d":
        return _conv(xs[0], p["w"], _geom(n, "stride"), depthwise=False)
    if n.op == "dwconv2d":
        return _conv(xs[0], p["w"], _geom(n, "stride"), depthwise=True)
    if n.op == "dense":
        x = xs[0]
        x = x.reshape(x.shape[0], -1)  # flatten (B,1,1,C) heads
        return x @ p["w"].T
    if n.op == "bias_add":
        return xs[0] + p["b"]
    if n.op == "requant":
        # (x * M + B) >> S with round-half-even + clip; M/B/S come from
        # params, else from attrs fold_requant_div carried off the chain
        scale = _scalar(p, n, "scale", 1.0)
        addend = _scalar(p, n, "addend", 0.0)
        shift = _scalar(p, n, "shift", 5.0)
        y = torch.round((xs[0] * scale + addend) / (2.0**shift))
        return torch.clamp(y, -128, 127)
    if n.op == "relu":
        # dtype-preserving: integer/quantized activations stay integer
        return torch.clamp_min(xs[0], 0)
    if n.op == "add":
        if len(xs) >= 2:
            # n-ary elementwise join: sum every operand, never only two
            total = xs[0]
            for x in xs[1:]:
                total = total + x
            return total
        # constant addend (un-folded requant chains): x + B
        return xs[0] + _scalar(p, n, "addend", 0.0)
    if n.op == "avgpool":
        # global average pool as round(sum / count): the division
        # jnp.mean does, written out so no device mean's internal
        # rounding enters
        x = xs[0]
        return torch.round(x.sum(dim=(1, 2), keepdim=True) / (x.shape[1] * x.shape[2]))
    if n.op == "maxpool":
        # VALID windows, stride = window (floor division of the extent)
        fy, fx = _geom(n, "FY"), _geom(n, "FX")
        y = F.max_pool2d(xs[0].permute(0, 3, 1, 2), (fy, fx), (fy, fx))
        return y.permute(0, 2, 3, 1)
    if n.op in ("reshape", "identity"):
        return xs[0]
    if n.op == "mul":
        if len(xs) >= 2:
            total = xs[0]
            for x in xs[1:]:
                total = total * x
            return total
        return xs[0] * _scalar(p, n, "scale", 1.0)
    if n.op == "concat":
        # channel-axis concatenation (NHWC last axis); flat (B, C) rows
        # concatenate along their feature axis, which is also axis -1
        return torch.cat(xs, dim=-1)
    if n.op == "div":
        if len(xs) == 2:
            return xs[0] / xs[1]
        return xs[0] / _scalar(p, n, "divisor", 1.0)
    if n.op == "rshift":
        # arithmetic right shift on integer-valued tensors: floor(x / 2^S)
        shift = _scalar(p, n, "shift", 0.0)
        return torch.floor(xs[0] / (2.0**shift))
    if n.op == "clip":
        lo = n.attr("clip_min", None)
        hi = n.attr("clip_max", None)
        return torch.clamp(
            xs[0],
            -128.0 if lo is None else float(lo),
            127.0 if hi is None else float(hi),
        )
    raise NotImplementedError(f"op {n.op}")


def execute_graph(graph: Graph, params: dict, inputs: dict, *, device=None) -> dict:
    """Interpret the graph on ``device`` (CUDA unless told otherwise);
    returns {output_name: tensor}.  ``params`` and ``inputs`` may be the
    reference's numpy dicts or tensors."""
    dev = resolve_device(device)
    tparams = params_to_torch(params, dev)
    env: dict[str, torch.Tensor] = {
        k: to_tensor(v, dev, torch.float32) for k, v in inputs.items()
    }

    for n in graph.nodes:
        xs = [env[i] for i in n.inputs]
        try:
            env[n.name] = apply_node(n, tparams.get(n.name, {}), xs)
        except NotImplementedError:
            raise NotImplementedError(f"op {n.op} in {graph.name}")

    return {o: env[o] for o in graph.outputs}

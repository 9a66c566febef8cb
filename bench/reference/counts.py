"""What a configuration's net needs, counted from its layer list alone.

The need of a batch of ``rows`` samples is the work of the int8 net as
declared, whatever implements it: ops = 2 x MACs (avgpool: one add per
input element), and the bytes of each input read once, each weight and
int32 bias read once per batch, and each output written once, all at
their declared widths (int8 activations and weights, int32 bias).  A
layer's least time is max(bytes / HBM bytes/s, ops / peak ops/s); the
net's is the sum over its layers.

The harness asks a counts module for :func:`macs_of` and :func:`need_s_of`,
which take the whole configuration; the functions of a layer list beside
them are what those, and other counts modules, are built from.
"""

from __future__ import annotations

__all__ = ["layer_counts", "macs", "macs_of", "need_s", "need_s_of", "shapes"]

ACT_BYTES, WEIGHT_BYTES, BIAS_BYTES = 1, 1, 4


def shapes(layers: list[dict], input_shape: list[int]) -> list[tuple[tuple[int, ...], tuple[int, ...]]]:
    """(input shape, output shape) of each layer for one sample, batch
    axis dropped."""
    cur = tuple(input_shape[1:])
    out = []
    for layer in layers:
        op = layer["op"]
        if op == "conv2d":
            nxt = (layer["OY"], layer["OX"], layer["K"])
        elif op == "dwconv2d":
            nxt = (layer["OY"], layer["OX"], layer["C"])
        elif op == "dense":
            nxt = (layer["K"],)
        elif op == "avgpool":
            nxt = (1, 1, layer["C"])
        else:
            raise ValueError(f"no count for op {op!r}")
        out.append((cur, nxt))
        cur = nxt
    return out


def _prod(t: tuple[int, ...]) -> int:
    n = 1
    for v in t:
        n *= v
    return n


def layer_counts(layer: dict, in_shape: tuple[int, ...], out_shape: tuple[int, ...], rows: int) -> dict:
    """MACs, ops and bytes of one layer over ``rows`` samples."""
    op = layer["op"]
    if op == "conv2d":
        per_row = layer["K"] * layer["OY"] * layer["OX"] * layer["C"] * layer["FY"] * layer["FX"]
        params = layer["FY"] * layer["FX"] * layer["C"] * layer["K"] * WEIGHT_BYTES + layer["K"] * BIAS_BYTES
    elif op == "dwconv2d":
        per_row = layer["C"] * layer["OY"] * layer["OX"] * layer["FY"] * layer["FX"]
        params = layer["FY"] * layer["FX"] * layer["C"] * WEIGHT_BYTES + layer["C"] * BIAS_BYTES
    elif op == "dense":
        per_row = layer["K"] * layer["C"]
        params = layer["K"] * layer["C"] * WEIGHT_BYTES + layer["K"] * BIAS_BYTES
    elif op == "avgpool":
        per_row, params = 0, 0
    else:
        raise ValueError(f"no count for op {op!r}")
    mac = per_row * rows
    ops = 2 * mac if op != "avgpool" else _prod(in_shape) * rows
    nbytes = params + (_prod(in_shape) + _prod(out_shape)) * ACT_BYTES * rows
    return {"macs": mac, "ops": ops, "bytes": nbytes}


def macs(layers: list[dict], input_shape: list[int]) -> int:
    """MACs of one sample through the net."""
    return sum(layer_counts(l, i, o, 1)["macs"] for l, (i, o) in zip(layers, shapes(layers, input_shape)))


def need_s(layers: list[dict], input_shape: list[int], rows: int, ops_s: float, bytes_s: float) -> float:
    """The least device seconds of one batch of ``rows`` samples."""
    total = 0.0
    for layer, (i, o) in zip(layers, shapes(layers, input_shape)):
        c = layer_counts(layer, i, o, rows)
        total += max(c["bytes"] / bytes_s, c["ops"] / ops_s)
    return total


def macs_of(config: dict) -> int:
    """MACs of one sample through the configuration's net."""
    return macs(config["layers"], config["input"]["shape"])


def need_s_of(config: dict, rows: int, peaks: dict) -> float:
    """The least device seconds of one batch of ``rows`` samples, at the
    peak the configuration's precision names and the HBM's bytes/s."""
    return need_s(config["layers"], config["input"]["shape"], rows, peaks[config["precision"]["peak"]],
                  peaks["hbm_bytes_s"])

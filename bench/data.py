"""Everything a run draws from ``--seed``: weights, biases, requant shifts
and the pool of inputs, made in a few large calls by a ``torch.Generator``
on the run's device.

The draw is the benchmark's own: the program gets float32 copies of the
weights and biases (the integer-valued float32 it serves in), the
reference gets the int8 and int32 originals.  The rules are the ones the
configuration's ``assumed`` block states.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from bench.reference.cnn_int import MAC_OPS

__all__ = ["Draw", "draw", "fan_in", "shifts"]

W_RMS = 73.9  # rms of a uniform int8 weight
IN_RMS = 73.9  # rms of the net's uniform int8 input
ACT_RMS = 32 / math.sqrt(2)  # rms after a requant to rms 32 and a ReLU
TARGET_RMS = 32.0
BIAS_RAW_BITS = 20  # biases are drawn over [-2**20, 2**20) and shifted down


def fan_in(layer: dict) -> int:
    if layer["op"] == "conv2d":
        return layer["FY"] * layer["FX"] * layer["C"]
    if layer["op"] == "dwconv2d":
        return layer["FY"] * layer["FX"]
    return layer["C"]


def shifts(layers: list[dict]) -> list[int | None]:
    """Each MAC layer's requant shift from its fan-in (``assumed.shift``)."""
    out: list[int | None] = []
    rms_in = IN_RMS
    for layer in layers:
        if layer["op"] not in MAC_OPS:
            out.append(None)
            continue
        acc_rms = math.sqrt(fan_in(layer)) * W_RMS * rms_in
        out.append(max(0, round(math.log2(acc_rms / TARGET_RMS))))
        rms_in = ACT_RMS
    return out


def _weight_shape(layer: dict) -> tuple[int, ...]:
    if layer["op"] == "conv2d":
        return (layer["FY"], layer["FX"], layer["C"], layer["K"])
    if layer["op"] == "dwconv2d":
        return (layer["FY"], layer["FX"], 1, layer["C"])
    return (layer["K"], layer["C"])


def _out_channels(layer: dict) -> int:
    return layer["C"] if layer["op"] == "dwconv2d" else layer["K"]


@dataclass
class Draw:
    """One seed's weights (int8), biases (int32) and shifts per layer, on
    the run's device, and the pool of int8 inputs in host memory."""

    weights: list[torch.Tensor | None]
    biases: list[torch.Tensor | None]
    shifts: list[int | None]
    pool: list[torch.Tensor]  # int8, (1, *input) each, host memory

    def reference_params(self) -> list[dict | None]:
        """The reference's parameters: host int8 and int32 arrays."""
        return [
            None if w is None else {"w": w.cpu().numpy(), "b": b.cpu().numpy(), "shift": s}
            for w, b, s in zip(self.weights, self.biases, self.shifts)
        ]


def draw(config: dict, seed: int, pool: int, device: torch.device) -> Draw:
    layers = config["layers"]
    in_shape = tuple(config["input"]["shape"][1:])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    mac = [layer for layer in layers if layer["op"] in MAC_OPS]
    w_sizes = [math.prod(_weight_shape(layer)) for layer in mac]
    b_sizes = [_out_channels(layer) for layer in mac]
    w_all = torch.randint(-128, 128, (sum(w_sizes),), generator=gen, device=device, dtype=torch.int8)
    b_all = torch.randint(-(2**BIAS_RAW_BITS), 2**BIAS_RAW_BITS, (sum(b_sizes),), generator=gen, device=device,
                          dtype=torch.int32)
    x_all = torch.randint(-128, 128, (pool, 1, *in_shape), generator=gen, device=device, dtype=torch.int8).cpu()
    sh = shifts(layers)
    weights, biases = [], []
    wi = bi = 0
    for layer, s in zip(layers, sh):
        if s is None:
            weights.append(None)
            biases.append(None)
            continue
        if not 0 <= s <= BIAS_RAW_BITS - 3:
            raise ValueError(f"shift {s} outside the bias rule's range")
        shape = _weight_shape(layer)
        n, k = math.prod(shape), _out_channels(layer)
        weights.append(w_all[wi : wi + n].view(shape))
        # [-2**20, 2**20) >> (17 - s) is uniform over [-2**(s+3), 2**(s+3))
        biases.append(b_all[bi : bi + k] >> (BIAS_RAW_BITS - 3 - s))
        wi, bi = wi + n, bi + k
    return Draw(weights, biases, sh, list(x_all.unbind(0)))

"""Shared helpers of the PyTorch-port tests (``tests/test_torch_*.py``).

Each (net, target) is dispatched once per process and package, with the
reference suite's ``budget=300``; inputs are the conformance harness's
(``tests/conformance/harness.py``), made with numpy from seed 0 and handed
as numpy to both packages.  :func:`perturb_rglru` draws the RG-LRU decay
parameters of an LM tree so that the recurrence carries across time.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

import repro.backend
import repro.cnn
import repro.core
import repro_torch.backend
import repro_torch.cnn
import repro_torch.core

BUDGET = 300
NETS = ("MobileNet", "ResNet", "DSCNN", "DAE")
TARGETS = ("diana", "gap9", "ne16_octa")
CELLS = [(n, t) for n in NETS for t in TARGETS]


@lru_cache(maxsize=None)
def ref_graph(net: str):
    return repro.cnn.mlperf_tiny_networks()[net]


@lru_cache(maxsize=None)
def port_graph(net: str):
    return repro_torch.cnn.mlperf_tiny_networks()[net]


@lru_cache(maxsize=None)
def ref_mapped(net: str, tgt: str):
    return repro.core.dispatch(ref_graph(net), tgt, budget=BUDGET)


@lru_cache(maxsize=None)
def port_mapped(net: str, tgt: str):
    return repro_torch.core.dispatch(port_graph(net), tgt, budget=BUDGET)


@lru_cache(maxsize=None)
def port_compiled(net: str, tgt: str):
    return repro_torch.backend.lower(port_mapped(net, tgt), device="cpu")


@lru_cache(maxsize=None)
def io(net: str):
    g = ref_graph(net)
    params = repro.cnn.init_graph_params(g)
    x = {
        k: np.random.default_rng(0).integers(-128, 128, s).astype("float32")
        for k, s in g.inputs.items()
    }
    return params, x


@lru_cache(maxsize=None)
def ref_outputs(net: str) -> dict:
    params, x = io(net)
    return {k: np.asarray(v) for k, v in repro.cnn.execute_graph(ref_graph(net), params, x).items()}


def segment_rows(mapped) -> list[tuple]:
    """What dispatch decided, comparable across the two packages."""
    return [
        (s.anchor.name, s.module, s.pattern, tuple(n.name for n in s.nodes), s.cycles, s.transfer_cycles)
        for s in mapped.segments
    ]


def node_rows(graph) -> list[tuple]:
    return [(n.name, n.op, tuple(n.inputs), dict(n.attrs)) for n in graph.nodes]


def perturb_rglru(params: dict, seed: int) -> dict:
    """An LM parameter tree (numpy leaves) with every ``rglru`` block's
    decay and gate parameters drawn from numpy seed ``seed``: ``lam``
    uniform in [-6, -2], the decay gate's bias N(-1, 0.5) and weight
    N(0, 0.05), the input gate's bias and weight N(0, 0.5).

    The reference init (``lam`` = 1, gates 0) puts every decay a_t near
    e^-5.25, so h carries almost nothing across time.  These draws put
    a_t in about 0.4-0.999.  A decay gate that saturates (r_t -> 0) would
    push a_t to within float32 ulps of 1, where ``1 - a_t^2`` (the input
    scale) keeps no correct digit and two correct ``exp``s disagree; the
    small gate weight keeps r_t away from 0."""
    rng = np.random.default_rng(seed)
    draws = {
        "gate_a_w": (0.0, 0.05),
        "gate_a_b": (-1.0, 0.5),
        "gate_i_w": (0.0, 0.5),
        "gate_i_b": (0.0, 0.5),
    }

    def walk(tree):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if k == "rglru":
                v = dict(v)
                v["lam"] = rng.uniform(-6.0, -2.0, np.shape(v["lam"])).astype(np.float32)
                for g, (mean, std) in draws.items():
                    v[g] = (mean + std * rng.normal(size=np.shape(v[g]))).astype(np.float32)
                out[k] = v
            elif isinstance(v, dict):
                out[k] = walk(v)
            else:
                out[k] = v
        return out

    return walk(params)

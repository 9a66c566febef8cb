"""Differential check of the port on generated graphs: the reference's
fuzz generator builds quantized DAGs (n-ary joins, concat, residual
ladders, pools, dense heads), and the port's interpreter and its
dispatch -> lower -> run on the CPU must match the JAX interpreter
bit-exactly on each, for the shipped regression corpus and fresh seeds."""

import json
from pathlib import Path

import numpy as np
import pytest

import repro.cnn
import repro_torch.backend
import repro_torch.cnn
import repro_torch.core
from repro.fuzz.generate import build_graph, random_inputs, sample_spec

CORPUS = sorted((Path(__file__).parent / "conformance" / "corpus").glob("*.json"))
SPECS = [(p.stem, json.loads(p.read_text())["spec"]) for p in CORPUS]
SPECS += [(f"seed{s}", sample_spec(s)) for s in range(10)]
TARGETS = ("diana", "gap9", "ne16_octa")


def _port_graph(g):
    """The reference graph rebuilt node for node in the port's IR."""
    nodes = [repro_torch.core.Node(n.name, n.op, tuple(n.inputs), dict(n.attrs)) for n in g.nodes]
    return repro_torch.core.Graph(g.name, nodes, dict(g.inputs), tuple(g.outputs), dict(g.attrs))


@pytest.mark.parametrize("tgt", TARGETS)
@pytest.mark.parametrize("name,spec", SPECS, ids=[n for n, _ in SPECS])
def test_generated_graph_bit_exact(name, spec, tgt):
    ref_g = build_graph(spec)
    params = repro.cnn.init_graph_params(ref_g, seed=0)
    x = random_inputs(spec, 0)
    want = {k: np.asarray(v) for k, v in repro.cnn.execute_graph(ref_g, params, x).items()}

    g = _port_graph(ref_g)
    interp = repro_torch.cnn.execute_graph(g, params, x, device="cpu")
    cm = repro_torch.backend.lower(repro_torch.core.dispatch(g, tgt, budget=300), device="cpu")
    got = cm.run(params, x)
    for k, w in want.items():
        assert np.array_equal(interp[k].numpy(), w), ("interpreter", k)
        assert np.array_equal(got[k].numpy(), w), ("compiled", k)

"""The port's AOT executor bit-exact on whole nets, on the CPU.

Parametrised over the reference's relu chain, DAE (ten GEMM segments)
and DS-CNN (banded convs and a GEMM head), each dispatched on gap9 and
on diana with ``budget=300``, in both memory modes: the port's
``AotModel.run`` against the reference ``AotModel.run`` and against the
port's ``CompiledModel.run``, over three inputs in a row (the arena
reused across runs), and the port's arena laid out as the reference's
(same length, same fallback buffers).  A separate file from
``test_torch_aot.py`` so that ``--dist loadfile`` spreads the JAX
compiles over workers.
"""

import numpy as np
import pytest

import repro.backend as rb
import repro.core as rc
import repro_torch.backend as pb
import repro_torch.core as pc
from _torch_port import BUDGET, io, port_mapped, ref_mapped


def _chain(core):
    nodes, prev = [], "x"
    for i in range(4):
        nodes.append(core.Node(f"r{i}", "relu", (prev,), {"B": 1, "C": 16, "OY": 1, "OX": 1, "elem_bytes": 1}))
        prev = f"r{i}"
    return core.Graph("unit_chain", nodes, {"x": (1, 16)}, (prev,))


def _case(net, tgt):
    """(port CompiledModel on the CPU, reference CompiledModel, params, inputs)."""
    if net == "relu_chain":
        x = {"x": np.random.default_rng(0).normal(size=(1, 16)).astype("float32")}
        return (
            pb.lower(pc.dispatch(_chain(pc), tgt, budget=BUDGET), device="cpu"),
            rb.lower(rc.dispatch(_chain(rc), tgt, budget=BUDGET)),
            {},
            x,
        )
    params, x = io(net)
    return pb.lower(port_mapped(net, tgt), device="cpu"), rb.lower(ref_mapped(net, tgt)), params, x


@pytest.mark.parametrize("memory", ["xla", "arena"])
@pytest.mark.parametrize("tgt", ["gap9", "diana"])
@pytest.mark.parametrize("net", ["relu_chain", "DAE", "DSCNN"])
def test_aot_bit_exact_with_reference_aot_and_compiled_run(net, tgt, memory):
    cm, ref_cm, params, x = _case(net, tgt)
    am = pb.compile_aot(cm, memory=memory)
    ref = rb.compile_aot(ref_cm, memory=memory)
    for i in range(3):
        xi = {k: np.clip(v + np.float32(i), -128, 127) for k, v in x.items()}  # int8-valued, as dense needs
        got = am.run(params, xi)
        want = {k: np.asarray(v) for k, v in ref.run(params, xi).items()}
        run = cm.run(params, xi)
        assert set(got) == set(want) == set(run)
        for k in want:
            assert np.array_equal(got[k].numpy(), want[k]), (k, i)
            assert np.array_equal(got[k].numpy(), run[k].numpy()), (k, i)
    entry, ref_entry = am.warmup(params, x), ref.warmup(params, x)
    assert entry.calls == 3
    assert (entry.arena_elems, entry.arena_fallbacks) == (ref_entry.arena_elems, ref_entry.arena_fallbacks)
    assert am.stats()["staging"] == ref.stats()["staging"]

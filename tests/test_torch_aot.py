"""The port's whole-graph AOT executor (``repro_torch.backend.aot``) on the
CPU: ``tests/test_aot_unit.py``'s AOT cases (from ``AotModel basics`` on)
ported, each held against the reference ``AotModel`` and against the
port's ``CompiledModel.run``, on the reference's relu chain dispatched on
gap9 with ``budget=300``.  Then the arena's layout against the
reference's, ``report_dict()["aot"]`` with the reference's keys, and an
AOT run under the host-sync check.  Marked ``cuda`` (decided inside the
fixture): both memory modes bit-exact on the card and the GEMM launches
of N runs.
"""

import json

import numpy as np
import pytest
import torch

import repro.backend as rb
import repro.core as rc
import repro_torch.backend as pb
import repro_torch.core as pc
from _torch_port import BUDGET, NoHostSync, io, port_mapped, ref_mapped
from repro_torch import _graphs
from repro_torch.cnn import params_to_torch


def relu_chain(core, n=4, width=16, name="unit_chain"):
    nodes, prev = [], "x"
    for i in range(n):
        nodes.append(
            core.Node(f"r{i}", "relu", (prev,), {"B": 1, "C": width, "OY": 1, "OX": 1, "elem_bytes": 1})
        )
        prev = f"r{i}"
    return core.Graph(name, nodes, {"x": (1, width)}, (prev,))


def _lowered(core, backend, **kw):
    return backend.lower(core.dispatch(relu_chain(core), "gap9", budget=BUDGET), **kw)


@pytest.fixture(scope="module")
def compiled():
    return _lowered(pc, pb, device="cpu")


@pytest.fixture(scope="module")
def ref_compiled():
    return _lowered(rc, rb)


@pytest.fixture(scope="module")
def io_chain():
    x = np.random.default_rng(0).normal(size=(1, 16)).astype("float32")
    return {}, {"x": x}


def _same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def _keys(d):
    """The nested key structure of a stats payload (lists by their first
    element)."""
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    if isinstance(d, list) and d and isinstance(d[0], dict):
        return [_keys(d[0])]
    return None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# AotModel basics
# ---------------------------------------------------------------------------


def test_aot_bit_exact_and_cached(compiled, ref_compiled, io_chain):
    params, x = io_chain
    am = pb.compile_aot(compiled)
    assert am.verify(params, x) == 0.0
    _same(am.run(params, x), rb.compile_aot(ref_compiled).run(params, x))
    _same(am.run(params, x), compiled.run(params, x))
    e1 = am.warmup(params, x)
    e2 = am.warmup(params, x)
    assert e1 is e2  # same (params, signature) -> held entry reused
    assert e1.trace_us > 0.0 and e1.compile_us is None  # nothing is captured on the CPU
    # a different input signature warms up a second entry
    xi = {"x": x["x"].astype(np.int8)}
    e3 = am.warmup(params, xi)
    assert e3 is not e1
    # so does a different params dict (params are baked)
    assert am.warmup({}, x) is not e1


def test_aot_rejects_bad_memory_mode(compiled):
    with pytest.raises(ValueError):
        pb.AotModel(compiled, memory="paged")


def test_to_aot_caches_and_feeds_report_dict(io_chain):
    params, x = io_chain
    cm = _lowered(pc, pb, device="cpu")
    assert "aot" not in cm.report_dict()
    am = cm.to_aot()
    assert cm.to_aot() is am
    am.warmup(params, x)
    d = json.loads(json.dumps(cm.report_dict()))
    assert d["aot"]["segments"] == len(cm.segments)
    assert d["aot"]["mode"] == "xla"
    # rebuild with explicit kwargs replaces the cached model
    am2 = cm.to_aot(memory="arena")
    assert am2 is not am and am2.memory == "arena"


@pytest.mark.parametrize("memory", ["xla", "arena"])
def test_stats_keep_the_reference_keys(io_chain, memory):
    """Every key of the reference's ``stats()``, with measured dispatch
    overhead; what has no card counterpart holds None."""
    params, x = io_chain
    am = pb.compile_aot(_lowered(pc, pb, device="cpu"), memory=memory)
    ref = rb.compile_aot(_lowered(rc, rb), memory=memory)
    for m in (am, ref):
        m.warmup(params, x)
        m.measure_dispatch_overhead(params, x, repeats=2)
    got, want = json.loads(json.dumps(am.stats())), ref.stats()
    want["entries"][0]["executable"] = None  # XLA's stats: no CUDA-graph counterpart
    assert _keys(got) == _keys(want)
    assert got["entries"][0]["executable"] is None and got["entries"][0]["donation_honored"] is None
    assert got["donation"].get("inputs_donated", got["donation"].get("arena_donation_honored")) is None
    for k in ("mode", "segments", "staging", "plan_aliasing"):
        assert got[k] == want[k], k
    for k in ("plan_bytes", "covered_bytes", "coverage", "fallback_buffers"):
        assert got["donation"][k] == want["donation"][k], k
    assert got["dispatch_overhead"]["segments"] == len(am.compiled.segments)
    assert got["dispatch_overhead"]["per_segment_path_us"] > 0 and got["dispatch_overhead"]["aot_us"] > 0


def test_aot_arena_mode_survives_repeated_runs(compiled, ref_compiled, io_chain):
    params, x = io_chain
    am = pb.compile_aot(compiled, memory="arena")
    ref = rb.compile_aot(ref_compiled, memory="arena")
    r1 = am.run(params, x)
    r2 = am.run(params, x)
    _same(r1, r2)
    for i in range(3):
        xi = {"x": x["x"] * (i - 1.5)}
        _same(am.run(params, xi), ref.run(params, xi))
    s = am.stats()
    assert s["mode"] == "arena"
    assert s["donation"]["coverage"] > 0.0
    assert s["entries"][0]["calls"] == 5


def test_outputs_are_copies_a_later_run_cannot_overwrite(compiled, io_chain):
    params, x = io_chain
    am = pb.compile_aot(compiled, memory="arena")
    first = am.run(params, x)
    kept = {k: v.clone() for k, v in first.items()}
    am.run(params, {"x": -x["x"]})
    _same(first, kept)


def test_aot_preserves_integer_input_dtypes():
    """An int8 input stays int8 through the signature and the output, as
    in ``tests/conformance/test_aot.py``'s int8 chain."""
    cm = pb.lower(pc.dispatch(relu_chain(pc, n=3, width=8, name="int8_chain"), "gap9", budget=BUDGET), device="cpu")
    am = pb.compile_aot(cm, memory="arena")
    xi = {"x": np.arange(-4, 4, dtype=np.int8).reshape(1, 8)}
    entry = am.warmup({}, xi)
    assert {name: dt for name, _, dt in entry.signature} == {"x": "int8"}
    out, ref = am.run({}, xi), cm.run({}, xi)
    for k in ref:
        assert out[k].dtype == ref[k].dtype == torch.int8
        assert torch.equal(out[k], ref[k])


@pytest.mark.parametrize("memory", ["xla", "arena"])
def test_aot_run_makes_no_host_sync(memory):
    """A DS-CNN x gap9 run (banded convs, the GEMM head, the arena's
    stores and loads) makes no call that would break the card's capture."""
    cm = pb.lower(port_mapped("DSCNN", "gap9"), device="cpu")
    params, x = io("DSCNN")
    am = pb.compile_aot(cm, memory=memory)
    entry = am.warmup(params, x)
    with NoHostSync():
        out = entry.run_fn()
    _same({k: v.clone() for k, v in out.items()}, cm.run(params, x))


# ---------------------------------------------------------------------------
# Lane chaining
# ---------------------------------------------------------------------------


class _FakeSeg:
    def __init__(self, name, inputs):
        self.output_name = name
        self.input_names = tuple(inputs)

    def params_slice(self, params):
        return {}

    def fn(self, seg_params, *xs):
        return sum(xs)


def test_build_chains_groups_dependency_closed_runs():
    # lane: a<-x, b<-a, c<-(b, other), d<-c   with "other" from another lane
    a, b = _FakeSeg("a", ["x"]), _FakeSeg("b", ["a"])
    c, d = _FakeSeg("c", ["b", "other"]), _FakeSeg("d", ["c"])
    chains = pb.build_chains([a, b, c, d], graph_inputs=["x"])
    assert [[s.output_name for s in ch] for ch in chains] == [["a", "b"], ["c", "d"]]
    ref = rb.build_chains([a, b, c, d], graph_inputs=["x"])
    assert [[s.output_name for s in ch] for ch in chains] == [[s.output_name for s in ch] for ch in ref]


def test_build_chains_all_graph_inputs_single_chain():
    segs = [_FakeSeg(f"s{i}", ["x"]) for i in range(3)]
    chains = pb.build_chains(segs, graph_inputs=["x"])
    assert len(chains) == 1 and len(chains[0]) == 3


@pytest.mark.parametrize("net", ["DSCNN", "ResNet", "DAE"])
def test_build_chains_match_reference_on_module_lanes(net):
    """Each execution module's lane of a diana mapping (digital and analog
    accelerators, a CPU fallback) groups into the reference's chains."""
    cm = pb.lower(port_mapped(net, "diana"), device="cpu")
    ref = rb.lower(ref_mapped(net, "diana"))
    modules = {ls.module for ls in cm.segments}
    assert modules == {ls.module for ls in ref.segments}
    for module in modules:
        got = pb.build_chains([ls for ls in cm.segments if ls.module == module], cm.graph.inputs)
        want = rb.build_chains([ls for ls in ref.segments if ls.module == module], ref.graph.inputs)
        assert [[ls.output_name for ls in ch] for ch in got] == [[ls.output_name for ls in ch] for ch in want]


def test_chain_executor_bit_exact(compiled, io_chain):
    params, x = io_chain
    lane = list(compiled.segments)
    chains = pb.build_chains(lane, compiled.graph.inputs)
    assert len(chains) == 1  # a pure chain collapses fully
    ce = pb.make_chain_executor(chains[0], params)
    assert ce.ext_inputs == ("x",)
    assert ce.output_names == tuple(ls.output_name for ls in lane)
    outs = ce.fn(torch.from_numpy(x["x"]))
    assert len(outs) == len(lane)
    ref = compiled.run(params, x)
    assert torch.equal(outs[-1], list(ref.values())[0])


def test_chain_executor_on_a_gemm_lane():
    """DAE x gap9: every segment a GEMM; numpy params converted once."""
    cm = pb.lower(port_mapped("DAE", "gap9"), device="cpu")
    params, x = io("DAE")
    chains = pb.build_chains(list(cm.segments), cm.graph.inputs)
    env = {k: torch.from_numpy(v) for k, v in x.items()}
    for ch in chains:
        ce = pb.make_chain_executor(ch, params)
        for name, out in zip(ce.output_names, ce.fn(*[env[n] for n in ce.ext_inputs])):
            env[name] = out
    _same({o: env[o] for o in cm.graph.outputs}, cm.run(params, x))


# ---------------------------------------------------------------------------
# MemoryPlan.arena_view invariants, and the arena against the reference's
# ---------------------------------------------------------------------------


def test_arena_view_scaling_invariants(compiled):
    plan = compiled.memory_plan
    view = plan.arena_view()
    assert view.length_elems == plan.arena_bytes[view.home_level]
    for name, off in view.offsets.items():
        cap = view.capacities_elems[name]
        assert off >= 0 and cap > 0
        assert off + cap <= view.length_elems  # inside the arena
        assert off == plan.buffers[name].offset
        assert cap == plan.buffers[name].nbytes


def test_aliasing_summary_consistent(compiled, ref_compiled):
    s = compiled.memory_plan.aliasing_summary()
    assert s["sum_buffer_bytes"] >= s["arena_peak_bytes"] > 0
    assert s["bytes_saved_by_aliasing"] == s["sum_buffer_bytes"] - s["arena_peak_bytes"]
    assert s["aliased_pairs"] >= 0
    assert s == ref_compiled.memory_plan.aliasing_summary()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("memory", ["xla", "arena"])
def test_aot_bit_exact_on_card(cuda, memory):
    """DS-CNN x gap9 captured: bit-exact with CompiledModel.run and the CPU
    interpreter over repeated runs; N runs add N x the GEMM segments'
    launches, the warm-up none."""
    cm = pb.lower(port_mapped("DSCNN", "gap9"), device=cuda)
    params, x = io("DSCNN")
    tparams = params_to_torch(params, cuda)
    am = pb.compile_aot(cm, memory=memory)
    before = _graphs.launch_counts()
    entry = am.warmup(params, x)
    assert _graphs.launch_counts() == before
    assert entry.graph is not None and entry.compile_us > 0
    gemms = cm.routes().get("pallas_gemm", 0)
    assert entry.graph.launches["matmul_requant"] == gemms > 0
    cpu = pb.lower(port_mapped("DSCNN", "gap9"), device="cpu")
    for i in range(3):
        xi = {k: np.clip(v + i, -128, 127) for k, v in x.items()}
        got = am.run(params, xi)
        torch.cuda.synchronize()
        _same({k: v.cpu() for k, v in got.items()}, {k: v.cpu() for k, v in cm.run(tparams, xi).items()})
        _same({k: v.cpu() for k, v in got.items()}, cpu.run(params, xi))
    assert _graphs.launch_counts()["matmul_requant"] - before["matmul_requant"] == 6 * gemms

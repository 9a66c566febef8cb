"""The port's main path on the CPU: lower(dispatch(...), device="cpu").run
is bit-exact with the JAX interpreter, with the reference's routes."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.backend
import repro_torch.backend as tb
from _torch_port import CELLS, io, port_compiled, port_mapped, ref_mapped, ref_outputs
from repro_torch.cnn import conv_block_graph
from repro_torch.core import MappedGraph, TemporalMapping, dispatch
from repro_torch.kernels import matmul_requant
from repro_torch.targets import TargetRegistryError, make_diana_target, make_gap9_target


@pytest.mark.parametrize("net,tgt", CELLS)
def test_run_bit_exact_with_reference_interpreter(net, tgt):
    cm = port_compiled(net, tgt)
    params, x = io(net)
    got = cm.run(params, x)
    for k, want in ref_outputs(net).items():
        assert got[k].device.type == "cpu"
        assert np.array_equal(got[k].numpy(), want), k


@pytest.mark.parametrize("net,tgt", CELLS)
def test_routes_match_reference_lowering(net, tgt):
    ref = repro.backend.lower(ref_mapped(net, tgt))
    cm = port_compiled(net, tgt)
    assert cm.routes() == ref.routes()
    assert [ls.route for ls in cm.segments] == [ls.route for ls in ref.segments]
    assert [ls.meta.get("block_oy") for ls in cm.segments] == [ls.meta.get("block_oy") for ls in ref.segments]


@pytest.mark.parametrize("net,tgt", CELLS)
def test_verify_per_segment_exact(net, tgt):
    cm = port_compiled(net, tgt)
    params, x = io(net)
    rep = cm.verify(params, x, per_segment=True)
    assert rep.exact, rep.summary()
    assert len(rep.segments) == len(cm.segments)
    assert cm.verify(params, x) == 0.0


@pytest.mark.parametrize("net,tgt", CELLS)
def test_timed_run_and_report_dict(net, tgt):
    cm = port_compiled(net, tgt)
    params, x = io(net)
    out = cm.run(params, x, timed=True)
    assert set(out) == set(cm.graph.outputs)
    assert [t.name for t in cm.last_timings] == [ls.name for ls in cm.segments]
    assert all(t.measured_us >= 0.0 for t in cm.last_timings)
    rd = json.loads(json.dumps(cm.report_dict()))
    ref_keys = set(repro.backend.lower(ref_mapped(net, tgt)).report_dict())
    # the reference's keys (``aot`` only once to_aot() has built one)
    assert set(rd) == (ref_keys - {"aot"}) | {"device", "measured_total_us", "timings"}
    assert rd["device"] == "cpu" and len(rd["timings"]) == len(cm.segments)
    assert rd["memory_plan"] == cm.memory_plan.to_dict()
    assert "meas us" in cm.report() and "predicted total" in cm.report()


@pytest.mark.parametrize("tgt", ["gap9", "diana"])
def test_gemm_segments_carry_dse_blocks(tgt):
    cm = port_compiled("DAE", tgt)
    gemm = [ls for ls in cm.segments if ls.route == "pallas_gemm"]
    assert len(gemm) == 10
    for ls in gemm:
        assert set(ls.meta["dse_block"]) == {"M", "N", "K"}
        assert all(v >= 1 for v in ls.meta["dse_block"].values())


def test_gemm_route_with_runtime_scale_evaluates_reference_chain():
    """Requant params carrying scale/addend are outside the GEMM epilogue:
    the segment evaluates its fused reference chain, still bit-exact."""
    import repro.cnn

    cm = port_compiled("DAE", "gap9")
    params, x = io("DAE")
    params = {k: dict(v) for k, v in params.items()}
    for ls in cm.segments:
        rq = next(n for n in ls.segment.nodes if n.op == "requant")
        params[rq.name].update(scale=np.float32(3.0), addend=np.float32(5.0))
    want = repro.cnn.execute_graph(cm.graph, params, x)
    got = cm.run(params, x)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


def test_int8_and_converted_inputs_pass_through():
    cm = port_compiled("DAE", "gap9")
    params, x = io("DAE")
    from repro_torch.cnn import params_to_torch

    converted = params_to_torch(params, "cpu")
    xi = {k: v.astype(np.int8) for k, v in x.items()}
    assert tb.as_input_array(xi["x"], torch.device("cpu")).dtype == torch.int8
    got = cm.run(converted, xi)
    for k, want in ref_outputs("DAE").items():
        assert np.array_equal(got[k].numpy(), want)


def test_cpu_run_launches_no_kernel():
    cm = port_compiled("DAE", "diana")
    params, x = io("DAE")
    before = matmul_requant.launches
    cm.run(params, x)
    assert matmul_requant.launches == before


def test_lower_rejects_mismatched_target():
    mapped = dispatch(conv_block_graph(IX=8, IY=8, C=8, K=8), make_gap9_target(), budget=300)
    with pytest.raises(tb.LoweringError):
        tb.lower(mapped, make_diana_target(), device="cpu")
    with pytest.raises(tb.LoweringError):
        tb.lower(mapped, "diana", device="cpu")
    with pytest.raises(TargetRegistryError):
        tb.lower(mapped, "no_such_target", device="cpu")
    assert tb.lower(mapped, "gap9", device="cpu").target is mapped.target


def test_lower_rejects_uncovered_and_fused_outputs():
    mapped = port_mapped("ResNet", "gap9")
    kept = mapped.segments[:-1]
    g_kept = dataclasses.replace(mapped.graph, outputs=(kept[-1].output_node.name,))
    partial = MappedGraph(g_kept, mapped.target, kept)
    with pytest.raises(tb.LoweringError, match="does not cover"):
        tb.lower(partial, device="cpu")
    inner = mapped.segments[0].nodes[0].name  # an anchor fused into its chain
    g = dataclasses.replace(mapped.graph, outputs=(inner,))
    with pytest.raises(tb.LoweringError, match="fused inside"):
        tb.lower(MappedGraph(g, mapped.target, mapped.segments), device="cpu")


def test_plan_spill_and_error_paths():
    g = conv_block_graph(IX=32, IY=32, C=64, K=64)
    mapped = dispatch(g, make_gap9_target(), budget=300)
    seg = next(s for s in mapped.segments if s.workload is not None)
    full = dict(seg.workload.dim_sizes)
    bad_sched = dataclasses.replace(
        seg.schedule, mapping=TemporalMapping(full, seg.schedule.mapping.outer_order)
    )
    bad_seg = dataclasses.replace(seg, schedule=bad_sched)
    broken = MappedGraph(mapped.graph, mapped.target, [bad_seg if s is seg else s for s in mapped.segments])
    plan = tb.plan_memory(broken)
    assert seg.anchor.name in plan.spills
    plan.validate()
    with pytest.raises(tb.MemoryPlanError):
        tb.plan_memory(broken, allow_spill=False)

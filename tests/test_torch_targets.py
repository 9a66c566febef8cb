"""The port's targets against the reference's (``repro.targets``).

The registry lists the reference's names, the TPU v5e copy included, and
the copy dispatches DAE and DS-CNN to the reference's segments, modules
and cycles at ``budget=300``.  The card's own target (``h100``) enters the
registry only on an explicit ``register_h100_target()`` call; dispatch on
it gives contiguous covers and feasible LOMA schedules for the four
MLPerf-Tiny nets, every CNN anchor on the CUDA-core module or the aten
fallback, and lowering that mapping is bit-exact with the reference
interpreter.  A timed run measures in the card's clock (ROADMAP C-port-2).
"""

import dataclasses
import math
from functools import lru_cache

import numpy as np
import pytest

import repro.targets as rt
import repro.targets.tpu_v5e as rt_v5e
import repro_torch.targets as pt
from _torch_port import BUDGET, NETS, io, one_torch_thread, port_graph, port_mapped, ref_mapped, ref_outputs, segment_rows  # noqa: F401 (one_torch_thread: a fixture)
from repro_torch.backend import lower
from repro_torch.core import dispatch
from repro_torch.core.cost_model import tile_working_set
from repro_torch.targets import h100 as pt_h100
from repro_torch.targets import tpu_v5e as pt_v5e


def test_list_targets_equals_the_reference():
    assert pt.list_targets() == rt.list_targets()
    assert pt.target_info("v5e")["name"] == rt.target_info("v5e")["name"] == "tpu_v5e"


def test_tpu_v5e_copy_declares_the_reference_hardware():
    assert dataclasses.asdict(pt_v5e.V5E) == dataclasses.asdict(rt_v5e.V5E)
    mine, ref = pt.get_target("tpu_v5e"), rt.get_target("tpu_v5e")
    assert [m.name for m in mine.all_modules()] == [m.name for m in ref.all_modules()]
    for a, b in zip(mine.all_modules(), ref.all_modules()):
        assert a.supported_ops == b.supported_ops
        assert a.frequency_hz == b.frequency_hz and a.handoff_cycles == b.handoff_cycles
        assert [(m.name, m.size_bytes, m.bandwidth) for m in a.memories] == [
            (m.name, m.size_bytes, m.bandwidth) for m in b.memories
        ]
    assert pt_v5e.PodSpec().all_reduce_s(1e6, 4) == rt_v5e.PodSpec().all_reduce_s(1e6, 4)


@pytest.mark.parametrize("net", ["DAE", "DSCNN"])
def test_tpu_v5e_copy_dispatches_as_the_reference(net):
    assert segment_rows(port_mapped(net, "tpu_v5e")) == segment_rows(ref_mapped(net, "tpu_v5e"))


def test_h100_enters_the_registry_only_when_asked():
    assert "h100" not in pt.list_targets()  # importing the module registered nothing
    pt.register_h100_target()
    try:
        pt.register_h100_target()  # idempotent
        assert "h100" in pt.list_targets()
        g = port_graph("DAE")
        cm = lower(dispatch(g, "h100", budget=BUDGET), "h100", device="cpu")
        assert cm.target.name == "h100"
        assert cm.routes() == {"pallas_gemm": 10}  # every DAE dense takes the int8 GEMM
    finally:
        pt.unregister_target("h100")
    assert "h100" not in pt.list_targets()


def test_h100_constants_are_the_data_sheet_s():
    spec = pt_h100.H100
    assert (spec.sms, spec.smem_per_block, spec.l2_bytes) == (132, 232_448, 50 * 1024**2)
    assert spec.hbm_bytes_per_s == 3.35e12 and spec.hbm_capacity == 80 * 1024**3
    # the FP32 peak is the CUDA-core lanes at the declared clock
    lanes_peak = spec.sms * spec.fp32_lanes_per_sm * 2 * spec.clock_hz
    assert lanes_peak == pytest.approx(spec.peak_flops_fp32, rel=2e-3)
    assert spec.launch_floor_cycles == pytest.approx(0.98e-6 * 1.98e9)
    t = pt_h100.make_h100_target()
    assert [m.name for m in t.modules] == ["cuda_core", "tensor_core"] and t.fallback.name == "aten"
    for m in t.all_modules():
        assert m.frequency_hz == spec.clock_hz
        assert m.handoff_cycles == m.compute.fixed_overhead_cycles == spec.launch_floor_cycles
        assert m.memories[0].size_bytes == spec.smem_per_block
        assert m.memories[-1].name == "HBM"


@lru_cache(maxsize=None)
def h100_mapped(net: str):
    return dispatch(port_graph(net), pt_h100.make_h100_target(), budget=BUDGET)


@pytest.mark.parametrize("net", NETS)
def test_h100_covers_are_contiguous_and_schedules_feasible(net):
    mg = h100_mapped(net)
    t = mg.target
    # every node once, each segment a contiguous run of the topological order
    assert [n.name for s in mg.segments for n in s.nodes] == [n.name for n in mg.graph.nodes]
    for s in mg.segments:
        assert s.module in ("cuda_core", "aten")  # no CNN op on the tensor cores
        if s.module == "cuda_core":
            assert s.anchor.op in ("conv2d", "dwconv2d", "dense")
        if s.schedule is None:
            continue
        assert s.schedule.cost.feasible and math.isfinite(s.cycles)
        assert s.cycles >= t.module(s.module).compute.fixed_overhead_cycles  # a launch at least
        module = t.module(s.module)
        usage = tile_working_set(s.workload, s.schedule.mapping.tiles, module)
        for lvl in module.memories[:-1]:
            assert usage[lvl.name] <= lvl.size_bytes
    assert mg.total_cycles() > 0.0


@pytest.mark.parametrize("net", NETS)
def test_h100_lowering_bit_exact_with_the_reference_interpreter(net):
    cm = lower(h100_mapped(net), device="cpu")
    params, x = io(net)
    got = cm.run(params, x)
    want = ref_outputs(net)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k]), k


@pytest.mark.parametrize("net", ["MobileNet", "DSCNN"])
def test_h100_l1_holds_every_cuda_core_conv_band_whole(net):
    """The 227 KB SMEM holds each of these convs' whole output height in
    one tile, so each is one cuDNN call per request, as on gap9's 128 kB."""
    cm = lower(h100_mapped(net), device="cpu")
    convs = [ls for ls in cm.segments if ls.route == "tiled_conv" and ls.module == "cuda_core"]
    assert convs
    for ls in convs:
        assert ls.meta["block_oy"] == int(ls.segment.anchor.attr("OY"))


def test_timed_run_on_h100_measures_in_the_card_clock():
    """Predicted and measured cycles share the target's 1.98 GHz clock
    (on the CPU the measured side is the host clock)."""
    cm = lower(h100_mapped("DAE"), device="cpu")
    params, x = io("DAE")
    cm.run(params, x, timed=True)
    assert cm.last_timings
    for tm in cm.last_timings:
        assert tm.frequency_hz == pt_h100.H100.clock_hz
        assert tm.measured_cycles == pytest.approx(tm.measured_us * 1e-6 * pt_h100.H100.clock_hz)

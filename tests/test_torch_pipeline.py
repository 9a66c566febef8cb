"""The port's ``PipelinedModel`` (``repro_torch.pipeline.runtime``) on the
CPU, against the reference's (``repro.pipeline.runtime``).

Ports of ``tests/test_pipeline_unit.py``'s runtime cases (depth bounds,
a foreign schedule, error propagation) and of
``tests/conformance/test_pipeline.py``'s runtime contract: ``run`` and
``run_stream``, with ``aot`` off and on, bit-exact with the port's
``CompiledModel.run``, with the reference interpreter and with the
reference ``PipelinedModel`` on the same numpy inputs.  Then the
schedule-side hooks of ``CompiledModel`` (``pipeline_schedule``,
``predicted_makespan``, ``serve_dict``, ``report_dict()["pipeline"]``)
against the reference at rel 1e-12, never ``==`` (ROADMAP C-ref-2), and
the ``pipeline:<module>`` trace spans.
"""

from functools import lru_cache

import numpy as np
import pytest

import repro.backend as rb
import repro.core as rc
import repro.pipeline as rp
import repro.targets as rt
import repro_torch.core as pc
import repro_torch.targets as pt
from _torch_port import BUDGET, CELLS, NETS, io, one_torch_thread, port_compiled, port_graph, ref_graph, ref_mapped, ref_outputs  # noqa: F401 (one_torch_thread: a fixture)
from repro_torch import obs
from repro_torch.pipeline import PipelinedModel, schedule_pipeline


@lru_cache(maxsize=None)
def ref_compiled(net: str, tgt: str):
    return rb.lower(ref_mapped(net, tgt))


def stream_inputs(net: str, n: int = 3) -> list[dict]:
    _, x = io(net)
    rng = np.random.default_rng(7)
    return [{k: rng.integers(-128, 128, v.shape).astype("float32") for k, v in x.items()} for _ in range(n)]


def _same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def close(a, b, rel: float = 1e-12) -> bool:
    """Nested payloads equal key for key, floats within ``rel``."""
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(close(a[k], b[k], rel) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(close(x, y, rel) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return a == pytest.approx(b, rel=rel, abs=0.0)
    return a == b


# ---------------------------------------------------------------------------
# Constructor checks and error propagation (tests/test_pipeline_unit.py)
# ---------------------------------------------------------------------------


def test_pipelined_model_rejects_bad_depth():
    with pytest.raises(ValueError, match="stream_depth"):
        PipelinedModel(port_compiled("DSCNN", "gap9"), stream_depth=0)


def test_run_stream_depth_bounded_by_memory_plan():
    cm = port_compiled("DSCNN", "gap9")
    params, x = io("DSCNN")
    pm = PipelinedModel(cm, stream_depth=2)
    with pytest.raises(ValueError, match="stream_depth"):
        pm.run_stream(params, [x, x], depth=5)  # plan reserved 2 copies
    with pytest.raises(ValueError, match="depth"):
        pm.run_stream(params, [x], depth=0)
    assert len(pm.run_stream(params, [x, x, x], depth=1)) == 3
    assert pm.streaming_plan().attrs["pipeline"] is True
    assert pm.run_stream(params, []) == []


def test_pipelined_model_rejects_foreign_schedule():
    foreign = schedule_pipeline(port_compiled("DAE", "gap9").mapped)
    with pytest.raises(ValueError, match="does not match"):
        PipelinedModel(port_compiled("DSCNN", "gap9"), foreign)


@pytest.mark.parametrize("aot", [False, True])
def test_pipelined_model_propagates_segment_errors(aot):
    cm = port_compiled("DSCNN", "gap9")
    params, x = io("DSCNN")
    broken = cm.segments[0]
    orig_fn = broken.fn

    def explode(p, *xs):
        raise RuntimeError("kernel exploded")

    broken.fn = explode
    try:
        pm = PipelinedModel(cm, aot=aot)
        with pytest.raises(RuntimeError, match="kernel exploded"):
            pm.run(params, x)
        with pytest.raises(RuntimeError, match="kernel exploded"):
            pm.run_stream(params, [x, x])
    finally:
        broken.fn = orig_fn


# ---------------------------------------------------------------------------
# Bit-exactness (tests/conformance/test_pipeline.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aot", [False, True], ids=["segments", "chains"])
@pytest.mark.parametrize("net,tgt", CELLS)
def test_pipelined_run_and_stream_bit_exact(net, tgt, aot):
    cm = port_compiled(net, tgt)
    params, x = io(net)
    pm = PipelinedModel(cm, stream_depth=2, aot=aot)
    _same({k: v.numpy() for k, v in pm.run(params, x).items()}, ref_outputs(net))
    assert pm.verify(params, x) == 0.0
    xs = stream_inputs(net)
    outs = pm.run_stream(params, xs)
    assert len(outs) == len(xs)
    for xi, out in zip(xs, outs):
        _same(out, cm.run(params, xi))


@pytest.mark.parametrize("aot", [False, True], ids=["segments", "chains"])
@pytest.mark.parametrize("net,tgt", [("DSCNN", "gap9"), ("ResNet", "diana"), ("DAE", "ne16_octa")])
def test_pipelined_runs_equal_the_reference_pipelined_model(net, tgt, aot):
    params, x = io(net)
    xs = stream_inputs(net)
    mine = PipelinedModel(port_compiled(net, tgt), stream_depth=2, aot=aot)
    ref = rp.PipelinedModel(ref_compiled(net, tgt), stream_depth=2, aot=aot)
    _same(mine.run(params, x), ref.run(params, x))
    for a, b in zip(mine.run_stream(params, xs), ref.run_stream(params, xs)):
        _same(a, b)
    assert mine.predicted_makespan() == pytest.approx(ref.predicted_makespan(), rel=1e-12)
    assert mine.predicted_speedup() == pytest.approx(ref.predicted_speedup(), rel=1e-12)
    assert mine.memory_plan.to_dict() == ref.memory_plan.to_dict()


def test_chains_are_reused_per_params_and_signature():
    cm = port_compiled("DSCNN", "gap9")
    params, x = io("DSCNN")
    pm = PipelinedModel(cm, aot=True)
    pm.run(params, x)
    pm.run_stream(params, stream_inputs("DSCNN"))
    assert len(pm._chain_cache) == 1
    pm.run(dict(params), x)  # another params dict: its own chains
    assert len(pm._chain_cache) == 2


def test_report_is_the_gantt_and_the_plan():
    pm = PipelinedModel(port_compiled("ResNet", "gap9"))
    rep = pm.report()
    assert pm.schedule.gantt() in rep and pm.memory_plan.report() in rep


def test_pipeline_spans_land_on_module_lanes():
    cm = port_compiled("DSCNN", "gap9")
    params, x = io("DSCNN")
    pm = PipelinedModel(cm)
    tr = obs.get_tracer()
    was = tr.enabled
    tr.enabled = True
    tr.clear()
    try:
        pm.run_stream(params, [x, x])
        names = {e["name"] for e in tr.chrome_trace()["traceEvents"] if e.get("ph") == "X"}
        lanes = {e["args"]["name"] for e in tr.chrome_trace()["traceEvents"] if e.get("ph") == "M"}
    finally:
        tr.enabled = was
        tr.clear()
    for ls in cm.segments:
        assert f"{ls.output_name}@0" in names and f"{ls.output_name}@1" in names
    assert {f"pipeline:{m}" for m in pm.schedule.lanes()} <= lanes


# ---------------------------------------------------------------------------
# CompiledModel's pipeline and serve hooks against the reference
# ---------------------------------------------------------------------------

HOOK_CELLS = CELLS + [(n, "tpu_v5e") for n in NETS]


@pytest.mark.parametrize("net,tgt", HOOK_CELLS)
def test_timeline_and_serve_dict_match_the_reference(net, tgt):
    mine = port_compiled(net, tgt)
    ref = ref_compiled(net, tgt)
    assert close(mine.pipeline_schedule().timeline_dict(), ref.pipeline_schedule().timeline_dict())
    assert mine.predicted_makespan() == pytest.approx(ref.predicted_makespan(), rel=1e-12)
    assert close(mine.serve_dict(), ref.serve_dict())
    assert close(mine.serve_dict(stream_requests=7), ref.serve_dict(stream_requests=7))


def test_report_dict_has_the_reference_keys_plus_device():
    mine, ref = port_compiled("DSCNN", "gap9"), ref_compiled("DSCNN", "gap9")
    a, b = mine.report_dict(), ref.report_dict()
    assert set(a) == set(b) | {"device"}
    assert set(a["pipeline"]) == set(b["pipeline"]) and set(a["serve"]) == set(b["serve"])
    assert close(a["pipeline"], b["pipeline"])


@pytest.mark.parametrize("net", NETS)
def test_makespan_equals_total_on_single_module_cover(net):
    """The CPU-only restriction serialises the schedule: the makespan
    reproduces total_cycles(), within rel 1e-12 (the reference compares
    with ``==`` and fails by 2.1e-6 cycles on MobileNet x tpu_v5e)."""
    for tname in ("gap9", "tpu_v5e"):
        solo = pt.get_target(tname).restricted([])
        mg = pc.dispatch(port_graph(net), solo, budget=BUDGET)
        assert len({s.module for s in mg.segments}) == 1
        ps = schedule_pipeline(mg)
        assert ps.makespan == pytest.approx(mg.total_cycles(), rel=1e-12)
        ref_mg = rc.dispatch(ref_graph(net), rt.get_target(tname).restricted([]), budget=BUDGET)
        assert ps.makespan == pytest.approx(rp.schedule_pipeline(ref_mg).makespan, rel=1e-12)

"""The port's spans and counters of the request path, the segments and
the compile (``repro_torch.obs.trace``), on the CPU: the four phase spans
of ``AotModel.run`` inside ``aot.run:<graph>``, nothing recorded with the
tracer off, the ``node:<op>`` spans inside each segment span of
``CompiledModel.run`` (one, the anchor's, for a fused conv segment), the
``dse.candidates`` counter and the
``dispatch.dse_flush`` span's ``candidates``, and the tracer's epoch on
``perf_counter``, which ties its spans to a device trace.
"""

import time

import numpy as np
import pytest

import repro_torch.backend as pb
import repro_torch.core as pc
from repro_torch import obs
from repro_torch.cnn import init_graph_params
from repro_torch.cnn.nets import conv_block_graph
from repro_torch.obs.trace import _NULL_SPAN

PHASES = ("aot.prepare", "aot.input_copy", "aot.replay", "aot.output_clone")


@pytest.fixture(scope="module")
def net():
    """A conv block (conv2d, bias_add, requant), lowered for the CPU."""
    g = conv_block_graph(IX=8, IY=8, C=4, K=8)
    cm = pb.lower(pc.dispatch(g, "gap9", budget=300), device="cpu")
    params = init_graph_params(g, seed=0)
    x = np.random.default_rng(0).integers(-128, 128, size=(1, 8, 8, 4)).astype("float32")
    return cm, params, {"x": x}


@pytest.fixture(scope="module")
def banded():
    """The same block with a requant that carries a folded ``scale`` attr,
    which the fused conv kernel does not model: its conv segment keeps the
    banded executor and its chain."""
    g = conv_block_graph(IX=8, IY=8, C=4, K=8)
    nodes = [pc.Node(n.name, n.op, n.inputs, {**n.attrs, "scale": 1.0}) if n.op == "requant" else n for n in g.nodes]
    g = pc.Graph(g.name, nodes, g.inputs, g.outputs)
    cm = pb.lower(pc.dispatch(g, "gap9", budget=300), device="cpu")
    return cm, init_graph_params(g, seed=0)


@pytest.fixture
def tracer():
    """The process tracer, on and empty; off and empty again afterwards."""
    tr = obs.get_tracer()
    was = tr.enabled
    tr.clear()
    obs.enable_tracing()
    try:
        yield tr
    finally:
        tr.enabled = was
        tr.clear()


def _spans(tr) -> list[dict]:
    lanes = {e["tid"]: e["args"]["name"] for e in tr.chrome_trace()["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    return [dict(e, lane=lanes.get(e["tid"])) for e in tr.chrome_trace()["traceEvents"] if e["ph"] == "X"]


def _inside(inner: dict, outer: dict) -> bool:
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_aot_run_writes_the_four_phases_in_order_inside_its_span(net, tracer):
    cm, params, inputs = net
    am = pb.compile_aot(cm)
    am.warmup(params, inputs)
    tracer.clear()
    got = am.run(params, inputs)
    spans = [s for s in _spans(tracer) if s["lane"] == "run:aot"]
    parent = [s for s in spans if s["name"] == f"aot.run:{cm.graph.name}"]
    assert len(parent) == 1 and parent[0]["args"] == {"memory": "xla"}
    phases = sorted((s for s in spans if s["name"] in PHASES), key=lambda s: s["ts"])
    assert [s["name"] for s in phases] == list(PHASES)
    for s in phases:
        assert _inside(s, parent[0]), s
    for a, b in zip(phases, phases[1:]):
        assert a["ts"] + a["dur"] <= b["ts"] + 1e-6
    # the traced path does the untraced one's work: outputs bit for bit
    obs.disable_tracing()
    want = am.run(params, inputs)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k].numpy()), k
    assert am._entries and next(iter(am._entries.values())).calls == 2


def test_untraced_run_records_nothing_and_hands_out_the_null_span(net):
    cm, params, inputs = net
    tr = obs.get_tracer()
    assert not tr.enabled
    tr.clear()
    am = pb.compile_aot(cm)
    am.run(params, inputs)
    cm.run(params, inputs)
    assert len(tr) == 0
    assert tr.span("x") is _NULL_SPAN and obs.span("y") is _NULL_SPAN


def test_requests_no_longer_bump_a_cache_hit_counter(net):
    cm, params, inputs = net
    counters = obs.metrics_dict()["counters"]
    hits, misses = counters.get("aot.cache_hits", 0), counters.get("aot.cache_misses", 0)
    am = pb.compile_aot(cm)
    for _ in range(3):
        am.run(params, inputs)
    counters = obs.metrics_dict()["counters"]
    assert counters.get("aot.cache_hits", 0) == hits
    assert counters["aot.cache_misses"] == misses + 1
    assert next(iter(am._entries.values())).calls == 3


def test_segments_write_node_spans_inside_their_span(net, banded, tracer):
    _, _, inputs = net
    for (cm, params), kernel in (((net[0], net[1]), "conv_requant"), (banded, "banded")):
        tracer.clear()
        cm.run(params, inputs)
        spans = _spans(tracer)
        segs = [s for s in spans if s["args"].get("route") is not None]
        assert [s["name"] for s in segs] == [ls.name for ls in cm.segments]
        for ls, seg in zip(cm.segments, segs):
            nodes = sorted((s for s in spans if s["name"].startswith("node:") and _inside(s, seg)
                            and s["lane"] == seg["lane"]), key=lambda s: s["ts"])
            # a fused conv segment is one launch: one span, the anchor's; any
            # other segment writes one span per node
            fused = ls.meta.get("kernel") == "conv_requant"
            want = [(f"node:{nd.op}", nd.name) for nd in (ls.segment.nodes[:1] if fused else ls.segment.nodes)]
            assert [(s["name"], s["args"]["name"]) for s in nodes] == want, ls.name
        conv = next(ls for ls in cm.segments if ls.route == "tiled_conv")
        assert [nd.op for nd in conv.segment.nodes][:3] == ["conv2d", "bias_add", "requant"]
        assert conv.meta["kernel"] == kernel


def test_dispatch_counts_the_dse_candidates(tracer):
    g = conv_block_graph(IX=8, IY=8, C=4, K=16)
    pc.clear_schedule_cache()
    planner = pc.SchedulePlanner()
    before = obs.counter("dse.candidates").value
    pc.dispatch(g, "gap9", budget=300, planner=planner)
    added = obs.counter("dse.candidates").value - before
    evaluated = sum(r.candidates_evaluated for r in planner._results.values())
    assert planner.stats["searched"] == len(planner._results) > 0
    assert added == evaluated > 0
    (flush,) = [s for s in _spans(tracer) if s["name"] == "dispatch.dse_flush"]
    assert flush["args"]["candidates"] == evaluated
    # a second dispatch on the same planner searches nothing and counts nothing
    pc.dispatch(g, "gap9", budget=300, planner=planner)
    assert obs.counter("dse.candidates").value - before == evaluated


def test_the_epoch_maps_a_span_onto_perf_counter(tracer):
    a = time.perf_counter()
    t0 = tracer.now_us()
    b = time.perf_counter()
    tracer.complete("probe", t0, end_us=t0 + 5.0)
    (probe,) = [s for s in _spans(tracer) if s["name"] == "probe"]
    start = tracer.epoch_s + probe["ts"] * 1e-6
    assert a - 1e-6 <= start <= b + 1e-6
    assert probe["dur"] == pytest.approx(5.0)

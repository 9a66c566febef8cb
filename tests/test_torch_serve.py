"""The port's request server (``repro_torch.serve``) on the CPU, against
the reference's (``repro.serve``): a port of ``tests/test_serve.py``.

Batch packing folds the request slots into the batch axis, so every op of
the segment executors must treat axis 0 as independent rows: one case per
op kind of ``apply_node``, the banded conv and the int8 GEMM route.  Then
``BatchedModel.run_batch`` rows at B in {1, 3, 16} against the reference
``BatchedModel`` (vmapped) on the same numpy inputs, one captured entry
per batch shape, the server bit-exact in both modes, ``stats()`` and
``report_dict()["serve"]`` with the reference's keys, the admission queue
against the reference queue on the same request sequence, priority jumps,
shedding, and a stress test of concurrent submitters.
"""

import json
import sys
import threading
from functools import lru_cache

import numpy as np
import pytest
import torch

import repro.backend as rb
import repro.serve as rs
from _torch_port import io, one_torch_thread, port_compiled, port_mapped, ref_mapped  # noqa: F401 (one_torch_thread: a fixture)
from repro_torch.backend import lower
from repro_torch.cnn import params_to_torch
from repro_torch.cnn.execute import apply_node
from repro_torch.core import Node
from repro_torch.kernels.tiled_conv import tiled_conv2d
from repro_torch.serve import (
    AdmissionQueue,
    BatchedModel,
    DeadlineExceededError,
    ModelServer,
    QueueFullError,
    ServeRequest,
)
from repro_torch.serve.batching import _folded


def requests(net: str, n: int = 16) -> list[dict]:
    _, x = io(net)
    rng = np.random.default_rng(7)
    return [{k: rng.integers(-128, 128, v.shape).astype("float32") for k, v in x.items()} for _ in range(n)]


@lru_cache(maxsize=None)
def ref_batched(net: str, tgt: str):
    return rs.BatchedModel(rb.lower(ref_mapped(net, tgt), use_pallas=False, band_tiling=False))


def fresh_compiled(net: str):
    """A compiled model of its own: a replica stamps its stats into it."""
    return lower(port_mapped(net, "gap9"), device="cpu")


def _same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def _keys(d):
    """The nested key structure of a stats payload."""
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    if isinstance(d, list) and d and isinstance(d[0], dict):
        return [_keys(d[0])]
    return None


# ---------------------------------------------------------------------------
# The fold: every op treats axis 0 as independent rows
# ---------------------------------------------------------------------------


def _ints(rng, shape, lo=-128, hi=128):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.float32))


def _op_case(kind: str, rng):
    """(fn(p, *xs), p, per-row operand shapes) for one op kind."""
    def node(op, n_in=1, **attrs):
        return Node(kind, op, tuple(f"x{i}" for i in range(n_in)), attrs)

    def via(n):
        return lambda p, *xs: apply_node(n, p, list(xs))

    img = (1, 6, 5, 4)
    if kind == "conv2d":
        return via(node("conv2d", stride=2)), {"w": _ints(rng, (3, 3, 4, 3), -4, 5)}, [img]
    if kind == "dwconv2d":
        return via(node("dwconv2d", stride=1)), {"w": _ints(rng, (3, 3, 1, 4), -4, 5)}, [img]
    if kind == "dense":
        return via(node("dense")), {"w": _ints(rng, (7, 20), -4, 5)}, [(1, 1, 1, 20)]
    if kind == "bias_add":
        return via(node("bias_add")), {"b": _ints(rng, (4,), -16, 17)}, [img]
    if kind == "requant":
        return via(node("requant")), {"shift": 5.0}, [img]
    if kind == "requant_affine":
        return via(Node(kind, "requant", ("x0",), {})), {"shift": 3.0, "scale": 3.0, "addend": 7.0}, [img]
    if kind == "relu":
        return via(node("relu")), {}, [img]
    if kind == "add":
        return via(node("add", 3)), {}, [img, img, img]
    if kind == "add_constant":
        return via(node("add")), {"addend": 9.0}, [img]
    if kind == "avgpool":
        return via(node("avgpool")), {}, [img]
    if kind == "maxpool":
        return via(node("maxpool", FY=2, FX=2)), {}, [img]
    if kind in ("reshape", "identity"):
        return via(node(kind)), {}, [img]
    if kind == "mul":
        return via(node("mul", 2)), {}, [img, img]
    if kind == "mul_constant":
        return via(node("mul")), {"scale": 3.0}, [img]
    if kind == "concat":
        return via(node("concat", 2)), {}, [img, (1, 6, 5, 2)]
    if kind == "div":
        return via(node("div", 2)), {}, [img, img]
    if kind == "div_constant":
        return via(node("div")), {"divisor": 4.0}, [img]
    if kind == "rshift":
        return via(node("rshift")), {"shift": 2.0}, [img]
    if kind == "clip":
        return via(node("clip", clip_min=-20, clip_max=30)), {}, [img]
    if kind == "banded_conv":
        return (lambda p, x: tiled_conv2d(x, p["w"], stride=1, block_oy=2)), {"w": _ints(rng, (3, 3, 4, 5), -4, 5)}, [img]
    raise KeyError(kind)


OP_KINDS = [
    "conv2d", "dwconv2d", "dense", "bias_add", "requant", "requant_affine", "relu", "add", "add_constant",
    "avgpool", "maxpool", "reshape", "identity", "mul", "mul_constant", "concat", "div", "div_constant",
    "rshift", "clip", "banded_conv",
]


def _check_fold(fn, p, rows: list[tuple]) -> None:
    stacked = [torch.stack([r[j] for r in rows]) for j in range(len(rows[0]))]
    got = _folded(fn)(p, *stacked)
    want = torch.stack([fn(p, *r) for r in rows])
    assert got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", OP_KINDS)
def test_the_fold_is_row_independent_for_each_op_kind(kind):
    rng = np.random.default_rng(len(kind))
    fn, p, shapes = _op_case(kind, rng)
    rows = [tuple(_ints(rng, s, 1 if kind.startswith("div") else -128) for s in shapes) for _ in range(5)]
    _check_fold(fn, p, rows)


@pytest.mark.parametrize("net,tgt,route", [("DAE", "gap9", "pallas_gemm"), ("ResNet", "gap9", "tiled_conv")])
def test_the_fold_is_row_independent_for_lowered_routes(net, tgt, route):
    """The int8 GEMM route (the rows become the GEMM's M) and a conv
    lowered in several bands, as executors of a compiled model."""
    cm = port_compiled(net, tgt)
    params, _ = io(net)
    tparams = params_to_torch(params, "cpu")
    segs = [ls for ls in cm.segments if ls.route == route]
    if route == "tiled_conv":
        segs = [ls for ls in segs if ls.meta["block_oy"] < int(ls.segment.anchor.attr("OY"))]
    assert segs
    ls = segs[0]
    env = {k: torch.from_numpy(v) for k, v in requests(net, 1)[0].items()}
    for s in cm.segments[: ls.index]:  # the segment's real operand shapes
        env[s.output_name] = s.fn(s.params_slice(tparams), *[env[nm] for nm in s.input_names])
    rng = np.random.default_rng(3)
    rows = [tuple(_ints(rng, tuple(env[nm].shape)) for nm in ls.input_names) for _ in range(16)]
    _check_fold(ls.fn, ls.params_slice(tparams), rows)


# ---------------------------------------------------------------------------
# Batch packing against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 3, 16])
@pytest.mark.parametrize("net", ["DAE", "DSCNN"])
def test_run_batch_rows_bit_exact_with_the_reference(net, batch):
    cm = port_compiled(net, "gap9")
    params, _ = io(net)
    reqs = requests(net, batch)
    rows = BatchedModel(cm).run_batch(params, reqs)
    want = ref_batched(net, "gap9").run_batch(params, reqs)
    assert len(rows) == batch
    for i in range(batch):
        _same(rows[i], want[i])
        _same(rows[i], cm.run(params, reqs[i]))


def test_one_entry_per_batch_shape():
    cm = port_compiled("DSCNN", "gap9")
    params, _ = io("DSCNN")
    reqs = requests("DSCNN", 6)
    bm = BatchedModel(cm)
    bm.run_batch(params, reqs[:3])
    bm.run_batch(params, reqs[3:6])  # same shape: the same entry
    assert len(bm.entry_stats()) == 1
    bm.run_batch(params, reqs[:2])  # new batch size: new entry
    stats = bm.entry_stats()
    assert sorted(row["batch"] for row in stats) == [2, 3]
    for row in stats:
        assert row["trace_us"] > 0.0 and row["compile_us"] is None  # nothing captured on the CPU
    ref = ref_batched("DSCNN", "gap9")
    ref.run_batch(params, reqs[:2])
    assert set(stats[0]) == set(ref.entry_stats()[0])


def test_stack_takes_numpy_and_tensors_alike():
    bm = BatchedModel(port_compiled("DAE", "gap9"))
    reqs = requests("DAE", 3)
    a = bm.stack(reqs)
    b = bm.stack([{k: torch.from_numpy(v) for k, v in r.items()} for r in reqs])
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert a["x"].shape == (3, *reqs[0]["x"].shape)
    with pytest.raises(ValueError, match="empty"):
        bm.stack([])


# ---------------------------------------------------------------------------
# ModelServer end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["aot", "pipeline"])
def test_server_bit_exact_per_request_and_reports(mode):
    cm = fresh_compiled("DSCNN")
    params, _ = io("DSCNN")
    reqs = requests("DSCNN", 6)
    with ModelServer(cm, params, batch_slots=3, stream_depth=2, queue_capacity=16, mode=mode) as srv:
        srv.warmup(reqs[0])
        handles = [srv.submit(r, priority=float(i % 3)) for i, r in enumerate(reqs)]
        outs = [h.result(timeout=120) for h in handles]
    for i, out in enumerate(outs):
        _same(out, cm.run(params, reqs[i]))
    d = json.loads(json.dumps(cm.report_dict(), sort_keys=True))
    eng = d["serve"]["engine"]
    assert eng["mode"] == mode
    assert eng["submitted"] == eng["completed"] == len(reqs)
    assert eng["rejected"] == 0 and eng["shed"] == 0 and eng["drained"] is True
    assert eng["latency_us"]["count"] == len(reqs)
    assert eng["latency_us"]["p99"] >= eng["latency_us"]["p50"] > 0.0
    assert eng["latency_us"]["relative_accuracy"] == 0.01
    assert eng["last_round"]["weighted_completion_cycles"] > 0.0


def test_stats_and_report_keep_the_reference_keys():
    params, _ = io("DAE")
    reqs = requests("DAE", 2)
    ref_cm = rb.lower(ref_mapped("DAE", "gap9"), use_pallas=False, band_tiling=False)
    with rs.ModelServer(ref_cm, params, batch_slots=2) as ref_srv:
        [h.result(timeout=120) for h in [ref_srv.submit(r) for r in reqs]]
    cm = fresh_compiled("DAE")
    with ModelServer(cm, params, batch_slots=2) as srv:
        [h.result(timeout=120) for h in [srv.submit(r) for r in reqs]]
    assert _keys(srv.stats()) == _keys(ref_srv.stats())
    assert set(cm.report_dict()["serve"]) == set(ref_cm.report_dict()["serve"])


def test_warmup_runs_on_the_serving_thread():
    cm = fresh_compiled("DAE")
    params, x = io("DAE")
    srv = ModelServer(cm, params, batch_slots=2)
    seen = []
    run_batch = srv.batched.run_batch
    srv.batched.run_batch = lambda *a: seen.append(threading.current_thread()) or run_batch(*a)
    with srv:
        srv.warmup(x)
    assert seen == [srv._thread]
    assert len(srv.batched.entry_stats()) == 1


def _pinned(srv: ModelServer) -> None:
    """Pin a finished thread as the worker: the test drives the rounds."""
    t = threading.Thread(target=lambda: None)
    t.start()
    t.join()
    srv._thread = t


def test_priority_jumps_lane_order_in_a_round():
    cm = port_compiled("DSCNN", "gap9")
    params, _ = io("DSCNN")
    reqs = requests("DSCNN", 4)
    srv = ModelServer(cm, params, batch_slots=4, stream_depth=2)
    _pinned(srv)
    handles = {i: srv.submit(reqs[i], priority=pr) for i, pr in enumerate((1.0, 1.0, 5.0, 2.0))}
    batch = srv.queue.take(8, timeout=0)
    assert [r.rid for r in batch] == [2, 3, 0, 1]  # Smith order, FIFO ties
    srv._serve_round(batch)
    assert srv.stats()["last_round"]["rids"] == [2, 3, 0, 1]
    for i, h in handles.items():
        _same(h.result(timeout=120), cm.run(params, reqs[i]))
    cm.attrs.pop("serve")


def test_server_rejects_when_queue_full():
    cm = port_compiled("DAE", "gap9")
    params, _ = io("DAE")
    reqs = requests("DAE", 2)
    srv = ModelServer(cm, params, batch_slots=1, queue_capacity=1)
    _pinned(srv)  # no worker: the queue cannot drain
    srv.submit(reqs[0])
    with pytest.raises(QueueFullError):
        srv.submit(reqs[1])
    assert srv.stats()["rejected"] == 1


def test_expired_requests_are_shed_not_run():
    cm = port_compiled("DAE", "gap9")
    params, _ = io("DAE")
    reqs = requests("DAE", 2)
    srv = ModelServer(cm, params, batch_slots=2, shed_expired=True)
    _pinned(srv)
    late = srv.submit(reqs[0], deadline_us=-1.0)  # already past its deadline
    fine = srv.submit(reqs[1])
    srv._serve_round(srv.queue.take(8, timeout=0))
    with pytest.raises(DeadlineExceededError):
        late.result(timeout=10)
    _same(fine.result(timeout=120), cm.run(params, reqs[1]))
    assert srv.stats()["shed"] == 1 and srv.stats()["completed"] == 1
    cm.attrs.pop("serve")


@pytest.mark.parametrize(
    "kwargs,match",
    [({"batch_slots": 0}, "batch_slots"), ({"stream_depth": 0}, "stream_depth"), ({"mode": "eager"}, "mode")],
)
def test_server_rejects_bad_arguments(kwargs, match):
    with pytest.raises(ValueError, match=match):
        ModelServer(port_compiled("DAE", "gap9"), {}, **kwargs)


def test_concurrent_submitters_all_served_bit_exact():
    """8 threads submit 10 requests each against one replica, with the
    interpreter switching threads every 10 us: every request served once,
    bit-exact, and the replica's counters add up."""
    cm = fresh_compiled("DAE")
    params, _ = io("DAE")
    reqs = requests("DAE", 8)
    want = [cm.run(params, r) for r in reqs]
    results: dict[tuple, dict] = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ModelServer(cm, params, batch_slots=4, stream_depth=2, queue_capacity=128) as srv:
            def client(t: int) -> None:
                hs = [(i, srv.submit(reqs[(t + i) % len(reqs)])) for i in range(10)]
                for i, h in hs:
                    results[t, i] = h.result(timeout=120)

            threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(120)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(results) == 80
    for (t, i), out in results.items():
        _same(out, want[(t + i) % len(reqs)])
    st = srv.stats()
    assert st["submitted"] == st["completed"] == 80 and st["rejected"] == 0


# ---------------------------------------------------------------------------
# Admission control against the reference queue
# ---------------------------------------------------------------------------


def test_queue_order_matches_the_reference_on_one_sequence():
    rng = np.random.default_rng(5)
    mine, ref = AdmissionQueue(capacity=64), rs.AdmissionQueue(capacity=64)
    got, want = [], []
    rid = 0
    for _ in range(40):
        if rng.random() < 0.65:
            pr = float(rng.integers(0, 4))
            dl = None if rng.random() < 0.5 else float(rng.integers(0, 100))
            mine.put(ServeRequest(rid=rid, inputs={}, priority=pr, deadline_us=dl))
            ref.put(rs.ServeRequest(rid=rid, inputs={}, priority=pr, deadline_us=dl))
            rid += 1
        else:
            n = int(rng.integers(1, 4))
            got.append([r.rid for r in mine.take(n, timeout=0)])
            want.append([r.rid for r in ref.take(n, timeout=0)])
    got.append([r.rid for r in mine.take(64, timeout=0)])
    want.append([r.rid for r in ref.take(64, timeout=0)])
    assert got == want
    assert mine.depth == ref.depth == 0


def test_take_orders_by_priority_then_deadline_then_arrival():
    q = AdmissionQueue(capacity=8)
    for rid, pr, dl in ((0, 1.0, None), (1, 3.0, None), (2, 3.0, 50.0), (3, 1.0, None)):
        q.put(ServeRequest(rid=rid, inputs={}, priority=pr, deadline_us=dl))
    assert [r.rid for r in q.take(8, timeout=0)] == [2, 1, 0, 3]


def test_reject_policy_sheds_where_the_reference_does():
    for q, full in ((AdmissionQueue(capacity=2), QueueFullError), (rs.AdmissionQueue(capacity=2), rs.QueueFullError)):
        req = ServeRequest if isinstance(q, AdmissionQueue) else rs.ServeRequest
        q.put(req(rid=0, inputs={}))
        q.put(req(rid=1, inputs={}))
        with pytest.raises(full):
            q.put(req(rid=2, inputs={}))
        assert q.depth == 2


def test_block_policy_times_out_then_admits_like_the_reference():
    for q, full in ((AdmissionQueue(1, "block"), QueueFullError), (rs.AdmissionQueue(1, "block"), rs.QueueFullError)):
        req = ServeRequest if isinstance(q, AdmissionQueue) else rs.ServeRequest
        q.put(req(rid=0, inputs={}))
        with pytest.raises(full):
            q.put(req(rid=1, inputs={}), timeout=0.05)
        assert [r.rid for r in q.take(1, timeout=0)] == [0]
        q.put(req(rid=2, inputs={}), timeout=0.05)
        assert q.depth == 1
        q.close()
        with pytest.raises(RuntimeError, match="closed"):
            q.put(req(rid=3, inputs={}), timeout=0.05)


def test_queue_rejects_bad_arguments():
    with pytest.raises(ValueError, match="capacity"):
        AdmissionQueue(capacity=0)
    with pytest.raises(ValueError, match="policy"):
        AdmissionQueue(policy="drop")

"""The readers of the program's spans on synthetic traces: the eager run's
kernels put down to segment and node spans by correlation id, replays
matched in order against them (and left out, said why, where they
differ), idle gaps labelled by the innermost span, and a CPU run whose
pass leaves the window's own readings as they were."""

import json
from pathlib import Path

import pytest

from bench import harness, program_spans
from bench.program_spans import Span, device_trace, fit_shift, read_stretch_b
from conftest import checkout_copy

BASE = 1_000_000.0  # the profiler's clock, in us, at perf_counter 0
X_SYNC, D_SYNC, W_SYNC = 2.4, 1.0, 4.0  # each sync call's offset, duration and bracket: base is off by 0.9 us
CONV = [("conv2d", ["conv_k"]), ("bias_add", ["add_k"]), ("requant", ["div_k", "round_k"]), ("relu", ["clamp_k"])]
EAGER0 = 100.0
R0 = 1000.0  # the replays' window starts here, one request every 100 us
PERIOD = 100.0


def _us(t: float) -> float:
    return t * 1e-6


class Trace:
    """A profiler's Chrome events and a tracer's spans, built on one true clock (us)."""

    def __init__(self, drift=None):
        self.drift = drift or (lambda t: 0.0)  # the device clock's offset from the host calls', at true time t
        self.truth = {}  # (correlation, name) -> true start of each device event
        self.events, self.spans, self.client = [], [], []
        self.sync_perf = []
        self.corr = 0
        for k in range(8):
            before = 10.0 * k
            self.sync_perf.append((_us(before), _us(before + W_SYNC)))
            self.events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaMemGetInfo",
                                "ts": BASE + before + X_SYNC, "dur": D_SYNC, "args": {"correlation": 0}})

    def launch(self, t: float, name: str = "cudaLaunchKernel", dur: float = 0.5) -> int:
        self.corr += 1
        self.events.append({"ph": "X", "cat": "cuda_runtime", "name": name, "ts": BASE + t, "dur": dur,
                            "args": {"correlation": self.corr}})
        return self.corr

    def device(self, corr: int, name: str, t: float, dur: float = 3.0, cat: str = "kernel") -> None:
        self.truth[corr, name] = t
        self.events.append({"ph": "X", "cat": cat, "name": name, "ts": BASE + t + self.drift(t), "dur": dur,
                            "args": {"correlation": corr}})

    def span(self, label: str, a: float, b: float, lane: str = "run:aot", **args) -> None:
        self.spans.append(Span(label, lane, _us(a), _us(b), args))

    def eager(self) -> tuple[float, float]:
        """conv1 (tiled_conv; five kernels under four node spans, each span
        tight around its launch) then fc (one GEMM kernel, no node spans),
        after an input copy outside any segment."""
        self.device(self.launch(EAGER0 - 5), "Memcpy HtoD (Pageable -> Device)", EAGER0 - 4, cat="gpu_memcpy")
        t = EAGER0 + 10
        seg_a = t - 2
        for op, kernels in CONV:
            self.span(f"node:{op}", t - 0.3, t + 2.2, lane="run:cuda_core", name=f"{op}1")
            for j, kernel in enumerate(kernels):
                self.device(self.launch(t + j), kernel, t + 5 + 4 * j)
            t += 20
        self.span("conv1", seg_a, t - 10, lane="run:cuda_core", route="tiled_conv", **{"async": True})
        self.span("fc", t - 8, t + 5, lane="run:cuda_core", route="pallas_gemm", **{"async": True})
        self.device(self.launch(t), "gemv_k", t + 5)
        return _us(EAGER0 - 10), _us(t + 50)

    def replay(self, k: int, kernels: list[str]) -> None:
        t0 = R0 + k * PERIOD
        self.client.append(("client", _us(t0 - 3), _us(t0)))
        self.client.append(("AotModel.run", _us(t0), _us(t0 + 45)))
        self.client.append(("client output copy", _us(t0 + 45), _us(t0 + 95)))
        self.span("aot.run:net", t0, t0 + 45, memory="xla")
        self.span("aot.prepare", t0, t0 + 10)
        self.span("aot.input_copy", t0 + 10, t0 + 20)
        self.device(self.launch(t0 + 12, "cudaMemcpyAsync"), "Memcpy HtoD", t0 + 14, 2.0, "gpu_memcpy")
        self.span("aot.replay", t0 + 20, t0 + 30)
        corr = self.launch(t0 + 25, "cudaGraphLaunch")
        for j, name in enumerate(kernels):
            self.device(corr, name, t0 + 32 + 4 * j)
        self.span("aot.output_clone", t0 + 30, t0 + 40)
        self.device(self.launch(t0 + 35, "cudaMemcpyAsync"), "Memcpy DtoD", t0 + 32 + 4 * len(kernels), 1.0,
                    "gpu_memcpy")
        # the copy to pageable memory returns once the copy is done
        self.device(self.launch(t0 + 70, "cudaMemcpyAsync", 10.0), "Memcpy DtoH (Device -> Pageable)", t0 + 72,
                    2.0, "gpu_memcpy")

    def read(self, n: int, bad: dict[int, list[str]] | None = None):
        eager = self.eager()
        names = [kernel for _, kernels in CONV for kernel in kernels] + ["gemv_k"]
        for k in range(n):
            self.replay(k, (bad or {}).get(k, names))
        dt = device_trace(self.events, self.sync_perf)
        window = (_us(R0 - 5), _us(R0 + n * PERIOD))
        spans = sorted(self.spans, key=lambda s: s.a)
        return dt, read_stretch_b(dt, spans, eager, window, self.client, {"conv1": 2e-6, "fc": 1e-6})


def test_the_clock_is_tied_by_the_sync_calls():
    dt = device_trace(Trace().events, Trace().sync_perf)
    assert dt.sync_error_us == pytest.approx((W_SYNC - D_SYNC) / 2)
    assert dt.launches == [] and dt.device == []


def test_the_device_clock_is_put_on_the_host_calls_clock():
    """Device timestamps 40 us late at the start and drifting 3000 ppm (as
    on the card): the copies to the host and the launches around them
    bring each event back to within a few us of its true start."""
    tr = Trace(drift=lambda t: 40.0 - 0.003 * t)
    dt, b = tr.read(8)
    errs = [abs(d.a * 1e6 - tr.truth[d.corr, d.name]) for d in dt.device
            if d.a * 1e6 >= R0 - 20]  # the replays, between the copies that tie the clock
    assert errs and max(errs) < 6.0
    assert dt.device_error_us is not None and 0 < dt.device_error_us < 6.0
    assert b.first_after_start == len(b.matched) == 8
    # without the copies to pageable memory nothing ties it: the offset stays
    raw = device_trace([dict(e, name=e["name"].replace("Pageable", "Pinned")) for e in tr.events], tr.sync_perf)
    assert raw.device_error_us is None
    assert max(abs(d.a * 1e6 - tr.truth[d.corr, d.name.replace("Pinned", "Pageable")]) for d in raw.device) > 30.0


def test_the_eager_kernels_go_to_their_segment_and_node_by_correlation():
    dt, b = Trace().read(5)
    # the launches lie 0.9 us before their tight node spans on the bracket's clock: the fit moves them in
    assert b.eager_launches == 7 and b.eager_in_spans == 6
    assert 0.6 < b.shift_us < 2.1
    assert [(n, lab.segment, lab.route, lab.node, lab.op) for n, lab in b.sequence] == [
        ("conv_k", "conv1", "tiled_conv", 0, "conv2d"),
        ("add_k", "conv1", "tiled_conv", 1, "bias_add"),
        ("div_k", "conv1", "tiled_conv", 2, "requant"),
        ("round_k", "conv1", "tiled_conv", 2, "requant"),
        ("clamp_k", "conv1", "tiled_conv", 3, "relu"),
        ("gemv_k", "fc", "pallas_gemm", None, None),
    ]
    assert b.replays == 5 and len(b.matched) == 5 and b.why == []
    assert b.first_after_start == 5
    # need 2 us a replay over 5 x 3 us of conv kernels a replay
    assert b.tiled_conv_roofline_pct == pytest.approx(100.0 * 2.0 / 15.0)
    conv = next(r for r in b.by_segment if r[0] == "conv1")
    assert conv[1:] == ["tiled_conv", pytest.approx(75e-6), pytest.approx(15e-6), pytest.approx(60e-6)]


def test_the_fit_prefers_the_shift_nearest_the_bracket():
    leaves = [(0.0, 1.0), (10.0, 11.0)]
    shift, inside = fit_shift([0.5, 10.5], leaves, 20.0)
    assert inside == 2 and -0.5 <= shift <= 0.5
    shift, inside = fit_shift([1.5, 11.5], leaves, 20.0)
    assert inside == 2 and -1.5 <= shift <= -0.5


@pytest.mark.parametrize("bad, why", [
    (["conv_k", "add_k", "div_k", "round_k", "clamp_k"], "replay 3: 5 device events, the eager run 6"),
    (["conv_k", "add_k", "div_k", "other_k", "clamp_k", "gemv_k"], "replay 3: event 3 is 'other_k'"),
])
def test_a_replay_that_differs_is_left_out_and_the_readers_read_none(bad, why):
    _, b = Trace().read(5, {3: bad})
    assert len(b.matched) == 4 and b.replays == 5
    assert len(b.why) == 1 and b.why[0].startswith(why)
    # 4 of 5 is under 99 %: nothing read from the replays' kernels
    assert b.tiled_conv_roofline_pct is None and b.by_segment == []


def test_a_replay_the_trace_missed_is_left_out_and_the_rest_still_match():
    """The profiler can drop a graph launch's record: the replays pair with
    the launch inside their own aot.replay span, so one missing record
    costs one replay, not the stretch."""
    tr = Trace()
    eager = tr.eager()
    names = [kernel for _, kernels in CONV for kernel in kernels] + ["gemv_k"]
    for k in range(200):
        tr.replay(k, names)
    launches = [e for e in tr.events if e["name"] == "cudaGraphLaunch"]
    tr.events.remove(launches[7])
    dt = device_trace(tr.events, tr.sync_perf)
    b = read_stretch_b(dt, sorted(tr.spans, key=lambda s: s.a), eager, (_us(R0 - 5), _us(R0 + 200 * PERIOD)),
                       tr.client, {"conv1": 2e-6, "fc": 1e-6})
    assert b.replays == 200 and len(b.matched) == 199
    assert b.why == ["replay 7: no graph launch with device work in the trace inside its aot.replay span"]
    # 199 of 200 is 99.5 %: the replays' readers read
    assert b.by_segment and b.tiled_conv_roofline_pct is not None
    # the trace can lose its last device events: the stretch is read as far as it holds them
    tail = _us(R0 + 190 * PERIOD)
    kept = [e for e in tr.events if e["cat"] not in program_spans.DEVICE_CATS or _us(e["ts"] - BASE) < tail]
    dt = device_trace(kept, tr.sync_perf)
    b = read_stretch_b(dt, sorted(tr.spans, key=lambda s: s.a), eager, (_us(R0 - 5), _us(R0 + 200 * PERIOD)),
                       tr.client, {"conv1": 2e-6, "fc": 1e-6})
    assert b.window[1] < tail and b.replays == 190 and len(b.matched) == 189


def test_the_innermost_span_labels_each_gap():
    tr = Trace()
    dt, b = tr.read(5)
    r0, r1 = b.window  # to the last device event
    labels = dict(b.idle_gaps)
    # brute force: each idle gap's middle under the shortest program span, else the client's
    busy = sorted((max(d.a, r0), min(d.b, r1)) for d in dt.device if d.b > r0 and d.a < r1)
    merged = program_spans.union_s(busy)[1]
    edges = [r0] + [x for iv in merged for x in iv] + [r1]
    want: dict[str, float] = {}
    for a, b_ in zip(edges[0::2], edges[1::2]):
        if b_ <= a:
            continue
        mid = (a + b_) / 2
        inside = [s for s in tr.spans if s.a <= mid <= s.b] or [Span(n, None, x, y) for n, x, y in tr.client
                                                                if x <= mid <= y]
        name = min(inside, key=lambda s: s.b - s.a).name if inside else "none"
        want[name] = want.get(name, 0.0) + b_ - a
    assert set(labels) == set(want)
    for name, s in want.items():
        assert labels[name] == pytest.approx(s)
    # the graph launch's gap lies under aot.replay, inside aot.run:net; the wait for D2H under the client
    assert labels["aot.replay"] > 0 and "client output copy" in labels
    assert labels.get("aot.run:net", 0.0) < labels["aot.replay"]
    # idle while the host is inside an aot.* span (each inside its request's aot.run:net)
    runs = [s for s in tr.spans if s.name == "aot.run:net"]
    aot_idle = sum(max(0.0, min(b_, s.b) - max(a, s.a)) for a, b_ in zip(edges[0::2], edges[1::2]) for s in runs)
    assert b.idle_in_aot_pct == pytest.approx(100.0 * aot_idle / (r1 - r0))


def test_a_cpu_run_reads_the_spans_after_the_window_and_leaves_its_readings(tmp_path):
    """The pass runs after the window: the window's requests, the part
    outside the profiler and the stretch are what the loop left; the span
    readers read numbers, the trace readers nothing (no profiler on the CPU)."""
    root = checkout_copy(tmp_path)
    seen = []

    class Recorded(harness.Run):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self)

    harness.Run, original = Recorded, harness.Run
    try:
        result = harness.run_cell(Path(root), "dae_toycar.single", 11, 0.5, True, device="cpu")
    finally:
        harness.Run = original
    assert result["correct"], result
    (run,) = seen
    assert len(run.latencies_s) == run.attempted == result["attempted"]
    assert len(run.host_calls_s) == run.outside_samples
    assert run.outside_samples + sum(run.stretch_rows) == run.attempted
    got = result["metrics"]
    for name in ("aot.prepare_us.single", "aot.input_copy_us.single", "aot.replay_us.single",
                 "aot.output_clone_us.single", "dispatch.dse_s"):
        assert got[name]["value"] > 0, name
    assert got["dispatch.dse_candidates"]["value"] > 0
    assert "device.idle_in_aot.single" not in got and "aot.capture_s" not in got
    names = {m["name"] for m in json.loads((root / "BENCHMARK.json").read_text())["per_layer"]}
    assert "kernels_roofline.tiled_conv.single" in names and "kernels.conv_epilogue_share.single" not in names

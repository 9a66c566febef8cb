"""The harness finds every part of a cell by the names BENCHMARK.json and
its data give it, with no edit to a file it has: here a configuration
whose net is not a chain (a residual add), with its own graph builder,
reference and need counts, a mix driven by a loop of a new kind, and a
per-layer metric."""

import json

import pytest

from bench import harness, spec
from conftest import checkout_copy

CELL = "tiny_residual.paced"
GEOM = {"OY": 8, "OX": 8, "FY": 3, "FX": 3, "stride": 1}
DUMMY_CONFIG = {
    "name": "tiny_residual",
    "source": "a test's own residual net",
    "graph": "residual",
    "reference": "residual_int",
    "counts": "residual_counts",
    "target": "h100",
    "dispatch": {"budget": 300},
    "precision": {"operands": "int8", "bias": "int32", "accumulate": "int32", "peak": "int8_ops_s"},
    "input": {"name": "x", "shape": [1, 8, 8, 4], "dtype": "float32"},
    "layers": [
        {"name": "c1", "op": "conv2d", "K": 4, "C": 4, **GEOM, "relu": True},
        {"name": "c2", "op": "conv2d", "K": 4, "C": 4, **GEOM, "relu": False},
        {"name": "a1", "op": "add", "inputs": ["c1", "c2"], "shift": 1, "K": 4, "C": 4, "OY": 8, "OX": 8},
        {"op": "avgpool", "C": 4, "OY": 1, "OX": 1, "FY": 8, "FX": 8},
        {"op": "dense", "K": 2, "C": 4, "relu": False},
    ],
}
DUMMY_MIX = {"loop": "paced", "interval_s": 0.01, "pool": 8, "warmup": 4, "check_answers": 16}
FILES = {
    "graphs/residual.py": '''"""A test's graph builder: layers join the outputs their ``inputs`` name;
the draw, the device's set-up and the compile are the chain's."""

from pathlib import Path

from repro_torch.core import Graph, Node

from bench import spec
from bench.reference.cnn_int import MAC_OPS

_chain = spec.load_module(Path(__file__).with_name("cnn_chain.py"))
draw, prepare_device = _chain.draw, _chain.prepare_device

SKIP = ("op", "relu", "name", "inputs", "shift")


def _chains(config):
    out, prev, chains = {}, config["input"]["name"], []
    for i, layer in enumerate(config["layers"]):
        name = layer.get("name", f"l{i}")
        ins = tuple(out[n] for n in layer.get("inputs", ())) or (prev,)
        geom = {"B": 1, "elem_bytes": 1, **{k: v for k, v in layer.items() if k not in SKIP}}
        if layer["op"] in MAC_OPS:
            ops = [layer["op"], "bias_add", "requant"] + (["relu"] if layer["relu"] else [])
        elif layer["op"] == "add":
            ops = ["add", "requant"]
        else:
            ops = [layer["op"]]
        chain = []
        for j, op in enumerate(ops):
            chain.append(Node(f"{name}_{op}", op, ins if j == 0 else (chain[-1].name,), geom))
        chains.append(chain)
        out[name] = prev = chain[-1].name
    return chains


def build_graph(config):
    nodes = [n for c in _chains(config) for n in c]
    inp = config["input"]
    return Graph(config["name"], nodes, {inp["name"]: tuple(inp["shape"])}, (nodes[-1].name,))


def build_program(config, params, device):
    return _chain.compile_graph(build_graph(config), config, device)


def program_params(config, drawn):
    params = {}
    for layer, chain, w, b, s in zip(config["layers"], _chains(config), drawn.weights, drawn.biases, drawn.shifts):
        if w is not None:
            params[chain[0].name], params[chain[1].name] = {"w": w.float()}, {"b": b.float()}
            params[chain[2].name] = {"shift": float(s)}
        elif layer["op"] == "add":
            params[chain[1].name] = {"shift": float(layer["shift"])}
    return params
''',
    "reference/residual_int.py": '''"""A test's reference: cnn_int's layers, and an add of two named outputs."""

import numpy as np

from bench.reference import cnn_int


def forward(layers, params, x, *, operand_bits=8):
    h, out = np.asarray(x, dtype=np.int64), {}
    for i, (layer, p) in enumerate(zip(layers, params)):
        if layer["op"] == "add":
            a, b = (out[n] for n in layer["inputs"])
            h = np.clip(cnn_int.round_half_even_shift(a + b, layer["shift"]), -128, 127)
        else:
            h = cnn_int.forward([layer], [p], h, operand_bits=operand_bits)
        out[layer.get("name", f"l{i}")] = h
    return h
''',
    "reference/residual_counts.py": '''"""A test's counts: the chain's, and each add's two reads and one write."""

from bench.reference import counts


def _chain(layers):
    return [layer for layer in layers if layer["op"] != "add"]


def macs_of(config):
    return counts.macs(_chain(config["layers"]), config["input"]["shape"])


def need_s_of(config, rows, peaks):
    ops_s, bytes_s = peaks[config["precision"]["peak"]], peaks["hbm_bytes_s"]
    t = counts.need_s(_chain(config["layers"]), config["input"]["shape"], rows, ops_s, bytes_s)
    for layer in config["layers"]:
        if layer["op"] == "add":
            n = layer["K"] * layer["OY"] * layer["OX"] * rows
            t += max(3 * n / bytes_s, n / ops_s)
    return t
''',
    "loops/paced.py": '''"""A test's loop: one request every ``interval_s``, timed from when it was due."""

import time

import torch


def prepare(cm, feed, mix):
    from repro_torch.backend import compile_aot

    am = compile_aot(cm)
    am.warmup(feed.params, {feed.name: feed.samples[0]})
    return am


def warm(am, feed, mix):
    for p in feed.warm_order:
        am.run(feed.params, {feed.name: feed.samples[p]})


def drive(run, am, feed, mix):
    t_start, i = time.perf_counter(), 0
    with torch.inference_mode():
        while (due := t_start + i * mix["interval_s"]) < t_start + run.seconds:
            time.sleep(max(0.0, due - time.perf_counter()))
            p = feed.order[i % len(feed.order)]
            host = {k: v.cpu() for k, v in am.run(feed.params, {feed.name: feed.samples[p]}).items()}
            run.latencies_s.append(time.perf_counter() - due)
            feed.keep.offer((p, host))
            i += 1
    run.window_s = time.perf_counter() - t_start
    run.attempted = run.samples = i
''',
    "metrics/window_samples.py": '''"""A test's metric: the samples the window saw."""


def read(run):
    return float(run.samples)
''',
}


@pytest.fixture
def checkout(tmp_path):
    """A copy of the checkout's BENCHMARK.json and bench/, with the new
    cell's files added and entries appended, nothing else edited."""
    checkout_copy(tmp_path)
    bench_dir = tmp_path / "bench"
    for rel, text in FILES.items():
        (bench_dir / rel).write_text(text)
    (bench_dir / "configs" / "tiny_residual.json").write_text(json.dumps(DUMMY_CONFIG))
    (bench_dir / "mixes" / "paced.json").write_text(json.dumps(DUMMY_MIX))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_residual", "source": "a test", "file": "bench/configs/tiny_residual.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": CELL, "config": "tiny_residual", "traffic": "paced", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("latency_p50_ms", "latency_p95_ms"):
            m["workloads"].append(CELL)
    bench["per_layer"].append({"name": "window_samples", "unit": "samples", "better": "higher",
                               "source": "host_clock", "layer": "a test", "moves": "latency_p50_ms",
                               "workloads": [CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_new_cell_found_by_name(checkout):
    cell = spec.load_cell(checkout, CELL, checkout / "bench")
    assert cell.config["name"] == "tiny_residual" and cell.mix["loop"] == "paced"
    assert [m["name"] for m in spec.metrics_of(cell, True)] == ["window_samples"]
    assert spec.reader(cell, "window_samples").__module__.endswith("window_samples")


def test_new_cell_runs(checkout):
    """The residual net, served by the new loop, is correct against its own
    reference: the graph is not a chain (two layers read ``c1``)."""
    graph = spec.named(checkout / "bench", "graphs", "residual").build_graph(DUMMY_CONFIG)
    readers = [n.name for n in graph.nodes if "c1_relu" in n.inputs]
    assert readers == ["c2_conv2d", "a1_add"]
    result = harness.run_cell(checkout, CELL, 5, 0.3, True, device="cpu", bench_dir=checkout / "bench")
    assert result["correct"], result
    assert result["metrics"]["window_samples"]["value"] == result["attempted"] > 0
    e2e = harness.run_cell(checkout, CELL, 5, 0.3, False, device="cpu", bench_dir=checkout / "bench")
    assert e2e["correct"], e2e
    assert set(e2e["metrics"]) == {"latency_p50_ms", "latency_p95_ms", "setup_s"}


def test_the_new_references_answers_differ_from_a_chains(checkout):
    """The check holds the new cell to its own reference: the chain's
    reference, which skips the add, gives other answers."""
    from bench import data

    drawn = data.draw(DUMMY_CONFIG, 5, 4, harness.torch.device("cpu"))
    x = harness.np.concatenate([p.numpy() for p in drawn.pool])
    chain = [layer for layer in DUMMY_CONFIG["layers"] if layer["op"] != "add"]
    params = [p for layer, p in zip(DUMMY_CONFIG["layers"], drawn.reference_params()) if layer["op"] != "add"]
    wrong = spec.named(checkout / "bench", "reference", "cnn_int").forward(chain, params, x)
    kept = [(i, {"y": harness.torch.from_numpy(wrong[i : i + 1].astype("float32"))}) for i in range(4)]
    value, limit = harness.check(DUMMY_CONFIG, drawn, kept, bench_dir=checkout / "bench")["mismatched_values"]
    assert value > limit == 0


def test_a_metric_without_workloads_follows_what_it_moves(checkout):
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "window_samples_e2e", "unit": "samples", "better": "higher", "bound": 0.25,
                                "source": "host_clock", "workloads": [CELL]})
    for name, moves in (("follows_p50", "latency_p50_ms"), ("follows_new", "window_samples_e2e")):
        bench["per_layer"].append({"name": name, "unit": "samples", "better": "higher", "source": "host_clock",
                                   "layer": "a test", "moves": moves})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    new = [m["name"] for m in spec.metrics_of(spec.load_cell(checkout, CELL, checkout / "bench"), True)]
    old = [m["name"] for m in spec.metrics_of(spec.load_cell(checkout, "dae_toycar.single", checkout / "bench"), True)]
    assert "follows_p50" in new and "follows_p50" in old
    assert "follows_new" in new and "follows_new" not in old

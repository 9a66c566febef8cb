"""A configuration that is not an int8 MATCH graph, added with new files and
appended entries only: its builder draws token ids and float32 weights
from the seed and builds a program of its own (an embedding, two dense
layers with a GELU, logits) with no dispatch, its reference is plain
float64, and its answers are held to a ``close`` rule, a rule file the
test adds too.  A configuration with no ``"check"`` block keeps the exact
rule and its three check lines."""

import json
import math

import pytest
import torch

from bench import harness, spec
from conftest import CHECKOUT, checkout_copy

CELL = "tiny_float_lm.single"
SEED = 2**31 + 77
WHY = ("float32 against float64 reads |got - want| at most 2.9e-6 over 12 seeds, logits up to 7.9: atol 2e-5 and "
       "rtol 2e-5 put that at a tenth of the tolerance; bfloat16 reads 2.7e-2 and more, a thousand times it")
FLOAT_CONFIG = {
    "name": "tiny_float_lm",
    "source": "a test's own float net",
    "graph": "float_lm",
    "reference": "float_lm_ref",
    "counts": "float_lm_counts",
    "target": "h100",
    # peaks.json holds no float32 peak until a cell runs in float32; the test reads only that mfu is above 0
    "precision": {"dtype": "float32", "peak": "bf16_flops_s"},
    "input": {"name": "tokens", "shape": [1, 16], "dtype": "int64"},
    "sizes": {"vocab": 512, "d_model": 64, "d_ff": 256},
    "check": {"rule": "close", "atol": 2e-5, "rtol": 2e-5, "why": WHY},
}
FLOAT_MIX = {"loop": "direct", "pool": 64, "warmup": 20, "check_answers": 64}
FILES = {
    "graphs/float_lm.py": '''"""A test's builder: token ids and float32 weights drawn on the device,
and a program of its own, in the configuration's dtype."""

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


def shapes(config):
    s = config["sizes"]
    v, d, f = s["vocab"], s["d_model"], s["d_ff"]
    return {"emb": (v, d), "w1": (d, f), "b1": (f,), "w2": (f, d), "b2": (d,), "out": (d, v)}


@dataclass
class Drawn:
    weights: dict  # float32, on the run's device
    pool: list  # int64 token ids, (1, T) each, host memory

    def reference_params(self):
        return {k: v.to("cpu", torch.float64) for k, v in self.weights.items()}


def draw(config, seed, pool, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    sh = shapes(config)
    flat = torch.randn(sum(math.prod(s) for s in sh.values()), generator=gen, device=device)
    weights, i = {}, 0
    for k, s in sh.items():
        n = math.prod(s)
        weights[k] = flat[i : i + n].view(s) / math.sqrt(s[0] if len(s) == 2 and k != "emb" else 1)
        i += n
    tokens = torch.randint(0, sh["emb"][0], (pool, *config["input"]["shape"]), generator=gen, device=device)
    return Drawn(weights, list(tokens.cpu().unbind(0)))


def program_params(config, drawn):
    dtype = getattr(torch, config["precision"]["dtype"])
    return {k: v.to(dtype) for k, v in drawn.weights.items()}


def prepare_device(config, dev):
    pass


class Program:
    def __init__(self, name, device):
        self.name, self.device = name, device

    def run(self, params, inputs):
        h = params["emb"][inputs[self.name].to(self.device)]
        h = F.gelu(h @ params["w1"] + params["b1"])
        h = h @ params["w2"] + params["b2"]
        return {"logits": h @ params["out"]}


def build_program(config, params, device):
    return Program(config["input"]["name"], device), {}
''',
    "checks/close.py": '''"""A test's rule: each value of each kept answer is finite and lies within
``atol + rtol * |want|`` of the reference's ``want``; the reference runs on
the run's device in blocks of ``BLOCK`` inputs."""

import numpy as np
import torch

BLOCK = 16


def judge(config, rule, drawn, kept, reference, device):
    """Values not finite or outside the tolerance (every value of an answer
    of another size), and the largest ``|got - want| / (atol + rtol *
    |want|)`` over the finite values of answers of the right size."""
    atol, rtol = float(rule["atol"]), float(rule["rtol"])
    rparams = drawn.reference_params()
    wanted = sorted({p for p, _ in kept})
    ref = {}
    for i in range(0, len(wanted), BLOCK):
        idx = wanted[i : i + BLOCK]
        y = reference.forward(config, rparams, torch.cat([drawn.pool[p] for p in idx]), device)
        y = y.to("cpu", torch.float64).numpy()
        for j, p in enumerate(idx):
            ref[p] = y[j].reshape(-1)
    bad, worst = 0, 0.0
    for p, out in kept:
        (got,) = out.values()
        got, want = got.detach().to("cpu", torch.float64).numpy().reshape(-1), ref[p]
        if got.shape != want.shape:
            bad += want.size
            continue
        finite = np.isfinite(got) & np.isfinite(want)
        ratio = np.abs(got - want)[finite] / (atol + rtol * np.abs(want[finite]))
        bad += int(np.count_nonzero(~finite)) + int(np.count_nonzero(ratio > 1))
        if ratio.size:
            worst = max(worst, float(ratio.max()))
    return {"mismatched_values": (bad, 0), "max_error_over_tolerance": (worst, 1)}
''',
    "reference/float_lm_ref.py": '''"""A test's reference: the float net in float64, erf GELU, on the device it is given."""

import torch


def forward(config, params, x, device):
    p = {k: v.to(device, torch.float64) for k, v in params.items()}
    a = p["emb"][x.to(device)] @ p["w1"] + p["b1"]
    h = 0.5 * a * (1.0 + torch.erf(a / 2.0**0.5))
    return (h @ p["w2"] + p["b2"]) @ p["out"]
''',
    "reference/float_lm_counts.py": '''"""A test's counts, from the whole configuration: 2 x MACs of the three
matmuls; the weights read once a batch, each row's tokens, embedding rows
and logits once, at 4 bytes (token ids 8)."""


def macs_of(config):
    s, t = config["sizes"], config["input"]["shape"][1]
    return t * (2 * s["d_model"] * s["d_ff"] + s["d_model"] * s["vocab"])


def need_s_of(config, rows, peaks):
    s, t = config["sizes"], config["input"]["shape"][1]
    d, f, v = s["d_model"], s["d_ff"], s["vocab"]
    weight_bytes = 4 * (2 * d * f + f + d + d * v)
    row_bytes = t * (8 + 4 * d + 4 * v)
    ops = 2 * macs_of(config) * rows
    return max(ops / peaks[config["precision"]["peak"]], (weight_bytes + rows * row_bytes) / peaks["hbm_bytes_s"])
''',
    "loops/direct.py": '''"""A test's loop: the closed loop, driving the builder's program as it is."""

from pathlib import Path

from bench import spec

_closed = spec.load_module(Path(__file__).with_name("closed.py"))
warm, drive = _closed.warm, _closed.drive


def prepare(program, feed, mix):
    return program
''',
}


def _append(root, config=FLOAT_CONFIG):
    """Add the float cell to the copy under ``root``: new files, and entries
    appended to BENCHMARK.json's lists."""
    bench_dir = root / "bench"
    for rel, text in FILES.items():
        assert not (bench_dir / rel).exists(), rel
        (bench_dir / rel).write_text(text)
    (bench_dir / "configs" / "tiny_float_lm.json").write_text(json.dumps(config))
    (bench_dir / "mixes" / "float_single.json").write_text(json.dumps(FLOAT_MIX))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_float_lm", "source": "a test", "file": "bench/configs/tiny_float_lm.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": CELL, "config": "tiny_float_lm", "traffic": "float_single", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("latency_p50_ms", "latency_p95_ms", "dispatch_s", "compile_s", "mfu.single",
                         "kernels_roofline.single"):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def checkout(tmp_path):
    return _append(checkout_copy(tmp_path))


def _run(root, trace, device="cpu", seed=SEED, workload=CELL):
    return harness.run_cell(root, workload, seed, 0.3, trace, device=device, bench_dir=root / "bench")


def test_nothing_of_the_copy_is_edited(checkout):
    """Every file the benchmark had is as it was; BENCHMARK.json only gained
    entries at the ends of its lists."""
    for f in (CHECKOUT / "bench").rglob("*"):
        rel = f.relative_to(CHECKOUT)
        if f.is_file() and "tests" not in rel.parts and "__pycache__" not in rel.parts:
            assert (checkout / rel).read_bytes() == f.read_bytes(), rel
    old, new = (json.loads((r / "BENCHMARK.json").read_text()) for r in (CHECKOUT, checkout))

    def without_cell(entry):
        if not isinstance(entry, dict) or "workloads" not in entry:
            return entry
        return {**entry, "workloads": [w for w in entry["workloads"] if w != CELL]}

    assert new.keys() == old.keys()
    for key, value in old.items():
        if isinstance(value, list):
            assert [without_cell(m) for m in new[key][: len(value)]] == value, key
        else:
            assert new[key] == value, key


def test_the_float_cell_runs_with_its_own_draw_program_and_rule(checkout):
    result = _run(checkout, False)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"latency_p50_ms", "latency_p95_ms", "setup_s"}
    assert list(result["checks"]) == ["mismatched_values", "max_error_over_tolerance", "failed_requests",
                                      "checked_answers"]
    assert result["checks"]["max_error_over_tolerance"]["limit"] == 1
    assert 0 < result["checks"]["max_error_over_tolerance"]["value"] < 0.5
    assert result["checks"]["checked_answers"]["value"] == min(FLOAT_MIX["check_answers"], result["attempted"]) > 0
    assert harness.check_lines(result["checks"])[1].startswith("check max_error_over_tolerance ")


def test_a_traced_run_has_no_dispatch_and_counts_the_whole_configuration(checkout):
    result = _run(checkout, True)
    assert result["correct"], result["checks"]
    got = result["metrics"]
    assert "dispatch_s" not in got and got["compile_s"]["value"] > 0 and got["mfu.single"]["value"] > 0
    assert "kernels_roofline.single" not in got  # no profiler on the CPU
    counts = spec.named(checkout / "bench", "reference", "float_lm_counts")
    peaks = json.loads((checkout / "bench" / "peaks.json").read_text())["h100"]
    run = harness.Run(config=FLOAT_CONFIG, counts=counts, peaks=peaks, seconds=1.0)
    assert run.macs() == 16 * (2 * 64 * 256 + 64 * 512)
    assert run.need_s(2) == counts.need_s_of(FLOAT_CONFIG, 2, peaks) > run.need_s(1) > 0


def test_the_same_program_in_bfloat16_fails_the_check(tmp_path):
    """The control: the program computed one precision below the stated
    one is caught by the stated tolerance."""
    root = _append(checkout_copy(tmp_path), {**FLOAT_CONFIG, "precision": {**FLOAT_CONFIG["precision"],
                                                                            "dtype": "bfloat16"}})
    result = _run(root, False)
    assert not result["correct"]
    assert result["checks"]["mismatched_values"]["value"] > 0
    assert result["checks"]["max_error_over_tolerance"]["value"] > 100


def test_the_reference_runs_in_blocks_with_tf32_off_and_restores_it(checkout, monkeypatch):
    seen = []
    real = spec.named

    def named(bench_dir, folder, name):
        mod = real(bench_dir, folder, name)
        if folder == "reference":
            forward = mod.forward

            def probe(config, params, x, device):
                seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, len(x)))
                return forward(config, params, x, device)

            mod.forward = probe
        return mod

    monkeypatch.setattr(spec, "named", named)
    builder = real(checkout / "bench", "graphs", "float_lm")
    drawn = builder.draw(FLOAT_CONFIG, SEED, 40, torch.device("cpu"))
    program, _ = builder.build_program(FLOAT_CONFIG, builder.program_params(FLOAT_CONFIG, drawn), torch.device("cpu"))
    kept = [(p, program.run(builder.program_params(FLOAT_CONFIG, drawn), {"tokens": drawn.pool[p]}))
            for p in range(40)]
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        found = harness.check(FLOAT_CONFIG, drawn, kept, bench_dir=checkout / "bench")
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
    assert seen == [(False, False, 16), (False, False, 16), (False, False, 8)]
    assert found["mismatched_values"] == (0, 0) and found["max_error_over_tolerance"][1] == 1
    # an answer altered by more than the tolerance is counted, one of another shape counts every value
    kept[3][1]["logits"].view(-1)[5] += 1e-3
    kept[7] = (7, {"logits": kept[7][1]["logits"][:, :8]})
    found = harness.check(FLOAT_CONFIG, drawn, kept, bench_dir=checkout / "bench")
    assert found["mismatched_values"][0] == 1 + 16 * 512 and found["max_error_over_tolerance"][0] > 1


def test_a_configuration_with_no_check_block_keeps_the_exact_rule_and_its_three_lines(checkout):
    result = _run(checkout, False, workload="dae_toycar.single")
    assert result["correct"], result["checks"]
    n = result["checks"]["checked_answers"]["value"]
    assert harness.check_lines(result["checks"]) == [
        "check mismatched_values 0 <= 0", "check failed_requests 0 <= 0", f"check checked_answers {n} >= 1"]
    assert n == min(512, result["attempted"]) > 0


@pytest.mark.cuda
def test_the_float_cell_on_the_card(tmp_path):
    """The float cell through ``run_cell`` on the card, the reference on the
    card with TF32 off: correct on three seeds, and its bfloat16 control
    not.  ``-s`` prints the readings."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = _append(checkout_copy(tmp_path / "f32"))
    low = _append(checkout_copy(tmp_path / "bf16"), {**FLOAT_CONFIG, "precision": {**FLOAT_CONFIG["precision"],
                                                                                  "dtype": "bfloat16"}})
    for seed in (SEED, SEED + 1, SEED + 2):
        ok, control = _run(root, False, "cuda", seed), _run(low, False, "cuda", seed)
        for name, r in (("float32", ok), ("bfloat16", control)):
            print(f"{name} seed {seed} on {r['device']['kind']}: correct {r['correct']}, "
                  + ", ".join(f"{k} {c['value']}" for k, c in r["checks"].items()))
        assert ok["correct"] and ok["device"]["platform"] == "gpu" and not control["correct"]
        assert math.isfinite(ok["checks"]["max_error_over_tolerance"]["value"])

"""The port's calibration loop (``repro_torch.calibrate``) against the
reference's (``repro.calibrate``) on the same numpy data: the fitter's
coefficients, the sample and profile files each package reads from the
other, the microbench features and predicted cycles of the quick sweep,
per-module coverage (the card's ``h100`` included, run here on the CPU),
the ``sweep -> fit -> show`` CLI, and a compile under a fitted profile.
The sweep on the card is the ``cuda``-marked test at the end."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import repro.calibrate as rc
import repro_torch.calibrate as pc
from repro_torch.backend import lower
from repro_torch.calibrate.__main__ import main as calibrate_main
from repro_torch.cnn import conv_block_graph
from repro_torch.core import dispatch
from repro_torch.targets import get_target, make_h100_target, unregister_target

from _torch_port import one_torch_thread  # noqa: F401 (a fixture)

BUDGET = 300
FIT_FIELDS = ("compute_scale", "mem_scale", "fixed_overhead_cycles", "samples", "mae_before", "mae_after")


@pytest.fixture(autouse=True)
def _no_calibration_env(monkeypatch):
    monkeypatch.delenv("MATCH_CALIBRATION_PROFILE", raising=False)
    monkeypatch.delenv("MATCH_SCHEDULE_CACHE", raising=False)


def _rows(a, b, async_dma, *, c=0.0, n=12, seed=0, outlier=None) -> list[dict]:
    """Sample rows (``MicrobenchSample`` fields) on a known linear model,
    as ``tests/test_calibrate.py`` draws them; ``outlier`` scales the last
    measurement (a sample set where least squares raises the MAE)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        l_ops = float(rng.uniform(1e3, 1e6))
        l_mem = float(rng.uniform(1e3, 1e6))
        pred = max(l_ops, l_mem) if async_dma else l_ops + l_mem
        y = (a * max(l_ops, l_mem) if async_dma else a * l_ops + b * l_mem) + c
        if outlier is not None and i == n - 1:
            y *= outlier
        rows.append(dict(graph=f"g{i}", segment=f"s{i}", module="m", pattern="p", route="reference",
                         l_ops=l_ops, l_mem=l_mem, async_dma=async_dma, predicted_cycles=pred,
                         measured_us=y, frequency_hz=1e6))
    return rows


def _both(rows):
    return [pc.MicrobenchSample(**r) for r in rows], [rc.MicrobenchSample(**r) for r in rows]


def _fit_fields(mc) -> tuple:
    return tuple(getattr(mc, f) for f in FIT_FIELDS)


# the sample sets of tests/test_calibrate.py's fitter tests, and one where
# least squares would raise the MAE (the declared model is kept)
FIT_CASES = {
    "sync": _rows(3.0, 0.5, False, c=4000.0),
    "async": _rows(7.5, 7.5, True, c=900.0),
    "degenerate": [dict(graph="g", segment="s", module="m", pattern="p", route="r", l_ops=0.0, l_mem=0.0,
                        async_dma=False, predicted_cycles=0.0, measured_us=10.0, frequency_hz=1e6)] * 3,
    "mae_would_rise": _rows(1.0, 1.0, False, n=10, outlier=40.0),
    "empty": [],
}


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_fit_module_equals_the_reference(case):
    port, ref = _both(FIT_CASES[case])
    got, want = pc.fit_module(port), rc.fit_module(ref)
    assert _fit_fields(got) == _fit_fields(want)
    if case == "mae_would_rise":
        # least squares chased the outlier: both keep the declared model
        assert got.compute_scale == got.mem_scale == 1.0 and got.fixed_overhead_cycles == 0.0
        assert got.mae_after == got.mae_before


@pytest.fixture(scope="module")
def quick_samples():
    """The quick sweep on gap9 and diana, through each package (the port on
    the CPU), with one timed repeat."""
    return {
        t: (pc.run_microbench(t, quick=True, repeats=1, device="cpu"), rc.run_microbench(t, quick=True, repeats=1))
        for t in ("gap9", "diana")
    }


def _features(s) -> tuple:
    return (s.graph, s.segment, s.module, s.pattern, s.route, s.l_ops, s.l_mem, s.predicted_cycles)


@pytest.mark.parametrize("target", ["gap9", "diana"])
def test_collect_samples_features_equal_the_reference(quick_samples, target):
    port, ref = quick_samples[target]
    assert [_features(s) for s in port] == [_features(s) for s in ref]
    assert all(s.measured_us > 0 and s.frequency_hz > 0 for s in port)


@pytest.mark.parametrize("target", ["gap9", "diana"])
def test_fit_profile_equals_the_reference_on_the_same_samples(quick_samples, target):
    """The port's measured samples, handed to both fitters as numpy data."""
    port, _ = quick_samples[target]
    ref = [rc.MicrobenchSample.from_dict(s.to_dict()) for s in port]
    got = pc.fit_profile(port, target_name=target, meta={"k": 1})
    want = rc.fit_profile(ref, target_name=target, meta={"k": 1})
    assert got.to_dict() == want.to_dict()
    assert got.fingerprint() == want.fingerprint()
    assert pc.profile_errors(port, got) == rc.profile_errors(ref, want)


def test_sample_and_profile_files_load_in_either_package(quick_samples, tmp_path):
    port, ref = quick_samples["gap9"]
    p1 = pc.save_samples(tmp_path / "port_samples.json", port, target="gap9", meta={"device": "cpu"})
    tname, loaded = rc.load_samples(p1)
    assert tname == "gap9" and [s.to_dict() for s in loaded] == [s.to_dict() for s in port]
    p2 = rc.save_samples(tmp_path / "ref_samples.json", ref, target="gap9")
    tname, loaded = pc.load_samples(p2)
    assert tname == "gap9" and [s.to_dict() for s in loaded] == [s.to_dict() for s in ref]

    prof = pc.fit_profile(port, target_name="gap9")
    back = rc.load_profile(prof.save(tmp_path / "port_profile.json"))
    assert back is not None and back.to_dict() == prof.to_dict() and back.tag() == prof.tag()
    rprof = rc.fit_profile(ref, target_name="gap9")
    back = pc.load_profile(rprof.save(tmp_path / "ref_profile.json"))
    assert back is not None and back.to_dict() == rprof.to_dict() and back.tag() == rprof.tag()


def test_run_microbench_covers_every_module():
    """tests/test_calibrate.py's coverage test, on the port."""
    sweep = [conv_block_graph(IX=8, IY=8, C=8, K=8), pc.dense_block_graph(K=16, C=32)]
    samples = pc.run_microbench("gap9", sweep=sweep, repeats=1, budget=200, device="cpu")
    assert {s.module for s in samples} == {"cluster", "ne16", "cpu"}
    assert pc.unsampled_modules(get_target("gap9", profile=None), samples) == []


def test_run_microbench_on_h100_leaves_the_tensor_cores_declared():
    """No CNN pattern lands on ``tensor_core``: its restriction falls back to
    ``aten``, so only ``cuda_core`` and ``aten`` get samples."""
    h100 = make_h100_target()
    samples = pc.run_microbench(h100, quick=True, repeats=1, device="cpu")
    assert {s.module for s in samples} == {"cuda_core", "aten"}
    assert {s.route for s in samples if s.module == "cuda_core"} == {"tiled_conv", "pallas_gemm"}
    assert pc.unsampled_modules(h100, samples) == ["tensor_core"]
    prof = pc.fit_profile(samples, target_name="h100")
    assert set(prof.modules) == {"cuda_core", "aten"}
    assert all(s.frequency_hz == 1.98e9 for s in samples)


@pytest.mark.parametrize("target", ["gap9", "h100"])
def test_cli_sweep_fit_show_round_trip(tmp_path, capsys, target):
    samples, profile = tmp_path / "samples.json", tmp_path / "profile.json"
    try:
        assert calibrate_main(["sweep", "--target", target, "--quick", "--repeats", "1", "--device", "cpu",
                               "--out", str(samples)]) == 0
        assert calibrate_main(["fit", "--samples", str(samples), "--out", str(profile)]) == 0
    finally:
        if target == "h100":  # the CLI registered it; leave the registry as found
            unregister_target("h100")
    out = capsys.readouterr().out
    tname, loaded = rc.load_samples(samples)  # the reference reads the port's file
    assert tname == target and loaded
    prof = rc.load_profile(profile)
    assert prof is not None and prof.target == target
    assert prof.meta["declared_as_is"] == (["tensor_core"] if target == "h100" else [])
    assert calibrate_main(["show", str(profile)]) == 0
    shown = capsys.readouterr().out
    assert json.loads(shown[: shown.rindex("# fingerprint")]) == prof.to_dict()
    assert f"# fingerprint {prof.tag()}" in shown and "fitted" in out


def test_calibrated_compile_stays_bit_exact(quick_samples):
    """Calibration changes cost constants only — never numerics
    (tests/test_calibrate.py's test, with a profile the port fitted)."""
    port, _ = quick_samples["gap9"]
    prof = pc.fit_profile(port, target_name="gap9")
    g = conv_block_graph(IX=8, IY=8, C=8, K=8)
    tgt = get_target("gap9", profile=prof)
    assert tgt.attrs["calibration"]["fingerprint"] == prof.fingerprint()
    compiled = lower(dispatch(g, tgt, budget=BUDGET), device="cpu")
    params, x = pc.graph_io(g)
    assert compiled.verify(params, x) == 0.0


def test_run_microbench_defaults_to_cuda_and_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device would work")
    with pytest.raises((AssertionError, RuntimeError)):
        pc.run_microbench("gap9", sweep=[pc.dense_block_graph(K=16, C=32)], repeats=1)


@pytest.mark.cuda
def test_run_microbench_on_the_card_measures_cuda_core_and_aten():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    h100 = make_h100_target()
    samples = pc.run_microbench(h100, quick=True, repeats=1)
    assert {s.module for s in samples} == {"cuda_core", "aten"}
    assert all(s.measured_us > 0 for s in samples)
    prof = pc.fit_profile(samples, target_name="h100")
    for name in ("cuda_core", "aten"):
        assert prof.modules[name].samples > 0

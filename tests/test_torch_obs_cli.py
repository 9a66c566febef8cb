"""The port's ``obs`` CLI (``python -m repro_torch.obs``) against the
reference's on the same artifacts, written by the port's own tracer and
flight recorder: the same exit codes and the same text, but for the
re-fit command the drift verdict names."""

from __future__ import annotations

import json

import pytest

from repro.obs.__main__ import main as ref_main
from repro_torch import obs
from repro_torch.obs.__main__ import main as port_main
from repro_torch.obs.trace import Tracer


def _trace(tmp_path):
    tr = Tracer(enabled=True)
    with tr.span("dispatch", cat="compile"):
        pass
    tr.complete("conv0", tr.now_us() - 3.0, cat="runtime", lane="run:cuda_core")
    tr.instant("divergence:conv0", cat="verify")
    tr.slice("predicted:cuda_core", "conv0", 0.0, 5.0)
    return tr.save(tmp_path / "trace.json")


def _drift(tmp_path):
    def row(module, us):
        return {"module": module, "predicted_cycles": 100.0, "measured_us": us, "frequency_hz": 1e6}

    p = tmp_path / "report.json"
    p.write_text(json.dumps({"target": "h100", "timings": [row("aten", 120.0)] * 3 + [row("cuda_core", 1000.0)] * 3}))
    return p


def _slo(tmp_path):
    spec = {"kind": "latency_p99_us", "threshold": 100.0, "warn_ratio": 0.75, "description": "", "state": "breach",
            "value": 250.0, "burn": 2.5, "transitions": 1, "breaches": 1, "last_change_s": 1.0}
    engine = {"name": "serve:r0", "window_s": 60.0, "worst_state": "breach", "breached": True, "specs": {"p99": spec}}
    p = tmp_path / "report.json"
    p.write_text(json.dumps({"obs": {"slo": {"breached": True, "engines": {"serve:r0": engine}}}}))
    return p


def _flight(tmp_path):
    fl = obs.get_flight()
    fl.record_request(rid=1, replica="r0", arrival_us=10.0, latency_us=500.0, priority=2.0, status="ok", batch=4)
    fl.trigger("queue_full", capacity=8)
    return fl.dump(tmp_path / "inc.json", reason="queue_full")


@pytest.mark.parametrize("verb,make,rc", [
    ("summarize", _trace, 0), ("drift", _drift, 0), ("slo", _slo, 1), ("flight", _flight, 0),
])
def test_obs_cli_prints_what_the_reference_prints(tmp_path, capsys, verb, make, rc):
    path = str(make(tmp_path))
    assert port_main([verb, path]) == rc
    got = capsys.readouterr().out
    assert ref_main([verb, path]) == rc
    want = capsys.readouterr().out
    assert got == want.replace("python -m repro.calibrate", "python -m repro_torch.calibrate")
    if verb == "drift":
        assert "DRIFTED — re-fit (python -m repro_torch.calibrate)" in got


def test_obs_cli_drift_without_timings_exits_1(tmp_path):
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"target": "h100", "segments": []}))
    assert port_main(["drift", str(empty)]) == 1
    with pytest.raises(SystemExit):
        port_main(["summarize", str(tmp_path / "missing.json")])

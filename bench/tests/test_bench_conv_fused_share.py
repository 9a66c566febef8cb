"""`lower.conv_fused_share` reads the program's lowering counters: the share
of the configuration's `tiled_conv` segments that the lowering gave the
fused conv kernel, and nothing where the program has no such counter."""

from pathlib import Path

import pytest

from bench import spec

CHECKOUT = Path(__file__).resolve().parents[2]


def _read():
    return spec.named(spec.BENCH, "metrics", "lower.conv_fused_share").read(None)


def test_reads_the_fused_share_of_the_conv_segments_lowered():
    from repro_torch import obs
    from repro_torch.backend import lower
    from repro_torch.core import dispatch
    from repro_torch.targets import make_h100_target

    cell = spec.load_cell(CHECKOUT, "mobilenetv1_025_vww.single")
    graph = spec.named(spec.BENCH, "graphs", cell.config["graph"]).build_graph(cell.config)
    before = dict(obs.metrics_dict()["counters"])
    cm = lower(dispatch(graph, make_h100_target(), budget=300), device="cpu")
    counters = obs.metrics_dict()["counters"]
    added = {k: counters[k] - before.get(k, 0) for k in ("lower.conv.fused", "lower.route.tiled_conv")}
    assert added == {"lower.conv.fused": 27, "lower.route.tiled_conv": 27}
    assert all(ls.meta["kernel"] == "conv_requant" for ls in cm.segments if ls.route == "tiled_conv")
    share = _read()
    assert share == pytest.approx(100.0 * counters["lower.conv.fused"] / counters["lower.route.tiled_conv"])
    assert 0.0 < share <= 100.0


def test_a_program_without_the_counter_reads_none(monkeypatch):
    from repro_torch import obs

    real = obs.metrics_dict

    def without():
        d = real()
        d["counters"] = {k: v for k, v in d["counters"].items() if k != "lower.conv.fused"}
        return d

    monkeypatch.setattr(obs, "metrics_dict", without)
    assert _read() is None

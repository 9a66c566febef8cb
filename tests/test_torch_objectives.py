"""The port's ``dispatch`` objectives and calibration profiles against the
reference: ``objective="makespan"`` and ``"wct"`` re-rank through the
port's copy of ``pipeline.schedule``, and ``profile=`` overlays through
its copy of ``calibrate.profile``.  Both must pick the reference's
segmentation; a profile saved by the reference must load in the port."""

import pytest

import repro.calibrate.profile as ref_profile
import repro.core
import repro.pipeline.schedule as ref_schedule
import repro_torch.calibrate.profile as port_profile
import repro_torch.core
import repro_torch.pipeline.schedule as port_schedule
from _torch_port import BUDGET, NETS, port_graph, ref_graph, segment_rows


@pytest.mark.parametrize("objective", ["makespan", "wct"])
@pytest.mark.parametrize("net", NETS)
def test_objective_dispatch_matches_reference(net, objective):
    want = repro.core.dispatch(ref_graph(net), "gap9", budget=BUDGET, objective=objective)
    got = repro_torch.core.dispatch(port_graph(net), "gap9", budget=BUDGET, objective=objective)
    assert segment_rows(got) == segment_rows(want)
    assert got.attrs.get("objective") == want.attrs.get("objective")


@pytest.mark.parametrize("net", NETS)
def test_pipeline_schedule_matches_reference(net):
    want = ref_schedule.schedule_pipeline(repro.core.dispatch(ref_graph(net), "gap9", budget=BUDGET))
    got = port_schedule.schedule_pipeline(repro_torch.core.dispatch(port_graph(net), "gap9", budget=BUDGET))
    assert got.makespan == pytest.approx(want.makespan, rel=1e-12)
    assert [(s.index, s.name, s.module, s.deps) for s in got.entries] == [
        (s.index, s.name, s.module, s.deps) for s in want.entries
    ]
    assert [s.finish for s in got.entries] == pytest.approx([s.finish for s in want.entries], rel=1e-12)
    got.validate()


def _ref_profile():
    return ref_profile.CalibrationProfile(
        target="gap9",
        modules={
            "cluster": ref_profile.ModuleCalibration(2.0, 1.5, 120.0, samples=9),
            "ne16": ref_profile.ModuleCalibration(3.0, 3.0, 50.0, samples=4),
        },
        meta={"source": "reference"},
    )


def test_reference_profile_loads_in_port(tmp_path):
    path = _ref_profile().save(tmp_path / "gap9.json")
    prof = port_profile.load_profile(path)
    assert isinstance(prof, port_profile.CalibrationProfile)
    assert prof.to_dict() == _ref_profile().to_dict()
    assert prof.fingerprint() == _ref_profile().fingerprint()


@pytest.mark.parametrize("net", ["DSCNN", "DAE"])
def test_profile_dispatch_matches_reference(net, tmp_path):
    path = _ref_profile().save(tmp_path / "gap9.json")
    want = repro.core.dispatch(ref_graph(net), "gap9", budget=BUDGET, profile=str(path))
    got = repro_torch.core.dispatch(port_graph(net), "gap9", budget=BUDGET, profile=str(path))
    assert segment_rows(got) == segment_rows(want)
    plain = repro_torch.core.dispatch(port_graph(net), "gap9", budget=BUDGET, profile=None)
    assert [r[4] for r in segment_rows(got)] != [r[4] for r in segment_rows(plain)]

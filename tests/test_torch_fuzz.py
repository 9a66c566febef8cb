"""The port's fuzz generator, shrinker, corpus and CLI
(``repro_torch.fuzz``) against the reference's (``repro.fuzz``): the same
seed gives the same spec, the same graph node for node and the same
inputs; the shrinker reaches the same spec under the same predicate; the
CLI runs and replays on the CPU into a temporary corpus and never writes
into the reference's replayed ``tests/conformance/corpus/``.  The oracle's
verdicts are held in ``tests/test_torch_fuzz_oracle.py``."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

import repro.fuzz as rf
import repro_torch.fuzz as pf
from repro_torch.fuzz.__main__ import main as fuzz_main
from repro_torch.fuzz.corpus import REFERENCE_CORPUS

from _torch_port import node_rows, one_torch_thread  # noqa: F401 (one_torch_thread: a fixture)

CORPUS = Path(__file__).parent / "conformance" / "corpus"


def test_the_port_names_the_reference_corpus():
    assert REFERENCE_CORPUS == CORPUS.resolve()


@pytest.mark.parametrize("block", range(4))
def test_generator_equals_the_reference_for_1000_seeds(block):
    """Seeds 250·block .. 250·block+249: spec, graph and inputs identical."""
    for s in range(250 * block, 250 * (block + 1)):
        spec = pf.sample_spec(s)
        assert spec == rf.sample_spec(s), s
        assert json.dumps(spec, sort_keys=True) == json.dumps(rf.sample_spec(s), sort_keys=True)
        g, rg = pf.build_graph(spec), rf.build_graph(spec)
        assert node_rows(g) == node_rows(rg), s
        assert (g.name, dict(g.inputs), tuple(g.outputs)) == (rg.name, dict(rg.inputs), tuple(rg.outputs))
        a, b = pf.random_inputs(spec, s), rf.random_inputs(spec, s)
        assert a.keys() == b.keys() and all(
            a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a
        ), s


def test_graph_for_seed_and_knobs_equal_the_reference():
    kn_p, kn_r = pf.FuzzKnobs(max_ops=8), rf.FuzzKnobs(max_ops=8)
    for s in range(50):
        assert pf.sample_spec(s, kn_p) == rf.sample_spec(s, kn_r)
        assert node_rows(pf.graph_for_seed(s, kn_p)) == node_rows(rf.graph_for_seed(s, kn_r))


def _has_conv(build):
    def pred(spec):
        try:
            return any(n.op == "conv2d" for n in build(spec).nodes)
        except (pf.SpecError, rf.SpecError):
            return False

    return pred


def _has_join(build):
    def pred(spec):
        try:
            return any(n.op in ("add", "mul", "concat") for n in build(spec).nodes)
        except (pf.SpecError, rf.SpecError):
            return False

    return pred


@pytest.mark.parametrize("seed", [3, 11, 17, 29])
@pytest.mark.parametrize("make_pred", [_has_conv, _has_join], ids=["conv", "join"])
def test_shrink_spec_equals_the_reference(seed, make_pred):
    spec = pf.sample_spec(seed)
    got, got_checks = pf.shrink_spec(spec, make_pred(pf.build_graph))
    want, want_checks = rf.shrink_spec(spec, make_pred(rf.build_graph))
    assert got == want and got_checks == want_checks


def test_build_graph_rejects_the_reference_s_malformed_specs():
    good = pf.sample_spec(0)
    for bad in ({**good, "ops": []}, {**good, "ops": [{"kind": "warp", "src": 0}]},
                {**good, "ops": [{"kind": "conv", "src": 99}]},
                {"version": 1, "B": 1, "H": 5, "W": 5, "C": 2,
                 "ops": [{"kind": "conv", "src": 0, "K": 2, "F": 3, "stride": 2}]}):
        with pytest.raises(pf.SpecError):
            pf.build_graph(bad)
        with pytest.raises(rf.SpecError):
            rf.build_graph(bad)


def test_cases_are_the_reference_s_format(tmp_path):
    spec = pf.sample_spec(5)
    case = pf.make_case(spec, "gap9", "memory", 5, note="n")
    assert case == rf.make_case(spec, "gap9", "memory", 5, note="n")
    assert pf.case_id(case) == rf.case_id(case)
    path = pf.save_case(case, tmp_path)
    assert path.name == rf.save_case(case, tmp_path / "ref").name
    assert dict(rf.load_cases(tmp_path))[path] == case
    assert [(p.name, c) for p, c in pf.load_cases(CORPUS)] == [(p.name, c) for p, c in rf.load_cases(CORPUS)]


def test_saved_cases_never_land_in_the_reference_corpus(tmp_path, monkeypatch):
    monkeypatch.delenv("MATCH_FUZZ_CORPUS", raising=False)
    monkeypatch.chdir(tmp_path)
    assert pf.default_corpus_dir() == tmp_path / "fuzz-corpus"
    monkeypatch.setenv("MATCH_FUZZ_CORPUS", str(tmp_path / "env"))
    assert pf.default_corpus_dir() == tmp_path / "env"
    before = sorted(p.name for p in CORPUS.iterdir())
    case = pf.make_case(pf.sample_spec(1), "gap9", "memory", 1)
    with pytest.raises(ValueError, match="reference"):
        pf.save_case(case, CORPUS)
    monkeypatch.setenv("MATCH_FUZZ_CORPUS", str(CORPUS))
    with pytest.raises(ValueError, match="reference"):
        pf.save_case(case)
    assert sorted(p.name for p in CORPUS.iterdir()) == before


def test_cli_run_replay_round_trip(tmp_path, capsys, monkeypatch):
    """tests/test_fuzz.py's CLI test on the port, with ``--device cpu``."""
    monkeypatch.delenv("MATCH_FUZZ_CORPUS", raising=False)
    monkeypatch.chdir(tmp_path)
    before = sorted(p.name for p in CORPUS.iterdir())
    corpus = tmp_path / "corpus"
    args = ["run", "--seed", "0", "--n", "2", "--targets", "gap9", "--budget", "100", "--exec-every", "1",
            "--corpus", str(corpus), "--device", "cpu"]
    assert fuzz_main(args + ["--json", str(tmp_path / "summary.json")]) == 0
    out1 = capsys.readouterr().out
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["seeds_run"] == 2 and summary["failures"] == []
    assert summary["invariant_coverage"] == dict.fromkeys(pf.INVARIANTS, 2)
    assert fuzz_main(args) == 0
    assert capsys.readouterr().out == out1  # the verdict summary is deterministic
    assert fuzz_main(["replay", "--corpus", str(corpus), "--device", "cpu"]) == 0
    assert "no corpus cases" in capsys.readouterr().out
    # the shipped corpus, replayed as data with the full battery
    assert fuzz_main(["replay", "--corpus", str(CORPUS), "--full-battery", "--device", "cpu"]) == 0
    assert "replayed 3 cases, 0 failures" in capsys.readouterr().out
    assert sorted(p.name for p in CORPUS.iterdir()) == before
    assert not (tmp_path / "fuzz-corpus").exists()


def test_cli_shrink_refuses_to_write_into_the_reference_corpus(capsys):
    case = sorted(CORPUS.glob("*.json"))[0]
    text = case.read_text()
    assert fuzz_main(["shrink", str(case), "--device", "cpu"]) == 2
    assert case.read_text() == text

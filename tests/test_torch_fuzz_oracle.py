"""The port's differential oracle (``repro_torch.fuzz.oracle``) against
the reference's: the same (invariant, stage) verdicts with the full
battery on the shipped corpus and on seeds 0-5, the compiled paths on
the CPU.  The oracle on the card is the ``cuda``-marked test at the end;
``tests/test_torch_fuzz_shrink.py`` holds an induced failure and the
cross-package invariant."""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

import repro.fuzz as rf
import repro_torch.fuzz as pf
from repro_torch.targets import make_h100_target

from _torch_port import one_torch_thread  # noqa: F401 (a fixture)

BUDGET = 120
CORPUS = Path(__file__).parent / "conformance" / "corpus"
CASES = [(p.stem, c) for p, c in pf.load_cases(CORPUS)]


def _verdicts(rep) -> list[tuple[str, str]]:
    return [(f.invariant, f.stage) for f in rep.failures]


@pytest.mark.parametrize("name,case", CASES, ids=[n for n, _ in CASES])
def test_corpus_verdicts_equal_the_reference(name, case):
    got = pf.replay_case(case, budget=BUDGET, full_battery=True, device="cpu")
    want = rf.replay_case(case, budget=BUDGET, full_battery=True)
    assert got.invariants_checked == want.invariants_checked == pf.INVARIANTS
    assert (got.n_nodes, _verdicts(got)) == (want.n_nodes, _verdicts(want))
    assert got.ok


@pytest.mark.parametrize("target", ["gap9", "diana"])
@pytest.mark.parametrize("seed", range(6))
def test_seed_verdicts_equal_the_reference(seed, target):
    spec = pf.sample_spec(seed)
    got = pf.check_case(spec, target, io_seed=seed, budget=BUDGET, device="cpu")
    want = rf.check_case(spec, target, io_seed=seed, budget=BUDGET)
    assert (got.n_nodes, got.invariants_checked, _verdicts(got)) == (
        want.n_nodes, want.invariants_checked, _verdicts(want))
    assert got.ok, got.as_dict()


def test_check_case_defaults_to_cuda_and_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device would work")
    with pytest.raises((AssertionError, RuntimeError)):
        pf.check_case(pf.sample_spec(0), "gap9", budget=BUDGET)


@pytest.mark.cuda
@pytest.mark.parametrize("target", ["h100", "gap9"])
def test_oracle_is_clean_on_the_card(target):
    """Seeds 0-3, full battery: every compiled path on the card bit-exact
    with the CPU interpreter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    obj = make_h100_target() if target == "h100" else None
    for seed in range(4):
        rep = pf.check_case(pf.sample_spec(seed), target, io_seed=seed, budget=BUDGET, target_obj=obj)
        assert rep.ok and rep.invariants_checked == pf.INVARIANTS, rep.as_dict()

"""An induced failure on a deliberately broken target, classified, shrunk
and replayed by the port's fuzzer (``repro_torch.fuzz``) as by the
reference's, and the cross-package invariant the port's oracle cannot
hold itself (it never imports the reference): the port's CPU interpreter
bit-exact with the JAX interpreter on generated graphs."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import repro.cnn
import repro.fuzz as rf
import repro.targets
import repro_torch.cnn
import repro_torch.fuzz as pf
import repro_torch.targets

from _torch_port import one_torch_thread  # noqa: F401 (a fixture)

BUDGET = 120


def _verdicts(rep) -> list[tuple[str, str]]:
    return [(f.invariant, f.stage) for f in rep.failures]


def _broken(targets):
    """tests/test_fuzz.py's broken gap9: a home memory of 64 bytes, so
    every memory plan overflows."""
    t = targets.get_target("gap9")
    home = t.fallback.memories[-1]
    tiny = dataclasses.replace(home, size_bytes=64)
    fb = dataclasses.replace(t.fallback, memories=t.fallback.memories[:-1] + (tiny,))
    mods = [
        dataclasses.replace(m, memories=m.memories[:-1] + (tiny,))
        if m.memories and m.memories[-1].name == home.name else m
        for m in t.modules
    ]
    return dataclasses.replace(t, modules=mods, fallback=fb)


def test_induced_failure_is_classified_shrunk_and_replayed_as_by_the_reference(tmp_path):
    seed, spec = 4, pf.sample_spec(4)
    pbroken, rbroken = _broken(repro_torch.targets), _broken(repro.targets)

    def check(fuzz, broken, cand, **kw):
        return fuzz.check_case(cand, "gap9", io_seed=seed, invariants=("memory",), budget=BUDGET,
                               target_obj=broken, **kw)

    got, want = check(pf, pbroken, spec, device="cpu"), check(rf, rbroken, spec)
    assert not got.ok and [f.as_dict() for f in got.failures] == [f.as_dict() for f in want.failures]
    assert {f.invariant for f in got.failures} == {"memory"}

    small, checks = pf.shrink_spec(spec, lambda c: not check(pf, pbroken, c, device="cpu").ok)
    rsmall, rchecks = rf.shrink_spec(spec, lambda c: not check(rf, rbroken, c).ok)
    assert (small, checks) == (rsmall, rchecks)
    assert len(pf.build_graph(small).nodes) <= 8

    case = pf.make_case(small, "gap9", "memory", seed, note="induced: tiny home")
    path = pf.save_case(case, tmp_path)
    loaded = dict(pf.load_cases(tmp_path))[path]
    bad = pf.replay_case(loaded, budget=BUDGET, target_obj=pbroken, device="cpu")
    rbad = rf.replay_case(loaded, budget=BUDGET, target_obj=rbroken)
    assert not bad.ok and _verdicts(bad) == _verdicts(rbad)
    assert pf.replay_case(loaded, budget=BUDGET, device="cpu").ok  # clean on the real target


@pytest.mark.parametrize("seed", range(10, 20))
def test_port_interpreter_bit_exact_with_the_jax_interpreter(seed):
    """The cross-package invariant on seeds 10-19, each graph built by each
    package (tests/test_torch_fuzz_graphs.py holds the corpus and seeds
    0-9, and the port's compiled path on them)."""
    spec = pf.sample_spec(seed)
    g, rg = pf.build_graph(spec), rf.build_graph(spec)
    params = repro_torch.cnn.init_graph_params(g, seed=1)
    x = pf.random_inputs(spec, 1)
    got = repro_torch.cnn.execute_graph(g, params, x, device="cpu")
    want = repro.cnn.execute_graph(rg, params, x)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k

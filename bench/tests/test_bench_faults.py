"""A run with the timed path broken underneath reads ``correct`` false.

Each test drives the rest of a run (on the card where there is one, else
on the CPU) with one fault planted in the program: an answer altered where
it is produced.  The other faults a cell can have in general (a step that
returns its state unchanged, half of a batch left out, the exchange
between chips left out) have no place in a one-chip inference cell at
batch 1."""

import dataclasses

import pytest
import torch

import repro_torch.backend as backend
from bench import harness
from conftest import checkout_copy

SEED = 2**31 + 9
WINDOW_S = 0.5


def _device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def _altered(y: torch.Tensor) -> torch.Tensor:
    y = y.clone()
    y.view(-1)[0] += 1
    return y


def _alter_last_segment(monkeypatch):
    real = backend.lower

    def lower(mapped, *args, **kw):
        cm = real(mapped, *args, **kw)
        last = cm.segments[-1]
        cm.segments[-1] = dataclasses.replace(last, fn=lambda p, *xs: _altered(last.fn(p, *xs)))
        return cm

    monkeypatch.setattr(backend, "lower", lower)


@pytest.fixture
def run(tmp_path):
    root = checkout_copy(tmp_path)

    def run(workload: str) -> dict:
        return harness.run_cell(root, workload, SEED, WINDOW_S, False, device=_device(), bench_dir=root / "bench")

    return run


@pytest.mark.parametrize("workload", ["dae_toycar.single", "mobilenetv1_025_vww.single"])
def test_an_altered_answer(monkeypatch, run, workload):
    _alter_last_segment(monkeypatch)
    result = run(workload)
    assert not result["correct"] and result["checks"]["mismatched_values"]["value"] > 0


def test_a_sound_run_is_correct(run):
    result = run("mobilenetv1_025_vww.single")
    assert result["correct"], result["checks"]

"""The port's data pipeline and train driver on the CPU.

The data tests of ``tests/test_serving_data.py`` on ``repro_torch.data``,
each batch also bit-identical to the reference pipeline's for the same
(seed, step, host_index), tokens and embeds modes; then
``repro_torch.launch.train.main`` as ``tests/test_system.py`` drives the
reference's (mamba2 smoke, 6 steps, a checkpoint every 3) with ``--device
cpu``; a run stopped at step 4 through its ``PreemptionGuard`` and resumed
from its checkpoint gives the uninterrupted run's losses (the data is
replayed from the checkpoint's step); and the driver's default device is
the card.
"""

import numpy as np
import pytest
import torch

from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticTokenPipeline as JaxPipeline
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.launch import train as train_cli
from repro_torch.training.checkpoint import latest_step
from repro_torch.training.fault_tolerance import PreemptionGuard


def _same_as_reference(cfg: dict, step: int, batch: dict) -> None:
    want = JaxPipeline(JaxDataConfig(**cfg)).batch_at(step)
    assert set(batch) == set(want)
    for k in batch:
        assert batch[k].dtype == want[k].dtype and np.array_equal(batch[k], want[k]), k


def test_data_determinism_and_host_sharding():
    base = dict(vocab=100, seq_len=16, global_batch=8, seed=5)
    a = SyntheticTokenPipeline(DataConfig(**base, host_index=0, host_count=2))
    b = SyntheticTokenPipeline(DataConfig(**base, host_index=1, host_count=2))
    a0, a0b = a.batch_at(0), a.batch_at(0)
    np.testing.assert_array_equal(a0["tokens"], a0b["tokens"])  # deterministic
    assert a.local_batch == 4
    assert not np.array_equal(a0["tokens"], b.batch_at(0)["tokens"])  # disjoint shards
    for host, pipe in ((0, a), (1, b)):
        for step in (0, 7):
            _same_as_reference(dict(base, host_index=host, host_count=2), step, pipe.batch_at(step))


def test_data_prefetch_ordering():
    cfg = dict(vocab=50, seq_len=8, global_batch=2, prefetch=3)
    p = SyntheticTokenPipeline(DataConfig(**cfg)).start()
    got = [p.next() for _ in range(5)]
    p.stop()
    assert [s for s, _ in got] == [0, 1, 2, 3, 4]
    for s, batch in got:
        _same_as_reference(cfg, s, batch)


def test_data_labels_are_shifted_tokens():
    p = SyntheticTokenPipeline(DataConfig(vocab=50, seq_len=8, global_batch=2))
    b = p.batch_at(0)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])


def test_embeds_mode_for_stub_frontends():
    cfg = dict(vocab=50, seq_len=8, global_batch=2, embeds_dim=16)
    b = SyntheticTokenPipeline(DataConfig(**cfg)).batch_at(0)
    assert b["embeds"].shape == (2, 8, 16)
    assert b["labels"].max() < 50
    _same_as_reference(cfg, 0, b)


ARGS = ["--arch", "mamba2_1_3b", "--smoke", "--batch", "2", "--seq", "32", "--log-every", "100", "--device", "cpu"]


def test_train_driver_cli(tmp_path, capsys):
    res = train_cli.main(ARGS + ["--steps", "6", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"])
    assert res["final_step"] == 6
    assert latest_step(tmp_path) == 6
    assert np.isfinite(res["first_loss"]) and np.isfinite(res["final_loss"])
    assert "[train] done: {'final_step': 6" in capsys.readouterr().out


def test_preempted_run_resumes_with_the_uninterrupted_losses(tmp_path):
    """Steps 4-6 after a stop at step 4 and a restart from the checkpoint
    equal steps 4-6 of one uninterrupted run: parameters, optimizer state
    (step, moments, masters) and data all resume."""
    run = ARGS + ["--steps", "6", "--ckpt-every", "3"]

    def losses_of(argv, guard=None, stop_at=None):
        out = {}

        def on_step(step, metrics):
            out[step] = float(metrics["loss"])
            if step == stop_at:
                guard.request_stop()

        train_cli.main(argv, guard=guard, on_step=on_step)
        return out

    whole = losses_of(run + ["--ckpt-dir", str(tmp_path / "whole")])
    guard = PreemptionGuard(signals=())
    first = losses_of(run + ["--ckpt-dir", str(tmp_path / "cut")], guard=guard, stop_at=4)
    assert sorted(first) == [1, 2, 3, 4] and latest_step(tmp_path / "cut") == 4
    rest = losses_of(run + ["--ckpt-dir", str(tmp_path / "cut")])
    assert sorted(rest) == [5, 6]
    for step in range(1, 7):
        assert (first | rest)[step] == whole[step], step


def test_train_driver_defaults_to_cuda_and_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device would work")
    with pytest.raises((AssertionError, RuntimeError)):
        train_cli.main(["--arch", "mamba2_1_3b", "--smoke", "--steps", "1"])

"""The lower-precision control: the plain reference computed with int4
operands, put in the program's place, must come out not correct.

At the cells' own size (the whole net, the mixes' pool of 64 samples) and
on the weights a run draws: on the card with its generator where there is
one, on the CPU's elsewhere.  ``-s`` prints each reading."""

import json

import numpy as np
import pytest
import torch

from bench import data, harness
from conftest import CHECKOUT

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)
LIMIT = 0  # mismatched_values: the comparison is exact


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["mobilenetv1_025_vww", "dae_toycar"])
def test_int4_control_is_not_correct(name, seed):
    cfg = json.loads((CHECKOUT / "bench" / "configs" / f"{name}.json").read_text())
    mix = json.loads((CHECKOUT / "bench" / "mixes" / "single.json").read_text())
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    drawn = data.draw(cfg, seed, mix["pool"], dev)
    ref_mod = harness.spec.load_module(CHECKOUT / "bench" / "reference" / f"{cfg['reference']}.py")
    x = np.concatenate([p.numpy() for p in drawn.pool])
    control = ref_mod.forward(cfg["layers"], drawn.reference_params(), x, operand_bits=4)
    kept = [(i, {"y": torch.from_numpy(control[i : i + 1].astype(np.float32))}) for i in range(len(drawn.pool))]
    value, limit = harness.check(cfg, drawn, kept)["mismatched_values"]
    print(f"control {name} seed {seed} on {dev.type}: mismatched_values {value} of "
          f"{control.size} in {len(kept)} answers (limit {limit})")
    assert len(kept) == mix["pool"] and limit == LIMIT
    assert value > LIMIT

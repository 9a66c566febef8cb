"""The port's MoE layer and ``moe_gmm`` on the CPU against the JAX package.

``moe_gmm_plain`` and the ``moe_gmm`` wrapper given CPU tensors are held
against the Pallas kernel (interpret mode, as ``tests/test_kernels.py``
runs it) on that file's grid and against the oracle ``ref.moe_gmm_ref``,
also on ragged shapes the Pallas kernel cannot tile, at the reference's
1e-4.  ``moe_ffn`` and its aux loss are held against the reference's on
the dbrx and granite-moe smoke configs under each of the reference's
four (``moe_dispatch``, ``moe_combine``) formulations — the port
implements the default one; all four compute the same function — and in
a case that drops tokens.  Inputs and weights are made with numpy from a
seed and handed to both packages; float32 throughout.

The routed rows: ``moe_gmm`` given the per-expert counts computes the
filled rows as without them and 0 on the rest, and counts the rows of the
tiles it runs; ``moe_ffn``, which passes the counts, gives the same output
as with every row computed; and its ``moe.*`` counters match a hand count
after a prefill and a decode whose routing is set by the router, the
rows through the device tally that reading the counters folds in.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.kernels import moe_gmm as jax_moe_gmm
from repro.kernels import ref as jax_ref
from repro.models import ModelConfig as JaxConfig
from repro.models import moe as jmoe
from repro_torch import obs
from repro_torch.configs import get_smoke
from repro_torch.kernels import moe_gmm, moe_gmm_plain
from repro_torch.kernels import ref as port_ref
from repro_torch.models import ModelConfig
from repro_torch.models import moe as pmoe

GRID = [(2, 16, 32, 64), (8, 64, 128, 128), (3, 8, 16, 384)]  # tests/test_kernels.py:39
RAGGED = [(3, 37, 45, 70), (5, 1, 7, 3), (2, 33, 100, 65)]


def _gmm_inputs(E, C, D, F, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(E, C, D)).astype(np.float32), rng.normal(size=(E, D, F)).astype(np.float32)


def _port_both(x, w):
    """The plain version and the wrapper on CPU tensors (no launch)."""
    before = moe_gmm.launches
    outs = {"plain": moe_gmm_plain(x, w), "wrapper": moe_gmm(x, w)}
    assert moe_gmm.launches == before
    return outs


@pytest.mark.parametrize("E,C,D,F", GRID)
def test_moe_gmm_matches_pallas_kernel_and_oracle(E, C, D, F):
    x, w = _gmm_inputs(E, C, D, F, seed=E * C + F)
    pallas = np.asarray(jax_moe_gmm(jnp.asarray(x), jnp.asarray(w), block_c=8, block_f=64, block_d=16))
    oracle = np.asarray(jax_ref.moe_gmm_ref(jnp.asarray(x), jnp.asarray(w)))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_allclose(port_ref.moe_gmm_ref(xt, wt).numpy(), oracle, atol=1e-4, rtol=1e-4)
    for name, got in _port_both(xt, wt).items():
        assert got.dtype == torch.float32 and got.shape == (E, C, F), name
        np.testing.assert_allclose(got.numpy(), pallas, atol=1e-4, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(got.numpy(), oracle, atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("E,C,D,F", RAGGED)
def test_moe_gmm_ragged_and_strided_match_oracle(E, C, D, F):
    """Shapes the Pallas kernel's tiling refuses, and x as a strided view
    (the (E, C, D) view of (C, E, D) storage)."""
    x, w = _gmm_inputs(E, C, D, F, seed=C + D)
    oracle = np.asarray(jax_ref.moe_gmm_ref(jnp.asarray(x), jnp.asarray(w)))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2))).transpose(0, 1)
    for name, got in _port_both(xt, torch.from_numpy(w)).items():
        np.testing.assert_allclose(got.numpy(), oracle, atol=1e-4, rtol=1e-4, err_msg=name)


def test_moe_gmm_bf16_keeps_the_dtype_and_matches_oracle():
    x, w = _gmm_inputs(4, 16, 64, 48, seed=9)
    want = np.asarray(jax_ref.moe_gmm_ref(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)), np.float32)
    for name, got in _port_both(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()).items():
        assert got.dtype == torch.bfloat16, name
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2, err_msg=name)


@pytest.mark.parametrize("shapes", [((2, 4, 8), (3, 8, 5)), ((2, 4, 8), (2, 7, 5)), ((4, 8), (4, 8))])
def test_moe_gmm_rejects_mismatched_shapes(shapes):
    with pytest.raises(ValueError):
        moe_gmm(torch.zeros(shapes[0]), torch.zeros(shapes[1]))


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

FORMULATIONS = [("token", "gather"), ("token", "scatter"), ("unique_k", "gather"), ("unique_k", "scatter")]


def _params(cfg, seed):
    """MoE weights from numpy, as {name: np.ndarray}, at the reference's scale."""
    rng = np.random.default_rng(seed)
    return {
        k: (rng.normal(size=s.shape) * s.scale / np.sqrt(s.shape[0])).astype(np.float32)
        for k, s in jmoe.moe_params(cfg).items()
    }


def _both(jcfg, pcfg, x, params):
    jy, jaux = jmoe.moe_ffn({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), jcfg)
    py, paux = pmoe.moe_ffn({k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(x), pcfg)
    return (np.asarray(jy), float(jaux)), (py.numpy(), float(paux))


@pytest.mark.parametrize("dispatch,combine", FORMULATIONS)
@pytest.mark.parametrize("arch", ["dbrx_132b", "granite_moe_3b_a800m"])
def test_moe_ffn_matches_every_reference_formulation(arch, dispatch, combine):
    jcfg = jax_get_smoke(arch).replace(dtype="float32", moe_dispatch=dispatch, moe_combine=combine)
    pcfg = get_smoke(arch).replace(dtype="float32")
    params = _params(jcfg, seed=len(arch))
    x = np.random.default_rng(1).normal(size=(2, 12, jcfg.d_model)).astype(np.float32)
    (jy, jaux), (py, paux) = _both(jcfg, pcfg, x, params)
    assert py.shape == x.shape
    np.testing.assert_allclose(py, jy, atol=1e-4 * max(1.0, np.abs(jy).max()), rtol=1e-4)
    assert paux == pytest.approx(jaux, rel=1e-5)


@pytest.mark.parametrize("dispatch,combine", FORMULATIONS)
def test_moe_ffn_with_dropped_tokens(dispatch, combine):
    """Capacity 8 for 32 tokens x top-2 over 2 experts: most (token, k)
    pairs overflow and contribute zero."""
    kw = dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=2, vocab=64, n_experts=2,
              top_k=2, moe_d_ff=16, capacity_factor=0.25, dtype="float32")
    jcfg = JaxConfig(**kw, moe_dispatch=dispatch, moe_combine=combine)
    pcfg = ModelConfig(**kw)
    params = _params(jcfg, seed=3)
    x = np.random.default_rng(4).normal(size=(2, 32, 32)).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(params["router"]), dim=-1)
    slots, gates, _ = pmoe._route(probs, 2, pmoe.moe_capacity(pcfg, 32))
    assert bool((slots < 0).any()), "no token was dropped"
    assert bool((gates[slots < 0] == 0).all())
    (jy, jaux), (py, paux) = _both(jcfg, pcfg, x, params)
    np.testing.assert_allclose(py, jy, atol=1e-4 * max(1.0, np.abs(jy).max()), rtol=1e-4)
    assert paux == pytest.approx(jaux, rel=1e-5)


@pytest.mark.parametrize("S", [1, 7, 16, 100, 1000])
def test_moe_capacity_and_params_match_reference(S):
    for arch in ("dbrx_132b", "granite_moe_3b_a800m"):
        assert pmoe.moe_capacity(get_smoke(arch), S) == jmoe.moe_capacity(jax_get_smoke(arch), S)
        jspecs, pspecs = jmoe.moe_params(jax_get_smoke(arch)), pmoe.moe_params(get_smoke(arch))
        assert {k: (s.shape, s.axes, s.dtype, s.scale) for k, s in pspecs.items()} == {
            k: (s.shape, s.axes, s.dtype, s.scale) for k, s in jspecs.items()
        }


def test_moe_routing_takes_the_first_index_on_ties():
    """Equal router probabilities: jnp.argmax's first-index rule, round by round."""
    probs = torch.full((1, 3, 4), 0.25)
    slots, gates, counts = pmoe._route(probs, 2, 8)
    assert slots[0, :, 0].tolist() == [0, 1, 2]  # expert 0, positions 0..2
    assert slots[0, :, 1].tolist() == [8, 9, 10]  # expert 1
    assert counts.tolist() == [[3, 3, 0, 0]] and counts.dtype == torch.int32
    assert torch.allclose(gates, torch.full_like(gates, 0.5))


# ---------------------------------------------------------------------------
# routed rows
# ---------------------------------------------------------------------------

# (B, cap, E, counts): a decode at batch 1 and 4 (one pair an expert at
# most), a ragged prefill layout at batch 1 and 4
ROUTED = [
    (1, 8, 12, lambda g: (torch.randperm(12, generator=g)[None] < 4).int()),
    (4, 8, 12, lambda g: (torch.rand((4, 12), generator=g) < 0.3).int()),
    (1, 64, 6, lambda g: torch.tensor([[0, 1, 17, 32, 33, 64]], dtype=torch.int32)),
    (4, 16, 6, lambda g: torch.randint(0, 17, (4, 6), generator=g, dtype=torch.int32)
     * (torch.rand((4, 6), generator=g) < 0.7)),
]


def _rows_run_by_hand(counts: list, cap: int, bm: int) -> int:
    """The rows of the bm-row tiles of each expert's B * cap rows that hold
    a pair: row r holds one iff r % cap < counts[r // cap][e]."""
    B, E = len(counts), len(counts[0])
    total = 0
    for e in range(E):
        for t0 in range(0, B * cap, bm):
            rows = range(t0, min(t0 + bm, B * cap))
            if any(r % cap < counts[r // cap][e] for r in rows):
                total += len(rows)
    return total


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,cap,E,draw", ROUTED)
def test_moe_gmm_with_rows_is_the_product_on_filled_rows_and_zero_elsewhere(B, cap, E, draw, dtype):
    g = torch.Generator().manual_seed(B * cap + E)
    rows = draw(g)
    x = torch.randn((E, B * cap, 24), generator=g).to(dtype)
    w = torch.randn((E, 24, 40), generator=g).to(dtype)
    full = moe_gmm_plain(x, w)
    filled = torch.tensor([[c % cap < int(rows[c // cap, e]) for c in range(B * cap)] for e in range(E)])
    bm = 16 if dtype == torch.bfloat16 and B * cap <= 16 else 32
    want_rows = _rows_run_by_hand(rows.tolist(), cap, bm)
    for fn in (moe_gmm_plain, moe_gmm):
        tally = torch.zeros((), dtype=torch.int64)
        got = fn(x, w, rows, tally=tally)
        assert got.dtype == dtype and got.shape == full.shape
        assert torch.equal(got[filled], full[filled])
        assert not got[~filled].any()
        assert int(tally) == want_rows, fn.__name__
    assert torch.equal(moe_gmm(x, w, rows), moe_gmm_plain(x, w, rows))


def test_moe_gmm_rejects_rows_that_do_not_fit():
    x, w = torch.zeros((3, 8, 4)), torch.zeros((3, 4, 5))
    for rows, err in ((torch.zeros((3, 3), dtype=torch.int32), ValueError),  # 8 rows not a multiple of 3
                      (torch.zeros((2, 2), dtype=torch.int32), ValueError),  # not one count an expert
                      (torch.zeros((2, 3), dtype=torch.int64), TypeError)):
        with pytest.raises(err):
            moe_gmm(x, w, rows)
    with pytest.raises(ValueError):  # a tally counts routed tiles
        moe_gmm(x, w, tally=torch.zeros((), dtype=torch.int64))


def _draw_specs(specs, g):
    return {k: _draw_specs(v, g) if isinstance(v, dict) else torch.randn(v.shape, generator=g) / v.shape[0] ** 0.5
            for k, v in specs.items()}


def _without_rows(x, w, rows=None, *, tally=None):
    return moe_gmm(x, w)


@pytest.mark.parametrize("B,S", [(1, 1), (4, 1), (2, 12), (1, 40)])
@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "dbrx_132b", "granite_4_0_h_small"])
def test_moe_ffn_is_the_same_with_rows_as_without(arch, B, S, monkeypatch):
    """Every decode and prefill layout, dropless or at a capacity that drops."""
    cfg = get_smoke(arch).replace(dtype="float32")
    g = torch.Generator().manual_seed(B * S)
    params = _draw_specs(pmoe.moe_params(cfg), g)
    x = torch.randn((B, S, cfg.d_model), generator=g)
    with torch.no_grad():
        y, aux = pmoe.moe_ffn(params, x, cfg)
        monkeypatch.setattr(pmoe, "moe_gmm", _without_rows)
        y_all, aux_all = pmoe.moe_ffn(params, x, cfg)
    assert torch.equal(y, y_all) and torch.equal(aux, aux_all)


def test_moe_counters_count_the_rows_of_the_tiles_that_run():
    """granite-4.0-h's dropless layer, float32 (32-row tiles).  The router
    reads channel 0 alone: a token with a positive channel 0 goes to
    experts 0 and 1, one with a negative to 3 and 2.

    Prefill, B = 2, S = 12, row 0 seven positive tokens, row 1 twelve:
    counts [[7, 7, 5, 5], [12, 12, 0, 0]], 24 + 24 pairs; the most an
    expert received is 12, so each batch row lays an expert out at 16
    slots, 32 rows an expert: one tile, which runs for experts 0-3 (and
    not 4-7): 4 x 32 rows.  Decode, B = 2, S = 1, row 0 positive, row 1
    negative: counts [[1, 1, 0, 0], [0, 0, 1, 1]], 4 pairs, 8 slots a
    batch row, 16 rows an expert, one tile each for experts 0-3: 4 x 16
    rows.  The prefill again under grad: every row, 8 experts x 2 x 16."""
    cfg = get_smoke("granite_4_0_h_small").replace(dtype="float32")
    assert cfg.moe_dropless and cfg.n_experts == 8 and cfg.top_k == 2
    params = _draw_specs(pmoe.moe_params(cfg), torch.Generator().manual_seed(0))
    params["router"] = torch.zeros_like(params["router"])
    params["router"][0, :4] = torch.tensor([10.0, 5.0, -5.0, -10.0])
    sign = torch.ones((2, 12))
    sign[0, 7:] = -1
    prefill = torch.randn((2, 12, cfg.d_model), generator=torch.Generator().manual_seed(1))
    prefill[..., 0] = sign * (1 + prefill[..., 0].abs())
    decode = torch.randn((2, 1, cfg.d_model), generator=torch.Generator().manual_seed(2))
    decode[..., 0] = torch.tensor([[1.0], [-1.0]]) * (1 + decode[..., 0].abs())
    names = ("moe.routed_pairs", "moe.rows_computed", "moe.dropped")
    seen = [obs.metrics_dict()["counters"]]
    with torch.no_grad():
        pmoe.moe_ffn(params, prefill, cfg)
        seen.append(obs.metrics_dict()["counters"])
        pmoe.moe_ffn(params, decode, cfg)
        seen.append(obs.metrics_dict()["counters"])
    pmoe.moe_ffn({k: v if k == "shared" else v.requires_grad_() for k, v in params.items()}, prefill, cfg)
    seen.append(obs.metrics_dict()["counters"])
    moved = [{k: b.get(k, 0) - a.get(k, 0) for k in names} for a, b in zip(seen, seen[1:])]
    assert moved == [{"moe.routed_pairs": 48, "moe.rows_computed": 4 * 32, "moe.dropped": 0},
                     {"moe.routed_pairs": 4, "moe.rows_computed": 4 * 16, "moe.dropped": 0},
                     {"moe.routed_pairs": 48, "moe.rows_computed": 8 * 2 * 16, "moe.dropped": 0}]


def test_a_device_tally_is_folded_into_its_counter_on_read_and_zeroed_by_a_reset():
    tally = obs.device_tally("test_torch_moe.tally", "cpu")
    assert tally is obs.device_tally("test_torch_moe.tally", torch.device("cpu"))
    tally += 5
    assert obs.metrics_dict()["counters"]["test_torch_moe.tally"] == 5 and int(tally) == 0
    tally += 3
    assert obs.metrics_dict()["counters"]["test_torch_moe.tally"] == 8
    tally += 2
    obs.reset_metrics()
    assert int(tally) == 0 and "test_torch_moe.tally" not in obs.metrics_dict()["counters"]

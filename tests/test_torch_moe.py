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
    slots, gates = pmoe._route(probs, 2, pmoe.moe_capacity(pcfg, 32))
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
    slots, gates = pmoe._route(probs, 2, 8)
    assert slots[0, :, 0].tolist() == [0, 1, 2]  # expert 0, positions 0..2
    assert slots[0, :, 1].tolist() == [8, 9, 10]  # expert 1
    assert torch.allclose(gates, torch.full_like(gates, 0.5))

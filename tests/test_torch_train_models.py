"""The port's LM training path on the CPU, against the JAX package.

``LM.loss`` and the gradient of every parameter against
``jax.value_and_grad`` of the reference's ``LM.loss`` on the float32
smoke configs of six families (qwen2.5-3b, granite-moe, mamba2,
recurrentgemma, qwen2-vl with M-RoPE and the frontend stub on embeds,
hubert, encoder-only on embeds); forward parity for qwen2-vl and hubert and
prefill/decode parity for qwen2-vl; ``mrope_tables`` and ``layernorm``;
``params_to_jax`` as the inverse of ``params_from_jax``; and remat
``full`` and ``dots`` giving the gradients of ``none``.  Weights come from
the reference's ``LM.init`` through ``params_from_jax``; inputs are made
with numpy from a seed.

Tolerance 1e-4, relative and absolute (scaled by the larger of 1 and the
largest magnitude of the compared tensor), as in ``test_torch_models``;
granite-moe's gradients 5e-4: at its smoke config both packages' float32
gradients sit up to 1.7e-4 (the port) and 1.2e-4 (the reference) of a
leaf's largest |gradient| from a float64 run of the port's same function
(worst leaves: norm1 and norm2), and 2.0e-4 from each other, so 1e-4
cannot tell a fault from float32 rounding there; its loss holds at 1e-4.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jattn
import repro.models.layers as jlayers
from repro.configs import get_smoke as jax_get_smoke
from repro.models import LM as JaxLM
from repro_torch.configs import get_smoke
from repro_torch.models import LM, params_from_jax, params_to_jax
from repro_torch.models import attention as pattn
from repro_torch.models import layers as players

FAMILIES = ["qwen2_5_3b", "granite_moe_3b_a800m", "mamba2_1_3b", "recurrentgemma_2b", "qwen2_vl_2b", "hubert_xlarge"]
TOL = 1e-4
GRAD_TOL = {"granite_moe_3b_a800m": 5e-4}


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, float(np.abs(want).max())), rtol=tol)


@lru_cache(maxsize=None)
def _models(arch, remat="none"):
    """(JAX LM, its params, the port LM carrying them), float32."""
    jm = JaxLM(jax_get_smoke(arch).replace(dtype="float32"))
    jp = jm.init(jax.random.key(0))
    pm = LM(get_smoke(arch).replace(dtype="float32", remat=remat), device="cpu")
    params_from_jax(pm, jax.tree.map(np.asarray, jp))
    return jm, jp, pm


def _batch(cfg, B=2, S=16, seed=0):
    """Token batches, or frame/patch embeddings for the stub frontends, as
    the data pipeline makes them (labels in the vocab)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend_stub:
        return {
            "embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        }
    t = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return {"tokens": t, "labels": np.roll(t, -1, axis=1)}


def _port_loss_and_grads(pm, batch):
    """(loss, the reference tree of every parameter's gradient, zeros where
    the loss does not reach a parameter, as jax's zero cotangent)."""
    params = dict(pm.named_parameters())
    with torch.enable_grad():
        for p in params.values():
            p.requires_grad_(True)
        loss = pm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        for p in params.values():
            p.requires_grad_(False)
    named = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}
    return loss.detach(), pm.reference_tree(named)


def _tree_close(got, want, tol, path=""):
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in got:
        if isinstance(got[k], dict):
            _tree_close(got[k], want[k], tol, f"{path}/{k}")
        else:
            try:
                _close(got[k], want[k], tol)
            except AssertionError as e:
                raise AssertionError(f"{path}/{k}: {e}") from None


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    jm, jp, pm = _models(arch)
    batch = _batch(jm.cfg)
    jl, jg = jax.value_and_grad(jm.loss)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _port_loss_and_grads(pm, batch)
    _close(loss, jl)
    _tree_close(grads, jax.tree.map(np.asarray, jg), GRAD_TOL.get(arch, TOL))


def test_loss_with_mask_and_positions_matches_reference():
    """The optional ``mask`` (mean over kept positions) and explicit M-RoPE
    positions (3, B, S) on qwen2-vl's embeds."""
    jm, jp, pm = _models("qwen2_vl_2b")
    batch = _batch(jm.cfg)
    rng = np.random.default_rng(1)
    batch["mask"] = (rng.random((2, 16)) < 0.7).astype(np.float32)
    batch["positions"] = rng.integers(0, 64, (3, 2, 16)).astype(np.int32)
    jl, jg = jax.value_and_grad(jm.loss)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _port_loss_and_grads(pm, batch)
    _close(loss, jl)
    _tree_close(grads, jax.tree.map(np.asarray, jg), TOL)


@pytest.mark.parametrize("arch", ["qwen2_vl_2b", "hubert_xlarge"])
def test_forward_on_embeds_matches_reference(arch):
    jm, jp, pm = _models(arch)
    batch = _batch(jm.cfg, seed=3)
    jl, jaux = jm.forward(jp, None, embeds=jnp.asarray(batch["embeds"]))
    with torch.no_grad():
        lg, aux = pm(None, embeds=torch.from_numpy(batch["embeds"]))
    _close(lg, jl)
    _close(aux, jaux)


def test_qwen2_vl_prefill_and_decode_match_reference():
    """Token prefill (M-RoPE from positions broadcast to 3 streams) and
    three decode steps: last logits and logits per step."""
    jm, jp, pm = _models("qwen2_vl_2b")
    toks = np.random.default_rng(4).integers(0, jm.cfg.vocab, (2, 12)).astype(np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=16)
    with torch.no_grad():
        lg, cache = pm.prefill(torch.from_numpy(toks).long(), max_len=16)
        _close(lg, jl)
        for i in range(3):
            nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), jnp.int32(12 + i))
            lg, cache = pm.decode_step(cache, torch.from_numpy(nxt).long(), 12 + i)
            _close(lg, jl)


def test_mrope_tables_match_reference():
    pos = np.random.default_rng(5).integers(0, 1000, (3, 2, 7)).astype(np.int32)
    js, jc = jattn.mrope_tables(jnp.asarray(pos), (2, 3, 3), 16, 1_000_000.0)
    s, c = pattn.mrope_tables(torch.from_numpy(pos), (2, 3, 3), 16, 1_000_000.0)
    _close(s, js)
    _close(c, jc)


def test_layernorm_matches_reference():
    rng = np.random.default_rng(6)
    x = (3.0 + rng.standard_normal((2, 5, 24))).astype(np.float32)
    scale, bias = rng.standard_normal(24).astype(np.float32), rng.standard_normal(24).astype(np.float32)
    want = jlayers.layernorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    got = players.layernorm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    _close(got, want)
    bf = players.layernorm(torch.from_numpy(x).bfloat16(), torch.from_numpy(scale), torch.from_numpy(bias))
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["qwen2_vl_2b", "recurrentgemma_2b"])
def test_params_to_jax_inverts_params_from_jax(arch):
    jm, jp, pm = _models(arch)
    tree = params_to_jax(pm)
    assert jax.tree.structure(tree) == jax.tree.structure(jp)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)), tree, jp)
    again = params_from_jax(LM(pm.cfg, device="cpu", generator=torch.Generator().manual_seed(9)), tree)
    for (k, a), (_, b) in zip(pm.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), k


def test_params_to_jax_widens_bf16_exactly():
    pm = LM(get_smoke("qwen2_5_3b"), device="cpu", generator=torch.Generator().manual_seed(2))
    tree = params_to_jax(pm)
    assert tree["embed"].dtype == np.float32
    assert np.array_equal(tree["embed"], pm.top.embed.float().numpy())
    back = params_from_jax(LM(pm.cfg, device="cpu"), tree)
    assert torch.equal(back.top.embed, pm.top.embed) and back.top.embed.dtype == torch.bfloat16


@pytest.mark.parametrize("fault", ["extra_leaf", "missing_stacked_leaf", "repeats", "stacked_shape"])
def test_params_from_jax_refuses_a_wrong_stacked_tree(fault):
    """The stacked layout's mapping refuses a tree that does not give every
    parameter, with its exact shape, and nothing else."""
    _, jp, pm = _models("recurrentgemma_2b")
    bad = jax.tree.map(np.asarray, jp)
    blk = bad["stack0"][next(iter(bad["stack0"]))]
    key = next(k for k, v in blk.items() if not isinstance(v, dict))
    if fault == "extra_leaf":
        blk["spare"] = blk[key]
    elif fault == "missing_stacked_leaf":
        del blk[key]
    elif fault == "repeats":
        blk[key] = blk[key][:-1]
    else:
        blk[key] = blk[key][..., :-1]
    target = LM(pm.cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    before = [p.clone() for p in target.parameters()]
    with pytest.raises(ValueError):
        params_from_jax(target, bad)
    assert all(torch.equal(a, b) for a, b in zip(before, target.parameters())), "a refused tree wrote parameters"


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "recurrentgemma_2b"])
def test_remat_gives_the_gradients_of_none(arch, remat):
    _, _, plain = _models(arch)
    _, _, rematted = _models(arch, remat)
    batch = _batch(plain.cfg, seed=7)
    l0, g0 = _port_loss_and_grads(plain, batch)
    l1, g1 = _port_loss_and_grads(rematted, batch)
    _close(l1, l0, 1e-6)
    _tree_close(g1, jax.tree.map(lambda t: t.numpy(), g0), 1e-6)


def test_parameters_are_frozen_by_default():
    """The serving paths build no autograd graph: parameters are created
    with ``requires_grad=False`` (the trainer turns them on)."""
    pm = LM(get_smoke("qwen2_5_3b"), device="cpu")
    assert not any(p.requires_grad for p in pm.parameters())
    assert "top.frontend" in dict(LM(get_smoke("hubert_xlarge"), device="cpu").named_parameters())

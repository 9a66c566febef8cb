"""The port's LM stack on the CPU against the JAX package.

Layers (rope, rmsnorm, the three MLP activations), attention, and the
whole ``LM`` — ``forward`` (logits and the MoE aux loss), ``prefill``
(last logits and every cache leaf: k/v/pos, or the ssd states) and
``decode_step`` — on the ``SMOKE`` configs of the four dense archs, the
two MoE archs (granite-moe, dbrx), mamba2 and recurrentgemma, in float32.  The reference's weights come from ``LM.init`` and are
carried into the port by ``params_from_jax``; token inputs are made with
numpy from a seed.  Both packages compute in IEEE float32, in different
summation orders: tolerance 1e-4 relative and absolute, scaled by the
largest magnitude of the compared tensor (``_close``).
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
from repro_torch.configs import ALL_ARCHS, get_smoke
from repro_torch.kernels import flash_attention
from repro_torch.models import LM, params_from_jax
from repro_torch.models import attention as pattn
from repro_torch.models import layers as players

DENSE = ["gemma_7b", "granite_34b", "qwen2_5_3b", "starcoder2_15b"]
PORTED = DENSE + ["granite_moe_3b_a800m", "dbrx_132b", "mamba2_1_3b", "recurrentgemma_2b"]
UNPORTED = [a for a in ALL_ARCHS if a not in PORTED]
TOL = 1e-4


def _close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


def _cfg(arch):
    return jax_get_smoke(arch).replace(dtype="float32")


@lru_cache(maxsize=None)
def _models(arch):
    """(JAX LM, its params as jax arrays, the port LM carrying them)."""
    jm = JaxLM(_cfg(arch))
    jp = jm.init(jax.random.key(0))
    pm = LM(get_smoke(arch).replace(dtype="float32"), device="cpu")
    params_from_jax(pm, jax.tree.map(np.asarray, jp))
    return jm, jp, pm


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def _cache_close(pc, jc):
    """Every leaf of the port's cache against the reference's: the
    ring-buffer ``pos`` leaves exactly, the rest within ``_close``."""
    assert set(pc) == set(jc)
    for k in pc:
        if isinstance(pc[k], dict):
            _cache_close(pc[k], jc[k])
        elif k == "pos":
            assert torch.equal(pc[k], torch.from_numpy(np.array(jc[k])))
        else:
            _close(pc[k], jc[k])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_dim,theta", [(16, 10_000.0), (128, 1_000_000.0)])
def test_rope_tables_and_apply_rope(head_dim, theta):
    rng = np.random.default_rng(head_dim)
    pos = np.concatenate([np.arange(24), rng.integers(0, 4096, 8)]).astype(np.int32)
    js, jc = jattn.rope_tables(jnp.asarray(pos), head_dim, theta)
    ps, pc = pattn.rope_tables(torch.from_numpy(pos), head_dim, theta)
    _close(ps, js, 1e-5)
    _close(pc, jc, 1e-5)
    x = rng.normal(size=(2, len(pos), 3, head_dim)).astype(np.float32)
    want = jattn.apply_rope(jnp.asarray(x), js, jc)
    got = pattn.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(js)), torch.from_numpy(np.array(jc)))
    _close(got, want, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3
    scale = rng.normal(size=(48,)).astype(np.float32)
    want = jlayers.rmsnorm(jnp.asarray(x, jnp.dtype(dtype)), jnp.asarray(scale), 1e-6)
    got = players.rmsnorm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(scale), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, 1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_mlp(activation):
    rng = np.random.default_rng(2)
    specs = jlayers.mlp_params(32, 80, activation, "float32")
    params = {k: (rng.normal(size=s.shape) / np.sqrt(s.shape[0])).astype(np.float32) for k, s in specs.items()}
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    want = jlayers.mlp({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), activation)
    got = players.mlp({k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(x), activation)
    assert set(players.mlp_params(32, 80, activation, "float32")) == set(specs)
    _close(got, want)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    _close(players.gelu(torch.from_numpy(x)), jlayers.gelu(jnp.asarray(x)), 1e-6)


# ---------------------------------------------------------------------------
# attention and the LM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_attention_matches_reference(arch):
    jm, jp, pm = _models(arch)
    cfg = jm.cfg
    ap_j = jax.tree.map(lambda a: a[0], jp["stack0"]["b0_attn"]["attn"])
    ap_p = pm._params()[1][0]["attn"]
    x = np.random.default_rng(3).normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    js, jc = jattn.rope_tables(jnp.arange(12), cfg.head_dim_, cfg.rope_theta)
    ps, pc = pattn.rope_tables(torch.arange(12), cfg.head_dim_, cfg.rope_theta)
    want = jattn.attention(ap_j, jnp.asarray(x), cfg, sin=js, cos=jc)
    got = pattn.attention(ap_p, torch.from_numpy(x), cfg, sin=ps, cos=pc)
    _close(got, want)


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "gemma_7b"])
def test_decode_attention_matches_reference(arch):
    """The module-level one-token decode against a (B, S_max, KV, hd)
    cache; the port writes the cache in place and returns it."""
    jm, jp, pm = _models(arch)
    cfg = jm.cfg
    rng = np.random.default_rng(4)
    ap_j = jax.tree.map(lambda a: a[1], jp["stack0"]["b0_attn"]["attn"])
    ap_p = pm._params()[1][1]["attn"]
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    kv = [rng.normal(size=(2, 16, cfg.kv_heads, cfg.head_dim_)).astype(np.float32) for _ in range(2)]
    for position, window in ((9, None), (12, 5)):
        want, wc = jattn.decode_attention(
            ap_j, jnp.asarray(x), jattn.KVCache(*map(jnp.asarray, kv)), jnp.int32(position), cfg, window=window
        )
        cache = pattn.KVCache(*(torch.from_numpy(a.copy()) for a in kv))
        got, pc = pattn.decode_attention(ap_p, torch.from_numpy(x), cache, position, cfg, window=window)
        assert pc.k is cache.k
        _close(got, want)
        _close(pc.k, wc.k)
        _close(pc.v, wc.v)


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "granite_34b"])
def test_forward_with_embeds_and_positions_matches_reference(arch):
    jm, jp, pm = _models(arch)
    rng = np.random.default_rng(5)
    embeds = rng.normal(size=(2, 9, jm.cfg.d_model)).astype(np.float32)
    positions = np.sort(rng.integers(0, 200, 9)).astype(np.int32)
    want, _ = jm.forward(jp, embeds=jnp.asarray(embeds), positions=jnp.asarray(positions))
    got, _ = pm(embeds=torch.from_numpy(embeds), positions=torch.from_numpy(positions))
    _close(got, want)


@pytest.mark.parametrize("arch", PORTED)
def test_forward_matches_reference(arch):
    jm, jp, pm = _models(arch)
    toks = _tokens(jm.cfg, 2, 16)
    want, want_aux = jm.forward(jp, jnp.asarray(toks))
    got, aux = pm(torch.from_numpy(toks))
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5, abs=1e-6)
    assert (float(aux) > 0) == jm.cfg.is_moe
    _close(got, want)
    last, _ = pm(torch.from_numpy(toks), last_only=True)
    _close(last, np.asarray(want)[:, -1:])


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_and_decode_match_reference(arch):
    jm, jp, pm = _models(arch)
    cfg = jm.cfg
    B, S, steps = 2, 10, 3
    toks = _tokens(cfg, B, S + steps, seed=1)
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :S]), max_len=S + steps + 2)
    pl, pc = pm.prefill(torch.from_numpy(toks[:, :S]), max_len=S + steps + 2)
    _close(pl, jl)
    _cache_close(pc, jc)
    for t in range(steps):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, S + t]), jnp.int32(S + t))
        pl, pc = pm.decode_step(pc, torch.from_numpy(toks[:, S + t]), S + t)
        _close(pl, jl)
    _cache_close(pc, jc)


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_plus_decode_reproduces_forward(arch):
    """prefill + decode reproduce the teacher-forced forward
    (``tests/test_models_smoke.py:60``), in the port alone.  MoE configs
    get a capacity that drops nothing: the forward groups S + 2 tokens,
    prefill S and decode 1, so their capacities differ.  For
    recurrentgemma the identity holds only where the local-attention ring
    (L = min(S + steps, window)) maps prefill's slots as decode reads
    them, S <= L or S % L == 0 (ROADMAP C-ref-6); S = 16 fills its window
    of 16 exactly."""
    _, jp, pm = _models(arch)
    if pm.cfg.is_moe:
        cfg = pm.cfg.replace(capacity_factor=pm.cfg.n_experts / pm.cfg.top_k)
        pm = params_from_jax(LM(cfg, device="cpu"), jax.tree.map(np.asarray, jp))
    B, S, steps = 2, 16, 2
    if "local_attn" in pm.cfg.block_types:
        L = min(S + steps, pm.cfg.local_window)
        assert S <= L or S % L == 0
    toks = torch.from_numpy(_tokens(pm.cfg, B, S + steps, seed=7).astype(np.int64))
    full, _ = pm(toks)
    lg, cache = pm.prefill(toks[:, :S], max_len=S + steps)
    errs = [float((full[:, S - 1] - lg).abs().max())]
    for t in range(steps):
        lg, cache = pm.decode_step(cache, toks[:, S + t], S + t)
        errs.append(float((full[:, S + t] - lg).abs().max()))
    assert max(errs) < 1e-3 * max(1.0, float(full.abs().max())), errs


@pytest.mark.parametrize("arch", PORTED)
def test_exact_cache_keeps_the_last_entries(arch):
    """max_len == prompt length: the exactly-sized cache path."""
    jm, jp, pm = _models(arch)
    toks = _tokens(jm.cfg, 1, 8, seed=2)
    jl, jc = jm.prefill(jp, jnp.asarray(toks))
    pl, pc = pm.prefill(torch.from_numpy(toks))
    _close(pl, jl)
    _cache_close(pc, jc)


@pytest.mark.parametrize("arch", PORTED)
def test_param_shapes_and_cache_axes_match_reference(arch):
    jm, _, pm = _models(arch)

    def tree(t):
        return {k: tree(v) for k, v in t.items()} if isinstance(t, dict) else (tuple(t.shape), str(t.dtype))

    assert pm.param_shapes() == tree(jm.param_shapes())
    assert pm.cache_axes() == jm.cache_axes()
    cache = pm.init_cache(2, 32)
    jcache = jax.eval_shape(lambda: jm.init_cache(2, 32))
    assert jax.tree.map(lambda a: tuple(a.shape), cache) == jax.tree.map(lambda a: tuple(a.shape), jcache)
    # the module's per-layer parameters are the stacked leaves' slices
    stacked = pm.param_shapes()["stack0"][f"b0_{pm.block_types[0]}"]
    layer = pm.layers[0].tree()
    assert jax.tree.map(lambda t: tuple(t.shape), layer) == jax.tree.map(
        lambda s: s[0][1:], stacked, is_leaf=lambda x: isinstance(x, tuple)
    )
    assert len(pm.layers) == pm.cfg.n_layers


@pytest.mark.parametrize("arch", ["qwen2_vl_2b", "hubert_xlarge"])
def test_unported_families_raise(arch):
    """The two families this test once saw refused (M-RoPE, the frontend
    stub) now build, with the reference's parameter tree, frontend
    included; ``tests/test_torch_train_models.py`` holds them against the
    reference.  No architecture of the pool is refused any more."""
    assert UNPORTED == ["qwen2_vl_2b", "hubert_xlarge"]
    pm = LM(get_smoke(arch), device="cpu")
    jm = JaxLM(jax_get_smoke(arch))
    want = jax.eval_shape(jm.init, jax.random.key(0))
    assert pm.param_shapes() == jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), want)


def test_init_keeps_the_reference_distribution():
    """normal * scale / sqrt(fan_in), fan_in = the leading axis (for a
    stacked leaf: the layer count, as in the reference); zeros for
    norms and biases; the weights' dtype from the config."""
    cfg = get_smoke("qwen2_5_3b").replace(n_layers=4, vocab=4096)
    pm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    top, layers = pm._params()
    assert top["embed"].dtype == torch.bfloat16 and top["final_norm"].dtype == torch.float32
    assert float(top["embed"].float().std()) == pytest.approx(1 / np.sqrt(cfg.vocab), rel=0.05)
    wq = torch.stack([lp["attn"]["wq"] for lp in layers]).float()
    assert float(wq.std()) == pytest.approx(1 / np.sqrt(cfg.n_layers), rel=0.05)
    assert not layers[0]["attn"]["bq"].any() and not layers[0]["norm1"].any()
    again = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    assert torch.equal(again._params()[0]["embed"], top["embed"])


def test_params_from_jax_rejects_a_wrong_tree():
    jm, jp, pm = _models("qwen2_5_3b")
    bad = jax.tree.map(np.asarray, jp)
    bad["final_norm"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError):
        params_from_jax(LM(pm.cfg, device="cpu"), bad)
    del bad["final_norm"]
    with pytest.raises(ValueError):
        params_from_jax(LM(pm.cfg, device="cpu"), bad)


def test_bf16_weights_carry_losslessly():
    jm = JaxLM(jax_get_smoke("qwen2_5_3b"))
    jp = jm.init(jax.random.key(3))
    pm = params_from_jax(LM(get_smoke("qwen2_5_3b"), device="cpu"), jax.tree.map(np.asarray, jp))
    want = np.asarray(jp["stack0"]["b0_attn"]["mlp"]["wo"][1], np.float32)
    got = pm._params()[1][1]["mlp"]["wo"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want)


def test_prefill_counts_no_launch_on_cpu():
    _, _, pm = _models("qwen2_5_3b")
    before = flash_attention.launches
    pm.prefill(torch.zeros((1, 4), dtype=torch.int64), max_len=8)
    assert flash_attention.launches == before


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "mamba2_1_3b", "recurrentgemma_2b"])
def test_moe_and_ssd_paths_count_no_launch_on_cpu(arch):
    """On CPU tensors every kernel wrapper takes its plain version."""
    from repro_torch.kernels import moe_gmm, rglru_scan, ssd_scan

    _, _, pm = _models(arch)
    counted = (flash_attention, moe_gmm, ssd_scan, rglru_scan)
    before = [k.launches for k in counted]
    _, cache = pm.prefill(torch.zeros((2, 4), dtype=torch.int64), max_len=8)
    pm.decode_step(cache, torch.zeros(2, dtype=torch.int64), 4)
    assert [k.launches for k in counted] == before

"""The port's RG-LRU block, ``rglru_scan`` and recurrentgemma LM on the CPU
against the JAX package.

``rglru_scan_plain`` and the ``rglru_scan`` wrapper given CPU tensors:
against the Pallas kernel (interpret mode, ``block_w = block_t = 16``, as
``tests/test_kernels.py:48-54`` runs it) and the sequential oracle
``ref.rglru_scan_ref`` at the reference's 1e-4; ragged T and W and bf16
inputs against the oracle alone (the Pallas kernel needs exact tiles).
Then ``rglru_scan_ref`` with ``h0``, ``_gates``, ``rglru_block`` with its
state and ``rglru_decode_step`` against the reference on the
recurrentgemma smoke config, and the whole ``LM`` (forward, prefill with
every cache leaf, decode across the local-attention ring's wrap, also at
prompt lengths that the window does not divide: ROADMAP C-ref-6).  The
decay parameters are drawn (``perturb_rglru``) so that a_t lies in about
0.4-0.999: at the reference init every a_t is near 0.005 and a wrong
carry would not show.  Weights and inputs come from numpy seeds; float32,
tolerance 1e-4 scaled by the largest magnitude (``_close``).
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import perturb_rglru
from repro.configs import get_smoke as jax_get_smoke
from repro.kernels import ref as jax_ref
from repro.kernels import rglru_scan as jax_rglru_scan
from repro.models import LM as JaxLM
from repro.models import rglru as jrglru
from repro_torch.configs import get_smoke
from repro_torch.kernels import flash_attention, rglru_scan, rglru_scan_plain
from repro_torch.kernels import ref as port_ref
from repro_torch.models import LM, params_from_jax
from repro_torch.models import rglru as prglru

ARCH = "recurrentgemma_2b"
GRID = [(1, 32, 16), (2, 128, 64), (3, 64, 256)]  # tests/test_kernels.py:48
RAGGED = [(2, 37, 45), (1, 5, 3), (3, 20, 130)]


def _close(got, want, tol=1e-4):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, float(np.abs(want).max())), rtol=tol)


def _scan_inputs(B, T, W, seed):
    """The kernel test's distributions: a ~ U(0.2, 0.999), b normal."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.2, 0.999, (B, T, W)).astype(np.float32), rng.normal(size=(B, T, W)).astype(np.float32)


def _port_both(a, b):
    """The plain version and the wrapper on CPU tensors: neither launches."""
    before = rglru_scan.launches
    outs = {"plain": rglru_scan_plain(a, b), "wrapper": rglru_scan(a, b)}
    assert rglru_scan.launches == before
    return outs


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,T,W", GRID)
def test_rglru_scan_matches_pallas_kernel_and_oracle(B, T, W):
    a, b = _scan_inputs(B, T, W, seed=T + W)
    pallas = np.asarray(jax_rglru_scan(jnp.asarray(a), jnp.asarray(b), block_w=16, block_t=16))
    oracle = np.asarray(jax_ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(port_ref.rglru_scan_ref(ta, tb).numpy(), oracle, atol=1e-4, rtol=1e-4)
    for name, h in _port_both(ta, tb).items():
        assert h.dtype == torch.float32 and h.shape == (B, T, W)
        np.testing.assert_allclose(h.numpy(), pallas, atol=1e-4, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(h.numpy(), oracle, atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,W", RAGGED)
def test_rglru_scan_ragged_and_bf16_match_oracle(B, T, W, dtype):
    """T and W that no 16-wide tile divides, in float32 and bfloat16: the
    oracle sees the same (rounded) values, cast to float32 as the kernel
    casts them."""
    a, b = _scan_inputs(B, T, W, seed=T * W)
    ta, tb = torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype)
    oracle = np.asarray(jax_ref.rglru_scan_ref(jnp.asarray(ta.float().numpy()), jnp.asarray(tb.float().numpy())))
    np.testing.assert_allclose(port_ref.rglru_scan_ref(ta, tb).numpy(), oracle, atol=1e-4, rtol=1e-4)
    for name, h in _port_both(ta, tb).items():
        assert h.dtype == torch.float32
        np.testing.assert_allclose(h.numpy(), oracle, atol=1e-4, rtol=1e-4, err_msg=name)


def test_rglru_scan_reads_strided_views():
    """a and b as (B, T, W) views of (T, B, W) storage."""
    a, b = _scan_inputs(3, 24, 40, seed=9)
    oracle = np.asarray(jax_ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b)))
    ta = torch.from_numpy(np.ascontiguousarray(a.transpose(1, 0, 2))).transpose(0, 1)
    tb = torch.from_numpy(np.ascontiguousarray(b.transpose(1, 0, 2))).transpose(0, 1)
    for name, h in _port_both(ta, tb).items():
        assert h.is_contiguous()
        np.testing.assert_allclose(h.numpy(), oracle, atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("shapes", [((2, 8, 4), (2, 8, 5)), ((8, 4), (8, 4))])
def test_rglru_scan_rejects_mismatched_shapes(shapes):
    with pytest.raises(ValueError):
        rglru_scan(torch.zeros(shapes[0]), torch.zeros(shapes[1]))


@pytest.mark.parametrize("with_h0", [False, True])
def test_model_scan_ref_matches_reference(with_h0):
    """``models.rglru.rglru_scan_ref`` folds ``h0`` into ``b[:, 0]`` as the
    reference's associative scan does."""
    a, b = _scan_inputs(2, 33, 24, seed=4)
    h0 = np.random.default_rng(5).normal(size=(2, 24)).astype(np.float32) if with_h0 else None
    want = jrglru.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b), None if h0 is None else jnp.asarray(h0))
    tb = torch.from_numpy(b)
    got = prglru.rglru_scan_ref(torch.from_numpy(a), tb, None if h0 is None else torch.from_numpy(h0))
    _close(got, want)
    assert torch.equal(tb, torch.from_numpy(b))  # b is not written


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------


def _cfg():
    return jax_get_smoke(ARCH).replace(dtype="float32")


def _pcfg():
    return get_smoke(ARCH).replace(dtype="float32")


def _block_params(seed=0):
    """Block weights from numpy at the reference's init scales, with the
    decay parameters drawn by ``perturb_rglru``."""
    rng = np.random.default_rng(seed)
    p = {}
    for k, s in jrglru.rglru_params(_cfg()).items():
        p[k] = (rng.normal(size=s.shape) * s.scale / np.sqrt(s.shape[0])).astype(np.float32)
    return perturb_rglru({"rglru": p}, seed + 1)["rglru"]


def _jp(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _pp(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def test_rglru_params_match_reference():
    want = jrglru.rglru_params(_cfg())
    got = prglru.rglru_params(_pcfg())
    assert set(got) == set(want)
    for k in want:
        w, g = want[k], got[k]
        assert (g.shape, g.axes, g.dtype, g.init, g.scale) == (w.shape, w.axes, w.dtype, w.init, w.scale), k
    assert (got["lam"].init, got["gate_a_w"].init) == ("ones", "zeros")


def test_gates_match_reference():
    """a_t and b_t in float32, with ``lam`` also past 20, where torch's
    ``F.softplus`` would switch to the identity."""
    p = _block_params(seed=1)
    p["lam"][:4] = [21.0, 25.0, 30.0, -30.0]
    xr = np.random.default_rng(2).normal(size=(2, 9, p["lam"].shape[0])).astype(np.float32) * 2
    ja, jb = jrglru._gates(_jp(p), jnp.asarray(xr))
    pa, pb = prglru._gates(_pp(p), torch.from_numpy(xr))
    assert pa.dtype == pb.dtype == torch.float32
    _close(pa, ja, 1e-5)
    _close(pb, jb, 1e-5)
    a = pa[..., 4:]
    assert float(a.min()) > 0.3 and float(a.max()) < 1.0  # the drawn decays carry


@pytest.mark.parametrize("T", [1, 16, 37])
def test_rglru_block_with_state_matches_reference(T):
    cfg, pcfg = _cfg(), _pcfg()
    p = _block_params(seed=T)
    x = np.random.default_rng(T + 1).normal(size=(2, T, cfg.d_model)).astype(np.float32)
    jy, jst = jrglru.rglru_block(_jp(p), jnp.asarray(x), cfg, return_state=True)
    before = rglru_scan.launches
    py, pst = prglru.rglru_block(_pp(p), torch.from_numpy(x), pcfg, return_state=True)
    assert rglru_scan.launches == before
    _close(py, jy)
    assert set(pst) == set(jst) == {"h", "conv"}
    for k in jst:
        _close(pst[k], jst[k])
    _close(prglru.rglru_block(_pp(p), torch.from_numpy(x), pcfg), jy)


def test_rglru_decode_step_matches_reference():
    """A prefill's state carried through four decode steps."""
    cfg, pcfg = _cfg(), _pcfg()
    p = _block_params(seed=3)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    _, jst = jrglru.rglru_block(_jp(p), jnp.asarray(x), cfg, return_state=True)
    _, pst = prglru.rglru_block(_pp(p), torch.from_numpy(x), pcfg, return_state=True)
    for _ in range(4):
        xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jy, jst = jrglru.rglru_decode_step(_jp(p), jnp.asarray(xt), jst, cfg)
        py, pst = prglru.rglru_decode_step(_pp(p), torch.from_numpy(xt), pst, pcfg)
        assert py.shape == (2, 1, cfg.d_model)
        _close(py, jy)
        for k in jst:
            _close(pst[k], jst[k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_state_init_matches_reference(dtype):
    want = jrglru.rglru_state_init(_cfg().replace(dtype=dtype), 3)
    got = prglru.rglru_state_init(_pcfg().replace(dtype=dtype), 3)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in got.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()
    }
    assert not any(v.any() for v in got.values())


# ---------------------------------------------------------------------------
# the recurrentgemma LM
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _models():
    """(JAX LM, its params with drawn decays, the port LM carrying them)."""
    jm = JaxLM(_cfg())
    params = perturb_rglru(jax.tree.map(np.asarray, jm.init(jax.random.key(0))), seed=11)
    pm = params_from_jax(LM(_pcfg(), device="cpu"), params)
    return jm, jax.tree.map(jnp.asarray, params), pm


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, _cfg().vocab, (B, S)).astype(np.int32)


def _cache_close(pc, jc):
    """Every cache leaf: the ring's ``pos`` leaves exactly, the rest within ``_close``."""
    assert set(pc) == set(jc)
    for k in pc:
        if isinstance(pc[k], dict):
            _cache_close(pc[k], jc[k])
        elif k == "pos":
            assert torch.equal(pc[k], torch.from_numpy(np.array(jc[k]))), (pc[k], jc[k])
        else:
            _close(pc[k], jc[k])


def test_lm_forward_matches_reference_past_the_window():
    """32 tokens against a window of 16: the local-attention blocks mask."""
    jm, jp, pm = _models()
    toks = _tokens(2, 32, seed=0)
    want, _ = jm.forward(jp, jnp.asarray(toks))
    got, aux = pm(torch.from_numpy(toks))
    assert float(aux) == 0.0
    _close(got, want)


@pytest.mark.parametrize(
    "S,max_len,steps",
    [(12, 40, 5), (16, 40, 2), (32, 40, 2), (20, 40, 4), (23, 40, 3), (12, 12, 0)],
    ids=["short-wrap", "full-wrap", "twice-full", "C-ref-6-S20", "C-ref-6-S23", "exact"],
)
def test_lm_prefill_and_decode_match_reference(S, max_len, steps):
    """Prefill (last logits, every cache leaf) and greedy decode across the
    ring's wrap (L = min(max_len, 16)).  At S = 20 and 23 the reference's
    ring mapping is misaligned (S % 16 != 0, C-ref-6): the port follows it
    slot for slot."""
    jm, jp, pm = _models()
    toks = _tokens(2, S, seed=S)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=max_len)
    pl, pc = pm.prefill(torch.from_numpy(toks), max_len=max_len)
    assert pc["stack0"]["b2_local_attn"]["k"].shape[2] == min(max_len, 16)
    _close(pl, jl)
    _cache_close(pc, jc)
    for t in range(steps):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        assert np.array_equal(pl.argmax(-1).numpy(), nxt)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), jnp.int32(S + t))
        pl, pc = pm.decode_step(pc, torch.from_numpy(nxt), S + t)
        _close(pl, jl)
    _cache_close(pc, jc)


def test_misaligned_ring_keeps_the_reference_slots():
    """C-ref-6: prefill S = 20 into a ring of 16 leaves positions 4..19 in
    slots 0..15; decode at 20 then writes slot 4 (evicting position 8,
    still inside the window) and the stale position 4 stays in slot 0."""
    _, _, pm = _models()
    toks = torch.from_numpy(_tokens(1, 26, seed=3))
    _, cache = pm.prefill(toks[:, :20], max_len=40)
    for t in range(6):
        pm.decode_step(cache, toks[:, 20 + t], 20 + t)
    want = [4, 5, 6, 7, 20, 21, 22, 23, 24, 25, 14, 15, 16, 17, 18, 19]
    for i in range(cache["stack0"]["b2_local_attn"]["pos"].shape[0]):
        assert cache["stack0"]["b2_local_attn"]["pos"][i].tolist() == want


def test_lm_counts_no_launch_on_cpu():
    _, _, pm = _models()
    before = (rglru_scan.launches, flash_attention.launches)
    _, cache = pm.prefill(torch.zeros((2, 18), dtype=torch.int64), max_len=24)
    pm.decode_step(cache, torch.zeros(2, dtype=torch.int64), 18)
    assert (rglru_scan.launches, flash_attention.launches) == before


def test_two_stack_plan_loads_in_reference_order():
    """8 layers: ``(rglru, rglru, local_attn) x 2`` then ``(rglru, rglru)
    x 1``, as recurrentgemma-2b's 26 are 8 repeats and a remainder of two.
    ``params_from_jax`` slices every repeat of the first stack before the
    second, and forward and prefill agree with the reference."""
    jm = JaxLM(_cfg().replace(n_layers=8))
    params = perturb_rglru(jax.tree.map(np.asarray, jm.init(jax.random.key(1))), seed=12)
    pm = params_from_jax(LM(_pcfg().replace(n_layers=8), device="cpu"), params)
    assert [(st.pattern, st.repeats) for st in pm.stacks] == [
        (("rglru", "rglru", "local_attn"), 2), (("rglru", "rglru"), 1)
    ]
    assert pm.block_types == ["rglru", "rglru", "local_attn"] * 2 + ["rglru", "rglru"]
    lam = [layer.tree()["rglru"]["lam"] for bt, layer in zip(pm.block_types, pm.layers) if bt == "rglru"]
    want = [params["stack0"][f"b{j}_rglru"]["rglru"]["lam"][r] for r in range(2) for j in range(2)]
    want += [params["stack1"][f"b{j}_rglru"]["rglru"]["lam"][0] for j in range(2)]
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(lam, want))
    jp = jax.tree.map(jnp.asarray, params)
    toks = _tokens(2, 20, seed=4)
    want_logits, _ = jm.forward(jp, jnp.asarray(toks))
    got, _ = pm(torch.from_numpy(toks))
    _close(got, want_logits)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=24)
    pl, pc = pm.prefill(torch.from_numpy(toks), max_len=24)
    _close(pl, jl)
    _cache_close(pc, jc)

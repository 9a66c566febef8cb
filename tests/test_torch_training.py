"""The port's training substrate on the CPU, against the JAX package.

The analogues of the 14 tests of ``tests/test_training.py`` (optimizer
schedule, loss falling, accumulation, int8 compression, checkpoints,
fault tolerance, data replay) run on ``repro_torch``; then the port
against the reference: the int8 values of ``quantize``, three train steps
of ``make_train_step`` from the same initial parameters
(``params_from_jax``) on the same numpy batches (plain, ``accum_steps=2``
and ``compress_grads``), and a checkpoint written by either package
restored by the other.

Train-step parity runs in float32 at lr 1e-5: both packages compute in
IEEE fp32 in different orders, and Adam's first update is about
lr * sign(g), so a near-zero gradient of opposite sign in the two moves a
parameter by 2 * lr; parameters and losses within 1e-4 (absolute, and
relative to the largest magnitude above 1), 1e-3 with ``compress_grads``
(a gradient on an int8 rounding tie may land one step apart).  At that
lr the parameters move by a few 1e-5, inside those bounds, so the same
run also holds the moments m and v within 1e-4 of each leaf's largest
magnitude (m and v are linear in g and g * g: no sign to flip).

What each step changed is held separately, at lr 1e-3 with both packages
started from the reference's state before every step: the update
``p_after - p_before`` within 1e-2 of the step's lr (plus 2 ulp of the
parameter) wherever sqrt(v_hat) is at least 1e-2 of its leaf's largest,
that is wherever Adam's direction is not decided by a gradient near 0.
With ``compress_grads`` an entry whose int8 gradient lands one step apart
(at most 1% of a leaf) may differ in m and v by a few int8 steps, and is
left out of the update check.
A no-op, a sign flip, a missing bias correction, a wrong b2 or a missing
weight decay each fail that check (``test_update_check_catches_a_wrong_update``).
"""

import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.training.checkpoint as jckpt
from repro.distributed.compression import quantize as jax_quantize
from repro.models import LM as JaxLM
from repro.training import OptConfig as JaxOptConfig
from repro.training import adamw_init as jax_adamw_init
from repro.training import make_train_step as jax_make_train_step
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.distributed.compression import dequantize, error_feedback_update, quantize
from repro_torch.models import LM, ModelConfig, params_from_jax
import repro_torch.training.train_loop as port_train_loop
from repro_torch.training import OptConfig, adamw_init, adamw_update, lr_at, make_train_step
from repro_torch.training.checkpoint import CheckpointManager, latest_step, restore_checkpoint, save_checkpoint
from repro_torch.training.fault_tolerance import HeartbeatMonitor, PreemptionGuard, plan_rescale
from repro_torch.training.train_loop import load_state_tree, state_like, state_tree

TINY = ModelConfig(
    name="tiny", family="dense", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
    d_ff=64, vocab=64,
)
TINY32 = TINY.replace(dtype="float32")


def _batch(seed=0, B=4, S=16, vocab=64):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return {"tokens": t, "labels": np.roll(t, -1, axis=1)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _model(cfg=TINY, seed=0):
    return LM(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


def _opt(model):
    return adamw_init(dict(model.named_parameters()))


# ---------------------------------------------------------------------------
# analogues of tests/test_training.py
# ---------------------------------------------------------------------------


def test_lr_schedule_shape():
    cfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    assert float(lr_at(cfg, torch.tensor(0))) == pytest.approx(0.0)
    assert float(lr_at(cfg, torch.tensor(10))) == pytest.approx(1e-3, rel=1e-3)
    assert float(lr_at(cfg, torch.tensor(100))) == pytest.approx(1e-4, rel=1e-2)


def test_training_reduces_loss():
    model = _model()
    opt = _opt(model)
    step = make_train_step(model, OptConfig(lr=3e-3, warmup_steps=5, total_steps=60))
    batch = _torch_batch(_batch())
    losses = []
    for _ in range(40):
        opt, m = step(opt, batch)  # overfit one batch
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_grad_accum_matches_full_batch():
    batch = _torch_batch(_batch(B=8))
    m1, m2 = _model(), _model()
    _, r1 = make_train_step(m1, OptConfig(lr=1e-3))(_opt(m1), batch)
    _, r2 = make_train_step(m2, OptConfig(lr=1e-3), accum_steps=2)(_opt(m2), batch)
    assert float(r1["loss"]) == pytest.approx(float(r2["loss"]), rel=1e-2)
    d = max(float((a.detach().float() - b.detach().float()).abs().max())
            for a, b in zip(m1.parameters(), m2.parameters()))
    assert d < 2e-2


def test_quantize_roundtrip_error_bounded(rng):
    x = torch.from_numpy(rng.normal(size=(128, 64)).astype(np.float32))
    q, s = quantize(x)
    err = torch.max(torch.abs(dequantize(q, s) - x))
    assert float(err) <= float(s) / 2 + 1e-6


def test_error_feedback_accumulates():
    g = {"w": torch.full((8, 8), 0.001)}
    r = {"w": torch.zeros((8, 8))}
    total = torch.zeros((8, 8))
    for _ in range(50):
        d, r = error_feedback_update(g, r)
        total = total + d["w"]
    # EF: the long-run average of decompressed grads matches the signal
    assert float(torch.mean(total)) == pytest.approx(0.001 * 50, rel=0.05)


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": {"c": torch.ones((2, 2), dtype=torch.bfloat16), "step": torch.tensor(7, dtype=torch.int32)},
    }
    save_checkpoint(tmp_path, 5, tree)
    assert latest_step(tmp_path) == 5
    got = restore_checkpoint(tmp_path, 5, tree)
    for k in ("a",):
        assert torch.equal(got[k], tree[k])
    assert torch.equal(got["b"]["c"], tree["b"]["c"]) and got["b"]["c"].dtype == torch.bfloat16
    assert int(got["b"]["step"]) == 7 and got["b"]["step"].shape == ()


def test_checkpoint_detects_corruption(tmp_path):
    tree = {"a": torch.ones(4)}
    save_checkpoint(tmp_path, 1, tree)
    f = tmp_path / "step_00000001" / "00000.npy"
    data = bytearray(f.read_bytes())
    data[-1] ^= 0xFF
    f.write_bytes(bytes(data))
    with pytest.raises(IOError, match="corruption"):
        restore_checkpoint(tmp_path, 1, tree)


def test_checkpoint_elastic_reshard(tmp_path):
    """Save one layout, restore into another placement: a transposed view
    is stored unstrided, and restores onto the device and dtype of the
    new job's ``like`` (here meta shapes, float64 on the CPU)."""
    x = torch.arange(16.0).reshape(4, 4).t()
    save_checkpoint(tmp_path, 2, {"x": x})
    like = {"x": torch.empty((4, 4), dtype=torch.float64, device="meta")}
    got = restore_checkpoint(tmp_path, 2, like, device="cpu")
    np.testing.assert_allclose(got["x"].numpy(), np.arange(16.0).reshape(4, 4).T)
    assert got["x"].dtype == torch.float64 and got["x"].is_contiguous()


def test_checkpoint_manager_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    tree = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    steps = sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]


def test_checkpoint_atomicity_no_partial(tmp_path):
    """A .tmp directory must never be picked up by latest_step."""
    (tmp_path / "step_00000009.tmp").mkdir(parents=True)
    assert latest_step(tmp_path) is None


def test_preemption_guard():
    g = PreemptionGuard(signals=(signal.SIGUSR1,))
    try:
        assert not g.should_stop
        os.kill(os.getpid(), signal.SIGUSR1)
        assert g.should_stop
    finally:
        g.restore()


def test_heartbeat_monitor_dead_and_stragglers():
    t = [0.0]
    mon = HeartbeatMonitor(timeout_s=10, straggler_factor=2.0, clock=lambda: t[0])
    for h, st in (("h0", 1.0), ("h1", 1.1), ("h2", 5.0)):
        mon.beat(h, st)
    assert mon.stragglers() == ["h2"]
    t[0] = 5.0
    mon.beat("h0", 1.0)
    mon.beat("h2", 5.0)
    t[0] = 14.0
    assert mon.dead() == ["h1"]
    assert set(mon.alive()) == {"h0", "h2"}


def test_plan_rescale():
    p = plan_rescale(10, 4, model_axis=16)
    assert p["mesh_shape"] == (2, 16)
    assert p["devices_idle"] == 8
    assert plan_rescale(3, 4, model_axis=16) == {}


def test_train_resume_replays_data():
    """Determinism: restart from checkpoint sees identical batches."""
    cfg = DataConfig(vocab=64, seq_len=8, global_batch=4, seed=3)
    b_direct = SyntheticTokenPipeline(cfg).batch_at(17)
    p2 = SyntheticTokenPipeline(cfg).start(from_step=17)
    s, b_stream = p2.next()
    p2.stop()
    assert s == 17
    np.testing.assert_array_equal(b_direct["tokens"], b_stream["tokens"])


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------


def test_quantize_int8_values_equal_the_reference(rng):
    """Per-tensor scale and round-half-even: the same int8 values, ties included."""
    x = rng.normal(size=(64, 48)).astype(np.float32)
    x[0, :8] = np.float32(np.abs(x).max()) * np.array([0.5, -0.5, 1.5, 2.5, -2.5, 3.5, 0, 1]) / 127
    jq, js = jax_quantize(jnp.asarray(x))
    q, s = quantize(torch.from_numpy(x))
    assert np.array_equal(q.numpy(), np.asarray(jq)) and q.dtype == torch.int8
    assert float(s) == float(js)


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, float(np.abs(want).max())), rtol=tol)


def _tree_close(port_tree, ref_tree, tol):
    assert set(port_tree) == set(ref_tree)
    for k in port_tree:
        if isinstance(port_tree[k], dict):
            _tree_close(port_tree[k], ref_tree[k], tol)
        else:
            _close(port_tree[k], ref_tree[k], tol)


def _leaf_pairs(port_tree, ref_tree, path=""):
    """(path, port leaf as float32 numpy, reference leaf as float32 numpy)."""
    assert set(port_tree) == set(ref_tree), path
    for k in sorted(port_tree):
        if isinstance(port_tree[k], dict):
            yield from _leaf_pairs(port_tree[k], ref_tree[k], f"{path}/{k}")
        else:
            yield f"{path}/{k}", port_tree[k].float().numpy(), np.asarray(ref_tree[k], np.float32)


FLIP_SHARE = 1e-2  # compress_grads: at most this share of a leaf's entries on an int8 tie
FLIP_STEP = 4 / 127  # and there m and v within a few int8 steps of the leaf's largest


def _moments_close(port_opt, ref_opt, tol, compressed=False):
    """m and v, each leaf within ``tol`` of its own largest magnitude.  With
    ``compressed``, an entry whose int8 gradient landed one step apart in
    the two packages may differ by a few int8 steps, on at most
    ``FLIP_SHARE`` of a leaf.  Returns those entries, by leaf path."""
    flipped = {}
    for part in ("m", "v"):
        for path, got, want in _leaf_pairs(port_opt[part], ref_opt[part]):
            top = float(np.abs(want).max())
            gap = np.abs(got - want)
            off = gap > tol * top
            if compressed:
                assert off.mean() <= FLIP_SHARE and (gap[off] <= FLIP_STEP * top).all(), (
                    f"{part}{path}: {int(off.sum())} of {off.size} entries beyond {tol} of {top:.3e}, "
                    f"largest gap {gap.max():.3e}")
                flipped[path] = flipped.get(path, False) | off
            else:
                assert not off.any(), f"{part}{path}: {gap.max():.3e} beyond {tol} of {top:.3e}"
    return flipped


@pytest.mark.parametrize(
    "mode,kw,tol",
    [("plain", {}, 1e-4), ("accum2", {"accum_steps": 2}, 1e-4), ("compress", {"compress_grads": True}, 1e-3)],
)
def test_train_steps_match_reference(mode, kw, tol):
    jm = JaxLM(TINY32)
    jp = jm.init(jax.random.key(0))
    model = params_from_jax(_model(TINY32), jax.tree.map(np.asarray, jp))
    opt_kw = dict(lr=1e-5, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jm, JaxOptConfig(**opt_kw), **kw))
    step = make_train_step(model, OptConfig(**opt_kw), **kw)
    jopt, opt = jax_adamw_init(jp), _opt(model)
    for i in range(3):
        batch = _batch(seed=i, B=4)
        jp, jopt, jm_ = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
        opt, m = step(opt, _torch_batch(batch))
        _close(m["loss"], jm_["loss"], tol)
        _close(m["grad_norm"], jm_["grad_norm"], tol)
    tree = state_tree(model, opt)
    _tree_close(tree["params"], jax.tree.map(np.asarray, jp), tol)
    _tree_close(tree["opt"]["master"], jax.tree.map(np.asarray, jopt["master"]), tol)
    _moments_close(tree["opt"], jax.tree.map(np.asarray, jopt), tol, compressed="compress_grads" in kw)
    assert int(tree["opt"]["step"]) == int(jopt["step"]) == 3


UPDATE_LR = 1e-3
UPDATE_TOL = 1e-2  # of the step's lr, on the update where Adam's direction is decided
V_FLOOR = 1e-2  # sqrt(v_hat) below this share of its leaf's largest: a gradient near 0


def _synced_steps(kw, tol, n_steps=3):
    """``n_steps`` train steps of both packages, each from the reference's
    state: loss, grad norm, m and v within ``tol``, and the update each
    step made within ``UPDATE_TOL`` of its lr where sqrt(v_hat) is at least
    ``V_FLOOR`` of its leaf's largest (and, with ``compress_grads``, the
    gradient's int8 value is the same in both).  Returns the number of
    entries the update check held."""
    jm = JaxLM(TINY32)
    jp = jm.init(jax.random.key(0))
    model = params_from_jax(_model(TINY32), jax.tree.map(np.asarray, jp))
    cfg = OptConfig(lr=UPDATE_LR, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jm, JaxOptConfig(**dataclasses.asdict(cfg)), **kw))
    step = make_train_step(model, cfg, **kw)
    jopt, opt = jax_adamw_init(jp), _opt(model)
    held = 0
    for i in range(n_steps):
        batch = _batch(seed=10 + i, B=4)
        before = jax.tree.map(np.asarray, jp)
        jp, jopt, jm_ = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
        opt, m = step(opt, _torch_batch(batch))
        ref = {"params": jax.tree.map(np.asarray, jp), "opt": jax.tree.map(np.asarray, jopt)}
        got = state_tree(model, opt)
        _close(m["loss"], jm_["loss"], tol)
        _close(m["grad_norm"], jm_["grad_norm"], tol)
        flipped = _moments_close(got["opt"], ref["opt"], tol, compressed="compress_grads" in kw)
        lr_t = float(lr_at(cfg, torch.tensor(i + 1)))
        b2c = 1 - cfg.b2 ** (i + 1)
        v_of = dict((path, want) for path, _, want in _leaf_pairs(got["opt"]["v"], ref["opt"]["v"]))
        for (path, p_got, p_ref), (_, _, p0) in zip(_leaf_pairs(got["params"], ref["params"]),
                                                    _leaf_pairs(got["params"], before)):
            root = np.sqrt(v_of[path] / b2c)
            keep = (root >= V_FLOOR * root.max()) & ~flipped.get(path, np.zeros(root.shape, bool))
            err = np.abs((p_got - p0) - (p_ref - p0))[keep]
            allowed = UPDATE_TOL * lr_t + 2 * np.spacing(np.abs(p_ref))[keep]
            assert (err <= allowed).all(), (
                f"step {i + 1} {path}: update off by {err.max():.3e} of lr {lr_t:.3e} "
                f"({int((err > allowed).sum())} of {err.size} entries)")
            held += err.size
        # both packages take the next step from the reference's state
        load_state_tree(model, opt, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), ref))
    return held


@pytest.mark.parametrize(
    "mode,kw,tol",
    [("plain", {}, 1e-4), ("accum2", {"accum_steps": 2}, 1e-4), ("compress", {"compress_grads": True}, 1e-3)],
)
def test_train_step_updates_match_reference(mode, kw, tol):
    assert _synced_steps(kw, tol) > 0


def _mutant(kind):
    """A wrong AdamW: the port's update with one fault put in."""

    @torch.no_grad()
    def update(grads, opt_state, params, cfg):
        before = {k: p.detach().clone() for k, p in params.items()}
        if kind == "no_update":
            return adamw_update(grads, opt_state, before, cfg)
        if kind == "b2":
            return adamw_update(grads, opt_state, params, dataclasses.replace(cfg, b2=0.99))
        if kind == "no_weight_decay":
            return adamw_update(grads, opt_state, params, dataclasses.replace(cfg, weight_decay=0.0))
        out = adamw_update(grads, opt_state, params, cfg)
        t = float(opt_state["step"])
        factor = -1.0 if kind == "sign_flip" else (1 - cfg.b2 ** t) ** 0.5 / (1 - cfg.b1 ** t)
        for k, p in params.items():
            p.copy_(before[k] + factor * (p - before[k]))
        return out

    return update


@pytest.mark.parametrize("kind", ["no_update", "sign_flip", "no_bias_correction", "b2", "no_weight_decay"])
def test_update_check_catches_a_wrong_update(kind, monkeypatch):
    monkeypatch.setattr(port_train_loop, "adamw_update", _mutant(kind))
    with pytest.raises(AssertionError):
        _synced_steps({}, 1e-4, n_steps=2)


def _trained_pair():
    """The reference and the port, one train step in from the same
    parameters, at the smoke qwen config in bf16 (bf16 leaves, fp32
    moments and masters, an int32 step)."""
    from repro.configs import get_smoke as jax_get_smoke
    from repro_torch.configs import get_smoke

    cfg = jax_get_smoke("qwen2_5_3b")
    jm = JaxLM(cfg)
    jp = jm.init(jax.random.key(1))
    jopt = jax_adamw_init(jp)
    batch = _batch(seed=5, B=2, S=8, vocab=cfg.vocab)
    jp, jopt, _ = jax_make_train_step(jm, JaxOptConfig(lr=1e-3, warmup_steps=1))(
        jp, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
    model = _model(get_smoke("qwen2_5_3b"), seed=2)
    opt = _opt(model)
    make_train_step(model, OptConfig(lr=1e-3, warmup_steps=1))(opt, _torch_batch(batch))
    return jp, jopt, model, opt


def _exact(port_tree, ref_tree):
    """Every leaf equal, in value and in the reference's dtype name."""
    assert set(port_tree) == set(ref_tree)
    for k in port_tree:
        if isinstance(port_tree[k], dict):
            _exact(port_tree[k], ref_tree[k])
        else:
            want = np.asarray(ref_tree[k])
            got = port_tree[k]
            assert str(got.dtype).replace("torch.", "") == str(want.dtype), (k, got.dtype, want.dtype)
            assert np.array_equal(got.float().numpy(), want.astype(np.float32)), k


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jp, jopt, model, opt = _trained_pair()
    jckpt.save_checkpoint(tmp_path, 1, {"params": jp, "opt": jopt})
    got = restore_checkpoint(tmp_path, 1, state_like(model))
    load_state_tree(model, opt, got)
    tree = state_tree(model, opt)
    _exact(tree["params"], jp)
    _exact(tree["opt"], jopt)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jp, jopt, model, opt = _trained_pair()
    save_checkpoint(tmp_path, 1, state_tree(model, opt))
    got = jckpt.restore_checkpoint(tmp_path, 1, {"params": jp, "opt": jopt})
    _exact(state_tree(model, opt), got)
    manifest = (tmp_path / "step_00000001" / "manifest.json").read_text()
    assert '"dtype": "bfloat16"' in manifest and '"dtype": "int32"' in manifest

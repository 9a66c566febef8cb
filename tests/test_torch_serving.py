"""The port's ServeEngine and serving CLI on the CPU.

Against the JAX package: the same requests through the reference
``ServeEngine`` and the port's, on ``tests/test_serving_engine.py``'s
``TINY`` model and on the granite-moe, dbrx, mamba2 and recurrentgemma
smoke configs, in float32 with the reference's weights carried by
``params_from_jax`` (recurrentgemma's decays drawn by ``perturb_rglru``),
must give identical ``out_tokens``, ``truncated`` flags, ``decode_steps``
and ``refills`` (greedy, and sampled from the same ``rng_seed``).  Then the reference's ServeEngine regressions —
refill, truncation warning, the poll-free queue — ported to the port's
engine, and the ``repro_torch.launch.serve`` CLI on a smoke config.
"""

import queue
import threading
import warnings
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import perturb_rglru
from repro.configs import get_smoke as jax_get_smoke
from repro.models import LM as JaxLM
from repro.models import ModelConfig as JaxConfig
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxEngine
from repro_torch.configs import get_smoke
from repro_torch.launch import serve as serve_cli
from repro_torch.models import LM, ModelConfig, params_from_jax
from repro_torch.serving import Request, ServeEngine, TruncationWarning

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab=64)


@lru_cache(maxsize=None)
def _jax_model(dtype):
    model = JaxLM(JaxConfig(**TINY, dtype=dtype))
    return model, model.init(jax.random.key(0))


def _port_model(dtype="float32"):
    _, params = _jax_model(dtype)
    return params_from_jax(LM(ModelConfig(**TINY, dtype=dtype), device="cpu"), jax.tree.map(np.asarray, params))


@lru_cache(maxsize=None)
def _smoke_models(arch):
    """(JAX LM, its params, the port LM carrying them) on a smoke config in
    float32; RG-LRU decays drawn so that the recurrence carries."""
    jm = JaxLM(jax_get_smoke(arch).replace(dtype="float32"))
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    if "rglru" in jm.cfg.block_types:
        params = perturb_rglru(params, seed=5)
    pm = params_from_jax(LM(get_smoke(arch).replace(dtype="float32"), device="cpu"), params)
    return jm, jax.tree.map(jnp.asarray, params), pm


def _prompt(rng, n):
    return rng.integers(1, TINY["vocab"], n).astype(np.int32)


def _serve_both(specs, *, slots, max_len, seed, temperature=0.0, arch=None):
    """Run ``specs`` [(prompt_len, max_new)] through both engines, on
    ``TINY`` or on the smoke config of ``arch``."""
    rng = np.random.default_rng(seed)
    prompts = [_prompt(rng, n) for n, _ in specs]
    if arch is None:
        (jm, jp), pm = _jax_model("float32"), _port_model()
    else:
        jm, jp, pm = _smoke_models(arch)
    jeng = JaxEngine(jm, jp, batch_slots=slots, max_len=max_len, rng_seed=seed)
    peng = ServeEngine(pm, batch_slots=slots, max_len=max_len, rng_seed=seed)
    for rid, (p, (_, max_new)) in enumerate(zip(prompts, specs)):
        jeng.submit(JaxRequest(rid, p, max_new_tokens=max_new, temperature=temperature))
        peng.submit(Request(rid, p, max_new_tokens=max_new, temperature=temperature))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # truncation warns in both
        jdone, pdone = jeng.run(), peng.run()
    return jeng, peng, jdone, pdone


@pytest.mark.parametrize(
    "case",
    [
        dict(specs=[(8, 10), (8, 2), (8, 10)], slots=2, max_len=64, seed=1),  # refill
        dict(specs=[(8, 12), (6, 3), (10, 5)], slots=2, max_len=64, seed=2),  # padded refill
        dict(specs=[(4, 2), (40, 2)], slots=1, max_len=64, seed=3),  # long prompt parks
        dict(specs=[(8, 30)], slots=1, max_len=12, seed=4),  # truncation
        dict(specs=[(5, 6), (9, 4), (3, 7), (12, 5), (7, 3)], slots=3, max_len=40, seed=5),
        dict(specs=[(6, 8), (11, 6), (4, 9)], slots=2, max_len=64, seed=6, temperature=0.8),
    ],
    ids=["refill", "padded-refill", "long-prompt", "truncation", "mixed", "sampled"],
)
def test_engine_matches_reference(case):
    _assert_same_serving(*_serve_both(**case))


def _assert_same_serving(jeng, peng, jdone, pdone):
    assert [r.rid for r in pdone] == [r.rid for r in jdone]
    for pr, jr in zip(pdone, jdone):
        assert pr.out_tokens == jr.out_tokens, pr.rid
        assert (pr.done, pr.truncated) == (jr.done, jr.truncated), pr.rid
    assert (peng.decode_steps, peng.refills) == (jeng.decode_steps, jeng.refills)


@pytest.mark.parametrize(
    "case",
    [
        dict(specs=[(8, 12), (6, 3), (10, 5)], slots=2, max_len=64, seed=2),  # padded refill
        dict(specs=[(5, 6), (9, 4), (3, 7), (12, 5), (7, 3)], slots=3, max_len=40, seed=5),
    ],
    ids=["padded-refill", "mixed"],
)
@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "dbrx_132b", "mamba2_1_3b"])
def test_engine_matches_reference_on_moe_and_ssd(arch, case):
    """The MoE and mamba2 smoke models: refills merge the ssd state leaves
    (and the k/v) into their rows through ``cache_axes``."""
    jeng, peng, jdone, pdone = _serve_both(**case, arch=arch)
    assert peng.refills >= 1
    _assert_same_serving(jeng, peng, jdone, pdone)


@pytest.mark.parametrize(
    "case",
    [
        dict(specs=[(20, 6), (17, 4), (24, 8), (9, 5)], slots=2, max_len=40, seed=7),  # past the window
        dict(specs=[(16, 5), (32, 3), (12, 6)], slots=2, max_len=48, seed=8),  # prompts of 16 and 32
        dict(specs=[(8, 12), (6, 3), (10, 5)], slots=2, max_len=14, seed=2),  # ring of max_len < window
    ],
    ids=["past-window", "window-multiples", "short-ring"],
)
def test_engine_matches_reference_on_recurrentgemma(case):
    """The recurrentgemma smoke model (window 16): refills merge the
    rglru states and the local-attention rings into their rows through
    ``cache_axes``; prompts reach past the window, where the reference's
    ring mapping may be misaligned (ROADMAP C-ref-6) and the port follows
    it."""
    jeng, peng, jdone, pdone = _serve_both(**case, arch="recurrentgemma_2b")
    assert peng.refills >= 1
    _assert_same_serving(jeng, peng, jdone, pdone)


# ---------------------------------------------------------------------------
# the reference's regressions, on the port's engine
# ---------------------------------------------------------------------------


def _engine(**kw):
    return ServeEngine(_port_model("bfloat16"), **kw)


def test_finished_slots_refill_between_decode_steps():
    rng = np.random.default_rng(1)
    eng = _engine(batch_slots=2, max_len=64)
    for rid, max_new in enumerate((10, 2, 10)):
        eng.submit(Request(rid, _prompt(rng, 8), max_new_tokens=max_new))
    done = {r.rid: r for r in eng.run()}
    assert sorted(done) == [0, 1, 2]
    for r in done.values():
        assert r.done and not r.truncated
        assert len(r.out_tokens) == r.max_new_tokens
    assert eng.refills >= 1
    assert eng.decode_steps <= 12  # two sequential batches would pay 18


def test_refilled_row_decodes_like_a_fresh_batch():
    rng = np.random.default_rng(2)
    p_long, p_short, p_next = _prompt(rng, 8), _prompt(rng, 6), _prompt(rng, 10)
    eng = _engine(batch_slots=2, max_len=64)
    eng.submit(Request(0, p_long, max_new_tokens=12))
    eng.submit(Request(1, p_short, max_new_tokens=3))
    eng.submit(Request(2, p_next, max_new_tokens=5))
    done = {r.rid: r for r in eng.run()}
    assert eng.refills == 1
    solo = _engine(batch_slots=1, max_len=64)
    solo.submit(Request(0, p_next, max_new_tokens=5))
    (ref,) = solo.run()
    assert done[2].out_tokens == ref.out_tokens


def test_max_len_sets_truncated_and_warns():
    rng = np.random.default_rng(4)
    eng = _engine(batch_slots=1, max_len=12)
    eng.submit(Request(0, _prompt(rng, 8), max_new_tokens=30))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (r,) = eng.run()
    assert r.done and r.truncated
    assert len(r.out_tokens) < r.max_new_tokens
    assert any(issubclass(w.category, TruncationWarning) for w in caught)


class _PollFreeQueue(queue.Queue):
    def empty(self):  # pragma: no cover - the assertion IS the test
        raise AssertionError("ServeEngine must not poll Queue.empty()")


def test_engine_never_polls_queue_empty():
    rng = np.random.default_rng(6)
    eng = _engine(batch_slots=2, max_len=64)
    eng._queue = _PollFreeQueue()
    for rid in range(3):
        eng.submit(Request(rid, _prompt(rng, 6), max_new_tokens=2))
    assert len(eng.run()) == 3


def test_concurrent_submitters_all_get_served():
    rng = np.random.default_rng(7)
    eng = _engine(batch_slots=2, max_len=64)
    prompts = [_prompt(rng, 6) for _ in range(12)]

    def feed(base):
        for j in range(4):
            eng.submit(Request(base + j, prompts[base + j], max_new_tokens=2))

    threads = [threading.Thread(target=feed, args=(b,)) for b in (0, 4, 8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    done = []
    while len(done) < 12:
        done.extend(eng.run())
    assert sorted(r.rid for r in done) == list(range(12))
    assert all(len(r.out_tokens) == 2 for r in done)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_serve_cli_on_smoke_config(capsys):
    done = serve_cli.main(["--arch", "qwen2_5_3b", "--smoke", "--device", "cpu", "--requests", "5", "--max-new", "4"])
    out = capsys.readouterr().out
    assert sorted(r.rid for r in done) == list(range(5))
    assert all(len(r.out_tokens) == 4 and not r.truncated for r in done)
    assert out.count("[serve] rid=") == 5
    assert "[serve] 5 requests, 20 tokens in" in out


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "mamba2_1_3b", "recurrentgemma_2b"])
def test_serve_cli_on_moe_and_ssd_smoke_configs(arch, capsys):
    done = serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "5", "--max-new", "4"])
    out = capsys.readouterr().out
    assert sorted(r.rid for r in done) == list(range(5))
    assert all(len(r.out_tokens) == 4 and not r.truncated for r in done)
    assert "[serve] 5 requests, 20 tokens in" in out


def test_serve_cli_refuses_encoder_only_and_unported_configs():
    with pytest.raises(AssertionError, match="encoder-only"):
        serve_cli.main(["--arch", "hubert_xlarge", "--smoke", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve_cli.main(["--arch", "qwen2_vl_2b", "--smoke", "--device", "cpu"])

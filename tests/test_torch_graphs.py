"""The port's compiled decode step: ``LM.decode_step`` free of host syncs,
with its position on the device, and the engine's CUDA-graph replay.

On the CPU, against the JAX package and the port's own earlier
formulations, on the smoke configs of every block family (dense
``attn``, MoE, ``ssd``, ``rglru`` + ``local_attn``), in float32:

* ``decode_step`` makes no host sync (:class:`_torch_port.NoHostSync`),
  so the card can capture it;
* a 0-d tensor position gives exactly what an int position gives, and
  both match the JAX ``LM.decode_step`` within 1e-4 of the largest
  magnitude, across the local-attention ring's wraps;
* the scatter-based MoE dispatch is bit-identical to the boolean-mask
  dispatch it replaced, dropped slots included;
* the launch-count bookkeeping of :mod:`repro_torch._graphs`, and a CPU
  engine decoding eagerly.

Marked ``cuda`` (decided inside the fixture): the engine by graph replay
against ``eager=True`` on the four families, and launch counts under
replay.
"""

import gc
import warnings
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port import NoHostSync, perturb_rglru
from repro.configs import get_smoke as jax_get_smoke
from repro.models import LM as JaxLM
from repro_torch import _graphs
from repro_torch.configs import get_smoke
from repro_torch.kernels import moe_gmm
from repro_torch.models import LM, params_from_jax
from repro_torch.models import attention as pattn
from repro_torch.models import moe as pmoe
from repro_torch.serving import Request, ServeEngine

FAMILIES = ["qwen2_5_3b", "granite_moe_3b_a800m", "mamba2_1_3b", "recurrentgemma_2b"]
TOL = 1e-4


@lru_cache(maxsize=None)
def _models(arch):
    """(JAX LM, its params, the port LM carrying them), smoke config, fp32;
    RG-LRU decays drawn so that the recurrence carries."""
    jm = JaxLM(jax_get_smoke(arch).replace(dtype="float32"))
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    if "rglru" in jm.cfg.block_types:
        params = perturb_rglru(params, seed=5)
    pm = params_from_jax(LM(get_smoke(arch).replace(dtype="float32"), device="cpu"), params)
    return jm, jax.tree.map(jnp.asarray, params), pm


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# decode_step: no host sync, a device position
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_makes_no_host_sync(arch):
    """With a 0-d tensor position, as the engine's graph replays it (an
    int position is copied to the device once per call, eagerly)."""
    _, _, pm = _models(arch)
    toks = torch.from_numpy(_tokens(pm.cfg, 2, 8, seed=0))
    with torch.inference_mode():
        lg, cache = pm.prefill(toks, max_len=24)
        pos = torch.tensor(8, dtype=torch.int32)
        with NoHostSync():
            for _ in range(3):
                lg, cache = pm.decode_step(cache, lg.argmax(-1), pos)
                pos += 1


def test_the_sync_check_sees_a_mask_index_and_an_item():
    x = torch.arange(6.0)
    with pytest.raises(AssertionError, match="boolean mask"), NoHostSync():
        x[x > 2]
    with pytest.raises(AssertionError, match="host sync"), NoHostSync():
        int(x.sum())
    with pytest.raises(AssertionError, match="host sync"), NoHostSync():
        torch.tensor([3])


@pytest.mark.parametrize("arch", FAMILIES)
def test_tensor_position_equals_int_position(arch):
    """Every step's logits and every cache leaf identical; recurrentgemma's
    ring (16 slots) wraps during the 8 steps."""
    _, _, pm = _models(arch)
    S, steps = 12, 8
    toks = torch.from_numpy(_tokens(pm.cfg, 2, S + steps, seed=1))
    with torch.inference_mode():
        _, ci = pm.prefill(toks[:, :S], max_len=S + steps)
        _, ct = pm.prefill(toks[:, :S], max_len=S + steps)
        pos = torch.zeros((), dtype=torch.int32)
        for t in range(steps):
            li, ci = pm.decode_step(ci, toks[:, S + t], S + t)
            pos.fill_(S + t)
            lt, ct = pm.decode_step(ct, toks[:, S + t], pos)
            assert torch.equal(li, lt), t
    for a, b in zip(_leaves(ci), _leaves(ct)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", FAMILIES)
def test_tensor_position_decode_matches_reference(arch):
    """Prefill 12 tokens, then 8 greedy steps with a 0-d int32 position:
    the logits within 1e-4 of the JAX ``decode_step`` at every step; on
    recurrentgemma the 16-slot ring wraps."""
    jm, jp, pm = _models(arch)
    S, steps = 12, 8
    toks = _tokens(jm.cfg, 2, S, seed=2)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=S + steps)
    with torch.inference_mode():
        pl, pc = pm.prefill(torch.from_numpy(toks), max_len=S + steps)
        for t in range(steps):
            nxt = np.asarray(jl).argmax(-1).astype(np.int32)
            assert np.array_equal(pl.argmax(-1).numpy(), nxt)
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), jnp.int32(S + t))
            pl, pc = pm.decode_step(pc, torch.from_numpy(nxt), torch.tensor(S + t, dtype=torch.int32))
            _close(pl, jl)
    if "local_attn" in jm.cfg.block_types:
        ring = pc["stack0"]["b2_local_attn"]["pos"]
        assert ring.shape[-1] == 16 and int(ring.max()) == S + steps - 1 and int(ring.min()) == S + steps - 16


def test_module_decode_attention_takes_a_tensor_position():
    _, _, pm = _models("qwen2_5_3b")
    cfg = pm.cfg
    ap = pm._params()[1][0]["attn"]
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32))
    kv = [rng.normal(size=(2, 16, cfg.kv_heads, cfg.head_dim_)).astype(np.float32) for _ in range(2)]
    for position, window in ((9, None), (12, 5), (20, None)):
        ci = pattn.KVCache(*(torch.from_numpy(a.copy()) for a in kv))
        ct = pattn.KVCache(*(torch.from_numpy(a.copy()) for a in kv))
        want, _ = pattn.decode_attention(ap, x, ci, position, cfg, window=window)
        pos = torch.tensor(position, dtype=torch.int32)
        with NoHostSync():
            got, out = pattn.decode_attention(ap, x, ct, pos, cfg, window=window)
        assert out.k is ct.k
        assert torch.equal(got, want) and torch.equal(ct.k, ci.k) and torch.equal(ct.v, ci.v)


# ---------------------------------------------------------------------------
# MoE dispatch without a boolean mask
# ---------------------------------------------------------------------------


def _mask_dispatch_moe_ffn(params, x, cfg):
    """``moe_ffn`` as it stood with its boolean-mask dispatch (the
    formulation the scatter replaced), for the bit-for-bit comparison."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = pmoe.moe_capacity(cfg, S)
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    slots, gates, _ = pmoe._route(probs, K, C)
    kept = slots >= 0
    e_idx, c_idx = torch.div(slots, C, rounding_mode="floor"), slots % C
    b_idx = torch.arange(B)[:, None, None].expand(B, S, K)
    s_idx = torch.arange(S)[None, :, None].expand(B, S, K)
    dst = (e_idx * B + b_idx) * C + c_idx
    src_for_slot = torch.full((E * B * C,), B * S, dtype=torch.int64)
    src_for_slot[dst[kept].long()] = (b_idx * S + s_idx)[kept]
    xpad = torch.cat([x.reshape(B * S, D), x.new_zeros((1, D))])
    dispatched = xpad[src_for_slot].reshape(E, B * C, D)
    h = F.silu(moe_gmm(dispatched, params["wi_gate"])) * moe_gmm(dispatched, params["wi_up"])
    eo = moe_gmm(h, params["wo"]).reshape(E * B * C, D)
    eo_pad = torch.cat([eo, eo.new_zeros((1, D))])
    tok_out = eo_pad[torch.where(kept, dst, E * B * C).long()]
    return torch.sum(tok_out * gates[..., None].to(tok_out.dtype), dim=2).to(x.dtype), slots


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "dbrx_132b"])
def test_scatter_dispatch_is_bit_identical_to_mask_dispatch(arch, capacity_factor):
    """On the smoke config's MoE layer, at its own capacity factor and at
    one that drops tokens; a one-token decode shape too."""
    cfg = get_smoke(arch).replace(dtype="float32", capacity_factor=capacity_factor)
    lm = LM(cfg, device="cpu")
    params = lm._params()[1][0]["moe"]
    dropped = 0
    for B, S, seed in ((2, 24, 0), (4, 1, 1), (3, 17, 2)):
        x = torch.from_numpy(np.random.default_rng(seed).normal(size=(B, S, cfg.d_model)).astype(np.float32))
        want, slots = _mask_dispatch_moe_ffn(params, x, cfg)
        with NoHostSync():
            got, _ = pmoe.moe_ffn(params, x, cfg)
        assert torch.equal(got, want)
        dropped += int((slots < 0).sum())
    assert (dropped > 0) == (capacity_factor < 1), dropped


# ---------------------------------------------------------------------------
# _graphs: launch counts under replay; the CPU never captures
# ---------------------------------------------------------------------------


def test_uncounted_restores_every_counter():
    before = _graphs.launch_counts()
    with _graphs.uncounted():
        _graphs.add_launches({"moe_gmm": 5, "flash_attention": 2})
        assert _graphs.launch_counts()["moe_gmm"] == before["moe_gmm"] + 5
    assert _graphs.launch_counts() == before


def test_replay_adds_the_captured_launches():
    class FakeGraph:
        replays = 0

        def replay(self):
            FakeGraph.replays += 1

    g = _graphs.CapturedGraph(FakeGraph(), "out", {"moe_gmm": 3, "matmul_requant": 1}, 0.0)
    before = _graphs.launch_counts()
    for _ in range(4):
        assert g.replay() == "out"
    after = _graphs.launch_counts()
    assert FakeGraph.replays == 4
    assert after["moe_gmm"] - before["moe_gmm"] == 12
    assert after["matmul_requant"] - before["matmul_requant"] == 4
    assert after["flash_attention"] == before["flash_attention"]


def test_capture_refuses_a_cpu_device():
    with pytest.raises(ValueError, match="CUDA device"):
        _graphs.capture(lambda: None, torch.device("cpu"))


@pytest.mark.parametrize("eager", [False, True])
def test_cpu_engine_decodes_eagerly(eager):
    _, _, pm = _models("qwen2_5_3b")
    eng = ServeEngine(pm, batch_slots=2, max_len=32, eager=eager)
    assert eng.eager
    rng = np.random.default_rng(0)
    for rid in range(3):
        eng.submit(Request(rid, rng.integers(1, 64, 6).astype(np.int32), max_new_tokens=4))
    done = eng.run()
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert eng.capture_ms == {} and eng.decode_steps > 0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _serve(pm, eager, specs, seed):
    eng = ServeEngine(pm, batch_slots=2, max_len=40, eager=eager)
    rng = np.random.default_rng(seed)
    for rid, (n, new) in enumerate(specs):
        eng.submit(Request(rid, rng.integers(1, pm.cfg.vocab, n).astype(np.int32), max_new_tokens=new))
    before = _graphs.launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        done = eng.run()
    after = _graphs.launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    return eng, sorted(done, key=lambda r: r.rid), launches


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_graph_matches_eager_on_card(cuda, arch):
    """The same requests (a refill, a padded refill, a batch of one at the
    end) by graph replay and op by op: identical tokens, flags and
    counters, and the same kernel launches."""
    _, _, cpu_model = _models(arch)
    pm = LM(cpu_model.cfg, device="cpu")
    pm.load_state_dict(cpu_model.state_dict())
    pm = pm.to(cuda)
    specs = [(8, 10), (6, 3), (10, 5), (5, 30)]
    eng_e, done_e, launches_e = _serve(pm, True, specs, seed=7)
    eng_g, done_g, launches_g = _serve(pm, False, specs, seed=7)
    assert not eng_g.eager and eng_g.capture_ms
    assert [r.out_tokens for r in done_g] == [r.out_tokens for r in done_e]
    assert [r.truncated for r in done_g] == [r.truncated for r in done_e]
    assert (eng_g.decode_steps, eng_g.refills) == (eng_e.decode_steps, eng_e.refills)
    assert launches_g == launches_e


@pytest.mark.cuda
def test_replays_count_launches_exactly(cuda):
    """A captured MoE decode layer: N replays add N x the captured launches
    (3 moe_gmm), and the capture itself adds none."""
    cfg = get_smoke("granite_moe_3b_a800m").replace(dtype="float32")
    lm = LM(cfg, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    params = lm._params()[1][0]["moe"]
    x = torch.randn((4, 1, cfg.d_model), device=cuda)
    with torch.inference_mode():
        want, _ = pmoe.moe_ffn(params, x, cfg)
        before = _graphs.launch_counts()
        g = _graphs.capture(lambda: pmoe.moe_ffn(params, x, cfg)[0], cuda)
        assert _graphs.launch_counts() == before
        assert g.launches["moe_gmm"] == 3 and sum(g.launches.values()) == 3
        for _ in range(5):
            g.replay()
        torch.cuda.synchronize()
    assert _graphs.launch_counts()["moe_gmm"] - before["moe_gmm"] == 15
    assert torch.equal(g.output, want)


@pytest.mark.cuda
def test_the_collector_is_off_while_capturing(cuda):
    """A dead reference cycle that holds another graph must not be
    collected in the middle of a capture (destroying that graph there
    invalidates the capture): the cyclic collector is on for the warm-up,
    off for the capture and on again after it."""
    x = torch.ones(4, device=cuda)
    seen = []

    def fn():
        seen.append(gc.isenabled())
        return x * 2

    assert gc.isenabled()
    g = _graphs.capture(fn, cuda)
    assert seen == [True, False] and gc.isenabled()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(g.output, x * 2)


@pytest.mark.cuda
def test_a_host_sync_fails_the_capture(cuda):
    """A callable that reads the card on the host raises, and leaves the
    counters as they were; the card works on afterwards."""
    x = torch.ones(4, device=cuda)
    before = _graphs.launch_counts()
    with pytest.raises(_graphs.GraphCaptureError):
        _graphs.capture(lambda: x * float(x.sum()), cuda)
    assert _graphs.launch_counts() == before
    torch.cuda.synchronize()
    assert float((x + 1).sum()) == 8.0

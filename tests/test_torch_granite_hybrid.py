"""granite-4.0-h through the port's ``LM`` and ``ServeEngine`` against the
plain float32 reference (``repro_torch.models.granite_hybrid_ref``), on
the CPU at the ``SMOKE`` size with the model's own seeded initialisation.

Everything runs in float32 with TF32 off, so the port and the reference
differ only in the order of their sums (the chunked scan against the
recurrence, the fused dispatch against a loop over experts): the
tolerance below is float32's, and each degraded program (no shared
expert, every expert weight rounded to float8_e4m3, the 1/sqrt(head_dim)
attention scale) misses it by orders of magnitude."""

import ast
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import _graphs, obs
from repro_torch.configs import get_config, get_smoke
from repro_torch.models import LM
from repro_torch.models import granite_hybrid_ref as ref
from repro_torch.models import moe as pmoe
from repro_torch.models.layers import spec_shapes
from repro_torch.models.transformer import param_specs
from repro_torch.serving import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite_4_0_h_small"
# float32 port against float32 reference: the logits differ by at most
# about 1e-7; this tolerance puts that near a hundredth of it
ATOL, RTOL = 1e-5, 1e-4
PROMPT, NEW = 24, 6
SEEDS = [2**31 + 17, 3]


@pytest.fixture(autouse=True)
def _no_tf32():
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def published(cfg) -> dict:
    """The published ``config.json`` keys the reference reads, at ``cfg``'s sizes."""
    return {
        "hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.kv_heads,
        "attention_multiplier": cfg.attn_scale or cfg.head_dim_**-0.5,
        "mamba_n_heads": cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim, "mamba_d_head": cfg.ssm_head_dim,
        "num_experts_per_tok": cfg.top_k, "rms_norm_eps": cfg.norm_eps, "residual_multiplier": cfg.residual_multiplier,
        "embedding_multiplier": cfg.embed_multiplier, "logits_scaling": cfg.logits_scaling,
        "layer_types": ["mamba" if t == "ssd" else "attention" for t in cfg.layer_pattern()],
    }


def smoke32():
    return get_smoke(ARCH).replace(dtype="float32")


@dataclass
class Drawn:
    lm: LM
    pool: list  # int64 token ids, (PROMPT,) each

    def reference_params(self):
        return self.lm.top.tree(), [layer.tree() for layer in self.lm.layers]


def drawn_model(seed: int, cfg=None):
    """The published keys and a model of ``cfg`` initialised from ``seed``,
    with two prompts drawn after it."""
    cfg = cfg or smoke32()
    gen = torch.Generator().manual_seed(seed % 2**63)
    lm = LM(cfg, device=torch.device("cpu"), generator=gen)
    pool = list(torch.randint(0, cfg.vocab, (2, PROMPT), generator=gen).unbind(0))
    return published(cfg), Drawn(lm, pool)


def worst(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(((got - want).abs() / (ATOL + RTOL * want.abs())).max())


def reference_logits(config, drawn, tokens, last=None):
    top, layers = drawn.reference_params()
    return ref.forward(config, top, layers, tokens, last=last)


def frozen_params(drawn):
    """The reference's parameters, copied before a test changes the program's."""
    clone = lambda t: {k: clone(v) for k, v in t.items()} if isinstance(t, dict) else t.clone()
    top, layers = drawn.reference_params()
    return clone(top), [clone(lp) for lp in layers]


def serve(lm, prompts, new=NEW, slots=1):
    """Greedy answers of an engine: (tokens, logits rows) per prompt, all
    submitted before it runs."""
    eng = ServeEngine(lm, batch_slots=slots, max_len=PROMPT + new)
    reqs = [Request(i, p.reshape(-1).numpy().astype(np.int32), max_new_tokens=new, logits=[])
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
        if slots == 1:
            eng.run()
    if slots > 1:
        eng.run()
    return [(torch.tensor(r.out_tokens), torch.from_numpy(np.stack(r.logits))) for r in reqs]


def served_against_reference(config, drawn, answers, params=None):
    """Each answer's logits against the reference's full forward pass over
    its prompt and served tokens; the worst error over tolerance."""
    top, layers = params or drawn.reference_params()
    err = 0.0
    for p, (tokens, logits) in zip(drawn.pool, answers):
        seq = torch.cat([p.reshape(-1), tokens[:-1]])[None]
        want = ref.forward(config, top, layers, seq, last=len(tokens))[0]
        err = max(err, worst(logits, want))
    return err


# -- the model and its configuration ------------------------------------------


def test_the_benchmark_and_the_port_keep_one_reference_file():
    a = (ROOT / "src" / "repro_torch" / "models" / "granite_hybrid_ref.py").read_bytes()
    b = (ROOT / "bench" / "reference" / "granite_hybrid.py").read_bytes()
    assert a == b


def test_the_reference_imports_only_torch():
    tree = ast.parse((ROOT / "src" / "repro_torch" / "models" / "granite_hybrid_ref.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert names <= {"__future__", "torch", "torch.nn.functional"}, names


def test_the_smoke_preset_is_one_period_of_the_published_pattern():
    cfg, smoke = get_config(ARCH), get_smoke(ARCH)
    assert cfg.layer_pattern() == smoke.layer_pattern() * 4
    assert smoke.layer_pattern() == ("ssd",) * 5 + ("attn",) + ("ssd",) * 4
    assert cfg.attn_scale == 1 / cfg.head_dim_ and smoke.attn_scale == 1 / smoke.head_dim_
    same = ("moe_dropless", "ssd_mlp", "ssm_conv_bias", "embed_multiplier", "residual_multiplier", "logits_scaling",
            "tie_embeddings", "pos_kind", "activation")
    assert {k: getattr(smoke, k) for k in same} == {k: getattr(cfg, k) for k in same}


def test_parameter_counts_of_the_published_model_and_of_its_cut():
    """The model card's 32B-A9B, and the cut's 8.36 B, each parameter the
    model holds."""
    cfg = get_config(ARCH)
    assert cfg.n_params() == pytest.approx(32.2e9, rel=0.005)
    assert cfg.n_active_params() == pytest.approx(8.8e9, rel=0.005)
    cut = cfg.replace(n_layers=10)
    assert cut.n_params() == pytest.approx(8.36e9, rel=0.002)
    held = sum(math.prod(s) for s, _ in _leaves(spec_shapes(param_specs(cut))))
    assert held == 8_360_118_912
    assert held == pytest.approx(cut.n_params(), rel=1e-4)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_param_counts_take_the_moe_after_mamba_blocks_and_the_shared_expert():
    cfg = get_smoke(ARCH)
    d, E, f, fs = cfg.d_model, cfg.n_experts, cfg.moe_d_ff, cfg.moe_shared_d_ff
    moe = E * 3 * d * f + d * E + 3 * d * fs
    assert cfg.n_params() - cfg.replace(ssd_mlp=False).n_params() == 9 * moe  # the 9 mamba blocks' MoE halves
    assert cfg.n_params() - cfg.replace(moe_shared_d_ff=0).n_params() == 10 * 3 * d * fs
    assert cfg.n_params() - cfg.n_active_params() == 10 * (E - cfg.top_k) * 3 * d * f
    # the other families count as before (the numbers of the counts without these terms)
    for arch, before in {"mamba2_1_3b": (116480, 116480), "granite_moe_3b_a800m": (237888, 154944),
                         "dbrx_132b": (411136, 312832), "recurrentgemma_2b": (424480, 424480)}.items():
        assert (get_smoke(arch).n_params(), get_smoke(arch).n_active_params()) == before, arch


# -- the port against the reference ---------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_full_forward_matches_the_reference(seed):
    config, drawn = drawn_model(seed)
    tokens = torch.stack([p.reshape(-1) for p in drawn.pool])
    with torch.no_grad():
        got, _ = drawn.lm(tokens)
    want = reference_logits(config, drawn, tokens)
    assert want.std() > 0.005  # logits that spread (about 0.01)
    assert worst(got, want) <= 1.0


@pytest.mark.parametrize("seed", SEEDS)
def test_served_prefill_then_decode_matches_the_full_forward_pass(seed):
    config, drawn = drawn_model(seed)
    answers = serve(drawn.lm, drawn.pool)
    for tokens, logits in answers:
        assert len(tokens) == len(logits) == NEW
        assert torch.equal(tokens, logits.argmax(-1))  # greedy: each token the argmax of its row
    assert served_against_reference(config, drawn, answers) <= 1.0


def _force_every_token_to_experts_0_and_1(lm) -> None:
    """Channel 0 of the residual stream carries the embedding's constant 12
    and nothing else (every block's output projection writes 0 there), so
    every token's normalised input has a positive channel 0; every router,
    reading channel 0 alone, then puts experts 0 and 1 first."""
    with torch.no_grad():
        lm.top.embed[:, 0] = 1.0
        for layer in lm.layers:
            mixer = layer.ssd.out if hasattr(layer, "ssd") else layer.attn.wo
            mixer[:, 0] = 0.0
            layer.moe.wo[:, :, 0] = 0.0
            layer.moe.shared.wo[:, 0] = 0.0
            layer.moe.router.zero_()
            layer.moe.router[0, 0] = 10.0
            layer.moe.router[0, 1] = 5.0


@pytest.mark.parametrize("seed", SEEDS)
def test_two_requests_decoded_together_match_the_full_forward_pass(seed):
    """Two slots of one engine: the mixed cache (Mamba-2 states beside a KV
    cache) keeps each request's rows apart."""
    config, drawn = drawn_model(seed)
    answers = serve(drawn.lm, drawn.pool, slots=2)
    assert served_against_reference(config, drawn, answers) <= 1.0


def test_a_router_that_sends_every_token_to_one_expert_drops_nothing():
    config, drawn = drawn_model(SEEDS[0])
    lm = drawn.lm
    _force_every_token_to_experts_0_and_1(lm)
    tokens = torch.stack([p.reshape(-1) for p in drawn.pool])
    before = obs.metrics_dict()["counters"]
    with torch.no_grad():
        got, _ = lm(tokens)
    after = obs.metrics_dict()["counters"]
    moved = {k: after.get(k, 0) - before.get(k, 0) for k in ("moe.routed_pairs", "moe.rows_computed", "moe.dropped")}
    pairs = lm.cfg.n_layers * tokens.numel() * lm.cfg.top_k
    # only experts 0 and 1 hold pairs, every slot of theirs: only their tiles run
    assert moved == {"moe.routed_pairs": pairs, "moe.dropped": 0,
                     "moe.rows_computed": lm.cfg.n_layers * lm.cfg.top_k * len(tokens) * PROMPT}
    want = reference_logits(config, drawn, tokens)
    assert worst(got, want) <= 1.0
    # the same routing through capacity-factor routing drops most pairs
    lm.cfg = lm.cfg.replace(moe_dropless=False)
    with torch.no_grad():
        capped, _ = lm(tokens)
    assert worst(capped, want) > 100


def test_dropless_capacity_lays_the_experts_out_at_the_most_pairs_any_received():
    """At the power of two, 8 or more, that holds the most pairs any expert
    received, and never past the bound of a group's tokens."""
    cfg = smoke32()
    assert pmoe.moe_capacity(cfg, 1) == 8 and pmoe.moe_capacity(cfg, 24) == 24
    assert pmoe.moe_capacity(cfg, 1000) == 1000
    c_idx = torch.tensor([[[0, 3], [1, 11]]])  # the most any expert received: 12
    kept = torch.ones_like(c_idx, dtype=torch.bool)
    before = obs.metrics_dict()["counters"]
    assert pmoe._dropless_capacity(c_idx, kept, 24, 4) == 16
    after = obs.metrics_dict()["counters"]
    # the pairs here; the rows are the expert products' device tally
    assert after["moe.routed_pairs"] - before.get("moe.routed_pairs", 0) == 4
    assert after.get("moe.rows_computed", 0) == before.get("moe.rows_computed", 0)
    for most, bound, want in ((0, 24, 8), (7, 24, 8), (8, 24, 16), (16, 24, 24), (16, 40, 32), (200, 1024, 256),
                              (256, 1024, 512)):
        assert pmoe._dropless_capacity(torch.tensor([[[most]]]), kept[..., :1, :1], bound, 1) == want
    # a decode step (at most 8 tokens a group) keeps the bound and reads nothing
    assert pmoe._dropless_capacity(c_idx[..., :1], kept[..., :1], 8, 2) == 8


def test_prompts_that_route_differently_share_a_prefill_layout():
    """Two prompts whose experts receive different most pairs still lay
    their experts out at one power of two, so the second allocates no new
    shape."""
    _, drawn = drawn_model(SEEDS[0])
    sizes, seen = [], []
    record = pmoe._dropless_capacity

    def spy(c_idx, kept, C, pairs):
        seen.append(int(c_idx.amax()) + 1)
        out = record(c_idx, kept, C, pairs)
        sizes.append(out)
        return out

    tokens = torch.randint(0, 512, (2, 128), generator=torch.Generator().manual_seed(5))
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(pmoe, "_dropless_capacity", spy)
        for t in tokens:
            drawn.lm(t[None])
    assert len(set(seen)) > 1  # the prompts' most pairs differ ...
    assert all(c & (c - 1) == 0 and c >= n for c, n in zip(sizes, seen))  # ... their layouts are powers of two
    assert len(set(sizes)) < len(set(seen))


# -- degraded programs fail ----------------------------------------------------------


def _no_shared_expert(lm):
    with torch.no_grad():
        for layer in lm.layers:
            layer.moe.shared.wo.zero_()


def _float8_experts(lm):
    with torch.no_grad():
        for layer in lm.layers:
            for m in (layer.moe, layer.moe.shared):
                for name in ("wi_gate", "wi_up", "wo"):
                    w = getattr(m, name)
                    amax = w.abs().amax(dim=(-2, -1), keepdim=True)
                    w.copy_((w * (448.0 / amax)).to(torch.float8_e4m3fn).float() * (amax / 448.0))


def _sqrt_scale(lm):
    lm.cfg = lm.cfg.replace(attn_scale=0.0)


DEGRADED = {"no shared expert": _no_shared_expert, "float8_e4m3 experts": _float8_experts,
            "1/sqrt(head_dim) attention scale": _sqrt_scale}


@pytest.mark.parametrize("degrade", list(DEGRADED))
def test_a_degraded_program_fails_the_comparison(degrade):
    config, drawn = drawn_model(SEEDS[0])
    params = frozen_params(drawn)
    DEGRADED[degrade](drawn.lm)
    answers = serve(drawn.lm, drawn.pool)
    assert served_against_reference(config, drawn, answers, params) > 10


# -- the serving path's spans, counters and logits ----------------------------------------


def test_the_engine_keeps_a_logits_row_for_each_token_of_its_request():
    _, drawn = drawn_model(SEEDS[0])
    eng = ServeEngine(drawn.lm, batch_slots=2, max_len=PROMPT + NEW)
    reqs = [Request(i, p.reshape(-1).numpy().astype(np.int32), max_new_tokens=n, logits=[])
            for i, (p, n) in enumerate(zip(drawn.pool, (2, NEW)))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    for r in reqs:
        assert len(r.logits) == len(r.out_tokens) == r.max_new_tokens
        assert [int(np.argmax(row)) for row in r.logits] == r.out_tokens


def test_serving_records_its_spans_with_the_tracer_on():
    _, drawn = drawn_model(SEEDS[0])
    eng = ServeEngine(drawn.lm, batch_slots=1, max_len=PROMPT + NEW)
    tracer = obs.get_tracer()
    tracer.clear()
    obs.enable_tracing()
    try:
        eng.submit(Request(0, drawn.pool[0].reshape(-1).numpy().astype(np.int32), max_new_tokens=NEW))
        eng.run()
        names = [e["name"] for e in tracer.chrome_trace()["traceEvents"] if e.get("ph") == "X"]
    finally:
        obs.disable_tracing()
        tracer.clear()
    assert names.count("serve.prefill") == 1
    assert names.count("serve.decode_step") == NEW - 1
    assert names.count("model.moe") == drawn.lm.cfg.n_layers  # one a layer, in the prefill only


def test_a_graph_replay_repeats_the_moe_counts_of_its_capture():
    """A captured decode step's ``moe.*`` counts are made once, in the
    capture; each replay adds them."""

    class FakeGraph:
        def replay(self):
            pass

    routed = obs.counter("moe.routed_pairs")
    before = routed.value
    g = _graphs.CapturedGraph(FakeGraph(), "out", {}, 0.0, ((routed, 10),))
    for _ in range(3):
        g.replay()
    assert routed.value - before == 30


@pytest.mark.parametrize("name", ["moe.routed_pairs", "granite_test.first_made_in_a_warm_up"])
def test_a_warm_up_leaves_every_counter_as_it_was(name):
    """Whatever counter a warm-up or a capture moves, or first makes, reads
    after it what it read before."""
    counters = obs.metrics_dict()["counters"]
    before, dropped = counters.get(name, 0), counters.get("moe.dropped", 0)
    with _graphs.uncounted():
        obs.counter(name).inc(7)
        obs.counter("moe.dropped").inc(1)
    after = obs.metrics_dict()["counters"]
    assert (after[name], after["moe.dropped"]) == (before, dropped)

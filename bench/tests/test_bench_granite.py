"""The granite cell's files on the CPU: the builder, the served loop, the
served-logits rule, the counts and the six readers, run through
``run_cell`` on a configuration of the same file at small widths (a copy
of the cell under another name), and the rule on the port's served
answers in float32 at the ``SMOKE`` size, against the program and three
degraded ones (no shared expert, every expert weight rounded to
float8_e4m3, the 1/sqrt(head_dim) attention scale)."""

import json
import math

import numpy as np
import pytest
import torch

from bench import harness, spec
from conftest import CHECKOUT, checkout_copy
from repro_torch.configs import get_config, get_smoke
from repro_torch.models import granite_hybrid_ref as ref
from repro_torch.serving import Request, ServeEngine

CELL = "granite_4_0_h_small.chat_1k"
SMALL = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2, "intermediate_size": 32,
         "shared_intermediate_size": 48, "mamba_n_heads": 8, "mamba_d_head": 16, "mamba_d_state": 16,
         "num_local_experts": 8, "num_experts_per_tok": 2, "vocab_size": 512, "attention_multiplier": 1 / 16}
NEW_METRICS = ("kernels_roofline.chat_1k", "mfu.chat_1k", "serve.prefill_ms.chat_1k",
               "serve.decode_step_us.chat_1k", "moe.pad_share.chat_1k", "device.idle_share.chat_1k")
ARCH = "granite_4_0_h_small"
BUILDER = spec.named(spec.BENCH, "graphs", "granite_hybrid")
RULE = spec.named(spec.BENCH, "checks", "served_logits")
BENCH_CONFIG = json.loads((CHECKOUT / "bench" / "configs" / f"{ARCH}.json").read_text())
# the float32 program reads a relative rms near 1e-6; each degraded one
# reads 0.1 or more
FLOAT32_RULE = {"rule": "served_logits", "rms": 1e-4, "gap": 1e-4}
PROMPT, NEW = 24, 6
SEED = 3


def _small_checkout(root):
    """The checkout with a small float32 copy of the granite cell, ``small.chat_1k``."""
    checkout_copy(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    config = json.loads((CHECKOUT / "bench" / "configs" / "granite_4_0_h_small.json").read_text())
    config.update(SMALL)
    config["input"] = dict(config["input"], shape=[1, 32], new_tokens=6)
    # float32: at these widths a bf16 top-2 of 8 experts flips its second
    # expert on rounding, which the published top-10 of 72 does not feel
    config["precision"] = dict(config["precision"], dtype="float32")
    (root / "bench" / "configs" / "small.json").write_text(json.dumps(config))
    entry = next(c for c in bench["configs"] if c["name"] == "granite_4_0_h_small")
    bench["configs"].append(dict(entry, name="small", file="bench/configs/small.json"))
    bench["workloads"].append(dict(next(w for w in bench["workloads"] if w["name"] == CELL),
                                   name="small.chat_1k", config="small"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("small.chat_1k")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_the_cell_names_files_that_exist():
    cell = spec.load_cell(CHECKOUT, CELL)
    cfg = cell.config
    for folder, name in (("graphs", cfg["graph"]), ("reference", cfg["reference"]), ("reference", cfg["counts"]),
                         ("loops", cell.mix["loop"]), ("checks", cfg["check"]["rule"])):
        assert (CHECKOUT / "bench" / folder / f"{name}.py").is_file(), (folder, name)
    reported = {m["name"] for m in spec.metrics_of(cell, True)}
    assert reported == set(NEW_METRICS) | {"compile_s"}
    assert {m["name"] for m in spec.metrics_of(cell, False)} == {"latency_p50_ms", "latency_p95_ms", "setup_s"}


def test_the_configuration_keeps_the_published_keys_but_its_cut():
    """Every number of the catalog's config under its own key; only
    ``num_hidden_layers`` and ``layer_types`` differ, as ``reduced`` says."""
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "granite_4_0_h_small")
    cfg = json.loads((CHECKOUT / entry["file"]).read_text())
    assert entry["reduced"] == ["num_hidden_layers", "layer_types"]
    assert cfg["num_hidden_layers"] == 10
    assert cfg["layer_types"] == ["mamba"] * 5 + ["attention"] + ["mamba"] * 4
    published = {"hidden_size": 4096, "intermediate_size": 768, "shared_intermediate_size": 1536,
                 "num_local_experts": 72, "num_experts_per_tok": 10, "vocab_size": 100352, "mamba_n_heads": 128,
                 "mamba_d_head": 64, "mamba_d_state": 128, "num_attention_heads": 32, "num_key_value_heads": 8,
                 "attention_multiplier": 0.0078125, "embedding_multiplier": 12, "residual_multiplier": 0.22,
                 "logits_scaling": 16}
    assert {k: cfg[k] for k in published} == published


def test_counts_of_a_request():
    counts = spec.named(spec.BENCH, "reference", "granite_counts")
    cfg = spec.load_cell(CHECKOUT, CELL).config
    phases = counts.phases(cfg)
    assert [p["phase"] for p in phases] == ["prefill"] + ["decode"] * 127
    assert counts.parameters(cfg)["total"] == 8_360_118_912
    # a decode step reads 10 of 72 experts a layer: about 5.1 GB, and the prefill every weight, 16.8 GB
    assert phases[1]["bytes"] == pytest.approx(5.1e9, rel=0.01)
    assert phases[0]["bytes"] == pytest.approx(16.8e9, rel=0.01)
    peaks = json.loads((CHECKOUT / "bench" / "peaks.json").read_text())["h100"]
    need = counts.need_s_of(cfg, 1, peaks)
    assert 0.15 < need < 0.25 and counts.need_s_of(cfg, 3, peaks) == pytest.approx(3 * need)
    # MACs: about 2.1 G a token through the 10 layers, and the head a logit row
    assert counts.macs_of(cfg) == pytest.approx(1151 * 2.10e9 + 128 * 4096 * 100352, rel=0.02)


@pytest.mark.parametrize("trace", [0, 1])
def test_a_small_copy_runs_correct_and_reads_its_metrics(tmp_path, trace):
    root = _small_checkout(tmp_path)
    r = harness.run_cell(root, "small.chat_1k", 2**31 + 41, 3.0, bool(trace), device="cpu",
                         bench_dir=root / "bench")
    assert r["correct"], r["checks"]
    assert list(r["checks"])[:2] == ["logit_rms_error", "served_logit_gap"]
    assert r["checks"]["checked_answers"]["value"] == 8 and r["failed"] == 0
    m = r["metrics"]
    if not trace:
        assert set(m) == {"latency_p50_ms", "latency_p95_ms", "setup_s"}
        return
    # no device trace on the CPU: the roofline and the idle share read nothing; the rest read the program
    assert set(m) == set(NEW_METRICS) - {"kernels_roofline.chat_1k", "device.idle_share.chat_1k"} | {"compile_s"}
    assert 0 < m["moe.pad_share.chat_1k"]["value"] < 100
    assert m["serve.prefill_ms.chat_1k"]["value"] > 0 and m["serve.decode_step_us.chat_1k"]["value"] > 0
    assert 0 < m["mfu.chat_1k"]["value"] < 100


def test_a_degraded_answer_is_not_correct(tmp_path, monkeypatch):
    """The rule refuses answers whose logits are off by more than its
    tolerance: the served logits of every kept answer shifted by 0.1."""
    root = _small_checkout(tmp_path)
    loop = spec.named(root / "bench", "loops", "served")
    close = loop.close

    def shifted(entry):
        close(entry)
        for _, out in entry.kept:
            out["logits"] += 0.1

    monkeypatch.setattr(loop, "close", shifted)
    monkeypatch.setattr(spec, "named", _named_with(loop, spec.named))
    r = harness.run_cell(root, "small.chat_1k", 5, 2.0, False, device="cpu", bench_dir=root / "bench")
    assert not r["correct"]
    assert r["checks"]["logit_rms_error"]["value"] > r["checks"]["logit_rms_error"]["limit"]


def _named_with(loop, named):
    def f(bench_dir, folder, name):
        return loop if folder == "loops" and name == "served" else named(bench_dir, folder, name)
    return f


def test_the_rules_limits_have_reasons():
    cfg = spec.load_cell(CHECKOUT, CELL).config
    rule = cfg["check"]
    assert rule["rule"] == "served_logits"
    for k in ("rms", "gap"):
        assert math.isfinite(rule[k]) and rule[k] > 0 and len(rule["why"][k]) > 40, k


# -- the builder and the rule on the port's served answers, in float32 at the SMOKE size -------------------


def hf_config(cfg) -> dict:
    """The configuration file with the published keys set to ``cfg``'s
    sizes, and a short request."""
    c = dict(BENCH_CONFIG)
    c.update(
        name=cfg.name, hidden_size=cfg.d_model, num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.kv_heads, intermediate_size=cfg.moe_d_ff,
        shared_intermediate_size=cfg.moe_shared_d_ff, mamba_n_heads=cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim,
        mamba_d_head=cfg.ssm_head_dim, mamba_d_state=cfg.ssm_state, num_local_experts=cfg.n_experts,
        num_experts_per_tok=cfg.top_k, vocab_size=cfg.vocab, attention_multiplier=cfg.attn_scale,
        num_hidden_layers=cfg.n_layers,
        layer_types=["mamba" if t == "ssd" else "attention" for t in cfg.layer_pattern()],
    )
    c["precision"] = dict(c["precision"], dtype=cfg.dtype)
    c["input"] = dict(c["input"], shape=[1, PROMPT], new_tokens=NEW)
    return c


def drawn_smoke():
    config = hf_config(get_smoke(ARCH).replace(dtype="float32"))
    return config, BUILDER.draw(config, SEED, 2, torch.device("cpu"))


def serve(lm, prompts):
    """Greedy answers of a one-slot engine, as the loop keeps them."""
    eng = ServeEngine(lm, batch_slots=1, max_len=PROMPT + NEW)
    kept = []
    for i, p in enumerate(prompts):
        req = Request(i, p.reshape(-1).numpy().astype(np.int32), max_new_tokens=NEW, logits=[])
        eng.submit(req)
        (done,) = eng.run()
        kept.append((i, {"tokens": torch.tensor(done.out_tokens), "logits": torch.from_numpy(np.stack(done.logits))}))
    return kept


def frozen_params(drawn):
    """The reference's parameters, copied before a test changes the program's."""
    clone = lambda t: {k: clone(v) for k, v in t.items()} if isinstance(t, dict) else t.clone()
    top, layers = drawn.reference_params()
    return clone(top), [clone(lp) for lp in layers]


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


def test_the_builder_reads_the_published_keys_into_the_port_config():
    assert BUILDER.model_config(hf_config(get_smoke(ARCH))) == get_smoke(ARCH)
    cut = get_config(ARCH).replace(n_layers=10, remat="none", name="granite_4_0_h_small")
    assert BUILDER.model_config(BENCH_CONFIG) == cut


@pytest.mark.parametrize("degrade", [None, *DEGRADED])
def test_the_served_logits_rule_holds_the_program_and_refuses_each_degraded_one(degrade):
    """The benchmark's rule, at float32's tolerance: the served answers of
    the float32 program pass both its numbers, a degraded program's fail."""
    config, drawn = drawn_smoke()
    params = frozen_params(drawn)
    if degrade is not None:
        DEGRADED[degrade](drawn.lm)
    kept = serve(drawn.lm, drawn.pool)

    class Reference:
        @staticmethod
        def forward(config, top, layers, tokens, last=None):
            return ref.forward(config, *params, tokens, last=last)

    got = RULE.judge(config, FLOAT32_RULE, drawn, kept, Reference, torch.device("cpu"))
    assert list(got) == ["logit_rms_error", "served_logit_gap"]
    ok = all(value <= limit for value, limit in got.values())
    assert ok == (degrade is None), got


def test_the_rule_reads_the_gap_of_a_served_token_below_the_best():
    config, drawn = drawn_smoke()
    kept = serve(drawn.lm, drawn.pool)
    want = ref.forward(config, *drawn.reference_params(),
                       torch.cat([drawn.pool[0].reshape(-1), kept[0][1]["tokens"][:-1]])[None], last=NEW)[0]
    last = NEW - 1  # the reference reads no served token after the last
    second = want[last].topk(2).indices[1]
    kept[0][1]["tokens"] = kept[0][1]["tokens"].clone()
    kept[0][1]["tokens"][last] = second  # a token that is not the reference's best
    got = RULE.judge(config, FLOAT32_RULE, drawn, kept, ref, torch.device("cpu"))
    assert got["served_logit_gap"][0] == pytest.approx(float(want[last].max() - want[last][second]), rel=1e-5)


def test_the_counts_hold_every_parameter_of_the_model():
    from repro_torch.models.layers import spec_shapes
    from repro_torch.models.transformer import param_specs

    counts = spec.named(spec.BENCH, "reference", "granite_counts")
    cut = BUILDER.model_config(BENCH_CONFIG)
    leaves = lambda t: [x for v in t.values() for x in leaves(v)] if isinstance(t, dict) else [t]
    held = sum(math.prod(s) for s, _ in leaves(spec_shapes(param_specs(cut))))
    assert counts.parameters(BENCH_CONFIG)["total"] == held

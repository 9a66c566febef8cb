"""granite-4.0-h as the port's ``LM``, served through its ``ServeEngine``.

The configuration file holds the published ``config.json`` keys (cut as
its ``reduced`` says); :func:`model_config` reads them into the port's
``GraniteConfig``.  The draw builds the ``LM`` on the run's device and
redraws every weight in place from one ``torch.Generator`` seeded with
``--seed``, by the rules of the configuration's ``assumed`` block, then
draws the pool of token-id prompts from the same generator.  The program
is a ``ServeEngine`` of one slot whose cache holds a prompt and its new
tokens; the loop captures its decode graph.  The reference gets the same
bf16 weights, as the model's own parameter trees.
"""

import math
import time
from dataclasses import dataclass

import torch
from repro_torch.models import LM, GraniteConfig
from repro_torch.serving import ServeEngine

__all__ = ["Drawn", "Served", "build_program", "draw", "model_config", "prepare_device", "program_params"]

# the draw's scales (the configuration's ``assumed`` block says why)
EMBED_STD = 0.02
QK_SPREAD = 2.5  # wq, wk: q.k x attention_multiplier (1/head_dim) spreads this much
ROUTER_GAIN = 5.0  # router: std ROUTER_GAIN / sqrt(d_model)
DT_RANGE = (1e-3, 1e-1)  # Mamba-2's dt, log-uniform
A_RANGE = (1.0, 16.0)  # Mamba-2's A, uniform


def model_config(config: dict) -> GraniteConfig:
    """The port's configuration of the published keys in ``config``."""
    kinds = {"mamba": "ssd", "attention": "attn"}
    types = tuple(kinds[t] for t in config["layer_types"])
    if len(types) != config["num_hidden_layers"]:
        raise ValueError(f"{len(types)} layer types for {config['num_hidden_layers']} layers")
    d, H = config["hidden_size"], config["mamba_n_heads"]
    if config["mamba_expand"] * d != H * config["mamba_d_head"] or config["mamba_n_groups"] != 1:
        raise ValueError("the port's Mamba-2 block has one group and d_inner = expand * hidden_size")
    if config["position_embedding_type"] != "nope" or config["attention_bias"] or config["mamba_proj_bias"]:
        raise ValueError("the port's granite blocks have no position embedding and no projection bias")
    return GraniteConfig(
        name=config["name"], family="moe", n_layers=config["num_hidden_layers"], d_model=d,
        n_heads=config["num_attention_heads"], n_kv_heads=config["num_key_value_heads"],
        head_dim=d // config["num_attention_heads"], vocab=config["vocab_size"], block_types=types,
        pos_kind="none", n_experts=config["num_local_experts"], top_k=config["num_experts_per_tok"],
        moe_d_ff=config["intermediate_size"], moe_shared_d_ff=config["shared_intermediate_size"],
        moe_dropless=True, activation="swiglu", ssm_state=config["mamba_d_state"],
        ssm_head_dim=config["mamba_d_head"], ssm_expand=config["mamba_expand"], ssm_conv=config["mamba_d_conv"],
        ssm_conv_bias=config["mamba_conv_bias"], ssd_mlp=True,
        embed_multiplier=float(config["embedding_multiplier"]), residual_multiplier=config["residual_multiplier"],
        logits_scaling=float(config["logits_scaling"]), attn_scale=config["attention_multiplier"],
        norm_eps=config["rms_norm_eps"], dtype=config["precision"]["dtype"],
        tie_embeddings=config["tie_word_embeddings"],
    )


@dataclass
class Drawn:
    lm: LM  # its weights in the configuration's dtype, on the run's device
    pool: list  # int64 token ids, (1, prompt) each, host memory

    def reference_params(self) -> tuple[dict, list[dict]]:
        """The model's parameters as the reference takes them: the top
        level (embed, final_norm) and one tree a layer."""
        return self.lm.top.tree(), [layer.tree() for layer in self.lm.layers]


def _redraw(name: str, t: torch.Tensor, gen: torch.Generator, cfg: GraniteConfig) -> None:
    """Draw parameter ``name`` in place by the ``assumed`` rules."""
    leaf = name.rsplit(".", 1)[-1]
    shape, dev = t.shape, t.device

    def normal(std: float) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device=dev) * std

    def uniform(lo: float, hi: float) -> torch.Tensor:
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    if leaf.startswith("norm") or leaf == "final_norm":
        v = torch.zeros(shape, device=dev)  # stored as offsets from 1: every norm weight 1
    elif leaf == "embed":
        v = normal(EMBED_STD)
    elif leaf == "router":
        v = normal(ROUTER_GAIN / math.sqrt(cfg.d_model))
    elif leaf in ("wq", "wk"):
        # q and k of rms g over head_dim entries: q.k / head_dim spreads g**2 / sqrt(head_dim)
        v = normal(math.sqrt(QK_SPREAD * math.sqrt(cfg.head_dim_)) / math.sqrt(cfg.d_model))
    elif leaf == "A_log":
        v = torch.log(uniform(*A_RANGE))
    elif leaf == "dt_bias":
        dt = torch.exp(uniform(math.log(DT_RANGE[0]), math.log(DT_RANGE[1])))
        v = dt + torch.log(-torch.expm1(-dt))  # the inverse of softplus
    elif leaf == "D":
        v = torch.ones(shape, device=dev)
    elif leaf.startswith("conv_"):
        v = uniform(-1.0 / math.sqrt(cfg.ssm_conv), 1.0 / math.sqrt(cfg.ssm_conv))
    else:  # a projection, (in, out) or (experts, in, out)
        v = normal(1.0 / math.sqrt(shape[-2]))
    t.copy_(v)


@torch.no_grad()
def draw(config: dict, seed: int, pool: int, device: torch.device) -> Drawn:
    cfg = model_config(config)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    lm = LM(cfg, device=device, generator=gen)
    for name, p in sorted(lm.named_parameters()):
        _redraw(name, p, gen, cfg)
    prompts = torch.randint(0, cfg.vocab, (pool, *config["input"]["shape"]), generator=gen, device=device)
    return Drawn(lm, list(prompts.cpu().unbind(0)))


def program_params(config: dict, drawn: Drawn) -> LM:
    return drawn.lm


def prepare_device(config: dict, dev: torch.device) -> None:
    """Load the three LM kernels' libraries before the compile clock
    starts: a cold build is set-up that no program should be charged with."""
    if dev.type != "cuda":
        return
    from repro_torch.kernels import _build

    for name in ("flash_attention", "moe_gmm", "ssd_scan"):
        _build.load(name)


@dataclass
class Served:
    """The program: a one-slot engine and the tokens each request asks for."""

    engine: ServeEngine
    new_tokens: int


def build_program(config: dict, lm: LM, device: torch.device):
    """A ``ServeEngine`` of one slot over ``lm``, its cache sized for a
    prompt and its new tokens, and its host seconds."""
    t0 = time.perf_counter()
    prompt, new = config["input"]["shape"][-1], config["input"]["new_tokens"]
    engine = ServeEngine(lm, batch_slots=1, max_len=prompt + new)
    return Served(engine, new), {"engine": time.perf_counter() - t0}

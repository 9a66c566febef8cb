"""Autoshard — the pod-level MATCH dispatcher.

The paper dispatches each layer to the execution module with minimum
predicted latency.  At pod scale the "modules" are *sharding strategies*;
the cost model is the three-term roofline (PodSpec).  This module:

1. builds legal :class:`ShardingRules` candidates for an (arch, shape,
   mesh) cell — divisibility-aware, exactly like the paper's pattern
   constraints reject illegal offloads (e.g. granite-moe's 40 experts on
   a 16-way axis);
2. scores each candidate analytically (compute / HBM / collective
   seconds per step);
3. returns the argmin rules + the predicted terms (verified later
   against the compiled dry-run in EXPERIMENTS.md §Roofline).

The port of ``repro.distributed.autoshard``, the same code: only jax's
``Mesh`` is replaced by any mesh :func:`repro_torch.launch.mesh.mesh_axes`
reads as ``{name: size}`` (a ``DeviceMesh``, an ``AbstractMesh``).  Its
pod model is the reference's ``PodSpec()``, the TPU v5e pod, so that the
port's choices equal the reference's: its seconds are that pod model's,
not the card's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import mesh_axes
from repro_torch.models.config import ModelConfig
from repro_torch.targets.tpu_v5e import PodSpec, V5E

__all__ = ["StrategyCost", "candidate_rules", "best_rules", "predict_cell"]


@dataclass(frozen=True)
class StrategyCost:
    name: str
    compute_s: float
    memory_s: float
    collective_s: float
    hbm_bytes_per_chip: float
    feasible: bool = True
    reason: str = ""

    @property
    def step_s(self) -> float:
        # async collectives overlap with compute up to the bigger of the two
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def bound(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)


def _mesh_axes(mesh) -> dict[str, int]:
    return mesh_axes(mesh)  # a DeviceMesh, an AbstractMesh


def _ffn_dims(cfg: ModelConfig) -> list[int]:
    dims = []
    if cfg.d_ff:
        dims.append(cfg.d_ff)
    if any(t == "rglru" for t in cfg.block_types):
        dims.append(cfg.lru_width or cfg.d_model)
    if any(t == "ssd" for t in cfg.block_types):
        dims.append(cfg.ssm_expand * cfg.d_model)
    return dims or [cfg.d_model]


def candidate_rules(
    cfg: ModelConfig, mesh, *, global_batch: int, seq: int
) -> dict[str, ShardingRules]:
    """Legal strategy candidates for this cell."""
    axes = _mesh_axes(mesh)
    model = axes.get("model", 1)
    dp_axes = tuple(a for a in ("pod", "data") if a in axes)
    dp = math.prod(axes[a] for a in dp_axes)

    def shed(cand_axes: tuple[str, ...]) -> tuple[str, ...]:
        # batch must divide across its axes; shed from the left (pod
        # first) until it does — batch=1 cells run without DP.
        while cand_axes and global_batch % math.prod(axes[a] for a in cand_axes):
            cand_axes = cand_axes[1:]
        return cand_axes

    batch_axes = shed(dp_axes)
    # pure-DP strategies use the model axis for batch too (all chips DP)
    all_batch_axes = shed(tuple(a for a in ("pod", "data", "model") if a in axes))

    div = lambda n: n % model == 0

    def tp_table() -> dict:
        t: dict = {
            "batch": batch_axes or None,
            "seq": None,
            "layers": None,
            "embed": None,
            "heads": "model" if div(cfg.n_heads) else None,
            "kv_heads": "model" if div(cfg.kv_heads) else None,
            "ffn": "model" if all(div(d) for d in _ffn_dims(cfg)) else None,
            "vocab": "model" if div(cfg.vocab) else None,
        }
        if cfg.is_moe:
            if cfg.n_experts % model == 0:
                t["experts"], t["moe_ffn"] = "model", None
            elif div(cfg.moe_d_ff):
                t["experts"], t["moe_ffn"] = None, "model"
            else:
                t["experts"], t["moe_ffn"] = None, None
        return t

    cands: dict[str, dict] = {}
    base = tp_table()
    cands["tp"] = base
    if cfg.is_moe and cfg.n_experts % model == 0 and div(cfg.moe_d_ff):
        # both EP and TP-experts are legal (dbrx): register both, cost decides
        alt = dict(base)
        alt["experts"], alt["moe_ffn"] = None, "model"
        cands["tp_experts"] = alt
        cands["ep"] = base
        del cands["tp"]
    dp_only = {k: None for k in base}
    dp_only["batch"] = all_batch_axes or None
    cands["dp_only"] = dp_only

    # FSDP variants: parameter "embed" dims additionally sharded over the
    # dp axes (ZeRO-3 semantics under GSPMD: weights all-gathered per
    # layer, grads reduce-scattered).  Required for 34B+ training and for
    # dbrx serving (bf16 params / 16-way TP alone exceed one chip's HBM).
    fsdp_axes = tuple(a for a in ("data", "pod") if a in axes)
    if fsdp_axes and cfg.d_model % math.prod(axes[a] for a in fsdp_axes) == 0:
        for name in list(cands):
            if name == "dp_only":
                continue
            t = dict(cands[name])
            t["embed"] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
            cands[name + "_fsdp"] = t

    # ZeRO-3: pure data parallelism with params fully sharded over BOTH
    # axes ("model" carries no activation TP — no per-layer activation
    # all-reduces, just weight all-gathers + grad reduce-scatters).  The
    # winning strategy for small dense models where TP is collective-bound.
    zero_axes = tuple(a for a in ("data", "model") if a in axes)
    zshards = math.prod(axes[a] for a in zero_axes)
    if zero_axes and cfg.d_model % zshards == 0:
        z = {k: None for k in base}
        z["batch"] = all_batch_axes or None
        z["embed"] = zero_axes
        # vocab/ffn stay unsharded: their tensors shard via the embed dim
        cands["zero3"] = z

    return {name: ShardingRules(mesh, t) for name, t in cands.items()}


# ---------------------------------------------------------------------------
# Analytical cost (per training step or serve step)
# ---------------------------------------------------------------------------


def _strategy_cost(
    name: str,
    cfg: ModelConfig,
    rules: ShardingRules,
    *,
    global_batch: int,
    seq: int,
    kind: str,
    pod: PodSpec = PodSpec(),
) -> StrategyCost:
    axes = _mesh_axes(rules.mesh)
    chips = math.prod(axes.values())
    model = axes.get("model", 1)
    t = rules.table
    tp = model if any(v == "model" for k, v in t.items() if k in ("heads", "ffn", "moe_ffn", "experts")) else 1
    dp_axes_used = [a for a in (t.get("batch") or ()) if a in axes]
    dp = math.prod(axes[a] for a in dp_axes_used) if dp_axes_used else 1
    # effective compute parallelism: mesh axes that shard neither batch
    # nor a model dimension replicate work and contribute nothing
    eff = max(dp * tp if "model" not in dp_axes_used else dp, 1)

    tokens = global_batch * seq if kind in ("train", "prefill") else global_batch
    n_active = cfg.n_active_params()
    flops_fwd = 2.0 * n_active * tokens
    # attention score flops (full-attn archs)
    attn_layers = sum(1 for bt in cfg.layer_pattern() if bt == "attn")
    local_layers = sum(1 for bt in cfg.layer_pattern() if bt == "local_attn")
    if kind in ("train", "prefill"):
        s_eff = seq
        flops_fwd += 2.0 * 2.0 * global_batch * cfg.n_heads * cfg.head_dim_ * (
            attn_layers * s_eff * s_eff / 2.0 + local_layers * s_eff * min(seq, cfg.local_window)
        )
    flops = flops_fwd * (3.0 if kind == "train" else 1.0)
    compute_s = flops / (eff * pod.chip.peak_flops_bf16)

    emb = t.get("embed")
    fsdp_axes = [a for a in ((emb,) if isinstance(emb, str) else (emb or ())) if a in axes]
    fsdp = math.prod(axes[a] for a in fsdp_axes) if fsdp_axes else 1

    # HBM: params read once per step per chip shard (+grad/opt traffic in train)
    param_bytes = cfg.n_params() * 2 / (tp * fsdp)
    if kind == "train":
        mem = param_bytes * (2 + 4 + 8) / 2  # bf16 read + grad + fp32 m/v rw
    elif kind == "decode":
        # decode is memory-bound: every weight + cache byte read per token
        cache_bytes = _cache_bytes(cfg, global_batch, seq) / max(
            math.prod(axes[a] for a in (t.get("batch") or ()) if a in axes), 1
        ) / (tp if tp > 1 else 1)
        mem = param_bytes + cache_bytes
    else:
        mem = param_bytes
    memory_s = mem / pod.chip.hbm_bytes_per_s

    # collectives
    coll = 0.0
    local_tokens = tokens / max(dp, 1)
    act_bytes = local_tokens * cfg.d_model * 2
    if tp > 1:
        # 2 all-reduces per layer (attn out + ffn out), fwd (+2x in bwd)
        per_layer = pod.all_reduce_s(act_bytes, tp)
        mult = 4.0 if kind == "train" else 2.0
        coll += cfg.n_layers * per_layer * mult / 2.0
    if kind == "train" and dp > 1:
        grad_bytes = cfg.n_params() * 2 / (tp * fsdp)
        coll += pod.all_reduce_s(grad_bytes, dp)
    if fsdp > 1:
        # ZeRO-3 weight all-gathers: fwd + bwd regather (train), 1x serve
        shard_bytes = cfg.n_params() * 2 / (tp * fsdp)
        gathers = 2.0 if kind == "train" else 1.0
        coll += gathers * pod.all_gather_s(shard_bytes * fsdp, fsdp)
    if cfg.is_moe and t.get("experts") == "model":
        # EP all-to-all: dispatched activations cross the model axis
        cap_tokens = local_tokens * cfg.top_k * cfg.capacity_factor
        a2a = pod.all_to_all_s(cap_tokens * cfg.d_model * 2 / model, model)
        coll += cfg.n_layers * a2a * (2.0 if kind != "train" else 4.0)
    elif cfg.is_moe and t.get("moe_ffn") == "model":
        # §Perf lesson (dbrx C1): TP-sharded expert hidden all-reduces the
        # FULL dispatch-space activations (top_k*cf inflated) every layer —
        # measured 34% worse than EP; charge it so the dispatcher prefers
        # EP whenever the expert count divides the axis.
        cap_tokens = local_tokens * cfg.top_k * cfg.capacity_factor
        ar = pod.all_reduce_s(cap_tokens * cfg.d_model * 2, model)
        coll += cfg.n_layers * ar * (2.0 if kind != "train" else 4.0)

    # feasibility: per-chip HBM (bf16 params + grads + fp32 master/m/v = 14 B)
    if kind == "train":
        resident = cfg.n_params() * 14 / (tp * fsdp)
    else:
        resident = cfg.n_params() * 2 / (tp * fsdp) + (
            _cache_bytes(cfg, global_batch, seq) / max(dp, 1) / tp if kind == "decode" else 0
        )
    feasible = resident <= pod.chip.hbm_capacity
    return StrategyCost(
        name,
        compute_s,
        memory_s,
        coll,
        resident,
        feasible,
        "" if feasible else f"resident {resident/2**30:.1f} GiB > HBM",
    )


def _cache_bytes(cfg: ModelConfig, batch: int, seq: int) -> float:
    total = 0.0
    for bt in cfg.layer_pattern():
        if bt == "attn":
            total += 2 * batch * seq * cfg.kv_heads * cfg.head_dim_ * 2
        elif bt == "local_attn":
            total += 2 * batch * min(seq, cfg.local_window) * cfg.kv_heads * cfg.head_dim_ * 2
        elif bt == "rglru":
            total += batch * (cfg.lru_width or cfg.d_model) * 4
        elif bt == "ssd":
            d_in = cfg.ssm_expand * cfg.d_model
            total += batch * (d_in // cfg.ssm_head_dim) * cfg.ssm_head_dim * cfg.ssm_state * 4
    return total


def best_rules(
    cfg: ModelConfig, mesh, *, global_batch: int, seq: int, kind: str
) -> tuple[str, ShardingRules, StrategyCost]:
    """MATCH-style argmin over sharding strategies."""
    cands = candidate_rules(cfg, mesh, global_batch=global_batch, seq=seq)
    best = None
    for name, rules in cands.items():
        c = _strategy_cost(name, cfg, rules, global_batch=global_batch, seq=seq, kind=kind)
        if not c.feasible:
            continue
        if best is None or c.step_s < best[2].step_s:
            best = (name, rules, c)
    if best is None:
        # report the least-infeasible for diagnostics
        name, rules = next(iter(cands.items()))
        c = _strategy_cost(name, cfg, rules, global_batch=global_batch, seq=seq, kind=kind)
        return name, rules, c
    return best


def predict_cell(cfg: ModelConfig, mesh, *, global_batch: int, seq: int, kind: str) -> dict:
    """All candidates with their predicted roofline terms (for reports)."""
    cands = candidate_rules(cfg, mesh, global_batch=global_batch, seq=seq)
    out = {}
    for name, rules in cands.items():
        c = _strategy_cost(name, cfg, rules, global_batch=global_batch, seq=seq, kind=kind)
        out[name] = {
            "compute_s": c.compute_s,
            "memory_s": c.memory_s,
            "collective_s": c.collective_s,
            "step_s": c.step_s,
            "bound": c.bound,
            "feasible": c.feasible,
            "hbm_gib_per_chip": c.hbm_bytes_per_chip / 2**30,
        }
    return out

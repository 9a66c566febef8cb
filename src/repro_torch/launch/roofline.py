"""Roofline analysis (the port of ``repro.launch.roofline``), priced on the
card.

Per (arch x shape) cell on a production mesh, the three roofline terms
from the dry-run's records (:mod:`repro_torch.launch.dryrun`):

  compute term    = flops_per_chip / chip peak (bf16)                [s]
  memory term     = bytes_per_chip / chip memory rate                 [s]
  collective term = collective_bytes_per_chip / collective rate       [s]

The reference's protocol is kept: the cell is dry-run at depth p and 2p
(p = block-pattern period) with the strategy the full-depth config picks,
and each count is extrapolated to the full depth,
``total = f(p) + (f(2p) - f(p)) * (L - p) / p``.  ``MODEL_FLOPS`` is
6*N(_active)*D (the 6 for the train step's forward and backward), and
``MODEL_FLOPS / flops_global`` exposes remat and dispatch waste.

What changes against the reference: the chip is an argument,
:class:`ChipRates`, and defaults to the card (``targets.h100.H100``: the
bf16 tensor-core peak, HBM3, NVLink 4); ``ChipRates.of_v5e()`` gives the
reference's v5e numbers.  The dry-run's counts are the port's (flops and
bytes of each rank's local ops, collectives DTensor issued; see
:mod:`~repro_torch.launch.dryrun`), not XLA's: its bytes are unfused, so
the memory term is an upper bound.  :func:`roofline_terms` does the
arithmetic on two records, so any two records (the reference's too) can
be priced alike.  :func:`attention_flops` is the sequence term that
``model_flops`` leaves out, for the bound :func:`flops_ratio` states.

Usage:
  python -m repro_torch.launch.roofline --arch qwen2_5_3b --shape train_4k [--strategy S] [--remat R] [--tag T]
  python -m repro_torch.launch.roofline --all [--resume]
"""

from __future__ import annotations

import argparse
import gc
import json
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

from repro_torch.configs import ALL_ARCHS, SHAPES, cell_applicable, get_config
from repro_torch.targets.h100 import H100
from repro_torch.targets.tpu_v5e import V5E

__all__ = [
    "ChipRates",
    "analyse_cell",
    "attention_flops",
    "flops_ratio",
    "fmt_row",
    "model_flops",
    "roofline_terms",
    "main",
]

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "roofline"


@dataclass(frozen=True)
class ChipRates:
    """The three rates a roofline prices with."""

    name: str
    peak_flops: float
    hbm_bytes_per_s: float
    collective_bytes_per_s: float

    @classmethod
    def of_h100(cls) -> "ChipRates":
        return cls("h100", H100.peak_flops_bf16, H100.hbm_bytes_per_s, H100.nvlink_bytes_per_s)

    @classmethod
    def of_v5e(cls) -> "ChipRates":
        """The reference's ``PEAK``, ``HBM`` and ``ICI``."""
        return cls("tpu_v5e", V5E.peak_flops_bf16, V5E.hbm_bytes_per_s, V5E.ici_link_bytes_per_s * V5E.ici_links_per_axis)


def _cost_triple(rec: dict) -> tuple[float, float, float]:
    f = rec.get("cost_analysis_flops") or 0.0
    b = rec.get("cost_analysis_bytes") or 0.0
    c = rec.get("collectives", {}).get("total_bytes", 0.0) or 0.0
    return float(f), float(b), float(c)


def model_flops(cfg, cell) -> float:
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    f = 2.0 * cfg.n_active_params() * tokens
    if cell.kind == "train":
        f *= 3.0
    return f


def attention_flops(cfg, cell) -> float:
    """The attention scores' and values' flops that :func:`model_flops`
    leaves out, for a train or prefill cell: 4 * S_k * H * head_dim per
    token and attention layer forward, S_k the keys a query sees without
    causal skipping (the window for ``local_attn``), x3 for the train step
    (PaLM's 12 * L * H * Q * T)."""
    if cell.kind == "decode":
        return 0.0
    tokens = cell.global_batch * cell.seq_len
    per_token = 0.0
    for bt in cfg.layer_pattern():
        if bt == "attn":
            per_token += 4.0 * cell.seq_len * cfg.n_heads * cfg.head_dim_
        elif bt == "local_attn":
            per_token += 4.0 * min(cell.seq_len, cfg.local_window) * cfg.n_heads * cfg.head_dim_
    return per_token * tokens * (3.0 if cell.kind == "train" else 1.0)


# the forward a train step recomputes per remat policy: "full" runs each
# layer's forward twice (4/3 of forward + backward)
_REMAT_FACTOR = {"none": 1.0, "dots": 1.0, "full": 4.0 / 3.0}


def flops_ratio(flops_global: float, cfg, cell) -> float:
    """Counted flops over what the step's matmuls need: the layers' share
    of :func:`model_flops` and :func:`attention_flops`, x the remat
    policy's recompute, plus the LM head's matmul (the embedding lookup
    does none, and the head is not recomputed).  The dry-run's count is
    about that (the kernels' plain versions computing every score of the
    causal square) and adds the SSD chunk terms, the MoE capacity slack
    and the work DTensor replicates across a mesh axis."""
    head = cfg.vocab * cfg.d_model
    tables = head * (1 if cfg.tie_embeddings else 2)
    per_param = model_flops(cfg, cell) / cfg.n_active_params()
    remat = _REMAT_FACTOR[cfg.remat] if cell.kind == "train" else 1.0
    need = remat * (per_param * (cfg.n_active_params() - tables) + attention_flops(cfg, cell)) + per_param * head
    return flops_global / need


def roofline_terms(rec1: dict, rec2: dict, cfg, cell, chip: ChipRates) -> dict:
    """The reference's depth extrapolation and three terms, from the
    depth-p and depth-2p records of one cell, priced on ``chip``."""
    p = len(cfg.block_types)
    L = cfg.n_layers
    f1, b1, c1 = _cost_triple(rec1)
    f2, b2, c2 = _cost_triple(rec2)
    scale = (L - p) / p
    flops_pc = f1 + (f2 - f1) * scale
    bytes_pc = b1 + (b2 - b1) * scale
    coll_pc = c1 + (c2 - c1) * scale

    chips = rec1["chips"]
    compute_s = flops_pc / chip.peak_flops
    memory_s = bytes_pc / chip.hbm_bytes_per_s
    coll_s = coll_pc / chip.collective_bytes_per_s
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bound = max(terms, key=terms.get)
    step_s = max(terms.values())

    mf = model_flops(cfg, cell)
    hlo_global = flops_pc * chips
    ratio = mf / hlo_global if hlo_global else 0.0
    mfu_proxy = mf / (chips * chip.peak_flops * step_s) if step_s else 0.0
    return {
        "protocol": {"p": p, "L": L, "f_p": f1, "f_2p": f2, "bytes_p": b1, "bytes_2p": b2, "coll_p": c1, "coll_2p": c2},
        "flops_per_chip": flops_pc,
        "bytes_per_chip": bytes_pc,
        "collective_bytes_per_chip": coll_pc,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "bound": bound,
        "step_s": step_s,
        "model_flops": mf,
        "hlo_flops_global": hlo_global,
        "model_to_hlo_ratio": ratio,
        "mfu_proxy": mfu_proxy,
    }


_SUGGESTIONS = {
    "compute": "raise useful-FLOP share: relax remat (dots policy), fuse epilogues, larger per-chip batch",
    "memory": "cut HBM traffic: better fusion/layout, avoid re-materialized activations, bf16 end-to-end, larger tiles",
    "collective": "cut wire bytes: fewer all-gathers (FSDP prefetch once), int8 grad compression, overlap via microbatch accumulation, reshard axes",
}


def analyse_cell(
    arch: str,
    shape: str,
    *,
    strategy: str | None = None,
    remat: str | None = None,
    mesh_kind: str = "single",
    overrides: dict | None = None,
    chip: ChipRates | None = None,
) -> dict:
    """Depth-extrapolated roofline terms for one cell, in a process that
    holds the fake group of the mesh (:func:`repro_torch.launch.dryrun.fake_group`)."""
    from repro_torch.distributed.autoshard import best_rules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh, production_shape

    chip = chip or ChipRates.of_h100()
    cfg = get_config(arch)
    cell = SHAPES[shape]
    p = len(cfg.block_types)

    if strategy is None:
        # strategy must come from the FULL config (feasibility differs at
        # reduced depth: dbrx needs FSDP at 40 layers, not at 1)
        amesh = AbstractMesh(*production_shape(mesh_kind == "multi"))
        strategy, _, _ = best_rules(cfg, amesh, global_batch=cell.global_batch, seq=cell.seq_len, kind=cell.kind)

    rec1 = dryrun.run_cell(arch, shape, mesh_kind, strategy=strategy, depth_override=p, remat_override=remat, overrides=overrides)
    rec2 = dryrun.run_cell(arch, shape, mesh_kind, strategy=strategy, depth_override=2 * p, remat_override=remat, overrides=overrides)
    terms = roofline_terms(rec1, rec2, cfg, cell, chip)
    return {
        "arch": arch,
        "shape": shape,
        "overrides": overrides,
        "mesh": mesh_kind,
        "chips": rec1["chips"],
        "strategy": strategy,
        "remat": rec1["remat"],
        "chip": chip.name,
        **terms,
        "suggestion": _SUGGESTIONS[terms["bound"]],
        "collectives_by_kind_2p": rec2.get("collectives", {}).get("bytes_by_kind", {}),
        "records": {"p": rec1, "2p": rec2},
    }


def fmt_row(r: dict) -> str:
    return (
        f"| {r['arch']} | {r['shape']} | {r['strategy']} | {r['compute_s']*1e3:.1f} | "
        f"{r['memory_s']*1e3:.1f} | {r['collective_s']*1e3:.1f} | {r['bound']} | "
        f"{r['model_to_hlo_ratio']:.2f} | {r['mfu_proxy']*100:.1f}% |"
    )


def _parse_overrides(pairs: list[str]) -> dict:
    ov = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                pass
        ov[k] = v
    return ov


def main(argv=None) -> None:
    from repro_torch.launch.dryrun import fake_group

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--strategy", default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--set", action="append", default=[], help="cfg override k=v")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out-dir", default=str(OUT_DIR), help="where each cell's JSON record goes")
    args = ap.parse_args(argv)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cells: list[tuple[str, str]] = []
    if args.all:
        for arch in ALL_ARCHS:
            cfg = get_config(arch)
            for shape in SHAPES:
                if cell_applicable(cfg, shape)[0]:
                    cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    failed = 0
    for arch, shape in cells:
        tag = f"__{args.tag}" if args.tag else ""
        out = out_dir / f"{arch}__{shape}{tag}.json"
        if args.resume and out.exists() and "error" not in json.loads(out.read_text()):
            print(f"[skip] {out.name}")
            continue
        t0 = time.time()
        try:
            with fake_group("single"):
                r = analyse_cell(arch, shape, strategy=args.strategy, remat=args.remat,
                                 overrides=_parse_overrides(args.set) or None)
            cfg, cell = get_config(arch), SHAPES[shape]
            print(
                f"[roofline] {arch} x {shape}: bound={r['bound']} "
                f"c/m/x = {r['compute_s']*1e3:.1f}/{r['memory_s']*1e3:.1f}/{r['collective_s']*1e3:.1f} ms "
                f"mfu~{r['mfu_proxy']*100:.1f}% ratio={r['model_to_hlo_ratio']:.2f} "
                f"flops/need={flops_ratio(r['hlo_flops_global'], cfg, cell):.3f} ({time.time()-t0:.0f}s)",
                flush=True,
            )
        except Exception as e:  # a cell that fails is recorded, as the reference's sweep records it
            failed += 1
            r = {"arch": arch, "shape": shape, "error": f"{type(e).__name__}: {e}",
                 "traceback": traceback.format_exc()[-3000:]}
            print(f"[roofline] {arch} x {shape}: ERROR {str(e)[:150]}", flush=True)
        out.write_text(json.dumps(r, indent=1, default=str))
        print(f"[roofline] record: {out}", flush=True)
        gc.collect()
    if failed:
        raise SystemExit(f"{failed} of {len(cells)} cells failed")


if __name__ == "__main__":
    main()

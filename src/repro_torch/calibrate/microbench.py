"""Microbenchmark harness: generated workloads -> measured SegmentTimings.

The port of ``repro.calibrate.microbench``, the measurement half of the
calibration loop: sweep a set of generated conv / dwconv / dense
workloads per (target, execution module) through the full ``dispatch ->
lower -> run(timed=True)`` pipeline and collect one
:class:`MicrobenchSample` per executed segment — its *uncalibrated*
cost-model features (``CostBreakdown.features()``) paired with its
measured time, converted to module-clock cycles.

Per-module coverage is guaranteed by sweeping both the full target and
each module in isolation (``MatchTarget.restricted``, the paper's
Table IV ablation hook), so the fitter sees samples even for modules the
dispatcher would never pick cold.  A module that no swept pattern lands
on in its own restriction (the card's ``tensor_core``: no CNN pattern is
registered there, so its variant falls back to ``aten``) gets no sample
and stays as declared; :func:`unsampled_modules` names such modules.

A sample holds what ``CompiledModel.run(timed=True)`` measures, the
reference's contract: on the card, CUDA events around one eager call of
the segment's executor, host launch gaps between its kernels included;
on the CPU, the host clock.  Timings take the min over ``repeats`` runs
(after a warmup, so kernel builds and cuDNN's algorithm search are
excluded) — the standard microbenchmark de-noising.  The sweep runs on
the CUDA device unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np

from repro_torch.cnn.execute import params_to_torch
from repro_torch.core import Graph, MatchTarget, Node, dispatch

__all__ = [
    "MicrobenchSample",
    "unsampled_modules",
    "default_sweep",
    "dense_block_graph",
    "graph_io",
    "run_microbench",
    "collect_samples",
    "save_samples",
    "load_samples",
]


@dataclass(frozen=True)
class MicrobenchSample:
    """One measured segment execution with its predicted-cost features."""

    graph: str
    segment: str
    module: str
    pattern: str
    route: str
    l_ops: float
    l_mem: float
    async_dma: bool
    predicted_cycles: float
    measured_us: float
    frequency_hz: float

    @property
    def measured_cycles(self) -> float:
        """Measured wall-clock expressed in the module's clock domain —
        the quantity the fitter regresses the model features against.

        Raises on an unset (``<= 0``) frequency instead of silently
        yielding 0 cycles: a zeroed sample would drag the least-squares
        fit toward a degenerate all-zero model, which is far worse than
        failing the sweep loudly (the warn-only path lives in
        ``repro_torch.backend.runtime.SegmentTiming``).
        """
        if self.frequency_hz <= 0.0:
            raise ValueError(
                f"microbench sample {self.graph}/{self.segment} on "
                f"{self.module} has frequency_hz={self.frequency_hz}; an "
                "unset module clock would zero measured_cycles and poison "
                "the calibration fit — declare ExecutionModule.frequency_hz"
            )
        return self.measured_us * 1e-6 * self.frequency_hz

    def to_dict(self) -> dict:
        return {
            "graph": self.graph,
            "segment": self.segment,
            "module": self.module,
            "pattern": self.pattern,
            "route": self.route,
            "l_ops": self.l_ops,
            "l_mem": self.l_mem,
            "async_dma": self.async_dma,
            "predicted_cycles": self.predicted_cycles,
            "measured_us": self.measured_us,
            "frequency_hz": self.frequency_hz,
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "MicrobenchSample":
        return cls(
            graph=str(d["graph"]),
            segment=str(d["segment"]),
            module=str(d["module"]),
            pattern=str(d.get("pattern", "")),
            route=str(d.get("route", "")),
            l_ops=float(d["l_ops"]),
            l_mem=float(d["l_mem"]),
            async_dma=bool(d["async_dma"]),
            predicted_cycles=float(d["predicted_cycles"]),
            measured_us=float(d["measured_us"]),
            frequency_hz=float(d["frequency_hz"]),
        )


# ---------------------------------------------------------------------------
# Workload generation
# ---------------------------------------------------------------------------


def dense_block_graph(*, K: int, C: int, B: int = 1, relu: bool = False) -> Graph:
    """dense + bias + requant (+relu) microbenchmark block, int8/NHWC —
    the DAE-style workload the conv sweep cannot cover."""
    geom = {"B": B, "K": K, "C": C, "elem_bytes": 1}
    nodes = [
        Node("dense1", "dense", ("x",), dict(geom)),
        Node("bias1", "bias_add", ("dense1",), dict(geom)),
        Node("requant1", "requant", ("bias1",), dict(geom)),
    ]
    out = "requant1"
    if relu:
        nodes.append(Node("relu1", "relu", ("requant1",), dict(geom)))
        out = "relu1"
    return Graph(f"dense_{C}to{K}", nodes, {"x": (B, C)}, (out,))


def default_sweep(quick: bool = False) -> list[Graph]:
    """The generated-workload sweep: conv / dwconv / dense geometries
    spanning the MLPerf-Tiny layer range (paper Sec. VI-A micro-bench
    shapes).  ``quick`` keeps one representative per op family — the CI
    smoke sweep."""
    from repro_torch.cnn import conv_block_graph

    if quick:
        return [
            conv_block_graph(IX=16, IY=16, C=16, K=32),
            conv_block_graph(IX=16, IY=16, C=16, K=16, depthwise=True),
            dense_block_graph(K=64, C=256),
        ]
    return [
        conv_block_graph(IX=32, IY=32, C=8, K=16),
        conv_block_graph(IX=16, IY=16, C=16, K=32),
        conv_block_graph(IX=8, IY=8, C=32, K=64),
        conv_block_graph(IX=16, IY=16, C=32, K=32, FY=1, FX=1),
        conv_block_graph(IX=16, IY=16, C=16, K=16, depthwise=True),
        conv_block_graph(IX=32, IY=32, C=8, K=8, depthwise=True),
        dense_block_graph(K=128, C=128),
        dense_block_graph(K=64, C=256),
        dense_block_graph(K=16, C=64),
    ]


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------


def graph_io(g: Graph, seed: int = 0):
    """Deterministic (params, inputs) for one graph — one shared rng, so
    multi-input graphs do not receive byte-identical streams."""
    from repro_torch.cnn import init_graph_params

    params = init_graph_params(g)
    rng = np.random.default_rng(seed)
    x = {k: rng.integers(-128, 128, s).astype("float32") for k, s in g.inputs.items()}
    return params, x


def collect_samples(compiled, params, inputs, *, repeats: int = 3) -> list[MicrobenchSample]:
    """Run ``compiled`` timed ``repeats`` times (plus one warmup) and pair
    every scheduled segment's cost-model features with its min measured
    time.  Structural (schedule-less) segments carry no model features
    and are skipped.  Runs on ``compiled.device``: the params are
    converted there once, so no repeat copies the weights again."""
    params = params_to_torch(params, compiled.device)
    compiled.run(params, inputs)  # warmup: kernel builds excluded from timing
    best_us: dict[str, float] = {}
    for _ in range(max(1, repeats)):
        compiled.run(params, inputs, timed=True)
        for tm in compiled.last_timings:
            us = best_us.get(tm.name)
            best_us[tm.name] = tm.measured_us if us is None else min(us, tm.measured_us)

    target = compiled.target
    samples: list[MicrobenchSample] = []
    for ls in compiled.segments:
        seg = ls.segment
        if seg.schedule is None or ls.name not in best_us:
            continue
        module = target.module(seg.module)
        if module.frequency_hz <= 0.0:
            raise ValueError(
                f"module {module.name} declares frequency_hz="
                f"{module.frequency_hz}; cannot convert measured wall-clock "
                "to cycles — fix the target declaration before sweeping"
            )
        feats = seg.schedule.cost.features()
        samples.append(
            MicrobenchSample(
                graph=compiled.graph.name,
                segment=ls.name,
                module=seg.module,
                pattern=seg.pattern,
                route=ls.route,
                l_ops=feats["l_ops"],
                l_mem=feats["l_mem"],
                async_dma=module.async_dma,
                predicted_cycles=seg.cycles,
                measured_us=best_us[ls.name],
                frequency_hz=module.frequency_hz,
            )
        )
    return samples


def run_microbench(
    target: MatchTarget | str,
    *,
    sweep: Sequence[Graph] | None = None,
    repeats: int = 3,
    budget: int = 300,
    per_module: bool = True,
    quick: bool = False,
    verbose: bool = False,
    device=None,
) -> list[MicrobenchSample]:
    """Sweep generated workloads through dispatch/lower/run(timed=True).

    ``per_module=True`` additionally dispatches the sweep on each
    single-module restriction of the target (and fallback-only), so every
    execution module contributes samples regardless of what the cost
    model would pick — without it, a grossly mispriced module would never
    be measured and so never corrected.  ``device`` is where the sweep
    runs (``lower(..., device=)``): CUDA unless the caller asks for
    ``"cpu"``; without a card the default raises.
    """
    from repro_torch._device import resolve_device
    from repro_torch.backend import lower

    dev = resolve_device(device)  # before any work: no card, no sweep
    if isinstance(target, str):
        # always sweep the *declared* model: a MATCH_CALIBRATION_PROFILE
        # env default would make the fitter correct an already-corrected
        # model (its features must stay uncalibrated)
        from repro_torch.targets.registry import get_target

        tgt = get_target(target, profile=None)
    else:
        tgt = target
    graphs = list(sweep) if sweep is not None else default_sweep(quick=quick)

    variants: list[MatchTarget] = [tgt]
    if per_module:
        for m in tgt.modules:
            variants.append(tgt.restricted([m.name]))
        variants.append(tgt.restricted([]))  # fallback (CPU) only

    from repro_torch import obs

    samples: list[MicrobenchSample] = []
    with obs.span(
        "calibrate.microbench", cat="compile", target=tgt.name,
        variants=len(variants), workloads=len(graphs),
    ) as sweep_span:
        for variant in variants:
            for g in graphs:
                mapped = dispatch(g, variant, budget=budget)
                compiled = lower(mapped, device=dev)
                params, x = graph_io(g)
                got = collect_samples(compiled, params, x, repeats=repeats)
                samples.extend(got)
                if verbose:
                    print(
                        f"  microbench {variant.name:>20s} / {g.name:<24s} -> "
                        f"{len(got)} samples"
                    )
        sweep_span.set(samples=len(samples))
    obs.counter("calibrate.microbench_samples").inc(len(samples))
    return samples


def unsampled_modules(target: MatchTarget, samples: Sequence[MicrobenchSample]) -> list[str]:
    """The modules of ``target`` (fallback included) that no sample
    measured: a fit leaves them as declared."""
    seen = {s.module for s in samples}
    return [m.name for m in (*target.modules, target.fallback) if m.name not in seen]


# ---------------------------------------------------------------------------
# Sample persistence (the sweep artifact the CLI / CI pass to the fitter)
# ---------------------------------------------------------------------------

SAMPLES_VERSION = 1


def save_samples(
    path: str | os.PathLike,
    samples: Sequence[MicrobenchSample],
    *,
    target: str = "",
    meta: Mapping | None = None,
) -> Path:
    p = Path(path).expanduser()
    p.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "version": SAMPLES_VERSION,
        "target": target,
        "meta": dict(meta or {}),
        "samples": [s.to_dict() for s in samples],
    }
    tmp = p.with_suffix(p.suffix + ".tmp")
    tmp.write_text(json.dumps(payload, indent=2, sort_keys=True))
    tmp.replace(p)
    return p


def load_samples(path: str | os.PathLike) -> tuple[str, list[MicrobenchSample]]:
    raw = json.loads(Path(path).expanduser().read_text())
    if not isinstance(raw, dict) or raw.get("version") != SAMPLES_VERSION:
        raise ValueError(f"unrecognized microbench samples file {path}")
    return str(raw.get("target", "")), [
        MicrobenchSample.from_dict(d) for d in raw["samples"]
    ]

"""Least-squares fitting of abstract-model parameters from measurements.

The analytical cost model (``repro_torch.core.cost_model``) predicts a segment
latency that is *affine in two features* of the uncalibrated breakdown —
``L_ops`` and ``L_mem`` (``CostBreakdown.features()``):

* synchronous DMA:    latency = a*L_ops + b*L_mem + c
* async double-buffer: latency = a*max(L_ops, L_mem) + c

:func:`fit_profile` solves (a, b, c) per execution module by least
squares over microbenchmark samples (measured wall-clock converted to
module-clock cycles), which is exactly solving for the *effective*
macs/cycle (1/a rescales every compute constant), per-level bandwidths
(1/b) and fixed setup/handoff cycles (c).  The solved coefficients are
reproduced bit-for-bit by the cost model once
:meth:`repro_torch.core.ExecutionModule.recalibrated` applies them, so the DSE
re-ranks candidates under the fitted — not assumed — hardware model.

Degenerate modules fall back conservatively: negative/singular solutions
drop to a constant-free fit, then to a single ratio on the combined
feature, then to identity; a module with no samples stays as declared.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from .microbench import MicrobenchSample
from .profile import CalibrationProfile, ModuleCalibration, PROFILE_VERSION

__all__ = ["fit_profile", "fit_module", "profile_errors"]


def _mae(pred: np.ndarray, y: np.ndarray) -> float:
    return float(np.mean(np.abs(pred - y))) if len(y) else 0.0


def _combined(l_ops: np.ndarray, l_mem: np.ndarray, async_dma: bool) -> np.ndarray:
    return np.maximum(l_ops, l_mem) if async_dma else l_ops + l_mem


def fit_module(samples: Sequence[MicrobenchSample]) -> ModuleCalibration:
    """Fit (compute_scale, mem_scale, fixed_overhead_cycles) for one
    module from its samples.  All samples must share the module's DMA
    semantics (they do: ``async_dma`` comes from the module)."""
    if not samples:
        return ModuleCalibration()
    async_dma = samples[0].async_dma
    l_ops = np.array([s.l_ops for s in samples], dtype=np.float64)
    l_mem = np.array([s.l_mem for s in samples], dtype=np.float64)
    y = np.array([s.measured_cycles for s in samples], dtype=np.float64)
    pred_before = np.array([s.predicted_cycles for s in samples], dtype=np.float64)
    mae_before = _mae(pred_before, y)

    def solve(cols: list[np.ndarray]) -> np.ndarray | None:
        X = np.stack(cols, axis=1)
        try:
            coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        except np.linalg.LinAlgError:
            return None
        return coef if np.all(np.isfinite(coef)) else None

    one = np.ones_like(y)
    a = b = c = None
    if async_dma:
        comb = _combined(l_ops, l_mem, True)
        coef = solve([comb, one])
        if coef is not None and coef[0] > 0 and coef[1] >= 0:
            a = b = float(coef[0])
            c = float(coef[1])
        else:
            coef = solve([comb])
            if coef is not None and coef[0] > 0:
                a = b = float(coef[0])
                c = 0.0
    else:
        coef = solve([l_ops, l_mem, one])
        if coef is not None and coef[0] > 0 and coef[1] > 0 and coef[2] >= 0:
            a, b, c = float(coef[0]), float(coef[1]), float(coef[2])
        else:
            coef = solve([l_ops, l_mem])
            if coef is not None and coef[0] > 0 and coef[1] > 0:
                a, b, c = float(coef[0]), float(coef[1]), 0.0
    if a is None:
        # last resort: one ratio on the combined feature (always >= 0;
        # guards the all-zero-feature corner with an identity fit)
        comb = _combined(l_ops, l_mem, async_dma)
        denom = float(np.dot(comb, comb))
        ratio = float(np.dot(comb, y)) / denom if denom > 0 else 1.0
        a = b = ratio if ratio > 0 else 1.0
        c = 0.0

    mc = ModuleCalibration(
        compute_scale=a,
        mem_scale=b,
        fixed_overhead_cycles=c,
        samples=len(samples),
        mae_before=mae_before,
    )
    pred_after = np.array(
        [mc.predict_cycles(s.l_ops, s.l_mem, async_dma) for s in samples]
    )
    mae_after = _mae(pred_after, y)
    if mae_after > mae_before:
        # least squares minimises squared error, not MAE: on the rare
        # adversarial sample set where MAE regresses, keep the declared
        # model rather than ship a profile that measures worse
        return ModuleCalibration(samples=len(samples), mae_before=mae_before, mae_after=mae_before)
    return ModuleCalibration(
        compute_scale=a,
        mem_scale=b,
        fixed_overhead_cycles=c,
        samples=len(samples),
        mae_before=mae_before,
        mae_after=mae_after,
    )


def fit_profile(
    samples: Sequence[MicrobenchSample],
    *,
    target_name: str,
    meta: Mapping | None = None,
) -> CalibrationProfile:
    """Fit one :class:`ModuleCalibration` per module seen in ``samples``."""
    by_module: dict[str, list[MicrobenchSample]] = {}
    for s in samples:
        by_module.setdefault(s.module, []).append(s)
    modules = {name: fit_module(group) for name, group in sorted(by_module.items())}
    return CalibrationProfile(
        target=target_name,
        modules=modules,
        meta={"n_samples": len(samples), **dict(meta or {})},
        version=PROFILE_VERSION,
    )


def profile_errors(
    samples: Sequence[MicrobenchSample], profile: CalibrationProfile | None
) -> dict:
    """Mean |predicted - measured| cycles over ``samples``, before (the
    declared model) and after applying ``profile``'s linear corrections."""
    if not samples:
        return {"n": 0, "mae_before": 0.0, "mae_after": 0.0}
    y = np.array([s.measured_cycles for s in samples])
    before = np.array([s.predicted_cycles for s in samples])
    after = []
    for s in samples:
        mc = (profile.modules.get(s.module) if profile else None) or ModuleCalibration()
        after.append(mc.predict_cycles(s.l_ops, s.l_mem, s.async_dma))
    return {
        "n": len(samples),
        "mae_before": _mae(before, y),
        "mae_after": _mae(np.array(after), y),
    }

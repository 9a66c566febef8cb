"""Versioned, persisted calibration profiles.

A :class:`CalibrationProfile` is the artifact the measure → fit → re-rank
loop produces: per-execution-module overrides for the abstract hardware
model — an effective compute scale (rescaling macs/cycle constants), a
memory scale (rescaling per-level bandwidths + chunk overheads) and a
fixed per-segment overhead — solved by :mod:`repro_torch.calibrate.fit`
from :mod:`repro_torch.calibrate.microbench` measurements.

Profiles persist as versioned JSON (``{"version": N, ...}``) with the
same warn-and-fallback hardening as the schedule cache: a corrupt,
stale or foreign profile file emits :class:`CalibrationProfileWarning`
and the declared (uncalibrated) target is used — a profile file must
never fail a compile.  ``repro_torch.targets.registry.get_target(name,
profile=...)`` and the ``MATCH_CALIBRATION_PROFILE`` environment variable
apply profiles without editing any target file.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Mapping

from repro_torch.core.target import MatchTarget
from repro_torch.obs.log import MatchWarning
from repro_torch.obs.log import warn as obs_warn

__all__ = [
    "PROFILE_VERSION",
    "PROFILE_ENV",
    "CalibrationProfileWarning",
    "ModuleCalibration",
    "CalibrationProfile",
    "load_profile",
    "coerce_profile",
    "apply_profile",
    "profile_matches_target",
]

# Bump when the meaning of the stored coefficients changes (e.g. the
# features they multiply move): stale profiles must warn-and-miss.
PROFILE_VERSION = 1
PROFILE_ENV = "MATCH_CALIBRATION_PROFILE"


class CalibrationProfileWarning(MatchWarning):
    """A calibration profile could not be applied (corrupt, stale, or for
    another target) and the declared hardware model is used instead."""


@dataclass(frozen=True)
class ModuleCalibration:
    """Fitted overrides for one execution module.

    ``compute_scale`` multiplies predicted L_ops, ``mem_scale`` predicted
    L_mem, and ``fixed_overhead_cycles`` is charged once per segment
    execution after the L_ops/L_mem combine — exactly the transform
    :meth:`repro_torch.core.ExecutionModule.recalibrated` applies, so the
    linear model the fitter solved is reproduced by the cost model.
    ``samples`` / ``mae_before`` / ``mae_after`` record fit provenance.
    """

    compute_scale: float = 1.0
    mem_scale: float = 1.0
    fixed_overhead_cycles: float = 0.0
    samples: int = 0
    mae_before: float = 0.0
    mae_after: float = 0.0

    def predict_cycles(self, l_ops: float, l_mem: float, async_dma: bool) -> float:
        """Calibrated latency for an *uncalibrated* (l_ops, l_mem) pair —
        mirrors evaluate_mapping on the recalibrated module."""
        a, b, c = self.compute_scale, self.mem_scale, self.fixed_overhead_cycles
        if async_dma:
            return max(a * l_ops, b * l_mem) + c
        return a * l_ops + b * l_mem + c

    def is_identity(self) -> bool:
        return (
            self.compute_scale == 1.0
            and self.mem_scale == 1.0
            and self.fixed_overhead_cycles == 0.0
        )

    def to_dict(self) -> dict:
        return {
            "compute_scale": self.compute_scale,
            "mem_scale": self.mem_scale,
            "fixed_overhead_cycles": self.fixed_overhead_cycles,
            "samples": self.samples,
            "mae_before": self.mae_before,
            "mae_after": self.mae_after,
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "ModuleCalibration":
        mc = cls(
            compute_scale=float(d.get("compute_scale", 1.0)),
            mem_scale=float(d.get("mem_scale", 1.0)),
            fixed_overhead_cycles=float(d.get("fixed_overhead_cycles", 0.0)),
            samples=int(d.get("samples", 0)),
            mae_before=float(d.get("mae_before", 0.0)),
            mae_after=float(d.get("mae_after", 0.0)),
        )
        if (
            not math.isfinite(mc.compute_scale)
            or not math.isfinite(mc.mem_scale)
            or not math.isfinite(mc.fixed_overhead_cycles)
            or mc.compute_scale <= 0
            or mc.mem_scale <= 0
            or mc.fixed_overhead_cycles < 0
        ):
            raise ValueError(f"non-finite or non-positive calibration values: {d}")
        return mc


@dataclass
class CalibrationProfile:
    """Per-target calibration: module name -> :class:`ModuleCalibration`."""

    target: str
    modules: dict[str, ModuleCalibration] = field(default_factory=dict)
    meta: dict = field(default_factory=dict)
    version: int = PROFILE_VERSION

    def fingerprint(self) -> str:
        """Content hash — stamped into module attrs so schedule-cache keys
        distinguish every distinct profile (and the uncalibrated model)."""
        payload = json.dumps(
            {
                "version": self.version,
                "target": self.target,
                "modules": {k: v.to_dict() for k, v in sorted(self.modules.items())},
            },
            sort_keys=True,
        )
        return hashlib.sha1(payload.encode()).hexdigest()[:16]

    def tag(self) -> str:
        return f"v{self.version}:{self.fingerprint()}"

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "target": self.target,
            "modules": {k: v.to_dict() for k, v in sorted(self.modules.items())},
            "meta": dict(self.meta),
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "CalibrationProfile":
        if not isinstance(d, Mapping) or "modules" not in d or "target" not in d:
            raise ValueError("unrecognized profile format")
        version = d.get("version")
        if version != PROFILE_VERSION:
            raise ValueError(
                f"stale version {version!r} (this build reads {PROFILE_VERSION})"
            )
        mods = d["modules"]
        if not isinstance(mods, Mapping):
            raise ValueError("modules field is not a mapping")
        return cls(
            target=str(d["target"]),
            modules={str(k): ModuleCalibration.from_dict(v) for k, v in mods.items()},
            meta=dict(d.get("meta", {})),
            version=int(version),
        )

    def save(self, path: str | os.PathLike) -> Path:
        p = Path(path).expanduser()
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(p.suffix + ".tmp")
        tmp.write_text(json.dumps(self.to_dict(), indent=2, sort_keys=True))
        tmp.replace(p)
        return p


def load_profile(path: str | os.PathLike) -> CalibrationProfile | None:
    """Read a persisted profile; any defect warns and returns ``None`` so
    the caller falls back to the declared model (never crash a compile)."""

    def reject(why: str) -> None:
        obs_warn(
            f"calibration profile {path}: {why}; using the declared "
            f"(uncalibrated) hardware model",
            CalibrationProfileWarning,
            stacklevel=3,
            logger="calibrate",
        )
        return None

    try:
        raw = json.loads(Path(path).expanduser().read_text())
    except OSError as e:
        return reject(f"unreadable ({e})")
    except ValueError as e:
        return reject(f"corrupt JSON ({e})")
    try:
        return CalibrationProfile.from_dict(raw)
    except (ValueError, TypeError, KeyError, AttributeError) as e:
        return reject(str(e))


def coerce_profile(profile) -> CalibrationProfile | None:
    """Accept a profile object, a path, or a raw dict; warn-and-None on
    anything that cannot be read as a profile."""
    if profile is None or isinstance(profile, CalibrationProfile):
        return profile
    if isinstance(profile, (str, os.PathLike)):
        return load_profile(profile)
    if isinstance(profile, Mapping):
        try:
            return CalibrationProfile.from_dict(profile)
        except (ValueError, TypeError, KeyError) as e:
            obs_warn(
                f"calibration profile mapping rejected: {e}; using the "
                f"declared hardware model",
                CalibrationProfileWarning,
                stacklevel=2,
                logger="calibrate",
            )
            return None
    obs_warn(
        f"cannot interpret {type(profile).__name__} as a calibration profile",
        CalibrationProfileWarning,
        stacklevel=2,
        logger="calibrate",
    )
    return None


def profile_matches_target(profile: CalibrationProfile, target_name: str) -> bool:
    """True when ``profile`` was fitted for ``target_name`` — including
    the bracketed derived instances ``MatchTarget.restricted`` /
    ``scaled_l1`` produce (``"gap9[cluster]"``, ``"gap9[L1=32kB]"``), so
    a profile fitted on the full SoC drives its Table IV ablations too.
    An empty profile target matches anything (hand-written universal
    overrides)."""
    return (
        not profile.target
        or profile.target == target_name
        or target_name.startswith(profile.target + "[")
    )


def apply_profile(
    target: MatchTarget, profile: CalibrationProfile | None
) -> MatchTarget:
    """Overlay ``profile`` on ``target`` via the core override hooks.

    Module names in the profile that the target does not declare warn and
    are skipped (a profile fitted on ``gap9`` applies cleanly to
    ``gap9.restricted([...])`` ablations).  The returned target keeps its
    name; profile provenance lands in ``attrs["calibration"]`` and every
    overridden module is tagged so schedule caches key on the profile.
    """
    if profile is None:
        return target
    known = {m.name for m in target.all_modules()}
    overrides = {k: v for k, v in profile.modules.items() if k in known}
    unknown = sorted(set(profile.modules) - known)
    # a derived instance (restricted ablation / scaled L1, named
    # "base[...]") drops modules *on purpose* — only warn when the
    # profile names modules its own base target never declared
    if unknown and target.name == profile.target:
        obs_warn(
            f"calibration profile for {profile.target!r} names modules "
            f"{unknown} that target {target.name!r} does not declare; "
            f"skipping those entries",
            CalibrationProfileWarning,
            stacklevel=2,
            logger="calibrate",
        )
    new = target.recalibrated(overrides, tag=profile.tag())
    new.attrs["calibration"] = {
        "target": profile.target,
        "version": profile.version,
        "fingerprint": profile.fingerprint(),
        "modules": sorted(overrides),
    }
    return new

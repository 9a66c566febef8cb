"""repro_torch.calibrate — calibration profiles for the hardware models.

* :mod:`.profile` — a copy of the reference's versioned JSON
  :class:`CalibrationProfile` (pure Python), which
  ``repro_torch.targets.registry.get_target(name, profile=...)``,
  ``repro_torch.core.dispatch(..., profile=...)`` and the
  ``MATCH_CALIBRATION_PROFILE`` env var overlay on a declared target.
  A profile the reference package saved loads here as it is.

The reference's microbench sweep and least-squares fitter are not ported
yet.
"""

from .profile import (
    PROFILE_ENV,
    PROFILE_VERSION,
    CalibrationProfile,
    CalibrationProfileWarning,
    ModuleCalibration,
    apply_profile,
    coerce_profile,
    load_profile,
)

__all__ = [
    "PROFILE_ENV",
    "PROFILE_VERSION",
    "CalibrationProfile",
    "CalibrationProfileWarning",
    "ModuleCalibration",
    "apply_profile",
    "coerce_profile",
    "load_profile",
]

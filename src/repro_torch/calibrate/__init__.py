"""repro_torch.calibrate — profiling-guided cost-model calibration.

The port of ``repro.calibrate``.  Closes the measure -> fit -> re-rank
loop the paper's "model-aware" claim rests on (Sec. V: a retargetable
mapper *with good cost models* competes with custom toolchains):

1. :mod:`.microbench` sweeps generated workloads per (target, execution
   module) through ``dispatch -> lower -> run(timed=True)`` on the card
   (CUDA events around each segment; ``device="cpu"`` for the host
   clock) and collects measured segment timings next to the
   uncalibrated model features;
2. :mod:`.fit` (a copy of the reference's) solves the abstract-model
   parameters — effective macs/cycle, per-level bandwidths, fixed
   setup/handoff cycles — by least squares over those samples;
3. :mod:`.profile` (a copy) persists the result as a versioned JSON
   :class:`CalibrationProfile` that
   ``repro_torch.targets.registry.get_target(name, profile=...)`` (or the
   ``MATCH_CALIBRATION_PROFILE`` env var) overlays on the declared
   target — no hardware file is ever edited, and every schedule-cache
   key carries the profile fingerprint.

Samples and profiles are the reference's JSON formats: a file either
package writes loads in the other.

CLI: ``python -m repro_torch.calibrate sweep|fit|show`` (see ``--help``).
"""

from .fit import fit_module, fit_profile, profile_errors
from .microbench import (
    MicrobenchSample,
    collect_samples,
    default_sweep,
    dense_block_graph,
    graph_io,
    load_samples,
    run_microbench,
    save_samples,
    unsampled_modules,
)
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
    "MicrobenchSample",
    "collect_samples",
    "default_sweep",
    "dense_block_graph",
    "graph_io",
    "load_samples",
    "run_microbench",
    "save_samples",
    "unsampled_modules",
    "fit_module",
    "fit_profile",
    "profile_errors",
    "PROFILE_ENV",
    "PROFILE_VERSION",
    "CalibrationProfile",
    "CalibrationProfileWarning",
    "ModuleCalibration",
    "apply_profile",
    "coerce_profile",
    "load_profile",
]

"""repro_torch.targets — declarative hardware models (paper Sec. V).

Copies of the reference's targets (``repro.targets``): DIANA, GAP9, the
TPU v5e and the NE16-Octa porting proof, registered in this package's
own registry at import, exactly as the reference registers them, so
``list_targets()`` equals the reference's.  The card the port runs on has
its own file, :mod:`repro_torch.targets.h100`, registered only by an
explicit :func:`register_h100_target` call.
"""

from .diana import make_diana_target
from .gap9 import make_gap9_target
from .h100 import H100Spec, make_h100_target, register_h100_target
from .ne16_octa import make_ne16_octa_target
from .registry import (
    TargetRegistryError,
    get_target,
    list_targets,
    load_plugins,
    register_target,
    resolve_target,
    target_info,
    unregister_target,
)
from .tpu_v5e import TPUv5eSpec, make_tpu_v5e_target

# Builtin targets, registered declaratively: factory + one-line card.
register_target(
    "diana",
    make_diana_target,
    description="DIANA: RISC-V host + 16x16 digital SIMD array, blocking DMA",
)
register_target(
    "gap9",
    make_gap9_target,
    description="GAP9: RISC-V host + 8-core PULP-NN cluster + NE16, shared 128 kB L1",
)
register_target(
    "tpu_v5e",
    make_tpu_v5e_target,
    aliases=("v5e",),
    description="TPU v5e chip: MXU + VPU over HBM->VMEM (Pallas BlockSpec level)",
)
register_target(
    "ne16_octa",
    make_ne16_octa_target,
    description="NE16-Octa: hypothetical 16-core cluster + widened NE16 (porting proof)",
)

__all__ = [
    "make_diana_target",
    "make_gap9_target",
    "make_ne16_octa_target",
    "make_tpu_v5e_target",
    "make_h100_target",
    "register_h100_target",
    "H100Spec",
    "TPUv5eSpec",
    "TargetRegistryError",
    "register_target",
    "unregister_target",
    "get_target",
    "resolve_target",
    "list_targets",
    "target_info",
    "load_plugins",
]

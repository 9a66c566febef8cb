"""repro_torch.targets — declarative hardware models (paper Sec. V).

Copies of the reference's MCU targets (``repro.targets``): DIANA, GAP9
and the NE16-Octa porting proof, registered in this package's own
registry.  The main path dispatches onto them; the TPU v5e model is not
carried over.
"""

from .diana import make_diana_target
from .gap9 import make_gap9_target
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
    "ne16_octa",
    make_ne16_octa_target,
    description="NE16-Octa: hypothetical 16-core cluster + widened NE16 (porting proof)",
)

__all__ = [
    "make_diana_target",
    "make_gap9_target",
    "make_ne16_octa_target",
    "TargetRegistryError",
    "register_target",
    "unregister_target",
    "get_target",
    "resolve_target",
    "list_targets",
    "target_info",
    "load_plugins",
]

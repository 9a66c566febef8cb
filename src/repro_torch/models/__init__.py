"""repro_torch.models — the LM stack, for the dense ``attn`` architectures.

* :class:`ModelConfig` — a copy of the reference's config dataclass;
* :class:`LM` — the reference ``LM`` as an ``nn.Module`` (prefill
  attention through the flash kernel);
* :func:`params_from_jax` — loads a reference ``LM.init`` tree (numpy
  leaves) into an :class:`LM`.
"""

from .config import ModelConfig
from .transformer import LM, StackSpec, params_from_jax

__all__ = ["ModelConfig", "LM", "StackSpec", "params_from_jax"]

"""repro_torch.models — the LM stack, for the ``attn`` (dense or MoE), ``ssd`` and recurrentgemma architectures.

* :class:`ModelConfig` — a copy of the reference's config dataclass;
* :class:`LM` — the reference ``LM`` as an ``nn.Module`` (prefill
  attention through the flash kernel, MoE expert GEMMs through
  ``moe_gmm``, the SSD core of prefill through ``ssd_scan``, the RG-LRU
  recurrence through ``rglru_scan``);
* :mod:`.moe`, :mod:`.ssd`, :mod:`.rglru` — the MoE FFN, the mamba2 block
  and the Griffin recurrent block;
* :func:`params_from_jax` — loads a reference ``LM.init`` tree (numpy
  leaves) into an :class:`LM`.
"""

from .config import ModelConfig
from .transformer import LM, StackSpec, params_from_jax

__all__ = ["ModelConfig", "LM", "StackSpec", "params_from_jax"]

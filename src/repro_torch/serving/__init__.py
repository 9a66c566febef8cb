"""repro_torch.serving — batched LM inference engine (prefill + decode slots)."""

from .engine import Request, ServeEngine, TruncationWarning

__all__ = ["Request", "ServeEngine", "TruncationWarning"]

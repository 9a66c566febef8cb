"""repro_torch.distributed — the port of ``repro.distributed``, so far its
gradient compression (:mod:`.compression`); sharding and autoshard are
still to be ported (ROADMAP A13)."""

from .compression import dequantize, dequantize_tree, error_feedback_update, quantize, quantize_tree

__all__ = ["quantize", "dequantize", "quantize_tree", "dequantize_tree", "error_feedback_update"]

"""Launch-time layout properties of the tensors a kernel wrapper passes on."""

from __future__ import annotations

__all__ = ["rows_16b_aligned"]


def rows_16b_aligned(*tensors) -> bool:
    """Whether 16-byte copies (``cp.async``) may stage every row of each
    tensor: unit stride along the last dim, rows a multiple of 16 bytes
    long, and a base pointer and leading strides (of dims longer than 1)
    that are multiples of 16 bytes.  Otherwise a kernel stages them by
    element loads."""
    for t in tensors:
        es = t.element_size()
        if t.stride(-1) != 1 or (t.shape[-1] * es) % 16 or t.data_ptr() % 16:
            return False
        if any(n > 1 and (s * es) % 16 for n, s in zip(t.shape[:-1], t.stride()[:-1])):
            return False
    return True

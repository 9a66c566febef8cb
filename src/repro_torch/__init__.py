"""repro_torch — the MATCH compile stack in PyTorch, for an NVIDIA H100.

The JAX package ``repro`` stays the reference; this package is its port
and mirrors its subpackage and module names, so each counterpart is found
by name:

* ``repro_torch.core``, ``repro_torch.targets``, ``repro_torch.obs``,
  ``repro_torch.cnn.nets``, ``repro_torch.cnn.analysis`` and
  ``repro_torch.backend.memory`` are copies of the pure-Python reference
  modules (graph IR, LOMA DSE, dispatcher, hardware models, tracing,
  memory planner) with their imports pointed at this package;
* ``repro_torch.cnn.execute``, ``repro_torch.kernels`` and
  ``repro_torch.backend.lower`` / ``runtime`` are ported array code: the
  integer-simulating interpreter, the banded conv, and the int8
  GEMM + requant epilogue as a hand-written CUDA kernel for ``sm_90a``.

The main path is the paper's flow: ``core.dispatch`` →
``backend.lower`` → ``CompiledModel.run``, bit-exact with
``cnn.execute_graph``.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"``; nothing falls back to the CPU silently.

Importing this package never imports ``jax`` or ``repro``.
"""

__all__ = ["backend", "cnn", "core", "kernels", "obs", "targets"]

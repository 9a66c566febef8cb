"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each kernel is one ``csrc/<name>.cu`` with a plain ``extern "C"``
launcher.  At first use it is compiled for Hopper (``sm_90a``) into a
shared library under the build directory — ``build/repro_torch/`` at the
root of the checkout, or ``$REPRO_TORCH_BUILD_DIR`` — keyed by a hash of
the source and the compiler flags, so an edited source rebuilds and an
unchanged one is loaded as built.  Two processes building at once each
compile to a private temporary name and ``os.replace`` it into place.

Nothing is compiled when a module is imported: the CPU test suite imports
every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
import uuid
from dataclasses import dataclass
from pathlib import Path

__all__ = ["BuildInfo", "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclass(frozen=True)
class BuildInfo:
    """One kernel library: where it is, and what building it took."""

    name: str
    path: Path
    seconds: float  # 0.0 when an earlier build was reused
    ptxas: str  # the compiler's -Xptxas -v report (registers, smem, spills)


def _build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> <checkout>/build/repro_torch
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


@functools.lru_cache(maxsize=None)
def build(name: str) -> BuildInfo:
    """Compile ``csrc/<name>.cu`` (once per source hash) and return it."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = _build_dir()
    lib = out_dir / f"{name}-{digest}.so"
    log = out_dir / f"{name}-{digest}.ptxas.txt"
    if lib.exists():
        return BuildInfo(name, lib, 0.0, log.read_text() if log.exists() else "")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{name}-{digest}.{os.getpid()}.{uuid.uuid4().hex}.so"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    report = proc.stdout + proc.stderr
    tmp_log = tmp.with_suffix(".txt")
    tmp_log.write_text(report)
    os.replace(tmp_log, log)
    os.replace(tmp, lib)
    return BuildInfo(name, lib, seconds, report)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, loaded into this process."""
    return ctypes.CDLL(str(build(name).path))

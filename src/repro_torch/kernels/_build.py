"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each kernel is one ``csrc/<name>.cu`` with a plain ``extern "C"``
launcher; it may include local headers (``#include "mma_sm90.cuh"``, next
to it in ``csrc/``).  At first use it is compiled for Hopper (``sm_90a``)
into a shared library under the build directory — ``build/repro_torch/``
at the root of the checkout, or ``$REPRO_TORCH_BUILD_DIR`` — keyed by a
hash of the source, every local header it includes and the compiler
flags (:func:`digest`), so an edited source or header rebuilds and an
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
import re
import shutil
import subprocess
import time
import uuid
from dataclasses import dataclass
from pathlib import Path

__all__ = ["BuildInfo", "build", "digest", "load", "local_includes"]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


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


def local_includes(src: Path) -> list[Path]:
    """The files ``src`` includes with ``#include "..."``, resolved next to
    the file that includes them, transitively, each once, in first-seen
    order (system headers in ``<...>`` are not followed)."""
    seen: list[Path] = []
    todo = [src]
    while todo:
        cur = todo.pop(0)
        for rel in _INCLUDE.findall(cur.read_text()):
            dep = (cur.parent / rel).resolve()
            if dep not in seen:
                seen.append(dep)
                todo.append(dep)
    return seen


def digest(name: str, csrc: Path = CSRC) -> str:
    """The build key of ``<csrc>/<name>.cu``: a hash of its bytes, of every
    local header it includes, and of the compiler flags."""
    src = csrc / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for dep in local_includes(src):
        h.update(dep.name.encode() + b"\0" + dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build(name: str) -> BuildInfo:
    """Compile ``csrc/<name>.cu`` (once per :func:`digest`) and return it."""
    src = CSRC / f"{name}.cu"
    key = digest(name)
    out_dir = _build_dir()
    lib = out_dir / f"{name}-{key}.so"
    log = out_dir / f"{name}-{key}.ptxas.txt"
    if lib.exists():
        return BuildInfo(name, lib, 0.0, log.read_text() if log.exists() else "")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{name}-{key}.{os.getpid()}.{uuid.uuid4().hex}.so"
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

"""Build the PyTorch port's kernels on one CUDA card, time them, and run the
full-width phases that are too large for a unit test.

    python3 chip_smoke.py                       # every phase, as below
    python3 chip_smoke.py --only gemm,kernels [--src DIR]

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
``nvcc``; run from the root of a checkout.  Kernel- and path-level
correctness on the card is ``pytest -m cuda tests/test_torch_*.py``, on
its test grids; here each timed call is held only at the shapes it is
timed at.  Phases, each raising on failure:

1. the card's name, power limit and largest SM clock (``nvidia-smi``);
2. build: every kernel's ``nvcc`` (``src/repro_torch/kernels/csrc``) and an
   empty kernel's, the launch floor, all started together; ``-Xptxas -v``
   printed, and no spill store allowed in a tensor-core instantiation (bf16
   flash and ``moe_gmm``, the int8 GEMM's four) or a scan kernel;
3. the kernel table (``PERF.md`` §6): each row's call first held against its
   plain version (bit-exact for the int8 kernels, within the kernel test's
   tolerance for the others), then its device ms per call in a CUDA graph
   at its path's shapes, beside an empty kernel at its launch
   shape (the floor), its plain version, PyTorch's own calls for the same
   function (timed only) and the bound max(bytes / 3.35 TB/s, operations /
   peak).  ``gemm``: the segment entry at the CNN path's M = 1 and DAE's
   served M = 16, then the sweep behind the GEMM's rule (both branches of
   both entries, each forced, across the knee: the GEMV up to 512 blocks,
   the tensor cores beyond); ``kernels``: flash at qwen2.5-3b's prefills and
   recurrentgemma-2b's local attention, ``moe_gmm`` at granite-moe-3b-a800m's
   serving shapes and at granite-4.0-h-small's with the routed rows and with
   every row, the scans at mamba2-1.3b's and recurrentgemma-2b's prefills,
   then ``ssd_scan`` by heads per output block (the data behind
   ``heads_per_block``); ``conv``: the fused conv at every conv layer of
   MobileNetV1-0.25 and DS-CNN's first, batch 1 and 16, and MobileNet's 27
   layers summed;
4. ``[cnn]``: the CNN cells' path, the four nets lowered for h100: 32
   requests by ``compile_aot`` at its defaults, in arena memory, and (DAE,
   DS-CNN) through a 16-slot ``ModelServer``, bit-exact with the CPU
   interpreter, launches exactly one per GEMM and fused conv segment a
   request (a batch, served);
5. ``[pipeline]``: 4 nets x {gap9, diana, ne16_octa}, 12 inputs through
   ``PipelinedModel.run_stream`` per segment and by captured lane chains, 5
   streamed runs each, bit-exact with ``CompiledModel.run`` (the first input
   also with the CPU interpreter), launches exact;
6. ``[calibrate]``: ``run_microbench("h100", repeats=3)``, a fit per module
   that must lower its MAE, the profile saved under ``build/calibration/``
   and loaded back; the four nets under the declared and the fitted model,
   bit-exact eagerly and by AOT replay;
7. ``[fuzz]``: seeds 0-23 x {h100, gap9} and the corpus cases with the full
   battery: every compiled path bit-exact with the CPU interpreter;
8. ``[lm]``: qwen2.5-3b, granite-moe-3b-a800m and mamba2-1.3b at full width,
   2 layers, fp32, and recurrentgemma-2b, 3 layers, over a prompt that fills
   its 2048-slot ring: prefill and 4 greedy steps decoded by the engine's
   graph, against the CPU within 1e-3, tokens identical, launches exact;
9. ``[lm-bf16]``: the same four at full width, bf16, prefills of 512 and
   4096 tokens: every kernel call and every attention and MoE layer on the
   model's own activations against the plain versions, and the logits
   within 3e-2 (or the model's floor) with the MoE routing replayed;
10. ``[prefill-long]``: a 4096-token full-depth bf16 prefill of qwen2.5-3b,
   mamba2-1.3b and recurrentgemma-2b: host ms, exact launches, each
   kernel's device ms per call (profiler);
11. ``[serve]``: ``launch.serve``'s engine on the four LMs at full width and
   depth, 4 runs decoding by graph replay and 4 eagerly: identical tokens,
   steps, refills and launches, each run's launches exact; capture ms;
12. ``[train]``: each kernel's backward against autograd of its plain
   version and its times; six families' gradients, card against CPU
   against float64; qwen2.5-3b and mamba2-1.3b trained at full width through
   ``launch.train`` (ms per step, MFU, peak memory, exact launches); the
   loss falling on a fixed batch; a stopped run resumed from its checkpoint;
13. ``[ops]``: the h100 schedule table; each ``scheduled_*`` wrapper once at
   full shapes (one counted launch, within its plain version's tolerance)
   with its host ms cold and cached; the DSE's ``ssd_scan`` heads against
   the kernel's rule;
14. ``[shard]``: qwen2.5-3b placed on a 1 x 1 ``DeviceMesh`` (NCCL) bitwise,
   ``constrain`` an identity, ``best_rules``' strategy per cell;
15. ``[dryrun]``: ``launch.roofline`` on qwen2.5-3b's and mamba2-1.3b's
   ``train_4k`` in subprocesses, counted flops within ``FLOPS_RATIO`` of the
   need;
16. one JSON line of each kernel's table rows and launches by phase (the CNN
   kernels' exact ones under ``cnn`` and ``pipeline``), the card line, and
   last the ``{"ok": true, "device": ...}`` line.

``--only`` runs the named phases after the card line and the build, and
prints neither the JSON line nor the ``ok`` line.  ``--src DIR`` drives the
``repro_torch`` package under DIR instead of this checkout's ``src``
(``--only gemm,kernels --src <parent>/src`` times another commit's kernels,
unpacked under DIR, in the same call).

Exits non-zero, printing no result, without a CUDA card or outside a
checkout.  Imports nothing of JAX or of the reference package ``repro``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import gc
import importlib
import itertools
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Callable, NamedTuple

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

PHASES = ("gemm", "kernels", "conv", "cnn", "pipeline", "calibrate", "fuzz", "lm", "lm-bf16", "prefill-long", "serve",
          "train", "ops", "shard", "dryrun")
CHECKOUT_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")


def parse_args() -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help=f"comma-separated phases among {', '.join(PHASES)} (default: all, and the JSON lines)")
    ap.add_argument("--src", default=CHECKOUT_SRC,
                    help="directory holding the repro_torch package to drive (default: this checkout's src)")
    args = ap.parse_args()
    args.only = [p for p in args.only.split(",") if p]
    unknown = sorted(set(args.only) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}; choose among {PHASES}")
    return args


ARGS = parse_args()
sys.path.insert(0, os.path.abspath(ARGS.src))

import numpy as np  # noqa: E402

import torch.nn.functional as F  # noqa: E402

from repro_torch import _graphs  # noqa: E402
from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.backend import compile_aot, lower  # noqa: E402
from repro_torch.cnn import (  # noqa: E402
    execute_graph,
    init_graph_params,
    mlperf_tiny_networks,
    params_to_torch,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_backward,
    flash_attention_plain,
)
from repro_torch.kernels.matmul_requant import matmul_requant, matmul_requant_plain  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_backward, moe_gmm_plain  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_backward, rglru_scan_plain  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_backward, ssd_scan_plain  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import attention as attention_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import rglru as rglru_mod  # noqa: E402
from repro_torch.models import ssd as ssd_mod  # noqa: E402
from repro_torch.models import transformer as transformer_mod  # noqa: E402
from repro_torch.models.layers import rmsnorm  # noqa: E402
from repro_torch.pipeline import PipelinedModel  # noqa: E402
from repro_torch.serve import ModelServer  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.targets import get_target, register_h100_target  # noqa: E402

DEV = torch.device("cuda")
# the GEMM's and the fused conv's modules (the package attributes of the same
# names are the functions)
MR = importlib.import_module("repro_torch.kernels.matmul_requant")
CR = importlib.import_module("repro_torch.kernels.conv_requant")
# [conv]: every distinct conv layer of MobileNetV1-0.25 (IY, IX, C, K, FY, FX,
# stride, depthwise) and DS-CNN's 10x4 stride-2 first layer, at batch 1 and
# at a served batch of 16
CONV_SHAPES = [(96, 96, 3, 8, 3, 3, 2, False)] + [
    shape
    for c, k, hw, st in ((8, 16, 48, 1), (16, 32, 48, 2), (32, 32, 24, 1), (32, 64, 24, 2), (64, 64, 12, 1),
                         (64, 128, 12, 2), (128, 128, 6, 1), (128, 256, 6, 2), (256, 256, 3, 1))
    for shape in ((hw, hw, c, c, 3, 3, st, True), (hw // st, hw // st, c, k, 1, 1, 1, False))
] + [(49, 10, 1, 64, 10, 4, 2, False)]
CONV_BATCHES = (1, 16)
NETS = ("MobileNet", "ResNet", "DSCNN", "DAE")
# [cnn]: requests through each of the CNN path's ways on h100, and the
# request server's slots (DAE's rows are the GEMM's M) and the nets it serves
CNN_REQUESTS, CNN_SLOTS, CNN_SERVED = 32, 16, ("DAE", "DSCNN")
# [pipeline]: benchmarks/pipeline_throughput.py's sweep on the card
PIPE_TARGETS = ("gap9", "diana", "ne16_octa")
PIPE_INPUTS, PIPE_DEPTH, PIPE_REPEATS = 12, 3, 5
# [fuzz]: generated graphs, full battery on every seed, on these targets
FUZZ_SEEDS = 24
FUZZ_TARGETS = ("h100", "gap9")
KERNELS = ("matmul_requant", "flash_attention", "moe_gmm", "ssd_scan", "rglru_scan")
# every source built: the five kernels, the fused conv of the CNN path and an
# empty kernel, the card's launch floor
SOURCES = KERNELS + ("conv_requant", "launch_floor")
# H100 SXM data sheet: HBM3 bytes/s, dense int8 and bf16 tensor-core ops/s,
# fp32 ops/s outside the tensor cores
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
BF16_FLOPS_S = 989e12
FP32_FLOPS_S = 67e12
# (K, N) of every dense on the main path; all run at M = 1 there, and DAE's
# five at M = batch rows when requests are served in batches
MAIN_KN = ((640, 128), (128, 128), (128, 8), (8, 128), (128, 640), (64, 10), (256, 2), (64, 12))
DAE_KN = MAIN_KN[:5]
# (M, K, N) on both sides of the GEMM rule's knee (the GEMV's blocks against
# those the card holds at once): only the branch sweep times them
BRANCH_KNEE = ((16, 128, 256), (16, 128, 384), (16, 128, 512), (32, 128, 128), (64, 128, 128), (1, 128, 4096),
               (1, 128, 8192))
# the kernels' tolerances on their test grids (tests/test_kernels.py), by dtype
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SSD_TOL = 2e-4
RGLRU_TOL = 1e-4
# each kernel table row's call against its plain version before it is timed:
# atol = rtol by kernel (every timed row is bf16 but the scans' f32 state);
# a kernel not named here is int8-valued and held bit-exact
ROW_TOL = {"flash_attention": FLASH_TOL[torch.bfloat16], "moe_gmm": GMM_TOL[torch.bfloat16], "ssd_scan": SSD_TOL,
           "rglru_scan": RGLRU_TOL}
LM_ARCH, MOE_ARCH, SSD_ARCH, RG_ARCH = "qwen2_5_3b", "granite_moe_3b_a800m", "mamba2_1_3b", "recurrentgemma_2b"
GRANITE_ARCH = "granite_4_0_h_small"
SERVE_REQUESTS, SERVE_NEW, SERVE_SLOTS = 6, 12, 4
# the kernel table's shapes: (B, S) of flash at qwen2.5-3b (bf16, causal) and
# at recurrentgemma-2b's local attention, (B, T) of the scans
FLASH_TIMED = ((4, 24), (4, 512), (1, 4096))
RG_FLASH_TIMED = ((4, 24), (1, 4096))
SSD_TIMED = RGLRU_TIMED = ((4, 24), (4, 512), (1, 4096))
# heads per output block timed at each of SSD_TIMED and (1, 512): the data
# behind the wrapper's heads_per_block
SSD_HEADS = (1, 2, 4, 8, 16, 32, 64)
# [prefill-long]: one prompt of this many tokens through full-depth bf16 prefill
LONG_PROMPT = 4096


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_sm_clock() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, flops_s: float) -> tuple[float, str]:
    """max(bytes / HBM rate, flops / peak rate) in ms, and which bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / flops_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def graph_ms(fn, iters: int | None = None) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed between CUDA events (host launch cost excluded).  By
    default as many calls as fill about 10 ms, from 2 to 200, by one call
    timed after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if iters is None:
        start.record()
        fn()
        end.record()
        end.synchronize()
        iters = int(min(200, max(2, 10.0 / max(start.elapsed_time(end), 1e-3))))
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start.record()
    g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_label(name: str) -> str:
    """A device kernel's short name: its ``..._kernel`` word, and for
    PyTorch's elementwise kernels the functor or copy routine inside
    (``vectorized_elementwise_kernel[FillFunctor]``); a copy event's own
    name otherwise."""
    m = re.search(r"(\w+_kernel)", name)
    if not m:
        return name[:40]
    what = re.search(r"::(\w*(?:Functor|_cuda|copy\w*))\b", name)
    return f"{m.group(1)}[{what.group(1)}]" if what and what.group(1) != m.group(1) else m.group(1)


def eager_ms(fn, iters: int = 200) -> float:
    """Time per call of ``fn`` launched from Python, host cost included:
    CUDA events around ``iters`` back-to-back calls after a warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def launch_floor(blocks: int, threads: int):
    """A call that launches ``csrc/launch_floor.cu``'s empty kernel at one
    launch shape on the current stream: timed in a CUDA graph, the least
    time any kernel of that shape takes on this card."""
    fn = _build.load("launch_floor").launch_floor_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        err = fn(blocks, threads, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch_floor kernel launch failed: CUDA error {err}")
    return launch


def ptxas_functions(report: str) -> dict[str, dict]:
    """Registers and spill bytes of each entry function in an ``nvcc
    -Xptxas -v`` report, by mangled name."""
    funcs: dict[str, dict] = {}
    cur = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return funcs


SCAN_TYPES = {"f": "float", "13__nv_bfloat16": "bf16", "6float4": "float4"}
GEMM_TYPES = {"a": "int8", "f": "float"}
# the GEMM kernel's instantiations, the operands' type of each branch (tensor
# cores and the GEMV): int8 for the int8 entry, float for the segment entry
GEMM_KERNELS = 4


def short_kernel_name(mangled: str) -> str | None:
    """``..._flash_attention_bf16_kernelILi128ELi64ELb1EE...`` ->
    ``flash_attention_bf16_kernel<128, 64, 1>``, ``...22ssd_scan_output_kernelIfEE...``
    -> ``ssd_scan_output_kernel<float>``, ``...matmul_requant_mma_kernelIaE...`` ->
    ``matmul_requant_mma_kernel<int8>``; None for another kernel."""
    m = re.search(r"((?:flash_attention|moe_gmm)_bf16_kernel)I(.*?)EE", mangled)
    if m:
        return f"{m.group(1)}<{', '.join(re.findall(r'L[ib](\d+)E', m.group(2) + 'E'))}>"
    m = re.search(r"\d+((?:ssd|rglru)_scan\w*?_kernel)I(f|13__nv_bfloat16|6float4)E", mangled)
    if m:
        return f"{m.group(1)}<{SCAN_TYPES[m.group(2)]}>"
    m = re.search(r"\d+(matmul_requant_(?:mma|gemv)_kernel)I([af])E", mangled)
    if m:
        return f"{m.group(1)}<{GEMM_TYPES[m.group(2)]}>"
    m = re.search(r"\d+(conv_requant_kernel)ILb([01])E", mangled)
    if m:
        return f"{m.group(1)}<{'depthwise' if m.group(2) == '1' else 'dense'}>"
    return None


def phase_build(check_spills: bool = True) -> list[dict]:
    """Every kernel's nvcc started at once, one thread each; then the
    registers and spills of the tensor-core instantiations (bf16 flash and
    moe_gmm, the int8 GEMM's four) and of the scan kernels, which must
    spill nothing (``check_spills``: and must exist)."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        infos = list(pool.map(_build.build, SOURCES))
    tc = []
    for info in infos:
        how = f"built in {info.seconds:.2f} s" if info.seconds else "reused an earlier build"
        print(f"[build] {info.name}: {how} -> {info.path}")
        print("[build] nvcc -Xptxas -v:")
        for line in info.ptxas.strip().splitlines():
            print(f"    {line}")
        for mangled, props in ptxas_functions(info.ptxas).items():
            name = short_kernel_name(mangled)
            if name is not None:
                tc.append({"kernel": name, **props})
    print(f"[build] tensor-core instantiations (template: DP, BC, ALIGNED for flash; MT, ALIGNED for "
          f"moe_gmm; the operands' type for the int8 GEMM's two branches) and scan kernels (template: the type of B/C, a/b or the carried "
          f"vector): {len(tc)}")
    for row in tc:
        print(f"    {row['kernel']:44s} registers {row.get('registers', '?'):>3}, spill stores "
              f"{row.get('spill_stores', '?')} B, spill loads {row.get('spill_loads', '?')} B")
    spilled = [r["kernel"] for r in tc if r.get("spill_stores", 1) != 0]
    gemms = sum(r["kernel"].startswith("matmul_requant") for r in tc)
    if check_spills and (not tc or spilled or gemms != GEMM_KERNELS):
        raise AssertionError(f"tensor-core or scan kernels that spill (or no report, or {gemms} GEMM "
                             f"instantiations for {GEMM_KERNELS}): {spilled or 'none found'}")
    return tc


# ---------------------------------------------------------------------------
# the kernel table: one row builder and one printer for every kernel
# ---------------------------------------------------------------------------


class Timed(NamedTuple):
    """One row of the kernel table: ``call`` at ``shape``, the same function
    by its plain version and by PyTorch's own calls (None: none computes
    it), the bytes and operations it needs, the peak rate of the unit its
    operations run on, and the (blocks, threads) it launches (None: no
    floor timed)."""
    kernel: str
    shape: str
    call: Callable
    plain: Callable
    library: Callable | None
    nbytes: float
    flops: float
    peak: float
    launch: tuple[int, int] | None = None


def check_row(t: Timed) -> None:
    """The row's call against its plain version, once each on the row's
    operands: bit-exact, or within :data:`ROW_TOL`."""
    tol, where = ROW_TOL.get(t.kernel), f"[{t.kernel}] {t.shape}"
    got, want = t.call(), t.plain()
    for g, w in zip(*(o if isinstance(o, tuple) else (o,) for o in (got, want))):
        if tol is not None:
            torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol, msg=lambda m: f"{where}: {m}")
        elif not torch.equal(g, w):
            raise AssertionError(f"{where}: differs from its plain version")


def time_row(t: Timed) -> dict:
    """The kernel held against its plain version (:func:`check_row`), then
    device ms per call in a CUDA graph of the kernel, of an empty kernel at
    its launch shape, of its plain version and of the library calls; and the
    bound and what bounds it."""
    check_row(t)
    ms = lambda fn: None if fn is None else graph_ms(fn)  # noqa: E731
    row = {"kernel": t.kernel, "shape": t.shape, "ms": ms(t.call),
           "launch_floor_ms": ms(t.launch and launch_floor(*t.launch)), "plain_ms": ms(t.plain),
           "library_ms": ms(t.library)}
    row["bound_ms"], row["bound_by"] = bound(t.nbytes, t.flops, t.peak)
    return row


def print_rows(title: str, rows: list[dict]) -> None:
    cell = lambda v: f"{v:>10.5f}" if v is not None else f"{'-':>10s}"  # noqa: E731
    print(f"[{title}] device ms per call in a CUDA graph: the kernel; floor = an empty kernel at its launch shape; "
          "plain = its plain version; library = PyTorch's own calls for the same function, timed only; bound = "
          "max(bytes / 3.35 TB/s, operations / peak: int8 1979 TOP/s, bf16 989 TFLOP/s, fp32 67 TFLOP/s)")
    print(f"    {'kernel':15s} {'shape':46s} {'card':>10s} {'floor':>10s} {'plain':>10s} {'library':>10s} "
          f"{'bound':>10s}")
    for r in rows:
        print(f"    {r['kernel']:15s} {r['shape']:46s} {cell(r['ms'])} {cell(r['launch_floor_ms'])} "
              f"{cell(r['plain_ms'])} {cell(r['library_ms'])} {r['bound_ms']:>10.6f} ({r['bound_by']})")


def table(title: str, specs) -> list[dict]:
    """Each of ``specs`` timed as it comes (its operands freed before the
    next is drawn), then printed."""
    rows = [time_row(t) for t in specs]
    print_rows(title, rows)
    return rows


def segment_operands(m: int, k: int, n: int, seed: int):
    """The segment entry's operands on the card as the lowering holds them:
    integer-valued float32 activations (M, K), the dense weight (N, K) and
    bias (N,)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (m, k)).astype(np.float32)
    w = rng.integers(-128, 128, (n, k)).astype(np.float32)
    b = rng.integers(-1000, 1000, (n,)).astype(np.float32)
    return [torch.from_numpy(v).to(DEV) for v in (x, w, b)]


def library_segment(x, w, bias, shift):
    """PyTorch's own calls for the segment's function (fp32 addmm on the
    integer-valued operands, then the epilogue): the yardstick only."""
    y = torch.addmm(bias, x, w.T)
    return torch.clamp(torch.round(y / float(1 << shift)), 0, 127)


def gemm_timed():
    """The segment entry as the lowering calls it (float32 operands, bias,
    round-half-even, ReLU) at the main path's M = 1 and DAE's served M = 16,
    bound by its float32 bytes."""
    kw = dict(shift=5, relu=True, rounding="even")
    for m, k, n in [(1, k, n) for k, n in MAIN_KN] + [(16, k, n) for k, n in DAE_KN]:
        x, w, b = segment_operands(m, k, n, seed=7)
        branch = "tensor cores" if MR.launch_shape(m, n, k)[2] == MR.TENSOR_CORES else "GEMV"
        yield Timed("matmul_requant", f"segment {m},{k},{n} ({branch})", partial(MR.matmul_requant_f32, x, w, b, **kw),
                    partial(MR.matmul_requant_f32_plain, x, w, b, **kw), partial(library_segment, x, w, b, 5),
                    4 * (m * k + n * k + n + m * n), 2 * m * n * k, INT8_OPS_S, MR.launch_shape(m, n, k)[:2])


def conv_operands(shape, batch: int, seed: int):
    """x (B, IY, IX, C), the HWIO weight and the bias, integer-valued
    float32 on the card, as the lowering holds them."""
    iy, ix, c, k, fy, fx, _, dw = shape
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (batch, iy, ix, c)).astype(np.float32)
    w = rng.integers(-128, 128, (fy, fx, 1, c) if dw else (fy, fx, c, k)).astype(np.float32)
    b = rng.integers(-3000, 3000, (w.shape[3],)).astype(np.float32)
    return [torch.from_numpy(v).to(DEV) for v in (x, w, b)]


def conv_library(xpad, w_oihw, b, stride: int, groups: int, shift: int):
    """PyTorch's own calls for the segment's function (cuDNN's conv with the
    bias, on an input padded and laid out beforehand, then the epilogue in
    two ops): the yardstick only, never on the port's path."""
    y = F.conv2d(xpad, w_oihw, b, stride=stride, groups=groups)
    return torch.clamp(torch.round(y / float(1 << shift)), 0, 127)


def conv_label(shape, batch: int) -> str:
    iy, ix, c, k, fy, fx, stride, dw = shape
    return f"{'dw' if dw else 'conv'} {batch},{iy},{ix},{c}->{k} {fy}x{fx}/{stride}"


def conv_timed():
    """The fused conv as the lowering calls it (bias, shift 5, ReLU) at
    ``CONV_SHAPES`` x ``CONV_BATCHES``; the library: cuDNN's conv on an
    input padded beforehand, and the epilogue."""
    for shape in CONV_SHAPES:
        iy, ix, c, k, fy, fx, stride, dw = shape
        oy, ox = -(-iy // stride), -(-ix // stride)
        for batch in CONV_BATCHES:
            x, w, b = conv_operands(shape, batch, seed=sum(shape[:6]) + batch)
            kw = dict(stride=stride, depthwise=dw, shift=5, relu=True)
            (py0, py1), (px0, px1) = CR.same_padding(iy, stride, fy), CR.same_padding(ix, stride, fx)
            xpad = F.pad(x.permute(0, 3, 1, 2), (px0, px1, py0, py1)).contiguous(memory_format=torch.channels_last)
            macs = batch * oy * ox * k * fy * fx * (1 if dw else c)
            yield Timed("conv_requant", conv_label(shape, batch), partial(CR.conv_requant, x, w, b, **kw),
                        partial(CR.conv_requant_plain, x, w, b, **kw),
                        partial(conv_library, xpad, w.permute(3, 2, 0, 1).contiguous(), b, stride, c if dw else 1, 5),
                        4 * (x.numel() + w.numel() + b.numel() + batch * oy * ox * k), 2 * macs, INT8_OPS_S,
                        CR.conv_launch_shape(batch, iy, ix, c, k, fy, fx, stride=stride, depthwise=dw)[:2])


def mobilenet_conv_layers() -> list[tuple]:
    """The 27 conv layers of MobileNetV1-0.25 in order, as CONV_SHAPES keys."""
    out = []
    for n in mlperf_tiny_networks()["MobileNet"].nodes:
        if n.op in ("conv2d", "dwconv2d"):
            a = {k: int(n.attr(k, 1) or 1) for k in ("OY", "OX", "C", "K", "FY", "FX", "stride")}
            dw = n.op == "dwconv2d"
            out.append((a["OY"] * a["stride"], a["OX"] * a["stride"], a["C"], a["C"] if dw else a["K"], a["FY"],
                        a["FX"], a["stride"], dw))
    return out


def phase_conv() -> list[dict]:
    """[conv]: the fused conv's rows, then MobileNetV1-0.25's 27 conv layers
    summed at each batch."""
    rows = table("conv", conv_timed())
    by = {r["shape"]: r for r in rows}
    layers = mobilenet_conv_layers()
    for batch in CONV_BATCHES:
        tot = {key: sum(by[conv_label(s, batch)][key] for s in layers)
               for key in ("ms", "launch_floor_ms", "library_ms", "bound_ms")}
        print(f"[conv] MobileNetV1-0.25's {len(layers)} conv layers at batch {batch}, ms summed: kernel {tot['ms']:.5f}, "
              f"floor {tot['launch_floor_ms']:.5f}, library {tot['library_ms']:.5f}, bound {tot['bound_ms']:.6f}")
    return rows


def flash_operands(B, H, KV, Sq, Sk, D, dtype, seed, *, bshd=False):
    """q (B, H, Sq, D) and k, v (B, KV, Sk, D) on the card, rounded to
    ``dtype`` from float32 normals.  With ``bshd`` each is the (B, H, S, D)
    view of (B, S, H, D) storage, as the model passes its activations."""
    rng = np.random.default_rng(seed)

    def mk(b, h, s, d):
        if bshd:
            x = rng.normal(size=(b, s, h, d)).astype(np.float32)
            return torch.from_numpy(x).to(DEV, dtype).transpose(1, 2)
        return torch.from_numpy(rng.normal(size=(b, h, s, d)).astype(np.float32)).to(DEV, dtype)

    return mk(B, H, Sq, D), mk(B, KV, Sk, D), mk(B, KV, Sk, D)


def window_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal attention over S tokens keeps when each
    query sees the ``window`` keys up to itself."""
    w = min(S, window)
    return w * (w + 1) // 2 + (S - w) * w


def flash_timed():
    """bf16 causal attention at qwen2.5-3b's prefill shapes and at
    recurrentgemma-2b's local attention (window 2048), as the model passes
    q, k and v; q, k, v read once and o written once, 4 B H D flops per
    kept (query, key) pair at the bf16 tensor-core rate.  The library:
    SDPA (with the boolean window mask at recurrentgemma-2b)."""
    for arch, shapes in ((LM_ARCH, FLASH_TIMED), (RG_ARCH, RG_FLASH_TIMED)):
        cfg = get_config(arch)
        H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim_
        W = cfg.local_window if "local_attn" in cfg.block_types else None
        for B, S in shapes:
            q, k, v = flash_operands(B, H, KV, S, S, D, torch.bfloat16, seed=S + (W is not None), bshd=True)
            if W is None:
                lib = partial(F.scaled_dot_product_attention, q, k, v, is_causal=True, enable_gqa=True)
            else:
                i = torch.arange(S, device=DEV)
                mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < W)
                lib = partial(F.scaled_dot_product_attention, q, k, v, attn_mask=mask, enable_gqa=True)
            pairs = S * S / 2 if W is None else window_pairs(S, W)
            yield Timed("flash_attention", f"{arch} B={B}, S={S}" + (f", window {W}" if W else ""),
                        partial(flash_attention, q, k, v, causal=True, window=W),
                        partial(flash_attention_plain, q, k, v, causal=True, window=W), lib,
                        2 * (2 * B * H * S * D + 2 * B * KV * S * D), 4 * B * H * D * pairs, BF16_FLOPS_S)


def gmm_operands(E, C, D, F, dtype, seed):
    """x (E, C, D) normal and w (E, D, F) normal / sqrt(D) on the card in
    ``dtype``."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32)).to(DEV, dtype)
    x = torch.from_numpy(rng.normal(size=(E, C, D)).astype(np.float32)).to(DEV, dtype)
    return x, w


def granite_gmm_shapes() -> list[tuple[str, int, int, int, int]]:
    """(name, E, C, D, F) of granite-moe-3b-a800m's three expert GEMMs at
    the serving engine's 4 slots: C = 4 rows x capacity 8."""
    cfg = get_config(MOE_ARCH)
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    C = SERVE_SLOTS * 8
    return [("wi", E, C, D, F), ("wo", E, C, F, D)]


def gmm_timed():
    """bf16 ``moe_gmm`` at granite-moe-3b-a800m's serving shapes (x and w
    read once, y written once; 2 E C D F flops; the library: ``torch.bmm``);
    then at granite-4.0-h-small's expert products with the routed rows (a
    decode at batch 1: top-10 of 72 experts, one pair each, each call of the
    graph routing to another of 8 draws as the layers do; a prefill's 256
    slots, 100-190 pairs an expert), bound by the routed experts' weights
    and the pairs' rows, and the same call with every row."""
    for name, E, C, D, F in granite_gmm_shapes():
        x, w = gmm_operands(E, C, D, F, torch.bfloat16, seed=D)
        yield Timed("moe_gmm", f"{name}: E,C,D,F = {E},{C},{D},{F}", partial(moe_gmm, x, w), partial(moe_gmm_plain, x, w),
                    partial(torch.bmm, x, w), 2 * (E * C * D + E * D * F + E * C * F), 2 * E * C * D * F, BF16_FLOPS_S)
    cfg = get_config(GRANITE_ARCH)
    E, K = cfg.n_experts, cfg.top_k
    g = torch.Generator().manual_seed(30)
    wi, wo = (cfg.d_model, cfg.moe_d_ff), (cfg.moe_d_ff, cfg.d_model)
    for name, C, D, F in (("decode wi", 8, *wi), ("decode wo", 8, *wo), ("prefill wi", 256, *wi),
                          ("prefill wo", 256, *wo)):
        x, w = gmm_operands(E, C, D, F, torch.bfloat16, seed=C + D)
        if C == 8:
            routings = [(torch.randperm(E, generator=g) < K).int()[None].to(DEV) for _ in range(8)]
        else:
            routings = [torch.randint(100, 191, (1, E), generator=g, dtype=torch.int32).to(DEV)]
        pairs = sum(int(r.sum()) for r in routings) / len(routings)
        experts = min(E, pairs) if C == 8 else E

        def routed(fn, x=x, w=w, routings=routings):  # each call its own turn: the check's first pair routes alike
            turn = itertools.cycle(routings)
            return lambda: fn(x, w, next(turn))

        label = f"granite-4.0-h {name} {E},{C},{D},{F}"
        yield Timed("moe_gmm", f"{label}, routed rows", routed(moe_gmm), routed(moe_gmm_plain), None,
                    2 * (experts * D * F + pairs * (D + F)), 2 * pairs * D * F, BF16_FLOPS_S)
        yield Timed("moe_gmm", f"{label}, every row", partial(moe_gmm, x, w), partial(moe_gmm_plain, x, w),
                    partial(torch.bmm, x, w), 2 * (E * C * D + E * D * F + E * C * F), 2 * E * C * D * F, BF16_FLOPS_S)


def ssd_operands(B, H, T, P, N, bc_dtype, seed, *, decay=0.2):
    """xb (B, H, T, P) and a (B, H, T) float32 as views of (B, T, H, ...)
    storage, as the model passes them; Bm, Cm (B, T, N) in ``bc_dtype``.
    The kernel test's distributions, B and C scaled by 1/sqrt(N), a =
    -|normal| x ``decay``: at 0.2 a 64-row chunk decays by about e^-10 and
    the carried state barely reaches the next chunk; at 0.002 by about
    e^-0.1, and every chunk's output leans on the carry."""
    rng = np.random.default_rng(seed)
    xb = torch.from_numpy(rng.normal(size=(B, T, H, P)).astype(np.float32)).to(DEV).transpose(1, 2)
    a = torch.from_numpy((-np.abs(rng.normal(size=(B, T, H))) * decay).astype(np.float32)).to(DEV).transpose(1, 2)
    Bm, Cm = (torch.from_numpy((rng.normal(size=(B, T, N)) / np.sqrt(N)).astype(np.float32)).to(DEV, bc_dtype)
              for _ in range(2))
    return xb, a, Bm, Cm


def ssd_widths() -> tuple[int, int, int]:
    """mamba2-1.3b's (heads, head dim, state)."""
    cfg = get_config(SSD_ARCH)
    return cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state


def rglru_operands(B, T, W, dtype, seed, *, lo=0.2):
    """a in U(``lo``, 0.999) and b normal, (B, T, W) on the card in
    ``dtype`` (the kernel test's distributions at ``lo`` = 0.2, where a
    64-step chunk's product of a is about 1e-17 and the state carried into
    it vanishes; at 0.99 it is about 0.7)."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.uniform(lo, 0.999, (B, T, W)).astype(np.float32)).to(DEV, dtype),
            torch.from_numpy(rng.normal(size=(B, T, W)).astype(np.float32)).to(DEV, dtype))


def scan_timed():
    """``ssd_scan`` at mamba2-1.3b's prefill shapes (xb, a, y and h_final in
    f32, B and C in bf16, each moved once; 5 P N flops per token and head at
    the fp32 rate) and ``rglru_scan`` at recurrentgemma-2b's (a, b read and
    h written once, f32; 2 flops an element).  No library call computes
    either."""
    H, P, N = ssd_widths()
    for B, T in SSD_TIMED:
        xb, a, Bm, Cm = ssd_operands(B, H, T, P, N, torch.bfloat16, seed=T)
        yield Timed("ssd_scan", f"{SSD_ARCH} B={B}, T={T}", partial(ssd_scan, xb, a, Bm, Cm),
                    partial(ssd_scan_plain, xb, a, Bm, Cm), None,
                    4 * (2 * B * H * T * P + B * H * T + B * H * P * N) + 2 * 2 * B * T * N, 5 * B * H * T * P * N,
                    FP32_FLOPS_S)
    W = get_config(RG_ARCH).lru_width
    for B, T in RGLRU_TIMED:
        a, b = rglru_operands(B, T, W, torch.float32, seed=T)
        yield Timed("rglru_scan", f"{RG_ARCH} B={B}, T={T}, W={W}", partial(rglru_scan, a, b),
                    partial(rglru_scan_plain, a, b), None, 12 * B * T * W, 2 * B * T * W, FP32_FLOPS_S)


def phase_ssd_heads() -> dict:
    """Device ms per ``ssd_scan`` call with each count in :data:`SSD_HEADS`
    of heads sharing one output block's C . B^T, at mamba2-1.3b's timed
    shapes and (1, 512), B/C bf16; the count the wrapper's
    ``heads_per_block`` picks on this card is starred."""
    mod = sys.modules["repro_torch.kernels.ssd_scan"]
    H, P, N = ssd_widths()
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    print(f"[kernels] ssd_scan ms per call by heads per output block (graph; {sms} SMs; * = heads_per_block's "
          f"pick; blocks = output blocks)")
    print(f"    {'B':>2s} {'T':>5s} " + " ".join(f"{f'G={g}':>10s}" for g in SSD_HEADS))
    picks = {}
    for B, T in (*SSD_TIMED, (1, 512)):
        xb, a, Bm, Cm = ssd_operands(B, H, T, P, N, torch.bfloat16, seed=T)
        chunks = mod._lib().ssd_scan_chunks(T)
        pick = mod.heads_per_block(B, H, chunks, sms)
        ms = {g: graph_ms(lambda g=g: mod._launch(xb, a, Bm, Cm, g)) for g in SSD_HEADS}
        best = min(ms, key=ms.get)
        picks[B, T] = {"pick": pick, "pick_ms": ms[pick], "best": best, "best_ms": ms[best]}
        print(f"    {B:>2d} {T:>5d} " + " ".join(f"{ms[g]:>9.5f}{'*' if g == pick else ' '}" for g in SSD_HEADS)
              + f"   blocks {' '.join(str(B * chunks * -(-H // g)) for g in SSD_HEADS)}; fastest G={best}, "
              f"pick / fastest {ms[pick] / ms[best]:.3f}")
    return picks


def branch_call(m: int, k: int, n: int, segment: bool, path: int):
    """One entry's launch at (M, K, N) as the lowering calls it, on a
    forced branch (``MR.TENSOR_CORES`` or ``MR.GEMV``)."""
    if segment:
        x, w, b = segment_operands(m, k, n, seed=7)
        out = torch.empty((m, n), dtype=torch.float32, device=DEV)
        return lambda: MR._launch(x, w, None, b, out, w.stride(0), w.stride(1), 5, "even", True, segment=True,
                                  path=path)
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8)).to(DEV)
    w = torch.from_numpy(rng.integers(-128, 128, (n, k)).astype(np.int8)).to(DEV).T
    mult = torch.from_numpy(rng.integers(1, 8, (n,)).astype(np.int32)).to(DEV)
    bias = torch.from_numpy(rng.integers(-1000, 1000, (n,)).astype(np.int32)).to(DEV)
    out = torch.empty((m, n), dtype=torch.int8, device=DEV)
    return lambda: MR._launch(a, w, mult, bias, out, w.stride(1), w.stride(0), 5, "even", True, segment=False,
                              path=path)


def phase_gemm_branches() -> list[dict]:
    """The data behind the GEMM's rule (the GEMV up to 512 blocks of 8
    outputs, the tensor cores beyond): both entries at M = 1 on the main
    path's shapes, at the served M = 16 on DAE's, and across the knee
    (``BRANCH_KNEE``), each branch forced (the GEMV: one warp per output (m,
    n)) and timed in a CUDA graph beside its own launch floor.  The
    branches' bits are the cuda tests' (``test_both_branches_*``)."""
    rows = []
    print("[kernels] matmul_requant branches, ms per call in a CUDA graph (floor at the branch's own launch shape; "
          "GEMV = one warp per output (m, n), blocks = its M x ceil(N / 8) blocks); the rule takes the GEMV up to "
          "512 blocks and the tensor cores beyond")
    print(f"    {'entry':8s} {'M':>3s} {'K':>4s} {'N':>5s} {'blocks':>6s} {'tensor cores':>12s} {'floor':>9s} "
          f"{'GEMV':>9s} {'floor':>9s} {'faster':>12s} {'rule':>12s}")
    shapes = [(1, k, n) for k, n in MAIN_KN] + [(16, k, n) for k, n in DAE_KN] + list(BRANCH_KNEE)
    label = {MR.TENSOR_CORES: "tensor cores", MR.GEMV: "GEMV"}
    for segment in (False, True):
        for m, k, n in shapes:
            row = {"entry": "f32" if segment else "int8", "shape": [m, k, n], "gemv_blocks": m * -(-n // 8)}
            for path, key in ((MR.TENSOR_CORES, "mma"), (MR.GEMV, "gemv")):
                row[f"{key}_ms"] = graph_ms(branch_call(m, k, n, segment, path))
                row[f"{key}_floor_ms"] = graph_ms(launch_floor(*MR.launch_shape(m, n, k, path)[:2]))
            row["faster"] = "GEMV" if row["gemv_ms"] < row["mma_ms"] else "tensor cores"
            row["rule"] = label[MR.launch_shape(m, n, k)[2]]
            rows.append(row)
            print(f"    {row['entry']:8s} {m:>3d} {k:>4d} {n:>5d} {row['gemv_blocks']:>6d} {row['mma_ms']:>12.5f} "
                  f"{row['mma_floor_ms']:>9.5f} {row['gemv_ms']:>9.5f} {row['gemv_floor_ms']:>9.5f} "
                  f"{row['faster']:>12s} {row['rule']:>12s}")
    agree = sum(r["faster"] == r["rule"] for r in rows)
    print(f"[kernels] the rule takes the faster branch at {agree} of {len(rows)} shapes")
    return rows


# ---------------------------------------------------------------------------
# launch counts, and the CNN paths at scale: [pipeline], [calibrate], [fuzz]
# ---------------------------------------------------------------------------


def reset_counts() -> None:
    for fn in _graphs.COUNTED:
        fn.launches = 0


def read_counts() -> dict[str, int]:
    return _graphs.launch_counts()


def with_zeros(want: dict[str, int]) -> dict[str, int]:
    """``want`` over every counted kernel: 0 launches of each it does not name."""
    return {**dict.fromkeys(read_counts(), 0), **want}


def check_counts(where: str, got: dict[str, int], want: dict[str, int]) -> None:
    if got != want:
        raise AssertionError(f"{where}: kernel launches {got}, expected {want}")


def cnn_counts(cm, runs: int) -> dict[str, int]:
    """The launches of ``runs`` runs of a CNN: one GEMM per GEMM segment, one
    fused conv per fused conv segment, and nothing else."""
    convs = sum(ls.meta.get("kernel") == "conv_requant" for ls in cm.segments)
    return with_zeros({"matmul_requant": cm.routes().get("pallas_gemm", 0) * runs, "conv_requant": convs * runs})


def check_outputs(where: str, outs: list[dict], refs: list[dict]) -> None:
    """Every output on the card, finite, and bit-exact with the CPU
    interpreter's."""
    for i, (out, ref) in enumerate(zip(outs, refs)):
        for name, want in ref.items():
            got = out[name]
            if got.device.type != "cuda" or not torch.isfinite(got).all():
                raise AssertionError(f"{where} request {i}: output not finite on the card")
            if tuple(got.shape) != tuple(want.shape) or not torch.equal(got.cpu(), want):
                raise AssertionError(f"{where} request {i}: {name} differs from the CPU interpreter")


def check_same(where: str, outs: list[dict], refs: list[dict]) -> None:
    """Every output on the card and bit-exact with ``CompiledModel.run``'s."""
    if len(outs) != len(refs):
        raise AssertionError(f"{where}: {len(outs)} outputs for {len(refs)} inputs")
    for i, (out, ref) in enumerate(zip(outs, refs)):
        for name, want in ref.items():
            got = out[name]
            if got.device.type != "cuda" or tuple(got.shape) != tuple(want.shape) or not torch.equal(got, want):
                raise AssertionError(f"{where} input {i}: {name} differs from CompiledModel.run")


def request_stream(g, n: int, seed: int = 0) -> list[dict]:
    """``n`` requests of int8-valued inputs from one generator, as the
    benchmarks draw them."""
    rng = np.random.default_rng(seed)
    return [{k: rng.integers(-128, 128, s).astype(np.float32) for k, s in g.inputs.items()} for _ in range(n)]


def bands_of(cm) -> int:
    """F.conv2d calls per request: one per output band of each conv segment
    that keeps the banded executor (a fused conv segment is one launch)."""
    return sum(-(-int(ls.segment.anchor.attr("OY", 1) or 1) // ls.meta["block_oy"])
               for ls in cm.segments if ls.route == "tiled_conv" and ls.meta.get("kernel") != "conv_requant")


def add_counts(total: dict[str, int], counts: dict[str, int]) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def phase_cnn() -> dict:
    """[cnn]: the CNN cells' path on the card's own target.  Each net,
    lowered for h100, by ``compile_aot`` at its defaults (the cells' entry),
    in arena memory, and (DAE and DS-CNN) through a 16-slot ``ModelServer``:
    ``CNN_REQUESTS`` requests each, bit-exact with the CPU interpreter, the
    launches counted from 0 after the capture exactly one per GEMM and fused
    conv segment a request (a batch, served)."""
    nets = mlperf_tiny_networks()
    launches: dict[str, int] = {}
    for net in NETS:
        g = nets[net]
        params = init_graph_params(g)
        xs = request_stream(g, CNN_REQUESTS)
        cpu_params = params_to_torch(params, "cpu")
        refs = [execute_graph(g, cpu_params, x, device="cpu") for x in xs]
        cm = lower(dispatch(g, "h100", budget=300))
        line = []
        for way in ("xla", "arena") + (("server",) if net in CNN_SERVED else ()):
            where = f"[cnn] {net} x h100 {way}"
            if way == "server":
                with ModelServer(cm, params_to_torch(params, cm.device), batch_slots=CNN_SLOTS) as srv:
                    srv.warmup(xs[0])
                    torch.cuda.synchronize()
                    reset_counts()
                    outs = [h.result(timeout=120) for h in [srv.submit(x) for x in xs]]
                torch.cuda.synchronize()
                stats = srv.stats()
                cm.attrs.pop("serve")
                if stats["completed"] != len(xs) or stats["rejected"] or not stats["drained"]:
                    raise AssertionError(f"{where}: stats {stats}")
                runs = stats["batches"]
            else:
                am = compile_aot(cm) if way == "xla" else compile_aot(cm, memory=way)
                am.warmup(params, xs[0])
                reset_counts()
                outs = [am.run(params, x) for x in xs]
                torch.cuda.synchronize()
                runs = len(xs)
            counts = read_counts()
            check_counts(where, counts, cnn_counts(cm, runs))
            check_outputs(where, outs, refs)
            add_counts(launches, counts)
            line.append(f"{way} {counts['matmul_requant']} + {counts['conv_requant']} ({runs} "
                        f"{'batches' if way == 'server' else 'requests'})")
        print(f"[cnn] {net:9s} x h100: bit-exact x{len(xs)} with the CPU interpreter; GEMM + fused conv launches, "
              f"exact: {'; '.join(line)}")
    return {"launches": launches}


def phase_pipeline() -> dict:
    """benchmarks/pipeline_throughput.py's sweep on the card: 4 nets x {gap9,
    diana, ne16_octa}, 12 inputs through ``PipelinedModel.run_stream`` (one
    CUDA stream per module lane, 3 inputs in flight), per segment and with
    each lane chain a captured graph (aot), each streamed run repeated and
    held bit-exact with ``CompiledModel.run`` with exact launches."""
    nets = mlperf_tiny_networks()
    launches: dict[str, int] = {}
    for net in NETS:
        g = nets[net]
        params = init_graph_params(g)
        xs = request_stream(g, PIPE_INPUTS)
        cpu_first = execute_graph(g, params_to_torch(params, "cpu"), xs[0], device="cpu")
        for tgt in PIPE_TARGETS:
            cm = lower(dispatch(g, tgt, budget=300))
            dev_params = params_to_torch(params, cm.device)
            refs = [cm.run(dev_params, x) for x in xs]
            check_outputs(f"[pipeline] {net}x{tgt} sequential", refs[:1], [cpu_first])
            want = cnn_counts(cm, PIPE_INPUTS)
            for aot in (False, True):
                where = f"[pipeline] {net}x{tgt} aot={aot}"
                pm = PipelinedModel(cm, stream_depth=PIPE_DEPTH, aot=aot)
                check_same(where + " warm-up", pm.run_stream(dev_params, xs), refs)  # captures (aot)
                for _ in range(PIPE_REPEATS):
                    reset_counts()
                    outs = pm.run_stream(dev_params, xs)
                    torch.cuda.synchronize()
                    counts = read_counts()
                    check_counts(where, counts, want)
                    check_same(where, outs, refs)
                    add_counts(launches, counts)
                del pm
            print(f"[pipeline] {net:9s} x {tgt:9s}: {len(cm.pipeline_schedule().lanes())} lanes, bit-exact x"
                  f"{PIPE_REPEATS} streamed runs per segment and by captured chains, launches per run "
                  f"{ {k: v for k, v in want.items() if v} }")
    return {"launches": launches}


def calibrated_net(g, target, params: dict, x: dict, ref: dict, where: str) -> dict:
    """One net on ``target``: segments per module, the (module, route) of each
    segment anchor and conv bands per request, bit-exact with the CPU
    interpreter eagerly and by AOT xla replay."""
    cm = lower(dispatch(g, target, budget=300))
    dev_params = params_to_torch(params, cm.device)
    check_outputs(f"{where} eager", [cm.run(dev_params, x)], [ref])
    am = compile_aot(cm, memory="xla")
    am.warmup(params, x)
    check_outputs(f"{where} AOT xla", [am.run(params, x)], [ref])
    modules: dict[str, int] = {}
    for ls in cm.segments:
        modules[ls.module] = modules.get(ls.module, 0) + 1
    return {"modules": modules, "anchors": {ls.segment.anchor.name: (ls.module, ls.route) for ls in cm.segments},
            "segments": len(cm.segments), "bands": bands_of(cm), "predicted_cycles": cm.predicted_cycles()}


def phase_calibrate() -> dict:
    """The calibration loop on the card's own target: the full microbench
    sweep (9 graphs x {h100, cuda_core, tensor_core, aten only}, 3 timed
    repeats) on the card, a least-squares fit per module, the profile saved
    under build/ and loaded back; then the four nets on h100 under the
    declared and the fitted model."""
    # imported here: a --src tree from before the calibration loop still runs the other phases
    from repro_torch.calibrate import (
        default_sweep, fit_profile, load_profile, run_microbench, save_samples, unsampled_modules,
    )

    t0 = time.perf_counter()
    reset_counts()
    declared = get_target("h100", profile=None)
    samples = run_microbench("h100", repeats=3)  # default device: the card
    sweep_s = time.perf_counter() - t0
    unsampled = unsampled_modules(declared, samples)
    profile = fit_profile(samples, target_name="h100",
                          meta={"source": "chip_smoke.py [calibrate]", "card": card_line(),
                                "declared_as_is": unsampled})
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "calibration")
    save_samples(os.path.join(out_dir, "h100_samples.json"), samples, target="h100", meta={"repeats": 3})
    path = os.path.join(out_dir, "h100_profile.json")
    profile.save(path)
    loaded = load_profile(path)
    if loaded is None or loaded.tag() != profile.tag():
        raise AssertionError(f"[calibrate] the saved profile {path} does not load back as {profile.tag()}")
    print(f"[calibrate] h100: {len(samples)} samples from {len(default_sweep())} graphs x "
          f"{len(declared.modules) + 2} variants in {sweep_s:.1f} s (CUDA events around each eager segment, "
          f"min of 3); profile {profile.tag()} -> {path}; no samples, left as declared: {unsampled}")
    for name, mc in sorted(profile.modules.items()):
        group = [s for s in samples if s.module == name]
        y = np.array([s.measured_cycles for s in group])
        before = np.median(y / np.array([s.predicted_cycles for s in group]))
        after = np.median(y / np.array([mc.predict_cycles(s.l_ops, s.l_mem, s.async_dma) for s in group]))
        f = group[0].frequency_hz
        kept = " (the fit would raise the MAE: declared model kept)" if mc.is_identity() else ""
        print(f"[calibrate] {name:9s}: {mc.samples:3d} samples ({'async, one scale' if group[0].async_dma else 'sync'}); "
              f"compute_scale {mc.compute_scale:.6g}, mem_scale {mc.mem_scale:.6g}, fixed_overhead_cycles "
              f"{mc.fixed_overhead_cycles:.6g} ({mc.fixed_overhead_cycles / f * 1e6:.3f} us); MAE cycles "
              f"{mc.mae_before:.1f} -> {mc.mae_after:.1f} (us {mc.mae_before / f * 1e6:.3f} -> "
              f"{mc.mae_after / f * 1e6:.3f}); median measured/predicted {before:.3f} -> {after:.3f}{kept}")
        if not mc.mae_after < mc.mae_before:
            raise AssertionError(f"[calibrate] {name}: the fit did not lower the MAE ({mc.mae_before} -> {mc.mae_after})")
    print("[calibrate] by module and route (medians, us): measured, the declared model's prediction, the fitted one's")
    groups: dict[tuple, list] = {}
    for smp in samples:
        groups.setdefault((smp.module, smp.route), []).append(smp)
    for (name, route), group in sorted(groups.items()):
        mc = profile.modules[name]
        f = group[0].frequency_hz / 1e6
        med = lambda v: float(np.median(v))  # noqa: E731
        print(f"    {name:9s} {route:11s} {len(group):3d} samples: measured {med([g.measured_us for g in group]):9.2f}, "
              f"declared {med([g.predicted_cycles for g in group]) / f:7.2f}, fitted "
              f"{med([mc.predict_cycles(g.l_ops, g.l_mem, g.async_dma) for g in group]) / f:9.2f}")
    # a segment swept in two variants on the same module is measured twice:
    # the spread between the two is the measurement's own noise
    seen: dict[tuple, list[float]] = {}
    for smp in samples:
        seen.setdefault((smp.graph, smp.segment, smp.module, smp.route), []).append(smp.measured_us)
    spread = sorted(max(v) / min(v) for v in seen.values() if len(v) > 1)
    if spread:
        print(f"[calibrate] the same segment measured in two variants: {len(spread)} pairs, max/min median "
              f"{np.median(spread):.2f}, largest {spread[-1]:.2f}")
    fitted = get_target("h100", profile=profile)
    nets = mlperf_tiny_networks()
    for net in NETS:
        g = nets[net]
        params = init_graph_params(g)
        x = request_stream(g, 1)[0]
        ref = execute_graph(g, params_to_torch(params, "cpu"), x, device="cpu")
        d = calibrated_net(g, declared, params, x, ref, f"[calibrate] {net} declared")
        c = calibrated_net(g, fitted, params, x, ref, f"[calibrate] {net} fitted")
        moved: dict[str, list[str]] = {}
        for a, was in d["anchors"].items():
            now = c["anchors"].get(a, was)
            if now != was:
                moved.setdefault(f"{'/'.join(was)} -> {'/'.join(now)}", []).append(a)
        print(f"[calibrate] {net:9s} x h100 declared / fitted: segments {d['segments']} / {c['segments']}, by module "
              f"{d['modules']} / {c['modules']}; conv bands per request {d['bands']} / {c['bands']}; "
              f"predicted cycles {d['predicted_cycles']:.0f} / {c['predicted_cycles']:.0f}; bit-exact "
              f"with the CPU interpreter under both; anchors moved: "
              + ("; ".join(f"{k} x{len(v)} ({' '.join(v)})" for k, v in moved.items()) or "none"))
    counts = read_counts()
    check_counts("[calibrate]", counts, with_zeros({k: counts[k] for k in ("matmul_requant", "conv_requant")}))
    if counts["matmul_requant"] == 0:
        raise AssertionError("[calibrate] no matmul_requant launch: the dense sweep missed the GEMM")
    print(f"[calibrate] {time.perf_counter() - t0:.1f} s in all; matmul_requant launches {counts['matmul_requant']}, "
          f"conv_requant launches {counts['conv_requant']}")
    return {"launches": counts}


@contextlib.contextmanager
def recorded_gemm_shapes(sink: set):
    """Record the (M, K, N) of every GEMM segment call the lowering makes
    (the kernel's own wrapper, and so its count, untouched)."""
    lower_mod = importlib.import_module("repro_torch.backend.lower")
    entry = lower_mod.matmul_requant_f32

    def record(a, w, bias, **kw):
        sink.add((int(a.shape[0]), int(a.shape[1]), int(w.shape[0])))
        return entry(a, w, bias, **kw)

    lower_mod.matmul_requant_f32 = record
    try:
        yield
    finally:
        lower_mod.matmul_requant_f32 = entry


def phase_fuzz() -> dict:
    """The differential fuzzer on the card: seeds 0-23 x {h100, gap9} with
    the full battery on every seed (one SchedulePlanner per target), then
    the shipped corpus cases replayed with the full battery on their own
    targets; every compiled path on the card against the CPU interpreter."""
    from repro_torch.core import SchedulePlanner
    from repro_torch.fuzz import INVARIANTS, check_case, load_cases, replay_case, sample_spec

    t0 = time.perf_counter()
    reset_counts()
    planners = {t: SchedulePlanner() for t in FUZZ_TARGETS}
    coverage = dict.fromkeys(INVARIANTS, 0)
    failures, shapes = [], set()
    cases = 0
    with recorded_gemm_shapes(shapes):
        for seed in range(FUZZ_SEEDS):
            spec = sample_spec(seed)
            for tgt in FUZZ_TARGETS:
                rep = check_case(spec, tgt, io_seed=seed, budget=120, planner=planners[tgt])
                cases += 1
                for iv in rep.invariants_checked:
                    coverage[iv] += 1
                failures += [(f"seed {seed}", f) for f in rep.failures]
        corpus = load_cases(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "conformance", "corpus"))
        if not corpus:
            raise AssertionError("[fuzz] no corpus case found under tests/conformance/corpus")
        for path, case in corpus:
            rep = replay_case(case, budget=120, full_battery=True)
            cases += 1
            for iv in rep.invariants_checked:
                coverage[iv] += 1
            failures += [(os.path.basename(path), f) for f in rep.failures]
    torch.cuda.synchronize()
    counts = read_counts()
    seconds = time.perf_counter() - t0
    odd = sorted(s for s in shapes if s[1] % 4 or s[2] % 4)
    print(f"[fuzz] seeds 0-{FUZZ_SEEDS - 1} x {', '.join(FUZZ_TARGETS)} and {len(corpus)} corpus cases "
          f"({', '.join(c['target'] for _, c in corpus)}), full battery on the card: {cases} cases in {seconds:.1f} s; "
          "invariant coverage " + " ".join(f"{iv}={n}" for iv, n in coverage.items())
          + f"; failures {len(failures)}; matmul_requant launches {counts['matmul_requant']}, conv_requant launches "
          f"{counts['conv_requant']}")
    print(f"[fuzz] GEMM segment (M, K, N) reached: {len(shapes)} distinct, {len(odd)} with K or N not divisible by 4: "
          + " ".join(f"{m}x{k}x{n}" for m, k, n in sorted(shapes)))
    for where, f in failures:
        print(f"[fuzz] FAIL {where} target={f.target} invariant={f.invariant} stage={f.stage}: {f.message}")
    check_counts("[fuzz]", counts, with_zeros({k: counts[k] for k in ("matmul_requant", "conv_requant")}))
    if failures:
        raise AssertionError(f"[fuzz] {len(failures)} failures")
    if counts["matmul_requant"] == 0:
        raise AssertionError("[fuzz] no matmul_requant launch: the fuzz graphs' dense heads missed the GEMM")
    if counts["conv_requant"] == 0:
        raise AssertionError("[fuzz] no conv_requant launch: the fuzz graphs' convs missed the fused conv")
    return {"launches": counts, "cases": cases, "failures": len(failures)}


# ---------------------------------------------------------------------------
# the LMs at full width: [lm], [lm-bf16], [prefill-long], [serve]
# ---------------------------------------------------------------------------


def layer_kinds(cfg) -> dict[str, int]:
    """Layers of ``cfg`` by what they launch: attention (``attn`` and
    ``local_attn``), MoE (the FFN half of every non-ssd block), ssd and
    rglru."""
    pat = cfg.layer_pattern()
    attn = sum(bt in ("attn", "local_attn") for bt in pat)
    rglru = sum(bt == "rglru" for bt in pat)
    return {"attn": attn, "moe": attn + rglru if cfg.is_moe else 0, "ssd": sum(bt == "ssd" for bt in pat),
            "rglru": rglru}


def expected_counts(cfg, prefills: int, decode_steps: int) -> dict[str, int]:
    """Exact launches of each kernel on the LM path: flash once per
    attention layer, ssd_scan once per ssd layer and rglru_scan once per
    rglru layer per prefill call (decode is plain torch there), moe_gmm
    three times per MoE layer per prefill call and per decode step."""
    n = layer_kinds(cfg)
    return with_zeros({
        "flash_attention": n["attn"] * prefills,
        "moe_gmm": 3 * n["moe"] * (prefills + decode_steps),
        "ssd_scan": n["ssd"] * prefills,
        "rglru_scan": n["rglru"] * prefills,
    })


def ssd_scan_f64(xb, a, Bm, Cm):
    """``h_t = e^{a_t} h_{t-1} + xb_t B_t^T``, ``y_t = h_t C_t`` step by
    step in float64: the oracle that says which of the kernel and the
    plain version carries a gap between the two."""
    x, av, b, c = (t.double() for t in (xb, a, Bm, Cm))
    Bsz, H, T, P = x.shape
    h = torch.zeros((Bsz, H, P, b.shape[-1]), dtype=torch.float64, device=x.device)
    y = torch.empty((Bsz, H, T, P), dtype=torch.float64, device=x.device)
    for t in range(T):
        h = torch.exp(av[:, :, t])[..., None, None] * h + x[:, :, t, :, None] * b[:, None, t, None, :]
        y[:, :, t] = torch.einsum("bhpn,bn->bhp", h, c[:, t])
    return y, h


@torch.no_grad()
def draw_rglru_decays(lm, seed: int) -> None:
    """Redraw every rglru layer's decay and gate parameters in place, from a
    CPU generator seeded ``seed``: ``lam`` uniform in [-6, -2], the decay
    gate's bias N(0, 0.5) and weight N(0, 0.001), the input gate's N(0,
    0.5).  At the reference init every a_t is near e^-5.25 and h carries
    nothing across time; these put a_t in about 0.4-0.999.  The decay
    gate's weight stays small because its input is large: a stacked
    leaf's fan-in is its layer count, 1 in a one-repeat stack, so at full
    width x W_x has entries in the hundreds.  A wider weight saturates
    r_t and puts a_t within float32 ulps of 1, where 1 - a_t^2 keeps no
    correct digit and the card and the CPU round it apart."""
    g = torch.Generator().manual_seed(seed)
    for bt, layer in zip(lm.block_types, lm.layers):
        if bt == "rglru":
            p = layer.rglru
            p.lam.uniform_(-6.0, -2.0, generator=g)
            p.gate_a_b.normal_(0.0, 0.5, generator=g)
            p.gate_a_w.normal_(0.0, 0.001, generator=g)
            p.gate_i_b.normal_(0.0, 0.5, generator=g)
            p.gate_i_w.normal_(0.0, 0.5, generator=g)


def check_decays(lm, tokens) -> str:
    """The decays a_t of ``lm``'s first rglru layer on ``tokens`` (CPU):
    they must carry across time (max above 0.9) and stay clear of 1 (max
    below 0.9999, where 1 - a_t^2 still keeps its leading digits)."""
    top, layers = lm._params()
    p = layers[lm.block_types.index("rglru")]
    h = rmsnorm(lm._embed_in(top, tokens, None), p["norm1"], lm.cfg.norm_eps)
    xr, _ = rglru_mod._causal_conv1d(h @ p["rglru"]["wx"], p["rglru"]["conv_w"])
    a, _ = rglru_mod._gates(p["rglru"], xr)
    lo, hi = float(a.min()), float(a.max())
    if not 0.9 < hi < 0.9999:
        raise AssertionError(f"drawn decays a_t in [{lo:.6f}, {hi:.6f}]: need a max in (0.9, 0.9999)")
    return f"first rglru layer's a_t in [{lo:.4f}, {hi:.6f}]"


def check_rings(arch: str, cache: dict, cfg, max_len: int, last: int) -> None:
    """Every local-attention ring is min(max_len, window) slots long and
    holds position ``last`` at slot ``last % L``."""
    for i, stack in cache.items():
        for name, leaves in stack.items():
            if name.endswith("local_attn"):
                pos = leaves["pos"]
                L = pos.shape[-1]
                if L != min(max_len, cfg.local_window) or bool((pos[:, last % L] != last).any()):
                    raise AssertionError(f"LM parity {arch}: {i}/{name} ring of {L} slots, pos[{last % L}] "
                                         f"= {pos[:, last % L].tolist()}, expected {last}")


def phase_lm_parity(arch: str, *, n_layers: int = 2, prompt: int = 16, prepare=None) -> dict:
    """``arch`` at full width, ``n_layers`` layers, fp32: the module on the
    card (the kernels; decode by the serving engine's captured graph)
    against a copy on the CPU (plain versions, decode op by op), a
    ``prompt``-token prefill and 4 greedy decode steps.  ``prepare(lm)``
    edits the CPU module's weights before the copy."""
    cfg = get_config(arch).replace(n_layers=n_layers, dtype="float32")
    t0 = time.perf_counter()
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    if prepare is not None:
        prepare(cpu)
    gpu = copy.deepcopy(cpu).to(DEV)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, prompt)))
    max_len = prompt + 8
    worst, tokens = 0.0, []
    with torch.inference_mode():
        decays = check_decays(cpu, toks) if "rglru" in cfg.block_types else ""
    eng = ServeEngine(gpu, batch_slots=toks.shape[0], max_len=max_len)  # decode by graph replay
    reset_counts()
    with torch.inference_mode():
        lg, cache = gpu.prefill(toks.to(DEV), max_len=max_len)
        cache = eng._decode_cache(cache, toks.shape[0])  # captures the step, copies the prefill's cache in
        want, want_cache = cpu.prefill(toks, max_len=max_len)
        for step in range(5):
            got = lg.cpu()
            if not torch.isfinite(got).all():
                raise AssertionError(f"LM parity {arch} step {step}: logits not finite on the card")
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, atol=1e-3, rtol=1e-3):
                raise AssertionError(f"LM parity {arch} step {step}: max |card - cpu| logit = {err:.3g} beyond 1e-3")
            worst = max(worst, err)
            nxt, nxt_dev = want.argmax(-1), got.argmax(-1)
            if not torch.equal(nxt, nxt_dev):
                raise AssertionError(
                    f"LM parity {arch} step {step}: greedy tokens {nxt_dev.tolist()} != cpu {nxt.tolist()}"
                )
            tokens.append(nxt.tolist())
            if step == 4:
                break
            lg = eng._decode(cache, nxt.numpy(), prompt + step)
            want, want_cache = cpu.decode_step(want_cache, nxt, prompt + step)
    counts = read_counts()
    check_counts(f"LM parity {arch}", counts, expected_counts(cfg, prefills=1, decode_steps=4))
    check_rings(arch, cache, cfg, max_len, prompt + 3)
    if eng.eager or len(eng.capture_ms) != 1:
        raise AssertionError(f"LM parity {arch}: decode did not run by graph replay")
    print(f"[lm] {cfg.name} full width x {cfg.n_layers} layers fp32: prefill of {prompt} + 4 greedy steps "
          f"(decode by graph replay, capture {next(iter(eng.capture_ms.values())):.1f} ms), card vs cpu "
          f"max |logit diff| {worst:.3e} (atol=rtol=1e-3), tokens identical {tokens}, "
          f"launches {counts}, {time.perf_counter() - t0:.1f} s" + (f"; {decays}" if decays else ""))
    del cpu, gpu, eng, cache, want_cache
    gc.collect()
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, "launches": counts}


# the name each model module calls a kernel by, and the kernel's plain version
MODEL_KERNELS = ((attention_mod, "flash_attention"), (moe_mod, "moe_gmm"), (ssd_mod, "ssd_scan"),
                 (rglru_mod, "rglru_scan"))
PLAIN = {"flash_attention": flash_attention_plain, "moe_gmm": moe_gmm_plain, "ssd_scan": ssd_scan_plain,
         "rglru_scan": rglru_scan_plain}
KERNEL = {"flash_attention": flash_attention, "moe_gmm": moe_gmm, "ssd_scan": ssd_scan, "rglru_scan": rglru_scan}
# [lm-bf16]: each kernel call's limit on max |kernel - plain| / max |plain|:
# the bf16 kernel grid's tolerance for the tensor-core kernels, the kernel
# grid's for the fp32 scans
PER_CALL_TOL = {"flash_attention": FLASH_TOL[torch.bfloat16], "moe_gmm": GMM_TOL[torch.bfloat16],
                "ssd_scan": SSD_TOL, "rglru_scan": RGLRU_TOL}


@contextlib.contextmanager
def kernels_as(kernels: dict):
    """The model modules' names of the four kernels bound to ``kernels[name]``
    for the duration: this script's comparisons only, the package has no
    switch."""
    saved = [getattr(mod, name) for mod, name in MODEL_KERNELS]
    for mod, name in MODEL_KERNELS:
        setattr(mod, name, kernels[name])
    try:
        yield
    finally:
        for (mod, name), fn in zip(MODEL_KERNELS, saved):
            setattr(mod, name, fn)


def on_inputs(kernel, plain, tol: float, worst: dict, name: str, oracle=None, against: dict | None = None):
    """``kernel`` that also holds each call's output against ``plain`` on
    the same inputs (the model's own activations, at its shapes): max
    |kernel - plain| within ``tol`` of max |plain|, for each element of a
    tuple output, the kernel grid's atol taken to the scale of these
    activations (an attention output near 0 carries an error in proportion
    to |v|, not to itself).  The largest ratio goes to ``worst[name]``.
    With ``oracle``, the largest ratios of kernel and plain version each to
    the oracle go to ``against["kernel"]`` and ``against["plain"]``
    (reported, not checked).  The plain call launches nothing."""
    def ratio(got, want):
        pairs = zip(got, want) if isinstance(got, tuple) else ((got, want),)
        return max(float((g.float() - w.float()).abs().max() / w.float().abs().max().clamp_min(1e-30))
                   for g, w in pairs)

    def call(*args, **kw):
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        r = ratio(got, want)
        worst[name] = max(worst.get(name, 0.0), r)
        if r > tol:
            raise AssertionError(f"{name} on the model's inputs {tuple(args[0].shape)}: max |kernel - plain| "
                                 f"/ max |plain| = {r:.3g} beyond {tol}")
        if oracle is not None:
            truth = oracle(*args, **kw)
            for who, out in (("kernel", got), ("plain", want)):
                against[who] = max(against.get(who, 0.0), ratio(out, truth))
        return got
    return call


@contextlib.contextmanager
def routing(record: list | None = None, replay: list | None = None):
    """The MoE layers' routing decisions appended to ``record``, one (B, S,
    K) tensor of slots per layer call; or, with ``replay``, the slots of an
    earlier run fed back in order, each kept slot's gate taken from this
    run's own router probabilities and renormalised as ``_route`` does.
    This script's comparisons only, the package has no switch."""
    route, pending = moe_mod._route, list(replay or [])

    def recorded(probs, K, C):
        slots, gates, counts = route(probs, K, C)
        if record is not None:
            record.append(slots)
        return slots, gates, counts

    def replayed(probs, K, C):
        slots = pending.pop(0)
        expert = torch.div(slots, C, rounding_mode="floor").clamp_min(0).long()
        gates = torch.where(slots >= 0, probs.gather(-1, expert), 0.0)
        one_hot = (expert[..., None] == torch.arange(probs.shape[-1], device=slots.device)) & (slots >= 0)[..., None]
        return (slots, gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9),
                one_hot.sum(dim=(1, 2), dtype=torch.int32))

    moe_mod._route = replayed if replay is not None else recorded
    try:
        yield
    finally:
        moe_mod._route = route
    if pending:
        raise AssertionError(f"routing replay: {len(pending)} recorded layer calls left over")


ROUTE = moe_mod._route  # the package's own routing


@contextlib.contextmanager
def own_routing():
    """The MoE layers route with the package's ``_route`` for the duration,
    whatever :func:`routing` has bound: nothing recorded, nothing replayed."""
    bound = moe_mod._route
    moe_mod._route = ROUTE
    try:
        yield
    finally:
        moe_mod._route = bound


@contextlib.contextmanager
def layers_checked(worst: dict):
    """During a run with the plain versions: each attention layer's output
    and each MoE layer's output before its residual add, computed a second
    time through the kernels on the same inputs (the plain run's own
    activations; an MoE layer routes the same on the same inputs, the
    router runs no kernel), within the kernel's per-call limit of max
    |plain| (flash and moe_gmm, 2e-2).  The largest ratio of each kind
    goes to ``worst["attention layer"]`` and ``worst["moe layer"]``.  The
    plain run's outputs pass on unchanged."""
    saved = transformer_mod.attention_kv, transformer_mod.moe_ffn

    def checked(kind: str, fn, tol: float):
        def call(*args, **kw):
            want = fn(*args, **kw)
            with kernels_as(KERNEL), own_routing():
                got = fn(*args, **kw)
            g, w = got[0].float(), want[0].float()
            r = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
            worst[kind] = max(worst.get(kind, 0.0), r)
            if r > tol:
                raise AssertionError(f"{kind} output on the model's inputs {tuple(args[1].shape)}: max |kernels - "
                                     f"plain| / max |plain| = {r:.3g} beyond {tol}")
            return want
        return call

    transformer_mod.attention_kv = checked("attention layer", saved[0], PER_CALL_TOL["flash_attention"])
    transformer_mod.moe_ffn = checked("moe layer", saved[1], PER_CALL_TOL["moe_gmm"])
    try:
        yield
    finally:
        transformer_mod.attention_kv, transformer_mod.moe_ffn = saved


def flash_plain_toward_zero(q, k, v, **kw):
    """The plain flash with its fp32 output rounded to bf16 toward zero
    instead of to nearest: for every element one of the two bf16 values
    nearest the exact output, as a correct bf16 kernel may return."""
    o = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    return (o.view(torch.int32) & ~0xFFFF).view(torch.float32).to(torch.bfloat16)


def phase_lm_bf16(arch: str, *, n_layers: int = 2, batch: int = 4, prompt: int = 512, prepare=None,
                  seeds: tuple[int, ...] = (1, 2, 3)) -> dict:
    """``arch`` at full width, ``n_layers`` layers, bf16 on the card, one
    prompt batch per seed in ``seeds``:

    * every kernel call of the prefill through the kernels against its
      plain version on the same inputs (:func:`on_inputs`), within
      :data:`PER_CALL_TOL`;
    * the prefill's last-token logits through the kernels against the
      same module with the four plain versions, the MoE routing of the
      plain run replayed in the kernels' run (a routing decision is
      discrete: one ulp can move a token past an expert's capacity), within
      3e-2 of the largest |logit|, or within the model's floor if that is
      larger: how far the logits move when the plain flash's output is
      rounded toward zero (:func:`flash_plain_toward_zero`), a difference
      no check on the logits can tell from a correct kernel's.

    Also printed: greedy agreement, for an MoE model the gap with each run
    routing itself, and for the first seed both bf16 runs against an fp32
    run of the same weights.  ``prepare(lm)`` edits the weights (on the
    CPU, before the move)."""
    cfg = get_config(arch).replace(n_layers=n_layers)
    t0 = time.perf_counter()
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    if prepare is not None:
        prepare(cpu)
    lm32 = LM(cfg.replace(dtype="float32"), device="cpu", generator=torch.Generator().manual_seed(0))
    lm32.load_state_dict({k: v.float() for k, v in cpu.state_dict().items()})
    lm, lm32 = cpu.to(DEV), lm32.to(DEV)
    worst: dict[str, float] = {}  # the kernels this model calls
    against: dict[str, float] = {}  # ssd_scan's kernel and plain version against a float64 recurrence
    checked = {name: on_inputs(KERNEL[name], PLAIN[name], PER_CALL_TOL[name], worst, name) for name in KERNEL}
    checked["ssd_scan"] = on_inputs(ssd_scan, ssd_scan_plain, SSD_TOL, worst, "ssd_scan", ssd_scan_f64, against)

    layers: dict[str, float] = {}  # each attention and MoE layer's output, kernels against plain

    def prefill(model, toks, kernels, check_layers=False, **route):
        checks = layers_checked(layers) if check_layers else contextlib.nullcontext()
        with torch.inference_mode(), kernels_as(kernels), routing(**route), checks:
            out, _ = model.prefill(toks, max_len=prompt)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"bf16 LM {arch}: logits not finite")
        return out.float()

    gaps, floors = [], []
    for seed in seeds:
        toks = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, (batch, prompt))).to(DEV)
        routes: list = []
        want = prefill(lm, toks, PLAIN, check_layers=True, record=routes)
        reset_counts()
        got = prefill(lm, toks, checked, replay=routes)
        counts = read_counts()
        check_counts(f"bf16 LM {arch}", counts, expected_counts(cfg, prefills=1, decode_steps=0))
        top = float(want.abs().max())

        def gap(a, b):
            return float((a - b).abs().max()) / top

        gaps.append(gap(got, want))
        floors.append(gap(prefill(lm, toks, {**PLAIN, "flash_attention": flash_plain_toward_zero}, replay=routes),
                          want))
        limit = max(3e-2, floors[-1])
        line = (f"[lm-bf16] {cfg.name} full width x {n_layers} layers bf16, prefill ({batch}, {prompt}), seed {seed}: "
                f"kernels vs plain versions max |logit gap| / max |logit| = {gaps[-1]:.3e} (limit {limit:.3e}: "
                f"3e-2 or the floor {floors[-1]:.3e}; max |logit| {top:.3f}), greedy agreement "
                f"{float((got.argmax(-1) == want.argmax(-1)).float().mean()):.2f}")
        if cfg.is_moe:
            own: list = []
            free = prefill(lm, toks, KERNEL, record=own)
            moved = [f"{float((a != b).float().mean()):.3f}" for a, b in zip(own, routes)]
            line += (f"; each run routing itself {gap(free, want):.3e}, share of routing slots that moved "
                     f"per layer {moved}")
        if seed == seeds[0]:
            truth = prefill(lm32, toks, PLAIN)
            line += f"; bf16 vs an fp32 run of the same weights: plain {gap(want, truth):.3e}, kernels {gap(got, truth):.3e}"
        print(line + f"; launches {counts}")
        if gaps[-1] > limit:
            raise AssertionError(f"bf16 LM {arch} seed {seed}: logit gap {gaps[-1]:.3g} of max |logit| beyond {limit:.3g}")
    print(f"[lm-bf16] {cfg.name}: every kernel call within its limit of its plain version on the model's own "
          f"inputs, max |kernel - plain| / max |plain| "
          f"{', '.join(f'{k} {v:.3e} (limit {PER_CALL_TOL[k]:g})' for k, v in worst.items())}"
          + (f"; ssd_scan against a float64 recurrence on the same inputs, max |x - f64| / max |f64|: kernel "
             f"{against['kernel']:.3e}, plain {against['plain']:.3e}" if against else "")
          + f"; {time.perf_counter() - t0:.1f} s")
    if layers:
        print(f"[lm-bf16] {cfg.name}: each layer's output before its residual add, through the kernels against the "
              f"plain versions on the plain run's activations, max |kernels - plain| / max |plain| over "
              f"{len(seeds)} seeds: " + ", ".join(f"{k} {v:.3e} (limit {PER_CALL_TOL['flash_attention' if k.startswith('attention') else 'moe_gmm']:g})"
                                                  for k, v in layers.items()))
    del cpu, lm, lm32
    gc.collect()
    torch.cuda.empty_cache()
    return {"gap": max(gaps), "floor": max(floors), **worst, **layers}


def phase_prefill_long(arch: str) -> dict:
    """One ``LONG_PROMPT``-token prompt through full-depth bf16 ``LM.prefill``
    (``max_len`` = the prompt): host ms between syncs (median of 3 after a
    warm-up), exact launch counts, and for each kernel of the prefill its
    device ms per counted call (all the device kernels one call issues)
    from a ``torch.profiler`` pass."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config(arch)
    lm = LM(cfg, device=DEV, generator=torch.Generator(device=DEV).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (1, LONG_PROMPT))).to(DEV)
    want = expected_counts(cfg, prefills=1, decode_steps=0)
    ms = []
    with torch.inference_mode():
        lg, _ = lm.prefill(toks, max_len=LONG_PROMPT)  # warm-up
        for _ in range(3):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            lg, _ = lm.prefill(toks, max_len=LONG_PROMPT)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            check_counts(f"prefill-long {arch}", read_counts(), want)
        if not torch.isfinite(lg).all():
            raise AssertionError(f"prefill-long {arch}: logits not finite")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            lm.prefill(toks, max_len=LONG_PROMPT)
            torch.cuda.synchronize()
    device = [(e.name, e.time_range.elapsed_us()) for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(us for _, us in device) / 1e3
    med = sorted(ms)[1]
    kernels = {}
    for name in ("flash_attention", "ssd_scan", "rglru_scan"):
        if want[name]:
            us = [t for n, t in device if name in n]
            kernels[name] = {"launches": want[name], "device_kernels": len(us),
                             "ms_per_call": sum(us) / 1e3 / want[name] if us else float("nan"),
                             "ms": sum(us) / 1e3}
    print(f"[prefill-long] {cfg.name} full depth ({cfg.n_layers} layers) bf16, one {LONG_PROMPT}-token prompt, "
          f"max_len {LONG_PROMPT}: prefill ms median {med:.3f} (runs {', '.join(f'{t:.3f}' for t in ms)}); "
          f"device busy {busy_ms:.3f} ms in the profiled call; per kernel (launches counted per call, device "
          f"kernels in the profiled call, device ms per counted call, device ms in all): "
          + "; ".join(f"{k} {v['launches']}, {v['device_kernels']}, {v['ms_per_call']:.5f}, {v['ms']:.3f}"
                      for k, v in kernels.items()))
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    return {"prefill_ms": med, "busy_ms": busy_ms, "kernels": kernels}


class CheckedLM:
    """The serving engine's model, with its prefills counted and each
    prefill's logits checked finite.  Everything else passes through."""

    def __init__(self, lm):
        self.lm = lm
        self.prefills = 0
        self.finite = True

    def __getattr__(self, name):
        return getattr(self.lm, name)

    def prefill(self, tokens, max_len=None):
        out = self.lm.prefill(tokens, max_len=max_len)
        self.prefills += 1
        self.finite &= bool(torch.isfinite(out[0]).all())
        return out


def serve_runs(eng, cfg, model: CheckedLM, runs: int) -> list[dict]:
    """``runs`` calls of ``eng.run()`` on launch.serve's requests, each
    with its launch counts from 0 just before and read just after, checked
    exact: flash and the scans once per layer per prefill, moe_gmm three
    times per MoE layer per prefill and per decode step; every decode's
    logits (one graph replay, or one eager ``decode_step``) checked finite."""
    decode, decodes = eng._decode, []

    def checked(cache, cur, pos):
        logits = decode(cache, cur, pos)
        decodes.append(bool(torch.isfinite(logits).all()))
        return logits

    eng._decode = checked
    out = []
    try:
        for _ in range(runs):
            steps0, refills0, prefills0 = eng.decode_steps, eng.refills, model.prefills
            decodes.clear()
            serve.submit_requests(eng, cfg, SERVE_REQUESTS, SERVE_NEW)
            reset_counts()
            done = eng.run()
            torch.cuda.synchronize()
            counts = read_counts()
            prefills, steps = model.prefills - prefills0, eng.decode_steps - steps0
            check_counts(f"serve {cfg.name}", counts, expected_counts(cfg, prefills, steps))
            if len(decodes) != steps:
                raise AssertionError(f"serve {cfg.name}: {len(decodes)} decodes, the engine counted {steps} steps")
            if sorted(r.rid for r in done) != list(range(SERVE_REQUESTS)):
                raise AssertionError(f"serve {cfg.name}: served {[r.rid for r in done]}, expected all {SERVE_REQUESTS}")
            for r in done:
                if len(r.out_tokens) != SERVE_NEW or r.truncated or not all(0 <= t < cfg.vocab for t in r.out_tokens):
                    raise AssertionError(f"serve {cfg.name}: request {r.rid} gave {r.out_tokens} "
                                         f"(truncated={r.truncated})")
            if not (model.finite and all(decodes)):
                raise AssertionError(f"serve {cfg.name}: logits not finite")
            out.append({
                "served": [(r.rid, len(r.prompt), tuple(r.out_tokens), r.truncated)
                           for r in sorted(done, key=lambda r: r.rid)],
                "decode_steps": steps, "refills": eng.refills - refills0, "prefills": prefills, "launches": counts,
            })
    finally:
        del eng._decode  # back to the engine's own method
    return out


def phase_serve(arch: str) -> dict:
    """launch.serve's engine on ``arch``, full width and depth, bf16: 4 runs
    decoding by graph replay (the default on the card) and 4 op by op
    (``eager=True``) on one model, identical in all that they serve and
    launch."""
    cfg = get_config(arch)
    graph_eng = serve.build_engine(cfg, "cuda", slots=SERVE_SLOTS)
    lm = graph_eng.model
    eager_eng = ServeEngine(lm, batch_slots=SERVE_SLOTS, max_len=serve.MAX_LEN, eager=True)
    if graph_eng.eager or not eager_eng.eager:
        raise AssertionError(f"serve {arch}: the engine on the card must decode by graph unless asked not to")
    results = {}
    for mode, eng in (("graph", graph_eng), ("eager", eager_eng)):
        eng.model = CheckedLM(lm)
        results[mode] = serve_runs(eng, cfg, eng.model, runs=4)
        eng.model = lm
    first = results["eager"][0]
    for mode, runs in results.items():
        for i, r in enumerate(runs):
            if r != first:
                raise AssertionError(f"serve {arch}: {mode} run {i} {r} differs from eager run 0's {first}")
    for rid, plen, toks, _ in first["served"]:
        print(f"[serve] rid={rid} prompt_len={plen} out={list(toks)}")
    print(f"[serve] {cfg.name} full width x {cfg.n_layers} layers bf16 ({sum(p.numel() for p in lm.parameters()) / 1e9:.2f} "
          f"B params), slots {SERVE_SLOTS}, max_len {serve.MAX_LEN}: {len(first['served'])} requests per run; refills "
          f"{first['refills']}, decode steps {first['decode_steps']}, {first['prefills']} prefills; launches per run "
          f"{first['launches']}; graph and eager identical in tokens, truncation, decode steps, refills and launches "
          f"over {len(results['graph'])} + {len(results['eager'])} runs; capture ms per (rows, max_len): "
          + ", ".join(f"{key} {ms:.1f}" for key, ms in graph_eng.capture_ms.items()))
    del graph_eng, eager_eng, lm
    gc.collect()
    torch.cuda.empty_cache()
    return first


# ---------------------------------------------------------------------------
# [train]: the kernels' backwards, LM.loss gradients and training on the card
# ---------------------------------------------------------------------------

BACKWARDS = (flash_attention_backward, moe_gmm_backward, ssd_scan_backward, rglru_scan_backward)
# [train]: gradient limits of each kernel's autograd.Function against
# autograd of its plain version, of the largest |plain gradient|
TRAIN_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 10  # the reference driver's defaults, 10 steps
TRAIN_ARCHS = (LM_ARCH, SSD_ARCH)
# [train] card-against-CPU gradients: (arch, layers) at full width, batch 2, seq 128
GRAD_FAMILIES = ((LM_ARCH, 2), (MOE_ARCH, 2), (SSD_ARCH, 2), ("hubert_xlarge", 2), (RG_ARCH, 3), ("qwen2_vl_2b", 2))


def reset_backward_calls() -> None:
    for fn in BACKWARDS:
        fn.calls = 0


def backward_calls() -> dict[str, int]:
    return {fn.__name__: fn.calls for fn in BACKWARDS}


def grads_of(fn, inputs: list, douts: list) -> tuple[tuple, list]:
    """(outputs, gradients) of ``fn`` on fresh leaves copied from ``inputs``,
    against the output gradients ``douts`` (None: that output unused);
    zeros for an input the outputs do not reach."""
    inputs = [x.detach().clone().requires_grad_(True) for x in inputs]
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, d) for o, d in zip(outs, douts) if d is not None]
    grads = torch.autograd.grad([o for o, _ in pairs], inputs, [d for _, d in pairs], allow_unused=True)
    return outs, [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]


def check_function(label: str, kernel, plain, inputs: list, douts: list, tol: dict, worst: dict) -> float:
    """``kernel`` under autograd (its Function: the kernel forward, the
    explicit backward) against ``torch.autograd.grad`` of ``plain`` on the
    same inputs, on the card: each input's gradient (in the input's dtype,
    as both return it) within ``tol[its dtype]`` of the largest |plain
    gradient|, and the output's grad_fn the Function's."""
    outs, got = grads_of(kernel, inputs, douts)
    name = type(outs[0].grad_fn).__name__
    if not name.startswith("_") or not name.endswith("Backward"):
        raise AssertionError(f"[train] {label}: output grad_fn {name}, not the kernel's autograd.Function")
    _, want = grads_of(plain, inputs, douts)
    torch.cuda.synchronize()
    key = label.split(" ")[0]
    r = 0.0
    for x, g, w in zip(inputs, got, want):
        ri = float((g.float() - w.float()).abs().max() / w.float().abs().max().clamp_min(1e-30))
        if not ri <= tol[x.dtype]:
            raise AssertionError(f"[train] {label}: max |grad - plain grad| / max |plain grad| = {ri:.3g} beyond "
                                 f"{tol[x.dtype]} ({x.dtype} input {tuple(x.shape)})")
        r = max(r, ri)
    worst[key] = max(worst.get(key, 0.0), r)
    return r


def family_train_shapes() -> dict[str, list]:
    """Each kernel's shapes in a training step of every family at the
    driver's batch and sequence (8, 128), in the model's working dtypes."""
    B, S = TRAIN_BATCH, TRAIN_SEQ
    shapes: dict[str, list] = {"flash": [], "moe_gmm": [], "ssd": [], "rglru": []}
    for arch in ("qwen2_5_3b", MOE_ARCH, RG_ARCH, "qwen2_vl_2b", "hubert_xlarge"):
        cfg = get_config(arch)
        window = cfg.local_window if "local_attn" in cfg.block_types else None
        shapes["flash"].append((arch, (B, cfg.n_heads, cfg.kv_heads, S, S, cfg.head_dim_, cfg.causal, 0, window)))
    cfg = get_config(MOE_ARCH)
    C = B * moe_mod.moe_capacity(cfg, S)
    shapes["moe_gmm"] += [(f"{MOE_ARCH} wi", (cfg.n_experts, C, cfg.d_model, cfg.moe_d_ff)),
                          (f"{MOE_ARCH} wo", (cfg.n_experts, C, cfg.moe_d_ff, cfg.d_model))]
    cfg = get_config(SSD_ARCH)
    shapes["ssd"].append((SSD_ARCH, (B, cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim, S, cfg.ssm_head_dim,
                                     cfg.ssm_state)))
    shapes["rglru"].append((RG_ARCH, (B, S, get_config(RG_ARCH).lru_width)))
    return shapes


def phase_train_backward() -> dict:
    """Each LM kernel's autograd.Function on the card against autograd of its
    plain version: flash causal, windowed, non-causal, GQA, Sq != Sk with
    ``q_offset`` (f32 and bf16); moe_gmm at granite-moe's wi and wo (f32,
    bf16); both scans at T = 128, 512 and a ragged T with slow decays
    (ssd_scan with a gradient of h_final too); then every family's training
    shapes in its working dtypes."""
    t0 = time.perf_counter()
    worst: dict[str, float] = {}
    n = 0
    flash_cases = [("causal", (2, 4, 2, 64, 64, 32, True, 0, None)),
                   ("windowed", (1, 4, 1, 96, 96, 16, True, 0, 24)),
                   ("non-causal", (2, 4, 4, 40, 40, 16, False, 0, None)),
                   ("gqa", (1, 16, 2, 128, 128, 128, True, 0, None)),
                   ("sq!=sk", (2, 4, 2, 24, 64, 16, True, 40, None))]
    cfg = get_config(MOE_ARCH)
    gmm_cases = [("wi", (cfg.n_experts, 32, cfg.d_model, cfg.moe_d_ff)),
                 ("wo", (cfg.n_experts, 32, cfg.moe_d_ff, cfg.d_model))]
    dtypes = (torch.float32, torch.bfloat16)
    train = family_train_shapes()
    for dtype, (label, case) in [(d, c) for d in dtypes for c in flash_cases] + [
            (torch.bfloat16, (arch, case)) for arch, case in train["flash"]]:
        B, H, KV, Sq, Sk, D, causal, off, win = case
        q, k, v = flash_operands(B, H, KV, Sq, Sk, D, dtype, seed=Sq + Sk, bshd=True)
        do = torch.randn(q.shape, generator=torch.Generator(DEV).manual_seed(n), device=DEV).to(dtype)
        kw = dict(causal=causal, q_offset=off, window=win)
        check_function(f"flash {label} {tuple(case[:6])} {str(dtype)[6:]}", lambda q, k, v: flash_attention(q, k, v, **kw),
                       lambda q, k, v: flash_attention_plain(q, k, v, **kw), [q, k, v], [do], TRAIN_GRAD_TOL, worst)
        n += 1
    for dtype, (label, (E, C, D, F_)) in [(d, c) for d in dtypes for c in gmm_cases] + [
            (torch.bfloat16, c) for c in train["moe_gmm"]]:
        x, w = gmm_operands(E, C, D, F_, dtype, seed=D)
        dy = torch.randn((E, C, F_), generator=torch.Generator(DEV).manual_seed(n), device=DEV).to(dtype)
        check_function(f"moe_gmm {label} {(E, C, D, F_)} {str(dtype)[6:]}", moe_gmm, moe_gmm_plain, [x, w], [dy],
                       TRAIN_GRAD_TOL, worst)
        n += 1
    W = get_config(RG_ARCH).lru_width
    for label, (B, T, W_) in [("T128", (2, 128, W)), ("T512", (1, 512, W)), ("ragged", (3, 37, 45))] + train["rglru"]:
        a, b = rglru_operands(B, T, W_, torch.float32, seed=T, lo=0.9)
        dh = torch.randn(a.shape, generator=torch.Generator(DEV).manual_seed(n), device=DEV)
        check_function(f"rglru_scan {label} {(B, T, W_)}", rglru_scan, rglru_scan_plain, [a, b], [dh],
                       TRAIN_GRAD_TOL, worst)
        n += 1
    cfg = get_config(SSD_ARCH)
    H, P, N = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state
    for label, (B, H_, T, P_, N_), decay in [("T128", (2, 8, 128, P, N), 0.002), ("T512", (1, 8, 512, P, N), 0.002),
                                             ("ragged", (2, 4, 300, P, N), 0.02)] + [
            (lab, s, 0.2) for lab, s in train["ssd"]]:
        xb, a, Bm, Cm = ssd_operands(B, H_, T, P_, N_, torch.bfloat16, seed=T, decay=decay)
        g = torch.Generator(DEV).manual_seed(n)
        dy = torch.randn(xb.shape, generator=g, device=DEV)
        dh = torch.randn((B, H_, P_, N_), generator=g, device=DEV)
        # xb and a (f32): ssd_scan's own limit, its grid's 2e-4 of the
        # forward; B and C (bf16, as the model passes them): bf16's
        check_function(f"ssd_scan {label} {(B, H_, T, P_, N_)}", ssd_scan, ssd_scan_plain, [xb, a, Bm, Cm], [dy, dh],
                       {**TRAIN_GRAD_TOL, torch.float32: SSD_TOL}, worst)
        n += 1
    print(f"[train] backward of each kernel's autograd.Function on the card against torch.autograd.grad of its plain "
          f"version ({n} cases: flash causal, windowed, non-causal, GQA 16/2, Sq != Sk with q_offset, f32 and bf16; "
          f"moe_gmm granite wi/wo f32 and bf16; rglru_scan and ssd_scan T = 128, 512, ragged, slow decays, ssd with "
          f"dh_final; every family's training shapes at ({TRAIN_BATCH}, {TRAIN_SEQ}) in bf16): max |grad - plain| / "
          f"max |plain| " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (limits f32 {TRAIN_GRAD_TOL[torch.float32]:g}, bf16 {TRAIN_GRAD_TOL[torch.bfloat16]:g}, ssd_scan's "
            f"f32 xb and a {SSD_TOL:g}); {time.perf_counter() - t0:.1f} s")
    return worst


def phase_train_backward_timing() -> dict[str, dict]:
    """Each backward at its main model's training shape, ms: the explicit
    ``*_backward`` alone; the kernel forward + backward through its
    Function and the plain version's forward + autograd backward; the
    library, timed only: SDPA forward + backward (flash) against the
    kernel's forward + backward, two ``torch.bmm`` (``moe_gmm``'s dx and
    dw) against the backward alone.  Each as device time in a CUDA graph
    (the autograd backward captured with its forward) and, for the forward
    + backward pairs, launched from Python (CUDA events, host cost
    included); the bound of the backward's own work."""
    out = {}
    train = family_train_shapes()

    def both(name, fn, inputs, douts, iters):
        call = lambda: grads_of(fn, inputs, douts)  # noqa: E731
        return {f"{name}_ms": graph_ms(call, iters), f"{name}_eager_ms": eager_ms(call, iters)}

    B, H, KV, Sq, Sk, D, causal, _, _ = train["flash"][0][1]
    q, k, v = flash_operands(B, H, KV, Sq, Sk, D, torch.bfloat16, seed=1, bshd=True)
    do = torch.randn(q.shape, device=DEV).to(torch.bfloat16)
    pairs = Sq * (Sq + 1) // 2
    sdpa = both("library", lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
                [q, k, v], [do], 20)
    out["flash_attention"] = {
        "shape": [B, H, KV, Sq, D],
        "ms": graph_ms(lambda: flash_attention_backward(q, k, v, do, causal=True), 20),
        **both("fwd_bwd", lambda q, k, v: flash_attention(q, k, v, causal=True), [q, k, v], [do], 20),
        **both("plain", lambda q, k, v: flash_attention_plain(q, k, v, causal=True), [q, k, v], [do], 20),
        **sdpa,
        # q, k, v, dO read and dq, dk, dv written once (bf16); five products
        # (S, dP, dQ, dK, dV) of 2 D flops per kept (query, key) pair
        "bound": bound(2 * (3 * B * H * Sq * D + 2 * B * KV * Sk * D + 2 * B * KV * Sk * D),
                       5 * 2 * B * H * pairs * D, BF16_FLOPS_S),
    }
    (_, (E, C, D, F_)) = train["moe_gmm"][0]
    x, w = gmm_operands(E, C, D, F_, torch.bfloat16, seed=3)
    dy = torch.randn((E, C, F_), device=DEV).to(torch.bfloat16)
    wt, xt = w.transpose(1, 2), x.transpose(1, 2)
    out["moe_gmm"] = {
        "shape": [E, C, D, F_],
        "ms": graph_ms(lambda: moe_gmm_backward(x, w, dy), 50),
        **both("fwd_bwd", moe_gmm, [x, w], [dy], 50),
        **both("plain", moe_gmm_plain, [x, w], [dy], 50),
        "library_ms": graph_ms(lambda: (torch.bmm(dy, wt), torch.bmm(xt, dy)), 50),
        # x, w, dy read, dx, dw written (bf16); two GEMMs of 2 E C D F flops
        "bound": bound(2 * (2 * E * C * D + 2 * E * D * F_ + E * C * F_), 2 * 2 * E * C * D * F_, BF16_FLOPS_S),
    }
    (_, (B, H, T, P, N)) = train["ssd"][0]
    xb, a, Bm, Cm = ssd_operands(B, H, T, P, N, torch.bfloat16, seed=5)
    dy, dh = torch.randn(xb.shape, device=DEV), torch.randn((B, H, P, N), device=DEV)
    out["ssd_scan"] = {
        "shape": [B, H, T, P, N],
        "ms": graph_ms(lambda: ssd_scan_backward(xb, a, Bm, Cm, dy, dh), 20),
        **both("fwd_bwd", ssd_scan, [xb, a, Bm, Cm], [dy, dh], 20),
        **both("plain", ssd_scan_plain, [xb, a, Bm, Cm], [dy, dh], 20),
        "library_ms": None,
        # xb, a, dy, dh read and dxb, da in f32, B, C and dB, dC in bf16,
        # each once; the recurrence's adjoint at 16 P N flops per token and
        # head (h recomputed, dh carried, dxb, dB, dC, da), fp32
        "bound": bound(4 * (2 * 2 * B * H * T * P + 2 * B * H * T + B * H * P * N) + 2 * 4 * B * T * N,
                       16 * B * H * T * P * N, FP32_FLOPS_S),
    }
    (_, (B, T, W)) = train["rglru"][0]
    a, b = rglru_operands(B, T, W, torch.float32, seed=7, lo=0.9)
    dh = torch.randn(a.shape, device=DEV)
    h = rglru_scan(a, b)
    out["rglru_scan"] = {
        "shape": [B, T, W],
        "ms": graph_ms(lambda: rglru_scan_backward(a, h, dh), 50),
        **both("fwd_bwd", rglru_scan, [a, b], [dh], 50),
        **both("plain", rglru_scan_plain, [a, b], [dh], 2),
        "library_ms": None,
        # a, h, dh read and da, db written once, f32; 4 flops an element
        "bound": bound(20 * B * T * W, 4 * B * T * W, FP32_FLOPS_S),
    }
    print(f"[train] backward times at each kernel's training shape (batch {TRAIN_BATCH}, seq {TRAIN_SEQ}; flash "
          f"qwen2.5-3b bf16 causal, moe_gmm granite-moe wi bf16, ssd_scan mamba2-1.3b, rglru_scan recurrentgemma-2b), "
          f"ms: backward = the explicit *_backward alone (device, CUDA graph); fwd+bwd = the kernel forward and that "
          f"backward through its Function, plain = the plain version's forward + autograd backward, library = SDPA "
          f"forward + backward (flash) or two torch.bmm (moe_gmm dx, dw), timed only; each of those as device ms "
          f"in a CUDA graph / ms launched from Python (CUDA events); bound = the backward's own bytes or operations")

    def pair(row, name):
        if row.get(f"{name}_ms") is None:
            return "none"
        eager = row.get(f"{name}_eager_ms")
        return f"{row[f'{name}_ms']:.5f}" + ("" if eager is None else f" / {eager:.5f}")

    for name, row in out.items():
        row["bound_ms"], row["bound_by"] = row.pop("bound")
        print(f"    {name:15s} {str(row['shape']):24s} backward {row['ms']:.5f}  fwd+bwd {pair(row, 'fwd_bwd')}  "
              f"plain {pair(row, 'plain')}  library {pair(row, 'library')}  bound {row['bound_ms']:.6f} "
              f"({row['bound_by']})")
    return out


def grad_batch(cfg, B: int, S: int, seed: int) -> dict:
    """A CPU batch: tokens, or frame/patch embeddings for a stub frontend
    (with M-RoPE, three distinct position streams), and labels."""
    rng = np.random.default_rng(seed)
    if cfg.frontend_stub:
        batch = {"embeds": torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))}
        if cfg.pos_kind == "mrope":
            batch["positions"] = torch.from_numpy(rng.integers(0, 4 * S, (3, B, S)))
    else:
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))}
    batch["labels"] = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    return batch


def loss_and_grads(lm, batch: dict) -> tuple[float, dict[str, torch.Tensor | None]]:
    params = dict(lm.named_parameters())
    lm.requires_grad_(True)
    loss = lm.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    lm.requires_grad_(False)
    return float(loss.detach()), dict(zip(params, grads))


@torch.no_grad()
def unsaturate_attention(lm) -> float:
    """Scale every attention layer's wq and wk in place so that, for a
    unit-RMS input, q and k have unit entries and the logits q.k/sqrt(hd)
    are about N(0, 1).  At the reference init (std 1/sqrt(layers), the
    fan-in taken from the stacked layer axis) the logits at full width are
    in the hundreds, the softmax is one-hot, and the score gradient dS is
    rounding; here it is not.  Returns the scale applied to wq."""
    d = lm.cfg.d_model
    applied = 1.0
    for name, p in lm.named_parameters():
        if name.endswith(("attn.wq", "attn.wk")):
            s = 1.0 / (float(p.std()) * d ** 0.5)
            p.mul_(s)
            if name.endswith("wq"):
                applied = s
    return applied


def phase_train_grads(arch: str, n_layers: int, unsaturated: bool = False) -> dict:
    """``LM.loss`` and every parameter's gradient of ``arch`` at full width,
    ``n_layers`` layers, batch 2, seq 128: the module in fp32 on the card
    (the kernels' Functions) and on the CPU (plain versions), each against
    the same weights in a float64 module on the CPU (``dtype="float64"``:
    the port computes in float64 where its inputs are; the truth both
    round from).  Per leaf, of its largest |float64 gradient|: the card
    within 1e-3, or within 3x the CPU's own fp32 gap where that is larger
    (at the reference init some leaves' gradients cancel so far that two
    correct fp32 evaluations differ by more than 1e-3: measured 1.5e-2
    for granite-moe's wk and 8.9e-4 for qwen's embedding, CPU fp32 against
    float64).  With ``unsaturated`` (wq and wk scaled by
    :func:`unsaturate_attention`, so the score gradient carries signal) the
    card is held to the CPU within a flat 1e-3 of each leaf's largest |CPU
    gradient|.  Every gradient nonzero on the card wherever the CPU's is;
    the loss within 1e-5; the card's kernel launches and backward calls
    exactly those of one step at remat "none".  MoE routing in the float64
    run and on the card replays the CPU fp32 run's (a near-tie would flip
    an expert)."""
    cfg = get_config(arch).replace(n_layers=n_layers, dtype="float32", remat="none")
    t0 = time.perf_counter()
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    if "rglru" in cfg.block_types:
        draw_rglru_decays(cpu, seed=1)
    wq_scale = unsaturate_attention(cpu) if unsaturated else None
    gpu = copy.deepcopy(cpu).to(DEV)
    # the float64 module, built by its config; its float32-declared leaves
    # (the norms) made float64 too, then every weight copied from the cpu's
    cpu64 = LM(cfg.replace(dtype="float64"), device="cpu").double()
    cpu64.load_state_dict(cpu.state_dict())
    batch = grad_batch(cfg, 2, TRAIN_SEQ, seed=0)
    routes: list = []
    with routing(record=routes):
        want_loss, want = loss_and_grads(cpu, batch)
    with routing(replay=routes) if cfg.is_moe else contextlib.nullcontext():
        truth_loss, truth = loss_and_grads(cpu64, {k: v.double() if v.is_floating_point() else v
                                                   for k, v in batch.items()})
    del cpu64
    routes = [r.to(DEV) for r in routes]
    reset_counts()
    reset_backward_calls()
    with routing(replay=routes) if cfg.is_moe else contextlib.nullcontext():
        got_loss, got = loss_and_grads(gpu, {k: v.to(DEV) for k, v in batch.items()})
    torch.cuda.synchronize()
    counts, calls = read_counts(), backward_calls()
    want_l, want_c = expected_train_counts(cfg, 1)
    check_counts(f"train grads {arch}", counts, want_l)
    if calls != want_c:
        raise AssertionError(f"train grads {arch}: backward calls {calls}, expected {want_c}")
    unreached, worst, worst_cpu, gap = [], (0.0, ""), 0.0, (0.0, "")
    for name, g_cpu in want.items():
        g_gpu, g64 = got[name], truth[name]
        if g_cpu is None or not bool(g_cpu.any()):
            unreached.append(name)
            if g_gpu is not None and bool(g_gpu.any()):
                raise AssertionError(f"[train] {arch} {name}: a gradient on the card where the CPU has none")
            continue
        if g_gpu is None or not bool(g_gpu.any()):
            raise AssertionError(f"[train] {arch} {name}: no gradient on the card (the CPU's max |g| "
                                 f"{float(g_cpu.abs().max()):.3e})")
        scale = float(g64.abs().max())
        r_cpu = float((g_cpu.double() - g64).abs().max()) / scale
        r = float((g_gpu.cpu().double() - g64).abs().max()) / scale
        r_gap = float((g_gpu.cpu() - g_cpu).abs().max() / g_cpu.abs().max())
        worst, worst_cpu, gap = max(worst, (r, name)), max(worst_cpu, r_cpu), max(gap, (r_gap, name))
        if unsaturated:
            if r_gap > 1e-3:
                raise AssertionError(f"[train] {arch} unsaturated {name}: card vs cpu gradient gap {r_gap:.3g} of "
                                     f"its max beyond 1e-3 (card vs float64 {r:.3g}, cpu vs float64 {r_cpu:.3g})")
        elif r > max(1e-3, 3 * r_cpu):
            raise AssertionError(f"[train] {arch} {name}: card vs float64 gradient gap {r:.3g} of its max beyond "
                                 f"{max(1e-3, 3 * r_cpu):.3g} (the cpu's fp32 gap {r_cpu:.3g})")
    if abs(got_loss - truth_loss) > 1e-5 * abs(truth_loss):
        raise AssertionError(f"[train] {arch}: loss {got_loss} on the card vs {truth_loss} in float64")
    limit = ("card vs cpu within a flat 1e-3" if unsaturated else "card vs float64 within max(1e-3, 3x the cpu's)")
    print(f"[train] {cfg.name} full width x {n_layers} layers fp32, batch 2 x {TRAIN_SEQ}"
          + (" (embeds" + (", M-RoPE positions" if cfg.pos_kind == "mrope" else "") + ")" if cfg.frontend_stub else "")
          + (", MoE routing replayed from the cpu fp32 run" if cfg.is_moe else "")
          + (f", unsaturated attention (wq, wk scaled for N(0, 1) logits; wq x {wq_scale:.3e})" if unsaturated else "")
          + f": loss card {got_loss:.6f}, cpu {want_loss:.6f}, float64 {truth_loss:.6f}; "
          f"{len(want) - len(unreached)} parameters, every gradient nonzero on the card; per leaf, of its max "
          f"|gradient|: card vs float64 at most {worst[0]:.3e} ({worst[1]}), cpu fp32 vs float64 at most "
          f"{worst_cpu:.3e}, card vs cpu at most {gap[0]:.3e} ({gap[1]}); held: {limit}"
          + (f"; not reached by the loss on either: {unreached}" if unreached else "")
          + f"; kernel launches {counts}, backward calls {calls} (exact); {time.perf_counter() - t0:.1f} s")
    del cpu, gpu
    gc.collect()
    torch.cuda.empty_cache()
    return {"card_vs_f64": worst[0], "cpu_vs_f64": worst_cpu, "card_vs_cpu": gap[0], "launches": counts,
            "backward_calls": calls}


def expected_train_counts(cfg, steps: int) -> tuple[dict[str, int], dict[str, int]]:
    """(kernel launches, backward calls) of ``steps`` train steps: each
    kernel's forward once per layer, twice under remat (the backward
    recomputes the layer), its backward once per layer; moe_gmm three
    forwards per MoE layer and two launches per backward (dx, dw),
    rglru_scan one launch per backward."""
    n = layer_kinds(cfg)
    f = 2 if cfg.remat != "none" else 1
    launches = with_zeros({"flash_attention": f * n["attn"] * steps, "moe_gmm": (3 * f + 6) * n["moe"] * steps,
                           "ssd_scan": f * n["ssd"] * steps, "rglru_scan": (f + 1) * n["rglru"] * steps})
    calls = {"flash_attention_backward": n["attn"] * steps, "moe_gmm_backward": 3 * n["moe"] * steps,
             "ssd_scan_backward": n["ssd"] * steps, "rglru_scan_backward": n["rglru"] * steps}
    return launches, calls


def profiled_train_step(model, opt_state, opt_cfg, batch: dict) -> dict:
    """One train step of ``model`` as the port's ``make_train_step`` takes it
    (``LM.loss``, ``torch.autograd.grad``, ``adamw_update``), with a
    ``torch.cuda.synchronize()`` after each phase, under ``torch.profiler``:
    device busy and idle, and device ms and top device ops of each phase."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.training.optimizer import adamw_update

    params = dict(model.named_parameters())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function("phase.forward"):
            loss = model.loss(batch)
            torch.cuda.synchronize()
        with record_function("phase.backward"):
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            torch.cuda.synchronize()
        with record_function("phase.optimizer"):
            adamw_update(dict(zip(params, grads)), opt_state, params, opt_cfg)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = list(prof.events())
    ranges = {e.name[6:]: (e.time_range.start, e.time_range.end) for e in events
              if e.name.startswith("phase.") and e.device_type == DeviceType.CPU}
    by_phase: dict[str, dict[str, list[float]]] = {p: {} for p in ranges}
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.name.startswith("phase."):
            phase = next((p for p, (s, t) in ranges.items() if s <= e.time_range.start < t), "outside")
            by_phase.setdefault(phase, {}).setdefault(kernel_label(e.name), []).append(e.time_range.elapsed_us())
    busy = {p: sum(sum(v) for v in ops.values()) / 1e3 for p, ops in by_phase.items()}
    phase_ms = {p: (t - s) / 1e3 for p, (s, t) in ranges.items()}
    total_busy = sum(busy.values())
    if not total_busy:
        return {"wall_ms": wall_ms, "busy_ms": None, "lines": [f"wall {wall_ms:.1f} ms; device time not measured "
                                                                "(the profiler recorded no CUDA events)"]}
    lines = [f"wall {wall_ms:.1f} ms, device busy {total_busy:.1f} ms, idle {100 * (1 - total_busy / wall_ms):.1f} %"]
    for p, ops in by_phase.items():
        top = sorted(ops.items(), key=lambda kv: -sum(kv[1]))[:5]
        lines.append(f"{p}: {phase_ms.get(p, float('nan')):.1f} ms host, {busy[p]:.1f} ms device in "
                     f"{sum(len(v) for v in ops.values())} ops; top " +
                     ", ".join(f"{name} x{len(us)} {sum(us) / 1e3:.2f}" for name, us in top))
    return {"wall_ms": wall_ms, "busy_ms": total_busy, "phase_ms": phase_ms, "phase_busy_ms": busy, "lines": lines}


def phase_train_full(arch: str) -> dict:
    """``repro_torch.launch.train.main`` on ``arch`` at full width and depth,
    bf16, the reference's defaults (batch 8, seq 128, remat "full"), 10
    steps: ms per step (median of steps 3-10), tokens/s, MFU (6 N tokens
    per step over 989 TFLOP/s), peak device memory against 16 bytes per
    parameter, exact launches and backward calls per step, first and last
    loss and grad norm; then a profiled step of a second model built the
    same way, split into forward, backward and optimizer."""
    from repro_torch.launch import train as train_cli
    from repro_torch.training import OptConfig, adamw_init, make_train_step

    cfg = get_config(arch)
    stamps, norms = [], []

    def on_step(step, metrics):
        stamps.append(time.perf_counter())
        norms.append(float(metrics["grad_norm"]))

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    reset_backward_calls()
    res = train_cli.main(["--arch", arch, "--steps", str(TRAIN_STEPS), "--log-every", "5"], on_step=on_step)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts, calls = read_counts(), backward_calls()
    want_l, want_c = expected_train_counts(cfg, TRAIN_STEPS)
    check_counts(f"train {arch}", counts, want_l)
    if calls != want_c:
        raise AssertionError(f"train {arch}: backward calls {calls}, expected {want_c}")
    if res["final_step"] != TRAIN_STEPS or not all(np.isfinite([res["first_loss"], res["final_loss"]] + norms)):
        raise AssertionError(f"train {arch}: {res}, grad norms {norms}")
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]  # steps 2..10
    med = float(np.median(step_ms[1:]))  # steps 3..10
    n_params = cfg.n_params()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = 6 * n_params * tokens / (med / 1e3) / BF16_FLOPS_S
    reckoned = 16 * n_params / 1e9
    print(f"[train] {cfg.name} full width x {cfg.n_layers} layers bf16 ({n_params / 1e9:.3f} B params), batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, remat {cfg.remat}, {TRAIN_STEPS} steps through repro_torch.launch.train: "
          f"ms per step median of steps 3-{TRAIN_STEPS} {med:.1f} (steps 2-{TRAIN_STEPS}: "
          f"{', '.join(f'{t:.1f}' for t in step_ms)}), {tokens / med * 1e3:.0f} tokens/s, MFU {100 * mfu:.2f} % "
          f"(6 N tokens / step s / 989 TFLOP/s); peak allocated {peak_gb:.2f} GB against 16 B per parameter "
          f"{reckoned:.2f} GB; launches per step {({k: v // TRAIN_STEPS for k, v in counts.items()})}, backward "
          f"calls per step {({k: v // TRAIN_STEPS for k, v in calls.items()})} (exact: remat full runs each forward "
          f"twice); loss first {res['first_loss']:.4f} last {res['final_loss']:.4f}, grad norm first {norms[0]:.3f} "
          f"last {norms[-1]:.3f}")
    gc.collect()
    torch.cuda.empty_cache()
    # a profiled step of the same model, built the same way
    model = LM(cfg, device=DEV, generator=torch.Generator(device=DEV).manual_seed(0))
    opt_cfg = OptConfig(warmup_steps=1, total_steps=TRAIN_STEPS)
    step = make_train_step(model, opt_cfg)
    opt = adamw_init(dict(model.named_parameters()))
    batch = {k: v.to(DEV) for k, v in grad_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=1).items()}
    for _ in range(2):
        opt, m = step(opt, batch)
    float(m["loss"])
    prof = profiled_train_step(model, opt, opt_cfg, batch)
    print(f"[train] {cfg.name} one profiled step (torch.profiler, a synchronize after each phase): "
          + "; ".join(prof["lines"]))
    del model, opt, step, m
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": counts, "step_ms": med, "tokens_s": tokens / med * 1e3, "mfu": mfu, "peak_gb": peak_gb, "reckoned_gb": reckoned,
            "launches_per_step": {k: v // TRAIN_STEPS for k, v in counts.items()},
            "backward_calls_per_step": {k: v // TRAIN_STEPS for k, v in calls.items()},
            "first_loss": res["first_loss"], "final_loss": res["final_loss"], "grad_norm": norms,
            "profile": {k: v for k, v in prof.items() if k != "lines"}}


def phase_train_fixed_batch() -> dict:
    """``test_quickstart_flow`` on the card at full width: qwen2.5-3b, bf16,
    8 steps of ``make_train_step`` on one fixed batch (4, 32) at lr 1e-3
    (warm-up 2, 20 total): the loss must fall."""
    from repro_torch.training import OptConfig, adamw_init, make_train_step

    cfg = get_config(LM_ARCH)
    model = LM(cfg, device=DEV, generator=torch.Generator(device=DEV).manual_seed(0))
    step = make_train_step(model, OptConfig(lr=1e-3, warmup_steps=2, total_steps=20))
    opt = adamw_init(dict(model.named_parameters()))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32))).to(DEV) for k in ("tokens", "labels")}
    losses = []
    for _ in range(8):
        opt, m = step(opt, batch)
        losses.append(float(m["loss"]))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train fixed batch {cfg.name}: loss did not fall: {losses}")
    print(f"[train] {cfg.name} full width bf16, 8 steps on one fixed batch (4, 32) at lr 1e-3: loss "
          f"{', '.join(f'{x:.4f}' for x in losses)} (falls)")
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses}


def phase_train_resume() -> dict:
    """The train driver on the card on mamba2's smoke config: 6 steps with a
    checkpoint every 3, and the same run stopped after step 4 through its
    ``PreemptionGuard`` (checkpointing there) and resumed: steps 4-6 give
    the uninterrupted run's losses.  Then the checkpoint's parameters,
    restored through the port's copy of the reference format, load into a
    new module through ``params_from_jax`` equal to the trained module's."""
    import shutil
    import tempfile

    from repro_torch.configs import get_smoke
    from repro_torch.launch import train as train_cli
    from repro_torch.models import params_from_jax, params_to_jax
    from repro_torch.training.checkpoint import latest_step, restore_checkpoint
    from repro_torch.training.fault_tolerance import PreemptionGuard
    from repro_torch.training.train_loop import state_like

    build = os.path.join(os.path.dirname(CHECKOUT_SRC), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="train_resume_", dir=build)
    argv = ["--arch", SSD_ARCH, "--smoke", "--steps", "6", "--batch", "2", "--seq", "32", "--ckpt-every", "3",
            "--log-every", "100"]

    def losses_of(args, guard=None, stop_at=None):
        out = {}

        def on_step(step, metrics):
            out[step] = float(metrics["loss"])
            if step == stop_at:
                guard.request_stop()

        train_cli.main(args, guard=guard, on_step=on_step)
        return out

    try:
        whole = losses_of(argv + ["--ckpt-dir", os.path.join(root, "whole")])
        cut = os.path.join(root, "cut")
        first = losses_of(argv + ["--ckpt-dir", cut], guard=PreemptionGuard(signals=()), stop_at=4)
        if latest_step(cut) != 4:
            raise AssertionError(f"train resume: the stopped run checkpointed step {latest_step(cut)}, not 4")
        rest = losses_of(argv + ["--ckpt-dir", cut])
        got = {**first, **rest}
        gap = max(abs(got[s] - whole[s]) for s in range(1, 7))
        if sorted(got) != list(range(1, 7)) or gap > 1e-6 * max(abs(v) for v in whole.values()):
            raise AssertionError(f"train resume: losses {got} vs uninterrupted {whole}")
        # the resumed run's last checkpoint, through the reference format, into params_from_jax and back
        lm = LM(get_smoke(SSD_ARCH), device=DEV, generator=torch.Generator(device=DEV).manual_seed(5))
        tree = restore_checkpoint(cut, 6, state_like(lm))
        want = _numpy_tree(tree["params"])
        back = params_to_jax(params_from_jax(lm, want))
        for path, leaf in _leaves(want):
            if not np.array_equal(_at(back, path), leaf):
                raise AssertionError(f"train resume: {'/'.join(path)} through params_from_jax / params_to_jax differs")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[train] {SSD_ARCH} smoke on the card, 6 steps, checkpoint every 3: stopped after step 4 by its "
          f"PreemptionGuard, resumed from the step-4 checkpoint; losses steps 1-6 "
          f"{', '.join(f'{got[s]:.6f}' for s in range(1, 7))} vs uninterrupted "
          f"{', '.join(f'{whole[s]:.6f}' for s in range(1, 7))} (max gap {gap:.3e}, "
          f"{'bitwise equal' if gap == 0 else 'within 1e-6'}); the resumed run's step-6 checkpoint restores through "
          f"the reference format into params_from_jax, and params_to_jax gives back every leaf exactly")
    return {"gap": gap}


def _leaves(tree, prefix=()):
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k, v in tree.items():
        yield from _leaves(v, (*prefix, k))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.float().numpy() if tree.dtype == torch.bfloat16 else tree.numpy()


def phase_train() -> dict:
    """[train]: the backwards, their times, six families' gradients, full-width
    training of qwen2.5-3b and mamba2-1.3b through the driver, the fixed-batch
    check and checkpoint/resume.  ``launches_full`` sums each kernel's
    launches over the full-width runs (the main path), ``launches_grads``
    over the gradient checks."""
    out: dict = {"backward": phase_train_backward(), "timing": phase_train_backward_timing()}
    out["grads"] = {arch: phase_train_grads(arch, n) for arch, n in GRAD_FAMILIES}
    out["grads"][f"{LM_ARCH}/unsaturated"] = phase_train_grads(LM_ARCH, 2, unsaturated=True)
    out["full"] = {arch: phase_train_full(arch) for arch in TRAIN_ARCHS}
    out["fixed"] = phase_train_fixed_batch()
    out["resume"] = phase_train_resume()
    for run in ("full", "grads"):
        out[f"launches_{run}"] = {k: sum(r["launches"].get(k, 0) for r in out[run].values()) for k in REPLACES}
    return out


# [ops]: each scheduled wrapper at the reference table's full shapes or its
# served shape, its plain version's tolerance on the card
OPS_MM = (4096, 6144, 6144)  # (M, K, N), int8
OPS_FLASH = (8, 16, 4096, 128)  # (B, H = KV, S, D), bf16, causal
OPS_RGLRU = (8, 4096, 2560)  # (B, T, W), f32
OPS_MM_ROWS = 8  # rows of A per plain block: the plain version broadcasts (rows, K, N) int32


def host_call_ms(fn, cold: bool, runs: int = 5) -> float:
    """Median host ms from call to return (the launch enqueued, not waited
    for), the DSE's search cache cleared before each call when ``cold``."""
    from repro_torch.core import clear_schedule_cache

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        if cold:
            clear_schedule_cache()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return float(np.median(times))


def ops_cases() -> list[dict]:
    """(kernel, scheduled call, bare kernel call, plain call, check) on the
    card at [ops]' shapes."""
    rng = np.random.default_rng(22)
    M, K, N = OPS_MM
    a = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8)).to(DEV)
    w = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8)).to(DEV)
    mult = torch.from_numpy(rng.integers(1, 8, (N,)).astype(np.int32)).to(DEV)
    bias = torch.from_numpy(rng.integers(-1000, 1000, (N,)).astype(np.int32)).to(DEV)

    def mm_plain():
        return torch.cat([matmul_requant_plain(a[r:r + OPS_MM_ROWS], w, mult, bias, shift=16)
                          for r in range(0, M, OPS_MM_ROWS)])

    B, H, S, D = OPS_FLASH
    q, k, v = flash_operands(B, H, H, S, S, D, torch.bfloat16, seed=22)
    E, C, Dm, F = granite_gmm_shapes()[0][1:]
    x, wg = gmm_operands(E, C, Dm, F, torch.bfloat16, seed=22)
    cfg = get_config(SSD_ARCH)
    Hs, P, Ns = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state
    xb, sa, Bm, Cm = ssd_operands(1, Hs, LONG_PROMPT, P, Ns, torch.bfloat16, seed=22)
    ra, rb = rglru_operands(*OPS_RGLRU, torch.float32, seed=22)
    return [
        {"kernel": "matmul_requant", "shape": [M, K, N], "tol": 0,
         "scheduled": lambda: ops.scheduled_matmul_requant(a, w, mult, bias, shift=16),
         "bare": lambda: matmul_requant(a, w, mult, bias, shift=16), "plain": mm_plain},
        {"kernel": "flash_attention", "shape": [B, H, H, S, D], "tol": FLASH_TOL[torch.bfloat16],
         "scheduled": lambda: ops.scheduled_flash_attention(q, k, v, causal=True),
         "bare": lambda: flash_attention(q, k, v, causal=True),
         "plain": lambda: flash_attention_plain(q, k, v, causal=True)},
        {"kernel": "moe_gmm", "shape": [E, C, Dm, F], "tol": GMM_TOL[torch.bfloat16],
         "scheduled": lambda: ops.scheduled_moe_gmm(x, wg), "bare": lambda: moe_gmm(x, wg),
         "plain": lambda: moe_gmm_plain(x, wg)},
        {"kernel": "ssd_scan", "shape": [1, Hs, LONG_PROMPT, P, Ns], "tol": SSD_TOL,
         "scheduled": lambda: ops.scheduled_ssd_scan(xb, sa, Bm, Cm), "bare": lambda: ssd_scan(xb, sa, Bm, Cm),
         "plain": lambda: ssd_scan_plain(xb, sa, Bm, Cm)},
        {"kernel": "rglru_scan", "shape": list(OPS_RGLRU), "tol": RGLRU_TOL,
         "scheduled": lambda: ops.scheduled_rglru_scan(ra, rb), "bare": lambda: rglru_scan(ra, rb),
         "plain": lambda: rglru_scan_plain(ra, rb)},
    ]


def phase_ops() -> dict:
    """[ops]: the h100 schedule table, then each scheduled wrapper launched
    once on the card (counted), held against its plain version, and timed
    on the host cold and cached."""
    table = ops.kernel_schedule_table()
    print("[ops] kernel_schedule_table() on the h100 target (LOMA DSE; blocks snapped to divisors; the knob "
          "the schedule sets, None where the kernel keeps its own tiling):")
    for r in table:
        print(f"    {r['kernel']:16s} {r['module']:12s} dims {r['dims']} block {r['block']} order "
              f"{' > '.join(r['grid_order'])} predicted {r['predicted_cycles']:.4g} cycles knob {r['knob']}")
    if len(table) < 5 or any(not r["predicted_cycles"] > 0 for r in table):
        raise AssertionError(f"[ops] schedule table: {len(table)} rows, cycles {[r['predicted_cycles'] for r in table]}")
    out: dict = {"table": table, "kernels": {}}
    for case in ops_cases():
        name = case["kernel"]
        reset_counts()
        got = case["scheduled"]()
        torch.cuda.synchronize()
        counts = read_counts()
        want_counts = with_zeros({name: 1})
        check_counts(f"[ops] scheduled_{name}", counts, want_counts)
        want = case["plain"]()
        pairs = list(zip(("y", "h_final"), got, want)) if name == "ssd_scan" else [("out", got, want)]
        errs = {}
        for what, g, wv in pairs:
            if g.shape != wv.shape or not torch.isfinite(g.float()).all():
                raise AssertionError(f"[ops] {name} {what}: shape {tuple(g.shape)} vs {tuple(wv.shape)} or not finite")
            diff = (g.float() - wv.float()).abs()
            tol = case["tol"]
            if bool((diff > tol + tol * wv.float().abs()).any()):
                raise AssertionError(f"[ops] {name} {what}: max |kernel - plain| {float(diff.max()):.3g} beyond "
                                     f"atol = rtol = {tol}")
            errs[what] = float(diff.max())
        del got, want
        row = {"shape": case["shape"], "launches": counts[name], "max_abs_err": max(errs.values()),
               "host_ms_cold": host_call_ms(case["scheduled"], cold=True),
               "host_ms_cached": host_call_ms(case["scheduled"], cold=False),
               "host_ms_bare": host_call_ms(case["bare"], cold=False)}
        out["kernels"][name] = row
        torch.cuda.empty_cache()
    print("[ops] each scheduled wrapper once on the card (launch counters reset just before, read just after: "
          "one launch of its kernel, none of another), against its plain version; host ms per call, median of 5 "
          "(call to return, the launch enqueued): cold = the DSE's search cache cleared first, cached = "
          "repeated, bare = the kernel wrapper without the DSE")
    print(f"    {'kernel':16s} {'shape':28s} {'launches':>8s} {'max|k-plain|':>12s} {'cold ms':>9s} "
          f"{'cached ms':>9s} {'bare ms':>9s}")
    for name, r in out["kernels"].items():
        print(f"    {name:16s} {str(tuple(r['shape'])):28s} {r['launches']:>8d} {r['max_abs_err']:>12.3e} "
              f"{r['host_ms_cold']:>9.3f} {r['host_ms_cached']:>9.4f} {r['host_ms_bare']:>9.4f}")
    # the one knob the DSE sets: ssd_scan's heads per output block, against
    # the kernel's own rule, device ms in a CUDA graph
    cfg = get_config(SSD_ARCH)
    Hs, P, Ns = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state
    xb, sa, Bm, Cm = ssd_operands(1, Hs, LONG_PROMPT, P, Ns, torch.bfloat16, seed=22)
    mod = importlib.import_module("repro_torch.kernels.ssd_scan")
    rule = mod.heads_per_block(1, Hs, mod._lib().ssd_scan_chunks(LONG_PROMPT), mod._sms(DEV))
    dse = ops._heads_per_block(ops._scan_schedule("ssd", 4, Hs, LONG_PROMPT, P * Ns), Hs)
    knob = {"dse_heads": dse, "rule_heads": rule,
            "dse_ms": graph_ms(lambda: ops.scheduled_ssd_scan(xb, sa, Bm, Cm), iters=50),
            "rule_ms": graph_ms(lambda: ssd_scan(xb, sa, Bm, Cm), iters=50)}
    print(f"[ops] ssd_scan (1, {LONG_PROMPT}) at {SSD_ARCH}'s width, device ms per call in a CUDA graph: the DSE's "
          f"{dse} heads per output block {knob['dse_ms']:.5f}, the kernel's rule's {rule} {knob['rule_ms']:.5f}")
    out["ssd_heads"] = knob
    return out


def phase_shard() -> dict:
    """[shard]: qwen2.5-3b placed on a 1 x 1 mesh on the card by the port's
    sharding rules, bitwise; constrain an identity; the autoshard choices of
    every applicable cell on both production meshes."""
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.configs import ALL_ARCHS, SHAPES, cell_applicable
    from repro_torch.distributed import ShardingRules, constrain, param_shardings, use_rules
    from repro_torch.distributed.autoshard import best_rules
    from repro_torch.launch.mesh import AbstractMesh, make_local_mesh, production_shape
    from repro_torch.models.layers import map_specs

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = make_local_mesh()
        cfg = get_config(LM_ARCH)
        cell = SHAPES["train_4k"]
        name, rules, _ = best_rules(cfg, mesh, global_batch=cell.global_batch, seq=cell.seq_len, kind=cell.kind)
        lm = LM(cfg, generator=torch.Generator(device=DEV).manual_seed(0))
        placements = dict(_leaves(param_shardings(map_specs(lambda sp: sp.axes, lm.param_specs()), rules)))
        tree = dict(_leaves(lm.reference_tree(dict(lm.named_parameters()))))
        placed = nbytes = 0
        for path, full in tree.items():
            dt = distribute_tensor(full, mesh, placements[path])
            if not isinstance(dt, DTensor) or tuple(dt.placements) != placements[path] \
                    or not torch.equal(dt.to_local(), full):
                raise AssertionError(f"[shard] {path}: placed {dt.placements} is not the parameter bitwise")
            placed += 1
            nbytes += full.numel() * full.element_size()
            del dt
        x = torch.randn(4, 128, cfg.d_model, device=DEV, dtype=torch.bfloat16)
        with use_rules(ShardingRules(mesh, rules.table)):
            y = constrain(x, "batch", "seq", "embed")
        torch.cuda.synchronize()
        if not isinstance(y, DTensor) or not torch.equal(y.full_tensor(), x):
            raise AssertionError("[shard] constrain on the card changed the values")
        print(f"[shard] {LM_ARCH} at full width and depth on a 1 x 1 DeviceMesh (NCCL, {mesh.device_type}): "
              f"{placed} stacked leaves, {nbytes / 2**30:.2f} GiB, placed by param_shardings under "
              f"best_rules' '{name}' ({rules.table}), each local tensor bitwise the parameter; constrain "
              f"(batch, seq, embed) an identity on values")
        del lm, tree
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    chosen: dict = {}
    for multi in (False, True):
        amesh = AbstractMesh(*production_shape(multi))
        for arch in ALL_ARCHS:
            for shape, c in SHAPES.items():
                if cell_applicable(get_config(arch), shape)[0]:
                    chosen[f"{arch}/{shape}/{'multi' if multi else 'single'}"] = best_rules(
                        get_config(arch), amesh, global_batch=c.global_batch, seq=c.seq_len, kind=c.kind)[0]
    print(f"[shard] best_rules' strategy per applicable cell on (16, 16) and (2, 16, 16) (the reference's TPU v5e "
          f"pod model; names only):")
    for key, strat in chosen.items():
        print(f"    {key:42s} {strat}")
    return {"strategy": name, "leaves": placed, "bytes": nbytes, "chosen": chosen}


# [dryrun]: the roofline CLI's two train cells, and the bound it states on
# counted flops over need (launch/roofline.py: flops_ratio)
DRYRUN_ARCHS = (LM_ARCH, SSD_ARCH)
FLOPS_RATIO = (0.95, 2.0)


def phase_dryrun() -> dict:
    """[dryrun]: the roofline of each train_4k cell on the (16, 16) fake
    mesh, in a subprocess, priced on the H100; its flops within
    FLOPS_RATIO of the need."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.roofline import flops_ratio

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "roofline")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ARGS.src))
    out: dict = {}
    for arch in DRYRUN_ARCHS:
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline", "--arch", arch, "--shape",
                               "train_4k", "--out-dir", out_dir], env=env, capture_output=True, text=True,
                              timeout=600)
        for line in proc.stdout.splitlines():
            print(f"    {line}")
        if proc.returncode != 0:
            raise AssertionError(f"[dryrun] roofline {arch}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
        r = json.loads(open(os.path.join(out_dir, f"{arch}__train_4k.json")).read())
        cfg, cell = get_config(arch), SHAPES["train_4k"]
        rec_p = r["records"]["p"]
        ratio_p = flops_ratio(rec_p["cost_analysis_flops"] * rec_p["chips"],
                              cfg.replace(n_layers=r["protocol"]["p"]), cell)
        ratio = flops_ratio(r["hlo_flops_global"], cfg, cell)
        print(f"[dryrun] {arch} train_4k on (16, 16) ({r['chips']} fake ranks), strategy {r['strategy']}, remat "
              f"{r['remat']}, {time.time() - t0:.1f} s: flops per chip p={r['protocol']['f_p']:.6g} "
              f"2p={r['protocol']['f_2p']:.6g} full={r['flops_per_chip']:.6g}; argument bytes per chip "
              f"p={rec_p['memory_analysis']['argument_size_bytes']}; collective bytes per chip by kind (2p) "
              f"{r['collectives_by_kind_2p']}; H100 terms compute {r['compute_s'] * 1e3:.3f} ms, memory "
              f"{r['memory_s'] * 1e3:.3f} ms, collective {r['collective_s'] * 1e3:.3f} ms ({r['bound']}-bound); "
              f"counted / need {ratio_p:.4f} at depth p, {ratio:.4f} extrapolated (bound {FLOPS_RATIO})")
        if not (FLOPS_RATIO[0] <= ratio_p <= FLOPS_RATIO[1] and FLOPS_RATIO[0] <= ratio <= FLOPS_RATIO[1]):
            raise AssertionError(f"[dryrun] {arch}: counted flops / need {ratio_p:.4f} (p), {ratio:.4f} "
                                 f"(extrapolated) outside {FLOPS_RATIO}")
        out[arch] = {"ratio_p": ratio_p, "ratio": ratio, **{k: r[k] for k in (
            "strategy", "flops_per_chip", "bytes_per_chip", "collective_bytes_per_chip", "compute_s", "memory_s",
            "collective_s", "bound", "model_to_hlo_ratio", "mfu_proxy")}}
    return out


# the Pallas kernel body each CUDA kernel replaces (the fused conv replaces none)
REPLACES = {
    "matmul_requant": "src/repro/kernels/matmul_requant.py:45",
    "flash_attention": "src/repro/kernels/flash_attention.py:28",
    "moe_gmm": "src/repro/kernels/moe_gmm.py:22",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:27",
    "rglru_scan": "src/repro/kernels/rglru_scan.py:26",
}


def main() -> None:
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    print(f"[card] driving repro_torch from {os.path.abspath(ARGS.src)}; phases {', '.join(ARGS.only)}")
    resolve_device("cuda")  # IEEE fp32 matmuls on the card (TF32 off) for every comparison
    register_h100_target()  # the card's own target, on explicit request only
    print(f"[card] largest SM clock (nvidia-smi clocks.max.sm): {max_sm_clock()}")

    phase_build(check_spills=os.path.abspath(ARGS.src) == CHECKOUT_SRC)
    only = set(ARGS.only)
    rows: list[dict] = []
    launches: dict[str, dict[str, int]] = {}  # by phase, each by kernel
    if "gemm" in only:
        rows += table("gemm", gemm_timed())
        branches = phase_gemm_branches()
    if "kernels" in only:
        rows += table("kernels", itertools.chain(flash_timed(), gmm_timed(), scan_timed()))
        phase_ssd_heads()
    if "conv" in only:
        rows += phase_conv()
    if "cnn" in only:
        launches["cnn"] = phase_cnn()["launches"]
    if "pipeline" in only:
        launches["pipeline"] = phase_pipeline()["launches"]
    if "calibrate" in only:
        launches["calibrate"] = phase_calibrate()["launches"]
    if "fuzz" in only:
        launches["fuzz"] = phase_fuzz()["launches"]
    draw = lambda lm: draw_rglru_decays(lm, seed=1)  # noqa: E731
    if "lm" in only:
        for arch in (LM_ARCH, MOE_ARCH, SSD_ARCH):
            phase_lm_parity(arch)
        # one (rglru, rglru, local_attn) period; the prompt fills the 2048-slot
        # ring (S % L == 0, clear of ROADMAP C-ref-6) and decode wraps it
        phase_lm_parity(RG_ARCH, n_layers=3, prompt=get_config(RG_ARCH).local_window, prepare=draw)
    if "lm-bf16" in only:
        phase_lm_bf16(LM_ARCH)
        phase_lm_bf16(MOE_ARCH)
        phase_lm_bf16(SSD_ARCH)  # (4, 512): 128 divides it (C-ref-5), eight 64-row kernel chunks
        # one (rglru, rglru, local_attn) period over 4096 tokens: the window of 2048 bites
        phase_lm_bf16(RG_ARCH, n_layers=3, batch=2, prompt=LONG_PROMPT, prepare=draw)
    if "prefill-long" in only:
        longs = {arch: phase_prefill_long(arch) for arch in (LM_ARCH, SSD_ARCH, RG_ARCH)}
    if "serve" in only:
        launches["serve"] = {}
        for arch in (LM_ARCH, MOE_ARCH, SSD_ARCH, RG_ARCH):
            add_counts(launches["serve"], phase_serve(arch)["launches"])
    if "train" in only:
        trained = phase_train()
        launches["train"], launches["train_grads"] = trained["launches_full"], trained["launches_grads"]
    if "ops" in only:
        op_run = phase_ops()
        launches["ops"] = {name: r["launches"] for name, r in op_run["kernels"].items()}
    if "shard" in only:
        phase_shard()
    if "dryrun" in only:
        phase_dryrun()
    if only != set(PHASES):
        print(f"[only] {', '.join(ARGS.only)} passed; no JSON lines without every phase")
        return

    entries = []
    for name in KERNELS + ("conv_requant",):
        e = {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{name}.cu",
             "replaces": REPLACES.get(name), "rows": [r for r in rows if r["kernel"] == name],
             "launches": {phase: n[name] for phase, n in launches.items() if n.get(name)}}
        if name in trained["timing"]:  # the training path: each backward's times
            e["backward"] = trained["timing"][name]
        if name in op_run["kernels"]:  # the DSE-scheduled wrapper's run
            o = op_run["kernels"][name]
            e["ops"] = {k: o[k] for k in ("shape", "max_abs_err", "host_ms_cold", "host_ms_cached", "host_ms_bare")}
        if name in ("ssd_scan", "rglru_scan"):
            e["prefill_long"] = longs[RG_ARCH if name == "rglru_scan" else SSD_ARCH]["kernels"][name]
        if name == "matmul_requant":
            e["branches"] = branches
        entries.append(e)
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

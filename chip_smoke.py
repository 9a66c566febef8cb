"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py                       # every phase, as below
    python3 chip_smoke.py --only gemm,cnn [--src DIR]

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
``nvcc``; run from the root of a checkout.  Phases, each raising on
failure:

1. the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the main paths, and an empty kernel (the
   launch floor), compiled by ``nvcc`` from
   ``src/repro_torch/kernels/csrc``, one compiler per source, all started
   together (build seconds, ``-Xptxas -v``), and no spill store in any
   tensor-core instantiation (bf16 flash and ``moe_gmm``, the int8 GEMM's
   four) or scan kernel (registers and spills printed);
3. ``gemm``: both entries of the int8 GEMM on the card against their
   plain versions, bit-exact (tolerance 0: integer arithmetic):
   ``matmul_requant`` on the CNN path's shapes, the test grid and ragged
   shapes (K past one block's 1024 staged columns among them), both
   roundings, ReLU on and off; the segment entry ``matmul_requant_f32``
   on the same shapes as drawn, with A one float off 16 bytes (an arena
   view), fractional operands inside int8 range, no bias, a bias beyond
   2^24 and A with column stride M; then both entries' times at M = 1 and at
   DAE's served M = 16 (kernel, launch floor at the kernel's own launch
   shape, launched from Python, plain, library, bound, and the time
   before the redesign as ``before``); the data behind the kernel's rule (the GEMV branch up
   to 512 blocks, the tensor cores beyond): both entries at M = 1, at
   DAE's M = 16 and across the knee with each branch forced, bit-exact
   and timed beside its own launch floor; and
   DAE's GEMM segments on h100 as the lowering runs them (``LoweredSegment.fn`` at M = 1 and 16): device ms per call in a
   CUDA graph and the device kernels of one call; ``kernels``: the LM
   kernels, each on the card against its plain PyTorch version:
   ``flash_attention`` within 2e-5 (f32) and 2e-2 (bf16) on the kernel
   test grid (causal and not), Sq != Sk with ``q_offset``,
   sliding windows, ragged lengths, the serving shapes, bf16 at D in
   {24, 80, 256} with Sq, Sk in {1, 63, 65, 129}, views whose rows start
   one element off 16 bytes, and rows with no valid key (negative
   ``q_offset``, causal); ``moe_gmm`` within 1e-4 (f32) and 2e-2 (bf16)
   on the kernel test grid, ragged, strided and misaligned operands and
   granite-moe-3b-a800m's shapes (C = 32, a refill's 16 and one slot's
   decode, 8), and granite-4.0-h-small's (a decode's 8 slots, a prefill's
   256 and 512) with and without the routed rows; at granite-4.0-h-small's
   decode and 256-slot prefill with the routed rows (10 of 72 experts a
   decode, 100-190 pairs an expert in the prefill) within 2e-2 of the
   plain product and bit for bit against the call without them on the
   filled rows and 0 elsewhere, then timed beside it and beside every
   expert empty, with the routed bytes as its bound; ``ssd_scan`` (y and the final state) within 2e-4 of its
   plain version and of the sequential oracle on the kernel test grid,
   ragged T and mamba2-1.3b's shapes, among them many chunks at full
   width ((1, 4096), (4, 512) and a ragged (1, 4095)); ``rglru_scan``
   within 1e-4 of its plain version and of the sequential oracle on the
   kernel test grid, ragged T and W, strided and bf16 operands and
   recurrentgemma-2b's shapes (T on each side of one 64-step chunk, and
   (1, 4096), (1, 4097)); then times of each at its path's shapes (flash
   also at recurrentgemma-2b's local-attention shape) beside the plain
   version, one PyTorch library call where there is one, the bound, and,
   printed only, the time the same kernel took before its redesign
   (``BEFORE_MS``, from ``PERF.md``'s kernel table); under each scan row,
   the device kernels one call issues, by ``torch.profiler``; and
   ``ssd_scan``'s time with each count of heads per output block, the
   data behind the wrapper's ``heads_per_block``; ``conv``: the fused conv
   ``conv_requant`` (one launch per int8 conv segment) at every conv layer
   shape of MobileNetV1-0.25 and DS-CNN's 10x4 stride-2 first layer, batch
   1 and 16, bit-exact with its plain version at band heights 0, 1, 3 and
   OY, ReLU on and off, shifts 0, 1, 5 and 12, without bias and on a
   strided view, one counted launch each; then device ms per call in a
   CUDA graph beside the launch floor at its launch shape, the bound, the
   banded executor with its eager epilogue that it replaced (``before``)
   and cuDNN's conv with the epilogue (``library``, timed only), and
   MobileNet's 27 layers summed;
4. CNN path: the four MLPerf-Tiny nets x {gap9, diana, h100} (h100, the
   card's own target, registered explicitly) through
   ``repro_torch.core.dispatch`` -> ``repro_torch.backend.lower`` (default
   device) -> 4 requests through ``CompiledModel.run``, each output
   bit-exact with the port's CPU interpreter, and the GEMM and fused conv
   launch counts equal to (GEMM segments) x 4 requests and (fused conv
   segments) x 4 requests, no other kernel launched; then the same requests through
   the whole-graph AOT executor (``compile_aot``, one CUDA graph) in both
   memory modes, ``xla`` and ``arena``: bit-exact with
   ``CompiledModel.run`` and the interpreter, a rerun of the first request
   exact (the arena reused), the same GEMM launch count under replay; for
   DAE and DS-CNN on gap9 and h100 the device kernels of one AOT ``xla``
   run by name, with count and µs (profiler); for each net on h100 the
   device operations of one replay of the captured graph alone (its
   nodes that run on the card, profiler); and ms per request eager / AOT xla / AOT arena (host clock to
   ``torch.cuda.synchronize()``, median of 5 after a warm-up); conv
   bands per request on h100 beside gap9's; on h100, one timed run per
   net: each segment's predicted cycles against its CUDA-event time in
   the target's cycles;
5. ``[pipeline]``, ``benchmarks/pipeline_throughput.py`` on the card: the
   four nets x {gap9, diana, ne16_octa}, 12 inputs through
   ``PipelinedModel.run_stream`` (one CUDA stream per module lane, 3
   inputs in flight), per segment and with every lane chain a captured
   CUDA graph (``aot=True``); each streamed run repeated 5 times, every
   output bit-exact with ``CompiledModel.run`` (the first also with the
   CPU interpreter) and the GEMM and fused conv launches exact; µs per input sequential
   against streamed beside ``predicted_speedup()`` and the stream bound;
6. ``[cnn-serve]``, ``benchmarks/serve_load.py`` on the card: DAE and
   DS-CNN x {gap9, ne16_octa, h100}, 96 requests offered open-loop
   (Poisson, seed 1) at 6x the measured sequential rate to a
   ``ModelServer`` of 16 slots and 2 batches in flight, in ``mode="aot"``
   (one captured graph per batch shape) and ``mode="pipeline"``: every
   served row bit-exact with the sequential run, itself bit-exact with
   the CPU interpreter; GEMM (fused conv) launches = GEMM (fused conv)
   segments x batches; every
   request completed, none rejected; sequential and sustained requests
   per second, p50/p99 latency, capture ms per batch shape, the SLO
   verdict (which must be ok) and the serving thread's host ms per batch
   by step (launch, wait on the batch's event, resolve, the rest);
7. ``[calibrate]``, the calibration loop on the card's own target:
   ``repro_torch.calibrate.run_microbench("h100", repeats=3)`` over the
   full sweep (9 generated conv, dwconv and dense graphs x the full
   target, ``cuda_core`` alone, ``tensor_core`` alone and the ``aten``
   fallback alone; CUDA events around each segment's eager call), a
   least-squares fit per module (``fit_profile``), the samples and the
   profile saved under ``build/calibration/`` and the profile loaded back
   with the same fingerprint; per module its samples, coefficients, MAE
   before and after (cycles and µs; the fit must lower it) and the median
   measured/predicted before and after, then the medians by module and
   route and the spread between the two measurements of a segment swept
   in two variants on one module; then the four nets on h100 under the declared and the fitted
   model: segments per module, the anchors that change module or route,
   conv bands per request, eager and AOT ``xla`` ms per request (median
   of 5), each bit-exact with the CPU interpreter;
8. ``[fuzz]``, the differential fuzzer on the card: seeds 0-23 x {h100,
   gap9} through ``repro_torch.fuzz.check_case`` with the full battery
   on every seed (one ``SchedulePlanner`` per target), then the corpus
   cases of ``tests/conformance/corpus/`` replayed with the full battery
   on their own targets (read only): every compiled path on the card
   (``CompiledModel.run``, AOT, ``PipelinedModel.run`` and
   ``run_stream``, ``BatchedModel``) bit-exact with the CPU interpreter;
   the invariant coverage, the failures (any fails the phase), the
   seconds, the GEMM and fused conv launches (each must be above 0) and
   the distinct (M, K, N) of the GEMM
   segments reached, with how many have K or N not divisible by 4;
9. LM parity: qwen2.5-3b, granite-moe-3b-a800m and mamba2-1.3b at full
   width, 2 layers, float32, a 16-token prefill, and recurrentgemma-2b at
   full width, 3 layers (rglru, rglru, local_attn), float32, a 2048-token
   prefill that fills its local-attention ring, with RG-LRU decays drawn
   in about 0.4-0.999 so the recurrence carries; each with 4 greedy decode
   steps (recurrentgemma's wrap the ring) on the card (the kernels, decode
   by the serving engine's captured CUDA graph) against the same module on
   the CPU (plain versions), logits within 1e-3 and identical tokens;
10. bf16 LM check of the kernels: qwen2.5-3b, granite-moe-3b-a800m and
   mamba2-1.3b at full width, 2 layers, a (4, 512) prefill, and
   recurrentgemma-2b, 3 layers, a (2, 4096) prefill (the window of 2048
   bites), three prompt batches each, bf16 on the card, against the same
   module with the four plain versions (``flash_attention_plain``,
   ``moe_gmm_plain``, ``ssd_scan_plain``, ``rglru_scan_plain``) patched
   into the model modules and the MoE routing of the plain run replayed:
   every kernel call on the model's own inputs within its limit of the
   largest |plain| of its plain version (flash and moe_gmm 2e-2, the bf16
   kernel grid's; ssd_scan 2e-4 and rglru_scan 1e-4, their kernel
   grids'; each element of ssd_scan's (y, h_final); both sides of
   ssd_scan also printed against a float64 recurrence); each attention
   layer's and each MoE layer's output before its residual add, through
   the kernels against the plain versions on the plain run's own
   activations, within 2e-2 of max |plain|; and last-token logits within
   3e-2 of the
   largest |logit| or within the model's floor where that is larger (the
   gap that rounding the plain flash's output toward zero makes); greedy
   agreement and the gap with each run routing itself printed;
11. ``[prefill-long]``: one 4096-token prompt through full-depth bf16
   ``LM.prefill`` of qwen2.5-3b, mamba2-1.3b and recurrentgemma-2b
   (``max_len`` 4096): host ms (median of 3 after a warm-up), exact
   launch counts (one flash per attention layer, one ssd_scan per ssd
   layer, one rglru_scan per rglru layer), and for each kernel of the
   prefill its device ms per counted call and its device kernels by
   ``torch.profiler``;
12. LM serve path: ``repro_torch.launch.serve``'s engine on qwen2.5-3b (36
   layers), granite-moe-3b-a800m (32), mamba2-1.3b (48) and
   recurrentgemma-2b (26), each at full width and depth (bf16, weights
   from a generator seeded 0), 6 requests, 12 new tokens each, greedy,
   4 ``run()`` calls decoding by CUDA-graph replay (the engine's default
   on the card) and 4 with ``eager=True`` on the same model: every
   request served, all logits finite, identical tokens, truncation,
   decode steps, refills and launch counts in all 8 runs, and exact
   launch counts in each (counted from 0 just before each run): flash =
   attention layers (``attn`` and ``local_attn``) x prefill calls,
   moe_gmm = 3 x MoE layers x (prefill calls + decode steps), ssd_scan =
   ssd layers x prefill calls, rglru_scan = rglru layers x prefill calls,
   and no launch of a kernel off the path; capture ms per graph; decode ms
   per step and tok/s of each mode (median over runs 2-4); then a
   profiler breakdown of a decode step, eager and by replay;
13. ``[train]``: training on the card.  Each LM kernel's
   ``autograd.Function`` (the kernel forward, its explicit ``*_backward``)
   against ``torch.autograd.grad`` of its plain version on the card
   (flash causal, windowed, non-causal, GQA, Sq != Sk with ``q_offset``;
   ``moe_gmm`` at granite-moe's wi and wo; both scans at T = 128, 512
   and a ragged T with slow decays; then every family's training shapes),
   within 1e-4 of the largest |plain gradient| in f32 and 2e-2 in bf16
   (``ssd_scan``'s f32 xb and a 2e-4); each backward's times at its
   training shape beside the plain version's forward + backward, SDPA's
   forward + backward (flash) or two ``torch.bmm`` (``moe_gmm``), and its
   bound; ``LM.loss`` and every parameter's gradient, fp32, batch 2 x 128,
   on the card and on the CPU against the same weights in float64, the
   card within max(1e-3, 3x the CPU's own gap) of each leaf's largest
   |gradient|, every gradient nonzero on the card wherever the CPU's is,
   launches exact, for qwen2.5-3b, granite-moe (routing replayed from the
   CPU run), mamba2, hubert (2 layers), recurrentgemma (3, decays drawn)
   and qwen2-vl (M-RoPE positions, embeds) at full width, and qwen2.5-3b
   once more with wq and wk scaled so the softmax is not saturated, the
   card within a flat 1e-3 of the CPU; qwen2.5-3b and
   mamba2-1.3b at full width and depth through
   ``repro_torch.launch.train.main`` (bf16, batch 8, seq 128, remat
   ``full``, 10 steps): ms per step, tokens/s, MFU, peak memory against
   16 bytes per parameter, exact launches and backward calls per step,
   losses and grad norms, and one profiled step split into forward,
   backward and optimizer; 8 steps of qwen2.5-3b on one fixed batch, the
   loss falling; and on mamba2's smoke config a run stopped after step 4
   by its ``PreemptionGuard`` and resumed from its checkpoint giving the
   uninterrupted run's losses, the checkpoint restoring through the
   reference format into ``params_from_jax``;
14. ``[ops]``: ``repro_torch.kernels.ops``, the kernels behind the LOMA
   DSE on the card's own target: ``kernel_schedule_table()`` on h100
   (each row's module, blocks, grid order, predicted cycles and the knob
   the schedule set); then each ``scheduled_*`` wrapper once on the card,
   launch counters reset just before and read just after (one launch of
   its kernel, none of another), at the reference table's full shapes
   (``matmul_requant`` 4096 x 6144 x 6144 int8, ``flash_attention`` B 8,
   H 16, S 4096, D 128 bf16 causal, ``rglru_scan`` 8 x 4096 x 2560 f32)
   or the served shapes of ``PERF.md`` (``moe_gmm`` granite's 40 x 32 x
   1536 x 512 bf16, ``ssd_scan`` mamba2's (1, 4096)), each held against
   its plain version on the card (``matmul_requant`` bit-exact, by row
   blocks; flash and ``moe_gmm`` 2e-2; ``rglru_scan`` 1e-4; ``ssd_scan``
   2e-4, y and the final state); each wrapper's host ms per call with its
   schedule cached and cold (the DSE's cost per call) beside the bare
   kernel wrapper's; and ``ssd_scan``'s device ms with the DSE's heads per
   block against the kernel's own rule;
15. ``[shard]``: a 1 x 1 ``DeviceMesh`` on the card (a one-rank NCCL
   group, destroyed after): qwen2.5-3b's full-width parameters placed by
   ``param_shardings`` under the rules ``best_rules`` picks for it, each
   DTensor's local tensor bitwise the parameter; ``constrain`` an
   identity on values; and ``best_rules``'s strategy for every
   applicable (arch x shape) on both production meshes (a TPU v5e pod
   model's choice, printed by name only);
16. ``[dryrun]``: ``python -m repro_torch.launch.roofline --arch A --shape
   train_4k`` for qwen2.5-3b and mamba2-1.3b, each in a subprocess (its
   fake 256-rank group never meets NCCL): the depth-p and 2p records'
   flops, per-chip argument bytes and collective bytes by kind, the three
   H100 terms, and the counted flops over ``roofline.flops_ratio``'s need
   (model flops + attention flops, x the remat recompute), which must
   lie in ``FLOPS_RATIO`` at depth p and extrapolated;
17. one JSON line of per-kernel numbers (each LM kernel with its
   training launches and its backward's times, each kernel with its
   ``[ops]`` launches), the card line, and last the ``{"ok": true,
   "device": ...}`` line.

``--only`` is a development aid: it runs the named phases of ``gemm``,
``kernels`` and ``conv`` (3), ``cnn`` (4), ``pipeline`` (5), ``cnn-serve`` (6),
``calibrate`` (7), ``fuzz`` (8), ``lm`` (9), ``lm-bf16`` (10),
``prefill-long`` (11), ``serve`` (12), ``train`` (13), ``ops`` (14),
``shard`` (15) and ``dryrun`` (16), after the card
line and the build, and prints neither the
JSON line nor the ``ok`` line, so it never stands in for a full run.
``--src DIR`` drives the ``repro_torch`` package under DIR instead of this
checkout's ``src`` (``--only gemm,cnn --src <parent>/src`` times the
kernels and segments of another commit, unpacked under DIR, in the same
call; a tree without the segment entry skips its checks and tables).

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
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

PHASES = ("gemm", "kernels", "conv", "cnn", "pipeline", "cnn-serve", "calibrate", "fuzz", "lm", "lm-bf16", "prefill-long",
          "serve", "train", "ops", "shard", "dryrun")
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
from repro_torch.kernels.ref import rglru_scan_ref, ssd_scan_ref  # noqa: E402
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
from repro_torch.obs import SloSpec  # noqa: E402
from repro_torch.pipeline import PipelinedModel  # noqa: E402
from repro_torch.serve import ModelServer  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.targets import get_target, register_h100_target  # noqa: E402

DEV = torch.device("cuda")
# the GEMM's module; its segment entry exists from the redesign on (None
# only for an older tree driven with --src)
MR = importlib.import_module("repro_torch.kernels.matmul_requant")
SEGMENT = getattr(MR, "matmul_requant_f32", None)
# the fused conv's module (None for a tree before it, driven with --src)
try:
    CR = importlib.import_module("repro_torch.kernels.conv_requant")
except ModuleNotFoundError:
    CR = None
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
TARGETS = ("gap9", "diana", "h100")  # h100 registered explicitly in main()
REQUESTS = 4
# the cells whose AOT replay is broken down into its device kernels
BREAKDOWN_CELLS = {(net, tgt) for net in ("DAE", "DSCNN") for tgt in ("gap9", "h100")}
# [pipeline]: benchmarks/pipeline_throughput.py's sweep on the card
PIPE_TARGETS = ("gap9", "diana", "ne16_octa")
PIPE_INPUTS, PIPE_DEPTH, PIPE_REPEATS = 12, 3, 5
# [cnn-serve]: benchmarks/serve_load.py's sweep on the card, h100 added
SERVE_NETS = ("DAE", "DSCNN")
SERVE_TARGETS = ("gap9", "ne16_octa", "h100")
SERVE_N, SERVE_BATCH, SERVE_DEPTH, SERVE_OFFERED_X = 96, 16, 2, 6.0
# [fuzz]: generated graphs, full battery on every seed, on these targets
FUZZ_SEEDS = 24
FUZZ_TARGETS = ("h100", "gap9")
KERNELS = ("matmul_requant", "flash_attention", "moe_gmm", "ssd_scan", "rglru_scan")
# every source built: the five kernels, the fused conv of the CNN path (where
# the tree driven has it) and an empty kernel, the card's launch floor
SOURCES = tuple(n for n in KERNELS + ("conv_requant", "launch_floor") if (_build.CSRC / f"{n}.cu").exists())
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
SERVED_M = (2, 16)
# (M, K, N) on both sides of the GEMM rule's knee (the GEMV's blocks against
# those the card holds at once): only the branch sweep times them
BRANCH_KNEE = ((16, 128, 256), (16, 128, 384), (16, 128, 512), (32, 128, 128), (64, 128, 128), (1, 128, 4096),
               (1, 128, 8192))
GRID_MKN = ((8, 16, 128), (32, 64, 128), (128, 128, 256), (16, 96, 384), (3, 37, 11), (48, 80, 112))
# ragged M, N and K for both GEMM entries: heads of N = 2 and 10, K = 8 and
# 13, M one past a 16-row tile, and K beyond one block's staged 1024 columns
SEGMENT_RAGGED = ((17, 13, 10), (2, 8, 2), (17, 640, 10), (1, 13, 640), (33, 200, 24), (5, 2100, 40), (16, 1030, 9))
# flash attention: tolerance per dtype (tests/test_kernels.py:33), the
# kernel test grid (B, H, KV, S, D), and qwen2.5-3b's prefill shapes
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_GRID = ((1, 4, 4, 64, 32), (2, 8, 2, 128, 64), (1, 6, 1, 96, 16))
LM_ARCH = "qwen2_5_3b"
FLASH_TIMED = ((4, 24), (4, 512), (1, 4096))  # (B, S) at H=16, KV=2, D=128, bf16, causal
SERVE_REQUESTS, SERVE_NEW, SERVE_SLOTS = 6, 12, 4
MOE_ARCH, SSD_ARCH = "granite_moe_3b_a800m", "mamba2_1_3b"
# moe_gmm: the kernel test grid (E, C, D, F), ragged shapes, and
# granite-moe-3b-a800m's serving shapes (C = 4 slots x capacity 8)
GMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
GMM_GRID = ((2, 16, 32, 64), (8, 64, 128, 128), (3, 8, 16, 384))
GMM_RAGGED = ((3, 37, 45, 70), (5, 1, 7, 3), (2, 33, 100, 65))
# ssd_scan: the kernel test grid (B, H, T, P, N), ragged T, and mamba2-1.3b's
# prefill shapes; times at (B, T) with H=64, P=64, N=128
SSD_GRID = ((1, 2, 32, 8, 16), (2, 4, 64, 16, 32))
SSD_RAGGED = ((1, 3, 37, 8, 16), (2, 2, 5, 16, 16), (1, 2, 100, 16, 32))
SSD_TIMED = ((4, 24), (4, 512), (1, 4096))
SSD_TOL = 2e-4
# heads per output block timed at each of SSD_TIMED and (1, 512): the data
# behind the wrapper's heads_per_block
SSD_HEADS = (1, 2, 4, 8, 16, 32, 64)
RG_ARCH = "recurrentgemma_2b"
# rglru_scan: the kernel test grid (B, T, W) with a in U(0.2, 0.999), ragged
# T and W; times at (B, T) with recurrentgemma-2b's W = 2560, a and b f32.
# A call of one 64-step chunk skips the kernel that pairs the chunks: the
# checks take T on both sides of that edge.
RGLRU_TOL = 1e-4
RGLRU_GRID = ((1, 32, 16), (2, 128, 64), (3, 64, 256))
RGLRU_RAGGED = ((2, 37, 45), (1, 5, 3), (3, 20, 130))
RGLRU_TIMED = ((4, 24), (4, 512), (1, 4096))
RGLRU_CHUNK = 64  # steps per chunk: kTc in csrc/rglru_scan.cu
# flash at recurrentgemma-2b's local attention (H=10, KV=1, D=256, window 2048)
RG_FLASH_TIMED = ((4, 24), (1, 4096))
# the bf16 tensor-core path's ragged head dims and lengths
FLASH_BF16_D = (24, 80, 256)
FLASH_BF16_S = (1, 63, 65, 129)
# device ms per call of each timed shape with each kernel as it was before its
# redesign (PERF.md's kernel table; NVIDIA H100 80GB HBM3, 700.00 W): flash
# and moe_gmm on the CUDA cores; matmul_requant as one warp per output;
# ssd_scan as one block per (b, h) walking
# the chunks in order, rglru_scan as one thread per channel walking all of T.
# Keyed by table and shape: printed in the timing tables' `before` column,
# beside this run's times, and nowhere else
BEFORE_MS = {
    ("matmul_requant", (1, 640, 128)): 0.00188, ("matmul_requant", (16, 640, 128)): 0.00236,
    ("matmul_requant", (16, 128, 128)): 0.00206, ("matmul_requant", (16, 128, 8)): 0.00176,
    ("matmul_requant", (16, 8, 128)): 0.00209, ("matmul_requant", (16, 128, 640)): 0.00336,
    ("flash", (4, 24)): 0.01694, ("flash", (4, 512)): 0.58414, ("flash", (1, 4096)): 7.68650,
    ("rg_flash", (4, 24)): 0.03146, ("rg_flash", (1, 4096)): 12.49169,
    ("moe_gmm", "wi"): 0.27632, ("moe_gmm", "wo"): 0.16695,
    ("ssd_scan", (4, 24)): 0.06077, ("ssd_scan", (4, 512)): 1.26050, ("ssd_scan", (1, 4096)): 8.55763,
    ("rglru_scan", (4, 24)): 0.00239, ("rglru_scan", (4, 512)): 0.07055, ("rglru_scan", (1, 4096)): 0.47136,
}
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


def gemm_operands(m: int, k: int, n: int, seed: int, *, transposed_w: bool):
    """int8 A (M, K), W (K, N) and int32 mult/bias on the card.  With
    ``transposed_w`` W is the (K, N) view of an (N, K) matrix, as the
    lowering passes a dense weight."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8)).to(DEV)
    if transposed_w:
        w = torch.from_numpy(rng.integers(-128, 128, (n, k)).astype(np.int8)).to(DEV).T
    else:
        w = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8)).to(DEV)
    mult = torch.from_numpy(rng.integers(1, 8, (n,)).astype(np.int32)).to(DEV)
    bias = torch.from_numpy(rng.integers(-1000, 1000, (n,)).astype(np.int32)).to(DEV)
    return a, w, mult, bias


def bound(nbytes: float, flops: float, flops_s: float) -> tuple[float, str]:
    """max(bytes / HBM rate, flops / peak rate) in ms, and which bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / flops_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def graph_ms(fn, iters: int = 200) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed between CUDA events (host launch cost excluded)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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


def device_kernels(fn, calls: int = 3) -> dict[str, dict]:
    """Device kernels per call of ``fn`` by :func:`kernel_label`: how many,
    and their device µs, from ``torch.profiler`` over ``calls`` calls
    after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, dict] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = out.setdefault(kernel_label(e.name), {"count": 0.0, "us": 0.0})
            row["count"] += 1 / calls
            row["us"] += e.time_range.elapsed_us() / calls
    return out


def device_kernels_us(fn, calls: int = 3) -> dict[str, float]:
    """Device µs per call of each kernel that ``fn`` launches, by name."""
    return {name: row["us"] for name, row in device_kernels(fn, calls).items()}


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


def library_gemm_requant(af, wf, mult, bias, shift):
    """PyTorch's own calls for the same function (fp32 matmul on the
    integer-valued operands, then the epilogue): the yardstick only."""
    y = torch.matmul(af, wf).to(torch.int32) * mult + bias
    return torch.clamp(torch.round(y / float(1 << shift)), -128, 127).to(torch.int8)


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


def gemm_floor(m: int, k: int, n: int):
    """The launch floor at the GEMM's own launch shape: the package's
    ``launch_shape`` where it has one, else the shape of the kernel before
    its redesign (ceil(M N / 8) blocks of 256 threads), for ``--src``."""
    shape = getattr(MR, "launch_shape", None)
    blocks, threads = shape(m, n, k)[:2] if shape else (-(-m * n // 8), 256)
    return launch_floor(blocks, threads)


def segment_operands(m: int, k: int, n: int, seed: int, *, fractional: bool = False, misaligned: bool = False,
                     with_bias: bool = True, big_bias: bool = False, strided_a: bool = False):
    """The segment entry's operands on the card as the lowering holds them:
    integer-valued float32 activations (M, K), the dense weight (N, K) and
    bias (N,) (or None).  ``fractional`` moves every activation and weight
    by a fraction inside int8 range (truncation toward zero must agree);
    ``misaligned`` puts A one float off 16 bytes, as an arena view may be;
    ``big_bias`` draws the bias beyond 2^24, where a float32 holds only
    even integers; ``strided_a`` hands the activations over as a view with
    column stride M."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (m, k)).astype(np.float32)
    w = rng.integers(-128, 128, (n, k)).astype(np.float32)
    if fractional:
        x = np.clip(x + rng.uniform(-0.99, 0.99, x.shape), -128.99, 127.99).astype(np.float32)
        w = np.clip(w + rng.uniform(-0.99, 0.99, w.shape), -128.99, 127.99).astype(np.float32)
    hi = 1 << 30 if big_bias else 1000
    b = rng.integers(-hi, hi, (n,)).astype(np.float32)
    a = torch.from_numpy(x).to(DEV)
    a = a.T.contiguous().T if strided_a else a
    return (off_by_one(a) if misaligned else a), torch.from_numpy(w).to(DEV), (torch.from_numpy(b).to(DEV)
                                                                             if with_bias else None)


def library_segment(x, w, bias, shift):
    """PyTorch's own calls for the segment's function (fp32 addmm on the
    integer-valued operands, then the epilogue): the yardstick only."""
    y = torch.addmm(bias, x, w.T)
    return torch.clamp(torch.round(y / float(1 << shift)), 0, 127)


def gemm_row(m: int, k: int, n: int) -> dict:
    """``matmul_requant``'s times at one (M, K, N), as the lowering called it
    before the segment entry (a transposed (N, K) weight, round-half-even,
    ReLU): in a CUDA graph, launched from Python, the launch floor at its
    own launch shape, the plain version, the library calls and the bound."""
    a, w, mult, bias = gemm_operands(m, k, n, seed=7, transposed_w=True)
    af, wf = a.float(), w.float()
    kw = dict(shift=5, relu=True, rounding="even")
    row = {
        "shape": [m, k, n],
        "ms": graph_ms(lambda: matmul_requant(a, w, mult, bias, **kw)),
        "launch_floor_ms": graph_ms(gemm_floor(m, k, n)),
        "eager_ms": eager_ms(lambda: matmul_requant(a, w, mult, bias, **kw)),
        "plain_ms": graph_ms(lambda: matmul_requant_plain(a, w, mult, bias, **kw)),
        "library_ms": graph_ms(lambda: library_gemm_requant(af, wf, mult, bias, 5)),
        "before_ms": BEFORE_MS.get(("matmul_requant", (m, k, n))),
    }
    row["bound_ms"], row["bound_by"] = bound(m * k + k * n + 8 * n + m * n, 2 * m * n * k, INT8_OPS_S)
    return row


def segment_row(m: int, k: int, n: int) -> dict:
    """The segment entry's times at one (M, K, N), as the lowering calls it
    (float32 operands, bias, round-half-even, ReLU), with the bound of its
    float32 bytes."""
    x, w, b = segment_operands(m, k, n, seed=7)
    kw = dict(shift=5, relu=True, rounding="even")
    row = {
        "shape": [m, k, n],
        "ms": graph_ms(lambda: SEGMENT(x, w, b, **kw)),
        "launch_floor_ms": graph_ms(gemm_floor(m, k, n)),
        "eager_ms": eager_ms(lambda: SEGMENT(x, w, b, **kw)),
        "plain_ms": graph_ms(lambda: MR.matmul_requant_f32_plain(x, w, b, **kw)),
        "library_ms": graph_ms(lambda: library_segment(x, w, b, 5)),
        "before_ms": None,
    }
    row["bound_ms"], row["bound_by"] = bound(4 * (m * k + n * k + n + m * n), 2 * m * n * k, INT8_OPS_S)
    return row


def print_gemm_rows(title: str, rows: list[dict]) -> None:
    print(f"[kernels] {title}, ms per call; graph = device time in a CUDA graph, eager = launched from Python; "
          "floor = an empty kernel at the same launch shape in a CUDA graph; before = the time before the redesign (PERF.md)")
    print(f"    {'M':>3s} {'K':>4s} {'N':>4s} {'kernel':>9s} {'floor':>9s} {'kern eager':>10s} {'plain':>9s} "
          f"{'library':>9s} {'bound':>9s} {'before':>9s}")
    for row in rows:
        m, k, n = row["shape"]
        before = f"{row['before_ms']:>9.5f}" if row["before_ms"] is not None else f"{'-':>9s}"
        print(f"    {m:>3d} {k:>4d} {n:>4d} {row['ms']:>9.5f} {row['launch_floor_ms']:>9.5f} {row['eager_ms']:>10.5f} "
              f"{row['plain_ms']:>9.5f} {row['library_ms']:>9.5f} {row['bound_ms']:>9.6f} {before}")


def check_segment_entry() -> tuple[int, int]:
    """The segment entry bit-exact with its plain version: the main path's
    and the served shapes, the ragged grid, A one float off 16 bytes,
    fractional in-range operands, no bias and a bias beyond 2^24."""
    shapes = ([(1, k, n) for k, n in MAIN_KN] + [(m, k, n) for m in SERVED_M for k, n in DAE_KN]
              + list(GRID_MKN) + list(SEGMENT_RAGGED))
    variants = ({}, {"misaligned": True}, {"fractional": True}, {"with_bias": False}, {"big_bias": True},
                {"strided_a": True})
    cases = 0
    for i, (m, k, n) in enumerate(shapes):
        for j, variant in enumerate(variants):
            x, w, b = segment_operands(m, k, n, seed=100 * i + j, **variant)
            for rounding in ("floor", "even"):
                for relu in (False, True):
                    for shift in (0, 5, 13):
                        kw = dict(shift=shift, relu=relu, rounding=rounding)
                        got = SEGMENT(x, w, b, **kw)
                        torch.cuda.synchronize()
                        want = MR.matmul_requant_f32_plain(x, w, b, **kw)
                        if got.dtype != torch.float32 or not torch.equal(got, want):
                            err = float((got.double() - want.double()).abs().max())
                            raise AssertionError(f"matmul_requant_f32 M,K,N={m},{k},{n} {variant} {kw}: "
                                                 f"max |kernel - plain| = {err}")
                        cases += 1
    return cases, len(shapes)


def phase_gemm_kernel() -> dict:
    """Both GEMM entries bit-exact with their plain versions, then times at
    the CNN path's shapes (M = 1) and at DAE's served shapes (M = 16, one
    row per request of a 16-slot batch)."""
    worst = 0
    cases = 0
    shapes = ([(1, k, n, True) for k, n in MAIN_KN] + [(m, k, n, True) for m in SERVED_M for k, n in DAE_KN]
              + [(m, k, n, False) for m, k, n in GRID_MKN] + [(m, k, n, tw) for m, k, n in SEGMENT_RAGGED
                                                             for tw in (False, True)])
    # A contiguous, and (a tree before the redesign, driven by --src, takes
    # unit column stride only) A with column stride M: the element-wise loads
    layouts = ("contiguous", "column stride M") if SEGMENT is not None else ("contiguous",)
    for i, (m, k, n, tw) in enumerate(shapes):
        a0, w, mult, bias = gemm_operands(m, k, n, seed=i, transposed_w=tw)
        for layout in layouts:
            a = a0 if layout == "contiguous" else a0.T.contiguous().T
            for rounding in ("floor", "even"):
                for relu in (False, True):
                    for shift in (0, 5, 8, 13):
                        got = matmul_requant(a, w, mult, bias, shift=shift, relu=relu, rounding=rounding)
                        torch.cuda.synchronize()
                        want = matmul_requant_plain(a, w, mult, bias, shift=shift, relu=relu, rounding=rounding)
                        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
                        if err:
                            raise AssertionError(
                                f"matmul_requant M,K,N={m},{k},{n} A {layout} {rounding} relu={relu} "
                                f"shift={shift}: max |kernel - plain| = {err}"
                            )
                        worst = max(worst, err)
                        cases += 1
    print(f"[kernels] matmul_requant bit-exact vs matmul_requant_plain on {cases} cases "
          f"({len(shapes)} shapes, M = 1 and M in {SERVED_M} at DAE's (K, N) among them, x A {' and '.join(layouts)} "
          "x 2 roundings x relu on/off x 4 shifts)")
    out = {"max_abs_err": worst}
    if SEGMENT is not None:
        seg_cases, seg_shapes = check_segment_entry()
        print(f"[kernels] matmul_requant_f32 (the segment entry) bit-exact vs matmul_requant_f32_plain on "
              f"{seg_cases} cases ({seg_shapes} shapes x {{as drawn, A one float off 16 bytes, fractional "
              "operands, no bias, bias beyond 2^24, A with column stride M}} x 2 "
              "roundings x relu on/off x 3 shifts)")
    out["rows"] = [gemm_row(1, k, n) for k, n in MAIN_KN]
    print_gemm_rows("matmul_requant, main-path shapes (M=1)", out["rows"])
    out["served_rows"] = [gemm_row(16, k, n) for k, n in DAE_KN]
    print_gemm_rows("matmul_requant, served shapes (M=16, DAE's (K, N))", out["served_rows"])
    if SEGMENT is not None:
        out["segment_rows"] = [segment_row(1, k, n) for k, n in MAIN_KN]
        print_gemm_rows("matmul_requant_f32 (segment entry; bound by float32 bytes), main-path shapes (M=1)",
                        out["segment_rows"])
        out["segment_served_rows"] = [segment_row(16, k, n) for k, n in DAE_KN]
        print_gemm_rows("matmul_requant_f32 (segment entry), served shapes (M=16)", out["segment_served_rows"])
    out["launch_floor_ms"] = graph_ms(launch_floor(1, 32))
    print(f"[kernels] launch floor: an empty sm_90a kernel of 1 block x 32 threads in a CUDA graph, "
          f"{out['launch_floor_ms']:.5f} ms per launch")
    return out


def branch_call(m: int, k: int, n: int, segment: bool, path: int):
    """One entry's launch at (M, K, N) as the lowering calls it, on a
    forced branch (``MR.TENSOR_CORES`` or ``MR.GEMV``), and its plain
    version's output."""
    kw = dict(shift=5, relu=True, rounding="even")
    if segment:
        x, w, b = segment_operands(m, k, n, seed=7)
        out = torch.empty((m, n), dtype=torch.float32, device=DEV)
        return (lambda: MR._launch(x, w, None, b, out, w.stride(0), w.stride(1), 5, "even", True, segment=True,
                                   path=path)), out, MR.matmul_requant_f32_plain(x, w, b, **kw)
    a, w, mult, bias = gemm_operands(m, k, n, seed=7, transposed_w=True)
    out = torch.empty((m, n), dtype=torch.int8, device=DEV)
    return (lambda: MR._launch(a, w, mult, bias, out, w.stride(1), w.stride(0), 5, "even", True, segment=False,
                               path=path)), out, matmul_requant_plain(a, w, mult, bias, **kw)


def phase_gemm_branches() -> list[dict]:
    """The data behind the kernel's rule (the GEMV up to 512 blocks of 8
    outputs, the tensor cores beyond): both entries at M = 1 on the main
    path's shapes, at the served M = 16 on DAE's, and across the knee
    (``BRANCH_KNEE``), each branch forced (the
    GEMV: one warp per output (m, n)), checked bit-exact with the plain
    version and timed in a CUDA graph beside its own launch floor."""
    rows = []
    print("[kernels] matmul_requant branches, ms per call in a CUDA graph (each branch bit-exact with the plain "
          "version; floor at the branch's own launch shape; GEMV = one warp per output (m, n), blocks = its "
          "M x ceil(N / 8) blocks); the rule takes the GEMV up to 512 blocks and the tensor cores beyond")
    print(f"    {'entry':8s} {'M':>3s} {'K':>4s} {'N':>5s} {'blocks':>6s} {'tensor cores':>12s} {'floor':>9s} "
          f"{'GEMV':>9s} {'floor':>9s} {'faster':>12s} {'rule':>12s}")
    shapes = [(1, k, n) for k, n in MAIN_KN] + [(16, k, n) for k, n in DAE_KN] + list(BRANCH_KNEE)
    label = {MR.TENSOR_CORES: "tensor cores", MR.GEMV: "GEMV"}
    for segment in (False, True):
        for m, k, n in shapes:
            row = {"entry": "f32" if segment else "int8", "shape": [m, k, n], "gemv_blocks": m * -(-n // 8)}
            for path, key in ((MR.TENSOR_CORES, "mma"), (MR.GEMV, "gemv")):
                call, out, want = branch_call(m, k, n, segment, path)
                call()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"matmul_requant {row['entry']} branch {key} at M,K,N={m},{k},{n}: "
                                         "differs from the plain version")
                row[f"{key}_ms"] = graph_ms(call)
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


def conv_operands(shape, batch: int, seed: int):
    """x (B, IY, IX, C), the HWIO weight and the bias, integer-valued
    float32 on the card, as the lowering holds them."""
    iy, ix, c, k, fy, fx, _, dw = shape
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (batch, iy, ix, c)).astype(np.float32)
    w = rng.integers(-128, 128, (fy, fx, 1, c) if dw else (fy, fx, c, k)).astype(np.float32)
    b = rng.integers(-3000, 3000, (w.shape[3],)).astype(np.float32)
    return [torch.from_numpy(v).to(DEV) for v in (x, w, b)]


def conv_before(x, w, b, stride: int, dw: bool, shift: int):
    """The conv segment as the lowering ran it before the fused kernel (and
    still runs a segment outside the kernel's pattern): the banded conv of
    ``tiled_conv2d`` (an NCHW view, ``F.pad``, cuDNN), then the chain's
    bias_add, requant and relu through the op library, one eager op each."""
    from repro_torch.cnn.execute import apply_node
    from repro_torch.core import Node
    from repro_torch.kernels.tiled_conv import tiled_conv2d

    y = tiled_conv2d(x, w, stride=stride, feature_groups=x.shape[-1] if dw else 1)
    y = apply_node(Node("b", "bias_add", ("c",)), {"b": b}, [y])
    y = apply_node(Node("q", "requant", ("b",)), {"shift": float(shift)}, [y])
    return apply_node(Node("r", "relu", ("q",)), {}, [y])


def conv_library(xpad, w_oihw, b, stride: int, groups: int, shift: int):
    """PyTorch's own calls for the segment's function (cuDNN's conv with the
    bias, on an input padded and laid out beforehand, then the epilogue in
    two ops): the yardstick only, never on the port's path."""
    y = F.conv2d(xpad, w_oihw, b, stride=stride, groups=groups)
    return torch.clamp(torch.round(y / float(1 << shift)), 0, 127)


def conv_equal(where: str, x, w, b, **kw) -> None:
    """One counted launch of the fused conv, bit-exact with its plain version."""
    before = CR.conv_requant.launches
    got = CR.conv_requant(x, w, b, **kw)
    torch.cuda.synchronize()
    if CR.conv_requant.launches != before + 1:
        raise AssertionError(f"{where}: {CR.conv_requant.launches - before} launches for one call")
    want = CR.conv_requant_plain(x, w, b, **kw)
    if got.dtype != torch.float32 or not torch.equal(got, want):
        bad = (got != want).sum().item() if got.shape == want.shape else "shape"
        raise AssertionError(f"{where} {kw}: {bad} values differ from the plain version")


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


def phase_conv() -> dict:
    """[conv]: the fused conv on the card at every conv layer shape of
    MobileNetV1-0.25 and DS-CNN's first, batch 1 and 16: bit-exact with its
    plain version at every band height (0, 1, 3, OY), ReLU on and off, shift
    0, 1, 5 and 12, no bias and a strided view, one counted launch each;
    then device ms per call in a CUDA graph beside the launch floor at its
    own launch shape, the bound, the banded executor with its eager
    epilogue it replaced (``before``), and cuDNN's conv with the epilogue
    (``library``, timed only)."""
    if CR is None:
        print("[conv] the tree driven has no fused conv kernel: skipped")
        return {"rows": [], "checked": 0}
    rows, checked = [], 0
    print("[conv] conv_requant, device ms per call: kernel in a CUDA graph; floor = an empty kernel at its launch shape "
          "in a CUDA graph; eager = launched from Python; plain = its plain version; before = the banded executor and "
          "eager epilogue it replaced; library = cuDNN conv + bias, round, clamp on a pre-padded input; bound = "
          "max(float32 bytes / 3.35 TB/s, 2 MACs / 1979 TOP/s)")
    print(f"    {'B':>2s} {'IY':>3s} {'IX':>3s} {'C':>4s} {'K':>4s} {'F':>5s} {'s':>1s} {'dw':>2s} {'blocks':>6s} "
          f"{'kernel':>9s} {'floor':>9s} {'eager':>9s} {'plain':>9s} {'before':>9s} {'library':>9s} {'bound':>9s}")
    for shape in CONV_SHAPES:
        iy, ix, c, k, fy, fx, stride, dw = shape
        oy = -(-iy // stride)
        for batch in CONV_BATCHES:
            where = f"[conv] {shape} B={batch}"
            x, w, b = conv_operands(shape, batch, seed=sum(shape[:6]) + batch)
            geo = dict(stride=stride, depthwise=dw)
            for block_oy in (0, 1, 3, oy):
                for relu in (False, True):
                    conv_equal(where, x, w, b, shift=5, relu=relu, block_oy=block_oy, **geo)
                    checked += 1
            for shift in (0, 1, 12):
                conv_equal(where, x, w, b, shift=shift, **geo)
            conv_equal(where, x, w, None, shift=5, relu=True, **geo)
            conv_equal(where, x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3), w, b, shift=5, relu=True, **geo)
            checked += 5
            kern = lambda: CR.conv_requant(x, w, b, shift=5, relu=True, **geo)  # noqa: E731
            before = lambda: conv_before(x, w, b, stride, dw, 5)  # noqa: E731
            if not torch.equal(kern(), before()):
                raise AssertionError(f"{where}: the fused conv differs from the banded executor")
            (py0, py1), (px0, px1) = CR.same_padding(iy, stride, fy), CR.same_padding(ix, stride, fx)
            xpad = F.pad(x.permute(0, 3, 1, 2), (px0, px1, py0, py1)).contiguous(memory_format=torch.channels_last)
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            lib = lambda: conv_library(xpad, w_oihw, b, stride, c if dw else 1, 5)  # noqa: E731
            blocks, threads = CR.conv_launch_shape(batch, iy, ix, c, k, fy, fx, stride=stride, depthwise=dw)
            with _graphs.uncounted():
                row = {"shape": list(shape[:7]), "depthwise": dw, "batch": batch, "blocks": blocks,
                       "ms": graph_ms(kern), "launch_floor_ms": graph_ms(launch_floor(blocks, threads)),
                       "eager_ms": eager_ms(kern),
                       "plain_ms": graph_ms(lambda: CR.conv_requant_plain(x, w, b, shift=5, relu=True, **geo), 20),
                       "before_ms": graph_ms(before), "library_ms": graph_ms(lib)}
            macs = batch * oy * -(-ix // stride) * k * fy * fx * (1 if dw else c)
            nbytes = 4 * (x.numel() + w.numel() + b.numel() + batch * oy * -(-ix // stride) * k)
            row["bound_ms"], row["bound_by"] = bound(nbytes, 2 * macs, INT8_OPS_S)
            rows.append(row)
            print(f"    {batch:>2d} {iy:>3d} {ix:>3d} {c:>4d} {k:>4d} {f'{fy}x{fx}':>5s} {stride:>1d} {'dw' if dw else '':>2s} "
                  f"{blocks:>6d} {row['ms']:>9.5f} {row['launch_floor_ms']:>9.5f} {row['eager_ms']:>9.5f} "
                  f"{row['plain_ms']:>9.5f} {row['before_ms']:>9.5f} {row['library_ms']:>9.5f} {row['bound_ms']:>9.6f}")
    by = {(tuple(r["shape"]) + (r["depthwise"],), r["batch"]): r for r in rows}
    layers = mobilenet_conv_layers()
    for batch in CONV_BATCHES:
        tot = {key: sum(by[s, batch][key] for s in layers) for key in ("ms", "launch_floor_ms", "before_ms",
                                                                       "library_ms", "bound_ms")}
        print(f"[conv] MobileNetV1-0.25's {len(layers)} conv layers at batch {batch}, ms summed: kernel {tot['ms']:.5f}, "
              f"floor {tot['launch_floor_ms']:.5f}, before {tot['before_ms']:.5f}, library {tot['library_ms']:.5f}, "
              f"bound {tot['bound_ms']:.6f}")
    print(f"[conv] {checked} checks bit-exact with the plain version, one counted launch each")
    return {"rows": rows, "checked": checked}


def phase_gemm_segments() -> list[dict]:
    """DAE's GEMM segments on h100 as the lowering runs them: each (K, N)'s
    first ``LoweredSegment.fn`` on an (M, K) integer-valued float32 input at
    M = 1 and at the served M = 16; device ms per call in a CUDA graph (all
    that one call issues) and the device kernels of one call (profiler)."""
    g = mlperf_tiny_networks()["DAE"]
    cm = lower(dispatch(g, "h100", budget=300))
    dev_params = params_to_torch(init_graph_params(g), cm.device)
    rows, seen = [], set()
    print("[kernels] DAE x h100 GEMM segments (LoweredSegment.fn), device ms per call in a CUDA graph; kernels "
          "and µs: the device kernels of one call by the profiler")
    for ls in cm.segments:
        sp = ls.params_slice(dev_params)
        n, k = sp[ls.segment.anchor.name]["w"].shape if ls.route == "pallas_gemm" else (0, 0)
        if ls.route != "pallas_gemm" or (k, n) in seen:
            continue
        seen.add((k, n))
        for m in (1, 16):
            x = torch.from_numpy(np.random.default_rng(m + k + n).integers(-128, 128, (m, k)).astype(np.float32)).to(DEV)
            kern = device_kernels(lambda: ls.fn(sp, x))  # noqa: B023 (called before the loop moves on)
            row = {"segment": ls.name, "shape": [m, k, n], "ms": graph_ms(lambda: ls.fn(sp, x)),  # noqa: B023
                   "kernels": round(sum(r["count"] for r in kern.values())),
                   "device_us": sum(r["us"] for r in kern.values()), "by_name": kern}
            rows.append(row)
            print(f"    {ls.name:10s} M,K,N={m:>2d},{k:>3d},{n:>3d}: {row['ms']:.5f} ms; {row['kernels']} kernels, "
                  f"{row['device_us']:.2f} µs: " + ", ".join(f"{nm} x{r['count']:.0f} {r['us']:.2f}"
                                                            for nm, r in kern.items()))
    return rows


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


def host_ms(fn, runs: int = 5) -> tuple[float, list[float]]:
    """Median host ms of ``fn()`` ended by ``torch.cuda.synchronize()``,
    over ``runs`` calls after one warm-up call; and the runs."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms)), ms


def print_h100_timings(cm, dev_params: dict, x: dict) -> None:
    """One timed run on the card's own target: each segment's predicted
    cycles against its CUDA-event time in cycles of the target's clock."""
    cm.run(dev_params, x, timed=True)
    f = cm.target.fallback.frequency_hz
    print(f"[cnn] {cm.graph.name} x h100, per segment: predicted cycles against measured (CUDA events around "
          f"the segment's launches, x {f / 1e9:.2f} GHz), measured / predicted")
    for tm in cm.last_timings:
        ratio = tm.measured_cycles / tm.predicted_cycles if tm.predicted_cycles > 0 else float("nan")
        print(f"    {tm.name:24.24s} {tm.module:10s} {tm.route:11s} predicted {tm.predicted_cycles:>9.0f} "
              f"measured {tm.measured_cycles:>10.0f} ({tm.measured_us:8.2f} us) x{ratio:.1f}")
    total = sum(tm.measured_cycles for tm in cm.last_timings)
    print(f"    total: predicted {cm.predicted_cycles():.0f} cycles, measured {total:.0f}")


def print_replay_kernels(where: str, run, gemm_segments: int, calls: int = 10) -> dict:
    """The device kernels of one AOT ``run`` (the input copies, one replay,
    the output copies), by name with count and µs per run (profiler, mean
    of ``calls`` runs), beside the GEMM launches the wrapper counted."""
    before = read_counts()["matmul_requant"]
    kern = device_kernels(run, calls=calls)
    counted = (read_counts()["matmul_requant"] - before) / (calls + 1)  # the warm-up run too
    total = sum(r["count"] for r in kern.values())
    print(f"[cnn] {where}: device kernels of one AOT xla run (profiler, mean of {calls} runs; {gemm_segments} GEMM "
          f"segments, {counted:g} GEMM launches counted per run): {total:.1f} kernels, "
          f"{sum(r['us'] for r in kern.values()):.2f} µs; "
          + "; ".join(f"{nm} x{r['count']:.1f} {r['us']:.2f} µs"
                      for nm, r in sorted(kern.items(), key=lambda kv: -kv[1]["us"])))
    return {"kernels": total, "gemm_launches": counted, "by_name": kern}


def net_request(g, seed: int = 0) -> dict:
    return {k: np.random.default_rng(seed).integers(-128, 128, s).astype(np.float32) for k, s in g.inputs.items()}


def bands_of(cm) -> int:
    """F.conv2d calls per request: one per output band of each conv segment
    that keeps the banded executor (a fused conv segment is one launch)."""
    return sum(-(-int(ls.segment.anchor.attr("OY", 1) or 1) // ls.meta["block_oy"])
               for ls in cm.segments if ls.route == "tiled_conv" and ls.meta.get("kernel") != "conv_requant")


def device_busy_us(fn, calls: int = 3) -> float:
    """Device µs per call of ``fn`` during which some operation of it ran:
    the union of its device operations' intervals (profiler), mean of
    ``calls`` calls after a warm-up.  Unlike their summed durations it
    counts no time twice where a kernel launched early by programmatic
    dependent launch waits beside its predecessor."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / calls


def print_replay_nodes(where: str, entry, segments: int, convs: int) -> dict:
    """The device operations of one replay of an AOT entry's captured graph
    alone (its nodes that run on the card: kernels, copies and fills), by
    the profiler, mean of 3 replays, with the device's busy time; the
    launch counters untouched."""
    replay = lambda: entry.graph.graph.replay()  # noqa: E731
    kern = device_kernels(replay, calls=3)
    busy = device_busy_us(replay)
    nodes = sum(r["count"] for r in kern.values())
    print(f"[cnn] {where}: the AOT graph's replay issues {nodes:.1f} device operations for {segments} segments "
          f"({convs} fused conv segments); the device busy {busy:.2f} µs (their summed durations "
          f"{sum(r['us'] for r in kern.values()):.2f} µs): "
          + "; ".join(f"{nm} x{r['count']:.1f} {r['us']:.2f} µs"
                      for nm, r in sorted(kern.items(), key=lambda kv: -kv[1]["us"])[:8]))
    return {"nodes": nodes, "busy_us": busy, "by_name": kern}


def phase_cnn_path() -> dict:
    """4 nets x 3 targets (gap9, diana and the card's own h100) through
    dispatch -> lower -> run on the card, then through the whole-graph AOT
    executor in both memory modes."""
    nets = mlperf_tiny_networks()
    cells = []
    for net in NETS:
        g = nets[net]
        params = init_graph_params(g)
        cpu_params = params_to_torch(params, "cpu")
        requests = [net_request(g, seed) for seed in range(REQUESTS)]
        refs = [execute_graph(g, cpu_params, x, device="cpu") for x in requests]
        for tgt in TARGETS:
            t0 = time.perf_counter()
            mapped = dispatch(g, tgt, budget=300)
            cm = lower(mapped)  # default device: the card
            compile_s = time.perf_counter() - t0
            dev_params = params_to_torch(params, cm.device)
            gemm_segments = cm.routes().get("pallas_gemm", 0)
            convs = fused_convs(cm)
            bands = bands_of(cm)
            # the main path: counts from 0 just before, read just after
            reset_counts()
            outs, req_ms = [], []
            for x in requests:
                t1 = time.perf_counter()
                out = cm.run(dev_params, x)
                torch.cuda.synchronize()
                req_ms.append((time.perf_counter() - t1) * 1e3)
                outs.append(out)
            counts = read_counts()
            launches = counts["matmul_requant"]
            conv_launches = counts.get("conv_requant", 0)
            check_counts(f"{net}x{tgt}", counts, cnn_counts(gemm_segments, convs, REQUESTS))
            try:
                check_outputs(f"{net}x{tgt}", outs, refs)
            except AssertionError:
                print(cm.verify(params, requests[0], per_segment=True).summary())
                raise
            if launches != gemm_segments * REQUESTS:
                raise AssertionError(
                    f"{net}x{tgt}: {launches} GEMM kernel launches, expected "
                    f"{gemm_segments} segments x {REQUESTS} requests"
                )
            cell = {"net": net, "target": tgt, "launches": launches, "bands": bands, "conv_segments": convs,
                    "conv_launches": conv_launches}
            # the AOT path in each memory mode: warm-up (capture, uncounted),
            # then the requests, counts from 0 just before, read just after
            aot_line = []
            for memory in ("xla", "arena"):
                am = compile_aot(cm, memory=memory)
                entry = am.warmup(params, requests[0])
                reset_counts()
                aot_outs = [am.run(params, x) for x in requests]
                torch.cuda.synchronize()
                counts = read_counts()
                check_counts(f"{net}x{tgt} AOT {memory}", counts, cnn_counts(gemm_segments, convs, REQUESTS))
                check_outputs(f"{net}x{tgt} AOT {memory}", aot_outs, refs)
                for i, (a, e) in enumerate(zip(aot_outs, outs)):
                    if any(not torch.equal(a[k], e[k]) for k in e):
                        raise AssertionError(f"{net}x{tgt} AOT {memory} request {i}: differs from CompiledModel.run")
                # the arena (and the static inputs) reused: the first request again
                again = am.run(params, requests[0])
                check_outputs(f"{net}x{tgt} AOT {memory} rerun", [again], refs[:1])
                cell[f"launches_aot_{memory}"] = counts["matmul_requant"]
                cell[f"conv_launches_aot_{memory}"] = counts.get("conv_requant", 0)
                cell[f"aot_{memory}_capture_ms"] = entry.compile_us / 1e3
                cell[f"aot_{memory}_ms"], runs = host_ms(lambda: am.run(params, requests[0]))
                if memory == "xla" and (net, tgt) in BREAKDOWN_CELLS:
                    cell["replay_kernels"] = print_replay_kernels(f"{net} x {tgt}", lambda: am.run(params, requests[0]),
                                                                  gemm_segments)
                if memory == "xla" and tgt == "h100":
                    cell["replay_nodes"] = print_replay_nodes(f"{net} x {tgt}", entry, len(cm.segments), convs)
                aot_line.append(f"{memory} capture {entry.compile_us / 1e3:.1f} ms"
                                + (f", arena {entry.arena_elems} floats" if memory == "arena" else ""))
            cell["eager_ms"], eager_runs = host_ms(lambda: cm.run(dev_params, requests[0]))
            cells.append(cell)
            print(f"[path] {net:9s} x {tgt:5s}: routes {cm.routes()}, compile {compile_s:.2f} s, "
                  f"bit-exact x{REQUESTS}, GEMM launches {launches}, fused conv launches {conv_launches} "
                  f"({convs} segments x {REQUESTS}), conv bands/request {bands}, "
                  f"ms/request {' '.join(f'{t:.3f}' for t in req_ms)}")
            print(f"[cnn] {net:9s} x {tgt:5s}: AOT bit-exact with CompiledModel.run and the CPU interpreter in both "
                  f"memory modes x{REQUESTS} and a rerun, GEMM launches {cell['launches_aot_xla']} (xla), "
                  f"{cell['launches_aot_arena']} (arena), fused conv launches {cell['conv_launches_aot_xla']} (xla), "
                  f"{cell['conv_launches_aot_arena']} (arena); {'; '.join(aot_line)}; ms per request (median of 5 "
                  f"after a warm-up, host clock to synchronize): eager {cell['eager_ms']:.3f}, AOT xla "
                  f"{cell['aot_xla_ms']:.3f}, AOT arena {cell['aot_arena_ms']:.3f}; eager runs "
                  f"{' '.join(f'{t:.3f}' for t in eager_runs)}")
            if net == "DSCNN" and tgt == "gap9":
                cm.run(dev_params, requests[0], timed=True)
                print(cm.report())
            if tgt == "h100":
                print_h100_timings(cm, dev_params, requests[0])
    bands_by = {(c["net"], c["target"]): c["bands"] for c in cells}
    print("[cnn] conv bands per request (F.conv2d calls), h100 against gap9: "
          + "; ".join(f"{net} {bands_by[net, 'h100']}/{bands_by[net, 'gap9']}" for net in NETS))
    print("[cnn] ms per request, eager / AOT xla / AOT arena: "
          + "; ".join(f"{c['net']}x{c['target']} {c['eager_ms']:.3f} / {c['aot_xla_ms']:.3f} / {c['aot_arena_ms']:.3f}"
                      for c in cells))
    return {"cells": cells, "launches": sum(c["launches"] for c in cells),
            "launches_aot": sum(c["launches_aot_xla"] + c["launches_aot_arena"] for c in cells),
            "conv_launches": sum(c["conv_launches"] for c in cells),
            "conv_launches_aot": sum(c["conv_launches_aot_xla"] + c["conv_launches_aot_arena"] for c in cells)}


def request_stream(g, n: int, seed: int = 0) -> list[dict]:
    """``n`` requests of int8-valued inputs from one generator, as the
    benchmarks draw them."""
    rng = np.random.default_rng(seed)
    return [{k: rng.integers(-128, 128, s).astype(np.float32) for k, s in g.inputs.items()} for _ in range(n)]


def check_same(where: str, outs: list[dict], refs: list[dict]) -> None:
    """Every output on the card and bit-exact with ``CompiledModel.run``'s."""
    if len(outs) != len(refs):
        raise AssertionError(f"{where}: {len(outs)} outputs for {len(refs)} inputs")
    for i, (out, ref) in enumerate(zip(outs, refs)):
        for name, want in ref.items():
            got = out[name]
            if got.device.type != "cuda" or tuple(got.shape) != tuple(want.shape) or not torch.equal(got, want):
                raise AssertionError(f"{where} input {i}: {name} differs from CompiledModel.run")


def phase_pipeline() -> dict:
    """benchmarks/pipeline_throughput.py on the card: 4 nets x {gap9, diana,
    ne16_octa}, 12 inputs through ``PipelinedModel.run_stream`` (one CUDA
    stream per module lane, 3 inputs in flight), per-segment and with each
    lane chain a captured graph (aot), each streamed run repeated and held
    bit-exact with ``CompiledModel.run`` with exact GEMM launches; µs per
    input sequential against streamed (host clock to the last output,
    median of the repeats) beside the schedule's predicted speedups."""
    nets = mlperf_tiny_networks()
    cells = []
    launches = 0
    for net in NETS:
        g = nets[net]
        params = init_graph_params(g)
        xs = request_stream(g, PIPE_INPUTS)
        cpu_first = execute_graph(g, params_to_torch(params, "cpu"), xs[0], device="cpu")
        for tgt in PIPE_TARGETS:
            cm = lower(dispatch(g, tgt, budget=300))
            dev_params = params_to_torch(params, cm.device)
            gemms = cm.routes().get("pallas_gemm", 0)
            convs = fused_convs(cm)
            refs = [cm.run(dev_params, x) for x in xs]
            check_outputs(f"[pipeline] {net}x{tgt} sequential", refs[:1], [cpu_first])
            seq_ms, _ = host_ms(lambda: [cm.run(dev_params, x) for x in xs], runs=PIPE_REPEATS)
            ps = cm.pipeline_schedule()
            busy = ps.module_busy()
            cell = {"net": net, "target": tgt, "lanes": len(ps.lanes()), "seq_us": seq_ms * 1e3 / PIPE_INPUTS,
                    "predicted_speedup": ps.speedup(),
                    "predicted_stream": ps.sequential_cycles() / max(busy.values())}
            for aot in (False, True):
                where = f"[pipeline] {net}x{tgt} aot={aot}"
                pm = PipelinedModel(cm, stream_depth=PIPE_DEPTH, aot=aot)
                check_same(where + " warm-up", pm.run_stream(dev_params, xs), refs)  # captures (aot)
                times = []
                for _ in range(PIPE_REPEATS):
                    reset_counts()
                    t0 = time.perf_counter()
                    outs = pm.run_stream(dev_params, xs)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    counts = read_counts()
                    check_counts(where, counts, cnn_counts(gemms, convs, PIPE_INPUTS))
                    check_same(where, outs, refs)
                    launches += counts["matmul_requant"]
                cell[f"stream_us_aot_{aot}"] = float(np.median(times)) * 1e6 / PIPE_INPUTS
                del pm
            cells.append(cell)
            print(f"[pipeline] {net:9s} x {tgt:9s}: {cell['lanes']} lanes, bit-exact x{PIPE_REPEATS} streamed runs "
                  f"per mode, GEMM launches {gemms} x {PIPE_INPUTS} per run; us per input sequential "
                  f"{cell['seq_us']:.1f}, streamed {cell['stream_us_aot_False']:.1f} (segments) / "
                  f"{cell['stream_us_aot_True']:.1f} (captured chains); measured sequential/streamed "
                  f"x{cell['seq_us'] / cell['stream_us_aot_False']:.2f} / x{cell['seq_us'] / cell['stream_us_aot_True']:.2f}; "
                  f"predicted: predicted_speedup() x{cell['predicted_speedup']:.2f}, stream bound (sequential "
                  f"cycles / busiest module) x{cell['predicted_stream']:.2f}")
    return {"cells": cells, "launches": launches}


def slo_specs() -> list:
    """benchmarks/serve_load.py's objectives, generous by construction: a
    normal sweep must verdict ok."""
    return [
        SloSpec("p99_budget", "latency_p99_us", 300e6, description="tail budget"),
        SloSpec("rejections", "rejection_rate", 0.25, description="shed bound"),
    ]


def time_calls(obj, name: str, sink: list) -> None:
    """Replace the method ``obj.name`` on this instance by one that appends
    each call's host ms (``time.perf_counter``) to ``sink``."""
    fn = getattr(obj, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            sink.append((time.perf_counter() - t0) * 1e3)
    setattr(obj, name, timed)


def serve_host_ms(span_s: float, host: dict) -> dict:
    """The serving thread's host ms over one round of load: its rounds in
    all, and per batch the launch (``run_batch_async``: stacking, the
    copies in, the replay), the wait on the batch's CUDA event and the
    resolution of its requests (``_resolve``); in ``pipeline`` mode the
    launch and wait are inside ``run_stream``, counted in ``other_ms``."""
    rounds, resolve = sum(host["round"]), sum(host["resolve"])
    out = {"span_ms": span_s * 1e3, "rounds_ms": rounds, "resolve_ms": resolve,
           "launch_ms": sum(host["launch"]), "finish_ms": sum(host["finish"])}
    out["wait_ms"] = out["finish_ms"] - resolve if host["finish"] else None
    # the rest of the rounds: shedding, the stream schedule, padding, stats
    out["other_ms"] = rounds - out["launch_ms"] - (out["finish_ms"] if host["finish"] else resolve)
    out["idle_ms"] = out["span_ms"] - rounds  # between rounds: the queue's take
    return out


def serve_round(cm, dev_params: dict, xs: list[dict], refs: list[dict], rate_rps: float, mode: str) -> dict:
    """One open-loop Poisson round (seed 1) at ``rate_rps`` through a
    16-slot replica, every served row held against ``refs``; launches
    counted from 0 after the warm-up; the serving thread's host ms by step
    (:func:`serve_host_ms`), timed from the warm-up on."""
    gemms = cm.routes().get("pallas_gemm", 0)
    convs = fused_convs(cm)
    rng = np.random.default_rng(1)
    host = {"round": [], "launch": [], "finish": [], "resolve": []}
    with ModelServer(cm, dev_params, batch_slots=SERVE_BATCH, stream_depth=SERVE_DEPTH, queue_capacity=len(xs),
                     mode=mode, slo=slo_specs()) as srv:
        srv.warmup(xs[0])  # the batch graph captured before load arrives
        torch.cuda.synchronize()
        for obj, name, key in ((srv, "_serve_round", "round"), (srv.batched, "run_batch_async", "launch"),
                               (srv, "_finish", "finish"), (srv, "_resolve", "resolve")):
            time_calls(obj, name, host[key])
        reset_counts()
        arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, size=len(xs)))
        t0 = time.perf_counter()
        handles = []
        for x, due in zip(xs, arrivals):
            delay = t0 + due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            handles.append(srv.submit(x))
        outs = [h.result(timeout=300) for h in handles]
        torch.cuda.synchronize()
        span_s = time.perf_counter() - t0
    stats = srv.stats()
    where = f"[cnn-serve] {cm.graph.name}x{cm.target.name} {mode}"
    counts = read_counts()
    check_counts(where, counts, cnn_counts(gemms, convs, stats["batches"]))
    check_same(where, outs, refs)
    if stats["completed"] != len(xs) or stats["rejected"] or not stats["drained"]:
        raise AssertionError(f"{where}: stats {stats}")
    return {"sustained_rps": len(xs) / span_s, "p50_us": stats["latency_us"]["p50"],
            "p99_us": stats["latency_us"]["p99"], "batches": stats["batches"], "rounds": stats["rounds"],
            "launches": counts["matmul_requant"], "slo_breached": stats["slo"]["breached"],
            "capture_ms": {e["batch"]: e["compile_us"] / 1e3 for e in stats["entries"]},
            "host": serve_host_ms(span_s, host)}


def phase_cnn_serve() -> dict:
    """benchmarks/serve_load.py on the card: DAE and DS-CNN x {gap9,
    ne16_octa, h100}, 96 requests offered open-loop at 6x the measured
    sequential rate to a replica of 16 slots and 2 batches in flight, in
    both modes; every served row bit-exact with the sequential run, which
    is bit-exact with the CPU interpreter."""
    nets = mlperf_tiny_networks()
    cells = []
    for net in SERVE_NETS:
        g = nets[net]
        params = init_graph_params(g)
        xs = request_stream(g, SERVE_N)
        cpu_params = params_to_torch(params, "cpu")
        cpu_refs = [execute_graph(g, cpu_params, x, device="cpu") for x in xs]
        for tgt in SERVE_TARGETS:
            cm = lower(dispatch(g, tgt, budget=300))
            dev_params = params_to_torch(params, cm.device)
            refs = [cm.run(dev_params, x) for x in xs]
            check_outputs(f"[cnn-serve] {net}x{tgt} sequential", refs, cpu_refs)
            seq_ms, _ = host_ms(lambda: [cm.run(dev_params, x) for x in xs], runs=3)
            seq_rps = SERVE_N / (seq_ms / 1e3)
            cell = {"net": net, "target": tgt, "seq_rps": seq_rps, "gemm_segments": cm.routes().get("pallas_gemm", 0)}
            for mode in ("aot", "pipeline"):
                r = serve_round(cm, dev_params, xs, refs, SERVE_OFFERED_X * seq_rps, mode)
                cell[mode] = r
                print(f"[cnn-serve] {net:5s} x {tgt:9s} {mode:8s}: bit-exact x{SERVE_N} with CompiledModel.run and "
                      f"the CPU interpreter (batch {SERVE_BATCH}, padded), {r['batches']} batches in {r['rounds']} "
                      f"rounds, GEMM launches {r['launches']} = {cell['gemm_segments']} x {r['batches']}; "
                      f"rps sequential {seq_rps:.1f}, offered {SERVE_OFFERED_X * seq_rps:.1f}, sustained "
                      f"{r['sustained_rps']:.1f} (x{r['sustained_rps'] / seq_rps:.2f}); latency us p50 "
                      f"{r['p50_us']:.0f} p99 {r['p99_us']:.0f}; capture ms per batch shape {r['capture_ms']}; "
                      f"SLO {'breached' if r['slo_breached'] else 'ok'}")
                h, nb = r["host"], r["batches"]
                split, rest = ((f"launch {h['launch_ms'] / nb:.3f}, wait {h['wait_ms'] / nb:.3f}, ", "the rest")
                               if h["wait_ms"] is not None else ("", "run_stream (launch and wait) and the rest"))
                print(f"[cnn-serve] {net:5s} x {tgt:9s} {mode:8s}: serving thread host ms over the load's "
                      f"{h['span_ms']:.3f}: rounds {h['rounds_ms']:.3f} (idle between rounds {h['idle_ms']:.3f}); "
                      f"per batch {h['rounds_ms'] / nb:.3f}: {split}resolve {h['resolve_ms'] / nb:.3f}, "
                      f"{rest} of the round {h['other_ms'] / nb:.3f}")
                if r["slo_breached"]:
                    raise AssertionError(f"[cnn-serve] {net}x{tgt} {mode}: the generous SLOs breached")
            cells.append(cell)
    return {"cells": cells, "launches": sum(c[m]["launches"] for c in cells for m in ("aot", "pipeline"))}


def calibrated_net(g, target, params: dict, x: dict, ref: dict, where: str) -> dict:
    """One net on ``target``: segments per module, the (module, route) of each
    segment anchor, conv bands per request, eager and AOT xla ms per request
    (median of 5 after a warm-up), both bit-exact with the CPU interpreter."""
    cm = lower(dispatch(g, target, budget=300))
    dev_params = params_to_torch(params, cm.device)
    check_outputs(f"{where} eager", [cm.run(dev_params, x)], [ref])
    am = compile_aot(cm, memory="xla")
    am.warmup(params, x)
    check_outputs(f"{where} AOT xla", [am.run(params, x)], [ref])
    eager_ms, _ = host_ms(lambda: cm.run(dev_params, x))
    aot_ms, _ = host_ms(lambda: am.run(params, x))
    modules: dict[str, int] = {}
    for ls in cm.segments:
        modules[ls.module] = modules.get(ls.module, 0) + 1
    return {"modules": modules, "anchors": {ls.segment.anchor.name: (ls.module, ls.route) for ls in cm.segments},
            "segments": len(cm.segments), "bands": bands_of(cm), "eager_ms": eager_ms, "aot_xla_ms": aot_ms,
            "predicted_cycles": cm.predicted_cycles()}


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
        x = net_request(g)
        ref = execute_graph(g, params_to_torch(params, "cpu"), x, device="cpu")
        d = calibrated_net(g, declared, params, x, ref, f"[calibrate] {net} declared")
        c = calibrated_net(g, fitted, params, x, ref, f"[calibrate] {net} fitted")
        moved: dict[str, list[str]] = {}
        for a, was in d["anchors"].items():
            now = c["anchors"].get(a, was)
            if now != was:
                moved.setdefault(f"{'/'.join(was)} -> {'/'.join(now)}", []).append(a)
        print(f"[calibrate] {net:9s} x h100 declared / fitted: segments {d['segments']} / {c['segments']}, by module "
              f"{d['modules']} / {c['modules']}; conv bands per request {d['bands']} / {c['bands']}; ms per request "
              f"eager {d['eager_ms']:.3f} / {c['eager_ms']:.3f}, AOT xla {d['aot_xla_ms']:.3f} / {c['aot_xla_ms']:.3f} "
              f"(median of 5); predicted cycles {d['predicted_cycles']:.0f} / {c['predicted_cycles']:.0f}; bit-exact "
              f"with the CPU interpreter under both; anchors moved: "
              + ("; ".join(f"{k} x{len(v)} ({' '.join(v)})" for k, v in moved.items()) or "none"))
    counts = read_counts()
    check_counts("[calibrate]", counts, with_zeros({k: counts[k] for k in ("matmul_requant", "conv_requant")
                                                    if k in counts}))
    if counts["matmul_requant"] == 0:
        raise AssertionError("[calibrate] no matmul_requant launch: the dense sweep missed the GEMM")
    print(f"[calibrate] {time.perf_counter() - t0:.1f} s in all; matmul_requant launches {counts['matmul_requant']}, "
          f"conv_requant launches {counts.get('conv_requant', 0)}")
    return {"launches": counts["matmul_requant"], "conv_launches": counts.get("conv_requant", 0)}


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
          f"{counts.get('conv_requant', 0)}")
    print(f"[fuzz] GEMM segment (M, K, N) reached: {len(shapes)} distinct, {len(odd)} with K or N not divisible by 4: "
          + " ".join(f"{m}x{k}x{n}" for m, k, n in sorted(shapes)))
    for where, f in failures:
        print(f"[fuzz] FAIL {where} target={f.target} invariant={f.invariant} stage={f.stage}: {f.message}")
    check_counts("[fuzz]", counts, with_zeros({k: counts[k] for k in ("matmul_requant", "conv_requant") if k in counts}))
    if failures:
        raise AssertionError(f"[fuzz] {len(failures)} failures")
    if counts["matmul_requant"] == 0:
        raise AssertionError("[fuzz] no matmul_requant launch: the fuzz graphs' dense heads missed the GEMM")
    if counts.get("conv_requant", 1) == 0:
        raise AssertionError("[fuzz] no conv_requant launch: the fuzz graphs' convs missed the fused conv")
    return {"launches": counts["matmul_requant"], "conv_launches": counts.get("conv_requant", 0), "cases": cases,
            "failures": len(failures)}


def off_by_one(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` whose storage starts one element past an
    allocation: every row is one element off 16 bytes."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def flash_operands(B, H, KV, Sq, Sk, D, dtype, seed, *, bshd=False, misaligned=False):
    """q (B, H, Sq, D) and k, v (B, KV, Sk, D) on the card, rounded to
    ``dtype`` from float32 normals.  With ``bshd`` each is the (B, H, S, D)
    view of (B, S, H, D) storage, as the model passes its activations; with
    ``misaligned`` each starts one element off 16 bytes."""
    rng = np.random.default_rng(seed)

    def mk(b, h, s, d):
        if bshd:
            x = rng.normal(size=(b, s, h, d)).astype(np.float32)
            return torch.from_numpy(x).to(DEV, dtype).transpose(1, 2)
        x = torch.from_numpy(rng.normal(size=(b, h, s, d)).astype(np.float32)).to(DEV, dtype)
        return off_by_one(x) if misaligned else x

    return mk(B, H, Sq, D), mk(B, KV, Sk, D), mk(B, KV, Sk, D)


def phase_flash_kernel() -> dict:
    """The flash kernel against its plain version on the card, within
    the reference kernel test's tolerance; max |kernel - plain| printed."""
    cfg, rg = get_config(LM_ARCH), get_config(RG_ARCH)
    H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim_
    cases = []  # (label, B, H, KV, Sq, Sk, D, dtype, kwargs, bshd, misaligned)
    for dtype in (torch.float32, torch.bfloat16):
        for B_, H_, KV_, S, D_ in FLASH_GRID:
            for causal in (True, False):
                cases.append(("grid", B_, H_, KV_, S, S, D_, dtype, {"causal": causal}, False, False))
        for Sq, Sk in ((16, 64), (1, 40), (24, 300)):
            cases.append(("q_offset", 2, 4, 2, Sq, Sk, 32, dtype, {"q_offset": Sk - Sq}, False, False))
        for Sq, Sk, off, causal, win in ((64, 64, 0, True, 16), (32, 64, 32, True, 8), (64, 64, 0, False, 24),
                                         (8, 32, 100, True, 4), (40, 300, 260, True, 70)):
            cases.append(("window", 2, 4, 2, Sq, Sk, 32, dtype,
                          {"causal": causal, "q_offset": off, "window": win}, False, False))
        for S in (5, 24, 37):
            for causal in (True, False):
                cases.append(("ragged", 2, 4, 1, S, S, 24, dtype, {"causal": causal}, False, False))
        for S in (4, 17, 24, 35):  # serving: the engine's prompt lengths and past them
            cases.append(("serve", 4, H, KV, S, S, D, dtype, {"causal": True}, True, False))
            cases.append(("rgemma", 4, rg.n_heads, rg.kv_heads, S, S, rg.head_dim_, dtype,
                          {"causal": True, "window": rg.local_window}, True, False))
        # recurrentgemma's head shape with a window that bites
        cases.append(("rgemma", 1, rg.n_heads, rg.kv_heads, 300, 300, rg.head_dim_, dtype,
                      {"causal": True, "window": 64}, True, False))
        # rows one element off 16 bytes: bf16 stages them by element loads
        for D_, causal in ((128, True), (24, False), (256, True)):
            cases.append(("misaligned", 2, 4, 2, 70, 70, D_, dtype, {"causal": causal}, False, True))
        # rows with no valid key (positions < 0 under the causal mask) average v over all keys
        for Sq, Sk, off in ((64, 64, -10), (100, 80, -30), (5, 130, -7)):
            cases.append(("masked rows", 2, 4, 2, Sq, Sk, 64, dtype, {"causal": True, "q_offset": off}, False, False))
    # the bf16 tensor-core path at ragged head dims and lengths, causal end-aligned and not
    for D_ in FLASH_BF16_D:
        for Sq in FLASH_BF16_S:
            for Sk in FLASH_BF16_S:
                cases.append((f"bf16 D={D_}", 1, 4, 2, Sq, Sk, D_, torch.bfloat16,
                              {"causal": True, "q_offset": Sk - Sq}, False, False))
                cases.append((f"bf16 D={D_}", 1, 4, 2, Sq, Sk, D_, torch.bfloat16, {"causal": False}, False, False))
    worst: dict[str, float] = {}
    for i, (label, B, H_, KV_, Sq, Sk, D_, dtype, kw, bshd, misaligned) in enumerate(cases):
        q, k, v = flash_operands(B, H_, KV_, Sq, Sk, D_, dtype, seed=i, bshd=bshd, misaligned=misaligned)
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, **kw)
        if got.dtype != dtype or got.shape != q.shape or not torch.isfinite(got).all():
            raise AssertionError(f"flash {label} {(B, H_, KV_, Sq, Sk, D_)} {dtype} {kw}: bad output")
        diff = (got.float() - want.float()).abs()
        tol = FLASH_TOL[dtype]
        if bool((diff > tol + tol * want.float().abs()).any()):
            raise AssertionError(
                f"flash {label} {(B, H_, KV_, Sq, Sk, D_)} {dtype} {kw}: max |kernel - plain| "
                f"= {float(diff.max()):.3g} beyond atol = rtol = {tol}"
            )
        key = f"{label} {str(dtype).split('.')[-1]}"
        worst[key] = max(worst.get(key, 0.0), float(diff.max()))
    print(f"[kernels] flash_attention within tolerance of flash_attention_plain on {len(cases)} cases "
          f"(f32 atol=rtol=2e-5, bf16 2e-2); max |kernel - plain| per group:")
    for key, err in worst.items():
        print(f"    {key:22s} {err:.3e}")
    return {
        "max_abs_err": max(worst.values()),
        "max_abs_err_f32": max(e for k, e in worst.items() if k.endswith("float32")),
    }


def flash_bound_ms(B, H, KV, S, D) -> tuple[float, str]:
    """Causal bf16 attention: max(bytes / HBM rate, flops / bf16
    tensor-core rate), q, k, v read once and o written once (2 bytes an
    element), 4·B·H·S·S·D flops halved by the causal mask."""
    return bound(2 * (2 * B * H * S * D + 2 * B * KV * S * D), 4 * B * H * S * S * D * 0.5, BF16_FLOPS_S)


def phase_flash_timing() -> list[dict]:
    """Times at qwen2.5-3b's prefill shapes, bf16, causal."""
    cfg = get_config(LM_ARCH)
    H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim_
    print(f"[kernels] flash_attention at {LM_ARCH} prefill shapes (H={H}, KV={KV}, D={D}, bf16, causal), "
          "ms per call; graph = device time in a CUDA graph, eager = launched from Python, "
          "library = F.scaled_dot_product_attention(is_causal, enable_gqa), timed only; "
          "before = the CUDA-core kernel (PERF.md)")
    print(f"    {'B':>2s} {'S':>5s} {'kernel':>10s} {'kern eager':>10s} {'plain':>10s} "
          f"{'library':>10s} {'bound':>10s} {'':12s} {'before':>10s}")
    rows = []
    for B, S in FLASH_TIMED:
        q, k, v = flash_operands(B, H, KV, S, S, D, torch.bfloat16, seed=S, bshd=True)
        iters = 200 if S <= 512 else 20
        row = {
            "shape": [B, H, KV, S, D],
            "ms": graph_ms(lambda: flash_attention(q, k, v, causal=True), iters),
            "eager_ms": eager_ms(lambda: flash_attention(q, k, v, causal=True), iters),
            "plain_ms": graph_ms(lambda: flash_attention_plain(q, k, v, causal=True), iters),
            "library_ms": graph_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True), iters
            ),
        }
        row["bound_ms"], row["bound_by"] = flash_bound_ms(B, H, KV, S, D)
        rows.append(row)
        print(f"    {B:>2d} {S:>5d} {row['ms']:>10.5f} {row['eager_ms']:>10.5f} {row['plain_ms']:>10.5f} "
              f"{row['library_ms']:>10.5f} {row['bound_ms']:>10.6f} {'(' + row['bound_by'] + ')':12s} "
              f"{BEFORE_MS['flash', (B, S)]:>10.5f}")
    return rows


def window_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal attention over S tokens keeps when each
    query sees the ``window`` keys up to itself."""
    w = min(S, window)
    return w * (w + 1) // 2 + (S - w) * w


def phase_rg_flash_timing() -> list[dict]:
    """Times at recurrentgemma-2b's local attention, bf16, causal, window."""
    cfg = get_config(RG_ARCH)
    H, KV, D, W = cfg.n_heads, cfg.kv_heads, cfg.head_dim_, cfg.local_window
    print(f"[kernels] flash_attention at {RG_ARCH} local attention (H={H}, KV={KV}, D={D}, bf16, causal, "
          f"window {W}), ms per call; library = F.scaled_dot_product_attention with the boolean window mask "
          "(enable_gqa), timed only; before = the CUDA-core kernel (PERF.md)")
    print(f"    {'B':>2s} {'S':>5s} {'kernel':>10s} {'kern eager':>10s} {'plain':>10s} "
          f"{'library':>10s} {'bound':>10s} {'':12s} {'before':>10s}")
    rows = []
    for B, S in RG_FLASH_TIMED:
        q, k, v = flash_operands(B, H, KV, S, S, D, torch.bfloat16, seed=S + 1, bshd=True)
        i = torch.arange(S, device=DEV)
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < W)
        iters = 200 if S <= 512 else 20
        row = {
            "shape": [B, H, KV, S, D, W],
            "ms": graph_ms(lambda: flash_attention(q, k, v, causal=True, window=W), iters),
            "eager_ms": eager_ms(lambda: flash_attention(q, k, v, causal=True, window=W), iters),
            "plain_ms": graph_ms(lambda: flash_attention_plain(q, k, v, causal=True, window=W), iters),
            "library_ms": graph_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True), iters
            ),
        }
        # q, k, v read once and o written once (2 bytes an element); 4 B H D
        # flops per kept (query, key) pair at the bf16 tensor-core rate
        nbytes = 2 * (2 * B * H * S * D + 2 * B * KV * S * D)
        row["bound_ms"], row["bound_by"] = bound(nbytes, 4 * B * H * D * window_pairs(S, W), BF16_FLOPS_S)
        rows.append(row)
        print(f"    {B:>2d} {S:>5d} {row['ms']:>10.5f} {row['eager_ms']:>10.5f} {row['plain_ms']:>10.5f} "
              f"{row['library_ms']:>10.5f} {row['bound_ms']:>10.6f} {'(' + row['bound_by'] + ')':12s} "
              f"{BEFORE_MS['rg_flash', (B, S)]:>10.5f}")
    return rows


def gmm_operands(E, C, D, F, dtype, seed, *, layout="dense"):
    """x (E, C, D) normal and w (E, D, F) normal / sqrt(D) on the card in
    ``dtype``.  ``layout="strided"``: x is the (E, C, D) view of (C, E, D)
    storage; ``"misaligned"``: x and w each start one element off 16
    bytes."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32)).to(DEV, dtype)
    if layout == "strided":
        x = torch.from_numpy(rng.normal(size=(C, E, D)).astype(np.float32)).to(DEV, dtype).transpose(0, 1)
    else:
        x = torch.from_numpy(rng.normal(size=(E, C, D)).astype(np.float32)).to(DEV, dtype)
    if layout == "misaligned":
        x, w = off_by_one(x), off_by_one(w)
    return x, w


def granite_gmm_shapes() -> list[tuple[str, int, int, int, int]]:
    """(name, E, C, D, F) of granite-moe-3b-a800m's three expert GEMMs at
    the serving engine's 4 slots: C = 4 rows x capacity 8."""
    cfg = get_config(MOE_ARCH)
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    C = SERVE_SLOTS * 8
    return [("wi", E, C, D, F), ("wo", E, C, F, D)]


GRANITE_ARCH = "granite_4_0_h_small"


def granite_h_gmm_shapes() -> list[tuple[str, int, int, int, int]]:
    """(name, E, C, D, F) of granite-4.0-h-small's expert GEMMs at batch 1:
    a decode step's 8 slots an expert, and an eager prefill's 256 and 512
    (a 1,024-token prompt's power-of-two layouts)."""
    cfg = get_config(GRANITE_ARCH)
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    return [(f"{C} {name}", E, C, *dims) for C in (8, 256, 512) for name, dims in (("wi", (D, F)), ("wo", (F, D)))]


def granite_h_rows(E: int, C: int, g: torch.Generator) -> torch.Tensor:
    """(1, E) int32 routed rows on the card at granite-4.0-h-small's
    layouts: at C = 8 a decode's top-k experts hold one pair each, else a
    prefill's ragged counts from C / 4 to 3 C / 4, one expert in ten empty."""
    if C == 8:
        return (torch.randperm(E, generator=g) < get_config(GRANITE_ARCH).top_k).int()[None].to(DEV)
    counts = torch.randint(C // 4, 3 * C // 4 + 1, (1, E), generator=g, dtype=torch.int32)
    return (counts * (torch.rand((1, E), generator=g) >= 0.1)).int().to(DEV)


def phase_moe_gmm_kernel() -> dict:
    """The grouped expert GEMM against its plain version on the card,
    granite-4.0-h-small's shapes with and without the routed rows."""
    cases = []  # (label, E, C, D, F, dtype, layout, routed)
    g = torch.Generator().manual_seed(30)
    for dtype in (torch.float32, torch.bfloat16):
        cases += [("grid", *s, dtype, "dense") for s in GMM_GRID]
        cases += [("ragged", *s, dtype, lay) for s in GMM_RAGGED for lay in ("dense", "strided")]
        cases += [("granite", *s[1:], dtype, "dense") for s in granite_gmm_shapes()]
        cases += [("granite", s[1], 16, *s[3:], dtype, "dense") for s in granite_gmm_shapes()]  # a refill's C
        cases += [("granite C=8", s[1], 8, *s[3:], dtype, "dense") for s in granite_gmm_shapes()]  # one slot's decode
        cases += [("granite", *s[1:], dtype, "strided") for s in granite_gmm_shapes()]  # (C, E, D) storage
        cases += [("misaligned", *s, dtype, "misaligned") for s in ((3, 37, 64, 72), (2, 33, 100, 65))]
        cases += [("misaligned", *s[1:], dtype, "misaligned") for s in granite_gmm_shapes()]
        cases += [(f"granite-4.0-h{' rows' if r else ''}", *s[1:], dtype, "dense", r)
                  for s in granite_h_gmm_shapes() for r in (False, True)]
    cases = [c if len(c) == 8 else (*c, False) for c in cases]
    worst: dict[str, float] = {}
    for i, (label, E, C, D, F, dtype, layout, routed) in enumerate(cases):
        x, w = gmm_operands(E, C, D, F, dtype, seed=i, layout=layout)
        rows = granite_h_rows(E, C, g) if routed else None
        got = moe_gmm(x, w, rows)
        torch.cuda.synchronize()
        want = moe_gmm_plain(x, w, rows)
        if got.dtype != dtype or got.shape != (E, C, F) or not torch.isfinite(got).all():
            raise AssertionError(f"moe_gmm {label} {(E, C, D, F)} {dtype}: bad output")
        diff = (got.float() - want.float()).abs()
        tol = GMM_TOL[dtype]
        if bool((diff > tol + tol * want.float().abs()).any()):
            raise AssertionError(
                f"moe_gmm {label} {(E, C, D, F)} {dtype} {layout}: max |kernel - plain| "
                f"= {float(diff.max()):.3g} beyond atol = rtol = {tol}"
            )
        key = f"{label} {str(dtype).split('.')[-1]}"
        worst[key] = max(worst.get(key, 0.0), float(diff.max()))
    print(f"[kernels] moe_gmm within tolerance of moe_gmm_plain on {len(cases)} cases "
          f"(f32 atol=rtol=1e-4, bf16 2e-2); max |kernel - plain| per group:")
    for key, err in worst.items():
        print(f"    {key:22s} {err:.3e}")
    return {"max_abs_err": max(worst.values()),
            "max_abs_err_f32": max(e for k, e in worst.items() if k.endswith("float32"))}


def phase_moe_gmm_timing() -> list[dict]:
    """Times at granite-moe-3b-a800m's serving shapes, bf16."""
    print(f"[kernels] moe_gmm at {MOE_ARCH} serving shapes (bf16), ms per call; graph = device time in a "
          "CUDA graph, eager = launched from Python, library = torch.bmm, timed only; before = the CUDA-core kernel "
          "(PERF.md)")
    print(f"    {'GEMM':>4s} {'E':>3s} {'C':>3s} {'D':>5s} {'F':>5s} {'kernel':>9s} {'kern eager':>10s} "
          f"{'plain':>9s} {'library':>9s} {'bound':>9s} {'':9s} {'before':>9s}")
    rows = []
    for name, E, C, D, F in granite_gmm_shapes():
        x, w = gmm_operands(E, C, D, F, torch.bfloat16, seed=D)
        row = {
            "shape": [E, C, D, F],
            "ms": graph_ms(lambda: moe_gmm(x, w)),
            "eager_ms": eager_ms(lambda: moe_gmm(x, w)),
            "plain_ms": graph_ms(lambda: moe_gmm_plain(x, w)),
            "library_ms": graph_ms(lambda: torch.bmm(x, w)),
        }
        # x and w read once, y written once (2 bytes an element); 2 E C D F flops
        row["bound_ms"], row["bound_by"] = bound(2 * (E * C * D + E * D * F + E * C * F), 2 * E * C * D * F,
                                                 BF16_FLOPS_S)
        rows.append(row)
        print(f"    {name:>4s} {E:>3d} {C:>3d} {D:>5d} {F:>5d} {row['ms']:>9.5f} {row['eager_ms']:>10.5f} "
              f"{row['plain_ms']:>9.5f} {row['library_ms']:>9.5f} {row['bound_ms']:>9.6f} "
              f"{'(' + row['bound_by'] + ')':9s} {BEFORE_MS['moe_gmm', name]:>9.5f}")
    return rows


def phase_moe_gmm_routed() -> list[dict]:
    """``moe_gmm`` at granite-4.0-h-small's expert products (bf16) given the
    routed rows, beside the same call without them: the decode at batch 1
    (C = 8, top-10 of 72 experts, one pair each; each call of the timed
    loop routes to another of 8 draws of experts, as the layers do) and an
    eager prefill's layout (C = 256, 100-190 pairs an expert).  Checked
    first: within 2e-2 of the plain product with the same rows, and bit
    for bit against the call without rows on the filled rows, 0 on the
    rest.  ``empty_ms``: every expert empty (every block exits);
    the bound: the routed experts' weights and the pairs' rows over
    3.35 TB/s, or their operations."""
    cfg = get_config(GRANITE_ARCH)
    E, K = cfg.n_experts, cfg.top_k
    print(f"[kernels] moe_gmm at {GRANITE_ARCH}'s expert products (bf16), ms per call in a CUDA graph, with the "
          f"routed rows and without; bound = routed bytes / 3.35 TB/s or operations; hbm = the routed weights' "
          f"bytes/s over 3.35 TB/s")
    print(f"    {'GEMM':>10s} {'E':>3s} {'C':>4s} {'D':>5s} {'F':>5s} {'rows ms':>9s} {'all ms':>9s} {'empty ms':>9s} "
          f"{'bound':>9s} {'':12s} {'hbm':>6s}")
    out = []
    g = torch.Generator().manual_seed(30)
    wi, wo = (cfg.d_model, cfg.moe_d_ff), (cfg.moe_d_ff, cfg.d_model)
    for name, C, D, F in (("decode wi", 8, *wi), ("decode wo", 8, *wo),
                          ("prefill wi", 256, *wi), ("prefill wo", 256, *wo)):
        x, w = gmm_operands(E, C, D, F, torch.bfloat16, seed=C + D)
        if C == 8:
            routings = [(torch.randperm(E, generator=g) < K).int()[None].to(DEV) for _ in range(8)]
        else:
            routings = [torch.randint(100, 191, (1, E), generator=g, dtype=torch.int32).to(DEV)]
        full = moe_gmm(x, w)
        for rows in routings:
            got = moe_gmm(x, w, rows)
            filled = (torch.arange(C, device=DEV)[None, :] < rows[0][:, None])[..., None].expand_as(got)
            if not torch.equal(got[filled], full[filled]) or bool(got[~filled].any()):
                raise AssertionError(f"moe_gmm {name} with rows: not the product on filled rows and 0 elsewhere")
            want = moe_gmm_plain(x, w, rows).float()
            tol = GMM_TOL[torch.bfloat16]
            if bool(((got.float() - want).abs() > tol + tol * want.abs()).any()):
                raise AssertionError(f"moe_gmm {name} with rows: beyond atol = rtol = {tol} of moe_gmm_plain")
        turn = iter(range(1 << 30))
        empty = torch.zeros_like(routings[0])
        pairs = int(sum(int(r.sum()) for r in routings)) / len(routings)
        experts = min(E, pairs) if C == 8 else E
        row = {"gemm": name, "shape": [E, C, D, F], "pairs": pairs,
               "ms": graph_ms(lambda: moe_gmm(x, w, routings[next(turn) % len(routings)])),
               "all_ms": graph_ms(lambda: moe_gmm(x, w)),
               "empty_ms": graph_ms(lambda: moe_gmm(x, w, empty))}
        row["bound_ms"], row["bound_by"] = bound(2 * (experts * D * F + pairs * (D + F)), 2 * pairs * D * F,
                                                 BF16_FLOPS_S)
        row["hbm_share"] = 2 * experts * D * F / (row["ms"] * 1e-3) / HBM_BYTES_S
        out.append(row)
        print(f"    {name:>10s} {E:>3d} {C:>4d} {D:>5d} {F:>5d} {row['ms']:>9.5f} {row['all_ms']:>9.5f} "
              f"{row['empty_ms']:>9.5f} {row['bound_ms']:>9.6f} {'(' + row['bound_by'] + ')':12s} "
              f"{row['hbm_share']:>6.1%}")
    return out


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


def phase_ssd_kernel() -> dict:
    """The SSD chunk scan against its plain version (y and the final
    state) and, where T is short, the sequential oracle, on the card."""
    cfg = get_config(SSD_ARCH)
    H, P, N = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state
    shapes = [("grid", *s) for s in SSD_GRID] + [("ragged", *s) for s in SSD_RAGGED]
    shapes += [("mamba2", SERVE_SLOTS, H, T, P, N) for T in (4, 24, 35)] + [("mamba2", 1, H, 200, P, N)]
    shapes = [(*s, 0.2) for s in shapes]  # (..., decay)
    # many chunks at full width: a long prefill, the [lm-bf16] prefill, and a
    # ragged last chunk; then states carried across every chunk
    shapes += [("mamba2 long", B, H, T, P, N, 0.2) for B, T in ((1, 4096), (SERVE_SLOTS, 512), (1, 4095))]
    shapes += [("slow decay", 1, H, 4096, P, N, 0.002), ("slow decay", 1, 3, 200, 72, 20, 0.002)]
    worst: dict[str, float] = {}
    cases = 0
    for i, (label, B, H_, T, P_, N_, decay) in enumerate(shapes):
        for bc_dtype in (torch.float32, torch.bfloat16):
            xb, a, Bm, Cm = ssd_operands(B, H_, T, P_, N_, bc_dtype, seed=i, decay=decay)
            y, h = ssd_scan(xb, a, Bm, Cm)
            torch.cuda.synchronize()
            if y.stride() != xb.stride():
                raise AssertionError(f"ssd_scan {label} {(B, H_, T, P_, N_)}: y strides {y.stride()}, "
                                     f"xb's {xb.stride()}")
            y_want, h_want = ssd_scan_plain(xb, a, Bm, Cm)
            wants = [("y", y, y_want), ("h_final", h, h_want)]
            if T <= 64:
                wants.append(("y vs oracle", y, ssd_scan_ref(xb, a, Bm, Cm)))
            for what, got, want in wants:
                diff = (got - want).abs()
                if not torch.isfinite(got).all() or bool((diff > SSD_TOL + SSD_TOL * want.abs()).any()):
                    raise AssertionError(
                        f"ssd_scan {label} {(B, H_, T, P_, N_)} B/C {bc_dtype}: {what} max |kernel - want| "
                        f"= {float(diff.max()):.3g} beyond atol = rtol = {SSD_TOL}"
                    )
                worst[f"{label} {what}"] = max(worst.get(f"{label} {what}", 0.0), float(diff.max()))
            cases += 1
    print(f"[kernels] ssd_scan within 2e-4 of ssd_scan_plain (y, final state) and of ssd_scan_ref (y, T <= 64) "
          f"on {cases} cases (B/C in f32 and bf16); max |kernel - want| per group:")
    for key, err in worst.items():
        print(f"    {key:20s} {err:.3e}")
    return {"max_abs_err": max(worst.values())}


def phase_ssd_timing() -> list[dict]:
    """Times at mamba2-1.3b's prefill shapes: xb, a f32; B, C bf16."""
    cfg = get_config(SSD_ARCH)
    H, P, N = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state
    print(f"[kernels] ssd_scan at {SSD_ARCH} prefill shapes (H={H}, P={P}, N={N}; xb, a f32, B/C bf16), ms per "
          "call; graph = device time in a CUDA graph, eager = launched from Python; no library call computes SSD; "
          "before = the same kernel's earlier time (PERF.md)")
    print(f"    {'B':>2s} {'T':>5s} {'kernel':>10s} {'kern eager':>10s} {'plain':>10s} {'bound':>10s} {'':12s} "
          f"{'before':>10s}")
    rows = []
    for B, T in SSD_TIMED:
        xb, a, Bm, Cm = ssd_operands(B, H, T, P, N, torch.bfloat16, seed=T)
        iters = 200 if T <= 512 else 10
        row = {
            "shape": [B, H, T, P, N],
            "ms": graph_ms(lambda: ssd_scan(xb, a, Bm, Cm), iters),
            "eager_ms": eager_ms(lambda: ssd_scan(xb, a, Bm, Cm), iters),
            "plain_ms": graph_ms(lambda: ssd_scan_plain(xb, a, Bm, Cm), iters),
            "library_ms": None,
        }
        # xb, a, y and h_final in f32, B and C in bf16, each moved once; the
        # recurrence's 5 P N flops per token and head (decay, outer product,
        # add; read-out) at the fp32 rate outside the tensor cores
        nbytes = 4 * (2 * B * H * T * P + B * H * T + B * H * P * N) + 2 * 2 * B * T * N
        row["bound_ms"], row["bound_by"] = bound(nbytes, 5 * B * H * T * P * N, FP32_FLOPS_S)
        rows.append(row)
        print(f"    {B:>2d} {T:>5d} {row['ms']:>10.5f} {row['eager_ms']:>10.5f} {row['plain_ms']:>10.5f} "
              f"{row['bound_ms']:>10.6f} {'(' + row['bound_by'] + ')':12s} {BEFORE_MS['ssd_scan', (B, T)]:>10.5f}")
        print_device_kernels(lambda: ssd_scan(xb, a, Bm, Cm))
    return rows


def phase_ssd_heads() -> dict:
    """Device ms per ``ssd_scan`` call with each count in :data:`SSD_HEADS`
    of heads sharing one output block's C . B^T, at mamba2-1.3b's timed
    shapes and (1, 512), B/C bf16; the count the wrapper's
    ``heads_per_block`` picks on this card is starred.  Skipped for an older
    package (``--src``) without that rule."""
    mod = sys.modules["repro_torch.kernels.ssd_scan"]
    if not hasattr(mod, "heads_per_block"):
        return {}
    cfg = get_config(SSD_ARCH)
    H, P, N = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    print(f"[kernels] ssd_scan ms per call by heads per output block (graph; {sms} SMs; * = heads_per_block's "
          f"pick; blocks = output blocks)")
    print(f"    {'B':>2s} {'T':>5s} " + " ".join(f"{f'G={g}':>10s}" for g in SSD_HEADS))
    picks = {}
    for B, T in (*SSD_TIMED, (1, 512)):
        xb, a, Bm, Cm = ssd_operands(B, H, T, P, N, torch.bfloat16, seed=T)
        chunks = mod._lib().ssd_scan_chunks(T)
        pick = mod.heads_per_block(B, H, chunks, sms)
        iters = 200 if T <= 512 else 10
        ms = {g: graph_ms(lambda g=g: mod._launch(xb, a, Bm, Cm, g), iters) for g in SSD_HEADS}
        best = min(ms, key=ms.get)
        picks[B, T] = {"pick": pick, "pick_ms": ms[pick], "best": best, "best_ms": ms[best]}
        print(f"    {B:>2d} {T:>5d} " + " ".join(f"{ms[g]:>9.5f}{'*' if g == pick else ' '}" for g in SSD_HEADS)
              + f"   blocks {' '.join(str(B * chunks * -(-H // g)) for g in SSD_HEADS)}; fastest G={best}, "
              f"pick / fastest {ms[pick] / ms[best]:.3f}")
    return picks


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


def print_device_kernels(fn) -> None:
    """One line under a timing row: the device kernels one call issues."""
    us = device_kernels_us(fn)
    print(f"          device kernels of one call (profiler, µs): "
          + ", ".join(f"{name} {t:.1f}" for name, t in us.items()))


def rglru_operands(B, T, W, dtype, seed, *, strided=False, lo=0.2):
    """a in U(``lo``, 0.999) and b normal, (B, T, W) on the card in
    ``dtype`` (the kernel test's distributions at ``lo`` = 0.2, where a
    64-step chunk's product of a is about 1e-17 and the state carried into
    it vanishes; at 0.99 it is about 0.7).  With ``strided`` each is the
    (B, T, W) view of (T, B, W) storage."""
    rng = np.random.default_rng(seed)

    def mk(x):
        if strided:
            return torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2))).to(DEV, dtype).transpose(0, 1)
        return torch.from_numpy(x).to(DEV, dtype)

    return mk(rng.uniform(lo, 0.999, (B, T, W)).astype(np.float32)), mk(rng.normal(size=(B, T, W)).astype(np.float32))


def phase_rglru_kernel() -> dict:
    """The RG-LRU scan against its plain version and the sequential oracle
    on the card, within the reference kernel test's 1e-4."""
    W = get_config(RG_ARCH).lru_width
    shapes = [("grid", *s, False) for s in RGLRU_GRID] + [("ragged", *s, st) for s in RGLRU_RAGGED
                                                         for st in (False, True)]
    shapes += [("rgemma", SERVE_SLOTS, T, W, False) for T in (4, 24, 35)] + [("rgemma", 1, 300, W, False)]
    # one chunk (no pairs) and two, then long prefills
    shapes += [("rgemma chunk edge", SERVE_SLOTS, T, W, st) for T in (RGLRU_CHUNK, RGLRU_CHUNK + 1)
               for st in (False, True)]
    shapes += [("rgemma long", 1, T, W, st) for T in (4096, 4097) for st in (False, True)]
    shapes = [(*s, 0.2) for s in shapes]  # (..., lo)
    # states carried across chunks, on the split path
    shapes += [("slow decay", 1, 4096, W, False, 0.99),
               ("slow decay", SERVE_SLOTS, 2 * RGLRU_CHUNK + 1, W, True, 0.99)]
    worst: dict[str, float] = {}
    cases = 0
    for i, (label, B, T, W_, strided, lo) in enumerate(shapes):
        for dtype in (torch.float32, torch.bfloat16):
            a, b = rglru_operands(B, T, W_, dtype, seed=i, strided=strided, lo=lo)
            h = rglru_scan(a, b)
            torch.cuda.synchronize()
            if h.dtype != torch.float32 or h.shape != (B, T, W_) or not torch.isfinite(h).all():
                raise AssertionError(f"rglru_scan {label} {(B, T, W_)} {dtype}: bad output")
            for what, want in (("plain", rglru_scan_plain(a, b)), ("oracle", rglru_scan_ref(a, b))):
                diff = (h - want).abs()
                if bool((diff > RGLRU_TOL + RGLRU_TOL * want.abs()).any()):
                    raise AssertionError(
                        f"rglru_scan {label} {(B, T, W_)} {dtype} strided={strided}: max |kernel - {what}| "
                        f"= {float(diff.max()):.3g} beyond atol = rtol = {RGLRU_TOL}"
                    )
                key = f"{label} {str(dtype).split('.')[-1]} vs {what}"
                worst[key] = max(worst.get(key, 0.0), float(diff.max()))
            cases += 1
    print(f"[kernels] rglru_scan within {RGLRU_TOL} of rglru_scan_plain and rglru_scan_ref on {cases} cases "
          "(a, b in f32 and bf16); max |kernel - want| per group:")
    for key, err in worst.items():
        print(f"    {key:28s} {err:.3e}")
    return {"max_abs_err": max(worst.values())}


def phase_rglru_timing() -> list[dict]:
    """Times at recurrentgemma-2b's prefill shapes: a, b f32, as the model
    passes them."""
    W = get_config(RG_ARCH).lru_width
    print(f"[kernels] rglru_scan at {RG_ARCH} prefill shapes (W={W}; a, b f32), ms per call; graph = device "
          "time in a CUDA graph, eager = launched from Python; no library call computes the recurrence; "
          "before = the same kernel's earlier time (PERF.md)")
    print(f"    {'B':>2s} {'T':>5s} {'kernel':>10s} {'kern eager':>10s} {'plain':>10s} {'bound':>10s} {'':12s} "
          f"{'before':>10s}")
    rows = []
    for B, T in RGLRU_TIMED:
        a, b = rglru_operands(B, T, W, torch.float32, seed=T)
        iters = 200 if T <= 512 else 20
        row = {
            "shape": [B, T, W],
            "ms": graph_ms(lambda: rglru_scan(a, b), iters),
            "eager_ms": eager_ms(lambda: rglru_scan(a, b), iters),
            # the plain version is one launch per time step: fewer calls per graph
            "plain_ms": graph_ms(lambda: rglru_scan_plain(a, b), max(2, 4096 // T)),
            "library_ms": None,
        }
        # a and b read once and h written once, 4 bytes each; 2 flops an
        # element at the fp32 rate outside the tensor cores
        row["bound_ms"], row["bound_by"] = bound(12 * B * T * W, 2 * B * T * W, FP32_FLOPS_S)
        rows.append(row)
        print(f"    {B:>2d} {T:>5d} {row['ms']:>10.5f} {row['eager_ms']:>10.5f} {row['plain_ms']:>10.5f} "
              f"{row['bound_ms']:>10.6f} {'(' + row['bound_by'] + ')':12s} {BEFORE_MS['rglru_scan', (B, T)]:>10.5f}")
        print_device_kernels(lambda: rglru_scan(a, b))
    return rows


def reset_counts() -> None:
    for fn in _graphs.COUNTED:
        fn.launches = 0


def read_counts() -> dict[str, int]:
    return _graphs.launch_counts()


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


def with_zeros(want: dict[str, int]) -> dict[str, int]:
    """``want`` over every counted kernel: 0 launches of each it does not name."""
    return {**dict.fromkeys(read_counts(), 0), **want}


def cnn_counts(gemms: int, convs: int, runs: int) -> dict[str, int]:
    """The launches of ``runs`` runs of a CNN: one GEMM per GEMM segment,
    one fused conv per fused conv segment (where the tree counts it), and
    nothing else."""
    want = {"matmul_requant": gemms * runs}
    if "conv_requant" in read_counts():
        want["conv_requant"] = convs * runs
    return with_zeros(want)


def fused_convs(cm) -> int:
    """The conv segments lowered to the fused conv kernel."""
    return sum(ls.meta.get("kernel") == "conv_requant" for ls in cm.segments)


def check_counts(where: str, got: dict[str, int], want: dict[str, int]) -> None:
    if got != want:
        raise AssertionError(f"{where}: kernel launches {got}, expected {want}")


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


class TimedLM:
    """The serving engine's model, with each prefill timed on the host clock
    between ``torch.cuda.synchronize()`` calls and its logits checked
    finite.  Everything else passes through (decode steps are timed at the
    engine, where a replay happens)."""

    def __init__(self, lm):
        self.lm = lm
        self.prefill_ms: list[tuple[tuple, float]] = []
        self.finite = True

    def __getattr__(self, name):
        return getattr(self.lm, name)

    def prefill(self, tokens, max_len=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.lm.prefill(tokens, max_len=max_len)
        torch.cuda.synchronize()
        self.prefill_ms.append((tuple(tokens.shape), (time.perf_counter() - t0) * 1e3))
        self.finite &= bool(torch.isfinite(out[0]).all())
        return out


def time_decodes(eng, timed: TimedLM, sink: list) -> None:
    """Time each of ``eng``'s lock-step decodes (one graph replay, or one
    eager ``decode_step``, with the engine's copies of tokens and
    position) on the host clock between synchronizes into ``sink``, and
    check its logits finite."""
    inner = eng._decode

    def decode(cache, cur, pos):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = inner(cache, cur, pos)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t0) * 1e3)
        timed.finite &= bool(torch.isfinite(logits).all())
        return logits

    eng._decode = decode


def decode_breakdown(label: str, step, steps: int = 3) -> dict:
    """Where a decode step's time goes: ``torch.profiler`` over ``steps``
    calls of ``step(i)`` (one decode at the serving shape, 4 slots, 24
    positions filled), device time by name against the host clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            step(1 + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    if not by_name:
        print(f"[serve] decode breakdown, {label}: wall {wall_ms:.3f} ms per step; device time not measured "
              "(the profiler recorded no CUDA events)")
        return {"wall_ms": wall_ms, "busy_ms": None}
    busy_ms = sum(sum(v) for v in by_name.values()) / 1e3 / steps
    launches = sum(len(v) for v in by_name.values()) / steps
    print(f"[serve] decode breakdown, {label} (torch.profiler, {steps} steps, B={SERVE_SLOTS}): wall {wall_ms:.3f} "
          f"ms per step, device busy {busy_ms:.3f} ms ({launches:.0f} device ops per step), "
          f"device idle {100 * (1 - busy_ms / wall_ms):.1f} %; top device ops, ms per step:")
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:6]
    for name, us in top:
        print(f"    {sum(us) / 1e3 / steps:8.4f}  x{len(us) // steps:<4d} {name[:100]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms}


def serve_runs(eng, cfg, timed: TimedLM, runs: int) -> list[dict]:
    """``runs`` calls of ``eng.run()`` on launch.serve's requests, each
    with its launch counts from 0 just before and read just after, checked
    exact: flash and the scans once per layer per prefill, moe_gmm three
    times per MoE layer per prefill and per decode step."""
    out = []
    for _ in range(runs):
        steps0, refills0 = eng.decode_steps, eng.refills
        timed.prefill_ms.clear()
        decode_ms: list[float] = []
        time_decodes(eng, timed, decode_ms)
        serve.submit_requests(eng, cfg, SERVE_REQUESTS, SERVE_NEW)
        reset_counts()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        del eng._decode  # back to the engine's own method
        prefills, steps = len(timed.prefill_ms), eng.decode_steps - steps0
        check_counts(f"serve {cfg.name}", counts, expected_counts(cfg, prefills, steps))
        if len(decode_ms) != steps:
            raise AssertionError(f"serve {cfg.name}: {len(decode_ms)} timed decode steps, the engine counted {steps}")
        if sorted(r.rid for r in done) != list(range(SERVE_REQUESTS)):
            raise AssertionError(f"serve {cfg.name}: served {[r.rid for r in done]}, expected all {SERVE_REQUESTS}")
        for r in done:
            if len(r.out_tokens) != SERVE_NEW or r.truncated or not all(0 <= t < cfg.vocab for t in r.out_tokens):
                raise AssertionError(f"serve {cfg.name}: request {r.rid} gave {r.out_tokens} (truncated={r.truncated})")
        if not timed.finite:
            raise AssertionError(f"serve {cfg.name}: logits not finite")
        out.append({
            "served": [(r.rid, len(r.prompt), tuple(r.out_tokens), r.truncated) for r in sorted(done, key=lambda r: r.rid)],
            "decode_steps": steps, "refills": eng.refills - refills0, "prefills": prefills, "launches": counts,
            "run_s": run_s, "tokens": sum(len(r.out_tokens) for r in done), "decode_ms": decode_ms,
            "prefill_ms": list(timed.prefill_ms),
        })
    return out


def phase_serve(arch: str) -> dict:
    """launch.serve's engine on ``arch``, full width and depth, bf16: decode
    by graph replay (the default on the card) and op by op (``eager=True``)
    on one model, one warm-up ``run()`` and 3 timed ones each."""
    cfg = get_config(arch)
    t0 = time.perf_counter()
    graph_eng = serve.build_engine(cfg, "cuda", slots=SERVE_SLOTS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    lm = graph_eng.model
    eager_eng = ServeEngine(lm, batch_slots=SERVE_SLOTS, max_len=serve.MAX_LEN, eager=True)
    if graph_eng.eager or not eager_eng.eager:
        raise AssertionError(f"serve {arch}: the engine on the card must decode by graph unless asked not to")
    results = {}
    for mode, eng in (("graph", graph_eng), ("eager", eager_eng)):
        timed = TimedLM(lm)
        eng.model = timed
        results[mode] = serve_runs(eng, cfg, timed, runs=4)
        eng.model = lm
    first = results["eager"][0]
    for mode, runs in results.items():
        for i, r in enumerate(runs):
            for key in ("served", "decode_steps", "refills", "prefills", "launches"):
                if r[key] != first[key]:
                    raise AssertionError(f"serve {arch}: {mode} run {i} {key} {r[key]} differs from eager run 0's "
                                         f"{first[key]}")
    for rid, plen, toks, _ in first["served"]:
        print(f"[serve] rid={rid} prompt_len={plen} out={list(toks)}")
    per_step = {mode: float(np.median([np.mean(r["decode_ms"]) for r in runs[1:]])) for mode, runs in results.items()}
    tok_s = {mode: float(np.median([r["tokens"] / r["run_s"] for r in runs[1:]])) for mode, runs in results.items()}
    g = results["graph"][1]
    print(f"[serve] {cfg.name} full width x {cfg.n_layers} layers bf16 ({sum(p.numel() for p in lm.parameters()) / 1e9:.2f} B params), "
          f"slots {SERVE_SLOTS}, max_len {serve.MAX_LEN}: weights built in {build_s:.2f} s; {len(first['served'])} "
          f"requests, {g['tokens']} tokens per run; refills {g['refills']}, decode steps {g['decode_steps']}, "
          f"{g['prefills']} prefills; launches per run {g['launches']}; graph and eager identical in tokens, "
          f"truncation, decode steps, refills and launches over {len(results['graph'])} + {len(results['eager'])} runs")
    print(f"[serve] capture ms per (rows, max_len): "
          + ", ".join(f"{key} {ms:.1f}" for key, ms in graph_eng.capture_ms.items()))
    for mode, runs in results.items():
        print(f"[serve] {mode}: decode ms per step, median over runs 2-4 of each run's mean {per_step[mode]:.3f} "
              f"(run means {', '.join(f'{np.mean(r['decode_ms']):.3f}' for r in runs)}; first run warm-up); tok/s "
              f"{tok_s[mode]:.1f} (runs {', '.join(f'{r['tokens'] / r['run_s']:.1f}' for r in runs)}); prefill ms "
              f"(tokens shape) {', '.join(f'{ms:.3f} {list(shape)}' for shape, ms in runs[1]['prefill_ms'])}")
    print(f"[serve] {cfg.name}: decode ms per step graph {per_step['graph']:.3f} vs eager {per_step['eager']:.3f} "
          f"({per_step['eager'] / per_step['graph']:.2f}x); tok/s graph {tok_s['graph']:.1f} vs eager {tok_s['eager']:.1f}")
    B, S = SERVE_SLOTS, 24
    with torch.inference_mode():
        toks = torch.zeros((B, S), dtype=torch.int64, device=DEV)
        nxt = np.zeros(B, np.int64)
        _, cache = lm.prefill(toks, max_len=serve.MAX_LEN)
        eager_b = decode_breakdown("eager", lambda i: lm.decode_step(cache, torch.from_numpy(nxt).to(DEV), S + i))
        gcache = graph_eng._decode_cache(lm.prefill(toks, max_len=serve.MAX_LEN)[1], B)
        graph_b = decode_breakdown("graph", lambda i: graph_eng._decode(gcache, nxt, S + i))
    del graph_eng, eager_eng, lm, cache, gcache
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": g["launches"], "prefills": g["prefills"], "decode_steps": g["decode_steps"],
            "decode_ms": per_step, "tok_s": tok_s, "breakdown": {"eager": eager_b, "graph": graph_b}}


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


# the Pallas kernel body each CUDA kernel replaces
REPLACES = {
    "matmul_requant": "src/repro/kernels/matmul_requant.py:45",
    "flash_attention": "src/repro/kernels/flash_attention.py:28",
    "moe_gmm": "src/repro/kernels/moe_gmm.py:22",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:27",
    "rglru_scan": "src/repro/kernels/rglru_scan.py:26",
}


def kernel_entry(name: str, launches: int, check: dict, row: dict, **extra) -> dict:
    """One kernel's entry of the JSON line: ``row`` holds the times at the
    main path's shape."""
    return {
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": REPLACES[name],
        "launches": launches,
        "max_abs_err": check["max_abs_err"],
        **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "eager_ms")},
        **extra,
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
    if "gemm" in only:
        gemm = phase_gemm_kernel()
        if SEGMENT is not None:
            gemm["branches"] = phase_gemm_branches()
        gemm["segments"] = phase_gemm_segments()
    if "kernels" in only:
        flash = phase_flash_kernel()
        flash_rows = phase_flash_timing()
        gmm = phase_moe_gmm_kernel()
        gmm_rows = phase_moe_gmm_timing()
        gmm_routed = phase_moe_gmm_routed()
        ssd = phase_ssd_kernel()
        ssd_rows = phase_ssd_timing()
        phase_ssd_heads()
        rglru = phase_rglru_kernel()
        rglru_rows = phase_rglru_timing()
        rg_flash_rows = phase_rg_flash_timing()
    if "conv" in only:
        conv = phase_conv()
    if "cnn" in only:
        cnn = phase_cnn_path()
    if "pipeline" in only:
        pipe = phase_pipeline()
    if "cnn-serve" in only:
        cnn_serve = phase_cnn_serve()
    if "calibrate" in only:
        calib = phase_calibrate()
    if "fuzz" in only:
        fuzz = phase_fuzz()
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
        served = {arch: phase_serve(arch) for arch in (LM_ARCH, MOE_ARCH, SSD_ARCH, RG_ARCH)}
    if "train" in only:
        trained = phase_train()
    if "ops" in only:
        op_run = phase_ops()
    if "shard" in only:
        phase_shard()
    if "dryrun" in only:
        phase_dryrun()
    if only != set(PHASES):
        print(f"[only] {', '.join(ARGS.only)} passed; no JSON lines without every phase")
        return

    def shapes(rows):
        return [{k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
                for r in rows]

    # the main path calls the segment entry (``entry``): its largest M = 1 shape
    # heads the kernel's entry, bounded by its float32 bytes
    rowkeys = ("shape", "ms", "launch_floor_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    big = max(gemm["segment_rows"], key=lambda r: r["shape"][1] * r["shape"][2])
    entries = [
        kernel_entry("matmul_requant", cnn["launches"], gemm, big, entry="matmul_requant_f32",
                     launch_floor_ms=big["launch_floor_ms"],
                     launch_floor_1x32_ms=gemm["launch_floor_ms"], launches_aot=cnn["launches_aot"],
                     launches_pipeline=pipe["launches"], launches_cnn_serve=cnn_serve["launches"],
                     launches_calibrate=calib["launches"], launches_fuzz=fuzz["launches"],
                     served_shapes=[{k: r[k] for k in rowkeys} for r in gemm["segment_served_rows"]],
                     int8_entry_shapes=[{k: r[k] for k in rowkeys} for r in gemm["rows"] + gemm["served_rows"]],
                     segments=[{k: r[k] for k in ("segment", "shape", "ms", "kernels", "device_us")}
                               for r in gemm["segments"]], branches=gemm["branches"]),
        # the serving engine's prefill shape first
        kernel_entry("flash_attention", served[LM_ARCH]["launches"]["flash_attention"], flash, flash_rows[0],
                     max_abs_err_f32=flash["max_abs_err_f32"], prefill_shapes=shapes(flash_rows),
                     launches_granite_moe=served[MOE_ARCH]["launches"]["flash_attention"],
                     local_attn_shapes=shapes(rg_flash_rows),
                     launches_recurrentgemma=served[RG_ARCH]["launches"]["flash_attention"]),
        kernel_entry("moe_gmm", served[MOE_ARCH]["launches"]["moe_gmm"], gmm, gmm_rows[0],
                     max_abs_err_f32=gmm["max_abs_err_f32"], serve_shapes=shapes(gmm_rows),
                     routed_shapes=gmm_routed),
        kernel_entry("ssd_scan", served[SSD_ARCH]["launches"]["ssd_scan"], ssd, ssd_rows[0],
                     prefill_shapes=shapes(ssd_rows), prefill_long=longs[SSD_ARCH]["kernels"]["ssd_scan"]),
        kernel_entry("rglru_scan", served[RG_ARCH]["launches"]["rglru_scan"], rglru, rglru_rows[0],
                     prefill_shapes=shapes(rglru_rows), prefill_long=longs[RG_ARCH]["kernels"]["rglru_scan"]),
    ]
    for e in entries:  # the training path: forward and backward launches, each backward's times
        e["launches_train"] = trained["launches_full"][e["name"]]
        e["launches_train_grads"] = trained["launches_grads"][e["name"]]
        if e["name"] in trained["timing"]:
            e["backward"] = trained["timing"][e["name"]]
        o = op_run["kernels"][e["name"]]  # the DSE-scheduled wrapper's run
        e["launches_ops"] = o["launches"]
        e["ops"] = {k: o[k] for k in ("shape", "max_abs_err", "host_ms_cold", "host_ms_cached", "host_ms_bare")}
    big = max(conv["rows"], key=lambda r: r["ms"] if r["batch"] == 1 else 0.0, default=None)  # slowest batch-1 layer
    entries += [] if big is None else [{"name": "conv_requant", "route": "cuda", "source": "src/repro_torch/kernels/csrc/conv_requant.cu",
                    "replaces": None, "launches": cnn["conv_launches"], "checks": conv["checked"],
                    **{k: big[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "eager_ms",
                                           "before_ms", "launch_floor_ms")},
                    "launches_aot": cnn["conv_launches_aot"], "launches_calibrate": calib["conv_launches"],
                    "launches_fuzz": fuzz["conv_launches"], "shapes": conv["rows"]}]
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
``nvcc``; run from the root of a checkout.  Phases, each raising on
failure:

1. the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the main paths compiled by ``nvcc`` from
   ``src/repro_torch/kernels/csrc``, one compiler per source, all started
   together (build seconds, ``-Xptxas -v``);
3. kernels, each on the card against its plain PyTorch version:
   ``matmul_requant`` bit-exact (tolerance 0: integer arithmetic) on the
   CNN path's shapes, the test grid and ragged shapes, both roundings,
   ReLU on and off; ``flash_attention`` within 2e-5 (f32) and 2e-2 (bf16)
   on the kernel test grid (causal and not), Sq != Sk with ``q_offset``,
   sliding windows, ragged lengths and the serving shapes; ``moe_gmm``
   within 1e-4 (f32) and 2e-2 (bf16) on the kernel test grid, ragged and
   strided operands and granite-moe-3b-a800m's shapes; ``ssd_scan`` (y and
   the final state) within 2e-4 of its plain version and of the
   sequential oracle on the kernel test grid, ragged T and mamba2-1.3b's
   shapes; ``rglru_scan`` within 1e-4 of its plain version and of the
   sequential oracle on the kernel test grid, ragged T and W, strided and
   bf16 operands and recurrentgemma-2b's shapes; then times of each at its
   path's shapes (flash also at recurrentgemma-2b's local-attention shape)
   beside the plain version, one PyTorch library call where there is one,
   and the bound;
4. CNN path: the four MLPerf-Tiny nets x {gap9, diana} through
   ``repro_torch.core.dispatch`` -> ``repro_torch.backend.lower`` (default
   device) -> 4 requests through ``CompiledModel.run``, each output
   bit-exact with the port's CPU interpreter, and the GEMM launch count
   equal to (GEMM segments) x 4 requests;
5. LM parity: qwen2.5-3b, granite-moe-3b-a800m and mamba2-1.3b at full
   width, 2 layers, float32, a 16-token prefill, and recurrentgemma-2b at
   full width, 3 layers (rglru, rglru, local_attn), float32, a 2048-token
   prefill that fills its local-attention ring, with RG-LRU decays drawn
   in about 0.4-0.999 so the recurrence carries; each with 4 greedy decode
   steps (recurrentgemma's wrap the ring) on the card (the kernels) against
   the same module on the CPU (plain versions), logits within 1e-3 and
   identical tokens;
6. LM serve path: ``repro_torch.launch.serve``'s engine on qwen2.5-3b (36
   layers), granite-moe-3b-a800m (32), mamba2-1.3b (48) and
   recurrentgemma-2b (26), each at full width and depth (bf16, weights
   from a generator seeded 0), 6 requests, 12 new tokens each, greedy;
   every request served, all logits finite, and exact launch counts:
   flash = attention layers (``attn`` and ``local_attn``) x prefill calls,
   moe_gmm = 3 x MoE layers x (prefill calls + decode steps), ssd_scan =
   ssd layers x prefill calls, rglru_scan = rglru layers x prefill calls,
   and no launch of a kernel off the path; then a profiler breakdown of a
   decode step;
7. one JSON line of per-kernel numbers, the card line, and last the
   ``{"ok": true, "device": ...}`` line.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout.  Imports nothing of JAX or of the reference package ``repro``.
"""

from __future__ import annotations

import copy
import gc
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np  # noqa: E402

import torch.nn.functional as F  # noqa: E402

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.backend import lower  # noqa: E402
from repro_torch.cnn import (  # noqa: E402
    execute_graph,
    init_graph_params,
    mlperf_tiny_networks,
    params_to_torch,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain  # noqa: E402
from repro_torch.kernels.matmul_requant import matmul_requant, matmul_requant_plain  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_plain  # noqa: E402
from repro_torch.kernels.ref import rglru_scan_ref, ssd_scan_ref  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import rglru as rglru_mod  # noqa: E402
from repro_torch.models.layers import rmsnorm  # noqa: E402

DEV = torch.device("cuda")
NETS = ("MobileNet", "ResNet", "DSCNN", "DAE")
TARGETS = ("gap9", "diana")
REQUESTS = 4
KERNELS = ("matmul_requant", "flash_attention", "moe_gmm", "ssd_scan", "rglru_scan")
COUNTED = (matmul_requant, flash_attention, moe_gmm, ssd_scan, rglru_scan)  # wrappers with a launch count
# H100 SXM data sheet: HBM3 bytes/s, dense int8 and bf16 tensor-core ops/s,
# fp32 ops/s outside the tensor cores
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
BF16_FLOPS_S = 989e12
FP32_FLOPS_S = 67e12
# (K, N) of every dense on the main path; all run at M = 1
MAIN_KN = ((640, 128), (128, 128), (128, 8), (8, 128), (128, 640), (64, 10), (256, 2), (64, 12))
GRID_MKN = ((8, 16, 128), (32, 64, 128), (128, 128, 256), (16, 96, 384), (3, 37, 11), (48, 80, 112))
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
RG_ARCH = "recurrentgemma_2b"
# rglru_scan: the kernel test grid (B, T, W) with a in U(0.2, 0.999), ragged
# T and W; times at (B, T) with recurrentgemma-2b's W = 2560, a and b f32
RGLRU_TOL = 1e-4
RGLRU_GRID = ((1, 32, 16), (2, 128, 64), (3, 64, 256))
RGLRU_RAGGED = ((2, 37, 45), (1, 5, 3), (3, 20, 130))
RGLRU_TIMED = ((4, 24), (4, 512), (1, 4096))
# flash at recurrentgemma-2b's local attention (H=10, KV=1, D=256, window 2048)
RG_FLASH_TIMED = ((4, 24), (1, 4096))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
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


def library_gemm_requant(af, wf, mult, bias, shift):
    """PyTorch's own calls for the same function (fp32 matmul on the
    integer-valued operands, then the epilogue): the yardstick only."""
    y = torch.matmul(af, wf).to(torch.int32) * mult + bias
    return torch.clamp(torch.round(y / float(1 << shift)), -128, 127).to(torch.int8)


def phase_build() -> None:
    """Every kernel's nvcc started at once, one thread each."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        infos = list(pool.map(_build.build, KERNELS))
    for info in infos:
        how = f"built in {info.seconds:.2f} s" if info.seconds else "reused an earlier build"
        print(f"[build] {info.name}: {how} -> {info.path}")
        print("[build] nvcc -Xptxas -v:")
        for line in info.ptxas.strip().splitlines():
            print(f"    {line}")


def phase_gemm_kernel() -> dict:
    """Bit-exact checks, then times at the CNN path's shapes."""
    worst = 0
    cases = 0
    shapes = [(1, k, n, True) for k, n in MAIN_KN] + [(m, k, n, False) for m, k, n in GRID_MKN]
    for i, (m, k, n, tw) in enumerate(shapes):
        a, w, mult, bias = gemm_operands(m, k, n, seed=i, transposed_w=tw)
        for rounding in ("floor", "even"):
            for relu in (False, True):
                for shift in (0, 5, 8, 13):
                    got = matmul_requant(a, w, mult, bias, shift=shift, relu=relu, rounding=rounding)
                    torch.cuda.synchronize()
                    want = matmul_requant_plain(a, w, mult, bias, shift=shift, relu=relu, rounding=rounding)
                    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
                    if err:
                        raise AssertionError(
                            f"matmul_requant M,K,N={m},{k},{n} {rounding} relu={relu} "
                            f"shift={shift}: max |kernel - plain| = {err}"
                        )
                    worst = max(worst, err)
                    cases += 1
    print(f"[kernels] matmul_requant bit-exact vs matmul_requant_plain on {cases} cases "
          f"({len(shapes)} shapes x 2 roundings x relu on/off x 4 shifts)")

    print("[kernels] main-path shapes (M=1), ms per call; graph = device time in a CUDA graph, "
          "eager = launched from Python")
    print(f"    {'K':>4s} {'N':>4s} {'kernel':>9s} {'kern eager':>10s} {'plain':>9s} "
          f"{'library':>9s} {'bound':>9s}")
    rows = []
    for k, n in MAIN_KN:
        a, w, mult, bias = gemm_operands(1, k, n, seed=7, transposed_w=True)
        af, wf = a.float(), w.float()
        kw = dict(shift=5, relu=True, rounding="even")
        row = {
            "shape": [1, k, n],
            "ms": graph_ms(lambda: matmul_requant(a, w, mult, bias, **kw)),
            "eager_ms": eager_ms(lambda: matmul_requant(a, w, mult, bias, **kw)),
            "plain_ms": graph_ms(lambda: matmul_requant_plain(a, w, mult, bias, **kw)),
            "library_ms": graph_ms(lambda: library_gemm_requant(af, wf, mult, bias, 5)),
        }
        row["bound_ms"], row["bound_by"] = bound(1 * k + k * n + 8 * n + 1 * n, 2 * 1 * n * k, INT8_OPS_S)
        rows.append(row)
        print(f"    {k:>4d} {n:>4d} {row['ms']:>9.5f} {row['eager_ms']:>10.5f} "
              f"{row['plain_ms']:>9.5f} {row['library_ms']:>9.5f} {row['bound_ms']:>9.6f}")
    return {"max_abs_err": worst, "rows": rows}


def phase_cnn_path() -> dict:
    """4 nets x 2 targets through dispatch -> lower -> run on the card."""
    nets = mlperf_tiny_networks()
    cells = []
    for net in NETS:
        g = nets[net]
        params = init_graph_params(g)
        cpu_params = params_to_torch(params, "cpu")
        requests = [
            {k: np.random.default_rng(seed).integers(-128, 128, s).astype(np.float32)
             for k, s in g.inputs.items()}
            for seed in range(REQUESTS)
        ]
        refs = [execute_graph(g, cpu_params, x, device="cpu") for x in requests]
        for tgt in TARGETS:
            t0 = time.perf_counter()
            mapped = dispatch(g, tgt, budget=300)
            cm = lower(mapped)  # default device: the card
            compile_s = time.perf_counter() - t0
            dev_params = params_to_torch(params, cm.device)
            gemm_segments = cm.routes().get("pallas_gemm", 0)
            # F.conv2d calls per request: one per output band of each conv segment
            bands = sum(
                -(-int(ls.segment.anchor.attr("OY", 1) or 1) // ls.meta["block_oy"])
                for ls in cm.segments if ls.route == "tiled_conv"
            )
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
            check_counts(f"{net}x{tgt}", counts, {**dict.fromkeys(counts, 0), "matmul_requant": launches})
            for i, (out, ref) in enumerate(zip(outs, refs)):
                for name, want in ref.items():
                    got = out[name]
                    if got.device.type != "cuda" or not torch.isfinite(got).all():
                        raise AssertionError(f"{net}x{tgt} request {i}: output not finite on the card")
                    if tuple(got.shape) != tuple(want.shape) or not torch.equal(got.cpu(), want):
                        print(cm.verify(params, requests[i], per_segment=True).summary())
                        raise AssertionError(f"{net}x{tgt} request {i}: {name} differs from the CPU interpreter")
            if launches != gemm_segments * REQUESTS:
                raise AssertionError(
                    f"{net}x{tgt}: {launches} GEMM kernel launches, expected "
                    f"{gemm_segments} segments x {REQUESTS} requests"
                )
            cells.append({"net": net, "target": tgt, "launches": launches})
            print(f"[path] {net:9s} x {tgt:5s}: routes {cm.routes()}, compile {compile_s:.2f} s, "
                  f"bit-exact x{REQUESTS}, GEMM launches {launches}, conv bands/request {bands}, "
                  f"ms/request {' '.join(f'{t:.3f}' for t in req_ms)}")
            if net == "DSCNN" and tgt == "gap9":
                cm.run(dev_params, requests[0], timed=True)
                print(cm.report())
    return {"cells": cells, "launches": sum(c["launches"] for c in cells)}


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


def phase_flash_kernel() -> dict:
    """The flash kernel against its plain version on the card, within
    the reference kernel test's tolerance; max |kernel - plain| printed."""
    cfg, rg = get_config(LM_ARCH), get_config(RG_ARCH)
    H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim_
    cases = []  # (label, B, H, KV, Sq, Sk, D, dtype, kwargs, bshd)
    for dtype in (torch.float32, torch.bfloat16):
        for B_, H_, KV_, S, D_ in FLASH_GRID:
            for causal in (True, False):
                cases.append(("grid", B_, H_, KV_, S, S, D_, dtype, {"causal": causal}, False))
        for Sq, Sk in ((16, 64), (1, 40), (24, 300)):
            cases.append(("q_offset", 2, 4, 2, Sq, Sk, 32, dtype, {"q_offset": Sk - Sq}, False))
        for Sq, Sk, off, causal, win in ((64, 64, 0, True, 16), (32, 64, 32, True, 8), (64, 64, 0, False, 24),
                                         (8, 32, 100, True, 4), (40, 300, 260, True, 70)):
            cases.append(("window", 2, 4, 2, Sq, Sk, 32, dtype,
                          {"causal": causal, "q_offset": off, "window": win}, False))
        for S in (5, 24, 37):
            for causal in (True, False):
                cases.append(("ragged", 2, 4, 1, S, S, 24, dtype, {"causal": causal}, False))
        for S in (4, 17, 24, 35):  # serving: the engine's prompt lengths and past them
            cases.append(("serve", 4, H, KV, S, S, D, dtype, {"causal": True}, True))
            cases.append(("rgemma", 4, rg.n_heads, rg.kv_heads, S, S, rg.head_dim_, dtype,
                          {"causal": True, "window": rg.local_window}, True))
        # recurrentgemma's head shape with a window that bites
        cases.append(("rgemma", 1, rg.n_heads, rg.kv_heads, 300, 300, rg.head_dim_, dtype,
                      {"causal": True, "window": 64}, True))
    worst: dict[str, float] = {}
    for i, (label, B, H_, KV_, Sq, Sk, D_, dtype, kw, bshd) in enumerate(cases):
        q, k, v = flash_operands(B, H_, KV_, Sq, Sk, D_, dtype, seed=i, bshd=bshd)
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
        print(f"    {key:18s} {err:.3e}")
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
          "library = F.scaled_dot_product_attention(is_causal, enable_gqa), timed only")
    print(f"    {'B':>2s} {'S':>5s} {'kernel':>10s} {'kern eager':>10s} {'plain':>10s} "
          f"{'library':>10s} {'bound':>10s}")
    rows = []
    for B, S in FLASH_TIMED:
        q, k, v = flash_operands(B, H, KV, S, S, D, torch.bfloat16, seed=S, bshd=True)
        iters = 200 if S <= 512 else 10
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
              f"{row['library_ms']:>10.5f} {row['bound_ms']:>10.6f} ({row['bound_by']})")
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
          "(enable_gqa), timed only")
    print(f"    {'B':>2s} {'S':>5s} {'kernel':>10s} {'kern eager':>10s} {'plain':>10s} "
          f"{'library':>10s} {'bound':>10s}")
    rows = []
    for B, S in RG_FLASH_TIMED:
        q, k, v = flash_operands(B, H, KV, S, S, D, torch.bfloat16, seed=S + 1, bshd=True)
        i = torch.arange(S, device=DEV)
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < W)
        iters = 200 if S <= 512 else 10
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
              f"{row['library_ms']:>10.5f} {row['bound_ms']:>10.6f} ({row['bound_by']})")
    return rows


def gmm_operands(E, C, D, F, dtype, seed, *, strided=False):
    """x (E, C, D) normal and w (E, D, F) normal / sqrt(D) on the card in
    ``dtype``.  With ``strided`` x is the (E, C, D) view of (C, E, D)
    storage."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32)).to(DEV, dtype)
    if strided:
        x = torch.from_numpy(rng.normal(size=(C, E, D)).astype(np.float32)).to(DEV, dtype).transpose(0, 1)
    else:
        x = torch.from_numpy(rng.normal(size=(E, C, D)).astype(np.float32)).to(DEV, dtype)
    return x, w


def granite_gmm_shapes() -> list[tuple[str, int, int, int, int]]:
    """(name, E, C, D, F) of granite-moe-3b-a800m's three expert GEMMs at
    the serving engine's 4 slots: C = 4 rows x capacity 8."""
    cfg = get_config(MOE_ARCH)
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    C = SERVE_SLOTS * 8
    return [("wi", E, C, D, F), ("wo", E, C, F, D)]


def phase_moe_gmm_kernel() -> dict:
    """The grouped expert GEMM against its plain version on the card."""
    cases = []  # (label, E, C, D, F, dtype, strided)
    for dtype in (torch.float32, torch.bfloat16):
        cases += [("grid", *s, dtype, False) for s in GMM_GRID]
        cases += [("ragged", *s, dtype, st) for s in GMM_RAGGED for st in (False, True)]
        cases += [("granite", *s[1:], dtype, False) for s in granite_gmm_shapes()]
        cases += [("granite", s[1], 16, *s[3:], dtype, False) for s in granite_gmm_shapes()]  # a refill's C
    worst: dict[str, float] = {}
    for i, (label, E, C, D, F, dtype, strided) in enumerate(cases):
        x, w = gmm_operands(E, C, D, F, dtype, seed=i, strided=strided)
        got = moe_gmm(x, w)
        torch.cuda.synchronize()
        want = moe_gmm_plain(x, w)
        if got.dtype != dtype or got.shape != (E, C, F) or not torch.isfinite(got).all():
            raise AssertionError(f"moe_gmm {label} {(E, C, D, F)} {dtype}: bad output")
        diff = (got.float() - want.float()).abs()
        tol = GMM_TOL[dtype]
        if bool((diff > tol + tol * want.float().abs()).any()):
            raise AssertionError(
                f"moe_gmm {label} {(E, C, D, F)} {dtype} strided={strided}: max |kernel - plain| "
                f"= {float(diff.max()):.3g} beyond atol = rtol = {tol}"
            )
        key = f"{label} {str(dtype).split('.')[-1]}"
        worst[key] = max(worst.get(key, 0.0), float(diff.max()))
    print(f"[kernels] moe_gmm within tolerance of moe_gmm_plain on {len(cases)} cases "
          f"(f32 atol=rtol=1e-4, bf16 2e-2); max |kernel - plain| per group:")
    for key, err in worst.items():
        print(f"    {key:16s} {err:.3e}")
    return {"max_abs_err": max(worst.values()),
            "max_abs_err_f32": max(e for k, e in worst.items() if k.endswith("float32"))}


def phase_moe_gmm_timing() -> list[dict]:
    """Times at granite-moe-3b-a800m's serving shapes, bf16."""
    print(f"[kernels] moe_gmm at {MOE_ARCH} serving shapes (bf16), ms per call; graph = device time in a "
          "CUDA graph, eager = launched from Python, library = torch.bmm, timed only")
    print(f"    {'GEMM':>4s} {'E':>3s} {'C':>3s} {'D':>5s} {'F':>5s} {'kernel':>9s} {'kern eager':>10s} "
          f"{'plain':>9s} {'library':>9s} {'bound':>9s}")
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
              f"{row['plain_ms']:>9.5f} {row['library_ms']:>9.5f} {row['bound_ms']:>9.6f} ({row['bound_by']})")
    return rows


def ssd_operands(B, H, T, P, N, bc_dtype, seed):
    """xb (B, H, T, P) and a (B, H, T) float32 as views of (B, T, H, ...)
    storage, as the model passes them; Bm, Cm (B, T, N) in ``bc_dtype``.
    The kernel test's distributions, B and C scaled by 1/sqrt(N)."""
    rng = np.random.default_rng(seed)
    xb = torch.from_numpy(rng.normal(size=(B, T, H, P)).astype(np.float32)).to(DEV).transpose(1, 2)
    a = torch.from_numpy((-np.abs(rng.normal(size=(B, T, H))) * 0.2).astype(np.float32)).to(DEV).transpose(1, 2)
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
    worst: dict[str, float] = {}
    cases = 0
    for i, (label, B, H_, T, P_, N_) in enumerate(shapes):
        for bc_dtype in (torch.float32, torch.bfloat16):
            xb, a, Bm, Cm = ssd_operands(B, H_, T, P_, N_, bc_dtype, seed=i)
            y, h = ssd_scan(xb, a, Bm, Cm)
            torch.cuda.synchronize()
            y_want, h_want = ssd_scan_plain(xb, a, Bm, Cm)
            wants = [("y", y, y_want), ("h_final", h, h_want)]
            if T <= 64:
                wants.append(("y vs oracle", y, ssd_scan_ref(xb, a, Bm, Cm)))
            for what, got, want in wants:
                diff = (got - want).abs()
                if not torch.isfinite(got).all() or bool((diff > 2e-4 + 2e-4 * want.abs()).any()):
                    raise AssertionError(
                        f"ssd_scan {label} {(B, H_, T, P_, N_)} B/C {bc_dtype}: {what} max |kernel - want| "
                        f"= {float(diff.max()):.3g} beyond atol = rtol = 2e-4"
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
          "call; graph = device time in a CUDA graph, eager = launched from Python; no library call computes SSD")
    print(f"    {'B':>2s} {'T':>5s} {'kernel':>10s} {'kern eager':>10s} {'plain':>10s} {'bound':>10s}")
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
              f"{row['bound_ms']:>10.6f} ({row['bound_by']})")
    return rows


def rglru_operands(B, T, W, dtype, seed, *, strided=False):
    """a in U(0.2, 0.999) and b normal, (B, T, W) on the card in ``dtype``
    (the kernel test's distributions).  With ``strided`` each is the
    (B, T, W) view of (T, B, W) storage."""
    rng = np.random.default_rng(seed)

    def mk(x):
        if strided:
            return torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2))).to(DEV, dtype).transpose(0, 1)
        return torch.from_numpy(x).to(DEV, dtype)

    return mk(rng.uniform(0.2, 0.999, (B, T, W)).astype(np.float32)), mk(rng.normal(size=(B, T, W)).astype(np.float32))


def phase_rglru_kernel() -> dict:
    """The RG-LRU scan against its plain version and the sequential oracle
    on the card, within the reference kernel test's 1e-4."""
    W = get_config(RG_ARCH).lru_width
    shapes = [("grid", *s, False) for s in RGLRU_GRID] + [("ragged", *s, st) for s in RGLRU_RAGGED
                                                         for st in (False, True)]
    shapes += [("rgemma", SERVE_SLOTS, T, W, False) for T in (4, 24, 35)] + [("rgemma", 1, 300, W, False)]
    worst: dict[str, float] = {}
    cases = 0
    for i, (label, B, T, W_, strided) in enumerate(shapes):
        for dtype in (torch.float32, torch.bfloat16):
            a, b = rglru_operands(B, T, W_, dtype, seed=i, strided=strided)
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
          "time in a CUDA graph, eager = launched from Python; no library call computes the recurrence")
    print(f"    {'B':>2s} {'T':>5s} {'kernel':>10s} {'kern eager':>10s} {'plain':>10s} {'bound':>10s}")
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
              f"{row['bound_ms']:>10.6f} ({row['bound_by']})")
    return rows


def reset_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0


def read_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in COUNTED}


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
    return {
        "matmul_requant": 0,
        "flash_attention": n["attn"] * prefills,
        "moe_gmm": 3 * n["moe"] * (prefills + decode_steps),
        "ssd_scan": n["ssd"] * prefills,
        "rglru_scan": n["rglru"] * prefills,
    }


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
    card (the kernels) against a copy on the CPU (plain versions), a
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
    reset_counts()
    with torch.inference_mode():
        lg, cache = gpu.prefill(toks.to(DEV), max_len=max_len)
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
            lg, cache = gpu.decode_step(cache, nxt.to(DEV), prompt + step)
            want, want_cache = cpu.decode_step(want_cache, nxt, prompt + step)
    counts = read_counts()
    check_counts(f"LM parity {arch}", counts, expected_counts(cfg, prefills=1, decode_steps=4))
    check_rings(arch, cache, cfg, max_len, prompt + 3)
    print(f"[lm] {cfg.name} full width x {cfg.n_layers} layers fp32: prefill of {prompt} + 4 greedy steps, "
          "card vs cpu "
          f"max |logit diff| {worst:.3e} (atol=rtol=1e-3), tokens identical {tokens}, "
          f"launches {counts}, {time.perf_counter() - t0:.1f} s" + (f"; {decays}" if decays else ""))
    del cpu, gpu, cache, want_cache
    gc.collect()
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, "launches": counts}


class TimedLM:
    """The serving engine's model, with each prefill and decode step timed
    on the host clock between ``torch.cuda.synchronize()`` calls and its
    logits checked finite.  Everything else passes through."""

    def __init__(self, lm):
        self.lm = lm
        self.prefill_ms: list[tuple[tuple, float]] = []
        self.decode_ms: list[float] = []
        self.finite = True

    def __getattr__(self, name):
        return getattr(self.lm, name)

    def _timed(self, fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        self.finite &= bool(torch.isfinite(out[0]).all())
        return out, ms

    def prefill(self, tokens, max_len=None):
        out, ms = self._timed(self.lm.prefill, tokens, max_len=max_len)
        self.prefill_ms.append((tuple(tokens.shape), ms))
        return out

    def decode_step(self, cache, tokens, position):
        out, ms = self._timed(self.lm.decode_step, cache, tokens, position)
        self.decode_ms.append(ms)
        return out


def decode_breakdown(lm, steps: int = 3) -> None:
    """Where a decode step's time goes: ``torch.profiler`` over ``steps``
    decode steps at the serving shape (4 slots, 24 positions filled),
    device kernel time by name against the host clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    B, S = SERVE_SLOTS, 24
    with torch.inference_mode():
        toks = torch.zeros((B, S), dtype=torch.int64, device=DEV)
        _, cache = lm.prefill(toks, max_len=serve.MAX_LEN)
        nxt = torch.zeros(B, dtype=torch.int64, device=DEV)
        lm.decode_step(cache, nxt, S)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                lm.decode_step(cache, nxt, S + 1 + i)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    if not by_name:
        print(f"[serve] decode breakdown: wall {wall_ms:.3f} ms per step; device time not measured "
              "(the profiler recorded no CUDA events)")
        return
    busy_ms = sum(sum(v) for v in by_name.values()) / 1e3 / steps
    launches = sum(len(v) for v in by_name.values()) / steps
    print(f"[serve] decode breakdown (torch.profiler, {steps} steps, B={B}): wall {wall_ms:.3f} ms per step, "
          f"device busy {busy_ms:.3f} ms ({launches:.0f} device ops per step), "
          f"device idle {100 * (1 - busy_ms / wall_ms):.1f} %; top device ops, ms per step:")
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:6]
    for name, us in top:
        print(f"    {sum(us) / 1e3 / steps:8.4f}  x{len(us) // steps:<4d} {name[:100]}")


def phase_serve(arch: str) -> dict:
    """launch.serve's engine on ``arch``, full width and depth, bf16."""
    cfg = get_config(arch)
    t0 = time.perf_counter()
    eng = serve.build_engine(cfg, "cuda", slots=SERVE_SLOTS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    timed = TimedLM(eng.model)
    eng.model = timed
    serve.submit_requests(eng, cfg, SERVE_REQUESTS, SERVE_NEW)
    # the main path: counts from 0 just before, read just after
    reset_counts()
    t1 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    counts = read_counts()
    prefills, steps = len(timed.prefill_ms), len(timed.decode_ms)
    check_counts(f"serve {arch}", counts, expected_counts(cfg, prefills, steps))
    if steps != eng.decode_steps:
        raise AssertionError(f"serve {arch}: {steps} timed decode steps, the engine counted {eng.decode_steps}")
    if sorted(r.rid for r in done) != list(range(SERVE_REQUESTS)):
        raise AssertionError(f"serve {arch}: served {[r.rid for r in done]}, expected all {SERVE_REQUESTS}")
    for r in done:
        if len(r.out_tokens) != SERVE_NEW or r.truncated or not all(0 <= t < cfg.vocab for t in r.out_tokens):
            raise AssertionError(f"serve {arch}: request {r.rid} gave {r.out_tokens} (truncated={r.truncated})")
    if not timed.finite:
        raise AssertionError(f"serve {arch}: logits not finite")
    new_tokens = sum(len(r.out_tokens) for r in done)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"[serve] rid={r.rid} prompt_len={len(r.prompt)} out={r.out_tokens}")
    dec = sorted(timed.decode_ms)
    print(f"[serve] {cfg.name} full width x {cfg.n_layers} layers bf16 ({sum(p.numel() for p in eng.model.parameters()) / 1e9:.2f} B params), "
          f"slots {SERVE_SLOTS}, max_len {serve.MAX_LEN}: weights built in {build_s:.2f} s; "
          f"{len(done)} requests, {new_tokens} tokens in {run_s:.3f} s ({new_tokens / run_s:.1f} tok/s); "
          f"refills {eng.refills}, decode steps {eng.decode_steps}, {prefills} prefills; launches {counts}")
    print("[serve] prefill ms (tokens shape): "
          + ", ".join(f"{ms:.3f} {list(shape)}" for shape, ms in timed.prefill_ms))
    print(f"[serve] decode ms per step: median {dec[len(dec) // 2]:.3f}, min {dec[0]:.3f}, max {dec[-1]:.3f} "
          f"over {len(dec)} steps")
    decode_breakdown(timed.lm)
    del eng, timed, done
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": counts, "prefills": prefills, "decode_steps": steps}


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
    resolve_device("cuda")  # IEEE fp32 matmuls on the card (TF32 off) for every comparison

    phase_build()
    gemm = phase_gemm_kernel()
    flash = phase_flash_kernel()
    flash_rows = phase_flash_timing()
    gmm = phase_moe_gmm_kernel()
    gmm_rows = phase_moe_gmm_timing()
    ssd = phase_ssd_kernel()
    ssd_rows = phase_ssd_timing()
    rglru = phase_rglru_kernel()
    rglru_rows = phase_rglru_timing()
    rg_flash_rows = phase_rg_flash_timing()
    cnn = phase_cnn_path()
    for arch in (LM_ARCH, MOE_ARCH, SSD_ARCH):
        phase_lm_parity(arch)
    # one (rglru, rglru, local_attn) period; the prompt fills the 2048-slot
    # ring (S % L == 0, clear of ROADMAP C-ref-6) and decode wraps it
    phase_lm_parity(RG_ARCH, n_layers=3, prompt=get_config(RG_ARCH).local_window,
                    prepare=lambda lm: draw_rglru_decays(lm, seed=1))
    served = {arch: phase_serve(arch) for arch in (LM_ARCH, MOE_ARCH, SSD_ARCH, RG_ARCH)}

    def shapes(rows):
        return [{k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")} for r in rows]

    big = max(gemm["rows"], key=lambda r: r["shape"][1] * r["shape"][2])
    entries = [
        kernel_entry("matmul_requant", cnn["launches"], gemm, big),
        # the serving engine's prefill shape first
        kernel_entry("flash_attention", served[LM_ARCH]["launches"]["flash_attention"], flash, flash_rows[0],
                     max_abs_err_f32=flash["max_abs_err_f32"], prefill_shapes=shapes(flash_rows),
                     launches_granite_moe=served[MOE_ARCH]["launches"]["flash_attention"],
                     local_attn_shapes=shapes(rg_flash_rows),
                     launches_recurrentgemma=served[RG_ARCH]["launches"]["flash_attention"]),
        kernel_entry("moe_gmm", served[MOE_ARCH]["launches"]["moe_gmm"], gmm, gmm_rows[0],
                     max_abs_err_f32=gmm["max_abs_err_f32"], serve_shapes=shapes(gmm_rows)),
        kernel_entry("ssd_scan", served[SSD_ARCH]["launches"]["ssd_scan"], ssd, ssd_rows[0],
                     prefill_shapes=shapes(ssd_rows)),
        kernel_entry("rglru_scan", served[RG_ARCH]["launches"]["rglru_scan"], rglru, rglru_rows[0],
                     prefill_shapes=shapes(rglru_rows)),
    ]
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

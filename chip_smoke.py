"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
``nvcc``; run from the root of a checkout.  Phases, each raising on
failure:

1. the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the main path compiled by ``nvcc`` from
   ``src/repro_torch/kernels/csrc`` (build seconds, ``-Xptxas -v``);
3. kernels: each kernel's wrapper on the card against its plain PyTorch
   version, bit-exact (tolerance 0: integer arithmetic), on the main
   path's shapes, the test grid and ragged shapes, both roundings, ReLU
   on and off; then times at the main path's shapes;
4. path: the four MLPerf-Tiny nets x {gap9, diana} through
   ``repro_torch.core.dispatch`` -> ``repro_torch.backend.lower`` (default
   device) -> 4 requests through ``CompiledModel.run``, each output
   bit-exact with the port's CPU interpreter, and the kernel launch count
   equal to (GEMM segments) x 4 requests;
5. one JSON line of per-kernel numbers, the card line, and last the
   ``{"ok": true, "device": ...}`` line.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout.  Imports nothing of JAX or of the reference package ``repro``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np  # noqa: E402

from repro_torch.backend import lower  # noqa: E402
from repro_torch.cnn import (  # noqa: E402
    execute_graph,
    init_graph_params,
    mlperf_tiny_networks,
    params_to_torch,
)
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.matmul_requant import matmul_requant, matmul_requant_plain  # noqa: E402

DEV = torch.device("cuda")
NETS = ("MobileNet", "ResNet", "DSCNN", "DAE")
TARGETS = ("gap9", "diana")
REQUESTS = 4
# H100 SXM data sheet: HBM3 bytes/s and dense int8 tensor-core ops/s
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
# (K, N) of every dense on the main path; all run at M = 1
MAIN_KN = ((640, 128), (128, 128), (128, 8), (8, 128), (128, 640), (64, 10), (256, 2), (64, 12))
GRID_MKN = ((8, 16, 128), (32, 64, 128), (128, 128, 256), (16, 96, 384), (3, 37, 11), (48, 80, 112))


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
    info = _build.build("matmul_requant")
    how = f"built in {info.seconds:.2f} s" if info.seconds else "reused an earlier build"
    print(f"[build] matmul_requant: {how} -> {info.path}")
    print("[build] nvcc -Xptxas -v:")
    for line in info.ptxas.strip().splitlines():
        print(f"    {line}")


def phase_kernels() -> dict:
    """Bit-exact checks, then times at the main path's shapes."""
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
        nbytes = 1 * k + k * n + 8 * n + 1 * n
        row["bound_ms"] = max(nbytes / HBM_BYTES_S, 2 * 1 * n * k / INT8_OPS_S) * 1e3
        row["bound_by"] = "bytes" if nbytes / HBM_BYTES_S >= 2 * n * k / INT8_OPS_S else "operations"
        rows.append(row)
        print(f"    {k:>4d} {n:>4d} {row['ms']:>9.5f} {row['eager_ms']:>10.5f} "
              f"{row['plain_ms']:>9.5f} {row['library_ms']:>9.5f} {row['bound_ms']:>9.6f}")
    return {"max_abs_err": worst, "rows": rows}


def phase_path() -> dict:
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
            matmul_requant.launches = 0
            outs, req_ms = [], []
            for x in requests:
                t1 = time.perf_counter()
                out = cm.run(dev_params, x)
                torch.cuda.synchronize()
                req_ms.append((time.perf_counter() - t1) * 1e3)
                outs.append(out)
            launches = matmul_requant.launches
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


def main() -> None:
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    phase_build()
    kern = phase_kernels()
    path = phase_path()

    big = max(kern["rows"], key=lambda r: r["shape"][1] * r["shape"][2])
    entry = {
        "name": "matmul_requant",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul_requant.cu",
        "replaces": "src/repro/kernels/matmul_requant.py:45",
        "launches": path["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": big["library_ms"],
        "shape": big["shape"],
        "eager_ms": big["eager_ms"],
    }
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

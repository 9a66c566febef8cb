"""One run of one cell: set-up, the measured window, the traced stretch,
then the check against the plain reference.

The cell's data names every part that is not common to all cells: the
configuration its graph builder, reference, need counts and check rule,
the mix the loop that drives the window (:mod:`bench.spec`, which lists
what each of those files holds).  Inputs are a seeded pool of samples,
the builder's ``draw``, taken in a seeded order.  Before the window they
are put in host memory in the dtype the entry takes (the configuration's
``input.dtype``: float32 for the int8 nets, since the port's conv route
takes no int8), as LoadGen's sample library loads samples before a run.
The builder's ``build_program`` (for the int8 nets: the graph dispatched
and lowered) goes to the loop's ``prepare``.  A seeded reservoir of
answers is kept and, once the window has closed and the program's state
is freed, held against the configuration's plain reference by its check
rule: bit for bit where the configuration states none
(``bench/checks/exact.py``).
"""

from __future__ import annotations

import gc
import json
import random
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

import numpy as np
import torch

from bench import spec
from bench.trace import Stretch, TraceReading

__all__ = ["Feed", "Run", "check", "run_cell"]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SEQ_LEN = 1 << 20  # the seeded order of pool inputs, wrapped


@dataclass
class Run:
    """What one run measured; the metric readers read it."""

    config: dict
    counts: ModuleType  # the configuration's need counts
    peaks: dict
    seconds: float
    setup_s: float = 0.0
    compile_s: float = 0.0
    compile_parts: dict = field(default_factory=dict)  # host seconds of each stage of build_program
    window_s: float = 0.0
    latencies_s: list = field(default_factory=list)  # every request of the window
    attempted: int = 0
    failed: int = 0
    samples: int = 0  # answers completed in the window
    # the traced run.  The profiler slows the host, so host-clock readings
    # are taken outside the disturbed part (profiler start to stop) and the
    # device readings inside the stretch
    spans: list = field(default_factory=list)  # host spans (label, start, end) in the stretch
    host_calls_s: list = field(default_factory=list)  # the entry's call seconds, outside
    outside_s: float = 0.0  # the window less the disturbed part
    outside_samples: int = 0
    stretch_s: float = 0.0
    stretch_rows: list = field(default_factory=list)  # useful rows of each batch run in the stretch
    trace: TraceReading | None = None

    def need_s(self, rows: int) -> float:
        """The least device seconds of one batch of ``rows`` samples."""
        return self.counts.need_s_of(self.config, rows, self.peaks)

    def macs(self) -> int:
        return self.counts.macs_of(self.config)

    # the readers of the traced stretch: None where it has nothing to read
    def roofline_pct(self) -> float | None:
        """The stretch's need over the union of its device kernels."""
        if self.trace is None or not self.stretch_rows or self.trace.kernel_s <= 0:
            return None
        return 100.0 * sum(self.need_s(r) for r in self.stretch_rows) / self.trace.kernel_s

    def mfu_pct(self) -> float | None:
        """2 x MACs of the samples completed outside the profiler, per second, over the peak."""
        if not self.outside_samples or self.outside_s <= 0:
            return None
        peak = self.peaks[self.config["precision"]["peak"]]
        return 100.0 * 2 * self.macs() * self.outside_samples / self.outside_s / peak

    def idle_pct(self) -> float | None:
        """1 - the union of the device's activity in the stretch over the
        stretch, both from the trace alone.  The profiler slows the host
        (CUPTI instruments every replayed graph node), so this reads more
        idle than the untraced window is: :meth:`host_slowdown` says by how
        much the host was slowed."""
        if self.trace is None or self.trace.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def host_slowdown(self) -> float | None:
        """Samples per second outside the profiler over those inside the stretch."""
        if not self.stretch_rows or self.stretch_s <= 0 or self.outside_s <= 0:
            return None
        return (self.outside_samples / self.outside_s) / (sum(self.stretch_rows) / self.stretch_s)


@dataclass
class Feed:
    """What a loop drives the window with."""

    params: dict  # the program's parameters
    samples: list  # host tensors in the entry's dtype, the pool
    warm_order: list  # pool indices of the warm-up, in order
    order: list  # pool indices of the window, in order; a power of two long
    name: str  # the net's input
    keep: "Reservoir"  # offered (pool index, {output: host tensor}) for each answer
    dev: torch.device
    trace: bool


class Reservoir:
    """A seeded uniform sample of ``k`` answers out of a stream."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, random.Random(seed), 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# -- the check ------------------------------------------------------------------


def check(config: dict, drawn, kept: list, *, device: torch.device = torch.device("cpu"),
          bench_dir: Path = spec.BENCH) -> dict[str, tuple[float, float]]:
    """Hold each kept answer ``(pool index, {output: tensor})`` against the
    plain reference's answer for that input by the configuration's check
    rule (:func:`bench.spec.check_rule`), TF32 off in the reference and
    restored after it.  Returns each number the rule compares with the
    most it may read, in the order printed."""
    rule, rule_mod = spec.check_rule(config, bench_dir)
    reference = spec.named(bench_dir, "reference", config["reference"])
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return rule_mod.judge(config, rule, drawn, kept, reference, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


# -- one run --------------------------------------------------------------------


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def run_cell(checkout: Path, workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t_process: float | None = None, bench_dir: Path = spec.BENCH) -> dict:
    """One run of ``workload``; returns the result line's object (the
    ``checks`` key last).  ``t_process`` is when the process started,
    on ``perf_counter``, so that set-up counts the imports."""
    t_process = time.perf_counter() if t_process is None else t_process
    from repro_torch._device import resolve_device

    cell = spec.load_cell(checkout, workload, bench_dir)
    cfg, mix = cell.config, cell.mix
    loop = spec.named(bench_dir, "loops", mix["loop"])
    builder = spec.named(bench_dir, "graphs", cfg["graph"])
    dev = resolve_device(device)
    peaks = json.loads((bench_dir / "peaks.json").read_text())[cfg["target"]]
    run = Run(config=cfg, counts=spec.named(bench_dir, "reference", cfg["counts"]), peaks=peaks,
              seconds=float(seconds))
    drawn = builder.draw(cfg, seed, mix["pool"], dev)
    order = np.random.default_rng(seed).integers(0, mix["pool"], size=SEQ_LEN).tolist()
    n_warm = mix.get("warmup", 0)
    # the samples sit in host memory in the dtype the compiled entry takes
    # before the run, as LoadGen's sample library loads them
    feed = Feed(params=builder.program_params(cfg, drawn),
                samples=[x.to(getattr(torch, cfg["input"]["dtype"])) for x in drawn.pool],
                warm_order=order[:n_warm], order=order[n_warm:] + order[:n_warm], name=cfg["input"]["name"],
                keep=Reservoir(mix["check_answers"], seed), dev=dev, trace=trace)
    builder.prepare_device(cfg, dev)
    _sync(dev)

    # compile: the builder's program (the int8 nets: dispatch and lower), and the loop's prepare
    # (the capture of the cell's own signature)
    t0 = time.perf_counter()
    program, run.compile_parts = builder.build_program(cfg, feed.params, dev)
    _sync(dev)
    t2 = time.perf_counter()
    entry = loop.prepare(program, feed, mix)
    _sync(dev)
    run.compile_s = time.perf_counter() - t0
    parts = ", ".join(f"{k} {v:.4f}" for k, v in run.compile_parts.items())
    print(f"bench: compile_s {run.compile_s:.4f}: build_program {t2 - t0:.4f} ({parts}), "
          f"prepare {run.compile_s - (t2 - t0):.4f}", file=sys.stderr)

    if trace:
        Stretch(dev).prime()
    loop.warm(entry, feed, mix)  # the path the window drives, uncounted
    _sync(dev)
    run.setup_s = time.perf_counter() - t_process

    gc.collect()
    gc.freeze()  # set-up's objects leave the collector's generations: its passes in the window stay short
    try:
        loop.drive(run, entry, feed, mix)
    finally:
        if hasattr(loop, "close"):
            loop.close(entry)

    # the window has closed: the device reading, then the program's state freed
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0}
    if trace:
        slowdown = run.host_slowdown()
        print(f"bench: traced stretch {sum(run.stretch_rows)} samples in {run.stretch_s:.4f} s, device busy "
              f"{run.trace.busy_s if run.trace else 0.0:.4f} s; outside the profiler {run.outside_samples} samples "
              f"in {run.outside_s:.4f} s; the profiler slowed the host {slowdown}x", file=sys.stderr)
        device_info["busy_s"] = run.trace.busy_s if run.trace else 0.0
        device_info["window_s"] = run.trace.window_s if run.trace else run.stretch_s
        device_info["trace_host_slowdown"] = slowdown
        if run.trace is not None:
            device_info["trace_sync_error_us"] = run.trace.sync_error_us
            device_info["trace_events"] = run.trace.events
    leaked = sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
    if leaked:
        raise ImportError(f"the run loaded {', '.join(leaked)}: the benchmark runs without JAX and the JAX package")
    kept = [(p, {k: v.cpu() for k, v in out.items()}) for p, out in feed.keep.items]
    del feed, entry, program
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    metrics = {}
    for m in spec.metrics_of(cell, trace):
        value = spec.reader(cell, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": value, "limit": limit, "holds": "<="}
              for k, (value, limit) in check(cfg, drawn, kept, device=dev, bench_dir=bench_dir).items()}
    checks["failed_requests"] = {"value": run.failed, "limit": 0, "holds": "<="}
    checks["checked_answers"] = {"value": len(kept), "limit": 1, "holds": ">="}
    correct = all(c["value"] <= c["limit"] if c["holds"] == "<=" else c["value"] >= c["limit"]
                  for c in checks.values())
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
              "device": device_info}
    card = _power_limit() if dev.type == "cuda" else None
    if card:
        result["device"]["card"] = card
    if trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops, "idle_gaps": run.trace.idle_gaps}
    result["checks"] = checks
    return result


def check_lines(checks: dict) -> list[str]:
    return [f"check {k} {c['value']} {c['holds']} {c['limit']}" for k, c in checks.items()]

"""Finds what ``BENCHMARK.json`` names, by name, inside a checkout.

A cell names a configuration (its file is given in ``BENCHMARK.json``)
and a traffic mix (``bench/mixes/<traffic>.json``).  A mix names the loop
that drives it (``bench/loops/<loop>.py``); a configuration names its
graph builder (``bench/graphs/<graph>.py``), its plain reference and its
need counts (``bench/reference/<reference>.py``, ``<counts>.py``); every
metric has a reader of its own (``bench/metrics/<name>.py``, a function
``read(run)`` returning a number or ``None``).  Adding a cell, a mix, a
loop, a configuration or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

__all__ = ["Cell", "load_cell", "load_module", "metrics_of", "named", "reader"]

BENCH = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    benchmark: dict
    bench_dir: Path


def load_module(path: Path) -> ModuleType:
    """Import one file of the benchmark by its path (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location("bench_file_" + re.sub(r"\W", "_", path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def named(bench_dir: Path, folder: str, name: str) -> ModuleType:
    """The file ``bench/<folder>/<name>.py`` that a cell's data names."""
    return load_module(bench_dir / folder / f"{name}.py")


def load_cell(checkout: Path, workload: str, bench_dir: Path = BENCH) -> Cell:
    benchmark = json.loads((checkout / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[workload]
    entry = next(c for c in benchmark["configs"] if c["name"] == w["config"])
    config = json.loads((checkout / entry["file"]).read_text())
    mix = json.loads((bench_dir / "mixes" / f"{w['traffic']}.json").read_text())
    return Cell(workload, int(w["chips"]), config, mix, benchmark, bench_dir)


def metrics_of(cell: Cell, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end ones with
    ``trace`` off, its per-layer ones with it on."""
    e2e = [m for m in cell.benchmark["end_to_end"] if cell.name in m.get("workloads", [cell.name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in cell.benchmark["per_layer"]
            if (cell.name in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def reader(cell: Cell, metric: str):
    return named(cell.bench_dir, "metrics", metric).read

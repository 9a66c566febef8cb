"""Finds what ``BENCHMARK.json`` names, by name, inside a checkout.

A cell names a configuration (its file is given in ``BENCHMARK.json``)
and a traffic mix (``bench/mixes/<traffic>.json``).  A mix names the loop
that drives it (``bench/loops/<loop>.py``); a configuration names its
graph builder (``bench/graphs/<graph>.py``), its plain reference and its
need counts (``bench/reference/<reference>.py``, ``<counts>.py``) and, in
an optional ``"check"`` block, the rule its answers are held to
(``bench/checks/<rule>.py``; ``exact`` where there is no block); every
metric has a reader of its own (``bench/metrics/<name>.py``, a function
``read(run)`` returning a number or ``None``).  Adding a cell, a mix, a
loop, a configuration, a rule or a metric adds files and entries and
edits none.

What each file holds (:mod:`bench.graphs.cnn_chain`,
:mod:`bench.loops.closed`, :mod:`bench.reference.counts` and
``bench/checks/exact.py`` are the int8 MATCH nets'):

* a graph builder: ``draw(config, seed, pool, device)``, the run's draw
  from the seed, an object with ``pool`` (host tensors of any dtype, one
  sample each) and ``reference_params()``; ``program_params(config,
  drawn)``, the program's parameters; ``prepare_device(config, dev)``,
  set-up before the compile clock starts; and ``build_program(config,
  params, device)``, the program and the host seconds of each of its
  stages by name (a ``dispatch`` stage is what ``dispatch_s`` reads);
* a loop: ``prepare(program, feed, mix)``, ``warm(entry, feed, mix)``,
  ``drive(run, entry, feed, mix)`` and, optionally, ``close(entry)``;
* need counts: ``macs_of(config)``, the MACs of one sample, and
  ``need_s_of(config, rows, peaks)``, the least device seconds of a batch
  of ``rows`` samples;
* a check rule: ``judge(config, rule, drawn, kept, reference, device)``,
  each number it compares, in the order printed, with the most it may
  read.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

__all__ = ["Cell", "check_rule", "load_cell", "load_module", "metrics_of", "named", "reader"]

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


def check_rule(config: dict, bench_dir: Path = BENCH) -> tuple[dict, ModuleType]:
    """The configuration's ``"check"`` block (``{"rule": "exact"}`` where it
    has none) and the file of its rule."""
    rule = config.get("check", {"rule": "exact"})
    return rule, named(bench_dir, "checks", rule["rule"])

"""The benchmark's import boundary: no JAX and no JAX package in a run, no
program in the reference, nothing read from the JAX package's folder."""

import json
import subprocess
import sys

from conftest import CHECKOUT, checkout_copy

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _modules_after(code: str) -> set[str]:
    prog = (
        f"import sys, json; sys.path[:0] = [{str(CHECKOUT / 'src')!r}, {str(CHECKOUT)!r}]\n"
        + code
        + "\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    )
    out = subprocess.run([sys.executable, "-c", prog], cwd=CHECKOUT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    """The harness's modules, every loop, graph builder and metric reader,
    and a short run of a cell's set-up plumbing and window on the CPU."""
    root = checkout_copy(tmp_path)
    tops = _modules_after(
        "from pathlib import Path\n"
        "from bench import harness, spec, trace, data\n"
        "for d in ('metrics', 'loops', 'graphs'):\n"
        "    for f in sorted(Path('bench', d).glob('*.py')): spec.load_module(f)\n"
        f"r = harness.run_cell(Path({str(root)!r}), 'dae_toycar.single', 3, 0.3, True, device='cpu')\n"
        "assert r['correct'], r\n"
    )
    assert "repro_torch" in tops
    assert not tops & set(FORBIDDEN), sorted(tops & set(FORBIDDEN))


def test_the_reference_loads_no_program():
    tops = _modules_after("import bench.reference.cnn_int, bench.reference.counts")
    assert not tops & {"repro_torch", "torch", *FORBIDDEN}


def test_nothing_names_the_jax_packages_benchmarks():
    for f in (CHECKOUT / "bench").rglob("*"):
        if f.is_file() and f.suffix in (".py", ".json", ".md", ".txt") and f.name != "test_bench_imports.py":
            assert "benchmarks/" not in f.read_text(), f

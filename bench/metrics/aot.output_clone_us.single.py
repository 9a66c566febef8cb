"""Mean microseconds of the program's `aot.output_clone` span (the copies of the outputs) over window C
(bench/program_spans.py)."""

from bench import program_spans


def read(run):
    r = program_spans.reading(run)
    return r.phase_us.get("aot.output_clone") if r else None

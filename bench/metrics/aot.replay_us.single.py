"""Mean microseconds of the program's `aot.replay` span (the host call that launches the graph) over
window C (bench/program_spans.py)."""

from bench import program_spans


def read(run):
    r = program_spans.reading(run)
    return r.phase_us.get("aot.replay") if r else None

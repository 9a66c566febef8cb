"""Mean microseconds of the program's `aot.input_copy` span (the copy into the static inputs) over
window C (bench/program_spans.py)."""

from bench import program_spans


def read(run):
    r = program_spans.reading(run)
    return r.phase_us.get("aot.input_copy") if r else None

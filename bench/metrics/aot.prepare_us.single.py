"""Mean microseconds of the program's `aot.prepare` span (coercion, signature, entry lookup and lock of
AotModel.run) over window C, the requests after the window with the tracer on and no profiler
(bench/program_spans.py)."""

from bench import program_spans


def read(run):
    r = program_spans.reading(run)
    return r.phase_us.get("aot.prepare") if r else None

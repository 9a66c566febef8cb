"""The share of stretch B's requests in which the device is idle while the host is inside an `aot.*` span
of the program, in %: idle from the profiler's trace, spans from the program's tracer, on one clock
(bench/program_spans.py)."""

from bench import program_spans


def read(run):
    r = program_spans.reading(run)
    return r.b.idle_in_aot_pct if r and r.b else None

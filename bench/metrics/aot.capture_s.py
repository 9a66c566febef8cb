"""Seconds of the program's `aot.capture` span (the CUDA graph capture inside compile_aot's warm-up) in a
second, traced compile of the net after the window (bench/program_spans.py)."""

from bench import program_spans


def read(run):
    r = program_spans.reading(run)
    return r.capture_s if r else None

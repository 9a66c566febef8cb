"""Seconds of the program's `dispatch.dse_flush` span (the LOMA searches of the dispatch) in a second,
traced dispatch of the net after the window, the schedule cache cleared (bench/program_spans.py)."""

from bench import program_spans


def read(run):
    r = program_spans.reading(run)
    return r.dse_s if r else None

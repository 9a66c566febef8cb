"""LOMA candidates the set-up's dispatch evaluated: the program's `dse.candidates` counter when the
window has closed (bench/program_spans.py)."""

from bench import program_spans


def read(run):
    r = program_spans.reading(run)
    return r.dse_candidates if r else None

"""The need of the layers the `tiled_conv` segments cover (bench/reference/counts.py, int8 as declared)
over the union of those segments' device kernels in stretch B's matched replays, in %
(bench/program_spans.py)."""

from bench import program_spans


def read(run):
    r = program_spans.reading(run)
    return r.b.tiled_conv_roofline_pct if r and r.b else None

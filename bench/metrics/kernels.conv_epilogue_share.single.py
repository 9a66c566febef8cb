"""Device seconds of the `tiled_conv` segments' epilogue nodes (bias_add, requant, relu) over all their
device seconds in stretch B's matched replays, in % (bench/program_spans.py)."""

from bench import program_spans


def read(run):
    r = program_spans.reading(run)
    return r.b.conv_epilogue_pct if r and r.b else None

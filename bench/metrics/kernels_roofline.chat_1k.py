"""The stretch's need (each request a prefill and its decode steps, each phase at max(bytes / HBM bytes/s,
2 x MACs / bf16 peak), bench/reference/granite_counts.py) over the union of its device kernels, in %."""


def read(run):
    return run.roofline_pct()

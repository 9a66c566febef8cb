"""The share of the traced stretch in which the device is idle, in %: 1 - the union of its kernels, copies
and memsets over the stretch, both from the trace alone."""


def read(run):
    return run.idle_pct()

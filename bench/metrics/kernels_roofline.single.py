"""The stretch's need (each batch of the net at its useful rows, int8 as declared) over the union of its
device kernels, in %."""


def read(run):
    return run.roofline_pct()

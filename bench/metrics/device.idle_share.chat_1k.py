"""The share of the traced stretch in which the device is idle, in %: 1 - the union of its kernels, copies
and memsets over the stretch, both from the trace alone.  The stretch holds whole requests; the profiler
slows the host (the result's ``device.trace_host_slowdown``), so it reads idler than the untraced window."""


def read(run):
    return run.idle_pct()

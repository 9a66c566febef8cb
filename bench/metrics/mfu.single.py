"""2 x MACs of the samples the traced run completed outside the profiler, per second, over the int8 dense
peak, in %."""


def read(run):
    return run.mfu_pct()

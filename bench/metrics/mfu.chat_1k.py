"""2 x MACs of the requests the traced run completed outside the profiler (prefill and decode steps,
bench/reference/granite_counts.py), per second, over the bf16 dense peak, in %."""


def read(run):
    return run.mfu_pct()

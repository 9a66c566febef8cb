"""Mean host microseconds of AotModel.run, call to return, over the traced run's requests outside the
profiler."""


def read(run):
    return 1e6 * sum(run.host_calls_s) / len(run.host_calls_s) if run.host_calls_s else None

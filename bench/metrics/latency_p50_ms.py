"""Median host-clock latency of every request of the window, in ms."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s, 50)) * 1e3 if run.latencies_s else None

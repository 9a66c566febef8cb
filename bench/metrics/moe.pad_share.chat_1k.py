"""The share of the rows the MoE's expert products ran that no routed (token, expert) pair filled, in %:
100 x (1 - the program's counter `moe.routed_pairs` / `moe.rows_computed`, models/moe.py) over every
request of the run, its prefills and its decode steps, once the window has closed.  A program without the
counters reads None."""


def read(run):
    from repro_torch import obs

    counters = obs.metrics_dict()["counters"]
    rows = counters.get("moe.rows_computed", 0)
    if "moe.routed_pairs" not in counters or rows <= 0:
        return None
    return 100.0 * (1.0 - counters["moe.routed_pairs"] / rows)

"""Mean milliseconds of the program's `serve.prefill` span (ServeEngine: the prefill, its copy into the
decode graph's cache and the first token's sampling, ending with the logits in host memory) over the
traced run's window outside the profiler (bench/loops/served.py).  A program without the span reads None."""


def read(run):
    s = getattr(run, "served_spans", {}).get("serve.prefill")
    return None if s is None else s * 1e3

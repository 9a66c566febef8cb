"""Mean microseconds of the program's `serve.decode_step` span (ServeEngine: one replay of the decode graph
and its token's sampling, ending with the logits in host memory) over the traced run's window outside the
profiler (bench/loops/served.py).  A program without the span reads None."""


def read(run):
    s = getattr(run, "served_spans", {}).get("serve.decode_step")
    return None if s is None else s * 1e6

"""Host seconds of the dispatch call (the DP partitioner and the LOMA search)."""


def read(run):
    return run.compile_parts.get("dispatch")

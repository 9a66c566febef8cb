"""Host seconds from handing the port the net's graph to an entry ready for the first request: dispatch,
lower and the capture of the cell's own signature, each ending in a synchronize."""


def read(run):
    return run.compile_s

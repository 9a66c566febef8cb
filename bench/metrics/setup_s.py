"""Set-up seconds: process start to the window, imports, build, weights, compile and warm-up."""


def read(run):
    return run.setup_s

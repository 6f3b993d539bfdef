"""Set-up seconds: process start to the window's start (imports, CUDA,
the kernels' build, weights, warm-up)."""


def read(run):
    return run.setup_s

"""setup_s: seconds from the process's start to the window's (weights,
build, kernels loaded or built, graphs, voices, warm-up)."""


def read(run, name):
    return run.setup_s

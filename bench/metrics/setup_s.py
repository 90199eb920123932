"""setup_s: seconds from process start to the window's start (import,
CUDA, data, problem, Solver, warm-up iterations).  Host clock."""


def read(run):
    return run.setup_s

"""setup_s: from the process's start to the end of the warm-up unit:
imports, CUDA initialisation, the kernels' build or load, the scene's
compile and tables, the renderer, and one unit of the cell's shapes."""


def read(run):
    return run.setup_s

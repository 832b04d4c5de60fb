"""setup_s (s, end to end, host clock): the process's start to the
window's: Python and CUDA, loading the port and its built kernels, making
or finding the seed's inputs, and one whole warm analysis."""


def read(run):
    return run.setup_s

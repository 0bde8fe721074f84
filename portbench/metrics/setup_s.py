"""``setup_s``: seconds from the process's start to the window's start:
loading, making the inputs and weights, building and warming up the
program, and in a fresh checkout compiling its kernels."""


def read(run):
    return run.setup_s

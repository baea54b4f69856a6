"""End to end: from the process's start to the first timed call: importing
torch and the program, the CUDA context, loading (or, in a fresh checkout,
building) the kernels' library, making the inputs and the warm-up."""


def read(r):
    return r.setup_s

"""End to end: the program's peak of ``torch.cuda.max_memory_allocated()``
from the warm-up to the window's close: the inputs, the outputs of the
calls in flight and any workspace the program holds.  The outputs the
benchmark holds for its comparison are left out: the peak is read in
segments between them, each less the held bytes live through it."""


def read(r):
    return r.peak_bytes / 2**30 if r.peak_bytes else None

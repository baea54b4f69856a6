"""Per layer (wrappers): the operations that ran on the card in the traced
window (kernels, copies and memsets, whoever launched them) over the calls
made in it."""


def read(r):
    if r.trace is None or not r.trace.device_ops or not r.calls:
        return None
    return len(r.trace.device_ops) / r.calls

"""Per layer (device): the share of the traced window in which no kernel,
copy or memset ran on the card (the union of their intervals), in
percent."""


def read(r):
    if r.trace is None or not r.trace.window or not r.trace.device_ops:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)

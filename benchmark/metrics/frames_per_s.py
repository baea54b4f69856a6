"""End to end: the frames that all calls of the window returned, over the
window's seconds on the host clock (first submission to last completion)."""


def read(r):
    return r.frames / r.window_s if r.calls else None

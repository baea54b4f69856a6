"""End to end: the 95th percentile, over every call completed in the
window, of the host clock from the call's submission to its observed
completion: the moment the caller's wait on the event that follows the
call returns.  With two calls in flight a call waits behind the one before
it, so this is the latency a pipelined caller feels, its queueing in it."""

import numpy as np


def read(r):
    if not r.latency_s:
        return None
    return float(np.percentile(np.asarray(r.latency_s), 95.0)) * 1e3

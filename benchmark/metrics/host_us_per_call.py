"""Per layer (api and wrappers): the host's wall from a call's entry to its
return, the enqueue, as the mean over the window's calls, in microseconds.
In a traced run the profiler's recording of each operator is inside it."""


def read(r):
    return sum(r.host_s) / len(r.host_s) * 1e6 if r.host_s else None

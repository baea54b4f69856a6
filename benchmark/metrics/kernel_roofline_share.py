"""Per layer (kernels): the least time the window's calls need, over the
device time of every operation they ran on the card, whatever its name, in
percent.  The least time of a call is the larger of its bytes over the
card's memory bandwidth and its f32 FMAs over the card's FMA rate
(``benchmark/work.py``, ``benchmark/peaks.json``)."""


def read(r):
    if r.trace is None or r.peaks is None or not r.calls:
        return None
    spent = r.trace.device_seconds()
    if spent <= 0:
        return None
    return 100.0 * r.calls * r.work.least_seconds(r.peaks) / spent

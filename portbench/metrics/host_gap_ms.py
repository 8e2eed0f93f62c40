"""Mean host time from the end of one engine call (decode, prefill,
extend, insert) to the start of the next, over the window: the front
door, the graph server and the Scheduler's own time between calls."""
from statistics import fmean


def read(run):
    calls = run.spans.within(run.t0, run.t_end)
    gaps = [b.t0 - a.t1 for a, b in zip(calls, calls[1:])]
    return fmean(gaps) * 1e3 if gaps else None

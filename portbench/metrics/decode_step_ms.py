"""Mean wall of a decode tick: the span around engine.decode, which ends
once the tick's tokens are copied to the host."""
from statistics import fmean


def read(run):
    ticks = run.spans.within(run.t0, run.t_end, ("decode",))
    return fmean(s.t1 - s.t0 for s in ticks) * 1e3 if ticks else None

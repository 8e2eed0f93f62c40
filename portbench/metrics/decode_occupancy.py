"""Active rows over the decode tick's slots, averaged over the window's
decode ticks, in percent (from the rows each engine.decode was given)."""
from statistics import fmean


def read(run):
    ticks = run.spans.within(run.t0, run.t_end, ("decode",))
    if not ticks:
        return None
    return 100.0 * fmean(s.info["active"] / s.info["rows"] for s in ticks)

"""Wall of the engine's prefill and extend calls per 1000 prompt tokens
they computed, over the window."""


def read(run):
    calls = run.spans.within(run.t0, run.t_end, ("prefill", "extend"))
    tokens = sum(s.info["tokens"] for s in calls)
    if not tokens:
        return None
    return sum(s.t1 - s.t0 for s in calls) * 1e3 / (tokens / 1000.0)

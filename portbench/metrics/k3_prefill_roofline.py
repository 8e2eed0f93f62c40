"""K3 (the flash-attention kernel) timed alone after the window over one
chunk of the cell's chunk size behind the window's mean cached prefix
(over its extend calls), against its bound, in percent."""
from pbcore import costs, kerneltime


def read(run):
    calls = run.spans.within(run.t0, run.t_end, ("extend",))
    if not calls:
        return None
    prefix = round(sum(s.info["prefix"] for s in calls) / len(calls))
    ms, flops, nbytes = kerneltime.k3_prefill(
        run.spec, int(run.mix["chunk"]), prefix, run.device)
    return costs.roofline_pct(flops, nbytes, ms / 1e3)

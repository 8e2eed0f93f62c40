"""K2 (the paged fused flash-decode kernel) timed alone after the window
at the cell's slots, every row at the window's mean context (keys a row
a decode tick), against its bytes or operations bound, in percent."""
from pbcore import costs, kerneltime


def read(run):
    ticks = run.spans.within(run.t0, run.t_end, ("decode",))
    active = sum(s.info["active"] for s in ticks)
    if not active:
        return None
    keys = round(sum(s.info["key_sum"] for s in ticks) / active)
    ms, flops, nbytes = kerneltime.k2_decode(
        run.spec, int(run.mix["slots"]), keys, int(run.mix["block_size"]),
        int(run.mix["max_len"]), run.device)
    return costs.roofline_pct(flops, nbytes, ms / 1e3)

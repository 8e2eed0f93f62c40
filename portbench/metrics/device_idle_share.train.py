"""The share of the profiled part of the window in which no kernel,
copy or fill ran on the card (one minus the union of their intervals
over the window), from torch.profiler, in percent."""


def read(run):
    prof = run.profile
    if not prof or prof["window_s"] <= 0 or not prof["kernels"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])

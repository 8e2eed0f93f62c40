"""The whole training step's share of the card's bf16 peak: the
operations of every step the window ran (6 x the weights multiplied x
tokens, and the attention forward three times, by the benchmark's
formula; no recomputation counted), over the window's seconds x 989e12,
in percent."""
from pbcore import costs


def read(run):
    if not run.window_steps:
        return None
    flops = run.window_steps * costs.train_flops(run.spec, run.rows, run.seq)
    return 100.0 * flops / ((run.t_end - run.t0) * costs.PEAK_BF16_FLOPS)

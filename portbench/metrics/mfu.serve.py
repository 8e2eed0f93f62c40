"""The whole serving step's share of the card's bf16 peak: the
operations of every prompt token computed and every token decoded by the
engine calls that started in the window (weights multiplied and
attention over the keys each token sees, by the benchmark's formula),
over the window's seconds x 989e12, in percent."""
from pbcore import costs


def read(run):
    calls = run.spans.within(run.t0, run.t_end, ("decode", "prefill",
                                                  "extend"))
    tokens = keys = 0
    for s in calls:
        if s.name == "decode":
            tokens += s.info["active"]
            keys += s.info["key_sum"]
        else:
            n, p = s.info["tokens"], s.info["prefix"]
            tokens += n
            keys += n * p + n * (n + 1) // 2
    if not tokens:
        return None
    flops = costs.serve_flops(run.spec, tokens, keys)
    return 100.0 * flops / (run.seconds * costs.PEAK_BF16_FLOPS)

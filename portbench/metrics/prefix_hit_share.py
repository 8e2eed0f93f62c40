"""Prompt tokens served from shared prefix blocks over prompt tokens
ingested, in percent, from the Scheduler's counters across the window
(``prefill_tokens_saved`` is ``shared_block_hits`` x the block size;
``prefill_tokens`` counts the tokens computed)."""


def read(run):
    a, b = run.stats0["scheduler"], run.stats1["scheduler"]
    saved = b["prefill_tokens_saved"] - a["prefill_tokens_saved"]
    computed = b["prefill_tokens"] - a["prefill_tokens"]
    if saved + computed <= 0:
        return None
    return 100.0 * saved / (saved + computed)

"""Self-speculative drafting: prompt-lookup (n-gram) draft proposal.

Speculative decoding trades more compute per tick for fewer ticks per
token: a cheap *drafter* proposes ``k`` continuation tokens, the model
scores the whole window in ONE batched forward pass
(``LLMEngine.verify``), and the scheduler accepts the longest drafted
prefix that matches the model's own greedy argmax chain — so the output
stream is **bit-identical to plain greedy decode** no matter how good or
bad the drafts are (docs/SPECULATIVE.md).

This module is the *drafting policy* half: **prompt lookup** (n-gram
self-speculation, no second model).  The drafter searches the request's
own known sequence (prompt + already-generated tokens) for the most
recent earlier occurrence of its trailing n-gram and proposes the tokens
that followed it.  That is exactly the regime LLM serving workloads are
rich in — retrieval/summarization prompts quoted in the answer, code
edits, chat templates, and greedy decode's own repetition loops — and it
costs microseconds of host time per tick.

The policy is pluggable: ``Scheduler(draft_fn=...)`` accepts any
``draft_fn(context, k) -> np.ndarray`` (at most ``k`` int32 tokens; an
empty draft falls back to plain decode for that tick).  The property
tests exploit this seam by injecting adversarial draft functions and
asserting bit-identity regardless.
"""
from __future__ import annotations

import numpy as np

_EMPTY = np.zeros(0, np.int32)


def lookup_draft(context: np.ndarray, k: int, *, max_ngram: int = 3,
                 min_ngram: int = 1) -> np.ndarray:
    """Prompt-lookup drafting (n-gram self-speculation).

    Searches ``context`` (the request's prompt ++ generated tokens, most
    recent last) for the latest earlier occurrence of its trailing
    ``n``-gram, longest ``n`` first (``max_ngram`` down to
    ``min_ngram``), and proposes up to ``k`` tokens that followed that
    occurrence.  Returns an int32 array of length ``0..k`` — empty when
    no n-gram recurs, which makes the scheduler fall back to a plain
    decode tick.
    """
    context = np.asarray(context, np.int32).reshape(-1)
    n_ctx = context.size
    if k <= 0 or n_ctx < min_ngram + 1:
        return _EMPTY
    for n in range(min(max_ngram, n_ctx - 1), min_ngram - 1, -1):
        tail = context[n_ctx - n:]
        # candidate window starts j < n_ctx - n (exclude the tail itself,
        # and guarantee at least one following token to propose)
        windows = np.lib.stride_tricks.sliding_window_view(context, n)
        hits = np.nonzero((windows[:n_ctx - n] == tail).all(axis=1))[0]
        if hits.size:
            j = int(hits[-1])            # most recent occurrence
            return context[j + n:j + n + k].astype(np.int32)
    return _EMPTY

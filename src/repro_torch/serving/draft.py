"""Draft proposers for speculative decoding.

A proposer guesses the next k tokens of a sequence cheaply; the runner
verifies the whole guess in ONE batched model dispatch and the
scheduler accepts the longest agreeing prefix (plus the one token the
model produced anyway) — the serving-side version of the paper's move
of amortizing one expensive synchronization over a batch of cheap
local work.

`NGramProposer` is prompt-lookup decoding: no draft model, no extra
device work. It matches the sequence's most recent n-gram against its
own earlier history (prompt + generated tokens) and proposes the
tokens that followed the match. Strong on repetitive continuations
(code, templated text, self-looping generations); proposes nothing
when no n-gram recurs, so the engine falls back to plain decode with
zero overhead. The seam for a draft-model proposer later is the same
`propose(history, k)` interface.
"""
from __future__ import annotations

from typing import List, Sequence


class NGramProposer:
    """Prompt-lookup draft proposer over one sequence's token history.

    max_ngram     longest n-gram to try to match (falls back to shorter
                  ones down to `min_ngram` before giving up)
    min_ngram     shortest n-gram considered a real match
    max_lookback  only the trailing `max_lookback` history tokens are
                  scanned — bounds the per-step host work to O(lookback)
                  instead of O(full history) on the serial engine loop
                  (repeats worth speculating on are local anyway)
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 max_lookback: int = 512):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError((min_ngram, max_ngram))
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.max_lookback = max_lookback

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        """Up to k draft tokens continuing `history`, or [] when no
        n-gram suffix of the history recurs earlier in it. The MOST
        RECENT earlier occurrence wins (locality: loops and templated
        spans repeat their latest iteration)."""
        if k <= 0:
            return []
        hist = history if isinstance(history, list) else list(history)
        if len(hist) > self.max_lookback:
            hist = hist[-self.max_lookback:]
        n_max = min(self.max_ngram, len(hist) - 1)
        for n in range(n_max, self.min_ngram - 1, -1):
            pattern = hist[-n:]
            # scan right-to-left over earlier occurrences; the match
            # must end before the final position so at least one
            # continuation token exists
            for start in range(len(hist) - n - 1, -1, -1):
                if hist[start:start + n] == pattern:
                    cont = hist[start + n:start + n + k]
                    if cont:
                        return cont
        return []


def make_proposer(kind: str, *, ngram: int = 3) -> NGramProposer:
    """Proposer factory (`--draft` CLI values resolve here)."""
    if kind == "ngram":
        return NGramProposer(max_ngram=ngram)
    raise ValueError(f"unknown draft proposer {kind!r} "
                     f"(available: 'ngram')")

"""Self-speculative drafting: per-request n-gram / prompt-lookup index.
A copy of ``repro/serving/speculative.py`` (numpy only), kept in the port
so that it imports nothing of ``repro``.

The unified tick's speculative decoding (DESIGN.md §11) needs a drafter
that proposes likely continuations of a request's token stream WITHOUT a
second model: repetitive analytical output (tables, code, boilerplate,
greedy repetition loops) re-uses n-grams the stream has already emitted,
so the best free predictor of the next ``k`` tokens is "what followed
this exact suffix last time it appeared" — vLLM/transformers-style
prompt lookup, applied over prompt *and* generated tokens.

:class:`NGramDrafter` is that index, maintained incrementally: one dict
update per (token, n) on append, one dict probe per n on draft.  Only
*accepted* tokens are ever indexed — the engine extends the drafter with
the accept-survivors of each verify, so a rejected draft can never
poison later proposals (the rollback invariant has no drafter-side
bookkeeping at all).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class NGramDrafter:
    """Incremental suffix n-gram index over one request's token stream.

    For every n-gram (n up to ``max_ngram``) the index keeps the
    continuation positions of its two most recent occurrences.  A draft
    probes the stream's tail n-gram longest-first: the continuation of
    the tail's *previous* occurrence (its own occurrence necessarily
    ends the stream, where the continuation is the unknown next token)
    is proposed verbatim, up to ``k`` tokens.

        >>> d = NGramDrafter()
        >>> d.reset([5, 6, 7, 5, 6])
        >>> d.draft(3)          # "5 6" last continued with 7, then 5 6
        [7, 5, 6]

    Cost: O(max_ngram) dict ops per appended token and per draft — the
    engine calls both once per decode tick per slot.
    """

    def __init__(self, max_ngram: int = 3):
        assert max_ngram >= 1
        self.max_ngram = max_ngram
        self.tokens: List[int] = []
        # gram -> continuation index of its most recent occurrence, and
        # of the one before that (the tail gram's own registration always
        # points past the end, so draft() falls back one occurrence deep)
        self._last: Dict[Tuple[int, ...], int] = {}
        self._prev: Dict[Tuple[int, ...], Optional[int]] = {}

    def __len__(self) -> int:
        return len(self.tokens)

    def reset(self, tokens) -> None:
        """Rebuild the index over ``tokens`` (prompt + generated so far)."""
        self.tokens = []
        self._last.clear()
        self._prev.clear()
        self.extend(tokens)

    def append(self, token: int) -> None:
        """Index one more (accepted) token."""
        self.tokens.append(int(token))
        i = len(self.tokens) - 1          # position of the new token
        for n in range(1, self.max_ngram + 1):
            if i - n + 1 < 0:
                break
            g = tuple(self.tokens[i - n + 1:i + 1])
            self._prev[g] = self._last.get(g)
            self._last[g] = i + 1         # continuation = next position
        return None

    def extend(self, tokens) -> None:
        """Index a run of accepted tokens (admission, accepted drafts)."""
        for t in np.asarray(tokens).reshape(-1):
            self.append(int(t))

    def draft(self, k: int) -> List[int]:
        """Propose up to ``k`` continuation tokens (possibly none).

        Probes the stream's tail n-gram from ``max_ngram`` down to 1 and
        copies the continuation of its most recent *earlier* occurrence.
        When the copy window runs past the stream end the proposal wraps
        around the match period (``L - c``): a match distance of ``q``
        asserts "the stream is repeating with period q", so the
        continuation keeps cycling — this is what turns the degenerate
        period-1 greedy attractor into full-``k`` drafts instead of
        single-token ones.  An empty proposal means the tail has never
        been seen before — the engine then falls back to plain
        one-token decode.
        """
        L = len(self.tokens)
        if k <= 0 or L == 0:
            return []
        for n in range(min(self.max_ngram, L), 0, -1):
            g = tuple(self.tokens[L - n:])
            c = self._last.get(g)
            if c == L:                    # the tail's own registration
                c = self._prev.get(g)
            if c is not None and c < L:
                q = L - c                 # match period
                return [self.tokens[c + (j % q)] for j in range(k)]
        return []

"""Hashing n-gram tokenizer (paper §2.4: "queries are short, and we only
consider n-grams up to n=3").

Host-side: strings -> 64-bit fingerprints, with a reverse dictionary so the
serving frontend (and the spelling job) can map fingerprints back to text.
The device only ever sees fingerprints.

This is a copy of the JAX package's ``data/tokenizer.py``: the torch package
never imports the JAX one.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..core.hashing import fingerprint


class NGramTokenizer:
    def __init__(self, max_n: int = 3):
        self.max_n = max_n
        self.fp_to_text: Dict[int, str] = {}

    def fp(self, text: str) -> int:
        f = fingerprint(text)
        self.fp_to_text.setdefault(f, text)
        return f

    def text(self, fp: int) -> str:
        return self.fp_to_text.get(int(fp), f"<fp:{int(fp):x}>")

    def query_fp(self, query: str) -> int:
        """Fingerprint a whole (normalized) query string."""
        return self.fp(" ".join(query.lower().split()))

    def ngrams(self, text: str) -> List[str]:
        toks = text.lower().split()
        out = []
        for n in range(1, self.max_n + 1):
            for i in range(len(toks) - n + 1):
                out.append(" ".join(toks[i : i + n]))
        return out

    def tweet_ngram_fps(self, tweet: str, max_grams: int) -> np.ndarray:
        """Fingerprints of a tweet's n-grams, padded/truncated to max_grams."""
        fps = [self.fp(g) for g in self.ngrams(tweet)][:max_grams]
        arr = np.zeros((max_grams,), np.uint64)
        arr[: len(fps)] = fps
        return arr

"""Token pipeline for LM example training: a synthetic corpus with Zipfian
unigram statistics + Markov bigram structure (so a small LM has signal to
learn), packed into fixed-length training sequences with deterministic
shuffling and epoch/shard bookkeeping (resumable from a step counter)."""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int = 512
    seq_len: int = 128
    batch_size: int = 8
    n_states: int = 32          # Markov blocks for learnable structure
    seed: int = 0


class SyntheticTokenStream:
    """Deterministic, seekable token batches: batch(i) is pure in (seed, i)."""

    def __init__(self, cfg: LMDataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V, S = cfg.vocab_size, cfg.n_states
        # state transition matrix + per-state Zipf emission over a vocab slice
        self.trans = rng.dirichlet(np.ones(S) * 0.3, size=S)
        ranks = np.arange(1, V + 1)
        zipf = ranks ** -1.1
        self.emit = np.stack([
            np.roll(zipf, rng.integers(V)) / zipf.sum() for _ in range(S)])
        self.emit /= self.emit.sum(axis=1, keepdims=True)

    def batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, T = cfg.batch_size, cfg.seq_len + 1
        out = np.zeros((B, T), np.int64)
        state = rng.integers(0, cfg.n_states, size=B)
        for t in range(T):
            for b in range(B):
                out[b, t] = rng.choice(cfg.vocab_size, p=self.emit[state[b]])
            # vectorized-ish state step
            u = rng.random(B)
            cdf = np.cumsum(self.trans[state], axis=1)
            state = (u[:, None] < cdf).argmax(axis=1)
        return out.astype(np.int32)

    def batches(self, start_step: int = 0) -> Iterator[Tuple[int, np.ndarray]]:
        step = start_step
        while True:
            yield step, self.batch(step)
            step += 1

"""Firehose workload generator — millions-of-users traffic shapes (§1, §2).

The paper's whole reason to exist is the breaking-news flash crowd: query
volume spikes 10-100x within minutes and the system must stay fresh *and*
stay up. ``data/stream.py`` models the *statistical* structure (Zipf,
sessions, hockey-puck events) at a fixed per-tick volume; this module
models the *load* structure on top of it, as the traffic that drives the
overload-control layer (``streaming/overload.py``):

  * **Zipf base traffic with topic drift** — per-topic popularity drifts
    smoothly over time (deterministic per-topic phase curves), so the head
    of the distribution churns the way §2.3 measures;
  * **breaking-news flash crowds** (:class:`SpikeSpec`) — a hockey-puck
    *volume multiplier* (10-100x the base event rate), with the added
    traffic focused on a small set of event terms (Figure 1's shape);
  * **spam bursts** (:class:`SpamSpec`) — periodic bursts of near-identical
    payload queries/tweets from a small pool of bot sessions (the traffic
    the paper's rate-limiting stance exists for);
  * **multilingual sessions** — disjoint per-language vocabularies; each
    user sticks to one language, so sessions never mix languages and the
    cooccurrence signal stays language-local.

Volume scaling is *physical*: a tick's arrays are sized to a power-of-
``bucket_factor`` bucket that fits the tick's event count (valid-masked
padding), so a 50x spike really costs ~50x device work — which is what
makes overload, admission control and shedding measurable instead of
cosmetic. The small bucket alphabet keeps the number of distinct
micro-batch shapes bounded.

``gen_tick(t)`` is a pure function of ``(seed, t)``: any tick can be
regenerated independently (replay comparisons, chaos schedules that revisit
ticks, a resumed run), and two generators with the same seed agree tick
for tick.

Port of the JAX package's ``streaming/workload.py`` (numpy only): the same
``(seed, t)`` gives the same arrays, bit for bit. It takes the port's
tokenizer, and the splitmix64 finalizer of ``data/stream.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..data.stream import QueryEvents, TweetBatch, _mix64
from ..data.tokenizer import NGramTokenizer

_WORDS = [
    "news", "video", "live", "score", "game", "music", "photo", "trend",
    "world", "tech", "movie", "series", "stream", "update", "launch", "team",
]


def bucket_size(n: int, min_bucket: int, max_bucket: int,
                factor: int = 4) -> int:
    """Smallest power-of-``factor`` multiple of ``min_bucket`` >= n,
    clamped to ``max_bucket``. The coarse (factor-4 by default) alphabet
    bounds how many distinct micro-batch shapes the ingest paths and the
    micro-batcher ever see, spike or no spike."""
    b = max(min_bucket, 1)
    while b < n and b < max_bucket:
        b *= factor
    return min(b, max_bucket)


@dataclasses.dataclass(frozen=True)
class SpikeSpec:
    """A breaking-news flash crowd: a volume spike focused on few terms."""
    t_start: int
    mult: float = 50.0            # added query volume at peak, x base rate
    ramp_ticks: float = 3.0       # rise time constant (§2.2 hockey puck)
    plateau_ticks: float = 10.0   # time near peak
    decay_ticks: float = 12.0     # die-off constant
    focus: float = 0.7            # share of spike traffic on event terms
    n_terms: int = 5              # distinct breaking terms
    term_lag: float = 2.0         # per-term onset lag (Figure 1)


@dataclasses.dataclass(frozen=True)
class SpamSpec:
    """Periodic near-duplicate payload bursts from a small bot pool."""
    period: int = 29              # a burst starts every ``period`` ticks
    burst_ticks: int = 3
    mult: float = 2.0             # added volume during a burst, x base rate
    n_payloads: int = 4           # distinct spam strings per burst
    n_bots: int = 8               # bot sessions emitting them


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    vocab_per_lang: int = 1024
    n_langs: int = 3              # multilingual: disjoint vocabularies
    zipf_s: float = 1.07
    n_topics: int = 32
    drift_scale: float = 0.6      # log-amplitude of topic-popularity drift
    drift_period: float = 96.0    # slowest drift period, in ticks
    n_users: int = 50_000
    session_ticks: int = 24       # session epoch length
    topic_stickiness: float = 0.7
    base_queries_per_tick: int = 256
    base_tweets_per_tick: int = 32
    tweet_words: int = 4
    tweet_grams: int = 8
    min_bucket: int = 256         # smallest query-array bucket
    max_queries_per_tick: int = 1 << 14   # hard array cap (bucket ceiling)
    min_tweet_bucket: int = 32
    max_tweets_per_tick: int = 1 << 11
    bucket_factor: int = 4
    tick_seconds: float = 10.0    # one tick of simulated wall time
    source_probs: Tuple[float, float, float] = (0.70, 0.22, 0.08)
    spikes: Tuple[SpikeSpec, ...] = ()
    spam: Optional[SpamSpec] = None


class FirehoseWorkload:
    """Deterministic generator: ``gen_tick(t)`` is pure in ``(seed, t)``."""

    def __init__(self, cfg: WorkloadConfig, tok: Optional[NGramTokenizer] = None,
                 seed: int = 0):
        self.cfg = cfg
        self.tok = tok or NGramTokenizer()
        self.seed = seed
        rr = np.random.default_rng(seed + 1)

        # --- per-language vocabularies (disjoint by a language prefix) ---
        self.vocab: List[str] = []
        self.lang_slice: List[slice] = []
        for lang in range(cfg.n_langs):
            start = len(self.vocab)
            seen = set()
            while len(self.vocab) - start < cfg.vocab_per_lang:
                w1 = _WORDS[rr.integers(len(_WORDS))]
                w2 = f"{_WORDS[rr.integers(len(_WORDS))]}{rr.integers(4000)}"
                q = f"l{lang} {w1} {w2}"
                if q not in seen:
                    seen.add(q)
                    self.vocab.append(q)
            self.lang_slice.append(slice(start, len(self.vocab)))
        self.fps = np.array([self.tok.query_fp(q) for q in self.vocab],
                            np.uint64)

        # Zipf base probabilities within each language + topic assignment
        ranks = np.arange(1, cfg.vocab_per_lang + 1, dtype=np.float64)
        self._zipf = ranks ** (-cfg.zipf_s)
        self._zipf /= self._zipf.sum()
        self.topic = rr.integers(0, cfg.n_topics,
                                 size=cfg.n_langs * cfg.vocab_per_lang)
        # topic drift: two incommensurate phase curves per topic
        self._ph = rr.random((2, cfg.n_topics))

        # --- spike event terms (language 0 — breaking news breaks in one) ---
        self.spike_terms: List[np.ndarray] = []
        for si, sp in enumerate(cfg.spikes):
            idx = []
            for k in range(sp.n_terms):
                term = f"breaking{si} term{k}"
                self.vocab.append(term)
                self.fps = np.append(self.fps, np.uint64(self.tok.query_fp(term)))
                idx.append(len(self.vocab) - 1)
            self.spike_terms.append(np.array(idx))

        # --- spam payload pool ---
        self.spam_idx = np.zeros((0,), np.int64)
        if cfg.spam is not None:
            idx = []
            for k in range(cfg.spam.n_payloads):
                term = f"win prize{k} now"
                self.vocab.append(term)
                self.fps = np.append(self.fps, np.uint64(self.tok.query_fp(term)))
                idx.append(len(self.vocab) - 1)
            self.spam_idx = np.array(idx)

    # ------------------------------------------------------------------
    # intensity model
    # ------------------------------------------------------------------
    def spike_mult(self, t: int) -> np.ndarray:
        """Per-spike added-volume multiplier at tick t (hockey puck)."""
        out = []
        for sp in self.cfg.spikes:
            dt = t - sp.t_start
            if dt < 0:
                out.append(0.0)
                continue
            rise = 1.0 - np.exp(-((dt / sp.ramp_ticks) ** 2))
            fall = np.exp(-max(0.0, dt - sp.plateau_ticks) / sp.decay_ticks)
            out.append(sp.mult * rise * fall)
        return np.array(out)

    def spam_mult(self, t: int) -> float:
        sp = self.cfg.spam
        if sp is None or (t % sp.period) >= sp.burst_ticks:
            return 0.0
        return sp.mult

    def volume_mult(self, t: int) -> float:
        """Total query-volume multiplier at tick t (1.0 = calm baseline)."""
        return float(1.0 + self.spike_mult(t).sum() + self.spam_mult(t))

    def arrival_s(self, t: int) -> float:
        """Simulated arrival time of tick t (for SLO pacing/lag)."""
        return t * self.cfg.tick_seconds

    def _topic_weights(self, t: int) -> np.ndarray:
        """Drifted per-topic popularity multipliers (smooth, deterministic)."""
        cfg = self.cfg
        ph = self._ph
        a = np.sin(2 * np.pi * (t / cfg.drift_period + ph[0]))
        b = np.sin(2 * np.pi * (t / (cfg.drift_period / 2.7) + ph[1]))
        return np.exp(cfg.drift_scale * (a + 0.5 * b))

    def _lang_probs(self, lang: int, t: int) -> np.ndarray:
        w = self._zipf * self._topic_weights(t)[
            self.topic[self.lang_slice[lang]]]
        return w / w.sum()

    def _spike_term_probs(self, si: int, t: int) -> np.ndarray:
        sp = self.cfg.spikes[si]
        dt = t - sp.t_start
        w = np.array([
            0.0 if dt < k * sp.term_lag else
            (2.0 if k == 0 else 1.0)
            * (1 - np.exp(-((dt - k * sp.term_lag + 1) / sp.ramp_ticks)))
            for k in range(sp.n_terms)])
        s = w.sum()
        return w / s if s > 0 else np.ones(sp.n_terms) / sp.n_terms

    # ------------------------------------------------------------------
    # tick generation
    # ------------------------------------------------------------------
    def gen_tick(self, t: int) -> Tuple[QueryEvents, TweetBatch]:
        cfg = self.cfg
        rng = np.random.default_rng((self.seed, 0xF1AE, t))
        spikes = self.spike_mult(t)
        spam_m = self.spam_mult(t)

        n_q = int(round(cfg.base_queries_per_tick
                        * (1.0 + spikes.sum() + spam_m)))
        B = bucket_size(n_q, cfg.min_bucket, cfg.max_queries_per_tick,
                        cfg.bucket_factor)
        n_q = min(n_q, B)

        # --- base traffic: multilingual topical sessions ---
        users = rng.integers(0, cfg.n_users, size=n_q)
        epoch = t // cfg.session_ticks
        with np.errstate(over="ignore"):
            sess = _mix64(users.astype(np.uint64)
                          * np.uint64(0x9E3779B97F4A7C15)
                          ^ np.uint64((epoch * 0xC2B2AE3D27D4EB4F)
                                      % (1 << 64)))
        lang = users % cfg.n_langs
        sess_topic = (users + epoch * 7919) % cfg.n_topics
        q_idx = np.zeros(n_q, np.int64)
        sticky = rng.random(n_q) < cfg.topic_stickiness
        for lg in range(cfg.n_langs):
            lm = lang == lg
            if not lm.any():
                continue
            p = self._lang_probs(lg, t)
            base = self.lang_slice[lg].start
            loose = lm & ~sticky
            if loose.any():
                q_idx[loose] = base + rng.choice(cfg.vocab_per_lang,
                                                 size=int(loose.sum()), p=p)
            for tpc in np.unique(sess_topic[lm & sticky]):
                m = lm & sticky & (sess_topic == tpc)
                pt = p * (self.topic[self.lang_slice[lg]] == tpc)
                s = pt.sum()
                pt = pt / s if s > 0 else p
                q_idx[m] = base + rng.choice(cfg.vocab_per_lang,
                                             size=int(m.sum()), p=pt)

        # --- flash crowd: overwrite the spike's share of the stream ---
        total_m = 1.0 + spikes.sum() + spam_m
        u = rng.random(n_q)
        cursor = 0.0
        for si, sm in enumerate(spikes):
            share = (sm / total_m) * self.cfg.spikes[si].focus
            pick = (u >= cursor) & (u < cursor + share)
            cursor += share
            if pick.any():
                tp = self._spike_term_probs(si, t)
                q_idx[pick] = self.spike_terms[si][
                    rng.choice(len(tp), size=int(pick.sum()), p=tp)]
        # --- spam burst: identical payloads from a small bot pool ---
        if spam_m > 0.0 and len(self.spam_idx):
            share = spam_m / total_m
            pick = (u >= cursor) & (u < cursor + share)
            cursor += share
            if pick.any():
                n = int(pick.sum())
                q_idx[pick] = rng.choice(self.spam_idx, size=n)
                bots = rng.integers(0, cfg.spam.n_bots, size=n)
                sess[pick] = _mix64(bots.astype(np.uint64)
                                    + np.uint64(0xBAD5EED))

        src = rng.choice(3, size=n_q, p=cfg.source_probs).astype(np.int32)
        ev = QueryEvents(
            sess_fp=_pad(sess, B), q_fp=_pad(self.fps[q_idx], B),
            src=_pad(src, B), valid=_valid(n_q, B))

        # --- tweets: over-index on breaking news, spam payload floods ---
        n_t = int(round(cfg.base_tweets_per_tick
                        * (1.0 + 2.0 * spikes.sum() + spam_m)))
        T = bucket_size(n_t, cfg.min_tweet_bucket, cfg.max_tweets_per_tick,
                        cfg.bucket_factor)
        n_t = min(n_t, T)
        W = cfg.tweet_words
        tw_idx = np.zeros((n_t, W), np.int64)
        tu = rng.random(n_t)
        cursor = 0.0
        assigned = np.zeros(n_t, bool)
        for si, sm in enumerate(spikes):
            share = min(2.0 * sm / max(total_m, 1.0), 0.9)
            pick = (~assigned) & (tu >= cursor) & (tu < cursor + share)
            cursor += share
            if pick.any():
                tp = self._spike_term_probs(si, t)
                tw_idx[pick] = self.spike_terms[si][
                    rng.choice(len(tp), size=(int(pick.sum()), W), p=tp)]
                assigned |= pick
        if spam_m > 0.0 and len(self.spam_idx):
            share = min(spam_m / total_m, 0.9 - cursor)
            pick = (~assigned) & (tu >= cursor) & (tu < cursor + share)
            if pick.any():   # a flood of the SAME payload
                tw_idx[pick] = rng.choice(self.spam_idx)
                assigned |= pick
        rest = ~assigned
        if rest.any():
            lgs = rng.integers(0, cfg.n_langs, size=int(rest.sum()))
            picks = np.empty((int(rest.sum()), W), np.int64)
            for i, lg in enumerate(lgs):
                picks[i] = self.lang_slice[lg].start + rng.choice(
                    cfg.vocab_per_lang, size=W, p=self._lang_probs(lg, t))
            tw_idx[rest] = picks
        grams = np.zeros((T, cfg.tweet_grams), np.uint64)
        g = min(W, cfg.tweet_grams)
        grams[:n_t, :g] = self.fps[tw_idx[:, :g]]
        tw = TweetBatch(grams=grams, valid=_valid(n_t, T))
        return ev, tw


def _pad(a: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    out[: a.shape[0]] = a
    return out


def _valid(n: int, size: int) -> np.ndarray:
    v = np.zeros(size, bool)
    v[:n] = True
    return v

"""Synthetic firehose + query hose (the engine's two inputs, paper §4.2).

Models the statistical structure the paper describes:

  * a Zipf-distributed base query vocabulary (head/tail split drives the
    churn statistics of §2.3 and the coverage/memory tradeoff of §4.4),
  * topical user sessions (successive queries within a session are
    correlated -> the session co-occurrence signal of §2.4),
  * breaking-news events with "hockey puck" intensity curves (§2.2): a ramp,
    an accelerating rise to a peak share of the query stream, then decay;
    related event terms spike with a short lag after the head term
    (Figure 1's "steve jobs" -> "apple", "stay foolish" shape),
  * misspellings: common queries are corrupted at a configurable rate
    (feeding the spelling-correction path),
  * tweets as bags of n-grams biased to the same topics/events (the tweet
    context of §2.4).

Everything is vectorized numpy keyed by a deterministic seed; fingerprints
for sessions are numeric (mix64) while query fingerprints go through the
tokenizer so the serving layer can recover strings.

This is a numpy copy of the JAX package's ``data/stream.py``: the same seed gives
the same per-tick arrays, and the torch package never imports the JAX one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from .tokenizer import NGramTokenizer

_WORDS = [
    "news", "video", "live", "score", "game", "music", "photo", "trend",
    "world", "tech", "movie", "series", "stream", "update", "launch", "team",
    "play", "final", "award", "storm", "market", "stock", "crypto", "earth",
    "space", "rocket", "phone", "app", "meme", "viral", "dance", "song",
]


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (vectorized), output != 0."""
    x = np.asarray(x, np.uint64).copy()
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return np.where(x == 0, np.uint64(1), x)


@dataclasses.dataclass(frozen=True)
class EventSpec:
    name: str
    terms: Tuple[str, ...]         # terms[0] is the head query
    t_start: int                   # tick the news breaks
    ramp_ticks: float = 6.0        # rise time constant
    plateau_ticks: float = 24.0    # time near peak
    decay_ticks: float = 72.0      # die-off constant
    peak_share: float = 0.10       # share of the query stream at peak
    term_lag: float = 3.0          # onset lag per related term (Fig. 1)


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    vocab_size: int = 4096
    zipf_s: float = 1.07
    n_topics: int = 64
    n_users: int = 20000
    session_ticks: int = 24            # session epoch length
    topic_stickiness: float = 0.75     # P(query from session topic)
    typo_rate: float = 0.01
    n_misspell_targets: int = 64
    queries_per_tick: int = 2048
    tweets_per_tick: int = 512
    tweet_words: int = 6
    tweet_grams: int = 16
    tick_seconds: float = 10.0          # one tick of simulated wall time
    source_probs: Tuple[float, float, float] = (0.70, 0.22, 0.08)
    events: Tuple[EventSpec, ...] = ()


class QueryEvents(NamedTuple):
    sess_fp: np.ndarray   # u64[B]
    q_fp: np.ndarray      # u64[B]
    src: np.ndarray       # i32[B]: 0 typed, 1 hashtag click, 2 related click
    valid: np.ndarray     # bool[B]


class TweetBatch(NamedTuple):
    grams: np.ndarray     # u64[T, G] n-gram fingerprints (0 padded)
    valid: np.ndarray     # bool[T]


class SyntheticStream:
    def __init__(self, cfg: StreamConfig, tok: Optional[NGramTokenizer] = None,
                 seed: int = 0):
        self.cfg = cfg
        self.tok = tok or NGramTokenizer()
        self.rng = np.random.default_rng(seed)

        # --- vocabulary: two-word queries over a word list (n-gram friendly)
        rr = np.random.default_rng(seed + 1)
        vocab: List[str] = []
        seen = set()
        while len(vocab) < cfg.vocab_size:
            w1 = _WORDS[rr.integers(len(_WORDS))]
            w2 = f"{_WORDS[rr.integers(len(_WORDS))]}{rr.integers(1000)}"
            q = f"{w1} {w2}" if rr.random() < 0.8 else w2
            if q not in seen:
                seen.add(q)
                vocab.append(q)
        self.vocab = vocab
        self.fps = np.array([self.tok.query_fp(q) for q in vocab], np.uint64)

        # Zipf base probabilities
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_s)
        self.base_p = p / p.sum()
        self.topic = rr.integers(0, cfg.n_topics, size=cfg.vocab_size)
        # per-topic sampling distributions
        self._topic_p = []
        for t in range(cfg.n_topics):
            m = (self.topic == t).astype(np.float64) * self.base_p
            s = m.sum()
            self._topic_p.append(m / s if s > 0 else self.base_p)
        # ``rng.choice(n, size, p=p)`` looks ``rng.random(size)`` up in
        # p's cumulative sum over its last entry; the tweets' topic draws
        # do the same with these, one ``random`` call for every tweet
        self._topic_cdf = []
        for p_t in self._topic_p:
            cdf = p_t.cumsum()
            cdf /= cdf[-1]
            self._topic_cdf.append(cdf)

        # --- events: append their terms to the vocab space
        self.event_term_idx: List[np.ndarray] = []
        for ev in cfg.events:
            idx = []
            for term in ev.terms:
                fp = self.tok.query_fp(term)
                if fp in self.fps:
                    idx.append(int(np.nonzero(self.fps == fp)[0][0]))
                else:
                    self.vocab.append(term)
                    self.fps = np.append(self.fps, np.uint64(fp))
                    idx.append(len(self.vocab) - 1)
            self.event_term_idx.append(np.array(idx))

        # --- misspelling pool for the head of the distribution
        self.misspell_of: Dict[int, int] = {}   # variant idx -> true idx
        self._misspell_variants: List[int] = []
        for i in range(min(cfg.n_misspell_targets, len(vocab))):
            q = self.vocab[i]
            if len(q) < 5:
                continue
            v = self._corrupt(q, rr)
            if v == q:
                continue
            fp = self.tok.query_fp(v)
            self.vocab.append(v)
            self.fps = np.append(self.fps, np.uint64(fp))
            vi = len(self.vocab) - 1
            self.misspell_of[vi] = i
            self._misspell_variants.append(vi)

    @staticmethod
    def _corrupt(q: str, rr) -> str:
        # internal-character typos (the paper's observation)
        pos = int(rr.integers(1, max(2, len(q) - 1)))
        kind = rr.integers(3)
        if kind == 0 and pos + 1 < len(q):   # transpose
            return q[:pos] + q[pos + 1] + q[pos] + q[pos + 2:]
        if kind == 1:                         # delete
            return q[:pos] + q[pos + 1:]
        return q[:pos] + "x" + q[pos + 1:]    # replace

    # ------------------------------------------------------------------
    def event_share(self, t: int) -> np.ndarray:
        """Per-event share of the query stream at tick t (hockey puck)."""
        shares = []
        for ev in self.cfg.events:
            dt = t - ev.t_start
            if dt < 0:
                shares.append(0.0)
                continue
            rise = 1.0 - np.exp(-((dt / ev.ramp_ticks) ** 2))
            fall = np.exp(-max(0.0, dt - ev.plateau_ticks) / ev.decay_ticks)
            shares.append(ev.peak_share * rise * fall)
        return np.array(shares)

    def _event_term_probs(self, ev_i: int, t: int) -> np.ndarray:
        ev = self.cfg.events[ev_i]
        dt = t - ev.t_start
        w = []
        for k in range(len(ev.terms)):
            onset = k * ev.term_lag
            w.append(0.0 if dt < onset else
                     (2.0 if k == 0 else 1.0) * (1 - np.exp(-((dt - onset + 1) / ev.ramp_ticks))))
        w = np.array(w)
        s = w.sum()
        return w / s if s > 0 else np.ones(len(w)) / len(w)

    def gen_tick(self, t: int) -> Tuple[QueryEvents, TweetBatch]:
        cfg, rng = self.cfg, self.rng
        B = cfg.queries_per_tick
        shares = self.event_share(t)
        ev_total = float(shares.sum())

        # choose generator per query: event e / base
        u = rng.random(B)
        q_idx = np.zeros(B, np.int64)
        cursor = 0.0
        assigned = np.zeros(B, bool)
        for e, sh in enumerate(shares):
            pick = (~assigned) & (u >= cursor) & (u < cursor + sh)
            cursor += sh
            if pick.any():
                tp = self._event_term_probs(e, t)
                q_idx[pick] = self.event_term_idx[e][
                    rng.choice(len(tp), size=int(pick.sum()), p=tp)]
                assigned |= pick

        # base queries: topical sessions
        users = rng.integers(0, cfg.n_users, size=B)
        epoch = t // cfg.session_ticks
        with np.errstate(over="ignore"):
            sess_fp = _mix64(
                users.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
                ^ np.uint64((epoch * 0xC2B2AE3D27D4EB4F) % (1 << 64)))
        sess_topic = (users + epoch * 7919) % cfg.n_topics
        base = ~assigned
        n_base = int(base.sum())
        if n_base:
            sticky = rng.random(n_base) < cfg.topic_stickiness
            picks = np.empty(n_base, np.int64)
            bt = sess_topic[base]
            # vectorized-ish: group by topic
            for tpc in np.unique(bt[sticky]):
                m = sticky & (bt == tpc)
                picks[m] = rng.choice(self.cfg.vocab_size, size=int(m.sum()),
                                      p=self._topic_p[tpc])
            if (~sticky).any():
                picks[~sticky] = rng.choice(self.cfg.vocab_size,
                                            size=int((~sticky).sum()), p=self.base_p)
            q_idx[base] = picks

        # typos on head queries
        if self._misspell_variants:
            ty = rng.random(B) < cfg.typo_rate
            if ty.any():
                q_idx[ty] = rng.choice(self._misspell_variants, size=int(ty.sum()))

        # during events, user sessions revisit the event terms (breaking-news
        # sessions mix event queries with their topical queries)
        src = rng.choice(3, size=B, p=cfg.source_probs).astype(np.int32)
        q_fp = self.fps[q_idx]
        events = QueryEvents(sess_fp=sess_fp, q_fp=q_fp, src=src,
                             valid=np.ones(B, bool))

        # ------- tweets -------
        T, W = cfg.tweets_per_tick, cfg.tweet_words
        tw_idx = np.zeros((T, W), np.int64)
        tu = rng.random(T)
        cursor = 0.0
        t_assigned = np.zeros(T, bool)
        for e, sh in enumerate(shares):
            tw_share = min(3.0 * sh, 0.9)  # tweets over-index on breaking news
            pick = (~t_assigned) & (tu >= cursor) & (tu < cursor + tw_share)
            cursor += tw_share
            if pick.any():
                tp = self._event_term_probs(e, t)
                tw_idx[pick] = self.event_term_idx[e][
                    rng.choice(len(tp), size=(int(pick.sum()), W), p=tp)]
                t_assigned |= pick
        rest = ~t_assigned
        if rest.any():
            topics = rng.integers(0, cfg.n_topics, size=int(rest.sum()))
            # the numbers one rng.choice(vocab_size, size=W, p=topic_p) a
            # tweet would draw, in the same order
            u = rng.random((len(topics), W))
            picks = np.empty((len(topics), W), np.int64)
            for tpc in np.unique(topics):
                m = topics == tpc
                picks[m] = self._topic_cdf[tpc].searchsorted(u[m],
                                                             side="right")
            tw_idx[rest] = picks
        grams = np.zeros((T, cfg.tweet_grams), np.uint64)
        g = min(W, cfg.tweet_grams)
        grams[:, :g] = self.fps[tw_idx[:, :g]]
        tweets = TweetBatch(grams=grams, valid=np.ones(T, bool))
        return events, tweets


def steve_jobs_scenario(seed: int = 0, base_cfg: Optional[StreamConfig] = None
                        ) -> Tuple[StreamConfig, EventSpec]:
    """The paper's Figure-1 scenario as a canned event."""
    ev = EventSpec(
        name="steve-jobs",
        terms=("steve jobs", "apple", "stay foolish", "stay hungry", "ipad"),
        t_start=60, ramp_ticks=5.0, plateau_ticks=30.0, decay_ticks=90.0,
        peak_share=0.15, term_lag=4.0,
    )
    cfg = dataclasses.replace(base_cfg or StreamConfig(), events=(ev,))
    return cfg, ev

"""Pure-Python dict-based reference engine, and the parity comparator.

Port of the JAX package's ``core/reference.py``: the correctness oracle,
hash maps mutated event at a time, as the paper's JVM engine does. It
defines the semantics the device engine reproduces at micro-batch
granularity: the same store lanes (weight, count, last tick), the same
session sliding-window pair emission (batch order per session), the same
decay/prune and ranking math, in float64. Deliberately simple and slow.

:func:`parity_report` holds a :class:`~.engine.SearchAssistanceEngine`'s
state and suggestions against a :class:`ReferenceEngine` fed the same
stream, under the parity contract (``tests/test_engine.py``): keys and
session windows exact, weights within ``weight_rtol``, counts within
``count_rtol``, the top-3 suggestion scores of every source within
``score_rtol``/``score_atol``, and the top-3 identities of at least
``min_agree`` of the sources equal. A key that one side pruned within
``weight_rtol`` of the prune threshold is a flip: counted, not a fault.
Sources the engine's ranking caps by design (``RankConfig.bucket_rows``,
``source_cap``, ``seg_arena_frac``) are counted, and their disagreements
are counted apart.

The engine scores in float32, and its LLR lane is a cancelling sum of
nine ``x log x`` terms of up to ``n log n`` with ``n`` the total query
count, so at a deployment's totals the rounding of that sum alone moves a
score by more than the contract's 5e-3 (the JAX engine's too: the same
formula). ``ReferenceEngine(cfg, llr_f32=True)`` takes that drift out of
the reference: it computes the LLR term in numpy float32, in the engine's
order of operations (:func:`llr_float32`), and everything else in float64
as before. The comparator then holds the scores to the plain contract.
Its logs are correctly rounded, as the CPU engine's are; a CUDA ``logf``
is within an ulp of that, and an ulp of ``n log n`` is itself past the
contract at a deployment's totals, so against an engine on the card pass
``log_f32``, a float32 log on the engine's device: the one libm function
the oracle then borrows.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import stores
from .engine import EngineConfig
from .hashing import join_fp, to_np_u32
from .ranking import RankConfig


def _sigmoid(x: float) -> float:
    if x >= 0:
        return 1.0 / (1.0 + math.exp(-x))
    e = math.exp(x)
    return e / (1.0 + e)


def _xlogx(x: float) -> float:
    return x * math.log(x) if x > 0 else 0.0


_F32 = np.float32


Log32 = Callable[[np.ndarray], np.ndarray]


def log_rounded(x: np.ndarray) -> np.ndarray:
    """float32 log of a float32 array, correctly rounded (computed in
    float64)."""
    return np.log(x.astype(np.float64)).astype(np.float32)


def llr_float32(c_ab, c_a, c_b, total_c: float,
                log: Log32 = log_rounded) -> np.ndarray:
    """Dunning's LLR of each pair as the engine computes it
    (``kernels/assoc_score.assoc_lanes``, ``csrc/assoc_score.cuh``): float32
    throughout, every clamp, sum and product in its order, ``log`` for the
    logs; float64 out."""
    k11 = np.asarray(c_ab, np.float32)
    c_a = np.asarray(c_a, np.float32)
    c_b = np.asarray(c_b, np.float32)
    z = _F32(0)
    k12 = np.maximum(c_a - k11, z)
    k21 = np.maximum(c_b - k11, z)
    k22 = np.maximum(_F32(total_c) - c_a - c_b + k11, z)
    n = np.maximum(k11 + k12 + k21 + k22, _F32(1e-9))
    r1, r2 = k11 + k12, k21 + k22
    q1, q2 = k11 + k21, k12 + k22
    def x(v):                      # x * log(x), 0 where x <= 0
        return np.where(v > z, v * log(np.maximum(v, _F32(1e-30))), z)

    s = (x(k11) + x(k12) + x(k21) + x(k22) - x(r1) - x(r2) - x(q1) - x(q2)
         + x(n))
    return np.maximum(_F32(2) * s, z).astype(np.float64)


class ReferenceEngine:
    def __init__(self, cfg: EngineConfig, *, llr_f32: bool = False,
                 log_f32: Optional[Log32] = None):
        """``llr_f32``: score the LLR term as the engine does, in float32
        (:func:`llr_float32`), its logs from ``log_f32`` (default correctly
        rounded); the default is the JAX reference's float64."""
        self.cfg = cfg
        self.llr_f32 = llr_f32
        self.log_f32 = log_f32 or log_rounded
        self.q: Dict[int, List[float]] = {}          # fp -> [w, c, last_tick]
        self.cooc: Dict[Tuple[int, int], List[float]] = {}
        self.sessions: Dict[int, deque] = {}         # sess_fp -> deque[(qfp, src)]
        self.sess_tick: Dict[int, int] = {}
        self.tick = 0
        self.suggestions: Dict[int, List[Tuple[int, float]]] = {}
        # source -> gate-passing candidates at the last rank cycle
        self.n_candidates: Dict[int, int] = {}

    # ------------------------------------------------------------------
    def _source_w(self, src: int) -> float:
        sw = self.cfg.source_weights
        return sw[min(max(src, 0), len(sw) - 1)]

    def _bump_q(self, fp: int, w: float) -> None:
        e = self.q.setdefault(int(fp), [0.0, 0.0, 0])
        e[0] += w
        e[1] += 1.0
        e[2] = self.tick

    def _bump_cooc(self, a: int, b: int, w: float) -> None:
        e = self.cooc.setdefault((int(a), int(b)), [0.0, 0.0, 0])
        e[0] += w
        e[1] += 1.0
        e[2] = self.tick

    def ingest_queries(self, events) -> None:
        W = self.cfg.session_window
        for sess, q, src, valid in zip(events.sess_fp.tolist(),
                                       events.q_fp.tolist(),
                                       events.src.tolist(),
                                       events.valid.tolist()):
            if not valid or q == 0 or sess == 0:
                continue
            self._bump_q(q, self._source_w(src))
            d = self.sessions.setdefault(sess, deque(maxlen=W))
            for (prev, psrc) in d:
                if prev == q:
                    continue
                w_pair = math.sqrt(self._source_w(psrc) * self._source_w(src))
                self._bump_cooc(prev, q, w_pair)
            d.append((q, src))
            self.sess_tick[sess] = self.tick

    def ingest_tweets(self, tweets) -> None:
        cfg = self.cfg

        # query-likeness snapshot BEFORE this batch's updates
        def querylike(fp: int) -> bool:
            e = self.q.get(fp)
            return e is not None and e[1] >= cfg.min_querylike_count
        batches = []
        for grams, valid in zip(tweets.grams.tolist(), tweets.valid.tolist()):
            if not valid:
                continue
            batches.append([g for g in grams if g != 0 and querylike(g)])
        for ql in batches:
            for g in ql:
                self._bump_q(g, cfg.tweet_weight)
            for a in ql:
                for b in ql:
                    if a != b:
                        self._bump_cooc(a, b, cfg.tweet_weight)

    def decay_cycle(self, dticks: int) -> None:
        cfg = self.cfg.decay
        f = cfg.factor_py(dticks)
        for d in (self.q, self.cooc):
            dead = []
            for k, e in d.items():
                e[0] *= f
                if e[0] < cfg.prune_threshold:
                    dead.append(k)
            for k in dead:
                del d[k]
        stale = [s for s, t in self.sess_tick.items()
                 if self.tick - t > self.cfg.session_ttl]
        for s in stale:
            self.sessions.pop(s, None)
            self.sess_tick.pop(s, None)

    # ------------------------------------------------------------------
    def rank_cycle(self) -> Dict[int, List[Tuple[int, float]]]:
        cfg: RankConfig = self.cfg.rank
        total_w = sum(e[0] for e in self.q.values())
        total_c = sum(e[1] for e in self.q.values())
        cand = []       # the gate-passing pairs and their lanes
        for (a, b), (w_ab, c_ab, _) in self.cooc.items():
            ea, eb = self.q.get(a), self.q.get(b)
            if ea is None or eb is None:
                continue
            w_a, c_a = ea[0], ea[1]
            w_b, c_b = eb[0], eb[1]
            if (w_ab < cfg.min_pair_weight or c_ab < cfg.min_pair_count
                    or w_a < cfg.min_src_weight):
                continue
            condprob = w_ab / w_a if w_a > 0 else 0.0
            pmi = (math.log(w_ab * max(total_w, 1e-9) / max(w_a * w_b, 1e-9))
                   if w_ab > 0 and w_a > 0 and w_b > 0 else 0.0)
            k11 = c_ab
            k12 = max(c_a - c_ab, 0.0)
            k21 = max(c_b - c_ab, 0.0)
            k22 = max(total_c - c_a - c_b + c_ab, 0.0)
            n = max(k11 + k12 + k21 + k22, 1e-9)
            r1, r2 = k11 + k12, k21 + k22
            c1, c2 = k11 + k21, k12 + k22
            llr = 2.0 * (_xlogx(k11) + _xlogx(k12) + _xlogx(k21) + _xlogx(k22)
                         - _xlogx(r1) - _xlogx(r2) - _xlogx(c1) - _xlogx(c2)
                         + _xlogx(n))
            llr = max(llr, 0.0)
            chi2 = n * (k11 * k22 - k12 * k21) ** 2 / max(r1 * r2 * c1 * c2, 1e-9)
            cand.append((a, b, condprob, pmi, llr, chi2, c_ab, c_a, c_b))
        if self.llr_f32 and cand:
            llrs = llr_float32([t[6] for t in cand], [t[7] for t in cand],
                           [t[8] for t in cand], total_c,
                           self.log_f32).tolist()
        per_src: Dict[int, List[Tuple[float, int]]] = {}
        for i, (a, b, condprob, pmi, llr, chi2, *_) in enumerate(cand):
            if self.llr_f32:
                llr = llrs[i]
            score = (cfg.coef_condprob * condprob
                     + cfg.coef_pmi * _sigmoid(pmi)
                     + cfg.coef_llr * math.log1p(llr)
                     + cfg.coef_chi2 * math.log1p(chi2))
            per_src.setdefault(a, []).append((score, b))
        self.n_candidates = {a: len(lst) for a, lst in per_src.items()}
        out: Dict[int, List[Tuple[int, float]]] = {}
        for a, lst in per_src.items():
            lst.sort(key=lambda t: (-t[0], t[1]))
            out[a] = [(b, s) for (s, b) in lst[: cfg.top_k]]
        self.suggestions = out
        return out

    # ------------------------------------------------------------------
    def step(self, query_events=None, tweets=None) -> None:
        if query_events is not None:
            self.ingest_queries(query_events)
        if tweets is not None:
            self.ingest_tweets(tweets)
        if (self.cfg.decay_every > 0 and self.tick > 0
                and self.tick % self.cfg.decay_every == 0):
            self.decay_cycle(self.cfg.decay_every)
        if (self.cfg.rank_every > 0 and self.tick > 0
                and self.tick % self.cfg.rank_every == 0):
            self.rank_cycle()
        self.tick += 1


# ---------------------------------------------------------------------------
# The parity comparator
# ---------------------------------------------------------------------------

def _engine_stores(engine) -> Tuple[Dict, Dict]:
    """The engine's live qstore ``{fp: (w, c)}`` and cooc ``{(src, dst):
    (w, c)}`` on the host, under either cooc layout."""
    st = engine.state
    exp = stores.export_live(st.qstore)
    q = dict(zip(join_fp(exp["key_hi"], exp["key_lo"]).tolist(),
                 zip(exp["weight"].tolist(), exp["count"].tolist())))
    c = st.cooc
    if engine.cfg.region_cooc:
        _, _, referenced = stores.region_chain_state(c, st.qstore)
        W = c.width
        live = (c.live_mask.reshape(-1, W) & referenced[:, None]).reshape(-1)
        idx = live.nonzero().squeeze(1)
        owner = c.region_owner[idx // W].long()
        src = join_fp(to_np_u32(c.chain_hi[owner]), to_np_u32(c.chain_lo[owner]))
        dst = join_fp(to_np_u32(c.key_hi[idx]), to_np_u32(c.key_lo[idx]))
        w = c.lanes["weight"][idx].cpu().numpy()
        n = c.lanes["count"][idx].cpu().numpy()
    else:
        exp = stores.export_live(c)
        src = join_fp(exp["src_hi"], exp["src_lo"])
        dst = join_fp(exp["dst_hi"], exp["dst_lo"])
        w, n = exp["weight"], exp["count"]
    cooc = dict(zip(zip(src.tolist(), dst.tolist()),
                    zip(w.tolist(), n.tolist())))
    return q, cooc


def _engine_sessions(engine) -> Dict[int, Tuple[List[Tuple[int, int]], int]]:
    """The engine's live sessions ``{sess_fp: (window, last_tick)}``; the
    window oldest first, as the reference's deque holds it."""
    s = engine.state.sessions
    live = ((s.key_hi != 0) | (s.key_lo != 0)).nonzero().squeeze(1)
    fps = join_fp(to_np_u32(s.key_hi[live]), to_np_u32(s.key_lo[live]))
    ring = join_fp(to_np_u32(s.ring_hi[live]), to_np_u32(s.ring_lo[live]))
    src = s.ring_src[live].cpu().numpy()
    cur = s.cursor[live].cpu().numpy()
    fill = s.filled[live].cpu().numpy()
    tick = s.last_tick[live].cpu().numpy()
    W = s.window
    out = {}
    for i, fp in enumerate(fps.tolist()):
        pos = [(int(cur[i]) - int(fill[i]) + j) % W for j in range(fill[i])]
        out[fp] = ([(int(ring[i, p]), int(src[i, p])) for p in pos],
                   int(tick[i]))
    return out


def _store_parity(eng: Dict, ref: Dict, threshold: float, weight_rtol: float,
                  count_rtol: float) -> Dict:
    """Key sets, threshold flips and lane errors of one store."""
    only_e = eng.keys() - ref.keys()
    only_r = ref.keys() - eng.keys()
    near = threshold * (1.0 + weight_rtol)
    flips = (sum(eng[k][0] < near for k in only_e)
             + sum(ref[k][0] < near for k in only_r))
    common = eng.keys() & ref.keys()
    w_out = c_out = 0
    max_w = max_c = 0.0
    for k in common:
        (w, c), (rw, rc) = eng[k], ref[k][:2]
        ew, ec = abs(w - rw), abs(c - rc)
        max_w = max(max_w, ew / abs(rw) if rw else ew)
        max_c = max(max_c, ec / abs(rc) if rc else ec)
        w_out += ew > weight_rtol * abs(rw)
        c_out += ec > count_rtol * abs(rc)
    return {"engine": len(eng), "reference": len(ref),
            "only_engine": len(only_e), "only_reference": len(only_r),
            "flips": flips, "weight_max_rel": max_w, "weight_out": w_out,
            "count_max_rel": max_c, "count_out": c_out}


def _caps(cfg: EngineConfig, ref: ReferenceEngine) -> Dict:
    """What the engine's ranking cuts by design, from the reference's
    gate-passing candidates: sources with more than ``bucket_rows`` of
    them (the bucket arena keeps its coarse-score best), sources past
    ``source_cap``, candidates past the selection arena."""
    rk = cfg.rank
    n_cand = ref.n_candidates
    L = max(rk.bucket_rows, rk.top_k)
    C, Q = cfg.cooc_capacity, cfg.query_capacity
    M = C if rk.seg_arena_frac >= 1.0 else min(
        C, max(rk.top_k, int(C * rk.seg_arena_frac)))
    return {"bucket_rows": sorted(a for a, n in n_cand.items() if n > L),
            "source_cap": max(len(n_cand) - min(Q, M, rk.source_cap(Q)), 0),
            "arena": max(sum(n_cand.values()) - M, 0)}


def parity_report(engine, ref: ReferenceEngine, *, weight_rtol: float = 2e-3,
                  count_rtol: float = 1e-5, score_rtol: float = 5e-3,
                  score_atol: float = 1e-4, min_agree: float = 0.95
                  ) -> Dict:
    """Hold ``engine`` (a ``SearchAssistanceEngine`` of the same config)
    against ``ref`` after both stepped the same ticks. Returns a report:
    per store the key counts, flips and lane errors; the sessions; drops;
    the suggestions (sources each side, compared, top-3 agreement, sources
    whose top-3 scores break the contract, the largest score difference,
    the reference's LLR precision, capped sources and their
    disagreements); and ``faults``, the breaches of the contract (``ok``
    when there are none). At a deployment's totals give the reference
    ``llr_f32=True`` (the module's docstring says why)."""
    cfg = engine.cfg
    thr = cfg.decay.prune_threshold
    q, cooc = _engine_stores(engine)
    rep = {"qstore": _store_parity(q, ref.q, thr, weight_rtol, count_rtol),
           "cooc": _store_parity(cooc, ref.cooc, thr, weight_rtol,
                                 count_rtol)}
    st = engine.state
    rep["drops"] = {"qstore": int(st.qstore.n_dropped),
                    "cooc": int(st.cooc.n_dropped),
                    "sessions": int(st.sessions.n_dropped)}
    sess = _engine_sessions(engine)
    ref_sess = {s: (list(d), ref.sess_tick[s]) for s, d in ref.sessions.items()}
    rep["sessions"] = {
        "engine": len(sess), "reference": len(ref_sess),
        "mismatched": sum(sess.get(s) != v for s, v in ref_sess.items())
        + len(sess.keys() - ref_sess.keys())}

    caps = _caps(cfg, ref)
    capped = set(caps["bucket_rows"])
    es, rs = engine.suggestions, ref.suggestions
    both = es.keys() & rs.keys()
    agree = score_out = capped_disagree = compared = 0
    max_diff = 0.0
    for a in both:
        e3, r3 = es[a][:3], rs[a][:3]
        same_ids = [d for d, _ in e3] == [d for d, _ in r3]
        close = len(e3) == len(r3)
        if close:
            diff = [abs(x - y) for (_, x), (_, y) in zip(e3, r3)]
            close = all(d <= score_atol + score_rtol * abs(y)
                        for d, (_, y) in zip(diff, r3))
        if a in capped:
            capped_disagree += not (same_ids and close)
            continue
        compared += 1
        agree += same_ids
        score_out += not close
        if len(e3) == len(r3):
            max_diff = max([max_diff] + diff)
    rep["suggestions"] = {
        "engine_sources": len(es), "reference_sources": len(rs),
        "only_engine": len(es.keys() - rs.keys()),
        "only_reference": len(rs.keys() - es.keys()),
        "compared": compared, "agree_top3": agree,
        "agree_share": agree / compared if compared else 1.0,
        "score_out": score_out, "score_max_abs_diff": max_diff,
        "reference_llr": ("float64" if not ref.llr_f32 else "float32"
                          if ref.log_f32 is log_rounded
                          else "float32, given logs"),
        "capped": {"bucket_rows": len(capped),
                   "source_cap": caps["source_cap"], "arena": caps["arena"]},
        "capped_disagree": capped_disagree}

    faults = []
    for name in ("qstore", "cooc"):
        r = rep[name]
        if r["only_engine"] + r["only_reference"] > r["flips"]:
            faults.append(f"{name}: keys differ beyond threshold flips")
        if r["weight_out"] or r["count_out"]:
            faults.append(f"{name}: {r['weight_out']} weights, "
                          f"{r['count_out']} counts outside tolerance")
    if any(rep["drops"].values()):
        faults.append(f"drops {rep['drops']}")
    if rep["sessions"]["mismatched"]:
        faults.append(f"{rep['sessions']['mismatched']} sessions differ")
    sg = rep["suggestions"]
    if (sg["only_engine"] or sg["only_reference"]) and not (
            caps["source_cap"] or caps["arena"]):
        faults.append("suggestion sources differ")
    if sg["score_out"]:
        faults.append(f"{sg['score_out']} sources' top-3 scores outside "
                      f"tolerance")
    if sg["agree_share"] < min_agree:
        faults.append(f"top-3 agreement {sg['agree_share']:.4f} under "
                      f"{min_agree}")
    rep["faults"] = faults
    rep["ok"] = not faults
    return rep

"""The "Take One" Hadoop/Pig baseline of the paper's §3, simulated.

Port of the JAX package's ``data/batch_pipeline.py``. The paper's first
implementation computed the same statistics with a cascade of about a
dozen MapReduce jobs over hourly log directories, and was abandoned for
its end-to-end latency:

  * log import lag: "typically ... a couple of hours, although delays of up
    to six hours are not uncommon" (§3.1); best case with incremental import
    "latencies in the tens of minutes";
  * MR compute: "roughly a dozen MapReduce jobs ... around 15-20 minutes to
    process one hour of log data (without resource contention)" (§3.2);
  * job startup: "tens of seconds for a large job to start up";
  * stragglers: Zipfian key skew makes max task time >> mean task time.

The batch job's *computation* is real: each job re-ingests its window of
buffered logs into a fresh :class:`SearchAssistanceEngine` on ``device``
(the card unless the caller names another) and ranks once. Its *latency*
is modelled with the paper's numbers (:class:`HadoopLatencyModel`), so the
batch and streaming time to suggestion of one breaking-news event can be
set side by side.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..core import stores
from ..core.engine import EngineConfig, SearchAssistanceEngine


@dataclasses.dataclass(frozen=True)
class HadoopLatencyModel:
    """Latency budget of the §3 pipeline, in simulated seconds."""
    import_lag_s: float = 2 * 3600.0        # typical "couple of hours"
    import_lag_best_s: float = 20 * 60.0    # best-case incremental import
    mr_minutes_per_log_hour: float = 17.5   # 15-20 min per hour of logs
    n_chained_jobs: int = 12
    startup_s_per_job: float = 20.0         # "tens of seconds"
    straggler_factor: float = 1.25          # max-task vs mean-task stretch
    contention_factor: float = 1.0          # shared-cluster queueing

    def compute_time_s(self, log_hours: float) -> float:
        mr = self.mr_minutes_per_log_hour * 60.0 * log_hours
        startup = self.startup_s_per_job * self.n_chained_jobs
        return (mr * self.straggler_factor + startup) * self.contention_factor

    def end_to_end_s(self, log_hours: float, *, best_case: bool = False) -> float:
        lag = self.import_lag_best_s if best_case else self.import_lag_s
        return lag + self.compute_time_s(log_hours)


@dataclasses.dataclass
class HourlyLogDir:
    """An hour of logs "on HDFS": visible only after the import lag."""
    hour: int
    query_batches: List
    tweet_batches: List
    generated_at_s: float
    available_at_s: float


class BatchPipeline:
    """Oink-scheduled hourly Pig cascade, simulated over the same stream.

    Buffers the stream into hourly log directories, applies the import-lag
    visibility rule, and when an hour closes recomputes the whole
    suggestion table from the trailing ``window_hours`` of logs with the
    same statistics engine: one fresh engine re-ingests the window, as the
    Pig cascade did. ``ticks_per_hour`` is a plain attribute a caller may
    overwrite to compress simulated hours. A job keeps only its host
    suggestion table; its engine (9.35 GiB at the hash cell's widths) is
    freed when the job returns, before the next job starts.
    """

    def __init__(self, cfg: EngineConfig, latency: HadoopLatencyModel,
                 tick_seconds: float, window_hours: int = 4, device=None):
        self.device = stores.resolve_device(device)
        self.cfg = dataclasses.replace(cfg, decay_every=0, rank_every=0)
        self.latency = latency
        self.tick_seconds = tick_seconds
        self.window_hours = window_hours
        self.ticks_per_hour = max(int(3600.0 / tick_seconds), 1)
        self.hours: List[HourlyLogDir] = []
        self._cur_q: List = []
        self._cur_t: List = []
        self.tick = 0
        # (suggestions, done_s) of every completed batch job, in order
        self.results: List[Tuple[Dict, float]] = []

    def ingest_tick(self, query_events, tweets) -> None:
        self._cur_q.append(query_events)
        self._cur_t.append(tweets)
        self.tick += 1
        if self.tick % self.ticks_per_hour == 0:
            hour = self.tick // self.ticks_per_hour - 1
            gen_s = self.tick * self.tick_seconds
            self.hours.append(HourlyLogDir(
                hour=hour, query_batches=self._cur_q, tweet_batches=self._cur_t,
                generated_at_s=gen_s,
                available_at_s=gen_s + self.latency.import_lag_s))
            self._cur_q, self._cur_t = [], []
            self._run_job(hour)

    def _run_job(self, upto_hour: int) -> None:
        """Oink fires the cascade once the hourly directory 'appears'."""
        window = [h for h in self.hours
                  if upto_hour - self.window_hours < h.hour <= upto_hour]
        eng = SearchAssistanceEngine(self.cfg, name=f"batch@h{upto_hour}",
                                     device=self.device)
        for h in window:
            for q, t in zip(h.query_batches, h.tweet_batches):
                eng.step(q, t)
        eng.run_rank_cycle()
        log_hours = float(len(window))
        done_s = (max(h.available_at_s for h in window)
                  + self.latency.compute_time_s(log_hours))
        self.results.append((eng.suggestions, done_s))

    def suggestions_at(self, sim_time_s: float) -> Dict:
        """The newest batch result whose job had completed by sim_time_s."""
        best: Dict = {}
        for sugg, done in self.results:
            if done <= sim_time_s:
                best = sugg
        return best

"""The port's §3 batch baseline (``data/batch_pipeline.py``) against JAX's.

Both pipelines run the same stream, drawn from a seed: the breaking-news
benchmark's stream and engine sizes, the steve-jobs event at tick 10,
hours compressed to 5 ticks, a 2-hour window, 30 ticks (six jobs). The
hourly directories, every job's ``done_s`` and the latency model must be
exact; every job's suggestions hold under the parity contract
(``torch_parity.compare_suggestions``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.engine import EngineConfig as JEngineConfig
from repro.data.batch_pipeline import BatchPipeline as JBatchPipeline
from repro.data.batch_pipeline import HadoopLatencyModel as JLatency
from repro.data.stream import StreamConfig as JStreamConfig
from repro.data.stream import SyntheticStream as JStream
from repro.data.stream import steve_jobs_scenario as j_scenario
from repro_torch.core.engine import EngineConfig
from repro_torch.data.batch_pipeline import (BatchPipeline, HadoopLatencyModel,
                                             HourlyLogDir)
from repro_torch.data.stream import StreamConfig, SyntheticStream
from repro_torch.data.stream import steve_jobs_scenario
from torch_parity import compare_suggestions

STREAM = dict(vocab_size=1024, queries_per_tick=1024, tweets_per_tick=64,
              tick_seconds=30.0)
ENGINE = dict(query_capacity=1 << 14, cooc_capacity=1 << 16,
              session_capacity=1 << 13, decay_every=4, rank_every=10)
N_TICKS, TICKS_PER_HOUR, WINDOW, EVENT_AT, SEED = 30, 5, 2, 10, 1


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """XLA:CPU's compiled executables hold memory maps of the worker
    process, which count against its map limit; the tier-1 run's
    JAX-heavy workers come close to it, so this file releases its own."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(scenario, config, stream_cls):
    scfg, event = scenario(base_cfg=config(**STREAM))
    scfg = dataclasses.replace(scfg, events=(
        dataclasses.replace(event, t_start=EVENT_AT),))
    return stream_cls(scfg, seed=SEED), scfg


def _drive(pipe, stream):
    pipe.ticks_per_hour = TICKS_PER_HOUR
    for t in range(N_TICKS):
        pipe.ingest_tick(*stream.gen_tick(t))
    return pipe


@pytest.fixture(scope="module")
def pipelines():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        js, jscfg = _stream(j_scenario, JStreamConfig, JStream)
        ts, tscfg = _stream(steve_jobs_scenario, StreamConfig, SyntheticStream)
        jp = _drive(JBatchPipeline(JEngineConfig(**ENGINE), JLatency(),
                                   tick_seconds=jscfg.tick_seconds,
                                   window_hours=WINDOW), js)
        tp = _drive(BatchPipeline(EngineConfig(**ENGINE), HadoopLatencyModel(),
                                  tick_seconds=tscfg.tick_seconds,
                                  window_hours=WINDOW, device="cpu"), ts)
    finally:
        torch.set_num_threads(n)
    return jp, tp, ts


def test_batch_config_turns_off_the_engine_cadences(pipelines):
    jp, tp, _ = pipelines
    assert (tp.cfg.decay_every, tp.cfg.rank_every) == (0, 0)
    got, exp = dataclasses.asdict(tp.cfg), dataclasses.asdict(jp.cfg)
    # the fields both packages have (JAX's adds the plan and kernel knobs)
    for k, v in got.items():
        if isinstance(v, dict):
            assert {f: v[f] for f in v if f in exp[k]} == \
                {f: exp[k][f] for f in v if f in exp[k]}, k
        else:
            assert v == exp[k], k
    assert tp.device.type == "cpu"
    assert len(tp.results) == len(jp.results) == N_TICKS // TICKS_PER_HOUR


@pytest.mark.parametrize("field", [f.name for f in
                                   dataclasses.fields(HourlyLogDir)])
def test_hourly_log_dirs_match_jax(pipelines, field):
    jp, tp, _ = pipelines
    assert len(tp.hours) == len(jp.hours)
    for th, jh in zip(tp.hours, jp.hours):
        a, b = getattr(th, field), getattr(jh, field)
        if field.endswith("_batches"):
            assert len(a) == len(b) == TICKS_PER_HOUR
            for x, y in zip(a, b):
                for u, v in zip(x, y):
                    np.testing.assert_array_equal(u, v)
        else:
            assert type(a) is type(b) and a == b


def test_every_job_done_s_is_exactly_jax(pipelines):
    jp, tp, _ = pipelines
    assert [d for _, d in tp.results] == [d for _, d in jp.results]


@pytest.mark.parametrize("job", range(N_TICKS // TICKS_PER_HOUR))
def test_every_job_suggestions_match_jax(pipelines, job):
    jp, tp, _ = pipelines
    got, exp = tp.results[job][0], jp.results[job][0]
    assert got, "a batch job surfaced no suggestions"
    compare_suggestions(got, exp)


def test_event_surfaces_in_a_batch_job(pipelines):
    """Some job whose window saw the event holds a related term for the
    head query, as the breaking-news benchmark looks for it."""
    _, tp, stream = pipelines
    event = stream.cfg.events[0]
    head = stream.tok.query_fp(event.terms[0])
    related = {stream.tok.query_fp(t) for t in event.terms[1:]}
    hits = [i for i, (sugg, _) in enumerate(tp.results)
            if {d for d, _ in sugg.get(int(head), [])} & related]
    assert hits and min(hits) >= EVENT_AT // TICKS_PER_HOUR - 1


def test_suggestions_at_picks_the_same_job_as_jax(pipelines):
    jp, tp, _ = pipelines
    done = sorted({d for _, d in jp.results})
    times = [0.0, done[0] - 1e-3] + [x + dx for x in done
                                     for dx in (-1.0, 0.0, 0.5)]
    times += [done[-1] + 3600.0]
    picked = 0
    for t in times:
        got, exp = tp.suggestions_at(t), jp.suggestions_at(t)
        # the job a sim time picks: the last result done by then, or none
        want = [i for i, (_, d) in enumerate(tp.results) if d <= t]
        assert (got is tp.results[want[-1]][0]) if want else got == {}
        assert set(got) == set(exp)
        if got:
            compare_suggestions(got, exp)
            picked += 1
    assert picked > 0


MODELS = [dict(), dict(contention_factor=1.7, straggler_factor=1.1),
          dict(import_lag_s=6 * 3600.0, import_lag_best_s=600.0,
               mr_minutes_per_log_hour=15.0, n_chained_jobs=11,
               startup_s_per_job=35.0)]


@pytest.mark.parametrize("kw", MODELS, ids=["defaults", "contended",
                                            "slow-import"])
@pytest.mark.parametrize("best_case", [False, True])
def test_latency_model_is_jax_bit_for_bit(kw, best_case):
    got, exp = HadoopLatencyModel(**kw), JLatency(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(exp)
    for h in (0.0, 0.5, 1.0, 2.0, 3.0, 4.0, 7.25, 24.0, 1e-7):
        assert got.compute_time_s(h) == exp.compute_time_s(h)
        assert (got.end_to_end_s(h, best_case=best_case)
                == exp.end_to_end_s(h, best_case=best_case))


def test_ticks_per_hour_follows_tick_seconds():
    for ts in (30.0, 10.0, 7.0, 3600.0, 5000.0):
        got = BatchPipeline(EngineConfig(**ENGINE), HadoopLatencyModel(), ts,
                            device="cpu")
        exp = JBatchPipeline(JEngineConfig(**ENGINE), JLatency(), ts)
        assert got.ticks_per_hour == exp.ticks_per_hour
        assert (got.window_hours, got.tick) == (exp.window_hours, exp.tick)

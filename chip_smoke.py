#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile-region-only [--root DIR]
    python3 chip_smoke.py --profile-hash-only [--root DIR]
    python3 chip_smoke.py --flash-crowd-only
    python3 chip_smoke.py --tune-only
    python3 chip_smoke.py --fleet-only
    python3 chip_smoke.py --sharded-only
    python3 chip_smoke.py --moe-only
    python3 chip_smoke.py --recsys-only
    python3 chip_smoke.py --train-only
    python3 chip_smoke.py --batch-only

Phases, each of which must pass:

  1. card and build — the card's name and power limit (nvidia-smi), then
     every CUDA kernel built from ``src/repro_torch/kernels/csrc``;
  2. kernels at main-path shapes — each kernel against its plain torch
     version on the card (random inputs from a numpy seed; ``chain_find``
     on the region store and the largest pair batch of an untimed replay
     of the phase-4 region run's ticks): max error; the kernel's own time
     (its bare launch into preallocated outputs), the wrapper's, the plain
     version's and the library call's time (CUDA events, median of 20
     after warm-up); and the least time the card could take (HBM bytes
     at 3.35 TB/s or operations at 67 TFLOP/s f32, whichever is larger;
     for ``flash_attention`` its in-band FLOPs at the 989 TFLOP/s bf16
     tensor-core peak and its exponentials at the SFU rate).
     ``edit_distance`` runs on the largest pair batch of an untimed run of
     the phase-4 spelling job, on both kernel routes with the same pairs
     (the job's first_char_cost 1.5 on the half-unit DPX route, 1.3 on
     the f32 route; each bit-equal to the plain version, its ms, % of
     bound, cells/us and ``-Xptxas -v`` lines printed; the half-unit route
     must be the faster). ``bucket_topk`` runs on both kernel routes (the
     wrapper's row route, one thread a row, and the warp route forced
     through its bare launch) with the same grid, each equal to the plain
     version in values and every column: a synthetic 4,194,304 x 64 grid
     (K 8, half -inf, heavy ties; ms, % of bound, rows/us and
     ``-Xptxas -v`` lines printed; the row route must be the faster), and
     the main paths' own grids at their last rank cycle from untimed
     replays of their ticks (the hash bucket grid, with the rows that hold
     a finite value counted, and the region chain merge's candidates).
     ``chain_find`` prints its batch's active share and the 32-row groups
     with no active row, its route, rows a warp, time, share of the bound,
     the other load route's time (forced), the time at each rows-a-warp
     and ``-Xptxas -v`` lines, then the same times on the run's other
     batch size. ``region_rank`` runs on both kernel routes (the wrapper's
     row route, gate first, and the warp route forced through its bare
     launch), each held against the plain version, under both decay
     policies: on a synthetic 131,072 x 128 grid (~71% of slots pass; the
     row route must be the faster), with its ``-Xptxas -v`` lines and
     static SASS counts beside assoc_score's; and on the region path's own
     grid of its last rank cycle (an untimed replay). Both grids are timed
     against the bytes that grid needs and against a yardstick that reads
     every slot. ``scripts/score_rate.py`` measures the score floor, the
     card's time for the scoring chain alone a slot (its run that scores
     less its run that only makes the inputs), and every scoring
     kernel's time is also set beside the floor times the slots it scored.
     ``score_gate`` (both decay policies) and ``assoc_score`` run on
     synthetic 2^24 lanes (~71% of slots pass) and on the lanes the hash
     path's last rank cycle gave ``score_gate`` (an untimed replay; ~1.4%
     live), each bit-equal to its plain version (score_gate wherever the
     gates agree; the lazy gate's flips within 1 ulp of min_pair_weight
     counted) through the wrapper and its bare launch, on the lanes and on
     copies one element off 16-byte alignment (the 4-byte route); each
     route timed with its pass share, the bytes those inputs need,
     the 29 B (28 B) a slot yardstick, ``-Xptxas -v`` lines and static
     SASS counts.
     ``flash_attention`` runs on layer 0's q/k/v from
     the phase-6 scoring forward (bf16, B 4, T 8192; the twin row by row),
     plus an f32 case at T 2048; its library column is SDPA with the band
     as mask, and the kernels SDPA ran are printed; the bf16 kernel (tensor
     cores) must beat that SDPA call, and its % of bound, TFLOP/s and
     ``-Xptxas -v`` lines are printed;
  3. the engine on the card against the engine on the CPU at a small size
     (state under the parity contract, suggestions), under both cooc
     layouts (hash: sweep policy; region: sweep and lazy policies); the
     spelling job and the count-min sketch on the card against the CPU
     (the small engine's qstore plus planted misspellings); the LM's
     danube, granite, qwen3, qwen2-moe and mixtral SMOKE models (f32) on
     the card against the CPU: forward (and the MoE router loss), prefill
     and 4 decode steps (mixtral's runs the f32 kernel at head dim 16,
     window 16); the four recsys SMOKE models' serve (256 rows) and
     retrieval (4,096 candidates) steps and the GAT SMOKE model on its four
     cells (the two large graphs cut to 4,096 nodes) on the card against
     the CPU, f32 with TF32 off, within the CPU tests' 1e-5 bars;
  4. the main paths at deployment scale — ``SearchAssistanceEngine.step``
     for 17 ticks (4 decay sweeps, 2 rank cycles), once with the hash cooc
     layout and once with the region layout, each with its kernels'
     launch counts set to 0 just before and read just after (every
     ``bucket_topk`` launch on its row route); suggestions
     out, no drops on the hash path (region drops are printed), every
     ``score_gate`` launch on its 16-byte route. After the
     hash path, the spelling job over its 17-tick qstore, as the serving
     loop runs it (export, join_fp, tok.text, ``spelling_cycle``), with
     ``edit_distance``'s launches counted the same way (all on the
     half-unit route): sources, filtered pairs, wall time, corrections,
     peak memory, the stream's planted misspellings that are live and
     corrected to their true form; then 256 sources re-solved over all
     candidates with the plain version;
  5. determinism — the same stream twice gives bit-identical state, under
     each layout, the spelling job twice gives the same corrections in
     the same order, and two scoring forwards give bit-identical logits;
  6. the LM serving path — h2o-danube-1.8b at its published widths and
     depth, bf16, random weights from a seed: the scoring forward over 4
     requests of 8192 tokens (24 ``flash_attention`` launches, counts set
     to 0 just before and read just after; wall ms, tokens/s, peak
     memory); prefill of the same prompts into ring caches and 16 greedy
     decode steps (ms, peak memory, flash launches: 0); one kernel forward
     over prompt + decoded tokens (T 8208) whose logits must match the
     prefill's last chunk and every decode step; then the model in f32
     (TF32 off), B 1: prefill and 4 decode steps against the kernel
     forward at a bound a bf16 computation fails;
  7. crash recovery at deployment scale, under the hash and then the
     region layout (the phase-4 configuration and stream, seed 0): 21
     ticks, each appended to a ``FirehoseLogWriter`` (4 ticks a segment)
     before ``step``, ``save_snapshot`` into a ``CheckpointManager``
     (``full_interval=2``) at the rank cycles of ticks 8 and 16 (a full,
     then a delta); the state after tick 19 kept as the reference (host
     copies); tick 20 appended and torn by ``kill_writer_mid_segment``;
     then ``recover_engine`` from the newest chain (3 ticks replayed) and
     from the full alone (11 ticks), each bit for bit against the
     reference, leaf for leaf, its handoff rank cycle's suggestions equal
     to a rank cycle on the reference. Printed per layout: snapshot bytes
     (raw and on disk), the save split (device-to-host copy,
     ``diff_leading_rows``, ``savez``, raw sha256, zlib, file sha256,
     write and fsync) against the 80-s rank period, the restore split
     (read, sha256, zlib, raw sha256, npz load, delta apply, host-to-device
     copy), replay ms a tick and its multiple of real time (10-s ticks),
     time to fresh (restore + replay + handoff rank), peak device memory
     and the kernels' launches on the recovery path (counts set to 0
     before each recovery and read after; each of the layout's kernels
     must launch). Then ``repro_torch.breaking_news`` on the card: the
     related terms must surface within 10 sim-minutes and survive the
     crash;
  8. the serving stack at deployment scale — ``repro_torch.launch.
     serve_assist``'s loop on the phase-4 hash configuration and stream
     with the ``steve_jobs_scenario`` event (two rt replicas, the
     background engine, the durable log, delta-chained state snapshots
     of both engines, two frontends behind a ``ServerSet``), cut in
     depth to 49 ticks: the event and the spelling job at tick 36 (the
     launcher's 60, ``SERVE_EVENT_AT``), crashed right after tick 31 (the
     end of a log segment, 7 ticks past both engines' tick-24
     snapshots); ``recover_service`` on its directories must restore both
     engines bit for bit against host copies of their states at the
     crash; then the loop resumes with ``recover`` through tick 48
     (requests at 36 and 48). Printed with the card's name and power
     limit: ms per stack tick, each engine's full and delta save ms,
     whole-stack time to fresh against the 80-s rank period, the spelling
     job's ms and corrections, ``ServerSet.request`` p50/p99 over 1,000
     live query texts, the frontends' ``rt_lag_ticks``/``bg_lag_ticks``,
     ``related('steve jobs')`` at tick 48 and the event terms it holds,
     peak device memory and the phase's launches (counts set to 0 before,
     read after). ``decay_prune_multi``, ``score_gate``, ``bucket_topk``
     and ``edit_distance`` must launch, and the tick-48 answer must be
     non-empty and come from the tick-48 table;
  9. a flash crowd at deployment scale — ``serve_assist``'s loop on the
     hash configuration under its firehose workload (1,024 queries and 64
     tweets a 10-s tick, a 50x spike from tick 16 capped at 16,384
     queries, spam bursts), with overload control (``--slo-ms``
     ``FLASH_SLO_FACTOR`` times the slowest of eight warm base-traffic
     steps the phase times first, ``--tick-ms`` ``FLASH_TICK_MS``; the
     follower replica as a mirror) and log compaction every 16 ticks keeping 2
     bases; the stack crashes after tick 39, inside the shed window, right
     after sealing its log; the drained engines' states are kept on the
     host; ``recover_service`` from the state snapshots older than the
     newest base must go through that base and equal them bit for bit;
     the loop resumes with ``recover`` through tick 47 (each engine takes
     the base only where its snapshot is older) and the head query
     ``breaking0 term0`` must be answered, non-empty, from the newest
     table; then a cold rt engine restores the newest base and replays the
     tail (the segments below the retained floor are gone from disk), and,
     with the newest base torn (``corrupt_base``), falls back to the
     previous one (counted), each bit for bit. At every ladder level
     entered, queries and tweets offered equal those logged plus those
     shed, and the shed rank cycles are counted; level 3 must be reached
     (pinned from tick 30 if the live triggers have not reached it, which
     the output says). Printed with the card's name and power limit: ms
     per stack tick for base and spike ticks, the live step percentiles,
     ticks at each level, escalations and shed counts, flushes, each
     compaction's split per engine (restore, fold replay, base save, base
     bytes) and the log's bytes before and after, each save's ms, time to
     fresh through the base and with the fallback against the 80-s rank
     period, the frontends' lags, peak device memory and the phase's
     launches (``decay_prune_multi``, ``score_gate`` and ``bucket_topk``
     must launch); then ``score_gate`` and ``bucket_topk`` held against
     their plain versions on the inputs of the phase's last rank cycle;
 10. tuning and the oracle at deployment scale — ``launch/autotune.tune``
     for the hash and the region cell into a fresh cache directory (the
     shape class; each op's kernel and twin µs; each kernel's roofline
     fraction under the JAX tuner's traffic model at the
     ``launch/mesh`` peaks; the plan): every op of the layout must say
     "kernel" and launch its kernel (counts set to 0 before and read
     after); a second ``tune`` must hit the cache with no launch and the
     same plan; then the port's ``ReferenceEngine`` (its LLR term in the
     engine's float32) over phase 4's 17 hash ticks against the hash
     engine on the card under the parity contract
     (``core/reference.parity_report``: keys exact, weights and counts,
     top-3 agreement and scores at rtol 5e-3, atol 1e-4; the sources the
     ranking caps counted; the reference's wall time); the region cell is
     not compared (it drops pair updates at this scale); last
     ``serve_assist --autotune`` for 13 ticks on the card, whose
     frontend's ``metrics()["tuned_variants"]`` must equal the printed
     plan;
 11. the self-healing replicated fleet at deployment scale — (a) a
     ``ServingFleet`` of 3 replicas on the hash configuration under the
     firehose workload (a 50x spike from tick 4, spam bursts, seed 0),
     against an uninterrupted ``AssistanceService`` stepping the same
     ticks: replica 2 answers through a 0.05-s slow disk against a 0.01-s
     client timeout until the kills, the leader is killed mid-segment at
     tick 7 and follower 2 at tick 12, one ``ServerSet.request_info`` for
     ``breaking0 term0`` a tick, through tick 24 and on until every
     replica is live. It must show zero failed requests, 2 deaths, 2
     recoveries, 2 failovers, epoch 2, leader 0, no lost and at least 3
     healed ticks, a gap-free log, a zombie writer at epoch 0 refused with
     the manifest untouched, every replica's rt and bg state bit for bit
     the reference's, no climb of device memory from one restart to the
     next, and ``decay_prune_multi``, ``score_gate`` and ``bucket_topk``
     launched by the fleet (counts set to 0 before, the reference's
     launches subtracted). Printed with the card's name and power limit:
     ms per fleet tick (``offer_tick``) at base and spike ticks, request
     p50/p99 over the run and the failover window with hedges and
     timeouts, each restart's time to fresh and split against the 80-s
     rank period and the device memory after it, ticks from kill to
     detection and to readmission, each leader save's ms per engine, the
     peak and the phase's wall time; (b) ``serve_assist --fleet 3
     --kill-leader-at 7 --kill-follower-at 12 --workload firehose
     --spike-at 6 --compact-every 8 --keep-bases 2 --ticks 24`` at the
     launcher's own settings, whose ``[done] fleet:`` line must report 2
     failovers, 2 recoveries, 0 lost ticks and a compaction;
 12. the sharded engine on one card — ``core/sharded_engine.py`` with 8
     shards at the hash cell's widths (query store 2^22, cooc 2^24 and
     sessions 2^20 in all, ``ShardedConfig`` defaults) over the engine
     cell's query hose (16,384 queries a tick, no tweets, seed 0); every
     part must show 0 route drops. (a) hash layout, sweep policy, 17
     ticks through ``make_sharded_tick_step``, ranked at ticks 8 and 16,
     against the unsharded engine on the same ticks (``ingest_quantum``
     0: both ingest a tick whole): the query store bit for bit, equal
     merged key sets, and top-3 scores within rtol 5e-3, atol 1e-4 for
     every source whose pairs each live in one shard; a source that
     crossed ``hot_threshold`` mid-run holds some pairs in two shards
     (the JAX engine's salting), and those sources are counted and
     printed, not held; ``export_sharded_pairs`` against ``export_live``
     (keys on one side, prune flips, weight difference) printed; (b) hash
     layout, lazy policy: a live run of 17 ticks against a crash after
     tick 8 with delta-chained snapshots (full at 4, delta at 8), restored
     and replayed through ``make_sharded_ingest_many``: every leaf bit for
     bit the live run's; (c) region layout, sweep policy: 8 shards to tick
     12 with the port's firehose log, the old state serving ticks 12-13
     while ``distributed/elastic.live_reshard`` splits it to 16 shards and
     replays them: equal merged key sets, no source's top score lower;
     then a merge back to 8 with equal key sets. Then each kernel of the
     path against its plain version at one shard's shapes:
     ``decay_prune_multi`` at a shard's cooc capacity, ``score_gate`` and
     ``bucket_topk`` on shard 0's rank-cycle inputs, ``region_rank`` and
     the chain merge's ``bucket_topk`` on the region state's shard 0, and
     ``chain_find`` on the largest batch of one more region tick. Printed
     with the card's name and power limit: ms per sharded tick (p50, max)
     and per rank cycle, live slots and sessions per shard, peak memory,
     each part's launches (counts set to 0 just before it, the unsharded
     reference's not counted; ``decay_prune_multi``, ``score_gate``,
     ``bucket_topk``, ``region_rank`` and ``chain_find`` must each be
     above 0), the snapshots' ms and bytes, restore and replay ms, the
     replay's multiple of a 10-s tick and the time to fresh, and the
     reshard's wall split (export, fill, replay), pairs, sessions and
     drops;
 13. the MoE LM serving path — qwen2-moe-a2.7b at its published widths
     and depth (60 experts, top-4, 4 shared), bf16, random weights from a
     seed: the scoring forward over 4 requests of 4096 tokens twice (24
     ``flash_attention`` launches, counts set to 0 just before and read
     just after; bit-identical logits; wall ms, tokens/s, peak memory),
     the capacity drops and router loss of each layer, and the layer with
     the most drops routed again on the card and, from the same logits,
     on the CPU (equal dispatch); prefill of the same prompts and 16
     greedy decode steps (ms, peak memory, flash launches: 0); then, with
     each MoE layer's top-k pinned to a kernel forward's, (A) a prefill
     against the scoring forward and (B) at a capacity where nothing
     drops, prefill and 16 decode steps against one kernel forward over
     prompt + decoded tokens, within bf16 bounds derived beside
     ``MOE_BF16_REL_RMS``; last, ``flash_attention`` at the scoring
     forward's layer-0 q/k/v (head dim 128, causal) against its twin,
     with its time, bound, SDPA's time and the ptxas lines of its D-128
     instantiation;
 14. the recsys and GNN serving paths — bst, xdeepfm, two-tower-retrieval
     and bert4rec at their full ``CONFIG``s (f32, TF32 off), seeded random
     weights made on the card (two-tower's tables 19.1 GiB), through
     ``models.api.serve_fn``: serve_p99 (512 rows), serve_bulk (262,144;
     bert4rec's is skipped and says why: 33.5 PFLOP of vocabulary scores,
     78 GiB of attention logits) and retrieval_cand (1M candidates; one
     row for bert4rec); then gat-cora's ``gnn.forward`` through
     ``adapt_config`` on full_graph_sm, molecule, minibatch_lg and
     ogb_products (61,859,328 edges). Each cell runs on ``make_inputs``'
     inputs (ids below 100) and on ids drawn from the seed uniformly over
     each whole table or node set (a GAT's real edges valid, its padding
     not). Printed per cell and input set, with the card's name and power
     limit: ms (median of 3 synced runs, each run's ms), rows/s,
     ``model_flops`` over the time and its share of the f32 peak, peak GiB,
     whether the runs agree bit for bit (a GAT's run-to-run difference:
     its segment sums use float atomics), and the card against the port's
     CPU path on 64 rows (a recsys cell's first 64 rows or candidates,
     two-tower's CPU holding only the table rows they touch; a GAT's nodes
     0-63 on the subgraph that determines them, skipped and said so where
     it holds over 2M edges), within 1e-5. No kernel lies on this path:
     every launch count must stay 0;
 15. training — (a) danube's and mixtral's SMOKE models (f32, TF32 off):
     8 AdamW steps on the card against the same 8 on the CPU from the same
     weights and token batches, each loss within rtol 1e-3; (b)
     h2o-danube-1.8b at its published widths and depth, bf16, remat
     "full", seeded random weights made on the card, AdamW with master
     weights, ``SyntheticTokenStream`` batches of 2 x 4096 tokens
     (train_4k's 256 rows cut to 2): one step's loss and gradients with
     the kernel forward against the same step with the twin forward (loss
     gap, global-norm gap and the worst leaf's relative RMS, each within
     the bound derived beside ``TRAIN_BF16_REL``), then 2 warmup and 6
     timed steps (counts set to 0 just before the timed ones, read just
     after: 2 x 24 ``flash_attention`` launches a step, the forward and
     its recompute), the first loss within 0.5 of ln 32,000 + 1/2 (the
     cross entropy of N(0, 1) logits) and the last below it; printed with
     the card's name and power limit: ms a step, tokens/s, ``6 N tokens``
     over the time as a share of the bf16 peak, peak GiB, a profiled step
     and the step's forward, backward and AdamW ms by CUDA events; then
     ``flash_attention`` at the train step's layer-0 q/k/v ([2, 32, 4096,
     80], causal) against its twin with its time, bound and SDPA's time;
     (c) one ``train_batch`` step each of bst, xdeepfm,
     two-tower-retrieval (tables cut to 5M + 5M rows, 32,768 rows) and
     bert4rec (8,192 rows) at their full ``CONFIG``s and of gat-cora on Cora, f32, TF32
     off, ids drawn over whole tables, after a card-against-CPU check of
     the loss and every gradient leaf on 64 rows (a GAT's whole graph):
     ms, rows/s, FLOP share of the f32 peak, peak GiB (at most 70), no
     kernel launched;
 16. the paper's §3 batch baseline — ``data/batch_pipeline.BatchPipeline``
     (hours compressed to 20 ticks, a 2-hour window, each job a fresh
     engine that re-ingests its window and ranks once) with the
     ``steve_jobs_scenario`` event at tick 30, seed 1: (a) at
     ``benchmarks/bench_latency.py``'s sizes (1,024 queries and 64 tweets
     a 30-s tick, engine 2^14/2^16/2^13), 40 ticks, the pipeline on the
     card against the same pipeline on the CPU: every job's ``done_s``
     exactly equal and its suggestions under the parity contract; (b) at
     the hash cell's widths (16,384 queries and 2,048 tweets a tick,
     engine 2^22/2^24/2^20, a rank cycle every 10 ticks), 90 ticks fed
     tick by tick to a streaming engine and to the pipeline (jobs at
     ticks 20, 40, 60 and 80): the streaming engine must surface a
     related term for the head query within 10 sim-minutes, every job
     must drop nothing, hold a suggestion table and finish at the latency
     model's arithmetic, and the batch path must launch ``score_gate`` and
     ``bucket_topk`` 4 times each and ``decay_prune_multi`` never (counts
     set to 0 before each tick's call, read after); printed with the
     card's name and power limit: each job's wall split (construction,
     re-ingest and ms a tick, rank cycle), live slots, drops and peak
     GiB, the streaming engine's ms a tick and rank ms, and the streaming,
     typical and best-case batch times to suggestion in sim-minutes,
     computed as ``bench_latency.py`` computes them; (c) the single-lane
     ``decay_prune`` on the streaming engine's query store (C = 2^22)
     against its plain version (lanes and live count bit for bit, the
     total within ``DECAY_TOTAL_RTOL``), and ``insert_accumulate_twopass``
     of the last tick's query batch into an empty 2^22 table, the card
     against the CPU bit for bit and against the fused insert as a map.
     Item 15's other kernel entries run in phase 2: ``ops.assoc_score``
     on the synthetic 2^24 lanes (bit for bit) and ``chain_find_depth``
     on the first chain column of the region run's largest pair batch
     (exact, against the CPU).

The second-to-last line is a JSON object with one record per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.

``--profile-region-only`` runs none of the phases: it drives the region
cell (its deployment configuration and stream, seed 0, 17 ticks) through
the public engine API, then profiles one more ingest tick and one rank
cycle as phase 4 does (wall, device time, the kernels that take it and
each engine kernel's summed device time, ``chain_find`` and
``region_rank`` among them). ``--profile-hash-only`` does the same for the
hash cell (``score_gate`` and ``bucket_topk`` in its rank cycle), then
times ``score_gate``'s and ``assoc_score``'s bare launches on the
synthetic lanes and on the lanes its last rank cycle gave ``score_gate``.
``--flash-crowd-only`` builds the kernels and runs phase 9 alone;
``--tune-only`` builds them and runs phase 10 alone; ``--fleet-only``
builds them and runs phase 11 alone; ``--sharded-only`` builds them and
runs phase 12 alone; ``--moe-only`` builds them and runs the MoE SMOKE
models of phase 3 and phase 13 alone; ``--recsys-only`` builds nothing
(no kernel lies on its path) and runs the recsys and GNN SMOKE models of
phase 3 and phase 14 alone; ``--train-only`` builds ``flash_attention``
alone and runs phase 15 alone; ``--batch-only`` builds the kernels and
runs phase 16 alone.
``--root DIR`` takes the ``repro_torch`` package from ``DIR/src``, where
DIR lies inside this checkout (a parent commit unpacked with ``git
archive`` under ``build/``), so one call on one card profiles two trees.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# The card's peaks (HBM bytes/s, f32 CUDA-core and dense bf16 tensor-core
# operations/s): ``repro_torch.launch.mesh``, read once the package is on
# the path (:func:`bind_peaks`).
HBM_BYTES_PER_S = F32_OPS_PER_S = BF16_TC_OPS_PER_S = None
# Exponentials: 16 a clock per SM (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0) x 132 SMs x the 1.98 GHz
# maximum boost clock (data sheet).
EXP_PER_S = 16 * 132 * 1.98e9
SEED = 0
# ~1 ms of device sleep at the H100's clock: queued before a timed call so
# the host's launch work hides under it and the events time the device.
SLEEP_CYCLES = 2_000_000


def log(*a):
    print(*a, flush=True)


def bind_peaks() -> None:
    global HBM_BYTES_PER_S, F32_OPS_PER_S, BF16_TC_OPS_PER_S
    from repro_torch.launch import mesh
    HBM_BYTES_PER_S = mesh.HBM_BW
    F32_OPS_PER_S = mesh.PEAK_FLOPS_F32
    BF16_TC_OPS_PER_S = mesh.PEAK_FLOPS_BF16


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device span of ``fn()`` in ms over ``reps`` calls (CUDA
    events), each queued behind a device sleep so host launch work is
    hidden."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels at main-path shapes.
# ---------------------------------------------------------------------------

def _u32_lane(rng, n, dead, dev):
    import numpy as np
    import torch
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    x[dead] = 0
    return torch.from_numpy(x.view(np.int32)).to(dev)


def check_decay_prune(C: int, n_aux: int, dev):
    """decay_prune_multi at a store of capacity C (1 weight lane, n_aux aux
    lanes), held bit-for-bit against the plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decay_prune import decay_prune_multi, launch
    rng = np.random.default_rng(SEED + C)
    dead = rng.random(C) < 0.4
    kh, kl = _u32_lane(rng, C, dead, dev), _u32_lane(rng, C, dead, dev)
    w = torch.from_numpy((rng.random(C) * 0.2).astype(np.float32)).to(dev)
    aux = [torch.from_numpy(np.floor(rng.random(C) * 9).astype(np.float32)).to(dev),
           torch.from_numpy(rng.integers(0, 17, C).astype(np.int32)).to(dev)]
    aux += [_u32_lane(rng, C, dead, dev) for _ in range(n_aux - 2)]
    f = float(2.0 ** (-4 / 36.0))
    got = decay_prune_multi(kh, kl, [w], aux, f, 0.05)
    exp = ref.decay_prune_multi_ref(kh, kl, [w], aux, torch.tensor(f), 0.05)
    for g, e in zip((got[0], got[1], *got[2], *got[3]),
                    (exp[0], exp[1], *exp[2], *exp[3])):
        if not torch.equal(g.view(torch.int32), e.view(torch.int32)):
            raise AssertionError(f"decay_prune_multi C={C}: lanes differ")
    err = float((got[2][0] - exp[2][0]).abs().max())
    outs = [torch.empty_like(t) for t in (kh, kl, w)]
    a_out = [torch.empty_like(a) for a in aux]
    ms = time_ms(lambda: launch(kh, kl, w, aux, *outs, a_out, f, 0.05))
    wrapper_ms = time_ms(lambda: decay_prune_multi(kh, kl, [w], aux, f, 0.05))
    plain_ms = time_ms(lambda: ref.decay_prune_multi_ref(
        kh, kl, [w], aux, torch.tensor(f), 0.05))
    lanes = 2 + 1 + n_aux
    b_ms, b_by = bound(C * lanes * 4 * 2, C * 2)
    return dict(max_abs_err=err, ms=ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def _score_inputs(C, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 1)
    mk = lambda s: (rng.random(C) * s).astype(np.float32)
    w_ab, c_ab = mk(5), np.floor(mk(20))
    w_a, w_b = mk(50), mk(50)
    c_a = np.maximum(c_ab, np.floor(mk(100)))
    c_b = np.maximum(c_ab, np.floor(mk(100)))
    lanes = [torch.from_numpy(x).to(dev) for x in (w_ab, c_ab, w_a, w_b, c_a, c_b)]
    ok = torch.from_numpy(rng.random(C) < 0.8).to(dev)
    lt = torch.from_numpy(rng.integers(0, 17, C).astype(np.int32)).to(dev)
    sc = [torch.tensor(x, dtype=torch.float32, device=dev)
          for x in (float(C) * 2.0, float(C) * 4.0, 17.0)]
    return lanes, ok, lt, sc


SCORE_OPS_PER_SLOT = 60   # f32 adds/muls/compares/divides + 9 libm calls


def score_floor():
    """``scripts/score_rate.py``'s measure(): the card's time for
    repro::score_body alone, ms per 2^24 scores (its "score" run less its
    "inputs" run, which makes the same inputs and skips the body), and the
    static SASS of its kernel."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "score_rate", ROOT / "scripts" / "score_rate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.measure()
    r = res["score"]
    log(f"  score floor (scripts/score_rate.py): {res['floor_ms_per_2_24']!r}"
        f" ms per 2^24 scores (scoring {r['ms_per_2_24']!r} less making the "
        f"inputs alone {res['inputs']['ms_per_2_24']!r}), "
        f"{r['sass_static']} static SASS (measured, not a bound)")
    return res


def floor_ms(floor, n_scored: int) -> float:
    return floor["floor_ms_per_2_24"] * n_scored / 2 ** 24


def score_gate_bytes(ok, passes, lazy: bool) -> int:
    """The bytes score_gate needs on these inputs: every slot's gate byte
    and score; the pair weight, count and source weight (and last_tick
    under the lazy policy) where the base gate is set; the dst weight and
    both counts' marginals where every gate passes; the three scalars."""
    C = ok.shape[0]
    return (C * 5 + int(ok.sum()) * (16 if lazy else 12)
            + int(passes.sum()) * 12 + 12)


def _times(fns):
    return {k: time_ms(fn) for k, fn in fns.items()}


def _unaligned(x):
    """``x`` copied into a view one element into a buffer of its own, a
    base that is not 16-byte aligned: the score kernels' 4-byte route."""
    buf = x.new_empty(x.numel() + 1)
    buf[1:].copy_(x)
    return buf[1:]


def score_gate_report(label, lanes, ok, lt, sc, half_life, gates, coefs,
                      floor):
    """score_gate on one set of lanes: the wrapper (its route counted) and
    its bare launch on these lanes and on copies one element off 16-byte
    alignment (the 4-byte route), each held against the plain version
    (bit-equal wherever the gates agree; gate flips only within 1 ulp of
    min_pair_weight, counted), then each bare launch timed against the bytes
    these inputs need, the 29 B (33 B lazy) a slot yardstick and the score
    floor times the slots scored. Returns the report."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_select as ktk
    kw = dict(coefs=coefs, half_life=half_life, **gates)
    routes = dict(ktk.SCORE_ROUTE_LAUNCHES)
    got = ktk.score_gate(*lanes, ok, lt, *sc, **kw)
    route = next(r for r, n in ktk.SCORE_ROUTE_LAUNCHES.items()
                 if n != routes[r])
    w_eff = lanes[0]
    if half_life is not None:
        w_eff = ktk.decay_exp2(lanes[0], lt, sc[2], half_life)
    exp = ref.score_gate_ref(w_eff, *lanes[1:], ok, sc[0], sc[1], coefs,
                             **gates)
    flips = torch.isneginf(got) != torch.isneginf(exp)
    near = (w_eff - gates["min_pair_weight"]).abs() <= 2.0 ** -23 * 0.25
    n_flips = int(flips.sum())
    if n_flips != int((flips & near).sum()):
        raise AssertionError(f"score_gate ({label}): gate masks differ away "
                             f"from the min_pair_weight boundary")
    if not torch.equal(got[~flips].view(torch.int32),
                       exp[~flips].view(torch.int32)):
        raise AssertionError(f"score_gate ({label}) differs from the plain "
                             f"version where the gates agree")
    both = ~flips & torch.isfinite(exp)
    err = float((got[both] - exp[both]).abs().max()) if bool(both.any()) \
        else 0.0
    scalars, gv = torch.stack(sc), tuple(gates.values())
    launches = {route: (lanes, ok, lt, torch.empty_like(got))}
    if route == "vec":
        launches["scalar"] = ([_unaligned(x) for x in lanes], _unaligned(ok),
                              None if lt is None else _unaligned(lt),
                              _unaligned(got))

    def launch(ls, o, l_t, out):
        ktk.launch_score_gate(ls, o, None if half_life is None
                              else l_t.data_ptr(), scalars, coefs, gv,
                              half_life, out)

    for name, args in launches.items():
        args[3].fill_(7.0)
        before = ktk.SCORE_ROUTE_LAUNCHES[name]
        launch(*args)
        if ktk.SCORE_ROUTE_LAUNCHES[name] != before + 1:
            raise AssertionError(f"score_gate ({label}) missed its {name} "
                                 f"route")
        if not torch.equal(args[3].view(torch.int32), got.view(torch.int32)):
            raise AssertionError(f"score_gate ({label}, {name} route) "
                                 f"differs from the wrapper's launch")
    ms = _times({name: (lambda args=args: launch(*args))
                 for name, args in launches.items()})
    C = got.shape[0]
    lazy = half_life is not None
    passes = got > -torch.inf
    n_ok, n_pass = int(ok.sum()), int(passes.sum())
    b_ms, b_by = bound(score_gate_bytes(ok, passes, lazy),
                       n_pass * SCORE_OPS_PER_SLOT)
    y_ms = bound(C * (33 if lazy else 29), 0)[0]
    f_ms = floor_ms(floor, n_pass) if floor else None
    log(f"  score_gate {label}, half_life={half_life}: C={C}, route "
        f"{route}, base gate {n_ok} ({100 * n_ok / C:.3f}%), {n_pass} pass "
        f"({100 * n_pass / C:.3f}%), gate flips within 1 ulp of "
        f"min_pair_weight {n_flips}; bound {b_ms!r} ms ({b_by}, the bytes "
        f"these inputs need), yardstick {y_ms!r} ms "
        f"({33 if lazy else 29} B a slot), score floor x {n_pass} scored "
        f"{f_ms!r} ms")
    for name, t in ms.items():
        log(f"  score_gate {label}, half_life={half_life}, {name} route: "
            f"{t!r} ms, {100 * b_ms / t:.2f}% of bound, {100 * y_ms / t:.2f}%"
            f" of the yardstick" + (f", {100 * f_ms / t:.2f}% of the score "
                                    f"floor" if f_ms else ""))
    return dict(ms=ms[route], route=route, slots=C, base_gate=n_ok,
                slots_pass=n_pass, gate_flips=n_flips, bound_ms=b_ms,
                bound_by=b_by, yardstick_bound_ms=y_ms, score_floor_ms=f_ms,
                ms_by_route=ms, max_abs_err=err)


def assoc_score_report(label, lanes, tot, coefs, floor):
    """assoc_score on one set of lanes, as score_gate_report: bit-equal to
    score_body on every slot, timed against the bytes these inputs need
    (c_ab and the score for every slot, the other five lanes where
    c_ab > 0), the 28 B a slot yardstick and the score floor."""
    import torch
    from repro_torch.kernels import assoc_score as kas
    routes = dict(kas.ROUTE_LAUNCHES)
    got = kas.assoc_score(*lanes, *tot, coefs=coefs)
    route = next(r for r, n in kas.ROUTE_LAUNCHES.items() if n != routes[r])
    exp = kas.score_body(*lanes, *tot, coefs)
    if not torch.equal(got.view(torch.int32), exp.view(torch.int32)):
        raise AssertionError(f"assoc_score ({label}) differs from score_body")
    fin = torch.isfinite(exp)
    err = float((got[fin] - exp[fin]).abs().max()) if bool(fin.any()) \
        else 0.0
    totals = torch.stack(tot)
    launches = {route: (lanes, torch.empty_like(got))}
    if route == "vec":
        launches["scalar"] = ([_unaligned(x) for x in lanes],
                              _unaligned(got))
    for name, (ls, out) in launches.items():
        out.fill_(7.0)
        before = kas.ROUTE_LAUNCHES[name]
        kas.launch_assoc_score(ls, totals, coefs, out)
        if kas.ROUTE_LAUNCHES[name] != before + 1:
            raise AssertionError(f"assoc_score ({label}) missed its {name} "
                                 f"route")
        if not torch.equal(out.view(torch.int32), got.view(torch.int32)):
            raise AssertionError(f"assoc_score ({label}, {name} route) "
                                 f"differs from the wrapper's launch")
    ms = _times({name: (lambda ls=ls, out=out: kas.launch_assoc_score(
        ls, totals, coefs, out)) for name, (ls, out) in launches.items()})
    C = got.shape[0]
    n_pos = int((lanes[1] > 0).sum())
    b_ms, b_by = bound(C * 8 + n_pos * 20 + 8, n_pos * SCORE_OPS_PER_SLOT)
    y_ms = bound(C * 28, 0)[0]
    f_ms = floor_ms(floor, n_pos) if floor else None
    log(f"  assoc_score {label}: C={C}, route {route}, c_ab > 0 at {n_pos} "
        f"({100 * n_pos / C:.3f}%); bound {b_ms!r} ms ({b_by}, the bytes "
        f"these inputs need), yardstick {y_ms!r} ms (28 B a slot), score "
        f"floor x {n_pos} scored {f_ms!r} ms")
    for name, t in ms.items():
        log(f"  assoc_score {label}, {name} route: {t!r} ms, "
            f"{100 * b_ms / t:.2f}% of bound, {100 * y_ms / t:.2f}% of the "
            f"yardstick" + (f", {100 * f_ms / t:.2f}% of the score floor"
                            if f_ms else ""))
    return dict(ms=ms[route], route=route, slots=C, slots_scored=n_pos,
                bound_ms=b_ms, bound_by=b_by, yardstick_bound_ms=y_ms,
                score_floor_ms=f_ms, ms_by_route=ms, max_abs_err=err)


def score_kernel_code() -> None:
    """The ``-Xptxas -v`` lines and static SASS counts of both kernels'
    instances."""
    for stem, kernel in (("score_gate", "score_gate_tile_kernel"),
                         ("assoc_score", "assoc_score_tile_kernel")):
        for line in ptxas_report(stem, kernel):
            log(f"    ptxas ({stem}): {line}")
        counts = sass_count(stem, kernel)
        log(f"    SASS instructions, static ({stem}): "
            + ("not measured" if counts is None else json.dumps(counts)))


def check_score_gate(C: int, dev, floor):
    """score_gate on the synthetic lanes (~71% of slots pass) under both
    decay policies (score_gate_report), its wrapper's and plain version's
    times, ptxas lines and static SASS counts."""
    from repro_torch.core.ranking import RankConfig
    from repro_torch.kernels import ref
    from repro_torch.kernels.topk_select import score_gate
    rc = RankConfig()
    gates = dict(min_pair_weight=rc.min_pair_weight,
                 min_src_weight=rc.min_src_weight,
                 min_pair_count=rc.min_pair_count)
    lanes, ok, lt, sc = _score_inputs(C, dev)
    rep = {hl: score_gate_report("synthetic lanes", lanes, ok, lt, sc, hl,
                                 gates, rc.coefs, floor)
           for hl in (None, 36.0)}
    score_kernel_code()
    kw = dict(coefs=rc.coefs, half_life=None, **gates)
    wrapper_ms = time_ms(lambda: score_gate(*lanes, ok, lt, *sc, **kw))
    plain_ms = time_ms(lambda: ref.score_gate_ref(
        *lanes, ok, sc[0], sc[1], rc.coefs, **gates))
    r, lz = rep[None], rep[36.0]
    return dict(max_abs_err=r["max_abs_err"], ms=r["ms"],
                wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=None, kernel_route=r["route"],
                slots_pass=r["slots_pass"],
                yardstick_bound_ms=r["yardstick_bound_ms"],
                score_floor_ms=r["score_floor_ms"],
                ms_by_route=r["ms_by_route"], lazy_ms=lz["ms"],
                lazy_max_abs_err=lz["max_abs_err"],
                lazy_bound_ms=lz["bound_ms"],
                lazy_slots_pass=lz["slots_pass"],
                lazy_gate_flips=lz["gate_flips"])


def check_assoc_score(C: int, dev, floor):
    """The stand-alone assoc_score kernel on the synthetic lanes
    (assoc_score_report; no engine caller: its launches on the main paths
    are 0), its wrapper's and plain version's times."""
    from repro_torch.core.ranking import RankConfig
    from repro_torch.kernels.assoc_score import assoc_score, score_body
    import torch
    from repro_torch.kernels import ops
    coefs = RankConfig().coefs
    lanes, _, _, sc = _score_inputs(C, dev)
    r = assoc_score_report("synthetic lanes", lanes, sc[:2], coefs, floor)
    got = ops.assoc_score(*lanes, sc[0], sc[1], coefs=coefs)
    if not torch.equal(got.view(torch.int32), score_body(
            *lanes, sc[0], sc[1], coefs).view(torch.int32)):
        raise AssertionError("ops.assoc_score differs from the plain version")
    log(f"  ops.assoc_score (the engine-facing entry) at C={C}: equal to "
        f"the plain version bit for bit")
    wrapper_ms = time_ms(lambda: assoc_score(*lanes, sc[0], sc[1],
                                             coefs=coefs))
    plain_ms = time_ms(lambda: score_body(*lanes, sc[0], sc[1], coefs))
    return dict(max_abs_err=r["max_abs_err"], ms=r["ms"],
                wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=None, kernel_route=r["route"],
                slots_scored=r["slots_scored"],
                yardstick_bound_ms=r["yardstick_bound_ms"],
                score_floor_ms=r["score_floor_ms"],
                ms_by_route=r["ms_by_route"])


def check_score_path_lanes(call, tick, floor, label=None):
    """score_gate and assoc_score on the lanes the hash path's rank cycle of
    ``tick`` passed score_gate (an untimed replay; ``label`` names other
    lanes): score_gate_report on them, and assoc_score_report on the same
    six lanes."""
    import torch
    a, kw = call
    w_ab, c_ab, w_a, w_b, c_a, c_b, ok, total_w, total_c = a
    if kw.get("decay_cfg") is not None:
        raise AssertionError("the hash cell runs the sweep policy")
    total_w, total_c = (x.to(torch.float32).reshape(())
                        for x in (total_w, total_c))
    lanes = (w_ab, c_ab, w_a, w_b, c_a, c_b)
    gates = dict(min_pair_weight=kw["min_pair_weight"],
                 min_src_weight=kw["min_src_weight"],
                 min_pair_count=kw["min_pair_count"])
    label = label or f"hash path lanes, tick {tick}"
    sc = [total_w, total_c, total_w.new_zeros(())]
    sg = score_gate_report(label, lanes, ok, None, sc, None, gates,
                           kw["coefs"], floor)
    asc = assoc_score_report(label, lanes, [total_w, total_c], kw["coefs"],
                             floor)
    return {"score_gate": sg, "assoc_score": asc}


def region_rank_routes(label, lanes, ok, lt, sc, K, half_life, gates,
                       coefs):
    """region_rank on one grid through both kernel routes: the wrapper
    (which must take the row route) and the warp route forced through its
    bare launch, each held against the plain version: npass, values and
    columns equal, apart from rows where the lazy gate sits within 1 ulp of
    min_pair_weight (counted and printed). Returns (max_abs_err, the
    outputs' buffers, the plain npass)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_select as ktk
    kw = dict(k=K, coefs=coefs, **gates)
    if ktk.kernel_route(K) != "row":
        raise AssertionError(f"region_rank K={K} does not take the row route")
    before = dict(ktk.REGION_ROUTE_LAUNCHES)
    vals, args, npass = ktk.region_rank(*lanes, ok, lt, *sc,
                                        half_life=half_life, **kw)
    if ktk.REGION_ROUTE_LAUNCHES["row"] != before["row"] + 1:
        raise AssertionError("region_rank's wrapper did not take the row "
                             "route")
    bufs = (torch.empty_like(vals), torch.empty_like(args),
            torch.empty_like(npass))
    lt_ptr = None if half_life is None else lt.data_ptr()
    ktk.launch_region_rank(lanes, ok, lt_ptr, torch.stack(sc), coefs,
                           tuple(gates.values()), half_life, *bufs,
                           kroute="warp")
    w_eff = lanes[0]
    if half_life is not None:
        w_eff = ktk.decay_exp2(lanes[0], lt, sc[2], half_life)
    ev, ea, en = ref.region_rank_ref(w_eff, *lanes[1:], ok, sc[0], sc[1],
                                     **kw)
    near = ((w_eff - gates["min_pair_weight"]).abs()
            <= 2.0 ** -23 * 0.25).any(1)
    err = 0.0
    for kroute, (v, a, n) in (("row", (vals, args, npass)), ("warp", bufs)):
        same = (n == en) & (v == ev).all(1) & (a == ea).all(1)
        n_flip_rows = int((~same).sum())
        if n_flip_rows != int((~same & near).sum()):
            raise AssertionError(f"region_rank ({kroute} route, {label}) "
                                 f"differs from the plain version away from "
                                 f"the min_pair_weight boundary")
        fin = (v > -torch.inf) & (ev > -torch.inf) & same[:, None]
        e = float((v[fin] - ev[fin]).abs().max()) if bool(fin.any()) else 0.0
        err = max(err, e)
        log(f"  region_rank {kroute} route, {label}, half_life={half_life}: "
            f"max_abs_err={e!r}, rows differing (gate within 1 ulp of "
            f"min_pair_weight)={n_flip_rows} of {v.shape[0]}")
    return err, bufs, en


def time_region_rank_routes(lanes, ok, lt, sc, half_life, gates, coefs,
                            bufs):
    """Each route's bare launch on one grid, timed: {route: ms}."""
    import torch
    from repro_torch.kernels import topk_select as ktk
    scalars = torch.stack(sc)
    lt_ptr = None if half_life is None else lt.data_ptr()
    return {kroute: time_ms(lambda: ktk.launch_region_rank(
        lanes, ok, lt_ptr, scalars, coefs, tuple(gates.values()), half_life,
        *bufs, kroute=kroute)) for kroute in ("row", "warp")}


def region_rank_bound(ok, w_a, npass, K: int, min_src_weight: float,
                      lazy: bool):
    """region_rank's bound on one grid, from the bytes this data needs:
    the base gate byte of each slot of a row whose source passes
    min_src_weight; the pair's weight and count (and its i32 last_tick
    under the lazy policy) where the base gate and the source pass; the dst
    marginals' weight and count where every gate passes; per row its
    source weight, its source count where a slot passes, K values, K
    columns and npass written. Operations: one score (SCORE_OPS_PER_SLOT)
    a passing slot."""
    R, W = ok.shape
    src = w_a >= min_src_weight
    n_open = int((ok & src[:, None]).sum())
    n_pass = int(npass.sum())
    n_bytes = (int(src.sum()) * W + n_open * (12 if lazy else 8)
               + n_pass * 8 + R * 4 + int((npass > 0).sum()) * 4
               + R * (K * 8 + 4))
    return bound(n_bytes, n_pass * SCORE_OPS_PER_SLOT)


def sass_count(stem: str, kernel: str):
    """Static SASS instructions of the entry functions of csrc/<stem>.cu
    whose names contain ``kernel`` (``cuobjdump -sass`` of the built
    library): {function: count}, or None without cuobjdump."""
    import re
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    lib = build.library_path(build.CSRC / f"{stem}.cu")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                out[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            out[name] += 1
    return out


def check_region_rank(R: int, W: int, K: int, dev, floor):
    """region_rank's two routes with and without in-kernel decay against
    the plain version on a synthetic grid (72% of slots pass), both timed
    by their bare launches against the bytes this grid needs
    (:func:`region_rank_bound`), against the yardstick of 17 B a slot
    (21 B under the lazy policy) that every slot would need were it all
    read, and against the score floor times the slots scored; fails unless
    the row route is the faster. Prints each kernel's ptxas lines and
    static SASS count."""
    import numpy as np
    import torch
    from repro_torch.core.ranking import RankConfig
    from repro_torch.kernels import ref
    from repro_torch.kernels.topk_select import region_rank
    rc = RankConfig()
    gates = dict(min_pair_weight=rc.min_pair_weight,
                 min_src_weight=rc.min_src_weight,
                 min_pair_count=rc.min_pair_count)
    rng = np.random.default_rng(SEED + 3)
    mk = lambda *s: torch.from_numpy(rng.random(s, dtype=np.float32)).to(dev)
    w_ab, c_ab = mk(R, W) * 5, torch.floor(mk(R, W) * 20)
    w_a, w_b = mk(R) * 50, mk(R, W) * 50
    c_a = torch.floor(mk(R) * 100) + 20
    c_b = torch.maximum(c_ab, torch.floor(mk(R, W) * 100))
    lanes = (w_ab, c_ab, w_a, w_b, c_a, c_b)
    ok = torch.from_numpy(rng.random((R, W)) < 0.8).to(dev)
    lt = torch.from_numpy(rng.integers(0, 17, (R, W)).astype(np.int32)).to(dev)
    sc = [torch.tensor(x, dtype=torch.float32, device=dev)
          for x in (float(R * W) * 2.0, float(R * W) * 4.0, 17.0)]
    kw = dict(k=K, coefs=rc.coefs, **gates)
    err, ms, bnd, yard = 0.0, {}, {}, {}
    for half_life in (None, 36.0):
        e, bufs, en = region_rank_routes("synthetic grid", lanes, ok, lt, sc,
                                         K, half_life, gates, rc.coefs)
        err = max(err, e)
        ms[half_life] = time_region_rank_routes(lanes, ok, lt, sc, half_life,
                                                gates, rc.coefs, bufs)
        lazy = half_life is not None
        bnd[half_life] = (int(en.sum()), *region_rank_bound(
            ok, w_a, en, K, gates["min_src_weight"], lazy))
        yard[half_life] = bound(R * W * (21 if lazy else 17)
                                + R * (8 + K * 8 + 4), 0)[0]
    for half_life in (None, 36.0):
        n_pass, bm, b_by = bnd[half_life]
        ym = yard[half_life]
        fm = floor_ms(floor, n_pass)
        log(f"  region_rank synthetic grid ({R}x{W}, K={K}), half_life="
            f"{half_life}: {n_pass} slots pass "
            f"({100 * n_pass / (R * W):.2f}%); bound {bm!r} ms ({b_by}), "
            f"yardstick at every slot's {21 if half_life else 17} B "
            f"{ym!r} ms, score floor x {n_pass} scored {fm!r} ms")
        for kroute in ("row", "warp"):
            t = ms[half_life][kroute]
            log(f"  region_rank {kroute} route, synthetic grid, "
                f"half_life={half_life}: {t!r} ms, {100 * bm / t:.2f}% of "
                f"bound, {100 * ym / t:.2f}% of the yardstick, "
                f"{100 * fm / t:.2f}% of the score floor")
    _, b_ms, b_by = bnd[None]
    _, lazy_b_ms, _ = bnd[36.0]
    if not ms[None]["row"] < ms[None]["warp"]:
        raise AssertionError(f"region_rank: the row route ({ms[None]['row']} "
                             f"ms) is not faster than the warp route "
                             f"({ms[None]['warp']} ms)")
    log(f"  region_rank synthetic grid: row route "
        f"{ms[None]['warp'] / ms[None]['row']:.2f}x faster than the warp "
        f"route")
    for stem, entry in (("row", "region_rank_row_kernel"),
                        ("warp", "region_rank_kernel")):
        for line in ptxas_report("region_rank", entry):
            log(f"    ptxas ({stem} route): {line}")
    # the engine's instances (W 128, K 8)
    for what, stem, kernel in (
            ("row route", "region_rank", "region_rank_row_kernelILi4ELi8E"),
            ("warp route", "region_rank", "region_rank_kernelILi4E")):
        counts = sass_count(stem, kernel)
        n = "not measured" if counts is None else sum(counts.values())
        log(f"    SASS instructions, static ({what}): {n}")
    wrapper_ms = time_ms(lambda: region_rank(*lanes, ok, lt, *sc, **kw))
    plain_ms = time_ms(lambda: ref.region_rank_ref(*lanes, ok, sc[0], sc[1],
                                                   **kw))
    return dict(max_abs_err=err, ms=ms[None]["row"], wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, kernel_route="row",
                yardstick_bound_ms=yard[None], slots_pass=bnd[None][0],
                warp_route_ms=ms[None]["warp"], lazy_ms=ms[36.0]["row"],
                lazy_warp_route_ms=ms[36.0]["warp"], lazy_bound_ms=lazy_b_ms,
                lazy_yardstick_bound_ms=yard[36.0],
                lazy_slots_pass=bnd[36.0][0],
                score_floor_ms=floor_ms(floor, bnd[None][0]))


def check_region_rank_path_grid(call, tick, floor, label=None):
    """region_rank's two routes on the grid the region path's rank cycle of
    ``tick`` passed it (an untimed replay; ``label`` names another grid):
    the live and passing slots, each route against the plain version, both
    timed against the bytes that data needs (:func:`region_rank_bound`)
    and against a yardstick that reads the base gate byte of every slot,
    16 B for each live slot, and each row's two marginals, K values, K
    columns and npass."""
    a, kw = call
    w_ab, c_ab, w_a, w_b, c_a, c_b, ok, total_w, total_c = a
    if kw.get("decay_cfg") is not None:
        raise AssertionError("the region cell runs the sweep policy")
    R, W = w_ab.shape
    K = kw["k"]
    gates = dict(min_pair_weight=kw["min_pair_weight"],
                 min_src_weight=kw["min_src_weight"],
                 min_pair_count=kw["min_pair_count"])
    lanes = (w_ab, c_ab, w_a, w_b, c_a, c_b)
    sc = [total_w, total_c, total_w.new_zeros(())]
    label = label or f"region path grid, tick {tick}"
    err, bufs, en = region_rank_routes(label, lanes, ok, None, sc, K, None,
                                       gates, kw["coefs"])
    ms = time_region_rank_routes(lanes, ok, None, sc, None, gates,
                                 kw["coefs"], bufs)
    n_ok, n_pass = int(ok.sum()), int(en.sum())
    rows_free = int((~ok.any(1)).sum())
    src_rows = int((w_a >= gates["min_src_weight"]).sum())
    b_ms, b_by = region_rank_bound(ok, w_a, en, K, gates["min_src_weight"],
                                   False)
    y_ms = bound(R * W + n_ok * 16 + R * (8 + K * 8 + 4), 0)[0]
    f_ms = floor_ms(floor, n_pass)
    log(f"  region_rank {label}: {R}x{W}, K={K}, {n_ok} slots live "
        f"({100 * n_ok / (R * W):.3f}%), {n_pass} pass "
        f"({100 * n_pass / (R * W):.3f}%), {rows_free} rows with no live "
        f"slot, {src_rows} rows whose source passes; bound {b_ms!r} ms "
        f"({b_by}), yardstick (every gate byte, 16 B a live slot) "
        f"{y_ms!r} ms, score floor x {n_pass} scored {f_ms!r} ms")
    for kroute in ("row", "warp"):
        log(f"  region_rank {kroute} route, {label}: {ms[kroute]!r} ms, "
            f"{100 * b_ms / ms[kroute]:.2f}% of that data's bound, "
            f"{100 * y_ms / ms[kroute]:.2f}% of the yardstick")
    return dict(rows=R, width=W, k=K, slots_live=n_ok, slots_pass=n_pass,
                rows_without_live_slot=rows_free, rows_source_pass=src_rows,
                row_ms=ms["row"], warp_ms=ms["warp"], bound_ms=b_ms,
                bound_by=b_by, yardstick_bound_ms=y_ms, score_floor_ms=f_ms,
                max_abs_err=err)


def chain_find_sweep(kh, kl, batch, kroute, out):
    """chain_find's bare launch on one batch at each rows-a-warp the
    kernel takes, on ``kroute``, each result held exactly against the
    wrapper's: {rows a warp: ms}."""
    import torch
    from repro_torch.kernels.region_probe import chain_find, launch_chain_find
    exp = chain_find(kh, kl, *batch)
    ms = {}
    for rpw in (1, 2, 4, 8, 16, 32):
        launch_chain_find(kh, kl, *batch, out, kroute=kroute, rpw=rpw)
        if not torch.equal(out, exp):
            raise AssertionError(f"chain_find at {rpw} rows a warp differs")
        ms[rpw] = time_ms(lambda: launch_chain_find(
            kh, kl, *batch, out, kroute=kroute, rpw=rpw))
    return ms


def check_chain_find(table, batch, dev):
    """chain_find on the region store and largest pair batch of the
    phase-4 region run's ticks, held exactly against the plain version;
    the batch's active share and the 32-row groups and the groups of a
    warp's rows without an active row, its time and its share of the
    bound, the other route's time forced through the bare launch, and the
    time at each rows-a-warp."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import region_probe as kprobe
    from repro_torch.kernels.region_probe import chain_find, launch_chain_find
    R, W = table.n_regions, table.width
    kh, kl = table.key_hi.view(R, W), table.key_lo.view(R, W)
    regs, dh, dl, active = batch
    B, MC = regs.shape
    by_route = dict(kprobe.ROUTE_LAUNCHES)
    got = chain_find(kh, kl, regs, dh, dl, active)
    kroute = kprobe.kernel_route(kh, kl)
    if kprobe.ROUTE_LAUNCHES[kroute] != by_route[kroute] + 1:
        raise AssertionError(f"chain_find did not take the {kroute} route")
    exp = ref.chain_find_ref(kh, kl, regs, dh, dl, active)
    if not torch.equal(got, exp):
        raise AssertionError("chain_find differs from the plain version")
    # what this data needs: an active row reads its chain's region ids up
    # to the hit (all MC on a miss), its dst key, and one region row of
    # keys per region visited; every row reads its active flag and writes
    # its result.
    hit = got >= 0
    hit_depth = torch.argmax((regs == torch.div(
        got, W, rounding_mode="floor")[:, None]).to(torch.uint8), 1)
    ids_read = torch.where(hit, hit_depth + 1, MC)
    visited = torch.where(hit, (regs >= 0).cumsum(1).gather(
        1, hit_depth[:, None])[:, 0], (regs >= 0).sum(1))
    n_active = int(active.sum())
    n_ids = int(torch.where(active, ids_read, 0).sum())
    n_visits = int(torch.where(active, visited, 0).sum())
    target = kprobe.target_warps(dev, W, kroute == "vec")
    rpw = kprobe.rows_per_warp(B, target)
    idle = {}
    for g in sorted({32, rpw}):
        groups = -(-B // g)
        pad = torch.zeros(groups * g, dtype=torch.bool, device=dev)
        pad[:B] = active
        idle[g] = (int((~pad.view(groups, g).any(1)).sum()), groups)
    log(f"  chain_find: {B} rows ({n_active} active, "
        f"{100 * n_active / B:.3f}%; {int(hit.sum())} hits), "
        + ", ".join(f"{n} of {groups} {g}-row groups"
                    for g, (n, groups) in idle.items())
        + f" with no active row, {n_ids} region ids "
        f"and {n_visits} region rows read, MC={MC}, W={W}, {kroute} route, "
        f"{rpw} rows a warp (target {target} warps: {kprobe.WAVES} waves "
        f"of {target // kprobe.WAVES} resident)")
    out = torch.empty_like(got)
    ms = time_ms(lambda: launch_chain_find(kh, kl, regs, dh, dl, active, out))
    other = "scalar" if kroute == "vec" else None
    other_ms = None
    if other:
        launch_chain_find(kh, kl, regs, dh, dl, active, out, kroute=other)
        if not torch.equal(out, exp):
            raise AssertionError(f"chain_find's {other} route differs from "
                                 f"the plain version")
        other_ms = time_ms(lambda: launch_chain_find(
            kh, kl, regs, dh, dl, active, out, kroute=other))
    wrapper_ms = time_ms(lambda: chain_find(kh, kl, regs, dh, dl, active))
    plain_ms = time_ms(lambda: ref.chain_find_ref(kh, kl, regs, dh, dl,
                                                  active))
    b_ms, b_by = bound(n_ids * 4 + n_active * 8 + B * (1 + 4)
                       + n_visits * W * 8, n_visits * W * 2)
    log(f"  chain_find: {ms!r} ms, {100 * b_ms / ms:.2f}% of bound "
        f"({b_ms!r} ms, {b_by}), {B / ms / 1e3:.1f} rows/us")
    if other:
        log(f"  chain_find {other} route forced, same batch: {other_ms!r} "
            f"ms, {100 * b_ms / other_ms:.2f}% of bound; {kroute} route "
            f"{other_ms / ms:.3f}x faster")
    sweep = chain_find_sweep(kh, kl, batch, kroute, out)
    log(f"  chain_find by rows a warp, {B}-row batch: {sweep}")
    for line in ptxas_report("chain_find", "chain_find_kernel"):
        log(f"    ptxas: {line}")
    return dict(max_abs_err=0.0, ms=ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, kernel_route=kroute, rows_per_warp=rpw,
                other_route_ms=other_ms, ms_by_rows_per_warp=sweep)


def check_chain_find_depth(table, batch) -> None:
    """``chain_find_depth`` (``chain_find.cu`` on a one-column chain, every
    row active) on the first chain column of a region pair batch, the rows
    that have a region there, held exactly against its plain version on
    the CPU."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.kernels.region_probe import chain_find_depth
    R, W = table.n_regions, table.width
    regs, dh, dl, _ = batch
    rows = (regs[:, 0] >= 0).nonzero().squeeze(1)
    args = (table.key_hi.view(R, W), table.key_lo.view(R, W),
            regs[rows, 0].contiguous(), dh[rows].contiguous(),
            dl[rows].contiguous())
    before = tk.LAUNCHES["chain_find"]
    got = chain_find_depth(*args)
    if tk.LAUNCHES["chain_find"] != before + 1:
        raise AssertionError("chain_find_depth launched no kernel")
    exp = chain_find_depth(*(a.cpu() for a in args))
    if not torch.equal(got.cpu(), exp):
        raise AssertionError("chain_find_depth differs from the plain version")
    ms = time_ms(lambda: chain_find_depth(*args))
    log(f"  chain_find_depth on the batch's first chain column: "
        f"{len(rows)} rows, {int((exp < W).sum())} found in that region, "
        f"equal to the plain version on the CPU; wrapper {ms!r} ms")


def check_chain_find_batch(table, batch):
    """chain_find on another of the region run's batch sizes: held exactly
    against the plain version, its active share, rows a warp and time, and
    the time at each rows-a-warp."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import region_probe as kprobe
    R, W = table.n_regions, table.width
    kh, kl = table.key_hi.view(R, W), table.key_lo.view(R, W)
    regs, dh, dl, active = batch
    got = kprobe.chain_find(kh, kl, regs, dh, dl, active)
    if not torch.equal(got, ref.chain_find_ref(kh, kl, regs, dh, dl,
                                               active)):
        raise AssertionError("chain_find differs from the plain version")
    B, n_active = regs.shape[0], int(active.sum())
    kroute = kprobe.kernel_route(kh, kl)
    rpw = kprobe.rows_per_warp(B, kprobe.target_warps(
        regs.device, W, kroute == "vec"))
    out = torch.empty_like(got)
    ms = time_ms(lambda: kprobe.launch_chain_find(kh, kl, regs, dh, dl,
                                                  active, out))
    log(f"  chain_find, a {B}-row batch ({n_active} active, "
        f"{100 * n_active / B:.3f}%), {rpw} rows a warp: {ms!r} ms")
    sweep = chain_find_sweep(kh, kl, batch, kroute, out)
    log(f"  chain_find by rows a warp, {B}-row batch: {sweep}")
    return dict(rows=B, active=n_active, rows_per_warp=rpw, ms=ms,
                ms_by_rows_per_warp=sweep)


def topk_bound(R: int, L: int, K: int):
    """bucket_topk's bound: the grid read once, K values and K columns
    written per row; its K rounds of L compares as operations."""
    return bound(R * L * 4 + R * K * 8, R * L * K)


def bucket_topk_routes(label: str, grid, K: int):
    """bucket_topk on ``grid`` through both kernel routes: the wrapper
    (which must take the row route) and the warp route forced through its
    bare launch. Each is held against the plain version (values, and every
    column with its sentinels) and timed by its bare launch. Returns
    {route: ms}."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_select as ktk
    R, L = grid.shape
    if ktk.kernel_route(K) != "row":
        raise AssertionError(f"bucket_topk K={K} does not take the row route")
    ev, ea = ref.bucket_topk_ref(grid, K)
    before = dict(ktk.ROUTE_LAUNCHES)
    vals, args = ktk.bucket_topk(grid, K)
    if ktk.ROUTE_LAUNCHES["row"] != before["row"] + 1:
        raise AssertionError("bucket_topk's wrapper did not take the row "
                             "route")
    bv, ba = torch.empty_like(vals), torch.empty_like(args)
    ktk.launch_bucket_topk(grid, bv, ba, "warp")
    for kroute, (v, a) in (("row", (vals, args)), ("warp", (bv, ba))):
        if not (torch.equal(v, ev) and torch.equal(a, ea)):
            raise AssertionError(f"bucket_topk ({kroute} route, {label}) "
                                 f"differs from the plain version")
    del vals, args
    b_ms, b_by = topk_bound(R, L, K)
    ms = {}
    for kroute in ("row", "warp"):
        ms[kroute] = time_ms(
            lambda: ktk.launch_bucket_topk(grid, bv, ba, kroute))
        log(f"  bucket_topk {kroute} route, {label} ({R}x{L}, K={K}): "
            f"equal to the plain version (values, columns, sentinels), "
            f"{ms[kroute]!r} ms, {100 * b_ms / ms[kroute]:.2f}% of bound "
            f"({b_ms!r} ms, {b_by}), {R / ms[kroute] / 1e3:.1f} rows/us")
    log(f"  bucket_topk {label}: the wrapper took the row route; row "
        f"route {ms['warp'] / ms['row']:.2f}x faster than the warp route")
    return ms


def check_bucket_topk(R: int, L: int, K: int, dev):
    """bucket_topk's two routes against the plain version on a synthetic
    grid (half -inf, many ties), with torch.topk timed beside them as the
    library yardstick; fails unless the row route is the faster."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.topk_select import bucket_topk
    rng = np.random.default_rng(SEED + 2)
    g = np.floor(rng.random((R, L), dtype=np.float32) * 64)     # many ties
    g[rng.random((R, L)) < 0.5] = -np.inf
    grid = torch.from_numpy(g).to(dev)
    del g
    ms = bucket_topk_routes("synthetic grid", grid, K)
    for stem, entry in (("row", "bucket_topk_row_kernel"),
                        ("warp", "bucket_topk_kernel")):
        for line in ptxas_report("bucket_topk", entry):
            log(f"    ptxas ({stem} route): {line}")
    if not ms["row"] < ms["warp"]:
        raise AssertionError(f"bucket_topk: the row route ({ms['row']} ms) "
                             f"is not faster than the warp route "
                             f"({ms['warp']} ms)")
    wrapper_ms = time_ms(lambda: bucket_topk(grid, K))
    plain_ms = time_ms(lambda: ref.bucket_topk_ref(grid, K))
    library_ms = time_ms(lambda: torch.topk(grid, K, dim=1))
    b_ms, b_by = topk_bound(R, L, K)
    return dict(max_abs_err=0.0, ms=ms["row"], wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                kernel_route="row", warp_route_ms=ms["warp"])


def check_bucket_topk_path_grid(label: str, grid, K: int):
    """bucket_topk's two routes on a grid a main path passed it (from an
    untimed replay): rows holding a finite value, each route against the
    plain version, both timed; ``torch.topk`` beside them."""
    import torch
    R, L = grid.shape
    n_live = int(torch.isfinite(grid).any(1).sum())
    log(f"  bucket_topk {label}: {R}x{L}, K={K}, {n_live} rows hold a "
        f"finite value ({100 * n_live / max(R, 1):.3f}%)")
    ms = bucket_topk_routes(label, grid, K)
    library_ms = time_ms(lambda: torch.topk(grid, K, dim=1))
    b_ms, _ = topk_bound(R, L, K)
    return dict(rows=R, width=L, rows_finite=n_live, row_ms=ms["row"],
                warp_ms=ms["warp"], bound_ms=b_ms, library_ms=library_ms)


ED_OPS_PER_CELL = 7   # f32 adds and mins per DP cell, the bound's yardstick
ED_FC_F32 = 1.3       # a first-character cost only the f32 route takes


def check_edit_distance(batch, fc: float):
    """edit_distance on the largest pair batch of the spelling job, on both
    kernel routes with the same pairs: the job's cost ``fc`` (half-unit
    route) and ``ED_FC_F32`` (f32 route), each held bit for bit against
    the plain version and timed by its bare launch. The bound counts the
    cells these pairs fill (a_len x b_len each) at ED_OPS_PER_CELL f32
    operations, on both routes. Fails unless the half-unit route is
    faster."""
    import torch
    from repro_torch.kernels import edit_distance as ked
    from repro_torch.kernels import ref
    ac, al, bc, bl = batch
    B, L = ac.shape
    cells = int((al.long() * bl.long()).sum())
    b_ms, b_by = bound(B * (2 * L + 8 + 4), cells * ED_OPS_PER_CELL)
    log(f"  edit_distance: {B} pairs, L={L}, {cells} DP cells "
        f"({cells / max(B, 1):.1f} a pair), bound {b_ms} ms ({b_by})")
    if ked.kernel_route(fc) != "half":
        raise AssertionError(f"the job's first_char_cost {fc} does not take "
                             f"the half-unit route")
    out = torch.empty((B,), dtype=torch.float32, device=ac.device)
    by_route = {}
    for cost in (fc, ED_FC_F32):
        kroute = ked.kernel_route(cost)
        before = dict(ked.ROUTE_LAUNCHES)
        got = ked.edit_distance(ac, al, bc, bl, first_char_cost=cost)
        n_route = ked.ROUTE_LAUNCHES[kroute] - before[kroute]
        if n_route != 1:
            raise AssertionError(f"edit_distance fc {cost}: {n_route} "
                                 f"launches on the {kroute} route")
        exp = ref.edit_distance_ref(ac, al, bc, bl, first_char_cost=cost)
        if not torch.equal(got.view(torch.int32), exp.view(torch.int32)):
            raise AssertionError(f"edit_distance ({kroute} route, fc "
                                 f"{cost}) differs from the plain version")
        ms = time_ms(lambda: ked.launch(ac, al, bc, bl, out, cost))
        by_route[kroute] = dict(fc=cost, ms=ms,
                                max_abs_err=float((got - exp).abs().max()))
        del got, exp
        log(f"  edit_distance {kroute} route (first_char_cost={cost}): "
            f"{n_route} launch on it, bit-equal to the plain version, "
            f"{ms} ms, "
            f"{100 * b_ms / ms:.2f}% of bound, {cells / ms / 1e3:.1f} "
            f"cells/us")
        for line in ptxas_report("edit_distance", f"ed_{kroute}_kernel"):
            log(f"    ptxas: {line}")
    half, f32 = by_route["half"], by_route["f32"]
    if not half["ms"] < f32["ms"]:
        raise AssertionError(f"edit_distance: the half-unit route "
                             f"({half['ms']} ms) is not faster than the f32 "
                             f"route ({f32['ms']} ms)")
    log(f"  edit_distance: half-unit route {f32['ms'] / half['ms']:.2f}x "
        f"faster than the f32 route on the same pairs")
    wrapper_ms = time_ms(lambda: ked.edit_distance(ac, al, bc, bl,
                                                   first_char_cost=fc))
    plain_ms = time_ms(lambda: ref.edit_distance_ref(ac, al, bc, bl, fc),
                       reps=3, warmup=1)
    return dict(max_abs_err=half["max_abs_err"], ms=half["ms"],
                wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, kernel_route="half",
                f32_route_ms=f32["ms"],
                f32_route_max_abs_err=f32["max_abs_err"])


# ---------------------------------------------------------------------------
# Phases 3-5: the engine.
# ---------------------------------------------------------------------------

def engine_stream_config():
    from repro_torch.data.stream import StreamConfig
    return StreamConfig(vocab_size=256, n_users=150, queries_per_tick=128,
                        tweets_per_tick=16, tweet_words=4, tweet_grams=6)


def small_parity(dev, layout="hash", lazy=False):
    """The engine on the card against the engine on the CPU, on the
    ``tests/test_engine.py`` stream and configuration (9 ticks)."""
    import numpy as np
    from repro_torch.core.decay import DecayConfig
    from repro_torch.core.engine import EngineConfig, SearchAssistanceEngine
    from repro_torch.data.stream import SyntheticStream
    kw = dict(decay=DecayConfig(policy="lazy"), prune_every=4) if lazy else {}
    cfg = EngineConfig(query_capacity=1 << 12, cooc_capacity=1 << 14,
                       session_capacity=1 << 11, session_window=4,
                       decay_every=4, rank_every=8, cooc_layout=layout, **kw)
    engines = []
    for device in (dev, "cpu"):
        stream = SyntheticStream(engine_stream_config(), seed=11)
        eng = SearchAssistanceEngine(cfg, device=device)
        for t in range(9):
            eng.step(*stream.gen_tick(t))
        engines.append(eng)
    a, b = (e.state_arrays() for e in engines)
    n_exact = 0
    for i in range(len(a)):
        x, y = a[f"leaf_{i}"], b[f"leaf_{i}"]
        if x.dtype == np.float32:
            np.testing.assert_allclose(x, y, rtol=2e-3, err_msg=f"leaf_{i}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"leaf_{i}")
        n_exact += x.tobytes() == y.tobytes()
    held = suggestions_contract(engines[0].suggestions,
                                engines[1].suggestions, "card vs CPU")
    log(f"  {layout} layout, {'lazy' if lazy else 'sweep'} policy, card vs "
        f"CPU: {n_exact}/{len(a)} leaves bit-identical, keys and "
        f"slots exact, {held}")
    return engines


def suggestions_contract(sa, sb, label: str) -> str:
    """Same sources; top-3 scores within rtol 5e-3, atol 1e-4; top-3
    identities agree for at least 95% of sources."""
    import numpy as np
    if set(sa) != set(sb) or not sa:
        raise AssertionError(f"{label}: suggestion sources differ")
    agree = 0
    for f in sa:
        np.testing.assert_allclose([s for _, s in sa[f][:3]],
                                   [s for _, s in sb[f][:3]],
                                   rtol=5e-3, atol=1e-4, err_msg=label)
        agree += [d for d, _ in sa[f][:3]] == [d for d, _ in sb[f][:3]]
    if agree < 0.95 * len(sa):
        raise AssertionError(f"{label}: top-3 agreement {agree}/{len(sa)}")
    return f"{len(sa)} sources, top-3 identity agreement {agree}/{len(sa)}"


PLANTED = [("justin bieber", 900.0), ("justin beiber", 5.0),
           ("justin biber", 3.0), ("hadoop", 800.0), ("hadop", 4.0),
           ("lady gaga", 700.0), ("lady gagga", 6.0), ("world cup", 600.0),
           ("wrold cup", 2.0)]
TRUE_FORM = {"justin beiber": "justin bieber", "justin biber": "justin bieber",
             "hadop": "hadoop", "lady gagga": "lady gaga",
             "wrold cup": "world cup"}


def small_spelling(dev, engine) -> None:
    """The spelling job on the card against the CPU over a small engine's
    live qstore plus planted misspellings, and a count-min sketch on the
    card against the CPU (integer weights, so sums are exact)."""
    import numpy as np
    import torch
    from repro_torch.core import sketch as tsk
    from repro_torch.core.hashing import fingerprint, from_np_u32, join_fp
    from repro_torch.core.spelling import spelling_cycle
    from repro_torch.core.stores import export_live
    from repro_torch.data.stream import SyntheticStream
    exp = export_live(engine.state.qstore)
    tok = SyntheticStream(engine_stream_config(), seed=11).tok
    fps = join_fp(exp["key_hi"], exp["key_lo"])
    texts = [tok.text(int(f)) for f in fps] + [t for t, _ in PLANTED]
    fps = np.concatenate([fps, np.array([fingerprint(t) for t, _ in PLANTED],
                                        np.uint64)])
    weights = np.concatenate([exp["weight"],
                              np.float32([w for _, w in PLANTED])])
    got = spelling_cycle(fps, texts, weights, device=dev)
    cpu = spelling_cycle(fps, texts, weights, device="cpu")
    if list(got.items()) != list(cpu.items()) or not got:
        raise AssertionError("spelling job differs between card and CPU")
    fixed = sum(got.get(fingerprint(v), (None,))[0] == fingerprint(t)
                for v, t in TRUE_FORM.items())
    rng = np.random.default_rng(SEED + 5)
    hi = rng.integers(0, 2**32, 1 << 16, dtype=np.uint32)
    lo = rng.integers(0, 2**32, 1 << 16, dtype=np.uint32)
    w = np.floor(rng.random(1 << 16) * 8).astype(np.float32)
    valid = rng.random(1 << 16) < 0.9
    res = []
    for d in (dev, "cpu"):
        kh, kl = from_np_u32(hi, d), from_np_u32(lo, d)
        sk = tsk.sketch_update(tsk.make_sketch(4, 1 << 12, device=d), kh, kl,
                               torch.from_numpy(w).to(d),
                               torch.from_numpy(valid).to(d))
        sk = tsk.sketch_decay(sk, 0.5)
        res.append((sk.table.cpu(), tsk.sketch_query(sk, kh, kl).cpu()))
    if not all(torch.equal(x, y) for x, y in zip(*res)):
        raise AssertionError("count-min sketch differs between card and CPU")
    log(f"  spelling job, card vs CPU: {len(fps)} sources ({len(PLANTED)} "
        f"planted), {len(got)} corrections, same items in the same order; "
        f"planted misspellings corrected {fixed}/{len(TRUE_FORM)}; "
        f"count-min sketch 4 x 4096 over {1 << 16} keys: table and "
        f"queries equal")


def deployment_config(layout="hash"):
    from repro_torch.core.engine import EngineConfig
    from repro_torch.data.stream import StreamConfig
    return (EngineConfig(query_capacity=1 << 22, cooc_capacity=1 << 24,
                         session_capacity=1 << 20, decay_every=4,
                         rank_every=8, cooc_layout=layout),
            StreamConfig(vocab_size=65536, n_users=200000,
                         queries_per_tick=16384, tweets_per_tick=2048))


def main_path(dev, ticks, layout):
    """Drive SearchAssistanceEngine.step over the pre-generated ticks with
    the launch counts set to 0 just before and read just after."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core import engine as te
    cfg, scfg = deployment_config(layout)
    eng = te.SearchAssistanceEngine(cfg, device=dev)
    cycle_ms = {"decay": [], "rank": []}

    def timed(kind, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            cycle_ms[kind].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    decay_cycle = te.decay_cycle
    te.decay_cycle = timed("decay", decay_cycle)
    eng.run_rank_cycle = timed("rank", eng.run_rank_cycle)
    step_ms, results = [], []
    torch.cuda.synchronize()
    tk.reset_launches()
    try:
        for events, tweets in ticks:
            t0 = time.perf_counter()
            res = eng.step(events, tweets)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if res:
                results.append(res)
                log(f"  {layout} tick {res['tick']}: rank cycle -> "
                    f"{res['n_suggest']} "
                    f"queries with suggestions ({res['n_rows']} rows, "
                    f"{res['n_overflow']} overflow)")
    finally:
        te.decay_cycle = decay_cycle
    launches = dict(tk.LAUNCHES)
    return eng, step_ms, cycle_ms, results, launches


# The engine's kernels, each named in its CUDA kernels' function names.
ENGINE_KERNELS = ("decay_prune_multi", "score_gate", "bucket_topk",
                  "chain_find", "region_rank")


def _profiled(label, fn) -> None:
    """Run ``fn`` under torch.profiler: wall time, summed device kernel
    time, device busy share, and the kernels that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        log(f"  profiled {label}: no device time recorded (busy share not "
            f"measured)")
        return
    busy_ms = sum(r[1] for r in rows)
    log(f"  profiled {label}: wall {wall_ms:.3f} ms, device kernels "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% busy), "
        f"{sum(r[2] for r in rows)} kernel launches")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"    {ms:9.3f} ms  x{n:<5d} {key[:90]}")
    ours = {name: [0.0, 0] for name in ENGINE_KERNELS}
    for key, ms, n in rows:
        for name in ENGINE_KERNELS:
            if name in key:
                ours[name][0] += ms
                ours[name][1] += n
    if any(n for _, n in ours.values()):
        log(f"  profiled {label}, engine kernels: " + ", ".join(
            f"{name} {ms!r} ms x{n}" for name, (ms, n) in ours.items()
            if n))


def profile_tick(eng, tick, layout) -> None:
    """One more ingest-only tick, then one rank cycle, under the profiler."""
    _profiled(f"{layout} ingest tick", lambda: eng.step(*tick))
    _profiled(f"{layout} rank cycle", eng.run_rank_cycle)


def state_bits_equal(a, b) -> bool:
    """``state_arrays()`` of two engines, compared byte for byte."""
    sa, sb = a.state_arrays(), b.state_arrays()
    return sa.keys() == sb.keys() and all(
        sa[k].dtype == sb[k].dtype and sa[k].tobytes() == sb[k].tobytes()
        for k in sa)


def run_main_path(dev, ticks, extra_tick, scfg, layout, stream):
    """Phase 4 for one cooc layout: drive the path, check and report it.
    Returns the launch counts of the driven path and a copy of its query
    store as the timed ticks left it."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.kernels import topk_select as ktk
    cfg, _ = deployment_config(layout)
    torch.cuda.reset_peak_memory_stats()
    by_route = dict(ktk.ROUTE_LAUNCHES)
    rr_route = dict(ktk.REGION_ROUTE_LAUNCHES)
    sg_route = dict(ktk.SCORE_ROUTE_LAUNCHES)
    eng, step_ms, cycle_ms, results, launches = main_path(dev, ticks, layout)
    by_route = {r: n - by_route[r] for r, n in ktk.ROUTE_LAUNCHES.items()}
    rr_route = {r: n - rr_route[r]
                for r, n in ktk.REGION_ROUTE_LAUNCHES.items()}
    sg_route = {r: n - sg_route[r]
                for r, n in ktk.SCORE_ROUTE_LAUNCHES.items()}
    st = eng.state
    q = st.qstore
    qstore = q._replace(key_hi=q.key_hi.clone(), key_lo=q.key_lo.clone(),
                        lanes={k: v.clone() for k, v in q.lanes.items()})
    drops = {n: int(getattr(st, n).n_dropped)
             for n in ("qstore", "cooc", "sessions")}
    Q, C = cfg.query_capacity, cfg.cooc_capacity
    live_q, live_c = int(st.qstore.live_count()), int(st.cooc.live_count())
    log(f"  {layout} launches on the main path: {launches}; bucket_topk "
        f"by route {by_route}; region_rank by route {rr_route}; score_gate "
        f"by route {sg_route}")
    if sg_route["vec"] != launches["score_gate"]:
        raise AssertionError(f"{layout} score_gate launches by route: "
                             f"{sg_route}")
    if by_route["row"] != launches["bucket_topk"]:
        raise AssertionError(f"{layout} bucket_topk launches by route: "
                             f"{by_route}")
    if rr_route["row"] != launches["region_rank"]:
        raise AssertionError(f"{layout} region_rank launches by route: "
                             f"{rr_route}")
    log(f"  {layout} n_dropped {drops}; live qstore {live_q}/{Q}, "
        f"cooc {live_c}/{C}")
    if layout == "region":
        t = st.cooc
        held = torch.where(t.chain_region >= 0, t.region_fill[
            torch.clamp(t.chain_region, 0).long()], 0).sum(1)
        depth = torch.bincount((t.chain_region >= 0).sum(1),
                               minlength=t.max_chain + 1).tolist()
        room = t.width * t.max_chain
        n_full = int((held == room).sum())
        log(f"  region: W={t.width}, {t.n_regions} regions, "
            f"c_free_regions={int(t.free_regions())}; directory rows by "
            f"chain depth 0..{t.max_chain}: {depth}; full chains "
            f"({room} pairs): {n_full}; last maintenance "
            f"{eng.last_maintenance}")
    elif any(drops.values()):
        raise AssertionError(f"dropped updates at deployment scale: {drops}")
    if len(results) != 2 or results[-1]["n_suggest"] <= 0:
        raise AssertionError(f"{layout} rank cycles: {results}")
    missing = [n for n in tk.PATH_KERNELS[layout] if launches[n] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {layout} path: "
                             f"{missing}")
    if eng.n_decay_cycles != 4:
        raise AssertionError(f"decay cycles: {eng.n_decay_cycles}")
    ev_per_tick = scfg.queries_per_tick + scfg.tweets_per_tick
    plain = [m for i, m in enumerate(step_ms)
             if i % cfg.decay_every and i % cfg.rank_every]
    main = {
        "ms_per_tick_mean": statistics.mean(step_ms),
        "ms_per_tick_median": statistics.median(step_ms),
        "ms_per_ingest_only_tick_median": statistics.median(plain),
        "events_per_s": ev_per_tick * len(step_ms) / (sum(step_ms) / 1e3),
        "decay_cycle_ms": cycle_ms["decay"],
        "rank_cycle_ms": cycle_ms["rank"],
        "step_ms": step_ms,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    log(f"  {layout} main path: " + json.dumps(main))
    profile_tick(eng, extra_tick, layout)
    for i in range(5):
        q = stream.vocab[i]
        sugg = eng.suggest_fp(stream.tok.query_fp(q), k=4)
        log(f"  {layout} {q!r:24s} -> "
            f"{[(stream.tok.text(d), round(s, 3)) for d, s in sugg]}")
    return launches, qstore


def spelling_job(dev, qstore, tok, stats=None, times=None):
    """The serving loop's periodic spelling job: export the live queries,
    join their fingerprints, look up their texts, run the job. ``times``,
    if given, receives the host-clock ms of each step (the last synced)."""
    import torch
    from repro_torch.core.hashing import join_fp
    from repro_torch.core.spelling import SpellConfig, spelling_cycle
    from repro_torch.core.stores import export_live
    t0 = time.perf_counter()
    exp = export_live(qstore)
    t1 = time.perf_counter()
    fps = join_fp(exp["key_hi"], exp["key_lo"])
    texts = [tok.text(int(f)) for f in fps]
    t2 = time.perf_counter()
    corr = spelling_cycle(fps, texts, exp["weight"], SpellConfig(),
                          device=dev, stats=stats)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    if times is not None:
        times.update(export_ms=(t1 - t0) * 1e3, texts_ms=(t2 - t1) * 1e3,
                     spelling_cycle_ms=(t3 - t2) * 1e3)
    return fps, texts, exp["weight"], corr


def run_spelling(dev, qstore, stream):
    """Phase 4's spelling job over the hash path's 17-tick query store,
    with edit_distance's launch count set to 0 just before and read just
    after; then the host share of spelling_cycle (scan_order) timed alone
    and one more job under the profiler. Returns (its launch counts, the
    job's inputs and result)."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core.spelling import SpellConfig, scan_order
    from repro_torch.kernels import edit_distance as ked
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats, times = {}, {}
    by_route = dict(ked.ROUTE_LAUNCHES)
    tk.reset_launches()
    t0 = time.perf_counter()
    fps, texts, weights, corr = spelling_job(dev, qstore, stream.tok, stats,
                                             times)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(tk.LAUNCHES)
    by_route = {r: n - by_route[r] for r, n in ked.ROUTE_LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    missing = [n for n in tk.PATH_KERNELS["spelling"] if launches[n] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the spelling job: "
                             f"{missing}")
    if by_route["half"] != launches["edit_distance"]:
        raise AssertionError(f"the spelling job's edit_distance launches "
                             f"by route: {by_route}")
    if not corr:
        raise AssertionError("the spelling job emitted no correction")
    t0 = time.perf_counter()
    scan_order(texts, weights, SpellConfig())
    times["scan_order_ms"] = (time.perf_counter() - t0) * 1e3
    live = {int(f) for f in fps}
    planted = [(int(stream.fps[v]), int(stream.fps[t]))
               for v, t in stream.misspell_of.items()]
    planted_live = [(v, t) for v, t in planted if v in live]
    fixed = sum(corr.get(v, (None,))[0] == t for v, t in planted_live)
    row = {"sources": stats["sources"], "pairs_filtered": stats["pairs"],
           "blocks": stats["blocks"], "largest_batch": stats["largest_batch"],
           "edit_distance_launches": launches["edit_distance"],
           "edit_distance_route_launches": by_route,
           "wall_ms": wall_ms, **times, "corrections": len(corr),
           "peak_mem_gib": peak, "planted_variants": len(planted),
           "planted_variants_live": len(planted_live),
           "planted_variants_corrected": fixed}
    log("  spelling job: " + json.dumps(row))
    for v, t in planted_live[:4]:
        got = corr.get(v)
        log(f"    {stream.tok.text(v)!r} -> "
            f"{stream.tok.text(got[0]) if got else None!r} "
            f"(true form {stream.tok.text(t)!r})")
    _profiled("spelling job", lambda: spelling_job(dev, qstore, stream.tok))
    return launches, (fps, texts, weights, corr)


def recheck_spelling(dev, job, n_src=256, chunk=32) -> None:
    """Re-solve n_src sources (half drawn from the corrected ones) against
    all candidates with the plain version on the card and the JAX
    package's filter and scan written out in numpy; each must give the
    job's entry, or none where the job has none."""
    import numpy as np
    import torch
    from repro_torch.core.spelling import SpellConfig, scan_order
    from repro_torch.kernels import ref
    fps, texts, weights, corr = job
    cfg = SpellConfig()
    order, chars, lens, _ = scan_order(texts, weights, cfg)
    fp_s, w_s = fps[order], weights[order]
    n = len(fp_s)
    rng = np.random.default_rng(SEED)
    pos = {int(f): i for i, f in enumerate(fp_s)}
    fixed = np.array([pos[f] for f in corr])
    pick = rng.choice(fixed, min(len(fixed), n_src // 2), replace=False)
    rest = np.setdiff1d(np.arange(n), pick)
    pick = np.concatenate([pick, rng.choice(rest, n_src - len(pick),
                                            replace=False)])
    chars_d = torch.from_numpy(chars).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    cand = torch.arange(n, device=dev)
    n_entries = 0
    for c0 in range(0, len(pick), chunk):
        src = pick[c0:c0 + chunk]
        aa = torch.from_numpy(src).to(dev).repeat_interleave(n)
        bb = cand.repeat(len(src))
        d = ref.edit_distance_ref(chars_d[aa], lens_d[aa], chars_d[bb],
                                  lens_d[bb], cfg.first_char_cost)
        d = d.view(len(src), n).cpu().numpy()
        for k, a in enumerate(src):
            ok = ((w_s >= cfg.freq_boost * w_s[a:a + 1])
                  & (lens[a] >= cfg.min_len)
                  & (np.abs(lens[a] - lens) <= int(cfg.max_distance))
                  & (d[k] > 0.0) & (d[k].astype(np.float64)
                                    <= cfg.max_distance))
            exp = None
            if ok.any():
                b = int(np.argmin(np.where(ok, d[k], np.inf)))
                exp = (int(fp_s[b]), float(d[k][b]))
            got = corr.get(int(fp_s[a]))
            if got != exp:
                raise AssertionError(f"source {a}: job {got}, plain "
                                     f"re-solve {exp}")
            n_entries += exp is not None
    log(f"  plain re-solve of {len(pick)} sources against all {n} "
        f"candidates: {n_entries} corrections, all equal to the job's")


def largest_edit_distance_batch(dev, qstore, tok):
    """An untimed run of the spelling job that keeps the largest pair batch
    passed to edit_distance."""
    from repro_torch.kernels import ops as kops
    largest = {}
    edit_distance = kops.edit_distance

    def spy(ac, al, bc, bl, *, first_char_cost):
        if ac.shape[0] > largest.get("n", -1):
            largest.update(n=ac.shape[0], batch=(ac, al, bc, bl),
                           fc=first_char_cost)
        return edit_distance(ac, al, bc, bl, first_char_cost=first_char_cost)

    kops.edit_distance = spy
    try:
        spelling_job(dev, qstore, tok)
    finally:
        kops.edit_distance = edit_distance
    return largest["batch"], largest["fc"]


def largest_chain_find_batch(dev, ticks):
    """An untimed replay of the region main path's ticks that keeps the
    pair batch with the most active rows passed to chain_find, and the last
    batch of each other row count. Returns the replay's region store, that
    batch (regs, dst_hi, dst_lo, active) and {rows: last batch}."""
    from repro_torch.core.engine import SearchAssistanceEngine
    from repro_torch.kernels import ops as kops
    cfg, _ = deployment_config("region")
    largest, by_rows = {}, {}
    chain_find = kops.chain_find

    def spy(khi, klo, regs, dh, dl, active):
        n = int(active.sum())
        batch = tuple(t.clone() for t in (regs, dh, dl, active))
        if n > largest.get("n", -1):
            largest.update(n=n, batch=batch)
        by_rows[regs.shape[0]] = batch
        return chain_find(khi, klo, regs, dh, dl, active)

    kops.chain_find = spy
    try:
        eng = SearchAssistanceEngine(cfg, device=dev)
        for events, tweets in ticks:
            eng.step(events, tweets)
    finally:
        kops.chain_find = chain_find
    rows = largest["batch"][0].shape[0]
    return eng.state.cooc, largest["batch"], {
        b: batch for b, batch in by_rows.items() if b != rows}


def last_bucket_topk_grid(dev, ticks, layout):
    """An untimed replay of a main path's ticks that keeps what its last
    bucket_topk call was given: the hash layout's [R, L] bucket grid or
    the region layout's chain-merge candidates, at the last rank cycle.
    Returns (grid, K, the tick of that rank cycle)."""
    from repro_torch.core.engine import SearchAssistanceEngine
    from repro_torch.kernels import ops as kops
    cfg, _ = deployment_config(layout)
    calls, ranked, last = [], [], {}
    bucket_topk = kops.bucket_topk

    def spy(grid, k):
        calls.append(k)
        last.update(grid=grid.clone(), k=k)
        return bucket_topk(grid, k)

    kops.bucket_topk = spy
    try:
        eng = SearchAssistanceEngine(cfg, device=dev)
        for events, tweets in ticks:
            res = eng.step(events, tweets)
            if res:
                ranked.append(res["tick"])
    finally:
        kops.bucket_topk = bucket_topk
    if len(calls) != len(ranked) or not ranked:
        raise AssertionError(f"{layout} replay: {len(calls)} bucket_topk "
                             f"calls in {len(ranked)} rank cycles")
    return last["grid"], last["k"], ranked[-1]


def last_region_rank_call(dev, ticks):
    """An untimed replay of the region path's ticks that keeps what its last
    region_rank call was given (ops.region_rank's arguments, cloned), at the
    last rank cycle. Returns (args, kwargs, the tick of that rank cycle)."""
    import torch
    from repro_torch.core.engine import SearchAssistanceEngine
    from repro_torch.kernels import ops as kops
    cfg, _ = deployment_config("region")
    calls, ranked, last = [], [], {}
    region_rank = kops.region_rank

    def spy(*a, **kw):
        calls.append(kw["k"])
        last.update(call=(tuple(t.clone() if torch.is_tensor(t) else t
                                for t in a), dict(kw)))
        return region_rank(*a, **kw)

    kops.region_rank = spy
    try:
        eng = SearchAssistanceEngine(cfg, device=dev)
        for events, tweets in ticks:
            res = eng.step(events, tweets)
            if res:
                ranked.append(res["tick"])
    finally:
        kops.region_rank = region_rank
    if len(calls) != len(ranked) or not ranked:
        raise AssertionError(f"region replay: {len(calls)} region_rank "
                             f"calls in {len(ranked)} rank cycles")
    return last["call"], ranked[-1]


def last_score_gate_call(dev, ticks, eng_out=None):
    """An untimed replay of the hash path's ticks that keeps what its last
    score_gate call was given (ops.score_gate's arguments, cloned), at the
    last rank cycle. Returns (args, kwargs, the tick of that rank cycle);
    ``eng_out`` (a list), if given, receives the replay's engine."""
    import torch
    from repro_torch.core.engine import SearchAssistanceEngine
    from repro_torch.kernels import ops as kops
    cfg, _ = deployment_config("hash")
    calls, ranked, last = [], [], {}
    score_gate = kops.score_gate

    def spy(*a, **kw):
        calls.append(1)
        last.update(call=(tuple(t.clone() if torch.is_tensor(t) else t
                                for t in a), dict(kw)))
        return score_gate(*a, **kw)

    kops.score_gate = spy
    try:
        eng = SearchAssistanceEngine(cfg, device=dev)
        for events, tweets in ticks:
            res = eng.step(events, tweets)
            if res:
                ranked.append(res["tick"])
    finally:
        kops.score_gate = score_gate
    if len(calls) != len(ranked) or not ranked:
        raise AssertionError(f"hash replay: {len(calls)} score_gate calls in "
                             f"{len(ranked)} rank cycles")
    if eng_out is not None:
        eng_out.append(eng)
    return last["call"], ranked[-1]


def two_runs_bit_identical(dev, ticks, layout) -> None:
    from repro_torch.core.engine import SearchAssistanceEngine
    cfg, _ = deployment_config(layout)
    runs = []
    for _ in range(2):
        e = SearchAssistanceEngine(cfg, device=dev)
        for events, tweets in ticks[:5]:
            e.step(events, tweets)
        runs.append(e)
    if not state_bits_equal(*runs):
        raise AssertionError(f"two {layout} runs of the same stream differ")
    log(f"[5] determinism: two 5-tick {layout} runs (one decay sweep) "
        f"bit-identical")


# ---------------------------------------------------------------------------
# Phase 6: the LM serving path (h2o-danube-1.8b at its published widths).
# ---------------------------------------------------------------------------

LM_ARCH = "h2o-danube-1.8b"
LM_BATCH, LM_SEQ, LM_DECODE = 4, 8192, 16
# Agreement of prefill/decode with the kernel forward, in logits.
# bf16: 8 significant bits, 2^-9 relative per rounding. The two runs round
# at different places (kernel vs plain attention; matmuls over 8208 rows,
# 4096-row chunks or one row) at ~6 sites a layer over 24 layers;
# independent roundings add in quadrature, sqrt(144) x 2^-9 = 2.3% relative
# RMS expected, bounded here at 5%. Logits are ~N(0, 1) (unit-RMS final
# norm, head std 1/sqrt(d)): 2.3% RMS puts 6 sigma over 5e8 logits at
# ~0.14, bounded at 0.5. A wrong cache slot, position or chunk moves logits
# by O(1) and fails both; a mask off by one key of 4096 moves them by
# ~1/4096, which is the f32 check's and the CPU tests' to catch.
LM_BF16_REL_RMS, LM_BF16_MAX_ABS = 0.05, 0.5
# f32 (TF32 off): ~1e-5 relative at worst from sums in another order, so
# ~1e-4 on logits of |x| <= 5. Rounding the logits alone to bf16 errs by up
# to 2^-9 x 4 = 8e-3, and a bf16 computation by ~2e-2 RMS: both fail.
LM_F32_MAX_ABS = 1e-3
# bf16 kernel vs its f32-P twin: the tensor-core kernel rounds each p to
# bf16 once (2^-9 relative); with l summed from the f32 p, the output (a
# weighted mean of v) moves by at most 2^-9 max|v|; rtol 2^-7 covers the
# two final bf16 roundings; relative RMS within 2^-8
# (tests/test_torch_flash_numerics.py derives it on the CPU).
FA_BF16_RTOL, FA_BF16_ATOL_V, FA_BF16_REL_RMS = 2 ** -7, 2 ** -9, 2 ** -8
FA_F32_TOL = dict(rtol=2e-4, atol=2e-4)   # JAX's bar, tests/test_kernels.py


def band_pairs(Tq: int, Tk: int, causal: bool, window: int) -> int:
    """(query, key) pairs inside the causal/window band of one head."""
    import numpy as np
    qpos = np.arange(Tq, dtype=np.int64) + (Tk - Tq)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else 0
    hi = np.minimum(Tk, qpos + 1) if causal else Tk
    return int(np.maximum(hi - lo, 0).sum())


def attention_bound(q, k, causal: bool, window: int):
    """Least time for one flash_attention call: the larger of its bytes (q,
    k, v read once, o written once) at the HBM rate and its work, counted
    over the in-band pairs only: 4D FLOPs a pair (q.k and p.v) at the bf16
    tensor-core peak, and one exponential a pair at the SFU rate.
    Returns (ms, "bytes" | "operations", the bounding term, all terms)."""
    B, Hq, Tq, D = q.shape
    pairs = band_pairs(Tq, k.shape[2], causal, window) * B * Hq
    n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    terms = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "tensor-core FLOPs": 4 * D * pairs / BF16_TC_OPS_PER_S * 1e3,
             "exponentials": pairs / EXP_PER_S * 1e3}
    which = max(terms, key=terms.get)
    return (terms[which], "bytes" if which == "bytes" else "operations",
            which, dict(terms, pairs=pairs))


def _logit_gap(got, exp, vocab: int):
    """(relative RMS, max abs, top-1 agreement) of two [B, T, Vp] logit
    tensors over their first ``vocab`` columns (the padded rows hold
    -1e30, whose square overflows f32), one batch row at a time in f32."""
    sq = ref_sq = mx = 0.0
    same = n = 0
    for g, e in zip(got, exp):
        g, e = g[..., :vocab].float(), e[..., :vocab].float()
        d = g - e
        sq += float((d * d).sum())
        ref_sq += float((e * e).sum())
        mx = max(mx, float(d.abs().max()))
        same += int((g.argmax(-1) == e.argmax(-1)).sum())
        n += g.shape[0]
    return (sq / ref_sq) ** 0.5, mx, same / n


def lm_scoring(model, cfg, tokens, routes=None):
    """The scoring forward twice: first untimed, capturing layer 0's q/k/v
    as the kernel receives them (and, given a list ``routes``, each MoE
    layer's router logits, ``Route`` and top-k indices into it); then
    timed, with the launch counts set to 0 just before and read just
    after. Returns (logits, launches, wall ms, peak GiB, captured (q, k,
    v), whether the two are bit-identical)."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr
    captured = []
    kernel_call = ops.flash_attention

    def capture(q, k, v, causal=True, window=0):
        if not captured:
            captured.append((q, k, v))
        return kernel_call(q, k, v, causal, window)

    ops.flash_attention = capture
    try:
        with MoESpies(routes):
            first = tr.forward(model, tokens, cfg)[0]
    finally:
        ops.flash_attention = kernel_call
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launches()
    t0 = time.perf_counter()
    logits = tr.forward(model, tokens, cfg)[0]
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(tk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    return (logits, launches, wall_ms, peak, captured[0],
            torch.equal(first, logits))


def lm_serving(dev, model, cfg, tokens, n_decode, profile_step=False):
    """Prefill the prompts into fresh caches, then ``n_decode`` greedy
    decode steps, with the launch counts set to 0 just before; with
    ``profile_step``, one more (untimed, unchecked) step under the
    profiler. Returns
    (prefill logits, decode logits [B, n, V], the tokens fed to the decode
    steps [B, n], prefill ms, per-step ms, launches, peak GiB)."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.models import transformer as tr
    B, T = tokens.shape
    caches = tr.init_caches(cfg, B, T + n_decode, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launches()
    t0 = time.perf_counter()
    pre, caches = tr.prefill(model, tokens, cfg, caches)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    nxt = pre[:, -1].argmax(-1, keepdim=True).int()
    fed, outs, step_ms = [], [], []
    for _ in range(n_decode):
        fed.append(nxt)
        t0 = time.perf_counter()
        lg, caches = tr.decode_step(model, nxt, cfg, caches)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(lg)
        nxt = lg.argmax(-1, keepdim=True).int()
    launches = dict(tk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not bool((caches["pos"] == T + n_decode).all()):
        raise AssertionError("cache positions do not count the tokens")
    if profile_step:
        _profiled("decode step", lambda: tr.decode_step(model, nxt, cfg,
                                                         caches))
    return (pre, torch.stack(outs, 1), torch.cat(fed, 1), prefill_ms,
            step_ms, launches, peak)


def lm_agreement(model, cfg, tokens, pre, dec, fed, max_abs, rel_rms=None):
    """One kernel forward over prompt + fed tokens (ragged on purpose); its
    logits over the prefill's last chunk and at each decode position must
    match the served ones."""
    import torch
    from repro_torch.models import transformer as tr
    T, n = tokens.shape[1], fed.shape[1]
    full = tr.forward(model, torch.cat([tokens, fed], 1), cfg)[0]
    chunk = pre.shape[1]
    for name, got, exp in (("prefill", pre, full[:, T - chunk:T]),
                           ("decode", dec, full[:, T:T + n])):
        rms, mx, top1 = _logit_gap(got, exp, cfg.vocab_size)
        log(f"  {name} vs kernel forward over {T + n} tokens "
            f"({got.shape[1]} positions): rel RMS {rms!r}, max abs {mx!r} "
            f"(bounds: rel RMS {rel_rms}, max abs {max_abs}), top-1 "
            f"agreement {top1!r}")
        if mx > max_abs or (rel_rms is not None and rms > rel_rms) or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} disagrees with the kernel forward")


def check_flash_attention(q, k, v, window: int, must_beat_sdpa=True,
                          ptxas_kernel="flash_fwd_tc"):
    """flash_attention on the scoring forward's layer-0 q/k/v (bf16), held
    against its twin one batch row at a time (a row's f32 scores are
    [Hq, T, T]), then an f32 case at a quarter of T. Times: the bare launch,
    the twin row by row (summed) and SDPA with the band as its mask (with
    ``is_causal`` where the window does not cut the causal band); with ``must_beat_sdpa`` the
    bf16 kernel must be faster than that SDPA call. The ``-Xptxas -v``
    lines printed are those of the entry functions named ``ptxas_kernel``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention, launch
    B, Hq, T, D = q.shape
    got = flash_attention(q, k, v, causal=True, window=window)
    max_v = float(v.float().abs().max())
    tol = dict(rtol=FA_BF16_RTOL, atol=FA_BF16_ATOL_V * max_v)
    err = sq = ref_sq = 0.0
    for b in range(B):
        exp = ref.flash_attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                      causal=True, window=window).float()
        torch.testing.assert_close(got[b:b + 1].float(), exp, **tol)
        d = got[b:b + 1].float() - exp
        err = max(err, float(d.abs().max()))
        sq += float((d * d).sum())
        ref_sq += float((exp * exp).sum())
        del exp, d
    rel_rms = (sq / ref_sq) ** 0.5
    log(f"  flash_attention bf16 q {list(q.shape)}, k/v {list(k.shape)}, "
        f"window {window}: max_abs_err {err!r}, rel RMS {rel_rms!r}, max|v| "
        f"{max_v!r} (bounds: rtol {FA_BF16_RTOL}, atol {FA_BF16_ATOL_V} "
        f"max|v| = {tol['atol']!r}, rel RMS {FA_BF16_REL_RMS}: P is rounded "
        f"to bf16 once)")
    if rel_rms > FA_BF16_REL_RMS:
        raise AssertionError(f"flash_attention bf16 rel RMS {rel_rms}")
    q32, k32, v32 = (t[:1, :, :T // 4].float() for t in (q, k, v))
    got32 = flash_attention(q32, k32, v32, causal=True, window=window)
    exp32 = ref.flash_attention_ref(q32, k32, v32, causal=True,
                                    window=window)
    torch.testing.assert_close(got32, exp32, **FA_F32_TOL)
    log(f"  flash_attention f32 q {list(q32.shape)}: max_abs_err "
        f"{float((got32 - exp32).abs().max())!r} (tolerance {FA_F32_TOL}, "
        f"JAX's bar)")
    del q32, k32, v32, got32, exp32
    scale = ref.attention_scale(D)
    out = torch.empty_like(q)
    ms = time_ms(lambda: launch(q, k, v, out, True, window, scale))
    wrapper_ms = time_ms(lambda: flash_attention(q, k, v, causal=True,
                                                 window=window))
    plain_ms = sum(time_ms(lambda: ref.flash_attention_ref(
        q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=True, window=window),
        reps=5, warmup=1) for b in range(B))
    qpos = torch.arange(T, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    band = (kpos <= qpos) & (kpos > qpos - window)

    def sdpa():
        if window <= 0 or window >= T:   # the band is the causal triangle
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                              enable_gqa=True)
    library_ms = time_ms(sdpa)
    gap = float((sdpa().float() - got.float()).abs().max())
    log(f"  SDPA (library yardstick, timed only): {library_ms!r} ms, max abs "
        f"gap to the kernel {gap!r}; each fused backend alone: "
        f"{json.dumps(sdpa_backends(sdpa))}")
    _profiled("SDPA", sdpa)
    b_ms, b_by, which, terms = attention_bound(q, k, True, window)
    log(f"  flash_attention bound by {which}: {json.dumps(terms)}")
    flops = 4 * D * terms["pairs"]
    log(f"  flash_attention bf16: {ms!r} ms, {100 * b_ms / ms!r}% of bound, "
        f"{flops / ms / 1e9!r} TFLOP/s; SDPA {library_ms!r} ms "
        f"({library_ms / ms!r}x the kernel's time)")
    ptxas = ptxas_report("flash_attention", ptxas_kernel)
    for line in ptxas:
        log(f"  flash_attention bf16 ptxas: {line}")
    if must_beat_sdpa and ms >= library_ms:
        raise AssertionError(f"flash_attention bf16 {ms} ms is not faster "
                             f"than SDPA's {library_ms} ms")
    return dict(max_abs_err=err, ms=ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, ptxas=ptxas)


def ptxas_report(stem: str, kernel: str):
    """The ``-Xptxas -v`` lines (entry, registers, spills) of the entry
    functions of ``csrc/<stem>.cu`` whose names contain ``kernel``."""
    from repro_torch.kernels import build
    out, inside = [], False
    for line in build.build_log(stem).splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        if inside and any(w in line for w in ("entry function", "registers",
                                              "spill")):
            out.append(line.strip())
    return out


def sdpa_backends(fn):
    """ms of ``fn`` (an SDPA call) with each fused backend alone, to tell
    which one the default call took; a backend that refuses the inputs
    raises RuntimeError and is reported as refused. The math backend is
    not tried: its [B, H, T, T] scores would not fit."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        with sdpa_kernel(backend):
            try:
                out[backend.name] = time_ms(fn)
            except RuntimeError as e:
                out[backend.name] = "refused: " + str(e).splitlines()[0][:80]
    return out


LM_SMOKE_ARCHS = ("h2o-danube-1.8b", "granite-3-8b", "qwen3-8b")
MOE_SMOKE_ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x22b")


def small_lm(dev, archs=LM_SMOKE_ARCHS + MOE_SMOKE_ARCHS) -> None:
    """Phase 3 for the LM: each SMOKE model (f32, TF32 off) on the card
    against the same weights on the CPU: the forward (kernel against twin),
    then prefill of 64 tokens and 4 greedy decode steps; logits within
    1e-4 (f32 sums in another order), the MoE models' router loss within
    1e-6. Mixtral's SMOKE model runs the f32 kernel at head dim 16, window
    16."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tr
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in archs:
        cfg = get_arch(arch).smoke_config
        cpu = tr.init_params(cfg, generator=torch.Generator().manual_seed(SEED),
                             device="cpu")
        card = tr.init_params(cfg,
                              generator=torch.Generator().manual_seed(SEED),
                              device="cpu").to(dev)
        toks = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (2, 64)).astype(np.int32))
        (got, _, aux_card), (exp, _, aux_cpu) = (
            tr.forward(card, toks.to(dev), cfg), tr.forward(cpu, toks, cfg))
        if abs(float(aux_card) - float(aux_cpu)) > 1e-6:
            raise AssertionError(f"{arch} router loss {float(aux_card)!r} "
                                 f"on the card, {float(aux_cpu)!r} on the "
                                 f"CPU")
        pairs = [(got, exp)]
        caches = [tr.init_caches(cfg, 2, 68, device=d) for d in (dev, "cpu")]
        gl, caches[0] = tr.prefill(card, toks.to(dev), cfg, caches[0])
        cl, caches[1] = tr.prefill(cpu, toks, cfg, caches[1])
        pairs.append((gl, cl))
        nxt = cl[:, -1:].argmax(-1).int()
        for _ in range(4):
            gl, caches[0] = tr.decode_step(card, nxt.to(dev), cfg, caches[0])
            cl, caches[1] = tr.decode_step(cpu, nxt, cfg, caches[1])
            pairs.append((gl, cl))
            nxt = cl.argmax(-1, keepdim=True).int()
        err = 0.0
        for g, c in pairs:
            torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-4)
            err = max(err, float((g.cpu() - c).abs().max()))
        log(f"  {arch} SMOKE, card vs CPU: forward, prefill and 4 decode "
            f"steps, max abs logit error {err!r} (tolerance 1e-4)")


def run_lm(dev, rows):
    """Phase 6 (with the LM's parts of phases 2 and 5): h2o-danube-1.8b at
    its published widths and depth, bf16, random weights from a seeded
    generator on the card. Returns the scoring forward's launch counts."""
    import numpy as np
    import torch
    from repro_torch import kernels as tk
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tr
    t_phase = time.perf_counter()
    cfg = get_arch(LM_ARCH).config
    B, T, n_dec = LM_BATCH, LM_SEQ, LM_DECODE
    t0 = time.perf_counter()
    model = tr.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
        device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[6] LM serving path: {cfg}, {n_params} parameters "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB), made in "
        f"{time.perf_counter() - t0:.3f} s")
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)).to(dev)
    with torch.inference_mode():
        logits, launches, wall, peak, (q, k, v), same = lm_scoring(
            model, cfg, tokens)
        missing = [n for n in tk.PATH_KERNELS["lm"] if launches[n] <= 0]
        if missing or launches["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"scoring forward launches {launches}")
        if logits.shape != (B, T, cfg.padded_vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError("scoring logits not finite or misshapen")
        log(f"  scoring forward: {B} x {T} tokens in {wall!r} ms "
            f"({B * T / wall * 1e3!r} tokens/s), peak {peak!r} GiB, "
            f"flash_attention launches {launches['flash_attention']}")
        if not same:
            raise AssertionError("two scoring forwards differ")
        log("[5] determinism: two scoring forwards give bit-identical logits")
        del logits
        _profiled("scoring forward", lambda: tr.forward(model, tokens, cfg))
        pre, dec, fed, pre_ms, step_ms, s_launches, s_peak = lm_serving(
            dev, model, cfg, tokens, n_dec, profile_step=True)
        log(f"  serving: prefill {B} x {T} in chunks of "
            f"{cfg.window or T}: {pre_ms!r} ms; {n_dec} decode steps, ms "
            f"each {step_ms!r} (median {statistics.median(step_ms)!r}); "
            f"peak {s_peak!r} GiB; flash_attention launches "
            f"{s_launches['flash_attention']} (prefill and decode read the "
            f"cache in plain torch)")
        lm_agreement(model, cfg, tokens, pre, dec, fed, LM_BF16_MAX_ABS,
                     LM_BF16_REL_RMS)
        del pre, dec
        torch.cuda.empty_cache()
        log("[2] flash_attention at the scoring forward's layer-0 shapes")
        rows["flash_attention"] = check_flash_attention(q, k, v, cfg.window)
        log(f"  flash_attention at its main-path shape: "
            f"{json.dumps(rows['flash_attention'])}")
        del q, k, v
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"[6] f32: allow_tf32 matmul "
            f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
            f"{torch.backends.cudnn.allow_tf32}; B=1, T={T}, prefill and 4 "
            f"decode steps against the kernel forward")
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model = model.float()
        pre, dec, fed, _, _, _, _ = lm_serving(dev, model, cfg32,
                                               tokens[:1], 4)
        lm_agreement(model, cfg32, tokens[:1], pre, dec, fed,
                     LM_F32_MAX_ABS)
    del model
    torch.cuda.empty_cache()
    log(f"  LM phases took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 7: crash recovery at deployment scale.
# ---------------------------------------------------------------------------

RECOVERY_TICKS = 21          # ticks 0..19 stepped, tick 20 torn by the crash
RECOVERY_TPS = 4             # ticks per log segment


def arrays_bits_equal(a, b) -> bool:
    """Two ``state_arrays()`` dicts, leaf for leaf, byte for byte."""
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in a)


def recovery_cell(dev, ticks, layout, root: Path):
    """Phase 7 for one cooc layout: a live run that logs every tick and
    snapshots at each rank cycle (full, then delta), a crash that tears
    tick 20, then two recoveries (the newest chain; the full alone) held
    bit for bit against the state after tick 19, with equal suggestions.
    Returns (report dict, the recoveries' summed launch counts)."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core.engine import SearchAssistanceEngine
    from repro_torch.distributed.fault_tolerance import CheckpointManager
    from repro_torch.streaming import (FirehoseLogReader, FirehoseLogWriter,
                                       ReplayConfig, kill_writer_mid_segment,
                                       recover_engine)
    cfg, scfg = deployment_config(layout)
    ckpt = CheckpointManager(str(root / "ckpt"), keep_n=0, full_interval=2)
    log_dir = str(root / "log")
    writer = FirehoseLogWriter(log_dir, ticks_per_segment=RECOVERY_TPS)
    eng = SearchAssistanceEngine(cfg, device=dev)
    saves, step_ms = [], []
    for t, (events, tweets) in enumerate(ticks[:RECOVERY_TICKS - 1]):
        writer.append(t, events, tweets)
        t0 = time.perf_counter()
        out = eng.step(events, tweets)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if out is None:
            continue
        t0 = time.perf_counter()
        eng.save_snapshot(ckpt)
        wall = (time.perf_counter() - t0) * 1e3
        saves.append({"step": int(eng.state.tick),
                      "kind": ckpt.last_save_kind,
                      "raw_bytes": ckpt.last_save_raw_bytes,
                      "disk_bytes": ckpt.last_save_bytes, "wall_ms": wall,
                      "split_ms": ckpt.last_save_ms})
    if [s["kind"] for s in saves] != ["full", "delta"]:
        raise AssertionError(f"{layout} snapshots: {saves}")
    reference = eng.state_arrays()           # host copies of the card state
    del eng
    torch.cuda.empty_cache()
    writer.append(RECOVERY_TICKS - 1, *ticks[RECOVERY_TICKS - 1])
    torn = kill_writer_mid_segment(writer)
    reader = FirehoseLogReader(log_dir)
    if torn is None or reader.last_tick() != RECOVERY_TICKS - 2 or \
            reader.n_unmanifested_files != 1:
        raise AssertionError(f"{layout} torn tail: {torn}, head "
                             f"{reader.last_tick()}")
    ref = SearchAssistanceEngine(cfg, device=dev)
    ref.load_state_arrays(reference)
    ref.run_rank_cycle()
    ref_suggestions = ref.suggestions
    del ref
    torch.cuda.empty_cache()
    full_step = saves[0]["step"]
    launches = {n: 0 for n in tk.KERNELS}
    runs = {}
    for label, step, tail in (("a", None, RECOVERY_TICKS - 1 - saves[1]["step"]),
                              ("b", full_step, RECOVERY_TICKS - 1 - full_step)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tk.reset_launches()
        t0 = time.perf_counter()
        rec, stats = recover_engine(cfg, ckpt, log_dir, ReplayConfig(),
                                    step=step, device=dev)
        torch.cuda.synchronize()
        fresh_ms = (time.perf_counter() - t0) * 1e3
        for n, k in tk.LAUNCHES.items():
            launches[n] += k
        peak = torch.cuda.max_memory_allocated() / 2**30
        if stats["n_ticks"] != tail or int(rec.state.tick) != \
                RECOVERY_TICKS - 1:
            raise AssertionError(f"{layout} recovery ({label}): {stats}")
        if not arrays_bits_equal(rec.state_arrays(), reference):
            raise AssertionError(f"{layout} recovery ({label}) differs from "
                                 f"the uncrashed state")
        if rec.suggestions != ref_suggestions or not rec.suggestions:
            raise AssertionError(f"{layout} recovery ({label}): suggestions "
                                 f"differ from the uncrashed state's")
        replay_s = stats["wall_s"] - stats["rank_s"]
        runs[label] = {
            "restored_step": stats["restored_step"],
            "chain_len": stats["restore"]["chain_len"],
            "ticks_replayed": stats["n_ticks"],
            "time_to_fresh_ms": fresh_ms,
            "restore_ms": stats["restore_s"] * 1e3,
            "restore_split_ms": stats["restore_ms"],
            "replay_ms": replay_s * 1e3,
            "replay_ms_per_tick": replay_s * 1e3 / stats["n_ticks"],
            "replay_x_real_time": stats["n_ticks"] * scfg.tick_seconds
            / replay_s,
            "rank_ms": stats["rank_s"] * 1e3,
            "rank_cycles": stats["n_rank_run"],
            "suggestions": len(rec.suggestions),
            "peak_mem_gib": peak}
        del rec
        torch.cuda.empty_cache()
    report = {"layout": layout, "live_ms_per_tick_mean":
              statistics.mean(step_ms), "rank_period_ms":
              cfg.rank_every * scfg.tick_seconds * 1e3, "saves": saves,
              "torn": torn, "recoveries": runs,
              "launches": {n: k for n, k in launches.items() if k}}
    return report, launches


def run_recovery(dev, card: str):
    """Phase 7: recovery at deployment scale under each cooc layout, then
    the breaking-news scenario on the card. Returns the recovery path's
    launch counts (both layouts summed)."""
    import tempfile
    import torch
    from repro_torch import breaking_news
    from repro_torch import kernels as tk
    from repro_torch.data.stream import SyntheticStream
    t_phase = time.perf_counter()
    _, scfg = deployment_config()
    stream = SyntheticStream(scfg, seed=SEED)
    ticks = [stream.gen_tick(t) for t in range(RECOVERY_TICKS)]
    total = {n: 0 for n in tk.KERNELS}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_recovery_") as tmp:
        for layout in ("hash", "region"):
            report, launches = recovery_cell(dev, ticks, layout,
                                             Path(tmp) / layout)
            missing = [n for n in tk.PATH_KERNELS[layout] if launches[n] <= 0]
            if missing:
                raise AssertionError(f"kernels not launched on the {layout} "
                                     f"recovery path: {missing}")
            for n, k in launches.items():
                total[n] += k
            log(f"[7] {layout} recovery ({card}): " + json.dumps(report))
            for s in report["saves"]:
                log(f"  {layout} save step {s['step']} ({s['kind']}): "
                    f"{s['raw_bytes']} B raw, {s['disk_bytes']} B on disk, "
                    f"{s['wall_ms']:.3f} ms against a rank period of "
                    f"{report['rank_period_ms']:.0f} ms; split "
                    + ", ".join(f"{k} {v:.3f}" for k, v in
                                s["split_ms"].items()))
            for label, r in report["recoveries"].items():
                log(f"  {layout} recovery ({label}) from step "
                    f"{r['restored_step']} (chain of {r['chain_len']}): "
                    f"bit-exact, suggestions equal; time to fresh "
                    f"{r['time_to_fresh_ms']:.3f} ms = restore "
                    f"{r['restore_ms']:.3f} + replay {r['ticks_replayed']} "
                    f"ticks {r['replay_ms']:.3f} "
                    f"({r['replay_ms_per_tick']:.3f} ms a tick, "
                    f"{r['replay_x_real_time']:.1f}x real time) + rank "
                    f"{r['rank_ms']:.3f}; restore split "
                    + ", ".join(f"{k} {v:.3f}" for k, v in
                                r["restore_split_ms"].items())
                    + f"; peak {r['peak_mem_gib']:.3f} GiB")
            log(f"  {layout} recovery launches: {report['launches']}")
            torch.cuda.empty_cache()
        log("[7] breaking news on the card (python -m "
            "repro_torch.breaking_news)")
        lines = []
        t0 = time.perf_counter()
        res = breaking_news.run(dev, out_dir=str(Path(tmp) / "news"),
                                log=lines.append)
        wall = time.perf_counter() - t0
    for line in lines:
        if "CRASH" in line or ">>>" in line or "breaks at" in line:
            log("  " + line.strip())
    rec = res["recovery"]
    if res["latency_min"] is None or \
            res["latency_min"] > breaking_news.TARGET_MIN:
        raise AssertionError(f"breaking news: related terms surfaced after "
                             f"{res['latency_min']} sim-min")
    if not res["kept"] or not any(t in dict(res["final"])
                                  for t in res["event_terms"]):
        raise AssertionError(f"breaking news: event terms lost across the "
                             f"crash: {res['final']}")
    log(f"  breaking news ({card}): surfaced {res['latency_min']} sim-min "
        f"after the event (target {breaking_news.TARGET_MIN}); crash "
        f"recovery from step {rec['restored_step']}, {rec['n_ticks']} ticks "
        f"replayed, {rec['wall_total_s'] * 1e3:.3f} ms wall; kept "
        f"{res['kept']}; final {res['final']}; scenario {wall:.1f} s")
    log(f"  recovery phase took {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# Phase 8: the serving stack at deployment scale.
# ---------------------------------------------------------------------------

# The loop appends each tick to the durable log before stepping and seals
# a segment every 8 ticks; the crash comes right after a seal (ticks
# 48-55), so the log holds every tick and both engines replay 49-55 onto
# their tick-48 snapshots. (At tick 52 the writer's unsealed ticks 48-52
# would die with the stack: recovery would land on the snapshot itself,
# with nothing replayed, not on the crash-time state.)
# Phase 8's depth: the launcher's steve-jobs event and spelling job (tick
# 60 in serve_assist) move to tick 36, so the crashed and resumed loops
# cover 49 ticks instead of 73 with every check in place: the crash 7
# ticks past both engines' tick-24 snapshots, requests at 36 and 48.
SERVE_EVENT_AT = 36
SERVE_CRASH_AT = 31
SERVE_TICKS = 49              # resumed through tick 48
SERVE_REQUESTS = 1000
SERVE_KERNELS = ("decay_prune_multi", "score_gate", "bucket_topk",
                 "edit_distance")


def _ms_stats(xs):
    xs = sorted(xs)
    return {"n": len(xs), "mean": statistics.mean(xs),
            "p50": xs[len(xs) // 2], "p99": xs[min(len(xs) - 1,
                                                  int(0.99 * len(xs)))],
            "max": xs[-1]}


def run_serving(dev, card: str):
    """Phase 8: ``repro_torch.launch.serve_assist``'s loop on the hash
    deployment cell (two rt replicas, the bg engine, two frontends behind a
    ServerSet), crashed at ``SERVE_CRASH_AT``, the stack recovered by
    ``recover_service`` and held bit for bit against host copies of both
    engines at the crash, then resumed with ``recover`` through tick
    ``SERVE_TICKS - 1``; the launcher's event and spelling job moved to
    ``SERVE_EVENT_AT`` for the phase. Returns the phase's launch counts."""
    import os
    import tempfile
    import numpy as np
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core.background import background_config
    from repro_torch.core.hashing import join_fp
    from repro_torch.core.stores import export_live
    from repro_torch.data.stream import steve_jobs_scenario
    from repro_torch.distributed.fault_tolerance import CheckpointManager
    from repro_torch.launch import serve_assist
    from repro_torch.streaming import ReplayConfig, recover_service
    t_phase = time.perf_counter()
    cfg, base = deployment_config("hash")
    bgcfg = background_config(cfg, rank_every_mult=3)
    launcher_scenario = serve_assist.steve_jobs_scenario
    launcher_spell_every = serve_assist.SPELL_EVERY

    def moved_scenario(*a, **kw):
        scfg, ev = steve_jobs_scenario(*a, **kw)
        ev = dataclasses.replace(ev, t_start=SERVE_EVENT_AT)
        return dataclasses.replace(scfg, events=(ev,)), ev

    serve_assist.steve_jobs_scenario = moved_scenario
    serve_assist.SPELL_EVERY = SERVE_EVENT_AT
    _, event = moved_scenario(base_cfg=base)
    rank_period_ms = cfg.rank_every * base.tick_seconds * 1e3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launches()
    lines = []
    # the spelling job's inputs and result, for its check after the phase
    job, spelling_cycle = [], serve_assist.spelling_cycle

    def keep_job(fps, texts, weights, scfg, **kw):
        corr = spelling_cycle(fps, texts, weights, scfg, **kw)
        job.append((fps, texts, weights, corr))
        return corr

    serve_assist.spelling_cycle = keep_job
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serving_") as tmp:
        opts = serve_assist.AssistOptions(
            ticks=SERVE_TICKS, out=tmp, replicas=2, fail_replica_at=-1,
            crash_at=SERVE_CRASH_AT, recover=False, full_every=4,
            slow_io_ms=0.0)
        walls = {}
        t0 = time.perf_counter()
        live = serve_assist.run(cfg, base, opts, dev, log=lines.append)
        walls["live_run"] = time.perf_counter() - t0
        if live["crashed_at"] != SERVE_CRASH_AT:
            raise AssertionError(f"serving: no crash at {SERVE_CRASH_AT}")
        copies = {"rt": live["backends"][0].state_arrays(),
                  "bg": live["bg"].state_arrays()}
        if not arrays_bits_equal(live["backends"][1].state_arrays(),
                                 copies["rt"]):
            raise AssertionError("serving: the two rt replicas differ")
        ticks, saves = list(live["ticks"]), list(live["saves"])
        del live
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc, rstats = recover_service(
            cfg, CheckpointManager(os.path.join(tmp, "state", "rt")),
            CheckpointManager(os.path.join(tmp, "state", "bg")),
            os.path.join(tmp, "log"), ReplayConfig(chunk_ticks=8),
            bg_cfg=bgcfg, device=dev)
        torch.cuda.synchronize()
        fresh_ms = (time.perf_counter() - t0) * 1e3
        walls["recover_service"] = fresh_ms / 1e3
        for name, eng in (("rt", svc.rt), ("bg", svc.bg)):
            st = rstats[name]
            if int(eng.state.tick) != SERVE_CRASH_AT + 1 or not \
                    arrays_bits_equal(eng.state_arrays(), copies[name]):
                raise AssertionError(f"serving: recovered {name} engine "
                                     f"differs from the crash-time state "
                                     f"({st['n_ticks']} ticks replayed)")
        recovery = {name: {
            "restored_step": rstats[name]["restored_step"],
            "chain_len": rstats[name]["restore"]["chain_len"],
            "ticks_replayed": rstats[name]["n_ticks"],
            "restore_ms": rstats[name]["restore_s"] * 1e3,
            "replay_ms": (rstats[name]["wall_s"] - rstats[name]["rank_s"])
            * 1e3,
            "rank_ms": rstats[name]["rank_s"] * 1e3}
            for name in ("rt", "bg")}
        if not svc.suggestions:
            raise AssertionError("serving: recovered stack has no tables")
        del svc, copies
        torch.cuda.empty_cache()
        opts = dataclasses.replace(opts, crash_at=-1, recover=True)
        t0 = time.perf_counter()
        res = serve_assist.run(cfg, base, opts, dev, log=lines.append)
        walls["resumed_run"] = time.perf_counter() - t0
        serve_assist.spelling_cycle = spelling_cycle
        serve_assist.steve_jobs_scenario = launcher_scenario
        serve_assist.SPELL_EVERY = launcher_spell_every
        draws = {"live_run_ms": sum(r["draw_ms"] for r in ticks),
                 "resumed_run_ms": sum(r["draw_ms"] for r in res["ticks"]),
                 "resumed_run_skipped_ms": res["skip_draw_ms"],
                 "resumed_run_skipped_ticks": res["start_tick"]}
        ticks += res["ticks"]
        saves += res["saves"]
        # requests for live query texts, after the last poll
        exp = export_live(res["backends"][0].state.qstore)
        fps = join_fp(exp["key_hi"], exp["key_lo"])
        pick = np.random.default_rng(SEED).choice(
            len(fps), size=min(SERVE_REQUESTS, len(fps)), replace=False)
        texts = [res["tok"].text(int(fps[i])) for i in pick]
        req_ms, answered = [], 0
        for q in texts:
            t0 = time.perf_counter()
            answered += bool(res["serverset"].request(q, k=8))
            req_ms.append((time.perf_counter() - t0) * 1e3)
        metrics = res["frontends"][0].metrics()
        peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(tk.LAUNCHES)
    last = res["requests"][-1]
    route = last["route"]
    terms = [t for t in event.terms[1:] if t in dict(route.suggestions)]
    if last["t"] != SERVE_TICKS - 1 or route.tick != SERVE_TICKS - 1 or \
            route.staleness != 0 or not route.suggestions:
        raise AssertionError(f"serving: tick-{SERVE_TICKS - 1} request "
                             f"answered from {last['t']}/{route}")
    missing = [n for n in SERVE_KERNELS if launches[n] <= 0]
    if missing:
        raise AssertionError(f"serving: kernels not launched: {missing}")
    spelling = res["spelling"]
    if not spelling or spelling[0]["corrections"] <= 0 or len(job) != 1:
        raise AssertionError(f"serving: spelling job {spelling}, "
                             f"{len(job)} kept")
    draws["share_of_phase"] = sum(
        v for k, v in draws.items() if k.endswith("_ms")) / 1e3 / (
        time.perf_counter() - t_phase)
    by_kind = {}
    for s in saves:
        for e in ("rt", "bg"):
            by_kind.setdefault(f"{e} {s[e]['kind']}", []).append(s[e]["ms"])
    report = {
        "card": card, "crash_at": SERVE_CRASH_AT,
        "resumed_from": res["start_tick"], "last_tick": SERVE_TICKS - 1,
        "stack_tick_ms": _ms_stats([r["stack_ms"] for r in ticks]),
        "steps_ms": _ms_stats([r["steps_ms"] for r in ticks]),
        "poll_ms": _ms_stats([r["poll_ms"] for r in ticks]),
        "slowest_ticks": [
            {k: r[k] for k in ("t", "steps_ms", "poll_ms", "persist_ms")}
            for r in sorted(ticks, key=lambda r: -r["stack_ms"])[:6]],
        "persist_ms_total": sum(r["persist_ms"] for r in ticks),
        "stream_draws": draws, "wall_s": walls,
        "save_ms": {k: _ms_stats(v) for k, v in by_kind.items()},
        "time_to_fresh_ms": fresh_ms,
        "resume_time_to_fresh_ms": res["recover"]["wall_s"] * 1e3,
        "rank_period_ms": rank_period_ms, "recovery": recovery,
        "spelling": spelling, "request_ms": _ms_stats(req_ms),
        "requests_answered": answered,
        "rt_lag_ticks": metrics["rt_lag_ticks"],
        "bg_lag_ticks": metrics["bg_lag_ticks"],
        "related_last_tick": route.suggestions, "event_terms_held": terms,
        "peak_mem_gib": peak,
        "launches": {n: k for n, k in launches.items() if k}}
    log(f"[8] serving stack ({card}): " + json.dumps(report))
    for line in lines:
        if "CRASH" in line or "recover" in line or "spelling" in line \
                or "related" in line:
            log("  " + line.strip())
    st = report["stack_tick_ms"]
    log(f"  serving ({card}): ms per stack tick (3 engine steps, log "
        f"append, 2 frontend polls) mean {st['mean']:.3f}, p50 "
        f"{st['p50']:.3f}, max {st['max']:.3f} over {st['n']} ticks; "
        f"steps p50 {report['steps_ms']['p50']:.3f}, polls p50 "
        f"{report['poll_ms']['p50']:.3f}, max {report['poll_ms']['max']:.3f}"
        f"; slowest {report['slowest_ticks']}; walls (s) {walls}")
    log(f"  serving ({card}): synthetic stream draws on the host: live "
        f"run {draws['live_run_ms']:.3f} ms over {SERVE_CRASH_AT + 1} "
        f"ticks, resumed run {draws['resumed_run_ms']:.3f} ms over "
        f"{SERVE_TICKS - res['start_tick']} ticks plus "
        f"{draws['resumed_run_skipped_ms']:.3f} ms drawing and dropping its "
        f"{res['start_tick']} earlier ticks; "
        f"{100 * draws['share_of_phase']:.1f}% of the phase so far")
    for k, v in report["save_ms"].items():
        log(f"  serving ({card}): {k} save ms mean {v['mean']:.3f} "
            f"(n {v['n']}, max {v['max']:.3f})")
    log(f"  serving ({card}): whole-stack time to fresh "
        f"(recover_service) {fresh_ms:.3f} ms against the "
        f"{rank_period_ms:.0f}-ms rank period; resume "
        f"{report['resume_time_to_fresh_ms']:.3f} ms; " + "; ".join(
            f"{e} from step {r['restored_step']} (chain of "
            f"{r['chain_len']}), {r['ticks_replayed']} ticks replayed, "
            f"restore {r['restore_ms']:.3f} + replay {r['replay_ms']:.3f}"
            f" + rank {r['rank_ms']:.3f} ms" for e, r in recovery.items())
        + "; both engines bit-exact against the crash-time state")
    log(f"  serving ({card}): spelling job {spelling[0]['ms']:.3f} ms, "
        f"{spelling[0]['corrections']} corrections over "
        f"{spelling[0]['sources']} sources")
    rq = report["request_ms"]
    log(f"  serving ({card}): ServerSet.request over {rq['n']} live query "
        f"texts: p50 {rq['p50']:.4f} ms, p99 {rq['p99']:.4f} ms "
        f"({answered} answered with rows); frontend metrics rt_lag_ticks "
        f"{metrics['rt_lag_ticks']}, bg_lag_ticks {metrics['bg_lag_ticks']}")
    log(f"  serving ({card}): related('{event.terms[0]}') at tick "
        f"{route.tick} (staleness {route.staleness}): {route.suggestions}; "
        f"event terms held {terms}; peak {peak:.3f} GiB")
    log(f"  serving launches: {report['launches']}")
    del res
    torch.cuda.empty_cache()
    check_serving_spelling(dev, job[0], launches["edit_distance"])
    log(f"  serving phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def check_serving_spelling(dev, job, n_launches: int) -> None:
    """Phase 8's spelling job held against the plain version on its own
    inputs: the job's sources, texts and weights go through spelling_cycle
    again, each edit_distance launch compared bit for bit with the plain
    version on the same pairs (the path's launches, one for one), and the
    corrections must equal the job's; then recheck_spelling re-solves a
    sample of its sources with the plain version. These launches come
    after the phase's counts were read."""
    import torch
    from repro_torch.core.spelling import SpellConfig, spelling_cycle
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    fps, texts, weights, corr = job
    edit_distance = kops.edit_distance
    held = {"launches": 0, "pairs": 0, "largest_batch": 0,
            "max_abs_err": 0.0}

    def hold(ac, al, bc, bl, *, first_char_cost):
        got = edit_distance(ac, al, bc, bl, first_char_cost=first_char_cost)
        exp = ref.edit_distance_ref(ac, al, bc, bl,
                                    first_char_cost=first_char_cost)
        if not torch.equal(got.view(torch.int32), exp.view(torch.int32)):
            raise AssertionError(f"serving: edit_distance launch "
                                 f"{held['launches']} ({ac.shape[0]} pairs) "
                                 f"differs from the plain version")
        n = ac.shape[0]
        held["launches"] += 1
        held["pairs"] += n
        held["largest_batch"] = max(held["largest_batch"], n)
        if n:
            held["max_abs_err"] = max(held["max_abs_err"],
                                      float((got - exp).abs().max()))
        return got

    t0 = time.perf_counter()
    kops.edit_distance = hold
    try:
        again = spelling_cycle(fps, texts, weights, SpellConfig(),
                               device=dev)
    finally:
        kops.edit_distance = edit_distance
    if held["launches"] != n_launches or again != corr:
        raise AssertionError(f"serving: the spelling job's check run made "
                             f"{held['launches']} edit_distance launches "
                             f"(the path {n_launches}); corrections equal: "
                             f"{again == corr}")
    log(f"  serving spelling job held against the plain version: "
        f"{json.dumps(held)}, every launch bit-equal, corrections equal, "
        f"{time.perf_counter() - t0:.1f} s")
    recheck_spelling(dev, job)


# ---------------------------------------------------------------------------
# Phase 9: a flash crowd, overload control and log compaction at deployment
# scale, with a crash in the shed window.
# ---------------------------------------------------------------------------

# serve_assist's firehose workload: 1,024 queries and 64 tweets a tick at
# base, a 50x breaking-news spike from tick 16 (capped at 16,384 queries a
# tick), spam bursts; a tick is 10 s of traffic. The stack runs live
# through tick 39 (inside the shed window), crashes right after sealing
# its log, and resumes with ``recover`` through tick 47. Compaction folds
# both engines every 16 ticks, keeping 2 bases.
FLASH_SPIKE_AT = 16
FLASH_CRASH_AT = 39
FLASH_TICKS = 48
FLASH_COMPACT_EVERY = 16
FLASH_KEEP_BASES = 2
# The SLO is this multiple of the slowest base-traffic step the phase
# measures before its run (three engines stepping base ticks 0-7 again,
# warm), so base ticks stay under it and spike ticks (16x the queries, 32x
# the tweets) do not; measured cold, one-time module loading in the first
# tick would hold the p95 up for ~20 ticks. The arrival budget a tick
# leaves base traffic and its persists ahead of schedule on an H100, and
# the ~20-s fold at tick 32 puts the spike window behind (PERF.md §4, §5).
FLASH_SLO_FACTOR = 1.5
FLASH_TICK_MS = 1500.0
# If the live triggers have not reached level 3 by this tick, the ladder is
# pinned at 3 from here to the crash (``DegradationLadder.force``), and the
# phase says so.
FLASH_PIN_FROM = 30
FLASH_KERNELS = ("decay_prune_multi", "score_gate", "bucket_topk")


def _flash_spies():
    """Keep the arguments of the last score_gate and bucket_topk calls
    (cloned); returns (kept, undo)."""
    import torch
    from repro_torch.kernels import ops as kops
    kept = {"score_gate": None, "bucket_topk": None}
    score_gate, bucket_topk = kops.score_gate, kops.bucket_topk

    def keep_score_gate(*a, **kw):
        kept["score_gate"] = (tuple(t.clone() if torch.is_tensor(t) else t
                                    for t in a), dict(kw))
        return score_gate(*a, **kw)

    def keep_bucket_topk(grid, k):
        kept["bucket_topk"] = (grid.clone(), k)
        return bucket_topk(grid, k)

    kops.score_gate, kops.bucket_topk = keep_score_gate, keep_bucket_topk

    def undo():
        kops.score_gate, kops.bucket_topk = score_gate, bucket_topk
    return kept, undo


def _pin_ladder(pinned):
    """Wrap ``DegradationLadder.observe``: the n-th observation of a fresh
    ladder is tick n of the live run; from ``FLASH_PIN_FROM`` on, a ladder
    below level 3 is pinned there. Returns undo."""
    from repro_torch.streaming import overload as tov
    observe = tov.DegradationLadder.observe

    def observe_or_pin(self, **kw):
        n = self.__dict__.setdefault("_n_observed", 0)
        self._n_observed = n + 1
        if n >= FLASH_PIN_FROM and self.level < 3 and pinned["from"] is None:
            pinned["from"] = n
            self.force(3)
        return observe(self, **kw)

    tov.DegradationLadder.observe = observe_or_pin

    def undo():
        tov.DegradationLadder.observe = observe
    return undo


def _flash_base_step_ms(dev, cfg, bgcfg):
    """Warm the process's kernels and allocator on base traffic, and time
    it: the phase's three engines (two rt, bg) step the firehose
    workload's base ticks 0-7 twice (spam ticks, a decay cycle, a rank
    cycle in the second pass); returns the second pass's ms a tick (all
    three engines, synced)."""
    import torch
    from repro_torch.core.engine import SearchAssistanceEngine
    from repro_torch.launch import serve_assist
    wl = serve_assist.firehose_workload(FLASH_SPIKE_AT, 50.0)
    ticks = [wl.gen_tick(t) for t in range(8)]
    engines = [SearchAssistanceEngine(c, n, dev) for c, n in
               ((cfg, "rt"), (cfg, "rt1"), (bgcfg, "bg"))]
    ms = []
    for _ in range(2):
        for ev, tw in ticks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for e in engines:
                e.step(ev, tw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    del engines
    torch.cuda.empty_cache()
    return ms[len(ticks):]


def _levels_balance(ticks):
    """Per ladder level: queries and tweets offered, shed and logged (what
    admission let into the durable log). Raises unless offered = logged +
    shed at every level, for each hose."""
    out = {}
    for r in ticks:
        o = r["overload"]
        lv = out.setdefault(o["level"], {k: 0 for k in (
            "ticks", "offered_events", "shed_events", "logged_events",
            "offered_tweets", "shed_tweets", "logged_tweets")})
        lv["ticks"] += 1
        for k in lv:
            if k != "ticks":
                lv[k] += o[k]
    for level, lv in out.items():
        for hose in ("events", "tweets"):
            if lv[f"offered_{hose}"] != lv[f"logged_{hose}"] + \
                    lv[f"shed_{hose}"]:
                raise AssertionError(f"flash crowd: {hose} at level {level} "
                                     f"do not balance: {lv}")
    return dict(sorted(out.items()))


def run_flash_crowd(dev, card: str, floor):
    """Phase 9: ``serve_assist``'s loop on the hash deployment cell under
    its firehose workload with overload control and compaction; a crash in
    the shed window; recovery through the newest base (``recover_service``
    from the snapshots older than it), replay from zero through the base
    after the trim, a torn newest base falling back to the previous one,
    each bit for bit against host copies of the drained engines; then the
    resumed run. Holds score_gate and bucket_topk against their plain
    versions on the inputs of the phase's last rank cycle. Returns the
    phase's launch counts."""
    import os
    import tempfile
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core.background import background_config
    from repro_torch.core.engine import SearchAssistanceEngine, rank_due
    from repro_torch.distributed.fault_tolerance import CheckpointManager
    from repro_torch.launch import serve_assist
    from repro_torch.streaming import (CatchUpController, FirehoseLogReader,
                                       ReplayConfig, corrupt_base,
                                       recover_service, restore_from_base)
    t_phase = time.perf_counter()
    cfg, base = deployment_config("hash")
    bgcfg = background_config(cfg, rank_every_mult=3)
    rank_period_ms = cfg.rank_every * 10.0 * 1e3     # 10-s ticks
    base_ms = _flash_base_step_ms(dev, cfg, bgcfg)
    slo_ms = FLASH_SLO_FACTOR * max(base_ms)
    log(f"[9] flash crowd ({card}): base traffic, three engines a tick "
        f"(ticks 0-7, warm): {[round(x, 3) for x in base_ms]} ms; slo_ms = "
        f"{FLASH_SLO_FACTOR} x {max(base_ms):.3f} = {slo_ms:.3f}, tick_ms "
        f"{FLASH_TICK_MS}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kept, undo_spies = _flash_spies()
    pinned = {"from": None}
    undo_pin = _pin_ladder(pinned)
    lines, walls = [], {}
    tk.reset_launches()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_flash_") as tmp:
            log_dir = os.path.join(tmp, "log")
            opts = serve_assist.AssistOptions(
                ticks=FLASH_TICKS, out=tmp, replicas=2, fail_replica_at=-1,
                crash_at=FLASH_CRASH_AT, recover=False, full_every=4,
                slow_io_ms=0.0, slo_ms=slo_ms, tick_ms=FLASH_TICK_MS,
                workload="firehose", spike_at=FLASH_SPIKE_AT,
                spike_mult=50.0, compact_every=FLASH_COMPACT_EVERY,
                keep_bases=FLASH_KEEP_BASES)
            t0 = time.perf_counter()
            live = serve_assist.run(cfg, base, opts, dev, log=lines.append)
            walls["live_run"] = time.perf_counter() - t0
            undo_pin()
            if live["crashed_at"] != FLASH_CRASH_AT:
                raise AssertionError("flash crowd: no crash")
            # the crash comes right after the writer sealed its segment:
            # every offered tick is in the log; the drained engines hold
            # them all
            live["writer"].flush()
            svc = live["service"]
            svc.drain()
            torch.cuda.synchronize()
            end = FLASH_CRASH_AT + 1
            copies = {"rt": svc.rt.state_arrays(),
                      "bg": svc.bg.state_arrays()}
            if int(svc.rt.state.tick) != end or not arrays_bits_equal(
                    live["backends"][1].state_arrays(), copies["rt"]):
                raise AssertionError("flash crowd: the mirror differs from "
                                     "the leader, or the drain fell short")
            ov = svc.overload.stats_snapshot()
            c = svc.overload.counters
            for hose in ("events", "tweets"):
                if c[f"n_offered_{hose}"] != c[f"n_ingested_{hose}"] + \
                        c[f"n_shed_{hose}"]:
                    raise AssertionError(f"flash crowd: {hose} shed "
                                         f"silently: {c}")
            levels = _levels_balance(live["ticks"])
            logged = {h: sum(lv[f"logged_{h}"] for lv in levels.values())
                      for h in ("events", "tweets")}
            if logged["events"] != c["n_ingested_events"] or \
                    logged["tweets"] != c["n_ingested_tweets"]:
                raise AssertionError(f"flash crowd: logged {logged}, "
                                     f"ingested {c}")
            dues = {e: sum(rank_due(x, t) for t in range(end))
                    for e, x in (("rt", cfg), ("bg", bgcfg))}
            for e in ("rt", "bg"):
                if c[f"n_rank_run_{e}"] + c[f"n_shed_rank_{e}"] != dues[e]:
                    raise AssertionError(f"flash crowd: {e} rank cycles "
                                         f"{c}, {dues[e]} due")
            if max(levels) != 3:
                raise AssertionError(f"flash crowd: level 3 never reached: "
                                     f"{ov['level_ticks']}")
            ticks, saves = list(live["ticks"]), list(live["saves"])
            compactions = live["compactions"]
            del live, svc
            torch.cuda.empty_cache()

            # the trim: segments below the retained floor are gone
            reader = FirehoseLogReader(log_dir)
            last = compactions[-1]["stats"]
            newest = reader.floor_tick()
            on_disk = sorted(f for f in os.listdir(log_dir)
                             if f.endswith(".npz"))
            if newest != last["floor"] or \
                    reader.first_tick() < last["retain_floor"] or \
                    on_disk != sorted(s.file for s in reader.segments) or \
                    reader.last_tick() != FLASH_CRASH_AT:
                raise AssertionError(f"flash crowd: log after the trim: "
                                     f"{reader.segments}, {reader.bases}")
            # (a) recover_service through the newest base: both engines
            # from the newest state snapshot older than the base
            cks = {e: CheckpointManager(os.path.join(tmp, "state", e))
                   for e in ("rt", "bg")}
            older = {e: max(s for s in ck.steps() if s < newest)
                     for e, ck in cks.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec, rstats = recover_service(
                cfg, cks["rt"], cks["bg"], log_dir,
                ReplayConfig(chunk_ticks=8), bg_cfg=bgcfg,
                rt_step=older["rt"], bg_step=older["bg"], device=dev)
            torch.cuda.synchronize()
            fresh = {"base": (time.perf_counter() - t0) * 1e3}
            recovery = {}
            for e, eng in (("rt", rec.rt), ("bg", rec.bg)):
                st = rstats[e]
                if (st["base"] or {}).get("base_tick") != newest or \
                        int(eng.state.tick) != end or \
                        not arrays_bits_equal(eng.state_arrays(), copies[e]):
                    raise AssertionError(f"flash crowd: {e} through the base"
                                         f" differs: {st}")
                recovery[e] = {
                    "snapshot": st["restored_step"], "base": newest,
                    "ticks_replayed": st["n_ticks"],
                    "snapshot_restore_ms": st["restore_s"] * 1e3,
                    "base_restore_ms": st["base"]["restore_s"] * 1e3,
                    "replay_ms": (st["wall_s"] - st["rank_s"]) * 1e3,
                    "rank_ms": st["rank_s"] * 1e3}
            del rec
            torch.cuda.empty_cache()

            # the resumed run, through tick 47
            opts = dataclasses.replace(opts, crash_at=-1, recover=True)
            t0 = time.perf_counter()
            res = serve_assist.run(cfg, base, opts, dev, log=lines.append)
            walls["resumed_run"] = time.perf_counter() - t0
            rs = res["recover"]
            for e in ("rt", "bg"):
                via_base = rs[e]["base"] is not None
                if via_base != (rs[e]["restored_step"] < newest):
                    raise AssertionError(f"flash crowd: resumed {e} took "
                                         f"the {'base' if via_base else 'chain'}"
                                         f": {rs[e]}")
            route = res["serverset"].request_info(serve_assist.FIREHOSE_HEAD,
                                                  k=8)
            newest_table = CheckpointManager(os.path.join(tmp, "rt")).manifest()
            metrics = res["frontends"][0].metrics()
            if not route.suggestions or route.staleness != 0 or \
                    route.tick != newest_table["meta"]["tick"]:
                raise AssertionError(f"flash crowd: '{serve_assist.FIREHOSE_HEAD}'"
                                     f" answered {route}, newest table "
                                     f"{newest_table['meta']}")
            resumed = {"from_tick": res["start_tick"],
                       "recover": {e: {k: rs[e][k] for k in (
                           "restored_step", "n_ticks")} | {
                           "base": (rs[e]["base"] or {}).get("base_tick")}
                           for e in ("rt", "bg")},
                       "time_to_fresh_ms": rs["wall_s"] * 1e3,
                       "overload": res["overload"]}
            ticks += res["ticks"]
            saves += res["saves"]
            compactions += res["compactions"]
            del res
            # (b) replay from zero after the trim: a cold rt engine, no
            # snapshot; (c) the newest base torn, the same cold recovery
            # (both to the crash-time tick, after the resumed run)
            cold = {}
            for label in ("cold", "torn"):
                if label == "torn":
                    corrupt_base(log_dir, "rt")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng = SearchAssistanceEngine(cfg, "rt", dev)
                state, tick, info = restore_from_base(log_dir, "rt",
                                                      eng.state,
                                                      max_tick=end)
                eng.state = state
                t1 = time.perf_counter()
                st = CatchUpController(eng, FirehoseLogReader(log_dir),
                                       ReplayConfig(chunk_ticks=8)).catch_up(
                                           target_tick=end)
                torch.cuda.synchronize()
                fresh[label] = (time.perf_counter() - t0) * 1e3
                want = newest if label == "cold" else last["prev_floor"]
                if tick != want or info["fell_back"] != (label == "torn") \
                        or not arrays_bits_equal(eng.state_arrays(),
                                                 copies["rt"]):
                    raise AssertionError(f"flash crowd: {label} recovery "
                                         f"from base {tick} ({info}) differs")
                cold[label] = {"base": tick, "fell_back": info["fell_back"],
                               "ticks_replayed": st["n_ticks"],
                               "restore_ms": (t1 - t0) * 1e3,
                               "replay_ms": (st["wall_s"] - st["rank_s"])
                               * 1e3, "rank_ms": st["rank_s"] * 1e3}
                del eng, state
                torch.cuda.empty_cache()
            del copies
            peak = torch.cuda.max_memory_allocated() / 2**30

    finally:
        undo_spies()
        undo_pin()
    launches = dict(tk.LAUNCHES)
    missing = [n for n in FLASH_KERNELS if launches[n] <= 0]
    if missing:
        raise AssertionError(f"flash crowd: kernels not launched: {missing}")
    base_ticks = [r for r in ticks if r["t"] < FLASH_SPIKE_AT]
    spike_ticks = [r for r in ticks if r["t"] >= FLASH_SPIKE_AT]
    by_kind = {}
    for s in saves:
        for e in ("rt", "bg"):
            by_kind.setdefault(f"{e} {s[e]['kind']}", []).append(s[e]["ms"])
    report = {
        "card": card, "base_step_ms": base_ms, "slo_ms": slo_ms,
        "tick_ms": FLASH_TICK_MS,
        "crash_at": FLASH_CRASH_AT, "last_tick": FLASH_TICKS - 1,
        "pinned_from": pinned["from"],
        "stack_tick_ms": {"base": _ms_stats([r["stack_ms"]
                                             for r in base_ticks]),
                          "spike": _ms_stats([r["stack_ms"]
                                              for r in spike_ticks])},
        "step_ms_live": {k: ov[k] for k in ("step_p50_ms", "step_p95_ms",
                                            "step_p99_ms")},
        "level_ticks": ov["level_ticks"],
        "n_escalations": ov["n_escalations"],
        "n_deescalations": ov["n_deescalations"],
        "levels": levels,
        "shed": {k: ov[k] for k in ("n_shed_events", "n_shed_tweets",
                                    "n_shed_rank_rt", "n_shed_rank_bg",
                                    "n_rank_run_rt", "n_rank_run_bg",
                                    "n_shed_total")},
        "flushes": ov["n_flushes"], "flush_ticks": ov["n_flush_ticks"],
        "per_tick": [{"t": r["t"], "level": r["overload"]["level"],
                      "lag": round(r["overload"]["lag_hint"], 3),
                      "backlog": r["overload"]["backlog"],
                      "steps_ms": round(r["steps_ms"], 3),
                      "persist_ms": round(r["persist_ms"], 3),
                      "compact_ms": round(r["compact_ms"], 3)}
                     for r in ticks],
        "compactions": [{
            "t": x["t"], "floor": x["stats"].get("floor"),
            "retain_floor": x["stats"].get("retain_floor"),
            "segments_dropped": x["stats"].get("n_segments_dropped"),
            "wall_ms": x["stats"].get("wall_s", 0.0) * 1e3,
            "engines": {e: {"start": v["start"], "ticks": v["n_ticks"],
                            "restore_ms": v["restore_s"] * 1e3,
                            "replay_ms": v["replay_s"] * 1e3,
                            "save_ms": v["save_s"] * 1e3,
                            "base_raw_bytes": v["base_raw_bytes"],
                            "base_bytes": v["base_bytes"]}
                        for e, v in x["stats"].get("engines", {}).items()},
            "log_bytes_before": x["bytes_before"],
            "log_bytes_after": x["bytes_after"]} for x in compactions],
        "save_ms": {k: _ms_stats(v) for k, v in by_kind.items()},
        "recovery_through_base": recovery, "cold": cold,
        "time_to_fresh_ms": fresh, "rank_period_ms": rank_period_ms,
        "resumed": resumed, "rt_lag_ticks": metrics["rt_lag_ticks"],
        "bg_lag_ticks": metrics["bg_lag_ticks"],
        "answer": {"query": serve_assist.FIREHOSE_HEAD, "tick": route.tick,
                   "suggestions": route.suggestions},
        "walls_s": walls, "peak_mem_gib": peak,
        "launches": {n: k for n, k in launches.items() if k}}
    log(f"[9] flash crowd ({card}): " + json.dumps(report))
    for line in lines:
        if any(w in line for w in ("CRASH", "recover", "compacted",
                                   "related", "[done]")):
            log("  " + line.strip())
    for kind in ("base", "spike"):
        st = report["stack_tick_ms"][kind]
        log(f"  flash crowd ({card}): {kind} ticks, ms per stack tick p50 "
            f"{st['p50']:.3f}, p99 {st['p99']:.3f}, max {st['max']:.3f} "
            f"(n {st['n']})")
    log(f"  flash crowd ({card}): live step p50/p95/p99 "
        f"{report['step_ms_live']}; ticks at levels 0-3 {ov['level_ticks']},"
        f" {ov['n_escalations']} escalations, {ov['n_deescalations']} "
        f"de-escalations"
        + (f"; LADDER PINNED at level 3 from tick {pinned['from']} (the "
           f"live triggers had not reached it)" if pinned["from"] is not None
           else "; every rung reached by the live triggers")
        + f"; shed {report['shed']}; {ov['n_flushes']} flushes for "
        f"{ov['n_flush_ticks']} ticks")
    for level, lv in levels.items():
        log(f"  flash crowd: level {level}: {lv} (offered = logged + shed)")
    for x in report["compactions"]:
        log(f"  flash crowd ({card}): compaction at tick {x['t']}: floor "
            f"{x['floor']}, retained from {x['retain_floor']}, "
            f"{x['segments_dropped']} segments dropped, "
            f"{x['wall_ms']:.3f} ms; log bytes on disk "
            f"{x['log_bytes_before']} -> {x['log_bytes_after']}; "
            + "; ".join(f"{e} from {v['start']} ({v['ticks']} ticks): "
                        f"restore {v['restore_ms']:.3f} + replay "
                        f"{v['replay_ms']:.3f} + save {v['save_ms']:.3f} ms,"
                        f" base {v['base_raw_bytes']} B raw, "
                        f"{v['base_bytes']} B on disk"
                        for e, v in x["engines"].items()))
    for k, v in report["save_ms"].items():
        log(f"  flash crowd ({card}): {k} save ms mean {v['mean']:.3f} "
            f"(n {v['n']}, max {v['max']:.3f})")
    log(f"  flash crowd ({card}): time to fresh against the "
        f"{rank_period_ms:.0f}-ms rank period: recover_service through the "
        f"tick-{newest} base {fresh['base']:.3f} ms ({recovery}); cold rt "
        f"from the base {fresh['cold']:.3f} ms; torn newest base, fell back "
        f"to {cold['torn']['base']}: {fresh['torn']:.3f} ms ({cold}); all "
        f"bit-exact against the drained engines at tick {FLASH_CRASH_AT + 1}")
    log(f"  flash crowd ({card}): resumed from tick {resumed['from_tick']}:"
        f" {resumed['recover']}, {resumed['time_to_fresh_ms']:.3f} ms to "
        f"fresh; '{serve_assist.FIREHOSE_HEAD}' at tick {route.tick}: "
        f"{route.suggestions}; rt_lag_ticks {metrics['rt_lag_ticks']}, "
        f"bg_lag_ticks {metrics['bg_lag_ticks']}; peak {peak:.3f} GiB")
    log(f"  flash crowd launches: {report['launches']}")
    (a, kw), grid = kept["score_gate"], kept["bucket_topk"]
    log("[9] score_gate and bucket_topk on the inputs of the phase's last "
        "rank cycle (held against their plain versions)")
    lanes = check_score_path_lanes((a, kw), None, floor,
                                   "flash crowd, last rank cycle's lanes")
    log(f"  score_gate at the flash crowd's last lanes: "
        f"{json.dumps(lanes['score_gate'])}")
    topk = check_bucket_topk_path_grid("flash crowd, last rank cycle",
                                       *grid)
    log(f"  bucket_topk at the flash crowd's last grid: {json.dumps(topk)}")
    del kept
    torch.cuda.empty_cache()
    log(f"  flash crowd phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 10: tuning and the oracle at deployment scale.
# ---------------------------------------------------------------------------

TUNE_TICKS = 17               # phase 4's stream: 4 sweeps, 2 rank cycles
ASSIST_TICKS = 13             # serve_assist --autotune: one rank cycle (12)


def tune_cell(dev, layout, cache):
    """(a), (b): ``autotune.tune`` for a deployment cell into ``cache``
    (fresh): the shape class, each op's kernel and twin µs, each kernel's
    roofline fraction under the JAX tuner's traffic model at the
    ``launch/mesh`` peaks, and the plan; every op of the layout must say
    "kernel" and launch its kernel. Then a second tune must hit the cache:
    the same plan, no launch. Returns (plan, launches of the first
    tune)."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core.plan import LAYOUT_OPS, OP_KERNELS
    from repro_torch.launch import autotune
    from repro_torch.launch.roofline import hot_path_roofline
    cfg, _ = deployment_config(layout)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launches()
    t0 = time.perf_counter()
    plan = autotune.tune(cfg, device=dev, cache=cache)
    wall = time.perf_counter() - t0
    launches = dict(tk.LAUNCHES)
    rec = json.loads(autotune.cache_path(cfg, dev, cache).read_text())
    tim = rec["timings_us"]
    traffic = autotune.hot_path_traffic(cfg)
    ops = LAYOUT_OPS[layout]
    log(f"[10] tune {layout}: shape class {rec['shape_class']}; "
        f"{wall:.1f} s; peak {torch.cuda.max_memory_allocated() / 2**30:.3f}"
        f" GiB; launches {launches}")
    for op in ops:
        k, j = tim[f"{op}:kernel"], tim[f"{op}:jnp"]
        row = hot_path_roofline(op, bytes_touched=traffic[op]["bytes"],
                                flops=traffic[op]["flops"], measured_us=k)
        ceil_ms = max(row["t_memory_s"], row["t_compute_s"]) * 1e3
        log(f"  {layout} {op}: kernel {k!r} us, twin {j!r} us (twin / "
            f"kernel {j / k:.2f}); JAX model {traffic[op]['bytes']!r} B, "
            f"{traffic[op]['flops']!r} flops: ceiling {ceil_ms!r} ms "
            f"({row['bottleneck']}), roofline fraction "
            f"{row['roofline_fraction']!r}")
    log(f"  {layout} plan: {plan.to_json()}; twin faster than kernel: "
        f"{rec['twin_faster']}")
    bad = [op for op in ops if getattr(plan, op) != "kernel"]
    missing = [op for op in ops if launches[OP_KERNELS[op]] <= 0]
    if bad or missing:
        raise AssertionError(f"{layout} tuning: ops not 'kernel' {bad}, "
                             f"kernels not launched {missing}")
    tk.reset_launches()
    t0 = time.perf_counter()
    again = autotune.tune(cfg, device=dev, cache=cache)
    hit_ms = (time.perf_counter() - t0) * 1e3
    if again != plan or any(tk.LAUNCHES.values()):
        raise AssertionError(f"{layout} second tune: {again} with launches "
                             f"{tk.LAUNCHES}")
    log(f"  {layout} second tune: a cache hit in {hit_ms:.3f} ms, the same "
        f"plan, 0 launches")
    return plan, launches


def reference_against_card(dev, ticks) -> dict:
    """(c): the hash cell's ticks on the card, and the port's
    ``ReferenceEngine`` over the same ticks, its LLR term in the engine's
    float32 with the card's float32 log, held against the card's engine
    under the parity contract; the sources the ranking caps are counted
    and printed. Then, printed only, the same state ranked with correctly
    rounded logs and with the float64 LLR. Returns the launches of the
    card's run."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core.engine import SearchAssistanceEngine
    from repro_torch.core.reference import (ReferenceEngine, log_rounded,
                                            parity_report)
    cfg, _ = deployment_config("hash")
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launches()
    eng = SearchAssistanceEngine(cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ev, tw in ticks:
        eng.step(ev, tw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(ticks)
    launches = dict(tk.LAUNCHES)
    log(f"[10] hash engine on the card, {len(ticks)} ticks: {ms:.3f} ms a "
        f"tick; peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
        f"launches {launches}")
    def card_log(v):           # the card's float32 log, the engine's libm
        return torch.log(torch.from_numpy(v).to(dev)).cpu().numpy()

    ref = ReferenceEngine(cfg, llr_f32=True, log_f32=card_log)
    tick_s = []
    for ev, tw in ticks:
        t0 = time.perf_counter()
        ref.step(ev, tw)
        tick_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    rep = parity_report(eng, ref)
    cmp_s = time.perf_counter() - t0
    log(f"[10] reference over the hash cell's {len(ticks)} ticks: wall "
        f"{sum(tick_s):.3f} s (per tick {[round(x, 3) for x in tick_s]}); "
        f"report {cmp_s:.3f} s")
    for part in ("qstore", "cooc", "sessions", "drops", "suggestions"):
        log(f"  reference vs card, {part}: {json.dumps(rep[part])}")
    sg = rep["suggestions"]
    log(f"  keys exact: qstore {rep['qstore']['only_engine']} + "
        f"{rep['qstore']['only_reference']}, cooc "
        f"{rep['cooc']['only_engine']} + {rep['cooc']['only_reference']} "
        f"keys on one side only ({rep['qstore']['flips']} + "
        f"{rep['cooc']['flips']} prune-threshold flips); weights within "
        f"2e-3 (max rel {rep['qstore']['weight_max_rel']!r}, "
        f"{rep['cooc']['weight_max_rel']!r}), counts within 1e-5; top-3 "
        f"agreement {sg['agree_share']!r} of {sg['compared']} sources "
        f"(at least 0.95); top-3 scores outside rtol 5e-3, atol 1e-4 "
        f"(reference LLR {sg['reference_llr']}): {sg['score_out']} sources "
        f"(max |diff| {sg['score_max_abs_diff']!r}); capped by bucket_rows "
        f"{sg['capped']['bucket_rows']} ({sg['capped_disagree']} of them "
        f"disagree), by source_cap {sg['capped']['source_cap']}, by the "
        f"arena {sg['capped']['arena']}")
    # what the card's logs and the float32 LLR take out: the same state
    # (after tick 16's sweep) ranked again (printed, not held)
    for f32, lg in ((True, log_rounded), (False, log_rounded)):
        ref.llr_f32, ref.log_f32 = f32, lg
        ref.rank_cycle()
        other = parity_report(eng, ref)["suggestions"]
        log(f"  against the reference with LLR {other['reference_llr']} "
            f"instead: top-3 agreement {other['agree_share']!r}; "
            f"{other['score_out']} sources outside rtol 5e-3, atol 1e-4 "
            f"(max |diff| {other['score_max_abs_diff']!r})")
    log("  region cell not held against the reference: it drops pair "
        "updates at this scale (phase 4), which the reference keeps")
    if not rep["ok"]:
        raise AssertionError(f"reference vs card: {rep['faults']}")
    return launches


def assist_autotune(dev, cache) -> dict:
    """(d): ``python -m repro_torch.launch.serve_assist --autotune`` for
    a few ticks on the card (in process, its cache in ``cache``): the
    frontend's ``metrics()["tuned_variants"]`` must equal the printed
    plan. Returns the launches of the run."""
    import ast
    import contextlib
    import io
    import os
    import tempfile
    from repro_torch import kernels as tk
    from repro_torch.launch import autotune, serve_assist
    from repro_torch.serving.serve import SuggestFrontend
    out = io.StringIO()
    env = os.environ.get(autotune.CACHE_ENV)
    os.environ[autotune.CACHE_ENV] = cache
    tk.reset_launches()
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_assist_") as tmp, \
                contextlib.redirect_stdout(out):
            serve_assist.main(["--ticks", str(ASSIST_TICKS), "--autotune",
                               "--out", tmp])
            fe = SuggestFrontend(os.path.join(tmp, "rt"))
            fe.poll()
            metrics = fe.metrics()
    finally:
        if env is None:
            os.environ.pop(autotune.CACHE_ENV)
        else:
            os.environ[autotune.CACHE_ENV] = env
    wall = time.perf_counter() - t0
    launches = dict(tk.LAUNCHES)
    lines = out.getvalue().splitlines()
    line = next(x for x in lines if x.startswith("[assist] tuned plan: "))
    printed = ast.literal_eval(line.split(": ", 1)[1])
    log(f"[10] serve_assist --autotune, {ASSIST_TICKS} ticks on the card: "
        f"{wall:.1f} s; {line}; metrics()['tuned_variants'] "
        f"{metrics['tuned_variants']}; rt_tick {metrics['rt_tick']}; "
        f"launches {launches}")
    for x in lines:
        if x.startswith("[t=12]"):
            log(f"  {x}")
    if metrics["tuned_variants"] != printed or \
            {printed[op] for op in ("score_gate", "bucket_topk",
                                    "decay_prune")} != {"kernel"}:
        raise AssertionError(f"serve_assist --autotune: printed {printed}, "
                             f"metrics {metrics['tuned_variants']}")
    return launches


def run_tuning(dev, card: str, ticks=None) -> dict:
    """Phase 10: (a), (b) tune both deployment cells into a fresh cache;
    (c) the reference against the card's hash engine over the cell's 17
    ticks; (d) serve_assist --autotune. ``ticks``: phase 4's stream, or
    made here. Returns the phase's launch counts."""
    import gc
    import tempfile
    import torch
    from repro_torch import kernels as tk
    from repro_torch.data.stream import SyntheticStream
    t_phase = time.perf_counter()
    if ticks is None:
        _, scfg = deployment_config()
        stream = SyntheticStream(scfg, seed=SEED)
        ticks = [stream.gen_tick(t) for t in range(TUNE_TICKS)]
        log(f"[10] stream: {TUNE_TICKS} ticks generated in "
            f"{time.perf_counter() - t_phase:.1f} s")
    total = {n: 0 for n in tk.KERNELS}

    def add(launches):
        for n, v in launches.items():
            total[n] += v

    log(f"[10] tuning and the oracle ({card})")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as cache:
        for layout in ("hash", "region"):
            add(tune_cell(dev, layout, cache)[1])
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  after tuning: {torch.cuda.memory_allocated() / 2**30:.3f} "
            f"GiB held")
        add(reference_against_card(dev, ticks))
        gc.collect()
        torch.cuda.empty_cache()
        add(assist_autotune(dev, cache))
    log(f"  tuning launches: {total}")
    log(f"  tuning phase took {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# Phase 11: the self-healing replicated fleet at deployment scale.
# ---------------------------------------------------------------------------

# The chaos schedule of tests/test_fleet.py at the hash cell's widths:
# three replicas under serve_assist's firehose workload (1,024 queries and
# 64 tweets a tick at base, a 50x spike from tick 4 capped at 16,384 and
# 2,048, spam bursts, seed 0); replica 2 answers through a 0.05-s slow
# disk against a 0.01-s client timeout until the kills; the leader dies
# mid-segment at tick 7, follower 2 at tick 12; the run goes to tick 24
# and on until every replica is live (at most 16 ticks more). The spam
# burst of ticks 0-2 and each change of a tick's array sizes seal a
# segment early (4 ticks a segment otherwise): with the spike's first full
# tick at 5 the dying leader's writer holds ticks 5 and 6, which it tears.
# (From tick 6 on, its writer would hold nothing at tick 7.)
FLEET_SPIKE_AT = 4
FLEET_KILL_LEADER_AT = 7
FLEET_KILL_FOLLOWER_AT = 12
FLEET_TICKS = 24
FLEET_EXTRA_TICKS = 16
FLEET_SLOW_S = 0.05
FLEET_TIMEOUT_S = 0.01
FLEET_KERNELS = FLASH_KERNELS
# serve_assist --fleet at the launcher's own settings (default_configs()).
FLEET_CLI_ARGV = ("--fleet", "3", "--kill-leader-at", "7",
                  "--kill-follower-at", "12", "--workload", "firehose",
                  "--spike-at", "6", "--compact-every", "8", "--keep-bases",
                  "2", "--ticks", "24")
FLEET_DONE = re.compile(
    r"\[done\] fleet: (\d+) requests \((\d+) hedged\), (\d+) failovers, "
    r"(\d+) recoveries, log healed (\d+) ticks \((\d+) lost\), epoch "
    r"(\d+), (\d+) compactions \(floor=(\S+)\)")


def _fleet_timers(fleet, restarts, saves):
    """Time each restart (``recover_service`` and the device memory after
    it) and each leader save per engine, through the fleet's own calls."""
    import torch
    restart = fleet._restart

    def timed_restart(rep):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restart(rep)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        st = rep.last_recovery
        restarts.append({
            "rid": rep.rid, "time_to_fresh_ms": ms,
            **{e: {"snapshot": st[e]["restored_step"],
                   "restore_ms": st[e]["restore_s"] * 1e3,
                   "ticks_replayed": st[e]["n_ticks"],
                   "replay_ms": (st[e]["wall_s"] - st[e]["rank_s"]) * 1e3,
                   "rank_ms": st[e]["rank_s"] * 1e3} for e in ("rt", "bg")},
            "allocated_gib": torch.cuda.memory_allocated() / 2**30,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30})

    fleet._restart = timed_restart
    for label, ck in (("rt", fleet.rt_ckpt), ("bg", fleet.bg_ckpt)):
        def timed_save(step, *a, _save=ck.save, _ck=ck, _label=label, **kw):
            t0 = time.perf_counter()
            out = _save(step, *a, **kw)
            saves.append({"engine": _label, "step": step,
                          "kind": _ck.last_save_kind,
                          "bytes": _ck.last_save_bytes,
                          "ms": (time.perf_counter() - t0) * 1e3})
            return out
        ck.save = timed_save


def fleet_chaos(dev, card: str):
    """Phase 11(a): the chaos run on the hash cell, against an
    uninterrupted service stepping the same ticks. Returns the fleet's
    launch counts (the reference's subtracted) and the report."""
    import os
    import tempfile
    import numpy as np
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core.background import AssistanceService
    from repro_torch.distributed.fleet import FleetConfig, ServingFleet
    from repro_torch.launch import serve_assist
    from repro_torch.streaming import (FirehoseLogReader, FirehoseLogWriter,
                                       WriterFencedError, log_epoch, slow_io)
    cfg, _ = deployment_config("hash")
    rank_period_ms = cfg.rank_every * 10.0 * 1e3     # 10-s ticks
    wl = serve_assist.firehose_workload(FLEET_SPIKE_AT, 50.0)
    head = serve_assist.FIREHOSE_HEAD
    fcfg = FleetConfig(n_replicas=3, heartbeat_timeout=2, restart_after=1,
                       snapshot_every=8, ticks_per_segment=4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    restarts, saves, ticks = [], [], []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        fleet = ServingFleet(tmp, cfg, fcfg, device=dev)
        ref = AssistanceService(cfg, bg_cfg=fleet.bg_cfg, device=dev)
        _fleet_timers(fleet, restarts, saves)
        ss = fleet.serverset(timeout_s=FLEET_TIMEOUT_S, max_retries=1)
        slow_io(fleet.handles[2], ("related",), delay_s=FLEET_SLOW_S)
        all_live = lambda: all(r.status == "live" for r in fleet._replicas)
        tk.reset_launches()
        ref_launches = {n: 0 for n in tk.KERNELS}
        kills, torn = {}, None
        t = 0
        while t < FLEET_TICKS or (t < FLEET_TICKS + FLEET_EXTRA_TICKS
                                  and not all_live()):
            ev, tw = wl.gen_tick(t)
            if t == FLEET_KILL_LEADER_AT:
                fleet.handles[2]._slow_io_undo()
                if fleet.leader() != 0:
                    raise AssertionError(f"fleet: leader {fleet.leader()}")
                torn = fleet.kill(0, mid_segment=True)
                kills[0] = t
            if t == FLEET_KILL_FOLLOWER_AT:
                if fleet._replicas[2].status != "live" or \
                        fleet.leader() == 2:
                    raise AssertionError(f"fleet: {fleet.metrics()}")
                fleet.kill(2)
                kills[2] = t
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            info = fleet.offer_tick(t, ev, tw)
            torch.cuda.synchronize()
            offer_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            route = ss.request_info(head)   # raises iff no replica answers
            request_ms = (time.perf_counter() - t0) * 1e3
            ticks.append({"t": t, "queries": int(np.asarray(ev.valid).sum()),
                          "tweets": int(np.asarray(tw.valid).sum()),
                          "info": info, "offer_ms": offer_ms,
                          "request_ms": request_ms, "replica": route.replica,
                          "hedged": route.hedged,
                          "rows": len(route.suggestions)})
            before = dict(tk.LAUNCHES)
            ref.step(ev, tw)
            for n in tk.KERNELS:
                ref_launches[n] += tk.LAUNCHES[n] - before[n]
            t += 1
        launches = {n: tk.LAUNCHES[n] - ref_launches[n] for n in tk.KERNELS}
        m = fleet.metrics()
        if not all_live() or torn is None or m["n_deaths_detected"] != 2 \
                or m["n_recoveries"] != 2 or m["n_failovers"] != 2 \
                or m["epoch"] != 2 or m["leader"] != 0 \
                or m["n_lost_ticks"] != 0 or m["n_healed_ticks"] < 3:
            raise AssertionError(f"fleet: metrics {m}, torn {torn}")
        if ss.n_requests != t or ss.n_timeouts <= 0:
            raise AssertionError(f"fleet: {ss.n_requests} requests over {t} "
                                 f"ticks, {ss.n_timeouts} timeouts")
        fleet._replicas[fleet.leader()].writer.flush()
        reader = FirehoseLogReader(fleet.log_dir)
        logged = [tk_ for tk_, _, _ in reader.read_ticks(0)]
        if logged != list(range(t)):
            raise AssertionError(f"fleet: the log is not gap-free: {logged}")
        # the fenced zombie: an ex-leader writer at epoch 0 wakes up
        segs = [(x.first, x.last, x.sha256) for x in reader.segments]
        zombie = FirehoseLogWriter(fleet.log_dir, ticks_per_segment=4,
                                   epoch=0)
        try:
            zombie.append(t + 100, ev, tw)
            raise AssertionError("fleet: the zombie's append landed")
        except WriterFencedError as e:
            fenced = str(e)
        if log_epoch(fleet.log_dir) != 2 or [
                (x.first, x.last, x.sha256)
                for x in reader.refresh().segments] != segs:
            raise AssertionError("fleet: the zombie moved the manifest")
        # every replica, leaf by leaf, bit for bit the uninterrupted service
        want = {"rt": ref.rt.state_arrays(), "bg": ref.bg.state_arrays()}
        service_bytes = sum(a.nbytes for w in want.values()
                            for a in w.values())
        for rep in fleet._replicas:
            for e in ("rt", "bg"):
                got = getattr(rep.service, e).state_arrays()
                if not arrays_bits_equal(got, want[e]):
                    raise AssertionError(f"fleet: replica {rep.rid} {e} "
                                         f"differs from the reference")
                del got
        n_restarts = [r.n_restarts for r in fleet._replicas]
        routed = {k: getattr(ss, k) for k in ("n_requests", "n_hedged",
                                              "n_timeouts")}
        peak = torch.cuda.max_memory_allocated() / 2**30
        del want, ref, fleet, ss, reader, zombie
    torch.cuda.empty_cache()
    missing = [n for n in FLEET_KERNELS if launches[n] <= 0]
    if missing:
        raise AssertionError(f"fleet: kernels not launched: {missing}")
    if n_restarts != [1, 0, 1] or len(restarts) != 2:
        raise AssertionError(f"fleet: restarts {n_restarts}, {restarts}")
    # a killed service is freed before its restart: the second restart
    # holds no more than the first (the same four services live)
    climb = restarts[1]["allocated_gib"] - restarts[0]["allocated_gib"]
    if climb * 2**30 > service_bytes / 2:
        raise AssertionError(f"fleet: device memory climbs with restarts: "
                             f"{[r['allocated_gib'] for r in restarts]} GiB,"
                             f" a service holds {service_bytes / 2**30:.3f}")
    died = {r: x["t"] for x in ticks for r in x["info"]["died"]}
    back = {r: x["t"] for x in ticks for r in x["info"]["recovered"]}
    window = [x for x in ticks if min(kills.values()) <= x["t"]
              <= max(back.values())]
    base = [x for x in ticks if x["t"] < FLEET_SPIKE_AT]
    spike = [x for x in ticks if x["t"] >= FLEET_SPIKE_AT]
    report = {
        "card": card, "ticks": t, "fleet": dataclasses.asdict(fcfg),
        "metrics": m,
        **routed, "n_failed_requests": 0,
        "offer_tick_ms": {"base": _ms_stats([x["offer_ms"] for x in base]),
                          "spike": _ms_stats([x["offer_ms"]
                                              for x in spike])},
        "request_ms": {"run": _ms_stats([x["request_ms"] for x in ticks]),
                       "failover_window": _ms_stats(
                           [x["request_ms"] for x in window]),
                       "window_ticks": [window[0]["t"], window[-1]["t"]]},
        "kill_to_detection_ticks": {r: died[r] - k for r, k in kills.items()},
        "detection_to_readmission_ticks": {r: back[r] - died[r]
                                           for r in kills},
        "restarts": restarts, "rank_period_ms": rank_period_ms,
        "saves": saves, "peak_mem_gib": peak,
        "service_gib": service_bytes / 2**30, "torn": torn,
        "zombie": fenced, "launches": {n: k for n, k in launches.items()
                                       if k},
        "reference_launches": {n: k for n, k in ref_launches.items() if k},
        "per_tick": [{"t": x["t"], "queries": x["queries"],
                      "tweets": x["tweets"], "died": x["info"]["died"],
                      "recovered": x["info"]["recovered"],
                      "appended": x["info"]["appended"],
                      "offer_ms": round(x["offer_ms"], 3),
                      "request_ms": round(x["request_ms"], 3),
                      "replica": x["replica"], "hedged": x["hedged"],
                      "rows": x["rows"]} for x in ticks]}
    return launches, report


def fleet_cli(dev):
    """Phase 11(b): serve_assist --fleet at the launcher's own settings,
    its [done] line read back. Returns launch counts and the report."""
    import tempfile
    from repro_torch import kernels as tk
    from repro_torch.launch import serve_assist
    ecfg, scfg = serve_assist.default_configs()
    lines = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_cli_") as tmp:
        opts = serve_assist.options(list(FLEET_CLI_ARGV) + ["--out", tmp])
        tk.reset_launches()
        t0 = time.perf_counter()
        res = serve_assist.run_fleet(ecfg, scfg, opts, dev, log=lines.append)
        wall = time.perf_counter() - t0
        launches = dict(tk.LAUNCHES)
        offer = _ms_stats([x["offer_ms"] for x in res["ticks"]])
        del res
    (done,) = [m for m in map(FLEET_DONE.search, lines) if m]
    failovers, recoveries, lost, compactions = (
        int(done.group(i)) for i in (3, 4, 6, 8))
    if (failovers, recoveries, lost) != (2, 2, 0) or compactions < 1:
        raise AssertionError(f"fleet CLI: {done.group(0)}")
    missing = [n for n in FLEET_KERNELS if launches[n] <= 0]
    if missing:
        raise AssertionError(f"fleet CLI: kernels not launched: {missing}")
    return launches, {"argv": " ".join(FLEET_CLI_ARGV), "wall_s": wall,
                      "offer_tick_ms": offer, "lines": lines,
                      "launches": {n: k for n, k in launches.items() if k}}


def run_fleet(dev, card: str):
    """Phase 11: (a) the chaos run, (b) ``serve_assist --fleet``. Returns
    the phase's launch counts (the fleet's own, both runs)."""
    import torch
    t_phase = time.perf_counter()
    log(f"[11] the replicated fleet ({card}): 3 replicas on the hash cell, "
        f"the firehose workload (50x spike from tick "
        f"{FLEET_SPIKE_AT}), leader killed mid-segment at "
        f"{FLEET_KILL_LEADER_AT}, follower 2 at {FLEET_KILL_FOLLOWER_AT}, "
        f"full snapshots (no delta chain)")
    t0 = time.perf_counter()
    chaos_launches, rep = fleet_chaos(dev, card)
    rep["wall_s"] = time.perf_counter() - t0
    log(f"[11] fleet chaos ({card}): " + json.dumps(rep))
    m = rep["metrics"]
    for kind in ("base", "spike"):
        st = rep["offer_tick_ms"][kind]
        log(f"  fleet ({card}): {kind} ticks, ms per fleet tick "
            f"(offer_tick) p50 {st['p50']:.3f}, max {st['max']:.3f} "
            f"(n {st['n']})")
    for k, st in (("whole run", rep["request_ms"]["run"]),
                  (f"failover window, ticks {rep['request_ms']['window_ticks']}",
                   rep["request_ms"]["failover_window"])):
        log(f"  fleet ({card}): ServerSet.request ms over the {k}: p50 "
            f"{st['p50']:.4f}, p99 {st['p99']:.4f}, max {st['max']:.4f} "
            f"(n {st['n']})")
    log(f"  fleet: {rep['n_requests']} requests, 0 failed, "
        f"{rep['n_hedged']} hedged, {rep['n_timeouts']} timeouts; "
        f"{m['n_deaths_detected']} deaths detected, {m['n_recoveries']} "
        f"recoveries, {m['n_failovers']} failovers, epoch {m['epoch']}, "
        f"leader {m['leader']}, {m['n_healed_ticks']} ticks healed, "
        f"{m['n_lost_ticks']} lost; the log gap-free over {rep['ticks']} "
        f"ticks; the zombie refused ({rep['zombie']}); every replica bit for "
        f"bit the uninterrupted service")
    log(f"  fleet: ticks from kill to detection "
        f"{rep['kill_to_detection_ticks']}, from detection to readmission "
        f"{rep['detection_to_readmission_ticks']}")
    for r in rep["restarts"]:
        log(f"  fleet ({card}): restart of replica {r['rid']}: time to fresh "
            f"{r['time_to_fresh_ms']:.3f} ms of the "
            f"{rep['rank_period_ms']:.0f}-ms rank period; "
            + "; ".join(f"{e}: snapshot {r[e]['snapshot']}, restore "
                        f"{r[e]['restore_ms']:.3f} ms, "
                        f"{r[e]['ticks_replayed']} ticks replayed in "
                        f"{r[e]['replay_ms']:.3f} ms, handoff rank "
                        f"{r[e]['rank_ms']:.3f} ms" for e in ("rt", "bg"))
            + f"; device memory after it {r['allocated_gib']:.3f} GiB "
            f"allocated, peak {r['peak_gib']:.3f} GiB")
    for x in rep["saves"]:
        log(f"  fleet ({card}): leader save at tick {x['step'] - 1}, "
            f"{x['engine']}: {x['kind']}, {x['bytes']} B, {x['ms']:.3f} ms")
    log(f"  fleet: peak {rep['peak_mem_gib']:.3f} GiB (a service holds "
        f"{rep['service_gib']:.3f} GiB of state); launches "
        f"{rep['launches']} (the reference's {rep['reference_launches']} "
        f"not counted)")
    log(f"  fleet chaos took {rep['wall_s']:.1f} s")
    cli_launches, cli = fleet_cli(dev)
    log(f"[11] serve_assist {cli['argv']} ({card}), default_configs(): "
        f"{cli['wall_s']:.1f} s, offer_tick ms {json.dumps(cli['offer_tick_ms'])},"
        f" launches {cli['launches']}")
    for line in cli["lines"]:
        log("  " + line.strip())
    torch.cuda.empty_cache()
    log(f"  fleet phase took {time.perf_counter() - t_phase:.1f} s")
    return {n: chaos_launches[n] + cli_launches[n] for n in chaos_launches}


# ---------------------------------------------------------------------------
# Phase 12: the sharded engine on one card.
# ---------------------------------------------------------------------------

# The hash cell's widths under ShardedConfig's defaults (4 salts, hot at a
# count of 50, 4,096 pairs a bucket), 8 shards, over the engine cell's
# query hose (16,384 queries a tick, no tweets: the sharded engine ingests
# the query hose only). A shard sends at most 16,384 x 4 / 8 = 8,192
# pairs a tick, ~1,024 a bucket. The sharded engine ingests a tick whole,
# as the JAX one does, so the unsharded engine it is held against takes
# ingest_quantum 0.
SHARDED_N = 8
SHARDED_TICKS = 17
SHARDED_RANK_AT = (8, 16)
SHARDED_SNAPSHOT_AT = (4, 8)   # (b): full, then delta; the crash after 8
SHARDED_SPLIT_AT = 12          # (c): the old state serves ticks 12-13
SHARDED_KERNELS = {"hash": ("decay_prune_multi", "score_gate", "bucket_topk"),
                   "region": ("region_rank", "chain_find", "bucket_topk")}


def sharded_config(layout="hash", lazy=False):
    """(ShardedConfig, StreamConfig) of phase 12."""
    from repro_torch.core.decay import DecayConfig
    from repro_torch.core.sharded_engine import ShardedConfig
    cfg, scfg = deployment_config(layout)
    kw = dict(decay=DecayConfig(policy="lazy"), prune_every=8) if lazy else {}
    return (ShardedConfig(base=dataclasses.replace(cfg, ingest_quantum=0,
                                                   **kw)),
            dataclasses.replace(scfg, tweets_per_tick=0))


def sharded_events(stream_cfg, n_ticks):
    from repro_torch.data.stream import SyntheticStream
    stream = SyntheticStream(stream_cfg, seed=SEED)
    return [stream.gen_tick(t)[0] for t in range(n_ticks)]


def hose(ev):
    """One tick's query hose as the sharded steps take it (host lanes)."""
    import numpy as np
    from repro_torch.core.hashing import split_fp
    s_hi, s_lo = split_fp(ev.sess_fp)
    q_hi, q_lo = split_fp(ev.q_fp)
    return s_hi, s_lo, q_hi, q_lo, np.asarray(ev.src, np.int32), \
        np.asarray(ev.valid, bool)


def _synced_ms(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def fragmented_sources(state):
    """Sources (fp64) with a (src, dst) pair held by more than one hash
    shard: the pairs a source salted after it crossed hot_threshold live
    apart from its earlier ones, and the merge takes their max."""
    import numpy as np
    from repro_torch.core.hashing import join_fp
    from repro_torch.core.stores import export_live
    src, dst = [], []
    for c in state.cooc:
        e = export_live(c)
        src.append(join_fp(e["src_hi"], e["src_lo"]))
        dst.append(join_fp(e["dst_hi"], e["dst_lo"]))
    src, dst = np.concatenate(src), np.concatenate(dst)
    order = np.lexsort((dst, src))
    s, d = src[order], dst[order]
    dup = (s[1:] == s[:-1]) & (d[1:] == d[:-1])
    return set(s[1:][dup].tolist())


def capped_sources(coocs, qstore, rank_cfg):
    """Sources (fp64) with more than ``bucket_rows`` gate-passing rows in
    one hash store, by the rank cycle's own score and gate: the bucket
    arena keeps their coarse-score best (``core/reference.py``'s capped
    sources). Its ``score_gate`` launches are taken back out of the
    counts."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core import ranking
    from repro_torch.core.hashing import u32
    L = max(rank_cfg.bucket_rows, rank_cfg.top_k)
    before = dict(tk.LAUNCHES)
    out = set()
    for c in coocs:
        _, ok, _, (s_hi, s_lo, _, _) = ranking._score_and_gate(
            c, qstore, rank_cfg, None, None)
        key = (u32(s_hi[ok]) << 32) | u32(s_lo[ok])
        uniq, cnt = torch.unique(key, return_counts=True)
        out |= {k & (2**64 - 1) for k in uniq[cnt > L].tolist()}
    tk.LAUNCHES.update(before)
    return out


def hold_sharded_suggestions(merged, ref, fragmented, capped, label):
    """Equal key sets; top-3 scores within rtol 5e-3, atol 1e-4 for every
    source neither fragmented nor capped (on either side); those two
    counted apart, with how many leave the contract and the worst relative
    difference of their top-3 scores."""
    import numpy as np
    if set(merged) != set(ref) or not merged:
        raise AssertionError(f"sharded {label}: {len(merged)} sources, the "
                             f"unsharded engine {len(ref)}")
    held = 0
    apart = {"fragmented": [0, 0, 0.0], "capped": [0, 0, 0.0]}
    for f in merged:
        ms = sorted((s for _, s in merged[f]), reverse=True)[:3]
        rs = sorted((s for _, s in ref[f]), reverse=True)[:3]
        ok = len(ms) == len(rs) and np.allclose(ms, rs, rtol=5e-3, atol=1e-4)
        why = ("fragmented" if f in fragmented
               else "capped" if f in capped else None)
        if why is None:
            if not ok:
                raise AssertionError(f"sharded {label}: source {f} top-3 "
                                     f"{ms}, unsharded {rs}")
            held += 1
            continue
        n = apart[why]
        n[0] += 1
        n[1] += not ok
        if len(ms) == len(rs):
            n[2] = max(n[2], float(np.max(np.abs(np.subtract(ms, rs))
                                          / np.abs(rs))))
    return dict(sources=len(merged), held=held, **{
        f"{k}{sfx}": v[i] for k, v in apart.items()
        for i, sfx in enumerate(("", "_off", "_worst_rel"))})


def pair_difference(pairs, exp, threshold):
    """export_sharded_pairs against the unsharded export_live: keys on one
    side only, those within 2e-3 of the prune threshold (prune flips), and
    the largest relative weight difference over the common keys."""
    import numpy as np
    from repro_torch.core.hashing import join_fp

    def keyed(e):
        k = np.stack([join_fp(e["src_hi"], e["src_lo"]),
                      join_fp(e["dst_hi"], e["dst_lo"])], 1)
        return np.ascontiguousarray(k).view([("s", "u8"), ("d", "u8")]) \
            .ravel(), e["weight"]

    ka, wa = keyed(pairs)
    kb, wb = keyed(exp)
    common, ia, ib = np.intersect1d(ka, kb, return_indices=True)
    only_a = np.setdiff1d(np.arange(ka.size), ia)
    only_b = np.setdiff1d(np.arange(kb.size), ib)
    near = lambda w: int((np.abs(w - threshold) <= 2e-3 * threshold).sum())
    rel = np.abs(wa[ia] - wb[ib]) / np.maximum(np.abs(wb[ib]), 1e-30)
    return dict(sharded=int(ka.size), unsharded=int(kb.size),
                common=int(common.size), sharded_only=int(only_a.size),
                unsharded_only=int(only_b.size),
                prune_flips=near(wa[only_a]) + near(wb[only_b]),
                max_rel_weight_diff=float(rel.max()) if rel.size else 0.0,
                common_weight_exact=int((wa[ia] == wb[ib]).sum()))


def sharded_hash(dev, card):
    """Phase 12(a): the sharded hash path against the unsharded engine.
    Returns (launches, report, final state)."""
    import numpy as np
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core import sharded_engine as se
    from repro_torch.core.engine import SearchAssistanceEngine, table_leaves
    from repro_torch.core.stores import export_live
    scfg, stream_cfg = sharded_config("hash")
    cfg, n = scfg.base, SHARDED_N
    events = sharded_events(stream_cfg, SHARDED_TICKS)
    step = se.make_sharded_tick_step(scfg, n, dev)
    rank = se.make_sharded_rank(scfg, n, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = se.init_sharded_state(scfg, n, dev)
    tick_ms, rank_ms, merged, overflow, frag, capped = [], {}, {}, {}, {}, {}
    tk.reset_launches()
    for t, ev in enumerate(events):
        state, ms = _synced_ms(lambda: step(state, *hose(ev)))
        tick_ms.append(ms)
        if t in SHARDED_RANK_AT:
            table, rank_ms[t] = _synced_ms(lambda: rank(state))
            # read between the timed spans, so outside them
            merged[t] = se.merge_sharded_suggestions(table, cfg.rank.top_k)
            overflow[t] = table.n_overflow.tolist()
            frag[t] = fragmented_sources(state)
            capped[t] = capped_sources(state.cooc, state.qstore, cfg.rank)
            del table
    launches = dict(tk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    drops = state.n_route_drop.tolist()
    if any(drops):
        raise AssertionError(f"sharded hash: route drops {drops}")
    missing = [k for k in SHARDED_KERNELS["hash"] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"sharded hash: kernels not launched {missing}")

    # the unsharded engine on the same ticks (its launches not counted)
    eng = SearchAssistanceEngine(cfg, device=dev)
    held = {}
    for t, ev in enumerate(events):
        eng.step(ev, None)
        if t in SHARDED_RANK_AT:
            capped[t] |= capped_sources([eng.state.cooc], eng.state.qstore,
                                        cfg.rank)
            held[t] = hold_sharded_suggestions(merged[t], eng.suggestions,
                                               frag[t], capped[t],
                                               f"tick {t}")
    for x, y in zip(table_leaves(state.qstore), table_leaves(eng.state.qstore)):
        if not torch.equal(x[0], y[0]):
            raise AssertionError("sharded hash: the query store differs from "
                                 "the unsharded engine's")
    pairs = se.export_sharded_pairs(scfg, state)
    diff = pair_difference(pairs, export_live(eng.state.cooc),
                           cfg.decay.prune_threshold)
    del eng
    report = {
        "card": card, "shards": n, "ticks": SHARDED_TICKS,
        "queries_per_tick": stream_cfg.queries_per_tick,
        "route_drop": drops,
        "tick_ms": _ms_stats(tick_ms), "tick_ms_all": tick_ms,
        "rank_ms": rank_ms, "rank_overflow": overflow,
        "cooc_live_per_shard": [int(c.live_count()) for c in state.cooc],
        "cooc_dropped_per_shard": [int(c.n_dropped) for c in state.cooc],
        "sessions_live_per_shard": [
            int(((s.key_hi != 0) | (s.key_lo != 0)).sum())
            for s in state.sessions],
        "qstore_live": int(state.qstore.live_count()),
        "peak_gib": peak, "suggestions": held, "pairs": diff,
        "launches": {k: v for k, v in launches.items() if v}}
    return launches, report, state


def sharded_replay(dev, card):
    """Phase 12(b): the lazy hash path live against a crash after tick 8,
    delta-chained snapshots, restore and replay. Returns (launches,
    report)."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core import sharded_engine as se
    from repro_torch.distributed.fault_tolerance import CheckpointManager
    scfg, stream_cfg = sharded_config("hash", lazy=True)
    n = SHARDED_N
    events = sharded_events(stream_cfg, SHARDED_TICKS)
    step = se.make_sharded_tick_step(scfg, n, dev)
    many = se.make_sharded_ingest_many(scfg, n, dev)
    rank = se.make_sharded_rank(scfg, n, dev)
    crash = SHARDED_SNAPSHOT_AT[-1]
    tk.reset_launches()
    live = se.init_sharded_state(scfg, n, dev)
    for ev in events:
        live = step(live, *hose(ev))
    saves = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as tmp:
        ckpt = CheckpointManager(tmp, full_interval=4)
        half = se.init_sharded_state(scfg, n, dev)
        for t, ev in enumerate(events[:crash]):
            half = step(half, *hose(ev))
            if t + 1 in SHARDED_SNAPSHOT_AT:
                _, ms = _synced_ms(lambda: se.save_sharded_snapshot(half,
                                                                    ckpt))
                saves.append({"tick": t + 1, "kind": ckpt.last_save_kind,
                              "bytes": ckpt.last_save_bytes,
                              "raw_bytes": ckpt.last_save_raw_bytes,
                              "ms": ms, "split_ms": ckpt.last_save_ms})
        del half                                   # the crash
        torch.cuda.empty_cache()
        (restored, log_tick), restore_ms = _synced_ms(
            lambda: se.restore_sharded_snapshot(scfg, n, ckpt, device=dev))
        restore_split = ckpt.last_restore_ms
    if log_tick != crash or [x["kind"] for x in saves] != ["full", "delta"]:
        raise AssertionError(f"sharded replay: log tick {log_tick}, saves "
                             f"{[x['kind'] for x in saves]}")
    tail = tuple(np.stack(x) for x in zip(*map(hose, events[crash:])))
    caught_up, replay_ms = _synced_ms(lambda: many(restored, *tail))
    _, rank_ms = _synced_ms(lambda: rank(caught_up))
    launches = dict(tk.LAUNCHES)
    for i, ((a, _), (b, _)) in enumerate(zip(se.sharded_leaves(live),
                                             se.sharded_leaves(caught_up))):
        if not torch.equal(a, b):
            raise AssertionError(f"sharded replay: leaf {i} differs from the "
                                 f"live run's")
    drops = live.n_route_drop.tolist()
    if any(drops):
        raise AssertionError(f"sharded replay: route drops {drops}")
    n_replayed = SHARDED_TICKS - crash
    per_tick = replay_ms / n_replayed
    return launches, {
        "card": card, "crash_after_tick": crash, "saves": saves,
        "restore_ms": restore_ms, "restore_split_ms": restore_split,
        "ticks_replayed": n_replayed, "replay_ms": replay_ms,
        "replay_ms_per_tick": per_tick,
        "replay_multiple_of_10s_tick": 1e4 / per_tick,
        "handoff_rank_ms": rank_ms,
        "time_to_fresh_ms": restore_ms + replay_ms + rank_ms,
        "leaves": len(se.sharded_leaves(live)), "route_drop": drops,
        "launches": {k: v for k, v in launches.items() if v}}


def sharded_split_merge(dev, card):
    """Phase 12(c): the region path split 8 -> 16 live and merged back.
    Returns (launches, report, the old 8-shard state)."""
    import tempfile
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core import sharded_engine as se
    from repro_torch.distributed import elastic
    from repro_torch.streaming.log import FirehoseLogWriter
    scfg, stream_cfg = sharded_config("region")
    cfg, n = scfg.base, SHARDED_N
    events = sharded_events(stream_cfg, SHARDED_SPLIT_AT + 2)
    step = se.make_sharded_tick_step(scfg, n, dev)
    rank = {k: se.make_sharded_rank(scfg, k, dev) for k in (n, 2 * n)}
    split = {"export_ms": 0.0, "fill_ms": 0.0}
    timed = {}

    def timer(name, key):
        fn = getattr(se, name)

        def wrapped(*a, **kw):
            out, ms = _synced_ms(lambda: fn(*a, **kw))
            split[key] += ms
            return out
        timed[name] = fn
        setattr(se, name, wrapped)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_reshard_") as tmp:
        writer = FirehoseLogWriter(tmp, ticks_per_segment=4)
        st = se.init_sharded_state(scfg, n, dev)
        tick_ms = []
        for t, ev in enumerate(events[:SHARDED_SPLIT_AT]):
            writer.append(t, ev, None)
            st, ms = _synced_ms(lambda: step(st, *hose(ev)))
            tick_ms.append(ms)
        old = se.clone_sharded_state(st)
        for t in range(SHARDED_SPLIT_AT, SHARDED_SPLIT_AT + 2):
            writer.append(t, events[t], None)      # the old state serves
            old = step(old, *hose(events[t]))      # the window's ticks
        writer.close()
        for name, key in (("export_sharded_pairs", "export_ms"),
                          ("export_sharded_sessions", "export_ms"),
                          ("_fill_cooc_shard", "fill_ms"),
                          ("_fill_session_shard", "fill_ms")):
            timer(name, key)
        make_many = elastic.make_sharded_ingest_many

        def timed_many(*a, **kw):
            many = make_many(*a, **kw)

            def replay(*b):
                out, ms = _synced_ms(lambda: many(*b))
                split["replay_ms"] += ms
                return out
            return replay

        split["replay_ms"] = 0.0
        elastic.make_sharded_ingest_many = timed_many
        try:
            (new, stats), wall = _synced_ms(lambda: elastic.live_reshard(
                scfg, st, 2 * n, 2 * n, log_dir=tmp, chunk_ticks=8,
                device=dev))
        finally:
            elastic.make_sharded_ingest_many = make_many
            for name, fn in timed.items():
                setattr(se, name, fn)
        del st
        split["wall_ms"] = wall
        split["other_ms"] = wall - sum(split[k] for k in (
            "export_ms", "fill_ms", "replay_ms"))
        m_old = se.merge_sharded_suggestions(rank[n](old), cfg.rank.top_k)
        m_new = se.merge_sharded_suggestions(rank[2 * n](new),
                                             cfg.rank.top_k)
        (merged, mstats), merge_ms = _synced_ms(lambda: elastic.live_reshard(
            scfg, new, n, n, log_dir=tmp, device=dev))
        m_back = se.merge_sharded_suggestions(rank[n](merged), cfg.rank.top_k)
    launches = dict(tk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    top = lambda m: {f: max(s for _, s in v) for f, v in m.items() if v}
    t_old, t_new = top(m_old), top(m_new)
    fell = [f for f in t_old if t_new[f] < t_old[f] - 1e-5]
    if (stats["replayed_ticks"] != 2 or int(new.tick) != int(old.tick)
            or not m_old or set(m_new) != set(m_old) or fell
            or set(m_back) != set(m_new) or mstats["replayed_ticks"] != 0):
        raise AssertionError(f"sharded split/merge: {stats}, {mstats}, "
                             f"{len(m_old)}/{len(m_new)}/{len(m_back)} "
                             f"sources, {len(fell)} top scores fell")
    drops = {"old": old.n_route_drop.tolist(),
             "split": new.n_route_drop.tolist(),
             "merged": merged.n_route_drop.tolist()}
    if any(x for v in drops.values() for x in v):
        raise AssertionError(f"sharded split/merge: route drops {drops}")
    missing = [k for k in SHARDED_KERNELS["region"] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"sharded region: kernels not launched {missing}")
    pressure = elastic.sharded_pressure(old, cfg)
    report = {
        "card": card, "shards": [n, 2 * n, n], "split_at": SHARDED_SPLIT_AT,
        "tick_ms": _ms_stats(tick_ms), "split": stats, "split_ms": split,
        "merge": mstats, "merge_ms": merge_ms,
        "sources": [len(m_old), len(m_new), len(m_back)],
        "top_score_rose": sum(t_new[f] > t_old[f] + 1e-5 for f in t_old),
        "route_drop": drops,
        "cooc_dropped_per_shard": {
            "old": [int(c.n_dropped) for c in old.cooc],
            "split": [int(c.n_dropped) for c in new.cooc]},
        "free_regions_per_shard": {
            "old": [int(c.free_regions()) for c in old.cooc],
            "split": [int(c.free_regions()) for c in new.cooc]},
        "pressure": pressure, "peak_gib": peak,
        "launches": {k: v for k, v in launches.items() if v}}
    del new, merged
    return launches, report, old


def sharded_path_kernels(dev, hash_state, region_state, floor):
    """Each kernel of the sharded paths against its plain version at one
    shard's shapes (after the phase's counts were read)."""
    import torch
    from repro_torch.core import ranking
    from repro_torch.core import sharded_engine as se
    from repro_torch.kernels import ops as kops
    scfg, _ = sharded_config("hash")
    C = scfg.base.cooc_capacity // SHARDED_N
    row = check_decay_prune(C, 6, dev)
    log(f"  decay_prune_multi at a hash shard's cooc (C={C}, 9 lanes): "
        f"{json.dumps(row)}")
    keep = {}
    spied = {"score_gate": kops.score_gate, "bucket_topk": kops.bucket_topk,
             "region_rank": kops.region_rank, "chain_find": kops.chain_find}

    def spy(name):
        def fn(*a, **kw):
            if name == "chain_find":
                n_act = int(a[5].sum())
                if n_act > keep.get("chain_find_active", -1):
                    keep["chain_find_active"] = n_act
                    keep["chain_find"] = (a[0].data_ptr(), tuple(
                        t.clone() for t in a[2:]))
            else:
                keep[name] = (tuple(t.clone() if torch.is_tensor(t) else t
                                    for t in a), dict(kw))
            return spied[name](*a, **kw)
        return fn

    for name in spied:
        setattr(kops, name, spy(name))
    try:
        ranking.ranking_cycle(hash_state.cooc[0], hash_state.qstore,
                              scfg.base.rank)
        hash_grid = keep.pop("bucket_topk")
        rcfg, stream_cfg = sharded_config("region")
        ranking.ranking_cycle_region(region_state.cooc[0], region_state.qstore,
                                     rcfg.base.rank)
        rt = int(region_state.tick) - 1
        step = se.make_sharded_tick_step(rcfg, SHARDED_N, dev)
        ev = sharded_events(stream_cfg, SHARDED_SPLIT_AT + 3)[-1]
        region_state = step(region_state, *hose(ev))
    finally:
        for name, fn in spied.items():
            setattr(kops, name, fn)
    tick = int(hash_state.tick) - 1
    sg = check_score_path_lanes(
        keep["score_gate"], tick, floor,
        label=f"sharded hash shard 0 of {SHARDED_N} lanes, tick {tick}")
    (grid, k), _ = hash_grid
    tk_hash = check_bucket_topk_path_grid(
        f"sharded hash shard 0 bucket grid, tick {tick}", grid, k)
    rr = check_region_rank_path_grid(
        keep["region_rank"], rt, floor,
        label=f"sharded region shard 0 of {SHARDED_N} grid, tick {rt}")
    (grid, k), _ = keep["bucket_topk"]
    tk_region = check_bucket_topk_path_grid(
        f"sharded region shard 0 chain-merge candidates, tick {rt}", grid, k)
    ptr, batch = keep["chain_find"]
    (table,) = [c for c in region_state.cooc if c.key_hi.data_ptr() == ptr]
    cf = check_chain_find_batch(table, batch)
    return {"decay_prune_multi": row, "score_gate": sg["score_gate"],
            "bucket_topk_hash": tk_hash, "region_rank": rr,
            "bucket_topk_region": tk_region, "chain_find": cf}


def run_sharded(dev, card: str, floor):
    """Phase 12: (a), (b), (c), then the kernels at one shard's shapes.
    Returns the phase's launch counts ((a) + (b) + (c))."""
    import torch
    t_phase = time.perf_counter()
    scfg, stream_cfg = sharded_config("hash")
    log(f"[12] the sharded engine ({card}): {SHARDED_N} shards, "
        f"{scfg.n_salts} salts, hot at "
        f"{scfg.hot_threshold}, {scfg.route_capacity} pairs a bucket; "
        f"{stream_cfg.queries_per_tick} queries a tick, no tweets")
    t0 = time.perf_counter()
    la, rep_a, hash_state = sharded_hash(dev, card)
    rep_a["wall_s"] = time.perf_counter() - t0
    log(f"[12] sharded hash vs unsharded ({card}): " + json.dumps(
        {k: v for k, v in rep_a.items() if k != "tick_ms_all"}))
    st = rep_a["tick_ms"]
    log(f"  sharded hash ({card}): ms per sharded tick p50 {st['p50']:.3f}, "
        f"max {st['max']:.3f} (n {st['n']}); rank cycle over "
        f"{SHARDED_N} shards " + ", ".join(
            f"tick {t}: {ms:.3f} ms" for t, ms in rep_a["rank_ms"].items())
        + f"; peak {rep_a['peak_gib']:.3f} GiB; route drops "
        f"{rep_a['route_drop']}")
    for t, h in rep_a["suggestions"].items():
        log(f"  sharded hash, tick {t}: {h['sources']} sources, key sets "
            f"equal; {h['held']} held to the top-3 contract; "
            f"{h['fragmented']} hold a pair in two shards (salted after "
            f"crossing hot_threshold), {h['fragmented_off']} of them off "
            f"the contract, worst top-3 relative difference "
            f"{h['fragmented_worst_rel']!r}; {h['capped']} more have over "
            f"bucket_rows gate-passing rows in a store of either engine, "
            f"{h['capped_off']} of them off, worst "
            f"{h['capped_worst_rel']!r}")
    p = rep_a["pairs"]
    log(f"  sharded hash: export_sharded_pairs {p['sharded']} pairs, "
        f"export_live {p['unsharded']}; {p['sharded_only']} keys on the "
        f"sharded side only, {p['unsharded_only']} on the unsharded side "
        f"only, {p['prune_flips']} of them prune flips; max relative weight "
        f"difference {p['max_rel_weight_diff']!r} "
        f"({p['common_weight_exact']} of {p['common']} equal); the query "
        f"store bit for bit the unsharded engine's")
    log(f"  sharded hash: live slots per shard {rep_a['cooc_live_per_shard']}"
        f", sessions per shard {rep_a['sessions_live_per_shard']}, launches "
        f"{rep_a['launches']}; took {rep_a['wall_s']:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lb, rep_b = sharded_replay(dev, card)
    rep_b["wall_s"] = time.perf_counter() - t0
    log(f"[12] sharded replay, lazy policy ({card}): " + json.dumps(rep_b))
    log(f"  sharded replay ({card}): saves " + "; ".join(
        f"tick {x['tick']} {x['kind']} {x['bytes']} B ({x['raw_bytes']} raw)"
        f" {x['ms']:.3f} ms" for x in rep_b["saves"])
        + f"; restore {rep_b['restore_ms']:.3f} ms; replay "
        f"{rep_b['ticks_replayed']} ticks {rep_b['replay_ms']:.3f} ms "
        f"({rep_b['replay_ms_per_tick']:.3f} ms a tick, "
        f"{rep_b['replay_multiple_of_10s_tick']:.1f}x a 10-s tick); handoff "
        f"rank {rep_b['handoff_rank_ms']:.3f} ms; time to fresh "
        f"{rep_b['time_to_fresh_ms']:.3f} ms; all {rep_b['leaves']} leaves "
        f"bit for bit the live run's; took {rep_b['wall_s']:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lc, rep_c, region_state = sharded_split_merge(dev, card)
    rep_c["wall_s"] = time.perf_counter() - t0
    log(f"[12] sharded split and merge, region layout ({card}): "
        + json.dumps(rep_c))
    s, sp = rep_c["split"], rep_c["split_ms"]
    log(f"  sharded split 8 -> 16 at tick {rep_c['split_at']} ({card}): "
        f"wall {sp['wall_ms']:.3f} ms = export {sp['export_ms']:.3f} + fill "
        f"{sp['fill_ms']:.3f} + replay of {s['replayed_ticks']} ticks "
        f"{sp['replay_ms']:.3f} + ownership and the query store's copy "
        f"{sp['other_ms']:.3f}; {s['n_pairs']} pairs, {s['n_sessions']} "
        f"sessions, {s['n_pair_drop']} pair and {s['n_sess_drop']} session "
        f"drops; merge 16 -> 8 {rep_c['merge_ms']:.3f} ms "
        f"({rep_c['merge']['n_pairs']} pairs); sources "
        f"{rep_c['sources']} (key sets equal, no top score lower, "
        f"{rep_c['top_score_rose']} higher); launches {rep_c['launches']}; "
        f"took {rep_c['wall_s']:.1f} s")
    log("[12] kernels at one shard's shapes")
    t0 = time.perf_counter()
    rows = sharded_path_kernels(dev, hash_state, region_state, floor)
    del hash_state, region_state
    torch.cuda.empty_cache()
    log(f"  sharded path kernels: " + json.dumps(
        {k: {x: y for x, y in v.items() if not isinstance(y, (dict, list))}
         for k, v in rows.items()}) + f"; took {time.perf_counter() - t0:.1f} s")
    log(f"  sharded phase took {time.perf_counter() - t_phase:.1f} s")
    return {k: la[k] + lb[k] + lc[k] for k in la}


def profile_region() -> None:
    """The region cell's 17 ticks, then one more ingest tick and one rank
    cycle under the profiler, on the ``repro_torch`` package on the path."""
    import torch
    import repro_torch
    from repro_torch.core.engine import SearchAssistanceEngine
    from repro_torch.data.stream import SyntheticStream
    log(f"profile region: {card_line()} | package "
        f"{Path(repro_torch.__file__).parent}")
    cfg, scfg = deployment_config("region")
    stream = SyntheticStream(scfg, seed=SEED)
    ticks = [stream.gen_tick(t) for t in range(18)]
    eng = SearchAssistanceEngine(cfg, device=torch.device("cuda"))
    for events, tweets in ticks[:17]:
        eng.step(events, tweets)
    profile_tick(eng, ticks[17], "region")


def profile_hash() -> None:
    """The hash cell's 17 ticks (score_gate's last arguments kept by a spy),
    then one more ingest tick and one rank cycle under the profiler, then
    score_gate's and assoc_score's bare launches timed on the synthetic
    lanes and on those kept lanes, on the ``repro_torch`` package on the
    path (launch signatures shared with the parent trees)."""
    import torch
    import repro_torch
    from repro_torch.core.ranking import RankConfig
    from repro_torch.data.stream import SyntheticStream
    from repro_torch.kernels import assoc_score as kas
    from repro_torch.kernels import topk_select as ktk
    dev = torch.device("cuda")
    log(f"profile hash: {card_line()} | package "
        f"{Path(repro_torch.__file__).parent}")
    cfg, scfg = deployment_config("hash")
    stream = SyntheticStream(scfg, seed=SEED)
    ticks = [stream.gen_tick(t) for t in range(18)]
    eng = []
    (a, kw), tick = last_score_gate_call(dev, ticks[:17], eng)
    profile_tick(eng[0], ticks[17], "hash")
    del eng
    rc = RankConfig()
    gates = (rc.min_pair_weight, rc.min_src_weight, rc.min_pair_count)
    syn, ok, lt, sc = _score_inputs(cfg.cooc_capacity, dev)
    cases = {"synthetic lanes": (syn, ok, torch.stack(sc)),
             f"hash path lanes, tick {tick}": (a[:6], a[6], torch.stack(
                 [x.to(torch.float32).reshape(()) for x in a[7:9]]
                 + [torch.zeros((), device=dev)]))}
    for label, (lanes, g, scalars) in cases.items():
        out = torch.empty_like(lanes[0])
        ms = {"score_gate": time_ms(lambda: ktk.launch_score_gate(
            lanes, g, None, scalars, kw["coefs"], gates, None, out))}
        if label == "synthetic lanes":
            ms["score_gate lazy"] = time_ms(lambda: ktk.launch_score_gate(
                lanes, g, lt.data_ptr(), scalars, kw["coefs"], gates, 36.0,
                out))
        ms["assoc_score"] = time_ms(lambda: kas.launch_assoc_score(
            lanes, scalars[:2], kw["coefs"], out))
        log(f"  profile hash, bare launches on the {label}: "
            + ", ".join(f"{k} {v!r} ms" for k, v in ms.items()))


# ---------------------------------------------------------------------------
# Phase 13: the MoE LM serving path (qwen2-moe-a2.7b at its published widths).
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen2-moe-a2.7b"
MOE_BATCH, MOE_SEQ, MOE_DECODE = 4, 4096, 16
# Agreement of prefill/decode with the kernel forward, in logits, with the
# served run's top-k choices pinned to the kernel forward's (the choice is
# a discontinuity: where two router logits lie closer than the runs'
# rounding gap, they pick different experts, and that token's output moves
# by a gate times the difference of two experts, O(gate)). Pinned, the runs
# differ only in where they round, as in phase 6, but at more sites a
# layer: attention ~6 (phase 6's count), the routed experts 9 (three
# products, silu, the product, the gate's cast, three adds of the k = 4
# contributions), the shared experts 8 (three products, silu, the product,
# the gate's product, sigmoid, its multiply) and the residual add: ~24 a
# layer over 24 layers, sqrt(576) x 2^-9 = 4.7% relative RMS expected,
# bounded at twice that, 10%; 4.7% RMS puts 6 sigma of ~N(0, 1) logits at
# ~0.28, bounded at 1.0. A wrong cache slot, position or expert moves logits
# by O(1) and fails both. The choices that differ from the served run's own
# are counted and printed.
MOE_BF16_REL_RMS, MOE_BF16_MAX_ABS = 0.10, 1.0


class MoESpies:
    """Spies on ``models.moe.top_k`` and ``models.moe.route`` for the
    forwards run inside: with ``routes`` (a list), one entry per MoE layer
    call holding its top-k indices, router logits and ``Route``; with
    ``pins`` (an iterator of top-k index tensors, one per MoE layer call in
    order), each call's choice replaced by the pinned one, the gates taken
    from its own logits, and the number of tokens whose own top-k set
    differs from the pin appended to ``flips``."""

    def __init__(self, routes=None, pins=None, flips=None):
        self.routes, self.pins, self.flips = routes, pins, flips

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.real = real_top_k, real_route = moe.top_k, moe.route
        if self.routes is None and self.pins is None:
            return self

        def top_k(logits, k):
            v, i = real_top_k(logits, k)
            if self.pins is not None:
                pin = next(self.pins)
                self.flips.append((i.sort(-1).values
                                   != pin.sort(-1).values).any(-1).sum())
                v, i = torch.gather(logits, -1, pin), pin
            if self.routes is not None:
                self.routes.append({"top_i": i})
            return v, i

        def route(logits, cfg):
            r = real_route(logits, cfg)
            if self.routes is not None:
                self.routes[-1].update(logits=logits, route=r)
            return r
        moe.top_k, moe.route = top_k, route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.top_k, moe.route = self.real
        return False


def moe_pinned_serving(model, cfg, tokens, fed, pins):
    """Prefill ``tokens`` into fresh caches, then one decode step per column
    of ``fed``, each MoE layer call's top-k pinned (:class:`MoESpies`).
    Returns (prefill logits, decode logits [B, n, V], routing choices that
    differ from the run's own)."""
    import torch
    from repro_torch.models import transformer as tr
    B, T = tokens.shape
    n = fed.shape[1]
    caches = tr.init_caches(cfg, B, T + n, device=tokens.device)
    flips = []
    with MoESpies(pins=iter(pins), flips=flips):
        pre, caches = tr.prefill(model, tokens, cfg, caches)
        outs = []
        for j in range(n):
            lg, caches = tr.decode_step(model, fed[:, j:j + 1], cfg, caches)
            outs.append(lg)
    return pre, torch.stack(outs, 1) if outs else None, int(sum(flips))


def moe_gap(name, got, exp, vocab, flips, n_choices):
    rms, mx, top1 = _logit_gap(got, exp, vocab)
    log(f"  {name} ({got.shape[1]} positions, top-k pinned to the kernel "
        f"forward's): rel RMS {rms!r}, max abs {mx!r} (bounds: rel RMS "
        f"{MOE_BF16_REL_RMS}, max abs {MOE_BF16_MAX_ABS}), top-1 agreement "
        f"{top1!r}; routing choices the run would have made otherwise: "
        f"{flips} of {n_choices} (token, layer)")
    import torch
    if mx > MOE_BF16_MAX_ABS or rms > MOE_BF16_REL_RMS or \
            not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name} disagrees with the kernel forward")


def moe_routing_on_card(routes, cfg) -> None:
    """The layer with the most capacity drops: its router logits from the
    scoring forward routed on the card and, the same tensor moved to the
    CPU, on the CPU; the dispatch must be equal, and equal to what the
    forward routed."""
    import torch
    from repro_torch.models import moe
    drops = [int(r["route"].n_dropped) for r in routes]
    layer = max(range(len(drops)), key=drops.__getitem__)
    logits = routes[layer]["logits"]
    card = moe.route(logits, cfg.moe)
    cpu = moe.route(logits.cpu(), cfg.moe)
    seen = routes[layer]["route"]
    for name in ("slot_tok", "token_slot", "n_kept", "n_dropped"):
        a, b, c = (getattr(r, name) for r in (card, cpu, seen))
        if not (torch.equal(a.cpu(), b) and torch.equal(a, c)):
            raise AssertionError(f"routing {name} differs, card vs CPU")
    log(f"  routing on the card vs the CPU, layer {layer}'s router logits "
        f"{list(logits.shape)} (C {card.C}): slot_tok, token_slot and the "
        f"counts equal (kept {int(card.n_kept)}, dropped "
        f"{int(card.n_dropped)})")


def run_moe(dev, rows):
    """Phase 13: qwen2-moe-a2.7b at its published widths and depth, bf16,
    random weights from a seeded generator on the card. Returns the scoring
    forward's launch counts."""
    import numpy as np
    import torch
    from repro_torch import kernels as tk
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tr
    t_phase = time.perf_counter()
    cfg = get_arch(MOE_ARCH).config
    m = cfg.moe
    B, T, n_dec = MOE_BATCH, MOE_SEQ, MOE_DECODE
    t0 = time.perf_counter()
    model = tr.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
        device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[13] MoE LM serving path: {cfg}, {cfg.param_count()} parameters "
        f"by param_count ({cfg.active_param_count()} active a token; "
        f"{n_params} held, the vocabulary padded to {cfg.padded_vocab}; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB), made in "
        f"{time.perf_counter() - t0:.3f} s")
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)).to(dev)
    from repro_torch.models.moe import capacity
    with torch.inference_mode():
        routes = []
        logits, launches, wall, peak, (q, k, v), same = lm_scoring(
            model, cfg, tokens, routes)
        missing = [n for n in tk.PATH_KERNELS["moe"] if launches[n] <= 0]
        if missing or launches["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"MoE scoring forward launches {launches}")
        if logits.shape != (B, T, cfg.padded_vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError("MoE scoring logits not finite or misshapen")
        if not same:
            raise AssertionError("two MoE scoring forwards differ")
        drops = [int(r["route"].n_dropped) for r in routes]
        auxs = [float(r["route"].aux) for r in routes]
        log(f"  scoring forward: {B} x {T} tokens in {wall!r} ms "
            f"({B * T / wall * 1e3!r} tokens/s), peak {peak!r} GiB, "
            f"flash_attention launches {launches['flash_attention']}; "
            f"C {capacity(m, B * T)} slots an expert")
        log(f"  capacity drops a layer (of {B * T * m.top_k} assignments): "
            f"{drops} (mean {statistics.mean(drops)!r}); router loss a "
            f"layer {auxs}, mean {statistics.mean(auxs)!r}")
        log("[5] determinism: two MoE scoring forwards give bit-identical "
            "logits (no float atomics in the dispatch or the combine)")
        moe_routing_on_card(routes, cfg)
        _profiled("MoE scoring forward", lambda: tr.forward(model, tokens,
                                                            cfg))
        pre, dec, fed, pre_ms, step_ms, s_launches, s_peak = lm_serving(
            dev, model, cfg, tokens, n_dec, profile_step=True)
        if s_launches["flash_attention"] != 0 or \
                not bool(torch.isfinite(dec).all()):
            raise AssertionError("MoE serving launches or logits")
        log(f"  serving: prefill {B} x {T} (C {capacity(m, B * T)}): "
            f"{pre_ms!r} ms; {n_dec} decode steps (C {capacity(m, B)}), ms "
            f"each {step_ms!r} (median {statistics.median(step_ms)!r}); "
            f"peak {s_peak!r} GiB; flash_attention launches "
            f"{s_launches['flash_attention']} (prefill and decode read the "
            f"cache in plain torch)")
        rms, mx, top1 = _logit_gap(pre, logits, cfg.vocab_size)
        log(f"  prefill vs the scoring forward, own routing (printed, not "
            f"held): rel RMS {rms!r}, max abs {mx!r}, top-1 agreement "
            f"{top1!r}")
        del pre, dec
        # (A) prefill against the scoring forward: the same tokens, the same
        # C, the same dispatch order; top-k pinned to the forward's.
        pins = [r["top_i"] for r in routes]
        pre, _, flips = moe_pinned_serving(model, cfg, tokens, fed[:, :0],
                                           pins)
        moe_gap("prefill vs the scoring forward", pre, logits,
                cfg.vocab_size, flips, B * T * cfg.n_layers)
        del pre, logits, routes, pins
        torch.cuda.empty_cache()
        # (B) decode: a forward over prompt + fed tokens has another C and
        # another drop order, so both run at a capacity where nothing drops
        # (capacity_factor E / k: C >= the tokens of a group), where the
        # MoE is per token and the served run and the forward compute the
        # same function.
        cfg_nd = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k))
        full_routes = []
        with MoESpies(routes=full_routes):
            full = tr.forward(model, torch.cat([tokens, fed], 1), cfg_nd)[0]
        if any(int(r["route"].n_dropped) for r in full_routes):
            raise AssertionError("the no-drop forward dropped assignments")
        ti = [r["top_i"].view(B, T + n_dec, m.top_k) for r in full_routes]
        pins = [t[:, :T].reshape(1, B * T, m.top_k) for t in ti]
        for j in range(n_dec):
            pins += [t[:, T + j].reshape(1, B, m.top_k) for t in ti]
        del full_routes, ti
        pre, dec, flips = moe_pinned_serving(model, cfg_nd, tokens, fed,
                                             pins)
        log(f"  no-drop capacity (factor {cfg_nd.moe.capacity_factor}): "
            f"C {capacity(cfg_nd.moe, B * (T + n_dec))} over {B} x "
            f"{T + n_dec} tokens, {capacity(cfg_nd.moe, B * T)} at prefill, "
            f"{capacity(cfg_nd.moe, B)} at decode")
        n_choices = B * (T + n_dec) * cfg.n_layers
        moe_gap(f"prefill vs kernel forward over {T + n_dec} tokens", pre,
                full[:, :T], cfg.vocab_size, flips, n_choices)
        moe_gap(f"decode vs kernel forward over {T + n_dec} tokens", dec,
                full[:, T:T + n_dec], cfg.vocab_size, flips, n_choices)
        del pre, dec, full, pins
        torch.cuda.empty_cache()
        log(f"[2] flash_attention at the MoE scoring forward's layer-0 "
            f"shapes (head dim {cfg.hd}, causal, no window)")
        row = check_flash_attention(q, k, v, cfg.window,
                                    must_beat_sdpa=False,
                                    ptxas_kernel=f"flash_fwd_tcILi{cfg.hd}E")
        row["launches"] = launches["flash_attention"]
        rows.setdefault("flash_attention", {})[f"moe_d{cfg.hd}"] = row
        log(f"  flash_attention at the MoE path's shape: {json.dumps(row)}")
        del q, k, v
    del model
    torch.cuda.empty_cache()
    log(f"  MoE phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 14: the recsys and GNN serving paths at full width.
# ---------------------------------------------------------------------------

RECSYS_ARCHS = ("bst", "xdeepfm", "two-tower-retrieval", "bert4rec")
RECSYS_CELLS = ("serve_p99", "serve_bulk", "retrieval_cand")
GAT_CELLS = ("full_graph_sm", "molecule", "minibatch_lg", "ogb_products")
RECSYS_SKIPS = {("bert4rec", "serve_bulk"): (
    "262,144 rows x 1,000,002 vocabulary scores are 33.5 PFLOP, and the "
    "encoder's attention logits [262144, 2, 200, 200] f32 take 78 GiB")}
# The cell of each architecture run once more under the profiler, on the
# seeded inputs (xdeepfm's serve_bulk: its retrieval_cand is the same
# arithmetic on 3.8x the rows).
PROFILED = {"bst": "retrieval_cand", "xdeepfm": "serve_bulk",
            "two-tower-retrieval": "serve_bulk", "bert4rec": "serve_p99",
            "gat-cora": "ogb_products"}
CHECK_ROWS = 64          # rows held card against CPU in each cell
CHECK_MAX_EDGES = 2_000_000   # GAT: the CPU's share of a check, at most
RECSYS_REPS = 3


def _close(label, got, exp, scale_atol=False):
    """Card against CPU (f32, TF32 off) within 1e-5: a tensor (its atol
    scaled by max |exp| where ``scale_atol``), or a top-k (values; ids
    wherever a value stands more than 1e-5 from each neighbour or ties it
    exactly on both sides). Returns the max abs error."""
    import numpy as np
    import torch
    if not isinstance(exp, tuple):
        atol = 1e-5 * (float(exp.abs().max()) if scale_atol else 1.0)
        torch.testing.assert_close(got.cpu(), exp, rtol=1e-5, atol=atol,
                                   msg=lambda m: f"{label}: {m}")
        return float((got.cpu() - exp).abs().max())
    gv, gi = (t.cpu().numpy() for t in got)
    ev, ei = (t.numpy() for t in exp)
    np.testing.assert_allclose(gv, ev, rtol=1e-5, atol=1e-5, err_msg=label)
    gap = np.diff(ev, axis=-1)
    ok = (np.abs(gap) > 1e-5 * np.maximum(np.abs(ev[..., 1:]), 1.0)) | (
        (gap == 0) & (np.diff(gv) == 0))
    clear = np.ones_like(ev, bool)
    clear[..., 1:] &= ok
    clear[..., :-1] &= ok
    if not (gi[clear] == ei[clear]).all():
        raise AssertionError(f"{label}: top-k ids differ where clear")
    return float(np.abs(gv - ev).max())


def small_recsys(dev) -> None:
    """Phase 3 for the recsys and GNN families: each SMOKE model (f32, TF32
    off) on the card against the same weights on the CPU, within the CPU
    tests' 1e-5 bars: the four recsys models' serve and retrieval steps,
    and the GAT through ``adapt_config`` on each of its four cells (the two
    large graphs cut to 4,096 nodes and 16,384 edges)."""
    import numpy as np
    import torch
    from repro_torch.configs import gat_cora, get_arch
    from repro_torch.models import api, gnn
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = lambda: torch.Generator().manual_seed(SEED)
    for arch in RECSYS_ARCHS:
        cfg = get_arch(arch).smoke_config
        cpu = api.init_params(cfg, generator=gen(), device="cpu")
        card = api.init_params(cfg, generator=gen(), device="cpu").to(dev)
        errs = []
        for cell in (api.ShapeCell("s", "serve", {"batch": 256}),
                     api.ShapeCell("r", "retrieval",
                                   {"batch": 1, "n_candidates": 4096})):
            b = api.make_inputs(np.random.default_rng(SEED), cfg, cell,
                                device="cpu")["batch"]
            fn = api.serve_fn(cfg, cell)
            errs.append(_close(f"{arch} SMOKE {cell.kind}",
                               fn(card, {k: v.to(dev) for k, v in b.items()}),
                               fn(cpu, b), arch == "xdeepfm"))
        log(f"  {arch} SMOKE, card vs CPU: serve (256 rows) and retrieval "
            f"(4,096 candidates), max abs error {max(errs)!r} (1e-5)")
    errs = {}
    for cell in gat_cora.SHAPES:
        dims = dict(cell.dims)
        if dims["n_edges"] > 16384:
            dims.update(n_nodes=4096, n_edges=16384, n_edges_padded=16384)
        cell = dataclasses.replace(cell, dims=dims)
        cfg = gat_cora.adapt_config(gat_cora.SMOKE, cell)
        cpu = api.init_params(cfg, generator=gen(), device="cpu")
        card = api.init_params(cfg, generator=gen(), device="cpu").to(dev)
        b = api.make_inputs(np.random.default_rng(SEED), cfg, cell,
                            device="cpu")["batch"]
        errs[cell.name] = _close(
            f"gat-cora SMOKE {cell.name}",
            gnn.forward(card, {k: v.to(dev) for k, v in b.items()}, cfg),
            gnn.forward(cpu, b, cfg))
    log(f"  gat-cora SMOKE, card vs CPU, forward on its four cells: max abs "
        f"error {errs} (1e-5)")


def seeded_batch(cfg, cell, dev, gen):
    """A cell's inputs with every id drawn uniformly over its whole table
    (or node set) on the card: the gathers and scatters a deployment makes.
    Features are standard normal; a GAT's first ``n_edges`` edges are
    valid, the padding not."""
    import torch
    from repro_torch.models import api
    specs = api.input_specs(cfg, cell)["batch"]
    hi = api.id_ranges(cfg, cell)
    out = {}
    for k, s in sorted(specs.items()):
        if s.dtype == torch.int32:
            out[k] = torch.randint(0, hi[k], s.shape, generator=gen,
                                   device=dev, dtype=torch.int32)
        elif s.dtype == torch.bool:
            out[k] = torch.rand(s.shape, generator=gen, device=dev) < 0.5
        else:
            out[k] = torch.randn(s.shape, generator=gen, device=dev)
    for k in ("fields", "fields_ctx"):
        if k in out:
            out[k] += (torch.arange(out[k].shape[1], device=dev,
                                    dtype=torch.int32) * cfg.field_vocab)
    if "edge_valid" in out:
        out["edge_valid"] = torch.arange(out["edge_valid"].shape[0],
                                         device=dev) < cell.dims["n_edges"]
    return out


def _timed_runs(fn, reps=RECSYS_REPS):
    """``reps`` synced runs: (the outputs of the first and last, the ms of
    each)."""
    outs, ms = [], []
    for _ in range(reps):
        out, t = _synced_ms(fn)
        ms.append(t)
        outs = [outs[0] if outs else out, out]
    return outs, ms


def _check_rows_recsys(cfg, cell, model, batch, out, cpu):
    """The card against the port's CPU path on the cell's first 64 rows
    (for a retrieval cell the first 64 candidates): ``cpu`` holds the
    model's parameters on the host; for two-tower (``cpu`` None) only the
    table rows those ids touch reach it (ids renumbered, 0 kept as
    padding). Where the cell's rows are
    independent the full run's first 64 outputs are held, else the card's
    own run on those rows."""
    import torch
    from repro_torch.models import api, recsys
    n = CHECK_ROWS
    if "cand_ids" in batch:
        rows = dict(batch, cand_ids=batch["cand_ids"][:n])
    else:
        rows = {k: v[:n] for k, v in batch.items()}
    fn = api.serve_fn(cfg, cell)
    if isinstance(cfg, recsys.TwoTowerConfig):
        users, u_at = torch.unique(rows["user_id"], return_inverse=True)
        keys = [k for k in ("hist", "pos_item", "cand_ids") if k in rows]
        items, i_at = torch.unique(torch.cat(
            [torch.zeros(1, dtype=torch.int32, device=users.device)]
            + [rows[k].reshape(-1) for k in keys]), return_inverse=True)
        off = 1
        host = {"user_id": u_at.int()}
        for k in keys:
            m = rows[k].numel()
            host[k] = i_at[off:off + m].reshape(rows[k].shape).int()
            off += m
        sub = dataclasses.replace(cfg, n_users=len(users), n_items=len(items))
        cpu = api.init_params(sub, generator=None, device="cpu")
        state = {k: v.cpu() for k, v in model.state_dict().items()
                 if "emb" not in k}
        state["user_emb"] = model.user_emb[users].cpu()
        state["item_emb"] = model.item_emb[items].cpu()
        cpu.load_state_dict(state)
        host = {k: v.cpu() for k, v in host.items()}
        cpu_cfg = sub
    else:
        host = {k: v.cpu() for k, v in rows.items()}
        cpu_cfg = cfg
    exp = api.serve_fn(cpu_cfg, cell)(cpu, host)
    independent = cell.kind == "serve" or not isinstance(
        cfg, (recsys.TwoTowerConfig, recsys.Bert4RecConfig))
    if independent:
        got = tuple(t[:n] for t in out) if isinstance(out, tuple) \
            else out[:n]
    else:
        got = fn(model, rows)
    return _close(f"{cfg.name} {cell.name} rows", got, exp,
                  isinstance(cfg, recsys.XDeepFMConfig))


def _check_nodes_gat(cfg, model, batch, out):
    """The card's GAT logits of nodes 0-63 against the port's CPU path on
    the subgraph that determines them: the valid edges into those nodes and
    into the sources of those edges (both layers' in-edges), with their
    endpoints' features. Returns (max abs error, edges) or (None, edges)
    where the subgraph holds more than ``CHECK_MAX_EDGES`` edges."""
    import torch
    from repro_torch.models import gnn
    from repro_torch.models.convert import model_from_jax, model_to_numpy
    src, dst = batch["src"].long(), batch["dst"].long()
    valid = batch["edge_valid"]
    targets = torch.arange(CHECK_ROWS, device=src.device)
    s1 = torch.unique(src[valid & torch.isin(dst, targets)])
    keep = valid & torch.isin(dst, torch.cat([targets, s1]))
    n_edges = int(keep.sum())
    if n_edges > CHECK_MAX_EDGES:
        return None, n_edges
    e_src, e_dst = src[keep], dst[keep]
    nodes = torch.unique(torch.cat([targets, e_src, e_dst]))
    sub = {"x": batch["x"][nodes].cpu(),
           "src": torch.searchsorted(nodes, e_src).int().cpu(),
           "dst": torch.searchsorted(nodes, e_dst).int().cpu()}
    cpu = model_from_jax(model_to_numpy(model), cfg, device="cpu")
    exp = gnn.forward(cpu, sub, cfg)[torch.searchsorted(nodes, targets).cpu()]
    return _close(f"{cfg.name} nodes", out[:CHECK_ROWS], exp), n_edges


def _cell_line(arch, cell, inputs, ms, rows, flops, peak, extra):
    rec = {"ms": statistics.median(ms), "runs_ms": ms, "rows": rows,
           "rows_per_s": rows / statistics.median(ms) * 1e3,
           "model_flops": flops,
           "tflop_per_s": flops / statistics.median(ms) / 1e9,
           "f32_peak_share": flops / (statistics.median(ms) * 1e-3)
           / F32_OPS_PER_S, "peak_gib": peak, **extra}
    log(f"[14] {arch} {cell.name} ({inputs}): {json.dumps(rec)}")


def recsys_arch(dev, arch, card):
    """One recsys architecture at its full CONFIG on the card: each cell on
    ``make_inputs``' inputs and on ids drawn uniformly over the tables."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import api
    from repro_torch.models.convert import model_from_jax, model_to_numpy
    spec = get_arch(arch)
    cfg = spec.config
    t0 = time.perf_counter()
    model = api.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
        device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[14] {arch}: {cfg} ({spec.source}), {n_params} parameters "
        f"({torch.cuda.memory_allocated() / 2**30:.3f} GiB) made on the card "
        f"in {time.perf_counter() - t0:.3f} s ({card})")
    # the CPU path's copy of the weights (two-tower's 19.1 GiB of tables
    # stay on the card: each check copies the rows it reads)
    cpu = None if arch == "two-tower-retrieval" else model_from_jax(
        model_to_numpy(model), cfg, device="cpu")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for name in RECSYS_CELLS:
        cell = spec.cell(name)
        if (arch, name) in RECSYS_SKIPS:
            log(f"[14] {arch} {name}: skipped, not run on the card: "
                f"{RECSYS_SKIPS[arch, name]}")
            continue
        fn = api.serve_fn(cfg, cell)
        rows = cell.dims["n_candidates"] if cell.kind == "retrieval" and \
            arch != "bert4rec" else cell.dims["batch"]
        for inputs in ("make_inputs", "seeded"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            batch = api.make_inputs(np.random.default_rng(SEED), cfg, cell,
                                    device=dev)["batch"] \
                if inputs == "make_inputs" else \
                seeded_batch(cfg, cell, dev, gen)
            torch.cuda.synchronize()
            made_ms = (time.perf_counter() - t0) * 1e3
            with torch.inference_mode():
                (first, out), ms = _timed_runs(lambda: fn(model, batch))
            peak = torch.cuda.max_memory_allocated() / 2**30
            leaves = out if isinstance(out, tuple) else (out,)
            if not all(bool(torch.isfinite(t).all()) for t in leaves
                       if t.is_floating_point()):
                raise AssertionError(f"{arch} {name} ({inputs}): not finite")
            shape = [tuple(t.shape) for t in leaves]
            exp_shape = [(cell.dims["batch"], 100)] * 2 if isinstance(
                out, tuple) else [(rows,)]
            if shape != exp_shape:
                raise AssertionError(f"{arch} {name}: shape {shape}")
            same = all(torch.equal(a, b) for a, b in zip(
                first if isinstance(first, tuple) else (first,), leaves))
            with torch.inference_mode():
                err = _check_rows_recsys(cfg, cell, model, batch, out, cpu)
                if inputs == "seeded" and PROFILED[arch] == name:
                    _profiled(f"{arch} {name}", lambda: fn(model, batch))
            _cell_line(arch, cell, inputs, ms, rows,
                       api.model_flops(cfg, cell), peak,
                       {"inputs_made_ms": made_ms, "shape": shape,
                        "runs_bit_identical": same,
                        "check_rows_max_abs_err": err})
            del batch, out, first
    del model
    torch.cuda.empty_cache()


def gat_cells(dev, card):
    """gat-cora's CONFIG through ``adapt_config`` on each of its four cells,
    on ``make_inputs``' inputs and on edges drawn uniformly over the node
    set."""
    import numpy as np
    import torch
    from repro_torch.configs import gat_cora
    from repro_torch.models import api, gnn
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for name in GAT_CELLS:
        cell = gat_cora.SPEC.cell(name)
        cfg = gat_cora.adapt_config(gat_cora.CONFIG, cell)
        model = api.init_params(
            cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
            device=dev)
        d = cell.dims
        log(f"[14] gat-cora {name}: {cfg}; {d['n_nodes']} nodes, "
            f"{d['n_edges_padded']} edges ({d['n_edges']} real) ({card})")
        for inputs in ("make_inputs", "seeded"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            batch = api.make_inputs(np.random.default_rng(SEED), cfg, cell,
                                    device=dev)["batch"] \
                if inputs == "make_inputs" else \
                seeded_batch(cfg, cell, dev, gen)
            torch.cuda.synchronize()
            made_ms = (time.perf_counter() - t0) * 1e3
            with torch.inference_mode():
                (first, out), ms = _timed_runs(
                    lambda: gnn.forward(model, batch, cfg))
                peak = torch.cuda.max_memory_allocated() / 2**30
                if out.shape != (d["n_nodes"], cfg.n_classes) or \
                        not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"gat-cora {name}: output")
                # the segment sums add a node's in-edges by float atomics
                # in no fixed order: a random walk of sqrt(in-degree)
                # roundings of 2^-24 relative, bounded at 8 times that
                indeg = int(torch.bincount(
                    batch["dst"][batch["edge_valid"]].long()).max())
                drift = float((out - first).abs().max())
                drift_bar = 8 * indeg ** 0.5 * 2.0 ** -24 * max(
                    1.0, float(out.abs().max()))
                if drift > drift_bar:
                    raise AssertionError(f"gat-cora {name}: runs differ by "
                                         f"{drift!r} (bar {drift_bar!r})")
                err, sub_edges = _check_nodes_gat(cfg, model, batch, out)
                if inputs == "seeded" and PROFILED["gat-cora"] == name:
                    _profiled(f"gat-cora {name}",
                              lambda: gnn.forward(model, batch, cfg))
            _cell_line(
                "gat-cora", cell, inputs, ms, d["n_nodes"],
                api.model_flops(cfg, cell), peak,
                {"inputs_made_ms": made_ms,
                 "edges_per_s": d["n_edges_padded"] / statistics.median(ms)
                 * 1e3, "max_in_degree": indeg,
                 "run_to_run_max_abs_diff": drift,
                 "run_to_run_bar": drift_bar,
                 "check_nodes_max_abs_err": err,
                 "check_subgraph_edges": sub_edges})
            if err is None:
                log(f"  gat-cora {name} ({inputs}): card vs CPU not run: "
                    f"nodes 0-63 and their sources take {sub_edges} edges "
                    f"(limit {CHECK_MAX_EDGES})")
            del batch, out, first
        del model
    torch.cuda.empty_cache()


def run_recsys(dev, card: str):
    """Phase 14: the four recsys models and the GAT at their full CONFIGs,
    seeded random weights made on the card. Returns the phase's launch
    counts (no kernel lies on this path: all 0)."""
    import torch
    from repro_torch import kernels as tk
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[14] recsys and GNN serving paths at full width ({card}); ms: "
        f"median of {RECSYS_REPS} synced runs; f32 peak "
        f"{F32_OPS_PER_S!r} op/s; TF32 off")
    tk.reset_launches()
    for arch in RECSYS_ARCHS:
        recsys_arch(dev, arch, card)
    gat_cells(dev, card)
    launches = dict(tk.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"recsys/GNN path launched kernels {launches}")
    log(f"  recsys/GNN launches (none expected): {launches}; phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 15: training on the card.
# ---------------------------------------------------------------------------

TRAIN_ARCH = "h2o-danube-1.8b"
# train_4k is 256 rows of 4096 tokens, a pod's batch: one card takes 2.
TRAIN_BATCH, TRAIN_SEQ = 2, 4096
TRAIN_WARMUP, TRAIN_TIMED = 2, 6
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=TRAIN_WARMUP
                 + TRAIN_TIMED)
# One step at full width with the kernel forward against the same step
# with the twin forward (bf16): the kernel rounds P to bf16 (2^-8 relative
# RMS on each attention output) at 24 layers, and the rest of the step
# rounds the same way on both sides; by the derivation beside
# LM_BF16_REL_RMS ~2.3% relative RMS is expected downstream, bounded at 5%
# for each gradient leaf and the global norm. The loss (~10.9) averages
# 8192 tokens' errors, bounded at 0.05.
TRAIN_BF16_REL, TRAIN_LOSS_GAP = 0.05, 0.05
# Random weights give N(0, 1) logits (unit-RMS final norm, head std
# 1/sqrt(d)), whose cross entropy is ln V + 1/2; the first loss must lie
# within 0.5 of it.
TRAIN_FIRST_LOSS_GAP = 0.5
TRAIN_SMOKE_ARCHS = ("h2o-danube-1.8b", "mixtral-8x22b")
TRAIN_SMOKE_STEPS = 8
# f32, TF32 off: ~1e-6 relative a step from sums in another order, which
# AdamW's m / sqrt(v) amplifies where a gradient is near zero.
TRAIN_SMOKE_RTOL = 1e-3
TRAIN_RECSYS_ARCHS = ("bst", "xdeepfm", "two-tower-retrieval", "bert4rec")
# bert4rec's 8,192 shared negatives give [B, 30, 8192] f32 logits (8 GiB at
# 8,192 rows, 64 GiB at train_batch's 65,536): 8,192 rows. two-tower's
# in-batch softmax holds [B, B] f32 logits, 16 GiB a copy at 65,536 rows
# (the step ran out of the card's memory there): halved to 32,768.
TRAIN_RECSYS_BATCH = {"bert4rec": 8192, "two-tower-retrieval": 32768}
# two-tower's 10M + 10M rows of 256 f32 (19.1 GiB) with their dense
# gradients and AdamW's m and v are 76 GiB: 5M + 5M rows (38 GiB).
TRAIN_TWO_TOWER_ROWS = 5_000_000
TRAIN_PEAK_GIB = 70.0
# 64 rows card against CPU, f32, TF32 off: the loss within rtol 1e-5 (the
# serving bar), each gradient leaf within 1e-4 of its largest magnitude
# (the CPU tests hold the port to JAX at 2e-5; the card's atomics add
# table rows in another order).
TRAIN_CHECK_GRAD = 1e-4


class _AttentionThrough:
    """Route ``ops.flash_attention`` through ``wrap(kernel_call)`` inside
    the block (the model looks the wrapper up at each call)."""

    def __init__(self, wrap):
        self.wrap = wrap

    def __enter__(self):
        from repro_torch.kernels import ops
        self.kernel_call = ops.flash_attention
        ops.flash_attention = self.wrap(self.kernel_call)

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_attention = self.kernel_call


def _twin(_kernel_call):
    from repro_torch.kernels import ref
    return lambda q, k, v, causal=True, window=0: ref.flash_attention_ref(
        q, k, v, causal=causal, window=window)


def train_smoke_card_vs_cpu(dev) -> None:
    """Phase 15 (a): danube's and mixtral's SMOKE models (f32, TF32 off),
    8 AdamW steps on the card against the same 8 on the CPU from the same
    weights and token batches: each step's loss within rtol 1e-3."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.lm_data import LMDataConfig, SyntheticTokenStream
    from repro_torch.models import api, transformer as tr
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import (TrainConfig,
                                                 init_train_state,
                                                 make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    tcfg = TrainConfig(opt=opt.AdamWConfig(lr=3e-3, warmup_steps=2,
                                           total_steps=TRAIN_SMOKE_STEPS))
    for arch in TRAIN_SMOKE_ARCHS:
        cfg = get_arch(arch).smoke_config
        data = SyntheticTokenStream(LMDataConfig(
            vocab_size=cfg.vocab_size, seq_len=64, batch_size=4, seed=SEED))
        losses = []
        for d in ("cpu", dev):
            model = tr.init_params(
                cfg, generator=torch.Generator().manual_seed(SEED),
                device="cpu").to(d)
            state = init_train_state(model, tcfg)
            step = make_train_step(api.loss_fn(cfg), tcfg)
            out = []
            for s in range(TRAIN_SMOKE_STEPS):
                model, state, m = step(model, state, {
                    "tokens": torch.from_numpy(data.batch(s)).to(d)})
                out.append(float(m["loss"]))
            losses.append(out)
        cpu, card = losses
        gap = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
        log(f"  {arch} SMOKE, {TRAIN_SMOKE_STEPS} train steps card vs CPU: "
            f"losses {card!r} (CPU {cpu!r}), max rel gap {gap!r} (rtol "
            f"{TRAIN_SMOKE_RTOL})")
        if gap > TRAIN_SMOKE_RTOL or not card[-1] < card[0]:
            raise AssertionError(f"{arch} SMOKE training differs on the "
                                 f"card or does not learn")


def _grad_gap(model, ga, gb):
    """(global norms of ga and gb, the worst JAX leaf's relative RMS gap
    and its path)."""
    from repro_torch.training import optimizer as opt
    runs, names = opt.groups(model), [n for n, _ in opt.named_leaves(model)]
    worst = (0.0, None)
    for run in runs:
        num = sum(float((ga[i].float() - gb[i].float()).square().sum())
                  for i in run)
        den = sum(float(gb[i].float().square().sum()) for i in run)
        rel = (num / max(den, 1e-30)) ** 0.5
        if rel >= worst[0]:
            worst = (rel, names[run[0]])
    return (float(opt.global_norm(ga, runs)), float(opt.global_norm(gb, runs)),
            worst)


def _train_step_split(model, state, batch, loss_fn, tcfg):
    """One more train step, timed by CUDA events in three parts: the
    forward (the loss), the backward (the recomputed forward and the
    gradients) and the AdamW update. Returns their ms."""
    import torch
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import trainable
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ps = opt.leaves(model)
    torch.cuda.synchronize()
    with trainable(ps):
        ev[0].record()
        loss, _ = loss_fn(model, batch)
        ev[1].record()
        grads = list(torch.autograd.grad(loss, ps))
        ev[2].record()
    _, state["opt"], _ = opt.apply_updates(model, grads, state["opt"],
                                           tcfg.opt)
    ev[3].record()
    ev[3].synchronize()
    return {name: ev[i].elapsed_time(ev[i + 1]) for i, name in
            enumerate(("forward", "backward", "optimizer"))}


def _stream_batch(kw, step):
    from repro_torch.data.lm_data import LMDataConfig, SyntheticTokenStream
    return SyntheticTokenStream(LMDataConfig(**kw)).batch(step)


def stream_batches(kw, steps):
    """``SyntheticTokenStream(LMDataConfig(**kw)).batch(s)`` for each step,
    one spawned process a batch at a time (the stream draws a batch token
    by token on the host, ~3 s at 2 x 4097 tokens); the pool is shut down
    on return."""
    import concurrent.futures as cf
    import multiprocessing as mp
    with cf.ProcessPoolExecutor(max_workers=min(len(steps), 8),
                                mp_context=mp.get_context("spawn")) as ex:
        return list(ex.map(_stream_batch, [kw] * len(steps), steps))


def train_full_width(dev, card, rows):
    """Phase 15 (b): h2o-danube-1.8b at its published widths and depth,
    bf16, remat "full", random weights from a seed made on the card, AdamW
    with master weights, the token stream's batches of 2 x 4096. Returns
    the timed steps' launch counts."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.configs import get_arch
    from repro_torch.data.lm_data import LMDataConfig, SyntheticTokenStream
    from repro_torch.models import api, transformer as tr
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import (TrainConfig,
                                                 init_train_state,
                                                 make_train_step,
                                                 value_and_grad)
    cfg = get_arch(TRAIN_ARCH).config
    B, T, n_steps = TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP + TRAIN_TIMED
    t0 = time.perf_counter()
    batches = [{"tokens": torch.from_numpy(b).to(dev)} for b in stream_batches(
        dict(vocab_size=cfg.vocab_size, seq_len=T, batch_size=B, seed=SEED),
        list(range(n_steps)))]
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = tr.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
        device=dev)
    torch.cuda.synchronize()
    log(f"[15] training at full width ({card}): {cfg}, {cfg.param_count()} "
        f"parameters made on the card in {time.perf_counter() - t0:.2f} s; "
        f"batch {B} x {T} tokens (train_4k's 256 rows cut to {B}); AdamW "
        f"{TRAIN_OPT}, master weights; {n_steps} token batches drawn in "
        f"{draw_s:.1f} s on the host, in parallel processes")
    loss_fn = api.loss_fn(cfg)

    # (b1) one step's loss and gradients, kernel forward against twin
    (lk, _), gk = value_and_grad(loss_fn, model, batches[0])
    with _AttentionThrough(_twin):
        (lt, _), gt = value_and_grad(loss_fn, model, batches[0])
    nk, nt, (worst, where) = _grad_gap(model, gk, gt)
    dloss, dnorm = abs(float(lk) - float(lt)), abs(nk - nt) / nt
    log(f"  one step, kernel forward vs twin forward: loss {float(lk)!r} vs "
        f"{float(lt)!r} (gap {dloss!r}, bound {TRAIN_LOSS_GAP}); grad norm "
        f"{nk!r} vs {nt!r} (rel gap {dnorm!r}, bound {TRAIN_BF16_REL}); "
        f"worst leaf rel RMS {worst!r} at {where} (bound {TRAIN_BF16_REL})")
    if dloss > TRAIN_LOSS_GAP or dnorm > TRAIN_BF16_REL or \
            worst > TRAIN_BF16_REL or not math.isfinite(float(lk)):
        raise AssertionError("the kernel forward's gradients disagree with "
                             "the twin's")
    del gk, gt
    torch.cuda.empty_cache()

    # (b2) the steps: warmup, then the timed ones with the counts at 0
    tcfg = TrainConfig(opt=opt.AdamWConfig(**TRAIN_OPT))
    state = init_train_state(model, tcfg)
    step = make_train_step(loss_fn, tcfg)
    losses, ms = [], []
    for s in range(n_steps):
        if s == TRAIN_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tk.reset_launches()
        (model, state, m), t = _synced_ms(
            lambda: step(model, state, batches[s]))
        losses.append(float(m["loss"]))
        ms.append(t)
    launches = dict(tk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = TRAIN_TIMED * cfg.n_layers * (2 if cfg.remat == "full" else 1)
    missing = [n for n in tk.PATH_KERNELS["train"] if launches[n] <= 0]
    if missing or launches["flash_attention"] != want:
        raise AssertionError(f"train steps launched {launches}, want "
                             f"flash_attention {want}")
    first_exp = math.log(cfg.vocab_size) + 0.5
    if not all(map(math.isfinite, losses)) or \
            abs(losses[0] - first_exp) > TRAIN_FIRST_LOSS_GAP or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses}")
    timed = ms[TRAIN_WARMUP:]
    step_ms = statistics.median(timed)
    flops = api.model_flops(cfg, api.ShapeCell("t", "train", {"batch": B,
                                                              "seq": T}))
    rec = {"step_ms": step_ms, "steps_ms": timed, "warmup_ms":
           ms[:TRAIN_WARMUP], "tokens_per_s": B * T / step_ms * 1e3,
           "model_flops": flops, "bf16_peak_share": flops / (step_ms * 1e-3)
           / BF16_TC_OPS_PER_S, "peak_gib": peak, "losses": losses,
           "first_loss_expected": first_exp,
           "flash_attention_launches": launches["flash_attention"]}
    log(f"[15] danube train steps ({card}): {json.dumps(rec)}")
    _profiled("train step", lambda: step(model, state, batches[-1]))
    split = _train_step_split(model, state, batches[-1], loss_fn, tcfg)
    total = sum(split.values())
    log(f"  train step by CUDA events: {json.dumps(split)} ms; backward "
        f"{100 * split['backward'] / total!r}% of {total!r} ms")

    # flash_attention at the train step's layer-0 q/k/v
    captured = []

    def capture(kernel_call):
        def fn(q, k, v, causal=True, window=0):
            if not captured:
                captured.append((q, k, v))
            return kernel_call(q, k, v, causal, window)
        return fn
    with torch.no_grad(), _AttentionThrough(capture):
        tr.forward(model, batches[0]["tokens"][:, :-1], cfg)
    del model, state, batches
    torch.cuda.empty_cache()
    log("[2] flash_attention at the train step's layer-0 shapes")
    row = check_flash_attention(*captured[0], cfg.window,
                                must_beat_sdpa=False)
    rows.setdefault("flash_attention", {})["train_shape"] = row
    log(f"  flash_attention at the train step's shape: {json.dumps(row)}")
    return launches


def _rows_check(cfg, cell, model, batch):
    """Loss and gradients of the first 64 rows (a GAT: its whole graph) on
    the card against the port's CPU path: (loss error, worst leaf's error
    over its largest magnitude). two-tower's CPU model holds only the
    table rows those ids touch (ids renumbered, 0 kept as padding)."""
    import torch
    from repro_torch.models import api, gnn, recsys
    from repro_torch.models.convert import model_from_jax, model_to_numpy
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import value_and_grad
    if isinstance(cfg, gnn.GATConfig):
        rows = batch
    else:
        rows = {k: v if k == "neg_ids" else v[:CHECK_ROWS]
                for k, v in batch.items()}
    (loss, _), grads = value_and_grad(api.loss_fn(cfg), model, rows)
    card = dict(zip([n for n, _ in opt.named_leaves(model)], grads))
    if isinstance(cfg, recsys.TwoTowerConfig):
        users, u_at = torch.unique(rows["user_id"], return_inverse=True)
        items, i_at = torch.unique(torch.cat(
            [torch.zeros(1, dtype=torch.int32, device=users.device),
             rows["hist"].reshape(-1), rows["pos_item"]]),
            return_inverse=True)
        nh = rows["hist"].numel()
        host = {"user_id": u_at.int(),
                "hist": i_at[1:1 + nh].reshape(rows["hist"].shape).int(),
                "pos_item": i_at[1 + nh:].int(),
                "item_logq": rows["item_logq"]}
        cpu_cfg = dataclasses.replace(cfg, n_users=len(users),
                                      n_items=len(items))
        cpu = api.init_params(cpu_cfg, generator=None, device="cpu")
        state = {k: v.cpu() for k, v in model.state_dict().items()
                 if "emb" not in k}
        state["user_emb"] = model.user_emb.detach()[users].cpu()
        state["item_emb"] = model.item_emb.detach()[items].cpu()
        cpu.load_state_dict(state)
        card["user_emb"] = card["user_emb"][users]
        card["item_emb"] = card["item_emb"][items]
    else:
        cpu_cfg, host = cfg, rows
        cpu = model_from_jax(model_to_numpy(model), cfg, device="cpu")
    host = {k: v.cpu() for k, v in host.items()}
    (closs, _), cgrads = value_and_grad(api.loss_fn(cpu_cfg), cpu, host)
    loss_err = abs(float(loss) - float(closs)) / abs(float(closs))
    worst = 0.0
    for (name, _), cg in zip(opt.named_leaves(cpu), cgrads):
        scale = max(float(cg.abs().max()), 1e-30)
        worst = max(worst, float((card[name].cpu() - cg).abs().max())
                    / scale)
    if loss_err > 1e-5 or worst > TRAIN_CHECK_GRAD:
        raise AssertionError(f"{cfg.name}: card vs CPU loss {loss_err!r}, "
                             f"gradients {worst!r}")
    return loss_err, worst, host["x"].shape[0] if "x" in host else \
        CHECK_ROWS


def train_recsys(dev, card) -> None:
    """Phase 15 (c): one ``train_batch`` step (AdamW, no master copy of the
    f32 weights) of bst, xdeepfm, two-tower-retrieval and bert4rec at their
    full ``CONFIG``s, and of gat-cora on Cora (full_graph_sm), f32 with
    TF32 off, on ids drawn over each whole table; first the 64-row card
    against CPU check of the loss and every gradient leaf."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.configs import gat_cora, get_arch
    from repro_torch.models import api
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import (TrainConfig,
                                                 init_train_state,
                                                 make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    tcfg = TrainConfig(opt=opt.AdamWConfig(master_weights=False))
    for arch in TRAIN_RECSYS_ARCHS + ("gat-cora",):
        spec, cut = get_arch(arch), []
        if arch == "gat-cora":
            cell = spec.cell("full_graph_sm")
            cfg = gat_cora.adapt_config(spec.config, cell)
        else:
            cell, cfg = spec.cell("train_batch"), spec.config
            if arch in TRAIN_RECSYS_BATCH:
                cut.append(f"batch {cell.dims['batch']} -> "
                           f"{TRAIN_RECSYS_BATCH[arch]}")
                cell = dataclasses.replace(cell, dims=dict(
                    cell.dims, batch=TRAIN_RECSYS_BATCH[arch]))
            if arch == "two-tower-retrieval":
                cut.append(f"tables {cfg.n_users} + {cfg.n_items} rows -> "
                           f"{TRAIN_TWO_TOWER_ROWS} + {TRAIN_TWO_TOWER_ROWS}")
                cfg = dataclasses.replace(cfg, n_users=TRAIN_TWO_TOWER_ROWS,
                                          n_items=TRAIN_TWO_TOWER_ROWS)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = api.init_params(
            cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
            device=dev)
        batch = seeded_batch(cfg, cell, dev,
                             torch.Generator(device=dev).manual_seed(SEED))
        loss_err, grad_err, n_rows = _rows_check(cfg, cell, model, batch)
        state = init_train_state(model, tcfg)
        step = make_train_step(api.loss_fn(cfg), tcfg)
        tk.reset_launches()
        (model, state, m), ms = _synced_ms(lambda: step(model, state,
                                                        batch))
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = dict(tk.LAUNCHES)
        rows = cell.dims.get("batch", cell.dims.get("n_nodes"))
        flops = api.model_flops(cfg, cell)
        rec = {"ms": ms, "rows": rows, "rows_per_s": rows / ms * 1e3,
               "model_flops": flops, "f32_peak_share": flops / (ms * 1e-3)
               / F32_OPS_PER_S, "peak_gib": peak, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "cuts": cut,
               "check_rows": n_rows, "check_loss_rel_err": loss_err,
               "check_grad_err_over_leaf_max": grad_err}
        log(f"[15] {arch} {cell.name} train step ({card}): {json.dumps(rec)}")
        if any(launches.values()) or peak > TRAIN_PEAK_GIB or \
                not math.isfinite(rec["loss"]):
            raise AssertionError(f"{arch} train step: launches {launches}, "
                                 f"peak {peak} GiB, loss {rec['loss']}")
        del model, state, batch
    torch.cuda.empty_cache()


def run_train(dev, card: str, rows):
    """Phase 15: training. Returns the full-width danube steps' launch
    counts."""
    t_phase = time.perf_counter()
    log(f"[15] training: SMOKE models, card vs CPU ({card})")
    train_smoke_card_vs_cpu(dev)
    launches = train_full_width(dev, card, rows)
    train_recsys(dev, card)
    log(f"  training phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 16: the paper's §3 batch baseline.
# ---------------------------------------------------------------------------

BATCH_TICKS = 90              # jobs at ticks 20, 40, 60 and 80
BATCH_SMALL_TICKS = 40        # (a): jobs at ticks 20 and 40
BATCH_TICKS_PER_HOUR = 20     # one compressed "hour" of logs
BATCH_WINDOW_HOURS = 2
BATCH_EVENT_AT = 30
BATCH_SEED = 1
BATCH_HEAD_K = 8              # the head query's suggestions looked at
STREAM_TARGET_S = 600.0       # the paper's 10 minutes
# The single-lane decay_prune's total against the plain version's: two
# plain sums over the same lane in different orders.
DECAY_TOTAL_RTOL = 1e-5
# The two-pass insert's weight lane, card against CPU: a key's rows summed
# in another order (the parity contract's weight tolerance).
TWOPASS_WEIGHT_RTOL = 2e-3


def batch_configs(full: bool):
    """(EngineConfig, StreamConfig) of phase 16: the breaking-news
    benchmark's sizes, or the hash cell's widths with its rank cadence of
    5 sim-minutes; both with 30-s ticks."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.data.stream import StreamConfig
    if full:
        return (EngineConfig(query_capacity=1 << 22, cooc_capacity=1 << 24,
                             session_capacity=1 << 20, decay_every=4,
                             rank_every=10),
                StreamConfig(vocab_size=65536, n_users=200000,
                             queries_per_tick=16384, tweets_per_tick=2048,
                             tick_seconds=30.0))
    return (EngineConfig(query_capacity=1 << 14, cooc_capacity=1 << 16,
                         session_capacity=1 << 13, decay_every=4,
                         rank_every=10),
            StreamConfig(vocab_size=1024, queries_per_tick=1024,
                         tweets_per_tick=64, tick_seconds=30.0))


def batch_stream(base):
    """The steve-jobs event moved to ``BATCH_EVENT_AT`` on ``base``, seed
    ``BATCH_SEED``. Returns (stream, head fp, related fps, event start s)."""
    from repro_torch.data.stream import SyntheticStream, steve_jobs_scenario
    scfg, event = steve_jobs_scenario(base_cfg=base)
    scfg = dataclasses.replace(scfg, events=(
        dataclasses.replace(event, t_start=BATCH_EVENT_AT),))
    event = scfg.events[0]
    stream = SyntheticStream(scfg, seed=BATCH_SEED)
    return (stream, int(stream.tok.query_fp(event.terms[0])),
            {int(stream.tok.query_fp(t)) for t in event.terms[1:]},
            event.t_start * scfg.tick_seconds)


def batch_pipeline(ecfg, scfg, device):
    from repro_torch.data.batch_pipeline import (BatchPipeline,
                                                 HadoopLatencyModel)
    pipe = BatchPipeline(ecfg, HadoopLatencyModel(),
                         tick_seconds=scfg.tick_seconds,
                         window_hours=BATCH_WINDOW_HOURS, device=device)
    pipe.ticks_per_hour = BATCH_TICKS_PER_HOUR
    return pipe


def expected_done_s(pipe, job: int) -> float:
    """Job ``job``'s completion by the latency model, from its hours
    alone: the window is hours max(0, job - window + 1)..job, each
    visible an import lag after its last tick."""
    hours = range(max(0, job - pipe.window_hours + 1), job + 1)
    avail = max((h + 1) * pipe.ticks_per_hour * pipe.tick_seconds
                + pipe.latency.import_lag_s for h in hours)
    return avail + pipe.latency.compute_time_s(float(len(hours)))


def batch_card_vs_cpu(dev) -> None:
    """(a) BatchPipeline on the card against the same pipeline on the CPU,
    on the breaking-news benchmark's sizes cut to 40 ticks."""
    ecfg, base = batch_configs(full=False)
    stream, _, _, _ = batch_stream(base)
    ticks = [stream.gen_tick(t) for t in range(BATCH_SMALL_TICKS)]
    pipes = {}
    for device in (dev, "cpu"):
        t0 = time.perf_counter()
        pipes[device] = batch_pipeline(ecfg, stream.cfg, device)
        for ev, tw in ticks:
            pipes[device].ingest_tick(ev, tw)
        log(f"  (a) {BATCH_SMALL_TICKS} ticks on {device}: "
            f"{time.perf_counter() - t0:.1f} s")
    card, cpu = pipes[dev].results, pipes["cpu"].results
    if len(card) != len(cpu) or len(card) != \
            BATCH_SMALL_TICKS // BATCH_TICKS_PER_HOUR:
        raise AssertionError(f"(a) jobs: {len(card)} on the card, "
                             f"{len(cpu)} on the CPU")
    for i, ((sa, da), (sb, db)) in enumerate(zip(card, cpu)):
        if da != db or da != expected_done_s(pipes[dev], i):
            raise AssertionError(f"(a) job {i}: done_s {da} on the card, "
                                 f"{db} on the CPU")
        log(f"  (a) job {i} (hour {i}), card vs CPU: done_s {da!r} on "
            f"both; " + suggestions_contract(sa, sb, f"(a) job {i}"))


def _timed_batch_engines(jobs):
    """Patch ``data.batch_pipeline``'s engine class with a subclass that
    times (synced) each job's construction, steps and rank cycle into
    ``jobs`` and records its live slots and drops. Returns the undo."""
    import torch
    from repro_torch.data import batch_pipeline as bp
    base = bp.SearchAssistanceEngine

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    class TimedEngine(base):
        def __init__(self, *a, **kw):
            torch.cuda.reset_peak_memory_stats()
            _, ms = synced(lambda: super(TimedEngine, self).__init__(*a, **kw))
            jobs.append({"name": self.name, "construct_ms": ms, "ticks": 0,
                         "ingest_ms": 0.0})

        def step(self, *a, **kw):
            out, ms = synced(lambda: super(TimedEngine, self).step(*a, **kw))
            jobs[-1]["ticks"] += 1
            jobs[-1]["ingest_ms"] += ms
            return out

        def run_rank_cycle(self):
            out, ms = synced(super().run_rank_cycle)
            st = self.state
            jobs[-1].update(
                rank_ms=ms, n_suggest=len(self.suggestions),
                live_qstore=int(st.qstore.live_count()),
                live_cooc=int(st.cooc.live_count()),
                n_dropped={n: int(getattr(st, n).n_dropped)
                           for n in ("qstore", "cooc", "sessions")},
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            return out

    bp.SearchAssistanceEngine = TimedEngine

    def undo():
        bp.SearchAssistanceEngine = base
    return undo


def hadoop_latency_s(pipe, head, related, t_event_s, best_case):
    """``benchmarks/bench_latency.py``'s batch time to suggestion: the
    earliest job whose table holds a related term for the head query,
    done an import lag plus a window's compute after its last log."""
    model, best = pipe.latency, None
    for i, (sugg, _) in enumerate(pipe.results):
        if {d for d, _ in sugg.get(head, [])} & related:
            lag = model.import_lag_best_s if best_case else model.import_lag_s
            done = (pipe.hours[i].generated_at_s + lag
                    + model.compute_time_s(pipe.window_hours))
            best = done if best is None else min(best, done)
    return best - t_event_s if best is not None else math.inf


def batch_vs_streaming(dev, card: str):
    """(b) The paper's comparison at the hash cell's widths: one stream fed
    to a streaming engine and to the batch pipeline, tick by tick. Returns
    ({"batch": launches, "streaming": launches}, the streaming engine, the
    last tick's (events, tweets))."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core.engine import SearchAssistanceEngine
    ecfg, base = batch_configs(full=True)
    stream, head, related, t_event_s = batch_stream(base)
    tick_s = stream.cfg.tick_seconds
    eng = SearchAssistanceEngine(ecfg, device=dev)
    pipe = batch_pipeline(ecfg, stream.cfg, dev)
    jobs, step_ms, rank_ms, draw_ms = [], [], [], 0.0
    rank = eng.run_rank_cycle

    def timed_rank():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rank()
        torch.cuda.synchronize()
        rank_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    eng.run_rank_cycle = timed_rank
    launches = {"batch": {n: 0 for n in tk.KERNELS},
                "streaming": {n: 0 for n in tk.KERNELS}}

    def counted(path, fn):
        torch.cuda.synchronize()
        tk.reset_launches()
        fn()
        torch.cuda.synchronize()
        for n, k in tk.LAUNCHES.items():
            launches[path][n] += k

    stream_latency = None
    undo = _timed_batch_engines(jobs)
    try:
        for t in range(BATCH_TICKS):
            t0 = time.perf_counter()
            ev, tw = stream.gen_tick(t)
            draw_ms += (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            counted("streaming", lambda: eng.step(ev, tw))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            counted("batch", lambda: pipe.ingest_tick(ev, tw))
            if stream_latency is None and eng.suggestions:
                hits = {d for d, _ in eng.suggest_fp(head, k=BATCH_HEAD_K)}
                if hits & related:
                    stream_latency = t * tick_s - t_event_s
    finally:
        undo()
    n_jobs = BATCH_TICKS // BATCH_TICKS_PER_HOUR
    if len(pipe.results) != n_jobs or len(jobs) != n_jobs:
        raise AssertionError(f"(b) {len(pipe.results)} jobs ran")
    first = None
    for i, ((sugg, done), job) in enumerate(zip(pipe.results, jobs)):
        job["done_s"] = done
        job["hour"] = i
        job["related_terms"] = len(
            {d for d, _ in sugg.get(head, [])} & related)
        if first is None and job["related_terms"]:
            first = i
        want = min(i + 1, BATCH_WINDOW_HOURS) * BATCH_TICKS_PER_HOUR
        if job["ticks"] != want or any(job["n_dropped"].values()) \
                or not sugg or job["n_suggest"] != len(sugg) \
                or done != expected_done_s(pipe, i):
            raise AssertionError(f"(b) job {i}: {job}")
    if stream_latency is None or stream_latency > STREAM_TARGET_S:
        raise AssertionError(f"(b) streaming time to suggestion "
                             f"{stream_latency} s")
    want = {"score_gate": n_jobs, "bucket_topk": n_jobs}
    got = {n: k for n, k in launches["batch"].items() if k}
    if got != want:
        raise AssertionError(f"(b) batch launches {got}, want {want}")
    for n in tk.PATH_KERNELS["hash"]:
        if launches["streaming"][n] <= 0:
            raise AssertionError(f"(b) streaming: {n} not launched")
    lat = {"streaming": stream_latency,
           "batch_typical": hadoop_latency_s(pipe, head, related, t_event_s,
                                             False),
           "batch_best_case": hadoop_latency_s(pipe, head, related,
                                               t_event_s, True)}
    if not all(math.isfinite(v) for v in lat.values()):
        raise AssertionError(f"(b) times to suggestion: {lat}")
    # each job resets the peak as it starts, so the phase's is the largest
    peak = max([j["peak_gib"] for j in jobs]
               + [torch.cuda.max_memory_allocated() / 2**30])
    for job in jobs:
        job["ms_a_tick"] = job["ingest_ms"] / job["ticks"]
        job["wall_ms"] = job["construct_ms"] + job["ingest_ms"] + \
            job["rank_ms"]
    rec = {"card": card, "ticks": BATCH_TICKS,
           "ticks_per_hour": BATCH_TICKS_PER_HOUR,
           "window_hours": BATCH_WINDOW_HOURS, "event_at": BATCH_EVENT_AT,
           "jobs": jobs, "first_job_with_a_related_term": first,
           "streaming_ms_a_tick_p50": statistics.median(step_ms),
           "streaming_ms_a_tick_max": max(step_ms),
           "streaming_rank_ms": rank_ms,
           "streaming_live_qstore": int(eng.state.qstore.live_count()),
           "streaming_live_cooc": int(eng.state.cooc.live_count()),
           "stream_draw_ms": draw_ms, "peak_gib": peak,
           "time_to_suggestion_sim_min": {k: v / 60 for k, v in lat.items()},
           "launches": {p: {n: k for n, k in d.items() if k}
                        for p, d in launches.items()}}
    log(f"[16] batch vs streaming ({card}): " + json.dumps(rec))
    for job in jobs:
        log(f"  (b) {job['name']} ({card}): wall {job['wall_ms']:.3f} ms = "
            f"construct {job['construct_ms']:.3f} + re-ingest "
            f"{job['ticks']} ticks {job['ingest_ms']:.3f} "
            f"({job['ms_a_tick']:.3f} a tick) + rank {job['rank_ms']:.3f}; "
            f"live qstore {job['live_qstore']}, cooc {job['live_cooc']}; "
            f"{job['n_suggest']} sources; related terms for the head "
            f"{job['related_terms']}; done {job['done_s'] / 60:.2f} sim-min;"
            f" peak {job['peak_gib']:.3f} GiB")
    m = rec["time_to_suggestion_sim_min"]
    log(f"  (b) time to suggestion ({card}): streaming "
        f"{m['streaming']!r} sim-min (target 10), batch typical "
        f"{m['batch_typical']!r}, best case {m['batch_best_case']!r} "
        f"(first job with a related term: {first}); streaming engine "
        f"{rec['streaming_ms_a_tick_p50']:.3f} ms a tick (p50), rank "
        f"{rank_ms}")
    log(f"  (b) launches: batch {rec['launches']['batch']}, streaming "
        f"{rec['launches']['streaming']}")
    return launches, eng, (ev, tw)


def check_decay_prune_single(qstore, cfg) -> dict:
    """(c) The single-lane ``decay_prune`` on a live query store
    (C = 2^22): keys, weight lane and live count bit for bit with the
    plain version on the same card tensors, the total within
    ``DECAY_TOTAL_RTOL`` (a different summation order)."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.kernels import ref
    from repro_torch.kernels.decay_prune import decay_prune
    kh, kl, w = qstore.key_hi, qstore.key_lo, qstore.lanes["weight"]
    f, th = float(cfg.decay.factor(cfg.decay_every)), \
        cfg.decay.prune_threshold
    before = tk.LAUNCHES["decay_prune_multi"]
    got = decay_prune(kh, kl, w, f, th)
    if tk.LAUNCHES["decay_prune_multi"] != before + 1:
        raise AssertionError("decay_prune launched no kernel")
    exp = ref.decay_prune_ref(kh, kl, w, torch.tensor(f), th)
    for g, e in zip(got[:3], exp[:3]):
        if not torch.equal(g.view(torch.int32), e.view(torch.int32)):
            raise AssertionError("decay_prune differs from the plain version")
    if int(got[3]) != int(exp[4]):
        raise AssertionError("decay_prune live count differs")
    tot, etot = float(got[4]), float(exp[5])
    if abs(tot - etot) > DECAY_TOTAL_RTOL * abs(etot):
        raise AssertionError(f"decay_prune total {tot} against {etot}")
    ms = time_ms(lambda: decay_prune(kh, kl, w, f, th))
    plain_ms = time_ms(lambda: ref.decay_prune_ref(kh, kl, w,
                                                   torch.tensor(f), th))
    return {"capacity": kh.shape[0], "live_in": int(qstore.live_count()),
            "live_out": int(got[3]), "total": tot, "plain_total": etot,
            "wrapper_ms": ms, "plain_ms": plain_ms}


def check_twopass_insert(dev, events, cfg) -> dict:
    """(c) ``insert_accumulate_twopass`` for one deployment tick's query
    batch into an empty 2^22 table, on the card and on the CPU, beside the
    fused insert on both. Held: keys, slots, the count and tick lanes and
    the drops bit for bit card against CPU; on each device the two-pass
    table the same key-to-value map as the fused one, bit for bit; the
    weight lane card against CPU within ``TWOPASS_WEIGHT_RTOL`` (both
    inserts' segment sums add a key's rows in another order on the card),
    its differing slots and largest relative difference printed."""
    import numpy as np
    import torch
    from repro_torch.core import engine as te
    from repro_torch.core import stores
    from repro_torch.core.hashing import from_np_u32, join_fp, split_fp
    q_hi, q_lo = split_fp(events.q_fp)
    B = len(q_hi)
    lanes = {"weight": torch.float32, "count": torch.float32,
             "last_tick": torch.int32}

    def args(d):
        src = torch.tensor(np.asarray(events.src, np.int32), device=d)
        return (from_np_u32(q_hi, d), from_np_u32(q_lo, d),
                {"weight": te._source_weights(cfg, src),
                 "count": torch.ones((B,), dtype=torch.float32, device=d),
                 "last_tick": torch.full((B,), 7, dtype=torch.int32,
                                         device=d)},
                torch.tensor(np.asarray(events.valid, bool), device=d))

    def host(t):
        return {"key_hi": t.key_hi.cpu(), "key_lo": t.key_lo.cpu(),
                **{n: v.cpu() for n, v in t.lanes.items()},
                "n_dropped": t.n_dropped.cpu()}

    out, ms = {}, {}
    for kind, fn in (("twopass", stores.insert_accumulate_twopass),
                     ("fused", stores.insert_accumulate)):
        for d in (dev, "cpu"):
            t = stores.make_table(cfg.query_capacity, lanes, device=d)
            a = args(d)
            if d != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            t = fn(t, *a, modes=te._Q_MODES, probe_rounds=cfg.probe_rounds)
            if d != "cpu":
                torch.cuda.synchronize()
            ms[f"{kind} {d}"] = (time.perf_counter() - t0) * 1e3
            out[kind, str(d)] = host(t)
    card, cpu = out["twopass", str(dev)], out["twopass", "cpu"]
    diff = {n: int((card[n].view(-1).view(torch.int32)
                    != cpu[n].view(-1).view(torch.int32)).sum())
            for n in card}
    if any(diff[n] for n in card if n != "weight"):
        raise AssertionError(f"insert_accumulate_twopass differs between "
                             f"the card and the CPU: {diff}")
    w_card, w_cpu = card["weight"], cpu["weight"]
    rel = float(((w_card - w_cpu).abs() / w_cpu.abs().clamp_min(1e-30))
                .max())
    if rel > TWOPASS_WEIGHT_RTOL:
        raise AssertionError(f"twopass weights card vs CPU: {rel}")
    fused_diff = int((out["fused", str(dev)]["weight"]
                      != out["fused", "cpu"]["weight"]).sum())
    for d in (str(dev), "cpu"):
        a, f = out["twopass", d], out["fused", d]
        live = lambda t: (t["key_hi"] != 0) | (t["key_lo"] != 0)
        ka = join_fp(a["key_hi"][live(a)].numpy().view(np.uint32),
                     a["key_lo"][live(a)].numpy().view(np.uint32))
        kf = join_fp(f["key_hi"][live(f)].numpy().view(np.uint32),
                     f["key_lo"][live(f)].numpy().view(np.uint32))
        oa, of = np.argsort(ka), np.argsort(kf)
        same = int(a["n_dropped"]) == int(f["n_dropped"]) == 0 and \
            np.array_equal(ka[oa], kf[of]) and all(
                a[n][live(a)].numpy()[oa].tobytes()
                == f[n][live(f)].numpy()[of].tobytes() for n in lanes)
        if not same:
            raise AssertionError(f"insert_accumulate_twopass and the fused "
                                 f"insert give different maps on {d}")
    _, counts = np.unique(events.q_fp[np.asarray(events.valid, bool)],
                          return_counts=True)
    slots_same = int(((card["key_hi"] == out["fused", str(dev)]["key_hi"])
                      & (card["key_lo"] == out["fused", str(dev)]["key_lo"])
                      & ((card["key_hi"] != 0) | (card["key_lo"] != 0)))
                     .sum())
    return {"batch": B, "unique_keys": len(ka),
            "most_rows_a_key": int(counts.max()), "ms": ms,
            "weight_slots_differing_card_vs_cpu": diff["weight"],
            "weight_max_rel_diff_card_vs_cpu": rel,
            "fused_weight_slots_differing_card_vs_cpu": fused_diff,
            "slots_shared_with_fused": slots_same}


def run_batch(dev, card: str):
    """Phase 16: the paper's §3 batch baseline (Take One) against the
    streaming engine (Take Two). Returns {"batch": ..., "batch_streaming":
    ...} launch counts."""
    import torch
    t_phase = time.perf_counter()
    log(f"[16] the §3 batch baseline: (a) card vs CPU at the breaking-news "
        f"benchmark's sizes ({card})")
    batch_card_vs_cpu(dev)
    log(f"[16] (b) batch vs streaming at the hash cell's widths, "
        f"{BATCH_TICKS} ticks ({card})")
    launches, eng, (ev, _) = batch_vs_streaming(dev, card)
    ecfg = eng.cfg
    log("[16] (c) item 15's entries on the phase's inputs")
    r = check_decay_prune_single(eng.state.qstore, ecfg)
    log(f"  decay_prune on the streaming engine's qstore: {json.dumps(r)}; "
        f"lanes and live count equal to the plain version, total within "
        f"rtol {DECAY_TOTAL_RTOL}")
    del eng
    torch.cuda.empty_cache()
    r = check_twopass_insert(dev, ev, ecfg)
    log(f"  insert_accumulate_twopass, the last tick's query batch into a "
        f"{ecfg.query_capacity}-slot table: {json.dumps(r)}; keys, slots, "
        f"counts, ticks and drops equal card vs CPU, weights within rtol "
        f"{TWOPASS_WEIGHT_RTOL}; on each device the same map as the fused "
        f"insert")
    torch.cuda.empty_cache()
    log(f"  batch phase took {time.perf_counter() - t_phase:.1f} s")
    return {"batch": launches["batch"],
            "batch_streaming": launches["streaming"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-region-only", action="store_true",
                    help="profile the region cell's ingest tick and rank "
                         "cycle, and nothing else")
    ap.add_argument("--profile-hash-only", action="store_true",
                    help="profile the hash cell's ingest tick and rank "
                         "cycle and time score_gate and assoc_score, and "
                         "nothing else")
    ap.add_argument("--flash-crowd-only", action="store_true",
                    help="build the kernels and run phase 9 (the flash "
                         "crowd), and nothing else")
    ap.add_argument("--tune-only", action="store_true",
                    help="build the kernels and run phase 10 (tuning and "
                         "the oracle), and nothing else")
    ap.add_argument("--fleet-only", action="store_true",
                    help="build the kernels and run phase 11 (the "
                         "replicated fleet), and nothing else")
    ap.add_argument("--sharded-only", action="store_true",
                    help="build the kernels and run phase 12 (the sharded "
                         "engine), and nothing else")
    ap.add_argument("--moe-only", action="store_true",
                    help="build the kernels and run the MoE SMOKE models "
                         "card vs CPU and phase 13 (the MoE LM serving "
                         "path), and nothing else")
    ap.add_argument("--recsys-only", action="store_true",
                    help="run the recsys and GNN SMOKE models card vs CPU "
                         "and phase 14 (the recsys and GNN serving paths), "
                         "and nothing else")
    ap.add_argument("--train-only", action="store_true",
                    help="build flash_attention and run phase 15 "
                         "(training), and nothing else")
    ap.add_argument("--batch-only", action="store_true",
                    help="build the kernels and run phase 16 (the §3 batch "
                         "baseline against the streaming engine), and "
                         "nothing else")
    ap.add_argument("--root", default=str(ROOT),
                    help="with --profile-region-only or --profile-hash-only:"
                         " a directory inside this checkout whose "
                         "src/repro_torch is profiled")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    profile = args.profile_region_only or args.profile_hash_only
    if root != ROOT and not (profile and root.is_relative_to(ROOT)):
        print("chip_smoke: --root takes a directory inside this checkout, "
              "with --profile-region-only or --profile-hash-only",
              file=sys.stderr)
        return 2
    if not (root / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    if args.profile_region_only:
        profile_region()
    if args.profile_hash_only:
        profile_hash()
    if profile:
        return 0
    from repro_torch import kernels as tk
    from repro_torch.kernels import build
    bind_peaks()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    t_start = time.perf_counter()
    if args.recsys_only:    # no kernel lies on this path: nothing to build
        log(f"[1] card: {card} | torch {torch.__version__} cuda "
            f"{torch.version.cuda}")
        log("[3] recsys and GNN SMOKE models on the card vs the CPU")
        small_recsys(dev)
        run_recsys(dev, card)
        log(f"  total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.train_only:     # one kernel lies on this path: build it alone
        log(f"[1] card: {card} | torch {torch.__version__} cuda "
            f"{torch.version.cuda}")
        t0 = time.perf_counter()
        build.build_all(("flash_attention",))
        build.load("flash_attention")
        log(f"  built flash_attention in {time.perf_counter() - t0:.1f} s")
        run_train(dev, card, {})
        log(f"  total {time.perf_counter() - t_start:.1f} s")
        return 0
    if (args.flash_crowd_only or args.tune_only or args.fleet_only
            or args.sharded_only or args.moe_only or args.batch_only):
        log(f"[1] card: {card} | torch {torch.__version__} cuda "
            f"{torch.version.cuda}")
        for stem in build.build_all():
            build.load(stem)
        if args.flash_crowd_only:
            run_flash_crowd(dev, card, score_floor())
        if args.tune_only:
            run_tuning(dev, card)
        if args.fleet_only:
            run_fleet(dev, card)
        if args.sharded_only:
            run_sharded(dev, card, score_floor())
        if args.moe_only:
            log("[3] MoE SMOKE models on the card vs the CPU")
            small_lm(dev, MOE_SMOKE_ARCHS)
            run_moe(dev, {})
        if args.batch_only:
            run_batch(dev, card)
        log(f"  total {time.perf_counter() - t_start:.1f} s")
        return 0

    # ---- 1. card and build ----
    log(f"[1] card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    paths = build.build_all()
    for stem in paths:
        build.load(stem)
    log(f"  built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for stem in sorted(paths):
        for line in build.build_log(stem).splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                log(f"  {stem}: {line.strip()}")

    # ---- 2. kernels at main-path shapes ----
    cfg, _ = deployment_config()
    rcfg, _ = deployment_config("region")
    C, Q = cfg.cooc_capacity, cfg.query_capacity
    R = min(Q, int(C * cfg.rank.seg_arena_frac))
    L, K = max(cfg.rank.bucket_rows, cfg.rank.top_k), cfg.rank.top_k
    RW = rcfg.region_w
    log(f"[2] kernels vs plain versions: cooc C={C}, qstore C={Q}, "
        f"grid {R}x{L}, K={K}; region grid {C // RW}x{RW}, "
        f"K1={min(K, RW)}")
    rows = {}
    rows["decay_prune_multi"] = check_decay_prune(C, 6, dev)
    q_row = check_decay_prune(Q, 2, dev)
    log(f"  decay_prune_multi qstore C={Q}: {json.dumps(q_row)}")
    floor = score_floor()
    rows["score_gate"] = check_score_gate(C, dev, floor)
    rows["bucket_topk"] = check_bucket_topk(R, L, K, dev)
    rows["region_rank"] = check_region_rank(C // RW, RW, min(K, RW), dev,
                                            floor)
    rows["assoc_score"] = check_assoc_score(C, dev, floor)
    for name, row in rows.items():
        log(f"  {name} at its main-path shape: {json.dumps(row)}")
    torch.cuda.empty_cache()

    # ---- 3. card vs CPU at a small size ----
    log("[3] engine on the card vs engine on the CPU (test_engine stream)")
    small_spelling(dev, small_parity(dev)[1])
    small_parity(dev, "region")
    small_parity(dev, "region", lazy=True)
    t0 = time.perf_counter()
    log("[3] LM SMOKE models on the card vs the CPU")
    small_lm(dev)
    log(f"  LM SMOKE parity took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("[3] recsys and GNN SMOKE models on the card vs the CPU")
    small_recsys(dev)
    log(f"  recsys/GNN SMOKE parity took {time.perf_counter() - t0:.1f} s")

    # ---- 4. main paths at deployment scale ----
    from repro_torch.data.stream import SyntheticStream
    _, scfg = deployment_config()
    n_ticks = 17
    t0 = time.perf_counter()
    stream = SyntheticStream(scfg, seed=SEED)
    ticks = [stream.gen_tick(t) for t in range(n_ticks)]
    extra_tick = stream.gen_tick(n_ticks)
    log(f"[4] main paths: {n_ticks} ticks of {scfg.queries_per_tick} "
        f"queries + {scfg.tweets_per_tick} tweets; stream generated in "
        f"{time.perf_counter() - t0:.1f} s")
    launches = {}
    for layout in ("hash", "region"):
        launches[layout], qstore = run_main_path(dev, ticks, extra_tick, scfg,
                                                 layout, stream)
        torch.cuda.empty_cache()
        if layout != "hash":
            continue
        log(f"[4] spelling job over the hash path's {n_ticks}-tick qstore")
        launches["spelling"], job = run_spelling(dev, qstore, stream)
        recheck_spelling(dev, job)
        for _ in range(2):
            again = spelling_job(dev, qstore, stream.tok)[3]
            if list(again.items()) != list(job[3].items()):
                raise AssertionError("two spelling jobs differ")
        log(f"[5] determinism: the spelling job twice more, "
            f"{len(job[3])} corrections, same items in the same order")
        log("[2] edit_distance at the spelling job's shapes (untimed run)")
        batch, fc = largest_edit_distance_batch(dev, qstore, stream.tok)
        rows["edit_distance"] = check_edit_distance(batch, fc)
        log(f"  edit_distance at its main-path shape: "
            f"{json.dumps(rows['edit_distance'])}")
        del qstore, job, batch
        torch.cuda.empty_cache()
    log("[2] chain_find at the region run's shapes (untimed replay of its "
        "ticks)")
    table, batch, others = largest_chain_find_batch(dev, ticks)
    rows["chain_find"] = check_chain_find(table, batch, dev)
    check_chain_find_depth(table, batch)
    rows["chain_find"]["other_batches"] = [
        check_chain_find_batch(table, b) for b in others.values()]
    log(f"  chain_find at its main-path shape: "
        f"{json.dumps(rows['chain_find'])}")
    del table, batch, others
    torch.cuda.empty_cache()
    log("[2] region_rank at the region path's own grid (untimed replay of "
        "its ticks, the last rank cycle)")
    call, tick = last_region_rank_call(dev, ticks)
    rows["region_rank"]["path_grid"] = check_region_rank_path_grid(
        call, tick, floor)
    log(f"  region_rank at the region path's grid: "
        f"{json.dumps(rows['region_rank']['path_grid'])}")
    del call
    torch.cuda.empty_cache()
    log("[2] score_gate and assoc_score on the hash path's own lanes "
        "(untimed replay of its ticks, the last rank cycle)")
    call, tick = last_score_gate_call(dev, ticks)
    path_lanes = check_score_path_lanes(call, tick, floor)
    for name in ("score_gate", "assoc_score"):
        rows[name]["path_lanes"] = path_lanes[name]
        log(f"  {name} at the hash path's lanes: "
            f"{json.dumps(path_lanes[name])}")
    del call
    torch.cuda.empty_cache()
    log("[2] bucket_topk at the main paths' own grids (untimed replays of "
        "their ticks, the last rank cycle)")
    path_grids = {}
    for layout, what in (("hash", "hash bucket grid"),
                         ("region", "region chain-merge candidates")):
        grid, k, tick = last_bucket_topk_grid(dev, ticks, layout)
        path_grids[layout] = check_bucket_topk_path_grid(
            f"{what}, tick {tick}", grid, k)
        log(f"  bucket_topk at the {layout} path's grid: "
            f"{json.dumps(path_grids[layout])}")
        del grid
        torch.cuda.empty_cache()
    rows["bucket_topk"]["path_grids"] = path_grids

    # ---- 5. determinism ----
    two_runs_bit_identical(dev, ticks, "hash")
    two_runs_bit_identical(dev, ticks, "region")

    # ---- 6. the LM serving path at full width ----
    launches["lm"] = run_lm(dev, rows)

    # ---- 7. crash recovery at deployment scale ----
    launches["recovery"] = run_recovery(dev, card)
    torch.cuda.empty_cache()

    # ---- 8. the serving stack at deployment scale ----
    launches["serving"] = run_serving(dev, card)
    torch.cuda.empty_cache()

    # ---- 9. a flash crowd, overload control and log compaction ----
    launches["flash_crowd"] = run_flash_crowd(dev, card, floor)
    torch.cuda.empty_cache()

    # ---- 10. tuning and the oracle ----
    launches["tuning"] = run_tuning(dev, card, ticks)
    torch.cuda.empty_cache()

    # ---- 11. the self-healing replicated fleet ----
    launches["fleet"] = run_fleet(dev, card)
    torch.cuda.empty_cache()

    # ---- 12. the sharded engine ----
    launches["sharded"] = run_sharded(dev, card, floor)
    torch.cuda.empty_cache()

    # ---- 13. the MoE LM serving path ----
    launches["moe"] = run_moe(dev, rows)
    torch.cuda.empty_cache()

    # ---- 14. the recsys and GNN serving paths ----
    launches["recsys"] = run_recsys(dev, card)
    torch.cuda.empty_cache()

    # ---- 15. training ----
    launches["train"] = run_train(dev, card, rows)
    torch.cuda.empty_cache()

    # ---- 16. the §3 batch baseline ----
    launches.update(run_batch(dev, card))
    log("kernels " + " ".join(f"{n}=ok" for n in rows))

    sources = {"decay_prune_multi": ("decay_prune.cu", "decay_prune.py:85"),
               "score_gate": ("score_gate.cu", "topk_select.py:78"),
               "bucket_topk": ("bucket_topk.cu", "topk_select.py:150"),
               "chain_find": ("chain_find.cu", "region_probe.py:50"),
               "region_rank": ("region_rank.cu", "topk_select.py:236"),
               "assoc_score": ("assoc_score.cu", "assoc_score.py:81"),
               "edit_distance": ("edit_distance.cu", "edit_distance.py:107"),
               "flash_attention": ("flash_attention.cu",
                                   "flash_attention.py:86")}
    record = {"kernels": [
        {"name": n, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{sources[n][0]}",
         "replaces": f"src/repro/kernels/{sources[n][1]}",
         "launches": sum(launches[p][n] for p in launches),
         "launches_by_path": {p: launches[p][n] for p in launches},
         **{k: v for k, v in rows[n].items() if k != "wrapper_ms"}}
        for n in tk.KERNELS]}
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the torch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. card   — print the card's name and power limit (nvidia-smi);
  2. build  — build the CUDA kernels from `src/repro_torch/kernels/csrc/`
              with nvcc (sm_90a), one nvcc per source, all started
              together, and print the build times; beside them a separate
              compile of each source with `-Xptxas -v` (the built
              libraries' flags are unchanged) prints each kernel's
              registers, spills and shared memory;
  3. kernels — hold each kernel against its plain torch version on the card.
              The bitmap kernels bit for bit, each entry with an extend at
              every word-block width of FUSED_TILE_WIDTHS (32, 64, 128:
              one compiled instantiation each) against its plain version,
              which has no width. The old contracts
              (bitmap_intersect, fused_expand_intersect): k in 1..4 tables,
              ragged widths, all-zero and all-one rows, T = 256, and for
              the fused entry K0 = 0 and slots through both kinds of
              indirection. The new entry points (tile_intersect,
              expand_select, expand_intersect) over the grid of
              `check_new_kernels`: k 1..4, K0 0, 1, 4, W 1, 33, 82, 246,
              T_in 1, 37, 256, 1000 (at widths 32 and 64: 1 and 256) and
              10,000 against T_out = 256,
              starts at 0, mid, total - 1, total and past it, empty,
              sparse, dense and all-one frontiers, negative index entries
              and same-label clears on the bitpos column.
              tile_intersect's query lane (`check_lane`): Q 1, 2, 5, 8,
              k 1..4, W 1, 33, 128, query ids and keys negative and past
              the end, same-label clears on and off.
              flash_decode over B in {1, 3}, (H, Hkv) in {(4, 2), (12, 2),
              (4, 4), (16, 2), (32, 1)}, S in {1, 17, 128, 200}, D in
              {16, 64, 128}, plus the serve loop's (4, 12, 2, 24, 128),
              S = 32,768 at D = 128, D = 18 and 40 at S = 200 and D = 256
              at S = 3,000, phase 5c's decode_32k layers (32, 32, 2,
              32,768, 128), (32, 32, 4, 32,768, 128) and (8, 24, 8,
              32,768, 64), in all four (q, cache) dtype pairs,
              with ragged lengths and with none, and at S = 32,768 with
              lengths chunk - 1, chunk, chunk + 1 and 2 chunk for the chunk
              that `split_plan` picks, within FD_TOL (below);
  4. matcher path — `repro_torch.api.Matcher.count(engine="vector")` on
              the synthetic dblp (size-8 and size-16 queries) and human
              (size-8) datasets at scale 1.0, plus a size-8 query on dblp
              at scale 0.02 whose count stays below the limit, with
              intersect="auto" and "fused", each count held against the
              port's own `cemr_match` (numpy, CPU). Each route's launch
              counts are set to 0 just before its runs and read just
              after, beside the path's own count of boundary expansions,
              fused boundaries and pair-extend computes (`PathCalls`):
              each new kernel must launch once per boundary or extend it
              covers (expand_select and tile_intersect on "auto",
              expand_intersect and tile_intersect on "fused"), the old
              entry points never, and the torch `bitops.expand_select`
              never on the card. The two routes' VectorStats must be
              equal, and the scale-1.0 dblp supersteps and CER hits equal
              the JAX reference's (those counts stop at the limit). The
              scale-1.0 dblp queries are then counted once more with
              `mesh="auto"` (`check_mesh_auto`): over this host's visible
              cards it must take the single-device path, with the count
              and every VectorStats field of the `mesh=None` run.
              Widths: on "auto" every bitmap launch is at the default
              width (128); on "fused" each fused boundary's engine build
              autotunes its width on the card (`autotune_words_per_block`,
              whose sweep launches expand_intersect at every width: those
              launches are in the route's count, and the wrapper counts
              them by width where it launches them, apart from the
              path's) and its expand_intersect
              launches are all at the width it picked; each pick is
              printed. The dblp size-8 query is then counted on "fused"
              at each width forced (`drive_widths`): the autotuned run's
              count and every VectorStats field;
  4b. superbatch and compat paths — on the same scale-1.0 dblp, a mix of
              `random_query` (size, seed) pairs MIX: five size-4 queries
              that must form one bucket, a size-8 query twice (a bucket
              of one plan twice) and a size-3 query whose signature
              nothing else shares (the sequential fallback), through
              `Matcher.match_many(engine="vector", limit=1,000,000)` with
              batch="auto" and "off". Counts equal between the modes and
              to `cemr_match` (seed 9: 885,622; the size-3 query
              203,920); batched_queries 5, 2 and 0; the buckets'
              supersteps, leaf tiles, packed tiles, CER and failure hits
              and recompiles equal the JAX reference's
              (REFERENCE_MIX_STATS); readbacks + overlapped supersteps ==
              supersteps. Launches counted over the batched run
              (`PathCalls` also counts the BatchProgram closures): the
              lane once per batched pair extend, expand_select once per
              boundary (batched or not), tile_intersect once per pair
              extend, the other entry points and the torch expand_select
              never. Then the all_white union workload (its batched
              union's peak memory) and `count(use_cer_buffer=False)` on
              dblp size 8, human size 8 and dblp scale 0.02 (counts held,
              bucketed tiles, dedup keys and dispatches against the
              reference's REFERENCE_COMPAT_STATS, tile_intersect once per
              pair compute or bucketed compute, expand_select once per
              expansion). Printed, not asserted: the mix's wall and
              queries per second batched and sequential, and the lane's
              device time at the size-4 bucket's widest extend beside the
              lane-free call on the same tables;
  4c. streaming and runtime — on the same dblp: `--arch match` through
              the launcher's `serve_match` (16 size-4 queries, engine
              "vector"), counts held against `cemr_match` and each kernel
              launched once per boundary or extend covered (`PathCalls`);
              `Matcher.count_delta` on a Dataset of its own, exact bases
              for four queries below the limit (one without a base, so
              its first outcome is a fallback recount), through 8
              `random_delta(seed=i, 3 edge inserts, 3 edge deletes)`, one
              with vertex inserts and deletes, one whose labels miss a
              query's (its plan must be carried, with the same engine and
              device tables), and the delete and re-insert of an edge of
              an embedding: every outcome equal to a fresh Matcher's
              count on a fresh Dataset, the final counts to `cemr_match`,
              the maintained graph and index to `apply_delta_reference` +
              `build_data_index` bit for bit, and one standing query of a
              MatchQueueRuntime through 2 more deltas; printed, not
              asserted: each count_delta's ms beside the index
              maintenance's, the fresh Dataset's and the fresh recount's.
              Then `MatchQueueRuntime` over phase 4b's mix inline and on 2
              spawned workers, and a `MatchService` on 2 workers: an
              open loop of 32 requests at half the inline drain's rate,
              a drain with one worker SIGKILLed mid-bucket and a drain
              after the respawn. Every count equal to the sequential one,
              no failure and no degradation to the ref engine, the
              workers' reported kernel launches above 0; printed: p50,
              p99, sustained q/s, each worker's boot seconds, the card's
              memory a worker and `nvidia-smi --query-compute-apps`;
  4d. sharded — `repro_torch.core.shard` with its lanes on the one card
              (`EnumMesh((cuda:0,) * S)`, the counterpart of the reference
              tests' forced host devices): phase 4's scale-1.0 dblp
              queries and the skewed star of
              tests/test_shard_differential.py (tile_rows 16, all_black,
              order 0, 1, 2) counted on fresh engines single-device and
              with `ShardedTileScheduler` over 2 and 4 lanes, in the order
              1, 2, 4, 4, 2, 1: every count equal to the single-device one
              (and to `cemr_match` below the limit), every VectorStats
              field equal to the JAX reference's sharded scheduler on as
              many forced host devices (REFERENCE_SHARD), and, with the
              launch counts set to 0 just before each count and read just
              after, each bitmap kernel launched once per live lane per
              boundary or extend covered (`PathCalls`), the torch
              expand_select never; then `ShardedSuperbatchScheduler` over
              4 lanes on phase 4b's five-query bucket: counts equal to the
              batched drain's, stats to the reference's, the query lane
              once per batched pair extend. With more than one card, all
              of it again over meshes of distinct cards, for each lane
              count there are cards for (`chip_shard.py` runs only this
              phase, for a machine with several cards).
              Printed: lanes, supersteps, shard_lanes, shard_rebalances,
              each count's wall and the bitmap launches a dispatch;
  5. LM path — qwen2-1.5b decode serving (`repro_torch.launch.serve`):
              the reduced model's four float32 steps on the card against
              the same steps on the CPU (logits within 1e-4, the same
              greedy tokens); then at full width (28 layers, d_model 1536,
              random weights from seed 0, bfloat16) `decode_loop` at
              batch 4 x 16 tokens with a float32 cache, once with every
              attention call held against the plain version on its own
              inputs, then counted: flash_decode launches must be 28 x 16,
              all on the "cuda_core" route (float32 cache), each one split
              kernel and no combine (the device kernels the library
              reports it launched);
              then 3 `decode_32k` steps at batch 32 (the shape's 128 rows
              need 120 GB of cache) over a bfloat16 cache of 32,768
              positions filled with seeded random values, lengths from
              `make_inputs(seed=0)`: 28 x 3 launches, all on the
              "tensor_core" route, each a split kernel and a combine; then
              one more step in
              bfloat16 with each of its 28 attention calls held against the
              plain version, the same step with the plain attention, and
              both again in float32 activations: the float32 logits agree
              within LM_32K_F32_ATOL, and the bfloat16 step with the kernel
              is no farther from the float32 step than LM_32K_BF16_RATIO
              times the plain bfloat16 step is; peak device memory;
  5a. long context — after phase 6's timing, once the decode_32k cache is
              freed, on the same bfloat16 qwen2-1.5b (`run_long_500k`;
              `run_long_alone()` runs it by itself): 3 `long_500k` steps
              uncut (batch 1, a seeded bfloat16 cache of 524,288 + 4
              positions, 15.0 GB; lengths set to 524,288, not drawn by
              make_inputs), launch counts set to 0 just before and read
              just after: 28 x 3 flash_decode launches, all "tensor_core",
              each a split and a combine, no other kernel; logits finite;
              one more step with each attention call held against the
              plain version (decode_32k's check); ms a step beside
              `hbm_floor_bytes` on a one-card `MeshShape` and the step's
              share of `roofline_terms(...).bound_s` (FLOPs by
              `count_flops` over the same step with the plain attention);
              one layer's flash_decode beside its bound, the plain version
              and SDPA (`time_fd_shape`), its split and combine timed apart
              (profiler, and the combine alone through
              `flash_decode_merge`). `sharded_decode_attention` on layer
              0's cache over 1, 2 and 4 lanes of the card, counts set to 0
              just before and read just after (a partials call a lane,
              each a split and a combine, a merge a call), at the whole
              context and at 1,000 (later lanes empty), held against
              flash_decode and the plain version, no NaN; over distinct
              cards where several are visible, else printed as not run.
              flash_decode_partials (with an empty block, exactly
              (0, -inf, 0)) and flash_decode_merge held against their
              plain versions and timed at the 4-lane split. A 4,096-token
              float32 prefill with cp_degree 4 against cp_degree 0: last
              logits within LM_32K_F32_ATOL, cp_attention in every layer;
  5b. LM prefill and training — qwen2-1.5b's `steps["prefill"]` and
              `steps["train"]` (run after phase 6's timing, once the
              decode_32k cache is freed): the reduced model in float32
              on the card against the CPU (prefill logits within 1e-4;
              one train step's loss and gnorm within 1e-5 relative and
              its parameters within 1e-5; a `TrainLoop` of 12 steps at
              batch 2 x 32 with faults at steps 5 and 9 and checkpoints
              every 3 gives 2 restarts and ends within 1e-4 of a
              fault-free run on the card; a checkpoint saved from the
              card loads onto the CPU bit for bit). Then at full width,
              float32 weights from seed 0, bfloat16 activations:
              `prefill_32k` at batch 1 (the shape's 32 rows cut to 1),
              logits finite of shape (1, 1, 151936), cold and warm ms,
              tokens/s, peak memory and the reference's model_flops over
              the time as a share of the dense bf16 peak; prefill over a
              64-token prefix at batch 2 against the same tokens fed one
              by one through the decode step with the flash_decode kernel
              (float32, last logits within LM_32K_F32_ATOL, 28 x 64
              launches); 3 `train_4k` steps at batch 4 (256 cut to 4,
              grad_accum 4: microbatches of one row) on one repeated
              batch, loss and gnorm finite and the third loss below the
              first, ms a step warm, tokens/s, 6·N·tokens over the time
              as a share of the bf16 peak, peak memory. Printed, not
              asserted: one layer of prefill_32k's attention (B 1, S
              32,768, 12/2 heads, D 128, causal, bf16) through
              `flash_attention` beside `scaled_dot_product_attention`;
  5c. the other LM architectures — chatglm3-6b (partial rotary),
              minicpm3-4b (MLA), qwen3-moe-30b-a3b and granite-moe-3b-a800m
              (MoE), run after phase 5b, one at a time, each model freed
              before the next. `python -m repro_torch.launch.serve --arch
              <id>` (its `main`, no --device: the reduced model on the
              card, batch 4 x 16 tokens, float32 cache) with n_layers x
              16 flash_decode launches, all "cuda_core" (0 for MLA). The
              reduced model in float32 on the card
              against the CPU: prefill logits within 1e-4; 8 decode steps
              over a random cache (flash_decode on the card, the plain
              version on the CPU; MLA plain on both) to 1e-4 in the last
              logits and the caches, with n_layers x 8 launches (0 for
              MLA); one train step's loss (with the MoE aux) and gnorm
              within 1e-5 relative and its parameters within 1e-5. Then at
              full width, bfloat16 weights from seed 0 and bfloat16
              activations (qwen3-moe cut to 12 of its 48 layers): 3
              `decode_32k` steps at batch 32 (granite: 8) over a bfloat16
              cache of 32,772 positions filled with seeded values, lengths
              from make_inputs(seed=0), launch counts set to 0 just before
              and read just after: n_layers x 3 flash_decode launches, all
              "tensor_core", each a split kernel and a combine, for the GQA
              models, none for minicpm3; one more step with each attention
              call held against the plain version within FD_TOL; ms a
              step, tokens/s, peak memory, and for the GQA models
              flash_decode timed at that layer shape beside its plain
              version, SDPA and its bound. Prefill of 4,096 tokens at
              batch 1 (prefill_32k cut in length and batch): logits finite,
              cold and warm ms, tokens/s, model_flops (active parameters)
              over the time as a share of the bf16 peak, peak memory.
              chatglm3-6b and minicpm3-4b: prefill over 64 tokens at batch
              2 against the same tokens decoded one by one (float32, last
              logits within LM_32K_F32_ATOL; for minicpm3 the absorbed
              decode against the expanded path). Prints phase 5c's wall;
  5d. recsys and GNN stacks — run after phase 5c, float32 weights from
              seed 0 and float32 activations (TF32 off); none of it
              launches a kernel of the kernels line (counts set to 0 just
              before each path and read just after; each row of the line
              records them). `python -m repro_torch.launch.serve --arch
              bert4rec` (its `main`: the reduced serve_p99 batch on the
              card). The reduced bert4rec, card against CPU: serve's top-10
              (both held against the CPU's float64 recompute), retrieval
              scores, one train step (loss, gnorm, gradients, parameters by
              phase 5c's rule: 1e-5 where |g| >= ADAM_G_FLOOR, 2·lr
              elsewhere). bert4rec at full width (embed 64, 2 blocks, 2
              heads, seq 200, 10^6 items): serve_p99 at batch 512 and
              serve_bulk cut to 4,096 rows (ms a batch, median of 5 warm,
              queries/s; the top-10 held against h @ table.T in float64 on
              the card, all rows and the first 256: values within
              RECSYS_TOPK_RTOL of the row's largest, the same items
              wherever the 10th and 11th scores are farther apart);
              retrieval_cand (batch 1 x 10^6 candidates, its scores held
              likewise); train_batch cut to 4,096 rows, batch_chunk 32: a
              warm step and 3 timed, losses finite, every parameter
              changed, ms a step, masked items/s, share of the float32
              peak by model_flops, peak memory. Then gatedgcn, nequip,
              dimenet and equiformer-v2 at published widths: the reduced
              model card against CPU on molecule and full_graph_sm (one
              train step, as bert4rec's); a warm train step and 3 timed on
              molecule and full_graph_sm, and on minibatch_lg uncut where
              `gnn_bytes` reckons it within GNN_BYTES_BUDGET, else with its
              seeds cut to the largest multiple of 128 that fits
              (equiformer-v2: 512 of 1,024); ms a step, peak memory, model_flops over the time as
              a share of the float32 peak (hw()["flops_f32"]). Prints phase
              5d's wall; `run_phase_5d(dev, card)` runs it alone;
  examples — after phase 5d, before phase 5e: the port's five examples
              (`examples/torch_*.py`), each `main` called in this process
              at its documented defaults on the card (EXAMPLE_RUNS):
              torch_quickstart (the Fig. 1 count held against
              `cemr_match`, the 2k-vertex graph's ref and vector counts
              equal); torch_match_queries twice, at its defaults (yeast at
              scale 0.05, 20 queries of size 6; each count held against
              `cemr_match`) and with `--dataset dblp --scale 1.0` (each
              count held against a fresh Matcher's count of the query on
              the card); torch_serve_recsys (each batch's top-10 and the
              retrieval scores held against the bundle's plain CPU run on
              the example's weights; requests/s printed); torch_train_lm
              and torch_gnn_train (their own "loss decreased" assertion;
              ms a step printed). Launch counts set to 0 just before each
              `main` and read just after: the match examples'
              tile_intersect and expand_select once per extend or boundary
              covered (`PathCalls`), the other kernels never; the model
              examples none. Each run's seconds and launches go into every
              row of the kernels line (`launches_phase_examples`);
  5e. placement — last, once every other phase has freed the card: one
              spawned NCCL rank a visible card (`placement_rank`), a
              (data, model) mesh of them ((1, 1) on one card, (2, 2) on
              four); qwen2-1.5b at full width in float32 weights: one
              float32 train_4k step at batch 4, undistributed and then
              distributed by the policy in its sharding context, loss and
              gnorm held within PLACE_LOSS_RTOL / PLACE_GNORM_RTOL, then a
              timed bf16 step of each; 3 decode_32k steps (float32
              activations, bf16 caches) at batch 32 over whole caches,
              then over caches made in the decode rules' context
              (DTensors placed by `cache_bsnd`, even on (1, 1)), logits
              held within PLACE_LOGITS_ATOL, every kernel's launches
              counted (a partials and a merge one a layer and step, no
              other), layer 0 timed both ways; the same 3 steps in bf16
              activations with the plain attention, the whole-cache
              kernel and the sharded route, each partials and merge call
              of the last held against its plain version on its own
              inputs, its logits held by PLACE_BF16_RATIO; the CEMR engine
              cell at the reference's size (3 tables of 262,144 x 8,192
              words, 65,536 rows) on each rank's local shards through
              `bitmap_intersect` (launches counted), R and pop
              bit-identical to the plain version and to bitmap_intersect
              over the whole tables at every word-block width (each
              width's launches on the cell's path and difference from the
              plain version recorded), then timed on the rank's shard at
              every width beside its plain version (the kernels line's
              bitmap_intersect rows).
              Then each GNN (gatedgcn, nequip, dimenet, equiformer-v2) at
              its published width on the shape phase 5d runs faster
              (PLACE_GNN_SHAPES), float32, TF32 off: one train step
              undistributed, then one with the parameters and the batch
              placed by the policy (nodes, edges and triplets split over
              every mesh dim, parameters whole; every gather and sum by
              node, edge or triplet index on each rank's own rows), loss
              and gnorm held within PLACE_LOSS_RTOL / PLACE_GNORM_RTOL, no
              kernel launched. Beside the ranks, from the phase's start,
              the dry runs on the host, all started together, one thread
              each (`dryrun_cells`): qwen2-1.5b x train_4k and each GNN at
              molecule on (16, 16), the engine cell on (2, 16, 16), their
              rows printed. A failed check or rank fails the
              script; `chip_dist.py` runs this phase without the dry runs
              on several cards, then the cells one card runs cut, uncut
              on four;
  6. timing — each kernel's median device time at its path's shapes beside
              its plain version's, its bound and, for flash_decode, the
              time of `scaled_dot_product_attention`, the achieved bytes/s
              and the share of the bound. The bitmap kernels at the dblp
              size-8 plan's widest extend and at eu2005's widest shape
              (synthetic 6,138 x 246 tables, k = 2), warm and with the L2
              flushed before each call, each entry with an extend
              (fused_expand_intersect over expand_select's selection) at
              every word-block width; tile_intersect's query lane at
              the mix's size-4 bucket's widest extend beside the
              lane-free call on the same tables. The launch floor: an empty
              `torch.cuda._sleep(0)` kernel back to back, and alone after
              an L2 flush;
  7. summary — the kernels line, the card, one JSON line of per-kernel
              numbers (one row a bitmap entry and width, with the
              launches at that width; flash_decode's with phase 5a's and
              5c's launches and its times at their shapes;
              flash_decode_partials' and
              flash_decode_merge's from phase 5a's sharded check; each row
              with phase 5d's 0 launches by path and phase 5e's
              launches; the partials' and merge's with phase 5e's held
              differences; each row with phase 5e's GNN steps' 0
              launches and the examples phase's seconds and launches),
              and last the line
              {"ok": true, "device": {"platform": "gpu", ...}}.

It imports nothing of jax or of the JAX package `repro`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

TILE_ROWS = 256                  # MatchOptions.tile_rows default
LIMIT = 1_000_000                # MatchOptions.limit default
HUMAN_SIZE8_COUNT = 40_860       # ref-engine count of human size-8, seed 7
# (dataset, scale, query size); every query is random_query(size, seed=7).
# The scale-1.0 dblp counts stop at the limit, so a small dblp whose count
# (473,828) stays below it holds a dblp count exactly.
WORKLOADS = (("dblp", 1.0, 8), ("dblp", 1.0, 16), ("human", 1.0, 8),
             ("dblp", 0.02, 8))
# The JAX reference TileScheduler's counters on the same queries (default
# options). They hold the kernels' bits where the clipped count cannot.
REFERENCE_STATS = {("dblp", 1.0, 8): {"supersteps": 35},
                   ("dblp", 1.0, 16): {"supersteps": 37, "cer_hits": 6_927}}
# The superbatch mix on dblp at scale 1.0: random_query(size, seed) pairs.
# Queries 0-4 share one padded shape (one bucket), 5-6 are one plan twice,
# 7's shape is its own (sequential fallback).
MIX = ((4, 2), (4, 3), (4, 4), (4, 8), (4, 9), (8, 7), (8, 7), (3, 1))
MIX_BUCKETS = ((0, 1, 2, 3, 4), (5, 6), (7,))
# the mix's counts below the limit (cemr_match); the rest stop at it
MIX_EXACT = {4: 885_622, 7: 203_920}
# The JAX reference SuperbatchScheduler's counters on the mix's buckets
# (default options, limit 1,000,000), and the reference compat loop's
# (use_cer_buffer=False) on phase 4's queries: from
# `python tests/torch_reference.py chip-constants` on the CPU.
REFERENCE_MIX_STATS = {
    (0, 1, 2, 3, 4): {"supersteps": 102, "leaf_tiles": 76,
                      "packed_tiles": 0, "cer_hits": 296, "fail_hits": 0,
                      "bucket_recompiles": 2},
    (5, 6): {"supersteps": 97, "leaf_tiles": 46, "packed_tiles": 7,
             "cer_hits": 782, "fail_hits": 0, "bucket_recompiles": 5}}
REFERENCE_COMPAT_STATS = {
    ("dblp", 1.0, 8): {"bucketed_tiles": 7, "dedup_unique": 154,
                       "device_steps": 78},
    ("human", 1.0, 8): {"bucketed_tiles": 3, "dedup_unique": 28,
                        "device_steps": 17},
    ("dblp", 0.02, 8): {"bucketed_tiles": 2, "dedup_unique": 13,
                        "device_steps": 16}}
# Phase 4d: the sharded schedulers over lanes on one card at these lane
# counts (the superbatch at SHARD_SB_LANES), on phase 4's scale-1.0 dblp
# queries and the skewed star of tests/test_shard_differential.py
# (tile_rows 16, all_black, order 0, 1, 2). REFERENCE_SHARD is every
# VectorStats field of the JAX reference's ShardedTileScheduler /
# ShardedSuperbatchScheduler on meshes of as many forced host devices, from
# `python tests/torch_reference.py chip-constants` on the CPU.
SHARD_LANES = (2, 4)
SHARD_SB_LANES = 4
STAR_TILE_ROWS = 16
REFERENCE_SHARD = {'dblp': {'8': {'2': {'count': 1000000,
                                        'stats': {'device_steps': 14,
                                                  'supersteps': 11,
                                                  'tiles': 22,
                                                  'expansions': 22,
                                                  'rows_processed': 19968,
                                                  'rows_alive': 3854,
                                                  'gather_and_ops': 26112,
                                                  'dedup_keys_seen': 1525,
                                                  'dedup_unique': 350,
                                                  'cer_hits': 0,
                                                  'cer_misses': 1525,
                                                  'fail_hits': 0,
                                                  'fail_misses': 6312,
                                                  'fail_inserts': 0,
                                                  'fail_pruned_rows': 0,
                                                  'bucketed_tiles': 0,
                                                  'packed_tiles': 3,
                                                  'batched_queries': 0,
                                                  'bucket_recompiles': 0,
                                                  'shard_lanes': 22,
                                                  'shard_rebalances': 1,
                                                  'leaf_tiles': 8,
                                                  'leaf_overflows': 0,
                                                  'peak_stack': 9,
                                                  'readbacks': 6,
                                                  'overlapped_supersteps': 5}},
                                  '4': {'count': 1000000,
                                        'stats': {'device_steps': 15,
                                                  'supersteps': 9,
                                                  'tiles': 36,
                                                  'expansions': 36,
                                                  'rows_processed': 27648,
                                                  'rows_alive': 5612,
                                                  'gather_and_ops': 35840,
                                                  'dedup_keys_seen': 2279,
                                                  'dedup_unique': 430,
                                                  'cer_hits': 0,
                                                  'cer_misses': 2279,
                                                  'fail_hits': 0,
                                                  'fail_misses': 6963,
                                                  'fail_inserts': 1,
                                                  'fail_pruned_rows': 0,
                                                  'bucketed_tiles': 0,
                                                  'packed_tiles': 6,
                                                  'batched_queries': 0,
                                                  'bucket_recompiles': 0,
                                                  'shard_lanes': 36,
                                                  'shard_rebalances': 2,
                                                  'leaf_tiles': 12,
                                                  'leaf_overflows': 0,
                                                  'peak_stack': 12,
                                                  'readbacks': 5,
                                                  'overlapped_supersteps': 4}}},
                            '16': {'2': {'count': 1000000,
                                         'stats': {'device_steps': 21,
                                                   'supersteps': 17,
                                                   'tiles': 34,
                                                   'expansions': 34,
                                                   'rows_processed': 74240,
                                                   'rows_alive': 5983,
                                                   'gather_and_ops': 115712,
                                                   'dedup_keys_seen': 6757,
                                                   'dedup_unique': 963,
                                                   'cer_hits': 728,
                                                   'cer_misses': 6029,
                                                   'fail_hits': 0,
                                                   'fail_misses': 22106,
                                                   'fail_inserts': 73,
                                                   'fail_pruned_rows': 0,
                                                   'bucketed_tiles': 0,
                                                   'packed_tiles': 4,
                                                   'batched_queries': 0,
                                                   'bucket_recompiles': 0,
                                                   'shard_lanes': 34,
                                                   'shard_rebalances': 2,
                                                   'leaf_tiles': 2,
                                                   'leaf_overflows': 0,
                                                   'peak_stack': 22,
                                                   'readbacks': 9,
                                                   'overlapped_supersteps': 8}},
                                   '4': {'count': 1000000,
                                         'stats': {'device_steps': 17,
                                                   'supersteps': 9,
                                                   'tiles': 34,
                                                   'expansions': 34,
                                                   'rows_processed': 58368,
                                                   'rows_alive': 4962,
                                                   'gather_and_ops': 88064,
                                                   'dedup_keys_seen': 5386,
                                                   'dedup_unique': 338,
                                                   'cer_hits': 564,
                                                   'cer_misses': 4822,
                                                   'fail_hits': 0,
                                                   'fail_misses': 16540,
                                                   'fail_inserts': 62,
                                                   'fail_pruned_rows': 0,
                                                   'bucketed_tiles': 0,
                                                   'packed_tiles': 8,
                                                   'batched_queries': 0,
                                                   'bucket_recompiles': 0,
                                                   'shard_lanes': 34,
                                                   'shard_rebalances': 10,
                                                   'leaf_tiles': 4,
                                                   'leaf_overflows': 0,
                                                   'peak_stack': 15,
                                                   'readbacks': 5,
                                                   'overlapped_supersteps': 4}}}},
                   'star': {'2': {'count': 300,
                                  'stats': {'device_steps': 14,
                                            'supersteps': 14,
                                            'tiles': 26,
                                            'expansions': 26,
                                            'rows_processed': 432,
                                            'rows_alive': 401,
                                            'gather_and_ops': 144,
                                            'dedup_keys_seen': 0,
                                            'dedup_unique': 0,
                                            'cer_hits': 0,
                                            'cer_misses': 0,
                                            'fail_hits': 0,
                                            'fail_misses': 0,
                                            'fail_inserts': 0,
                                            'fail_pruned_rows': 0,
                                            'bucketed_tiles': 0,
                                            'packed_tiles': 0,
                                            'batched_queries': 0,
                                            'bucket_recompiles': 0,
                                            'shard_lanes': 26,
                                            'shard_rebalances': 3,
                                            'leaf_tiles': 19,
                                            'leaf_overflows': 0,
                                            'peak_stack': 5,
                                            'readbacks': 8,
                                            'overlapped_supersteps': 6}},
                            '4': {'count': 300,
                                  'stats': {'device_steps': 8,
                                            'supersteps': 8,
                                            'tiles': 26,
                                            'expansions': 26,
                                            'rows_processed': 432,
                                            'rows_alive': 401,
                                            'gather_and_ops': 144,
                                            'dedup_keys_seen': 0,
                                            'dedup_unique': 0,
                                            'cer_hits': 0,
                                            'cer_misses': 0,
                                            'fail_hits': 0,
                                            'fail_misses': 0,
                                            'fail_inserts': 0,
                                            'fail_pruned_rows': 0,
                                            'bucketed_tiles': 0,
                                            'packed_tiles': 0,
                                            'batched_queries': 0,
                                            'bucket_recompiles': 0,
                                            'shard_lanes': 26,
                                            'shard_rebalances': 8,
                                            'leaf_tiles': 19,
                                            'leaf_overflows': 0,
                                            'peak_stack': 6,
                                            'readbacks': 5,
                                            'overlapped_supersteps': 3}}},
                   'superbatch': {'indices': [0, 1, 2, 3, 4],
                                  'counts': [1000000, 1000000, 1000000,
                                             1000000, 885622],
                                  'stats': {'device_steps': 28,
                                            'supersteps': 28,
                                            'tiles': 105,
                                            'expansions': 105,
                                            'rows_processed': 60928,
                                            'rows_alive': 21738,
                                            'gather_and_ops': 60928,
                                            'dedup_keys_seen': 14757,
                                            'dedup_unique': 6510,
                                            'cer_hits': 2,
                                            'cer_misses': 14755,
                                            'fail_hits': 0,
                                            'fail_misses': 21738,
                                            'fail_inserts': 0,
                                            'fail_pruned_rows': 0,
                                            'bucketed_tiles': 0,
                                            'packed_tiles': 0,
                                            'batched_queries': 5,
                                            'bucket_recompiles': 2,
                                            'shard_lanes': 105,
                                            'shard_rebalances': 1,
                                            'leaf_tiles': 77,
                                            'leaf_overflows': 0,
                                            'peak_stack': 12,
                                            'readbacks': 15,
                                            'overlapped_supersteps': 13}}}
# The route whose launch count each bitmap kernel reports (tile_intersect
# runs on both routes)
KERNEL_ROUTE = {"tile_intersect": "auto", "expand_select": "auto",
                "expand_intersect": "fused", "fused_expand_intersect": "fused"}

LM_ARCH = "qwen2-1.5b"
SERVE_BATCH, SERVE_TOKENS = 4, 16      # the reference launcher's defaults
DECODE_SHAPE = "decode_32k"
DECODE_BATCH = 32      # the shape's 128 rows need 120 GB of bf16 cache
DECODE_STEPS = 3
# flash_decode against its plain version, (atol, rtol) by output (q)
# dtype. Both sum in float32 and cast at the end: a float32 output differs
# by the order of the sums; a bfloat16 output may round one bfloat16 step
# (at most 2^-7 of the value) the other way. atol is 1 % of the typical
# output of a 32k-long row (~0.01), so a row that is zero or lost part of
# its sum fails; `fd_agrees` also fails when a zero row would pass.
FD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-4, 8e-3)}
FD_DTYPES = (torch.float32, torch.bfloat16)
# The long-context phase: qwen2-1.5b's long_500k cell uncut (batch 1, a
# bfloat16 cache of 524,288 + LONG_STEPS + 1 positions, 15.0 GB). Lengths
# start at 524,288, set rather than drawn by make_inputs (which draws them
# in [1, S - 2]), so every step reads the cell's whole context.
LONG_SHAPE = "long_500k"
LONG_STEPS = 3
# sharded_decode_attention on layer 0's cache over this many lanes of the
# card, at the whole context and at LONG_SHORT_LENGTH, a length inside the
# first lane's block (the later lanes' blocks are empty)
LONG_LANES = (1, 2, 4)
LONG_SHORT_LENGTH = 1_000
# cp_attention: a prefill of this many tokens with cp_degree 4 against
# cp_degree 0 (flash_attention), float32 activations, last logits held at
# LM_32K_F32_ATOL (two exact softmaxes, float32 sums in another order, 28
# layers deep)
LONG_CP_TOKENS, LONG_CP_DEGREE = 4096, 4
# flash_decode_partials against its plain version (float32 rows from the
# same bfloat16 inputs, sums in another order over 131,073 positions; P
# V on the tensor cores with P kept to ~16 bits): m absolute, acc and l
# each relative to its largest magnitude
PARTIALS_M_ATOL, PARTIALS_RTOL = 1e-4, 1e-4
# LM logits in float32 activations: the reduced model on the card against
# the CPU, and the full model's decode_32k step with the kernel against the
# same step with the plain attention (fp32 sums in another order, 28
# layers deep).
LM_F32_ATOL = 1e-4
LM_32K_F32_ATOL = 1e-3
# A bfloat16 step's logits cannot be held to a fixed atol against the plain
# attention's: one bfloat16 step of difference in an attention output grows
# through 28 layers of random weights (0.14 at logits of 4.0 on the H100).
# They are held against the float32 step instead: the kernel's bfloat16
# step may be at most this many times as far from it (RMS over the logits)
# as the plain bfloat16 step is, i.e. add no more error than bfloat16 does.
LM_32K_BF16_RATIO = 2.0
# Phase 5b: qwen2-1.5b prefill and training, float32 weights from seed 0.
# prefill_32k's 32 rows and train_4k's 256 are cut to what one card holds
# beside the float32 optimizer state (params, grads, the accumulation
# buffer, m and v: 30.8 GB); train_4k's grad_accum 4 then makes
# microbatches of one row.
PREFILL_SHAPE, PREFILL_BATCH = "prefill_32k", 1
TRAIN_SHAPE, TRAIN_BATCH, TRAIN_STEPS = "train_4k", 4, 3
# prefill against the decode path: a 64-token prefix at batch 2, float32
# activations and cache; the last logits held at LM_32K_F32_ATOL, the
# limit of the decode kernel against the plain attention at this width
# (float32 sums in another order, 28 layers deep: here the products run
# as one GEMM over 128 rows against 64 GEMMs over 2)
XCHECK_TOKENS, XCHECK_BATCH = 64, 2
# card against CPU on the reduced model, float32 (what the CPU tests see
# against the JAX package, with room for another order of sums):
# a train step's loss and gnorm relative, its parameters absolute
TRAIN_F32_RTOL, TRAIN_F32_PARAM_ATOL = 1e-5, 1e-5
REPLAY_ATOL = 1e-4                # a replayed run against a fault-free one
# Phase 5c: the registry's other four LM architectures, bfloat16 weights
# from seed 0. decode_32k's 128 rows are cut to what one card holds beside
# the weights (a bfloat16 cache of 32,772 positions): 32 rows, granite's 8
# (its 32 layers x 8 KV heads of 64 need 68.7 GB at 32 rows); qwen3-moe's
# 48 layers are cut to 12 (61 GB of weights at 48, 103 GB of cache).
# prefill_32k is cut to 4,096 tokens at batch 1, so that the eager
# flash_attention stays within the run's time.
FAMILY_ARCHS = ("chatglm3-6b", "minicpm3-4b", "qwen3-moe-30b-a3b",
                "granite-moe-3b-a800m")
FAMILY_DECODE_BATCH = {"chatglm3-6b": 32, "minicpm3-4b": 32,
                       "qwen3-moe-30b-a3b": 32, "granite-moe-3b-a800m": 8}
FAMILY_LAYERS = {"qwen3-moe-30b-a3b": 12}
FAMILY_PREFILL_TOKENS = 4096
# prefill against decode, as phase 5b's: the dense families only (a MoE
# groups prefill over the sequence and decode over the batch, so their
# capacities and drops differ by design)
FAMILY_XCHECK = ("chatglm3-6b", "minicpm3-4b")
FAMILY_REDUCED_STEPS = 8
# The reduced train step's parameters are held at TRAIN_F32_PARAM_ATOL
# where Adam's first step is well conditioned: it moves an entry by
# lr·g/(|g| + eps) (+ the decay), so where the clipped gradient |g| is
# near eps = 1e-8 it normalises float32 rounding noise. chatglm3's K bias
# has a zero true gradient on its non-rotated half (a shift of every key's
# score), and the CPU's own float32 step differs from its float64 step by
# 1.8e-5 there; with |g| >= ADAM_G_FLOOR the two differ by at most 3e-8 on
# all four models. The other entries are held within 2·lr, the most two
# first steps can differ, and every gradient (m / (1 - b1)) within
# TRAIN_F32_PARAM_ATOL of its leaf's largest.
ADAM_G_FLOOR = 1e-6
# Phase 5d: bert4rec and the four GNNs at their published widths, float32
# weights from seed 0 and float32 activations (TF32 off). bert4rec's
# serve_bulk batch is cut 262,144 -> 4,096 (its (B, 10^6) float32 scores
# are 1.05 TB at 262,144, 16.4 GB at 4,096); train_batch's batch 65,536 ->
# 4,096 and batch_chunk 256 -> 32 (one chunk's float32 logits are 39.9 GB
# at 256 x 39 masked positions, 5.0 GB at 32, and their gradient as much
# again). A GNN's minibatch_lg runs uncut where the reckoning of
# `gnn_bytes` fits GNN_BYTES_BUDGET, else with its seeds cut to the largest
# multiple of GNN_SEED_STEP that fits (`reckon_sampled`).
RECSYS_ARCH = "bert4rec"
RECSYS_BULK_BATCH = 4096
RECSYS_TRAIN_BATCH, RECSYS_TRAIN_CHUNK = 4096, 32
RECSYS_STEPS = 3                  # timed, after a warm one
RECSYS_TIMED_CALLS = 5            # serve and retrieval: median of 5, warm
RECSYS_HELD_BULK_ROWS = 256       # serve_bulk rows held against float64
# top-k values against a float64 recompute, relative to the row's largest
# score (float32 products of 64 terms); indices held wherever the k-th and
# (k+1)-th float64 scores are farther apart than that
RECSYS_TOPK_RTOL = 1e-4
GNN_ARCHS = ("gatedgcn", "nequip", "dimenet", "equiformer-v2")
GNN_TRAIN_SHAPES = ("molecule", "full_graph_sm")
GNN_SAMPLED_SHAPE = "minibatch_lg"
GNN_STEPS = 3                     # timed, after a warm one
GNN_BYTES_BUDGET = 64e9           # of the card's 80 GB: room for the rest
GNN_SEED_STEP = 128
# card against CPU, reduced, float32: each gradient leaf within
# TRAIN_F32_PARAM_ATOL of its largest |g| or GRAD_FLOOR, where larger (a
# leaf whose true gradient is zero, as EquiformerV2's alpha MLP's last
# bias, a shift of every score of a softmax, carries rounding noise only)
GRAD_FLOOR = 1e-7


def hw() -> dict:
    """The card's data-sheet peaks, the port's `launch/roofline.HW`
    ("hbm_bw" in bytes/s, "flops_bf16", "flops_tf32", "flops_f32" in
    FLOP/s, "nvlink_bw"); main() has put the checkout's src/ on the path."""
    from repro_torch.launch.roofline import HW
    return HW


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, *, reps: int = 5, iters: int = 20) -> float:
    """Device time of one call: the median over `reps` of the mean of
    `iters` back-to-back calls, timed with CUDA events after a warm-up.
    A sleep kernel holds the stream while the host queues the calls, so
    the events see the calls' device time, not the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)           # ~50 ms at H100 clocks
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    return float(np.median(times))


def max_abs_err(got, want) -> int:
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               if g.numel() else 0 for g, w in zip(got, want))


def check_kernels(bi, ref, dev, wpb: int) -> dict:
    """The old contracts at word-block width `wpb` against their plain
    versions, bit for bit. Returns the largest absolute
    difference seen per kernel (0 when they agree)."""
    gen = np.random.default_rng(0)
    t = TILE_ROWS
    errs = {"bitmap_intersect": 0, "fused_expand_intersect": 0}

    def tables_for(k, w, fill):
        out = []
        for _ in range(k):
            s = int(gen.integers(1, 300))
            if fill == "random":
                a = gen.integers(0, 2 ** 32, size=(s, w), dtype=np.uint32)
            else:
                a = np.full((s, w), 0 if fill == "zeros" else 0xFFFFFFFF,
                            dtype=np.uint32)
            out.append(torch.from_numpy(a.view(np.int32)).to(dev))
        return out

    for k in (1, 2, 3, 4):
        for w in (1, 5, 33, 82):
            for fill in ("random", "zeros", "ones"):
                tabs = tables_for(k, w, fill)
                idxs = torch.from_numpy(np.stack(
                    [gen.integers(0, x.shape[0], t) for x in tabs], 1
                ).astype(np.int32)).to(dev)
                got = bi.bitmap_intersect(tabs, idxs, words_per_block=wpb)
                want = ref.bitmap_intersect_ref(tabs, idxs)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                errs["bitmap_intersect"] = max(errs["bitmap_intersect"], err)
                if err:
                    raise SystemExit(f"bitmap_intersect disagrees: k={k} "
                                     f"w={w} {fill} width {wpb} "
                                     f"max_abs_err={err}")
                for k0 in (0, 1, 3):
                    # slot k0 reads bitpos; slots < k0 read parent columns
                    slots = [min(j, k0) for j in range(k)][::-1]
                    t_in = int(gen.integers(1, 40))
                    s_min = min(x.shape[0] for x in tabs)
                    idx = torch.from_numpy(gen.integers(
                        0, s_min, size=(t_in, k0)).astype(np.int32)).to(dev)
                    rows = torch.from_numpy(gen.integers(
                        0, t_in, t).astype(np.int32)).to(dev)
                    bitpos = torch.from_numpy(gen.integers(
                        0, s_min, t).astype(np.int32)).to(dev)
                    got = bi.fused_expand_intersect(tabs, idx, rows, bitpos,
                                                    slots,
                                                    words_per_block=wpb)
                    want = ref.fused_expand_intersect_ref(
                        tabs, idx, rows, bitpos, slots=slots)
                    torch.cuda.synchronize()
                    err = max_abs_err(got, want)
                    errs["fused_expand_intersect"] = max(
                        errs["fused_expand_intersect"], err)
                    if err:
                        raise SystemExit(
                            f"fused_expand_intersect disagrees: k={k} w={w} "
                            f"{fill} k0={k0} slots={slots} width {wpb} "
                            f"max_abs_err={err}")
    return errs


def frontier_bits(gen, t_in, w_in, fill) -> np.ndarray:
    """A (t_in, w_in) uint32 frontier bitmap: empty, sparse (about 1 bit in
    64, half the rows empty), dense (random words) or all ones."""
    if fill == "empty":
        return np.zeros((t_in, w_in), np.uint32)
    if fill == "ones":
        return np.full((t_in, w_in), 0xFFFFFFFF, np.uint32)
    if fill == "dense":
        return gen.integers(0, 2 ** 32, (t_in, w_in), dtype=np.uint32)
    bits = (gen.random((t_in, w_in, 32)) < 1 / 64).astype(np.uint64)
    bits[gen.random(t_in) < 0.5] = 0
    return (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def check_new_kernels(bi, ref, dev, wpb: int) -> tuple[dict, int]:
    """tile_intersect, expand_select and expand_intersect against their
    plain versions, bit for bit, the two with an extend at word-block width
    `wpb`: k in 1..4 tables,
    K0 in {0, 1, 4} parent columns (entries from -5 on: negative keys count
    from the table's end, negative clear values clear nothing), W in {1,
    33, 82, 246}, T_in in {1, 37, 256, 1000} against T_out = 256 (at a
    width other than the default {1, 256}, and no expand_select, which
    takes no width), plus T_in = 10,000 (its scan leaves shared memory for
    global scratch), start at 0, the middle, total - 1, total and past it,
    empty, sparse, dense and all-one frontiers, and same-label clears on
    the bitpos column (slot K0) and on parent columns. Returns the largest
    difference per kernel and the number of cases."""
    gen = np.random.default_rng(5)
    default = wpb == bi.DEFAULT_WORDS_PER_BLOCK
    errs = {"tile_intersect": 0, "expand_select": 0, "expand_intersect": 0}
    n = 0

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)

    def held(name, got, want, where):
        nonlocal n
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs[name] = max(errs[name], err)
        n += 1
        if err:
            raise SystemExit(f"{name} disagrees: {where} max_abs_err={err}")

    grid = [(k, k0, w, t_in) for k in (1, 2, 3, 4) for k0 in (0, 1, 4)
            for w in (1, 33, 82, 246)
            for t_in in ((1, 37, 256, 1000) if default else (1, 256))]
    grid += [(k, k0, w, 10_000) for k in (1, 2) for k0 in (0, 4)
             for w in (1, 33)]
    for k, k0, w, t_in in grid:
        tabs = [on_card(gen.integers(0, 2 ** 32, (int(gen.integers(1, 300)),
                                                  w), dtype=np.uint32))
                for _ in range(k)]
        idx = on_card(gen.integers(-5, 400, (t_in, k0)).astype(np.int32))
        slots = [int(s) for s in gen.integers(0, k0 + 1, k)]
        clears = [k0] + [int(s) for s in gen.integers(0, k0 + 1, 2)]
        if k0:
            t_slots = [min(s, k0 - 1) for s in slots]
            t_clears = [0, k0 - 1]
            held("tile_intersect",
                 bi.tile_intersect(tabs, idx, t_slots, t_clears,
                                   words_per_block=wpb),
                 ref.tile_intersect_ref(tabs, idx, t_slots, t_clears),
                 f"k={k} K={k0} W={w} T={t_in} width {wpb}")
        for fill in ("empty", "sparse", "dense", "ones"):
            bits = frontier_bits(gen, t_in, w, fill)
            r = on_card(bits)
            total = int(np.unpackbits(bits.view(np.uint8)).sum())
            for start in sorted({0, total // 2, max(total - 1, 0), total,
                                 total + 7}):
                where = (f"k={k} K0={k0} W={w} T_in={t_in} {fill} "
                         f"start={start} total={total} width {wpb}")
                args = (r, start, TILE_ROWS, idx)
                if default:
                    held("expand_select", bi.expand_select(*args),
                         ref.expand_select_ref(*args), where)
                held("expand_intersect",
                     bi.expand_intersect(*args, tabs, slots, clears,
                                         words_per_block=wpb),
                     ref.expand_intersect_ref(*args, tabs, slots, clears),
                     where)
    return errs, n


def check_lane(bi, ref, dev, wpb: int) -> tuple[int, int]:
    """tile_intersect with a query lane at word-block width `wpb` against
    its plain version, bit for bit: Q in {1, 2, 5, 8}
    stacked queries, k in 1..4 tables, W in
    {1, 33, 128}, T = 256 rows, query ids from -Q - 2 to Q + 2 and keys
    from -45 to 44 (negative ones count from the end, past the end clamp,
    each on its own axis), same-label clears on and off. Returns the
    largest difference and the number of cases."""
    gen = np.random.default_rng(9)
    worst, n = 0, 0
    for q in (1, 2, 5, 8):
        for k in (1, 2, 3, 4):
            for w in (1, 33, 128):
                tabs = [torch.from_numpy(gen.integers(
                    0, 2 ** 32, (q, int(gen.integers(1, 40)), w),
                    dtype=np.uint32).view(np.int32)).to(dev)
                    for _ in range(k)]
                idx = torch.from_numpy(np.stack(
                    [gen.integers(-q - 2, q + 3, TILE_ROWS)]
                    + [gen.integers(-45, 45, TILE_ROWS) for _ in range(3)],
                    1).astype(np.int32)).to(dev)
                slots = [int(x) for x in gen.integers(1, 4, k)]
                for clears in ([3, slots[0]], []):
                    got = bi.tile_intersect(tabs, idx, slots, clears,
                                            qid_slot=0, words_per_block=wpb)
                    want = ref.tile_intersect_ref(tabs, idx, slots, clears,
                                                  qid_slot=0)
                    torch.cuda.synchronize()
                    err = max_abs_err(got, want)
                    worst, n = max(worst, err), n + 1
                    if err:
                        raise SystemExit(
                            f"tile_intersect lane disagrees: Q={q} k={k} "
                            f"W={w} clears={clears} width {wpb} "
                            f"max_abs_err={err}")
    return worst, n


def prepare(api, cemr_match) -> list:
    """Build the datasets, compile the queries and count each with the
    port's `cemr_match` (numpy, host). Returns one workload per query."""
    work, matchers = [], {}
    for name, scale, size in WORKLOADS:
        if (name, scale) not in matchers:
            t0 = time.perf_counter()
            ds = api.Dataset.synthetic(name, scale=scale)
            matchers[name, scale] = api.Matcher(ds)
            print(f"dataset {name} scale {scale}: |V|={ds.n} "
                  f"|E|={ds.n_edges} "
                  f"preprocess_s={time.perf_counter() - t0:.3f}", flush=True)
        m = matchers[name, scale]
        q = m.dataset.random_query(size=size, seed=7)
        cq = m.compile(q)
        t0 = time.perf_counter()
        ref = cemr_match(q, m.dataset.graph, limit=LIMIT,
                         preprocessed=(cq.cs, cq.an)).count
        print(f"cemr_match {name} scale {scale} size {size}: count={ref} "
              f"s={time.perf_counter() - t0:.3f}", flush=True)
        if (name, scale, size) == ("human", 1.0, 8) \
                and ref != HUMAN_SIZE8_COUNT:
            raise SystemExit(f"human size-8 cemr_match gave {ref}, "
                             f"expected {HUMAN_SIZE8_COUNT}")
        if scale != 1.0 and ref >= LIMIT:
            raise SystemExit(f"{name} scale {scale} size {size} reaches the "
                             "limit: its count is no exact check")
        work.append({"dataset": name, "scale": scale, "query_size": size,
                     "matcher": m, "query": q, "compiled": cq, "ref": ref})
    return work


class PathCalls:
    """Counts, while active, what the main path asks of the bitmap kernels,
    independently of the wrappers' launch counts: the engine's boundary
    expansions (`expand` closures), fused boundaries (`fused` closures)
    and pair-extend computes (`compute_r` closures of extends with
    backward pairs), the same of the superbatch's BatchProgram
    (`batched_expand`, `batched_pair_compute`) when given the scheduler
    module, and every call of the torch `bitops.expand_select` on a CUDA
    tensor. Engines and programs must be built while it is active."""

    def __init__(self, engine_mod, bitops_mod, sched_mod=None):
        self.eng_cls, self.bitops = engine_mod.VectorEngine, bitops_mod
        self.prog_cls = sched_mod.BatchProgram if sched_mod else None
        self.calls = {"expand": 0, "fused": 0, "pair_compute": 0,
                      "batched_expand": 0, "batched_pair_compute": 0,
                      "torch_expand_select_on_card": 0}

    def _counted(self, key, fn):
        def wrapped(*args, **kwargs):
            self.calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    def __enter__(self):
        cls, counted = self.eng_cls, self._counted
        self.saved = {name: getattr(cls, name) for name in
                      ("_make_expand", "_make_expand_fused",
                       "_make_compute_parts")}
        saved = self.saved
        self.saved_select = self.bitops.expand_select

        def make_expand(eng, si):
            return counted("expand", saved["_make_expand"](eng, si))

        def make_fused(eng, si, sj):
            fn = saved["_make_expand_fused"](eng, si, sj)
            return None if fn is None else counted("fused", fn)

        def make_compute(eng, si):
            compute_r, con = saved["_make_compute_parts"](eng, si)
            stage = eng._stages[si]
            if stage[0] == "extend" and stage[1].level > 0 \
                    and stage[1].bk_pairs:
                compute_r = counted("pair_compute", compute_r)
            return compute_r, con

        def torch_select(bm, *args, **kwargs):
            if bm.is_cuda:
                self.calls["torch_expand_select_on_card"] += 1
            return self.saved_select(bm, *args, **kwargs)

        cls._make_expand = make_expand
        cls._make_expand_fused = make_fused
        cls._make_compute_parts = make_compute
        self.bitops.expand_select = torch_select
        if self.prog_cls is not None:
            prog = self.prog_cls
            self.saved_prog = {name: getattr(prog, name) for name in
                               ("_make_expand", "_make_compute_parts")}
            saved_prog = self.saved_prog

            def make_batched_expand(p, si):
                return counted("batched_expand",
                               saved_prog["_make_expand"](p, si))

            def make_batched_compute(p, si):
                compute_r, con = saved_prog["_make_compute_parts"](p, si)
                stage = p._stages[si]
                if stage[0] == "e" and stage[3]:
                    compute_r = counted("batched_pair_compute", compute_r)
                return compute_r, con

            prog._make_expand = make_batched_expand
            prog._make_compute_parts = make_batched_compute
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.eng_cls, name, fn)
        self.bitops.expand_select = self.saved_select
        if self.prog_cls is not None:
            for name, fn in self.saved_prog.items():
                setattr(self.prog_cls, name, fn)


class AutotuneLog:
    """Records, while active, the width each fused boundary's engine build
    gets from `autotune_words_per_block`: one {"k", "W", "width"} a
    call."""

    def __init__(self, bi):
        self.bi, self.picks = bi, []

    def __enter__(self):
        self.saved = tune = self.bi.autotune_words_per_block

        def logged(k, w, **kwargs):
            got = tune(k, w, **kwargs)
            self.picks.append({"k": k, "W": w, "width": got})
            return got

        self.bi.autotune_words_per_block = logged
        return self

    def __exit__(self, *exc):
        self.bi.autotune_words_per_block = self.saved


def launches_by_width(bi) -> dict:
    """Each width-taking wrapper's launches by width since the last
    reset."""
    return {fn.__name__: dict(fn.launches_by_width)
            for fn in bi.WIDTH_WRAPPERS}


def sweep_counts(bi) -> dict:
    """The autotune sweeps' expand_intersect launches since the last
    reset, as the wrapper counted them where it launched: their total
    ("sweep_launches") and by width ("sweep_by_width")."""
    by_width = dict(bi.expand_intersect.sweep_launches_by_width)
    return {"sweep_launches": sum(by_width.values()),
            "sweep_by_width": by_width}


def drive(bi, engine_mod, bitops_mod, work, intersect: str):
    """One intersect route of the main path: every workload through
    Matcher.count, with the launch counts set to 0 just before and read
    just after, and the path's kernel work counted by `PathCalls` (the
    route's engines are built here, so the fused route's autotune sweeps
    run here: their expand_intersect launches are in the route's count
    and in the calls' "sweep_launches"). Returns the per-run lines (with
    the full VectorStats), the route's launch counts, its path calls and
    {"by_width": launches by width, "picks": the autotune's picks}."""
    runs = []
    with PathCalls(engine_mod, bitops_mod) as path, AutotuneLog(bi) as tuned:
        bi.reset_launches()
        for w in work:
            t0 = time.perf_counter()
            # engine="vector": human's size-8 candidate space is small
            # enough that engine="auto" would pick the ref engine
            out = w["matcher"].count(w["query"], engine="vector",
                                     intersect=intersect, limit=LIMIT)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs.append({"dataset": w["dataset"], "scale": w["scale"],
                         "query_size": w["query_size"],
                         "intersect": intersect, "count": out.count,
                         "cemr_match_count": w["ref"], "wall_s": wall,
                         "compile_s": out.compile_s,
                         "elapsed_s": out.elapsed_s,
                         "stats": dataclasses.asdict(out.stats)})
        launches = {fn.__name__: fn.launches for fn in bi.WRAPPERS}
        widths = {"by_width": launches_by_width(bi), "picks": tuned.picks}
        calls = dict(path.calls, **sweep_counts(bi))
    return runs, launches, calls, widths


def check_launches(route: str, launches: dict, calls: dict) -> None:
    """Each kernel of the route launched once per boundary or extend it
    covers, and the torch expand_select never ran on the card: on "auto"
    expand_select once per boundary expansion; on "fused" expand_intersect
    once per fused boundary (plus the autotune sweeps' launches, at least
    one sweep) and expand_select once per other boundary; on both
    tile_intersect once per pair extend computed (the fused boundary's
    extend is computed by expand_intersect); the old entry points
    never."""
    want = {"tile_intersect": calls["pair_compute"],
            "expand_select": calls["expand"],
            "expand_intersect": calls["fused"] + calls["sweep_launches"],
            "bitmap_intersect": 0, "fused_expand_intersect": 0}
    if launches != want:
        raise SystemExit(f"{route}: launches {launches}, expected one per "
                         f"boundary or extend covered: {want} "
                         f"(path calls {calls})")
    needed = (("tile_intersect", "expand_select") if route == "auto"
              else ("tile_intersect", "expand_intersect"))
    for name in needed:
        if launches[name] <= 0:
            raise SystemExit(f"{name} never launched on the {route} route")
    if route == "auto" and (calls["fused"] or calls["sweep_launches"]):
        raise SystemExit(f"auto route fused {calls['fused']} boundaries, "
                         f"swept {calls['sweep_launches']} launches")
    if calls["torch_expand_select_on_card"]:
        raise SystemExit(f"{route}: the torch expand_select ran "
                         f"{calls['torch_expand_select_on_card']} times on "
                         f"the card")


def check_runs(by_route: dict) -> None:
    """Counts against cemr_match, the overlap invariant, VectorStats equal
    across the two routes, and the reference's supersteps / CER hits."""
    for route, runs in by_route.items():
        for r in runs:
            key = (r["dataset"], r["scale"], r["query_size"])
            where = f"{key} {route}"
            st = r["stats"]
            if r["count"] != r["cemr_match_count"]:
                raise SystemExit(f"{where}: count {r['count']} != "
                                 f"cemr_match {r['cemr_match_count']}")
            if st["readbacks"] + st["overlapped_supersteps"] \
                    != st["supersteps"]:
                raise SystemExit(f"{where}: readbacks + "
                                 "overlapped_supersteps != supersteps")
            want = REFERENCE_STATS.get(key, {})
            for field, value in want.items():
                if st[field] != value:
                    raise SystemExit(f"{where}: {field} {st[field]} != "
                                     f"the reference's {value}")
    for a, f in zip(by_route["auto"], by_route["fused"]):
        if a["stats"] != f["stats"]:
            diff = {k: (v, f["stats"][k]) for k, v in a["stats"].items()
                    if v != f["stats"][k]}
            raise SystemExit(f"{a['dataset']} scale {a['scale']} size "
                             f"{a['query_size']}: VectorStats differ "
                             f"between routes: {diff}")


def path_by_width(by_width: dict, calls: dict) -> dict:
    """expand_intersect's launches by width without the autotune sweeps',
    each width's less the sweeps' launches at that width."""
    return {wpb: n - calls["sweep_by_width"][wpb]
            for wpb, n in by_width["expand_intersect"].items()}


def check_widths(bi, by_width: dict, picks: list, calls: dict, route: str,
                 forced: int | None = None) -> None:
    """A route's launches by width: every entry but expand_intersect at the
    default width only; expand_intersect, the sweeps' launches aside, once
    per fused boundary, each at a width its engine build picked (`forced`:
    the forced width), each pick a member of FUSED_TILE_WIDTHS."""
    default = bi.DEFAULT_WORDS_PER_BLOCK
    for name, counts in by_width.items():
        if name != "expand_intersect" and any(
                n for wpb, n in counts.items() if wpb != default):
            raise SystemExit(f"{route}: {name} launched at widths {counts}")
    path = path_by_width(by_width, calls)
    picked = {p["width"] for p in picks}
    if (any(n < 0 or (n and wpb not in picked) for wpb, n in path.items())
            or sum(path.values()) != calls["fused"]):
        raise SystemExit(f"{route}: expand_intersect at widths {path} "
                         f"(sweeps aside) for {calls['fused']} fused "
                         f"boundaries and picks {sorted(picked)}")
    if not picked <= set(bi.FUSED_TILE_WIDTHS) or (
            forced is not None and picked - {forced}):
        raise SystemExit(f"{route}: autotune picks {picks}")
    if route == "auto" and picks:
        raise SystemExit(f"auto route asked the autotune: {picks}")


def drive_widths(api, bi, engine_mod, bitops_mod, work, fused_runs) -> dict:
    """Phase 4's scale-1.0 dblp size-8 query on intersect="fused" once
    more at each width of FUSED_TILE_WIDTHS, forced by patching the
    engine's `autotune_words_per_block` to return it, each on a fresh
    Matcher over the same Dataset (its engine built anew), with the launch
    counts set to 0 just before and read just after. Each run must give
    the fused route's count and every VectorStats field, and launch
    expand_intersect once per fused boundary, all at the forced width."""
    w = next(x for x in work if (x["dataset"], x["scale"], x["query_size"])
             == ("dblp", 1.0, 8))
    want = next(r for r in fused_runs
                if (r["dataset"], r["scale"], r["query_size"])
                == ("dblp", 1.0, 8))
    saved, out = bi.autotune_words_per_block, {}
    for wpb in bi.FUSED_TILE_WIDTHS:
        bi.autotune_words_per_block = \
            lambda k, w_, *, device, _wpb=wpb: _wpb
        try:
            with PathCalls(engine_mod, bitops_mod) as path, \
                    AutotuneLog(bi) as tuned:
                bi.reset_launches()
                t0 = time.perf_counter()
                res = api.Matcher(w["matcher"].dataset).count(
                    w["query"], engine="vector", intersect="fused",
                    limit=LIMIT)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {fn.__name__: fn.launches for fn in bi.WRAPPERS}
                by_width = launches_by_width(bi)
                calls = dict(path.calls, **sweep_counts(bi))
        finally:
            bi.autotune_words_per_block = saved
        stats = dataclasses.asdict(res.stats)
        if res.count != want["count"] or stats != want["stats"]:
            diff = {k: (v, stats[k]) for k, v in want["stats"].items()
                    if v != stats[k]}
            raise SystemExit(f"fused at width {wpb}: count {res.count} "
                             f"against {want['count']}, VectorStats "
                             f"differ: {diff}")
        check_launches(f"fused at width {wpb}", launches, calls)
        check_widths(bi, by_width, tuned.picks, calls,
                     f"fused at width {wpb}", forced=wpb)
        if not tuned.picks or calls["sweep_launches"]:
            raise SystemExit(f"fused at width {wpb}: {len(tuned.picks)} "
                             f"boundaries built, {calls['sweep_launches']} "
                             f"sweep launches")
        out[wpb] = {"count": res.count, "wall_s": wall, "launches": launches,
                    "by_width": by_width, "path_calls": calls,
                    "boundaries_built": len(tuned.picks)}
    return out


def mix_queries(ds) -> list:
    return [ds.random_query(size=size, seed=seed) for size, seed in MIX]


def check_mesh_auto(api, options_mod, work, runs) -> dict:
    """Phase 4's dblp counts once more with `mesh="auto"` on the card, each
    on a fresh Matcher over the same Dataset (a warm engine keeps its CER
    and failing-set state, so only a cold run is comparable). The
    reference's cost model over `torch.cuda.device_count()` cards must pick
    the single-device path (a larger result raises), and each count and
    every VectorStats field must equal the `mesh=None` run's."""
    n_devices = torch.cuda.device_count()
    held = []
    for w, r in zip(work, runs):
        if (w["dataset"], w["scale"]) != ("dblp", 1.0):
            continue
        rows = int(w["compiled"].cs.sizes().sum())
        lanes = options_mod.auto_mesh_devices(
            rows, n_devices=n_devices, cpu_count=os.cpu_count() or 1,
            platform="gpu")
        m = api.Matcher(w["matcher"].dataset, device=w["matcher"].device)
        out = m.count(w["query"], engine="vector", intersect="auto",
                      limit=LIMIT, mesh="auto")
        stats = dataclasses.asdict(out.stats)
        where = f"dblp size {w['query_size']} mesh=\"auto\""
        if out.count != r["count"]:
            raise SystemExit(f"{where}: count {out.count} != mesh=None "
                             f"{r['count']}")
        if stats != r["stats"]:
            diff = {k: (v, r["stats"][k]) for k, v in stats.items()
                    if v != r["stats"][k]}
            raise SystemExit(f"{where}: VectorStats differ from mesh=None: "
                             f"{diff}")
        held.append({"query_size": w["query_size"], "total_rows": rows,
                     "auto_mesh_devices": lanes, "count": out.count})
    if not held:
        raise SystemExit("phase 4 has no dblp scale 1.0 count to hold "
                         "mesh=\"auto\" against")
    return {"device_count": n_devices, "held": held}


def drive_superbatch(api, bi, engine_mod, bitops_mod, sched_mod, ds,
                     cemr_match) -> dict:
    """The superbatch path: the MIX on `ds` through a fresh Matcher's
    `match_many` with batch="auto" (program cache cleared, launch counts
    set to 0 just before and read just after, the path's kernel work
    counted by `PathCalls`), then batch="off", then both timed warm in the
    order auto, off, off, auto, auto, off. Holds the counts, buckets,
    stats and launches (see the module docstring); returns what it
    measured."""
    from repro_torch.core.plan import plan_shape_signature
    m = api.Matcher(ds)
    queries = mix_queries(ds)
    want, sigs = [], []
    for q in queries:
        cq = m.compile(q)
        want.append(cemr_match(q, ds.graph, limit=LIMIT,
                               preprocessed=(cq.cs, cq.an)).count)
        sigs.append(plan_shape_signature(cq.plan, tile_rows=TILE_ROWS))
    for i, c in MIX_EXACT.items():
        if want[i] != c:
            raise SystemExit(f"mix query {MIX[i]}: cemr_match {want[i]}, "
                             f"expected {c}")
    groups: dict = {}
    for i, sig in enumerate(sigs):
        groups.setdefault(sig, []).append(i)
    if sorted(map(tuple, groups.values())) != sorted(MIX_BUCKETS):
        raise SystemExit(f"the mix's buckets are {list(groups.values())}, "
                         f"expected {MIX_BUCKETS}")
    sched_mod._PROGRAMS.clear()
    with PathCalls(engine_mod, bitops_mod, sched_mod) as path:
        bi.reset_launches()
        t0 = time.perf_counter()
        bat = m.match_many(queries, engine="vector", limit=LIMIT,
                           batch="auto")
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in bi.WRAPPERS}
        lane = bi.tile_intersect.lane_launches
    calls = dict(path.calls)
    seq = m.match_many(queries, engine="vector", limit=LIMIT, batch="off")
    counts = {"auto": [o.count for o in bat], "off": [o.count for o in seq],
              "cemr_match": want}
    if not counts["auto"] == counts["off"] == want:
        raise SystemExit(f"mix counts differ: {counts}")
    buckets = []
    for idx in MIX_BUCKETS:
        st = bat[idx[0]].stats
        if any(bat[i].stats is not st for i in idx):
            raise SystemExit(f"bucket {idx} does not share one VectorStats")
        if st.batched_queries != (len(idx) if len(idx) > 1 else 0):
            raise SystemExit(f"bucket {idx}: batched_queries "
                             f"{st.batched_queries}")
        if st.readbacks + st.overlapped_supersteps != st.supersteps:
            raise SystemExit(f"bucket {idx}: readbacks + "
                             "overlapped_supersteps != supersteps")
        for field, value in REFERENCE_MIX_STATS.get(idx, {}).items():
            if getattr(st, field) != value:
                raise SystemExit(f"bucket {idx}: {field} "
                                 f"{getattr(st, field)} != the reference's "
                                 f"{value}")
        buckets.append({"queries": [MIX[i] for i in idx],
                        "stats": dataclasses.asdict(st)})
    want_launches = {
        "tile_intersect": calls["pair_compute"]
        + calls["batched_pair_compute"],
        "expand_select": calls["expand"] + calls["batched_expand"],
        "expand_intersect": 0, "bitmap_intersect": 0,
        "fused_expand_intersect": 0}
    if launches != want_launches or lane != calls["batched_pair_compute"] \
            or not lane or not calls["batched_expand"] \
            or calls["torch_expand_select_on_card"]:
        raise SystemExit(f"superbatch launches {launches}, lane {lane}, "
                         f"expected {want_launches} and the lane once per "
                         f"batched pair extend (path calls {calls})")
    walls = {"auto": [], "off": []}
    for mode in ("auto", "off", "off", "auto", "auto", "off"):
        t0 = time.perf_counter()
        outs = m.match_many(queries, engine="vector", limit=LIMIT,
                            batch=mode)
        torch.cuda.synchronize()
        walls[mode].append(time.perf_counter() - t0)
        if [o.count for o in outs] != want:
            raise SystemExit(f"mix counts changed on a warm {mode} run")
    med = {mode: float(np.median(v)) for mode, v in walls.items()}
    return {"queries": len(queries), "counts": counts, "buckets": buckets,
            "launches": launches, "lane_launches": lane, "path_calls": calls,
            "cold_auto_s": cold_s, "walls_s": walls, "median_s": med,
            "queries_per_s": {mode: len(queries) / v
                              for mode, v in med.items()},
            "matcher": m, "queries_list": queries}


def drive_union(api, graph_mod, cemr_match, dev) -> dict:
    """The batched union stage on the card: the all_white workload of
    tests/test_batch_differential.py (decompose boundaries and a
    no-black-bwd union) through match_many auto and off, counts held
    against cemr_match, with the batched run's peak device memory; then
    `_union_rows_batched` alone at dblp's and eu2005's padded widths
    (5 queries in a stack padded to 8, T = 256, sources of 4,096 and
    8,192 rows, 128 and 256 words), its peak above the inputs."""
    from repro_torch.core.scheduler import _union_rows_batched
    data = graph_mod.synthetic_labeled_graph(180, 7.0, 2, seed=3)
    q = graph_mod.random_walk_query(data, 6, seed=301)
    m = api.Matcher(api.Dataset.from_graph(data))
    want = cemr_match(q, data).count
    opts = dict(engine="vector", tile_rows=32, limit=10 ** 9,
                encoding="all_white")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    bat = m.match_many([q, q], batch="auto", **opts)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    seq = m.match_many([q, q], batch="off", **opts)
    if not ([o.count for o in bat] == [o.count for o in seq] == [want] * 2
            and bat[0].stats.batched_queries == 2):
        raise SystemExit(f"union workload: batched {[o.count for o in bat]}"
                         f", sequential {[o.count for o in seq]}, "
                         f"cemr_match {want}")
    gen = np.random.default_rng(4)
    widths = {}
    for name, (s, w) in {"dblp": (4096, 128), "eu2005": (8192, 256)}.items():
        tables = torch.from_numpy(gen.integers(
            0, 2 ** 32, (8, s, w), dtype=np.uint32).view(np.int32)).to(dev)
        bmcol = torch.from_numpy(frontier_bits(
            gen, TILE_ROWS, s // 32, "sparse").view(np.int32)).to(dev)
        qid = torch.from_numpy(gen.integers(0, 5, TILE_ROWS).astype(
            np.int32)).to(dev)
        _union_rows_batched(tables, bmcol, qid, 5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        _union_rows_batched(tables, bmcol, qid, 5)
        torch.cuda.synchronize()
        widths[name] = {"S": s, "W": w, "Q": 8, "n_real": 5, "T": TILE_ROWS,
                        "peak_bytes_above_inputs":
                        torch.cuda.max_memory_allocated(dev) - before,
                        "ms": median_ms(lambda: _union_rows_batched(
                            tables, bmcol, qid, 5), reps=3, iters=3)}
        del tables
    torch.cuda.empty_cache()
    return {"count": want, "batched_peak_bytes": peak, "widths": widths}


def drive_compat(bi, engine_mod, bitops_mod, work) -> list:
    """`count(use_cer_buffer=False)`, the stage-at-a-time compat loop, on
    phase 4's dblp size 8, human size 8 and dblp scale 0.02 queries: counts
    against cemr_match, bucketed tiles, dedup keys and dispatches against
    the reference's, no failure-cache or readback stats, and, with the
    launch counts set to 0 just before each count and read just after,
    tile_intersect once per pair compute or bucketed compute, expand_select
    once per expansion, nothing else."""
    runs = []
    for w in work:
        key = (w["dataset"], w["scale"], w["query_size"])
        if key not in REFERENCE_COMPAT_STATS:
            continue
        with PathCalls(engine_mod, bitops_mod) as path:
            bi.reset_launches()
            t0 = time.perf_counter()
            out = w["matcher"].count(w["query"], engine="vector",
                                     use_cer_buffer=False, limit=LIMIT)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in bi.WRAPPERS}
        st = out.stats
        if out.count != w["ref"]:
            raise SystemExit(f"compat {key}: count {out.count} != "
                             f"cemr_match {w['ref']}")
        for field, value in REFERENCE_COMPAT_STATS[key].items():
            if getattr(st, field) != value:
                raise SystemExit(f"compat {key}: {field} "
                                 f"{getattr(st, field)} != the reference's "
                                 f"{value}")
        if st.readbacks or st.supersteps or st.fail_hits or st.fail_inserts:
            raise SystemExit(f"compat {key}: superstep or failure-cache "
                             f"stats are not 0: {st}")
        calls = path.calls
        want = {"tile_intersect": calls["pair_compute"] + st.bucketed_tiles,
                "expand_select": calls["expand"], "expand_intersect": 0,
                "bitmap_intersect": 0, "fused_expand_intersect": 0}
        if launches != want or not launches["tile_intersect"] \
                or not launches["expand_select"] \
                or calls["torch_expand_select_on_card"]:
            raise SystemExit(f"compat {key}: launches {launches}, expected "
                             f"{want} (path calls {calls})")
        runs.append({"workload": list(key), "count": out.count,
                     "wall_s": wall, "launches": launches,
                     "stats": dataclasses.asdict(st)})
    return runs


def skewed_star(graph_mod):
    """(query, data): one label-0 hub fanning out to 100 label-1 mids with
    3 label-2 leaves each (tests/test_shard_differential.py's skewed
    star): with the hub as root every subtree hangs off one root
    candidate, so only chunk-splitting spreads it over the lanes."""
    nmid, nleaf = 100, 3
    labels = [0] + [1] * nmid + [2] * (nmid * nleaf)
    edges = [(0, 1 + i) for i in range(nmid)]
    for i in range(nmid):
        for j in range(nleaf):
            edges.append((1 + i, 1 + nmid + i * nleaf + j))
    data = graph_mod.build_graph(len(labels), edges, labels)
    query = graph_mod.build_graph(3, [(0, 1), (1, 2)], [0, 1, 2])
    return query, data


def held_stats(where: str, stats: dict, want: dict) -> None:
    if stats != want:
        diff = {k: (v, want.get(k)) for k, v in stats.items()
                if v != want.get(k)}
        raise SystemExit(f"{where}: VectorStats differ from the "
                         f"reference's: {diff}")


def sharded_count(bi, engine_mod, bitops_mod, cq, dev, mesh, **kw) -> dict:
    """One cold count through a fresh VectorEngine over `mesh` (None = the
    single-device scheduler), its launches counted from 0 and its kernel
    work by `PathCalls`: the wall (synchronised), count, stats, launches
    and path calls."""
    with PathCalls(engine_mod, bitops_mod) as path:
        bi.reset_launches()
        t0 = time.perf_counter()
        eng = engine_mod.VectorEngine(cq.cs, cq.an, device=dev,
                                      plan=cq.plan, mesh=mesh, **kw)
        res = eng.run(limit=LIMIT)
        sync(dev)
        wall = time.perf_counter() - t0
        launches = launch_counts(bi)
    return {"lanes": 1 if mesh is None else mesh.size, "count": res.count,
            "wall_s": wall, "stats": dataclasses.asdict(res.stats),
            "launches": launches, "path_calls": dict(path.calls)}


def launches_a_dispatch(run: dict) -> float:
    return (sum(run["launches"].values())
            / max(run["stats"]["supersteps"], 1))


def sharded_superbatch(bi, engine_mod, bitops_mod, sched_mod, plans, mesh,
                       dev, batched, want) -> dict:
    """One `ShardedSuperbatchScheduler` drain of `plans` over `mesh`, its
    launches counted from 0 and its kernel work by `PathCalls`: counts
    equal to the batched drain's and the reference's, every VectorStats
    field the reference's, each kernel once per live lane per boundary
    or extend, the query lane once per batched pair extend."""
    from repro_torch.core.shard import ShardedSuperbatchScheduler
    where = f"sharded superbatch over {mesh.devices}"
    with PathCalls(engine_mod, bitops_mod, sched_mod) as path:
        bi.reset_launches()
        t0 = time.perf_counter()
        counts, st, _ = ShardedSuperbatchScheduler(
            plans, mesh=mesh, device=dev).run(limit=LIMIT)
        sync(dev)
        wall = time.perf_counter() - t0
        launches = launch_counts(bi)
        lane = bi.tile_intersect.lane_launches
    if counts != batched or counts != want["counts"]:
        raise SystemExit(f"{where}: counts {counts}, batched {batched}, "
                         f"reference {want['counts']}")
    held_stats(where, dataclasses.asdict(st), want["stats"])
    calls = dict(path.calls)
    require_path_launches(where, launches, calls)
    if lane != calls["batched_pair_compute"] or not lane:
        raise SystemExit(f"{where}: lane {lane}, batched pair extends "
                         f"{calls['batched_pair_compute']}")
    return {"lanes": mesh.size, "counts": counts, "wall_s": wall,
            "supersteps": st.supersteps, "shard_lanes": st.shard_lanes,
            "shard_rebalances": st.shard_rebalances, "launches": launches,
            "lane_launches": lane,
            "launches_a_dispatch": (sum(launches.values())
                                    / max(st.supersteps, 1))}


def drive_sharded(bi, engine_mod, bitops_mod, sched_mod, graph_mod, work,
                  sb_res, cemr_match, dev) -> dict:
    """Phase 4d: sharded enumeration with its lanes on the one card (the
    counterpart of the reference tests' forced host devices). For phase
    4's scale-1.0 dblp queries and the skewed star: a single-device count
    and `ShardedTileScheduler` counts over EnumMesh((cuda:0,) * S) for S
    in SHARD_LANES, in the order 1, 2, 4, 4, 2, 1, each on a fresh engine;
    every count equals the single-device one (and cemr_match's where below
    the limit), every VectorStats field the reference's (REFERENCE_SHARD),
    and each bitmap kernel launches once per live lane per boundary or
    extend covered (`PathCalls`), the torch expand_select never. Then
    `ShardedSuperbatchScheduler` over SHARD_SB_LANES lanes on phase 4b's
    five-query bucket (`sharded_superbatch`). With more than one card,
    the same over meshes of distinct cards for each lane count there are
    cards for, held the same way. Returns what it measured."""
    from repro_torch.core.plan import build_plan
    from repro_torch.core.ref_engine import preprocess
    from repro_torch.launch.mesh import EnumMesh
    card0 = (torch.device("cuda", torch.cuda.current_device())
             if dev.type == "cuda" else dev)
    meshes = {s: EnumMesh((card0,) * s) for s in SHARD_LANES}
    star_q, star_d = skewed_star(graph_mod)
    cs, an = preprocess(star_q, star_d, encoding="all_black",
                        order=[0, 1, 2])
    star = types.SimpleNamespace(cs=cs, an=an, plan=build_plan(cs, an))
    cases = [(f"dblp size {w['query_size']}", w["compiled"], w["ref"],
              REFERENCE_SHARD["dblp"][str(w["query_size"])], {})
             for w in work if (w["dataset"], w["scale"]) == ("dblp", 1.0)]
    cases.append(("skewed star", star, cemr_match(
        star_q, star_d, encoding="all_black", order=[0, 1, 2]).count,
        REFERENCE_SHARD["star"], {"tile_rows": STAR_TILE_ROWS}))
    out = []
    launches = dict.fromkeys(launch_counts(bi), 0)
    for where, cq, want_count, ref_stats, kw in cases:
        by_lanes: dict = {}
        for s in (1, *SHARD_LANES, *SHARD_LANES[::-1], 1):
            r = sharded_count(bi, engine_mod, bitops_mod, cq, dev,
                              meshes.get(s), **kw)
            by_lanes.setdefault(s, []).append(r)
            if s > 1:
                for name, n in r["launches"].items():
                    launches[name] += n
        single = by_lanes[1][0]
        if single["count"] != min(want_count, LIMIT):
            raise SystemExit(f"{where}: single-device count "
                             f"{single['count']} != cemr_match "
                             f"{want_count}")
        for s, rs in by_lanes.items():
            for r in rs:
                tag = f"{where} over {s} lane(s)"
                if r["count"] != single["count"]:
                    raise SystemExit(f"{tag}: count {r['count']} != the "
                                     f"single-device {single['count']}")
                if r["stats"] != rs[0]["stats"]:
                    raise SystemExit(f"{tag}: two cold runs differ")
                if s > 1:
                    held_stats(tag, r["stats"], ref_stats[str(s)]["stats"])
                    if r["count"] != ref_stats[str(s)]["count"]:
                        raise SystemExit(f"{tag}: count differs from the "
                                         "reference's")
                    if not r["stats"]["shard_lanes"]:
                        raise SystemExit(f"{tag}: no lane dispatched")
                require_path_launches(tag, r["launches"], r["path_calls"])
        out.append({
            "workload": where, "count": single["count"],
            "lanes": {s: {"wall_s": [r["wall_s"] for r in rs],
                          "supersteps": rs[0]["stats"]["supersteps"],
                          "shard_lanes": rs[0]["stats"]["shard_lanes"],
                          "shard_rebalances":
                              rs[0]["stats"]["shard_rebalances"],
                          "launches": rs[0]["launches"],
                          "launches_a_dispatch": launches_a_dispatch(rs[0])}
                      for s, rs in by_lanes.items()}})
    # the superbatch over lanes, on phase 4b's five-query bucket
    want = REFERENCE_SHARD["superbatch"]
    m = sb_res["matcher"]
    plans = [m.compile(sb_res["queries_list"][i]).plan
             for i in want["indices"]]
    batched = [sb_res["counts"]["auto"][i] for i in want["indices"]]
    sb_out = sharded_superbatch(bi, engine_mod, bitops_mod, sched_mod, plans,
                                EnumMesh((card0,) * SHARD_SB_LANES), dev,
                                batched, want)
    for name, n in sb_out["launches"].items():
        launches[name] += n
    # the same over distinct cards, where the machine has more than one
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    distinct = []
    for s in SHARD_LANES:
        if s > n_cards:
            continue
        mesh = EnumMesh(tuple(torch.device("cuda", i) for i in range(s)))
        for (where, cq, _, ref_stats, kw), c in zip(cases, out):
            tag = f"{where} over {s} cards"
            r = sharded_count(bi, engine_mod, bitops_mod, cq, dev, mesh,
                              **kw)
            if r["count"] != c["count"]:
                raise SystemExit(f"{tag}: count {r['count']} != the "
                                 f"single-device {c['count']}")
            held_stats(tag, r["stats"], ref_stats[str(s)]["stats"])
            require_path_launches(tag, r["launches"], r["path_calls"])
            distinct.append({"workload": where, "cards": s,
                             "wall_s": r["wall_s"],
                             "supersteps": r["stats"]["supersteps"]})
    if n_cards >= SHARD_SB_LANES:
        r = sharded_superbatch(
            bi, engine_mod, bitops_mod, sched_mod, plans,
            EnumMesh(tuple(torch.device("cuda", i)
                           for i in range(SHARD_SB_LANES))), dev, batched,
            want)
        distinct.append({"workload": "superbatch", "cards": SHARD_SB_LANES,
                         "wall_s": r["wall_s"],
                         "supersteps": r["supersteps"]})
    return {"counts": out, "superbatch": sb_out, "distinct_cards": distinct,
            "device_count": n_cards, "launches": launches}


LAUNCHER_ARGS = ["--arch", "match", "--dataset", "dblp", "--scale", "1.0",
                 "--query-size", "4", "--n-queries", "16", "--limit",
                 str(LIMIT), "--engine", "vector"]
# streaming: random_delta(graph, seed=i, 3 edge inserts, 3 edge deletes)
# for i < STREAM_DELTAS (the reference delta_bench's small batch), one
# more with vertex inserts and deletes, one whose labels miss a query's
# (the carried plan), then the delete and the re-insert of an edge that
# an embedding uses (random edits of a graph this size touch none)
STREAM_DELTAS = 8
STANDING_DELTAS = 2
SERVICE_REQUESTS = 32
POOL_WORKERS = 2


def launch_counts(bi) -> dict:
    return {fn.__name__: fn.launches for fn in bi.WRAPPERS}


def require_launched(where: str, launches: dict, calls: dict | None) -> None:
    """The bitmap kernels of the auto route launched (tile_intersect and
    expand_select), the fused and old entry points never, and the torch
    expand_select never on the card (`calls` from `PathCalls`, or None
    where the path ran in worker processes)."""
    if launches["tile_intersect"] <= 0 or launches["expand_select"] <= 0 \
            or launches["expand_intersect"] or launches["bitmap_intersect"] \
            or launches["fused_expand_intersect"]:
        raise SystemExit(f"{where}: launches {launches}")
    if calls is not None and calls["torch_expand_select_on_card"]:
        raise SystemExit(f"{where}: the torch expand_select ran on the card")


def require_path_launches(where: str, launches: dict, calls: dict) -> None:
    """`require_launched`, and each kernel once per boundary or extend the
    path covered, batched or not (`PathCalls`)."""
    want = {"tile_intersect": calls["pair_compute"]
            + calls["batched_pair_compute"],
            "expand_select": calls["expand"] + calls["batched_expand"],
            "expand_intersect": 0, "bitmap_intersect": 0,
            "fused_expand_intersect": 0}
    if launches != want:
        raise SystemExit(f"{where}: launches {launches}, expected {want} "
                         f"(path calls {calls})")
    require_launched(where, launches, calls)


def compute_apps() -> list[str]:
    """`nvidia-smi --query-compute-apps=pid,used_memory` lines."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def device_used_bytes(dev) -> int:
    """Bytes in use on the whole card, every process's."""
    free, total = torch.cuda.mem_get_info(dev)
    return total - free


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def exact_count(m, q, cemr_match) -> int:
    cq = m.compile(q)
    return cemr_match(q, m.dataset.graph, limit=LIMIT,
                      preprocessed=(cq.cs, cq.an)).count


def drive_launcher(serve, bi, engine_mod, bitops_mod, sched_mod, dblp_m,
                   cemr_match, dev) -> dict:
    """`--arch match` through the launcher's own `serve_match` (its Dataset,
    Matcher and `match_many`), launch counts set to 0 just before and read
    just after, the path's kernel work counted by `PathCalls`; its counts
    held against `cemr_match` on phase 4's identical dblp."""
    args = serve.parse_args(LAUNCHER_ARGS + ["--device", str(dev)])
    sched_mod._PROGRAMS.clear()
    with PathCalls(engine_mod, bitops_mod, sched_mod) as path:
        bi.reset_launches()
        res = serve.serve_match(args)
        sync(dev)
        launches = launch_counts(bi)
    calls = dict(path.calls)
    if res["dataset"].signature != dblp_m.dataset.signature:
        raise SystemExit("the launcher's dblp differs from phase 4's")
    want = [exact_count(dblp_m, q, cemr_match) for q in res["queries"]]
    if res["counts"] != want or res["engines"]["vector"] != len(want):
        raise SystemExit(f"launcher counts {res['counts']} != cemr_match "
                         f"{want} ({res['engines']})")
    require_path_launches("launcher", launches, calls)
    return {"counts": res["counts"], "seconds": res["seconds"],
            "queries_per_s": len(want) / res["seconds"],
            "launches": launches, "path_calls": calls,
            "cache_info": dataclasses.asdict(res["cache_info"])}


def exact_queries(m, cemr_match, n: int, taken) -> list:
    """The first `n` size-3 random queries (seeds from 2 up, skipping
    `taken`) whose counts lie in [1,000, LIMIT): exact counts with work
    enough to reach the kernels."""
    out = []
    for seed in range(2, 64):
        if (3, seed) in taken:
            continue
        q = m.dataset.random_query(size=3, seed=seed)
        c = exact_count(m, q, cemr_match)
        if 1_000 <= c < LIMIT:
            out.append(((3, seed), q, c))
            if len(out) == n:
                return out
    raise SystemExit(f"fewer than {n} size-3 queries count below the limit")


def label_disjoint_delta(streaming, graph, query):
    """Two edge deletes and two edge inserts among vertices whose labels the
    query does not have: a compiled plan of the query survives it."""
    ok = ~np.isin(graph.labels, np.unique(query.labels))
    src = np.repeat(np.arange(graph.n), np.diff(graph.indptr))
    dst = graph.indices.astype(np.int64)
    cand = np.flatnonzero(ok[src] & ok[dst] & (src < dst))
    deletes = np.stack([src[cand[:2]], dst[cand[:2]]], axis=1)
    vs = np.flatnonzero(ok)
    inserts = []
    for a, b in zip(vs[::7], vs[3::7]):
        if a != b and not graph.has_edge(int(a), int(b)):
            inserts.append((min(a, b), max(a, b)))
            if len(inserts) == 2:
                break
    return streaming.GraphDelta(edge_inserts=inserts, edge_deletes=deletes)


def drive_streaming(api, bi, streaming, runtime_queue, engine_mod,
                    bitops_mod, filtering, dblp, cemr_match, dev) -> dict:
    """`Matcher.count_delta` on a Dataset of its own over phase 4's dblp:
    exact bases for mix query (4, 9) and (3, 1) and a third exact query, a
    fourth exact query with no base, then STREAM_DELTAS random deltas, one
    with vertex inserts and deletes, one whose labels miss the third
    query's (its plan is carried: same CompiledQuery, same engine and device
    tables), and the delete and re-insert of an edge of one embedding of
    (3, 1). After each delta every outcome equals a fresh Matcher's count
    on a fresh Dataset of the maintained graph; at the end the counts equal
    `cemr_match` and the graph and index equal the rebuild oracle bit for
    bit. Each row also times the index maintenance alone
    (`streaming.apply_delta` on the same inputs, discarded) and the fresh
    Dataset's build. Then one standing query of a MatchQueueRuntime over
    the same Dataset rolls through STANDING_DELTAS more. Launches counted
    over the bases and count_delta calls only (the fresh recounts are
    checks)."""
    ds = api.Dataset.from_graph(dblp.graph, name="dblp")
    m = api.Matcher(ds, device=dev)
    qs = {"A": ds.random_query(size=4, seed=9),
          "B": ds.random_query(size=3, seed=1)}
    picked = exact_queries(m, cemr_match, 2, taken={(3, 1)})
    qs["C"], qs["D"] = picked[0][1], picked[1][1]
    names = ("A", "B", "C", "D")
    labels = {"A": (4, 9), "B": (3, 1), "C": picked[0][0],
              "D": picked[1][0]}
    tag = {n: "size %d seed %d" % labels[n] for n in names}
    acc = {fn.__name__: 0 for fn in bi.WRAPPERS}

    def counted(fn):
        before = launch_counts(bi)
        out = fn()
        sync(dev)
        for k, v in launch_counts(bi).items():
            acc[k] += v - before[k]
        return out

    kw = dict(engine="vector", limit=LIMIT)
    bases = {}
    rows = []
    oracle = dblp.graph
    with PathCalls(engine_mod, bitops_mod) as path:
        for name in ("A", "B", "C"):
            out = counted(lambda: m.count(qs[name], **kw))
            want = exact_count(m, qs[name], cemr_match)
            if out.count != want or want >= LIMIT:
                raise SystemExit(f"streaming base {labels[name]}: "
                                 f"{out.count} != cemr_match {want}")
            bases[name] = out.count
        carried = None
        edge = None
        for i in range(STREAM_DELTAS + 4):
            if i < STREAM_DELTAS:
                d = streaming.random_delta(ds.graph, seed=i,
                                           n_edge_inserts=3,
                                           n_edge_deletes=3)
            elif i == STREAM_DELTAS:
                d = streaming.random_delta(ds.graph, seed=i,
                                           n_edge_inserts=3,
                                           n_edge_deletes=3,
                                           n_vertex_inserts=2,
                                           n_vertex_deletes=2)
            elif i == STREAM_DELTAS + 1:
                # a fresh compile of C at this version, then a delta its
                # labels miss: the next count must carry the plan
                counted(lambda: m.count(qs["C"], **kw))
                cq = m.compile(qs["C"])
                eng = next(iter(cq._engines.values()))
                carried0 = m.cache_info().carried
                d = label_disjoint_delta(streaming, ds.graph, qs["C"])
            elif edge is None:
                emb = cemr_match(qs["B"], ds.graph, limit=1,
                                 materialize=True).embeddings[0]
                u, w = 0, int(qs["B"].neighbors(0)[0])
                edge = sorted((emb[u], emb[w]))
                d = streaming.GraphDelta(edge_deletes=[edge])
            else:
                d = streaming.GraphDelta(edge_inserts=[edge])
            t0 = time.perf_counter()
            streaming.apply_delta(ds.graph, ds.index, d)
            maintain_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            outs = counted(lambda: m.count_delta([qs[n] for n in names], d,
                                                 **kw))
            delta_ms = (time.perf_counter() - t0) * 1e3
            oracle = streaming.apply_delta_reference(oracle, d)
            t0 = time.perf_counter()
            fresh = api.Matcher(api.Dataset.from_graph(ds.graph), device=dev)
            build_ms = (time.perf_counter() - t0) * 1e3
            recount_ms = {}
            for n, out in zip(names, outs):
                t0 = time.perf_counter()
                want = fresh.count(qs[n], **kw)
                sync(dev)
                recount_ms[n] = (time.perf_counter() - t0) * 1e3
                if out.count != want.count or out.inexact \
                        or out.graph_version != ds.graph_version \
                        or want.count >= LIMIT:
                    raise SystemExit(
                        f"delta {i} {labels[n]}: count_delta {out} != a "
                        f"fresh count {want.count}")
            row = {"delta": i, "edits": repr(d),
                   "graph_version": ds.graph_version,
                   "count_delta_ms": delta_ms,
                   "maintain_ms": maintain_ms,
                   "fresh_dataset_ms": build_ms,
                   "outcomes": {tag[n]: {
                       "count": o.count, "created": o.created,
                       "destroyed": o.destroyed, "fallback": o.fallback,
                       "ms": o.elapsed_s * 1e3}
                       for n, o in zip(names, outs)},
                   "fresh_recount_ms": {tag[n]: v
                                        for n, v in recount_ms.items()}}
            if i == STREAM_DELTAS + 1:
                out = counted(lambda: m.count(qs["C"], **kw))
                if m.cache_info().carried <= carried0 \
                        or m.compile(qs["C"]) is not cq \
                        or next(iter(cq._engines.values())) is not eng \
                        or out.count != outs[2].count:
                    raise SystemExit(
                        f"label-disjoint delta: no carried plan for "
                        f"{labels['C']} (cache {m.cache_info()}, count "
                        f"{out.count} vs {outs[2].count})")
                carried = m.cache_info().carried
                row["carried"] = carried
            rows.append(row)
            print("stream " + json.dumps(row), flush=True)
        calls = dict(path.calls)
        final = {n: exact_count(m, qs[n], cemr_match) for n in names}
        if [final[n] for n in names] != [o.count for o in outs]:
            raise SystemExit(f"final counts {[o.count for o in outs]} != "
                             f"cemr_match {final}")
        index = filtering.build_data_index(oracle)
        for f in ("labels", "indptr", "indices"):
            a, b = getattr(ds.graph, f), getattr(oracle, f)
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise SystemExit(f"maintained graph.{f} != the oracle's")
        for f in ("deg_out", "nbr_label_counts", "lab_indptr",
                  "lab_indices"):
            a, b = getattr(ds.index, f), getattr(index, f)
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise SystemExit(f"maintained index.{f} != the rebuild's")
        if set(ds.index.by_label) != set(index.by_label) or any(
                not np.array_equal(ds.index.by_label[k], v)
                for k, v in index.by_label.items()):
            raise SystemExit("maintained index.by_label != the rebuild's")
        fallbacks = [o["fallback"] for r in rows
                     for o in r["outcomes"].values()]
        if all(fallbacks) or not any(fallbacks):
            raise SystemExit(f"count_delta outcomes must include an "
                             f"identity and a fallback: {fallbacks}")
        churn = [(o["created"], o["destroyed"]) for r in rows[-2:]
                 for o in r["outcomes"].values()
                 if not o["fallback"]]
        if not any(d for _, d in churn) or not any(c for c, _ in churn):
            raise SystemExit(f"the edge delete and re-insert changed no "
                             f"count through the identity path: {churn}")
        require_launched("streaming", acc, calls)
        # a standing query of the queue runtime over the same Dataset
        rt = runtime_queue.MatchQueueRuntime(ds, engine="vector",
                                             device=dev)
        before = launch_counts(bi)
        sid = rt.register_standing(qs["B"], limit=LIMIT)
        standing = []
        for k in range(STANDING_DELTAS):
            d = streaming.random_delta(ds.graph, seed=100 + k,
                                       n_edge_inserts=3, n_edge_deletes=3)
            out = rt.apply_delta(d)[sid]
            sync(dev)
            want = api.Matcher(api.Dataset.from_graph(ds.graph),
                               device=dev).count(qs["B"], **kw).count
            if out.count != want or rt.standing[sid].count != want:
                raise SystemExit(f"standing query after delta {k}: "
                                 f"{out.count} != a fresh count {want}")
            standing.append({"count": out.count, "fallback": out.fallback,
                             "ms": out.elapsed_s * 1e3})
        standing_launches = {k: v - before[k]
                             for k, v in launch_counts(bi).items()}
    return {"queries": [tag[n] for n in names],
            "bases": {tag[n]: c for n, c in bases.items()}, "deltas": len(rows),
            "identity_outcomes": fallbacks.count(False),
            "fallback_outcomes": fallbacks.count(True),
            "carried": carried,
            "final_counts": {tag[n]: c for n, c in final.items()},
            "launches": acc, "path_calls": calls,
            "standing": standing, "standing_launches": standing_launches,
            "queue_stats": dict(rt.stats)}


def drive_runtime(runtime, api, dblp, mix, mix_counts, bi, dev) -> dict:
    """The queue runtime over phase 4b's mix, drained inline and through a
    pool of POOL_WORKERS spawned workers; then a MatchService on a pool of
    POOL_WORKERS: an open loop of SERVICE_REQUESTS over the mix at half
    the inline drain's rate, a chaos drain with one worker SIGKILLed
    mid-bucket, and a drain after the respawn. Every count equals the
    sequential count (`mix_counts`), nothing fails or degrades."""
    from repro_torch.runtime import (FaultInjector, MatchQueueRuntime,
                                     MatchService, ServiceConfig,
                                     arrival_schedule, open_loop)
    res = {}
    rt = MatchQueueRuntime(dblp, engine="vector", device=dev)
    rt.submit(mix, limit=LIMIT)
    bi.reset_launches()
    t0 = time.perf_counter()
    got = list(rt.run().values())
    sync(dev)
    inline_s = time.perf_counter() - t0
    res["queue_inline"] = {"seconds": inline_s,
                           "queries_per_s": len(mix) / inline_s,
                           "launches": launch_counts(bi),
                           "stats": dict(rt.stats)}
    if got != mix_counts or rt.stats["failed"]:
        raise SystemExit(f"inline queue drain {got} != sequential "
                         f"{mix_counts}")
    require_launched("queue inline", res["queue_inline"]["launches"], None)

    def await_ready(pool):
        deadline = time.monotonic() + 300
        while pool.idle_count() < pool.size:
            if time.monotonic() > deadline:
                raise SystemExit(f"pool not ready: {pool.stats}")
            pool.poll(0.1)

    # the card's memory in use before the pool, once its workers are
    # ready (CUDA contexts) and after the drain (plus their tables and
    # caching allocators): the difference over the pool is a worker's
    used0 = device_used_bytes(dev)
    with MatchQueueRuntime(dblp, engine="vector", device=dev,
                           workers=POOL_WORKERS) as rtp:
        await_ready(rtp.pool)
        used_ready = device_used_bytes(dev)
        rtp.submit(mix, limit=LIMIT)
        t0 = time.perf_counter()
        got = list(rtp.run().values())
        pool_s = time.perf_counter() - t0
        await_ready(rtp.pool)
        used_drained = device_used_bytes(dev)
        per = {"ready": (used_ready - used0) / POOL_WORKERS,
               "after_drain": (used_drained - used0) / POOL_WORKERS}
        res["queue_pool"] = {"seconds": pool_s,
                             "device_bytes_per_worker": per,
                             "stats": dict(rtp.stats),
                             "pool": dict(rtp.pool.stats),
                             "boots": list(rtp.pool.boots),
                             "worker_launches": dict(
                                 rtp.pool.kernel_launches),
                             "compute_apps": compute_apps()}
    if got != mix_counts or rtp.stats["failed"]:
        raise SystemExit(f"pool queue drain {got} != sequential "
                         f"{mix_counts}")
    require_launched("queue pool", res["queue_pool"]["worker_launches"],
                     None)
    print("runtime queue " + json.dumps(res), flush=True)

    cfg = ServiceConfig(workers=POOL_WORKERS, bucket_size=4,
                        worker_deadline_s=120.0, retry_backoff_s=0.01)
    qps = 0.5 * res["queue_inline"]["queries_per_s"]
    with MatchService(dblp, config=cfg, device=dev,
                      options=api.MatchOptions(engine="vector",
                                               limit=LIMIT)) as svc:
        for q in mix:                       # warm both workers' caches
            svc.submit(q, limit=LIMIT, force=True)
        svc.drain()
        svc.reset_stats()
        await_ready(svc.pool)
        workload = [dict(query=mix[i % len(mix)], limit=LIMIT)
                    for i in range(SERVICE_REQUESTS)]
        schedule = arrival_schedule(SERVICE_REQUESTS, qps, seed=0)
        summary = open_loop(svc, workload, schedule)
        wrong = {rid: r.count for rid, r in svc.results.items()
                 if r.ok and r.count != mix_counts[rid % len(mix)]}
        if summary["failed"] or svc.stats["degraded"] or wrong \
                or summary["offered"] != summary["completed"] \
                + summary["shed"]:
            raise SystemExit(f"open loop {summary}, stats {svc.stats}, "
                             f"wrong counts {wrong}")
        res["open_loop"] = {"offered_qps": qps,
                            "last_arrival_s": schedule[-1], **summary,
                            "stats": dict(svc.stats)}
        print("runtime open loop " + json.dumps(res["open_loop"]),
              flush=True)
        for phase, inj in (("chaos", FaultInjector(kill_worker_at={0})),
                           ("after respawn", None)):
            svc.reset_stats()
            tickets = [svc.submit(q, limit=LIMIT, deadline_s=600.0)
                       for q in mix]
            counts = svc.drain(injector=inj)
            got = [counts[t.request_id] for t in tickets]
            if got != mix_counts or svc.stats["failed"] \
                    or svc.stats["degraded"]:
                raise SystemExit(f"service {phase}: {got} != sequential "
                                 f"{mix_counts} ({svc.stats})")
            if inj is not None and (svc.pool.stats["respawned"] < 1
                                    or svc.pool.stats["chaos_kills"] != 1):
                raise SystemExit(f"chaos drain: {svc.pool.stats}")
            await_ready(svc.pool)
            res[phase] = {"stats": dict(svc.stats),
                          "pool": dict(svc.pool.stats)}
        res["service_pool"] = {"boots": list(svc.pool.boots),
                               "worker_launches": dict(
                                   svc.pool.kernel_launches),
                               "compute_apps": compute_apps()}
    require_launched("service workers",
                     res["service_pool"]["worker_launches"], None)
    return res


def time_lane(bi, ref, sb, dev) -> dict:
    """The lane at the size-4 bucket's widest pair extend (most tables x
    padded words): its stacked tables, a tile of T = 256 rows whose query
    ids cover the bucket's queries and whose keys are random within each
    padded table; beside the lane-free call on the first query's slice of
    the same tables with the same keys, and the plain version. Warm and
    with the L2 flushed; bound by bytes."""
    prog, data = sb.program, sb.data
    stages = prog._stages
    si = max((i for i, st in enumerate(stages) if st[0] == "e" and st[3]),
             key=lambda i: (len(stages[i][3]) * prog.widths[stages[i][1]], i))
    v, bk, same = stages[si][1], stages[si][3], stages[si][6]
    tabs = [data["tables"][f"{u}:{v}"] for (_, u) in bk]
    n_cols = 2 + max([s for s, _ in bk] + list(same))
    gen = np.random.default_rng(6)
    s_min = min(t.shape[1] for t in tabs)
    cols = [gen.integers(0, sb.nq, TILE_ROWS)] + [
        gen.integers(0, s_min, TILE_ROWS) for _ in range(n_cols - 1)]
    idx = torch.from_numpy(np.stack(cols, 1).astype(np.int32)).to(dev)
    slots = [s + 1 for s, _ in bk]
    clears = [c + 1 for c in same]
    one = [t[0] for t in tabs]
    lane = lambda: bi.tile_intersect(tabs, idx, slots, clears, qid_slot=0)
    plain = lambda: ref.tile_intersect_ref(tabs, idx, slots, clears,
                                           qid_slot=0)
    nolane = lambda: bi.tile_intersect(one, idx, slots, clears)
    err = max_abs_err(lane(), plain())
    if err:
        raise SystemExit("the lane disagrees at the bucket's widest extend")
    w = tabs[0].shape[2]
    rows = sum(int(torch.unique(idx[:, 0].long() * t.shape[1]
                                + idx[:, s].long()).numel())
               for t, s in zip(tabs, slots))
    nbytes = (TILE_ROWS * (1 + len(set(slots)) + len(set(clears))) * 4
              + rows * w * 4 + TILE_ROWS * w * 4 + TILE_ROWS * 4)
    flush = torch.empty(100 * 2 ** 20, dtype=torch.int8, device=dev)
    out = {"stage": si, "k": len(tabs), "W": w, "Q": tabs[0].shape[0],
           "S": [t.shape[1] for t in tabs], "T": TILE_ROWS,
           "ms": median_ms(lane), "flushed_ms": flushed_ms(lane, flush),
           "no_lane_ms": median_ms(nolane),
           "no_lane_flushed_ms": flushed_ms(nolane, flush),
           "plain_ms": median_ms(plain), "bytes": nbytes,
           "bound_ms": nbytes / hw()["hbm_bw"] * 1e3, "max_abs_err": err}
    return out


def build_all(build, names) -> dict:
    """Build every kernel library at once, one nvcc per source. Returns
    {name: (library path, seconds)}."""
    def one(name):
        t0 = time.perf_counter()
        lib = build.build_library(name)
        return lib, time.perf_counter() - t0

    with ThreadPoolExecutor(len(names)) as ex:
        futures = {name: ex.submit(one, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


def ptxas_report(build, name) -> list:
    """Compile `csrc/<name>.cu` once more with `-Xptxas -v` (into a
    temporary file; the built library keeps build.NVCC_FLAGS) and return
    one line per kernel: registers, spill stores/loads, static shared
    memory."""
    import re
    import tempfile
    build.build_dir().mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.build_dir()) as tmp:
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(Path(tmp) / "ptxas.so"), str(build.CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc -Xptxas -v failed:\n{proc.stderr}")
    text = proc.stdout + proc.stderr
    # per entry: "Compiling entry function '<name>'", then its spill line,
    # then "Used N registers[, M bytes smem]"
    kernels, cur = [], None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            cur = {"name": m.group(1), "spill": None, "regs": None,
                   "smem": "0"}
            kernels.append(cur)
        elif cur and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                     r"bytes spill loads", line)):
            cur["spill"] = m.groups()
        elif cur and (m := re.search(r"Used (\d+) registers", line)):
            cur["regs"] = m.group(1)
            if sm := re.search(r"(\d+) bytes smem", line):
                cur["smem"] = sm.group(1)
    if not kernels or any(k["spill"] is None or k["regs"] is None
                          for k in kernels):
        raise SystemExit(f"could not read ptxas -v:\n{text[-3000:]}")
    names = [k["name"] for k in kernels]
    filt = Path(build._nvcc()).with_name("cu++filt")
    if filt.exists():
        names = subprocess.run([str(filt)], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    # "void <unnamed>::f<(int)128>(args)" -> "f<128>"
    names = [re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::"
                    r"|\((int|bool)\)", "", n).split("(")[0] for n in names]
    return [f"{name}: {k['regs']} registers, spill stores {k['spill'][0]} "
            f"B, spill loads {k['spill'][1]} B, static smem {k['smem']} B"
            for name, k in zip(names, kernels)]


def fd_agrees(got, want, where: str) -> float:
    """flash_decode's output against its plain version's within FD_TOL for
    the output dtype, finite, and on rows that a zero output would fail.
    Returns the largest absolute difference; raises SystemExit otherwise."""
    atol, rtol = FD_TOL[want.dtype]
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if want.numel() else 0.0
    if not (bool(torch.isfinite(got).all())
            and torch.allclose(got, want, atol=atol, rtol=rtol)):
        raise SystemExit(f"flash_decode disagrees: {where} "
                         f"max_abs_err={err}")
    zero_passes = (want.abs() <= atol + rtol * want.abs()).all(-1)
    if bool(zero_passes.any()):
        raise SystemExit(f"flash_decode: {where}: {int(zero_passes.sum())} "
                         "rows are so small that a zero row would pass")
    return err


def held_attention(kops, ref, run) -> dict:
    """Runs `run()` with every kernel call of `kops.decode_attention` held
    against the plain version on that call's own inputs (shapes, dtypes,
    lengths and cache contents of the path). Returns the number of calls
    held, their (q, cache) dtypes and the largest difference."""
    orig = kops.decode_attention
    held = {"calls": 0, "dtypes": set(), "max_abs_err": 0.0}

    def checked(q, k, v, lengths=None, *, use_kernel=True):
        out = orig(q, k, v, lengths, use_kernel=use_kernel)
        if use_kernel:
            where = (f"call {held['calls']} q {tuple(q.shape)} {q.dtype} "
                     f"cache {tuple(k.shape)} {k.dtype}")
            err = fd_agrees(out, ref.flash_decode_ref(q, k, v, lengths),
                            where)
            held["calls"] += 1
            held["dtypes"].add((str(q.dtype).removeprefix("torch."),
                                str(k.dtype).removeprefix("torch.")))
            held["max_abs_err"] = max(held["max_abs_err"], err)
        return out

    kops.decode_attention = checked
    try:
        run()
    finally:
        kops.decode_attention = orig
    held["dtypes"] = sorted(held["dtypes"])
    return held


def flash_decode_inputs(gen, rng, shape, q_dtype, kv_dtype, dev,
                        lens=None):
    """Seeded q, k, v on the card and the given lengths, or ragged lengths
    in [1, S] that hold 1 and S when B > 1."""
    b, h, hkv, s, d = shape
    q = torch.randn((b, h, d), generator=gen, device=dev).to(q_dtype)
    k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(kv_dtype)
    v = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(kv_dtype)
    if lens is None:
        lens = rng.integers(1, s + 1, b)
        if b > 1:
            lens[:2] = (1, s)
    return q, k, v, torch.from_numpy(np.asarray(lens, np.int32)).to(dev)


def check_flash_decode(fd, ref, dev) -> tuple[dict, int]:
    """flash_decode against its plain version over the CPU tests' shapes
    plus D = 128, G = 8 and G = 32, S = 32,768 at D = 128, D = 18 and 40
    (rows not 16-byte aligned, bf16 D not a multiple of 16) and D = 256,
    phase 5c's three decode_32k layer shapes,
    in all four dtype pairs, with ragged lengths and with none; and at S = 32,768 with
    lengths at the boundaries of the chunk that split_plan picks. Returns
    the largest absolute difference per output dtype and the number of
    comparisons."""
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    shapes = [(b, h, hkv, s, d) for b in (1, 3)
              for h, hkv in ((4, 2), (12, 2), (4, 4), (16, 2), (32, 1))
              for s in (1, 17, 128, 200) for d in (16, 64, 128)]
    shapes += [(4, 12, 2, 24, 128), (3, 12, 2, 32_768, 128)]
    # rows not 16-byte aligned (D = 18), a bfloat16 D that is not a
    # multiple of 16 (40), and the largest D over a few chunks
    shapes += [(3, 12, 2, 200, 18), (3, 12, 2, 200, 40),
               (2, 12, 2, 3_000, 256)]
    # phase 5c's decode_32k layers: chatglm3-6b (group 16), qwen3-moe
    # (group 8) and granite-moe (group 3 at D = 64)
    shapes += [(32, 32, 2, 32_768, 128), (32, 32, 4, 32_768, 128),
               (8, 24, 8, 32_768, 64)]
    edge_shape = (4, 12, 2, 32_768, 128)
    chunk = fd.split_plan(*edge_shape)[0]
    cases = [(shape, None) for shape in shapes]
    cases.append((edge_shape, [chunk - 1, chunk, chunk + 1, 2 * chunk]))
    errs = {str(t).removeprefix("torch."): 0.0 for t in FD_DTYPES}
    n = 0
    for shape, edges in cases:
        for q_dtype in FD_DTYPES:
            for kv_dtype in FD_DTYPES:
                q, k, v, lengths = flash_decode_inputs(
                    gen, rng, shape, q_dtype, kv_dtype, dev, edges)
                for lens in ((lengths, None) if edges is None
                             else (lengths,)):
                    err = fd_agrees(
                        fd.flash_decode(q, k, v, lens),
                        ref.flash_decode_ref(q, k, v, lens),
                        f"shape {shape} q {q_dtype} cache {kv_dtype} "
                        f"lengths {lens.tolist() if lens is not None else None}")
                    key = str(q_dtype).removeprefix("torch.")
                    errs[key] = max(errs[key], err)
                    n += 1
    return errs, n


def check_lm_reduced(build_bundle, dev) -> float:
    """The reduced qwen2-1.5b's four float32 decode steps on the card
    against the same steps on the CPU: same weights, same random cache,
    ragged lengths from make_inputs. Returns the largest logit
    difference."""
    cpu = build_bundle(LM_ARCH, reduced=True, device="cpu")
    card = build_bundle(LM_ARCH, reduced=True, device=dev)
    m_cpu = cpu.init_fn(0)
    m_card = card.init_fn(1)
    m_card.load_state_dict(m_cpu.state_dict())
    inputs = cpu.make_inputs(DECODE_SHAPE, seed=0)
    b = inputs["token"].shape[0]
    c_cpu = cpu.init_caches(b, 128 + 4, dtype=torch.float32)
    gen = torch.Generator().manual_seed(2)
    for t in c_cpu.values():
        t.normal_(generator=gen)
    c_card = {n: t.to(dev) for n, t in c_cpu.items()}
    token, lengths = inputs["token"], inputs["lengths"]
    worst = 0.0
    for i in range(4):
        want, c_cpu = cpu.steps["decode"](
            m_cpu, c_cpu, {"token": token, "lengths": lengths},
            dtype=torch.float32)
        got, c_card = card.steps["decode"](
            m_card, c_card, {"token": token.to(dev),
                             "lengths": lengths.to(dev)},
            dtype=torch.float32)
        got = got.cpu()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        if err > LM_F32_ATOL or not torch.equal(got.argmax(-1),
                                                want.argmax(-1)):
            raise SystemExit(f"reduced LM step {i}: card and CPU differ "
                             f"(max_abs_err={err})")
        token, lengths = want.argmax(-1).to(torch.int32), lengths + 1
    return worst


def drive_serve(serve, bi, fd, kops, ref, bundle, model) -> dict:
    """The LM main path: `decode_loop` at full width, batch 4 x 16 tokens,
    float32 cache. A first loop holds each of its attention calls against
    the plain version (and warms up); the second runs with the launch
    counts set to 0 just before and read just after."""
    want = bundle.cfg.n_layers * SERVE_TOKENS
    held = held_attention(kops, ref, lambda: serve.decode_loop(
        bundle, model, batch=SERVE_BATCH, tokens=SERVE_TOKENS))
    if held["calls"] != want:
        raise SystemExit(f"serve loop held {held['calls']} attention calls, "
                         f"expected {want}")
    print(f"serve loop: {held['calls']} flash_decode calls agree with the "
          f"plain version on their own inputs, (q, cache) dtypes "
          f"{held['dtypes']}, max_abs_err {held['max_abs_err']:.3g}",
          flush=True)
    bi.reset_launches()
    fd.reset_launches()
    res = serve.decode_loop(bundle, model, batch=SERVE_BATCH,
                            tokens=SERVE_TOKENS)
    launches = fd.flash_decode.launches
    by_route = dict(fd.flash_decode.launches_by_route)
    by_kernel = dict(fd.flash_decode.launches_by_kernel)
    if launches != want:
        raise SystemExit(f"serve loop launched flash_decode {launches} "
                         f"times, expected {want}")
    if by_route != {"tensor_core": 0, "cuda_core": want}:
        raise SystemExit(f"serve loop's flash_decode routes {by_route}, "
                         f"expected all {want} on cuda_core")
    # a 24-position cache is one chunk: the split kernel writes out itself
    if by_kernel != {"split": want, "combine": 0}:
        raise SystemExit(f"serve loop's flash_decode device kernels "
                         f"{by_kernel}, expected {want} split, no combine")
    toks = res["tokens"]
    if toks.shape != (SERVE_TOKENS, SERVE_BATCH) or toks.min() < 0 \
            or toks.max() >= bundle.cfg.vocab:
        raise SystemExit(f"serve loop gave tokens {toks}")
    return {"batch": SERVE_BATCH, "tokens": SERVE_TOKENS,
            "seconds": res["seconds"], "ms_per_step": res["ms_per_step"],
            "tokens_per_s": res["tokens_per_s"], "launches": launches,
            "launches_by_route": by_route, "launches_by_kernel": by_kernel,
            "held_max_abs_err": held["max_abs_err"],
            "bitmap_launches": sum(fn.launches for fn in bi.WRAPPERS),
            "sample": toks[:, 0].tolist()}


def drive_decode_32k(bi, fd, kops, ref, bundle, model, dev,
                     seq: int) -> dict:
    """decode_32k at batch 32: a bfloat16 cache of 32,768 positions (plus
    room for the steps' new tokens) filled with seeded random values,
    lengths from make_inputs(seed=0); DECODE_STEPS greedy steps with the
    launch counts set to 0 just before and read just after; then one more
    step with the kernel (each attention call held against the plain
    version) and the same step with the plain attention, in bfloat16 and
    in float32 activations."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    inputs = bundle.make_inputs(DECODE_SHAPE, seed=0, batch=DECODE_BATCH)
    caches = bundle.init_caches(DECODE_BATCH, seq + DECODE_STEPS + 1,
                                dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(1)
    for t in caches.values():
        t.normal_(generator=gen)
    step = bundle.steps["decode"]
    token, lengths = inputs["token"], inputs["lengths"]
    torch.cuda.synchronize()
    bi.reset_launches()
    fd.reset_launches()
    step_ms = []
    for _ in range(DECODE_STEPS):
        t0 = time.perf_counter()
        logits, caches = step(model, caches,
                              {"token": token, "lengths": lengths})
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        lengths = lengths + 1
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = fd.flash_decode.launches
    by_route = dict(fd.flash_decode.launches_by_route)
    by_kernel = dict(fd.flash_decode.launches_by_kernel)
    want = bundle.cfg.n_layers * DECODE_STEPS
    if launches != want:
        raise SystemExit(f"decode_32k launched flash_decode {launches} "
                         f"times, expected {want}")
    if by_route != {"tensor_core": want, "cuda_core": 0}:
        raise SystemExit(f"decode_32k's flash_decode routes {by_route}, "
                         f"expected all {want} on tensor_core")
    # a 32,772-position cache splits: each call merges its chunks
    if by_kernel != {"split": want, "combine": want}:
        raise SystemExit(f"decode_32k's flash_decode device kernels "
                         f"{by_kernel}, expected {want} split and {want} "
                         f"combine")
    if not bool(torch.isfinite(logits).all()):
        raise SystemExit("decode_32k logits are not finite")
    batch = {"token": token, "lengths": lengths}
    logits = {}

    def kernel_bf16():
        logits["bfloat16", "kernel"] = step(model, caches, batch)[0]
    held = held_attention(kops, ref, kernel_bf16)
    if held["calls"] != bundle.cfg.n_layers:
        raise SystemExit(f"decode_32k step held {held['calls']} attention "
                         f"calls, expected {bundle.cfg.n_layers}")
    print(f"decode_32k step: {held['calls']} flash_decode calls agree with "
          f"the plain version on their own inputs, (q, cache) dtypes "
          f"{held['dtypes']}, max_abs_err {held['max_abs_err']:.3g}",
          flush=True)
    logits["bfloat16", "plain"] = step(model, caches, batch,
                                       use_kernel=False)[0]
    for use_kernel, name in ((True, "kernel"), (False, "plain")):
        logits["float32", name] = step(model, caches, batch,
                                       dtype=torch.float32,
                                       use_kernel=use_kernel)[0]
    logits = {k: v.float() for k, v in logits.items()}
    f32 = logits["float32", "plain"]

    def rms(a):
        return float(a.pow(2).mean().sqrt())
    diff = {"attention_held": held}
    for key in ("bfloat16", "float32"):
        got, plain = logits[key, "kernel"], logits[key, "plain"]
        diff[key] = {
            "logits_max_abs_err": float((got - plain).abs().max()),
            "logits_max_abs": float(plain.abs().max()),
            "logits_std": float(plain.std()),
            "greedy_agreement": float((got.argmax(-1)
                                       == plain.argmax(-1)).float().mean()),
            "kernel_rms_vs_float32_plain": rms(got - f32),
            "plain_rms_vs_float32_plain": rms(plain - f32)}
    b16 = diff["bfloat16"]
    ratio = (b16["kernel_rms_vs_float32_plain"]
             / b16["plain_rms_vs_float32_plain"])
    b16["rms_ratio"] = ratio
    print(f"decode_32k step, kernel vs plain attention: {diff}", flush=True)
    err = diff["float32"]["logits_max_abs_err"]
    if not err <= LM_32K_F32_ATOL:
        raise SystemExit(f"decode_32k float32 step: kernel and plain "
                         f"attention differ (max_abs_err={err})")
    if not (bool(torch.isfinite(logits["bfloat16", "kernel"]).all())
            and ratio <= LM_32K_BF16_RATIO):
        raise SystemExit(f"decode_32k bfloat16 step: the kernel's logits are "
                         f"{ratio:.3g}x as far from the float32 step as the "
                         f"plain attention's (limit {LM_32K_BF16_RATIO})")
    return {"batch": DECODE_BATCH, "cache_positions": seq + DECODE_STEPS + 1,
            "steps": DECODE_STEPS, "step_ms": step_ms,
            "ms_per_step": float(np.median(step_ms)),
            "tokens_per_s": DECODE_BATCH / (np.median(step_ms) / 1e3),
            "launches": launches, "launches_by_route": by_route,
            "launches_by_kernel": by_kernel, "vs_plain": diff,
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "caches": caches, "lengths": lengths + 1,
            "n_heads": bundle.cfg.n_heads}


def time_fd_shape(fd, ref, dev, k, v, lens, h: int, where: str) -> dict:
    """flash_decode on one layer's bfloat16 cache (k, v) at the lengths a
    decode step attended over, with a seeded bfloat16 q of h heads: held
    against the plain version, then timed beside it and beside
    scaled_dot_product_attention with a length mask; the bound from the
    bytes these lengths need (each attended K/V row read once) and the
    operations, and the share of the bound."""
    import torch.nn.functional as F
    b, s, hkv, d = k.shape
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    want = ref.flash_decode_ref(q, k, v, lens)
    err = fd_agrees(fd.flash_decode(q, k, v, lens), want, where)
    ms = median_ms(lambda: fd.flash_decode(q, k, v, lens))
    plain_ms = median_ms(lambda: ref.flash_decode_ref(q, k, v, lens))
    # the library yardstick: (B, H, 1, D) over (B, Hkv, S, D) views
    mask = (torch.arange(s, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]
    qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              enable_gqa=True)
    lib_err = float((sdpa()[:, :, 0].float() - want.float()).abs().max())
    library_ms = median_ms(sdpa)
    total_len = int(lens.sum())
    nbytes = (total_len * hkv * d * 2 * k.element_size()
              + 2 * q.numel() * q.element_size() + lens.numel() * 4)
    flops = 4 * total_len * h * d
    t_bytes, t_ops = nbytes / hw()["hbm_bw"], flops / hw()["flops_f32"]
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    bytes_per_s = nbytes / (ms / 1e3)
    chunk, n_chunks, _ = fd.split_plan(b, h, hkv, s, d)
    kernel_route = fd.route(q, k, v)
    print(f"time flash_decode ({where}): B={b} H={h} Hkv={hkv} D={d} "
          f"S={s} sum(lengths)={total_len} route={kernel_route} "
          f"chunk={chunk} n_chunks={n_chunks} ms={ms:.6f} "
          f"plain_ms={plain_ms:.6f} sdpa_ms={library_ms:.6f} (max_abs_err "
          f"{lib_err:.3g}) bound_ms={bound_ms:.6f} ({bound_by}: {nbytes} B, "
          f"{flops} flop) achieved {bytes_per_s / 1e12:.4f} TB/s, "
          f"{bound_ms / ms:.4f} of the bound", flush=True)
    return {"kernel_route": kernel_route, "chunk": chunk,
            "n_chunks": n_chunks, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "bytes_per_s": bytes_per_s, "bound_share": bound_ms / ms,
            "library_max_abs_err": lib_err,
            "shape": {"B": b, "H": h, "Hkv": hkv, "D": d, "S": s,
                      "sum_lengths": total_len, "q": "bfloat16",
                      "cache": "bfloat16"}}


def time_flash_decode(fd, ref, dev, d32k, launches, errs) -> dict:
    """The kernels line's flash_decode row, timed at one layer of
    qwen2-1.5b's decode_32k: layer 0's bfloat16 cache, bfloat16 q, the
    lengths the last step attended over (`time_fd_shape`)."""
    t = time_fd_shape(fd, ref, dev, d32k["caches"]["k"][0],
                      d32k["caches"]["v"][0], d32k["lengths"],
                      d32k["n_heads"], f"{LM_ARCH} decode_32k")
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:100",
            "launches": launches["serve"]["calls"],
            "launches_by_path": launches,
            **{k: t[k] for k in ("kernel_route", "chunk", "n_chunks")},
            "max_abs_err": max(max(errs.values()), t["max_abs_err"]),
            "max_abs_err_by_case": errs,
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "bytes_per_s",
                                 "bound_share")},
            "library": "scaled_dot_product_attention(enable_gqa=True, "
                       "attn_mask=length mask)",
            "library_max_abs_err": t["library_max_abs_err"],
            "shape": t["shape"]}


def kernel_times_ms(fn, names, *, calls: int = 20) -> dict:
    """Device time a call of the CUDA kernels that `fn` launches, by name:
    {name: ms}, a kernel counted under each name its own name contains,
    from torch.profiler's device times over `calls` warm calls. A name
    that no kernel matched, or a trace with no device time, gives None."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names)
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        for name in names:
            if name in ev.key and us:
                out[name] = (out[name] or 0.0) + us / 1e3 / calls
    return out


def time_fd_parts(fd, dev, k, v, lens, h: int) -> dict:
    """One flash_decode call at one layer's cache with its two device
    kernels timed apart: the split and the combine from the profiler's
    device times, and the combine alone with CUDA events through
    `flash_decode_merge` (the same combine kernel, grid and chunk count)
    over a workspace-shaped input."""
    b, s, hkv, d = k.shape
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    chunk, n_chunks, _ = fd.split_plan(b, h, hkv, s, d)
    by_kernel = kernel_times_ms(lambda: fd.flash_decode(q, k, v, lens),
                                ("split_", "combine_kernel"))
    ws = torch.randn((b, h, n_chunks, d + 2), generator=gen, device=dev)
    ws[..., -1].abs_()
    combine_ms = median_ms(lambda: fd.flash_decode_merge(ws, q.dtype))
    return {"split_ms": by_kernel["split_"],
            "combine_ms": by_kernel["combine_kernel"],
            "combine_events_ms": combine_ms, "chunk": chunk,
            "n_chunks": n_chunks, "combine_ctas": b * h}


def partials_agree(got, want, where: str) -> float:
    """flash_decode_partials' rows against the plain version's: the same
    empty rows, each exactly (0, -inf, 0); elsewhere m within
    PARTIALS_M_ATOL, and acc and l each within PARTIALS_RTOL of its
    largest magnitude. Returns the largest absolute difference over the
    non-empty rows; raises SystemExit otherwise."""
    empty = torch.isinf(want[..., -2])
    if not torch.equal(torch.isinf(got[..., -2]), empty) \
            or not torch.equal(got[empty], want[empty]):
        raise SystemExit(f"flash_decode_partials: {where}: empty rows "
                         f"differ from the plain version's (0, -inf, 0)")
    if bool(empty.all()):
        return 0.0
    g, w = got[~empty], want[~empty]
    m_err = float((g[:, -2] - w[:, -2]).abs().max())

    def rel(i):     # of the largest magnitude; exact where that is 0
        diff, scale = (float((g[:, i] - w[:, i]).abs().max()),
                       float(w[:, i].abs().max()))
        return diff / scale if scale > 0 else (0.0 if diff == 0
                                               else float("inf"))
    rel = max(rel(slice(0, -2)), rel(-1))
    if not (bool(torch.isfinite(g).all()) and m_err <= PARTIALS_M_ATOL
            and rel <= PARTIALS_RTOL):
        raise SystemExit(f"flash_decode_partials disagrees: {where}: m "
                         f"{m_err:.3g}, acc and l relative {rel:.3g}")
    return float((g - w).abs().max())


def check_long_sharded(fd, cp, mesh_mod, ref, dev, k, v, h: int,
                       seq: int) -> dict:
    """sharded_decode_attention on one layer's long_500k cache over
    LONG_LANES lanes of the card at two lengths, the cell's whole context
    `seq` and LONG_SHORT_LENGTH (inside the first lane's block, so the
    later lanes' blocks are empty), each held against flash_decode on the
    whole cache and against the plain version, with the launch counts set
    to 0 just before and read just after; then over distinct cards where
    more than one is visible."""
    b, s, hkv, d = k.shape
    gen = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    cases = {"whole": seq, "short": LONG_SHORT_LENGTH}
    lens = {name: torch.full((b,), n, dtype=torch.int32, device=dev)
            for name, n in cases.items()}
    want = {name: fd.flash_decode(q, k, v, L) for name, L in lens.items()}
    plain = {name: ref.flash_decode_ref(q, k, v, L)
             for name, L in lens.items()}
    torch.cuda.synchronize()
    fd.reset_launches()
    got = {(n, name): cp.sharded_decode_attention(
        q, k, v, L, mesh_mod.EnumMesh((dev,) * n))
        for n in LONG_LANES for name, L in lens.items()}
    torch.cuda.synchronize()
    launches = {
        "flash_decode_partials": {
            "calls": fd.flash_decode_partials.launches,
            "by_route": dict(fd.flash_decode_partials.launches_by_route),
            "by_kernel": dict(fd.flash_decode_partials.launches_by_kernel)},
        "flash_decode_merge": {
            "calls": fd.flash_decode_merge.launches,
            "by_kernel": dict(fd.flash_decode_merge.launches_by_kernel)}}
    n_part = sum(LONG_LANES) * len(cases)
    n_merge = len(LONG_LANES) * len(cases)
    if launches["flash_decode_partials"] != {
            "calls": n_part, "by_route": {"tensor_core": n_part,
                                          "cuda_core": 0},
            "by_kernel": {"split": n_part, "combine": n_part}} \
            or launches["flash_decode_merge"] != {
                "calls": n_merge,
                "by_kernel": {"split": 0, "combine": n_merge}}:
        raise SystemExit(f"sharded long_500k launches {launches}, expected "
                         f"{n_part} partials (each a split and a combine, "
                         f"tensor_core) and {n_merge} merges")
    errs = {}
    for (n, name), out in got.items():
        where = f"sharded over {n} lane(s) at length {cases[name]}"
        errs[f"{n} lanes {name}"] = max(
            fd_agrees(out, want[name], where + " vs flash_decode"),
            fd_agrees(out, plain[name], where + " vs the plain version"))
    cards = torch.cuda.device_count()
    distinct = {}
    for n in LONG_LANES:
        if n < 2 or n > cards:
            continue
        devs = [torch.device("cuda", i) for i in range(n)]
        spans = cp.lane_blocks(s, n)
        kb = [k[:, o:o + m].to(dv) for (o, m), dv in zip(spans, devs)]
        vb = [v[:, o:o + m].to(dv) for (o, m), dv in zip(spans, devs)]
        for name, L in lens.items():
            out = cp.sharded_decode_attention(q, kb, vb, L,
                                              mesh_mod.EnumMesh(devs))
            distinct[f"{n} cards {name}"] = fd_agrees(
                out, want[name], f"sharded over {n} cards at length "
                f"{cases[name]}")
        del kb, vb
    if not distinct:
        print(f"sharded long_500k over distinct cards: not run ({cards} "
              f"card visible)", flush=True)
    return {"lanes": list(LONG_LANES), "lengths": cases,
            "max_abs_err": errs, "distinct_cards": distinct or None,
            "launches": launches}


def time_long_partials(fd, cp, ref, dev, k, v, h: int, seq: int,
                       launches: dict) -> list:
    """The kernels line's rows of flash_decode_partials and
    flash_decode_merge at the sharded check's widest lane: the first
    block of a LONG_LANES[-1]-lane split of one long_500k layer (every
    position counted at the whole context) and the merge of that split's
    rows into a bfloat16 output. Each held against its plain version on
    the same inputs (with an empty block, whose row must be exactly
    (0, -inf, 0)), then timed beside it; bounds from the bytes and
    operations of these inputs."""
    b, s, hkv, d = k.shape
    lanes = LONG_LANES[-1]
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    lens = torch.full((b,), seq, dtype=torch.int32, device=dev)
    spans = cp.lane_blocks(s, lanes)
    blocks = [(k[:, o:o + m], v[:, o:o + m], o) for o, m in spans]
    parts = [fd.flash_decode_partials(q, kb, vb, lens, o)
             for kb, vb, o in blocks]
    err = max(partials_agree(
        p, ref.flash_decode_partials_ref(q, kb, vb, lens, o),
        f"lane {i} of {lanes} at length {seq}")
        for i, (p, (kb, vb, o)) in enumerate(zip(parts, blocks)))
    short = torch.full((b,), LONG_SHORT_LENGTH, dtype=torch.int32,
                       device=dev)
    kb, vb, o = blocks[1]
    partials_agree(fd.flash_decode_partials(q, kb, vb, short, o),
                   ref.flash_decode_partials_ref(q, kb, vb, short, o),
                   f"an empty block at length {LONG_SHORT_LENGTH}")
    kb, vb, o = blocks[0]
    part_ms = median_ms(lambda: fd.flash_decode_partials(q, kb, vb, lens, o))
    part_plain_ms = median_ms(
        lambda: ref.flash_decode_partials_ref(q, kb, vb, lens, o))
    n_pos = int((lens.long() - o).clamp(0, kb.shape[1]).sum())
    nbytes = (n_pos * hkv * d * 2 * k.element_size()
              + q.numel() * q.element_size() + lens.numel() * 4
              + b * h * (d + 2) * 4)
    flops = 4 * n_pos * h * d
    t_bytes, t_ops = nbytes / hw()["hbm_bw"], flops / hw()["flops_f32"]
    chunk, n_chunks, _ = fd.split_plan(b, h, hkv, kb.shape[1], d)
    stacked = torch.stack(parts, dim=2).contiguous()
    merged = fd.flash_decode_merge(stacked, torch.bfloat16)
    merge_err = fd_agrees(merged, ref.flash_decode_merge_ref(
        stacked, torch.bfloat16), f"merge of {lanes} lanes' rows")
    merge_ms = median_ms(lambda: fd.flash_decode_merge(stacked,
                                                       torch.bfloat16))
    merge_plain_ms = median_ms(
        lambda: ref.flash_decode_merge_ref(stacked, torch.bfloat16))
    m_bytes = stacked.numel() * 4 + merged.numel() * merged.element_size()
    m_flops = 2 * lanes * (d + 1) * b * h
    m_bytes_s, m_ops_s = m_bytes / hw()["hbm_bw"], m_flops / hw()["flops_f32"]
    common = {"route": "cuda",
              "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
              "replaces": "src/repro/kernels/flash_decode.py:100",
              "library_ms": None, "library": None}
    rows = [
        {"name": "flash_decode_partials", **common,
         "launches": launches["flash_decode_partials"]["calls"],
         "launches_by_path": {f"{LM_ARCH} {LONG_SHAPE} sharded":
                              launches["flash_decode_partials"]},
         "max_abs_err": err, "ms": part_ms, "plain_ms": part_plain_ms,
         "bound_ms": max(t_bytes, t_ops) * 1e3,
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "bound_share": max(t_bytes, t_ops) * 1e3 / part_ms,
         "kernel_route": fd.route(q, kb, vb), "chunk": chunk,
         "n_chunks": n_chunks,
         "shape": {"B": b, "H": h, "Hkv": hkv, "D": d, "S": kb.shape[1],
                   "offset": o, "positions_counted": n_pos,
                   "q": "bfloat16", "cache": "bfloat16"}},
        {"name": "flash_decode_merge", **common,
         "launches": launches["flash_decode_merge"]["calls"],
         "launches_by_path": {f"{LM_ARCH} {LONG_SHAPE} sharded":
                              launches["flash_decode_merge"]},
         "max_abs_err": merge_err, "ms": merge_ms,
         "plain_ms": merge_plain_ms,
         "bound_ms": max(m_bytes_s, m_ops_s) * 1e3,
         "bound_by": "bytes" if m_bytes_s >= m_ops_s else "operations",
         "bound_share": max(m_bytes_s, m_ops_s) * 1e3 / merge_ms,
         "shape": {"B": b, "H": h, "n": lanes, "D": d, "out": "bfloat16"}}]
    for r in rows:
        print(f"time {r['name']} ({LM_ARCH} {LONG_SHAPE}, {lanes} lanes): "
              + json.dumps(r), flush=True)
    return rows


def check_long_cp(attn_mod, transformer, model, dev) -> dict:
    """cp_attention at full width: a LONG_CP_TOKENS-token prefill at batch
    1 with cp_degree LONG_CP_DEGREE against cp_degree 0 (flash_attention)
    on the same model, float32 activations; the last logits within
    LM_32K_F32_ATOL, cp_attention run in every layer."""
    cfg = model.cfg
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, LONG_CP_TOKENS)).astype(np.int32)).to(dev)
    calls = {"n": 0}
    orig = attn_mod.cp_attention

    def counted(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)
    logits, wall = {}, {}
    attn_mod.cp_attention = counted
    try:
        for cp_degree in (0, LONG_CP_DEGREE):
            model.cfg = dataclasses.replace(cfg, cp_degree=cp_degree)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits[cp_degree] = transformer.lm_prefill_logits(
                model, tokens, dtype=torch.float32).float()
            torch.cuda.synchronize()
            wall[cp_degree] = time.perf_counter() - t0
    finally:
        model.cfg = cfg
        attn_mod.cp_attention = orig
    got, want = logits[LONG_CP_DEGREE], logits[0]
    err = float((got - want).abs().max())
    if calls["n"] != cfg.n_layers or not bool(torch.isfinite(got).all()) \
            or not err <= LM_32K_F32_ATOL:
        raise SystemExit(f"cp_attention prefill: {calls['n']} calls (want "
                         f"{cfg.n_layers}), max_abs_err {err} against "
                         f"cp_degree 0 (limit {LM_32K_F32_ATOL})")
    return {"tokens": LONG_CP_TOKENS, "cp_degree": LONG_CP_DEGREE,
            "cp_attention_calls": calls["n"], "logits_max_abs_err": err,
            "logits_max_abs": float(want.abs().max()),
            "greedy_agreement": bool(torch.equal(got.argmax(-1),
                                                 want.argmax(-1))),
            "wall_s": {"cp_degree_0": wall[0],
                       f"cp_degree_{LONG_CP_DEGREE}": wall[LONG_CP_DEGREE]}}


def run_long_500k(bi, fd, kops, ref, bundle, model, dev, card: str) -> dict:
    """The long-context phase (after decode_32k's cache is freed, on the
    same bfloat16 qwen2-1.5b): LONG_STEPS greedy long_500k steps at batch 1
    over a seeded bfloat16 cache of 524,288 + LONG_STEPS + 1 positions,
    lengths set to 524,288 (not drawn by make_inputs), the launch counts
    set to 0 just before and read just after; one further step with each
    attention call held against the plain version (`held_attention`, the
    decode_32k check); the step's FLOPs (`count_flops` over the same step
    with the plain attention), its HBM floor (`hbm_floor_bytes` on a
    one-card MeshShape) and its share of the roofline bound; one layer's
    flash_decode timed beside its bound and SDPA, split and combine apart;
    sharded_decode_attention over lanes of the card; cp_attention in a
    prefill."""
    from repro_torch.config import LM_SHAPES
    from repro_torch.distributed import context_parallel as cp
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.hbm_model import hbm_floor_bytes
    from repro_torch.launch.roofline import count_flops, roofline_terms
    from repro_torch.nn import attention as attn_mod
    from repro_torch.nn import transformer
    t_phase = time.perf_counter()
    cfg = bundle.cfg
    spec = LM_SHAPES[LONG_SHAPE]
    seq, batch = spec["seq_len"], spec["global_batch"]
    reset_peak(dev)
    t0 = time.perf_counter()
    caches = bundle.init_caches(batch, seq + LONG_STEPS + 1,
                                dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(1)
    for t in caches.values():
        t.normal_(generator=gen)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    token = bundle.make_inputs(LONG_SHAPE, seed=0, batch=batch)["token"]
    lengths = torch.full((batch,), seq, dtype=torch.int32, device=dev)
    step = bundle.steps["decode"]
    torch.cuda.synchronize()
    bi.reset_launches()
    fd.reset_launches()
    step_ms = []
    for _ in range(LONG_STEPS):
        t0 = time.perf_counter()
        logits, caches = step(model, caches,
                              {"token": token, "lengths": lengths})
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        lengths = lengths + 1
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = {"calls": fd.flash_decode.launches,
              "by_route": dict(fd.flash_decode.launches_by_route),
              "by_kernel": dict(fd.flash_decode.launches_by_kernel)}
    want = cfg.n_layers * LONG_STEPS
    if counts != {"calls": want,
                  "by_route": {"tensor_core": want, "cuda_core": 0},
                  "by_kernel": {"split": want, "combine": want}} \
            or fd.flash_decode_partials.launches \
            or fd.flash_decode_merge.launches \
            or sum(fn.launches for fn in bi.WRAPPERS):
        raise SystemExit(f"long_500k launches {counts}, expected {want} "
                         f"flash_decode calls on tensor_core, each a split "
                         f"and a combine, and no other kernel")
    if not bool(torch.isfinite(logits).all()):
        raise SystemExit("long_500k logits are not finite")
    held_batch = {"token": token, "lengths": lengths}
    held = held_attention(kops, ref,
                          lambda: step(model, caches, held_batch))
    if held["calls"] != cfg.n_layers:
        raise SystemExit(f"long_500k step held {held['calls']} attention "
                         f"calls, expected {cfg.n_layers}")
    print(f"{LONG_SHAPE} step: {held['calls']} flash_decode calls agree "
          f"with the plain version on their own inputs, (q, cache) dtypes "
          f"{held['dtypes']}, max_abs_err {held['max_abs_err']:.3g}",
          flush=True)
    # the same step once more with the plain attention, its operators
    # counted (it rewrites the row the held step wrote, at that position)
    _, flops = count_flops(lambda: step(model, caches, held_batch,
                                        use_kernel=False))
    floor = hbm_floor_bytes(bundle, LONG_SHAPE,
                            mesh_mod.MeshShape(("data", "model"), (1, 1)))
    terms = roofline_terms(flops, floor, 1)
    ms = float(np.median(step_ms))
    share = terms.bound_s * 1e3 / ms
    attended = lengths + 1          # the held step's attention lengths
    print(f"{LM_ARCH} {LONG_SHAPE} on {card}: batch {batch}, cache "
          f"{seq + LONG_STEPS + 1:,} positions ({caches['k'].numel() * 4:,} "
          f"B of bfloat16 K and V, filled in {fill_s:.3f} s), ms a step "
          + ", ".join(f"{t:.3f}" for t in step_ms) + f" (median {ms:.3f}); "
          f"hbm_floor_bytes {floor:,.0f} B on one card, step FLOPs "
          f"{flops:,}, roofline bound {terms.bound_s * 1e3:.4f} ms "
          f"({terms.dominant}), the step at {share:.4f} of its bound",
          flush=True)
    k0, v0 = caches["k"][0], caches["v"][0]
    layer = time_fd_shape(fd, ref, dev, k0, v0, attended, cfg.n_heads,
                          f"{LM_ARCH} {LONG_SHAPE}")
    layer.update(time_fd_parts(fd, dev, k0, v0, attended, cfg.n_heads))
    print(f"time flash_decode ({LM_ARCH} {LONG_SHAPE}) kernels apart: split "
          f"{layer['split_ms']} ms, combine {layer['combine_ms']} ms "
          f"(profiler), combine alone {layer['combine_events_ms']:.6f} ms "
          f"(CUDA events, {layer['n_chunks']} chunks over "
          f"{layer['combine_ctas']} CTAs)", flush=True)
    sharded = check_long_sharded(fd, cp, mesh_mod, ref, dev, k0, v0,
                                 cfg.n_heads, seq)
    print(f"sharded {LONG_SHAPE} on {card}: " + json.dumps(sharded),
          flush=True)
    rows = time_long_partials(fd, cp, ref, dev, k0, v0, cfg.n_heads, seq,
                              sharded["launches"])
    peak = peak_bytes(dev)
    del caches, k0, v0
    torch.cuda.empty_cache()
    cp_res = check_long_cp(attn_mod, transformer, model, dev)
    print(f"cp_attention prefill on {card}: " + json.dumps(cp_res),
          flush=True)
    res = {"batch": batch, "cache_positions": seq + LONG_STEPS + 1,
           "steps": LONG_STEPS, "step_ms": step_ms, "ms_per_step": ms,
           "tokens_per_s": batch / (ms / 1e3), "launches": counts,
           "held_max_abs_err": held["max_abs_err"], "step_flops": flops,
           "hbm_floor_bytes": floor, "roofline": terms.row(),
           "bound_ms": terms.bound_s * 1e3, "bound_share": share,
           "cache_fill_s": fill_s, "peak_bytes": peak, "layer": layer,
           "sharded": sharded, "cp_attention": cp_res, "kernel_rows": rows,
           "wall_s": time.perf_counter() - t_phase}
    print(f"long-context phase on {card} in {res['wall_s']:.3f} s, peak "
          f"memory {peak:,} B", flush=True)
    return res


def run_long_alone() -> dict:
    """The long-context phase alone on the card, its library built first
    (with its ptxas report) and held against the plain version over
    phase 3's flash_decode grid:

        python3 -c "import sys; sys.path.insert(0, 'src');
                    import chip_smoke as c; c.run_long_alone()"

    Prints the phase's lines and its kernels' JSON rows."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import bitmap_intersect as bi
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops as kops
    from repro_torch.models.api import build_bundle
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    for name, (lib, secs) in build_all(build, (fd.LIBRARY,)).items():
        print(f"build: {lib.name} in {secs:.3f} s", flush=True)
    for line in ptxas_report(build, fd.LIBRARY):
        print(f"ptxas: {line}", flush=True)
    dev = torch.device("cuda")
    errs, n = check_flash_decode(fd, ref, dev)
    print(f"flash_decode agrees with its plain version in {n} cases, "
          f"max_abs_err by output dtype {errs}", flush=True)
    bundle = build_bundle(LM_ARCH, device=dev)
    model = bundle.init_fn(0, dtype=torch.bfloat16)
    res = run_long_500k(bi, fd, kops, ref, bundle, model, dev, card)
    print(json.dumps({"kernels": res["kernel_rows"]}), flush=True)
    return res


def run_examples_alone() -> dict:
    """The examples phase alone on the card, the bitmap and flash_decode
    libraries built first:

        python3 -c "import sys; sys.path.insert(0, 'src');
                    import chip_smoke as c; c.run_examples_alone()"
    """
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import bitmap_intersect as bi
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as fd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    for name, (lib, secs) in build_all(build, (bi.LIBRARY,
                                               fd.LIBRARY)).items():
        print(f"build: {lib.name} in {secs:.3f} s", flush=True)
    return run_phase_examples(torch.device("cuda"), card)


def flushed_ms(fn, flush, *, reps: int = 20) -> float:
    """Device time of one call that finds the L2 cache cold: a write of
    `flush` (twice the 50 MB L2) before each call, then a sleep kernel that
    holds the stream while the host queues the call, and CUDA events
    around the call alone; the median over `reps`."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.fill_(1)
        torch.cuda._sleep(200_000)       # time for the host to queue fn
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def host_us(fn, *, calls: int = 200) -> float:
    """Host time of one call in microseconds: `calls` back-to-back calls
    queued behind a sleep kernel (so the launch queue never fills and no
    call waits on the device), timed on the host clock, over the count."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)           # ~100 ms at H100 clocks
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def bitmap_shapes(plan, tables, dev) -> dict:
    """The two shapes the bitmap kernels are timed at, each as (tables,
    slots, frontier r, parent idx): the dblp size-8 plan's widest extend
    (most gathered words; its own tables; the frontier as wide as the
    extend before it), and synthetic tables of eu2005's widest extend
    (k = 2 tables of 6,138 x 246 words, a 246-word frontier). Frontiers
    are sparse (about 1 bit in 64, half the rows empty), T_in = T_out =
    tile_rows, K0 = 4 parent columns at eu2005."""
    gen = np.random.default_rng(1)
    t = TILE_ROWS

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)

    ops = list(plan.ops)
    i = max(range(len(ops)), key=lambda j: (len(ops[j].bk_pairs)
                                             * ops[j].n_words, ops[j].level)
            if ops[j].bk_pairs else (-1, 0))
    op = ops[i]
    w_in = ops[i - 1].n_words if i else plan.root_words
    d_tabs = [tables[f"{u}:{op.vertex}"] for (_, u) in op.bk_pairs]
    d_slots = [s for (s, _) in op.bk_pairs]
    k0 = max(d_slots)                     # parent width; slot k0 = bitpos
    s_min = min(x.shape[0] for x in d_tabs)
    e_tabs = [on_card(gen.integers(0, 2 ** 32, (6_138, 246), dtype=np.uint32))
              for _ in range(2)]
    return {
        "dblp": (d_tabs, d_slots,
                 on_card(frontier_bits(gen, t, w_in, "sparse")),
                 on_card(gen.integers(0, s_min, (t, k0)).astype(np.int32))),
        "eu2005": (e_tabs, [4, 1],
                   on_card(frontier_bits(gen, t, 246, "sparse")),
                   on_card(gen.integers(0, 6_138, (t, 4)).astype(np.int32)))}


def io_bytes(name, tabs, slots, r, idx, out, sel=None) -> int:
    """Bytes the call must move at these inputs: each input byte it needs
    read once (the frontier, the parent rows and table rows its keys
    select, distinct rows counted once; for fused_expand_intersect the
    given selection `sel` = (rows, bitpos) instead of the frontier) and
    each output written once."""
    t = TILE_ROWS
    w = tabs[0].shape[1]
    if name == "fused_expand_intersect":
        rows, bitpos = sel
        parent = idx[rows.long()]
        cols = torch.cat([parent, bitpos[:, None]], dim=1)
        gathered = sum(int(torch.unique(cols[:, s]).numel()) for s in slots)
        return (t * 8 + int(torch.unique(rows).numel()) * idx.shape[1] * 4
                + gathered * w * 4 + t * w * 4 + t * 4)
    if name == "tile_intersect":
        keys = idx[:, slots]
        rows = sum(int(torch.unique(keys[:, j]).numel())
                   for j in range(len(slots)))
        clears = 1
        return (t * (len(set(slots)) + clears) * 4 + rows * w * 4
                + t * w * 4 + t * 4)
    rows, child = out[0], out[4]
    k0 = idx.shape[1]
    nbytes = (r.numel() * 4 + int(torch.unique(rows).numel()) * k0 * 4
              + t * (4 + 4 + 1) + 4 + child.numel() * 4)
    if name == "expand_intersect":
        gathered = sum(int(torch.unique(child[:, s]).numel()) for s in slots)
        nbytes += gathered * w * 4 + t * w * 4 + t * 4
    return nbytes


def time_kernels(bi, ref, cq, dev, launches, errs_by_width, floors,
                 widths, forced) -> list:
    """tile_intersect, expand_select, expand_intersect and (the old
    contract over a given selection) fused_expand_intersect at the two
    shapes of `bitmap_shapes`, each with an extend at every word-block
    width, warm (median_ms) and with the L2 flushed (flushed_ms), beside
    their plain versions (which have no width: timed once an entry and
    shape), their bounds and the launch floors; and, at the default width,
    the host's time a call (host_us), the kernel's and the plain
    version's, since the matcher waits on the host. One row an entry and
    width: its launches at that width on the entry's route of phase 4
    (KERNEL_ROUTE; expand_intersect's with the autotune sweeps') and in
    the forced-width run at that width."""
    from repro_torch.core.engine import upload_plan
    tables, _ = upload_plan(cq.plan, dev)
    flush = torch.empty(100 * 2 ** 20, dtype=torch.int8, device=dev)
    t = TILE_ROWS
    default = bi.DEFAULT_WORDS_PER_BLOCK
    keys = [("expand_select", default)] + [
        (name, wpb) for name in ("tile_intersect", "expand_intersect",
                                 "fused_expand_intersect")
        for wpb in bi.FUSED_TILE_WIDTHS]
    per = {key: {} for key in keys}
    for shape, (tabs, slots, r, idx) in bitmap_shapes(cq.plan, tables,
                                                      dev).items():
        k0 = idx.shape[1]
        t_idx = torch.cat([idx, idx[:, :1]], dim=1).contiguous()
        rows, bitpos = bi.expand_select(r, 0, t, idx)[:2]

        def specs(name, wpb):
            if name == "tile_intersect":
                return (lambda: bi.tile_intersect(tabs, t_idx, slots, [k0],
                                                  words_per_block=wpb),
                        lambda: ref.tile_intersect_ref(
                            tabs, t_idx, slots, [k0]))
            if name == "expand_select":
                return (lambda: bi.expand_select(r, 0, t, idx),
                        lambda: ref.expand_select_ref(r, 0, t, idx))
            if name == "expand_intersect":
                return (lambda: bi.expand_intersect(
                            r, 0, t, idx, tabs, slots, [k0],
                            words_per_block=wpb),
                        lambda: ref.expand_intersect_ref(
                            r, 0, t, idx, tabs, slots, [k0]))
            return (lambda: bi.fused_expand_intersect(
                        tabs, idx, rows, bitpos, slots, words_per_block=wpb),
                    lambda: ref.fused_expand_intersect_ref(
                        tabs, idx, rows, bitpos, slots=slots))

        plain_ms = {}
        for name, wpb in keys:
            kern, plain = specs(name, wpb)
            if name not in plain_ms:
                plain_ms[name] = median_ms(plain)
            out = kern()
            err = max_abs_err(out, plain())
            if err:
                raise SystemExit(f"{name} disagrees at the {shape} shape, "
                                 f"width {wpb}")
            nbytes = io_bytes(name, tabs, slots,
                              r, t_idx if name == "tile_intersect" else idx,
                              out, (rows, bitpos))
            row = {"k": len(tabs), "W": tabs[0].shape[1], "T": t,
                   "W_in": r.shape[1], "K0": k0, "words_per_block": wpb,
                   "ms": median_ms(kern),
                   "flushed_ms": flushed_ms(kern, flush),
                   "plain_ms": plain_ms[name],
                   "bytes": nbytes,
                   "bound_ms": nbytes / hw()["hbm_bw"] * 1e3,
                   "max_abs_err": err}
            if wpb == default and name != "fused_expand_intersect":
                row["host_us"] = host_us(kern)
                row["plain_host_us"] = host_us(plain)
            per[name, wpb][shape] = row
            print(f"time {name} at {shape}: " + json.dumps(row), flush=True)
    out = []
    for (name, wpb), shapes in per.items():
        d = shapes["dblp"]
        route = KERNEL_ROUTE[name]
        row = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bitmap_intersect.cu",
            "replaces": ("src/repro/kernels/bitmap_intersect.py:88"
                         if name == "tile_intersect"
                         else "src/repro/kernels/bitmap_intersect.py:179"),
            "words_per_block": wpb,
            "max_abs_err": max(errs_by_width[wpb][name],
                               *(v["max_abs_err"] for v in shapes.values())),
            "ms": d["ms"], "plain_ms": d["plain_ms"],
            "bound_ms": d["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "launch_floor_ms": floors["warm"],
            "launch_floor_flushed_ms": floors["flushed"],
            "shapes": shapes}
        if name == "expand_select":
            row["launches"] = launches[route][name]
            row["launches_by_route"] = {r: counts[name]
                                        for r, counts in launches.items()}
        else:
            row["launches"] = widths[route]["by_width"][name][wpb]
            row["launches_by_route"] = {
                r: widths[r]["by_width"][name][wpb] for r in widths}
            row["launches_forced_width"] = (
                forced[wpb]["by_width"][name][wpb])
            if name == "expand_intersect":
                row["launches_without_sweeps"] = \
                    widths[route]["path_by_width"][wpb]
        out.append(row)
    return out


def check_lm_train_reduced(build_bundle, trainer, ft, ckpt, dev,
                           tmp: str) -> dict:
    """Phase 5b.1: the reduced qwen2-1.5b in float32, card against CPU:
    prefill logits, one train step, a supervised run with faults, and a
    checkpoint written from the card and read onto the CPU."""
    f32 = torch.float32
    cpu = build_bundle(LM_ARCH, reduced=True, device="cpu")
    card = build_bundle(LM_ARCH, reduced=True, device=dev)
    m_cpu = cpu.init_fn(0)
    m_card = card.init_fn(1)
    m_card.load_state_dict(m_cpu.state_dict())
    tokens = cpu.make_inputs(PREFILL_SHAPE, seed=0)["tokens"]
    want = cpu.steps["prefill"](m_cpu, {"tokens": tokens}, dtype=f32)
    got = card.steps["prefill"](m_card, {"tokens": tokens.to(dev)},
                                dtype=f32).cpu()
    prefill_err = float((got - want).abs().max())
    if got.shape != want.shape or not prefill_err <= LM_F32_ATOL:
        raise SystemExit(f"reduced prefill: card and CPU differ "
                         f"(shape {tuple(got.shape)}, max_abs_err "
                         f"{prefill_err})")
    batch = cpu.make_inputs(TRAIN_SHAPE, seed=0)
    p_cpu = dict(m_cpu.named_parameters())
    p_card = dict(m_card.named_parameters())
    s_cpu, s_card = cpu.optimizer.init(p_cpu), card.optimizer.init(p_card)
    _, s_cpu, met_cpu = cpu.steps["train"](m_cpu, s_cpu, batch, dtype=f32)
    _, s_card, met_card = card.steps["train"](
        m_card, s_card, {"tokens": batch["tokens"].to(dev)}, dtype=f32)
    rel = {k: abs(float(met_card[k]) - float(met_cpu[k]))
           / abs(float(met_cpu[k])) for k in ("loss", "gnorm")}
    param_err = max(float((p_card[k].detach().cpu() - p.detach()).abs().max())
                    for k, p in p_cpu.items())
    if not (max(rel.values()) <= TRAIN_F32_RTOL
            and param_err <= TRAIN_F32_PARAM_ATOL):
        raise SystemExit(f"reduced train step: card and CPU differ "
                         f"(relative {rel}, parameters max_abs_err "
                         f"{param_err})")
    loops = {}
    for name, injector in (("faults", ft.FaultInjector(fail_at={5, 9})),
                           ("clean", None)):
        loops[name] = trainer.TrainLoop(
            arch=LM_ARCH, reduced=True, n_steps=12, batch=2, seq=32,
            ckpt_dir=os.path.join(tmp, name), ckpt_every=3,
            device=dev).run(injector=injector)
    faults, clean = loops["faults"], loops["clean"]
    replay_err = abs(faults.history[-1]["loss"] - clean.history[-1]["loss"])
    if (faults.restarts, clean.restarts) != (2, 0) \
            or not replay_err <= REPLAY_ATOL:
        raise SystemExit(f"supervised run on the card: restarts "
                         f"{faults.restarts} and {clean.restarts}, final "
                         f"losses {faults.history[-1]['loss']} and "
                         f"{clean.history[-1]['loss']}")
    state = {"params": p_card, "opt": s_card}
    ckpt.save_checkpoint(os.path.join(tmp, "card"), 1, state)
    template = {"params": {k: torch.empty_like(p, device="cpu")
                           for k, p in p_card.items()},
                "opt": {"m": {k: torch.empty_like(p, device="cpu")
                              for k, p in s_card["m"].items()},
                        "v": {k: torch.empty_like(p, device="cpu")
                              for k, p in s_card["v"].items()},
                        "step": torch.empty((), dtype=torch.int32)}}
    restored, _ = ckpt.load_checkpoint(os.path.join(tmp, "card"), template,
                                       device="cpu")
    flat, back = ckpt._flatten(state), ckpt._flatten(restored)
    if flat.keys() != back.keys() or not all(
            back[k].device.type == "cpu"
            and torch.equal(back[k], v.detach().cpu()) for k, v in flat.items()):
        raise SystemExit("a checkpoint saved from the card did not load "
                         "onto the CPU bit for bit")
    return {"prefill_max_abs_err": prefill_err,
            "train_rel_err": rel, "train_param_max_abs_err": param_err,
            "restarts": faults.restarts, "replay_loss_err": replay_err,
            "replayed_steps": [h["step"] for h in faults.history],
            "checkpoint_leaves": len(flat)}


def drive_prefill_32k(bundle, model, dev) -> dict:
    """Phase 5b.2: `steps["prefill"]` on prefill_32k at batch 1, bfloat16
    activations; a cold call, then a warm one."""
    from repro_torch.config import LM_SHAPES
    shape = LM_SHAPES[PREFILL_SHAPE]
    inputs = bundle.make_inputs(PREFILL_SHAPE, seed=0, batch=PREFILL_BATCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = bundle.steps["prefill"](model, inputs)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    cfg = bundle.cfg
    if tuple(logits.shape) != (PREFILL_BATCH, 1, cfg.vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"prefill_32k logits: shape {tuple(logits.shape)}, "
                         f"finite {bool(torch.isfinite(logits).all())}")
    tokens = PREFILL_BATCH * shape["seq_len"]
    flops = (bundle.model_flops(PREFILL_SHAPE) * PREFILL_BATCH
             / shape["global_batch"])
    s = shape["seq_len"]
    attn_flops = (cfg.n_layers * 4 * PREFILL_BATCH * cfg.n_heads * s * s
                  * cfg.head_dim / 2)
    return {"batch": PREFILL_BATCH, "batch_cut_from": shape["global_batch"],
            "seq": s, "ms": ms, "tokens_per_s": tokens / (ms[-1] / 1e3),
            "model_flops": flops,
            "bf16_peak_share": flops / (ms[-1] / 1e3) / hw()["flops_bf16"],
            "causal_attention_flops": attn_flops,
            "peak_bytes": torch.cuda.max_memory_allocated(dev)}


def prefill_against_decode(bundle, model, fd, dev) -> dict:
    """Phase 5b.2 (and 5c): prefill over a 64-token prefix at batch 2
    against the same tokens fed one by one through the decode step (with
    the flash_decode kernel, or MLA's absorbed path), float32 activations
    and cache."""
    f32 = torch.float32
    tokens = bundle.make_inputs(PREFILL_SHAPE, seed=1, batch=XCHECK_BATCH)[
        "tokens"][:, :XCHECK_TOKENS].contiguous()
    want = bundle.steps["prefill"](model, {"tokens": tokens}, dtype=f32)
    caches = bundle.init_caches(XCHECK_BATCH, XCHECK_TOKENS, dtype=f32)
    lengths = torch.zeros(XCHECK_BATCH, dtype=torch.int32, device=dev)
    fd.reset_launches()
    for t in range(XCHECK_TOKENS):
        logits, caches = bundle.steps["decode"](
            model, caches, {"token": tokens[:, t], "lengths": lengths},
            dtype=f32)
        lengths = lengths + 1
    torch.cuda.synchronize()
    launches = fd.flash_decode.launches
    # MLA decode is plain torch: no flash_decode launch
    expect = (bundle.cfg.n_layers * XCHECK_TOKENS
              if bundle.cfg.attention != "mla" else 0)
    err = float((logits - want[:, 0]).abs().max())
    if launches != expect or not err <= LM_32K_F32_ATOL:
        raise SystemExit(f"prefill against decode: {launches} flash_decode "
                         f"launches (expected {expect}), last logits "
                         f"max_abs_err {err} (limit {LM_32K_F32_ATOL})")
    return {"batch": XCHECK_BATCH, "tokens": XCHECK_TOKENS,
            "flash_decode_launches": launches, "max_abs_err": err,
            "logits_max_abs": float(want.abs().max()),
            "same_argmax": bool(torch.equal(logits.argmax(-1),
                                            want[:, 0].argmax(-1)))}


def drive_train_4k(bundle, model, trainer, dev) -> dict:
    """Phase 5b.3: TRAIN_STEPS `steps["train"]` on train_4k at batch 4
    over one repeated batch, bfloat16 activations."""
    from repro_torch.config import LM_SHAPES
    shape = LM_SHAPES[TRAIN_SHAPE]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    batch_fn = trainer.lm_token_stream(bundle.cfg.vocab, TRAIN_BATCH,
                                       shape["seq_len"], cycle=1, device=dev)
    state = bundle.optimizer.init(dict(model.named_parameters()))
    losses, gnorms, ms = [], [], []
    for step in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, metrics = bundle.steps["train"](model, state,
                                                  batch_fn(step))
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["gnorm"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()
            and losses[-1] < losses[0]):
        raise SystemExit(f"train_4k: losses {losses}, gnorms {gnorms}")
    warm = float(np.median(ms[1:]))
    tokens = TRAIN_BATCH * shape["seq_len"]
    flops = (bundle.model_flops(TRAIN_SHAPE) * TRAIN_BATCH
             / shape["global_batch"])
    return {"batch": TRAIN_BATCH, "batch_cut_from": shape["global_batch"],
            "seq": shape["seq_len"], "grad_accum": bundle.cfg.grad_accum,
            "losses": losses, "gnorms": gnorms, "ms": ms, "warm_ms": warm,
            "tokens_per_s": tokens / (warm / 1e3), "model_flops": flops,
            "bf16_peak_share": flops / (warm / 1e3) / hw()["flops_bf16"],
            "peak_bytes": torch.cuda.max_memory_allocated(dev)}


def time_prefill_attention(attn_mod, cfg, dev) -> dict:
    """Phase 5b.4: one layer of prefill_32k's attention, `flash_attention`
    beside `scaled_dot_product_attention` on the same bfloat16 inputs."""
    import torch.nn.functional as F
    from repro_torch.config import LM_SHAPES
    s = LM_SHAPES[PREFILL_SHAPE]["seq_len"]
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((PREFILL_BATCH, s, h, cfg.head_dim),
                           generator=gen, device=dev, dtype=torch.bfloat16)
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))

    def flash():
        return attn_mod.flash_attention(q, k, v, causal=True,
                                        q_chunk=cfg.q_chunk,
                                        k_chunk=cfg.k_chunk)

    def sdpa():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)

    with torch.no_grad():
        diff = float((flash().float() - sdpa().float()).abs().max())
        flash_ms = median_ms(flash, reps=3, iters=1)
        sdpa_ms = median_ms(sdpa, reps=5, iters=5)
    flops = 4 * PREFILL_BATCH * cfg.n_heads * s * s * cfg.head_dim / 2
    return {"shape": [PREFILL_BATCH, s, cfg.n_heads, cfg.n_kv_heads,
                      cfg.head_dim], "causal_flops": flops,
            "flash_attention_ms": flash_ms, "sdpa_ms": sdpa_ms,
            "flash_over_sdpa": flash_ms / sdpa_ms,
            "flash_tflops": flops / flash_ms / 1e9,
            "sdpa_tflops": flops / sdpa_ms / 1e9, "max_abs_diff": diff}


def run_phase_5b(dev, card: str) -> dict:
    """Phase 5b: LM prefill and training (module docstring)."""
    import tempfile
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.api import build_bundle
    from repro_torch.nn import attention as attn_mod
    from repro_torch.runtime import ft
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import trainer
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        red = check_lm_train_reduced(build_bundle, trainer, ft, ckpt, dev,
                                     tmp)
    print("lm train reduced " + json.dumps(red), flush=True)
    print(f"reduced {LM_ARCH} on the card against the CPU, float32: "
          f"prefill max_abs_err {red['prefill_max_abs_err']:.3g}, train "
          f"step relative {red['train_rel_err']}, parameters "
          f"{red['train_param_max_abs_err']:.3g}; {red['restarts']} "
          f"restarts replayed to {red['replay_loss_err']:.3g} of a "
          f"fault-free run; checkpoint card -> CPU bit for bit "
          f"({time.perf_counter() - t0:.3f} s)", flush=True)
    t1 = time.perf_counter()
    bundle = build_bundle(LM_ARCH, device=dev)
    model = bundle.init_fn(0)
    torch.cuda.synchronize()
    print(f"{LM_ARCH}: {bundle.cfg.n_params():,} parameters in float32, "
          f"init {time.perf_counter() - t1:.3f} s", flush=True)
    pre = drive_prefill_32k(bundle, model, dev)
    print("lm prefill_32k " + json.dumps(pre), flush=True)
    print(f"prefill_32k on {card}: batch {pre['batch']} (cut from "
          f"{pre['batch_cut_from']}) x {pre['seq']} tokens, cold "
          f"{pre['ms'][0]:.1f} ms, warm {pre['ms'][1]:.1f} ms, "
          f"{pre['tokens_per_s']:.0f} tokens/s, "
          f"{100 * pre['bf16_peak_share']:.3f} % of the bf16 peak, peak "
          f"memory {pre['peak_bytes']:,} B", flush=True)
    xc = prefill_against_decode(bundle, model, fd, dev)
    print("lm prefill vs decode " + json.dumps(xc), flush=True)
    tr = drive_train_4k(bundle, model, trainer, dev)
    print("lm train_4k " + json.dumps(tr), flush=True)
    print(f"train_4k on {card}: batch {tr['batch']} (cut from "
          f"{tr['batch_cut_from']}) x {tr['seq']}, grad_accum "
          f"{tr['grad_accum']}, losses {tr['losses']}, warm "
          f"{tr['warm_ms']:.1f} ms a step, {tr['tokens_per_s']:.0f} "
          f"tokens/s, {100 * tr['bf16_peak_share']:.3f} % of the bf16 "
          f"peak, peak memory {tr['peak_bytes']:,} B", flush=True)
    del model
    torch.cuda.empty_cache()
    at = time_prefill_attention(attn_mod, bundle.cfg, dev)
    print(f"prefill attention on {card}: " + json.dumps(at), flush=True)
    print(f"phase 5b in {time.perf_counter() - t0:.3f} s", flush=True)
    return {"reduced": red, "prefill_32k": pre, "prefill_vs_decode": xc,
            "train_4k": tr, "attention": at}


def check_family_reduced(build_bundle, fd, arch: str, dev) -> dict:
    """Phase 5c.2: `arch`'s reduced model in float32, card against CPU:
    prefill logits, FAMILY_REDUCED_STEPS decode steps over a random cache
    (flash_decode on the card, its plain version on the CPU; MLA plain on
    both) and one train step (loss with the MoE aux, gnorm, parameters)."""
    f32 = torch.float32
    cpu = build_bundle(arch, reduced=True, device="cpu")
    card = build_bundle(arch, reduced=True, device=dev)
    cfg = cpu.cfg
    m_cpu = cpu.init_fn(0)
    m_card = card.init_fn(1)
    m_card.load_state_dict(m_cpu.state_dict())
    tokens = cpu.make_inputs(PREFILL_SHAPE, seed=0)["tokens"]
    want = cpu.steps["prefill"](m_cpu, {"tokens": tokens}, dtype=f32)
    got = card.steps["prefill"](m_card, {"tokens": tokens.to(dev)},
                                dtype=f32).cpu()
    prefill_err = float((got - want).abs().max())
    if got.shape != want.shape or not prefill_err <= LM_F32_ATOL:
        raise SystemExit(f"reduced {arch} prefill: card and CPU differ "
                         f"(shape {tuple(got.shape)}, max_abs_err "
                         f"{prefill_err})")
    inputs = cpu.make_inputs(DECODE_SHAPE, seed=0)
    b = inputs["token"].shape[0]
    c_cpu = cpu.init_caches(b, 128 + FAMILY_REDUCED_STEPS, dtype=f32)
    gen = torch.Generator().manual_seed(2)
    for t in c_cpu.values():
        t.normal_(generator=gen)
    c_card = {n: t.to(dev) for n, t in c_cpu.items()}
    token, lengths = inputs["token"], inputs["lengths"]
    fd.reset_launches()
    for _ in range(FAMILY_REDUCED_STEPS):
        want, c_cpu = cpu.steps["decode"](
            m_cpu, c_cpu, {"token": token, "lengths": lengths}, dtype=f32)
        got, c_card = card.steps["decode"](
            m_card, c_card, {"token": token.to(dev),
                             "lengths": lengths.to(dev)}, dtype=f32)
        token, lengths = want.argmax(-1).to(torch.int32), lengths + 1
    launches = fd.flash_decode.launches
    expect = (cfg.n_layers * FAMILY_REDUCED_STEPS
              if cfg.attention != "mla" else 0)
    decode_err = float((got.cpu() - want).abs().max())
    cache_err = max(float((c_card[n].cpu() - c_cpu[n]).abs().max())
                    for n in c_cpu)
    if not (decode_err <= LM_F32_ATOL and cache_err <= LM_F32_ATOL
            and launches == expect):
        raise SystemExit(f"reduced {arch} decode: card and CPU differ "
                         f"(last logits max_abs_err {decode_err}, caches "
                         f"{cache_err}) or flash_decode launched {launches} "
                         f"times (expected {expect})")
    batch = cpu.make_inputs(TRAIN_SHAPE, seed=0)
    p_cpu = dict(m_cpu.named_parameters())
    p_card = dict(m_card.named_parameters())
    s_cpu, s_card = cpu.optimizer.init(p_cpu), card.optimizer.init(p_card)
    _, _, met_cpu = cpu.steps["train"](m_cpu, s_cpu, batch, dtype=f32)
    _, _, met_card = card.steps["train"](
        m_card, s_card, {"tokens": batch["tokens"].to(dev)}, dtype=f32)
    rel = {k: abs(float(met_card[k]) - float(met_cpu[k]))
           / abs(float(met_cpu[k])) for k in ("loss", "gnorm")}
    opt = cpu.optimizer
    param_err, loose_err, grad_err, n_loose = 0.0, 0.0, 0.0, 0
    for k, p in p_cpu.items():
        g = s_cpu["m"][k] / (1 - opt.b1)          # the clipped gradient
        g_card = s_card["m"][k].cpu() / (1 - opt.b1)
        grad_err = max(grad_err, float((g_card - g).abs().max())
                       / max(float(g.abs().max()), 1e-30))
        diff = (p_card[k].detach().cpu() - p.detach()).abs()
        firm = g.abs() >= ADAM_G_FLOOR
        if firm.any():
            param_err = max(param_err, float(diff[firm].max()))
        if not firm.all():
            loose_err = max(loose_err, float(diff[~firm].max()))
        n_loose += int((~firm).sum())
    if not (max(rel.values()) <= TRAIN_F32_RTOL
            and param_err <= TRAIN_F32_PARAM_ATOL
            and grad_err <= TRAIN_F32_PARAM_ATOL
            and loose_err <= 2 * opt.lr):
        raise SystemExit(f"reduced {arch} train step: card and CPU differ "
                         f"(relative {rel}, gradients {grad_err} of each "
                         f"leaf's largest, parameters max_abs_err "
                         f"{param_err} where |g| >= {ADAM_G_FLOOR}, "
                         f"{loose_err} on the {n_loose} other entries)")
    return {"prefill_max_abs_err": prefill_err,
            "decode_steps": FAMILY_REDUCED_STEPS,
            "decode_max_abs_err": decode_err, "cache_max_abs_err": cache_err,
            "flash_decode_launches": launches,
            "train_loss": float(met_cpu["loss"]), "train_rel_err": rel,
            "train_grad_rel_err": grad_err,
            "train_param_max_abs_err": param_err,
            "train_small_grad_entries": n_loose,
            "train_small_grad_param_max_abs_err": loose_err}


def drive_family_launcher(serve, fd, arch: str) -> dict:
    """Phase 5c.1: the launcher as a user runs it, `python -m
    repro_torch.launch.serve --arch <arch>` with no --device (its `main`:
    the reduced config on the card, random bfloat16 weights, greedy decode
    of SERVE_BATCH x SERVE_TOKENS over a float32 cache), with the launch
    counts set to 0 just before and read just after: n_layers x
    SERVE_TOKENS flash_decode launches, all "cuda_core", for GQA; none for
    MLA."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch, reduced=True)
    fd.reset_launches()
    t0 = time.perf_counter()
    rc = serve.main(["--arch", arch])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = fd.flash_decode.launches
    by_route = dict(fd.flash_decode.launches_by_route)
    want = cfg.n_layers * SERVE_TOKENS if cfg.attention != "mla" else 0
    if (rc, launches, by_route) != (0, want, {"tensor_core": 0,
                                              "cuda_core": want}):
        raise SystemExit(f"serve --arch {arch} on the card: exit {rc}, "
                         f"flash_decode launches {launches} by route "
                         f"{by_route} (expected {want}, all cuda_core)")
    return {"arch": arch, "seconds": secs, "launches": launches,
            "launches_by_route": by_route}


def drive_family_decode_32k(bi, fd, kops, ref, bundle, model, arch: str,
                            dev) -> dict:
    """Phase 5c.3: decode_32k at FAMILY_DECODE_BATCH[arch] rows, bfloat16
    weights and activations over a bfloat16 cache of 32,768 positions (plus
    the steps' new tokens) filled with seeded random values, lengths from
    make_inputs(seed=0): DECODE_STEPS greedy steps with the launch counts
    set to 0 just before and read just after (GQA: n_layers launches a
    step, all "tensor_core", each a split kernel and a combine; MLA: none),
    then one more step with each attention call held against the plain
    version; for GQA, flash_decode timed on layer 0's cache at the lengths
    that step attended over (`time_fd_shape`)."""
    from repro_torch.config import LM_SHAPES
    cfg = bundle.cfg
    batch = FAMILY_DECODE_BATCH[arch]
    seq = LM_SHAPES[DECODE_SHAPE]["seq_len"]
    gqa = cfg.attention != "mla"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    inputs = bundle.make_inputs(DECODE_SHAPE, seed=0, batch=batch)
    caches = bundle.init_caches(batch, seq + DECODE_STEPS + 1,
                                dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(1)
    for t in caches.values():
        t.normal_(generator=gen)
    step = bundle.steps["decode"]
    token, lengths = inputs["token"], inputs["lengths"]
    torch.cuda.synchronize()
    bi.reset_launches()
    fd.reset_launches()
    step_ms = []
    for _ in range(DECODE_STEPS):
        t0 = time.perf_counter()
        logits, caches = step(model, caches,
                              {"token": token, "lengths": lengths})
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        lengths = lengths + 1
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = fd.flash_decode.launches
    by_route = dict(fd.flash_decode.launches_by_route)
    by_kernel = dict(fd.flash_decode.launches_by_kernel)
    bitmap = sum(fn.launches for fn in bi.WRAPPERS)
    want = cfg.n_layers * DECODE_STEPS if gqa else 0
    n_chunks = fd.split_plan(batch, cfg.n_heads, cfg.n_kv_heads,
                             caches["k"].shape[2], cfg.head_dim)[1] \
        if gqa else 1
    want_kernel = {"split": want, "combine": want if n_chunks > 1 else 0}
    if (launches, by_route, by_kernel, bitmap) != (
            want, {"tensor_core": want, "cuda_core": 0}, want_kernel, 0):
        raise SystemExit(f"{arch} decode_32k launched flash_decode "
                         f"{launches} times, routes {by_route}, device "
                         f"kernels {by_kernel} (expected {want}, all on "
                         f"tensor_core, {want_kernel}), bitmap kernels "
                         f"{bitmap}")
    if not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"{arch} decode_32k logits are not finite")
    batch_in = {"token": token, "lengths": lengths}
    out = {}
    held = held_attention(kops, ref, lambda: out.update(
        logits=step(model, caches, batch_in)[0]))
    if held["calls"] != (cfg.n_layers if gqa else 0) \
            or not bool(torch.isfinite(out["logits"]).all()):
        raise SystemExit(f"{arch} decode_32k step held {held['calls']} "
                         f"attention calls (expected "
                         f"{cfg.n_layers if gqa else 0}), logits finite "
                         f"{bool(torch.isfinite(out['logits']).all())}")
    peak = torch.cuda.max_memory_allocated(dev)
    timing = (time_fd_shape(fd, ref, dev, caches["k"][0], caches["v"][0],
                            lengths + 1, cfg.n_heads, f"{arch} decode_32k")
              if gqa else None)
    ms = float(np.median(step_ms))
    return {"batch": batch, "layers": cfg.n_layers,
            "cache_positions": seq + DECODE_STEPS + 1,
            "cache_bytes": sum(t.numel() * t.element_size()
                               for t in caches.values()),
            "steps": DECODE_STEPS, "step_ms": step_ms, "ms_per_step": ms,
            "tokens_per_s": batch / (ms / 1e3), "launches": launches,
            "launches_by_route": by_route, "launches_by_kernel": by_kernel,
            "attention_held": held, "peak_bytes": peak,
            "flash_decode": timing}


def drive_family_prefill(bundle, model, dev) -> dict:
    """Phase 5c.4: `steps["prefill"]` over the first FAMILY_PREFILL_TOKENS
    tokens of prefill_32k's first row, bfloat16; a cold call, then a warm
    one."""
    tokens = bundle.make_inputs(PREFILL_SHAPE, seed=0, batch=1)["tokens"][
        :, :FAMILY_PREFILL_TOKENS].contiguous()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = bundle.steps["prefill"](model, {"tokens": tokens})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    cfg = bundle.cfg
    if tuple(logits.shape) != (1, 1, cfg.vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"{cfg.name} prefill logits: shape "
                         f"{tuple(logits.shape)}, finite "
                         f"{bool(torch.isfinite(logits).all())}")
    flops = 2.0 * cfg.n_active_params() * FAMILY_PREFILL_TOKENS
    return {"batch": 1, "tokens": FAMILY_PREFILL_TOKENS, "ms": ms,
            "tokens_per_s": FAMILY_PREFILL_TOKENS / (ms[-1] / 1e3),
            "model_flops": flops,
            "bf16_peak_share": flops / (ms[-1] / 1e3) / hw()["flops_bf16"],
            "peak_bytes": torch.cuda.max_memory_allocated(dev)}


def run_phase_5c(dev, card: str) -> dict:
    """Phase 5c: the other four LM architectures (module docstring)."""
    from repro_torch.kernels import bitmap_intersect as bi
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.models.api import build_bundle
    t0 = time.perf_counter()
    res = {}
    for arch in FAMILY_ARCHS:
        ta = time.perf_counter()
        launcher = drive_family_launcher(serve, fd, arch)
        print(f"serve --arch {arch} on the card: " + json.dumps(launcher),
              flush=True)
        red = check_family_reduced(build_bundle, fd, arch, dev)
        print(f"reduced {arch} on the card against the CPU, float32: "
              + json.dumps(red), flush=True)
        layers = FAMILY_LAYERS.get(arch)
        bundle = build_bundle(arch, device=dev, override=(
            {"n_layers": layers} if layers else None))
        cfg = bundle.cfg
        torch.cuda.synchronize()
        ti = time.perf_counter()
        model = bundle.init_fn(0, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        print(f"{arch}: {cfg.n_layers} layers, {cfg.n_params():,} "
              f"parameters ({cfg.n_active_params():,} active) in bfloat16, "
              f"init {time.perf_counter() - ti:.3f} s", flush=True)
        d32k = drive_family_decode_32k(bi, fd, kops, ref, bundle, model,
                                       arch, dev)
        print(f"lm {arch} decode_32k " + json.dumps(d32k), flush=True)
        print(f"{arch} decode_32k on {card}: batch {d32k['batch']}, "
              f"{d32k['layers']} layers, "
              f"{d32k['ms_per_step']:.2f} ms a step (median of "
              f"{d32k['steps']}), {d32k['tokens_per_s']:.1f} tokens/s, "
              f"flash_decode launches {d32k['launches']}, held "
              f"{d32k['attention_held']['calls']} attention calls, peak "
              f"memory {d32k['peak_bytes']:,} B", flush=True)
        pre = drive_family_prefill(bundle, model, dev)
        print(f"lm {arch} prefill " + json.dumps(pre), flush=True)
        print(f"{arch} prefill on {card}: batch 1 x {pre['tokens']} tokens, "
              f"cold {pre['ms'][0]:.1f} ms, warm {pre['ms'][1]:.1f} ms, "
              f"{pre['tokens_per_s']:.0f} tokens/s, "
              f"{100 * pre['bf16_peak_share']:.3f} % of the bf16 peak, peak "
              f"memory {pre['peak_bytes']:,} B", flush=True)
        xc = None
        if arch in FAMILY_XCHECK:
            xc = prefill_against_decode(bundle, model, fd, dev)
            print(f"lm {arch} prefill vs decode " + json.dumps(xc),
                  flush=True)
        del model
        torch.cuda.empty_cache()
        res[arch] = {"launcher": launcher, "reduced": red,
                     "decode_32k": d32k, "prefill": pre,
                     "prefill_vs_decode": xc,
                     "seconds": time.perf_counter() - ta}
        print(f"phase 5c {arch} in {res[arch]['seconds']:.3f} s",
              flush=True)
    print(f"phase 5c in {time.perf_counter() - t0:.3f} s", flush=True)
    return res


def kernel_launch_counts(bi, fd) -> dict:
    """Each kernel of the kernels line: its launches since the last reset."""
    return {fn.__name__: fn.launches for fn in (*bi.WRAPPERS, *fd.WRAPPERS)}


def reset_kernel_launches(bi, fd) -> None:
    bi.reset_launches()
    fd.reset_launches()


def require_no_launches(where: str, counts: dict) -> None:
    """Phase 5d's paths reach none of the three kernels."""
    if any(counts.values()):
        raise SystemExit(f"{where} launched kernels {counts}; its path has "
                         "none")


def timed_ms(fn, dev, n: int) -> list:
    """Host-clock ms of n synchronised calls of fn."""
    out = []
    for _ in range(n):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def peak_bytes(dev) -> int:
    return torch.cuda.max_memory_allocated(dev)


def reset_peak(dev) -> None:
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def held_top_k(vals, idx, scores64, rtol: float, where: str) -> dict:
    """(vals, idx), a top-k in float32, against `scores64` (B, V): the
    float64 top-k's values within rtol of the row's largest |score|, the
    float64 scores of the chosen items likewise (each chosen item really
    scores so, in that order), and the chosen set equal to the float64
    top-k's on every row where its k-th and (k+1)-th scores are farther
    apart than that."""
    k = idx.shape[1]
    ref_v, ref_i = torch.topk(scores64, k + 1, dim=-1)
    scale = ref_v.abs().amax(-1, keepdim=True).clamp(min=1e-30) * rtol
    err_v = float(((vals.double() - ref_v[:, :k]).abs() / scale).max())
    chosen = scores64.gather(1, idx.long())
    err_c = float(((chosen - ref_v[:, :k]).abs() / scale).max())
    clear = (ref_v[:, k - 1] - ref_v[:, k]) > scale[:, 0]
    same_set = (idx.long().sort(-1).values
                == ref_i[:, :k].sort(-1).values).all(-1)
    bad = int((clear & ~same_set).sum())
    if not (err_v <= 1 and err_c <= 1 and bad == 0):
        raise SystemExit(f"{where}: top-{k} against the float64 recompute: "
                         f"values {err_v:.3g} x the tolerance, chosen items' "
                         f"scores {err_c:.3g} x, {bad} rows with a clear "
                         "boundary choose other items")
    return {"rows": idx.shape[0], "rows_with_clear_boundary": int(clear.sum()),
            "rows_equal_in_order": int((idx.long() == ref_i[:, :k])
                                       .all(-1).sum()),
            "max_err_over_tol": max(err_v, err_c)}


def scores64(model, ids, table):
    """The last position's hidden state (the encoder in float32) against
    `table` (V, D), recomputed in float64."""
    from repro_torch.nn import transformer as T
    with torch.no_grad():
        h = T.encoder_forward(model, ids)[:, -1]
    return h.double() @ table.double().T


def drive_recsys_serve(bundle, model, shape: str, dev, *, batch=None,
                       held_rows=None) -> dict:
    """Phase 5d.2/4: the serve step on `shape`'s inputs (seed 0, `batch`
    rows): warm, then RECSYS_TIMED_CALLS timed; the top-10 of the first
    `held_rows` rows (all by default) held against h @ table.T in
    float64."""
    from repro_torch.config import RECSYS_SHAPES
    inputs = bundle.make_inputs(shape, seed=0, batch=batch)
    b = inputs["ids"].shape[0]
    reset_peak(dev)
    out = {}
    step = bundle.steps["serve"]
    ms = timed_ms(lambda: out.update(r=step(model, inputs)), dev,
                  1 + RECSYS_TIMED_CALLS)
    vals, idx = out["r"]
    peak = peak_bytes(dev)
    rows = slice(0, held_rows or b)
    held = held_top_k(vals[rows], idx[rows],
                      scores64(model, inputs["ids"][rows],
                               model.embed.table.detach()),
                      RECSYS_TOPK_RTOL, f"{RECSYS_ARCH} {shape}")
    warm = float(np.median(ms[1:]))
    flops = (bundle.model_flops(shape) * b / RECSYS_SHAPES[shape]["batch"])
    return {"shape": shape, "batch": b,
            "batch_cut_from": RECSYS_SHAPES[shape]["batch"], "ms": ms,
            "ms_per_batch": warm, "queries_per_s": b / (warm / 1e3),
            "model_flops": flops,
            "f32_peak_share": flops / (warm / 1e3) / hw()["flops_f32"],
            "scores_bytes": b * bundle.cfg.n_items * 4,
            "peak_bytes": peak, "held": held}


def drive_recsys_retrieval(bundle, model, dev) -> dict:
    """Phase 5d.3: retrieval_cand, batch 1 against 10^6 candidates: warm,
    then RECSYS_TIMED_CALLS timed; the scores held against the float64
    recompute within RECSYS_TOPK_RTOL of the largest."""
    inputs = bundle.make_inputs("retrieval_cand", seed=0)
    out = {}
    step = bundle.steps["retrieval"]
    ms = timed_ms(lambda: out.update(s=step(model, inputs)), dev,
                  1 + RECSYS_TIMED_CALLS)
    cand = model.embed.table.detach()[inputs["candidate_ids"].long()]
    want = scores64(model, inputs["ids"], cand)
    err = float((out["s"].double() - want).abs().max()
                / want.abs().max())
    if tuple(out["s"].shape) != tuple(want.shape) \
            or not err <= RECSYS_TOPK_RTOL:
        raise SystemExit(f"{RECSYS_ARCH} retrieval_cand: scores "
                         f"{tuple(out['s'].shape)} against the float64 "
                         f"recompute, {err:.3g} of the largest")
    warm = float(np.median(ms[1:]))
    return {"batch": 1, "candidates": inputs["candidate_ids"].shape[0],
            "ms": ms, "ms_per_query": warm,
            "model_flops": bundle.model_flops("retrieval_cand"),
            "rel_err_vs_float64": err}


def drive_recsys_train(build_bundle, dev) -> dict:
    """Phase 5d.5: train_batch at RECSYS_TRAIN_BATCH rows and batch_chunk
    RECSYS_TRAIN_CHUNK: a warm step, then RECSYS_STEPS timed, on one
    batch; losses finite and the parameters changed."""
    from repro_torch.config import RECSYS_SHAPES
    bundle = build_bundle(RECSYS_ARCH, device=dev,
                          override={"batch_chunk": RECSYS_TRAIN_CHUNK})
    model = bundle.init_fn(0)
    inputs = bundle.make_inputs("train_batch", seed=0,
                                batch=RECSYS_TRAIN_BATCH)
    params = dict(model.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    state = bundle.optimizer.init(params)
    reset_peak(dev)
    losses = []

    def step():
        nonlocal state
        _, state, met = bundle.steps["train"](model, state, inputs)
        losses.append(float(met["loss"]))
    ms = timed_ms(step, dev, 1 + RECSYS_STEPS)
    peak = peak_bytes(dev)
    changed = sum(int(not torch.equal(p.detach(), before[k]))
                  for k, p in params.items())
    if not (np.isfinite(losses).all() and changed == len(params)):
        raise SystemExit(f"{RECSYS_ARCH} train_batch: losses {losses}, "
                         f"{changed} of {len(params)} parameters changed")
    warm = float(np.median(ms[1:]))
    masked = int(inputs["mask_valid"].sum())
    m = inputs["mask_idx"].shape[1]
    spec_b = RECSYS_SHAPES["train_batch"]["batch"]
    flops = bundle.model_flops("train_batch") * RECSYS_TRAIN_BATCH / spec_b
    return {"batch": RECSYS_TRAIN_BATCH, "batch_cut_from": spec_b,
            "batch_chunk": RECSYS_TRAIN_CHUNK, "max_masks": m,
            "chunk_logits_bytes": RECSYS_TRAIN_CHUNK * m
            * bundle.cfg.n_items * 4,
            "losses": losses, "ms": ms, "ms_per_step": warm,
            "masked_items": masked,
            "masked_items_per_s": masked / (warm / 1e3),
            "model_flops": flops,
            "f32_peak_share": flops / (warm / 1e3) / hw()["flops_f32"],
            "peak_bytes": peak}


def held_train_step(cpu, card, m_cpu, m_card, run_cpu, run_card,
                    where: str) -> dict:
    """One train step of the same weights on the card and the CPU
    (float32): loss and gnorm within TRAIN_F32_RTOL relative; each
    gradient leaf (the first moment / (1 - b1): the clipped gradient)
    within TRAIN_F32_PARAM_ATOL of its largest or GRAD_FLOOR; parameters
    within TRAIN_F32_PARAM_ATOL where |g| >= ADAM_G_FLOOR and 2·lr
    elsewhere (phase 5c's rule, ADAM_G_FLOOR above)."""
    p_cpu = dict(m_cpu.named_parameters())
    p_card = dict(m_card.named_parameters())
    s_cpu, s_card = cpu.optimizer.init(p_cpu), card.optimizer.init(p_card)
    _, _, met_cpu = run_cpu(m_cpu, s_cpu)
    _, _, met_card = run_card(m_card, s_card)
    rel = {k: abs(float(met_card[k]) - float(met_cpu[k]))
           / abs(float(met_cpu[k])) for k in ("loss", "gnorm")}
    opt = cpu.optimizer
    param_err, loose_err, grad_err, n_loose = 0.0, 0.0, 0.0, 0
    for k, p in p_cpu.items():
        g = s_cpu["m"][k] / (1 - opt.b1)
        g_card = s_card["m"][k].cpu() / (1 - opt.b1)
        grad_err = max(grad_err, float((g_card - g).abs().max()) / max(
            TRAIN_F32_PARAM_ATOL * float(g.abs().max()), GRAD_FLOOR))
        diff = (p_card[k].detach().cpu() - p.detach()).abs()
        firm = g.abs() >= ADAM_G_FLOOR
        if firm.any():
            param_err = max(param_err, float(diff[firm].max()))
        if not firm.all():
            loose_err = max(loose_err, float(diff[~firm].max()))
        n_loose += int((~firm).sum())
    if not (max(rel.values()) <= TRAIN_F32_RTOL
            and param_err <= TRAIN_F32_PARAM_ATOL and grad_err <= 1
            and loose_err <= 2 * opt.lr):
        raise SystemExit(f"{where} train step: card and CPU differ "
                         f"(relative {rel}, gradients {grad_err} x the "
                         f"tolerance, parameters max_abs_err {param_err} "
                         f"where |g| >= {ADAM_G_FLOOR}, {loose_err} on the "
                         f"{n_loose} other entries)")
    return {"loss": float(met_cpu["loss"]), "rel_err": rel,
            "grad_err_over_tol": grad_err, "param_max_abs_err": param_err,
            "small_grad_entries": n_loose,
            "small_grad_param_max_abs_err": loose_err}


def check_recsys_reduced(build_bundle, dev) -> dict:
    """Phase 5d.6: the reduced bert4rec in float32, card against CPU: the
    serve step's top-10 (both held against the CPU's float64 recompute at
    TRAIN_F32_RTOL), the retrieval scores (within TRAIN_F32_RTOL of the
    largest) and one train step (`held_train_step`)."""
    cpu = build_bundle(RECSYS_ARCH, reduced=True, device="cpu")
    card = build_bundle(RECSYS_ARCH, reduced=True, device=dev)
    m_cpu = cpu.init_fn(0)
    m_card = card.init_fn(1)
    m_card.load_state_dict(m_cpu.state_dict())
    to_dev = lambda b: {k: v.to(dev) for k, v in b.items()}  # noqa: E731
    serve = cpu.make_inputs("serve_p99", seed=0)
    want64 = scores64(m_cpu, serve["ids"], m_cpu.embed.table.detach())
    vals, idx = card.steps["serve"](m_card, to_dev(serve))
    vals_c, idx_c = cpu.steps["serve"](m_cpu, serve)
    held = {where: held_top_k(v.cpu(), i.cpu(), want64, TRAIN_F32_RTOL,
                              f"reduced {RECSYS_ARCH} serve on the {where}")
            for where, (v, i) in (("card", (vals, idx)),
                                  ("cpu", (vals_c, idx_c)))}
    retr = cpu.make_inputs("retrieval_cand", seed=0)
    got = card.steps["retrieval"](m_card, to_dev(retr)).cpu()
    want = cpu.steps["retrieval"](m_cpu, retr)
    retr_err = float((got - want).abs().max() / want.abs().max())
    if not retr_err <= TRAIN_F32_RTOL:
        raise SystemExit(f"reduced {RECSYS_ARCH} retrieval: card and CPU "
                         f"differ by {retr_err:.3g} of the largest score")
    batch = cpu.make_inputs("train_batch", seed=0)
    train = held_train_step(
        cpu, card, m_cpu, m_card,
        lambda m, s: cpu.steps["train"](m, s, batch),
        lambda m, s: card.steps["train"](m, s, to_dev(batch)),
        f"reduced {RECSYS_ARCH}")
    return {"serve": held, "serve_indices_equal":
            bool(torch.equal(idx.cpu(), idx_c)),
            "retrieval_rel_err": retr_err, "train": train}


def drive_recsys_launcher(serve, bi, fd) -> dict:
    """Phase 5d.1: `python -m repro_torch.launch.serve --arch bert4rec` as
    a user runs it (its `main`, no --device: the reduced config's
    serve_p99 batch on the card)."""
    reset_kernel_launches(bi, fd)
    t0 = time.perf_counter()
    rc = serve.main(["--arch", RECSYS_ARCH])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kernel_launch_counts(bi, fd)
    if rc != 0:
        raise SystemExit(f"serve --arch {RECSYS_ARCH} on the card: exit {rc}")
    require_no_launches(f"serve --arch {RECSYS_ARCH}", counts)
    return {"seconds": secs, "launches": counts}


def gnn_bytes(cfg, n: int, e: int, t: int) -> int:
    """A reckoning of one train step's live device bytes (float32), from the
    shapes: each layer's checkpointed input kept for the backward, plus one
    layer's recomputed activations and their gradients (counted as the
    layer's largest per-edge tensors, a few times over). `drive_gnn_train`
    records it beside each run's measured peak."""
    c, L, f = cfg.d_hidden, cfg.n_layers, 4
    if cfg.model == "gatedgcn":
        return f * c * (L * (n + e) + 16 * e + 8 * n)
    if cfg.model == "nequip":
        lm = cfg.extra.get("l_max", 2)
        coef = (lm + 1) ** 2
        from repro_torch.models.gnn_models import NequIP
        paths = len(NequIP.paths(lm))
        return f * c * (L * n * coef + paths * e * 4 * (2 * lm + 1)
                        + 4 * n * coef)
    if cfg.model == "equiformer_v2":
        coef = (cfg.extra.get("l_max", 6) + 1) ** 2
        return f * c * coef * (L * n + 12 * e)
    nb = cfg.extra.get("n_bilinear", 8)              # dimenet
    return f * c * (L * e + 2 * nb * t + 6 * t + 8 * e)


def reckon_sampled(bundle) -> dict:
    """`gnn_bytes` of minibatch_lg uncut and, where that passes
    GNN_BYTES_BUDGET, the largest multiple of GNN_SEED_STEP seeds that
    fits, with its bytes."""
    from repro_torch.config import GNN_SHAPES

    def reckon(seeds):
        spec = bundle.input_specs(GNN_SAMPLED_SHAPE, batch=seeds)
        return gnn_bytes(bundle.cfg, spec["node_mask"][0][0],
                         spec["edge_mask"][0][0],
                         spec["t_kj"][0][0] if "t_kj" in spec else 0)
    full = GNN_SHAPES[GNN_SAMPLED_SHAPE]["batch_nodes"]
    out = {"bytes": reckon(None), "budget": GNN_BYTES_BUDGET, "seeds": None,
           "seeds_cut_from": full}
    if out["bytes"] > GNN_BYTES_BUDGET:
        fits = [s for s in range(GNN_SEED_STEP, full, GNN_SEED_STEP)
                if reckon(s) <= GNN_BYTES_BUDGET]
        if not fits:
            raise SystemExit(f"{bundle.arch} {GNN_SAMPLED_SHAPE}: even "
                             f"{GNN_SEED_STEP} seeds reckon "
                             f"{reckon(GNN_SEED_STEP):,} B")
        out["seeds"] = fits[-1]
        out["cut_bytes"] = reckon(fits[-1])
    return out


def drive_gnn_train(bundle, shape: str, dev, bi, fd, *, batch=None) -> dict:
    """Phase 5d.7: GNN_STEPS train steps of `shape` (seed-0 inputs, cut to
    `batch` seeds or molecules when given) after a warm one, on one batch:
    losses finite, parameters changed, no kernel launched; ms a step, peak
    memory, model_flops over the time as a share of the float32 peak."""
    from repro_torch.config import GNN_SHAPES
    t0 = time.perf_counter()
    inputs = bundle.make_inputs(shape, seed=0, batch=batch)
    sync(dev)
    make_s = time.perf_counter() - t0
    model = bundle.init_fn_for(shape)(0)
    params = dict(model.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    state = bundle.optimizer.init(params)
    step_fn = bundle.steps[GNN_SHAPES[shape]["kind"]]
    losses = []

    def step():
        nonlocal state
        _, state, met = step_fn(model, state, inputs)
        losses.append(float(met["loss"]))
    reset_peak(dev)
    reset_kernel_launches(bi, fd)
    ms = timed_ms(step, dev, 1 + GNN_STEPS)
    counts = kernel_launch_counts(bi, fd)
    peak = peak_bytes(dev)
    changed = sum(int(not torch.equal(p.detach(), before[k]))
                  for k, p in params.items())
    where = f"{bundle.arch} {shape}"
    require_no_launches(where, counts)
    if not (np.isfinite(losses).all() and changed > 0):
        raise SystemExit(f"{where}: losses {losses}, {changed} of "
                         f"{len(params)} parameters changed")
    warm = float(np.median(ms[1:]))
    flops = bundle.model_flops(shape, batch=batch)
    n, e = inputs["node_mask"].shape[0], inputs["edge_mask"].shape[0]
    t = inputs["t_kj"].shape[0] if "t_kj" in inputs else None
    return {"shape": shape, "batch": batch, "nodes": n, "edges": e,
            "triplets": t,
            "reckoned_bytes": gnn_bytes(bundle.cfg, n, e, t or 0),
            "make_inputs_s": make_s, "losses": losses, "ms": ms,
            "ms_per_step": warm, "model_flops": flops,
            "f32_peak_share": flops / (warm / 1e3) / hw()["flops_f32"],
            "parameters": sum(p.numel() for p in params.values()),
            "changed_leaves": changed, "peak_bytes": peak,
            "launches": counts}


def check_gnn_reduced(build_bundle, arch: str, shape: str, dev) -> dict:
    """Phase 5d.8: `arch`'s reduced model on `shape` in float32, card
    against CPU: one train step (`held_train_step`: loss, gradients,
    the AdamW update)."""
    from repro_torch.config import GNN_SHAPES
    cpu = build_bundle(arch, reduced=True, device="cpu")
    card = build_bundle(arch, reduced=True, device=dev)
    m_cpu = cpu.init_fn_for(shape)(0)
    m_card = card.init_fn_for(shape)(1)
    m_card.load_state_dict(m_cpu.state_dict())
    batch = cpu.make_inputs(shape, seed=0)
    batch_card = {k: v.to(dev) for k, v in batch.items()}
    kind = GNN_SHAPES[shape]["kind"]
    return held_train_step(
        cpu, card, m_cpu, m_card,
        lambda m, s: cpu.steps[kind](m, s, batch),
        lambda m, s: card.steps[kind](m, s, batch_card),
        f"reduced {arch} {shape}")


def run_phase_5d(dev, card: str) -> dict:
    """Phase 5d: bert4rec and the four GNNs (module docstring). Returns
    each path's kernel launches (all 0) under "launches"."""
    from repro_torch.config import GNN_SHAPES
    from repro_torch.kernels import bitmap_intersect as bi
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch import serve
    from repro_torch.models.api import build_bundle
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    res = {"launches": {}}
    res["launcher"] = drive_recsys_launcher(serve, bi, fd)
    res["launches"]["bert4rec serve --arch"] = res["launcher"]["launches"]
    print(f"serve --arch {RECSYS_ARCH} on the card: "
          + json.dumps(res["launcher"]), flush=True)
    res["recsys_reduced"] = check_recsys_reduced(build_bundle, dev)
    print(f"reduced {RECSYS_ARCH} on the card against the CPU, float32: "
          + json.dumps(res["recsys_reduced"]), flush=True)

    bundle = build_bundle(RECSYS_ARCH, device=dev)
    model = bundle.init_fn(0)
    cfg = bundle.cfg
    print(f"{RECSYS_ARCH}: embed {cfg.embed_dim}, {cfg.n_blocks} blocks, "
          f"{cfg.n_heads} heads, seq {cfg.seq_len}, {cfg.n_items:,} items; "
          f"{sum(p.numel() for p in model.parameters()):,} parameters in "
          "float32", flush=True)
    for key, fn in (
            ("serve_p99", lambda: drive_recsys_serve(
                bundle, model, "serve_p99", dev)),
            ("retrieval_cand", lambda: drive_recsys_retrieval(
                bundle, model, dev)),
            ("serve_bulk", lambda: drive_recsys_serve(
                bundle, model, "serve_bulk", dev, batch=RECSYS_BULK_BATCH,
                held_rows=RECSYS_HELD_BULK_ROWS))):
        reset_kernel_launches(bi, fd)
        r = fn()
        r["launches"] = kernel_launch_counts(bi, fd)
        require_no_launches(f"{RECSYS_ARCH} {key}", r["launches"])
        res[key] = r
        res["launches"][f"{RECSYS_ARCH} {key}"] = r["launches"]
        print(f"recsys {key} " + json.dumps(r), flush=True)
        per = r.get("ms_per_batch", r.get("ms_per_query"))
        rate = (f", {r['queries_per_s']:.0f} queries/s"
                if "queries_per_s" in r else "")
        print(f"{RECSYS_ARCH} {key} on {card}: batch {r['batch']}, "
              f"{per:.3f} ms (median of {RECSYS_TIMED_CALLS}, warm){rate}",
              flush=True)
    del model
    torch.cuda.empty_cache()
    reset_kernel_launches(bi, fd)
    tr = drive_recsys_train(build_bundle, dev)
    tr["launches"] = kernel_launch_counts(bi, fd)
    require_no_launches(f"{RECSYS_ARCH} train_batch", tr["launches"])
    res["train_batch"] = tr
    res["launches"][f"{RECSYS_ARCH} train_batch"] = tr["launches"]
    print("recsys train_batch " + json.dumps(tr), flush=True)
    print(f"{RECSYS_ARCH} train_batch on {card}: batch {tr['batch']} (cut "
          f"from {tr['batch_cut_from']}), batch_chunk {tr['batch_chunk']}, "
          f"{tr['ms_per_step']:.1f} ms a step (median of {RECSYS_STEPS}), "
          f"{tr['masked_items_per_s']:.0f} masked items/s, "
          f"{100 * tr['f32_peak_share']:.2f} % of the float32 peak "
          f"({hw()['flops_f32'] / 1e12:.0f} TFLOP/s, NVIDIA data sheet), "
          f"peak memory {tr['peak_bytes']:,} B", flush=True)
    torch.cuda.empty_cache()

    res["gnn"] = {}
    for arch in GNN_ARCHS:
        ta = time.perf_counter()
        gb = build_bundle(arch, device=dev)
        out = {"reduced": {}}
        for shape in GNN_TRAIN_SHAPES:
            out["reduced"][shape] = check_gnn_reduced(build_bundle, arch,
                                                      shape, dev)
        print(f"reduced {arch} on the card against the CPU, float32: "
              + json.dumps(out["reduced"]), flush=True)
        reck = reckon_sampled(gb)
        out["minibatch_lg_reckoning"] = reck
        seeds = reck["seeds"]
        print(f"{arch} {GNN_SAMPLED_SHAPE}: reckoned {reck['bytes']:,} B "
              f"uncut (budget {GNN_BYTES_BUDGET:,.0f} B)"
              + (f", {reck['cut_bytes']:,} B at {seeds} of "
                 f"{reck['seeds_cut_from']} seeds" if seeds else ""),
              flush=True)
        for shape in GNN_TRAIN_SHAPES + (GNN_SAMPLED_SHAPE,):
            r = drive_gnn_train(gb, shape, dev, bi, fd,
                                batch=seeds if shape == GNN_SAMPLED_SHAPE
                                else None)
            out[shape] = r
            res["launches"][f"{arch} {shape}"] = r["launches"]
            print(f"gnn {arch} {shape} " + json.dumps(r), flush=True)
            print(f"{arch} {shape} on {card}: {r['nodes']:,} nodes, "
                  f"{r['edges']:,} edges"
                  + (f", {r['triplets']:,} triplets" if r["triplets"]
                     else "")
                  + (f" ({r['batch']} seeds)" if r["batch"] else "")
                  + f", {r['ms_per_step']:.1f} ms a step (median of "
                  f"{GNN_STEPS}), {100 * r['f32_peak_share']:.2f} % of the "
                  f"float32 peak ({hw()['flops_f32'] / 1e12:.0f} TFLOP/s, "
                  f"NVIDIA data sheet) by model_flops, peak memory "
                  f"{r['peak_bytes']:,} B (reckoned "
                  f"{r['reckoned_bytes']:,} B)", flush=True)
            torch.cuda.empty_cache()
        out["seconds"] = time.perf_counter() - ta
        res["gnn"][arch] = out
        print(f"phase 5d {arch} in {out['seconds']:.3f} s", flush=True)
    res["seconds"] = time.perf_counter() - t0
    print(f"phase 5d in {res['seconds']:.3f} s", flush=True)
    return res


# ---------------------------------------------------------- examples phase
# The port's five examples (`examples/torch_*.py`), each `main` called in
# process at its documented defaults, on the card (no --device); runs
# after phase 5d and before phase 5e, which needs the card free.
EXAMPLE_RUNS = (
    ("torch_quickstart", ()),
    ("torch_match_queries", ()),
    ("torch_match_queries dblp", ("--dataset", "dblp", "--scale", "1.0")),
    ("torch_serve_recsys", ()),
    ("torch_train_lm", ()),
    ("torch_gnn_train", ()),
)
# the match examples launch the auto route's bitmap kernels, the model
# examples none of the kernels line's
MATCH_EXAMPLES = ("torch_quickstart", "torch_match_queries")
# train_lm's --steps in the phase: None keeps its default (200); set it only
# if those steps push the phase past about 120 s, and the phase prints it
EXAMPLES_TRAIN_LM_STEPS = None


def load_example(name: str):
    """examples/<name>.py as a module."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def held_quickstart(r: dict, mod, cemr_match) -> dict:
    """The Fig. 1 count against the port's `cemr_match`; the 2k-vertex
    graph's two engines must agree."""
    data, query = mod.fig1_graphs()
    want = cemr_match(query, data).count
    if r["fig1_count"] != want or len(r["embeddings"]) != want \
            or r["ref_count"] != r["vec_count"]:
        raise SystemExit(f"torch_quickstart on the card: Fig. 1 count "
                         f"{r['fig1_count']} ({len(r['embeddings'])} "
                         f"streamed) against cemr_match's {want}; 2k graph "
                         f"ref {r['ref_count']}, vec {r['vec_count']}")
    return {"fig1_count": want, "ref_count": r["ref_count"],
            "vec_count": r["vec_count"], "vec_tiles": r["vec_tiles"],
            "cache_info": str(r["cache_info"])}


def held_match_queries(r: dict, api, cemr_match, dev, direct: bool) -> dict:
    """Every query's count from the queue against `cemr_match` (numpy,
    host) at the example's limit, or with `direct`, against a fresh
    Matcher's `count` of the same query on the card."""
    m = api.Matcher(r["dataset"], device=dev) if direct else r["matcher"]
    got, want = [], []
    for i, q in enumerate(r["queries"]):
        got.append(r["results"][i])
        if direct:
            want.append(m.count(q, engine="vector", limit=r["limit"]).count)
        else:
            cq = m.compile(q)
            want.append(cemr_match(q, r["dataset"].graph, limit=r["limit"],
                                   preprocessed=(cq.cs, cq.an)).count)
    if got != want or r["stats"]["failed"]:
        raise SystemExit(f"torch_match_queries on {r['dataset']!r}: queue "
                         f"counts {got} against "
                         f"{'Matcher.count' if direct else 'cemr_match'} "
                         f"{want}, stats {r['stats']}")
    return {"queries": len(got), "embeddings": sum(got),
            "held_against": "Matcher.count" if direct else "cemr_match",
            "stats": r["stats"]}


def held_serve_recsys(r: dict, build_bundle) -> dict:
    """The example's model copied to the bundle's plain CPU run: each
    batch's top-10 on the card and on the CPU held against the CPU's
    float64 recompute (`held_top_k`, TRAIN_F32_RTOL: the same items
    wherever the 10th and 11th scores are clearly apart), and the
    retrieval scores within TRAIN_F32_RTOL of the largest."""
    cpu = build_bundle(RECSYS_ARCH, reduced=True, device="cpu")
    model = cpu.init_fn(1)
    model.load_state_dict({k: v.cpu() for k, v in
                           r["model"].state_dict().items()})
    rows_equal = 0
    for s, (vals, idx) in enumerate(r["top"]):
        batch = cpu.make_inputs("serve_p99", seed=s)
        want64 = scores64(model, batch["ids"], model.embed.table.detach())
        vals_c, idx_c = cpu.steps["serve"](model, batch)
        for where, (v, i) in (("card", (vals.cpu(), idx.cpu())),
                              ("cpu", (vals_c, idx_c))):
            held_top_k(v, i, want64, TRAIN_F32_RTOL,
                       f"torch_serve_recsys batch {s} on the {where}")
        rows_equal += int((idx.cpu().long() == idx_c.long()).all(-1).sum())
    scores = cpu.steps["retrieval"](model,
                                    cpu.make_inputs("retrieval_cand"))
    got = r["retrieval_scores"].cpu()
    err = float((got - scores).abs().max() / scores.abs().max())
    if got.shape != scores.shape or not err <= TRAIN_F32_RTOL:
        raise SystemExit(f"torch_serve_recsys retrieval: {tuple(got.shape)} "
                         f"scores {err:.3g} of the largest from the CPU's")
    return {"batches": len(r["top"]), "rows": len(r["top"]) * r["batch"],
            "rows_equal_in_order": rows_equal, "retrieval_rel_err": err,
            "requests_per_s": r["requests_per_s"]}


def run_phase_examples(dev, card: str) -> dict:
    """The examples phase (module docstring): each run of EXAMPLE_RUNS
    with the launch counts set to 0 just before its `main` and read just
    after, the match examples' bitmap launches once per boundary or
    extend they covered (`PathCalls`), the model examples' none; then
    each run's results held. Returns each run's seconds, launches (by
    kernel, and by width for the width-taking wrappers) and checks."""
    from repro_torch import api
    from repro_torch.core import bitops as bitops_mod
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import scheduler as sched_mod
    from repro_torch.core.ref_engine import cemr_match
    from repro_torch.kernels import bitmap_intersect as bi
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.api import build_bundle
    t0 = time.perf_counter()
    out = {"runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for key, argv in EXAMPLE_RUNS:
            name = key.split()[0]
            mod = load_example(name)
            argv = list(argv)
            if name == "torch_match_queries":
                argv += ["--state-path",
                         os.path.join(tmp, f"{key.replace(' ', '_')}.json")]
            if name == "torch_train_lm":
                argv += ["--ckpt-dir", os.path.join(tmp, "train_lm")]
                if EXAMPLES_TRAIN_LM_STEPS is not None:
                    argv += ["--steps", str(EXAMPLES_TRAIN_LM_STEPS)]
                    print(f"examples phase: torch_train_lm cut to "
                          f"{EXAMPLES_TRAIN_LM_STEPS} steps (default 200)",
                          flush=True)
            calls = PathCalls(engine_mod, bitops_mod, sched_mod)
            sync(dev)
            ta = time.perf_counter()
            reset_kernel_launches(bi, fd)
            with calls:
                r = mod.main(argv)
            sync(dev)
            launches = kernel_launch_counts(bi, fd)
            by_width = launches_by_width(bi)
            secs = time.perf_counter() - ta
            where = f"example {key}"
            if name in MATCH_EXAMPLES:
                require_path_launches(where, {k: launches[k] for k in
                                              launch_counts(bi)},
                                      calls.calls)
                if any(launches[fn.__name__] for fn in fd.WRAPPERS):
                    raise SystemExit(f"{where} launched {launches}")
            else:
                require_no_launches(where, launches)
            if name == "torch_quickstart":
                held = held_quickstart(r, mod, cemr_match)
            elif name == "torch_match_queries":
                held = held_match_queries(r, api, cemr_match, dev,
                                          direct=key != name)
            elif name == "torch_serve_recsys":
                held = held_serve_recsys(r, build_bundle)
            elif name == "torch_train_lm":
                held = {k: r[k] for k in ("steps_run", "restarts",
                                          "first_loss", "last_loss",
                                          "ms_per_step")}
            else:
                held = {k: r[k] for k in ("arch", "shape", "ms_per_step")}
                held.update(first_loss=r["losses"][0],
                            last_loss=r["losses"][-1])
            out["runs"][key] = {"argv": argv, "seconds": secs,
                                "launches": launches,
                                "launches_by_width": by_width,
                                "path_calls": dict(calls.calls),
                                "held": held}
            print(f"example {key} on {card}: {secs:.3f} s, launches "
                  f"{launches}; " + json.dumps(held), flush=True)
            del r
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"examples phase in {out['seconds']:.3f} s", flush=True)
    return out


def examples_launches(row: dict, ex: dict) -> dict:
    """A kernels-line row's entry for each run of the examples phase: the
    run's seconds and the row's kernel's launches in it, at the row's
    width where its wrapper takes one."""
    out = {}
    for key, r in ex["runs"].items():
        by_width = r["launches_by_width"].get(row["name"])
        n = (by_width[row["words_per_block"]]
             if by_width is not None and "words_per_block" in row
             else r["launches"][row["name"]])
        out[key] = {"launches": n, "seconds": r["seconds"]}
    return out


# ---------------------------------------------------------------- phase 5e
# Phase 5e, placement: one rank a visible card (NCCL), a (data, model)
# mesh of them ((1, 1) on one card, (2, 2) on four), the port's policy,
# sharding context and sharded decode cache on qwen2-1.5b at full width,
# and the CEMR engine cell at the reference's default size.
PLACE_TRAIN_STEPS = 1             # timed bf16 steps after the held float32 one
PLACE_DECODE_STEPS = 3
# the held train step runs in float32 (TF32 off): the sharded step sums
# the same products in another order, across ranks
PLACE_LOSS_RTOL, PLACE_GNORM_RTOL = 1e-5, 1e-4
# the decode is held twice. With float32 activations over a bf16 cache
# (the "cuda_core" route) the sharded route merges its blocks' float32
# partials in another order than the whole-cache kernel's chunks (~1e-6
# relative), and a cache entry written from activations that differ in
# the last bits may round to the neighbouring bf16 (2^-9 relative):
# PLACE_LOGITS_ATOL against the whole-cache kernel's run. With bf16
# activations (the "tensor_core" route, as decode runs in use) every
# layer's attention output rounds to bf16 and that noise grows over 28
# layers (0.13 in the logits on four cards), so no fixed atol holds it:
# the sharded run's logits must be at most PLACE_BF16_RATIO times as far
# from the plain attention's bf16 run as the whole-cache kernel's run is
# (phase 2's rule), or within PLACE_LOGITS_ATOL of it. Each partials and
# merge call of that run is held against its plain version on its own
# inputs.
PLACE_LOGITS_ATOL = 5e-3
PLACE_BF16_RATIO = 2.0
ENGINE_CELL = {"frontier_rows": 65_536, "space": 262_144, "k_bwd": 3}
# each GNN's placed step at its published width, on the shape phase 5d
# runs it faster of molecule and full_graph_sm (phase 5d on the H100:
# dimenet 278 ms against 2,273 on molecule, equiformer-v2 925 against 952;
# gatedgcn's and nequip's both under 0.2 s), float32, TF32 off: held
# against the undistributed step by PLACE_LOSS_RTOL / PLACE_GNORM_RTOL
PLACE_GNN_SHAPES = {"gatedgcn": "molecule", "nequip": "molecule",
                    "dimenet": "full_graph_sm",
                    "equiformer-v2": "full_graph_sm"}
PLACE_TIMEOUT_S = 900
# the dry runs start together on the host and must all end within this:
# qwen2's train_4k traces in ~200–280 s on the H100 machine's host; a GNN
# cell, each at molecule, the shape cheapest to trace (the fewest edges
# and triplets)
DRYRUN_TIMEOUT_S = 400
DRYRUN_GNN_SHAPE = "molecule"


def _place_model(n: int) -> int:
    """The model axis of n ranks: 2 when n is a multiple of 4, else 1."""
    return 2 if n % 4 == 0 else 1


def _train_step_held(bundle, mesh, batch, dev) -> dict:
    """One float32 train_4k step of a fresh model from seed 0 on `batch`
    (then PLACE_TRAIN_STEPS bf16 steps, the last timed): undistributed
    with `mesh` None, else distributed by the policy in its sharding
    context. Returns losses, gnorms, the timed ms and wi's shapes."""
    from repro_torch.distributed import policy
    from repro_torch.distributed.sharding import sharding_ctx, to_placements
    from torch.distributed.tensor import distribute_tensor
    model = bundle.init_fn(0)
    tokens = batch["tokens"]
    ctx = contextlib.nullcontext
    if mesh is not None:
        policy.distribute_model(model, bundle.cfg, mesh)
        spec = policy.batch_pspecs("lm", "train", mesh,
                                   batch=tokens.shape[0])["tokens"]
        tokens = distribute_tensor(tokens, mesh, to_placements(spec, mesh),
                                   src_data_rank=None)
        rules = policy.activation_rules(bundle.cfg, mesh, "train",
                                        batch=tokens.shape[0])
        ctx = functools.partial(sharding_ctx, mesh, rules)
    state = bundle.optimizer.init(dict(model.named_parameters()))
    out = {"loss": [], "gnorm": [], "ms": []}
    for i in range(1 + PLACE_TRAIN_STEPS):
        dtype = torch.float32 if i == 0 else torch.bfloat16
        sync(dev)
        t0 = time.perf_counter()
        with ctx():
            _, state, m = bundle.steps["train"](model, state,
                                                {"tokens": tokens},
                                                dtype=dtype)
        out["loss"].append(float(m["loss"]))
        out["gnorm"].append(float(m["gnorm"]))
        sync(dev)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
    wi = model.blocks[0].ffn.wi.w
    out["wi_shape"] = list(wi.shape)
    from torch.distributed.tensor import DTensor
    local = wi.to_local() if isinstance(wi, DTensor) else wi
    out["wi_local_shape"] = list(local.shape)
    del model, state
    return out


def _gnn_step(bundle, shape: str, mesh, batch, dev) -> dict:
    """One float32 train step of `shape` on `batch` from a fresh model of
    seed 0: undistributed with `mesh` None, else with the parameters and
    the batch placed by the policy (nodes, edges and triplets split over
    `mesh` flattened to one dim, parameters whole) in its sharding
    context."""
    from repro_torch.config import GNN_SHAPES
    from repro_torch.distributed import policy
    from repro_torch.distributed.sharding import sharding_ctx
    kind = GNN_SHAPES[shape]["kind"]
    model = bundle.init_fn_for(shape)(0)
    ctx = contextlib.nullcontext
    if mesh is not None:
        mesh = policy.placement_mesh("gnn", mesh)
        policy.distribute_model(model, bundle.cfg, mesh)
        batch = policy.distribute_inputs(batch, mesh, "gnn")
        ctx = functools.partial(sharding_ctx, mesh, policy.activation_rules(
            bundle.cfg, mesh, kind))
    state = bundle.optimizer.init(dict(model.named_parameters()))
    sync(dev)
    t0 = time.perf_counter()
    with ctx():
        _, state, m = bundle.steps[kind](model, state, batch)
    loss, gnorm = float(m["loss"]), float(m["gnorm"])
    sync(dev)
    out = {"loss": loss, "gnorm": gnorm,
           "ms": (time.perf_counter() - t0) * 1e3}
    if mesh is not None:
        out["placements"] = [str(p) for p in batch["edge_src"].placements]
    del model, state
    return out


def _gnn_held(mesh, dev, reduced: bool) -> dict:
    """Each GNN of GNN_ARCHS on its PLACE_GNN_SHAPES shape: one step
    undistributed, then one placed on `mesh`, loss and gnorm held within
    PLACE_LOSS_RTOL / PLACE_GNORM_RTOL; no kernel launched (counts set to 0
    just before and read just after)."""
    from repro_torch.kernels import bitmap_intersect as bi
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.api import build_bundle
    out = {}
    for arch in GNN_ARCHS:
        shape = PLACE_GNN_SHAPES[arch]
        bundle = build_bundle(arch, reduced=reduced, device=dev)
        batch = bundle.make_inputs(shape, seed=0)
        reset_kernel_launches(bi, fd)
        plain = _gnn_step(bundle, shape, None, batch, dev)
        release(dev)
        placed = _gnn_step(bundle, shape, mesh, batch, dev)
        launches = kernel_launch_counts(bi, fd)
        del batch
        release(dev)
        require_no_launches(f"placed {arch} {shape}", launches)
        for key, tol in (("loss", PLACE_LOSS_RTOL),
                         ("gnorm", PLACE_GNORM_RTOL)):
            a, b = placed[key], plain[key]
            if not abs(a - b) <= tol * abs(b):
                raise SystemExit(f"placed {arch} {shape} train step {key} "
                                 f"{a} against {b}, rtol {tol}")
        out[arch] = {"shape": shape, "plain": plain, "placed": placed,
                     "launches": launches}
    return out


def merge_agrees(got, want, where: str) -> float:
    """flash_decode_merge's output against its plain version's: finite,
    and each element within FD_TOL's rtol of its row's largest magnitude
    (a decode over caches that are zero but for a few rows gives small
    outputs, which an absolute tolerance would not hold). Returns the
    largest absolute difference; raises SystemExit otherwise."""
    rtol = FD_TOL[want.dtype][1]
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    scale = want.abs().amax(-1, keepdim=True)
    if not (bool(torch.isfinite(got).all())
            and bool((diff <= rtol * scale).all())):
        raise SystemExit(f"flash_decode_merge disagrees: {where} "
                         f"max_abs_err={float(diff.max())}")
    return float(diff.max())


def held_sharded_decode(ref, run) -> dict:
    """Runs `run()` with every `flash_decode_partials` and
    `flash_decode_merge` call of the sharded decode route
    (`nn.attention`'s names) held against its plain version on that
    call's own inputs. Returns the calls held and the largest difference
    of each kernel."""
    from repro_torch.nn import attention
    orig = attention.flash_decode_partials, attention.flash_decode_merge
    held = {"calls": 0, "partials_max_abs_err": 0.0,
            "merge_max_abs_err": 0.0}

    def partials(q, k, v, lengths, offset):
        got = orig[0](q, k, v, lengths, offset)
        err = partials_agree(
            got, ref.flash_decode_partials_ref(q, k, v, lengths, offset),
            f"sharded decode call {held['calls']}, block "
            f"{tuple(k.shape)} at {offset}")
        held["partials_max_abs_err"] = max(held["partials_max_abs_err"], err)
        return got

    def merge(parts, dtype):
        got = orig[1](parts, dtype)
        err = merge_agrees(got, ref.flash_decode_merge_ref(parts, dtype),
                           f"sharded decode call {held['calls']}, "
                           f"{tuple(parts.shape)}")
        held["merge_max_abs_err"] = max(held["merge_max_abs_err"], err)
        held["calls"] += 1
        return got

    attention.flash_decode_partials, attention.flash_decode_merge = \
        partials, merge
    try:
        run()
    finally:
        attention.flash_decode_partials, attention.flash_decode_merge = orig
    return held


def _decode_held(bundle, model, mesh, inputs, seq: int, dev) -> dict:
    """PLACE_DECODE_STEPS decode steps from zero caches of `seq` positions,
    each step's tokens the float32 whole-cache run's argmax; the model's
    weights are float32, the caches bf16. Float32 activations: the
    whole-cache run (plain caches, flash_decode), then the phase's main
    path, the run whose caches are DTensors placed by `cache_bsnd` in the
    decode rules' sharding context (each rank's flash_decode_partials,
    the gather, flash_decode_merge), its launches counted. bf16
    activations: the plain attention's and the kernel's whole-cache runs,
    then the sharded run with each partials and merge call held
    (`held_sharded_decode`). Returns the logits differences a step, the
    sharded run's ms and launches and layer 0's timing."""
    from repro_torch.distributed import policy
    from repro_torch.distributed.sharding import full, sharding_ctx
    from repro_torch.kernels import bitmap_intersect as bi
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    b = inputs["token"].shape[0]
    rules = policy.activation_rules(bundle.cfg, mesh, "decode", batch=b)
    step = bundle.steps["decode"]
    feeds = [dict(inputs)]

    def run(dtype, *, placed=False, ms=None, keep=False, **kw):
        ctx = (functools.partial(sharding_ctx, mesh, rules) if placed
               else contextlib.nullcontext)
        with ctx():
            caches = bundle.init_caches(b, seq)
        out = []
        for i in range(PLACE_DECODE_STEPS):
            sync(dev)
            t0 = time.perf_counter()
            with ctx():
                logits, caches = step(model, caches, feeds[i], dtype=dtype,
                                      **kw)
            logits = full(logits).float()
            sync(dev)
            if ms is not None:
                ms.append((time.perf_counter() - t0) * 1e3)
            if len(feeds) == i + 1:
                feeds.append({"token": torch.argmax(logits, -1)
                              .to(torch.int32),
                              "lengths": feeds[i]["lengths"] + 1})
            out.append(logits)
        if keep:
            return out, caches
        del caches
        release(dev)
        return out

    def errs(got, want):
        return [float((g - w).abs().max()) for g, w in zip(got, want)]

    want = run(torch.float32)
    reset_kernel_launches(bi, fd)
    ms = []
    got, caches = run(torch.float32, placed=True, ms=ms, keep=True)
    launches = kernel_launch_counts(bi, fd)
    placements = [str(p) for p in caches["k"].placements]
    layer = time_sharded_layer(bundle.cfg, caches, feeds[-1]["lengths"],
                               dev) if dev.type == "cuda" else None
    del caches
    release(dev)
    out = {"batch": b, "seq": seq, "cache_placements": placements,
           "max_abs_err": errs(got, want), "ms": ms, "launches": launches,
           "layer": layer}
    plain = run(torch.bfloat16, use_kernel=False)
    whole = run(torch.bfloat16)
    placed = []
    held = held_sharded_decode(ref, lambda: placed.extend(
        run(torch.bfloat16, placed=True)))
    out["bf16"] = {"whole_kernel_vs_plain": errs(whole, plain),
                   "sharded_vs_plain": errs(placed, plain),
                   "sharded_vs_whole_kernel": errs(placed, whole),
                   "held": held}
    return out


def time_sharded_layer(cfg, caches, lengths, dev) -> dict:
    """Layer 0 of a placed decode cache, by CUDA events (`median_ms`;
    every rank times in step, the gathers being collectives): the
    sharded route (the new row's write, `flash_decode_partials` on this
    rank's block, the gather, `flash_decode_merge`) against
    `flash_decode` over the layer's whole cache. Seeded q and new rows,
    bf16."""
    from repro_torch.distributed.sharding import full
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.nn.attention import sharded_gqa_decode
    gen = torch.Generator(device=dev).manual_seed(3)
    b = lengths.shape[0]

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    q = draw(b, cfg.n_heads, cfg.head_dim)
    k_new, v_new = (draw(b, cfg.n_kv_heads, cfg.head_dim) for _ in "kv")
    kd, vd = caches["k"][0], caches["v"][0]
    k_whole, v_whole = full(kd), full(vd)
    whole = median_ms(lambda: fd.flash_decode(q, k_whole, v_whole,
                                              lengths + 1))
    placed = median_ms(lambda: sharded_gqa_decode(q, k_new, v_new, kd, vd,
                                                  lengths, like=q))
    return {"flash_decode_whole_ms": whole, "sharded_ms": placed,
            "local_cache": list(kd.to_local().shape),
            "whole_cache": list(kd.shape)}


def int_err(got, want) -> int:
    """The largest |got - want| of two integer tensors, 0 when equal."""
    ne = got != want
    if not bool(ne.any()):
        return 0
    return int((got[ne].long() - want[ne].long()).abs().max())


def _engine_held(mesh, dev, cell: dict) -> dict:
    """The engine cell on `mesh`: seeded tables and rows, each rank's
    bitmap_intersect on its local shards and the popcount all-reduce over
    model (`dryrun.engine_extend`, launches counted, bitmap_intersect's by
    width too), held bit for bit against the plain version
    (`bitmap_intersect_ref`) over the whole tables on this card; and
    bitmap_intersect over the whole tables at every width, each held
    against the plain version (its own max_abs_err) and against the
    path's result. Keys by width are strings: the rank's result goes
    through JSON."""
    from repro_torch.kernels import bitmap_intersect as bi
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    from repro_torch.launch import dryrun
    tables, idxs = dryrun.engine_inputs(mesh, seed=7, device=dev, **cell)
    reset_kernel_launches(bi, fd)
    sync(dev)
    t0 = time.perf_counter()
    r, pop = dryrun.engine_extend(tables, idxs)
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    launches = kernel_launch_counts(bi, fd)
    by_width = {str(wpb): n
                for wpb, n in bi.bitmap_intersect.launches_by_width.items()}
    r, pop = r.full_tensor(), pop.full_tensor().reshape(-1)
    whole = [t.full_tensor() for t in tables]
    idx_whole = idxs.full_tensor()
    want_r, want_pop = ref.bitmap_intersect_ref(whole, idx_whole)
    want_pop = want_pop.reshape(-1)
    err = max(int_err(r, want_r), int_err(pop, want_pop))
    same_kernel, width_err = {}, {}
    for wpb in bi.FUSED_TILE_WIDTHS:
        got_r, got_pop = bi.bitmap_intersect(whole, idx_whole,
                                             words_per_block=wpb)
        got_pop = got_pop.reshape(-1)
        width_err[str(wpb)] = max(int_err(got_r, want_r),
                                  int_err(got_pop, want_pop))
        same_kernel[str(wpb)] = bool(torch.equal(r, got_r)) and bool(
            torch.equal(pop, got_pop))
        del got_r, got_pop
    del want_r, want_pop
    out = {"tables": [list(t.shape) for t in tables],
           "local_tables": [list(t.to_local().shape) for t in tables],
           "rows": list(idxs.shape), "max_abs_err": err,
           "max_abs_err_by_width": width_err,
           "equals_whole_kernel": same_kernel,
           "bit_identical": (err == 0 and not any(width_err.values())
                             and all(same_kernel.values())), "ms": ms,
           "launches": launches, "launches_by_width": by_width}
    del whole, r
    if dev.type == "cuda":
        out["timing"] = time_engine_shard(bi, [t.to_local() for t in tables],
                                          idxs.to_local())
    del tables
    return out


def time_engine_shard(bi, tables, idxs) -> dict:
    """bitmap_intersect on this rank's shards of the engine cell at every
    word-block width (CUDA events, `median_ms`) beside its plain version,
    which has no width; the bound is the bytes the call must move (each
    table row it gathers, R, idxs and pop, once) over the card's HBM rate.
    The default width's time stays at the top level, every width's is
    under "by_width", keyed by the width as a string (the result goes
    through JSON)."""
    from repro_torch.kernels import ref
    t, k = idxs.shape
    w = tables[0].shape[1]
    moved = 4 * (t * k * w + t * w + t * k + t)
    by_width = {str(wpb): {"ms": median_ms(lambda: bi.bitmap_intersect(
        tables, idxs, words_per_block=wpb))} for wpb in bi.FUSED_TILE_WIDTHS}
    return {**by_width[str(bi.DEFAULT_WORDS_PER_BLOCK)], "by_width": by_width,
            "plain_ms": median_ms(lambda: ref.bitmap_intersect_ref(tables,
                                                                   idxs)),
            "bytes": moved, "bound_ms": moved / hw()["hbm_bw"] * 1e3,
            "shape": {"T": t, "k": k, "W": w, "S": tables[0].shape[0]}}


def engine_kernel_rows(bi, place: dict) -> list:
    """The kernels line's rows of `bitmap_intersect`, one a width, from
    phase 5e's engine cell: its launches at that width on the phase's
    path (the cell calls it at the default width), its difference from the
    plain version at that width over the whole tables, whether it equals
    the path's result, and its time at the rank's shard."""
    eng = place["engine"]
    tm = eng["timing"]
    return [{"name": "bitmap_intersect", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/bitmap_intersect.cu",
             "replaces": "src/repro/kernels/bitmap_intersect.py:88",
             "words_per_block": wpb,
             "launches": eng["launches_by_width"][str(wpb)],
             "max_abs_err": eng["max_abs_err_by_width"][str(wpb)],
             "equals_the_path_bit_for_bit":
                 eng["equals_whole_kernel"][str(wpb)],
             "ms": tm["by_width"][str(wpb)]["ms"],
             "plain_ms": tm["plain_ms"],
             "bound_ms": tm["bound_ms"], "bound_by": "bytes",
             "library_ms": None, "shape": tm["shape"], "bytes": tm["bytes"],
             "path": "phase 5e engine cell, a rank's shard"}
            for wpb in bi.FUSED_TILE_WIDTHS]


def placement_rank(rank: int, world: int, port: int, out_dir: str,
                   reduced: bool = False) -> None:
    """One rank of phase 5e (spawned: NCCL on card `rank`; with
    `reduced`, gloo on the CPU at the reduced config, for a rehearsal).
    Writes its results to out_dir/rank<rank>.json; any failed check
    raises, which fails the spawn."""
    import datetime
    import torch.distributed as dist
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.config import LM_SHAPES
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.api import build_bundle
    from repro_torch.train import trainer
    cpu = reduced
    if not cpu:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cpu") if cpu else torch.device("cuda", rank)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(
                                seconds=PLACE_TIMEOUT_S))
    try:
        model_axis = _place_model(world)
        mesh = make_local_mesh(world // model_axis, model_axis,
                               device=dev.type)
        res = {"rank": rank, "mesh": dict(zip(mesh.mesh_dim_names,
                                              mesh.shape))}
        t0 = time.perf_counter()
        bundle = build_bundle(LM_ARCH, reduced=reduced, device=dev)
        shape = LM_SHAPES[TRAIN_SHAPE]
        seq = shape["seq_len"] if not reduced else 64
        batch = trainer.lm_token_stream(bundle.cfg.vocab, TRAIN_BATCH, seq,
                                        cycle=1, device=dev, rank=0)(0)
        plain = _train_step_held(bundle, None, batch, dev)
        release(dev)
        placed = _train_step_held(bundle, mesh, batch, dev)
        release(dev)
        for key, tol in (("loss", PLACE_LOSS_RTOL),
                         ("gnorm", PLACE_GNORM_RTOL)):
            a, b = placed[key][0], plain[key][0]
            if not abs(a - b) <= tol * abs(b):
                raise SystemExit(f"rank {rank}: placed train step {key} "
                                 f"{a} against {b}, rtol {tol}")
        if model_axis > 1 and placed["wi_local_shape"][1] * model_axis \
                != placed["wi_shape"][1]:
            raise SystemExit(f"rank {rank}: wi {placed['wi_local_shape']} "
                             f"of {placed['wi_shape']} is not sharded")
        res["train"] = {"plain": plain, "placed": placed,
                        "seconds": time.perf_counter() - t0}
        t0 = time.perf_counter()
        model = bundle.init_fn(0)
        d_shape = LM_SHAPES[DECODE_SHAPE]
        inputs = bundle.make_inputs(DECODE_SHAPE,
                                    batch=DECODE_BATCH if not reduced
                                    else 8)
        dec = _decode_held(bundle, model, mesh, inputs,
                           d_shape["seq_len"] if not reduced else 128, dev)
        del model
        release(dev)
        if max(dec["max_abs_err"]) > PLACE_LOGITS_ATOL:
            raise SystemExit(f"rank {rank}: sharded-cache decode logits "
                             f"{dec['max_abs_err']} from the whole-cache "
                             f"run, atol {PLACE_LOGITS_ATOL}")
        b16 = dec["bf16"]
        tol = max(PLACE_BF16_RATIO * max(b16["whole_kernel_vs_plain"]),
                  PLACE_LOGITS_ATOL)
        if max(b16["sharded_vs_plain"]) > tol:
            raise SystemExit(f"rank {rank}: bf16 sharded-cache decode "
                             f"logits {b16['sharded_vs_plain']} from the "
                             f"plain attention's run, the whole-cache "
                             f"kernel's {b16['whole_kernel_vs_plain']}: over "
                             f"{tol}")
        dec["seconds"] = time.perf_counter() - t0
        res["decode"] = dec
        t0 = time.perf_counter()
        cell = ENGINE_CELL if not reduced else {
            "frontier_rows": 1024, "space": 4096, "k_bwd": 3}
        eng = _engine_held(mesh, dev, cell)
        release(dev)
        if not eng["bit_identical"]:
            raise SystemExit(f"rank {rank}: the engine cell's R and pop "
                             f"differ from the plain version over the whole "
                             f"tables by {eng['max_abs_err']}, or "
                             f"bitmap_intersect's at a width by "
                             f"{eng['max_abs_err_by_width']} (equal to the "
                             f"path's: {eng['equals_whole_kernel']})")
        eng["seconds"] = time.perf_counter() - t0
        res["engine"] = eng
        t0 = time.perf_counter()
        res["gnn"] = _gnn_held(mesh, dev, reduced)
        res["gnn"]["seconds"] = time.perf_counter() - t0
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def release(dev) -> None:
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_cells() -> list:
    """(name, dryrun arguments) of phase 5e's dry runs: qwen2-1.5b x
    train_4k and one cell of each GNN on (16, 16), the engine cell on
    (2, 16, 16)."""
    return ([("qwen2-1.5b train_4k (16, 16)",
              ["--arch", LM_ARCH, "--shape", TRAIN_SHAPE])]
            + [(f"{a} {DRYRUN_GNN_SHAPE} (16, 16)",
                ["--arch", a, "--shape", DRYRUN_GNN_SHAPE])
               for a in GNN_ARCHS]
            + [("cemr-engine (2, 16, 16)", ["--engine", "--multi-pod"])])


def run_dryruns() -> list:
    """Phase 5e's dry runs on the host (`dryrun_cells`), all started
    together, each in a process group of its own, all stopped whole
    unless every one ends within DRYRUN_TIMEOUT_S. Their rows; fails
    unless each exits 0."""
    root = Path(__file__).resolve().parent
    # one thread each: they trace beside the card's ranks on a shared host
    env = {**os.environ, "PYTHONPATH": str(root / "src"),
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        try:
            for i, (name, args) in enumerate(dryrun_cells()):
                out = os.path.join(tmp, f"rows{i}.json")
                procs.append((name, out, subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     *args, "--out", out], env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True,
                    start_new_session=True)))
            deadline = time.monotonic() + DRYRUN_TIMEOUT_S
            logs = []
            for name, _, proc in procs:
                try:
                    logs.append(proc.communicate(
                        timeout=max(deadline - time.monotonic(), 1))[0])
                except subprocess.TimeoutExpired:
                    raise SystemExit(f"dry run {name} took over "
                                     f"{DRYRUN_TIMEOUT_S} s")
        finally:
            for _, _, proc in procs:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
        for (name, out, proc), log in zip(procs, logs):
            if proc.returncode != 0:
                raise SystemExit(f"dry run {name} exited {proc.returncode}:"
                                 f"\n{log[-3000:]}")
            with open(out) as f:
                rows += json.load(f)
    return rows


def require_placement_launches(launches: dict, layers: int) -> None:
    """Phase 5e's main path on each rank: a partials and a merge launch a
    layer and decode step, one bitmap_intersect, no other kernel."""
    n = layers * PLACE_DECODE_STEPS
    want = {name: 0 for name in launches}
    want.update({"flash_decode_partials": n, "flash_decode_merge": n,
                 "bitmap_intersect": 1})
    if launches != want:
        raise SystemExit(f"phase 5e launches {launches}, want {want}")


def run_phase_5e(card: str, *, dryruns: bool = True,
                 world: int | None = None, reduced: bool = False) -> dict:
    """Phase 5e, placement (see the constants above): one spawned rank a
    visible card and, with `dryruns`, the dry runs on the host beside
    them (started first: qwen2's trace is the phase's longest part).
    Returns rank 0's results, the dry-run rows and the phase's launches
    (the decode's and the engine cell's, each counted from 0)."""
    import torch.multiprocessing as mp
    from repro_torch.configs.registry import get_config
    t0 = time.perf_counter()
    if world is None:
        world = torch.cuda.device_count()
    with ThreadPoolExecutor(1) as ex, \
            tempfile.TemporaryDirectory() as tmp:
        dry = ex.submit(run_dryruns) if dryruns else None
        mp.spawn(placement_rank, args=(world, free_port(), tmp, reduced),
                 nprocs=world, join=True)
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    res = ranks[0]
    res["ranks"] = world
    res["launches"] = {k: v + res["engine"]["launches"][k]
                       for k, v in res["decode"]["launches"].items()}
    for r in ranks:
        if r["decode"]["launches"] != res["decode"]["launches"] \
                or r["engine"]["launches"] != res["engine"]["launches"]:
            raise SystemExit(f"rank {r['rank']} launched {r['decode']} "
                             f"{r['engine']}, rank 0 "
                             f"{res['launches']}")
    require_placement_launches(
        res["launches"], get_config(LM_ARCH, reduced=reduced).n_layers)
    tr, dec, eng, gnn = res["train"], res["decode"], res["engine"], \
        res["gnn"]
    print("placement " + json.dumps(res), flush=True)
    print(f"placement on {card}: mesh {res['mesh']} over {world} rank(s); "
          f"train_4k batch {TRAIN_BATCH} float32 loss "
          f"{tr['placed']['loss'][0]:.6f} against {tr['plain']['loss'][0]:.6f}"
          f", gnorm {tr['placed']['gnorm'][0]:.6f} against "
          f"{tr['plain']['gnorm'][0]:.6f}; bf16 step "
          f"{tr['placed']['ms'][-1]:.1f} ms placed, "
          f"{tr['plain']['ms'][-1]:.1f} ms plain; decode_32k batch "
          f"{dec['batch']} cache {dec['cache_placements']} logits "
          f"max_abs_err {max(dec['max_abs_err']):.4g} (bf16: sharded "
          f"{max(dec['bf16']['sharded_vs_plain']):.4g}, whole-cache kernel "
          f"{max(dec['bf16']['whole_kernel_vs_plain']):.4g} from the plain "
          f"attention's run; {dec['bf16']['held']['calls']} partials and "
          f"merge calls held), step "
          f"{dec['ms'][-1]:.1f} ms, layer 0 sharded "
          f"{(dec['layer'] or {}).get('sharded_ms')} ms against "
          f"{(dec['layer'] or {}).get('flash_decode_whole_ms')} ms whole; "
          f"engine cell bit-identical to the plain version, "
          f"{eng['ms']:.1f} ms (timed {eng.get('timing')}); launches "
          f"{res['launches']}", flush=True)
    for arch in GNN_ARCHS:
        g = gnn[arch]
        print(f"placed {arch} {g['shape']} on {card}: mesh {res['mesh']} "
              f"flattened, batch {g['placed']['placements']}, float32 loss "
              f"{g['placed']['loss']:.6f} against {g['plain']['loss']:.6f}, "
              f"gnorm {g['placed']['gnorm']:.6f} against "
              f"{g['plain']['gnorm']:.6f}; a step {g['placed']['ms']:.1f} "
              f"ms placed, {g['plain']['ms']:.1f} ms undistributed (a "
              f"first step each); launches {g['launches']}", flush=True)
    if dry is not None:
        res["dryrun"] = dry.result()
        for row in res["dryrun"]:
            print("dryrun " + json.dumps(row), flush=True)
    print(f"phase 5e in {time.perf_counter() - t0:.3f} s", flush=True)
    return res


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import api
    from repro_torch.core.ref_engine import cemr_match
    from repro_torch.core import bitops as bitops_mod
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import graph as graph_mod
    from repro_torch.core import scheduler as sched_mod
    from repro_torch.kernels import bitmap_intersect as bi
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.config import LM_SHAPES
    from repro_torch.core import filtering
    from repro_torch.launch import serve
    from repro_torch.models.api import build_bundle
    from repro_torch import runtime, streaming
    from repro_torch.runtime import queue as runtime_queue

    # the plain versions are the references: full float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    libraries = (bi.LIBRARY, fd.LIBRARY)
    with ThreadPoolExecutor(len(libraries)) as ex:
        reports = [ex.submit(ptxas_report, build, name) for name in libraries]
        for name, (lib, secs) in build_all(build, libraries).items():
            print(f"build: {lib.name} in {secs:.3f} s", flush=True)
        for report in reports:
            for line in report.result():
                print(f"ptxas: {line}", flush=True)
    print(f"build: all in {time.perf_counter() - t0:.3f} s", flush=True)
    for way, q16, kv16 in (("tensor_core", 1, 1), ("cuda_core", 1, 0)):
        smem = fd._lib().cemr_flash_decode_smem_bytes(
            128, q16, kv16, int(way == "tensor_core"))
        print(f"ptxas: split_kernel on the {way} route (q bf16={q16}, "
              f"cache bf16={kv16}, D=128): dynamic smem {smem} B",
              flush=True)

    t0 = time.perf_counter()
    errs_by_width, n_new, n_lane = {}, {}, {}
    for wpb in bi.FUSED_TILE_WIDTHS:
        e = check_kernels(bi, ref, dev, wpb)
        new_errs, n_new[wpb] = check_new_kernels(bi, ref, dev, wpb)
        e.update(new_errs)
        lane_err, n_lane[wpb] = check_lane(bi, ref, dev, wpb)
        e["tile_intersect"] = max(e["tile_intersect"], lane_err)
        errs_by_width[wpb] = e
    print(f"bitmap kernels agree with their plain versions bit for bit at "
          f"every width {bi.FUSED_TILE_WIDTHS}: cases of the new entry "
          f"points by width {n_new}, of tile_intersect's query lane "
          f"{n_lane} ({time.perf_counter() - t0:.3f} s)", flush=True)
    t0 = time.perf_counter()
    fd_errs, n_fd = check_flash_decode(fd, ref, dev)
    print(f"flash_decode agrees with its plain version in {n_fd} cases, "
          f"max_abs_err by output dtype {fd_errs} "
          f"({time.perf_counter() - t0:.3f} s)", flush=True)

    work = prepare(api, cemr_match)
    by_route, launches, widths = {}, {}, {}
    for route in ("auto", "fused"):
        t0 = time.perf_counter()
        by_route[route], launches[route], calls, widths[route] = drive(
            bi, engine_mod, bitops_mod, work, route)
        for r in by_route[route]:
            print("run " + json.dumps(r), flush=True)
        print(f"main path {route}: {len(work)} runs in "
              f"{time.perf_counter() - t0:.3f} s, launches {launches[route]}, "
              f"path calls {calls}, launches by width "
              f"{widths[route]['by_width']}", flush=True)
        check_launches(route, launches[route], calls)
        check_widths(bi, widths[route]["by_width"], widths[route]["picks"],
                     calls, route)
        widths[route]["path_by_width"] = path_by_width(
            widths[route]["by_width"], calls)
        widths[route]["sweep_launches"] = calls["sweep_launches"]
    if not widths["fused"]["sweep_launches"]:
        raise SystemExit("the fused route's engine builds swept no width on "
                         "the card")
    # one pick a fused boundary's build (the autotune's cache answers all
    # but the first of a (k, W))
    picks = {}
    for pick in widths["fused"]["picks"]:
        key = (pick["k"], pick["W"], pick["width"])
        picks[key] = picks.get(key, 0) + 1
    for (k, w, wpb), n in sorted(picks.items()):
        # the same sweep once more, outside the path's counts, to show how
        # far apart the widths' times are at the sweep's shape
        again = {x: bi._sweep_seconds(bi._sweep_inputs(k, w, dev), x, dev)
                 * 1e3 for x in bi.FUSED_TILE_WIDTHS}
        print(f"autotune on {card}: fused boundary k={k} W={w} -> "
              f"words_per_block {wpb} ({n} boundary builds); the sweep "
              f"again, ms a call: " + ", ".join(
                  f"{x}: {t:.6f}" for x, t in again.items()), flush=True)
    check_runs(by_route)
    t0 = time.perf_counter()
    forced = drive_widths(api, bi, engine_mod, bitops_mod, work,
                          by_route["fused"])
    for wpb, r in forced.items():
        print(f"fused at width {wpb} on {card}: dblp size 8 count "
              f"{r['count']} and VectorStats equal to the autotuned run, "
              f"wall {r['wall_s'] * 1e3:.1f} ms, expand_intersect by width "
              f"{r['by_width']['expand_intersect']} for "
              f"{r['path_calls']['fused']} fused boundaries", flush=True)
    print(f"forced widths in {time.perf_counter() - t0:.3f} s", flush=True)
    from repro_torch.api import options as options_mod
    mesh_res = check_mesh_auto(api, options_mod, work, by_route["auto"])
    print("mesh auto equals mesh=None on the card " + json.dumps(mesh_res),
          flush=True)

    t0 = time.perf_counter()
    dblp = next(w["matcher"].dataset for w in work
                if (w["dataset"], w["scale"]) == ("dblp", 1.0))
    sb_res = drive_superbatch(api, bi, engine_mod, bitops_mod, sched_mod,
                              dblp, cemr_match)
    print("superbatch " + json.dumps(
        {k: v for k, v in sb_res.items()
         if k not in ("matcher", "queries_list")}), flush=True)
    print(f"superbatch mix on {card}: {sb_res['queries']} queries, "
          f"median wall batch=auto {sb_res['median_s']['auto']:.4f} s "
          f"({sb_res['queries_per_s']['auto']:.2f} queries/s), batch=off "
          f"{sb_res['median_s']['off']:.4f} s "
          f"({sb_res['queries_per_s']['off']:.2f} queries/s); launches "
          f"{sb_res['launches']}, lane {sb_res['lane_launches']}, path "
          f"calls {sb_res['path_calls']} "
          f"({time.perf_counter() - t0:.3f} s)", flush=True)
    launches["superbatch"] = sb_res["launches"]
    t0 = time.perf_counter()
    union_res = drive_union(api, graph_mod, cemr_match, dev)
    print(f"union workload on {card}: " + json.dumps(union_res) +
          f" ({time.perf_counter() - t0:.3f} s)", flush=True)
    t0 = time.perf_counter()
    compat_runs = drive_compat(bi, engine_mod, bitops_mod, work)
    for r in compat_runs:
        print("compat " + json.dumps(r), flush=True)
    launches["compat"] = {name: sum(r["launches"][name] for r in compat_runs)
                          for name in compat_runs[0]["launches"]}
    print(f"compat route: {len(compat_runs)} counts in "
          f"{time.perf_counter() - t0:.3f} s, launches {launches['compat']}",
          flush=True)

    t0 = time.perf_counter()
    dblp_m = next(w["matcher"] for w in work
                  if (w["dataset"], w["scale"]) == ("dblp", 1.0))
    launcher = drive_launcher(serve, bi, engine_mod, bitops_mod, sched_mod,
                              dblp_m, cemr_match, dev)
    print("launcher " + json.dumps(launcher), flush=True)
    stream_res = drive_streaming(api, bi, streaming, runtime_queue,
                                 engine_mod, bitops_mod, filtering, dblp,
                                 cemr_match, dev)
    print("streaming " + json.dumps(stream_res), flush=True)
    runtime_res = drive_runtime(runtime, api, dblp, sb_res["queries_list"],
                                sb_res["counts"]["off"], bi, dev)
    print("runtime " + json.dumps(runtime_res), flush=True)
    launches["launcher"] = launcher["launches"]
    launches["streaming"] = stream_res["launches"]
    launches["queue_inline"] = runtime_res["queue_inline"]["launches"]
    launches["workers"] = {
        k: runtime_res["queue_pool"]["worker_launches"][k]
        + runtime_res["service_pool"]["worker_launches"][k]
        for k in runtime_res["queue_pool"]["worker_launches"]}
    ol = runtime_res["open_loop"]
    per_worker = runtime_res["queue_pool"]["device_bytes_per_worker"]
    print(f"phase 4c on {card}: launcher {launcher['queries_per_s']:.2f} "
          f"queries/s; count_delta {stream_res['identity_outcomes']} "
          f"identity and {stream_res['fallback_outcomes']} fallback "
          f"outcomes, carried {stream_res['carried']}; open loop "
          f"{ol['completed']}/{ol['offered']} at {ol['offered_qps']:.2f} "
          f"q/s offered, sustained {ol['qps_sustained']:.2f}, p50 "
          f"{ol['p50_s'] * 1e3:.1f} ms, p99 {ol['p99_s'] * 1e3:.1f} ms; "
          f"worker boots {runtime_res['service_pool']['boots']}, device "
          f"bytes a worker {per_worker} ({time.perf_counter() - t0:.3f} s)",
          flush=True)

    t0 = time.perf_counter()
    shard_res = drive_sharded(bi, engine_mod, bitops_mod, sched_mod,
                              graph_mod, work, sb_res, cemr_match, dev)
    print("sharded " + json.dumps(shard_res), flush=True)
    for c in shard_res["counts"]:
        for lanes, r in c["lanes"].items():
            print(f"sharded {c['workload']} on {card}: {lanes} lane(s), "
                  f"count {c['count']}, supersteps {r['supersteps']}, "
                  f"shard_lanes {r['shard_lanes']}, shard_rebalances "
                  f"{r['shard_rebalances']}, wall "
                  + ", ".join(f"{w * 1e3:.1f}" for w in r["wall_s"])
                  + f" ms, launches a dispatch "
                  f"{r['launches_a_dispatch']:.2f}", flush=True)
    sbs = shard_res["superbatch"]
    print(f"sharded superbatch on {card}: {sbs['lanes']} lanes, supersteps "
          f"{sbs['supersteps']}, shard_lanes {sbs['shard_lanes']}, "
          f"shard_rebalances {sbs['shard_rebalances']}, wall "
          f"{sbs['wall_s'] * 1e3:.1f} ms, launches a dispatch "
          f"{sbs['launches_a_dispatch']:.2f}; phase 4d in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    launches["sharded"] = shard_res["launches"]

    t0 = time.perf_counter()
    worst = check_lm_reduced(build_bundle, dev)
    print(f"reduced {LM_ARCH}: 4 float32 steps on the card agree with the "
          f"CPU, max_abs_err {worst:.3g} "
          f"({time.perf_counter() - t0:.3f} s)", flush=True)
    t0 = time.perf_counter()
    bundle = build_bundle(LM_ARCH, device=dev)
    model = bundle.init_fn(0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"{LM_ARCH}: {bundle.cfg.n_params():,} parameters in bfloat16, "
          f"init {time.perf_counter() - t0:.3f} s", flush=True)
    serve_res = drive_serve(serve, bi, fd, kops, ref, bundle, model)
    print("lm serve " + json.dumps(serve_res), flush=True)
    d32k = drive_decode_32k(bi, fd, kops, ref, bundle, model, dev,
                            LM_SHAPES[DECODE_SHAPE]["seq_len"])
    print("lm decode_32k " + json.dumps(
        {k: v for k, v in d32k.items()
         if k not in ("caches", "lengths", "n_heads")}), flush=True)

    shapes_cq = next(w["compiled"] for w in work
                     if (w["dataset"], w["scale"], w["query_size"])
                     == ("dblp", 1.0, 8))
    floors = {"warm": median_ms(lambda: torch.cuda._sleep(0))}
    flush = torch.empty(100 * 2 ** 20, dtype=torch.int8, device=dev)
    floors["flushed"] = flushed_ms(lambda: torch.cuda._sleep(0), flush)
    del flush
    print(f"launch floor: torch.cuda._sleep(0) back to back "
          f"{floors['warm']:.6f} ms, alone after an L2 flush "
          f"{floors['flushed']:.6f} ms", flush=True)
    kernels = time_kernels(bi, ref, shapes_cq, dev, launches, errs_by_width,
                           floors, widths, forced)
    m_mix, mix = sb_res["matcher"], sb_res["queries_list"]
    lane = time_lane(bi, ref, sched_mod.SuperbatchScheduler(
        [m_mix.compile(mix[i]).plan for i in MIX_BUCKETS[0]], device=dev),
        dev)
    print(f"time tile_intersect lane on {card}: " + json.dumps(lane),
          flush=True)
    ti = next(k for k in kernels if k["name"] == "tile_intersect"
              and k["words_per_block"] == bi.DEFAULT_WORDS_PER_BLOCK)
    ti["lane"] = lane
    ti["lane_launches"] = sb_res["lane_launches"]
    kernels.append(time_flash_decode(
        fd, ref, dev, d32k,
        {path: {"calls": res["launches"],
                "by_route": res["launches_by_route"],
                "by_kernel": res["launches_by_kernel"]}
         for path, res in (("serve", serve_res), ("decode_32k", d32k))},
        {**{f"grid {k}": v for k, v in fd_errs.items()},
         "serve loop": serve_res["held_max_abs_err"],
         "decode_32k step": d32k["vs_plain"]["attention_held"]
                            ["max_abs_err"]}))

    # the long-context phase once the decode_32k cache is freed, on the
    # same model; its flash_decode launches and layer timing go into
    # flash_decode's row, its partials and merge rows into the line
    del d32k
    torch.cuda.empty_cache()
    long_res = run_long_500k(bi, fd, kops, ref, bundle, model, dev, card)
    fdk = next(k for k in kernels if k["name"] == "flash_decode")
    fdk["launches_by_path"][LONG_SHAPE] = long_res["launches"]
    fdk.setdefault("by_shape", {})[f"{LM_ARCH} {LONG_SHAPE}"] = \
        long_res["layer"]
    fdk["max_abs_err_by_case"][f"{LONG_SHAPE} step"] = \
        long_res["held_max_abs_err"]
    fdk["max_abs_err"] = max(fdk["max_abs_err"], long_res["held_max_abs_err"],
                             long_res["layer"]["max_abs_err"])
    kernels += long_res["kernel_rows"]
    print("lm long_500k " + json.dumps(
        {k: v for k, v in long_res.items() if k != "kernel_rows"}),
        flush=True)

    # phase 5b after the timing, with the model freed
    del model
    torch.cuda.empty_cache()
    run_phase_5b(dev, card)
    # phase 5c once phase 5b's model is freed; its decode_32k launches and
    # timings go into flash_decode's row
    fam = run_phase_5c(dev, card)
    for arch, r in fam.items():
        d = r["decode_32k"]
        fdk["launches_by_path"][f"{arch} decode_32k"] = {
            "calls": d["launches"], "by_route": d["launches_by_route"],
            "by_kernel": d["launches_by_kernel"]}
        if d["flash_decode"] is not None:
            fdk.setdefault("by_shape", {})[f"{arch} decode_32k"] = \
                d["flash_decode"]
            fdk["max_abs_err_by_case"][f"{arch} decode_32k step"] = \
                d["attention_held"]["max_abs_err"]
            fdk["max_abs_err"] = max(fdk["max_abs_err"],
                                     d["attention_held"]["max_abs_err"],
                                     d["flash_decode"]["max_abs_err"])

    # phase 5d last: bert4rec and the GNNs, which launch none of the three
    # kernels; each row records the 0 launches of each of its paths
    rec = run_phase_5d(dev, card)
    for k in kernels:
        k["launches_phase_5d"] = {path: counts[k["name"]]
                                  for path, counts in rec["launches"].items()}
    # the examples phase, then phase 5e once everything else has freed
    # the card: spawned ranks, then the dry runs on the host
    ex = run_phase_examples(dev, card)
    place = run_phase_5e(card)
    held = place["decode"]["bf16"]["held"]
    held = {"flash_decode_partials": held["partials_max_abs_err"],
            "flash_decode_merge": held["merge_max_abs_err"]}
    for k in kernels:
        k["launches_phase_5e"] = place["launches"][k["name"]]
        k["launches_phase_5e_gnn"] = {
            arch: g["launches"][k["name"]] for arch, g in place["gnn"].items()
            if arch != "seconds"}
        if k["name"] in held:
            k["max_abs_err_phase_5e"] = held[k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"], held[k["name"]])
    kernels += engine_kernel_rows(bi, place)
    for k in kernels:
        k["launches_phase_examples"] = examples_launches(k, ex)

    print(f"chip_smoke: all phases in {time.perf_counter() - t_start:.3f} s",
          flush=True)
    print("kernels: " + ", ".join(
        k["name"] + (f" (words_per_block {k['words_per_block']})"
                     if "words_per_block" in k else "") for k in kernels))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

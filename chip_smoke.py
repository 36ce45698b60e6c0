"""Drives the PyTorch port's paths on one CUDA card and checks them.

  python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero before a result is printed):
  1. build the nine CUDA kernels from src/repro_torch/kernels/csrc with
     nvcc, one process per source, all started together, and print each
     one's registers and spills;
  2. hold each kernel against its plain PyTorch version on the card at
     the engine bucket of the paper's serve_online cell (B=32, m1=1024,
     K=8, m2=64, d=20, n_db=1,048,576, k=10; the affine kernel with a
     K_pred=5 predictor padded to K=8), at m2=128 and at a ragged n_db:
     perm and compliant exact, utility/exposure within rtol=1e-5,
     atol=1e-5, lambda-hat within rtol=1e-5, atol=1e-6; knn_lambda's
     lambda-hat bitwise equal to knn_rank_audited's. The two quantized
     kernels likewise, over the int8 and the bf16 pack of the same db,
     with idx and guard exact and knn_lambda_quant's lambda-hat and
     guard bitwise knn_rank_audited_quant's; on a db the int8 pack holds
     exactly (the 0.5 grid, 63.5 in every slab) the quantized outputs
     equal knn_rank_audited's bitwise and an exact-match query returns
     its row's lambda; the share of rows whose guard fired is logged;
     both quantized kernels in both modes, bitwise (lambda-hat and guard
     of the pair equal too), over 1,048,576 rows on orderings that
     stress the sweep's filtered selection (rows in rising and falling
     distance from the queries, all rows identical, exact ties planted
     every 2999 rows) and at the limits this slice lifted (k = 20, 33,
     64; d = 300, 512; d = 13 with a ragged slab of 200), plus a pack
     smaller than one chunk and k + k_extra = n_pad; knn_topk,
     knn_lambda and knn_rank_audited bitwise (lambda-hat of the last two
     equal too) over 1,048,576 rows on the same four orderings, at
     k = 20, 33, 64, 100, 256 (lists of 32 to 256), at k = 64 with
     d = 300 and 512, and at d = 1407 (rows scored in pieces of d);
     the kernel library's three: fused_rank at the bucket (m2 64 and
     128) and at kernel_bench's retrieval shape (64 x m1=100,000, K=5,
     m2=50), bitwise its plain version and rank_audited's (vals, idx);
     knn_topk at B=32 and 1024 over n_db=1,048,576, a ragged n_db and
     d=256 with k=16 over 100,003 rows, (d2, idx) bitwise;
     knn_predict_kernel's lambda-hat against the knn_lambda kernel's
     within rtol=1e-5, atol=1e-6; embedding_bag with an f32 and a bf16
     table, bitwise, at kernel_bench's shape (V=1,000,000, D=64, 4096
     bags x 32, weights, ~10% padding), at MIND's and DeepFM's
     serve_bulk shapes (BAG_SHAPES) and on BAG_EDGES (D = 10 to 256,
     empty and one-slot bags, a row-sliced and a misaligned table), each
     with an all-padded bag, a bag naming one row in every slot and
     indices past the table; the rank kernels (fused_rank,
     rank_audited, linear_rank_audited) bitwise at K=64, on rows whose
     scores rise with the item index (every candidate passes the
     filter), tie or fall, at the bucket and split over a cluster
     (4 x m1=100,000); rank_audited, knn_rank_audited and fused_rank
     bitwise at the paper's serve_retrieval cell (B=256,
     m1=1,048,576, K=5, m2=50, n_db=65,536, d=20, k=10); and m2=256
     through ops.fused_rank and ops.rank_audited on the card by the
     sort route, no launch;
  O. the paper's experiment on the card: for each dataset (MovieLens,
     YOW) and scenario m2 in (50, 500, 1000), build_experiment from
     --seed (10,923 users, 20,000 items, m1 = 1000, 2 recommender
     epochs, cut from build_experiment's 3 for the script's time: the
     Appendix-B recommender trained with the port's Adam,
     top-m1 slates, Table 1 constraints; 8192 train users, the
     offline_dual cell's batch, and 2731 holdout users), then
     fit_pipeline (300 dual iterations, with the MLP), then the Fig. 2
     strategies none, optimal, mean, linear, knn and mlp on the holdout
     users through the kernels (backend="kernel"), and at MovieLens
     m2 = 50 also the KNN predictor quantized to int8 and bf16 and the
     three knn_chain routes; each strategy's perm and compliant held
     exactly, its floats within TOL / LAM_TOL, against its plain version
     (ref.* for m2 <= 128; the route's plain lambda-hat and
     rank_given_lambda above), the launch counters against the calls'
     kernel_launch_count; logs a Fig. 2 row per (dataset, m2,
     strategy) (us_per_user: the median of 3 synchronised wall clocks
     over the holdout users), the Table 2-3 deltas computed from them,
     each build's stage seconds, and how far each build's trained user
     table lies from the first's (one seed trains one recommender), and
     a training step's wall and device time (torch.profiler) over 50
     steps; fails if optimal's compliance falls below none's;
  3. serve 192 KNN, 64 int8 KNN, 32 bf16 KNN, 64 linear, 64 mean, 32 MLP
     and 64 lambda-given requests at serve_online widths (m2=50, m1
     jittered in 512-1024), and 32 KNN, 32 int8 KNN, 32 linear and 16
     MLP requests at m2=500 (the 512 bucket: lambda-hat, then the sort
     route), through ServingEngine(device="cuda") at pipeline depth 1
     with phase O's MovieLens m2 = 50 linear, mean and MLP predictors,
     check every result against the plain version on the same padded
     batch (for m2=500 the route's plain lambda-hat and
     rank_given_lambda), and check that each wrapper's launch counter
     equals the sum over batches of the route's kernel_launch_count;
     then the xla row: the same stream through
     ServingEngine(executor="xla", device="cuda") (JAX's default
     executor: each predictor's predict, then rank_given_lambda as torch
     ops), which must move no wrapper's counter and count 0 launches;
     against the fused engine, on every request whose adjacent scores
     among its first m2 + 1 part by more than XLA_MARGIN relative, perm
     and compliant equal and utility and exposure within TOL; logs how
     many requests fall under the margin and each engine's wall ms a
     batch;
  S. serving under offered load (benchmarks/latency_serve.py's
     run_frontier at serve_online's width): 2048 requests of
     serving.DEFAULT_MIX plus the serve_online KNN surface (m1=1024,
     m2=50, K=5, d=20, weight 4) over phase 2's 1,048,576-row db,
     through ServingEngine(max_batch=32, max_wait_ms=2.0,
     pipeline_depth=1): a closed-loop pass gives the capacity C (its
     overlap_ratio must exceed 0), the same stream at depth 0 and 1 in
     turns, and at depth 1 with a 0.1 ms thread switch interval, gives
     every request the same perm and compliant (each pass's wall time
     logged), then Poisson arrivals
     through serve_open_loop at 0.25, 0.5, 0.7, 0.85, 1.0 and 1.2 x C,
     each on a fresh, warmed engine, log one row each (offered and
     achieved QPS, p50/p95/p99, queueing lag, pacing drift, deadline hit
     share against 50 ms, fill rate, overlap ratio, assembly, dispatch
     and launch-to-home ms a batch, saturated, the largest latency and
     queueing lag, and the garbage collector's pauses); admission on at
     0.25 x C must shed and degrade nothing and change no output bit
     in one pass, run over a frozen heap (gc.freeze: a full collection
     of the script's heap stalls the process for 150-420 ms); the
     controller's lag samples and any refused
     decision, with its lag EWMA, service estimates and predictions
     against headroom x budget, are logged;
     a deadline run at 1.2 x C with admission and a knn -> mean ladder
     (phase O's mean predictor) logs its sheds, degrades and hits by
     rung. Every served row equals the plain version on its own padded
     row (ref.*, its rung's bucket, in full batches), every run has one
     dispatch a batch, and its launch counters and metrics equal the
     sum over its batches of the route's kernel_launch_count;
  R. the refresh lane on the card (latency_serve.py's run_refresh and
     run_drift at serve_online's width): the KNN surface (m1=1024, m2=50,
     K=5, d=20, k=10) over phase 2's 1,048,576 rows with zero prices,
     over the f32 db and its int8 pack, through
     ServingEngine(pipeline_depth=1, max_wait_ms far away); a tighten
     drift stream (x8 over 0.25-0.75) of 256 requests whose covariates
     come from 32 returning users; RefreshLane.refresh() every 32. Fails
     unless each family swaps at least twice, every served row equals a
     cold engine started on its epoch's state bitwise and the plain
     version there, the shortfall with the lane is below the shortfall
     without it, each int8 pack is bitwise a full pack_knn_db of its db,
     rollback serves the pre-swap generation bitwise, a state with a NaN
     in lam_db is refused and counted while serving stays on last-good,
     the newest epoch's checkpoint (build/phase_r_ckpt, removed after)
     reloads and serves bitwise, and a stationary compliant stream
     leaves the lane unswapped and serving bitwise as without it; logs
     each swap's drain + update, validate and flip ms and checkpoint ms,
     the same stream's shortfall with fresh users, the ring write's and
     the int8 repack's ms and device ms beside the ring write's bound,
     and p50/p99, hit share and swaps of 2048 Poisson requests at
     0.5 x phase S's capacity with the lane on its thread (0.05 s)
     against off, in turns; every line with the card's name and power
     limit. Each driven run's launch counters equal its engine's;
  A. the adaptive bucket lattice on the card (latency_serve.py's
     run_lattice/check_lattice with its LATTICE_MIX_P0/P1, 64-request
     chunks, max_batch 8 and lane settings), plus the serve_online KNN
     surface (m1 jittered over 512-1024, m2=50, K=5, d=20, k=10, weight
     2) over phase 2's 1,048,576 rows: one engine at depth 1 with a
     LatticeLane; fails unless both re-warms are detector-gated swaps
     (epochs 1 and 2), a poisoned proposal rolls back with the stream
     going on, every chunk's rows are bitwise a cold engine's on that
     chunk's lattice and equal to the plain version, the gate mix's
     padding waste on c1 and c3 is at least 1.5x below a power-of-two
     engine's on the same chunks, no ring is allocated on the dispatch
     path, both the lambda-given and the KNN route ran at learned
     corners, and each run's launch counters equal its flushed and
     phantom batches'; logs the corners, shadow_warm_ms a corner, the
     device ms a batch (torch.profiler) of c1 and c3 at the learned
     corners and at the power-of-two ones, and p50/p99 of 2048 Poisson
     requests of the phase-0 mix at 0.5 x phase S's capacity with a
     lane.rewarm() fired from a side thread halfway through against
     without it, in turns (every row against the plain version);
  F. the replica fleet under chaos (latency_serve.py's run_fleet/
     check_fleet: 3 replicas, its step clock, health settings and
     FaultPlan.chaos(seed=17)) at serve_online's width: two KNN surfaces
     (m1 = 1024 and 512, m2=50, K=5, d=20, k=10) over phase 2's db, each
     replica an engine on its own stream with a RefreshLane and a
     CheckpointStore under build/phase_f_ckpt (removed after); 512
     requests, a fault-free prefix and a checkpointed refresh, then the
     plan with refreshes; fails unless every rid is served exactly once,
     no future is orphaned and none lost, a crash and a restart
     happened, the restarted replica resumed at the checkpointed epoch,
     the poisoned swap was refused, no incarnation allocated a ring on
     the dispatch path, every served row equals the plain version with
     the generation that served it, and the launch counters equal the
     engines'; logs crashes, restarts, hedges, failovers, p50/p99 and
     each restart's factory, reload and re-warm ms;
  D. the deployment driver (repro_torch.launch.serve's body: deploy,
     request_stream, serve) for each of deepfm, sasrec, bert4rec and
     mind at its published config (src/repro/configs/*.py, nothing
     cut), at DEPLOY: 60 training steps at batch 64 and lr 3e-3, 8192
     offline users and 300 dual iterations, 1024 candidates jittered
     by 0.5, m2 = 50, K = 5, 2048 requests through ServingEngine
     (max_batch 32, max_wait_ms 2, depth 1); then --admission on the
     sasrec deployment (a knn -> mean ladder: the mean rung runs
     linear_rank_audited) and --replicas 3 on mind's (a FleetRouter).
     Fails unless every rid is served once, every served row's perm
     and compliant equal the plain version on its own padded row,
     compiles_post_warmup is 0, the report's keys are the JAX
     launcher's (read from src/repro/launch/serve.py's source, not
     imported), the launch counters equal the flushed and phantom
     batches' route launches plus, for DeepFM, one embedding_bag a
     scoring call, and DeepFM's context sum is bitwise the
     embedding_bag plain version; logs each run's stage seconds, a
     training step's wall and device ms, scoring ms a chunk of 64,
     embedding_bag's device ms, latency, fill rate, compliance, peak
     memory and launches, beside the card's name and power limit;
  M. the paper's cells partitioned on a virtual make_smoke_mesh()
     ((2, 4) ('data', 'model'), every shard on the card): build_paper
     for each cell of configs/paper.py's PAPER_CELLS at full width
     (offline_dual 8192 x 1024, K = 5, m2 = 50, 300 iterations;
     serve_online B = 8192, m1 = 1024, d = 20, n_db = 1,048,576, k = 10;
     serve_retrieval B = 256, m1 = 1,048,576, n_db = 65,536), three
     programs a cell on the same seeded arrays: the global one
     (PaperConfig() on a one-device mesh over the card), the default
     variant partitioned over the mesh, and PaperConfig(distributed=True)
     (dist-topk); offline_dual's partitioned lam, dual_value,
     primal_value, exposure and compliant bitwise the global solve's;
     a serve cell's partitioned perm
     and compliant equal the global program's, utility and exposure
     within TOL, lambda-hat within LAM_TOL (each logged with whether it
     held bitwise); the partitioned default bitwise the dist-topk
     program on every field; every position's copy of each output block
     bitwise the block's first copy; each program's ms (CUDA events,
     median of 3) and allocated peak; the merged
     sharded_knn_topk over the 1,048,576 rows against one knn_topk
     launch (idx equal, d2 bitwise or within rtol 1e-6);
     knn_predict_quant_distributed over the int8 pack (slab 512) against
     knn_lambda_quant within LAM_TOL; then 512 requests (the
     serve_online KNN surface, m1 jittered 512-1024, m2 = 50, over the
     db, f32 and int8; lambda-given and linear requests; 32 KNN requests
     at m2 = 500) through ServingEngine(executor="dist", mesh=...,
     max_batch=32, pipeline_depth=1) and the default engine: every
     row's perm and compliant equal and its floats within TOL,
     compiles_post_warmup 0, the distributed paths' launch counters
     equal to the programs' and the flushed batches' dist route counts
     (core.serving_dist.dist_kernel_launches): 2 x 8 knn_topk and 8
     fused_rank launches for each partitioned and each dist-topk serve
     program; logs both engines' wall, latency and launches;
  L. the kernel library path: the entry points of repro_torch.kernels
     (ops.fused_rank, ops.knn_topk, ops.knn_predict_kernel,
     ops.embedding_bag) on phase 2's inputs, each output equal to phase
     2's plain version, with 1 launch per fused_rank and embedding_bag
     call and 2 per knn_topk and knn_predict_kernel call;
  Z. the LM half of the zoo (ZOO), after phase 4's timings: llama3.2-1b
     at its published width and depth (16 layers, d_model 2048, vocab
     128,256, bf16; src/repro/configs/llama3_2_1b.py): prefill at B=2,
     S=4096 (the chunked attention path), 8 decode steps at B=16 against
     a 32,768-token cache, 3 lm_train_steps at B=2, S=4096 on one
     make_lm_batch with f32 moments; prefill's last logits (chunked
     attention) held against an lm_forward with dense attention, and
     each decode step's against lm_forward's at those positions, within
     LM_BF16_TOL, chunked against dense attention on layer 0's q, k, v
     in f32 at S=2048 within ATTN_TOL, the loss finite and falling;
     then the same prefill, decode steps (the cache laid over 'data' x
     'model') and one train step (from a fresh Adam state) partitioned
     through build_lm on a virtual (2, 4) mesh over the card, one shard
     body a mesh position, against the global programs: logits within
     LM_BF16_TOL, the loss, grad_norm and each leaf's clipped gradient
     within PARTITIONED_LM, bitwise run to run, no FSDP leaf gathered
     whole; then llama4-scout at its published width with its depth cut to 2
     of 48 layers: prefill at B=1, S=2048 and 4 decode steps (finite),
     the assignments dropped over capacity (lm_prefill's and
     lm_decode_step's stats) and the aux loss logged; then decode
     against lm_forward on the configured path, at B=1 over 4 + 4
     tokens, few enough that the least capacity (8) drops nothing in
     either (checked). Logs each part's wall and device ms
     (torch.profiler) and peak memory beside the card's name and power
     limit. No kernel of the port runs here: attention and the MoE are
     torch ops, as the JAX package has no Pallas kernel for them;
  G. the GNN half of the zoo (GNN), after phase Z: MeshGraphNet at its
     published config (15 layers, d_hidden 128, sum, remat on;
     src/repro/configs/meshgraphnet.py) on the four cells of
     gnn_family.py at their cell_config widths, 3 gnn_train_steps each:
     full_graph_sm (2708 nodes, 10,556 edges, d_feat 1433) and molecule
     (128 graphs of 30 nodes, 64 edges) uncut; minibatch_lg a block of
     169,984 nodes / 168,960 edges neighbor_sample'd with 1024 seeds
     and fanouts (15, 10) from a make_csr_graph of Reddit's 232,965
     nodes at avg_degree 492 (~114.6M edges), node_mask on the seeds;
     ogb_products cut to 1/16 of its nodes and edges (153,065 and
     3,866,197), its widths kept. Logs each step's wall and device ms
     (torch.profiler) and peak memory, and a fourth step's wall
     without the profiler; fails unless every loss is finite, aggregate
     over the cell's encoded edges is bitwise equal across two calls
     (at full_graph_sm its distance from the CPU's is logged) and, at
     full_graph_sm, the loss and every gradient with remat on equal
     those with it off bitwise. After ogb_products' global steps, the
     same step partitioned (PARTITIONED): build_gnn's program on a
     virtual make_smoke_mesh() over the card, 2 'data' blocks on
     (2, 4), shard bodies with an all-gather of the node latents and a
     reduce-scatter of the partial aggregates each processor step and a
     sum of the replicas' gradients, from a copy of the parameters, a
     fresh Adam state and the graph padded by pad_graph; fails unless its
     loss and grad_norm are within rtol 1e-5 of the global step's on
     the same padded graph, its parameters within the tests'
     tolerances (tests/test_torch_gnn_sharded.py: from a fresh state a
     check of the gradients' signs), each leaf's clipped gradient
     within PARTITIONED["leaf_rtol"] of the global step's in norm, and
     two calls give the same bits; logs both steps' device ms (CUDA
     events) and peaks and the moments' largest distances; out of
     memory fails it. Then the ranking head:
     the 1024 seeds' node scores as one request's u (m1 = 1024, K = 8
     random a, m2 = 64) through ops.rank_audited, one rank_audited
     launch, bitwise its plain version;
  T. the training driver (TRAIN): launch.train's body in process on the
     card for meshgraphnet FULL, llama3.2-1b and sasrec at --smoke, 40
     steps with a checkpoint every 10 (under build/phase_t_ckpt,
     removed after phase P), once uninterrupted and once with a failure
     injected at step 25; fails unless the second run restarted once
     and its final parameters and Adam state are bitwise the first's;
  P. the zoo's cell programs (configs/*_family.py's build_lm,
     build_recsys, build_gnn and build_paper) over a virtual
     make_smoke_mesh() ((2, 4) ('data', 'model') on the card,
     PROGRAMS): every arch x cell built at FULL, its arguments'
     shapes, dtypes and specs those of the same build on a CPU mesh
     (the build tests/test_torch_cell_programs.py holds against JAX's
     Lowerable.args) and every sharding on the card's mesh;
     retrieval_cand uncut for deepfm, sasrec, bert4rec and mind at
     their published configs (1,000,448 candidates, the 65,536-row
     KNN database, m2 = 50; DeepFM's 39M x 10 table is 1.56 GB):
     lambda-hat through the knn_lambda kernel, the adjusted top-50
     through fused_rank, DeepFM's context through embedding_bag, each
     launch counted, perm exactly and lambda-hat and the scores bitwise
     the same program with the plain versions on the card; serve_p99
     (B = 512) for the four, and full_graph_sm and molecule through
     build_gnn at MeshGraphNet's published config on graphs padded by
     pad_graph, each step partitioned into shard bodies over the 2
     'data' blocks (a block of graphs for molecule), every output finite
     (nothing cut); llama4-scout's "opt"
     variant (moe_dispatch 'shmap') at its published width with its
     depth cut to 2 of 48 layers, under use_mesh_rules(mesh, LM_RULES):
     lm_forward through moe_apply_shmap against the global dispatch at
     2 x 4 tokens (neither drops) within LM_BF16_TOL, and at 2 x 2048
     timed with both paths' drops logged; compressed_psum and
     psum_with_error_feedback over 'data' on llama3.2-1b's FULL
     parameter shapes (two shards of f32 draws), every shard's result
     equal, the error within shards x scale / 2, each leaf's first 64
     rows bitwise the CPU's; phase T's llama3.2-1b checkpoint restored
     with param_shardings onto the mesh, every block bitwise the saved
     leaf's slice;
  Y. the dry run's cost model against the card (launch/graph_cost.py,
     after phase P): the programs the earlier phases ran, at the shapes
     they ran (COST_PROGRAMS: phase M's three paper cells, global; phase
     P's four retrieval_cand programs; phase Z's llama3.2-1b prefill
     2 x 4096 and a decode step at 16 x 32,768; phase G's ogb_products
     /16 train step; phase D's DeepFM train step), each traced on a
     one-device mesh over the fake card (the meta device): its strict
     bound is its matmul flops at their dtype's peak against the bytes
     it must move (every argument byte it reads, once; every output
     byte, once) at 3.35 TB/s. Fails unless every program was kept and,
     where the bound's bytes reach 1 GB (20 x the 50 MB L2), the
     measured device time (CUDA events around the program on its
     stream: phases M's and P's own timings, a pair around phase Z's
     and G's profiled calls, 5 more of phase D's steps) is at least
     0.95 x the bound. Logs each program's bound, what bounds it, its
     share of the measured time, the JAX-convention roofline terms and
     the device time by the dry run's op categories (torch.profiler:
     one more run in phases M and P). Launches nothing;
  4. time the nine kernels (CUDA events, medians) at the bucket shape and
     at a large batch (the quantized ones in both modes; fused_rank at
     64 x m1=100,000; rank_audited and knn_rank_audited also at
     serve_retrieval; embedding_bag at BAG_SHAPES with both tables, hot
     and on fresh index sets, its device and host time apart), beside the plain
     version, a library yardstick that only this script calls, and the
     card's bound; and split each KNN lambda-hat kernel's device time
     at the bucket and at B=1024 between its sweep and its merge
     (torch.profiler), and likewise knn_topk and knn_rank_audited. The
     rank, KNN and embedding_bag timings are rank_timings, knn_timings
     and bag_timings, which bench_rank.py runs on two checkouts for a
     before/after pair.
The launch counters are set to 0 just before each of phase O's holdout
paths, the serving path, phase 3's xla row, each run of phases S, R
and A, phase F, each
run of phase D, each distributed call of phase M (its checked program
runs, the sharded knn_topk and the dist engine's stream), the kernel
library path, phase G's ranking head and each retrieval_cand program
of phase P, and read just after each (the profiled runs phase Y takes
in phases M and P come after those readings, and count nowhere).
Prints the kernel table as one JSON line, the card's name and power
limit, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import gc
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch


def _load_roofline():
    """src/repro_torch/launch/roofline.py of this checkout, by its path:
    the card's peaks and the kernels' work formulas (it imports nothing
    of the package, so bench_rank.py can time another tree's kernels
    against this one's bounds)."""
    import importlib.util
    path = (Path(__file__).resolve().parent / "src" / "repro_torch"
            / "launch" / "roofline.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_roofline",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


roofline = _load_roofline()
HBM_BYTES_PER_S = roofline.HBM_BW
bound = roofline.bound
fused_work, rank_work = roofline.fused_work, roofline.rank_work
D, K_PRED, KNN_K, EPS = 20, 5, 10, 1e-4
N_DB = 1_048_576
BUCKET = dict(B=32, m1=1024, K=8, m2=64)
LARGE_RANK_B = 8192           # the serve_online cell's full batch
LARGE_KNN_B = 1024            # cut from 8192: see PERF.md
# the paper's experiment (phase O): build_experiment's sizes, the
# offline_dual cell's 8192 train users (round(0.75 * 10,923)) beside
# 2731 holdout users, fig2_strategies.py --full's 20,000 items, the
# paper's m1 = 1000 and its three scenarios; the recommender's epochs cut
# from 3 to 2 for time (at 3, its host-bound training took 368 s of the
# script's 634.6 s beside an H100 80GB HBM3 at 700 W)
EXPERIMENT = dict(n_users=10_923, n_items=20_000, m1=1000, train_frac=0.75,
                  epochs=2, iters=300)
DATASETS = ("movielens", "yow")
SCENARIOS = (50, 500, 1000)
STRATEGIES = ("none", "optimal", "mean", "linear", "knn", "mlp")
TIMED_RUNS = 3
TOL = dict(rtol=1e-5, atol=1e-5)
LAM_TOL = dict(rtol=1e-5, atol=1e-6)
# the xla row: a request whose adjacent scores among its first m2 + 1
# part by at most this (relative) may order its near-ties apart from the
# fused engine's (the two lambda-hats agree within LAM_TOL)
XLA_MARGIN = 1e-5
KERNELS = ("rank_audited", "knn_rank_audited", "linear_rank_audited",
           "knn_lambda", "knn_lambda_quant", "knn_rank_audited_quant",
           "fused_rank", "knn_topk", "embedding_bag")
# kernel_bench's shapes of the kernel library's entry points
RETRIEVAL = dict(B=64, m1=100_000, K=5, m2=50)
# the paper's serve_retrieval cell (src/repro/configs/paper.py): 6.44 GB
# of u and a
SERVE_RETRIEVAL = dict(B=256, m1=1_048_576, K=5, m2=50, n_db=65_536)
WIDE_K = 64                   # the engine's K tier after 32
WIDE = dict(n_db=100_003, d=256, k=16)   # the JAX tests' widest knn_topk
BAG = dict(V=1_000_000, D=64, n_bags=4096, bag=32)
# embedding_bag's measured shapes (bag_timings): kernel_bench's (S1),
# MIND at the recsys family's serve_bulk batch of 262,144 (S2: D = 64, a
# 50-item behaviour window; src/repro/configs/mind.py,
# recsys_family.py) and DeepFM there (S3: 39 one-slot field lookups a
# sample over its flat 39,000,000 x 10 table, no weights; deepfm.py)
BAG_SHAPES = {
    "kernel_bench": dict(BAG, weighted=True),
    "mind_serve_bulk": dict(V=1_000_000, D=64, n_bags=262_144, bag=50,
                            weighted=True),
    "deepfm_serve_bulk": dict(V=39_000_000, D=10, n_bags=39 * 262_144,
                              bag=1, weighted=False)}
# embedding_bag's edge cases: every plan of bag_geometry (8-byte vectors
# and 6 bags a warp at D = 10, column passes at D = 256), empty and
# one-slot bags, a row slice big[1:] and a table one item past an
# aligned pointer ("flat": 4-byte f32, 2-byte bf16 vectors)
BAG_EDGES = {
    "D=10 bag=1": dict(V=50_000, D=10, n_bags=4099, bag=1, weighted=False),
    "D=10 bag=50 rows": dict(V=50_000, D=10, n_bags=1000, bag=50,
                             weighted=True, view="rows"),
    "D=50 bag=50": dict(V=50_000, D=50, n_bags=1000, bag=50, weighted=True),
    "D=50 bag=1": dict(V=50_000, D=50, n_bags=1001, bag=1, weighted=True),
    "D=64 bag=0": dict(V=50_000, D=64, n_bags=100, bag=0, weighted=True),
    "D=64 bag=50 rows": dict(V=50_000, D=64, n_bags=1000, bag=50,
                             weighted=False, view="rows"),
    "D=64 bag=7 flat": dict(V=50_000, D=64, n_bags=1000, bag=7,
                            weighted=True, view="flat"),
    "D=256 bag=3": dict(V=50_000, D=256, n_bags=1000, bag=3, weighted=True)}
L2_BYTES = 50e6               # H100 L2
SECTOR_BYTES = 32
# phase S: latency_serve.py's run_frontier at serve_online's width
SERVE_LOAD = dict(n_requests=2048, max_batch=32, max_wait_ms=2.0,
                  fracs=(0.25, 0.5, 0.7, 0.85, 1.0, 1.2), budget_ms=50.0)
# phase R: latency_serve.py's run_refresh / run_drift at serve_online's
# width over phase 2's db: 256 requests of 32 returning users, a refresh
# every 32; 2048 under load with the lane's thread at 0.05 s
REFRESH = dict(n_requests=256, users=32, every=32, n_stationary=128,
               n_load=2048, interval_s=0.05)
TAG_R = "knn"
# phase A: latency_serve.py's run_lattice / check_lattice (its mixes,
# chunks, lane settings and checks) plus the serve_online KNN surface
# (m1 jittered over 512-1024) over phase 2's db; 2048 Poisson requests
# of the phase-0 mix at 0.5 x phase S's capacity, with and without a
# re-warm fired halfway through
LATTICE = dict(chunk=64, max_batch=8, max_executables=8, min_samples=32,
               rate_qps=50.0, lag_ms=5.0, patience_s=0.25, knn_weight=2.0,
               n_load=2048, load_wait_ms=2.0, min_waste_cut=1.5)
# phase F: latency_serve.py's run_fleet / check_fleet (3 replicas, its
# step clock, health settings and FaultPlan.chaos(seed=17)) at
# serve_online's width: two KNN surfaces (m1 = 1024 and 512) over phase
# 2's db, a RefreshLane and a CheckpointStore a replica
# latency_serve.py's LATTICE_MIX_P0 and _P1: candidate counts just past
# a power of two, so the static lattice pads 2-3x; phase 1 moves the
# heavy surface past the next boundary
LATTICE_MIX_P0 = (
    dict(name="feed_a", m1=540, m2=10, K=3, weight=4.0, m1_jitter=0.05,
         surface="feed"),
    dict(name="strip_a", m1=300, m2=8, K=5, weight=2.0, m1_jitter=0.1,
         surface="strip"),
    dict(name="notif_a", m1=140, m2=6, K=3, weight=1.0, m1_jitter=0.05,
         surface="notif"))
LATTICE_MIX_P1 = (
    dict(name="feed_b", m1=1100, m2=12, K=3, weight=4.0, m1_jitter=0.05,
         surface="feed"),
    dict(name="strip_a", m1=300, m2=8, K=5, weight=2.0, m1_jitter=0.1,
         surface="strip"))
FLEET = dict(n_requests=512, max_batch=8, seed=17, slow_ms=1.0,
             suspect_after_s=0.02, dead_after_s=0.5, backoff_base_s=0.02,
             backoff_cap_s=0.2, step_s=1e-3, keep_last=2)
# phase D: launch/serve.py's body at each recsys arch's published config:
# its launcher's training defaults (60 steps at batch 64, lr 3e-3), the
# offline_dual cell's 8192 users (configs/paper.py) with 300 dual
# iterations, serve_online's m1 = 1024 candidates (jittered by 0.5),
# m2 = 50, K = 5, and 2048 requests at the engine's defaults
DEPLOY = dict(train_steps=60, offline_users=8192, candidates=1024, m2=50,
              constraints=5, m1_jitter=0.5, requests=2048, max_batch=32,
              max_wait_ms=2.0, pipeline_depth=1)
MODES = ("int8", "bf16")
QUANT_EXTRA = 8
LIMIT_K = (20, 33, 64)        # k past 16: lists of 32, 64 and 128 (pack)
F32_K = (20, 33, 64, 100, 256)  # f32 lists of 32, 64, 128 and 256
LIMIT_D = (300, 512)          # d past the old 128 (pack) and 256 (f32)
F32_WIDE_D = 1407             # at k = 10: rows scored in pieces of d
# (route tag, m2) -> requests; m2 = 500 lands in the 512 bucket, above
# the rank kernels' m2 <= 128
SERVE_MIX = {("knn", 50): 192, ("knn_int8", 50): 64, ("knn_bf16", 50): 32,
             ("linear", 50): 64, ("mean", 50): 64, ("_lam", 50): 64,
             ("mlp", 50): 32, ("knn", 500): 32, ("knn_int8", 500): 32,
             ("linear", 500): 32, ("mlp", 500): 16}


def fail(msg: str):
    """Stop the run: the reason on standard output, where the phases log,
    and on standard error, whose end a caller may be the only one to see."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def rank_inputs(gen, dev, B, m1, K, m2):
    u = torch.rand((B, m1), generator=gen, device=dev) * 4.0 + 1.0
    a = (torch.rand((B, K, m1), generator=gen, device=dev) < 0.15).float()
    lam = torch.rand((B, K), generator=gen, device=dev)
    b = torch.rand((B, K), generator=gen, device=dev) * 2.0
    g = 1.0 / torch.log2(torch.arange(2, m2 + 2, device=dev,
                                      dtype=torch.float32))
    return u, a, b, lam, g.expand(B, m2).contiguous()


def affine_inputs(gen, dev, B, K, relu):
    """X (B, D) and a K_PRED-wide predictor padded to K rows: the linear
    family (relu) or the mean family (W = 0, a negative price in c)."""
    X = torch.randn((B, D), generator=gen, device=dev)
    W = torch.zeros((K, D), device=dev)
    c = torch.zeros((K,), device=dev)
    if relu:
        W[:K_PRED] = torch.randn((K_PRED, D), generator=gen, device=dev) * 0.3
        c[:K_PRED] = torch.randn((K_PRED,), generator=gen, device=dev) * 0.3
    else:
        c[:K_PRED] = torch.rand((K_PRED,), generator=gen, device=dev) - 0.3
        c[0] = -0.25
    return X, W, c


def knn_db(gen, dev, n_db):
    X_db = torch.randn((n_db, D), generator=gen, device=dev)
    lam_db = torch.randn((n_db, K_PRED), generator=gen, device=dev).abs()
    return X_db, lam_db * 0.5


def compare(name, got, want, lam_at=None):
    """perm/compliant exact, floats within tolerance; returns the max
    abs difference over the float outputs (vals skipped where the plain
    side has none)."""
    vals, idx, util, expo, comp = got[:5]
    w_vals, w_idx, w_util, w_expo, w_comp = want[:5]
    if not torch.equal(idx, w_idx):
        fail(f"{name}: perm differs from the plain version in "
             f"{int((idx != w_idx).sum())} slots")
    if not torch.equal(comp, w_comp):
        fail(f"{name}: compliant differs from the plain version")
    err = 0.0
    pairs = [(util, w_util, TOL), (expo, w_expo, TOL)]
    if w_vals is not None:
        pairs.append((vals, w_vals, TOL))
    if lam_at is not None:
        pairs.append((got[lam_at], want[lam_at], LAM_TOL))
    for g, w, tol in pairs:
        if not torch.allclose(g, w, **tol):
            fail(f"{name}: floats outside {tol}")
        err = max(err, float((g - w).abs().max()))
    return err


def time_ms(fn, reps, groups=5):
    """ms per call: CUDA events around `reps` back-to-back calls, so the
    card, not the host's enqueue of one call, sets the time; the median
    over `groups` such runs."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    return float(np.median(times))


def time_auto(fn, budget_ms=100.0, groups=5):
    """time_ms with as many back-to-back calls per group as fill about
    budget_ms (1 to 50), from one probe call."""
    probe = time_ms(fn, 1, groups=1)
    return time_ms(fn, max(1, min(50, int(budget_ms / max(probe, 1e-3)))),
                   groups)


def enqueue_ms(fn, calls=100, groups=5):
    """ms of host time per call: the host clock around `calls` calls that
    are not waited for, after the card has caught up (median of
    `groups`); the card's queue takes them without stalling the host
    while a call's device time stays under its host time."""
    times = []
    for _ in range(groups):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def bitwise(got, want):
    """Every output of a kernel equals its plain version's, bit for bit."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(
        torch.equal(g, w) for g, w in zip(got, want))


def device_split(fns, reps=5):
    """ms per call of each kernel that each function launches, by kernel
    name, from torch.profiler's device times; the reason instead where
    the profiler gives none."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for label, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            out[label] = {
                ev.key.split("(")[0].replace("void ", ""):
                    ev.device_time_total / 1e3 / reps
                for ev in prof.key_averages() if ev.device_time_total > 0}
        except (RuntimeError, AssertionError) as exc:
            out[label] = f"not measured: {str(exc)[:120]}"
    return out


def bag_work(table, idx, weighted=True):
    """(bytes, fp32 flops) of the bag on this run's indices: each distinct
    row a valid slot names read once, the indices and weights (where
    there are any) read, the output written; a product and a sum per
    valid slot and column."""
    n_bags, bag = idx.shape
    V, width = table.shape
    valid = idx[idx >= 0]
    rows = int(torch.unique(valid).numel())
    item = table.element_size()
    return (rows * width * item + (8 if weighted else 4) * n_bags * bag
            + n_bags * width * item, 2 * int(valid.numel()) * width)


def bag_slot_bytes(table, idx, weighted=True):
    """Bytes of the bag when no row is found in L2: the 32-byte sectors
    each valid slot's row spans, once a slot, plus bag_work's indices,
    weights and output."""
    n_bags, bag = idx.shape
    row = table.shape[1] * table.element_size()
    start = table.data_ptr() % SECTOR_BYTES + idx[idx >= 0].long() * row
    sectors = int(((start + row - 1) // SECTOR_BYTES
                   - start // SECTOR_BYTES + 1).sum())
    return (SECTOR_BYTES * sectors + (8 if weighted else 4) * n_bags * bag
            + n_bags * row)


def bag_indices(gen, dev, V, n_bags, bag, weighted):
    """int32 indices uniform in [0, V), about 10% of the slots padded
    where a bag has more than one, and f32 weights where `weighted`."""
    idx = torch.randint(0, V, (n_bags, bag), generator=gen, device=dev,
                        dtype=torch.int32)
    if bag > 1:
        pad = torch.rand(idx.shape, generator=gen, device=dev) < 0.1
        idx = torch.where(pad, torch.full_like(idx, -1), idx)
    w = (torch.randn(idx.shape, generator=gen, device=dev) if weighted
         else None)
    return idx, w


def bag_inputs(gen, dev, V, D, n_bags, bag, weighted, edges=False):
    """(big, indices, weights): an f32 (V + 1, D) table that bag_table
    cuts to V rows, and bag_indices'; with `edges`, bag 0 all padded,
    bag 1 one row in every slot and bag 2's first slots past the table
    (V, V + 7, 2**31 - 1)."""
    big = torch.randn((V + 1, D), generator=gen, device=dev)
    idx, w = bag_indices(gen, dev, V, n_bags, bag, weighted)
    if edges and bag:
        idx[0] = -1
        idx[1] = V // 2
        past = [V, V + 7, 2**31 - 1][:bag]
        idx[2, :len(past)] = torch.tensor(past, dtype=torch.int32,
                                          device=dev)
    return big, idx, w


def bag_table(big, dtype, view=None):
    """big in dtype, cut to its V = len(big) - 1 rows: its first V (None),
    its last V (a row slice big[1:], "rows") or V * D items one past its
    start ("flat")."""
    big = big.to(dtype)
    V, width = big.shape[0] - 1, big.shape[1]
    if view == "rows":
        return big[1:]
    if view == "flat":
        return big.view(-1)[1:1 + V * width].view(V, width)
    return big[:V]


RANK_CASES = (
    ("fused_rank", "bucket", BUCKET), ("fused_rank", "retrieval", RETRIEVAL),
    ("rank_audited", "bucket", BUCKET),
    ("rank_audited", "large", dict(BUCKET, B=LARGE_RANK_B)),
    ("rank_audited", "serve_retrieval", SERVE_RETRIEVAL),
    ("linear_rank_audited", "bucket", BUCKET),
    ("linear_rank_audited", "large", dict(BUCKET, B=LARGE_RANK_B)),
    ("knn_rank_audited", "serve_retrieval", SERVE_RETRIEVAL))


def rank_timings(k, gen, dev, cases=RANK_CASES):
    """Times the rank kernels of the namespace `k` (fused_rank_cuda,
    rank_audited_cuda, linear_rank_audited_cuda, knn_rank_audited_cuda
    and the module ref) at each (kernel, label, shape) of `cases`, on
    inputs drawn from `gen`: the kernel, its plain version and a library
    yardstick (torch.topk on the scores at the bucket and the large
    batch, torch.baddbmm + torch.topk where the score is part of the
    call, plus torch.addmm + torch.topk for KNN's lambda-hat), beside the
    card's bound; `bitwise` says whether the kernel's outputs equal the
    plain version's. bench_rank.py runs this for two checkouts."""
    out = {}
    c_eps = float(np.float32(1.0 + EPS))
    for name, label, sh in cases:
        B, m1, K, m2 = sh["B"], sh["m1"], sh["K"], sh["m2"]
        u, a, b, lam, g = rank_inputs(gen, dev, B, m1, K, m2)
        row = dict(batch=B, m1=m1, K=K, m2=m2)

        def lib_rank():
            return torch.topk(torch.baddbmm(u[:, None], lam[:, None], a,
                                            alpha=c_eps)[:, 0], m2)
        if name == "fused_rank":
            fn = lambda: k.fused_rank_cuda(u, a, lam, m2=m2, eps=EPS)  # noqa: E731
            plain = lambda: k.ref.fused_rank_ref(u, a, lam, m2, EPS)  # noqa: E731
            lib, work = lib_rank, fused_work(B, m1, K, m2)
        elif name == "rank_audited":
            fn = lambda: k.rank_audited_cuda(u, a, b, lam, g, m2=m2,  # noqa: E731
                                             eps=EPS)
            plain = lambda: k.ref.rank_audited_ref(u, a, b, lam, g, m2,  # noqa: E731
                                                   EPS)
            lib, work = lib_rank, rank_work(B, m1, K, m2)
            if label != "serve_retrieval":
                s = u + c_eps * torch.einsum("nk,nkm->nm", lam, a)
                lib = lambda: torch.topk(s, m2)  # noqa: E731
        elif name == "linear_rank_audited":
            X, W, c = affine_inputs(gen, dev, B, K, True)
            fn = lambda: k.linear_rank_audited_cuda(  # noqa: E731
                u, a, b, X, W, c, g, m2=m2, eps=EPS)
            plain = lambda: k.ref.linear_rank_audited_ref(  # noqa: E731
                u, a, b, X, W, c, g, m2, EPS)
            lib = lambda: torch.topk(torch.baddbmm(  # noqa: E731
                u[:, None], torch.addmm(c, X, W.T)[:, None], a,
                alpha=c_eps)[:, 0], m2)
            work = roofline.linear_work(B, m1, K, m2, D)
        else:
            X_db, lam_db = knn_db(gen, dev, sh["n_db"])
            xq = torch.randn((B, D), generator=gen, device=dev)
            y2 = (X_db * X_db).sum(1)
            fn = lambda: k.knn_rank_audited_cuda(  # noqa: E731
                xq, X_db, lam_db, u, a, b, g, k=KNN_K, m2=m2, eps=EPS)
            plain = lambda: k.ref.knn_rank_audited_ref(  # noqa: E731
                xq, X_db, lam_db, u, a, b, g, k=KNN_K, m2=m2, eps=EPS)
            lib = lambda: (torch.topk(torch.addmm(  # noqa: E731
                y2, xq, X_db.T, alpha=-2.0), KNN_K, largest=False),
                lib_rank())
            work = roofline.knn_work(B, sh["n_db"], m1, K, m2, D, KNN_K,
                                     K_PRED)
            row.update(n_db=sh["n_db"], d=D, k=KNN_K)
        got, want = fn(), plain()
        torch.cuda.synchronize()
        row["bitwise"] = bitwise(got, want)
        del got, want
        bms, by = bound(*work)
        row.update(ms=time_auto(fn), plain_ms=time_auto(plain, groups=3),
                   library_ms=time_auto(lib), bound_ms=bms, bound_by=by)
        out[(name, label)] = row
        del u, a, b, lam, g
        torch.cuda.empty_cache()
    return out


def knn_timings(k, gen, dev, X_db, lam_db, packs, plain=True):
    """Times the KNN kernels of the namespace `k` (knn_topk_cuda,
    knn_lambda_cuda, knn_rank_audited_cuda, knn_lambda_quant_cuda,
    knn_rank_audited_quant_cuda and the module ref) over the f32 db X_db
    and its packs {mode: (X_q, q_scale, y2_q)} at the bucket and at
    LARGE_KNN_B queries, on inputs drawn from `gen`: the kernel's ms
    beside a library yardstick (torch.addmm + torch.topk on the f32 db;
    torch._int_mm or a bf16 addmm, then torch.topk(k+8), on a pack) and
    the card's bound; `bitwise` says whether the outputs equal the plain
    version's; the plain version's ms where `plain`; and, for the three
    f32 kernels and knn_lambda_quant, the profiler's device ms by kernel
    (the sweep and the merge, or the rank launch). Returns (rows by
    (kernel, label[, mode]), the yardstick of each mode). bench_rank.py
    runs this for two checkouts."""
    B, m1, K, m2 = BUCKET["B"], BUCKET["m1"], BUCKET["K"], BUCKET["m2"]
    n_db = X_db.shape[0]
    out, library = {}, {}

    def row(key, Bt, fn, plain_fn, bnd, library_ms, reps, split):
        got, want = fn(), plain_fn()
        torch.cuda.synchronize()
        bms, by = bnd
        r = dict(batch=Bt, ms=time_ms(fn, reps), library_ms=library_ms,
                 bound_ms=bms, bound_by=by, bitwise=bitwise(got, want))
        del got, want
        if plain:
            r["plain_ms"] = time_ms(plain_fn, 1, groups=3)
        if split:
            r["split_ms"] = device_split({"x": fn})["x"]
        out[key] = r

    y2 = (X_db * X_db).sum(1)
    for label, Bt in (("bucket", B), ("large", LARGE_KNN_B)):
        u, a, b, lam, g = rank_inputs(gen, dev, Bt, m1, K, m2)
        xq = torch.randn((Bt, D), generator=gen, device=dev)
        reps = 10 if Bt == B else 2
        library_ms = time_ms(lambda: torch.topk(
            torch.addmm(y2, xq, X_db.T, alpha=-2.0), KNN_K, largest=False),
            reps)
        row(("knn_rank_audited", label), Bt,
            lambda: k.knn_rank_audited_cuda(xq, X_db, lam_db, u, a, b, g,
                                            k=KNN_K, m2=m2, eps=EPS),
            lambda: k.ref.knn_rank_audited_ref(xq, X_db, lam_db, u, a, b, g,
                                               k=KNN_K, m2=m2, eps=EPS),
            bound(*roofline.knn_work(Bt, n_db, m1, K, m2, D, KNN_K, K_PRED)),
            library_ms, reps, True)
        row(("knn_lambda", label), Bt,
            lambda: k.knn_lambda_cuda(xq, X_db, lam_db, k=KNN_K),
            lambda: k.ref.knn_lambda_ref(xq, X_db, lam_db, KNN_K),
            bound(*roofline.sweep_work(Bt, n_db, D, KNN_K, K_PRED)),
            library_ms, reps, True)
        row(("knn_topk", label), Bt,
            lambda: k.knn_topk_cuda(xq, X_db, k=KNN_K),
            lambda: k.ref.knn_topk_ref(xq, X_db, KNN_K),
            bound(*roofline.topk_work(Bt, n_db, D, KNN_K)), library_ms, reps,
            True)
    for mode, pack in packs.items():
        n_pad = pack[0].shape[0]
        if mode == "int8":
            # the int8 product wants whole 8-byte rows: pad d to 24
            db8 = torch.zeros((n_pad, 24), dtype=torch.int8, device=dev)
            db8[:, :D] = pack[0]
            library[mode] = ("torch._int_mm on the int8 query and db padded "
                             "to d=24, then torch.topk(k+8)")
        else:
            y2b = pack[2][:, 0].to(torch.bfloat16)
            library[mode] = ("torch.addmm on bf16 operands, then "
                             "torch.topk(k+8)")
        for label, Bt in (("bucket", B), ("large", LARGE_KNN_B)):
            u, a, b, lam, g = rank_inputs(gen, dev, Bt, m1, K, m2)
            xq = torch.randn((Bt, D), generator=gen, device=dev)
            reps = 10 if Bt == B else 2
            if mode == "int8":
                # the query quantized per row, as the kernel does
                sq = xq.abs().amax(1, keepdim=True) / 127.0
                q8 = torch.zeros((Bt, 24), dtype=torch.int8, device=dev)
                q8[:, :D] = torch.clamp(torch.round(xq / sq), -127, 127)
                lib_fn = lambda: torch.topk(  # noqa: E731
                    torch._int_mm(q8, db8.t()), KNN_K + QUANT_EXTRA)
            else:
                xb = xq.to(torch.bfloat16)
                lib_fn = lambda: torch.topk(  # noqa: E731
                    torch.addmm(y2b, xb, pack[0].T, alpha=-2.0),
                    KNN_K + QUANT_EXTRA, largest=False)
            try:
                library_ms = time_ms(lib_fn, reps)
            except RuntimeError as exc:        # the reason it would not run
                library_ms = None
                library[mode] += f" (did not run: {str(exc)[:160]})"
            row(("knn_rank_audited_quant", label, mode), Bt,
                lambda: k.knn_rank_audited_quant_cuda(
                    xq, *pack, lam_db, u, a, b, g, k=KNN_K, mode=mode,
                    m2=m2, eps=EPS),
                lambda: k.ref.knn_rank_audited_quant_ref(
                    xq, *pack, lam_db, u, a, b, g, k=KNN_K, mode=mode,
                    m2=m2, eps=EPS),
                bound(*roofline.quant_knn_work(Bt, n_db, m1, K, m2, mode, D,
                                               KNN_K, K_PRED), mode=mode),
                library_ms, reps, False)
            row(("knn_lambda_quant", label, mode), Bt,
                lambda: k.knn_lambda_quant_cuda(xq, *pack, lam_db, k=KNN_K,
                                                mode=mode),
                lambda: k.ref.knn_lambda_quant_ref(xq, *pack, lam_db, KNN_K,
                                                   mode=mode),
                bound(*roofline.quant_sweep_work(Bt, n_db, mode, D, KNN_K,
                                                 K_PRED), mode=mode),
                library_ms, reps, True)
        if mode == "int8":
            del db8
    return out, library


def bag_timings(k, gen, dev, shapes=BAG_SHAPES, plain=True):
    """Times the embedding_bag kernel of the namespace `k`
    (embedding_bag_cuda, the module ref, and bag_geometry where the tree
    has it) at each shape of `shapes` with an f32 and a bf16 table, on
    inputs drawn from `gen` with no index past the table, so that every
    tree's kernel takes them: `ms`, CUDA events around back-to-back calls
    on one index set (S1's rows fit L2); `cold_ms`, each call on the next
    of several index sets drawn beforehand, whose rows together exceed
    twice L2; `device_ms` and `cold_device_ms`, the profiler's device
    time of the kernels a call launches (None where it gives none), and
    `host_ms` = ms - device_ms; `enqueue_ms`, the wrapper's host time a
    call on the host's clock; `bound_ms` (bag_work: each distinct row
    once) and `slot_ms` (bag_slot_bytes: each valid slot's 32-byte
    sectors); `library_ms` and `library_device_ms` of
    torch.nn.functional.embedding_bag (weight 0 at a padded slot);
    `bitwise`, the output against the plain version's; and the plain
    version's ms where `plain`. Returns rows by ("embedding_bag", shape,
    "f32" | "bf16"). bench_rank.py runs this for two checkouts."""
    def device_ms(fn):
        split = device_split({"x": fn})["x"]
        return None if isinstance(split, str) else sum(split.values())

    out = {}
    for label, sh in shapes.items():
        V, width, n_bags, bag = sh["V"], sh["D"], sh["n_bags"], sh["bag"]
        big, idx, w = bag_inputs(gen, dev, V, width, n_bags, bag,
                                 sh["weighted"])
        # enough index sets that a set's rows are out of L2 by its turn
        # (counted at bf16's row bytes, the fewer)
        valid = int((idx >= 0).sum())
        n_sets = min(16, max(2, math.ceil(2 * L2_BYTES
                                          / max(1, valid * width * 2))))
        sets = [(idx, w)] + [bag_indices(gen, dev, V, n_bags, bag,
                                         sh["weighted"])
                             for _ in range(n_sets - 1)]
        pad = idx < 0
        bag_in = torch.where(pad, torch.zeros_like(idx), idx).long()
        for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            table = bag_table(big, dtype)
            got = k.embedding_bag_cuda(table, idx, w)
            torch.cuda.synchronize()
            want = k.ref.embedding_bag_ref(table, idx, w)
            row = dict(V=V, D=width, bags=n_bags, bag=bag,
                       weighted=sh["weighted"],
                       padded_share=float(pad.float().mean()) if bag else 0.0,
                       index_sets=n_sets, bitwise=bitwise(got, want))
            del got, want
            if getattr(k, "bag_geometry", None) is not None:
                row["plan"] = k.bag_geometry(width, table.element_size(), 16,
                                             bag)._asdict()
            fn = lambda: k.embedding_bag_cuda(table, idx, w)  # noqa: E731
            turn = itertools.cycle(sets)
            cold = lambda: k.embedding_bag_cuda(table, *next(turn))  # noqa: E731
            w_lib = None
            if sh["weighted"] or bool(pad.any()):
                ones = torch.ones(idx.shape, device=dev) if w is None else w
                w_lib = torch.where(pad, torch.zeros_like(ones),
                                    ones).to(dtype)
            lib = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
                bag_in, table, per_sample_weights=w_lib, mode="sum")
            row["ms"] = time_auto(fn)
            row["enqueue_ms"] = enqueue_ms(fn)
            row["cold_ms"] = time_auto(cold)
            row["device_ms"] = device_ms(fn)
            row["host_ms"] = (None if row["device_ms"] is None
                              else row["ms"] - row["device_ms"])
            row["cold_device_ms"] = device_ms(cold)
            row["library_device_ms"] = device_ms(lib)
            bms, by = bound(*bag_work(table, idx, sh["weighted"]))
            row.update(bound_ms=bms, bound_by=by,
                       slot_ms=bag_slot_bytes(table, idx, sh["weighted"])
                       / HBM_BYTES_PER_S * 1e3,
                       library_ms=time_auto(lib))
            if plain:
                row["plain_ms"] = time_ms(
                    lambda: k.ref.embedding_bag_ref(table, idx, w), 1,
                    groups=3)
            out[("embedding_bag", label, dt)] = row
            del table, w_lib
        del big, idx, w, sets, bag_in, pad
        torch.cuda.empty_cache()
    return out


def reset_counters(wrappers):
    for w in wrappers.values():
        w.launches = 0


def read_counters(wrappers):
    return {name: w.launches for name, w in wrappers.items()}


def load_stream(seed):
    """Phase S's stream: serving.DEFAULT_MIX plus the serve_online KNN
    surface, SERVE_LOAD["n_requests"] requests."""
    from repro_torch.serving import DEFAULT_MIX, Scenario, make_stream

    mix = DEFAULT_MIX + (Scenario("serve_online_knn", m1=1024, m2=50,
                                  K=K_PRED, tag="knn", d_cov=D, weight=4.0),)
    return make_stream(mix, n_requests=SERVE_LOAD["n_requests"], seed=seed)


def load_engine(stream, dev, knn, mean_pred, depth=1, admission=None,
                cls=None):
    """A warmed engine of phase S: SERVE_LOAD's batch and wait, the knn
    and mean predictors, and with `admission` a knn -> mean ladder."""
    from repro_torch.serving import ServingEngine

    eng = (cls or ServingEngine)(
        max_batch=SERVE_LOAD["max_batch"],
        max_wait_ms=SERVE_LOAD["max_wait_ms"], eps=EPS,
        pipeline_depth=depth, admission=admission, device=dev)
    eng.register_predictor("knn", knn, d_cov=D)
    eng.register_predictor("mean", mean_pred, d_cov=D)
    if admission is not None:
        eng.set_degradation_ladder("knn", ["mean"])
    eng.warmup(stream)
    return eng


def watched_admission():
    """An AdmissionController that records every queueing-lag sample it
    is fed (with its time) and every decision that sheds or degrades:
    the lag EWMA, each rung's service estimate, queue and in-flight
    count and prediction at that moment, against headroom x budget.
    Warmup feeds it no lag and no decision."""
    from repro_torch.serving import AdmissionController

    class Watched(AdmissionController):
        def __init__(self):
            super().__init__()
            self.lags, self.refused, self._rungs = [], [], []

        def observe_lag(self, lag_ms):
            self.lags.append((time.perf_counter(), float(lag_ms)))
            super().observe_lag(lag_ms)

        def predict_ms(self, bucket_name, *, queue_len, batch_cap,
                       inflight, max_wait_ms):
            got = super().predict_ms(bucket_name, queue_len=queue_len,
                                     batch_cap=batch_cap, inflight=inflight,
                                     max_wait_ms=max_wait_ms)
            self._rungs.append((bucket_name, queue_len, inflight, got))
            return got

        def decide(self, *, budget_ms, rung_predictions):
            lag, rungs, self._rungs = self.lag_ms, self._rungs, []
            d = super().decide(budget_ms=budget_ms,
                               rung_predictions=rung_predictions)
            if d.action != "admit":
                self.refused.append({
                    "action": d.action, "lag_ewma_ms": lag,
                    "limit_ms": self.headroom * budget_ms,
                    "default_rung": self.default_rung,
                    "rungs": [{"bucket": bk, "service_ms": self.service_ms(bk),
                               "queue": q, "inflight": n, "predicted_ms": p}
                              for bk, q, n, p in rungs]})
            return d

        def summary(self):
            lags = [x for _, x in self.lags]
            return {"lag_samples": len(lags),
                    "lag_ms_max": max(lags, default=0.0),
                    "lag_samples_over_10ms": sum(x > 10.0 for x in lags),
                    "refused": len(self.refused),
                    "first_refused": self.refused[:3]}

    return Watched()


class heap_frozen:
    """With-block: a full collection, then every object that is left
    frozen out of later collections (gc.freeze), so a collection inside
    the block traverses only what the block makes; unfrozen on exit."""

    def __enter__(self):
        gc.collect()
        gc.freeze()

    def __exit__(self, *exc):
        gc.unfreeze()


def serve_under_load(seed, dev, knn, mean_pred, wrappers, route_wrapper):
    """Phase S: the engine at pipeline depth 1 under open-loop Poisson
    traffic (benchmarks/latency_serve.py's run_frontier). A closed-loop
    pass gives the capacity C, then each offered load, a fraction of C,
    runs on a fresh, warmed engine. Every served row is held to the
    plain version on its own padded row (a row's answer does not depend
    on its batchmates), every run's launch counters to its batches'
    routes. Returns (launches summed over the runs, frontier rows,
    report)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.serving import (
        AdmissionController,
        ServingEngine,
        Shed,
        alloc_staging,
        fill_staging,
        poisson_arrivals,
        serve_open_loop,
    )

    cfg = SERVE_LOAD
    stream = load_stream(seed)
    n = len(stream)
    total = dict.fromkeys(wrappers, 0)

    class LoadEngine(ServingEngine):
        """Records each batch's bucket and rids."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.batches = []

        def _materialize_batch(self, pending):
            self.batches.append((pending.bucket,
                                 [e.req.rid for e in pending.entries]))
            super()._materialize_batch(pending)

    def engine(depth=1, admission=None):
        return load_engine(stream, dev, knn, mean_pred, depth, admission,
                           cls=LoadEngine)

    def plain(eng, rung):
        """rid -> (perm, compliant) of the plain version on the request's
        padded row in its bucket of `rung`, in full batches."""
        groups = {}
        for r in stream:
            bk = dict(eng._rung_buckets(r, eng.bucket_of(r))).get(rung)
            if bk is not None:
                groups.setdefault(bk, []).append(r)
        table = {}
        for bk, rs in groups.items():
            pred = eng._predictors.get(bk.tag)
            for i in range(0, len(rs), bk.batch):
                chunk = rs[i:i + bk.batch]
                staged = fill_staging(alloc_staging(
                    bk, d_cov=eng._d_cov.get(bk.tag), device="cpu"),
                    chunk, bk)
                t = {k: torch.tensor(v, device=dev)
                     for k, v in staged.items()}
                if pred is None:
                    want = ref.rank_audited_ref(t["u"], t["a"], t["b"],
                                                t["lam"], t["gamma"], bk.m2,
                                                EPS)
                else:
                    want = ref.predict_rank_audited_ref(
                        t["X"], pred, t["u"], t["a"], t["b"], t["gamma"],
                        bk.m2, EPS)
                perm, comp = want[1].cpu().numpy(), want[4].cpu().numpy()
                for j, r in enumerate(chunk):
                    table[r.rid] = (perm[j, :r.m2], bool(comp[j]))
        return table

    def run(label, eng, drive, tables,
            required=("rank_audited", "knn_rank_audited")):
        """Drive `eng` with the counters at 0, check every result and the
        launch counts, and close it."""
        pauses, started = [], []

        def on_gc(phase, info):
            if phase == "start":
                started.append(time.perf_counter())
            else:
                pauses.append((time.perf_counter() - started.pop()) * 1e3)

        gc.callbacks.append(on_gc)
        reset_counters(wrappers)
        try:
            results, extra = drive(eng)
        finally:
            gc.callbacks.remove(on_gc)
        launches = read_counters(wrappers)
        eng.close()
        for name, count in launches.items():
            total[name] += count
        if sorted(r.rid for r in results) != list(range(n)):
            fail(f"phase S {label}: {len(results)} results for {n} requests")
        for r in results:
            if isinstance(r, Shed):
                continue
            perm, comp = tables[r.rung][r.rid]
            if not np.array_equal(r.perm, perm) or r.compliant != comp:
                fail(f"phase S {label}: request {r.rid} (rung {r.rung}) "
                     f"differs from the plain version")
        expect = dict.fromkeys(wrappers, 0)
        for bucket, _ in eng.batches:
            pred = eng._predictors.get(bucket.tag)
            expect[route_wrapper(pred, bucket.m2)] += \
                ops.kernel_launch_count(pred, bucket.m2)
        s = eng.metrics.summary()
        if (launches != expect or s["dispatches_per_batch"] != 1.0
                or s["kernel_launches"] != sum(expect.values())
                or len(eng.batches) != s["batches"]):
            fail(f"phase S {label}: launch counters {launches} != batches "
                 f"x route launches {expect} (metrics "
                 f"{s['kernel_launches']}, dispatches per batch "
                 f"{s['dispatches_per_batch']})")
        for name in required:
            if launches[name] == 0:
                fail(f"phase S {label}: {name} never launched")
        s["gc_ms"] = {"collections": len(pauses), "total": sum(pauses),
                      "max": max(pauses, default=0.0)}
        s["latency_ms"]["max"] = max(eng.metrics.latencies_ms, default=0.0)
        return results, extra, s

    def closed_loop(eng, switch_s=None):
        """Back to back; `switch_s` sets the interpreter's thread switch
        interval for the pass (a probe of the GIL hand-off between the
        submitting thread and the pipeline worker)."""
        old = sys.getswitchinterval()
        if switch_s is not None:
            sys.setswitchinterval(switch_s)
        try:
            t0 = time.perf_counter()
            results = eng.serve_stream(stream, warmup=False)
            return results, time.perf_counter() - t0
        finally:
            sys.setswitchinterval(old)

    def open_loop(arrivals, reqs=stream, **kw):
        return lambda eng: serve_open_loop(eng, reqs, arrivals, **kw)

    def same(label, got, want, floats=False):
        want = {r.rid: r for r in want}
        for r in got:
            w = want[r.rid]
            if (isinstance(r, Shed) or r.rung != 0
                    or not np.array_equal(r.perm, w.perm)
                    or r.compliant != w.compliant
                    or (floats and (r.utility != w.utility or
                                    not np.array_equal(r.exposure,
                                                       w.exposure)))):
                fail(f"phase S {label}: request {r.rid} differs")

    t_phase = time.perf_counter()
    heap = len(gc.get_objects())       # what a full collection traverses
    probe = engine()
    tables = {0: plain(probe, 0)}
    closed, wall, s = run("capacity probe", probe, closed_loop, tables)
    capacity = n / wall
    report = {"capacity_qps": capacity, "closed_loop_wall_s": wall,
              "gc_tracked_objects_at_start": heap,
              "closed_loop": {k: s[k] for k in ("batches", "fill_rate",
                                                "latency_ms", "pipeline",
                                                "gc_ms")}}
    if not s["pipeline"]["overlap_ratio"] > 0.0:
        fail(f"phase S: overlap_ratio {s['pipeline']['overlap_ratio']} "
             f"at depth 1 on a back-to-back stream")
    # depth 0 against depth 1, in turns, and depth 1 with a 0.1 ms switch
    # interval: the same perm and compliant for every request
    report["closed_loop_turns"] = []
    for depth, switch_s in ((0, None), (1, None), (0, None), (1, 1e-4)):
        label = f"closed loop at depth {depth}, switch interval {switch_s}"
        res, wall_t, s_t = run(label, engine(depth=depth),
                               lambda eng: closed_loop(eng, switch_s), tables)
        same(label, res, closed)
        report["closed_loop_turns"].append({
            "depth": depth, "switch_interval_s": switch_s or
            sys.getswitchinterval(), "wall_s": wall_t,
            "batches": s_t["batches"],
            "overlap_ratio": s_t["pipeline"]["overlap_ratio"],
            "exec_ms_per_batch": s_t["pipeline"]["exec_ms_per_batch"],
            "latency_ms": s_t["latency_ms"], "gc_ms": s_t["gc_ms"]})
    rows = []
    for frac in cfg["fracs"]:
        qps = capacity * frac
        arrivals = poisson_arrivals(n, qps, seed=seed + 1)
        results, ol, s = run(f"load {frac} x C", engine(),
                             open_loop(arrivals), tables)
        pipe, lat = s["pipeline"], s["latency_ms"]
        rows.append({
            "offered_frac_of_capacity": frac, "target_qps": qps,
            "offered_qps": ol["offered_qps"],
            "achieved_qps": ol["achieved_qps"], "capacity_qps": capacity,
            "p50_ms": lat["p50"], "p95_ms": lat["p95"], "p99_ms": lat["p99"],
            "queue_lag_ms_last": ol["queue_lag_ms"]["last"],
            "drift_ms_p99": ol["drift_ms"]["p99"],
            "deadline_hit_rate": s["deadline"]["hit_rate"],
            "fill_rate": s["fill_rate"], "batches": s["batches"],
            "overlap_ratio": pipe["overlap_ratio"],
            "assembly_ms_per_batch": pipe["assembly_ms_per_batch"],
            "dispatch_ms_per_batch": pipe["dispatch_ms_per_batch"],
            "exec_ms_per_batch": pipe["exec_ms_per_batch"],
            "queue_depth_mean": pipe["queue_depth_mean"],
            "latency_ms_max": lat["max"],
            "queue_lag_ms_max": ol["queue_lag_ms"]["max"],
            "gc_ms": s["gc_ms"],
            "saturated": ol["queue_lag_ms"]["last"] > max(5.0, 1e4 / qps),
            "within_50ms": lat["p99"] <= cfg["budget_ms"]})
        log(f"phase S frontier {json.dumps(rows[-1])}")
        if frac == cfg["fracs"][0]:
            quarter = (arrivals, results)
    # admission at the lowest load changes nothing, in one pass, over a
    # frozen heap: a full collection of this script's heap
    # (gc_tracked_objects_at_start) stalls the process for 150-420 ms,
    # and the controller rightly sheds behind a stall
    ctrl = watched_admission()
    eng = engine(admission=ctrl)
    tables[1] = plain(eng, 1)                    # the knn -> mean rung
    modules = set(sys.modules)
    with heap_frozen():
        results, _, s = run("admission at the lowest load", eng,
                            open_loop(quarter[0]), tables)
    report["admission_low_load"] = {
        "sheds": s["deadline"]["sheds"],
        "degrades": s["deadline"]["degrades"], **ctrl.summary(),
        "gc_ms": s["gc_ms"],
        "modules_imported": sorted(set(sys.modules) - modules)}
    if s["deadline"]["sheds"] or s["deadline"]["degrades"]:
        fail(f"phase S: admission shed or degraded at {cfg['fracs'][0]} "
             f"x C: {report['admission_low_load']}")
    same("admission on against off", results, quarter[1], floats=True)
    # a deadline run past capacity: admission and a knn -> mean ladder
    frac = cfg["fracs"][-1]
    results, ol, s = run(
        f"deadline run at {frac} x C", engine(admission=AdmissionController()),
        open_loop(poisson_arrivals(n, capacity * frac, seed=seed + 2),
                  [dataclasses.replace(r) for r in stream],
                  deadline_budget_s=cfg["budget_ms"] / 1e3), tables,
        required=())
    by_rung = {}
    for r in results:
        if not isinstance(r, Shed):
            hit = by_rung.setdefault(str(r.rung), {"served": 0, "hits": 0})
            hit["served"] += 1
            hit["hits"] += int(r.deadline_hit)
    report["deadline_run"] = {
        "offered_frac_of_capacity": frac, "achieved_qps": ol["achieved_qps"],
        "sheds": s["deadline"]["sheds"], "degrades": s["deadline"]["degrades"],
        "hit_rate": s["deadline"]["hit_rate"], "by_rung": by_rung,
        "rungs": s["deadline"]["rungs"], "latency_ms": s["latency_ms"],
        "queue_lag_ms_last": ol["queue_lag_ms"]["last"]}
    report["seconds"] = time.perf_counter() - t_phase
    return total, rows, report


def serve_refresh(seed, dev, X_db, capacity, wrappers, route_wrapper, smi):
    """Phase R: the refresh lane on the card at serve_online's width
    (benchmarks/latency_serve.py's run_refresh/check_refresh and
    run_drift/check_drift). The KNN surface over phase 2's 1,048,576-row
    db with zero prices (the compliant era), over the f32 db and its
    int8 pack, through ServingEngine(pipeline_depth=1); a tighten drift
    stream; lane.refresh() every REFRESH["every"] requests. Checks: at
    least 2 swaps a family; every served row bitwise a cold engine's on
    its epoch's state and equal to the plain version there; shortfall
    with the lane below shortfall without; the int8 pack after each
    refresh bitwise a full pack_knn_db; rollback serving the pre-swap
    generation bitwise; a poisoned state refused and counted, serving
    on last-good; the newest checkpoint reloading and serving bitwise;
    a stationary compliant stream neutral to the bit. Logs the publish
    split, the ring write's and repack's device ms, the checkpoint
    write's ms and p50/p99 with the lane on its thread against off at
    0.5 x phase S's capacity. Returns (launches summed over the driven
    runs, report)."""
    import shutil

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.core.predictors import (
        KNNLambdaPredictor,
        pack_knn_db,
        predictor_state,
        repack_knn_slabs,
        with_state,
    )
    from repro_torch.data.synthetic import DriftSpec
    from repro_torch.kernels import ops, ref
    from repro_torch.serving import (
        RefreshLane,
        ServingEngine,
        alloc_staging,
        fill_staging,
        knn_ring_update,
        make_drift_stream,
        poisson_arrivals,
        serve_open_loop,
    )

    cfg = REFRESH
    t_phase = time.perf_counter()
    total = dict.fromkeys(wrappers, 0)
    zero = torch.zeros((X_db.shape[0], K_PRED), device=dev)
    preds = {"knn": KNNLambdaPredictor(X_db=X_db, lam_db=zero, k=KNN_K)}
    preds["knn_int8"] = preds["knn"].quantized("int8", device=dev)
    tighten = DriftSpec(kind="tighten", magnitude=8.0, start=0.25, end=0.75)

    def stream(spec, n, users=None, **kw):
        """make_drift_stream at serve_online's width; with `users`,
        request i carries returning user (i mod users)'s covariates."""
        reqs = make_drift_stream(spec, tag=TAG_R, n_requests=n, m1=1024,
                                 m2=50, K=K_PRED, d_cov=D, seed=seed + 7,
                                 **kw)
        if users:
            for r in reqs:
                r.X = reqs[r.rid % users].X
        return reqs

    drift = stream(tighten, cfg["n_requests"], users=cfg["users"])
    fresh = stream(tighten, cfg["n_requests"])

    def engine(pred, max_wait_ms=1e9, warm=drift):
        eng = ServingEngine(max_batch=32, max_wait_ms=max_wait_ms, eps=EPS,
                            pipeline_depth=1, device=dev)
        eng.register_predictor(TAG_R, pred, d_cov=D)
        eng.warmup(warm[:1])
        torch.cuda.synchronize()
        return eng

    def counted(label, eng, drive, launched=True):
        """Drive `eng` with the counters at 0; its launches must equal
        its batches' route launches (and be some, if `launched`)."""
        before = eng.metrics.kernel_launches
        reset_counters(wrappers)
        out = drive()
        torch.cuda.synchronize()
        launches = read_counters(wrappers)
        name = route_wrapper(eng.predictor_template(TAG_R), 50)
        expect = dict.fromkeys(wrappers, 0)
        expect[name] = eng.metrics.kernel_launches - before
        if launches != expect or (launched and not launches[name]):
            fail(f"phase R {label}: launch counters {launches} != the "
                 f"engine's {expect}")
        for k, v in launches.items():
            total[k] += v
        return out

    def shortfall(reqs, results):
        by_rid = {r.rid: r for r in reqs}
        return sum(float(np.clip(by_rid[r.rid].b - r.exposure, 0.0,
                                 None).sum()) for r in results)

    def chunks(eng, reqs, lane=None, every=cfg["every"]):
        """Serve in chunks (each fully drained: one epoch a chunk), with
        lane.refresh() after each; returns results, the epoch's states
        and the lane's reports."""
        results, states, reports = [], {0: eng.predictor_state_of(TAG_R)}, []
        for i in range(0, len(reqs), every):
            results += eng.serve_stream(reqs[i:i + every], warmup=False)
            if lane is not None:
                rep = lane.refresh(TAG_R)[TAG_R]
                reports.append(rep)
                if rep["swapped"]:
                    states[rep["epoch"]] = eng.predictor_state_of(TAG_R)
        return results, states, reports

    def cold(pred, state, reqs):
        """rid -> result of a fresh engine that serves `state` from the
        start (depth 1, the same bucket)."""
        eng = engine(pred)
        if state is not None:
            eng.swap_predictor(TAG_R, state)
        out = {r.rid: r for r in eng.serve_stream(reqs, warmup=False)}
        eng.close()
        return out

    def same(label, got, want):
        for r in got:
            w = want[r.rid]
            if (not np.array_equal(r.perm, w.perm) or r.utility != w.utility
                    or not np.array_equal(r.exposure, w.exposure)
                    or r.compliant != w.compliant):
                fail(f"phase R {label}: request {r.rid} differs")

    def plain(label, pred, state, reqs, got):
        """Every row of `got` against the plain version on `state`, on its
        own padded row in full batches of its bucket."""
        eng = ServingEngine(max_batch=32, device=dev)
        eng.register_predictor(TAG_R, pred, d_cov=D)
        p = with_state(pred, state)
        bk = eng.bucket_of(reqs[0])
        by_rid = {r.rid: r for r in got}
        for i in range(0, len(reqs), bk.batch):
            chunk = reqs[i:i + bk.batch]
            staged = fill_staging(alloc_staging(bk, d_cov=D, device="cpu"),
                                  chunk, bk)
            t = {k: torch.tensor(v, device=dev) for k, v in staged.items()}
            want = ref.predict_rank_audited_ref(
                t["X"], p, t["u"], t["a"], t["b"], t["gamma"], bk.m2, EPS)
            perm, comp = want[1].cpu().numpy(), want[4].cpu().numpy()
            for j, r in enumerate(chunk):
                g = by_rid[r.rid]
                if not np.array_equal(g.perm, perm[j, :r.m2]) \
                        or g.compliant != bool(comp[j]):
                    fail(f"phase R {label}: request {r.rid} differs from "
                         f"the plain version")
        eng.close()

    def per_epoch(label, pred, reqs, results, states):
        """Hot against cold, epoch by epoch, and against the plain
        version."""
        by_epoch = {}
        for r in results:
            by_epoch.setdefault(r.epoch, set()).add(r.rid)
        for epoch, rids in sorted(by_epoch.items()):
            sub = [q for q in reqs if q.rid in rids]
            hot = [r for r in results if r.rid in rids]
            same(f"{label} epoch {epoch}", hot, cold(pred, states[epoch]
                                                      if epoch else None,
                                                      sub))
            plain(f"{label} epoch {epoch}", pred, states[epoch], sub, hot)
        return sorted(by_epoch)

    report = {"config": dict(cfg, n_db=int(X_db.shape[0]), d=D, K=K_PRED,
                             k=KNN_K, m1=1024, m2=50, drift="tighten x8 "
                             "over 0.25-0.75")}
    ckpt_dir = Path(__file__).resolve().parent / "build" / "phase_r_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    store = CheckpointStore(str(ckpt_dir), keep_last=2)
    for fam, pred in preds.items():
        # refresh off, then on, over the same returning-user drift stream
        eng = engine(pred)
        off = counted(f"{fam} refresh off", eng,
                      lambda: chunks(eng, drift)[0])
        eng.close()
        eng = engine(pred)
        lane = RefreshLane(eng, eta=1.0, min_samples=8,
                           checkpoint=store if fam == "knn" else None)
        on, states, reports = counted(f"{fam} refresh on", eng,
                                      lambda: chunks(eng, drift, lane))
        swaps = [r for r in reports if r["swapped"]]
        if len(swaps) < 2:
            fail(f"phase R {fam}: {len(swaps)} swaps (reports "
                 f"{[r['reason'] for r in reports]})")
        s_off, s_on = shortfall(drift, off), shortfall(drift, on)
        if not s_on < s_off:
            fail(f"phase R {fam}: shortfall with the lane {s_on} is not "
                 f"below {s_off} without it")
        epochs = per_epoch(fam, pred, drift, on, states)
        if fam == "knn_int8":
            # each published pack is a full repack of its db, bitwise
            for e, st in states.items():
                full = pack_knn_db(st["X_db"], mode="int8", device=dev)
                if not all(torch.equal(st[n], w) for n, w in
                           zip(("X_q", "q_scale", "y2_q"), full)):
                    fail(f"phase R int8 epoch {e}: the pack differs from "
                         f"a full pack_knn_db of its db")
        m = eng.metrics
        row = {"swaps": len(swaps), "epochs_served": epochs,
               "shortfall_off": s_off, "shortfall_on": s_on,
               "shortfall_ratio": s_on / s_off,
               "drain_update_ms": [r["ms"]["drain_update"] for r in swaps],
               "swap_ms": [r["ms"]["swap"] for r in swaps],
               "validate_ms": list(m.swap_validate_ms),
               "flip_ms": list(m.swap_flip_ms),
               "states_retired": m.states_retired}
        if fam == "knn":
            row["checkpoint_ms"] = [r["ms"]["checkpoint"] for r in swaps]
            # rollback serves the pre-swap generation bitwise
            last = max(states)
            chunk = drift[-cfg["every"]:]
            want = cold(pred, states[last - 1], chunk)
            rb = lane.rollback(TAG_R)
            got = counted("rollback", eng,
                          lambda: eng.serve_stream(chunk, warmup=False))
            if rb != last + 1 or any(r.epoch != rb for r in got):
                fail(f"phase R rollback: epoch {rb}, served "
                     f"{sorted({r.epoch for r in got})}")
            same("rollback", got, want)
            # a poisoned state is refused, counted, and serving stays on
            # last-good
            def poison(tag, st):
                lam = st["lam_db"].clone()
                lam[lam.shape[0] // 2 + 1, 2] = float("nan")
                return {**st, "lam_db": lam}
            lane.publish_filter = poison
            counted("poisoned", eng, lambda: eng.serve_stream(
                chunk, warmup=False))
            rep = lane.refresh(TAG_R)[TAG_R]
            if rep["swapped"] or "poisoned" not in str(rep["reason"]) \
                    or m.refresh_failures != 1 \
                    or eng.predictor_epoch(TAG_R) != rb:
                fail(f"phase R poisoned swap: {rep}, failures "
                     f"{m.refresh_failures}, epoch "
                     f"{eng.predictor_epoch(TAG_R)}")
            got = counted("last-good", eng, lambda: eng.serve_stream(
                chunk, warmup=False))
            same("last-good after the refusal", got, want)
            # the newest checkpoint reloads and serves bitwise
            t0 = time.perf_counter()
            loaded, e = store.load_predictor_epoch(
                TAG_R, like=predictor_state(pred), device=dev)
            row["checkpoint_load_ms"] = (time.perf_counter() - t0) * 1e3
            if e != last or not all(torch.equal(loaded[k], states[last][k])
                                    for k in loaded):
                fail(f"phase R checkpoint: epoch {e} of {last} does not "
                     f"reload bitwise")
            restored = engine(pred)
            restored.swap_predictor(TAG_R, loaded, epoch=e)
            got = restored.serve_stream(chunk, warmup=False)
            restored.close()
            if any(r.epoch != e for r in got):
                fail("phase R checkpoint: the restored engine's epoch")
            same("restored checkpoint", got, cold(pred, states[last], chunk))
        eng.close()
        report[fam] = row
        log(f"phase R {fam} {json.dumps(row)} ({smi})")
        del states, on, off, lane, eng
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # fresh users: each request's 10 nearest rows of 1M are almost never
    # the few hundred the lane wrote (logged, not checked)
    pred = preds["knn"]
    f_out = {}
    for on_ in (False, True):
        eng = engine(pred)
        lane = RefreshLane(eng, eta=1.0, min_samples=8) if on_ else None
        res, _, reps = counted(f"fresh users, lane {on_}", eng,
                               lambda: chunks(eng, fresh, lane))
        f_out[on_] = (shortfall(fresh, res), sum(r["swapped"] for r in reps))
        eng.close()
    report["fresh_users"] = {"shortfall_off": f_out[False][0],
                             "shortfall_on": f_out[True][0],
                             "swaps": f_out[True][1]}
    log(f"phase R fresh users {json.dumps(report['fresh_users'])} ({smi})")

    # a stationary compliant stream at lambda-hat = 0: neutral to the bit
    stat = stream(DriftSpec(kind="none"), cfg["n_stationary"],
                  topic_rate=0.45, b_frac=0.01)
    runs = {}
    for on_ in (False, True):
        eng = engine(pred, warm=stat)
        lane = RefreshLane(eng, min_samples=8) if on_ else None
        res, _, reps = counted(f"stationary, lane {on_}", eng,
                               lambda: chunks(eng, stat, lane))
        eng.close()
        if not (on_ or all(r.compliant for r in res)):
            fail("phase R stationary: the stream is not compliant without "
                 "the lane")
        if any(r["swapped"] or r["reason"] not in (
                "no-pressure", "below-min-samples") for r in reps):
            fail(f"phase R stationary: the lane published "
                 f"{[r['reason'] for r in reps]}")
        runs[on_] = {r.rid: r for r in res}
    same("stationary", list(runs[True].values()), runs[False])

    # the lane's device work alone: the ring write (a 32-row telemetry
    # window into the 1M-row db, the db cloned) and the int8 repack of
    # the slabs it touched
    st = predictor_state(preds["knn_int8"])
    X_new = torch.randn((cfg["every"], D), device=dev).cpu().numpy()
    lam_new = np.ones((cfg["every"], K_PRED), np.float32)
    ring = lambda: knn_ring_update(st["X_db"], st["lam_db"], X_new,  # noqa
                                   lam_new, 1_048_000, return_written=True)
    written = ring()[3]
    repack = lambda: repack_knn_slabs(  # noqa: E731
        st["X_db"], st["X_q"], st["q_scale"], st["y2_q"], written,
        mode="int8", slab=st["X_q"].shape[0] // st["q_scale"].shape[0])
    dev_ms = device_split({"ring_write": ring, "repack": repack})
    n, nb = X_db.shape[0], 4 * (D + K_PRED)
    report["lane_device"] = {
        "ring_write_ms": time_ms(ring, 5),
        "ring_write_device_ms": sum(dev_ms["ring_write"].values())
        if isinstance(dev_ms["ring_write"], dict) else dev_ms["ring_write"],
        "ring_write_bound_ms": 2 * n * nb / HBM_BYTES_PER_S * 1e3,
        "repack_ms": time_ms(repack, 5),
        "repack_device_ms": sum(dev_ms["repack"].values())
        if isinstance(dev_ms["repack"], dict) else dev_ms["repack"],
        "device_kernels": dev_ms}
    log(f"phase R lane device work {json.dumps(report['lane_device'])} "
        f"({smi})")

    # p50/p99 with the lane on its thread against off, at 0.5 x C, turns
    qps = 0.5 * capacity
    load = stream(tighten, cfg["n_load"], users=cfg["users"])
    arrivals = poisson_arrivals(len(load), qps, seed=seed + 3)
    report["load"] = []
    class TimedLane(RefreshLane):
        """Records each pass's start (s since the run began) and wall ms."""

        def __init__(self, eng, t0, **kw):
            super().__init__(eng, **kw)
            self.t0, self.passes = t0, []

        def refresh(self, tag=None):
            t = time.perf_counter()
            out = super().refresh(tag)
            self.passes.append((t - self.t0,
                                (time.perf_counter() - t) * 1e3))
            return out

    def segments():
        """The caching allocator's cudaMalloc count so far."""
        return torch.cuda.memory_stats(dev).get("segment.all.allocated", 0)

    for on_ in (False, True, True, False):
        eng = engine(pred, max_wait_ms=2.0, warm=load)
        pauses, started = [], []

        def on_gc(phase, info):
            if phase == "start":
                started.append(time.perf_counter())
            else:
                pauses.append((time.perf_counter() - started.pop()) * 1e3)

        t0, segs = time.perf_counter(), segments()
        lane = (TimedLane(eng, t0, eta=1.0, min_samples=8) if on_
                else None)
        if lane is not None:
            lane.start(cfg["interval_s"])
        gc.callbacks.append(on_gc)
        try:
            res, ol = counted(f"load, lane {on_}", eng,
                              lambda: serve_open_loop(eng, load, arrivals))
        finally:
            gc.callbacks.remove(on_gc)
            if lane is not None:
                lane.stop()
        if len(res) != len(load):
            fail(f"phase R load: {len(res)} results of {len(load)}")
        s = eng.metrics.summary()
        lat = eng.metrics.latencies_ms
        eng.close()
        report["load"].append({
            "lane": on_, "offered_qps": ol["offered_qps"],
            "achieved_qps": ol["achieved_qps"], "capacity_qps": capacity,
            "p50_ms": s["latency_ms"]["p50"], "p99_ms": s["latency_ms"]["p99"],
            "latency_ms_max": max(lat, default=0.0),
            "over_10ms": sum(x > 10.0 for x in lat),
            "hit_rate": s["deadline"]["hit_rate"],
            "swaps": s["refresh"]["swaps"],
            "refresh_failures": s["refresh"]["refresh_failures"],
            "shortfall": shortfall(load, res),
            "lane_passes_s_ms": lane.passes if lane is not None else [],
            "validate_ms": list(eng.metrics.swap_validate_ms),
            "cuda_mallocs": segments() - segs,
            "gc_ms": {"collections": len(pauses), "total": sum(pauses),
                      "max": max(pauses, default=0.0)}})
        log(f"phase R load {json.dumps(report['load'][-1])} ({smi})")
    report["seconds"] = time.perf_counter() - t_phase
    return total, report


def plain_table(dev, groups):
    """rid -> (perm, compliant) of the plain version on each request's
    padded row in its bucket. `groups` maps (bucket, predictor or None)
    to requests; the rows go through in chunks of up to 64 (a row's
    answer does not depend on its batchmates)."""
    from repro_torch.kernels import ref
    from repro_torch.serving import alloc_staging, fill_staging

    table = {}
    for (bk, pred), reqs in groups.items():
        for i in range(0, len(reqs), 64):
            chunk = reqs[i:i + 64]
            bkc = dataclasses.replace(bk, batch=len(chunk))
            staged = fill_staging(alloc_staging(
                bkc, d_cov=None if pred is None else D, device="cpu"),
                chunk, bkc)
            t = {k: torch.tensor(v, device=dev) for k, v in staged.items()}
            if pred is None:
                want = ref.rank_audited_ref(t["u"], t["a"], t["b"], t["lam"],
                                            t["gamma"], bkc.m2, EPS)
            else:
                want = ref.predict_rank_audited_ref(
                    t["X"], pred, t["u"], t["a"], t["b"], t["gamma"],
                    bkc.m2, EPS)
            perm, comp = want[1].cpu().numpy(), want[4].cpu().numpy()
            for j, r in enumerate(chunk):
                table[r.rid] = (perm[j, :r.m2], bool(comp[j]))
    return table


def check_plain(label, results, table):
    for r in results:
        perm, comp = table[r.rid]
        if not np.array_equal(r.perm, perm) or r.compliant != comp:
            fail(f"{label}: request {r.rid} differs from the plain version")


def gc_pauses():
    """Start recording the collector's pauses (ms); returns the list and
    a function that stops the recording."""
    pauses, started = [], []

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        else:
            pauses.append((time.perf_counter() - started.pop()) * 1e3)

    gc.callbacks.append(on_gc)
    return pauses, lambda: gc.callbacks.remove(on_gc)


def serve_lattice(seed, dev, knn, capacity, wrappers, route_wrapper, smi):
    """Phase A: the adaptive lattice on the card (latency_serve.py's
    run_lattice/check_lattice: its mixes, chunks, lane settings and
    checks), with the serve_online KNN surface beside the gate's mix.
    One engine (pipeline depth 1) with a LatticeLane serves the chunks:
    c0 on the power-of-two lattice, a detector-gated re-warm (no trough,
    then a trough), c1, the phase shift c2, a second gated re-warm, c3, a
    poisoned proposal rolled back, c4. Checks: two gated swaps; the
    rollback with the stream going on; every chunk's rows bitwise a cold
    engine's on that chunk's lattice and equal to the plain version; the
    gate's mix padded at least 1.5x less than on a power-of-two engine
    serving c1 and c3; no ring allocated on the dispatch path; each
    run's launch counters equal to its flushed and phantom batches'
    route launches. Logs the corners, shadow_warm_ms a corner, the
    device ms a batch (torch.profiler) of c1 and c3 at the learned
    corners against the power-of-two ones, and p50/p99 of Poisson load
    at 0.5 x phase S's capacity with a lane.rewarm() fired from a side
    thread halfway through, against the same stream without it, in
    turns. Returns (launches summed over the driven runs, report)."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.serving import (
        Lattice,
        LatticeLane,
        Scenario,
        ServingEngine,
        TroughDetector,
        make_stream,
        poisson_arrivals,
        serve_open_loop,
    )
    from repro_torch.serving.buckets import bucket_for, fill_stats

    cfg = LATTICE
    Bm = cfg["max_batch"]
    t_phase = time.perf_counter()
    total = dict.fromkeys(wrappers, 0)
    knn_s = Scenario("serve_online_knn", m1=1024, m2=50, K=K_PRED,
                     tag="knn", d_cov=D, m1_jitter=0.5,
                     weight=cfg["knn_weight"], surface="online")
    mix0 = tuple(Scenario(**kw) for kw in LATTICE_MIX_P0) + (knn_s,)
    mix1 = tuple(Scenario(**kw) for kw in LATTICE_MIX_P1) + (knn_s,)
    s0 = seed + 29
    chunks = [make_stream(mix0, n_requests=cfg["chunk"], seed=s0),
              make_stream(mix0, n_requests=cfg["chunk"], seed=s0 + 1),
              make_stream(mix1, n_requests=cfg["chunk"], seed=s0 + 2),
              make_stream(mix1, n_requests=cfg["chunk"], seed=s0 + 3),
              make_stream(mix1, n_requests=Bm, seed=s0 + 4)]
    for i, r in enumerate(r for c in chunks[1:] for r in c):
        r.rid = 10_000 + i
    full = [r for c in chunks for r in c]

    class LatticeEngine(ServingEngine):
        """Records each flushed batch (bucket, requests), each phantom
        batch's bucket and each result's enqueue time."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.batches, self.phantoms, self.t_enq = [], [], {}

        def _build_result(self, pending, i):
            res = super()._build_result(pending, i)
            self.t_enq[res.rid] = pending.entries[i].t_enq
            return res

        def _materialize_batch(self, pending):
            self.batches.append((pending.bucket,
                                 [e.req for e in pending.entries]))
            super()._materialize_batch(pending)

        def _phantom(self, bucket, ring, fn):
            self.phantoms.append(bucket)
            super()._phantom(bucket, ring, fn)

    def engine(lattice=None, wait_ms=1e9, warm=full):
        eng = LatticeEngine(max_batch=Bm, max_wait_ms=wait_ms, eps=EPS,
                            pipeline_depth=1, lattice=lattice, device=dev)
        eng.register_predictor("knn", knn, d_cov=D)
        eng.warmup(warm)
        return eng

    def lane_of(eng):
        return LatticeLane(eng, max_executables=cfg["max_executables"],
                           min_samples=cfg["min_samples"],
                           detector=TroughDetector(
                               rate_threshold_qps=cfg["rate_qps"],
                               lag_threshold_ms=cfg["lag_ms"],
                               patience_s=cfg["patience_s"]))

    def launches_of(buckets, eng):
        out = dict.fromkeys(wrappers, 0)
        for bk in buckets:
            pred = eng._predictors.get(bk.tag)
            out[route_wrapper(pred, bk.m2)] += ops.kernel_launch_count(
                pred, bk.m2)
        return out

    def counted(label, engs, drive):
        """Drive the engine(s) `engs` with the counters at 0: they must
        equal the flushed and phantom batches' route launches, and the
        engines' own counts the flushed ones'."""
        engs = engs if isinstance(engs, list) else [engs]
        for e_ in engs:
            e_.batches.clear()
            e_.phantoms.clear()
        before = sum(e_.metrics.kernel_launches for e_ in engs)
        reset_counters(wrappers)
        out = drive()
        torch.cuda.synchronize()
        launches = read_counters(wrappers)
        flushed = launches_of([b for e_ in engs for b, _ in e_.batches],
                              engs[0])
        phantom = launches_of([b for e_ in engs for b in e_.phantoms],
                              engs[0])
        expect = {k: flushed[k] + phantom[k] for k in wrappers}
        metric = sum(e_.metrics.kernel_launches for e_ in engs) - before
        if launches != expect or metric != sum(flushed.values()):
            fail(f"phase A {label}: launch counters {launches} != flushed "
                 f"{flushed} + phantom {phantom} (metrics {metric})")
        for k, v in launches.items():
            total[k] += v
        return out

    def same(label, got, want):
        for r in got:
            w = want[r.rid]
            if (not np.array_equal(r.perm, w.perm) or r.utility != w.utility
                    or not np.array_equal(r.exposure, w.exposure)
                    or r.compliant != w.compliant):
                fail(f"phase A {label}: request {r.rid} differs")

    def plain(label, eng, reqs, got):
        """Every row of `got` against the plain version in its bucket."""
        names = {b.name: b for b in eng._rings}
        by_rid = {r.rid: r for r in reqs}
        groups = {}
        for r in got:
            bk = names[r.bucket]
            pred = knn if bk.tag == "knn" else None
            groups.setdefault((bk, pred), []).append(by_rid[r.rid])
        check_plain(f"phase A {label}", got, plain_table(dev, groups))

    def waste(batches, knn_rows=None):
        """Padded over real rank+audit work of `batches`: the KNN ones
        (True), the others (False) or all (None)."""
        real = padded = 0
        for bk, reqs in batches:
            if knn_rows is not None and (bk.tag == "knn") != knn_rows:
                continue
            f = fill_stats(reqs, bk)
            real += f["real_flops"]
            padded += f["padded_flops"]
        return padded / real

    def learned(bk):
        return bk != bucket_for(m1=bk.m1, m2=bk.m2, K=bk.K, tag=bk.tag,
                                batch=bk.batch)

    report = {"config": dict(cfg, mix_p0=LATTICE_MIX_P0,
                             mix_p1=LATTICE_MIX_P1,
                             knn_surface="m1 512-1024, m2 50, K 5, d 20, "
                                         "k 10, n_db 1,048,576")}
    # -- the gate: two detector-gated swaps, a rollback, five chunks -------
    eng = engine()
    lane = lane_of(eng)
    served, gated, marks, warmed = [], [], [], []

    def drive():
        for i, c in enumerate(chunks):
            if i == 4:
                lane.propose = lambda: Lattice(corners=((64, 128, 4),))
                gated.append(lane.rewarm())
                del lane.propose
            got = eng.serve_stream(c, warmup=False)
            marks.append(len(eng.batches))
            served.append((eng.lattice_epoch(), eng.lattice(), c, got))
            if i in (0, 2):
                now, before = eng.clock(), eng.metrics.shadow_compiles
                gated.append((lane.maybe_rewarm(now + 0.1),
                              lane.maybe_rewarm(now + 1.0)))
                warmed.append(eng.metrics.shadow_compiles - before)

    counted("gate", eng, drive)
    m = eng.metrics
    (no1, swap1), (no2, swap2), rollback = gated
    if not (no1["reason"] == no2["reason"] == "no-trough"
            and swap1["swapped"] and swap2["swapped"]
            and m.lattice_swaps == 2):
        fail(f"phase A: the swaps were not detector-gated: {gated[:2]}")
    if (rollback["swapped"] or "rewarm-failed" not in rollback["reason"]
            or m.lattice_rollbacks != 1 or served[4][0] != 2
            or len(served[4][3]) != len(chunks[4])):
        fail(f"phase A rollback: {rollback}, rollbacks "
             f"{m.lattice_rollbacks}")
    if [e for e, _, _, _ in served] != [0, 1, 1, 2, 2]:
        fail(f"phase A: chunk epochs {[e for e, _, _, _ in served]}")
    for e, _, _, got in served:
        if any(r.lattice_epoch != e for r in got):
            fail(f"phase A: a row's lattice_epoch stamp is not {e}")
    if (m.compiles_post_warmup or not m.shadow_compiles
            or m.executable_calls != m.batches):
        fail(f"phase A: compiles_post_warmup {m.compiles_post_warmup}, "
             f"shadow_compiles {m.shadow_compiles}, executable_calls "
             f"{m.executable_calls} of {m.batches} batches")
    measured = (eng.batches[marks[0]:marks[1]]
                + eng.batches[marks[2]:marks[3]])
    at_corners = sorted({bk.name for bk, _ in measured if learned(bk)})
    for tag in ("knn", "_lam"):
        if not any(n.startswith(tag + "/") for n in at_corners):
            fail(f"phase A: no {tag} batch ran at a learned corner")
    # every chunk bitwise a cold engine's on its lattice, and plain
    for i, (e, lattice, reqs, got) in enumerate(served):
        cold = engine(lattice if lattice.adaptive else None, warm=reqs)
        want = counted(f"cold {i}", cold,
                       lambda: cold.serve_stream(reqs, warmup=False))
        cold.close()
        same(f"chunk {i} (epoch {e}) against a cold engine", got,
             {r.rid: r for r in want})
        plain(f"chunk {i}", eng, reqs, got)
    # padding: the same chunks on a power-of-two engine
    base = engine()
    counted("power of two", base, lambda: (
        base.serve_stream(chunks[1], warmup=False),
        base.serve_stream(chunks[3], warmup=False)))
    base_batches, base_cpw = list(base.batches), \
        base.metrics.compiles_post_warmup
    base.close()
    pad = {label: {"pow2": waste(base_batches, rows),
                   "adaptive": waste(measured, rows)}
           for label, rows in (("gate_mix", False), ("knn", True),
                               ("all", None))}
    for row in pad.values():
        row["cut"] = row["pow2"] / row["adaptive"]
    if not pad["gate_mix"]["cut"] >= cfg["min_waste_cut"]:
        fail(f"phase A: the learned lattice cut the gate mix's padding "
             f"{pad['gate_mix']['cut']}x (< {cfg['min_waste_cut']}x): "
             f"{pad}")
    report.update({
        "swaps": m.lattice_swaps, "rollbacks": m.lattice_rollbacks,
        "shadow_compiles": m.shadow_compiles,
        "compiles_post_warmup": m.compiles_post_warmup,
        "base_compiles_post_warmup": base_cpw,
        "corners": [list(swap1["corners"]), list(swap2["corners"])],
        "corners_warmed": warmed,
        "shadow_warm_ms": [swap1["warm_ms"], swap2["warm_ms"]],
        "shadow_warm_ms_a_corner": [r["warm_ms"] / max(n, 1) for r, n in
                                    zip((swap1, swap2), warmed)],
        "learned_corners_served": at_corners,
        "padding_waste": pad})
    log(f"phase A gate {json.dumps(report)} ({smi})")

    # -- device ms a batch: c1 and c3 at the learned corners and at the
    # power-of-two ones (torch.profiler, every kernel and copy)
    report["device"] = {}
    for label, lats in (("learned", (served[1][1], served[3][1])),
                        ("pow2", (None, None))):
        engs = [engine(lat, warm=c) for lat, c in zip(lats, (chunks[1],
                                                             chunks[3]))]
        kernels = {}

        def drive_profiled():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for e_, c in zip(engs, (chunks[1], chunks[3])):
                    e_.serve_stream(c, warmup=False)
                torch.cuda.synchronize()
            for ev in prof.key_averages():
                if ev.device_time_total > 0:
                    kernels[ev.key.split("(")[0].replace("void ", "")] = \
                        ev.device_time_total / 1e3

        try:
            counted(f"profiled {label}", engs, drive_profiled)
        except (RuntimeError, AssertionError) as exc:
            kernels = f"not measured: {str(exc)[:120]}"
        batches = sum(e_.metrics.batches for e_ in engs)
        row = {"batches": batches,
               "knn_batches": sum(bk.tag == "knn" for e_ in engs
                                  for bk, _ in e_.batches)}
        if isinstance(kernels, dict):
            row.update(device_ms=sum(kernels.values()),
                       device_ms_a_batch=sum(kernels.values()) / batches,
                       by_kernel=kernels)
        else:
            row["device_ms"] = kernels
        for e_ in engs:
            e_.close()
        report["device"][label] = row
    log(f"phase A device {json.dumps(report['device'])} ({smi})")

    # -- p50/p99 at 0.5 x C, a re-warm fired halfway through, in turns
    qps = 0.5 * capacity
    load = make_stream(mix0, n_requests=cfg["n_load"], seed=s0 + 5)
    arrivals = poisson_arrivals(len(load), qps, seed=s0 + 6)
    report["load"] = []

    def segments():
        return torch.cuda.memory_stats(dev).get("segment.all.allocated", 0)

    for on_ in (False, True, True, False):
        eng = engine(wait_ms=cfg["load_wait_ms"], warm=load)
        lane = lane_of(eng)
        fired, marks_s = {}, {}
        t_run = time.perf_counter()
        propose = lane.propose

        def timed_propose():
            # the optimizer's pass over the live histogram, apart from
            # the shadow warm and the flip
            marks_s["propose_start"] = time.perf_counter() - t_run
            out = propose()
            marks_s["propose_end"] = time.perf_counter() - t_run
            return out

        lane.propose = timed_propose

        def fire():
            time.sleep(float(arrivals[len(load) // 2]))
            t = time.perf_counter()
            fired.update(lane.rewarm())
            fired["wall_ms"] = (time.perf_counter() - t) * 1e3
            marks_s["rewarm_end"] = time.perf_counter() - t_run

        def drive_load():
            side = threading.Thread(target=fire) if on_ else None
            if side is not None:
                side.start()
            out = serve_open_loop(eng, load, arrivals)
            if side is not None:
                side.join()
            return out

        segs = segments()
        pauses, stop = gc_pauses()
        try:
            res, ol = counted(f"load, re-warm {on_}", eng, drive_load)
        finally:
            stop()
        if sorted(r.rid for r in res) != list(range(len(load))):
            fail(f"phase A load: {len(res)} results of {len(load)}")
        plain(f"load, re-warm {on_}", eng, load, res)
        s = eng.metrics.summary()
        lat = eng.metrics.latencies_ms
        epochs = {}
        for r in res:
            epochs[r.lattice_epoch] = epochs.get(r.lattice_epoch, 0) + 1
        slowest = max(res, key=lambda r: r.latency_ms)
        marks_s["slowest_enqueued"] = eng.t_enq[slowest.rid] - t_run
        eng.close()
        report["load"].append({
            "rewarm": on_, "offered_qps": ol["offered_qps"],
            "achieved_qps": ol["achieved_qps"], "capacity_qps": capacity,
            "p50_ms": s["latency_ms"]["p50"], "p99_ms": s["latency_ms"]["p99"],
            "latency_ms_max": max(lat, default=0.0),
            "over_10ms": sum(x > 10.0 for x in lat),
            "rows_by_lattice_epoch": {str(k): v for k, v in epochs.items()},
            "compiles_post_warmup": s["compiles_post_warmup"],
            "lattice": s["lattice"],
            "rewarm_report": {k: v for k, v in fired.items()
                              if k in ("swapped", "epoch", "warm_ms",
                                       "wall_ms", "reason")},
            "timeline_s": marks_s,
            "cuda_mallocs": segments() - segs,
            "gc_ms": {"collections": len(pauses), "total": sum(pauses),
                      "max": max(pauses, default=0.0)}})
        log(f"phase A load {json.dumps(report['load'][-1])} ({smi})")
        if on_ and not fired.get("swapped"):
            fail(f"phase A load: the re-warm did not swap: {fired}")
    report["seconds"] = time.perf_counter() - t_phase
    return total, report


def serve_fleet(seed, dev, knn, wrappers, route_wrapper, smi):
    """Phase F: the replica fleet under chaos on the card (latency_serve
    .py's run_fleet/check_fleet: 3 replicas, its step clock, health
    settings and FaultPlan.chaos(seed=17)) at serve_online's width: two
    KNN surfaces (m1 = 1024 and 512, m2 = 50, K = 5, d = 20, k = 10) over
    phase 2's 1,048,576-row db, each replica a ServingEngine (depth 1, its
    own stream) with a RefreshLane and a CheckpointStore under build/
    (removed after). 512 requests: a fault-free prefix and a checkpointed
    refresh, then the plan, with refreshes. Checks: every rid served
    exactly once, no orphaned future or lost request, a crash and a
    restart, the restarted replica resumed at the checkpointed epoch,
    the poisoned swap refused, no ring allocated on the dispatch path
    across every incarnation, every served row equal to the plain
    version on its padded row with the generation that served it, and
    the launch counters equal to the engines' flushed and phantom
    batches' launches. Returns (launches, report)."""
    import shutil

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.core.predictors import with_state
    from repro_torch.kernels import ops
    from repro_torch.serving import (
        FaultInjector,
        FaultPlan,
        FleetRouter,
        HealthConfig,
        RefreshLane,
        Scenario,
        ServingEngine,
        Shed,
        make_stream,
    )

    cfg = FLEET
    t_phase = time.perf_counter()
    ckpt_dir = Path(__file__).resolve().parent / "build" / "phase_f_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    made = []

    class FleetEngine(ServingEngine):
        """Keeps each generation it served (by epoch), the results it
        built and its phantom batches."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.states, self.built, self.phantoms = {}, [], []

        def register_predictor(self, tag, predictor, *, d_cov):
            super().register_predictor(tag, predictor, d_cov=d_cov)
            self.states[0] = self.predictor_state_of(tag)

        def swap_predictor(self, tag, new, *, epoch=None):
            e = super().swap_predictor(tag, new, epoch=epoch)
            self.states[e] = self.predictor_state_of(tag)
            return e

        def _build_result(self, pending, i):
            res = super()._build_result(pending, i)
            self.built.append(res)
            return res

        def _phantom(self, bucket, ring, fn):
            self.phantoms.append(bucket)
            super()._phantom(bucket, ring, fn)

    def factory(name):
        eng = FleetEngine(max_batch=cfg["max_batch"], max_wait_ms=1e9,
                          eps=EPS, pipeline_depth=1, device=dev)
        eng.register_predictor(TAG_R, knn, d_cov=D)
        made.append(eng)
        store = CheckpointStore(str(ckpt_dir / name),
                                keep_last=cfg["keep_last"])
        return eng, RefreshLane(eng, eta=0.5, min_samples=8,
                                checkpoint=store)

    def step_clock():
        t = [0.0]

        def clock():
            t[0] += cfg["step_s"]
            return t[0]
        return clock

    mix = tuple(Scenario(name, m1=m1, m2=50, K=K_PRED, tag=TAG_R, d_cov=D,
                         m1_jitter=0.0, b_frac=0.25, weight=w, surface=name)
                for name, m1, w in (("feed", 1024, 2.0), ("strip", 512, 1.0)))
    n = cfg["n_requests"]
    reqs = make_stream(mix, n_requests=n, seed=seed + cfg["seed"] + 1)
    router = FleetRouter(
        factory, 3, clock=step_clock(),
        health=HealthConfig(suspect_after_s=cfg["suspect_after_s"],
                            dead_after_s=cfg["dead_after_s"]),
        heartbeat_interval_s=float("inf"),
        backoff_base_s=cfg["backoff_base_s"],
        backoff_cap_s=cfg["backoff_cap_s"], seed=cfg["seed"])
    router.warmup(reqs)
    torch.cuda.synchronize()
    for e in made:
        e.phantoms.clear()
    reset_counters(wrappers)

    def serve(chunk, out):
        for r in chunk:
            out += router.submit(r)
            out += router.poll()
            router.tick()

    results, prefix = [], n // 4
    serve(reqs[:prefix], results)
    results += router.drain()
    order = []
    for r in reqs:
        name = router.replicas[router._owners(router._bucket_key(r))[0]].name
        if name not in order:
            order.append(name)
    order += [rep.name for rep in router.replicas if rep.name not in order]
    pre = router.refresh()[order[0]][TAG_R]
    if not (pre["swapped"] and pre.get("checkpointed")):
        fail(f"phase F: the prefix refresh did not checkpoint: {pre}")
    plan = FaultPlan.chaos(order, seed=cfg["seed"], slow_ms=cfg["slow_ms"])
    router.fault_plan = plan
    for rep in router.replicas:
        rep.injector = FaultInjector(plan.faults_for(rep.name), rep.name)
        rep.lane.publish_filter = (
            lambda tag, state, inj=rep.injector: inj.poison_state(state))
    router.arm_faults()
    rest, refused = reqs[prefix:], 0
    step = max(1, len(rest) // 3)
    for i in range(0, len(rest), step):
        serve(rest[i:i + step], results)
        for reports in router.refresh().values():
            reason = str(reports.get(TAG_R, {}).get("reason", ""))
            refused += reason.startswith("refused")
    results += router.drain()
    torch.cuda.synchronize()
    launches = read_counters(wrappers)
    s = router.fleet_summary()
    served = [r for r in results if not isinstance(r, Shed)]
    crashed = next(r for r in router.replicas if r.name == order[0])
    restored = (crashed.restore_history[0].get(TAG_R)
                if crashed.restore_history else None)
    cpw = sum(e.metrics.compiles_post_warmup for e in made)
    if sorted(r.rid for r in served) != list(range(n)):
        fail(f"phase F: served {len(served)} rids, not each of {n} once")
    if s["orphaned_futures"] or s["lost"]:
        fail(f"phase F: {s['orphaned_futures']} orphaned futures, "
             f"{s['lost']} lost")
    if s["crashes"] < 1 or s["restarts"] < 1:
        fail(f"phase F: crashes {s['crashes']}, restarts {s['restarts']}")
    if restored != pre["epoch"]:
        fail(f"phase F: the restarted replica resumed at epoch {restored}, "
             f"not the checkpointed {pre['epoch']}")
    if refused < 1:
        fail("phase F: no poisoned swap was refused")
    if cpw:
        fail(f"phase F: {cpw} rings allocated on the dispatch path")
    # every served row against the plain version, with the generation of
    # the incarnation that built it
    owner = {id(res): e for e in made for res in e.built}
    by_rid = {r.rid: r for r in reqs}
    groups = {}
    for r in served:
        e = owner[id(r)]
        bk = e.bucket_of(by_rid[r.rid])
        key = (bk, id(e), r.epoch)
        groups.setdefault(key, (with_state(knn, e.states[r.epoch]), []))[
            1].append(by_rid[r.rid])
    check_plain("phase F", served, plain_table(
        dev, {(bk, pred): rs for (bk, _, _), (pred, rs) in groups.items()}))
    expect = dict.fromkeys(wrappers, 0)
    for e in made:
        pred = e.predictor_template(TAG_R)
        for bk in e.phantoms:
            expect[route_wrapper(pred, bk.m2)] += ops.kernel_launch_count(
                pred, bk.m2)
        expect[route_wrapper(pred, 64)] += e.metrics.kernel_launches
    if launches != expect:
        fail(f"phase F: launch counters {launches} != the engines' "
             f"{expect}")
    report = {
        "config": dict(cfg, replicas=3, mix="knn m1 1024 (2) and 512 (1), "
                       "m2 50, K 5, d 20, k 10, n_db 1,048,576"),
        "order": order, "plan": {k: dataclasses.asdict(v) for k, v in
                                 plan.replicas.items()},
        **{k: s[k] for k in ("served", "crashes", "restarts", "failovers",
                             "hedges", "hedge_wins", "duplicates_deduped",
                             "retries", "heartbeats_missed", "lost",
                             "orphaned_futures")},
        "latency_ms": s.get("latency_ms"),
        "poisoned_swaps_refused": refused, "last_good_epoch": pre["epoch"],
        "restored_epoch": restored, "compiles_post_warmup": cpw,
        "incarnations": len(made),
        "restart_ms": {rep.name: rep.restart_ms for rep in router.replicas
                       if rep.restart_ms},
        "prefix_refresh_ms": pre.get("ms"),
        "replicas": {name: {k: v for k, v in row.items()
                            if k in ("state", "transitions", "restarts",
                                     "restored_epochs", "requests",
                                     "batches", "swaps",
                                     "refresh_failures")}
                     for name, row in s["replicas"].items()}}
    router.close()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    report["seconds"] = time.perf_counter() - t_phase
    log(f"phase F {json.dumps(report)} ({smi})")
    return launches, report


def jax_report_keys():
    """{"engine": keys, "fleet": keys} of the report that the JAX
    launcher (src/repro/launch/serve.py) prints, read from its source,
    which is parsed, not imported: the dict literal assigned to `report`,
    then each path's report.update({...})."""
    path = Path(__file__).resolve().parent / "src/repro/launch/serve.py"
    tree = ast.parse(path.read_text())
    base, paths = None, {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "report"
                for t in node.targets):
            base = [k.value for k in node.value.keys]
        if isinstance(node, ast.If) and "replicas" in ast.unparse(node.test):
            for name, body in (("fleet", node.body),
                               ("engine", node.orelse)):
                for stmt in body:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Call) and \
                                ast.unparse(sub.func) == "report.update":
                            paths[name] = [k.value for k in
                                           sub.args[0].keys]
    return {name: base + keys for name, keys in paths.items()}


def serve_deployments(seed, dev, wrappers, route_wrapper, smi):
    """Phase D: the port's launch.serve body (deploy, request_stream,
    serve) for each recsys arch at its published config, then the
    --admission path on sasrec and the --replicas 3 path on mind on the
    same deployment. Returns (launches summed over the runs, report)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve as launch
    from repro_torch.serving.engine import RankResult, ServingEngine

    class CheckedEngine(ServingEngine):
        """Keeps each flushed batch's padded inputs (copied before the
        slot goes back to its ring), rids and outputs, and each phantom
        batch's bucket."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.captured, self.phantoms = [], []

        def _materialize_batch(self, pending):
            staged = {k: v.copy() for k, v in pending.staged.items()}
            super()._materialize_batch(pending)
            self.captured.append(
                (pending.bucket, staged,
                 [e.req.rid for e in pending.entries], pending.out))

        def _phantom(self, bucket, ring, fn):
            self.phantoms.append(bucket)
            super()._phantom(bucket, ring, fn)

    keys = jax_report_keys()
    t_phase = time.perf_counter()
    total = dict.fromkeys(wrappers, 0)
    report = {}
    base_argv = [
        "--requests", str(DEPLOY["requests"]),
        "--candidates", str(DEPLOY["candidates"]),
        "--m2", str(DEPLOY["m2"]),
        "--constraints", str(DEPLOY["constraints"]),
        "--train-steps", str(DEPLOY["train_steps"]),
        "--offline-users", str(DEPLOY["offline_users"]),
        "--max-batch", str(DEPLOY["max_batch"]),
        "--max-wait-ms", str(DEPLOY["max_wait_ms"]),
        "--pipeline-depth", str(DEPLOY["pipeline_depth"]),
        "--m1-jitter", str(DEPLOY["m1_jitter"])]

    def check_served(label, dep, reqs, rep, args):
        """Every rid once; every served row's perm and compliant equal
        the plain version on its own padded row; the launch counters
        equal the flushed and phantom batches' route launches."""
        results = dep.served["results"]
        if sorted(r.rid for r in results) != list(range(len(reqs))):
            fail(f"phase D {label}: rids not served exactly once")
        if list(rep) != keys["fleet" if args.replicas > 1 else "engine"]:
            fail(f"phase D {label}: report keys {list(rep)} are not the "
                 f"JAX launcher's")
        if rep["compiles_post_warmup"] != 0:
            fail(f"phase D {label}: {rep['compiles_post_warmup']} rings "
                 f"built on the dispatch path")
        by_rid = {r.rid: r for r in results if isinstance(r, RankResult)}
        preds = {args.arch: dep.knn, f"{args.arch}_mean": dep.mean}
        expect = dict.fromkeys(wrappers, 0)
        checked = 0
        for eng in dep.served["engines"]:
            for bucket in eng.phantoms:
                pred = preds[bucket.tag]
                expect[route_wrapper(pred, bucket.m2)] += \
                    ops.kernel_launch_count(pred, bucket.m2)
            for bucket, staged, rids, out in eng.captured:
                pred = preds[bucket.tag]
                expect[route_wrapper(pred, bucket.m2)] += \
                    ops.kernel_launch_count(pred, bucket.m2)
                t = {k: torch.tensor(v, device=dev)
                     for k, v in staged.items()}
                want = ref.predict_rank_audited_ref(
                    t["X"], pred, t["u"], t["a"], t["b"], t["gamma"],
                    bucket.m2, EPS)
                w_perm, w_comp = want[1].cpu().numpy(), \
                    want[4].cpu().numpy()
                for i, rid in enumerate(rids):
                    res, req = by_rid[rid], reqs[rid]
                    if not np.array_equal(res.perm, w_perm[i, :req.m2]) or \
                            bool(res.compliant) != bool(w_comp[i]):
                        fail(f"phase D {label}: request {rid} differs from "
                             f"the plain version")
                    checked += 1
        if checked != len(by_rid):
            fail(f"phase D {label}: checked {checked} of {len(by_rid)} "
                 f"served rows")
        return expect

    runs = [("deepfm", ()), ("sasrec", ()), ("sasrec", ("--admission",)),
            ("bert4rec", ()), ("mind", ()), ("mind", ("--replicas", "3"))]
    dep = reqs = None
    for arch, extra in runs:
        args = launch.build_parser().parse_args(
            ["--arch", arch, *base_argv, *extra])
        cfg = get_arch(arch).make_config(full=True)
        label = arch + "".join(f" {x}" for x in extra)
        torch.cuda.synchronize()
        reset_counters(wrappers)
        t0 = time.perf_counter()
        n_scores = 0
        if not extra:
            dep = reqs = None
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            dep = launch.deploy(cfg, args, dev)
            reqs = launch.request_stream(dep, args)
            # one backbone call per offline chunk and per arrival chunk
            n_scores = (math.ceil(args.offline_users / launch.SCORE_CHUNK)
                        + math.ceil(args.requests / launch.ARRIVAL_CHUNK))
        rep = launch.serve(dep, reqs, args, engine_cls=CheckedEngine)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_counters(wrappers)
        expect = check_served(label, dep, reqs, rep, args)
        if cfg.kind == "deepfm":
            expect["embedding_bag"] = n_scores
        if launches != expect:
            fail(f"phase D {label}: launch counters {launches} != the "
                 f"batches' route launches and the scoring calls {expect}")
        if cfg.kind == "deepfm" and not launches["embedding_bag"]:
            fail("phase D: DeepFM's scoring launched no embedding_bag")
        if "--admission" in extra and not launches["linear_rank_audited"]:
            fail("phase D: the mean rung launched no linear_rank_audited")
        if not launches["knn_rank_audited"]:
            fail(f"phase D {label}: knn_rank_audited never launched")
        for k, v in launches.items():
            total[k] += v
        row = {"wall_s": wall_s, "launches": {k: v for k, v in
                                              launches.items() if v},
               "requests": rep["requests"], "served": rep["served"],
               "shed": rep["shed"], "latency_ms": rep["latency_ms"],
               "compiles_post_warmup": rep["compiles_post_warmup"],
               "offline_compliance": rep["offline_compliance"]}
        if args.replicas > 1:
            row.update(fleet=rep["fleet"],
                       replica_states=rep["replica_states"])
        else:
            row.update(fill_rate=rep["fill_rate"],
                       online_compliance=rep["online_compliance"],
                       deadline=rep["deadline"],
                       exec_ms_per_batch=rep["pipeline"][
                           "exec_ms_per_batch"],
                       overlap_ratio=rep["pipeline"]["overlap_ratio"])
        if not extra:
            model = dep.model
            chunk = launch.request_batch(cfg, launch.ARRIVAL_CHUNK, 99, dev)
            row.update(
                n_params=cfg.n_params, d_cov=dep.d_cov,
                stages_s={k: v for k, v in dep.timings.items()},
                train_wall_ms_per_step=dep.timings["train_s"]
                / args.train_steps * 1e3,
                score_ms_per_chunk=time_ms(lambda: dep.score(chunk), 5),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            # the training step's device time (torch.profiler) over 5
            # more steps on fresh optimiser state, after serving
            opt = model.init_opt()
            batches = [launch.train_batch(cfg, 10_000 + s, dev)
                       for s in range(5)]

            def steps():
                nonlocal opt
                for bt in batches:
                    opt, _ = model.train_step(opt, bt, lr=launch.TRAIN_LR)

            split = device_split({"step": steps}, reps=1)["step"]
            row["train_device_ms_per_step"] = (
                sum(split.values()) / len(batches)
                if isinstance(split, dict) else split)
            if cfg.kind == "deepfm":
                from repro_torch.launch.graph_analysis import device_category
                cats = {}
                for kname, kms in (split.items()
                                   if isinstance(split, dict) else ()):
                    c = device_category(kname)
                    cats[c] = cats.get(c, 0.0) + kms / len(batches)
                cost_run(
                    "deepfm train step",
                    lambda params, opt, batch, cls=type(model), cfg=cfg:
                    cls.bound(cfg, params).functional_step(
                        params, opt, batch, lr=launch.TRAIN_LR),
                    (model.params(), opt, batches[0]),
                    time_ms(steps, 1, groups=1) / len(batches), cats)
            del opt, batches
            if cfg.kind == "deepfm":
                ctx_ids = chunk[:, 1:].contiguous()
                if not torch.equal(model.context_sum(ctx_ids),
                                   ref.embedding_bag_ref(
                                       model.table.detach(), ctx_ids)):
                    fail("phase D: DeepFM's context sum differs from the "
                         "embedding_bag plain version")
                bag = device_split(
                    {"bag": lambda: model.context_sum(ctx_ids)})["bag"]
                row["embedding_bag_device_ms"] = (
                    sum(bag.values()) if isinstance(bag, dict) else bag)
                row["context_sum_bitwise_plain"] = True
        report[label] = row
        log(f"phase D {label}: {json.dumps(row)} ({smi})")
    del dep, reqs
    gc.collect()
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_phase
    return total, report


# phase M: the paper's cells (src/repro/configs/paper.py) at full width
# on a virtual (2, 4) mesh over the card; the engine's dist executor on
# the serve_online KNN surface (f32 and int8), phase 3's lambda-given
# and linear requests and 32 KNN requests at m2 = 500
MESH_MIX = {("knn", 50): 192, ("knn_int8", 50): 96, ("_lam", 50): 96,
            ("linear", 50): 96, ("knn", 500): 32}
MESH_QUANT_B = 8192           # queries of the quantized distributed check


OFFLINE_FIELDS = ("lam", "dual_value", "primal_value", "exposure",
                  "compliant")
RANKED_FIELDS = ("perm", "utility", "exposure", "compliant", "lam")


def whole_fields(out, names):
    """An output's fields as whole tensors (a partitioned program's are
    launch.mesh.Sharded, gathered on the mesh's first device)."""
    from repro_torch.launch.mesh import Sharded
    return {f: (v.gather() if isinstance(v := getattr(out, f), Sharded)
                else v) for f in names}


class replicas_recorded:
    """Within the block, every position's block of each output a
    partitioned paper program assembles (distributed.topk.assemble, as
    core.dual_solver and core.serving_dist call it) is kept in a list,
    before the Sharded keeps one copy a device."""

    def __enter__(self):
        from repro_torch.core import serving_dist
        from repro_torch.distributed import topk
        self.mods, self.real, seen = (topk, serving_dist), topk.assemble, []

        def recording(mesh, xs, spec, shape):
            seen.append((mesh, list(xs), spec, shape))
            return self.real(mesh, xs, spec, shape)
        for mod in self.mods:
            mod.assemble = recording
        return seen

    def __exit__(self, *exc):
        for mod in self.mods:
            mod.assemble = self.real


def held_replicas(label, seen):
    """Fails unless every position's copy of each output block equals
    the first position's copy of that block, bit for bit. Returns the
    copies compared."""
    from repro_torch.distributed.topk import positions
    from repro_torch.launch.mesh import block_of, spec_entries
    copies = 0
    for mesh, xs, spec, shape in seen:
        entries = spec_entries(spec, len(shape))
        first = {}
        for i, pos in enumerate(positions(mesh)):
            blk = block_of(mesh, entries, pos)
            if blk in first:
                copies += 1
                if not torch.equal(first[blk], xs[i]):
                    fail(f"{label}: position {pos}'s copy of block {blk} "
                         f"differs from its first copy")
            first.setdefault(blk, xs[i])
    return copies


def peak_gib(fn):
    """The card's allocated peak (GiB, the phase's resident tensors
    included) over one call of fn."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def serve_mesh(seed, dev, X_db, lam_db, predictors, wrappers, smi):
    """Phase M: build_paper's programs for every cell of PAPER_CELLS, the
    global one on a one-device mesh and PaperConfig() and
    PaperConfig(distributed=True) on a virtual make_smoke_mesh() over
    the card, on the same seeded arrays, each serve cell's dist program
    also against the plain versions (one shard
    body's knn_topk and fused_rank launches at this cell's shard shapes,
    and the whole cell's lambda-hat and ranking); the merged
    sharded_knn_topk over the 1,048,576 rows against one knn_topk launch
    and against its plain version; knn_predict_quant_distributed over
    the int8 pack against knn_lambda_quant; then
    ServingEngine(executor="dist") against the default engine on one
    stream of MESH_MIX. Returns (launches of the distributed paths,
    launches of the dense programs and the default engine, report)."""
    from repro_torch.configs.paper import PAPER_CELLS, PaperConfig, build_paper
    from repro_torch.core.constraints import dcg_discount
    from repro_torch.core.predictors import _idw_lambda
    from repro_torch.core.serving_dist import (
        dist_kernel_launches,
        knn_predict_quant_distributed,
    )
    from repro_torch.distributed.topk import sharded_knn_topk
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.common import sq_norm_seq
    from repro_torch.kernels.fused_rank import fused_rank_cuda
    from repro_torch.kernels.knn_topk import (
        knn_lambda_quant_cuda,
        knn_topk_cuda,
    )
    from repro_torch.launch.mesh import (
        make_smoke_mesh,
        shard_rows,
        virtual_mesh,
    )
    from repro_torch.serving.engine import RankRequest, ServingEngine

    t_phase = time.perf_counter()
    mesh = make_smoke_mesh(device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 41)
    total = dict.fromkeys(wrappers, 0)
    dense_total = dict.fromkeys(wrappers, 0)
    expect = dict.fromkeys(wrappers, 0)
    cfg = PaperConfig()
    report = {"mesh": f"virtual {mesh.axis_sizes} {mesh.axis_names} over "
                      f"{dev} (the shards share one card)", "cells": {}}

    def counted(call, launches=None):
        """call() with the counters from 0; their reading is added to the
        distributed paths' total and `launches` to what those routes
        predict, or with launches None to the dense side's total."""
        torch.cuda.synchronize()
        reset_counters(wrappers)
        out = call()
        torch.cuda.synchronize()
        into = dense_total if launches is None else total
        for name, n in read_counters(wrappers).items():
            into[name] += n
        for name, n in (launches or {}).items():
            expect[name] += n
        return out

    def hold_plain(cell, X, u, a, b, X_cell, lam_cell, out, row):
        """A serve cell's dist program against the plain versions: batch
        block 0, shard 0's inputs through knn_topk_cuda and fused_rank_cuda
        (the shard bodies' kernels at this cell's shard shapes), bitwise;
        the whole cell's lambda-hat (the plain selection, weighted) and
        ranking (rank_audited_ref), perm and compliant exact, floats
        within their tolerance. Returns the plain selection."""
        B, m1, K, m2 = cell["batch"], cell["m1"], cell["K"], cell["m2"]
        rows = B // mesh.shape["data"]
        shards = mesh.shape["model"]
        n_l, m1_l = X_cell.shape[0] // shards, m1 // shards
        xq, xdb = X[:rows], X_cell[:n_l]
        if not bitwise(knn_topk_cuda(xq, xdb, k=cfg.knn_k, device=dev),
                       ref.knn_topk_ref(xq, xdb, cfg.knn_k)):
            fail(f"phase M {cell.name}: knn_topk at the shard shape "
                 f"{tuple(xq.shape)} x {tuple(xdb.shape)} differs from the "
                 f"plain version")
        kk = min(m2, m1_l)
        u_l = u[:rows, :m1_l].contiguous()
        a_l = a[:, :m1_l].expand(rows, K, m1_l).contiguous()
        if not bitwise(fused_rank_cuda(u_l, a_l, out.lam[:rows], m2=kk,
                                       eps=cfg.eps, device=dev),
                       ref.fused_rank_ref(u_l, a_l, out.lam[:rows], kk,
                                          cfg.eps)):
            fail(f"phase M {cell.name}: fused_rank at the shard shape "
                 f"{tuple(a_l.shape)} kk {kk} differs from the plain version")
        del u_l, a_l
        d2, idx = ref.knn_topk_ref(X, X_cell, cfg.knn_k)
        sel = idx.long()
        lam = _idw_lambda(d2, sq_norm_seq(X)[:, None],
                          sq_norm_seq(X_cell[sel]), lam_cell[sel])
        if not torch.allclose(out.lam, lam, **LAM_TOL):
            fail(f"phase M {cell.name}: lambda-hat outside {LAM_TOL} of the "
                 f"plain version")
        want = ref.rank_audited_ref(
            u, a.expand(B, K, m1), b.expand(B, K), out.lam,
            dcg_discount(m2).to(u.device).expand(B, m2), m2, cfg.eps)
        if not (torch.equal(out.perm, want[1])
                and torch.equal(out.compliant, want[4])):
            fail(f"phase M {cell.name}: perm or compliant differs from "
                 f"rank_audited_ref's")
        if not (torch.allclose(out.utility, want[2], **TOL)
                and torch.allclose(out.exposure, want[3], **TOL)):
            fail(f"phase M {cell.name}: utility or exposure outside {TOL} "
                 f"of rank_audited_ref's")
        row["plain_bitwise"] = all(torch.equal(g, w) for g, w in (
            (out.lam, lam), (out.utility, want[2]), (out.exposure, want[3])))
        return d2, idx

    bodies = mesh.shape["model"] * mesh.shape["data"]
    one = virtual_mesh((1, 1), ("data", "model"), dev)
    db = shard_rows(mesh, X_db)          # placed once: views on the card
    for cell in PAPER_CELLS:
        B, m1, K, m2 = cell["batch"], cell["m1"], cell["K"], cell["m2"]
        u = torch.rand((B, m1), generator=gen, device=dev) * 4.0 + 1.0
        a = (torch.rand((K, m1), generator=gen, device=dev) < 0.15).float()
        b = torch.full((K,), 0.05, device=dev)
        a_b = a.expand(B, K, m1).contiguous()
        # the global program (one device), the default variant partitioned
        # over the mesh, and the dist-topk variant
        progs = {"global": build_paper(cfg, cell, one),
                 "partitioned": build_paper(cfg, cell, mesh),
                 "dist": build_paper(PaperConfig(distributed=True), cell,
                                     mesh)}
        if cell.kind == "offline":
            args = dict.fromkeys(progs, (u, a_b, b))
            names = OFFLINE_FIELDS
        else:
            n_db = cell["n_db"]
            X = torch.randn((B, D), generator=gen, device=dev)
            dense = (X, u, a_b, b, X_db[:n_db], lam_db[:n_db])
            args = {"global": dense, "partitioned": dense,
                    "dist": (X, u, a, b, db if n_db == X_db.shape[0]
                             else X_db[:n_db], lam_db[:n_db])}
            names = RANKED_FIELDS
        for label, prog in progs.items():
            for arg, spec in zip(args[label], prog.args):
                if tuple(arg.shape) != spec.shape or arg.dtype != spec.dtype:
                    fail(f"phase M {cell.name}: an argument {tuple(arg.shape)}"
                         f" {arg.dtype} is not {spec}")
        glob = counted(lambda: progs["global"].fn(*args["global"]))
        launches = ({} if cell.kind == "offline" else
                    {"knn_topk": 2 * bodies, "fused_rank": bodies})
        with replicas_recorded() as seen:
            part = counted(lambda: progs["partitioned"].fn(
                *args["partitioned"]), launches)
        row = {"replica_blocks": held_replicas(f"phase M {cell.name}",
                                               seen)}
        dist = counted(lambda: progs["dist"].fn(*args["dist"]), launches)
        part, whole_dist = (whole_fields(o, names) for o in (part, dist))
        for f in names:
            if not torch.equal(part[f], whole_dist[f]):
                fail(f"phase M {cell.name}: {f} of the partitioned default "
                     f"differs from the dist-topk program's")
        if cell.kind == "offline":
            differ = [f for f in names
                      if not torch.equal(part[f], getattr(glob, f))]
            if differ:
                fail(f"phase M offline_dual: {differ} of the partitioned "
                     f"solve differ from the global solve's")
            if not bool(torch.isfinite(glob.lam).all()):
                fail("phase M offline_dual: non-finite prices")
        else:
            if not torch.equal(part["perm"], glob.perm):
                fail(f"phase M {cell.name}: perm differs from the global "
                     f"program's in "
                     f"{int((part['perm'] != glob.perm).sum())} slots")
            if not torch.equal(part["compliant"], glob.compliant):
                fail(f"phase M {cell.name}: compliant differs from the "
                     f"global program's")
            for f, tol in (("utility", TOL), ("exposure", TOL),
                           ("lam", LAM_TOL)):
                g, w = part[f], getattr(glob, f)
                if not torch.allclose(g, w, **tol):
                    fail(f"phase M {cell.name}: {f} outside {tol} of the "
                         f"global program's")
                row[f"{f}_max_abs_err"] = float((g - w).abs().max())
                row[f"{f}_bitwise"] = torch.equal(g, w)
            plain_sel = hold_plain(cell, X, u, a, b, X_db[:n_db],
                                   lam_db[:n_db], dist, row)
        row["compliance"] = float(glob.compliant.float().mean())
        for label, prog in progs.items():
            row[f"{label}_ms"] = time_ms(lambda: prog.fn(*args[label]), 1,
                                         groups=TIMED_RUNS)
            row[f"{label}_peak_gib"] = peak_gib(lambda: prog.fn(*args[label]))
        # the global program for phase Y: its time, and one profiled run
        cost_run(f"paper-ranking {cell.name} dense", progs["global"].fn,
                 args["global"], row["global_ms"],
                 categories_of(lambda: progs["global"].fn(*args["global"])))
        report["cells"][cell.name] = row
        log(f"phase M {cell.name}: {json.dumps(row)} ({smi})")
        if cell.name == "serve_online":
            Xq, Xq_sel = X, plain_sel
        del u, a, b, a_b, args, glob, part, dist, whole_dist, seen
        gc.collect()
        torch.cuda.empty_cache()

    # the sharded knn_topk against its plain version (the streamed sweep
    # over the whole db, bitwise) and one launch over the whole db
    got = counted(lambda: sharded_knn_topk(mesh, Xq, db, KNN_K),
                  {"knn_topk": 2 * bodies})
    if not bitwise(got, Xq_sel):
        fail("phase M: sharded_knn_topk over 8192 queries x 1,048,576 rows "
             "differs from the plain version")
    want = ops.knn_topk(Xq, X_db, k=KNN_K, device=dev)
    torch.cuda.synchronize()
    if not torch.equal(got[1], want[1]):
        fail("phase M: sharded_knn_topk's idx differs from one knn_topk "
             "launch")
    if not torch.equal(got[0], want[0]):
        if not torch.allclose(got[0], want[0], rtol=1e-6, atol=0.0):
            fail("phase M: sharded_knn_topk's d2 outside rtol 1e-6")
    report["knn_topk_bitwise"] = torch.equal(got[0], want[0])
    # the quantized distributed KNN over the int8 pack (slab 512)
    pack = predictors["knn_int8"]
    Xs = Xq[:MESH_QUANT_B]
    t0 = time.perf_counter()
    got = knn_predict_quant_distributed(mesh, pack.X_q, pack.q_scale,
                                        pack.y2_q, lam_db, Xs, k=KNN_K)
    torch.cuda.synchronize()
    report["quant_dist_s"] = time.perf_counter() - t0
    want, _ = knn_lambda_quant_cuda(Xs, pack.X_q, pack.q_scale, pack.y2_q,
                                    lam_db, k=KNN_K, mode="int8",
                                    device=dev)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, **LAM_TOL):
        fail(f"phase M: knn_predict_quant_distributed outside {LAM_TOL} of "
             f"knn_lambda_quant")
    report["quant_lam_max_abs_err"] = float((got - want).abs().max())
    report["quant_lam_bitwise"] = torch.equal(got, want)
    del Xq, Xq_sel, Xs, got, want

    # the engine's dist executor against the default engine
    rng = np.random.default_rng(seed + 41)
    kinds = [kind for kind, n in MESH_MIX.items() for _ in range(n)]
    reqs = []
    for rid, i in enumerate(rng.permutation(len(kinds))):
        tag, m2r = kinds[i]
        gam = (1.0 / np.log2(np.arange(2, m2r + 2))).astype(np.float32)
        mm1 = int(rng.integers(512, 1025))
        kw = dict(rid=rid, m2=m2r, gamma=gam,
                  u=rng.uniform(1.0, 5.0, mm1).astype(np.float32),
                  a=(rng.random((K_PRED, mm1)) < 0.15).astype(np.float32),
                  b=np.full(K_PRED, 0.06 * gam.sum(), np.float32))
        if tag == "_lam":
            kw.update(lam=rng.exponential(0.5, K_PRED).astype(np.float32))
        else:
            kw.update(X=(rng.normal(size=D) / math.sqrt(D)).astype(
                np.float32), tag=tag)
        reqs.append(RankRequest(**kw))

    class Batches(ServingEngine):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.flushed = []

        def _materialize_batch(self, pending):
            super()._materialize_batch(pending)
            self.flushed.append(pending.bucket)

    served = {}
    for label, kw in (("default", {}), ("dist", {"executor": "dist",
                                                 "mesh": mesh})):
        eng = Batches(max_batch=32, max_wait_ms=2.0, eps=EPS,
                      pipeline_depth=1, device=dev, **kw)
        for tag in ("knn", "knn_int8", "linear"):
            eng.register_predictor(tag, predictors[tag], d_cov=D)
        eng.warmup(reqs)
        eng.flushed.clear()
        t0 = time.perf_counter()
        res = counted(lambda: eng.serve_stream(reqs),
                      {} if label == "dist" else None)
        wall = time.perf_counter() - t0
        summary = eng.metrics.summary()
        if label == "dist":
            for bk in eng.flushed:
                for name, n in dist_kernel_launches(
                        predictors.get(bk.tag), bk.m2, mesh=mesh).items():
                    expect[name] += n
            if summary["compiles_post_warmup"] != 0:
                fail(f"phase M dist engine: compiles_post_warmup "
                     f"{summary['compiles_post_warmup']}")
        served[label] = {r.rid: r for r in res}
        report[f"engine_{label}"] = {
            "wall_s": wall, "batches": summary["batches"],
            "latency_ms": summary["latency_ms"],
            "compliance": summary["compliance"],
            "kernel_launches": summary["kernel_launches"]}
        log(f"phase M engine {label}: "
            f"{json.dumps(report[f'engine_{label}'])} ({smi})")
        eng.close()
    dist_rows, dense_rows = served["dist"], served["default"]
    if not sorted(dist_rows) == sorted(dense_rows) == list(range(len(reqs))):
        fail("phase M engine: rids not served exactly once by both")
    rows_bitwise = True
    for rid, w in dense_rows.items():
        g = dist_rows[rid]
        if not np.array_equal(g.perm, w.perm) or g.compliant != w.compliant:
            fail(f"phase M engine: request {rid} differs from the default "
                 f"engine's")
        if not (np.allclose(g.utility, w.utility, **TOL)
                and np.allclose(g.exposure, w.exposure, **TOL)):
            fail(f"phase M engine: request {rid}'s floats outside {TOL}")
        rows_bitwise &= (g.utility == w.utility
                         and np.array_equal(g.exposure, w.exposure))
    report["engine_rows_bitwise"] = bool(rows_bitwise)
    if total != expect:
        fail(f"phase M launch counters {total} != the routes' {expect}")
    for name in ("knn_topk", "fused_rank", "knn_lambda", "knn_lambda_quant"):
        if total[name] == 0:
            fail(f"phase M: {name} never launched on the distributed paths")
    report["seconds"] = time.perf_counter() - t_phase
    log(f"phase M: {json.dumps({k: v for k, v in report.items() if k != 'cells'})} ({smi})")
    return total, dense_total, report


def serve_xla(dev, reqs, predictors, fused_rows, fused_summary, fused_s,
              wrappers):
    """Phase 3's xla row: phase 3's stream through
    ServingEngine(executor="xla") on the card. Fails unless no wrapper's
    counter moves and the engine counts 0 launches, and, on every
    request whose adjacent scores among its first m2 + 1 (by the xla
    route's lambda-hat) part by more than XLA_MARGIN relative, perm and
    compliant equal the fused engine's and utility and exposure lie
    within TOL of them. Logs how many requests fall under the margin and
    each engine's wall time a batch."""
    from repro_torch.serving.engine import ServingEngine

    eng = ServingEngine(max_batch=32, max_wait_ms=2.0, eps=EPS,
                        executor="xla", device="cuda")
    for tag, p in predictors.items():
        eng.register_predictor(tag, p, d_cov=D)
    eng.warmup(reqs)
    torch.cuda.synchronize()
    reset_counters(wrappers)
    t0 = time.perf_counter()
    results = eng.serve_stream(reqs)
    xla_s = time.perf_counter() - t0
    launches = read_counters(wrappers)
    summary = eng.metrics.summary()
    eng.close()
    if any(launches.values()) or eng.metrics.kernel_launches != 0:
        fail(f"phase 3 xla: launches {launches} (metrics "
             f"{eng.metrics.kernel_launches}), expected none")
    got = {r.rid: r for r in results}
    if sorted(got) != list(range(len(reqs))):
        fail(f"phase 3 xla: served {len(got)} of {len(reqs)} requests")
    # the xla route's lambda-hat of every request, one predict a tag
    lam_of = {r.rid: torch.tensor(r.lam, device=dev) for r in reqs
              if r.lam is not None}
    for tag, pred in predictors.items():
        mine = [r for r in reqs if r.lam is None and r.tag == tag]
        if mine:
            lam = pred.predict(torch.tensor(np.stack([r.X for r in mine]),
                                            device=dev))
            lam_of.update({r.rid: lam[i] for i, r in enumerate(mine)})
    under, perm_differs = 0, 0
    for req in reqs:
        g, f = got[req.rid], fused_rows[req.rid]
        u = torch.tensor(req.u, device=dev)
        a = torch.tensor(req.a, device=dev)
        s = torch.sort(u + (1.0 + EPS) * (lam_of[req.rid] @ a),
                       descending=True).values
        s = s[:req.m2 + 1]
        gap = (s[:-1] - s[1:]) / s[:-1].abs().clamp_min(1e-30)
        if float(gap.min()) <= XLA_MARGIN:
            under += 1
            if not np.array_equal(g.perm, f.perm):
                perm_differs += 1
                continue
        if not np.array_equal(g.perm, f.perm) or g.compliant != f.compliant:
            fail(f"phase 3 xla: request {req.rid} differs from the fused "
                 f"engine's (smallest score gap {float(gap.min())})")
        if not np.allclose(g.utility, f.utility, **TOL) or \
                not np.allclose(g.exposure, f.exposure, **TOL):
            fail(f"phase 3 xla: request {req.rid}'s utility or exposure "
                 f"differs from the fused engine's")
    return {"requests": len(results), "batches": summary["batches"],
            "launches": launches, "under_margin": under,
            "perm_differs_under_margin": perm_differs,
            "xla_ms_a_batch": xla_s * 1e3 / summary["batches"],
            "fused_ms_a_batch": fused_s * 1e3 / fused_summary["batches"],
            "xla_latency_ms": summary["latency_ms"],
            "fused_latency_ms": fused_summary["latency_ms"]}


# phase Z: the LM half of the zoo at the card's published widths.
# llama3.2-1b at FULL width and depth (src/repro/configs/llama3_2_1b.py):
# prefill at B=2, S=4096 (the chunked path: S > dense_attn_threshold
# 1024), 8 decode steps at B=16 against a 32,768-token cache (the
# decode_32k cell's sequence length at batch 16 of its 128), 3 train
# steps at B=2, S=4096 (the train_4k cell's sequence, batch 2 of its
# 256) with f32 moments; llama4-scout at FULL width, depth cut from 48
# layers to 2 (one card holds 13 GB of its 217 GB of bf16 weights);
# scout's decode against forward at 1 x (4 + 4) tokens: top-1 of at most
# 8 tokens fits the least capacity, 8, so nothing drops
ZOO = dict(prefill=(2, 4096), decode=(16, 1016, 8, 32768), train=(2, 4096, 3),
           attn_check=(2, 2048), scout_layers=2, scout=(1, 2048, 4),
           scout_short=(1, 4, 4))
# bf16 logits (std ~0.9 at random init) of two evaluation orders, decode
# against forward: max abs and relative L2 error. A CPU run of the same
# 16-layer layout (bf16, S=64) measured 0.0625 and 1.39e-2
LM_BF16_TOL = dict(max_abs=0.25, rel_l2=4e-2)
ATTN_TOL = dict(rtol=2e-4, atol=1e-5)


def by_category(prof):
    """A profile's device ms by the dry run's op categories."""
    from repro_torch.launch.graph_analysis import device_time_by_category
    return device_time_by_category(prof)


def categories_of(fn):
    """fn()'s device ms by category, from one torch.profiler pass. The
    profiler may drop kernel records (on the card it once reported 2 of
    3 launches of one kernel), so phase Y checks CUDA-event times."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return by_category(prof)


def cost_run(name, fn, args, device_ms, categories):
    """Keep a program an earlier phase ran for phase Y: `fn` and the
    shapes and dtypes of the arguments it ran on (no tensor is kept),
    with its device ms (CUDA events) and that ms by category (the
    profiler's)."""
    from repro_torch.configs.registry import ArgSpec
    from repro_torch.distributed.sharding import tree_map
    specs = tuple(tree_map(
        lambda x: ArgSpec(tuple(x.shape), x.dtype)
        if isinstance(x, torch.Tensor) else x, a) for a in args)
    COST_RUNS.append({"name": name, "fn": fn, "args": specs,
                      "ms": device_ms, "by_category": categories})


def lm_part(fn):
    """fn() once: (its output, {wall_ms (synchronised host clock),
    device_ms (torch.profiler: the sum of its kernels' device times),
    by_category (that device time by the dry run's op categories,
    graph_analysis.device_time_by_category), peak_gib (the card's
    allocated peak)})."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    device = sum(ev.device_time_total for ev in prof.key_averages()) / 1e3
    return out, {"wall_ms": wall, "device_ms": device or "not measured",
                 "by_category": by_category(prof),
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def bf16_close(label, got, want):
    """Fails unless `got` is within LM_BF16_TOL of `want`; returns the
    two errors."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        fail(f"{label}: non-finite logits")
    diff = got - want
    err = {"max_abs": float(diff.abs().max()),
           "rel_l2": float(diff.norm() / want.norm())}
    if err["max_abs"] > LM_BF16_TOL["max_abs"] or \
            err["rel_l2"] > LM_BF16_TOL["rel_l2"]:
        fail(f"{label}: {err} outside {LM_BF16_TOL}")
    return err


def serve_lm_zoo(seed, dev, smi):
    """Phase Z: the LM half of the zoo on the card (ZOO). Fails unless
    prefill's last logits equal a dense-attention lm_forward's and every
    decode step's equal lm_forward's at those positions (scout's on a
    run that drops no assignment) within LM_BF16_TOL, chunked attention
    equals dense on one layer's q, k, v in f32 within ATTN_TOL, the
    loss is finite and falls over the train steps, and every output is
    finite. Returns its report."""
    from repro_torch.configs import get_arch
    from repro_torch.data.batches import make_lm_batch
    from repro_torch.models import layers, transformer as tt

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    report = {"held_gib_at_start": torch.cuda.memory_allocated() / 2**30}

    def tokens(B, S, vocab, s):
        g = torch.Generator(device=dev)
        g.manual_seed(seed * 1000 + s)
        return torch.randint(0, vocab, (B, S), generator=g, device=dev)

    # -- llama3.2-1b, FULL -------------------------------------------------
    cfg = get_arch("llama3.2-1b").make_config(full=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params, t = lm_part(lambda: tt.lm_init(gen, cfg, device=dev))
    rep = {"init": t, "n_params": cfg.n_params}
    B, S = ZOO["prefill"]
    tok = tokens(B, S, cfg.vocab, 1)
    (cache, last), rep["prefill"] = lm_part(
        lambda: tt.lm_prefill(params, tok, cfg))
    del cache

    # for phase Y: back-to-back calls between CUDA events, no profiler
    def prefill(params, tok, cfg=cfg):
        return tt.lm_prefill(params, tok, cfg)

    rep["prefill"]["event_ms"] = time_ms(lambda: prefill(params, tok), 2,
                                         groups=2)
    cost_run(f"llama3.2-1b prefill {B} x {S}", prefill, (params, tok),
             rep["prefill"]["event_ms"], rep["prefill"]["by_category"])
    # prefill's chunked attention against a forward with dense attention
    dense = dataclasses.replace(cfg, dense_attn_threshold=S)
    with torch.no_grad():
        (fwd, _), rep["dense_forward"] = lm_part(
            lambda: tt.lm_forward(params, tok, dense))
    rep["chunked_prefill_vs_dense_forward"] = bf16_close(
        "phase Z llama chunked prefill", last, fwd[:, -1])
    del fwd, last
    # chunked against dense attention on layer 0's q, k, v in f32
    B, S = ZOO["attn_check"]
    with torch.no_grad():
        p0 = {k: v.float() for k, v in tt._layer(params, 0)["attn"].items()}
        f32 = dataclasses.replace(cfg, dtype=torch.float32)
        x = layers.rms_norm(params["embed"][tokens(B, S, cfg.vocab, 2)]
                            .float(), params["layers"]["ln1"][0])
        q, k, v = layers._qkv(p0, x, f32, torch.arange(S, device=dev)[None])
        chunked = layers.chunked_causal_attention(
            q, k, v, chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
        dense = layers.dense_causal_attention(q, k, v)
    if not torch.allclose(chunked, dense, **ATTN_TOL):
        fail(f"phase Z: chunked attention differs from dense by "
             f"{float((chunked - dense).abs().max())}")
    rep["chunked_vs_dense_max_abs"] = float((chunked - dense).abs().max())
    del p0, x, q, k, v, chunked, dense
    # decode at B=16 against a 32,768-token cache
    B, P, n_dec, max_seq = ZOO["decode"]
    tok = tokens(B, P + n_dec, cfg.vocab, 3)
    (cache, last), rep["decode_prefill"] = lm_part(
        lambda: tt.lm_prefill(params, tok[:, :P], cfg))
    full = tt.make_decode_cache(cfg, B, max_seq, device=dev)
    rep["cache_gib"] = 2 * full["k"].numel() * full["k"].element_size() / 2**30
    for n in ("k", "v"):
        full[n][:, :, :P] = cache[n]
    del cache

    def decode():
        outs = []
        for pos in range(P, P + n_dec):
            outs.append(tt.lm_decode_step(params, full, tok[:, pos], pos,
                                          cfg)[0])
        return torch.stack(outs, 1)

    steps, rep["decode"] = lm_part(decode)
    rep["decode"]["ms_a_step"] = rep["decode"]["wall_ms"] / n_dec

    # for phase Y: the first step again (it rewrites the cache at P with
    # the same values), back-to-back between CUDA events, no profiler
    def step(params, cache, token, pos=P, cfg=cfg):
        return tt.lm_decode_step(params, cache, token, pos, cfg)

    rep["decode"]["event_ms_a_step"] = time_ms(
        lambda: step(params, full, tok[:, P]), 5, groups=3)
    cost_run(f"llama3.2-1b decode step {B} x {max_seq}", step,
             (params, full, tok[:, P]), rep["decode"]["event_ms_a_step"],
             {k: v / n_dec for k, v in rep["decode"]["by_category"].items()})
    del full
    with torch.no_grad():
        fwd = tt.lm_forward(params, tok, cfg)[0][:, P - 1:]
    rep["decode_vs_forward"] = bf16_close(
        "phase Z llama decode", torch.cat([last[:, None], steps], 1), fwd)
    del fwd, steps, last
    # 3 train steps on one make_lm_batch, f32 moments
    B, S, n_steps = ZOO["train"]
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 5)
    batch = make_lm_batch(g, batch=B, seq=S, vocab=cfg.vocab, device=dev)
    opt = tt.lm_adam_init(params, cfg)
    losses, rep["train"] = [], []
    for _ in range(n_steps):
        (params, opt, m), t = lm_part(
            lambda: tt.lm_train_step(params, opt, batch, cfg))
        losses.append(float(m["loss"]))
        rep["train"].append(dict(t, loss=losses[-1],
                                 grad_norm=float(m["grad_norm"])))
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"phase Z: llama3.2-1b losses {losses} do not fall")
    del opt, m
    torch.cuda.empty_cache()
    rep["partitioned"] = partitioned_llama(seed, dev, params, cfg, tokens,
                                           smi)
    report["llama3.2-1b"] = rep
    log(f"phase Z llama3.2-1b {json.dumps(rep)} ({smi})")
    del params, batch
    torch.cuda.empty_cache()

    # -- llama4-scout at FULL width, depth cut to 2 layers ------------------
    cfg = dataclasses.replace(
        get_arch("llama4-scout-17b-a16e").make_config(full=True),
        n_layers=ZOO["scout_layers"])
    gen.manual_seed(seed + 1)
    params, t = lm_part(lambda: tt.lm_init(gen, cfg, device=dev))
    rep = {"init": t, "n_params": cfg.n_params,
           "n_layers": f"{cfg.n_layers} of 48 (depth cut)"}
    B, S, n_dec = ZOO["scout"]
    tok = tokens(B, S + n_dec, cfg.vocab, 4)
    stats = {}
    (cache, last), rep["prefill"] = lm_part(
        lambda: tt.lm_prefill(params, tok[:, :S], cfg, stats=stats))
    rep["prefill_dropped_by_layer"] = [int(x) for x in stats["moe_dropped"]]
    rep["capacity"] = layers.moe_capacity(B * S, cfg)
    with torch.no_grad():
        rep["aux"] = float(tt.lm_forward(params, tok[:, :S], cfg)[1])
    full = tt.make_decode_cache(cfg, B, 2 * S, device=dev)
    for n in ("k", "v"):
        full[n][:, :, :S] = cache[n]
    del cache
    stats = {}

    def decode():
        outs = []
        for pos in range(S, S + n_dec):
            outs.append(tt.lm_decode_step(params, full, tok[:, pos], pos,
                                          cfg, stats=stats)[0])
        return torch.stack(outs, 1)

    steps, rep["decode"] = lm_part(decode)
    rep["decode"]["ms_a_step"] = rep["decode"]["wall_ms"] / n_dec
    rep["decode_dropped"] = sum(int(x) for x in stats["moe_dropped"])
    if not bool(torch.isfinite(steps).all()):
        fail("phase Z: llama4-scout decode logits are not finite")
    del full, steps, last
    # decode against forward on the configured path: a prompt and decode
    # short enough (B * (S + n_dec) * top_k <= 8, the least capacity)
    # that neither drops an assignment, so both route every token alike
    B, S, n_dec = ZOO["scout_short"]
    tok = tokens(B, S + n_dec, cfg.vocab, 5)
    stats = {}
    cache, last = tt.lm_prefill(params, tok[:, :S], cfg, stats=stats)
    full = tt.make_decode_cache(cfg, B, S + n_dec, device=dev)
    for n in ("k", "v"):
        full[n][:, :, :S] = cache[n]
    steps = [tt.lm_decode_step(params, full, tok[:, pos], pos, cfg,
                               stats=stats)[0]
             for pos in range(S, S + n_dec)]
    with torch.no_grad():
        fwd = tt.lm_forward(params, tok, cfg, stats=stats)[0][:, S - 1:]
    if any(int(x) for x in stats["moe_dropped"]):
        fail(f"phase Z: llama4-scout dropped assignments on {B} x "
             f"{S + n_dec} tokens: {stats['moe_dropped']}")
    rep["short_decode_vs_forward"] = bf16_close(
        "phase Z scout decode",
        torch.cat([last[:, None], torch.stack(steps, 1)], 1),
        fwd)
    del params, cache, full, fwd, steps, last
    torch.cuda.empty_cache()
    report["llama4-scout-17b-a16e"] = rep
    log(f"phase Z llama4-scout {json.dumps(rep)} ({smi})")
    report["seconds"] = time.perf_counter() - t_phase
    return report


# phase Z's partitioned part: llama3.2-1b's prefill, decode and train
# step through build_lm on a virtual make_smoke_mesh() (2, 4) over the
# card (the batch over 'data', FSDP over 'data', tensor parallelism and
# the cache's sequence over 'model'), at phase Z's shapes, against the
# global programs on the same inputs. Bounds, set before the first run
# from a CPU run of the same layout at d_model 256, 4 layers, S 256 in
# bf16 (loss 9e-6 apart, grad_norm 4e-4, each leaf's gradient 0.022 in
# norm, prefill logits' rel_l2 0.016): the loss within loss_rtol, the
# grad_norm within grad_norm_rtol, each leaf's clipped gradient (Adam's
# first moment after its first step, over 0.1) within leaf_rtol of the
# global step's in norm; the logits within LM_BF16_TOL
PARTITIONED_LM = dict(loss_rtol=2e-3, grad_norm_rtol=2e-2, leaf_rtol=0.1)


def partitioned_llama(seed, dev, params, cfg, tokens, smi):
    """Phase Z's partitioned part (PARTITIONED_LM): build_lm's prefill at
    ZOO["prefill"], 8 decode steps at ZOO["decode"]'s batch against its
    32,768-token cache laid over 'data' x 'model', and one train step at
    ZOO["train"]'s shape from the parameters as the global steps left
    them (the step leaves its inputs as they are) and a fresh Adam
    state, on a virtual (2, 4) mesh over the card, each against the
    global program on the same inputs. Fails unless the logits are
    within LM_BF16_TOL of the global ones, the loss, grad_norm and each
    leaf's clipped gradient within PARTITIONED_LM, and two calls give
    the same bits; an out-of-memory error fails the phase. Logs both
    sides' device ms (CUDA events) and peaks, and how many FSDP leaves
    the step ever gathered whole on one device."""
    from repro_torch.checkpoint.store import flatten_with_paths
    from repro_torch.configs.lm_family import build_lm
    from repro_torch.configs.registry import Cell
    from repro_torch.data.batches import make_lm_batch
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import transformer as tt

    mesh = make_smoke_mesh(device=dev)
    rep = {"mesh": list(mesh.devices.shape)}

    def same(a, b, label):
        fa, fb = flatten_with_paths(a), flatten_with_paths(b)
        for k in fa:
            x, y = fa[k], fb[k]
            if hasattr(x, "blocks"):
                ok = all(torch.equal(x.blocks[i][d], y.blocks[i][d])
                         for i in x.blocks for d in x.blocks[i])
            else:
                ok = torch.equal(x, y)
            if not ok:
                fail(f"phase Z partitioned {label}: two calls differ at {k}")

    # -- prefill -----------------------------------------------------------
    B, S = ZOO["prefill"]
    tok = tokens(B, S, cfg.vocab, 1)
    prog = build_lm(cfg, Cell("prefill_32k", "prefill",
                              {"seq_len": S, "global_batch": B}), mesh)
    (cache, last), t = event_step(lambda: tt.lm_prefill(params, tok, cfg))
    rep["prefill"] = {"global": t}
    del cache
    outs = []
    for _ in range(2):
        out, t = event_step(lambda: prog.fn(params, tok))
        outs.append(out)
        rep["prefill"].setdefault("partitioned", []).append(t)
    rep["prefill"]["vs_global"] = bf16_close(
        "phase Z partitioned prefill", outs[0][1].gather(), last)
    same(outs[0], outs[1], "prefill")
    del outs, out, last
    torch.cuda.empty_cache()

    # -- decode: 8 steps against a 32,768-token cache -----------------------
    B, P, n_dec, max_seq = ZOO["decode"]
    tok = tokens(B, P + n_dec, cfg.vocab, 3)
    cache, _ = tt.lm_prefill(params, tok[:, :P], cfg)

    def fresh():
        full = tt.make_decode_cache(cfg, B, max_seq, device=dev)
        for n in ("k", "v"):
            full[n][:, :, :P] = cache[n]
        return full

    def decode(step, full):
        return [step(full, tok[:, pos], pos) for pos in range(P, P + n_dec)]

    full = fresh()
    want, t = event_step(lambda: decode(
        lambda c, x, p: tt.lm_decode_step(params, c, x, p, cfg)[0], full))
    rep["decode"] = {"global": t}
    del full
    torch.cuda.empty_cache()
    prog = build_lm(cfg, Cell("decode_32k", "decode",
                              {"seq_len": max_seq, "global_batch": B}), mesh)
    full = fresh()
    del cache
    runs = []
    for _ in range(2):
        # the second call rewrites rows P.. with the same values before
        # any step reads them
        got, t = event_step(lambda: decode(
            lambda c, x, p: prog.fn(params, c, x, p)[0], full))
        runs.append([g.gather() for g in got])
        rep["decode"].setdefault("partitioned", []).append(t)
    rep["decode"]["vs_global"] = [
        bf16_close(f"phase Z partitioned decode step {j}", g, w)
        for j, (g, w) in enumerate(zip(runs[0], want))]
    for j, (a, b) in enumerate(zip(*runs)):
        if not torch.equal(a, b):
            fail(f"phase Z partitioned decode step {j}: two calls differ")
    del full, runs, got, want
    torch.cuda.empty_cache()

    # -- one train step from a fresh Adam state ------------------------------
    B, S, _ = ZOO["train"]
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 5)
    batch = make_lm_batch(g, batch=B, seq=S, vocab=cfg.vocab, device=dev)
    opt = tt.lm_adam_init(params, cfg)
    ref, t = event_step(lambda: tt.lm_train_step(params, opt, batch, cfg))
    rep["train"] = {"global": t}
    ref_mu = ref[1].mu
    ref_m = {k: float(ref[2][k]) for k in ("loss", "grad_norm")}
    del ref
    torch.cuda.empty_cache()
    prog = build_lm(cfg, Cell("train_4k", "train",
                              {"seq_len": S, "global_batch": B}), mesh)
    # FSDP leaves a device ever held whole during the step: an FSDP
    # gather's output of a leaf's whole (layer) shape, or one gathered
    # over 'model' after it
    shapes = {k: tuple(v.shape) for k, v in flatten_with_paths(
        tt.lm_init(None, cfg, device="meta")).items()}
    whole, made = set(), {}
    fsdp, gather_model = tt._fsdp, tt._gather_model

    def noting_fsdp(plan, xs, path):
        out = fsdp(plan, xs, path)
        if "data" in {a for e in plan.specs[path] if e
                      for a in ((e,) if isinstance(e, str) else e)}:
            made[id(out[0])] = path
            if tuple(out[0].shape) in (shapes[path], shapes[path][1:]):
                whole.add(path)
        return out

    def noting_model(plan, xs, dim):
        if id(xs[0]) in made:
            whole.add(made[id(xs[0])])
        return gather_model(plan, xs, dim)
    tt._fsdp, tt._gather_model = noting_fsdp, noting_model
    try:
        out1, t = event_step(lambda: prog.fn(params, opt, batch))
        rep["train"]["partitioned"] = [t]
        worst = 0.0
        for k, mu in ref_mu.items():
            got_mu = out1[1].mu[k].gather()
            rel = float(torch.linalg.vector_norm(got_mu.float() - mu.float())
                        / torch.linalg.vector_norm(mu.float()).clamp_min(
                            1e-30))
            worst = max(worst, rel)
            if not rel <= PARTITIONED_LM["leaf_rtol"]:
                fail(f"phase Z partitioned: leaf {k}'s gradient {rel} from "
                     f"the global step's in norm")
            del got_mu
        rep["train"]["leaf_grad_rel"] = worst
        del ref_mu
        for k, bound in (("loss", "loss_rtol"),
                         ("grad_norm", "grad_norm_rtol")):
            a = float(out1[2][k])
            rep["train"][k] = {"partitioned": a, "global": ref_m[k]}
            if not math.isfinite(a) or abs(a - ref_m[k]) > \
                    PARTITIONED_LM[bound] * abs(ref_m[k]):
                fail(f"phase Z partitioned: {k} {a!r} against the global "
                     f"step's {ref_m[k]!r}")
        torch.cuda.empty_cache()
        out2, t = event_step(lambda: prog.fn(params, opt, batch))
        rep["train"]["partitioned"].append(t)
        same(out1, out2, "train step")
    finally:
        tt._fsdp, tt._gather_model = fsdp, gather_model
    rep["train"]["fsdp_leaves_gathered_whole"] = len(whole)
    if whole:
        fail(f"phase Z partitioned: FSDP leaves gathered whole: {whole}")
    del out1, out2, opt, batch
    torch.cuda.empty_cache()
    log(f"phase Z partitioned llama3.2-1b {json.dumps(rep)} ({smi})")
    return rep


# phase G: MeshGraphNet's FULL config (15 layers, d_hidden 128) on the
# four cells of src/repro/configs/gnn_family.py at their cell_config
# widths: minibatch_lg samples its block from a CSR graph of Reddit's
# 232,965 nodes at avg_degree 492 (~114.6M edges); ogb_products is cut
# to 1/16 of its nodes and edges (one layer's edge latents alone would
# be 31.7 GB at full size, and remat keeps 15); the ranking head ranks
# the 1024 seeds' node_scores as one request
GNN = dict(steps=3, products_cut=16, reddit_degree=492, head_K=8,
           head_m2=64)
# phase G's partitioned step: ogb_products at the same cut through
# build_gnn on a virtual make_smoke_mesh() (2 'data' blocks), against
# the global step on the same padded graph; leaf_rtol bounds each
# leaf's clipped gradient's distance from the global step's, in norm
PARTITIONED = dict(calls=2, lr=1e-3, sure_grad=3e-6, leaf_rtol=2e-3)
# phase T: launch.train's body, a failure injected at step 25 of 40
TRAIN = dict(steps=40, ckpt_every=10, fail_at=25,
             runs=(("meshgraphnet", False), ("llama3.2-1b", True),
                   ("sasrec", True)))


def gnn_cell_graph(cell, gen, dev):
    """The cell's training graph on the card (and, for minibatch_lg,
    the sample and its seed count): a make_random_graph, a batch of
    molecules, or a block sampled from the Reddit-sized CSR graph with
    node_mask on the seeds."""
    from repro_torch.configs.gnn_family import D_EDGE
    from repro_torch.data.batches import (
        make_csr_graph,
        make_molecule_batch,
        make_random_graph,
    )
    from repro_torch.models.gnn import (
        block_graph_from_sample,
        neighbor_sample,
    )

    widths = dict(d_node=cell["d_feat"], d_edge=D_EDGE, d_out=cell["d_out"],
                  device=dev)
    info = {}
    if cell.kind == "train_batched":
        g = make_molecule_batch(gen, batch=cell["batch"],
                                n_nodes=cell["n_nodes"],
                                n_edges=cell["n_edges"], **widths)
    elif cell.kind == "train_sampled":
        t0 = time.perf_counter()
        N = cell["n_graph_nodes"]
        indptr, indices = make_csr_graph(gen, n_nodes=N,
                                         avg_degree=GNN["reddit_degree"],
                                         device=dev)
        info["csr_edges"] = int(indices.shape[0])
        info["csr_s"] = time.perf_counter() - t0
        seeds = torch.randperm(N, generator=gen, device=dev)[
            :cell["batch_nodes"]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample = neighbor_sample(gen, indptr, indices, seeds,
                                 fanouts=tuple(cell["fanouts"]))
        torch.cuda.synchronize()
        info["sample_ms"] = (time.perf_counter() - t0) * 1e3
        del indptr, indices
        table = torch.randn((N, cell["d_feat"]), generator=gen, device=dev)
        feats = table[sample["node_ids"].long()]
        del table
        g = block_graph_from_sample(sample, feats, D_EDGE)
        T = feats.shape[0]
        g["targets"] = torch.tanh(feats[:, :cell["d_out"]])
        mask = torch.zeros((T,), device=dev)
        mask[:sample["n_seeds"]] = 1.0
        g["node_mask"] = mask
        info["n_seeds"] = sample["n_seeds"]
    else:
        n, e = cell["n_nodes"], cell["n_edges"]
        if cell.name == "ogb_products":
            n = -(-n // GNN["products_cut"])
            e = -(-e // GNN["products_cut"])
            info["cut"] = (f"nodes and edges / {GNN['products_cut']}: "
                           f"{n} of {cell['n_nodes']}, {e} of "
                           f"{cell['n_edges']}")
        g = make_random_graph(gen, n_nodes=n, n_edges=e, **widths)
    nodes = g["nodes"]
    info["nodes"] = int(nodes.shape[0] * (nodes.shape[1]
                                          if nodes.dim() == 3 else 1))
    info["edges"] = int(g["senders"].numel())
    return g, info


def event_step(fn):
    """fn() once between CUDA events: (its output, {event_ms, peak_gib
    (the card's allocated peak during the call), alloc_retries (the
    caching allocator's frees of its cache to retry an allocation
    during the call, each a synchronisation)})."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, {"event_ms": start.elapsed_time(end),
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "alloc_retries": torch.cuda.memory_stats().get(
                     "num_alloc_retries", 0) - retries}


def partitioned_products(cell, cfg, params, graph, dev, smi):
    """Phase G's partitioned step: ogb_products at phase G's cut through
    build_gnn on a virtual make_smoke_mesh() over the card (2 'data'
    blocks on (2, 4)), from a copy of the parameters, a fresh Adam state
    and the graph padded by pad_graph, against gnn_train_step's global
    step from the same. Fails unless the loss and grad_norm are within
    rtol 1e-5 of the global step's; each leaf's clipped gradient (Adam's
    first moment after its first step, over 0.1) is within
    PARTITIONED["leaf_rtol"] of the global step's in norm, which holds
    the partition's per-leaf gradient magnitudes; the new parameters
    are within rtol 1e-5, atol lr x 1e-3 where the gradient is above
    3e-6 and within 2 x lr everywhere (from a fresh state Adam's first
    step moves a weight by about lr x sign(g), so this is a check of
    the gradients' signs); and two calls give the same bits. The Adam
    state is fresh because the parameters' tolerance is Adam's first
    step's (tests/test_torch_gnn_sharded.py). An out-of-memory error
    fails the phase. Logs each step's device ms (CUDA events) and
    peak, and the moments' largest distances."""
    from repro_torch.checkpoint.store import flatten_with_paths
    from repro_torch.configs.gnn_family import build_gnn, pad_graph
    from repro_torch.configs.registry import Cell
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import gnn

    mesh = make_smoke_mesh(device=dev)
    lr, cut = PARTITIONED["lr"], GNN["products_cut"]
    n = -(-cell["n_nodes"] // cut)
    e = -(-cell["n_edges"] // cut)
    cut_cell = Cell(cell.name, cell.kind, dict(cell.params, n_nodes=n,
                                               n_edges=e))
    # cfg is the cell's config already: build_gnn's cell_config of it is
    # itself
    prog = build_gnn(cfg, cut_cell, mesh)
    want = prog.args[2]
    padded = pad_graph({k: v for k, v in graph.items() if k in want},
                       want["nodes"].shape[0], want["edges"].shape[0])
    padded = {k: v.to(want[k].dtype) for k, v in padded.items()}
    p0 = tree_map(lambda t: t.detach().clone(), params)
    o0 = gnn.gnn_adam_init(p0)
    rep = {"cut": cut, "nodes": n, "edges": e,
           "padded": [want["nodes"].shape[0], want["edges"].shape[0]],
           "blocks": 2, "mesh": list(mesh.devices.shape)}
    ref, rep["global"] = event_step(
        lambda: gnn.gnn_train_step(p0, o0, padded, cfg, lr=lr))
    outs = []
    for _ in range(PARTITIONED["calls"]):
        out, t = event_step(lambda: prog.fn(p0, o0, padded))
        outs.append(out)
        rep.setdefault("partitioned", []).append(t)
    got = outs[0]
    for name in ("loss", "grad_norm"):
        a, b = float(got[2][name]), float(ref[2][name])
        rep[name] = {"partitioned": a, "global": b}
        if not math.isfinite(a) or abs(a - b) > 1e-5 * abs(b):
            fail(f"phase G partitioned: {name} {a!r} against the global "
                 f"step's {b!r}")
    gp, rp = flatten_with_paths(got[0]), flatten_with_paths(ref[0])
    worst = {"params": 0.0, "mu": 0.0, "nu": 0.0, "leaf_grad_rel": 0.0}
    for k, r in rp.items():
        # the clipped gradient, Adam's first moment after its first step
        g, g_got = ref[1].mu[k] / 0.1, got[1].mu[k] / 0.1
        rel = float(torch.linalg.vector_norm(g_got - g)
                    / torch.linalg.vector_norm(g).clamp_min(1e-30))
        worst["leaf_grad_rel"] = max(worst["leaf_grad_rel"], rel)
        if not rel <= PARTITIONED["leaf_rtol"]:
            fail(f"phase G partitioned: leaf {k}'s gradient {rel} from the "
                 f"global step's in norm")
        sure = g.abs() > PARTITIONED["sure_grad"]
        diff = (gp[k] - r).abs()
        within = diff <= lr * 1e-3 + 1e-5 * r.abs()
        worst["params"] = max(worst["params"], float(diff.max()))
        if not bool(within[sure].all()) or float(diff.max()) > 2 * lr:
            fail(f"phase G partitioned: parameter {k} "
                 f"{float(diff[sure].max()) if sure.any() else 0.0} "
                 f"(where the gradient is above "
                 f"{PARTITIONED['sure_grad']}) / {float(diff.max())} from "
                 f"the global step's")
        for m in ("mu", "nu"):
            worst[m] = max(worst[m], float((getattr(got[1], m)[k]
                                            - getattr(ref[1], m)[k])
                                           .abs().max()))
    rep["max_abs_diff"] = worst
    for a, b in zip(outs[0], outs[1]):
        fa, fb = flatten_with_paths(a), flatten_with_paths(b)
        if not all(torch.equal(fa[k], fb[k]) for k in fa):
            fail("phase G partitioned: two calls differ")
    rep["bitwise_run_to_run"] = True
    log(f"phase G partitioned ogb_products/{cut} {json.dumps(rep)} ({smi})")
    del ref, outs, got, p0, o0, padded
    torch.cuda.empty_cache()
    return rep


def train_gnn_cells(seed, dev, wrappers, smi):
    """Phase G: 3 gnn_train_steps of MeshGraphNet FULL on each cell
    (GNN): each step's wall and device ms (torch.profiler) and peak
    memory, then a fourth step's wall and CUDA-event ms without the
    profiler, every loss
    finite; aggregate on the cell's encoded edges
    bitwise equal across two calls on the card (at full_graph_sm also
    its distance from the CPU's); at full_graph_sm the loss and every
    gradient with remat on bitwise those with remat off; then the
    ranking head: the minibatch_lg seeds' node_scores as one request's
    u (m1 = 1024, K = 8, m2 = 64) through ops.rank_audited, one
    rank_audited launch counted, its outputs bitwise the plain
    version's. Returns (launches, report)."""
    from repro_torch.checkpoint.store import flatten_with_paths
    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_family import GNN_CELLS, cell_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import gnn

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    full = get_arch("meshgraphnet").make_config(full=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 7)
    report = {"held_gib_at_start": torch.cuda.memory_allocated() / 2**30}
    head_u = None
    for cell in GNN_CELLS:
        cfg = cell_config(full, cell)
        graph, rep = gnn_cell_graph(cell, gen, dev)
        params = gnn.gnn_init(gen, cfg, device=dev)
        opt = gnn.gnn_adam_init(params)
        rep["n_params"] = cfg.n_params
        rep["steps"] = []
        for _ in range(GNN["steps"]):
            (params, opt, m), t = lm_part(
                lambda: gnn.gnn_train_step(params, opt, graph, cfg))
            rep["steps"].append(dict(t, loss=float(m["loss"]),
                                     grad_norm=float(m["grad_norm"])))
        # one more step without the profiler, whose per-op cost would
        # inflate a host-bound step's wall time and its device time
        # between CUDA events (phase Y's)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        params, opt, m = gnn.gnn_train_step(params, opt, graph, cfg)
        end.record()
        loss = float(m["loss"])
        end.synchronize()
        rep["unprofiled_step"] = {
            "wall_ms": (time.perf_counter() - t0) * 1e3,
            "event_ms": start.elapsed_time(end), "loss": loss}
        if cell.name == "ogb_products":
            cost_run(f"meshgraphnet ogb_products/{GNN['products_cut']} "
                     f"train step",
                     lambda p, o, g, cfg=cfg: gnn.gnn_train_step(p, o, g,
                                                                 cfg),
                     (params, opt, graph),
                     rep["unprofiled_step"]["event_ms"],
                     rep["steps"][-1]["by_category"])
            rep["partitioned"] = partitioned_products(
                cell, cfg, params, graph, dev, smi)
        losses = [r["loss"] for r in rep["steps"]] + [loss]
        if not all(math.isfinite(x) for x in losses):
            fail(f"phase G {cell.name}: losses {losses} are not finite")
        # aggregate over the cell's encoded edges, twice
        flat = gnn.flatten_batch(graph) if cell.kind == "train_batched" \
            else graph
        with torch.no_grad():
            e = gnn._mlp_apply(params["edge_encoder"], flat["edges"], cfg)
            n_nodes = flat["nodes"].shape[0]
            recv = flat["receivers"].long()
            a1 = gnn.aggregate(e, recv, n_nodes, "sum")
            a2 = gnn.aggregate(e, recv, n_nodes, "sum")
        if not torch.equal(a1, a2):
            fail(f"phase G {cell.name}: aggregate differs between two "
                 f"calls on the card")
        rep["aggregate_bitwise_run_to_run"] = True
        if cell.name == "full_graph_sm":
            want = gnn.aggregate(e.cpu(), recv.cpu(), n_nodes, "sum")
            diff = (a1.cpu() - want).abs()
            rep["aggregate_vs_cpu"] = {
                "max_abs": float(diff.max()),
                "max_rel": float((diff / want.abs().clamp_min(1e-30))
                                 .max()),
                "bitwise": bool(torch.equal(a1.cpu(), want))}
            outs = {}
            for remat in (True, False):
                c = dataclasses.replace(cfg, remat=remat)
                loss, _, grads = gnn.gnn_grads(params, graph, c)
                outs[remat] = (loss, flatten_with_paths(grads))
            same = torch.equal(outs[True][0], outs[False][0]) and all(
                torch.equal(v, outs[False][1][k])
                for k, v in outs[True][1].items())
            if not same:
                fail("phase G full_graph_sm: remat on differs from remat "
                     "off")
            rep["remat_on_equals_off_bitwise"] = True
        if cell.kind == "train_sampled":
            with torch.no_grad():
                head_u = gnn.gnn_forward(params, graph, cfg)[
                    :rep["n_seeds"], 0][None].contiguous()
        del graph, params, opt, flat, e, a1, a2
        torch.cuda.empty_cache()
        report[cell.name] = rep
        log(f"phase G {cell.name} {json.dumps(rep)} ({smi})")

    # the ranking head on the sampled seeds' node scores
    m1, K, m2 = head_u.shape[1], GNN["head_K"], GNN["head_m2"]
    _, a, b, lam, g = rank_inputs(gen, dev, 1, m1, K, m2)
    reset_counters(wrappers)
    out = ops.rank_audited(head_u, a, b, lam, g, m2=m2, device=dev)
    torch.cuda.synchronize()
    launches = read_counters(wrappers)
    want = ref.rank_audited_ref(head_u, a, b, lam, g, m2)
    if launches != {n: int(n == "rank_audited") for n in wrappers}:
        fail(f"phase G ranking head: launch counters {launches}")
    if not bitwise((out.perm, out.utility, out.exposure, out.compliant),
                   want[1:]):
        fail("phase G ranking head: rank_audited differs from its plain "
             "version")
    report["ranking_head"] = {"m1": m1, "K": K, "m2": m2,
                              "launches": launches["rank_audited"],
                              "bitwise_plain": True,
                              "compliant": bool(out.compliant[0])}
    report["seconds"] = time.perf_counter() - t_phase
    log(f"phase G ranking head {json.dumps(report['ranking_head'])}")
    return launches, report


PHASE_T_CKPT = Path(__file__).resolve().parent / "build" / "phase_t_ckpt"


def train_with_failures(dev, smi):
    """Phase T: launch.train's body (build_training, the runner, the
    report) in process on the card for each of TRAIN's runs: 40 steps
    with a checkpoint every 10, once uninterrupted and once with a
    failure injected at step 25. Fails unless the second run restarted
    once and its final parameters and Adam state are bitwise the first
    run's. Checkpoints go under build/phase_t_ckpt (PHASE_T_CKPT); the
    caller removes them after phase P has restored one onto a mesh.
    Returns its report."""
    import shutil

    from repro_torch.checkpoint.store import flatten_with_paths
    from repro_torch.launch import train as launch

    t_phase = time.perf_counter()
    root = PHASE_T_CKPT
    shutil.rmtree(root, ignore_errors=True)
    report = {}
    for arch, smoke in TRAIN["runs"]:
        states, rep = {}, {"config": "SMOKE" if smoke else "FULL"}
        for label, extra in (("uninterrupted", []),
                             ("failure", ["--fail-at",
                                          str(TRAIN["fail_at"])])):
            args = launch.build_parser().parse_args(
                ["--arch", arch, "--steps", str(TRAIN["steps"]),
                 "--ckpt-every", str(TRAIN["ckpt_every"]),
                 "--ckpt-dir", str(root / label), "--device", str(dev)]
                + (["--smoke"] if smoke else []) + extra)
            torch.cuda.synchronize()
            state, runner_rep, out = launch.run(args)
            torch.cuda.synchronize()
            states[label] = flatten_with_paths(state)
            out["step_ms_median"] = float(np.median(
                runner_rep.step_times)) * 1e3
            rep[label] = out
        if rep["failure"]["restarts"] != 1 or \
                rep["uninterrupted"]["restarts"] != 0:
            fail(f"phase T {arch}: restarts {rep['failure']['restarts']}"
                 f" and {rep['uninterrupted']['restarts']}")
        a, b = states["failure"], states["uninterrupted"]
        differ = [k for k in b if not torch.equal(a[k], b[k])]
        if list(a) != list(b) or differ:
            fail(f"phase T {arch}: the replayed run's state differs "
                 f"from the uninterrupted run's in {differ[:5]}")
        rep["replay_bitwise"] = True
        rep["leaves"] = len(b)
        if not all(math.isfinite(rep[r]["last_loss"]) for r in
                   ("failure", "uninterrupted")):
            fail(f"phase T {arch}: the loss is not finite")
        report[arch] = rep
        log(f"phase T {arch} {json.dumps(rep)} ({smi})")
    report["seconds"] = time.perf_counter() - t_phase
    return report


# phase P: the zoo's cell programs (configs/*_family.py build_*) over a
# virtual make_smoke_mesh() ((2, 4) ('data', 'model')) on the card.
# retrieval_cand runs uncut at FULL (1,000,448 candidates, the 65,536-row
# KNN database, m2 = 50); llama4-scout's "opt" variant (moe_dispatch
# 'shmap') at FULL width with its depth cut to 2 of 48 layers, as phase
# Z cuts it: held against the global dispatch at 2 x 4 tokens (top-1 of
# 8 tokens fits the least capacity, 8: nothing drops in either path),
# and timed at 2 x 2048 with both paths' drops logged; the compressed
# psum over 'data' on llama3.2-1b's FULL parameter shapes, two shards of
# f32 draws, and on each leaf's first PSUM_SLICE rows against the CPU
PROGRAMS = dict(scout_layers=2, scout_check=(2, 4), scout_timed=(2, 2048),
                psum_slice=64, reps=3)


def plain_retrieval_wrappers():
    """The three kernels on retrieval_cand's path as their plain
    versions, in the wrappers' signatures (for ops' module attributes)."""
    from repro_torch.kernels import ref

    return {
        "knn_lambda_cuda": lambda xq, xdb, lam_db, *, k=10, device=None:
            ref.knn_lambda_ref(xq, xdb, lam_db, k),
        "fused_rank_cuda": lambda u, a, lam, *, m2, eps=1e-4, device=None:
            ref.fused_rank_ref(u, a, lam, m2, eps),
        "embedding_bag_cuda": lambda table, indices, weights=None, *,
        device=None: ref.embedding_bag_ref(table, indices, weights),
    }


def run_plain(fn, *args):
    """fn(*args) with ops' three retrieval wrappers swapped for their
    plain versions on the card (no counter moves), restored after."""
    from repro_torch.kernels import ops

    saved = {name: getattr(ops, name) for name in plain_retrieval_wrappers()}
    try:
        for name, plain in plain_retrieval_wrappers().items():
            setattr(ops, name, plain)
        return fn(*args)
    finally:
        for name, w in saved.items():
            setattr(ops, name, w)


def program_specs(prog):
    """{arg|path: (shape, dtype, spec entries, the sharding's mesh)}."""
    from repro_torch.checkpoint.store import flatten_with_paths
    from repro_torch.launch.mesh import spec_entries

    out = {}
    for i, arg in enumerate(prog.args):
        for path, a in flatten_with_paths(arg).items():
            sh = a.sharding
            out[f"{i}|{path}"] = (a.shape, a.dtype, None if sh is None else
                                  spec_entries(sh.spec, len(sh.spec)),
                                  None if sh is None else sh.mesh)
    return out


def retrieval_inputs(cfg, prog, gen, dev):
    """retrieval_cand's arguments after the parameters, drawn on the
    card: the user's fields or sequence, candidate ids (DeepFM's from
    field 0), a 0/1 constraint matrix, the KNN database and its
    nonnegative lambda rows."""
    (B, width), n = prog.args[1].shape, prog.args[2].shape[0]
    K, (n_db, d) = prog.args[3].shape[0], prog.args[4].shape
    i32 = torch.int32
    if cfg.kind == "deepfm":
        fv = cfg.field_vocab
        user = (torch.randint(0, fv, (B, width), generator=gen, device=dev)
                + torch.arange(1, cfg.n_sparse, device=dev) * fv).to(i32)
        cand = torch.randint(0, fv, (n,), generator=gen, device=dev)
    else:
        user = torch.randint(0, cfg.n_items, (B, width), generator=gen,
                             device=dev).to(i32)
        cand = torch.randint(0, cfg.n_items, (n,), generator=gen, device=dev)
    a = (torch.rand((K, n), generator=gen, device=dev) < 0.15).float()
    X_db = torch.randn((n_db, d), generator=gen, device=dev) * 0.05
    lam_db = torch.randn((n_db, K), generator=gen, device=dev).abs()
    return user, cand.to(i32), a, X_db, lam_db


def serve_cell_programs(seed, dev, wrappers, ckpt_root, smi):
    """Phase P: the zoo's cell programs over a virtual (2, 4) mesh on the
    card (PROGRAMS). (a) every arch x cell at FULL built on the card's
    mesh, its arguments' shapes, dtypes and specs those of the same
    build on a CPU mesh (which tests/test_torch_cell_programs.py holds
    against JAX's Lowerable.args), every sharding on the card's mesh;
    (b) retrieval_cand uncut for the four recsys archs at FULL: the
    program through the kernels (launches counted) against the same
    program with the plain versions on the card, perm exactly and
    lambda-hat and the adjusted scores bitwise; (c) serve_p99 for the
    four recsys archs and full_graph_sm and molecule through build_gnn
    at FULL, every output finite; (d) llama4-scout's "opt" variant under
    use_mesh_rules(mesh, LM_RULES) through moe_apply_shmap against the
    global dispatch within LM_BF16_TOL where neither drops, and timed;
    (e) compressed_psum and psum_with_error_feedback over 'data' on
    llama3.2-1b's FULL parameter shapes, each shard's result equal, the
    int8 bound held, each leaf's first rows bitwise the CPU's; (f) phase
    T's llama3.2-1b checkpoint restored onto the mesh with
    param_shardings, every block bitwise the saved leaf's slice.
    Returns (launches, report)."""
    from dataclasses import replace

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.checkpoint.store import flatten_with_paths
    from repro_torch.configs import all_archs, get_arch
    from repro_torch.configs.gnn_family import cell_config, pad_graph
    from repro_torch.configs.registry import pad_up
    from repro_torch.distributed.sharding import (
        LM_RULES,
        param_shardings,
        use_mesh_rules,
    )
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import (
        Sharded,
        block_of,
        make_smoke_mesh,
        spec_entries,
    )
    from repro_torch.models import gnn
    from repro_torch.models import transformer as tt
    from repro_torch.models.recsys import RECSYS_REGISTRY
    from repro_torch.optim import compression

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    mesh = make_smoke_mesh(device=dev)
    cpu_mesh = make_smoke_mesh(device="cpu")
    report = {"mesh": "(2, 4) ('data', 'model'), virtual on the card"}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 11)

    # (a) every arch x cell at FULL ----------------------------------------
    t0, n_leaves, n_cells = time.perf_counter(), 0, 0
    for arch in all_archs():
        spec = get_arch(arch)
        cfg = spec.make_config(True)
        for cell in spec.cells:
            got = program_specs(spec.build(cfg, cell, mesh))
            want = program_specs(spec.build(cfg, cell, cpu_mesh))
            if sorted(got) != sorted(want) or any(
                    got[k][:3] != want[k][:3] for k in want):
                fail(f"phase P {arch} {cell.name}: the card mesh's build "
                     f"differs from the CPU mesh's")
            if any(v[3] is not mesh for v in got.values()
                   if v[2] is not None):
                fail(f"phase P {arch} {cell.name}: a sharding off the mesh")
            n_leaves += len(got)
            n_cells += 1
    report["full_builds"] = {"cells": n_cells, "arg_leaves": n_leaves,
                             "s": time.perf_counter() - t0}

    # (b) retrieval_cand uncut, and (c) serve_p99, for the recsys archs ----
    launches = {name: 0 for name in wrappers}
    report["retrieval_cand"], report["serve_p99"] = {}, {}
    for arch in ("deepfm", "sasrec", "bert4rec", "mind"):
        spec = get_arch(arch)
        cfg = spec.make_config(True)
        t0 = time.perf_counter()
        model = RECSYS_REGISTRY[cfg.kind](cfg, gen=gen, device=dev)
        params = model.params()
        torch.cuda.synchronize()
        rep = {"init_s": time.perf_counter() - t0,
               "n_params": sum(p.numel() for p in model.parameters())}
        prog = spec.build(cfg, spec.cell("retrieval_cand"), mesh)
        args = (params,) + retrieval_inputs(cfg, prog, gen, dev)
        for a, s in zip(args[1:], prog.args[1:]):
            if tuple(a.shape) != s.shape or a.dtype != s.dtype:
                fail(f"phase P {arch}: an argument is {tuple(a.shape)} "
                     f"{a.dtype}, the program's {s.shape} {s.dtype}")
        torch.cuda.synchronize()
        reset_counters(wrappers)
        vals, idx, lam = prog.fn(*args)
        torch.cuda.synchronize()
        got = read_counters(wrappers)
        for name, n in got.items():
            launches[name] += n
        want_l = {"knn_lambda": 2, "fused_rank": 1,
                  "embedding_bag": 1 if cfg.kind == "deepfm" else 0}
        if any(got[n] != want_l.get(n, 0) for n in got):
            fail(f"phase P {arch}: launches {got}, expected {want_l}")
        pv, pidx, plam = run_plain(prog.fn, *args)
        same = {"perm": torch.equal(idx, pidx),
                "scores": torch.equal(vals, pv),
                "lambda-hat": torch.equal(lam, plam)}
        if not all(same.values()):
            fail(f"phase P {arch}: retrieval_cand through the kernels "
                 f"against its plain version, equal: {same}")
        if not bool(torch.isfinite(vals).all()) or vals.shape != (1, 50):
            fail(f"phase P {arch}: retrieval values {tuple(vals.shape)} "
                 f"not finite")
        rep.update(
            n_candidates=prog.args[2].shape[0], n_db=prog.args[4].shape[0],
            d_cov=prog.args[4].shape[1], launches=got, bitwise_plain=True,
            ms=time_ms(lambda: prog.fn(*args), PROGRAMS["reps"]),
            plain_ms=time_ms(lambda: run_plain(prog.fn, *args),
                             PROGRAMS["reps"]))
        report["retrieval_cand"][arch] = rep
        log(f"phase P retrieval_cand {arch} {json.dumps(rep)} ({smi})")
        cost_run(f"{arch} retrieval_cand", prog.fn, args, rep["ms"],
                 categories_of(lambda: prog.fn(*args)))     # for phase Y
        # serve_p99 on the same parameters
        prog = spec.build(cfg, spec.cell("serve_p99"), mesh)
        B = prog.args[1].shape[0]
        if cfg.kind == "deepfm":
            ids = (torch.randint(0, cfg.field_vocab, prog.args[1].shape,
                                 generator=gen, device=dev)
                   + torch.arange(cfg.n_sparse, device=dev)
                   * cfg.field_vocab).to(torch.int32)
            sargs = (params, ids)
        else:
            sargs = (params,) + tuple(
                torch.randint(0, cfg.n_items, a.shape, generator=gen,
                              device=dev).to(torch.int32)
                for a in prog.args[1:])
        scores = prog.fn(*sargs)
        if scores.shape != (B,) or not bool(torch.isfinite(scores).all()):
            fail(f"phase P {arch} serve_p99: scores {tuple(scores.shape)} "
                 f"not finite")
        report["serve_p99"][arch] = {
            "batch": B, "ms": time_ms(lambda: prog.fn(*sargs),
                                      PROGRAMS["reps"])}
        del model, params, args, sargs, prog, vals, idx, lam, pv, plam
        torch.cuda.empty_cache()
    log(f"phase P serve_p99 {json.dumps(report['serve_p99'])} ({smi})")

    # (c) the GNN's full_graph_sm and molecule through build_gnn ----------
    spec = get_arch("meshgraphnet")
    full = spec.make_config(True)
    report["gnn"] = {}
    for name in ("full_graph_sm", "molecule"):
        cell = spec.cell(name)
        prog = spec.build(full, cell, mesh)
        graph, info = gnn_cell_graph(cell, gen, dev)
        want = {k: a for k, a in prog.args[2].items()}
        n_pad, e_pad = want["nodes"].shape[-2], want["edges"].shape[-2]
        graph = pad_graph({k: v for k, v in graph.items() if k in want},
                          n_pad, e_pad)
        graph = {k: v.to(want[k].dtype) for k, v in graph.items()}
        for k, a in want.items():
            if tuple(graph[k].shape) != a.shape:
                fail(f"phase P {name}: graph {k} {tuple(graph[k].shape)} "
                     f"!= {a.shape}")
        params = gnn.gnn_init(gen, cell_config(full, cell), device=dev)
        opt = gnn.gnn_adam_init(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, opt, m = prog.fn(params, opt, graph)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        leaves = flatten_with_paths(new)
        if not math.isfinite(float(m["loss"])) or not all(
                bool(torch.isfinite(v).all()) for v in leaves.values()):
            fail(f"phase P {name}: the padded train step is not finite")
        report["gnn"][name] = dict(info, padded=(n_pad, e_pad),
                                   loss=float(m["loss"]), step_ms=step_ms)
        del params, opt, new, graph
        torch.cuda.empty_cache()
    log(f"phase P gnn {json.dumps(report['gnn'])} ({smi})")

    # (d) llama4-scout's "opt" variant through moe_apply_shmap -------------
    cfg = replace(get_arch("llama4-scout-17b-a16e").variants["opt"](),
                  n_layers=PROGRAMS["scout_layers"])
    params = tt.lm_init(gen, cfg, device=dev)
    calls = []
    orig = tt.moe_apply_shmap_with_drops

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    def forward(tok, on_mesh, stats):
        with torch.no_grad():
            if not on_mesh:
                return tt.lm_forward(params, tok, cfg, stats=stats)
            with use_mesh_rules(mesh, LM_RULES):
                return tt.lm_forward(params, tok, cfg, stats=stats)

    rep = {"n_layers": f"{cfg.n_layers} of 48 (depth cut)",
           "moe_dispatch": cfg.moe_dispatch}
    tt.moe_apply_shmap_with_drops = counting
    try:
        for label, (B, S) in (("check", PROGRAMS["scout_check"]),
                              ("timed", PROGRAMS["scout_timed"])):
            tok = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                device=dev)
            out, drops = {}, {}
            for path, on_mesh in (("shmap", True), ("global", False)):
                stats = {}
                before = len(calls)
                (logits, aux), t = lm_part(lambda: forward(tok, on_mesh,
                                                           stats))
                if (len(calls) - before) != (cfg.n_layers if on_mesh else 0):
                    fail(f"phase P scout {path}: moe_apply_shmap ran "
                         f"{len(calls) - before} times")
                out[path] = logits
                drops[path] = [int(x) for x in stats["moe_dropped"]]
                rep[f"{label}_{path}"] = dict(t, aux=float(aux),
                                              dropped=drops[path])
            if label == "check":
                if any(drops["shmap"]) or any(drops["global"]):
                    fail(f"phase P scout: assignments dropped at {B} x {S}: "
                         f"{drops}")
                rep["shmap_vs_global"] = bf16_close(
                    "phase P scout shmap", out["shmap"], out["global"])
            del out
    finally:
        tt.moe_apply_shmap_with_drops = orig
    report["llama4-scout-opt"] = rep
    log(f"phase P llama4-scout opt {json.dumps(rep)} ({smi})")
    del params
    torch.cuda.empty_cache()

    # (e) the int8 compressed psum over 'data' -------------------------------
    cfg = get_arch("llama3.2-1b").make_config(True)
    shapes = flatten_with_paths(tt.lm_init(None, cfg, device="meta"))
    t0 = time.perf_counter()
    worst, n_el, rows = 0.0, 0, PROGRAMS["psum_slice"]
    for path, like in shapes.items():
        xs = [torch.randn(like.shape, generator=gen, device=dev) * s
              for s in (1.0, 0.5)]
        rs = [torch.randn(like.shape, generator=gen, device=dev) * 1e-3
              for _ in xs]
        got = compression.compressed_psum(xs, "data", mesh)
        if not torch.equal(got[0], got[1]):
            fail(f"phase P psum {path}: the shards' results differ")
        scale = max(float(compression.compress_int8(x)[1]) for x in xs)
        err = float((got[0] - (xs[0] + xs[1])).abs().max())
        if err > 2 * scale / 2 * (1 + 1e-6):
            fail(f"phase P psum {path}: error {err} past the int8 bound "
                 f"{scale}")
        worst = max(worst, err / scale)
        mean, res = compression.psum_with_error_feedback(xs, rs, "data",
                                                         mesh)
        if not (torch.isfinite(mean[0]).all() and torch.equal(mean[0],
                                                              mean[1])):
            fail(f"phase P error feedback {path}: the means differ")
        # each leaf's first rows (as a matrix of its last dim): the card
        # against the CPU, bitwise
        cut = [x.reshape(-1, x.shape[-1])[:rows].contiguous() for x in xs]
        rcut = [r.reshape(-1, r.shape[-1])[:rows].contiguous() for r in rs]
        card = (compression.compressed_psum(cut, "data", mesh),
                compression.psum_with_error_feedback(cut, rcut, "data", mesh))
        host = (compression.compressed_psum([c.cpu() for c in cut], "data",
                                             cpu_mesh),
                compression.psum_with_error_feedback(
                    [c.cpu() for c in cut], [r.cpu() for r in rcut], "data",
                    cpu_mesh))
        pairs = [(card[0][0], host[0][0]), (card[1][0][0], host[1][0][0]),
                 (card[1][1][0], host[1][1][0])]
        if not all(torch.equal(g.cpu(), w) for g, w in pairs):
            fail(f"phase P psum {path}: the card's first {rows} rows differ "
                 f"from the CPU's")
        n_el += like.numel()
        del xs, rs, got, mean, res
    torch.cuda.synchronize()
    report["compressed_psum"] = {
        "leaves": len(shapes), "elements_a_shard": n_el,
        "worst_error_over_scale": worst, "bound": "shards x scale / 2",
        "cpu_bitwise_rows": rows, "s": time.perf_counter() - t0}
    log(f"phase P compressed psum {json.dumps(report['compressed_psum'])} "
        f"({smi})")
    torch.cuda.empty_cache()

    # (f) phase T's llama3.2-1b checkpoint restored onto the mesh -----------
    state, _, _, _ = launch.build_training("llama3.2-1b", smoke=True,
                                           batch=None, seq=None, device=dev)
    cfg = get_arch("llama3.2-1b").make_config(False)
    store = CheckpointStore(str(ckpt_root / "uninterrupted" / "llama3.2-1b"),
                            keep_last=2)
    shardings = (param_shardings(tt.lm_logical_axes(cfg), mesh, LM_RULES),
                 None)
    (placed, popt), extra = store.restore(state, shardings=shardings,
                                          device=dev)
    (saved, sopt), _ = store.restore(state, device=dev)
    n_blocks = 0
    flat_saved = flatten_with_paths(saved)
    for path, leaf in flatten_with_paths(placed).items():
        want = flat_saved[path]
        if not isinstance(leaf, Sharded):
            fail(f"phase P restore {path}: not placed onto the mesh")
        entries = spec_entries(leaf.spec, want.dim())
        bs = leaf.block_shape()
        for pos in np.ndindex(*mesh.devices.shape):
            idx = block_of(mesh, entries, pos)
            sl = tuple(slice(i * b, (i + 1) * b) for i, b in zip(idx, bs))
            if not torch.equal(leaf.at(pos), want[sl]):
                fail(f"phase P restore {path}: block at {pos} differs")
            n_blocks += 1
    if not all(torch.equal(popt.mu[k], sopt.mu[k]) for k in sopt.mu):
        fail("phase P restore: Adam's state differs")
    report["restore"] = {"step": int(extra["next_step"]),
                         "leaves": len(flat_saved), "blocks": n_blocks,
                         "bitwise": True}
    log(f"phase P restore {json.dumps(report['restore'])} ({smi})")
    report["seconds"] = time.perf_counter() - t_phase
    return launches, report


# phase Y: the dry run's cost model against the card. Each program an
# earlier phase ran (cost_run) is traced on a one-device mesh
# (launch/graph_cost.py); its strict bound is its matmul flops at their
# dtype's peak against the bytes it must move (every argument byte it
# reads, once, and every output byte, once) at the memory rate. Where
# those bytes come to at least COST_CHECK_BYTES (20 x the card's 50 MB
# L2, so no cache can serve them) the device time the earlier phase
# measured with CUDA events must reach COST_SHARE_MIN x the bound: a
# cost model that promises less time than the card can take is wrong.
COST_RUNS: list = []
COST_PROGRAMS = (
    "paper-ranking offline_dual dense", "paper-ranking serve_online dense",
    "paper-ranking serve_retrieval dense", "deepfm retrieval_cand",
    "sasrec retrieval_cand", "bert4rec retrieval_cand",
    "mind retrieval_cand", "llama3.2-1b prefill 2 x 4096",
    "llama3.2-1b decode step 16 x 32768",
    "meshgraphnet ogb_products/16 train step", "deepfm train step")
COST_CHECK_BYTES = 1e9
COST_SHARE_MIN = 0.95


def hold_cost_model(smi):
    """Phase Y: every program of COST_RUNS traced on a one-device mesh
    over the fake card, its strict bound against its measured device
    time (checked where the bound's bytes reach COST_CHECK_BYTES), the
    bound's share of the time and the term that bounds it, the
    JAX-convention roofline terms and the measured time by category.
    Launches nothing. Returns its report."""
    from repro_torch.configs.registry import Program
    from repro_torch.launch.graph_cost import (
        FAKE_CARD,
        fake_card,
        graph_cost,
        trace_program,
    )
    from repro_torch.launch.mesh import virtual_mesh

    t_phase = time.perf_counter()
    got = [r["name"] for r in COST_RUNS]
    if sorted(got) != sorted(COST_PROGRAMS):
        fail(f"phase Y: the earlier phases kept {got}, not "
             f"{list(COST_PROGRAMS)}")
    with fake_card():
        mesh = virtual_mesh((1, 1), ("data", "model"), FAKE_CARD)
    report = {"programs": {}}
    for run in COST_RUNS:
        t0 = time.perf_counter()
        walk = trace_program(Program(fn=run["fn"], args=run["args"]), mesh)
        gc_ = graph_cost(walk)
        compute_s = roofline.compute_seconds(gc_["matmul_flops_by_dtype"])
        nbytes = walk.min_bytes()
        bytes_s = nbytes / roofline.HBM_BW
        bound_ms = max(compute_s, bytes_s) * 1e3
        checked = nbytes >= COST_CHECK_BYTES
        terms = roofline.terms_from_artifact({
            "mesh_devices": 1, "mesh_shape": [1, 1], "graph_cost": gc_,
            "collective_bytes": {"total": 0.0, "seconds": 0.0}}).as_dict()
        row = {"device_ms": run["ms"], "bound_ms": bound_ms,
               "bound_by": "bytes" if bytes_s >= compute_s else "operations",
               "share_of_bound": bound_ms / run["ms"],
               "bound_bytes": nbytes,
               "matmul_flops_by_dtype": gc_["matmul_flops_by_dtype"],
               "checked": checked, "roofline": terms,
               "device_ms_by_category": run["by_category"],
               "profiler_ms": sum(run["by_category"].values()),
               "ops": gc_["n_ops"], "kernel_ops": gc_["n_kernel_ops"],
               "trace_s": time.perf_counter() - t0}
        report["programs"][run["name"]] = row
        log(f"phase Y {run['name']}: {json.dumps(row)} ({smi})")
        if checked and run["ms"] < COST_SHARE_MIN * bound_ms:
            fail(f"phase Y {run['name']}: {run['ms']:.4f} ms measured, "
                 f"under {COST_SHARE_MIN} x the strict bound "
                 f"{bound_ms:.4f} ms")
    if not any(r["checked"] for r in report["programs"].values()):
        fail("phase Y: no program's bound reached COST_CHECK_BYTES")
    COST_RUNS.clear()
    report["seconds"] = time.perf_counter() - t_phase
    return report


def table23(rows):
    """Tables 2-3 of the paper from the Fig. 2 rows, as
    benchmarks/table23_regression.py computes them (a copy: this script
    imports nothing of benchmarks/): per dataset, each strategy's mean
    over the scenarios minus knn's, in log10 time per user, compliance
    and utility; and each scenario's mean over the strategies minus the
    smallest scenario's."""
    tables = {}
    for ds in sorted({r["dataset"] for r in rows}):
        cells = {(r["strategy"], r["m2"]): r for r in rows
                 if r["dataset"] == ds}
        m2s = sorted({m for _, m in cells})
        strategies = sorted({st for st, _ in cells})

        def mean(keys, key):
            vals = [cells[k][key] for k in keys if k in cells]
            return sum(vals) / len(vals)

        def delta(keys, base):
            return {
                "log10_time_delta": math.log10(mean(keys, "us_per_user"))
                - math.log10(mean(base, "us_per_user")),
                "compliance_delta": mean(keys, "compliance")
                - mean(base, "compliance"),
                "utility_delta": mean(keys, "utility")
                - mean(base, "utility")}

        table = {f"{st}_vs_knn": delta([(st, m) for m in m2s],
                                       [("knn", m) for m in m2s])
                 for st in strategies if st != "knn"}
        for m2 in m2s[1:]:
            table[f"size_{m2}_vs_{m2s[0]}"] = delta(
                [(st, m2) for st in strategies],
                [(st, m2s[0]) for st in strategies])
        tables[ds] = table
    return tables


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import ranking
    from repro_torch.core.predictors import KNNLambdaPredictor, pack_knn_db
    from repro_torch.data.synthetic import build_experiment, make_interactions
    from repro_torch.models.recommender import (
        PaperRecommender,
        RecommenderConfig,
    )
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.embedding_bag import (
        bag_geometry,
        embedding_bag_cuda,
    )
    from repro_torch.kernels.fused_rank import (
        MAX_KERNEL_M2,
        fused_rank_cuda,
        linear_rank_audited_cuda,
        rank_audited_cuda,
    )
    from repro_torch.kernels.knn_topk import (
        knn_lambda_cuda,
        knn_lambda_quant_cuda,
        knn_rank_audited_cuda,
        knn_rank_audited_quant_cuda,
        knn_topk_cuda,
    )
    from repro_torch.serving.engine import RankRequest, ServingEngine

    wrappers = {"rank_audited": rank_audited_cuda,
                "knn_rank_audited": knn_rank_audited_cuda,
                "linear_rank_audited": linear_rank_audited_cuda,
                "knn_lambda": knn_lambda_cuda,
                "knn_lambda_quant": knn_lambda_quant_cuda,
                "knn_rank_audited_quant": knn_rank_audited_quant_cuda,
                "fused_rank": fused_rank_cuda, "knn_topk": knn_topk_cuda,
                "embedding_bag": embedding_bag_cuda}
    def route_wrapper(pred, m2r):
        """The wrapper whose counter a dispatcher call of this route and
        m2 moves (kernel_launch_count says by how much)."""
        route = ops.route_of(pred)
        quant = route == "knn" and pred.X_q is not None
        if route == "knn" and m2r > MAX_KERNEL_M2:
            return "knn_lambda_quant" if quant else "knn_lambda"
        if route == "knn":
            return "knn_rank_audited_quant" if quant else "knn_rank_audited"
        return ("linear_rank_audited" if route == "affine"
                else "rank_audited")

    def plain_large_m2(pred, t, m2r, eps=EPS):
        """The dispatcher's route for m2 > MAX_KERNEL_M2 on the plain
        versions: lambda-hat (KNN's sweep order, the affine prologue's,
        the MLP's predict, or given: pred None), zero-padded to the K
        tier, then rank_given_lambda. No vals: the route ranks without
        them."""
        X, Kt = t["X"], t["a"].shape[1]
        route = ops.route_of(pred)
        if route == "lam":
            lam = X
        elif route == "mlp":
            lam = ref.predicted_lambda(pred, X, Kt)
        elif route == "affine":
            W, c, relu = ref.affine_params(pred, X.shape[1], Kt)
            lam = ref.affine_lambda_ref(X, W, c, relu)
        elif pred.X_q is None:
            lam = ref.knn_lambda_ref(X, pred.X_db, pred.lam_db, pred.k)
        else:
            lam = ref.knn_lambda_quant_ref(X, pred.X_q, pred.q_scale,
                                           pred.y2_q, pred.lam_db, pred.k,
                                           mode=pred.quant)[0]
        lam = torch.nn.functional.pad(lam, (0, Kt - lam.shape[1]))
        out = ranking.rank_given_lambda(t["u"], t["a"], t["b"], lam,
                                        t["gamma"], m2=m2r, eps=eps)
        return (None, out.perm, out.utility, out.exposure, out.compliant,
                out.lam)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    t_start = time.perf_counter()

    # -- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"phase 1: built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]       # the mangled kernel name
            elif "registers" in line or "spill" in line:
                log(f"  {name}: {entry}: {line.strip()}")

    # -- phase 2: each kernel against its plain version --------------------
    B, m1, K, m2 = BUCKET["B"], BUCKET["m1"], BUCKET["K"], BUCKET["m2"]
    X_db, lam_db = knn_db(gen, dev, N_DB)
    err = {name: 0.0 for name in KERNELS}
    for mm2 in (m2, 128):
        u, a, b, lam, g = rank_inputs(gen, dev, B, m1, K, mm2)
        got = rank_audited_cuda(u, a, b, lam, g, m2=mm2, eps=EPS)
        torch.cuda.synchronize()
        e = compare(f"rank_audited m2={mm2}", got,
                    ref.rank_audited_ref(u, a, b, lam, g, mm2, EPS))
        if mm2 == m2:
            err["rank_audited"] = e
        for relu in (True, False):
            X, W, c = affine_inputs(gen, dev, B, K, relu)
            got = linear_rank_audited_cuda(u, a, b, X, W, c, g, m2=mm2,
                                           eps=EPS, relu=relu)
            torch.cuda.synchronize()
            e = compare(f"linear_rank_audited m2={mm2} relu={relu}", got,
                        ref.linear_rank_audited_ref(u, a, b, X, W, c, g, mm2,
                                                    EPS, relu=relu),
                        lam_at=5)
            if not relu and not (got[5][:, 0] < 0).all():
                fail("the mean route clamped a negative price")
            if mm2 == m2:
                err["linear_rank_audited"] = max(
                    err["linear_rank_audited"], e)
        xq = torch.randn((B, D), generator=gen, device=dev)
        xq[0] = X_db[N_DB - 1]                   # an exact match
        for n_db in (N_DB, N_DB - 4093):         # and a ragged db
            xdb, ldb = X_db[:n_db], lam_db[:n_db]
            got = knn_rank_audited_cuda(xq, xdb, ldb, u, a, b, g, k=KNN_K,
                                        m2=mm2, eps=EPS)
            torch.cuda.synchronize()
            want = ref.knn_rank_audited_ref(xq, xdb, ldb, u, a, b, g,
                                            k=KNN_K, m2=mm2, eps=EPS)
            e = compare(f"knn_rank_audited m2={mm2} n_db={n_db}", got, want,
                        lam_at=5)
            if mm2 == m2 and n_db == N_DB:
                err["knn_rank_audited"] = e
                if not torch.equal(got[5][0, :K_PRED], lam_db[N_DB - 1]):
                    fail("exact-match query did not return its row's lambda")
            if mm2 == m2:
                lam_hat = knn_lambda_cuda(xq, xdb, ldb, k=KNN_K)
                torch.cuda.synchronize()
                plain = want[5][:, :K_PRED]
                if not torch.allclose(lam_hat, plain, **LAM_TOL):
                    fail(f"knn_lambda n_db={n_db}: outside {LAM_TOL}")
                err["knn_lambda"] = max(
                    err["knn_lambda"], float((lam_hat - plain).abs().max()))
                if not torch.equal(lam_hat, got[5][:, :K_PRED]):
                    fail(f"knn_lambda n_db={n_db}: lambda-hat differs from "
                         f"knn_rank_audited's")
    # the quantized kernels over the int8 and bf16 packs of the same db
    packs = {(mode, n_db): pack_knn_db(X_db[:n_db], mode=mode, device=dev)
             for mode in MODES for n_db in (N_DB, N_DB - 4093)}
    guard_share = {}
    for mm2 in (m2, 128):
        u, a, b, lam, g = rank_inputs(gen, dev, B, m1, K, mm2)
        xq = torch.randn((B, D), generator=gen, device=dev)
        for (mode, n_db), pack in packs.items():
            ldb = lam_db[:n_db]
            name = f"knn_rank_audited_quant {mode} m2={mm2} n_db={n_db}"
            got = knn_rank_audited_quant_cuda(xq, *pack, ldb, u, a, b, g,
                                              k=KNN_K, mode=mode, m2=mm2,
                                              eps=EPS)
            torch.cuda.synchronize()
            want = ref.knn_rank_audited_quant_ref(
                xq, *pack, ldb, u, a, b, g, k=KNN_K, mode=mode, m2=mm2,
                eps=EPS)
            e = compare(name, got, want, lam_at=5)
            if not torch.equal(got[6], want[6]):
                fail(f"{name}: guard differs from the plain version")
            if mm2 != m2:
                continue
            err["knn_rank_audited_quant"] = max(
                err["knn_rank_audited_quant"], e)
            lam_hat, guard = knn_lambda_quant_cuda(xq, *pack, ldb, k=KNN_K,
                                                   mode=mode)
            torch.cuda.synchronize()
            plain = want[5][:, :K_PRED]
            if not torch.allclose(lam_hat, plain, **LAM_TOL) or \
                    not torch.equal(guard, want[6]):
                fail(f"knn_lambda_quant {mode} n_db={n_db}: differs from "
                     f"the plain version")
            err["knn_lambda_quant"] = max(
                err["knn_lambda_quant"],
                float((lam_hat - plain).abs().max()))
            if not (torch.equal(lam_hat, got[5][:, :K_PRED])
                    and torch.equal(guard, got[6])):
                fail(f"knn_lambda_quant {mode} n_db={n_db}: lambda-hat or "
                     f"guard differs from knn_rank_audited_quant's")
            if n_db == N_DB:
                guard_share[mode] = float(guard.float().mean())
    # a db the int8 pack holds exactly: the 0.5 grid, 63.5 in every slab
    X_ll = torch.round((torch.rand((N_DB, D), generator=gen, device=dev)
                        * 126.0 - 63.0) * 2.0) / 2.0
    X_ll[::512] = 63.5
    u, a, b, lam, g = rank_inputs(gen, dev, B, m1, K, m2)
    xq = torch.round(torch.randn((B, D), generator=gen, device=dev)
                     * 20.0) / 2.0
    xq[0] = X_ll[N_DB - 1]                       # an exact match
    want = knn_rank_audited_cuda(xq, X_ll, lam_db, u, a, b, g, k=KNN_K,
                                 m2=m2, eps=EPS)
    for mode in MODES:
        pack = pack_knn_db(X_ll, mode=mode, device=dev)
        if mode == "int8" and not bool((pack[1] == 0.5).all()):
            fail("the 0.5-grid db did not pack at scale 0.5")
        got = knn_rank_audited_quant_cuda(xq, *pack, lam_db, u, a, b, g,
                                          k=KNN_K, mode=mode, m2=m2, eps=EPS)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got[:6], want)):
            fail(f"lossless {mode} pack: knn_rank_audited_quant differs from "
                 f"knn_rank_audited")
        if not torch.equal(got[5][0, :K_PRED], lam_db[N_DB - 1]):
            fail(f"lossless {mode} pack: exact-match query did not return "
                 f"its row's lambda")
    del X_ll
    # the quantized pair and the f32 kernels on orderings that stress a
    # filtered selection and at the limits, all over 1,048,576 rows;
    # drawn from a generator of their own, so the phases after this one
    # see the draws they always saw
    gen_l = torch.Generator(device=dev)
    gen_l.manual_seed(args.seed + 17)

    def quant_pair(name, xq, xdb, ldb, mode, k=KNN_K, k_extra=QUANT_EXTRA,
                   slab=512):
        """Both quantized kernels bitwise their plain versions, the chain
        kernel's lambda-hat and guard the fused kernel's."""
        pack = pack_knn_db(xdb, mode=mode, slab=slab, device=dev)
        u, a, b, _, g = rank_inputs(gen_l, dev, xq.shape[0], m1, K, m2)
        kw = dict(k=k, k_extra=k_extra, mode=mode)
        got = knn_rank_audited_quant_cuda(xq, *pack, ldb, u, a, b, g, m2=m2,
                                          eps=EPS, **kw)
        lam_hat, guard = knn_lambda_quant_cuda(xq, *pack, ldb, **kw)
        torch.cuda.synchronize()
        want = ref.knn_rank_audited_quant_ref(xq, *pack, ldb, u, a, b, g,
                                              m2=m2, eps=EPS, **kw)
        if not bitwise(got, want):
            fail(f"knn_rank_audited_quant {mode} {name}: differs from the "
                 f"plain version")
        if not bitwise((lam_hat, guard),
                       ref.knn_lambda_quant_ref(xq, *pack, ldb, **kw)):
            fail(f"knn_lambda_quant {mode} {name}: differs from the plain "
                 f"version")
        if not (torch.equal(lam_hat, got[5][:, :lam_hat.shape[1]])
                and torch.equal(guard, got[6])):
            fail(f"knn_lambda_quant {mode} {name}: lambda-hat or guard "
                 f"differs from knn_rank_audited_quant's")

    def f32_triple(name, xq, xdb, ldb, k=KNN_K):
        """The three f32 KNN kernels bitwise their plain versions, and
        knn_lambda's lambda-hat knn_rank_audited's."""
        u, a, b, _, g = rank_inputs(gen_l, dev, xq.shape[0], m1, K, m2)
        got = (knn_topk_cuda(xq, xdb, k=k),
               knn_lambda_cuda(xq, xdb, ldb, k=k))
        fused = knn_rank_audited_cuda(xq, xdb, ldb, u, a, b, g, k=k, m2=m2,
                                      eps=EPS)
        torch.cuda.synchronize()
        want = ref.knn_rank_audited_ref(xq, xdb, ldb, u, a, b, g, k=k,
                                        m2=m2, eps=EPS)
        if not (bitwise(got[0], ref.knn_topk_ref(xq, xdb, k))
                and bitwise(got[1], ref.knn_lambda_ref(xq, xdb, ldb, k))
                and bitwise(fused, want)
                and torch.equal(got[1], fused[5][:, :got[1].shape[1]])):
            fail(f"the f32 KNN kernels {name}: differ from the plain "
                 f"versions")
        return got

    ray = torch.nn.functional.normalize(
        torch.randn(D, generator=gen_l, device=dev), dim=0)
    ramp = torch.linspace(0.5, 8.0, N_DB, device=dev)[:, None]
    xq = torch.randn((B, D), generator=gen_l, device=dev) * 1e-3
    planted = torch.randn((N_DB, D), generator=gen_l, device=dev) * 3.0
    planted[::2999] = xq[0]       # exact ties across chunks and folds
    orderings = {"rising": ramp * ray, "falling": ramp.flip(0) * ray,
                 "identical": ray.expand(N_DB, D).contiguous(),
                 "planted": planted}
    for label, xdb in orderings.items():
        for mode in MODES:
            quant_pair(label, xq, xdb, lam_db, mode)
        got = f32_triple(label, xq, xdb, lam_db)
        first = {"rising": 0, "falling": N_DB - 1, "identical": 0,
                 "planted": 0}[label]
        if int(got[0][1][0, 0]) != first:
            fail(f"knn_topk {label}: row {first} is not first")
    del orderings, planted, ramp
    xq = torch.randn((B, D), generator=gen_l, device=dev)
    for kk in F32_K:
        f32_triple(f"k={kk}", xq, X_db, lam_db, k=kk)
    for mode in MODES:
        for kk in LIMIT_K:
            quant_pair(f"k={kk}", xq, X_db, lam_db, mode, k=kk)
        quant_pair("d=13 slab=200 ragged", xq[:, :13].contiguous(),
                   X_db[:N_DB - 4093, :13].contiguous(),
                   lam_db[:N_DB - 4093], mode, slab=200)
        quant_pair("n_pad < chunk", xq, X_db[:300], lam_db[:300], mode,
                   slab=128)
        quant_pair("k + k_extra = n_pad", xq, X_db[:60], lam_db[:60], mode,
                   k=56, slab=64)
    for dd in LIMIT_D:
        xdb = torch.randn((N_DB, dd), generator=gen_l, device=dev)
        xq = torch.randn((B, dd), generator=gen_l, device=dev)
        xq[0] = xdb[N_DB - 1]                    # an exact match
        for mode in MODES:
            quant_pair(f"d={dd}", xq, xdb, lam_db, mode)
        f32_triple(f"k={max(LIMIT_K)} d={dd}", xq, xdb, lam_db,
                   k=max(LIMIT_K))
    xdb = torch.randn((N_DB, F32_WIDE_D), generator=gen_l, device=dev)
    xq = torch.randn((B, F32_WIDE_D), generator=gen_l, device=dev)
    xq[0] = xdb[N_DB - 1]                        # an exact match
    got = f32_triple(f"d={F32_WIDE_D}", xq, xdb, lam_db)
    if int(got[0][1][0, 0]) != N_DB - 1:
        fail(f"knn_topk d={F32_WIDE_D}: the exact match is not first")
    del xdb
    torch.cuda.empty_cache()
    # the kernel library: fused_rank, knn_topk, knn_predict_kernel and
    # embedding_bag; `lib` keeps each case's inputs and plain outputs for
    # the library path (phase L)
    lib = {}
    for label, sh in (("bucket", BUCKET), ("bucket_m2_128",
                                           dict(BUCKET, m2=128)),
                      ("retrieval", RETRIEVAL)):
        u, a, b, lam, g = rank_inputs(gen, dev, sh["B"], sh["m1"], sh["K"],
                                      sh["m2"])
        got = fused_rank_cuda(u, a, lam, m2=sh["m2"], eps=EPS)
        audited = rank_audited_cuda(u, a, b, lam, g, m2=sh["m2"], eps=EPS)
        torch.cuda.synchronize()
        want = ref.fused_rank_ref(u, a, lam, sh["m2"], EPS)
        for name, other in (("its plain version", want),
                            ("rank_audited's", audited[:2])):
            if not (torch.equal(got[0], other[0])
                    and torch.equal(got[1], other[1])):
                fail(f"fused_rank {label}: (vals, idx) differ from {name}")
        err["fused_rank"] = max(err["fused_rank"],
                                float((got[0] - want[0]).abs().max()))
        if label != "bucket_m2_128":
            lib[("fused_rank", label)] = ((u, a, lam), dict(m2=sh["m2"]),
                                          want)
    # K = 64, the engine's tier after 32: coef in dynamic shared memory
    u, a, b, lam, g = rank_inputs(gen, dev, B, m1, WIDE_K, m2)
    X, W, c = affine_inputs(gen, dev, B, WIDE_K, True)
    wide = {"rank_audited": (rank_audited_cuda(u, a, b, lam, g, m2=m2,
                                               eps=EPS),
                             ref.rank_audited_ref(u, a, b, lam, g, m2, EPS)),
            "linear_rank_audited": (
                linear_rank_audited_cuda(u, a, b, X, W, c, g, m2=m2, eps=EPS),
                ref.linear_rank_audited_ref(u, a, b, X, W, c, g, m2, EPS)),
            "fused_rank": (fused_rank_cuda(u, a, lam, m2=m2, eps=EPS),
                           ref.fused_rank_ref(u, a, lam, m2, EPS))}
    torch.cuda.synchronize()
    for name, (got, want) in wide.items():
        if not bitwise(got, want):
            fail(f"{name} K={WIDE_K}: differs from the plain version")
    # the filter's worst case (scores rising with the item index: every
    # candidate is staged), a row of exact ties and falling scores, on
    # the bucket and on rows split over a cluster (4 x m1 = 100,000);
    # lam = 0 and W = c = 0 leave s = u
    for Bw, m1w in ((B, m1), (4, RETRIEVAL["m1"])):
        u0, a, b, lam, g = rank_inputs(gen, dev, Bw, m1w, K, m2)
        lam.zero_()
        X, W, c = affine_inputs(gen, dev, Bw, K, True)
        W.zero_()
        c.zero_()
        ramp = torch.arange(m1w, device=dev, dtype=torch.float32) / m1w
        for label, row in (("rising", ramp), ("ties", torch.ones_like(ramp)),
                           ("falling", 1.0 - ramp)):
            u = (u0[:, :1] + row).contiguous()
            pairs = {
                "rank_audited": (
                    rank_audited_cuda(u, a, b, lam, g, m2=m2, eps=EPS),
                    ref.rank_audited_ref(u, a, b, lam, g, m2, EPS)),
                "linear_rank_audited": (
                    linear_rank_audited_cuda(u, a, b, X, W, c, g, m2=m2,
                                             eps=EPS),
                    ref.linear_rank_audited_ref(u, a, b, X, W, c, g, m2,
                                                EPS)),
                "fused_rank": (fused_rank_cuda(u, a, lam, m2=m2, eps=EPS),
                               ref.fused_rank_ref(u, a, lam, m2, EPS))}
            torch.cuda.synchronize()
            for name, (got, want) in pairs.items():
                if not bitwise(got, want):
                    fail(f"{name} {label} rows {Bw} x {m1w}: differs from "
                         f"the plain version")
            first = {"rising": m1w - 1, "ties": 0, "falling": 0}[label]
            if int(pairs["fused_rank"][0][1][0, 0]) != first:
                fail(f"fused_rank {label}: item {first} is not first")
    # the paper's serve_retrieval cell: 256 x m1 = 1,048,576, K = 5,
    # m2 = 50 (6.44 GB of u and a), KNN over 65,536 rows
    sr = SERVE_RETRIEVAL
    u, a, b, lam, g = rank_inputs(gen, dev, sr["B"], sr["m1"], sr["K"],
                                  sr["m2"])
    xdb, ldb = knn_db(gen, dev, sr["n_db"])
    xq = torch.randn((sr["B"], D), generator=gen, device=dev)
    for name, got, want in (
            ("rank_audited",
             rank_audited_cuda(u, a, b, lam, g, m2=sr["m2"], eps=EPS),
             ref.rank_audited_ref(u, a, b, lam, g, sr["m2"], EPS)),
            ("knn_rank_audited",
             knn_rank_audited_cuda(xq, xdb, ldb, u, a, b, g, k=KNN_K,
                                   m2=sr["m2"], eps=EPS),
             ref.knn_rank_audited_ref(xq, xdb, ldb, u, a, b, g, k=KNN_K,
                                      m2=sr["m2"], eps=EPS)),
            ("fused_rank", fused_rank_cuda(u, a, lam, m2=sr["m2"], eps=EPS),
             ref.fused_rank_ref(u, a, lam, sr["m2"], EPS))):
        torch.cuda.synchronize()
        if not bitwise(got, want):
            fail(f"{name} at serve_retrieval: differs from the plain version")
    del u, a, b, lam, g, u0, xdb, ldb, got, want, wide, pairs
    torch.cuda.empty_cache()
    # m2 above the kernels' limit: the sort route, on the card, no launch
    u, a, b, lam, g = rank_inputs(gen, dev, B, m1, K, 256)
    before = read_counters(wrappers)
    big = ops.fused_rank(u, a, lam, m2=256, eps=EPS)
    big_ra = ops.rank_audited(u, a, b, lam, g, m2=256, eps=EPS)
    want = ranking.rank_given_lambda(u, a, b, lam, g, m2=256, eps=EPS)
    torch.cuda.synchronize()
    if read_counters(wrappers) != before or \
            ops.kernel_launch_count(None, 256) != 0:
        fail("m2=256 launched a kernel")
    if not (big[1].device == dev and torch.equal(big[1], want.perm)
            and torch.equal(big_ra.perm, want.perm)
            and torch.equal(big_ra.compliant, want.compliant)):
        fail("m2=256: the sort route differs from rank_given_lambda")
    X_wide = torch.randn((WIDE["n_db"], WIDE["d"]), generator=gen,
                         device=dev)
    for label, Bq, xdb, kk in (("bucket", B, X_db, KNN_K),
                               ("large", LARGE_KNN_B, X_db, KNN_K),
                               ("ragged", B, X_db[:N_DB - 4093], KNN_K),
                               ("wide", B, X_wide, WIDE["k"])):
        xq = torch.randn((Bq, xdb.shape[1]), generator=gen, device=dev)
        xq[0] = xdb[xdb.shape[0] - 1]            # an exact match
        got = knn_topk_cuda(xq, xdb, k=kk)
        torch.cuda.synchronize()
        want = ref.knn_topk_ref(xq, xdb, kk)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail(f"knn_topk {label}: (d2, idx) differ from the plain version")
        if int(got[1][0, 0]) != xdb.shape[0] - 1:
            fail(f"knn_topk {label}: the exact match is not first")
        err["knn_topk"] = max(err["knn_topk"],
                              float((got[0] - want[0]).abs().max()))
        lib[("knn_topk", label)] = ((xq, xdb), dict(k=kk), want)
    xq = lib[("knn_topk", "bucket")][0][0]
    lam_hat = knn_lambda_cuda(xq, X_db, lam_db, k=KNN_K)
    lam_pk = ops.knn_predict_kernel(X_db, lam_db, xq, k=KNN_K)
    torch.cuda.synchronize()
    if not torch.allclose(lam_pk, lam_hat, **LAM_TOL):
        fail(f"knn_predict_kernel: lambda-hat outside {LAM_TOL} of the "
             f"knn_lambda kernel's")
    pk_err = float((lam_pk - lam_hat).abs().max())
    lib[("knn_predict_kernel", "bucket")] = ((X_db, lam_db, xq),
                                             dict(k=KNN_K), lam_hat)
    table32 = torch.randn((BAG["V"], BAG["D"]), generator=gen, device=dev)
    bag_idx = torch.randint(0, BAG["V"], (BAG["n_bags"], BAG["bag"]),
                            generator=gen, device=dev, dtype=torch.int32)
    pad = torch.rand(bag_idx.shape, generator=gen, device=dev) < 0.1
    bag_idx = torch.where(pad, torch.full_like(bag_idx, -1), bag_idx)
    bag_w = torch.randn(bag_idx.shape, generator=gen, device=dev)
    for label, table in (("f32", table32),
                         ("bf16", table32.to(torch.bfloat16))):
        got = embedding_bag_cuda(table, bag_idx, bag_w)
        torch.cuda.synchronize()
        want = ref.embedding_bag_ref(table, bag_idx, bag_w)
        if got.dtype != table.dtype or not torch.equal(got, want):
            fail(f"embedding_bag {label}: differs from the plain version")
        err["embedding_bag"] = max(
            err["embedding_bag"],
            float((got.float() - want.float()).abs().max()))
        lib[("embedding_bag", label)] = ((table, bag_idx, bag_w), {}, want)
    # embedding_bag at MIND's and DeepFM's serve_bulk shapes and on the
    # edge cases, each with an all-padded bag, a bag that names one row
    # in every slot and indices past the table; drawn from a generator of
    # their own
    gen_b = torch.Generator(device=dev)
    gen_b.manual_seed(args.seed + 29)
    bag_cases = {k: v for k, v in BAG_SHAPES.items() if k != "kernel_bench"}
    for label, case in {**bag_cases, **BAG_EDGES}.items():
        case = dict(case)
        view = case.pop("view", None)
        big, idx, w = bag_inputs(gen_b, dev, **case, edges=True)
        for dt in (torch.float32, torch.bfloat16):
            table = bag_table(big, dt, view)
            got = embedding_bag_cuda(table, idx, w)
            torch.cuda.synchronize()
            if not bitwise(got, ref.embedding_bag_ref(table, idx, w)):
                fail(f"embedding_bag {label} {dt}: differs from the plain "
                     f"version")
            del got, table
        del big, idx, w
    torch.cuda.empty_cache()
    log(f"phase 2: kernels equal their plain versions, max abs err {err}; "
        f"knn_lambda's lambda-hat is bitwise knn_rank_audited's, "
        f"knn_lambda_quant's lambda-hat and guard bitwise "
        f"knn_rank_audited_quant's; on the lossless pack both modes equal "
        f"knn_rank_audited bitwise; both modes bitwise on rising, falling, "
        f"identical and planted-tie rows, at k={LIMIT_K}, d={LIMIT_D}, d=13 "
        f"with a ragged slab, n_pad < one chunk and k + k_extra = n_pad; "
        f"the f32 kernels bitwise on the same four orderings, at "
        f"k={F32_K}, at k={max(LIMIT_K)} with d={LIMIT_D} and at "
        f"d={F32_WIDE_D}; "
        f"guard fired on {guard_share} of rows "
        f"at n_db={N_DB}; fused_rank's (vals, idx) are rank_audited's; "
        f"the rank kernels bitwise at K={WIDE_K}, on rising, tied and "
        f"falling rows and at serve_retrieval {SERVE_RETRIEVAL}; "
        f"m2=256 took the sort route with no launch; knn_predict_kernel "
        f"within {pk_err} of knn_lambda; padded bag slots "
        f"{float(pad.float().mean())}; embedding_bag bitwise in f32 and "
        f"bf16 at {sorted(bag_cases)} and {sorted(BAG_EDGES)}")

    # -- phase O: the paper's experiment (Fig. 2, Tables 2-3) --------------
    ex = EXPERIMENT
    fig2_rows, quant_rows, stage_s = [], [], {}
    offline_launches = dict.fromkeys(wrappers, 0)
    tables_by_build, first_X = {}, {}
    t_phase = time.perf_counter()
    for dataset, m2o in itertools.product(DATASETS, SCENARIOS):
        build = f"{dataset}/m2={m2o}"
        gen_e = torch.Generator(device=dev)
        gen_e.manual_seed(args.seed)
        exp = build_experiment(gen_e, dataset=dataset,
                               n_users=ex["n_users"], n_items=ex["n_items"],
                               m1=ex["m1"], m2=m2o,
                               train_frac=ex["train_frac"],
                               recommender_epochs=ex["epochs"], device=dev)
        u_tr, X_tr, a_tr = exp.split("train")
        u_h, X_h, a_h = exp.split("test")
        n_h, K_o = u_h.shape[0], exp.a.shape[1]
        for name, x in (("u", exp.u), ("X", exp.X), ("a", exp.a)):
            if not bool(torch.isfinite(x).all()):
                fail(f"phase O {build}: {name} is not finite")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe = ranking.fit_pipeline(X_tr, u_tr, a_tr, exp.b, exp.gamma,
                                    m2=m2o, num_iters=ex["iters"],
                                    with_mlp=True, device=dev)
        torch.cuda.synchronize()
        stage_s[build] = dict(exp.stage_s,
                              fit_pipeline=time.perf_counter() - t0)
        sol = pipe.train_solution
        if not (torch.isfinite(sol.lam).all() and (sol.lam >= 0).all()):
            fail(f"phase O {build}: shadow prices not finite and >= 0")
        # every build of one seed trains the same recommender: equal
        # tables, or the card's scatter-add order showing
        if dataset == DATASETS[0] and m2o == SCENARIOS[0]:
            first_X = exp.X.clone()
        tables_by_build[build] = float((exp.X - first_X).abs().max())
        quant = m2o <= MAX_KERNEL_M2 and dataset == "movielens"
        if quant:
            for mode in MODES:
                pipe = ranking.with_predictor(
                    pipe, f"knn_{mode}",
                    pipe.predictors["knn"].quantized(mode, device=dev))
        b_rows = exp.b.expand(n_h, K_o).contiguous()
        g_rows = exp.gamma.expand(n_h, m2o).contiguous()
        t_h = {"X": X_h, "u": u_h, "a": a_h, "b": b_rows, "gamma": g_rows}
        expect = dict.fromkeys(wrappers, 0)

        def strategy_call(strategy):
            return ranking.rank_with_strategy(
                pipe, strategy, X_h, u_h, a_h, exp.b,
                dual_iters=ex["iters"], backend="kernel", device=dev)

        names = STRATEGIES + (tuple(f"knn_{m}" for m in MODES) if quant
                              else ())
        outs, us = {}, {}
        torch.cuda.synchronize()
        reset_counters(wrappers)
        for strategy in names:
            outs[strategy] = strategy_call(strategy)
            times = []
            for _ in range(TIMED_RUNS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                strategy_call(strategy)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            us[strategy] = float(np.median(times)) / n_h * 1e6
            pred = pipe.predictors.get(strategy)
            expect[route_wrapper(pred, m2o)] += (
                (1 + TIMED_RUNS) * ops.kernel_launch_count(pred, m2o))
        chains = {}
        if quant:
            for name in ("knn",) + tuple(f"knn_{m}" for m in MODES):
                pred = pipe.predictors[name]
                chains[name] = ops.predict_rank_audited(
                    X_h, pred, u_h, a_h, exp.b, exp.gamma, m2=m2o,
                    eps=pipe.eps, knn_chain=True, device=dev)
                expect[route_wrapper(pred, MAX_KERNEL_M2 + 1)] += 2
                expect["rank_audited"] += 1
        torch.cuda.synchronize()
        launches = read_counters(wrappers)
        if launches != expect:
            fail(f"phase O {build}: launch counters {launches} != the "
                 f"calls' kernel_launch_count {expect}")
        for name in wrappers:
            offline_launches[name] += launches[name]
        for strategy, out in outs.items():
            pred = pipe.predictors.get(strategy)
            eps = 0.0 if strategy == "none" else pipe.eps
            if m2o > MAX_KERNEL_M2:
                t_s = dict(t_h, X=out.lam) if pred is None else t_h
                want = plain_large_m2(pred, t_s, m2o, eps=eps)
            elif pred is None:
                want = ref.rank_audited_ref(u_h, a_h, b_rows, out.lam,
                                            g_rows, m2o, eps)
            else:
                want = ref.predict_rank_audited_ref(
                    X_h, pred, u_h, a_h, b_rows, g_rows, m2o, eps)
            got = (want[0], out.perm, out.utility, out.exposure,
                   out.compliant, out.lam)
            compare(f"phase O {build} {strategy}", got, want,
                    lam_at=None if pred is None else 5)
        for name, out in chains.items():
            if not (torch.equal(out.perm, outs[name].perm)
                    and torch.equal(out.lam, outs[name].lam)):
                fail(f"phase O {build}: the {name} chain differs from its "
                     f"fused route")
        opt_util = float(outs["optimal"].utility.mean())
        for strategy, out in outs.items():
            row = {"dataset": dataset, "m2": m2o, "strategy": strategy,
                   "us_per_user": us[strategy],
                   "compliance": float(out.compliant.float().mean()),
                   "utility": float(out.utility.mean()),
                   "utility_vs_optimal": float(out.utility.mean())
                   / opt_util, "n_te": n_h, "m1": ex["m1"]}
            (fig2_rows if strategy in STRATEGIES else quant_rows).append(row)
            log(f"phase O fig2 {json.dumps(row)}")
        comp = {st: float(outs[st].compliant.float().mean())
                for st in STRATEGIES}
        if comp["optimal"] < comp["none"]:
            fail(f"phase O {build}: optimal's compliance {comp['optimal']} "
                 f"is below none's {comp['none']}")
        log(f"phase O {build}: stage seconds {json.dumps(stage_s[build])}; "
            f"train compliance {float(sol.compliant.float().mean())}; eps "
            f"{pipe.eps}; launches {launches}; compliance ordering "
            f"{sorted(comp, key=comp.get)}")
        if dataset == "movielens" and m2o == SCENARIOS[0]:
            serve_pipe = pipe            # phase 3 serves its predictors
        del exp, pipe, outs, chains, u_tr, X_tr, a_tr, u_h, X_h, a_h, t_h
        del b_rows, g_rows, sol
        torch.cuda.empty_cache()
    phase_o_s = time.perf_counter() - t_phase
    log(f"phase O: Table 2-3 deltas {json.dumps(table23(fig2_rows))}")
    # the recommender's training step, which takes most of a build: its
    # wall time (synchronised) against the device time and the device
    # operations the profiler records, over 50 steps at the tables' size
    steps = 50
    gen_p = torch.Generator(device=dev)
    gen_p.manual_seed(args.seed)
    inter = make_interactions(gen_p, n_users=ex["n_users"],
                              n_items=ex["n_items"], n_obs=steps * 200,
                              device=dev)
    rec = PaperRecommender(RecommenderConfig(n_users=ex["n_users"],
                                             n_items=ex["n_items"]),
                           gen=gen_p, device=dev)
    ratings = {"uid": inter.uid, "iid": inter.iid, "rating": inter.rating}
    rec.train(ratings, gen=gen_p, epochs=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec.train(ratings, gen=gen_p, epochs=1)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    split = device_split({"step": lambda: rec.train(ratings, gen=gen_p,
                                                      epochs=1)}, reps=1)
    step_split = {"wall_ms": step_ms}
    if isinstance(split["step"], dict):
        step_split.update(
            device_ms=sum(split["step"].values()) / steps,
            device_busy=sum(split["step"].values()) / steps / step_ms)
    log(f"phase O: a training step (batch 200, {ex['n_users']} x "
        f"{ex['n_items']} tables) {json.dumps(step_split)}")
    del rec, inter, ratings
    log(f"phase O: {len(fig2_rows)} Fig. 2 rows and {len(quant_rows)} "
        f"quantized-KNN rows in {phase_o_s:.1f} s; the recommender's "
        f"user table against the first build's, max abs difference "
        f"{json.dumps(tables_by_build)}; launches {offline_launches}")

    # -- phase 3: the engine serves five routes -----------------------------
    rng = np.random.default_rng(args.seed)
    knn = KNNLambdaPredictor(X_db=X_db, lam_db=lam_db, k=KNN_K)
    predictors = {"knn": knn, "linear": serve_pipe.predictors["linear"],
                  "mean": serve_pipe.predictors["mean"],
                  "mlp": serve_pipe.predictors["mlp"]}
    for mode in MODES:
        predictors[f"knn_{mode}"] = knn.quantized(mode, device=dev)
    kinds = [kind for kind, count in SERVE_MIX.items() for _ in range(count)]
    reqs = []
    for rid, i in enumerate(rng.permutation(len(kinds))):
        kind, m2r = kinds[i]
        gam = (1.0 / np.log2(np.arange(2, m2r + 2))).astype(np.float32)
        mm1 = int(rng.integers(512, 1025))
        kw = dict(rid=rid, m2=m2r, gamma=gam,
                  u=rng.uniform(1.0, 5.0, mm1).astype(np.float32),
                  a=(rng.random((K_PRED, mm1)) < 0.15).astype(np.float32),
                  b=np.full(K_PRED, 0.06 * gam.sum(), np.float32))
        if kind == "_lam":
            kw.update(lam=rng.exponential(0.5, K_PRED).astype(np.float32))
        else:
            kw.update(X=(rng.normal(size=D) / math.sqrt(D)).astype(
                np.float32), tag=str(kind))
        reqs.append(RankRequest(**kw))

    class CheckedEngine(ServingEngine):
        """Keeps each batch's padded inputs and outputs for the check
        (the inputs copied before the slot goes back to its ring)."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.captured = []

        def _materialize_batch(self, pending):
            staged = {k: v.copy() for k, v in pending.staged.items()}
            super()._materialize_batch(pending)
            self.captured.append(
                (pending.bucket, staged,
                 [e.req.rid for e in pending.entries], pending.out))

    eng = CheckedEngine(max_batch=32, max_wait_ms=2.0, eps=EPS, device="cuda")
    for tag, p in predictors.items():
        eng.register_predictor(tag, p, d_cov=D)
    warm = eng.warmup(reqs)
    torch.cuda.synchronize()
    eng.captured.clear()
    reset_counters(wrappers)
    t0 = time.perf_counter()
    results = eng.serve_stream(reqs)
    serve_s = time.perf_counter() - t0
    serve_launches = read_counters(wrappers)
    by_rid = {r.rid: r for r in results}
    if sorted(by_rid) != list(range(len(reqs))):
        fail(f"served {len(by_rid)} of {len(reqs)} requests")
    n_batches = {kind: 0 for kind in SERVE_MIX}
    expect = dict.fromkeys(wrappers, 0)
    for bucket, staged, rids, out in eng.captured:
        big = bucket.m2 > MAX_KERNEL_M2
        n_batches[(bucket.tag, 500 if big else 50)] += 1
        pred = predictors.get(bucket.tag)
        expect[route_wrapper(pred, bucket.m2)] += ops.kernel_launch_count(
            pred, bucket.m2)
        t = {k: torch.tensor(v, device=dev) for k, v in staged.items()}
        if big:
            want = plain_large_m2(pred, t, bucket.m2)
        elif bucket.tag == "_lam":
            want = ref.rank_audited_ref(t["u"], t["a"], t["b"], t["lam"],
                                        t["gamma"], bucket.m2, EPS)
        else:
            want = ref.predict_rank_audited_ref(
                t["X"], predictors[bucket.tag], t["u"], t["a"], t["b"],
                t["gamma"], bucket.m2, EPS)
        got = [torch.tensor(np.asarray(x), device=dev) for x in
               (out.perm, out.perm, out.utility, out.exposure,
                out.compliant, out.lam)]
        got[0] = want[0]                         # vals are not served
        compare(f"served batch {bucket.name}", got, want,
                lam_at=None if bucket.tag == "_lam" else 5)
        for i, rid in enumerate(rids):
            res, req = by_rid[rid], reqs[rid]
            perm = res.perm
            if perm.shape != (req.m2,) or len(set(perm.tolist())) != req.m2 \
                    or perm.min() < 0 or perm.max() >= req.u.shape[0]:
                fail(f"request {rid}: malformed perm")
            if not np.array_equal(perm, want[1][i, :req.m2].cpu().numpy()):
                fail(f"request {rid}: served perm differs from the plain "
                     f"version")
            if not np.isfinite(res.utility) or \
                    not np.isfinite(res.exposure).all():
                fail(f"request {rid}: non-finite audit")
    if serve_launches != expect or eng.metrics.kernel_launches != sum(
            expect.values()):
        fail(f"launch counters {serve_launches} != batches x route launches "
             f"{expect} (metrics {eng.metrics.kernel_launches})")
    for name in ("rank_audited", "knn_rank_audited", "linear_rank_audited",
                 "knn_rank_audited_quant", "knn_lambda", "knn_lambda_quant"):
        if serve_launches[name] == 0:
            fail(f"{name} never launched on the serving path")
    n_batches = {f"{tag}/m2={m2r}": n for (tag, m2r), n in n_batches.items()}
    summary = eng.metrics.summary()
    log(f"phase 3: served {len(results)} requests in {serve_s:.3f} s over "
        f"{summary['batches']} batches {n_batches}, buckets "
        f"{warm['buckets']}, launches {serve_launches}, compliance "
        f"{summary['compliance']}, latency_ms {summary['latency_ms']}")
    eng.close()

    # -- phase 3, the xla row: the same stream through executor="xla" -----
    xla_report = serve_xla(dev, reqs, predictors, by_rid, summary, serve_s,
                           wrappers)
    log(f"phase 3 xla: {json.dumps(xla_report)}")
    mean_pred = serve_pipe.predictors["mean"]    # phase S's degradation rung
    del eng, serve_pipe

    # -- phase S: serving under offered load ---------------------------------
    load_launches, frontier, load_report = serve_under_load(
        args.seed, dev, knn, mean_pred, wrappers, route_wrapper)
    del mean_pred
    log(f"phase S: capacity {load_report['capacity_qps']} req/s; "
        f"{json.dumps(load_report)}; launches {load_launches}")

    # -- phase R: the refresh lane on the card -------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    refresh_launches, refresh_report = serve_refresh(
        args.seed, dev, X_db, load_report["capacity_qps"], wrappers,
        route_wrapper, smi)
    log(f"phase R: {refresh_report['seconds']:.1f} s, launches "
        f"{refresh_launches}")

    # -- phase A: the adaptive lattice on the card ---------------------------
    lattice_launches, lattice_report = serve_lattice(
        args.seed, dev, knn, load_report["capacity_qps"], wrappers,
        route_wrapper, smi)
    log(f"phase A: {lattice_report['seconds']:.1f} s, launches "
        f"{lattice_launches}")

    # -- phase F: the replica fleet under chaos ------------------------------
    fleet_launches, fleet_report = serve_fleet(args.seed, dev, knn, wrappers,
                                               route_wrapper, smi)
    log(f"phase F: {fleet_report['seconds']:.1f} s, launches "
        f"{fleet_launches}")

    # -- phase D: the deployment driver at the published widths -------------
    deploy_launches, deploy_report = serve_deployments(
        args.seed, dev, wrappers, route_wrapper, smi)
    log(f"phase D: {deploy_report['seconds']:.1f} s, launches "
        f"{deploy_launches}")

    # -- phase M: the paper's cells and the dist executor on a mesh ---------
    mesh_launches, mesh_dense_launches, mesh_report = serve_mesh(
        args.seed, dev, X_db, lam_db, predictors, wrappers, smi)
    log(f"phase M: {mesh_report['seconds']:.1f} s, launches "
        f"{mesh_launches}, dense side {mesh_dense_launches}")

    # -- phase L: the kernel library's entry points --------------------------
    entry = {"fused_rank": ops.fused_rank, "knn_topk": ops.knn_topk,
             "knn_predict_kernel": ops.knn_predict_kernel,
             "embedding_bag": ops.embedding_bag}
    torch.cuda.synchronize()
    reset_counters(wrappers)
    t0 = time.perf_counter()
    lib_out = {key: entry[key[0]](*args, **kw)
               for key, (args, kw, _) in lib.items()}
    torch.cuda.synchronize()
    lib_s = time.perf_counter() - t0
    lib_launches = read_counters(wrappers)
    for key, out in lib_out.items():
        want = lib[key][2]
        if key[0] == "knn_predict_kernel":
            ok = torch.allclose(out, want, **LAM_TOL)
        elif key[0] == "embedding_bag":
            ok = torch.equal(out, want)
        else:
            ok = torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
        if not ok:
            fail(f"library path {' '.join(key)}: the output differs from "
                 f"phase 2's plain version")
    calls = {name: sum(k[0] == name for k in lib) for name in entry}
    expect = dict.fromkeys(wrappers, 0)
    expect.update(fused_rank=calls["fused_rank"],
                  knn_topk=2 * (calls["knn_topk"]
                                + calls["knn_predict_kernel"]),
                  embedding_bag=calls["embedding_bag"])
    if lib_launches != expect:
        fail(f"library path launch counters {lib_launches} != {expect}")
    log(f"phase L: {len(lib_out)} entry-point calls {calls} in "
        f"{lib_s:.3f} s, outputs equal to the plain versions, launches "
        f"{lib_launches}")

    # -- phase 4: timing ---------------------------------------------------
    # the rank kernels (rank_timings, which bench_rank.py also runs on
    # another checkout)
    timing = rank_timings(SimpleNamespace(
        fused_rank_cuda=fused_rank_cuda, rank_audited_cuda=rank_audited_cuda,
        linear_rank_audited_cuda=linear_rank_audited_cuda,
        knn_rank_audited_cuda=knn_rank_audited_cuda, ref=ref), gen, dev)
    # the rank kernels' device time alone (torch.profiler): the events
    # above time back-to-back wrapper calls, the host's work included
    rank_split_ms = {}
    for label, Bt in (("bucket", B), ("large", LARGE_RANK_B)):
        u, a, b, lam, g = rank_inputs(gen, dev, Bt, m1, K, m2)
        X, W, c = affine_inputs(gen, dev, Bt, K, True)
        rank_split_ms.update(device_split({
            f"rank_audited {label}": lambda: rank_audited_cuda(
                u, a, b, lam, g, m2=m2, eps=EPS),
            f"linear_rank_audited {label}": lambda: linear_rank_audited_cuda(
                u, a, b, X, W, c, g, m2=m2, eps=EPS),
            f"fused_rank {label}": lambda: fused_rank_cuda(u, a, lam, m2=m2,
                                                           eps=EPS)}))
    del u, a, b, lam, g, X, W, c
    # the KNN kernels (knn_timings, which bench_rank.py also runs on
    # another checkout)
    knn_t, library = knn_timings(SimpleNamespace(
        knn_topk_cuda=knn_topk_cuda, knn_lambda_cuda=knn_lambda_cuda,
        knn_rank_audited_cuda=knn_rank_audited_cuda,
        knn_lambda_quant_cuda=knn_lambda_quant_cuda,
        knn_rank_audited_quant_cuda=knn_rank_audited_quant_cuda, ref=ref),
        gen, dev, X_db, lam_db, {m: packs[(m, N_DB)] for m in MODES})
    for key, row in knn_t.items():
        if not row.pop("bitwise"):
            fail(f"{' '.join(key)}: differs from the plain version")
    timing.update(knn_t)
    # knn_predict_kernel, on phase 2's inputs
    (Xd, ld, xq), kw, _ = lib[("knn_predict_kernel", "bucket")]
    predict_ms = time_ms(lambda: ops.knn_predict_kernel(Xd, ld, xq, **kw), 10)
    # embedding_bag at S1, S2 and S3 (bag_timings, which bench_rank.py
    # also runs on another checkout)
    bag_t = bag_timings(SimpleNamespace(
        embedding_bag_cuda=embedding_bag_cuda, bag_geometry=bag_geometry,
        ref=ref), gen, dev)
    for key, row in bag_t.items():
        if not row.pop("bitwise"):
            fail(f"{' '.join(key)}: differs from the plain version")
    timing.update(bag_t)
    for key, tm in timing.items():
        log(f"phase 4: {' '.join(key)} {json.dumps(tm)}")
    log(f"phase 4: knn_predict_kernel at the bucket {predict_ms} ms")
    log(f"phase 4: rank kernels' device ms per call "
        f"{json.dumps(rank_split_ms)}")
    log(f"phase 4: device ms per call by kernel (sweep and merge) "
        f"{json.dumps({' '.join(key): row['split_ms'] for key, row in knn_t.items() if 'split_ms' in row})}")

    # -- phase Z: the LM half of the zoo ------------------------------------
    del lib
    zoo_report = serve_lm_zoo(args.seed, dev, smi)
    log(f"phase Z: {zoo_report['seconds']:.1f} s ({smi})")

    # -- phase G: the GNN half of the zoo ------------------------------------
    gnn_launches, gnn_report = train_gnn_cells(args.seed, dev, wrappers, smi)
    log(f"phase G: {gnn_report['seconds']:.1f} s, launches {gnn_launches} "
        f"({smi})")

    # -- phase T: the training driver with an injected failure, then --------
    # -- phase P: the zoo's cell programs over a mesh (its checkpoint) -------
    import shutil
    try:
        train_report = train_with_failures(dev, smi)
        log(f"phase T: {train_report['seconds']:.1f} s ({smi})")
        prog_launches, prog_report = serve_cell_programs(
            args.seed, dev, wrappers, PHASE_T_CKPT, smi)
    finally:
        shutil.rmtree(PHASE_T_CKPT, ignore_errors=True)
    log(f"phase P: {prog_report['seconds']:.1f} s, launches {prog_launches} "
        f"({smi})")

    # -- phase Y: the dry run's cost model against the card -----------------
    cost_report = hold_cost_model(smi)
    log(f"phase Y: {cost_report['seconds']:.1f} s, "
        f"{len(cost_report['programs'])} programs, "
        f"{sum(r['checked'] for r in cost_report['programs'].values())} "
        f"checked ({smi})")

    csrc = "src/repro_torch/kernels/csrc/"
    sources = {"rank_audited": (csrc + "rank_audited.cu",
                                "src/repro/kernels/fused_rank.py:261"),
               "knn_rank_audited": (csrc + "knn_rank_audited.cu",
                                    "src/repro/kernels/knn_topk.py:574"),
               "linear_rank_audited": (csrc + "linear_rank_audited.cu",
                                       "src/repro/kernels/fused_rank.py:384"),
               "knn_lambda": (csrc + "knn_lambda.cu",
                              "src/repro/kernels/knn_topk.py:253"),
               "knn_lambda_quant": (csrc + "knn_lambda_quant.cu",
                                    "src/repro/kernels/knn_topk.py:426"),
               "knn_rank_audited_quant": (
                   csrc + "knn_rank_audited_quant.cu",
                   "src/repro/kernels/knn_topk.py:731"),
               "fused_rank": (csrc + "fused_rank.cu",
                              "src/repro/kernels/fused_rank.py:128"),
               "knn_topk": (csrc + "knn_topk.cu",
                            "src/repro/kernels/knn_topk.py:129"),
               "embedding_bag": (csrc + "embedding_bag.cu",
                                 "src/repro/kernels/embedding_bag.py:76")}
    main_key = {"fused_rank": ("fused_rank", "bucket"),
                "embedding_bag": ("embedding_bag", "kernel_bench", "f32")}
    rows = []
    for name, (source, replaces) in sources.items():
        quant = name.endswith("_quant")
        # a quantized kernel's headline numbers are its int8 mode's
        main_t = timing[main_key.get(
            name, (name, "bucket") + (("int8",) if quant else ()))]
        shape = {"batch": B, "m1": m1, "K": K, "m2": m2}
        if name == "linear_rank_audited":
            shape.update(d=D, K_pred=K_PRED)
        elif name == "knn_lambda":
            shape = {"batch": B, "n_db": N_DB, "d": D, "k": KNN_K,
                     "K_pred": K_PRED}
        elif name == "knn_lambda_quant":
            shape = {"batch": B, "n_db": N_DB, "d": D, "k": KNN_K,
                     "k_keep": KNN_K + QUANT_EXTRA, "K_pred": K_PRED,
                     "mode": "int8"}
        elif name == "knn_rank_audited":
            shape.update(n_db=N_DB, d=D, k=KNN_K)
        elif name == "knn_rank_audited_quant":
            shape.update(n_db=N_DB, d=D, k=KNN_K,
                         k_keep=KNN_K + QUANT_EXTRA, mode="int8")
        elif name == "knn_topk":
            shape = {"batch": B, "n_db": N_DB, "d": D, "k": KNN_K}
        elif name == "embedding_bag":
            shape = dict(BAG, table="f32", padded_share=main_t[
                "padded_share"])
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (offline_launches[name] + serve_launches[name]
                         + load_launches[name] + refresh_launches[name]
                         + lattice_launches[name] + fleet_launches[name]
                         + deploy_launches[name] + mesh_launches[name]
                         + mesh_dense_launches[name] + lib_launches[name]
                         + gnn_launches[name] + prog_launches[name]),
            "launches_by_path": {"offline_holdout": offline_launches[name],
                                 "serving": serve_launches[name],
                                 "serving_under_load": load_launches[name],
                                 "refresh": refresh_launches[name],
                                 "lattice": lattice_launches[name],
                                 "fleet": fleet_launches[name],
                                 "deployment": deploy_launches[name],
                                 "distributed": mesh_launches[name],
                                 "distributed_dense_side":
                                     mesh_dense_launches[name],
                                 "kernel_library": lib_launches[name],
                                 "gnn_ranking_head": gnn_launches[name],
                                 "cell_programs": prog_launches[name]},
            "max_abs_err": err[name], "ms": main_t["ms"],
            "plain_ms": main_t["plain_ms"], "bound_ms": main_t["bound_ms"],
            "bound_by": main_t["bound_by"],
            "library_ms": main_t["library_ms"], "shape": shape})
        if quant:
            rows[-1].update(
                modes={mode: {label: timing[(name, label, mode)]
                              for label in ("bucket", "large")}
                       for mode in MODES},
                library=library, guard_share_at_n_db=guard_share)
            if name == "knn_lambda_quant":
                rows[-1]["split_ms"] = {
                    m: {label: timing[(name, label, m)]["split_ms"]
                        for label in ("bucket", "large")} for m in MODES}
        elif name == "fused_rank":
            rows[-1]["retrieval"] = timing[(name, "retrieval")]
            rows[-1]["device_ms"] = {k: v for k, v in rank_split_ms.items()
                                     if k.startswith(name)}
        elif name == "embedding_bag":
            rows[-1]["shapes"] = {
                label: {dt: timing[(name, label, dt)]
                        for dt in ("f32", "bf16")} for label in BAG_SHAPES}
        else:
            rows[-1]["large"] = timing[(name, "large")]
            if name in ("rank_audited", "linear_rank_audited"):
                rows[-1]["device_ms"] = {
                    k: v for k, v in rank_split_ms.items()
                    if k.split()[0] == name}
            if (name, "serve_retrieval") in timing:
                rows[-1]["serve_retrieval"] = timing[
                    (name, "serve_retrieval")]
            if name in ("knn_lambda", "knn_rank_audited", "knn_topk"):
                rows[-1]["split_ms"] = {
                    label: timing[(name, label)]["split_ms"]
                    for label in ("bucket", "large")}
            if name == "knn_topk":
                rows[-1]["knn_predict_kernel_ms"] = predict_ms
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

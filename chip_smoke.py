#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

It takes no arguments and runs every phase, in order (any failure raises
and the script exits non-zero):

1. device  — the card's name and power limit (nvidia-smi), torch/CUDA.
2. build   — compile the CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, in parallel).
3. kernels — each kernel against its plain PyTorch version: kernels 1
   and 3 over every gather × reduce × dtype × mask_inactive the menu
   admits, ragged shapes and NaN inputs; kernel 2 (the block-skipping
   edge block) over the same sweep at R not a multiple of its
   block_rows, with random, all-dead and all-live block flags, exactly
   equal to kernel 1's rows with dead blocks set to the identity; kernel
   4 (the tiled segment reduce) for add/min/max × int32/float32 over
   empty segments, one segment, ragged E, E = 0, E under one tile of
   2,048, runs that end on tile boundaries, an INT_MAX tail that starts
   inside a tile and inside a thread's 8 elements, a 100k-element hub at
   six offsets from a tile boundary (once through pointers off the
   16-byte grid), NaN values, and a hub whose one NaN reaches the output
   only through a carry; the fused push kernel (kernel 3's messages
   fused with the combine) over every gather × push reduce (min, max,
   int32 add) × dtype, touched on and off, NaN, +0 and -0 values, widths
   8 (also off the 16-byte grid), 16, 3 and 1, capacities past the live
   count (C·W ragged), all-PAD rows, an empty frontier and a destination
   receiving over 100k messages in one call, exactly.  Min, max and int32
   exact, float add within ``rtol=1e-5`` (the kernels add in their own
   fixed order, the plain versions in PyTorch's).  Kernel 5 (decode
   attention) over float32/bf16 × h
   in {16, 64, 128, 256} × G in {1, 4, 6, 8, 16} × K in {1, 8} × S in {1,
   33, 100, 4097} × soft-cap in {0, 30} (q scaled by 8 where capped, so
   the cap bites), with row lengths 1, S and random, ``pos = -1`` holes
   in the middle and at the front, NaN in every masked slot, and caches
   read through strides; then over ``DECODE_SPLIT_CASES`` at both
   soft-caps, which stress its split over the sequence (uneven shares,
   shares past ``length`` or wholly masked, ``length`` under one tile a
   split, B·K of 1 and 64, S of 32,768, two groups of query heads, h not
   a multiple of 16) and hold the LM families' decode shapes (gemma3's G
   = 2 at h = 256, recurrentgemma's G = 16 at K = 1, grok's G = 6,
   moonshot's G = 1 at K = 16, whisper's G = 1 at K = 20 and h = 64 over
   448 self slots and 1,500 cross slots); float32
   within ``rtol=1e-4, atol=1e-5`` (``tests/test_kernels.py``'s), bf16
   within ``rtol=1e-2`` (one bf16 rounding is at most 2**-8 of a value)
   plus ``1e-3 * max|out|``, a bound that follows the size of the outputs
   compared.  The lane-axis variant of kernel 1 over every gather ×
   reduce × dtype × mask_inactive, NaN values, k of 1 to 37 lanes (one
   launch per 32) and ids off the 16-byte grid: each lane exactly kernel
   1 alone, and the plain version (float add within 1e-5 of the sum of
   its terms' magnitudes).  2L, both lane kernels with per-lane block
   flags (the counterpart of kernel 2 under ``jax.vmap``), on the fused
   lane sweep's graphs at grids of 128 and 5 rows: on random flags, the
   sub-row kernel = kernel 2 a lane bit for bit and = plain, the fused
   fold = plain bit for bit; on the lanes' touched-derived flags (the
   touched pass, 3L with a one-byte message, = plain) = 1L bit for bit.
   The fused lane sweep (1L with the sub-row fold
   fused in) and the lane push (3L) over every gather x order-free reduce
   (min, max; add on int32) x dtype (x mask_inactive for the sweep) on
   three graphs with hubs whose runs of sub-rows cross block edges, k of
   1, 3, 4, 8, 17, 32 and 33 lanes listed out of order in a state with
   lanes left out, NaN, +0 and -0, int adds that wrap, the push's table
   then shared with a sweep of the other lanes: exactly their plain
   versions.  The streamed engine's routes on 3 pieces of those
   graphs' views (an owner's rows in several pieces): the fused lane
   sweep in accumulate mode on one pre-pass for all pieces equal to the
   unsplit sweep and the plain accumulate, the lane push over the pieces
   with ``got`` equal to the unsplit push and the plain got, and kernel 1
   and the lane kernel on prepared tables equal to their unprepared
   launches, bit for bit.  The streamed float-add fold
   (``edge_block_add_fold_lanes``, ``csrc/stream_fold.cu``) over
   ``ADD_FOLD_CASES``: a run across a tile edge, a hub over 12 tiles,
   one tile, an empty partition, owners absent from the partition, pad
   owners, a view off the 16-byte grid and width 3, at k of 1, 3, 8, 32
   and 33 lanes (K = 1, 4, 8, 32, and two launches) listed out of order,
   every gather x mask_inactive, got on (and for ``copy`` off), NaN and
   +0/-0 values, running tables with +0 and NaN: equal to the route it
   replaced (kernel 1 or the lane kernel on a pre-pass, kernel 4, the
   add) bit for bit, and to its plain version within 1e-5 of each entry's
   sum of |terms| and |red|.  The multi-PE push's shard routes: 3f and 3L
   on each PE's interval of a sharded forward ELL (intervals that start
   mid-graph, empty intervals, vertex 0 on the frontier while padding
   rows exist) against their plain versions, and the PEs' partials
   combined by the reduce-matched collective against the unsharded plain
   push, bit for bit.  The routes that reduce a float min/max through
   torch's own order (the dense pull's sub-row fold and row combines, the
   sparse backend's scatter on pull and push, the streamed general push)
   on a graph sending +0, -0 and ±1 into 1,024 targets, one a hub split
   into max-width rows: equal to a numpy table that settles each tie -0 <
   +0, bit for bit, the -0 and +0 entries counted.
4. analysis — the static analysis tier (``core/analysis.py``): each
   template's and each adversarial program's facts with their provenance
   and codes (templates all ``static``; the evader's apply not
   elementwise and the coincidence gather no menu module, each with
   A002; an untraceable gather, and the coincidence written so that the
   tracer cannot follow it, ``probed`` ``plus_one`` with A001), the cold
   seconds a program (cache cleared) and a cached hit, the process's
   first trace apart.  The coincidence program (``where(v < 100, v + 1,
   v * 2)``, ``plus_one`` on the probe batch), traced and untraceable, on
   a 120-vertex chain under pull, push and auto on the card: equal to a
   numpy replay of the user's function bit for bit (vertex 101 = 200), no
   menu kernel launched (a probed module never reaches the kernels).
   The evader through ``run_batch`` over 8 roots at scale 12: each lane
   equal to its sequential run bitwise, a lane kernel launched, and its
   apply on the whole ``(k, V)`` batch shown to differ from lane by lane.
5. main    — R-MAT at Graph500 scale 22 (edge factor 16, seed 0), BFS
   from root 0 through ``algorithms.bfs`` under pull, push and auto on
   three paths, each held against a numpy level-synchronous BFS, with the
   launch counts set to 0 just before each run and read just after: the
   dense plane (kernel 1 on the pull and fallback supersteps, the fused
   push kernel exactly 4 times on dense auto's compacted push supersteps,
   the message kernel never), the bitmap plane (``pull_sweep=
   'bitmap'``, kernel 2 on its narrow tiers) and the sparse backend
   (``backend='sparse'``, after ``in_degrees`` on CUDA against
   ``np.bincount``); steady run walls of every plane and direction (median
   of 3, in turns), the walls that decide ``pull_sweep='auto'``, device
   reads per run, profiles (dense auto's must hold no
   ``aten::scatter_reduce_``); each kernel held against its plain version
   at the main path's shapes and timed there (CUDA events, median of 20
   or 30 launches after warm-up) beside its bound: kernel 2 on three BFS
   frontiers (the root, the narrow one the plane routes to it, the
   widest), kernels 1 and 2 also by the profiler's device time (pre-pass
   and main kernel), the fused push at the large capacity tier on a
   random frontier and on each compacted superstep's frontier of the BFS
   beside the two-stage path it replaces (message kernel, then
   ``scatter_reduce_``), kernel 4 through ``ops.segment_reduce`` over the
   reverse COO's sorted receiving ids with bfs's messages (its result must
   be the BFS levels; the device time of each of its three launches),
   beside ``scatter_reduce_``.
6. serve   — the graph-query server on the main phase's scale-22 graph:
   ``GraphServer(slots=8, slice_supersteps=4, landmarks=4)`` on CUDA
   (the landmark table: SSSP from 4 landmarks on the graph and its
   transpose through ``run_batch``), a first stream submitted at once
   (64 bfs with 8 duplicates, 16 sssp, 16 dist of which 4 rooted at a
   landmark, 2 ppr; numpy seed 0, roots of out-degree > 0), then 32 bfs
   in 4 bursts between ``step()`` calls, with a snapshot after the second
   burst's step; launch counts set to 0 before the streams and read
   after.  Every bfs/sssp/ppr answer must equal a sequential
   ``translate(...).run(roots=r)`` on the card bitwise, with its
   iterations and ``run_stats`` counters; every dist answer its root's
   SSSP entry, one at least served by the landmark table and one by the
   exact fallback; 4 bfs roots = ``numpy_bfs``, 2 sssp roots ≈ scipy
   Dijkstra; one lane sweep per batched superstep with a masked sweep
   (the fused lane sweep for bfs/sssp/dist, 1L for ppr's float add), one
   lane push per batched superstep with a push lane, kernel 1 alone, the
   single-lane fused push and an order-free reduce's ``subrow_combine``
   never; host reads = one per batched superstep + one per harvest + one
   per snapshot copy;
   the snapshot restored into a new server serves the remaining queries
   bitwise as the first did.  Then queries/s, p50/p99 latency, aggregate
   MTEPS (traversed edges of the bfs answers over the serve wall), ms per
   batched superstep; ``run_batch`` over 8 roots against 8 sequential
   runs; a checkpointed bfs (every 2 supersteps) = the plain run, and one
   killed by an armed ``lane.crash`` and resumed = it too; the lane sweep
   end to end at k = 1, 8 and 32 on a 50% random frontier and on root 0's
   BFS frontiers: the fused sweep against 1L + ``subrow_combine`` (and
   its plain version), exactly, timed (CUDA events and the profiler's
   device time) beside 1L alone, k launches of kernel 1 and its bound;
   the lane push at k = 1, 8 and 32 on root 0's BFS frontiers and a
   random 1% frontier against k compactions + fused pushes (and its plain
   version), exactly, timed beside them, its bound and the first design's
   one 32-byte sector a message.
7. serve_bitmap — the graph server on the bitmap plane's lane axis (2L),
   on the main phase's scale-22 graph and pull plan, with [serve]'s
   landmark table (the same exact SSSP distances from the same 4
   landmarks): ``GraphServer(slots=8, slice_supersteps=4)`` under
   ``ScheduleConfig(pull_sweep='bitmap')`` and again under
   ``direction=pull`` (auto pushes every frontier narrow enough for the
   plane's narrow tiers at this scale, so 2L runs on the pull server),
   each serving 34 queries (16 bfs and 4 repeats, 6 sssp, 6 dist of which
   3 rooted at a landmark, 2 ppr; numpy seed 5), launch counts set to 0
   before the stream and read after: every answer = a sequential run on
   the same schedule bitwise (values, iters and every ``run_stats``
   counter, the swept and skipped blocks included), the bfs from root 0
   = the main phase's numpy_bfs;
   single-lane kernel 2, kernel 1 alone and the single-lane fused push
   never; one touched pass a 2L launch, 2L on the pull server at least
   once, the fused fold for every other masked sweep, 1L for ppr's, 3L
   for every batched push; one host read a batched superstep (+ one a
   harvest); queries/s and ms a batched superstep beside [serve]'s dense
   ones.  Then at k = 1, 8 and 32 on root 0's BFS frontiers, random
   narrow frontiers and a random 1% frontier a lane: 2L on touched flags
   = its plain version and 1L bit for bit, the touched pass = its plain
   version; the batched bitmap superstep = k single-lane bitmap
   supersteps (values, frontiers, counters) = the dense batched
   superstep; 2L, 1L, the touched pass and 2L's flags pass and pre-pass
   timed (CUDA events, the profiler's device time) beside 2L's plain
   version and bound, and the
   three routes on the BFS and narrow sets (on the 1% sets every lane is
   past the tiers: the route is 1L's).
8. stream  — out-of-core streaming on the main phase's scale-22 graph
   with ``ScheduleConfig(partitions=8)`` (the plan's partition count and
   the store's rows and entry bytes printed): BFS from root 0 under pull,
   push and auto equal to the resident dense run on the card (values,
   iters; push/pull superstep counts) and to ``numpy_bfs``, every
   ``run_stats`` counter equal to a numpy replay of the stream's
   accounting from the oracle's levels, swept + skipped = partitions ×
   supersteps, launches of the fused lane sweep in accumulate mode = swept
   pull partitions and of the lane push = swept push partitions, one
   pre-pass a superstep, no kernel 1, fused push or ``segment_reduce``
   launch, one device read a superstep, and a profile of the auto run
   with no ``scatter_reduce``/``index_reduce`` and no fused push kernel;
   ``torch.cuda.max_memory_allocated`` of the streamed run below the
   resident dense runs'; steady walls (median of 3, in turns), MTEPS,
   bytes a run and a superstep, transfer / compute / wall and
   ``overlap_efficiency``, the copies' H2D rate against a plain pinned
   ``copy_`` of the largest entry; ``run_batch`` over 8 roots = the
   resident ``run_batch``; a checkpointed auto BFS (every 8 sweeps) =
   uncut, and one killed by ``lane.crash`` at a partition boundary and
   resumed = uncut; ``GraphServer`` on the streamed schedule serving 16
   bfs (numpy seed 0) = sequential resident runs bitwise with bytes
   streamed; each streamed route timed per partition (CUDA events)
   against its plain version and byte bound: the fold in accumulate mode
   and its pre-pass (each also by the profiler's device time), the lane
   push with got (table and got against the plain version; timed from a
   refilled table and cleared got, as a superstep finds them, with the
   profiler's device time, with got and with got null, and the most
   messages one destination receives) and its pre-pass, and (scale 20,
   pagerank) the fused float-add fold against its plain version (rtol
   1e-5) and the route it replaced (kernel 1 on prepared tables, kernel 4,
   the add; bit for bit), both timed with the wrappers' host time and by
   the profiler's device time, beside a CSR product and the byte bound
   (and the old reckoning, which wrote a (V,) partial).  Weighted
   gathers outside the menu on the scale-22 graph with uniform(0.5, 2)
   weights (numpy seed 4) through the general partial: ``v + 2 * w``
   under min (pull, push, auto) bitwise equal to the resident run of the
   same program on the card, and ``v * w + 1`` under add (5 iterations,
   pull) within ``rtol=1e-5`` of the resident run and of a float64 replay
   of the program, two streamed runs and two resident runs bitwise
   equal, iterations equal, kernel 4 launched once a
   swept pull partition and no lane kernel; kernel 4 on the route timed
   (largest pull partition) against its plain version, ``scatter_reduce_``
   and its byte bound.  At scale
   20: SSSP streamed = resident bitwise, PageRank (20 iterations) within
   ``rtol=1e-5`` of the resident run and bitwise equal across two
   streamed runs with one fused float-add fold launch a swept partition,
   one lane pre-pass a superstep and no kernel 1, lane kernel, kernel 1
   pre-pass, kernel 4 or fused lane sweep launch, and a container from
   ``data.graphs.container_from_graph`` under a
   ``partition_budget_bytes`` that forces evictions = the resident BFS.
9. multi_pe — a PE group of repeated devices (``devices=[cuda:0] * p``)
   on the main phase's scale-22 graph: dense BFS from root 0 under push
   and auto at p = 1, 2 and 4 (the sharded push: kernel 3f a PE on its
   forward-ELL interval, the collective, kernel 1 on the replicated
   fallback), each equal to ``numpy_bfs`` and to p = 1 bitwise, its
   ``run_stats`` equal to p = 1's but for the multi-PE fields (and the
   CUDA graphs' engagement, which p = 1 alone has), and those
   (each PE's live rows, the compacted/fallback split, the exchanges and
   their bytes) equal to a numpy replay from the oracle's levels and the
   JAX package's byte formulas; 3f launches = compacted supersteps ×
   non-empty intervals; steady walls at p = 1, 2, 4 (median of 3, in
   turns); each collective (``pmin`` at p = 2 and 4, ``psum``,
   ``quantized_psum``, ``bitmap_or``) timed on V-entry tables; the
   ``comm.collective`` fault armed (typed error) then disarmed (= the
   clean run); ``run_batch`` over 8 roots at p = 2 = 8 sequential p = 2
   runs (3L launches = batched pushes × intervals); a ``GraphServer`` at
   p = 2 serving 16 bfs = sequential runs bitwise; the sparse BFS at p =
   2 (the pull exchange) = p = 1 with the exchange counters; 3f and 3L
   on PE 0's interval timed beside their plain versions and bounds.  At
   scale 20: SSSP and WCC at p = 2 = p = 1 bitwise, sparse PageRank at p
   = 2 within ``rtol=1e-5`` of p = 1 and with the int8 exchange within
   the JAX package's bound ``d/(1-d) · p · max|r|/127 + 1e-6``.
10. others — at scale 20: SSSP on both pull planes (push == pull exactly,
   ≈ scipy Dijkstra), WCC on both (push == pull, = min vertex id per weak
   component, scipy), PageRank (20 iterations, rtol 1e-4 of a scipy power
   iteration), ``k_core(k=4)`` (= a numpy peel).
11. lm     — the LM serving path at full width: ``launch.serve.main``
   through qwen3-8b (all 36 layers and widths, bf16, weights from
   ``torch.Generator`` seed 0), 8 slots at capacity 4096, 16 requests
   with prompts of 256–2048 tokens (numpy seed 0), 64 new tokens each;
   prefill seconds per request, ms per decode step and tokens/s beside
   the step's byte bound, host syncs per step (counted by CUDA's sync
   debug mode; must be 1, the token read),
   kernel 5's launches (must be 36 per decode step) and a profile of one
   steady step.  Then decode ≡ full forward in float32 at full width
   (each decode step's logits against ``logits_seq``, which never
   reaches kernel 5; max |Δ| / max |logit| <= 1e-3), the server's
   prefill and decode step on a 4,608-token prompt (prefilled in two
   chunks) against ``logits_seq`` and on a ring that wraps mid-decode
   against the full forward under the ring's window (same bound), and
   kernel 5 held
   against its plain version on one layer's inputs of a mid-run step (in
   bf16 as served and cast to float32) and timed there and on one
   32,768-slot sequence (CUDA events, and the profiler's device time of
   its split and combine kernels), beside its bound, its plain version
   and ``scaled_dot_product_attention``.
12. lm_families — the decoder-only families at full width and depth, one
   model at a time (freed before the next), bf16, weights from
   ``torch.Generator`` seed 0: gemma3-4b, recurrentgemma-9b,
   falcon-mamba-7b and moonshot-v1-16b-a3b through ``launch.serve.main``
   (4 slots × 2048, 8 requests with prompts of 256–1536 tokens, numpy
   seed 0, 32 new tokens each): prefill s a request, ms a decode step,
   tokens/s, the step's byte bound (weights + valid KV and state at 3.35
   TB/s; for moonshot also over only the experts the step's tokens reach,
   beside the served step, which computes every expert at capacity as the
   reference does), host syncs a step (must be 1), kernel 5 launches a
   step (must be the model's attention layers: 34, 12, 0, 48), peak
   device memory beside the weights' bytes and a profiled steady step.
   Decode ≡ full forward in float32 (max |Δ| / max |logit| <= 1e-3) at
   full depth for gemma3, recurrentgemma and falcon-mamba, and at 8 of
   moonshot's 48 layers with a capacity factor of E / k (asserted at
   least E / k, so no token is dropped); gemma3's local rings wrapping
   mid-decode and a prompt past its ``prefill_chunk``, through the
   server's functions; grok-1-314b at smoke size with its soft-cap
   reaching kernel 5 (every launch soft-capped).  Kernel 5 soft-capped
   (30) at grok's attention shape (B 8, S 4096, K 8, G 6, h 128, bf16)
   held against its plain version and timed beside its bound, the plain
   version, the uncapped kernel and the library call (``flex_attention``
   with a capping, masking ``score_mod``; sdpa takes no soft-cap); the
   SSM prefill scan at falcon-mamba's longest prompt beside its bound.
13. whisper — whisper-large-v3 at full width and depth (32 decoder + 32
   encoder layers, d_model 1280, 20 heads, vocab 51,866, bf16, weights
   from ``torch.Generator`` seed 0, learned position tables of 1,500
   rows, which encoding 1,500 frames needs) through the model's
   conditioned path: 4 slots of 448, ``build_cross_caches`` from 1,500
   bf16 frame embeddings a slot (seed 1), one prompt of 4–16 tokens a
   slot (numpy seed 0), 64 greedy decode steps.  Encoder + cross-cache
   seconds a request, prefill seconds, ms a decode step, tokens/s, host
   syncs a step (must be 1), kernel 5 launches a step (must be 64: 32
   self, 32 cross, each half counted where it launches), peak memory,
   the step's byte bound (the decoder weights a step reads, valid self
   KV and the cross caches at 3.35 TB/s) and a
   profiled step; kernel 5 at both of whisper's shapes on layer 17's
   inputs of step 32, against its plain version and timed beside its
   bound, the plain version and sdpa; decode ≡ full forward in float32
   at full depth (``logits_seq`` with the encoder inputs, max |Δ| / max
   |logit| <= 1e-3); and ``launch.serve.main --arch whisper-large-v3``
   (the reference's scheduler, which builds no cross caches) serving 8
   requests with one sync and 32 kernel 5 launches a step.
14. train — whisper-large-v3 trained at full width and depth: bf16
   parameters, float32 AdamW states, ``cfg.remat``, batch 8 × 448 tokens
   with 448 float32 encoder frames (``synth_batch``), 4 sequences a
   microbatch, 8 steps on one repeated batch: loss, grad norm and lr a
   step (finite, the last loss below the first), seconds a step,
   tokens/s, peak memory, dtypes and shapes kept, and the step's useful
   operations against the dense bf16 peak; ``launch.train.main`` at full
   width for 2 steps of the pipeline's batches; at full width over 2 + 2
   layers, ``save`` then ``restore_latest`` of the parameters and AdamW
   state bit for bit and a resumed model's next loss equal to the
   uninterrupted one's (rtol 1e-6); one float32 step at smoke size equal
   to the same step on the CPU (loss and grad norm rtol 1e-5; AdamW's m
   and v, which hold the gradients, within 1e-4 and 2e-4 of each leaf's
   largest; every parameter AdamW's step from the card's own m and v
   within rtol 2e-5 + 1e-3 · lr, and the CPU's within rtol 2e-5 + 2e-2 ·
   lr wherever the gradient is not within rounding of 0).

15. plan  — the planning layer (``launch/dryrun.py``): the dry run of
   the 10 archs × 4 shapes on the (16, 16) production mesh with the
   roofline and on (2, 16, 16) without, on ``meta`` tensors in 6 worker
   processes, the archs shared out (each cell's status, live GB a
   device, ``fits_80gb``, the three roofline terms and the dominant one;
   no error, no worker that initialized CUDA, and
   ``torch.cuda.memory_allocated`` the same before and after); the
   planner on a (1, 1) mesh of the card at the [lm] and [train] shapes
   (qwen3-8b decode, 8 slots of 4,096; whisper-large-v3 training, 8 ×
   448, 4 sequences a microbatch): its argument bytes equal, part by part
   and byte for byte, to the parameters, caches or optimizer state and
   batch those phases held, its live bytes beside their measured peaks
   and its roofline beside their measured steps (and qwen3's hand bound
   of 4.934 ms); the expert-parallel MoE at moonshot-v1-16b-a3b's full
   width (E 64, D 2048, top-6) on 4 × 256 tokens over a (1, 4) mesh of
   the card repeated, through ``apply_moe_auto``, against ``apply_moe``:
   in float32 within 1e-5 of max |out|, in bf16 no farther from the
   float32 result than twice the gather path's own bf16 distance, aux
   within 1e-6, both timed in bf16 and the psum's bytes read from the
   mesh's ``CommManager``; the 2 + 2-layer whisper tree (parameters and AdamW
   state after a step) sharded over a (4, 2) mesh of the card repeated,
   saved, restored onto (2, 2) with ``shardings=`` and joined by
   ``unshard``, bit for bit.

The line before the last is the per-kernel JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Longer logs go to ``chiprun_out/``
(``chip_smoke.log`` keeps every line the phases print).
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
INT_MAX = 2**30
INT32_MAX = 2**31 - 1       # the min reduce's identity on int32
SCALE = 22          # the main path's R-MAT (Graph500 scale, edge factor 16)
OTHERS_SCALE = 20   # SSSP, WCC and PageRank against scipy
# The LM serving path: the server's flags, the (decode step, layer) whose
# kernel 5 inputs are kept, and the decode ≡ full forward check's shape
LM_SERVE = dict(arch="qwen3-8b", slots=8, capacity=4096, requests=16,
                min_prompt=256, max_prompt=2048, max_new=64, seed=0,
                device="cuda")
LM_KEEP = (32, 17)
LM_EQUIV = (2, 32, 16)      # prompts, prefilled tokens, decode steps
# (prompt, cache capacity, decode steps) of the served long paths: a
# prompt past prefill_chunk = 4096 (chunks of 4,096 and 512), no wrap; and a
# ring that wraps at the 33rd decode step
LM_CHUNKED = (4608, 4608 + 16, 16)
LM_RING = (480, 512, 64)
LONG_SHAPE = (1, 32768, 8, 4, 128)      # B, S, K, G, h of one long row
# The decoder-only families at full width and depth, one at a time: the
# server's flags (capacity 2048 fits moonshot's 55.5 GB of weights too),
# decode ≡ full forward's prompts, prefilled tokens and decode steps (a
# MoE model at 8 of its layers: float32 at full depth does not fit), and
# gemma3's served long paths: a prompt just under its 1,024 window whose
# decode steps wrap the local rings, and one past prefill_chunk = 1,024
LM_FAMILIES = ("gemma3-4b", "recurrentgemma-9b", "falcon-mamba-7b",
               "moonshot-v1-16b-a3b")
LM_FAMILY_SERVE = dict(slots=4, capacity=2048, requests=8, min_prompt=256,
                       max_prompt=1536, max_new=32, seed=0, device="cuda")
LM_FAMILY_EQUIV = (2, 32, 16)
LM_MOE_EQUIV_LAYERS = 8
LM_GEMMA_PATHS = (("local_ring_wrap", (1000, 2048, 64), False),
                  ("chunked_prefill", (1536, 2048, 8), False))
GROK_SHAPE = (8, 4096, 8, 6, 128)   # B, S, K, G, h of grok's decode step
GROK_SOFTCAP = 30.0
SCAN_SHAPE = (1, 1536, 8192, 16)    # falcon-mamba's scan, longest prompt

# The H100 SXM's peak rates (NVIDIA data sheet), which the bounds assume:
# device-memory bandwidth, and the scalar (non-tensor-core) float32 rate,
# also used for int32 ops.
CARD = "H100 80GB HBM3"
_BANDWIDTH = 3.35e12
_SCALAR_OPS = 67e12


def log(*a):
    """Print, and keep the line in ``chiprun_out/chip_smoke.log``, so
    that every line survives where only the end of the output is kept."""
    print(*a, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.log"), "a") as f:
        print(*a, file=f)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    os.makedirs(OUT_DIR, exist_ok=True)
    open(os.path.join(OUT_DIR, "chip_smoke.log"), "w").close()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    if CARD not in name:
        raise SystemExit(f"chip_smoke: the bounds assume an {CARD}, not "
                         f"{name!r}")
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"count {torch.cuda.device_count()} bandwidth_bound "
        f"{_BANDWIDTH:.3g} B/s")
    return {"smi": smi, "name": name}


def phase_build():
    from repro_torch.kernels import _build
    info = _build.build(ptxas_verbose=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name, text in info["ptxas"].items():
            f.write(f"== {name}\n{text}\n")
    lines = [ln.strip() for text in info["ptxas"].values()
             for ln in text.splitlines()]
    regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines
            if "registers" in ln and "Used " in ln]
    spills = sorted({ln.split(":")[-1].strip() for ln in lines
                     if "spill" in ln})
    log(f"[build] built {info['built']} in {info['seconds']:.2f} s: "
        f"{len(regs)} kernel instantiations, at most {max(regs or [0])} "
        f"registers a thread; spill lines {spills}")
    return info


def _same(a, b):
    """Exact agreement, NaN equal to NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        return bool(((a == b) | (a.isnan() & b.isnan())).all())
    return bool((a == b).all())


def _bits(a):
    """A float tensor's bit patterns as int32, every NaN as one pattern;
    other tensors as they are."""
    if not a.dtype.is_floating_point:
        return a
    import torch
    return torch.where(a.isnan(), torch.full_like(a, float("nan")),
                       a).view(torch.int32)


def _same_bits(a, b):
    """Exact agreement of the bit patterns (+0 is not -0), NaN equal to
    NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return bool((_bits(a) == _bits(b)).all())


def _same_bits_np(a, b):
    """:func:`_same_bits` for host arrays and scalars."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.kind == "f":
        a, b = (np.where(np.isnan(x), np.nan, x).astype(x.dtype).view(
            f"i{x.dtype.itemsize}") for x in (a, b))
    return bool(np.array_equal(a, b))


def _close(a, b, rtol=1e-5, atol=1e-6):
    """``|a - b| <= atol + rtol |b|`` elementwise; equal infs and NaNs
    agree."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    near = (a - b).abs() <= atol + rtol * b.abs()
    return bool((near | (a == b) | (a.isnan() & b.isnan())).all())


def _max_err(a, b):
    """Largest |a - b|, equal entries (infinities, NaN with NaN) at 0."""
    if a.dtype.is_floating_point:
        ok = ~((a.isnan() & b.isnan()) | (a == b))
        d = (a[ok].double() - b[ok].double()).abs()
        return float(d.max()) if d.numel() else 0.0
    return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0


def _segment_cases(rng, tile):
    """Kernel 4's sweep cases ``(label, seg, S, nan_index)`` at its real
    tile of ``tile`` elements: empty segments, one segment, ragged E, E = 0,
    E under a tile, runs that end on tile boundaries, an INT_MAX tail that
    starts inside a tile and inside a thread's 8 elements, a 100k-element
    hub at several offsets from a tile boundary, and a hub whose only NaN
    sits in its first tile (it reaches the output only through a carry;
    ``nan_index`` is its index, else None and random NaN)."""
    int_max = 2**31 - 1
    cases = []
    for E, S, tail, hub in ((1000, 97, 0, 0), (5000, 1, 0, 0),
                            (12345, 30011, 7, 0), (1, 5, 3, 0),
                            (20000, 1000, 0, 100_000)):
        seg = rng.integers(0, S, E)
        if hub:
            seg = np.concatenate([seg, np.full(hub, S // 3)])
        seg = np.concatenate([np.sort(seg), np.full(tail, int_max)])
        cases.append((f"E={E} S={S} tail={tail} hub={hub}", seg, S, None))
    cases.append(("E=0", np.zeros(0, np.int64), 10, None))
    cases.append(("E under a tile", np.sort(rng.integers(0, 50, tile // 3)),
                  50, None))
    lengths = [tile, tile - 1, 1, 2 * tile, 5, tile - 5, 3 * tile, 17]
    cases.append(("runs ending on tile boundaries",
                  np.repeat(np.arange(0, 3 * len(lengths), 3), lengths),
                  3 * len(lengths), None))
    n_valid = 3 * tile + 1237
    cases.append(("INT_MAX tail from inside a tile",
                  np.concatenate([np.sort(rng.integers(0, 4000, n_valid)),
                                  np.full(3000, int_max)]), 4000, None))
    # a hub after `off` elements of about 4 a segment, then short ones
    # (short segments keep the float sums away from cancellation, where
    # two summation orders part by more than rtol 1e-5)
    for off in (0, 1, 7, tile - 1, tile + 3, 5 * tile // 2):
        p = max(off // 4, 1)
        seg = np.concatenate([np.sort(rng.integers(0, p, off)),
                              np.full(100_000, p),
                              np.sort(rng.integers(p + 1, p + 2000, 7777))])
        cases.append((f"100k hub at offset {off}", seg, p + 2000, None))
    off = 3 * tile + 100
    p = off // 4
    seg = np.concatenate([np.sort(rng.integers(0, p, off)),
                          np.full(20 * tile, p),
                          np.sort(rng.integers(p + 1, p + 100, 333))])
    cases.append(("NaN only through a carry", seg, p + 100, off + 5))
    return cases


def _check_segment_kernel(torch, rng):
    """Kernel 4 against its plain version: add/min/max × int32/float32
    over ``_segment_cases``, and the first case with a hub again through
    pointers not 16-byte aligned (its scalar-load path)."""
    from repro_torch.kernels import segment_sum as ss
    dev = torch.device("cuda")
    checked, worst = 0, 0.0
    for label, seg, S, nan_at in _segment_cases(rng, ss.TILE):
        seg = seg.astype(np.int32)
        n = len(seg)
        for dtype in (np.int32, np.float32):
            val = (rng.integers(-1000, 1000, n) if dtype == np.int32
                   else rng.uniform(-5, 5, n)).astype(dtype)
            if dtype == np.float32 and n:
                if nan_at is None:
                    val[rng.integers(0, n, max(n // 50, 1))] = np.nan
                else:
                    val[nan_at] = np.nan
            ts, tv = (torch.as_tensor(a).to(dev) for a in (seg, val))
            views = [(ts, tv)]
            if "hub" in label and "offset 1" in label:
                # one element in: contiguous, but off the 16-byte grid
                bs = torch.cat([ts[:1], ts])
                bv = torch.cat([tv[:1], tv])
                views.append((bs[1:], bv[1:]))
            for vs, vv in views:
                for reduce in ("add", "min", "max"):
                    got = ss.segment_reduce(vs, vv, S, reduce=reduce)
                    want = ss.segment_reduce_ref(vs, vv, S, reduce=reduce)
                    torch.cuda.synchronize()
                    exact = not (dtype == np.float32 and reduce == "add")
                    if not (_same if exact else _close)(got, want):
                        raise AssertionError(
                            f"segment_reduce {reduce}/{dtype.__name__} "
                            f"{label} (aligned "
                            f"{vv.data_ptr() % 16 == 0}): max err "
                            f"{_max_err(got, want)}")
                    if nan_at is not None and dtype == np.float32 \
                            and not bool(got[int(seg[nan_at])].isnan()):
                        raise AssertionError(f"segment_reduce {reduce} "
                                             f"{label}: the NaN was lost")
                    worst = max(worst, _max_err(got, want))
                    checked += 1
    log(f"[kernels] segment_reduce: {checked} cases agree (tile "
        f"{ss.TILE} elements), max abs err {worst}")
    return checked, worst


def _check_fused_push(torch, rng):
    """The fused push kernel against its plain version, exactly: every
    gather × push reduce (min, max; add on int32) × dtype, float values
    with NaN, +0 and -0, touched on and off, over widths 8 (and rows off
    the 16-byte grid), 16, 3 and 1, capacities past the live count (C·W
    ragged), all-PAD rows, an empty frontier, and a destination receiving
    over 100k messages in one call."""
    from repro_torch.kernels import push_ell as pe
    from repro_torch.kernels.ref import GATHER_OPS, PAD, REDUCE_OPS, _identity
    dev = torch.device("cuda")
    checked, hub_msgs, worst = 0, 0, 0.0
    # (R, W, V, capacity, share of slots sent to vertex 1, frontier)
    cases = ((1037, 8, 4099, 1100, 0.0, "random"),
             (1037, 8, 4099, 1100, 0.0, "unaligned"),
             (300, 16, 97, 301, 0.1, "random"),
             (77, 3, 50, 100, 0.0, "all"),
             (5, 1, 7, 8, 0.0, "random"),
             (64, 8, 33, 64, 0.0, "empty"),
             (25000, 8, 5000, 25000, 0.7, "all"))
    for R, W, V, cap, hub, front in cases:
        row_src = np.sort(rng.integers(0, V, R)).astype(np.int32)
        dst = rng.integers(0, V, (R, W)).astype(np.int32)
        dst[rng.random((R, W)) < hub] = 1
        dst[rng.random((R, W)) < 0.2] = PAD
        dst[:2] = PAD                                  # all-PAD rows
        wgt = rng.uniform(0, 4, (R, W)).astype(np.float32)
        deg = rng.integers(0, 9, V).astype(np.int32)
        act = (np.ones(V, bool) if front == "all" else
               np.zeros(V, bool) if front == "empty" else
               rng.random(V) < 0.5)
        t_src, t_dst, t_wgt, t_deg = (torch.as_tensor(a).to(dev)
                                      for a in (row_src, dst, wgt, deg))
        if front == "unaligned":       # rows one word off the 16-byte grid
            t_dst = torch.cat([t_dst.reshape(-1)[:1],
                               t_dst.reshape(-1)])[1:].view(R, W)
            t_wgt = torch.cat([t_wgt.reshape(-1)[:1],
                               t_wgt.reshape(-1)])[1:].view(R, W)
        live = torch.as_tensor(act[row_src]).to(dev)
        sel, ok = pe.compact_rows(live, R, cap)
        if hub:
            hub_msgs = max(hub_msgs, int((t_dst[sel[ok].long()] == 1).sum()))
        for dtype in (np.int32, np.float32):
            vals = (rng.integers(-50, 50, V) if dtype == np.int32
                    else rng.uniform(-5, 5, V)).astype(dtype)
            if dtype == np.float32:
                vals[rng.integers(0, V, max(V // 10, 1))] = np.nan
                vals[rng.integers(0, V, max(V // 10, 1))] = 0.0
                vals[rng.integers(0, V, max(V // 10, 1))] = -0.0
            t_val = torch.as_tensor(vals).to(dev)
            for gather in GATHER_OPS:
                if gather == "div_deg" and dtype == np.int32:
                    continue
                for reduce in REDUCE_OPS:
                    if reduce == "add" and dtype == np.float32:
                        continue
                    for touched in (False, True):
                        kw = dict(gather=gather, reduce=reduce,
                                  identity=_identity(reduce, t_val.dtype),
                                  num_vertices=V, dtype=t_val.dtype,
                                  emit_touched=touched)
                        args = (sel, ok, t_src, t_dst, t_wgt, t_val, t_deg)
                        got = pe.push_ell_fused_reduce(*args, **kw)
                        want = pe.push_ell_fused_reduce_plain(*args, **kw)
                        torch.cuda.synchronize()
                        if not (_same(got[0], want[0]) and (
                                not touched or _same(got[1], want[1]))):
                            raise AssertionError(
                                f"push_ell_fused {gather}/{reduce}/"
                                f"{dtype.__name__} touched={touched} R={R} "
                                f"W={W} V={V} C={cap} {front}: max err "
                                f"{_max_err(got[0], want[0])}")
                        worst = max(worst, _max_err(got[0], want[0]))
                        checked += 1
    if hub_msgs < 100_000:
        raise AssertionError(f"the hub case sent only {hub_msgs} messages")
    log(f"[kernels] push_ell_fused: {checked} cases equal the plain version "
        f"(a hub received {hub_msgs} messages in one call)")
    return checked, worst


def _decode_case(torch, gen, B, S, K, G, h, dtype, strided):
    """Kernel 5's inputs: row lengths 1, S and random, ``pos = -1`` holes
    in the middle of row 2 and over the front of row 3 (its first two
    tiles wholly masked when it is long enough), NaN in k and v at every
    masked slot.  ``strided`` reads the caches as two halves of one
    ``(B, S, 2, K, h)`` buffer.  Returns the inputs and the valid mask."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(B * S + K * G + h)
    lengths = [1, S] + [int(x) for x in rng.integers(1, S + 1, B - 2)]
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    slots = torch.arange(S, device=dev)
    pos = torch.where(slots[None] < length[:, None], slots[None], -1)
    n2, n3 = lengths[2], lengths[3]
    holes = slots[n2 // 4:(3 * n2) // 4]
    pos[2, holes[torch.as_tensor(rng.random(holes.numel()) < 0.5,
                                 device=dev)]] = -1
    pos[3, :min(n3 - 1, 133)] = -1
    pos = pos.to(torch.int32).contiguous()
    q = torch.randn((B, K, G, h), generator=gen, device=dev).to(dtype)
    if strided:
        kv = torch.randn((B, S, 2, K, h), generator=gen, device=dev).to(dtype)
        kc, vc = kv[:, :, 0], kv[:, :, 1]
    else:
        kc, vc = (torch.randn((B, S, K, h), generator=gen,
                              device=dev).to(dtype) for _ in range(2))
    valid = (slots[None] < length[:, None]) & (pos >= 0)
    kc[~valid] = float("nan")
    vc[~valid] = float("nan")
    return (q, kc, vc, pos, length), valid


def _decode_agrees(got, want, bf16):
    """Kernel 5's output against its plain version's (float32 copies):
    finite, and within ``rtol=1e-4, atol=1e-5`` for float32 inputs or,
    for bf16, ``rtol=1e-2`` (each side is rounded to bf16 once, at most
    2**-8 of the value) plus ``1e-3 * max|want|``.  Returns whether they
    agree, the max abs error and max |want|."""
    scale = float(want.abs().max()) if want.numel() else 0.0
    tol = (dict(rtol=1e-2, atol=1e-3 * scale) if bf16
           else dict(rtol=1e-4, atol=1e-5))
    ok = bool(got.isfinite().all()) and _close(got, want, **tol)
    return ok, _max_err(got, want), scale


# kernel 5's soft-caps (grok's 30) and the query scale that makes the cap
# bite: scores of ~8 sigma
DECODE_SOFTCAPS = (0.0, 30.0)
SOFTCAP_Q_SCALE = 8.0


def _capped(args, softcap):
    """Kernel 5's inputs with q scaled up where a soft-cap is checked."""
    return ((args[0] * SOFTCAP_Q_SCALE,) + tuple(args[1:])) if softcap \
        else args


def _check_decode_kernel(torch):
    """Kernel 5 against its plain version over dtype × h × G × K × S ×
    soft-cap (``_decode_case``'s rows); compared on rows with a valid
    slot."""
    from repro_torch.kernels import decode_gqa as dg
    from repro_torch.kernels.ref import decode_gqa_ref
    gen = torch.Generator(device="cuda").manual_seed(5)
    checked, worst, worst_rel = 0, 0.0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for h in (16, 64, 128, 256):
            for G in (1, 4, 6, 8, 16):
                for K in (1, 8):
                    for S in (1, 33, 100, 4097):
                        args, valid = _decode_case(torch, gen, 4, S, K, G, h,
                                                   dtype, checked % 2 == 1)
                        for cap in DECODE_SOFTCAPS:
                            a = _capped(args, cap)
                            got = dg.decode_gqa(*a, softcap=cap)
                            want = decode_gqa_ref(*a, softcap=cap)
                            torch.cuda.synchronize()
                            rows = valid.any(1)
                            ok, err, scale = _decode_agrees(
                                got[rows].float(), want[rows].float(),
                                dtype == torch.bfloat16)
                            if not ok:
                                raise AssertionError(
                                    f"decode_gqa {dtype} h={h} G={G} K={K} "
                                    f"S={S} softcap={cap}: max err {err}, "
                                    f"max |out| {scale}")
                            worst = max(worst, err)
                            worst_rel = max(worst_rel,
                                            err / max(scale, 1e-30))
                            checked += 1
    log(f"[kernels] decode_gqa: {checked} cases (soft-cap "
        f"{DECODE_SOFTCAPS}), max abs err {worst}, max err / max |out| of "
        f"a case {worst_rel:.3e}")
    return checked, worst


# Kernel 5's split-stress cases: (B, S, K, G, h, row lengths); each row
# also gets pos = -1 holes (its first half wholly masked where it is long)
# and NaN in every masked slot
DECODE_SPLIT_CASES = (
    (1, 32768, 1, 8, 128, (32768,)),         # B·K = 1, 264 splits
    (1, 32768, 1, 4, 128, (777,)),           # most splits past length
    (1, 32768, 8, 4, 128, (32768,)),         # the long row, 33 splits
    (8, 4096, 8, 4, 128, (4096, 1, 65, 1000, 2049, 3000, 17, 4095)),
    (2, 4096, 4, 4, 128, (5, 70)),           # length < one tile a split
    (2, 1000, 2, 12, 64, (999, 1000)),       # two groups of query heads
    (3, 300, 2, 4, 24, (300, 150, 33)),      # h not a multiple of 16
    (2, 500, 3, 3, 8, (500, 250)),
    (2, 2048, 1, 8, 256, (2048, 1500)),      # h = 256
    # the LM families' decode shapes (the local rings' 1,024 and 2,048)
    (4, 2048, 4, 2, 256, (2048, 1024, 77, 1)),       # gemma3: G = 2
    (4, 2048, 1, 16, 256, (2048, 1500, 3, 900)),     # recurrentgemma: G 16
    (8, 4096, 8, 6, 128, (4096, 1, 65, 1000, 2049, 3000, 17, 4095)),  # grok
    (4, 2048, 16, 1, 128, (2048, 300, 1, 1999)),     # moonshot: G = 1
    # whisper-large-v3's decode shapes, G = 1 at K = 20, h = 64: the self
    # rings of 448 slots, and the cross caches of 1,500 encoder frames (a
    # tile of 64 slots does not divide 1,500; served, every slot is valid)
    (4, 448, 20, 1, 64, (448, 300, 17, 1)),
    (4, 1500, 20, 1, 64, (1500, 1500, 1500, 1500)),
)


def _split_case(torch, gen, B, S, K, G, h, dtype, lengths):
    """Kernel 5's inputs for a split-stress case: the given row lengths,
    random pos = -1 holes (5%), row 0's first half masked where it holds
    more than 128 slots, NaN in k and v at every masked slot."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(B * S + K * G + h)
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    slots = torch.arange(S, device=dev)
    pos = torch.where(slots[None] < length[:, None], slots[None], -1)
    holes = torch.as_tensor(rng.random((B, S)) < 0.05, device=dev)
    pos[holes & (slots[None] > 0)] = -1
    if lengths[0] > 128:
        pos[0, :lengths[0] // 2] = -1
    pos = pos.to(torch.int32).contiguous()
    q = torch.randn((B, K, G, h), generator=gen, device=dev).to(dtype)
    kc, vc = (torch.randn((B, S, K, h), generator=gen, device=dev).to(dtype)
              for _ in range(2))
    valid = (slots[None] < length[:, None]) & (pos >= 0)
    kc[~valid] = float("nan")
    vc[~valid] = float("nan")
    return (q, kc, vc, pos, length), valid


def _check_decode_splits(torch):
    """Kernel 5 against its plain version on ``DECODE_SPLIT_CASES`` in
    float32 and bf16 at each soft-cap, each case's splits printed."""
    from repro_torch.kernels import decode_gqa as dg
    from repro_torch.kernels.ref import decode_gqa_ref
    gen = torch.Generator(device="cuda").manual_seed(6)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    checked, worst, plans = 0, 0.0, []
    for B, S, K, G, h, lengths in DECODE_SPLIT_CASES:
        for dtype, cap in ((d, c) for d in (torch.float32, torch.bfloat16)
                           for c in DECODE_SOFTCAPS):
            args, valid = _split_case(torch, gen, B, S, K, G, h, dtype,
                                      lengths)
            args = _capped(args, cap)
            got = dg.decode_gqa(*args, softcap=cap)
            want = decode_gqa_ref(*args, softcap=cap)
            torch.cuda.synchronize()
            rows = valid.any(1)
            ok, err, scale = _decode_agrees(got[rows].float(),
                                            want[rows].float(),
                                            dtype == torch.bfloat16)
            if not ok:
                raise AssertionError(
                    f"decode_gqa split case {dtype} B={B} S={S} K={K} G={G} "
                    f"h={h} lengths={lengths} softcap={cap}: max err {err}, "
                    f"max |out| {scale}")
            worst = max(worst, err)
            checked += 1
        plans.append(((B, S, K, G, h), dg.split_plan(B, S, K, G, h, 2, sms)))
    log(f"[kernels] decode_gqa split cases: {checked} agree, max abs err "
        f"{worst}; (B, S, K, G, h) -> bf16 (warps, splits): {plans}")
    return checked, worst


def _abs_sum(torch, nbr, wgt, vals, deg, act, *, gather, reduce,
             mask_inactive):
    """Per lane and row, the sum of the live slots' |message| ((k, R)):
    the scale of a float sum's reassociation error."""
    from repro_torch.kernels.ref import PAD, gather_msg
    valid = nbr != PAD
    safe = torch.where(valid, nbr, 0).long()
    out = []
    for v, a in zip(vals, act):
        msg = gather_msg(gather, v[safe], wgt.to(v.dtype), deg[safe]).abs()
        live = valid & a[safe] if mask_inactive else valid
        out.append(torch.where(live, msg, 0).sum(1))
    return torch.stack(out)


def _close_sum(a, b, scale, rtol=1e-5, atol=1e-6):
    """Float sums in two orders: ``|a - b| <= atol + rtol * scale``, with
    ``scale`` the sum of the terms' magnitudes; equal infs and NaNs
    agree."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    near = (a - b).abs() <= atol + rtol * scale
    return bool((near | (a == b) | (a.isnan() & b.isnan())).all())


# the lane-axis kernel's sweep: (R, W, V, lane counts), R never a multiple
# of the 256-thread block; the last case's ids sit off the 16-byte grid
LANE_CASES = ((1037, 8, 4099, (1, 3, 8, 32, 37)), (300, 16, 97, (2, 8)),
              (5, 1, 7, (4, 16)), (515, 8, 1000, (8,)))


def _check_lane_kernel(torch, rng):
    """The lane-axis kernel (``edge_block_reduce_lanes``) over every
    gather × reduce × dtype × mask_inactive the menu admits, NaN inputs,
    k of 1 to 37 (one launch per 32 lanes) and ids off the 16-byte grid:
    each lane exactly equal to kernel 1 on that lane alone (values and
    any-live flags; the same slot order, so float add too), and to the
    plain version (min/max/int exact; float add, summed in another order,
    within 1e-5 of the sum of its terms' magnitudes plus 1e-6: near-zero
    sums of mixed signs part by more than 1e-5 of themselves)."""
    from repro_torch.kernels import edge_block as eb
    from repro_torch.kernels.ref import GATHER_OPS, PAD, REDUCE_OPS
    dev = torch.device("cuda")
    checked, worst = 0, 0.0
    for R, W, V, ks in LANE_CASES:
        nbr = rng.integers(0, V, (R, W)).astype(np.int32)
        nbr[rng.random((R, W)) < 0.3] = PAD
        wgt = rng.uniform(0, 4, (R, W)).astype(np.float32)
        deg = torch.as_tensor(rng.integers(0, 9, V).astype(np.int32)).to(dev)
        if (R, V) == (515, 1000):     # a view one id past the 16-byte grid
            flat = torch.as_tensor(np.concatenate(
                [[0], nbr.reshape(-1)]).astype(np.int32)).to(dev)
            nbr_t = flat[1:].view(R, W)
            wflat = torch.as_tensor(np.concatenate(
                [[0], wgt.reshape(-1)]).astype(np.float32)).to(dev)
            wgt_t = wflat[1:].view(R, W)
        else:
            nbr_t = torch.as_tensor(nbr).to(dev)
            wgt_t = torch.as_tensor(wgt).to(dev)
        for k in ks:
            act = torch.as_tensor(rng.random((k, V)) < 0.5).to(dev)
            for dtype in (np.int32, np.float32):
                vals = (rng.integers(-50, 50, (k, V)) if dtype == np.int32
                        else rng.uniform(-5, 5, (k, V))).astype(dtype)
                if dtype == np.float32:
                    vals[rng.random((k, V)) < 0.05] = np.nan
                vals = torch.as_tensor(vals).to(dev)
                for gather in GATHER_OPS:
                    if gather == "div_deg" and dtype == np.int32:
                        continue
                    for reduce in REDUCE_OPS:
                        for mask in (True, False):
                            kw = dict(gather=gather, reduce=reduce,
                                      mask_inactive=mask)
                            tag = (f"{gather}/{reduce}/{dtype.__name__}/"
                                   f"mask={mask} R={R} W={W} V={V} k={k}")
                            got = eb.edge_block_reduce_lanes(
                                nbr_t, wgt_t, vals, deg, act, **kw)
                            want = eb.edge_block_reduce_lanes_plain(
                                nbr_t, wgt_t, vals, deg, act, **kw)
                            one = [eb.edge_block_reduce(
                                nbr_t, wgt_t, vals[i], deg, act[i], **kw)
                                for i in range(k)]
                            torch.cuda.synchronize()
                            exact = not (dtype == np.float32
                                         and reduce == "add")
                            k1 = (torch.stack([o[0] for o in one]),
                                  torch.stack([o[1] for o in one]))
                            near = _same(got[0], want[0]) if exact else \
                                _close_sum(got[0], want[0], _abs_sum(
                                    torch, nbr_t, wgt_t, vals, deg, act,
                                    **kw))
                            if not (_same(got[0], k1[0])
                                    and _same(got[1], k1[1])
                                    and _same(got[1], want[1]) and near):
                                raise AssertionError(
                                    f"edge_block_lanes {tag}: max err "
                                    f"{_max_err(got[0], want[0])} against "
                                    f"plain, {_max_err(got[0], k1[0])} "
                                    "against kernel 1")
                            worst = max(worst, _max_err(got[0], want[0]))
                            checked += 1
    return checked, worst


# the fused lane sweep's and the lane push's ragged graphs: (V, random
# edges, edges into hub vertex 3, bucket max_width, lane counts); the hubs'
# runs of sub-rows cross warp and 256-thread block edges
LANE_GRAPHS = ((4099, 30000, 5000, 16, (1, 3, 4, 8, 17, 32, 33)),
               (1000, 9000, 3000, 1024, (4, 8, 32)),
               (97, 700, 0, 16, (3, 17)))


def _lane_graph(torch, V, E, hub, max_width, rng):
    """A graph with a hub, its flat pull view (bucketed at max_width) and
    forward ELL on the card."""
    from repro_torch.core import graph as G
    src = np.concatenate([rng.integers(0, V, E), rng.integers(0, V, hub)])
    dst = np.concatenate([rng.integers(0, V, E), np.full(hub, 3)])
    w = rng.uniform(0.5, 4.0, len(src)).astype(np.float32)
    g = G.from_edge_list(src, dst, weights=w, num_vertices=V)
    plan = G.pull_bitmap_plan(G.bucketize(G.reverse(g), max_width=max_width))
    fe = G.forward_ell(g, width=8)
    return (G.to_device(plan, "cuda"), G.to_device(fe, "cuda"),
            g.out_degrees.to(device="cuda", dtype=torch.int32))


def _lane_state(torch, rng, kk, V, dtype, live):
    """A (kk, V) state: int32 values with adds that wrap, or float32 with
    NaN and a third of +0 and -0, lanes of values >= 0 and lanes <= 0
    (so min and max both meet ties of +0 and -0, also across a hub's
    pieces); frontiers with a share ``live`` of active vertices."""
    if dtype == np.int32:
        vals = rng.integers(-50, 50, (kk, V)).astype(np.int32)
        vals[:, :3] = 2**31 - 1 - np.arange(3)
    else:
        vals = rng.uniform(0, 5, (kk, V)).astype(np.float32)
        zero = rng.random((kk, V)) < 0.33
        vals[zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0.0, -0.0)
        vals[1::2] *= -1
        vals[rng.random((kk, V)) < 0.05] = np.nan
    act = rng.random((kk, V)) < live
    return (torch.as_tensor(vals).to("cuda"),
            torch.as_tensor(act).to("cuda"))


def _check_lane_routes(torch, rng):
    """The fused lane sweep (``edge_block_fold_lanes``) and the lane push
    (``push_ell_lanes_reduce``) against their plain versions, bit for bit
    (+0 is not -0; NaN equal to NaN), over every gather x order-free
    reduce (min, max; add on int32) x dtype (x mask_inactive for the
    sweep), on ``LANE_GRAPHS`` (hubs split into rows, runs crossing block
    edges, ids 1..33 lanes wide), each lane map listing k of k + 2 lanes
    out of order (two left out, which must keep the table's identity),
    NaN, ties of +0 and -0, int adds that wrap; the sweep also into a
    table the lane push filled first (rows of one batched superstep).
    Returns the counts of cases and the largest ``|kernel - plain|`` of
    each."""
    from repro_torch.kernels import edge_block as eb
    from repro_torch.kernels import push_ell as pe
    from repro_torch.kernels.ref import GATHER_OPS, REDUCE_OPS, _identity
    checked = {"fold": 0, "push": 0}
    worst = {"fold": 0.0, "push": 0.0}
    zeros = {"fold": [0, 0], "push": [0, 0]}     # [-0, +0] entries seen

    def count_zeros(route, t):
        if t.dtype.is_floating_point:
            z = t == 0
            neg = int((z & t.signbit()).sum())
            zeros[route][0] += neg
            zeros[route][1] += int(z.sum()) - neg

    for V, E, hub, max_width, ks in LANE_GRAPHS:
        plan, fe, deg = _lane_graph(torch, V, E, hub, max_width, rng)
        for k in ks:
            kk = k + 2
            lanes = [int(i) for i in rng.permutation(kk)[:k]]
            for dtype in (np.int32, np.float32):
                vals, act = _lane_state(torch, rng, kk, V, dtype, 0.3)
                for gather in GATHER_OPS:
                    if gather == "div_deg" and dtype == np.int32:
                        continue
                    for reduce in REDUCE_OPS:
                        if reduce == "add" and dtype == np.float32:
                            continue
                        tag = (f"{gather}/{reduce}/{dtype.__name__} V={V} "
                               f"max_width={max_width} k={k} lanes={lanes}")
                        ident = _identity(reduce, vals.dtype)
                        for mask in (True, False):
                            kw = dict(gather=gather, reduce=reduce,
                                      mask_inactive=mask)
                            got = eb.edge_block_fold_lanes(
                                plan, vals, deg, act, lanes, **kw)
                            want = eb.edge_block_fold_lanes_plain(
                                plan, vals, deg, act, lanes, **kw)
                            torch.cuda.synchronize()
                            if not (_same_bits(got[0], want[0])
                                    and _same(got[1], want[1])):
                                raise AssertionError(
                                    f"edge_block_fold {tag} mask={mask}: "
                                    f"max err {_max_err(got[0], want[0])}, "
                                    "or the bits of a zero or the flags "
                                    "differ")
                            worst["fold"] = max(worst["fold"], _max_err(
                                got[0], want[0]))
                            count_zeros("fold", got[0])
                            checked["fold"] += 1
                        pkw = dict(num_rows=fe.num_rows, gather=gather,
                                   reduce=reduce, identity=ident)
                        args = (fe.row_src, fe.dst, fe.weights, vals, deg,
                                act)
                        # the push's lanes: k listed; the sweep then
                        # takes the two left out, into the same table
                        got = pe.push_ell_lanes_reduce(*args, lanes, **pkw)
                        want = pe.push_ell_lanes_reduce_plain(*args, lanes,
                                                              **pkw)
                        rest = [i for i in range(kk) if i not in lanes]
                        both, _ = eb.edge_block_fold_lanes(
                            plan, vals, deg, act, rest, gather=gather,
                            reduce=reduce, red=got.clone(), need_got=False)
                        alone, _ = eb.edge_block_fold_lanes_plain(
                            plan, vals, deg, act, rest, gather=gather,
                            reduce=reduce, need_got=False)
                        torch.cuda.synchronize()
                        if not (_same_bits(got, want)
                                and _same_bits(both[lanes], want[lanes])
                                and _same_bits(both[rest], alone[rest])):
                            raise AssertionError(
                                f"push_ell_lanes {tag}: max err "
                                f"{_max_err(got, want)}, or the bits of a "
                                "zero differ")
                        worst["push"] = max(
                            worst["push"], _max_err(got, want),
                            _max_err(both[lanes], want[lanes]))
                        worst["fold"] = max(worst["fold"], _max_err(
                            both[rest], alone[rest]))
                        count_zeros("push", got)
                        checked["push"] += 1
    log(f"[kernels] lane routes: the fused lane sweep in {checked['fold']} "
        f"cases and the lane push in {checked['push']} (each also sharing "
        "its table with a sweep of the other lanes) equal their plain "
        "versions bit for bit (max |err| fold "
        f"{worst['fold']}, push {worst['push']}); float min/max tables "
        f"held {zeros['fold'][0]} -0 and {zeros['fold'][1]} +0 entries "
        f"(fold), {zeros['push'][0]} and {zeros['push'][1]} (push), each "
        "a tie settled as the plain version settles it")
    return checked["fold"], checked["push"], worst["fold"], worst["push"]


TIE_GRAPH = (1 << 14, 1024, 1 << 18, 5000)   # V, targets, edges, a hub's


def _check_tie_routes(torch, rng):
    """The routes that reduce a float min/max through torch's own order
    (the dense plane's sub-row fold and row combines in ``pull_bitmap``,
    the sparse backend's scatter in ``push_scatter`` on pull and push,
    the streamed general partial's push scatter in ``core/stream.py``),
    one superstep each from every vertex active, on the card: messages
    +0, -0 and ±1 into 1,024 targets (one a hub of 5,000 in-edges, split
    into max-width rows), against a numpy table in which a tied zero is
    -0 for a min and +0 for a max if any such message reached the
    target.  Bit for bit; the -0 and +0 entries met are counted."""
    from repro_torch.core import dsl
    from repro_torch.core import graph as G
    from repro_torch.core.scheduler import DirectionPolicy, ScheduleConfig
    from repro_torch.core.translator import translate
    V, T, E, hub = TIE_GRAPH
    src = rng.integers(T, V, E).astype(np.int32)
    dst = rng.integers(1, T, E).astype(np.int32)
    dst[:hub] = 0
    zeros = [0, 0]
    checked = 0
    for reduce in ("min", "max"):
        win, lose, far = ((-0.0, 0.0, 1.0) if reduce == "min"
                          else (0.0, -0.0, -1.0))
        vals = np.full(V, far, np.float32)
        r = rng.random(V)
        vals[r < 0.4] = lose
        vals[r < 0.02] = win
        ident = np.inf if reduce == "min" else -np.inf
        vals[:T] = ident
        msg = vals[src]
        want = np.full(V, ident, np.float32)
        (np.minimum if reduce == "min" else np.maximum).at(want, dst, msg)
        won = np.zeros(V, bool)
        np.logical_or.at(won, dst, (msg == 0) & (np.signbit(msg)
                                                 == (reduce == "min")))
        want = np.where(want == 0, np.where(won, np.float32(win),
                                            np.float32(lose)), want)
        want[T:] = vals[T:]
        want = want.astype(np.float32)
        apply = torch.minimum if reduce == "min" else torch.maximum
        for route, weight in (("dense/pull", 1.0), ("sparse/pull", 1.0),
                              ("sparse/push", 1.0),
                              ("stream general/push", -0.0)):
            g = G.from_edge_list(src, dst, num_vertices=V,
                                 weights=np.full(E, weight, np.float32))
            general = route.startswith("stream")
            prog = dsl.VertexProgram(
                name=f"tie_{reduce}", reduce=reduce, apply=apply,
                gather=(lambda v, w, d: v + 2 * w) if general
                else (lambda v, w, d: v), init_value=float(ident),
                frontier="changed", value_dtype=torch.float32)
            backend, mode = route.split("/")
            cfg = ScheduleConfig(
                partitions=2 if general else 1,
                backend="auto" if general else backend,
                direction=DirectionPolicy(mode=mode))
            tp = translate(prog, g, cfg, device="cuda")
            v0, a0 = tp.init_state(values=vals)
            if general:
                v, a = v0[None], a0[None]
                red, got, _, _ = tp._sweep(v, a, [0], list(range(
                    tp.store.partitions)), "push", trip=False)
                new = tp._finish(v, a, red, got, [0])[0][0]
            elif mode == "pull":
                new, _ = tp.superstep(v0, a0)
            else:
                new, _ = tp.superstep_push(v0, a0)
            out = new.cpu().numpy()
            if not _same_bits_np(out, want):
                bad = int(np.sum(out.view(np.int32) != want.view(np.int32)))
                raise AssertionError(f"tie route {route} {reduce}: {bad} "
                                     "entries differ from the numpy table "
                                     "in their bits")
            z = out[:T] == 0
            zeros[0] += int(np.sum(z & np.signbit(out[:T])))
            zeros[1] += int(np.sum(z & ~np.signbit(out[:T])))
            checked += 1
    log(f"[kernels] tie routes: the dense pull's sub-row fold and row "
        f"combines, the sparse pull and push scatter and the streamed "
        f"general push, min and max, {checked} cases, equal a numpy table "
        f"bit for bit; {zeros[0]} -0 and {zeros[1]} +0 entries, each a tie "
        f"settled -0 < +0")
    return checked


# 2L's ragged cases: (LANE_GRAPHS entry, grid block rows, lane counts); a
# grid of 5 rows leaves most of a warp's row streams empty at K = 1, one of
# 37 puts a ragged block of 37 rows in every stream shape
LANE_SKIP_CASES = ((0, 128, (1, 8, 33)), (1, 128, (1, 4, 8, 32)),
                   (2, 5, (3, 17)),
                   (0, 37, (4, 32)))


def _lane_skip_flags(torch, rng, kk, nblk):
    """Random (kk, nblk) flags on the card with an all-dead grid block, a
    block live in one lane only and a lane dead everywhere."""
    flags = rng.random((kk, nblk)) < 0.5
    flags[:, 0] = False
    if nblk > 1:
        flags[:, 1] = False
        flags[kk // 2, 1] = True
    flags[kk - 1] = False
    return torch.as_tensor(flags).to("cuda")


def _prepass_err(prep, want, V, tag):
    """The lane pre-pass's tables on the card (``prep``) against its plain
    version's (``want``): frontier bits equal everywhere, messages equal
    at every vertex whose row the kernel writes (under mask_inactive those
    active in some lane of the launch, else all).  Raises on a mismatch;
    returns the largest ``|message - plain|`` over the written rows."""
    worst = 0.0
    if len(prep.chunks) != len(want):
        raise AssertionError(f"lanes_prepare {tag}: {len(prep.chunks)} "
                             f"launches, the plain version {len(want)}")
    for (lo, _, k, K, bits, msg), (lo2, k2, K2, wbits, wmsg, written) \
            in zip(prep.chunks, want):
        m, wm = msg.view(V, K)[written], wmsg.view(V, K)[written]
        if (lo, k, K) != (lo2, k2, K2) or (bits is None) != (wbits is None) \
                or (bits is not None and not _same(bits, wbits)) \
                or not _same_bits(m, wm):
            raise AssertionError(f"lanes_prepare {tag} != its plain "
                                 f"version")
        worst = max(worst, _max_err(m, wm))
    return worst


def _check_lane_prepass(torch, eb, vals, deg, act, lanes, gather):
    """The lane pre-pass's tables on the card against its plain version,
    masked (the messages of active vertices only) and unmasked (every
    message): see ``_prepass_err``."""
    V = vals.shape[1]
    for mask in (True, False):
        prep = eb.lanes_prepare(vals, deg, act, lanes, gather=gather,
                                mask_inactive=mask)
        want = eb.lanes_prepare_plain(vals, deg, act, lanes, gather=gather,
                                      mask_inactive=mask)
        torch.cuda.synchronize()
        _prepass_err(prep, want, V, f"mask={mask} {gather} {vals.dtype} "
                                    f"V={V} k={len(lanes)}")


def _check_lane_skip(torch, rng):
    """2L, the lane sweep with a per-lane early-out (both lane kernels with
    flags), on ``LANE_GRAPHS``: every gather x reduce x dtype x
    mask_inactive, k lanes listed out of order in a state with two left
    out, NaN, +0 and -0.  On random flags (a ragged last grid block, an
    all-dead block, a one-lane block, a dead lane; grids of 128, 37 and 5
    rows, so row streams end inside runs of owners and hubs' runs cross
    streams, warps and grid blocks) the sub-row kernel equals k single-lane
    kernel-2 launches bit for bit (the same slot order: float add too) and
    its plain version (float add within 1e-5 of the sum of |terms|); the
    fold (min, max, int add: the warp-a-grid-block kernel) equals its plain
    version bit for bit, and without mask_inactive raises.  The kernels
    take the flags as words (``block_words_from_flags``), the plain
    versions the flag table.  The pre-pass, masked (live messages only)
    and unmasked, equals its plain version.
    On the lanes' touched tables (``push_lanes_touched``, held against its
    plain version) the flags pass (``lane_block_words``, words and
    counters) equals its plain version, and 2L on its words equals 1L bit
    for bit.  Returns the count of cases and the largest ``|kernel -
    plain|``."""
    from repro_torch.kernels import edge_block as eb
    from repro_torch.kernels import push_ell as pe
    from repro_torch.kernels.ref import GATHER_OPS, REDUCE_OPS
    checked, worst, dead = 0, 0.0, 0
    for gi, br, ks in LANE_SKIP_CASES:
        V, E, hub, max_width, _ = LANE_GRAPHS[gi]
        plan, fe, deg = _lane_graph(torch, V, E, hub, max_width, rng)
        R = plan.flat_dst.shape[0]
        nblk = -(-R // br)
        for k in ks:
            kk = k + 2
            lanes = [int(i) for i in rng.permutation(kk)[:k]]
            flags = _lane_skip_flags(torch, rng, kk, nblk)
            words = eb.block_words_from_flags(flags, lanes, br)
            dead += int((~flags[lanes]).sum())
            for dtype in (np.int32, np.float32):
                vals, act = _lane_state(torch, rng, kk, V, dtype, 0.3)
                for gather in GATHER_OPS:
                    if gather == "div_deg" and dtype == np.int32:
                        continue
                    _check_lane_prepass(torch, eb, vals, deg, act, lanes,
                                        gather)
                    checked += 1
                    for reduce in REDUCE_OPS:
                        exact = not (reduce == "add" and dtype == np.float32)
                        for mask in (True, False):
                            kw = dict(gather=gather, reduce=reduce,
                                      mask_inactive=mask)
                            fl = dict(block_words=words)
                            table = dict(block_live=flags, block_rows=br)
                            tag = (f"{gather}/{reduce}/{dtype.__name__}/"
                                   f"mask={mask} V={V} br={br} k={k}")
                            got = eb.edge_block_reduce_lanes(
                                plan.flat_dst, plan.flat_wgt, vals, deg, act,
                                lanes, **kw, **fl)
                            want = eb.edge_block_reduce_lanes_plain(
                                plan.flat_dst, plan.flat_wgt, vals, deg, act,
                                lanes, **kw, **table)
                            one = [eb.edge_block_reduce(
                                plan.flat_dst, plan.flat_wgt, vals[i], deg,
                                act[i], block_live=flags[i], block_rows=br,
                                **kw) for i in lanes]
                            torch.cuda.synchronize()
                            k2 = (torch.stack([o[0] for o in one]),
                                  torch.stack([o[1] for o in one]))
                            near = _same(got[0], want[0]) if exact else \
                                _close_sum(got[0], want[0], _abs_sum(
                                    torch, plan.flat_dst, plan.flat_wgt,
                                    vals[lanes], deg, act[lanes], **kw))
                            if not (_same_bits(got[0], k2[0])
                                    and _same(got[1], k2[1])
                                    and _same(got[1], want[1]) and near):
                                raise AssertionError(
                                    f"edge_block_lanes 2L {tag}: max err "
                                    f"{_max_err(got[0], want[0])} against "
                                    f"plain, {_max_err(got[0], k2[0])} "
                                    "against kernel 2 a lane")
                            worst = max(worst, _max_err(got[0], want[0]))
                            checked += 1
                            if not exact:
                                continue
                            if not mask:
                                try:
                                    eb.edge_block_fold_lanes(
                                        plan, vals, deg, act, lanes, **kw,
                                        **fl)
                                except ValueError:
                                    checked += 1
                                    continue
                                raise AssertionError(
                                    f"edge_block_fold 2L {tag}: a flagged "
                                    "fold without mask_inactive ran")
                            got = eb.edge_block_fold_lanes(
                                plan, vals, deg, act, lanes, **kw, **fl)
                            want = eb.edge_block_fold_lanes_plain(
                                plan, vals, deg, act, lanes, **kw, **table)
                            torch.cuda.synchronize()
                            if not (_same_bits(got[0], want[0])
                                    and _same(got[1], want[1])):
                                raise AssertionError(
                                    f"edge_block_fold 2L {tag}: max err "
                                    f"{_max_err(got[0], want[0])}, or the "
                                    "bits of a zero or the flags differ")
                            worst = max(worst, _max_err(got[0], want[0]))
                            checked += 1
                # the bitmap plane's flags: each lane's touched table, a
                # word a grid block built on the card; 2L on them = 1L
                touched = pe.push_lanes_touched(fe.row_src, fe.dst, act,
                                                lanes, num_rows=fe.num_rows)
                t_want = pe.push_lanes_touched_plain(
                    fe.row_src, fe.dst, act, lanes, num_rows=fe.num_rows)
                wide = lanes[1:2]
                gcount = torch.as_tensor(
                    rng.integers(1, 9, nblk).astype(np.int64)).to("cuda")
                gedges = torch.as_tensor(
                    rng.integers(0, 5000, nblk).astype(np.int64)).to("cuda")
                tw, tc = eb.lane_block_words(
                    touched, plan.owner8, lanes, br, wide=wide,
                    grid_blocks=gcount, grid_edges=gedges)
                tw_want, tc_want = eb.lane_block_words_plain(
                    t_want, plan.owner8, lanes, br, wide=wide,
                    grid_blocks=gcount, grid_edges=gedges)
                torch.cuda.synchronize()
                if not (_same(touched, t_want) and _same(tw.words,
                                                         tw_want.words)
                        and _same(tc, tc_want)):
                    raise AssertionError(f"push_lanes_touched or the flags "
                                         f"pass V={V} br={br} k={k} != its "
                                         "plain version")
                tw, _ = eb.lane_block_words(touched, plan.owner8, lanes, br)
                checked += 2
                for gather in ("copy", "plus_one", "add_w", "mul_w"):
                    for reduce in REDUCE_OPS:
                        tf = dict(block_words=tw)
                        kw = dict(gather=gather, reduce=reduce)
                        a = eb.edge_block_reduce_lanes(
                            plan.flat_dst, plan.flat_wgt, vals, deg, act,
                            lanes, **kw, **tf)
                        b = eb.edge_block_reduce_lanes(
                            plan.flat_dst, plan.flat_wgt, vals, deg, act,
                            lanes, **kw)
                        same = _same_bits(a[0], b[0]) and _same(a[1], b[1])
                        if reduce != "add" or dtype == np.int32:
                            a = eb.edge_block_fold_lanes(plan, vals, deg,
                                                         act, lanes, **kw,
                                                         **tf)
                            b = eb.edge_block_fold_lanes(plan, vals, deg,
                                                         act, lanes, **kw)
                            same = same and _same_bits(a[0], b[0]) \
                                and _same(a[1], b[1])
                        torch.cuda.synchronize()
                        if not same:
                            raise AssertionError(
                                f"2L on touched flags != 1L: {gather}/"
                                f"{reduce}/{dtype.__name__} V={V} br={br} "
                                f"k={k}")
                        checked += 1
    log(f"[kernels] 2L (the lane kernels with block flags): {checked} cases "
        f"({dead} dead lane-blocks in the random flags): the sub-row "
        "kernel = kernel 2 a lane bit for bit and = plain (float add within "
        "1e-5 of the sum of |terms|), the warp-a-grid-block fold = plain "
        "bit for bit (and raises without mask_inactive), the pre-pass "
        "masked (live messages only) and unmasked = plain, "
        "push_lanes_touched and the flags pass (words, counters) = plain, "
        f"and 2L on touched words = 1L bit for bit; max |err| against plain "
        f"{worst}")
    return checked, worst


def _row_pieces(rng, rows, n=3):
    """``n`` consecutive row ranges covering ``[0, rows)``, cut at random
    rows (so a hub's run of sub-rows falls into several pieces)."""
    cuts = np.sort(rng.choice(np.arange(1, rows), n - 1, replace=False))
    edges = [0, *cuts.tolist(), rows]
    return list(zip(edges[:-1], edges[1:]))


def _check_stream_routes(torch, rng):
    """The streamed engine's kernel routes against their plain versions
    and the unsplit kernels, on ``LANE_GRAPHS``' first two graphs, the
    views cut into 3 pieces at random rows (the stream's partitions: an
    owner's rows in several pieces, runs crossing warp and block edges in
    each): the fused lane sweep in accumulate mode, fed one pre-pass
    (``lanes_prepare``) for all pieces, equals the unsplit fused sweep and
    the plain accumulate bit for bit (red and got); the lane push over the
    pieces into one table with ``got`` and one pre-pass
    (``push_lanes_prepare``) equals the unsplit push, its got the plain
    version's; kernel 1 and the lane kernel on prepared tables
    (``edge_block_prepare`` / ``lanes_prepare``) equal their unprepared
    launches bit for bit on each piece, float add included.  Every
    gather x order-free reduce x dtype x mask_inactive, k of 1, 3, 8 and
    33.  Returns (cases, max |kernel - plain|)."""
    import types
    from repro_torch.kernels import edge_block as eb
    from repro_torch.kernels import push_ell as pe
    from repro_torch.kernels.ref import GATHER_OPS, REDUCE_OPS, _identity
    checked, worst = 0, 0.0
    for V, E, hub, max_width, ks in LANE_GRAPHS[:2]:
        plan, fe, deg = _lane_graph(torch, V, E, hub, max_width, rng)
        R = plan.flat_dst.shape[0]
        pieces = _row_pieces(rng, R)
        fpieces = _row_pieces(rng, fe.num_rows)
        views = [types.SimpleNamespace(flat_dst=plan.flat_dst[a:b],
                                       flat_wgt=plan.flat_wgt[a:b],
                                       owner8=plan.owner8[a:b])
                 for a, b in pieces]
        for k in [k for k in ks if k in (1, 3, 8, 33)]:
            kk = k + 2
            lanes = [int(i) for i in rng.permutation(kk)[:k]]
            for dtype in (np.int32, np.float32):
                vals, act = _lane_state(torch, rng, kk, V, dtype, 0.3)
                for gather in GATHER_OPS:
                    if gather == "div_deg" and dtype == np.int32:
                        continue
                    for mask in (True, False):
                        kw = dict(gather=gather, mask_inactive=mask)
                        prep = eb.lanes_prepare(vals, deg, act, lanes, **kw)
                        tag = (f"{gather}/{dtype.__name__} V={V} k={k} "
                               f"mask={mask}")
                        for reduce in REDUCE_OPS:
                            if reduce == "add" and dtype == np.float32:
                                continue
                            ident = _identity(reduce, vals.dtype)
                            red = torch.full((kk, V), ident,
                                             dtype=vals.dtype, device="cuda")
                            got = torch.zeros((kk, V), dtype=torch.bool,
                                              device="cuda")
                            pred, pgot = red.clone(), got.clone()
                            for view in views:
                                eb.edge_block_fold_lanes(
                                    view, vals, deg, act, lanes,
                                    reduce=reduce, red=red, got=got,
                                    accumulate=True, prepared=prep, **kw)
                                eb.edge_block_fold_lanes_plain(
                                    view, vals, deg, act, lanes,
                                    reduce=reduce, red=pred, got=pgot,
                                    accumulate=True, **kw)
                            whole = eb.edge_block_fold_lanes(
                                plan, vals, deg, act, lanes, reduce=reduce,
                                **kw)
                            torch.cuda.synchronize()
                            if not (_same_bits(red, whole[0])
                                    and _same_bits(red, pred)
                                    and _same(got, whole[1])
                                    and _same(got, pgot)):
                                raise AssertionError(
                                    f"edge_block_fold accumulate {tag} "
                                    f"{reduce}: max err "
                                    f"{_max_err(red, pred)} against plain, "
                                    f"{_max_err(red, whole[0])} against "
                                    "the unsplit sweep, or a flag differs")
                            worst = max(worst, _max_err(red, pred))
                            checked += 1
                            if not mask:
                                continue
                            # the lane push over the forward ELL's pieces
                            pprep = pe.push_lanes_prepare(act, lanes)
                            table = torch.full((kk, V), ident,
                                               dtype=vals.dtype,
                                               device="cuda")
                            tgot = torch.zeros((kk, V), dtype=torch.bool,
                                               device="cuda")
                            for a, b in fpieces:
                                pe.push_ell_lanes_reduce(
                                    fe.row_src[a:b], fe.dst[a:b],
                                    fe.weights[a:b], vals, deg, act, lanes,
                                    num_rows=b - a, gather=gather,
                                    reduce=reduce, identity=ident,
                                    table=table, got=tgot, prepared=pprep)
                            pkw = dict(num_rows=fe.num_rows, gather=gather,
                                       reduce=reduce, identity=ident)
                            args = (fe.row_src, fe.dst, fe.weights, vals,
                                    deg, act, lanes)
                            whole = pe.push_ell_lanes_reduce(*args, **pkw)
                            wgot = torch.zeros_like(tgot)
                            want = pe.push_ell_lanes_reduce_plain(
                                *args, **pkw, got=wgot)
                            torch.cuda.synchronize()
                            if not (_same_bits(table, whole)
                                    and _same_bits(table, want)
                                    and _same(tgot, wgot)):
                                raise AssertionError(
                                    f"push_ell_lanes pieces {tag} {reduce}: "
                                    f"max err {_max_err(table, want)}, or "
                                    "got differs")
                            worst = max(worst, _max_err(table, want))
                            checked += 1
                        # kernel 1 and the lane kernel on prepared tables
                        for reduce in REDUCE_OPS:
                            for a, b in pieces:
                                blk = (plan.flat_dst[a:b], plan.flat_wgt[a:b])
                                one = eb.edge_block_prepare(
                                    vals[lanes[0]], deg, act[lanes[0]], **kw)
                                p1 = eb.edge_block_reduce(
                                    *blk, vals[lanes[0]], deg,
                                    act[lanes[0]], reduce=reduce,
                                    prepared=one, **kw)
                                u1 = eb.edge_block_reduce(
                                    *blk, vals[lanes[0]], deg,
                                    act[lanes[0]], reduce=reduce, **kw)
                                pl = eb.edge_block_reduce_lanes(
                                    *blk, vals, deg, act, lanes,
                                    reduce=reduce, prepared=prep, **kw)
                                ul = eb.edge_block_reduce_lanes(
                                    *blk, vals, deg, act, lanes,
                                    reduce=reduce, **kw)
                                torch.cuda.synchronize()
                                if not (_same_bits(p1[0], u1[0])
                                        and _same(p1[1], u1[1])
                                        and _same_bits(pl[0], ul[0])
                                        and _same(pl[1], ul[1])):
                                    raise AssertionError(
                                        f"prepared launch {tag} {reduce} "
                                        f"rows {a}:{b} differs from the "
                                        "unprepared one")
                                checked += 1
    log(f"[kernels] streamed routes: {checked} cases of the fused lane "
        "sweep in accumulate mode over 3 pieces of a view (= the unsplit "
        "sweep and the plain accumulate, bit for bit), the lane push over "
        "3 pieces with got (= the unsplit push and the plain got), and "
        "kernel 1 / the lane kernel on prepared tables (= unprepared), "
        f"one pre-pass for all pieces; max |err| {worst}")
    return checked, worst


def _add_fold_parent(torch, view, vals, deg, act, lanes, *, gather,
                     mask_inactive, red, got, prepared=None):
    """The streamed float-add route that ``edge_block_add_fold_lanes``
    replaced, as the parent tree's ``PartitionedGraphProgram._partial``
    ran it: a pre-pass, kernel 1 (one lane) or the lane kernel for the
    row sums and any-live flags, then a lane at a time kernel 4 by owner,
    ``red += partial`` and ``got |= segment max > 0``.  Its A/B
    yardstick, bit for bit.  ``prepared``: the superstep's pre-pass
    (``edge_block_prepare`` for one lane, else ``lanes_prepare``), made
    here when None."""
    from repro_torch.kernels import edge_block as eb
    from repro_torch.kernels import segment_sum as ss
    V = vals.shape[1]
    kw = dict(gather=gather, reduce="add", mask_inactive=mask_inactive)
    slot, wgt, key = view.flat_dst, view.flat_wgt, view.owner8
    if len(lanes) == 1:
        i = lanes[0]
        prep = prepared or eb.edge_block_prepare(
            vals[i], deg, act[i], gather=gather, mask_inactive=mask_inactive)
        sums, anys = eb.edge_block_reduce(slot, wgt, vals[i], deg, act[i],
                                          prepared=prep, **kw)
        sums, anys = sums[None], anys[None]
    else:
        prep = prepared or eb.lanes_prepare(
            vals, deg, act, lanes, gather=gather, mask_inactive=mask_inactive)
        sums, anys = eb.edge_block_reduce_lanes(
            slot, wgt, vals, deg, act, lanes, need_any=got is not None,
            prepared=prep, **kw)
    for j, i in enumerate(lanes):
        red[i] += ss.segment_reduce(key, sums[j], V, reduce="add")
        if got is not None:
            got[i] |= ss.segment_reduce(key, anys[j].to(torch.int32), V,
                                        reduce="max") > 0
    return red, got


# the streamed float-add fold's ragged cases: (name, rows, width, V); the
# owners' runs are laid out by _add_fold_view
ADD_FOLD_CASES = (("tile_crossing", 9001, 8, 3001),
                  ("hub", 40000, 8, 2000),
                  ("one_tile", 777, 8, 500),
                  ("empty", 0, 8, 300),
                  ("absent_owners", 5000, 8, 4000),
                  ("off_grid", 3001, 8, 1500),
                  ("width_3", 2500, 3, 900))
ADD_FOLD_LANES = (1, 3, 8, 32, 33)


def _add_fold_view(torch, rng, name, R, W, V):
    """A pull partition's rows: owners ascending in runs (a run across
    each tile edge of 2,048 rows; a hub of 25,000 rows over 12 tiles; only
    even owners, so the odd ones are absent; the last rows owned by V, a
    pad), ids with a third PAD, weights; ``off_grid`` is one word off the
    16-byte grid, ``width_3`` three slots a row."""
    import types
    from repro_torch.kernels.ref import PAD
    lengths = []
    while sum(lengths) < R:
        lengths.append(int(rng.integers(1, 40)))
    if name == "hub":
        lengths = [3, 2040, 25000 + 7] + lengths
    elif name == "tile_crossing":
        lengths = [2040, 16, 4090, 12] + lengths
    owner = np.repeat(np.arange(len(lengths)), lengths)[:R]
    owner = np.sort(rng.choice(V, len(lengths), replace=False))[owner] \
        if len(lengths) <= V else owner % V
    if name == "absent_owners":
        owner = np.sort(owner // 2 * 2)
    owner = owner.astype(np.int32)
    owner[R - R // 50:] = V                 # pad rows, dropped
    nbr = rng.integers(0, V, (R, W)).astype(np.int32)
    nbr[rng.random((R, W)) < 0.3] = PAD
    wgt = rng.uniform(0.25, 4, (R, W)).astype(np.float32)
    off = 1 if name == "off_grid" else 0

    def card(a):
        flat = np.concatenate([np.zeros(off, a.dtype), a.reshape(-1)])
        return torch.as_tensor(flat).to("cuda")[off:].view(a.shape)

    return types.SimpleNamespace(flat_dst=card(nbr), flat_wgt=card(wgt),
                                 owner8=card(owner))


def _check_add_fold(torch, rng):
    """The streamed float-add fold (``edge_block_add_fold_lanes``) over
    ``ADD_FOLD_CASES`` (runs across tile edges, a hub over 12 tiles, one
    tile, an empty partition, absent owners, pad owners, a view off the
    16-byte grid, width 3) x k in ``ADD_FOLD_LANES`` (K = 1, 4, 8, 32 and
    two launches for 33) listed out of order in a state of k + 2 lanes x
    every gather x mask_inactive, got on (and for ``copy`` off), values
    with NaN and a fifth of +0 and -0, running tables of random values,
    +0 and NaN (no -0: a running sum from +0 never holds one): equal to
    the route it replaced (``_add_fold_parent``) bit for bit, got and the
    lanes left out too, and to its plain version within 1e-5 of each
    entry's sum of |terms| and |red| plus 1e-6.  Returns (cases, max
    |kernel - plain|)."""
    from repro_torch.kernels import edge_block as eb
    from repro_torch.kernels.ref import GATHER_OPS, segment_reduce_ref
    checked, worst = 0, 0.0
    for name, R, W, V in ADD_FOLD_CASES:
        view = _add_fold_view(torch, rng, name, R, W, V)
        deg = torch.as_tensor(rng.integers(0, 9, V).astype(np.int32)) \
            .to("cuda")
        for k in ADD_FOLD_LANES:
            kk = k + 2
            lanes = [int(i) for i in rng.permutation(kk)[:k]]
            vals = rng.uniform(-5, 5, (kk, V)).astype(np.float32)
            zero = rng.random((kk, V)) < 0.2
            vals[zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0.0,
                                  -0.0)
            vals[rng.random((kk, V)) < 0.02] = np.nan
            vals = torch.as_tensor(vals).to("cuda")
            act = torch.as_tensor(rng.random((kk, V)) < 0.5).to("cuda")
            red0 = rng.uniform(-3, 3, (kk, V)).astype(np.float32)
            red0[rng.random((kk, V)) < 0.2] = 0.0
            red0[rng.random((kk, V)) < 0.01] = np.nan
            red0 = torch.as_tensor(red0).to("cuda")
            got0 = torch.as_tensor(rng.random((kk, V)) < 0.1).to("cuda")
            for gather in GATHER_OPS:
                for mask in (True, False):
                    for with_got in ((True, False) if gather == "copy"
                                     else (True,)):
                        kw = dict(gather=gather, mask_inactive=mask)
                        red, got = red0.clone(), got0.clone() \
                            if with_got else None
                        eb.edge_block_add_fold_lanes(
                            view, vals, deg, act, lanes, red=red, got=got,
                            **kw)
                        pred, pgot = _add_fold_parent(
                            torch, view, vals, deg, act, lanes,
                            red=red0.clone(),
                            got=got0.clone() if with_got else None, **kw)
                        wred, wgot = eb.edge_block_add_fold_lanes_plain(
                            view, vals, deg, act, lanes, red=red0.clone(),
                            got=got0.clone() if with_got else None, **kw)
                        torch.cuda.synchronize()
                        scale = red0.abs().nan_to_num()
                        if R:
                            terms = _abs_sum(torch, view.flat_dst,
                                             view.flat_wgt, vals, deg, act,
                                             reduce="add", **kw)
                            scale = scale + torch.stack([segment_reduce_ref(
                                view.owner8, t, V) for t in terms])
                        tag = (f"{name} k={k} {gather} mask={mask} "
                               f"got={with_got}")
                        if not (_same_bits(red, pred)
                                and (not with_got or _same(got, pgot))):
                            raise AssertionError(
                                f"edge_block_add_fold {tag}: differs from "
                                "the route it replaced (max err "
                                f"{_max_err(red, pred)}), or got does")
                        if not (_close_sum(red, wred, scale)
                                and (not with_got or _same(got, wgot))):
                            raise AssertionError(
                                f"edge_block_add_fold {tag}: max err "
                                f"{_max_err(red, wred)} against plain, or "
                                "got differs")
                        worst = max(worst, _max_err(red, wred))
                        checked += 1
    log(f"[kernels] streamed float-add fold: {checked} cases "
        f"({', '.join(c[0] for c in ADD_FOLD_CASES)}; k in "
        f"{list(ADD_FOLD_LANES)}; every gather, mask_inactive, got on and "
        "off; NaN and +-0) equal to the route it replaced (kernel 1 or the "
        "lane kernel, kernel 4, the add) bit for bit and to the plain "
        f"version within 1e-5 of the sum of |terms|; max |err| {worst}")
    return checked, worst


def _check_shard_routes(torch, rng):
    """Kernels 3f and 3L on the per-PE intervals of a sharded forward ELL
    (``graph.shard_forward_ell``, launched as the multi-PE push launches
    them: PE p on its first ``rows_per_pe[p]`` rows) against their plain
    versions, and the PEs' partials combined by the reduce-matched
    collective (``comm.COLLECTIVES``) against the unsharded plain push,
    bit for bit: every gather x order-free reduce x dtype (NaN, +0 and -0
    among float values); intervals that start mid-graph; empty intervals
    (every edge on two vertices, cut for four PEs); vertex 0 on every
    frontier while padding rows (``row_src`` 0) exist, with each PE's
    live rows counted from its vertex bounds equal to the JAX package's
    ``active[row_src] & row_valid`` and below the count that reads the
    padding."""
    from repro_torch.core import comm as C
    from repro_torch.core import graph as G
    from repro_torch.kernels import push_ell as pe
    from repro_torch.kernels.ref import GATHER_OPS, _identity
    dev = torch.device("cuda")
    checked, worst, empty, padded = 0, 0.0, 0, 0
    coll = {"min": C.pmin, "max": C.pmax, "add": C.psum}
    for V, E, pes, skewed in ((4099, 30000, 3, False), (300, 2000, 4, True)):
        src = (rng.choice([0, 1], E) if skewed
               else rng.integers(0, V, E)).astype(np.int32)
        dst = rng.integers(0, V, E).astype(np.int32)
        w = rng.uniform(0, 4, E).astype(np.float32)
        g = G.from_edge_list(src, dst, num_vertices=V, weights=w)
        fe = G.forward_ell(g)
        sfe = G.shard_forward_ell(fe, pes)
        empty += sum(n == 0 for n in sfe.rows_per_pe)
        padded += sum(n < sfe.rows_per_pe_max for n in sfe.rows_per_pe)
        deg = g.out_degrees.to(device=dev, dtype=torch.int32)
        whole = [t.to(dev) for t in (fe.row_src, fe.dst, fe.weights)]
        parts = [tuple(t.to(dev) for t in sfe.interval(p))
                 for p in range(pes)]
        k, lanes = 5, [3, 0, 4, 1]
        act = rng.random((k, V)) < 0.5
        act[:, 0] = True                       # vertex 0 on every frontier
        act_k = torch.as_tensor(act).to(dev)
        a0 = act_k[0]
        rpv = fe.rows_per_vertex.to(dev)
        cuts = sfe.vertex_cuts
        by_cuts = [int(torch.where(a0, rpv, 0)[lo:hi].sum())
                   for lo, hi in zip(cuts[:-1], cuts[1:])]
        rs_pad = sfe.row_src.long().to(dev)
        jax_rule = (a0[rs_pad] & sfe.row_valid.to(dev)).sum(1).tolist()
        unmasked = a0[rs_pad].sum(1).tolist()
        if by_cuts != jax_rule or not any(
                u > j for u, j in zip(unmasked, jax_rule)):
            raise AssertionError(f"live rows a PE: by cuts {by_cuts}, JAX "
                                 f"rule {jax_rule}, unmasked {unmasked}")
        for dtype in (np.int32, np.float32):
            vals = (rng.integers(-50, 50, (k, V)) if dtype == np.int32
                    else rng.uniform(-5, 5, (k, V))).astype(dtype)
            if dtype == np.float32:
                for special in (np.nan, 0.0, -0.0):
                    vals[rng.random((k, V)) < 0.05] = special
            vals_k = torch.as_tensor(vals).to(dev)
            v0 = vals_k[0].contiguous()
            for gather in GATHER_OPS:
                if gather == "div_deg" and dtype == np.int32:
                    continue
                for reduce in ("min", "max", "add"):
                    if reduce == "add" and dtype == np.float32:
                        continue
                    ident = _identity(reduce, v0.dtype)
                    kw = dict(gather=gather, reduce=reduce, identity=ident)
                    fkw = dict(kw, num_vertices=V, dtype=v0.dtype)
                    sel, ok = pe.compact_rows(a0[whole[0].long()],
                                              fe.num_rows, fe.num_rows)
                    want = pe.push_ell_fused_reduce_plain(
                        sel, ok, *whole, v0, deg, **fkw)[0]
                    want_l = pe.push_ell_lanes_reduce_plain(
                        *whole, vals_k, deg, act_k, lanes,
                        num_rows=fe.num_rows, **kw)
                    got_p, got_l = [], []
                    for p, (rs, d_p, w_p) in enumerate(parts):
                        n = sfe.rows_per_pe[p]
                        if n == 0:
                            continue
                        sel, ok = pe.compact_rows(a0[rs.long()], n, n)
                        args = (sel, ok, rs, d_p, w_p, v0, deg)
                        one = pe.push_ell_fused_reduce(*args, **fkw)[0]
                        plain = pe.push_ell_fused_reduce_plain(*args,
                                                               **fkw)[0]
                        lk = pe.push_ell_lanes_reduce(
                            rs, d_p, w_p, vals_k, deg, act_k, lanes,
                            num_rows=n, **kw)
                        lplain = pe.push_ell_lanes_reduce_plain(
                            rs, d_p, w_p, vals_k, deg, act_k, lanes,
                            num_rows=n, **kw)
                        torch.cuda.synchronize()
                        if not (_same_bits(one, plain)
                                and _same_bits(lk, lplain)):
                            raise AssertionError(
                                f"shard route {gather}/{reduce}/"
                                f"{dtype.__name__} PE {p} of {pes} (rows "
                                f"{n}): 3f err {_max_err(one, plain)}, 3L "
                                f"err {_max_err(lk, lplain)}")
                        worst = max(worst, _max_err(one, plain),
                                    _max_err(lk, lplain))
                        got_p.append(one)
                        got_l.append(lk)
                        checked += 2
                    if not (_same_bits(coll[reduce](got_p), want)
                            and _same_bits(coll[reduce](got_l), want_l)):
                        raise AssertionError(
                            f"sharded push {gather}/{reduce}/"
                            f"{dtype.__name__} over {pes} PEs != the "
                            f"unsharded plain push")
                    checked += 2
    if not empty or not padded:
        raise AssertionError(f"the shard cases met {empty} empty and "
                             f"{padded} padded intervals")
    log(f"[kernels] shard routes: {checked} cases of 3f and 3L on PE "
        f"intervals (and their collectives against the unsharded push) "
        f"equal the plain versions bit for bit; {empty} empty and {padded} "
        f"padded intervals met")
    return checked, worst


def phase_kernels(torch):
    from repro_torch.kernels import edge_block as eb
    from repro_torch.kernels import push_ell as pe
    from repro_torch.kernels.ref import GATHER_OPS, PAD, REDUCE_OPS, _identity
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    live_rng = np.random.default_rng(1)     # kernel 2's block flags
    checked = 0
    worst = {"edge_block": 0.0, "edge_block_skip": 0.0, "push_ell": 0.0}
    # (R, W, V, block_rows of kernel 2): R is never a multiple of it
    for R, W, V, br in ((1037, 8, 4099, 128), (1, 8, 33, 128),
                        (300, 16, 97, 32), (5, 1, 7, 2)):
        nb = -(-R // br)
        lives = [torch.as_tensor(live_rng.random(nb) < 0.5).to(dev),
                 torch.zeros(nb, dtype=torch.bool, device=dev),
                 torch.ones(nb, dtype=torch.bool, device=dev)]
        nbr = rng.integers(0, V, (R, W)).astype(np.int32)
        nbr[rng.random((R, W)) < 0.3] = PAD
        wgt = rng.uniform(0, 4, (R, W)).astype(np.float32)
        deg = rng.integers(0, 9, V).astype(np.int32)
        act = rng.random(V) < 0.5
        for dtype in (np.int32, np.float32):
            for nan in ((False, True) if dtype == np.float32 else (False,)):
                vals = (rng.integers(-50, 50, V) if dtype == np.int32
                        else rng.uniform(-5, 5, V)).astype(dtype)
                if nan:
                    vals[rng.integers(0, V, max(V // 10, 1))] = np.nan
                t = [torch.as_tensor(a).to(dev)
                     for a in (nbr, wgt, vals, deg, act)]
                for gather in GATHER_OPS:
                    if gather == "div_deg" and dtype == np.int32:
                        continue
                    for reduce in REDUCE_OPS:
                        for mask in (True, False):
                            kw = dict(gather=gather, reduce=reduce,
                                      mask_inactive=mask)
                            tag = (f"{gather}/{reduce}/{dtype.__name__}/"
                                   f"mask={mask}/nan={nan} R={R} W={W} "
                                   f"V={V}")
                            got = eb.edge_block_reduce(*t, **kw)
                            want = eb.edge_block_reduce_plain(*t, **kw)
                            torch.cuda.synchronize()
                            exact = not (dtype == np.float32
                                         and reduce == "add")
                            ok = (_same if exact else _close)(got[0], want[0])
                            if not ok or not _same(got[1], want[1]):
                                raise AssertionError(
                                    f"edge_block {tag}: max err "
                                    f"{_max_err(got[0], want[0])}")
                            worst["edge_block"] = max(
                                worst["edge_block"],
                                _max_err(got[0], want[0]))
                            checked += 1
                            # kernel 2: a dead block is the identity, a
                            # live one kernel 1's row, exactly
                            ident = _identity(reduce, got[0].dtype)
                            for live in lives:
                                sk = eb.edge_block_reduce(
                                    *t, **kw, block_live=live, block_rows=br)
                                plain = eb.edge_block_reduce_plain(
                                    *t, **kw, block_live=live, block_rows=br)
                                dead = ~live.repeat_interleave(br)[:R]
                                k1 = (torch.where(dead, ident, got[0]),
                                      got[1] & ~dead)
                                torch.cuda.synchronize()
                                if not (_same(sk[0], k1[0])
                                        and _same(sk[1], k1[1])
                                        and _same(sk[1], plain[1])
                                        and (_same if exact else _close)(
                                            sk[0], plain[0])):
                                    raise AssertionError(
                                        f"edge_block_skip {tag} br={br}: max "
                                        f"err {_max_err(sk[0], plain[0])}")
                                worst["edge_block_skip"] = max(
                                    worst["edge_block_skip"],
                                    _max_err(sk[0], plain[0]))
                                checked += 1
                    src = torch.as_tensor(
                        rng.integers(0, V, R).astype(np.int32)).to(dev)
                    got = pe.push_ell_message_block(
                        t[0], t[1], src, t[2], t[3], gather=gather)
                    want = pe.push_ell_message_block_plain(
                        t[0], t[1], src, t[2], t[3], gather=gather)
                    torch.cuda.synchronize()
                    if not _same(got, want):
                        raise AssertionError(
                            f"push_ell {gather}/{dtype.__name__}/nan={nan} "
                            f"C={R} W={W}: max err {_max_err(got, want)}")
                    checked += 1
    n_seg, worst["segment_reduce"] = _check_segment_kernel(torch, live_rng)
    n_push, worst["push_ell_fused"] = _check_fused_push(torch, live_rng)
    n_lane, worst["edge_block_lanes"] = _check_lane_kernel(torch, live_rng)
    n_fold, n_lpush, worst["edge_block_fold"], worst["push_ell_lanes"] = \
        _check_lane_routes(torch, live_rng)
    n_skip, worst["edge_block_lanes_skip"] = _check_lane_skip(torch,
                                                               live_rng)
    n_stream, worst["stream_routes"] = _check_stream_routes(torch, live_rng)
    n_add, worst["stream_add_fold"] = _check_add_fold(torch, live_rng)
    n_shard, worst["shard_routes"] = _check_shard_routes(torch, live_rng)
    n_tie = _check_tie_routes(torch, live_rng)
    checked += n_seg + n_push + n_lane + n_fold + n_lpush + n_skip \
        + n_stream + n_add + n_shard + n_tie
    n_dec, worst["decode_gqa"] = _check_decode_kernel(torch)
    n_split, split_err = _check_decode_splits(torch)
    worst["decode_gqa"] = max(worst["decode_gqa"], split_err)
    checked += n_dec + n_split
    log(f"[kernels] {checked} kernel/plain comparisons agree (min/max/int "
        "exact, float add rtol 1e-5; kernel 2 also exactly equal to kernel "
        "1's rows with dead blocks set to the identity, the lane-axis "
        "kernel to kernel 1 on each lane alone and its float add within "
        "1e-5 of the sum of |terms|; kernel 5 float32 "
        f"rtol 1e-4 atol 1e-5, bf16 rtol 1e-2 atol 1e-3 max|out|); max abs "
        f"err {worst}")
    return worst


ANALYSIS_CHAIN = 120        # the coincidence program's chain (values < 2**31)
ANALYSIS_SCALE = 12         # the evader's R-MAT graph
ANALYSIS_BATCH = 8          # the evader's run_batch lanes


def _adversarial_programs(torch, dsl):
    """The programs built to fool the sampling probes (the JAX package's
    ``tests/test_analysis.py``), and one the tracer cannot follow."""
    def host_gather(v, w, d):
        if bool(v.sum() >= 0):           # data-dependent Python control
            return v + 1
        return v

    def host_coincidence(v, w, d):
        if bool((v < 100).all()):        # untraceable; plus_one on the
            return v + 1                 # probe batch, v * 2 from 100 up
        return torch.where(v < 100, v + 1, v * 2)

    return {
        # elementwise on every probe batch; a cross-lane flip once the
        # table's sum passes 1e6 (a (k, V) batch of lanes gets there)
        "evader": dsl.VertexProgram(
            name="evader", gather=lambda v, w, d: v + 1, reduce="min",
            apply=lambda old, s: torch.where(
                old.sum() > 1e6, torch.flip(s, (0,)), torch.minimum(old, s)),
            init_value=100.0, frontier="changed", value_dtype=torch.float32),
        # plus_one on the probe batch by coincidence, v * 2 from 100 up
        "coincidence": dsl.VertexProgram(
            name="coincidence",
            gather=lambda v, w, d: torch.where(v < 100, v + 1, v * 2),
            reduce="min", apply=torch.minimum, init_value=2**20,
            frontier="changed", value_dtype=torch.int32),
        "untraceable": dsl.VertexProgram(
            name="untraceable", gather=host_gather, reduce="min",
            apply=torch.minimum, init_value=2**20, frontier="changed",
            value_dtype=torch.int32),
        # the coincidence again, where the tracer cannot follow it: its
        # module fact is the probe's plus_one
        "untraceable_coincidence": dsl.VertexProgram(
            name="untraceable_coincidence", gather=host_coincidence,
            reduce="min", apply=torch.minimum, init_value=2**20,
            frontier="changed", value_dtype=torch.int32),
    }


def _coincidence_replay(V):
    """The coincidence program on the chain 0 → 1 → … → V-1 from root 0,
    superstep by superstep in numpy (int64, then checked to fit int32)."""
    val = np.full(V, 2**20, np.int64)
    val[0] = 0
    active = np.zeros(V, bool)
    active[0] = True
    while active.any():
        src = np.flatnonzero(active[:-1])
        msg = np.full(V, np.iinfo(np.int32).max, np.int64)
        msg[src + 1] = np.where(val[src] < 100, val[src] + 1, val[src] * 2)
        new = np.minimum(val, msg)
        active = new != val
        val = new
    if val.max() >= 2**31:
        raise AssertionError("the chain's values leave int32")
    return val.astype(np.int32)


def phase_analysis(torch, dev_info):
    """The static analysis tier on the card's host, and the two programs
    it now routes differently: see the module docstring (step 4)."""
    from repro_torch.core import analysis, dsl
    from repro_torch.core import graph as G
    from repro_torch.core.scheduler import DirectionPolicy, ScheduleConfig
    from repro_torch.core.translator import translate

    smi = dev_info["smi"]
    progs = {name: factory() for name, factory in
             sorted(dsl.PROGRAM_TEMPLATES.items())}
    progs.update(_adversarial_programs(torch, dsl))
    # the process's first trace pays make_fx's imports and the menu's
    # signatures once
    analysis.analysis_cache_clear()
    t0 = time.perf_counter()
    analysis.analyze_program(progs["bfs"])
    first_s = time.perf_counter() - t0
    facts, seconds = {}, {}
    for name, prog in progs.items():
        analysis.analysis_cache_clear()
        t0 = time.perf_counter()
        res = analysis.analyze_program(prog)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        if analysis.analyze_program(prog) is not res:
            raise AssertionError(f"{name}: the analysis was not cached")
        seconds[name] = (cold, time.perf_counter() - t0)
        facts[name] = {"facts": res.summary(),
                       "codes": [d.code for d in res.diagnostics]}
        log(f"[analysis] {name}: {res.summary()} codes "
            f"{facts[name]['codes']}; cold {cold:.4f} s, cached "
            f"{seconds[name][1] * 1e6:.1f} us")
    want = {
        "evader": ("elementwise", (False, "static"), "A002"),
        "coincidence": ("gather_module", (None, "static"), "A002"),
        "untraceable": ("gather_module", ("plus_one", "probed"), "A001"),
        "untraceable_coincidence": ("gather_module", ("plus_one", "probed"),
                                    "A001"),
    }
    for name, (prop, fact, code) in want.items():
        got = facts[name]
        if got["facts"][prop] != fact or code not in got["codes"]:
            raise AssertionError(f"{name}: {prop} {got['facts'][prop]} "
                                 f"codes {got['codes']}")
    for name in dsl.PROGRAM_TEMPLATES:
        if {p for _, p in facts[name]["facts"].values()} != {"static"}:
            raise AssertionError(f"{name}: a fact not static: {facts[name]}")
    log(f"[analysis] first analysis in the process (make_fx's imports, the "
        f"menu's signatures) {first_s:.3f} s; cold analysis per program "
        f"{min(c for c, _ in seconds.values()):.4f}–"
        f"{max(c for c, _ in seconds.values()):.4f} s on the host of "
        f"{smi}")

    # ---- the coincidence program on the card, traced (module None) and
    # untraceable (module fact probed): no menu kernel may evaluate it
    # (the kernels' plus_one would give vertex 101 the value 101); the
    # sparse backend runs the user's gather
    V = ANALYSIS_CHAIN
    src = np.arange(V - 1, dtype=np.int32)
    chain = G.from_edge_list(src, src + 1, num_vertices=V)
    want_v = _coincidence_replay(V)
    coinc = {}
    for name, mode in ((n, m) for n in ("coincidence",
                                        "untraceable_coincidence")
                       for m in ("pull", "push", "auto")):
        prog = translate(progs[name], chain, ScheduleConfig(
            direction=DirectionPolicy(mode=mode)), device="cuda")
        _zero_counts()
        v, it = prog.run(roots=0)
        torch.cuda.synchronize()
        launches = _read_counts()
        got = v.cpu().numpy()
        if not np.array_equal(got, want_v) or int(got[101]) != 200 \
                or prog.report.gather_module is not None \
                or any(launches.values()):
            raise AssertionError(
                f"{name} {mode}: vertex 101 = {int(got[101])} (want "
                f"200), equal to the numpy replay: "
                f"{np.array_equal(got, want_v)}; module "
                f"{prog.report.gather_module}; launches {launches}")
        coinc[f"{name}/{mode}"] = {
            "iters": it, "backend": prog.report.backend,
            "analysis_s": prog.report.translate_breakdown["analysis_s"]}
    log(f"[analysis] coincidence, traced and untraceable (module fact "
        f"probed), on a {V}-vertex chain under pull, push and auto on the "
        f"card: = the numpy replay bit for bit (vertex 101 = 200, vertex "
        f"{V - 1} = {int(want_v[-1])}), gather module None, backend "
        f"{coinc['untraceable_coincidence/auto']['backend']}, no menu "
        f"kernel launched; {json.dumps(coinc)}")

    # ---- the evader in a batch of lanes: its apply runs lane by lane
    Vg = 1 << ANALYSIS_SCALE
    s_, d_ = G.rmat_edges(Vg, 16 * Vg, seed=3)
    g = G.from_edge_list(s_, d_, num_vertices=Vg)
    deg = g.out_degrees.numpy()
    roots = np.random.default_rng(0).choice(np.flatnonzero(deg > 0),
                                            ANALYSIS_BATCH, replace=False)
    ev = progs["evader"]
    prog = translate(ev, g, device="cuda")
    _zero_counts()
    vb, ib = prog.run_batch(roots)
    torch.cuda.synchronize()
    launches = _read_counts()
    for i, r in enumerate(roots):
        v, it = prog.run(roots=int(r))
        if not (torch.equal(vb[i], v) and int(ib[i]) == it):
            raise AssertionError(f"evader lane {i} (root {r}) != its "
                                 "sequential run")
    if launches["edge_block_fold"] + launches["push_ell_lanes"] <= 0:
        raise AssertionError(f"evader run_batch launched no lane kernel: "
                             f"{launches}")
    # the same apply on the whole (k, V) batch is not the lanes' results:
    # at the lanes' init values (100 a vertex) the batch's sum passes 1e6
    old = torch.full_like(vb, 100.0)
    batched = ev.apply(old, vb)
    per_lane = torch.stack([ev.apply(old[i], vb[i])
                            for i in range(len(roots))])
    if torch.equal(batched, per_lane):
        raise AssertionError("the evader's apply batches over lanes")
    log(f"[analysis] evader run_batch over {len(roots)} roots at scale "
        f"{ANALYSIS_SCALE}: each lane = its sequential run bitwise (iters "
        f"{ib.tolist()}); the apply ran lane by lane (on the (k, V) batch "
        f"it flips the lanes); launches {launches}")
    summary = {"facts": facts, "seconds": seconds, "first_s": first_s,
               "coincidence": coinc, "evader_launches": launches,
               "card": smi}
    with open(os.path.join(OUT_DIR, "chip_smoke_analysis.json"), "w") as f:
        json.dump(summary, f, indent=1, default=str)
    return summary


def _time_ms(torch, fn, reps=30, warmup=3, batch=1):
    """Median CUDA-event milliseconds of one call after ``warmup``, over
    ``reps`` samples of ``batch`` calls back to back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return float(np.median(times))


def _device_ms(torch, fn, name, calls=10):
    """Device milliseconds of one call of ``fn``: over the kernels whose
    name holds ``name`` (a call may launch several, as kernel 5's split
    and combine kernels or kernel 1's pre-pass and main kernel), the sum
    of each kernel's mean over the launches torch.profiler recorded in
    ``calls`` calls (it may drop some; ``None`` when it kept none), times
    its launches a call where a name launches more than once a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kept = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key
            and e.count]
    return (sum(e.self_device_time_total / e.count
                * max(1, round(e.count / calls)) for e in kept) / 1e3
            if kept else None)


def _profile_run(torch, prog, run_wall_s, label):
    """Device time by op over one BFS run (torch.profiler), and the idle
    share of the unprofiled run wall that the kernels leave."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prog.run(roots=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prog.run(roots=0)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: e.self_device_time_total, reverse=True)
    top = [(e.key, round(e.self_device_time_total / 1e3, 4), e.count)
           for e in ops[:10]]
    idle = 1.0 - busy_ms / (1e3 * run_wall_s)
    # in-place scatters: the plain push combine (the dense fallback's
    # hub fold is the out-of-place aten::scatter_reduce)
    scatters = sum(e.count for e in events
                   if e.key == "aten::scatter_reduce_")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_bfs_{label}.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=40))
    log(f"[profile] bfs {label}: kernel time {busy_ms:.3f} ms of the "
        f"{run_wall_s * 1e3:.2f} ms run wall (device idle share "
        f"{idle:.3f}); aten::scatter_reduce_ calls {scatters}; top ops by "
        f"device ms (ms, calls): {top}")
    return {"kernel_ms": busy_ms, "idle_share": idle, "top_ops": top,
            "scatter_reduce_calls": scatters}


def numpy_bfs(offsets, dst, root, V):
    """Level-synchronous BFS on a CSR, independent of the port."""
    level = np.full(V, INT_MAX, np.int64)
    level[root] = 0
    frontier = np.array([root], np.int64)
    d = 0
    while frontier.size:
        starts, ends = offsets[frontier], offsets[frontier + 1]
        counts = ends - starts
        total = int(counts.sum())
        base = np.repeat(starts - np.concatenate([[0], np.cumsum(counts)[:-1]]),
                         counts)
        nb = dst[base + np.arange(total)]
        nb = np.unique(nb[level[nb] == INT_MAX])
        d += 1
        level[nb] = d
        frontier = nb
    return level


def _counters():
    """Each kernel wrapper's launch count: name → (function, attribute)."""
    from repro_torch.kernels import edge_block as eb
    from repro_torch.kernels import push_ell as pe
    from repro_torch.kernels import decode_gqa as dg
    from repro_torch.kernels import segment_sum as ss
    return {"edge_block": (eb.edge_block_reduce, "launches"),
            "edge_block_skip": (eb.edge_block_reduce, "skip_launches"),
            "edge_block_lanes": (eb.edge_block_reduce_lanes,
                                 "lane_launches"),
            "edge_block_fold": (eb.edge_block_fold_lanes, "launches"),
            "edge_block_fold_acc": (eb.edge_block_fold_lanes,
                                    "accumulate_launches"),
            "edge_block_fold_skip": (eb.edge_block_fold_lanes,
                                     "skip_launches"),
            "edge_block_lanes_skip": (eb.edge_block_reduce_lanes,
                                      "skip_launches"),
            "push_lanes_touched": (pe.push_lanes_touched, "launches"),
            "edge_block_add_fold": (eb.edge_block_add_fold_lanes,
                                    "launches"),
            "edge_block_prepare": (eb.edge_block_prepare, "launches"),
            "lanes_prepare": (eb.lanes_prepare, "launches"),
            "lane_block_words": (eb.lane_block_words, "launches"),
            "push_lanes_prepare": (pe.push_lanes_prepare, "launches"),
            "push_ell": (pe.push_ell_message_block, "launches"),
            "push_ell_fused": (pe.push_ell_fused_reduce, "launches"),
            "push_ell_lanes": (pe.push_ell_lanes_reduce, "launches"),
            "segment_reduce": (ss.segment_reduce, "launches"),
            "decode_gqa": (dg.decode_gqa, "launches"),
            "decode_gqa_softcap": (dg.decode_gqa, "softcap_launches")}


def _zero_counts():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def _read_counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


def _bfs_runs(torch, g, oracle, label, **kw):
    """``algorithms.bfs`` from root 0 under pull, push and auto, each held
    against the numpy oracle, with its launch counts (set to 0 just
    before the run, read just after)."""
    from repro_torch.core import algorithms as alg
    results = {}
    for direction in ("pull", "push", "auto"):
        _zero_counts()
        t1 = time.perf_counter()
        levels, iters, rep = alg.bfs(g, root=0, direction=direction,
                                     device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = _read_counts()
        lv = levels.cpu().numpy()
        if not np.array_equal(lv.astype(np.int64), oracle):
            raise AssertionError(
                f"bfs {label} {direction} disagrees with the numpy oracle at "
                f"{int((lv != oracle).sum())} vertices")
        results[direction] = {"levels": lv, "iters": iters, "rep": rep,
                              "launches": launches, "wall": wall}
        bd = {k: round(v, 3) if isinstance(v, float) else v
              for k, v in rep.translate_breakdown.items()}
        log(f"[main] bfs {label} {direction}: iters={iters} "
            f"backend={rep.backend} pull_sweep={rep.pull_sweep} "
            f"push_layout={rep.push_layout} first call {wall:.2f} s "
            f"(translate {rep.translate_time_s:.2f} s: {json.dumps(bd)}) "
            f"launches={launches} run_stats={json.dumps(rep.run_stats)}")
    return results


def _steady(torch, g, schedules, traversed, smi, repeats=3):
    """Steady run walls (layouts cached, kernels loaded) of the BFS
    programs ``{label: ScheduleConfig}``, one warm-up each, then runs in
    turns; median of ``repeats``.  Returns ``{label: {...}}``."""
    from repro_torch.core import dsl
    from repro_torch.core.translator import translate
    progs = {k: translate(dsl.bfs_program(INT_MAX), g, cfg, device="cuda")
             for k, cfg in schedules.items()}
    walls = {k: [] for k in progs}
    for prog in progs.values():
        prog.run(roots=0)
    for _ in range(repeats):
        for k, prog in progs.items():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, iters = prog.run(roots=0)
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t1)
    out = {}
    for k, prog in progs.items():
        w = float(np.median(walls[k]))
        st = prog.last_run_stats
        iters = st["push_supersteps"] + st["pull_supersteps"]
        out[k] = {"run_wall_s": w, "walls_s": walls[k], "iters": iters,
                  "ms_per_superstep": 1e3 * w / iters,
                  "mteps": traversed / w / 1e6,
                  "syncs_per_run": prog.last_run_syncs,
                  "run_stats": prog.last_run_stats, "prog": prog}
        log(f"[main] bfs {k} steady: run wall {w * 1e3:.3f} ms (runs "
            f"{[round(x * 1e3, 3) for x in walls[k]]}), {iters} supersteps, "
            f"{1e3 * w / iters:.3f} ms/superstep, MTEPS "
            f"{traversed / w / 1e6:.1f}, {prog.last_run_syncs} device→host "
            f"reads a run, on {smi}")
    return out


def _frontier_live_blocks(torch, lay, g, level_mask, grid_br=128):
    """The bitmap plane's kernel-path block flags for a frontier: its
    touched table (capacity = the frontier's forward-ELL rows), owners per
    sub-row, ``grid_br`` sub-rows a flag."""
    from repro_torch.kernels import pull_bitmap as pb
    fe = lay.on(lay.forward_ell(8), "cuda")
    pplan = lay.on(lay.pull_plan(64), "cuda")
    active = torch.as_tensor(level_mask).to("cuda")
    cap = max(int(torch.where(active, fe.rows_per_vertex, 0).sum()), 1)
    touched = pb.touched_table(fe.row_src, fe.dst, active,
                               num_rows=fe.num_rows, capacity=cap,
                               num_vertices=g.num_vertices)
    return active, pb.grid_block_live(touched, pplan.owner8, grid_br)


def _fused_push_timing(torch, fe, values, out_deg, sel, ok, label, smi):
    """The fused push kernel (bfs's plus_one/min) on compacted rows
    ``sel``/``ok`` of the forward ELL: held against its plain version and
    the two-stage path it replaces (the message kernel, then the
    ``where``/``full``/``scatter_reduce_`` combine, from the gathered
    blocks), exactly, and timed beside them (CUDA events; and the
    profiler's device time of the kernel alone, without the table's
    fill) and beside its bound."""
    from repro_torch.kernels import push_ell as pe
    from repro_torch.kernels.ref import PAD, _identity
    V, W = values.shape[0], fe.dst.shape[1]
    ident = _identity("min", torch.int32)
    kw = dict(gather="plus_one", reduce="min", identity=ident,
              num_vertices=V, dtype=torch.int32)
    args = (sel, ok, fe.row_src, fe.dst, fe.weights, values, out_deg)
    rows = sel.long()
    dst_blk = torch.where(ok[:, None], fe.dst[rows], PAD)
    wgt_blk, src_blk = fe.weights[rows].contiguous(), fe.row_src[rows]

    def two_stage():
        msg = pe.push_ell_message_block(dst_blk, wgt_blk, src_blk, values,
                                        out_deg, gather="plus_one")
        valid = dst_blk != PAD
        segs = torch.where(valid, dst_blk, V).reshape(-1).long()
        flat = torch.where(valid, msg, ident).reshape(-1)
        table = torch.full((V + 1,), ident, dtype=torch.int32,
                           device=values.device)
        return table.scatter_reduce_(0, segs, flat, "amin",
                                     include_self=True)[:V]

    got = pe.push_ell_fused_reduce(*args, **kw)[0]
    want = pe.push_ell_fused_reduce_plain(*args, **kw)[0]
    old = two_stage()
    torch.cuda.synchronize()
    if not (_same(got, want) and _same(got, old)):
        raise AssertionError(f"push_ell_fused disagrees at the {label}")
    ms = _time_ms(torch, lambda: pe.push_ell_fused_reduce(*args, **kw))
    dev_ms = _device_ms(torch, lambda: pe.push_ell_fused_reduce(*args, **kw),
                        "push_ell_fused")
    plain_ms = _time_ms(torch, lambda: pe.push_ell_fused_reduce_plain(
        *args, **kw), reps=20)
    two_ms = _time_ms(torch, two_stage, reps=20)
    # bytes the function must move: the compacted row ids and flags, the
    # live rows' W ids, a source id and value a live row (plus_one reads
    # no weight or degree), and the table written once (its fill; the
    # messages combine into it)
    n_live = int(ok.sum())
    n_valid = int((dst_blk != PAD).sum())
    C = sel.shape[0]
    nbytes = C * 5 + n_live * W * 4 + n_live * 8 + V * 4
    bound = 1e3 * max(nbytes / _BANDWIDTH, n_valid / _SCALAR_OPS)
    log(f"[main] push_ell_fused (plus_one/min) at the {label}: C={C} W={W} "
        f"V={V}, {n_live} live rows, {n_valid} valid slots: {ms:.4f} ms "
        f"with the table's fill (device time of the kernel "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}), "
        f"bound {bound:.4f} ms ({bound / ms:.3f} of it), plain "
        f"{plain_ms:.4f} ms, two-stage (message kernel + scatter_reduce_ "
        f"combine) {two_ms:.4f} ms on {smi}")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": two_ms, "bound_ms": bound, "bytes": nbytes,
            "max_abs_err": _max_err(got, want), "shape": [C, W, V],
            "live_rows": n_live, "valid_slots": n_valid}


def phase_main(torch, dev_info):
    from repro_torch.core import algorithms as alg
    from repro_torch.core import graph as G
    from repro_torch.core import passes
    from repro_torch.core import preprocess
    from repro_torch.core.scheduler import (DirectionPolicy, ScheduleConfig,
                                            push_capacity_tiers)
    from repro_torch.kernels import edge_block as eb
    from repro_torch.kernels import ops
    from repro_torch.kernels import push_ell as pe
    from repro_torch.kernels import segment_sum as ss

    scale, device, smi = SCALE, "cuda", dev_info["smi"]
    V, E = 1 << scale, 16 << scale
    t0 = time.perf_counter()
    src, dst = G.rmat_edges(V, E, seed=0)
    g = G.from_edge_list(src, dst, num_vertices=V)
    del src, dst
    gen_s = time.perf_counter() - t0
    log(f"[main] R-MAT scale {scale}: V={V} E={g.num_edges} built in "
        f"{gen_s:.1f} s")
    offsets = g.edge_offsets.numpy().astype(np.int64)
    oracle = numpy_bfs(offsets, g.edges_dst.numpy(), 0, V)
    deg = np.diff(offsets)
    levels_n = [(k, int((oracle == k).sum()), int(deg[oracle == k].sum()))
                for k in range(int(oracle[oracle < INT_MAX].max()) + 1)]
    log(f"[main] oracle levels (level, vertices, out-edges): {levels_n}")

    # ---- path 1: the dense plane (kernels 1 and 3) ----------------------
    dense = _bfs_runs(torch, g, oracle, "dense", pull_sweep="dense")
    auto_launches = dense["auto"]["launches"]
    # each compacted push superstep (4 at scale 22) runs the fused kernel
    # once, the message kernel no more; the fallback ones run kernel 1
    compacted = dense["auto"]["rep"].run_stats["push_compacted_supersteps"]
    if auto_launches["edge_block"] <= 0 \
            or auto_launches["push_ell_fused"] != compacted \
            or (scale == 22 and compacted != 4) \
            or auto_launches["push_ell"] != 0:
        raise AssertionError(f"dense auto run: want kernel 1 launched, the "
                             f"fused push 4 times and the message kernel "
                             f"never: {auto_launches}")
    traversed = alg.traversed_edges(g, dense["auto"]["levels"])

    # ---- path 2: the bitmap plane (kernel 2) ----------------------------
    bitmap = _bfs_runs(torch, g, oracle, "bitmap", pull_sweep="bitmap")
    for d in ("pull", "push", "auto"):
        if not np.array_equal(bitmap[d]["levels"], dense["pull"]["levels"]):
            raise AssertionError(f"bfs bitmap {d} != bfs dense pull")
    skip_launches = bitmap["pull"]["launches"]["edge_block_skip"]
    if skip_launches <= 0:
        raise AssertionError("kernel 2 never launched on the bitmap pull "
                             f"run: {bitmap['pull']['launches']}")
    rep = bitmap["pull"]["rep"]
    log(f"[main] bitmap plane: tiers {rep.pull_block_tiers} of "
        f"{rep.pull_blocks_total} blocks")

    # steady walls of both planes in turns; the auto resolution's inputs
    perf = _steady(torch, g, {
        f"{plane} {d}": ScheduleConfig(direction=DirectionPolicy(mode=d),
                                       pull_sweep=plane)
        for d in ("pull", "push", "auto") for plane in ("dense", "bitmap")},
        traversed, smi)
    walls_ms = {d: (round(perf[f"dense {d}"]["run_wall_s"] * 1e3, 3),
                    round(perf[f"bitmap {d}"]["run_wall_s"] * 1e3, 3))
                for d in ("pull", "auto")}
    pays = all(b <= dd for dd, b in walls_ms.values())
    log(f"[main] pull_sweep='auto' decision on {smi}: steady walls ms "
        f"(dense, bitmap) {json.dumps(walls_ms)} -> "
        f"{'bitmap' if pays else 'dense'}; passes resolves dense on "
        f"{passes.CUDA_AUTO_SWEEP_NOTE}")

    # the one host read per superstep: the occupancy read on its own
    prog = perf["dense auto"]["prog"]
    active = torch.zeros(V, dtype=torch.bool, device=device)
    active[:: 97] = True
    sync_ms = _time_ms(torch, lambda: prog._occupancy(active), reps=50)
    log(f"[main] host sync (occupancy read) {sync_ms:.4f} ms per superstep; "
        f"dense auto run: {sync_ms * perf['dense auto']['iters']:.3f} ms of "
        f"{perf['dense auto']['run_wall_s'] * 1e3:.2f} ms")
    for k in ("dense pull", "dense auto", "bitmap pull"):
        perf[k]["profile"] = _profile_run(
            torch, perf[k]["prog"], perf[k]["run_wall_s"],
            k.replace(" ", "_"))
    if perf["dense auto"]["profile"]["scatter_reduce_calls"]:
        raise AssertionError("the dense auto run's compacted push "
                             "supersteps still ran scatter_reduce_")

    # ---- each kernel at the main path's shapes --------------------------
    lay = preprocess.layouts_for(g)
    pplan = lay.on(lay.pull_plan(64), device)
    fe = lay.on(lay.forward_ell(8), device)
    out_deg = g.out_degrees.to(device=device, dtype=torch.int32)
    values = torch.as_tensor(dense["auto"]["levels"]).to(device)
    rng = np.random.default_rng(1)
    act = torch.as_tensor(rng.random(V) < 0.5).to(device)
    kw = dict(gather="plus_one", reduce="min", mask_inactive=True)
    args = (pplan.flat_dst, pplan.flat_wgt, values, out_deg, act)
    got = eb.edge_block_reduce(*args, **kw)
    want = eb.edge_block_reduce_plain(*args, **kw)
    torch.cuda.synchronize()
    if not (_same(got[0], want[0]) and _same(got[1], want[1])):
        raise AssertionError("edge_block disagrees with plain at main shape")
    eb_err = _max_err(got[0], want[0])
    R8, W = pplan.flat_dst.shape
    eb_ms = _time_ms(torch, lambda: eb.edge_block_reduce(*args, **kw))
    eb_plain = _time_ms(torch, lambda: eb.edge_block_reduce_plain(*args, **kw),
                        reps=20)
    # bytes the function must move for bfs's gather: ids, the value and
    # frontier tables, the two outputs (weights and degrees are not read)
    eb_bytes = R8 * W * 4 + V * 4 + V * 1 + R8 * 4 + R8 * 1
    eb_ops = 2 * R8 * W
    eb_bound = 1e3 * max(eb_bytes / _BANDWIDTH, eb_ops / _SCALAR_OPS)
    eb_dev = _device_ms(torch, lambda: eb.edge_block_reduce(*args, **kw),
                        "edge_block")
    log(f"[main] edge_block (plus_one/min, R8={R8}, W={W}, V={V}, 50% random "
        f"frontier): {eb_ms:.4f} ms (device time, pre-pass and main kernel "
        f"{'not measured' if eb_dev is None else f'{eb_dev:.4f} ms'}), bound "
        f"{eb_bound:.4f} ms ({eb_bound / eb_ms:.3f} of it), plain "
        f"{eb_plain:.3f} ms, library call none, on {smi}")
    # kernel 1 on each frontier of the BFS, as the dense pull runs it
    eb_levels = {}
    for lvl, _, _ in levels_n:
        largs = args[:4] + (torch.as_tensor(oracle == lvl).to(device),)
        eb_levels[lvl] = _time_ms(torch, lambda: eb.edge_block_reduce(
            *largs, **kw), reps=20)
    log(f"[main] edge_block on the BFS frontiers, ms by level: "
        f"{json.dumps({k: round(v, 4) for k, v in eb_levels.items()})}; "
        f"sum {sum(eb_levels.values()):.4f} ms on {smi}")

    # kernel 2 on three frontiers of the BFS: the root (first superstep),
    # the last frontier the plane routes to kernel 2, the widest one
    caps = rep.pull_block_tiers
    narrow = [k for k, n, m in levels_n if 0 < m <= caps[1]]
    widest = max(levels_n, key=lambda t: t[1])[0]
    skip = {}
    for label, lvl in (("root", 0), ("narrow", narrow[0] if narrow else 0),
                       ("widest", widest)):
        front, live = _frontier_live_blocks(torch, lay, g, oracle == lvl)
        sargs = (pplan.flat_dst, pplan.flat_wgt, values, out_deg, front)
        skw = dict(kw, block_live=live, block_rows=128)
        got = eb.edge_block_reduce(*sargs, **skw)
        want = eb.edge_block_reduce_plain(*sargs, **skw)
        full = eb.edge_block_reduce(*sargs, **kw)
        torch.cuda.synchronize()
        if not (_same(got[0], want[0]) and _same(got[1], want[1])
                and _same(got[0], full[0]) and _same(got[1], full[1])):
            raise AssertionError(f"edge_block_skip disagrees at main shape "
                                 f"({label} frontier)")
        n_live, nb = int(live.sum()), live.shape[0]
        ms = _time_ms(torch, lambda: eb.edge_block_reduce(*sargs, **skw),
                      reps=20)
        dev_ms = _device_ms(torch, lambda: eb.edge_block_reduce(
            *sargs, **skw), "edge_block")
        plain_ms = _time_ms(torch, lambda: eb.edge_block_reduce_plain(
            *sargs, **skw), reps=20)
        # ids of live blocks only, the value and frontier tables, the
        # flags, the two outputs over all rows
        nbytes = n_live * 128 * W * 4 + V * 5 + R8 * 5 + nb
        nops = 2 * n_live * 128 * W
        bound = 1e3 * max(nbytes / _BANDWIDTH, nops / _SCALAR_OPS)
        skip[label] = {"level": lvl, "live_blocks": n_live, "blocks": nb,
                       "live_share": n_live / nb, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound,
                       "device_ms": dev_ms,
                       "max_abs_err": _max_err(got[0], want[0])}
        log(f"[main] edge_block_skip on the level-{lvl} ({label}) frontier: "
            f"{n_live}/{nb} grid blocks live (share {n_live / nb:.4f}); "
            f"{ms:.4f} ms (device time "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}; "
            f"kernel 1 on the same rows {eb_ms:.4f} ms), plain "
            f"{plain_ms:.3f} ms, bound {bound:.4f} ms, library call none, on "
            f"{smi}")

    tiers = push_capacity_tiers(fe.num_rows)
    C = tiers[-1]
    rows = fe.rows_per_vertex.long()
    frontier = torch.zeros(V, dtype=torch.bool, device=device)
    order = torch.as_tensor(rng.permutation(V)).to(device)
    cum = torch.cumsum(rows[order], 0)
    frontier[order[cum <= C]] = True
    live = frontier[fe.row_src.long()]
    sel, ok = pe.compact_rows(live, fe.num_rows, C)
    dst_blk = torch.where(ok[:, None], fe.dst[sel.long()], 2**31 - 1)
    wgt_blk = fe.weights[sel.long()].contiguous()
    src_blk = fe.row_src[sel.long()]
    pargs = (dst_blk, wgt_blk, src_blk, values, out_deg)
    got = pe.push_ell_message_block(*pargs, gather="plus_one")
    want = pe.push_ell_message_block_plain(*pargs, gather="plus_one")
    torch.cuda.synchronize()
    if not _same(got, want):
        raise AssertionError("push_ell disagrees with plain at main shape")
    pe_err = _max_err(got, want)
    pe_ms = _time_ms(torch, lambda: pe.push_ell_message_block(
        *pargs, gather="plus_one"))
    pe_plain = _time_ms(torch, lambda: pe.push_ell_message_block_plain(
        *pargs, gather="plus_one"), reps=20)
    # source ids, one source value per row, the messages out
    pe_bytes = C * 4 + C * 4 + C * W * 4
    pe_bound = 1e3 * max(pe_bytes / _BANDWIDTH, C * W / _SCALAR_OPS)
    fused = _fused_push_timing(torch, fe, values, out_deg, sel, ok,
                               "random frontier", smi)
    fused["launches"] = auto_launches["push_ell_fused"]
    # the same on each compacted push superstep of the BFS from root 0:
    # the frontier of that level, the state the BFS holds then, its tier
    lv_all = torch.as_tensor(oracle.astype(np.int64)).to(device)
    fused_levels = {}
    for lvl, _, _ in levels_n:
        front = lv_all == lvl
        r_f = int(torch.where(front, rows, 0).sum())
        tier = next((c for c in tiers if r_f <= c), None)
        if tier is None:
            continue                        # the dense fallback's superstep
        state = torch.where(lv_all <= lvl, lv_all, INT_MAX).to(torch.int32)
        lsel, lok = pe.compact_rows(front[fe.row_src.long()], fe.num_rows,
                                    tier)
        fused_levels[lvl] = _fused_push_timing(
            torch, fe, state, out_deg, lsel, lok,
            f"BFS level-{lvl} frontier (r_f {r_f}, tier {tier})", smi)
    if len(fused_levels) != auto_launches["push_ell_fused"]:
        raise AssertionError(f"compacted levels {sorted(fused_levels)} != "
                             f"the fused launches of the dense auto run")
    by_level = {k: (round(v["ms"], 4), round(v["library_ms"], 4))
                for k, v in fused_levels.items()}
    log(f"[main] push_ell_fused on the BFS's compacted supersteps, ms by "
        f"level (fused, two-stage): {json.dumps(by_level)}; "
        f"sum {sum(v['ms'] for v in fused_levels.values()):.4f} ms against "
        f"{sum(v['library_ms'] for v in fused_levels.values()):.4f} ms on "
        f"{smi}")

    # ---- path 3: the sparse backend, and kernel 4's entry point ----------
    sparse = phase_sparse(torch, g, oracle, traversed, smi)
    seg, rsrc, _ = lay.on(lay.reverse_coo(), device)
    lv_t = torch.as_tensor(oracle.astype(np.int32)).to(device)
    msgs = lv_t[rsrc.long()] + 1             # bfs's plus_one messages
    _zero_counts()
    red = ops.segment_reduce(seg, msgs, V, reduce="min")
    torch.cuda.synchronize()
    seg_launches = _read_counts()["segment_reduce"]
    # BFS: a reached vertex's level is 1 + the least level of its
    # in-neighbours (the root excepted)
    reached = torch.as_tensor((oracle < INT_MAX) & (np.arange(V) != 0))
    if seg_launches != 1 or not torch.equal(
            red.cpu()[reached], lv_t.cpu()[reached]):
        raise AssertionError(f"ops.segment_reduce path: launches "
                             f"{seg_launches}, or min-of-messages != levels")
    want = ss.segment_reduce_ref(seg, msgs, V, reduce="min")
    torch.cuda.synchronize()
    if not _same(red, want):
        raise AssertionError("segment_reduce disagrees with plain at main "
                             "shape")
    seg_err = _max_err(red, want)
    seg_ms = _time_ms(torch, lambda: ss.segment_reduce(seg, msgs, V,
                                                       reduce="min"), reps=20)
    seg_dev = {k: _device_ms(torch, lambda: ss.segment_reduce(
        seg, msgs, V, reduce="min"), k)
        for k in ("segment_fill", "segment_tile", "segment_fold")}
    seg_plain = _time_ms(torch, lambda: ss.segment_reduce_ref(
        seg, msgs, V, reduce="min"), reps=20)
    # the library call: an identity-filled table's amin scatter (amin is
    # idempotent, so the repeated calls need no fresh table)
    seg64 = seg.long()
    table = torch.full((V,), 2**31 - 1, dtype=torch.int32, device=device)
    seg_lib = _time_ms(torch, lambda: table.scatter_reduce_(
        0, seg64, msgs, "amin", include_self=True), reps=20)
    if not torch.equal(table, red):
        raise AssertionError("scatter_reduce_ amin != segment_reduce")
    in_deg = np.bincount(g.edges_dst.numpy(), minlength=V)
    Es = int(seg.shape[0])
    seg_bytes = Es * 8 + V * 4
    seg_bound = 1e3 * max(seg_bytes / _BANDWIDTH, Es / _SCALAR_OPS)
    dev_txt = ", ".join(f"{k} {'not measured' if v is None else f'{v:.4f}'}"
                        for k, v in seg_dev.items())
    log(f"[main] segment_reduce (min, E={Es}, V={V}, largest segment "
        f"{int(in_deg.max())} elements, {-(-Es // ss.TILE)} tiles): "
        f"{seg_ms:.4f} ms (device ms of its launches: {dev_txt}), plain "
        f"{seg_plain:.4f} ms, scatter_reduce_ amin {seg_lib:.4f} ms, bound "
        f"{seg_bound:.4f} ms ({seg_bound / seg_ms:.3f} of it); "
        f"ops.segment_reduce launches {seg_launches} on {smi}")

    sk = skip["narrow"]
    kernels = [
        {"name": "edge_block_reduce", "route": "cuda",
         "source": "src/repro_torch/csrc/edge_block.cu",
         "replaces": "src/repro/kernels/edge_block.py:33",
         "launches": auto_launches["edge_block"], "max_abs_err": eb_err,
         "ms": eb_ms, "plain_ms": eb_plain, "bound_ms": eb_bound,
         "bound_by": "bytes" if eb_bytes / _BANDWIDTH
         >= eb_ops / _SCALAR_OPS else "operations",
         "library_ms": None, "shape": [R8, W, V]},
        {"name": "edge_block_reduce_skip", "route": "cuda",
         "source": "src/repro_torch/csrc/edge_block.cu",
         "replaces": "src/repro/kernels/edge_block.py:58",
         "launches": skip_launches, "max_abs_err": sk["max_abs_err"],
         "ms": sk["ms"], "plain_ms": sk["plain_ms"],
         "bound_ms": sk["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "shape": [R8, W, V, sk["live_blocks"],
                                       sk["blocks"]]},
        {"name": "push_ell_message_block", "route": "cuda",
         "source": "src/repro_torch/csrc/push_ell.cu",
         "replaces": "src/repro/kernels/push_ell.py:89",
         "launches": auto_launches["push_ell"], "max_abs_err": pe_err,
         "ms": pe_ms, "plain_ms": pe_plain, "bound_ms": pe_bound,
         "bound_by": "bytes", "library_ms": None, "shape": [C, W, V]},
        {"name": "push_ell_fused_reduce", "route": "cuda",
         "source": "src/repro_torch/csrc/push_ell.cu",
         "replaces": "src/repro/kernels/push_ell.py:89",
         "launches": fused["launches"], "max_abs_err": fused["max_abs_err"],
         "ms": fused["ms"], "plain_ms": fused["plain_ms"],
         "bound_ms": fused["bound_ms"], "bound_by": "bytes",
         "library_ms": fused["library_ms"], "shape": fused["shape"]},
        {"name": "segment_reduce", "route": "cuda",
         "source": "src/repro_torch/csrc/segment_sum.cu",
         "replaces": "src/repro/kernels/segment_sum.py:24",
         "launches": seg_launches, "max_abs_err": seg_err,
         "ms": seg_ms, "plain_ms": seg_plain, "bound_ms": seg_bound,
         "bound_by": "bytes", "library_ms": seg_lib, "shape": [Es, V]},
    ]
    per_bfs = {"edge_block_reduce": auto_launches["edge_block"],
               "edge_block_reduce_skip": skip_launches,
               "push_ell_message_block": auto_launches["push_ell"],
               "push_ell_fused_reduce": auto_launches["push_ell_fused"],
               "segment_reduce": dense["auto"]["launches"]["segment_reduce"]}
    for k in kernels:
        log(json.dumps({"kernel": k["name"], "ms": k["ms"],
                        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "library_ms": k["library_ms"],
                        "launches_per_bfs": per_bfs[k["name"]],
                        "shape": k["shape"]}))
    summary = {"scale": scale, "V": V, "E": g.num_edges,
               "graph_build_s": gen_s, "traversed_edges": traversed,
               "oracle_levels": levels_n,
               "perf": {k: {kk: vv for kk, vv in v.items() if kk != "prog"}
                        for k, v in perf.items()},
               "auto_decision_walls_ms": walls_ms, "bitmap_pays": pays,
               "host_sync_ms": sync_ms, "edge_block_skip": skip,
               "edge_block_device_ms": eb_dev,
               "push_ell_fused": fused,
               "push_ell_fused_levels": fused_levels,
               "segment_reduce_device_ms": seg_dev,
               "edge_block_levels_ms": eb_levels,
               "sparse": sparse,
               "launches": {f"{p} {d}": r[d]["launches"]
                            for p, r in (("dense", dense),
                                         ("bitmap", bitmap))
                            for d in r},
               "run_stats": {f"{p} {d}": r[d]["rep"].run_stats
                             for p, r in (("dense", dense),
                                          ("bitmap", bitmap))
                             for d in r},
               "translate_breakdown": dense["pull"]["rep"].translate_breakdown,
               "card": smi}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_main.json"), "w") as f:
        json.dump({"summary": summary, "kernels": kernels}, f, indent=1,
                  default=str)
    return kernels, {"g": g, "oracle": oracle}


SERVE_LANES = (1, 8, 32)    # lane counts the lane routes are timed at


def _lane_timing(torch, g, oracle, smi):
    """The batched masked sweep end to end (bfs's plus_one/min over the
    flat pull view, with got flags) at k = 1, 8 and 32 lanes, on a 50%
    random frontier a lane and on root 0's BFS frontiers (lane i takes
    level i mod 6): the fused lane sweep (the identity and zero fills and
    one launch of pre-pass and fold) against the route it replaces (the
    lane-axis kernel 1L, then ``subrow_combine`` of its values and of its
    flags), held exactly against it and against the plain version, and
    timed (CUDA events; the profiler's device time of the pre-pass and
    fold kernels, and of 1L's) beside 1L alone, k launches of kernel 1,
    the plain version and its bound."""
    from repro_torch.core import preprocess
    from repro_torch.kernels import edge_block as eb
    from repro_torch.kernels import pull_bitmap as pb
    lay = preprocess.layouts_for(g)
    pplan = lay.on(lay.pull_plan(64), "cuda")
    out_deg = g.out_degrees.to(device="cuda", dtype=torch.int32)
    V = g.num_vertices
    R8, W = pplan.flat_dst.shape
    levels = torch.as_tensor(np.minimum(oracle, INT_MAX).astype(np.int32))
    frontiers = [torch.as_tensor(oracle == lv)
                 for lv in range(int(oracle[oracle < INT_MAX].max()) + 1)]
    rng = np.random.default_rng(3)
    kw = dict(gather="plus_one", reduce="min", mask_inactive=True)
    ident = INT32_MAX
    rows = {}
    for k in SERVE_LANES:
        values = levels.to("cuda").expand(k, V).contiguous()
        lanes = list(range(k))
        for label in ("random", "bfs"):
            if label == "random":
                active = torch.as_tensor(rng.random((k, V)) < 0.5)
            else:
                active = torch.stack([frontiers[i % len(frontiers)]
                                      for i in range(k)])
            active = active.to("cuda")
            args = (pplan.flat_dst, pplan.flat_wgt, values, out_deg, active)

            def fold(values=values, active=active):
                return eb.edge_block_fold_lanes(pplan, values, out_deg,
                                                active, lanes, **kw)

            def old(args=args):
                sub, sub_any = eb.edge_block_reduce_lanes(*args, **kw)
                red = pb.subrow_combine(sub, pplan, ident, "min",
                                        torch.int32)
                got = pb.subrow_combine(sub_any.to(torch.int8), pplan, 0,
                                        "max", torch.int8) != 0
                return red, got

            new, prev = fold(), old()
            red_shared = torch.full((k, V), ident, dtype=torch.int32,
                                    device="cuda")
            want = eb.edge_block_fold_lanes_plain(pplan, values, out_deg,
                                                  active, lanes, **kw)
            torch.cuda.synchronize()
            if not (_same_bits(new[0], prev[0]) and _same(new[1], prev[1])
                    and _same_bits(new[0], want[0])
                    and _same(new[1], want[1])):
                raise AssertionError(f"edge_block_fold disagrees at the main "
                                     f"shape, k={k}, {label} frontier")
            err = _max_err(new[0], want[0])
            del new, prev, want
            ms = _time_ms(torch, fold, reps=20)
            old_ms = _time_ms(torch, old, reps=10)
            dev_ms = _device_ms(torch, fold, "edge_block_fold") or 0.0
            pack_ms = _device_ms(torch, fold, "lanes_pack")
            old_dev = _device_ms(torch, lambda: eb.edge_block_reduce_lanes(
                *args, **kw), "edge_block_lanes")
            l1_ms = _time_ms(torch, lambda: eb.edge_block_reduce_lanes(
                *args, **kw), reps=10)
            l1 = eb.edge_block_reduce_lanes(*args, **kw)
            l1_want = eb.edge_block_reduce_lanes_plain(*args, **kw)
            torch.cuda.synchronize()
            if not (_same(l1[0], l1_want[0]) and _same(l1[1], l1_want[1])):
                raise AssertionError(f"edge_block_lanes disagrees at the "
                                     f"main shape, k={k}, {label} frontier")
            l1_err = _max_err(l1[0], l1_want[0])
            del l1, l1_want
            l1_plain_ms = _time_ms(
                torch, lambda: eb.edge_block_reduce_lanes_plain(*args, **kw),
                reps=3, warmup=1)
            # 1L's own bound: the ids once, each lane's values and
            # frontier, each lane's two (R8,) outputs
            l1_bound = 1e3 * (R8 * W * 4 + k * V * 5 + k * R8 * 5) \
                / _BANDWIDTH
            # the message table's L2 overflow: the same lanes swept in
            # launches of fewer lanes (K = 4 or 1: a 67 or 17 MB table),
            # pre-pass and fold kernels only (into one filled table, no
            # flags), against one launch of all k
            groups = {}
            for width in (k, 4, 1):
                if width <= k:
                    parts = [lanes[i:i + width]
                             for i in range(0, k, width)]
                    groups[width] = _time_ms(torch, lambda parts=parts: [
                        eb.edge_block_fold_lanes(
                            pplan, values, out_deg, active, part,
                            red=red_shared, need_got=False, **kw)
                        for part in parts], reps=5)

            def kernel1(values=values, active=active):
                return [eb.edge_block_reduce(pplan.flat_dst, pplan.flat_wgt,
                                             values[i], out_deg, active[i],
                                             **kw) for i in range(k)]
            k1_ms = _time_ms(torch, kernel1, reps=5)
            plain_ms = _time_ms(torch, lambda: eb.edge_block_fold_lanes_plain(
                pplan, values, out_deg, active, lanes, **kw), reps=3,
                warmup=1)
            # bytes the function must move: the ids once, owner8, each
            # lane's value table and frontier, each lane's (V,) reduced
            # table and got flags
            nbytes = R8 * W * 4 + R8 * 4 + k * V * (4 + 1) + k * V * (4 + 1)
            ops = k * R8 * W
            bound = 1e3 * max(nbytes / _BANDWIDTH, ops / _SCALAR_OPS)
            live = int(active.sum())
            rows[(k, label)] = {
                "ms": ms, "device_ms": dev_ms, "pack_device_ms": pack_ms,
                "old_ms": old_ms, "old_kernel_ms": l1_ms,
                "old_kernel_device_ms": old_dev, "kernel1_ms": k1_ms,
                "old_kernel_plain_ms": l1_plain_ms,
                "old_kernel_bound_ms": l1_bound,
                "old_kernel_max_abs_err": l1_err,
                "lane_groups_ms": groups,
                "plain_ms": plain_ms, "bound_ms": bound, "bytes": nbytes,
                "max_abs_err": err, "shape": [k, R8, W, V],
                "live_vertices": live}
            log(f"[serve] lane sweep (plus_one/min, got flags) k={k} {label} "
                f"frontier ({live} live lane-vertices): fused "
                f"{ms:.4f} ms (device: fold "
                f"{dev_ms:.4f}, pre-pass "
                f"{'not measured' if pack_ms is None else f'{pack_ms:.4f}'} "
                f"ms) against 1L + subrow_combine {old_ms:.4f} ms "
                f"({old_ms / ms:.2f}x; 1L alone {l1_ms:.4f} ms, device "
                f"{'not measured' if old_dev is None else f'{old_dev:.4f}'})"
                f", {k} x kernel 1 {k1_ms:.4f} ms; bound {bound:.4f} ms "
                f"({bound / ms:.3f} of it, {nbytes / 1e9:.3f} GB), plain "
                f"{plain_ms:.4f} ms; = the old route and = plain, exactly, "
                f"on {smi}")
            log(f"[serve] lane sweep k={k} {label}: 1L alone {l1_ms:.4f} ms "
                f"against its bound {l1_bound:.4f} ms (it also writes the "
                f"(k, R8) partials), its plain version {l1_plain_ms:.4f} ms, "
                f"= plain exactly; the fused sweep's kernels (no fills, no "
                f"flags) in launches of "
                + ", ".join(f"{w} lanes {t:.4f} ms" for w, t in
                            groups.items()) + f", on {smi}")
            del args, active, red_shared
        del values
    torch.cuda.empty_cache()
    return rows


def _push_lane_timing(torch, g, oracle, smi):
    """The lane push (bfs's plus_one/min over the forward ELL) at k = 1, 8
    and 32 lanes, on root 0's BFS frontiers (lane i at level i mod 6) and
    on a random 1% frontier a lane: held exactly against k compacted
    pushes (``compact_rows`` at the tier covering the lane's live rows,
    then the fused push kernel 3f) and the plain version, and timed
    (CUDA events with the table's fill; the profiler's device time of the
    pre-pass and the kernel) beside those k compactions and fused pushes,
    the plain version and its bound."""
    from repro_torch.core import preprocess
    from repro_torch.core.scheduler import push_capacity_tiers
    from repro_torch.kernels import push_ell as pe
    from repro_torch.kernels.ref import PAD
    lay = preprocess.layouts_for(g)
    fe = lay.on(lay.forward_ell(8), "cuda")
    out_deg = g.out_degrees.to(device="cuda", dtype=torch.int32)
    V = g.num_vertices
    R, W = fe.dst.shape
    tiers = push_capacity_tiers(fe.num_rows)
    levels = torch.as_tensor(np.minimum(oracle, INT_MAX).astype(np.int32))
    frontiers = [torch.as_tensor(oracle == lv)
                 for lv in range(int(oracle[oracle < INT_MAX].max()) + 1)]
    rng = np.random.default_rng(4)
    kw = dict(gather="plus_one", reduce="min", identity=INT32_MAX)
    rows = {}
    for k in SERVE_LANES:
        values = levels.to("cuda").expand(k, V).contiguous()
        lanes = list(range(k))
        for label in ("bfs", "random"):
            if label == "random":
                active = torch.as_tensor(rng.random((k, V)) < 0.01)
            else:
                active = torch.stack([frontiers[i % len(frontiers)]
                                      for i in range(k)])
            active = active.to("cuda")
            r_f = torch.where(active, fe.rows_per_vertex, 0).sum(1).tolist()
            caps = [next((c for c in tiers if c >= r), max(r, 1))
                    for r in r_f]
            args = (fe.row_src, fe.dst, fe.weights, values, out_deg, active)

            def lane_push(args=args):
                return pe.push_ell_lanes_reduce(*args, lanes,
                                                num_rows=fe.num_rows, **kw)

            def singles(values=values, active=active, caps=caps):
                return [pe.push_ell_reduce(
                    fe.row_src, fe.dst, fe.weights, values[i], out_deg,
                    active[i], num_rows=fe.num_rows, capacity=caps[i],
                    gather_fn=None, reduce="min", identity=INT32_MAX,
                    num_vertices=V, dtype=torch.int32,
                    gather_module="plus_one", use_kernels=True)[0]
                    for i in range(k)]

            got = lane_push()
            one = torch.stack(singles())
            want = pe.push_ell_lanes_reduce_plain(*args, lanes,
                                                  num_rows=fe.num_rows, **kw)
            torch.cuda.synchronize()
            if not (_same_bits(got, one) and _same_bits(got, want)):
                raise AssertionError(f"push_ell_lanes disagrees at the main "
                                     f"shape, k={k}, {label} frontier")
            err = max(_max_err(got, want), _max_err(got, one))
            del got, one, want
            ms = _time_ms(torch, lane_push, reps=20)
            dev_ms = _device_ms(torch, lane_push, "push_ell_lanes") or 0.0
            pack_ms = _device_ms(torch, lane_push, "lanes_pack")
            k_ms = _time_ms(torch, singles, reps=10)
            plain_ms = _time_ms(torch, lambda: pe.push_ell_lanes_reduce_plain(
                *args, lanes, num_rows=fe.num_rows, **kw), reps=3, warmup=1)
            # bytes the function must move: row_src once, each lane's
            # frontier (the pre-pass) and the bits it packs, written and
            # read, the (k, V) table written once (its fill; the messages
            # combine into it); per live row its W ids, per live
            # (row, lane) the source's value
            live_rows = torch.stack([active[i][fe.row_src[:fe.num_rows]
                                               .long()] for i in lanes])
            n_rows = int(live_rows.any(0).sum())
            n_pairs = int(live_rows.sum())
            valid = (fe.dst[:fe.num_rows] != PAD).sum(1)
            n_slots = int((live_rows.to(torch.int64)
                           * valid[None, :]).sum())
            K = next(w for w in (1, 4, 8, 32) if w >= k)
            nbytes = (fe.num_rows * 4 + k * V + 2 * V * K // 8 + k * V * 4
                      + n_rows * W * 4 + n_pairs * 4)
            bound = 1e3 * max(nbytes / _BANDWIDTH, n_slots / _SCALAR_OPS)
            # the first design's reckoning: one 32-byte DRAM sector a
            # message, its table out of L2
            sector_ms = 1e3 * n_slots * 32 / _BANDWIDTH
            del live_rows
            rows[(k, label)] = {
                "ms": ms, "device_ms": dev_ms, "pack_device_ms": pack_ms,
                "singles_ms": k_ms, "plain_ms": plain_ms, "bound_ms": bound,
                "sector_ms": sector_ms,
                "bytes": nbytes, "max_abs_err": err,
                "shape": [k, R, W, V], "live_rows": n_rows,
                "live_lane_rows": n_pairs, "messages": n_slots,
                "capacities": caps}
            log(f"[serve] lane push (plus_one/min) k={k} {label} frontier "
                f"({n_pairs} live lane-rows, {n_slots} messages): "
                f"{ms:.4f} ms with the table's fill (device: kernel "
                f"{dev_ms:.4f}, pre-pass "
                f"{'not measured' if pack_ms is None else f'{pack_ms:.4f}'} "
                f"ms) against {k} x (compaction + fused push) {k_ms:.4f} ms "
                f"({k_ms / ms:.2f}x; capacities {sorted(set(caps))}); bound "
                f"{bound:.4f} ms ({bound / ms:.3f} of it, "
                f"{nbytes / 1e6:.1f} MB), one sector a message "
                f"{sector_ms:.4f} ms, plain {plain_ms:.4f} ms; = the "
                f"compacted pushes and = plain, exactly, on {smi}")
            del args, active
        del values
    torch.cuda.empty_cache()
    return rows


def _profile_serve(torch, srv, roots, step_ms, smi):
    """Device time by op over one more burst of bfs queries served under
    torch.profiler, per batched superstep, against the unprofiled streams'
    ``step_ms`` a batched superstep (the device idle share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    steps0 = srv.counters()["batched_supersteps"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for r in roots:
            srv.submit("bfs", int(r))
        srv.run()
        torch.cuda.synchronize()
    steps = srv.counters()["batched_supersteps"] - steps0
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA) / 1e3
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: e.self_device_time_total, reverse=True)
    top = [(e.key, round(e.self_device_time_total / 1e3, 4), e.count)
           for e in ops[:10]]
    # the port's own kernels (launched through ctypes, under no aten op)
    lane_kernels = {name: round(sum(
        e.self_device_time_total for e in events
        if e.device_type == DeviceType.CUDA and name in e.key) / 1e3, 4)
        for name in ("lanes_pack", "edge_block_fold", "edge_block_lanes",
                     "push_ell_lanes")}
    per_step = busy_ms / max(steps, 1)
    idle = 1.0 - per_step / step_ms
    with open(os.path.join(OUT_DIR, "profile_serve.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=40))
    log(f"[profile] serve, {len(roots)} bfs in {steps} batched supersteps: "
        f"kernel time {busy_ms:.3f} ms, {per_step:.3f} ms a batched "
        f"superstep of the streams' {step_ms:.3f} ms (device idle share "
        f"{idle:.3f}); top ops by device ms (ms, calls): {top}; the lane "
        f"kernels' device ms: {lane_kernels} on {smi}")
    return {"kernel_ms": busy_ms, "batched_supersteps": steps,
            "kernel_ms_per_step": per_step, "idle_share": idle,
            "top_ops": top, "lane_kernels_ms": lane_kernels}


def phase_serve(torch, dev_info, main):
    """The graph-query server at the main scale: see the module docstring
    (step 6)."""
    import tempfile
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra
    from repro_torch.core import algorithms as alg
    from repro_torch.core import dsl, faults
    from repro_torch.core.scheduler import AdmissionPolicy, ScheduleConfig
    from repro_torch.core.translator import translate
    from repro_torch.errors import InjectedFault
    from repro_torch.kernels import pull_bitmap as pb
    from repro_torch.serve.graph_serve import GraphServer

    g, oracle, smi = main["g"], main["oracle"], dev_info["smi"]
    V = g.num_vertices
    deg = g.out_degrees.numpy()
    rng = np.random.default_rng(0)
    cand = np.flatnonzero(deg > 0)
    admission = AdmissionPolicy(slots=8, slice_supersteps=4)
    t0 = time.perf_counter()
    srv = GraphServer(g, admission=admission, landmarks=4, device="cuda")
    table_s = time.perf_counter() - t0
    lms = srv.table.landmarks
    log(f"[serve] GraphServer(slots=8, slice_supersteps=4, landmarks=4) at "
        f"scale {SCALE}: landmark table (SSSP from {lms.tolist()} on the "
        f"graph and its transpose, run_batch) built in {table_s:.1f} s")

    # the first stream: submitted at once, in a shuffled order
    bfs_roots = rng.choice(cand, 56, replace=False)
    stream = [("bfs", int(r), None) for r in bfs_roots]
    stream += [("bfs", int(r), None)
               for r in rng.choice(bfs_roots, 8, replace=False)]
    stream += [("sssp", int(r), None)
               for r in rng.choice(cand, 16, replace=False)]
    # dist: four rooted at a landmark (the table pins those), twelve random
    stream += [("dist", int(lms[i % len(lms)]), int(rng.choice(cand)))
               for i in range(4)]
    stream += [("dist", int(rng.choice(cand)), int(rng.choice(cand)))
               for _ in range(12)]
    stream += [("ppr", int(r), None)
               for r in rng.choice(cand, 2, replace=False)]
    stream = [stream[i] for i in rng.permutation(len(stream))]
    burst_roots = rng.choice(cand, 32, replace=False)

    # subrow_combine calls of order-free reduces in the streams (the fused
    # lane sweep runs none; ppr's float add folds through it)
    real_combine = pb.subrow_combine
    folds = []

    def combine_spy(sub_red, plan, identity, reduce, dtype):
        if not (reduce == "add" and sub_red.dtype.is_floating_point) \
                and sub_red.dtype != torch.int8:
            folds.append((reduce, str(sub_red.dtype)))
        return real_combine(sub_red, plan, identity, reduce, dtype)

    pb.subrow_combine = combine_spy
    _zero_counts()
    c0 = srv.counters()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    first = [srv.submit(kind, root, target=target)
             for kind, root, target in stream]
    srv.run()
    wall1 = time.perf_counter() - t1
    # the second stream: 4 bursts of 8 bfs between steps; a snapshot of
    # the server after the second burst's step (its time left out)
    snap_dir = tempfile.mkdtemp(prefix="serve_snap_")
    second = []
    snap_s = 0.0
    t2 = time.perf_counter()
    for b in range(4):
        second += [srv.submit("bfs", int(r))
                   for r in burst_roots[8 * b:8 * b + 8]]
        srv.step()
        if b == 1:
            ts = time.perf_counter()
            reads = srv.counters()["host_reads"]
            srv.snapshot(snap_dir)
            snap_reads = srv.counters()["host_reads"] - reads
            snap_s = time.perf_counter() - ts
            pending_at_snap = {q.qid for q in second if not q.done}
    srv.run()
    wall2 = time.perf_counter() - t2 - snap_s
    launches = _read_counts()
    pb.subrow_combine = real_combine
    cnt = {k: v - c0[k] for k, v in srv.counters().items()}
    ppr_sweeps = sum(grp.masked_sweeps for prog, grp in srv._groups.items()
                     if getattr(prog, "name", "") == "ppr")
    harvests = cnt["harvests"]
    handles = first + second
    bad = [q for q in handles if not q.done or q.answer_quality != "exact"]
    if bad:
        raise AssertionError(f"{len(bad)} queries unanswered or inexact")
    # the path's kernels: one launch a batched superstep with a masked
    # sweep, the fused lane sweep for bfs/sssp/dist and 1L for ppr's
    # float add; one lane push a batched superstep with a push lane;
    # kernel 1 alone, the single-lane fused push and an order-free
    # reduce's subrow_combine never
    if launches["edge_block_fold"] <= 0 \
            or launches["edge_block_lanes"] <= 0 \
            or launches["edge_block_lanes"] != ppr_sweeps \
            or launches["edge_block_fold"] + launches["edge_block_lanes"] \
            != cnt["masked_sweeps"] \
            or launches["push_ell_lanes"] <= 0 \
            or launches["push_ell_lanes"] != cnt["lane_pushes"] \
            or launches["edge_block"] != 0 \
            or launches["push_ell_fused"] != 0 or folds:
        raise AssertionError(f"serve launches {launches} against the "
                             f"server's counters {cnt} (ppr sweeps "
                             f"{ppr_sweeps}; order-free subrow_combine "
                             f"calls {len(folds)})")
    if cnt["host_reads"] != cnt["batched_supersteps"] + harvests \
            + snap_reads:
        raise AssertionError(f"host reads {cnt['host_reads']} != batched "
                             f"supersteps {cnt['batched_supersteps']} + "
                             f"harvests {harvests} + snapshot {snap_reads}")
    log(f"[serve] launches {launches}; server counters {cnt}; host reads "
        f"{cnt['host_reads']} = {cnt['batched_supersteps']} batched "
        f"supersteps (one read each) + {harvests} harvests (one read a "
        "slice end that finished a query, only the finished lanes copied) "
        f"+ {snap_reads} snapshot copies (one a batch group)")
    log(f"[serve] launches in the streams: lane sweeps "
        f"{launches['edge_block_fold']} fused (bfs/sssp/dist) + "
        f"{launches['edge_block_lanes']} 1L (ppr, = its "
        f"{ppr_sweeps} masked sweeps), lane pushes "
        f"{launches['push_ell_lanes']} (= {cnt['lane_pushes']} batched "
        f"supersteps with a push lane), single-lane fused pushes "
        f"{launches['push_ell_fused']}, kernel 1 alone "
        f"{launches['edge_block']}; subrow_combine of an order-free reduce: "
        f"{len(folds)} calls")

    # every answer against a sequential run on the card, bit for bit
    cfg = ScheduleConfig()
    progs = {"bfs": translate(dsl.bfs_program(), g, cfg, device="cuda"),
             "sssp": translate(dsl.sssp_program(), g, cfg, device="cuda")}
    seq = {}

    def sequential(kind, root):
        key = (kind, root)
        if key not in seq:
            prog = progs.get(kind) or translate(
                dsl.ppr_program(root), g, cfg, device="cuda")
            v, it = prog.run(roots=root)
            seq[key] = (v.cpu().numpy(), it, dict(prog.last_run_stats))
        return seq[key]

    stat_keys = ("push_supersteps", "pull_supersteps", "direction_switches",
                 "edges_traversed", "push_compacted_supersteps")
    served = {"landmark": 0, "exact": 0, "coalesced": 0, "batch": 0}
    for q in handles:
        served[q.served_by] = served.get(q.served_by, 0) + 1
        if q.kind == "dist":
            v, _, _ = sequential("sssp", q.root)
            if not _same_bits_np(np.float64(q.result),
                                 np.float64(v[q.target])):
                raise AssertionError(f"dist {q.root}->{q.target}: "
                                     f"{q.result} != {v[q.target]}")
            continue
        v, it, st = sequential(q.kind, q.root)
        if not _same_bits_np(q.result, v) or q.iters != it or any(
                q.stats[k] != st[k] for k in stat_keys):
            raise AssertionError(f"{q.kind} root {q.root} ({q.served_by}) "
                                 "!= its sequential run")
    if served["landmark"] < 1 or served["exact"] < 1:
        raise AssertionError(f"dist answers served by {served}: want a "
                             "landmark one and an exact one")
    for r in bfs_roots[:4]:
        want = numpy_bfs(g.edge_offsets.numpy().astype(np.int64),
                         g.edges_dst.numpy(), int(r), V)
        got, _, _ = sequential("bfs", int(r))
        if not np.array_equal(got.astype(np.int64), want):
            raise AssertionError(f"bfs root {r} != numpy_bfs")
    sssp_roots = [q.root for q in first if q.kind == "sssp"][:2]
    A = sp.csr_matrix((g.edge_weights.numpy().astype(np.float64),
                       g.edges_dst.numpy(), g.edge_offsets.numpy()),
                      shape=(V, V))
    want = dijkstra(A, indices=sssp_roots)
    for i, r in enumerate(sssp_roots):
        got = sequential("sssp", r)[0].astype(np.float64)
        if not (np.array_equal(np.isinf(got), np.isinf(want[i]))
                and np.allclose(got[np.isfinite(got)],
                                want[i][np.isfinite(got)], rtol=1e-5)):
            raise AssertionError(f"sssp root {r} disagrees with scipy")
    del A, want
    log(f"[serve] {len(handles)} answers = their sequential runs on the "
        f"card, bitwise (values, iters and {', '.join(stat_keys)}); served "
        f"by {served}; bfs roots {[int(r) for r in bfs_roots[:4]]} = "
        f"numpy_bfs; sssp roots {sssp_roots} ≈ scipy dijkstra (rtol 1e-5)")

    # restore the mid-stream snapshot into a fresh server
    fresh = GraphServer(g, admission=admission, device="cuda")
    restored = fresh.restore(snap_dir)
    fresh.run()
    by_qid = {q.qid: q for q in handles}
    redo = [q for q in fresh.done if q.qid in pending_at_snap]
    if {q.qid for q in redo} != pending_at_snap or any(
            not _same_bits_np(q.result, by_qid[q.qid].result)
            or q.iters != by_qid[q.qid].iters for q in redo):
        raise AssertionError("restored server's answers != the original's")
    log(f"[serve] snapshot after the second burst ({snap_s:.2f} s to write, "
        f"{restored} pending queries) restored into a new GraphServer: its "
        f"{len(redo)} answers = the original server's, bitwise")
    del fresh

    # times
    def lat(qs):
        ms = np.asarray([1e3 * (q.finished_s - q.submitted_s) for q in qs])
        return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))

    bfs_edges = sum(alg.traversed_edges(g, q.result) for q in handles
                    if q.kind == "bfs")
    wall = wall1 + wall2
    p50, p99 = lat(first)
    p50b, p99b = lat(second)
    prof = _profile_serve(torch, srv, rng.choice(cand, 16, replace=False),
                          1e3 * wall / cnt["batched_supersteps"], smi)
    main["landmark_table"] = srv.table       # [serve_bitmap] serves with it
    main["serve_dense"] = {"qps": len(first) / wall1,
                           "ms_step": 1e3 * wall / cnt["batched_supersteps"]}
    log(f"[serve] first stream {len(first)} queries in {wall1:.3f} s "
        f"({len(first) / wall1:.1f} queries/s; latency p50 {p50:.1f} ms, "
        f"p99 {p99:.1f} ms); second stream {len(second)} bfs in "
        f"{wall2:.3f} s (p50 {p50b:.1f} ms, p99 {p99b:.1f} ms); aggregate "
        f"MTEPS {bfs_edges / wall / 1e6:.1f} ({bfs_edges} traversed edges "
        f"of {sum(q.kind == 'bfs' for q in handles)} bfs answers over "
        f"{wall:.3f} s); {1e3 * wall / cnt['batched_supersteps']:.3f} ms a "
        f"batched superstep, on {smi}")
    del srv

    # run_batch over 8 roots against 8 sequential runs
    prog = progs["bfs"]
    roots8 = [int(r) for r in bfs_roots[:8]]
    vals, its = prog.run_batch(roots8)
    for i, r in enumerate(roots8):
        v, it, _ = sequential("bfs", r)
        if not _same_bits_np(vals[i].cpu().numpy(), v) or int(its[i]) != it:
            raise AssertionError(f"run_batch lane {i} != run(roots={r})")
    del vals
    t_batch, t_seq = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        ta = time.perf_counter()
        prog.run_batch(roots8)
        torch.cuda.synchronize()
        t_batch.append(time.perf_counter() - ta)
        ta = time.perf_counter()
        for r in roots8:
            prog.run(roots=r)
        torch.cuda.synchronize()
        t_seq.append(time.perf_counter() - ta)
    tb, tq = float(np.median(t_batch)), float(np.median(t_seq))
    log(f"[serve] run_batch over 8 bfs roots {tb * 1e3:.3f} ms against 8 "
        f"sequential runs {tq * 1e3:.3f} ms ({tq / tb:.2f}x; median of 3, "
        f"in turns; = run per lane, exactly) on {smi}")

    # a checkpointed run, then one crashed by an armed lane.crash and
    # resumed from its last snapshot
    ref_v, ref_it, ref_st = sequential("bfs", 0)
    keys = stat_keys + ("terminated",)
    ck = tempfile.mkdtemp(prefix="ck_")
    p1 = translate(dsl.bfs_program(), g, cfg, device="cuda")
    v, it = p1.run(roots=0, checkpoint_dir=ck, checkpoint_every=2)
    st1 = p1.last_run_stats
    if not np.array_equal(v.cpu().numpy(), ref_v) or it != ref_it or any(
            st1[k] != ref_st[k] for k in keys):
        raise AssertionError("checkpointed run != plain run")
    ck2 = tempfile.mkdtemp(prefix="ck_")
    crashed = translate(dsl.bfs_program(), g, cfg, device="cuda")
    with faults.injected("lane.crash", times=1, after=2) as plan:
        try:
            crashed.run(roots=0, checkpoint_dir=ck2, checkpoint_every=2)
        except InjectedFault:
            pass
        else:
            raise AssertionError("the armed lane.crash never fired")
    if plan.fired != 1:
        raise AssertionError("lane.crash fired {plan.fired} times")
    resumed = translate(dsl.bfs_program(), g, cfg, device="cuda")
    v, it = resumed.run(roots=0, checkpoint_dir=ck2, checkpoint_every=2,
                        resume=True)
    st2 = resumed.last_run_stats
    if not np.array_equal(v.cpu().numpy(), ref_v) or it != ref_it or any(
            st2[k] != ref_st[k] for k in keys) or st2["checkpoint_loads"] != 1:
        raise AssertionError("crashed and resumed run != plain run")
    log(f"[serve] checkpointed bfs (root 0, every 2 supersteps) = plain run: "
        f"saves {st1['checkpoint_saves']}, loads {st1['checkpoint_loads']}, "
        f"write {st1['checkpoint_write_s']:.3f} s; crashed at the third "
        f"slice boundary and resumed: saves {st2['checkpoint_saves']}, "
        f"loads {st2['checkpoint_loads']}, write "
        f"{st2['checkpoint_write_s']:.3f} s, = plain run")

    timing = _lane_timing(torch, g, oracle, smi)
    push_timing = _push_lane_timing(torch, g, oracle, smi)
    row = timing[(8, "random")]
    prow = push_timing[(8, "bfs")]
    torch.cuda.empty_cache()
    summary = {"table_s": table_s, "wall_first_s": wall1,
               "wall_second_s": wall2, "snapshot_s": snap_s,
               "queries": len(handles), "counters": cnt,
               "harvests": harvests, "launches": launches,
               "latency_ms": {"first": [p50, p99], "second": [p50b, p99b]},
               "bfs_traversed_edges": bfs_edges,
               "mteps": bfs_edges / wall / 1e6, "served_by": served,
               "run_batch_ms": tb * 1e3, "sequential_ms": tq * 1e3,
               "checkpoint": {k: st2[k] for k in ("checkpoint_saves",
                                                  "checkpoint_loads",
                                                  "checkpoint_write_s")},
               "lane_sweep": {f"k={k} {lbl}": v
                              for (k, lbl), v in timing.items()},
               "lane_push": {f"k={k} {lbl}": v
                             for (k, lbl), v in push_timing.items()},
               "profile": prof,
               "card": smi}
    with open(os.path.join(OUT_DIR, "chip_smoke_serve.json"), "w") as f:
        json.dump(summary, f, indent=1, default=str)
    return [
        {"name": "edge_block_fold_lanes", "route": "cuda",
         "source": "src/repro_torch/csrc/edge_block.cu",
         "replaces": "src/repro/kernels/edge_block.py:147",
         "launches": launches["edge_block_fold"],
         "max_abs_err": row["max_abs_err"], "ms": row["ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": "bytes", "library_ms": None, "shape": row["shape"]},
        # 1L, kept for float add (the route the fused sweep replaced for
        # min, max and int add, timed there end to end against it)
        {"name": "edge_block_reduce_lanes", "route": "cuda",
         "source": "src/repro_torch/csrc/edge_block.cu",
         "replaces": "src/repro/kernels/edge_block.py:147",
         "launches": launches["edge_block_lanes"],
         "max_abs_err": row["old_kernel_max_abs_err"],
         "ms": row["old_kernel_ms"], "plain_ms": row["old_kernel_plain_ms"],
         "bound_ms": row["old_kernel_bound_ms"], "bound_by": "bytes",
         "library_ms": None, "shape": row["shape"]},
        {"name": "push_ell_lanes_reduce", "route": "cuda",
         "source": "src/repro_torch/csrc/push_ell.cu",
         "replaces": "src/repro/kernels/push_ell.py:134",
         "launches": launches["push_ell_lanes"],
         "max_abs_err": prow["max_abs_err"], "ms": prow["ms"],
         "plain_ms": prow["plain_ms"], "bound_ms": prow["bound_ms"],
         "bound_by": "bytes", "library_ms": None, "shape": prow["shape"]}]


BITMAP_LANE_SETS = ("bfs", "narrow", "1%")   # the 2L timing's frontiers


def _bitmap_lane_timing(torch, g, oracle, smi):
    """2L and the bitmap plane's batched superstep at the main shape
    (bfs's plus_one/min over the flat pull view, grid blocks of 128
    sub-rows), at k = 1, 8 and 32 lanes on three frontier sets: root 0's
    BFS frontiers (lane i at level i mod the levels, with the BFS's state
    then), a random narrow frontier a lane (1,000 vertices, inside the
    plane's narrow tiers) and a random 1% frontier a lane (past them).
    2L on each lane's touched-derived flags (the flags pass,
    ``lane_block_words``, held against its plain version) is held bit for
    bit against its plain version and 1L (the same fold without flags),
    and its pre-pass (``lanes_prepare``: the messages of vertices active
    in some lane only) against its plain version's tables; the batched
    superstep (``lane_step``: touched tables, flags, 2L, apply) against
    the route it replaces (k single-lane bitmap supersteps,
    ``_pull_step``: k touched tables, kernel 2, ``subrow_combine``) and
    the dense plane's batched superstep (1L), values, frontiers and each
    lane's counters.  Each is timed (CUDA-event medians, and the
    profiler's device time: 2L's fold kernel, its pre-pass and the flags
    pass apart) beside 2L's plain version and byte bound; the routes on
    the BFS and narrow sets only."""
    from repro_torch.core import dsl, preprocess
    from repro_torch.core.scheduler import DirectionPolicy, ScheduleConfig
    from repro_torch.core.translator import translate
    from repro_torch.kernels import edge_block as eb
    from repro_torch.kernels import push_ell as pe
    lay = preprocess.layouts_for(g)
    pplan = lay.on(lay.pull_plan(64), "cuda")
    fe = lay.on(lay.forward_ell(8), "cuda")
    out_deg = g.out_degrees.to(device="cuda", dtype=torch.int32)
    V = g.num_vertices
    R8, W = pplan.flat_dst.shape
    grid_br = 128
    nblk = -(-R8 // grid_br)
    pull = DirectionPolicy(mode="pull")
    bitmap = translate(dsl.bfs_program(), g, ScheduleConfig(
        pull_sweep="bitmap", direction=pull), device="cuda")
    dense = translate(dsl.bfs_program(), g, ScheduleConfig(
        pull_sweep="dense", direction=pull), device="cuda")
    caps = bitmap.report.pull_block_tiers
    top = int(oracle[oracle < INT_MAX].max())
    lv_all = torch.as_tensor(np.minimum(oracle, INT_MAX).astype(np.int32))
    rng = np.random.default_rng(7)
    kw = dict(gather="plus_one", reduce="min", mask_inactive=True)
    rows = {}
    for k in SERVE_LANES:
        lanes = list(range(k))
        for label in BITMAP_LANE_SETS:
            if label == "bfs":
                lvls = [i % (top + 1) for i in range(k)]
                values = torch.stack([torch.where(lv_all <= lv, lv_all,
                                                  INT_MAX) for lv in lvls])
                active = torch.stack([lv_all == lv for lv in lvls])
            else:
                n = 1000 if label == "narrow" else V // 100
                active = torch.zeros((k, V), dtype=torch.bool)
                for i in range(k):
                    active[i, torch.as_tensor(rng.choice(V, n,
                                                         replace=False))] = 1
                values = torch.where(active, 0, INT_MAX).to(torch.int32)
            values, active = values.to("cuda"), active.to("cuda")
            m_f = [int(x) for x in torch.where(active, out_deg, 0).sum(
                1, dtype=torch.int64).tolist()]
            narrow = sum(m <= caps[1] for m in m_f)
            touched = pe.push_lanes_touched(fe.row_src, fe.dst, active,
                                            lanes, num_rows=fe.num_rows)
            words, _ = eb.lane_block_words(touched, pplan.owner8, lanes,
                                           grid_br)
            w_want, _ = eb.lane_block_words_plain(touched, pplan.owner8,
                                                  lanes, grid_br)
            flags = eb.block_words_flags(words, k)
            fl = dict(block_words=words)

            def skip(values=values, active=active, fl=fl):
                return eb.edge_block_fold_lanes(pplan, values, out_deg,
                                                active, lanes, **kw, **fl)

            def full(values=values, active=active):
                return eb.edge_block_fold_lanes(pplan, values, out_deg,
                                                active, lanes, **kw)

            got, l1 = skip(), full()
            want = eb.edge_block_fold_lanes_plain(pplan, values, out_deg,
                                                  active, lanes, **kw, **fl)
            t_want = pe.push_lanes_touched_plain(
                fe.row_src, fe.dst, active, lanes, num_rows=fe.num_rows)
            torch.cuda.synchronize()
            if not (_same_bits(got[0], want[0]) and _same(got[1], want[1])
                    and _same_bits(got[0], l1[0]) and _same(got[1], l1[1])
                    and _same(touched, t_want)
                    and _same(words.words, w_want.words)):
                raise AssertionError(f"2L disagrees at the main shape, k={k},"
                                     f" {label} frontiers")
            err = _max_err(got[0], want[0])
            words_err = _max_err(words.words, w_want.words)
            touched_err = _max_err(touched.to(torch.int32),
                                   t_want.to(torch.int32))
            del got, l1, want, t_want
            # the batched superstep against k single-lane supersteps and
            # the dense plane's batched superstep, lane by lane (on the
            # 1% sets every lane is wide: the route is 1L's there)
            args = (values, active, lanes, [True] * k, [], m_f)

            def batched(args=args):
                return bitmap._lane_step(*args)

            def singles(values=values, active=active, m_f=m_f):
                return [bitmap._pull_step(values[i], active[i], m_f[i])
                        for i in lanes]

            def dense_step(args=args):
                return dense._lane_step(*args)

            route = label != "1%"
            b_new, b_nxt, b_cnt = batched()
            d_new, d_nxt, _ = dense_step()
            s_out = singles()
            s_cnt = [[int(x) for x in c] for _, _, c in s_out]
            b_cnt = [[int(x) for x in b_cnt[i]] for i in lanes]
            torch.cuda.synchronize()
            if b_cnt != s_cnt or not all(
                    _same(b_new[i], n) and _same(b_nxt[i], x)
                    for i, (n, x, _) in enumerate(s_out)) or not (
                    _same(b_new, d_new) and _same(b_nxt, d_nxt)):
                raise AssertionError(f"the batched bitmap superstep != k "
                                     f"single-lane supersteps or the dense "
                                     f"batched one, k={k}, {label}")
            del b_new, b_nxt, d_new, d_nxt, s_out
            swept = sum(c[1] for c in s_cnt)
            reps = 10
            ms = _time_ms(torch, skip, reps=reps)
            dev_ms = _device_ms(torch, skip, "edge_block_skip_fold")
            pre_dev = _device_ms(torch, skip, "lanes_pack")
            l1_ms = _time_ms(torch, full, reps=reps)
            l1_dev = _device_ms(torch, full, "edge_block_fold")

            def words_pass(touched=touched):
                return eb.lane_block_words(touched, pplan.owner8, lanes,
                                           grid_br)

            def prepass(values=values, active=active):
                return eb.lanes_prepare(values, out_deg, active, lanes,
                                        gather="plus_one")

            def prepass_plain(values=values, active=active):
                return eb.lanes_prepare_plain(values, out_deg, active,
                                              lanes, gather="plus_one")

            prep, prep_want = prepass(), prepass_plain()
            torch.cuda.synchronize()
            prepass_err = _prepass_err(prep, prep_want, V,
                                       f"k={k} {label} at the main shape")
            del prep, prep_want
            prepass_ms = _time_ms(torch, prepass, reps=reps)
            prepass_plain_ms = _time_ms(torch, prepass_plain, reps=3,
                                        warmup=1)
            words_ms = _time_ms(torch, words_pass, reps=reps)
            words_dev = _device_ms(torch, words_pass, "words_kernel")
            words_plain_ms = _time_ms(
                torch, lambda touched=touched: eb.lane_block_words_plain(
                    touched, pplan.owner8, lanes, grid_br), reps=3,
                warmup=1)
            touched_ms = _time_ms(torch, lambda active=active: (
                pe.push_lanes_touched(fe.row_src, fe.dst, active, lanes,
                                      num_rows=fe.num_rows)), reps=reps)
            touched_dev = _device_ms(torch, lambda active=active: (
                pe.push_lanes_touched(fe.row_src, fe.dst, active, lanes,
                                      num_rows=fe.num_rows)),
                "push_ell_lanes")
            step_ms = step_dev = single_ms = single_dev = dense_ms = \
                dense_dev = None
            if route:
                step_ms = _time_ms(torch, batched, reps=5, warmup=1)
                step_dev = _device_ms(torch, batched, "", calls=5)
                single_ms = _time_ms(torch, singles, reps=5, warmup=1)
                single_dev = _device_ms(torch, singles, "", calls=5)
                dense_ms = _time_ms(torch, dense_step, reps=5, warmup=1)
                dense_dev = _device_ms(torch, dense_step, "", calls=5)
            plain_ms = _time_ms(
                torch, lambda values=values, active=active, fl=fl:
                eb.edge_block_fold_lanes_plain(pplan, values, out_deg,
                                               active, lanes, **kw, **fl),
                reps=3, warmup=1)
            t_plain_ms = _time_ms(torch, lambda active=active: (
                pe.push_lanes_touched_plain(fe.row_src, fe.dst, active,
                                            lanes, num_rows=fe.num_rows)),
                reps=3, warmup=1)
            # 2L's bytes: the ids and owners of the rows in a grid block
            # live in some lane, the flags, each lane's values and frontier
            # in and (V,) table out; its operations: a slot a live
            # (lane, row)
            block_rows = torch.full((nblk,), grid_br, device="cuda")
            block_rows[-1] = R8 - (nblk - 1) * grid_br
            rows_live = int(block_rows[flags.any(0)].sum())
            lane_rows = int((flags * block_rows).sum())
            nbytes = rows_live * (W * 4 + 4) + k * nblk + k * V * 5 \
                + k * V * 4
            bound = 1e3 * max(nbytes / _BANDWIDTH,
                              lane_rows * W / _SCALAR_OPS)
            # the flags pass's bytes: the touched tables, owner8 and the
            # words out; the live-only pre-pass's: the frontiers, the values
            # of vertices active in some lane, the bits and their messages
            w_bytes = k * V + R8 * 4 + nblk * 4
            w_bound = 1e3 * w_bytes / _BANDWIDTH
            n_live = int(active.any(0).sum())
            K = next(x for x in (1, 4, 8, 32) if x >= k)
            p_bytes = k * V + n_live * k * 4 + V * K // 8 + n_live * K * 4
            p_bound = 1e3 * p_bytes / _BANDWIDTH
            # the touched pass's bytes: row_src, each lane's frontier, the
            # live rows' ids, each lane's (V,) table out
            live_rows = int(torch.where(active, fe.rows_per_vertex, 0).sum())
            t_bytes = fe.num_rows * 4 + k * V + live_rows * 8 * 4 + k * V
            t_bound = 1e3 * t_bytes / _BANDWIDTH
            rows[(k, label)] = {
                "ms": ms, "device_ms": dev_ms, "l1_ms": l1_ms,
                "l1_device_ms": l1_dev, "prepass_device_ms": pre_dev,
                "prepass_ms": prepass_ms, "prepass_plain_ms": prepass_plain_ms,
                "prepass_bound_ms": p_bound, "live_vertices": n_live,
                "prepass_max_abs_err": prepass_err,
                "words_ms": words_ms, "words_device_ms": words_dev,
                "words_plain_ms": words_plain_ms, "words_bound_ms": w_bound,
                "words_max_abs_err": words_err,
                "touched_max_abs_err": touched_err,
                "plain_ms": plain_ms, "bound_ms": bound, "bytes": nbytes,
                "max_abs_err": err, "live_blocks": int(flags.sum()),
                "blocks": k * nblk, "narrow_lanes": narrow,
                "touched_ms": touched_ms, "touched_device_ms": touched_dev,
                "touched_plain_ms": t_plain_ms, "touched_bound_ms": t_bound,
                "superstep_ms": step_ms, "superstep_device_ms": step_dev,
                "singles_ms": single_ms, "singles_device_ms": single_dev,
                "dense_superstep_ms": dense_ms,
                "dense_superstep_device_ms": dense_dev,
                "plan_blocks_swept": swept, "shape": [k, R8, W, V]}

            def fmt(x):
                return "not measured" if x is None else f"{x:.4f}"
            log(f"[serve_bitmap] 2L (plus_one/min, touched flags) k={k} "
                f"{label} frontiers ({narrow} of {k} lanes narrow, "
                f"{int(flags.sum())}/{k * nblk} lane-blocks live): "
                f"{ms:.4f} ms (device: fold {fmt(dev_ms)}, pre-pass "
                f"{fmt(pre_dev)}, bound {p_bound:.4f} for {n_live} live "
                f"vertices; alone {prepass_ms:.4f} ms, plain "
                f"{prepass_plain_ms:.4f}, = plain) against 1L {l1_ms:.4f} ms "
                f"(fold "
                f"device {fmt(l1_dev)}); plain {plain_ms:.4f} ms; bound "
                f"{bound:.4f} ms ({nbytes / 1e9:.3f} GB); touched pass "
                f"{touched_ms:.4f} ms (device {fmt(touched_dev)}, plain "
                f"{t_plain_ms:.4f}, bound {t_bound:.4f}); flags pass "
                f"{words_ms:.4f} ms (device {fmt(words_dev)}, plain "
                f"{words_plain_ms:.4f}, bound {w_bound:.4f}); = plain and "
                f"= 1L bit for bit, on {smi}")
            if route:
                log(f"[serve_bitmap] route A/B k={k} {label}: batched bitmap"
                    f" superstep {step_ms:.4f} ms (device {fmt(step_dev)}) "
                    f"against {k} x single-lane _pull_step {single_ms:.4f} "
                    f"ms (device {fmt(single_dev)}) and the dense batched "
                    f"superstep (1L) {dense_ms:.4f} ms (device "
                    f"{fmt(dense_dev)}); values, frontiers and counters "
                    f"equal, on {smi}")
            del values, active, touched, flags, words
    torch.cuda.empty_cache()
    return rows


def phase_serve_bitmap(torch, dev_info, main):
    """The graph server on the bitmap plane: see the module docstring
    (step 7)."""
    from repro_torch.core import dsl
    from repro_torch.core.scheduler import (AdmissionPolicy, DirectionPolicy,
                                            ScheduleConfig)
    from repro_torch.core.translator import translate
    from repro_torch.serve.graph_serve import GraphServer

    t_phase = time.perf_counter()
    g, oracle, smi = main["g"], main["oracle"], dev_info["smi"]
    deg = g.out_degrees.numpy()
    rng = np.random.default_rng(5)
    cand = np.flatnonzero(deg > 0)
    table = main["landmark_table"]
    lms = table.landmarks
    bfs_roots = np.concatenate([[0], rng.choice(cand[cand != 0], 15,
                                                replace=False)])
    stream = [("bfs", int(r), None) for r in bfs_roots]
    stream += [("bfs", int(r), None)
               for r in rng.choice(bfs_roots, 4, replace=False)]
    stream += [("sssp", int(r), None)
               for r in rng.choice(cand, 6, replace=False)]
    stream += [("dist", int(lms[i % len(lms)]), int(rng.choice(cand)))
               for i in range(3)]
    stream += [("dist", int(rng.choice(cand)), int(rng.choice(cand)))
               for _ in range(3)]
    stream += [("ppr", int(r), None)
               for r in rng.choice(cand, 2, replace=False)]
    stream = [stream[i] for i in rng.permutation(len(stream))]
    admission = AdmissionPolicy(slots=8, slice_supersteps=4)
    stat_keys = ("push_supersteps", "pull_supersteps", "direction_switches",
                 "edges_traversed", "push_compacted_supersteps",
                 "pull_blocks_swept", "pull_blocks_skipped")
    results = {}
    for label, direction in (("auto", DirectionPolicy()),
                             ("pull", DirectionPolicy(mode="pull"))):
        cfg = ScheduleConfig(pull_sweep="bitmap", direction=direction)
        # landmarks=4: [serve]'s table (exact SSSP distances from the same
        # 4 landmarks, equal on every plane), so it is not rebuilt
        srv = GraphServer(g, schedule=cfg, admission=admission,
                          device="cuda")
        srv.table = table
        _zero_counts()
        c0 = srv.counters()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        handles = [srv.submit(kind, root, target=target)
                   for kind, root, target in stream]
        srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = _read_counts()
        cnt = {key: v - c0[key] for key, v in srv.counters().items()}
        if any(not q.done or q.answer_quality != "exact" for q in handles):
            raise AssertionError(f"[serve_bitmap] {label}: queries "
                                 "unanswered or inexact")
        skip_2l = launches["edge_block_fold_skip"] \
            + launches["edge_block_lanes_skip"]
        ppr_sweeps = sum(grp.masked_sweeps
                         for prog, grp in srv._groups.items()
                         if getattr(prog, "name", "") == "ppr")
        # the batched route: 2L a batched superstep with narrow pull lanes
        # (one touched pass each), 1L (fused) for the other sweeps, ppr's
        # float add (frontier 'all': the dense plane) 1L, the lane push;
        # no single-lane kernel 1 or 2 and no single-lane fused push
        if launches["edge_block_skip"] != 0 or launches["edge_block"] != 0 \
                or launches["push_ell_fused"] != 0 \
                or launches["push_lanes_touched"] != skip_2l \
                or launches["lane_block_words"] != skip_2l \
                or launches["lanes_prepare"] != launches["edge_block_fold"] \
                + launches["edge_block_lanes"] \
                + launches["edge_block_lanes_skip"] \
                or launches["edge_block_lanes"] != ppr_sweeps \
                or launches["edge_block_fold"] != cnt["masked_sweeps"] \
                - ppr_sweeps \
                or launches["push_ell_lanes"] != cnt["lane_pushes"] \
                or (label == "pull" and skip_2l <= 0) \
                or (label == "auto" and launches["push_ell_lanes"] <= 0):
            raise AssertionError(f"[serve_bitmap] {label}: launches "
                                 f"{launches} against the server's counters "
                                 f"{cnt} (ppr sweeps {ppr_sweeps})")
        if cnt["host_reads"] != cnt["batched_supersteps"] + cnt["harvests"]:
            raise AssertionError(f"[serve_bitmap] {label}: host reads "
                                 f"{cnt['host_reads']} != batched supersteps "
                                 f"{cnt['batched_supersteps']} + harvests "
                                 f"{cnt['harvests']}")
        # every answer against a sequential run on the same schedule
        progs = {"bfs": translate(dsl.bfs_program(), g, cfg, device="cuda"),
                 "sssp": translate(dsl.sssp_program(), g, cfg,
                                   device="cuda")}
        seq = {}

        def sequential(kind, root, progs=progs, seq=seq, cfg=cfg):
            if (kind, root) not in seq:
                prog = progs.get(kind) or translate(
                    dsl.ppr_program(root), g, cfg, device="cuda")
                v, it = prog.run(roots=root)
                seq[(kind, root)] = (v.cpu().numpy(), it,
                                     dict(prog.last_run_stats))
            return seq[(kind, root)]

        for q in handles:
            if q.kind == "dist":
                v, _, _ = sequential("sssp", q.root)
                if not _same_bits_np(np.float64(q.result),
                                     np.float64(v[q.target])):
                    raise AssertionError(f"[serve_bitmap] dist {q.root}->"
                                         f"{q.target}: {q.result} != "
                                         f"{v[q.target]}")
                continue
            v, it, st = sequential(q.kind, q.root)
            if not _same_bits_np(q.result, v) or q.iters != it or any(
                    q.stats[key] != st[key] for key in stat_keys):
                raise AssertionError(f"[serve_bitmap] {label}: {q.kind} root "
                                     f"{q.root} != its sequential run")
        if not np.array_equal(sequential("bfs", 0)[0].astype(np.int64),
                              oracle):
            raise AssertionError("[serve_bitmap] bfs from root 0 != the "
                                 "main phase's numpy_bfs")
        check_s = time.perf_counter() - t1 - wall
        steps = cnt["batched_supersteps"]
        results[label] = {
            "queries": len(handles), "wall_s": wall,
            "queries_per_s": len(handles) / wall,
            "ms_per_batched_superstep": 1e3 * wall / steps,
            "launches": launches, "counters": cnt,
            "skip_2l_launches": skip_2l,
            "host_reads_per_batched_superstep":
                (cnt["host_reads"] - cnt["harvests"]) / steps,
            "check_s": check_s}
        log(f"[serve_bitmap] {label}: {len(handles)} queries (16 bfs + 4 "
            f"repeats, 6 sssp, 6 dist, 2 ppr) under ScheduleConfig("
            f"pull_sweep='bitmap', direction={direction.mode!r}) = their "
            f"sequential runs bitwise (values, iters, {', '.join(stat_keys)})"
            f"; launches: 2L {skip_2l} (fused fold "
            f"{launches['edge_block_fold_skip']}, sub-row "
            f"{launches['edge_block_lanes_skip']}), touched passes "
            f"{launches['push_lanes_touched']}, flags passes "
            f"{launches['lane_block_words']}, pre-passes "
            f"{launches['lanes_prepare']}, single-lane kernel 2 "
            f"{launches['edge_block_skip']}, 1L fold "
            f"{launches['edge_block_fold'] - launches['edge_block_fold_skip']}"
            f", 1L sub-row (ppr) {launches['edge_block_lanes']}, 3L "
            f"{launches['push_ell_lanes']}, kernel 1 alone "
            f"{launches['edge_block']}; host reads {cnt['host_reads']} = "
            f"{steps} batched supersteps x 1 + {cnt['harvests']} harvests; "
            f"{len(handles) / wall:.1f} queries/s, "
            f"{1e3 * wall / steps:.3f} ms a batched superstep ({wall:.3f} s)"
            f" against [serve]'s dense plane {main['serve_dense']['qps']:.1f}"
            f" queries/s, {main['serve_dense']['ms_step']:.3f} ms a batched "
            f"superstep, on {smi}; the sequential checks {check_s:.1f} s")
        del srv, progs, seq
    t_timing = time.perf_counter()
    timing = _bitmap_lane_timing(torch, g, oracle, smi)
    phase_s = time.perf_counter() - t_phase
    log(f"[serve_bitmap] phase wall {phase_s:.1f} s (the 2L and route "
        f"timings {time.perf_counter() - t_timing:.1f} s)")
    with open(os.path.join(OUT_DIR, "chip_smoke_serve_bitmap.json"),
              "w") as f:
        json.dump({"servers": results, "phase_s": phase_s,
                   "timing": {f"k={k} {lbl}": v
                              for (k, lbl), v in timing.items()},
                   "card": smi}, f, indent=1, default=str)
    row = timing[(8, "bfs")]
    return [
        {"name": "edge_block_fold_lanes (2L, block flags)", "route": "cuda",
         "source": "src/repro_torch/csrc/edge_block.cu",
         "replaces": "src/repro/kernels/edge_block.py:58",
         "launches": results["pull"]["skip_2l_launches"]
         + results["auto"]["skip_2l_launches"],
         "max_abs_err": row["max_abs_err"], "ms": row["ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": "bytes", "library_ms": None, "shape": row["shape"]},
        {"name": "push_lanes_touched (3L, touched only)", "route": "cuda",
         "source": "src/repro_torch/csrc/push_ell.cu",
         "replaces": "src/repro/kernels/push_ell.py:134",
         "launches": results["pull"]["launches"]["push_lanes_touched"]
         + results["auto"]["launches"]["push_lanes_touched"],
         "max_abs_err": row["touched_max_abs_err"], "ms": row["touched_ms"],
         "plain_ms": row["touched_plain_ms"],
         "bound_ms": row["touched_bound_ms"], "bound_by": "bytes",
         "library_ms": None, "shape": row["shape"]},
        {"name": "lane_block_words (2L's flags pass)", "route": "cuda",
         "source": "src/repro_torch/csrc/edge_block.cu",
         "replaces": "src/repro/kernels/edge_block.py:141",
         "launches": results["pull"]["launches"]["lane_block_words"]
         + results["auto"]["launches"]["lane_block_words"],
         "max_abs_err": row["words_max_abs_err"], "ms": row["words_ms"],
         "plain_ms": row["words_plain_ms"],
         "bound_ms": row["words_bound_ms"], "bound_by": "bytes",
         "library_ms": None, "shape": row["shape"]},
        {"name": "lanes_prepare (the lane pre-pass, live messages only)",
         "route": "cuda", "source": "src/repro_torch/csrc/lanes.cuh",
         "replaces": "src/repro/kernels/edge_block.py:147",
         "launches": results["pull"]["launches"]["lanes_prepare"]
         + results["auto"]["launches"]["lanes_prepare"],
         "max_abs_err": row["prepass_max_abs_err"], "ms": row["prepass_ms"],
         "plain_ms": row["prepass_plain_ms"],
         "bound_ms": row["prepass_bound_ms"], "bound_by": "bytes",
         "library_ms": None, "shape": row["shape"]}]


def phase_sparse(torch, g, oracle, traversed, smi):
    """The sparse backend at the main scale: ``in_degrees`` on CUDA (its
    unmatched gather routes sparse) against ``np.bincount``, then BFS with
    ``backend='sparse'`` under pull, push (coo_chunks) and auto."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import preprocess
    from repro_torch.core.scheduler import DirectionPolicy, ScheduleConfig
    lay = preprocess.layouts_for(g)
    before = dict(lay.build_times_s)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    deg = alg.in_degrees(g, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    want = np.bincount(g.edges_dst.numpy(), minlength=g.num_vertices)
    if not np.array_equal(deg.cpu().numpy(), want.astype(np.float32)):
        raise AssertionError("in_degrees on CUDA != np.bincount")
    built = {k: round(v, 2) for k, v in lay.build_times_s.items()
             if k not in before}
    log(f"[sparse] in_degrees on CUDA = np.bincount of the destinations "
        f"({wall:.2f} s first call); sparse layouts built on the host "
        f"{built} s")
    runs = _bfs_runs(torch, g, oracle, "sparse", backend="sparse")
    grown = torch.cuda.memory_allocated() - mem0
    log(f"[sparse] device memory held by the sparse layouts: "
        f"{grown / 2**30:.2f} GiB")
    perf = _steady(torch, g, {
        f"sparse {d}": ScheduleConfig(backend="sparse",
                                      direction=DirectionPolicy(mode=d))
        for d in ("pull", "push", "auto")}, traversed, smi)
    prof = _profile_run(torch, perf["sparse pull"]["prog"],
                        perf["sparse pull"]["run_wall_s"], "sparse_pull")
    return {"in_degrees_first_call_s": wall, "host_layouts_s": built,
            "device_bytes": grown,
            "run_stats": {d: r["rep"].run_stats for d, r in runs.items()},
            "perf": {k: {kk: vv for kk, vv in v.items() if kk != "prog"}
                     for k, v in perf.items()},
            "profile_pull": prof}


STREAM_PARTITIONS = 8       # the stream phase's ScheduleConfig(partitions=8)
STREAM_BATCH = 8            # run_batch roots
STREAM_QUERIES = 16         # bfs queries served over the stream


def _stream_replay(oracle, deg, store, mode, policy, num_edges):
    """A numpy replay of the streamed engine's accounting of a BFS from
    root 0, from the oracle's levels alone (superstep s's frontier is the
    level-s vertices): each superstep's interval counts, direction
    (``'auto'`` replays the hysteresis on ``n_f``, ``m_f`` and the pull
    cost), live partitions, edges, pull cost and bytes shipped.  Returns
    ``(run_stats counters, iters, sweeps a plane, pre-passes a plane,
    lane.crash trips, plane a superstep)``."""
    cuts, P, V = store.cuts, store.partitions, len(oracle)
    part = np.searchsorted(cuts[1:], np.arange(V), side="right")
    epp = np.asarray(store.edges_per_partition, np.int64)
    entry = store.stats()["entry_bytes"]
    top = int(oracle[oracle < INT_MAX].max())
    out = {"push_supersteps": 0, "direction_switches": 0,
           "edges_traversed": 0, "pull_cost_model": int(num_edges),
           "partitions_swept": 0, "partitions_skipped": 0,
           "partitions_transferred": 0, "partition_bytes_h2d": 0}
    sweeps = {"pull": 0, "push": 0}
    prepasses = {"pull": 0, "push": 0}
    trips, planes = [], []
    direction = 0
    for s in range(top + 1):
        act = oracle == s
        counts = np.bincount(part[act], minlength=P)
        n_f, m_f = int(act.sum()), int(deg[act].sum())
        if mode == "pull":
            d = 0
        elif mode == "push":
            d = 1
        elif direction == 1:
            d = int(m_f * policy.alpha < out["pull_cost_model"])
        else:
            d = int(n_f * policy.beta < V)
        live = np.flatnonzero((counts > 0) & (epp > 0))
        pull_edges = int(epp[counts > 0].sum())
        plane = "push" if d else "pull"
        out["edges_traversed"] += m_f if d else pull_edges
        if d == 0:
            out["pull_cost_model"] = pull_edges
        out["direction_switches"] += int(s > 0 and d != direction)
        direction = d
        out["push_supersteps"] += d
        out["partitions_swept"] += len(live)
        out["partitions_skipped"] += P - len(live)
        out["partitions_transferred"] += len(live)
        out["partition_bytes_h2d"] += len(live) * entry[plane]
        sweeps[plane] += len(live)
        prepasses[plane] += int(len(live) > 0)
        trips.append(("superstep", s))
        trips += [("partition", int(p)) for p in live]
        planes.append(plane)
    out["pull_supersteps"] = top + 1 - out["push_supersteps"]
    return out, top + 1, sweeps, prepasses, trips, planes


def _partition_on_card(torch, store, plane, p):
    """Partition p's streamed arrays of ``plane``, copied to the card,
    cut to its real rows: ``(key, slot, wgt, rows)``."""
    host = store.push_arrays(p) if plane == "push" else store.pull_arrays(p)
    rows = int(store.rows_per_partition[plane][p])
    dev = {k: v.to("cuda")[:rows] for k, v in host.items()}
    return dev["key"], dev["slot"], dev["wgt"], rows


def _stream_route_timing(torch, g, oracle, store, push_level, smi):
    """Each streamed route's time per partition at the stream's shapes
    (scale 22, one lane), against its plain version and its byte bound:
    the fused lane sweep in accumulate mode on the largest pull partition
    at the widest BFS level's frontier, the lane push at the level of
    auto's heaviest push superstep, over the partition that holds most of
    that frontier's out-edges, and the pre-passes of both."""
    import types
    from repro_torch.kernels import edge_block as eb
    from repro_torch.kernels import push_ell as pe
    from repro_torch.kernels.ref import PAD
    V = g.num_vertices
    degd = g.out_degrees.to(device="cuda", dtype=torch.int32)
    lv = torch.as_tensor(oracle.astype(np.int32)).to("cuda")
    sizes = np.bincount(oracle[oracle < INT_MAX])
    wide = int(np.argmax(sizes))
    out = {}

    def state(level):
        vals = torch.where(lv <= level, lv, INT_MAX)[None].contiguous()
        return vals, (lv == level)[None].contiguous()

    # pull: the fused lane sweep in accumulate mode, prepared tables
    p = int(np.argmax(store.rows_per_partition["pull"]))
    key, slot, wgt, rows = _partition_on_card(torch, store, "pull", p)
    view = types.SimpleNamespace(flat_dst=slot, flat_wgt=wgt, owner8=key)
    vals, act = state(wide)
    kw = dict(gather="plus_one", reduce="min", need_got=False,
              accumulate=True)
    prep = eb.lanes_prepare(vals, degd, act, [0], gather="plus_one")
    red = torch.full((1, V), 2**31 - 1, dtype=torch.int32, device="cuda")
    want = eb.edge_block_fold_lanes_plain(view, vals, degd, act, [0],
                                          red=red.clone(), **kw)[0]
    got = eb.edge_block_fold_lanes(view, vals, degd, act, [0],
                                   red=red.clone(), prepared=prep, **kw)[0]
    torch.cuda.synchronize()
    if not _same(got, want):
        raise AssertionError("streamed fold on the scale-22 partition != "
                             "plain accumulate")

    def fold():
        return eb.edge_block_fold_lanes(view, vals, degd, act, [0], red=red,
                                        prepared=prep, **kw)

    ms = _time_ms(torch, fold, reps=20)
    dev = _device_ms(torch, fold, "edge_block_fold")
    plain = _time_ms(torch, lambda: eb.edge_block_fold_lanes_plain(
        view, vals, degd, act, [0], red=red, **kw), reps=5, warmup=1)
    # what this partition's launch must move: its ids and owners once, the
    # frontier bits of its source interval, the message of each frontier
    # source its slots name, and the running entry of each owner it holds,
    # read and written
    lo, hi = int(store.cuts[p]), int(store.cuts[p + 1])
    srcs = torch.unique(slot[slot != PAD].long())
    n_msg = int(act[0][srcs].sum())
    n_own = int(torch.unique(key[key < V]).numel())
    nbytes = rows * 36 + (hi - lo) / 8 + n_msg * 4 + n_own * 8
    bound = 1e3 * nbytes / _BANDWIDTH
    prep_ms = _time_ms(torch, lambda: eb.lanes_prepare(
        vals, degd, act, [0], gather="plus_one"), reps=20)
    prep_dev = _device_ms(torch, lambda: eb.lanes_prepare(
        vals, degd, act, [0], gather="plus_one"), "lanes_pack")
    prep_bound = 1e3 * (V * 5 + V * 4 + V // 8) / _BANDWIDTH
    out["fold"] = {"ms": ms, "device_ms": dev, "plain_ms": plain,
                   "bound_ms": bound,
                   "max_abs_err": _max_err(got, want), "rows": rows,
                   "partition": p, "level": wide,
                   "frontier": int(sizes[wide]), "interval": hi - lo,
                   "messages": n_msg, "owners": n_own,
                   "shape": [rows, 8, V, 1]}
    out["prepare"] = {"ms": prep_ms, "device_ms": prep_dev,
                      "bound_ms": prep_bound}

    def opt(x):
        return "not measured" if x is None else f"{x:.4f} ms"

    log(f"[stream] fused lane sweep, accumulate mode, on pull partition "
        f"{p} ({rows} rows, source interval of {hi - lo}, {n_own} owners, "
        f"{n_msg} frontier sources named) at BFS level {wide} "
        f"({int(sizes[wide])} frontier vertices): {ms:.4f} ms (device "
        f"{opt(dev)}), plain {plain:.4f} ms, bound {bound:.4f} ms "
        f"({bound / ms:.3f} of it); its pre-pass (lanes_prepare, once a "
        f"superstep) {prep_ms:.4f} ms (device {opt(prep_dev)}) against "
        f"{prep_bound:.4f} ms, on {smi}")

    # push: the lane push with got over the partition holding most of the
    # level's frontier out-edges
    front = oracle == push_level
    part = np.searchsorted(store.cuts[1:], np.flatnonzero(front),
                           side="right")
    p = int(np.argmax(np.bincount(
        part, weights=g.out_degrees.numpy()[front],
        minlength=store.partitions)))
    key, slot, wgt, rows = _partition_on_card(torch, store, "push", p)
    vals, act = state(push_level)
    pprep = pe.push_lanes_prepare(act, [0])
    table = torch.full((1, V), 2**31 - 1, dtype=torch.int32, device="cuda")
    gotp = torch.zeros((1, V), dtype=torch.bool, device="cuda")
    pkw = dict(num_rows=rows, gather="plus_one", reduce="min",
               identity=2**31 - 1)
    args = (key, slot, wgt, vals, degd, act, [0])
    want_g = torch.zeros_like(gotp)
    want_t = pe.push_ell_lanes_reduce_plain(*args, **pkw, got=want_g,
                                            table=table.clone())
    got_t = pe.push_ell_lanes_reduce(*args, **pkw, table=table.clone(),
                                     got=gotp, prepared=pprep)
    torch.cuda.synchronize()
    if not _same(got_t, want_t) or not torch.equal(gotp, want_g):
        raise AssertionError("streamed push on the scale-22 partition != "
                             "plain (table or got)")

    def streamed_push(g=gotp):
        # as a superstep finds them: the running table at the identity
        # (this is the level's first partition), got cleared
        table.fill_(2**31 - 1)
        if g is not None:
            g.zero_()
        return pe.push_ell_lanes_reduce(*args, **pkw, table=table, got=g,
                                        prepared=pprep)

    pms = _time_ms(torch, streamed_push, reps=20)
    pdev = _device_ms(torch, streamed_push, "push_ell_lanes")
    pdev_nogot = _device_ms(torch, lambda: streamed_push(None),
                            "push_ell_lanes")
    pplain = _time_ms(torch, lambda: pe.push_ell_lanes_reduce_plain(
        *args, **pkw, table=table), reps=5, warmup=1)
    live_rows = act[0][key.long()]
    n_live = int(live_rows.sum())
    dst = slot[live_rows]
    dst = dst[dst != PAD].long()
    valid = int(dst.numel())
    in_count = torch.bincount(dst, minlength=V)
    n_dst = int((in_count > 0).sum())
    max_in = int(in_count.max())
    del in_count
    n_src = int(torch.unique(key[live_rows]).numel())
    lo, hi = int(store.cuts[p]), int(store.cuts[p + 1])
    # what this partition's launch must move: row_src and its source
    # interval's bits once, a live row's ids, a live source's value, and
    # the running entry of each destination a message reaches, read and
    # written, with its got byte
    pbytes = rows * 4 + (hi - lo) / 8 + n_live * 32 + n_src * 4 + n_dst * 9
    pbound = 1e3 * pbytes / _BANDWIDTH
    pprep_ms = _time_ms(torch, lambda: pe.push_lanes_prepare(act, [0]),
                        reps=20)
    out["push"] = {"ms": pms, "device_ms": pdev,
                   "device_ms_got_null": pdev_nogot, "plain_ms": pplain,
                   "bound_ms": pbound,
                   "max_abs_err": _max_err(got_t, want_t), "rows": rows,
                   "partition": p, "level": push_level,
                   "live_rows": n_live, "valid_slots": valid,
                   "destinations": n_dst, "max_in_messages": max_in,
                   "shape": [rows, 8, V, 1, n_live]}
    out["push_prepare"] = {"ms": pprep_ms,
                           "bound_ms": 1e3 * (V + V // 8) / _BANDWIDTH}
    log(f"[stream] lane push with got on push partition {p} ({rows} rows, "
        f"{n_live} live at BFS level {push_level}, {valid} messages to "
        f"{n_dst} vertices, at most {max_in} to one): {pms:.4f} ms with "
        f"the table's refill and got's clearing (device: kernel "
        f"{opt(pdev)}, {opt(pdev_nogot)} with got null), plain "
        f"{pplain:.4f} ms, bound {pbound:.4f} ms ({pbound / pms:.3f} of "
        f"it); its pre-pass {pprep_ms:.4f} ms, on {smi}")
    return out


def _pagerank_route_timing(torch, g2, prog, smi):
    """The float-add route on the largest pull partition of the scale-20
    streamed pagerank, as a superstep finds it (one lane, every vertex
    live, the running table at +0): the fused fold
    (``edge_block_add_fold_lanes`` on the superstep's pre-pass) against
    its plain version (rtol 1e-5) and the route it replaced (kernel 1 on
    prepared tables, kernel 4 by the keys, the add; bit for bit), both
    timed with the wrappers' host time and by the profiler's device time,
    beside the byte bound (and the old reckoning, which wrote a (V,)
    partial), the plain version and one library call (a CSR
    matrix-vector product of the partition's adjacency with the message
    table)."""
    import types
    from repro_torch.kernels import edge_block as eb
    from repro_torch.kernels.ref import PAD
    store = prog.store
    V = g2.num_vertices
    degd = g2.out_degrees.to(device="cuda", dtype=torch.int32)
    p = int(np.argmax(store.rows_per_partition["pull"]))
    key, slot, wgt, rows = _partition_on_card(torch, store, "pull", p)
    view = types.SimpleNamespace(flat_dst=slot, flat_wgt=wgt, owner8=key)
    vals = torch.full((1, V), 1.0, device="cuda")
    act = torch.ones((1, V), dtype=torch.bool, device="cuda")
    kw = dict(gather="div_deg", mask_inactive=False)
    prep = eb.lanes_prepare(vals, degd, act, [0], **kw)
    prep1 = eb.edge_block_prepare(vals[0], degd, act[0], **kw)
    red0 = torch.zeros((1, V), device="cuda")
    red = red0.clone()

    def fused():
        return eb.edge_block_add_fold_lanes(view, vals, degd, act, [0],
                                            red=red, prepared=prep, **kw)

    def parent():
        return _add_fold_parent(torch, view, vals, degd, act, [0], red=red,
                                got=None, prepared=prep1, **kw)

    def plain():
        return eb.edge_block_add_fold_lanes_plain(view, vals, degd, act, [0],
                                                  red=red, **kw)

    got = eb.edge_block_add_fold_lanes(view, vals, degd, act, [0],
                                       red=red0.clone(), prepared=prep,
                                       **kw)[0]
    old = _add_fold_parent(torch, view, vals, degd, act, [0],
                           red=red0.clone(), got=None, prepared=prep1,
                           **kw)[0]
    want = eb.edge_block_add_fold_lanes_plain(view, vals, degd, act, [0],
                                              red=red0.clone(), **kw)[0]
    torch.cuda.synchronize()
    if not _same_bits(got, old):
        raise AssertionError("streamed float-add fold != the route it "
                             f"replaced (max err {_max_err(got, old)})")
    if not _close(got, want, rtol=1e-5, atol=1e-6):
        raise AssertionError("streamed float-add fold != plain (max err "
                             f"{_max_err(got, want)})")
    ms = _time_ms(torch, fused, reps=20)
    parent_ms = _time_ms(torch, parent, reps=20)
    dev_ms = _device_ms(torch, fused, "stream_fold")
    # the replaced route's own device time: kernel 1, kernel 4's fill,
    # tiles and fold, the add
    pdev = {k: _device_ms(torch, parent, k)
            for k in ("edge_block", "segment_", "CUDAFunctor_add")}
    pdev_ms = (None if None in pdev.values() else sum(pdev.values()))
    plain_ms = _time_ms(torch, plain, reps=5, warmup=1)
    valid = slot != PAD
    n_valid = int(valid.sum())
    # the library call: the partition's (V x V) CSR times the messages
    owner = key.long()[:, None].expand_as(slot)[valid]
    cols = slot[valid].long()
    order = torch.argsort(owner * V + cols)
    crow = torch.zeros(V + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(torch.bincount(owner, minlength=V), 0)
    A = torch.sparse_csr_tensor(crow, cols[order],
                                torch.ones(n_valid, device="cuda"),
                                size=(V, V))
    msg = vals[0] / torch.clamp_min(degd, 1).to(torch.float32)
    lib = A @ msg
    torch.cuda.synchronize()
    if not _close(lib, want[0], rtol=1e-5, atol=1e-6):
        raise AssertionError("the CSR product != the float-add route")
    lib_ms = _time_ms(torch, lambda: A @ msg, reps=20)
    # ids and keys once, the message of each source the slots name once,
    # each owner's running entry read and written; the old reckoning
    # wrote a (V,) partial instead
    n_src = int(torch.unique(slot[valid].long()).numel())
    n_own = int(torch.unique(key[key < V]).numel())
    bound = 1e3 * (rows * 36 + n_src * 4 + n_own * 8) / _BANDWIDTH
    bound_old = 1e3 * (rows * 36 + n_src * 4 + V * 4) / _BANDWIDTH

    def opt(x):
        return "not measured" if x is None else f"{x:.4f} ms"

    log(f"[stream] float-add fold (edge_block_add_fold_lanes on the "
        f"superstep's pre-pass) on pagerank's pull partition {p} ({rows} "
        f"rows, {n_own} owners, {n_src} sources) at scale {OTHERS_SCALE}: "
        f"{ms:.4f} ms (device {opt(dev_ms)}); the route it replaced "
        f"(kernel 1 + kernel 4 + the add) {parent_ms:.4f} ms (device "
        f"{', '.join(f'{k} {opt(v)}' for k, v in pdev.items())}), equal "
        f"bit for bit; plain {plain_ms:.4f} ms, CSR product {lib_ms:.4f} "
        f"ms, bound {bound:.4f} ms ({bound / ms:.3f} of it; the old "
        f"reckoning with a (V,) partial {bound_old:.4f} ms), on {smi}")
    return {"ms": ms, "device_ms": dev_ms, "parent_ms": parent_ms,
            "parent_device_ms": pdev_ms, "parent_device_ms_by_kernel": pdev,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound, "bound_ms_old": bound_old,
            "max_abs_err": _max_err(got, want), "rows": rows,
            "partition": p, "sources": n_src, "owners": n_own,
            "shape": [rows, 8, V, 1]}


def _general_programs(torch, dsl):
    """Weighted gathers outside the menu, one a reduce the general
    partial folds differently: min (exact) and float add (kernel 4's
    order, within rtol 1e-5)."""
    return {
        "min": dsl.VertexProgram(
            name="two_w", gather=lambda v, w, d: v + 2 * w, reduce="min",
            apply=torch.minimum, init_value=float("inf"),
            frontier="changed", value_dtype=torch.float32),
        "add": dsl.VertexProgram(
            name="affine_w", gather=lambda v, w, d: v * w + 1,
            reduce="add", apply=lambda old, s: 0.5 * s, init_value=1.0,
            frontier="all", value_dtype=torch.float32, mask_inactive=False,
            max_iters=5),
    }


def _general_route_timing(torch, store, gather, values, smi):
    """Kernel 4 on the general partial's route: the largest pull
    partition's rows (the user's gather over its slots at ``values``,
    each row min-reduced) folded by owner, against its plain version,
    ``scatter_reduce_`` amin into an identity-filled table, and the byte
    bound (keys and row values read once, the (V,) partial written)."""
    from repro_torch.kernels import segment_sum as ss
    from repro_torch.kernels.ref import PAD
    V = values.shape[0]
    p = int(np.argmax(store.rows_per_partition["pull"]))
    key, slot, wgt, rows = _partition_on_card(torch, store, "pull", p)
    valid = slot != PAD
    safe = torch.where(valid, slot, 0).long()
    msg = torch.where(valid, gather(values[safe], wgt, None), float("inf"))
    row = msg.amin(1)

    def kernel():
        return ss.segment_reduce(key, row, V, reduce="min")

    got = kernel()
    want = ss.segment_reduce_ref(key, row, V, reduce="min")
    table = torch.full((V,), float("inf"), device="cuda")
    key64 = key.long()
    table.scatter_reduce_(0, key64, row, "amin", include_self=True)
    torch.cuda.synchronize()
    if not (_same(got, want) and _same(got, table)):
        raise AssertionError("kernel 4 on the general route != its plain "
                             "version or scatter_reduce_")
    ms = _time_ms(torch, kernel, reps=20)
    dev_ms = _device_ms(torch, kernel, "segment_")
    plain_ms = _time_ms(torch, lambda: ss.segment_reduce_ref(
        key, row, V, reduce="min"), reps=10)
    # amin is idempotent: the repeated calls need no fresh table
    lib_ms = _time_ms(torch, lambda: table.scatter_reduce_(
        0, key64, row, "amin", include_self=True), reps=20)
    bound = 1e3 * max((rows * 8 + V * 4) / _BANDWIDTH, rows / _SCALAR_OPS)
    log(f"[stream] kernel 4 on the general route (pull partition {p}, "
        f"{rows} rows, min): {ms:.4f} ms (device "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.4f}'}), plain "
        f"{plain_ms:.4f} ms, scatter_reduce_ amin {lib_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({bound / ms:.3f} of it), on {smi}")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound,
            "max_abs_err": _max_err(got, want), "partition": p,
            "shape": [rows, V]}


def _float64_replay(torch, g, prog, iters):
    """``prog`` (frontier 'all', every source sending, a float add) for
    ``iters`` supersteps in float64 on the card, ``index_add_`` over every
    edge: the sums without float32's reassociation, to hold a float-add
    run against."""
    V = g.num_vertices
    deg = g.out_degrees.to("cuda")
    src = torch.repeat_interleave(torch.arange(V, device="cuda"),
                                  deg.long())
    dst = g.edges_dst.to("cuda").long()
    w = g.edge_weights.to("cuda", torch.float64)
    v = torch.full((V,), float(prog.init_value), dtype=torch.float64,
                   device="cuda")
    for _ in range(iters):
        s = torch.zeros_like(v).index_add_(
            0, dst, prog.gather(v[src], w, deg[src]).double())
        v = prog.apply(v, s)
    return v


def _max_rel(a, b):
    """Largest |a - b| / |b| (``b`` the reference), in float64."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())


def _stream_general(torch, g, smi):
    """Weighted gathers outside the menu streamed through the general
    partial on the scale-22 graph with random weights, in
    ``STREAM_PARTITIONS`` partitions: the min program bitwise equal to the
    resident run of the same program on the card; the float add within
    rtol 1e-5 of the resident run and of a float64 replay, two streamed
    runs and two resident runs each bitwise equal; iterations equal,
    kernel 4's launches against the swept pull partitions, no lane
    kernel; then kernel 4 timed on the route."""
    import dataclasses
    from repro_torch.core import dsl, preprocess
    from repro_torch.core.scheduler import DirectionPolicy, ScheduleConfig
    from repro_torch.core.translator import translate

    P = STREAM_PARTITIONS
    w = np.random.default_rng(4).uniform(0.5, 2.0, g.num_edges)
    gw = dataclasses.replace(g, edge_weights=torch.from_numpy(
        w.astype(np.float32)))
    del w
    lane_kernels = ("edge_block", "edge_block_skip", "edge_block_lanes",
                    "edge_block_fold", "edge_block_prepare", "lanes_prepare",
                    "push_lanes_prepare", "push_ell", "push_ell_fused",
                    "push_ell_lanes")
    out, timing, seg_launches = {}, None, 0
    for red, prog in _general_programs(torch, dsl).items():
        root = 0 if red == "min" else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resident = translate(prog, gw, ScheduleConfig(), device="cuda")
        ref, rit = resident.run(roots=root)
        torch.cuda.synchronize()
        res_s = time.perf_counter() - t0
        for mode in ("pull", "push", "auto") if red == "min" else ("pull",):
            sp = translate(prog, gw, ScheduleConfig(
                partitions=P, direction=DirectionPolicy(mode=mode)),
                device="cuda")
            if not sp._general or sp.report.gather_module is not None:
                raise AssertionError(f"{prog.name}: not the general route")
            _zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v, it = sp.run(roots=root)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _read_counts()
            st = sp.last_run_stats
            extra = {}
            if red == "min":
                same = _same_bits(v, ref)
            else:
                exact = _float64_replay(torch, gw, prog, prog.max_iters)
                v2, _ = sp.run(roots=root)
                extra = {"stream_vs_float64": _max_rel(v, exact),
                         "resident_vs_float64": _max_rel(ref, exact),
                         "stream_vs_resident": _max_rel(v, ref),
                         "stream_runs_bitwise": _same_bits(v, v2),
                         "resident_runs_bitwise": _same_bits(
                             resident.run()[0], ref)}
                same = _close(v, ref, rtol=1e-5, atol=1e-6) \
                    and _close(v.double(), exact, rtol=1e-5, atol=1e-6) \
                    and extra["stream_runs_bitwise"] \
                    and extra["resident_runs_bitwise"]
                del exact, v2
            segs = launches["segment_reduce"]
            swept = st["partitions_swept"]
            want_segs = {"pull": swept, "push": 0}.get(mode)
            if not same or it != rit \
                    or any(launches[k] for k in lane_kernels) \
                    or (want_segs is not None and segs != want_segs) \
                    or not (st["pull_supersteps"] == 0 or 0 < segs <= swept):
                raise AssertionError(
                    f"streamed {prog.name} {mode}: agrees {same} (max err "
                    f"to the resident run {_max_err(v, ref)}; {extra}), "
                    f"iters {it} / {rit}, kernel 4 launches {segs} for "
                    f"{swept} swept partitions, launches {launches}")
            if red == "min" and mode == "pull":
                seg_launches = segs
                timing = _general_route_timing(
                    torch, sp.store, prog.gather, ref, smi)
            out[f"{red} {mode}"] = {
                "iters": it, "wall_s": wall, "resident_s": res_s,
                "launches_segment_reduce": segs, "partitions_swept": swept,
                "bytes": st["partition_bytes_h2d"],
                "max_abs_err": _max_err(v, ref), **extra}
            held = ("bitwise the resident run" if red == "min" else
                    f"within rtol 1e-5 of the resident run (max rel "
                    f"{extra['stream_vs_resident']:.3e}) and of a float64 "
                    f"replay (the stream {extra['stream_vs_float64']:.3e}, "
                    f"the resident run {extra['resident_vs_float64']:.3e} "
                    f"from it), two streamed and two resident runs "
                    f"bitwise")
            log(f"[stream] general route {prog.name} ({red}) {mode}: {held} "
                f"(resident {res_s:.3f} s with its set-up), iters {it}; "
                f"{wall:.3f} s (store built in it), "
                f"{st['partition_bytes_h2d']} bytes, kernel 4 launches "
                f"{segs} for {swept} swept partitions, no lane kernel, on "
                f"{smi}")
            del sp, v
        del resident
    # the weighted copy's layouts (host and device) go with it
    preprocess._LAYOUT_CACHE.pop(preprocess._layout_key(gw), None)
    del gw, ref
    return out, seg_launches, timing


def phase_stream(torch, dev_info, main):
    """Out-of-core streaming on the main phase's scale-22 graph: see the
    module docstring (step 8)."""
    import gc
    import shutil
    from repro_torch.core import algorithms as alg
    from repro_torch.core import dsl, faults, preprocess
    from repro_torch.core import graph as G
    from repro_torch.core.comm import CommManager
    from repro_torch.core.scheduler import DirectionPolicy, ScheduleConfig
    from repro_torch.core.translator import translate
    from repro_torch.data import graphs as D
    from repro_torch.errors import InjectedFault
    from repro_torch.serve.graph_serve import GraphServer

    t_phase = time.perf_counter()
    g, oracle, smi = main["g"], main["oracle"], dev_info["smi"]
    V, E, P = g.num_vertices, g.num_edges, STREAM_PARTITIONS
    deg = g.out_degrees.numpy().astype(np.int64)
    traversed = alg.traversed_edges(g, oracle)
    bfs = dsl.bfs_program(INT_MAX)
    work = os.path.join(ROOT, "build", "stream")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    def cfg(mode="pull", **kw):
        return ScheduleConfig(direction=DirectionPolicy(mode=mode), **kw)

    # ---- the resident dense runs on the card: the answers to hold, and
    # the device memory the resident engine needs
    for lay in preprocess._LAYOUT_CACHE.values():
        lay._on_device.clear()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    resident = {}
    for d in ("pull", "push", "auto"):
        prog = translate(bfs, g, cfg(d, pull_sweep="dense"), device="cuda")
        v, it = prog.run(roots=0)
        resident[d] = (v.cpu().numpy(), it, dict(prog.last_run_stats))
    torch.cuda.synchronize()
    mem_res = torch.cuda.max_memory_allocated()
    del prog, v
    for d in ("pull", "push", "auto"):
        if not np.array_equal(resident[d][0].astype(np.int64), oracle):
            raise AssertionError(f"resident bfs {d} != numpy_bfs")

    # ---- the streamed programs, one a direction ------------------------
    progs = {}
    for lay in preprocess._LAYOUT_CACHE.values():
        lay._on_device.clear()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_s = torch.cuda.memory_allocated()
    checks = {}
    for d in ("pull", "push", "auto"):
        comm = CommManager()
        t0 = time.perf_counter()
        prog = translate(bfs, g, cfg(d, partitions=P), comm, device="cuda")
        translate_s = time.perf_counter() - t0
        reads0 = prog.lane_reads
        _zero_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        v, it = prog.run(roots=0)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t1
        launches = _read_counts()
        reads = prog.lane_reads - reads0
        st = dict(prog.last_run_stats)
        store = prog.store
        if d == "pull":
            mem_stream = torch.cuda.max_memory_allocated()
            ss_ = store.stats()
            log(f"[stream] ScheduleConfig(partitions={P}) at scale {SCALE}: "
                f"plan {prog.report.num_partitions} partitions, cuts "
                f"{store.cuts.tolist()}, edges a partition "
                f"{store.edges_per_partition.tolist()}; pull_rows "
                f"{ss_['pull_rows']}, push_rows {ss_['push_rows']}, "
                f"entry_bytes {ss_['entry_bytes']} (real rows a partition: "
                f"pull {store.rows_per_partition['pull'].tolist()}, push "
                f"{store.rows_per_partition['push'].tolist()})")
        want, iters, sweeps, prepasses, trips, planes = _stream_replay(
            oracle, deg, store, d, prog._policy, E)
        vv = v.cpu().numpy()
        if not (np.array_equal(vv, resident[d][0]) and it == resident[d][1]
                and it == iters):
            raise AssertionError(f"streamed bfs {d}: values or iters "
                                 f"({it}) != the resident run's "
                                 f"({resident[d][1]}) or the oracle's")
        bad = {k: (st[k], w) for k, w in want.items() if st[k] != w}
        # the counters both engines define alike (the resident engine also
        # counts a push run's first superstep as a switch, and sweeps all
        # E edges a pull superstep)
        same = ("push_supersteps", "pull_supersteps")
        if d != "auto":
            bad.update({k: (st[k], resident[d][2][k]) for k in same
                        if st[k] != resident[d][2][k]})
        if bad:
            raise AssertionError(f"streamed bfs {d}: run_stats (got, want) "
                                 f"{bad}")
        if st["partitions_swept"] + st["partitions_skipped"] != P * it:
            raise AssertionError("partitions swept + skipped != P x steps")
        expect = {"edge_block_fold": sweeps["pull"],
                  "edge_block_fold_acc": sweeps["pull"],
                  "push_ell_lanes": sweeps["push"],
                  "lanes_prepare": prepasses["pull"],
                  "push_lanes_prepare": prepasses["push"],
                  "edge_block": 0, "edge_block_skip": 0,
                  "edge_block_lanes": 0, "edge_block_prepare": 0,
                  "edge_block_add_fold": 0, "push_ell": 0,
                  "push_ell_fused": 0, "segment_reduce": 0}
        wrong = {k: (launches[k], n) for k, n in expect.items()
                 if launches[k] != n}
        if wrong or reads != it:
            raise AssertionError(f"streamed bfs {d}: launches (got, want) "
                                 f"{wrong}; device reads {reads} for {it} "
                                 "supersteps")
        checks[d] = {"iters": it, "launches": launches, "reads": reads,
                     "first_run_s": first_s, "translate_s": translate_s,
                     "run_stats": st, "sweeps": sweeps, "trips": trips,
                     "planes": planes}
        progs[d] = prog
        log(f"[stream] bfs {d}: iters {it} = resident = oracle, values = "
            f"resident bitwise; run_stats = the numpy replay of the "
            f"stream's accounting {json.dumps(want)}; launches {launches}; "
            f"{reads} device reads for {it} supersteps; translate "
            f"{translate_s:.2f} s, first run {first_s:.2f} s (store built "
            f"then: {store.stats()['build_s']:.2f} s)")
    if not mem_stream < mem_res:
        raise AssertionError(f"streamed peak device memory {mem_stream} >= "
                             f"the resident dense run's {mem_res}")
    log(f"[stream] torch.cuda.max_memory_allocated: streamed pull run "
        f"{mem_stream / 2**30:.3f} GiB (from {base_s / 2**30:.3f} GiB held "
        f"before), resident dense runs {mem_res / 2**30:.3f} GiB (from "
        f"{base / 2**30:.3f} GiB), on {smi}")

    # no scatter_reduce_ and no single-lane fused push: the profiler of
    # a streamed auto run
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        progs["auto"].run(roots=0)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    scat = sum(e.count for e in ev if "scatter_reduce" in e.key
               or "index_reduce" in e.key)
    fused_k = sum(e.count for e in ev if e.device_type == DeviceType.CUDA
                  and "push_ell_fused" in e.key)
    kern = sorted({e.key[:60] for e in ev
                   if e.device_type == DeviceType.CUDA
                   and ("fold" in e.key or "lanes" in e.key)})
    if scat or fused_k or not kern:
        raise AssertionError(f"streamed auto profile: scatter/index_reduce "
                             f"{scat}, fused push kernels {fused_k}, lane "
                             f"kernels {kern}")
    log(f"[stream] profile of a streamed auto run: no scatter_reduce / "
        f"index_reduce, no fused push kernel; lane kernels {kern}")

    # ---- steady walls, in turns ------------------------------------------
    walls = {d: [] for d in progs}
    stats = {}
    for _ in range(3):
        for d, prog in progs.items():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            prog.run(roots=0)
            torch.cuda.synchronize()
            walls[d].append(time.perf_counter() - t1)
            stats[d] = dict(prog.last_run_stats)
    steady = {}
    for d in progs:
        w = float(np.median(walls[d]))
        st = stats[d]
        it = st["push_supersteps"] + st["pull_supersteps"]
        rate = st["partition_bytes_h2d"] / st["partition_transfer_s"] \
            if st["partition_transfer_s"] > 0 else 0.0
        steady[d] = {"run_wall_s": w, "walls_s": walls[d],
                     "mteps": traversed / w / 1e6, "iters": it,
                     "bytes_run": st["partition_bytes_h2d"],
                     "bytes_superstep": st["partition_bytes_h2d"] / it,
                     "transfer_s": st["partition_transfer_s"],
                     "compute_s": st["partition_compute_s"],
                     "wall_s": st["partition_wall_s"],
                     "overlap_efficiency": st["overlap_efficiency"],
                     "h2d_rate": rate,
                     "partitions_swept": st["partitions_swept"]}
        log(f"[stream] bfs {d} steady: run wall {w * 1e3:.3f} ms (runs "
            f"{[round(x * 1e3, 3) for x in walls[d]]}), MTEPS "
            f"{traversed / w / 1e6:.1f}; {st['partition_bytes_h2d']} bytes "
            f"shipped a run ({st['partition_bytes_h2d'] / it:.0f} a "
            f"superstep, {st['partitions_swept']} partition sweeps); "
            f"transfer {st['partition_transfer_s'] * 1e3:.3f} ms, compute "
            f"{st['partition_compute_s'] * 1e3:.3f} ms, streamed wall "
            f"{st['partition_wall_s'] * 1e3:.3f} ms, overlap_efficiency "
            f"{st['overlap_efficiency']:.3f}; H2D {rate / 1e9:.2f} GB/s, on "
            f"{smi}")

    # the transfer phase's bound: a plain pinned copy of the largest entry
    store = progs["pull"].store
    biggest = max(store.stats()["entry_bytes"].values())
    host = torch.empty(biggest, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(biggest, dtype=torch.uint8, device="cuda")
    copy_ms = _time_ms(torch, lambda: dev.copy_(host, non_blocking=True),
                       reps=10)
    pinned_rate = biggest / (copy_ms / 1e3)
    del host, dev
    log(f"[stream] a plain pinned copy_ of the largest entry ({biggest} "
        f"bytes): {copy_ms:.4f} ms, {pinned_rate / 1e9:.2f} GB/s; the "
        f"stream's copies reached "
        f"{', '.join(f'{d} {steady[d]['h2d_rate'] / 1e9:.2f}' for d in steady)}"
        f" GB/s")

    # ---- run_batch over 8 roots ----------------------------------------
    res_prog = translate(bfs, g, cfg("pull", pull_sweep="dense"),
                         device="cuda")
    rng = np.random.default_rng(0)
    cand = np.flatnonzero(deg > 0)
    roots = rng.choice(cand, STREAM_BATCH, replace=False)
    vb, ib = progs["pull"].run_batch(roots)
    rb, rib = res_prog.run_batch(roots)
    if not (torch.equal(vb, rb) and torch.equal(ib, rib)):
        raise AssertionError("streamed run_batch != resident run_batch")
    log(f"[stream] run_batch over {STREAM_BATCH} roots = resident "
        f"run_batch bitwise (iters {ib.tolist()})")

    # ---- a checkpointed bfs killed at a partition boundary -------------
    prog = progs["auto"]
    trips = checks["auto"]["trips"]
    ref_v = resident["auto"][0]
    ck1 = os.path.join(work, "ck_plain")
    v, it = prog.run(roots=0, checkpoint_dir=ck1, checkpoint_every=8)
    st1 = dict(prog.last_run_stats)
    if not np.array_equal(v.cpu().numpy(), ref_v):
        raise AssertionError("checkpointed streamed bfs != uncut run")
    at = [i for i, (kind, _) in enumerate(trips) if kind == "partition"]
    after = at[len(at) // 2]
    ck2 = os.path.join(work, "ck_crash")
    plan = faults.arm("lane.crash", times=1, after=after)
    try:
        prog.run(roots=0, checkpoint_dir=ck2, checkpoint_every=8)
    except InjectedFault:
        pass
    finally:
        faults.reset()
    if plan.fired != 1:
        raise AssertionError("the armed lane.crash never fired")
    v, it2 = prog.run(roots=0, checkpoint_dir=ck2, checkpoint_every=8,
                      resume=True)
    st2 = dict(prog.last_run_stats)
    if not np.array_equal(v.cpu().numpy(), ref_v) or it2 != it \
            or st2["checkpoint_loads"] != 1:
        raise AssertionError("crashed and resumed streamed bfs != uncut")
    log(f"[stream] checkpointed bfs auto (every 8 sweeps) = uncut: saves "
        f"{st1['checkpoint_saves']}; killed at trip {after} "
        f"({trips[after]}, a partition boundary) and resumed from its "
        f"snapshot: = uncut, loads {st2['checkpoint_loads']}")

    # ---- serving over the streamed schedule ------------------------------
    comm = CommManager()
    srv = GraphServer(g, schedule=cfg("auto", partitions=P), comm=comm,
                      device="cuda")
    qroots = rng.choice(cand, STREAM_QUERIES, replace=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    qs = [srv.submit("bfs", int(r)) for r in qroots]
    srv.run()
    serve_s = time.perf_counter() - t1
    for q, r in zip(qs, qroots):
        ref, _ = res_prog.run(roots=int(r))
        if not (q.done and np.array_equal(np.asarray(q.result),
                                          ref.cpu().numpy())):
            raise AssertionError(f"served streamed bfs root {r} != the "
                                 "sequential resident run")
    if comm.stats.partition_bytes_h2d <= 0:
        raise AssertionError("the server streamed no partition bytes")
    log(f"[stream] GraphServer over ScheduleConfig(partitions={P}): "
        f"{STREAM_QUERIES} bfs = sequential resident runs bitwise, "
        f"{serve_s:.2f} s ({STREAM_QUERIES / serve_s:.1f} queries/s), "
        f"{comm.stats.partition_bytes_h2d} bytes streamed, overlap "
        f"{comm.stats.overlap_efficiency():.3f}; counters {srv.counters()}")
    del srv

    # ---- the routes' kernels at the stream's shapes ---------------------
    # the push route at auto's heaviest push superstep (most frontier
    # out-edges), the pull route at the widest level
    pushed = [s for s, plane in enumerate(checks["auto"]["planes"])
              if plane == "push"] or [1]
    push_level = max(pushed, key=lambda s: int(deg[oracle == s].sum()))
    timing = _stream_route_timing(torch, g, oracle, store, push_level, smi)
    build_s = {d: p.store.stats()["build_s"] for d, p in progs.items()}
    launches_bfs = {d: checks[d]["launches"] for d in checks}
    del progs, res_prog, prog
    gc.collect()
    torch.cuda.empty_cache()

    # ---- weighted gathers outside the menu: the general partial ---------
    general, general_segs, gtime = _stream_general(torch, g, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- scale 20: SSSP, PageRank, a container under a byte budget ------
    V2, E2 = 1 << OTHERS_SCALE, 16 << OTHERS_SCALE
    src, dst = G.rmat_edges(V2, E2, seed=1)
    w = np.random.default_rng(2).uniform(1.0, 10.0, len(src)) \
        .astype(np.float32)
    g2 = G.from_edge_list(src, dst, num_vertices=V2, weights=w)
    del src, dst, w
    ref_d, _ = translate(dsl.sssp_program(), g2, cfg("auto"),
                         device="cuda").run(roots=0)
    d_s, _ = translate(dsl.sssp_program(), g2, cfg("auto", partitions=P),
                       device="cuda").run(roots=0)
    if not _same_bits(ref_d, d_s):
        raise AssertionError("streamed sssp != resident sssp bitwise")
    ref_r, _ = translate(dsl.pagerank_program(), g2, cfg("pull"),
                         device="cuda").run()
    pr = translate(dsl.pagerank_program(), g2, cfg("pull", partitions=P),
                   device="cuda")
    _zero_counts()
    r1, pit = pr.run()
    torch.cuda.synchronize()
    pr_launches = _read_counts()
    r2, _ = pr.run()
    pst = pr.last_run_stats
    if not (_close(r1, ref_r, rtol=1e-5, atol=1e-7)
            and _same_bits(r1, r2)):
        raise AssertionError(f"streamed pagerank: max err "
                             f"{_max_err(r1, ref_r)} against resident, or "
                             "two streamed runs differ")
    # one fused float-add fold a swept partition (its carry fold
    # included), one pre-pass a superstep, and nothing of the route it
    # replaced (kernel 1, the lane kernel, kernel 4)
    if pr_launches["edge_block_add_fold"] != pst["partitions_swept"] \
            or pr_launches["lanes_prepare"] != pit \
            or any(pr_launches[k] for k in (
                "edge_block", "edge_block_lanes", "edge_block_prepare",
                "segment_reduce", "edge_block_fold")):
        raise AssertionError(f"streamed pagerank launches {pr_launches}")
    pr_timing = _pagerank_route_timing(torch, g2, pr, smi)
    log(f"[stream] scale {OTHERS_SCALE}: streamed sssp = resident bitwise; "
        f"streamed pagerank ({pit} iterations) within rtol 1e-5 of the "
        f"resident run (max |err| {_max_err(r1, ref_r):.3e}) and bitwise "
        f"equal across two streamed runs; launches {pr_launches}")
    path = D.container_from_graph(os.path.join(work, "scale20.npz"), g2, P)
    c = D.load_partition_container(path)
    budget = 3 * int(max(c.pull_rows.max(), c.push_rows.max())) * (4 + 64)
    ref_b, _ = translate(bfs, g2, cfg("auto"), device="cuda").run(roots=0)
    pc = translate(bfs, c, cfg("auto", partition_budget_bytes=budget),
                   device="cuda")
    b_c, _ = pc.run(roots=0)
    cst = pc.last_run_stats["partition_store"]
    if not torch.equal(b_c, ref_b) or cst["evictions"] <= 0:
        raise AssertionError(f"container bfs under a {budget}-byte budget "
                             f"!= resident, or no eviction: {cst}")
    log(f"[stream] container (container_from_graph, scale "
        f"{OTHERS_SCALE}, {c.partitions} partitions) under "
        f"partition_budget_bytes={budget}: bfs = resident bitwise, store "
        f"{json.dumps(cst)}")
    del pc, c, pr, g2
    shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    log(f"[stream] phase wall {phase_s:.1f} s; store build (set-up) s by "
        f"program {json.dumps({k: round(v, 2) for k, v in build_s.items()})}")
    summary = {"partitions": P, "checks": {
        d: {k: v for k, v in c_.items() if k != "trips"}
        for d, c_ in checks.items()},
        "steady": steady, "memory": {"streamed_peak": mem_stream,
                                     "resident_peak": mem_res,
                                     "streamed_base": base_s,
                                     "resident_base": base},
        "pinned_copy_ms": copy_ms, "pinned_rate": pinned_rate,
        "timing": timing, "pagerank_timing": pr_timing,
        "general": general, "general_timing": gtime,
        "build_s": build_s, "phase_s": phase_s, "card": smi}
    with open(os.path.join(OUT_DIR, "chip_smoke_stream.json"), "w") as f:
        json.dump(summary, f, indent=1, default=str)
    fold, push = timing["fold"], timing["push"]
    return [
        {"name": "edge_block_fold_lanes (streamed, accumulate)",
         "route": "cuda", "source": "src/repro_torch/csrc/edge_block.cu",
         "replaces": "src/repro/kernels/edge_block.py:147",
         "launches": launches_bfs["pull"]["edge_block_fold_acc"],
         "max_abs_err": fold["max_abs_err"], "ms": fold["ms"],
         "plain_ms": fold["plain_ms"], "bound_ms": fold["bound_ms"],
         "bound_by": "bytes", "library_ms": None, "shape": fold["shape"]},
        {"name": "push_ell_lanes_reduce (streamed, got)",
         "route": "cuda", "source": "src/repro_torch/csrc/push_ell.cu",
         "replaces": "src/repro/kernels/push_ell.py:134",
         "launches": launches_bfs["push"]["push_ell_lanes"],
         "max_abs_err": push["max_abs_err"], "ms": push["ms"],
         "plain_ms": push["plain_ms"], "bound_ms": push["bound_ms"],
         "bound_by": "bytes", "library_ms": None, "shape": push["shape"]},
        {"name": "edge_block_add_fold_lanes (streamed float add)",
         "route": "cuda", "source": "src/repro_torch/csrc/stream_fold.cu",
         "replaces": "src/repro/kernels/edge_block.py:33",
         "launches": pr_launches["edge_block_add_fold"],
         "max_abs_err": pr_timing["max_abs_err"], "ms": pr_timing["ms"],
         "plain_ms": pr_timing["plain_ms"],
         "bound_ms": pr_timing["bound_ms"], "bound_by": "bytes",
         "library_ms": pr_timing["library_ms"],
         "shape": pr_timing["shape"]},
        {"name": "segment_reduce (streamed general gather, by owner)",
         "route": "cuda", "source": "src/repro_torch/csrc/segment_sum.cu",
         "replaces": "src/repro/kernels/segment_sum.py:24",
         "launches": general_segs, "max_abs_err": gtime["max_abs_err"],
         "ms": gtime["ms"], "plain_ms": gtime["plain_ms"],
         "bound_ms": gtime["bound_ms"], "bound_by": "bytes",
         "library_ms": gtime["library_ms"], "shape": gtime["shape"]},
    ]


MULTI_PES = (2, 4)          # the PE counts of the multi-PE phase
MULTI_BATCH = 8             # run_batch roots at pes=2
MULTI_QUERIES = 16          # bfs queries served at pes=2
# the fields a PE group reports otherwise than one PE; the last two are
# the run loop's CUDA graphs, which a single-PE dense plan alone replays
MULTI_KEYS = ("pes", "push_live_rows_per_pe", "push_compacted_supersteps",
              "push_fallback_supersteps", "exchange_supersteps",
              "exchange_bytes", "replayed_supersteps", "graph_captures")


def _pe_replay(oracle, deg, rpv, cuts, tiers, mode, policy, num_edges):
    """A numpy replay of a resident dense BFS from root 0 on a PE group,
    from the oracle's levels: each superstep's direction (``'auto'``
    replays the hysteresis in float32, the pull cost E after a dense
    sweep), each PE's live forward-ELL rows (its vertex bounds ``cuts``),
    and whether the push fit a tier on every PE (compacted, an exchange)
    or took the replicated fallback.  Returns the run_stats it predicts."""
    V = len(oracle)
    top = int(oracle[oracle < INT_MAX].max())
    rows = [0] * (len(cuts) - 1)
    out = {"push_supersteps": 0, "push_compacted_supersteps": 0}
    direction, pull_cost = 0, num_edges
    for s in range(top + 1):
        act = oracle == s
        n_f, m_f = int(act.sum()), int(deg[act].sum())
        if mode == "push":
            d = 1
        elif direction == 1:
            d = int(np.float32(m_f) * np.float32(policy.alpha)
                    < np.float32(pull_cost))
        else:
            d = int(np.float32(n_f) * np.float32(policy.beta)
                    < np.float32(V))
        if d:
            live = np.where(act, rpv, 0)
            r_f = [int(live[lo:hi].sum())
                   for lo, hi in zip(cuts[:-1], cuts[1:])]
            rows = [a + b for a, b in zip(rows, r_f)]
            out["push_supersteps"] += 1
            out["push_compacted_supersteps"] += int(max(r_f) <= tiers[-1])
        else:
            pull_cost = num_edges
        direction = d
    out["push_fallback_supersteps"] = (out["push_supersteps"]
                                       - out["push_compacted_supersteps"])
    out["push_live_rows_per_pe"] = rows
    return out


def _multi_pe_kernel_timing(torch, lay, g, oracle, pes, smi):
    """Kernels 3f and 3L as the multi-PE push launches them, on PE 0's
    interval at ``pes`` PEs: 3f (with its compaction) on the widest BFS
    level the sharded push compacts, 3L on root 0's BFS frontiers (lane i
    at level i mod 6) for 8 lanes; each against its plain version,
    exactly, timed (CUDA events) beside its bound."""
    from types import SimpleNamespace
    from repro_torch.core.scheduler import push_capacity_tiers
    from repro_torch.kernels import push_ell as pe
    from repro_torch.kernels.ref import PAD
    sfe = lay.forward_ell_shards(8, pes)
    rs, dst, wgt = (t.to("cuda") for t in sfe.interval(0))
    n, W, V = sfe.rows_per_pe[0], sfe.width, g.num_vertices
    out_deg = g.out_degrees.to(device="cuda", dtype=torch.int32)
    tiers = push_capacity_tiers(sfe.rows_per_pe_max)
    rpv = lay.forward_ell(8).rows_per_vertex.numpy().astype(np.int64)
    lo, hi = sfe.vertex_cuts[:2]
    top = int(oracle[oracle < INT_MAX].max())
    r0 = {lvl: int(np.where(oracle[lo:hi] == lvl, rpv[lo:hi], 0).sum())
          for lvl in range(top + 1)}
    fits = [lvl for lvl in r0 if 0 < r0[lvl] <= tiers[-1]]
    lvl = max(fits, key=lambda x: r0[x])
    lv_all = torch.as_tensor(oracle.astype(np.int64)).to("cuda")
    state = torch.where(lv_all <= lvl, lv_all, INT_MAX).to(torch.int32)
    front = lv_all == lvl
    cap = next(c for c in tiers if r0[lvl] <= c)
    sel, ok = pe.compact_rows(front[rs.long()], n, cap)
    fused = _fused_push_timing(
        torch, SimpleNamespace(row_src=rs, dst=dst, weights=wgt), state,
        out_deg, sel, ok, f"PE 0 of {pes}, BFS level {lvl} (r_f {r0[lvl]}, "
        f"tier {cap})", smi)
    k = MULTI_BATCH
    levels = torch.as_tensor(np.minimum(oracle, INT_MAX).astype(np.int32))
    values = levels.to("cuda").expand(k, V).contiguous()
    active = torch.stack([torch.as_tensor(oracle == (i % (top + 1)))
                          for i in range(k)]).to("cuda")
    lanes = list(range(k))
    kw = dict(gather="plus_one", reduce="min", identity=INT32_MAX)
    args = (rs, dst, wgt, values, out_deg, active)

    def lane_push():
        return pe.push_ell_lanes_reduce(*args, lanes, num_rows=n, **kw)

    got = lane_push()
    want = pe.push_ell_lanes_reduce_plain(*args, lanes, num_rows=n, **kw)
    torch.cuda.synchronize()
    if not _same_bits(got, want):
        raise AssertionError(f"push_ell_lanes on PE 0's interval of {pes} "
                             "!= plain")
    err = _max_err(got, want)
    ms = _time_ms(torch, lane_push, reps=20)
    plain_ms = _time_ms(torch, lambda: pe.push_ell_lanes_reduce_plain(
        *args, lanes, num_rows=n, **kw), reps=3, warmup=1)
    live_rows = active[:, rs.long()]
    n_rows = int(live_rows.any(0).sum())
    n_pairs = int(live_rows.sum())
    n_slots = int((live_rows.to(torch.int64)
                   * (dst != PAD).sum(1)[None, :]).sum())
    # bytes the function must move: the interval's row_src once, each
    # lane's frontier over the interval's own vertices and the bits packed
    # from it, written and read, the (k, V) table written once (its fill;
    # the messages combine into it); per live row its W ids, per live
    # (row, lane) the source's value
    K = next(w for w in (1, 4, 8, 32) if w >= k)
    nv = hi - lo
    nbytes = (n * 4 + k * nv + 2 * nv * K // 8 + k * V * 4 + n_rows * W * 4
              + n_pairs * 4)
    bound = 1e3 * max(nbytes / _BANDWIDTH, n_slots / _SCALAR_OPS)
    log(f"[multi_pe] lane push (plus_one/min) k={k} on PE 0's interval of "
        f"{pes} ({n} rows, {n_pairs} live lane-rows, {n_slots} messages): "
        f"{ms:.4f} ms with the table's fill, bound {bound:.4f} ms "
        f"({bound / ms:.3f} of it), plain {plain_ms:.4f} ms; = plain "
        f"exactly, on {smi}")
    del got, want, values, active, live_rows
    lanes_row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                 "bytes": nbytes, "max_abs_err": err,
                 "shape": [k, n, W, V], "messages": n_slots}
    return fused, lanes_row


def phase_multi_pe(torch, dev_info, main):
    """Multi-PE execution on one card: a PE group of repeated devices
    (``devices=[cuda:0] * p``) on the main phase's scale-22 graph; see the
    module docstring (step 9)."""
    import gc
    from repro_torch.core import algorithms as alg
    from repro_torch.core import comm as C
    from repro_torch.core import dsl, faults, preprocess
    from repro_torch.core import graph as G
    from repro_torch.core.scheduler import (AdmissionPolicy, DirectionPolicy,
                                            ScheduleConfig,
                                            push_capacity_tiers)
    from repro_torch.core.translator import translate
    from repro_torch.errors import InjectedFault
    from repro_torch.serve.graph_serve import GraphServer

    t_phase = time.perf_counter()
    g, oracle, smi = main["g"], main["oracle"], dev_info["smi"]
    V, E = g.num_vertices, g.num_edges
    dev = torch.device("cuda", 0)
    deg = g.out_degrees.numpy().astype(np.int64)
    lay = preprocess.layouts_for(g)
    rpv = lay.forward_ell(8).rows_per_vertex.numpy().astype(np.int64)
    bfs = dsl.bfs_program(INT_MAX)
    policy = DirectionPolicy()

    def cfg(pes=1, mode="auto", **kw):
        return ScheduleConfig(pes=pes, direction=DirectionPolicy(mode=mode),
                              **kw)

    def group(p):
        return [dev] * p

    # ---- dense BFS: the sharded push at p in {2, 4} against p = 1 -------
    progs, runs = {}, {}
    for mode in ("push", "auto"):
        for p in (1,) + MULTI_PES:
            comm = C.CommManager()
            t1 = time.perf_counter()
            prog = translate(bfs, g, cfg(p, mode), comm, device="cuda",
                             devices=group(p) if p > 1 else None)
            translate_s = time.perf_counter() - t1
            _zero_counts()
            vals, iters = prog.run(roots=0)
            torch.cuda.synchronize()
            launches = _read_counts()
            lv = vals.cpu().numpy()
            st = dict(prog.last_run_stats)
            rep = prog.report
            progs[(mode, p)] = prog
            runs[(mode, p)] = (lv, iters, st, launches)
            if not np.array_equal(lv.astype(np.int64), oracle):
                raise AssertionError(f"bfs {mode} pes={p} != numpy_bfs")
            base_lv, base_it, base_st, base_l = runs[(mode, 1)]
            if not np.array_equal(lv, base_lv) or iters != base_it:
                raise AssertionError(f"bfs {mode} pes={p} != pes=1 bitwise")
            for k, v in base_st.items():
                if k not in MULTI_KEYS and st[k] != v:
                    raise AssertionError(f"bfs {mode} pes={p}: run_stats "
                                         f"{k} {st[k]} != pes=1's {v}")
            sfe = (lay.forward_ell_shards(8, p) if p > 1 else None)
            cuts = sfe.vertex_cuts if p > 1 else (0, V)
            tiers = push_capacity_tiers(sfe.rows_per_pe_max if p > 1
                                        else lay.forward_ell(8).num_rows)
            want = _pe_replay(oracle, deg, rpv, cuts, tiers, mode, policy, E)
            for k, v in want.items():
                if st[k] != v:
                    raise AssertionError(f"bfs {mode} pes={p}: {k} {st[k]} "
                                         f"!= the replay's {v}")
            ex = st["push_compacted_supersteps"] if p > 1 else 0
            nonempty = sum(n > 0 for n in sfe.rows_per_pe) if p > 1 else 1
            coll = int(2 * (p - 1) / p * V * 4) if p > 1 else 0
            sweeps = st["pull_supersteps"] + st["push_fallback_supersteps"]
            base_sweeps = (base_st["pull_supersteps"]
                           + base_st["push_fallback_supersteps"])
            checks = {
                "pes": st["pes"] == rep.pes == p,
                "exchange_supersteps": st["exchange_supersteps"] == ex,
                "exchange_bytes": st["exchange_bytes"] == ex * coll,
                "est_collective_bytes": rep.est_collective_bytes == coll,
                "est_frontier_bytes": rep.est_frontier_bytes == 0,
                "comm": comm.stats.collective_supersteps == (ex if p > 1
                                                             else 0),
                "3f launches": launches["push_ell_fused"]
                == st["push_compacted_supersteps"] * nonempty,
                "kernel 1 launches": sweeps == 0 or base_sweeps == 0
                or launches["edge_block"] * base_sweeps
                == base_l["edge_block"] * sweeps,
                "no message kernel": launches["push_ell"] == 0}
            if not all(checks.values()):
                raise AssertionError(f"bfs {mode} pes={p}: {checks}, "
                                     f"run_stats {st}, launches {launches}")
            log(f"[multi_pe] bfs dense {mode} pes={p}: iters={iters} = "
                f"numpy_bfs = pes=1 bitwise; translate {translate_s:.2f} s; "
                f"PE rows {rep.push_pe_rows} edges {rep.push_pe_edges}; "
                f"run_stats {json.dumps(st)}; launches {launches} (3f "
                f"{launches['push_ell_fused']} = {nonempty} a compacted "
                f"superstep, {launches['push_ell_fused'] // max(nonempty, 1)}"
                f" a PE; kernel 1 {launches['edge_block']})")

    # steady run walls at p = 1, 2, 4, in turns, median of 3
    walls = {key: [] for key in progs}
    for prog in progs.values():
        prog.run(roots=0)
    for _ in range(3):
        for key, prog in progs.items():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            prog.run(roots=0)
            torch.cuda.synchronize()
            walls[key].append(time.perf_counter() - t1)
    wall_ms = {f"{m} pes={p}": round(1e3 * float(np.median(w)), 3)
               for (m, p), w in walls.items()}
    runs_ms = {f"{m} pes={p}": [round(1e3 * x, 3) for x in w]
               for (m, p), w in walls.items()}
    log(f"[multi_pe] steady run walls (median of 3, in turns), ms: "
        f"{json.dumps(wall_ms)}; runs ms {json.dumps(runs_ms)} on {smi}")

    # the collectives alone, per exchanged superstep (CUDA events)
    coll_ms = {}
    rng = np.random.default_rng(5)
    for p in MULTI_PES:
        parts = [torch.as_tensor(rng.integers(0, 30, V).astype(np.int32))
                 .to(dev) for _ in range(p)]
        coll_ms[f"pmin int32 p={p}"] = _time_ms(torch, lambda: C.pmin(parts),
                                                reps=20)
    fparts = [torch.as_tensor(rng.random(V).astype(np.float32)).to(dev)
              for _ in range(2)]
    coll_ms["psum float32 p=2"] = _time_ms(torch, lambda: C.psum(fparts),
                                           reps=20)
    coll_ms["quantized_psum p=2"] = _time_ms(
        torch, lambda: C.quantized_psum(fparts), reps=20)
    words = [G.pack_bits(torch.as_tensor(rng.random(V) < 0.1).to(dev))
             for _ in range(2)]
    coll_ms["bitmap_or p=2"] = _time_ms(torch, lambda: C.bitmap_or(words),
                                        reps=20)
    del parts, fparts, words
    log(f"[multi_pe] collectives on {V}-entry tables, CUDA-event ms per "
        f"exchanged superstep: "
        f"{json.dumps({k: round(v, 4) for k, v in coll_ms.items()})} on {smi}")

    # the comm.collective fault: armed, the run raises typed; disarmed, it
    # equals the clean run
    prog = progs[("auto", 2)]
    with faults.injected("comm.collective"):
        try:
            prog.run(roots=0)
        except InjectedFault:
            pass
        else:
            raise AssertionError("comm.collective armed, no fault raised")
    vals, _ = prog.run(roots=0)
    if not np.array_equal(vals.cpu().numpy(), runs[("auto", 2)][0]):
        raise AssertionError("the run after the fault != the clean run")

    # ---- batched lanes and the server at pes=2 --------------------------
    pick = np.random.default_rng(0)
    cand = np.flatnonzero(deg > 0)
    roots = pick.choice(cand, MULTI_BATCH, replace=False)
    _zero_counts()
    pushes0 = prog.lane_pushes
    bv, bi = prog.run_batch(roots)
    torch.cuda.synchronize()
    batch_launches = _read_counts()
    bstats = prog.last_run_stats
    lane_pushes = prog.lane_pushes - pushes0
    seq = {}
    for i, r in enumerate(roots.tolist()):
        v, it = prog.run(roots=r)
        seq[r] = (v.cpu().numpy(), it, dict(prog.last_run_stats))
        if not torch.equal(bv[i], v) or int(bi[i]) != it:
            raise AssertionError(f"run_batch lane {i} (root {r}) != its "
                                 "sequential pes=2 run")
        for k in set(bstats) & set(seq[r][2]) - {"pes"}:
            if bstats[k][i] != seq[r][2][k]:
                raise AssertionError(f"run_batch lane {i}: {k}")
    nonempty = sum(n > 0 for n in prog.report.push_pe_rows)
    if lane_pushes <= 0 or batch_launches["push_ell_lanes"] \
            != lane_pushes * nonempty:
        raise AssertionError(f"run_batch pes=2: {lane_pushes} lane pushes, "
                             f"launches {batch_launches}")
    log(f"[multi_pe] run_batch over {MULTI_BATCH} roots at pes=2 = "
        f"{MULTI_BATCH} sequential pes=2 runs (values, iters, counters); "
        f"{lane_pushes} batched pushes, 3L launches "
        f"{batch_launches['push_ell_lanes']} ({nonempty} a batched push), "
        f"fold launches {batch_launches['edge_block_fold']}")
    srv = GraphServer(g, schedule=cfg(2), device="cuda", devices=group(2),
                      admission=AdmissionPolicy(slots=8, slice_supersteps=4))
    sroots = list(roots) + list(pick.choice(cand, MULTI_QUERIES - MULTI_BATCH,
                                            replace=False))
    _zero_counts()
    t1 = time.perf_counter()
    handles = [srv.submit("bfs", int(r)) for r in sroots]
    srv.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t1
    serve_launches = _read_counts()
    for q in handles:
        if q.root not in seq:
            v, it = prog.run(roots=q.root)
            seq[q.root] = (v.cpu().numpy(), it, None)
        want, it = seq[q.root][:2]
        if not q.done or not np.array_equal(np.asarray(q.result), want) \
                or q.iters != it:
            raise AssertionError(f"served bfs root {q.root} at pes=2 != its "
                                 "sequential run")
    if serve_launches["push_ell_lanes"] <= 0:
        raise AssertionError(f"the pes=2 server ran no 3L: {serve_launches}")
    log(f"[multi_pe] GraphServer at pes=2: {MULTI_QUERIES} bfs = sequential "
        f"pes=2 runs bitwise, {serve_s:.2f} s; launches {serve_launches}")
    del srv, bv

    # ---- the sparse pull exchange at pes=2, scale 22 ---------------------
    # a sparse plan pins multi-PE runs to pull (its push is single-PE), so
    # the one-PE run it equals is the pull-pinned one
    sp1 = translate(bfs, g, cfg(1, "pull", backend="sparse"), device="cuda")
    v1, i1 = sp1.run(roots=0)
    s1 = dict(sp1.last_run_stats)
    sp2 = translate(bfs, g, cfg(2, backend="sparse"), device="cuda",
                    devices=group(2))
    t1 = time.perf_counter()
    v2, i2 = sp2.run(roots=0)
    torch.cuda.synchronize()
    sparse_s = time.perf_counter() - t1
    s2 = sp2.last_run_stats
    rep = sp2.report
    per = rep.est_collective_bytes + rep.est_frontier_bytes
    ok = (np.array_equal(v2.cpu().numpy().astype(np.int64), oracle)
          and torch.equal(v1, v2) and i1 == i2
          and all(s2[k] == v for k, v in s1.items() if k not in MULTI_KEYS)
          and rep.exchange_plane == "pull"
          and s2["exchange_supersteps"] == s2["pull_supersteps"] == i2
          and rep.est_collective_bytes == V * 4
          and rep.est_frontier_bytes == -(-V // 32) * 4
          and s2["exchange_bytes"] == i2 * per)
    if not ok:
        raise AssertionError(f"sparse bfs pes=2: run_stats {s2} against "
                             f"pes=1 {s1}")
    log(f"[multi_pe] sparse bfs pes=2 (pull exchange): = numpy_bfs = pes=1 "
        f"bitwise, {i2} exchanged supersteps of {per} bytes, run "
        f"{sparse_s * 1e3:.1f} ms")
    del sp1, sp2, v1, v2

    # ---- each kernel as the multi-PE push launches it -------------------
    fused, lanes_row = _multi_pe_kernel_timing(torch, lay, g, oracle, 2, smi)
    del progs, prog
    for lay_ in preprocess._LAYOUT_CACHE.values():
        lay_._on_device.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # ---- scale 20: SSSP, WCC, sparse PageRank ---------------------------
    V2, E2 = 1 << OTHERS_SCALE, 16 << OTHERS_SCALE
    src, dst = G.rmat_edges(V2, E2, seed=1)
    w = np.random.default_rng(2).uniform(1.0, 10.0, len(src)) \
        .astype(np.float32)
    g2 = G.from_edge_list(src, dst, num_vertices=V2, weights=w)
    und = G.from_edge_list(np.concatenate([src, dst]),
                           np.concatenate([dst, src]), num_vertices=V2)
    del src, dst, w
    for name, program, graph, roots in (
            ("sssp", dsl.sssp_program(), g2, 0),
            ("wcc", dsl.wcc_program(), und, None)):
        a = translate(program, graph, cfg(1), device="cuda")
        b = translate(program, graph, cfg(2), device="cuda",
                      devices=group(2))
        va, ia = a.run(roots=roots)
        vb, ib = b.run(roots=roots)
        sa, sb = a.last_run_stats, b.last_run_stats
        if not (_same_bits(va, vb) and ia == ib and all(
                sb[k] == v for k, v in sa.items() if k not in MULTI_KEYS)):
            raise AssertionError(f"{name} pes=2 != pes=1 at scale "
                                 f"{OTHERS_SCALE}")
        log(f"[multi_pe] {name} at scale {OTHERS_SCALE}, pes=2 (exchange "
            f"{b.report.exchange_plane}): = pes=1 bitwise, iters {ib}, "
            f"{sb['exchange_supersteps']} exchanges")
    damping = 0.85
    pr = dsl.pagerank_program(damping, 20)
    r1, _ = translate(pr, g2, cfg(1, backend="sparse"), device="cuda").run()
    p2 = translate(pr, g2, cfg(2, backend="sparse"), device="cuda",
                   devices=group(2))
    r2, _ = p2.run()
    if not (_close(r1, r2) and p2.report.exchange_plane == "pull"):
        raise AssertionError(f"pagerank pes=2 full precision: max |d| "
                             f"{_max_err(r1, r2)} past rtol 1e-5 of pes=1")
    # the int8 exchange: every combine within pes · scale of the exact sum
    # (the JAX package's unit bound, a guarantee), checked on each call
    quantized, combines = C.quantized_psum, []

    def checked(parts, device=None):
        out = quantized(parts, device=device)
        exact = C.psum(parts, device=device)
        scale_ = float(max(float(p.abs().max()) for p in parts)) / 127.0
        err_ = float((out - exact).abs().max())
        combines.append(err_ / (len(parts) * scale_ + 1e-30))
        if err_ > len(parts) * scale_ * (1 + 1e-6) + 1e-6:
            raise AssertionError(f"quantized_psum: |q - exact| {err_} past "
                                 f"pes x scale {len(parts) * scale_}")
        return out

    C.quantized_psum = checked
    try:
        q2 = translate(pr, g2, cfg(2, backend="sparse",
                                   message_dtype="int8"),
                       device="cuda", devices=group(2))
        rq, _ = q2.run()
    finally:
        C.quantized_psum = quantized
    # the end-to-end heuristic d/(1-d) · pes · max|r|/127 of the JAX
    # package's test, reported here: on R-MAT hubs the rounding compounds
    # through their fan-in, so it is no bound at this scale
    scale = float(r1.abs().max()) / 127.0
    heuristic = damping / (1 - damping) * 2 * scale + 1e-6
    qerr = float((rq - r1).abs().max())
    if not (q2.report.exchange_quantized and len(combines) == 20
            and bool(torch.isfinite(rq).all())):
        raise AssertionError(f"pagerank int8: {len(combines)} combines, "
                             f"quantized {q2.report.exchange_quantized}")
    # ... and held on the JAX package's own acceptance graph (R-MAT 400
    # vertices, 4,000 edges, seed 11; 10 iterations, 4 PEs), where its
    # test pins it
    src, dst = G.rmat_edges(400, 4000, seed=11)
    w = np.random.default_rng(11).uniform(0.5, 2, len(src)).astype(np.float32)
    g3 = G.from_edge_list(src, dst, num_vertices=400, weights=w)
    pr10 = dsl.pagerank_program(damping, 10)
    a1, _ = translate(pr10, g3, cfg(1, backend="sparse"), device="cuda").run()
    a4, _ = translate(pr10, g3, cfg(4, backend="sparse",
                                    message_dtype="int8"),
                      device="cuda", devices=group(4)).run()
    small_bound = damping / (1 - damping) * 4 * float(a1.abs().max()) / 127 \
        + 1e-6
    small_err = float((a4 - a1).abs().max())
    if small_err > small_bound:
        raise AssertionError(f"pagerank int8 on the JAX acceptance graph: "
                             f"{small_err} past {small_bound}")
    bound = heuristic
    log(f"[multi_pe] sparse pagerank (20 iterations) at scale "
        f"{OTHERS_SCALE}, pes=2: full precision within rtol 1e-5 of pes=1 "
        f"(max |d| {_max_err(r1, r2):.3e}); int8 exchange: each of "
        f"{len(combines)} combines within pes x scale of its exact sum (at "
        f"most {max(combines):.3f} of it); end to end max |d| {qerr:.3e} "
        f"against the heuristic {heuristic:.3e} "
        f"({'within' if qerr <= heuristic else 'past'} it); on the JAX "
        f"package's acceptance graph at 4 PEs, 10 iterations: max |d| "
        f"{small_err:.3e} <= {small_bound:.3e}")
    del g2, und, g3, r1, r2, rq, p2, q2
    gc.collect()
    torch.cuda.empty_cache()

    phase_s = time.perf_counter() - t_phase
    log(f"[multi_pe] phase wall {phase_s:.1f} s on {smi}")
    summary = {"walls_ms": wall_ms, "collectives_ms": coll_ms,
               "runs": {f"{m} pes={p}": {"iters": r[1], "run_stats": r[2],
                                         "launches": r[3]}
                        for (m, p), r in runs.items()},
               "batch_launches": batch_launches,
               "serve_launches": serve_launches, "serve_s": serve_s,
               "sparse_run_s": sparse_s, "fused": fused,
               "lanes": lanes_row, "pagerank_int8_err": qerr,
               "pagerank_int8_heuristic": bound,
               "pagerank_int8_combines": combines,
               "acceptance_graph_int8": [small_err, small_bound],
               "phase_s": phase_s,
               "card": smi}
    with open(os.path.join(OUT_DIR, "chip_smoke_multi_pe.json"), "w") as f:
        json.dump(summary, f, indent=1, default=str)
    auto2 = runs[("auto", 2)][3]
    return [
        {"name": "push_ell_fused_reduce (multi-PE, a PE's interval)",
         "route": "cuda", "source": "src/repro_torch/csrc/push_ell.cu",
         "replaces": "src/repro/kernels/push_ell.py:89",
         "launches": auto2["push_ell_fused"],
         "max_abs_err": fused["max_abs_err"], "ms": fused["ms"],
         "plain_ms": fused["plain_ms"], "bound_ms": fused["bound_ms"],
         "bound_by": "bytes", "library_ms": fused["library_ms"],
         "shape": fused["shape"]},
        {"name": "push_ell_lanes_reduce (multi-PE, a PE's interval)",
         "route": "cuda", "source": "src/repro_torch/csrc/push_ell.cu",
         "replaces": "src/repro/kernels/push_ell.py:134",
         "launches": batch_launches["push_ell_lanes"],
         "max_abs_err": lanes_row["max_abs_err"], "ms": lanes_row["ms"],
         "plain_ms": lanes_row["plain_ms"], "bound_ms": lanes_row["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "shape": lanes_row["shape"]},
    ]


def numpy_k_core(src, dst, V, k):
    """k-core membership by peeling on the undirected multigraph (each
    edge both ways), independent of the port."""
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    alive = np.ones(V, bool)
    while True:
        cnt = np.bincount(d, weights=alive[s], minlength=V)
        nxt = alive & (cnt >= k)
        if np.array_equal(nxt, alive):
            return alive
        alive = nxt


def phase_others(torch):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components, dijkstra
    from repro_torch.core import algorithms as alg
    from repro_torch.core import dsl
    from repro_torch.core import graph as G
    from repro_torch.core.scheduler import DirectionPolicy, ScheduleConfig
    from repro_torch.core.translator import translate

    scale, device = OTHERS_SCALE, "cuda"
    V, E = 1 << scale, 16 << scale
    src, dst = G.rmat_edges(V, E, seed=1)
    w = np.random.default_rng(2).uniform(1.0, 10.0, len(src)) \
        .astype(np.float32)
    g = G.from_edge_list(src, dst, num_vertices=V, weights=w)
    off = g.edge_offsets.numpy()
    A = sp.csr_matrix((g.edge_weights.numpy().astype(np.float64),
                       g.edges_dst.numpy(), off), shape=(V, V))

    want = dijkstra(A, indices=0)
    for sweep in ("dense", "bitmap"):
        _zero_counts()
        d_pull, _, _ = alg.sssp(g, 0, direction="pull", device=device,
                                pull_sweep=sweep)
        d_push, it, rep = alg.sssp(g, 0, direction="push", device=device,
                                   pull_sweep=sweep)
        if not torch.equal(d_pull, d_push):
            raise AssertionError(f"sssp {sweep}: push != pull")
        got = d_push.cpu().numpy().astype(np.float64)
        if not (np.array_equal(np.isinf(got), np.isinf(want)) and np.allclose(
                got[np.isfinite(want)], want[np.isfinite(want)], rtol=1e-5)):
            raise AssertionError(f"sssp {sweep} disagrees with scipy")
        log(f"[others] sssp scale {scale} ({sweep} pull plane): {it} "
            f"supersteps, push == pull, allclose(rtol=1e-5) to scipy "
            f"dijkstra; launches {_read_counts()}; run_stats "
            f"{json.dumps(rep.run_stats)}")

    n, comp = connected_components(A, directed=True, connection="weak")
    mins = np.full(n, V, np.int64)
    np.minimum.at(mins, comp, np.arange(V))
    # wcc's own undirected graph, built once so its layouts are cached
    und = G.from_edge_list(np.concatenate([src, dst]),
                           np.concatenate([dst, src]), num_vertices=V)
    for sweep in ("dense", "bitmap"):
        labels = {}
        for d in ("pull", "push"):
            prog = translate(dsl.wcc_program(), und, ScheduleConfig(
                direction=DirectionPolicy(mode=d), pull_sweep=sweep),
                device=device)
            labels[d], it = prog.run()
        if not torch.equal(labels["pull"], labels["push"]):
            raise AssertionError(f"wcc {sweep}: push != pull")
        if not np.array_equal(labels["push"].cpu().numpy(), mins[comp]):
            raise AssertionError(f"wcc {sweep} labels disagree with scipy")
        log(f"[others] wcc ({sweep} pull plane): {it} supersteps, {n} "
            "components, push == pull, labels = min id per scipy weak "
            "component")

    ranks, it, _ = alg.pagerank(g, iters=20, device=device)
    deg = np.maximum(np.diff(off), 1).astype(np.float64)
    ones = sp.csr_matrix((np.ones(g.num_edges), g.edges_dst.numpy(), off),
                         shape=(V, V))
    r = np.ones(V)
    for _ in range(20):
        r = 0.15 + 0.85 * (ones.T @ (r / deg))
    if not np.allclose(ranks.cpu().numpy(), r, rtol=1e-4):
        raise AssertionError("pagerank disagrees with scipy power iteration")
    log(f"[others] pagerank: {it} iterations within rtol 1e-4 of scipy")

    t1 = time.perf_counter()
    member, rounds = alg.k_core(g, 4, device=device)
    wall = time.perf_counter() - t1
    want_core = numpy_k_core(src, dst, V, 4)
    if not np.array_equal(member, want_core):
        raise AssertionError("k_core(k=4) disagrees with the numpy peel")
    log(f"[others] k_core(k=4): {int(member.sum())} of {V} vertices in the "
        f"core after {rounds} rounds ({wall:.2f} s), = numpy peel")


def _softcap_library(torch, args, softcap, compile=True):
    """The library call that computes soft-capped kernel 5 on ``args``:
    ``flex_attention`` with a ``score_mod`` that caps each score as
    ``softcap * tanh(s / softcap)`` and gives ``-inf`` outside ``slot <
    length & pos >= 0``, ``enable_gqa`` over the ``K * G`` query heads of
    one query row, compiled once (``torch.compile``, the way the library
    runs it fused; ``compile=False`` runs it eagerly).  Returns a
    callable giving ``(B, K * G, 1, h)``; timed only, the port never
    calls it."""
    from torch.nn.attention.flex_attention import flex_attention
    q, kc, vc, pos, length = args
    B, S, K, h = kc.shape
    length = length.long()

    def score_mod(s, b, head, q_idx, kv_idx):
        s = softcap * torch.tanh(s / softcap)
        ok = (kv_idx < length[b]) & (pos[b, kv_idx] >= 0)
        return torch.where(ok, s, -float("inf"))

    fn = torch.compile(flex_attention, dynamic=False) if compile \
        else flex_attention
    qf = q.reshape(B, K * q.shape[2], 1, h)
    kf, vf = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
    return lambda: fn(qf, kf, vf, score_mod=score_mod, enable_gqa=True)


def _decode_timings(torch, args, label, smi, softcap=0.0, tag="lm"):
    """Kernel 5 on ``args`` (bf16, rows with a valid slot) at ``softcap``:
    held against its plain version in bf16 and on the same inputs cast to
    float32 (``_decode_agrees``), then timed in bf16 beside its byte
    bound, the plain version and the library call (timed, and its error
    against the plain version recorded): uncapped,
    ``scaled_dot_product_attention`` with a boolean mask and
    ``enable_gqa``; capped, ``flex_attention`` (``_softcap_library``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_gqa as dg
    from repro_torch.kernels.ref import decode_gqa_ref
    q, kc, vc, pos, length = args
    B, S, K, h = kc.shape
    G = q.shape[2]
    slots = torch.arange(S, device=q.device)
    valid = (slots[None] < length[:, None].long()) & (pos >= 0)
    got = dg.decode_gqa(*args, softcap=softcap)
    want = decode_gqa_ref(*args, softcap=softcap)
    mask = valid[:, None, None, :]
    if softcap:
        lib_name = "flex_attention (soft-cap score_mod)"
        lib = _softcap_library(torch, args, softcap)
    else:
        lib_name = "scaled_dot_product_attention"
        lib = (lambda: F.scaled_dot_product_attention(
            q.reshape(B, K * G, 1, h), kc.permute(0, 2, 1, 3),
            vc.permute(0, 2, 1, 3), attn_mask=mask, enable_gqa=True))
    torch.cuda.synchronize()
    rows = valid.any(1)
    ok, err, scale = _decode_agrees(got[rows].float(), want[rows].float(),
                                    True)
    lib_err = _max_err(lib().reshape(B, K, G, h)[rows].float(),
                       want[rows].float())
    args32 = tuple(a.float() if a.is_floating_point() else a for a in args)
    got32 = dg.decode_gqa(*args32, softcap=softcap)
    want32 = decode_gqa_ref(*args32, softcap=softcap)
    ok32, err32, scale32 = _decode_agrees(got32[rows], want32[rows], False)
    del args32, got32, want32
    if not (ok and ok32):
        raise AssertionError(f"decode_gqa at the {label} shape: max err "
                             f"{err} in bf16, {err32} in float32 (max |out| "
                             f"{scale}, {scale32})")
    ms = _time_ms(torch, lambda: dg.decode_gqa(*args, softcap=softcap),
                  batch=20)
    dev_ms = _device_ms(torch, lambda: dg.decode_gqa(*args, softcap=softcap),
                        "decode_gqa")
    plain_ms = _time_ms(torch, lambda: decode_gqa_ref(*args, softcap=softcap),
                        batch=20)
    lib_ms = _time_ms(torch, lib, batch=20)
    # every kernel the library call launches
    lib_dev = _device_ms(torch, lib, "")
    # each valid slot's k and v rows, its position, q and the output once
    n_valid = int(valid.sum())
    ends = torch.clamp(length.long(), 0, S)
    nbytes = (n_valid * K * h * 2 * kc.element_size()
              + int(ends.sum()) * 4 + 2 * q.numel() * q.element_size())
    # a soft-capped score adds a division, a tanh and a product (counted
    # as three operations) a score
    nops = (4 * h + (3 if softcap else 0)) * n_valid * K * G
    bound = 1e3 * max(nbytes / _BANDWIDTH, nops / _SCALAR_OPS)
    lib_text = (f"{lib_ms:.4f} ms (device time "
                f"{'not measured' if lib_dev is None else f'{lib_dev:.4f} ms'})")
    log(f"[{tag}] decode_gqa at the {label} shape (B={B} S={S} K={K} G={G} "
        f"h={h}, softcap {softcap}, {n_valid} valid slots, "
        f"{nbytes / 1e6:.1f} MB): {ms:.4f} ms a call in batches of 20 "
        f"(device time "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}), "
        f"bound {bound:.4f} ms ({bound / ms:.3f} of it), plain "
        f"{plain_ms:.4f} ms, {lib_name} {lib_text}; "
        f"bf16 max abs err {err} (library {lib_err}), max |out| {scale}; "
        f"float32 max abs err {err32}, max |out| {scale32} on {smi}")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "library_ms": lib_ms, "library_device_ms": lib_dev,
            "max_abs_err": err, "library": lib_name,
            "library_err": lib_err,
            "max_abs_out": scale, "f32_max_abs_err": err32,
            "f32_max_abs_out": scale32,
            "bytes": nbytes, "bound_by": "bytes" if nbytes / _BANDWIDTH
            >= nops / _SCALAR_OPS else "operations",
            "shape": [B, S, K, G, h], "valid_slots": n_valid,
            "softcap": softcap}


def _profile_decode_step(torch, sched, wall_s, label):
    """Device time by kernel over one steady decode step of ``sched``
    (torch.profiler): kernel 5's share and the device's idle share."""
    def step():
        nxt, _, sched.cache = sched.serve_step(sched.last, sched.cache)
        nxt.tolist()
    return _profile_step(torch, step, wall_s, label)


def _profile_step(torch, step, wall_s, label):
    """Device time by kernel over one call of ``step`` (a decode step
    ending in its host read; torch.profiler): kernel 5's share and the
    device's idle share against a ``wall_s`` step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k5_ms = sum(e.self_device_time_total for e in kernels
                if "decode_gqa" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)
    top = [(e.key[:60], round(e.self_device_time_total / 1e3, 4), e.count)
           for e in top[:8]]
    with open(os.path.join(OUT_DIR, f"profile_{label}.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=40))
    idle = 1.0 - busy_ms / (1e3 * wall_s)
    log(f"[profile] {label}: kernel time {busy_ms:.3f} ms of a "
        f"{wall_s * 1e3:.3f} ms median step (device idle share {idle:.3f}); "
        f"decode_gqa {k5_ms:.3f} ms, share {k5_ms / busy_ms:.3f} of kernel "
        f"time; top kernels (ms, calls): {top}")
    return {"kernel_ms": busy_ms, "decode_gqa_ms": k5_ms,
            "decode_gqa_share": k5_ms / busy_ms, "idle_share": idle,
            "top": top}


def _decode_equiv(torch, cfg):
    """Decode ≡ full forward in float32 at full width: each decode step's
    logits against ``logits_seq`` at that position (the plain attention
    path, which never reaches kernel 5)."""
    from repro_torch.models.model import LModel
    n, pre, steps = LM_EQUIV
    model = LModel(cfg, device="cuda", dtype=torch.float32,
                   generator=torch.Generator(device="cuda").manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (n, pre + steps)), device="cuda")
    _zero_counts()
    full = model.logits_seq(toks)
    cache = model.init_cache(n, pre + steps, dtype=torch.float32)
    lg, cache = model.prefill(toks[:, :pre], cache)
    seq_launches = _read_counts()["decode_gqa"]
    errs = [float((lg - full[:, pre - 1]).abs().max())]
    for t in range(pre, pre + steps):
        lg, cache = model.decode_step(toks[:, t:t + 1], cache)
        errs.append(float((lg - full[:, t]).abs().max()))
    launches = _read_counts()["decode_gqa"]
    scale = float(full.abs().max())
    rel = max(errs) / scale
    log(f"[lm] decode ≡ full forward, float32, all {cfg.n_layers} layers at "
        f"full width (no depth cut), {n} prompts of {pre} tokens + {steps} "
        f"decode steps: max |Δ| {max(errs):.3e} (prefill {errs[0]:.3e}), max "
        f"|logit| {scale:.4f}, ratio {rel:.3e} (bound 1e-3); decode_gqa "
        f"launches {launches} (logits_seq and prefill: {seq_launches})")
    if not rel <= 1e-3 or seq_launches != 0 \
            or launches != cfg.n_layers * steps:
        raise AssertionError("decode ≡ full forward failed")
    del full, cache
    # a prompt past prefill_chunk (two chunks), no wrap; a global ring
    # that wraps mid-decode
    long_paths = _served_long_paths(torch, model, (
        ("chunked_prefill", LM_CHUNKED, False),
        ("ring_wrap", LM_RING, True)))
    return {"max_abs": max(errs), "max_logit": scale, "ratio": rel,
            "errs": errs, "launches": launches, **long_paths}


def _windowed_attention(torch, ring):
    """The full forward's attention under a ring of ``ring`` slots: a
    query at position p sees positions p - ring < p' <= p (and a local
    layer's own window, if narrower), the causal mask of
    ``layers._attn_core`` with the window term a windowed layer adds (a
    decode step after the ring wraps attends to the last ``ring``
    positions, each of whose k/v was computed under the same window)."""
    from repro_torch.models import layers as L
    real = L._attn_core

    def core(cfg, q, k, v, q_pos, k_pos, *, causal=True, window=0):
        return real(cfg, q, k, v, q_pos, k_pos, causal=causal,
                    window=min(window or ring, ring) if causal else window)
    return core


def _served_long_paths(torch, model, cases):
    """The serving functions' long paths, in float32 at full width,
    through ``serve.decode.make_serve_fns`` (the server's prefill and
    decode step): each case ``(label, (prompt, capacity, steps),
    ring_window)`` prefills one prompt (in chunks of at most
    ``prefill_chunk``) into a cache of ``capacity`` and takes ``steps``
    decode steps, against ``logits_seq``; with ``ring_window`` the full
    forward runs under the global ring's window (``_windowed_attention``),
    as it must once a global ring wraps.  A local layer's ring of
    ``min(window, capacity)`` slots needs no such change: the full
    forward masks its window itself.  Each within 1e-3 of max |logit|,
    the decode ≡ full forward bound."""
    from repro_torch.models import layers as L
    from repro_torch.models.model import prefill_chunks
    from repro_torch.serve.decode import make_serve_fns
    cfg = model.cfg
    prefill_step, serve_step = make_serve_fns(model)
    rng = np.random.default_rng(2)
    out = {}
    for label, (prompt, capacity, steps), ring_window in cases:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            (1, prompt + steps)),
                               device="cuda")
        kinds = [(kind, min(cfg.window, capacity) if kind == "local"
                  and cfg.window else capacity)
                 for kind in cfg.attn_pattern if kind in ("global", "local")]
        chunks = [n for _, n in prefill_chunks(
            cfg, prompt, min(cfg.prefill_chunk, prompt), rings=kinds)]
        rings = sorted({n for _, n in kinds})
        wraps = [r for r in rings if prompt + steps > r]
        if ("chunked" in label and len(chunks) < 2) \
                or ("wrap" in label and not wraps):
            raise AssertionError(f"{label}: {prompt} tokens in chunks "
                                 f"{chunks}, rings {rings}")
        real = L._attn_core
        if ring_window:
            L._attn_core = _windowed_attention(torch, capacity)
        try:
            full = model.logits_seq(toks)
        finally:
            L._attn_core = real
        cache = model.init_cache(1, capacity, dtype=torch.float32)
        lg, cache = prefill_step(toks[:, :prompt], cache)
        errs = [float((lg - full[:, prompt - 1]).abs().max())]
        for t in range(prompt, prompt + steps):
            _, lg, cache = serve_step(toks[:, t:t + 1].to(torch.int32),
                                      cache)
            errs.append(float((lg - full[:, t]).abs().max()))
        scale = float(full.abs().max())
        rel = max(errs) / scale
        del full, cache
        torch.cuda.empty_cache()
        log(f"[lm] {cfg.name} {label}: a prompt of {prompt} tokens "
            f"(prefill chunks {chunks}) and {steps} "
            f"decode steps in a cache of {capacity} (rings {rings}; "
            f"wrapping {wraps}), float32, all {cfg.n_layers} layers, "
            f"through the server's prefill and decode step, against the "
            f"full forward{' under the ring window' if ring_window else ''}"
            f": max |Δ| {max(errs):.3e} (prefill {errs[0]:.3e}), max "
            f"|logit| {scale:.4f}, ratio {rel:.3e} (bound 1e-3)")
        if not rel <= 1e-3:
            raise AssertionError(f"{label}: served logits != full forward")
        out[label] = {"prompt": prompt, "capacity": capacity,
                      "steps": steps, "chunks": chunks, "rings": rings,
                      "wrapping": wraps, "max_abs": max(errs),
                      "max_logit": scale, "ratio": rel}
    return out


def _serve_argv(conf):
    """``launch.serve.main``'s flags from a dict (``True``: a bare flag)."""
    return [a for k, v in conf.items() for a in (
        [f"--{k.replace('_', '-')}"] + ([] if v is True else [str(v)]))]


def phase_lm(torch, dev_info):
    import gc
    from repro_torch.configs import get_config
    from repro_torch.core import preprocess
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import param as P
    from repro_torch.models import transformer as T

    smi = dev_info["smi"]
    preprocess.layout_cache_clear()          # the graphs' device layouts
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    cfg = get_config(LM_SERVE["arch"])
    L = cfg.n_layers
    n_req, max_new = LM_SERVE["requests"], LM_SERVE["max_new"]
    slots, cap = LM_SERVE["slots"], LM_SERVE["capacity"]
    argv = _serve_argv(LM_SERVE)

    # keep a copy of one layer's kernel 5 inputs at a mid-run decode step
    # (the cache is written in place later); the kernel's count is kept
    # by its wrapper, which this passes through
    real = ops.decode_gqa
    calls, kept = [0], []
    target = LM_KEEP[0] * L + LM_KEEP[1]

    def keep(*args, **kw):
        if calls[0] == target:
            kept.extend(a.clone() for a in args)
        calls[0] += 1
        return real(*args, **kw)

    ops.decode_gqa = keep
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    try:
        t0 = time.perf_counter()
        sched = serve.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counts()
    finally:
        ops.decode_gqa = real
    serve_peak = torch.cuda.max_memory_allocated()
    steps = sched.decode_steps
    done = sched.done
    if len(done) != n_req or any(len(r.out) != max_new for r in done) \
            or any(not 0 <= t < cfg.vocab_size for r in done for t in r.out):
        raise AssertionError(f"the server did not answer all {n_req} "
                             "requests")
    syncs = sched.step_syncs
    if len(syncs) != steps or set(syncs) != {1}:
        raise AssertionError(f"host syncs of the {steps} decode steps, "
                             f"counted by CUDA's sync debug mode: {syncs}")
    if launches["decode_gqa"] != L * steps:
        raise AssertionError(f"decode_gqa launched {launches['decode_gqa']} "
                             f"times in {steps} decode steps of {L} layers")
    step_ms = [1e3 * x for x in sched.step_walls_s]
    med = float(np.median(step_ms))
    new_tokens = sum(len(r.out) - 1 for r in done)
    tok_s = new_tokens / sum(sched.step_walls_s)
    weight_bytes = P.nbytes(T.model_specs(cfg))
    kv_token = (P.nbytes(T.cache_specs(cfg, 1, 1)) - 4 - 4 * L)

    def step_bound(length):
        kv = int(torch.clamp(length.long(), max=cap).sum()) * kv_token
        return 1e3 * (weight_bytes + kv) / _BANDWIDTH

    bound_end = step_bound(sched.cache["length"])
    bound_mid = step_bound(kept[4])
    prefill = sched.prefill_walls_s
    prompts = [len(r.prompt) for r in sorted(done, key=lambda r: r.rid)]
    log(f"[lm] served {len(done)} requests at full width (qwen3-8b, "
        f"{P.count(T.model_specs(cfg)) / 1e9:.3f} B parameters, "
        f"{weight_bytes / 1e9:.2f} GB bf16; cache "
        f"{slots * cap * kv_token / 1e9:.2f} GB) in {wall:.2f} s with the "
        f"model's build; prompts {prompts}")
    log(f"[lm] prefill {float(np.mean(prefill)):.4f} s per request (median "
        f"{float(np.median(prefill)):.4f}, first {prefill[0]:.4f}, "
        f"{sum(prompts) / sum(prefill):.0f} prompt tokens/s); decode {steps} "
        f"steps, median {med:.3f} ms (min {min(step_ms):.3f}, max "
        f"{max(step_ms):.3f}), {tok_s:.1f} tokens/s; step bound (weights + "
        f"valid KV at 3.35 TB/s) {bound_mid:.3f} ms at decode step "
        f"{LM_KEEP[0]}, {bound_end:.3f} ms at the end ({bound_mid / med:.3f} "
        f"of the median step); host syncs a step (CUDA sync debug mode) "
        f"{min(syncs)}–{max(syncs)} over {len(syncs)} steps; decode_gqa launches {launches['decode_gqa']} = {L} × "
        f"{steps}; all launches {launches} on {smi}")
    # what the server held, for the planner (phase_plan): the parameters,
    # the caches and the decode step's tokens
    held = {"params": _tensor_bytes(sched.model.param_leaves()),
            "cache": _tensor_bytes(P.leaves(sched.cache)),
            "tokens_t": _tensor_bytes([sched.last]), "peak": serve_peak,
            "step_ms": med, "bound_ms": bound_mid}
    # one warm step, then one profiled, on the finished slots' caches
    nxt, _, sched.cache = sched.serve_step(sched.last, sched.cache)
    sched.last = nxt
    nxt.tolist()
    profile = _profile_decode_step(torch, sched, med / 1e3, "lm_decode_step")
    del sched, done
    gc.collect()
    torch.cuda.empty_cache()

    server = _decode_timings(torch, kept, f"served (step {LM_KEEP[0]}, "
                             f"layer {LM_KEEP[1]})", smi)
    del kept
    B, S, K, G, h = LONG_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(7)
    long_args = (torch.randn((B, K, G, h), generator=gen, device="cuda"),
                 torch.randn((B, S, K, h), generator=gen, device="cuda"),
                 torch.randn((B, S, K, h), generator=gen, device="cuda"),
                 torch.arange(S, device="cuda", dtype=torch.int32)[None]
                 .repeat(B, 1),
                 torch.full((B,), S, dtype=torch.int32, device="cuda"))
    long_args = tuple(a.to(torch.bfloat16) if a.is_floating_point() else a
                      for a in long_args)
    long = _decode_timings(torch, long_args, "long", smi)
    del long_args
    equiv = _decode_equiv(torch, cfg)
    summary = {"steps": steps, "step_ms": step_ms, "median_step_ms": med,
               "tokens_per_s": tok_s, "prefill_s": prefill,
               "prompts": prompts, "step_bound_ms": [bound_mid, bound_end],
               "step_syncs": syncs,
               "launches": launches, "profile": profile, "server": server,
               "long": long, "equiv": equiv, "card": smi}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_lm.json"), "w") as f:
        json.dump(summary, f, indent=1, default=str)
    log(json.dumps({"kernel": "decode_gqa", "ms": server["ms"],
                    "plain_ms": server["plain_ms"],
                    "bound_ms": server["bound_ms"],
                    "library_ms": server["library_ms"],
                    "launches_per_decode_step": L, "shape": server["shape"],
                    "device_ms": server["device_ms"],
                    "library_device_ms": server["library_device_ms"],
                    "long": {k: long[k] for k in ("ms", "device_ms",
                                                  "plain_ms",
                                                  "bound_ms", "library_ms",
                                                  "library_device_ms",
                                                  "shape")}}))
    return {"name": "decode_gqa", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_gqa.cu",
            "replaces": "src/repro/kernels/decode_gqa.py:32",
            "launches": launches["decode_gqa"],
            "max_abs_err": server["max_abs_err"], "ms": server["ms"],
            "plain_ms": server["plain_ms"], "bound_ms": server["bound_ms"],
            "bound_by": server["bound_by"],
            "library_ms": server["library_ms"], "shape": server["shape"]}, held


def _tensor_bytes(items):
    """Bytes of the tensors in ``items`` (tensors or ``(path, tensor)``
    pairs)."""
    return sum(t.numel() * t.element_size() for t in (
        x[1] if isinstance(x, tuple) else x for x in items))


def _attn_layers(cfg):
    from repro_torch.models import transformer as T
    return sum(kind in ("global", "local") for kind, _, _ in
               T.layer_slots(cfg))


def _step_bytes(torch, cfg, cache, routed=None):
    """What one decode step must move at the cache's lengths: every
    weight once (with ``routed``, the count of (layer, expert) pairs the
    step's tokens routed to, only those experts), each attention layer's
    valid KV slots (k, v and pos; a local ring holds at most its
    capacity) and each mixer's state, read and written once."""
    from repro_torch.models import param as P
    from repro_torch.models import transformer as T
    specs = T.model_specs(cfg)
    weights = P.nbytes(specs)
    if routed is not None:
        expert = 3 * cfg.d_model * cfg.d_ff * 2          # bf16 up/gate/down
        weights -= cfg.n_layers * cfg.n_experts * expert
        weights += routed * expert
    lengths = cache["length"].long()
    kv_token = 2 * cfg.n_kv_heads * cfg.head_dim * 2 + 4
    total = 0
    for kind, key, g in T.layer_slots(cfg):
        c = cache["blocks"][key] if g is not None else cache["rem"][key]
        if "attn" in c:
            cap = c["attn"]["pos"].shape[-1]
            total += int(torch.clamp(lengths, max=cap).sum()) * kv_token
        else:
            per = sum(t[0].numel() * t.element_size() if g is not None
                      else t.numel() * t.element_size() for t in c["mixer"])
            total += 2 * per
    return weights + total


def _serve_family(torch, arch, smi):
    """One full-width model through ``launch.serve.main``: its metrics,
    host syncs and kernel 5 launches a step, peak memory, and one profiled
    steady step; the model is freed before returning."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import moe as M
    from repro_torch.models import param as P
    from repro_torch.models import transformer as T
    cfg = get_config(arch)
    conf = dict(LM_FAMILY_SERVE, arch=arch)
    argv = _serve_argv(conf)
    n_attn = _attn_layers(cfg)
    weight_bytes = P.nbytes(T.model_specs(cfg))
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    sched = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps, done = sched.decode_steps, sched.done
    n_req, max_new = conf["requests"], conf["max_new"]
    if len(done) != n_req or any(len(r.out) != max_new for r in done) \
            or any(not 0 <= t < cfg.vocab_size for r in done for t in r.out):
        raise AssertionError(f"{arch}: the server did not answer all "
                             f"{n_req} requests")
    syncs = sched.step_syncs
    if len(syncs) != steps or set(syncs) != {1}:
        raise AssertionError(f"{arch}: host syncs of the {steps} decode "
                             f"steps: {syncs}")
    if launches["decode_gqa"] != n_attn * steps:
        raise AssertionError(f"{arch}: decode_gqa launched "
                             f"{launches['decode_gqa']} times in {steps} "
                             f"steps of {n_attn} attention layers")
    step_ms = [1e3 * x for x in sched.step_walls_s]
    med = float(np.median(step_ms))
    tok_s = sum(len(r.out) - 1 for r in done) / sum(sched.step_walls_s)
    prefill = sched.prefill_walls_s
    prompts = [len(r.prompt) for r in sorted(done, key=lambda r: r.rid)]
    bound = 1e3 * _step_bytes(torch, cfg, sched.cache) / _BANDWIDTH
    routed_text, routed_bound = "", None
    if cfg.n_experts:
        # one untimed step with the routing recorded: the experts the
        # step's tokens reach, a layer
        real, picked = M._routing_maps, []

        def spy(idx, E, C):
            picked.append(int(torch.unique(idx).numel()))
            return real(idx, E, C)

        M._routing_maps = spy
        try:
            nxt, _, sched.cache = sched.serve_step(sched.last, sched.cache)
            nxt.tolist()
        finally:
            M._routing_maps = real
        routed_bound = 1e3 * _step_bytes(torch, cfg, sched.cache,
                                         routed=sum(picked)) / _BANDWIDTH
        routed_text = (
            f"; routed-expert bound {routed_bound:.3f} ms ({sum(picked)} of "
            f"{cfg.n_layers * cfg.n_experts} (layer, expert) pairs reached "
            f"by the step's {conf['slots']} tokens, top-{cfg.moe_topk}), "
            f"against the served step, which is the reference's shape: "
            f"every expert at capacity {M._capacity(cfg, 1)} a token "
            f"({bound / med:.3f} of its every-expert bound, "
            f"{routed_bound / med:.3f} of the routed one)")
    log(f"[lm_families] {arch}: served {len(done)} requests at full width "
        f"and depth ({cfg.n_layers} layers, {P.count(T.model_specs(cfg)) / 1e9:.3f} B "
        f"parameters, {weight_bytes / 1e9:.2f} GB bf16; {conf['slots']} "
        f"slots × {conf['capacity']}) in {wall:.2f} s with the model's "
        f"build; prompts {prompts}; prefill {float(np.mean(prefill)):.4f} "
        f"s a request (median {float(np.median(prefill)):.4f}, "
        f"{sum(prompts) / sum(prefill):.0f} prompt tokens/s); decode "
        f"{steps} steps, median {med:.3f} ms (min {min(step_ms):.3f}, max "
        f"{max(step_ms):.3f}), {tok_s:.1f} tokens/s; step bound (weights + "
        f"valid KV and state at 3.35 TB/s, at the end) {bound:.3f} ms "
        f"({bound / med:.3f} of the median step){routed_text}; host syncs "
        f"a step {min(syncs)}–{max(syncs)}; decode_gqa launches "
        f"{launches['decode_gqa']} = {n_attn} attention layers × {steps}; "
        f"peak device memory {peak / 1e9:.2f} GB beside {weight_bytes / 1e9:.2f} "
        f"GB of weights on {smi}")
    nxt, _, sched.cache = sched.serve_step(sched.last, sched.cache)
    sched.last = nxt
    nxt.tolist()
    profile = _profile_decode_step(torch, sched, med / 1e3,
                                   f"lm_{arch}_decode_step")
    del sched, done, nxt
    gc.collect()
    torch.cuda.empty_cache()
    return {"steps": steps, "median_step_ms": med, "step_ms": step_ms,
            "tokens_per_s": tok_s, "prefill_s": prefill, "prompts": prompts,
            "step_bound_ms": bound, "routed_bound_ms": routed_bound,
            "step_syncs": syncs, "launches": launches,
            "attention_layers": n_attn, "peak_bytes": peak,
            "weight_bytes": weight_bytes, "wall_s": wall,
            "profile": profile}


def _family_equiv(torch, arch, cfg):
    """Decode ≡ full forward in float32 at full width: each decode step's
    logits against ``logits_seq`` (which never reaches kernel 5), max
    |Δ| / max |logit| <= 1e-3, with kernel 5 launched once an attention
    layer and step (its soft-capped instantiation where the config caps);
    then, for gemma3, the served long paths."""
    import gc
    from repro_torch.models.model import LModel
    n, pre, steps = LM_FAMILY_EQUIV
    model = LModel(cfg, device="cuda", dtype=torch.float32,
                   generator=torch.Generator(device="cuda").manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (n, pre + steps)), device="cuda")
    _zero_counts()
    full = model.logits_seq(toks)
    cache = model.init_cache(n, pre + steps, dtype=torch.float32)
    lg, cache = model.prefill(toks[:, :pre], cache)
    seq_launches = _read_counts()["decode_gqa"]
    errs = [float((lg - full[:, pre - 1]).abs().max())]
    for t in range(pre, pre + steps):
        lg, cache = model.decode_step(toks[:, t:t + 1], cache)
        errs.append(float((lg - full[:, t]).abs().max()))
    counts = _read_counts()
    scale = float(full.abs().max())
    rel = max(errs) / scale
    n_attn = _attn_layers(cfg)
    capped = counts["decode_gqa_softcap"]
    moe = ""
    if cfg.n_experts:
        least = cfg.n_experts / cfg.moe_topk
        moe = (f", capacity factor {cfg.capacity_factor:.4f} on both sides "
               f"(E / k = {cfg.n_experts} / {cfg.moe_topk} = {least:.4f})")
        if not cfg.capacity_factor >= least:
            raise AssertionError(f"{arch}: capacity factor "
                                 f"{cfg.capacity_factor} < E / k = {least}: "
                                 f"the full forward would drop tokens")
    log(f"[lm_families] {cfg.name}: decode ≡ full forward, float32, "
        f"{cfg.n_layers} of {arch}'s layers at d_model {cfg.d_model}{moe}, "
        f"{n} prompts of {pre} tokens + {steps} decode steps: max |Δ| "
        f"{max(errs):.3e} (prefill {errs[0]:.3e}), max |logit| {scale:.4f}, "
        f"ratio {rel:.3e} (bound 1e-3); decode_gqa launches "
        f"{counts['decode_gqa']} (soft-capped {capped}; logits_seq and "
        f"prefill {seq_launches})")
    want_capped = n_attn * steps if cfg.attn_softcap else 0
    if not rel <= 1e-3 or seq_launches != 0 \
            or counts["decode_gqa"] != n_attn * steps \
            or capped != want_capped:
        raise AssertionError(f"{arch}: decode ≡ full forward failed")
    del full, cache
    out = {"layers": cfg.n_layers, "max_abs": max(errs), "max_logit": scale,
           "ratio": rel, "launches": counts["decode_gqa"],
           "softcap_launches": capped}
    if arch == "gemma3-4b":
        out.update(_served_long_paths(torch, model, LM_GEMMA_PATHS))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _scan_timing(torch, smi):
    """``ssm.linear_recurrence`` at falcon-mamba's longest served prompt
    (one layer's decay and drive, float32): CUDA-event ms beside its
    bound (a and b read once, h written once)."""
    from repro_torch.models import ssm as S
    gen = torch.Generator(device="cuda").manual_seed(8)
    a = torch.rand(SCAN_SHAPE, generator=gen, device="cuda")
    b = torch.randn(SCAN_SHAPE, generator=gen, device="cuda")
    ms = _time_ms(torch, lambda: S.linear_recurrence(a, b), reps=10)
    steps = int(np.ceil(np.log2(SCAN_SHAPE[1])))
    bound = 1e3 * 3 * a.numel() * 4 / _BANDWIDTH
    log(f"[lm_families] the SSM prefill scan (linear_recurrence, float32 "
        f"{SCAN_SHAPE}, {a.numel() * 4 / 1e9:.3f} GB a tensor): {ms:.3f} ms "
        f"in {steps} doubling steps, bound {bound:.3f} ms ({bound / ms:.3f} "
        f"of it) on {smi}")
    del a, b
    torch.cuda.empty_cache()
    return {"ms": ms, "bound_ms": bound, "steps": steps,
            "shape": list(SCAN_SHAPE)}


def phase_lm_families(torch, dev_info):
    """The decoder-only families: see the module docstring (step 12)."""
    import dataclasses
    from repro_torch.configs import get_config, smoke_config
    smi = dev_info["smi"]
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    served, equiv = {}, {}
    for arch in LM_FAMILIES:
        served[arch] = _serve_family(torch, arch, smi)
        cfg = get_config(arch)
        if cfg.n_experts:
            cfg = dataclasses.replace(
                cfg, n_layers=LM_MOE_EQUIV_LAYERS,
                capacity_factor=cfg.n_experts / cfg.moe_topk)
        equiv[arch] = _family_equiv(torch, arch, cfg)
    # grok at smoke size: the soft-cap through kernel 5 on the served path
    grok = dataclasses.replace(smoke_config("grok-1-314b"), dtype="float32")
    equiv["grok-1-314b (smoke)"] = _family_equiv(torch, "grok-1-314b", grok)
    grok_launches = equiv["grok-1-314b (smoke)"]["softcap_launches"]
    B, S, K, G, h = GROK_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(9)
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device="cuda")
    slots = torch.arange(S, device="cuda")
    args = (SOFTCAP_Q_SCALE * torch.randn((B, K, G, h), generator=gen,
                                          device="cuda"),
            torch.randn((B, S, K, h), generator=gen, device="cuda"),
            torch.randn((B, S, K, h), generator=gen, device="cuda"),
            torch.where(slots[None] < lengths[:, None], slots[None], -1)
            .to(torch.int32).contiguous(),
            lengths.to(torch.int32))
    args = tuple(a.to(torch.bfloat16) if a.is_floating_point() else a
                 for a in args)
    capped = _decode_timings(torch, args, "grok attention", smi,
                             softcap=GROK_SOFTCAP)
    plain = _decode_timings(torch, args, "grok attention, uncapped", smi)
    del args
    scan = _scan_timing(torch, smi)
    summary = {"served": served, "equiv": equiv, "grok_kernel": capped,
               "grok_kernel_uncapped": plain, "scan": scan, "card": smi}
    with open(os.path.join(OUT_DIR, "chip_smoke_lm_families.json"), "w") as f:
        json.dump(summary, f, indent=1, default=str)
    return {"name": "decode_gqa_softcap", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_gqa.cu",
            "replaces": "src/repro/kernels/decode_gqa.py:32",
            "launches": grok_launches,
            "max_abs_err": capped["max_abs_err"], "ms": capped["ms"],
            "plain_ms": capped["plain_ms"], "bound_ms": capped["bound_ms"],
            "bound_by": capped["bound_by"],
            "library_ms": capped["library_ms"],
            "shape": capped["shape"]}


# whisper-large-v3 end to end (``phase_whisper``): the conditioned decode
# (cross caches built from 1,500 encoder frames; learned position tables
# of 1,500 rows, which the encoder needs), the decode step whose layer-17
# kernel 5 inputs are kept, decode ≡ full forward's prompts, prefilled
# tokens and decode steps, and the server's flags (the reference's
# unconditioned scheduler)
WHISPER_ARCH = "whisper-large-v3"
WHISPER_RUN = dict(slots=4, capacity=448, frames=1500, min_prompt=4,
                   max_prompt=16, steps=64)
WHISPER_KEEP = (32, 17)
WHISPER_EQUIV = (2, 32, 16)
WHISPER_SERVE = dict(arch=WHISPER_ARCH, slots=4, capacity=448, requests=8,
                     max_new=16, seed=0, device="cuda")
# Training whisper-large-v3 at full width and depth (``phase_train``):
# batch × seq (encoder frames = seq, as ``synth_batch`` makes them),
# sequences a microbatch, steps, peak lr; the depth of the checkpoint
# round trip (decoder and encoder layers); the smoke step's batch × seq
TRAIN = dict(batch=8, seq=448, microbatch_seqs=4, steps=8, lr=1e-3)
TRAIN_CKPT_LAYERS = 2
TRAIN_SMOKE = (4, 32)
_BF16_PEAK = 989e12        # dense bf16 tensor-core rate (data sheet)


def _whisper_step_bytes(cfg, model, cache):
    """What one conditioned decode step must move: every parameter
    outside the encoder once, but for the cross-attention ``wk``/``wv``
    (decode reads the cross caches ``build_cross_caches`` made from them)
    and the learned position table, of which a slot reads its one row;
    each layer's valid self-attention slots (k, v and pos) and its whole
    cross cache."""
    from repro_torch.models.param import leaves
    B = cache["length"].shape[0]
    weights = 0
    for path, t in leaves(model.param_tree()):
        if path[0] == "encoder" or path[-2:] in (("xattn", "wk"),
                                                 ("xattn", "wv")):
            continue
        if path == ("pos_emb",):
            t = t[:B]
        weights += t.numel() * t.element_size()
    slot = 2 * cfg.n_kv_heads * cfg.head_dim * 2 + 4      # bf16 k, v; pos
    cap = cache["blocks"]["pos0"]["attn"]["pos"].shape[-1]
    frames = cache["blocks"]["pos0"]["xattn"]["pos"].shape[-1]
    valid = int(cache["length"].long().clamp(max=cap).sum())
    return weights + cfg.n_layers * (valid + B * frames) * slot


def phase_whisper(torch, dev_info):
    """whisper-large-v3: see the module docstring (step 13)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_gqa as dg
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import LModel
    from repro_torch.models.param import leaves
    from repro_torch.serve.decode import _counting_syncs
    smi = dev_info["smi"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    cfg = get_config(WHISPER_ARCH)
    run = WHISPER_RUN
    B, cap, Se, steps = (run["slots"], run["capacity"], run["frames"],
                         run["steps"])
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LModel(cfg, max_seq=Se, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in model.param_leaves())
    rng = np.random.default_rng(0)
    P = int(rng.integers(run["min_prompt"], run["max_prompt"] + 1))
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, P)),
                           dtype=torch.int32, device=dev)
    enc = torch.randn((B, Se, cfg.d_model), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1)
                      ).to(torch.bfloat16)
    cache = model.init_cache(B, cap, cross_len=Se)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = model.build_cross_caches(cache, enc)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    logits, cache = model.prefill(toks, cache)
    last = torch.argmax(logits, -1).to(torch.int32)[:, None]
    out = [last[:, 0].tolist()]
    prefill_s = time.perf_counter() - t0
    seq_launches = _read_counts()["decode_gqa"]
    # the decode steps, keeping layer WHISPER_KEEP[1]'s self and cross
    # kernel 5 inputs at step WHISPER_KEEP[0] (a step calls kernel 5 twice
    # a layer: self-attention, then cross-attention), and adding the
    # launches the wrapper counts in each call to the half it served (a
    # cross call's caches hold the Se encoder frames)
    real, calls, kept = ops.decode_gqa, [0], {}
    halves = {"self": 0, "cross": 0}
    first = WHISPER_KEEP[0] * 2 * cfg.n_layers + 2 * WHISPER_KEEP[1]

    def keep(*args, **kw):
        part = "cross" if args[1].shape[1] == Se else "self"
        if calls[0] in (first, first + 1):
            kept[part] = tuple(a.clone() for a in args)
        calls[0] += 1
        before = dg.decode_gqa.launches
        out = real(*args, **kw)
        halves[part] += dg.decode_gqa.launches - before
        return out

    syncs, walls, finite = [], [], True
    ops.decode_gqa = keep
    _zero_counts()
    try:
        for _ in range(steps):
            t0 = time.perf_counter()
            with _counting_syncs(dev, syncs):
                logits, cache = model.decode_step(last, cache)
                last = torch.argmax(logits, -1).to(torch.int32)[:, None]
                out.append(last[:, 0].tolist())
            walls.append(time.perf_counter() - t0)
            finite = finite and bool(torch.isfinite(logits).all())
    finally:
        ops.decode_gqa = real
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    if seq_launches != 0 or launches["decode_gqa"] != 2 * cfg.n_layers * steps \
            or set(halves.values()) != {cfg.n_layers * steps} \
            or set(kept) != {"self", "cross"}:
        raise AssertionError(f"whisper: decode_gqa launched "
                             f"{launches['decode_gqa']} times in {steps} "
                             f"steps (self {halves['self']}, cross "
                             f"{halves['cross']}; {seq_launches} in the "
                             f"encoder and prefill)")
    if len(syncs) != steps or set(syncs) != {1}:
        raise AssertionError(f"whisper: host syncs of the decode steps "
                             f"{syncs}")
    if not finite or any(not 0 <= t < cfg.vocab_size
                         for row in out for t in row):
        raise AssertionError("whisper: decode gave non-finite logits or "
                             "tokens out of the vocabulary")
    step_ms = [1e3 * w for w in walls]
    med = float(np.median(step_ms))
    tok_s = B * steps / sum(walls)
    bound = 1e3 * _whisper_step_bytes(cfg, model, cache) / _BANDWIDTH
    enc_params = sum(t.numel() for p, t in leaves(model.param_tree())
                     if p[0] == "encoder")
    log(f"[whisper] {WHISPER_ARCH} at full width and depth ({cfg.n_layers} "
        f"decoder + {cfg.n_enc_layers} encoder layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.4f} B parameters of which "
        f"{(n_params - enc_params) / 1e6:.1f} M outside the encoder, bf16, "
        f"max_seq {Se}) built in {build_s:.2f} s; {B} slots × {cap}, "
        f"{Se} encoder frames a slot, a prompt of {P} tokens a slot")
    log(f"[whisper] encoder + cross caches {enc_s:.4f} s for {B} requests "
        f"({enc_s / B:.4f} s a request); prefill {prefill_s:.4f} s; decode "
        f"{steps} steps, median {med:.3f} ms (min {min(step_ms):.3f}, max "
        f"{max(step_ms):.3f}), {tok_s:.1f} tokens/s; step bound (the "
        f"decoder weights a step reads + valid self KV + the cross caches "
        f"at 3.35 TB/s, at the end) {bound:.3f} ms ({bound / med:.3f} of the "
        f"median step); host syncs a step {min(syncs)}–{max(syncs)}; "
        f"decode_gqa launches {launches['decode_gqa']} = "
        f"{2 * cfg.n_layers} a step × {steps}: self {halves['self']}, "
        f"cross {halves['cross']} (encoder and prefill: {seq_launches}); "
        f"peak device memory {peak / 1e9:.2f} GB "
        f"on {smi}")

    def one_step():
        nonlocal last, cache
        logits, cache = model.decode_step(last, cache)
        last = torch.argmax(logits, -1).to(torch.int32)[:, None]
        last[:, 0].tolist()

    one_step()
    profile = _profile_step(torch, one_step, med / 1e3,
                            "whisper_decode_step")
    del model, cache, logits, enc
    gc.collect()
    torch.cuda.empty_cache()
    k_self = _decode_timings(torch, kept["self"], f"whisper self-attention "
                             f"(step {WHISPER_KEEP[0]}, layer "
                             f"{WHISPER_KEEP[1]})", smi, tag="whisper")
    k_cross = _decode_timings(torch, kept["cross"], f"whisper "
                              f"cross-attention (step {WHISPER_KEEP[0]}, "
                              f"layer {WHISPER_KEEP[1]})", smi,
                              tag="whisper")
    del kept
    equiv = _whisper_equiv(torch, cfg)
    # the reference's scheduler: no cross caches (a decoder that never
    # sees an encoder), learned tables of --capacity rows
    _zero_counts()
    sched = serve.main(_serve_argv(WHISPER_SERVE))
    torch.cuda.synchronize()
    served = _read_counts()["decode_gqa"]
    n_req, max_new = WHISPER_SERVE["requests"], WHISPER_SERVE["max_new"]
    if len(sched.done) != n_req or any(len(r.out) != max_new
                                       for r in sched.done):
        raise AssertionError("whisper: the server did not answer all "
                             f"{n_req} requests")
    if set(sched.step_syncs) != {1} \
            or served != cfg.n_layers * sched.decode_steps:
        raise AssertionError(f"whisper server: syncs {sched.step_syncs}, "
                             f"decode_gqa {served} in "
                             f"{sched.decode_steps} steps")
    srv_med = 1e3 * float(np.median(sched.step_walls_s))
    log(f"[whisper] launch.serve.main --arch {WHISPER_ARCH} (the "
        f"reference's scheduler, no cross caches): served {n_req} requests "
        f"of {max_new} tokens, {sched.decode_steps} decode steps, median "
        f"{srv_med:.3f} ms, one host sync a step, decode_gqa {served} = "
        f"{cfg.n_layers} × {sched.decode_steps}")
    del sched
    gc.collect()
    torch.cuda.empty_cache()
    summary = {"build_s": build_s, "prompt": P, "encoder_cross_s": enc_s,
               "prefill_s": prefill_s, "step_ms": step_ms,
               "median_step_ms": med, "tokens_per_s": tok_s,
               "step_bound_ms": bound, "step_syncs": syncs,
               "launches": launches, "launches_by_half": halves,
               "peak_bytes": peak,
               "profile": profile, "kernel_self": k_self,
               "kernel_cross": k_cross, "equiv": equiv,
               "server_median_step_ms": srv_med, "card": smi}
    with open(os.path.join(OUT_DIR, "chip_smoke_whisper.json"), "w") as f:
        json.dump(summary, f, indent=1, default=str)
    return [{"name": f"decode_gqa_whisper_{part}", "route": "cuda",
             "source": "src/repro_torch/csrc/decode_gqa.cu",
             "replaces": "src/repro/kernels/decode_gqa.py:32",
             "launches": halves[part],
             "max_abs_err": k["max_abs_err"], "ms": k["ms"],
             "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
             "bound_by": k["bound_by"], "library_ms": k["library_ms"],
             "shape": k["shape"]}
            for part, k in (("self", k_self), ("cross", k_cross))]


def _whisper_equiv(torch, cfg):
    """Decode ≡ full forward in float32 at full width and depth: each
    decode step's logits (kernel 5 over the self and cross caches)
    against ``logits_seq`` with the same encoder inputs (which never
    reaches kernel 5), max |Δ| / max |logit| <= 1e-3."""
    import gc
    from repro_torch.models.model import LModel
    n, pre, steps = WHISPER_EQUIV
    Se = WHISPER_RUN["frames"]
    dev = torch.device("cuda")
    model = LModel(cfg, max_seq=Se, device=dev, dtype=torch.float32,
                   generator=torch.Generator(device=dev).manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (n, pre + steps)), device=dev)
    enc = torch.randn((n, Se, cfg.d_model), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(2))
    _zero_counts()
    full = model.logits_seq(toks, enc)
    cache = model.build_cross_caches(
        model.init_cache(n, pre + steps, dtype=torch.float32, cross_len=Se),
        enc)
    lg, cache = model.prefill(toks[:, :pre], cache)
    seq_launches = _read_counts()["decode_gqa"]
    errs = [float((lg - full[:, pre - 1]).abs().max())]
    for t in range(pre, pre + steps):
        lg, cache = model.decode_step(toks[:, t:t + 1], cache)
        errs.append(float((lg - full[:, t]).abs().max()))
    launches = _read_counts()["decode_gqa"]
    scale = float(full.abs().max())
    rel = max(errs) / scale
    log(f"[whisper] decode ≡ full forward, float32, all {cfg.n_layers} + "
        f"{cfg.n_enc_layers} layers at full width, {n} prompts of {pre} "
        f"tokens over {Se} encoder frames + {steps} decode steps: max |Δ| "
        f"{max(errs):.3e} (prefill {errs[0]:.3e}), max |logit| {scale:.4f}, "
        f"ratio {rel:.3e} (bound 1e-3); decode_gqa launches {launches} "
        f"(logits_seq, cross caches and prefill: {seq_launches})")
    if not rel <= 1e-3 or seq_launches != 0 \
            or launches != 2 * cfg.n_layers * steps:
        raise AssertionError("whisper: decode ≡ full forward failed")
    del model, full, cache, enc
    gc.collect()
    torch.cuda.empty_cache()
    return {"max_abs": max(errs), "max_logit": scale, "ratio": rel,
            "errs": errs, "launches": launches}


def _same_tree_bits(torch, a, b):
    """Every leaf of two trees of tensors equal bit for bit (dtype and
    shape too); returns the leaves compared."""
    from repro_torch.models.param import leaves
    la, lb = list(leaves(a)), list(leaves(b))
    if [p for p, _ in la] != [p for p, _ in lb]:
        raise AssertionError("checkpoint: the trees' leaves differ")
    for (path, x), (_, y) in zip(la, lb):
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                x.detach().view(torch.uint8) if x.dim() else x.detach(),
                y.detach().view(torch.uint8) if y.dim() else y.detach()):
            raise AssertionError(f"checkpoint: leaf {path} changed")
    return len(la)


def _train_flops(cfg, n_params, batch, seq):
    """Useful operations of one step: ``6 · parameters · tokens`` (each
    stack's parameters once a token of its own: the decoder's tokens and
    as many encoder frames), plus the attention products (q·k and p·v,
    forward and backward) of every layer: self and cross in the decoder,
    bidirectional in the encoder, causal counted whole."""
    tokens = batch * seq
    attn = 3 * 4 * seq * seq * cfg.n_heads * cfg.head_dim * batch * (
        2 * cfg.n_layers + cfg.n_enc_layers)
    return 6 * n_params * tokens + attn


def phase_train(torch, dev_info):
    """Training whisper-large-v3: see the module docstring (step 14)."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import device_put, synth_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import LModel
    from repro_torch.models.param import leaves
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import make_train_step
    smi = dev_info["smi"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    dev = torch.device("cuda")
    B, S, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    cfg = dataclasses.replace(get_config(WHISPER_ARCH),
                              microbatch_seqs=TRAIN["microbatch_seqs"])
    shape = ShapeConfig("train", S, B, "train")
    ocfg = O.OptConfig(peak_lr=TRAIN["lr"], warmup_steps=1,
                       decay_steps=steps, algorithm=cfg.optimizer,
                       state_dtype=cfg.opt_state_dtype)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LModel(cfg, max_seq=S, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(0))
    params = model.param_tree()
    state = O.init_state(ocfg, params)
    step_fn = make_train_step(model, ocfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    kinds = [(t.dtype, tuple(t.shape)) for t in model.param_leaves()]
    n_params = sum(t.numel() for t in model.param_leaves())
    # one batch of the pipeline, repeated: the loss must fall as the
    # model fits it (fresh random tokens have nothing to learn)
    batch = device_put(synth_batch(cfg, shape, 0, seed=0), dev)
    torch.cuda.synchronize()
    rows, walls = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        rows.append((float(m["loss"]), float(m["grad_norm"]),
                     float(m["lr"])))
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    losses = [r[0] for r in rows]
    if not all(np.isfinite(v) for r in rows for v in r[:2]):
        raise AssertionError(f"train: non-finite loss or grad norm {rows}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    if [(t.dtype, tuple(t.shape)) for t in model.param_leaves()] != kinds \
            or any(t.dtype != torch.float32 for path, t in leaves(state)
                   if path[0] in ("m", "v")) or int(state["step"]) != steps:
        raise AssertionError("train: dtypes, shapes or the step changed")
    step_s = float(np.median(walls[1:]))
    held = {"params": _tensor_bytes(model.param_leaves()),
            "opt_state": _tensor_bytes(leaves(state)),
            "batch": _tensor_bytes(batch.values()), "peak": peak,
            "step_s": step_s}
    flops = _train_flops(cfg, n_params, B, S)
    state_bytes = sum(t.numel() * t.element_size()
                      for _, t in leaves(state))
    log(f"[train] {WHISPER_ARCH} at full width and depth ({cfg.n_layers} + "
        f"{cfg.n_enc_layers} layers, {n_params / 1e9:.4f} B parameters in "
        f"bf16, AdamW states {state_bytes / 1e9:.2f} GB in "
        f"{cfg.opt_state_dtype}, remat {cfg.remat} ({cfg.remat_policy}), "
        f"gradient accumulators in {cfg.grad_accum_dtype}) built in "
        f"{build_s:.2f} s; batch {B} × {S} tokens and {S} encoder frames "
        f"(float32, as synth_batch makes them), {TRAIN['microbatch_seqs']} "
        f"sequences a microbatch ({B // TRAIN['microbatch_seqs']} "
        f"microbatches), {steps} steps on one repeated batch")
    log(f"[train] (loss, grad norm, lr) per step: "
        f"{[tuple(round(v, 6) for v in r) for r in rows]}")
    log(f"[train] {step_s:.4f} s a step (median of steps 2–{steps}; first "
        f"{walls[0]:.4f} s), {B * S / step_s:.0f} tokens/s; peak device "
        f"memory {peak / 1e9:.2f} GB; {flops:.4e} useful operations a step "
        f"(6 · params · tokens {6 * n_params * B * S:.4e} + attention): "
        f"{flops / step_s / 1e12:.1f} TFLOP/s, {flops / step_s / _BF16_PEAK:.4f} "
        f"of the dense bf16 peak (989 TFLOP/s), "
        f"{flops / step_s / _SCALAR_OPS:.4f} of the float32 peak (67 "
        f"TFLOP/s; float32 frame embeddings promote the products to "
        f"float32, as in the JAX package) on {smi}")
    del model, params, state, step_fn, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    # the trainer's entry point at full width: the pipeline's batches
    # through the prefetcher's pinned copies
    t0 = time.perf_counter()
    entry = launch_train.main(["--arch", WHISPER_ARCH, "--steps", "2",
                               "--seq", str(S), "--batch", str(B),
                               "--lr", str(TRAIN["lr"]), "--device", "cuda",
                               "--log-every", "1"])
    entry_s = time.perf_counter() - t0
    if entry["steps"] != 2 or not all(np.isfinite(
            [entry["first_loss"], entry["last_loss"]])):
        raise AssertionError(f"train: launch.train.main gave {entry}")
    log(f"[train] launch.train.main --arch {WHISPER_ARCH} --steps 2 --seq "
        f"{S} --batch {B}: {entry} in {entry_s:.2f} s with the model's "
        f"build")
    gc.collect()
    torch.cuda.empty_cache()
    ckpt_out = _train_checkpoint(torch, cfg, shape, ocfg, dev, smi)
    smoke = _train_smoke_on_cpu(torch, dev, smi)
    summary = {"rows": rows, "walls_s": walls, "step_s": step_s,
               "tokens_per_s": B * S / step_s, "peak_bytes": peak,
               "flops": flops, "params": n_params,
               "bf16_share": flops / step_s / _BF16_PEAK,
               "f32_share": flops / step_s / _SCALAR_OPS,
               "entry": entry, "checkpoint": ckpt_out, "smoke": smoke,
               "card": smi}
    with open(os.path.join(OUT_DIR, "chip_smoke_train.json"), "w") as f:
        json.dump(summary, f, indent=1, default=str)
    return held


def _train_checkpoint(torch, cfg, shape, ocfg, dev, smi):
    """Save then ``restore_latest`` at full width over 2 decoder + 2
    encoder layers (bit for bit, params and AdamW state), and a resumed
    model's next loss against the uninterrupted one's: both run the same
    step on the same batch from the same bits, so they must agree within
    ``rtol=1e-6`` (equal unless the card's products vary from run to
    run)."""
    import dataclasses
    import gc
    import shutil
    from repro_torch.data.pipeline import device_put, synth_batch
    from repro_torch.models.model import LModel
    from repro_torch.models.param import leaves
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import make_train_step
    n = TRAIN_CKPT_LAYERS
    cfg = dataclasses.replace(cfg, n_layers=n, n_enc_layers=n)
    d = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    model = LModel(cfg, max_seq=shape.seq_len, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(0))
    state = O.init_state(ocfg, model.param_tree())
    step_fn = make_train_step(model, ocfg)
    batches = [device_put(synth_batch(cfg, shape, s, seed=0), dev)
               for s in range(3)]
    for s in range(2):
        state, _ = step_fn(state, batches[s])
    tree = {"params": model.param_tree(), "opt": state}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save(d, 2, tree, asynchronous=True).join()
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, "step_2", f))
                 for f in os.listdir(os.path.join(d, "step_2")))
    t0 = time.perf_counter()
    restored, at = ckpt.restore_latest(d, tree, device=dev)
    restore_s = time.perf_counter() - t0
    n_leaves = _same_tree_bits(torch, restored, tree)
    if at != 2:
        raise AssertionError(f"checkpoint: latest step {at}")
    state, m = step_fn(state, batches[2])
    uninterrupted = float(m["loss"])
    del model, state, step_fn, tree, m
    gc.collect()
    resumed_model = LModel(cfg, max_seq=shape.seq_len, device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(1))
    with torch.no_grad():
        for (_, dst), (_, src) in zip(leaves(resumed_model.param_tree()),
                                      leaves(restored["params"])):
            dst.copy_(src)
    _, m = make_train_step(resumed_model, ocfg)(restored["opt"], batches[2])
    resumed = float(m["loss"])
    diff = abs(resumed - uninterrupted)
    log(f"[train] checkpoint at full width over {n} + {n} layers: "
        f"{nbytes / 1e9:.3f} GB, {n_leaves} leaves (params bf16, AdamW "
        f"float32, step) saved (async writer, joined) in {save_s:.2f} s, "
        f"restore_latest in {restore_s:.2f} s, bit for bit; the next "
        f"step's loss resumed {resumed!r} against uninterrupted "
        f"{uninterrupted!r} (|Δ| {diff:.3e}, bound rtol 1e-6) on {smi}")
    shutil.rmtree(d, ignore_errors=True)
    if not diff <= 1e-6 * abs(uninterrupted):
        raise AssertionError("checkpoint: the resumed loss differs")
    del resumed_model, restored, batches, m
    gc.collect()
    torch.cuda.empty_cache()
    return {"bytes": nbytes, "leaves": n_leaves, "save_s": save_s,
            "restore_s": restore_s, "resumed_loss": resumed,
            "uninterrupted_loss": uninterrupted, "abs_diff": diff}


def _train_smoke_on_cpu(torch, dev, smi):
    """One float32 train step of whisper at smoke size on the card and on
    the CPU from the same parameters and batch (TF32 off: both sides in
    float32, summing in other orders, the card's embedding gradient with
    atomics).  The loss and grad norm within ``rtol=1e-5``.  After one
    step AdamW's states hold the gradients, ``m = 0.1 g`` and ``v = 0.05
    g²`` (clipped): each ``m`` leaf within ``1e-4`` of its largest
    magnitude and each ``v`` leaf within ``2e-4`` of its (the bound of
    the CPU parity of every gradient leaf against ``jax.grad``, and of
    its square), plus ``rtol=2e-5``.  The parameters are held twice:

    * every one to AdamW's first step recomputed in float64 from the
      starting parameters, the CPU's lr and the card's own ``m`` and
      ``v``, within ``rtol=2e-5`` plus ``1e-3 · lr`` (the bias
      correction, lr, weight decay, sign and in-place write on the card);
    * to the CPU's within ``rtol=2e-5`` plus ``2e-2 · lr`` wherever the
      move ``u = g / (|g| + eps)`` cannot shift by more than ``1e-2``
      when ``g`` moves within the ``m`` bound (``|g| > tol`` and ``eps ·
      tol <= 1e-2 (|g| - tol + eps)²``).  Near ``g = 0`` a rounding of the
      gradient turns the move by up to ``2 · lr``; those parameters are
      left to the first check and counted."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import device_put, synth_batch
    from repro_torch.models.model import LModel
    from repro_torch.models.param import leaves
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import make_train_step
    cfg = dataclasses.replace(smoke_config(WHISPER_ARCH), dtype="float32")
    B, S = TRAIN_SMOKE
    batch = synth_batch(cfg, ShapeConfig("t", S, B, "train"), 0, seed=0)
    ocfg = O.OptConfig(peak_lr=1e-3, warmup_steps=0, decay_steps=10)
    cpu = LModel(cfg, max_seq=S, device="cpu", dtype=torch.float32,
                 generator=torch.Generator().manual_seed(3))
    card = LModel(cfg, max_seq=S, device=dev, dtype=torch.float32)
    with torch.no_grad():
        for dst, src in zip(card.param_leaves(), cpu.param_leaves()):
            dst.copy_(src)
    start = {path: t.detach().double().clone()
             for path, t in leaves(cpu.param_tree())}
    out = []
    for model in (cpu, card):
        state = O.init_state(ocfg, model.param_tree())
        state, m = make_train_step(model, ocfg)(
            state, device_put(batch, model.device))
        out.append((m, {"params": model.param_tree(), "opt": state}))
    (mc, tc), (mg, tg) = out
    for key in ("loss", "grad_norm"):
        a, b = float(mc[key]), float(mg[key])
        if not abs(a - b) <= 1e-5 * abs(a):
            raise AssertionError(f"smoke step: {key} {b} on the card, {a} "
                                 "on the CPU")
    want = {path: t.detach().double() for path, t in leaves(tc)}
    got = {path: t.detach().double().cpu() for path, t in leaves(tg)}
    worst, m_tol = {}, {}
    for path, a in want.items():
        b = got[path]
        kind = path[0] if path[0] == "params" else path[1]
        worst[kind] = max(worst.get(kind, 0.0), float((b - a).abs().max()))
        if kind == "params":
            continue
        atol = 0.0 if kind == "step" else \
            (1e-4 if kind == "m" else 2e-4) * float(a.abs().max())
        if kind == "m":
            m_tol[path[2:]] = atol + 2e-5 * a.abs()
        if not torch.allclose(b, a, rtol=2e-5, atol=atol):
            raise AssertionError(f"smoke step: leaf {path} differs by "
                                 f"{float((b - a).abs().max())}")
    if int(got[("opt", "step")]) != 1:
        raise AssertionError("smoke step: the step count is not 1")
    lr = float(mc["lr"])
    b1, b2, eps, wd = ocfg.b1, ocfg.b2, ocfg.eps, ocfg.weight_decay
    held = left = 0
    worst_move = 0.0
    for path, p0 in start.items():
        pc, pg = want[("params",) + path], got[("params",) + path]
        mh = got[("opt", "m") + path] / (1 - b1)
        vh = got[("opt", "v") + path] / (1 - b2)
        p1 = p0 - lr * (mh / (vh.sqrt() + eps) + wd * p0)
        if not torch.allclose(pg, p1, rtol=2e-5, atol=1e-3 * lr):
            raise AssertionError(f"smoke step: parameter {path} is not "
                                 f"AdamW's step from the card's states "
                                 f"(max |Δ| {float((pg - p1).abs().max())})")
        g = want[("opt", "m") + path].abs() / (1 - b1)
        tol = m_tol[path] / (1 - b1)
        safe = (g > tol) & (eps * tol <= 1e-2 * (g - tol + eps) ** 2)
        d = (pg - pc).abs()
        if (d > 2e-5 * pc.abs() + 2e-2 * lr)[safe].any():
            raise AssertionError(f"smoke step: parameter {path} moved "
                                 f"apart from the CPU's by "
                                 f"{float(d[safe].max())}")
        worst_move = max(worst_move, float(d[safe].max()) if safe.any()
                         else 0.0)
        held += int(safe.sum())
        left += int((~safe).sum())
    log(f"[train] one float32 step of {WHISPER_ARCH} at smoke size (batch "
        f"{B} × {S}) on the card equals the CPU's: loss "
        f"{float(mg['loss'])!r} / {float(mc['loss'])!r}, grad norm "
        f"{float(mg['grad_norm'])!r} / {float(mc['grad_norm'])!r}; max |Δ| "
        f"by leaf kind {worst} (bounds: m 1e-4 and v 2e-4 of each leaf's "
        f"largest, plus rtol 2e-5); every parameter AdamW's step from the "
        f"card's m and v (rtol 2e-5 + {1e-3 * lr:g}); {held} of "
        f"{held + left} parameters within rtol 2e-5 + {2e-2 * lr:g} of the "
        f"CPU's (max |Δ| {worst_move:.3e}), {left} with a gradient within "
        f"rounding of 0 left to the first check, on {smi}")
    return {"loss_card": float(mg["loss"]), "loss_cpu": float(mc["loss"]),
            "max_abs_diff": worst, "held_to_cpu": held,
            "near_zero_gradient": left, "max_param_diff_held": worst_move}


# The planner against the card (``phase_plan``): the [lm] and [train]
# shapes on a (1, 1) mesh of the card; moonshot-v1-16b-a3b's MoE layer on
# 4 × 256 tokens over a (1, 4) mesh of the card repeated; the reshard
# meshes of the 2 + 2-layer whisper checkpoint
PLAN_DECODE = ("qwen3-8b", ("decode_card", 4096, 8, "decode"))
PLAN_TRAIN = (WHISPER_ARCH, ("train_card", 448, 8, "train"), 4)
PLAN_HAND_BOUND_MS = 4.934      # PERF.md §5: qwen3-8b's decode step bound
PLAN_MOE = ("moonshot-v1-16b-a3b", (4, 256), (1, 4))
PLAN_RESHARD = ((4, 2), (2, 2))


PLAN_WORKERS = 6    # processes the dry run's cells are shared out to


def _plan_worker(cells):
    """A share of the dry run in a fresh process: its records, its log
    lines, and whether anything in it initialized CUDA."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from repro_torch.launch import dryrun
    lines = []
    recs = dryrun.sweep(cells, cost=True, echo=lines.append)
    return recs, lines, torch.cuda.is_initialized()


def _plan_sweep(torch):
    """The production meshes' dry run: the 10 archs × 4 shapes on (16,
    16) with the roofline and on (2, 16, 16) without, the archs shared
    out to ``PLAN_WORKERS`` processes (each its own op memo; the host's
    cores run them side by side); no error, no CUDA context in any
    worker and no CUDA memory allocated here."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import ARCHS
    before = torch.cuda.memory_allocated()
    archs = sorted(ARCHS)
    cells = [(a, s, m) for m in (False, True) for a in archs
             for s in SHAPES]
    workers = max(1, min(PLAN_WORKERS, len(archs), os.cpu_count() or 1))
    shares = [[c for c in cells if archs.index(c[0]) % workers == w]
              for w in range(workers)]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(workers, mp_context=multiprocessing
                             .get_context("spawn")) as pool:
        outs = list(pool.map(_plan_worker, shares))
    sweep_s = time.perf_counter() - t0
    by_cell = {}
    for share, (recs, lines, cuda) in zip(shares, outs):
        for line in lines:
            log(f"[plan] {line}")
        if cuda:
            raise AssertionError("plan: a dry-run worker initialized CUDA")
        by_cell.update(zip(share, recs))
    recs = [by_cell[c] for c in cells]
    after = torch.cuda.memory_allocated()
    n = {k: sum(r["status"] == k for r in recs)
         for k in ("ok", "skip", "error")}
    log(f"[plan] sweep: {n['ok']} ok, {n['skip']} skip, {n['error']} "
        f"error in {sweep_s:.1f} s ({workers} processes); CUDA memory "
        f"allocated {before} bytes before, {after} after; no worker "
        "initialized CUDA")
    with open(os.path.join(OUT_DIR, "chip_smoke_plan_sweep.json"), "w") as f:
        json.dump(recs, f, indent=1, default=str)
    if n["error"]:
        bad = [r for r in recs if r["status"] == "error"]
        raise AssertionError(f"plan: {len(bad)} cells failed, first "
                             f"{bad[0]['arch']} × {bad[0]['shape']}: "
                             f"{bad[0]['error']}\n{bad[0]['traceback']}")
    if after != before:
        raise AssertionError("plan: the dry run allocated CUDA memory")
    return {"counts": n, "seconds": sweep_s, "workers": workers}


def _plan_card_cell(torch, arch, shape, held, measured_s, hand_ms, smi,
                    cfg=None):
    """One card cell planned on a (1, 1) mesh of the card: argument bytes
    equal to what the phase held, byte for byte, part by part; live
    bytes beside the measured peak; the roofline beside the measured
    step (and the hand bound)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), ("data", "model"), [torch.device("cuda", 0)])
    rec = dryrun.run_cell(arch, ShapeConfig(*shape), mesh=mesh, cost=True,
                          cfg_override=cfg)
    if rec["status"] != "ok":
        raise AssertionError(f"plan: {arch} {shape}: {rec.get('error')}\n"
                             f"{rec.get('traceback')}")
    parts = dict(rec["memory"]["argument_parts"])
    if "cache" in held:                     # decode: params, tokens, cache
        card = {"params": held["params"], "tokens_t": held["tokens_t"],
                "cache": held["cache"]}
    else:
        card = {"params": held["params"], "opt_state": held["opt_state"],
                "batch": held["batch"]}
    if parts != card:
        raise AssertionError(f"plan: {arch} argument bytes {parts} planned, "
                             f"{card} held on the card")
    live = rec["live_bytes_per_device"]
    roof = rec["roofline"]
    step_ms = 1e3 * measured_s
    log(f"[plan] {arch} {shape[0]} ({shape[2]} × {shape[1]}) on a (1, 1) "
        f"mesh of the card: argument bytes {sum(parts.values())} = held "
        f"on the card byte for byte {card}; live {live / 1e9:.3f} GB "
        f"planned (temp {rec['memory']['temp_bytes'] / 1e9:.3f} GB) "
        f"against a measured peak of {held['peak'] / 1e9:.3f} GB (ratio "
        f"{live / held['peak']:.3f}); roofline compute "
        f"{1e3 * roof['compute_s']:.3f} ms, memory (unfused bytes) "
        f"{1e3 * roof['memory_s']:.3f} ms, collective "
        f"{1e3 * roof['collective_s']:.3f} ms, dominant {roof['dominant']}, "
        f"against the measured step {step_ms:.3f} ms"
        + (f" and the hand bound {hand_ms:.3f} ms" if hand_ms else "")
        + f"; planned in {rec['plan_s']} s on {smi}")
    return {"arch": arch, "shape": list(shape), "argument_parts": parts,
            "live_bytes": live, "temp_bytes": rec["memory"]["temp_bytes"],
            "measured_peak": held["peak"],
            "live_ratio": live / held["peak"], "roofline": roof,
            "measured_step_ms": step_ms, "hand_bound_ms": hand_ms}


def _plan_moe(torch, smi):
    """The expert-parallel MoE at moonshot-v1-16b-a3b's full width against
    the gather path on the same inputs, through ``apply_moe_auto`` under
    the mesh.  In float32 (the same bf16-valued inputs, upcast) the two
    are one function: within 1e-5 of max |out|.  In bf16 each column's
    partial is rounded before the psum adds them, so the paths round
    differently: the EP's distance from the float32 result must stay
    within twice the gather path's own (the gather path in bf16 is
    2.30e-5 from float32 where 1e-3 · max |out| is 2.99e-6 on these
    inputs, so that bound cannot tell rounding from a fault).  Aux within
    1e-6; the ms of each in bf16 and the psum's bytes from the mesh's
    ``CommManager``."""
    from repro_torch.configs.registry import optimized_config
    from repro_torch.core.comm import CommManager
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as M
    from repro_torch.models.param import materialize
    from repro_torch.sharding import partition as ps
    arch, (G, N), grid = PLAN_MOE
    cfg = optimized_config(arch)         # moe_impl="shardmap"
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    p = materialize(M.moe_specs(cfg), gen, device=dev)
    x = torch.randn((G, N, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    p32 = {k: v.float() for k, v in p.items()}
    mesh = make_mesh(grid, ("data", "model"), [dev] * math.prod(grid))
    comm = CommManager(devices=mesh.device_list())

    def dist(a, b):
        return float((a.float() - b.float()).abs().max())

    with torch.no_grad():
        want, aux_want = M.apply_moe(cfg, p, x)
        ref, aux_ref = M.apply_moe(cfg, p32, x.float())
        with ps.set_mesh(mesh, comm=comm):
            got, aux_got = M.apply_moe_auto(cfg, p, x)
        bytes_one = comm.stats.collective_bytes_total
        with ps.set_mesh(mesh):
            got32, aux_got32 = M.apply_moe_auto(cfg, p32, x.float())
    if not bytes_one:
        raise AssertionError("plan: apply_moe_auto did not take the EP path")
    scale = float(ref.abs().max())
    err32 = dist(got32, ref)
    err = dist(got, want)
    ep_off, gather_off = dist(got, ref), dist(want, ref)
    aux_err = max(abs(float(aux_got) - float(aux_want)),
                  abs(float(aux_got32) - float(aux_ref)))

    def ep():
        with ps.set_mesh(mesh):
            M.apply_moe_shardmap(cfg, p, x)

    with torch.no_grad():
        gather_ms = _time_ms(torch, lambda: M.apply_moe(cfg, p, x), reps=10)
        ep_ms = _time_ms(torch, ep, reps=10)
    n_model = grid[1]
    log(f"[plan] EP MoE ({arch}: E {cfg.n_experts}, D {cfg.d_model}, F "
        f"{cfg.d_ff}, top-{cfg.moe_topk}) on {G} × {N} tokens over a "
        f"{grid} mesh of the card repeated ({cfg.n_experts // n_model} "
        f"experts a column): float32 max |Δ| {err32:.4e} against apply_moe "
        f"(bound {1e-5 * scale:.4e} = 1e-5 · max |out|); bf16 max |Δ| "
        f"{err:.4e} against apply_moe (1e-3 · max |out| = "
        f"{1e-3 * scale:.4e}), {ep_off:.4e} from float32 against the "
        f"gather path's own {gather_off:.4e} (bound twice it); aux |Δ| "
        f"{aux_err:.3e} (bound 1e-6); bf16 apply_moe {gather_ms:.3f} ms, "
        f"apply_moe_shardmap {ep_ms:.3f} ms (CUDA events, median of 10); "
        f"the psum carried {bytes_one} bytes "
        f"({comm.stats.collective_supersteps} exchange, "
        f"{math.prod(grid)} partials of {G}×{N}×{cfg.d_model} bf16) on {smi}")
    if not err32 <= 1e-5 * scale or not ep_off <= 2 * gather_off \
            or not aux_err <= 1e-6:
        raise AssertionError("plan: the EP MoE disagrees with apply_moe")
    return {"max_abs_err_f32": err32, "max_abs_err_bf16": err,
            "bf16_from_f32": ep_off, "gather_bf16_from_f32": gather_off,
            "aux_err": aux_err, "gather_ms": gather_ms, "ep_ms": ep_ms,
            "psum_bytes": bytes_one}


def _plan_reshard(torch, smi):
    """The 2 + 2-layer whisper tree of [train]'s checkpoint (parameters
    and AdamW state after one step) sharded over a (4, 2) mesh of the card
    repeated, saved, restored onto (2, 2) with ``shardings=`` and joined
    by ``unshard``: bit for bit."""
    import dataclasses
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import device_put, synth_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import LModel
    from repro_torch.models.param import leaves, map_tree, specs, unflatten
    from repro_torch.sharding import partition as ps
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import make_train_step
    dev = torch.device("cuda", 0)
    n = TRAIN_CKPT_LAYERS
    S = TRAIN["seq"]
    cfg = dataclasses.replace(get_config(WHISPER_ARCH), n_layers=n,
                              n_enc_layers=n, microbatch_seqs=4)
    model = LModel(cfg, max_seq=S, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(0))
    ocfg = O.OptConfig(peak_lr=TRAIN["lr"], warmup_steps=1)
    state = O.init_state(ocfg, model.param_tree())
    batch = device_put(synth_batch(cfg, ShapeConfig("t", S, 4, "train"), 0,
                                   seed=0), dev)
    state, _ = make_train_step(model, ocfg)(state, batch)
    tree = {"params": map_tree(lambda t: t.detach(), model.param_tree()),
            "opt": state}

    def shardings(grid):
        mesh = make_mesh(grid, ("data", "model"), [dev] * math.prod(grid))
        pspec = specs(model.param_specs(), mesh, ps.TRAIN_RULES, fsdp=True)
        rep = ps.PartitionSpec()
        return ps.named_shardings({"params": pspec, "opt": {
            "m": pspec, "v": pspec, "step": rep}}, mesh)

    src, dst = (shardings(g) for g in PLAN_RESHARD)
    src_flat = dict(leaves(src))
    held = {path: src_flat[path].split(t) for path, t in leaves(tree)}
    sharded = sum(1 for path, _ in leaves(tree)
                  if any(src_flat[path].spec))
    d = os.path.join(ROOT, "build", "chip_smoke_reshard")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    t0 = time.perf_counter()
    ckpt.save(d, 1, unflatten(
        (path, ps.unshard(parts, src_flat[path]))
        for path, parts in held.items()))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = ckpt.restore(d, 1, tree, shardings=dst)
    restore_s = time.perf_counter() - t0
    dst_flat = dict(leaves(dst))
    joined = unflatten((path, ps.unshard(parts, dst_flat[path]))
                       for path, parts in leaves(restored))
    n_leaves = _same_tree_bits(torch, joined, tree)
    shutil.rmtree(d, ignore_errors=True)
    log(f"[plan] reshard: the {n} + {n}-layer whisper tree ({n_leaves} "
        f"leaves, {sharded} of them sharded on {PLAN_RESHARD[0]}) saved "
        f"from a {PLAN_RESHARD[0]} mesh of the card in {save_s:.2f} s, "
        f"restored onto {PLAN_RESHARD[1]} with shardings= in "
        f"{restore_s:.2f} s, unshard bit for bit on {smi}")
    return {"leaves": n_leaves, "sharded": sharded, "save_s": save_s,
            "restore_s": restore_s}


def phase_plan(torch, dev_info, lm_held, train_held):
    """The planning layer: see the module docstring (step 15)."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    smi = dev_info["smi"]
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    out = {"sweep": _plan_sweep(torch)}
    arch, shape = PLAN_DECODE
    out["decode"] = _plan_card_cell(torch, arch, shape, lm_held,
                                    lm_held["step_ms"] / 1e3,
                                    PLAN_HAND_BOUND_MS, smi)
    arch, shape, mb = PLAN_TRAIN
    out["train"] = _plan_card_cell(
        torch, arch, shape, train_held, train_held["step_s"], None, smi,
        cfg=dataclasses.replace(get_config(arch), microbatch_seqs=mb))
    out["moe"] = _plan_moe(torch, smi)
    gc.collect()
    torch.cuda.empty_cache()
    out["reshard"] = _plan_reshard(torch, smi)
    out["seconds"] = time.perf_counter() - t_phase
    out["card"] = smi
    log(f"[plan] phase {out['seconds']:.1f} s on {smi}")
    with open(os.path.join(OUT_DIR, "chip_smoke_plan.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    gc.collect()
    torch.cuda.empty_cache()


def main():
    if len(sys.argv) > 1:
        raise SystemExit("usage: python3 chip_smoke.py (no arguments)")
    t0 = time.perf_counter()
    import torch
    dev_info = phase_device(torch)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    phase_build()
    phase_kernels(torch)
    phase_analysis(torch, dev_info)
    kernels, main_graph = phase_main(torch, dev_info)
    kernels.extend(phase_serve(torch, dev_info, main_graph))
    kernels.extend(phase_serve_bitmap(torch, dev_info, main_graph))
    kernels.extend(phase_stream(torch, dev_info, main_graph))
    kernels.extend(phase_multi_pe(torch, dev_info, main_graph))
    del main_graph
    phase_others(torch)
    lm_kernel, lm_held = phase_lm(torch, dev_info)
    kernels.append(lm_kernel)
    kernels.append(phase_lm_families(torch, dev_info))
    kernels.extend(phase_whisper(torch, dev_info))
    train_held = phase_train(torch, dev_info)
    phase_plan(torch, dev_info, lm_held, train_held)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(f"{dev_info['smi']}")
    log(json.dumps({"kernels": [{k: v for k, v in kern.items()
                                 if k != "shape"} for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

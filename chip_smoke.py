#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card,
at the full ``dplr-fwfm`` width (and the training and ranking of the
other recsys models, the LMs' serving and training and PNA's training at
theirs), and hold every kernel against its plain version.

    python3 chip_smoke.py

Phases, one line each:

1. card: the ``nvidia-smi`` name and power limit; TF32 off.
2. build: compile ``src/repro_torch/kernels/csrc/*.cu`` with nvcc (sm_90a);
   fails if a kernel of ``dplr_corpus_score.cu``, ``dplr_score.cu``,
   ``embedding_bag.cu`` or ``fwfm_interaction.cu``, or
   ``flash_attention_wgmma``, spills registers.
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the shapes the serving and eval paths give it, plus ragged,
   all-dead and multi-hot edges; every top-K call also by C1 (below),
   with K past 4,096, K = n and adversarial orders of the scores; kernel
   1 at its edges (``FULL_EDGES``: one slot, a tile +- 1, one to three
   query groups, rho k = 3 and 128, k = 12, dead tiles, slabs 2 and 4
   bytes off a 16-byte boundary), every run at every query group bitwise
   the default geometry, and kernel 2 at K = n = 65,536 (Bq = 17) bitwise
   kernel 1's scores sorted, f32 and bf16; kernel
   3's batched rows bitwise equal to per-query calls, at edges of its tile,
   rho k = 128 and 3, m_I = 200, a misaligned V_I and 65,536 queries;
   kernel 5's backward at the train batch on skewed ids, bitwise equal to
   itself on a second call, every unnamed row exactly 0 in a freed
   NaN-filled allocation, and its radix sort alone bitwise
   ``torch.sort(stable=True)``; kernel 6 with a
   general and a pruned R, m in (1, 2, 128) by k in (1, 3, 32), B at edges
   of its tile, a misaligned V, and a ragged slice of the full batch
   bitwise equal to the full call's rows.  In bf16: kernels 1-4 on a bf16
   slab or V_I, each call bitwise the float32 kernels' call on the upcast
   inputs, at the served shapes and the edges above (ragged, a dead tile,
   K past 4,096, K = n, kernel 3's misaligned V_I, here 2 bytes off, and
   k = 12), every top-K by C1; ``acc_dtype='bfloat16'`` on bf16 and f32
   slabs against its plain version; kernel 5 on a bf16 table, bitwise on
   one-hot layouts (and a misaligned table), within its bound multi-hot;
   kernel 6 on a bf16 V at B = 262,144 and a ragged B (with a bf16 R,
   2 bytes off and at k = 12 too), bitwise its f32 launch on the upcast V.
   Kernel 7 also at starcoder2-7b's and yi-9b's heads (1 x 4,096, hd 128,
   36 and 32 query heads over 4 kv heads), granite-moe-1b-a400m's (2 x
   32,256, hd 64, 16 over 8, full causal) and mixtral-8x7b's (1 x 8,192, hd
   128, 32 over 8, a window of 4,096).
4. serve: the full config (82 fields, k = 16, rho = 3, random weights from
   a seed) serving a 1,000,000-item corpus from a 2^20-slot slab: top-K
   and score queries, churn, a model refresh, and Algorithm 1 per call,
   each held against the plain path (whose field lookups are the plain
   embedding bag, so no check runs a kernel), and one top-65,536 query.  The launches of each CUDA
   kernel are counted over this phase alone.
4b. serve-bf16: the same config, corpus and weights (cast to bf16, as
   ``launch/serve.py --bf16`` casts them) served from a bf16 slab: top-K
   and score queries at Bq = 1 and 16, one top-65,536, churn, a refresh
   from a float32 checkpoint through ``maybe_refresh``, one packed wave of
   16 tenants and Algorithm 1 per call, each held against the plain path;
   the Bq = 1 top-16 median beside the float32 engine's on the same
   corpus, and how many of its top-16 ids the bf16 engine keeps.  Every
   bf16 kernel must launch over the phase and no float32 instantiation of
   kernels 1-5 may; a Bq = 1 top-K call must hold less memory than half a
   float32 copy of the slab.  The bf16 rows of the ``kernels`` line count
   their launches over this phase.
5. tenants: the same config and weights serving 16 tenants on one
   ScorerRuntime, each 62,500 items of the serve phase's corpus in a
   65,536-slot slab, through ``QueryFrontend(pack=True)`` (one fused
   launch per wave of 16 tenants x 4 requests) and then through a
   ``pack=False`` frontend on the same states: every reply held against
   the plain scores, packed replies bitwise equal to unpacked ones,
   requests per second both ways, and the card's idle share over packed
   waves.  The multi-tenant kernel's launches are counted over the
   timed packed waves alone.
5b. shard: the serve phase's corpus and weights on ``make_host_mesh(4)``,
   four shards of 2^18 local slots sharing the card (one card each where
   there are four), in float32 and in bf16, beside a single-device engine
   on the same card: every slab row bitwise, the score and the top-16 at
   Bq = 1 and 16 bitwise, then a churn (+1,000 -1,000 ~100) and a growth
   of 60,000 items that doubles the slab, with the same slots assigned and
   the answers bitwise again; 16 tenants of 62,500 items on one sharded
   runtime, ``fused_topk`` bitwise 16 lone sharded calls (tenant 0 also
   the single-device engine's); each shard's kernel 1 against its plain
   version, its kernel 2 by C1 with its offset and stride, its kernel 4
   row by row bitwise kernel 2; ``rank_items_mp`` over four arena blocks
   at 1 x 512 against the plain path and ``rank_items``.  Prints the
   sharded and single-device top-16 medians (host clock).  The sharded
   engines' launches are counted over the phase (the bf16 half's into the
   bf16 rows).
5c. shard-train: the training half of sharding on ``make_host_mesh(4)``
   (``shard_train_phase``: the row-blocked lookup's step bitwise one
   shard's, kernel 5' a block, ``compressed_psum``, gemma3-1b's
   microbatches, PNA's ``+part`` cell).
5d. data: the mesh's data axis for the recsys family, a (2, 2) mesh (two
   data replicas of two arena blocks, all four positions on the card):
   ``dplr-fwfm/train_batch`` at full width (B = 65,536, the 33,040,384-row
   arena, adagrad), 4 steps beside the same steps unsharded and on
   ``make_host_mesh(4)`` from the same weights.  Step 1's loss and every
   gradient leaf against the unsharded step's (the loss within 1e-5 max(1,
   |loss|), each leaf within 1e-5 of its largest entry), the arena and
   first-order gradients per element within 1e-6 sum |w g| of the plain
   path on the replicas' rows; every step's loss within 1e-5 max(1,
   |loss|) of the unsharded step's from the same state, and every
   element of the parameters and accumulator within the bound that those
   gradient bounds give through adagrad's update of the same state; a
   second (2, 2) run bitwise the first; the (1, 4) steps
   bitwise the step before the data axis (``train.train_step`` with
   ``make_auto_take``); 10 launches of kernels 5 and 5' a step.  Then
   ``serve_bulk`` (262,144 rows) and ``retrieval_cand`` (1 x 1,000,000)
   on (2, 2) against the unsharded cells.  Prints the median step (CUDA
   events) of each mesh, the launches and the phase's peak memory.
5e. lm-mesh: the LM family on the mesh (``models.transformer.parallel``),
   every position on the card, each cell beside the one-device cell from
   the same weights and tokens: ``train_4k`` at B = 4 on (2, 2) for
   gemma3-1b (full width and depth), granite-moe-1b-a400m (full depth, 16
   experts a position) and yi-9b (full width, 2 of 48 layers, FSDP):
   step 1's gradients (``train.lm_data_parallel_grads``, joined from each
   block's first holder, every other holder's copy bitwise it), leaf by
   leaf no further from one device's f32 leaf than ``LM_MESH_F32`` times
   one device's bf16 leaf's distance plus ``LM_MESH_FLOOR`` of its largest
   entry, each of 2 steps' loss within
   ``LM_MESH_LOSS``, an MoE model's steps under one device's routes (its
   own counted where they differ), a second run bitwise; prefills
   through kernel 7 at each position's heads: gemma3-1b 2 x 32,752 on
   (2, 2) (2 heads a position, KV = 1 gathered) with one ``decode_32k``
   step on that cache at slot 32,752 of 32,768 (the sequence over the
   model axis), granite-moe-1b-a400m 2 x 8,192 on (2, 2) (hd 64),
   mixtral-8x7b at 4 layers 1 x 8,192 on (1, 16) (2 heads a position,
   KV = 8 gathered, d_ff / 16 of every expert), gemma3-1b 1 x 32,752 on
   (1, 8) (4 heads on 8 positions: the query rows split, kernel 7 at each
   position's row offset), each position's first
   kernel 7 launch held to its plain version, logits and cache by the
   f32 yardstick, a second call bitwise.  Prints each cell's median step
   or call (CUDA events) beside one device's, kernel 7's launches, the
   peak memory and each cut's collective bytes counted a device on
   ``meta``.
6. wire: the serving front door on the serve phase's engine and the
   tenants phase's 16 states, one ``QueryFrontend(pack=True)`` behind
   ``RpcServer`` on loopback: 1,000 Bq = 1 top-16 requests pipelined over
   4 connections and a packed round over the tenants, every reply
   bitwise the direct ``submit(...).result()`` of the same request (and
   each direct reply bitwise ``engine.topk``'s row in a batch of 16);
   typed error frames for an out-of-range context id and an expired
   deadline; a graceful drain of queued requests; wire and direct-submit
   latency (host clock).  Then scripted faults on the same engine
   (dispatch, resolve and kernel faults retried bitwise, spent kernel
   retries typed ``DispatchFailed`` with ``kernel_degraded`` False, write
   and alloc faults changing nothing, a stalled pump restarted by the
   watchdog, a seeded storm in which every request resolves), and the
   Bq = 1 and packed dispatches under ``REPRO_SANITIZE=1``, whose guard
   raises on an ``.item()`` inside it.  Kernel launches are counted over
   the wire traffic.
7. eval: the paper's comparison through ``eval.harness`` on the serve
   phase's data: ``evaluate_pointwise`` on 20,000 held-out rows for the
   DPLR model, the full-FwFM baseline (``make_fwfm_baseline``, random
   weights from a seed) and its matched-pruned form (249 of 3,321
   entries), each model's logits held against the plain path;
   ``model_scores(pruned=)`` against ``apply(pruned_mask=)``; and
   ``serving_parity`` for the DPLR model at 16 queries x 16,384 items
   (model, engine and frontend scores against the plain scores, top-10
   ids equal except at ties); then the full-FwFM baseline cast to bf16
   through ``evaluate_pointwise`` and ``score_split``, its logits against
   the plain path, only the bf16 kernels 5 and 6 launched.  Kernel
   launches are counted over this phase alone (the bf16 case's into the
   bf16 rows).
8. train: ``dplr-fwfm`` at full width through ``launch.train``'s
   ``train_step`` and a ``ShardedPipeline``: step 1's loss and gradients
   through the kernels against the plain forward with autograd; run A, 16
   adagrad steps at B = 4,096, lr 0.05, checkpoints at steps 8 and 16
   (``CheckpointManager(keep=2)`` in a temporary directory under
   ``build/``); run B, restored from step 8, bitwise run A from step 9
   (losses, params and accumulator); the plain path's 16 losses; the
   full-FwFM baseline's 4 steps against its plain path and
   ``posthoc_dplr`` of its R on the card against the CPU; then run A's
   directory served through ``CorpusState.maybe_refresh`` (top-K by C1
   and against plain, Algorithm 1, a second poll, a truncated newest step
   raising ``RefreshFailed`` once).  Step time split by CUDA events,
   checkpoint and refresh seconds, peak memory.  Kernel launches are
   counted over run A, the baseline's steps and the serving.
9. models: the rest of the recsys family, ``wide-deep``, ``autoint``,
   ``bst`` and ``mind`` at ``make_config()`` (no cut; random weights from
   a seed), one at a time, each freed before the next: step 1's loss and
   gradients through the kernels against the plain path (plain bags,
   autograd); two runs of 4 adagrad steps at B = 4,096, lr 0.05 on the JAX
   trainer's batches (made in a process of their own from the start of
   the script), bitwise equal (losses, and an int64 sum of each leaf's f32
   bits for params and accumulator); ``rank_items`` at 1 x 512 (MIND also
   at 1 x 1,000,000) against the plain path and against ``apply`` on the
   same (context, item) rows, and its median latency over 50 queries.
   Step time split by CUDA events, peak memory per arch.  Launches of
   kernels 5 and 5' are counted over the steps and the timed queries.
10. lm: gemma3-1b at full width (26 layers, d = 1152, random f32 weights
   from a seed, bf16 compute): a prefill of B = 2 prompts of 32,752
   tokens into a 32,768-slot cache through the flash-attention kernel
   (26 launches), the same prefill through the attention's plain version
   and a plain f32 prefill, both bf16 prefills held against the f32 one
   on the last logits and the cache; then 16 greedy ``decode_step``s from
   the kernel prefill's cache, held against one pass over the same tokens
   at those positions on that cache.  Prefill seconds,
   decode ms a step (host clock, synchronized) and peak memory.  Then
   starcoder2-7b and yi-9b at full width (1 x 4,096, 8 steps), and the MoE
   LMs: granite-moe-1b-a400m at full width and depth (2 x 32,256 into
   32,768 slots, 16 steps) and mixtral-8x7b at full width with 4 of its 32
   layers (1 x 8,192, 8 steps), by the same checks, each model freed before
   the next.  An MoE model's prefill and steps run again with each layer's
   routes recorded; the plain paths run under those routes, and the
   (layer, token) routes their own logits would change are counted, with
   each layer's share of dropped (token, choice) pairs.  On granite's first
   layer, the scatter implementation and the fused combine against the
   einsum one (``moe_impl_check``).
10b. lm-train: gemma3-1b and granite-moe-1b-a400m at full width, 4 adamw
   steps at 4 x 4,096 under deterministic algorithms, step 1 against the
   plain bf16 and f32 losses (the MoE one under the bf16 loss's routes),
   and a resumed run at 2 layers bitwise the uninterrupted one.
10c. gnn: PNA at ``make_config()`` widths on three shapes.
10d. examples: the port's ``examples/`` on the card.  quickstart at its
   defaults (FM, full FwFM and DPLR, 300 adagrad steps of B = 1,024 each,
   the matched-pruned FwFM, Algorithm 1 over 1,000 candidates), then again
   through the plain versions of kernels 3, 5 and 6: each step's loss
   within ``1e-4 max(1, |loss|)`` of the plain run's, and on its weights
   the eval logits and Algorithm 1's scores within ``1e-5 max(1, size)``
   of the plain path.  train_e2e on the reference's 82-field layout (92 M
   parameters), B = 2,048, checkpoints every 50 steps (keep 2) in a
   temporary directory under ``build/``, cut to 50 steps, its first 25
   through the plain path, the losses and eval logits held likewise.
   ranking_server at its defaults and at 1,000,000 items and top-16 (path
   1 cut to 3 queries, the tenants of paths 6-7 to 512 items): path 1's
   first query, path 2's first context and every reply of the packed
   tenant frontends (paths 6-7, but path 6's churned tenant) against the
   plain path, every path's kernels through ``LAUNCHES`` (kernels 3, 5, 1
   or 2, and 4 over paths 6-7), one top-K launch each micro-batch.
10e. dryrun: ``launch.dryrun`` over every registry cell on ``meta`` in a
   process of its own started with the script (one line a cell: flops,
   bytes, peak bytes, whether it fits the card), and ``launch.dryrun
   --mesh both`` over the five recsys architectures' 20 cells and the
   five LMs' 17 in another (one line a cell and mesh: a device's peak,
   collective bytes and whether it fits; ``dplr-fwfm/train_batch``'s bytes
   a device equal to the partition rules' by hand, ``mesh_figures``; each
   LM's parameters a device ``LM_MESH_PARAMS``); then each cut the script
   runs (gemma3-1b and granite-moe-1b-a400m train at 4 x 4,096, gemma3-1b
   prefill of 2 x 32,752, PNA ``minibatch_lg``) counted on ``meta`` beside
   4 steps of it on the card after a warm one (the median step): its
   ``peak_bytes`` within 1.5x of ``max_memory_allocated`` either way.
11. timing: each kernel's median time over CUDA events (the bf16
   instantiations of kernels 1-6 beside their float32 rows, on the same
   inputs in bf16, and the ``acc_dtype='bfloat16'`` mode), its plain
   version's, and the bound (the larger of bytes over the card's memory
   rate and flops over its f32 rate, or its bf16 tensor-core rate for
   flash attention); the top-K at each shape of ``topk_times`` (Bq, K and
   scores in random or rising order), each beside the yardstick kernel 1
   + ``torch.topk`` (two calls, which the port never makes); beside the
   multi-tenant kernel, the summed time of one single-tenant top-K call
   per tenant and that yardstick per tenant; beside the embedding-bag,
   FwFM and flash-attention kernels, one PyTorch call that computes the
   same function (``library_ms``; for the windowed attention,
   ``F.scaled_dot_product_attention`` with the (S, S) causal-and-window
   mask; for the embedding bag's backward, a zeroed table and
   ``index_add_``; for its radix sort, one stable ``torch.sort``), the
   backward's sort and writer each alone; and each top-K shape's peak
   device memory (its scratch and outputs) beside the yardstick's.
12. autotune: ``kernels/autotune.py`` sweeps the corpus kernels' geometry
   (``autotune.DEFAULT_CANDIDATES``: stage 1's chunk, threads, query group
   and the merge's part) at the served cells, on the serve phase's slab
   and queries: n = 2^20 at Bq = 1 and 16 in float32, the same slab in bf16
   at Bq = 1 with both accumulators, and the 16 tenants' 65,536-slot slabs
   at Bq = 4 through the multi-tenant launch a packed wave makes (winners
   apply only to launches like the ones they were timed on:
   ``blocks.launch_class``), all at K = 16.  Every
   float32 candidate must be bitwise the default geometry's output, which
   holds C1; every bf16-accumulation candidate passes the tuner's gate or
   is recorded and never crowned; a candidate past the card's shared
   memory is recorded as not launchable; one past a small n shows as a
   clamp event.  After registration a ``block_n=None`` call is bitwise the
   explicit winner's, and the served engine's top-K and a packed wave are
   bitwise their untuned selves.  One line a cell: the default's and the
   winner's ms (device time a call: ``autotune._time_call`` queues the
   timed calls behind a device-side sleep, so no host time is in it), the
   speedup and the fraction of the bound; then kernels 1, 2 and 4 and
   their bf16 rows at the timing phase's shapes, default and tuned
   (registry) geometry, timed side by side the same way: a row whose
   tuned time is past its default's is flagged, and past 1.10 times it
   fails.  Then the registry's bounds: a Bq = 1 record leaves a Bq = 16
   call at the default geometry, and a record past the card's shared
   memory is halved visibly until it launches, both bitwise the default.
   The registry is cleared after, so the profile runs untuned.
13. profile: with torch.profiler, the device time of a top-K call by CUDA
   kernel, the host's time to issue one (for the multi-tenant call, also
   without the wrapper's checks), and the device's idle share while the
   serving engine answers Bq = 1 queries.

A profiled window counts only when the profiler saw exactly the launches
of each hand-written kernel that ``ops.LAUNCHES`` counted in it: the
tracer can drop events, and a dropped kernel reads as idle time.  A
window is tried up to three times, then reported "not measured".

Then a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Any failed check raises, so the ``ok`` line is never printed after
a failure.  Exits non-zero where there is no CUDA card.

Tolerance on the card: ``|got - plain| <= 1e-5 * max(1, |plain|)``, or
``max(1, size)`` where a score is a sum of terms much larger than itself
(``size``: the summed magnitude of the terms).  The embedding bag is
bitwise on one-hot layouts (one slot a bag) and within
``1e-6 * sum |w * row|`` on multi-hot ones.  The
kernels sum in another order than PyTorch's einsum (and use fused
multiply-adds), and full-width scores reach tens, so a bound relative to
the score is the meaningful one.  Kernel 3's rho k = 128 and m_I = 200
cases use the size-scaled form (their scores are differences of terms up
to ~100).  Kernel 5's backward: within ``1e-6 * sum |w g|`` of the plain
vjp per table element.  Training: step 1's loss within ``1e-5 max(1,
|loss|)``, each arena row's gradient within ``1e-5`` of its terms'
summed magnitude, every other gradient within ``1e-5`` of its tensor's
largest entry; the kernel path's losses within ``1e-4 max(1, |loss|)`` of
the plain path's over the run; ``posthoc_dplr``'s error on the card
within 1% of the CPU's.  The models phase holds step 1 by the same rule
(an arena row's size: the summed ``|w| |dL/d bag|`` of the slots naming
it), ``rank_items`` within ``1e-5 max(1, |s|)`` of the plain path and
within ``1e-4 + 1e-4 |s|`` of ``apply`` on the same rows (the JAX
package's ``tests/test_ranking.py`` bound).  The lm-train phase: step 1's
loss within ``1e-5 max(1, |loss|)`` of the plain bf16 path without
checkpointing and ``2^-7 max(1, |loss|)`` of the f32 one.  The gnn phase:
step 1's loss within ``1e-4 max(1, |loss|)`` of the CPU's plus twice the
CPU's own spread under a one-ulp change of the node features (the std
aggregator's cancellation, ``gnn_phase``).  Top-K ids must equal the plain stable
top-K's, except where the plain scores tie within that tolerance; planted
exact ties must go to the lower slot.

bf16: kernels 1-4 on bf16 inputs with ``acc_dtype='float32'`` must be
bitwise their float32 launch on the upcast inputs (the upcast is exact and
the arithmetic after it the same), so C1 and the float32 tolerances above
carry over.  ``acc_dtype='bfloat16'`` rounds each square, each e_r and the
sum to bf16: within ``2^-8 * term + 1e-5 * max(1, size)`` of its plain
version (``term`` = sum_r |e_r| ||P_C + Q_I||^2: two sums of the same
exact products in other orders may round to neighbouring bf16 values, half
a term's ulp apart; the reference's 5e-2 holds only at test sizes, where a
term is small).  Kernel 5 in bf16 rounds each product and add to bf16:
bitwise the plain version on one-hot layouts; on a bag of m slots bitwise
``ref.embedding_bag_in_order`` (its own order) and within ``2^-7 (m - 1)
sum |w row|`` of the plain version, whose atomics add in another order
(each add rounds by at most 2^-8, bf16's unit roundoff, of the sum so
far).  The serve-bf16 phase's answers against
the plain path are held by the float32 rules: its query side is computed
by the same code in both, so only the scorer's order differs.  Row [s] of the multi-tenant kernel
must equal the single-tenant top-K kernel on segment s bitwise, and a
packed reply the unpacked one.

C1, exact: every top-K call of the kernel phase (kernels 2 and 4, each
row of kernel 4 against its own segment) must return values and ids
bitwise equal to ``ref.topk_stable`` of kernel 1's scores of the same
inputs on the card, dead slots included, relabeled: the top-K kernels
share kernel 1's scorer, so they select from the very scores kernel 1
writes.

Flash attention, against its plain version (which rounds where the
kernel rounds): f32 within ``1e-5 * max|v|``; bf16 within ``2^-7 * max|v|``
and, per element, within ``2^-7 (|o| + sum_j p_j |v_j| / l) + 1e-5 max|v|``
(one output ulp, one ulp of each p, which both round once at running
maxima that may differ, and the f32 bound).  The lm phase's bounds (an
MoE model's paths under one set of routes): the
kernel path's largest error from an f32 prefill (through
``gqa_attention``), on the last logits and on the cache, at most
``1.25x`` the plain path's; a decode step's logit within ``3e-3 + 3e-2
|x|`` of one pass over the decoded positions on the same cache: the
JAX package's ``test_decode_matches_forward`` bound.  That pass attends
through ``gqa_attention``, which rounds its scores to bf16 as decode
does, and reads the prefill's cache, all its slots, as decode does (an
MoE layer routes each position's B tokens as one group, as a step does);
only the number of query positions in its products differs (all at
once).  A random-init MoE model is sensitive enough that a last-bit
difference, such as a product over fewer keys, moves its logits past the
bound (``scripts/moe_decode_sensitivity.py``).  The ratio with one
rounding of each term (``2^-8 size``, ``size`` the logit's summed
``|h_d E_vd|``) added is printed too.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import json
import multiprocessing
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import optim  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    dplr_fwfm,
    gemma3_1b,
    granite_moe_1b_a400m,
    mixtral_8x7b,
    starcoder2_7b,
    yi_9b,
)
from repro_torch.configs import pna as pna_cfg  # noqa: E402
from repro_torch.configs.registry import REGISTRY  # noqa: E402
from repro_torch.core import ranking as rk  # noqa: E402
from repro_torch.core.dplr import (  # noqa: E402
    DPLRParams,
    dplr_diagonal,
    materialize_R,
    posthoc_dplr,
)
from repro_torch.core.fields import FeatureLayout  # noqa: E402
from repro_torch.core.interactions import dplr_pairwise, dplr_pairwise_explicit_d  # noqa: E402
from repro_torch.core.pruning import matched_param_count, prune_matched  # noqa: E402
from repro_torch.data.pipeline import ShardedPipeline  # noqa: E402
from repro_torch.data.synthetic_ctr import SyntheticCTR, sample_ids  # noqa: E402
from repro_torch.embedding import bag as field_lookups  # noqa: E402
from repro_torch.embedding import sharded  # noqa: E402
from repro_torch.embedding.bag import (  # noqa: E402
    item_arena_ids,
    lookup_linear_terms,
    padded_rows,
)
from repro_torch.eval import harness  # noqa: E402
from repro_torch.kernels import _build, autotune, blocks, ops, ref, work  # noqa: E402
from repro_torch.kernels import dplr_score as items_kernel  # noqa: E402
from repro_torch.kernels import embedding_bag as bag_lib  # noqa: E402
from repro_torch.kernels import fwfm_interaction as pair_kernel  # noqa: E402
from repro_torch.kernels.dplr_corpus_score import NEG_INF  # noqa: E402
from repro_torch.examples import quickstart, ranking_server, train_e2e  # noqa: E402
from repro_torch.launch import cost, dryrun, steps  # noqa: E402
from repro_torch.launch import serve as serve_driver  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_host_mesh  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.models.gnn import pna, sampler  # noqa: E402
from repro_torch.models.recsys import fwfm  # noqa: E402
from repro_torch.models.transformer import attention  # noqa: E402
from repro_torch.models.transformer import model as tm  # noqa: E402
from repro_torch.models.transformer import moe  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CorpusState,
    DeadlineExceeded,
    DispatchFailed,
    FaultInjector,
    InjectedFault,
    QueryFrontend,
    RefreshFailed,
    RpcClient,
    ScorerRuntime,
    ServingError,
    scoring_guard,
    serve_in_thread,
)
from repro_torch.serving.corpus import (  # noqa: E402
    ItemCorpusCache,
    masked_slab_scores,
    next_pow2,
)
from repro_torch.serving.engine import fused_topk  # noqa: E402
from repro_torch.serving.rpc import encode_rank_request, frame  # noqa: E402

TOL = 1e-5

# kernel 7 at the MoE LMs' prefills (B, S, H, KV, hd, window): granite-moe-1b-a400m's
# (hd 64, 2 query heads a kv head, full causal, 2 prompts of 32,256) and
# mixtral-8x7b's (hd 128, 4 a kv head, a window of 4,096 on 8,192 positions)
FLASH_MOE = ((2, 32_256, 16, 8, 64, None), (1, 8192, 32, 8, 128, 4096))


def mixtral_cut() -> tm.TransformerConfig:
    """mixtral-8x7b at its published widths with 4 of its 32 layers: at
    full depth its 187 GB of f32 parameters do not fit one card (the dry
    run counts it a device of the production meshes)."""
    return dataclasses.replace(mixtral_8x7b.make_config(), n_layers=4)


FULL = SimpleNamespace(
    n=1 << 20, live=1_000_000, bqs=(1, 16), ks=(1, 16, 1024), rho=3, k=16,
    n3=65_536, m3=38, bq3s=(1, 4), edge_n=1000,
    make_config=dplr_fwfm.make_config, items=1_000_000, capacity=1 << 20,
    queries=20, batch=16, churn=(1000, 1000, 100), percall_n=65_536, topk=16,
    big_topk=65_536,
    # multi-tenant kernel: (S, Bq, n_s, K), and a ragged masked case
    multi=(16, 4, 65_536, 16), ragged=((1100, 70_000, 20_000), 2, 1024),
    tenants=16, tenant_items=62_500, tenant_capacity=65_536, tenant_bq=4,
    waves=16, warm_waves=2, profile_waves=4,
    # shard: the serve corpus on a mesh of 4 shards; the Bq of its checks and
    # medians, timed calls a median, the churn (add, remove, update, then a
    # growth that doubles the slab) and rank_items_mp's candidates
    shards=4, shard_bqs=(1, 16), shard_reps=20, shard_churn=(1000, 1000, 100, 60_000),
    mp_items=512,
    # shard-train: dplr-fwfm's train_batch and serve_bulk cells at their
    # registry batches (dims None: B = 65,536 and 262,144) on the shard mesh,
    # adagrad steps a run (and timed steps after a warm one); gemma3-1b's
    # train_4k cut from B = 256 to 4 (its 4 micro_batches, of 1 x 4,096 each)
    # and its timed steps; PNA's full_graph_sm+part uncut, bf16 adamw steps a
    # run and timed; the phase's wall-clock limit
    strain_dims=None, strain_serve_dims=None, strain_steps=4,
    strain_lm=gemma3_1b.make_config, strain_lm_dims={"batch": 4}, strain_gnn_dims=None,
    strain_lm_steps=2, strain_gnn_steps=8, strain_seconds=120,
    # data: dplr-fwfm's train_batch, serve_bulk and retrieval_cand cells at
    # their registry sizes (dims None: B = 65,536, 262,144 and 1 x 1,000,000) on
    # a (2, 2) mesh, adagrad steps a run
    data_dims=None, data_serve_dims=None, data_retrieval_dims=None, data_steps=4,
    # lm-mesh: (arch, config, train_4k's dims, mesh) of the train cells, adamw
    # steps a run: gemma3-1b at full width and depth, B cut from 256 to 4;
    # granite-moe-1b-a400m at full depth, B = 4; yi-9b at full width, 2 of its
    # 48 layers, FSDP; then (arch, config, prefill_32k's dims, mesh, decode's
    # cache slots) of the prefills: gemma3-1b at 2 x 32,752 (a decode step
    # at slot 32,752 of 32,768), granite-moe-1b-a400m at 2 x 8,192, mixtral-8x7b
    # at 4 of its 32 layers, 1 x 8,192 on the production model axis (1, 16),
    # gemma3-1b at 1 x 32,752 on (1, 8), where its 4 heads do not split and
    # the query rows do (kernel 7 at each position's row offset); timed calls
    # a prefill
    lm_mesh_train=(("gemma3-1b", gemma3_1b.make_config, {"batch": 4}, (2, 2)),
                   ("granite-moe-1b-a400m", granite_moe_1b_a400m.make_config, {"batch": 4},
                    (2, 2)),
                   ("yi-9b", lambda: dataclasses.replace(yi_9b.make_config(), n_layers=2),
                    {"batch": 4}, (2, 2))),
    lm_mesh_steps=2,
    lm_mesh_serve=(("gemma3-1b", gemma3_1b.make_config, {"batch": 2, "seq": 32_752}, (2, 2),
                    32_768),
                   ("granite-moe-1b-a400m", granite_moe_1b_a400m.make_config,
                    {"batch": 2, "seq": 8192}, (2, 2), None),
                   ("mixtral-8x7b", mixtral_cut, {"batch": 1, "seq": 8192}, (1, 16), None),
                   ("gemma3-1b", gemma3_1b.make_config, {"batch": 1, "seq": 32_752}, (1, 8),
                    None)),
    lm_mesh_calls=2,
    # wire: Bq = 1 requests pipelined over connections, each with a window
    wire_requests=1000, wire_conns=4, wire_window=4,
    # embedding bag: rows of the context lookup (Bq), of the slab build
    # (items), of pointwise eval; and a B whose threads end mid-block
    bag_rows=(16, 1_000_000, 4096), bag_ragged=4097,
    # fwfm_pairwise (B, m): the eval batch, serve_bulk's pointwise batch,
    # and one example of a 39-field model; the B of the (m, k) grid of edge
    # cases, and the multiple of the tile whose neighbours are checked
    pairs=((4096, 82), (262_144, 82), (1, 39)), pair_small_b=333, pair_tiles=256,
    # dplr_score_items: n at a multiple of the tile +- 1, and the query
    # count of the n = 2 case
    items_tiles=125, items_many=65_536,
    make_fwfm=dplr_fwfm.make_fwfm_baseline, eval_n=20_000, eval_batch=4096,
    parity=(16, 16_384), pruned_q=(4, 1024),
    # top-K past the old 4,096 limit, the adversarial orders (n, live, Bq,
    # Ks) and K = n (n, Bq), all held by C1
    big_ks=(4097, 65_536), adv=(1 << 20, 1_000_000, 16, (16, 1024, 4096, 4097, 65_536)),
    # kernel 1's edges: the runs swept at every query group, and the (n, Bq)
    # of kernel 2 at K = n held to kernel 1's scores sorted
    full_runs=(1, 7, 255, 256, 257, 1000, 4096, 32_768), full_c1=(65_536, 17),
    # autotune: the sweep, timed calls a candidate, (Bq, slab dtype) of the
    # serve phase's slab to sweep, and the tenants' Bq
    tune_candidates=autotune.DEFAULT_CANDIDATES, tune_repeats=20,
    tune_cells=((1, "float32"), (16, "float32"), (1, "bfloat16")),
    large=(70_000, 2),
    # timed top-K shapes (Bq, K, order of the scores); the first is the row's
    topk_times=((16, 16, "random"), (1, 16, "random"), (16, 1024, "random"),
                (1, 1024, "random"), (1, 4096, "random"), (16, 4096, "random"),
                (16, 65_536, "random"), (16, 16, "rising"), (16, 1024, "rising")),
    # flash attention (B, S, H, KV, hd, window): gemma3-1b's global and
    # windowed layers at the lm phase's batch, then ragged small cases
    # (GQA, MHA, 9 heads a kv head, S ragged against 128-key tiles at B = 3)
    flash=((2, 32_752, 4, 1, 256, None), (2, 32_752, 4, 1, 256, 1024)),
    flash_small=((1, 1000, 4, 1, 256, 64), (2, 777, 8, 8, 64, None),
                 (1, 300, 36, 4, 128, 100), (3, 1001, 8, 2, 128, None)),
    # starcoder2-7b's (9 query heads a kv head) and yi-9b's (8) heads at the
    # lm phase's prompt
    flash_heads=((1, 4096, 36, 4, 128, None), (1, 4096, 32, 4, 128, None)) + FLASH_MOE,
    flash_moe=FLASH_MOE,
    # kernel 6 on a bf16 V: the full batch, and a ragged B past a multiple
    # of the tile, bitwise its f32 launch on the upcast V
    pair_bf16=((262_144, 82), (16 * 4096 + 5, 82)),
    make_lm=gemma3_1b.make_config, lm_batch=2, lm_prompt=32_752, lm_cache=32_768,
    lm_steps=16,
    # the dense LM configs at full width: a prompt of B = 1 x 4,096 tokens
    # (prefill_32k's 32 x 32,768 cut), 8 greedy decode steps
    lm_models=(starcoder2_7b.make_config, yi_9b.make_config), lm_model_prompt=4096,
    lm_model_steps=8,
    # the MoE LMs (make, B, prompt, cache slots, decode steps): granite at full
    # width and depth, prefill_32k cut to 2 x 32,256 (63 groups of 512 a row);
    # mixtral at full width, 4 of 32 layers, 1 x 8,192 (past its window).
    # The MoE implementations are checked on granite's layer moe_impl_layer
    lm_moe=((granite_moe_1b_a400m.make_config, 2, 32_256, 32_768, 16),
            (mixtral_cut, 1, 8192, 8192 + 8, 8)),
    moe_impl_layer=0,
    # lm-train: gemma3-1b and granite-moe-1b-a400m at train_4k's seq, B cut
    # from 256 to 4, adamw at the JAX trainer's lr; the resume check at the
    # full widths with 2 layers
    lm_train_models=(gemma3_1b.make_config, granite_moe_1b_a400m.make_config),
    lm_train_batch=4, lm_train_seq=4096, lm_train_steps=4, lm_train_lr=0.05,
    lm_resume_layers=2, lm_resume_steps=4, lm_resume_save=2,
    # gnn: PNA at make_config() widths on the shapes below (ogb_products does
    # not fit one card, whole or partitioned: the dry run), adamw steps at the
    # JAX example's lr
    gnn_shapes=("minibatch_lg", "molecule", "full_graph_sm"), gnn_steps=8, gnn_lr=1e-3,
    gnn_make=pna_cfg.make_config, gnn_graph=(232_965, 492), gnn_minibatch=(1024, (15, 10)),
    gnn_seed=0,
    # training: adagrad steps at the JAX trainer's batch and lr, a checkpoint
    # every train_save steps; the full-FwFM baseline's steps and its
    # post-hoc DPLR rank; the Bq of the queries served from the checkpoint;
    # the bytes a corrupt copy of the newest checkpoint keeps
    train_batch=4096, train_steps=16, train_save=8, train_lr=0.05, base_steps=4,
    posthoc_rank=3, train_serve_bqs=(1, 16), truncate_bytes=64 << 20,
    # models: the rest of the recsys family at make_config(), 4 adagrad steps
    # a run at the JAX trainer's batch and lr, rank_items at serve_p99 (and
    # MIND's retrieval_cand), queries a shape, apply's rows a chunk
    models=("wide-deep", "autoint", "bst", "mind"), model_make="make_config",
    model_batch=4096, model_steps=4, model_lr=0.05, model_queries=50,
    model_ranks={"wide-deep": (512,), "autoint": (512,), "bst": (512,),
                 "mind": (512, 1_000_000)}, model_apply_chunk=65_536,
    # examples: quickstart at its defaults (steps a model, Algorithm 1's
    # model's steps) and the eval rows its logits are held on; train_e2e on
    # the reference's layout at its batch, lr and checkpoint cadence, its 300
    # steps cut to 50 for the script's time (a batch is ~0.23 s of host
    # draws, its checkpoints 0.74 GB), its first e2e_plain_steps also through
    # the plain path;
    # ranking_server at its defaults (paths 6-7 pack tenants: kernel 4), and
    # at the served corpus (1,000,000 items, top-16) with path 1 cut to 3
    # queries (each draws 63 M zipf ids on the host, ~13 s) and the tenants
    # of paths 6-7 at the default 512 items (at 1,000,000 items they would
    # draw 5 more such corpora)
    qs_steps=300, qs_rank_steps=100, qs_rows=20_000,
    e2e_layout=train_e2e.make_layout, e2e_steps=50, e2e_batch=2048, e2e_ckpt_every=50,
    e2e_plain_steps=25,
    server_runs=([], ["--items", "1000000", "--topk", "16", "--percall-queries", "3",
                      "--tenant-items", "512"]),
    # dryrun: every cell (no selection), and the cuts the lm-train, lm and
    # gnn phases run (arch, shape, dims, config), each counted on meta beside
    # dryrun_steps steps on the card (after a warm one), timed at the median
    dryrun_args=(), dryrun_timeout=900, dryrun_steps=4,
    # the recsys and LM families' cells counted a device of the production meshes
    dryrun_mesh_args=("--mesh", "both", "--arch", "dplr-fwfm", "--arch", "wide-deep",
                      "--arch", "autoint", "--arch", "bst", "--arch", "mind",
                      "--arch", "gemma3-1b", "--arch", "starcoder2-7b", "--arch", "yi-9b",
                      "--arch", "granite-moe-1b-a400m", "--arch", "mixtral-8x7b"),
    dryrun_cuts=(("gemma3-1b", "train_4k", {"batch": 4}, None),
                 ("granite-moe-1b-a400m", "train_4k", {"batch": 4}, None),
                 ("gemma3-1b", "prefill_32k", {"batch": 2, "seq": 32_752}, None),
                 ("pna", "minibatch_lg", None, None)),
)

BUILD = Path(__file__).resolve().parent / "build"

# NVIDIA data-sheet peaks, by the card name torch reports: (device memory
# bytes/s, f32 flop/s outside the tensor cores, dense bf16 tensor-core
# flop/s).  One table with the autotuner's roofline (autotune.HW_PROFILES).
PEAKS = tuple((name, p["hbm_bw"], p["f32_flops"], p["bf16_flops"])
              for name, p in autotune.HW_PROFILES.items() if name != "cpu")

# The entry points the serve phase drives; the tenants phase drives
# dplr_corpus_score_multi, the eval phase embedding_bag and fwfm_pairwise.
SERVE_KERNELS = ("dplr_corpus_score", "dplr_corpus_topk", "dplr_score_items",
                 "embedding_bag")
EVAL_KERNELS = ("embedding_bag", "fwfm_pairwise")
TRAIN_KERNELS = ("embedding_bag", "embedding_bag_backward")

KERNEL_ROWS = {
    "dplr_corpus_score": ("src/repro_torch/kernels/csrc/dplr_corpus_score.cu",
                          "src/repro/kernels/dplr_corpus_score.py:196"),
    "dplr_corpus_topk": ("src/repro_torch/kernels/csrc/dplr_corpus_score.cu",
                         "src/repro/kernels/dplr_corpus_score.py:212"),
    "dplr_score_items": ("src/repro_torch/kernels/csrc/dplr_score.cu",
                         "src/repro/kernels/dplr_score.py:75"),
    "dplr_corpus_score_multi": ("src/repro_torch/kernels/csrc/dplr_corpus_score.cu",
                                "src/repro/kernels/dplr_corpus_score.py:376"),
    "embedding_bag": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag.py:78"),
    # the backward of kernel 5's port (the JAX trainer differentiates the
    # jnp lookup; the Pallas kernel has no vjp)
    "embedding_bag_backward": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                               "src/repro/kernels/embedding_bag.py:78"),
    # that backward's radix sort of the slots by row, on its own
    "bag_rows_sort": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag.py:78"),
    "fwfm_pairwise": ("src/repro_torch/kernels/csrc/fwfm_interaction.cu",
                      "src/repro/kernels/fwfm_interaction.py:49"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:124"),
}
# the bf16 instantiations replace the same TPU kernels, which take bf16 too
KERNEL_ROWS.update({f"{name}_bf16": KERNEL_ROWS[name] for name in (
    "dplr_corpus_score", "dplr_corpus_topk", "dplr_score_items", "dplr_corpus_score_multi",
    "embedding_bag", "fwfm_pairwise")})


# -- checks -----------------------------------------------------------------

def check_close(got, want, what: str, size=None) -> float:
    """Max |got - want|; raises unless every entry is within
    ``TOL * max(1, size)``, ``size`` being ``|want|`` unless given."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    got, want = got.double(), want.double()
    err = (got - want).abs()
    size = want.abs() if size is None else size.double()
    bad = err > TOL * torch.clamp(size, min=1.0)
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} of {err.numel()} values "
                             f"off, max |diff| {float(err.max()):.3g}")
    return float(err.max()) if err.numel() else 0.0


def check_topk(vals, ids, full, K: int, what: str, offset=0, stride=1,
               planted=(), size=None) -> tuple[float, int]:
    """Hold a top-K against the plain full scores ``full (Bq, n)``: values
    rank by rank, each returned id's plain score equal to its value (so ids
    differ from the plain stable top-K only between scores tied within the
    tolerance), ids unique, and each planted (lower, higher) pair of exact
    ties in order.  ``size (Bq, n)``, when given, scales the tolerance as in
    ``check_close``.  Returns (max |diff|, positions whose id differs)."""
    if vals.shape != (full.shape[0], K) or ids.shape != (full.shape[0], K):
        raise AssertionError(f"{what}: shapes {tuple(vals.shape)}, {tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        raise AssertionError(f"{what}: ids dtype {ids.dtype}")
    local = (ids.long() - offset) // stride
    if ((local * stride + offset) != ids.long()).any() or (local < 0).any() \
            or (local >= full.shape[1]).any():
        raise AssertionError(f"{what}: ids outside the relabeled slot range")
    ref_v, ref_i = ref.topk_stable(full, K)
    pick = (lambda idx: None) if size is None else (lambda idx: torch.gather(size, 1, idx))
    err = check_close(vals, ref_v, f"{what} values", pick(ref_i))
    err = max(err, check_close(vals, torch.gather(full, 1, local), f"{what} id scores",
                               pick(local)))
    srt = torch.sort(local, dim=1).values
    if (srt[:, 1:] == srt[:, :-1]).any():
        raise AssertionError(f"{what}: repeated ids")
    rows = local.cpu().numpy()
    for lo, hi in planted:
        for row in rows:
            where = {int(s): j for j, s in enumerate(row)}
            if hi in where and (lo not in where or where[lo] > where[hi]):
                raise AssertionError(f"{what}: tie of slots {lo} and {hi} broken "
                                     f"to the higher slot")
    return err, int((local != ref_i).sum())


def ranked(scores):
    """``scores (Bq, n)`` in the top-K order, all n: ``ref.topk_stable``
    (a stable descending sort, ties to the lower slot)."""
    return ref.topk_stable(scores, scores.shape[1])


def check_exact(vals, ids, scores, K: int, what: str, offset=0, stride=1) -> None:
    """C1: a top-K bitwise equal to ``ref.topk_stable(scores, K)`` with its
    positions relabeled ``offset + stride * slot``, ``scores`` being kernel
    1's ``(Bq, n)`` scores of the same inputs (dead slots included), or
    ``ranked(scores)`` of them.  Values are compared by their bits, so a
    value one ulp off, a pair of tied slots swapped or a dead slot above a
    live one fails."""
    want_v, want_i = scores if isinstance(scores, tuple) else ranked(scores)
    want_v = want_v[:, :K].contiguous()
    want_i = (offset + stride * want_i[:, :K]).to(torch.int32)
    if vals.shape != want_v.shape or ids.shape != want_i.shape:
        raise AssertionError(f"{what}: C1 shapes {tuple(vals.shape)}, {tuple(ids.shape)}, "
                             f"want {tuple(want_v.shape)}")
    if vals.dtype != torch.float32 or ids.dtype != torch.int32:
        raise AssertionError(f"{what}: C1 dtypes {vals.dtype}, {ids.dtype}")
    bad = (vals.contiguous().view(torch.int32) != want_v.view(torch.int32)) | (ids != want_i)
    if bad.any():
        r, c = (int(x) for x in bad.nonzero()[0])
        raise AssertionError(
            f"{what}: C1 {int(bad.sum())} of {bad.numel()} entries differ from kernel 1's "
            f"scores sorted; first at row {r} rank {c}: {float(vals[r, c])!r} id "
            f"{int(ids[r, c])}, want {float(want_v[r, c])!r} id {int(want_i[r, c])}")


# -- phase 3: kernels against plain -------------------------------------------

def corpus_inputs(dev, n, live, Bq, rho, k, gen):
    Q = torch.randn((n, rho, k), generator=gen, device=dev) * 0.5
    a_I = torch.randn((n,), generator=gen, device=dev)
    e = torch.rand((rho,), generator=gen, device=dev) + 0.5
    P_C = torch.randn((Bq, rho, k), generator=gen, device=dev) * 0.5
    a_C = torch.randn((Bq,), generator=gen, device=dev)
    valid = torch.arange(n, device=dev) < live
    return Q, a_I, e, P_C, a_C, valid


def plant(Q, a_I, valid, n_pairs=8):
    """Copy n_pairs rows, lifted far above the rest, to higher slots: exact
    ties that land in every top-K.  A lifted dead row must never appear."""
    live = int(valid.sum())
    pairs = [(97 * j + 5, live // 2 + 131 * j) for j in range(n_pairs)]
    for j, (lo, hi) in enumerate(pairs):
        a_I[lo] += 1000.0 + j
        Q[hi], a_I[hi] = Q[lo], a_I[lo]
    a_I[3] += 5000.0
    valid[3] = False
    # a whole 16384-slot chunk (and all of its 128-slot tiles) dead
    valid[2 * 16384:3 * 16384] = False
    return pairs


def adversarial(case: str, Q, a_I, valid, K: int, gen):
    """Inputs of adversarial order ``case`` built from (Q, a_I, valid):
    "rising" (a_I[i] += 1e-3 i, so the score grows with the slot),
    "falling" (a_I[i] -= 1e-3 i), "equal" (one Q_I row and one a_I value
    in every slot: the top-K is the first K live slots) or "few" (K // 2
    live slots at random places: the top-K ends with the first dead slots
    in ascending order).  Returns (Q, a_I, valid)."""
    n = Q.shape[0]
    ramp = 1e-3 * torch.arange(n, device=Q.device, dtype=torch.float32)
    if case == "rising":
        return Q, a_I + ramp, valid
    if case == "falling":
        return Q, a_I - ramp, valid
    if case == "equal":
        return Q[:1].expand_as(Q).contiguous(), a_I[:1].expand(n).contiguous(), valid
    few = torch.zeros_like(valid)
    few[torch.randperm(n, generator=gen, device=Q.device)[:K // 2]] = True
    return Q, a_I, few


def topk_exact(args, K: int, what: str, scores, **relabel):
    """One top-K call held by C1 against kernel 1's ``scores`` (or their
    ``ranked`` form).  Returns (vals, ids)."""
    vals, ids = ops.dplr_corpus_score(*args, topk=K, **relabel)
    _sync(vals.device)
    check_exact(vals, ids, scores, K, what, relabel.get("index_offset", 0),
                relabel.get("index_stride", 1))
    return vals, ids


def corpus_checks(dev, sz, gen, errs: dict, notes: list) -> None:
    """Kernels 1 and 2 against their plain versions, and every top-K call
    also by C1 against kernel 1's scores: at every (Bq, K) of ``sz.ks`` and
    ``sz.big_ks``, relabeled, at the n = ``edge_n`` edge, in the
    adversarial orders (``sz.adv``: n, live, Bq and Ks) and at K = n
    (``sz.large``: n, Bq)."""
    bq_max = max(sz.bqs)
    Q, a_I, e, P_C, a_C, valid = corpus_inputs(dev, sz.n, sz.live, bq_max, sz.rho, sz.k, gen)
    pairs = plant(Q, a_I, valid)
    for Bq in sz.bqs:
        args = (Q, a_I, e, P_C[:Bq].contiguous(), a_C[:Bq].contiguous(), valid)
        full = ref.dplr_corpus_score_ref(*args)
        got = ops.dplr_corpus_score(*args)
        _sync(dev)
        errs["dplr_corpus_score"] = max(errs["dplr_corpus_score"],
                                        check_close(got, full, f"full Bq={Bq}"))
        order = ranked(got)
        for K in sz.ks + sz.big_ks:
            vals, ids = topk_exact(args, K, f"topk Bq={Bq} K={K}", order)
            err, diff = check_topk(vals, ids, full, K, f"topk Bq={Bq} K={K}", planted=pairs)
            errs["dplr_corpus_topk"] = max(errs["dplr_corpus_topk"], err)
            notes.append(f"K={K}/Bq={Bq}:{diff} ids differ")
        vals, ids = topk_exact(args, 16, f"topk Bq={Bq} offset/stride", order,
                               index_offset=3, index_stride=4)
        err, _ = check_topk(vals, ids, full, 16, f"topk Bq={Bq} offset/stride",
                            offset=3, stride=4, planted=pairs)
        errs["dplr_corpus_topk"] = max(errs["dplr_corpus_topk"], err)
        del full, got, order
    del Q

    # adversarial orders at the serving shape, held by C1 alone (their own
    # generator, so that the other kernels' inputs stay what they were)
    gen_adv = torch.Generator(device=dev).manual_seed(5)
    n_adv, live_adv, bq_adv, ks_adv = sz.adv
    Q, a_I, e, P_C, a_C, valid = corpus_inputs(dev, n_adv, live_adv, bq_adv, sz.rho, sz.k,
                                               gen_adv)
    base, pcs = (Q, a_I, valid), (P_C, a_C)
    for case in ("rising", "falling", "equal", "few"):
        for K in ks_adv:
            if case == "few" or K == ks_adv[0]:
                Qc, ac, vc = adversarial(case, *base, K, gen_adv)
                args = (Qc, ac, e, *pcs, vc)
                order = ranked(ops.dplr_corpus_score(*args))
            vals, ids = topk_exact(args, K, f"topk {case} n={n_adv} Bq={bq_adv} K={K}", order)
            if case == "equal" and not torch.equal(
                    ids, torch.arange(K, device=dev, dtype=torch.int32).expand_as(ids)):
                raise AssertionError(f"topk equal K={K}: not the first K live slots")
            if case == "few":
                dead = (~vc).nonzero()[:K - K // 2, 0].to(torch.int32)
                if not torch.equal(ids[:, K // 2:], dead.expand(bq_adv, -1)):
                    raise AssertionError(f"topk few K={K}: not the first dead slots, ascending")
        del Qc, ac, vc, args, order
    notes.append(f"C1 (bitwise = kernel 1 sorted) at every K, relabeled, and adversarial "
                 f"rising/falling/equal/few at n={n_adv} Bq={bq_adv} K={list(ks_adv)}")
    del Q, base

    # edge: n = 1000 (ragged last tile), one 128-slot tile all dead
    Q, a_I, e, P_C, a_C, valid = corpus_inputs(dev, sz.edge_n, sz.edge_n, 3, sz.rho, sz.k, gen)
    valid[128:256] = False
    args = (Q, a_I, e, P_C, a_C, valid)
    full = ref.dplr_corpus_score_ref(*args)
    got = ops.dplr_corpus_score(*args)
    errs["dplr_corpus_score"] = max(errs["dplr_corpus_score"], check_close(
        got, full, "full edge"))
    vals, ids = topk_exact(args, 7, "topk edge", got)
    errs["dplr_corpus_topk"] = max(errs["dplr_corpus_topk"],
                                   check_topk(vals, ids, full, 7, "topk edge")[0])

    if sz.large is not None:                      # K = n, dead slots last
        n_l, bq_l = sz.large
        Q, a_I, e, P_C, a_C, valid = corpus_inputs(dev, n_l, n_l * 6 // 7, bq_l, sz.rho,
                                                   sz.k, gen_adv)
        args = (Q, a_I, e, P_C, a_C, valid)
        vals, ids = topk_exact(args, n_l, f"topk K=n={n_l} Bq={bq_l}",
                               ops.dplr_corpus_score(*args))
        errs["dplr_corpus_topk"] = max(errs["dplr_corpus_topk"], check_topk(
            vals, ids, ref.dplr_corpus_score_ref(*args), n_l, "topk K=n")[0])
        notes.append(f"K=n={n_l} Bq={bq_l}")


# kernel 1's edge shapes (n, Bq, rho, k): one slot; a 256-row tile - 1 and
# + 1; 3 tiles + 5; one, two and three query groups; rho k = 3 (12-byte
# rows: element copies, rows read an element at a time); rho k = 128 (fewer
# rows a stage) at groups of 2 and 16; k = 12 (wide rows in f32, not in
# bf16); and a served-width slab with dead tiles, misaligned copies of it
# and acc_dtype='bfloat16'
FULL_EDGES = ((1, 1, 3, 16), (255, 3, 3, 16), (257, 5, 3, 16), (773, 16, 3, 16),
              (3000, 17, 3, 16), (3000, 33, 3, 16), (1000, 4, 1, 3), (1000, 2, 4, 32),
              (1000, 16, 8, 16), (2000, 5, 3, 12), (5000, 16, 3, 16))


def full_edge_inputs(dev, n, Bq, rho, k, gen):
    """``corpus_inputs`` with every 10th slot dead (from slot 5), and for n
    past two 256-slot tiles a whole tile dead (slots 256-511) and a dead
    span across a tile boundary (1000-1299)."""
    args = list(corpus_inputs(dev, n, n, Bq, rho, k, gen))
    valid = args[5]
    valid[5::10] = False
    if n > 512:
        valid[256:512] = False
        valid[1000:1300] = False
    return tuple(args)


def off_by(t, elems: int):
    """A copy of ``t`` starting ``elems`` elements past a 16-byte boundary."""
    flat = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    return flat[elems:].view(t.shape).copy_(t)


def full_checks(dev, sz, errs: dict, notes: list) -> None:
    """Kernel 1 at its edges (``FULL_EDGES``): every float32 call within
    ``check_close`` of its plain version and each dead slot exactly
    ``NEG_INF``; every bf16-slab call bitwise the float32 call on the upcast
    slab (``acc_dtype='bfloat16'`` too, and within one bf16 rounding of the
    term of its plain version); the served-width slab also 4 bytes (f32)
    and 2 bytes (bf16) past a 16-byte boundary, bitwise the aligned call;
    at two ragged edges, every run of ``sz.full_runs`` at every query group
    bitwise the default geometry.  Then C1 turned around at ``sz.full_c1``
    (n, Bq): kernel 2 at K = n, each row bitwise kernel 1's scores sorted,
    f32 and bf16.  Its own generator."""
    gen = torch.Generator(device=dev).manual_seed(21)
    seen = []
    for n, Bq, rho, k in FULL_EDGES:
        Q, a_I, e, P_C, a_C, valid = full_edge_inputs(dev, n, Bq, rho, k, gen)
        args = (Q, a_I, e, P_C, a_C, valid)
        what = f"full n={n} Bq={Bq} rho={rho} k={k}"
        got = ops.dplr_corpus_score(*args)
        _sync(dev)
        errs["dplr_corpus_score"] = max(errs["dplr_corpus_score"], check_close(
            got, ref.dplr_corpus_score_ref(*args), what))
        if not (got[:, ~valid] == NEG_INF).all():
            raise AssertionError(f"{what}: a dead slot's score is not {NEG_INF}")
        b16 = (*to_bf16(Q, a_I), e, P_C, a_C, valid)
        up = (b16[0].float(), b16[1].float(), *args[2:])
        got16 = ops.dplr_corpus_score(*b16)
        same_bits(got16, ops.dplr_corpus_score(*up), f"bf16 {what}")
        errs["dplr_corpus_score_bf16"] = max(errs["dplr_corpus_score_bf16"], check_close(
            got16, ref.dplr_corpus_score_ref(*b16), f"bf16 {what}"))
        if n in (773, 3000) and Bq in (16, 33):       # every geometry at two edges
            for dtype_args, want in ((args, got), (b16, got16)):
                for run in sz.full_runs:
                    for G in blocks.GROUPS[:blocks.GROUPS.index(blocks.group_size(Bq)) + 1]:
                        same_bits(ops._corpus_score(*dtype_args, None, 0, 1,
                                                    blocks.Tile(run, group=G)),
                                  want, f"{what} {dtype_args[0].dtype} run={run} group={G}",
                                  "the default geometry's call")
            blocks.drain_clamp_events()
        if n == 5000:                                 # misaligned slabs; bf16 accumulation
            same_bits(ops.dplr_corpus_score(off_by(Q, 1), *args[1:]), got,
                      f"{what} 4 bytes off", "the aligned call")
            same_bits(ops.dplr_corpus_score(off_by(b16[0], 1), *b16[1:]), got16,
                      f"bf16 {what} 2 bytes off", "the aligned call")
            for slab, inputs in (("bf16", b16), ("f32", up)):
                acc = ops.dplr_corpus_score(*inputs, acc_dtype="bfloat16")
                if slab == "bf16":
                    same_bits(acc, ops.dplr_corpus_score(*up, acc_dtype="bfloat16"),
                              f"{what} acc_dtype='bfloat16' bf16 slab")
                want = ref.dplr_corpus_score_ref(*inputs, acc_dtype="bfloat16")
                P = P_C[:, None] + inputs[0].float()[None]
                term = torch.einsum("qnrk,r->qn", P * P, e.abs())
                size = a_C.abs()[:, None] + inputs[1].float().abs()[None] + 0.5 * term
                bound = BF16_ACC_ULP * term + TOL * torch.clamp(size, min=1.0)
                if not (((acc - want).abs() <= bound) | ~valid[None]).all() or not (
                        acc[:, ~valid] == NEG_INF).all():
                    raise AssertionError(f"{what} acc_dtype='bfloat16' on a {slab} slab: past "
                                         f"{BF16_ACC_ULP:g} x term + {TOL:g} x max(1, size)")
        seen.append(f"{n}x{Bq}/{rho}x{k}")
    n, Bq = sz.full_c1
    Q, a_I, e, P_C, a_C, valid = full_edge_inputs(dev, n, Bq, 3, 16, gen)
    for dtype in (torch.float32, torch.bfloat16):
        args = (Q.to(dtype), a_I.to(dtype), e, P_C, a_C, valid)
        scores = ops.dplr_corpus_score(*args)
        vals, ids = ops.dplr_corpus_score(*args, topk=n)
        _sync(dev)
        check_exact(vals, ids, scores, n, f"kernel 2 at K=n={n} Bq={Bq} {dtype}")
    notes.append(f"kernel 1 edges {', '.join(seen)} (n x Bq / rho x k): within the f32 rule of "
                 f"plain, bf16 slabs bitwise the upcast f32 call, 2 and 4 bytes off bitwise, "
                 f"acc_dtype='bfloat16' bitwise across slab types; runs {list(sz.full_runs)} "
                 f"at every group bitwise the default; kernel 2 at K=n={n} Bq={Bq} bitwise "
                 f"kernel 1 sorted, f32 and bf16")


def kernel_checks(dev, sz) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {name: 0.0 for name in ops.KERNELS}
    notes = []
    corpus_checks(dev, sz, gen, errs, notes)
    full_checks(dev, sz, errs, notes)

    for n3, Bq in [(sz.n3, b) for b in sz.bq3s] + [(sz.edge_n, 2)]:
        args = items_inputs(n3, Bq, sz.m3, sz.rho, sz.k, gen)
        errs["dplr_score_items"] = max(errs["dplr_score_items"],
                                       items_check(args, f"n={n3} Bq={Bq}"))
    errs["dplr_score_items"], more = items_edge_checks(dev, sz, errs["dplr_score_items"])
    notes += more
    errs["dplr_corpus_score_multi"], more = multi_checks(dev, sz, gen)
    notes += more
    errs["embedding_bag"], more = bag_checks(dev, sz, gen)
    notes += more
    errs["embedding_bag_backward"], errs["bag_rows_sort"], more = bag_backward_checks(dev, sz)
    notes += more
    errs["fwfm_pairwise"], more = pair_checks(dev, sz, gen)
    notes += more
    errs["flash_attention"], more = flash_checks(dev, sz, gen)
    notes += more
    bf16_corpus_checks(dev, sz, errs, notes)
    bf16_multi_checks(dev, sz, errs, notes)
    bf16_items_checks(dev, sz, errs, notes)
    bf16_bag_checks(dev, sz, errs, notes)
    bf16_pair_checks(dev, sz, errs, notes)
    print(f"phase kernels: all within {TOL:g} x max(1, |s|) (embedding_bag: bitwise on "
          f"one-hot layouts, 1e-6 x sum |w row| on multi-hot, in bf16 2^-7 (m - 1) "
          f"sum |w row| for a bag of m slots; flash_attention: "
          f"{FLASH_TOL[torch.float32]:g} max|v| in f32, 2^-7 max|v| and per element "
          f"2^-7 (|o| + sum p|v|/l) + 1e-5 max|v| in bf16; kernels 1-4 and 6 on bf16 "
          f"inputs bitwise their f32 launch on the upcast inputs, acc_dtype='bfloat16' within "
          f"{BF16_ACC_ULP:g} x term + {TOL:g} x max(1, size)); max |diff| "
          + ", ".join(f"{k}={v:.3g}" for k, v in errs.items())
          + "; " + ", ".join(notes), flush=True)
    return errs


def items_inputs(n, Bq, mI, rho, k, gen, misaligned=False):
    """Inputs of one ``dplr_score_items`` call: V_I (Bq, n, m_I, k), U_I,
    e, d_I, P_C, s_C; ``misaligned`` puts V_I one float past a 16-byte
    boundary."""
    dev = gen.device
    shape = (Bq, n, mI, k)
    V = torch.randn(math.prod(shape) + misaligned, generator=gen, device=dev)
    V = V[int(misaligned):].view(shape).mul_(0.25)
    U = torch.randn((rho, mI), generator=gen, device=dev) * 0.2
    e3 = torch.rand((rho,), generator=gen, device=dev) + 0.5
    d = -torch.rand((mI,), generator=gen, device=dev)
    PC = torch.randn((Bq, rho, k), generator=gen, device=dev)
    sC = torch.randn((Bq,), generator=gen, device=dev)
    return V, U, e3, d, PC, sC


def check_same(got, want, what: str) -> None:
    """On the card, ``got`` bitwise equal to ``want`` (the kernels' values do
    not depend on the batch); on the CPU, whose plain versions promise no
    such thing, within ``check_close``."""
    if not got.is_cuda:
        check_close(got, want, what)
    elif not torch.equal(got, want):
        raise AssertionError(f"{what}: not bitwise equal, max |diff| "
                             f"{float((got - want).abs().max()):.3g}")


def items_size(args):
    """The summed magnitude of a kernel-3 score's terms, ``0.5 (|s_C| +
    sum_m |d_m| |v_m|^2 + sum_r |e_r| |P_r|^2)``."""
    V, U, e3, d, PC, sC = args
    return ref.dplr_score_items_ref(V, U, e3.abs(), d.abs(), PC, sC.abs())


def items_check(args, what: str, rows=None, scaled: bool = False) -> float:
    """Kernel 3 against its plain version within ``check_close`` (with
    ``scaled``, within ``TOL * max(1, size)``, ``items_size``), and each
    row of the batched call (``rows``: those of these query indices, else
    all) equal to the per-query call (``check_same``).  Returns max |diff|."""
    V, U, e3, d, PC, sC = args
    want = ref.dplr_score_items_ref(*args)
    got = ops.dplr_score_items(*args)
    _sync(V.device)
    err = check_close(got, want, f"score_items {what}", items_size(args) if scaled else None)
    for q in range(V.shape[0]) if rows is None else rows:
        one = ops.dplr_score_items(V[q], U, e3, d, PC[q], sC[q])
        _sync(V.device)
        check_same(got[q], one, f"score_items {what}: row {q} of the batched call against "
                                f"the per-query call")
    return err


def items_tile(dev, mI: int, rho: int, k: int) -> int:
    """Items a tile of kernel 3 holds, as its library reports; 1 on the
    CPU, whose plain version has no tiles."""
    return items_kernel.tile(mI, rho, k) if dev.type == "cuda" else 1


def items_witness(args) -> str:
    """How far kernel 3 and its f32 plain version each sit from the f64
    plain version, as max |diff| and as the largest share of
    ``check_close``'s ``TOL * max(1, |s|)`` it takes.  A record, not a check."""
    exact = ref.dplr_score_items_ref(*(a.double() for a in args))
    bound = TOL * torch.clamp(exact.abs(), min=1.0)
    parts = []
    for name, got in (("kernel", ops.dplr_score_items(*args)),
                      ("plain f32", ref.dplr_score_items_ref(*args))):
        err = (got.double() - exact).abs()
        parts.append(f"{name} {float(err.max()):.3g} ({float((err / bound).max()):.3f} of "
                     f"the bound)")
    return "against f64: " + ", ".join(parts)


def items_edge_checks(dev, sz, err: float) -> tuple[float, list]:
    """Kernel 3's edges, each within ``check_close`` and batched rows bitwise
    equal to per-query calls (their own generator, so that the later
    kernels' inputs stay as they were): n one below and one above a
    multiple of the tile, n = 1; rho k = 128 as (8, 16) and (2, 64), and
    rho k = 3; m_I k odd; a misaligned V_I; m_I = 200, whose items the
    kernel streams in two chunks of fields; and ``sz.items_many`` queries
    of n = 2 (three of their rows checked bitwise).  The rho k = 128 and
    m_I = 200 cases, whose scores are differences of terms up to ~100, are
    held within ``TOL * max(1, size)`` (``items_size``), the others within
    the fixed bound; they also report their distance from an f64 plain
    version (``items_witness``)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    tile = items_tile(dev, sz.m3, sz.rho, sz.k)
    cases = [(tile * sz.items_tiles - 1, 2, sz.m3, sz.rho, sz.k, False),
             (tile * sz.items_tiles + 1, 2, sz.m3, sz.rho, sz.k, False),
             (1, 3, sz.m3, sz.rho, sz.k, False),
             (sz.edge_n, 2, sz.m3, 8, 16, False), (sz.edge_n, 2, sz.m3, 2, 64, False),
             (sz.edge_n, 2, sz.m3, 1, 3, False), (sz.edge_n, 2, 13, sz.rho, 3, False),
             (sz.edge_n, 3, sz.m3, sz.rho, sz.k, True), (sz.edge_n, 2, 200, sz.rho, sz.k, False)]
    notes = []
    for n, Bq, mI, rho, k, mis in cases:
        what = f"n={n} m_I={mI} k={k} rho={rho} Bq={Bq}" + (" misaligned" if mis else "")
        args = items_inputs(n, Bq, mI, rho, k, gen, mis)
        large = rho * k == 128 or mI == 200
        err = max(err, items_check(args, what, scaled=large))
        notes.append(what + (f" ({items_witness(args)})" if large else ""))
    Bq = sz.items_many
    err = max(err, items_check(items_inputs(2, Bq, sz.m3, sz.rho, sz.k, gen),
                               f"n=2 Bq={Bq}", rows=(0, Bq // 2, Bq - 1)))
    notes.append(f"n=2 m_I={sz.m3} Bq={Bq}")
    return err, ["dplr_score_items (batched rows bitwise = per query) n=" + str(sz.n3)
                 + f" Bq={list(sz.bq3s)}, n={sz.edge_n} Bq=2, " + ", ".join(notes)]


def multi_inputs(dev, ns, lives, Bq, rho, k, gen):
    """Per-segment corpus inputs, stacked where the multi-tenant entry
    stacks them: (Q_parts, a_parts, valid_parts, e, P_C, a_C)."""
    parts = [corpus_inputs(dev, n, live, Bq, rho, k, gen) for n, live in zip(ns, lives)]
    return ([list(p) for p in parts],
            (tuple(p[0] for p in parts), tuple(p[1] for p in parts),
             tuple(p[5] for p in parts), *(torch.stack([p[j] for p in parts])
                                           for j in (2, 3, 4))))


def multi_checks(dev, sz, gen) -> tuple[float, list]:
    """The multi-tenant kernel against its plain version, segment by
    segment, and row [s] bitwise against the single-tenant top-K kernel on
    segment s: S equal segments with planted ties, then a ragged masked
    case whose K exceeds one segment's live slots."""
    S, Bq, n_s, K = sz.multi
    ns, Bq2, K2 = sz.ragged
    err, notes = 0.0, []
    for case, (ns_, Bq_, K_) in (("equal", ((n_s,) * S, Bq, K)), ("ragged", (ns, Bq2, K2))):
        parts, args = multi_inputs(dev, ns_, ns_, Bq_, sz.rho, sz.k, gen)
        planted = []
        for s, p in enumerate(parts):
            if case == "equal":
                planted.append(plant(p[0], p[1], p[5]))
            else:                                  # random dead slots
                p[5].copy_(torch.rand(ns_[s], generator=gen, device=dev) > (0.6 if s == 0
                                                                            else 0.25))
        if case == "ragged" and not int(parts[0][5].sum()) < K_ <= min(ns_):
            raise AssertionError("ragged case: K must exceed segment 0's live slots")
        vals, ids = ops.dplr_corpus_score_multi(*args, topk=K_)
        _sync(dev)
        diffs = 0
        for s, p in enumerate(parts):
            full = ref.dplr_corpus_score_ref(*p)
            e_, d = check_topk(vals[s], ids[s], full, K_, f"multi {case} segment {s}",
                               planted=planted[s] if planted else ())
            err, diffs = max(err, e_), diffs + d
            check_exact(vals[s], ids[s], ops.dplr_corpus_score(*p), K_,
                        f"multi {case} segment {s}")
            one_v, one_i = ops.dplr_corpus_score(*p, topk=K_)
            if not (torch.equal(vals[s], one_v) and torch.equal(ids[s], one_i)):
                raise AssertionError(f"multi {case} segment {s}: row differs from the "
                                     f"single-tenant kernel")
        notes.append(f"multi {case} S={len(ns_)} Bq={Bq_} K={K_}: rows bitwise = single, "
                     f"{diffs} ids differ from plain")
        del parts, args, full
    # adversarial orders, every row held by C1 against kernel 1 on its segment
    # (their own generator, so that the later kernels' inputs stay as they were)
    gen_adv = torch.Generator(device=dev).manual_seed(6)
    for case in ("rising", "equal"):
        parts, _ = multi_inputs(dev, (n_s,) * S, (n_s,) * S, Bq, sz.rho, sz.k, gen_adv)
        parts = [[*adversarial(case, p[0], p[1], p[5], K, gen_adv)[:2], *p[2:]]
                 for p in parts]
        args = (tuple(p[0] for p in parts), tuple(p[1] for p in parts),
                tuple(p[5] for p in parts),
                *(torch.stack([p[j] for p in parts]) for j in (2, 3, 4)))
        vals, ids = ops.dplr_corpus_score_multi(*args, topk=K)
        _sync(dev)
        for s, p in enumerate(parts):
            check_exact(vals[s], ids[s], ops.dplr_corpus_score(*p), K,
                        f"multi {case} segment {s}")
        del parts, args
    notes.append(f"multi rows by C1, also rising and equal at S={S} Bq={Bq} K={K}")
    return err, notes


def bag_case(layout: FeatureLayout, kind, B: int, gen, skew: bool = False):
    """Inputs of one ``embedding_bag`` call on the lookup path for ``kind``
    fields of ``layout`` (None: all): (B, n_slots) int32 arena-global ids,
    each slot uniform over its field's rows (with ``skew``, the local id is
    ``vocab * u^6``: about a third of a 1,000-row field's slots name its
    first row, as Zipf traffic repeats its head), weights in [0.5, 1.5),
    and the slot -> field map on the device (``ops.bag_map``)."""
    dev = gen.device
    slots = np.arange(layout.n_slots) if kind is None else layout.slots_of(kind)
    fields = layout.slot_to_field[slots]
    vocab = torch.as_tensor(np.array([f.vocab_size for f in layout.fields])[fields],
                            device=dev)
    base = torch.as_tensor(layout.field_offsets[fields].astype(np.int64), device=dev)
    u = torch.rand((B, len(slots)), generator=gen, device=dev)
    local = ((u ** 6 if skew else u) * vocab).long()
    ids = (base + torch.minimum(local, vocab - 1)).to(torch.int32)
    w = torch.rand((B, len(slots)), generator=gen, device=dev) + 0.5
    sub = layout if kind is None else layout.subset(kind)
    return ids, w, ops.bag_map(sub.slot_to_field, sub.n_fields, dev)


def multi_hot(layout: FeatureLayout) -> FeatureLayout:
    """``layout`` with field i holding 1 + i % 4 slots (bags of 1-4 slots),
    as ``tiered_layout(..., multi_hot=)`` gives them."""
    return FeatureLayout(tuple(dataclasses.replace(f, multiplicity=1 + i % 4)
                               for i, f in enumerate(layout.fields)))


def bag_checks(dev, sz, gen) -> tuple[float, list]:
    """The embedding-bag kernel against its plain version on the full
    arena: the context lookup (Bq rows of the context slots), the slab
    build (item slots), pointwise rows, a ragged B and a multi-hot layout.
    One-hot layouts must match bitwise; an id outside the table must raise
    in the plain version and poison its bag (NaN) in the kernel."""
    cfg = sz.make_config()
    lay, k = cfg.layout, cfg.embed_dim
    table = torch.randn((padded_rows(lay.total_vocab), k), generator=gen, device=dev) / k**0.5
    Bq, items, rows_ = sz.bag_rows
    cases = (("context", lay, "context", Bq), ("corpus", lay, "item", items),
             ("pointwise", lay, None, rows_), ("ragged", lay, None, sz.bag_ragged),
             ("multi-hot", multi_hot(lay), None, rows_))
    err, notes = 0.0, []
    for name, layout, kind, B in cases:
        ids, w, bags = bag_case(layout, kind, B, gen)
        seg, nb = bags.segments, bags.n_bags
        got = ops.embedding_bag(table, ids, w, bags)
        want = ref.embedding_bag_ref(table, ids, w, seg, nb)
        _sync(dev)
        what = f"embedding_bag {name} B={B} slots={ids.shape[1]}"
        if layout.n_slots == layout.n_fields:
            if not torch.equal(got, want):
                raise AssertionError(f"{what}: not bitwise equal to the plain version")
        else:
            size = ref.embedding_bag_ref(table.abs(), ids, w, seg, nb)
            bad = (got - want).abs() > 1e-6 * size
            if bad.any() or not torch.isfinite(got).all():
                raise AssertionError(f"{what}: {int(bad.sum())} values off")
        err = max(err, float((got - want).abs().max()))
        notes.append(f"{name} {tuple(ids.shape)}")
        del got, want
    ids[1, 2] = table.shape[0]                         # past the last row
    if dev.type == "cuda":
        got = ops.embedding_bag(table, ids, w, bags)
        bag = int(seg[2])
        if not (got[1, bag].isnan().all() and torch.isfinite(got[0]).all()
                and int(got.isnan().sum()) == k):
            raise AssertionError("embedding_bag: an id past the table did not poison "
                                 "exactly its bag")
    try:
        ref.embedding_bag_ref(table, ids, w, seg, nb)
    except IndexError:
        pass
    else:
        raise AssertionError("embedding_bag plain version: an id past the table passed")
    return err, ["embedding_bag " + ", ".join(notes) + ": one-hot bitwise, an id past "
                 "the table poisons its bag"]


def poisoned(dev, shape) -> tuple[int, int] | None:
    """Free a NaN-filled f32 tensor of ``shape``: the caching allocator
    hands its block to the next ``torch.empty`` of that size, which the
    backward makes first.  Its address range (None on the CPU)."""
    if dev.type != "cuda":
        return None
    block = torch.full(shape, float("nan"), device=dev)
    span = (block.data_ptr(), block.data_ptr() + block.numel() * 4)
    del block
    return span


def check_poisoned(t, span, what: str) -> None:
    """Raise unless ``t`` lies inside ``poisoned``'s range ``span``."""
    if span is not None and not (
            span[0] <= t.data_ptr() and t.data_ptr() + t.numel() * t.element_size() <= span[1]):
        raise AssertionError(f"{what}: the output was not allocated in the NaN-filled block")


def bag_backward_checks(dev, sz) -> tuple[float, float, list]:
    """The embedding bag's backward (the table's gradient: the slots' radix
    sort, then the writer) against ``ref.embedding_bag_vjp`` on the full
    arena at the train phase's batch, within ``1e-6 * sum |w g|`` per
    element, every row no slot names exactly 0, and bitwise equal to itself
    on a second call: skewed ids on the one-hot and the multi-hot layout,
    and every example naming one row a field.  Each call's output lands in
    a freed NaN-filled block (checked by its address), so a row the writer
    missed shows.  Then the sort alone on the one-hot case's skewed keys,
    bitwise ``torch.sort(stable=True)``.  Their own generator, so that the
    later kernels' inputs stay as they were.  Returns the backward's max
    |diff|, the sort's (0: bitwise) and notes."""
    gen = torch.Generator(device=dev).manual_seed(9)
    cfg = sz.make_config()
    lay, k, B = cfg.layout, cfg.embed_dim, sz.train_batch
    table = torch.randn((padded_rows(lay.total_vocab), k), generator=gen, device=dev) / k**0.5
    rows_ = table.shape[0]
    err, notes = 0.0, []
    for name, layout, same in (("one-hot", lay, False), ("multi-hot", multi_hot(lay), False),
                               ("one row a field", lay, True)):
        ids, w, bags = bag_case(layout, None, B, gen, skew=True)
        if same:
            ids = ids[:1].expand_as(ids).contiguous()
        grad = torch.randn((B, bags.n_bags, k), generator=gen, device=dev)
        what = f"embedding_bag_backward {name} B={B} slots={ids.shape[1]}"
        span = poisoned(dev, table.shape)
        got = ops.embedding_bag_backward(grad, table, ids, w, bags)
        check_poisoned(got, span, what)
        span = poisoned(dev, table.shape)
        again = ops.embedding_bag_backward(grad, table, ids, w, bags)
        check_poisoned(again, span, what)
        want = ref.embedding_bag_vjp(table, ids, w, bags.segments, grad)[0]
        size = ref.embedding_bag_vjp(table, ids, w, bags.segments, grad.abs())[0]
        _sync(dev)
        diff = (got - want).abs()
        bad = diff > 1e-6 * size
        if bad.any() or not torch.isfinite(got).all():
            raise AssertionError(f"{what}: {int(bad.sum())} values off, max |diff| "
                                 f"{float(diff.max()):.3g}")
        named = torch.zeros(rows_, dtype=torch.bool, device=dev)
        named[ids.reshape(-1).long()] = True
        if (got[~named] != 0).any():
            raise AssertionError(f"{what}: a row no slot names is not 0")
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two calls on the same input differ")
        err = max(err, float(diff.max()))
        rows = int(named.sum())
        notes.append(f"{name} ({rows} rows named by {ids.numel()} slots)")
        if name == "one-hot":
            keys, perm = ops.bag_rows_sort(ids, rows_)
            want_keys, want_perm = torch.sort(ids.reshape(-1), stable=True)
            if not (torch.equal(keys, want_keys) and torch.equal(perm, want_perm)):
                raise AssertionError(f"bag_rows_sort {tuple(ids.shape)} skewed on {rows_} "
                                     f"rows: not bitwise torch.sort(stable=True)")
            del keys, perm, want_keys, want_perm
        del got, again, want, size, diff, bad, named
    return err, 0.0, [
        "embedding_bag_backward " + ", ".join(notes) + ": within 1e-6 x sum |w g|, unnamed "
        "rows exactly 0 in a NaN-filled allocation, bitwise on repeat; bag_rows_sort on the "
        "one-hot case's keys bitwise torch.sort(stable=True)"]


def pair_inputs(B: int, m: int, k: int, gen):
    """V (B, m, k) at embedding scale and a symmetric zero-diagonal R."""
    dev = gen.device
    V = torch.randn((B, m, k), generator=gen, device=dev) / k**0.5
    R = torch.randn((m, m), generator=gen, device=dev) * 0.1
    R = 0.5 * (R + R.T)
    return V, R - torch.diag(torch.diag(R))


def pair_size(V, R):
    """0.5 * sum_ij |R_ij G_ij|: the summed magnitude of the FwFM terms."""
    return 0.5 * torch.einsum("bij,ij->b", torch.einsum("bik,bjk->bij", V, V).abs(),
                              R.abs())


def pair_check(V, R, what: str) -> tuple[float, torch.Tensor]:
    """Kernel 6 against its plain version within ``TOL * max(1, 0.5 * sum
    |R_ij G_ij|)`` (ROADMAP's size-scaled rule).  Returns (max |diff|, the
    kernel's values)."""
    got = ops.fwfm_pairwise(V, R)
    _sync(V.device)
    return check_close(got, ref.fwfm_pairwise_ref(V, R), f"fwfm_pairwise {what}",
                       size=pair_size(V, R)), got


def pair_tile(dev, m: int, k: int) -> int:
    """Examples a tile of kernel 6 holds, as its library reports; 1 on the
    CPU, whose plain version has no tiles."""
    return pair_kernel.tile(m, k) if dev.type == "cuda" else 1


def pair_checks(dev, sz, gen) -> tuple[float, list]:
    """The FwFM pairwise kernel against its plain version (``pair_check``):
    at ``sz.pairs`` with a symmetric zero-diagonal R; then, on their own
    generator (so that the later kernels' inputs stay as they were), a
    general R (not symmetric, non-zero diagonal) and the matched-pruned R
    at the eval batch, a general R at the full batch (and a ragged slice of
    it bitwise equal to the full call's rows), every m in (1, 2, 128) with
    every k in (1, 3, 32), B one below and one above a multiple of the
    kernel's tile, and a V one float past a 16-byte boundary."""
    err, notes = 0.0, []
    for B, m in sz.pairs:
        V, R = pair_inputs(B, m, sz.k, gen)
        err = max(err, pair_check(V, R, f"B={B} m={m}")[0])
        notes.append(f"B={B} m={m}")
        del V
    gen = torch.Generator(device=dev).manual_seed(8)
    (b_eval, m), (b_full, _) = sz.pairs[:2]
    V, R = pair_inputs(b_eval, m, sz.k, gen)
    general = torch.randn((m, m), generator=gen, device=dev) * 0.1
    pruned = R * prune_matched(R, m, sz.rho).mask.to(R)
    for name, R_ in (("general", general), ("pruned", pruned)):
        err = max(err, pair_check(V, R_, f"B={b_eval} m={m} {name} R")[0])
        notes.append(f"B={b_eval} m={m} {name} R")
    V = pair_inputs(b_full, m, sz.k, gen)[0]
    e_, got = pair_check(V, general, f"B={b_full} m={m} general R")
    lo, hi = 12_345 % b_full, min(b_full, 12_345 % b_full + b_eval + 1)
    check_same(got[lo:hi], ops.fwfm_pairwise(V[lo:hi], general),
               f"fwfm_pairwise: the full call's rows {lo}:{hi} against those rows alone")
    err = max(err, e_)
    notes.append(f"B={b_full} m={m} general R, rows {lo}:{hi} alone bitwise")
    del V, got
    for m_ in (1, 2, 128):
        for k in (1, 3, 32):
            V = torch.randn((sz.pair_small_b, m_, k), generator=gen, device=dev) / k**0.5
            R_ = torch.randn((m_, m_), generator=gen, device=dev) * 0.1
            err = max(err, pair_check(V, R_, f"B={sz.pair_small_b} m={m_} k={k}")[0])
    notes.append(f"B={sz.pair_small_b} m in (1, 2, 128) x k in (1, 3, 32) general R")
    tile = pair_tile(dev, m, sz.k)
    for B in (tile * sz.pair_tiles - 1, tile * sz.pair_tiles + 1):
        V = pair_inputs(B, m, sz.k, gen)[0]
        err = max(err, pair_check(V, general, f"B={B} m={m} general R")[0])
        notes.append(f"B={B} m={m} (tile {tile})")
    flat = torch.randn(b_eval * m * sz.k + 1, generator=gen, device=dev) / sz.k**0.5
    V = flat[1:].view(b_eval, m, sz.k)
    err = max(err, pair_check(V, general, f"B={b_eval} m={m} misaligned")[0])
    notes.append(f"B={b_eval} m={m} misaligned")
    return err, ["fwfm_pairwise " + ", ".join(notes)]


FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}


def flash_inputs(B, S, H, KV, hd, dtype, gen):
    """q (B, S, H, hd), k and v (B, S, KV, hd), standard normal in ``dtype``."""
    return tuple(torch.randn((B, S, n, hd), generator=gen, device=gen.device).to(dtype)
                 for n in (H, KV, KV))


def flash_ratio(got, want, size, v) -> float:
    """Largest ``|got - want|`` over its bound: ``FLASH_TOL[dtype] * max|v|``
    and, in bf16, also per element ``2^-7 (|want| + size) + 1e-5 max|v|``
    (``size = sum_j p_ij |v_j| / l_i`` from the plain version): one output
    ulp, one ulp of each p, which both versions round once at maxima that
    may differ, and the f32 bound for the f32 arithmetic they share."""
    vmax = float(v.abs().max())
    diff = (got.float() - want.float()).abs()
    ratio = float(diff.max()) / (FLASH_TOL[got.dtype] * vmax)
    if got.dtype == torch.bfloat16:
        elem = 2.0**-7 * (want.float().abs() + size) + 1e-5 * vmax
        ratio = max(ratio, float((diff / elem).max()))
    return ratio


def flash_checks(dev, sz, gen) -> tuple[float, list]:
    """The flash-attention kernel against its plain version at gemma3-1b's
    global and windowed layers, at ragged small shapes and at the other
    LMs' heads (``sz.flash_heads``: starcoder2-7b's and yi-9b's hd 128, 9
    and 8 query heads a kv head; granite-moe-1b-a400m's hd 64, 2 a kv head;
    mixtral-8x7b's hd 128, 4 a kv head, windowed), in f32 and bf16, within ``flash_ratio``'s
    bounds (the gemma3 check's).  Returns the largest |diff| of
    the bf16 cases (the model's type) and notes."""
    err, notes = 0.0, []
    for B, S, H, KV, hd, window in sz.flash + sz.flash_small + sz.flash_heads:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(B, S, H, KV, hd, dtype, gen)
            got = ops.flash_attention(q, k, v, window=window)
            want, size = ref.flash_attention_plain(q, k, v, window=window, with_size=True)
            _sync(dev)
            e = float((got.float() - want.float()).abs().max())
            ratio = flash_ratio(got, want, size, v)
            what = f"{str(dtype)[6:]} {B}x{S}x{H}/{KV}x{hd} W={window}"
            if got.dtype != dtype or not torch.isfinite(got).all() or not ratio <= 1.0:
                raise AssertionError(f"flash_attention {what}: max |diff| {e:.3g}, "
                                     f"{ratio:.3f} of its bound")
            if dtype == torch.bfloat16:
                err = max(err, e)
            notes.append(f"{what}: {e:.3g} ({ratio:.3f} of its bound)")
            del q, k, v, got, want, size
    return err, ["flash_attention max |diff| " + ", ".join(notes)]


# -- phase 3, bf16: kernels 1-5 on a bf16 slab, V_I or table -----------------

# One rounding of the rank-space sum to bf16, relative: acc_dtype='bfloat16'
# rounds the sum of its exact products once, and two sums of them in other
# orders may round to neighbouring bf16 values, half a score's term apart.
BF16_ACC_ULP = 2.0**-8


def to_bf16(*tensors):
    return tuple(t.to(torch.bfloat16) for t in tensors)


def same_bits(got, want, what: str,
              against: str = "the float32 kernels' call on the upcast inputs") -> None:
    """``got`` bit for bit ``want`` (``against`` names it): float32 scores
    compared as int32 (so -0.0 differs from 0.0), ids as they are; tuples
    entry by entry."""
    if isinstance(got, tuple):
        for j, (g, w) in enumerate(zip(got, want)):
            same_bits(g, w, f"{what} [{j}]", against)
        return
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} against {want.dtype} "
                             f"{tuple(want.shape)}")
    view = (lambda t: t.contiguous().view(torch.int32)) if got.dtype == torch.float32 \
        else (lambda t: t)
    if not torch.equal(view(got), view(want)):
        raise AssertionError(f"{what}: not bitwise {against}")


def bf16_corpus_checks(dev, sz, errs: dict, notes: list) -> None:
    """Kernels 1 and 2 on a bf16 slab (``Q_I``, ``a_I``, and ``e``, ``P_C``,
    ``a_C`` in bf16 too, which the wrapper upcasts): every call bitwise the
    float32 kernels' call on the upcast tensors, every top-K by C1 against
    the bf16 kernel 1's scores, and against the plain version within
    ``check_close``: at the served shapes (``sz.n``, each Bq of ``sz.bqs``,
    each K of ``sz.ks`` and ``sz.big_ks``, planted ties and a dead chunk),
    the n = ``edge_n`` edge with a dead tile, and K = n (``sz.large``).  Then
    ``acc_dtype='bfloat16'`` on the bf16 slab and on its float32 copy,
    within ``BF16_ACC_ULP * term + TOL * max(1, size)`` of its plain version
    (``term``: sum_r |e_r| ||P_C + Q_I||^2), its top-K by C1.  Their own
    generator, so that the other kernels' inputs stay as they were."""
    gen = torch.Generator(device=dev).manual_seed(10)
    bq_max = max(sz.bqs)
    Q, a_I, e, P_C, a_C, valid = corpus_inputs(dev, sz.n, sz.live, bq_max, sz.rho, sz.k, gen)
    plant(Q, a_I, valid)
    Q16, a16, e16, P16, ac16 = to_bf16(Q, a_I, e, P_C, a_C)
    del Q, a_I
    Qu, au, eu, Pu, acu = (t.float() for t in (Q16, a16, e16, P16, ac16))
    for Bq in sz.bqs:
        b16 = (Q16, a16, e16, P16[:Bq], ac16[:Bq], valid)
        up = (Qu, au, eu, Pu[:Bq], acu[:Bq], valid)
        got = ops.dplr_corpus_score(*b16)
        _sync(dev)
        same_bits(got, ops.dplr_corpus_score(*up), f"bf16 full Bq={Bq}")
        full = ref.dplr_corpus_score_ref(*b16)
        errs["dplr_corpus_score_bf16"] = max(errs["dplr_corpus_score_bf16"],
                                             check_close(got, full, f"bf16 full Bq={Bq}"))
        order = ranked(got)
        for K in sz.ks + sz.big_ks:
            what = f"bf16 topk Bq={Bq} K={K}"
            vals, ids = topk_exact(b16, K, what, order, index_offset=3, index_stride=4)
            same_bits((vals, ids), ops.dplr_corpus_score(*up, topk=K, index_offset=3,
                                                         index_stride=4), what)
            errs["dplr_corpus_topk_bf16"] = max(errs["dplr_corpus_topk_bf16"], check_topk(
                vals, ids, full, K, what, offset=3, stride=4)[0])
        del got, full, order

    # acc_dtype='bfloat16' at Bq = bq_max, on the bf16 slab and its f32 copy
    P = Pu[:, None] + Qu[None]
    term = torch.einsum("qnrk,r->qn", P * P, eu.abs())
    del P
    size = acu.abs()[:, None] + au.abs()[None] + 0.5 * term
    bound = BF16_ACC_ULP * term + TOL * torch.clamp(size, min=1.0)
    del size, term
    worst = []
    for slab, args in (("bf16", (Q16, a16, e16, P16, ac16, valid)),
                       ("f32", (Qu, au, eu, Pu, acu, valid))):
        got = ops.dplr_corpus_score(*args, acc_dtype="bfloat16")
        want = ref.dplr_corpus_score_ref(*args, acc_dtype="bfloat16")
        _sync(dev)
        ratio = float(((got - want).abs() / bound).max())
        if not torch.isfinite(got).all() or ratio > 1.0:
            raise AssertionError(f"acc_dtype='bfloat16' on a {slab} slab: {ratio:.3f} of the "
                                 f"bound {BF16_ACC_ULP:g} x term + {TOL:g} x max(1, size)")
        order = ranked(got)
        for K in (16, 4097):
            topk_exact(args, K, f"acc bf16 {slab} slab topk K={K}", order, acc_dtype="bfloat16")
        worst.append(f"{slab} slab max |diff| {float((got - want).abs().max()):.3g} "
                     f"({ratio:.3f} of the bound)")
        del got, want, order
    del bound, Qu, Q16
    notes.append("bf16 slab: kernels 1-2 bitwise the f32 launch on the upcast inputs at "
                 f"Bq={list(sz.bqs)} K={list(sz.ks + sz.big_ks)} (C1 each); "
                 "acc_dtype='bfloat16' within one bf16 rounding of the term: "
                 + ", ".join(worst) + ", top-K by C1")

    # edge: n = edge_n (ragged last tile), one 128-slot tile all dead; K = n
    Q, a_I, e, P_C, a_C, valid = corpus_inputs(dev, sz.edge_n, sz.edge_n, 3, sz.rho, sz.k, gen)
    valid[128:256] = False
    b16 = (*to_bf16(Q, a_I, e, P_C, a_C), valid)
    up = tuple(t.float() if t.dtype == torch.bfloat16 else t for t in b16)
    got = ops.dplr_corpus_score(*b16)
    same_bits(got, ops.dplr_corpus_score(*up), "bf16 full edge")
    same_bits(topk_exact(b16, 7, "bf16 topk edge", got), ops.dplr_corpus_score(*up, topk=7),
              "bf16 topk edge")
    if sz.large is not None:
        n_l, bq_l = sz.large
        Q, a_I, e, P_C, a_C, valid = corpus_inputs(dev, n_l, n_l * 6 // 7, bq_l, sz.rho, sz.k,
                                                   gen)
        b16 = (*to_bf16(Q, a_I, e, P_C, a_C), valid)
        up = tuple(t.float() if t.dtype == torch.bfloat16 else t for t in b16)
        same_bits(topk_exact(b16, n_l, f"bf16 topk K=n={n_l}", ops.dplr_corpus_score(*b16)),
                  ops.dplr_corpus_score(*up, topk=n_l), f"bf16 topk K=n={n_l}")
    notes.append(f"bf16 edge n={sz.edge_n} (a dead tile) and K=n bitwise, by C1")


def bf16_multi_checks(dev, sz, errs: dict, notes: list) -> None:
    """Kernel 4 on bf16 slabs: bitwise its float32 launch on the upcast
    slabs, each row by C1 against the bf16 kernel 1 on its segment and
    against the plain version; S equal segments with planted ties, then the
    ragged masked case; with ``acc_dtype='bfloat16'`` (equal case) each row
    bitwise the single-segment kernel's."""
    S, Bq, n_s, K = sz.multi
    ns, Bq2, K2 = sz.ragged
    gen = torch.Generator(device=dev).manual_seed(11)
    stack = lambda ps: ((tuple(p[0] for p in ps), tuple(p[1] for p in ps),  # noqa: E731
                         tuple(p[5] for p in ps))
                        + tuple(torch.stack([p[j] for p in ps]) for j in (2, 3, 4)))
    for case, (ns_, Bq_, K_) in (("equal", ((n_s,) * S, Bq, K)), ("ragged", (ns, Bq2, K2))):
        parts, _ = multi_inputs(dev, ns_, ns_, Bq_, sz.rho, sz.k, gen)
        for s, p in enumerate(parts):
            if case == "equal":
                plant(p[0], p[1], p[5])
            else:
                p[5].copy_(torch.rand(ns_[s], generator=gen, device=dev) > (0.6 if s == 0
                                                                            else 0.25))
        p16 = [(*to_bf16(*p[:5]), p[5]) for p in parts]
        pup = [tuple(t.float() if t.dtype == torch.bfloat16 else t for t in p) for p in p16]
        del parts
        vals, ids = ops.dplr_corpus_score_multi(*stack(p16), topk=K_)
        _sync(dev)
        same_bits((vals, ids), ops.dplr_corpus_score_multi(*stack(pup), topk=K_),
                  f"bf16 multi {case}")
        for s, p in enumerate(p16):
            check_exact(vals[s], ids[s], ops.dplr_corpus_score(*p), K_,
                        f"bf16 multi {case} segment {s}")
            errs["dplr_corpus_score_multi_bf16"] = max(
                errs["dplr_corpus_score_multi_bf16"],
                check_topk(vals[s], ids[s], ref.dplr_corpus_score_ref(*p), K_,
                           f"bf16 multi {case} segment {s}")[0])
        if case == "equal":
            vals, ids = ops.dplr_corpus_score_multi(*stack(p16), topk=K_, acc_dtype="bfloat16")
            for s, p in enumerate(p16):
                same_bits((vals[s], ids[s]), ops.dplr_corpus_score(*p, topk=K_,
                                                                   acc_dtype="bfloat16"),
                          f"acc bf16 multi segment {s}")
        del p16, pup
    notes.append(f"bf16 multi S={S} Bq={Bq} K={K} and ragged: bitwise the f32 launch on the "
                 f"upcast slabs, rows by C1; acc bf16 rows bitwise the single segment's")


def bf16_items_checks(dev, sz, errs: dict, notes: list) -> None:
    """Kernel 3 on a bf16 V_I (and bf16 small operands, which the wrapper
    upcasts): bitwise the float32 kernel's call on the upcast tensors, and
    within ``check_close`` of the plain version (size-scaled at rho k = 128
    and m_I = 200), at the served shapes (``sz.n3``, each Bq of
    ``sz.bq3s``), n one past a multiple of the tile, k = 12 (rows not whole
    16-byte pieces: the plain-load branch), a V_I 2 bytes off a 4-byte
    boundary, m_I = 200 (two chunks of fields) and rho k = 128; rows of a
    batched call bitwise the per-query call."""
    gen = torch.Generator(device=dev).manual_seed(12)
    tile = items_tile(dev, sz.m3, sz.rho, sz.k)
    cases = ([(sz.n3, b, sz.m3, sz.rho, sz.k, False) for b in sz.bq3s]
             + [(tile * sz.items_tiles + 1, 2, sz.m3, sz.rho, sz.k, False),
                (sz.edge_n, 2, sz.m3, sz.rho, 12, False),
                (sz.edge_n, 3, sz.m3, sz.rho, sz.k, True),
                (sz.edge_n, 2, 200, sz.rho, sz.k, False), (sz.edge_n, 2, sz.m3, 8, 16, False)])
    done = []
    for n, Bq, mI, rho, k, mis in cases:
        what = f"bf16 score_items n={n} m_I={mI} k={k} rho={rho} Bq={Bq}" + (
            " misaligned by 2 bytes" if mis else "")
        b16 = list(to_bf16(*items_inputs(n, Bq, mI, rho, k, gen)))
        if mis:
            flat = torch.empty(b16[0].numel() + 1, dtype=torch.bfloat16, device=dev)
            b16[0] = flat[1:].view(b16[0].shape).copy_(b16[0])
        up = [t.float() for t in b16]
        got = ops.dplr_score_items(*b16)
        _sync(dev)
        same_bits(got, ops.dplr_score_items(*up), what)
        large = rho * k == 128 or mI == 200
        errs["dplr_score_items_bf16"] = max(errs["dplr_score_items_bf16"], check_close(
            got, ref.dplr_score_items_ref(*up), what, items_size(up) if large else None))
        V, U, e3, d, PC, sC = b16
        for q in (0, Bq - 1):
            check_same(got[q], ops.dplr_score_items(V[q], U, e3, d, PC[q], sC[q]),
                       f"{what}: row {q} against the per-query call")
        done.append(what[len("bf16 score_items "):])
        del b16, up, got, V
    notes.append("bf16 dplr_score_items bitwise the f32 launch on the upcast inputs: "
                 + ", ".join(done))


def bf16_pair_checks(dev, sz, errs: dict, notes: list) -> None:
    """Kernel 6 on a bf16 V (``fwfm_pairwise_kernel_bf16``): bitwise its f32
    launch on the upcast V at ``sz.pair_bf16`` (the full batch and a
    ragged B), with a bf16 R upcast first, on a V 2 bytes past a 16-byte
    boundary and at k = 12 (the element-by-element fill); and within the
    f32 bound of its plain version (which upcasts on entry)."""
    gen = torch.Generator(device=dev).manual_seed(9)
    err, what = 0.0, []
    for B, m in sz.pair_bf16:
        V, R = pair_inputs(B, m, sz.k, gen)
        V16 = V.to(torch.bfloat16)
        del V
        before = ops.LAUNCHES["fwfm_pairwise_kernel_bf16"]
        got = ops.fwfm_pairwise(V16, R)
        if dev.type == "cuda" and ops.LAUNCHES["fwfm_pairwise_kernel_bf16"] != before + 1:
            raise AssertionError("fwfm_pairwise on a bf16 V did not launch its bf16 kernel")
        same_bits(got, ops.fwfm_pairwise(V16.float(), R), f"fwfm_pairwise bf16 B={B} m={m}")
        same_bits(ops.fwfm_pairwise(V16, R.to(torch.bfloat16)),
                  ops.fwfm_pairwise(V16.float(), R.to(torch.bfloat16).float()),
                  f"fwfm_pairwise bf16 B={B} m={m}, bf16 R")
        err = max(err, check_close(got, ref.fwfm_pairwise_ref(V16, R),
                                   f"fwfm_pairwise bf16 B={B} m={m} vs plain",
                                   size=pair_size(V16.float(), R)))
        what.append(f"B={B} m={m}")
        del V16, got
    b_eval, m = sz.pairs[0]
    for k, off in ((sz.k, 1), (12, 0)):
        flat = torch.randn(b_eval * m * k + off, generator=gen, device=dev).to(torch.bfloat16)
        V16 = flat[off:].view(b_eval, m, k)
        R = torch.randn((m, m), generator=gen, device=dev) * 0.1
        same_bits(ops.fwfm_pairwise(V16, R), ops.fwfm_pairwise(V16.float(), R),
                  f"fwfm_pairwise bf16 B={b_eval} m={m} k={k} offset {off}")
        what.append(f"B={b_eval} m={m} k={k}" + (" misaligned" if off else ""))
    errs["fwfm_pairwise_bf16"] = err
    notes.append("fwfm_pairwise bf16 V bitwise its f32 launch on the upcast V at "
                 + ", ".join(what))


def bag_adds(bags, dev) -> torch.Tensor:
    """(n_bags, 1): each bag's slots less one, the adds a bag's sum rounds."""
    counts = torch.bincount(bags.segments, minlength=bags.n_bags)
    return torch.clamp(counts - 1, min=0).to(device=dev, dtype=torch.float32)[:, None]


def bf16_bag_checks(dev, sz, errs: dict, notes: list) -> None:
    """Kernel 5 on a bf16 table with bf16 weights, bf16 bags: on the lookup
    path's layouts (context, corpus, pointwise, a ragged B, and the context
    lookup on a table 2 bytes off a 16-byte boundary) bitwise the plain
    version; on the multi-hot layout bitwise ``ref.embedding_bag_in_order``
    (the kernel's order and roundings) and within ``2^-7 (m - 1) sum |w
    row|`` of the plain version for a bag of m slots (each of its m - 1 adds
    rounds to bf16, by at most 2^-8 of the sum so far, and the plain
    version's atomics add in another order)."""
    gen = torch.Generator(device=dev).manual_seed(13)
    cfg = sz.make_config()
    lay, k = cfg.layout, cfg.embed_dim
    table = (torch.randn((padded_rows(lay.total_vocab), k), generator=gen, device=dev)
             / k**0.5).to(torch.bfloat16)
    flat = torch.empty(table.numel() + 1, dtype=torch.bfloat16, device=dev)
    shifted = flat[1:].view(table.shape).copy_(table)
    Bq, items, rows_ = sz.bag_rows
    cases = (("context", lay, "context", Bq, table), ("corpus", lay, "item", items, table),
             ("pointwise", lay, None, rows_, table), ("ragged", lay, None, sz.bag_ragged, table),
             ("context misaligned", lay, "context", Bq, shifted),
             ("multi-hot", multi_hot(lay), None, rows_, table))
    done = []
    for name, layout, kind, B, tab in cases:
        ids, w, bags = bag_case(layout, kind, B, gen)
        w = w.to(torch.bfloat16)
        got = ops.embedding_bag(tab, ids, w, bags)
        want = ref.embedding_bag_ref(tab, ids, w, bags.segments, bags.n_bags)
        _sync(dev)
        what = f"bf16 embedding_bag {name} B={B} slots={ids.shape[1]}"
        if got.dtype != torch.bfloat16:
            raise AssertionError(f"{what}: bags in {got.dtype}")
        if layout.n_slots == layout.n_fields:
            if not torch.equal(got, want):
                raise AssertionError(f"{what}: not bitwise equal to the plain version")
        else:
            if not torch.equal(got, ref.embedding_bag_in_order(tab, ids, w, bags.segments,
                                                               bags.n_bags)):
                raise AssertionError(f"{what}: not bitwise the plain version in the kernel's "
                                     f"order")
            size = ref.embedding_bag_ref(tab.float().abs(), ids, w.float(), bags.segments,
                                         bags.n_bags)
            bad = (got.float() - want.float()).abs() > 2.0**-7 * bag_adds(bags, dev) * size
            if bad.any() or not torch.isfinite(got).all():
                raise AssertionError(f"{what}: {int(bad.sum())} values off")
        errs["embedding_bag_bf16"] = max(errs["embedding_bag_bf16"],
                                         float((got.float() - want.float()).abs().max()))
        done.append(f"{name} {tuple(ids.shape)}")
        del got, want, ids, w
    notes.append("bf16 embedding_bag " + ", ".join(done) + ": one-hot bitwise, multi-hot "
                 "bitwise in the kernel's order and within 2^-7 (m - 1) sum |w row| of "
                 "index_add_'s")


# -- phase 4: the serving path ------------------------------------------------

def plain_fields(table, layout: FeatureLayout, ids, w, item: bool = False):
    """A field lookup in plain PyTorch (``lookup_field_embeddings``, or
    ``lookup_item_embeddings`` with ``item``): the arena offsets added here
    and the plain embedding bag, so that no check launches a kernel."""
    shift = layout.subset("context").total_vocab if item else 0
    lay = layout.subset("item") if item else layout
    off = torch.as_tensor(lay.slot_offsets.astype(np.int64) + shift, device=table.device)
    return ref.embedding_bag_ref(table, ids.long() + off, w, lay.slot_to_field, lay.n_fields)


def plain_context(params, cfg, ctx_ids, ctx_w):
    """``ScorerRuntime.context`` in plain PyTorch: (P_C, s_C, lin_C)."""
    ctx_layout = cfg.layout.subset("context")
    V_C = plain_fields(params["embedding"], ctx_layout, ctx_ids, ctx_w)
    lin_C = lookup_linear_terms(params["linear"], ctx_layout, ctx_ids, ctx_w)
    c = rk.dplr_context_cache(DPLRParams(params["U"], params["e"]), V_C,
                              cfg.layout.n_context)
    return c.P_C, c.s_C, lin_C

def plain_scores(engine, ids):
    """The plain versions of the engine's scoring on its slab: the kernel's
    own form ``a_C + a_I + 0.5 term_e`` and the JAX package's jnp order
    ``bias + lin_C + lin_I + 0.5 (s_C + t_I + term_e)``
    (``masked_slab_scores``), with the summed size of those terms.

    At full width the score is a difference of terms of tens (s_C and t_I
    negative, term_e positive), so any two summation orders part by a few
    roundings of the terms, whatever the score: the size, not |score|,
    scales the tolerance (``check_close(..., size=)``)."""
    c, p = engine.cache, engine.params
    ctx = torch.as_tensor(ids, device=engine.device)
    P_C, s_C, lin_C = plain_context(p, engine.cfg, ctx,
                                    torch.ones(ctx.shape, device=engine.device))
    a_C = p["bias"] + lin_C + 0.5 * s_C
    kernel_form = ref.dplr_corpus_score_ref(c.Q_I, c.a_I, p["e"], P_C, a_C, c.valid)
    jnp_form = masked_slab_scores(p, c.Q_I, c.t_I, c.lin_I, c.valid, P_C, s_C, lin_C)
    P = P_C[:, None] + c.Q_I[None]
    size = (p["bias"].abs() + lin_C.abs()[:, None] + c.lin_I.abs()[None]
            + 0.5 * (s_C.abs()[:, None] + c.t_I.abs()[None]
                     + torch.einsum("qnrk,r->qn", P * P, p["e"].abs())))
    return kernel_form, jnp_form, size


def check_serving(engine, ids, got, what: str) -> int:
    """What the engine answered for contexts ``ids``: its (Bq, capacity)
    scores, or its (scores, ids) top-K, against both plain forms.  Returns
    the positions whose id differs."""
    kernel_form, jnp_form, size = plain_scores(engine, ids)
    if isinstance(got, torch.Tensor):
        check_close(got, kernel_form, what, size=size)
        check_close(got, jnp_form, f"{what}, jnp order", size=size)
        return 0
    vals, ids_ = got
    K = vals.shape[1]
    if not engine.is_live(ids_.cpu().numpy()).all():
        raise AssertionError(f"{what}: a dead slot was returned")
    check_topk(vals, ids_, jnp_form, K, f"{what}, jnp order", size=size)
    return check_topk(vals, ids_, kernel_form, K, what, size=size)[1]


def plain_rank_items(params, cfg, q):
    """Algorithm 1 in plain PyTorch (``fwfm.rank_items`` without the
    kernel), and the summed size of its terms (see ``plain_scores``)."""
    lay = cfg.layout
    nC = lay.n_context
    V_I = plain_fields(params["embedding"], lay, q["item_ids"], q["item_weights"], item=True)
    lin_I = lookup_linear_terms(params["linear"], lay.subset("item"),
                                item_arena_ids(lay, q["item_ids"]), q["item_weights"])
    p = DPLRParams(params["U"], params["e"])
    P_C, s_C, lin_C = plain_context(params, cfg, q["context_ids"], q["context_weights"])
    cache = rk.DPLRContextCache(P_C=P_C, s_C=s_C)
    pw = rk.dplr_score_items(p, cache, V_I, nC)
    d = dplr_diagonal(p)
    pw_size = ref.dplr_score_items_ref(V_I, p.U[:, nC:], p.e.abs(), d[nC:].abs(),
                                       cache.P_C, cache.s_C.abs())
    size = params["bias"].abs() + lin_C.abs()[..., None] + lin_I.abs() + pw_size
    return params["bias"] + lin_C[..., None] + lin_I + pw, size


def serving_phase(dev, sz):
    """Returns the launches of each CUDA kernel, the engine, the query
    contexts, the corpus and the data generator."""
    cfg = sz.make_config()
    # host data first, outside every timed window
    t0 = time.perf_counter()
    data = SyntheticCTR(cfg.layout, embed_dim=4, seed=0)
    corpus = data.ranking_query(sz.items, 0)
    ctxs = [data.context_query(s)["context_ids"] for s in range(sz.queries)]
    batch = np.concatenate([data.context_query(100 + b)["context_ids"]
                            for b in range(sz.batch)])
    n_add, n_remove, n_update = sz.churn
    added = data.ranking_query(n_add, 1)["item_ids"][0]
    updated = data.ranking_query(n_update, 2)["item_ids"][0]
    percall = {k: torch.as_tensor(v, device=dev)
               for k, v in data.ranking_query(sz.percall_n, 3).items()}
    host_s = time.perf_counter() - t0

    ops.reset_launches()
    params = fwfm.init(torch.Generator(device=dev).manual_seed(0), cfg)
    engine = CorpusState(cfg, corpus["item_ids"][0], corpus["item_weights"][0],
                         capacity=sz.capacity, device=dev)
    t0 = time.perf_counter()
    engine.refresh(params)
    _sync(dev)
    build_s = time.perf_counter() - t0
    K = sz.topk
    lat, answers = [], []
    for ctx in ctxs:
        t0 = time.perf_counter()
        answers.append(engine.topk(ctx, K))
        _sync(dev)
        lat.append((time.perf_counter() - t0) * 1e3)
    diffs = sum(check_serving(engine, ctx, got, "serve topk")
                for ctx, got in zip(ctxs, answers))
    diffs += check_serving(engine, batch, engine.topk(batch, K), "serve topk batch")
    check_serving(engine, ctxs[0], engine.score(ctxs[0]), "serve score")
    big = engine.topk(ctxs[0], sz.big_topk)        # past 4096: the winners' sort kernels
    check_serving(engine, ctxs[0], big, f"serve top-{sz.big_topk}")

    slots = engine.add_items(added)
    assert engine.is_live(slots).all()
    live = engine.valid_slots
    gone = live[:: len(live) // n_remove][:n_remove]
    engine.remove_items(gone)
    kept = engine.valid_slots
    engine.update_items(kept[1:: len(kept) // n_update][:n_update], updated)
    diffs += check_serving(engine, batch, engine.topk(batch, K), "churn topk")
    before = engine.score(ctxs[0])

    bumped = dict(params, bias=params["bias"] + 1.0)
    engine.refresh(bumped)
    after = engine.score(ctxs[0])
    check_serving(engine, ctxs[0], after, "refreshed score")
    alive = engine.cache.valid
    size = plain_scores(engine, ctxs[0])[2]
    check_close(after[:, alive], before[:, alive] + 1.0,
                "refresh shifts by the bias", size=size[:, alive])

    got = fwfm.rank_items(bumped, cfg, percall)
    _sync(dev)
    want, size = plain_rank_items(bumped, cfg, percall)
    check_close(got, want, "percall rank_items", size=size)
    small = CorpusState(cfg, percall["item_ids"][0], percall["item_weights"][0], device=dev)
    small.refresh(bumped)
    vals, ids = small.topk(percall["context_ids"], K)
    _sync(dev)
    check_topk(vals, ids, got, K, "corpus topk against percall scores", size=size)

    launches = {g: ops.LAUNCHES[g] for name in SERVE_KERNELS for g in ops.KERNELS[name]}
    if dev.type == "cuda" and not all(launches.values()):
        raise AssertionError(f"a kernel was not launched on the serving path: {launches}")
    print(f"phase serve: {cfg.layout.n_fields} fields k={cfg.embed_dim} rho={cfg.rank}, "
          f"{sz.items} items in a {sz.capacity}-slot slab; host data {host_s:.1f} s, "
          f"slab build {build_s:.2f} s; {len(lat)} top-{K} queries at Bq=1 median "
          f"{np.median(lat):.3f} ms (host clock, synchronized), one top-{sz.big_topk}; "
          f"{diffs} top-K ids "
          f"differ from plain, all within the tie rule; churn +{n_add} -{n_remove} "
          f"~{n_update}, refresh and percall n={sz.percall_n} all agree; "
          f"launches {launches}", flush=True)
    return SimpleNamespace(launches=launches, engine=engine, ctxs=ctxs, corpus=corpus,
                           data=data)


# -- phase 4b: the serving path in bf16 -----------------------------------------

# The entry points the serve-bf16 phase drives, their bf16 instantiations;
# and the float32 instantiations of kernels 1-5, which it must not launch.
SERVE_BF16_KERNELS = ("dplr_corpus_score_bf16", "dplr_corpus_topk_bf16",
                      "dplr_score_items_bf16", "dplr_corpus_score_multi_bf16",
                      "embedding_bag_bf16")
F32_ONLY = ("corpus_score_full", "corpus_topk_chunks", "corpus_multi_topk_chunks",
            "dplr_score_items_kernel", "embedding_bag_kernel")


def plain_slab_scores(engine, ids):
    """Plain scores of ``engine``'s slab (bf16 in the serve-bf16 phase,
    upcast by the plain version) for contexts ``ids``, and the summed size
    of their terms.  The query side is the engine's own ``_query`` with the
    plain bag in its lookups, which on these one-hot layouts is bitwise the
    kernel's (the kernel phase holds it so), so only the scorer differs."""
    c, p = engine.cache, engine.params
    ctx = torch.as_tensor(ids, device=engine.device)
    with plain_bags():
        P_C, a_C = engine.runtime._query(p, ctx, torch.ones(ctx.shape, device=engine.device))
    full = ref.dplr_corpus_score_ref(c.Q_I, c.a_I, p["e"], P_C, a_C, c.valid)
    P = P_C[:, None] + c.Q_I.float()[None]
    size = (a_C.abs()[:, None] + c.a_I.float().abs()[None]
            + 0.5 * torch.einsum("qnrk,r->qn", P * P, p["e"].float().abs()))
    return full, size


def check_slab_serving(engine, ids, got, what: str) -> int:
    """``check_serving`` for an engine whose slab may be bf16: its scores or
    top-K against ``plain_slab_scores`` within ``TOL * max(1, size)``; a
    top-K's ids live.  Returns the positions whose id differs."""
    full, size = plain_slab_scores(engine, ids)
    if isinstance(got, torch.Tensor):
        check_close(got, full, what, size=size)
        return 0
    vals, ids_ = got
    if not engine.is_live(ids_.cpu().numpy()).all():
        raise AssertionError(f"{what}: a dead slot was returned")
    return check_topk(vals, ids_, full, vals.shape[1], what, size=size)[1]


def serve_bf16_phase(dev, sz, serve) -> dict:
    """The full config served in bf16, as ``launch/serve.py --bf16`` serves
    it: the serve phase's weights (after its refresh) with their float32
    leaves cast to bf16 (``to_serving_dtype``), its 1,000,000-item corpus in
    a 2^20-slot bf16 slab.  Top-K and score queries at Bq = 1 and 16, one
    top-``big_topk``, churn, a refresh from a float32 checkpoint through
    ``maybe_refresh``, one packed wave of ``sz.tenants`` tenants and
    Algorithm 1 per call, each held against the plain path
    (``check_slab_serving``, ``plain_rank_items``).  The launches of each
    CUDA kernel are counted over the phase: every bf16 kernel must launch,
    no float32 instantiation of kernels 1-5 may, and one Bq = 1 top-K call
    must hold less device memory than half a float32 copy of the slab (no
    slab is cast before a launch).  Beside the answers, the float32
    engine's top-K on the same corpus: how many of its ids the bf16 one
    keeps (quality, not a check)."""
    cfg, K = serve.engine.cfg, sz.topk
    p16 = serve_driver.to_serving_dtype(serve.engine.params, True)
    data, corpus, ctxs = serve.data, serve.corpus, serve.ctxs
    ids, w = corpus["item_ids"][0], corpus["item_weights"][0]
    batch = np.concatenate((ctxs * sz.batch)[:sz.batch])
    n_add, n_remove, n_update = sz.churn
    added = data.ranking_query(n_add, 11)["item_ids"][0]
    updated = data.ranking_query(n_update, 12)["item_ids"][0]
    percall = {k_: torch.as_tensor(v, device=dev)
               for k_, v in data.ranking_query(sz.percall_n, 13).items()}
    t_phase = time.perf_counter()

    # the float32 engine on the same corpus and weights, for the overlap
    engine32 = CorpusState(cfg, ids, w, capacity=sz.capacity, device=dev)
    engine32.refresh(serve.engine.params)
    f32_answers = [engine32.topk(ctx, K) for ctx in ctxs]
    lat32 = []
    for ctx in ctxs:
        t0 = time.perf_counter()
        engine32.topk(ctx, K)
        _sync(dev)
        lat32.append((time.perf_counter() - t0) * 1e3)
    del engine32

    ops.reset_launches()
    engine = CorpusState(cfg, ids, w, capacity=sz.capacity, device=dev)
    t0 = time.perf_counter()
    engine.refresh(p16)
    _sync(dev)
    build_s = time.perf_counter() - t0
    c = engine.cache
    if not all(t.dtype == torch.bfloat16 for t in (c.Q_I, c.t_I, c.lin_I, c.a_I)):
        raise AssertionError("serve-bf16: the slab is not bf16")
    lat, answers = [], []
    for ctx in ctxs:
        t0 = time.perf_counter()
        answers.append(engine.topk(ctx, K))
        _sync(dev)
        lat.append((time.perf_counter() - t0) * 1e3)
    diffs = sum(check_slab_serving(engine, ctx, got, "bf16 serve topk")
                for ctx, got in zip(ctxs, answers))
    if any(v.dtype != torch.float32 for v, _ in answers):
        raise AssertionError("serve-bf16: top-K values not float32")
    check_exact(*answers[0], engine.score(ctxs[0]), K, "bf16 serve topk, C1")
    diffs += check_slab_serving(engine, batch, engine.topk(batch, K), "bf16 serve topk batch")
    check_slab_serving(engine, ctxs[0], engine.score(ctxs[0]), "bf16 serve score")
    check_slab_serving(engine, ctxs[0], engine.topk(ctxs[0], sz.big_topk),
                       f"bf16 serve top-{sz.big_topk}")
    peak = peak_mib(dev, lambda: engine.topk(ctxs[0], K))
    slab32 = engine.capacity * sz.rho * sz.k * 4 / 2**20
    if peak is not None and peak >= slab32 / 2:
        raise AssertionError(f"serve-bf16: a Bq=1 top-{K} call held {peak:.1f} MiB, as much as "
                             f"a float32 copy of the slab ({slab32:.0f} MiB)")
    kept = [len(set(a[1][0].tolist()) & set(b[1][0].tolist()))
            for a, b in zip(answers, f32_answers)]
    gap = max(float((a[0] - b[0]).abs().max()) for a, b in zip(answers, f32_answers))

    slots = engine.add_items(added)
    if not engine.is_live(slots).all():
        raise AssertionError("serve-bf16: added items not live")
    live = engine.valid_slots
    engine.remove_items(live[:: len(live) // n_remove][:n_remove])
    kept_slots = engine.valid_slots
    engine.update_items(kept_slots[1:: len(kept_slots) // n_update][:n_update], updated)
    diffs += check_slab_serving(engine, batch, engine.topk(batch, K), "bf16 churn topk")

    # a refresh from a float32 checkpoint, cast to bf16 by maybe_refresh's select
    BUILD.mkdir(parents=True, exist_ok=True)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_bf16_", dir=BUILD))
    try:
        mgr = CheckpointManager(str(workdir))
        bumped = dict(p16, bias=p16["bias"] + 1.0)
        on_disk = serve_driver.to_checkpoint_dtype(bumped)
        t0 = time.perf_counter()
        mgr.save({"params": on_disk}, step=1, blocking=True)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        swapped = engine.maybe_refresh(
            mgr, {"params": dict.fromkeys(on_disk)},
            select=lambda t: serve_driver.to_serving_dtype(t["params"], True))
        _sync(dev)
        refresh_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if not swapped or engine.model_step != 1 or not all(
            engine.params[k_].dtype == torch.bfloat16 and torch.equal(engine.params[k_], v)
            for k_, v in bumped.items()):
        raise AssertionError("serve-bf16: maybe_refresh did not install the bf16 weights")
    diffs += check_slab_serving(engine, batch, engine.topk(batch, K), "bf16 refreshed topk")

    # one packed wave: tenants x tenant_bq requests, one fused launch
    T, per, cap, bq = sz.tenants, sz.tenant_items, sz.tenant_capacity, sz.tenant_bq
    runtime = ScorerRuntime(cfg, device=dev)
    states = {}
    for i in range(T):
        st = CorpusState(None, ids[i * per:(i + 1) * per], w[i * per:(i + 1) * per],
                         capacity=cap, runtime=runtime)
        st.refresh(engine.params)
        states[f"t{i}"] = st
    pool = [data.context_query(7000 + s)["context_ids"] for s in range(T * bq)]
    fe = QueryFrontend(states, max_batch=bq, max_k=K, auto_pump=False, pack=True)
    pend = [fe.submit(pool[i * bq + j], k=K, tenant=name)
            for i, name in enumerate(states) for j in range(bq)]
    fe.pump()
    fe.resolve()
    got = [p.result() for p in pend]
    fused = fe.health()["packing"]["fused_dispatches"]
    fe.close()
    if fused < 1:
        raise AssertionError("serve-bf16: the wave did not pack")
    for i, (name, st) in enumerate(states.items()):
        rows = got[i * bq:(i + 1) * bq]
        ctx = np.concatenate(pool[i * bq:(i + 1) * bq])
        vals, ids_ = st.topk(ctx, K)
        if not (np.array_equal(np.stack([v for v, _ in rows]), vals.cpu().numpy())
                and np.array_equal(np.stack([i_ for _, i_ in rows]), ids_.cpu().numpy())):
            raise AssertionError(f"serve-bf16: tenant {name}'s packed replies != its own topk")
        diffs += check_slab_serving(st, ctx, (vals, ids_), f"bf16 packed wave {name}")
    del states, runtime

    got = fwfm.rank_items(engine.params, cfg, percall)
    _sync(dev)
    want, size = plain_rank_items(engine.params, cfg, percall)
    check_close(got, want, "bf16 percall rank_items", size=size)

    launches = {g: ops.LAUNCHES[g] for name in SERVE_BF16_KERNELS for g in ops.KERNELS[name]}
    f32 = {g: ops.LAUNCHES[g] for g in F32_ONLY}
    if dev.type == "cuda" and (not all(launches.values()) or any(f32.values())):
        raise AssertionError(f"serve-bf16: a bf16 kernel not launched, or a float32 one "
                             f"launched: {launches}, {f32}")
    print(f"phase serve-bf16: {cfg.layout.n_fields} fields k={cfg.embed_dim} rho={cfg.rank}, "
          f"bf16 weights, {sz.items} items in a {sz.capacity}-slot bf16 slab "
          f"({engine.capacity * (sz.rho * sz.k * 2 + 2 + 1) / 1e6:.1f} MB: Q_I, a_I, valid); "
          f"slab build {build_s:.2f} s; {len(lat)} top-{K} queries at Bq=1 median "
          f"{np.median(lat):.3f} ms bf16, {np.median(lat32):.3f} ms f32 on the same corpus "
          f"(host clock, synchronized); peak memory of a Bq=1 top-{K} call {_mib(peak)} "
          f"(a float32 copy of the slab: {slab32:.0f} MiB); bf16 top-{K} keeps "
          f"{np.mean(kept):.2f} of the f32 engine's {K} ids on average (min {min(kept)}), "
          f"values within {gap:.3g} of its; {diffs} top-K ids differ from plain, all within "
          f"the tie rule; one top-{sz.big_topk}; churn +{n_add} -{n_remove} ~{n_update}; "
          f"a float32 checkpoint saved in {save_s:.2f} s, installed as bf16 by maybe_refresh "
          f"in {refresh_s:.2f} s; one packed wave of {T} tenants x {bq} ({fused} fused "
          f"dispatch), replies bitwise each tenant's own top-K; percall n={sz.percall_n} "
          f"agrees; no float32 kernel 1-5 launched {f32}; wall "
          f"{time.perf_counter() - t_phase:.1f} s; launches {launches}", flush=True)
    return launches


# -- phase 5: tenants ---------------------------------------------------------

def tenants_phase(dev, sz, serve) -> tuple[dict, dict]:
    """16 tenants (``sz.tenants``) on one ScorerRuntime, each a disjoint
    slice of the serve phase's corpus in its own slab, with the serve
    phase's weights.  Waves of tenants x ``tenant_bq`` requests at
    K = ``topk`` go through a packed frontend (one fused launch a wave),
    then the same waves through an unpacked one on the same states.
    Returns the multi-tenant kernel's launches over the timed packed
    waves, and the tenants' states."""
    cfg, params, data = serve.engine.cfg, serve.engine.params, serve.data
    T, per, cap, bq, K = sz.tenants, sz.tenant_items, sz.tenant_capacity, sz.tenant_bq, sz.topk
    ids, w = serve.corpus["item_ids"][0], serve.corpus["item_weights"][0]
    pool = [data.context_query(5000 + s)["context_ids"] for s in range(4 * T * bq)]
    runtime = ScorerRuntime(cfg, device=dev)
    states = {}
    for i in range(T):
        st = CorpusState(None, ids[i * per:(i + 1) * per], w[i * per:(i + 1) * per],
                         capacity=cap, runtime=runtime)
        st.refresh(params)
        states[f"t{i}"] = st
    names = list(states)
    ctx_of = lambda wave, i, j: pool[(wave * T * bq + i * bq + j) % len(pool)]  # noqa: E731

    def run(fe, got, waves):
        """``waves`` more waves, numbered on from the ``len(got)`` done."""
        for wave in range(len(got), len(got) + waves):
            pend = [fe.submit(ctx_of(wave, i, j), k=K, tenant=name)
                    for i, name in enumerate(names) for j in range(bq)]
            fe.pump()
            fe.resolve()
            got.append([p.result() for p in pend])
        _sync(dev)

    replies, rates, launches = {}, {}, {}
    share = "device time not measured"
    multi = ops.KERNELS["dplr_corpus_score_multi"]
    for pack in (True, False):
        fe = QueryFrontend(states, max_batch=bq, max_k=K, auto_pump=False, pack=pack)
        got = []
        run(fe, got, sz.warm_waves)
        if pack:
            ops.reset_launches()
        t0 = time.perf_counter()
        run(fe, got, sz.waves)
        rates[pack] = sz.waves * T * bq / (time.perf_counter() - t0)
        if pack:
            launches = {g: ops.LAUNCHES[g] for gs in ops.KERNELS.values() for g in gs}
            if dev.type == "cuda" and not all(launches[g] for g in multi):
                raise AssertionError(f"the multi-tenant kernel was not launched: {launches}")
            split, wall, seen = profiled(dev, lambda: run(fe, got, sz.profile_waves))
            if split is not None:
                busy = sum(ms for ms, _ in split.values())
                kern = sum(split.get(g, (0.0, 0))[0] for g in multi)
                share = (f"device busy {busy:.3f} ms of {wall:.3f} ms wall over "
                         f"{sz.profile_waves} packed waves, idle share "
                         f"{1 - busy / wall:.3f}; per wave: multi-tenant kernel "
                         f"{kern / sz.profile_waves:.4f} ms, other kernels "
                         f"{(busy - kern) / sz.profile_waves:.4f} ms, wall "
                         f"{wall / sz.profile_waves:.3f} ms; profiler saw {seen}")
            elif seen:
                share = f"device time not measured (profiler saw {seen})"
            packing = fe.health()["packing"]
            if packing["fused_dispatches"] < len(got):
                raise AssertionError(f"fewer fused dispatches than waves: {packing}")
        else:
            run(fe, got, len(replies[True]) - len(got))
        fe.close()
        replies[pack] = got
    total = len(replies[True])
    diffs = 0
    for wave, (packed, unpacked) in enumerate(zip(replies[True], replies[False])):
        for i, name in enumerate(names):
            rows = packed[i * bq:(i + 1) * bq]
            for (pv, pi), (uv, ui) in zip(rows, unpacked[i * bq:(i + 1) * bq]):
                if not (np.array_equal(pv, uv) and np.array_equal(pi, ui)):
                    raise AssertionError(f"wave {wave} tenant {name}: packed reply != "
                                         f"unpacked reply")
            got = (torch.as_tensor(np.stack([v for v, _ in rows]), device=dev),
                   torch.as_tensor(np.stack([i_ for _, i_ in rows]), device=dev))
            ctx = np.concatenate([ctx_of(wave, i, j) for j in range(bq)])
            diffs += check_serving(states[name], ctx, got, f"tenants wave {wave} {name}")
    print(f"phase tenants: {T} tenants x {per} items in {cap}-slot slabs on one "
          f"ScorerRuntime; waves of {T} x {bq} requests at K={K}; packed "
          f"{rates[True]:.1f} req/s, unpacked {rates[False]:.1f} req/s over {sz.waves} "
          f"waves (host clock, after {sz.warm_waves} warm-up waves); "
          f"{packing['fused_dispatches']} fused dispatches for {total} waves, mean group "
          f"{packing['mean_group']:.2f}; {total * T * bq} replies checked against plain "
          f"({diffs} ids differ, all within the tie rule), packed = unpacked bitwise; "
          f"{share}; launches {launches}", flush=True)
    return launches, states


# -- phase 5b: the corpus sharded over a one-process mesh ----------------------

# The entry points the shard phase's sharded engines drive (their bf16
# instantiations in its bf16 half): kernels 1, 2 and 4, and kernel 5 in each
# shard's row build and in the context lookup.
SHARD_KERNELS = ("dplr_corpus_score", "dplr_corpus_topk", "dplr_corpus_score_multi",
                 "embedding_bag")


@contextlib.contextmanager
def counted(into: collections.Counter):
    """Adds the kernel launches made inside the block to ``into``."""
    before = collections.Counter(ops.LAUNCHES)
    try:
        yield
    finally:
        into.update(collections.Counter(ops.LAUNCHES) - before)


def shard_data(sz, serve) -> SimpleNamespace:
    """The shard phase's host data, made once for both types: the churn's
    items (a growth past the 2^20-slot slab among them) and the query
    contexts, all from the serve phase's generator."""
    data = serve.data
    n_add, n_remove, n_update, n_grow = sz.shard_churn
    return SimpleNamespace(
        added=data.ranking_query(n_add, 11)["item_ids"][0],
        n_remove=n_remove,
        updated=data.ranking_query(n_update, 12)["item_ids"][0],
        grown=data.ranking_query(n_grow, 13)["item_ids"][0],
        ctxs={bq: np.concatenate(serve.ctxs[:bq]) for bq in sz.shard_bqs},
        pool=[data.context_query(7000 + s)["context_ids"]
              for s in range(sz.tenants * sz.tenant_bq)],
        mp=data.ranking_query(sz.mp_items, 14))


def shard_launch_checks(dev, engine, ctx, K: int, what: str) -> float:
    """Each shard's launches of kernels 1 and 2 against their plain
    versions on the shard's slab, with its offset and stride: kernel 1
    within ``TOL * max(1, size)``, kernel 2 by C1 (bitwise kernel 1's
    scores sorted, relabeled ``s + D * row``).  Returns max |diff|."""
    D, err = engine.n_shards, 0.0
    params = engine.params
    ctx = torch.as_tensor(ctx, device=dev)
    P_C, a_C = engine.runtime._query(params, ctx, torch.ones(ctx.shape, device=dev))
    e = params["e"].float()
    for s, c in enumerate(engine.cache.shards):
        scores = ops.dplr_corpus_score(c.Q_I, c.a_I, e, P_C, a_C, valid=c.valid)
        plain = ref.dplr_corpus_score_ref(c.Q_I, c.a_I, e, P_C, a_C, c.valid)
        P = P_C[:, None] + c.Q_I.float()[None]
        size = (a_C.abs()[:, None] + c.a_I.float().abs()[None]
                + 0.5 * torch.einsum("qnrk,r->qn", P * P, e.abs()))
        del P
        err = max(err, check_close(scores, plain, f"{what} shard {s} kernel 1", size=size))
        topk_exact((c.Q_I, c.a_I, e, P_C, a_C, c.valid), K, f"{what} shard {s} kernel 2",
                   scores, index_offset=s, index_stride=D)
    return err


def shard_multi_checks(dev, tenants: dict, ctx, K: int, what: str) -> None:
    """Each shard's launch of kernel 4 over the tenants' slices: row [t]
    bitwise kernel 2 on tenant t's slice with the shard's offset and
    stride, and tenant 0's kernel 2 by C1 against kernel 1."""
    states = list(tenants.values())
    rt = states[0].runtime
    D = rt.n_shards
    ctx = torch.as_tensor(ctx, device=dev)
    ones = torch.ones(ctx.shape, device=dev)
    qs = [rt._query(st.params, ctx, ones) for st in states]
    P_C, a_C = torch.stack([p for p, _ in qs]), torch.stack([a for _, a in qs])
    e = torch.stack([st.params["e"].float() for st in states])
    for s in range(D):
        cs = [st.cache.shards[s] for st in states]
        k_loc = min(K, cs[0].capacity)
        multi = ops.dplr_corpus_score_multi(
            tuple(c.Q_I for c in cs), tuple(c.a_I for c in cs), tuple(c.valid for c in cs),
            e, P_C, a_C, topk=k_loc, index_offset=s, index_stride=D)
        for t, c in enumerate(cs):
            args = (c.Q_I, c.a_I, e[t], P_C[t], a_C[t], c.valid)
            if t == 0:
                single = topk_exact(args, k_loc, f"{what} shard {s} tenant 0 kernel 2",
                                    ops.dplr_corpus_score(*args), index_offset=s,
                                    index_stride=D)
            else:
                single = ops.dplr_corpus_score(*args, topk=k_loc, index_offset=s,
                                               index_stride=D)
            same_bits((multi[0][t], multi[1][t]), single, f"{what} shard {s} kernel 4 row {t}",
                      "kernel 2 on that tenant's slice")


def median_ms(dev, fn, reps: int) -> float:
    """Median host-clock ms of ``fn()`` followed by a synchronize."""
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        lat.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(lat))


def shard_run(dev, sz, serve, data, mesh, params, tag: str, launched: collections.Counter):
    """One type's half of the shard phase: the serve corpus in a sharded
    and a single-device engine on the card, held bitwise to each other
    (slabs, scores, top-K, churn with a growth, 16 packed tenants), each
    shard's kernels against their plain versions, and the two engines'
    top-K medians.  The sharded engines' launches go into ``launched``."""
    cfg = serve.engine.cfg
    K, D = sz.topk, mesh.shape["model"]
    ids, w = serve.corpus["item_ids"][0], serve.corpus["item_weights"][0]
    one = CorpusState(cfg, ids, w, capacity=sz.capacity, device=dev)
    one.refresh(params)
    with counted(launched):
        sh = CorpusState(cfg, ids, w, capacity=sz.capacity, mesh=mesh)
        sh.refresh(params)
    for s, c in enumerate(sh.cache.shards):
        for name in ItemCorpusCache._fields:
            same_bits(getattr(c, name), getattr(one.cache, name)[s::D],
                      f"{tag} shard {s} {name}", "the single-device slab's rows")

    def same_answers(what):
        for bq, ctx in data.ctxs.items():
            with counted(launched):
                got, score = sh.topk(ctx, K), sh.score(ctx)
            same_bits(got, one.topk(ctx, K), f"{tag} {what} Bq={bq} top-{K}",
                      "the single-device engine's")
            same_bits(score, one.score(ctx), f"{tag} {what} Bq={bq} score",
                      "the single-device engine's")
            del score

    same_answers("built")
    bq = max(data.ctxs)
    check_slab_serving(one, data.ctxs[bq], sh.topk(data.ctxs[bq], K), f"{tag} sharded top-K")
    err = shard_launch_checks(dev, sh, data.ctxs[bq], K, tag)
    times = {}
    for bq, ctx in data.ctxs.items():
        with counted(launched):
            sharded_ms = median_ms(dev, lambda: sh.topk(ctx, K), sz.shard_reps)
        times[bq] = (sharded_ms, median_ms(dev, lambda: one.topk(ctx, K), sz.shard_reps))

    with counted(launched):
        added = sh.add_items(data.added)
    if not np.array_equal(added, one.add_items(data.added)):
        raise AssertionError(f"{tag}: the engines assigned different slots")
    live = one.valid_slots
    gone = live[:: len(live) // data.n_remove][:data.n_remove]
    kept = np.setdiff1d(live, gone)
    upd = kept[1:: len(kept) // len(data.updated)][:len(data.updated)]
    with counted(launched):
        sh.remove_items(gone)
        sh.update_items(upd, data.updated)
        grown = sh.add_items(data.grown)
    one.remove_items(gone)
    one.update_items(upd, data.updated)
    if not np.array_equal(grown, one.add_items(data.grown)):
        raise AssertionError(f"{tag}: the engines assigned different slots in the growth")
    if not (sh.capacity == one.capacity == 2 * sz.capacity
            and np.array_equal(sh.valid_slots, one.valid_slots)):
        raise AssertionError(f"{tag}: capacities {sh.capacity}, {one.capacity} or live slots "
                             f"differ after the growth")
    same_answers("churned")
    del sh, one
    gc.collect()

    T, per, cap = sz.tenants, sz.tenant_items, sz.tenant_capacity
    with counted(launched):
        rt = ScorerRuntime(cfg, mesh=mesh)
        tenants = {}
        for i in range(T):
            tenants[f"t{i}"] = CorpusState(None, ids[i * per:(i + 1) * per],
                                           w[i * per:(i + 1) * per], capacity=cap, runtime=rt)
            tenants[f"t{i}"].refresh(params)
    ctx = np.stack([np.concatenate(data.pool[i * sz.tenant_bq:(i + 1) * sz.tenant_bq])
                    for i in range(T)])
    with counted(launched):
        fused = fused_topk(tuple(tenants.values()), ctx, K)
        lone = [st.topk(ctx[i], K) for i, st in enumerate(tenants.values())]
    for i, got in enumerate(lone):
        same_bits((fused[0][i], fused[1][i]), got, f"{tag} fused tenant {i}",
                  "a lone sharded call")
    single = CorpusState(cfg, ids[:per], w[:per], capacity=cap, device=dev)
    single.refresh(params)
    same_bits(lone[0], single.topk(ctx[0], K), f"{tag} tenant 0",
              "the single-device engine's")
    shard_multi_checks(dev, tenants, ctx[0], K, f"{tag} tenants")
    del tenants, rt, single
    gc.collect()
    return times, err


def shard_phase(dev, sz, serve) -> tuple[dict, dict]:
    """The serve phase's corpus on ``make_host_mesh(sz.shards)``: four
    shards of 2^18 local slots sharing the one card (one card each where
    there are as many), in float32 and in bf16 (the serve phase's weights
    cast as ``serve --bf16`` casts them), each held bitwise to a
    single-device engine on the same card; ``rank_items_mp`` over four
    arena blocks against ``rank_items``.  Returns the sharded paths'
    launches, float32 and bf16."""
    mesh = make_host_mesh(sz.shards, device=dev)
    t0 = time.perf_counter()
    data = shard_data(sz, serve)
    host_s = time.perf_counter() - t0
    params = serve.engine.params
    launched = {"f32": collections.Counter(), "bf16": collections.Counter()}
    lines = []
    for tag, p in (("f32", params), ("bf16", serve_driver.to_serving_dtype(params, True))):
        times, err = shard_run(dev, sz, serve, data, mesh, p, tag, launched[tag])
        lines.append(f"{tag}: slabs, scores, top-K, churn and growth, {sz.tenants} packed tenants "
                     f"bitwise the single-device engine; each shard's kernel 1 within "
                     f"{err:.3g} of plain, kernels 2 and 4 by C1 and bitwise kernel 2; "
                     f"top-{sz.topk} median ms sharded/single " + ", ".join(
                         f"Bq={bq} {a:.3f}/{b:.3f}" for bq, (a, b) in times.items()))
    cfg = serve.engine.cfg
    q = train.to_device(data.mp, dev)
    with counted(launched["f32"]):
        got = fwfm.rank_items_mp(params, cfg, q, mesh=mesh)
    want, size = plain_rank_items(params, cfg, q)
    mp_err = check_close(got, want, "rank_items_mp against plain", size=size)
    mp_err = max(mp_err, check_close(got, fwfm.rank_items(params, cfg, q),
                                     "rank_items_mp against rank_items", size=size))
    out = {}
    for tag, suffix in (("f32", ""), ("bf16", "_bf16")):
        names = [g if g.endswith("_merge") or g.startswith("topk_sort") else
                 ops.launch_name(g, torch.bfloat16 if suffix else torch.float32)
                 for entry in SHARD_KERNELS for g in ops.KERNELS[entry]]
        out[tag] = {g: launched[tag][g] for g in names}
        need = [ops.KERNELS[e][0] for e in SHARD_KERNELS] + ["topk_merge", "multi_topk_merge"]
        need = [g if g.endswith("_merge") else g + suffix for g in need]
        if dev.type == "cuda" and not all(launched[tag][g] for g in need):
            raise AssertionError(f"shard {tag}: a kernel of the sharded path did not launch: "
                                 f"{dict(launched[tag])}")
    print(f"phase shard: {mesh.shape['model']} shards on {', '.join(map(str, mesh.devices))}, "
          f"{sz.items} items in a {sz.capacity}-slot slab ({sz.capacity // sz.shards} a "
          f"shard); host data {host_s:.1f} s; " + "; ".join(lines)
          + f"; rank_items_mp over {sz.shards} arena blocks within {mp_err:.3g} of plain "
          f"and rank_items at 1 x {sz.mp_items}; launches f32 {out['f32']}, bf16 "
          f"{out['bf16']} (host clock, synchronized)", flush=True)
    return out["f32"], out["bf16"]


# -- phase 5c: the training half of sharding on the one-process mesh ----------

# The entry points the shard-train phase's sharded lookups drive: kernel 5 on
# every arena block forward (and once over the gathered rows, into the field
# bags), kernel 5' on every block backward.
SHARD_TRAIN_KERNELS = ("embedding_bag", "embedding_bag_backward")


def field_batches(cfg, B: int, n: int, dev, seed: int) -> list:
    """``n`` train batches of ``B`` rows made on ``dev`` from ``seed``: each
    slot's id uniform below its field's vocabulary, weights 1, labels 0 or
    1 with probability 1/2."""
    lay = cfg.layout
    vocab = torch.as_tensor([lay.fields[f].vocab_size for f in lay.slot_to_field],
                            dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for _ in range(n):
        u = torch.rand((B, lay.n_slots), generator=gen, device=dev, dtype=torch.float64)
        ids = torch.minimum((u * vocab).floor(), vocab - 1).to(torch.int32)
        out.append({"ids": ids, "weights": torch.ones((B, lay.n_slots), device=dev),
                    "label": (torch.rand(B, generator=gen, device=dev) < 0.5).float()})
    return out


def leaf_gap(a: dict, b: dict) -> float:
    """The largest, over the leaves of two nested dicts, of ``max|a - b|``
    over ``max(1, max|b|)``."""
    return max((float((x - y).abs().max()) / max(1.0, float(y.abs().max()))
                for (_, x), (_, y) in zip(flat_items(a), flat_items(b))), default=0.0)


def cell_ms(dev, cell, args: tuple, steps: int) -> float:
    """``measure_cell``'s median step of ``cell`` on ``args``."""
    return float(np.median(measure_cell(dev, dataclasses.replace(cell, args=args), steps)[0]))


def shard_train_recsys(dev, sz, cfg, mesh, launched: collections.Counter) -> tuple[str, dict]:
    """(a): ``dplr-fwfm/train_batch`` built on ``mesh`` (D shards), on a
    one-shard mesh and without a mesh, from one seed: ``sz.strain_steps``
    adagrad steps on the same batches.  Every step's loss and the
    parameters and accumulator after it bitwise D = 1's; the loss within
    ``1e-4 max(1, |loss|)`` of the step without ``take_fn``, and every leaf
    of the parameters and accumulator within ``1e-5 max(1, max|leaf|)`` of
    it (the CPU tests' bound: that path adds the first-order gradient with
    autograd's atomics); on the card ``2 D + 1`` launches of kernels 5 and
    5' a step (the field and first-order gathers on each block, and the
    bags of the gathered rows).  Each cell's median step on the first batch
    (``measure_cell``).  Then kernel 5' as the sharded backward calls it, at
    the first batch's slots: on each block, foreign slots keyed past it,
    into that block's rows of one NaN-filled gradient (``out=``); the
    blocks together bitwise one launch over the whole arena, which is
    within ``1e-6 sum |w g|`` of ``ref.embedding_bag_vjp``; each block's
    time beside the whole launch's.  Returns a summary and the first
    batch."""
    D = mesh.shape["model"]
    meshes = {D: mesh, 1: make_host_mesh(1, device=dev), "plain": None}
    cells = {k: steps.build("dplr-fwfm", "train_batch", device=dev, cfg=cfg,
                            dims=sz.strain_dims, mesh=m) for k, m in meshes.items()}
    B = cells[1].args[2]["ids"].shape[0]
    batches = field_batches(cfg, B, sz.strain_steps, dev, seed=5)
    runs = {k: list(c.args[:2]) for k, c in cells.items()}
    losses = {k: [] for k in cells}
    counts = {k: collections.Counter() for k in cells}
    plain_bitwise, gap = True, 0.0
    for i, batch in enumerate(batches):
        for k, cell in cells.items():
            params, state = runs[k]
            with counted(counts[k]):
                loss, params, state = cell.fn(params, state, batch, cell.args[3])
            runs[k] = [params, state]
            losses[k].append(loss)
        if not (torch.equal(losses[D][i], losses[1][i]) and same_tree(runs[D][0], runs[1][0])
                and same_tree(runs[D][1], runs[1][1])):
            raise AssertionError(f"shard-train: step {i + 1} at D={D} is not bitwise D=1's")
        got, plain = float(losses[D][i]), float(losses["plain"][i])
        if abs(got - plain) > 1e-4 * max(1.0, abs(plain)):
            raise AssertionError(f"shard-train: step {i + 1}'s loss {got:.7g} leaves the step "
                                 f"without take_fn ({plain:.7g})")
        step_gap = max(leaf_gap(runs[D][0], runs["plain"][0]),
                       leaf_gap(runs[D][1], runs["plain"][1]))
        if not step_gap <= 1e-5:
            raise AssertionError(f"shard-train: after step {i + 1} a leaf at D={D} is "
                                 f"{step_gap:.3g} x max(1, max|leaf|) from the step without "
                                 f"take_fn, past 1e-5")
        gap = max(gap, step_gap)
        plain_bitwise &= torch.equal(losses[D][i], losses["plain"][i]) and same_tree(
            runs[D][0], runs["plain"][0])
    launched.update(counts[D])
    n = len(batches)
    per_step = {k: {g: c[g] / n for g in ("embedding_bag_kernel", "embedding_bag_backward_kernel",
                                          "bag_rows_radix_sort")} for k, c in counts.items()}
    if dev.type == "cuda":
        want = {D: 2 * D + 1, 1: 3, "plain": 1}
        for k, c in per_step.items():
            if set(c.values()) != {want[k]}:
                raise AssertionError(f"shard-train: launches a step at {k}: {c}, want "
                                     f"{want[k]} of kernels 5 and 5' each")
    med = {k: cell_ms(dev, c, (*runs[k], batches[0], c.args[3]), sz.strain_steps)
           for k, c in cells.items()}
    table = runs[D][0]["embedding"]
    del runs, cells
    gc.collect()
    offsets = torch.as_tensor(cfg.layout.slot_offsets.astype(np.int32), device=dev)
    arena = (batches[0]["ids"] + offsets).reshape(-1)
    rows = table.shape[0] // D
    g = torch.randn((arena.numel(), 1, cfg.embed_dim),
                    generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    ones = torch.ones((arena.numel(), 1), device=dev)
    bags = field_lookups.one_slot_bags(1, str(dev))
    out = torch.full_like(table, float("nan"))
    blocks, shares = [], []
    for s in range(D):
        lo = s * rows
        mine = (arena >= lo) & (arena < lo + rows)
        keyed = torch.where(mine, arena - lo, rows)[:, None].contiguous()
        shares.append(float(mine.float().mean()))
        blocks.append(functools.partial(ops.embedding_bag_backward, g, table[lo:lo + rows],
                                        keyed, ones, bags, out=out[lo:lo + rows]))
    whole_ids = arena[:, None].contiguous()
    whole_fn = functools.partial(ops.embedding_bag_backward, g, table, whole_ids, ones, bags)
    for fn in blocks:
        fn()
    whole = whole_fn()
    what = f"shard-train: kernel 5' a block at step 1's {arena.numel()} slots"
    if not torch.equal(out, whole):
        raise AssertionError(f"{what}: the blocks' out= rows are not one launch over the arena")
    want = ref.embedding_bag_vjp(table, whole_ids, ones, bags.segments, g)[0]
    diff = (whole - want).abs()
    del want
    size = ref.embedding_bag_vjp(table, whole_ids, ones, bags.segments, g.abs())[0]
    bad = diff > 1e-6 * size
    if bad.any() or not torch.isfinite(whole).all():
        raise AssertionError(f"{what}: {int(bad.sum())} values of one launch over the arena "
                             f"off ref.embedding_bag_vjp, max |diff| {float(diff.max()):.3g}")
    err = float(diff.max())
    del diff, size, bad
    block_ms = [device_ms(fn, 3, 5) if dev.type == "cuda" else None for fn in blocks]
    whole_ms = device_ms(whole_fn, 3, 5) if dev.type == "cuda" else None
    if not torch.equal(out, whole):
        raise AssertionError(f"{what}: the blocks' rows changed on repeated calls")
    del g, out, whole, table, blocks, whole_fn
    how = "CUDA events" if dev.type == "cuda" else "host clock"
    line = (f"(a) dplr-fwfm/train_batch B={B}, {cfg.layout.n_fields} fields k={cfg.embed_dim} "
            f"rho={cfg.rank}, a {padded_rows(cfg.layout.total_vocab)}-row arena in {D} blocks "
            f"of {rows}: {n} adagrad steps at D={D} bitwise D=1 (losses, params, accumulator "
            f"after every step; losses {float(losses[D][0]):.6f} -> {float(losses[D][-1]):.6f}), "
            f"within 1e-4 x max(1, |loss|) of the steps without take_fn ("
            f"{'bitwise' if plain_bitwise else 'not bitwise'}), every leaf of params and "
            f"accumulator within {gap:.3g} x max(1, max|leaf|) of them (<= 1e-5); median step "
            f"ms on batch 1 after a warm one ({sz.strain_steps} steps, {how}) D={D} "
            f"{med[D]:.3f}, D=1 {med[1]:.3f}, without take_fn {med['plain']:.3f}; launches a "
            f"step (kernel 5, 5' writer, 5' sort) D={D} {tuple(per_step[D].values())}, D=1 "
            f"{tuple(per_step[1].values())}, without {tuple(per_step['plain'].values())}; "
            f"kernel 5' a block at step 1's {arena.numel()} slots, foreign slots keyed out, "
            f"into one NaN-filled gradient: the blocks bitwise one launch over the arena, "
            f"which is within {err:.3g} of ref.embedding_bag_vjp (<= 1e-6 x sum |w g|); "
            + ", ".join(f"block {s} {_ms(t)} ({100 * f:.1f}% of the slots its own)"
                        for s, (t, f) in enumerate(zip(block_ms, shares)))
            + f", the whole arena in one launch {_ms(whole_ms)}")
    return line, batches[0]


def shard_serve_check(dev, sz, cfg, mesh, launched: collections.Counter) -> str:
    """(b): ``dplr-fwfm/serve_bulk``'s pointwise logits on ``mesh`` bitwise
    a one-shard mesh's, and against the cell without a mesh."""
    D = mesh.shape["model"]
    build = lambda m: steps.build("dplr-fwfm", "serve_bulk", device=dev, cfg=cfg,  # noqa: E731
                                  dims=sz.strain_serve_dims, mesh=m)
    cell = build(mesh)
    with counted(launched):
        got = cell.fn(*cell.args)
    t = cell_ms(dev, cell, cell.args, sz.strain_steps)
    del cell
    one = build(make_host_mesh(1, device=dev))
    same_bits(got, one.fn(*one.args), f"serve_bulk at D={D}", "D=1's logits")
    del one
    plain = build(None)
    want = plain.fn(*plain.args)
    t_plain = cell_ms(dev, plain, plain.args, sz.strain_steps)
    err = check_close(got, want, f"serve_bulk at D={D} against the cell without a mesh")
    bitwise = torch.equal(got, want)
    return (f"(b) dplr-fwfm/serve_bulk {got.shape[0]} rows: logits at D={D} bitwise D=1's, "
            f"{'bitwise' if bitwise else f'within {err:.3g} of'} the cell without a mesh; "
            f"median call after a warm one ({sz.strain_steps} calls) {t:.3f} ms at D={D}, "
            f"{t_plain:.3f} ms without")


def plain_compressed_psum(xs: list, errs: list) -> tuple:
    """``compression.compressed_psum``'s formula stated over the stacked
    positions, a block of rows at a time: one scale from the largest
    ``|x + e|`` of all, each position's int8 grid, their int32 sum times
    the scale over the count.  (mean, errors, scale)."""
    corr = [x + e for x, e in zip(xs, errs)]
    amax = max(float(c.abs().max()) for c in corr)
    scale = torch.clamp(torch.tensor(amax, dtype=torch.float32, device=xs[0].device),
                        min=1e-12) / 127.0
    flat = [c.reshape(-1) for c in corr]
    mean = torch.empty_like(flat[0])
    errors = [torch.empty_like(f) for f in flat]
    step = 1 << 24
    for lo in range(0, flat[0].numel(), step):
        X = torch.stack([f[lo:lo + step] for f in flat])
        Q = torch.clamp(torch.round(X / scale), -127, 127).to(torch.int8)
        E = X - Q.float() * scale
        for e, row in zip(errors, E):
            e[lo:lo + step] = row
        mean[lo:lo + step] = Q.to(torch.int32).sum(0).float() * scale / float(len(xs))
    return mean.view(xs[0].shape), [e.view(xs[0].shape) for e in errors], scale


def psum_check(dev, sz, cfg, mesh, batch) -> str:
    """(c): ``compressed_psum`` over ``D`` positions holding the gradients of
    (a)'s first batch cut in ``D`` parts (from (a)'s initial weights,
    through the sharded lookup), every leaf: each position's mean and
    error bitwise ``plain_compressed_psum``; every error within ``0.51
    scale`` (half a grid step, and a float32 rounding); the mean within
    ``0.51 scale`` of the exact mean; and on one position, mean + error
    bitwise the input."""
    D = mesh.shape["model"]
    params = fwfm.init(torch.Generator(device=dev).manual_seed(0), cfg)
    take = sharded.make_sharded_take(mesh)
    grad_fn = optim.value_and_grad(lambda p, c, b: fwfm.loss(p, c, b, take_fn=take))
    q = batch["ids"].shape[0] // D
    grads = [grad_fn(params, cfg, {k: v[s * q:(s + 1) * q] for k, v in batch.items()})[1]
             for s in range(D)]
    del params
    worst, scales = 0.0, {}
    for name in sorted(grads[0]):
        xs = [g[name] for g in grads]
        errs = [torch.zeros_like(x) for x in xs]
        outs, new = compression.compressed_psum(xs, errs)
        mean, want_err, scale = plain_compressed_psum(xs, errs)
        for s in range(D):
            same_bits(outs[s], mean, f"compressed_psum {name} position {s}",
                      "the plain formula's mean")
            same_bits(new[s], want_err[s], f"compressed_psum {name} error {s}",
                      "the plain formula's error")
        s_ = float(scale)
        worst = max(worst, max(float(e.abs().max()) for e in new) / s_)
        exact = functools.reduce(torch.add, xs) / D
        if float((outs[0] - exact).abs().max()) > 0.51 * s_ or worst > 0.51:
            raise AssertionError(f"compressed_psum {name}: off by more than 0.51 x scale")
        (o1,), (e1,) = compression.compressed_psum(xs[:1], errs[:1])
        if not torch.equal(o1 + e1, xs[0]):
            raise AssertionError(f"compressed_psum {name}: on one position mean + error is "
                                 f"not the input")
        scales[name] = s_
        del outs, new, mean, want_err, exact, o1, e1
    del grads
    gc.collect()
    return (f"(c) compressed_psum over {D} positions of step 1's gradients ({q} rows each), "
            f"every leaf: means and errors bitwise the plain formula, |x - x_hat| <= "
            f"{worst:.3f} scale (<= 0.51), means within 0.51 scale of the exact mean, on one "
            f"position mean + error bitwise the input; scales " + ", ".join(
                f"{k} {v:.3g}" for k, v in scales.items()))


# (d)'s gate on the two gradients: each leaf's largest |difference| over its
# largest entry.  The card read 0.018 (bf16 compute, run 2 of the slice); a
# sign flip reads 2, a zero gradient 1, a sum in place of the mean 3.
LM_GRAD_GAP = 0.05


def micro_batch_check(dev, sz) -> str:
    """(d): gemma3-1b's ``train_4k`` cell cut to ``sz.strain_lm_dims``, with
    its ``micro_batches`` microbatches and with one, from the same weights
    and tokens.  Each cell's gradient as the cells take it
    (``optim.gradient_accumulation`` and ``optim.value_and_grad`` of
    ``lm_loss`` under ``train.deterministic()``): the two within
    ``LM_GRAD_GAP`` of each leaf's largest entry.  Each cell's step: its
    loss and the parameters after it bitwise the cells' adamw (weight decay
    0.1, norm clip 1) applied to its gradient, so that the two steps'
    parameters differ only as adamw of the gated gradients does; the two
    losses within ``1e-4 max(1, |loss|)``.  Each cell's median step after a
    warm one and its peak memory above what it found (``measure_cell``)."""
    cfg = sz.strain_lm()
    n = cfg.micro_batches
    if n < 2:
        raise AssertionError(f"shard-train: {cfg.name} has micro_batches={n}")
    cfgs = {n: cfg, 1: dataclasses.replace(cfg, micro_batches=1)}
    build = lambda k: steps.build("gemma3-1b", "train_4k", device=dev, cfg=cfgs[k],  # noqa: E731
                                  dims=sz.strain_lm_dims)
    cell = build(n)
    params, _, batch, lr = cell.args
    loss_fn = lambda p, b: tm.lm_loss(p, cfg, b, device=dev)  # noqa: E731
    with train.deterministic():
        grads = {n: optim.gradient_accumulation(loss_fn, n)(params, batch),
                 1: optim.value_and_grad(loss_fn)(params, batch)}
    leaves = optim.optimizers.tree_leaves
    grad_gap = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(leaves(grads[n][1]), leaves(grads[1][1])))
    if not grad_gap <= LM_GRAD_GAP:
        raise AssertionError(f"shard-train: {n} microbatches' gradient {grad_gap:.3g} of a "
                             f"leaf's largest entry from one batch's, past {LM_GRAD_GAP}")
    opt = optim.adamw(weight_decay=0.1)
    stepped = {}
    with train.deterministic():
        for k, (_, g) in grads.items():
            p = rebuild(params, iter([x.clone() for _, x in flat_items(params)]))
            stepped[k] = opt.update(g, opt.init(p), p, lr)[0]
    losses = {k: v[0] for k, v in grads.items()}
    del grads
    gc.collect()
    p_gap = max(float((a - b).abs().max())
                for a, b in zip(leaves(stepped[n]), leaves(stepped[1])))
    ms, peak = {}, {}
    for k in (n, 1):
        cell = cell if k == n else build(k)
        loss, p, _ = cell.fn(*cell.args)
        if not (torch.equal(loss, losses[k]) and same_tree(p, stepped[k])):
            raise AssertionError(f"shard-train: the {k}-microbatch step is not adamw of its "
                                 f"gradient, bitwise")
        del loss, p, stepped[k]
        gc.collect()
        _sync(dev)
        base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        times, top = measure_cell(dev, cell, sz.strain_lm_steps)
        ms[k], peak[k] = float(np.median(times)), None if top is None else top - base
        del cell
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    lm, lo = float(losses[n]), float(losses[1])
    if abs(lm - lo) > 1e-4 * max(1.0, abs(lo)):
        raise AssertionError(f"shard-train: {n} microbatches' loss {lm:.7g} against one "
                             f"batch's {lo:.7g}")
    B, S = batch["tokens"].shape
    return (f"(d) {cfg.name} train_4k at {B} x {S}: {n} microbatches of {B // n} against one "
            f"batch from the same weights: loss {lm:.6f} against {lo:.6f}, gradients within "
            f"{grad_gap:.3g} of each leaf's largest entry (<= {LM_GRAD_GAP}), each step's "
            f"loss and parameters bitwise adamw of its gradient, parameters within "
            f"{p_gap:.3g} of each other (lr {float(lr):.3g}); median step after a warm one "
            f"({sz.strain_lm_steps} steps, {'CUDA events' if dev.type == 'cuda' else 'host clock'}) "
            f"{ms[n]:.1f} ms against {ms[1]:.1f} ms; peak memory above what the step found "
            f"{_mib(None if peak[n] is None else peak[n] / 2**20)} against "
            f"{_mib(None if peak[1] is None else peak[1] / 2**20)}")


def part_gnn_check(dev, sz, mesh) -> str:
    """(e): PNA's ``full_graph_sm+part`` on ``mesh``: in f32 compute, the
    partitioned loss and gradients against ``pna.loss`` on the same graph
    and weights, on the card, within ``1e-4 max(1, |loss|)`` (each gradient
    leaf: ``1e-4`` of its largest entry) plus twice the whole-graph path's
    own spread when its node features move one ulp up (the gnn phase's
    rule: the std aggregator's cancellation magnifies a last-bit
    difference).  The three f32 runs are under ``train.deterministic()``:
    with ``index_add_``'s atomics adding in any order, the spread was a
    fresh draw each run, and a low draw beside a high error refused a
    right program (on an H100 one leaf at 1.03 of its bound, where ten
    repeats alone gave 0.58-0.80); each run now repeats bitwise, so the
    verdict does too (0.603 there).  Then the bf16 cell's adamw steps on
    that partitioned graph, every loss finite, and as many more timed
    after a warm one (``measure_cell``)."""
    D = mesh.shape["model"]
    shape = next(s for s in pna_cfg.SHAPES if s.name == "full_graph_sm")
    if sz.strain_gnn_dims:
        shape = dataclasses.replace(shape, dims={**shape.dims, **sz.strain_gnn_dims})
    base = sz.gnn_make()
    cfg32 = dataclasses.replace(pna_cfg.shape_config(base, shape), compute_dtype=torch.float32)
    n, E = steps.gnn_sizes(shape)
    N_p = -(-n // D) * D
    rng = np.random.default_rng(sz.gnn_seed)
    src = rng.integers(0, n, E).astype(np.int32)
    dst = rng.integers(0, n, E).astype(np.int32)
    label_mask = np.zeros(N_p, np.float32)
    label_mask[:n] = 1
    nodes = {"node_feat": rng.standard_normal((N_p, cfg32.d_feat), dtype=np.float32),
             "labels": rng.integers(0, cfg32.n_classes, N_p).astype(np.int32),
             "label_mask": label_mask}
    part, e_loc = sampler.partition_graph(src, dst, N_p, D)
    whole = train.to_device(dict(nodes, edge_src=src, edge_dst=dst,
                                 edge_mask=np.ones(E, np.float32)), dev)
    pbatch = train.to_device(dict(nodes, **part), dev)
    params = pna.init(torch.Generator(device=dev).manual_seed(0), cfg32)
    grad_whole = optim.value_and_grad(pna.loss)
    feat = whole["node_feat"]
    nudged = dict(whole, node_feat=torch.nextafter(feat, torch.full_like(feat, np.inf)))
    with train.deterministic():
        want, gw = grad_whole(params, cfg32, whole)
        wn, gn = grad_whole(params, cfg32, nudged)
        got, gg = optim.value_and_grad(
            lambda p, c, b: pna.loss_partitioned(p, c, b, mesh=mesh))(params, cfg32, pbatch)
    spread = abs(float(wn) - float(want))
    bound = 1e-4 * max(1.0, abs(float(want))) + 2 * spread
    if abs(float(got) - float(want)) > bound:
        raise AssertionError(f"shard-train: partitioned PNA loss {float(got):.7g} against "
                             f"{float(want):.7g} (bound {bound:.3g})")
    leaves = optim.optimizers.tree_leaves
    worst = share = 0.0
    for a, b, c in zip(leaves(gg), leaves(gw), leaves(gn)):
        err = float((a - b).abs().max())
        lim = 1e-4 * float(b.abs().max()) + 2 * float((c - b).abs().max())
        if not err <= lim + 1e-30:
            raise AssertionError(f"shard-train: partitioned PNA gradient off by {err:.3g} "
                                 f"(bound {lim:.3g})")
        worst = max(worst, err / max(float(b.abs().max()), 1e-30))
        share = max(share, err / (lim + 1e-30))
    cell = steps.build("pna", "full_graph_sm", device=dev, cfg=base, dims=sz.strain_gnn_dims,
                       opts={"partitioned": True}, mesh=mesh)
    p16, s16, _, lr = cell.args
    losses = []
    for _ in range(sz.strain_gnn_steps):
        loss, p16, s16 = cell.fn(p16, s16, pbatch, lr)
        losses.append(float(loss))
    if not np.isfinite(losses).all():
        raise AssertionError(f"shard-train: partitioned PNA bf16 losses {losses}")
    ms = cell_ms(dev, cell, (p16, s16, pbatch, lr), sz.strain_gnn_steps)
    return (f"(e) {cell.name} at D={D}: {n} nodes, {E} edges, {e_loc} edge slots a shard; "
            f"f32 loss {float(got):.6f} against the whole graph's {float(want):.6f} "
            f"(|diff| {abs(float(got) - float(want)):.3g} <= {bound:.3g}, spread "
            f"{spread:.3g}), gradients within {worst:.3g} of each leaf's largest entry and "
            f"{share:.3g} of their bounds (deterministic algorithms); bf16: {len(losses)} adamw steps, losses {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, then {sz.strain_gnn_steps} more after a warm one: median step "
            f"{ms:.3f} ms")


def shard_train_phase(dev, sz) -> dict:
    """The training half of sharding on ``make_host_mesh(sz.shards)`` (four
    shards sharing the one card): (a)-(e) above.  Returns the launches of
    kernels 5 and 5' in (a)'s sharded steps and (b)'s sharded call."""
    t_phase = time.perf_counter()
    mesh = make_host_mesh(sz.shards, device=dev)
    cfg = sz.make_config()
    launched = collections.Counter()
    lines = []
    line, first = shard_train_recsys(dev, sz, cfg, mesh, launched)
    lines.append(line)
    gc.collect()
    lines.append(shard_serve_check(dev, sz, cfg, mesh, launched))
    gc.collect()
    lines.append(psum_check(dev, sz, cfg, mesh, first))
    del first
    gc.collect()
    lines.append(micro_batch_check(dev, sz))
    gc.collect()
    lines.append(part_gnn_check(dev, sz, mesh))
    gc.collect()
    out = {g: launched[g] for entry in SHARD_TRAIN_KERNELS for g in ops.KERNELS[entry]}
    if dev.type == "cuda" and not all(out.values()):
        raise AssertionError(f"shard-train: a kernel of the sharded lookup did not launch: {out}")
    wall = time.perf_counter() - t_phase
    if dev.type == "cuda" and wall > sz.strain_seconds:
        raise AssertionError(f"shard-train: {wall:.1f} s, past {sz.strain_seconds} s")
    print(f"phase shard-train: {sz.shards} shards on {', '.join(map(str, mesh.devices))}; "
          + "; ".join(lines) + f"; launches {out}; wall {wall:.1f} s", flush=True)
    return out


# -- phase 5d: data -------------------------------------------------------------

# the entry points the data phase's lookups drive: kernel 5 on every (replica,
# block) and once a replica over its gathered rows, into the field bags; kernel
# 5' on every (replica, block) and once a replica
DATA_KERNELS = ("embedding_bag", "embedding_bag_backward")
# an arena gradient summed in another order, per element, against the summed
# magnitude of its terms (kernel 5''s bound in the shard-train phase)
BAG_GRAD_TOL = 1e-6


def two_by_two(dev) -> Mesh:
    """A (2, 2) mesh, every position on ``dev``: two data replicas of two
    arena blocks (the ``Mesh`` constructor, as ``jax.make_mesh`` in the
    reference's tests)."""
    return Mesh(("data", "model"), (2, 2), (dev,) * 4)


def replica_arena_grads(params, cfg, rows: dict) -> tuple:
    """One replica's gradients of the embedding and first-order tables by
    the plain path on its ``rows`` (the plain dense part's cotangents into
    ``ref.embedding_bag_vjp`` and an ``index_add_``), and per element the
    summed magnitude of their terms (the bound's sum |w g|: ``dV_size``
    through the vjp, ``|dL/dlogit| |w|`` into each slot's row)."""
    ids, w, label = rows["ids"], rows["weights"], rows["label"]
    table, segs = params["embedding"], cfg.layout.slot_to_field
    off = torch.as_tensor(cfg.layout.slot_offsets.astype(np.int64), device=ids.device)
    arena = ids.long() + off
    V = plain_fields(table, cfg.layout, ids, w).detach().requires_grad_()
    with torch.enable_grad():
        logits = plain_logits(params, cfg, ids, w, V=V)
        dV, dlogit = torch.autograd.grad(bce(logits, label), (V, logits))
    emb = ref.embedding_bag_vjp(table, arena, w, segs, dV)[0]
    emb_size = ref.embedding_bag_vjp(table, arena, w.abs(), segs,
                                     dV_size(params, cfg, V.detach(), ids, w, label))[0]
    flat = arena.reshape(-1)
    lin = torch.zeros_like(params["linear"]).index_add_(0, flat, (dlogit[:, None] * w).reshape(-1))
    lin_size = torch.zeros_like(params["linear"]).index_add_(
        0, flat, (dlogit.abs()[:, None] * w.abs()).reshape(-1))
    return emb, lin, emb_size, lin_size


def replicas_plain_grads(params, cfg, batch, mesh, batch_specs) -> list:
    """``replica_arena_grads`` on each data replica's rows of ``batch``,
    their mean over the replicas taken in position order, as the mesh's
    all-reduce takes it."""
    total = None
    for r in range(mesh.dp):
        rows = {k: rules.local_block(v, batch_specs[k], mesh, mesh.replica(r).coords(0))
                for k, v in batch.items()}
        got = replica_arena_grads(params, cfg, rows)
        total = list(got) if total is None else [t.add_(x) for t, x in zip(total, got)]
        del got
    return [t.div_(mesh.dp) for t in total]


def data_grad_check(cfg, params, batch, mesh, batch_specs) -> str:
    """Step 1's loss and gradients on ``mesh`` (``train.data_parallel_grads``:
    each replica's rows, the mean over the data axis).  Against the
    unsharded step's (``optim.value_and_grad`` of ``fwfm.loss``) from the
    same weights: the loss within ``TOL * max(1, |loss|)``, every
    gradient leaf within ``TOL * max|g|`` of its (the dense products may
    round differently at another batch size on the card).  And each
    element of the embedding and first-order tables' gradients within
    ``BAG_GRAD_TOL`` times its terms' summed magnitude of the plain path
    on the same replicas' rows, their mean taken in the same order
    (``replica_arena_grads``: the same dense arithmetic, the sums in
    another order); a row no slot names exactly 0."""
    loss, got, _ = train.data_parallel_grads(fwfm, cfg, params, batch, mesh=mesh,
                                             batch_specs=batch_specs)
    want_loss, want = optim.value_and_grad(fwfm.loss)(params, cfg, batch)
    check_close(loss, want_loss, "data: step 1's loss on the mesh")
    parts = []
    for name in sorted(got):
        err, scale = (float(t) for t in ((got[name] - want[name]).abs().max(),
                                         want[name].abs().max()))
        if not err <= TOL * scale or not torch.isfinite(got[name]).all():
            raise AssertionError(f"data: step 1's d_{name} on the mesh off by {err:.3g} from "
                                 f"the unsharded step's (max |d_{name}| {scale:.3g})")
        parts.append(f"d_{name} {err:.3g} of max {scale:.3g}")
    del want
    mean = replicas_plain_grads(params, cfg, batch, mesh, batch_specs)
    worst = []
    for name, ref_g, size in (("embedding", mean[0], mean[2]), ("linear", mean[1], mean[3])):
        diff = (got[name] - ref_g).abs()
        bad = diff > BAG_GRAD_TOL * size
        if bad.any():
            raise AssertionError(f"data: step 1's d_{name} on the mesh: {int(bad.sum())} "
                                 f"elements past {BAG_GRAD_TOL} x sum |w g| of the plain path "
                                 f"on the replicas' rows, max |diff| {float(diff.max()):.3g}")
        worst.append(f"d_{name} {float(diff.max()):.3g}")
        del diff, bad
    return (f"against the unsharded step {', '.join(parts)}; against the plain path on the "
            f"replicas' rows {', '.join(worst)} (<= {BAG_GRAD_TOL} x sum |w g| each element)")


def timed(dev, fn, times: list):
    """``fn()``, its time (CUDA events; the host clock off the card)
    appended to ``times``."""
    if dev.type == "cuda":
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    else:
        times.append((time.perf_counter() - t0) * 1e3)
    return out


def timed_step(dev, cell, state: list, batch, times: list):
    """One step of ``cell`` on ``state`` ([params, opt_state], replaced),
    timed (``timed``)."""
    loss, params, opt = timed(dev, lambda: cell.fn(*state, batch, cell.args[3]), times)
    state[:] = [params, opt]
    return loss


def cloned(tree: dict) -> dict:
    return {k: cloned(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


# float32's unit roundoff, and the elements a chunk of ``adagrad_gap``'s
# float64 arithmetic
F32_EPS = float(torch.finfo(torch.float32).eps)
GAP_CHUNK = 1 << 24


def adagrad_gap(g, delta, p_e, a_e, p_m, a_m, lr: float) -> tuple[float, int]:
    """Per element, how far an adagrad update (``p_m``, ``a_m``) is from the
    one that the gradient ``g`` gives from the same start (``p_e``,
    ``a_e``), over the most that a gradient off by ``delta`` (a tensor of
    ``g``'s shape, or a number) can move it: ``a += g^2`` by ``delta (2|g|
    + delta)``, ``p -= lr g / (sqrt(a) + eps)`` by ``lr (delta / sqrt(a) +
    |g| da / (2 a^1.5))`` at the smaller ``a`` of the two, with float32's
    roundings of both updates beside.  Returns (the largest ratio, the
    elements past 1), in float64 a chunk at a time."""
    worst, bad = 0.0, 0
    flat = [t.reshape(-1) if torch.is_tensor(t) else t for t in (g, delta, p_e, a_e, p_m, a_m)]
    for lo in range(0, flat[0].numel(), GAP_CHUNK):
        g_, d_, pe, ae, pm, am = (t[lo:lo + GAP_CHUNK].double() if torch.is_tensor(t) else t
                                  for t in flat)
        a_lo = torch.minimum(ae, am)
        da = d_ * (2 * g_.abs() + d_) + 4 * F32_EPS * ae
        dp = (lr * (d_ / a_lo.sqrt() + g_.abs() * da / (2 * a_lo ** 1.5))
              + 8 * F32_EPS * lr * g_.abs() / ae.sqrt() + 2 * F32_EPS * pe.abs())
        for diff, bound in (((am - ae).abs(), da), ((pm - pe).abs(), dp)):
            ratio = torch.where(diff == 0, 0.0, diff / bound)
            worst = max(worst, float(ratio.max()))
            bad += int((ratio > 1).sum())
    return worst, bad


def data_train(dev, sz, cfg, launched: collections.Counter) -> str:
    """(a): ``dplr-fwfm/train_batch`` at ``sz.data_dims`` on the (2, 2) mesh
    beside the unsharded step and ``make_host_mesh(sz.shards)``, every cell
    from the one seed's weights, ``sz.data_steps`` adagrad steps on the
    same batches.  Step 1's gradients (``data_grad_check``).  Every step
    from the (2, 2) run's state beside the unsharded step's work from a
    copy of it (``optim.value_and_grad`` of ``fwfm.loss``, then adagrad's
    update, fed the embedding and first-order tables' gradients of the
    plain path on the replicas' rows, ``replicas_plain_grads``: the card
    rounds the unsharded cotangents differently at another batch size):
    the loss within ``TOL * max(1, |loss|)`` of the unsharded loss, and
    every element of the updated parameters and accumulator within
    ``adagrad_gap``'s bound of the copy's, the gradient's ``delta``
    ``BAG_GRAD_TOL`` times the summed magnitude of the terms for those
    two tables and ``TOL * max|g|`` for a dense leaf
    (``data_grad_check``'s bounds).  A second (2, 2) run
    bitwise the first (losses, parameters, accumulator); the (1, D) mesh's
    steps bitwise the step that the cell made before the data axis
    (``train.train_step`` with ``make_auto_take``) after every step; on
    the card ``dp (2 D' + 1)`` launches of kernels 5 and 5' a step on a
    mesh of dp replicas of D' blocks.  Each run's median step (its checked
    steps, one at a time)."""
    m22, m1d = two_by_two(dev), make_host_mesh(sz.shards, device=dev)
    build = lambda mesh: steps.build("dplr-fwfm", "train_batch", device=dev,  # noqa: E731
                                     cfg=cfg, dims=sz.data_dims, mesh=mesh)
    cell = build(m22)
    B, lr = cell.args[2]["ids"].shape[0], cell.args[3]
    batches = field_batches(cfg, B, sz.data_steps, dev, seed=6)
    grad_line = data_grad_check(cfg, cell.args[0], batches[0], m22, cell.specs["batch"])
    state = list(cell.args[:2])
    times = {k: [] for k in ("2x2", "plain", "1xD")}
    losses, counts, worst = [], collections.Counter(), {}
    for i, batch in enumerate(batches):
        start = [cloned(state[0]), cloned(state[1])]
        emb, lin, emb_size, lin_size = replicas_plain_grads(start[0], cfg, batch, m22,
                                                            cell.specs["batch"])
        with counted(counts):
            loss = timed_step(dev, cell, state, batch, times["2x2"])

        def unsharded():
            plain_loss, g = optim.value_and_grad(fwfm.loss)(start[0], cfg, batch)
            g = {**g, "embedding": emb, "linear": lin}
            optim.adagrad().update(g, start[1], start[0], lr)
            return plain_loss, g

        want, g_e = timed(dev, unsharded, times["plain"])
        losses.append(loss)
        check_close(loss, want, f"data: step {i + 1}'s loss at (2, 2)")
        deltas = {"embedding": BAG_GRAD_TOL * emb_size, "linear": BAG_GRAD_TOL * lin_size}
        for name, g in flat_items(g_e):
            delta = deltas.get(name, TOL * float(g.abs().max()))
            ratio, bad = adagrad_gap(g, delta, start[0][name], start[1]["acc"][name],
                                     state[0][name], state[1]["acc"][name], float(lr))
            if bad:
                raise AssertionError(f"data: after step {i + 1} {bad} elements of {name} or "
                                     f"its accumulator at (2, 2) past the bound of the "
                                     f"unsharded step's update (worst {ratio:.3g} x)")
            worst[name] = max(worst.get(name, 0.0), ratio)
        del start, emb, lin, emb_size, lin_size, g_e, deltas
    gc.collect()
    again = build(m22)
    mine = list(again.args[:2])
    for i, batch in enumerate(batches):
        loss, *mine = again.fn(*mine, batch, again.args[3])
        if not torch.equal(loss, losses[i]):
            raise AssertionError(f"data: a second run's step {i + 1} loss at (2, 2) is not "
                                 f"bitwise the first's")
    if not (same_tree(mine[0], state[0]) and same_tree(mine[1], state[1])):
        raise AssertionError("data: a second run at (2, 2) is not bitwise the first")
    del again, mine, cell, state
    gc.collect()
    D = sz.shards
    ours, today = build(m1d), build(m1d)
    take = SimpleNamespace(loss=lambda p, c, b: fwfm.loss(p, c, b,
                                                          take_fn=steps.make_auto_take(m1d)))
    mine, theirs = list(ours.args[:2]), list(today.args[:2])
    for i, batch in enumerate(batches):
        loss = timed_step(dev, ours, mine, batch, times["1xD"])
        want, *theirs = train.train_step(take, cfg, optim.adagrad(), *theirs, batch,
                                         today.args[3])
        if not (torch.equal(loss, want) and same_tree(mine[0], theirs[0])
                and same_tree(mine[1], theirs[1])):
            raise AssertionError(f"data: step {i + 1} on (1, {D}) is not bitwise the step "
                                 f"before the data axis")
    del ours, today, mine, theirs
    gc.collect()
    n = len(batches)
    per_step = {g: counts[g] / n for entry in DATA_KERNELS for g in ops.KERNELS[entry]}
    if dev.type == "cuda" and set(per_step.values()) != {2 * (2 * 2 + 1)}:
        raise AssertionError(f"data: launches a step at (2, 2): {per_step}, want 10 of "
                             f"kernels 5 and 5' each")
    launched.update(counts)
    med = {k: float(np.median(v)) for k, v in times.items()}
    shown = tuple(per_step[g] for g in ("embedding_bag_kernel", "embedding_bag_backward_kernel",
                                        "bag_rows_radix_sort"))
    how = "CUDA events" if dev.type == "cuda" else "host clock"
    gaps = ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items()))
    return (f"(a) dplr-fwfm/train_batch B={B} ({B // 2} rows a replica), "
            f"{cfg.layout.n_fields} fields k={cfg.embed_dim} rho={cfg.rank}, a "
            f"{padded_rows(cfg.layout.total_vocab)}-row arena in 2 blocks a replica: step 1 "
            f"on (2, 2) against the unsharded step: {grad_line}; {n} adagrad steps, losses "
            f"{float(losses[0]):.6f} -> {float(losses[-1]):.6f} within 1e-5 x max(1, |loss|) "
            f"of the unsharded step's from the same state, every element of params and "
            f"accumulator within the bound of the update of the plain gradients (worst share "
            f"of the bound: {gaps}); "
            f"a second run at (2, 2) bitwise the first; (1, {D}) bitwise the step before the "
            f"data axis after every step; median step ms ({n} steps, {how}) (2, 2) "
            f"{med['2x2']:.3f}, (1, {D}) {med['1xD']:.3f}, unsharded {med['plain']:.3f}; "
            f"launches a step at (2, 2) (kernel 5, 5' writer, 5' sort) {shown}")


def data_serve(dev, sz, cfg, launched: collections.Counter) -> str:
    """(b): ``dplr-fwfm/serve_bulk`` and ``retrieval_cand`` at
    ``sz.data_serve_dims`` and ``sz.data_retrieval_dims`` on the (2, 2) mesh
    (each replica its rows or its items) against the unsharded cell:
    bitwise, else within ``TOL * max(1, |x|)`` (cuBLAS may round a product
    differently at another batch size)."""
    parts = []
    for shape, dims in (("serve_bulk", sz.data_serve_dims),
                        ("retrieval_cand", sz.data_retrieval_dims)):
        cell = steps.build("dplr-fwfm", shape, device=dev, cfg=cfg, dims=dims,
                           mesh=two_by_two(dev))
        with torch.no_grad(), counted(launched):
            got = cell.fn(*cell.args)
        del cell
        plain = steps.build("dplr-fwfm", shape, device=dev, cfg=cfg, dims=dims)
        with torch.no_grad():
            want = plain.fn(*plain.args)
        del plain
        err = check_close(got, want, f"data: {shape} at (2, 2)")
        parts.append(f"{shape} {tuple(got.shape)} "
                     + ("bitwise" if torch.equal(got, want) else f"within {err:.3g} of")
                     + " the unsharded cell's")
        del got, want
        gc.collect()
    return "(b) on (2, 2): " + ", ".join(parts)


def data_phase(dev, sz) -> dict:
    """The mesh's data axis for the recsys family, all positions of a (2, 2)
    mesh on the one card: (a) and (b) above.  Returns the launches of every
    kernel over the phase (kernels 5 and 5' in (a) and (b), kernel 3 in
    ``retrieval_cand``); on the card kernels 5 and 5' must have launched."""
    t_phase = time.perf_counter()
    if dev.type == "cuda":
        _sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = sz.make_config()
    launched = collections.Counter()
    lines = [data_train(dev, sz, cfg, launched)]
    gc.collect()
    lines.append(data_serve(dev, sz, cfg, launched))
    lookup = {g: launched[g] for entry in DATA_KERNELS for g in ops.KERNELS[entry]}
    if dev.type == "cuda" and not all(lookup.values()):
        raise AssertionError(f"data: a kernel of the data-parallel lookup did not launch: "
                             f"{lookup}")
    out = {**lookup, **launched}
    peak = "not measured" if dev.type != "cuda" else \
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
    print(f"phase data: (2, 2) mesh, 4 positions on {dev}; " + "; ".join(lines)
          + f"; launches over the phase {out}; peak memory {peak} (max_memory_allocated); "
          f"wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


# -- phase 5c: the LM family on the mesh -----------------------------------------

# The lm-mesh phase's bounds against the one-device cell from the same weights
# and tokens, bf16 compute on both (the mesh sums its positions' partial
# products, each rounded to bf16, where one device rounds one product): each
# step's loss within LM_MESH_LOSS x max(1, |loss|); the logits, the caches and
# the decode step's written slot no further from the one-device f32 run's than
# LM_MESH_F32 times the one-device bf16 run's distance from it (the CPU
# rehearsal at the smoke widths read 0.62-1.21 on logits and caches); step 1's
# gradient leaf by leaf: its largest distance from the one-device f32 leaf at
# most LM_MESH_F32 times the one-device bf16 leaf's, plus LM_MESH_FLOOR of the
# f32 leaf's largest entry (a bf16 rounding of that entry), so that a leaf
# whose bf16 gradient happens to sit near the f32 one is not held to less.
LM_MESH_LOSS = 1e-3
LM_MESH_F32 = 2.0
LM_MESH_FLOOR = 2.0**-8


def mesh_grid(sizes: tuple, dev) -> Mesh:
    return Mesh(("data", "model"), sizes, (dev,) * math.prod(sizes))


def joined(plan, blocks: list, params: dict) -> dict:
    """The whole gradient tree from each position's blocks (the one
    process's join): each block from its first holder, the copy that
    ``train.lm_data_parallel_step`` updates with; every other holder's copy
    must be bitwise that one."""
    whole = rebuild(params, iter([torch.empty_like(p) for _, p in flat_items(params)]))
    leaves = [p for _, p in flat_items(whole)]
    specs = [s for _, s in flat_items(plan.specs)]
    first = {}
    for pos, fl in zip(plan.pos, blocks):
        for li, (leaf, spec, g) in enumerate(zip(leaves, specs, fl)):
            key = (li, tuple(rules.block_index(e, plan.mesh, pos)[0] for e in spec))
            if key not in first:
                first[key] = pos
                rules.local_block(leaf, spec, plan.mesh, pos).copy_(g)
            elif not torch.equal(g, rules.local_block(leaf, spec, plan.mesh, pos)):
                raise AssertionError(f"lm-mesh: position {pos}'s copy of leaf {li}'s block is "
                                     f"not its first holder {first[key]}'s")
    return whole


def held(got, want, f32, what: str) -> float:
    """``max |got - f32|`` over ``LM_MESH_F32 max |want - f32|`` (plus f32's
    unit roundoff of ``max |f32|``), which must be at most 1."""
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"lm-mesh: non-finite {what}")
    err = _max_diff(got, f32)
    ratio = err / (LM_MESH_F32 * _max_diff(want, f32) + 2.0**-24 * float(f32.float().abs().max()))
    if not ratio <= 1.0:
        raise AssertionError(f"lm-mesh: {what} {err:.4g} from the one-device f32 run's, "
                             f"{ratio:.3g} x {LM_MESH_F32} x the one-device bf16 run's distance")
    return ratio


def counted_collectives(arch, shape, cfg, dims, mesh) -> str:
    """The same cut counted on ``meta`` a device of ``mesh``: its
    collectives' bytes by kind."""
    meta_mesh = Mesh(mesh.axis_names, tuple(mesh.shape.values()),
                     ("meta",) * mesh.size)
    cell = steps.build(arch, shape, "meta", cfg=cfg, dims=dims, mesh=meta_mesh)
    got = cost.analyze(cell.fn, *cell.args, mesh=meta_mesh, specs=cell.arg_specs())
    kinds = {k: v["total_bytes"] for k, v in got["collective_bytes"].items() if v["count"]}
    return "counted a device: " + ", ".join(f"{k} {v}" for k, v in kinds.items()) + \
        f" B (peak_bytes {got['peak_bytes'] / 2**30:.2f} GiB)"


def leaf_gaps(g: dict, f32: dict) -> dict:
    """Each leaf's ``max|g - f32|`` over ``max|f32|`` (largest entry 0: 0
    where they agree)."""
    return {k: float((a.float() - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for (k, a), (_, b) in zip(flat_items(g), flat_items(f32))}


def gradient_gaps(arch: str, sizes, g_m: dict, g_u: dict, g_f: dict) -> str:
    """Step 1's gradient on the mesh ``g_m`` leaf by leaf against one
    device's f32 gradient ``g_f``: each leaf's gap (``leaf_gaps``) at most
    ``LM_MESH_F32`` times one device's bf16 leaf's plus ``LM_MESH_FLOOR``.
    Returns a note of the readings: the worst leaf by its ratio to its
    bound, and the largest gaps, mesh / one device."""
    mesh_g, one = leaf_gaps(g_m, g_f), leaf_gaps(g_u, g_f)
    ratio = {k: mesh_g[k] / (LM_MESH_F32 * one[k] + LM_MESH_FLOOR) for k in mesh_g}
    worst = max(ratio, key=ratio.get)
    if not ratio[worst] <= 1.0:
        raise AssertionError(f"lm-mesh: {arch} step 1's gradient on {sizes}: leaf {worst} "
                             f"{mesh_g[worst]:.3g} of its largest entry from one device's f32 "
                             f"leaf, past {LM_MESH_F32} x one device's bf16 leaf's "
                             f"{one[worst]:.3g} + {LM_MESH_FLOOR:.3g}")
    top = max(mesh_g, key=mesh_g.get)
    return (f"(mesh / one device's bf16 gap from one device's f32, of a leaf's largest entry) "
            f"worst against its bound {worst} {mesh_g[worst]:.3g} / {one[worst]:.3g} "
            f"({ratio[worst]:.3g} of the bound), largest {top} {mesh_g[top]:.3g} / "
            f"{one[top]:.3g}, median over {len(ratio)} leaves of the ratio "
            f"{float(np.median(list(ratio.values()))):.3g}")


def mesh_train(dev, sz, arch: str, cfg, dims, sizes) -> str:
    """``arch/train_4k`` cut to ``dims`` on a ``sizes`` mesh, beside the
    one-device cell from the same weights and tokens: step 1's loss and
    gradients (``train.lm_data_parallel_grads``, joined) within the bounds
    above; ``sz.lm_mesh_steps`` adamw steps of each, each step's loss
    within ``LM_MESH_LOSS``; a second mesh run bitwise the first (losses
    and every parameter and state leaf); the median step of each and the
    mesh run's peak memory."""
    mesh = mesh_grid(sizes, dev)
    cell = steps.build(arch, "train_4k", device=dev, cfg=cfg, dims=dims, mesh=mesh)
    params, opt, batch, lr = cell.args
    n_micro = min(cfg.micro_batches, max(batch["tokens"].shape[0] // mesh.dp, 1))
    note = ""
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    with train.deterministic():
        plain_n = min(cfg.micro_batches, batch["tokens"].shape[0])

        def one_device(c):
            loss_fn = lambda p, b: tm.lm_loss(p, c, b, device=dev)  # noqa: E731
            return (optim.gradient_accumulation(loss_fn, plain_n) if plain_n > 1 else
                    optim.value_and_grad(loss_fn))(params, batch)

        with routed() as rec:
            loss_u, g_u = one_device(cfg)
        with routed(force=rec.own if cfg.is_moe else None):
            _, g_f = one_device(f32)
        if cfg.is_moe and (n_micro != 1 or plain_n != 1):
            raise AssertionError(f"lm-mesh: {arch}'s routes are held with one microbatch")
        plan = cell.plan
        # step 1 under the one device's routes, routing by routing (the
        # forward's L, then a remat recompute's)
        with routed(force=rec.own, plan=plan) if cfg.is_moe else \
                contextlib.nullcontext() as mrec:
            loss_m, blocks = train.lm_data_parallel_grads(plan, params, batch, n_micro)
        if cfg.is_moe:
            flips = route_diff(mrec.own[:cfg.n_layers], rec.own[:cfg.n_layers], cfg.moe_cfg)
            note = (" (under the one device's routes; the mesh's own against them: "
                    + _share(flips, cfg.n_layers * batch["tokens"].numel()) + ")")
        g_m = joined(plan, blocks, params)
        del blocks
    gap = gradient_gaps(arch, sizes, g_m, g_u, g_f)
    del g_m, g_u, g_f
    gc.collect()
    # the one-device steps first (an MoE model's routes recorded a step), then
    # the mesh's under those routes, twice
    times = {"mesh": [], "one": []}
    plain = steps.build(arch, "train_4k", device=dev, cfg=cfg, dims=dims)
    if not torch.equal(plain.args[2]["tokens"], batch["tokens"]):
        raise AssertionError("lm-mesh: the one-device cell drew other tokens")
    pstate, want, routes = list(plain.args[:2]), [], []
    for _ in range(sz.lm_mesh_steps):
        with routed() as rec:
            want.append(timed_step(dev, plain, pstate, batch, times["one"]))
        routes.append(rec.own)
    del plain, pstate
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        _sync(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    state, losses, worst_l = [params, opt], [], 0.0
    for i in range(sz.lm_mesh_steps):
        with routed(force=routes[i], plan=cell.plan) if cfg.is_moe else \
                contextlib.nullcontext():
            losses.append(timed_step(dev, cell, state, batch, times["mesh"]))
        gap_l = abs(float(losses[i]) - float(want[i])) / max(1.0, abs(float(want[i])))
        if not gap_l <= LM_MESH_LOSS:
            raise AssertionError(f"lm-mesh: {arch} step {i + 1}'s loss on {sizes} "
                                 f"{float(losses[i]):.7g} against one device's "
                                 f"{float(want[i]):.7g}")
        worst_l = max(worst_l, gap_l)
    peak = None if dev.type != "cuda" else torch.cuda.max_memory_allocated(dev) - base
    again = steps.build(arch, "train_4k", device=dev, cfg=cfg, dims=dims, mesh=mesh)
    mine = list(again.args[:2])
    for i in range(sz.lm_mesh_steps):
        with routed(force=routes[i], plan=again.plan) if cfg.is_moe else \
                contextlib.nullcontext():
            loss, *mine = again.fn(*mine, batch, lr)
        if not torch.equal(loss, losses[i]):
            raise AssertionError(f"lm-mesh: {arch} on {sizes}: a second run's step {i + 1} "
                                 f"loss is not bitwise the first's")
    if not (same_tree(mine[0], state[0]) and same_tree(mine[1], state[1])):
        raise AssertionError(f"lm-mesh: {arch} on {sizes}: a second run is not bitwise the "
                             f"first")
    del again, mine, state, cell
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    med = {k: float(np.median(v)) for k, v in times.items()}
    B, S = batch["tokens"].shape
    routes_note = " under the one device's routes" if cfg.is_moe else ""
    return (f"{arch} train_4k {B} x {S} on {sizes} ({cfg.n_layers} layers, fsdp={cfg.fsdp}, "
            f"{n_micro} microbatch(es) a replica; {cell_plan(plan)}): step 1's loss "
            f"{float(loss_m):.6f} against one device's {float(loss_u):.6f}, gradients "
            f"leaf by leaf {gap}{note}; "
            f"{sz.lm_mesh_steps} steps{routes_note}, "
            f"losses within {worst_l:.3g} x max(1, |loss|) (<= {LM_MESH_LOSS}); a second "
            f"run bitwise the first; median step ms (CUDA events) mesh {med['mesh']:.1f}, one "
            f"device {med['one']:.1f}; peak memory of the mesh steps "
            f"{_mib(None if peak is None else peak / 2**20)}; "
            + counted_collectives(arch, "train_4k", cfg, dims, mesh))


def cell_plan(plan) -> str:
    cfg = plan.cfg
    what = f"{cfg.n_heads // plan.m} heads a position" if plan.heads else "query rows a position"
    if not plan.kv_whole and plan.heads:
        what += ", the kv heads they read gathered"
    if cfg.is_moe:
        what += (f", {cfg.n_experts // plan.m} experts a position"
                 if rules.expert_parallel(cfg, plan.mesh) else
                 f", d_ff {cfg.d_ff // plan.m} of every expert a position")
    return what


def first_flash(record: list):
    """Wraps ``ops.flash_attention``: the first call's inputs kept in
    ``record``."""
    real = ops.flash_attention

    def wrapper(q, k, v, *, window=None, q_offset=0):
        if not record:
            record.append((q.clone(), k.clone(), v.clone(), window, q_offset))
        return real(q, k, v, window=window, q_offset=q_offset)

    return real, wrapper


def mesh_serve(dev, sz, arch: str, cfg, dims, sizes, decode_slots) -> tuple[str, dict]:
    """``arch/prefill_32k`` cut to ``dims`` on a ``sizes`` mesh beside the
    one-device function (``model.prefill``) on the same weights and
    tokens, an MoE model's under the one device's routes (the mesh's own
    counted where they differ): the logits and the cache within the
    bounds above, each position's kernel 7 launches counted (its first
    launch, the first position's heads of layer 0, held to the kernel's
    plain version by ``flash_ratio``), a timed call bitwise the first.
    With ``decode_slots``: one ``decode_32k`` step on a cache of that many
    slots holding the mesh prefill's, at the next slot, against
    ``model.decode_step`` on a copy: logits and the written slot within
    the bounds.  Returns (the line, kernel 7's launches over the mesh
    calls)."""
    mesh = mesh_grid(sizes, dev)
    cell = steps.build(arch, "prefill_32k", device=dev, cfg=cfg, dims=dims, mesh=mesh)
    params, tokens = cell.args
    B, S = tokens.shape
    flash = collections.Counter()
    note = ""
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    with routed() as rec:
        want_logits, want_cache = tm.prefill(params, cfg, tokens, S, device=dev)
    with routed(force=rec.own if cfg.is_moe else None):
        f32_logits, f32_cache = tm.prefill(params, f32, tokens, S, device=dev)
    forced = (lambda: routed(force=rec.own, plan=cell.plan)) if cfg.is_moe else \
        contextlib.nullcontext
    record = []
    real, wrapper = first_flash(record)
    ops.flash_attention = wrapper
    try:
        with torch.no_grad(), counted(flash), forced() as mrec:
            logits, cache = cell.fn(params, tokens)
    finally:
        ops.flash_attention = real
    if cfg.is_moe:
        flips = route_diff(mrec.own, rec.own, cfg.moe_cfg)
        note = "; routes of the mesh's own logits against one device's: " + _share(
            flips, cfg.n_layers * B * S)
    V = cfg.vocab
    ratios = {"logits": held(logits[..., :V], want_logits[..., :V], f32_logits[..., :V],
                             f"{arch} prefill logits on {sizes}"),
              "cache": max(held(cache[i], want_cache[i], f32_cache[i],
                                f"{arch} prefill cache layer {i}")
                           for i in range(cfg.n_layers))}
    del want_logits, f32_logits, f32_cache
    q, k, v, window, q_offset = record[0]
    got = ops.flash_attention(q, k, v, window=window, q_offset=q_offset)
    want, size = ref.flash_attention_plain(q, k, v, window=window, with_size=True,
                                           q_offset=q_offset)
    f_ratio = flash_ratio(got, want, size, v)
    if not f_ratio <= 1.0:
        raise AssertionError(f"lm-mesh: kernel 7 at the first position's "
                             f"{'heads' if cell.plan.heads else 'rows'} {tuple(q.shape)} off "
                             f"its plain version by {f_ratio:.3f} of its bound")
    del q, k, v, got, want, size, record
    launches = {g: flash[g] for g in ops.KERNELS["flash_attention"]}
    heads = len(cell.plan.pos) * cfg.n_layers
    if dev.type == "cuda" and sum(launches.values()) != heads:
        raise AssertionError(f"lm-mesh: {arch} prefill on {sizes} launched kernel 7 "
                             f"{launches}, not once a position and layer ({heads})")
    times = []
    if dev.type == "cuda":
        _sync(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        for _ in range(sz.lm_mesh_calls):
            with forced():
                again = timed(dev, lambda: cell.fn(params, tokens), times)
            if not (torch.equal(again[0], logits) and torch.equal(again[1], cache)):
                raise AssertionError(f"lm-mesh: {arch} prefill on {sizes}: a second call is "
                                     f"not bitwise the first")
            del again
    peak = None if dev.type != "cuda" else torch.cuda.max_memory_allocated(dev) - base
    one = []
    with torch.no_grad():
        for _ in range(sz.lm_mesh_calls):
            with routed(force=rec.own) if cfg.is_moe else contextlib.nullcontext():
                timed(dev, lambda: tm.prefill(params, cfg, tokens, S, device=dev), one)
    line = (f"{arch} prefill_32k {B} x {S} on {sizes} ({cfg.n_layers} layers; "
            f"{cell_plan(cell.plan)}): logits {ratios['logits']:.3g} and cache "
            f"{ratios['cache']:.3g} of their bounds (from one device's f32, against one "
            f"device's bf16){note}; kernel 7 "
            f"launches {launches}, its first position's launch {f_ratio:.3f} of the bound of "
            f"its plain version; median call ms (CUDA events) mesh {np.median(times):.1f}, "
            f"one device {np.median(one):.1f}; peak memory of the mesh calls "
            f"{_mib(None if peak is None else peak / 2**20)}; a second call bitwise the "
            f"first; " + counted_collectives(arch, "prefill_32k", cfg, dims, mesh))
    del want_cache
    if decode_slots:
        line += "; " + mesh_decode(dev, arch, cfg, mesh, params, logits, cache, decode_slots,
                                   flash)
    del cell, logits, cache
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return line, dict(flash)


def mesh_decode(dev, arch, cfg, mesh, params, logits, cache, slots: int, flash) -> str:
    """One ``decode_32k`` step on the mesh at slot S (the prefill's length)
    of a ``slots``-slot cache holding ``cache``, greedy from ``logits``,
    against ``model.decode_step`` on a copy of that cache."""
    L, _, B, S = cache.shape[:4]
    big = torch.zeros((L, 2, B, slots, cfg.n_kv_heads, cfg.hd), dtype=cache.dtype,
                      device=cache.device)
    big[:, :, :, :S] = cache
    copy = big.clone()
    tok = logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True).to(torch.int32)
    dcell = steps.build(arch, "decode_32k", device=dev, cfg=cfg, dims={"batch": B, "seq": slots},
                        mesh=mesh)
    index = torch.tensor(S, dtype=torch.int32, device=dev)
    times = []
    with torch.no_grad(), counted(flash):
        got, _ = timed(dev, lambda: dcell.fn(params, big, tok, index), times)
    f32_copy = copy.clone()
    with torch.no_grad():
        want, _ = tm.decode_step(params, cfg, tok, copy, S, device=dev)
        f32, _ = tm.decode_step(params, dataclasses.replace(cfg, compute_dtype=torch.float32),
                                tok, f32_copy, S, device=dev)
    V = cfg.vocab
    r_logits = held(got[..., :V], want[..., :V], f32[..., :V], f"{arch} decode logits")
    r_slot = held(big[:, :, :, S], copy[:, :, :, S], f32_copy[:, :, :, S],
                  f"{arch} decode's written slot")
    if not torch.equal(big[:, :, :, :S], copy[:, :, :, :S]):
        raise AssertionError(f"lm-mesh: {arch} decode changed a slot before {S}")
    del big, copy, f32_copy, dcell
    return (f"one decode_32k step at slot {S} of {slots} (the sequence over model): logits "
            f"{r_logits:.3g} and the written slot {r_slot:.3g} of their bounds, every other "
            f"slot as it was; {times[0]:.1f} ms (CUDA events, one step)")


def lm_mesh_phase(dev, sz) -> dict:
    """The LM family on the mesh, every position on the one card: train
    cells (``mesh_train``) and prefills with a decode step (``mesh_serve``),
    at ``sz.lm_mesh_train`` and ``sz.lm_mesh_serve``.  Returns kernel 7's
    launches over the phase's mesh calls; on the card they must be
    there."""
    t_phase = time.perf_counter()
    lines, launches = [], collections.Counter()
    for arch, make, dims, sizes in sz.lm_mesh_train:
        lines.append(mesh_train(dev, sz, arch, make(), dims, sizes))
        gc.collect()
    for arch, make, dims, sizes, slots in sz.lm_mesh_serve:
        line, flash = mesh_serve(dev, sz, arch, make(), dims, sizes, slots)
        lines.append(line)
        launches.update(flash)
        gc.collect()
    out = {g: launches[g] for g in ops.KERNELS["flash_attention"]}
    if dev.type == "cuda" and not sum(out.values()):
        raise AssertionError(f"lm-mesh: kernel 7 did not launch: {out}")
    print(f"phase lm-mesh: every position on {dev}; " + "; ".join(lines)
          + f"; kernel 7 launches over the phase {out}; wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


# -- phase 6: wire ------------------------------------------------------------

def same_reply(got, want, what: str) -> None:
    """One reply, ((k,) scores, (k,) slots), bitwise another of the same
    request: a row's reply does not depend on the micro-batch it was
    coalesced into (``ScorerRuntime._query``'s fixed blocks, and the
    kernels' row-independent scoring)."""
    (gv, gi), (wv, wi) = got, want
    if not (np.array_equal(gv, wv) and np.array_equal(gi, wi)):
        raise AssertionError(f"{what}: not bitwise the same reply")


def wire_pipeline(port, jobs, conns: int, window: int):
    """Send ``jobs`` ((ctx, k, tenant) each) over ``conns`` connections,
    each keeping up to ``window`` requests in flight; returns each job's
    reply and its latency in ms, send to reply (host clock)."""
    replies, lat, errors = [None] * len(jobs), np.zeros(len(jobs)), []

    def run(part):
        try:
            with RpcClient("127.0.0.1", port, timeout=120.0) as cli:
                todo, sent = list(part), {}
                while todo or sent:
                    while todo and len(sent) < window:
                        j = todo.pop(0)
                        ctx, k, tenant = jobs[j]
                        sent[cli.send_rank(ctx, k=k, tenant=tenant)] = (j, time.perf_counter())
                    reply = cli.recv()
                    j, t0 = sent.pop(reply.request_id)
                    lat[j] = (time.perf_counter() - t0) * 1e3
                    replies[j] = reply
        except BaseException as e:       # noqa: BLE001 - raised on the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(range(c, len(jobs), conns),))
               for c in range(conns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return replies, lat


def wait_until(pred, what: str, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def wire_phase(dev, sz, serve, tenants) -> dict:
    """The serving front door on the serve phase's engine (lane ``one``)
    and the tenants phase's states, behind ``RpcServer`` on loopback:
    ``wire_requests`` pipelined Bq = 1 top-K requests over ``wire_conns``
    connections to ``one`` and a packed round over the tenants, every
    reply against the direct ``submit(...).result()`` of the same
    request; typed error frames; a graceful drain of queued requests;
    scripted faults on the same engine; and the scoring dispatch under
    ``REPRO_SANITIZE=1``.  Returns the kernel launches of the wire
    traffic."""
    t_phase = time.perf_counter()
    engine, data, K = serve.engine, serve.data, sz.topk
    n = sz.wire_requests
    ctxs = [data.context_query(9000 + s)["context_ids"] for s in range(n)]
    names = list(tenants)
    fe = QueryFrontend({"one": engine, **tenants}, max_batch=sz.batch, max_k=K,
                       max_wait=1e-3, auto_pump=False, pack=True)
    fe.warmup(ctxs[0], tenant="one")
    fe.warmup_packed(ctxs[0], tenant=names[0])

    # direct submission, one request at a time: what the wire must answer
    direct, lat_direct = [], np.zeros(n)
    for s, ctx in enumerate(ctxs):
        t0 = time.perf_counter()
        direct.append(fe.submit(ctx, k=K, tenant="one").result())
        lat_direct[s] = (time.perf_counter() - t0) * 1e3
    for lo in range(0, n, sz.batch):           # each a row of engine.topk's batch
        vals, ids = (t.cpu().numpy() for t in engine.topk(np.concatenate(ctxs[lo:lo + sz.batch]),
                                                          K))
        for j in range(vals.shape[0]):
            same_reply(direct[lo + j], (vals[j], ids[j]),
                       f"direct reply {lo + j} against engine.topk's row {j}")
    got = tuple(torch.as_tensor(np.stack([r[i] for r in direct[:sz.batch]]), device=dev)
                for i in (0, 1))
    diffs = check_serving(engine, np.concatenate(ctxs[:sz.batch]), got, "wire direct replies")

    ops.reset_launches()
    server = serve_in_thread(fe)
    try:
        t0 = time.perf_counter()
        replies, lat_wire = wire_pipeline(server.port, [(c, K, "one") for c in ctxs],
                                          sz.wire_conns, sz.wire_window)
        wire_s = time.perf_counter() - t0
        # a packed round: every tenant's requests in one burst of frames
        pool = [data.context_query(7000 + s)["context_ids"] for s in range(len(names) * sz.tenant_bq)]
        jobs = [(pool[i * sz.tenant_bq + j], name) for i, name in enumerate(names)
                for j in range(sz.tenant_bq)]
        fused0 = fe.stats["fused_dispatches"]
        with RpcClient("127.0.0.1", server.port, timeout=120.0) as cli:
            cli.send_raw(b"".join(frame(encode_rank_request(i + 1, ctx, k=K, tenant=name))
                                  for i, (ctx, name) in enumerate(jobs)))
            packed = {}
            while len(packed) < len(jobs):
                r = cli.recv()
                packed[r.request_id - 1] = r
            launches = {g: ops.LAUNCHES[g] for gs in ops.KERNELS.values() for g in gs}
            # typed error frames
            bad = np.array(ctxs[0]).reshape(-1)
            bad[0] = engine.cfg.layout.fields[0].vocab_size
            err = cli.recv_for(cli.send_rank(bad, k=K, tenant="one")).error
            if not (isinstance(err, ValueError) and "outside" in str(err)):
                raise AssertionError(f"out-of-range context id: {err!r}, not a typed ValueError")
            err = cli.recv_for(cli.send_rank(ctxs[0], k=K, tenant="one", deadline_rel=1e-9)).error
            if not isinstance(err, DeadlineExceeded):
                raise AssertionError(f"expired deadline: {err!r}, not DeadlineExceeded")
        fused = fe.stats["fused_dispatches"] - fused0
        for s, r in enumerate(replies):
            r.raise_for_status()
            same_reply((r.scores, r.slots), direct[s], f"wire reply {s}")
        for i, (ctx, name) in enumerate(jobs):
            packed[i].raise_for_status()
            same_reply((packed[i].scores, packed[i].slots),
                       fe.submit(ctx, k=K, tenant=name).result(), f"packed reply {i}")
            if not tenants[name].is_live(packed[i].slots).all():
                raise AssertionError(f"packed reply {i}: a dead slot")
    finally:
        server.stop(timeout=120.0)
    stats = dict(server.stats)
    if fused < 1:
        raise AssertionError("the packed round went out in no fused dispatch")
    if dev.type == "cuda":
        for name in ("dplr_corpus_topk", "dplr_corpus_score_multi", "embedding_bag"):
            if not all(launches[g] for g in ops.KERNELS[name][:2]):
                raise AssertionError(f"the wire traffic launched no {name} kernel: {launches}")

    # a graceful drain: requests queued (short of a batch, never aged) when
    # the server stops are all answered
    fe2 = QueryFrontend(engine, max_batch=sz.batch, max_k=K, max_wait=1e9, auto_pump=False)
    server2 = serve_in_thread(fe2)
    cli = RpcClient("127.0.0.1", server2.port, timeout=120.0)
    try:
        rids = [cli.send_rank(ctxs[s], k=K) for s in range(sz.batch - 1)]
        wait_until(lambda: fe2.queue_depth == len(rids), "the drain's requests to queue")
        server2.stop(timeout=120.0)
        for s, rid in enumerate(rids):
            r = cli.recv_for(rid)
            r.raise_for_status()
            same_reply((r.scores, r.slots), direct[s], f"drained reply {s}")
    finally:
        cli.close()
    if not fe2.health()["closed"] or server2.stats["replies"] != len(rids):
        raise AssertionError(f"the drain answered {server2.stats['replies']} of {len(rids)}")

    chaos = chaos_checks(dev, sz, engine, data, ctxs, direct)
    sanitized = sanitize_checks(dev, sz, engine, tenants, ctxs, direct, pool)
    print(f"phase wire: RpcServer on loopback over lane 'one' (the serve phase's "
          f"{engine.n_items}-item engine) and {len(names)} packed tenants; {n} pipelined "
          f"Bq=1 top-{K} requests over {sz.wire_conns} connections (window "
          f"{sz.wire_window} each) in {wire_s:.2f} s: wire latency p50 "
          f"{np.percentile(lat_wire, 50):.3f} ms p99 {np.percentile(lat_wire, 99):.3f} ms, "
          f"direct submit (one at a time) p50 {np.percentile(lat_direct, 50):.3f} ms p99 "
          f"{np.percentile(lat_direct, 99):.3f} ms (host clock, {n} samples each); every "
          f"reply bitwise the direct submit and engine.topk's batched row ({diffs} ids "
          f"differ from plain, within the tie rule); packed round {len(jobs)} requests in {fused} fused dispatch(es); typed "
          f"ValueError and DeadlineExceeded frames; drain answered {len(rids)} queued; "
          f"server stats {stats}; {chaos}; {sanitized}; "
          f"{time.perf_counter() - t_phase:.1f} s; launches {launches}", flush=True)
    return launches


def chaos_checks(dev, sz, engine, data, ctxs, direct) -> str:
    """Scripted faults on the serve phase's engine through a frontend
    (module docstring, phase 6).  Returns a summary."""
    K = sz.topk
    inj = FaultInjector(seed=0)
    engine.fault_injector = inj
    fe = QueryFrontend(engine, max_batch=sz.batch, max_k=K, max_wait=0.0, auto_pump=False,
                       retries=2, retry_backoff=0.0, fault_injector=inj)
    try:
        # a dispatch fault: the same batch re-dispatches, bitwise
        inj.arm("dispatch", count=1)
        same_reply(fe.submit(ctxs[0], k=K).result(), direct[0], "chaos dispatch")
        # a resolve fault: the batch is read again after a re-dispatch
        pend = [fe.submit(ctxs[s], k=K) for s in range(3)]
        fe.flush()
        inj.arm("resolve", count=1)
        for s, p in enumerate(pend):
            same_reply(p.result(), direct[s], f"chaos resolve {s}")
        # a kernel fault: retried through the same kernel, then typed
        inj.arm("kernel", count=1)
        same_reply(fe.submit(ctxs[1], k=K).result(), direct[1], "chaos kernel")
        inj.arm("kernel", count=fe.retries + 1)
        p = fe.submit(ctxs[1], k=K)
        fe.drain()
        try:
            p.result()
            raise AssertionError("a spent kernel retry budget did not fail")
        except DispatchFailed as e:
            if not (isinstance(e.__cause__, InjectedFault) and e.__cause__.site == "kernel"):
                raise AssertionError(f"DispatchFailed without the kernel fault: {e!r}") from e
        if engine.kernel_degraded or fe.health()["tenants"]["default"]["kernel_degraded"]:
            raise AssertionError("kernel_degraded set: the port has no fallback")
        retries = fe.stats["retries"]
        # a write fault during churn: nothing moves
        live, free = engine.valid_slots.copy(), sorted(engine._free)
        upd = data.ranking_query(2, 77_000)
        inj.arm("write")
        for op in (lambda: fe.add_items(upd["item_ids"][0], upd["item_weights"][0]),
                   lambda: fe.update_items(live[:2], upd["item_ids"][0], upd["item_weights"][0]),
                   lambda: fe.remove_items(live[:2])):
            try:
                op()
                raise AssertionError("a faulted churn write landed")
            except InjectedFault:
                pass
        inj.disarm("write")
        if not (np.array_equal(engine.valid_slots, live) and sorted(engine._free) == free):
            raise AssertionError("a faulted churn write changed the corpus")
        same_reply(fe.submit(ctxs[2], k=K).result(), direct[2], "after the write faults")
        # an alloc fault: the slab's doubling is a clean no-op
        cap = engine.capacity
        inj.arm("alloc", count=1)
        try:
            engine.maybe_autoscale(engine.occupancy)
            raise AssertionError("a faulted slab growth went through")
        except InjectedFault:
            pass
        if engine.capacity != cap or engine.cache.Q_I.shape[0] != cap:
            raise AssertionError("a faulted slab growth changed the slab")
        # a stalled pump: the watchdog orphans it and a fresh pump dispatches
        inj.arm("pump", count=1, delay=0.5)
        fe.start_pump(interval=1e-3, watchdog=0.1)
        p = fe.submit(ctxs[3], k=K)
        wait_until(lambda: fe.stats["pump_restarts"] >= 1 and fe.queue_depth == 0,
                   "the watchdog to restart the pump", timeout=30.0)
        same_reply(p.result(), direct[3], "after the pump stall")
        fe.stop_pump()
        # a seeded storm: every request resolves, a reply or a typed error
        inj.arm("dispatch", rate=0.3)
        storm = []
        for s in range(4 * sz.batch):
            storm.append(fe.submit(ctxs[s], k=K))
            if s % 4 == 3:
                fe.pump()
        fe.drain()
        inj.clear()
        ok = failed = 0
        for s, p in enumerate(storm):
            if not p.done():
                raise AssertionError(f"storm request {s} never resolved")
            try:
                same_reply(p.result(), direct[s], f"storm reply {s}")
                ok += 1
            except ServingError:
                failed += 1
        if ok == 0:
            raise AssertionError("the storm served nothing")
    finally:
        fe.close()
        engine.fault_injector = None
    return (f"chaos: dispatch, resolve and kernel faults retried ({retries} retries, replies "
            f"bitwise), spent kernel retries DispatchFailed with kernel_degraded False, write "
            f"and alloc faults left the corpus as it was, watchdog restarted a 0.5 s pump "
            f"stall, storm of {len(storm)}: {ok} served / {failed} typed, 0 dropped")


def sanitize_checks(dev, sz, engine, tenants, ctxs, direct, pool) -> str:
    """The scoring dispatch under ``REPRO_SANITIZE=1``: on the card the
    guard raises on a synchronising call inside it, restores the mode it
    found, and the Bq = 1 and packed dispatches run clean in it.  Returns
    a summary."""
    K = sz.topk
    before = os.environ.get("REPRO_SANITIZE")
    os.environ["REPRO_SANITIZE"] = "1"
    try:
        mode = torch.cuda.get_sync_debug_mode() if dev.type == "cuda" else None
        if dev.type == "cuda":
            x = torch.ones(1, device=dev)
            try:
                with scoring_guard(dev):
                    x.item()
                raise AssertionError("an .item() inside scoring_guard did not raise")
            except RuntimeError:
                pass
            if torch.cuda.get_sync_debug_mode() != mode:
                raise AssertionError("scoring_guard did not restore the sync-debug mode")
        vals, ids = engine.topk(ctxs[0], K)           # inside the guard
        same_reply((vals[0].cpu().numpy(), ids[0].cpu().numpy()), direct[0],
                   "topk under the sanitizer")
        states = tuple(tenants.values())
        ctx = np.stack([np.concatenate(pool[i * sz.tenant_bq:(i + 1) * sz.tenant_bq])
                        for i in range(len(states))])
        pv, pi = fused_topk(states, ctx, K)
        for i, st in enumerate(states):
            want = st.topk(ctx[i], K)
            same_reply((pv[i].cpu().numpy(), pi[i].cpu().numpy()),
                       tuple(t.cpu().numpy() for t in want),
                       f"fused_topk under the sanitizer, tenant {i}")
        if dev.type == "cuda":
            if torch.cuda.get_sync_debug_mode() != mode:
                raise AssertionError("the engine's guard did not restore the sync-debug mode")
            # the sync the guard found: unprimed, the context lookup's first
            # call copies its static maps from pageable host memory
            field_lookups._statics.cache_clear()
            try:
                engine.topk(ctxs[0], K)
                raise AssertionError("the guard missed the lookup's first-use copy")
            except RuntimeError:
                pass
            finally:
                field_lookups.prepare_lookups(engine.cfg.layout.subset("context"),
                                              engine.params["embedding"].device)
    finally:
        if before is None:
            del os.environ["REPRO_SANITIZE"]
        else:
            os.environ["REPRO_SANITIZE"] = before
    return ("sanitize: .item() in scoring_guard raises and the mode is restored; Bq=1 topk "
            f"and a {len(tenants)}-tenant fused_topk run clean inside it; with the context "
            "lookup's maps unprimed, its first-use copy raises inside it"
            if dev.type == "cuda" else "sanitize: the guard is a no-op off the card")


# -- phase 7: eval ------------------------------------------------------------

def plain_logits(params, cfg, ids, w, pruned_mask=None, V=None):
    """``fwfm.apply`` in plain PyTorch (plain embedding bag and pairwise
    term, no kernel); ``V``, when given, in place of the field lookup."""
    if V is None:
        V = plain_fields(params["embedding"], cfg.layout, ids, w)
    lin = lookup_linear_terms(params["linear"], cfg.layout, ids, w)
    if cfg.interaction == "dplr":
        pw = dplr_pairwise(V, DPLRParams(params["U"], params["e"]))
    else:
        R = fwfm.field_matrix(params, cfg)
        pw = ref.fwfm_pairwise_ref(V, R if pruned_mask is None else R * pruned_mask)
    return params["bias"] + lin + pw


def plain_apply(params, cfg, ids, w, pruned_mask=None):
    """``plain_logits``, and the summed size of its terms:
    ``|bias| + sum |b_s w_s| + 0.5 sum_ij |R_ij G_ij|`` (R materialized
    for DPLR)."""
    V = plain_fields(params["embedding"], cfg.layout, ids, w)
    if cfg.interaction == "dplr":
        R = materialize_R(DPLRParams(params["U"], params["e"]))
    else:
        R = fwfm.field_matrix(params, cfg)
        if pruned_mask is not None:
            R = R * pruned_mask
    size = (params["bias"].abs() + lookup_linear_terms(params["linear"].abs(), cfg.layout,
                                                       ids, w.abs()) + pair_size(V, R))
    return plain_logits(params, cfg, ids, w, pruned_mask, V), size


def eval_phase(dev, sz, serve) -> dict:
    """The paper's comparison through ``eval.harness`` on the serve phase's
    data and DPLR weights: pointwise eval of DPLR, full FwFM and
    matched-pruned FwFM, each model's logits against the plain path; the
    pruned model's Algorithm 1 against its pointwise scores; and
    ``serving_parity`` (model, engine, frontend) for DPLR against the
    plain scores; then the full-FwFM baseline cast to bf16 (``eval_bf16_case``).
    Returns the launches of each CUDA kernel over the phase (the bf16
    case's bf16 kernels over that case)."""
    cfg, params, data = serve.engine.cfg, serve.engine.params, serve.data
    t0 = time.perf_counter()
    split = {k: torch.as_tensor(v, device=dev) for k, v in data.batch(sz.eval_n, 10**6).items()}
    Q, n = sz.parity
    parity_set = harness.ranking_eval_set(data, n_queries=Q, n_items=n, seed=11)
    Qp, n_p = sz.pruned_q
    pruned_set = harness.ranking_eval_set(data, n_queries=Qp, n_items=n_p, seed=13)
    host_s = time.perf_counter() - t0

    ops.reset_launches()
    fcfg = sz.make_fwfm()
    fparams = fwfm.init(torch.Generator(device=dev).manual_seed(1), fcfg)
    m = fcfg.n_fields
    pr = prune_matched(fwfm.field_matrix(fparams, fcfg), m, cfg.rank)
    if len(pr.entries_r) != matched_param_count(m, cfg.rank):
        raise AssertionError(f"pruned R keeps {len(pr.entries_r)} entries")
    parts = []
    for name, p, c, mask in (("dplr", params, cfg, None), ("fwfm", fparams, fcfg, None),
                             ("pruned-fwfm", fparams, fcfg, pr.mask)):
        res = harness.evaluate_pointwise(p, c, data, n=sz.eval_n, batch_size=sz.eval_batch,
                                         pruned_mask=mask)
        labels, logits = harness.score_split(p, c, data, n=sz.eval_n,
                                             batch_size=sz.eval_batch, pruned_mask=mask)
        if not np.array_equal(labels, split["label"].cpu().numpy()):
            raise AssertionError(f"eval {name}: labels differ from the split's")
        want, size = plain_apply(p, c, split["ids"], split["weights"], mask)
        err = check_close(torch.as_tensor(logits, device=dev), want, f"eval {name} logits",
                          size=size)
        parts.append(f"{name}: AUC {res['auc']:.4f}, log-loss {res['logloss']:.4f}, "
                     f"calibration {res['calibration_ratio']:.4f} (logits max |diff| "
                     f"{err:.3g} from plain)")

    # Algorithm 1 with the pruned cache against pointwise pruned scoring
    got = torch.as_tensor(harness.model_scores(fparams, fcfg, pruned_set, pruned=pr),
                          device=dev)
    lay = fcfg.layout
    order = np.argsort(np.concatenate([lay.slots_of("context"), lay.slots_of("item")]))
    rows = {key: torch.cat([torch.as_tensor(getattr(pruned_set, f"context_{key}"), device=dev)
                            [:, None].expand(Qp, n_p, -1),
                            torch.as_tensor(getattr(pruned_set, f"item_{key}"), device=dev)
                            [None].expand(Qp, n_p, -1)], -1)[..., order].reshape(Qp * n_p, -1)
            for key in ("ids", "weights")}
    pointwise = fwfm.apply(fparams, fcfg, rows, pruned_mask=pr.mask).reshape(Qp, n_p)
    want, size = plain_apply(fparams, fcfg, rows["ids"], rows["weights"], pr.mask)
    check_close(got, pointwise, "model_scores(pruned=) vs apply(pruned_mask=)",
                size=size.reshape(Qp, n_p))
    check_close(got, want.reshape(Qp, n_p), "model_scores(pruned=) vs plain",
                size=size.reshape(Qp, n_p))

    rep_ = harness.serving_parity(params, cfg, parity_set, k=10)
    want, size = plain_rank_items(params, cfg, parity_set.query(dev))
    diffs = {}
    for path, scores in rep_["scores"].items():
        s_ = torch.as_tensor(scores, device=dev)
        check_close(s_, want, f"serving_parity {path}", size=size)
        vals, ids = ref.topk_stable(s_, 10)
        diffs[path] = check_topk(vals, ids.to(torch.int32), want, 10,
                                 f"serving_parity {path} top-10", size=size)[1]
    launches = {g: ops.LAUNCHES[g] for name in EVAL_KERNELS for g in ops.KERNELS[name]}
    if dev.type == "cuda" and not all(launches.values()):
        raise AssertionError(f"a kernel was not launched on the eval path: {launches}")
    bf16_part, bf16_launches = eval_bf16_case(dev, sz, data, split, fcfg, fparams)
    launches.update(bf16_launches)
    parts.append(bf16_part)
    model = rep_["paths"]["model"]
    print(f"phase eval: wall {time.perf_counter() - t0:.1f} s, of it host data {host_s:.1f} s; "
          f"evaluate_pointwise on {sz.eval_n} rows, "
          f"batch {sz.eval_batch}: " + "; ".join(parts)
          + f"; pruned R keeps {len(pr.entries_r)} of {m * (m - 1) // 2} entries; "
          f"model_scores(pruned=) = apply(pruned_mask=) on {Qp} x {n_p}; serving_parity "
          f"Q={Q} n={n}: model ndcg@10 {model['ndcg@10']:.4f}, mrr {model['mrr']:.4f}; "
          f"max |diff| vs model {rep_['max_abs_diff']}, bitwise {rep_['bit_exact']}; "
          f"top-10 ids differing from plain (all within the tie rule) {diffs}; "
          f"launches {launches}", flush=True)
    return launches


def eval_bf16_case(dev, sz, data, split, fcfg, fparams) -> tuple[str, dict]:
    """The full-FwFM baseline cast to bf16 (weights and ``cfg.dtype``, as
    ``serve --bf16`` casts a model) through ``harness.evaluate_pointwise``
    and ``score_split``, as the JAX harness evaluates a bf16 model: on the
    card only the bf16 instantiations of kernels 5 and 6 may launch, and
    kernel 6's must.  Logits against the plain path on the same bf16
    weights (plain bags in bf16, the plain pairwise term on the upcast V),
    within ``TOL * max(1, size)``.  Returns (the line's part, the bf16
    kernels' launches over the case)."""
    cfg16 = dataclasses.replace(fcfg, dtype=torch.bfloat16)
    p16 = {k: v.to(torch.bfloat16) for k, v in fparams.items()}
    ops.reset_launches()
    res = harness.evaluate_pointwise(p16, cfg16, data, n=sz.eval_n, batch_size=sz.eval_batch)
    _, logits = harness.score_split(p16, cfg16, data, n=sz.eval_n, batch_size=sz.eval_batch)
    seen = {g: c for g, c in ops.LAUNCHES.items() if c}
    allowed = {"fwfm_pairwise_kernel_bf16", "embedding_bag_kernel_bf16"}
    if dev.type == "cuda" and (not seen.get("fwfm_pairwise_kernel_bf16") or set(seen) - allowed):
        raise AssertionError(f"the bf16 full-FwFM eval launched {seen}: only {sorted(allowed)} "
                             f"may launch, and fwfm_pairwise_kernel_bf16 must")
    launches = {g: ops.LAUNCHES[g] for g in sorted(allowed)}
    w16 = split["weights"].to(torch.bfloat16)
    V = plain_fields(p16["embedding"], cfg16.layout, split["ids"], w16)
    want = plain_logits(p16, cfg16, split["ids"], w16, V=V)
    R = fwfm.field_matrix(p16, cfg16).float()
    size = (p16["bias"].float().abs() + lookup_linear_terms(
        p16["linear"].float().abs(), cfg16.layout, split["ids"], w16.float().abs())
        + pair_size(V.float(), R))
    err = check_close(torch.as_tensor(logits, device=dev), want, "eval fwfm bf16 logits",
                      size=size)
    return (f"fwfm in bf16: AUC {res['auc']:.4f}, log-loss {res['logloss']:.4f} (logits max "
            f"|diff| {err:.3g} from plain; launches {launches})"), launches


# -- phase 8: train -----------------------------------------------------------

def bce(logits, label):
    """``fwfm.loss``'s binary cross-entropy on logits, in plain PyTorch."""
    y = label.to(logits.dtype)
    return (torch.clamp(logits, min=0) - logits * y
            + torch.log1p(torch.exp(-torch.abs(logits)))).mean()


# the model's loss with no kernel in it (``train.train_step`` takes either)
PLAIN_MODEL = SimpleNamespace(
    loss=lambda p, cfg, b: bce(plain_logits(p, cfg, b["ids"], b["weights"]), b["label"]))


class StepTimer:
    """Marks a step's boundaries (CUDA events on the card, the host clock
    on the CPU): ``begin()``, then ``train_step``'s ``mark`` after its
    forward, backward and update."""

    def __init__(self, dev):
        self.dev, self.steps = dev, []

    def _now(self):
        if self.dev.type != "cuda":
            return time.perf_counter()
        evt = torch.cuda.Event(enable_timing=True)
        evt.record()
        return evt

    def begin(self):
        self.steps.append([self._now()])

    def mark(self, name):
        self.steps[-1].append(self._now())

    def medians(self) -> dict:
        """Median ms of each part and of the whole step."""
        _sync(self.dev)
        if self.dev.type == "cuda":
            span = lambda a, b: a.elapsed_time(b)                       # noqa: E731
        else:
            span = lambda a, b: (b - a) * 1e3                           # noqa: E731
        parts = np.array([[span(a, b) for a, b in zip(t[:-1], t[1:])] for t in self.steps])
        med = dict(zip(("forward", "backward", "update"), np.median(parts, 0)))
        med["step"] = float(np.median(parts.sum(1)))
        return med


def run_steps(mod, cfg, optimizer, params, state, make_batch, start, stop, lr, dev,
              mgr=None, every=None, timer=None, prefetch=2):
    """Steps ``start + 1 .. stop`` through ``train.train_step`` on batches from
    a ``ShardedPipeline``; a checkpoint every ``every`` steps into ``mgr``.
    Returns the losses (0-d tensors) and the saves' timing dicts."""
    pipe = ShardedPipeline(make_batch, prefetch=prefetch).start(from_step=start)
    losses, saves = [], []
    try:
        for step in range(start, stop):
            _, batch = pipe.get()
            batch = train.to_device(batch, dev)
            if timer is not None:
                timer.begin()
            loss, params, state = train.train_step(mod, cfg, optimizer, params, state, batch,
                                                   lr, mark=timer and timer.mark)
            losses.append(loss)
            if mgr is not None and (step + 1) % every == 0:
                mgr.save({"params": params, "opt": state}, step + 1)
                saves.append(mgr.last_save)
    finally:
        pipe.stop()
        if mgr is not None:
            mgr.wait()
    return losses, saves


def same_tree(a: dict, b: dict) -> bool:
    """Every leaf of two nested dicts bitwise equal."""
    return all(same_tree(a[k], b[k]) if isinstance(a[k], dict) else torch.equal(a[k], b[k])
               for k in a) and a.keys() == b.keys()


def grad_checks(dev, cfg, params, batch, what: str) -> str:
    """Step 1's loss and gradients through the kernels against the plain
    forward with autograd, from ``params`` on ``batch``.  The loss within
    ``TOL * max(1, |loss|)``; each arena row's gradient within ``TOL *
    size``, ``size`` the summed magnitude of the row's terms
    (``dV_size``), rows no slot names exactly 0 on both; every other
    gradient (U, e, bias, linear, R) within ``TOL * max|plain|`` of its
    tensor."""
    loss, got = optim.value_and_grad(fwfm.loss)(params, cfg, batch)
    plain_loss, want = optim.value_and_grad(PLAIN_MODEL.loss)(params, cfg, batch)
    check_close(loss, plain_loss, f"{what} step-1 loss")
    ids, w = batch["ids"], batch["weights"]
    table = params["embedding"]
    V = plain_fields(table, cfg.layout, ids, w)
    off = torch.as_tensor(cfg.layout.slot_offsets.astype(np.int64), device=dev)
    arena = ids.long() + off
    rows = torch.unique(arena)
    size = ref.embedding_bag_vjp(table, arena, w.abs(), cfg.layout.slot_to_field,
                                 dV_size(params, cfg, V, ids, w, batch["label"]))[0]
    size = size.index_select(0, rows)
    g, p_ = got["embedding"], want["embedding"]
    if int(torch.count_nonzero(g)) != int(torch.count_nonzero(g.index_select(0, rows))) or \
            int(torch.count_nonzero(p_)) != int(torch.count_nonzero(p_.index_select(0, rows))):
        raise AssertionError(f"{what}: a row no slot names has a gradient")
    diff = (g.index_select(0, rows) - p_.index_select(0, rows)).abs()
    if (diff > TOL * size).any():
        raise AssertionError(f"{what}: d_embedding off, max |diff| {float(diff.max()):.3g}")
    parts = [f"loss {float(loss):.6f} (plain {float(plain_loss):.6f}), d_embedding on "
             f"{rows.numel()} rows max |diff| {float(diff.max()):.3g}"]
    for name in sorted(set(got) - {"embedding"}):
        err = float((got[name] - want[name]).abs().max())
        scale = float(want[name].abs().max())
        if not err <= TOL * scale or not torch.isfinite(got[name]).all():
            raise AssertionError(f"{what}: d_{name} off by {err:.3g} (max |d_{name}| "
                                 f"{scale:.3g})")
        parts.append(f"d_{name} {err:.3g} (of max {scale:.3g})")
    return ", ".join(parts)


def dV_size(params, cfg, V, ids, w, label):
    """The summed magnitude of the terms of ``dL/dV`` (bounded above): the
    vjp of the pairwise term with every factor by its magnitude (|V|, |R|
    or |U|, |e|, |d|) at the cotangent ``|dL/dlogit|`` of the plain path."""
    logits = plain_logits(params, cfg, ids, w, V=V).detach().requires_grad_()
    Va = V.detach().abs().requires_grad_()
    with torch.enable_grad():
        g = torch.autograd.grad(bce(logits, label), logits)[0].abs()
        if cfg.interaction == "dplr":
            p = DPLRParams(params["U"].detach(), params["e"].detach())
            pw = dplr_pairwise_explicit_d(Va, p.U.abs(), p.e.abs(), dplr_diagonal(p).abs())
        else:
            pw = ref.fwfm_pairwise_ref(Va, fwfm.field_matrix(params, cfg).detach().abs())
        return torch.autograd.grad(pw, Va, grad_outputs=g)[0]


def launches_of(names) -> dict:
    return {g: ops.LAUNCHES[g] for name in names for g in ops.KERNELS[name]}


def train_phase(dev, sz, serve) -> dict:
    """Train ``dplr-fwfm`` at full width through ``launch.train``'s step
    and pipeline, checkpoint it, resume it, hold it against the plain path,
    train the full-FwFM baseline and factor its R, then serve the trained
    checkpoint through ``CorpusState.maybe_refresh``.  Returns the launches
    of each CUDA kernel over run A, the baseline's kernel run and the
    serving of the checkpoint."""
    t_phase = time.perf_counter()
    cfg = sz.make_config()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    B, n_steps, every, lr = sz.train_batch, sz.train_steps, sz.train_save, sz.train_lr
    t0 = time.perf_counter()
    mod, make_batch = train.build_recsys_trainer("dplr-fwfm", cfg, B, seed=0)
    data_s = time.perf_counter() - t0
    optimizer = optim.adagrad()
    init = lambda c: fwfm.init(torch.Generator(device=dev).manual_seed(0), c)  # noqa: E731
    first = train.to_device(make_batch(0), dev)
    notes = [f"step 1 against the plain path: {grad_checks(dev, cfg, init(cfg), first, 'dplr')}"]

    # kernel 5's backward on step 1's input, twice
    lay, k = cfg.layout, cfg.embed_dim
    table = init(cfg)["embedding"]
    arena = (first["ids"] + torch.as_tensor(lay.slot_offsets.astype(np.int32),
                                            device=dev)).contiguous()
    bags = ops.bag_map(lay.slot_to_field, lay.n_fields, dev)
    g = torch.randn((B, lay.n_fields, k), generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    once = ops.embedding_bag_backward(g, table, arena, first["weights"], bags)
    if not torch.equal(once, ops.embedding_bag_backward(g, table, arena, first["weights"],
                                                        bags)):
        raise AssertionError("train: kernel 5's backward differs between two calls")
    bwd_ms = device_ms(lambda: ops.embedding_bag_backward(g, table, arena, first["weights"],
                                                          bags), 3, 5) \
        if dev.type == "cuda" else None
    del table, once, g

    BUILD.mkdir(parents=True, exist_ok=True)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_train_", dir=BUILD))
    try:
        mgr = CheckpointManager(str(workdir / "run_a"), keep=2)
        params = init(cfg)
        state = optimizer.init(params)
        ckpt_bytes = sum(t.numel() * t.element_size()
                         for t in optim.optimizers.tree_leaves({"params": params, "opt": state}))
        free = shutil.disk_usage(workdir).free
        notes.append(f"a checkpoint holds {ckpt_bytes / 1e9:.3f} GB of tensors, "
                     f"{len(range(every, n_steps + 1, every))} saved, {free / 1e9:.1f} GB free "
                     f"on the disk before the first")
        timer = StepTimer(dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        losses_a, saves = run_steps(mod, cfg, optimizer, params, state, make_batch, 0, n_steps,
                                    lr, dev, mgr, every, timer)
        run_a_s = time.perf_counter() - t0
        launches = launches_of(TRAIN_KERNELS)
        if dev.type == "cuda" and not all(launches.values()):
            raise AssertionError(f"train: a kernel was not launched in run A: {launches}")
        per_step = {g_: n / n_steps for g_, n in launches.items()}
        split = timer.medians()

        # run B: resume from the step-`every` checkpoint into a fresh state
        template = {"params": dict.fromkeys(params), "opt": {"acc": dict.fromkeys(params)}}
        t0 = time.perf_counter()
        restored, step = mgr.restore(template, step=every, device=dev)
        restore_s = time.perf_counter() - t0
        if step != every:
            raise AssertionError(f"train: restored step {step}, not {every}")
        losses_b, _ = run_steps(mod, cfg, optimizer, restored["params"], restored["opt"],
                                make_batch, every, n_steps, lr, dev)
        if not (torch.equal(torch.stack(losses_b), torch.stack(losses_a[every:]))
                and same_tree(restored, {"params": params, "opt": state})):
            raise AssertionError("train: run B (resumed) is not bitwise run A")
        del restored

        # the plain path: the same steps with no kernel in the loss
        pp = init(cfg)
        losses_p, _ = run_steps(PLAIN_MODEL, cfg, optimizer, pp, optimizer.init(pp),
                                make_batch, 0, n_steps, lr, dev)
        del pp
        la, lp = torch.stack(losses_a).double(), torch.stack(losses_p).double()
        loss_err = float((la - lp).abs().max())
        if ((la - lp).abs() > 1e-4 * torch.clamp(lp.abs(), min=1.0)).any():
            raise AssertionError(f"train: the kernel path's losses leave the plain path's by "
                                 f"{loss_err:.3g}")

        base = baseline_run(dev, sz, make_batch, optimizer)
        served = serve_trained(dev, sz, serve, mgr, params, n_steps, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for name, n in base["launches"].items():
        launches[name] = launches.get(name, 0) + n
    for name, n in served["launches"].items():
        launches[name] = launches.get(name, 0) + n
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB" if dev.type == "cuda"
            else "not measured")
    save_parts = "; ".join(
        f"step {t['step']}: host copy {t['host_copy_s']:.2f} s, write {t['write_s']:.2f} s, "
        f"checksum {t['checksum_s']:.2f} s, {t['bytes'] / 1e9:.3f} GB" for t in saves)
    bwd = "not measured (no card)" if bwd_ms is None else f"{bwd_ms:.4f} ms"
    print(f"phase train: {cfg.layout.n_fields} fields k={cfg.embed_dim} rho={cfg.rank}, "
          f"{padded_rows(cfg.layout.total_vocab)}-row arena; SyntheticCTR(embed_dim=8, "
          f"teacher_rank=2) built in {data_s:.1f} s; run A: {n_steps} adagrad steps at B={B} "
          f"lr={lr} in {run_a_s:.1f} s, losses {float(losses_a[0]):.5f} -> "
          f"{float(losses_a[-1]):.5f}; median step {split['step']:.3f} ms (forward "
          f"{split['forward']:.3f}, backward {split['backward']:.3f}, optimizer "
          f"{split['update']:.3f}; {'CUDA events' if dev.type == 'cuda' else 'host clock'}); "
          f"kernel 5 launches a step {per_step}, its backward {bwd} a call at this step's "
          f"input; checkpoints: {save_parts}; restore of step {every} {restore_s:.2f} s; "
          f"run B from step {every}: losses and step {n_steps}'s params and accumulator "
          f"bitwise run A's; the plain path's {n_steps} losses within 1e-4 x max(1, |loss|) "
          f"(max |diff| {loss_err:.3g}); {'; '.join(notes)}; {base['note']}; "
          f"{served['note']}; peak memory {peak}; wall {time.perf_counter() - t_phase:.1f} s; "
          f"launches {launches}", flush=True)
    return launches


def baseline_run(dev, sz, make_batch, optimizer) -> dict:
    """The full-FwFM baseline (``sz.make_fwfm``): step 1 and
    ``sz.base_steps`` steps through the kernels held against the plain
    path, then ``posthoc_dplr`` of its trained R on the card and on the
    CPU, their Frobenius errors within 1% of each other."""
    bcfg = sz.make_fwfm()
    init = lambda: fwfm.init(torch.Generator(device=dev).manual_seed(1), bcfg)  # noqa: E731
    first = train.to_device(make_batch(0), dev)
    grads = grad_checks(dev, bcfg, init(), first, "fwfm")
    params = init()
    ops.reset_launches()
    losses, _ = run_steps(fwfm, bcfg, optimizer, params, optimizer.init(params), make_batch,
                          0, sz.base_steps, sz.train_lr, dev)
    launches = launches_of(("embedding_bag", "embedding_bag_backward", "fwfm_pairwise"))
    if dev.type == "cuda" and not all(launches.values()):
        raise AssertionError(f"train: a kernel was not launched in the baseline's steps: "
                             f"{launches}")
    pp = init()
    plain, _ = run_steps(PLAIN_MODEL, bcfg, optimizer, pp, optimizer.init(pp), make_batch,
                         0, sz.base_steps, sz.train_lr, dev)
    del pp
    la, lp = torch.stack(losses).double(), torch.stack(plain).double()
    if ((la - lp).abs() > 1e-4 * torch.clamp(lp.abs(), min=1.0)).any():
        raise AssertionError("train: the baseline's kernel-path losses leave the plain path's")
    R = fwfm.field_matrix(params, bcfg).detach().cpu().numpy().astype(np.float64)
    del params
    fits = {}
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        U, e, d = posthoc_dplr(R, sz.posthoc_rank, device=where)
        fits[where.type] = (float(np.linalg.norm((U.T * e) @ U + np.diag(d) - R)),
                            time.perf_counter() - t0)
    (err_dev, s_dev), (err_cpu, s_cpu) = fits[dev.type], fits["cpu"]
    if not abs(err_dev - err_cpu) <= 0.01 * err_cpu:
        raise AssertionError(f"posthoc_dplr on {dev}: Frobenius error {err_dev:.6g}, on the "
                             f"CPU {err_cpu:.6g}")
    return dict(launches=launches, note=(
        f"baseline {bcfg.interaction} m={bcfg.n_fields}: step 1 against the plain path: "
        f"{grads}; {sz.base_steps} steps, losses {float(losses[0]):.5f} -> "
        f"{float(losses[-1]):.5f}, max |diff| from the plain path "
        f"{float((la - lp).abs().max()):.3g}; posthoc_dplr(R, rank={sz.posthoc_rank}) "
        f"Frobenius error {err_dev:.6g} on {dev.type} ({s_dev:.2f} s), {err_cpu:.6g} on the "
        f"CPU ({s_cpu:.2f} s), |R|_F {float(np.linalg.norm(R)):.6g}"))


def serve_trained(dev, sz, serve, mgr, params, step: int, workdir: Path) -> dict:
    """Run A's checkpoint directory served through ``maybe_refresh``: a
    ``CorpusState`` over the serve phase's corpus installs step ``step``,
    answers top-K queries at each Bq of ``sz.train_serve_bqs`` (held by
    ``check_serving`` and C1) and one Algorithm 1 call (against
    ``plain_rank_items``); a second poll finds nothing; a truncated copy of
    the newest step raises ``RefreshFailed`` once, the next poll finds
    nothing, and the engine still answers from ``step``, bitwise as before."""
    cfg, K = sz.make_config(), sz.topk
    engine = CorpusState(cfg, serve.corpus["item_ids"][0], serve.corpus["item_weights"][0],
                         capacity=sz.capacity, device=dev)
    template = {"params": dict.fromkeys(params)}
    pick = lambda t: t["params"]  # noqa: E731
    ops.reset_launches()
    t0 = time.perf_counter()
    if not engine.maybe_refresh(mgr, template, select=pick) or engine.model_step != step:
        raise AssertionError(f"maybe_refresh did not install step {step}")
    _sync(dev)
    refresh_s = time.perf_counter() - t0
    if not same_tree(engine.params, params):
        raise AssertionError("maybe_refresh installed params other than run A's")
    answers, diffs = [], 0
    for bq in sz.train_serve_bqs:
        ctx = np.concatenate(serve.ctxs[:bq])
        got = engine.topk(ctx, K)
        diffs += check_serving(engine, ctx, got, f"trained top-{K} Bq={bq}")
        check_exact(*got, engine.score(ctx), K, f"trained top-{K} Bq={bq}")
        answers.append((ctx, got))
    q = {k_: torch.as_tensor(v, device=dev)
         for k_, v in serve.data.ranking_query(sz.percall_n, 3).items()}
    got = fwfm.rank_items(engine.params, cfg, q)
    _sync(dev)
    want, size = plain_rank_items(engine.params, cfg, q)
    check_close(got, want, "trained percall rank_items", size=size)
    launches = launches_of(SERVE_KERNELS)
    # K <= 4096 here, so the winners' sort kernels (topk_sort_*) do not run
    ran = ("corpus_score_full", "corpus_topk_chunks", "topk_merge", "dplr_score_items_kernel",
           "embedding_bag_kernel")
    if dev.type == "cuda" and not all(launches[g] for g in ran):
        raise AssertionError(f"a kernel was not launched serving the trained model: {launches}")
    if engine.maybe_refresh(mgr, template, select=pick):
        raise AssertionError("a second poll swapped again")
    # a truncated copy of the newest step, one step on
    src = Path(mgr.directory) / f"step_{step:08d}"
    bad = Path(mgr.directory) / f"step_{step + 1:08d}"
    bad.mkdir()
    shutil.copy(src / "manifest.json", bad / "manifest.json")
    with open(src / "arrays.npz", "rb") as f_in, open(bad / "arrays.npz", "wb") as f_out:
        f_out.write(f_in.read(sz.truncate_bytes))
    t0 = time.perf_counter()
    try:
        engine.maybe_refresh(mgr, template, select=pick)
    except RefreshFailed as exc:
        if exc.step != step + 1:
            raise AssertionError(f"RefreshFailed names step {exc.step}") from exc
    else:
        raise AssertionError("a truncated newest step did not raise RefreshFailed")
    failed_s = time.perf_counter() - t0
    if engine.maybe_refresh(mgr, template, select=pick) or engine.model_step != step:
        raise AssertionError("the poll after RefreshFailed did not keep serving the last step")
    for ctx, (vals, ids) in answers:
        again = engine.topk(ctx, K)
        if not (torch.equal(again[0], vals) and torch.equal(again[1], ids)):
            raise AssertionError("after RefreshFailed the engine answers differently")
    return dict(launches=launches, note=(
        f"served: maybe_refresh installed step {step} in {refresh_s:.2f} s (restore with the "
        f"checksums of every retained step, and the slab build of {engine.n_items} items); "
        f"top-{K} at Bq={list(sz.train_serve_bqs)} by C1 and against plain ({diffs} ids "
        f"differ, all within the tie rule), Algorithm 1 on {sz.percall_n} items against "
        f"plain; a second poll found nothing; a truncated step {step + 1} raised "
        f"RefreshFailed once ({failed_s:.2f} s), the next poll found nothing and the engine "
        f"answers from step {step} as before"))


# -- phase 9: models ----------------------------------------------------------

def models_data(archs, make: str, batch: int, steps: int, seed: int = 0) -> dict:
    """The JAX trainer's batches of steps 0 .. ``steps - 1`` for each arch
    (``launch.train.build_recsys_trainer`` on ``REGISTRY[arch].<make>()``),
    as numpy.  Their labels come from ``SyntheticCTR``'s teacher, whose
    table at full width is ~2.3e9 normal draws over Wide&Deep, AutoInt and
    BST, so ``main`` runs this in a process of its own from the start of
    the script, beside the earlier phases."""
    out = {}
    for arch in archs:
        cfg = getattr(REGISTRY[arch], make)()
        _, make_batch = train.build_recsys_trainer(arch, cfg, batch, seed)
        out[arch] = [make_batch(s) for s in range(steps)]
    return out


def rank_queries(arch: str, cfg, n: int, count: int, seed: int = 0) -> list:
    """``count`` queries of ``n`` candidates, as numpy, shaped as
    ``src/repro/launch/steps.py`` shapes them: a context and candidates of
    Zipf ids (``sample_ids``, ``SyntheticCTR``'s draws); BST adds a
    behaviour history of uniform item ids, its length uniform in [1, L]
    (the rest masked), and has no item weights; MIND has a history and
    candidates only, one candidate set (the first query's) for every
    history."""
    rng = np.random.default_rng((seed, 5))
    lay = cfg.layout
    item_vocab = lay.fields[-1].vocab_size
    ctx_slots, item_slots = lay.slots_of("context"), lay.slots_of("item")
    shared = None
    out = []
    for _ in range(count):
        q = {}
        if arch in ("bst", "mind"):
            L = cfg.seq_len
            q["hist_ids"] = rng.integers(0, item_vocab, (1, L)).astype(np.int32)
            q["hist_mask"] = (np.arange(L) < rng.integers(1, L + 1)).astype(np.float32)[None]
        if arch == "mind":
            if shared is None:
                shared = rng.integers(0, item_vocab, (1, n, 1)).astype(np.int32)
            q["item_ids"] = shared
        else:
            ctx = sample_ids(lay, rng, 1)[:, ctx_slots]
            items = sample_ids(lay, rng, n)[None][..., item_slots]
            q.update(context_ids=ctx, context_weights=np.ones(ctx.shape, np.float32),
                     item_ids=items)
            if arch != "bst":
                q["item_weights"] = np.ones(items.shape, np.float32)
        out.append(q)
    return out


def pointwise_rows(arch: str, q: dict) -> dict:
    """The (context, item) rows of a query on the device, as ``apply``
    takes them (the reference's identity, ``tests/test_ranking.py``)."""
    n = q["item_ids"].shape[1]
    rows = {}
    if arch in ("bst", "mind"):
        rows.update(hist_ids=q["hist_ids"].expand(n, -1),
                    hist_mask=q["hist_mask"].expand(n, -1))
    if arch == "mind":
        rows["target_id"] = q["item_ids"][0, :, 0]
        return rows
    ids = torch.cat([q["context_ids"].expand(n, -1), q["item_ids"][0]], dim=-1)
    rows.update(ids=ids, weights=torch.ones(ids.shape, device=ids.device))
    return rows


@contextlib.contextmanager
def plain_bags(calls: list | None = None):
    """Inside, every ``ops.embedding_bag`` call (the field lookups and the
    history, target, negative and candidate gathers) runs its plain
    version, and appends ``(ids, weights, segments, out)`` to ``calls``
    when given.  Raises if a kernel launched inside."""
    kernel, before = ops.embedding_bag, dict(ops.LAUNCHES)

    def plain(table, ids, weights, bags):
        out = ref.embedding_bag_ref(table, ids, weights, bags.segments, bags.n_bags)
        if calls is not None:
            calls.append((ids, weights, bags.segments, out))
        return out

    ops.embedding_bag = plain
    try:
        yield
    finally:
        ops.embedding_bag = kernel
    if dict(ops.LAUNCHES) != before:
        raise AssertionError("the plain path launched a kernel")


def flat_items(tree, prefix=""):
    """(path, leaf) of nested dicts, in ``tree_leaves``' (sorted) order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from flat_items(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def rebuild(tree, leaves):
    """``tree``'s nested dicts with ``leaves`` in ``flat_items`` order."""
    return {k: rebuild(tree[k], leaves) if isinstance(tree[k], dict) else next(leaves)
            for k in sorted(tree)}


def leaf_blocks(t, block: int = 1 << 26) -> list:
    flat = t.reshape(-1)
    return [flat[i:i + block] for i in range(0, flat.numel(), block)]


def bit_sums(tree) -> list:
    """An int64 sum of each leaf's f32 bits (sorted key order), block by
    block, so that no leaf-sized temporary is made."""
    return [sum(int(b.view(torch.int32).sum(dtype=torch.int64)) for b in leaf_blocks(leaf))
            for _, leaf in flat_items(tree)]


def named_rows(g, rows, what: str):
    """``g``'s rows ``rows``; raises if any other row of ``g`` is nonzero.
    Zeroes those rows of ``g``: a gradient that the caller drops."""
    picked = g.index_select(0, rows)
    g.index_fill_(0, rows, 0)
    if any(int(torch.count_nonzero(b)) for b in leaf_blocks(g)):
        raise AssertionError(f"{what}: a row no slot names has a gradient")
    return picked


def model_grad_checks(mod, cfg, params, batch, what: str) -> str:
    """Step 1's loss and gradients through the kernels against the plain
    path (plain bags, autograd), by the train phase's rule: the loss within
    ``TOL * max(1, |loss|)``; each arena row that a lookup or gather names
    within ``TOL * size``, ``size`` its terms' summed magnitude (``sum |w_s|
    |dL/d bag(s)|`` over the slots naming it, from the plain path), every
    other row exactly 0 on both; every other leaf within ``TOL *
    max|plain|``.  The plain path runs first and its table gradient is cut
    to the named rows before the kernel path runs, so that one arena-sized
    gradient is alive at a time."""
    names, leaves = zip(*flat_items(params))
    live = [p.detach().requires_grad_() for p in leaves]
    tree = rebuild(params, iter(live))
    calls = []
    with plain_bags(calls), torch.enable_grad():
        plain_loss = mod.loss(tree, cfg, batch)
        got = torch.autograd.grad(plain_loss, live + [c[3] for c in calls], allow_unused=True)
    plain_loss = plain_loss.detach()
    del live, tree
    want = {n: (torch.zeros_like(p) if g is None else g)
            for n, p, g in zip(names, leaves, got)}
    k = params["embedding"].shape[1]
    rows, inv = torch.unique(torch.cat([c[0].reshape(-1).long() for c in calls]),
                             return_inverse=True)
    terms = torch.cat([
        (w.abs()[..., None] * (torch.zeros_like(out) if dV is None else dV.abs())
         .index_select(-2, seg)).reshape(-1, k)
        for (_, w, seg, out), dV in zip(calls, got[len(leaves):])])
    size = torch.zeros((rows.numel(), k), device=terms.device).index_add_(0, inv, terms)
    del calls, got, terms
    want_rows = named_rows(want.pop("embedding"), rows, f"{what} plain path")
    loss, grads = optim.value_and_grad(mod.loss)(params, cfg, batch)
    check_close(loss, plain_loss, f"{what} step-1 loss")
    grads = dict(flat_items(grads))
    diff = (named_rows(grads.pop("embedding"), rows, what) - want_rows).abs()
    if (diff > TOL * size).any():
        raise AssertionError(f"{what}: d_embedding off, max |diff| {float(diff.max()):.3g}")
    worst = 0.0
    for name, g in grads.items():
        err, scale = float((g - want[name]).abs().max()), float(want[name].abs().max())
        if not err <= TOL * scale or not torch.isfinite(g).all():
            raise AssertionError(f"{what}: d_{name} off by {err:.3g} (max |d_{name}| "
                                 f"{scale:.3g})")
        worst = max(worst, err / scale if scale else 0.0)
    return (f"step 1 against the plain path: loss {float(loss):.6f} (plain "
            f"{float(plain_loss):.6f}), d_embedding on {rows.numel()} named rows max |diff| "
            f"{float(diff.max()):.3g}, {len(grads)} other leaves max |diff| / max|g| "
            f"{worst:.3g}")


def rank_checks(dev, sz, arch, mod, cfg, params, n: int) -> tuple[dict, str]:
    """``rank_items`` on ``sz.model_queries`` queries of ``n`` candidates:
    the first against the plain path (``TOL * max(1, |s|)``) and against
    ``apply`` on the same (context, item) rows, in chunks of
    ``sz.model_apply_chunk`` rows (rtol = atol = 1e-4, the reference's
    ``tests/test_ranking.py``); then each timed (host clock ending in a
    synchronise), the launches counted over these alone."""
    queries = [train.to_device(q, dev) for q in rank_queries(arch, cfg, n, sz.model_queries)]
    with torch.no_grad():
        got = mod.rank_items(params, cfg, queries[0])
        with plain_bags():
            plain = mod.rank_items(params, cfg, queries[0])
        if got.shape != (1, n):
            raise AssertionError(f"{arch} rank_items: shape {tuple(got.shape)}")
        err = check_close(got, plain, f"{arch} rank_items n={n} against plain")
        rows = pointwise_rows(arch, queries[0])
        step = sz.model_apply_chunk
        point = torch.cat([mod.apply(params, cfg, {k: v[i:i + step] for k, v in rows.items()})
                           for i in range(0, n, step)])
        gap = (got[0] - point).abs()
        if not torch.isfinite(got).all() or (gap > 1e-4 + 1e-4 * point.abs()).any():
            raise AssertionError(f"{arch} rank_items n={n} leaves apply by "
                                 f"{float(gap.max()):.3g}")
        ops.reset_launches()
        lat = []
        for q in queries:
            t0 = time.perf_counter()
            mod.rank_items(params, cfg, q)
            _sync(dev)
            lat.append((time.perf_counter() - t0) * 1e3)
    return launches_of(("embedding_bag",)), (
        f"rank_items at 1 x {n}: median {np.median(lat):.3f} ms over {len(lat)} queries "
        f"(host clock, synchronized), against plain max |diff| {err:.3g}, against apply on "
        f"the same rows max |diff| {float(gap.max()):.3g}")


def model_run(dev, sz, arch: str, batches: list) -> dict:
    """One architecture at ``REGISTRY[arch].<sz.model_make>()``: step 1
    against the plain path, two runs of ``len(batches)`` adagrad steps from
    one seed bitwise equal (losses, and bit sums of params and
    accumulator), then ``rank_items`` at each n of ``sz.model_ranks[arch]``
    on the second run's params.  Returns its launches and its note."""
    cfg = getattr(REGISTRY[arch], sz.model_make)()
    mod = train.recsys_module(arch)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    init = lambda: mod.init(torch.Generator(device=dev).manual_seed(0), cfg)  # noqa: E731
    t_arch = time.perf_counter()
    params = init()
    arena = tuple(params["embedding"].shape)
    n_params = sum(t.numel() for _, t in flat_items(params))
    notes = [model_grad_checks(mod, cfg, params, train.to_device(batches[0], dev), arch)]
    optimizer = optim.adagrad()
    timer = StepTimer(dev)
    launches = collections.Counter()
    runs = []
    for run in range(2):
        if run:
            params = init()
        state = optimizer.init(params)
        ops.reset_launches()
        # the pipeline makes a batch or two past the last step: served and dropped
        losses, _ = run_steps(mod, cfg, optimizer, params, state,
                              lambda s: batches[s % len(batches)], 0, len(batches),
                              sz.model_lr, dev, timer=None if run else timer)
        launches.update(launches_of(TRAIN_KERNELS))
        runs.append((torch.stack(losses), bit_sums({"params": params, "opt": state})))
        del state
        if not run:
            del params
    (la, fa), (lb, fb) = runs
    if not (torch.equal(la, lb) and fa == fb):
        raise AssertionError(f"{arch}: two runs of {len(batches)} steps from one seed differ")
    split = timer.medians()
    for n in sz.model_ranks[arch]:
        ranked, note = rank_checks(dev, sz, arch, mod, cfg, params, n)
        launches.update(ranked)
        notes.append(note)
    if dev.type == "cuda" and not all(launches[g] for name in TRAIN_KERNELS
                                      for g in ops.KERNELS[name]):
        raise AssertionError(f"{arch}: a kernel was not launched: {dict(launches)}")
    del params
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB" if dev.type == "cuda"
            else "not measured")
    B = len(next(iter(batches[0].values())))
    return dict(launches=launches, note=(
        f"{arch}: {arena[0]} x {arena[1]} arena, {n_params} params; {notes[0]}; two runs of "
        f"{len(batches)} adagrad steps at B={B} lr={sz.model_lr} bitwise equal (losses "
        f"{float(la[0]):.5f} -> {float(la[-1]):.5f}, bit sums of params and accumulator); "
        f"median step {split['step']:.3f} ms (forward {split['forward']:.3f}, backward "
        f"{split['backward']:.3f}, update {split['update']:.3f}; "
        f"{'CUDA events' if dev.type == 'cuda' else 'host clock'}); {'; '.join(notes[1:])}; "
        f"peak memory {peak}; {time.perf_counter() - t_arch:.1f} s; launches {dict(launches)}"))


def models_phase(dev, sz, batches: dict) -> dict:
    """Wide&Deep, AutoInt, BST and MIND, one at a time, each freed before
    the next (``model_run``), on the batches of ``models_data``.  Returns
    the launches of kernels 5 and 5' over their steps and timed queries."""
    t_phase = time.perf_counter()
    launches = collections.Counter()
    notes = []
    for arch in sz.models:
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out = model_run(dev, sz, arch, batches[arch])
        launches.update(out["launches"])
        notes.append(out["note"])
    print(f"phase models: {' | '.join(notes)}; wall {time.perf_counter() - t_phase:.1f} s; "
          f"launches {dict(launches)}", flush=True)
    return dict(launches)


# -- phase 10: lm --------------------------------------------------------------

LM_Q_CHUNK = 512   # the f32 reference prefill's query chunk (gqa_attention)


def plain_prefill(params, cfg, tokens, max_seq, attend):
    """``tm.prefill`` with ``attend(q, k, v, positions, window)`` in place of
    the kernel, built from the port's layer pieces (as ``plain_apply``
    builds ``fwfm.apply``): (last logits, bf16 cache)."""
    cparams = tm.cast_params(params, cfg.compute_dtype)
    B, S = tokens.shape
    cache = tm.init_cache(cfg, B, max_seq, device=tokens.device)
    x = tm.embed(cparams, cfg, tokens)
    pos = torch.arange(S, device=tokens.device)
    for i in range(cfg.n_layers):
        lp = tm.layer_params(cparams, i)
        q, k, v = tm.attention_inputs(lp, cfg, x, pos)
        x = tm.finish_layer(lp, cfg, x, attend(q, k, v, pos, cfg.window(i)))
        cache[i, 0, :, :S] = k.to(torch.bfloat16)
        cache[i, 1, :, :S] = v.to(torch.bfloat16)
    return tm._logits(cparams, cfg, x[:, -1:]), cache


def flash_plain(q, k, v, pos, window):
    """The kernel's plain version (its rounding points)."""
    return ref.flash_attention_plain(q, k, v, window=window)


def gqa_chunked(q, k, v, pos, window):
    """The JAX package's plain attention, in query chunks of ``LM_Q_CHUNK``."""
    return attention.gqa_attention(q, k, v, n_kv_heads=k.shape[2], q_positions=pos,
                                   k_positions=pos, window=window, q_chunk=LM_Q_CHUNK)


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def cache_diff(cache, want, S: int) -> float:
    """Max |diff| over positions 0..S-1 of two caches, a layer at a time."""
    return max(_max_diff(cache[i, :, :, :S], want[i, :, :, :S]) for i in range(cache.shape[0]))


def stepwise_mlp(lp, cfg, h):
    """The FFN of ``h (B, n, d)`` as n decode steps give it.  An MoE layer
    routes a step's B tokens as one group (capacity ceil(B k cf / E)):
    here each position's B tokens are one group, the n groups in one call.
    A dense FFN is per token anyway."""
    if not cfg.is_moe:
        return tm._mlp(lp, cfg, h)
    B, n, d = h.shape
    step = dataclasses.replace(cfg, moe_group_size=B)
    return tm._mlp(lp, step, h.transpose(0, 1).reshape(n * B, d)).reshape(n, B, d).transpose(0, 1)


def plain_extend(params, cfg, tokens, cache, start: int):
    """One trunk pass over ``tokens (B, n)`` at positions ``start..start+n-1``
    against the k/v that ``cache`` holds before ``start``: the n positions'
    hidden states (pre-final-norm) and the cast parameters.  Its attention
    is ``attention.gqa_attention``, whose bf16 scores round as
    ``decode_attention``'s do, and its keys go through the cache's type and
    span the cache's slots as decode's do (the slots past the new positions
    masked by position); an MoE layer groups its tokens as decode does
    (``stepwise_mlp``).  What it does not share with ``tm.decode_step`` is
    the number of query positions in each product (n at once, not one)."""
    cparams = tm.cast_params(params, cfg.compute_dtype)
    B, n = tokens.shape
    x = tm.embed(cparams, cfg, tokens)
    q_pos = torch.arange(start, start + n, device=tokens.device)
    k_pos = torch.arange(cache.shape[3], device=tokens.device)
    for i in range(cfg.n_layers):
        lp = tm.layer_params(cparams, i)
        q, k, v = tm.attention_inputs(lp, cfg, x, q_pos)
        keys, vals = (torch.cat([cache[i, j, :, :start], new.to(cache.dtype),
                                 cache[i, j, :, start + n:]], 1).to(q.dtype)
                      for j, new in ((0, k), (1, v)))
        o = attention.gqa_attention(q, keys, vals, n_kv_heads=cfg.n_kv_heads,
                                    q_positions=q_pos, k_positions=k_pos, window=cfg.window(i))
        x = x + o.reshape(B, n, cfg.n_heads * cfg.hd) @ lp["wo"]
        x = x + stepwise_mlp(lp, cfg, tm._rms(x, lp["ln_mlp"]))
    return x, cparams


@contextlib.contextmanager
def routed(force=None, keep: int | None = None, plan=None):
    """Inside, each routing of an MoE layer (``moe.top_experts``, through
    which the one-device FFN and the mesh plan both choose, layer by layer;
    a remat recompute routes again) appends to ``.own`` the experts (T, k)
    its own logits choose, and runs under the next entry of ``force`` when
    given, else under its own.  ``plan`` (a mesh plan, with ``force``):
    each running position routes a layer, so an entry spans that many
    calls; a position takes its replica's rows of the forced entry (all
    of it where the layer routed every token), and ``.own`` holds each
    replica's rows from its model position 0.  ``keep``: the input of
    ``moe.moe_ffn`` call number ``keep`` is kept as ``.input``.  A check
    that compares two paths of an MoE model holds them under one set of
    routes this way, and counts where their own differ."""
    if plan is not None and force is None:
        raise ValueError("routed: a mesh plan routes under forced entries")
    rec = SimpleNamespace(own=[], input=None)
    real, real_ffn = moe.top_experts, moe.moe_ffn
    given = None if force is None else iter(force)
    per = 1 if plan is None else len(plan.pos)
    state = {"calls": 0, "entry": None, "mine": [], "ffn": 0}

    def choosing(logits, k):
        mine = real(logits, k)
        i = state["calls"] % per
        state["calls"] += 1
        if i == 0:
            state["entry"] = None if given is None else next(given)
            state["mine"] = []
        T = mine.numel() // k
        want = state["entry"]
        if plan is not None and plan.j(i) == 0:
            state["mine"].append(mine.reshape(T, k))
        if i == per - 1:
            rec.own.append(mine.reshape(T, k) if plan is None else
                           state["mine"][0] if T == want.shape[0] else torch.cat(state["mine"]))
        if want is None:
            return mine
        if want.shape[0] != T:
            r = plan.index[plan.pos[i]] // plan.m
            want = want[r * T:(r + 1) * T]
        return want.to(mine.device).reshape(mine.shape)

    def keeping(x, *args, **kw):
        if keep == state["ffn"]:
            rec.input = x
        state["ffn"] += 1
        return real_ffn(x, *args, **kw)

    moe.top_experts = choosing
    if keep is not None:
        moe.moe_ffn = keeping
    try:
        yield rec
    finally:
        moe.top_experts, moe.moe_ffn = real, real_ffn
    if state["calls"] % per:
        raise AssertionError(f"routed: {state['calls']} routings, not whole layers of {per}")
    if given is not None and next(given, None) is not None:
        raise AssertionError("routed: more forced routes than MoE calls")


def route_diff(a: list, b: list, mcfg) -> tuple[int, int]:
    """(call, token) pairs whose routes differ between two lists of
    experts (T, k): in their experts, and in experts, slots or keep (slots
    in groups of ``min(mcfg.group_size, T)``: one changed choice moves the
    slots of the group's later tokens in that expert)."""
    if len(a) != len(b):
        raise AssertionError(f"route lists of {len(a)} and {len(b)} calls")
    n_experts = n_any = 0
    for ea, eb in zip(a, b):
        (sa, ka), (sb, kb) = moe.slots(ea, mcfg), moe.slots(eb, mcfg)
        n_experts += int((ea != eb).any(1).sum())
        n_any += int(((ea != eb) | (sa != sb) | (ka != kb)).any(1).sum())
    return n_experts, n_any


def _share(counts: tuple[int, int], n: int) -> str:
    return (f"experts {counts[0]} of {n} ({counts[0] / n:.2e}), with slots and keep "
            f"{counts[1]} ({counts[1] / n:.2e})")


def dropped(routes: list, mcfg) -> list:
    """Each call's share of (token, choice) pairs past capacity."""
    return [1 - float(moe.slots(e, mcfg)[1].float().mean()) for e in routes]


def lm_phase(dev, sz) -> dict:
    """gemma3-1b (``sz.make_lm``) at full width, then starcoder2-7b and
    yi-9b (``sz.lm_models``) at full width, then the MoE LMs
    (``sz.lm_moe``: granite-moe-1b-a400m at full width and depth, mixtral-8x7b
    at full width and 4 layers), one at a time, each freed before the next:
    ``lm_model_run``.  Returns the launches of kernel 7's CUDA kernels over
    the kernel prefills, by name."""
    launches = lm_model_run(dev, sz.make_lm(), sz.lm_batch, sz.lm_prompt, sz.lm_cache,
                            sz.lm_steps)
    S, n = sz.lm_model_prompt, sz.lm_model_steps
    runs = [(make, 1, S, S + n, n, None) for make in sz.lm_models]
    runs += [(*run, sz.moe_impl_layer if i == 0 else None) for i, run in enumerate(sz.lm_moe)]
    for make, B, S, S_max, n_steps, impl_layer in runs:
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        more = lm_model_run(dev, make(), B, S, S_max, n_steps, impl_layer=impl_layer)
        for g, count in more.items():
            launches[g] += count
    gc.collect()
    return launches


def lm_model_run(dev, cfg, B: int, S: int, S_max: int, n_steps: int,
                 impl_layer: int | None = None) -> dict:
    """One LM at its widths, random f32 weights from seed 0 (their count
    held to ``cfg.n_params()``), bf16 compute: the kernel prefill of B
    random prompts of S tokens into an S_max-slot cache, the plain bf16 and
    f32 prefills (the f32 one through ``gqa_attention``), and ``n_steps``
    greedy decode steps from the kernel prefill's cache against one pass
    over the decoded positions (``plain_extend``).  An MoE model's
    prefill and steps run twice, timed and then with each layer's routes
    recorded (``routed``); the plain paths run under the recorded routes,
    and the (layer, token) routes their own logits would take instead are
    counted.  With ``impl_layer``, that MoE layer's implementations are
    checked on its prefill input (``moe_impl_check``).  Returns the
    launches of kernel 7's CUDA kernels over the timed kernel prefill, by
    name."""
    f32_cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    V, L = cfg.vocab, cfg.n_layers
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_init = time.perf_counter()
    params = tm.init(torch.Generator(device=dev).manual_seed(0), cfg)
    count = sum(t.numel() for t in optim.optimizers.tree_leaves(params))
    if count != cfg.n_params():
        raise AssertionError(f"lm {cfg.name}: {count} parameters, n_params() says "
                             f"{cfg.n_params()}")
    init_s = time.perf_counter() - t_init
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, V, (B, S), generator=gen, device=dev)

    ops.reset_launches()
    t0 = time.perf_counter()
    logits, cache = tm.prefill(params, cfg, tokens, S_max, device=dev)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    launches = {g: ops.LAUNCHES[g] for g in ops.KERNELS["flash_attention"]}
    if dev.type == "cuda" and launches["flash_attention_wgmma"] != L:
        raise AssertionError(f"prefill launched the kernels {launches}, not "
                             f"flash_attention_wgmma once a layer ({L})")
    route = contextlib.nullcontext
    krec = None
    if cfg.is_moe:
        del logits, cache
        with routed(keep=impl_layer) as krec:
            logits, cache = tm.prefill(params, cfg, tokens, S_max, device=dev)
        route = lambda: routed(force=krec.own)                          # noqa: E731
    before = sum(ops.LAUNCHES.values())
    t0 = time.perf_counter()
    with route() as prec:
        plain_logits, plain_cache = plain_prefill(params, cfg, tokens, S_max, flash_plain)
    _sync(dev)
    plain_s = time.perf_counter() - t0
    with route() as frec:
        f32_logits, f32_cache = plain_prefill(params, f32_cfg, tokens, S_max, gqa_chunked)
    _sync(dev)
    if sum(ops.LAUNCHES.values()) != before:
        raise AssertionError("the plain prefills launched a kernel")
    errs = {}
    for name, got, want in (("logits", logits[..., :V], f32_logits[..., :V]),
                            ("plain logits", plain_logits[..., :V], f32_logits[..., :V])):
        if not torch.isfinite(got).all():
            raise AssertionError(f"lm: non-finite {name}")
        errs[name] = _max_diff(got, want)
    errs["cache"] = cache_diff(cache, f32_cache, S)
    errs["plain cache"] = cache_diff(plain_cache, f32_cache, S)
    del plain_cache, f32_cache
    rel = {name: errs[name] / max(errs[f"plain {name}"], 1e-30) for name in ("logits", "cache")}
    for name in rel:
        if not errs[name] <= 1.25 * errs[f"plain {name}"]:
            raise AssertionError(f"lm: the kernel path's {name} error {errs[name]:.4g} from "
                                 f"f32 > 1.25 x the plain path's {errs[f'plain {name}']:.4g}")
    top1 = int((logits[..., :V].argmax(-1) == plain_logits[..., :V].argmax(-1)).sum())

    # greedy decode from the kernel prefill, against one pass over the same
    # tokens at those positions with decode's numerics
    tok = logits[:, -1, :V].argmax(-1, keepdim=True)
    step_cache = cache.clone() if cfg.is_moe else cache    # MoE: the timed steps on a copy
    fed, steps, step_ms = [], [], []
    for i in range(n_steps):
        fed.append(tok)
        t0 = time.perf_counter()
        lg, step_cache = tm.decode_step(params, cfg, tok, step_cache, S + i, device=dev)
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        steps.append(lg[:, 0, :V])
        tok = lg[:, -1, :V].argmax(-1, keepdim=True)
    got = torch.stack(steps, 1)                                # (B, n_steps, V)
    moe_note = ""
    if cfg.is_moe:
        del step_cache
        with routed() as drec:              # the same steps again, routes recorded
            again = [tm.decode_step(params, cfg, t, cache, S + i, device=dev)[0][:, 0, :V]
                     for i, t in enumerate(fed)]
        again = torch.stack(again, 1)
        timed_same = torch.equal(again, got)
        got = again
        # layer l's routes over the steps, position-major as stepwise_mlp takes them
        ext_routes = [torch.cat(drec.own[l::L]) for l in range(L)]
        with routed(force=ext_routes) as erec:
            h, cparams = plain_extend(params, cfg, torch.cat(fed, 1), cache, S)
        mcfg, step_mcfg = cfg.moe_cfg, dataclasses.replace(cfg.moe_cfg, group_size=B)
        n_pre, n_dec = L * B * S, L * B * n_steps
        diff = {"plain": route_diff(krec.own, prec.own, mcfg),
                "f32": route_diff(krec.own, frec.own, mcfg),
                "decode": route_diff(ext_routes, erec.own, step_mcfg)}
        drop_pre, drop_dec = dropped(krec.own, mcfg), dropped(ext_routes, step_mcfg)
        moe_note = (
            f"; MoE {cfg.n_experts} experts top-{cfg.top_k}, capacity {moe.capacity(mcfg)} "
            f"an expert a group of {moe.group_size(mcfg, B * S)} ({moe.capacity(step_mcfg)} "
            f"a decode step's group of {B}), {cfg.moe_impl}: the plain prefills and the "
            f"one-pass decode check ran under the kernel path's routes; (layer, token) "
            f"routes their own logits would change: plain bf16 {_share(diff['plain'], n_pre)}, "
            f"f32 {_share(diff['f32'], n_pre)}, one pass over the steps "
            f"{_share(diff['decode'], n_dec)}; dropped (token, choice) share by layer, "
            f"prefill [" + ", ".join(f"{x:.4f}" for x in drop_pre) + "], decode steps ["
            + ", ".join(f"{x:.3f}" for x in drop_dec) + f"]; the timed steps' logits "
            f"{'bitwise' if timed_same else 'not bitwise'} the recorded steps'")
        if impl_layer is not None:
            moe_note += "; " + moe_impl_check(dev, cfg, params, krec.input, impl_layer,
                                              krec.own[impl_layer])
    else:
        h, cparams = plain_extend(params, cfg, torch.cat(fed, 1), cache, S)
    del cache
    want = tm._logits(cparams, cfg, h)[..., :V]
    emb = (cparams["embed"] if cfg.tie_embeddings else cparams["lm_head"].T)[:V].float().abs()
    size = tm._rms(h, cparams["final_ln"]).float().abs() @ emb.T
    bound = 3e-3 + 3e-2 * want.float().abs()
    diff = (got.float() - want.float()).abs()
    ratio = float((diff / bound).max())
    size_ratio = float((diff / (bound + 2.0**-8 * size)).max())
    if not torch.isfinite(got).all() or ratio > 1.0:
        raise AssertionError(f"lm decode: {int((diff > bound).sum())} of {diff.numel()} "
                             f"logits beyond 3e-3 + 3e-2 |x| (max ratio {ratio:.3f})")
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB" if dev.type == "cuda"
            else "not measured")
    print(f"phase lm: {cfg.name} {L} layers d={cfg.d_model} H={cfg.n_heads} "
          f"KV={cfg.n_kv_heads} hd={cfg.hd} vocab={V}, {count} parameters (f32, seed 0; "
          f"= n_params(); made in {init_s:.1f} s), bf16 compute; B={B} prompts of {S} "
          f"tokens into {S_max} slots; "
          f"prefill {prefill_s:.3f} s through the kernel ({launches}, one a layer), "
          f"{plain_s:.3f} s through the plain attention (host clock, synchronized); max |diff| "
          f"from the plain f32 prefill: last logits {errs['logits']:.4g} (plain path "
          f"{errs['plain logits']:.4g}, ratio {rel['logits']:.3f} <= 1.25), cache "
          f"{errs['cache']:.4g} (plain path {errs['plain cache']:.4g}, ratio "
          f"{rel['cache']:.3f} <= 1.25); top-1 token equal to "
          f"the plain path's in {top1} of {B}; {n_steps} greedy decode steps, median "
          f"{np.median(step_ms):.2f} ms a step; decode logits against one pass over the "
          f"{n_steps} positions on the prefill's cache: max |diff| {float(diff.max()):.4g}, "
          f"max |diff| / (3e-3 + 3e-2 |x|) {ratio:.3f} <= 1 (with 2^-8 size added, size up "
          f"to {float(size.max()):.3g}: {size_ratio:.3f}){moe_note}; peak "
          f"memory {peak}", flush=True)
    del params, cparams, emb, size, h, want, got, logits, plain_logits, f32_logits
    return launches


# (impl, fused_combine): the MoE implementations of the reference
MOE_IMPLS = (("einsum", False), ("scatter", False), ("einsum", True))


def moe_impl_check(dev, cfg, params, x, layer: int, experts) -> str:
    """MoE layer ``layer`` on its prefill input ``x`` (bf16), under the
    prefill's routes ``experts``, through each implementation the
    reference's ``launch/steps.py`` selects (einsum, scatter, fused
    combine), with the layer's weights in f32 and cast to bf16.  Bounds:
    in f32 each within ``1e-5 max |einsum|`` of the einsum output; in bf16
    each one's largest error from the f32 einsum output at most ``top_k``
    times the bf16 einsum's (the scatter impl rounds each of its k
    products and k - 1 adds to bf16, where the einsum's combine rounds
    once; the fused combine rounds the gated activations).  Also times
    each in bf16 (``device_ms``), and the routing (router product, top-k,
    slots) and the experts' three products alone."""
    lp32 = {k: params["layers"][k][layer] for k in ("router", "w_gate", "w_in", "w_out")}
    out, ms = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        lp = {k: v.to(dtype) for k, v in lp32.items()}
        xx = x.to(dtype)
        for impl, fused in MOE_IMPLS:
            mcfg = dataclasses.replace(cfg.moe_cfg, impl=impl, fused_combine=fused)
            call = lambda: moe.moe_ffn(xx, lp["router"], lp["w_gate"], lp["w_in"],  # noqa
                                       lp["w_out"], mcfg, experts)
            out[dtype, impl, fused] = call()
            if dtype == torch.bfloat16:
                ms[impl, fused] = device_ms(call, 3, 2) if dev.type == "cuda" else None
            _sync(dev)
    ref32 = out[torch.float32, "einsum", False].float()
    scale = float(ref32.abs().max())
    parts = []
    for impl, fused in MOE_IMPLS[1:]:
        d32 = _max_diff(out[torch.float32, impl, fused], ref32)
        if not d32 <= 1e-5 * scale:
            raise AssertionError(f"moe {impl} fused={fused} f32: {d32:.4g} from einsum, "
                                 f"max |out| {scale:.4g}")
        parts.append(f"{impl}{' fused combine' if fused else ''} f32 {d32:.3g}")
    e16 = {key: _max_diff(out[(torch.bfloat16, *key)], ref32) for key in MOE_IMPLS}
    for key in MOE_IMPLS[1:]:
        if not e16[key] <= cfg.top_k * e16["einsum", False]:
            raise AssertionError(f"moe {key} bf16: error {e16[key]:.4g} from f32 > top_k x "
                                 f"the einsum's {e16['einsum', False]:.4g}")
    lp = {k: v.to(torch.bfloat16) for k, v in lp32.items()}
    x16 = x.to(torch.bfloat16)
    mcfg = cfg.moe_cfg
    gsz = moe.group_size(mcfg, x16.numel() // x16.shape[-1])
    gcfg = dataclasses.replace(mcfg, group_size=gsz)

    def routing():
        e = moe.route(x16, lp["router"], mcfg)
        return moe.slots(e, mcfg)

    ex_in = torch.zeros(x16.numel() // x16.shape[-1] // gsz, cfg.n_experts, moe.capacity(gcfg),
                        cfg.d_model, dtype=torch.bfloat16, device=x16.device)
    experts_ffn = lambda: moe._expert_ffn(lp["w_gate"], lp["w_in"], lp["w_out"], ex_in)  # noqa
    route_ms, expert_ms = ((device_ms(routing, 3, 2), device_ms(experts_ffn, 3, 2))
                           if dev.type == "cuda" else (None, None))
    del out, ref32, ex_in
    return (f"MoE implementations on layer {layer}'s prefill input ({tuple(x.shape)}) under "
            f"its routes, max |diff| from einsum: " + ", ".join(parts)
            + f" (<= 1e-5 x max |out| {scale:.4g}); bf16 error from the f32 einsum: "
            + ", ".join(f"{i}{' fused' if f else ''} {e16[i, f]:.4g}" for i, f in MOE_IMPLS)
            + f" (each <= {cfg.top_k} x einsum's); one bf16 call: "
            + ", ".join(f"{i}{' fused' if f else ''} {_ms(ms[i, f])}" for i, f in MOE_IMPLS)
            + f", of it routing alone {_ms(route_ms)} and the experts' products alone "
            f"{_ms(expert_ms)} (CUDA events, median of 3 x 2 calls)")


# -- phase 10b: gnn -----------------------------------------------------------

def gnn_batches(sz, name: str, cfg, steps: int):
    """``steps`` numpy batches of one PNA shape (``pna_cfg.SHAPES``) at its
    source's sizes, from ``sz.gnn_seed``; and a note.  ``minibatch_lg``: a
    ``random_graph`` of ``sz.gnn_graph`` (nodes, average degree), d_feat
    602, sampled ``sz.gnn_minibatch`` (seeds a step, fanout: 1,024 and
    (15, 10), the shape's) at a time; ``molecule``:
    128 graphs of 30 nodes and 64 random edges each (block-diagonal, graph
    task); ``full_graph_sm``: 2,708 nodes and 10,556 uniform random edges,
    d_feat 1,433, the same full batch every step."""
    dims = {s.name: s.dims for s in pna_cfg.SHAPES}[name]
    rng = np.random.default_rng(sz.gnn_seed)
    if name == "minibatch_lg":
        n, deg = sz.gnn_graph
        t0 = time.perf_counter()
        g = sampler.random_graph(rng, n, deg, cfg.d_feat, cfg.n_classes)
        made = time.perf_counter() - t0
        seeds, fan = sz.gnn_minibatch
        out = [sampler.sample_subgraph(g, rng.integers(0, n, seeds), fan, rng)
               for _ in range(steps)]
        cap = sampler.subgraph_shapes(seeds, fan, cfg.d_feat)
        note = (f"random_graph of {n} nodes, {int(g.indptr[-1])} edges (average degree "
                f"{deg}; made in {made:.1f} s), {seeds} seeds a step, fanout "
                f"{fan}: {cap[0]} nodes and {cap[1]} edge slots a step, "
                f"{int(out[0]['edge_mask'].sum())} live in step 1")
        return out, note
    if name == "molecule":
        G, npg, epg = dims["n_graphs"], dims["nodes_per_graph"], dims["edges_per_graph"]
        out = []
        for _ in range(steps):
            off = np.repeat(np.arange(G) * npg, epg)
            out.append({
                "node_feat": rng.standard_normal((G * npg, cfg.d_feat), dtype=np.float32),
                "edge_src": (rng.integers(0, npg, G * epg) + off).astype(np.int32),
                "edge_dst": (rng.integers(0, npg, G * epg) + off).astype(np.int32),
                "graph_ids": np.repeat(np.arange(G), npg).astype(np.int32),
                "n_graphs": G,
                "labels": rng.integers(0, cfg.n_classes, G).astype(np.int32)})
        return out, f"{G} graphs x {npg} nodes x {epg} edges, graph task"
    n, E = dims["n_nodes"], dims["n_edges"]
    one = {"node_feat": rng.standard_normal((n, cfg.d_feat), dtype=np.float32),
           "edge_src": rng.integers(0, n, E).astype(np.int32),
           "edge_dst": rng.integers(0, n, E).astype(np.int32),
           "labels": rng.integers(0, cfg.n_classes, n).astype(np.int32)}
    return [one] * steps, f"{n} nodes, {E} edges, full batch"


def tree_to(tree: dict, dev) -> dict:
    return {k: tree_to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def gnn_phase(dev, sz) -> str:
    """PNA (``sz.gnn_make()``: d_hidden 75, 4 layers, 4 aggregators x 3
    scalers) at each shape of ``sz.gnn_shapes`` (``shape_config``), random
    weights from seed 0: step 1's loss on the card against the port's CPU
    loss on the same weights and batch, then ``sz.gnn_steps`` adamw steps
    at ``sz.gnn_lr`` on the card, every loss finite, step time (CUDA
    events) and peak memory.  The step-1 bound: ``1e-4 max(1, |loss|)``
    plus twice the CPU's own spread (its loss with the node features one
    ulp up): the card's ``index_add_`` adds with atomics in any order and
    its matmuls round otherwise, and the std aggregator's ``E[m^2] -
    E[m]^2`` magnifies a last-bit difference where a node takes several
    identical messages (the sampler draws with replacement).  No kernel of
    the repo is on this path (none in the reference): none may launch."""
    base = sz.gnn_make()
    shapes = {s.name: s for s in pna_cfg.SHAPES}
    opt = optim.adamw()
    grad_fn = optim.value_and_grad(pna.loss)
    parts = []
    t_phase = time.perf_counter()
    ops.reset_launches()
    for name in sz.gnn_shapes:
        cfg = pna_cfg.shape_config(base, shapes[name])
        t0 = time.perf_counter()
        batches, note = gnn_batches(sz, name, cfg, sz.gnn_steps)
        host_s = time.perf_counter() - t0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        params = pna.init(torch.Generator(device=dev).manual_seed(0), cfg)
        cpu_params = tree_to(params, "cpu")
        first = train.to_device(batches[0], "cpu")
        with torch.no_grad():
            want = float(pna.loss(cpu_params, cfg, first))
            feat = first["node_feat"]
            nudged = dict(first, node_feat=torch.nextafter(feat, torch.full_like(feat, np.inf)))
            spread = abs(float(pna.loss(cpu_params, cfg, nudged)) - want)
        del cpu_params, first, nudged, feat
        state = opt.init(params)
        losses, ms = [], []
        for batch in batches:
            batch = train.to_device(batch, dev)
            start = time.perf_counter()
            if dev.type == "cuda":
                t_a, t_b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t_a.record()
            loss, grads = grad_fn(params, cfg, batch)
            params, state = opt.update(grads, state, params, sz.gnn_lr)
            if dev.type == "cuda":
                t_b.record()
                t_b.synchronize()
                ms.append(t_a.elapsed_time(t_b))
            else:
                ms.append((time.perf_counter() - start) * 1e3)
            losses.append(float(loss))
        got = losses[0]
        bound = 1e-4 * max(1.0, abs(want)) + 2 * spread
        if not np.isfinite(losses).all() or abs(got - want) > bound:
            raise AssertionError(f"gnn {name}: losses {losses}; step 1 {got:.6g} against the "
                                 f"CPU's {want:.6g} (bound {bound:.3g})")
        peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
                if dev.type == "cuda" else "not measured")
        parts.append(f"{name} (d_feat {cfg.d_feat}, {cfg.n_classes} classes, task {cfg.task}; "
                     f"{note}; host data {host_s:.1f} s): step 1 loss {got:.6f}, the CPU's "
                     f"{want:.6f} (|diff| {abs(got - want):.3g} <= {bound:.3g}, CPU spread "
                     f"{spread:.3g}); {sz.gnn_steps} adamw steps lr={sz.gnn_lr}, losses "
                     f"{losses[0]:.4f} -> {losses[-1]:.4f}, all finite; median step "
                     f"{float(np.median(ms)):.3f} ms ({'CUDA events' if dev.type == 'cuda' else 'host clock'}); "
                     f"peak memory {peak}")
        del params, state, grads, batches, batch
        gc.collect()
    launched = sum(ops.LAUNCHES.values())
    if launched:
        raise AssertionError(f"gnn: the path launched kernels of the repo: {dict(ops.LAUNCHES)}")
    print(f"phase gnn: PNA d_hidden={base.d_hidden} {base.n_layers} layers, 4 aggregators x 3 "
          f"scalers, random f32 weights (seed 0); " + "; ".join(parts)
          + f"; no kernel of the repo launched (none on this path); ogb_products does not "
          f"fit one card, whole or partitioned; wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return "gnn"


# -- phase 10c: lm-train --------------------------------------------------------

def skeleton(tree: dict) -> dict:
    """The tree's keys with None leaves (a restore template)."""
    return {k: skeleton(v) if isinstance(v, dict) else None for k, v in tree.items()}


def lm_steps(mod, cfg, opt, params, state, make_batch, start, stop, lr, dev, timer=None,
             mgr=None, save_at=None):
    """Adamw steps ``start + 1 .. stop`` of the LM trainer (``train_step``,
    under ``train.deterministic()`` as the lm module asks), a checkpoint
    after step ``save_at`` into ``mgr``.
    Returns the losses (0-d tensors)."""
    losses = []
    for step in range(start, stop):
        batch = train.to_device(make_batch(step), dev)
        if timer is not None:
            timer.begin()
        loss, params, state = train.train_step(mod, cfg, opt, params, state, batch, lr,
                                               mark=timer and timer.mark)
        losses.append(loss)
        if mgr is not None and step + 1 == save_at:
            mgr.save({"params": params, "opt": state}, step + 1, blocking=True)
    return losses


def lm_train_phase(dev, sz) -> str:
    """Each LM of ``sz.lm_train_models`` (gemma3-1b, granite-moe-1b-a400m),
    one at a time, each freed before the next: ``lm_train_run``."""
    for make in sz.lm_train_models:
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        lm_train_run(dev, sz, make())
    return "lm-train"


def lm_train_run(dev, sz, cfg) -> None:
    """One LM (full width, random f32 weights from seed 0, bf16 compute,
    remat, 512-query attention chunks and 512-position loss chunks) through
    ``launch.train``'s LM trainer: ``sz.lm_train_steps``
    adamw steps at B = ``sz.lm_train_batch`` x ``sz.lm_train_seq`` zipf
    tokens (the JAX trainer's draws), lr ``sz.lm_train_lr``, each step
    under ``train.deterministic()``.  Step 1's loss against two plain-path
    losses on the same weights, without checkpointing (under
    ``train.deterministic()`` too): in bf16 within
    ``1e-5 max(1, |loss|)`` (the same operations), in f32 compute within
    ``2^-7 max(1, |loss|)`` (bf16 rounds every activation, by at most 2^-8
    each; the loss is a mean over all positions).  An MoE model's f32 loss
    runs under the bf16 loss's routes (``routed``), and the (layer, token)
    routes its own logits would change are counted.  Every loss finite; no
    kernel of the repo launches (the loss attends through the plain
    ``gqa_attention``, as the JAX loss does).  Then the resume check at the
    full widths with ``sz.lm_resume_layers`` layers: run A
    ``sz.lm_resume_steps`` steps with a checkpoint at
    ``sz.lm_resume_save``, run B restored from it to the end, bitwise run A
    (losses, params, adamw state)."""
    B, S, n_steps, lr = sz.lm_train_batch, sz.lm_train_seq, sz.lm_train_steps, sz.lm_train_lr
    t_phase = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mod, make_batch = train.build_lm_trainer(cfg.name, cfg, B, S, 0, dev)
    opt = optim.adamw()
    params = mod.init(torch.Generator(device=dev).manual_seed(0), cfg)
    n_params = sum(t.numel() for t in optim.optimizers.tree_leaves(params))
    first = train.to_device(make_batch(0), dev)
    ops.reset_launches()
    route_note = ""
    with torch.no_grad(), train.deterministic():
        with routed() if cfg.is_moe else contextlib.nullcontext() as rec16:
            plain16 = float(tm.lm_loss(params, dataclasses.replace(cfg, remat=False), first,
                                       device=dev))
        with routed(force=rec16.own) if cfg.is_moe else contextlib.nullcontext() as rec32:
            plain32 = float(tm.lm_loss(params, dataclasses.replace(
                cfg, remat=False, compute_dtype=torch.float32), first, device=dev))
    if cfg.is_moe:
        mcfg = cfg.moe_cfg
        n_routes = cfg.n_layers * B * S
        changed = route_diff(rec16.own, rec32.own, mcfg)
        route_note = (f"; the f32 loss under the bf16 loss's routes, (layer, token) routes "
                      f"its own logits would change: {_share(changed, n_routes)}; dropped "
                      f"(token, choice) share by layer ["
                      + ", ".join(f"{x:.4f}" for x in dropped(rec16.own, mcfg)) + "]")
        del rec16, rec32
    state = opt.init(params)
    timer = StepTimer(dev)
    t0 = time.perf_counter()
    losses = [float(x) for x in lm_steps(mod, cfg, opt, params, state, make_batch, 0, n_steps,
                                         lr, dev, timer)]
    run_s = time.perf_counter() - t0
    split = timer.medians()
    launched = sum(ops.LAUNCHES.values())
    got = losses[0]
    if not np.isfinite(losses).all():
        raise AssertionError(f"lm-train: losses {losses}")
    if abs(got - plain16) > 1e-5 * max(1.0, abs(plain16)):
        raise AssertionError(f"lm-train: step 1 loss {got:.7g} against the plain bf16 path's "
                             f"{plain16:.7g}")
    if abs(got - plain32) > 2.0**-7 * max(1.0, abs(plain32)):
        raise AssertionError(f"lm-train: step 1 loss {got:.7g} against the f32 path's "
                             f"{plain32:.7g}")
    if launched:
        raise AssertionError(f"lm-train: the loss launched kernels: {dict(ops.LAUNCHES)}")
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB" if dev.type == "cuda"
            else "not measured")
    del params, state, first
    gc.collect()

    # resume: run A saves at step `save`, run B restores it and runs to the end
    rcfg = dataclasses.replace(cfg, n_layers=sz.lm_resume_layers)
    rmod, rbatch = train.build_lm_trainer(cfg.name, rcfg, B, S, 0, dev)
    steps, save = sz.lm_resume_steps, sz.lm_resume_save
    BUILD.mkdir(parents=True, exist_ok=True)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_", dir=BUILD))
    try:
        mgr = CheckpointManager(str(workdir / "run_a"), keep=2)
        pa = rmod.init(torch.Generator(device=dev).manual_seed(0), rcfg)
        sa = opt.init(pa)
        ckpt_bytes = sum(t.numel() * t.element_size()
                         for t in optim.optimizers.tree_leaves({"params": pa, "opt": sa}))
        t0 = time.perf_counter()
        la = lm_steps(rmod, rcfg, opt, pa, sa, rbatch, 0, steps, lr, dev, mgr=mgr, save_at=save)
        run_a_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, step = mgr.restore(skeleton({"params": pa, "opt": sa}), step=save, device=dev)
        restore_s = time.perf_counter() - t0
        if step != save:
            raise AssertionError(f"lm-train: restored step {step}, not {save}")
        lb = lm_steps(rmod, rcfg, opt, restored["params"], restored["opt"], rbatch, save,
                      steps, lr, dev)
        if not (torch.equal(torch.stack(lb), torch.stack(la[save:]))
                and same_tree(restored, {"params": pa, "opt": sa})):
            raise AssertionError("lm-train: run B (resumed) is not bitwise run A")
        del pa, sa, restored
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    line = (f"phase lm-train: {cfg.name} {cfg.n_layers} layers d={cfg.d_model}, {n_params} "
            f"parameters (f32, seed 0; n_params() {cfg.n_params()}), bf16 compute, remat, "
            f"q_chunk {cfg.q_chunk}, loss_chunk {cfg.loss_chunk}; {n_steps} adamw steps at "
            f"B={B} x {S} zipf tokens (train_4k's batch 256 cut to {B}), lr={lr}, under "
            f"deterministic algorithms, in {run_s:.1f} s: losses "
            + ", ".join(f"{x:.5f}" for x in losses)
            + f"; step 1 against the plain paths without checkpointing: bf16 {plain16:.7f} "
            f"(|diff| {abs(got - plain16):.3g} <= 1e-5 max(1, |loss|)), f32 compute "
            f"{plain32:.7f} (|diff| {abs(got - plain32):.3g} <= 2^-7 max(1, |loss|))"
            f"{route_note}; median "
            f"step {split['step']:.1f} ms (forward {split['forward']:.1f}, backward "
            f"{split['backward']:.1f}, adamw {split['update']:.1f}; "
            f"{'CUDA events' if dev.type == 'cuda' else 'host clock'}); no kernel of the repo "
            f"launched; peak memory {peak}; resume at {sz.lm_resume_layers} layers: "
            f"checkpoint of {ckpt_bytes / 1e9:.3f} GB at step {save}, run A {steps} steps in "
            f"{run_a_s:.1f} s, restore {restore_s:.2f} s, run B from step {save}: losses and "
            f"step {steps}'s params and adamw state bitwise run A's; wall "
            f"{time.perf_counter() - t_phase:.1f} s")
    print(line, flush=True)


# -- phase 10d: examples -----------------------------------------------------------

EXAMPLE_KERNELS = {
    # kernel 5 in every lookup, 5' (its sort and writer) in every backward,
    # 6 for the full and pruned FwFM, 3 for Algorithm 1
    "quickstart": ("embedding_bag_kernel", "bag_rows_radix_sort",
                   "embedding_bag_backward_kernel", "fwfm_pairwise_kernel",
                   "dplr_score_items_kernel"),
    "train_e2e": ("embedding_bag_kernel", "bag_rows_radix_sort",
                  "embedding_bag_backward_kernel"),
}
# ranking_server's paths: 3 per call, 1 (--topk 0) or 2 (--topk K) for the
# engine, 2 under churn and behind the frontend; paths 6-7 pack tenants, so
# 4 serves their fused rounds (counted over both: a round fuses only the
# tenants ready at once)
SERVER_KERNELS = {
    "percall": ("dplr_score_items_kernel", "embedding_bag_kernel"),
    "corpus": ("embedding_bag_kernel",),
    "churn": ("corpus_topk_chunks", "topk_merge"),
    "frontend": ("corpus_topk_chunks", "topk_merge"),
}
PACKED_KERNELS = ("corpus_multi_topk_chunks", "multi_topk_merge")


@contextlib.contextmanager
def plain_kernels():
    """Inside, the entry points of kernels 3, 5 and 6 run their plain
    versions (differentiable through autograd) on any device: the plain
    path of the examples.  Raises if a kernel launched inside."""
    saved = {name: getattr(ops, name) for name in ("embedding_bag", "fwfm_pairwise",
                                                    "dplr_score_items")}
    before = dict(ops.LAUNCHES)
    ops.embedding_bag = lambda table, ids, w, bags: ref.embedding_bag_ref(
        table, ids, w, bags.segments, bags.n_bags)
    ops.fwfm_pairwise = ref.fwfm_pairwise_ref
    ops.dplr_score_items = lambda V_I, U_I, e, d_I, P_C, s_C: (
        ref.dplr_score_items_ref(V_I, U_I, e, d_I, P_C, s_C) if V_I.ndim == 4 else
        ref.dplr_score_items_ref(V_I[None], U_I, e, d_I, P_C[None], s_C.reshape(1))[0])
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)
    if dict(ops.LAUNCHES) != before:
        raise AssertionError("the plain path launched a kernel")


def launched_since(before: dict) -> dict:
    return dict(collections.Counter(ops.LAUNCHES) - collections.Counter(before))


def require_launches(dev, launched: dict, names, what: str) -> None:
    """On the card, raises unless each kernel of ``names`` launched."""
    if dev.type == "cuda":
        missing = [n for n in names if not launched.get(n)]
        if missing:
            raise AssertionError(f"{what}: {', '.join(missing)} never launched ({launched})")


def check_losses(got: dict | list, want: dict | list, what: str) -> float:
    """The kernel path's losses against the plain path's over the steps
    both ran: within ``1e-4 max(1, |loss|)`` (the train phase's bound)."""
    if isinstance(got, dict):
        got, want = ([d[s] for s in sorted(d) if s in got and s in want] for d in (got, want))
    pairs = list(zip(got, want))
    if not pairs:
        raise AssertionError(f"{what}: no losses to compare")
    worst = 0.0
    for i, (g, w) in enumerate(pairs):
        if not (np.isfinite(g) and abs(g - w) <= 1e-4 * max(1.0, abs(w))):
            raise AssertionError(f"{what}: step {i + 1} loss {g:.7g}, plain {w:.7g}")
        worst = max(worst, abs(g - w))
    return worst


def logits_check(params, cfg, ids, w, what: str, pruned_mask=None) -> float:
    """``fwfm.apply`` through the kernels against ``plain_apply`` on the
    same params and rows, within ``1e-5 max(1, size)``."""
    with torch.no_grad():
        got = fwfm.apply(params, cfg, {"ids": ids, "weights": w}, pruned_mask=pruned_mask)
        want, size = plain_apply(params, cfg, ids, w, pruned_mask)
    return check_close(got, want, what, size=size)


def quickstart_run(dev, sz) -> str:
    """``examples/quickstart`` at ``sz.qs_steps`` (its default 300) and
    ``sz.qs_rank_steps`` (100) through the kernels, then again through the
    plain versions: every model's losses held step by step, and on the
    kernel run's weights its eval logits (DPLR, full and pruned FwFM) and
    Algorithm 1's 1,000 scores against the plain path."""
    layout = quickstart.make_layout()
    data = quickstart.make_data(layout)
    before = dict(ops.LAUNCHES)
    losses, plain = {}, {}
    t0 = time.perf_counter()
    out = quickstart.run(sz.qs_steps, sz.qs_rank_steps, dev, losses=losses)
    wall = time.perf_counter() - t0
    launched = launched_since(before)
    require_launches(dev, launched, EXAMPLE_KERNELS["quickstart"], "quickstart")
    with plain_kernels():
        plain_out = quickstart.run(sz.qs_steps, sz.qs_rank_steps, dev, losses=plain)
    worst = max(check_losses(losses[n], plain[n], f"quickstart {n}") for n in losses)
    ev = train.to_device(data.batch(sz.qs_rows, 10**6), dev)
    cfgs = dict(quickstart.configs(layout))
    errs = [logits_check(out["params"][n], cfgs[n], ev["ids"], ev["weights"],
                         f"quickstart {n} logits") for n in ("fwfm", "dplr(r=2)")]
    R = fwfm.field_matrix(out["params"]["fwfm"], cfgs["fwfm"])
    mask = prune_matched(R, layout.n_fields, rank=2).mask
    errs.append(logits_check(out["params"]["fwfm"], cfgs["fwfm"], ev["ids"], ev["weights"],
                             "quickstart pruned logits", pruned_mask=mask))
    q = train.to_device(data.ranking_query(1000, 0), dev)
    with torch.no_grad():
        want, size = plain_rank_items(out["params"]["rank"], cfgs["dplr(r=2)"], q)
    errs.append(check_close(out["scores"], want, "quickstart Algorithm 1", size=size))
    aucs = ", ".join(f"{n} {v:.4f} (plain {plain_out['auc'][n]:.4f})"
                     for n, v in out["auc"].items())
    return (f"quickstart ({sz.qs_steps} steps a model, {sz.qs_rank_steps} for Algorithm 1): "
            f"{wall:.1f} s; losses within 1e-4 max(1, |loss|) of the plain run's (max |diff| "
            f"{worst:.3g}); AUC {aucs}; logits and Algorithm 1's scores on its weights within "
            f"1e-5 max(1, size) of the plain path (max |diff| {max(errs):.3g}); top-5 "
            f"{out['top5'].tolist()}; launches {launched}")


def train_e2e_run(dev, sz) -> str:
    """``examples/train_e2e`` on ``sz.e2e_layout()`` (the reference's 82
    fields on the card), ``sz.e2e_steps`` steps of B = 2,048 with its
    checkpoints in a temporary directory under ``build/`` (removed after),
    then its first ``sz.e2e_plain_steps`` steps through the plain versions:
    the losses held step by step, and on the trained weights the eval
    logits against the plain path."""
    layout = sz.e2e_layout()
    tmp = Path(tempfile.mkdtemp(prefix="e2e_", dir=BUILD))
    try:
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        out = train_e2e.run(layout, sz.e2e_steps, sz.e2e_batch, tmp / "a", device=dev,
                            ckpt_every=sz.e2e_ckpt_every)
        wall = time.perf_counter() - t0
        launched = launched_since(before)
        require_launches(dev, launched, EXAMPLE_KERNELS["train_e2e"], "train_e2e")
        saved = sorted(p.name for p in (tmp / "a").glob("step_*"))
        with plain_kernels():
            plain = train_e2e.run(layout, sz.e2e_plain_steps, sz.e2e_batch, tmp / "p",
                                  device=dev, ckpt_every=sz.e2e_ckpt_every)
        worst = check_losses(out["losses"], plain["losses"], "train_e2e")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cfg = fwfm.FwFMConfig(layout=layout, embed_dim=16, interaction="dplr", rank=3)
    ev = train.to_device(train_e2e.make_data(layout).batch(20000, 10**6), dev)
    err = logits_check(out["params"], cfg, ev["ids"], ev["weights"], "train_e2e eval logits")
    return (f"train_e2e ({layout.n_fields} fields, {layout.total_vocab} arena rows, "
            f"{sz.e2e_steps} steps of B={sz.e2e_batch}): {wall:.1f} s, AUC {out['auc']:.4f}; "
            f"checkpoints {saved} (keep 2); the first {sz.e2e_plain_steps} losses within 1e-4 "
            f"max(1, |loss|) of the plain run's (max |diff| {worst:.3g}); eval logits within "
            f"1e-5 max(1, size) of the plain path (max |diff| {err:.3g}); launches {launched}")


def plain_slab(params, cfg, items: dict, ctx: dict, capacity: int, dev):
    """The plain path's scores of one context over a corpus slab whose
    first n slots hold ``items``' n candidates in order (as the engine and
    ``CorpusState`` place them), ``NEG_INF`` on the empty slots, and their
    sizes (1 there): two (1, capacity) tensors."""
    n = items["item_ids"].shape[1]
    q = train.to_device({**ctx, "item_ids": items["item_ids"],
                         "item_weights": items["item_weights"]}, dev)
    with torch.no_grad():
        plain, size = plain_rank_items(params, cfg, q)
    full = torch.full((1, capacity), ref.NEG_INF, device=dev)
    full[:, :n] = plain
    sizes = torch.ones((1, capacity), device=dev)
    sizes[:, :n] = size
    return full, sizes


def check_tenant_replies(params, cfg, served: dict, what: str, dev) -> tuple[float, int]:
    """Each reply of a packed frontend (``ranking_server``'s paths 6-7:
    kernel 4 where tenants were fused, kernel 2 alone) held by
    ``check_topk`` against the plain top-K of its tenant's corpus and its
    context (weights 1, as the frontend's default), within 1e-5 max(1,
    size); a tenant whose slab changed while it was served (``churned``)
    is skipped.  Returns (max |diff|, replies checked)."""
    err, checked = 0.0, 0
    for tenant, ctx_ids, scores, slots in served["replies"]:
        if tenant in served["churned"]:
            continue
        items = served["corpora"][tenant]
        ctx = np.asarray(ctx_ids).reshape(1, -1)
        full, sizes = plain_slab(params, cfg, items, {
            "context_ids": ctx, "context_weights": np.ones(ctx.shape, np.float32)},
            next_pow2(items["item_ids"].shape[1]), dev)
        K = len(scores)
        vals = torch.tensor(np.asarray(scores, np.float32), device=dev).reshape(1, K)
        ids = torch.tensor(np.asarray(slots), device=dev).reshape(1, K)
        err = max(err, check_topk(vals, ids, full, K, f"{what} tenant {tenant} top-{K}",
                                  size=sizes)[0])
        checked += 1
    if not checked:
        raise AssertionError(f"{what}: no reply to check")
    return err, checked


def server_run(dev, argv: list) -> str:
    """``examples/ranking_server`` with ``argv`` (and ``--device``), random
    weights from seed 0: its paths' kernels through ``LAUNCHES`` (kernel 4
    in path 6, whose frontend packs), path 1's first query, path 2's first
    context, and every reply of paths 6-7 against the plain path."""
    cfg = ranking_server.make_config()
    params = fwfm.init(torch.Generator(device=dev).manual_seed(0), cfg)
    before = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    out = ranking_server.main([*argv, "--device", dev.type], params=params)
    wall = time.perf_counter() - t0
    total = launched_since(before)
    args = ranking_server.parser().parse_args(argv)
    want = dict(SERVER_KERNELS)
    want["corpus"] += (("corpus_topk_chunks", "topk_merge") if args.topk
                       else ("corpus_score_full",))
    for path, names in want.items():
        require_launches(dev, out["launches"][path], names, f"ranking_server {path}")
    packed = collections.Counter(out["launches"]["multi_tenant"]) + collections.Counter(
        out["launches"]["rpc"])
    require_launches(dev, packed, PACKED_KERNELS, "ranking_server paths 6-7 (packed)")
    q = train.to_device(out["percall"]["query"], dev)
    with torch.no_grad():
        want_s, size = plain_rank_items(params, cfg, q)
    err = check_close(torch.as_tensor(out["percall"]["scores"], device=dev), want_s,
                      "ranking_server per-call Alg. 1", size=size)
    corpus = out["corpus"]["items"]
    n = corpus["item_ids"].shape[1]
    full, sizes = plain_slab(params, cfg, corpus, out["corpus"]["context"],
                             out["corpus"]["capacity"], dev)
    got = out["corpus"]["result"]
    if args.topk:
        vals, ids = (torch.as_tensor(t, device=dev) for t in got)
        err = max(err, check_topk(vals, ids, full, args.topk, "ranking_server corpus top-K",
                                  size=sizes)[0])
    else:
        err = max(err, check_close(torch.as_tensor(got, device=dev)[:, :n], full[:, :n],
                                   "ranking_server corpus scores", size=sizes[:, :n]))
    checked = []
    for path in ("multi_tenant", "rpc"):
        e, c = check_tenant_replies(params, cfg, out["tenants"][path],
                                    f"ranking_server {path}", dev)
        err = max(err, e)
        checked.append(f"{c} of {path}'s {len(out['tenants'][path]['replies'])}")
    return (f"ranking_server {' '.join(argv) or '(defaults)'}: {wall:.1f} s; per-call and "
            f"corpus answers and the packed frontends' replies ({', '.join(checked)}; "
            f"churned t0 not held) within 1e-5 max(1, size) of the plain path (max |diff| "
            f"{err:.3g}); frontends {out['counts']}; launches {total}")


def examples_phase(dev, sz) -> dict:
    """The three examples through their ``run``/``main`` on the card
    (``quickstart_run``, ``train_e2e_run``, ``server_run`` for each of
    ``sz.server_runs``).  Returns the launches of each CUDA kernel over the
    phase."""
    ops.reset_launches()
    t0 = time.perf_counter()
    for line in (quickstart_run(dev, sz), train_e2e_run(dev, sz),
                 *(server_run(dev, argv) for argv in sz.server_runs)):
        print(f"phase examples: {line}", flush=True)
    print(f"phase examples: wall {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(ops.LAUNCHES)


# -- phase 10e: dryrun -----------------------------------------------------------------

PEAK_RATIO = 1.5          # counted peak_bytes against the card's measured peak, either way


def start_dryrun(dev, argv: list, out: Path) -> subprocess.Popen:
    """``launch.dryrun`` over every cell in a process of its own (on
    ``meta``: host work only, no card), started with the script so that
    it runs beside the card's phases; ``argv`` its selection."""
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    card = (torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda"
            else dryrun.H100_BYTES)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([str(Path(__file__).resolve().parent / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    log = open(out / "dryrun.log", "w")
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--force",
                             "--out", str(out), "--card-bytes", str(card), *argv],
                            stdout=log, stderr=subprocess.STDOUT, env=env)


def measure_cell(dev, cell, steps: int) -> tuple[list, float | None]:
    """The times (ms) of ``steps`` calls of a cell after a warm call, each
    alone between CUDA events, and the peak of them all:
    ``max_memory_allocated`` (host clock and None off the card).  Each
    call's output is freed before the next, so the peak is one call's."""
    with torch.no_grad() if cell.kind not in ("train", "graph") else contextlib.nullcontext():
        out = cell.fn(*cell.args)
        del out
        _sync(dev)
        times = []
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(steps):
            if dev.type != "cuda":
                t0 = time.perf_counter()
                cell.fn(*cell.args)
                times.append((time.perf_counter() - t0) * 1e3)
                continue
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = cell.fn(*cell.args)
            stop.record()
            stop.synchronize()
            del out
            times.append(start.elapsed_time(stop))
        return times, (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None)


def dryrun_records(proc: subprocess.Popen, out: Path, timeout: float) -> list:
    """The records of a dry run's process, one line printed a record; fails
    unless it exited 0 and every record is ``ok``."""
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log = (out / "dryrun.log").read_text()
    recs = [json.loads(p.read_text()) for p in sorted(out.glob("*.json"))]
    for rec in recs:
        print(f"phase dryrun: {dryrun.line(rec)}", flush=True)
    if rc != 0 or not recs or not all(r.get("ok") for r in recs):
        raise AssertionError(f"dryrun: exit {rc}, {len(recs)} records; {log[-2000:]}")
    return recs


def mesh_figures(cfg, mesh_name: str) -> dict:
    """``dplr-fwfm/train_batch``'s bytes a device of a production mesh, from
    the partition rules by hand: the arena (rows x k) and the first-order
    table split by rows over the 16 model positions, bias, U (rho x m) and
    e (rho) whole; adagrad's accumulator alike; the batch's rows (65,536
    in the registry) over the 16 or 32 data replicas (ids and weights a
    slot, a label), and the learning rate."""
    rows, D = padded_rows(cfg.layout.total_vocab), 16
    params = rows // D * cfg.embed_dim * 4 + rows // D * 4 + 4 + cfg.rank * (
        cfg.layout.n_fields + 1) * 4
    shape = next(s for s in REGISTRY["dplr-fwfm"].shapes if s.name == "train_batch")
    B = shape.dims["batch"] // (32 if mesh_name == "multi" else 16)
    return {"param_bytes": params, "opt_state_bytes": params,
            "input_bytes": B * cfg.layout.n_slots * 8 + B * 4 + 4,
            "n_devices": 512 if mesh_name == "multi" else 256}


# An LM's f32 parameters a device of either production mesh (the rules'
# blocks: vocabulary, heads or experts over the 16 model positions, with FSDP
# the other dim over the 16 data positions); its serving cells hold them in bf16
LM_MESH_PARAMS = {"gemma3-1b": 250_182_144, "starcoder2-7b": 1_850_886_144,
                  "yi-9b": 139_542_528, "granite-moe-1b-a400m": 349_442_048,
                  "mixtral-8x7b": 734_969_856}


def dryrun_mesh_check(recs: list, want_cells: int) -> None:
    """The production-mesh dry run: ``want_cells`` records, each a device's
    ``peak``, ``coll`` and ``fits`` (one line a cell, with its mesh); the
    ``dplr-fwfm/train_batch`` records' bytes a device equal to
    ``mesh_figures``; an LM cell's parameters a device ``LM_MESH_PARAMS``
    (half that in a serving cell's bf16)."""
    if len(recs) != want_cells:
        raise AssertionError(f"dryrun --mesh: {len(recs)} records, want {want_cells}")
    cfg = dplr_fwfm.make_config()
    for rec in recs:
        if rec["arch"] in LM_MESH_PARAMS:
            want = LM_MESH_PARAMS[rec["arch"]] // (1 if rec["kind"] == "train" else 2)
            if rec["param_bytes"] != want:
                raise AssertionError(f"dryrun --mesh {rec['mesh']}: {rec['arch']}/"
                                     f"{rec['shape']} holds {rec['param_bytes']} B of "
                                     f"parameters a device, the rules give {want}")
        if (rec["arch"], rec["shape"]) != ("dplr-fwfm", "train_batch"):
            continue
        got = {k: rec[k] for k in ("param_bytes", "opt_state_bytes", "input_bytes",
                                   "n_devices")}
        want = mesh_figures(cfg, rec["mesh"])
        if got != want:
            raise AssertionError(f"dryrun --mesh {rec['mesh']}: dplr-fwfm/train_batch a "
                                 f"device {got}, the rules give {want}")
    fits = sum(r["fits_one_card"] for r in recs)
    lm = sum(r["arch"] in LM_MESH_PARAMS for r in recs)
    print(f"phase dryrun: {len(recs) - lm} recsys cells" + (f" and {lm} LM cells" if lm else "")
          + f" counted a device of the production meshes on meta ({fits} fit one card); "
          f"dplr-fwfm/train_batch's bytes a device equal the rules' on both meshes"
          + (", every LM's parameters a device the rules'" if lm else ""), flush=True)


def dryrun_phase(dev, sz, proc: subprocess.Popen, out: Path, mesh_proc=None,
                 mesh_out: Path | None = None) -> None:
    """The dry run's records, one line a cell (it fails on any cell that
    did not build); the production-mesh dry run's (``dryrun_mesh_check``)
    where its process is given; then each cut of ``sz.dryrun_cuts`` that
    the script's phases run, counted on ``meta`` beside
    ``sz.dryrun_steps`` steps of it on the card: flops, bytes and
    ``peak_bytes`` beside the median step and the measured peak, which
    must agree within ``PEAK_RATIO`` either way."""
    t0 = time.perf_counter()
    recs = dryrun_records(proc, out, sz.dryrun_timeout)
    fits = sum(r["fits_one_card"] for r in recs)
    print(f"phase dryrun: {len(recs)} cells counted on meta ({fits} fit one card of "
          f"{recs[0]['card_bytes'] / 2**30:.1f} GiB), waited {time.perf_counter() - t0:.1f} s",
          flush=True)
    if mesh_proc is not None:
        args = list(sz.dryrun_mesh_args)
        archs = {args[i + 1] for i, a in enumerate(args) if a == "--arch"}
        cells = sum(a in archs for a, _, _ in steps.all_cells())
        dryrun_mesh_check(dryrun_records(mesh_proc, mesh_out, sz.dryrun_timeout), 2 * cells)
    for arch, shape, dims, make_cfg in sz.dryrun_cuts:
        cfg = make_cfg() if make_cfg else None
        meta = steps.build(arch, shape, "meta", cfg=cfg, dims=dims)
        counted = cost.analyze(meta.fn, *meta.args)
        _sync(dev)
        base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        cell = steps.build(arch, shape, dev, cfg=cfg, dims=dims)
        times, peak = measure_cell(dev, cell, sz.dryrun_steps)
        del cell
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ms = float(np.median(times))
        ratio = None if peak is None else counted["peak_bytes"] / (peak - base)
        if ratio is not None and not 1 / PEAK_RATIO <= ratio <= PEAK_RATIO:
            raise AssertionError(f"dryrun {arch}/{shape} {dims}: peak_bytes "
                                 f"{counted['peak_bytes'] / 2**30:.2f} GiB against a measured "
                                 f"{(peak - base) / 2**30:.2f} GiB ({ratio:.2f}x)")
        measured = "not measured" if peak is None else f"{(peak - base) / 2**30:.2f} GiB"
        print(f"phase dryrun: cut {arch}/{shape} {dims or ''}: counted {counted['flops']:.4e} "
              f"flops, {counted['bytes']:.4e} bytes, peak_bytes "
              f"{counted['peak_bytes'] / 2**30:.2f} GiB (counted in {counted['seconds']:.1f} s); "
              f"{len(times)} steps on the {dev.type} after a warm one: median {ms:.1f} ms "
              f"(each {', '.join(f'{t:.1f}' for t in times)}; "
              f"{'CUDA events' if dev.type == 'cuda' else 'host clock'}), "
              f"{counted['flops'] / ms / 1e9:.1f} TFLOP/s counted at the median, peak {measured}"
              + ("" if ratio is None else f" (counted / measured {ratio:.3f})"), flush=True)
    print(f"phase dryrun: wall {time.perf_counter() - t0:.1f} s", flush=True)


# -- phase 11: timing ----------------------------------------------------------

def kernel_name(mangled: str) -> str:
    """``flash_attention_wgmma<256>`` from a mangled kernel name: the last
    name of its (possibly nested) name, then its template arguments where
    they are integers or the builtin types used here."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    args = []
    if mangled[i:i + 1] == "I":
        i += 1
        while i < len(mangled) and mangled[i] != "E":
            if m := re.match(r"Li(\d+)E", mangled[i:]):         # an int argument
                args.append(m.group(1))
                i += len(m.group(0))
            elif m := re.match(r"\d+", mangled[i:]):            # a named type
                j = i + len(m.group(0))
                args.append(mangled[j:j + int(m.group(0))])
                i = j + int(m.group(0))
            elif mangled[i] in "fi":
                args.append({"f": "float", "i": "int"}[mangled[i]])
                i += 1
            else:
                break
    return name + (f"<{', '.join(args)}>" if args else "")


def ptxas_report(log: str) -> list:
    """Per kernel of an ``nvcc -Xptxas -v`` log: its name with template
    arguments (``flash_attention_wgmma<256>``), registers, spill bytes and
    any ptxas warning about it (such as serialized wgmma)."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(_Z\w+)'", ln)
        if m:
            cur = dict(kernel=kernel_name(m.group(1)), registers=None, spill_stores=0,
                       spill_loads=0, warnings=[])
            out.append(cur)
        elif cur is not None:
            if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln):
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            elif m := re.search(r"Used (\d+) registers", ln):
                cur["registers"] = int(m.group(1))
            elif "warning" in ln.lower() or "Performance Loss" in ln:
                cur["warnings"].append(ln.strip())
    return out


# The build fails if any kernel of these sources, or any kernel whose name
# starts with one of these, spills registers.
NO_SPILL_SOURCES = ("dplr_corpus_score", "dplr_score", "embedding_bag",
                    "fwfm_interaction")
NO_SPILL_KERNELS = ("flash_attention_wgmma",)


def spilled(stem: str, log: str) -> list:
    """The kernels of source ``stem``'s ptxas log that the build refuses:
    those that spill, in ``NO_SPILL_SOURCES`` or named by ``NO_SPILL_KERNELS``."""
    return [fn for fn in ptxas_report(log)
            if (stem in NO_SPILL_SOURCES or fn["kernel"].startswith(NO_SPILL_KERNELS))
            and (fn["spill_stores"] or fn["spill_loads"])]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_ms(fn, batches=5, per_batch=10) -> float:
    """Median over batches of the mean time per call, from CUDA events
    around back-to-back calls (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / per_batch)
    return float(np.median(times))


def peak_mib(dev, fn) -> float | None:
    """MiB of device memory one call holds at its peak beyond what was
    allocated before it (its scratch and outputs); None off the card."""
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    return (torch.cuda.max_memory_allocated(dev) - before) / 2**20


def _ms(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def _mib(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.1f} MiB"


def bound_ms(nbytes: float, flops: float, peaks, tensor: bool = False) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate, or flops
    over the f32 rate (the bf16 tensor-core rate with ``tensor``)."""
    t_bytes, t_ops = nbytes / peaks[0], flops / peaks[2 if tensor else 1]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def work_bound(name: str, peaks, tensor: bool = False, **dims) -> tuple[float, str]:
    """``bound_ms`` of one call of ``name``'s kernel at ``dims``: its
    flops and bytes from the cost model's one formula
    (``work.kernel_work``), which a counted call reports too."""
    flops, nbytes = work.kernel_work(name, **dims)
    return bound_ms(nbytes, flops, peaks, tensor)


def timing_phase(dev, sz, peaks) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1)
    n, rho, k = sz.n, sz.rho, sz.k
    Bq = max(sz.bqs)
    Q, a_I, e, P_C, a_C, valid = corpus_inputs(dev, n, sz.live, Bq, rho, k, gen)
    live = int(valid.sum())                    # the work counts live slots only
    slab = dict(n=n, live=live, rho=rho, k=k)
    rows, extra = {}, []
    for Bq_t in (Bq, 1):
        args = (Q, a_I, e, P_C[:Bq_t].contiguous(), a_C[:Bq_t].contiguous(), valid)
        ms = device_ms(lambda: ops.dplr_corpus_score(*args))
        plain = device_ms(lambda: ref.dplr_corpus_score_ref(*args), 3, 2)
        bnd, by = work_bound("dplr_corpus_score", peaks, Bq=Bq_t, K=None, itemsize=4, **slab)
        extra.append(f"dplr_corpus_score n={n} Bq={Bq_t}: {ms:.4f} ms, plain {plain:.4f} ms, "
                     f"bound {bnd:.4f} ms ({by})")
        if Bq_t == Bq:
            rows["dplr_corpus_score"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by)
        else:
            rows["dplr_corpus_score"]["bq1"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd)
    # the top-K at each timed shape (Bq, K, order of the scores), beside the
    # yardstick kernel 1 + torch.topk (two calls; the port never makes them)
    rising = a_I + 1e-3 * torch.arange(n, device=dev, dtype=torch.float32)
    shapes = []
    for Bq_t, K, order in sz.topk_times:
        args = (Q, rising if order == "rising" else a_I, e, P_C[:Bq_t].contiguous(),
                a_C[:Bq_t].contiguous(), valid)
        ms = device_ms(lambda: ops.dplr_corpus_score(*args, topk=K))
        plain = device_ms(lambda: ref.dplr_corpus_topk_ref(*args[:5], K, args[5]), 3, 2)
        yard = device_ms(lambda: torch.topk(ops.dplr_corpus_score(*args), K))
        peak = peak_mib(dev, lambda: ops.dplr_corpus_score(*args, topk=K))
        yard_peak = peak_mib(dev, lambda: torch.topk(ops.dplr_corpus_score(*args), K))
        bnd, by = work_bound("dplr_corpus_topk", peaks, Bq=Bq_t, K=K, itemsize=4, **slab)
        shapes.append(dict(Bq=Bq_t, K=K, order=order, ms=ms, plain_ms=plain,
                           yardstick_ms=yard, bound_ms=bnd, peak_mib=peak,
                           yardstick_peak_mib=yard_peak))
        extra.append(f"dplr_corpus_topk n={n} Bq={Bq_t} K={K} {order}: {ms:.4f} ms, plain "
                     f"{plain:.4f} ms, kernel 1 + torch.topk {yard:.4f} ms, bound {bnd:.4f} ms "
                     f"({by}); peak memory of a call {_mib(peak)}, of the yardstick "
                     f"{_mib(yard_peak)}")
        if (Bq_t, K, order) == sz.topk_times[0]:
            rows["dplr_corpus_topk"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                            yardstick_ms=yard)
    rows["dplr_corpus_topk"]["shapes"] = shapes
    del rising

    # the same slab in bf16 (Q_I and a_I; e, P_C, a_C stay f32): 2 rho k + 2
    # bytes an item and the mask's 1, the same arithmetic
    Q16, a16 = Q.to(torch.bfloat16), a_I.to(torch.bfloat16)
    del Q
    for Bq_t in (Bq, 1):
        args = (Q16, a16, e, P_C[:Bq_t].contiguous(), a_C[:Bq_t].contiguous(), valid)
        ms = device_ms(lambda: ops.dplr_corpus_score(*args))
        plain = device_ms(lambda: ref.dplr_corpus_score_ref(*args), 3, 2)
        bnd, by = work_bound("dplr_corpus_score_bf16", peaks, Bq=Bq_t, K=None, itemsize=2,
                             **slab)
        extra.append(f"dplr_corpus_score bf16 n={n} Bq={Bq_t}: {ms:.4f} ms, plain {plain:.4f} "
                     f"ms, bound {bnd:.4f} ms ({by})")
        if Bq_t == Bq:
            rows["dplr_corpus_score_bf16"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                                                  bound_by=by)
        else:
            rows["dplr_corpus_score_bf16"]["bq1"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd)
        acc = device_ms(lambda: ops.dplr_corpus_score(*args, acc_dtype="bfloat16"))
        row = rows["dplr_corpus_score_bf16"]
        (row if Bq_t == Bq else row["bq1"])["acc_bf16_ms"] = acc
        extra.append(f"dplr_corpus_score bf16 acc_dtype='bfloat16' n={n} Bq={Bq_t}: {acc:.4f} ms")
    shapes = []
    for Bq_t, K, order in sz.topk_times[:3]:
        args = (Q16, a16, e, P_C[:Bq_t].contiguous(), a_C[:Bq_t].contiguous(), valid)
        ms = device_ms(lambda: ops.dplr_corpus_score(*args, topk=K))
        plain = device_ms(lambda: ref.dplr_corpus_topk_ref(*args[:5], K, args[5]), 3, 2)
        yard = device_ms(lambda: torch.topk(ops.dplr_corpus_score(*args), K))
        bnd, by = work_bound("dplr_corpus_topk_bf16", peaks, Bq=Bq_t, K=K, itemsize=2, **slab)
        shapes.append(dict(Bq=Bq_t, K=K, order=order, ms=ms, plain_ms=plain, yardstick_ms=yard,
                           bound_ms=bnd))
        extra.append(f"dplr_corpus_topk bf16 n={n} Bq={Bq_t} K={K} {order}: {ms:.4f} ms, plain "
                     f"{plain:.4f} ms, kernel 1 + torch.topk {yard:.4f} ms, bound {bnd:.4f} ms "
                     f"({by})")
        if (Bq_t, K, order) == sz.topk_times[0]:
            rows["dplr_corpus_topk_bf16"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                                                 bound_by=by, yardstick_ms=yard)
            acc = device_ms(lambda: ops.dplr_corpus_score(*args, topk=K, acc_dtype="bfloat16"))
            extra.append(f"dplr_corpus_topk bf16 acc_dtype='bfloat16' n={n} Bq={Bq_t} K={K}: "
                         f"{acc:.4f} ms")
    rows["dplr_corpus_topk_bf16"]["shapes"] = shapes
    # the runtime's upcast of a bf16 query side at Bq = 1, once a call
    pc16, ac16 = P_C[:1].to(torch.bfloat16), a_C[:1].to(torch.bfloat16)
    cast = device_ms(lambda: (pc16.to(torch.float32).contiguous(), ac16.to(torch.float32)))
    extra.append(f"the bf16 query side's upcast at Bq=1 (P_C (1, {rho}, {k}), a_C (1,)): "
                 f"{cast:.4f} ms")
    rows["dplr_corpus_topk_bf16"]["query_upcast_ms"] = cast
    del Q16, a16

    m, n3 = sz.m3, sz.n3
    shapes = []
    for Bq3 in sz.bq3s:
        V = torch.randn((Bq3, n3, m, k), generator=gen, device=dev) * 0.25
        U = torch.randn((rho, m), generator=gen, device=dev) * 0.2
        e3 = torch.rand((rho,), generator=gen, device=dev) + 0.5
        d = -torch.rand((m,), generator=gen, device=dev)
        PC = torch.randn((Bq3, rho, k), generator=gen, device=dev)
        sC = torch.randn((Bq3,), generator=gen, device=dev)
        ms = device_ms(lambda: ops.dplr_score_items(V, U, e3, d, PC, sC))
        host = host_issue_ms(dev, lambda: ops.dplr_score_items(V, U, e3, d, PC, sC))
        plain = device_ms(lambda: ref.dplr_score_items_ref(V, U, e3, d, PC, sC), 3, 2)
        items = dict(n=n3, Bq=Bq3, m_I=m, rho=rho, k=k)
        bnd, by = work_bound("dplr_score_items", peaks, itemsize=4, **items)
        shapes.append(dict(n=n3, m_I=m, Bq=Bq3, ms=ms, host_issue_ms=host, plain_ms=plain,
                           bound_ms=bnd))
        extra.append(f"dplr_score_items n={n3} m_I={m} Bq={Bq3}: {ms:.4f} ms (host issue "
                     f"{host:.4f} ms), plain {plain:.4f} ms, bound {bnd:.4f} ms ({by})")
        if Bq3 == max(sz.bq3s):
            rows["dplr_score_items"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by)
        # the same V_I in bf16: half its bytes, the same arithmetic
        V16 = V.to(torch.bfloat16)
        ms16 = device_ms(lambda: ops.dplr_score_items(V16, U, e3, d, PC, sC))
        plain16 = device_ms(lambda: ref.dplr_score_items_ref(V16, U, e3, d, PC, sC), 3, 2)
        bnd16, by16 = work_bound("dplr_score_items_bf16", peaks, itemsize=2, **items)
        extra.append(f"dplr_score_items bf16 n={n3} m_I={m} Bq={Bq3}: {ms16:.4f} ms, plain "
                     f"{plain16:.4f} ms, bound {bnd16:.4f} ms ({by16})")
        if Bq3 == max(sz.bq3s):
            rows["dplr_score_items_bf16"] = dict(ms=ms16, plain_ms=plain16, bound_ms=bnd16,
                                                 bound_by=by16)
        del V16
    rows["dplr_score_items"]["shapes"] = shapes
    del V

    S, Bq4, n_s, K = sz.multi
    live_s = sz.tenant_items
    parts, args = multi_inputs(dev, (n_s,) * S, (live_s,) * S, Bq4, rho, k, gen)
    ms = device_ms(lambda: ops.dplr_corpus_score_multi(*args, topk=K))
    plain = device_ms(lambda: ref.dplr_corpus_multi_topk_ref(*args, K), 3, 2)
    single = device_ms(lambda: [ops.dplr_corpus_score(*p, topk=K) for p in parts])
    yard = device_ms(lambda: [torch.topk(ops.dplr_corpus_score(*p), K) for p in parts])
    peak = peak_mib(dev, lambda: ops.dplr_corpus_score_multi(*args, topk=K))
    segs = dict(n=n_s, live=live_s, Bq=Bq4, K=K, rho=rho, k=k, segments=S)
    bnd, by = work_bound("dplr_corpus_score_multi", peaks, itemsize=4, **segs)
    extra.append(f"dplr_corpus_score_multi S={S} n_s={n_s} ({live_s} live) Bq={Bq4} K={K}: "
                 f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} ms ({by}); "
                 f"{S} single-tenant dplr_corpus_score(topk={K}) calls at Bq={Bq4}: "
                 f"{single:.4f} ms summed; {S} x (kernel 1 + torch.topk): {yard:.4f} ms; "
                 f"peak memory of a call {_mib(peak)}")
    rows["dplr_corpus_score_multi"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                           single_calls_ms=single, yardstick_ms=yard,
                                           peak_mib=peak)
    args16 = (tuple(q.to(torch.bfloat16) for q in args[0]),
              tuple(a.to(torch.bfloat16) for a in args[1]), *args[2:])
    ms = device_ms(lambda: ops.dplr_corpus_score_multi(*args16, topk=K))
    plain = device_ms(lambda: ref.dplr_corpus_multi_topk_ref(*args16, K), 3, 2)
    bnd, by = work_bound("dplr_corpus_score_multi_bf16", peaks, itemsize=2, **segs)
    extra.append(f"dplr_corpus_score_multi bf16 S={S} n_s={n_s} ({live_s} live) Bq={Bq4} "
                 f"K={K}: {ms:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} ms ({by})")
    rows["dplr_corpus_score_multi_bf16"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                                                bound_by=by)
    del parts, args, args16

    # embedding_bag at the lookup path's shapes; library: F.embedding_bag
    # with one slot a bag (every bag of the dplr-fwfm layout holds one)
    cfg = sz.make_config()
    lay, ek = cfg.layout, cfg.embed_dim
    table = torch.randn((padded_rows(lay.total_vocab), ek), generator=gen, device=dev)
    table16 = table.to(torch.bfloat16)
    Bq_b, items, pw_rows = sz.bag_rows
    for label, kind, B in (("context", "context", Bq_b), ("corpus", "item", items),
                           ("pointwise", None, pw_rows)):
        ids, w, bags = bag_case(lay, kind, B, gen)
        nb = bags.n_bags
        ms = device_ms(lambda: ops.embedding_bag(table, ids, w, bags))
        plain = device_ms(lambda: ref.embedding_bag_ref(table, ids, w, bags.segments, nb),
                          3, 2)
        lib_ids, lib_w = ids.reshape(-1, 1).long(), w.reshape(-1, 1)
        lib = device_ms(lambda: F.embedding_bag(lib_ids, table, per_sample_weights=lib_w,
                                                mode="sum"))
        bag = dict(slots=ids.numel(), B=B, n_bags=nb, k=ek, id_size=ids.element_size())
        bnd, by = work_bound("embedding_bag", peaks, itemsize=4, **bag)
        extra.append(f"embedding_bag {label} {tuple(ids.shape)}: {ms:.4f} ms, plain "
                     f"{plain:.4f} ms, F.embedding_bag {lib:.4f} ms, bound {bnd:.4f} ms ({by})")
        if label == "corpus":
            rows["embedding_bag"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                         library_ms=lib)
        # in bf16: 2k bytes a row and 2 a weight; library F.embedding_bag in bf16
        w16, lib_w16 = w.to(torch.bfloat16), lib_w.to(torch.bfloat16)
        ms = device_ms(lambda: ops.embedding_bag(table16, ids, w16, bags))
        plain = device_ms(lambda: ref.embedding_bag_ref(table16, ids, w16, bags.segments, nb),
                          3, 2)
        lib = device_ms(lambda: F.embedding_bag(lib_ids, table16, per_sample_weights=lib_w16,
                                                mode="sum"))
        bnd, by = work_bound("embedding_bag_bf16", peaks, itemsize=2, **bag)
        extra.append(f"embedding_bag bf16 {label} {tuple(ids.shape)}: {ms:.4f} ms, plain "
                     f"{plain:.4f} ms, F.embedding_bag bf16 {lib:.4f} ms, bound {bnd:.4f} ms "
                     f"({by})")
        if label == "corpus":
            rows["embedding_bag_bf16"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                              library_ms=lib)
        del ids, w, lib_ids, lib_w, w16, lib_w16
    rows["embedding_bag_backward"], rows["bag_rows_sort"] = bag_backward_timing(
        sz, peaks, gen, table, extra)
    del table, table16

    # fwfm_pairwise; library: one einsum with TF32 off.  The Gram is
    # symmetric, so the function needs its m (m + 1) / 2 distinct dot
    # products (2k flops each) contracted with R_ij + R_ji (2 flops each):
    # m (m + 1) (k + 1) flops an example
    shapes = []
    for B, m in sz.pairs:
        V, R = pair_inputs(B, m, k, gen)
        ms = device_ms(lambda: ops.fwfm_pairwise(V, R))
        host = host_issue_ms(dev, lambda: ops.fwfm_pairwise(V, R))
        plain = device_ms(lambda: ref.fwfm_pairwise_ref(V, R), 3, 2)
        lib = device_ms(lambda: torch.einsum("bik,bjk,ij->b", V, V, R))
        bnd, by = work_bound("fwfm_pairwise", peaks, B=B, m=m, k=k, itemsize=4)
        shapes.append(dict(B=B, m=m, ms=ms, host_issue_ms=host, plain_ms=plain, library_ms=lib,
                           bound_ms=bnd))
        extra.append(f"fwfm_pairwise B={B} m={m} k={k}: {ms:.4f} ms (host issue {host:.4f} "
                     f"ms), plain {plain:.4f} ms, einsum {lib:.4f} ms, bound {bnd:.4f} ms ({by})")
        if B == max(b for b, _ in sz.pairs):
            rows["fwfm_pairwise"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                         library_ms=lib)
        del V
    rows["fwfm_pairwise"]["shapes"] = shapes
    # its backward on the card is the plain vjp, at the train batch
    V, R = pair_inputs(sz.train_batch, sz.pairs[0][1], k, gen)
    g = torch.randn((sz.train_batch,), generator=gen, device=dev)
    bwd = device_ms(lambda: ref.fwfm_pairwise_vjp(V, R, g), 3, 5)
    rows["fwfm_pairwise"]["backward_plain_ms"] = bwd
    extra.append(f"fwfm_pairwise backward (plain vjp) B={sz.train_batch} m={sz.pairs[0][1]} "
                 f"k={k}: {bwd:.4f} ms")
    del V, g
    # kernel 6 on a bf16 V at the full batch; library: the einsum on the
    # upcast V (the upcast inside the timed call)
    B, m = max(sz.pairs)
    V, R = pair_inputs(B, m, k, gen)
    V16 = V.to(torch.bfloat16)
    del V
    ms = device_ms(lambda: ops.fwfm_pairwise(V16, R))
    plain = device_ms(lambda: ref.fwfm_pairwise_ref(V16, R), 3, 2)
    lib = device_ms(lambda: torch.einsum("bik,bjk,ij->b", V16.float(), V16.float(), R))
    # bf16 products summed in f32, as the reference's dot_general with
    # preferred_element_type f32: the bf16 tensor-core rate
    bnd, by = work_bound("fwfm_pairwise_bf16", peaks, tensor=True, B=B, m=m, k=k, itemsize=2)
    rows["fwfm_pairwise_bf16"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                      library_ms=lib, f32_ms=rows["fwfm_pairwise"]["ms"])
    extra.append(f"fwfm_pairwise bf16 V B={B} m={m} k={k}: {ms:.4f} ms (f32 "
                 f"{rows['fwfm_pairwise']['ms']:.4f}), plain {plain:.4f} ms, einsum on the "
                 f"upcast V {lib:.4f} ms, bound {bnd:.4f} ms ({by})")
    del V16
    rows["flash_attention"] = flash_timing(sz, peaks, gen, extra)
    print("phase timing: " + "; ".join(extra), flush=True)
    return rows


def bag_backward_timing(sz, peaks, gen, table, extra) -> tuple[dict, dict]:
    """Kernel 5's backward at the train phase's batch (one-hot, skewed ids
    on the full arena), the whole call: the slots' radix sort and the
    writer, each also timed alone (the writer re-run on one sort).  Plain:
    ``ref.embedding_bag_vjp``.  Library: a zeroed table and one
    ``index_add_`` of the slots' ``g w`` rows into it (its order depends on
    the run).  Bound: read g and the ids and weights, write the whole
    table once.  Returns the backward's row and the sort's: plain
    ``ref.bag_rows_sort``, library one stable ``torch.sort`` of the ids,
    bound the ids read and the keys and int64 indices written."""
    cfg = sz.make_config()
    lay, k, B = cfg.layout, cfg.embed_dim, sz.train_batch
    ids, w, bags = bag_case(lay, None, B, gen, skew=True)
    g = torch.randn((B, bags.n_bags, k), generator=gen, device=table.device)
    rows = table.shape[0]
    ms = device_ms(lambda: ops.embedding_bag_backward(g, table, ids, w, bags), 3, 5)
    plain = device_ms(lambda: ref.embedding_bag_vjp(table, ids, w, bags.segments, g), 3, 2)
    src = (g.index_select(1, bags.segments) * w[..., None]).reshape(-1, k)
    flat = ids.reshape(-1).long()
    lib = device_ms(lambda: torch.zeros_like(table).index_add_(0, flat, src), 3, 5)
    del src, flat
    # the call's parts alone: the sort, and the writer on one sort's result
    sort = device_ms(lambda: ops.bag_rows_sort(ids, rows), 3, 5)
    writer = None                                   # the CPU has no writer to time
    if table.device.type == "cuda":
        keys, perm, scratch = bag_lib.launch_sort(ids.reshape(-1), rows)
        out = torch.empty_like(table)
        writer = device_ms(lambda: bag_lib.launch_writer(g, keys, perm, w, bags, scratch, out),
                           3, 5)
        del keys, perm, scratch, out
    sort_plain = device_ms(lambda: ref.bag_rows_sort(ids, rows), 3, 5)
    sort_lib = device_ms(lambda: torch.sort(ids.reshape(-1), stable=True), 3, 5)
    slots = ids.numel()
    bnd, by = work_bound("embedding_bag_backward", peaks, slots=slots, B=B, n_bags=bags.n_bags,
                         k=k, rows=rows, id_size=ids.element_size())
    sort_bnd, sort_by = work_bound("bag_rows_sort", peaks, slots=slots,
                                   id_size=ids.element_size())
    extra.append(f"embedding_bag_backward {tuple(ids.shape)} on {rows} rows: {ms:.4f} ms (of "
                 f"it the sort alone {sort:.4f} ms, the writer alone {_ms(writer)}), plain "
                 f"{plain:.4f} ms, zeros + index_add_ {lib:.4f} ms, bound {bnd:.4f} ms ({by})")
    extra.append(f"bag_rows_sort of {slots} skewed keys over {rows} rows: {sort:.4f} ms, plain "
                 f"{sort_plain:.4f} ms, torch.sort(stable=True) {sort_lib:.4f} ms, bound "
                 f"{sort_bnd:.4f} ms ({sort_by}; 2 launches)")
    return (dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
                 sort_ms=sort, writer_ms=writer),
            dict(ms=sort, plain_ms=sort_plain, bound_ms=sort_bnd, bound_by=sort_by,
                 library_ms=sort_lib))


attention_pairs = work.attention_pairs


def flash_timing(sz, peaks, gen, extra) -> dict:
    """Flash attention in bf16 at the lm phase's shapes (``sz.flash``): the
    global layer's row, with the windowed layer's beside it, and the MoE
    LMs' prefills (``sz.flash_moe``: granite's full causal hd 64 and
    mixtral's windowed hd 128) under ``"moe"``.  Bound: 4 hd flops a
    (query, key) pair and head at the bf16 tensor-core rate, or q, k, v and
    out moved once.  Library (timed only; the port never calls it):
    ``F.scaled_dot_product_attention(is_causal, enable_gqa)`` on a full
    causal shape; on a windowed one, which it has no option for, the same
    call with the (S, S) causal-and-window mask, on its memory-efficient
    backend (on the card) and k, v repeated to the query heads outside the
    timed call."""
    out = {"moe": []}
    for shape in sz.flash + sz.flash_moe:
        B, S, H, KV, hd, window = shape
        q, k, v = flash_inputs(B, S, H, KV, hd, torch.bfloat16, gen)
        ms = device_ms(lambda: ops.flash_attention(q, k, v, window=window))
        plain = device_ms(lambda: ref.flash_attention_plain(q, k, v, window=window), 3, 2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window is None:
            lib = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                   enable_gqa=True))
        else:
            i = torch.arange(S, device=q.device)
            band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
            kt, vt = (t.repeat_interleave(H // KV, dim=1) for t in (kt, vt))
            with (sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION) if q.is_cuda
                  else contextlib.nullcontext()):
                lib = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                       attn_mask=band), 3, 2)
            del band
        flops = work.kernel_work("flash_attention", B=B, S=S, H=H, KV=KV, hd=hd, window=window,
                                 itemsize=2)[0]
        bnd, by = work_bound("flash_attention", peaks, tensor=True, B=B, S=S, H=H, KV=KV, hd=hd,
                             window=window, itemsize=2)
        label = "global" if window is None else f"window {window}"
        moe_shape = shape in sz.flash_moe
        extra.append(f"flash_attention bf16 B={B} S={S} H={H} KV={KV} hd={hd} {label}"
                     f"{' (MoE prefill)' if moe_shape else ''}: {ms:.4f} ms, plain "
                     f"{plain:.4f} ms, F.scaled_dot_product_attention {lib:.4f} ms, bound "
                     f"{bnd:.4f} ms ({by}, {flops / 1e12:.3f} TFLOP)")
        row = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib)
        if moe_shape:
            out["moe"].append(dict(row, shape=list(shape)))
        elif window is None:
            out.update(row)
        else:
            out["windowed"] = row
        del q, k, v
    return out


# -- phase 12: autotune ---------------------------------------------------------

def corpus_bound(n, live, Bq, K, rho, k, itemsize, peaks, segments=1) -> tuple[float, str]:
    """The timing phase's bound of a corpus call on ``segments`` slabs of
    n slots, ``live`` of them live in each (on average): each live slot's
    row and a_I read once (``itemsize`` bytes an entry) and the mask; the
    query side; the (Bq, K) top-K or (K None) the (Bq, n) scores written;
    the live slots' scoring flops."""
    return work_bound("dplr_corpus_score_multi", peaks, n=n, live=live, Bq=Bq, K=K, rho=rho,
                      k=k, itemsize=itemsize, segments=segments)


def tune_cell(dev, sz, peaks, inputs, K: int, what: str,
              segments: int = 1) -> autotune.TunedTile:
    """Sweep one cell on ``inputs`` (``segments > 1``: a packed wave's
    ``dplr_corpus_score_multi`` inputs) and hold the sweep to the phase's
    checks (module docstring); prints the cell's line."""
    if segments == 1:
        Q, a, e, P, aC, valid = inputs
        slabs = ((Q, a, e, P, aC, valid),)
        call = lambda asked: ops._corpus_score(*inputs, K, 0, 1, asked)  # noqa: E731
        public = lambda: ops.dplr_corpus_score(*inputs, topk=K)  # noqa: E731
        Bq = P.shape[0]
    else:
        Qs, As, Vs, e, P, aC = inputs
        slabs = tuple(zip(Qs, As, e, P, aC, Vs))
        call = lambda asked: ops._corpus_score_multi(*inputs, K, 0, 1, asked)  # noqa: E731
        public = lambda: ops.dplr_corpus_score_multi(*inputs, topk=K)  # noqa: E731
        Bq = P.shape[1]
    Q, valid = slabs[0][0], slabs[0][5]
    n, rho, k = Q.shape
    dtype = blocks.dtype_name(Q.dtype)
    tuned = autotune.tune_corpus_score(n, rho, k, Bq, K, dtype=dtype, inputs=inputs,
                                       candidates=sz.tune_candidates, repeats=sz.tune_repeats,
                                       device=dev, segments=segments)
    swept = tuned.swept
    bad = [r for r in swept if r.fits and not r.parity_ok and r.acc_dtype == "float32"]
    if bad:
        raise AssertionError(f"autotune {what}: {len(bad)} f32 candidates failed their gate, "
                             f"first {bad[0]}")
    # every f32 candidate is bitwise the default's, which is kernel 1's sorted
    vals, ids = call(blocks.default_tile(Bq, K))
    for s, (q, a, e_s, p, ac, v) in enumerate(slabs):
        check_exact(vals.reshape(-1, Bq, K)[s], ids.reshape(-1, Bq, K)[s],
                    ops.dplr_corpus_score(q, a, e_s, p, ac, v, acc_dtype="float32"), K,
                    f"autotune {what} default geometry, slab {s}")
    # after registration, block_n=None is the winner's geometry, bitwise
    win = next(r for r in swept if r.parity_ok and r.us == tuned.us)
    same_bits(public(), call(win.effective), f"autotune {what}: a block_n=None call",
              "the explicit winner's call")
    unfit = sum(not r.fits for r in swept)
    if dev.type == "cuda" and Bq >= blocks.CORPUS_MAX_GROUP and not unfit:
        raise AssertionError(f"autotune {what}: no candidate past the card's shared memory")
    failed_bf16 = sum(r.fits and not r.parity_ok for r in swept)
    clamps = sum(len(r.clamps) for r in swept)
    live = sum(int(v.sum()) for *_, v in slabs)
    bnd, by = corpus_bound(n, live / segments, Bq, K, rho, k, Q.element_size(), peaks,
                           segments)
    print(f"phase autotune: {what} {segments} x n={n} ({live} live) Bq={Bq} K={K} {dtype} "
          f"slab: {len(swept)} swept ({unfit} past the card's shared memory, {failed_bf16} bf16 "
          f"failed their gate, {clamps} clamp events); default {tuned.default_us / 1e3:.4f} ms, "
          f"winner {tuned.us / 1e3:.4f} ms {win.effective._asdict()}, speedup "
          f"{tuned.speedup:.3f}, bound {bnd:.4f} ms ({by}), {bnd / (tuned.us / 1e3):.3f} of "
          f"the bound, roofline_frac {tuned.roofline_frac:.3f}", flush=True)
    return tuned


# a row's tuned time past this multiple of its default's fails the phase:
# a winner applies only to launches like the ones it was timed on
TUNED_SLOWER = 1.10


def tuned_rows(dev, sz, peaks, rows: dict) -> list:
    """Kernels 1, 2 and 4 and their bf16 rows at the timing phase's shapes,
    the default geometry and the registry's (``block_n=None``) timed side by
    side on the same inputs, as the tuner times a candidate (device time,
    the calls queued behind a device-side sleep); float32 results bitwise
    equal.  A row whose tuned time is past its default's is flagged, and
    on the card past ``TUNED_SLOWER`` times it fails (a CPU time is noise).
    Adds ``tuned_ms``,
    ``tuned_default_ms`` and ``tuned_tile`` to the rows."""
    gen = torch.Generator(device=dev).manual_seed(1)
    n, rho, k, Bq = sz.n, sz.rho, sz.k, max(sz.bqs)
    Q, a_I, e, P_C, a_C, valid = corpus_inputs(dev, n, sz.live, Bq, rho, k, gen)
    K = sz.topk_times[0][1]
    S, Bq4, n_s, K4 = sz.multi
    _, margs = multi_inputs(dev, (n_s,) * S, (sz.tenant_items,) * S, Bq4, rho, k, gen)
    to16 = lambda t: t.to(torch.bfloat16)  # noqa: E731
    margs16 = (tuple(map(to16, margs[0])), tuple(map(to16, margs[1])), *margs[2:])
    slabs = {"": (Q, a_I), "_bf16": (to16(Q), to16(a_I))}
    lines = []
    for suffix, (q, a) in slabs.items():
        m = margs16 if suffix else margs
        cases = {   # name: (call at a geometry, n, Bq, K, segments)
            "dplr_corpus_score": (lambda t: ops._corpus_score(q, a, e, P_C, a_C, valid, None, 0,
                                                              1, t), n, Bq, None, 1),
            "dplr_corpus_topk": (lambda t: ops._corpus_score(q, a, e, P_C, a_C, valid, K, 0, 1,
                                                             t), n, Bq, K, 1),
            "dplr_corpus_score_multi": (lambda t: ops._corpus_score_multi(*m, K4, 0, 1, t), n_s,
                                        Bq4, K4, S),
        }
        for name, (fn, n_, bq_, k_, segs) in cases.items():
            dtype = "bfloat16" if suffix else "float32"
            tile = blocks.resolve_tile(n_, rho, k, bq_, k_, dtype, dev.type, segments=segs)
            default = blocks.default_tile(bq_, k_)
            blocks.drain_clamp_events()
            tuned = lambda: fn(blocks.Tile(None, None))  # noqa: E731
            if tile.acc_dtype == "float32":
                same_bits(tuned(), fn(default), f"autotune {name}{suffix} tuned",
                          "the default geometry's call")
            ms_default = autotune._time_call(lambda: fn(default), sz.tune_repeats, dev) / 1e3
            ms_tuned = autotune._time_call(tuned, sz.tune_repeats, dev) / 1e3
            row = rows[name + suffix]
            row.update(tuned_ms=ms_tuned, tuned_default_ms=ms_default, tuned_tile=tile._asdict())
            flag = ""
            if ms_tuned > ms_default:
                flag = f" (SLOWER than the default, {ms_tuned / ms_default:.3f}x)"
            lines.append(f"{name}{suffix} n={n_} Bq={bq_} K={k_} x{segs}: default "
                         f"{ms_default:.4f} ms, tuned {ms_tuned:.4f} ms {tile._asdict()}{flag}")
            if dev.type == "cuda" and ms_tuned > TUNED_SLOWER * ms_default:
                raise AssertionError(f"autotune: {lines[-1]}, past {TUNED_SLOWER}x")
    return lines


def registry_bounds(dev, sz, serve) -> str:
    """No record makes a call unlaunchable or carries a geometry to a query
    group it was not timed at: on the serve engine's slab, a Bq = 1 record
    of chunk 4,096 leaves a Bq = 16 call at the default geometry, and an
    exact Bq = 16 record of chunk 32,768 at group 16 (past the card's
    shared memory) is halved, visibly, until it launches; both bitwise the
    default's answer."""
    engine, K = serve.engine, sz.topk
    cache, e = engine.cache, engine.params["e"].float()
    n, rho, k = cache.Q_I.shape
    ctx = np.concatenate([serve.data.context_query(7100 + j)["context_ids"] for j in range(16)])
    ids, w = engine._ctx_tensors(ctx, None)
    P, aC = engine.runtime._query(engine.params, ids, w)
    args = (cache.Q_I, cache.a_I, e, P, aC, cache.valid)
    want = ops._corpus_score(*args, K, 0, 1, blocks.default_tile(16, K))
    cell = lambda bq: blocks.tile_cell(n, rho, k, bq, K, "float32", dev.type)  # noqa: E731
    blocks.register_tuned_tile(cell(1), 4096)
    if blocks.resolve_tile(n, rho, k, 16, K, "float32", dev.type) != blocks.default_tile(16, K):
        raise AssertionError("autotune: a Bq=1 record's geometry reached a Bq=16 call")
    same_bits(ops.dplr_corpus_score(*args, topk=K), want,
              "autotune: Bq=16 beside a Bq=1 chunk-4096 record", "the default geometry's")
    blocks.register_tuned_tile(cell(16), blocks.MAX_BLOCK_N, group=16)
    blocks.drain_clamp_events()
    got = ops.dplr_corpus_score(*args, topk=K)
    halved = blocks.drain_clamp_events()
    if not halved or halved[0]["requested"] != blocks.MAX_BLOCK_N:
        raise AssertionError(f"autotune: a chunk-{blocks.MAX_BLOCK_N} record left no clamp "
                             f"event: {halved}")
    same_bits(got, want, f"autotune: Bq=16 at an exact chunk-{blocks.MAX_BLOCK_N} record",
              "the default geometry's")
    blocks.clear_tuned_tiles()
    return (f"a Bq=1 chunk-4096 record left Bq=16 at the default; an exact chunk-"
            f"{blocks.MAX_BLOCK_N} record halved to {halved[-1]['effective']} "
            f"({len(halved)} clamp events); both bitwise the default")


def autotune_phase(dev, sz, peaks, serve, tenants, rows: dict) -> None:
    """Phase 12 (module docstring).  ``serve``: the serving phase's result;
    ``tenants``: the tenants phase's states; ``rows``: the timing phase's,
    which gain the tuned times."""
    t0 = time.perf_counter()
    engine, K = serve.engine, sz.topk
    params, cache = engine.params, engine.cache
    data = serve.data
    ctx = np.concatenate([data.context_query(7000 + j)["context_ids"]
                          for j in range(max(bq for bq, _ in sz.tune_cells))])
    wave = np.stack([np.concatenate([data.context_query(8000 + 4 * s + j)["context_ids"]
                                     for j in range(sz.tenant_bq)])
                     for s in range(len(tenants))])
    # the served answers before any tuning: the engine at Bq = 1 and 16,
    # and one packed wave of the tenants
    states = list(tenants.values())
    before = [engine.topk(ctx[:bq], K) for bq, _ in sz.tune_cells[:2]]
    before.append(fused_topk(states, wave, K))
    e = params["e"].float()

    def query(state, rows_):
        ids, w = state._ctx_tensors(rows_, None)
        return state.runtime._query(state.params, ids, w)

    tuned = []
    for bq, dtype in sz.tune_cells:
        slab = getattr(torch, dtype)
        inputs = (cache.Q_I.to(slab), cache.a_I.to(slab), e, *query(engine, ctx[:bq]),
                  cache.valid)
        tuned.append(tune_cell(dev, sz, peaks, inputs, K, "served"))
    # the tenants' cell on the launch a packed wave makes: every tenant's
    # slab, the wave's queries
    parts = [query(st, wave[s]) for s, st in enumerate(states)]
    inputs = (tuple(st.cache.Q_I for st in states), tuple(st.cache.a_I for st in states),
              tuple(st.cache.valid for st in states),
              torch.stack([st.params["e"].float() for st in states]),
              torch.stack([p for p, _ in parts]), torch.stack([a for _, a in parts]))
    tuned.append(tune_cell(dev, sz, peaks, inputs, K, "tenants' packed wave", len(states)))

    # a candidate past a small n clamps visibly
    small = autotune.tune_corpus_score(sz.edge_n, sz.rho, sz.k, 2, K, candidates=(4096,),
                                       repeats=2, register=False, device=dev)
    over = [r for r in small.swept if r.block_n == 4096]
    if not all(any(ev["requested"] == 4096 and ev["effective"] == sz.edge_n for ev in r.clamps)
               for r in over) or not over:
        raise AssertionError(f"autotune: the 4096-slot candidate at n={sz.edge_n} left no "
                             f"clamp event: {over}")
    # the served answers after tuning: bitwise the untuned ones (f32)
    after = [engine.topk(ctx[:bq], K) for bq, _ in sz.tune_cells[:2]]
    after.append(fused_topk(states, wave, K))
    same_bits(tuple(after), tuple(before), "autotune: the served top-K after tuning",
              "its answer before tuning")
    lines = tuned_rows(dev, sz, peaks, rows)
    autotune.clear_results()
    blocks.clear_tuned_tiles()
    bounds = registry_bounds(dev, sz, serve)
    blocks.drain_clamp_events()
    print(f"phase autotune: {len(tuned)} cells tuned in {time.perf_counter() - t0:.1f} s; the "
          f"served engine's top-K at Bq=1 and 16 and a packed wave of {len(states)} tenants "
          f"bitwise their untuned answers; a 4096-slot candidate at n={sz.edge_n} clamped "
          f"visibly; {bounds}; rows at the timing phase's shapes: " + "; ".join(lines)
          + "; registry cleared", flush=True)


def _device_times(prof) -> dict:
    """{kernel name: (device ms, calls)} of the CUDA kernels a profiler saw."""
    out = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", 0) or 0
        if t and str(getattr(evt, "device_type", "")).endswith("CUDA"):
            m = re.search(r"(\w+)(?:<[^<>()]*>)?\(", evt.key)   # name<args>( -> name
            name = m.group(1) if m else evt.key[:60]
            ms, calls = out.get(name, (0.0, 0))
            out[name] = (ms + t / 1e3, calls + evt.count)
    return out


def profiled(dev, fn, tries: int = 3):
    """Run ``fn`` in a torch.profiler window until the profiler saw, for
    each CUDA kernel ``ops.LAUNCHES`` counted in the window, exactly that
    many launches.  Returns (``_device_times`` split, wall ms of the last
    window, {kernel: (seen, counted)} of the last window); the split is
    None when no window agreed or the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    wall, seen = 0.0, {}
    for _ in range(tries):
        before = collections.Counter(ops.LAUNCHES)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            wall = (time.perf_counter() - t0) * 1e3
        counted = ops.LAUNCHES - before
        split = _device_times(prof)
        seen = {g: (split.get(g, (0.0, 0))[1], n) for g, n in counted.items()}
        if split and all(a == b for a, b in seen.values()):
            return split, wall, seen
    return None, wall, seen


def host_issue_ms(dev, fn, reps=20) -> float:
    """Host time to issue one call, the mean over back-to-back calls
    (after a warm-up), the device left to finish after the clock stops."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    _sync(dev)
    return host


def profile_phase(dev, sz, engine, ctxs) -> None:
    """Where the device time goes: the split of one top-K call between its
    stage-1 and merge kernels (single-slab and multi-tenant), the host's
    time to issue one, kernels 3 and 6's card time a call at their timed
    shapes, and the device's busy share while the
    serve phase's engine answers Bq = 1 top-K queries back to back (host
    clock around the window).  Reports "not measured" when the profiler sees no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import dplr_corpus_score as launchers

    gen = torch.Generator(device=dev).manual_seed(2)
    Bq, reps = max(sz.bqs), 3
    Q, a_I, e, P_C, a_C, valid = corpus_inputs(dev, sz.n, sz.live, Bq, sz.rho, sz.k, gen)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        # a first window, discarded: tracing starts up
        ops.dplr_corpus_score(Q, a_I, e, P_C, a_C, valid, topk=16)
        _sync(dev)
    parts = []
    for K in (16, 1024):
        split, _, seen = profiled(dev, lambda: [
            ops.dplr_corpus_score(Q, a_I, e, P_C, a_C, valid, topk=K) for _ in range(reps)])
        host = host_issue_ms(dev, lambda: ops.dplr_corpus_score(Q, a_I, e, P_C, a_C, valid,
                                                                topk=K))
        parts.append(f"topk Bq={Bq} K={K}, per call: host issue {host:.4f} ms; " + (", ".join(
            f"{k} {ms / reps:.4f} ms ({calls / reps:g} launches)"
            for k, (ms, calls) in sorted(split.items())) if split is not None
            else f"not measured (profiler saw {seen})"))
    del Q
    S, Bq4, n_s, K4 = sz.multi
    _, margs = multi_inputs(dev, (n_s,) * S, (sz.tenant_items,) * S, Bq4, sz.rho, sz.k, gen)
    split, _, seen = profiled(dev, lambda: [
        ops.dplr_corpus_score_multi(*margs, topk=K4) for _ in range(reps)])
    host = host_issue_ms(dev, lambda: ops.dplr_corpus_score_multi(*margs, topk=K4))
    # the same launches without the wrapper's checks: the difference is the
    # wrapper's own host time (uncounted launches, outside the counted run)
    tile = blocks.default_tile(Bq4, K4)          # the geometry the wrapper resolves
    bare = (host_issue_ms(dev, lambda: launchers.launch_multi_topk(*margs, K4, 0, 1,
                                                                   "float32", tile))
            if dev.type == "cuda" else None)
    bare = "not measured (no card)" if bare is None else f"{bare:.4f} ms"
    parts.append(f"multi S={S} Bq={Bq4} K={K4}, per call: host issue {host:.4f} ms "
                 f"(launcher alone, no wrapper checks: {bare}); " + (
        ", ".join(f"{k} {ms / reps:.4f} ms ({calls / reps:g} launches)"
                  for k, (ms, calls) in sorted(split.items())) if split is not None
        else f"not measured (profiler saw {seen})"))
    del margs

    # kernels 3 and 6 at their timed shapes: card time a call (the timing
    # phase's CUDA events also hold the host's issue time where it is longer)
    timed = []
    for Bq3 in sz.bq3s:
        args = items_inputs(sz.n3, Bq3, sz.m3, sz.rho, sz.k, gen)
        timed.append((f"dplr_score_items Bq={Bq3}", lambda a=args: ops.dplr_score_items(*a)))
    for B, m in sz.pairs:
        V, R = pair_inputs(B, m, sz.k, gen)
        timed.append((f"fwfm_pairwise B={B} m={m}", lambda V=V, R=R: ops.fwfm_pairwise(V, R)))
    for label, fn in timed:
        fn()
        split, _, seen = profiled(dev, lambda: [fn() for _ in range(reps)])
        parts.append(f"{label}, per call: " + (", ".join(
            f"{k} {ms / reps:.4f} ms ({calls / reps:g} launches)"
            for k, (ms, calls) in sorted(split.items())) if split is not None
            else f"not measured (profiler saw {seen})"))
    del timed, args, V

    engine.topk(ctxs[0], sz.topk)
    _sync(dev)
    split, wall, seen = profiled(dev, lambda: [engine.topk(ctx, sz.topk) for ctx in ctxs])
    busy = sum(ms for ms, _ in split.values()) if split is not None else 0.0
    share = (f"device busy {busy:.3f} ms of {wall:.3f} ms wall, idle share "
             f"{1 - busy / wall:.3f}" if busy else
             f"device time not measured (profiler saw {seen})")
    print(f"phase profile: {'; '.join(parts)}; serving {len(ctxs)} top-{sz.topk} "
          f"queries at Bq=1 on the {engine.n_items}-item engine of the serve phase "
          f"(profiled): {share}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peaks = next((rates for key, *rates in PEAKS if key in kind), None)
    if peaks is None:
        raise SystemExit(f"chip_smoke: no peak rates known for {kind!r}")
    print(smi)
    print(f"phase card: {kind}; peaks {peaks[0] / 1e12:g} TB/s, {peaks[1] / 1e12:g} "
          f"TFLOP/s f32, {peaks[2] / 1e12:g} TFLOP/s bf16 tensor cores (dense); TF32 off",
          flush=True)
    # the dry run counts every cell on meta, and the models phase's batches
    # are made, on the host beside the build and the card's phases, each in
    # a process of its own
    dry_out, mesh_out = BUILD / "dryrun_torch", BUILD / "dryrun_torch_mesh"
    dry = start_dryrun(dev, list(FULL.dryrun_args), dry_out)
    dry_mesh = start_dryrun(dev, list(FULL.dryrun_mesh_args), mesh_out)
    try:
        with concurrent.futures.ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as pool:
            model_batches = pool.submit(models_data, FULL.models, FULL.model_make,
                                        FULL.model_batch, FULL.model_steps)
            kernels = run_phases(dev, peaks, model_batches, (dry, dry_out, dry_mesh, mesh_out))
    finally:
        for proc in (dry, dry_mesh):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


def run_phases(dev, peaks, model_batches, dry) -> list:
    """Every phase after the card's; returns the ``kernels`` line's rows.
    ``dry``: the dry run's process and its records' directory, then the
    production-mesh dry run's."""
    t0 = time.perf_counter()
    built = _build.build_all()
    logs = []
    for src in _build.sources():
        log = _build.build_log(src.stem).read_text()
        for fn in ptxas_report(log):
            logs.append(f"{fn['kernel']}: {fn['registers']} registers, {fn['spill_stores']} "
                        f"bytes spill stores, {fn['spill_loads']} bytes spill loads"
                        + "".join(f"; {w}" for w in fn["warnings"]))
        bad = spilled(src.stem, log)
        if bad:
            raise AssertionError(f"{', '.join(fn['kernel'] for fn in bad)} spill registers")
    print(f"phase build: {time.perf_counter() - t0:.1f} s ({len(built)} sources compiled); "
          + " | ".join(logs), flush=True)
    errs = kernel_checks(dev, FULL)
    serve = serving_phase(dev, FULL)
    launches = dict(serve.launches)
    # the bf16 rows' launches: the serve-bf16 phase's alone
    launches_bf16 = serve_bf16_phase(dev, FULL, serve)
    tenant_launches, tenants = tenants_phase(dev, FULL, serve)
    for g in ops.KERNELS["dplr_corpus_score_multi"]:
        launches[g] = tenant_launches[g]
    # this slice's main path: the sharded engines' launches, counted over
    # their phase (the bf16 half's into the bf16 rows)
    for into, counts in zip((launches, launches_bf16), shard_phase(dev, FULL, serve)):
        for g, count in counts.items():
            into[g] = into.get(g, 0) + count
    # this slice's main path: the sharded lookup's launches in its training phase
    for g, count in shard_train_phase(dev, FULL).items():
        launches[g] = launches.get(g, 0) + count
    # and on the mesh's data axis
    for g, count in data_phase(dev, FULL).items():
        launches[g] = launches.get(g, 0) + count
    # the LM family on the mesh: kernel 7 at each position's heads
    mesh_flash = lm_mesh_phase(dev, FULL)
    for g, count in wire_phase(dev, FULL, serve, tenants).items():
        launches[g] = launches.get(g, 0) + count
    # the eval phase's bf16 case adds to the bf16 rows (kernel 6's only path)
    for g, count in eval_phase(dev, FULL, serve).items():
        into = launches_bf16 if g.endswith("_bf16") else launches
        into[g] = into.get(g, 0) + count
    for g, count in train_phase(dev, FULL, serve).items():
        launches[g] = launches.get(g, 0) + count
    for g, count in models_phase(dev, FULL, model_batches.result()).items():
        launches[g] = launches.get(g, 0) + count
    launches.update(lm_phase(dev, FULL))
    for g, count in mesh_flash.items():
        launches[g] = launches.get(g, 0) + count
    lm_train_phase(dev, FULL)
    gnn_phase(dev, FULL)
    # this slice's main path: the examples' launches, counted over their phase
    for g, count in examples_phase(dev, FULL).items():
        launches[g] = launches.get(g, 0) + count
    dryrun_phase(dev, FULL, *dry)
    rows = timing_phase(dev, FULL, peaks)
    autotune_phase(dev, FULL, peaks, serve, tenants, rows)
    profile_phase(dev, FULL, serve.engine, serve.ctxs)
    kernels = []
    for name, cuda_kernels in ops.KERNELS.items():
        source, replaces = KERNEL_ROWS[name]
        row = dict(rows[name])
        row.setdefault("library_ms", None)
        counts = launches_bf16 if name.endswith("_bf16") else launches
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=sum(counts[g] for g in cuda_kernels),
                            cuda_launches={g: counts[g] for g in cuda_kernels},
                            max_abs_err=errs[name], **row))
    return kernels


if __name__ == "__main__":
    main()

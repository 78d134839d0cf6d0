#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card, at the full
``dplr-fwfm`` width, and hold every kernel against its plain version.

    python3 chip_smoke.py

Phases, one line each:

1. card: the ``nvidia-smi`` name and power limit; TF32 off.
2. build: compile ``src/repro_torch/kernels/csrc/*.cu`` with nvcc (sm_90a);
   fails if a kernel of ``dplr_corpus_score.cu`` or ``flash_attention_wgmma``
   spills registers.
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the shapes the serving and eval paths give it, plus ragged,
   all-dead and multi-hot edges; every top-K call also by C1 (below),
   with K past 4,096, K = n and adversarial orders of the scores.
4. serve: the full config (82 fields, k = 16, rho = 3, random weights from
   a seed) serving a 1,000,000-item corpus from a 2^20-slot slab: top-K
   and score queries, churn, a model refresh, and Algorithm 1 per call,
   each held against the plain path (whose field lookups are the plain
   embedding bag, so no check runs a kernel), and one top-65,536 query.  The launches of each CUDA
   kernel are counted over this phase alone.
5. tenants: the same config and weights serving 16 tenants on one
   ScorerRuntime, each 62,500 items of the serve phase's corpus in a
   65,536-slot slab, through ``QueryFrontend(pack=True)`` (one fused
   launch per wave of 16 tenants x 4 requests) and then through a
   ``pack=False`` frontend on the same states: every reply held against
   the plain scores, packed replies bitwise equal to unpacked ones,
   requests per second both ways, and the card's idle share over packed
   waves.  The multi-tenant kernel's launches are counted over the
   timed packed waves alone.
6. eval: the paper's comparison through ``eval.harness`` on the serve
   phase's data: ``evaluate_pointwise`` on 20,000 held-out rows for the
   DPLR model, the full-FwFM baseline (``make_fwfm_baseline``, random
   weights from a seed) and its matched-pruned form (249 of 3,321
   entries), each model's logits held against the plain path;
   ``model_scores(pruned=)`` against ``apply(pruned_mask=)``; and
   ``serving_parity`` for the DPLR model at 16 queries x 16,384 items
   (model, engine and frontend scores against the plain scores, top-10
   ids equal except at ties).  Kernel launches are counted over this
   phase alone.
7. lm: gemma3-1b at full width (26 layers, d = 1152, random f32 weights
   from a seed, bf16 compute): a prefill of B = 2 prompts of 32,752
   tokens into a 32,768-slot cache through the flash-attention kernel
   (26 launches), the same prefill through the attention's plain version
   and a plain f32 prefill, both bf16 prefills held against the f32 one
   on the last logits and the cache; then 16 greedy ``decode_step``s from
   the kernel prefill's cache, held against one pass over the same tokens
   at those positions on that cache.  Prefill seconds,
   decode ms a step (host clock, synchronized) and peak memory.
8. timing: each kernel's median time over CUDA events, its plain
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
   mask); and each top-K shape's peak device memory (its scratch and
   outputs) beside the yardstick's.
9. profile: with torch.profiler, the device time of a top-K call by CUDA
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
the score is the meaningful one.  Top-K ids must equal the plain stable
top-K's, except where the plain scores tie within that tolerance; planted
exact ties must go to the lower slot.  Row [s] of the multi-tenant kernel
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
maxima that may differ, and the f32 bound).  The lm phase's bounds: the
kernel path's largest error from an f32 prefill (through
``gqa_attention``), on the last logits and on the cache, at most
``1.25x`` the plain path's; a decode step's logit within ``3e-3 + 3e-2
|x|`` of one pass over the decoded positions on the same cache: the
JAX package's ``test_decode_matches_forward`` bound.  That pass attends
through ``gqa_attention``, which rounds its scores to bf16 as decode
does, and reads the prefill's cache as decode does; only the shapes of
its products differ (all positions at once).  The ratio with one
rounding of each term (``2^-8 size``, ``size`` the logit's summed
``|h_d E_vd|``) added is printed too.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import dplr_fwfm, gemma3_1b  # noqa: E402
from repro_torch.core import ranking as rk  # noqa: E402
from repro_torch.core.dplr import DPLRParams, dplr_diagonal, materialize_R  # noqa: E402
from repro_torch.core.fields import FeatureLayout  # noqa: E402
from repro_torch.core.interactions import dplr_pairwise  # noqa: E402
from repro_torch.core.pruning import matched_param_count, prune_matched  # noqa: E402
from repro_torch.data.synthetic_ctr import SyntheticCTR  # noqa: E402
from repro_torch.embedding.bag import (  # noqa: E402
    item_arena_ids,
    lookup_linear_terms,
    padded_rows,
)
from repro_torch.eval import harness  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.models.recsys import fwfm  # noqa: E402
from repro_torch.models.transformer import attention  # noqa: E402
from repro_torch.models.transformer import model as tm  # noqa: E402
from repro_torch.serving.corpus import masked_slab_scores  # noqa: E402
from repro_torch.serving.engine import CorpusState  # noqa: E402
from repro_torch.serving.frontend import QueryFrontend  # noqa: E402
from repro_torch.serving.runtime import ScorerRuntime  # noqa: E402

TOL = 1e-5

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
    # embedding bag: rows of the context lookup (Bq), of the slab build
    # (items), of pointwise eval; and a B whose threads end mid-block
    bag_rows=(16, 1_000_000, 4096), bag_ragged=4097,
    # fwfm_pairwise (B, m): the eval batch, serve_bulk's pointwise batch,
    # and one example of a 39-field model
    pairs=((4096, 82), (262_144, 82), (1, 39)),
    make_fwfm=dplr_fwfm.make_fwfm_baseline, eval_n=20_000, eval_batch=4096,
    parity=(16, 16_384), pruned_q=(4, 1024),
    # top-K past the old 4,096 limit, the adversarial orders (n, live, Bq,
    # Ks) and K = n (n, Bq), all held by C1
    big_ks=(4097, 65_536), adv=(1 << 20, 1_000_000, 16, (16, 1024, 4096, 4097, 65_536)),
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
    make_lm=gemma3_1b.make_config, lm_batch=2, lm_prompt=32_752, lm_cache=32_768,
    lm_steps=16,
)

# NVIDIA data-sheet peaks: (device memory bytes/s, f32 flop/s outside the
# tensor cores, dense bf16 tensor-core flop/s), by the card name torch
# reports.
PEAKS = (
    ("H200", 4.8e12, 67e12, 989e12),
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H100", 3.35e12, 67e12, 989e12),    # SXM
)

# The entry points the serve phase drives; the tenants phase drives
# dplr_corpus_score_multi, the eval phase embedding_bag and fwfm_pairwise.
SERVE_KERNELS = ("dplr_corpus_score", "dplr_corpus_topk", "dplr_score_items",
                 "embedding_bag")
EVAL_KERNELS = ("embedding_bag", "fwfm_pairwise")

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
    "fwfm_pairwise": ("src/repro_torch/kernels/csrc/fwfm_interaction.cu",
                      "src/repro/kernels/fwfm_interaction.py:49"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:124"),
}


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


def kernel_checks(dev, sz) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {name: 0.0 for name in ops.KERNELS}
    notes = []
    corpus_checks(dev, sz, gen, errs, notes)

    for n3, Bq in [(sz.n3, b) for b in sz.bq3s] + [(sz.edge_n, 2)]:
        V = torch.randn((Bq, n3, sz.m3, sz.k), generator=gen, device=dev) * 0.25
        U = torch.randn((sz.rho, sz.m3), generator=gen, device=dev) * 0.2
        e3 = torch.rand((sz.rho,), generator=gen, device=dev) + 0.5
        d = -torch.rand((sz.m3,), generator=gen, device=dev)
        PC = torch.randn((Bq, sz.rho, sz.k), generator=gen, device=dev)
        sC = torch.randn((Bq,), generator=gen, device=dev)
        want = ref.dplr_score_items_ref(V, U, e3, d, PC, sC)
        got = ops.dplr_score_items(V, U, e3, d, PC, sC)
        _sync(dev)
        err = check_close(got, want, f"score_items n={n3} Bq={Bq}")
        one = ops.dplr_score_items(V[0], U, e3, d, PC[0], sC[0])
        _sync(dev)
        err = max(err, check_close(one, want[0], f"score_items n={n3} per query"))
        errs["dplr_score_items"] = max(errs["dplr_score_items"], err)
    errs["dplr_corpus_score_multi"], more = multi_checks(dev, sz, gen)
    notes += more
    errs["embedding_bag"], more = bag_checks(dev, sz, gen)
    notes += more
    errs["fwfm_pairwise"], more = pair_checks(dev, sz, gen)
    notes += more
    errs["flash_attention"], more = flash_checks(dev, sz, gen)
    notes += more
    print(f"phase kernels: all within {TOL:g} x max(1, |s|) (embedding_bag: bitwise on "
          f"one-hot layouts, 1e-6 x sum |w row| on multi-hot; flash_attention: "
          f"{FLASH_TOL[torch.float32]:g} max|v| in f32, 2^-7 max|v| and per element "
          f"2^-7 (|o| + sum p|v|/l) + 1e-5 max|v| in bf16); max |diff| "
          + ", ".join(f"{k}={v:.3g}" for k, v in errs.items())
          + "; " + ", ".join(notes), flush=True)
    return errs


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


def bag_case(layout: FeatureLayout, kind, B: int, gen):
    """Inputs of one ``embedding_bag`` call on the lookup path for ``kind``
    fields of ``layout`` (None: all): (B, n_slots) int32 arena-global ids,
    each slot uniform over its field's rows, weights in [0.5, 1.5), and
    the slot -> field map on the device (``ops.bag_map``)."""
    dev = gen.device
    slots = np.arange(layout.n_slots) if kind is None else layout.slots_of(kind)
    fields = layout.slot_to_field[slots]
    vocab = torch.as_tensor(np.array([f.vocab_size for f in layout.fields])[fields],
                            device=dev)
    base = torch.as_tensor(layout.field_offsets[fields].astype(np.int64), device=dev)
    local = (torch.rand((B, len(slots)), generator=gen, device=dev) * vocab).long()
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


def pair_checks(dev, sz, gen) -> tuple[float, list]:
    """The FwFM pairwise kernel against its plain version, within
    ``TOL * max(1, 0.5 * sum |R_ij G_ij|)`` (ROADMAP's size-scaled rule)."""
    err, notes = 0.0, []
    for B, m in sz.pairs:
        V, R = pair_inputs(B, m, sz.k, gen)
        got = ops.fwfm_pairwise(V, R)
        _sync(dev)
        err = max(err, check_close(got, ref.fwfm_pairwise_ref(V, R),
                                   f"fwfm_pairwise B={B} m={m}", size=pair_size(V, R)))
        notes.append(f"B={B} m={m}")
        del V, got
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
    global and windowed layers and at ragged small shapes, in f32 and
    bf16, within ``flash_ratio``'s bounds.  Returns the largest |diff| of
    the bf16 cases (the model's type) and notes."""
    err, notes = 0.0, []
    for B, S, H, KV, hd, window in sz.flash + sz.flash_small:
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


# -- phase 5: tenants ---------------------------------------------------------

def tenants_phase(dev, sz, serve) -> dict:
    """16 tenants (``sz.tenants``) on one ScorerRuntime, each a disjoint
    slice of the serve phase's corpus in its own slab, with the serve
    phase's weights.  Waves of tenants x ``tenant_bq`` requests at
    K = ``topk`` go through a packed frontend (one fused launch a wave),
    then the same waves through an unpacked one on the same states.
    Returns the multi-tenant kernel's launches over the timed packed
    waves."""
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
    return launches


# -- phase 6: eval ------------------------------------------------------------

def plain_apply(params, cfg, ids, w, pruned_mask=None):
    """``fwfm.apply`` in plain PyTorch (plain embedding bag and pairwise
    term, no kernel), and the summed size of its terms:
    ``|bias| + sum |b_s w_s| + 0.5 sum_ij |R_ij G_ij|`` (R materialized
    for DPLR)."""
    V = plain_fields(params["embedding"], cfg.layout, ids, w)
    lin = lookup_linear_terms(params["linear"], cfg.layout, ids, w)
    if cfg.interaction == "dplr":
        p = DPLRParams(params["U"], params["e"])
        pw, R = dplr_pairwise(V, p), materialize_R(p)
    else:
        R = fwfm.field_matrix(params, cfg)
        if pruned_mask is not None:
            R = R * pruned_mask
        pw = ref.fwfm_pairwise_ref(V, R)
    size = (params["bias"].abs() + lookup_linear_terms(params["linear"].abs(), cfg.layout,
                                                       ids, w.abs()) + pair_size(V, R))
    return params["bias"] + lin + pw, size


def eval_phase(dev, sz, serve) -> dict:
    """The paper's comparison through ``eval.harness`` on the serve phase's
    data and DPLR weights: pointwise eval of DPLR, full FwFM and
    matched-pruned FwFM, each model's logits against the plain path; the
    pruned model's Algorithm 1 against its pointwise scores; and
    ``serving_parity`` (model, engine, frontend) for DPLR against the
    plain scores.  Returns the launches of each CUDA kernel over the
    phase."""
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
    model = rep_["paths"]["model"]
    print(f"phase eval: host data {host_s:.1f} s; evaluate_pointwise on {sz.eval_n} rows, "
          f"batch {sz.eval_batch}: " + "; ".join(parts)
          + f"; pruned R keeps {len(pr.entries_r)} of {m * (m - 1) // 2} entries; "
          f"model_scores(pruned=) = apply(pruned_mask=) on {Qp} x {n_p}; serving_parity "
          f"Q={Q} n={n}: model ndcg@10 {model['ndcg@10']:.4f}, mrr {model['mrr']:.4f}; "
          f"max |diff| vs model {rep_['max_abs_diff']}, bitwise {rep_['bit_exact']}; "
          f"top-10 ids differing from plain (all within the tie rule) {diffs}; "
          f"launches {launches}", flush=True)
    return launches


# -- phase 7: lm --------------------------------------------------------------

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


def plain_extend(params, cfg, tokens, cache, start: int):
    """One trunk pass over ``tokens (B, n)`` at positions ``start..start+n-1``
    against the k/v that ``cache`` holds before ``start``: the n positions'
    hidden states (pre-final-norm) and the cast parameters.  Its attention
    is ``attention.gqa_attention``, whose bf16 scores round as
    ``decode_attention``'s do, and its keys go through the cache's type as
    decode's do; what it does not share with ``tm.decode_step`` is the
    shape of each product (n positions at once, not one)."""
    cparams = tm.cast_params(params, cfg.compute_dtype)
    n = tokens.shape[1]
    x = tm.embed(cparams, cfg, tokens)
    q_pos = torch.arange(start, start + n, device=tokens.device)
    k_pos = torch.arange(start + n, device=tokens.device)
    for i in range(cfg.n_layers):
        lp = tm.layer_params(cparams, i)
        q, k, v = tm.attention_inputs(lp, cfg, x, q_pos)
        keys, vals = (torch.cat([cache[i, j, :, :start], new.to(cache.dtype)], 1).to(q.dtype)
                      for j, new in ((0, k), (1, v)))
        x = tm.finish_layer(lp, cfg, x, attention.gqa_attention(
            q, keys, vals, n_kv_heads=cfg.n_kv_heads, q_positions=q_pos, k_positions=k_pos,
            window=cfg.window(i)))
    return x, cparams


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def cache_diff(cache, want, S: int) -> float:
    """Max |diff| over positions 0..S-1 of two caches, a layer at a time."""
    return max(_max_diff(cache[i, :, :, :S], want[i, :, :, :S]) for i in range(cache.shape[0]))


def lm_phase(dev, sz) -> dict:
    """gemma3-1b (``sz.make_lm``) at full width, random f32 weights from
    seed 0, bf16 compute: the kernel prefill, the plain bf16 and f32
    prefills (the f32 one through ``gqa_attention``), and greedy decode
    from the kernel prefill's cache against one pass over the decoded
    positions (``plain_extend``).  Returns the launches of kernel 7's CUDA
    kernels over the kernel prefill, by name."""
    cfg = sz.make_lm()
    f32_cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    B, S, S_max, n_steps = sz.lm_batch, sz.lm_prompt, sz.lm_cache, sz.lm_steps
    V = cfg.vocab
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = tm.init(torch.Generator(device=dev).manual_seed(0), cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, V, (B, S), generator=gen, device=dev)

    ops.reset_launches()
    t0 = time.perf_counter()
    logits, cache = tm.prefill(params, cfg, tokens, S_max, device=dev)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    launches = {g: ops.LAUNCHES[g] for g in ops.KERNELS["flash_attention"]}
    if dev.type == "cuda" and launches["flash_attention_wgmma"] != cfg.n_layers:
        raise AssertionError(f"prefill launched the kernels {launches}, not "
                             f"flash_attention_wgmma once a layer ({cfg.n_layers})")
    before = sum(ops.LAUNCHES.values())
    t0 = time.perf_counter()
    plain_logits, plain_cache = plain_prefill(params, cfg, tokens, S_max, flash_plain)
    _sync(dev)
    plain_s = time.perf_counter() - t0
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
    fed, steps, step_ms = [], [], []
    for i in range(n_steps):
        fed.append(tok)
        t0 = time.perf_counter()
        lg, cache = tm.decode_step(params, cfg, tok, cache, S + i, device=dev)
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        steps.append(lg[:, 0, :V])
        tok = lg[:, -1, :V].argmax(-1, keepdim=True)
    got = torch.stack(steps, 1)                                # (B, n_steps, V)
    h, cparams = plain_extend(params, cfg, torch.cat(fed, 1), cache, S)
    del cache
    want = tm._logits(cparams, cfg, h)[..., :V]
    emb = cparams["embed"][:V].float().abs()
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
    print(f"phase lm: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} H={cfg.n_heads} "
          f"KV={cfg.n_kv_heads} hd={cfg.hd} vocab={V}, {cfg.n_params()} parameters (f32, "
          f"seed 0), bf16 compute; B={B} prompts of {S} tokens into {S_max} slots; "
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
          f"to {float(size.max()):.3g}: {size_ratio:.3f}); peak "
          f"memory {peak}", flush=True)
    return launches


# -- phase 8: timing ----------------------------------------------------------

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


def _mib(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.1f} MiB"


def bound_ms(nbytes: float, flops: float, peaks, tensor: bool = False) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate, or flops
    over the f32 rate (the bf16 tensor-core rate with ``tensor``)."""
    t_bytes, t_ops = nbytes / peaks[0], flops / peaks[2 if tensor else 1]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def timing_phase(dev, sz, peaks) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1)
    n, rho, k = sz.n, sz.rho, sz.k
    rk_ = rho * k
    Bq = max(sz.bqs)
    Q, a_I, e, P_C, a_C, valid = corpus_inputs(dev, n, sz.live, Bq, rho, k, gen)
    live = int(valid.sum())
    score_flops = live * (3 * rk_ + 2 * rho + 3)          # per query, live slots only
    in_bytes = live * (rk_ + 1) * 4 + n + (rho + Bq * (rk_ + 1)) * 4
    rows, extra = {}, []
    for Bq_t in (Bq, 1):
        args = (Q, a_I, e, P_C[:Bq_t].contiguous(), a_C[:Bq_t].contiguous(), valid)
        ms = device_ms(lambda: ops.dplr_corpus_score(*args))
        plain = device_ms(lambda: ref.dplr_corpus_score_ref(*args), 3, 2)
        bnd, by = bound_ms(in_bytes + Bq_t * n * 4, Bq_t * score_flops, peaks)
        extra.append(f"dplr_corpus_score n={n} Bq={Bq_t}: {ms:.4f} ms, plain {plain:.4f} ms, "
                     f"bound {bnd:.4f} ms ({by})")
        if Bq_t == Bq:
            rows["dplr_corpus_score"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by)
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
        bnd, by = bound_ms(in_bytes + Bq_t * K * 8, Bq_t * score_flops, peaks)
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
    del Q, rising

    m, n3 = sz.m3, sz.n3
    for Bq3 in sz.bq3s:
        V = torch.randn((Bq3, n3, m, k), generator=gen, device=dev) * 0.25
        U = torch.randn((rho, m), generator=gen, device=dev) * 0.2
        e3 = torch.rand((rho,), generator=gen, device=dev) + 0.5
        d = -torch.rand((m,), generator=gen, device=dev)
        PC = torch.randn((Bq3, rho, k), generator=gen, device=dev)
        sC = torch.randn((Bq3,), generator=gen, device=dev)
        ms = device_ms(lambda: ops.dplr_score_items(V, U, e3, d, PC, sC))
        plain = device_ms(lambda: ref.dplr_score_items_ref(V, U, e3, d, PC, sC), 3, 2)
        nbytes = (Bq3 * n3 * (m * k + 1) + rho * m + rho + m + Bq3 * (rk_ + 1)) * 4
        flops = Bq3 * n3 * (m * k * (2 + 2 * rho) + 2 * m + rho * (2 * k + 2) + 3)
        bnd, by = bound_ms(nbytes, flops, peaks)
        extra.append(f"dplr_score_items n={n3} m_I={m} Bq={Bq3}: {ms:.4f} ms, "
                     f"plain {plain:.4f} ms, bound {bnd:.4f} ms ({by})")
        if Bq3 == max(sz.bq3s):
            rows["dplr_score_items"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by)
    del V

    S, Bq4, n_s, K = sz.multi
    live_s = sz.tenant_items
    parts, args = multi_inputs(dev, (n_s,) * S, (live_s,) * S, Bq4, rho, k, gen)
    ms = device_ms(lambda: ops.dplr_corpus_score_multi(*args, topk=K))
    plain = device_ms(lambda: ref.dplr_corpus_multi_topk_ref(*args, K), 3, 2)
    single = device_ms(lambda: [ops.dplr_corpus_score(*p, topk=K) for p in parts])
    yard = device_ms(lambda: [torch.topk(ops.dplr_corpus_score(*p), K) for p in parts])
    peak = peak_mib(dev, lambda: ops.dplr_corpus_score_multi(*args, topk=K))
    nbytes = (S * (live_s * (rk_ + 1) * 4 + n_s) + S * (rho + Bq4 * (rk_ + 1)) * 4
              + S * Bq4 * K * 8)
    flops = S * Bq4 * live_s * (3 * rk_ + 2 * rho + 3)
    bnd, by = bound_ms(nbytes, flops, peaks)
    extra.append(f"dplr_corpus_score_multi S={S} n_s={n_s} ({live_s} live) Bq={Bq4} K={K}: "
                 f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} ms ({by}); "
                 f"{S} single-tenant dplr_corpus_score(topk={K}) calls at Bq={Bq4}: "
                 f"{single:.4f} ms summed; {S} x (kernel 1 + torch.topk): {yard:.4f} ms; "
                 f"peak memory of a call {_mib(peak)}")
    rows["dplr_corpus_score_multi"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                           single_calls_ms=single, yardstick_ms=yard,
                                           peak_mib=peak)
    del parts, args

    # embedding_bag at the lookup path's shapes; library: F.embedding_bag
    # with one slot a bag (every bag of the dplr-fwfm layout holds one)
    cfg = sz.make_config()
    lay, ek = cfg.layout, cfg.embed_dim
    table = torch.randn((padded_rows(lay.total_vocab), ek), generator=gen, device=dev)
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
        slots = ids.numel()
        bnd, by = bound_ms(slots * (ek * 4 + 8) + B * nb * ek * 4, 2 * slots * ek, peaks)
        extra.append(f"embedding_bag {label} {tuple(ids.shape)}: {ms:.4f} ms, plain "
                     f"{plain:.4f} ms, F.embedding_bag {lib:.4f} ms, bound {bnd:.4f} ms ({by})")
        if label == "corpus":
            rows["embedding_bag"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                         library_ms=lib)
        del ids, w, lib_ids, lib_w
    del table

    # fwfm_pairwise; library: one einsum with TF32 off.  The Gram is
    # symmetric, so the function needs its m (m + 1) / 2 distinct dot
    # products (2k flops each) contracted with R_ij + R_ji (2 flops each):
    # m (m + 1) (k + 1) flops an example, half of what the kernel does
    for B, m in sz.pairs:
        V, R = pair_inputs(B, m, k, gen)
        ms = device_ms(lambda: ops.fwfm_pairwise(V, R))
        plain = device_ms(lambda: ref.fwfm_pairwise_ref(V, R), 3, 2)
        lib = device_ms(lambda: torch.einsum("bik,bjk,ij->b", V, V, R))
        bnd, by = bound_ms((B * m * k + m * m + B) * 4, B * m * (m + 1) * (k + 1), peaks)
        extra.append(f"fwfm_pairwise B={B} m={m} k={k}: {ms:.4f} ms, plain {plain:.4f} ms, "
                     f"einsum {lib:.4f} ms, bound {bnd:.4f} ms ({by})")
        if B == max(b for b, _ in sz.pairs):
            rows["fwfm_pairwise"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                         library_ms=lib)
        del V
    rows["flash_attention"] = flash_timing(sz, peaks, gen, extra)
    print("phase timing: " + "; ".join(extra), flush=True)
    return rows


def attention_pairs(S: int, window) -> int:
    """(query, key) pairs causal attention over S positions computes."""
    i = np.arange(S, dtype=np.int64)
    return int(np.minimum(i + 1, S if window is None else window).sum())


def flash_timing(sz, peaks, gen, extra) -> dict:
    """Flash attention in bf16 at the lm phase's shapes (``sz.flash``): the
    global layer's row, with the windowed layer's beside it.  Bound: 4 hd
    flops a (query, key) pair and head at the bf16 tensor-core rate, or
    q, k, v and out moved once.  Library (timed only; the port never calls
    it): ``F.scaled_dot_product_attention(is_causal, enable_gqa)`` on the
    global layer; on the windowed one, which it has no option for, the
    same call with the (S, S) causal-and-window mask, on its
    memory-efficient backend (on the card) and k, v repeated to the query
    heads outside the timed call."""
    out = {}
    for B, S, H, KV, hd, window in sz.flash:
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
        flops = 4 * hd * attention_pairs(S, window) * B * H
        bnd, by = bound_ms(B * S * (2 * H + 2 * KV) * hd * 2, flops, peaks, tensor=True)
        label = "global" if window is None else f"window {window}"
        extra.append(f"flash_attention bf16 B={B} S={S} H={H} KV={KV} hd={hd} {label}: "
                     f"{ms:.4f} ms, plain {plain:.4f} ms, F.scaled_dot_product_attention "
                     f"{lib:.4f} ms, bound {bnd:.4f} ms ({by}, {flops / 1e12:.3f} TFLOP)")
        row = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib)
        if window is None:
            out.update(row)
        else:
            out["windowed"] = row
        del q, k, v
    return out


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
    time to issue one, and the device's busy share while the
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
    bare = (host_issue_ms(dev, lambda: launchers.launch_multi_topk(*margs, K4, 0, 1))
            if dev.type == "cuda" else None)
    bare = "not measured (no card)" if bare is None else f"{bare:.4f} ms"
    parts.append(f"multi S={S} Bq={Bq4} K={K4}, per call: host issue {host:.4f} ms "
                 f"(launcher alone, no wrapper checks: {bare}); " + (
        ", ".join(f"{k} {ms / reps:.4f} ms ({calls / reps:g} launches)"
                  for k, (ms, calls) in sorted(split.items())) if split is not None
        else f"not measured (profiler saw {seen})"))
    del margs

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

    t0 = time.perf_counter()
    built = _build.build_all()
    logs = []
    for src in _build.sources():
        for fn in ptxas_report(_build.build_log(src.stem).read_text()):
            logs.append(f"{fn['kernel']}: {fn['registers']} registers, {fn['spill_stores']} "
                        f"bytes spill stores, {fn['spill_loads']} bytes spill loads"
                        + "".join(f"; {w}" for w in fn["warnings"]))
            if (fn["kernel"].startswith("flash_attention_wgmma")
                    or src.stem == "dplr_corpus_score") and (
                    fn["spill_stores"] or fn["spill_loads"]):
                raise AssertionError(f"{fn['kernel']} spills registers: {logs[-1]}")
    print(f"phase build: {time.perf_counter() - t0:.1f} s ({len(built)} sources compiled); "
          + " | ".join(logs), flush=True)

    errs = kernel_checks(dev, FULL)
    serve = serving_phase(dev, FULL)
    launches = dict(serve.launches)
    tenant_launches = tenants_phase(dev, FULL, serve)
    for g in ops.KERNELS["dplr_corpus_score_multi"]:
        launches[g] = tenant_launches[g]
    for g, count in eval_phase(dev, FULL, serve).items():
        launches[g] = launches.get(g, 0) + count
    launches.update(lm_phase(dev, FULL))
    rows = timing_phase(dev, FULL, peaks)
    profile_phase(dev, FULL, serve.engine, serve.ctxs)
    kernels = []
    for name, cuda_kernels in ops.KERNELS.items():
        source, replaces = KERNEL_ROWS[name]
        row = dict(rows[name])
        row.setdefault("library_ms", None)
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=sum(launches[g] for g in cuda_kernels),
                            cuda_launches={g: launches[g] for g in cuda_kernels},
                            max_abs_err=errs[name], **row))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card, at the full
``dplr-fwfm`` width, and hold every kernel against its plain version.

    python3 chip_smoke.py

Phases, one line each:

1. card: the ``nvidia-smi`` name and power limit; TF32 off.
2. build: compile ``src/repro_torch/kernels/csrc/*.cu`` with nvcc (sm_90a).
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the shapes the serving path gives it, plus ragged and all-dead edges.
4. serve: the full config (82 fields, k = 16, rho = 3, random weights from
   a seed) serving a 1,000,000-item corpus from a 2^20-slot slab: top-K
   and score queries, churn, a model refresh, and Algorithm 1 per call,
   each held against the plain path.  The launches of each CUDA kernel
   are counted over this phase alone.
5. timing: each kernel's median time over CUDA events, its plain
   version's, and the bound (the larger of bytes over the card's memory
   rate and f32 flops over its f32 rate).
6. profile: with torch.profiler, the device time of a top-K call by CUDA
   kernel, and the device's idle share while the serving engine answers
   Bq = 1 queries.

Then a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Any failed check raises, so the ``ok`` line is never printed after
a failure.  Exits non-zero where there is no CUDA card.

Tolerance on the card: ``|got - plain| <= 1e-5 * max(1, |plain|)``.  The
kernels sum in another order than PyTorch's einsum (and use fused
multiply-adds), and full-width scores reach tens, so a bound relative to
the score is the meaningful one.  Top-K ids must equal the plain stable
top-K's, except where the plain scores tie within that tolerance; planted
exact ties must go to the lower slot.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import dplr_fwfm  # noqa: E402
from repro_torch.core import ranking as rk  # noqa: E402
from repro_torch.core.dplr import DPLRParams, dplr_diagonal  # noqa: E402
from repro_torch.data.synthetic_ctr import SyntheticCTR  # noqa: E402
from repro_torch.embedding.bag import (  # noqa: E402
    item_arena_ids,
    lookup_item_embeddings,
    lookup_linear_terms,
)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.models.recsys import fwfm  # noqa: E402
from repro_torch.serving.corpus import masked_slab_scores  # noqa: E402
from repro_torch.serving.engine import CorpusState  # noqa: E402

TOL = 1e-5

FULL = SimpleNamespace(
    n=1 << 20, live=1_000_000, bqs=(1, 16), ks=(1, 16, 1024), rho=3, k=16,
    n3=65_536, m3=38, bq3s=(1, 4), edge_n=1000,
    make_config=dplr_fwfm.make_config, items=1_000_000, capacity=1 << 20,
    queries=20, batch=16, churn=(1000, 1000, 100), percall_n=65_536, topk=16,
)

# NVIDIA data-sheet peaks: (device memory bytes/s, f32 flop/s outside the
# tensor cores), by the card name torch reports.
PEAKS = (
    ("H200", 4.8e12, 67e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),    # SXM
)

KERNEL_ROWS = {
    "dplr_corpus_score": ("src/repro_torch/kernels/csrc/dplr_corpus_score.cu",
                          "src/repro/kernels/dplr_corpus_score.py:196"),
    "dplr_corpus_topk": ("src/repro_torch/kernels/csrc/dplr_corpus_score.cu",
                         "src/repro/kernels/dplr_corpus_score.py:212"),
    "dplr_score_items": ("src/repro_torch/kernels/csrc/dplr_score.cu",
                         "src/repro/kernels/dplr_score.py:75"),
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


def kernel_checks(dev, sz) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {name: 0.0 for name in ops.KERNELS}
    notes = []
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
        for K in sz.ks:
            vals, ids = ops.dplr_corpus_score(*args, topk=K)
            _sync(dev)
            err, diff = check_topk(vals, ids, full, K, f"topk Bq={Bq} K={K}", planted=pairs)
            errs["dplr_corpus_topk"] = max(errs["dplr_corpus_topk"], err)
            notes.append(f"K={K}/Bq={Bq}:{diff} ids differ")
        vals, ids = ops.dplr_corpus_score(*args, topk=16, index_offset=3, index_stride=4)
        _sync(dev)
        err, _ = check_topk(vals, ids, full, 16, f"topk Bq={Bq} offset/stride",
                            offset=3, stride=4, planted=pairs)
        errs["dplr_corpus_topk"] = max(errs["dplr_corpus_topk"], err)
    del Q, full

    # edge: n = 1000 (ragged last tile), one 128-slot tile all dead
    Q, a_I, e, P_C, a_C, valid = corpus_inputs(dev, sz.edge_n, sz.edge_n, 3, sz.rho, sz.k, gen)
    valid[128:256] = False
    args = (Q, a_I, e, P_C, a_C, valid)
    full = ref.dplr_corpus_score_ref(*args)
    errs["dplr_corpus_score"] = max(errs["dplr_corpus_score"], check_close(
        ops.dplr_corpus_score(*args), full, "full edge"))
    vals, ids = ops.dplr_corpus_score(*args, topk=7)
    _sync(dev)
    errs["dplr_corpus_topk"] = max(errs["dplr_corpus_topk"],
                                   check_topk(vals, ids, full, 7, "topk edge")[0])

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
    print(f"phase kernels: all within {TOL:g} x max(1, |s|); max |diff| "
          + ", ".join(f"{k}={v:.3g}" for k, v in errs.items())
          + "; " + ", ".join(notes), flush=True)
    return errs


# -- phase 4: the serving path ------------------------------------------------

def plain_scores(engine, ids):
    """The plain versions of the engine's scoring on its slab: the kernel's
    own form ``a_C + a_I + 0.5 term_e`` and the JAX package's jnp order
    ``bias + lin_C + lin_I + 0.5 (s_C + t_I + term_e)``
    (``masked_slab_scores``), with the summed size of those terms.

    At full width the score is a difference of terms of tens (s_C and t_I
    negative, term_e positive), so any two summation orders part by a few
    roundings of the terms, whatever the score: the size, not |score|,
    scales the tolerance (``check_close(..., size=)``)."""
    rt, c, p = engine.runtime, engine.cache, engine.params
    ctx = torch.as_tensor(ids, device=engine.device)
    P_C, s_C, lin_C = rt.context(p, ctx, torch.ones(ctx.shape, device=engine.device))
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
    V_C, lin_C = fwfm.context_inputs(params, cfg, q["context_ids"], q["context_weights"])
    V_I = lookup_item_embeddings(params["embedding"], lay, q["item_ids"], q["item_weights"])
    lin_I = lookup_linear_terms(params["linear"], lay.subset("item"),
                                item_arena_ids(lay, q["item_ids"]), q["item_weights"])
    p = DPLRParams(params["U"], params["e"])
    cache = rk.dplr_context_cache(p, V_C, nC)
    pw = rk.dplr_score_items(p, cache, V_I, nC)
    d = dplr_diagonal(p)
    pw_size = ref.dplr_score_items_ref(V_I, p.U[:, nC:], p.e.abs(), d[nC:].abs(),
                                       cache.P_C, cache.s_C.abs())
    size = params["bias"].abs() + lin_C.abs()[..., None] + lin_I.abs() + pw_size
    return params["bias"] + lin_C[..., None] + lin_I + pw, size


def serving_phase(dev, sz):
    """Returns the launches of each CUDA kernel, the engine and the query
    contexts."""
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

    launches = {g: ops.LAUNCHES[g] for gs in ops.KERNELS.values() for g in gs}
    if dev.type == "cuda" and not all(launches.values()):
        raise AssertionError(f"a kernel was not launched on the serving path: {launches}")
    print(f"phase serve: {cfg.layout.n_fields} fields k={cfg.embed_dim} rho={cfg.rank}, "
          f"{sz.items} items in a {sz.capacity}-slot slab; host data {host_s:.1f} s, "
          f"slab build {build_s:.2f} s; {len(lat)} top-{K} queries at Bq=1 median "
          f"{np.median(lat):.3f} ms (host clock, synchronized); {diffs} top-K ids "
          f"differ from plain, all within the tie rule; churn +{n_add} -{n_remove} "
          f"~{n_update}, refresh and percall n={sz.percall_n} all agree; "
          f"launches {launches}", flush=True)
    return launches, engine, ctxs


# -- phase 5: timing ----------------------------------------------------------

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


def bound_ms(nbytes: float, flops: float, peaks) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / peaks[0], flops / peaks[1]
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
    for Bq_t, K in [(Bq, None), (1, None), (Bq, 16), (1, 16), (Bq, 1024)]:
        args = (Q, a_I, e, P_C[:Bq_t].contiguous(), a_C[:Bq_t].contiguous(), valid)
        if K is None:
            ms = device_ms(lambda: ops.dplr_corpus_score(*args))
            plain = device_ms(lambda: ref.dplr_corpus_score_ref(*args), 3, 2)
            out_bytes = Bq_t * n * 4
        else:
            ms = device_ms(lambda: ops.dplr_corpus_score(*args, topk=K))
            plain = device_ms(lambda: ref.dplr_corpus_topk_ref(*args[:5], K, args[5]), 3, 2)
            out_bytes = Bq_t * K * 8
        bnd, by = bound_ms(in_bytes + out_bytes, Bq_t * score_flops, peaks)
        name = "dplr_corpus_score" if K is None else "dplr_corpus_topk"
        extra.append(f"{name} n={n} Bq={Bq_t}{'' if K is None else f' K={K}'}: "
                     f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} ms ({by})")
        if Bq_t == Bq and K in (None, 16):
            rows[name] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by)
    del Q

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
    print("phase timing: " + "; ".join(extra), flush=True)
    return rows


def _device_times(prof) -> dict:
    """{kernel name: (device ms, calls)} of the CUDA kernels a profiler saw."""
    out = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", 0) or 0
        if t and str(getattr(evt, "device_type", "")).endswith("CUDA"):
            m = re.search(r"(\w+)\(", evt.key)
            name = m.group(1) if m else evt.key[:60]
            ms, calls = out.get(name, (0.0, 0))
            out[name] = (ms + t / 1e3, calls + evt.count)
    return out


def profile_phase(dev, sz, engine, ctxs) -> None:
    """Where the device time goes: the split of one top-K call between its
    stage-1 and merge kernels, and the device's busy share while the
    serve phase's engine answers Bq = 1 top-K queries back to back (host
    clock around the window).  Reports "not measured" when the profiler sees no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    gen = torch.Generator(device=dev).manual_seed(2)
    Bq, reps = max(sz.bqs), 3
    Q, a_I, e, P_C, a_C, valid = corpus_inputs(dev, sz.n, sz.live, Bq, sz.rho, sz.k, gen)
    with profile(activities=acts):       # a first window, discarded: tracing starts up
        ops.dplr_corpus_score(Q, a_I, e, P_C, a_C, valid, topk=16)
        _sync(dev)
    parts = []
    for K in (16, 1024):
        with profile(activities=acts) as prof:
            for _ in range(reps):
                ops.dplr_corpus_score(Q, a_I, e, P_C, a_C, valid, topk=K)
            _sync(dev)
        split = _device_times(prof)
        t0 = time.perf_counter()           # host time to issue the calls
        for _ in range(reps):
            ops.dplr_corpus_score(Q, a_I, e, P_C, a_C, valid, topk=K)
        host = (time.perf_counter() - t0) * 1e3 / reps
        _sync(dev)
        parts.append(f"topk Bq={Bq} K={K}, per call: host issue {host:.4f} ms; " + (", ".join(
            f"{k} {ms / reps:.4f} ms ({calls // reps} launches)"
            for k, (ms, calls) in sorted(split.items())) or "not measured"))
    del Q

    engine.topk(ctxs[0], sz.topk)
    _sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for ctx in ctxs:
            engine.topk(ctx, sz.topk)
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(ms for ms, _ in _device_times(prof).values())
    share = (f"device busy {busy:.3f} ms of {wall:.3f} ms wall, idle share "
             f"{1 - busy / wall:.3f}" if busy else "device time not measured")
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
    peaks = next(((bw, fl) for key, bw, fl in PEAKS if key in kind), None)
    if peaks is None:
        raise SystemExit(f"chip_smoke: no peak rates known for {kind!r}")
    print(smi)
    print(f"phase card: {kind}; peaks {peaks[0] / 1e12:g} TB/s, {peaks[1] / 1e12:g} "
          f"TFLOP/s f32; TF32 off", flush=True)

    t0 = time.perf_counter()
    built = _build.build_all()
    logs = []
    for src in _build.sources():
        for ln in _build.build_log(src.stem).read_text().splitlines():
            if "registers" in ln or ("spill" in ln and " 0 bytes spill" not in ln):
                logs.append(f"{src.stem}: {ln.strip()}")
    print(f"phase build: {time.perf_counter() - t0:.1f} s ({len(built)} sources compiled); "
          + " | ".join(logs), flush=True)

    errs = kernel_checks(dev, FULL)
    launches, engine, ctxs = serving_phase(dev, FULL)
    rows = timing_phase(dev, FULL, peaks)
    profile_phase(dev, FULL, engine, ctxs)
    kernels = []
    for name, cuda_kernels in ops.KERNELS.items():
        source, replaces = KERNEL_ROWS[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=sum(launches[g] for g in cuda_kernels),
                            cuda_launches={g: launches[g] for g in cuda_kernels},
                            max_abs_err=errs[name], **rows[name], library_ms=None))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

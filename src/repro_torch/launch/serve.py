"""Serving driver of the port: a ranking service answering "score the
corpus (or these N candidates) for this context" queries.

    PYTHONPATH=src python -m repro_torch.launch.serve --config full \
        --engine corpus|percall --items N --queries Q [--topk K] [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.serve --tenant-demo --tenants N \
        --items N --queries Q [--fe-batch B --max-wait-ms W --inflight D --capacity C]
    PYTHONPATH=src python -m repro_torch.launch.serve [--ckpt-dir D] \
        [--refresh-every N] [--refresh-demo]

``--engine corpus`` (the default) serves through ``CorpusRankingEngine``:
the item side is precomputed once into a capacity-padded slab, and each
query costs its context cache plus O(rho k) per item, through the
``dplr_corpus_score`` kernel (``--topk K``: only the (1, K) winners leave
it).  ``--engine percall`` is Algorithm 1 per query (``fwfm.rank_items``
through the ``dplr_score_items`` kernel), the baseline that gathers and
projects every candidate on every query.  Weights are random, from
``--seed``; items and contexts come from ``SyntheticCTR``.  Prints the
same latency line as ``repro.launch.serve``; the first two queries are
dropped as warm-up.

``--ckpt-dir`` serves the params of the newest checkpoint there (one that
``repro_torch.launch.train`` or the JAX trainer wrote) and polls the
directory every ``--refresh-every`` queries through
``CorpusState.maybe_refresh``.  ``--refresh-demo`` (in a temporary
directory unless ``--ckpt-dir`` is given) writes a checkpoint with the
bias raised by 1 halfway through the queries, and asserts that the engine
swapped it in and that each query launched the same kernels, as many
times, after the swap as before it: the port traces nothing, so this
takes the place of ``repro.launch.serve``'s retrace count.  It prints "refresh
round-trip OK".

``--tenant-demo`` serves ``--tenants`` corpora (at least 2) behind one
shared ``ScorerRuntime`` through the tenant-routed ``QueryFrontend``:
mixed-tenant traffic with churn bursts on tenant t0, every reply checked
live and against its tenant's own state (and one tenant against a
dedicated engine), then a 5x burst that admission control sheds with
``Overloaded``.  Prints the summary lines of ``repro.launch.serve``'s
tenant demo, without its trace counts (nothing here is traced).
"""
from __future__ import annotations

import argparse
import collections
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import dplr_fwfm
from repro_torch.data.synthetic_ctr import SyntheticCTR
from repro_torch.checkpoint import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.recsys import fwfm
from repro_torch.serving.corpus import next_pow2
from repro_torch.serving.engine import CorpusRankingEngine, CorpusState
from repro_torch.serving.errors import Overloaded, RefreshFailed
from repro_torch.serving.frontend import QueryFrontend
from repro_torch.serving.runtime import ScorerRuntime


def _report(tag: str, lat: np.ndarray, queries: int, items: int) -> None:
    if lat.size == 0:   # fewer queries than the 2 warm-up drops
        print(f"{queries} queries x {items} items ({tag}): "
              f"too few queries for latency percentiles")
        return
    print(f"{queries} queries x {items} items ({tag}): "
          f"avg {lat.mean():.2f} ms  P95 {np.percentile(lat, 95):.2f} ms  "
          f"P99 {np.percentile(lat, 99):.2f} ms")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _tenant_demo(args, cfg, params, data, dev) -> None:
    """``--tenants`` corpora on one ScorerRuntime behind the frontend;
    asserts live, per-tenant replies equal to the tenant's own state,
    a shared-runtime tenant equal to a dedicated engine, and fast
    admission shedding."""
    rng = np.random.default_rng(args.seed)
    T = max(args.tenants, 2)
    runtime = ScorerRuntime(cfg, device=dev)
    capacity = args.capacity or next_pow2(2 * args.items)
    names = [f"t{i}" for i in range(T)]
    corpora = {n: data.ranking_query(args.items, 1000 + i) for i, n in enumerate(names)}
    states = {}
    for name in names:
        c = corpora[name]
        states[name] = CorpusState(None, c["item_ids"][0], c["item_weights"][0],
                                   capacity=capacity, runtime=runtime)
        states[name].refresh(params, step=0)
    max_k = max(args.topk or 10, 1)
    fe = QueryFrontend(states, max_batch=args.fe_batch, max_k=max_k,
                       max_wait=args.max_wait_ms * 1e-3, inflight=args.inflight)
    warm_dispatches = fe.warmup(data.context_query(0)["context_ids"], tenant="t0")

    n = args.queries
    ctxs = [data.context_query(s)["context_ids"] for s in range(n)]
    ks = rng.integers(1, max_k + 1, n)
    lanes = [names[int(rng.integers(T))] for _ in range(n)]
    churn_at = set(range(10, n, 20))           # churn bursts, tenant t0 only
    pend = []
    t0 = time.perf_counter()
    last_churn = -1
    for s in range(n):
        if s in churn_at:
            upd = data.ranking_query(2, 50_000 + s)
            fe.update_items(rng.choice(states["t0"].valid_slots, 2, replace=False),
                            upd["item_ids"][0], upd["item_weights"][0], tenant="t0")
            last_churn = s
        pend.append(fe.submit(ctxs[s], k=int(ks[s]), tenant=lanes[s]))
    fe.drain()
    wall = time.perf_counter() - t0
    # every reply live at delivery; equal to a lone call on its tenant's own
    # state for requests scored against the final corpus (the other tenants
    # never churned, t0 after its last burst).  A lone call has Bq = 1 where
    # the frontend batched: compare as the parity tests do.
    checked = 0
    for s, p in enumerate(pend):
        sc, sl = p.result()
        assert states[lanes[s]].is_live(sl).all(), f"tenant {lanes[s]} reply: a dead slot"
        if lanes[s] != "t0" or s > last_churn:
            wv, wi = states[lanes[s]].topk(np.asarray(ctxs[s]).reshape(1, -1), int(ks[s]))
            wv, wi = wv[0].cpu().numpy(), wi[0].cpu().numpy()
            assert np.allclose(sc, wv, atol=1e-5, rtol=1e-5), "tenant reply != lone call"
            full = states[lanes[s]].score(np.asarray(ctxs[s]).reshape(1, -1))[0].cpu().numpy()
            assert np.allclose(full[sl], wv, atol=1e-5, rtol=1e-5), \
                "tenant reply ids != lone call, beyond ties"
            checked += 1
    # a tenant on the shared runtime against a dedicated engine: same shapes,
    # so bitwise equal
    c = corpora["t1"]
    dedicated = CorpusRankingEngine(cfg, c["item_ids"][0], c["item_weights"][0],
                                    capacity=capacity, device=dev)
    dedicated.refresh(params, step=0)
    for s in range(0, n, max(n // 8, 1)):
        ctx = np.asarray(ctxs[s]).reshape(1, -1)
        got, want = states["t1"].topk(ctx, max_k), dedicated.topk(ctx, max_k)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), \
            "shared-runtime tenant != dedicated engine"

    # admission control under a 5x burst: bounded queue, fast sheds, and
    # every accepted request still answered
    fe.auto_pump = False
    fe.admit_depth = max(args.fe_batch, 4)
    sheds = accepted = 0
    for s in range(5 * fe.admit_depth):
        try:
            fe.submit(ctxs[s % n], k=int(ks[s % n]), tenant="t1")
            accepted += 1
        except Overloaded:
            sheds += 1
    fe.drain()
    assert accepted == fe.admit_depth and sheds == 4 * fe.admit_depth, \
        f"admission control off: {accepted} accepted, {sheds} shed"
    assert fe.stats["expired"] == 0
    fe.close()

    lat = np.asarray([(p.done_time - p.submit_time) * 1e3 for p in pend])
    per_tenant = {t: fe.lane_stats(t)["completed"] for t in names}
    print(f"tenant demo: {T} tenants x {args.items} items (capacity {capacity}) on ONE "
          f"ScorerRuntime ({dev.type}); {n} mixed requests in {wall * 1e3:.0f} ms, "
          f"{len(churn_at)} t0 churn bursts")
    print(f"  warmup    : {warm_dispatches} dispatch on t0 alone, at the largest bucket")
    print(f"  replies   : p50 {np.percentile(lat, 50):.2f}  p95 {np.percentile(lat, 95):.2f} "
          f"ms; {checked} checked (incl. vs a dedicated engine); per-tenant {per_tenant}")
    print(f"  admission : 5x burst -> {accepted} accepted / {sheds} shed fast "
          f"(Overloaded), 0 deadline expiries")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--engine", default="corpus", choices=["corpus", "percall"],
                    help="corpus = precomputed item slab; percall = Algorithm 1 "
                         "per query")
    ap.add_argument("--items", type=int, default=512)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--topk", type=int, default=0,
                    help="corpus engine: fused top-K, only (1, K) leaves the scorer")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tenant-demo", action="store_true",
                    help="serve --tenants corpora on one shared ScorerRuntime through "
                         "the tenant-routed frontend")
    ap.add_argument("--tenants", type=int, default=4,
                    help="tenant count for --tenant-demo (min 2)")
    ap.add_argument("--capacity", type=int, default=0,
                    help="--tenant-demo slab capacity (power of two; 0: 2x items, "
                         "rounded up)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="frontend: max ms a queued request waits before a partial "
                         "batch dispatches")
    ap.add_argument("--fe-batch", type=int, default=16,
                    help="frontend max micro-batch size (power of two)")
    ap.add_argument("--inflight", type=int, default=2,
                    help="frontend in-flight dispatch window depth")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of the newest checkpoint there, and poll it")
    ap.add_argument("--refresh-every", type=int, default=25,
                    help="poll --ckpt-dir for a newer step every N queries")
    ap.add_argument("--refresh-demo", action="store_true",
                    help="write a checkpoint with a shifted bias mid-stream and check "
                         "that the corpus engine swaps it in")
    args = ap.parse_args(argv)
    if (args.topk or args.tenant_demo or args.refresh_demo) and args.engine != "corpus":
        ap.error("--topk/--tenant-demo/--refresh-demo require --engine corpus")

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = dplr_fwfm.make_smoke() if args.config == "smoke" else dplr_fwfm.make_config()
    params = fwfm.init(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    mgr = None
    if args.ckpt_dir or args.refresh_demo:
        mgr = CheckpointManager(args.ckpt_dir or tempfile.mkdtemp(prefix="serve_refresh_demo_"))
        restored, step = mgr.restore({"params": params}, device=dev)
        if restored is not None:
            params = restored["params"]
            print(f"serving checkpoint step {step}")
    data = SyntheticCTR(cfg.layout, embed_dim=4, seed=args.seed)
    if args.tenant_demo:
        return _tenant_demo(args, cfg, params, data, dev)

    lat = []
    if args.engine == "corpus":
        corpus = data.ranking_query(args.items, 0)
        engine = CorpusRankingEngine(cfg, corpus["item_ids"][0], corpus["item_weights"][0],
                                     capacity=next_pow2(args.items), device=dev)
        engine.refresh(params, step=mgr.latest_step() if mgr else None)
        refreshes, demo_pending, per_query = 0, False, []
        for s in range(args.queries):
            if args.refresh_demo and s == args.queries // 2:
                bumped = dict(params, bias=params["bias"] + 1.0)
                mgr.save({"params": bumped}, step=(engine.model_step or 0) + 1, blocking=True)
                demo_pending = True          # poll now, whatever the cadence
            if mgr is not None and (demo_pending or (s and s % args.refresh_every == 0)):
                try:
                    swapped = engine.maybe_refresh(mgr, {"params": params},
                                                   select=lambda t: t["params"])
                except RefreshFailed as e:
                    # a bad model push: the last-good snapshot keeps serving
                    swapped = False
                    print(f"query {s}: refresh REJECTED ({e}); serving step "
                          f"{engine.model_step}")
                if swapped:
                    refreshes += 1
                    demo_pending = False
                    print(f"query {s}: refreshed to checkpoint step {engine.model_step} "
                          f"(corpus cache rebuilt)")
            before = collections.Counter(ops.LAUNCHES)
            q = data.context_query(s)
            ctx = torch.as_tensor(q["context_ids"], device=dev)
            ctx_w = torch.as_tensor(q["context_weights"], device=dev)
            t0 = time.perf_counter()
            if args.topk:
                out = engine.topk(ctx, args.topk, ctx_w)
            else:
                out = engine.score(ctx, ctx_w)
            _sync(dev)
            lat.append((time.perf_counter() - t0) * 1e3)
            per_query.append((refreshes, dict(ops.LAUNCHES - before)))
            if s == 0:
                top = (out[1][0][:3] if args.topk
                       else torch.argsort(out[0], descending=True, stable=True)[:3])
                print(f"query 0: top-3 of {args.items} candidates -> "
                      f"{top.cpu().numpy()}")
        tag = f"corpus{f', top{args.topk}' if args.topk else ''}, {dev.type}"
        if args.refresh_demo:
            assert refreshes >= 1, "refresh demo never saw the new checkpoint"
            seen = {str(launched) for r, launched in per_query if r == 0}
            after = {str(launched) for r, launched in per_query if r > 0}
            assert len(seen) == 1 and after == seen, \
                f"kernel launches per query changed across the refresh: {seen} -> {after}"
            print(f"refresh round-trip OK: {refreshes} refresh(es), kernel launches per "
                  f"query unchanged across the refresh ({seen.pop()}), no restart")
    else:
        for s in range(args.queries):
            q = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.ranking_query(args.items, s).items()}
            t0 = time.perf_counter()
            scores = fwfm.rank_items(params, cfg, q)
            _sync(dev)
            lat.append((time.perf_counter() - t0) * 1e3)
            if s == 0:
                top = torch.argsort(scores[0], descending=True, stable=True)[:3]
                print(f"query 0: top-3 of {args.items} candidates -> {top.cpu().numpy()}")
        tag = f"percall, {dev.type}"
    _report(tag, np.asarray(lat[2:]), args.queries, args.items)


if __name__ == "__main__":
    main()

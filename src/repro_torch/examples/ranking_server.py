"""Ranking server: the paper's deployment shape, a stream of ad-ranking
queries, each scoring N candidates for one context.  Port of the JAX
package's ``examples/ranking_server.py`` at its deployed geometry
(``uniform_layout(25, 38, 1000)``, k = 16, rho = 3; random weights from
seed 0), with the same seven paths:

  1. per-call Algorithm 1 (``fwfm.rank_items``): the context cache once a
     query, every candidate gathered and projected again (kernel 3);
  2. the corpus engine (``repro_torch.serving.CorpusRankingEngine``): the
     item side precomputed once into a capacity-padded slab, a query its
     context cache plus O(rho k) an item (kernel 1; ``--topk K``, kernel 2);
  3. ``--use-pallas``: accepted for the reference's command line.  It has
     no separate meaning here: on the card the engine always scores
     through the hand-written kernels (on the CPU through their plain
     versions); the line keeps the reference's tag;
  4. live catalog churn on the mutable slab (kernel 2 top-K after each
     remove + add round);
  5. online micro-batching (``QueryFrontend``) with mixed K (kernel 2);
  6. three tenants on one ``ScorerRuntime`` behind the tenant-routed
     frontend, tenant 0 churned mid-stream;
  7. that frontend behind the RPC server on loopback.

Paths 6 and 7 pack tenants (``QueryFrontend(pack=True)``): the ready
tenants of a round are served by one multi-tenant launch (kernel 4), a
lone tenant's micro-batch by kernel 2.  The reference's frontends do not
pack; a packed reply is bitwise the unpacked one, so this differs from
the reference in the kernel that serves a round only.

Two flags the reference lacks size the host's work: ``--percall-queries``
(path 1's queries, default ``--queries``: at a million items each draws
63 M zipf ids) and ``--tenant-items`` (the corpora of paths 6-7, default
``--items``).

Where the reference asserts that nothing retraced, the port asserts what
``launch.serve --refresh-demo`` asserts in its place: each query (each
micro-batch of the frontends) launches the same kernels, the same number
of times, after the churn as before it.  The field lookups are kernel 5.

Shutdown: a SIGTERM (or SIGINT) closes every live frontend, in-flight
batches resolve to real results, queued requests fail with a typed
``Unservable``, and the process exits 128 + the signal after printing the
frontends' counts (submitted = completed + failed + expired + shed:
nothing dropped).

    PYTHONPATH=src python -m repro_torch.examples.ranking_server [--items 512] \\
        [--queries 50] [--topk 10] [--use-pallas] [--churn 20] [--percall-queries N] \\
        [--tenant-items N] [--device cpu]
"""
from __future__ import annotations

import argparse
import collections
import signal
import time

import numpy as np
import torch

from repro_torch.core.fields import uniform_layout
from repro_torch.data.synthetic_ctr import SyntheticCTR
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.serve import _sync
from repro_torch.models.recsys import fwfm
from repro_torch.serving import (
    CorpusRankingEngine,
    CorpusState,
    QueryFrontend,
    RpcClient,
    ScorerRuntime,
    serve_in_thread,
)
from repro_torch.serving.corpus import next_pow2


def make_config():
    """The paper's deployed geometry: 63 fields, 38 item-side."""
    return fwfm.FwFMConfig(layout=uniform_layout(25, 38, 1000), embed_dim=16,
                           interaction="dplr", rank=3)


def _percentiles(lat):
    lat = np.asarray(lat[2:])   # drop warm-up
    return lat.mean(), np.percentile(lat, 95)


# frontends registered for graceful shutdown: the SIGTERM path answers
# every accepted request (in-flight -> result, queued -> typed error)
# before the process exits
_live_frontends = []


def _counts() -> dict:
    keys = ("submitted", "completed", "failed", "expired", "shed")
    return {k: sum(fe.stats[k] for fe in _live_frontends) for k in keys}


def _graceful_exit(signum, frame):
    for fe in _live_frontends:
        try:
            fe.close()
        except Exception:  # noqa: BLE001 - close the rest whatever one raises
            pass
    c = _counts()
    print(f"signal {signum}: frontends closed - in-flight resolved, queued failed typed, "
          f"nothing dropped (submitted {c['submitted']} = completed {c['completed']} + "
          f"failed {c['failed']} + expired {c['expired']} + shed {c['shed']})", flush=True)
    raise SystemExit(128 + signum)


class _Launches:
    """Kernel launches per unit of work (a query, a micro-batch): the
    port's counterpart of the reference's trace counts."""

    def __init__(self):
        self.per_unit = []

    def __enter__(self):
        self._before = collections.Counter(ops.LAUNCHES)
        return self

    def __exit__(self, *exc):
        self.per_unit.append(dict(collections.Counter(ops.LAUNCHES) - self._before))

    def same(self, what: str) -> dict:
        """Asserts every unit launched the same kernels as many times;
        returns that set."""
        seen = {tuple(sorted(u.items())) for u in self.per_unit}
        assert len(seen) <= 1, f"{what}: kernel launches per unit changed: {seen}"
        return dict(seen.pop()) if seen else {}


def _per_micro_batch(dev, before: collections.Counter, fe, stats0: dict, what: str) -> dict:
    """The launches since ``before``; on the card, asserts one top-K launch
    a micro-batch ``fe`` dispatched since its ``stats0``: a single tenant's
    stage 1 and merge, or for a fused group the multi-tenant pair, and no
    other top-K launch (a churn write launches lookups, never a scorer)."""
    launched = dict(collections.Counter(ops.LAUNCHES) - before)
    d = {k: fe.stats[k] - stats0[k] for k in ("dispatches", "fused_dispatches",
                                                "fused_segments")}
    single, fused = d["dispatches"] - d["fused_segments"], d["fused_dispatches"]
    want = {"corpus_topk_chunks": single, "topk_merge": single,
            "corpus_multi_topk_chunks": fused, "multi_topk_merge": fused}
    if dev.type == "cuda":
        got = {k: launched.get(k, 0) for k in want}
        assert got == want, f"{what}: top-K launches {got}, micro-batches {want}"
    return launched


def run(args, params=None) -> dict:
    """The seven paths; returns what they served and launched: path 1's
    first query and scores (``percall``), path 2's corpus, capacity, first
    context and its full or top-K scores (``corpus``), paths 6's and 7's
    corpora and replies (``tenants``: ``{"multi_tenant" | "rpc":
    {"corpora": {tenant: ranking_query}, "replies": [(tenant, context_ids,
    scores, slots)], "churned": tenants whose slab changed while served}}``),
    each path's kernel launches (``launches``), the frontends' counts
    (``counts``).  ``params``: the weights (default ``fwfm.init`` from seed
    0)."""
    dev = resolve_device(args.device)
    cfg = make_config()
    if params is None:
        params = fwfm.init(torch.Generator(device=dev).manual_seed(0), cfg)
    data = SyntheticCTR(cfg.layout, embed_dim=8, seed=0)
    percall_queries = args.queries if args.percall_queries is None else args.percall_queries
    tenant_items = args.items if args.tenant_items is None else args.tenant_items
    out = {"launches": {}, "tenants": {}}

    def tensors(q):
        return {k: torch.as_tensor(v, device=dev) for k, v in q.items()}

    # -- path 1: per-call Algorithm 1 (the uncached baseline) ----------------
    lat, units = [], _Launches()
    corpus = data.ranking_query(args.items, 0)      # path 1's first query, path 2's corpus
    for s in range(percall_queries):
        q = tensors(corpus if s == 0 else data.ranking_query(args.items, s))
        with units, torch.no_grad():
            t0 = time.perf_counter()
            scores = fwfm.rank_items(params, cfg, q)
            _sync(dev)
            lat.append((time.perf_counter() - t0) * 1e3)
        if s == 0:
            out["percall"] = {"query": corpus, "scores": scores.cpu().numpy()}
    out["launches"]["percall"] = units.same("per-call Alg. 1")
    avg, p95 = _percentiles(lat)
    print(f"per-call Alg. 1 : avg {avg:8.2f} ms   P95 {p95:8.2f} ms", flush=True)

    # -- paths 2/3: corpus-precomputed engine (mutable slab) -----------------
    # capacity == next_pow2(items): paths 2/3 score a (near-)full slab so
    # their latency is comparable to path 1; the churn phase frees its own
    # headroom by removing before adding
    engine = CorpusRankingEngine(cfg, corpus["item_ids"][0], corpus["item_weights"][0],
                                 capacity=next_pow2(args.items), device=dev)
    engine.refresh(params, step=0)
    lat, units = [], _Launches()
    for s in range(args.queries):
        qn = tensors(data.context_query(s))
        with units:
            t0 = time.perf_counter()
            if args.topk:
                got = engine.topk(qn["context_ids"], args.topk, qn["context_weights"])
            else:
                got = engine.score(qn["context_ids"], qn["context_weights"])
            _sync(dev)
            lat.append((time.perf_counter() - t0) * 1e3)
        if s == 0:
            out["corpus"] = {"items": corpus, "capacity": engine.capacity,
                             "context": data.context_query(0),
                             "result": tuple(t.cpu().numpy() for t in got) if args.topk
                             else got.cpu().numpy()}
    out["launches"]["corpus"] = units.same("corpus engine")
    avg, p95 = _percentiles(lat)
    tag = "corpus+pallas " if args.use_pallas else "corpus engine "
    note = ("  (the engine always scores through the kernels on the card, through their "
            "plain versions on the CPU)" if args.use_pallas else "")
    print(f"{tag}: avg {avg:8.2f} ms   P95 {p95:8.2f} ms{note}", flush=True)

    # -- path 4: live catalog churn on the mutable slab ----------------------
    if args.churn:
        rng = np.random.default_rng(0)
        delta = max(1, args.items // 64)
        lat_mut, lat_q, units = [], [], _Launches()
        qn = tensors(data.context_query(1))
        ctx, ctx_w = qn["context_ids"], qn["context_weights"]
        with units:                       # before any churn
            engine.topk(ctx, args.topk or 10, ctx_w)
            _sync(dev)
        for s in range(args.churn):
            # one churn round: delta ads leave, delta new ads arrive
            victims = rng.choice(engine.valid_slots, delta, replace=False)
            fresh = data.ranking_query(delta, 500 + s)
            t0 = time.perf_counter()
            engine.remove_items(victims)
            engine.add_items(fresh["item_ids"][0], fresh["item_weights"][0])
            _sync(dev)
            lat_mut.append((time.perf_counter() - t0) * 1e3)
            with units:
                t0 = time.perf_counter()
                vals, idx = engine.topk(ctx, args.topk or 10, ctx_w)
                _sync(dev)
                lat_q.append((time.perf_counter() - t0) * 1e3)
            # checked BEFORE the next round mutates the mask: the winners
            # must be live at the moment they were returned
            assert engine.is_live(idx.cpu().numpy()).all()
        out["launches"]["churn"] = units.same("catalog churn")
        print(f"catalog churn  : avg {np.mean(lat_mut):8.2f} ms per {delta}-item remove+add "
              f"round, scoring avg {np.mean(lat_q):8.2f} ms, the same kernel launches a query "
              f"over {args.churn} rounds as before them", flush=True)

    # -- path 5: online micro-batching through the query frontend ------------
    max_k = args.topk or 10
    fe = QueryFrontend(engine, max_batch=8, max_k=max_k, max_wait=1e-3)
    _live_frontends.append(fe)
    fe.warmup(data.context_query(0)["context_ids"])
    rng = np.random.default_rng(1)
    pend = []
    before, stats0 = collections.Counter(ops.LAUNCHES), dict(fe.stats)
    t0 = time.perf_counter()
    for s in range(args.queries):
        # one request at a time, each with its own K: the frontend coalesces
        pend.append(fe.submit(data.context_query(1000 + s)["context_ids"],
                              k=int(rng.integers(1, max_k + 1))))
    fe.drain()
    wall = (time.perf_counter() - t0) * 1e3
    out["launches"]["frontend"] = _per_micro_batch(dev, before, fe, stats0, "frontend")
    lat = [(p.done_time - p.submit_time) * 1e3 for p in pend]
    assert all(engine.is_live(p.result()[1]).all() for p in pend)
    print(f"frontend       : avg {np.mean(lat):8.2f} ms   P95 {np.percentile(lat, 95):8.2f} ms"
          f"   ({args.queries} mixed-K requests in {fe.stats['dispatches'] - stats0['dispatches']} "
          f"micro-batches, occupancy {fe.occupancy:.2f}, {wall:.1f} ms wall, one top-K "
          f"launch each)", flush=True)

    # -- path 6: multi-tenant corpora on one shared ScorerRuntime ------------
    runtime = ScorerRuntime(cfg, device=dev)
    states, corpora = {}, {}
    for i in range(3):
        c = corpora[f"t{i}"] = data.ranking_query(tenant_items, 2000 + i)
        states[f"t{i}"] = CorpusState(None, c["item_ids"][0], c["item_weights"][0],
                                      capacity=next_pow2(tenant_items), runtime=runtime)
        states[f"t{i}"].refresh(params, step=0)
    mt = QueryFrontend(states, max_batch=8, max_k=max_k, max_wait=1e-3, pack=True)
    _live_frontends.append(mt)
    mt.warmup(data.context_query(0)["context_ids"], tenant="t0")
    mt.warmup_packed(data.context_query(0)["context_ids"], tenant="t0")
    pend, ctxs = [], []
    before, stats0 = collections.Counter(ops.LAUNCHES), dict(mt.stats)
    t0 = time.perf_counter()
    for s in range(args.queries):
        ctxs.append(data.context_query(3000 + s)["context_ids"])
        pend.append(mt.submit(ctxs[-1], k=int(rng.integers(1, max_k + 1)),
                              tenant=f"t{s % 3}"))
        if s % 16 == 8:                   # churn tenant 0 mid-stream: the
            upd = data.ranking_query(2, 4000 + s)       # other tenants'
            mt.update_items(                             # reads stay put
                rng.choice(states["t0"].valid_slots, 2, replace=False),
                upd["item_ids"][0], upd["item_weights"][0], tenant="t0")
    mt.drain()
    wall = (time.perf_counter() - t0) * 1e3
    out["launches"]["multi_tenant"] = _per_micro_batch(dev, before, mt, stats0, "multi-tenant")
    fused = mt.stats["fused_dispatches"] - stats0["fused_dispatches"]
    dispatches = mt.stats["dispatches"] - stats0["dispatches"]
    lat = [(p.done_time - p.submit_time) * 1e3 for p in pend]
    assert all(states[p.tenant].is_live(p.result()[1]).all() for p in pend)
    out["tenants"]["multi_tenant"] = {
        "corpora": corpora, "churned": ("t0",),
        "replies": [(p.tenant, c, *p.result()) for p, c in zip(pend, ctxs)]}
    print(f"multi-tenant   : avg {np.mean(lat):8.2f} ms   P95 {np.percentile(lat, 95):8.2f} ms"
          f"   (3 tenants on ONE runtime, {dispatches} micro-batches, {fused} fused "
          f"launches, one top-K launch each, {wall:.1f} ms wall, t0 churned mid-stream)",
          flush=True)

    # -- path 7: the tenant frontend behind the RPC server (real socket) ----
    rstates, corpora, replies = {}, {}, []
    for i in range(2):
        c = corpora[f"t{i}"] = data.ranking_query(tenant_items, 5000 + i)
        rstates[f"t{i}"] = CorpusState(None, c["item_ids"][0], c["item_weights"][0],
                                       capacity=next_pow2(tenant_items), runtime=runtime)
        rstates[f"t{i}"].refresh(params, step=0)
    # auto_pump off: the server's event loop owns pump and resolve
    rfe = QueryFrontend(rstates, max_batch=8, max_k=max_k, max_wait=1e-3, auto_pump=False,
                        pack=True)
    _live_frontends.append(rfe)
    rfe.warmup(data.context_query(0)["context_ids"], tenant="t0")
    rfe.warmup_packed(data.context_query(0)["context_ids"], tenant="t0")
    server = serve_in_thread(rfe)
    pend, lat = [], []
    before, stats0 = collections.Counter(ops.LAUNCHES), dict(rfe.stats)
    t0 = time.perf_counter()
    try:
        with RpcClient("127.0.0.1", server.port) as cli:
            for s in range(args.queries):     # pipelined in windows of 8
                lane = f"t{s % 2}"
                ctx = data.context_query(6000 + s)["context_ids"]
                pend.append((cli.send_rank(ctx, k=int(rng.integers(1, max_k + 1)), tenant=lane),
                             lane, ctx, time.perf_counter()))
                if len(pend) == 8 or s == args.queries - 1:
                    for rid, lane, ctx, ts in pend:
                        reply = cli.recv_for(rid)
                        reply.raise_for_status()
                        assert rstates[lane].is_live(reply.slots).all()
                        lat.append((time.perf_counter() - ts) * 1e3)
                        replies.append((lane, ctx, reply.scores, reply.slots))
                    pend = []
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        server.stop()                         # graceful drain + close
    out["launches"]["rpc"] = _per_micro_batch(dev, before, rfe, stats0, "rpc")
    out["tenants"]["rpc"] = {"corpora": corpora, "churned": (), "replies": replies}
    fused = rfe.stats["fused_dispatches"] - stats0["fused_dispatches"]
    print(f"rpc            : avg {np.mean(lat):8.2f} ms   P95 {np.percentile(lat, 95):8.2f} ms"
          f"   ({args.queries} pipelined requests over 127.0.0.1:{server.port}, "
          f"{server.stats['replies']} ok / {server.stats['errors']} typed errors, "
          f"{fused} fused launches, {wall:.1f} ms wall)", flush=True)

    # graceful shutdown (the same path the SIGTERM handler takes)
    for f in _live_frontends:
        f.close()
    out["counts"] = _counts()
    c = out["counts"]
    assert c["submitted"] == c["completed"] + c["failed"] + c["expired"] + c["shed"]
    _live_frontends.clear()
    print(f"shutdown       : frontends closed (submitted {c['submitted']}, completed "
          f"{c['completed']}, nothing dropped)", flush=True)
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--items", type=int, default=512)
    ap.add_argument("--queries", type=int, default=50)
    ap.add_argument("--topk", type=int, default=0)
    ap.add_argument("--use-pallas", action="store_true",
                    help="accepted for the reference's command line; no separate meaning: "
                         "on the card the corpus engine always scores through the "
                         "hand-written kernels")
    ap.add_argument("--churn", type=int, default=20,
                    help="churn rounds in the mutable-corpus phase (0 disables)")
    ap.add_argument("--percall-queries", type=int, default=None,
                    help="path 1's queries (default --queries); each draws a query of "
                         "--items candidates on the host")
    ap.add_argument("--tenant-items", type=int, default=None,
                    help="the items of each corpus of paths 6-7 (default --items)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None, params=None) -> dict:
    """Runs the paths (``run``) with the SIGTERM/SIGINT handler installed
    (the previous handlers restored after)."""
    args = parser().parse_args(argv)
    previous = {sig: signal.signal(sig, _graceful_exit)
                for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        if resolve_device(args.device).type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        return run(args, params)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)


if __name__ == "__main__":
    main()

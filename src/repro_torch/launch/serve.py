"""Serving driver of the port: a ranking service answering "score the
corpus (or these N candidates) for this context" queries.

    PYTHONPATH=src python -m repro_torch.launch.serve --config full \
        --engine corpus|percall --items N --queries Q [--topk K] [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch wide-deep|autoint \
        [--engine percall] --items N --queries Q
    PYTHONPATH=src python -m repro_torch.launch.serve --tenant-demo --tenants N \
        --items N --queries Q [--fe-batch B --max-wait-ms W --inflight D --capacity C]
    PYTHONPATH=src python -m repro_torch.launch.serve [--ckpt-dir D] \
        [--refresh-every N] [--refresh-demo]
    PYTHONPATH=src python -m repro_torch.launch.serve --frontend [--arrival-rate R]
    PYTHONPATH=src python -m repro_torch.launch.serve --churn-demo [--churn-ops N]
    PYTHONPATH=src python -m repro_torch.launch.serve --chaos-demo
    PYTHONPATH=src python -m repro_torch.launch.serve --rpc [--port P] [--tenants N]
    PYTHONPATH=src python -m repro_torch.launch.serve --config full --bf16 [any of the above]
    PYTHONPATH=src python -m repro_torch.launch.serve --mesh host [any corpus loop]
    PYTHONPATH=src python -m repro_torch.launch.serve --mp --items N

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

``--frontend`` replays a Poisson arrival trace (``--arrival-rate``, 0:
about twice the synchronous per-query capacity) of single requests with
mixed K through ``QueryFrontend`` and through synchronous per-query
calls, with an update burst every 25 requests, and prints p50/p95/p99
latency and QPS for both.  ``--churn-demo`` interleaves ``--churn-ops``
add/remove/update/score operations on the live engine.
``--chaos-demo`` scripts faults through the self-healing frontend: a
transient dispatch fault retried, an outage tripping the breaker, a
corrupt checkpoint push rejected while the last-good model serves, a
failed churn write, a stalled pump restarted by its watchdog, a kernel
fault retried and then failing typed (the port has no fallback
scorer), and a seeded storm in which every request resolves.  ``--rpc``
serves ``--tenants`` corpora (packed into one launch a round) over the
binary wire protocol on a loopback socket (``--port``, 0: ephemeral) and
replays a pipelined mixed-tenant client trace.

``--bf16`` serves bf16 tables, as ``repro.launch.serve --bf16`` does: the
float32 leaves of the params (random, or restored from a checkpoint) are
cast to bf16 and ``cfg`` is left as it is, so context weights stay
float32 and are cast to the table's type at each lookup.  Every loop and
engine above runs so: the field lookups are the bf16 embedding-bag
kernel, the slab is bf16 and its top-K and scores come from the bf16
corpus kernels (float32 scores), ``--engine percall`` runs the bf16 item
kernel.  Checkpoints stay float32 on disk (npz has no bf16): a save casts
bf16 leaves to float32, and ``maybe_refresh`` casts a restored step back to
bf16 (``to_serving_dtype``, ``to_checkpoint_dtype``).

``--mesh host`` shards the corpus slab over a one-process mesh's model
axis (``launch.mesh.make_host_mesh``, ``serving.sharded``): D shards, D
the count of visible devices of ``--device``'s type (1 on the CPU and on
a one-card machine), one shard a device.  Every corpus loop composes
with it (the main loop, ``--refresh-demo``, ``--frontend``,
``--churn-demo``, ``--chaos-demo``, ``--tenant-demo`` and ``--rpc``,
whose tenants then share one sharded runtime).  ``--mesh prod`` and ``prod-mp`` ask for the
(16, 16) and (2, 16, 16) production meshes and raise ``ValueError`` where
that many devices are not visible, as the reference fails there.
``--mp`` ranks per call through ``fwfm.rank_items_mp`` (Algorithm 1 with
the arena row-blocked over the mesh's model axis, each block's rows
projected to rank rho before the partials are summed); it implies
``--engine percall`` and needs ``dplr-fwfm``.

``--arch`` (default ``dplr-fwfm``) picks the registry's recsys model.
The corpus engine and the demos need ``dplr-fwfm``; ``wide-deep`` and
``autoint`` rank per call (``--engine percall``, their default) through
their ``rank_items``, as ``repro.launch.serve`` does.  ``bst`` and
``mind`` raise ``ValueError``: their ``rank_items`` reads the user's
behaviour history, and the driver's queries carry none (the JAX driver
fails on the same query with ``KeyError: 'hist_ids'``).

Where ``repro.launch.serve`` asserts that nothing retraced, these demos
assert what the port can: every reply holds the live slots and is
bitwise a lone call on its state (a reply does not depend on the
micro-batch it was coalesced into), each query launches the same kernels
as many times whatever the churn, and on the card ``ops.LAUNCHES`` shows
the kernels ran.
"""
from __future__ import annotations

import argparse
import collections
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs.registry import REGISTRY
from repro_torch.data.synthetic_ctr import SyntheticCTR
from repro_torch.checkpoint import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.train import recsys_module
from repro_torch.serving.corpus import next_pow2
from repro_torch.serving import (
    CorpusRankingEngine,
    CorpusState,
    DeadlineExceeded,
    Degraded,
    DispatchFailed,
    FaultInjector,
    InjectedFault,
    Overloaded,
    QueryFrontend,
    RefreshFailed,
    RpcClient,
    ScorerRuntime,
    ServingError,
    serve_in_thread,
)


def _corpus_mesh(args, dev):
    """The mesh that carries the corpus slab (``--mesh``), or None."""
    if args.mesh == "none":
        return None
    if args.mesh == "host":
        return make_host_mesh(device=dev)
    return make_production_mesh(multi_pod=args.mesh == "prod-mp", device=dev)


def _sharded_capacity(capacity: int, mesh) -> int:
    """At least one slot a shard."""
    return capacity if mesh is None else max(capacity, mesh.shape["model"])


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


def _lone(engine, ctx, k):
    """A lone ``engine.topk(ctx, k)`` as host arrays: ((k,), (k,))."""
    vals, ids = engine.topk(np.asarray(ctx).reshape(1, -1), k)
    return vals[0].cpu().numpy(), ids[0].cpu().numpy()


def _check_reply(reply, engine, ctx, k: int, what: str) -> None:
    """A reply holds live slots only and is bitwise a lone call on
    ``engine``, whatever micro-batch it was coalesced into."""
    sc, sl = reply
    wv, wi = _lone(engine, ctx, k)
    assert engine.is_live(sl).all(), f"{what}: a dead slot in the reply"
    assert np.array_equal(sc, wv) and np.array_equal(sl, wi), \
        f"{what}: reply != lone call (must be bitwise)"


def _cast(tree: dict, src: torch.dtype, dst: torch.dtype) -> dict:
    """``tree`` (nested dicts of tensors) with its ``src`` leaves cast to ``dst``."""
    return {k: _cast(v, src, dst) if isinstance(v, dict) else v.to(dst) if v.dtype == src
            else v for k, v in tree.items()}


def to_serving_dtype(params: dict, bf16: bool) -> dict:
    """``params`` with its float32 leaves cast to bf16 when ``bf16`` (the
    serving type), else as it is."""
    return _cast(params, torch.float32, torch.bfloat16) if bf16 else params


def to_checkpoint_dtype(params: dict) -> dict:
    """``params`` with its bf16 leaves cast to float32: the on-disk type."""
    return _cast(params, torch.bfloat16, torch.float32)


def _entries(args, *names) -> tuple:
    """The ``ops.KERNELS`` entry points ``names`` as this run serves them:
    their bf16 instantiations under ``--bf16``."""
    return tuple(f"{n}_bf16" for n in names) if args.bf16 else names


def _kernels_ran(dev, before, names, what: str) -> dict:
    """The kernel launches since ``before`` (a copy of ``ops.LAUNCHES``);
    on the card, raises unless the first kernel of each entry point in
    ``names`` (its only or stage-1 kernel) launched."""
    launched = dict(collections.Counter(ops.LAUNCHES) - before)
    if dev.type == "cuda":
        for name in names:
            if not launched.get(ops.KERNELS[name][0]):
                raise AssertionError(f"{what}: no {name} kernel launched ({launched})")
    return launched


def _frontend_demo(args, engine, data, dev) -> None:
    """A Poisson trace through the micro-batching frontend and through
    synchronous per-query calls; latency percentiles and QPS of both."""
    rng = np.random.default_rng(args.seed)
    max_k = max(args.topk or 10, 1)
    fe = QueryFrontend(engine, max_batch=args.fe_batch, max_k=max_k,
                       max_wait=args.max_wait_ms * 1e-3, inflight=args.inflight)
    ctx0 = data.context_query(0)["context_ids"]
    fe.warmup(ctx0)
    # synchronous per-query service time -> the automatic arrival rate
    k_bucket = next_pow2(max_k)
    for _ in range(3):
        engine.topk(ctx0, k_bucket)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(10):
        engine.topk(ctx0, k_bucket)
        _sync(dev)
    rate = args.arrival_rate or 2.0 / ((time.perf_counter() - t0) / 10)

    n = args.queries
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n))
    ks = rng.integers(1, max_k + 1, n)
    ctxs = [data.context_query(s)["context_ids"] for s in range(n)]
    churn_at = set(range(25, n, 25))

    def churn(s):
        # through the engine: its on_mutate is the frontend's writer barrier
        upd = data.ranking_query(2, 50_000 + s)
        engine.update_items(rng.choice(engine.valid_slots, 2, replace=False),
                            upd["item_ids"][0], upd["item_weights"][0])

    churn(-1)
    before = collections.Counter(ops.LAUNCHES)
    pend = []
    t0 = time.perf_counter()
    for s in range(n):
        now = time.perf_counter() - t0
        if arrivals[s] > now:
            time.sleep(arrivals[s] - now)
        if s in churn_at:
            churn(s)
        pend.append(fe.submit(ctxs[s], k=int(ks[s])))
    fe.drain()
    end = time.perf_counter() - t0
    launched = _kernels_ran(dev, before, _entries(args, "dplr_corpus_topk", "embedding_bag"),
                            "frontend demo")
    # completion minus scheduled arrival, as the synchronous loop measures
    lat_fe = np.asarray([(p.done_time - t0 - arrivals[s]) * 1e3 for s, p in enumerate(pend)])
    for p in pend:
        assert engine.is_live(p.result()[1]).all(), "frontend surfaced a dead slot"
    # requests after the last burst were scored against the final corpus
    first = max(churn_at) + 1 if churn_at else 0
    for s in range(first, n):
        _check_reply(pend[s].result(), engine, ctxs[s], int(ks[s]), f"frontend request {s}")

    lat_sync = np.empty(n)
    t0 = time.perf_counter()
    for s in range(n):
        now = time.perf_counter() - t0
        if arrivals[s] > now:
            time.sleep(arrivals[s] - now)
        if s in churn_at:
            churn(s)
        engine.topk(ctxs[s], int(next_pow2(int(ks[s]))))
        _sync(dev)
        lat_sync[s] = (time.perf_counter() - t0 - arrivals[s]) * 1e3
    qps_sync = n / max(time.perf_counter() - t0, 1e-9)
    fe.close()

    def pct(a):
        return "  ".join(f"p{q} {np.percentile(a, q):7.2f}" for q in (50, 95, 99))

    print(f"frontend demo ({dev.type}): {n} requests, Poisson {rate:.0f} qps, K in "
          f"1..{max_k}, bucket <= {args.fe_batch}, max-wait {args.max_wait_ms:.1f} ms, "
          f"inflight {args.inflight}, {len(churn_at)} churn bursts")
    print(f"  coalesced : {pct(lat_fe)} ms   {n / max(end, 1e-9):7.0f} qps   occupancy "
          f"{fe.occupancy:.2f} ({fe.stats['dispatches']} dispatches)")
    print(f"  sync      : {pct(lat_sync)} ms   {qps_sync:7.0f} qps")
    print(f"  replies after the last burst bitwise lone calls, all slots live; "
          f"launches {launched}")


def _churn_demo(args, engine, data, dev) -> None:
    """Interleave add/remove/update/score on the live engine: every top-K
    holds live slots only, every score query launches the same kernels,
    and the churned slab scores as a slab rebuilt from scratch."""
    rng = np.random.default_rng(args.seed)
    K = args.topk or 10
    per_score = []

    def one_score(s):
        q = data.context_query(s)
        ctx = torch.as_tensor(q["context_ids"], device=dev)
        ctx_w = torch.as_tensor(q["context_weights"], device=dev)
        before = collections.Counter(ops.LAUNCHES)
        t0 = time.perf_counter()
        _, idx = engine.topk(ctx, K, ctx_w)
        idx = idx.cpu().numpy().ravel()
        dt = (time.perf_counter() - t0) * 1e3
        per_score.append(str(dict(collections.Counter(ops.LAUNCHES) - before)))
        assert engine.is_live(idx).all(), f"masked top-K surfaced a dead slot: {idx}"
        return dt

    one_score(0)
    cap0 = engine.capacity
    lat, counts = [], {"add": 0, "remove": 0, "update": 0, "score": 0}
    for s in range(args.churn_ops):
        kind = "score" if s % 2 else rng.choice(["add", "remove", "update"])
        live = engine.valid_slots
        if kind == "add":
            dn = int(rng.integers(1, 9))
            if engine.n_items + dn > engine.capacity:
                kind = "remove"          # stay inside the slab: no mid-demo growth
            else:
                fresh = data.ranking_query(dn, 10_000 + s)
                engine.add_items(fresh["item_ids"][0], fresh["item_weights"][0])
        if kind == "remove":
            dn = int(rng.integers(1, 9))
            if engine.n_items - dn < max(K, args.items // 2):
                kind = "update"          # keep enough live items for top-K
            else:
                engine.remove_items(rng.choice(live, dn, replace=False))
        if kind == "update":
            dn = int(rng.integers(1, 9))
            fresh = data.ranking_query(dn, 20_000 + s)
            engine.update_items(rng.choice(live, dn, replace=False), fresh["item_ids"][0],
                                fresh["item_weights"][0])
        if kind == "score":
            lat.append(one_score(s))
        counts[kind] += 1
    assert engine.capacity == cap0, "slab doubled mid-demo"
    assert len(set(per_score)) == 1, f"kernel launches per query changed with churn: {per_score}"
    # the churned slab against one rebuilt from the host mirror
    ctx = data.context_query(0)["context_ids"]
    churned = engine.score(ctx)[0].cpu().numpy()
    engine.refresh(engine.params, step=engine.model_step)
    rebuilt = engine.score(ctx)[0].cpu().numpy()
    # a row written alone and the same row of a rebuild are computed in
    # batches of other shapes; in bf16 their slab rows may part by a bf16
    # rounding (the reference's bf16 value tolerance)
    tol = dict(atol=1e-1, rtol=2e-2) if args.bf16 else dict(atol=1e-5, rtol=1e-5)
    assert np.allclose(churned, rebuilt, **tol), \
        "churned slab != a slab rebuilt from the same items"
    print(f"churn demo ({dev.type}): {args.churn_ops} interleaved ops ({counts['add']} add / "
          f"{counts['remove']} remove / {counts['update']} update / {counts['score']} score), "
          f"{engine.n_items}/{engine.capacity} live slots at exit")
    _report(f"churn, top{K}, {dev.type}", np.asarray(lat), counts["score"], args.items)
    print(f"churn OK: every top-K live, kernel launches per query unchanged "
          f"({per_score[0]}), churned slab scores as a rebuilt one (within "
          f"{'atol 0.1, rtol 0.02' if args.bf16 else '1e-5'})")


def _chaos_demo(args, engine, data, params, dev) -> None:
    """A scripted fault storm through the self-healing frontend (module
    docstring); every reply that succeeds is bitwise the fault-free one,
    and every request resolves to a reply or a typed error."""
    inj = FaultInjector(seed=args.seed)
    engine.fault_injector = inj
    k = 8
    ctxs = [data.context_query(s)["context_ids"] for s in range(8)]
    oracle = [_lone(engine, c, k) for c in ctxs]
    fe = QueryFrontend(engine, max_batch=8, max_k=16, max_wait=args.max_wait_ms * 1e-3,
                       retries=2, retry_backoff=1e-4, breaker_threshold=2,
                       breaker_cooldown=0.05, fault_injector=inj)
    fe.warmup(ctxs[0])
    fe.start_pump(interval=1e-3, watchdog=0.25)

    def serve(s):
        got_v, got_i = fe.submit(ctxs[s], k=k).result()
        assert np.array_equal(got_v, oracle[s][0]) and np.array_equal(got_i, oracle[s][1]), \
            f"reply {s} not bitwise the fault-free one"

    # 1. a transient dispatch fault: the same assembled batch re-dispatches
    inj.arm("dispatch", count=1)
    serve(0)
    assert fe.stats["retries"] >= 1
    print(f"chaos 1: transient dispatch fault retried ({fe.stats['retries']} retry), "
          f"reply bitwise")

    # 2. an outage: two spent retry budgets trip the breaker, which sheds
    #    submits until the half-open probe succeeds
    for i in (1, 2):
        inj.arm("dispatch", count=fe.retries + 1)
        try:
            fe.submit(ctxs[i], k=k).result()
            raise AssertionError("outage dispatch unexpectedly succeeded")
        except DispatchFailed:
            pass
    try:
        fe.submit(ctxs[3], k=k)
        raise AssertionError("open breaker accepted a submit")
    except Degraded:
        print("chaos 2: breaker OPEN after 2 spent retry budgets -> fast Degraded shed")
    time.sleep(fe.breaker_cooldown)
    serve(3)
    print("chaos 2: half-open probe served -> breaker CLOSED, reply bitwise")

    # 3. a corrupt model push: rejected typed once while the last-good model
    #    serves; a good push at the next step installs
    with tempfile.TemporaryDirectory(prefix="serve_chaos_") as tmp:
        mgr = CheckpointManager(tmp)
        step0 = engine.model_step
        push = (step0 or 0) + 1
        on_disk = {"params": to_checkpoint_dtype(params)}
        pick = lambda t: to_serving_dtype(t["params"], args.bf16)  # noqa: E731
        mgr.save(on_disk, step=push, blocking=True)
        inj.corrupt_checkpoint(mgr.directory)
        try:
            fe.maybe_refresh(mgr, on_disk, select=pick)
            raise AssertionError("corrupt push was not rejected")
        except RefreshFailed as e:
            assert engine.model_step == step0
            print(f"chaos 3: corrupt push REJECTED typed ({e}); still serving step {step0}")
        serve(4)
        mgr.save(on_disk, step=push + 1, blocking=True)
        assert fe.maybe_refresh(mgr, on_disk, select=pick)
    print(f"chaos 3: good push installed (step {engine.model_step}), replies bitwise")

    # 4. a failed churn write: the probe fires before any state moves
    upd = data.ranking_query(2, 70_000)
    live = engine.valid_slots.copy()
    inj.arm("write", count=1)
    try:
        fe.update_items(live[:2], upd["item_ids"][0], upd["item_weights"][0])
        raise AssertionError("faulted churn write unexpectedly landed")
    except InjectedFault:
        pass
    assert np.array_equal(engine.valid_slots, live)
    serve(5)
    print("chaos 4: churn write faulted -> corpus untouched, reply bitwise")

    # 5. a stalled pump: the watchdog orphans it and starts a fresh one
    inj.arm("pump", count=1, delay=0.6)
    p = fe.submit(ctxs[6], k=k)
    deadline = time.perf_counter() + 10.0
    while fe.stats["pump_restarts"] < 1 and time.perf_counter() < deadline:
        time.sleep(0.01)
    assert fe.stats["pump_restarts"] >= 1, "watchdog never restarted the pump"
    got_v, got_i = p.result()
    assert np.array_equal(got_v, oracle[6][0]) and np.array_equal(got_i, oracle[6][1])
    print(f"chaos 5: pump stalled 0.6 s -> watchdog restarted it "
          f"({fe.stats['pump_restarts']} restart), reply bitwise")

    # 6. a kernel fault: retried through the same kernel, then typed once
    #    the retries are spent; nothing degrades to another scorer
    inj.arm("kernel", count=1)
    serve(7)
    inj.arm("kernel", count=fe.retries + 1)
    try:
        fe.submit(ctxs[7], k=k).result()
        raise AssertionError("a spent kernel retry budget did not fail")
    except DispatchFailed:
        pass
    assert not engine.kernel_degraded
    assert not fe.health()["tenants"]["default"]["kernel_degraded"]
    print("chaos 6: kernel fault retried (reply bitwise), then DispatchFailed once the "
          "retries were spent; kernel_degraded False")

    # 7. a seeded storm: every submitted request resolves
    inj.clear()
    inj.arm("dispatch", rate=0.2)
    rng = np.random.default_rng(args.seed)
    pend, shed = [], 0
    for s in range(args.queries):
        kq = int(next_pow2(int(rng.integers(1, 17))))
        try:
            pend.append(fe.submit(data.context_query(100 + s)["context_ids"], k=kq))
        except Degraded:
            shed += 1                    # breaker open mid-storm: a fast failure
            time.sleep(fe.breaker_cooldown)
    fe.drain()
    inj.clear()
    ok = failed = 0
    for p in pend:
        assert p.done(), "storm request never resolved"
        try:
            p.result()
            ok += 1
        except ServingError:
            failed += 1
    print(f"chaos 7: storm of {args.queries} requests at fault rate 0.2 -> {ok} served / "
          f"{failed} typed failures / {shed} shed, 0 dropped")
    h = fe.health()
    assert h["ready"] and not h["closed"]
    fe.close()
    engine.fault_injector = None
    print(f"chaos demo OK ({dev.type}): all recovery paths exercised")


def _rpc_demo(args, cfg, params, data, dev, mesh) -> None:
    """``--tenants`` corpora on one runtime, packed, behind the binary RPC
    protocol on a loopback socket: a pipelined mixed-tenant client trace,
    replies against direct frontend submission, typed error frames and a
    graceful drain."""
    rng = np.random.default_rng(args.seed)
    T = max(args.tenants, 2)
    runtime = ScorerRuntime(cfg, device=None if mesh else dev, mesh=mesh)
    capacity = _sharded_capacity(args.capacity or next_pow2(2 * args.items), mesh)
    names = [f"t{i}" for i in range(T)]
    states = {}
    for i, name in enumerate(names):
        c = data.ranking_query(args.items, 1000 + i)
        states[name] = CorpusState(None, c["item_ids"][0], c["item_weights"][0],
                                   capacity=capacity, runtime=runtime)
        states[name].refresh(params, step=0)
    max_k = max(args.topk or 10, 1)
    # auto_pump=False: the server's event loop owns pump and resolve
    fe = QueryFrontend(states, max_batch=args.fe_batch, max_k=max_k,
                       max_wait=args.max_wait_ms * 1e-3, inflight=args.inflight,
                       auto_pump=False, pack=True)
    fe.warmup(data.context_query(0)["context_ids"], tenant="t0")
    fe.warmup_packed(data.context_query(0)["context_ids"], tenant="t0")
    server = serve_in_thread(fe, port=args.port)
    print(f"rpc ({dev.type}): {T} tenants x {args.items} items (capacity {capacity}) on ONE "
          f"ScorerRuntime, packed, listening on 127.0.0.1:{server.port}")

    n = args.queries
    ctxs = [data.context_query(s)["context_ids"] for s in range(n)]
    ks = rng.integers(1, max_k + 1, n)
    lanes = [names[int(rng.integers(T))] for _ in range(n)]
    window = 16                          # pipelined frames per burst
    lat, replies = [], {}
    before = collections.Counter(ops.LAUNCHES)
    try:
        with RpcClient("127.0.0.1", server.port, timeout=60.0) as cli:
            t_start = time.perf_counter()
            sent = []
            for s in range(n):
                sent.append((s, cli.send_rank(ctxs[s], k=int(ks[s]), tenant=lanes[s]),
                             time.perf_counter()))
                if len(sent) >= window or s == n - 1:
                    for si, rid, ti in sent:
                        reply = cli.recv_for(rid)
                        reply.raise_for_status()
                        replies[si] = reply
                        lat.append((time.perf_counter() - ti) * 1e3)
                    sent = []
            wall = time.perf_counter() - t_start
            # typed error frames rebuild the taxonomy on the client
            bad_k = cli.recv_for(cli.send_rank(ctxs[0], k=max_k + 90, tenant="t0"))
            assert isinstance(bad_k.error, ValueError), bad_k.error
            expired = cli.recv_for(cli.send_rank(ctxs[0], k=1, tenant="t0",
                                                 deadline_rel=1e-9))
            assert isinstance(expired.error, DeadlineExceeded), expired.error
            assert expired.error.tenant == "t0"
        launched = _kernels_ran(dev, before,
                                _entries(args, "dplr_corpus_score_multi", "embedding_bag"),
                                "rpc demo")
        # socket replies against direct submission (the server keeps pumping;
        # a submit from here rides its ticks)
        check = list(range(0, n, max(n // 16, 1)))
        pend = [(s, fe.submit(ctxs[s], k=int(ks[s]), tenant=lanes[s])) for s in check]
        for s, p in pend:
            sc, sl = p.result()
            assert np.array_equal(replies[s].scores, sc) and \
                np.array_equal(replies[s].slots, sl), \
                f"socket reply {s} != direct frontend submission"
            _check_reply((replies[s].scores, replies[s].slots), states[lanes[s]], ctxs[s],
                         int(ks[s]), f"socket reply {s}")
    finally:
        server.stop()                    # graceful drain, then loop teardown
    st = server.stats
    lat_a = np.asarray(lat)
    print(f"  replies   : p50 {np.percentile(lat_a, 50):.2f}  p95 {np.percentile(lat_a, 95):.2f}"
          f"  p99 {np.percentile(lat_a, 99):.2f} ms over the wire ({n / wall:.0f} rps "
          f"pipelined x{window}, host clock); {len(check)} bitwise direct submission and "
          f"lone calls")
    print(f"  wire      : {st['requests']} requests, {st['replies']} ok, {st['errors']} typed "
          f"error frames, {st['protocol_errors']} protocol errors; graceful drain ok; "
          f"{fe.stats['fused_dispatches']} fused dispatches; launches {launched}")
    fe.close()


def _tenant_demo(args, cfg, params, data, dev, mesh) -> None:
    """``--tenants`` corpora on one ScorerRuntime behind the frontend;
    asserts live, per-tenant replies equal to the tenant's own state,
    a shared-runtime tenant equal to a dedicated engine, and fast
    admission shedding."""
    rng = np.random.default_rng(args.seed)
    T = max(args.tenants, 2)
    runtime = ScorerRuntime(cfg, device=None if mesh else dev, mesh=mesh)
    capacity = _sharded_capacity(args.capacity or next_pow2(2 * args.items), mesh)
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
    # every reply live at delivery; bitwise a lone call on its tenant's own
    # state for requests scored against the final corpus (the other tenants
    # never churned, t0 after its last burst)
    checked = 0
    for s, p in enumerate(pend):
        sc, sl = p.result()
        assert states[lanes[s]].is_live(sl).all(), f"tenant {lanes[s]} reply: a dead slot"
        if lanes[s] != "t0" or s > last_churn:
            _check_reply((sc, sl), states[lanes[s]], ctxs[s], int(ks[s]),
                         f"tenant {lanes[s]} reply {s}")
            checked += 1
    # a tenant on the shared runtime against a dedicated engine: same shapes,
    # so bitwise equal
    c = corpora["t1"]
    dedicated = CorpusRankingEngine(cfg, c["item_ids"][0], c["item_weights"][0],
                                    capacity=capacity, device=None if mesh else dev,
                                    mesh=mesh)
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
          f"ms; {checked} checked bitwise (incl. vs a dedicated engine); per-tenant "
          f"{per_tenant}")
    print(f"  admission : 5x burst -> {accepted} accepted / {sheds} shed fast "
          f"(Overloaded), 0 deadline expiries")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dplr-fwfm",
                    choices=sorted(n for n, s in REGISTRY.items() if s.family == "recsys"))
    ap.add_argument("--config", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--engine", default=None, choices=["corpus", "percall"],
                    help="corpus = precomputed item slab (dplr-fwfm, the default "
                         "there); percall = the model's rank_items per query (the "
                         "default for the other archs)")
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
                    help="tenant count for --tenant-demo and --rpc (min 2)")
    ap.add_argument("--capacity", type=int, default=0,
                    help="slab capacity (power of two; 0: items rounded up, 2x items "
                         "under --churn-demo, --tenant-demo and --rpc)")
    ap.add_argument("--frontend", action="store_true",
                    help="a Poisson trace through the micro-batching frontend against "
                         "synchronous per-query serving (p50/p95/p99 and QPS)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="--frontend offered load in qps (0: about 2x the synchronous "
                         "per-query capacity)")
    ap.add_argument("--churn-demo", action="store_true",
                    help="interleave add/remove/update/score ops on the live corpus")
    ap.add_argument("--churn-ops", type=int, default=1000,
                    help="number of interleaved churn and score operations")
    ap.add_argument("--chaos-demo", action="store_true",
                    help="scripted faults through the self-healing frontend")
    ap.add_argument("--rpc", action="store_true",
                    help="serve --tenants corpora over the binary RPC protocol on a "
                         "loopback socket and replay a pipelined client trace")
    ap.add_argument("--port", type=int, default=0, help="--rpc listen port (0: ephemeral)")
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
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 serving tables: the params' float32 leaves cast to bf16 "
                         "(checkpoints stay float32 on disk)")
    ap.add_argument("--mp", action="store_true",
                    help="model-parallel DPLR scoring: rank_items_mp over the arena's "
                         "row blocks (implies --engine percall)")
    ap.add_argument("--mesh", default="none", choices=["none", "host", "prod", "prod-mp"],
                    help="shard the corpus slab over this mesh's model axis (host = the "
                         "visible devices; prod[-mp] = the production shapes, where that "
                         "many devices are visible)")
    args = ap.parse_args(argv)
    if args.arch in ("bst", "mind"):
        raise ValueError(f"--arch {args.arch}: its rank_items needs the user's behaviour "
                         f"history (query keys 'hist_ids', 'hist_mask'), and this driver's "
                         f"queries (SyntheticCTR.ranking_query) carry none; the JAX serve "
                         f"driver fails on the same query with KeyError: 'hist_ids'")
    is_dplr = args.arch == "dplr-fwfm"
    args.engine = args.engine or ("corpus" if is_dplr and not args.mp else "percall")
    if args.engine == "corpus" and (not is_dplr or args.mp):
        ap.error("--engine corpus requires a dplr model (--arch dplr-fwfm) (and not --mp)")
    if args.mp and not is_dplr:
        ap.error("--mp requires a dplr model (--arch dplr-fwfm)")
    demos = ("tenant_demo", "refresh_demo", "frontend", "churn_demo", "chaos_demo", "rpc")
    if ((args.topk or args.mesh != "none" or any(getattr(args, d) for d in demos))
            and args.engine != "corpus"):
        ap.error("--topk, --mesh and the demos require --engine corpus")

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    spec = REGISTRY[args.arch]
    cfg = spec.make_smoke() if args.config == "smoke" else spec.make_config()
    mod = recsys_module(args.arch)
    params = mod.init(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    mgr = None
    if args.ckpt_dir or args.refresh_demo:
        mgr = CheckpointManager(args.ckpt_dir or tempfile.mkdtemp(prefix="serve_refresh_demo_"))
        restored, step = mgr.restore({"params": params}, device=dev)
        if restored is not None:
            params = restored["params"]
            print(f"serving checkpoint step {step}")
    params = to_serving_dtype(params, args.bf16)
    data = SyntheticCTR(cfg.layout, embed_dim=4, seed=args.seed)
    mesh = _corpus_mesh(args, dev)
    if args.tenant_demo:
        return _tenant_demo(args, cfg, params, data, dev, mesh)
    if args.rpc:
        return _rpc_demo(args, cfg, params, data, dev, mesh)

    lat = []
    if args.engine == "corpus":
        corpus = data.ranking_query(args.items, 0)
        capacity = _sharded_capacity(args.capacity or next_pow2(
            2 * args.items if args.churn_demo else args.items), mesh)
        engine = CorpusRankingEngine(cfg, corpus["item_ids"][0], corpus["item_weights"][0],
                                     capacity=capacity, device=None if mesh else dev,
                                     mesh=mesh)
        if mesh is not None:
            print(f"corpus sharded {engine.n_shards}-way: {engine.local_capacity}/"
                  f"{engine.capacity} slots a shard on {', '.join(map(str, mesh.devices))}")
        engine.refresh(params, step=mgr.latest_step() if mgr else None)
        if args.chaos_demo:
            return _chaos_demo(args, engine, data, params, dev)
        if args.frontend:
            return _frontend_demo(args, engine, data, dev)
        if args.churn_demo:
            return _churn_demo(args, engine, data, dev)
        refreshes, demo_pending, per_query = 0, False, []
        for s in range(args.queries):
            if args.refresh_demo and s == args.queries // 2:
                bumped = dict(params, bias=params["bias"] + 1.0)
                mgr.save({"params": to_checkpoint_dtype(bumped)},
                         step=(engine.model_step or 0) + 1, blocking=True)
                demo_pending = True          # poll now, whatever the cadence
            if mgr is not None and (demo_pending or (s and s % args.refresh_every == 0)):
                try:
                    swapped = engine.maybe_refresh(
                        mgr, {"params": params},
                        select=lambda t: to_serving_dtype(t["params"], args.bf16))
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
        tag = (f"corpus{f', top{args.topk}' if args.topk else ''}"
               f"{f', {engine.n_shards} shards' if engine.n_shards > 1 else ''}"
               f"{', bf16' if args.bf16 else ''}, {dev.type}")
        if args.refresh_demo:
            assert refreshes >= 1, "refresh demo never saw the new checkpoint"
            seen = {str(launched) for r, launched in per_query if r == 0}
            after = {str(launched) for r, launched in per_query if r > 0}
            assert len(seen) == 1 and after == seen, \
                f"kernel launches per query changed across the refresh: {seen} -> {after}"
            print(f"refresh round-trip OK: {refreshes} refresh(es), kernel launches per "
                  f"query unchanged across the refresh ({seen.pop()}), no restart")
    else:
        rank = mod.rank_items
        if args.mp:
            mp_mesh = make_host_mesh(device=dev)
            rank = lambda p, c, q: mod.rank_items_mp(p, c, q, mesh=mp_mesh)  # noqa: E731
        for s in range(args.queries):
            q = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.ranking_query(args.items, s).items()}
            t0 = time.perf_counter()
            scores = rank(params, cfg, q)
            _sync(dev)
            lat.append((time.perf_counter() - t0) * 1e3)
            if s == 0:
                top = torch.argsort(scores[0], descending=True, stable=True)[:3]
                print(f"query 0: top-3 of {args.items} candidates -> {top.cpu().numpy()}")
        tag = (f"percall, {args.arch}{', mp' if args.mp else ''}"
               f"{', bf16' if args.bf16 else ''}, {dev.type}")
    _report(tag, np.asarray(lat[2:]), args.queries, args.items)


if __name__ == "__main__":
    main()

"""The port's serving stack under injected faults: the counterparts of the
JAX package's ``tests/test_faults.py`` on the CPU, at its smoke size.

Every scenario scripts a ``FaultInjector`` schedule and holds the port to
the self-healing rules of the reference's docstrings: every accepted
request resolves to a reply or a typed ``ServingError``; a reply that
succeeds after a retry or a re-dispatch is bitwise the fault-free one;
a failed mutation or slab growth changes nothing; a corrupt model push
never interrupts serving.

Differences from the reference's file, on purpose:

* The reference's ``trace_count`` asserts have no counterpart: nothing in
  the port is traced, so there is no trace count to hold flat.
* Not a difference: a reply is held bitwise against a lone
  ``engine.topk``, as in the reference.  In the port that holds for a
  row of any micro-batch (the runtime computes the query side in fixed
  blocks); under JAX 0.9 the reference's does not, which is why its
  ``test_fault_storm_every_request_resolves`` and
  ``test_pressure_clamp_serves_exact_prefix`` fail there (its CI pins
  jax < 0.5).
* ``test_kernel_launch_failure_falls_back_bitexact`` becomes
  ``test_kernel_fault_retried_then_typed_never_hidden``: the port has no
  fallback scorer, so a kernel fault is retried through the same kernel
  and, once the retries are spent, fails typed with ``DispatchFailed``.

Two more tests hold the port to the reference directly: one seeded
schedule fires at the same calls in both packages' injectors (and
corrupts a checkpoint with the same bytes), and ``health()`` has the
reference's keys."""
import ast
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.fields import uniform_layout as juniform  # noqa: E402
from repro.models.recsys import fwfm as jfwfm  # noqa: E402
from repro.serving import CorpusRankingEngine as JEngine  # noqa: E402
from repro.serving import FaultInjector as JInjector  # noqa: E402
from repro.serving import InjectedFault as JInjectedFault  # noqa: E402
from repro.serving import QueryFrontend as JFrontend  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.fields import uniform_layout  # noqa: E402
from repro_torch.data.synthetic_ctr import SyntheticCTR  # noqa: E402
from repro_torch.models.recsys import fwfm  # noqa: E402
from repro_torch.serving.faults import SITES  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CorpusRankingEngine,
    DeadlineExceeded,
    Degraded,
    DispatchFailed,
    FaultInjector,
    InjectedFault,
    QueryFrontend,
    RefreshFailed,
    ServingError,
    Unservable,
)


def _setup(nC=5, nI=4, vocab=50, k=8, rho=2, n=37, seed=0, **engine_kw):
    cfg = fwfm.FwFMConfig(layout=uniform_layout(nC, nI, vocab), embed_dim=k,
                          interaction="dplr", rank=rho)
    params = fwfm.init(torch.Generator().manual_seed(seed), cfg)
    data = SyntheticCTR(cfg.layout, embed_dim=4, seed=seed)
    q = data.ranking_query(n, seed)
    engine = CorpusRankingEngine(cfg, q["item_ids"][0], q["item_weights"][0],
                                 device="cpu", **engine_kw)
    engine.refresh(params, step=0)
    return cfg, params, data, engine


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _ctx(data, s):
    return data.context_query(s)["context_ids"]


def _oracle(engine, data, s, k):
    v, i = engine.topk(np.asarray(_ctx(data, s)).reshape(1, -1), k)
    return v[0].numpy(), i[0].numpy()


def assert_same(reply, want):
    np.testing.assert_array_equal(reply[0], want[0])
    np.testing.assert_array_equal(reply[1], want[1])


# -- retry/backoff: transient dispatch faults are absorbed, replies bitwise ---

def test_transient_dispatch_fault_retried_bitexact():
    _, _, data, engine = _setup()
    inj = FaultInjector()
    fe = QueryFrontend(engine, max_batch=4, max_k=8, max_wait=1e9,
                       retries=2, retry_backoff=0.0, fault_injector=inj)
    fe.warmup(_ctx(data, 0))
    inj.arm("dispatch", count=1)          # fail exactly the next dispatch
    p = fe.submit(_ctx(data, 3), k=5)
    fe.drain()
    assert_same(p.result(), _oracle(engine, data, 3, 5))   # a lone row: bitwise
    assert fe.stats["retries"] == 1 and fe.stats["failed"] == 0
    assert inj.fired("dispatch") == 1


def test_exhausted_retries_fail_typed():
    _, _, data, engine = _setup()
    inj = FaultInjector()
    fe = QueryFrontend(engine, max_batch=2, max_k=4, max_wait=1e9,
                       retries=1, retry_backoff=0.0, fault_injector=inj)
    inj.arm("dispatch")                   # every dispatch fails
    p = fe.submit(_ctx(data, 0), k=2)
    fe.drain()
    assert p.done()
    with pytest.raises(DispatchFailed) as ei:
        p.result()
    assert ei.value.attempts == 2         # first try + 1 retry
    assert ei.value.tenant == "default"
    assert fe.stats["failed"] == 1


# -- resolve-time failure: the same assembled batch re-dispatches -------------

def test_resolve_failure_redispatches_same_batch_bitexact():
    _, _, data, engine = _setup()
    ks = [3, 7, 1]
    inj = FaultInjector()
    fe = QueryFrontend(engine, max_batch=4, max_k=8, max_wait=1e9,
                       retries=1, retry_backoff=0.0, fault_injector=inj)
    reqs = [fe.submit(_ctx(data, s), k=k) for s, k in enumerate(ks)]
    inj.arm("resolve", count=1)           # a deferred device error at read
    fe.drain()
    for s, (k, p) in enumerate(zip(ks, reqs)):
        assert_same(p.result(), _oracle(engine, data, s, k))
    assert inj.fired("resolve") == 1


def test_resolve_failure_with_dead_backend_fails_typed():
    _, _, data, engine = _setup()
    inj = FaultInjector()
    fe = QueryFrontend(engine, max_batch=2, max_k=4, max_wait=1e9,
                       retries=0, retry_backoff=0.0, fault_injector=inj)
    p = fe.submit(_ctx(data, 0), k=2)
    fe.flush()                            # dispatched clean
    inj.arm("resolve")                    # ...but the read fails
    inj.arm("dispatch")                   # ...and so does the re-dispatch
    fe.drain()
    with pytest.raises(DispatchFailed):
        p.result()


# -- circuit breaker: trip, shed fast, half-open probe, tenant isolation ------

def test_breaker_trips_sheds_and_recovers():
    _, _, data, engine = _setup()
    inj = FaultInjector()
    clock = FakeClock()
    fe = QueryFrontend(engine, max_batch=2, max_k=4, max_wait=1e9,
                       auto_pump=False, clock=clock, retries=0,
                       retry_backoff=0.0, breaker_threshold=2,
                       breaker_cooldown=1.0, fault_injector=inj)
    inj.arm("dispatch")
    for _ in range(2):                    # two exhausted dispatches: trip
        fe.submit(_ctx(data, 0), k=2)
        fe.flush()
    assert fe.health()["tenants"]["default"]["breaker"] == "open"
    with pytest.raises(Degraded):         # an open breaker sheds at submit
        fe.submit(_ctx(data, 1), k=2)
    assert fe.stats["degraded"] == 1

    clock.t = 5.0                         # cooldown elapsed: half-open
    inj.clear()
    probe = fe.submit(_ctx(data, 2), k=2)
    assert fe.health()["tenants"]["default"]["breaker"] == "half_open"
    fe.flush()
    fe.drain()
    assert fe.health()["tenants"]["default"]["breaker"] == "closed"
    assert_same(probe.result(), _oracle(engine, data, 2, 2))
    assert fe.lane_stats()["trips"] == 1


def test_breaker_halfopen_probe_failure_reopens():
    _, _, data, engine = _setup()
    inj = FaultInjector()
    clock = FakeClock()
    fe = QueryFrontend(engine, max_batch=2, max_k=4, max_wait=1e9,
                       auto_pump=False, clock=clock, retries=0,
                       breaker_threshold=1, breaker_cooldown=1.0,
                       fault_injector=inj)
    inj.arm("dispatch")
    fe.submit(_ctx(data, 0), k=2)
    fe.flush()                            # trip
    clock.t = 2.0
    fe.submit(_ctx(data, 1), k=2)         # the half-open probe
    fe.flush()                            # the probe fails: re-open at once
    assert fe.health()["tenants"]["default"]["breaker"] == "open"
    assert fe.lane_stats()["trips"] == 2
    with pytest.raises(Degraded):
        fe.submit(_ctx(data, 2), k=2)


def test_open_breaker_isolates_tenants_and_churn():
    """Tenant A's open breaker does not touch tenant B: B serves, B
    churns, and B's work never drains on A's account."""
    cfg, params, data, ea = _setup()
    qb = data.ranking_query(33, 1)
    eb = CorpusRankingEngine(None, qb["item_ids"][0], qb["item_weights"][0],
                             runtime=ea.runtime)
    eb.refresh(params, step=0)
    inj = FaultInjector()
    clock = FakeClock()
    fe = QueryFrontend({"A": ea, "B": eb}, max_batch=2, max_k=4,
                       max_wait=1e9, auto_pump=False, clock=clock,
                       retries=0, breaker_threshold=1,
                       breaker_cooldown=1e9, fault_injector=inj)
    inj.arm("dispatch", count=1)          # exactly A's next dispatch
    fe.submit(_ctx(data, 0), k=2, tenant="A")
    fe.flush()                            # A trips
    assert fe.health()["tenants"]["A"]["breaker"] == "open"
    with pytest.raises(Degraded):
        fe.submit(_ctx(data, 1), k=2, tenant="A")

    pb = fe.submit(_ctx(data, 5), k=3, tenant="B")
    fe.flush()
    fe.drain()
    assert_same(pb.result(), _oracle(eb, data, 5, 3))
    assert fe.health()["tenants"]["B"]["breaker"] == "closed"

    n_b = eb.n_items
    slots = fe.add_items(qb["item_ids"][0][:2], qb["item_weights"][0][:2], tenant="B")
    assert eb.n_items == n_b + 2 and eb.is_live(slots).all()
    assert ea.n_items == 37               # A untouched


def test_remove_tenant_racing_open_breaker():
    """remove_tenant while the lane's breaker trips during the removal
    drain: every queued request resolves typed, the lane disappears, the
    other tenant keeps serving."""
    cfg, params, data, ea = _setup()
    qb = data.ranking_query(33, 1)
    eb = CorpusRankingEngine(None, qb["item_ids"][0], qb["item_weights"][0],
                             runtime=ea.runtime)
    eb.refresh(params, step=0)
    inj = FaultInjector()
    clock = FakeClock()
    fe = QueryFrontend({"A": ea, "B": eb}, max_batch=1, max_k=4,
                       max_wait=1e9, auto_pump=False, clock=clock,
                       retries=0, breaker_threshold=1,
                       breaker_cooldown=1e9, fault_injector=inj)
    r1 = fe.submit(_ctx(data, 0), k=2, tenant="A")
    r2 = fe.submit(_ctx(data, 1), k=2, tenant="A")
    inj.arm("dispatch")
    # the drain dispatches r1 (fails, trips the breaker) then r2: an open
    # breaker gates submits only, never accepted requests
    fe.remove_tenant("A")
    assert r1.done() and r2.done()
    for r in (r1, r2):
        with pytest.raises(DispatchFailed):
            r.result()
    assert fe.tenants == ("B",)
    with pytest.raises(ValueError):
        fe.submit(_ctx(data, 2), k=2, tenant="A")
    inj.clear()
    pb = fe.submit(_ctx(data, 3), k=2, tenant="B")
    fe.drain()
    np.testing.assert_array_equal(pb.result()[0], _oracle(eb, data, 3, 2)[0])


# -- the umbrella rule: under a storm every accepted request resolves ---------

def test_fault_storm_every_request_resolves():
    _, _, data, engine = _setup()
    inj = FaultInjector(seed=3)
    fe = QueryFrontend(engine, max_batch=4, max_k=8, max_wait=1e9,
                       auto_pump=False, retries=1, retry_backoff=0.0,
                       fault_injector=inj)
    fe.warmup(_ctx(data, 0))
    inj.arm("dispatch", rate=0.4)         # seeded: a deterministic pattern
    rng = np.random.default_rng(0)
    accepted = []
    for s in range(40):
        k = int(rng.integers(1, 9))
        accepted.append((s, k, fe.submit(_ctx(data, s), k=k)))
        if s % 3 == 0:
            fe.pump()
    fe.drain()
    inj.clear()
    ok = failed = 0
    for s, k, p in accepted:
        assert p.done(), f"request {s} silently dropped"
        try:
            reply = p.result()
        except ServingError:
            failed += 1
            continue
        assert_same(reply, _oracle(engine, data, s, k))
        ok += 1
    assert ok + failed == 40 and ok > 0 and failed > 0


# -- pressure-K clamp: degraded but exact prefixes ----------------------------

def test_pressure_clamp_serves_exact_prefix():
    _, _, data, engine = _setup()
    fe = QueryFrontend(engine, max_batch=4, max_k=8, max_wait=1e9,
                       auto_pump=False, pressure_depth=4, pressure_k=2)
    reqs = [fe.submit(_ctx(data, s), k=8) for s in range(12)]
    fe.flush()
    fe.drain()
    clamped = [p for p in reqs if p.degraded]
    full = [p for p in reqs if not p.degraded]
    assert len(clamped) == 8 and len(full) == 4   # the last batch saw no queue
    assert fe.stats["clamped"] == 8
    for s, p in enumerate(reqs):
        scores, slots = p.result()
        wv, wi = _oracle(engine, data, s, 8)
        want_k = p.served_k
        assert want_k == (2 if p.degraded else 8) and p.k == 8
        # the clamped reply is the exact top-served_k prefix
        np.testing.assert_array_equal(scores, wv[:want_k])
        np.testing.assert_array_equal(slots, wi[:want_k])


# -- mutation faults: partial churn is never reader-visible -------------------

def test_failed_mutation_never_partially_visible():
    inj = FaultInjector()
    _, params, data, engine = _setup(fault_injector=inj)
    fe = QueryFrontend(engine, max_batch=2, max_k=4, max_wait=1e9, auto_pump=False)
    q2 = data.ranking_query(4, 9)
    before_n = engine.n_items
    before_valid = engine.valid_slots.copy()
    before_free = sorted(engine._free)
    before_slab = engine.cache.Q_I.clone()
    wv, wi = _oracle(engine, data, 0, 4)

    # an in-flight read rides through the failed churn untouched
    p = fe.submit(_ctx(data, 0), k=4)
    fe.flush()
    inj.arm("write")
    with pytest.raises(InjectedFault):
        fe.add_items(q2["item_ids"][0], q2["item_weights"][0])
    with pytest.raises(InjectedFault):
        fe.remove_items([int(wi[0])])
    with pytest.raises(InjectedFault):
        fe.update_items([int(wi[0])], q2["item_ids"][0][:1], q2["item_weights"][0][:1])
    inj.disarm("write")

    assert engine.n_items == before_n
    np.testing.assert_array_equal(engine.valid_slots, before_valid)
    assert sorted(engine._free) == before_free
    assert torch.equal(engine.cache.Q_I, before_slab)
    assert_same(p.result(), (wv, wi))
    assert_same(_oracle(engine, data, 0, 4), (wv, wi))

    # cleared: the identical mutation now lands
    slots = fe.add_items(q2["item_ids"][0], q2["item_weights"][0])
    assert engine.n_items == before_n + 4 and engine.is_live(slots).all()


def test_failed_slab_growth_is_clean_noop():
    inj = FaultInjector()
    _, params, data, engine = _setup(n=16, capacity=16, fault_injector=inj)
    q2 = data.ranking_query(2, 9)
    inj.arm("alloc", count=1)
    with pytest.raises(InjectedFault):
        engine.add_items(q2["item_ids"][0], q2["item_weights"][0])
    assert engine.capacity == 16 and engine.n_items == 16
    assert engine.cache.Q_I.shape[0] == 16
    slots = engine.add_items(q2["item_ids"][0], q2["item_weights"][0])
    assert engine.capacity == 32 and engine.is_live(slots).all()


# -- checkpoint faults: a bad model push surfaces typed, serving continues ----

def test_corrupt_and_torn_refresh_serve_last_good(tmp_path):
    _, params, data, engine = _setup()
    inj = FaultInjector()
    mgr = CheckpointManager(str(tmp_path))
    sel = lambda t: t["params"]  # noqa: E731
    tpl = {"params": params}
    mgr.save(tpl, step=1, blocking=True)
    assert engine.maybe_refresh(mgr, tpl, select=sel)
    want = _oracle(engine, data, 0, 4)

    # a corrupt push: RefreshFailed once, silent re-polls of the same
    # signature, the last-good snapshot still serving bitwise
    mgr.save(tpl, step=2, blocking=True)
    assert inj.corrupt_checkpoint(str(tmp_path)) == 2
    assert not mgr.step_valid(2) and mgr.step_valid(1)
    with pytest.raises(RefreshFailed) as ei:
        engine.maybe_refresh(mgr, tpl, select=sel)
    assert ei.value.step == 2
    assert not engine.maybe_refresh(mgr, tpl, select=sel)
    assert engine.model_step == 1
    assert_same(_oracle(engine, data, 0, 4), want)

    # a torn write (manifest intact, payload truncated): the same story
    mgr.save(tpl, step=3, blocking=True)
    assert engine.maybe_refresh(mgr, tpl, select=sel)
    mgr.save(tpl, step=4, blocking=True)
    assert inj.torn_write_checkpoint(str(tmp_path)) == 4
    with pytest.raises(RefreshFailed) as ei:
        engine.maybe_refresh(mgr, tpl, select=sel)
    assert ei.value.step == 4 and engine.model_step == 3

    # a re-save of the torn step lands and clears the error
    mgr.save(tpl, step=4, blocking=True)
    assert engine.maybe_refresh(mgr, tpl, select=sel)
    assert engine.model_step == 4 and engine.last_refresh_error is None


# -- kernel faults: retried through the same kernel, then typed ---------------

def test_kernel_fault_retried_then_typed_never_hidden():
    inj = FaultInjector()
    _, _, data, engine = _setup(fault_injector=inj)
    want = _oracle(engine, data, 3, 4)
    ctx = np.asarray(_ctx(data, 3)).reshape(1, -1)

    # the engine itself: a fired probe reaches the caller, every time
    inj.arm("kernel", count=2)
    for call in (lambda: engine.topk(ctx, 4), lambda: engine.score(ctx)):
        with pytest.raises(InjectedFault):
            call()
    assert not engine.kernel_degraded
    assert_same(tuple(t[0].numpy() for t in engine.topk(ctx, 4)), want)
    assert inj.calls("kernel") == 3       # probed again: nothing sticky

    # the frontend: one fault is retried through the same kernel, bitwise
    fe = QueryFrontend(engine, max_batch=2, max_k=4, max_wait=1e9,
                       retries=2, retry_backoff=0.0, fault_injector=inj)
    inj.arm("kernel", count=1)
    p = fe.submit(_ctx(data, 3), k=4)
    fe.drain()
    assert_same(p.result(), want)
    assert fe.stats["retries"] == 1

    # spent retries fail typed, with the kernel fault as the cause
    inj.arm("kernel", count=fe.retries + 1)
    p = fe.submit(_ctx(data, 3), k=4)
    fe.drain()
    with pytest.raises(DispatchFailed) as ei:
        p.result()
    assert isinstance(ei.value.__cause__, InjectedFault)
    assert ei.value.__cause__.site == "kernel"
    assert not engine.kernel_degraded
    assert fe.health()["tenants"]["default"]["kernel_degraded"] is False


def test_kernel_fault_fails_the_whole_pack():
    inj = FaultInjector()
    cfg, params, data, ea = _setup(fault_injector=inj)
    qb = data.ranking_query(33, 1)
    eb = CorpusRankingEngine(None, qb["item_ids"][0], qb["item_weights"][0],
                             runtime=ea.runtime)
    eb.refresh(params, step=0)
    fe = QueryFrontend({"A": ea, "B": eb}, max_batch=1, max_k=4, max_wait=1e9,
                       auto_pump=False, retries=0, pack=True)
    inj.arm("kernel", count=1)            # only A carries the injector
    pa = fe.submit(_ctx(data, 0), k=2, tenant="A")
    pb = fe.submit(_ctx(data, 1), k=2, tenant="B")
    fe.flush()                            # one fused launch for A and B
    fe.drain()
    assert fe.stats["fused_dispatches"] == 0 and inj.fired("kernel") == 1
    for p in (pa, pb):
        with pytest.raises(DispatchFailed):
            p.result()
    pa = fe.submit(_ctx(data, 0), k=2, tenant="A")
    fe.drain()
    assert_same(pa.result(), _oracle(ea, data, 0, 2))


# -- deadline clock skew ------------------------------------------------------

def test_clock_skew_expires_queued_deadlines():
    _, _, data, engine = _setup()
    inj = FaultInjector()
    base = FakeClock()
    fe = QueryFrontend(engine, max_batch=4, max_k=4, max_wait=1e9,
                       auto_pump=False, clock=inj.wrap_clock(base))
    p = fe.submit(_ctx(data, 0), k=2, deadline=5.0)
    inj.arm("clock", skew=10.0)           # the deadline clock jumps ahead
    fe.flush()
    with pytest.raises(DeadlineExceeded):
        p.result()
    assert fe.stats["expired"] == 1


# -- pump watchdog: a stalled pump loop is restarted --------------------------

def test_pump_watchdog_restarts_stalled_loop():
    _, _, data, engine = _setup()
    inj = FaultInjector()
    fe = QueryFrontend(engine, max_batch=4, max_k=4, max_wait=0.0,
                       auto_pump=False, fault_injector=inj)
    inj.arm("pump", delay=0.6, count=1)   # one slow-fault stall
    fe.start_pump(interval=0.005, watchdog=0.1)
    try:
        p = fe.submit(_ctx(data, 0), k=2)
        deadline = time.monotonic() + 5.0
        while ((fe.stats["pump_restarts"] < 1 or fe.queue_depth > 0)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert fe.stats["pump_restarts"] >= 1, "stall never detected"
        assert fe.queue_depth == 0, "restarted pump never dispatched"
        assert fe.health()["pump"]["running"]
        assert_same(p.result(), _oracle(engine, data, 0, 2))
    finally:
        fe.stop_pump()


# -- graceful shutdown and the health surface ---------------------------------

def test_close_resolves_inflight_and_fails_queued_typed():
    _, _, data, engine = _setup()
    fe = QueryFrontend(engine, max_batch=2, max_k=4, max_wait=1e9, auto_pump=False)
    a = fe.submit(_ctx(data, 0), k=2)
    b = fe.submit(_ctx(data, 1), k=3)
    fe.flush()                            # a + b in flight
    c = fe.submit(_ctx(data, 2), k=2)     # still queued at close
    fe.close()
    for s, k, p in [(0, 2, a), (1, 3, b)]:
        assert_same(p.result(), _oracle(engine, data, s, k))
    with pytest.raises(Unservable):
        c.result()
    with pytest.raises(Unservable):
        fe.submit(_ctx(data, 3), k=2)
    h = fe.health()
    assert h["closed"] and not h["ready"]
    assert engine.on_mutate is None       # writer barrier detached
    fe.close()                            # idempotent


def test_health_probe_shape():
    _, _, data, engine = _setup()
    fe = QueryFrontend(engine, max_batch=4, max_k=4, max_wait=1e9, auto_pump=False)
    h = fe.health()
    assert h["ready"] and not h["closed"] and not h["degraded"]
    lane = h["tenants"]["default"]
    assert lane["breaker"] == "closed" and lane["queued"] == 0
    assert lane["n_items"] == 37 and lane["model_step"] == 0
    assert lane["refresh_age"] is not None and lane["refresh_age"] >= 0
    assert lane["last_refresh_error"] is None
    assert lane["kernel_degraded"] is False


def test_health_keys_equal_the_reference():
    _, _, data, engine = _setup()
    jcfg = jfwfm.FwFMConfig(layout=juniform(5, 4, 50), embed_dim=8, interaction="dplr",
                            rank=2)
    q = data.ranking_query(37, 0)
    jengine = JEngine(jcfg, q["item_ids"][0], q["item_weights"][0])
    jengine.refresh(jfwfm.init(jax.random.PRNGKey(0), jcfg), step=0)

    def keys(h):
        return {k: keys(v) if isinstance(v, dict) else None for k, v in h.items()}

    got = QueryFrontend(engine, auto_pump=False).health()
    want = JFrontend(jengine, auto_pump=False).health()
    assert keys(got) == keys(want)


# -- the injector itself: seeded determinism, across packages -----------------

def test_injector_rate_schedule_is_deterministic():
    def pattern(seed):
        inj = FaultInjector(seed=seed)
        inj.arm("dispatch", rate=0.5)
        out = []
        for _ in range(50):
            try:
                inj.check("dispatch")
                out.append(0)
            except InjectedFault:
                out.append(1)
        return out

    a, b = pattern(7), pattern(7)
    assert a == b and 0 < sum(a) < 50
    assert pattern(8) != a                # a different seed, a different run


def _script(inj, fault):
    """One schedule over several sites; returns (site, fired) per call and
    the injector's counters."""
    inj.arm("dispatch", rate=0.3)
    inj.arm("resolve", rate=0.5, after=3, count=4)
    inj.arm("write", count=2, after=1)
    inj.arm("rpc_read", rate=0.7, count=5)
    sites = ["dispatch", "resolve", "write", "rpc_read", "kernel"]
    out = []
    for i in range(120):
        site = sites[(i * 7 + i // 5) % len(sites)]
        try:
            inj.check(site)
            out.append((site, 0))
        except fault:
            out.append((site, 1))
    return out, {s: (inj.fired(s), inj.calls(s)) for s in sites}, list(inj.log)


def test_seeded_schedule_fires_at_the_same_calls_in_both_packages(tmp_path):
    for seed in (0, 11, 2024):
        got = _script(FaultInjector(seed=seed), InjectedFault)
        want = _script(JInjector(seed=seed), JInjectedFault)
        assert got == want
        assert 0 < sum(f for _, f in got[0]) < 120
    # the physical faults draw from the same stream: the same garbage bytes
    blobs = []
    for inj in (FaultInjector(seed=5), JInjector(seed=5)):
        d = tmp_path / type(inj).__module__.replace(".", "_")
        (d / "step_00000003").mkdir(parents=True)
        (d / "step_00000003" / "arrays.npz").write_bytes(b"\0" * 1000)
        assert inj.corrupt_checkpoint(str(d)) == 3
        blobs.append((d / "step_00000003" / "arrays.npz").read_bytes())
    assert blobs[0] == blobs[1] and len(blobs[0]) == 1000


# -- the analyzer's ERR-FAULT-SITE rule, for the port ---------------------------

def _probe_sites():
    """(file, line, site) of every ``<x>.check("<site>")`` and
    ``<x>._probe("<site>")`` call with a literal site in the port."""
    root = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    out = []
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("check", "_probe") and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                out.append((path.relative_to(root), node.lineno, node.args[0].value))
    return out


def test_every_probe_names_a_documented_site():
    probes = _probe_sites()
    unmapped = [p for p in probes if p[2] not in SITES]
    assert not unmapped, f"probes outside faults.SITES: {unmapped}"
    # and every site but the clock (read through wrap_clock) has a probe
    assert {site for _, _, site in probes} == SITES - {"clock"}
    with pytest.raises(AssertionError):   # the rule bites on an unmapped literal
        assert "dispatchh" in SITES

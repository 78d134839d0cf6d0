"""The port's ``QueryFrontend`` on the CPU: the counterparts of the JAX
package's frontend and multi-tenant tests that need no mesh, no trace
count and no fault injector, the self-healing paths driven by a failing
engine instead, and one request sequence sent through the JAX package's
``QueryFrontend(pack=True)`` and the port's, replies compared.

Within the port, a reply is held against a lone ``engine.topk`` call with
the parity tolerance (atol = rtol = 1e-5, ids equal except between ties):
a coalesced batch has another shape than a lone call.  Where the shapes
match (packed against unpacked in the same Bq bucket) replies must be
bitwise equal.  Tests that start a pump thread stop it in a ``finally``
and wait at most a few seconds."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.fields import uniform_layout as juniform  # noqa: E402
from repro.data.synthetic_ctr import SyntheticCTR  # noqa: E402
from repro.models.recsys import fwfm as jfwfm  # noqa: E402
from repro.serving import CorpusState as JState  # noqa: E402
from repro.serving import QueryFrontend as JFrontend  # noqa: E402
from repro.serving import ScorerRuntime as JRuntime  # noqa: E402
from repro_torch.core.fields import uniform_layout  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models.recsys import fwfm  # noqa: E402
from repro_torch.serving.engine import CorpusRankingEngine, CorpusState  # noqa: E402
from repro_torch.serving.errors import (  # noqa: E402
    DeadlineExceeded,
    Degraded,
    DispatchFailed,
    FrontendError,
    Overloaded,
    Unservable,
)
from repro_torch.serving.faults import FaultInjector  # noqa: E402
from repro_torch.serving.frontend import QueryFrontend  # noqa: E402
from repro_torch.serving.runtime import ScorerRuntime  # noqa: E402

from test_torch_parity import assert_topk  # noqa: E402


def _base(seed=0):
    cfg = fwfm.FwFMConfig(layout=uniform_layout(5, 4, 50), embed_dim=8,
                          interaction="dplr", rank=2)
    params = fwfm.init(torch.Generator().manual_seed(seed), cfg)
    return cfg, params, SyntheticCTR(cfg.layout, embed_dim=4, seed=seed)


def _engine(n=37, capacity=None, seed=0):
    cfg, params, data = _base(seed)
    q = data.ranking_query(n, seed)
    engine = CorpusRankingEngine(cfg, q["item_ids"][0], q["item_weights"][0],
                                 capacity=capacity, device="cpu")
    engine.refresh(params, step=0)
    return cfg, params, data, engine


def _tenants(cfg, params, data, names, *, n=20, capacity=32, runtime=None):
    """One shared runtime and one refreshed state per name, each over its
    own corpus; ``capacity`` is one for all or one per name."""
    rt = runtime or ScorerRuntime(cfg, device="cpu")
    caps = [capacity] * len(names) if isinstance(capacity, int) else capacity
    states = {}
    for i, (name, cap) in enumerate(zip(names, caps)):
        q = data.ranking_query(n, 100 + i)
        states[name] = CorpusState(None, q["item_ids"][0], q["item_weights"][0],
                                   capacity=cap, runtime=rt)
        states[name].refresh(params, step=0)
    return rt, states


def _ctx(data, s):
    return data.context_query(s)["context_ids"]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def assert_reply(reply, engine, ctx, k):
    """A reply against a lone ``engine.topk(ctx, k)`` call."""
    scores, slots = reply
    assert scores.shape == slots.shape == (k,)
    ctx = np.asarray(ctx).reshape(1, -1)
    wv, wi = engine.topk(ctx, k)
    assert_topk(scores[None], slots[None], wv, wi, engine.score(ctx)[:, :])
    assert engine.is_live(slots).all()


# -- coalescing, dispatch policy, window ----------------------------------------

def test_coalesced_replies_match_one_by_one_mixed_k():
    _, _, data, engine = _engine(n=37)
    fe = QueryFrontend(engine, max_batch=8, max_k=8, max_wait=1e9)
    rng = np.random.default_rng(0)
    reqs = [fe.submit(_ctx(data, s), k=int(rng.integers(1, 9))) for s in range(23)]
    fe.drain()
    assert fe.stats["dispatches"] == 3 and fe.stats["padded_rows"] == 1
    for s, p in enumerate(reqs):
        assert_reply(p.result(), engine, _ctx(data, s), p.k)


def test_submit_pump_flush_dispatch_policy():
    _, _, data, engine = _engine(n=37)
    clock = FakeClock()
    fe = QueryFrontend(engine, max_batch=4, max_k=4, max_wait=1.0, clock=clock)
    a = fe.submit(_ctx(data, 0), k=2)
    assert fe.queue_depth == 1 and fe.pump() == 0     # young: keeps waiting
    clock.t = 2.0
    assert fe.pump() == 1 and fe.queue_depth == 0     # max_wait elapsed
    assert a.done() or fe.inflight_depth == 1
    for s in range(4):                                # a full bucket goes at once
        fe.submit(_ctx(data, s), k=2)
    assert fe.queue_depth == 0
    fe.drain()
    assert a.result()[0].shape == (2,)


def test_inflight_window_resolves_oldest():
    _, _, data, engine = _engine(n=37)
    fe = QueryFrontend(engine, max_batch=2, max_k=4, max_wait=1e9, inflight=2)
    reqs = [fe.submit(_ctx(data, s), k=2) for s in range(6)]
    assert fe.stats["dispatches"] == 3 and fe.inflight_depth == 2
    assert reqs[0].done() and reqs[1].done() and not reqs[5].done()
    fe.drain()
    assert all(r.done() for r in reqs)


def test_every_arrival_pattern_completes_after_warmup():
    _, _, data, engine = _engine(n=37)
    fe = QueryFrontend(engine, max_batch=8, max_k=8, max_wait=1e9)
    assert fe.warmup(_ctx(data, 0)) == 1              # the largest bucket alone
    rng = np.random.default_rng(1)
    for burst in [1, 3, 8, 5, 23, 2, 16, 7, 1, 11]:
        pend = [fe.submit(_ctx(data, int(rng.integers(1000))), k=int(rng.integers(1, 9)))
                for _ in range(burst)]
        fe.drain() if burst % 2 else fe.flush()
        for p in pend:
            assert p.result()[1].shape == (p.k,)
    assert fe.stats["completed"] == fe.stats["submitted"] == 77


# -- churn against in-flight reads -----------------------------------------------

def test_churn_drains_inflight_before_mutating():
    _, _, data, engine = _engine(n=20, capacity=64)
    clock = FakeClock()
    fe = QueryFrontend(engine, max_batch=4, max_k=20, max_wait=1e9, inflight=8,
                       clock=clock)
    rng = np.random.default_rng(2)
    for round_ in range(6):
        pend = [fe.submit(_ctx(data, 10 * round_ + i), k=10) for i in range(5)]
        clock.t += 1.0
        assert any(not p.done() for p in pend)
        victims = rng.choice(engine.valid_slots, 2, replace=False)
        if round_ % 2:
            engine.remove_items(victims)
            upd = data.ranking_query(2, 700 + round_)
            engine.add_items(upd["item_ids"][0], upd["item_weights"][0])
        else:
            upd = data.ranking_query(2, 800 + round_)
            engine.update_items(victims, upd["item_ids"][0], upd["item_weights"][0])
        for p in pend:
            assert p.done() and p.done_time <= clock.t
    tail = fe.submit(_ctx(data, 999), k=10)
    fe.drain()
    assert engine.is_live(tail.result()[1]).all()
    assert fe.stats["drains"] >= 9


def test_writer_wrappers_atomic_with_concurrent_submits():
    _, _, data, engine = _engine(n=24, capacity=64)
    fe = QueryFrontend(engine, max_batch=4, max_k=8, max_wait=0.0)
    fe.warmup(_ctx(data, 0))
    rng = np.random.default_rng(4)
    stop = threading.Event()
    errors = []

    def writer():
        try:
            for i in range(40):
                fe.remove_items(rng.choice(engine.valid_slots, 2, replace=False))
                fresh = data.ranking_query(2, 5000 + i)
                fe.add_items(fresh["item_ids"][0], fresh["item_weights"][0])
        except Exception as e:              # pragma: no cover - fail loud
            errors.append(e)
        finally:
            stop.set()

    t = threading.Thread(target=writer)
    t.start()
    served = 0
    try:
        while not stop.is_set() or served == 0:
            scores, slots = fe.submit(_ctx(data, served), k=8).result()
            assert slots.shape == (8,) and np.isfinite(scores).all()
            served += 1
    finally:
        t.join(timeout=60)
    assert not errors and served > 0
    assert fe.stats["completed"] == fe.stats["submitted"]


def test_direct_engine_churn_and_refresh_trigger_the_barrier():
    _, params, data, engine = _engine(n=20, capacity=32)
    fe = QueryFrontend(engine, max_batch=8, max_k=4, max_wait=1e9)
    p = fe.submit(_ctx(data, 0), k=4)
    assert not p.done()
    engine.refresh(params, step=1)
    assert p.done() and fe.stats["drains"] == 1


# -- deadlines, K buckets, failures ----------------------------------------------

def test_deadline_expired_clean_error():
    _, _, data, engine = _engine(n=37)
    clock = FakeClock()
    fe = QueryFrontend(engine, max_batch=8, max_k=8, max_wait=0.5, clock=clock)
    doomed = fe.submit(_ctx(data, 0), k=4, deadline=1.0)
    alive = fe.submit(_ctx(data, 1), k=4, deadline=50.0)
    clock.t = 2.0
    assert fe.pump() == 1
    with pytest.raises(DeadlineExceeded):
        doomed.result()
    assert doomed.done() and fe.stats["expired"] == 1
    wv, wi = engine.topk(np.asarray(_ctx(data, 1)).reshape(1, -1), 4)
    np.testing.assert_array_equal(alive.result()[1], wi[0].numpy())   # same shape: bitwise
    assert fe.stats["dispatched_rows"] == 1


def test_deadline_checked_at_dispatch_not_submit():
    _, _, data, engine = _engine(n=37)
    clock = FakeClock()
    fe = QueryFrontend(engine, max_batch=8, max_k=8, max_wait=1e9, clock=clock)
    p = fe.submit(_ctx(data, 0), k=4, deadline=10.0)
    clock.t = 5.0
    fe.flush()
    assert p.result()[0].shape == (4,)


def test_k_bucket_lowers_to_live_count():
    _, _, data, engine = _engine(n=5)        # 5 live items, capacity 8
    fe = QueryFrontend(engine, max_batch=4, max_k=5, max_wait=1e9)
    p = fe.submit(_ctx(data, 0), k=5)
    fe.drain()
    assert_reply(p.result(), engine, _ctx(data, 0), 5)


def test_unservable_k_fails_typed_and_alone():
    _, _, data, engine = _engine(n=5)
    fe = QueryFrontend(engine, max_batch=4, max_k=64, max_wait=1e9)
    p = fe.submit(_ctx(data, 0), k=64)       # k <= max_k but > n_items
    fe.flush()
    with pytest.raises(FrontendError):
        p.result()
    assert fe.stats["failed"] == 1
    _, _, data, engine = _engine(n=12, capacity=16)
    fe = QueryFrontend(engine, max_batch=4, max_k=10, max_wait=1e9)
    small, big = fe.submit(_ctx(data, 0), k=2), fe.submit(_ctx(data, 1), k=10)
    engine.remove_items([0, 1, 2])           # the barrier answers both first
    assert small.done() and big.done()
    small2, big2 = fe.submit(_ctx(data, 0), k=2), fe.submit(_ctx(data, 1), k=10)
    fe.flush()
    with pytest.raises(Unservable, match="live corpus"):
        big2.result()
    assert_reply(small2.result(), engine, _ctx(data, 0), 2)


def test_submit_and_constructor_validation():
    _, _, data, engine = _engine(n=37)
    fe = QueryFrontend(engine, max_batch=4, max_k=8, max_wait=1e9)
    with pytest.raises(ValueError, match="max_k"):
        fe.submit(_ctx(data, 0), k=9)
    with pytest.raises(ValueError, match="slots"):
        fe.submit(np.arange(3), k=2)
    for kw, match in [({"max_batch": 6}, "power of two"), ({"inflight": 0}, "inflight"),
                      ({"pressure_depth": 2}, "come together"),
                      ({"autoscale_high": 1.5}, "outside")]:
        with pytest.raises(ValueError, match=match):
            QueryFrontend(engine, **kw)


# -- tenants: routing, isolation, fairness, admission, EDF ------------------------

def test_frontend_routes_tenants_with_matching_replies():
    cfg, params, data = _base()
    rt, states = _tenants(cfg, params, data, ["a", "b", "c"])
    fe = QueryFrontend(states, max_batch=4, max_k=8, max_wait=1e9)
    rng = np.random.default_rng(0)
    pend = []
    for s in range(21):
        t = ["a", "b", "c"][s % 3]
        k = int(rng.integers(1, 9))
        pend.append((fe.submit(_ctx(data, s), k=k, tenant=t), t, s, k))
    fe.drain()
    for p, t, s, k in pend:
        assert p.tenant == t
        assert_reply(p.result(), states[t], _ctx(data, s), k)
    assert fe.stats["completed"] == fe.stats["submitted"] == 21
    assert fe.lane_stats("a")["completed"] == 7


def test_frontend_tenant_routing_validation():
    cfg, params, data = _base()
    rt, states = _tenants(cfg, params, data, ["a", "b"])
    fe = QueryFrontend(states, max_batch=4, max_k=4, max_wait=1e9)
    with pytest.raises(ValueError, match="tenant= required"):
        fe.submit(_ctx(data, 0), k=2)
    with pytest.raises(ValueError, match="unknown tenant"):
        fe.submit(_ctx(data, 0), k=2, tenant="nope")
    with pytest.raises(ValueError, match="already registered"):
        fe.add_tenant("a", states["a"])
    with pytest.raises(ValueError, match="weight"):
        fe.add_tenant("z", states["a"], weight=0.0)


def test_tenant_a_churn_and_refresh_do_not_drain_tenant_b():
    cfg, params, data = _base()
    rt, states = _tenants(cfg, params, data, ["a", "b"])
    fe = QueryFrontend(states, max_batch=4, max_k=8, max_wait=1e9, inflight=8)
    pa = [fe.submit(_ctx(data, s), k=4, tenant="a") for s in range(4)]
    pb = [fe.submit(_ctx(data, 10 + s), k=4, tenant="b") for s in range(4)]
    assert fe.inflight_depth == 2
    upd = data.ranking_query(2, 50)
    fe.update_items([0, 1], upd["item_ids"][0], upd["item_weights"][0], tenant="a")
    assert all(p.done() for p in pa) and not any(p.done() for p in pb)
    fe.refresh(params, step=1, tenant="a")
    assert not any(p.done() for p in pb)
    assert states["a"].model_step == 1 and states["b"].model_step == 0
    assert fe.stats["drains"] == 2
    fe.drain()
    for s, p in enumerate(pb):
        assert_reply(p.result(), states["b"], _ctx(data, 10 + s), 4)


def test_tenant_b_never_sees_tenant_a_dead_slots_under_churn_storm():
    cfg, params, data = _base()
    rt, states = _tenants(cfg, params, data, ["a", "b"], n=24, capacity=64)
    fe = QueryFrontend(states, max_batch=2, max_k=8, max_wait=1e9, inflight=4)
    rng = np.random.default_rng(3)
    for round_ in range(8):
        pb = [fe.submit(_ctx(data, 10 * round_ + i), k=6, tenant="b") for i in range(2)]
        fe.remove_items(rng.choice(states["a"].valid_slots, 3, replace=False), tenant="a")
        fresh = data.ranking_query(3, 900 + round_)
        fe.add_items(fresh["item_ids"][0], fresh["item_weights"][0], tenant="a")
        assert not any(p.done() for p in pb)
        for p in pb:
            assert states["b"].is_live(p.result()[1]).all()
    assert fe.lane_stats("b")["completed"] == 16


def test_round_robin_and_weights_interleave_tenant_buckets():
    cfg, params, data = _base()
    rt, states = _tenants(cfg, params, data, ["a", "b", "c"])
    fe = QueryFrontend(states, max_batch=2, max_k=4, max_wait=1e9, inflight=16,
                       auto_pump=False)
    for t, n in (("a", 4), ("b", 2), ("c", 2)):
        for s in range(n):
            fe.submit(_ctx(data, s), k=2, tenant=t)
    assert fe.queue_depth == 8
    fe.pump()
    assert [fl.tenant for fl in fe._window] == ["a", "b", "c", "a"]
    fe.drain()
    assert fe.stats["completed"] == 8
    # weight 2 for a: a takes two turns of every three
    fe.set_tenant_policy("a", weight=2.0)
    for t in ("a", "b"):
        for s in range(6):
            fe.submit(_ctx(data, s), k=2, tenant=t)
    fe.pump()
    order = [fl.tenant for fl in fe._window]
    assert order[:3].count("a") == 2 and order.count("a") == 3
    fe.drain()


def test_quota_defers_the_scheduler_but_not_blocking_reads():
    cfg, params, data = _base()
    rt, states = _tenants(cfg, params, data, ["a", "b"])
    clock = FakeClock()
    fe = QueryFrontend(states, max_batch=2, max_k=4, max_wait=1e9, auto_pump=False,
                       clock=clock)
    fe.set_tenant_policy("a", quota=1.0)     # 1 request/s, empty bucket
    pa = [fe.submit(_ctx(data, s), k=2, tenant="a") for s in range(2)]
    pb = [fe.submit(_ctx(data, s), k=2, tenant="b") for s in range(2)]
    assert fe.pump() == 1 and fe.lane_stats("a")["quota_deferred"] >= 1
    assert fe.lane_stats("a")["queued"] == 2
    clock.t = 1.5                            # 1.5 tokens earned
    assert fe.pump() == 1
    assert pa[0].result()[0].shape == (2,) and pb[1].result()[0].shape == (2,)


def test_admit_depth_sheds_overloaded_and_serves_accepted():
    cfg, params, data = _base()
    rt, states = _tenants(cfg, params, data, ["a", "b"])
    fe = QueryFrontend(states, max_batch=8, max_k=4, max_wait=1e9, admit_depth=4,
                       auto_pump=False)
    accepted = [fe.submit(_ctx(data, s), k=2, tenant="a") for s in range(4)]
    for s in range(6):
        with pytest.raises(Overloaded, match="queue depth"):
            fe.submit(_ctx(data, 100 + s), k=2, tenant="a")
    pb = fe.submit(_ctx(data, 200), k=2, tenant="b")
    assert fe.stats["shed"] == 6 == fe.lane_stats("a")["shed"]
    assert fe.lane_stats("b")["shed"] == 0
    fe.drain()
    for p in accepted + [pb]:
        assert p.result()[0].shape == (2,)
    assert fe.stats["expired"] == 0


def test_admit_deadline_infeasible_sheds_at_submit():
    cfg, params, data = _base()
    rt, states = _tenants(cfg, params, data, ["a"])
    clock = FakeClock()
    fe = QueryFrontend(states, max_batch=4, max_k=4, max_wait=1.0, admit_deadlines=True,
                       clock=clock)
    p0 = fe.submit(_ctx(data, 0), k=2, tenant="a")
    fe.flush()
    clock.t = 1.0
    p0.result()
    assert fe._svc == 0.0                    # the blocking read took no clock time
    with pytest.raises(Overloaded, match="exceeds deadline"):
        fe.submit(_ctx(data, 1), k=2, deadline=clock.t + 0.5, tenant="a")
    fe._svc = 1.0
    with pytest.raises(Overloaded, match="exceeds deadline"):
        fe.submit(_ctx(data, 1), k=2, deadline=clock.t + 1.5, tenant="a")
    assert fe.stats["shed"] == 2 and fe.stats["expired"] == 0
    ok = fe.submit(_ctx(data, 2), k=2, deadline=clock.t + 10.0, tenant="a")
    fe.drain()
    assert ok.result()[0].shape == (2,)


def test_edf_order_and_fifo_for_deadline_less():
    cfg, params, data = _base()
    rt, states = _tenants(cfg, params, data, ["a"])
    clock = FakeClock()
    fe = QueryFrontend(states, max_batch=1, max_k=4, max_wait=1e9, inflight=1,
                       auto_pump=False, clock=clock)
    slack = fe.submit(_ctx(data, 0), k=2, deadline=100.0, tenant="a")
    tight = fe.submit(_ctx(data, 1), k=2, deadline=5.0, tenant="a")
    nodl = fe.submit(_ctx(data, 2), k=2, tenant="a")
    nodl2 = fe.submit(_ctx(data, 3), k=2, tenant="a")
    fe.flush()
    assert tight.done() and slack.done() and nodl.done() and not nodl2.done()
    assert tight.done_time <= slack.done_time
    fe.drain()
    for s, p in [(0, slack), (1, tight), (2, nodl), (3, nodl2)]:
        assert_reply(p.result(), states["a"], _ctx(data, s), 2)


def test_remove_tenant_drains_and_detaches_barrier():
    cfg, params, data = _base()
    rt, states = _tenants(cfg, params, data, ["a", "b"])
    fe = QueryFrontend(states, max_batch=8, max_k=4, max_wait=1e9)
    p = fe.submit(_ctx(data, 0), k=4, tenant="a")
    fe.remove_tenant("a")
    assert p.done() and states["a"].on_mutate is None and fe.tenants == ("b",)
    states["a"].add_items(data.ranking_query(2, 5)["item_ids"][0])
    pb = fe.submit(_ctx(data, 1), k=4)
    fe.drain()
    assert pb.result()[0].shape == (4,)


# -- packing ------------------------------------------------------------------

def _run_waves(fe, data, names, waves, k_of):
    pend = []
    for wave in range(waves):
        for t in names:
            for j in range(4):
                s = wave * 16 + j
                pend.append((fe.submit(_ctx(data, s), k=k_of(wave, t, j), tenant=t), t, s))
        fe.pump()
    fe.drain()
    return pend


@pytest.mark.parametrize("names,pack_max,caps,grow", [
    (["a", "b", "c", "d"], 4, 32, None),
    (["a", "b", "c"], 4, 32, None),           # 3 segments pad to a 4-segment launch
    (["a", "b", "c", "d", "e"], 8, 32, None),  # 5 segments pad to an 8-segment launch
    # the pack key leaves out the slab capacity: tenants whose slabs differ
    # in length, built so or doubled by autoscaling, share one launch
    (["a", "b", "c"], 4, (32, 64, 128), None),
    (["a", "b", "c"], 4, 32, "b"),
])
def test_packed_replies_equal_unpacked_bitwise(names, pack_max, caps, grow):
    cfg, params, data = _base()
    fes = []
    for pack in (True, False):
        _, states = _tenants(cfg, params, data, names, n=30 if grow else 20, capacity=caps)
        fes.append((QueryFrontend(states, max_batch=4, max_k=8, max_wait=1e9,
                                  auto_pump=False, pack=pack), states))
        if grow:
            assert states[grow].maybe_autoscale(0.9) and states[grow].capacity == 64
    rng = np.random.default_rng(2)
    ks = {}
    k_of = lambda w, t, j: ks.setdefault((w, t, j), int(rng.integers(1, 9)))  # noqa: E731
    (fe_p, st_p), (fe_u, _) = fes
    pend_p = _run_waves(fe_p, data, names, 3, k_of)
    pend_u = _run_waves(fe_u, data, names, 3, k_of)
    for (pp, t, s), (pu, _, _) in zip(pend_p, pend_u):
        pv, pi = pp.result()
        uv, ui = pu.result()
        np.testing.assert_array_equal(pv, uv)
        np.testing.assert_array_equal(pi, ui)
        assert_reply((pv, pi), st_p[t], _ctx(data, s), pp.k)
    assert fe_p.stats["fused_dispatches"] == 3
    assert fe_p.stats["fused_segments"] == 3 * len(names)
    assert fe_u.stats["fused_dispatches"] == 0
    h = fe_p.health()["packing"]
    assert h["enabled"] and h["pack_max"] == pack_max and h["mean_group"] > 1.0


def test_packed_single_tenant_traffic_uses_classic_path():
    cfg, params, data = _base()
    rt, states = _tenants(cfg, params, data, ["a", "b"])
    fe = QueryFrontend(states, max_batch=4, max_k=8, max_wait=1e9, auto_pump=False,
                       pack=True)
    pend = [fe.submit(_ctx(data, j), k=4, tenant="a") for j in range(4)]
    fe.pump()
    fe.drain()
    assert fe.stats["fused_dispatches"] == 0
    for j, p in enumerate(pend):
        assert_reply(p.result(), states["a"], _ctx(data, j), 4)


def test_packed_group_unpacks_when_k_exceeds_a_member():
    """A group whose common K bucket exceeds one member's live corpus is
    dispatched per tenant."""
    cfg, params, data = _base()
    rt, states = _tenants(cfg, params, data, ["a", "b"], n=20, capacity=32)
    states["b"].remove_items(list(range(14)))            # 6 live items left
    fe = QueryFrontend(states, max_batch=2, max_k=8, max_wait=1e9, auto_pump=False,
                       pack=True)
    pa = [fe.submit(_ctx(data, j), k=8, tenant="a") for j in range(2)]
    pb = [fe.submit(_ctx(data, j), k=4, tenant="b") for j in range(2)]
    fe.pump()
    fe.drain()
    assert fe.stats["fused_dispatches"] == 0 and fe.stats["dispatches"] == 2
    for j in range(2):
        assert_reply(pa[j].result(), states["a"], _ctx(data, j), 8)
        assert_reply(pb[j].result(), states["b"], _ctx(data, j), 4)


def test_warmup_packed_counts_the_grid():
    """One fused dispatch at the largest S, Bq and K bucket: nothing is
    traced, so no other shape needs a warm-up."""
    cfg, params, data = _base()
    rt, states = _tenants(cfg, params, data, ["a", "b", "c"])
    fe = QueryFrontend(states, max_batch=4, max_k=8, pack=True)
    assert fe.pack_max == 4
    assert fe.warmup_packed(_ctx(data, 0), tenant="a") == 1
    assert fe.warmup(_ctx(data, 0), tenant="b") == 1


def test_packed_replies_match_the_reference_packed_frontend():
    """The same request sequence through the JAX package's
    ``QueryFrontend(pack=True)`` and the port's, on the same weights and
    corpora: replies agree within the parity tolerance."""
    jcfg = jfwfm.FwFMConfig(layout=juniform(5, 4, 50), embed_dim=8, interaction="dplr",
                            rank=2)
    tcfg = _base()[0]
    jp = jfwfm.init(jax.random.PRNGKey(4), jcfg)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    data = SyntheticCTR(jcfg.layout, embed_dim=4, seed=0)
    names = ["a", "b", "c"]
    jrt = JRuntime(jcfg)
    jstates = {}
    for i, name in enumerate(names):
        q = data.ranking_query(20, 100 + i)
        jstates[name] = JState(jcfg, q["item_ids"][0], q["item_weights"][0], capacity=32,
                               runtime=jrt)
        jstates[name].refresh(jp, step=0)
    _, tstates = _tenants(tcfg, tp, data, names)
    rng = np.random.default_rng(6)
    ks = {}
    k_of = lambda w, t, j: ks.setdefault((w, t, j), int(rng.integers(1, 9)))  # noqa: E731
    kw = dict(max_batch=4, max_k=8, max_wait=1e9, auto_pump=False, pack=True)
    jfe, tfe = JFrontend(jstates, **kw), QueryFrontend(tstates, **kw)
    jpend = _run_waves(jfe, data, names, 2, k_of)
    tpend = _run_waves(tfe, data, names, 2, k_of)
    assert tfe.stats["fused_dispatches"] == jfe.stats["fused_dispatches"] == 2
    for (jq, t, s), (tq, _, _) in zip(jpend, tpend):
        wv, wi = jq.result()
        full = np.asarray(jstates[t].score(np.asarray(_ctx(data, s)).reshape(1, -1)))
        gv, gi = tq.result()
        assert_topk(gv[None], gi[None], np.asarray(wv)[None], np.asarray(wi)[None], full)


# -- self-healing: retries, breaker, pressure clamp, pump, health, close ----------

class Flaky:
    """Wraps ``engine.topk`` to raise on the next ``fails`` calls."""

    def __init__(self, engine, fails):
        self.fails = fails
        self.calls = 0
        self._topk = engine.topk
        engine.topk = self

    def __call__(self, *a, **kw):
        self.calls += 1
        if self.fails > 0:
            self.fails -= 1
            raise RuntimeError("injected launch failure")
        return self._topk(*a, **kw)


def test_failed_dispatch_retries_the_same_batch():
    _, _, data, engine = _engine(n=37)
    flaky = Flaky(engine, fails=2)
    fe = QueryFrontend(engine, max_batch=4, max_k=8, max_wait=1e9, retries=2,
                       retry_backoff=0.0)
    p = fe.submit(_ctx(data, 0), k=5)
    fe.drain()
    assert flaky.calls == 3 and fe.stats["retries"] == 2
    assert_reply(p.result(), engine, _ctx(data, 0), 5)
    Flaky(engine, fails=3)
    q = fe.submit(_ctx(data, 1), k=5)
    fe.drain()
    with pytest.raises(DispatchFailed) as err:
        q.result()
    assert err.value.attempts == 3 and fe.stats["failed"] == 1


def test_breaker_trips_sheds_and_recovers():
    _, _, data, engine = _engine(n=37)
    clock = FakeClock()
    fe = QueryFrontend(engine, max_batch=1, max_k=8, max_wait=1e9, retries=0,
                       breaker_threshold=2, breaker_cooldown=1.0, clock=clock)
    flaky = Flaky(engine, fails=3)
    for s in range(2):
        with pytest.raises(DispatchFailed):
            fe.submit(_ctx(data, s), k=2).result()
    assert fe.health()["tenants"]["default"]["breaker"] == "open" and fe.health()["degraded"]
    with pytest.raises(Degraded):
        fe.submit(_ctx(data, 2), k=2)
    clock.t = 1.5                            # half-open: the probe fails, re-opens
    with pytest.raises(DispatchFailed):
        fe.submit(_ctx(data, 3), k=2).result()
    assert fe.lane_stats()["trips"] == 2       # tripped, then re-opened
    clock.t = 3.0                            # the next probe succeeds
    p = fe.submit(_ctx(data, 4), k=2)
    assert_reply(p.result(), engine, _ctx(data, 4), 2)
    assert fe.health()["tenants"]["default"]["breaker"] == "closed"
    assert flaky.fails == 0 and not fe.health()["degraded"]


def test_read_failure_redispatches_the_same_batch():
    _, _, data, engine = _engine(n=37)
    fe = QueryFrontend(engine, max_batch=2, max_k=8, max_wait=1e9, retry_backoff=0.0)
    pend = [fe.submit(_ctx(data, s), k=3) for s in range(2)]
    fl = fe._window[-1]
    fl.vals = None                           # the read raises: re-dispatch
    fe.drain()
    for s, p in enumerate(pend):
        assert_reply(p.result(), engine, _ctx(data, s), 3)
    assert fe.stats["completed"] == 2


def test_pressure_clamp_serves_the_exact_prefix():
    _, _, data, engine = _engine(n=37)
    fe = QueryFrontend(engine, max_batch=2, max_k=8, max_wait=1e9, auto_pump=False,
                       pressure_depth=2, pressure_k=2)
    pend = [fe.submit(_ctx(data, s), k=8) for s in range(6)]
    fe.flush()
    fe.drain()
    clamped = [p for p in pend if p.degraded]
    assert clamped and fe.stats["clamped"] == len(clamped)
    for p in pend:
        scores, slots = p.result()
        assert p.served_k == (2 if p.degraded else 8) and scores.shape == (p.served_k,)
    s = pend.index(clamped[0])
    wv, wi = engine.topk(np.asarray(_ctx(data, s)).reshape(1, -1), 8)
    assert_topk(clamped[0].result()[0][None], clamped[0].result()[1][None], wv[:, :2],
                wi[:, :2], engine.score(np.asarray(_ctx(data, s)).reshape(1, -1)))


def test_autoscale_doubles_a_full_slab_at_a_pump_tick():
    _, _, data, engine = _engine(n=30, capacity=32)
    fe = QueryFrontend(engine, max_batch=4, max_k=4, max_wait=1e9, autoscale_high=0.9)
    fe.pump()
    assert engine.capacity == 64 and fe.stats["autoscales"] == 1
    fe.pump()
    assert engine.capacity == 64 and fe.stats["autoscales"] == 1


def test_pump_thread_serves_and_watchdog_restarts_a_stalled_pump():
    _, _, data, engine = _engine(n=37)
    fe = QueryFrontend(engine, max_batch=8, max_k=4, max_wait=0.0, auto_pump=False)
    stall = threading.Event()
    real_pump = fe.pump

    def pump(now=None):
        if stall.is_set():
            stall.clear()
            time.sleep(0.3)                  # one stalled tick
        return real_pump(now)

    fe.pump = pump
    try:
        fe.start_pump(interval=1e-3, watchdog=0.1)
        assert fe.health()["pump"]["running"]
        p = fe.submit(_ctx(data, 0), k=4)
        deadline = time.monotonic() + 10.0
        while fe.queue_depth and time.monotonic() < deadline:
            time.sleep(0.005)
        assert fe.queue_depth == 0           # the pump thread dispatched it
        assert p.result()[0].shape == (4,)
        stall.set()
        while fe.stats["pump_restarts"] == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fe.stats["pump_restarts"] >= 1
    finally:
        fe.stop_pump()
    assert not fe.health()["pump"]["running"]


def test_close_resolves_inflight_and_fails_queued_typed():
    _, _, data, engine = _engine(n=37)
    fe = QueryFrontend(engine, max_batch=2, max_k=4, max_wait=1e9, inflight=4,
                       auto_pump=False)
    flown = [fe.submit(_ctx(data, s), k=2) for s in range(2)]
    fe.pump()
    queued = fe.submit(_ctx(data, 5), k=2)
    fe.close()
    for p in flown:
        assert p.result()[0].shape == (2,)
    with pytest.raises(Unservable, match="closed"):
        queued.result()
    with pytest.raises(Unservable):
        fe.submit(_ctx(data, 0), k=2)
    assert engine.on_mutate is None
    h = fe.health()
    assert h["closed"] and not h["ready"] and h["queue_depth"] == 0
    assert set(h["tenants"]["default"]) >= {"breaker", "queued", "n_items", "model_step",
                                            "refresh_age"}
    fe.close()                               # idempotent


@pytest.mark.parametrize("barrier,dispatcher", [("drain", "pump"), ("drain", "thread"),
                                                ("close", "pump"), ("close", "thread"),
                                                ("result", "thread")])
def test_barrier_waits_for_a_dispatch_that_is_backing_off(barrier, dispatcher):
    """A dispatch on another thread (the pump, or a thread calling ``flush``)
    faults once and backs off (0.1-0.3 s), which releases the lock while its
    batch is in neither the queue nor the window; ``drain``/``close`` called
    then from this thread return only once that batch is resolved, every
    request done with its real reply, and ``result()`` of one of its
    requests waits for it (rather than raising ``Unservable``).  (``close``
    joins the pump thread before it takes the lock, so its pump case holds
    on the parent too.)"""
    _, _, data, engine = _engine(n=37)
    inj = FaultInjector(seed=0)
    fe = QueryFrontend(engine, max_batch=4, max_k=8, max_wait=0.0, auto_pump=False,
                       retries=2, retry_backoff=0.2, fault_injector=inj)
    inj.arm("dispatch", count=1)
    pend = [fe.submit(_ctx(data, s), k=5) for s in range(3)]   # one batch
    worker = None
    try:
        if dispatcher == "pump":
            fe.start_pump(interval=1e-3)
        else:
            worker = threading.Thread(target=fe.flush)
            worker.start()
        deadline = time.monotonic() + 10.0
        while inj.fired("dispatch") < 1 and time.monotonic() < deadline:
            time.sleep(1e-3)
        assert inj.fired("dispatch") == 1    # the dispatch is backing off
        if barrier == "result":
            pend[0].result()
        else:
            getattr(fe, barrier)()
        assert all(p.done() for p in pend)
    finally:
        fe.stop_pump()
        if worker is not None:
            worker.join(timeout=10.0)
    assert fe.stats["retries"] == 1 and fe.stats["failed"] == 0
    for s, p in enumerate(pend):
        assert_reply(p.result(), engine, _ctx(data, s), 5)

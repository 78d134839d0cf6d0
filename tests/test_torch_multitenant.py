"""Multi-tenant serving in the port, on the CPU, against the JAX package.

``ops.dplr_corpus_score_multi`` (its plain version here) against the JAX
package's multi-segment Pallas kernel (interpret mode) and oracle; tenants
on one shared ``ScorerRuntime`` against dedicated engines; ``fused_topk``
against the JAX package's ``fused_topk`` on the same weights (carried over
with ``interop.params_from_numpy``).  Inputs are made with numpy from a
seed.  Tolerance: atol = rtol = 1e-5, ids equal except between scores tied
within that; within the port (same code, same shapes) results are
compared bitwise."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.fields import uniform_layout as juniform  # noqa: E402
from repro.data.synthetic_ctr import SyntheticCTR  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.recsys import fwfm as jfwfm  # noqa: E402
from repro.serving import CorpusState as JState  # noqa: E402
from repro.serving import ScorerRuntime as JRuntime  # noqa: E402
from repro.serving.engine import fused_topk as jfused_topk  # noqa: E402
from repro_torch.core.fields import uniform_layout  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.dplr_corpus_score import MAX_SEGMENTS  # noqa: E402
from repro_torch.models.recsys import fwfm  # noqa: E402
from repro_torch.serving.corpus import item_addend  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    CorpusRankingEngine,
    CorpusState,
    fused_topk,
)
from repro_torch.serving.errors import NotReady  # noqa: E402
from repro_torch.serving.runtime import ScorerRuntime  # noqa: E402

from test_torch_parity import assert_topk, corpus_inputs, to_np  # noqa: E402


def _segments(ns, masked, Bq=2, rho=3, k=8, seed=30):
    """numpy inputs of S segments, stacked for both packages."""
    parts = [corpus_inputs(seed + s, n, rho, k, Bq) for s, n in enumerate(ns)]
    Q = tuple(p[0] for p in parts)
    a = tuple(p[1] for p in parts)
    valid = tuple(p[5] for p in parts) if masked else None
    e, PC, aC = (np.stack([p[j] for p in parts]) for j in (2, 3, 4))
    return parts, (Q, a, valid, e, PC, aC)


def _jax(args):
    Q, a, valid, e, PC, aC = args
    return (tuple(map(jnp.asarray, Q)), tuple(map(jnp.asarray, a)),
            None if valid is None else tuple(map(jnp.asarray, valid)),
            jnp.asarray(e), jnp.asarray(PC), jnp.asarray(aC))


def _torch(args):
    Q, a, valid, e, PC, aC = args
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    return (tuple(map(t, Q)), tuple(map(t, a)),
            None if valid is None else tuple(map(t, valid)), t(e), t(PC), t(aC))


# -- the kernel entry point ---------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ns", [(64, 64), (100, 37, 64)])
def test_multi_matches_pallas_kernel_and_oracle(ns, masked):
    K = 7
    parts, args = _segments(ns, masked)
    jargs, targs = _jax(args), _torch(args)
    vals, ids = ops.dplr_corpus_score_multi(*targs, topk=K)
    assert vals.shape == ids.shape == (len(ns), 2, K) and ids.dtype == torch.int32
    want_pallas = jops.dplr_corpus_score_multi(*jargs, topk=K, block_n=32)
    want_oracle = jref.dplr_corpus_multi_topk_ref(*jargs, K)
    mine = ref.dplr_corpus_multi_topk_ref(*targs, K)
    for s, (Q, a_I, e, PC, aC, valid) in enumerate(parts):
        full = jref.dplr_corpus_score_ref(Q, a_I, e, PC, aC, valid if masked else None)
        for want_v, want_i in (want_pallas, want_oracle):
            assert_topk(vals[s], ids[s], np.asarray(want_v)[s], np.asarray(want_i)[s], full)
        assert torch.equal(vals[s], mine[0][s]) and torch.equal(ids[s], mine[1][s])
        # row [s] is the single-segment top-K of segment s, bitwise
        one = ops.dplr_corpus_score(*(torch.from_numpy(x) for x in (Q, a_I, e, PC, aC)),
                                    valid=torch.from_numpy(valid) if masked else None,
                                    topk=K)
        assert torch.equal(vals[s], one[0]) and torch.equal(ids[s], one[1])


def test_multi_relabels_segment_local_ids():
    parts, args = _segments((50, 80), True)
    vals, ids = ops.dplr_corpus_score_multi(*_torch(args), topk=5, index_offset=3,
                                            index_stride=4)
    want_v, want_i = jops.dplr_corpus_score_multi(*_jax(args), topk=5, block_n=16,
                                                  index_offset=3, index_stride=4)
    for s, (Q, a_I, e, PC, aC, valid) in enumerate(parts):
        full = jref.dplr_corpus_score_ref(Q, a_I, e, PC, aC, valid)
        assert_topk(vals[s], ids[s], np.asarray(want_v)[s], np.asarray(want_i)[s], full,
                    offset=3, stride=4)


def test_multi_segment_isolation():
    """A segment's winners never come from a neighbour, even one that
    dominates by 1e6, and ids are segment-local."""
    n0, n1, K = 37, 64, 5
    parts, args = _segments((n0, n1), False, rho=2, k=4)
    Q, a, valid, e, PC, aC = args
    a = (a[0], a[1] + 1e6)
    vals, ids = ops.dplr_corpus_score_multi(*_torch((Q, a, valid, e, PC, aC)), topk=K)
    ids = to_np(ids)
    assert (0 <= ids[0]).all() and (ids[0] < n0).all()
    assert (0 <= ids[1]).all() and (ids[1] < n1).all()
    assert to_np(vals)[0].max() < 1e5
    want = jops.dplr_corpus_score_multi(*_jax((Q, a, valid, e, PC, aC)), topk=K,
                                        block_n=16)
    full0 = jref.dplr_corpus_score_ref(*parts[0][:5])
    assert_topk(vals[0], ids[0], np.asarray(want[0])[0], np.asarray(want[1])[0], full0)


def test_multi_validates():
    _, args = _segments((32,), False)
    Q, a, _, e, PC, aC = _torch(args)
    with pytest.raises(ValueError, match=">= 1 segment"):
        ops.dplr_corpus_score_multi((), (), None, e, PC, aC, topk=4)
    with pytest.raises(ValueError, match="segment-count mismatch"):
        ops.dplr_corpus_score_multi(Q * 2, a, None, e.repeat(2, 1), PC.repeat(2, 1, 1, 1),
                                    aC.repeat(2, 1), topk=4)
    with pytest.raises(ValueError, match="topk=33 out of range for smallest segment"):
        ops.dplr_corpus_score_multi(Q, a, None, e, PC, aC, topk=33)
    with pytest.raises(ValueError, match="shape"):
        ops.dplr_corpus_score_multi(Q, (a[0][:5],), None, e, PC, aC, topk=4)
    S = MAX_SEGMENTS + 1          # past the kernel's limit: the CPU answers
    vals, ids = ops.dplr_corpus_score_multi(Q * S, a * S, None, e.repeat(S, 1),
                                            PC.repeat(S, 1, 1, 1), aC.repeat(S, 1), topk=4)
    assert vals.shape == ids.shape == (S, PC.shape[1], 4)
    assert all(torch.equal(ids[s], ids[0]) for s in range(S))
    ops.reset_launches()
    ops.dplr_corpus_score_multi(Q, a, None, e, PC, aC, topk=4)
    assert sum(ops.LAUNCHES.values()) == 0       # the CPU runs no kernel


# -- shared runtime, fused_topk -----------------------------------------------

def _cfgs():
    jcfg = jfwfm.FwFMConfig(layout=juniform(5, 4, 50), embed_dim=8, interaction="dplr",
                            rank=2)
    tcfg = fwfm.FwFMConfig(layout=uniform_layout(5, 4, 50), embed_dim=8,
                           interaction="dplr", rank=2)
    return jcfg, tcfg, SyntheticCTR(jcfg.layout, embed_dim=4, seed=0)


def _params(jcfg, seed=0):
    jp = jfwfm.init(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")


def _tenants(tcfg, tp, data, ns, runtime, capacity=64):
    states = []
    for i, n in enumerate(ns):
        q = data.ranking_query(n, 100 + i)
        st = CorpusState(tcfg if runtime is None else runtime.cfg, q["item_ids"][0],
                         q["item_weights"][0], capacity=capacity, runtime=runtime,
                         device="cpu" if runtime is None else None)
        st.refresh(tp, step=0)
        states.append(st)
    return states


def _ctx(data, s, bq=1):
    return np.concatenate([data.context_query(s + j)["context_ids"] for j in range(bq)])


@pytest.mark.parametrize("Bq", [1, 3])
def test_shared_runtime_tenants_equal_dedicated_engines(Bq):
    _, tcfg, data = _cfgs()
    _, tp = _params(_cfgs()[0])
    rt = ScorerRuntime(tcfg, device="cpu")
    shared = _tenants(tcfg, tp, data, (20, 30, 40), rt)
    dedicated = _tenants(tcfg, tp, data, (20, 30, 40), None)
    ctx = _ctx(data, 0, Bq)
    for st, ded in zip(shared, dedicated):
        assert st.runtime is rt and ded.runtime is not rt
        assert torch.equal(st.score(ctx), ded.score(ctx))
        for a, b in zip(st.topk(ctx, 7), ded.topk(ctx, 7)):
            assert torch.equal(a, b)


def test_shared_runtime_churn_keeps_tenants_independent():
    """Churn on tenant a leaves tenant b bitwise untouched; the same churn
    on b and on a dedicated twin keeps them equal."""
    _, tcfg, data = _cfgs()
    _, tp = _params(_cfgs()[0])
    a, b = _tenants(tcfg, tp, data, (20, 20), ScorerRuntime(tcfg, device="cpu"),
                    capacity=32)
    _, ded = _tenants(tcfg, tp, data, (20, 20), None, capacity=32)
    before = b.score(_ctx(data, 1))
    added = a.add_items(data.ranking_query(5, 7)["item_ids"][0])
    a.remove_items([0, 2, int(added[1])])
    upd = data.ranking_query(2, 8)
    a.update_items([1, 3], upd["item_ids"][0], upd["item_weights"][0])
    assert torch.equal(b.score(_ctx(data, 1)), before)
    for e in (b, ded):
        e.add_items(data.ranking_query(5, 9)["item_ids"][0])
        e.remove_items([1, 4])
    assert torch.equal(b.score(_ctx(data, 2)), ded.score(_ctx(data, 2)))
    np.testing.assert_array_equal(b.valid_slots, ded.valid_slots)


def test_corpus_state_runtime_mismatch_rejected():
    jcfg, tcfg, data = _cfgs()
    other = fwfm.FwFMConfig(layout=uniform_layout(5, 4, 50), embed_dim=8,
                            interaction="dplr", rank=2)
    rt = ScorerRuntime(tcfg, device="cpu")
    ids = data.ranking_query(8, 0)["item_ids"][0]
    with pytest.raises(ValueError, match="different config"):
        CorpusState(other, ids, runtime=rt)
    with pytest.raises(ValueError, match="device is a runtime property"):
        CorpusState(tcfg, ids, runtime=rt, device="meta")
    assert CorpusState(None, ids, runtime=rt).cfg is tcfg


@pytest.mark.parametrize("mode", [{}, {"use_pallas_kernel": True, "block_n": 16}])
@pytest.mark.parametrize("Bq,K", [(1, 4), (4, 8)])
def test_fused_topk_matches_reference_fused_topk(mode, Bq, K):
    jcfg, tcfg, data = _cfgs()
    jp, tp = _params(jcfg, seed=3)
    ns = (20, 35, 50)
    jrt = JRuntime(jcfg, **mode)
    jstates = []
    for i, n in enumerate(ns):
        q = data.ranking_query(n, 100 + i)
        st = JState(jcfg, q["item_ids"][0], q["item_weights"][0], capacity=64,
                    runtime=jrt)
        st.refresh(jp, step=0)
        jstates.append(st)
    tstates = _tenants(tcfg, tp, data, ns, ScorerRuntime(tcfg, device="cpu"))
    ctx = np.stack([_ctx(data, 10 * s, Bq) for s in range(len(ns))])
    want_v, want_i = jfused_topk(jstates, ctx, K)
    vals, ids = fused_topk(tstates, ctx, K)
    assert vals.shape == ids.shape == (len(ns), Bq, K) and ids.dtype == torch.int32
    for s, (jst, tst) in enumerate(zip(jstates, tstates)):
        full = np.asarray(jst.score(ctx[s]))
        assert_topk(vals[s], ids[s], np.asarray(want_v)[s], np.asarray(want_i)[s], full)
        one = tst.topk(ctx[s], K)
        assert torch.equal(vals[s], one[0]) and torch.equal(ids[s], one[1])
        assert tst.is_live(to_np(ids[s])).all()


def test_fused_topk_validates():
    _, tcfg, data = _cfgs()
    _, tp = _params(_cfgs()[0])
    rt = ScorerRuntime(tcfg, device="cpu")
    a, b = _tenants(tcfg, tp, data, (20, 30), rt)
    (c,) = _tenants(tcfg, tp, data, (20,), None)
    ctx = np.stack([_ctx(data, 0), _ctx(data, 1)])
    with pytest.raises(ValueError, match="at least one state"):
        fused_topk([], ctx, 4)
    with pytest.raises(ValueError, match="share one ScorerRuntime"):
        fused_topk([a, c], ctx, 4)
    with pytest.raises(ValueError, match="out of range"):
        fused_topk([a, b], ctx, 21)
    with pytest.raises(ValueError, match="stack to"):
        fused_topk([a, b], ctx[0], 4)
    q = data.ranking_query(10, 5)
    cold = CorpusState(None, q["item_ids"][0], runtime=rt)
    with pytest.raises(NotReady):
        fused_topk([a, cold], ctx, 4)


def test_slab_stores_its_item_addend():
    """``a_I`` is stored when rows are built, written or grown, equal
    bitwise to ``lin_I + 0.5 * t_I`` on every slot."""
    _, tcfg, data = _cfgs()
    _, tp = _params(_cfgs()[0])
    (st,) = _tenants(tcfg, tp, data, (30,), None, capacity=32)
    check = lambda: torch.equal(st.cache.a_I, item_addend(st.cache.t_I,  # noqa: E731
                                                          st.cache.lin_I))
    assert check() and st.cache.a_I.shape == (32,)
    st.update_items([1, 2], data.ranking_query(2, 3)["item_ids"][0])
    assert check()
    st.add_items(data.ranking_query(9, 4)["item_ids"][0])      # 39 > 32: grows
    assert st.capacity == 64 and st.cache.a_I.shape == (64,)
    assert torch.equal(st.cache.a_I[:39], item_addend(st.cache.t_I, st.cache.lin_I)[:39])


def test_occupancy_autoscale_and_warmup_grid():
    _, tcfg, data = _cfgs()
    _, tp = _params(_cfgs()[0])
    q = data.ranking_query(30, 0)
    st = CorpusRankingEngine(tcfg, q["item_ids"][0], capacity=32, device="cpu")
    assert st.maybe_autoscale(0.5) is False            # no model yet
    st.refresh(tp)
    assert st.occupancy == 30 / 32
    calls = []
    st.on_mutate = lambda: calls.append(1)
    assert st.maybe_autoscale(0.99) is False
    assert st.maybe_autoscale(0.9) is True and calls == [1]
    assert st.capacity == 64 and st.occupancy == 30 / 64 and st.n_items == 30
    with pytest.raises(ValueError, match="outside"):
        st.maybe_autoscale(0.0)
    # one dispatch at the largest corner, Bq 4 x K 8
    assert st.warmup_grid(_ctx(data, 0), max_batch=4, max_k=5) == 1

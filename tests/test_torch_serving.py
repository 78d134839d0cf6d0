"""The port's ``CorpusState`` (on the CPU) against the JAX package's
``CorpusRankingEngine``, in its jnp mode and its Pallas mode (interpret,
block_n = 16), with one set of weights carried over through numpy: scores,
top-K, the capacity padding, churn with growth past capacity, and model
refresh.  Slot assignments must be identical; scores agree within
atol = rtol = 1e-5, top-K ids except between scores tied within that."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.fields import uniform_layout as juniform  # noqa: E402
from repro.data.synthetic_ctr import SyntheticCTR  # noqa: E402
from repro.models.recsys import fwfm as jfwfm  # noqa: E402
from repro.serving import CorpusRankingEngine as JEngine  # noqa: E402
from repro_torch.core.fields import uniform_layout  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels.dplr_corpus_score import NEG_INF  # noqa: E402
from repro_torch.models.recsys import fwfm  # noqa: E402
from repro_torch.serving.engine import CorpusRankingEngine, CorpusState  # noqa: E402
from repro_torch.serving.errors import NotReady  # noqa: E402

from test_torch_parity import assert_scores, assert_topk, to_np  # noqa: E402

MODES = {"jnp": {}, "pallas": {"use_pallas_kernel": True, "block_n": 16}}


def _setup(n=37, seed=0):
    jcfg = jfwfm.FwFMConfig(layout=juniform(5, 4, 50), embed_dim=8, interaction="dplr",
                            rank=2)
    tcfg = fwfm.FwFMConfig(layout=uniform_layout(5, 4, 50), embed_dim=8,
                           interaction="dplr", rank=2)
    data = SyntheticCTR(jcfg.layout, embed_dim=4, seed=seed)
    q = data.ranking_query(n, seed)
    ctx = np.concatenate([data.ranking_query(n, 100 + b)["context_ids"] for b in range(3)])
    return jcfg, tcfg, data, q, ctx


def _params(jcfg, seed):
    jp = jfwfm.init(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")


def _assert_same(jeng, teng, ctx, K=5):
    assert teng.capacity == jeng.capacity and teng.n_items == jeng.n_items
    np.testing.assert_array_equal(teng.valid_slots, jeng.valid_slots)
    full = np.asarray(jeng.score(ctx))
    got = teng.score(ctx)
    assert got.shape == (ctx.shape[0], teng.capacity)
    assert_scores(got, full)
    dead = ~teng.is_live(np.arange(teng.capacity))
    assert np.all(to_np(got)[:, dead] == NEG_INF)
    vals, ids = teng.topk(ctx, K)
    assert ids.dtype == torch.int32
    assert_topk(vals, ids, *jeng.topk(ctx, K), full)
    assert teng.is_live(to_np(ids)).all()


@pytest.mark.parametrize("mode", MODES)
def test_engine_scores_and_pads_like_reference(mode):
    jcfg, tcfg, _, q, ctx = _setup()
    jp, tp = _params(jcfg, 0)
    jeng = JEngine(jcfg, q["item_ids"][0], q["item_weights"][0], **MODES[mode])
    teng = CorpusState(tcfg, q["item_ids"][0], q["item_weights"][0], device="cpu")
    jeng.refresh(jp)
    teng.refresh(tp)
    # 37 items round up to a 64-slot slab; the dead tail is exactly NEG_INF
    assert teng.capacity == 64 and teng.n_items == 37
    assert np.all(to_np(teng.score(ctx))[:, 37:] == -1e30)
    _assert_same(jeng, teng, ctx, K=1)
    _assert_same(jeng, teng, ctx, K=16)


@pytest.mark.parametrize("mode", MODES)
def test_churn_growth_and_refresh_match_reference(mode):
    jcfg, tcfg, data, q, ctx = _setup()
    jp, tp = _params(jcfg, 0)
    jeng = JEngine(jcfg, q["item_ids"][0], q["item_weights"][0], **MODES[mode])
    teng = CorpusRankingEngine(tcfg, q["item_ids"][0], q["item_weights"][0], device="cpu")
    jeng.refresh(jp)
    teng.refresh(tp)
    new = data.ranking_query(40, 7)["item_ids"][0]

    np.testing.assert_array_equal(teng.add_items(new[:10]), jeng.add_items(new[:10]))
    _assert_same(jeng, teng, ctx)
    gone = [0, 5, 38, 46]
    jeng.remove_items(gone)
    teng.remove_items(gone)
    _assert_same(jeng, teng, ctx)
    jeng.update_items([1, 40], new[10:12])
    teng.update_items([1, 40], new[10:12])
    _assert_same(jeng, teng, ctx)
    # 47 - 4 + 28 = 71 live items: the 64-slot slab doubles
    slots = teng.add_items(new[12:])
    np.testing.assert_array_equal(slots, jeng.add_items(new[12:]))
    assert teng.capacity == 128
    _assert_same(jeng, teng, ctx)

    jp2, tp2 = _params(jcfg, 1)
    jeng.refresh(jp2, step=1)
    teng.refresh(tp2, step=1)
    _assert_same(jeng, teng, ctx)
    assert teng.model_step == 1 and teng.refresh_count == 2


@pytest.mark.parametrize("Bq", [1, 3])
def test_engine_score_equals_rank_items(Bq):
    jcfg, tcfg, _, q, ctx = _setup()
    _, tp = _params(jcfg, 0)
    teng = CorpusState(tcfg, q["item_ids"][0], q["item_weights"][0], device="cpu")
    teng.refresh(tp)
    qb = {"context_ids": torch.from_numpy(ctx[:Bq]),
          "context_weights": torch.ones(ctx[:Bq].shape),
          "item_ids": torch.from_numpy(np.repeat(q["item_ids"], Bq, 0)),
          "item_weights": torch.from_numpy(np.repeat(q["item_weights"], Bq, 0))}
    assert_scores(teng.score(ctx[:Bq])[:, :37], fwfm.rank_items(tp, tcfg, qb))


def test_engine_rejects_bad_requests():
    jcfg, tcfg, _, q, ctx = _setup()
    _, tp = _params(jcfg, 0)
    teng = CorpusState(tcfg, q["item_ids"][0], device="cpu")
    with pytest.raises(NotReady):
        teng.score(ctx)
    with pytest.raises(NotReady):
        teng.add_items(q["item_ids"][0][:1])
    teng.refresh(tp)
    for K in (0, 38):
        with pytest.raises(ValueError, match="out of range"):
            teng.topk(ctx, K)
    teng.remove_items([3])
    with pytest.raises(ValueError, match="live"):
        teng.update_items([3], q["item_ids"][0][:1])
    with pytest.raises(ValueError, match="duplicate"):
        teng.remove_items([4, 4])
    with pytest.raises(ValueError, match="item rows"):
        teng.update_items([4, 6], q["item_ids"][0][:1])
    with pytest.raises(ValueError, match="power of two"):
        CorpusState(tcfg, q["item_ids"][0], capacity=48, device="cpu")


def test_on_mutate_runs_before_every_write():
    jcfg, tcfg, data, q, _ = _setup()
    _, tp = _params(jcfg, 0)
    teng = CorpusState(tcfg, q["item_ids"][0], device="cpu")
    calls = []
    teng.on_mutate = lambda: calls.append(teng.n_items)
    teng.refresh(tp)
    slots = teng.add_items(data.ranking_query(2, 3)["item_ids"][0])
    teng.update_items(slots[:1], q["item_ids"][0][:1])
    teng.remove_items(slots)
    assert calls == [37, 37, 39, 39]

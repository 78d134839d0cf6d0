"""The port's eval package (``repro_torch.eval``) against the float64
oracles and the JAX package's harness.

* every metric against the port's ``eval/ref.py`` oracles at 1e-6, on
  fixed seeded cases and the conventions' edges (ties, one class, empty
  inputs, k > n, zero-relevance queries); the port's oracles against the
  JAX package's own;
* ``MetricAccumulator``: exact folding, independent of batch order;
* ``score_split``, ``evaluate_pointwise``, ``evaluate_streaming``,
  ``ranking_eval_set`` and ``model_scores`` (DPLR, full and pruned FwFM)
  against the JAX harness at atol = rtol = 1e-5, with JAX's weights;
* ``serving_parity`` on the CPU: model, engine and frontend agree.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import pruning as jpruning  # noqa: E402
from repro.core.fields import uniform_layout as juniform  # noqa: E402
from repro.data.synthetic_ctr import SyntheticCTR as JSyntheticCTR  # noqa: E402
from repro.eval import harness as jharness  # noqa: E402
from repro.eval import ref as jref  # noqa: E402
from repro.models.recsys import fwfm as jfwfm  # noqa: E402
from repro_torch.core import pruning  # noqa: E402
from repro_torch.core.fields import uniform_layout  # noqa: E402
from repro_torch.data.synthetic_ctr import SyntheticCTR  # noqa: E402
from repro_torch.eval import harness  # noqa: E402
from repro_torch.eval import metrics as M  # noqa: E402
from repro_torch.eval import ref  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models.recsys import fwfm  # noqa: E402

from test_torch_parity import TOL, assert_scores  # noqa: E402

METRIC_TOL = 1e-6


def _close(got, want, tol=METRIC_TOL):
    got, want = float(got), float(want)
    if math.isinf(want):
        assert math.isinf(got) and got > 0
    else:
        assert abs(got - want) <= tol, (got, want)


# -- metrics against the oracles ---------------------------------------------------

POINTWISE = ["random", "ties", "all_tie", "one_class", "float_labels", "empty", "one"]


def _pointwise(case: str):
    rng = np.random.default_rng(POINTWISE.index(case))
    n = {"empty": 0, "one": 1}.get(case, 3000)
    labels = (rng.random(n) < 0.3).astype(np.int32)
    logits = rng.normal(scale=3.0, size=n).astype(np.float32)
    if case == "ties":
        logits = np.round(logits).astype(np.float32)          # many exact ties
    elif case == "all_tie":
        logits[:] = 0.25
    elif case == "one_class":
        labels[:] = 0
    elif case == "float_labels":
        labels = labels.astype(np.float32)
    return labels, logits


@pytest.mark.parametrize("case", POINTWISE)
def test_pointwise_metrics_match_oracles(case):
    labels, logits = _pointwise(case)
    y, z = torch.from_numpy(labels), torch.from_numpy(logits)
    _close(M.auc(y, z), ref.auc_ref(labels, logits))
    _close(M.logloss(y, z), ref.logloss_ref(labels, logits))
    _close(M.calibration_ratio(y, z), ref.calibration_ratio_ref(labels, logits))
    # the copied oracles are the JAX package's
    assert ref.auc_ref(labels, logits) == jref.auc_ref(labels, logits)
    assert ref.logloss_ref(labels, logits) == jref.logloss_ref(labels, logits)


def test_auc_known_values_and_large_n_exact():
    y = torch.tensor([0, 0, 1, 1])
    assert float(M.auc(y, torch.tensor([0.0, 1.0, 2.0, 3.0]))) == 1.0
    assert float(M.auc(y, torch.tensor([3.0, 2.0, 1.0, 0.0]))) == 0.0
    assert float(M.auc(y, torch.tensor([0.0, 2.0, 1.0, 3.0]))) == 0.75
    # beyond the int32-exact bound of the JAX metric: int64 sums stay exact
    labels, logits = _pointwise("random")
    big_y = np.tile(labels, 20)
    big_z = (np.tile(logits, 20) + np.repeat(np.arange(20), 3000) * 1e-3).astype(np.float32)
    _close(M.auc(torch.from_numpy(big_y), torch.from_numpy(big_z)), ref.auc_ref(big_y, big_z))


def _ranking(case: str):
    rng = np.random.default_rng(7)
    B, n = (0, 5) if case == "empty" else (6, 40)
    rels = rng.random((B, n)).astype(np.float32)
    rels[rels < 0.6] = 0.0
    scores = rng.standard_normal((B, n)).astype(np.float32)
    if case == "ties":
        scores = np.round(scores).astype(np.float32)
    elif case == "zero_rel" and B:
        rels[2] = 0.0
    elif case == "binary":
        rels = (rels > 0).astype(np.float32)
    return rels, scores


@pytest.mark.parametrize("case", ["random", "ties", "zero_rel", "binary", "empty"])
@pytest.mark.parametrize("k", [1, 5, 40, 100])
def test_ranking_metrics_match_oracles(case, k):
    rels, scores = _ranking(case)
    r, s = torch.from_numpy(rels), torch.from_numpy(scores)
    _close(M.ndcg_at_k(r, s, k=k), ref.ndcg_at_k_ref(rels, scores, k))
    _close(M.precision_at_k(r, s, k=k), ref.precision_at_k_ref(rels, scores, k))
    _close(M.recall_at_k(r, s, k=k), ref.recall_at_k_ref(rels, scores, k))
    _close(M.mrr(r, s), ref.mrr_ref(rels, scores))
    assert ref.ndcg_at_k_ref(rels, scores, k) == jref.ndcg_at_k_ref(rels, scores, k)
    got = M.ranking_partials(r, s, k=k)
    want = ref.ranking_partials_ref(rels, scores, k)
    assert int(got["n_queries"]) == want["n_queries"]
    for key in ("ndcg_sum", "prec_sum", "rec_sum", "mrr_sum"):
        _close(got[key], want[key], METRIC_TOL * max(1, want["n_queries"]))


def test_ranking_ties_go_to_the_lowest_index():
    rels = torch.tensor([[0.0, 1.0, 0.0, 1.0]])
    tied = torch.tensor([[2.0, 2.0, 2.0, 2.0]])
    assert float(M.mrr(rels, tied)) == 0.5              # index 1 is second
    assert float(M.precision_at_k(rels, tied, k=1)) == 0.0
    with pytest.raises(ValueError, match=r"\(B, n\)"):
        M.mrr(rels[0], tied[0])


@pytest.mark.parametrize("case", ["random", "ties", "one_class"])
def test_pointwise_partials_match_oracle(case):
    labels, logits = _pointwise(case)
    got = M.pointwise_partials(torch.from_numpy(labels), torch.from_numpy(logits))
    want = ref.pointwise_partials_ref(labels, logits)
    assert int(got["n"]) == want["n"] and int(got["n_pos"]) == want["n_pos"]
    _close(got["bce_sum"] / want["n"], want["bce_sum"] / want["n"])
    _close(got["p_sum"] / want["n"], want["p_sum"] / want["n"])
    # a 1-ulp sigmoid difference may move a count to the next bin
    pos, neg = got["pos_hist"].numpy(), got["neg_hist"].numpy()
    assert pos.sum() == want["pos_hist"].sum() and neg.sum() == want["neg_hist"].sum()
    assert np.abs(pos - want["pos_hist"]).sum() <= 2
    assert abs(ref.binned_auc(pos, neg)
               - ref.binned_auc(want["pos_hist"], want["neg_hist"])) <= 1e-3


def test_accumulator_folds_exactly_in_any_order():
    labels, logits = _pointwise("random")
    rels, scores = _ranking("random")
    chunks = [(labels[i:i + 700], logits[i:i + 700]) for i in range(0, 3000, 700)]
    whole = M.MetricAccumulator(k=5)
    for y, z in chunks:
        whole.update(y, z)
    whole.update_ranking(rels[:3], scores[:3])
    whole.update_ranking(rels[3:], scores[3:])
    rev = M.MetricAccumulator(k=5)
    for y, z in reversed(chunks):
        rev.update(torch.from_numpy(y), torch.from_numpy(z))
    half = M.MetricAccumulator(k=5)
    half.update_ranking(rels[:3], scores[:3])
    other = M.MetricAccumulator(k=5)
    other.update_ranking(rels[3:], scores[3:])
    rev.merge(half.merge(other))
    assert rev.result() == whole.result()
    res = whole.result()
    assert res["n"] == 3000 and res["n_queries"] == 6
    _close(res["logloss"], ref.logloss_ref(labels, logits))
    _close(res["ndcg@5"], ref.ndcg_at_k_ref(rels, scores, 5))
    assert abs(res["auc"] - ref.auc_ref(labels, logits)) <= 5e-3
    with pytest.raises(ValueError, match="different k"):
        whole.merge(M.MetricAccumulator(k=3))


# -- the harness against the JAX harness -----------------------------------------

def _setup(interaction="dplr", seed=0):
    jlay, tlay = juniform(5, 4, 50), uniform_layout(5, 4, 50)
    jcfg = jfwfm.FwFMConfig(layout=jlay, embed_dim=8, interaction=interaction, rank=2)
    tcfg = fwfm.FwFMConfig(layout=tlay, embed_dim=8, interaction=interaction, rank=2)
    jparams = jfwfm.init(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return (jcfg, jparams, JSyntheticCTR(jlay, embed_dim=4, seed=seed),
            tcfg, tparams, SyntheticCTR(tlay, embed_dim=4, seed=seed))


def _pruned(jcfg, jparams):
    R = np.asarray(jfwfm.field_matrix(jparams, jcfg))
    m = jcfg.layout.n_fields
    return jpruning.prune_matched(R, m, 2), pruning.prune_matched(R.copy(), m, 2)


@pytest.mark.parametrize("interaction,pruned", [("dplr", False), ("fwfm", False),
                                                ("fwfm", True)])
def test_score_split_and_pointwise_eval_match_reference(interaction, pruned):
    jcfg, jparams, jdata, tcfg, tparams, tdata = _setup(interaction)
    jmask = tmask = None
    if pruned:
        jp, tp = _pruned(jcfg, jparams)
        jmask, tmask = jp.mask, tp.mask
    kw = dict(n=500, batch_size=128)
    jy, jz = jharness.score_split(jparams, jcfg, jdata, pruned_mask=jmask, **kw)
    ty, tz = harness.score_split(tparams, tcfg, tdata, pruned_mask=tmask, **kw)
    assert ty.dtype == np.int32 and tz.dtype == np.float32 and tz.shape == (500,)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_allclose(tz, jz, **TOL)
    _, whole = harness.score_split(tparams, tcfg, tdata, pruned_mask=tmask, n=500,
                                   batch_size=500)
    np.testing.assert_allclose(tz, whole, **TOL)
    for fn in ("evaluate_pointwise", "evaluate_streaming"):
        want = getattr(jharness, fn)(jparams, jcfg, jdata, pruned_mask=jmask, **kw)
        got = getattr(harness, fn)(tparams, tcfg, tdata, pruned_mask=tmask, **kw)
        assert set(got) == set(want)
        for key, v in want.items():
            assert abs(got[key] - v) <= 1e-5 * max(1.0, abs(v)), (fn, key, got[key], v)


def test_score_split_rejects_non_binary_labels():
    *_, tcfg, tparams, tdata = _setup()

    class Corrupted:
        def batch(self, n, seed):
            b = dict(tdata.batch(n, seed))
            b["label"] = np.asarray(b["label"], np.float64) + 0.5
            return b

    with pytest.raises(ValueError, match="binary"):
        harness.score_split(tparams, tcfg, Corrupted(), n=64)


def test_ranking_eval_set_matches_reference():
    _, _, jdata, _, _, tdata = _setup()
    want = jharness.ranking_eval_set(jdata, n_queries=5, n_items=16, seed=3)
    got = harness.ranking_eval_set(tdata, n_queries=5, n_items=16, seed=3)
    for name in ("context_ids", "context_weights", "item_ids", "item_weights", "rel",
                 "rel01"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    np.testing.assert_array_equal(got.rel01.sum(-1), np.full(5, 8.0))
    q = got.query()
    assert q["item_ids"].shape == (5, 16, got.item_ids.shape[1])
    assert q["context_weights"].dtype == torch.float32


@pytest.mark.parametrize("interaction,pruned", [("dplr", False), ("fwfm", False),
                                                ("fwfm", True)])
def test_model_scores_match_reference(interaction, pruned):
    jcfg, jparams, jdata, tcfg, tparams, tdata = _setup(interaction, seed=1)
    es_j = jharness.ranking_eval_set(jdata, n_queries=3, n_items=12, seed=5)
    es_t = harness.ranking_eval_set(tdata, n_queries=3, n_items=12, seed=5)
    jp, tp = _pruned(jcfg, jparams) if pruned else (None, None)
    got = harness.model_scores(tparams, tcfg, es_t, pruned=tp)
    assert got.shape == (3, 12) and got.dtype == np.float32
    want = jharness.model_scores(jparams, jcfg, es_j, pruned=jp)
    np.testing.assert_allclose(got, want, **TOL)
    for key, v in jharness.ranking_metrics(want, es_j, k=3).items():
        _close(harness.ranking_metrics(got, es_t, k=3)[key], v, 1e-5)


def test_serving_parity_on_the_cpu():
    jcfg, jparams, jdata, tcfg, tparams, tdata = _setup()
    es = harness.ranking_eval_set(tdata, n_queries=6, n_items=32, seed=1)
    rep = harness.serving_parity(tparams, tcfg, es, k=5)
    assert "retraces" not in rep
    assert set(rep["paths"]) == set(rep["bit_exact"]) | {"model"} == {"model", "engine",
                                                                     "frontend"}
    for path in ("engine", "frontend"):
        assert rep["max_abs_diff"][path] <= 1e-5
        assert_scores(rep["scores"][path], rep["scores"]["model"])
        for key, v in rep["paths"]["model"].items():
            assert abs(rep["paths"][path][key] - v) <= 1e-5
    # the frontend's full-depth replies are the engine's scores
    np.testing.assert_array_equal(rep["scores"]["frontend"], rep["scores"]["engine"])
    es_j = jharness.ranking_eval_set(jdata, n_queries=6, n_items=32, seed=1)
    assert_scores(rep["scores"]["model"], jharness.model_scores(jparams, jcfg, es_j))
    assert 0.0 < rep["paths"]["model"]["ndcg@5"] <= 1.0

"""The port's model layers (``repro_torch``: fields, embedding bags, DPLR,
``fwfm.apply`` / ``loss`` / ``rank_items``) against the JAX package, with
the JAX weights from ``fwfm.init(PRNGKey(0))`` carried over through numpy.
Tolerance: atol = rtol = 1e-5."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import dplr_fwfm as jconfigs  # noqa: E402
from repro.core import fields as jfields  # noqa: E402
from repro.core import ranking as jrk  # noqa: E402
from repro.core.dplr import DPLRParams as JDPLR  # noqa: E402
from repro.core.dplr import materialize_R as jmaterialize  # noqa: E402
from repro.data.synthetic_ctr import SyntheticCTR as JSyntheticCTR  # noqa: E402
from repro.embedding import bag as jbag  # noqa: E402
from repro.models.recsys import fwfm as jfwfm  # noqa: E402
from repro_torch.configs import dplr_fwfm  # noqa: E402
from repro_torch.core import fields, ranking  # noqa: E402
from repro_torch.core.dplr import DPLRParams, materialize_R  # noqa: E402
from repro_torch.data.synthetic_ctr import SyntheticCTR  # noqa: E402
from repro_torch.embedding import bag  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models.recsys import fwfm  # noqa: E402

from test_torch_parity import assert_scores, to_np  # noqa: E402


def _configs(which: str, interaction: str):
    """The same config in both packages: ``uniform`` = uniform_layout(5, 4,
    50), ``smoke`` = the dplr-fwfm smoke config."""
    if which == "uniform":
        jcfg = jfwfm.FwFMConfig(layout=jfields.uniform_layout(5, 4, 50), embed_dim=8,
                                interaction=interaction, rank=2)
        tcfg = fwfm.FwFMConfig(layout=fields.uniform_layout(5, 4, 50), embed_dim=8,
                               interaction=interaction, rank=2)
    else:
        jcfg = dataclasses.replace(jconfigs.make_smoke(), interaction=interaction)
        tcfg = dataclasses.replace(dplr_fwfm.make_smoke(), interaction=interaction)
    return jcfg, tcfg


def _params(jcfg):
    jparams = jfwfm.init(jax.random.PRNGKey(0), jcfg)
    return jparams, params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                                      device="cpu")


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


CASES = [("uniform", "dplr"), ("uniform", "fm"), ("uniform", "fwfm"), ("smoke", "dplr")]


@pytest.mark.parametrize("layout", [
    fields.uniform_layout(5, 4, 50),
    fields.uniform_layout(2, 3, [5, 6, 7, 8, 9], multiplicity=2),
    dplr_fwfm.make_layout(),
])
def test_fields_match_reference(layout):
    ref = jfields.FeatureLayout(tuple(jfields.FieldSpec(f.name, f.vocab_size, f.kind,
                                                        f.multiplicity)
                                      for f in layout.fields))
    for name in ("n_fields", "n_context", "n_item", "n_slots", "total_vocab"):
        assert getattr(layout, name) == getattr(ref, name)
    for name in ("field_offsets", "slot_to_field", "slot_offsets", "context_field_idx",
                 "item_field_idx"):
        np.testing.assert_array_equal(getattr(layout, name), getattr(ref, name))
    for kind in ("context", "item"):
        np.testing.assert_array_equal(layout.slots_of(kind), ref.slots_of(kind))
        assert layout.subset(kind).total_vocab == ref.subset(kind).total_vocab


def test_full_config_matches_reference():
    t, j = dplr_fwfm.make_config(), jconfigs.make_config()
    assert (t.layout.n_context, t.layout.n_item, t.embed_dim, t.rank) == (44, 38, 16, 3)
    assert t.layout.total_vocab == j.layout.total_vocab == 33_040_000
    assert bag.padded_rows(t.layout.total_vocab) == jbag.padded_rows(j.layout.total_vocab)


def test_embedding_bag_matches_reference():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((40, 6)).astype(np.float32)
    ids = rng.integers(0, 40, (7, 5)).astype(np.int32)
    w = rng.random((7, 5)).astype(np.float32)
    seg = np.array([0, 0, 1, 2, 2])
    got = bag.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                            torch.from_numpy(w), seg, 3)
    assert_scores(got, jbag.embedding_bag(table, ids, w, seg, 3))


@pytest.mark.parametrize("which,interaction", CASES)
def test_init_matches_reference_layout(which, interaction):
    jcfg, tcfg = _configs(which, interaction)
    jparams = jfwfm.init(jax.random.PRNGKey(0), jcfg)
    tparams = fwfm.init(torch.Generator().manual_seed(0), tcfg)
    assert set(tparams) == set(jparams)
    for k, v in jparams.items():
        assert tuple(tparams[k].shape) == v.shape and tparams[k].dtype == torch.float32


def test_dplr_parameterization_matches_reference():
    jcfg, _ = _configs("smoke", "dplr")
    jparams, tparams = _params(jcfg)
    R = materialize_R(DPLRParams(tparams["U"], tparams["e"]))
    assert_scores(R, jmaterialize(JDPLR(jparams["U"], jparams["e"])))
    np.testing.assert_allclose(np.diag(to_np(R)), 0.0, atol=1e-6)


@pytest.mark.parametrize("which", ["uniform", "smoke"])
def test_dplr_context_cache_matches_reference(which):
    jcfg, tcfg = _configs(which, "dplr")
    jparams, tparams = _params(jcfg)
    q = JSyntheticCTR(jcfg.layout, embed_dim=4, seed=1).ranking_query(8, 2)
    jV, _ = jfwfm.context_inputs(jparams, jcfg, q["context_ids"], q["context_weights"])
    tq = _torch(q)
    tV, _ = fwfm.context_inputs(tparams, tcfg, tq["context_ids"], tq["context_weights"])
    assert_scores(tV, jV)
    nC = tcfg.layout.n_context
    want = jrk.dplr_context_cache(JDPLR(jparams["U"], jparams["e"]), jV, nC)
    got = ranking.dplr_context_cache(DPLRParams(tparams["U"], tparams["e"]), tV, nC)
    assert_scores(got.P_C, want.P_C)
    assert_scores(got.s_C, want.s_C)


@pytest.mark.parametrize("which,interaction", CASES)
def test_apply_and_loss_match_reference(which, interaction):
    jcfg, tcfg = _configs(which, interaction)
    jparams, tparams = _params(jcfg)
    batch = JSyntheticCTR(jcfg.layout, embed_dim=4, seed=0).batch(32, seed=5)
    assert_scores(fwfm.apply(tparams, tcfg, _torch(batch)),
                  jfwfm.apply(jparams, jcfg, batch))
    assert_scores(fwfm.loss(tparams, tcfg, _torch(batch)),
                  jfwfm.loss(jparams, jcfg, batch))


def _ranking_query(layout, n, Bq):
    """Bq contexts against one shared set of n candidates."""
    data = JSyntheticCTR(layout, embed_dim=4, seed=0)
    q = data.ranking_query(n, 0)
    ctx = np.concatenate([data.ranking_query(n, 100 + b)["context_ids"] for b in range(Bq)])
    return {"context_ids": ctx, "context_weights": np.ones(ctx.shape, np.float32),
            "item_ids": np.repeat(q["item_ids"], Bq, axis=0),
            "item_weights": np.repeat(q["item_weights"], Bq, axis=0)}


@pytest.mark.parametrize("which,interaction", CASES)
def test_rank_items_matches_reference(which, interaction):
    jcfg, tcfg = _configs(which, interaction)
    jparams, tparams = _params(jcfg)
    q = _ranking_query(jcfg.layout, 37, 3)
    got = fwfm.rank_items(tparams, tcfg, _torch(q))
    assert got.shape == (3, 37)
    assert_scores(got, jfwfm.rank_items(jparams, jcfg, q))
    if interaction == "dplr":
        # the JAX package's own kernel path: Pallas, interpret mode
        kcfg = dataclasses.replace(jcfg, use_pallas_kernels=True)
        assert_scores(got, jfwfm.rank_items(jparams, kcfg, q))
    # Algorithm 1 equals pointwise scoring of the concatenated rows
    lay = tcfg.layout
    rows = np.concatenate([np.repeat(q["context_ids"][:, None], 37, 1), q["item_ids"]], -1)
    order = np.argsort(np.concatenate([lay.slots_of("context"), lay.slots_of("item")]))
    flat = {"ids": rows[..., order].reshape(-1, lay.n_slots),
            "weights": np.ones((3 * 37, lay.n_slots), np.float32)}
    assert_scores(got.reshape(-1), fwfm.apply(tparams, tcfg, _torch(flat)))


def test_params_round_trip_is_identity():
    jcfg, _ = _configs("uniform", "dplr")
    jparams, tparams = _params(jcfg)
    back = params_to_numpy(tparams)
    assert set(back) == set(jparams)
    for k, v in jparams.items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
        assert back[k].dtype == np.asarray(v).dtype
    again = params_from_numpy(back, device="cpu")
    for k in tparams:
        assert torch.equal(again[k], tparams[k])


def test_synthetic_data_matches_reference():
    lay = dplr_fwfm.make_smoke().layout
    mine, theirs = SyntheticCTR(lay, seed=3), JSyntheticCTR(jconfigs.make_smoke().layout, seed=3)
    for key, v in mine.batch(16, seed=4).items():
        np.testing.assert_array_equal(v, theirs.batch(16, seed=4)[key])
    for key, v in mine.ranking_query(9, 1).items():
        np.testing.assert_array_equal(v, theirs.ranking_query(9, 1)[key])

"""The paper's baselines in the port (full FwFM, matched-pruned FwFM) and the
pieces around them, against the JAX package: ``core.pruning``, the pruned
and explicit-diagonal interactions, the pruned ranking caches,
``fwfm.apply(pruned_mask=)``, ``fwfm.rank_items(pruned=)`` and
``make_fwfm_baseline``, plus the embedding lookups' static-map cache.
Inputs are made with numpy from a seed; weights are JAX's, carried over
through ``interop.params_from_numpy``.  Tolerance: atol = rtol = 1e-5;
pruned entries identical."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import _recsys_common as jcommon  # noqa: E402
from repro.configs import dplr_fwfm as jconfigs  # noqa: E402
from repro.core import interactions as jint  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.core import ranking as jrk  # noqa: E402
from repro.core.fields import uniform_layout as juniform  # noqa: E402
from repro.data.synthetic_ctr import SyntheticCTR as JSyntheticCTR  # noqa: E402
from repro.models.recsys import fwfm as jfwfm  # noqa: E402
from repro_torch.configs import _recsys_common as common  # noqa: E402
from repro_torch.configs import dplr_fwfm  # noqa: E402
from repro_torch.core import interactions, pruning, ranking  # noqa: E402
from repro_torch.core.fields import uniform_layout  # noqa: E402
from repro_torch.embedding import bag  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models.recsys import fwfm  # noqa: E402

from test_torch_parity import assert_scores, to_np  # noqa: E402

MULTI_HOT = {1: 3, -2: 2}   # context field 1 holds 3 slots, item field 1 holds 2


def _configs(which: str, interaction: str = "fwfm"):
    """One config in both packages: ``uniform`` = uniform_layout(7, 5, 40),
    ``smoke`` = the dplr-fwfm smoke layout, ``multi`` = a tiered layout
    with multi-hot fields."""
    if which == "uniform":
        pair = (juniform(7, 5, 40), uniform_layout(7, 5, 40))
    elif which == "smoke":
        pair = (jconfigs.make_smoke().layout, dplr_fwfm.make_smoke().layout)
    else:
        tiers = ([(3, 30)], [(3, 20)])
        pair = (jcommon.tiered_layout(*tiers, multi_hot=MULTI_HOT),
                common.tiered_layout(*tiers, multi_hot=MULTI_HOT))
    jcfg = jfwfm.FwFMConfig(layout=pair[0], embed_dim=8, interaction=interaction, rank=2)
    tcfg = fwfm.FwFMConfig(layout=pair[1], embed_dim=8, interaction=interaction, rank=2)
    return jcfg, tcfg


def _params(jcfg, seed=0):
    jparams = jfwfm.init(jax.random.PRNGKey(seed), jcfg)
    return jparams, params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                                      device="cpu")


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _pruned(jcfg, jparams, rank=2):
    """The matched-pruned R in both packages, from the same field matrix."""
    R = np.asarray(jfwfm.field_matrix(jparams, jcfg))
    m = jcfg.layout.n_fields
    return (jpruning.prune_matched(R, m, rank),
            pruning.prune_matched(torch.from_numpy(R.copy()), m, rank))


# -- pruning ------------------------------------------------------------------

@pytest.mark.parametrize("m,rank", [(12, 2), (39, 3), (82, 3)])
def test_prune_matched_keeps_the_reference_entries(m, rank):
    rng = np.random.default_rng(m)
    R = rng.standard_normal((m, m)).astype(np.float32)
    R = 0.5 * (R + R.T)
    want = jpruning.prune_matched(R, m, rank)
    got = pruning.prune_matched(torch.from_numpy(R), m, rank)
    for name in ("mask", "entries_i", "entries_j", "entries_r"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.entries_i.dtype == torch.int32 and got.mask.dtype == torch.float32
    assert pruning.matched_param_count(m, rank) == jpruning.matched_param_count(m, rank)
    assert pruning.kept_fraction(m, rank) == jpruning.kept_fraction(m, rank)
    mask = to_np(got.mask)
    np.testing.assert_array_equal(mask, mask.T)
    assert int(mask.sum()) == 2 * len(got.entries_r)


def test_matched_pruning_at_the_full_width_keeps_249_entries():
    assert pruning.matched_param_count(82, 3) == 249
    assert round(100 * pruning.kept_fraction(82, 3), 1) == 7.5


def test_prune_from_numpy_gives_cpu_tensors():
    got = pruning.prune_topk(np.eye(4, dtype=np.float32) + 1.0, 2)
    assert got.mask.device.type == "cpu" and len(got.entries_i) == 2


# -- interactions ---------------------------------------------------------------

def _vr(seed, B, m, k):
    rng = np.random.default_rng(seed)
    V = (rng.standard_normal((B, m, k)) / np.sqrt(k)).astype(np.float32)
    R = rng.standard_normal((m, m)).astype(np.float32) * np.float32(0.1)
    return V, 0.5 * (R + R.T)


@pytest.mark.parametrize("B,m,k", [(16, 12, 8), (5, 82, 16)])
def test_pruned_pairwise_dense_and_sparse_match_reference(B, m, k):
    V, R = _vr(20, B, m, k)
    jp = jpruning.prune_matched(R, m, 3)
    tp = pruning.prune_matched(torch.from_numpy(R), m, 3)
    tV, tR = torch.from_numpy(V), torch.from_numpy(R)
    dense = interactions.pruned_pairwise_dense(tV, tR, tp.mask)
    assert_scores(dense, jint.pruned_pairwise_dense(jnp.asarray(V), jnp.asarray(R), jp.mask))
    sparse = interactions.pruned_pairwise_sparse(tV, tp.entries_i, tp.entries_j, tp.entries_r)
    assert_scores(sparse, jint.pruned_pairwise_sparse(jnp.asarray(V), jp.entries_i,
                                                      jp.entries_j, jp.entries_r))
    # the sparse upper-triangular sum is the dense form of a zero-diagonal R
    Rz = R.copy()
    np.fill_diagonal(Rz, 0)
    assert_scores(sparse, interactions.pruned_pairwise_dense(tV, torch.from_numpy(Rz),
                                                             tp.mask))


def test_fwfm_pairwise_and_explicit_d_match_reference():
    V, R = _vr(21, 7, 10, 8)
    assert_scores(interactions.fwfm_pairwise(torch.from_numpy(V), torch.from_numpy(R)),
                  jint.fwfm_pairwise(jnp.asarray(V), jnp.asarray(R)))
    rng = np.random.default_rng(22)
    U = rng.standard_normal((3, 10)).astype(np.float32)
    e = rng.standard_normal(3).astype(np.float32)
    d = rng.standard_normal(10).astype(np.float32)
    got = interactions.dplr_pairwise_explicit_d(*(torch.from_numpy(a) for a in (V, U, e, d)))
    assert_scores(got, jint.dplr_pairwise_explicit_d(*(jnp.asarray(a) for a in (V, U, e, d))))


# -- pruned ranking caches ---------------------------------------------------------

def test_pruned_context_cache_and_item_scores_match_reference():
    rng = np.random.default_rng(23)
    nC, nI, k = 7, 5, 8
    V, R = _vr(24, 1, nC + nI, k)
    jp = jpruning.prune_matched(R, nC + nI, 2)
    tp = pruning.prune_matched(torch.from_numpy(R), nC + nI, 2)
    jg = jrk.split_pruned_entries(jp.entries_i, jp.entries_j, jp.entries_r, nC)
    tg = ranking.split_pruned_entries(tp.entries_i, tp.entries_j, tp.entries_r, nC)
    for group in ("cc", "ci", "ii"):
        for a, b in zip(tg[group], jg[group]):
            np.testing.assert_array_equal(a, np.asarray(b))
    V_C = rng.standard_normal((3, nC, k)).astype(np.float32)
    V_I = rng.standard_normal((3, 6, nI, k)).astype(np.float32)
    jc = jrk.pruned_context_cache(jg, jnp.asarray(V_C), nI)
    tc = ranking.pruned_context_cache(tg, torch.from_numpy(V_C), nI)
    assert_scores(tc.cc, jc.cc)
    assert_scores(tc.W_I, jc.W_I)
    assert_scores(ranking.pruned_score_items(tg, tc, torch.from_numpy(V_I)),
                  jrk.pruned_score_items(jg, jc, jnp.asarray(V_I)))


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("which", ["uniform", "smoke", "multi"])
def test_fwfm_baseline_and_pruned_apply_match_reference(which):
    jcfg, tcfg = _configs(which)
    jparams, tparams = _params(jcfg)
    batch = JSyntheticCTR(jcfg.layout, embed_dim=4, seed=0).batch(48, seed=6)
    assert_scores(fwfm.apply(tparams, tcfg, _torch(batch)), jfwfm.apply(jparams, jcfg, batch))
    jp, tp = _pruned(jcfg, jparams)
    got = fwfm.apply(tparams, tcfg, _torch(batch), pruned_mask=tp.mask)
    assert_scores(got, jfwfm.apply(jparams, jcfg, batch, pruned_mask=jp.mask))
    # pruning changes the scores: the mask reached the pairwise term
    assert not np.allclose(to_np(got), to_np(fwfm.apply(tparams, tcfg, _torch(batch))))


def _query(layout, Bq, n, seed=0):
    """Bq contexts against one shared set of n candidates (numpy)."""
    data = JSyntheticCTR(layout, embed_dim=4, seed=seed)
    q = data.ranking_query(n, 0)
    ctx = np.concatenate([data.context_query(50 + b)["context_ids"] for b in range(Bq)])
    return {"context_ids": ctx, "context_weights": np.ones(ctx.shape, np.float32),
            "item_ids": np.repeat(q["item_ids"], Bq, axis=0),
            "item_weights": np.repeat(q["item_weights"], Bq, axis=0)}


@pytest.mark.parametrize("which", ["uniform", "smoke"])
def test_rank_items_pruned_matches_reference_and_pointwise(which):
    jcfg, tcfg = _configs(which)
    jparams, tparams = _params(jcfg, seed=2)
    jp, tp = _pruned(jcfg, jparams)
    Bq, n = 2, 9
    q = _query(jcfg.layout, Bq, n)
    got = fwfm.rank_items(tparams, tcfg, _torch(q), pruned=tp)
    assert got.shape == (Bq, n)
    assert_scores(got, jfwfm.rank_items(jparams, jcfg, q, pruned=jp))
    # Algorithm 1's pruned cache equals pointwise scoring with the mask
    lay = tcfg.layout
    rows = np.concatenate([np.repeat(q["context_ids"][:, None], n, 1), q["item_ids"]], -1)
    order = np.argsort(np.concatenate([lay.slots_of("context"), lay.slots_of("item")]))
    flat = {"ids": rows[..., order].reshape(-1, lay.n_slots),
            "weights": np.ones((Bq * n, lay.n_slots), np.float32)}
    assert_scores(got.reshape(-1), fwfm.apply(tparams, tcfg, _torch(flat), pruned_mask=tp.mask))


def test_make_fwfm_baseline_matches_reference():
    t, j = dplr_fwfm.make_fwfm_baseline(), jconfigs.make_fwfm_baseline()
    assert (t.interaction, t.embed_dim, t.rank) == (j.interaction, j.embed_dim, j.rank)
    assert t.interaction == "fwfm" and t.layout == dplr_fwfm.make_layout()
    assert (t.layout.n_fields, t.layout.total_vocab) == (82, j.layout.total_vocab)


# -- the lookups' static maps ----------------------------------------------------

def test_lookup_copies_the_static_maps_once_per_layout_and_device():
    _, tcfg = _configs("multi")
    tparams = fwfm.init(torch.Generator().manual_seed(0), tcfg)
    batch = _torch(JSyntheticCTR(tcfg.layout, embed_dim=4, seed=0).batch(8, seed=1))
    first = bag.lookup_field_embeddings(tparams["embedding"], tcfg.layout, batch["ids"],
                                        batch["weights"])
    statics = bag._statics(dataclasses.replace(tcfg.layout), None, "cpu")
    before = bag._statics.cache_info()
    again = bag.lookup_field_embeddings(tparams["embedding"], tcfg.layout, batch["ids"],
                                        batch["weights"])
    after = bag._statics.cache_info()
    assert after.misses == before.misses and after.hits == before.hits + 1
    assert bag._statics(tcfg.layout, None, "cpu").offsets is statics.offsets
    assert torch.equal(first, again)
    # int32 local ids stay int32 through the offset add
    assert statics.offsets.dtype == torch.int32
    np.testing.assert_array_equal(statics.offsets.numpy(), tcfg.layout.slot_offsets)

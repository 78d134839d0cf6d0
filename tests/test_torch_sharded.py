"""The sharded item corpus of the port on the CPU: one process, D shards
(``launch.mesh.make_host_mesh(D, device="cpu")``).

Within the port the sharded engine is bitwise the single-device engine
(scores, top-K with ties, churn, growth, slot assignments) for D in
{1, 2, 4}.  Against the JAX package: its single-device
``CorpusRankingEngine`` (which its own contract makes equal to its
sharded one), scores within atol = rtol = 1e-5 and top-K ids equal except
between scores tied within that, slot assignments exactly; at D = 1 its
sharded engine on its one-device host mesh; its pure ``group_deltas`` and
``merge_topk`` bitwise; its partition rules, entry for entry, on stand-in
meshes (JAX has one CPU device here); ``rank_items_mp`` on its host mesh.
The sizes are ``tests/test_sharded_engine.py``'s."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import sharding as jrules  # noqa: E402
from repro.configs import REGISTRY as JREGISTRY  # noqa: E402
from repro.core.fields import uniform_layout as juniform  # noqa: E402
from repro.data.synthetic_ctr import SyntheticCTR  # noqa: E402
from repro.launch.mesh import make_host_mesh as jmake_host_mesh  # noqa: E402
from repro.launch.steps import _recsys_module as jrecsys_module  # noqa: E402
from repro.models.gnn import pna as jpna  # noqa: E402
from repro.models.recsys import fwfm as jfwfm  # noqa: E402
from repro.serving import CorpusRankingEngine as JEngine  # noqa: E402
from repro.serving import sharded as jsharded  # noqa: E402
from repro_torch import sharding as rules  # noqa: E402
from repro_torch.configs.registry import REGISTRY  # noqa: E402
from repro_torch.core.fields import FieldSpec, FeatureLayout, uniform_layout  # noqa: E402
from repro_torch.eval import harness  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels.dplr_corpus_score import NEG_INF  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.train import recsys_module  # noqa: E402
from repro_torch.models.gnn import pna  # noqa: E402
from repro_torch.models.recsys import fwfm  # noqa: E402
from repro_torch.serving import sharded  # noqa: E402
from repro_torch.serving.engine import CorpusRankingEngine, CorpusState, fused_topk  # noqa: E402
from repro_torch.serving.frontend import QueryFrontend  # noqa: E402
from repro_torch.serving.runtime import ScorerRuntime  # noqa: E402

from test_torch_parity import assert_scores, assert_topk, to_np  # noqa: E402

SHARDS = (1, 2, 4)


def _setup(nC=5, nI=4, vocab=50, k=8, rho=2, n=37, seed=0):
    """(JAX cfg, port cfg, JAX params, port params, data, query): one set of
    weights, the JAX package's, carried over through numpy."""
    jcfg = jfwfm.FwFMConfig(layout=juniform(nC, nI, vocab), embed_dim=k, interaction="dplr",
                            rank=rho)
    tcfg = fwfm.FwFMConfig(layout=uniform_layout(nC, nI, vocab), embed_dim=k,
                           interaction="dplr", rank=rho)
    jp = jfwfm.init(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy({key: np.asarray(v) for key, v in jp.items()}, device="cpu")
    data = SyntheticCTR(jcfg.layout, embed_dim=4, seed=seed)
    q = data.ranking_query(n, seed)
    q["context_ids"] = np.concatenate([data.ranking_query(1, 100 + b)["context_ids"]
                                       for b in range(3)])
    q["context_weights"] = np.ones(q["context_ids"].shape, np.float32)
    return jcfg, tcfg, jp, tp, data, q


def _mesh(D):
    return make_host_mesh(D, device="cpu")


def _pair(tcfg, tp, q, D, capacity=None):
    """(sharded, single-device) port engines over the same corpus."""
    sh = CorpusState(tcfg, q["item_ids"][0], q["item_weights"][0], capacity=capacity,
                     mesh=_mesh(D))
    one = CorpusState(tcfg, q["item_ids"][0], q["item_weights"][0], capacity=capacity,
                      device="cpu")
    sh.refresh(tp, step=0)
    one.refresh(tp, step=0)
    return sh, one


def _same(got, want, what=""):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _same(g, w, what)
        return
    assert torch.equal(got, want), f"{what}: not bitwise equal"


def _churn(engines, data):
    """The reference test's add/remove/update sequence on each engine;
    returns the slots each reported for the adds."""
    out = []
    for e in engines:
        added = e.add_items(data.ranking_query(7, 90)["item_ids"][0])
        e.remove_items([1, 3, 5, int(added[0]), int(added[3])])
        upd = data.ranking_query(4, 91)
        e.update_items([0, 2, int(added[1]), int(added[6])], upd["item_ids"][0],
                       upd["item_weights"][0])
        added2 = e.add_items(data.ranking_query(3, 92)["item_ids"][0])
        out.append((np.asarray(added), np.asarray(added2)))
    return out


# -- within the port: bitwise the single-device engine ----------------------------

@pytest.mark.parametrize("D", SHARDS)
def test_sharded_bitwise_single_device(D):
    _, tcfg, _, tp, _, q = _setup(n=37)
    sh, one = _pair(tcfg, tp, q, D)
    assert sh.n_shards == D and sh.local_capacity * D == sh.capacity == one.capacity
    assert isinstance(sh.cache, sharded.ShardedCorpusCache)
    assert all(c.capacity == sh.local_capacity for c in sh.cache.shards)
    ctx = q["context_ids"]
    _same(sh.score(ctx), one.score(ctx), "score")
    for K in (1, 5, sh.n_items):
        _same(sh.topk(ctx, K), one.topk(ctx, K), f"top-{K}")
    np.testing.assert_array_equal(sh.shard_of(np.arange(sh.capacity)),
                                  np.arange(sh.capacity) % D)


@pytest.mark.parametrize("D", SHARDS)
def test_sharded_churn_slots_and_rows_land_on_their_owners(D):
    _, tcfg, _, tp, data, q = _setup(n=20)
    sh, one = _pair(tcfg, tp, q, D, capacity=32)
    (s_add, s_add2), (o_add, o_add2) = _churn((sh, one), data)
    np.testing.assert_array_equal(s_add, o_add)
    np.testing.assert_array_equal(s_add2, o_add2)
    np.testing.assert_array_equal(sh.valid_slots, one.valid_slots)
    ctx = q["context_ids"]
    _same(sh.score(ctx), one.score(ctx), "score after churn")
    _same(sh.topk(ctx, sh.n_items), one.topk(ctx, one.n_items), "top-n after churn")
    # shard s holds exactly the striped global rows it owns, live rows bitwise
    live = one.cache.valid
    for s, c in enumerate(sh.cache.shards):
        _same(c.valid, live[s::D], f"shard {s} mask")
        for name in ("Q_I", "t_I", "lin_I", "a_I"):
            _same(getattr(c, name)[c.valid], getattr(one.cache, name)[s::D][c.valid],
                  f"shard {s} {name}")
    phys = sh.cache.physical()
    assert phys.Q_I.shape == (sh.local_capacity, D, *one.cache.Q_I.shape[1:])
    _same(phys.valid.reshape(-1), live, "physical view")


@pytest.mark.parametrize("D", SHARDS)
def test_grouped_write_on_one_shard_alone(D):
    """Every updated slot owned by shard 0: the other shards get filler only."""
    _, tcfg, _, tp, data, q = _setup(n=20)
    sh, one = _pair(tcfg, tp, q, D, capacity=32)
    victims = list(range(0, 20, D))[:4]
    upd = data.ranking_query(len(victims), 55)
    for e in (sh, one):
        e.update_items(victims, upd["item_ids"][0], upd["item_weights"][0])
    _same(sh.score(q["context_ids"]), one.score(q["context_ids"]), "score")


@pytest.mark.parametrize("D", SHARDS)
def test_sharded_growth_keeps_every_slot(D):
    _, tcfg, _, tp, data, q = _setup(n=20)
    sh, one = _pair(tcfg, tp, q, D, capacity=32)
    ctx = q["context_ids"]
    before = sh.score(ctx)
    grow = data.ranking_query(20, 77)["item_ids"][0]
    np.testing.assert_array_equal(sh.add_items(grow), one.add_items(grow))
    assert sh.capacity == 64 and sh.n_items == 40 and sh.local_capacity == 64 // D
    after = sh.score(ctx)
    _same(after, one.score(ctx), "score after growth")
    _same(after[:, :20], before[:, :20], "old slots across the doubling")
    _same(sh.topk(ctx, 40), one.topk(ctx, 40), "top-40 after growth")


@pytest.mark.parametrize("D", SHARDS)
def test_no_dead_slot_wins_across_merge(D):
    _, tcfg, _, tp, _, q = _setup(n=32)
    sh, one = _pair(tcfg, tp, q, D, capacity=32)
    victims = [g for g in range(32) if g % D == 0][1:]
    if victims:
        sh.remove_items(victims)
        one.remove_items(victims)
    K = sh.n_items
    vals, ids = sh.topk(q["context_ids"], K)
    assert sh.is_live(to_np(ids)).all()
    _same((vals, ids), one.topk(q["context_ids"], K), "top-n")
    assert np.all(to_np(sh.score(q["context_ids"]))[:, victims] == NEG_INF)
    with pytest.raises(ValueError):
        sh.topk(q["context_ids"], K + 1)


def test_sharded_construction_validates():
    _, tcfg, _, _, _, q = _setup(n=20)
    with pytest.raises(ValueError, match="not divisible"):
        CorpusState(tcfg, q["item_ids"][0][:2], capacity=2, mesh=_mesh(4))
    eng = CorpusState(tcfg, q["item_ids"][0][:1], mesh=_mesh(4))
    assert eng.capacity == 4 and eng.local_capacity == 1
    with pytest.raises(ValueError, match="power of two"):
        ScorerRuntime(tcfg, mesh=_mesh(3))
    rt = ScorerRuntime(tcfg, mesh=_mesh(2))
    assert rt.n_shards == 2 and rt.device == torch.device("cpu")
    with pytest.raises(ValueError, match="mesh is a runtime property"):
        CorpusState(None, q["item_ids"][0], runtime=rt, mesh=_mesh(2))
    with pytest.raises(ValueError, match="pass one of them"):
        CorpusRankingEngine(tcfg, q["item_ids"][0], device="cpu", mesh=_mesh(2))
    assert CorpusRankingEngine(tcfg, q["item_ids"][0], mesh=_mesh(2)).mesh.shape["model"] == 2


# -- against the JAX package ----------------------------------------------------------

def _assert_matches(jeng, teng, ctx, K):
    assert teng.capacity == jeng.capacity and teng.n_items == jeng.n_items
    np.testing.assert_array_equal(teng.valid_slots, jeng.valid_slots)
    full = np.asarray(jeng.score(ctx))
    assert_scores(teng.score(ctx), full)
    assert_topk(*teng.topk(ctx, K), *jeng.topk(ctx, K), full)


@pytest.mark.parametrize("D", SHARDS)
def test_sharded_matches_the_reference_engine(D):
    jcfg, tcfg, jp, tp, data, q = _setup(n=20)
    teng = CorpusState(tcfg, q["item_ids"][0], q["item_weights"][0], capacity=32,
                       mesh=_mesh(D))
    jeng = JEngine(jcfg, q["item_ids"][0], q["item_weights"][0], capacity=32)
    teng.refresh(tp)
    jeng.refresh(jp)
    ctx = q["context_ids"]
    _assert_matches(jeng, teng, ctx, 5)
    (t_add, t_add2), (j_add, j_add2) = _churn((teng, jeng), data)
    np.testing.assert_array_equal(t_add, j_add)
    np.testing.assert_array_equal(t_add2, j_add2)
    _assert_matches(jeng, teng, ctx, teng.n_items)
    grow = data.ranking_query(20, 77)["item_ids"][0]
    np.testing.assert_array_equal(teng.add_items(grow), jeng.add_items(grow))
    assert teng.capacity == 64
    _assert_matches(jeng, teng, ctx, 16)


def test_one_shard_matches_the_reference_sharded_engine():
    """The reference's sharded engine on its one-device host mesh, cache
    included (its physical (local, 1, ...) view)."""
    jcfg, tcfg, jp, tp, data, q = _setup(n=20)
    jeng = JEngine(jcfg, q["item_ids"][0], q["item_weights"][0], capacity=32,
                   mesh=jmake_host_mesh(model=jax.device_count()))
    teng = CorpusState(tcfg, q["item_ids"][0], q["item_weights"][0], capacity=32,
                       mesh=_mesh(jax.device_count()))
    jeng.refresh(jp)
    teng.refresh(tp)
    assert jeng.n_shards == teng.n_shards == 1
    (t_add, _), (j_add, _) = _churn((teng, jeng), data)
    np.testing.assert_array_equal(t_add, j_add)
    _assert_matches(jeng, teng, q["context_ids"], 8)
    phys = teng.cache.physical()
    for name in ("Q_I", "t_I", "lin_I"):
        live = np.asarray(jeng.cache.valid)
        np.testing.assert_allclose(to_np(getattr(phys, name))[live],
                                   np.asarray(getattr(jeng.cache, name))[live],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(to_np(phys.valid), np.asarray(jeng.cache.valid))


@pytest.mark.parametrize("D,local_cap,n", [(2, 16, 4), (4, 16, 13), (4, 8, 9), (1, 32, 7)])
def test_group_deltas_bitwise_the_reference(D, local_cap, n):
    rng = np.random.default_rng(D * 100 + n)
    slots = rng.choice(D * local_cap, n, replace=False)
    ids = rng.integers(0, 50, (n, 3)).astype(np.int32)
    w = rng.random((n, 3)).astype(np.float32)
    for got, want in zip(sharded.group_deltas(slots, ids, w, D, local_cap),
                         jsharded.group_deltas(slots, ids, w, D, local_cap)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # the reference test's layout case: 3 slots for shard 0 of D = 2, 1 for shard 1
    li, ids_g, _ = sharded.group_deltas(np.array([0, 2, 3, 4]),
                                        np.arange(8, dtype=np.int32).reshape(4, 2),
                                        np.ones((4, 2), np.float32), D=2, local_cap=16)
    np.testing.assert_array_equal(li[:, 0], [0, 1, 2, 16])
    np.testing.assert_array_equal(li[:, 1], [1, 16, 16, 16])


@pytest.mark.parametrize("D,Bq,k_loc,K", [(1, 2, 5, 5), (2, 3, 4, 6), (4, 2, 3, 9),
                                          (4, 1, 8, 8)])
def test_merge_topk_bitwise_the_reference(D, Bq, k_loc, K):
    """Candidates with planted ties within and across shards, and a sparse
    shard padded with NEG_INF dead candidates."""
    rng = np.random.default_rng(D + 10 * K)
    vals = rng.integers(0, 4, (D, Bq, k_loc)).astype(np.float32)   # many ties
    vals = -np.sort(-vals, axis=2)
    if D > 1:
        vals[-1, :, 1:] = NEG_INF
    ids = np.stack([s + D * np.sort(rng.choice(50, (Bq, k_loc), replace=True), axis=1)
                    for s in range(D)]).astype(np.int32)
    for b in range(Bq):                       # unique global ids a row
        for s in range(D):
            ids[s, b] = s + D * rng.permutation(50)[:k_loc]
    gv, gi = sharded.merge_topk(torch.from_numpy(vals), torch.from_numpy(ids), K)
    wv, wi = jsharded.merge_topk(jnp.asarray(vals), jnp.asarray(ids), K)
    np.testing.assert_array_equal(to_np(gv), np.asarray(wv))
    np.testing.assert_array_equal(to_np(gi), np.asarray(wi))
    S = 2
    cv = np.stack([vals, vals[:, ::-1]], axis=1)
    ci = np.stack([ids, ids[:, ::-1]], axis=1)
    gv, gi = sharded._merge_multi(torch.from_numpy(cv.copy()), torch.from_numpy(ci.copy()), K)
    wv, wi = jsharded._merge_multi(jnp.asarray(cv), jnp.asarray(ci), K)
    assert gv.shape == (S, Bq, K)
    np.testing.assert_array_equal(to_np(gv), np.asarray(wv))
    np.testing.assert_array_equal(to_np(gi), np.asarray(wi))


# -- the rules and the mesh ---------------------------------------------------------------

MESHES = (SimpleNamespace(shape={"data": 16, "model": 16}, axis_names=("data", "model")),
          SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16},
                          axis_names=("pod", "data", "model")),
          SimpleNamespace(shape={"data": 1, "model": 4}, axis_names=("data", "model")))


class _Fsdp:
    """A port config with the reference's ``fsdp`` flag, which the port's
    configs do not carry until FSDP is ported (the training half)."""

    def __init__(self, cfg, fsdp: bool):
        self._cfg, self.fsdp = cfg, fsdp

    def __getattr__(self, name):
        return getattr(self._cfg, name)


def _as_tuples(tree):
    """The reference's spec tree with each ``PartitionSpec`` as ``tuple(P)``."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


def _params_of(name):
    """(port params on meta, reference params as shapes) of a registry arch."""
    cfg, jcfg = REGISTRY[name].make_config(), JREGISTRY[name].make_config()
    if REGISTRY[name].family == "gnn":
        return (pna.init(torch.Generator(), cfg, device="meta"),
                jax.eval_shape(lambda: jpna.init(jax.random.PRNGKey(0), jcfg)))
    return (recsys_module(name).init(torch.Generator(), cfg, device="meta"),
            jax.eval_shape(lambda: jrecsys_module(name).init(jax.random.PRNGKey(0), jcfg)))


@pytest.mark.parametrize("name", sorted(REGISTRY))
@pytest.mark.parametrize("mesh", range(len(MESHES)))
def test_rules_entry_for_entry_the_reference(name, mesh):
    m = MESHES[mesh]
    assert rules.dp_axes(m) == jrules.dp_axes(m) and rules.model_size(m) == m.shape["model"]
    family = REGISTRY[name].family
    if family == "lm":
        jcfg = JREGISTRY[name].make_config()
        specs = rules.lm_param_specs(_Fsdp(REGISTRY[name].make_config(), jcfg.fsdp), m)
        assert specs == _as_tuples(jrules.lm_param_specs(jcfg, m))
        for batch in (1, 16, 128):
            assert rules.lm_cache_spec(m, batch) == tuple(jrules.lm_cache_spec(m, batch))
        from repro.sharding.rules import lm_batch_spec
        assert rules.lm_batch_spec(m) == tuple(lm_batch_spec(m))
    else:
        tparams, jparams = _params_of(name)
        rule, jrule = ((rules.gnn_param_specs, jrules.gnn_param_specs) if family == "gnn"
                       else (rules.recsys_param_specs, jrules.recsys_param_specs))
        specs, jspecs = rule(tparams, m), jrule(jparams, m)
        assert specs == _as_tuples(jspecs)
        state = {"m": tparams, "v": tparams, "t": torch.zeros((), device="meta")}
        jstate = {"m": jparams, "v": jparams, "t": jnp.zeros(())}
        assert rules.opt_state_specs(specs, state) == _as_tuples(
            jrules.opt_state_specs(jspecs, jstate))
    assert rules.corpus_slab_axis() == jrules.corpus_slab_axis()
    assert rules.corpus_slab_spec(m) == tuple(jrules.corpus_slab_spec(m))
    got, want = rules.corpus_cache_specs(m), jrules.corpus_cache_specs(m)
    for leaf in ("Q_I", "t_I", "lin_I", "valid"):
        assert getattr(got, leaf) == tuple(getattr(want, leaf))
    assert got.a_I == got.t_I


def test_meshes():
    m = make_host_mesh(device="cpu")
    assert m.axis_names == ("data", "model") and m.shape == {"data": 1, "model": 1}
    m4 = make_host_mesh(4, device="cpu")
    assert m4.shape["model"] == 4 and m4.devices == (torch.device("cpu"),) * 4
    assert sharded.shard_count(m4) == 4
    for multi_pod, need in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {need} cpu devices; 1 visible"):
            make_production_mesh(multi_pod=multi_pod, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh(2)                     # cuda unless asked: none here


# -- rank_items_mp ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", SHARDS)
@pytest.mark.parametrize("vocab", [50, 500])
def test_rank_items_mp_matches_the_reference_and_rank_items(D, vocab):
    """vocab 500: 4,500 rows in a 6,144-row arena, so every block of D = 4
    holds rows the queries name."""
    jcfg, tcfg, jp, tp, data, q = _setup(vocab=vocab, n=37)
    q = {key: np.concatenate([v, v[:1]]) for key, v in data.ranking_query(37, 1).items()}
    q = {key: np.concatenate([v, data.ranking_query(37, 2)[key]]) for key, v in q.items()}
    tq = {key: torch.as_tensor(v) for key, v in q.items()}
    want = np.asarray(jfwfm.rank_items_mp(jp, jcfg, {k: jnp.asarray(v) for k, v in q.items()},
                                          mesh=jmake_host_mesh(),
                                          item_spec=P(None, None, None)))
    got = fwfm.rank_items_mp(tp, tcfg, tq, mesh=_mesh(D))
    assert got.shape == want.shape == (3, 37)
    assert_scores(got, want)
    assert_scores(got, fwfm.rank_items(tp, tcfg, tq))


def test_rank_items_mp_refuses_what_the_reference_refuses():
    _, tcfg, _, tp, data, q = _setup()
    tq = {key: torch.as_tensor(v) for key, v in data.ranking_query(5, 0).items()}
    fields = list(tcfg.layout.fields)
    fields[-1] = FieldSpec(fields[-1].name, fields[-1].vocab_size, fields[-1].kind,
                           multiplicity=2)
    multi = fwfm.FwFMConfig(layout=FeatureLayout(tuple(fields)), embed_dim=8,
                            interaction="dplr", rank=2)
    with pytest.raises(ValueError, match="one-hot"):
        fwfm.rank_items_mp(tp, multi, tq, mesh=_mesh(1))
    with pytest.raises(ValueError, match="does not split"):
        fwfm.rank_items_mp(tp, tcfg, tq, mesh=_mesh(3))
    jcfg = jfwfm.FwFMConfig(layout=juniform(5, 4, 50), embed_dim=8, interaction="dplr",
                            rank=2)
    jfields = list(jcfg.layout.fields)
    jfields[-1] = type(jfields[-1])(jfields[-1].name, jfields[-1].vocab_size,
                                    jfields[-1].kind, multiplicity=2)
    jmulti = jfwfm.FwFMConfig(layout=type(jcfg.layout)(tuple(jfields)), embed_dim=8,
                              interaction="dplr", rank=2)
    with pytest.raises(AssertionError, match="one-hot"):
        jfwfm.rank_items_mp(None, jmulti, None, mesh=jmake_host_mesh(), item_spec=None)


# -- the layers above: harness, multi-tenant, frontend, launch/serve.py ----------------------

@pytest.mark.parametrize("D", SHARDS)
def test_serving_parity_on_a_mesh(D):
    _, tcfg, _, tp, data, _ = _setup()
    es = harness.ranking_eval_set(data, n_queries=3, n_items=24)
    got = harness.serving_parity(tp, tcfg, es, k=5, mesh=_mesh(D))
    want = harness.serving_parity(tp, tcfg, es, k=5)
    for path in ("engine", "frontend"):
        np.testing.assert_array_equal(got["scores"][path], want["scores"][path])
        assert got["max_abs_diff"][path] < 1e-4
    assert got["paths"] == want["paths"]


def _tenants(tcfg, tp, data, mesh, caps):
    rt = ScorerRuntime(tcfg, mesh=mesh)
    states = {}
    for i, cap in enumerate(caps):
        c = data.ranking_query(20, 100 + i)
        states[f"t{i}"] = CorpusState(None, c["item_ids"][0], c["item_weights"][0],
                                      capacity=cap, runtime=rt)
        states[f"t{i}"].refresh(tp)
    return rt, states


@pytest.mark.parametrize("D", SHARDS)
def test_fused_topk_on_a_mesh_bitwise_lone_calls(D):
    _, tcfg, _, tp, data, q = _setup()
    _, states = _tenants(tcfg, tp, data, _mesh(D), (32, 32, 32))
    ctx = np.stack([q["context_ids"]] * 3)
    vals, ids = fused_topk(tuple(states.values()), ctx, 7)
    for s, st in enumerate(states.values()):
        _same((vals[s], ids[s]), st.topk(ctx[s], 7), f"segment {s}")
    _, uneven = _tenants(tcfg, tp, data, _mesh(D), (32, 64))
    if D > 1:
        with pytest.raises(ValueError, match="fused mesh top-K needs equal capacities"):
            fused_topk(tuple(uneven.values()), ctx[:2], 7)


@pytest.mark.parametrize("D", SHARDS)
def test_frontend_on_sharded_tenants(D):
    """Replies bitwise lone calls; packed across tenants of one local
    capacity, and a tenant of another capacity left out of the pack."""
    _, tcfg, _, tp, data, _ = _setup()
    _, states = _tenants(tcfg, tp, data, _mesh(D), (32, 32, 64))
    fe = QueryFrontend(states, max_batch=2, max_k=8, max_wait=1e9, auto_pump=False,
                       pack=True)
    ctxs = [data.context_query(s)["context_ids"] for s in range(12)]
    pend = [(s, f"t{s % 3}", fe.submit(ctxs[s], k=1 + s % 8, tenant=f"t{s % 3}"))
            for s in range(12)]
    fe.flush()
    fe.drain()
    for s, tenant, p in pend:
        sc, sl = p.result()
        wv, wi = states[tenant].topk(np.asarray(ctxs[s]).reshape(1, -1), 1 + s % 8)
        np.testing.assert_array_equal(sc, to_np(wv)[0])
        np.testing.assert_array_equal(sl, to_np(wi)[0])
    assert fe.stats["fused_dispatches"] >= 1
    assert fe._pack_key(fe._lanes["t0"]) == fe._pack_key(fe._lanes["t1"])
    assert fe._pack_key(fe._lanes["t0"]) != fe._pack_key(fe._lanes["t2"])
    fe.close()


@pytest.mark.parametrize("devices,argv", [
    (1, ["--mesh", "host", "--items", "200", "--queries", "5", "--topk", "5"]),
    (4, ["--mesh", "host", "--items", "200", "--queries", "5", "--topk", "5"]),
    (2, ["--mesh", "host", "--frontend", "--items", "200", "--queries", "30"]),
    (4, ["--mp", "--items", "200", "--queries", "4"]),
    (1, ["--mp", "--items", "200", "--queries", "4"]),
], ids=["host", "host4", "frontend2", "mp4", "mp"])
def test_serve_mesh_and_mp_run_to_their_ends(devices, argv, capsys, monkeypatch):
    """``--mesh host`` and ``--mp`` take D from the visible devices, as the
    reference does; D CPU devices stand in for the reference tests' forced
    host device count."""
    monkeypatch.setattr(mesh_mod, "_device_count", lambda device_type: devices)
    serve.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    assert "queries x 200 items" in out or "frontend demo" in out
    if "--mesh" in argv and devices > 1:
        assert f"corpus sharded {devices}-way" in out


def test_serve_refuses_what_the_reference_refuses():
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--mp", "--engine", "corpus"])
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--engine", "percall", "--mesh", "host"])
    with pytest.raises(ValueError, match="needs 256"):
        serve.main(["--device", "cpu", "--mesh", "prod", "--items", "20", "--queries", "2"])

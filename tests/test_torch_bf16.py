"""bf16 serving in the port, on the CPU, against the JAX package.

Inputs are made with numpy from a seed and cast to bf16 on both sides
(numpy has no bf16; JAX and torch both round to nearest even, so the two
packages hold the same bits).  Tolerances are the reference's own for
bf16: the corpus scorer's selected items within 5e-2 of their f32 scores
and its values within rtol 2e-2, atol 1e-1 (``tests/test_serving_engine.py``
``test_corpus_score_acc_dtype``); Algorithm 1's item kernel within 5e-2 and
the embedding bag within 2e-2 (``tests/test_kernels.py``).  With
``acc_dtype='float32'`` both packages upcast a bf16 slab on entry and score
in f32, so there the port holds the f32 parity tolerance (1e-5) and is
bitwise its own f32 call on the upcast tensors."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.recsys import fwfm as jfwfm  # noqa: E402
from repro.serving import CorpusRankingEngine as JEngine  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.recsys import fwfm  # noqa: E402
from repro_torch.serving import CorpusState, QueryFrontend, ScorerRuntime  # noqa: E402
from repro_torch.serving.engine import fused_topk  # noqa: E402

from test_torch_parity import assert_scores, corpus_inputs, to_np  # noqa: E402
from test_torch_serving import _setup  # noqa: E402

BF16_VALUES = dict(rtol=2e-2, atol=1e-1)


def _both_bf16(arrays):
    """numpy arrays as bf16 on both sides (bool ones as they are)."""
    j = tuple(jnp.asarray(a, jnp.bfloat16) if a.dtype == np.float32 else jnp.asarray(a)
              for a in arrays)
    t = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
              if a.dtype == np.float32 else torch.from_numpy(np.ascontiguousarray(a))
              for a in arrays)
    return j, t


def _upcast(tensors):
    return tuple(t.float() if t.dtype == torch.bfloat16 else t for t in tensors)


def _assert_bf16_topk(vals, ids, f32_full, want_vals, acc_f32_vals):
    """The reference's bf16 gate: the selected ids judged by their f32
    scores (the sorted multiset within 5e-2 of the f32 top-K), and the
    values within the bf16 value tolerance of those scores."""
    got = np.take_along_axis(to_np(f32_full), to_np(ids).astype(np.int64), axis=1)
    np.testing.assert_allclose(-np.sort(-got, axis=1), to_np(acc_f32_vals), rtol=0, atol=5e-2)
    np.testing.assert_allclose(to_np(vals), got, **BF16_VALUES)
    np.testing.assert_allclose(to_np(vals), np.asarray(want_vals, np.float32), **BF16_VALUES)


@pytest.mark.parametrize("acc_dtype", ["float32", "bfloat16"])
def test_corpus_kernels_plain_bf16_match_pallas(acc_dtype):
    """Kernels 1 and 2's plain versions on a bf16 slab against the Pallas
    kernels (interpret mode) with the same acc_dtype."""
    n, rho, k, Bq, K = 256, 3, 8, 3, 8
    (jQ, ja, je, jP, jac, jv), args = _both_bf16(corpus_inputs(60, n, rho, k, Bq))
    full = ops.dplr_corpus_score(*args, acc_dtype=acc_dtype)
    assert full.dtype == torch.float32 and full.shape == (Bq, n)
    want = jops.dplr_corpus_score(jQ, ja, je, jP, jac, jv, block_n=64, acc_dtype=acc_dtype)
    vals, ids = ops.dplr_corpus_score(*args, topk=K, acc_dtype=acc_dtype)
    wv, _ = jops.dplr_corpus_score(jQ, ja, je, jP, jac, jv, topk=K, block_n=64,
                                   acc_dtype=acc_dtype)
    f32_full = ref.dplr_corpus_score_ref(*_upcast(args))
    if acc_dtype == "float32":
        assert_scores(full, want)
        assert_scores(vals, wv)
    else:
        live = to_np(args[5])
        np.testing.assert_allclose(to_np(full)[:, live], np.asarray(want)[:, live],
                                   **BF16_VALUES)
        _assert_bf16_topk(vals, ids, f32_full, wv, ref.topk_stable(f32_full, K)[0])
    assert to_np(args[5])[to_np(ids)].all()


@pytest.mark.parametrize("acc_dtype", ["float32", "bfloat16"])
def test_multi_plain_bf16_matches_pallas(acc_dtype):
    """Kernel 4's plain version on bf16 slabs of three lengths against the
    Pallas multi-segment kernel (interpret mode)."""
    rho, k, Bq, K = 3, 8, 2, 7
    parts = [_both_bf16(corpus_inputs(61 + s, n, rho, k, Bq)) for s, n in
             enumerate((64, 100, 37))]
    j = [p[0] for p in parts]
    t = [p[1] for p in parts]
    jargs = (tuple(p[0] for p in j), tuple(p[1] for p in j), tuple(p[5] for p in j),
             *(jnp.stack([p[i] for p in j]) for i in (2, 3, 4)))
    targs = (tuple(p[0] for p in t), tuple(p[1] for p in t), tuple(p[5] for p in t),
             *(torch.stack([p[i] for p in t]) for i in (2, 3, 4)))
    vals, ids = ops.dplr_corpus_score_multi(*targs, topk=K, acc_dtype=acc_dtype)
    wv, _ = jops.dplr_corpus_score_multi(*jargs, topk=K, block_n=32, acc_dtype=acc_dtype)
    for s in range(3):
        f32_full = ref.dplr_corpus_score_ref(*_upcast(t[s]))
        if acc_dtype == "float32":
            assert_scores(vals[s], np.asarray(wv)[s])
        else:
            _assert_bf16_topk(vals[s], ids[s], f32_full, np.asarray(wv)[s],
                              ref.topk_stable(f32_full, K)[0])
        one_v, one_i = ops.dplr_corpus_score(*t[s], topk=K, acc_dtype=acc_dtype)
        assert torch.equal(vals[s], one_v) and torch.equal(ids[s], one_i)


def test_bf16_calls_are_the_f32_calls_on_upcast_inputs():
    """With acc_dtype='float32', a bf16 call of kernels 1-4's plain versions
    is bitwise the float32 call on the upcast tensors (the card holds the
    kernels to the same rule: ``test_torch_cuda.py``)."""
    _, b16 = _both_bf16(corpus_inputs(62, 300, 3, 16, 4))
    up = _upcast(b16)
    assert torch.equal(ops.dplr_corpus_score(*b16), ops.dplr_corpus_score(*up))
    for got, want in zip(ops.dplr_corpus_score(*b16, topk=9, index_offset=2, index_stride=3),
                         ops.dplr_corpus_score(*up, topk=9, index_offset=2, index_stride=3)):
        assert torch.equal(got, want)
    stack = lambda a: ((a[0],) * 2, (a[1],) * 2, (a[5],) * 2,  # noqa: E731
                       *(torch.stack([a[i]] * 2) for i in (2, 3, 4)))
    for got, want in zip(ops.dplr_corpus_score_multi(*stack(b16), topk=9),
                         ops.dplr_corpus_score_multi(*stack(up), topk=9)):
        assert torch.equal(got, want)
    rng = np.random.default_rng(63)
    items = [rng.standard_normal(s).astype(np.float32)
             for s in ((2, 50, 7, 16), (3, 7), (3,), (7,), (2, 3, 16), (2,))]
    b16 = [torch.from_numpy(a).to(torch.bfloat16) for a in items]
    got = ops.dplr_score_items(*b16)
    assert got.dtype == torch.float32
    assert torch.equal(got, ops.dplr_score_items(*_upcast(b16)))


@pytest.mark.parametrize("acc_dtype", ["float16", "f32", "bf16", None])
def test_acc_dtype_other_values_raise(acc_dtype):
    """Names other than the reference's two raise.  ``None`` is not such a
    name: as in the reference's ``ops`` it resolves through the tuned-tile
    registry, to ``'float32'`` when nothing is tuned."""
    _, args = _both_bf16(corpus_inputs(64, 64, 3, 8, 2))
    multi = ((args[0],), (args[1],), None, args[2][None], args[3][None], args[4][None])
    if acc_dtype is None:
        assert torch.equal(ops.dplr_corpus_score(*args, acc_dtype=None),
                           ops.dplr_corpus_score(*args, acc_dtype="float32"))
        for got, want in zip(ops.dplr_corpus_score_multi(*multi, topk=4, acc_dtype=None),
                             ops.dplr_corpus_score_multi(*multi, topk=4, acc_dtype="float32")):
            assert torch.equal(got, want)
        return
    with pytest.raises(ValueError, match="acc_dtype"):
        ops.dplr_corpus_score(*args, acc_dtype=acc_dtype)
    with pytest.raises(ValueError, match="acc_dtype"):
        ops.dplr_corpus_score_multi(*multi, topk=4, acc_dtype=acc_dtype)


def test_score_items_plain_bf16_matches_pallas():
    """Kernel 3's plain version on bf16 candidate embeddings (and bf16 U_I,
    e, d_I, P_C, s_C) against the Pallas kernel in interpret mode, at the
    reference's bf16 tolerance (it squares V in bf16; the port in f32)."""
    rng = np.random.default_rng(65)
    n, mI, k, rho = 128, 38, 16, 3
    arrays = (rng.standard_normal((n, mI, k)), rng.standard_normal((rho, mI)),
              rng.standard_normal(rho), rng.standard_normal(mI),
              rng.standard_normal((rho, k)), np.asarray(0.37))
    arrays = tuple(np.asarray(a, np.float32) for a in arrays)
    j, t = _both_bf16(arrays)
    got = ops.dplr_score_items(*t)
    assert got.dtype == torch.float32 and got.shape == (n,)
    want = jops.dplr_score_items(*j, block_n=64)
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), rtol=5e-2, atol=5e-2)
    oracle = jref.dplr_score_items_ref(*[jnp.asarray(np.asarray(x, np.float32)) for x in j])
    np.testing.assert_allclose(to_np(got), np.asarray(oracle), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,slots,F,k", [(32, 6, 4, 16), (17, 3, 3, 8)])
def test_embedding_bag_plain_bf16_matches_pallas(B, slots, F, k):
    """Kernel 5's plain version on a bf16 table returns bf16 bags, within
    the reference's 2e-2 of the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(66)
    rows = 200
    table = rng.standard_normal((rows, k)).astype(np.float32)
    ids = rng.integers(0, rows, (B, slots)).astype(np.int32)
    w = rng.random((B, slots)).astype(np.float32)
    seg = tuple(int(x) for x in sorted(rng.integers(0, F, slots)))
    want = jops.embedding_bag(jnp.asarray(table, jnp.bfloat16), jnp.asarray(ids),
                              jnp.asarray(w), segment_ids=seg, n_bags=F)
    t16 = torch.from_numpy(table).to(torch.bfloat16)
    got = ops.embedding_bag(t16, torch.from_numpy(ids), torch.from_numpy(w).to(torch.bfloat16),
                            ops.bag_map(seg, F, "cpu"))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(to_np(got.float()), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def _bf16_params(jcfg, seed=0):
    """One set of f32 weights as bf16 on both sides, and the f32 ones."""
    jp = jfwfm.init(jax.random.PRNGKey(seed), jcfg)
    host = {k: np.asarray(v) for k, v in jp.items()}
    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, jp)
    return jp16, params_from_numpy(host, device="cpu", dtype=torch.bfloat16), host


def test_params_from_numpy_casts_float_leaves_to_the_jax_bits():
    jcfg = _setup()[0]
    jp16, tp16, host = _bf16_params(jcfg)
    for name, t in tp16.items():
        assert t.dtype == (torch.bfloat16 if host[name].dtype == np.float32
                           else torch.from_numpy(host[name]).dtype)
        np.testing.assert_array_equal(to_np(t.float()), np.asarray(jp16[name], np.float32))


def test_bf16_engine_matches_the_reference_engine():
    """The port's CorpusState on bf16 params and a bf16 cfg against the
    reference's ``CorpusRankingEngine(cfg16)`` (its
    ``test_engine_bf16_weights_follow_cfg_dtype``): both slabs bf16, context
    weights following cfg.dtype; the port's scores are float32 (the JAX
    jnp engine returns bf16: ROADMAP section 3), within the bf16 value
    tolerance, and its top-K ids equal the reference's except near ties."""
    jcfg, tcfg, _, q, ctx = _setup(n=40)
    jcfg16 = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    tcfg16 = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    jp16, tp16, _ = _bf16_params(jcfg)
    jeng = JEngine(jcfg16, q["item_ids"][0], q["item_weights"][0])
    teng = CorpusState(tcfg16, q["item_ids"][0], q["item_weights"][0], device="cpu")
    jeng.refresh(jp16, step=0)
    teng.refresh(tp16, step=0)
    assert jeng.cache.Q_I.dtype == jnp.bfloat16
    c = teng.cache
    assert c.Q_I.dtype == c.t_I.dtype == c.lin_I.dtype == c.a_I.dtype == torch.bfloat16
    assert teng._ctx_tensors(ctx, None)[1].dtype == torch.bfloat16
    assert jeng._ctx_arrays(ctx, None)[1].dtype == jnp.bfloat16
    np.testing.assert_allclose(to_np(c.Q_I.float()), np.asarray(jeng.cache.Q_I, np.float32),
                               **BF16_VALUES)
    want = np.asarray(jeng.score(ctx), np.float32)
    got = teng.score(ctx)
    assert got.dtype == torch.float32 and jeng.score(ctx).dtype == jnp.bfloat16
    live = teng.is_live(np.arange(teng.capacity))
    np.testing.assert_allclose(to_np(got)[:, live], want[:, live], **BF16_VALUES)
    K = 8
    vals, ids = teng.topk(ctx, K)
    wv, wi = jeng.topk(ctx, K)
    np.testing.assert_allclose(to_np(vals), np.asarray(wv, np.float32), **BF16_VALUES)
    full = to_np(got)
    for row in range(ctx.shape[0]):
        for j in np.flatnonzero(to_np(ids)[row] != np.asarray(wi)[row]):
            a, b = full[row, to_np(ids)[row, j]], full[row, np.asarray(wi)[row, j]]
            assert abs(a - b) <= BF16_VALUES["atol"] + BF16_VALUES["rtol"] * abs(b), (row, j)
    # the reference's serve driver casts params and keeps cfg: the slab is
    # bf16 all the same, the context weights float32
    teng32 = CorpusState(tcfg, q["item_ids"][0], q["item_weights"][0], device="cpu")
    teng32.refresh(tp16)
    assert teng32.cache.Q_I.dtype == torch.bfloat16
    assert teng32._ctx_tensors(ctx, None)[1].dtype == torch.float32
    assert torch.equal(teng32.score(ctx), got)


def test_bf16_tenants_pack_only_with_their_own_type():
    """A packed launch reads one slab type: fused_topk over bf16 tenants
    equals each tenant's own top-K, and a frontend does not pack a float32
    tenant with them (on the card a launch of mixed types raises:
    ``test_torch_cuda.py``)."""
    jcfg, tcfg, data, q, ctx = _setup(n=40)
    _, tp16, host = _bf16_params(jcfg)
    tp32 = params_from_numpy(host, device="cpu")
    rt = ScorerRuntime(tcfg, device="cpu")
    states = []
    for i, params in enumerate((tp16, tp16, tp32)):
        qi = data.ranking_query(40, 10 + i)
        states.append(CorpusState(None, qi["item_ids"][0], qi["item_weights"][0], runtime=rt))
        states[-1].refresh(params)
    stacked = np.stack([ctx, ctx])
    vals, ids = fused_topk(states[:2], stacked, 8)
    for s in range(2):
        one_v, one_i = states[s].topk(ctx, 8)
        assert torch.equal(vals[s], one_v) and torch.equal(ids[s], one_i)
    fe = QueryFrontend(dict(zip("abc", states)), max_batch=4, max_k=8, auto_pump=False,
                       pack=True)
    keys = {name: fe._pack_key(lane) for name, lane in fe._lanes.items()}
    assert keys["a"] == keys["b"] != keys["c"]
    fe.close()


def test_rank_items_on_bf16_params_matches_the_reference():
    """Algorithm 1 on bf16 params: the port (kernel 5 and kernel 3's plain
    versions in bf16, float32 scores) against the reference's
    ``rank_items`` through its Pallas item kernel (interpret mode), at that
    kernel's bf16 tolerance, and against its jnp path at the bf16 value
    tolerance."""
    jcfg, tcfg, data, _, _ = _setup()
    jp16, tp16, _ = _bf16_params(jcfg)
    a, b = data.ranking_query(30, 5), data.ranking_query(30, 6)
    query = {k: np.concatenate([a[k], b[k]]) for k in a}
    got = fwfm.rank_items(tp16, tcfg, {k: torch.as_tensor(v) for k, v in query.items()})
    assert got.dtype == torch.float32 and got.shape == (2, 30)
    jq = {k: jnp.asarray(v) for k, v in query.items()}
    pallas = jfwfm.rank_items(jp16, dataclasses.replace(jcfg, use_pallas_kernels=True), jq)
    np.testing.assert_allclose(to_np(got), np.asarray(pallas, np.float32), rtol=5e-2, atol=5e-2)
    plain = jfwfm.rank_items(jp16, jcfg, jq)
    np.testing.assert_allclose(to_np(got), np.asarray(plain, np.float32), **BF16_VALUES)


def test_apply_on_bf16_params_matches_the_reference():
    """Pointwise scoring on bf16 params: the field lookup in bf16 (kernel
    5's plain version), the pairwise term in bf16, bf16 logits, within the
    bf16 value tolerance of the reference's ``apply``."""
    jcfg, tcfg, data, _, _ = _setup()
    jp16, tp16, _ = _bf16_params(jcfg)
    batch = data.batch(64, 7)
    got = fwfm.apply(tp16, tcfg, {k: torch.as_tensor(batch[k]) for k in ("ids", "weights")})
    want = jfwfm.apply(jp16, jcfg, {k: jnp.asarray(batch[k]) for k in ("ids", "weights")})
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(to_np(got.float()), np.asarray(want, np.float32), **BF16_VALUES)


@pytest.mark.parametrize("flags,expect", [
    ([], "(corpus, bf16, cpu)"),
    (["--topk", "5"], "(corpus, top5, bf16, cpu)"),
    (["--engine", "percall"], "(percall, dplr-fwfm, bf16, cpu)"),
    (["--refresh-demo", "--queries", "12"], "refresh round-trip OK"),
    (["--tenant-demo", "--queries", "30", "--tenants", "3"], "checked bitwise"),
    (["--frontend", "--queries", "40"], "replies after the last burst bitwise lone calls"),
    (["--churn-demo", "--churn-ops", "40"], "churn OK"),
    (["--chaos-demo", "--queries", "24"], "chaos demo OK (cpu)"),
    (["--rpc", "--queries", "30", "--tenants", "3"], "graceful drain ok"),
    (["--arch", "wide-deep", "--items", "60", "--queries", "3"], "(percall, wide-deep, bf16"),
])
def test_serve_bf16_runs_every_loop_on_the_cpu(capsys, flags, expect):
    """``launch/serve.py --bf16`` at the smoke config through the query,
    percall, refresh, tenant, frontend, churn, chaos and rpc loops: each
    asserts its own contract (bitwise replies, live slots, a refresh from a
    float32 checkpoint cast to bf16) and prints its summary."""
    serve.main(["--device", "cpu", "--bf16", "--items", "200", "--queries", "5", *flags])
    out = capsys.readouterr().out
    assert expect in out, out


def test_serve_bf16_refresh_reads_a_float32_checkpoint(tmp_path):
    """Checkpoints stay float32 on disk; ``maybe_refresh`` with
    ``to_serving_dtype`` installs them as bf16."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.registry import REGISTRY

    cfg = REGISTRY["dplr-fwfm"].make_smoke()
    p32 = fwfm.init(torch.Generator().manual_seed(0), cfg)
    p16 = serve.to_serving_dtype(p32, True)
    assert all(v.dtype == torch.bfloat16 for v in p16.values())
    on_disk = serve.to_checkpoint_dtype(p16)
    assert all(v.dtype == torch.float32 for v in on_disk.values())
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"params": on_disk}, step=3, blocking=True)
    from repro_torch.data.synthetic_ctr import SyntheticCTR
    q = SyntheticCTR(cfg.layout, embed_dim=4, seed=0).ranking_query(50, 0)
    st = CorpusState(cfg, q["item_ids"][0], q["item_weights"][0], device="cpu")
    assert st.maybe_refresh(mgr, {"params": on_disk},
                            select=lambda t: serve.to_serving_dtype(t["params"], True))
    assert st.model_step == 3 and st.cache.Q_I.dtype == torch.bfloat16
    assert all(torch.equal(st.params[k], p16[k]) for k in p16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_order_bag_is_the_plain_bag_on_the_cpu(dtype):
    """``ref.embedding_bag_in_order`` (the card checks hold kernel 5 to it
    bitwise on multi-hot bags) is the plain version where that one adds in
    slot order, as ``index_add_`` does on the CPU."""
    rng = np.random.default_rng(67)
    table = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32)).to(dtype)
    ids = torch.from_numpy(rng.integers(0, 50, (7, 3, 9)).astype(np.int32))
    w = torch.from_numpy(rng.random((7, 3, 9)).astype(np.float32))
    seg = np.sort(rng.integers(0, 4, 9))
    got = ref.embedding_bag_in_order(table, ids, w, seg, 4)
    assert got.dtype == dtype and torch.equal(got, ref.embedding_bag_ref(table, ids, w, seg, 4))


@pytest.mark.parametrize("B,m,k", [(33, 7, 4), (16, 12, 3), (5, 39, 16)])
def test_fwfm_pairwise_plain_bf16_v_matches_pallas(B, m, k):
    """Kernel 6's plain version on a bf16 ``V`` against the Pallas kernel in
    interpret mode on the same bf16 ``V`` (both form the Gram in f32), within
    the f32 parity bound; and bitwise the f32 call on the upcast ``V``, as
    the kernel is on the card.  ``R`` in bf16 is upcast first."""
    from repro.kernels.fwfm_interaction import fwfm_pairwise as jpair

    rng = np.random.default_rng(B + m + k)
    V = rng.standard_normal((B, m, k)).astype(np.float32)
    R = (rng.standard_normal((m, m)) * 0.1).astype(np.float32)
    (jV,), (tV,) = _both_bf16((V,))
    want = np.asarray(jpair(jV, jnp.asarray(R), interpret=True))
    got = ops.fwfm_pairwise(tV, torch.from_numpy(R))
    assert got.dtype == torch.float32
    assert_scores(got, want)
    assert torch.equal(got, ops.fwfm_pairwise(tV.float(), torch.from_numpy(R)))
    R16 = torch.from_numpy(R).to(torch.bfloat16)
    assert torch.equal(ops.fwfm_pairwise(tV, R16), ops.fwfm_pairwise(tV.float(), R16.float()))


def test_fwfm_pairwise_bf16_v_gradient_is_the_f32_one_cast():
    """Differentiable in a bf16 ``V`` on the CPU: the gradient is the f32
    plain version's, on the upcast ``V``, cast to bf16 (as the card's
    backward computes it)."""
    rng = np.random.default_rng(3)
    V = torch.from_numpy(rng.standard_normal((6, 5, 4)).astype(np.float32)).to(torch.bfloat16)
    R = torch.from_numpy(rng.standard_normal((5, 5)).astype(np.float32))
    V16 = V.clone().requires_grad_()
    ops.fwfm_pairwise(V16, R).sum().backward()
    V32 = V.float().requires_grad_()
    ops.fwfm_pairwise(V32, R).sum().backward()
    assert V16.grad.dtype == torch.bfloat16
    assert torch.equal(V16.grad, V32.grad.to(torch.bfloat16))


def test_a_bf16_full_fwfm_model_evaluates_through_the_harness():
    """``eval.harness.evaluate_pointwise`` on a bf16 full-FwFM model, as
    the JAX harness evaluates one: finite metrics, and logits equal to the
    f32 pairwise term on the bf16 model's own (bf16) field embeddings."""
    from repro_torch.configs import dplr_fwfm
    from repro_torch.data.synthetic_ctr import SyntheticCTR
    from repro_torch.embedding.bag import lookup_field_embeddings
    from repro_torch.eval import harness

    cfg = dataclasses.replace(dplr_fwfm.make_smoke(), interaction="fwfm", dtype=torch.bfloat16)
    params = fwfm.init(torch.Generator().manual_seed(0), dataclasses.replace(cfg,
                                                                             dtype=torch.float32))
    params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    data = SyntheticCTR(cfg.layout, embed_dim=8, teacher_rank=2, seed=0)
    out = harness.evaluate_pointwise(params, cfg, data, n=512, batch_size=128)
    assert out["n"] == 512 and all(np.isfinite(out[k]) for k in ("auc", "logloss"))
    rows = data.batch(64, 0)
    b = {"ids": torch.as_tensor(rows["ids"]), "weights": torch.as_tensor(
        rows["weights"]).to(torch.bfloat16)}
    logits = fwfm.apply(params, cfg, b)
    V = lookup_field_embeddings(params["embedding"], cfg.layout, b["ids"], b["weights"])
    assert V.dtype == torch.bfloat16 and logits.dtype == torch.float32
    assert torch.equal(fwfm._pairwise(params, cfg, V, None),
                       ops.fwfm_pairwise(V.float(), fwfm.field_matrix(params, cfg).float()))

"""The port's kernel entry points (``repro_torch.kernels.ops``) against the
JAX package's Pallas kernels (interpret mode on the CPU) and oracles.

On the CPU the entry points run their plain PyTorch versions
(``tests/test_torch_cuda.py`` holds the CUDA kernels against those on a
card).  Inputs are made with numpy from a seed and handed to both
packages.  Tolerance: scores within atol = rtol = 1e-5; top-K ids equal
except between scores tied within that tolerance."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.dplr_corpus_score import MAX_RK, NEG_INF  # noqa: E402

from test_torch_parity import assert_scores, assert_topk, corpus_inputs, to_np  # noqa: E402


def _both(arrays):
    return (tuple(jnp.asarray(a) for a in arrays),
            tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays))


@pytest.mark.parametrize("n,rho,k,Bq,block_n", [
    (64, 2, 8, 1, 32),
    (1000, 3, 16, 4, 256),      # n not a multiple of the tile
    (130, 5, 16, 2, 64),
])
def test_corpus_score_full_matches_pallas_and_oracle(n, rho, k, Bq, block_n):
    (jQ, ja, je, jP, jac, jv), args = _both(corpus_inputs(0, n, rho, k, Bq))
    got = ops.dplr_corpus_score(*args)
    assert got.shape == (Bq, n) and got.dtype == torch.float32
    assert_scores(got, jops.dplr_corpus_score(jQ, ja, je, jP, jac, jv, block_n=block_n))
    assert_scores(got, jref.dplr_corpus_score_ref(jQ, ja, je, jP, jac, jv))
    dead = ~to_np(args[5])
    assert np.all(to_np(got)[:, dead] == NEG_INF)


@pytest.mark.parametrize("K", [1, 7, 16])
@pytest.mark.parametrize("n,block_n", [(100, 32), (256, 64), (1000, 256)])
def test_corpus_topk_matches_pallas_and_oracle(n, block_n, K):
    rho, k, Bq = 3, 8, 3
    (jQ, ja, je, jP, jac, jv), args = _both(corpus_inputs(1, n, rho, k, Bq))
    vals, ids = ops.dplr_corpus_score(*args, topk=K)
    assert ids.dtype == torch.int32 and vals.shape == ids.shape == (Bq, K)
    full = jref.dplr_corpus_score_ref(jQ, ja, je, jP, jac, jv)
    want_v, want_i = jops.dplr_corpus_score(jQ, ja, je, jP, jac, jv, topk=K,
                                            block_n=block_n)
    assert_topk(vals, ids, want_v, want_i, full)
    assert_topk(vals, ids, *jref.dplr_corpus_topk_ref(jQ, ja, je, jP, jac, K, jv), full)
    # planted ties go to the lower slot; a dead slot never wins
    got = to_np(ids)
    for row in got:
        for j in range(4):
            if n // 2 + j in row:
                assert list(row).index(j) < list(row).index(n // 2 + j)
    assert to_np(args[5])[got].all()


def test_corpus_topk_relabels_with_offset_and_stride():
    n, rho, k, Bq, K = 200, 3, 8, 2, 9
    (jQ, ja, je, jP, jac, jv), args = _both(corpus_inputs(2, n, rho, k, Bq))
    vals, ids = ops.dplr_corpus_score(*args, topk=K, index_offset=3, index_stride=4)
    want_v, want_i = jops.dplr_corpus_score(jQ, ja, je, jP, jac, jv, topk=K, block_n=64,
                                            index_offset=3, index_stride=4)
    full = jref.dplr_corpus_score_ref(jQ, ja, je, jP, jac, jv)
    assert_topk(vals, ids, want_v, want_i, full, offset=3, stride=4)


def test_plain_topk_breaks_exact_ties_to_the_lowest_slot():
    scores = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, NEG_INF, NEG_INF]])
    vals, idx = ref.topk_stable(scores, 6)
    assert idx.tolist() == [[1, 2, 4, 3, 0, 5]]
    assert vals[0, :3].tolist() == [3.0, 3.0, 3.0]


@pytest.mark.parametrize("n,mI,k,rho,block_n", [
    (64, 4, 8, 1, 32),
    (1000, 12, 16, 3, 256),     # n not a multiple of the tile
    (257, 38, 16, 5, 128),      # the paper's 38 item fields
    (128, 7, 32, 2, 128),
])
def test_score_items_matches_pallas_and_oracle(n, mI, k, rho, block_n):
    # model-like scales: embeddings ~ 1/sqrt(k), e > 0 and d < 0 as the
    # DPLR init gives them (unit-normal everything makes sums of hundreds
    # that cancel, where two summation orders part by more than 1e-5)
    rng = np.random.default_rng(3)
    arrays = (rng.standard_normal((n, mI, k), dtype=np.float32) / np.sqrt(k),
              rng.standard_normal((rho, mI), dtype=np.float32) / np.sqrt(mI),
              rng.random(rho).astype(np.float32) + 0.5,
              -rng.random(mI).astype(np.float32),
              rng.standard_normal((rho, k), dtype=np.float32),
              np.float32(0.37))
    jargs, args = _both([np.asarray(a, np.float32) for a in arrays])
    got = ops.dplr_score_items(*args)
    assert got.shape == (n,)
    assert_scores(got, jops.dplr_score_items(*jargs, block_n=block_n))
    assert_scores(got, jref.dplr_score_items_ref(*jargs))


def test_score_items_batched_equals_per_query_calls():
    rng = np.random.default_rng(4)
    Bq, n, mI, k, rho = 3, 50, 6, 8, 2
    V = torch.from_numpy(rng.standard_normal((Bq, n, mI, k), dtype=np.float32))
    U = torch.from_numpy(rng.standard_normal((rho, mI), dtype=np.float32))
    e = torch.from_numpy(rng.standard_normal(rho).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal(mI).astype(np.float32))
    PC = torch.from_numpy(rng.standard_normal((Bq, rho, k), dtype=np.float32))
    sC = torch.from_numpy(rng.standard_normal(Bq).astype(np.float32))
    batched = ops.dplr_score_items(V, U, e, d, PC, sC)
    assert batched.shape == (Bq, n)
    for q in range(Bq):
        assert_scores(batched[q], ops.dplr_score_items(V[q], U, e, d, PC[q], sC[q]))


def test_entry_points_reject_what_the_kernels_do_not_take():
    """The range checks the reference makes too, on either device (the
    kernels' own limits are checked on CUDA tensors only:
    ``test_torch_cuda.py``)."""
    _, args = _both(corpus_inputs(5, 64, 3, 8, 2))
    with pytest.raises(ValueError, match="topk"):
        ops.dplr_corpus_score(*args, topk=65)
    with pytest.raises(ValueError, match="topk"):
        ops.dplr_corpus_score(*args, topk=0)
    with pytest.raises(ValueError, match="shape"):
        ops.dplr_corpus_score(args[0], args[1][:10], *args[2:])
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="device"):
        ops.dplr_corpus_score(*meta)


# Past the CUDA kernels' limits (rho * k > MAX_RK, more than MAX_SEGMENTS
# segments), and past the card's old K limit of 4096, the CPU path answers as
# the JAX oracles do.

@pytest.mark.parametrize("n,rho,k,K", [
    (4096 + 904, 2, 4, 4096 + 1),              # K past the card's old limit
    (300, 3, MAX_RK // 3 + 1, 9),              # rho * k past it
])
def test_corpus_score_past_the_kernel_limits_matches_the_oracle(n, rho, k, K):
    (jQ, ja, je, jP, jac, jv), args = _both(corpus_inputs(9, n, rho, k, 2))
    full = ops.dplr_corpus_score(*args)
    assert_scores(full, jref.dplr_corpus_score_ref(jQ, ja, je, jP, jac, jv))
    vals, ids = ops.dplr_corpus_score(*args, topk=K)
    want_v, want_i = jref.dplr_corpus_topk_ref(jQ, ja, je, jP, jac, K, jv)
    assert_scores(vals, want_v)
    np.testing.assert_array_equal(to_np(ids), to_np(want_i))


def test_score_items_past_the_rk_limit_matches_the_oracle():
    rng = np.random.default_rng(10)
    n, mI, k, rho = 200, 6, MAX_RK // 2, 3            # rho * k = 192
    arrays = (rng.standard_normal((n, mI, k), dtype=np.float32) / np.sqrt(k),
              rng.standard_normal((rho, mI), dtype=np.float32) / np.sqrt(mI),
              rng.random(rho).astype(np.float32) + 0.5,
              -rng.random(mI).astype(np.float32),
              rng.standard_normal((rho, k), dtype=np.float32) / np.sqrt(k),
              np.float32(0.37))
    jargs, args = _both([np.asarray(a, np.float32) for a in arrays])
    assert_scores(ops.dplr_score_items(*args), jref.dplr_score_items_ref(*jargs))


@pytest.mark.parametrize("ns,rk,K", [
    ((4096 + 500, 4096 + 100), (2, 4), 4096 + 1),               # K past the old limit
    ((40,) * 65, (3, 8), 5),                                    # 65 segments
    ((70, 50), (3, MAX_RK // 3 + 1), 9),                        # rho * k past it
])
def test_corpus_multi_past_the_kernel_limits_matches_the_oracle(ns, rk, K):
    parts = [corpus_inputs(40 + s, n, *rk, 2) for s, n in enumerate(ns)]
    jparts, tparts = zip(*(_both(p) for p in parts))
    e, P_C, a_C = (np.stack([p[j] for p in parts]) for j in (2, 3, 4))
    vals, ids = ops.dplr_corpus_score_multi(
        tuple(p[0] for p in tparts), tuple(p[1] for p in tparts),
        tuple(p[5] for p in tparts), *(torch.from_numpy(a) for a in (e, P_C, a_C)), topk=K)
    want_v, want_i = jref.dplr_corpus_multi_topk_ref(
        tuple(p[0] for p in jparts), tuple(p[1] for p in jparts),
        tuple(p[5] for p in jparts), *(jnp.asarray(a) for a in (e, P_C, a_C)), K)
    assert vals.shape == ids.shape == (len(ns), 2, K)
    assert_scores(vals, want_v)
    np.testing.assert_array_equal(to_np(ids), to_np(want_i))


def test_cpu_path_counts_no_launches():
    _, args = _both(corpus_inputs(6, 64, 3, 8, 2))
    ops.reset_launches()
    ops.dplr_corpus_score(*args)
    ops.dplr_corpus_score(*args, topk=4)
    assert sum(ops.LAUNCHES.values()) == 0


def test_build_raises_without_nvcc(monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


# -- kernel 5: embedding_bag --------------------------------------------------

def _bag_inputs(seed, B, slots, F, k, rows=200, multi_hot=False):
    """(table, ids, weights, seg) as numpy: arena-global ids, a sorted slot
    -> bag map (with ``multi_hot``, bags of 1-4 slots and one empty bag)."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((rows, k), dtype=np.float32)
    ids = rng.integers(0, rows, (B, slots)).astype(np.int32)
    w = rng.random((B, slots)).astype(np.float32)
    if multi_hot:
        sizes = [1, 4, 0, 2, 3][:F]
        seg = np.repeat(np.arange(len(sizes)), sizes)[:slots]
    else:
        seg = np.sort(rng.integers(0, F, slots))
    return table, ids, w, seg


@pytest.mark.parametrize("B,slots,F,k,multi_hot", [
    (32, 6, 4, 16, False),      # tests/test_kernels.py's shapes
    (17, 3, 3, 8, False),
    (9, 10, 5, 16, True),       # bags of 1-4 slots and an empty bag
])
def test_embedding_bag_matches_pallas_and_oracle(B, slots, F, k, multi_hot):
    table, ids, w, seg = _bag_inputs(9, B, slots, F, k, multi_hot=multi_hot)
    got = ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                            torch.from_numpy(w), ops.bag_map(seg, F, "cpu"))
    assert got.shape == (B, F, k) and got.dtype == torch.float32
    assert_scores(got, jops.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                          jnp.asarray(w), segment_ids=seg, n_bags=F))
    assert_scores(got, jref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(ids),
                                              jnp.asarray(w), seg, F))


def test_embedding_bag_flattens_leading_dims_and_takes_int64_ids():
    table, ids, w, seg = _bag_inputs(10, 12, 5, 3, 8)
    t, i, ww = (torch.from_numpy(a) for a in (table, ids, w))
    bags = ops.bag_map(seg, 3, "cpu")
    flat = ops.embedding_bag(t, i, ww, bags)
    batched = ops.embedding_bag(t, i.view(3, 4, 5), ww.view(3, 4, 5), bags)
    assert batched.shape == (3, 4, 3, 8)
    assert torch.equal(batched.reshape(12, 3, 8), flat)
    assert torch.equal(ops.embedding_bag(t, i.long(), ww, bags), flat)


def test_embedding_bag_rejects_ids_outside_the_table():
    table, ids, w, seg = _bag_inputs(11, 4, 3, 2, 8)
    for bad in (-1, table.shape[0]):
        ids[1, 2] = bad
        with pytest.raises(IndexError, match="embedding ids"):
            ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                              torch.from_numpy(w), ops.bag_map(seg, 2, "cpu"))


def test_embedding_bag_csr_is_in_slot_order_and_built_once():
    from repro_torch.configs import dplr_fwfm
    from repro_torch.embedding import bag

    seg = np.array([2, 0, 2, 1, 0, 2])
    bags = ops.bag_map(seg, 4, "cpu")
    assert bags.bag_ptr.tolist() == [0, 2, 3, 6, 6]          # bag 3 is empty
    assert bags.bag_slots.tolist() == [1, 4, 3, 0, 2, 5]     # ascending within a bag
    assert bags.segments.tolist() == seg.tolist() and bags.n_bags == 4
    with pytest.raises(ValueError, match="segment ids"):
        ops.bag_map(np.array([0, 3]), 3, "cpu")
    # a layout's map is built once per device and kept for its lookups
    layout = dplr_fwfm.make_smoke().layout
    kept = bag._statics(layout, "item", "cpu").bags
    assert bag._statics(layout, "item", "cpu").bags is kept
    np.testing.assert_array_equal(kept.segments.numpy(), layout.subset("item").slot_to_field)


# -- kernel 6: fwfm_pairwise --------------------------------------------------

def _symmetric(rng, m):
    R = rng.standard_normal((m, m)).astype(np.float32)
    R = 0.5 * (R + R.T)
    np.fill_diagonal(R, 0)
    return R


@pytest.mark.parametrize("B,m,k,block_b", [
    (64, 8, 8, 32),             # tests/test_kernels.py's shapes
    (300, 14, 16, 128),
    (128, 39, 16, 64),
    (1, 82, 16, 8),             # the full dplr-fwfm field count
])
def test_fwfm_pairwise_matches_pallas_and_oracle(B, m, k, block_b):
    rng = np.random.default_rng(12)
    V = (rng.standard_normal((B, m, k)) / np.sqrt(k)).astype(np.float32)
    R = _symmetric(rng, m) * np.float32(0.1)
    got = ops.fwfm_pairwise(torch.from_numpy(V), torch.from_numpy(R))
    assert got.shape == (B,) and got.dtype == torch.float32
    assert_scores(got, jops.fwfm_pairwise(jnp.asarray(V), jnp.asarray(R), block_b=block_b))
    assert_scores(got, jref.fwfm_pairwise_ref(jnp.asarray(V), jnp.asarray(R)))
    batched = ops.fwfm_pairwise(torch.from_numpy(V).view(1, B, m, k), torch.from_numpy(R))
    assert torch.equal(batched.view(B), got)


@pytest.mark.parametrize("m,k", [(129, 16), (8, 36), (8, 10)])
def test_fwfm_pairwise_rejects_what_the_kernel_does_not_take(m, k):
    """The kernel's limits are m <= 128 and k <= 32 (a k that is not a
    multiple of 4 takes its scalar path); the plain version has none."""
    from repro_torch.kernels import fwfm_interaction

    if m > fwfm_interaction.MAX_M or k > fwfm_interaction.MAX_K:
        with pytest.raises(ValueError, match="the kernel takes m"):
            fwfm_interaction.check_limits(m, k)
    else:
        fwfm_interaction.check_limits(m, k)
    rng = np.random.default_rng(13)
    V = (rng.standard_normal((3, m, k)) / np.sqrt(k)).astype(np.float32)
    R = _symmetric(rng, m) * np.float32(0.1)
    assert_scores(ops.fwfm_pairwise(torch.from_numpy(V), torch.from_numpy(R)),
                  jref.fwfm_pairwise_ref(jnp.asarray(V), jnp.asarray(R)))


# -- gradients: the card's kernels run forward, the plain vjp backward --------

def test_embedding_bag_vjp_matches_autograd_of_the_plain_version():
    table, ids, w, seg = _bag_inputs(14, 9, 10, 5, 16, multi_hot=True)
    t = torch.from_numpy(table).requires_grad_()
    ww = torch.from_numpy(w).requires_grad_()
    i = torch.from_numpy(ids).view(3, 3, 10)
    out = ref.embedding_bag_ref(t, i, ww.view(3, 3, 10), seg, 5)
    grad = torch.from_numpy(np.random.default_rng(15).standard_normal(out.shape)
                            .astype(np.float32))
    want = torch.autograd.grad(out, (t, ww), grad)
    got = ref.embedding_bag_vjp(t.detach(), i, ww.detach().view(3, 3, 10), seg, grad)
    assert_scores(got[0], want[0].numpy())
    assert_scores(got[1].reshape(9, 10), want[1].numpy())


@pytest.mark.parametrize("lead,m,k", [((7,), 8, 8), ((2, 3), 14, 10)])
def test_fwfm_pairwise_vjp_matches_autograd_of_the_plain_version(lead, m, k):
    rng = np.random.default_rng(16)
    V = torch.from_numpy((rng.standard_normal((*lead, m, k)) / np.sqrt(k))
                         .astype(np.float32)).requires_grad_()
    R = torch.from_numpy(rng.standard_normal((m, m)).astype(np.float32)).requires_grad_()
    grad = torch.from_numpy(rng.standard_normal(lead).astype(np.float32))
    want = torch.autograd.grad(ref.fwfm_pairwise_ref(V, R), (V, R), grad)
    got = ref.fwfm_pairwise_vjp(V.detach(), R.detach(), grad)
    assert_scores(got[0], want[0].numpy())
    assert_scores(got[1], want[1].numpy())


def test_kernel_autograd_functions_pass_the_plain_vjp(monkeypatch):
    """The autograd wrappers that the card uses, driven on the CPU with the
    launchers replaced by the plain versions: their gradients are the
    plain version's autograd gradients."""
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.kernels import fwfm_interaction as kfwfm

    monkeypatch.setattr(kbag, "launch", lambda t, i, w, b: ref.embedding_bag_ref(
        t, i, w, b.segments, b.n_bags))
    monkeypatch.setattr(kfwfm, "launch", ref.fwfm_pairwise_ref)
    table, ids, w, seg = _bag_inputs(17, 6, 10, 5, 8, multi_hot=True)
    bags = ops.bag_map(seg, 5, "cpu")
    t = torch.from_numpy(table).requires_grad_()
    R = torch.from_numpy(_symmetric(np.random.default_rng(18), 5)).requires_grad_()

    def score(bag_fn, pair_fn):
        V = bag_fn(t, torch.from_numpy(ids), torch.from_numpy(w), bags)
        return (pair_fn(V, R) ** 2).sum()

    plain = torch.autograd.grad(score(lambda *a: ref.embedding_bag_ref(
        *a[:3], a[3].segments, a[3].n_bags), ref.fwfm_pairwise_ref), (t, R))
    ops.reset_launches()
    wired = torch.autograd.grad(score(ops._EmbeddingBag.apply, ops._FwFMPairwise.apply),
                                (t, R))
    assert ops.LAUNCHES == {"embedding_bag_kernel": 1, "fwfm_pairwise_kernel": 1}
    for g, want in zip(wired, plain):
        assert_scores(g, want.numpy())


# -- kernel 7: flash_attention ------------------------------------------------
#
# f32 within atol = rtol = 1e-5.  bf16 within 2^-7 max|v|: both versions
# round p and the output to bf16 once, and a running max that differs can
# move each rounding by one ulp.  So, per element, also within
# 2^-7 (|o| + sum_j p_j |v_j| / l) + 1e-5 max|v|: one output ulp, one ulp of
# each p, and the f32 bound.

def _attn_inputs(seed, B, S, H, KV, hd, dtype):
    """q, k, v as numpy f32 holding values exact in ``dtype``, and as JAX
    arrays of ``dtype``."""
    rng = np.random.default_rng(seed)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    arrays = [jnp.asarray(rng.standard_normal((B, S, n, hd), dtype=np.float32), jdt)
              for n in (H, KV, KV)]
    return [np.asarray(a, np.float32) for a in arrays], arrays


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,KV,hd,window,block", [
    (2, 128, 4, 1, 32, None, 64),     # GQA, G = 4
    (1, 192, 4, 1, 256, 96, 64),      # gemma3-1b's heads, a window
    (2, 128, 4, 4, 16, 48, 32),       # MHA with a window
    (1, 200, 8, 2, 16, 64, 40),       # S not a multiple of 64
    (1, 200, 8, 2, 16, None, 40),
])
def test_flash_attention_plain_matches_pallas_and_oracle(B, S, H, KV, hd, window, block,
                                                         dtype):
    arrays, (jq, jk, jv) = _attn_inputs(11, B, S, H, KV, hd, dtype)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, window=window)
    assert got.shape == q.shape and got.dtype == tdt
    assert sum(ops.LAUNCHES.values()) == 0
    pallas = jops.flash_attention(jq, jk, jv, window=window, block_q=block, block_k=block)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
    size = ref.flash_attention_plain(q, k, v, window=window, with_size=True)[1].numpy()
    vmax = np.abs(arrays[2]).max()
    # the default query block, and one that cuts the keys' span elsewhere
    for out in (got, ref.flash_attention_plain(q, k, v, window=window, block=48)):
        out = out.float().numpy()
        for want in (pallas, oracle):
            want = np.asarray(want, np.float32)
            if dtype == "f32":
                np.testing.assert_allclose(out, want, atol=1e-5, rtol=1e-5)
            else:
                diff = np.abs(out - want)
                assert diff.max() <= 2.0**-7 * vmax
                assert (diff <= 2.0**-7 * (np.abs(want) + size) + 1e-5 * vmax).all()


def test_flash_attention_oracle_matches_jax():
    arrays, jarrays = _attn_inputs(12, 2, 40, 4, 2, 8, "f32")
    for window in (None, 7):
        np.testing.assert_allclose(
            ref.flash_attention_ref(*map(torch.from_numpy, arrays), window=window).numpy(),
            np.asarray(jref.flash_attention_ref(*jarrays, causal=True, window=window)),
            atol=1e-5, rtol=1e-5)


def test_flash_attention_rejects_bad_shapes():
    q, k = torch.zeros((1, 8, 4, 16)), torch.zeros((1, 8, 3, 16))
    with pytest.raises(ValueError, match="group"):
        ops.flash_attention(q, k, k)
    k = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="shape"):
        ops.flash_attention(q, k, k[:, :4])
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, k, window=0)
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))

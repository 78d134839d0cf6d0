"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports no JAX, so that it runs where the card is:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Skips where ``torch.cuda.is_available()`` is False (the kernels are CUDA
C++ and have no CPU mode).  Tolerance: atol = rtol = 1e-5; top-K ids equal
except between scores tied within that."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.dplr_corpus_score import (  # noqa: E402
    MAX_RK, MAX_SEGMENTS, NEG_INF)

from test_torch_parity import assert_scores, assert_topk, corpus_inputs, to_np  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ and have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,sorts", [(1000, 7, (0, 0)), (70_000, 16, (0, 0)),
                                       (70_000, 1024, (0, 0)), (70_000, 4096, (0, 0)),
                                       (70_000, 4097, (1, 0)), (70_000, 40_000, (1, 2))])
def test_cuda_corpus_kernels_match_plain(cuda, n, K, sorts):
    """Each top-K call launches stage 1 and the merge once; past K = 4096
    the winners' sort adds ``topk_sort_tiles`` once and ``topk_sort_merge``
    once per doubling of 16,384-entry runs (``sorts`` per call)."""
    arrays = corpus_inputs(7, n, 3, 16, 5)
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in arrays)
    ops.reset_launches()
    full = ref.dplr_corpus_score_ref(*args)
    assert_scores(ops.dplr_corpus_score(*args), full)
    vals, ids = ops.dplr_corpus_score(*args, topk=K)
    assert_topk(vals, ids, *ref.dplr_corpus_topk_ref(*args[:5], K, args[5]), full)
    got = to_np(ids)
    for row in got:
        for j in range(4):
            if n // 2 + j in row:
                assert list(row).index(j) < list(row).index(n // 2 + j)
    assert to_np(args[5])[got].all()
    assert (to_np(ops.dplr_corpus_score(*args))[:, ~to_np(args[5])] == NEG_INF).all()
    vals, ids = ops.dplr_corpus_score(*args, topk=K, index_offset=3, index_stride=4)
    assert_topk(vals, ids, *ref.dplr_corpus_topk_ref(*args[:5], K, args[5], 3, 4), full,
                offset=3, stride=4)
    assert ops.LAUNCHES["corpus_score_full"] == ops.LAUNCHES["corpus_topk_chunks"] == 2
    assert ops.LAUNCHES["topk_merge"] == 2
    assert (ops.LAUNCHES["topk_sort_tiles"], ops.LAUNCHES["topk_sort_merge"]) == (
        2 * sorts[0], 2 * sorts[1])


@pytest.mark.cuda
def test_cuda_score_items_matches_plain(cuda):
    rng = np.random.default_rng(8)
    Bq, n, mI, k, rho = 3, 1000, 38, 16, 3
    arrays = (rng.standard_normal((Bq, n, mI, k), dtype=np.float32) * 0.25,
              rng.standard_normal((rho, mI), dtype=np.float32) * 0.2,
              rng.random(rho).astype(np.float32) + 0.5,
              -rng.random(mI).astype(np.float32),
              rng.standard_normal((Bq, rho, k), dtype=np.float32),
              rng.standard_normal(Bq).astype(np.float32))
    args = tuple(torch.from_numpy(a).to(cuda) for a in arrays)
    ops.reset_launches()
    assert_scores(ops.dplr_score_items(*args), ref.dplr_score_items_ref(*args))
    assert ops.LAUNCHES == {"dplr_score_items_kernel": 1}
    with pytest.raises(TypeError, match="dtype"):
        ops.dplr_score_items(args[0].double(), *args[1:])


@pytest.mark.cuda
def test_cuda_corpus_kernels_refuse_past_their_limits(cuda):
    """rho * k > MAX_RK and more than MAX_SEGMENTS segments raise on the card
    (the CPU's plain versions answer them: ``test_torch_kernels.py``); any
    0 < K <= n is answered, here K = 4097 (past the old limit) and K = n, as
    the plain version answers it."""
    n = 4096 + 10
    arrays = corpus_inputs(9, n, 2, 4, 2)
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in arrays)
    full = ref.dplr_corpus_score_ref(*args)
    for K in (4097, n):
        vals, ids = ops.dplr_corpus_score(*args, topk=K)
        assert_topk(vals, ids, *ref.dplr_corpus_topk_ref(*args[:5], K, args[5]), full)
    wide = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                 for a in corpus_inputs(9, 64, 3, MAX_RK // 3 + 1, 2))
    with pytest.raises(ValueError, match="rho \\* k"):
        ops.dplr_corpus_score(*wide)
    with pytest.raises(ValueError, match="rho \\* k"):
        ops.dplr_corpus_score(*wide, topk=4)
    V = torch.zeros((2, 8, 5, MAX_RK // 3 + 1), device=cuda)
    with pytest.raises(ValueError, match="rho \\* k"):
        ops.dplr_score_items(V, torch.zeros((3, 5), device=cuda), torch.zeros(3, device=cuda),
                             torch.zeros(5, device=cuda),
                             torch.zeros((2, 3, MAX_RK // 3 + 1), device=cuda),
                             torch.zeros(2, device=cuda))
    S = MAX_SEGMENTS + 1
    Q, a = (args[0][:64],) * S, (args[1][:64],) * S
    e, P_C, a_C = (t[None].repeat(S, *(1,) * t.ndim) for t in args[2:5])
    with pytest.raises(ValueError, match="segments"):
        ops.dplr_corpus_score_multi(Q, a, None, e, P_C, a_C, topk=4)
    Q, a, valid = (args[0],) * 2, (args[1],) * 2, (args[5],) * 2
    for K in (4097, n):
        vals, ids = ops.dplr_corpus_score_multi(Q, a, valid, e[:2], P_C[:2], a_C[:2], topk=K)
        want_v, want_i = ref.dplr_corpus_multi_topk_ref(Q, a, valid, e[:2], P_C[:2], a_C[:2], K)
        for s in range(2):
            assert_topk(vals[s], ids[s], want_v[s], want_i[s], full)


def _adversarial(case, arrays, K, rng):
    """corpus_inputs' arrays in an adversarial order: scores rising or
    falling with the slot, every slot equal, or K // 2 live slots."""
    Q, a_I, e, PC, a_C, valid = (np.array(a) for a in arrays)
    n = len(a_I)
    valid[:] = True
    if case == "rising":
        a_I += np.float32(1e-3) * np.arange(n, dtype=np.float32)
    elif case == "falling":
        a_I -= np.float32(1e-3) * np.arange(n, dtype=np.float32)
    elif case == "equal":
        Q[:], a_I[:] = Q[0], a_I[0]
    else:
        valid[:] = False
        valid[rng.permutation(n)[:K // 2]] = True
    return Q, a_I, e, PC, a_C, valid


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rising", "falling", "equal", "few"])
@pytest.mark.parametrize("K", [16, 1024, 4097, 20_000])
def test_cuda_topk_in_adversarial_orders_is_kernel_1_sorted(cuda, case, K):
    """The top-K is bitwise the stable sort of kernel 1's scores (dead slots
    included), relabeled, whatever the order of the scores: rising or
    falling with the slot, all equal (the first K slots), or fewer live
    slots than K (then the first dead slots, ascending)."""
    rng = np.random.default_rng(11)
    arrays = _adversarial(case, corpus_inputs(12, 30_000, 3, 16, 3), K, rng)
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in arrays)
    want_v, want_i = ref.topk_stable(ops.dplr_corpus_score(*args), K)
    vals, ids = ops.dplr_corpus_score(*args, topk=K, index_offset=5, index_stride=2)
    assert torch.equal(vals.view(torch.int32), want_v.contiguous().view(torch.int32))
    assert torch.equal(ids, (5 + 2 * want_i).to(torch.int32))
    if case == "equal":
        assert torch.equal(ids[0], 5 + 2 * torch.arange(K, device=cuda, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("Bq", [1, 2, 4, 8, 16, 19])
@pytest.mark.parametrize("K", [16, 1024])
def test_cuda_topk_at_every_query_group_is_kernel_1_sorted(cuda, Bq, K):
    """The kernels score 1, 2, 4, 8 or 16 query rows a block (19: a group
    of 16 and a group of 3 rows padded to 4): at each, the top-K is bitwise
    the stable sort of kernel 1's scores, relabeled."""
    arrays = corpus_inputs(13, 5000, 3, 16, Bq)
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in arrays)
    want_v, want_i = ref.topk_stable(ops.dplr_corpus_score(*args), K)
    assert_scores(want_v, ref.topk_stable(ref.dplr_corpus_score_ref(*args), K)[0])
    vals, ids = ops.dplr_corpus_score(*args, topk=K, index_offset=1, index_stride=3)
    assert torch.equal(vals.view(torch.int32), want_v.contiguous().view(torch.int32))
    assert torch.equal(ids, (1 + 3 * want_i).to(torch.int32))


def _segments(ns, Bq, rho=3, k=16, seed=20):
    """Per-segment corpus inputs (numpy), one seed each, dead slots and
    planted ties in every segment."""
    return [corpus_inputs(seed + s, n, rho, k, Bq) for s, n in enumerate(ns)]


@pytest.mark.cuda
@pytest.mark.parametrize("ns,Bq,K", [
    ((1100, 70_000, 5000), 2, 7),
    ((1100, 70_000, 5000), 2, 1024),    # K above segment 0's ~825 live slots
    ((65_536,) * 16, 4, 16),
])
def test_cuda_multi_kernel_matches_plain_and_single_segment_kernel(cuda, ns, Bq, K):
    parts = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in p)
             for p in _segments(ns, Bq)]
    Q_parts = tuple(p[0] for p in parts)
    a_parts = tuple(p[1] for p in parts)
    valid_parts = tuple(p[5] for p in parts)
    e, P_C, a_C = (torch.stack([p[j] for p in parts]) for j in (2, 3, 4))
    ops.reset_launches()
    vals, ids = ops.dplr_corpus_score_multi(Q_parts, a_parts, valid_parts, e, P_C, a_C,
                                            topk=K)
    assert vals.shape == ids.shape == (len(ns), Bq, K) and ids.dtype == torch.int32
    assert ops.LAUNCHES["corpus_multi_topk_chunks"] == 1
    assert ops.LAUNCHES["multi_topk_merge"] >= 1
    want_v, want_i = ref.dplr_corpus_multi_topk_ref(Q_parts, a_parts, valid_parts, e, P_C,
                                                    a_C, K)
    for s, p in enumerate(parts):
        full = ref.dplr_corpus_score_ref(*p)
        assert_topk(vals[s], ids[s], want_v[s], want_i[s], full)
        one_v, one_i = ops.dplr_corpus_score(*p[:5], valid=p[5], topk=K)
        assert torch.equal(vals[s], one_v) and torch.equal(ids[s], one_i), s
    # relabeling, and no valid masks at all
    vals, ids = ops.dplr_corpus_score_multi(Q_parts, a_parts, None, e, P_C, a_C, topk=K,
                                            index_offset=3, index_stride=4)
    for s, p in enumerate(parts):
        one_v, one_i = ops.dplr_corpus_score(*p[:5], topk=K, index_offset=3,
                                             index_stride=4)
        assert torch.equal(vals[s], one_v) and torch.equal(ids[s], one_i), s


def _bag(seed, B, slots, F, k, rows=5000, multi_hot=False):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((rows, k), dtype=np.float32)
    ids = rng.integers(0, rows, (B, slots)).astype(np.int32)
    w = rng.random((B, slots)).astype(np.float32)
    seg = (np.sort(rng.integers(0, F, slots)) if multi_hot
           else np.arange(slots) % F)
    return table, ids, w, seg


@pytest.mark.cuda
@pytest.mark.parametrize("B,slots,F,k,multi_hot", [
    (4097, 82, 82, 16, False),     # one slot a bag, threads end mid-block
    (16, 44, 44, 16, False),
    (33, 30, 7, 16, True),         # bags of several slots (and maybe empty ones)
    (9, 5, 3, 6, True),            # k % 4 != 0: one float a thread
])
def test_cuda_embedding_bag_matches_plain(cuda, B, slots, F, k, multi_hot):
    table, ids, w, seg = _bag(30, B, slots, F, k, multi_hot=multi_hot)
    table, ids, w = (torch.from_numpy(a).to(cuda) for a in (table, ids, w))
    bags = ops.bag_map(seg, F, cuda)
    ops.reset_launches()
    got = ops.embedding_bag(table, ids, w, bags)
    want = ref.embedding_bag_ref(table, ids, w, seg, F)
    assert ops.LAUNCHES == {"embedding_bag_kernel": 1}
    if not multi_hot:
        assert torch.equal(got, want)
    else:
        size = ref.embedding_bag_ref(table.abs(), ids, w, seg, F)
        assert ((got - want).abs() <= 1e-6 * size).all()
    assert torch.equal(ops.embedding_bag(table, ids.long(), w, bags), got)
    lead = ops.embedding_bag(table, ids[:8].reshape(2, 4, slots), w[:8].reshape(2, 4, slots),
                             bags)
    assert torch.equal(lead.reshape(8, F, k), got[:8])
    empty = ops.embedding_bag(table, ids[:0], w[:0], bags)
    assert empty.shape == (0, F, k) and ops.LAUNCHES["embedding_bag_kernel"] == 3
    bad = ids.clone()
    bad[1, 2] = -1
    out = ops.embedding_bag(table, bad, w, bags)
    assert out[1, int(seg[2])].isnan().all() and int(out.isnan().sum()) == k
    with pytest.raises(TypeError, match="dtype"):
        ops.embedding_bag(table.double(), ids, w, bags)


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,k", [(300, 14, 16), (4096, 82, 16), (1, 39, 16), (5, 128, 32),
                                   (7, 3, 4), (50, 82, 10), (3, 5, 1)])
def test_cuda_fwfm_pairwise_matches_plain(cuda, B, m, k):
    rng = np.random.default_rng(31)
    V = torch.from_numpy((rng.standard_normal((B, m, k)) / np.sqrt(k)).astype(np.float32))
    R = rng.standard_normal((m, m)).astype(np.float32) * np.float32(0.1)
    R = torch.from_numpy(0.5 * (R + R.T))
    V, R = V.to(cuda), R.to(cuda)
    ops.reset_launches()
    got = ops.fwfm_pairwise(V, R)
    assert ops.LAUNCHES == {"fwfm_pairwise_kernel": 1}
    want = ref.fwfm_pairwise_ref(V, R)
    size = 0.5 * torch.einsum("bij,ij->b", torch.einsum("bik,bjk->bij", V, V).abs(), R.abs())
    assert ((got - want).abs() <= 1e-5 * torch.clamp(size, min=1.0)).all()
    # a row's value does not depend on the batch it is in
    assert torch.equal(ops.fwfm_pairwise(V[-1:].contiguous(), R), got[-1:])


@pytest.mark.cuda
def test_cuda_fwfm_pairwise_takes_a_misaligned_tensor_and_raises_past_its_limits(cuda):
    rng = np.random.default_rng(32)
    flat = torch.from_numpy(rng.standard_normal(3 * 8 * 16 + 1).astype(np.float32)).to(cuda)
    V = flat[1:].view(3, 8, 16)                        # 4 bytes past a 16-byte boundary
    R = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32)).to(cuda)
    assert_scores(ops.fwfm_pairwise(V, R), ref.fwfm_pairwise_ref(V, R))
    for m, k in ((129, 16), (8, 36)):
        with pytest.raises(ValueError, match="the kernel takes m"):
            ops.fwfm_pairwise(torch.zeros((2, m, k), device=cuda),
                              torch.zeros((m, m), device=cuda))


@pytest.mark.cuda
def test_cuda_baseline_apply_matches_the_cpu(cuda):
    import dataclasses

    from repro_torch.configs import dplr_fwfm
    from repro_torch.core.pruning import prune_matched
    from repro_torch.data.synthetic_ctr import SyntheticCTR
    from repro_torch.models.recsys import fwfm

    cfg = dataclasses.replace(dplr_fwfm.make_smoke(), interaction="fwfm")
    params = fwfm.init(torch.Generator().manual_seed(0), cfg)
    pr = prune_matched(fwfm.field_matrix(params, cfg), cfg.n_fields, 2)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticCTR(cfg.layout, seed=0).batch(300, seed=1).items()}
    on_card = {k: v.to(cuda) for k, v in params.items()}
    for mask in (None, pr.mask):
        ops.reset_launches()
        got = fwfm.apply(on_card, cfg, {k: v.to(cuda) for k, v in batch.items()},
                         pruned_mask=None if mask is None else mask.to(cuda))
        assert ops.LAUNCHES == {"embedding_bag_kernel": 1, "fwfm_pairwise_kernel": 1}
        want = fwfm.apply(params, cfg, batch, pruned_mask=mask)
        assert_scores(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("interaction", ["dplr", "fwfm"])
def test_cuda_loss_gradients_match_the_cpu(cuda, interaction):
    """The kernels run forward on the card and the plain vjp backward:
    ``loss.backward()`` gives every parameter the CPU's gradient."""
    import dataclasses

    from repro_torch.configs import dplr_fwfm
    from repro_torch.data.synthetic_ctr import SyntheticCTR
    from repro_torch.models.recsys import fwfm

    cfg = dataclasses.replace(dplr_fwfm.make_smoke(), interaction=interaction)
    params = fwfm.init(torch.Generator().manual_seed(0), cfg)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticCTR(cfg.layout, seed=0).batch(300, seed=1).items()}
    grads = []
    for dev in ("cpu", cuda):
        p = {k: v.detach().to(dev).requires_grad_() for k, v in params.items()}
        ops.reset_launches()
        fwfm.loss(p, cfg, {k: v.to(dev) for k, v in batch.items()}).backward()
        grads.append({k: v.grad for k, v in p.items()})
    want = {"embedding_bag_kernel": 1}
    if interaction == "fwfm":
        want["fwfm_pairwise_kernel"] = 1
    assert ops.LAUNCHES == want
    for name, g in grads[0].items():
        assert grads[1][name] is not None, name
        assert_scores(grads[1][name], g)


# -- kernel 7: flash_attention ------------------------------------------------
#
# Against its plain version: f32 within 1e-5 max|v|; bf16 within 2^-7 max|v|
# and, per element, within 2^-7 (|o| + sum_j p_j |v_j| / l) + 1e-5 max|v|
# (chip_smoke.flash_ratio, with its reasons).

FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}


def _flash_check(cuda, dtype, B, S, H, KV, hd, window, k_scale=None):
    gen = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn((B, S, n, hd), generator=gen, device=cuda).to(dtype)
               for n in (H, KV, KV))
    if k_scale is not None:
        k[1:] *= k_scale
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    # bf16 at hd 64, 128 and 256 runs the Hopper kernel; the rest PR 15's
    wgmma = dtype == torch.bfloat16 and hd in (64, 128, 256)
    assert ops.LAUNCHES == {"flash_attention_wgmma" if wgmma else "flash_attention_kernel": 1}
    assert got.dtype == dtype and got.shape == q.shape and torch.isfinite(got).all()
    want, size = ref.flash_attention_plain(q, k, v, window=window, with_size=True)
    diff = (got.float() - want.float()).abs()
    vmax = float(v.abs().max())
    assert float(diff.max()) <= FLASH_TOL[dtype] * vmax, float(diff.max())
    if dtype == torch.bfloat16:
        ratio = float((diff / (2.0**-7 * (want.float().abs() + size) + 1e-5 * vmax)).max())
        assert ratio <= 1.0, ratio


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (2, 300, 4, 1, 256, None),     # gemma3-1b's heads, ragged S
    (2, 300, 4, 1, 256, 64),       # a window
    (1, 1000, 8, 8, 64, None),     # MHA
    (1, 130, 8, 2, 128, 33),
    (3, 65, 4, 4, 16, 7),
    (1, 1, 4, 1, 32, None),
    # the Hopper kernel's edges: S ragged against its 64- and 128-key tiles
    # at B >= 2 (a read past S would take the next sequence's keys), 9
    # query heads a kv head (126 of a block's 128 rows), a window longer
    # than S and one shorter than a tile, and S = 1
    (2, 4_000, 4, 1, 256, None),
    (3, 1_001, 8, 2, 128, None),
    (1, 300, 36, 4, 128, 100),
    (2, 300, 4, 1, 256, 5_000),
    (2, 300, 4, 1, 256, 7),
    (2, 1, 4, 1, 256, None),
    (2, 1, 8, 8, 64, None),
])
def test_cuda_flash_attention_matches_plain(cuda, dtype, B, S, H, KV, hd, window):
    _flash_check(cuda, dtype, B, S, H, KV, hd, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (2, 4_000, 4, 1, 256, None),
    (3, 1_001, 8, 2, 128, 300),
    (2, 777, 8, 8, 64, None),
])
def test_cuda_flash_attention_keeps_sequences_apart(cuda, dtype, B, S, H, KV, hd, window):
    """Keys of sequences 1.. are 50x larger: one of them leaking into
    sequence 0's attention (a load past S) would dominate its softmax."""
    _flash_check(cuda, dtype, B, S, H, KV, hd, window, k_scale=50.0)


@pytest.mark.cuda
def test_cuda_flash_attention_raises_on_what_it_does_not_take(cuda):
    q, k = torch.zeros((1, 8, 4, 64), device=cuda), torch.zeros((1, 8, 1, 64), device=cuda)
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            ops.flash_attention(q.to(dt), k.to(dt), k.to(dt))
    with pytest.raises(TypeError, match="one type"):
        ops.flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="head_dim 48"):
        b = torch.zeros((1, 8, 4, 48), device=cuda, dtype=torch.bfloat16)
        ops.flash_attention(b, b[:, :, :1].contiguous(), b[:, :, :1].contiguous())
    wide = torch.zeros((1, 8, 65, 64), device=cuda)
    with pytest.raises(ValueError, match="<= 64"):
        ops.flash_attention(wide, k, k)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(NotImplementedError, match="backward"):
        ops.flash_attention(q.requires_grad_(), k, k)


@pytest.mark.cuda
def test_cuda_prefill_and_decode_match_the_cpu(cuda):
    """gemma3-1b's smoke config in f32 compute: prefill (one kernel launch a
    layer) and decode on the card against the CPU's plain path, logits
    within 2e-4, and the bf16 cache within 2e-4 plus one bf16 ulp (at most
    2^-7 |x|).  Each decode step on the card starts from the CPU's cache
    before that step, so both devices decode the same inputs: a cache
    entry one ulp apart after the prefill would move what decode then
    writes by more than f32 rounding."""
    import dataclasses

    from repro_torch.configs import gemma3_1b
    from repro_torch.models.transformer import model as tm

    def cache_ratio(got, want):
        got, want = got.float().cpu(), want.float()
        return float(((got - want).abs() / (2e-4 + 2.0**-7 * want.abs())).max())

    cfg = dataclasses.replace(gemma3_1b.make_smoke(), compute_dtype=torch.float32)
    params = tm.init(torch.Generator().manual_seed(0), cfg)
    gpu = {k: ({n: t.to(cuda) for n, t in v.items()} if isinstance(v, dict) else v.to(cuda))
           for k, v in params.items()}
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(1))
    V = cfg.vocab

    lg_c, cache_c = tm.prefill(params, cfg, toks[:, :13], 16, device="cpu")
    ops.reset_launches()
    lg_g, cache_g = tm.prefill(gpu, cfg, toks[:, :13].to(cuda), 16, device=cuda)
    assert ops.LAUNCHES == {"flash_attention_kernel": cfg.n_layers}
    np.testing.assert_allclose(lg_g[..., :V].cpu().numpy(), lg_c[..., :V].numpy(),
                               rtol=2e-4, atol=2e-4)
    assert cache_ratio(cache_g, cache_c) <= 1.0
    for t in range(13, 16):
        cache_g = cache_c.to(cuda)
        lg_c, cache_c = tm.decode_step(params, cfg, toks[:, t:t + 1], cache_c, t, device="cpu")
        lg_g, cache_g = tm.decode_step(gpu, cfg, toks[:, t:t + 1].to(cuda), cache_g, t,
                                       device=cuda)
        np.testing.assert_allclose(lg_g[..., :V].cpu().numpy(), lg_c[..., :V].numpy(),
                                   rtol=2e-4, atol=2e-4)
        assert cache_ratio(cache_g, cache_c) <= 1.0, t
    assert ops.LAUNCHES == {"flash_attention_kernel": cfg.n_layers}   # decode launches none

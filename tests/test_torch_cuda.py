"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports no JAX, so that it runs where the card is:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Skips where ``torch.cuda.is_available()`` is False (the kernels are CUDA
C++ and have no CPU mode).  Tolerance: atol = rtol = 1e-5; top-K ids equal
except between scores tied within that."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (  # noqa: E402
    autotune, blocks, dplr_score, fwfm_interaction, ops, ref)
from repro_torch.kernels import dplr_corpus_score as corpus_lib  # noqa: E402
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


def _items_inputs(rng, Bq, n, mI, k, rho, cuda, misaligned=False):
    arrays = (rng.standard_normal((Bq, n, mI, k), dtype=np.float32) * 0.25,
              rng.standard_normal((rho, mI), dtype=np.float32) * 0.2,
              rng.random(rho).astype(np.float32) + 0.5,
              -rng.random(mI).astype(np.float32),
              rng.standard_normal((Bq, rho, k), dtype=np.float32),
              rng.standard_normal(Bq).astype(np.float32))
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    if misaligned:                                 # 4 bytes past a 16-byte boundary
        flat = torch.empty(args[0].numel() + 1, device=cuda)
        args[0] = flat[1:].view(args[0].shape).copy_(args[0])
    return tuple(args)


def _assert_items_close(got, args):
    """Within 1e-5 * max(1, size), ``size`` the summed magnitude of the
    score's terms: the rule of ROADMAP section 3 for scores that are
    differences of larger terms (at rho k = 128 the terms reach ~100)."""
    V, U, e, d, PC, sC = args
    size = ref.dplr_score_items_ref(V, U, e.abs(), d.abs(), PC, sC.abs())
    diff = (got - ref.dplr_score_items_ref(*args)).abs()
    assert (diff <= 1e-5 * torch.clamp(size, min=1.0)).all(), float(diff.max())


def _items_exact(got, args) -> str:
    """How far ``got`` and the f32 plain version each sit from the f64 plain
    version, as shares of atol + rtol |s| at 1e-5; asserts that ``got`` is
    within the size-scaled bound of it (``_assert_items_close``)."""
    V, U, e, d, PC, sC = args
    exact = ref.dplr_score_items_ref(*(a.double() for a in args))
    bound = 1e-5 * (1 + exact.abs())
    plain = ref.dplr_score_items_ref(*args).double()
    size = ref.dplr_score_items_ref(V, U, e.abs(), d.abs(), PC, sC.abs()).double()
    assert ((got.double() - exact).abs() <= 1e-5 * torch.clamp(size, min=1.0)).all()
    return (f"kernel {float(((got.double() - exact).abs() / bound).max()):.3f}, "
            f"plain f32 {float(((plain - exact).abs() / bound).max()):.3f} of the bound")


@pytest.mark.cuda
def test_cuda_score_items_matches_plain(cuda):
    """At the serving shape within atol = rtol = 1e-5; then, within the
    size-scaled bound, n one below and one above a multiple of the kernel's
    tile (8 items here) and n = 1, rho k = 128 as (8, 16) and (2, 64), rho
    k = 3, m_I k odd, a misaligned V_I and m_I = 200 (two chunks of fields);
    every row of a batched call bitwise equal to the per-query call.  Each
    case is also held to an f64 plain version; the distances from it, of
    the kernel and of the f32 plain version, print with ``-s``."""
    rng = np.random.default_rng(8)
    t = dplr_score.tile(38, 3, 16)
    for i, (Bq, n, mI, k, rho, mis) in enumerate([
            (3, 1000, 38, 16, 3, False), (2, 4 * t - 1, 38, 16, 3, False),
            (2, 4 * t + 1, 38, 16, 3, False),
            (3, 1, 38, 16, 3, False), (2, 300, 38, 16, 8, False), (2, 300, 38, 64, 2, False),
            (2, 299, 38, 3, 1, False), (2, 299, 13, 3, 3, False), (3, 1000, 38, 16, 3, True),
            (2, 100, 200, 16, 3, False)]):
        args = _items_inputs(rng, Bq, n, mI, k, rho, cuda, mis)
        ops.reset_launches()
        got = ops.dplr_score_items(*args)
        assert ops.LAUNCHES == {"dplr_score_items_kernel": 1}
        if i == 0:
            assert_scores(got, ref.dplr_score_items_ref(*args))
        else:
            _assert_items_close(got, args)
        print(f"Bq={Bq} n={n} m_I={mI} k={k} rho={rho}{' misaligned' if mis else ''}, "
              f"against f64: {_items_exact(got, args)}")
        V, U, e, d, PC, sC = args
        for q in range(Bq):
            assert torch.equal(ops.dplr_score_items(V[q], U, e, d, PC[q], sC[q]), got[q]), i
    with pytest.raises(TypeError, match="dtype"):
        ops.dplr_score_items(args[0].double(), *args[1:])


@pytest.mark.cuda
def test_cuda_tiles_at_the_served_shapes(cuda):
    """The tiles the launches cut, as the libraries report them (chip_smoke
    checks their edges): 8 items at m_I = 38, rho = 3, k = 16 (4 lanes an
    item), fewer as rho k grows; 16 examples at m = 82, k = 16, 4 at
    m = 128, k = 32 (shared memory runs out first), 64 at k = 1; 0 past
    the limits."""
    assert dplr_score.tile(38, 3, 16) == 8
    assert dplr_score.tile(38, 8, 16) == 4 and dplr_score.tile(38, 2, 64) == 2
    assert dplr_score.tile(38, 1, 128) == 1 and dplr_score.tile(38, 9, 16) == 0
    assert fwfm_interaction.tile(82, 16) == 16 and fwfm_interaction.tile(128, 32) == 4
    assert fwfm_interaction.tile(12, 1) == 64 and fwfm_interaction.tile(129, 16) == 0
    # a bf16 V stages in half the bytes: the same tile until shared memory binds
    bf16 = torch.bfloat16
    assert fwfm_interaction.tile(82, 16, bf16) == 16 and fwfm_interaction.tile(128, 32, bf16) == 8


@pytest.mark.cuda
def test_cuda_score_items_takes_65536_queries(cuda):
    """Past the 65,535 a grid axis holds: the kernel walks (query, tile)
    pairs, so any Bq >= 1 is one launch."""
    rng = np.random.default_rng(9)
    args = _items_inputs(rng, 65_536, 2, 38, 16, 3, cuda)
    ops.reset_launches()
    got = ops.dplr_score_items(*args)
    assert ops.LAUNCHES == {"dplr_score_items_kernel": 1}
    _assert_items_close(got, args)
    V, U, e, d, PC, sC = args
    for q in (0, 40_000, 65_535):
        assert torch.equal(ops.dplr_score_items(V[q], U, e, d, PC[q], sC[q]), got[q])


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


# the launches of one call of the embedding bag's backward: the slots'
# radix sort (two kernels), then the writer
BACKWARD_LAUNCHES = {"bag_rows_radix_histogram": 1, "bag_rows_radix_sort": 1,
                     "embedding_bag_backward_kernel": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("B,slots,F,k,multi_hot,dups", [
    (4096, 82, 82, 16, False, False),   # the train batch, one slot a bag
    (33, 30, 7, 16, True, False),       # bags of several slots
    (512, 82, 82, 16, False, True),     # duplicate-heavy: 7 rows for 41,984 slots
    (9, 5, 3, 6, True, True),           # k % 4 != 0
    (64, 40, 40, 40, False, True),      # k > 32: two passes of columns
])
def test_cuda_embedding_bag_backward_matches_plain_and_repeats(cuda, B, slots, F, k,
                                                               multi_hot, dups):
    """The table's gradient: one launch of each of the sort's two kernels
    and the writer, within 1e-6 * sum |w g| of ``ref.embedding_bag_vjp``
    on the card (rows no slot names exactly 0), bitwise equal to itself on
    a second call and to the plain version on the CPU, which sums each row
    in the same order."""
    table, ids, w, seg = _bag(33, B, slots, F, k, multi_hot=multi_hot)
    if dups:
        ids = ids % 7
    rng = np.random.default_rng(34)
    grad = rng.standard_normal((B, F, k), dtype=np.float32)
    host = [torch.from_numpy(a) for a in (table, ids, w, grad)]
    table, ids, w, grad = (a.to(cuda) for a in host)
    bags = ops.bag_map(seg, F, cuda)
    ops.reset_launches()
    got = ops.embedding_bag_backward(grad, table, ids, w, bags)
    assert ops.LAUNCHES == BACKWARD_LAUNCHES
    want = ref.embedding_bag_vjp(table, ids, w, seg, grad)[0]
    size = ref.embedding_bag_vjp(table, ids, w, seg, grad.abs())[0]
    assert ((got - want).abs() <= 1e-6 * size).all()
    assert torch.equal(ops.embedding_bag_backward(grad, table, ids, w, bags), got)
    assert torch.equal(ops.embedding_bag_backward(grad, table, ids.long(), w, bags), got)
    assert torch.equal(got.cpu(), ref.embedding_bag_vjp(host[0], host[1], host[2], seg,
                                                        host[3])[0])
    assert torch.equal(ops.embedding_bag_backward(grad[:0], table, ids[:0], w[:0], bags),
                       torch.zeros_like(table))


def _poisoned(dev, shape) -> tuple[int, int]:
    """Free a NaN-filled f32 tensor of ``shape``: the caching allocator
    hands its block to the next ``torch.empty`` of that size, which the
    backward makes first.  Its address range, to check that it did."""
    block = torch.full(shape, float("nan"), device=dev)
    span = (block.data_ptr(), block.data_ptr() + block.numel() * 4)
    del block
    return span


def _inside(t, span) -> bool:
    return span[0] <= t.data_ptr() and t.data_ptr() + t.numel() * t.element_size() <= span[1]


@pytest.mark.cuda
@pytest.mark.parametrize("case,B,slots,rows,k", [
    ("rows not a multiple of the tile", 512, 82, 70_001, 16),
    ("first and last row", 300, 40, 70_001, 16),
    ("one run past the staging ring", 2048, 82, 70_001, 16),
    ("ids out of range", 400, 30, 70_001, 16),
    ("k > 32, ragged rows", 64, 40, 9_001, 40),
])
def test_cuda_embedding_bag_backward_writes_every_row_once(cuda, case, B, slots, rows, k):
    """The writer on an allocation that held NaN (checked by address): every
    row no slot names exactly 0, the rest bitwise the CPU plain version,
    and bitwise on a second call.  An id outside ``[0, rows)`` adds to no
    row.  One run of 167,936 entries outlasts any stage of the writer."""
    rng = np.random.default_rng(35)
    ids = rng.integers(0, rows, (B, slots)).astype(np.int32)
    if case == "first and last row":
        ids[::3, ::2] = 0
        ids[1::3, 1::2] = rows - 1
    elif case == "one run past the staging ring":
        ids[:] = rows // 2
    elif case == "ids out of range":
        ids[::2, ::3] = rng.integers(rows, 2 * rows, ids[::2, ::3].shape)
        ids[1::2, 1::3] = -rng.integers(1, rows, ids[1::2, 1::3].shape)
    table = rng.standard_normal((rows, k), dtype=np.float32)
    w = rng.random((B, slots)).astype(np.float32) + 0.5
    grad = rng.standard_normal((B, slots, k), dtype=np.float32)
    seg = np.arange(slots)
    host = [torch.from_numpy(a) for a in (table, ids, w, grad)]
    table, ids_c, w, grad = (a.to(cuda) for a in host)
    bags = ops.bag_map(seg, slots, cuda)
    want = ref.embedding_bag_vjp(host[0], host[1], host[2], seg, host[3])[0]
    named = np.zeros(rows, bool)
    flat = host[1].numpy().reshape(-1)
    named[flat[(flat >= 0) & (flat < rows)]] = True
    outs = []
    for _ in range(2):
        span = _poisoned(cuda, (rows, k))
        ops.reset_launches()
        outs.append(ops.embedding_bag_backward(grad, table, ids_c, w, bags))
        assert _inside(outs[-1], span), "the table's gradient did not land in the NaN block"
        assert ops.LAUNCHES == BACKWARD_LAUNCHES
    got = outs[0].cpu()
    assert (got[torch.from_numpy(~named)] == 0).all()
    assert torch.equal(got, want)
    assert torch.equal(outs[1], outs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("pattern,n,rows", [
    ("equal", 100_003, 33_040_384),
    ("ascending", 100_003, 2**25 - 1),
    ("descending", 335_872, 2**25 + 1),
    ("skewed", 335_872, 33_040_384),
    ("skewed", 4_097, 2**25 - 1),
    ("skewed", 700_000, 33_040_384),      # more tiles than resident blocks: items of 2
    ("uniform", 70_000, 1000),            # two passes
    ("uniform", 1, 7),                    # one pass
    ("out of range", 50_000, 5000),
])
def test_cuda_bag_rows_sort_is_torch_sort(cuda, dtype, pattern, n, rows):
    """The radix sort, keys and indices, bitwise ``torch.sort(stable=True)``
    of the ids with those outside ``[0, rows)`` set to ``rows``: one launch
    of each of its kernels; N on and off its 4,096-key tile, and past a
    tile a resident block (an item then ranks several); rows of 25 and 26
    bits (9, 8, 8 and 9, 9, 8 bits a pass)."""
    rng = np.random.default_rng(36)
    if pattern == "equal":
        ids = np.full(n, rows - 1)
    elif pattern == "ascending":
        ids = np.arange(n) * (rows // n)
    elif pattern == "descending":
        ids = (np.arange(n) * (rows // n))[::-1]
    elif pattern == "skewed":
        ids = (rows * rng.random(n) ** 6).astype(np.int64)
    elif pattern == "uniform":
        ids = rng.integers(0, rows, n)
    else:
        ids = rng.integers(-rows, 2 * rows, n)
    ids = torch.from_numpy(np.ascontiguousarray(ids)).to(dtype)
    keys = ids.masked_fill((ids < 0) | (ids >= rows), rows)
    want_keys, want_perm = torch.sort(keys, stable=True)
    ops.reset_launches()
    got_keys, got_perm = ops.bag_rows_sort(ids.to(cuda).view(-1, 1), rows)
    assert ops.LAUNCHES == {"bag_rows_radix_histogram": 1, "bag_rows_radix_sort": 1}
    assert got_keys.dtype == dtype and got_perm.dtype == torch.int64
    assert torch.equal(got_keys.cpu(), want_keys) and torch.equal(got_perm.cpu(), want_perm)
    again = ops.bag_rows_sort(ids.to(cuda), rows)
    assert torch.equal(again[0], got_keys) and torch.equal(again[1], got_perm)


@pytest.mark.cuda
def test_cuda_train_steps_repeat_bitwise_and_match_the_cpu(cuda):
    """Ten adagrad steps of ``launch.train.train_step`` at the smoke config:
    two runs on the card from one init end bitwise equal, and their losses
    agree with the CPU's within 1e-5 * max(1, |loss|)."""
    from repro_torch import optim
    from repro_torch.configs import dplr_fwfm
    from repro_torch.launch import train
    from repro_torch.models.recsys import fwfm

    cfg = dplr_fwfm.make_smoke()
    mod, make_batch = train.build_recsys_trainer("dplr-fwfm", cfg, 256, seed=0)
    init = fwfm.init(torch.Generator().manual_seed(0), cfg)
    runs = []
    for dev in (cuda, cuda, "cpu"):
        opt = optim.adagrad()
        params = {k: v.clone().to(dev) for k, v in init.items()}
        state = opt.init(params)
        losses = [float(train.train_step(mod, cfg, opt, params, state,
                                         train.to_device(make_batch(s), dev), 0.1)[0])
                  for s in range(10)]
        runs.append((losses, params, state))
    (la, pa, sa), (lb, pb, sb), (lc, _, _) = runs
    assert la == lb
    assert all(torch.equal(pa[k], pb[k]) and torch.equal(sa["acc"][k], sb["acc"][k])
               for k in pa)
    np.testing.assert_allclose(la, lc, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,k", [(300, 14, 16), (4096, 82, 16), (1, 39, 16), (5, 128, 32),
                                   (7, 3, 4), (50, 82, 10), (3, 5, 1)])
def test_cuda_fwfm_pairwise_matches_plain(cuda, B, m, k):
    """With a symmetric R, a general one (not symmetric, non-zero diagonal)
    and a pruned one (a third of a symmetric R's entries kept)."""
    rng = np.random.default_rng(31)
    V = torch.from_numpy((rng.standard_normal((B, m, k)) / np.sqrt(k)).astype(np.float32))
    R = rng.standard_normal((m, m)).astype(np.float32) * np.float32(0.1)
    keep = np.triu(rng.random((m, m)) < 0.3, 1)
    sym = 0.5 * (R + R.T)
    for R in (sym, R, sym * (keep | keep.T)):
        V, R = V.to(cuda), torch.from_numpy(np.ascontiguousarray(R, np.float32)).to(cuda)
        ops.reset_launches()
        got = ops.fwfm_pairwise(V, R)
        assert ops.LAUNCHES == {"fwfm_pairwise_kernel": 1}
        want = ref.fwfm_pairwise_ref(V, R)
        size = 0.5 * torch.einsum("bij,ij->b", torch.einsum("bik,bjk->bij", V, V).abs(),
                                  R.abs())
        assert ((got - want).abs() <= 1e-5 * torch.clamp(size, min=1.0)).all()
        # a row's value does not depend on the batch it is in
        assert torch.equal(ops.fwfm_pairwise(V[-1:].contiguous(), R), got[-1:])


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,k,offset", [(4096, 82, 16, 0), (4097, 82, 16, 0), (33, 82, 16, 1),
                                          (5, 128, 32, 0), (300, 14, 12, 0), (7, 3, 4, 0),
                                          (3, 5, 1, 0), (50, 82, 8, 3)])
def test_cuda_fwfm_pairwise_bf16_v_is_bitwise_its_f32_launch(cuda, B, m, k, offset):
    """A bf16 ``V`` launches ``fwfm_pairwise_kernel_bf16``, whose result is
    bitwise the f32 kernel's on the upcast ``V`` (the upcast is exact and
    the arithmetic after it the same), for bulk copies (k % 8 == 0,
    16-byte aligned) and the element-by-element fill (k % 8 != 0, or
    ``offset`` bf16 values past an aligned base); ``R`` in bf16 is upcast
    first.  Rows do not depend on their batch."""
    rng = np.random.default_rng(33)
    flat = torch.from_numpy(rng.standard_normal(B * m * k + offset).astype(np.float32))
    V = flat.to(cuda, torch.bfloat16)[offset:].view(B, m, k)
    R = torch.from_numpy((rng.standard_normal((m, m)) * 0.1).astype(np.float32)).to(cuda)
    ops.reset_launches()
    got = ops.fwfm_pairwise(V, R)
    assert ops.LAUNCHES == {"fwfm_pairwise_kernel_bf16": 1} and got.dtype == torch.float32
    assert _bits_equal(got, ops.fwfm_pairwise(V.float(), R))
    assert _bits_equal(ops.fwfm_pairwise(V, R.bfloat16()), ops.fwfm_pairwise(V.float(),
                                                                             R.bfloat16().float()))
    assert _bits_equal(ops.fwfm_pairwise(V[-1:].contiguous(), R), got[-1:])
    want = ref.fwfm_pairwise_ref(V, R)
    size = 0.5 * torch.einsum("bij,ij->b", torch.einsum("bik,bjk->bij", V.float(), V.float())
                              .abs(), R.abs())
    assert ((got - want).abs() <= 1e-5 * torch.clamp(size, min=1.0)).all()


@pytest.mark.cuda
def test_cuda_fwfm_pairwise_bf16_v_gradient_is_the_f32_one_cast(cuda):
    rng = np.random.default_rng(34)
    V = torch.from_numpy(rng.standard_normal((64, 82, 16)).astype(np.float32)).to(cuda)
    R = torch.from_numpy(rng.standard_normal((82, 82)).astype(np.float32)).to(cuda)
    V16 = V.bfloat16().requires_grad_()
    ops.fwfm_pairwise(V16, R).sum().backward()
    V32 = V.bfloat16().float().requires_grad_()
    ops.fwfm_pairwise(V32, R).sum().backward()
    assert V16.grad.dtype == torch.bfloat16
    assert _bits_equal(V16.grad.float(), V32.grad.to(torch.bfloat16).float())


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
    """The kernels run forward on the card, and the embedding bag's backward
    kernel and the plain vjp of the rest backward: ``loss.backward()``
    gives every parameter the CPU's gradient."""
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
    want = {"embedding_bag_kernel": 1, **BACKWARD_LAUNCHES}
    if interaction == "fwfm":
        want["fwfm_pairwise_kernel"] = 1
    assert ops.LAUNCHES == want
    for name, g in grads[0].items():
        assert grads[1][name] is not None, name
        assert_scores(grads[1][name], g)


# -- the rest of the recsys family: Wide&Deep, AutoInt, BST, MIND ------------

@pytest.mark.cuda
def test_cuda_gather_rows_is_bitwise_the_rows(cuda):
    from repro_torch.embedding.bag import gather_rows

    gen = torch.Generator(device=cuda).manual_seed(0)
    table = torch.randn((5000, 64), generator=gen, device=cuda)
    ids = torch.randint(0, 5000, (300, 50), generator=gen, device=cuda, dtype=torch.int32)
    ops.reset_launches()
    assert torch.equal(gather_rows(table, ids), table[ids.long()])
    assert ops.LAUNCHES == {"embedding_bag_kernel": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["wide-deep", "autoint", "bst", "mind"])
def test_cuda_models_train_and_rank_like_the_cpu(cuda, arch):
    """At ``make_smoke()``: the loss's gradients on the card (kernel 5
    forward, 5' backward) against the CPU's (plain bags) within 1e-5; three
    adagrad steps twice on the card from one init, bitwise equal, their
    losses within 1e-5 of the CPU's; ``rank_items`` against the CPU's."""
    from repro_torch import optim
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.launch import train

    cfg = REGISTRY[arch].make_smoke()
    mod, make_batch = train.build_recsys_trainer(arch, cfg, 256, seed=0)
    init = mod.init(torch.Generator().manual_seed(0), cfg)

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.clone().to(dev)
                for k, v in tree.items()}

    def flat(tree, prefix=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from flat(tree[k], f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", tree[k]

    grads = []
    for dev in ("cpu", cuda):
        ops.reset_launches()
        loss, g = optim.value_and_grad(mod.loss)(to(init, dev), cfg,
                                                 train.to_device(make_batch(0), dev))
        grads.append((loss, dict(flat(g))))
    assert ops.LAUNCHES["embedding_bag_kernel"] >= 1
    assert ops.LAUNCHES["embedding_bag_backward_kernel"] >= 1
    assert_scores(grads[1][0], grads[0][0])
    for name, g in grads[0][1].items():
        assert_scores(grads[1][1][name], g)

    runs = []
    for dev in (cuda, cuda, "cpu"):
        opt = optim.adagrad()
        params = to(init, dev)
        state = opt.init(params)
        losses = [float(train.train_step(mod, cfg, opt, params, state,
                                         train.to_device(make_batch(s), dev), 0.05)[0])
                  for s in range(3)]
        runs.append((losses, dict(flat({"params": params, "opt": state}))))
    (la, ta), (lb, tb), (lc, _) = runs
    assert la == lb and all(torch.equal(ta[k], tb[k]) for k in ta)
    np.testing.assert_allclose(la, lc, rtol=1e-5, atol=1e-5)

    rng = np.random.default_rng(1)
    item_vocab = cfg.layout.fields[-1].vocab_size
    q = {"item_ids": rng.integers(0, item_vocab if arch in ("bst", "mind") else 16,
                                  (2, 30, cfg.layout.subset("item").n_slots)).astype(np.int32)}
    if arch != "mind":
        q["context_ids"] = rng.integers(0, 16, (2, cfg.layout.subset("context").n_slots)
                                        ).astype(np.int32)
        q["context_weights"] = np.ones(q["context_ids"].shape, np.float32)
    if arch in ("wide-deep", "autoint"):
        q["item_weights"] = np.ones(q["item_ids"].shape, np.float32)
    if arch in ("bst", "mind"):
        q["hist_ids"] = rng.integers(0, item_vocab, (2, cfg.seq_len)).astype(np.int32)
        q["hist_mask"] = (rng.random((2, cfg.seq_len)) > 0.3).astype(np.float32)
    want = mod.rank_items(to(init, "cpu"), cfg, train.to_device(q, "cpu"))
    assert_scores(mod.rank_items(to(init, cuda), cfg, train.to_device(q, cuda)), want)


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
    # starcoder2-7b's and yi-9b's heads (9 and 8 query heads a kv head)
    (1, 4_096, 36, 4, 128, None),
    (1, 4_096, 32, 4, 128, None),
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,window,lo,hi", [
    (2, 300, 4, 1, 256, None, 37, 300),      # gemma3-1b's heads, rows off a block's edge
    (2, 300, 4, 1, 256, 64, 100, 163),
    (2, 1_024, 4, 1, 256, None, 512, 640),   # position 4 of 8 on a model axis
    (3, 1_001, 8, 2, 128, None, 1, 1_000),
    (1, 300, 36, 4, 128, 100, 150, 151),     # one row
    (1, 130, 8, 2, 128, 33, 64, 130),
    (2, 777, 8, 8, 64, None, 333, 700),
    (3, 65, 4, 4, 16, 7, 20, 64),
    (2, 100, 4, 1, 32, None, 50, 100),
])
def test_cuda_flash_attention_query_rows_match_the_whole_sequence(cuda, dtype, B, S, H, KV, hd,
                                                                  window, lo, hi):
    """Query rows lo..hi against all S keys (``q_offset=lo``, the LM plan's
    rows on a model axis whose heads do not split): within the plain
    version's bounds at that offset, and bitwise those rows of the whole
    sequence's launch (a row's tiles differ only by whole tiles that mask
    it, which leave its max, sum and accumulator as they were)."""
    gen = torch.Generator(device=cuda).manual_seed(S + lo)
    q, k, v = (torch.randn((B, S, n, hd), generator=gen, device=cuda).to(dtype)
               for n in (H, KV, KV))
    rows = q[:, lo:hi].contiguous()
    ops.reset_launches()
    got = ops.flash_attention(rows, k, v, window=window, q_offset=lo)
    whole = ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert sum(ops.LAUNCHES.values()) == 2 and got.shape == rows.shape
    want, size = ref.flash_attention_plain(rows, k, v, window=window, with_size=True,
                                           q_offset=lo)
    diff = (got.float() - want.float()).abs()
    vmax = float(v.abs().max())
    assert float(diff.max()) <= FLASH_TOL[dtype] * vmax, float(diff.max())
    if dtype == torch.bfloat16:
        ratio = float((diff / (2.0**-7 * (want.float().abs() + size) + 1e-5 * vmax)).max())
        assert ratio <= 1.0, ratio
    assert torch.equal(got, whole[:, lo:hi])


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


@pytest.mark.cuda
def test_cuda_scoring_guard_raises_on_a_sync_and_restores_the_mode(cuda, monkeypatch):
    from repro_torch.serving import scoring_guard

    monkeypatch.setenv("REPRO_SANITIZE", "1")
    mode = torch.cuda.get_sync_debug_mode()
    x = torch.ones(3, device=cuda)
    with pytest.raises(RuntimeError):
        with scoring_guard(cuda):
            x.sum().item()                     # waits for the card: refused
    assert torch.cuda.get_sync_debug_mode() == mode
    with scoring_guard(cuda):
        y = x * 2                              # stays on the card: fine
    assert y.sum().item() == 6.0


@pytest.mark.cuda
def test_cuda_topk_and_fused_topk_run_clean_inside_the_guard(cuda, monkeypatch):
    """The Bq = 1 and batched ``topk`` and a packed ``fused_topk`` on fresh
    states, under ``REPRO_SANITIZE=1``: no synchronising call in the
    dispatch (the context lookup's static maps went to the card at
    ``refresh``), and the replies equal the unguarded ones bitwise."""
    from repro_torch.configs import dplr_fwfm
    from repro_torch.data.synthetic_ctr import SyntheticCTR
    from repro_torch.embedding import bag
    from repro_torch.models.recsys import fwfm
    from repro_torch.serving import CorpusState, ScorerRuntime
    from repro_torch.serving.engine import fused_topk

    cfg = dplr_fwfm.make_smoke()
    data = SyntheticCTR(cfg.layout, embed_dim=4, seed=0)
    params = fwfm.init(torch.Generator(device=cuda).manual_seed(0), cfg)
    bag._statics.cache_clear()                 # nothing primed before the states
    rt = ScorerRuntime(cfg, device=cuda)
    states = []
    for i in range(3):
        q = data.ranking_query(300, i)
        states.append(CorpusState(None, q["item_ids"][0], q["item_weights"][0], runtime=rt))
        states[-1].refresh(params)
    ctx = np.concatenate([data.context_query(s)["context_ids"] for s in range(4)])
    stacked = np.stack([ctx] * 3)
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    mode = torch.cuda.get_sync_debug_mode()
    guarded = [states[0].topk(ctx[:1], 16), states[0].topk(ctx, 16),
               fused_topk(states, stacked, 16)]
    assert torch.cuda.get_sync_debug_mode() == mode
    monkeypatch.delenv("REPRO_SANITIZE")
    plain = [states[0].topk(ctx[:1], 16), states[0].topk(ctx, 16),
             fused_topk(states, stacked, 16)]
    for got, want in zip(guarded, plain):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_cuda_guard_catches_the_lookups_first_use_copy(cuda, monkeypatch):
    """The sync the guard found on the dispatch path: a context lookup's
    first call on a layout copies the layout's static maps from pageable
    host memory, which waits for the card.  ``refresh`` primes them
    (``prepare_lookups``); unprimed, the guarded dispatch raises."""
    from repro_torch.configs import dplr_fwfm
    from repro_torch.data.synthetic_ctr import SyntheticCTR
    from repro_torch.embedding import bag
    from repro_torch.models.recsys import fwfm
    from repro_torch.serving import CorpusState

    cfg = dplr_fwfm.make_smoke()
    data = SyntheticCTR(cfg.layout, embed_dim=4, seed=0)
    q = data.ranking_query(300, 0)
    st = CorpusState(cfg, q["item_ids"][0], q["item_weights"][0], device=cuda)
    st.refresh(fwfm.init(torch.Generator(device=cuda).manual_seed(0), cfg))
    ctx = data.context_query(0)["context_ids"]
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    st.topk(ctx, 8)                            # primed at refresh: clean
    bag._statics.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="synchroniz"):
            st.topk(ctx, 8)
    finally:
        bag.prepare_lookups(cfg.layout.subset("context"), st.params["embedding"].device)
    st.topk(ctx, 8)


# -- bf16: kernels 1-5 on a bf16 slab, V_I or table ----------------------------

def _bits_equal(a, b) -> bool:
    """float32 tensors equal bit for bit (so -0.0 differs from 0.0)."""
    return (a.dtype == b.dtype == torch.float32 and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))


def _bf16_and_upcast(arrays, cuda):
    """``arrays`` as bf16 tensors on the card (bool ones as they are), and
    those bf16 values upcast to float32."""
    b16 = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in arrays)
    b16 = tuple(t.to(torch.bfloat16) if t.dtype == torch.float32 else t for t in b16)
    return b16, tuple(t.float() if t.dtype == torch.bfloat16 else t for t in b16)


@pytest.mark.cuda
@pytest.mark.parametrize("n,Bq,K,rho,k", [(1000, 3, 7, 3, 16), (70_000, 16, 16, 3, 16),
                                          (70_000, 1, 4097, 3, 16), (5000, 2, 5000, 3, 16),
                                          (1000, 5, 9, 1, 3), (3000, 2, 16, 8, 16)])
def test_cuda_bf16_corpus_kernels_are_bitwise_their_f32_launch_on_upcast_inputs(cuda, n, Bq,
                                                                                K, rho, k):
    """A bf16 slab (and bf16 e, P_C, a_C, upcast by the wrapper) scores
    bitwise as the float32 kernels score the upcast tensors, full and top-K
    (K past 4096, K = n, relabeled; rho k = 3, whose rows are no whole
    16-byte piece, and 128), and the top-K is kernel 1's scores sorted
    (C1).  The bf16 instantiations launch, under their own names."""
    b16, up = _bf16_and_upcast(corpus_inputs(40, n, rho, k, Bq), cuda)
    ops.reset_launches()
    full = ops.dplr_corpus_score(*b16)
    vals, ids = ops.dplr_corpus_score(*b16, topk=K, index_offset=3, index_stride=2)
    assert ops.LAUNCHES["corpus_score_full_bf16"] == ops.LAUNCHES["corpus_topk_chunks_bf16"] == 1
    assert ops.LAUNCHES["corpus_score_full"] == ops.LAUNCHES["corpus_topk_chunks"] == 0
    assert _bits_equal(full, ops.dplr_corpus_score(*up))
    want_v, want_i = ops.dplr_corpus_score(*up, topk=K, index_offset=3, index_stride=2)
    assert _bits_equal(vals, want_v) and torch.equal(ids, want_i)
    sv, si = ref.topk_stable(full, K)
    assert _bits_equal(vals, sv) and torch.equal(ids, (3 + 2 * si).to(torch.int32))
    assert_scores(full, ref.dplr_corpus_score_ref(*b16))


@pytest.mark.cuda
@pytest.mark.parametrize("slab", [torch.float32, torch.bfloat16])
def test_cuda_bf16_accumulation_is_within_one_bf16_rounding_of_plain(cuda, slab):
    """``acc_dtype='bfloat16'`` against its plain version: within half a
    bf16 ulp of the rank-space term, 2^-8 sum_r |e_r| ||P_C + Q_I||^2, plus
    the float32 bound (the two sum the exact products in other orders, so
    their sums may round to neighbouring bf16 values); its top-K is its
    own kernel 1 sorted (C1)."""
    arrays = corpus_inputs(41, 30_000, 3, 16, 5)
    Q, a_I, e, P_C, a_C, valid = (torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                                  for a in arrays)
    Q, a_I = Q.to(slab), a_I.to(slab)
    args = (Q, a_I, e, P_C, a_C, valid)
    ops.reset_launches()
    got = ops.dplr_corpus_score(*args, acc_dtype="bfloat16")
    name = "corpus_score_full" + ("_bf16" if slab == torch.bfloat16 else "") + "_accbf16"
    assert ops.LAUNCHES[name] == 1
    want = ref.dplr_corpus_score_ref(*args, acc_dtype="bfloat16")
    P = P_C[:, None] + Q.float()[None]
    term = torch.einsum("qnrk,r->qn", P * P, e.abs())
    size = a_C.abs()[:, None] + a_I.float().abs()[None] + 0.5 * term
    bound = 2.0**-8 * term + 1e-5 * torch.clamp(size, min=1.0)
    assert ((got - want).abs() <= bound).all(), float(((got - want).abs() / bound).max())
    for K in (16, 4097):
        vals, ids = ops.dplr_corpus_score(*args, topk=K, acc_dtype="bfloat16")
        sv, si = ref.topk_stable(got, K)
        assert _bits_equal(vals, sv) and torch.equal(ids, si.to(torch.int32))
    with pytest.raises(ValueError, match="acc_dtype"):
        ops.dplr_corpus_score(*args, acc_dtype="float16")


@pytest.mark.cuda
@pytest.mark.parametrize("acc_dtype", ["float32", "bfloat16"])
def test_cuda_bf16_multi_kernel_is_bitwise_its_f32_launch_and_refuses_mixed_types(cuda,
                                                                                  acc_dtype):
    """Kernel 4 on bf16 slabs: bitwise its float32 launch on the upcast
    slabs (f32 accumulation), each row bitwise the single-tenant kernel on
    its segment in either mode; segments of two types raise."""
    parts = [_bf16_and_upcast(p, cuda) for p in _segments((1100, 70_000, 5000), 2)]
    stack = lambda ps: ((tuple(p[0] for p in ps), tuple(p[1] for p in ps),  # noqa: E731
                         tuple(p[5] for p in ps))
                        + tuple(torch.stack([p[j] for p in ps]) for j in (2, 3, 4)))
    b16, up = stack([p[0] for p in parts]), stack([p[1] for p in parts])
    ops.reset_launches()
    vals, ids = ops.dplr_corpus_score_multi(*b16, topk=1024, acc_dtype=acc_dtype)
    assert ops.LAUNCHES[ops.launch_name("corpus_multi_topk_chunks", torch.bfloat16,
                                        acc_dtype)] == 1
    if acc_dtype == "float32":
        want_v, want_i = ops.dplr_corpus_score_multi(*up, topk=1024)
        assert _bits_equal(vals, want_v) and torch.equal(ids, want_i)
    for s, (p, _) in enumerate(parts):
        one_v, one_i = ops.dplr_corpus_score(*p, topk=1024, acc_dtype=acc_dtype)
        assert _bits_equal(vals[s], one_v) and torch.equal(ids[s], one_i), s
    mixed = ((up[0][0],) + b16[0][1:], (up[1][0],) + b16[1][1:]) + b16[2:]
    with pytest.raises(TypeError, match="mixed"):
        ops.dplr_corpus_score_multi(*mixed, topk=16)


@pytest.mark.cuda
def test_cuda_bf16_score_items_is_bitwise_its_f32_launch_on_upcast_inputs(cuda):
    """Kernel 3 on a bf16 V_I (bf16 small operands, upcast by the wrapper)
    scores bitwise as the float32 kernel scores the upcast tensors: the
    serving shape through the bulk copies, n past a tile edge, k % 8 != 0
    (12, and odd 3) and a V_I 2 bytes off a 4-byte boundary through the
    plain loads, m_I = 200 in two chunks of fields, rho k = 128; every row
    of a batched call bitwise the per-query call."""
    rng = np.random.default_rng(42)
    t = dplr_score.tile(38, 3, 16)
    for i, (Bq, n, mI, k, rho, mis) in enumerate([
            (3, 1000, 38, 16, 3, False), (2, 4 * t + 1, 38, 16, 3, False),
            (2, 300, 38, 12, 3, False), (2, 299, 13, 3, 3, False), (3, 1000, 38, 16, 3, True),
            (2, 100, 200, 16, 3, False), (2, 300, 38, 16, 8, False)]):
        args = _items_inputs(rng, Bq, n, mI, k, rho, cuda)
        b16 = [a.to(torch.bfloat16) for a in args]
        if mis:                                    # 2 bytes past a 16-byte boundary
            flat = torch.empty(b16[0].numel() + 1, dtype=torch.bfloat16, device=cuda)
            b16[0] = flat[1:].view(b16[0].shape).copy_(b16[0])
        up = [a.float() for a in b16]
        ops.reset_launches()
        got = ops.dplr_score_items(*b16)
        assert ops.LAUNCHES == {"dplr_score_items_kernel_bf16": 1}, i
        assert _bits_equal(got, ops.dplr_score_items(*up)), i
        _assert_items_close(got, up)
        V, U, e, d, PC, sC = b16
        for q in range(Bq):
            assert torch.equal(ops.dplr_score_items(V[q], U, e, d, PC[q], sC[q]), got[q]), i
    with pytest.raises(TypeError, match="dtype"):
        ops.dplr_score_items(up[0], up[1].half(), *up[2:])


@pytest.mark.cuda
@pytest.mark.parametrize("B,slots,F,k,multi_hot,misaligned", [
    (4097, 82, 82, 16, False, False),   # one slot a bag: 8 bf16 (16 bytes) a thread
    (16, 44, 44, 16, False, True),      # a table 2 bytes off: one element a thread
    (33, 30, 7, 16, True, False),       # bags of several slots
    (9, 5, 5, 12, False, False),        # k % 8 != 0
    (9, 5, 3, 6, True, False),
])
def test_cuda_bf16_embedding_bag_matches_plain(cuda, B, slots, F, k, multi_hot, misaligned):
    """Kernel 5 on a bf16 table and bf16 weights returns bf16 bags: bitwise
    the plain version one slot a bag; on bags of m slots bitwise the plain
    version summed in the kernel's order, and within 2^-7 (m - 1) sum |w
    row| of ``embedding_bag_ref`` (each of the m - 1 adds rounds by at most
    2^-8 of the sum so far, and its atomics add in another order).  A bf16 table that needs a
    gradient raises: the backward kernel is float32."""
    table, ids, w, seg = _bag(43, B, slots, F, k, multi_hot=multi_hot)
    table = torch.from_numpy(table).to(cuda).to(torch.bfloat16)
    if misaligned:
        flat = torch.empty(table.numel() + 1, dtype=torch.bfloat16, device=cuda)
        table = flat[1:].view(table.shape).copy_(table)
    ids = torch.from_numpy(ids).to(cuda)
    w = torch.from_numpy(w).to(cuda).to(torch.bfloat16)
    bags = ops.bag_map(seg, F, cuda)
    ops.reset_launches()
    got = ops.embedding_bag(table, ids, w, bags)
    assert ops.LAUNCHES == {"embedding_bag_kernel_bf16": 1} and got.dtype == torch.bfloat16
    want = ref.embedding_bag_ref(table, ids, w, seg, F)
    if not multi_hot:
        assert torch.equal(got, want)
    else:
        assert torch.equal(got, ref.embedding_bag_in_order(table, ids, w, seg, F))
        size = ref.embedding_bag_ref(table.float().abs(), ids, w.float(), seg, F)
        adds = torch.as_tensor(np.maximum(np.bincount(seg, minlength=F) - 1, 0),
                               dtype=torch.float32, device=cuda)[:, None]
        assert ((got.float() - want.float()).abs() <= 2.0**-7 * adds * size).all()
    with pytest.raises(TypeError, match="dtype"):
        ops.embedding_bag(table, ids, w.float(), bags)
    with pytest.raises(TypeError, match="float32"):
        ops.embedding_bag(table.detach().requires_grad_(), ids, w, bags)


@pytest.mark.cuda
def test_cuda_bf16_engine_and_rank_items_run_the_bf16_kernels(cuda):
    """bf16 params on the card: the slab is bf16, scores and top-K values
    float32, and the lookups, the slab's top-K and scores and Algorithm 1
    run the bf16 kernels alone; the answers agree with the CPU's plain path
    on the same bf16 params within the reference's bf16 tolerance (rtol
    2e-2, atol 1e-1), top-K ids equal except near ties."""
    from repro_torch.configs import dplr_fwfm
    from repro_torch.data.synthetic_ctr import SyntheticCTR
    from repro_torch.models.recsys import fwfm
    from repro_torch.serving import CorpusState

    cfg = dplr_fwfm.make_smoke()
    data = SyntheticCTR(cfg.layout, embed_dim=4, seed=0)
    p32 = fwfm.init(torch.Generator(device=cuda).manual_seed(0), cfg)
    p16 = {k: v.to(torch.bfloat16) for k, v in p32.items()}
    q = data.ranking_query(500, 0)
    ctx = np.concatenate([data.context_query(s)["context_ids"] for s in range(4)])
    out = {}
    for dev, params in ((cuda, p16), (torch.device("cpu"), {k: v.cpu() for k, v in p16.items()})):
        st = CorpusState(cfg, q["item_ids"][0], q["item_weights"][0], device=dev)
        st.refresh(params)
        assert st.cache.Q_I.dtype == st.cache.a_I.dtype == torch.bfloat16
        ops.reset_launches()
        scores, (vals, ids) = st.score(ctx), st.topk(ctx, 16)
        rq = {k: torch.as_tensor(v, device=dev) for k, v in data.ranking_query(300, 1).items()}
        items = fwfm.rank_items(params, cfg, rq)
        assert scores.dtype == vals.dtype == items.dtype == torch.float32
        out[dev.type] = (scores.cpu(), vals.cpu(), ids.cpu(), items.cpu(), dict(ops.LAUNCHES))
    launched = {g for g, c in out["cuda"][4].items() if c}
    assert launched >= {"embedding_bag_kernel_bf16", "corpus_score_full_bf16",
                        "corpus_topk_chunks_bf16", "topk_merge", "dplr_score_items_kernel_bf16"}
    assert not launched & {"embedding_bag_kernel", "corpus_score_full", "corpus_topk_chunks",
                           "dplr_score_items_kernel"}
    tol = dict(rtol=2e-2, atol=1e-1)
    for got, want in zip(out["cuda"][:4], out["cpu"][:4]):
        if got.dtype == torch.float32:
            np.testing.assert_allclose(to_np(got), to_np(want), **tol)
    full = to_np(out["cpu"][0])
    for row, (g, w_) in enumerate(zip(to_np(out["cuda"][2]), to_np(out["cpu"][2]))):
        for j in np.flatnonzero(g != w_):
            assert abs(full[row, g[j]] - full[row, w_[j]]) <= tol["atol"] + tol["rtol"] * abs(
                full[row, w_[j]]), (row, j)


# -- kernel 1 (the persistent ring) at its edges -----------------------------

# (n, Bq, rho, k): one slot; a 256-row tile - 1 and + 1; 3 tiles + 5; one,
# two and three query groups; rho k = 3 (element copies, rows read an
# element at a time); rho k = 128 (fewer rows a stage); k = 12 (wide rows
# in f32, not in bf16)
FULL_EDGES = [(1, 1, 3, 16), (255, 3, 3, 16), (257, 5, 3, 16), (773, 16, 3, 16),
              (3000, 17, 3, 16), (3000, 33, 3, 16), (1000, 4, 1, 3), (1000, 2, 4, 32),
              (1000, 16, 8, 16), (2000, 5, 3, 12)]


def _full_args(seed, n, Bq, rho, k, cuda):
    """corpus_inputs on the card, slot 0 live, and past 512 slots a whole
    256-slot tile dead."""
    arrays = list(corpus_inputs(seed, n, rho, k, Bq))
    arrays[5][0] = True
    if n > 512:
        arrays[5][256:512] = False
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("n,Bq,rho,k", FULL_EDGES)
def test_cuda_full_kernel_at_its_edges_matches_plain_and_its_f32_launch(cuda, n, Bq, rho, k):
    """Kernel 1 against its plain version (atol = rtol = 1e-5), every dead
    slot exactly NEG_INF; on a bf16 slab bitwise the f32 launch on the
    upcast slab, and with ``acc_dtype='bfloat16'`` bitwise across the two
    slab types."""
    args = _full_args(50, n, Bq, rho, k, cuda)
    got = ops.dplr_corpus_score(*args)
    assert_scores(got, ref.dplr_corpus_score_ref(*args))
    assert (got[:, ~args[5]] == NEG_INF).all()
    b16, up = _slab(args, torch.bfloat16), _slab(_slab(args, torch.bfloat16), torch.float32)
    assert _bits_equal(ops.dplr_corpus_score(*b16), ops.dplr_corpus_score(*up))
    assert _bits_equal(ops.dplr_corpus_score(*b16, acc_dtype="bfloat16"),
                       ops.dplr_corpus_score(*up, acc_dtype="bfloat16"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_full_kernel_sorted_is_kernel_2_at_k_equals_n(cuda, dtype):
    """C1 turned around: kernel 2 at K = n returns every row of kernel 1's
    scores sorted, bit for bit (n = 65,536, Bq = 17: two query groups)."""
    n, Bq = 65_536, 17
    args = _slab(_full_args(51, n, Bq, 3, 16, cuda), dtype)
    scores = ops.dplr_corpus_score(*args)
    vals, ids = ops.dplr_corpus_score(*args, topk=n)
    sv, si = ref.topk_stable(scores, n)
    assert _bits_equal(vals, sv) and torch.equal(ids, si.to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,Bq", [(773, 16), (3000, 33)])
def test_cuda_full_kernel_every_run_and_group_is_bitwise_the_default(cuda, dtype, n, Bq):
    """Every run (the slots a block claims at a time, 1 to past n) at every
    query group up to the default returns the default geometry's bits."""
    args = _slab(_full_args(52, n, Bq, 3, 16, cuda), dtype)
    want = ops.dplr_corpus_score(*args)
    for run in (1, 7, 255, 256, 257, 1000, 4096, blocks.MAX_BLOCK_N):
        for G in blocks.GROUPS[:blocks.GROUPS.index(blocks.group_size(Bq)) + 1]:
            got = ops._corpus_score(*args, None, 0, 1, blocks.Tile(run, group=G))
            assert _bits_equal(got, want), (run, G)
    blocks.drain_clamp_events()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,elems", [(torch.float32, 1), (torch.bfloat16, 1),
                                         (torch.bfloat16, 3)])
def test_cuda_full_kernel_takes_a_misaligned_slab(cuda, dtype, elems):
    """A slab starting 4 (f32) or 2 and 6 (bf16) bytes past a 16-byte
    boundary takes the element copies, bitwise the aligned call."""
    args = _slab(_full_args(53, 5000, 16, 3, 16, cuda), dtype)
    flat = torch.empty(args[0].numel() + elems, dtype=dtype, device=cuda)
    moved = flat[elems:].view(args[0].shape).copy_(args[0])
    assert moved.data_ptr() % 16 != 0
    assert _bits_equal(ops.dplr_corpus_score(moved, *args[1:]),
                       ops.dplr_corpus_score(*args))


# -- the corpus kernels' geometry (kernels/blocks.py, kernels/autotune.py) --

@pytest.mark.cuda
def test_cuda_named_geometry_is_the_librarys_and_fits_are_reported(cuda):
    """``blocks`` names the library's own defaults and limits, and the
    library's fit query refuses stage-1 shared memory past the card's."""
    assert corpus_lib.geometry_defaults() == dict(
        full_block_n=blocks.CORPUS_FULL_BLOCK_N, full_threads=blocks.CORPUS_FULL_THREADS,
        chunk=blocks.CORPUS_CHUNK, threads=blocks.CORPUS_THREADS,
        max_group=blocks.CORPUS_MAX_GROUP, part=blocks.CORPUS_PART,
        max_chunk=blocks.MAX_BLOCK_N, max_threads=blocks.MAX_THREADS)
    for dtype in (torch.float32, torch.bfloat16):
        assert corpus_lib.geometry_fits(blocks.default_tile(16, 16), True, 3, 16, dtype, 16,
                                        cuda)
        assert corpus_lib.geometry_fits(blocks.default_tile(16, None), False, 3, 16, dtype,
                                        None, cuda)
        big = blocks.Tile(8192, "float32", 16, 256, blocks.CORPUS_PART)
        assert not corpus_lib.geometry_fits(big, True, 3, 16, dtype, 16, cuda)
    with pytest.raises(ValueError, match="refuse"):
        corpus_lib.geometry_fits(blocks.Tile(512, "float32", 3, 256, 16384), True, 3, 16,
                                 torch.float32, 16, cuda)


def _swept(n, Bq, K, rho, k, dtype, cuda):
    """The default sweep's geometries that fit the card at this cell."""
    out = []
    for geo in autotune.DEFAULT_CANDIDATES:
        tile = blocks.resolve_tile(n, rho, k, Bq, K, blocks.dtype_name(dtype), "cuda", **geo)
        if corpus_lib.geometry_fits(tile, True, rho, k, dtype, K, cuda):
            out.append(geo)
    blocks.drain_clamp_events()
    return out


def _slab(args, dtype):
    return (args[0].to(dtype), args[1].to(dtype), *args[2:])


GEOMETRY_CASES = {
    "ragged n": (70_001, 5, 16),
    "all-dead tile": (9000, 3, 64),
    "K past 4096": (70_000, 2, 5000),
    "K = n": (3000, 2, 3000),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(GEOMETRY_CASES))
def test_cuda_every_swept_geometry_is_bitwise_the_default(cuda, case, dtype):
    """Every geometry of the default sweep that fits (chunk, stage-1
    threads, query group, merge part; in the full mode the run and the
    group) returns the default geometry's bits, which are kernel 1's
    scores sorted (C1), f32 and bf16 slabs."""
    n, Bq, K = GEOMETRY_CASES[case]
    arrays = list(corpus_inputs(31, n, 3, 16, Bq))
    if case == "all-dead tile":
        arrays[5][4096:8192] = False
    args = _slab(tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in arrays),
                 dtype)
    full = ops.dplr_corpus_score(*args)
    want_v, want_i = ops.dplr_corpus_score(*args, topk=K)
    sv, si = ref.topk_stable(full, K)
    assert _bits_equal(want_v, sv) and torch.equal(want_i, si.to(torch.int32))
    swept = _swept(n, Bq, K, 3, 16, dtype, cuda)
    assert len(swept) > len(autotune.DEFAULT_CANDIDATES) // 2
    for geo in swept:
        vals, ids = ops._corpus_score(*args, K, 0, 1, blocks.Tile(**geo))
        assert _bits_equal(vals, want_v) and torch.equal(ids, want_i), geo
        got = ops._corpus_score(*args, None, 0, 1, blocks.Tile(geo["block_n"],
                                                                group=geo["group"]))
        assert _bits_equal(got, full), geo
    blocks.drain_clamp_events()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_every_swept_geometry_is_bitwise_the_default_multi(cuda, dtype):
    """A multi-tenant launch whose segments are all smaller than the
    larger chunks: every geometry that fits returns the default's bits,
    row [s] bitwise the single-segment call."""
    ns, Bq, K = (300, 700, 1500), 2, 7
    parts = [_slab(tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in p), dtype)
             for p in _segments(ns, Bq)]
    Q_parts, a_parts, valid_parts = (tuple(p[j] for p in parts) for j in (0, 1, 5))
    e, P_C, a_C = (torch.stack([p[j] for p in parts]) for j in (2, 3, 4))
    want_v, want_i = ops.dplr_corpus_score_multi(Q_parts, a_parts, valid_parts, e, P_C, a_C,
                                                 topk=K)
    for s, p in enumerate(parts):
        one_v, one_i = ops.dplr_corpus_score(*p[:5], valid=p[5], topk=K)
        assert _bits_equal(want_v[s], one_v) and torch.equal(want_i[s], one_i), s
    swept = _swept(max(ns), Bq, K, 3, 16, dtype, cuda)
    assert any(geo["block_n"] > max(ns) for geo in swept)
    for geo in swept:
        vals, ids = ops._corpus_score_multi(Q_parts, a_parts, valid_parts, e, P_C, a_C, K, 0,
                                            1, blocks.Tile(**geo))
        assert _bits_equal(vals, want_v) and torch.equal(ids, want_i), geo
    blocks.drain_clamp_events()


@pytest.mark.cuda
def test_cuda_no_record_makes_a_call_unlaunchable(cuda):
    """A Bq = 1 record of chunk 4,096 leaves a Bq = 16 top-K on the same
    slab at the default geometry (its query group was never timed), and an
    exact Bq = 16 record of chunk 32,768 at group 16, past the card's
    shared memory, is halved visibly until it launches: both bitwise the
    default's answer."""
    n, Bq, K = 70_000, 16, 16
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                 for a in corpus_inputs(37, n, 3, 16, Bq))
    want = ops.dplr_corpus_score(*args, topk=K)
    cell = lambda bq: blocks.tile_cell(n, 3, 16, bq, K, "float32", "cuda")  # noqa: E731
    try:
        blocks.register_tuned_tile(cell(1), 4096)
        assert blocks.resolve_tile(n, 3, 16, Bq, K, "float32", "cuda") == blocks.default_tile(
            Bq, K)
        got = ops.dplr_corpus_score(*args, topk=K)
        assert _bits_equal(got[0], want[0]) and torch.equal(got[1], want[1])
        blocks.register_tuned_tile(cell(Bq), blocks.MAX_BLOCK_N, group=16)
        blocks.drain_clamp_events()
        got = ops.dplr_corpus_score(*args, topk=K)
        halved = blocks.drain_clamp_events()
        assert halved[0] == {"requested": blocks.MAX_BLOCK_N,
                             "effective": blocks.MAX_BLOCK_N // 2, "n": n}
        last = blocks.Tile(halved[-1]["effective"], "float32", 16, blocks.CORPUS_THREADS,
                           blocks.CORPUS_PART)
        assert corpus_lib.geometry_fits(last, True, 3, 16, torch.float32, K, cuda)
        assert _bits_equal(got[0], want[0]) and torch.equal(got[1], want[1])
    finally:
        blocks.clear_tuned_tiles()
        blocks.drain_clamp_events()


@pytest.mark.cuda
def test_cuda_tuner_times_the_device_not_the_host(cuda):
    """``autotune._time_call`` times a call's device work even when the host
    takes longer to issue it than the card to run it (2 ms of host time a
    call, a few microseconds of device time): the calls wait behind a
    device-side sleep, lengthened until the host has queued them all."""
    import time

    def slow_host():
        time.sleep(0.002)
        torch.cuda._sleep(1000)
    us = autotune._time_call(slow_host, 8, cuda)
    assert 0 < us < 500, us


@pytest.mark.cuda
def test_cuda_pna_step_matches_the_cpu(cuda):
    """PNA's smoke config on a sampled subgraph, node task, f32: the loss
    and every gradient on the card against the CPU's on the same weights
    and batch.  The card's ``index_add_`` adds with atomics and its
    matmuls round otherwise, and the std aggregator's cancellation
    (several identical messages into a node) magnifies a last-bit
    difference: the loss within ``1e-5 max(1, |loss|)`` plus the CPU's own
    spread (its loss with the node features one ulp up), each gradient leaf
    within ``1e-4`` of its largest entry plus that spread's share."""
    from repro_torch import optim
    from repro_torch.configs import pna as pna_cfg
    from repro_torch.models.gnn import pna, sampler

    cfg = pna_cfg.make_smoke()
    rng = np.random.default_rng(0)
    g = sampler.random_graph(rng, 2000, 8, cfg.d_feat, cfg.n_classes)
    nb = sampler.sample_subgraph(g, rng.integers(0, 2000, 64), (6, 4), rng)
    cpu = {k: torch.from_numpy(v) for k, v in nb.items()}
    params = pna.init(torch.Generator().manual_seed(0), cfg)
    loss_c, grads_c = optim.value_and_grad(pna.loss)(params, cfg, cpu)
    feat = cpu["node_feat"]
    nudged = dict(cpu, node_feat=torch.nextafter(feat, torch.full_like(feat, np.inf)))
    spread = abs(float(pna.loss(params, cfg, nudged)) - float(loss_c))
    gpu_params = {k: ({n: ({a: b.to(cuda) for a, b in t.items()} if isinstance(t, dict)
                           else t.to(cuda)) for n, t in v.items()} if isinstance(v, dict)
                      else v.to(cuda)) for k, v in params.items()}
    loss_g, grads_g = optim.value_and_grad(pna.loss)(
        gpu_params, cfg, {k: v.to(cuda) for k, v in cpu.items()})
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * max(1.0, abs(float(loss_c))) + 2 * spread

    def leaves(tree, prefix=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from leaves(tree[k], f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", tree[k]

    for (name, gc), (_, gg) in zip(leaves(grads_c), leaves(grads_g)):
        err = float((gg.cpu() - gc).abs().max())
        assert err <= 1e-4 * float(gc.abs().max()) + 1e-3 * spread + 1e-12, (name, err)


@pytest.mark.cuda
def test_cuda_lm_loss_step_matches_the_cpu_and_repeats(cuda):
    """gemma3-1b's smoke config in f32 compute: ``lm_loss`` and its
    gradients on the card against the CPU (loss within ``1e-5 max(1,
    |loss|)``, each leaf within ``1e-4`` of its largest entry), and, under
    ``launch.train.deterministic()``, the same bits on a second call."""
    import dataclasses

    from repro_torch import optim
    from repro_torch.configs import gemma3_1b
    from repro_torch.launch import train
    from repro_torch.models.transformer import model as tm

    cfg = dataclasses.replace(gemma3_1b.make_smoke(), compute_dtype=torch.float32)
    params = tm.init(torch.Generator().manual_seed(0), cfg)
    batch = train.lm_tokens(cfg, 2, 48, 0, 0)
    fn = optim.value_and_grad(lambda p, c, b: tm.lm_loss(p, c, b, device=p["embed"].device))
    loss_c, grads_c = fn(params, cfg, batch)
    gpu = {k: ({n: t.to(cuda) for n, t in v.items()} if isinstance(v, dict) else v.to(cuda))
           for k, v in params.items()}
    with train.deterministic():
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] in (train.CUBLAS_WORKSPACE, ":16:8")
        loss_g, grads_g = fn(gpu, cfg, batch)
        loss_2, grads_2 = fn(gpu, cfg, batch)
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * max(1.0, abs(float(loss_c)))
    assert _bits_equal(loss_g, loss_2)
    flat = lambda t: [(k, v) for k, v in sorted(t.items())]  # noqa: E731
    for (name, gc), (_, gg), (_, g2) in zip(flat(grads_c), flat(grads_g), flat(grads_2)):
        if isinstance(gc, dict):
            for n in sorted(gc):
                assert float((gg[n].cpu() - gc[n]).abs().max()) <= 1e-4 * float(gc[n].abs().max())
                assert _bits_equal(gg[n], g2[n]), n
        else:
            assert float((gg.cpu() - gc).abs().max()) <= 1e-4 * float(gc.abs().max()), name
            assert _bits_equal(gg, g2), name


def _routes_recorded(monkeypatch):
    """Each ``moe.moe_ffn`` call appends the experts its own logits choose."""
    from repro_torch.models.transformer import moe

    seen, real = [], moe.moe_ffn

    def recording(x, router_w, w_gate, w_in, w_out, cfg, experts=None):
        seen.append(moe.route(x, router_w, cfg).cpu())
        return real(x, router_w, w_gate, w_in, w_out, cfg, experts)

    monkeypatch.setattr(moe, "moe_ffn", recording)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mixtral-8x7b"])
def test_cuda_moe_lm_loss_step_matches_the_cpu_and_repeats(cuda, arch, monkeypatch):
    """An MoE LM's smoke config in f32 compute: the routes of every layer
    equal on the card and the CPU, then ``lm_loss`` within ``1e-5 max(1,
    |loss|)`` and each gradient within ``1e-4`` of its largest entry; under
    ``launch.train.deterministic()`` the same bits on a second call."""
    import dataclasses

    from repro_torch import optim
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.launch import train
    from repro_torch.models.transformer import model as tm

    cfg = dataclasses.replace(REGISTRY[arch].make_smoke(), compute_dtype=torch.float32)
    params = tm.init(torch.Generator().manual_seed(0), cfg)
    batch = train.lm_tokens(cfg, 2, 48, 0, 0)
    fn = optim.value_and_grad(lambda p, c, b: tm.lm_loss(p, c, b, device=p["embed"].device))
    seen = _routes_recorded(monkeypatch)
    loss_c, grads_c = fn(params, cfg, batch)
    gpu = {k: ({n: t.to(cuda) for n, t in v.items()} if isinstance(v, dict) else v.to(cuda))
           for k, v in params.items()}
    with train.deterministic():
        loss_g, grads_g = fn(gpu, cfg, batch)
        loss_2, grads_2 = fn(gpu, cfg, batch)
    L = cfg.n_layers
    assert len(seen) == 3 * L
    assert all(torch.equal(a, b) for a, b in zip(seen[:L], seen[L:2 * L]))
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * max(1.0, abs(float(loss_c)))
    assert _bits_equal(loss_g, loss_2)
    for name in sorted(grads_c["layers"]):
        gc, gg = grads_c["layers"][name], grads_g["layers"][name]
        assert float((gg.cpu() - gc).abs().max()) <= 1e-4 * float(gc.abs().max()), name
        assert _bits_equal(gg, grads_2["layers"][name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("impl,fused", [("einsum", False), ("scatter", False),
                                        ("einsum", True)])
def test_cuda_moe_ffn_matches_the_cpu(cuda, impl, fused):
    """Each MoE implementation at granite's widths (d 1024, 32 experts top-8,
    d_ff 512) on two groups of 512 tokens, f32, under the CPU's routes:
    within ``1e-5 max |out|`` of the CPU's output."""
    from repro_torch.models.transformer import moe

    gen = torch.Generator().manual_seed(0)
    d, E, f = 1024, 32, 512
    x = torch.randn(2, 512, d, generator=gen)
    w = [torch.randn(d, E, generator=gen) / d**0.5] + [
        torch.randn(s, generator=gen) / E**0.5 for s in ((E, d, f), (E, d, f), (E, f, d))]
    cfg = moe.MoEConfig(n_experts=E, top_k=8, impl=impl, fused_combine=fused)
    experts = moe.route(x, w[0], cfg)
    want = moe.moe_ffn(x, *w, cfg, experts)
    got = moe.moe_ffn(x.to(cuda), *(t.to(cuda) for t in w), cfg, experts.to(cuda))
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())

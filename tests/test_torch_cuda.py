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
from repro_torch.kernels.dplr_corpus_score import MAX_TOPK, NEG_INF  # noqa: E402

from test_torch_parity import assert_scores, assert_topk, corpus_inputs, to_np  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ and have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,merges", [(1000, 7, 0), (70_000, 16, 1), (70_000, 1024, 1),
                                        (70_000, MAX_TOPK, 2)])
def test_cuda_corpus_kernels_match_plain(cuda, n, K, merges):
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
    assert ops.LAUNCHES["topk_merge"] == 2 * merges


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

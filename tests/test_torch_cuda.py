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

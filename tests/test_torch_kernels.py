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
from repro_torch.kernels.dplr_corpus_score import MAX_RK, MAX_TOPK, NEG_INF  # noqa: E402

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
    _, args = _both(corpus_inputs(5, 64, 3, 8, 2))
    with pytest.raises(ValueError, match="topk"):
        ops.dplr_corpus_score(*args, topk=65)
    with pytest.raises(ValueError, match="topk"):
        ops.dplr_corpus_score(*args, topk=0)
    with pytest.raises(ValueError, match="shape"):
        ops.dplr_corpus_score(args[0], args[1][:10], *args[2:])
    wide = torch.zeros((8, 3, MAX_RK // 3 + 1))
    with pytest.raises(ValueError, match="rho \\* k"):
        ops.dplr_corpus_score(wide, torch.zeros(8), torch.zeros(3),
                              torch.zeros((1, *wide.shape[1:])), torch.zeros(1))
    big = torch.zeros((MAX_TOPK + 1, 1, 1))
    with pytest.raises(ValueError, match="topk"):
        ops.dplr_corpus_score(big, torch.zeros(MAX_TOPK + 1), torch.zeros(1),
                              torch.zeros((1, 1, 1)), torch.zeros(1), topk=MAX_TOPK + 1)
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="device"):
        ops.dplr_corpus_score(*meta)


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

"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py),
and tests of the helpers' own tie rule.

Both packages get the same numpy inputs and the same weights; outputs
come back as numpy and are compared here with the port's tolerances:
f32 scores within atol = rtol = 1e-5, top-K ids equal except between
scores that tie within that tolerance.
"""
import numpy as np
import pytest

TOL = dict(atol=1e-5, rtol=1e-5)


def to_np(x) -> np.ndarray:
    """A torch tensor or JAX/numpy array as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def corpus_inputs(seed, n, rho, k, Bq, dead=0.25):
    """Corpus-scorer inputs (Q_I, a_I, e, P_C, a_C, valid) as numpy, made
    from a seed, with dead slots and planted exact ties: slots 0..3 are
    lifted above the rest and copied to slots n//2 .. n//2 + 3."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, rho, k), dtype=np.float32)
    a_I = rng.standard_normal(n).astype(np.float32)
    e = rng.random(rho).astype(np.float32) + 0.5
    PC = rng.standard_normal((Bq, rho, k), dtype=np.float32)
    a_C = rng.standard_normal(Bq).astype(np.float32)
    valid = rng.random(n) > dead
    a_I[:4] += 100.0
    valid[:4] = True
    Q[n // 2:n // 2 + 4], a_I[n // 2:n // 2 + 4] = Q[:4], a_I[:4]
    valid[n // 2:n // 2 + 4] = True
    return Q, a_I, e, PC, a_C, valid


def assert_scores(got, want):
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


def assert_topk(got_vals, got_ids, want_vals, want_ids, full, offset=0, stride=1):
    """Values equal rank by rank; ids equal, except at ranks where the
    reference's scores tie within the tolerance.  ``full`` is the
    reference's (Bq, n) score matrix, by local slot; returned ids are
    ``offset + stride * slot``."""
    gv, gi = to_np(got_vals), to_np(got_ids).astype(np.int64)
    wv, wi = to_np(want_vals), to_np(want_ids).astype(np.int64)
    full = to_np(full)
    assert gv.shape == wv.shape and gi.shape == wi.shape
    np.testing.assert_allclose(gv, wv, **TOL)
    for row in range(gi.shape[0]):
        assert len(set(gi[row])) == gi.shape[1], "repeated ids"
        for j in np.flatnonzero(gi[row] != wi[row]):
            mine = full[row, (gi[row, j] - offset) // stride]
            assert abs(mine - wv[row, j]) <= TOL["atol"] + TOL["rtol"] * abs(wv[row, j]), (
                f"row {row} rank {j}: id {gi[row, j]} != {wi[row, j]} without a tie")


@pytest.mark.parametrize("got_ids,want_ids,offset,stride", [
    ([[1, 2]], [[2, 1]], 0, 1),     # slots 1 and 2 tie within 1e-5
    ([[7, 11]], [[11, 7]], 3, 4),   # the same, labeled 3 + 4 * slot
])
def test_assert_topk_accepts_ids_swapped_within_a_tie(got_ids, want_ids, offset, stride):
    full = np.array([[3.0, 5.0, 5.0 + 4e-6, 1.0]], dtype=np.float32)
    vals = np.array([[5.0 + 4e-6, 5.0]], dtype=np.float32)
    assert_topk(vals, np.array(got_ids), vals, np.array(want_ids), full,
                offset=offset, stride=stride)


@pytest.mark.parametrize("got_ids,want_ids,match", [
    ([[1, 0]], [[1, 2]], "without a tie"),   # slot 0 scores 3, not the 5 of rank 1
    ([[1, 1]], [[1, 2]], "repeated ids"),
])
def test_assert_topk_rejects_a_real_difference(got_ids, want_ids, match):
    full = np.array([[3.0, 5.0, 5.0, 1.0]], dtype=np.float32)
    vals = np.array([[5.0, 5.0]], dtype=np.float32)
    with pytest.raises(AssertionError, match=match):
        assert_topk(vals, np.array(got_ids), vals, np.array(want_ids), full)

"""The embedding bag's backward on the CPU: the radix sort's plain version
against numpy's stable argsort, and the plain table gradient against
``jax.grad`` of the JAX package's reference bag and against a float32 sum
of each row in slot order, the order the card's writer keeps.  The card's
kernels are held to these plain versions in ``tests/test_torch_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("pattern", ["equal", "ascending", "descending", "skewed",
                                     "out of range", "empty"])
def test_bag_rows_sort_plain_matches_numpy_stable_argsort(dtype, pattern):
    """Keys in the ids' type (those outside ``[0, rows)`` set to ``rows``)
    and int64 flat indices, ascending within a key."""
    rng = np.random.default_rng(40)
    n, rows = 5000, 777
    ids = {"equal": np.full(n, 5), "ascending": np.arange(n) // 7,
           "descending": (np.arange(n) // 7)[::-1],
           "skewed": (rows * rng.random(n) ** 6).astype(np.int64),
           "out of range": rng.integers(-rows, 2 * rows, n),
           "empty": np.zeros(0, np.int64)}[pattern].astype(dtype)
    keys = np.where((ids >= 0) & (ids < rows), ids, rows).astype(dtype)
    perm = np.argsort(keys, kind="stable")
    for sort in (ref.bag_rows_sort, ops.bag_rows_sort):
        got_keys, got_perm = sort(torch.from_numpy(ids.reshape(-1, 100)), rows)
        assert got_keys.dtype == torch.from_numpy(ids).dtype
        assert got_perm.dtype == torch.int64
        np.testing.assert_array_equal(got_keys.numpy(), keys[perm])
        np.testing.assert_array_equal(got_perm.numpy(), perm)


def _bag_case(seed):
    """Hot rows (three take a third of the slots), multi-hot bags, an id
    past the table (at [5, 7]) and, for the port alone, a negative one."""
    rng = np.random.default_rng(seed)
    B, slots, rows, k, F = 24, 10, 50, 8, 4
    ids = rng.integers(0, rows, (B, slots)).astype(np.int32)
    ids[:, :3] = rng.integers(0, 3, (B, 3))
    ids[5, 7] = rows + 3
    seg = np.sort(rng.integers(0, F, slots))
    table = rng.standard_normal((rows, k), dtype=np.float32)
    w = rng.random((B, slots)).astype(np.float32) + 0.5
    grad = rng.standard_normal((B, F, k), dtype=np.float32)
    return ids, seg, table, w, grad, F


def test_plain_table_gradient_matches_jax_grad_of_the_reference():
    """``ref.embedding_bag_vjp`` against ``jax.grad`` of
    ``repro.kernels.ref.embedding_bag_ref``: the table's gradient within
    1e-6 * sum |w g| per element (exactly 0 on rows no slot names; the id
    past the table adds to no row in either), the weights' within 1e-6 *
    sum |g row| on the other slots and NaN on that one in both."""
    ids, seg, table, w, grad, F = _bag_case(41)

    def loss(t, ww):
        return jnp.sum(jref.embedding_bag_ref(t, jnp.asarray(ids), ww, seg, F) * grad)

    jt, jw = (np.asarray(a) for a in jax.grad(loss, (0, 1))(jnp.asarray(table), jnp.asarray(w)))
    args = [torch.from_numpy(a) for a in (table, ids, w)]
    d_table, d_w = ref.embedding_bag_vjp(*args, seg, torch.from_numpy(grad))
    size = ref.embedding_bag_vjp(*args, seg, torch.from_numpy(np.abs(grad)))[0].numpy()
    assert (np.abs(d_table.numpy() - jt) <= 1e-6 * size).all()
    assert np.isfinite(jt).all() and (jt[size == 0] == 0).all()
    past = np.zeros(ids.shape, bool)
    past[5, 7] = True
    assert np.isnan(jw[past]).all() and np.isnan(d_w.numpy()[past]).all()
    ok = np.clip(ids, 0, len(table) - 1)
    w_size = (np.abs(grad[:, seg]) * np.abs(table[ok])).sum(-1)
    assert (np.abs(d_w.numpy() - jw)[~past] <= 1e-6 * w_size[~past]).all()


def test_plain_table_gradient_sums_each_row_in_slot_order():
    """Bitwise a float32 loop over the slots in flat order, each product
    rounded and then added into its row from 0 (the writer's order on the
    card); a slot whose id lies outside ``[0, rows)``, past the table or
    negative, adds to no row.  The entry point on the CPU is this plain
    version."""
    ids, seg, table, w, grad, F = _bag_case(42)
    ids[7, 2] = -4
    rows = len(table)
    want = np.zeros_like(table)
    for b in range(ids.shape[0]):
        for s in range(ids.shape[1]):
            if 0 <= ids[b, s] < rows:
                want[ids[b, s]] = want[ids[b, s]] + grad[b, seg[s]] * w[b, s]
    bags = ops.bag_map(seg, F, "cpu")
    got = ops.embedding_bag_backward(torch.from_numpy(grad), torch.from_numpy(table),
                                     torch.from_numpy(ids), torch.from_numpy(w), bags)
    np.testing.assert_array_equal(got.numpy(), want)

"""The work of each hand-written kernel: one formula a kernel, and the hook
through which an entry point of ``kernels.ops`` reports it.

``kernel_work(name, **dims)`` gives (flops, bytes) of one call of the
kernel behind the ``ops.KERNELS`` entry point ``name`` (its ``_bf16`` form
too).  chip_smoke's timing phase divides it by the card's rates for its
bound column; ``launch.cost.analyze`` adds it to a count, because on
``meta`` an entry point launches nothing and calls ``report`` instead.
Where the work depends on the data (the live slots of a corpus slab), the
caller passes what its data needs; on ``meta`` nothing can be read, so
every slot counts.

``COUNTERS`` is the stack of active counters (objects with an
``add_kernel(name, flops, bytes)``); ``launch.cost`` pushes one for the
length of an ``analyze``.  With none active, ``report`` does nothing.
"""
from __future__ import annotations

import numpy as np

__all__ = ["COUNTERS", "FORMULAS", "attention_pairs", "kernel_work", "report"]


def attention_pairs(S: int, window) -> int:
    """(query, key) pairs causal attention over S positions computes."""
    i = np.arange(S, dtype=np.int64)
    return int(np.minimum(i + 1, S if window is None else window).sum())


def _corpus(*, n, live, Bq, K, rho, k, itemsize, masked=True, segments=1):
    """Kernels 1, 2 and 4: each live slot's row and ``a_I`` read once
    (``itemsize`` bytes an entry), the mask's byte a slot, the query
    side; the (Bq, n) scores written, or the (Bq, K) top-K (f32 values,
    int32 ids); the live slots' scoring arithmetic.  ``segments`` slabs
    alike (kernel 4)."""
    rk = rho * k
    nbytes = (live * (rk + 1) * itemsize + (n if masked else 0) + (rho + Bq * (rk + 1)) * 4
              + (Bq * n * 4 if K is None else Bq * K * 8))
    return segments * Bq * live * (3 * rk + 2 * rho + 3), segments * nbytes


def _items(*, n, Bq, m_I, rho, k, itemsize):
    """Kernel 3: ``V_I`` (Bq, n, m_I, k) read once, the (Bq, n) scores
    written, the small operands."""
    rk = rho * k
    nbytes = Bq * n * m_I * k * itemsize + (Bq * n + rho * m_I + rho + m_I + Bq * (rk + 1)) * 4
    return Bq * n * (m_I * k * (2 + 2 * rho) + 2 * m_I + rho * (2 * k + 2) + 3), nbytes


def _bag(*, slots, B, n_bags, k, itemsize, id_size):
    """Kernel 5: each slot's row, id and weight read, the (B, n_bags, k)
    bags written; a multiply and an add a row element."""
    return 2 * slots * k, slots * (k * itemsize + id_size + itemsize) + B * n_bags * k * itemsize


def _bag_backward(*, slots, B, n_bags, k, rows, id_size):
    """Kernel 5': the output gradient, each slot's id and weight read, the
    whole (rows, k) table written once."""
    return 2 * slots * k, B * n_bags * k * 4 + slots * (id_size + 4) + rows * k * 4


def _sort(*, slots, id_size):
    """Kernel 5''s radix sort alone: the ids read, the keys and int64
    indices written."""
    return 0, slots * (2 * id_size + 8)


def _fwfm(*, B, m, k, itemsize):
    """Kernel 6: V read once, R, the (B,) terms written.  The Gram is
    symmetric: m (m + 1) / 2 dot products of 2k flops, each contracted
    with R_ij + R_ji (2 flops), m (m + 1) (k + 1) an example."""
    return B * m * (m + 1) * (k + 1), B * m * k * itemsize + (m * m + B) * 4


def _flash(*, B, S, H, KV, hd, window, itemsize, Sq=None, q_offset=0):
    """Kernel 7: 4 hd flops a (query, key) pair and head; q, the output and
    the keys and values the rows can see (positions below ``q_offset +
    Sq``) moved once.  ``Sq`` query rows from position ``q_offset`` (default
    S rows from 0)."""
    Sq = S if Sq is None else Sq
    pairs = attention_pairs(q_offset + Sq, window) - attention_pairs(q_offset, window)
    keys = q_offset + Sq
    return 4 * hd * pairs * B * H, B * (2 * Sq * H + 2 * keys * KV) * hd * itemsize


FORMULAS = {
    "dplr_corpus_score": _corpus, "dplr_corpus_topk": _corpus,
    "dplr_corpus_score_multi": _corpus, "dplr_score_items": _items,
    "embedding_bag": _bag, "embedding_bag_backward": _bag_backward,
    "bag_rows_sort": _sort, "fwfm_pairwise": _fwfm, "flash_attention": _flash,
}


def kernel_work(name: str, **dims) -> tuple[int, int]:
    """(flops, bytes) of one call of the kernel behind the ``ops.KERNELS``
    entry point ``name`` (its ``_bf16`` form too) at ``dims``: the one
    formula a kernel's bound and a counted call both use."""
    return FORMULAS[name.removesuffix("_bf16")](**dims)


COUNTERS: list = []


def report(name: str, **dims) -> None:
    """Add one call of ``name``'s kernel (``kernel_work``) to the newest
    active counter, if any: what an entry point of ``kernels.ops`` does on
    ``meta`` instead of a launch."""
    if COUNTERS:
        COUNTERS[-1].add_kernel(name, *kernel_work(name, **dims))

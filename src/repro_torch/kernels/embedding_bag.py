"""Launcher for the embedding-bag CUDA kernel (``csrc/embedding_bag.cu``).

Counterpart of ``repro.kernels.embedding_bag``:

    out[b, bag, :] = sum_{s: seg[s] = bag} w[b, s] * table[ids[b, s], :]

for arena-global ``ids (B, n_slots)`` (int32 or int64), ``weights
(B, n_slots)`` and a static slot -> bag map ``seg``, the table, weights and
bags all float32 or all bfloat16 (each product and add rounded to the
type); and its backward in the table, ``launch_backward``, float32, a
fixed-order sum per row (no atomics): the slots sorted by row
(``launch_sort``, a radix sort), then one writer of the whole table.
The forward kernel reads the map as CSR (bag -> its slots in ascending
order): ``bag_map`` builds it on the host, and its caller keeps the
result for as long as the map lives (``embedding.bag`` keeps one per
layout and device).  Takes CUDA tensors
that ``repro_torch.kernels.ops`` has already checked; callers go through
``ops``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dplr_corpus_score import DTYPE_CODES

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class BagMap(NamedTuple):
    """A static slot -> bag map on one device, with its CSR for the kernel:
    bag ``b`` holds slots ``bag_slots[bag_ptr[b]:bag_ptr[b + 1]]``."""
    segments: torch.Tensor    # (n_slots,) int64: slot -> bag
    bag_ptr: torch.Tensor     # (n_bags + 1,) int32
    bag_slots: torch.Tensor   # (n_slots,) int32, ascending within a bag
    n_bags: int


def bag_map(segment_ids, n_bags: int, device) -> BagMap:
    """The ``BagMap`` of ``segment_ids`` (slot -> bag, in ``[0, n_bags)``)
    on ``device``: three host-to-device copies, so build it once per map."""
    seg = np.asarray(segment_ids, np.int64).reshape(-1)
    if seg.size and (seg.min() < 0 or seg.max() >= n_bags):
        raise ValueError(f"segment ids must lie in [0, {n_bags})")
    ptr = np.zeros(n_bags + 1, np.int32)
    ptr[1:] = np.cumsum(np.bincount(seg, minlength=n_bags))
    order = np.argsort(seg, kind="stable").astype(np.int32)
    return BagMap(*(torch.as_tensor(a, device=device) for a in (seg, ptr, order)),
                  int(n_bags))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("embedding_bag")
    lib.embedding_bag.argtypes = [_P, _I, _L, _I, _P, _I, _P, _P, _P, _L, _I, _I, _P, _P, _I]
    lib.embedding_bag.restype = _I
    lib.bag_rows_sort_scratch.argtypes = [_L, _L, ctypes.POINTER(ctypes.c_longlong)]
    lib.bag_rows_sort_scratch.restype = _I
    lib.bag_rows_sort.argtypes = [_P, _I, _L, _L, _P, _P, _P, _P, _I]
    lib.bag_rows_sort.restype = _I
    lib.embedding_bag_backward.argtypes = [_P, _I, _I, _P, _I, _P, _P, _P, _I, _L, _L, _P, _P,
                                           _P, _I]
    lib.embedding_bag_backward.restype = _I
    return lib


def launch(table, ids, weights, bags: BagMap) -> torch.Tensor:
    """``(B, n_bags, k)`` bags in the table's type for 2-D ``ids``/``weights``
    (B, n_slots)."""
    B, n_slots = ids.shape
    rows, k = table.shape
    dev = table.device
    out = torch.empty((B, bags.n_bags, k), dtype=table.dtype, device=dev)
    status = _lib().embedding_bag(
        table.data_ptr(), DTYPE_CODES[table.dtype], rows, k, ids.data_ptr(), int(ids.dtype == torch.int64),
        weights.data_ptr(), bags.bag_ptr.data_ptr(), bags.bag_slots.data_ptr(), B, n_slots,
        bags.n_bags, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream, dev.index)
    _build.check(status, "embedding_bag launch")
    return out


@functools.lru_cache(maxsize=64)
def _sort_scratch_bytes(n: int, rows: int) -> int:
    nbytes = ctypes.c_longlong()
    _build.check(_lib().bag_rows_sort_scratch(n, rows, ctypes.byref(nbytes)),
                 f"bag_rows_sort of {n} slots over {rows} rows (rows < 2^31 - 1, slots < 2^31)")
    return nbytes.value


def launch_sort(ids, rows: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(keys, perm, scratch)`` for 1-D ``ids`` (int32 or int64, n >= 1):
    bitwise ``torch.sort(keys, stable=True)`` of the ids with those outside
    ``[0, rows)`` set to ``rows`` (keys in the ids' type, perm int64), and
    the scratch the sort used, which ``launch_backward``'s writer takes
    next on the same stream.  Two launches: the histogram, then the passes."""
    dev = ids.device
    keys = torch.empty_like(ids)
    perm = torch.empty(ids.shape, dtype=torch.int64, device=dev)
    scratch = torch.empty(_sort_scratch_bytes(ids.numel(), rows), dtype=torch.uint8, device=dev)
    status = _lib().bag_rows_sort(
        ids.data_ptr(), int(ids.dtype == torch.int64), ids.numel(), rows, keys.data_ptr(),
        perm.data_ptr(), scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        dev.index)
    _build.check(status, "bag_rows_sort launch")
    return keys, perm, scratch


def launch_writer(grad, keys, perm, weights, bags: BagMap, scratch, out) -> torch.Tensor:
    """Write ``out (rows, k)`` f32 whole, every element once, from
    ``launch_sort``'s ``(keys, perm, scratch)`` of the flat ids; ``grad (B,
    n_bags, k)`` and ``weights (B, n_slots)``.  One launch; it leaves the
    scratch's counters as the sort left them, so it may run again on the
    same sort (the timing does)."""
    B, n_slots = weights.shape
    rows, k = out.shape
    dev = grad.device
    status = _lib().embedding_bag_backward(
        grad.data_ptr(), bags.n_bags, k, keys.data_ptr(), int(keys.dtype == torch.int64),
        perm.data_ptr(), weights.data_ptr(), bags.segments.data_ptr(), n_slots, B * n_slots,
        rows, scratch.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        dev.index)
    _build.check(status, "embedding_bag_backward launch")
    return out


def launch_backward(grad, ids, weights, bags: BagMap, rows: int, out=None) -> torch.Tensor:
    """``d_table (rows, k)`` f32 for ``grad (B, n_bags, k)`` and 2-D
    ``ids``/``weights`` (B, n_slots), B >= 1: each named row's sum of
    ``grad[b, seg[s]] * w[b, s]`` over its slots in ascending flat order,
    zeros elsewhere.  ``d_table`` is ``out`` where given (contiguous f32),
    else allocated empty first (so a block the caller freed just before, of
    its size, is the one it gets), then the slots are sorted by row
    (``launch_sort``) and the writer fills it (``launch_writer``)."""
    d_table = out if out is not None else torch.empty(
        (rows, grad.shape[-1]), dtype=torch.float32, device=grad.device)
    keys, perm, scratch = launch_sort(ids.reshape(-1), rows)
    return launch_writer(grad, keys, perm, weights, bags, scratch, d_table)

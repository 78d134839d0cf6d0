"""Launcher for the embedding-bag CUDA kernel (``csrc/embedding_bag.cu``).

Counterpart of ``repro.kernels.embedding_bag``:

    out[b, bag, :] = sum_{s: seg[s] = bag} w[b, s] * table[ids[b, s], :]

for arena-global ``ids (B, n_slots)`` (int32 or int64), ``weights
(B, n_slots)`` and a static slot -> bag map ``seg``, the table, weights and
bags all float32 or all bfloat16 (each product and add rounded to the
type); and its backward in the table, ``launch_backward``, float32, a
fixed-order sum per row (no atomics).
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
    lib.embedding_bag_backward.argtypes = [_P, _I, _I, _P, _I, _P, _P, _P, _I, _L, _L, _P, _P,
                                           _I]
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


def launch_backward(grad, ids, weights, bags: BagMap, rows: int) -> torch.Tensor:
    """``d_table (rows, k)`` f32 for ``grad (B, n_bags, k)`` and 2-D
    ``ids``/``weights`` (B, n_slots): zeros, then each named row's sum of
    ``grad[b, seg[s]] * w[b, s]`` over its slots in ascending flat order.
    The stable sort of the slots by row is set-up for the kernel."""
    B, n_slots = ids.shape
    k = grad.shape[-1]
    dev = grad.device
    d_table = torch.zeros((rows, k), dtype=torch.float32, device=dev)
    sorted_rows, perm = torch.sort(ids.reshape(-1), stable=True)   # keys keep ids' type
    status = _lib().embedding_bag_backward(
        grad.data_ptr(), bags.n_bags, k, sorted_rows.data_ptr(),
        int(sorted_rows.dtype == torch.int64), perm.data_ptr(), weights.data_ptr(),
        bags.segments.data_ptr(), n_slots, B * n_slots, rows, d_table.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    _build.check(status, "embedding_bag_backward launch")
    return d_table

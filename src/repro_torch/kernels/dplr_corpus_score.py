"""Launchers for the corpus-scoring CUDA kernels (``csrc/dplr_corpus_score.cu``).

Counterpart of ``repro.kernels.dplr_corpus_score``: masked corpus-cached
DPLR-FwFM scores of a query batch against the item slab,

    s[q, i] = (a_C[q] + a_I[i]) + 0.5 * sum_r e_r ||P_C[q, r] + Q_I[i, r]||^2

with dead slots pinned to exactly ``NEG_INF``, either as the full
``(Bq, n)`` matrix or reduced to a top-K per query (ties to the lowest
slot).  The kernel's design is described at the top of the ``.cu`` file.

These functions take CUDA tensors that ``repro_torch.kernels.ops`` has
already checked, launch on the current stream and allocate their outputs
and scratch with ``torch.empty``.  Callers go through ``ops``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# Mask fill for dead slots: the one definition, shared by the plain
# versions and the corpus slab so that every path returns the same value
# for a dead slot.
NEG_INF = -1e30
# Largest rho * k the kernels take (kMaxRK in csrc/common.cuh).
MAX_RK = 128
# Largest K of the top-K mode (kMaxTopK in csrc/dplr_corpus_score.cu).
MAX_TOPK = 4096

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("dplr_corpus_score")
    lib.dplr_corpus_score_full.argtypes = [_P] * 6 + [_L, _I, _I, _I, _P, _P, _I]
    lib.dplr_corpus_score_full.restype = _I
    lib.dplr_corpus_topk_scratch.argtypes = [_L, _I, _I]
    lib.dplr_corpus_topk_scratch.restype = _L
    lib.dplr_corpus_topk.argtypes = ([_P] * 6 + [_L, _I, _I, _I, _I, _L, _L]
                                     + [_P] * 6 + [_I])
    lib.dplr_corpus_topk.restype = _I
    return lib


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch_full(Q_I, a_I, e, P_C, a_C, valid) -> torch.Tensor:
    """``(Bq, n)`` f32 scores."""
    n, rho, k = Q_I.shape
    Bq = P_C.shape[0]
    dev = Q_I.device
    out = torch.empty((Bq, n), dtype=torch.float32, device=dev)
    status = _lib().dplr_corpus_score_full(
        _ptr(Q_I), _ptr(a_I), _ptr(valid), _ptr(e), _ptr(P_C), _ptr(a_C),
        n, Bq, rho, k, _ptr(out), _stream(dev), dev.index)
    _build.check(status, "dplr_corpus_score_full launch")
    return out


def launch_topk(Q_I, a_I, e, P_C, a_C, valid, K: int, index_offset: int,
                index_stride: int) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """``(Bq, K) f32 scores, (Bq, K) int32 ids`` best first, and the
    launches made, ``{"corpus_topk_chunks": 1, "topk_merge": m}``: the
    merge runs once per round of stage-1 lists, 0 times for one list."""
    n, rho, k = Q_I.shape
    Bq = P_C.shape[0]
    dev = Q_I.device
    lib = _lib()
    m = lib.dplr_corpus_topk_scratch(n, Bq, K)
    scratch_v = torch.empty(m, dtype=torch.float32, device=dev)
    scratch_i = torch.empty(m, dtype=torch.int32, device=dev)
    vals = torch.empty((Bq, K), dtype=torch.float32, device=dev)
    ids = torch.empty((Bq, K), dtype=torch.int32, device=dev)
    launched = (ctypes.c_int * 2)()
    status = lib.dplr_corpus_topk(
        _ptr(Q_I), _ptr(a_I), _ptr(valid), _ptr(e), _ptr(P_C), _ptr(a_C),
        n, Bq, rho, k, K, index_offset, index_stride,
        _ptr(scratch_v), _ptr(scratch_i), _ptr(vals), _ptr(ids),
        ctypes.addressof(launched), _stream(dev), dev.index)
    _build.check(status, "dplr_corpus_topk launch")
    return vals, ids, {"corpus_topk_chunks": launched[0], "topk_merge": launched[1]}

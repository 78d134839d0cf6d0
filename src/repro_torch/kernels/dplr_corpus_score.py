"""Launchers for the corpus-scoring CUDA kernels (``csrc/dplr_corpus_score.cu``).

Counterpart of ``repro.kernels.dplr_corpus_score``: masked corpus-cached
DPLR-FwFM scores of a query batch against the item slab,

    s[q, i] = (a_C[q] + a_I[i]) + 0.5 * sum_r e_r ||P_C[q, r] + Q_I[i, r]||^2

with dead slots pinned to exactly ``NEG_INF``, either as the full
``(Bq, n)`` matrix or reduced to a top-K per query (ties to the lowest
slot), and the top-K of S tenants' slabs in one launch, for any
``0 < K <= n``.  The slab (``Q_I`` and ``a_I``) is float32 or bfloat16,
read as stored; ``e``, ``P_C`` and ``a_C`` arrive in float32; ``acc``
picks the accumulation of the reference's ``acc_dtype``, and ``tile`` (a
``blocks.Tile``, resolved and clamped by ``ops``) the launch geometry.
The kernels' design is described at the top of the ``.cu`` file.

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
# Most segments of one multi-tenant launch (kMaxSegments there).
MAX_SEGMENTS = 64

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# The C entry points' codes: the slab's type, and the accumulation mode
# (the reference's acc_dtype names).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ACC_CODES = {"float32": 0, "bfloat16": 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("dplr_corpus_score")
    lib.dplr_corpus_geometry_defaults.argtypes = [_P]
    lib.dplr_corpus_geometry_defaults.restype = None
    lib.dplr_corpus_geometry_fits.argtypes = [_I] * 10
    lib.dplr_corpus_geometry_fits.restype = _I
    lib.dplr_corpus_score_full.argtypes = [_P] * 6 + [_L, _I, _I, _I, _I, _I, _I, _L, _P, _P,
                                                      _I]
    lib.dplr_corpus_score_full.restype = _I
    lib.dplr_corpus_topk_scratch.argtypes = [_L, _L, _I, _I]
    lib.dplr_corpus_topk_scratch.restype = _L
    lib.dplr_corpus_topk.argtypes = ([_P] * 6 + [_L] + [_I] * 10 + [_L, _L]
                                     + [_P] * 5 + [_I])
    lib.dplr_corpus_topk.restype = _I
    lib.dplr_corpus_multi_topk.argtypes = ([_I] + [_P] * 7 + [_I] * 10 + [_L, _L]
                                           + [_P] * 5 + [_I])
    lib.dplr_corpus_multi_topk.restype = _I
    return lib


def geometry_defaults() -> dict:
    """The kernels' default geometry and the launch parameters' limits, as
    the library states them (``blocks`` names the same numbers).  Builds
    the kernels: CUDA only."""
    out = (ctypes.c_longlong * 8)()
    _lib().dplr_corpus_geometry_defaults(ctypes.addressof(out))
    keys = ("full_block_n", "full_threads", "chunk", "threads", "max_group", "part",
            "max_chunk", "max_threads")
    return dict(zip(keys, map(int, out)))


def geometry_fits(tile, topk: bool, rho: int, k: int, dtype: torch.dtype, K: int,
                  device: torch.device) -> bool:
    """Whether ``tile`` (a ``blocks.Tile``) fits ``device``'s opt-in shared
    memory a block: the full mode's, or stage 1's and the merge's for K.
    Raises on a geometry the kernels refuse."""
    got = _lib().dplr_corpus_geometry_fits(int(topk), tile.group, tile.threads, tile.block_n,
                                           tile.part, rho, k, DTYPE_CODES[dtype], K or 1,
                                           torch.device(device).index or 0)
    if got < 0:
        raise ValueError(f"{tile}: the kernels refuse this geometry (CUDA error {-got})")
    return bool(got)


@functools.lru_cache(maxsize=256)
def _scratch_words(n: int, rows: int, K: int, chunk: int) -> int:
    return _lib().dplr_corpus_topk_scratch(n, rows, K, chunk)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch_full(Q_I, a_I, e, P_C, a_C, valid, acc: str, tile) -> torch.Tensor:
    """``(Bq, n)`` f32 scores; ``tile.group`` queries a block at once, and
    ``tile.block_n`` consecutive slots (the run) a block claims at a time
    (one wave of persistent blocks)."""
    n, rho, k = Q_I.shape
    Bq = P_C.shape[0]
    dev = Q_I.device
    out = torch.empty((Bq, n), dtype=torch.float32, device=dev)
    status = _lib().dplr_corpus_score_full(
        _ptr(Q_I), _ptr(a_I), _ptr(valid), _ptr(e), _ptr(P_C), _ptr(a_C),
        n, Bq, rho, k, DTYPE_CODES[Q_I.dtype], ACC_CODES[acc], tile.group, tile.block_n,
        _ptr(out), _stream(dev), dev.index)
    _build.check(status, "dplr_corpus_score_full launch")
    return out


def _topk_launches(stage1: str, merge: str, launched) -> dict:
    return {stage1: launched[0], merge: launched[1], "topk_sort_tiles": launched[2],
            "topk_sort_merge": launched[3]}


def launch_topk(Q_I, a_I, e, P_C, a_C, valid, K: int, index_offset: int,
                index_stride: int, acc: str, tile) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """``(Bq, K) f32 scores, (Bq, K) int32 ids`` best first, and the
    launches made: ``corpus_topk_chunks`` and ``topk_merge`` once each,
    and for K > 4096 ``topk_sort_tiles`` once and ``topk_sort_merge``
    once per round of runs (none up to 16,384).  ``tile``: the query group,
    stage 1's threads, its chunk (``block_n``) and the merge's part."""
    n, rho, k = Q_I.shape
    Bq = P_C.shape[0]
    dev = Q_I.device
    lib = _lib()
    scratch = torch.empty(_scratch_words(n, Bq, K, tile.block_n), dtype=torch.int32, device=dev)
    vals = torch.empty((Bq, K), dtype=torch.float32, device=dev)
    ids = torch.empty((Bq, K), dtype=torch.int32, device=dev)
    launched = (ctypes.c_int * 4)()
    status = lib.dplr_corpus_topk(
        _ptr(Q_I), _ptr(a_I), _ptr(valid), _ptr(e), _ptr(P_C), _ptr(a_C),
        n, Bq, rho, k, DTYPE_CODES[Q_I.dtype], ACC_CODES[acc], tile.group, tile.threads,
        tile.block_n, tile.part, K, index_offset, index_stride, _ptr(scratch), _ptr(vals),
        _ptr(ids),
        ctypes.addressof(launched), _stream(dev), dev.index)
    _build.check(status, "dplr_corpus_topk launch")
    return vals, ids, _topk_launches("corpus_topk_chunks", "topk_merge", launched)


def launch_multi_topk(Q_parts, a_parts, valid_parts, e, P_C, a_C, K: int,
                      index_offset: int, index_stride: int, acc: str, tile
                      ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """``(S, Bq, K) f32 scores, (S, Bq, K) int32 segment-local ids`` best
    first, and the launches made: ``corpus_multi_topk_chunks`` and
    ``multi_topk_merge`` once each, and for K > 4096 the sort kernels as
    in ``launch_topk``, whose ``tile`` this is.  The segments' slabs, all of
    one type, are passed by pointer (a table in the launch's parameters),
    never copied."""
    S = len(Q_parts)
    _, rho, k = Q_parts[0].shape
    Bq = P_C.shape[1]
    dev = P_C.device
    lib = _lib()
    ptrs = lambda ts: (ctypes.c_void_p * S)(*[_ptr(t) for t in ts])  # noqa: E731
    n = (ctypes.c_longlong * S)(*[q.shape[0] for q in Q_parts])
    scratch = torch.empty(_scratch_words(max(n), S * Bq, K, tile.block_n), dtype=torch.int32,
                          device=dev)
    vals = torch.empty((S, Bq, K), dtype=torch.float32, device=dev)
    ids = torch.empty((S, Bq, K), dtype=torch.int32, device=dev)
    launched = (ctypes.c_int * 4)()
    status = lib.dplr_corpus_multi_topk(
        S, ptrs(Q_parts), ptrs(a_parts), ptrs(valid_parts), n,
        _ptr(e), _ptr(P_C), _ptr(a_C), Bq, rho, k, DTYPE_CODES[Q_parts[0].dtype],
        ACC_CODES[acc], tile.group, tile.threads, tile.block_n, tile.part, K, index_offset,
        index_stride, _ptr(scratch), _ptr(vals), _ptr(ids),
        ctypes.addressof(launched), _stream(dev), dev.index)
    _build.check(status, "dplr_corpus_multi_topk launch")
    return vals, ids, _topk_launches("corpus_multi_topk_chunks", "multi_topk_merge", launched)

"""Launcher for the full-FwFM pairwise CUDA kernel (``csrc/fwfm_interaction.cu``).

Counterpart of ``repro.kernels.fwfm_interaction``: per example,

    out[b] = 0.5 * sum_ij <v_i, v_j> R_ij

for ``V (B, m, k)`` float32 or bfloat16 (read as stored, upcast to f32 in
the kernel) and ``R (m, m)`` float32; ``out`` float32.  The O(m^2 k) term whose
removal is the paper's contribution: the full-FwFM and pruned-FwFM
baselines score through it.  Takes CUDA tensors that
``repro_torch.kernels.ops`` has already checked; callers go through ``ops``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# The kernel's limits (kMaxM, kMaxK in the .cu file).  The weights
# W_ij = R_ij + R_ji (i <= j) take m * round8(m) * 4 bytes of shared memory
# (64 KB at m = 128), and a tile's 64 column quads hold at least one
# example up to k = 32; the full dplr-fwfm config has m = 82, k = 16.  The
# plain version has no limit.
MAX_M = 128
MAX_K = 32

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# The C entry point's codes for V's type (repro::kF32, repro::kBF16).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("fwfm_interaction")
    lib.fwfm_pairwise.argtypes = [_P, _I, _P, _L, _I, _I, _P, _P, _I]
    lib.fwfm_pairwise.restype = _I
    lib.fwfm_pairwise_tile.argtypes = [_I, _I, _I]
    lib.fwfm_pairwise_tile.restype = _I
    return lib


def tile(m: int, k: int, dtype: torch.dtype = torch.float32) -> int:
    """Examples a tile of the kernel holds at (m, k) for a V of ``dtype``, as
    its launch cuts them (0 where it refuses the shape).  Builds the kernel:
    CUDA only."""
    return _lib().fwfm_pairwise_tile(m, k, DTYPE_CODES[dtype])


def check_limits(m: int, k: int) -> None:
    """Raise unless the kernel takes ``m`` fields of width ``k``."""
    if m > MAX_M or k > MAX_K:
        raise ValueError(f"m = {m}, k = {k}: the kernel takes m <= {MAX_M} and k <= {MAX_K}")


def launch(V, R) -> torch.Tensor:
    """``(B,)`` f32; ``V`` float32 or bfloat16, ``R`` float32."""
    B, m, k = V.shape
    dev = V.device
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    status = _lib().fwfm_pairwise(V.data_ptr(), DTYPE_CODES[V.dtype], R.data_ptr(), B, m, k,
                                  out.data_ptr(),
                                  torch.cuda.current_stream(dev).cuda_stream, dev.index)
    _build.check(status, "fwfm_pairwise launch")
    return out

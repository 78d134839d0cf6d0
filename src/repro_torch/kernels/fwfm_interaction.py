"""Launcher for the full-FwFM pairwise CUDA kernel (``csrc/fwfm_interaction.cu``).

Counterpart of ``repro.kernels.fwfm_interaction``: per example,

    out[b] = 0.5 * sum_ij <v_i, v_j> R_ij

for ``V (B, m, k)`` and ``R (m, m)``, f32.  The O(m^2 k) term whose
removal is the paper's contribution: the full-FwFM and pruned-FwFM
baselines score through it.  Takes CUDA tensors that
``repro_torch.kernels.ops`` has already checked; callers go through ``ops``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# The kernel's limits (kMaxM, kMaxK in the .cu file).  R takes
# m * (m | 1) * 4 bytes of shared memory (66 KB at m = 128); the full
# dplr-fwfm config has m = 82, k = 16.  The plain version has no limit.
MAX_M = 128
MAX_K = 32

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("fwfm_interaction")
    lib.fwfm_pairwise.argtypes = [_P, _P, _L, _I, _I, _P, _P, _I]
    lib.fwfm_pairwise.restype = _I
    return lib


def check_limits(m: int, k: int) -> None:
    """Raise unless the kernel takes ``m`` fields of width ``k``."""
    if m > MAX_M or k > MAX_K:
        raise ValueError(f"m = {m}, k = {k}: the kernel takes m <= {MAX_M} and k <= {MAX_K}")


def launch(V, R) -> torch.Tensor:
    """``(B,)`` f32."""
    B, m, k = V.shape
    dev = V.device
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    status = _lib().fwfm_pairwise(V.data_ptr(), R.data_ptr(), B, m, k, out.data_ptr(),
                                  torch.cuda.current_stream(dev).cuda_stream, dev.index)
    _build.check(status, "fwfm_pairwise launch")
    return out

"""Launcher for Algorithm 1's item-scoring CUDA kernel (``csrc/dplr_score.cu``).

Counterpart of ``repro.kernels.dplr_score``, batched over queries:

    P[q, i]   = P_C[q] + U_I V_I[q, i]
    out[q, i] = 0.5 * (s_C[q] + sum_m d_m ||v_m||^2 + sum_r e_r ||P_r||^2)

for ``V_I (Bq, n, m_I, k)``, ``P_C (Bq, rho, k)``, ``s_C (Bq,)``, in one
launch.  Takes CUDA tensors that ``repro_torch.kernels.ops`` has already
checked; callers go through ``ops``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("dplr_score")
    lib.dplr_score_items.argtypes = [_P] * 6 + [_L, _I, _I, _I, _I, _P, _P, _I]
    lib.dplr_score_items.restype = _I
    return lib


def launch(V_I, U_I, e, d_I, P_C, s_C) -> torch.Tensor:
    """``(Bq, n)`` f32 scores."""
    Bq, n, mI, k = V_I.shape
    rho = U_I.shape[0]
    dev = V_I.device
    out = torch.empty((Bq, n), dtype=torch.float32, device=dev)
    status = _lib().dplr_score_items(
        V_I.data_ptr(), U_I.data_ptr(), e.data_ptr(), d_I.data_ptr(),
        P_C.data_ptr(), s_C.data_ptr(), n, Bq, mI, rho, k, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    _build.check(status, "dplr_score_items launch")
    return out

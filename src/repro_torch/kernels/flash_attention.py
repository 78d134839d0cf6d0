"""Launcher for the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

Counterpart of ``repro.kernels.flash_attention``: causal GQA with an
optional sliding window, as a streaming softmax,

    out[b, i, h] = softmax_j(<q[b, i, h], k[b, j, h // G]> / sqrt(hd)) v[b, j, h // G]

over ``j <= i`` (and ``j > i - window``), for ``q (B, Sq, H, hd)`` and
``k, v (B, S, KV, hd)``, ``G = H // KV``, query row r at position ``i =
q_offset + r`` (``q_offset + Sq <= S``).  Takes CUDA tensors that
``repro_torch.kernels.ops`` has already checked; callers go through
``ops``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build

# What the kernel takes (the checks in the .cu file): at most 64 query heads
# per kv head; bf16 with hd in BF16_HD (one instantiation each), f32 with
# hd % 4 == 0 and hd <= 256; any S.
MAX_GROUP = 64
BF16_HD = (16, 32, 64, 128, 256)
MAX_HD_F32 = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# bf16 at these head widths runs the Hopper kernel (TMA, wgmma, a producer
# warpgroup); every other case runs the mma.sync / CUDA-core one.
WGMMA_HD = (64, 128, 256)


def kernel_name(dtype, hd: int) -> str:
    """The ``__global__`` a launch at this type and head width runs."""
    if dtype == torch.bfloat16 and hd in WGMMA_HD:
        return "flash_attention_wgmma"
    return "flash_attention_kernel"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("flash_attention")
    lib.flash_attention.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P,
                                    _I]
    lib.flash_attention.restype = _I
    return lib


def check_limits(dtype, H: int, KV: int, hd: int) -> None:
    """Raise unless the kernel takes this type, grouping and head width."""
    if dtype not in DTYPES:
        raise TypeError(f"dtype {dtype}: the kernel takes float32 or bfloat16")
    if H // KV > MAX_GROUP:
        raise ValueError(f"{H // KV} query heads per kv head: the kernel takes <= {MAX_GROUP}")
    ok = hd in BF16_HD if dtype == torch.bfloat16 else (hd % 4 == 0 and hd <= MAX_HD_F32)
    if not ok:
        raise ValueError(f"head_dim {hd}: the kernel takes {BF16_HD} in bfloat16, "
                         f"a multiple of 4 up to {MAX_HD_F32} in float32")


def launch(q, k, v, window: int | None, q_offset: int = 0) -> torch.Tensor:
    """``(B, Sq, H, hd)`` in q's dtype."""
    B, Sq, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    dev = q.device
    out = torch.empty_like(q)
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    status = _lib().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, S, q_offset, H, KV, hd,
        0 if window is None else int(window), scale, DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    _build.check(status, "flash_attention launch")
    return out

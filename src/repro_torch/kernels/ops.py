"""The kernel entry points: input checks, device dispatch, launch counts.

One scoring path per device.  For tensors on the CPU each entry point
runs its plain PyTorch version (``kernels.ref``); for CUDA tensors it
launches the hand-written CUDA kernel, or raises (wrong dtype, layout or
shape, a failed build or launch).  There is no fallback from the kernel
to the plain version.  Any other device raises.

``LAUNCHES`` counts launches of each CUDA kernel (``__global__``
function) by its name, and only those: a run reads it to show that its
path went through the kernels.  ``KERNELS`` names the CUDA kernels behind
each entry point; a top-K call launches stage 1 once and the merge once
per round, so its launches are not its calls.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import dplr_corpus_score as _corpus
from repro_torch.kernels import dplr_score as _dplr
from repro_torch.kernels import ref

KERNELS = {
    "dplr_corpus_score": ("corpus_score_full",),
    "dplr_corpus_topk": ("corpus_topk_chunks", "topk_merge"),
    "dplr_score_items": ("dplr_score_items_kernel",),
}
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def _device(**tensors) -> torch.device:
    devices = {t.device for t in tensors.values() if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev


def _check_shape(name: str, t, shape: tuple) -> None:
    if t is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def _check_for_kernel(**tensors) -> None:
    """The CUDA kernels take f32 (``valid``: bool) contiguous tensors."""
    for name, t in tensors.items():
        if t is None:
            continue
        want = torch.bool if name == "valid" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes a contiguous tensor")


def dplr_corpus_score(Q_I, a_I, e, P_C, a_C, valid=None, *, topk: int | None = None,
                      index_offset: int = 0, index_stride: int = 1):
    """Masked corpus-cached scores: ``(Bq, n)``, or with ``topk=K`` the
    ``((Bq, K) scores, (Bq, K) int32 ids)`` best first, ties to the lowest
    slot, local slot ``i`` labeled ``index_offset + index_stride * i``.

    ``Q_I (n, rho, k)``, ``a_I (n,)``, ``e (rho,)``, ``P_C (Bq, rho, k)``,
    ``a_C (Bq,)``, ``valid (n,)`` bool or None (all live)."""
    if Q_I.ndim != 3:
        raise ValueError(f"Q_I must be (n, rho, k), got {tuple(Q_I.shape)}")
    n, rho, k = Q_I.shape
    Bq = P_C.shape[0]
    _check_shape("a_I", a_I, (n,))
    _check_shape("e", e, (rho,))
    _check_shape("P_C", P_C, (Bq, rho, k))
    _check_shape("a_C", a_C, (Bq,))
    _check_shape("valid", valid, (n,))
    if rho * k > _corpus.MAX_RK:
        raise ValueError(f"rho * k = {rho * k} > {_corpus.MAX_RK}, the kernel's limit")
    if topk is not None and not 0 < topk <= min(n, _corpus.MAX_TOPK):
        raise ValueError(f"topk={topk} out of range for n={n} "
                         f"(the kernel takes K <= {_corpus.MAX_TOPK})")
    dev = _device(Q_I=Q_I, a_I=a_I, e=e, P_C=P_C, a_C=a_C, valid=valid)
    if dev.type == "cpu":
        if topk is None:
            return ref.dplr_corpus_score_ref(Q_I, a_I, e, P_C, a_C, valid)
        return ref.dplr_corpus_topk_ref(Q_I, a_I, e, P_C, a_C, topk, valid,
                                         index_offset, index_stride)
    _check_for_kernel(Q_I=Q_I, a_I=a_I, e=e, P_C=P_C, a_C=a_C, valid=valid)
    if topk is None:
        out = _corpus.launch_full(Q_I, a_I, e, P_C, a_C, valid)
        LAUNCHES["corpus_score_full"] += 1
        return out
    vals, ids, launched = _corpus.launch_topk(Q_I, a_I, e, P_C, a_C, valid, topk,
                                              int(index_offset), int(index_stride))
    LAUNCHES.update(launched)
    return vals, ids


def dplr_score_items(V_I, U_I, e, d_I, P_C, s_C):
    """Algorithm 1's item scores.  Per query: ``V_I (n, m_I, k)``,
    ``P_C (rho, k)``, ``s_C ()`` -> ``(n,)``; batched: ``V_I (Bq, n, m_I, k)``,
    ``P_C (Bq, rho, k)``, ``s_C (Bq,)`` -> ``(Bq, n)`` in one launch."""
    batched = V_I.ndim == 4
    if not batched:
        if V_I.ndim != 3:
            raise ValueError(f"V_I must be (n, m_I, k) or (Bq, n, m_I, k), "
                             f"got {tuple(V_I.shape)}")
        V_I, P_C, s_C = V_I[None], P_C[None], s_C.reshape(1)
    Bq, n, mI, k = V_I.shape
    rho = U_I.shape[0]
    _check_shape("U_I", U_I, (rho, mI))
    _check_shape("e", e, (rho,))
    _check_shape("d_I", d_I, (mI,))
    _check_shape("P_C", P_C, (Bq, rho, k))
    _check_shape("s_C", s_C, (Bq,))
    if rho * k > _corpus.MAX_RK:
        raise ValueError(f"rho * k = {rho * k} > {_corpus.MAX_RK}, the kernel's limit")
    dev = _device(V_I=V_I, U_I=U_I, e=e, d_I=d_I, P_C=P_C, s_C=s_C)
    if dev.type == "cpu":
        out = ref.dplr_score_items_ref(V_I, U_I, e, d_I, P_C, s_C)
    else:
        _check_for_kernel(V_I=V_I, U_I=U_I, e=e, d_I=d_I, P_C=P_C, s_C=s_C)
        out = _dplr.launch(V_I, U_I, e, d_I, P_C, s_C)
        LAUNCHES["dplr_score_items_kernel"] += 1
    return out if batched else out[0]

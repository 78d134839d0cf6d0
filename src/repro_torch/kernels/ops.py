"""The kernel entry points: input checks, device dispatch, launch counts.

One scoring path per device.  For tensors on the CPU each entry point
runs its plain PyTorch version (``kernels.ref``); for CUDA tensors it
launches the hand-written CUDA kernel, or raises (wrong dtype, layout or
shape, a failed build or launch).  There is no fallback from the kernel
to the plain version.  Any other device raises.

``LAUNCHES`` counts launches of each CUDA kernel (``__global__``
function) by its name, and only those: a run reads it to show that its
path went through the kernels.  ``KERNELS`` names the CUDA kernels behind
each entry point; a top-K call launches stage 1 and the merge once each,
and for K > 4096 the two sort kernels (listed under
``dplr_corpus_topk``, which the multi-tenant entry shares), so its
launches are not its calls.
"""
from __future__ import annotations

import collections
import math

import torch

from repro_torch.kernels import dplr_corpus_score as _corpus
from repro_torch.kernels import dplr_score as _dplr
from repro_torch.kernels import embedding_bag as _bag
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fwfm_interaction as _fwfm
from repro_torch.kernels import ref

KERNELS = {
    "dplr_corpus_score": ("corpus_score_full",),
    "dplr_corpus_topk": ("corpus_topk_chunks", "topk_merge", "topk_sort_tiles",
                         "topk_sort_merge"),
    "dplr_score_items": ("dplr_score_items_kernel",),
    "dplr_corpus_score_multi": ("corpus_multi_topk_chunks", "multi_topk_merge"),
    "embedding_bag": ("embedding_bag_kernel",),
    "fwfm_pairwise": ("fwfm_pairwise_kernel",),
    "flash_attention": ("flash_attention_kernel", "flash_attention_wgmma"),
}
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def _device(*tensors) -> torch.device:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev


def _check_shape(name: str, t, shape: tuple, index: int | None = None) -> None:
    """``index``: the tensor's place in a list of them, named in the error
    (formatted only then: the multi-tenant path checks 3 a segment a call)."""
    if t is not None and tuple(t.shape) != tuple(shape):
        if index is not None:
            name = f"{name}[{index}]"
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def _check_for_kernel(index: int | None = None, **tensors) -> None:
    """The CUDA kernels take f32 (``valid``: bool) contiguous tensors;
    ``index`` as in ``_check_shape``."""
    for name, t in tensors.items():
        if t is None:
            continue
        want = torch.bool if name.startswith("valid") else torch.float32
        if t.dtype != want or not t.is_contiguous():
            if index is not None:
                name = f"{name}{index}"
            if t.dtype != want:
                raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {want}")
            raise ValueError(f"{name}: the kernel takes a contiguous tensor")


def _check_corpus_limits(rk: int) -> None:
    """Kernels 1-4's own limit, checked for CUDA tensors only: the plain
    versions take any rho * k.  Both take any 0 < K <= n."""
    if rk > _corpus.MAX_RK:
        raise ValueError(f"rho * k = {rk} > {_corpus.MAX_RK}, the kernel's limit")


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
    if topk is not None and not 0 < topk <= n:
        raise ValueError(f"topk={topk} out of range for n={n}")
    dev = _device(Q_I, a_I, e, P_C, a_C, valid)
    if dev.type == "cpu":
        if topk is None:
            return ref.dplr_corpus_score_ref(Q_I, a_I, e, P_C, a_C, valid)
        return ref.dplr_corpus_topk_ref(Q_I, a_I, e, P_C, a_C, topk, valid,
                                         index_offset, index_stride)
    _check_corpus_limits(rho * k)
    _check_for_kernel(Q_I=Q_I, a_I=a_I, e=e, P_C=P_C, a_C=a_C, valid=valid)
    if topk is None:
        out = _corpus.launch_full(Q_I, a_I, e, P_C, a_C, valid)
        LAUNCHES["corpus_score_full"] += 1
        return out
    vals, ids, launched = _corpus.launch_topk(Q_I, a_I, e, P_C, a_C, valid, topk,
                                              int(index_offset), int(index_stride))
    LAUNCHES.update(launched)
    return vals, ids


def dplr_corpus_score_multi(Q_parts, a_parts, valid_parts, e, P_C, a_C, *, topk: int,
                            index_offset: int = 0, index_stride: int = 1):
    """S tenants' masked top-K in one call: ``((S, Bq, K) scores, (S, Bq, K)
    int32 ids)``, row ``[s]`` equal to ``dplr_corpus_score(..., topk=K)``
    on segment ``s`` alone (its slab, ``e[s]``, ``P_C[s]``, ``a_C[s]``);
    ids are segment-local slots labeled ``index_offset + index_stride * i``.

    ``Q_parts``: S tensors ``(n_s, rho, k)``; ``a_parts``: S ``(n_s,)``;
    ``valid_parts``: S ``(n_s,)`` bool (or None entries), or None (all
    live); ``e (S, rho)``, ``P_C (S, Bq, rho, k)``, ``a_C (S, Bq)``.
    Segments may differ in length; K is bounded by the smallest."""
    S = len(Q_parts)
    if S == 0:
        raise ValueError("dplr_corpus_score_multi needs >= 1 segment")
    if valid_parts is None:
        valid_parts = (None,) * S
    if not (len(a_parts) == S == len(valid_parts) and P_C.shape[0] == S
            and a_C.shape[0] == S and e.shape[0] == S):
        raise ValueError(f"segment-count mismatch: {S} Q_parts vs {len(a_parts)} "
                         f"a_parts, {len(valid_parts)} valid_parts, e {tuple(e.shape)}, "
                         f"P_C {tuple(P_C.shape)}, a_C {tuple(a_C.shape)}")
    if Q_parts[0].ndim != 3:
        raise ValueError(f"Q_parts[0] must be (n, rho, k), got {tuple(Q_parts[0].shape)}")
    _, rho, k = Q_parts[0].shape
    Bq = P_C.shape[1]
    for s in range(S):
        n_s = Q_parts[s].shape[0]
        _check_shape("Q_parts", Q_parts[s], (n_s, rho, k), s)
        _check_shape("a_parts", a_parts[s], (n_s,), s)
        _check_shape("valid_parts", valid_parts[s], (n_s,), s)
    _check_shape("e", e, (S, rho))
    _check_shape("P_C", P_C, (S, Bq, rho, k))
    _check_shape("a_C", a_C, (S, Bq))
    n_min = min(q.shape[0] for q in Q_parts)
    if not 0 < topk <= n_min:
        raise ValueError(f"topk={topk} out of range for smallest segment n={n_min}")
    dev = _device(e, P_C, a_C, *Q_parts, *a_parts, *valid_parts)
    if dev.type == "cpu":
        return ref.dplr_corpus_multi_topk_ref(Q_parts, a_parts, valid_parts, e, P_C, a_C,
                                              topk, index_offset, index_stride)
    if S > _corpus.MAX_SEGMENTS:
        raise ValueError(f"{S} segments > {_corpus.MAX_SEGMENTS}, the kernel's limit")
    _check_corpus_limits(rho * k)
    _check_for_kernel(e=e, P_C=P_C, a_C=a_C)
    for s in range(S):
        _check_for_kernel(s, Q_I=Q_parts[s], a_I=a_parts[s], valid=valid_parts[s])
    vals, ids, launched = _corpus.launch_multi_topk(
        Q_parts, a_parts, valid_parts, e, P_C, a_C, topk, int(index_offset),
        int(index_stride))
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
    dev = _device(V_I, U_I, e, d_I, P_C, s_C)
    if dev.type == "cpu":
        out = ref.dplr_score_items_ref(V_I, U_I, e, d_I, P_C, s_C)
    else:
        _check_corpus_limits(rho * k)
        _check_for_kernel(V_I=V_I, U_I=U_I, e=e, d_I=d_I, P_C=P_C, s_C=s_C)
        out = _dplr.launch(V_I, U_I, e, d_I, P_C, s_C)
        LAUNCHES["dplr_score_items_kernel"] += 1
    return out if batched else out[0]


BagMap = _bag.BagMap
bag_map = _bag.bag_map


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def embedding_bag(table, ids, weights, bags: BagMap):
    """Weighted bags ``(..., n_bags, k)`` in the table's dtype:
    ``out[..., b, :] = sum_{s: seg[s] = b} w[..., s] * table[ids[..., s]]``.

    ``table (rows, k)``; ``ids (..., n_slots)`` arena-global rows, int32 or
    int64 (the kernel reads either, so no copy changes their type);
    ``weights (..., n_slots)``; ``bags`` the static slot -> bag map on the
    table's device (``bag_map``, built once per map).  Leading dims flatten
    into one batch axis for the kernel.  An id outside ``[0, rows)``: the
    plain version raises, the kernel writes that bag as NaN (it never reads
    the row).  Differentiable in ``table`` and ``weights`` on both devices;
    on the card the backward is ``ref.embedding_bag_vjp``."""
    if table.ndim != 2:
        raise ValueError(f"table must be (rows, k), got {tuple(table.shape)}")
    if ids.ndim < 1 or tuple(weights.shape) != tuple(ids.shape):
        raise ValueError(f"ids {tuple(ids.shape)} and weights {tuple(weights.shape)} "
                         f"must be one (..., n_slots) shape")
    n_slots = ids.shape[-1]
    if bags.segments.shape != (n_slots,):
        raise ValueError(f"bags: {bags.segments.shape[0]} slots, ids have {n_slots}")
    dev = _device(table, ids, weights, bags.segments)
    if dev.type == "cpu":
        return ref.embedding_bag_ref(table, ids, weights, bags.segments, bags.n_bags)
    _check_for_kernel(table=table, weights=weights)
    if ids.dtype not in (torch.int32, torch.int64) or not ids.is_contiguous():
        raise TypeError(f"ids: the kernel takes contiguous int32 or int64, got {ids.dtype}")
    if _needs_grad(table, weights):
        return _EmbeddingBag.apply(table, ids, weights, bags)
    return _embedding_bag_launch(table, ids, weights, bags)


def _embedding_bag_launch(table, ids, weights, bags: BagMap):
    lead, n_slots = ids.shape[:-1], ids.shape[-1]
    B = math.prod(lead)
    if B == 0:
        return table.new_zeros((*lead, bags.n_bags, table.shape[1]))
    out = _bag.launch(table, ids.view(B, n_slots), weights.view(B, n_slots), bags)
    LAUNCHES["embedding_bag_kernel"] += 1
    return out.view(*lead, bags.n_bags, table.shape[1])


class _EmbeddingBag(torch.autograd.Function):
    """The kernel forward with the plain backward, for a table or weights
    that need a gradient on the card."""

    @staticmethod
    def forward(ctx, table, ids, weights, bags):
        ctx.save_for_backward(table, ids, weights, bags.segments)
        return _embedding_bag_launch(table, ids, weights, bags)

    @staticmethod
    def backward(ctx, grad):
        table, ids, weights, segments = ctx.saved_tensors
        d_table, d_weights = ref.embedding_bag_vjp(table, ids, weights, segments, grad)
        return (d_table if ctx.needs_input_grad[0] else None, None,
                d_weights if ctx.needs_input_grad[2] else None, None)


def fwfm_pairwise(V, R):
    """Full FwFM pairwise term ``(...,)``: ``0.5 * sum_ij <v_i, v_j> R_ij``
    for ``V (..., m, k)`` and ``R (m, m)``.  The kernel takes ``m <= 128``
    and ``k <= 32`` (a CUDA tensor beyond that raises); the plain version
    takes any.  Differentiable in ``V`` and ``R`` on both devices; on the
    card the backward is ``ref.fwfm_pairwise_vjp``."""
    if V.ndim < 2:
        raise ValueError(f"V must be (..., m, k), got {tuple(V.shape)}")
    m, k = V.shape[-2:]
    _check_shape("R", R, (m, m))
    dev = _device(V, R)
    if dev.type == "cpu":
        return ref.fwfm_pairwise_ref(V, R)
    _fwfm.check_limits(m, k)
    _check_for_kernel(V=V, R=R)
    if _needs_grad(V, R):
        return _FwFMPairwise.apply(V, R)
    return _fwfm_pairwise_launch(V, R)


def _fwfm_pairwise_launch(V, R):
    lead, (m, k) = V.shape[:-2], V.shape[-2:]
    B = math.prod(lead)
    if B == 0:
        return V.new_zeros(lead)
    out = _fwfm.launch(V.view(B, m, k), R)
    LAUNCHES["fwfm_pairwise_kernel"] += 1
    return out.view(lead)


class _FwFMPairwise(torch.autograd.Function):
    """The kernel forward with the plain backward, for ``V`` or ``R`` that
    need a gradient on the card."""

    @staticmethod
    def forward(ctx, V, R):
        ctx.save_for_backward(V, R)
        return _fwfm_pairwise_launch(V, R)

    @staticmethod
    def backward(ctx, grad):
        V, R = ctx.saved_tensors
        d_V, d_R = ref.fwfm_pairwise_vjp(V, R, grad)
        return (d_V if ctx.needs_input_grad[0] else None,
                d_R if ctx.needs_input_grad[1] else None)


def flash_attention(q, k, v, *, window: int | None = None):
    """Causal GQA, optionally within a sliding ``window``: ``(B, S, H, hd)``
    in q's dtype for ``q (B, S, H, hd)`` and ``k, v (B, S, KV, hd)``, query
    position i attending to keys j <= i (and j > i - window).  The kernel
    takes float32 or bfloat16 (one type for all three), ``H // KV <= 64``,
    and hd in (16, 32, 64, 128, 256) in bfloat16 or a multiple of 4 up to
    256 in float32; any S.  It has no backward: on the card, inputs that
    need a gradient raise (training is ROADMAP queue 7)."""
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q must be (B, S, H, hd) and k, v (B, S, KV, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    _check_shape("k", k, (B, S, KV, hd))
    _check_shape("v", v, (B, S, KV, hd))
    if KV == 0 or H % KV != 0:
        raise ValueError(f"{H} query heads do not group over {KV} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    dev = _device(q, k, v)
    if dev.type == "cpu":
        return ref.flash_attention_plain(q, k, v, window=window)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel "
                        f"takes one type")
    _flash.check_limits(q.dtype, H, KV, hd)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel takes a contiguous, 16-byte aligned tensor")
    if _needs_grad(q, k, v):
        raise NotImplementedError("flash_attention has no backward on the card "
                                  "(training is ROADMAP queue 7)")
    out = _flash.launch(q, k, v, window)
    LAUNCHES[_flash.kernel_name(q.dtype, hd)] += 1
    return out

"""The kernel entry points: input checks, device dispatch, launch counts.

One scoring path per device.  For tensors on the CPU each entry point
runs its plain PyTorch version (``kernels.ref``); for CUDA tensors it
launches the hand-written CUDA kernel, or raises (wrong dtype, layout or
shape, a failed build or launch).  There is no fallback from the kernel
to the plain version.  On ``meta`` tensors it makes the card's checks,
launches nothing and returns empty outputs of the kernel's shapes and
types, and reports the kernel's work by formula (``work.report``, to
the counter a running ``launch.cost.analyze`` holds), so that a count
does not depend on the plain version's route; it counts nothing in
``LAUNCHES``.  Any other device raises.

Types: kernels 1-4 take a float32 or bfloat16 slab (``Q_I`` and ``a_I``
of one type; kernel 3's ``V_I``), kernel 5 a float32 or bfloat16 table
(weights of the table's type) and kernel 6 a float32 or bfloat16 ``V``, as
the reference's kernels do.  The small operands that do not grow with n
(``e``, ``P_C``, ``a_C``; ``U_I``, ``d_I``, ``s_C``; kernel 6's ``R``) are
upcast to float32 before a launch; a slab, table or ``V`` is never cast: a
bf16 one launches the bf16 kernel.  Scores are float32 on
both devices.  The plain versions upcast bf16 on entry, so a bf16 call on
the CPU is the float32 call on the upcast tensors, as it is bitwise on the
card with ``acc_dtype='float32'``.  Other types raise.

Geometry: a corpus call (kernels 1, 2 and 4) that leaves ``block_n`` or
``acc_dtype`` ``None`` resolves it, and the rest of its launch geometry,
through the tuned-tile registry (``blocks.resolve_tile``: an argument
given wins, then the exact tuned cell, then the newest winner of the
shape family, the geometry only from a winner timed on launches like
this one), as the reference's ``ops`` resolves ``block_n`` and
``acc_dtype``.  With nothing registered every call
launches the kernels' default geometry with ``'float32'``.  On the CPU
the plain versions have no tiles: the geometry is validated and clamped
(so clamp events are the card's) but cannot change a result, and a
resolved ``acc_dtype`` applies.

``LAUNCHES`` counts launches of each CUDA kernel (``__global__``
function) by its name, and only those: a run reads it to show that its
path went through the kernels.  A kernel instantiated for a bf16 slab,
``V_I``, table or ``V`` counts under its name with ``_bf16`` appended, and one
that accumulates as ``acc_dtype='bfloat16'`` with ``_accbf16`` after that.
``KERNELS`` names the CUDA kernels behind each entry point, the bf16 ones
under the entry point's name with ``_bf16`` (the ``acc_dtype='bfloat16'``
ones, off the serving path, are in no entry); a top-K call launches stage
1 and the merge once each, and for K > 4096 the two sort kernels (listed
under ``dplr_corpus_topk``, which the multi-tenant entry shares; both
types share them), so its launches are not its calls.  The embedding
bag's backward launches the slots' radix sort (its own entry,
``bag_rows_sort``: a histogram kernel and one kernel for all passes) and
then the writer, once each a call.
"""
from __future__ import annotations

import collections
import functools
import math

import torch

from repro_torch.kernels import blocks
from repro_torch.kernels import dplr_corpus_score as _corpus
from repro_torch.kernels import dplr_score as _dplr
from repro_torch.kernels import embedding_bag as _bag
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fwfm_interaction as _fwfm
from repro_torch.kernels import ref
from repro_torch.kernels import work

KERNELS = {
    "dplr_corpus_score": ("corpus_score_full",),
    "dplr_corpus_topk": ("corpus_topk_chunks", "topk_merge", "topk_sort_tiles",
                         "topk_sort_merge"),
    "dplr_score_items": ("dplr_score_items_kernel",),
    "dplr_corpus_score_multi": ("corpus_multi_topk_chunks", "multi_topk_merge"),
    "embedding_bag": ("embedding_bag_kernel",),
    "embedding_bag_backward": ("bag_rows_radix_histogram", "bag_rows_radix_sort",
                               "embedding_bag_backward_kernel"),
    "bag_rows_sort": ("bag_rows_radix_histogram", "bag_rows_radix_sort"),
    "fwfm_pairwise": ("fwfm_pairwise_kernel",),
    "flash_attention": ("flash_attention_kernel", "flash_attention_wgmma"),
    "dplr_corpus_score_bf16": ("corpus_score_full_bf16",),
    "dplr_corpus_topk_bf16": ("corpus_topk_chunks_bf16", "topk_merge", "topk_sort_tiles",
                              "topk_sort_merge"),
    "dplr_score_items_bf16": ("dplr_score_items_kernel_bf16",),
    "dplr_corpus_score_multi_bf16": ("corpus_multi_topk_chunks_bf16", "multi_topk_merge"),
    "embedding_bag_bf16": ("embedding_bag_kernel_bf16",),
    "fwfm_pairwise_bf16": ("fwfm_pairwise_kernel_bf16",),
}
LAUNCHES: collections.Counter = collections.Counter()

# The types a slab, V_I or bag table may have on the card, and the
# reference's acc_dtype values.
SLAB_DTYPES = (torch.float32, torch.bfloat16)
ACC_DTYPES = blocks.ACC_DTYPES


def reset_launches() -> None:
    LAUNCHES.clear()


def _device(*tensors) -> torch.device:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel for device {dev}")
    return dev


def _check_shape(name: str, t, shape: tuple, index: int | None = None) -> None:
    """``index``: the tensor's place in a list of them, named in the error
    (formatted only then: the multi-tenant path checks 3 a segment a call)."""
    if t is not None and tuple(t.shape) != tuple(shape):
        if index is not None:
            name = f"{name}[{index}]"
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def _check_for_kernel(index: int | None = None, dtypes=(torch.float32,), **tensors) -> None:
    """The CUDA kernels take contiguous tensors of one of ``dtypes``
    (``valid``: bool); ``index`` as in ``_check_shape``."""
    for name, t in tensors.items():
        if t is None:
            continue
        want = (torch.bool,) if name.startswith("valid") else dtypes
        if t.dtype not in want or not t.is_contiguous():
            if index is not None:
                name = f"{name}{index}"
            if t.dtype not in want:
                raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes "
                                f"{' or '.join(map(str, want))}")
            raise ValueError(f"{name}: the kernel takes a contiguous tensor")


def _small_f32(**tensors) -> list:
    """The operands that do not grow with n, float32 or bfloat16, as the
    contiguous float32 the kernels read: no copy of a contiguous float32
    one."""
    for name, t in tensors.items():
        if t.dtype not in SLAB_DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes float32 or bfloat16")
    return [t.to(torch.float32).contiguous() for t in tensors.values()]


def launch_name(kernel: str, dtype: torch.dtype, acc_dtype: str = "float32") -> str:
    """The ``LAUNCHES`` name of ``kernel`` instantiated for a slab (V_I,
    table) of ``dtype`` accumulating as ``acc_dtype``."""
    return (kernel + ("_bf16" if dtype == torch.bfloat16 else "")
            + ("_accbf16" if acc_dtype == "bfloat16" else ""))


def _count(launched: dict, dtype: torch.dtype, acc_dtype: str) -> None:
    """Add a top-K call's launches: its stage 1 under the instantiation's
    name, the shared merge and sort kernels under their own."""
    for name, count in launched.items():
        if name.endswith("_chunks"):
            name = launch_name(name, dtype, acc_dtype)
        LAUNCHES[name] += count


def _check_corpus_limits(rk: int) -> None:
    """Kernels 1-4's own limit, checked for CUDA tensors only: the plain
    versions take any rho * k.  Both take any 0 < K <= n."""
    if rk > _corpus.MAX_RK:
        raise ValueError(f"rho * k = {rk} > {_corpus.MAX_RK}, the kernel's limit")


def _resolve_tile(n, rho, k, Bq, K, dtype, device, asked: blocks.Tile,
                  segments: int = 1) -> blocks.Tile:
    """The call's geometry (``blocks.resolve_tile``), keyed by the slab's
    type and the device type; on the card a registered geometry must fit
    the device's shared memory."""
    fits = None
    if device.type == "cuda":
        fits = lambda tile: _fits(tile, K, rho, k, dtype, device.index or 0)  # noqa: E731
    return blocks.resolve_tile(n, rho, k, Bq, K, blocks.dtype_name(dtype), device.type,
                               **asked._asdict(), segments=segments, fits=fits)


@functools.lru_cache(maxsize=1024)
def _fits(tile, K, rho, k, dtype, index) -> bool:
    return _corpus.geometry_fits(tile, K is not None, rho, k, dtype, K,
                                 torch.device("cuda", index))


def dplr_corpus_score(Q_I, a_I, e, P_C, a_C, valid=None, *, topk: int | None = None,
                      block_n: int | None = None, index_offset: int = 0,
                      index_stride: int = 1, acc_dtype: str | None = None):
    """Masked corpus-cached scores: ``(Bq, n)``, or with ``topk=K`` the
    ``((Bq, K) scores, (Bq, K) int32 ids)`` best first, ties to the lowest
    slot, local slot ``i`` labeled ``index_offset + index_stride * i``;
    scores float32.

    ``Q_I (n, rho, k)``, ``a_I (n,)``, ``e (rho,)``, ``P_C (Bq, rho, k)``,
    ``a_C (Bq,)``, ``valid (n,)`` bool or None (all live).  ``acc_dtype``:
    ``'float32'`` (the default when nothing is tuned) or ``'bfloat16'``
    (each square and e_r rounded to bf16, their products summed in f32, the
    sum rounded to bf16).  ``block_n``: the slots a block scores; it and
    ``acc_dtype``, each ``None``, resolve through the registry with the
    rest of the geometry (module docstring)."""
    return _corpus_score(Q_I, a_I, e, P_C, a_C, valid, topk, index_offset, index_stride,
                         blocks.Tile(block_n, acc_dtype))


def _corpus_score(Q_I, a_I, e, P_C, a_C, valid, topk, index_offset, index_stride,
                  asked: blocks.Tile):
    """``dplr_corpus_score`` at the geometry ``asked`` (a ``blocks.Tile``,
    each ``None`` field resolved): the autotuner's entry, which launches
    whole candidate geometries."""
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
    tile = _resolve_tile(n, rho, k, Bq, topk, Q_I.dtype, dev, asked)
    acc_dtype = tile.acc_dtype
    if dev.type == "cpu":
        if topk is None:
            return ref.dplr_corpus_score_ref(Q_I, a_I, e, P_C, a_C, valid, acc_dtype)
        return ref.dplr_corpus_topk_ref(Q_I, a_I, e, P_C, a_C, topk, valid,
                                         index_offset, index_stride, acc_dtype)
    _check_corpus_limits(rho * k)
    _check_for_kernel(dtypes=SLAB_DTYPES, Q_I=Q_I, valid=valid)
    _check_for_kernel(dtypes=(Q_I.dtype,), a_I=a_I)
    e, P_C, a_C = _small_f32(e=e, P_C=P_C, a_C=a_C)
    if dev.type == "meta":
        name = "dplr_corpus_score" if topk is None else "dplr_corpus_topk"
        work.report(launch_name(name, Q_I.dtype), n=n, live=n, Bq=Bq, K=topk, rho=rho, k=k,
                     itemsize=Q_I.element_size(), masked=valid is not None)
        if topk is None:
            return Q_I.new_empty((Bq, n), dtype=torch.float32)
        return (Q_I.new_empty((Bq, topk), dtype=torch.float32),
                Q_I.new_empty((Bq, topk), dtype=torch.int32))
    if topk is None:
        out = _corpus.launch_full(Q_I, a_I, e, P_C, a_C, valid, acc_dtype, tile)
        LAUNCHES[launch_name("corpus_score_full", Q_I.dtype, acc_dtype)] += 1
        return out
    vals, ids, launched = _corpus.launch_topk(Q_I, a_I, e, P_C, a_C, valid, topk,
                                              int(index_offset), int(index_stride), acc_dtype,
                                              tile)
    _count(launched, Q_I.dtype, acc_dtype)
    return vals, ids


def dplr_corpus_score_multi(Q_parts, a_parts, valid_parts, e, P_C, a_C, *, topk: int,
                            block_n: int | None = None, index_offset: int = 0,
                            index_stride: int = 1, acc_dtype: str | None = None):
    """S tenants' masked top-K in one call: ``((S, Bq, K) scores, (S, Bq, K)
    int32 ids)``, row ``[s]`` equal to ``dplr_corpus_score(..., topk=K)``
    on segment ``s`` alone (its slab, ``e[s]``, ``P_C[s]``, ``a_C[s]``);
    ids are segment-local slots labeled ``index_offset + index_stride * i``.

    ``Q_parts``: S tensors ``(n_s, rho, k)``; ``a_parts``: S ``(n_s,)``;
    ``valid_parts``: S ``(n_s,)`` bool (or None entries), or None (all
    live); ``e (S, rho)``, ``P_C (S, Bq, rho, k)``, ``a_C (S, Bq)``.
    Segments may differ in length; K is bounded by the smallest.  On the
    card every segment's slab is of one type (float32 or bfloat16);
    ``block_n`` and ``acc_dtype`` as in ``dplr_corpus_score``, resolved for
    the largest segment's cell with ``Bq = P_C.shape[1]`` (its tiles
    dominate the launch), as the reference resolves them; the geometry
    from a winner timed on as many segments (``blocks.launch_class``)."""
    return _corpus_score_multi(Q_parts, a_parts, valid_parts, e, P_C, a_C, topk, index_offset,
                               index_stride, blocks.Tile(block_n, acc_dtype))


def _corpus_score_multi(Q_parts, a_parts, valid_parts, e, P_C, a_C, topk, index_offset,
                        index_stride, asked: blocks.Tile):
    """``dplr_corpus_score_multi`` at the geometry ``asked``, as
    ``_corpus_score``."""
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
    n_max = max(q.shape[0] for q in Q_parts)
    tile = _resolve_tile(n_max, rho, k, Bq, topk, Q_parts[0].dtype, dev, asked, segments=S)
    acc_dtype = tile.acc_dtype
    if dev.type == "cpu":
        return ref.dplr_corpus_multi_topk_ref(Q_parts, a_parts, valid_parts, e, P_C, a_C,
                                              topk, index_offset, index_stride, acc_dtype)
    if S > _corpus.MAX_SEGMENTS:
        raise ValueError(f"{S} segments > {_corpus.MAX_SEGMENTS}, the kernel's limit")
    _check_corpus_limits(rho * k)
    slab = Q_parts[0].dtype
    _check_for_kernel(0, dtypes=SLAB_DTYPES, Q_I=Q_parts[0])
    for s in range(S):
        if Q_parts[s].dtype != slab or a_parts[s].dtype != slab:
            raise TypeError(f"segment {s}: Q_I {Q_parts[s].dtype}, a_I {a_parts[s].dtype}; "
                            f"one launch takes one slab type ({slab}), not mixed types")
        _check_for_kernel(s, dtypes=(slab,), Q_I=Q_parts[s], a_I=a_parts[s],
                          valid=valid_parts[s])
    e, P_C, a_C = _small_f32(e=e, P_C=P_C, a_C=a_C)
    if dev.type == "meta":
        for q, v in zip(Q_parts, valid_parts):
            n_s = q.shape[0]
            work.report(launch_name("dplr_corpus_score_multi", slab), n=n_s, live=n_s, Bq=Bq,
                         K=topk, rho=rho, k=k, itemsize=q.element_size(),
                         masked=v is not None)
        return (e.new_empty((S, Bq, topk)), e.new_empty((S, Bq, topk), dtype=torch.int32))
    vals, ids, launched = _corpus.launch_multi_topk(
        Q_parts, a_parts, valid_parts, e, P_C, a_C, topk, int(index_offset),
        int(index_stride), acc_dtype, tile)
    _count(launched, slab, acc_dtype)
    return vals, ids


def dplr_score_items(V_I, U_I, e, d_I, P_C, s_C):
    """Algorithm 1's item scores, float32.  Per query: ``V_I (n, m_I, k)``,
    ``P_C (rho, k)``, ``s_C ()`` -> ``(n,)``; batched: ``V_I (Bq, n, m_I, k)``,
    ``P_C (Bq, rho, k)``, ``s_C (Bq,)`` -> ``(Bq, n)`` in one launch.  On the
    card ``V_I`` is float32 or bfloat16, read as stored."""
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
        _check_for_kernel(dtypes=SLAB_DTYPES, V_I=V_I)
        U_I, e, d_I, P_C, s_C = _small_f32(U_I=U_I, e=e, d_I=d_I, P_C=P_C, s_C=s_C)
        if dev.type == "meta":
            work.report(launch_name("dplr_score_items", V_I.dtype), n=n, Bq=Bq, m_I=mI,
                         rho=rho, k=k, itemsize=V_I.element_size())
            out = P_C.new_empty((Bq, n))
        else:
            out = _dplr.launch(V_I, U_I, e, d_I, P_C, s_C)
            LAUNCHES[launch_name("dplr_score_items_kernel", V_I.dtype)] += 1
    return out if batched else out[0]


BagMap = _bag.BagMap
bag_map = _bag.bag_map


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def embedding_bag(table, ids, weights, bags: BagMap):
    """Weighted bags ``(..., n_bags, k)`` in the table's dtype:
    ``out[..., b, :] = sum_{s: seg[s] = b} w[..., s] * table[ids[..., s]]``,
    each product and add rounded to that type.  The kernel takes a float32
    or bfloat16 table with weights of its type; its backward, float32 only.

    ``table (rows, k)``; ``ids (..., n_slots)`` arena-global rows, int32 or
    int64 (the kernel reads either, so no copy changes their type);
    ``weights (..., n_slots)``; ``bags`` the static slot -> bag map on the
    table's device (``bag_map``, built once per map).  Leading dims flatten
    into one batch axis for the kernel.  An id outside ``[0, rows)``: the
    plain version raises, the kernel writes that bag as NaN (it never reads
    the row).  Differentiable in ``table`` and ``weights`` on both devices;
    on the card the table's gradient is ``embedding_bag_backward`` (a
    kernel that sums each row's terms in a fixed order, so a step's
    gradient is the same bits on every run) and the weights' is the plain
    gather-and-dot of ``ref.embedding_bag_vjp``."""
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
    _check_for_kernel(dtypes=SLAB_DTYPES, table=table)
    _check_for_kernel(dtypes=(table.dtype,), weights=weights)
    if ids.dtype not in (torch.int32, torch.int64) or not ids.is_contiguous():
        raise TypeError(f"ids: the kernel takes contiguous int32 or int64, got {ids.dtype}")
    if _needs_grad(table, weights):
        if table.dtype != torch.float32:
            raise TypeError(f"table: dtype {table.dtype} with a gradient; the backward "
                            f"kernel takes float32 (training is float32)")
        return _EmbeddingBag.apply(table, ids, weights, bags)
    return _embedding_bag_launch(table, ids, weights, bags)


def _embedding_bag_launch(table, ids, weights, bags: BagMap):
    lead, n_slots = ids.shape[:-1], ids.shape[-1]
    B = math.prod(lead)
    if B == 0:
        return table.new_zeros((*lead, bags.n_bags, table.shape[1]))
    if table.is_meta:
        work.report(launch_name("embedding_bag", table.dtype), slots=ids.numel(), B=B,
                     n_bags=bags.n_bags, k=table.shape[1], itemsize=table.element_size(),
                     id_size=ids.element_size())
        return table.new_empty((*lead, bags.n_bags, table.shape[1]))
    out = _bag.launch(table, ids.view(B, n_slots), weights.view(B, n_slots), bags)
    LAUNCHES[launch_name("embedding_bag_kernel", table.dtype)] += 1
    return out.view(*lead, bags.n_bags, table.shape[1])


def embedding_bag_backward(grad, table, ids, weights, bags: BagMap, out=None):
    """``d table`` of ``embedding_bag`` for the output gradient ``grad
    (..., n_bags, k)``: ``d_table[r] = sum_{slots s naming r} grad[bag(s)] *
    w_s``, zeros elsewhere, each row summed in ascending slot order (the
    plain version's order); a slot whose id lies outside ``[0, rows)`` adds
    to no row.  On the card the slots' radix sort by row, then one writer
    of the whole table; on the CPU ``ref.embedding_bag_vjp``.  ``out``: a
    contiguous float32 tensor of the table's shape on its device (a block
    of a larger gradient, say) that the writer fills, every element once,
    and that is returned; by default a new one."""
    n_slots = ids.shape[-1]
    _check_shape("grad", grad, (*ids.shape[:-1], bags.n_bags, table.shape[1]))
    dev = _device(grad, table, ids, weights, bags.segments, out)
    if out is not None:
        _check_shape("out", out, tuple(table.shape))
        _check_for_kernel(out=out)
    if dev.type == "cpu":
        d_table = ref.embedding_bag_vjp(table, ids, weights, bags.segments, grad)[0]
        return d_table if out is None else out.copy_(d_table)
    _check_for_kernel(grad=grad, weights=weights)
    B = math.prod(ids.shape[:-1])
    if B == 0:
        return torch.zeros_like(table) if out is None else out.zero_()
    if dev.type == "meta":
        work.report("embedding_bag_backward", slots=ids.numel(), B=B, n_bags=bags.n_bags,
                     k=table.shape[1], rows=table.shape[0], id_size=ids.element_size())
        return torch.empty_like(table) if out is None else out
    out = _bag.launch_backward(grad.view(B, bags.n_bags, table.shape[1]),
                               ids.view(B, n_slots), weights.view(B, n_slots), bags,
                               table.shape[0], out)
    for name in KERNELS["embedding_bag_backward"]:
        LAUNCHES[name] += 1
    return out


def bag_rows_sort(ids, rows: int):
    """``(keys, perm)``: the flat slot ids (int32 or int64) with those
    outside ``[0, rows)`` set to ``rows``, sorted stably, and their flat
    indices, bitwise ``torch.sort(keys, stable=True)``.  The backward's
    sort on its own.  On the card the radix sort (``rows < 2^31 - 1``,
    fewer than 2^31 slots); on the CPU ``ref.bag_rows_sort``."""
    dev = _device(ids)
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids: dtype {ids.dtype}, the sort takes int32 or int64")
    if dev.type == "cpu":
        return ref.bag_rows_sort(ids, rows)
    if not ids.is_contiguous():
        raise TypeError("ids: the kernel takes contiguous ids")
    flat = ids.view(-1)
    if flat.numel() == 0:
        return flat.clone(), torch.empty(0, dtype=torch.int64, device=dev)
    if dev.type == "meta":
        work.report("bag_rows_sort", slots=flat.numel(), id_size=ids.element_size())
        return torch.empty_like(flat), torch.empty(flat.shape, dtype=torch.int64, device=dev)
    keys, perm, _ = _bag.launch_sort(flat, rows)
    for name in KERNELS["bag_rows_sort"]:
        LAUNCHES[name] += 1
    return keys, perm


class _EmbeddingBag(torch.autograd.Function):
    """The kernel forward, and for the table the backward kernel, for a
    table or weights that need a gradient on the card."""

    @staticmethod
    def forward(ctx, table, ids, weights, bags):
        ctx.save_for_backward(table, ids, weights)
        ctx.bags = bags
        return _embedding_bag_launch(table, ids, weights, bags)

    @staticmethod
    def backward(ctx, grad):
        table, ids, weights = ctx.saved_tensors
        grad = grad.contiguous()
        d_table = d_weights = None
        if ctx.needs_input_grad[0]:
            d_table = embedding_bag_backward(grad, table, ids, weights, ctx.bags)
        if ctx.needs_input_grad[2]:
            # the plain gather-and-dot (on meta: shapes only, its work uncounted)
            d_weights = (torch.empty_like(weights) if weights.is_meta else
                         ref.embedding_bag_vjp(table, ids, weights, ctx.bags.segments,
                                               grad)[1])
        return d_table, None, d_weights, None


def fwfm_pairwise(V, R):
    """Full FwFM pairwise term ``(...,)`` float32: ``0.5 * sum_ij <v_i, v_j>
    R_ij`` for ``V (..., m, k)`` and ``R (m, m)``.  The kernel takes a
    float32 or bfloat16 ``V`` (read as stored and upcast in the kernel, so a
    bf16 launch is bitwise the float32 launch on the upcast ``V``; the
    plain version upcasts on entry), ``R`` upcast to float32 first,
    ``m <= 128`` and ``k <= 32`` (a CUDA tensor beyond that raises); the
    plain version takes any.  Differentiable in ``V`` and ``R`` on both
    devices; on the card the backward is ``ref.fwfm_pairwise_vjp`` in
    float32, ``d V`` cast to ``V``'s type."""
    if V.ndim < 2:
        raise ValueError(f"V must be (..., m, k), got {tuple(V.shape)}")
    m, k = V.shape[-2:]
    _check_shape("R", R, (m, m))
    dev = _device(V, R)
    if dev.type == "cpu":
        return ref.fwfm_pairwise_ref(V, R)
    _fwfm.check_limits(m, k)
    _check_for_kernel(dtypes=SLAB_DTYPES, V=V)
    (R,) = _small_f32(R=R)
    if _needs_grad(V, R):
        return _FwFMPairwise.apply(V, R)
    return _fwfm_pairwise_launch(V, R)


def _fwfm_pairwise_launch(V, R):
    lead, (m, k) = V.shape[:-2], V.shape[-2:]
    B = math.prod(lead)
    if B == 0:
        return V.new_zeros(lead, dtype=torch.float32)
    if V.is_meta:
        work.report(launch_name("fwfm_pairwise", V.dtype), B=B, m=m, k=k,
                     itemsize=V.element_size())
        return V.new_empty(lead, dtype=torch.float32)
    out = _fwfm.launch(V.view(B, m, k), R)
    LAUNCHES[launch_name("fwfm_pairwise_kernel", V.dtype)] += 1
    return out.view(lead)


class _FwFMPairwise(torch.autograd.Function):
    """The kernel forward with the plain backward in float32, for ``V`` or
    ``R`` that need a gradient on the card."""

    @staticmethod
    def forward(ctx, V, R):
        ctx.save_for_backward(V, R)
        return _fwfm_pairwise_launch(V, R)

    @staticmethod
    def backward(ctx, grad):
        V, R = ctx.saved_tensors
        d_V, d_R = ref.fwfm_pairwise_vjp(V.float(), R, grad.float())
        return (d_V.to(V.dtype) if ctx.needs_input_grad[0] else None,
                d_R if ctx.needs_input_grad[1] else None)


def flash_attention(q, k, v, *, window: int | None = None, q_offset: int = 0):
    """Causal GQA, optionally within a sliding ``window``: ``(B, Sq, H, hd)``
    in q's dtype for ``q (B, Sq, H, hd)`` and ``k, v (B, S, KV, hd)``, query
    row r at position i = ``q_offset`` + r attending to keys j <= i (and j >
    i - window); ``q_offset + Sq <= S`` (0 and Sq = S: a whole sequence;
    else a block of its query rows against its keys).  The kernel
    takes float32 or bfloat16 (one type for all three), ``H // KV <= 64``,
    and hd in (16, 32, 64, 128, 256) in bfloat16 or a multiple of 4 up to
    256 in float32; any S.  It has no backward: on the card, inputs that
    need a gradient raise.  The LM's loss attends through the plain
    ``attention.gqa_attention``, as the JAX loss does (ROADMAP: kernel 7's
    backward, a speed item)."""
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q must be (B, Sq, H, hd) and k, v (B, S, KV, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    B, Sq, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    _check_shape("k", k, (B, S, KV, hd))
    _check_shape("v", v, (B, S, KV, hd))
    if q_offset < 0 or q_offset + Sq > S:
        raise ValueError(f"query rows {q_offset} .. {q_offset + Sq} past the {S} keys' shape")
    if KV == 0 or H % KV != 0:
        raise ValueError(f"{H} query heads do not group over {KV} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    dev = _device(q, k, v)
    if dev.type == "cpu":
        return ref.flash_attention_plain(q, k, v, window=window, q_offset=q_offset)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel "
                        f"takes one type")
    _flash.check_limits(q.dtype, H, KV, hd)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel takes a contiguous, 16-byte aligned tensor")
    if _needs_grad(q, k, v):
        raise NotImplementedError("flash_attention has no backward on the card; "
                                  "model.lm_loss trains through the plain gqa_attention "
                                  "(ROADMAP: kernel 7's backward, a speed item)")
    if dev.type == "meta":
        work.report("flash_attention", B=B, S=S, H=H, KV=KV, hd=hd, window=window,
                    itemsize=q.element_size(), Sq=Sq, q_offset=q_offset)
        return torch.empty_like(q)
    out = _flash.launch(q, k, v, window, q_offset)
    LAUNCHES[_flash.kernel_name(q.dtype, hd)] += 1
    return out

"""Collectives of the one-process mesh: the port's counterparts of the
reference's ``lax.psum``, all-gather and reduce-scatter inside
``shard_map``, and the position that the work belongs to.

One process drives the mesh (``launch.mesh``), so a collective takes the
tensors of every position of a group at once, as a list in the group's
order (``Mesh.groups``), each on its position's device, and returns one
tensor a position, on that position's device.  Sums add in position
order, so a run repeats bitwise.  A group of one position moves nothing:
its collective returns the input and reports nothing (XLA drops such a
collective from the reference's program too).  The recsys family's data
axis runs ``all_reduce`` and ``broadcast``.  One function a kind: the LM
plan's collectives below are built on ``all_reduce``, ``all_gather`` and
``reduce_scatter`` (``need``: the slice a position reads, and its
conjugate), with ``copies``.

The LM family's per-position program (``models.transformer.parallel``)
runs its collectives inside a differentiated forward, so each of those is
a ``torch.autograd.Function`` whose backward is its conjugate and
reports itself too, so that a train cell's count holds the backward's
collectives: ``reduce_to_all`` (an all-reduce whose backward is the
identity: Megatron's g) and ``copy_to_all`` (the identity whose backward
is an all-reduce: Megatron's f), ``gather`` (an all-gather, or a gather
of the blocks a position reads, whose backward is a reduce-scatter) and
``all_to_all`` (whose backward is the all-to-all back).  Their outputs
are distinct tensors a position, so that positions sharing a card never
alias one another's copy.

Each collective reports its kind and the bytes of each position's output
(the reference's rule for its per-device HLO: output-operand bytes a
shard, keyed by kind, ``repro.launch.dryrun.collective_bytes``) to the
counter that ``launch.cost.analyze`` pushes on ``kernels.work.COUNTERS``.
Its own arithmetic is not counted as a position's work.

``at(position)`` names the mesh position whose work the operations
inside are (the mesh loops of ``embedding.sharded`` and ``launch.train``
set it), so that the counter attributes each operation to the device
that would run it; ``hold`` tells the counter which positions hold a
tensor that the one process keeps once (a gradient of the whole arena
whose blocks belong to the model positions, a sum that every position of
a group holds).  Both do nothing when no counter is active.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch

from repro_torch.kernels import work

__all__ = ["KINDS", "OFF", "all_gather", "all_reduce", "all_to_all", "at", "broadcast",
           "copy_to_all", "current", "gather", "hold", "mirror", "reduce_scatter",
           "reduce_to_all", "repeated", "report"]

# the reference's collective kinds (repro.launch.dryrun._COLLECTIVES)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# ``at(OFF)``: work of no position (a collective's own arithmetic, the
# one-process caller's join of the replicas' outputs)
OFF = "off"

_STATE = threading.local()


def current():
    """The position set by the innermost ``at``, else None."""
    return getattr(_STATE, "position", None)


@contextlib.contextmanager
def at(position):
    """Attribute the operations dispatched inside to ``position``."""
    prev = current()
    _STATE.position = position
    try:
        yield
    finally:
        _STATE.position = prev


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def report(kind: str, positions, nbytes: int) -> None:
    """``nbytes`` of a ``kind`` collective's output at each of ``positions``."""
    if kind not in KINDS:
        raise ValueError(f"unknown collective kind {kind!r}")
    for counter in work.COUNTERS[-1:]:
        for p in positions:
            counter.add_collective(kind, p, nbytes)


def hold(t: torch.Tensor, positions, split: bool = False) -> None:
    """``t``'s storage is held by ``positions``: each a copy, or with
    ``split`` each an equal block (added to the positions that hold it
    already)."""
    for counter in work.COUNTERS[-1:]:
        counter.hold(t, positions, split)


def mirror(mesh, positions=None) -> None:
    """Only ``positions`` of ``mesh`` run (default: the first data
    replica's), each other position's work the same as one of theirs: the
    active counter keeps those positions and counts the mesh's sums as
    ``mesh.size / len(positions)`` times theirs."""
    kept = tuple(mesh.positions()[:mesh.shape["model"]] if positions is None else positions)
    for counter in work.COUNTERS[-1:]:
        counter.set_mirror(kept, mesh.size // len(kept))


@contextlib.contextmanager
def repeated(times: int):
    """The work inside stands for ``times`` identical runs of it (the
    microbatches of an LM step on ``meta``): the active counter counts its
    operations, kernels and collectives ``times`` over; its storages once."""
    counters = work.COUNTERS[-1:]
    for counter in counters:
        counter.set_times(times)
    try:
        yield
    finally:
        for counter in counters:
            counter.set_times(1)


def _copies(outs: list, total: torch.Tensor, positions, copies: bool) -> list:
    """Tell the counter who holds ``outs``: with ``copies`` each its
    position's own tensor, else one storage ``total`` that every position
    reads."""
    if copies:
        for t, p in zip(outs, positions):
            hold(t, [p])
    else:
        hold(total, positions)
    return outs


def all_reduce(xs: list, positions, op: str = "sum", out=None, copies: bool = False) -> list:
    """The sum (``op="mean"``: the mean; ``"max"``: the elementwise
    maximum) of ``xs`` in position order, one copy a position on its
    input's device.  ``out``: a tensor of their shape on the first one's
    device that takes the result (it may be ``xs[0]``; the caller says who
    holds it), else a new one.  ``copies``: a distinct tensor a position,
    where ``.to(device)`` would hand positions that share a card one
    storage."""
    if len(xs) != len(positions):
        raise ValueError(f"{len(xs)} tensors for {len(positions)} positions")
    if op not in ("sum", "mean", "max"):
        raise ValueError(f"op {op!r}")
    if len(xs) == 1:
        return list(xs) if out is None else [out.copy_(xs[0])]
    with at(OFF):
        if op == "max":
            total = functools.reduce(torch.maximum, (x.to(xs[0].device) for x in xs))
        elif out is None:
            total = functools.reduce(torch.add, (x.to(xs[0].device) for x in xs))
        else:
            # in place, the same additions in the same order
            total = out.copy_(xs[0])
            for x in xs[1:]:
                total.add_(x.to(total.device))
        if op == "mean":
            total = total.div_(len(xs)) if out is not None else total / len(xs)
        outs = [total] + [total.to(x.device, copy=copies) for x in xs[1:]]
    report("all-reduce", positions, _nbytes(total))
    if out is None:
        _copies(outs, total, positions, copies)
    return outs


def _resized(shape, dim: int, n: int) -> list:
    out = list(shape)
    out[dim] = n
    return out


def all_gather(xs: list, positions, dim: int = 0, need=None, copies: bool = False) -> list:
    """The concatenation of ``xs`` along ``dim`` in position order, one copy
    a position; with ``need`` (a (start, stop) a position) the slice of it
    that each position reads.  ``copies``: as ``all_reduce``'s."""
    if len(xs) == 1 and need is None:
        return list(xs)
    with at(OFF):
        whole = torch.cat([x.to(xs[0].device) for x in xs], dim)
        want = [(0, whole.shape[dim])] * len(xs) if need is None else need
        outs = [whole.narrow(dim, lo, hi - lo).to(x.device, copy=copies)
                for (lo, hi), x in zip(want, xs)]
    for o, p in zip(outs, positions):
        report("all-gather", [p], _nbytes(o))
    return _copies(outs, whole, positions, copies)


def reduce_scatter(xs: list, positions, dim: int = 0, sizes=None, need=None,
                   copies: bool = False) -> list:
    """The sum of ``xs`` in position order, split along ``dim`` into one
    block a position (position ``i`` gets block ``i``; ``sizes``: the
    blocks' lengths, equal ones by default).  With ``need`` (``all_gather``'s:
    a (start, stop) a position) each of ``xs`` is the part of the whole
    at its range, None for nothing.  ``copies``: as ``all_reduce``'s."""
    n = len(xs)
    if n == 1 and need is None:
        return list(xs)
    like = next(x for x in xs if x is not None)
    length = sum(sizes) if sizes is not None else like.shape[dim]
    if sizes is None:
        if length % n:
            raise ValueError(f"dim {dim} of {length} does not split into {n} blocks")
        sizes = [length // n] * n
    with at(OFF):
        if need is None:
            total = functools.reduce(torch.add, (x.to(like.device) for x in xs if x is not None))
        else:
            total = like.new_zeros(_resized(like.shape, dim, length))
            for (lo, hi), x in zip(need, xs):
                if x is not None:
                    total.narrow(dim, lo, hi - lo).add_(x.to(total.device))
        outs = [b.to((x if x is not None else like).device, copy=copies)
                for b, x in zip(total.split(list(sizes), dim), xs)]
    for o, p in zip(outs, positions):
        report("reduce-scatter", [p], _nbytes(o))
    if copies:
        return _copies(outs, total, positions, True)
    hold(total, positions, split=True)
    return outs


def broadcast(x: torch.Tensor, positions, devices, src: int = 0) -> list:
    """``x``, held by ``positions[src]``, sent to every other position of
    the group (reported as ``collective-permute``, the sends a broadcast is
    made of, at each receiving position)."""
    if len(positions) == 1:
        return [x]
    with at(OFF):
        outs = [x.to(d) for d in devices]
    others = [p for i, p in enumerate(positions) if i != src]
    report("collective-permute", others, _nbytes(x))
    hold(x, others)
    return outs


# -- collectives inside a differentiated forward ----------------------------------

class _ReduceToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, positions, *xs):
        return tuple(all_reduce(list(xs), positions, copies=True))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *gs)


class _CopyToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, positions, *xs):
        ctx.positions = positions
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        if all(g is None for g in gs):
            return (None, *gs)
        like = next(g for g in gs if g is not None)
        gs = [torch.zeros_like(like) if g is None else g for g in gs]
        return (None, *all_reduce(gs, ctx.positions, copies=True))


def reduce_to_all(xs: list, positions) -> list:
    """The sum of ``xs`` in position order at every position (an
    all-reduce); its backward is the identity, each input taking its
    position's cotangent (Megatron's g: every position computes the same
    thing after it, so each cotangent is already the whole one)."""
    if len(xs) == 1:
        return list(xs)
    return list(_ReduceToAll.apply(tuple(positions), *xs))


def copy_to_all(xs: list, positions) -> list:
    """``xs`` as they are (every position's copy of one value), whose
    backward is an all-reduce of the cotangents (Megatron's f: each
    position's work after it sees part of the value's use)."""
    if len(xs) == 1:
        return list(xs)
    return list(_CopyToAll.apply(tuple(positions), *xs))


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, positions, dim, need, *xs):
        ctx.args = positions, dim, need, [x.shape[dim] for x in xs]
        return tuple(all_gather(list(xs), positions, dim, need, copies=True))

    @staticmethod
    def backward(ctx, *gs):
        positions, dim, need, sizes = ctx.args
        return (None, None, None, *reduce_scatter(list(gs), positions, dim, sizes, need,
                                                  copies=True))


def gather(xs: list, positions, dim: int = 0, need=None) -> list:
    """``all_gather`` of ``xs`` along ``dim`` (with ``need``: the slice of it
    that each position reads), a distinct tensor a position.  Its backward
    is the conjugate ``reduce_scatter``: each block's cotangent the sum, in
    position order, of the readers' cotangents of it."""
    if len(xs) == 1 and need is None:
        return list(xs)
    return list(_Gather.apply(tuple(positions), dim, None if need is None else tuple(need),
                              *xs))


def _exchange(xs, positions, split_dim: int, cat_dim: int, sizes) -> list:
    n = len(xs)
    with at(OFF):
        pieces = [x.split(list(sizes) if sizes else x.shape[split_dim] // n, split_dim)
                  for x in xs]
        outs = [torch.cat([pieces[j][i].to(xs[i].device) for j in range(n)], cat_dim)
                for i in range(n)]
    for o, p in zip(outs, positions):
        report("all-to-all", [p], _nbytes(o))
    return _copies(outs, None, positions, True)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, positions, split_dim, cat_dim, sizes, *xs):
        ctx.args = positions, cat_dim, split_dim, tuple(x.shape[cat_dim] for x in xs)
        return tuple(_exchange(xs, positions, split_dim, cat_dim, sizes))

    @staticmethod
    def backward(ctx, *gs):
        positions, split_dim, cat_dim, sizes = ctx.args
        return (None, None, None, None, *_exchange(gs, positions, split_dim, cat_dim, sizes))


def all_to_all(xs: list, positions, split_dim: int, cat_dim: int, sizes=None) -> list:
    """Position ``i`` gets piece ``i`` along ``split_dim`` of every
    position's tensor, concatenated along ``cat_dim`` in position order.
    ``sizes``: the pieces' lengths (default equal ones).  Its backward is
    the all-to-all back (the dims swapped)."""
    if len(xs) != len(positions):
        raise ValueError(f"{len(xs)} tensors for {len(positions)} positions")
    if sizes is None and xs[0].shape[split_dim] % len(xs):
        raise ValueError(f"dim {split_dim} of {xs[0].shape[split_dim]} does not split into "
                         f"{len(xs)} pieces")
    if len(xs) == 1:
        return list(xs)
    return list(_AllToAll.apply(tuple(positions), split_dim, cat_dim,
                                None if sizes is None else tuple(sizes), *xs))

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
axis runs ``all_reduce`` and ``broadcast``; ``all_gather`` and
``reduce_scatter`` are FSDP's pair (weights gathered before use,
gradients reduced to each position's block), for the LM family's data
axis (ROADMAP item 3c-ii).

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

__all__ = ["KINDS", "OFF", "all_gather", "all_reduce", "at", "broadcast", "current", "hold",
           "mirror", "reduce_scatter", "report"]

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


def mirror(mesh) -> None:
    """Only the first data replica of ``mesh`` runs, each other replica's
    work the same as its own: the active counter keeps the first
    replica's positions and counts the mesh's sums as ``mesh.dp`` times
    theirs."""
    for counter in work.COUNTERS[-1:]:
        counter.set_mirror(mesh)


def all_reduce(xs: list, positions, op: str = "sum", out=None) -> list:
    """The sum (``op="mean"``: the mean) of ``xs`` in position order, one
    copy a position on its input's device.  ``out``: a tensor of their
    shape on the first one's device that takes the result (it may be
    ``xs[0]``; the caller says who holds it), else a new one."""
    if len(xs) != len(positions):
        raise ValueError(f"{len(xs)} tensors for {len(positions)} positions")
    if op not in ("sum", "mean"):
        raise ValueError(f"op {op!r}")
    if len(xs) == 1:
        return list(xs) if out is None else [out.copy_(xs[0])]
    with at(OFF):
        if out is None:
            total = functools.reduce(torch.add, (x.to(xs[0].device) for x in xs))
        else:
            # in place, the same additions in the same order
            total = out.copy_(xs[0])
            for x in xs[1:]:
                total.add_(x.to(total.device))
        if op == "mean":
            total = total.div_(len(xs)) if out is not None else total / len(xs)
        outs = [total.to(x.device) for x in xs]
    report("all-reduce", positions, _nbytes(total))
    if out is None:
        hold(total, positions)
    return outs


def all_gather(xs: list, positions, dim: int = 0) -> list:
    """The concatenation of ``xs`` along ``dim`` in position order, one copy
    a position."""
    if len(xs) == 1:
        return list(xs)
    with at(OFF):
        whole = torch.cat([x.to(xs[0].device) for x in xs], dim)
        outs = [whole.to(x.device) for x in xs]
    report("all-gather", positions, _nbytes(whole))
    hold(whole, positions)
    return outs


def reduce_scatter(xs: list, positions, dim: int = 0) -> list:
    """The sum of ``xs`` in position order, split along ``dim`` into one
    equal block a position (position ``i`` gets block ``i``)."""
    n = len(xs)
    if n == 1:
        return list(xs)
    if xs[0].shape[dim] % n:
        raise ValueError(f"dim {dim} of {xs[0].shape[dim]} does not split into {n} blocks")
    with at(OFF):
        total = functools.reduce(torch.add, (x.to(xs[0].device) for x in xs))
        outs = [b.to(x.device) for b, x in zip(total.chunk(n, dim), xs)]
    report("reduce-scatter", positions, _nbytes(total) // n)
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

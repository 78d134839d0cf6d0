"""Model-parallel embedding lookup over a row-blocked arena.  Port of
``repro.embedding.sharded``.

The arena is split by rows over a mesh's ``model`` axis
(``sharding.rules.recsys_param_specs``: ``("model", None)``): the position
at model coordinate ``s`` owns rows ``[s R/D, (s+1) R/D)``, and every data
replica holds the same blocks.  One process drives the mesh
(``launch.mesh``), as the reference's ``shard_map`` is driven from one:
each position works on its own device, on a contiguous view of its rows
moved there (no copy where that is the arena's own device; four positions
on one H100 all share ``cuda:0``).  Each position runs the embedding-bag
kernel (``kops.embedding_bag``) over its block, every slot whose row
another position owns weighted 0, and the partials are all-reduced over
the model axis in position order (``sharding.collectives``): the
reference's ``psum``.  A row has one owner, so the other positions add
exact zeros.

The backward sends the bags' gradient from the first position (where
the dense work runs) to each block's position, and runs the bag's
backward kernel (``kops.embedding_bag_backward``) on each block, written
into that block's rows of one gradient of the whole arena, every element
once.  A foreign slot's id is keyed past the block there, so the kernel
drops it: clipped to local row 0 (as the forward clips it, so that the
kernel never writes a NaN bag), all foreign slots would be summed into
row 0, 3/4 of the slots on one row at D = 4.  Nor does a block's gradient
pass through autograd's slice of the arena, which would build a zero
gradient of the whole arena for every block.

The lookup runs on one data replica's model axis (``Mesh.replica``): a
mesh with data replicas, or a rule that splits the ids over an axis
past 1 (``spec_by_rank``, ``data_axes``: the reference's
``PartitionSpec``s), is refused.  The split over the data axes belongs
to the step (``launch.train.data_parallel_step``): each replica's rows
through its own replica's lookup, then the arena gradient's mean over
the data axes.
"""
from __future__ import annotations

import torch

from repro_torch.core.fields import FeatureLayout
from repro_torch.embedding.bag import _statics, one_slot_bags
from repro_torch.kernels import ops as kops
from repro_torch.sharding import collectives, rules


def block_rows(table: torch.Tensor, D: int) -> int:
    """Rows of each of the ``D`` blocks of ``table``."""
    if table.shape[0] % D:
        raise ValueError(f"an arena of {table.shape[0]} rows does not split into {D} blocks")
    return table.shape[0] // D


def _owned(ids: torch.Tensor, lo: int, rows: int):
    """(mine, local): which ``ids`` lie in ``[lo, lo + rows)``, and their
    local row there (0 for the others, so a gather stays in the block)."""
    mine = (ids >= lo) & (ids < lo + rows)
    return mine, torch.where(mine, ids - lo, 0)


def shard_rows(block, lin_block, lo: int, ids, w):
    """This shard's part of the lookups of arena-global ``ids (..., m)``
    (one slot a field): ``(w * row, w * b)`` for the slots whose row lies in
    ``[lo, lo + len(block))``, zero for the others.  The rows come from the
    embedding-bag kernel over the shard's block, foreign slots weighted
    zero; the first-order weights by index.  ``fwfm.rank_items_mp``'s
    per-shard lookup."""
    mine, local = _owned(ids, lo, block.shape[0])
    local = local.contiguous()
    w = w.to(block.dtype)
    V = kops.embedding_bag(block, local, torch.where(mine, w, 0).contiguous(),
                           one_slot_bags(ids.shape[-1], str(block.device)))
    lin = torch.where(mine, lin_block[local.long()], 0) * w
    return V, lin


def _check_one_replica(mesh, axes, what: str) -> None:
    for axis in axes:
        if axis is not None and mesh.shape.get(axis, 1) != 1:
            raise ValueError(f"{what} splits over {axis!r} ({mesh.shape[axis]} positions); "
                             f"the lookup runs on one data replica's model axis "
                             f"(Mesh.replica), the step splits the batch")


def _check_spec(mesh, spec, model_axis: str, what: str) -> None:
    """A rule for the ids (``sharding.rules``'s tuples) may name only axes of
    size 1: the lookup runs on one data replica, and the model axis splits
    rows."""
    for entry in spec:
        names = rules.entry_axes(entry)
        if model_axis in names:
            raise ValueError(f"{what}: the ids' batch dims cannot split over {model_axis!r}")
        _check_one_replica(mesh, names, what)


def _masked_bags(table, ids, weights, bags, mesh):
    """``sum_s`` of position s's kernel-5 bags over its block, foreign slots
    weighted 0: the partials all-reduced over the model axis in position
    order (``collectives.all_reduce``), the first position's copy."""
    D = len(mesh.devices)
    rows = block_rows(table, D)
    parts = []
    for s, dev in enumerate(mesh.devices):
        with collectives.at(mesh.coords(s)):
            lo = s * rows
            mine, local = _owned(ids.to(dev), lo, rows)
            w = torch.where(mine, weights.to(device=dev, dtype=table.dtype), 0)
            parts.append(kops.embedding_bag(table[lo:lo + rows].to(dev), local.contiguous(),
                                            w.contiguous(), bags(dev)))
    return collectives.all_reduce(parts, mesh.positions())[0]


def _block_grads(grad, table, ids, weights, bags, mesh):
    """The table's gradient: the bags' gradient sent from the first
    position to each block's (``collectives.broadcast``), then kernel 5' on
    each block, foreign slots keyed out, into that block's rows of one
    float32 gradient of the whole arena (each position holds its block)."""
    rows = block_rows(table, len(mesh.devices))
    group = mesh.positions()
    grads = collectives.broadcast(grad, group, mesh.devices)
    with collectives.at(collectives.OFF):
        d_table = torch.empty(table.shape, dtype=torch.float32, device=table.device)
    collectives.hold(d_table, group, split=True)
    for s, dev in enumerate(mesh.devices):
        with collectives.at(group[s]):
            lo = s * rows
            mine, local = _owned(ids.to(dev), lo, rows)
            keyed = torch.where(mine, local, rows).contiguous()   # a foreign slot: no row
            block = table[lo:lo + rows]
            out = d_table[lo:lo + rows]
            args = (grads[s].contiguous(), block.to(dev), keyed,
                    weights.to(device=dev, dtype=table.dtype).contiguous(), bags(dev))
            if block.device == torch.device(dev):
                kops.embedding_bag_backward(*args, out=out)
            else:
                out.copy_(kops.embedding_bag_backward(*args))
    return d_table


class _BlockedBags(torch.autograd.Function):
    """``_masked_bags`` with the table's gradient written block by block by
    kernel 5's backward, foreign slots keyed out of each block."""

    @staticmethod
    def forward(ctx, table, ids, weights, bags, mesh):
        ctx.save_for_backward(table, ids, weights)
        ctx.bags, ctx.mesh = bags, mesh
        return _masked_bags(table, ids, weights, bags, mesh)

    @staticmethod
    def backward(ctx, grad):
        table, ids, weights = ctx.saved_tensors
        return _block_grads(grad, table, ids, weights, ctx.bags, ctx.mesh), *(None,) * 4


def _blocked_bags(table, ids, weights, bags, mesh):
    """The sharded bags ``(..., n_bags, k)`` of arena-global ``ids (...,
    n_slots)`` on the mesh's first device; differentiable in ``table``
    only."""
    if weights.requires_grad and torch.is_grad_enabled():
        raise ValueError("the sharded lookup is differentiable in the table only")
    _check_one_replica(mesh, tuple(a for a in mesh.shape if a != "model"), "the mesh")
    if table.requires_grad and torch.is_grad_enabled():
        return _BlockedBags.apply(table, ids, weights, bags, mesh)
    return _masked_bags(table, ids, weights, bags, mesh)


def make_sharded_take(mesh, spec_by_rank: dict | None = None, model_axis: str = "model"):
    """``take_fn(table, ids) -> rows``: ``table[ids]`` for arena-global ``ids
    (...)`` on a table row-blocked over ``mesh``'s ``model_axis`` (rows
    divisible by its size, see ``padded_rows``), as ``(..., k)`` on the
    mesh's first device.  Each position gathers the rows it owns through
    kernel 5, one slot a bag, and the partials are summed: bitwise
    ``bag.gather_rows`` on the whole table.  ``mesh``: one data replica's
    model axis.  ``spec_by_rank`` maps ``ids.ndim`` to the ids' rule (how
    their batch dims split): it may name only axes of size 1.  The models'
    ``take_fn``."""
    if model_axis != "model":
        raise ValueError(f"the mesh places its devices on 'model', not {model_axis!r}")

    def take_fn(table, ids):
        if spec_by_rank is not None:
            _check_spec(mesh, spec_by_rank[ids.ndim], model_axis, "spec_by_rank")
        ones = torch.ones((*ids.shape, 1), dtype=table.dtype, device=ids.device)
        bags = lambda dev: one_slot_bags(1, str(torch.device(dev)))         # noqa: E731
        return _blocked_bags(table, ids[..., None], ones, bags, mesh)[..., 0, :]

    return take_fn


def sharded_lookup_field_embeddings(table: torch.Tensor, layout: FeatureLayout, ids, weights,
                                    *, mesh, model_axis: str = "model",
                                    data_axes: tuple = ("data",)) -> torch.Tensor:
    """``(batch..., n_fields, k)`` field embeddings of local ``ids (batch...,
    n_slots)``, ``bag.lookup_field_embeddings`` on a table row-blocked over
    ``mesh``: each position sums the weighted rows it owns into the field
    bags (kernel 5 over its block) and the partials are summed in position
    order (within rounding of the unsharded bags, which add all of a bag's
    slots in one order).  ``data_axes``: the axes the batch dims split
    over (the reference's ``P(data_axes)``), each of size 1 here."""
    if model_axis != "model":
        raise ValueError(f"the mesh places its devices on 'model', not {model_axis!r}")
    _check_one_replica(mesh, data_axes, "data_axes")
    offsets = _statics(layout, None, str(ids.device)).offsets
    bags = lambda dev: _statics(layout, None, str(torch.device(dev))).bags   # noqa: E731
    return _blocked_bags(table, ids + offsets, weights, bags, mesh)

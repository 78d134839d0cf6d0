"""Model-parallel embedding lookup over a row-blocked arena.  Port of
``repro.embedding.sharded``.

The arena is split by rows over a mesh's ``model`` axis
(``sharding.rules.recsys_param_specs``: ``("model", None)``): shard ``s``
owns rows ``[s R/D, (s+1) R/D)``.  One process drives the mesh
(``launch.mesh``), as the reference's ``shard_map`` is driven from one:
shard ``s`` works on ``mesh.devices[s]``, on a contiguous view of its rows
moved there (no copy where that is the arena's own device; four shards on
one H100 all share ``cuda:0``).  Each shard runs the embedding-bag kernel
(``kops.embedding_bag``) over its block, every slot whose row another shard
owns weighted 0, and the partials are summed on the mesh's first device in
shard order: the reference's ``psum`` over the model axis.  A row has one
owner, so the other shards add exact zeros.

The backward is the bag's backward kernel (``kops.embedding_bag_backward``)
on each block, written into that block's rows of one gradient of the whole
arena, every element once.  A foreign slot's id is keyed past the block
there, so the kernel drops it: clipped to local row 0 (as the forward
clips it, so that the kernel never writes a NaN bag), all foreign slots
would be summed into row 0, 3/4 of the slots on one row at D = 4.  Nor
does a shard's gradient pass through autograd's slice of the arena, which
would build a zero gradient of the whole arena for every shard.

The mesh has one data replica, so the batch dims are split over nothing:
``spec_by_rank`` and ``data_axes`` (the reference's ``PartitionSpec``s of
the ids over the data axes) are checked to name only axes of size 1.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.fields import FeatureLayout
from repro_torch.embedding.bag import _statics, one_slot_bags
from repro_torch.kernels import ops as kops


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
                             f"the one-process mesh has one data replica")


def _check_spec(mesh, spec, model_axis: str, what: str) -> None:
    """A rule for the ids (``sharding.rules``'s tuples) may name only axes of
    size 1: the mesh has one data replica, and the model axis splits rows."""
    for entry in spec:
        names = entry if isinstance(entry, tuple) else (entry,)
        if model_axis in names:
            raise ValueError(f"{what}: the ids' batch dims cannot split over {model_axis!r}")
        _check_one_replica(mesh, names, what)


def _masked_bags(table, ids, weights, bags, mesh):
    """``sum_s`` of shard s's kernel-5 bags over its block, foreign slots
    weighted 0, in shard order on ``mesh.devices[0]``."""
    D = len(mesh.devices)
    rows = block_rows(table, D)
    parts = []
    for s, dev in enumerate(mesh.devices):
        lo = s * rows
        mine, local = _owned(ids.to(dev), lo, rows)
        w = torch.where(mine, weights.to(device=dev, dtype=table.dtype), 0)
        parts.append(kops.embedding_bag(table[lo:lo + rows].to(dev), local.contiguous(),
                                        w.contiguous(), bags(dev)).to(mesh.devices[0]))
    return functools.reduce(torch.add, parts)


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
        mesh = ctx.mesh
        rows = block_rows(table, len(mesh.devices))
        d_table = torch.empty(table.shape, dtype=torch.float32, device=table.device)
        for s, dev in enumerate(mesh.devices):
            lo = s * rows
            mine, local = _owned(ids.to(dev), lo, rows)
            keyed = torch.where(mine, local, rows).contiguous()   # a foreign slot: no row
            block = table[lo:lo + rows]
            out = d_table[lo:lo + rows]
            args = (grad.to(dev).contiguous(), block.to(dev), keyed,
                    weights.to(device=dev, dtype=table.dtype).contiguous(), ctx.bags(dev))
            if block.device == torch.device(dev):
                kops.embedding_bag_backward(*args, out=out)
            else:
                out.copy_(kops.embedding_bag_backward(*args))
        return d_table, None, None, None, None


def _blocked_bags(table, ids, weights, bags, mesh):
    """The sharded bags ``(..., n_bags, k)`` of arena-global ``ids (...,
    n_slots)`` on ``mesh.devices[0]``; differentiable in ``table`` only."""
    if weights.requires_grad and torch.is_grad_enabled():
        raise ValueError("the sharded lookup is differentiable in the table only")
    if table.requires_grad and torch.is_grad_enabled():
        return _BlockedBags.apply(table, ids, weights, bags, mesh)
    return _masked_bags(table, ids, weights, bags, mesh)


def make_sharded_take(mesh, spec_by_rank: dict | None = None, model_axis: str = "model"):
    """``take_fn(table, ids) -> rows``: ``table[ids]`` for arena-global ``ids
    (...)`` on a table row-blocked over ``mesh``'s ``model_axis`` (rows
    divisible by its size, see ``padded_rows``), as ``(..., k)`` on the
    mesh's first device.  Each shard gathers the rows it owns through
    kernel 5, one slot a bag, and the partials are summed: bitwise
    ``bag.gather_rows`` on the whole table.  ``spec_by_rank`` maps
    ``ids.ndim`` to the ids' rule (how their batch dims are split): on the
    one-process mesh a rule may name only axes of size 1.  The models'
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
    ``mesh``: each shard sums the weighted rows it owns into the field bags
    (kernel 5 over its block) and the shards' bags are summed on the first
    device, in shard order (within rounding of the unsharded bags, which
    add all of a bag's slots in one order).  ``data_axes``: the axes the
    batch dims split over, each of size 1 here."""
    if model_axis != "model":
        raise ValueError(f"the mesh places its devices on 'model', not {model_axis!r}")
    _check_one_replica(mesh, data_axes, "data_axes")
    offsets = _statics(layout, None, str(ids.device)).offsets
    bags = lambda dev: _statics(layout, None, str(torch.device(dev))).bags   # noqa: E731
    return _blocked_bags(table, ids + offsets, weights, bags, mesh)

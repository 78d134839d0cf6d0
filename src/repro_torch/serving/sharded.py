"""The item-corpus slab sharded over a mesh's ``model`` axis.  Port of
``repro.serving.sharded``.

The single-device engine bounds the corpus by one device's memory.  Here
the capacity-padded slab is split over the D positions of the mesh's
``model`` axis (``sharding.rules.corpus_slab_axis``): each shard holds
capacity/D slots of every ``ItemCorpusCache`` leaf on its own device, so
the corpus grows with the mesh while a shard's memory and a query's work
on it stay O(capacity/D rho k).

Striped slots: global slot ``g`` is owned by shard ``g % D`` at local row
``g // D`` (``corpus.physical``).  Doubling the slab appends local rows to
every shard, and those are exactly the new global ids, so no live slot is
renumbered; the engine hands out the lowest free global id, as on one
device, so both engines assign the same slots and consecutive ids land on
consecutive shards.

The mesh is driven from one process (``launch.mesh``): each function
below loops over the shards, and shard ``s``'s work (its slice's row
build, its scatter, its kernel launch) runs on ``mesh.devices[s]``.
Several shards may share one card.  A shard's corpus kernel labels its
local row ``i`` as global slot ``s + D * i`` (``index_offset=s,
index_stride=D``), and only its ``(Bq, k_loc)`` candidates move to the
first device, ``k_loc = min(K, local capacity)``: O(D K), never O(n).

The merge (``merge_topk``) sorts the candidates by global slot, then takes
the top K with ties to the lowest position, so ties go to the lowest
global id, the single-device engine's rule: with the kernels' per-slot
scores independent of the slab they sit in, and ``corpus_rows``
independent of the batch, the sharded engine is bitwise the single-device
engine (ties included).  Any slot of the global top K is in its shard's
top ``k_loc`` (if ``k_loc < K`` the shard gave all its slots), and with
``K <= n_items`` the live candidates outrank the ``NEG_INF`` dead ones a
sparse shard contributes.

Entry points (``ScorerRuntime(mesh=...)`` calls them; callers do not):

    ShardedCorpusCache(shards)          shard s's ItemCorpusCache, local rows
    build(params, cfg, mesh, ids, w, valid)            -> ShardedCorpusCache
        ids/w: (capacity/D, D, m_I_slots) physical view; valid (capacity/D, D)
    group_deltas(slots, ids, w, D, local_cap)          -> (li, ids_g, w_g)
        host side: (dn,) global slots -> the (d_loc, D, ...) layout
    write_grouped(params, cfg, mesh, cache, ids_g, w_g, li) -> cache
    drop(mesh, cache, gidx)                             -> cache
    score(mesh, query, params, cache, ctx_ids, ctx_w)
        -> (Bq, capacity) float32 scores in global slot order
    topk(mesh, query, params, cache, ctx_ids, ctx_w, K)
        -> ((Bq, K) float32, (Bq, K) int32 global slots)
    multi_topk(mesh, query, params_parts, cache_parts, ctx_ids, ctx_w, K)
        -> ((S, Bq, K) float32, (S, Bq, K) int32 global slots)
    merge_topk(cand_vals, cand_idx, K)  (D, Bq, k_loc) candidates -> (Bq, K) x 2

``query(params, ctx_ids, ctx_w)`` is the runtime's query side, ``(P_C,
a_C)`` in float32 on the first device.  Writes and drops update each
shard's tensors in place, as the single-device runtime does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.serving.corpus import (
    ItemCorpusCache,
    build_corpus_cache,
    corpus_rows,
    item_addend,
    next_pow2,
)
from repro_torch.sharding import corpus_slab_axis


def shard_count(mesh) -> int:
    return int(mesh.shape[corpus_slab_axis()])


class ShardedCorpusCache(NamedTuple):
    """A slab sharded D ways: ``shards[s]`` holds global slots ``s, s + D,
    s + 2D, ...`` as its local rows ``0, 1, 2, ...``, on shard s's device."""

    shards: tuple

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def local_capacity(self) -> int:
        return self.shards[0].capacity

    @property
    def capacity(self) -> int:
        return self.local_capacity * self.n_shards

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def physical(self) -> ItemCorpusCache:
        """Every leaf in the ``(local, D, ...)`` physical view, gathered on
        shard 0's device (a copy; for checks)."""
        dev = self.shards[0].Q_I.device
        return ItemCorpusCache(*(torch.stack([leaf.to(dev) for leaf in leaves], dim=1)
                                 for leaves in zip(*self.shards)))


def params_on(params: dict, dev: torch.device) -> dict:
    """``params`` on shard device ``dev``: the dict itself where every
    tensor is there already (all shards on one card), else a copy, made
    at each call (a mesh of several cards copies the params to a shard's
    card for each build and churn write)."""
    if all(v.device == dev for v in params.values()):
        return params
    return {k: v.to(dev) for k, v in params.items()}


# ---------------------------------------------------------------------------
# Build (model refresh): every shard rebuilds its own rows
# ---------------------------------------------------------------------------

def build(params, cfg, mesh, ids_phys, w_phys, valid_phys) -> ShardedCorpusCache:
    """The sharded slab: shard s runs ``corpus_rows`` (kernel 5's lookups)
    over its column ``[:, s]`` of the physical view alone, so a shard's
    build is O(capacity/D m_I k).  Inputs: numpy arrays or tensors."""
    shards = []
    for s, dev in enumerate(mesh.devices):
        p = params_on(params, dev)
        ids = torch.as_tensor(ids_phys[:, s]).to(dev).contiguous()
        w = torch.as_tensor(w_phys[:, s]).to(device=dev, dtype=cfg.dtype).contiguous()
        valid = torch.as_tensor(valid_phys[:, s]).to(dev).contiguous()
        shards.append(build_corpus_cache(p, cfg, ids, w, valid=valid))
    return ShardedCorpusCache(tuple(shards))


# ---------------------------------------------------------------------------
# Churn: shard-grouped deltas, each shard computing and writing its own rows
# ---------------------------------------------------------------------------

def group_deltas(slots, ids, w, D: int, local_cap: int):
    """Host side: lay a (dn,) global-slot delta out per owning shard, as
    the ``(d_loc, D, ...)`` arrays the grouped write takes.

    ``li[j, s]`` is shard s's j-th local target row (filler: ``local_cap``,
    never written), ``ids_g``/``w_g`` the matching item rows (filler: zero
    ids, weight one).  ``d_loc`` is the power of two at or above the
    busiest shard's count.  Slot assignment is untouched: grouping only
    reorders the payload.  A copy of the reference's function."""
    slots = np.asarray(slots, np.int64)
    per = [np.flatnonzero(slots % D == s) for s in range(D)]
    d_loc = next_pow2(max(max((len(p) for p in per), default=0), 1))
    li = np.full((d_loc, D), local_cap, np.int32)
    ids_g = np.zeros((d_loc, D, ids.shape[1]), np.int32)
    w_g = np.ones((d_loc, D, w.shape[1]), np.float32)
    for s, rows in enumerate(per):
        m = len(rows)
        li[:m, s] = slots[rows] // D
        ids_g[:m, s] = ids[rows]
        w_g[:m, s] = w[rows]
    return li, ids_g, w_g


def write_grouped(params, cfg, mesh, cache: ShardedCorpusCache, ids_g, w_g, li):
    """Shard s computes ``corpus_rows`` over its ``(d_loc, m_I_slots)``
    column and writes its rows at their local targets, marking them live,
    in place; returns ``cache``.  A shard with no row in the delta does
    nothing.  ``li``, ``ids_g``, ``w_g``: host arrays from
    ``group_deltas``."""
    local_cap = cache.local_capacity
    for s, (c, dev) in enumerate(zip(cache.shards, mesh.devices)):
        m = int((li[:, s] < local_cap).sum())
        if m == 0:
            continue
        Q, t, lin = corpus_rows(
            params_on(params, dev), cfg,
            torch.as_tensor(ids_g[:, s], device=dev).contiguous(),
            torch.as_tensor(w_g[:, s], dtype=cfg.dtype, device=dev).contiguous())
        idx = torch.as_tensor(li[:m, s].astype(np.int64), device=dev)
        c.Q_I[idx] = Q[:m]
        c.t_I[idx] = t[:m]
        c.lin_I[idx] = lin[:m]
        c.a_I[idx] = item_addend(t, lin)[:m]
        c.valid[idx] = True
    return cache


def drop(mesh, cache: ShardedCorpusCache, gidx):
    """The (host) global slots ``gidx`` marked dead at their owning
    shards, in place; returns ``cache``."""
    D = shard_count(mesh)
    gidx = np.asarray(gidx, np.int64)
    for s, (c, dev) in enumerate(zip(cache.shards, mesh.devices)):
        mine = gidx[gidx % D == s] // D
        if mine.size:
            c.valid[torch.as_tensor(mine, device=dev)] = False
    return cache


# ---------------------------------------------------------------------------
# Scoring: each shard scores its slice; the full matrix in global order
# ---------------------------------------------------------------------------

def score(mesh, query, params, cache: ShardedCorpusCache, ctx_ids, ctx_w, *,
          block_n: int | None = None) -> torch.Tensor:
    """(Bq, capacity) float32 scores in global slot order, equal to the
    single-device engine's.  The query side (``query(params, ctx_ids,
    ctx_w)``) is computed once, on the first device; shard s launches
    kernel 1 on its slice, and its (Bq, local) scores come back to the
    first device (the full score is O(n) by definition)."""
    first = mesh.devices[0]
    P_C, a_C = query(params, ctx_ids, ctx_w)
    e = params["e"]
    parts = [kops.dplr_corpus_score(c.Q_I, c.a_I, e.to(dev), P_C.to(dev), a_C.to(dev),
                                    valid=c.valid, block_n=block_n).to(first)
             for c, dev in zip(cache.shards, mesh.devices)]
    out = torch.stack(parts, dim=2)             # (Bq, local, D)
    # the physical (local, D) order flattens to l * D + s, the global slot
    return out.reshape(out.shape[0], -1)


# ---------------------------------------------------------------------------
# Top-K: each shard's top k_loc, then one merge of D k_loc candidates
# ---------------------------------------------------------------------------

def merge_topk(cand_vals: torch.Tensor, cand_idx: torch.Tensor, K: int):
    """``(D, Bq, k_loc)`` per-shard candidates -> the global ``((Bq, K)
    values, (Bq, K) int32 ids)``.  The candidates are sorted by global slot
    first, so the stable top K sends ties to the lowest global id, the
    single-device rule (``lax.top_k`` on the reference's unsharded slab)."""
    Bq = cand_vals.shape[1]
    cv = cand_vals.transpose(0, 1).reshape(Bq, -1)
    ci = cand_idx.transpose(0, 1).reshape(Bq, -1)
    order = torch.sort(ci, dim=1, stable=True).indices
    cv, ci = cv.gather(1, order), ci.gather(1, order)
    vals, pos = ref.topk_stable(cv, K)
    return vals, ci.gather(1, pos)


def _gathered(parts, first):
    """Each shard's (vals, ids) moved to the first device and stacked on a
    new leading shard axis."""
    vals, ids = zip(*parts)
    return (torch.stack([v.to(first) for v in vals]), torch.stack([i.to(first) for i in ids]))


def topk(mesh, query, params, cache: ShardedCorpusCache, ctx_ids, ctx_w, K: int, *,
         block_n: int | None = None):
    """((Bq, K) float32, (Bq, K) int32 global slots), bitwise the
    single-device engine's ``topk``.  Shard s launches kernel 2 on its
    slice with ``index_offset=s, index_stride=D``, so its candidates carry
    global ids."""
    D = shard_count(mesh)
    k_loc = min(K, cache.local_capacity)
    P_C, a_C = query(params, ctx_ids, ctx_w)
    e = params["e"]
    parts = [kops.dplr_corpus_score(c.Q_I, c.a_I, e.to(dev), P_C.to(dev), a_C.to(dev),
                                    valid=c.valid, topk=k_loc, block_n=block_n,
                                    index_offset=s, index_stride=D)
             for s, (c, dev) in enumerate(zip(cache.shards, mesh.devices))]
    return merge_topk(*_gathered(parts, mesh.devices[0]), K)


def _merge_multi(cv: torch.Tensor, ci: torch.Tensor, K: int):
    """``(D, S, Bq, k_loc)`` candidates -> ``(S, Bq, K)``: ``merge_topk``
    per segment (the rows of all segments merged at once; each row sees
    only its own segment's candidates)."""
    D, S, Bq, k_loc = cv.shape
    vals, ids = merge_topk(cv.reshape(D, S * Bq, k_loc), ci.reshape(D, S * Bq, k_loc), K)
    return vals.reshape(S, Bq, K), ids.reshape(S, Bq, K)


def multi_topk(mesh, query, params_parts, cache_parts, ctx_ids, ctx_w, K: int, *,
               block_n: int | None = None):
    """((S, Bq, K) float32, (S, Bq, K) int32 global slots): S tenants'
    micro-batches on the mesh, shard s launching kernel 4 once over the S
    tenants' slices, then one merge per segment; row [s] bitwise ``topk``
    on tenant s alone.  The segments must share one local capacity (the
    frontend's pack key holds it), so that one ``k_loc`` suffices for
    every segment."""
    D = shard_count(mesh)
    caps = {c.local_capacity for c in cache_parts}
    if len(caps) != 1:
        raise ValueError(f"fused mesh top-K needs equal local capacities, got "
                         f"{sorted(caps)}")
    k_loc = min(K, caps.pop())
    pcs, acs = zip(*(query(p, ctx_ids[s], ctx_w[s]) for s, p in enumerate(params_parts)))
    P_C, a_C = torch.stack(pcs), torch.stack(acs)
    e = torch.stack([p["e"] for p in params_parts])
    parts = []
    for s, dev in enumerate(mesh.devices):
        cs = [c.shards[s] for c in cache_parts]
        parts.append(kops.dplr_corpus_score_multi(
            tuple(c.Q_I for c in cs), tuple(c.a_I for c in cs), tuple(c.valid for c in cs),
            e.to(dev), P_C.to(dev), a_C.to(dev), topk=k_loc, block_n=block_n,
            index_offset=s, index_stride=D))
    return _merge_multi(*_gathered(parts, mesh.devices[0]), K)

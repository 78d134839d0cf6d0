"""ScorerRuntime: the corpus-independent half of the serving engine.
Port of ``repro.serving.runtime``.

The runtime owns everything about scoring that does not depend on which
corpus is scored: the context cache, the dispatch to the corpus kernel,
and the row computation and scatter of churn writes.  Shapes:

    score(params, cache, ctx_ids, ctx_w)      -> (Bq, capacity) f32
    topk(params, cache, ctx_ids, ctx_w, K)    -> ((Bq, K) f32, (Bq, K) int32)
    multi_topk(params_parts, cache_parts, ctx_ids, ctx_w, K)
                                              -> ((S, Bq, K) f32, (S, Bq, K) int32)
    build(params, slab_ids, slab_w, valid)    -> ItemCorpusCache
    write_rows(params, cache, slots, ids, w)  -> ItemCorpusCache
    drop_rows(cache, slots)                   -> ItemCorpusCache

One runtime may serve many tenants (``CorpusState(..., runtime=rt)``):
it holds no corpus.  Scoring goes through ``kernels.ops``
(``dplr_corpus_score``, and ``dplr_corpus_score_multi`` for S tenants in
one launch): the CUDA kernel for a slab on the card, its plain version
for a slab on the CPU.  Calls return as soon as the work is queued on the
device; reading a result waits for it.

On a mesh (``ScorerRuntime(cfg, mesh=...)``, ``launch.mesh``) every
tenant's slab is sharded over the mesh's model axis
(``serving.sharded``): a cache is a ``ShardedCorpusCache``, each shard's
rows on its own device, and the calls above keep their signatures and
results (churn slots stay global, scores come back in global slot order,
bitwise the single-device runtime's).  ``build`` then takes the slab in
its physical ``(capacity/D, D, ...)`` view.  The query side runs on the
mesh's first device, the runtime's ``device``.

Types: the slab takes the params' type.  Params in bf16 (the serving
checkpoint's type) build a bf16 slab (``Q_I``, ``t_I``, ``lin_I``,
``a_I``), which the bf16 kernels read as stored; the query side (``P_C``,
``a_C``) is computed in the params' type and upcast to float32 once a
call.  Scores are float32 on both devices (the JAX package's jnp engine
returns bf16 there; its kernel path, float32).  Context weights take
``cfg.dtype``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ranking as rk
from repro_torch.core.dplr import DPLRParams
from repro_torch.device import resolve_device
from repro_torch.embedding.bag import prepare_lookups
from repro_torch.kernels import ops as kops
from repro_torch.models.recsys.fwfm import context_inputs
from repro_torch.serving import sharded
from repro_torch.serving.corpus import (
    ItemCorpusCache,
    build_corpus_cache,
    corpus_rows,
    item_addend,
    next_pow2,
)


# Rows of the query side computed together (``ScorerRuntime._query``); the
# frontend's largest default micro-batch and the kernels' query group.
QUERY_BLOCK = 16


class ScorerRuntime:
    """Corpus-independent scoring for one ``FwFMConfig`` (``interaction
    == 'dplr'``) on one device (``cuda`` unless ``device`` says otherwise),
    or on a ``mesh`` (``launch.mesh.Mesh``), whose first device is then the
    runtime's ``device``.  ``cfg.dtype`` is the serving dtype: context
    weights take it.  ``block_n``: the corpus kernels' slots a block
    scores, passed to every corpus call; ``None`` (default) resolves
    through the tuned-tile registry per shape cell (``kernels.blocks``), as
    does ``acc_dtype``, which the runtime leaves to it.  With nothing tuned
    the kernels' default geometry, bitwise on the card whatever the
    geometry."""

    def __init__(self, cfg, *, device=None, block_n: int | None = None, mesh=None):
        if cfg.interaction != "dplr":
            raise ValueError("ScorerRuntime requires interaction='dplr'")
        self.cfg = cfg
        self.wdtype = cfg.dtype
        self.block_n = block_n
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
            self._D = 1
            return
        if device is not None:
            raise ValueError("ScorerRuntime(device=..., mesh=...): the runtime's device is "
                             "the mesh's first; pass one of them")
        for dev in mesh.devices:
            resolve_device(dev)
        self.device = mesh.devices[0]
        self._D = sharded.shard_count(mesh)
        if self._D & (self._D - 1):
            # a capacity is a power of two divisible by D: no valid capacity
            raise ValueError(f"corpus shard count must be a power of two, got a "
                             f"{self._D}-wide model axis")

    @property
    def n_shards(self) -> int:
        """Corpus shard count D (1 without a mesh)."""
        return self._D

    def build(self, params, slab_ids, slab_w, valid):
        """The slab's cache; on a mesh ``slab_ids``/``slab_w`` (capacity/D,
        D, m_I_slots) and ``valid`` (capacity/D, D), the physical view."""
        # the context lookup's static maps go to the device here, before
        # any scoring dispatch: a copy inside one would wait for the card
        prepare_lookups(self.cfg.layout.subset("context"), params["embedding"].device)
        if self.mesh is not None:
            return sharded.build(params, self.cfg, self.mesh, slab_ids, slab_w, valid)
        return build_corpus_cache(params, self.cfg, slab_ids, slab_w, valid=valid)

    def rows(self, params, ids, w):
        return corpus_rows(params, self.cfg, ids, w)

    def context(self, params, ctx_ids, ctx_w):
        """Per-query context cache: P_C (Bq, rho, k), s_C (Bq,), lin_C (Bq,)."""
        V_C, lin_C = context_inputs(params, self.cfg, ctx_ids, ctx_w)
        p = DPLRParams(params["U"], params["e"])
        ctx = rk.dplr_context_cache(p, V_C, self.cfg.layout.n_context)
        return ctx.P_C.contiguous(), ctx.s_C, lin_C

    def _query(self, params, ctx_ids, ctx_w):
        """The kernels' query side in float32: P_C (Bq, rho, k) and the
        per-query addend a_C = bias + lin_C + s_C / 2 (Bq,), computed in the
        params' type and upcast once.  The one place that forms a_C, so a
        tenant's rows of a packed launch round exactly as its own ``topk``
        does.

        Computed in blocks of exactly ``QUERY_BLOCK`` rows, the last padded
        with copies of the batch's first row: cuBLAS and the reductions
        choose their algorithm, and with it the order of a sum, by the
        shape, so a row computed in a batch of 4 and alone differed in its
        last bits (on the card at full width).  In fixed blocks a row's
        bits do not depend on the batch it came in, and with the kernels'
        row-independent scoring neither does a reply: the frontend's
        micro-batching is invisible in the results."""
        Bq = ctx_ids.shape[0]
        pad = -Bq % QUERY_BLOCK
        if pad:
            ctx_ids = torch.cat([ctx_ids, ctx_ids[:1].expand(pad, -1)])
            ctx_w = torch.cat([ctx_w, ctx_w[:1].expand(pad, -1)])
        blocks = []
        for lo in range(0, Bq + pad, QUERY_BLOCK):
            P_C, s_C, lin_C = self.context(params, ctx_ids[lo:lo + QUERY_BLOCK],
                                           ctx_w[lo:lo + QUERY_BLOCK])
            blocks.append((P_C, params["bias"] + lin_C + 0.5 * s_C))
        P_C, a_C = blocks[0] if len(blocks) == 1 else map(torch.cat, zip(*blocks))
        return (P_C[:Bq].to(torch.float32).contiguous(),
                a_C[:Bq].to(torch.float32).contiguous())

    def _kernel_score(self, params, cache, ctx_ids, ctx_w, K=None):
        P_C, a_C = self._query(params, ctx_ids, ctx_w)
        return kops.dplr_corpus_score(cache.Q_I, cache.a_I, params["e"], P_C, a_C,
                                      valid=cache.valid, topk=K, block_n=self.block_n)

    def score(self, params, cache, ctx_ids, ctx_w) -> torch.Tensor:
        """(Bq, capacity) masked scores; dead slots exactly NEG_INF."""
        if self.mesh is not None:
            return sharded.score(self.mesh, self._query, params, cache, ctx_ids, ctx_w,
                                 block_n=self.block_n)
        return self._kernel_score(params, cache, ctx_ids, ctx_w)

    def topk(self, params, cache, ctx_ids, ctx_w, K: int):
        """((Bq, K) scores, (Bq, K) int32 slots), best first, ties to the
        lowest slot."""
        if self.mesh is not None:
            return sharded.topk(self.mesh, self._query, params, cache, ctx_ids, ctx_w, K,
                                block_n=self.block_n)
        return self._kernel_score(params, cache, ctx_ids, ctx_w, K=K)

    def multi_topk(self, params_parts, cache_parts, ctx_ids, ctx_w, K: int):
        """S tenants' top-K in one kernel launch: ``((S, Bq, K) scores,
        (S, Bq, K) int32 slots)``, row ``[s]`` equal to ``topk`` on tenant
        ``s`` alone.  ``ctx_ids``/``ctx_w``: (S, Bq, m_C_slots).  Each
        tenant's query side is computed with its own params, one call per
        tenant, by the same ``_query`` as ``topk``.  The slabs must share
        one type (a frontend packs only such tenants); on a mesh also one
        local capacity."""
        if self.mesh is not None:
            return sharded.multi_topk(self.mesh, self._query, params_parts, cache_parts,
                                      ctx_ids, ctx_w, K, block_n=self.block_n)
        pcs, acs = zip(*(self._query(params, ctx_ids[s], ctx_w[s])
                         for s, params in enumerate(params_parts)))
        return kops.dplr_corpus_score_multi(
            tuple(c.Q_I for c in cache_parts), tuple(c.a_I for c in cache_parts),
            tuple(c.valid for c in cache_parts), torch.stack([p["e"] for p in params_parts]),
            torch.stack(pcs), torch.stack(acs), topk=K, block_n=self.block_n)

    def write_rows(self, params, cache, slots, ids, w) -> ItemCorpusCache:
        """Compute the rows of Δn (slot -> item) writes, scatter them into
        the slab and mark them live.  The row computation runs on Δn
        padded to a power of two (O(log capacity) distinct shapes in all;
        the filler rows are never written).  Updates ``cache``'s tensors in
        place, with no copy of the slab, and returns it.  On a mesh the
        delta is grouped by owning shard first (``sharded.group_deltas``),
        and each shard computes and writes only its own rows."""
        if self.mesh is not None:
            li, ids_g, w_g = sharded.group_deltas(
                np.asarray(slots, np.int64), np.asarray(ids, np.int32),
                np.asarray(w, np.float32), self._D, cache.local_capacity)
            return sharded.write_grouped(params, self.cfg, self.mesh, cache, ids_g, w_g, li)
        dn = len(slots)
        pad = next_pow2(max(dn, 1)) - dn
        ids = np.asarray(ids, np.int32)
        w = np.asarray(w, np.float32)
        if pad:
            ids = np.concatenate([ids, np.zeros((pad, ids.shape[1]), np.int32)])
            w = np.concatenate([w, np.ones((pad, w.shape[1]), np.float32)])
        Q, t, lin = self.rows(params, torch.as_tensor(ids, device=self.device),
                              torch.as_tensor(w, dtype=self.wdtype, device=self.device))
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        cache.Q_I[idx] = Q[:dn]
        cache.t_I[idx] = t[:dn]
        cache.lin_I[idx] = lin[:dn]
        cache.a_I[idx] = item_addend(t, lin)[:dn]
        cache.valid[idx] = True
        return cache

    def drop_rows(self, cache, slots) -> ItemCorpusCache:
        """Mark slots dead, in place; no row computation."""
        if self.mesh is not None:
            return sharded.drop(self.mesh, cache, slots)
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        cache.valid[idx] = False
        return cache

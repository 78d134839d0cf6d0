"""ScorerRuntime: the corpus-independent half of the serving engine.
Port of ``repro.serving.runtime`` for one device.

The runtime owns everything about scoring that does not depend on which
corpus is scored: the context cache, the dispatch to the corpus kernel,
and the row computation and scatter of churn writes.  Shapes:

    score(params, cache, ctx_ids, ctx_w)      -> (Bq, capacity) f32
    topk(params, cache, ctx_ids, ctx_w, K)    -> ((Bq, K) f32, (Bq, K) int32)
    build(params, slab_ids, slab_w, valid)    -> ItemCorpusCache
    write_rows(params, cache, slots, ids, w)  -> ItemCorpusCache
    drop_rows(cache, slots)                   -> ItemCorpusCache

Scoring goes through ``kernels.ops.dplr_corpus_score``: the CUDA kernel
for a slab on the card, its plain version for a slab on the CPU.  Calls
return as soon as the work is queued on the device; reading a result
waits for it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ranking as rk
from repro_torch.core.dplr import DPLRParams
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models.recsys.fwfm import context_inputs
from repro_torch.serving.corpus import (
    ItemCorpusCache,
    build_corpus_cache,
    corpus_rows,
    next_pow2,
)


class ScorerRuntime:
    """Corpus-independent scoring for one ``FwFMConfig`` (``interaction
    == 'dplr'``) on one device (``cuda`` unless ``device`` says otherwise).
    ``cfg.dtype`` is the serving dtype: context weights take it."""

    def __init__(self, cfg, *, device=None):
        if cfg.interaction != "dplr":
            raise ValueError("ScorerRuntime requires interaction='dplr'")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.wdtype = cfg.dtype

    def build(self, params, slab_ids, slab_w, valid) -> ItemCorpusCache:
        return build_corpus_cache(params, self.cfg, slab_ids, slab_w, valid=valid)

    def rows(self, params, ids, w):
        return corpus_rows(params, self.cfg, ids, w)

    def context(self, params, ctx_ids, ctx_w):
        """Per-query context cache: P_C (Bq, rho, k), s_C (Bq,), lin_C (Bq,)."""
        V_C, lin_C = context_inputs(params, self.cfg, ctx_ids, ctx_w)
        p = DPLRParams(params["U"], params["e"])
        ctx = rk.dplr_context_cache(p, V_C, self.cfg.layout.n_context)
        return ctx.P_C.contiguous(), ctx.s_C, lin_C

    def _kernel_score(self, params, cache, ctx_ids, ctx_w, K=None):
        P_C, s_C, lin_C = self.context(params, ctx_ids, ctx_w)
        a_C = (params["bias"] + lin_C + 0.5 * s_C).contiguous()
        return kops.dplr_corpus_score(cache.Q_I, cache.a_I, params["e"], P_C, a_C,
                                      valid=cache.valid, topk=K)

    def score(self, params, cache, ctx_ids, ctx_w) -> torch.Tensor:
        """(Bq, capacity) masked scores; dead slots exactly NEG_INF."""
        return self._kernel_score(params, cache, ctx_ids, ctx_w)

    def topk(self, params, cache, ctx_ids, ctx_w, K: int):
        """((Bq, K) scores, (Bq, K) int32 slots), best first, ties to the
        lowest slot."""
        return self._kernel_score(params, cache, ctx_ids, ctx_w, K=K)

    def write_rows(self, params, cache, slots, ids, w) -> ItemCorpusCache:
        """Compute the rows of Δn (slot -> item) writes, scatter them into
        the slab and mark them live.  The row computation runs on Δn
        padded to a power of two (O(log capacity) distinct shapes in all;
        the filler rows are never written).  Updates ``cache``'s tensors in
        place, with no copy of the slab, and returns it."""
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
        cache.valid[idx] = True
        return cache

    def drop_rows(self, cache, slots) -> ItemCorpusCache:
        """Mark slots dead, in place; no row computation."""
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        cache.valid[idx] = False
        return cache

"""CorpusState: one tenant's mutable corpus behind a ScorerRuntime.
Port of ``repro.serving.engine`` for one device (no mesh, no fault
injector, no frontend; ``maybe_refresh`` waits for the checkpoint port).

``CorpusRankingEngine`` is an alias of ``CorpusState``.  Each state
builds its own runtime; sharing one runtime across tenants waits for the
multi-tenant port.

A state answers ``(Bq queries x capacity candidates)`` per call: per query
only the context cache is computed, then every candidate costs O(rho k)
against the precomputed item slab (``repro_torch.serving.corpus``).

Mutable corpus: the slab is padded to a power-of-two ``capacity`` with a
``valid`` mask and a free-list.  ``add_items`` / ``update_items`` /
``remove_items`` write only the touched rows; dead slots score exactly
``NEG_INF``; slot assignments are stable across churn and ``refresh``;
when the free-list runs dry the slab doubles.  ``on_mutate``, when set,
is called before any mutation or refresh (a frontend's writer barrier).
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch.serving.corpus import ItemCorpusCache, next_pow2
from repro_torch.serving.errors import NotReady
from repro_torch.serving.runtime import ScorerRuntime


class CorpusState:
    """One mutable, capacity-padded item corpus and its model snapshot;
    every device computation goes through ``runtime``.

    ``item_ids`` / ``item_weights``: (n, n_item_slots) local item-side ids
    and weights (numpy or tensors; weights default to ones)."""

    def __init__(self, cfg, item_ids, item_weights=None, *,
                 capacity: int | None = None, device=None):
        self.runtime = ScorerRuntime(cfg, device=device)

        ids = np.asarray(torch.as_tensor(item_ids).cpu(), np.int32)
        n0 = int(ids.shape[0])
        w = (np.ones(ids.shape, np.float32) if item_weights is None
             else np.asarray(torch.as_tensor(item_weights).cpu(), np.float32))
        self.capacity = next_pow2(max(n0, 1)) if capacity is None else int(capacity)
        if self.capacity < n0:
            raise ValueError(f"capacity={self.capacity} < initial corpus size n={n0}")
        if self.capacity & (self.capacity - 1):
            raise ValueError(f"capacity must be a power of two, got {self.capacity}")

        # host-side slab: the source of truth for ids, weights and liveness,
        # mirrored on the device by the runtime's writes
        self._slab_ids = np.zeros((self.capacity, ids.shape[1]), np.int32)
        self._slab_w = np.ones((self.capacity, ids.shape[1]), np.float32)
        self._slab_ids[:n0] = ids
        self._slab_w[:n0] = w
        self._valid_np = np.zeros(self.capacity, bool)
        self._valid_np[:n0] = True
        # free slots as a min-heap: the lowest-numbered slot goes first
        self._free = list(range(n0, self.capacity))

        self.params: dict | None = None
        self.cache: ItemCorpusCache | None = None
        self.model_step: int | None = None
        self.refresh_count = 0
        self.on_mutate = None

    @property
    def cfg(self):
        return self.runtime.cfg

    @property
    def device(self) -> torch.device:
        return self.runtime.device

    # -- corpus introspection -----------------------------------------------

    @property
    def n_items(self) -> int:
        """Live (valid) item count, not the slab capacity."""
        return self.capacity - len(self._free)

    @property
    def valid_slots(self) -> np.ndarray:
        """(n_items,) ascending corpus indices of the live slots."""
        return np.flatnonzero(self._valid_np)

    def is_live(self, indices) -> np.ndarray:
        """Elementwise liveness of corpus slot indices (out of range: False)."""
        idx = np.asarray(indices, np.int64).reshape(-1)
        ok = (0 <= idx) & (idx < self.capacity)
        out = np.zeros(idx.shape, bool)
        out[ok] = self._valid_np[idx[ok]]
        return out.reshape(np.shape(indices))

    # -- corpus mutation ----------------------------------------------------

    def _begin_write(self) -> None:
        if self.on_mutate is not None:
            self.on_mutate()

    def _scatter_rows(self, slots, ids, w) -> None:
        # device first, host mirror second: a failed write leaves the host
        # slab and liveness untouched
        self.cache = self.runtime.write_rows(self.params, self.cache, slots, ids, w)
        self._slab_ids[slots] = ids
        self._slab_w[slots] = w
        self._valid_np[slots] = True

    def _payload(self, ids, weights, op, n_expected=None):
        """Normalize and validate a (Δn, n_item_slots) ids/weights payload."""
        ids = np.atleast_2d(np.asarray(ids, np.int32))
        if n_expected is not None and ids.shape[0] != n_expected:
            raise ValueError(f"{op}: {n_expected} slots but {ids.shape[0]} item rows")
        w = (np.ones(ids.shape, np.float32) if weights is None
             else np.atleast_2d(np.asarray(weights, np.float32)))
        if w.shape != ids.shape:
            raise ValueError(f"{op}: weights shape {w.shape} != ids shape {ids.shape}")
        return ids, w

    def add_items(self, ids, weights=None) -> np.ndarray:
        """Insert Δn items; returns their (Δn,) corpus slots (stable until
        removed).  Doubles the slab first if the free-list runs dry."""
        self._require_ready()
        self._begin_write()
        ids, w = self._payload(ids, weights, "add_items")
        dn = ids.shape[0]
        if dn > len(self._free):
            self._grow(dn - len(self._free))
        slots = np.asarray([heapq.heappop(self._free) for _ in range(dn)], np.int64)
        try:
            self._scatter_rows(slots, ids, w)
        except Exception:
            # the rows were never written: give the slots back
            for g in slots:
                heapq.heappush(self._free, int(g))
            raise
        return slots

    def update_items(self, indices, ids, weights=None) -> None:
        """Rewrite the items at the given live slots in place."""
        self._require_ready()
        self._begin_write()
        slots = np.asarray(indices, np.int64).reshape(-1)
        self._check_live(slots, "update_items")
        ids, w = self._payload(ids, weights, "update_items", n_expected=slots.size)
        self._scatter_rows(slots, ids, w)

    def remove_items(self, indices) -> None:
        """Invalidate the given live slots; they score NEG_INF at once and
        their rows become free."""
        self._require_ready()
        self._begin_write()
        slots = np.asarray(indices, np.int64).reshape(-1)
        self._check_live(slots, "remove_items")
        self.cache = self.runtime.drop_rows(self.cache, slots)
        self._valid_np[slots] = False
        for s in slots:
            heapq.heappush(self._free, int(s))

    def _check_live(self, slots, op):
        if len(np.unique(slots)) != len(slots):
            raise ValueError(f"{op}: duplicate slot indices")
        if slots.size and not ((0 <= slots).all() and (slots < self.capacity).all()
                               and self._valid_np[slots].all()):
            raise ValueError(f"{op}: slot indices must be live corpus slots")

    def _grow(self, min_extra: int) -> None:
        """Double the slab (at least) so that >= min_extra slots are free.
        Every live slot keeps its number."""
        old = self.capacity
        new = max(old * 2, next_pow2(old + min_extra))
        extra = new - old
        self._slab_ids = np.pad(self._slab_ids, ((0, extra), (0, 0)))
        self._slab_w = np.pad(self._slab_w, ((0, extra), (0, 0)), constant_values=1.0)
        self._valid_np = np.pad(self._valid_np, (0, extra))
        # every new slot is above every free slot: appending keeps the heap
        self._free.extend(range(old, new))
        self.capacity = new
        if self.cache is not None:
            c = self.cache
            self.cache = ItemCorpusCache(
                Q_I=torch.cat([c.Q_I, c.Q_I.new_zeros((extra, *c.Q_I.shape[1:]))]),
                t_I=torch.cat([c.t_I, c.t_I.new_zeros(extra)]),
                lin_I=torch.cat([c.lin_I, c.lin_I.new_zeros(extra)]),
                valid=torch.cat([c.valid, c.valid.new_zeros(extra)]),
            )

    # -- model lifecycle ----------------------------------------------------

    def refresh(self, params: dict, step: int | None = None) -> None:
        """Install a model snapshot: rebuild every slab row in place (slot
        assignments preserved)."""
        self._begin_write()
        dev = self.device
        self.params = params
        self.cache = self.runtime.build(
            params, torch.as_tensor(self._slab_ids, device=dev),
            torch.as_tensor(self._slab_w, dtype=self.runtime.wdtype, device=dev),
            torch.as_tensor(self._valid_np, device=dev))
        self.model_step = step
        self.refresh_count += 1

    # -- scoring ------------------------------------------------------------

    def _require_ready(self):
        if self.cache is None:
            raise NotReady("engine has no model: call refresh() first")

    def _ctx_tensors(self, context_ids, context_weights):
        ids = torch.as_tensor(context_ids, device=self.device)
        w = (torch.ones(ids.shape, dtype=self.runtime.wdtype, device=self.device)
             if context_weights is None
             else torch.as_tensor(context_weights, dtype=self.runtime.wdtype,
                                  device=self.device))
        return ids, w

    def score(self, context_ids, context_weights=None) -> torch.Tensor:
        """(Bq, capacity) scores for a batch of query contexts; dead slots
        score exactly ``NEG_INF``.  ``context_ids``: (Bq, m_C_slots) local
        context slot ids; weights default to ones."""
        self._require_ready()
        ids, w = self._ctx_tensors(context_ids, context_weights)
        return self.runtime.score(self.params, self.cache, ids, w)

    def topk(self, context_ids, K: int, context_weights=None):
        """((Bq, K) scores, (Bq, K) int32 corpus slots), best first, ties to
        the lowest slot; a dead slot is never returned (K is checked
        against the live item count)."""
        self._require_ready()
        if not 0 < K <= self.n_items:
            raise ValueError(f"topk K={K} out of range for corpus of "
                             f"{self.n_items} live items")
        ids, w = self._ctx_tensors(context_ids, context_weights)
        return self.runtime.topk(self.params, self.cache, ids, w, K)


CorpusRankingEngine = CorpusState

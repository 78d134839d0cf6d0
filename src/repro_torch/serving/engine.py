"""CorpusState: one tenant's mutable corpus behind a ScorerRuntime.
Port of ``repro.serving.engine``.

The serving stack is three layers:

    ScorerRuntime  (serving/runtime.py)   shared: the scoring dispatch,
                                          corpus-independent
    CorpusState    (this module)          per tenant: the slab, its
                                          free-list, params, ``on_mutate``
    QueryFrontend  (serving/frontend.py)  shared: tenant-routed queues,
                                          micro-batching, packing

``CorpusState(..., runtime=rt)`` puts a tenant on a shared runtime;
without ``runtime`` it builds a private one.  ``CorpusRankingEngine`` is
an alias of ``CorpusState``.  ``fused_topk`` answers S tenants sharing a
runtime in one kernel launch (``dplr_corpus_score_multi``), each row
equal to that tenant's own ``topk``.  There is no fallback from the
kernel to a plain path: on the card a launch runs or raises.

A state answers ``(Bq queries x capacity candidates)`` per call: per query
only the context cache is computed, then every candidate costs O(rho k)
against the precomputed item slab (``repro_torch.serving.corpus``).

Mutable corpus: the slab is padded to a power-of-two ``capacity`` with a
``valid`` mask and a free-list.  ``add_items`` / ``update_items`` /
``remove_items`` write only the touched rows; dead slots score exactly
``NEG_INF``; slot assignments are stable across churn and ``refresh``;
when the free-list runs dry the slab doubles.  ``on_mutate``, when set,
is called before any mutation or refresh (a frontend's writer barrier).

Sharded slab: ``CorpusState(..., mesh=m)`` (or a runtime built with
``mesh=m``) shards the slab over the mesh's model axis
(``serving.sharded``): each of the D shards holds capacity/D slots, global
slot ``g`` at shard ``g % D``'s local row ``g // D``.  Slots are handed
out lowest free id first, as on one device, so both engines assign the
same slots; growth appends local rows to every shard, so no slot is
renumbered; the capacity must be a multiple of D.  Scores, top-K and
``fused_topk`` are bitwise the single-device engine's.

Faults: ``fault_injector`` (``repro_torch.serving.faults``) arms three
sites.  ``write`` fires before the device write of ``add_items`` /
``update_items`` / ``remove_items``, ``alloc`` before a slab doubles; a
fired probe, like a failed write, leaves the host mirror, the free-list
and the slab exactly as they were.  ``kernel`` fires before the scoring
launch of ``score``, ``topk`` and ``fused_topk``.  Unlike the reference,
the port does not degrade to another scorer when a launch fails: the
error (an armed ``kernel`` probe's or a real one) reaches the caller,
and a ``QueryFrontend`` re-dispatches the same batch through the same
kernel until its retries are spent.  ``kernel_degraded`` exists, for
``health()``, and is always False.

The scoring dispatch of ``score``, ``topk`` and ``fused_topk`` runs inside
``sanitize.scoring_guard``: under ``REPRO_SANITIZE=1`` on the card, a
call in it that makes the host wait for the card raises.  The host to
device copy of the contexts (``_ctx_tensors``) comes before the guard.

Model refresh from training: ``maybe_refresh(manager, template, select)``
polls a ``repro_torch.checkpoint.CheckpointManager`` (whose directory
either package may have written) and installs a newer step; a corrupt
newest step raises ``RefreshFailed`` once while the last-good snapshot
keeps serving.
"""
from __future__ import annotations

import heapq
import time

import numpy as np
import torch

from repro_torch.serving.corpus import ItemCorpusCache, next_pow2, pad_cache, physical
from repro_torch.serving.sharded import ShardedCorpusCache
from repro_torch.serving.errors import NotReady, RefreshFailed
from repro_torch.serving.runtime import ScorerRuntime
from repro_torch.serving.sanitize import scoring_guard


class CorpusState:
    """One mutable, capacity-padded item corpus and its model snapshot;
    every device computation goes through ``runtime``.

    ``item_ids`` / ``item_weights``: (n, n_item_slots) local item-side ids
    and weights (numpy or tensors; weights default to ones).
    ``fault_injector``: an optional ``FaultInjector`` for the ``write``,
    ``alloc`` and ``kernel`` sites (settable later).  ``block_n`` and
    ``mesh``: as ``ScorerRuntime``'s, for the runtime this state builds."""

    def __init__(self, cfg, item_ids, item_weights=None, *,
                 capacity: int | None = None, device=None, block_n: int | None = None,
                 runtime: ScorerRuntime | None = None, fault_injector=None, mesh=None):
        if runtime is None:
            runtime = ScorerRuntime(cfg, device=device, block_n=block_n, mesh=mesh)
        else:
            if cfg is not None and cfg is not runtime.cfg:
                raise ValueError("CorpusState(cfg=..., runtime=...): the runtime was "
                                 "built for a different config; pass runtime.cfg "
                                 "(or cfg=None)")
            if mesh is not None and mesh is not runtime.mesh:
                raise ValueError("CorpusState(mesh=..., runtime=...): mesh is a runtime "
                                 "property; build the ScorerRuntime with it instead")
            if device is not None and torch.device(device) != runtime.device:
                raise ValueError("CorpusState(device=..., runtime=...): device is a "
                                 "runtime property; build the ScorerRuntime with it "
                                 "instead")
            if block_n is not None and block_n != runtime.block_n:
                raise ValueError("CorpusState(block_n=..., runtime=...): block_n is a "
                                 "runtime property; build the ScorerRuntime with it "
                                 "instead")
        self.runtime = runtime
        self._D = runtime.n_shards

        ids = np.asarray(torch.as_tensor(item_ids).cpu(), np.int32)
        n0 = int(ids.shape[0])
        w = (np.ones(ids.shape, np.float32) if item_weights is None
             else np.asarray(torch.as_tensor(item_weights).cpu(), np.float32))
        self.capacity = (max(next_pow2(max(n0, 1)), self._D) if capacity is None
                         else int(capacity))
        if self.capacity < n0:
            raise ValueError(f"capacity={self.capacity} < initial corpus size n={n0}")
        if self.capacity & (self.capacity - 1):
            raise ValueError(f"capacity must be a power of two, got {self.capacity}")
        if self.capacity % self._D:
            raise ValueError(f"capacity={self.capacity} not divisible by the {self._D}-way "
                             f"corpus shard axis")

        # host-side slab: the source of truth for ids, weights and liveness,
        # mirrored on the device by the runtime's writes
        self._slab_ids = np.zeros((self.capacity, ids.shape[1]), np.int32)
        self._slab_w = np.ones((self.capacity, ids.shape[1]), np.float32)
        self._slab_ids[:n0] = ids
        self._slab_w[:n0] = w
        self._valid_np = np.zeros(self.capacity, bool)
        self._valid_np[:n0] = True
        # free slots as a min-heap: the lowest-numbered global slot goes
        # first, whatever the shard count (the reference's per-shard heaps
        # hand out the same order)
        self._free = list(range(n0, self.capacity))

        self.params: dict | None = None
        self.cache: ItemCorpusCache | None = None
        self.model_step: int | None = None
        self.refresh_count = 0
        self.last_refresh_time: float | None = None     # time.monotonic
        self.last_refresh_error: str | None = None
        self._last_polled_sig: tuple | None = None
        self.on_mutate = None
        self._injector = fault_injector
        # health() reads it; the port never degrades to another scorer
        self.kernel_degraded = False

    @property
    def cfg(self):
        return self.runtime.cfg

    @property
    def device(self) -> torch.device:
        return self.runtime.device

    @property
    def mesh(self):
        return self.runtime.mesh

    @property
    def n_shards(self) -> int:
        """Corpus shard count D (1 without a mesh)."""
        return self._D

    @property
    def local_capacity(self) -> int:
        """Slots a shard holds: capacity / D."""
        return self.capacity // self._D

    def shard_of(self, slots) -> np.ndarray:
        """Owning shard of each global slot (striped: ``g % D``)."""
        return np.asarray(slots, np.int64) % self._D

    @property
    def fault_injector(self):
        """The attached ``FaultInjector`` (None when chaos is off)."""
        return self._injector

    @fault_injector.setter
    def fault_injector(self, injector) -> None:
        self._injector = injector

    def _probe(self, site: str) -> None:
        if self._injector is not None:
            self._injector.check(site)

    # -- corpus introspection -----------------------------------------------

    @property
    def n_items(self) -> int:
        """Live (valid) item count, not the slab capacity."""
        return self.capacity - len(self._free)

    @property
    def occupancy(self) -> float:
        """Live fraction of the slab, ``n_items / capacity``: the
        autoscaling signal."""
        return 1.0 - len(self._free) / self.capacity

    def maybe_autoscale(self, high: float) -> bool:
        """Double the slab once ``occupancy >= high``, behind the writer
        barrier, at a scheduled tick rather than inside an ``add_items``
        on the hot path.  A no-op before the first ``refresh`` or below the
        mark.  Returns True when it grew."""
        if not 0.0 < high <= 1.0:
            raise ValueError(f"high={high} outside (0, 1]")
        if self.cache is None or self.occupancy < high:
            return False
        self._begin_write()
        self._grow(1)
        return True

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
        # device first, host mirror second: a failed write (or a fired
        # 'write' probe) leaves the host slab and liveness untouched
        self._probe("write")
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
        self._probe("write")
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
        Every live slot keeps its number.  A fired 'alloc' probe comes
        before any state is touched."""
        self._probe("alloc")
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
            if self.mesh is None:
                self.cache = pad_cache(self.cache, extra)
            else:
                # striped: the new global slots [old, new) are exactly the
                # new local rows [old/D, new/D) of every shard
                self.cache = ShardedCorpusCache(tuple(pad_cache(c, extra // self._D)
                                                      for c in self.cache.shards))

    # -- model lifecycle ----------------------------------------------------

    def refresh(self, params: dict, step: int | None = None) -> None:
        """Install a model snapshot: rebuild every slab row in place (slot
        assignments preserved)."""
        self._begin_write()
        dev = self.device
        self.params = params
        if self.mesh is None:
            self.cache = self.runtime.build(
                params, torch.as_tensor(self._slab_ids, device=dev),
                torch.as_tensor(self._slab_w, dtype=self.runtime.wdtype, device=dev),
                torch.as_tensor(self._valid_np, device=dev))
        else:
            # each shard rebuilds its own column of the physical view
            D = self._D
            self.cache = self.runtime.build(params, physical(self._slab_ids, D),
                                            physical(self._slab_w, D),
                                            physical(self._valid_np, D))
        self.model_step = step
        self.refresh_count += 1
        self.last_refresh_time = time.monotonic()

    def maybe_refresh(self, manager, template, select=lambda t: t) -> bool:
        """Checkpoint invalidation hook: if a newer checkpoint step exists,
        restore it onto this state's device and rebuild the slab.
        ``template`` is the tree structure passed to ``manager.restore``;
        ``select`` extracts the model params from the restored tree.

        Returns True on a swap, False when there is nothing newer (or the
        newest landing is a step backwards).  A newest step that fails
        validation, with nothing newer than the installed step restorable,
        raises ``RefreshFailed`` (its step and poll signature attached)
        while the last-good snapshot keeps serving.  A corrupt newest step
        with a valid intermediate one (newer than the installed step)
        installs the intermediate, returns True and records the bad push
        in ``last_refresh_error``.

        Poison-safe: the newest step's signature (step and manifest mtime)
        is recorded before the restore, and a poll that finds the same
        signature again returns False at once, so a corrupt checkpoint
        costs one restore and raises once, while a later re-save of the
        same step (a new mtime) is still picked up."""
        # name-only poll: no checksum pass over the retained checkpoints;
        # restore() below validates what it loads
        step = manager.latest_step(validate=False)
        if step is None or step == self.model_step:
            return False
        sig = manager.step_signature(step)
        if sig == self._last_polled_sig:
            return False
        self._last_polled_sig = sig
        restored, rstep = manager.restore(template, device=self.device)
        if restored is None or (self.model_step is not None and rstep is not None
                                and rstep <= self.model_step):
            self.last_refresh_error = (f"checkpoint step {step} failed validation; serving "
                                       f"last-good step {self.model_step}")
            raise RefreshFailed(self.last_refresh_error, step=step, signature=sig)
        if rstep is not None and rstep < step:
            self.last_refresh_error = (f"checkpoint step {step} failed validation; "
                                       f"installed fallback step {rstep}")
        else:
            self.last_refresh_error = None
        self.refresh(select(restored), step=rstep)
        return True

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
        self._probe("kernel")
        with scoring_guard(self.device):
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
        self._probe("kernel")
        with scoring_guard(self.device):
            return self.runtime.topk(self.params, self.cache, ids, w, K)

    def warmup_grid(self, context_ids, context_weights=None, *,
                    max_batch: int = 16, max_k: int = 16) -> int:
        """One dispatch at the largest corner of the (Bq bucket x K bucket)
        grid a frontend can reach, with one representative context: the
        kernels' build and load, and the allocator's growth to the largest
        scratch, are paid here, not by a request.  Nothing is traced, so
        the rest of the grid costs its first launch no more than any
        later one.  Returns the number of dispatches.  Call after
        ``refresh``."""
        ctx = np.asarray(torch.as_tensor(context_ids).cpu(), np.int32).reshape(-1)
        w = (np.ones(ctx.shape, np.float32) if context_weights is None
             else np.asarray(torch.as_tensor(context_weights).cpu(), np.float32).reshape(-1))
        k = min(next_pow2(max_k), 1 << (self.n_items.bit_length() - 1))
        self.topk(np.tile(ctx, (max_batch, 1)), k, np.tile(w, (max_batch, 1)))
        return 1


def fused_topk(states, context_ids, K: int, context_weights=None):
    """One kernel launch answering S tenants' micro-batches:
    ``((S, Bq, K) scores, (S, Bq, K) int32 slots)``, row ``[s]`` equal to
    ``states[s].topk(context_ids[s], K)``.  The path a ``QueryFrontend``
    packs same-runtime tenants through (``pack=True``).

    ``states`` must share one ``ScorerRuntime`` and each be ready with
    ``K <= n_items`` (on a mesh, also one capacity); ``context_ids``: (S,
    Bq, m_C_slots), one common Bq (the frontend buckets before packing);
    weights default to ones.  Each state's ``kernel`` probe is checked
    before the launch; a fault fails the whole pack, with no fallback."""
    states = tuple(states)
    if not states:
        raise ValueError("fused_topk needs at least one state")
    rt = states[0].runtime
    for st in states:
        if st.runtime is not rt:
            raise ValueError("fused_topk states must share one ScorerRuntime (tenants "
                             "on different runtimes cannot pack into one dispatch)")
        st._require_ready()
        if not 0 < K <= st.n_items:
            raise ValueError(f"fused_topk K={K} out of range for a corpus of "
                             f"{st.n_items} live items")
    if rt.mesh is not None and len({st.local_capacity for st in states}) != 1:
        raise ValueError("fused mesh top-K needs equal capacities; the frontend's pack "
                         "key guarantees this")
    ids = torch.as_tensor(context_ids, device=rt.device)
    if ids.ndim != 3 or ids.shape[0] != len(states):
        raise ValueError(f"context_ids must stack to (S={len(states)}, Bq, m_C_slots), "
                         f"got {tuple(ids.shape)}")
    w = (torch.ones(ids.shape, dtype=rt.wdtype, device=rt.device) if context_weights is None
         else torch.as_tensor(context_weights, dtype=rt.wdtype, device=rt.device))
    for st in states:
        st._probe("kernel")
    with scoring_guard(rt.device):
        return rt.multi_topk(tuple(st.params for st in states),
                             tuple(st.cache for st in states), ids, w, K)


CorpusRankingEngine = CorpusState

"""Tenant-routed micro-batching query frontend (the online path).  Port of
``repro.serving.frontend``.

A ``CorpusState`` scores a batch of query contexts for one corpus in one
dispatch, but an online service receives queries one at a time, each
with its own K, deadline and tenant (the advertiser, market or surface
whose corpus it ranks against).  ``QueryFrontend`` sits in between: one
request queue per tenant, each tenant's requests coalesced into
power-of-two micro-batches, the non-empty queues taken in turn into one
shared in-flight window, and load it cannot serve in time shed at submit
with ``Overloaded``.

    submit -> admission -> tenant queue (EDF) -> [bucket Bq, pad] ->
    dispatch (async) -> in-flight window -> resolve (one blocking read)
    -> reply truncated to the request's K

A reply is ``((k,) scores, (k,) int32 corpus slots)`` as numpy arrays,
best first, equal to ``engine.topk(ctx, k)`` on the request's tenant.

What it keeps from the reference:

* Tenants: one engine (lane ``"default"``) or a ``{name: CorpusState}``
  dict; ``add_tenant``/``remove_tenant`` live.  A micro-batch never mixes
  tenants' rows; batches of different tenants share the window.
* Buckets: a micro-batch of q requests pads to the next power of two
  ``<= max_batch`` by repeating a real row, and one dispatch serves every
  K in it at ``next_pow2(max K)``, each reply truncated (a top-K is
  sorted, so its first k entries are the top-k).
* Order: EDF within a tenant (deadline-less requests FIFO, after the
  deadlined ones); smooth weighted round-robin (SWRR) across tenants, one
  micro-batch per turn, with an optional QPS quota per tenant (token
  bucket, burst ``max_batch``) that only the scheduler honours.
* Packing (``pack=True``): when a turn picks a lane, further turns go
  to other eligible lanes with the same pack key (runtime, context
  width, slab type; on a mesh, local capacity), up to the kernel's
  ``MAX_SEGMENTS``, and the group runs as one ``engine.fused_topk``
  launch.  Unlike the reference, the key leaves out the capacity of an
  unsharded slab: the kernel reads each tenant's slab where it lies,
  whatever its length, so tenants of different capacities (or one that
  ``autoscale_high`` just doubled) still pack.  On a mesh it holds the
  local capacity, as the reference's does.  The group shares one Bq
  bucket and one K bucket, and its segment count pads to a power of two
  by repeating the last tenant.  A group whose K bucket exceeds a member's
  live corpus unpacks into per-tenant dispatches.  ``_PackedLaunch``
  reads the (S, Bq, K) result once for all its members.
* The in-flight window (``inflight``, default 2) shared by all tenants:
  a dispatch returns as soon as its kernels are queued on the card, and
  a batch is read back only when the window is full, a caller asks for a
  result, or a drain runs.
* Admission: ``admit_depth`` (queue depth) and ``admit_deadlines``
  (predicted completion from an EWMA of the blocking-read time) shed at
  submit, before the request is queued.
* Self-healing: a failed dispatch is re-dispatched, the same batch
  through the same kernel, up to ``retries`` times with jittered
  exponential backoff, then fails with ``DispatchFailed``; a tenant's
  circuit breaker (``breaker_threshold``) sheds its submits with
  ``Degraded`` until a cooldown and a successful probe; under queue
  pressure (``pressure_depth``) the served K clamps to ``pressure_k``
  (the exact prefix, flagged ``degraded``); ``autoscale_high`` doubles a
  slab at a pump tick; ``start_pump`` runs the pump on a thread with an
  optional watchdog; ``health()`` reports it all; ``close()`` resolves
  what is in flight and fails what is queued with ``Unservable``.
* The writer barrier: registering tenant T sets ``T.on_mutate`` to drain
  T alone, so churn and refresh on T wait for T's queued and in-flight
  reads and no other tenant's.  A writer on another thread goes through
  the frontend's ``add_items``/``remove_items``/``update_items``/
  ``refresh``, which hold the frontend's lock across barrier and write.

* Faults: ``fault_injector`` (``repro_torch.serving.faults``) arms the
  ``dispatch`` probe (inside the retried call, so a fired dispatch is
  retried like a failed launch), ``resolve`` (where a batch is read back;
  the batch re-dispatches) and ``pump`` (in the pump thread, outside the
  lock, so a stalled pump blocks nothing and the watchdog replaces it).
  ``health()`` reports each lane's ``kernel_degraded``, which is always
  False: the port re-dispatches through the same kernel and never falls
  back to another scorer.

Nothing here is traced, so there is no trace
count and no shape grid to warm: a kernel's first launch at a shape costs
what every later launch costs once its library is built and loaded.
``warmup``/``warmup_packed`` make one dispatch at the largest bucket, so
that the first request pays neither the build nor the allocator's growth
to the largest scratch.
"""
from __future__ import annotations

import collections
import heapq
import math
import threading
import time
from functools import partial

import numpy as np

from repro_torch.kernels.dplr_corpus_score import MAX_SEGMENTS
from repro_torch.serving.corpus import next_pow2
from repro_torch.serving.engine import fused_topk
from repro_torch.serving.errors import (
    DeadlineExceeded,
    Degraded,
    DispatchFailed,
    Overloaded,
    Unservable,
)


def _host(t) -> np.ndarray:
    """A result tensor as a host array: the one blocking read."""
    return t.cpu().numpy()


class PendingQuery:
    """Future-like handle for one submitted request.

    ``result()`` returns ``((K,) scores, (K,) int32 slots)``, best first,
    blocking until the request's micro-batch resolves (flushing it first
    if it is still queued).  ``done()`` never blocks.  ``submit_time`` and
    ``done_time`` are frontend-clock stamps; ``tenant`` names the lane.
    Under the pressure clamp ``served_k < k`` and ``degraded`` is True:
    the reply is then the exact top-``served_k`` prefix."""

    __slots__ = ("k", "served_k", "degraded", "deadline", "submit_time",
                 "done_time", "tenant", "_frontend", "_ctx", "_w",
                 "_scores", "_slots", "_error", "_taken")

    def __init__(self, frontend, tenant, ctx, w, k, deadline, submit_time):
        self.k = k
        self.served_k = k            # lowered only by the pressure clamp
        self.degraded = False
        self.deadline = deadline
        self.submit_time = submit_time
        self.done_time = None
        self.tenant = tenant
        self._frontend = frontend
        self._ctx = ctx
        self._w = w
        self._scores = None
        self._slots = None
        self._error = None
        self._taken = False          # popped from its lane's queue

    def done(self) -> bool:
        return self.done_time is not None

    def result(self):
        """((K,) scores, (K,) int32 slots).  Blocks: flushes the queue if
        needed, then resolves in-flight batches up to this one.  Raises the
        request's typed error if it failed."""
        # snapshot before the done() check: a writer-wrapper drain on
        # another thread may finish this request (clearing _frontend) in
        # between; _resolve_until checks again under the lock
        fe = self._frontend
        if not self.done() and fe is not None:
            fe._resolve_until(self)
        if self._error is not None:
            raise self._error
        return self._scores, self._slots

    def _finish(self, scores, slots, now):
        self._scores, self._slots = scores, slots
        self.done_time = now
        self._frontend = self._ctx = self._w = None

    def _fail(self, err, now):
        self._error = err
        self.done_time = now
        self._frontend = self._ctx = self._w = None


class _InFlight:
    """One dispatched, unresolved micro-batch: its result tensors (or, for
    a packed batch, the shared ``_PackedLaunch`` and its segment ``seg``),
    its requests in row order, its tenant, and the assembled batch
    (ctx, w, k_pad), so that a failure seen at read time re-dispatches the
    identical batch on its own."""

    __slots__ = ("requests", "vals", "idx", "tenant", "ctx", "w", "k_pad",
                 "launch", "seg")

    def __init__(self, requests, vals, idx, tenant, ctx, w, k_pad,
                 launch=None, seg=None):
        self.requests = requests
        self.vals = vals
        self.idx = idx
        self.tenant = tenant
        self.ctx = ctx
        self.w = w
        self.k_pad = k_pad
        self.launch = launch
        self.seg = seg


class _PackedLaunch:
    """The result of one fused multi-tenant dispatch: the (S, Bq, K)
    tensors and their host copy, read once (the first member's resolve
    blocks, the others slice).  A failed read is remembered, so that each
    member takes its own single-tenant re-dispatch."""

    __slots__ = ("vals", "idx", "np_vals", "np_idx", "error")

    def __init__(self, vals, idx):
        self.vals = vals
        self.idx = idx
        self.np_vals = None
        self.np_idx = None
        self.error = None

    def read(self):
        """((S, Bq, K) scores, (S, Bq, K) slots) as host arrays."""
        if self.error is not None:
            raise self.error
        if self.np_vals is None:
            try:
                self.np_vals = _host(self.vals)
                self.np_idx = _host(self.idx)
            except Exception as e:        # noqa: BLE001 - a deferred device fault
                self.error = e
                raise
        return self.np_vals, self.np_idx


class _TenantLane:
    """Per-tenant state: the engine, the EDF queue, counters, the circuit
    breaker (``closed`` -> ``open`` -> ``half_open`` -> ``closed``), the
    SWRR ``weight``/``credit`` and the optional QPS token bucket."""

    __slots__ = ("name", "engine", "heap", "arrivals", "n_ctx", "ctx_vocab", "stats",
                 "breaker", "fails", "opened_at", "weight", "quota",
                 "tokens", "tok_t", "credit")

    def __init__(self, name, engine, weight=1.0, quota=None):
        self.name = name
        self.engine = engine
        self.heap: list = []                      # (deadline|inf, seq, req)
        self.arrivals: collections.deque = collections.deque()  # FIFO view
        ctx_layout = engine.cfg.layout.subset("context")
        self.n_ctx = ctx_layout.n_slots
        # each context slot's vocabulary size: submit refuses an id outside it
        self.ctx_vocab = np.array([f.vocab_size for f in ctx_layout.fields],
                                  np.int64)[ctx_layout.slot_to_field]
        self.stats = {"submitted": 0, "completed": 0, "shed": 0,
                      "failed": 0, "trips": 0, "quota_deferred": 0}
        self.breaker = "closed"                   # closed|open|half_open
        self.fails = 0                            # consecutive exhausted
        self.opened_at = None                     # frontend-clock stamp
        self.weight = float(weight)               # SWRR share
        self.quota = None if quota is None else float(quota)
        self.tokens = 0.0
        self.tok_t = None                         # last refill stamp
        self.credit = 0.0                         # SWRR running credit


class QueryFrontend:
    """Coalesces single ranking requests into micro-batched, overlapped
    ``engine.topk`` (or, packed, ``fused_topk``) dispatches, per tenant.

    ``engines``: one ``CorpusState`` or ``{name: CorpusState}``.  The
    frontend becomes each state's ``on_mutate`` (one frontend per state).
    ``max_batch`` (power of two): Bq buckets are 1, 2, ..., max_batch.
    ``max_k``: largest per-request K.  ``max_wait``: seconds a request
    may wait before its lane's partial batch dispatches at a ``pump``.
    ``inflight``: depth of the shared unresolved window.
    ``admit_depth`` / ``admit_deadlines``: admission control (off by
    default).  ``auto_pump``: pump from ``submit`` (default).  ``clock``:
    time source.  ``retries`` / ``retry_backoff``: bounded re-dispatch.
    ``breaker_threshold`` / ``breaker_cooldown``: per-tenant breaker (off
    by default).  ``pressure_depth`` / ``pressure_k``: the K clamp (off by
    default).  ``autoscale_high``: slab occupancy mark (off by default).
    ``pack``: fused multi-tenant dispatch (off by default), at most
    ``MAX_SEGMENTS`` tenants a launch.  ``fault_injector``: the
    ``dispatch``/``resolve``/``pump`` probes (None: off).
    """

    def __init__(self, engines, *, max_batch: int = 16, max_k: int = 16,
                 max_wait: float = 2e-3, inflight: int = 2,
                 admit_depth: int | None = None,
                 admit_deadlines: bool = False, auto_pump: bool = True,
                 clock=time.perf_counter, retries: int = 2,
                 retry_backoff: float = 1e-3,
                 breaker_threshold: int | None = None,
                 breaker_cooldown: float = 0.05,
                 pressure_depth: int | None = None,
                 pressure_k: int | None = None,
                 autoscale_high: float | None = None,
                 pack: bool = False, fault_injector=None):
        if max_batch < 1 or max_batch & (max_batch - 1):
            raise ValueError(f"max_batch must be a power of two, got {max_batch}")
        if max_k < 1:
            raise ValueError(f"max_k must be >= 1, got {max_k}")
        if inflight < 1:
            raise ValueError(f"inflight depth must be >= 1, got {inflight}")
        if admit_depth is not None and admit_depth < 1:
            raise ValueError(f"admit_depth must be >= 1, got {admit_depth}")
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        if breaker_threshold is not None and breaker_threshold < 1:
            raise ValueError(f"breaker_threshold must be >= 1, got {breaker_threshold}")
        if (pressure_depth is None) != (pressure_k is None):
            raise ValueError("pressure_depth and pressure_k come together")
        if pressure_k is not None and not 1 <= pressure_k <= max_k:
            raise ValueError(f"pressure_k={pressure_k} outside [1, max_k={max_k}]")
        if autoscale_high is not None and not 0.0 < autoscale_high <= 1.0:
            raise ValueError(f"autoscale_high={autoscale_high} outside (0, 1]")
        self.pack = bool(pack)
        self.max_batch = max_batch
        self.max_k = max_k
        self.max_wait = float(max_wait)
        self.inflight = inflight
        self.admit_depth = admit_depth
        self.admit_deadlines = admit_deadlines
        self.auto_pump = auto_pump
        self.clock = clock
        self.retries = retries
        self.retry_backoff = float(retry_backoff)
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = float(breaker_cooldown)
        self.pressure_depth = pressure_depth
        self.pressure_k = pressure_k
        self.autoscale_high = autoscale_high
        self._injector = fault_injector
        self._rng = np.random.default_rng(0)     # retry jitter (seeded)
        self._closed = False
        self._lanes: dict[str, _TenantLane] = {}
        self._seq = 0                # global FIFO tie-break for EDF
        self._svc = None             # EWMA batch service time (seconds)
        self._window: collections.deque[_InFlight] = collections.deque()
        self._lock = threading.RLock()
        # retry backoff waits on a Condition of the frontend's lock: wait()
        # releases the re-entrant lock at every depth for the pause, so
        # submits and pump ticks go on while a failed dispatch backs off
        self._retry_wait = threading.Condition(self._lock)
        # batches a dispatch has taken and is retrying, by tenant: while one
        # backs off it is in neither a lane's queue nor the window, so the
        # blocking paths wait on ``_retry_wait`` until the count is zero
        self._retrying: collections.Counter = collections.Counter()
        # background pump + watchdog (start_pump): the generation token
        # lets the watchdog orphan a stalled pump thread, which exits when
        # it wakes and finds its generation stale
        self._pump_run = False
        self._pump_gen = 0
        self._pump_beat = 0.0        # time.monotonic heartbeat
        self._pump_interval = 1e-3
        self._watchdog_timeout = None
        self._pump_thread = None
        self._watchdog_thread = None
        self.stats = {"submitted": 0, "completed": 0, "expired": 0,
                      "failed": 0, "shed": 0, "dispatches": 0,
                      "dispatched_rows": 0, "padded_rows": 0, "drains": 0,
                      "retries": 0, "degraded": 0, "clamped": 0,
                      "pump_restarts": 0, "pump_errors": 0,
                      "autoscales": 0, "fused_dispatches": 0,
                      "fused_segments": 0}
        self.last_pump_error: BaseException | None = None
        if hasattr(engines, "topk"):         # a single engine
            engines = {"default": engines}
        for name, engine in engines.items():
            self.add_tenant(name, engine)

    # -- tenant management --------------------------------------------------

    def add_tenant(self, name: str, engine, *, weight: float = 1.0,
                   quota: float | None = None) -> None:
        """Register a tenant lane and install its writer barrier
        (``engine.on_mutate`` drains this tenant only).  ``weight``: its
        SWRR share of dispatch turns; ``quota``: an optional QPS cap (token
        bucket, burst ``max_batch``, empty at registration)."""
        if weight <= 0.0:
            raise ValueError(f"weight must be > 0, got {weight}")
        if quota is not None and quota <= 0.0:
            raise ValueError(f"quota must be > 0 requests/s, got {quota}")
        with self._lock:
            if name in self._lanes:
                raise ValueError(f"tenant {name!r} already registered")
            lane = _TenantLane(name, engine, weight, quota)
            lane.tok_t = self.clock()
            self._lanes[name] = lane
            engine.on_mutate = partial(self._drain_tenant, name)

    def set_tenant_policy(self, name: str, *, weight: float | None = None,
                          quota: float | None = None) -> None:
        """Re-tune a live lane: ``weight`` replaces its SWRR weight,
        ``quota`` its QPS cap (``math.inf`` lifts the cap; ``None`` leaves
        either unchanged).  Takes effect at the next pump turn."""
        with self._lock:
            lane = self._lane(name)
            if weight is not None:
                if weight <= 0.0:
                    raise ValueError(f"weight must be > 0, got {weight}")
                lane.weight = float(weight)
            if quota is not None:
                if quota <= 0.0:
                    raise ValueError(f"quota must be > 0 requests/s, got {quota}")
                lane.quota = None if math.isinf(quota) else float(quota)
                lane.tokens = min(lane.tokens, float(self.max_batch))

    def remove_tenant(self, name: str) -> None:
        """Drain and deregister a tenant: its queued and in-flight requests
        are answered first, and its state's writer barrier is detached."""
        with self._lock:
            self._drain_tenant(name)
            lane = self._lanes.pop(name)
            lane.engine.on_mutate = None

    @property
    def tenants(self) -> tuple:
        return tuple(self._lanes)

    def lane_stats(self, tenant: str | None = None) -> dict:
        """Per-tenant counters: submitted / completed / shed / queued."""
        lane = self._lane(tenant)
        return dict(lane.stats, queued=len(lane.heap))

    def _lane(self, tenant: str | None) -> _TenantLane:
        if tenant is None:
            if len(self._lanes) != 1:
                raise ValueError(f"tenant= required: frontend routes "
                                 f"{len(self._lanes)} tenants {tuple(self._lanes)}")
            return next(iter(self._lanes.values()))
        try:
            return self._lanes[tenant]
        except KeyError:
            raise ValueError(f"unknown tenant {tenant!r}; registered: "
                             f"{tuple(self._lanes)}") from None

    # -- request ingress ----------------------------------------------------

    def submit(self, context_ids, context_weights=None, *, k: int = 10,
               deadline: float | None = None,
               tenant: str | None = None) -> PendingQuery:
        """Enqueue one request; returns its ``PendingQuery``.

        ``context_ids``: (n_context_slots,) ints, one query's context.
        ``k``: ``1 <= k <= max_k``.  ``deadline``: absolute frontend-clock
        time after which the request fails rather than being served late.
        ``tenant``: its lane (optional with one tenant).  Non-blocking;
        raises ``Overloaded`` when admission sheds, ``Degraded`` while the
        tenant's breaker is open, ``Unservable`` after ``close()``, and
        ``ValueError`` for a malformed request, including a context id
        outside its field's vocabulary (unlike the reference, which takes
        it: on the card the lookup would read outside the arena)."""
        with self._lock:
            if self._closed:
                raise Unservable("frontend is closed", tenant=tenant)
            lane = self._lane(tenant)
            ctx = np.asarray(context_ids, np.int32).reshape(-1)
            if ctx.shape[0] != lane.n_ctx:
                raise ValueError(f"context has {ctx.shape[0]} slots, "
                                 f"layout expects {lane.n_ctx}")
            bad = np.flatnonzero((ctx < 0) | (ctx >= lane.ctx_vocab))
            if bad.size:
                raise ValueError(f"context id {ctx[bad[0]]} at slot {bad[0]} outside "
                                 f"[0, {lane.ctx_vocab[bad[0]]})")
            w = (np.ones(ctx.shape, np.float32) if context_weights is None
                 else np.asarray(context_weights, np.float32).reshape(-1))
            if w.shape != ctx.shape:
                raise ValueError(f"context_weights shape {w.shape} != "
                                 f"context shape {ctx.shape}")
            if not 1 <= k <= self.max_k:
                raise ValueError(f"k={k} outside [1, max_k={self.max_k}]")
            now = self.clock()
            if not self._breaker_allows(lane, now):
                lane.stats["shed"] += 1
                self.stats["degraded"] += 1
                raise Degraded(f"tenant {lane.name!r} circuit breaker open after "
                               f"{lane.fails} consecutive dispatch failures",
                               tenant=lane.name)
            self._admit(lane, deadline, now)
            req = PendingQuery(self, lane.name, ctx, w, int(k), deadline, now)
            heapq.heappush(lane.heap, (math.inf if deadline is None else deadline,
                                       self._seq, req))
            self._seq += 1
            lane.arrivals.append(req)
            lane.stats["submitted"] += 1
            self.stats["submitted"] += 1
            if self.auto_pump:
                self.pump(now)
        return req

    def _admit(self, lane, deadline, now) -> None:
        """Admission control: raise ``Overloaded`` instead of queueing a
        request the frontend cannot serve in time."""
        if self.admit_depth is not None and len(lane.heap) >= self.admit_depth:
            lane.stats["shed"] += 1
            self.stats["shed"] += 1
            raise Overloaded(f"tenant {lane.name!r} queue depth {len(lane.heap)} >= "
                             f"admit_depth {self.admit_depth}", tenant=lane.name)
        if self.admit_deadlines and deadline is not None and self._svc is not None:
            backlog = len(lane.heap) // self.max_batch + len(self._window) + 1
            eta = now + self.max_wait + backlog * self._svc
            if eta > deadline:
                lane.stats["shed"] += 1
                self.stats["shed"] += 1
                raise Overloaded(f"tenant {lane.name!r}: predicted completion "
                                 f"{eta - now:.4f}s out exceeds deadline "
                                 f"{deadline - now:.4f}s out", tenant=lane.name)

    # -- circuit breaker + bounded retry -------------------------------------

    def _breaker_allows(self, lane, now) -> bool:
        """The breaker gates submits only (accepted requests still
        dispatch).  An open breaker half-opens after the cooldown; the next
        accepted request is the probe."""
        if lane.breaker == "open":
            if now - lane.opened_at >= self.breaker_cooldown:
                lane.breaker = "half_open"
                return True
            return False
        return True

    def _breaker_failure(self, lane, now) -> None:
        """An exhausted dispatch: trip at the threshold, and re-open at
        once if the half-open probe failed."""
        if self.breaker_threshold is None:
            return
        lane.fails += 1
        if lane.breaker == "half_open" or lane.fails >= self.breaker_threshold:
            if lane.breaker != "open":
                lane.stats["trips"] += 1
            lane.breaker = "open"
            lane.opened_at = now

    def _breaker_success(self, lane) -> None:
        lane.fails = 0
        if lane.breaker != "closed":
            lane.breaker = "closed"
            lane.opened_at = None

    def _with_retries(self, dispatch, what: str, tenants: tuple):
        """Run ``dispatch()`` with up to ``retries`` re-dispatches of the
        identical batch of ``tenants``' requests, backing off
        ``retry_backoff * 2**i`` times a seeded jitter in [0.5, 1.5) between
        attempts; raises ``DispatchFailed`` when they are spent.  While it
        runs the batch counts in ``_retrying`` for each of ``tenants``; its
        end, in success or failure, wakes the blocking paths waiting for
        that count (``_await_retries``)."""
        attempts = self.retries + 1
        self._retrying.update(tenants)
        try:
            for i in range(attempts):
                try:
                    return dispatch()
                except Exception as e:            # noqa: BLE001 - typed below
                    if i + 1 >= attempts:
                        raise DispatchFailed(f"{what} failed after {attempts} attempts: {e}",
                                             tenant=tenants[0], attempts=attempts) from e
                    self.stats["retries"] += 1
                    pause = self.retry_backoff * (2.0 ** i) * (0.5 + self._rng.random())
                    if pause > 0.0:
                        # Condition.wait, not time.sleep: the lock is held
                        # here, and wait() releases it for the pause
                        self._retry_wait.wait(timeout=pause)
        finally:
            self._retrying.subtract(tenants)
            self._retry_wait.notify_all()

    def _await_retries(self, names) -> None:
        """Wait (releasing the lock) until no dispatch of ``names``' requests
        is retrying.  Such a batch's requests are in neither a queue nor the
        window, so a barrier that resolved the window without waiting would
        return with them pending.  The reference's drain does not wait."""
        while any(self._retrying[n] > 0 for n in names):
            self._retry_wait.wait()

    def _probe(self, site: str) -> None:
        if self._injector is not None:
            self._injector.check(site)

    def _launch(self, lane, ctx, w, k_pad):
        """Dispatch one assembled micro-batch of one tenant, with retries."""
        def dispatch():
            self._probe("dispatch")
            return lane.engine.topk(ctx, k_pad, w)
        return self._with_retries(dispatch, f"tenant {lane.name!r}: micro-batch dispatch",
                                  (lane.name,))

    # -- batching policy ----------------------------------------------------

    def _has_quota(self, lane, now) -> bool:
        """Refill the lane's token bucket to ``now`` and report whether it
        can afford a scheduler turn.  No quota: always."""
        if lane.quota is None:
            return True
        if lane.tok_t is None:
            lane.tok_t = now
        dt = now - lane.tok_t
        if dt > 0.0:
            lane.tokens = min(float(self.max_batch), lane.tokens + dt * lane.quota)
            lane.tok_t = now
        return lane.tokens >= 1.0

    def _consume_quota(self, lane, n: int) -> None:
        """Pay n dispatched requests; the balance may go negative, down to
        ``-max_batch``."""
        if lane.quota is not None:
            lane.tokens = max(lane.tokens - n, -float(self.max_batch))

    def _pick(self, pred, now, *, respect_quota: bool = True) -> _TenantLane | None:
        """One SWRR turn over the lanes passing ``pred`` (and holding
        tokens, on the scheduler's path): each candidate earns its weight,
        the richest wins and pays back the candidates' total.  Ties go to
        registration order.  None when no lane is eligible."""
        eligible = []
        for lane in self._lanes.values():
            if not pred(lane):
                continue
            if respect_quota and not self._has_quota(lane, now):
                lane.stats["quota_deferred"] += 1
                continue
            eligible.append(lane)
        if not eligible:
            return None
        total = 0.0
        for lane in eligible:
            lane.credit += lane.weight
            total += lane.weight
        best = max(eligible, key=lambda ln: ln.credit)
        best.credit -= total
        return best

    def _pack_key(self, lane):
        """Lanes with equal keys may share one ``fused_topk`` launch: same
        runtime, same context width, same slab type (one launch reads one
        type), and on a mesh the same local capacity (one ``k_loc`` for
        every segment of a shard's launch).  None: not ready."""
        eng = lane.engine
        if getattr(eng, "cache", None) is None:
            return None
        local = None if eng.runtime.mesh is None else eng.local_capacity
        return (id(eng.runtime), lane.n_ctx, eng.cache.dtype, local)

    @property
    def pack_max(self) -> int:
        """The most segments a fused launch takes now: the tenant count
        padded to a power of two, within the kernel's limit."""
        return min(next_pow2(len(self._lanes)), MAX_SEGMENTS)

    def _collect_group(self, first, pred, now, *,
                       respect_quota: bool = True) -> list[_TenantLane]:
        """Grow a packed group around the lane a turn just picked: up to
        ``MAX_SEGMENTS - 1`` further SWRR turns among lanes passing ``pred``
        with ``first``'s pack key.  Every member pays a real turn, so the
        fairness schedule is unchanged.  ``[first]`` when not packing."""
        group = [first]
        if not self.pack or len(self._lanes) < 2:
            return group
        key = self._pack_key(first)
        if key is None:
            return group
        names = {first.name}
        while len(group) < MAX_SEGMENTS:
            mate = self._pick(lambda ln: (ln.name not in names and pred(ln)
                                          and self._pack_key(ln) == key),
                              now, respect_quota=respect_quota)
            if mate is None:
                break
            names.add(mate.name)
            group.append(mate)
        return group

    def _oldest_age(self, lane, now) -> float | None:
        """Age of the lane's oldest queued request (arrival order)."""
        while lane.arrivals and lane.arrivals[0]._taken:
            lane.arrivals.popleft()
        if not lane.arrivals:
            return None
        return now - lane.arrivals[0].submit_time

    def _dispatch_turn(self, group, now: float, n_first: int | None = None) -> None:
        """Dispatch a lane a turn picked, or its packed group: one
        micro-batch (at most ``max_batch``) from each member; a lone lane
        takes ``n_first`` requests when given."""
        if len(group) == 1:
            lane = group[0]
            n = self._batch_of(lane) if n_first is None else n_first
            self._dispatch(lane, self._take(lane, n), now)
        else:
            self._dispatch_group([(ln, self._take(ln, self._batch_of(ln))) for ln in group],
                                 now)

    def _batch_of(self, lane) -> int:
        return min(len(lane.heap), self.max_batch)

    def pump(self, now: float | None = None) -> int:
        """Advance the frontend: dispatch every full ``max_batch`` bucket
        (SWRR turns, quota-gated), then each lane's partial tail once its
        oldest request is older than ``max_wait``.  With
        ``autoscale_high``, first give every slab its occupancy check.
        Non-blocking unless the window must evict.  Returns the number of
        turns dispatched."""
        with self._lock:
            if now is None:
                now = self.clock()
            if self.autoscale_high is not None:
                for lane in self._lanes.values():
                    if lane.engine.maybe_autoscale(self.autoscale_high):
                        self.stats["autoscales"] += 1
            n = 0
            full = lambda ln: len(ln.heap) >= self.max_batch  # noqa: E731
            while True:
                lane = self._pick(full, now)
                if lane is None:
                    break
                self._dispatch_turn(self._collect_group(lane, full, now), now)
                n += 1
            aged = lambda ln: (self._oldest_age(ln, now) or -1.0) >= self.max_wait  # noqa: E731
            for lane in list(self._lanes.values()):
                if not aged(lane):
                    continue
                if not self._has_quota(lane, now):
                    lane.stats["quota_deferred"] += 1
                    continue
                self._dispatch_turn(self._collect_group(lane, aged, now), now,
                                    n_first=len(lane.heap))
                n += 1
            return n

    def flush(self) -> int:
        """Dispatch everything queued, regardless of age, one micro-batch
        per tenant per SWRR turn (async: resolves nothing).  Quotas are
        bypassed: flush backs the blocking paths (``result``, ``drain``,
        ``close``).  Returns the number of turns dispatched."""
        with self._lock:
            now = self.clock()
            n = 0
            queued = lambda ln: len(ln.heap) > 0  # noqa: E731
            while True:
                lane = self._pick(queued, now, respect_quota=False)
                if lane is None:
                    break
                self._dispatch_turn(
                    self._collect_group(lane, queued, now, respect_quota=False), now)
                n += 1
            return n

    def drain(self) -> None:
        """Flush and resolve every tenant's queued and in-flight batches
        (blocking): the full-stop barrier.  When it returns, every request
        submitted before it is done, including those of a batch that
        another thread's dispatch was retrying."""
        with self._lock:
            for name in list(self._lanes):
                self._drain_tenant(name)

    def _drain_tenant(self, name: str) -> None:
        """The per-tenant writer barrier: dispatch this lane's queue, wait
        for its retrying dispatches, and resolve its in-flight batches
        (blocking), until none of the three is left; other tenants' queues
        and windows are untouched."""
        with self._lock:
            self.stats["drains"] += 1
            lane = self._lanes[name]
            while True:
                now = self.clock()
                while lane.heap:
                    self._dispatch(lane, self._take(lane, self._batch_of(lane)), now)
                self._await_retries((name,))
                mine = [fl for fl in self._window if fl.tenant == name]
                if not mine and not lane.heap and not self._retrying[name]:
                    return
                self._window = collections.deque(fl for fl in self._window
                                                 if fl.tenant != name)
                for fl in mine:
                    self._resolve(fl)

    # -- writer entry points (barrier + mutation under the lock) ------------

    def add_items(self, ids, weights=None, *, tenant: str | None = None):
        """``engine.add_items`` on the tenant's state under the frontend
        lock; returns the new slots."""
        with self._lock:
            return self._lane(tenant).engine.add_items(ids, weights)

    def remove_items(self, indices, *, tenant: str | None = None) -> None:
        """``engine.remove_items`` under the frontend lock."""
        with self._lock:
            self._lane(tenant).engine.remove_items(indices)

    def update_items(self, indices, ids, weights=None, *,
                     tenant: str | None = None) -> None:
        """``engine.update_items`` under the frontend lock."""
        with self._lock:
            self._lane(tenant).engine.update_items(indices, ids, weights)

    def refresh(self, params, step=None, *, tenant: str | None = None) -> None:
        """``engine.refresh`` (model swap) under the frontend lock."""
        with self._lock:
            self._lane(tenant).engine.refresh(params, step=step)

    def maybe_refresh(self, manager, template, select=lambda t: t, *,
                      tenant: str | None = None) -> bool:
        """``engine.maybe_refresh`` (checkpoint poll and swap) under the
        frontend lock."""
        with self._lock:
            return self._lane(tenant).engine.maybe_refresh(manager, template, select=select)

    def _take(self, lane, m: int) -> list[PendingQuery]:
        out = []
        for _ in range(m):
            _, _, req = heapq.heappop(lane.heap)
            req._taken = True
            out.append(req)
        return out

    # -- dispatch (async) ---------------------------------------------------

    def _k_dispatch(self, lane, reqs) -> int:
        """The batch's K bucket: next_pow2(max served K), lowered while it
        exceeds the lane's live item count (never below the max K)."""
        k_max = max(r.served_k for r in reqs)
        k_pad = next_pow2(k_max)
        n_live = lane.engine.n_items
        while k_pad > n_live:
            k_pad //= 2
        return max(k_pad, k_max)

    def _filter_live(self, lane, reqs: list[PendingQuery],
                     now: float) -> list[PendingQuery]:
        """Triage one tenant's taken requests before scoring: fail those
        past their deadline (``DeadlineExceeded``) and those whose k now
        exceeds the live corpus (``Unservable``), each alone; then, with
        the lane's queue still at ``pressure_depth``, clamp the served K
        of the rest to ``pressure_k``."""
        n_live_items = lane.engine.n_items
        live = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                self.stats["expired"] += 1
                r._fail(DeadlineExceeded(
                    f"deadline exceeded after {(now - r.submit_time) * 1e3:.2f} ms "
                    f"in queue", tenant=lane.name), now)
            elif r.k > n_live_items:
                self.stats["failed"] += 1
                lane.stats["failed"] += 1
                r._fail(Unservable(f"k={r.k} exceeds tenant {lane.name!r}'s live "
                                   f"corpus ({n_live_items} items)", tenant=lane.name),
                        now)
            else:
                live.append(r)
        if (live and self.pressure_depth is not None
                and len(lane.heap) >= self.pressure_depth):
            for r in live:
                if r.served_k > self.pressure_k:
                    r.served_k = self.pressure_k
                    r.degraded = True
                    self.stats["clamped"] += 1
        return live

    @staticmethod
    def _assemble(live: list[PendingQuery], bq: int):
        """Stack one tenant's rows to the ``bq`` bucket, padding with a
        real row (rows are scored independently)."""
        pad = bq - len(live)
        ctx = np.stack([r._ctx for r in live] + [live[0]._ctx] * pad)
        w = np.stack([r._w for r in live] + [live[0]._w] * pad)
        return ctx, w

    def _fail_all(self, pairs, err, now) -> None:
        for lane, live in pairs:
            for r in live:
                self.stats["failed"] += 1
                lane.stats["failed"] += 1
                r._fail(err, now)
            self._breaker_failure(lane, now)

    def _dispatch(self, lane, reqs: list[PendingQuery], now: float) -> None:
        """Triage, assemble and launch one tenant's micro-batch (async)."""
        self._consume_quota(lane, len(reqs))
        live = self._filter_live(lane, reqs, now)
        if live:
            self._dispatch_live(lane, live, now)

    def _dispatch_live(self, lane, live: list[PendingQuery], now: float) -> None:
        bq = min(next_pow2(len(live)), self.max_batch)
        ctx, w = self._assemble(live, bq)
        k_pad = self._k_dispatch(lane, live)
        try:
            # returns once the kernels are queued: the card scores while
            # the host assembles the next micro-batch
            vals, idx = self._launch(lane, ctx, w, k_pad)
        except DispatchFailed as e:
            self._fail_all([(lane, live)], e, now)
            return
        self._breaker_success(lane)
        self.stats["dispatches"] += 1
        self.stats["dispatched_rows"] += bq
        self.stats["padded_rows"] += bq - len(live)
        self._window.append(_InFlight(live, vals, idx, lane.name, ctx, w, k_pad))
        self._evict()

    def _evict(self) -> None:
        while len(self._window) > self.inflight:
            self._resolve_oldest()

    def _dispatch_group(self, pairs, now: float) -> None:
        """Launch a packed group as one ``fused_topk`` dispatch: triage each
        lane, bucket the group to a common Bq and K, pad the segment count
        to a power of two by repeating the last segment, and enter each
        member's batch into the window as a slice of one
        ``_PackedLaunch``.  One surviving lane takes the single-tenant
        path; a K bucket above some member's live corpus unpacks the
        group into per-tenant dispatches."""
        live_pairs = []
        for lane, reqs in pairs:
            self._consume_quota(lane, len(reqs))
            live = self._filter_live(lane, reqs, now)
            if live:
                live_pairs.append((lane, live))
        if not live_pairs:
            return
        if len(live_pairs) == 1:
            self._dispatch_live(*live_pairs[0], now)
            return
        bq = min(max(next_pow2(len(live)) for _, live in live_pairs), self.max_batch)
        k_pad = max(self._k_dispatch(lane, live) for lane, live in live_pairs)
        if any(k_pad > lane.engine.n_items for lane, _ in live_pairs):
            for lane, live in live_pairs:
                self._dispatch_live(lane, live, now)
            return
        rows = [self._assemble(live, bq) for _, live in live_pairs]
        s_pad = next_pow2(len(live_pairs)) - len(live_pairs)
        ctx = np.stack([c for c, _ in rows] + [rows[-1][0]] * s_pad)
        w = np.stack([wt for _, wt in rows] + [rows[-1][1]] * s_pad)
        states = tuple([lane.engine for lane, _ in live_pairs]
                       + [live_pairs[-1][0].engine] * s_pad)
        names = tuple(lane.name for lane, _ in live_pairs)

        def dispatch():
            self._probe("dispatch")
            return _PackedLaunch(*fused_topk(states, ctx, k_pad, w))
        try:
            launch = self._with_retries(dispatch, f"fused dispatch for tenants {names}",
                                        names)
        except DispatchFailed as e:
            self._fail_all(live_pairs, e, now)
            return
        self.stats["fused_dispatches"] += 1
        self.stats["fused_segments"] += len(live_pairs)
        for seg, (lane, live) in enumerate(live_pairs):
            self._breaker_success(lane)
            self.stats["dispatches"] += 1
            self.stats["dispatched_rows"] += bq
            self.stats["padded_rows"] += bq - len(live)
            self._window.append(_InFlight(live, None, None, lane.name, rows[seg][0],
                                          rows[seg][1], k_pad, launch=launch, seg=seg))
        self._evict()

    # -- resolution (the only blocking step) --------------------------------

    def _resolve(self, fl: _InFlight) -> None:
        t_read = self.clock()
        lane = self._lanes.get(fl.tenant)
        try:
            self._probe("resolve")
            if fl.launch is not None:
                # a packed batch: the first member pays the one blocking
                # read of the shared launch, the rest slice its host copy
                all_vals, all_idx = fl.launch.read()
                vals, idx = all_vals[fl.seg], all_idx[fl.seg]
            else:
                vals, idx = _host(fl.vals), _host(fl.idx)
        except Exception:               # noqa: BLE001 - a deferred device fault
            # re-dispatch the same assembled batch through the same kernel
            # and read it at once; only spent retries fail the requests
            now = self.clock()
            try:
                if lane is None:
                    raise DispatchFailed(f"tenant {fl.tenant!r} removed with batch "
                                         f"in flight", tenant=fl.tenant)
                vals, idx = self._launch(lane, fl.ctx, fl.w, fl.k_pad)
                vals, idx = _host(vals), _host(idx)
            except DispatchFailed as e:
                for r in fl.requests:
                    self.stats["failed"] += 1
                    if lane is not None:
                        lane.stats["failed"] += 1
                    r._fail(e, now)
                if lane is not None:
                    self._breaker_failure(lane, now)
                return
            if lane is not None:
                self._breaker_success(lane)
        now = self.clock()
        # the admission EWMA samples the time this read spent blocked on
        # the card, not the time since dispatch
        dt = now - t_read
        self._svc = dt if self._svc is None else 0.3 * dt + 0.7 * self._svc
        for row, r in enumerate(fl.requests):
            r._finish(vals[row, :r.served_k], idx[row, :r.served_k], now)
            self.stats["completed"] += 1
            if lane is not None:
                lane.stats["completed"] += 1

    def resolve(self, max_batches: int | None = None) -> int:
        """Resolve up to ``max_batches`` of the oldest in-flight batches
        (all when None), blocking on their reads.  Returns the count."""
        with self._lock:
            n = 0
            while self._window and (max_batches is None or n < max_batches):
                self._resolve_oldest()
                n += 1
            return n

    def _resolve_oldest(self) -> None:
        self._resolve(self._window.popleft())

    def _resolve_until(self, req: PendingQuery) -> None:
        with self._lock:
            if not req.done():
                self.flush()
            while not req.done() and self._window:
                self._resolve_oldest()
            if not req.done():
                self._await_retries((req.tenant,))
                while not req.done() and self._window:
                    self._resolve_oldest()
            if not req.done():
                raise Unservable("request neither queued nor in flight",
                                 tenant=req.tenant)

    # -- warmup -------------------------------------------------------------

    def warmup(self, context_ids, context_weights=None,
               tenant: str | None = None) -> int:
        """One dispatch on one tenant at the largest Bq and K bucket, with
        a representative context (see the module docstring for why one
        is enough).  Returns the number of dispatches.  Call after the
        state's ``refresh``."""
        lane = self._lane(tenant)
        return lane.engine.warmup_grid(context_ids, context_weights,
                                       max_batch=self.max_batch, max_k=self.max_k)

    def warmup_packed(self, context_ids, context_weights=None,
                      tenant: str | None = None) -> int:
        """One fused dispatch at the largest segment count (``pack_max``),
        Bq and K bucket, with one tenant's state repeated.  Returns the
        number of dispatches."""
        eng = self._lane(tenant).engine
        ctx = np.asarray(context_ids, np.int32).reshape(-1)
        w = (np.ones(ctx.shape, np.float32) if context_weights is None
             else np.asarray(context_weights, np.float32).reshape(-1))
        S, bq = self.pack_max, self.max_batch
        k = min(next_pow2(self.max_k), 1 << (eng.n_items.bit_length() - 1))
        fused_topk((eng,) * S, np.tile(ctx, (S, bq, 1)), k, np.tile(w, (S, bq, 1)))
        return 1

    # -- background pump + watchdog -----------------------------------------

    def start_pump(self, interval: float = 1e-3, *,
                   watchdog: float | None = None) -> None:
        """Run ``pump`` on a daemon thread every ``interval`` seconds.  With
        ``watchdog=t`` a second daemon thread watches the pump's heartbeat
        and, after t seconds of silence, orphans the stalled generation
        and starts a fresh pump (``stats["pump_restarts"]``).  Idempotent
        while running."""
        with self._lock:
            if self._closed:
                raise Unservable("frontend is closed")
            if self._pump_run:
                return
            self._pump_run = True
            self._pump_interval = float(interval)
            self._watchdog_timeout = watchdog
            self._pump_gen += 1
            self._spawn_pump(self._pump_gen)
            if watchdog is not None:
                t = threading.Thread(target=self._watchdog_loop, daemon=True,
                                     name="frontend-watchdog")
                self._watchdog_thread = t
                t.start()

    def stop_pump(self) -> None:
        """Stop the pump and watchdog threads and join them briefly.  Safe
        when never started; queued work is not flushed (``drain``,
        ``close``)."""
        with self._lock:
            self._pump_run = False
            self._pump_gen += 1          # orphan any live generation
            threads = [self._pump_thread, self._watchdog_thread]
            self._pump_thread = self._watchdog_thread = None
        me = threading.current_thread()
        for t in threads:
            if t is not None and t is not me and t.is_alive():
                t.join(timeout=1.0)

    def _spawn_pump(self, gen: int) -> None:
        self._pump_beat = time.monotonic()
        t = threading.Thread(target=self._pump_loop, args=(gen,), daemon=True,
                             name=f"frontend-pump-{gen}")
        self._pump_thread = t
        t.start()

    def _pump_loop(self, gen: int) -> None:
        while True:
            with self._lock:
                if not self._pump_run or gen != self._pump_gen:
                    return               # stopped, or the watchdog moved on
            self._pump_beat = time.monotonic()
            try:
                # outside the lock: a stalled pump must not block submits,
                # nor the watchdog that is about to replace it
                self._probe("pump")
                self.pump()
            except Exception as e:       # noqa: BLE001 - a lost tick, counted
                self.stats["pump_errors"] += 1
                self.last_pump_error = e
            time.sleep(self._pump_interval)

    def _watchdog_loop(self) -> None:
        timeout = self._watchdog_timeout
        while True:
            time.sleep(timeout / 2)
            with self._lock:
                if not self._pump_run:
                    return
                if time.monotonic() - self._pump_beat >= timeout:
                    self._pump_gen += 1
                    self.stats["pump_restarts"] += 1
                    self._spawn_pump(self._pump_gen)

    # -- health + graceful shutdown -----------------------------------------

    def health(self) -> dict:
        """Readiness probe (cheap).  Top level: ``ready``, ``closed``,
        ``degraded`` (some breaker not closed, or a tenant's last checkpoint
        poll found a bad push), ``queue_depth``,
        ``inflight_depth``, ``pump`` (running, restarts) and ``packing``
        (fused dispatches, segments, mean group).  Per tenant: breaker and
        consecutive failures, trips, weight, quota, queued, live items,
        model step, seconds since the last refresh, the last
        ``maybe_refresh`` error (None when its last swap was clean), and
        ``kernel_degraded`` (always False in the port: a failed launch is
        retried through the same kernel, never replaced)."""
        with self._lock:
            now = time.monotonic()       # refresh stamps are time.monotonic
            lanes = {}
            for name, lane in self._lanes.items():
                eng = lane.engine
                rt = eng.last_refresh_time
                lanes[name] = {
                    "breaker": lane.breaker,
                    "consecutive_failures": lane.fails,
                    "trips": lane.stats["trips"],
                    "weight": lane.weight,
                    "quota": lane.quota,
                    "quota_deferred": lane.stats["quota_deferred"],
                    "queued": len(lane.heap),
                    "n_items": eng.n_items,
                    "model_step": eng.model_step,
                    "refresh_age": None if rt is None else now - rt,
                    "last_refresh_error": getattr(eng, "last_refresh_error", None),
                    "kernel_degraded": bool(getattr(eng, "kernel_degraded", False)),
                }
            pump = self._pump_thread
            fused = self.stats["fused_dispatches"]
            return {
                "ready": not self._closed,
                "closed": self._closed,
                "degraded": any(v["breaker"] != "closed" or v["last_refresh_error"] is not None
                                for v in lanes.values()),
                "queue_depth": self.queue_depth,
                "inflight_depth": len(self._window),
                "pump": {"running": pump is not None and pump.is_alive(),
                         "restarts": self.stats["pump_restarts"]},
                "packing": {
                    "enabled": self.pack,
                    "pack_max": self.pack_max,
                    "fused_dispatches": fused,
                    "fused_segments": self.stats["fused_segments"],
                    "mean_group": self.stats["fused_segments"] / fused if fused else 0.0,
                },
                "tenants": lanes,
            }

    def close(self) -> None:
        """Graceful shutdown: stop the pump threads, resolve every in-flight
        batch to its real result, fail every queued request with
        ``Unservable``, and detach every writer barrier.  Later submits
        raise ``Unservable``; idempotent."""
        self.stop_pump()
        with self._lock:
            if self._closed:
                return
            self._closed = True
            # a batch another thread is retrying enters the window (or
            # fails) before the window is resolved below
            self._await_retries(tuple(self._lanes))
            now = self.clock()
            for lane in self._lanes.values():
                while lane.heap:
                    _, _, req = heapq.heappop(lane.heap)
                    req._taken = True
                    self.stats["failed"] += 1
                    lane.stats["failed"] += 1
                    req._fail(Unservable("frontend closed with request still queued",
                                         tenant=lane.name), now)
                lane.arrivals.clear()
            while self._window:
                self._resolve_oldest()
            for lane in self._lanes.values():
                lane.engine.on_mutate = None

    # -- convenience --------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        """Queued requests across every tenant lane."""
        return sum(len(lane.heap) for lane in self._lanes.values())

    @property
    def inflight_depth(self) -> int:
        return len(self._window)

    @property
    def occupancy(self) -> float:
        """Real-request fraction of dispatched rows (1.0: no padding)."""
        rows = self.stats["dispatched_rows"]
        return 1.0 if rows == 0 else 1.0 - self.stats["padded_rows"] / rows

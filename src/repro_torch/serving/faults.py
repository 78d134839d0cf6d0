"""Deterministic, seeded fault injection for the serving stack.  Port of
``repro.serving.faults``: the same sites, schedules and seeded stream, so
the same seed and the same ``arm`` calls fire at the same calls in both
packages.

A chaos scenario should be a SCRIPT, not a coin flip: the same seed and
the same arm() calls must produce the same faults at the same call
sites, so a failing chaos run reproduces under ``pytest -x`` and a CI
gate on recovery behavior is meaningful.  ``FaultInjector`` is that
script's arming surface: production code paths carry cheap, optional
``injector.check(site)`` probes, and a scenario arms each site with a
schedule (fail the next N calls, fail at rate p from the seeded stream,
delay by d seconds, skew the clock by s) — nothing fires unless armed,
and an unarmed ``check`` is a dict miss.

Sites wired through the stack:

    site        checked by                        models
    --------    ------------------------------    -------------------------
    dispatch    QueryFrontend micro-batch launch  a failed/slow device
                (and re-launch on resolve)        dispatch (CUDA error,
                                                  device loss, RPC timeout)
    resolve     QueryFrontend result              a deferred device error
                materialization                   surfacing at read time
    kernel      CorpusState score / topk and      a kernel-launch failure
                fused_topk, before the kernel     (build, load or launch);
                                                  the port has no fallback,
                                                  so it reaches the caller
    alloc       CorpusState slab growth           an OOM growing the slab
    write       CorpusState mutation scatter      a mid-flight churn write
                                                  failure
    pump        QueryFrontend pump loop           a stalled writer/pump
                (outside the lock)                thread (GC pause, NFS
                                                  hang, deadlocked hook)
    clock       ``wrap_clock`` time source        deadline-clock skew
    rpc_accept  RpcServer connection accept       a listener refusing /
                                                  dropping a new client
    rpc_read    RpcServer per-frame read          a connection dying (or
                                                  stalling: ``delay=``)
                                                  mid-request
    rpc_write   RpcServer reply write             a client gone before
                                                  its reply could be
                                                  written back

Arming semantics — ``arm(site, count=, rate=, after=, delay=, error=)``:

  * ``after=k``  — the first k calls at the site pass untouched;
  * ``count=n``  — at most n faults fire, then the site auto-disarms
    (``count=None`` = keep firing until ``disarm``);
  * ``rate=p``   — each eligible call fires with probability p from the
    injector's SEEDED stream (``rate=None`` = fire every eligible call);
  * ``delay=d``  — a firing call sleeps d seconds first (a SLOW fault);
  * ``error=e``  — a firing call raises e (class or instance) after any
    delay.  Default: raise ``InjectedFault`` — unless ``delay>0`` was
    given without an error, in which case the fault is slow-only.

Clock skew is armed separately (``arm("clock", skew=s)``) and read by
the callable ``wrap_clock`` returns — hand that to ``QueryFrontend
(clock=...)`` and armed skew shifts every deadline/age decision.

Checkpoint faults are PHYSICAL, not schedule-based: ``corrupt_checkpoint``
overwrites a landed step's ``arrays.npz`` with seeded garbage and
``torn_write_checkpoint`` truncates it mid-array (manifest intact, the
on-disk shape of a writer killed mid-write) — both make the step fail
checksum validation exactly the way a real bad push does, driving the
``RefreshFailed`` / serve-last-good path.

Everything is thread-safe (the pump thread and the submit thread probe
concurrently) and dependency-light; ``fired(site)``/``calls(site)`` and
the ``log`` of (site, action) events let scenarios assert exactly what
fired.
"""
from __future__ import annotations

import os
import threading
import time

import numpy as np

from repro_torch.serving.errors import ServingError


# The documented site map: every ``injector.check("<site>")`` literal in
# the serving stack must name one of these (a test walks the package's
# sources for them).  Adding a new probe means adding its site here and
# to the table above.
SITES = frozenset({
    "dispatch",   # QueryFrontend micro-batch launch (and re-launch)
    "resolve",    # QueryFrontend result materialization
    "kernel",     # CorpusState kernel launch
    "alloc",      # CorpusState slab growth
    "write",      # CorpusState mutation scatter
    "pump",       # QueryFrontend background pump tick
    "clock",      # wrap_clock()/skew_value() time skew
    "rpc_accept",  # RpcServer new-connection accept
    "rpc_read",    # RpcServer per-frame request read
    "rpc_write",   # RpcServer reply frame write
})


class InjectedFault(ServingError):
    """The default error an armed fault site raises.  ``site`` names the
    failure domain it fired in.  A ``ServingError`` like every other
    typed serving failure (and still a ``RuntimeError`` through it), so
    chaos runs exercise the exact except-clauses production failures
    take."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at site {site!r}")
        self.site = site


class _Armed:
    __slots__ = ("count", "rate", "after", "delay", "error", "skew",
                 "calls", "fired")

    def __init__(self, count, rate, after, delay, error, skew):
        self.count = count
        self.rate = rate
        self.after = after
        self.delay = delay
        self.error = error
        self.skew = skew
        self.calls = 0
        self.fired = 0


class FaultInjector:
    """Seeded, scriptable fault schedules keyed by site name.

    One injector serves a whole serving stack: pass it to
    ``QueryFrontend(fault_injector=...)`` and ``CorpusState
    (fault_injector=...)`` and every probe draws from the same seeded
    stream in call order — deterministic for a single-threaded scenario,
    reproducible in distribution otherwise.
    """

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._sites: dict[str, _Armed] = {}
        self._lock = threading.Lock()
        self.log: list[tuple[str, str]] = []   # (site, "raise"|"delay")

    # -- arming -------------------------------------------------------------

    def arm(self, site: str, *, count: int | None = None,
            rate: float | None = None, after: int = 0, delay: float = 0.0,
            error=None, skew: float = 0.0) -> None:
        """Arm ``site`` with a fault schedule (see module docstring).
        Re-arming replaces the site's schedule and resets its counters."""
        with self._lock:
            self._sites[site] = _Armed(count, rate, after, delay, error,
                                       skew)

    def disarm(self, site: str) -> None:
        with self._lock:
            self._sites.pop(site, None)

    def clear(self) -> None:
        """Disarm every site (the faults-cleared phase of a scenario)."""
        with self._lock:
            self._sites.clear()

    # -- introspection ------------------------------------------------------

    def active(self, site: str) -> bool:
        with self._lock:
            a = self._sites.get(site)
            return a is not None and (a.count is None or a.fired < a.count)

    def fired(self, site: str) -> int:
        """Faults actually fired at ``site`` (survives disarm/clear only
        via ``log``; this reads the live schedule)."""
        with self._lock:
            a = self._sites.get(site)
            return 0 if a is None else a.fired

    def calls(self, site: str) -> int:
        with self._lock:
            a = self._sites.get(site)
            return 0 if a is None else a.calls

    # -- the probe ----------------------------------------------------------

    def check(self, site: str) -> None:
        """The probe production code calls at a fault site: no-op unless
        the site is armed and its schedule says this call fires; a firing
        call sleeps ``delay`` and/or raises (module docstring)."""
        with self._lock:
            a = self._sites.get(site)
            if a is None:
                return
            a.calls += 1
            if a.calls <= a.after:
                return
            if a.count is not None and a.fired >= a.count:
                return
            if a.rate is not None and self._rng.random() >= a.rate:
                return
            a.fired += 1
            delay, error = a.delay, a.error
            self.log.append((site, "raise" if (error is not None
                                               or delay == 0.0) else "delay"))
        # sleep OUTSIDE the lock: a slow fault must not block other sites
        if delay:
            time.sleep(delay)
        if error is not None:
            raise error if isinstance(error, BaseException) else error(site)
        if delay == 0.0:
            raise InjectedFault(site)

    # -- clock skew ---------------------------------------------------------

    def skew_value(self) -> float:
        """Currently armed clock skew in seconds (0.0 when unarmed)."""
        with self._lock:
            a = self._sites.get("clock")
            return 0.0 if a is None else a.skew

    def wrap_clock(self, clock=time.perf_counter):
        """A time source that adds the armed ``clock``-site skew — hand
        it to ``QueryFrontend(clock=...)`` so a scenario can jump the
        deadline clock forward mid-stream."""
        def skewed() -> float:
            return clock() + self.skew_value()
        return skewed

    # -- physical checkpoint faults -----------------------------------------

    def _step_npz(self, directory: str, step: int | None) -> tuple[int, str]:
        if step is None:
            steps = [int(n.split("_")[1]) for n in os.listdir(directory)
                     if n.startswith("step_") and not n.endswith(".tmp")]
            if not steps:
                raise FileNotFoundError(f"no checkpoints in {directory}")
            step = max(steps)
        return step, os.path.join(directory, f"step_{step:08d}",
                                  "arrays.npz")

    def corrupt_checkpoint(self, directory: str,
                           step: int | None = None) -> int:
        """Overwrite a landed step's ``arrays.npz`` with seeded garbage
        (manifest intact => checksum validation fails).  ``step=None``
        hits the newest step.  Returns the step corrupted."""
        step, npz = self._step_npz(directory, step)
        size = max(os.path.getsize(npz), 16)
        with open(npz, "wb") as f:
            f.write(self._rng.bytes(size))
        self.log.append(("checkpoint", f"corrupt:{step}"))
        return step

    def torn_write_checkpoint(self, directory: str,
                              step: int | None = None) -> int:
        """Truncate a landed step's ``arrays.npz`` to its first half —
        the on-disk shape of a writer killed mid-write after the rename
        (manifest present, payload torn).  Returns the step torn."""
        step, npz = self._step_npz(directory, step)
        with open(npz, "rb") as f:
            data = f.read()
        with open(npz, "wb") as f:
            f.write(data[:len(data) // 2])
        self.log.append(("checkpoint", f"torn:{step}"))
        return step

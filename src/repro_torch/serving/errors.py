"""Typed failure domains for the serving stack.

Every error the serving stack can hand a caller derives from ONE base,
``ServingError``, so "did serving fail?" is a single ``except`` clause
and each subclass names a distinct FAILURE DOMAIN with a distinct
recovery story (the full table lives in docs/robustness.md):

    error              domain                     caller's move
    -----------------  -------------------------  ------------------------
    Overloaded         admission (queue/deadline  back off / route away;
                       infeasible at submit)      nothing was queued
    DeadlineExceeded   the request aged out in    the answer is moot;
                       the queue                  don't retry blindly
    Unservable         the request can never be   fix the request (k >
                       served as posed (or the    live corpus, unknown
                       frontend is closed)        tenant, shutdown)
    DispatchFailed     device dispatch failed     transient infra fault:
                       after bounded retries      safe to resubmit
    RefreshFailed      a model snapshot failed    serving CONTINUES on the
                       validation at hot-swap     last-good snapshot; page
                       time                       the model-push pipeline
    Degraded           the tenant's circuit       fast shed while the
                       breaker is open            breaker cools down

Raising sites guarantee the split: ``Overloaded``/``Degraded`` are raised
at ``submit`` BEFORE the request is queued (a fast reject — the caller
still holds the request); every other subclass resolves an ACCEPTED
request, so "accepted => resolved with a result or a typed error" holds
across every fault the chaos suite injects (tests/test_faults.py).

Compatibility: ``Overloaded`` and ``DeadlineExceeded`` keep their
historical names (they used to be plain ``RuntimeError`` subclasses
defined in ``frontend.py``); ``FrontendError`` — which used to cover both
the unservable-k case and dispatch failures — is now an alias of
``ServingError`` itself, so every pre-existing ``except FrontendError``
still catches exactly what it used to (and more precisely typed).
"""
from __future__ import annotations


class ServingError(RuntimeError):
    """Base of every typed serving failure.

    ``tenant`` (optional) names the lane the failure is scoped to —
    ``None`` for frontend-wide failures.  All subclasses accept it as a
    keyword.
    """

    def __init__(self, message: str = "", *, tenant: str | None = None):
        super().__init__(message)
        self.tenant = tenant


class Overloaded(ServingError):
    """Admission control shed this request at submit: the tenant's queue
    is saturated (``admit_depth``) or the deadline is already infeasible
    (``admit_deadlines``).  Raised BEFORE the request is queued — the
    fast reject that keeps accepted requests inside their deadlines."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed while it was still queued; it was
    failed at dispatch, never scored."""


class Unservable(ServingError):
    """The request cannot be served as posed: its k exceeds the tenant's
    live corpus, the tenant is unknown, or the frontend has been
    closed.  Resubmitting unchanged will fail again."""


class DispatchFailed(ServingError):
    """A micro-batch device dispatch failed after ``retries`` bounded
    re-dispatch attempts (exponential backoff + jitter).  Carried to
    every request in the batch.  ``attempts`` counts dispatch tries
    (first try + retries)."""

    def __init__(self, message: str = "", *, tenant: str | None = None,
                 attempts: int = 1):
        super().__init__(message, tenant=tenant)
        self.attempts = attempts


class RefreshFailed(ServingError):
    """A model hot-swap failed validation: the newest checkpoint step is
    corrupt (or vanished) and no newer valid snapshot could be installed.
    The engine KEEPS SERVING its last-good snapshot — this error reports
    the failed push, it does not interrupt service.  ``step`` is the
    offending checkpoint step and ``signature`` its poll signature
    (``CheckpointManager.step_signature``) at failure time."""

    def __init__(self, message: str = "", *, tenant: str | None = None,
                 step: int | None = None, signature: tuple | None = None):
        super().__init__(message, tenant=tenant)
        self.step = step
        self.signature = signature


class NotReady(ServingError):
    """The engine has no model installed yet: ``refresh()`` (or
    ``maybe_refresh()`` landing a checkpoint) must run before scoring.
    Distinct from ``Unservable`` — the REQUEST is fine, the BACKEND is
    not initialized; retry after the model push lands."""


class Degraded(ServingError):
    """The tenant's circuit breaker is open after consecutive dispatch
    failures: submits shed fast (no queueing) until the cooldown elapses
    and a half-open probe succeeds.  Distinct from ``Overloaded`` so
    callers can tell "healthy but saturated" from "unhealthy backend"."""


# Historical name: pre-robustness code raised FrontendError for both
# dispatch failures and unservable requests.  Aliasing it to the BASE
# keeps every existing ``except FrontendError`` catching what it caught.
FrontendError = ServingError

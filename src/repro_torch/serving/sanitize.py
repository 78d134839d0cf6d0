"""Opt-in runtime sanitizer for the serving stack (``REPRO_SANITIZE=1``).
Port of ``repro.serving.sanitize``.

* ``scoring_guard(device)`` wraps the scoring dispatch in
  ``torch.cuda.set_sync_debug_mode("error")`` when sanitize mode is on
  and ``device`` is a CUDA device, so that a call inside the block that
  makes the host wait for the card (an ``.item()``, a ``.cpu()``, a
  ``nonzero``, a blocking copy from pageable host memory) raises instead
  of silently serialising the pipeline.  It takes the place of the
  reference's ``jax.transfer_guard("disallow")``.  On a CPU device it does
  nothing: there is no device-host transfer to guard.

  torch's sync-debug mode is **process-wide**, where JAX's transfer
  guard is thread-local: while one thread is inside the guard, a
  synchronising call on any other thread raises too.  So only work that
  a lock already serialises against every other CUDA call may sit inside
  it; in the serving stack that is the dispatch, which runs under the
  ``QueryFrontend`` lock (the same lock the blocking read takes).  torch
  calls the mode a prototype that does not detect every synchronising
  operation: it catches those that go through torch (``.item()``,
  ``.cpu()``, a blocking copy), not a sync inside the kernels' own
  libraries.
* ``check_scores()``: host-side NaN / +inf check on materialised results.
  ``-inf`` (and the kernels' ``NEG_INF``) is legal: it is how dead corpus
  slots are masked, so only NaN and ``+inf`` fail.
* ``assert_no_retrace``: the counter assertion the JAX package's demos
  and tests share (baseline an integer ``trace_count`` on enter, assert
  it did not grow on exit), ported as it is.  Nothing in the port is
  traced, so no port object has a ``trace_count``; it works on any
  target that exposes one, or on a callable returning an integer.

``sanitize_enabled()`` is read on every call, so that tests can flip
``REPRO_SANITIZE`` with ``monkeypatch``.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

_TRUTHY = ("1", "true", "on", "yes")


def sanitize_enabled() -> bool:
    """True when ``REPRO_SANITIZE`` is set truthy in the environment."""
    return os.environ.get("REPRO_SANITIZE", "").strip().lower() in _TRUTHY


@contextlib.contextmanager
def scoring_guard(device):
    """Raise on any synchronising CUDA call inside the block, when
    sanitize mode is on and ``device`` is a CUDA device; a no-op
    otherwise.  Restores the previous sync-debug mode on exit.

    Wrap the dispatch only: inputs must already be on the device (the
    engine's ``_ctx_tensors`` runs before the guard), and reading the
    result back (``.cpu()`` on the reply) happens after it."""
    if not sanitize_enabled() or torch.device(device).type != "cuda":
        yield
        return
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)


def check_scores(vals, *, where: str = "scores"):
    """Fail fast on NaN / ``+inf`` in a materialised score array when
    sanitize mode is on; ``-inf`` passes.  Returns ``vals`` unchanged."""
    if sanitize_enabled():
        arr = vals.detach().cpu().numpy() if isinstance(vals, torch.Tensor) else np.asarray(vals)
        if np.isnan(arr).any():
            raise FloatingPointError(f"sanitizer: NaN in {where}")
        if np.isposinf(arr).any():
            raise FloatingPointError(f"sanitizer: +inf in {where}")
    return vals


class assert_no_retrace:
    """Assert that a trace counter stays flat across a block.

    Targets are anything exposing an integer ``trace_count``, or a
    zero-argument callable returning one; several targets share one
    block and their growth is summed.  ``allow=n`` tolerates up to ``n``
    new traces.  On exit with an exception already in flight the check is
    skipped (the original error is the story).  ``new_traces`` is
    readable mid-block."""

    def __init__(self, *targets, allow: int = 0, label: str | None = None):
        if not targets:
            raise ValueError("assert_no_retrace needs at least one target")
        self.targets = targets
        self.allow = allow
        self.label = label
        self.baseline: list[int] | None = None

    @staticmethod
    def _read(target) -> int:
        return int(target() if callable(target) else target.trace_count)

    @property
    def new_traces(self) -> int:
        if self.baseline is None:
            raise ValueError("assert_no_retrace: not entered yet")
        return sum(self._read(t) - b for t, b in zip(self.targets, self.baseline))

    def __enter__(self) -> "assert_no_retrace":
        self.baseline = [self._read(t) for t in self.targets]
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            grew = self.new_traces
            if grew > self.allow:
                where = f" [{self.label}]" if self.label else ""
                raise AssertionError(
                    f"retrace sanitizer{where}: trace_count grew by {grew} inside a "
                    f"zero-retrace block (allow={self.allow})")
        return False

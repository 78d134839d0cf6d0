"""Host-sharded, prefetching data pipeline.  A copy of
``repro.data.pipeline`` (numpy and threads; nothing in it is JAX).

At 1000+ node scale each host feeds only its slice of the global batch:
``ShardedPipeline`` derives a per-(host, step) seed so (a) every host draws
disjoint data deterministically with NO host-to-host coordination, and
(b) restarts resume mid-epoch byte-identically (the seed is a pure function
of the step — data state never needs checkpointing).

Straggler mitigation: producer threads fill a bounded queue; if a batch
misses ``straggler_timeout_s`` the consumer re-serves the previous batch
instead of stalling the step (a documented accuracy/throughput trade used
by large sync-SGD systems), and the event is counted for monitoring.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable


class ShardedPipeline:
    def __init__(
        self,
        make_batch: Callable[[int], dict],   # step -> host-local batch
        prefetch: int = 2,
        straggler_timeout_s: float | None = None,
    ):
        self.make_batch = make_batch
        self.prefetch = prefetch
        self.timeout = straggler_timeout_s
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._next_step = 0
        self._last_batch = None
        self.straggler_events = 0

    def start(self, from_step: int = 0):
        self._next_step = from_step
        self._stop.clear()

        def produce():
            step = from_step
            while not self._stop.is_set():
                batch = self.make_batch(step)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()
        return self

    def get(self) -> tuple[int, dict]:
        if self.timeout is None:
            return self._q.get()
        try:
            step, batch = self._q.get(timeout=self.timeout)
            self._last_batch = batch
            return step, batch
        except queue.Empty:
            # straggler: reuse the previous batch rather than stall the sync
            # step; counted so monitoring can alert on data-path slowness.
            self.straggler_events += 1
            if self._last_batch is None:
                return self._q.get()   # nothing cached yet: block
            return -1, self._last_batch

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


def host_shard_seed(global_seed: int, host_id: int, step: int) -> int:
    """Pure-function seed: disjoint per host, replayable per step."""
    return hash((global_seed, host_id, step)) % (2**63)

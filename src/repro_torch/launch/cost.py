"""The work of a call, counted as it dispatches: the port's counterpart of
``repro.launch.hlo_cost``.

The reference walks compiled HLO, because XLA's own cost analysis counts
a while-loop body once.  In eager PyTorch every operation of every layer
dispatches, so a dispatch mode sees them all, the backward's too (and a
recompute under ``torch.utils.checkpoint``, as the reference's HLO counts
remat).  ``analyze(fn, *args)`` runs ``fn`` under such a mode, best on
``meta`` tensors (``launch.steps`` builds every cell there without
allocating), and returns:

  * ``flops``      - 2 * output * contracted of every product (matmuls,
                     batched matmuls, convolutions, attention), through
                     ``torch.utils.flop_counter``'s formulas: the
                     reference's rule for a ``dot``.  Elementwise work is
                     not counted, as there.
  * ``bytes``      - operand and output bytes of every ATen operation
                     (views and allocations excluded).  Like the
                     reference's figure an upper-bound proxy for device
                     memory traffic; larger than it, since nothing here is
                     fused: an intermediate is written by one operation and
                     read by the next.
  * ``peak_bytes`` - the arguments' bytes (``arg_bytes``, each storage
                     once) plus the highest sum of the live storages the
                     call creates: each storage an operation outputs is
                     counted once, and freed when it dies.
  * ``kernels``    - the work of each hand-written kernel the call
                     reached, by ``ops.KERNELS`` entry point (``_bf16``
                     for a bf16 instantiation): calls, flops and bytes
                     from ``kernels.work.kernel_work``.  On ``meta`` an
                     entry point of ``kernels.ops`` launches nothing and
                     reports its kernel's work by formula to the counter
                     this module pushes on ``kernels.work.COUNTERS``; the
                     reference sees a Pallas call as an opaque custom call
                     and counts none of it, so where a path reaches a
                     kernel this count is the higher.  ``flops`` and
                     ``bytes`` include it.
  * ``collective_bytes`` - None: one card has no collectives (the
                     one-process mesh moves tensors between its shards'
                     devices, uncounted; on one card there are none).
  * ``seconds``    - the host time the count took.
"""
from __future__ import annotations

import collections
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work

__all__ = ["analyze"]

# operations that move no bytes: allocations and aliases
_NO_TRAFFIC = {getattr(torch.ops.aten, name) for name in (
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided", "detach",
    "alias", "lift_fresh", "_unsafe_view", "_reshape_alias", "set_", "resize_")}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    def __init__(self, args):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernels: dict = collections.defaultdict(lambda: {"calls": 0, "flops": 0,
                                                               "bytes": 0})
        self._arg_storages = set()
        self.arg_bytes = 0
        for t in _tensors(args):
            s = t.untyped_storage()
            if s._cdata not in self._arg_storages:
                self._arg_storages.add(s._cdata)
                self.arg_bytes += s.nbytes()
        self._live: dict = {}
        self.live = 0
        self.peak = 0

    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        row = self.kernels[name]
        row["calls"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def _free(self, key) -> None:
        self.live -= self._live.pop(key, 0)

    def _track(self, outs) -> None:
        for t in outs:
            s = t.untyped_storage()
            key = s._cdata
            if key in self._arg_storages or key in self._live:
                continue
            self._live[key] = s.nbytes()
            self.live += self._live[key]
            weakref.finalize(s, self._free, key)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        outs = _tensors(out)
        if not func.is_view and packet not in _NO_TRAFFIC:
            self.bytes += sum(map(_nbytes, _tensors((args, kwargs)))) + sum(map(_nbytes, outs))
        self._track(outs)
        return out


def analyze(fn, *args, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` run once under the counter; its work as the
    module docstring says.  Best on ``meta`` tensors, where nothing is
    computed or allocated and the kernels report their formulas; on a
    real device the operations run and the kernels launch (and report no
    work)."""
    counter = _Counter((args, kwargs))
    t0 = time.perf_counter()
    work.COUNTERS.append(counter)
    try:
        with counter:
            fn(*args, **kwargs)
    finally:
        work.COUNTERS.pop()
    return {"flops": counter.flops, "bytes": counter.bytes,
            "peak_bytes": counter.arg_bytes + counter.peak, "arg_bytes": counter.arg_bytes,
            "kernels": {name: dict(row) for name, row in sorted(counter.kernels.items())},
            "collective_bytes": None, "seconds": time.perf_counter() - t0}

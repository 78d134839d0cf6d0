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
  * ``collective_bytes`` - None without a mesh: one card has no
                     collectives.
  * ``seconds``    - the host time the count took.

``analyze(fn, *args, mesh=, specs=)`` counts the one-process mesh's
program as the reference's dry run counts its per-device HLO: every
operation is attributed to the mesh position that issued it
(``sharding.collectives.at``, set by the mesh loops of
``embedding.sharded``, ``launch.train`` and
``models.transformer.parallel``; in a backward, the position that ran the
node's forward, which each autograd node is tagged with; the mesh's
first position where none is set), and the figures above are
those of the first position, the busiest (it holds the dense work of
the first data replica): ``arg_bytes`` its blocks of the arguments under
``specs`` (``sharding.rules.local_bytes``), ``peak_bytes`` those plus the
most its storages held at once, ``collective_bytes`` a dict of the
reference's kinds (``all-gather``, ``all-reduce``, ``reduce-scatter``,
``all-to-all``, ``collective-permute``), each with ``count`` and
``total_bytes``: the output bytes of each collective at that position
(``sharding.collectives``).  ``n_devices`` is the mesh's size and
``sum`` the flops, bytes, collective bytes and kernel calls of all
positions.  On a symmetric plan the step may run the first data replica
alone (``collectives.mirror``): the other replicas' figures are then the
first's, and ``sum`` counts them so (``positions_counted`` says how many
positions ran); the LM plan runs its first position alone on ``meta``,
and its first microbatch for all (``collectives.repeated``).  A train
cell's count holds the backward's collectives (each autograd collective
reports its conjugate) and those re-run by a layer's recompute under
``torch.utils.checkpoint``, as GSPMD's remat re-gathers FSDP weights in
the backward; the checkpoint stops its recompute after the last tensor
the backward needs, so a layer's last all-reduce is not re-run.
"""
from __future__ import annotations

import collections
import contextlib
import time
import weakref

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work
from repro_torch.sharding import collectives, rules

__all__ = ["analyze"]

# operations that move no bytes: allocations and aliases
_NO_TRAFFIC = {getattr(torch.ops.aten, name) for name in (
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided", "detach",
    "alias", "lift_fresh", "_unsafe_view", "_reshape_alias", "set_", "resize_")}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Position:
    """One position's count."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.kernels: dict = collections.defaultdict(lambda: {"calls": 0, "flops": 0,
                                                               "bytes": 0})
        self.collectives = {k: {"count": 0, "total_bytes": 0} for k in collectives.KINDS}
        self.live = 0
        self.peak = 0


class _Counter(TorchDispatchMode):
    """Counts every operation; with a ``mesh``, each at the position that
    ``collectives.at`` names (the mesh's first where none does, none under
    ``collectives.OFF``).  An operation that keeps the shape of an input
    held in blocks by several positions (``collectives.hold(split=True)``:
    a gradient of the whole arena, one block a model position) is
    elementwise work on those blocks: it and its output are split over
    the same positions."""

    def __init__(self, args, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.first = None if mesh is None else mesh.coords(0)
        self.at: dict = collections.defaultdict(_Position)
        self.keep = None                     # the positions counted (all: None)
        self.mirror = 1
        self.times = 1                       # identical runs the work in hand stands for
        self._arg_storages = set()
        self.arg_bytes = 0
        for t in _tensors(args):
            s = t.untyped_storage()
            if s._cdata not in self._arg_storages:
                self._arg_storages.add(s._cdata)
                self.arg_bytes += s.nbytes()
        self._live: dict = {}                # storage -> {position: bytes}
        self._split: dict = {}               # storage -> the positions holding its blocks

    # -- where ---------------------------------------------------------------
    def _where(self):
        if self.mesh is None:
            return None
        pos = collectives.current()
        if pos is None:
            # in a backward: the position that ran the node's forward
            node = torch._C._current_autograd_node()
            pos = None if node is None else node.metadata.get(_POSITION)
        return self.first if pos is None else pos

    def set_mirror(self, positions, factor: int) -> None:
        self.keep = set(positions)
        self.mirror = factor

    def set_times(self, times: int) -> None:
        self.times = times

    def _kept(self, positions):
        return [p for p in positions if self.keep is None or p in self.keep]

    # -- hooks of kernels.work and sharding.collectives ------------------------
    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        pos = self._where()
        if pos == collectives.OFF:
            return
        at, n = self.at[pos], self.times
        row = at.kernels[name]
        row["calls"] += n
        row["flops"] += n * flops
        row["bytes"] += n * nbytes
        at.flops += n * flops
        at.bytes += n * nbytes

    def add_collective(self, kind: str, position, nbytes: int) -> None:
        if self.mesh is None or not self._kept([position]):
            return
        row = self.at[position].collectives[kind]
        row["count"] += self.times
        row["total_bytes"] += self.times * nbytes

    def hold(self, t: torch.Tensor, positions, split: bool) -> None:
        if self.mesh is None:
            return
        key = t.untyped_storage()._cdata
        if key in self._arg_storages:
            return
        if key not in self._live:
            self._register(t.untyped_storage(), {})
        nbytes = _nbytes(t) // (len(positions) if split else 1)
        if split:
            self._split[key] = tuple(positions)
        for p in self._kept(positions):
            owners = self._live[key]
            owners[p] = owners.get(p, 0) + nbytes
            self._grow(p, nbytes)

    # -- storages --------------------------------------------------------------
    def _grow(self, pos, nbytes: int) -> None:
        at = self.at[pos]
        at.live += nbytes
        at.peak = max(at.peak, at.live)

    def _free(self, key) -> None:
        for pos, nbytes in self._live.pop(key, {}).items():
            self.at[pos].live -= nbytes
        self._split.pop(key, None)

    def _register(self, s, owners: dict) -> None:
        key = s._cdata
        self._live[key] = owners
        weakref.finalize(s, self._free, key)

    def _track(self, outs, positions, split=None) -> None:
        """Each new storage of ``outs`` held by ``positions`` (None: by none
        yet), whole, or in blocks of the positions ``split``."""
        for t in outs:
            s = t.untyped_storage()
            key = s._cdata
            if key in self._arg_storages or key in self._live:
                continue
            if positions is None:            # under collectives.OFF: held by none yet
                self._register(s, {})
                continue
            share = s.nbytes() // (len(split) if split else 1)
            self._register(s, {p: share for p in positions})
            if split:
                self._split[key] = split
            for p in positions:
                self._grow(p, share)

    def _spread(self, ins, outs):
        """The positions an operation's work is split over: those holding
        the blocks of an input, whole, whose shape its output keeps."""
        for t in ins:
            s = t.untyped_storage()
            held = self._split.get(s._cdata)
            # the whole tensor, not one position's block of it
            if held and _nbytes(t) == s.nbytes() and any(o.shape == t.shape for o in outs):
                return held
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        pos = self._where()
        outs = _tensors(out)
        if pos == collectives.OFF:
            self._track(outs, None)
            return out
        ins = _tensors((args, kwargs))
        packet = func.overloadpacket
        flops = int(flop_registry[packet](*args, **kwargs, out_val=out)) \
            if packet in flop_registry else 0
        nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)) \
            if not func.is_view and packet not in _NO_TRAFFIC else 0
        spread = self._spread(ins, outs) if self.mesh is not None else None
        positions = self._kept(spread) if spread else [pos]
        for p in positions:
            at = self.at[p]
            at.flops += self.times * flops // len(spread or positions)
            at.bytes += self.times * nbytes // len(spread or positions)
        self._track(outs, positions, spread)
        return out


_POSITION = "repro_torch.position"


class _Tagger(TorchFunctionMode):
    """Marks the autograd node of each differentiable output with the
    position that ``collectives.at`` names, so that the counter attributes
    the node's backward to the position that ran its forward."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        pos = collectives.current()
        if pos is not None and torch.is_grad_enabled():
            for t in _tensors(out):
                node = t.grad_fn
                if node is not None and _POSITION not in node.metadata:
                    node.metadata[_POSITION] = pos
        return out


def _kernels(rows) -> dict:
    return {name: dict(row) for name, row in sorted(rows.items())}


def analyze(fn, *args, mesh=None, specs=None, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` run once under the counter; its work as the
    module docstring says.  Best on ``meta`` tensors, where nothing is
    computed or allocated and the kernels report their formulas; on a
    real device the operations run and the kernels launch (and report no
    work).  ``mesh``: count each position's work (module docstring);
    ``specs``: the rules of ``args``, one a positional argument, from
    which a position's argument bytes come (``sharding.rules.local_bytes``;
    without them, every argument whole at every position)."""
    counter = _Counter((args, kwargs), mesh)
    t0 = time.perf_counter()
    work.COUNTERS.append(counter)
    try:
        with counter, (_Tagger() if mesh is not None else contextlib.nullcontext()):
            fn(*args, **kwargs)
    finally:
        work.COUNTERS.pop()
    seconds = time.perf_counter() - t0
    if mesh is None:
        at = counter.at[None]
        return {"flops": at.flops, "bytes": at.bytes,
                "peak_bytes": counter.arg_bytes + at.peak, "arg_bytes": counter.arg_bytes,
                "kernels": _kernels(at.kernels), "collective_bytes": None, "seconds": seconds}
    arg_bytes = counter.arg_bytes if specs is None else sum(
        rules.local_bytes(a, sp, mesh) for a, sp in zip(args, specs))
    first = counter.at[counter.first]
    seen = list(counter.at.values())
    kernel_calls: dict = collections.Counter()
    for at in seen:
        for name, row in at.kernels.items():
            kernel_calls[name] += row["calls"] * counter.mirror
    return {"flops": first.flops, "bytes": first.bytes,
            "peak_bytes": arg_bytes + first.peak, "arg_bytes": arg_bytes,
            "kernels": _kernels(first.kernels),
            "collective_bytes": {k: dict(v) for k, v in first.collectives.items()},
            "n_devices": mesh.size, "position": list(counter.first),
            "positions_counted": len(seen),
            "sum": {"flops": counter.mirror * sum(at.flops for at in seen),
                    "bytes": counter.mirror * sum(at.bytes for at in seen),
                    "collective_bytes": counter.mirror * sum(
                        row["total_bytes"] for at in seen for row in at.collectives.values()),
                    "kernel_calls": dict(sorted(kernel_calls.items()))},
            "seconds": seconds}

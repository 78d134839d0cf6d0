"""Device meshes of the port.  Port of ``repro.launch.mesh``.

The port drives its mesh from one process, as the reference drives its
``shard_map`` from one: a ``Mesh`` names its axes, their sizes, and the
``torch.device`` of every position, and a sharded module
(``serving.sharded``, ``embedding.sharded``, ``launch.train``'s
data-parallel step) loops over those positions itself, each position's
work on its own device.

  host:        (1, D)         axes ("data", "model")         D shards
  single-pod:  (16, 16)       axes ("data", "model")         256 devices
  multi-pod:   (2, 16, 16)    axes ("pod", "data", "model")  512 devices

A position is the tuple of its coordinates, one an axis, in the order of
``axis_names``; positions are numbered row-major, so the first ``D``
(the model axis's size) are the model axis of the first data replica,
``mesh.devices``.  ``pod`` and ``data`` are data parallelism: replica
``r`` (row-major over those axes) is ``mesh.replica(r)``, a ``(1, D)``
mesh of its model axis whose positions keep their coordinates in this
mesh.

Shard ``s`` of a host mesh lives on device ``s % count`` of the visible
devices of its type: with more shards than cards, shards share a card
(four shards on one H100 all live on ``cuda:0``), the counterpart of the
reference tests' forced host device count.  A mesh with a data axis
past 1 is built with the constructor, the counterpart of
``jax.make_mesh`` in the reference's tests.  A production mesh is built
where that many devices are visible, or on ``meta`` (nothing is
allocated there: ``launch.dryrun --mesh`` counts its cells on it), the
counterpart of the reference dry run's forced 512 host devices.
"""
from __future__ import annotations

import itertools
import math

import torch

from repro_torch.device import resolve_device

DATA_AXES = ("pod", "data")


class Mesh:
    """Axis names, their sizes (``shape``, a dict as ``jax.sharding.Mesh``
    has), and a device for every position.  ``devices``: one device a
    position, row-major (``math.prod(sizes)`` of them), or one for each
    position of the model axis, which every data replica then shares.
    ``mesh.devices`` is the model axis of the first data replica."""

    def __init__(self, axis_names: tuple, sizes: tuple, devices: tuple, *, coords=None):
        if len(axis_names) != len(sizes):
            raise ValueError(f"{len(axis_names)} axis names for {len(sizes)} sizes")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        n, D = math.prod(self.shape.values()), self.shape["model"]
        devs = tuple(torch.device(d) for d in devices)
        if len(devs) == D and n != D:
            devs = devs * (n // D)
        if len(devs) != n:
            raise ValueError(f"{len(devs)} devices for {n} positions (or a model axis of {D})")
        self.grid = devs
        self.devices = devs[:D]
        self._coords = tuple(coords) if coords is not None else tuple(
            itertools.product(*(range(s) for s in self.shape.values())))

    @property
    def size(self) -> int:
        return len(self.grid)

    @property
    def dp(self) -> int:
        """Data replicas: the product of the ``pod`` and ``data`` sizes."""
        return math.prod(self.shape[a] for a in DATA_AXES if a in self.shape)

    def positions(self) -> tuple:
        """Every position's coordinates, row-major."""
        return self._coords

    def coords(self, i: int) -> tuple:
        """The coordinates of position ``i`` (row-major)."""
        return self._coords[i]

    def replica(self, r: int) -> "Mesh":
        """Data replica ``r``'s model axis as a ``(1, D)`` mesh whose
        positions keep this mesh's coordinates."""
        D = self.shape["model"]
        if not 0 <= r < self.dp:
            raise ValueError(f"replica {r} of {self.dp}")
        return Mesh(("data", "model"), (1, D), self.grid[r * D:(r + 1) * D],
                    coords=self._coords[r * D:(r + 1) * D])

    def groups(self, axes) -> list:
        """The groups of positions along ``axes`` (a name or a tuple of
        names; those the mesh lacks are ignored): each group the positions
        that differ only in those axes, in row-major order of the axes;
        the groups in row-major order of the other axes."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        along = [i for i, a in enumerate(self.axis_names) if a in axes]
        groups: dict = {}
        for c in self._coords:
            key = tuple(x for i, x in enumerate(c) if i not in along)
            groups.setdefault(key, []).append(c)
        return list(groups.values())

    def __repr__(self) -> str:
        devs = sorted(set(map(str, self.grid)))
        return f"Mesh({self.shape}, {self.size} positions on {', '.join(devs)})"


def _device_count(device_type: str) -> int:
    """Visible devices of a type: CUDA cards, or 1 for the CPU."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    return 1


def _device(device_type: str, index: int) -> torch.device:
    return torch.device(device_type, index) if device_type == "cuda" else torch.device(
        device_type)


def make_host_mesh(model: int | None = None, device=None) -> Mesh:
    """A (1, D) mesh with the production axis names.  ``device``: the
    device type (``cuda`` unless the caller names another); D = ``model``,
    by default the count of visible devices of that type (1 on the CPU).
    Shard ``s`` lives on device ``s % count``."""
    dev = resolve_device(device)
    count = _device_count(dev.type)
    D = count if model is None else int(model)
    if D < 1:
        raise ValueError(f"model axis of {D}")
    return Mesh(("data", "model"), (1, D),
                tuple(_device(dev.type, s % count) for s in range(D)))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The (16, 16) single-pod or (2, 16, 16) multi-pod mesh: on ``meta``
    (every position there), or where that many devices are visible;
    otherwise ``ValueError`` naming the count."""
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = resolve_device(device)
    need = math.prod(sizes)
    if dev.type == "meta":
        return Mesh(axes, sizes, (dev,) * need)
    count = _device_count(dev.type)
    if count < need:
        raise ValueError(f"the production mesh {sizes} needs {need} {dev.type} devices; "
                         f"{count} visible")
    return Mesh(axes, sizes, tuple(_device(dev.type, s) for s in range(need)))

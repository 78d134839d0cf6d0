"""Device meshes of the port.  Port of ``repro.launch.mesh``.

The port drives its mesh from one process, as the reference drives its
``shard_map`` from one: a ``Mesh`` names its axes, their sizes, and the
``torch.device`` of each position on the ``model`` axis, and a sharded
module (``serving.sharded``, ``fwfm.rank_items_mp``) loops over those
positions itself, each shard's work on its own device.

  host:        (1, D)         axes ("data", "model")         D shards
  single-pod:  (16, 16)       axes ("data", "model")         256 devices
  multi-pod:   (2, 16, 16)    axes ("pod", "data", "model")  512 devices

Shard ``s`` of a host mesh lives on device ``s % count`` of the visible
devices of its type: with more shards than cards, shards share a card
(four shards on one H100 all live on ``cuda:0``), the counterpart of the
reference tests' forced host device count.  A production mesh is built
only where that many devices are visible.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device


class Mesh:
    """Axis names, their sizes (``shape``, a dict as ``jax.sharding.Mesh``
    has), and ``devices``: one ``torch.device`` for each position on the
    ``model`` axis, of the first ``data`` (and ``pod``) replica."""

    def __init__(self, axis_names: tuple, sizes: tuple, devices: tuple):
        if len(axis_names) != len(sizes):
            raise ValueError(f"{len(axis_names)} axis names for {len(sizes)} sizes")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.devices = tuple(torch.device(d) for d in devices)
        if len(self.devices) != self.shape["model"]:
            raise ValueError(f"{len(self.devices)} devices for a model axis of "
                             f"{self.shape['model']}")

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices=[{', '.join(map(str, self.devices))}])")


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
    """The (16, 16) single-pod or (2, 16, 16) multi-pod mesh, where that
    many devices are visible; otherwise ``ValueError`` naming the count."""
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = resolve_device(device)
    count = _device_count(dev.type)
    need = math.prod(sizes)
    if count < need:
        raise ValueError(f"the production mesh {sizes} needs {need} {dev.type} devices; "
                         f"{count} visible")
    return Mesh(axes, sizes, tuple(_device(dev.type, s) for s in range(sizes[-1])))

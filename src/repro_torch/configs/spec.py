"""The registry's records: one architecture (``ArchSpec``) and one of its
input-shape cells (``ShapeSpec``).  Apart from ``registry`` so that a
config module can define its shapes without importing the registry."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (input-shape) cell for an architecture.

    kind:
      lm:     train | prefill | decode
      recsys: train | rank | pointwise
      gnn:    graph
    """

    name: str
    kind: str
    dims: dict
    skip: str | None = None      # reason when the cell is N/A for this arch


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                   # lm | recsys | gnn
    make_config: Callable[[], Any]
    make_smoke: Callable[[], Any]
    shapes: tuple[ShapeSpec, ...]
    notes: str = ""

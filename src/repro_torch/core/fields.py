"""Field / feature-layout substrate for tabular (recsys) models.

A sample is a row of a tabular dataset whose columns ("fields") hold
categorical features.  Fields are either *context* fields (user, device,
page, ...) or *item* fields (ad id, advertiser, creative, ...).  The
context/item split is the load-bearing structural fact of the paper: during
item ranking, everything that depends only on context fields is computed
once per query (Algorithm 1).

Multi-valued fields (e.g. a list of movie genres) occupy ``multiplicity``
id slots; per-slot weights implement the paper's averaging convention
(a movie with 3 genres puts 1/3 on each genre slot, Section 3.2).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

CONTEXT = "context"
ITEM = "item"


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """One tabular column."""

    name: str
    vocab_size: int
    kind: str = CONTEXT          # "context" | "item"
    multiplicity: int = 1        # number of id slots (1 = one-hot)

    def __post_init__(self):
        if self.kind not in (CONTEXT, ITEM):
            raise ValueError(f"bad field kind {self.kind!r}")
        if self.vocab_size < 1 or self.multiplicity < 1:
            raise ValueError(f"bad field spec {self}")


@dataclasses.dataclass(frozen=True)
class FeatureLayout:
    """Static layout derived from an ordered list of FieldSpecs.

    The embedding arena is a single table of ``total_vocab`` rows; each
    field owns the contiguous row range ``[offset, offset + vocab)``.
    A batch is represented as::

        ids:     int32 (batch, n_slots)   per-slot *local* ids in [0, vocab)
        weights: f32   (batch, n_slots)   0 for padding; 1/n for multi-hot

    All index math below is static numpy, resolved at trace time.
    """

    fields: tuple[FieldSpec, ...]

    # ---- derived static arrays -------------------------------------------------
    @property
    def n_fields(self) -> int:
        return len(self.fields)

    @property
    def n_context(self) -> int:
        return sum(1 for f in self.fields if f.kind == CONTEXT)

    @property
    def n_item(self) -> int:
        return sum(1 for f in self.fields if f.kind == ITEM)

    @property
    def n_slots(self) -> int:
        return sum(f.multiplicity for f in self.fields)

    @property
    def total_vocab(self) -> int:
        return sum(f.vocab_size for f in self.fields)

    @property
    def field_offsets(self) -> np.ndarray:
        """(n_fields,) arena row offset of each field."""
        sizes = np.array([f.vocab_size for f in self.fields], dtype=np.int64)
        return np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)

    @property
    def slot_to_field(self) -> np.ndarray:
        """(n_slots,) field index of each id slot."""
        out = []
        for i, f in enumerate(self.fields):
            out.extend([i] * f.multiplicity)
        return np.array(out, dtype=np.int32)

    @property
    def slot_offsets(self) -> np.ndarray:
        """(n_slots,) arena offset of each slot's field."""
        return self.field_offsets[self.slot_to_field]

    @property
    def context_field_idx(self) -> np.ndarray:
        return np.array(
            [i for i, f in enumerate(self.fields) if f.kind == CONTEXT], np.int32
        )

    @property
    def item_field_idx(self) -> np.ndarray:
        return np.array(
            [i for i, f in enumerate(self.fields) if f.kind == ITEM], np.int32
        )

    def slots_of(self, kind: str) -> np.ndarray:
        """(n,) slot indices belonging to fields of the given kind."""
        want = {
            i for i, f in enumerate(self.fields) if f.kind == kind
        }
        return np.array(
            [s for s, fi in enumerate(self.slot_to_field) if int(fi) in want],
            dtype=np.int32,
        )

    def subset(self, kind: str) -> "FeatureLayout":
        """A layout containing only fields of the given kind (local slots)."""
        return FeatureLayout(tuple(f for f in self.fields if f.kind == kind))


def uniform_layout(
    n_context: int,
    n_item: int,
    vocab_per_field: int | Sequence[int],
    multiplicity: int = 1,
) -> FeatureLayout:
    """Convenience constructor: n_context context + n_item item fields."""
    m = n_context + n_item
    if isinstance(vocab_per_field, int):
        vocabs = [vocab_per_field] * m
    else:
        vocabs = list(vocab_per_field)
        assert len(vocabs) == m
    fields = []
    for i in range(m):
        kind = CONTEXT if i < n_context else ITEM
        fields.append(
            FieldSpec(
                name=f"{kind[:3]}_{i}",
                vocab_size=int(vocabs[i]),
                kind=kind,
                multiplicity=multiplicity,
            )
        )
    return FeatureLayout(tuple(fields))

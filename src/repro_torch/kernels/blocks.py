"""The corpus kernels' launch geometry: named defaults, clamp events, and
the tuned-tile registry.

Counterpart of ``repro.kernels.blocks``.  The reference's tiles are
Pallas ``BlockSpec`` geometry for a TPU's VMEM; the port's are the launch
parameters of the CUDA kernels in ``csrc/dplr_corpus_score.cu`` (kernels
1, 2 and 4), whose defaults are named here and checked on the card
against the library's own (``dplr_corpus_score.geometry_defaults``).  The
other kernels' tiles are computed by their libraries from the shape
(``dplr_score.tile``, ``fwfm_interaction.tile``), so they have no
constant here.  The reference's ``BlockSpec`` helpers (``grid_1d``,
``row_tiles``, ``col_tiles``, ``broadcast``, ``attn_tiles``,
``prefetch_*``) have no counterpart: a CUDA launch has no ``BlockSpec``.

A launch's geometry is a ``Tile``:

  * ``block_n``: the slots a block scores at a time.  Kernel 1 (full
    mode, one wave of persistent blocks): the run, the consecutive slots
    a block claims at a time, streamed through its ring in tiles of at
    most 256 rows (default 256, one tile).  Kernels 2 and 4 (top-K
    modes): stage 1's chunk, the slots a block scores and counts into the
    merge's histogram (default 512).  So the reference's keyword keeps
    its meaning;
  * ``acc_dtype``: the reference's accumulation mode;
  * ``group``: the query rows a block scores at once (1, 2, 4, 8 or 16;
    default ``group_size(Bq)``), the one template parameter;
  * ``threads``: stage 1's threads a block (top-K modes; default and
    most 256, its launch bound).
    The full mode's threads are fixed (128 scoring threads and one
    producer warp), so no winner ever sets them;
  * ``part``: the scores one merge block filters (top-K modes; default
    16,384).

Per query a slot's score is the same operations whatever the geometry,
and the top-K selection is a function of the scores alone, so every
geometry returns the same bits on the card; only the time differs.

Two services beyond the defaults, as in the reference:

  * **clamp events**: ``clamp_tile`` never shrinks a tile silently; each
    clamp is recorded and drained by ``drain_clamp_events``.  A requested
    ``block_n`` (explicit or registered) past the slab is clamped to n,
    and a requested ``group`` past ``group_size(Bq)`` to that.  The
    defaults are not clamped: a process that tunes nothing launches
    exactly the geometry the kernels had before the registry.
  * **tuned-tile registry**: ``kernels/autotune.py`` registers each
    parity-gated winner with ``register_tuned_tile``, and every corpus
    call that leaves a parameter ``None`` resolves it through
    ``resolve_tile``.  ``acc_dtype`` resolves in the reference's order:
    the exact cell, then the newest winner of the same ``(n, rho, k,
    dtype, backend)`` family, then the default.  The geometry resolves
    only where it was timed: the exact cell on as many slabs, then the
    newest winner of its ``launch_class`` (the family at the same query
    group, mode and number of slabs), then the default: a winner's
    geometry never reaches a launch unlike the ones it was timed on.  A
    registry-sourced geometry that does not fit the card is halved
    visibly until it does.  ``backend`` is the tensors' device type
    (``'cuda'`` or ``'cpu'``), so a CPU winner never applies on the card.
    Nothing is traced, so a registry change applies at the next call.
"""
from __future__ import annotations

import functools
from numbers import Integral
from typing import NamedTuple

# The kernels' default geometry (csrc/dplr_corpus_score.cu: kFullBlockN,
# kChunk, kTopkThreads, kMaxGroup, kPart) and the limits of its launch
# parameters (kMaxChunk: a chunk's histogram counts are 16-bit; stage 1's
# launch bound is its default threads).
CORPUS_FULL_BLOCK_N = 256   # slots a full-mode block claims at a time (kernel 1)
CORPUS_FULL_THREADS = 128   # and its scoring threads, two slots each a tile; fixed
CORPUS_CHUNK = 512          # slots a stage-1 block scores (kernels 2, 4)
CORPUS_THREADS = 256        # stage 1's threads, one slot each a tile
CORPUS_MAX_GROUP = 16       # query rows a block scores at once, at most
CORPUS_PART = 16384         # scores one merge block filters
MAX_BLOCK_N = 32768
MAX_THREADS = 256
MAX_PART = 1 << 20
GROUPS = (1, 2, 4, 8, 16)
ACC_DTYPES = ("float32", "bfloat16")
# most merge blocks a row may have (the grid's y limit)
MAX_PARTS = 65535


class Tile(NamedTuple):
    """One launch geometry; ``tile[:2]`` is the reference's ``(block_n,
    acc_dtype)``.  In a registered record a ``None`` field means "the
    default at the call"."""
    block_n: int
    acc_dtype: str = "float32"
    group: int | None = None
    threads: int | None = None
    part: int | None = None


def group_size(Bq: int) -> int:
    """The default query group at Bq (the library's ``group_size``): the
    smallest power of two >= Bq, at most ``CORPUS_MAX_GROUP``."""
    return min(CORPUS_MAX_GROUP, 1 << max(int(Bq) - 1, 0).bit_length())


@functools.cache
def default_tile(Bq: int, K: int | None) -> Tile:
    """The geometry the kernels launch when nothing is tuned or asked:
    the full mode's for ``K=None`` (its fixed threads; ``part`` unused),
    else the top-K modes'."""
    if K is None:
        return Tile(CORPUS_FULL_BLOCK_N, "float32", group_size(Bq), CORPUS_FULL_THREADS,
                    CORPUS_PART)
    return Tile(CORPUS_CHUNK, "float32", group_size(Bq), CORPUS_THREADS, CORPUS_PART)


def check_tile(tile: Tile) -> None:
    """Raise ``ValueError`` unless every field given (not ``None``) is a
    geometry the kernels take."""
    bn, acc, group, threads, part = tile
    if bn is not None and not (isinstance(bn, Integral) and 1 <= bn <= MAX_BLOCK_N):
        raise ValueError(f"block_n={bn!r}: the kernels take 1 <= block_n <= {MAX_BLOCK_N}")
    if acc is not None and acc not in ACC_DTYPES:
        raise ValueError(f"acc_dtype={acc!r}: the kernels accumulate in "
                         f"{' or '.join(ACC_DTYPES)}")
    if group is not None and group not in GROUPS:
        raise ValueError(f"group={group!r}: the kernels take a group in {GROUPS}")
    if threads is not None and not (isinstance(threads, Integral)
                                    and 32 <= threads <= MAX_THREADS and threads % 32 == 0):
        raise ValueError(f"threads={threads!r}: the kernels take a multiple of 32 "
                         f"from 32 to {MAX_THREADS}")
    if part is not None and not (isinstance(part, Integral) and 1024 <= part <= MAX_PART
                                 and part % 1024 == 0):
        raise ValueError(f"part={part!r}: the kernels take a multiple of 1024 "
                         f"from 1024 to {MAX_PART}")


# Bounded log of tile clamps (requested > axis length), drained by the
# autotuner and the benchmarks.
_CLAMP_EVENTS: list[dict] = []
_CLAMP_EVENTS_MAX = 256


def clamp_tile(tile: int, n: int) -> int:
    """Shrink a requested tile to the axis length ``n``.  Never silent:
    each clamp is recorded for ``drain_clamp_events`` readers."""
    clamped = min(tile, n)
    if clamped != tile:
        _record(tile, clamped, n)
    return clamped


def _record(requested: int, effective: int, n: int) -> None:
    if len(_CLAMP_EVENTS) < _CLAMP_EVENTS_MAX:
        _CLAMP_EVENTS.append({"requested": int(requested), "effective": int(effective),
                              "n": int(n)})


def drain_clamp_events() -> list[dict]:
    """Return and clear the recorded clamp events (bounded at
    ``_CLAMP_EVENTS_MAX``): ``{"requested", "effective", "n"}`` dicts in
    occurrence order."""
    out = list(_CLAMP_EVENTS)
    _CLAMP_EVENTS.clear()
    return out


def pad_amount(n: int, tile: int) -> int:
    """Rows of phantom padding that make ``n`` a whole number of tiles."""
    return (-n) % tile


# -- tuned-tile registry (written by kernels/autotune.py) -------------------

# The reference's two tables, which resolve a call's acc_dtype: exact cell
# (n, rho, k, Bq, K, dtype, backend) -> record, and the newest record per
# shape family (n, rho, k, dtype, backend).
_TUNED_TILES: dict[tuple, Tile] = {}
_TUNED_FAMILY: dict[tuple, Tile] = {}
# Where each record's geometry was timed, which resolve a call's geometry:
# (cell, segments) -> record, and the newest record per launch class.
_TUNED_GEOMETRY: dict[tuple, Tile] = {}
_CLASS_GEOMETRY: dict[tuple, Tile] = {}
_UNSET = Tile(None, None)


@functools.cache
def dtype_name(dtype) -> str:
    """A slab dtype's registry name: ``torch.bfloat16`` -> ``'bfloat16'``,
    as ``str`` of the reference's jnp dtype gives it."""
    return str(dtype).removeprefix("torch.")


def tile_cell(n: int, rho: int, k: int, Bq: int, K: int | None,
              dtype: str, backend: str) -> tuple:
    """The registry key of one autotuned shape cell."""
    return (int(n), int(rho), int(k), int(Bq),
            None if K is None else int(K), str(dtype), str(backend))


def _family(cell: tuple) -> tuple:
    return cell[:3] + cell[5:]


def launch_class(cell: tuple, segments: int = 1) -> tuple:
    """The launches a record's geometry applies to beyond its own cell: the
    same shape family, query group (``group_size(Bq)``), mode (top-K or
    full) and number of slabs (``segments``; 1: a single-slab call).  Each
    sets how much work a block does per slab byte, so a geometry timed in
    one class says nothing of its time in another."""
    return _family(cell) + (group_size(cell[3]), cell[4] is None, int(segments))


def register_tuned_tile(cell: tuple, block_n: int, acc_dtype: str = "float32", *,
                        group: int | None = None, threads: int | None = None,
                        part: int | None = None, segments: int = 1) -> None:
    """Record a parity-gated autotune winner for ``cell`` (a ``tile_cell``
    tuple), timed on ``segments`` slabs (1: ``dplr_corpus_score``, more:
    ``dplr_corpus_score_multi``).  Only ``kernels/autotune.py`` should call
    this, and only after the candidate passed its oracle parity gate (the
    KRN-TUNE rule of ``tools/analyze`` checks that pairing).  Raises on a
    geometry the kernels do not take."""
    cell = tuple(cell)
    winner = Tile(int(block_n), str(acc_dtype), group, threads, part)
    check_tile(winner)
    if not (isinstance(segments, Integral) and segments >= 1):
        raise ValueError(f"segments={segments!r}: a launch has at least one slab")
    _TUNED_TILES[cell] = winner
    _TUNED_FAMILY[_family(cell)] = winner
    _TUNED_GEOMETRY[(cell, int(segments))] = winner
    _CLASS_GEOMETRY[launch_class(cell, segments)] = winner


def _lookup(cell: tuple, segments: int) -> tuple[Tile | None, Tile | None]:
    """The records a call of ``cell`` on ``segments`` slabs resolves
    through: its ``acc_dtype``'s, in the reference's order (the exact
    cell, then the newest of the family), and its geometry's (the exact
    cell timed on as many slabs, then the newest of its launch class)."""
    acc = _TUNED_TILES.get(cell) or _TUNED_FAMILY.get(_family(cell))
    geo = (_TUNED_GEOMETRY.get((cell, segments))
           or _CLASS_GEOMETRY.get(launch_class(cell, segments)))
    return acc, geo


def corpus_tile(n: int, rho: int, k: int, Bq: int, K: int | None,
                dtype: str, backend: str, *, segments: int = 1) -> Tile:
    """The geometry a call of this cell that asks for nothing resolves to,
    before clamps: ``acc_dtype`` from the exact tuned cell if registered,
    else the newest winner of the same ``(n, rho, k, dtype, backend)``
    family (the reference's order); the geometry from the exact cell
    timed on as many slabs, else the newest winner of its
    ``launch_class``; each else ``default_tile`` (a record's unset fields
    from the default too)."""
    acc, geo = _lookup(tile_cell(n, rho, k, Bq, K, dtype, backend), segments)
    d = default_tile(Bq, K)
    if geo is not None:
        d = Tile(*(dv if g is None else g for g, dv in zip(geo, d)))
    return d if acc is None else d._replace(acc_dtype=acc.acc_dtype)


def resolve_tile(n: int, rho: int, k: int, Bq: int, K: int | None, dtype: str,
                 backend: str, *, block_n=None, acc_dtype=None, group=None,
                 threads=None, part=None, segments: int = 1, fits=None) -> Tile:
    """The geometry a corpus call on ``segments`` slabs launches: each
    argument given wins, each ``None`` falls through to the registry
    (``corpus_tile``'s order), then to the default.  A requested (given or
    registered) ``block_n`` and ``group`` are clamped to n and
    ``group_size(Bq)``, and in the top-K modes a ``part`` to the row's
    length, through ``clamp_tile``; a part so small that a row would need
    more than ``MAX_PARTS`` merge blocks is widened to the least that
    fits, recorded the same way.  The full mode (``K=None``) takes
    ``block_n``, ``group`` and ``acc_dtype`` alone: its threads are fixed,
    so a top-K winner's never reach it.  ``fits`` (a predicate on a
    ``Tile``; on the card, whether it fits the device's shared memory):
    a geometry that came from the registry and does not fit has its
    ``block_n`` halved until it does, each step recorded as a clamp, so
    that no record makes a call unlaunchable.  Raises ``ValueError`` on a
    geometry the kernels do not take."""
    asked = Tile(block_n, acc_dtype, group, threads, part)
    if asked == _UNSET and not _TUNED_TILES:
        return default_tile(Bq, K)          # nothing asked, nothing tuned
    check_tile(asked)
    acc, geo = _lookup(tile_cell(n, rho, k, Bq, K, dtype, backend), segments)
    registered = False
    if geo is not None:
        registered = any(asked[f] is None and geo[f] is not None for f in (0, 2, 3, 4))
        asked = Tile(*(g if a is None else a for a, g in zip(asked, geo)))._replace(
            acc_dtype=asked.acc_dtype)
    if asked.acc_dtype is None and acc is not None:
        asked = asked._replace(acc_dtype=acc.acc_dtype)
    d = default_tile(Bq, K)
    bn = d.block_n if asked.block_n is None else clamp_tile(asked.block_n, n)
    G = d.group if asked.group is None else clamp_tile(asked.group, group_size(Bq))
    threads = d.threads if asked.threads is None or K is None else asked.threads
    part = d.part
    if K is not None and asked.part is not None:
        m = -(-n // bn) * bn             # the row's length: n in whole chunks
        part = clamp_tile(asked.part, m)
        least = -(-m // MAX_PARTS)
        if part < least:
            widened = -(-least // 1024) * 1024
            _record(part, widened, m)
            part = widened
    tile = Tile(int(bn), d.acc_dtype if asked.acc_dtype is None else asked.acc_dtype, int(G),
                int(threads), int(part))
    while registered and fits is not None and tile.block_n > 1 and not fits(tile):
        half = tile.block_n // 2
        _record(tile.block_n, half, n)
        tile = tile._replace(block_n=half)
    return tile


def clear_tuned_tiles() -> None:
    """Drop every registered tuned tile (tests / benchmark hygiene)."""
    for table in (_TUNED_TILES, _TUNED_FAMILY, _TUNED_GEOMETRY, _CLASS_GEOMETRY):
        table.clear()

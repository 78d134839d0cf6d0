"""Shape-cell autotuner for the corpus kernels (+ the card peaks table).

Counterpart of ``repro.kernels.autotune``.  The corpus kernels (1, 2 and
4) launch with a geometry (``blocks.Tile``: the slots a block scores, the
query group, stage 1's threads, the merge's part) and an accumulation
mode.  This module sweeps candidate geometries, and bf16 accumulation
where the slab already is bf16, per ``(n, rho, k, Bq, K, dtype,
backend)`` cell, gates every candidate on the plain oracles (a faster
wrong kernel never wins), and registers the winner with
``blocks.register_tuned_tile``, so that every corpus call that leaves a
parameter ``None`` (the runtime, the engine, the multi-tenant path)
launches it from the next call on, where it was timed: a cell is swept on
one slab, or with ``segments=S`` through the multi-tenant launch a packed
wave of S tenants makes, and its geometry reaches only launches of its
``blocks.launch_class``.

Parity gates, per candidate, never sampled:

  * f32 accumulation: indices exactly those of ``dplr_corpus_topk_ref``
    and values within 1e-5 of it.  On the card, also bitwise the default
    geometry's output: per query the scorer's operations do not depend on
    the geometry, so the geometry must be invisible in the bits.
  * bf16 accumulation: the returned indices must select items whose
    oracle scores (``dplr_corpus_score_ref``) are within ``bf16_tol`` of
    the oracle's top-K values, and the returned values must be within
    ``bf16_tol`` of the selected items' oracle scores.

A candidate that does not fit the card's shared memory a block
(``dplr_corpus_score.geometry_fits``) is recorded as not launchable and
never run or crowned.  Requested sizes past the cell's n or ``Bq`` are
clamped by ``blocks.resolve_tile``; the events are drained per candidate
and carried on its result.

``HW_PROFILES`` is the one table of card peaks: ``chip_smoke.py`` binds
its bounds to it, and the tuner reports each winner's distance from the
memory roofline with the same profile.

In-process results memo per cell; ``save_cache`` / ``load_cache``
round-trip the registry through the reference's JSON format (geometry
beyond ``block_n`` in extra keys, which the reference ignores), so each
package loads the other's file.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import blocks

# NVIDIA data-sheet peaks by the card name torch reports (the first key
# the name contains): device memory bytes/s, f32 flop/s outside the tensor
# cores, dense bf16 tensor-core flop/s, NVLink bytes/s.  The 'cpu' entry
# is deliberately rough: reporting only, never for picking a winner.
HW_PROFILES: dict[str, dict[str, float]] = {
    "H200": {"hbm_bw": 4.8e12, "f32_flops": 67e12, "bf16_flops": 989e12, "link_bw": 900e9},
    "H100 PCIe": {"hbm_bw": 2.0e12, "f32_flops": 51e12, "bf16_flops": 756e12,
                  "link_bw": 600e9},
    "H100 NVL": {"hbm_bw": 3.9e12, "f32_flops": 60e12, "bf16_flops": 835e12,
                 "link_bw": 600e9},
    "H100": {"hbm_bw": 3.35e12, "f32_flops": 67e12, "bf16_flops": 989e12,
             "link_bw": 900e9},    # SXM
    "cpu": {"hbm_bw": 5e10, "f32_flops": 1e11, "bf16_flops": 1e11, "link_bw": 1e9},
}
# the card the port is measured on; ``hw_for`` reads a device's own
DEFAULT_HW = "H100"


def hw_for(device) -> str:
    """The ``HW_PROFILES`` key of ``device``: from the card's name, or
    ``'cpu'``.  Raises for a card the table does not know."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    name = torch.cuda.get_device_name(dev)
    for key in HW_PROFILES:
        if key != "cpu" and key in name:
            return key
    raise ValueError(f"no peak rates known for {name!r}")


# The default sweep: stage 1's chunk by its threads, the query group and
# the merge's part around the defaults (None: the default at the call),
# and one chunk past any card's shared memory at a group of 16 (recorded
# as not launchable).  Requested groups past a cell's Bq clamp visibly.
# The default geometry always competes, whether listed or not.
DEFAULT_CANDIDATES = tuple(
    {"block_n": chunk, "threads": threads, "group": group, "part": part}
    for chunk in (256, 512, 1024, 2048, 4096)
    for threads in (None, 128, 64)
    for group in (None, 8, 4)
    for part in (None, 4096, 8192, 32768)
) + ({"block_n": 8192, "group": 16},)


@dataclass(frozen=True)
class CandidateResult:
    """One swept (geometry, acc_dtype) configuration of a cell."""
    block_n: int                # requested slots a block scores
    effective_block_n: int      # after the clamp (== block_n when n >= it)
    acc_dtype: str
    us: float                   # microseconds a call (inf: failed or not run)
    parity_ok: bool
    parity_error: str | None = None
    clamps: tuple = ()          # drained blocks.drain_clamp_events dicts
    group: int | None = None    # requested (None: the default at the call)
    threads: int | None = None
    part: int | None = None
    effective: blocks.Tile | None = None   # the geometry launched
    fits: bool = True           # False: past the card's shared memory a block


@dataclass(frozen=True)
class TunedTile:
    """A cell's sweep outcome: the parity-gated winner vs the default."""
    cell: tuple                 # blocks.tile_cell key
    block_n: int
    acc_dtype: str
    us: float                   # winner's time
    default_us: float           # the default geometry's f32 time on the same cell
    swept: tuple = ()           # every CandidateResult, winners and losers
    hw: str = DEFAULT_HW
    bytes_per_call: int = 0     # slab + output traffic, for the roofline fraction
    group: int | None = None
    threads: int | None = None
    part: int | None = None
    segments: int = 1           # slabs a timed launch scored (1: dplr_corpus_score)

    @property
    def speedup(self) -> float:
        return self.default_us / self.us if self.us > 0 else 1.0

    @property
    def roofline_frac(self) -> float:
        """Fraction of the profile's memory roofline the winner achieves
        (reporting only: meaningless on the CPU)."""
        bw = HW_PROFILES[self.hw]["hbm_bw"]
        ideal_us = self.bytes_per_call / bw * 1e6
        return ideal_us / self.us if self.us > 0 else 0.0


# in-process memo: (tile_cell, segments) -> TunedTile (sweeps are not free;
# a warmup that touches the same cell twice must pay once)
_RESULTS: dict[tuple, TunedTile] = {}


def clear_results() -> None:
    """Drop the in-process sweep memo (tests / benchmark hygiene)."""
    _RESULTS.clear()


def _mk_inputs(n, rho, k, Bq, dtype, seed):
    """The reference's arrays for one cell, from the same numpy draws:
    ``(Q, a, e, P, aC, valid)`` CPU tensors, ``Q`` and ``P`` in ``dtype``
    (rounded from float32, as the reference's cast rounds), the rest
    float32 and ``valid`` bool."""
    r = np.random.default_rng(seed)
    Q = r.normal(size=(n, rho, k)).astype(np.float32)
    a = r.normal(size=(n,)).astype(np.float32)
    e = r.normal(size=(rho,)).astype(np.float32)
    P = r.normal(size=(Bq, rho, k)).astype(np.float32)
    aC = r.normal(size=(Bq,)).astype(np.float32)
    valid = (r.random(n) > 0.1)
    valid[: max(1, n // 8)] = True      # K live items guaranteed
    dt = getattr(torch, blocks.dtype_name(dtype))
    return (torch.from_numpy(Q).to(dt), torch.from_numpy(a), torch.from_numpy(e),
            torch.from_numpy(P).to(dt), torch.from_numpy(aC), torch.from_numpy(valid))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check_parity(vals, idx, ref_scores, ref_vals, acc_dtype, ref_idx, bf16_tol):
    """Gate one candidate's output against the oracle.  Returns an error
    string (None = pass)."""
    vals, idx = _np(vals), _np(idx)
    ref_scores, ref_vals, ref_idx = _np(ref_scores), _np(ref_vals), _np(ref_idx)
    if acc_dtype == "float32":
        if not np.array_equal(idx, ref_idx):
            return "f32 indices diverge from dplr_corpus_topk_ref"
        if not np.allclose(vals, ref_vals, rtol=1e-5, atol=1e-5):
            return "f32 values beyond epsilon of dplr_corpus_topk_ref"
        return None
    # bf16 accumulation: judge the returned ITEMS by their ref scores
    got = np.take_along_axis(ref_scores, idx.astype(np.int64), axis=1)
    if not np.allclose(got, ref_vals, rtol=0, atol=bf16_tol):
        return "bf16 indices select items outside tolerance of ref top-K"
    if not np.allclose(vals, got, rtol=0, atol=bf16_tol):
        return "bf16 values beyond tolerance of the selected items' ref"
    return None


# Device cycles a timed batch waits behind per call (``_time_call``): ample
# for the host to queue a call, whose issue takes 0.05-0.4 ms.
_SLEEP_CYCLES_PER_CALL = 2_000_000


def _time_call(fn, repeats: int, device) -> float:
    """Microseconds a call.  On the card: the device time of a call, the
    mean over ``repeats`` back-to-back calls, after one warm call.  The
    timed calls are queued behind a device-side sleep, so the card runs
    them back to back whatever the host's time to issue one (at small
    cells the host is slower than the kernels, and back-to-back calls
    would time the host); if the host had not queued them all before the
    sleep ended, the batch is timed again behind a longer one.  On the
    CPU: the best of ``repeats`` calls timed one by one (a CPU call is
    complete when it returns)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        fn()
        torch.cuda.synchronize(dev)
        cycles = _SLEEP_CYCLES_PER_CALL * repeats
        while True:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            for _ in range(repeats):
                fn()
            queued = not start.query()      # the sleep still running: all queued in time
            stop.record()
            stop.synchronize()
            if queued:
                return start.elapsed_time(stop) * 1e3 / repeats
            cycles *= 4
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e6)
    return best


def _candidate(c) -> dict:
    """A sweep entry as the launch parameters it sets: an int is a
    ``block_n``; unset (``None``) fields and ``acc_dtype`` are dropped."""
    if isinstance(c, int):
        return {"block_n": c}
    c = c._asdict() if isinstance(c, blocks.Tile) else c
    return {f: v for f, v in c.items() if v is not None and f != "acc_dtype"}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def tune_corpus_score(n: int, rho: int, k: int, Bq: int, K: int, *,
                      dtype: str = "float32",
                      candidates=DEFAULT_CANDIDATES,
                      sweep_bf16_acc: bool | None = None,
                      bf16_tol: float = 5e-2,
                      repeats: int = 3, seed: int = 0,
                      register: bool = True, hw: str | None = None,
                      device=None, inputs=None, segments: int = 1) -> TunedTile:
    """Sweep ``dplr_corpus_score(topk=K)`` geometries for one shape cell
    on ``device`` (``cuda`` unless the caller names the CPU) and return
    the parity-gated winner, registered into ``blocks`` unless
    ``register=False``.  ``candidates``: ``block_n`` ints, or dicts (or
    ``blocks.Tile``) of ``block_n``, ``group``, ``threads``, ``part``.
    ``hw``: the ``HW_PROFILES`` key for reporting (default: the device's).
    ``inputs``: the cell's ``(Q, a, e, P, aC, valid)`` (for example a
    served slab and its queries), else ``_mk_inputs(seed)``; the slab's
    ``a`` is read in the slab's type, as the kernels read it.

    ``segments > 1`` sweeps ``dplr_corpus_score_multi`` over that many
    slabs of n slots, the launch a packed wave makes, and registers the
    winner for such launches alone (``blocks.launch_class``); ``inputs``
    is then ``(Q_parts, a_parts, valid_parts, e (S, rho), P (S, Bq, rho,
    k), aC (S, Bq))``, else segment ``s`` is ``_mk_inputs(seed + s)``.

    ``sweep_bf16_acc=None`` sweeps bf16 accumulation exactly when the
    slab ``dtype`` is bfloat16: a f32 slab never trades accumulation
    precision.  A candidate that fails its gate or does not fit the card
    is recorded and never crowned; if none passes, this raises
    ``RuntimeError`` and registers nothing.
    """
    from repro_torch.device import resolve_device
    from repro_torch.kernels import dplr_corpus_score as _corpus
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import dplr_corpus_score_ref, dplr_corpus_topk_ref

    dev = resolve_device(device)
    hw = hw_for(dev) if hw is None else hw
    if hw not in HW_PROFILES:
        raise ValueError(f"unknown hw profile {hw!r}; have {sorted(HW_PROFILES)}")
    dtype = blocks.dtype_name(dtype)
    # the cell's backend key is what ops resolves with at the real call
    # sites (the tensors' device type), or winners would never be looked up
    cell = blocks.tile_cell(n, rho, k, Bq, K, dtype, dev.type)
    hit = _RESULTS.get((cell, segments))
    if hit is not None:
        if register:
            blocks.register_tuned_tile(cell, hit.block_n, hit.acc_dtype, group=hit.group,
                                       threads=hit.threads, part=hit.part, segments=segments)
        return hit

    slab = getattr(torch, dtype)
    if inputs is None:
        drawn = [_mk_inputs(n, rho, k, Bq, dtype, seed + s) for s in range(segments)]
        inputs = drawn[0] if segments == 1 else (
            *(tuple(d[j] for d in drawn) for j in (0, 1, 5)),
            *(torch.stack([d[j] for d in drawn]) for j in (2, 3, 4)))
    if segments == 1:
        Q, a, e, P, aC, valid = inputs
        Qs, As, Vs, es, Ps, aCs = (Q,), (a,), (valid,), e[None], P[None], aC[None]
    else:
        Qs, As, Vs, es, Ps, aCs = inputs
    if (len(Qs) != segments or any(tuple(q.shape) != (n, rho, k) or q.dtype != slab
                                   for q in Qs) or tuple(Ps.shape) != (segments, Bq, rho, k)):
        raise ValueError(f"inputs: Q {[tuple(q.shape) for q in Qs]} {Qs[0].dtype}, P "
                         f"{tuple(Ps.shape)} do not fit the cell {cell} on {segments} slabs")
    Qs = tuple(q.to(dev) for q in Qs)
    Vs = tuple(None if v is None else v.to(dev) for v in Vs)
    As = tuple(x.to(dev, slab) for x in As)
    es, Ps, aCs = es.to(dev), Ps.to(dev), aCs.to(dev)
    # the oracles, segment by segment, as rows of one (S * Bq, ...) table
    ref_scores = torch.cat([dplr_corpus_score_ref(Qs[s], As[s], es[s], Ps[s], aCs[s], Vs[s])
                            for s in range(segments)])
    refs = [dplr_corpus_topk_ref(Qs[s], As[s], es[s], Ps[s], aCs[s], K, Vs[s])
            for s in range(segments)]
    ref_vals, ref_idx = (torch.cat([r[j] for r in refs]) for j in (0, 1))

    if sweep_bf16_acc is None:
        sweep_bf16_acc = dtype == "bfloat16"
    accs = ("float32", "bfloat16") if sweep_bf16_acc else ("float32",)

    default = {"block_n": blocks.CORPUS_CHUNK}
    sweep, seen = [], set()
    for c in (default, *map(_candidate, candidates)):   # the default first
        key = tuple(sorted(c.items()))
        if key not in seen:
            seen.add(key)
            sweep.append(c)

    # a candidate's unset fields are the default's, never a registered
    # winner's: the sweep launches exactly what it lists
    fill = blocks.default_tile(Bq, K)._asdict()
    base = None                 # the default geometry's f32 output
    results: list[CandidateResult] = []
    for geo in sweep:
        launch = {f: fill[f] if geo.get(f) is None else geo[f]
                  for f in ("block_n", "group", "threads", "part")}
        for acc in accs:
            eff = blocks.resolve_tile(n, rho, k, Bq, K, dtype, dev.type, acc_dtype=acc,
                                      segments=segments, **launch)
            blocks.drain_clamp_events()     # isolate this candidate's
            if dev.type == "cuda" and not _corpus.geometry_fits(eff, True, rho, k, slab, K,
                                                                 dev):
                results.append(CandidateResult(
                    block_n=geo["block_n"], effective_block_n=eff.block_n, acc_dtype=acc,
                    us=float("inf"), parity_ok=False,
                    parity_error="does not fit the card's shared memory a block",
                    group=geo.get("group"), threads=geo.get("threads"), part=geo.get("part"),
                    effective=eff, fits=False))
                continue
            asked = blocks.Tile(acc_dtype=acc, **launch)
            if segments == 1:
                call = lambda: ops._corpus_score(Qs[0], As[0], es[0], Ps[0],  # noqa: E731
                                                 aCs[0], Vs[0], K, 0, 1, asked)
            else:
                call = lambda: ops._corpus_score_multi(Qs, As, Vs, es, Ps,  # noqa: E731
                                                       aCs, K, 0, 1, asked)
            vals, idx = (x.reshape(segments * Bq, K) for x in call())
            clamps = tuple(blocks.drain_clamp_events())
            err = _check_parity(vals, idx, ref_scores, ref_vals, acc, ref_idx, bf16_tol)
            if acc == "float32" and dev.type == "cuda":
                if base is None:
                    base = (vals, idx)
                elif err is None and not (_same_bits(vals, base[0])
                                          and torch.equal(idx, base[1])):
                    err = "f32 output not bitwise the default geometry's"
            us = _time_call(call, repeats, dev) if err is None else float("inf")
            blocks.drain_clamp_events()
            results.append(CandidateResult(
                block_n=geo["block_n"], effective_block_n=eff.block_n, acc_dtype=acc, us=us,
                parity_ok=err is None, parity_error=err, clamps=clamps,
                group=geo.get("group"), threads=geo.get("threads"), part=geo.get("part"),
                effective=eff, fits=True))

    passing = [r for r in results if r.parity_ok]
    if not passing:
        raise RuntimeError(f"autotune cell {cell}: no candidate passed the parity gate")
    winner = min(passing, key=lambda r: r.us)
    default_us = results[0].us          # the default geometry in f32, swept first
    itemsize = Qs[0].element_size()
    slab_bytes = n * rho * k * itemsize + n * (itemsize + 1)
    out_bytes = Bq * K * 8 + Bq * rho * k * itemsize
    tuned = TunedTile(cell=cell, block_n=winner.block_n, acc_dtype=winner.acc_dtype,
                      us=winner.us, default_us=default_us, swept=tuple(results), hw=hw,
                      bytes_per_call=segments * (slab_bytes + out_bytes), group=winner.group,
                      threads=winner.threads, part=winner.part, segments=segments)
    _RESULTS[(cell, segments)] = tuned
    if register:
        blocks.register_tuned_tile(cell, tuned.block_n, tuned.acc_dtype, group=tuned.group,
                                   threads=tuned.threads, part=tuned.part, segments=segments)
    return tuned


# -- optional on-disk registry cache ----------------------------------------

_GEOMETRY_KEYS = ("group", "threads", "part")


def save_cache(path) -> int:
    """Write every in-process sweep winner to ``path`` (JSON, the
    reference's format; a winner's ``group``, ``threads`` and ``part``,
    where set, in keys of their own; a winner timed on S > 1 slabs under
    its cell with S appended, a key the reference never looks up).
    Returns the number of cells written."""
    payload = {}
    for t in _RESULTS.values():
        rec = {"block_n": t.block_n, "acc_dtype": t.acc_dtype, "us": t.us,
               "default_us": t.default_us}
        rec.update({key: getattr(t, key) for key in _GEOMETRY_KEYS
                    if getattr(t, key) is not None})
        payload[json.dumps(t.cell + ((t.segments,) if t.segments > 1 else ()))] = rec
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    return len(payload)


def load_cache(path, *, register: bool = True) -> int:
    """Re-register winners from a ``save_cache`` file of either package
    (a warm process skips the sweep).  Returns the number of cells
    loaded; 0 when the file does not exist: a cold cache is not an
    error."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except FileNotFoundError:
        return 0
    for cell_s, rec in payload.items():
        cell = tuple(json.loads(cell_s))
        if register:
            blocks.register_tuned_tile(cell[:7], int(rec["block_n"]), str(rec["acc_dtype"]),
                                       segments=cell[7] if len(cell) > 7 else 1,
                                       **{key: int(rec[key]) for key in _GEOMETRY_KEYS
                                          if key in rec})
    return len(payload)

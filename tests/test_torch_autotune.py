"""The port's tuned-tile registry and autotuner (``kernels/blocks.py``,
``kernels/autotune.py``) on the CPU, against the JAX package's.

Every case of ``tests/test_kernel_autotune.py`` runs here on the port with
``device='cpu'``; then parity cases hold the port to the reference: the
same numpy draws, the same parity verdicts, the same resolution of the
same registrations, each package's cache file loaded by the other, and a
``block_n=None`` corpus call resolved through a ``'bfloat16'`` winner
registered in both.  The plain versions have no tiles, so on the CPU a
geometry changes no result: each case holds results bitwise or within the
reference's bf16 tolerance (5e-2).

Every case clears both packages' registries, sweep memos and clamp logs
around itself: a tuned tile is process-global state that must never leak
into another test (other suites call the corpus scorer with
``block_n=None`` and rely on the untuned default).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels import blocks as jblocks  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import autotune, blocks, ops  # noqa: E402
from repro_torch.serving import CorpusState, ScorerRuntime  # noqa: E402

from test_torch_serving import _params, _setup  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

# small-but-ragged cell: fast to sweep, exercises a non-pow2 last tile
CELL = dict(n=200, rho=2, k=4, Bq=2, K=4)
CANDS = (64, 128)
CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_registries():
    def clean():
        for tuner, reg in ((autotune, blocks), (jautotune, jblocks)):
            tuner.clear_results()
            reg.clear_tuned_tiles()
            reg.drain_clamp_events()
    clean()
    yield
    clean()


def _tune(**kw):
    args = dict(CELL)
    args.update(candidates=CANDS, repeats=1, device=CPU)
    args.update(kw)
    return autotune.tune_corpus_score(
        args.pop("n"), args.pop("rho"), args.pop("k"),
        args.pop("Bq"), args.pop("K"), **args)


def _cell_tile(n=CELL["n"], Bq=CELL["Bq"], K=CELL["K"], dtype="float32"):
    return blocks.corpus_tile(n, CELL["rho"], CELL["k"], Bq, K, dtype, CPU)


# -- the reference's cases, on the port ---------------------------------------

def test_tune_registers_winner_and_ops_resolves():
    tuned = _tune()
    # the default geometry always competes, even when not a candidate
    swept_bns = {r.block_n for r in tuned.swept}
    assert set(CANDS) <= swept_bns and blocks.CORPUS_CHUNK in swept_bns
    assert all(r.parity_ok for r in tuned.swept)
    assert tuned.block_n in swept_bns and tuned.us <= tuned.default_us

    # registry: block_n=None resolution returns the registered winner
    assert _cell_tile()[:2] == (tuned.block_n, tuned.acc_dtype)

    # and a block_n=None call is bit-identical to the explicit winner
    Q, a, e, P, aC, valid = autotune._mk_inputs(
        CELL["n"], CELL["rho"], CELL["k"], CELL["Bq"], "float32", seed=3)
    v0, i0 = ops.dplr_corpus_score(Q, a, e, P, aC, valid=valid, topk=CELL["K"])
    v1, i1 = ops.dplr_corpus_score(Q, a, e, P, aC, valid=valid, topk=CELL["K"],
                                   block_n=tuned.block_n, acc_dtype=tuned.acc_dtype)
    assert torch.equal(v0, v1) and torch.equal(i0, i1)


def test_family_fallback_and_exact_precedence():
    """The reference's case, its family lookups kept in the winner's query
    group (Bq = 2 and 8 have groups 2 and 8): the port carries a family
    winner's geometry only within its launch class."""
    tuned = _tune(dtype="bfloat16", candidates=(64,), sweep_bf16_acc=False)
    # a DIFFERENT K of the same (n, rho, k, dtype, backend) family and query
    # group inherits the newest family winner instead of the blind default
    assert _cell_tile(K=16, dtype="bfloat16")[:2] == (tuned.block_n, tuned.acc_dtype)
    # another query group inherits its acc_dtype alone, as the reference's
    assert _cell_tile(Bq=8, K=16, dtype="bfloat16") == blocks.default_tile(8, 16)._replace(
        acc_dtype=tuned.acc_dtype)
    # but an unrelated shape family stays on the untuned default
    assert _cell_tile(n=CELL["n"] + 1) == blocks.default_tile(CELL["Bq"], CELL["K"])
    # and the exact cell wins over a newer family winner
    tuned = _tune()
    blocks.register_tuned_tile(blocks.tile_cell(CELL["n"], CELL["rho"], CELL["k"], 8, 16,
                                                "float32", CPU), 96)
    assert _cell_tile()[:2] == (tuned.block_n, tuned.acc_dtype)
    assert _cell_tile(Bq=6, K=5).block_n == 96


def test_untuned_resolution_is_the_default():
    got = blocks.corpus_tile(4096, 3, 8, 4, 10, "float32", CPU)
    assert got == blocks.default_tile(4, 10) == (
        blocks.CORPUS_CHUNK, "float32", 4, blocks.CORPUS_THREADS, blocks.CORPUS_PART)
    assert blocks.corpus_tile(4096, 3, 8, 20, None, "bfloat16", "cuda") == (
        blocks.CORPUS_FULL_BLOCK_N, "float32", 16, blocks.CORPUS_FULL_THREADS,
        blocks.CORPUS_PART)
    # and resolution of an untuned call is the default, unclamped
    assert blocks.resolve_tile(100, 3, 8, 3, 10, "float32", CPU) == blocks.default_tile(3, 10)
    assert blocks.drain_clamp_events() == []


def test_memo_returns_same_object_without_resweep(monkeypatch):
    tuned = _tune()

    def boom(*a, **k):  # pragma: no cover - would fail the test
        raise AssertionError("memoised cell re-swept")
    monkeypatch.setattr(ops, "_corpus_score", boom)
    again = _tune()
    assert again is tuned
    # the memo hit still re-registers (fresh registry, warm memo)
    blocks.clear_tuned_tiles()
    _tune()
    assert _cell_tile()[:2] == (tuned.block_n, tuned.acc_dtype)


def test_check_parity_gates():
    ref_scores = np.array([[5.0, 4.0, 3.0, 2.0, 1.0]])
    ref_vals = np.array([[5.0, 4.0]])
    ref_idx = np.array([[0, 1]])
    ok = dict(ref_scores=ref_scores, ref_vals=ref_vals, ref_idx=ref_idx, bf16_tol=5e-2)
    # f32: exact indices, epsilon values
    assert autotune._check_parity(ref_vals, ref_idx, acc_dtype="float32", **ok) is None
    assert "indices" in autotune._check_parity(
        ref_vals, np.array([[0, 2]]), acc_dtype="float32", **ok)
    assert "values" in autotune._check_parity(
        ref_vals + 1.0, ref_idx, acc_dtype="float32", **ok)
    # bf16: judged by the selected items' ref scores
    tie = dict(ok, ref_scores=np.array([[5.0, 4.99, 3.0, 2.0, 1.0]]),
               ref_vals=np.array([[5.0, 4.99]]))
    assert autotune._check_parity(np.array([[4.98, 5.01]]), np.array([[1, 0]]),
                                  acc_dtype="bfloat16", **tie) is None
    bad = autotune._check_parity(np.array([[5.0, 3.0]]), np.array([[0, 2]]),
                                 acc_dtype="bfloat16", **tie)
    assert "tolerance" in bad
    # tensors are taken as they come from the kernels
    assert autotune._check_parity(torch.tensor(ref_vals), torch.tensor(ref_idx),
                                  acc_dtype="float32", **ok) is None


def test_no_passing_candidate_raises(monkeypatch):
    def broken(Q, a, e, P, aC, valid, topk, index_offset, index_stride, asked):
        return (torch.zeros((P.shape[0], topk)),
                torch.zeros((P.shape[0], topk), dtype=torch.int32))
    monkeypatch.setattr(ops, "_corpus_score", broken)
    with pytest.raises(RuntimeError, match="no candidate passed"):
        _tune()
    # nothing was registered from the failed sweep
    assert _cell_tile() == blocks.default_tile(CELL["Bq"], CELL["K"])


def test_oversized_candidate_clamps_visibly():
    n = 130
    tuned = autotune.tune_corpus_score(n, CELL["rho"], CELL["k"], CELL["Bq"], CELL["K"],
                                       candidates=(512, {"block_n": 64, "group": 16}),
                                       repeats=1, register=False, device=CPU)
    over = [r for r in tuned.swept if r.block_n > n]
    assert over, "sweep lost the oversized candidates"
    for r in over:
        assert r.effective_block_n == n and r.effective.block_n == n
        assert r.parity_ok
        assert any(ev["requested"] == r.block_n and ev["effective"] == n for ev in r.clamps)
    # a group past the cell's Bq clamps the same way, to group_size(Bq)
    (grouped,) = [r for r in tuned.swept if r.group == 16]
    assert grouped.effective.group == blocks.group_size(CELL["Bq"]) == 2
    assert {"requested": 16, "effective": 2, "n": 2} in grouped.clamps
    # register=False: the registry stays untouched
    assert blocks.corpus_tile(n, CELL["rho"], CELL["k"], CELL["Bq"], CELL["K"], "float32",
                              CPU) == blocks.default_tile(CELL["Bq"], CELL["K"])


def test_bf16_slab_sweeps_both_accumulators():
    tuned = _tune(dtype="bfloat16", register=False)
    assert {r.acc_dtype for r in tuned.swept} == {"float32", "bfloat16"}
    # the winner passed its gate whichever accumulator it used
    assert any(r.parity_ok and r.block_n == tuned.block_n
               and r.acc_dtype == tuned.acc_dtype for r in tuned.swept)


def test_cache_roundtrip(tmp_path):
    path = tmp_path / "tiles.json"
    # cold cache is not an error
    assert autotune.load_cache(path) == 0
    tuned = _tune(candidates=({"block_n": 64, "threads": 128, "part": 8192},))
    assert autotune.save_cache(path) == 1

    autotune.clear_results()
    blocks.clear_tuned_tiles()
    assert autotune.load_cache(path, register=False) == 1
    assert _cell_tile() == blocks.default_tile(CELL["Bq"], CELL["K"])
    assert autotune.load_cache(path) == 1
    got = _cell_tile()
    assert got[:2] == (tuned.block_n, tuned.acc_dtype)
    # the rest of the winner's geometry survives the file too
    d = blocks.default_tile(CELL["Bq"], CELL["K"])
    assert (got.group, got.threads, got.part) == tuple(
        d[i] if v is None else v for i, v in zip((2, 3, 4), (tuned.group, tuned.threads,
                                                             tuned.part)))


# -- the port's own rules -------------------------------------------------------

def test_a_sweep_launches_its_candidates_not_a_registered_winner():
    """A candidate's unset fields are the default's even where a family
    winner is registered: the default candidate is the default geometry."""
    blocks.register_tuned_tile(blocks.tile_cell(CELL["n"], CELL["rho"], CELL["k"], 8, 16,
                                                "float32", CPU), 96, group=8, threads=64,
                               part=4096)
    tuned = _tune(candidates=({"block_n": 64, "part": 8192},))
    d = blocks.default_tile(CELL["Bq"], CELL["K"])
    default, listed = tuned.swept
    assert (default.effective.group, default.effective.threads) == (d.group, d.threads)
    assert default.effective.part == CELL["n"]      # the default part, clamped to the row
    assert listed.effective == (64, "float32", d.group, d.threads, 256)   # 200 slots in chunks


def test_registry_refuses_what_the_kernels_do_not_take():
    cell = blocks.tile_cell(200, 2, 4, 2, 4, "float32", CPU)
    for bad in (dict(block_n=0), dict(block_n=blocks.MAX_BLOCK_N + 1),
                dict(block_n=64, acc_dtype="float16"), dict(block_n=64, group=3),
                dict(block_n=64, threads=48), dict(block_n=64, threads=512),
                dict(block_n=64, part=1000)):
        with pytest.raises(ValueError):
            blocks.register_tuned_tile(cell, **bad)
    assert blocks._TUNED_TILES == {}
    with pytest.raises(ValueError, match="segments"):
        blocks.register_tuned_tile(cell, 64, segments=0)
    with pytest.raises(ValueError, match="group"):
        blocks.resolve_tile(200, 2, 4, 2, 4, "float32", CPU, group=5)
    Q, a, e, P, aC, valid = autotune._mk_inputs(200, 2, 4, 2, "float32", seed=1)
    with pytest.raises(ValueError, match="block_n"):
        ops.dplr_corpus_score(Q, a, e, P, aC, valid=valid, topk=4, block_n=0)


def test_the_entry_points_take_the_references_geometry_keywords_alone():
    """``block_n`` and ``acc_dtype`` are the corpus calls' only geometry
    keywords, as in the reference; the rest of a launch's geometry comes
    from the registry (or the tuner's own entry)."""
    import inspect
    for name in ("dplr_corpus_score", "dplr_corpus_score_multi"):
        params = set(inspect.signature(getattr(ops, name)).parameters)
        # the reference's Pallas interpret mode has no counterpart on the card
        want = set(inspect.signature(getattr(jops, name)).parameters) - {"interpret"}
        assert params == want, name


def test_a_top_k_winner_never_sets_the_full_modes_threads():
    blocks.register_tuned_tile(blocks.tile_cell(200, 2, 4, 2, 4, "float32", CPU), 64,
                               threads=128, part=8192)
    # a top-K winner's geometry never reaches the full mode (another class)
    assert blocks.resolve_tile(200, 2, 4, 2, None, "float32", CPU) == blocks.default_tile(2, None)
    # a full-mode record sets its block_n and group, never its threads
    blocks.register_tuned_tile(blocks.tile_cell(200, 2, 4, 2, None, "float32", CPU), 64,
                               threads=64)
    full = blocks.resolve_tile(200, 2, 4, 2, None, "float32", CPU)
    assert full.block_n == 64 and full.threads == blocks.CORPUS_FULL_THREADS
    topk = blocks.resolve_tile(200, 2, 4, 2, 9, "float32", CPU)
    # the part clamped to the row: 200 slots in whole chunks of 64
    assert (topk.block_n, topk.threads, topk.part) == (64, 128, 256)
    assert blocks.drain_clamp_events() == [{"requested": 8192, "effective": 256, "n": 256}]


def test_a_family_winner_clamps_visibly_at_a_smaller_bq_and_n():
    blocks.register_tuned_tile(blocks.tile_cell(100, 2, 4, 2, 4, "float32", CPU), 4096,
                               group=16)
    # at a smaller Bq of its query group (Bq = 2 and 1 are groups 2 and 1)
    # and past the slab's n: clamped, visibly
    tile = blocks.resolve_tile(100, 2, 4, 2, 9, "float32", CPU)
    assert (tile.block_n, tile.group) == (100, 2)
    assert blocks.drain_clamp_events() == [
        {"requested": 4096, "effective": 100, "n": 100},
        {"requested": 16, "effective": 2, "n": 2}]
    # a part so small that the row would need too many merge blocks widens
    tile = blocks.resolve_tile(1 << 27, 2, 4, 1, 4, "float32", "cuda", part=1024)
    assert tile.part >= (1 << 27) / blocks.MAX_PARTS and tile.part % 1024 == 0
    assert blocks.drain_clamp_events() == [
        {"requested": 1024, "effective": tile.part, "n": 1 << 27}]


def test_a_winners_geometry_stays_in_its_launch_class():
    """A winner's geometry applies only where it was timed: the same family,
    query group, mode and number of slabs.  Its acc_dtype follows the
    reference's family rule everywhere."""
    cell = blocks.tile_cell(4096, 3, 8, 1, 16, "float32", CPU)
    blocks.register_tuned_tile(cell, 2048, "bfloat16", threads=128)
    want = blocks.Tile(2048, "bfloat16", 1, 128, blocks.CORPUS_PART)
    assert blocks.corpus_tile(4096, 3, 8, 1, 100, "float32", CPU) == want
    for Bq, K, segments in ((16, 16, 1), (2, 16, 1), (1, None, 1), (1, 16, 4)):
        got = blocks.corpus_tile(4096, 3, 8, Bq, K, "float32", CPU, segments=segments)
        assert got == blocks.default_tile(Bq, K)._replace(acc_dtype="bfloat16"), (Bq, K)
    # a winner timed on 4 slabs applies to 4-slab launches of its class alone
    blocks.register_tuned_tile(cell, 256, segments=4)
    assert blocks.corpus_tile(4096, 3, 8, 1, 16, "float32", CPU, segments=4)[:2] == (
        256, "float32")
    assert blocks.corpus_tile(4096, 3, 8, 1, 16, "float32", CPU)[:2] == (2048, "float32")
    assert blocks.corpus_tile(4096, 3, 8, 1, 16, "float32", CPU, segments=3).block_n == (
        blocks.CORPUS_CHUNK)
    assert blocks.launch_class(cell) != blocks.launch_class(cell, 4)


def test_a_registered_geometry_that_does_not_fit_is_halved_visibly():
    """With a fit predicate (on the card, the device's shared memory), a
    registered chunk that does not fit is halved, each step a clamp event,
    until it does; an explicit ask and the default are never shrunk."""
    fits = lambda tile: tile.block_n <= 1024  # noqa: E731
    cell = blocks.tile_cell(1 << 16, 3, 8, 16, 16, "float32", CPU)
    assert blocks.resolve_tile(*cell, fits=fits) == blocks.default_tile(16, 16)
    blocks.register_tuned_tile(cell, 8192, group=16)
    tile = blocks.resolve_tile(*cell, fits=fits)
    assert (tile.block_n, tile.group) == (1024, 16)
    assert blocks.drain_clamp_events() == [
        {"requested": 8192, "effective": 4096, "n": 1 << 16},
        {"requested": 4096, "effective": 2048, "n": 1 << 16},
        {"requested": 2048, "effective": 1024, "n": 1 << 16}]
    assert blocks.resolve_tile(*cell, block_n=8192, group=16, threads=256,
                               part=16384, fits=fits).block_n == 8192
    assert blocks.drain_clamp_events() == []


def test_a_packed_wave_is_tuned_through_the_multi_tenant_call():
    """``segments=S`` sweeps ``dplr_corpus_score_multi`` on S slabs and
    registers the winner for S-slab launches: a ``block_n=None`` fused call
    is then the explicit winner's, and the result survives a cache file."""
    tuned = _tune(segments=3, candidates=({"block_n": 64, "part": 1024},))
    assert tuned.segments == 3 and all(r.parity_ok for r in tuned.swept)
    assert blocks.corpus_tile(*CELL.values(), "float32", CPU, segments=3)[:2] == (
        tuned.block_n, tuned.acc_dtype)
    assert blocks.corpus_tile(*CELL.values(), "float32", CPU) == blocks.default_tile(
        CELL["Bq"], CELL["K"])
    drawn = [autotune._mk_inputs(CELL["n"], CELL["rho"], CELL["k"], CELL["Bq"], "float32", s)
             for s in range(3)]
    Q, a, valid = (tuple(d[j] for d in drawn) for j in (0, 1, 5))
    e, P, aC = (torch.stack([d[j] for d in drawn]) for j in (2, 3, 4))
    got = ops.dplr_corpus_score_multi(Q, a, valid, e, P, aC, topk=CELL["K"])
    for s in range(3):
        want = ops.dplr_corpus_score(Q[s], a[s], e[s], P[s], aC[s], valid=valid[s],
                                     topk=CELL["K"])
        assert torch.equal(got[0][s], want[0]) and torch.equal(got[1][s], want[1])


def test_a_multi_slab_winner_survives_a_cache_file(tmp_path):
    path = tmp_path / "tiles.json"
    tuned = _tune(segments=2, candidates=({"block_n": 64, "part": 1024},))
    assert autotune.save_cache(path) == 1
    blocks.clear_tuned_tiles()
    assert autotune.load_cache(path) == 1
    assert blocks.corpus_tile(*CELL.values(), "float32", CPU, segments=2)[:2] == (
        tuned.block_n, tuned.acc_dtype)
    assert blocks.corpus_tile(*CELL.values(), "float32", CPU) == blocks.default_tile(
        CELL["Bq"], CELL["K"])
    # the reference reads the file too; its keys never match a lookup
    assert jautotune.load_cache(path) == 1


def test_a_cpu_winner_never_applies_on_the_card():
    blocks.register_tuned_tile(blocks.tile_cell(200, 2, 4, 2, 4, "float32", CPU), 64,
                               "bfloat16")
    assert blocks.corpus_tile(200, 2, 4, 2, 4, "float32", "cuda") == blocks.default_tile(2, 4)
    assert blocks.corpus_tile(200, 2, 4, 2, 4, "float32", CPU)[:2] == (64, "bfloat16")


def test_multi_resolves_through_the_largest_segments_cell():
    """The fused call takes the largest segment's cell with Bq = P_C's
    second axis: a 'bfloat16' winner there turns its accumulation, bitwise
    the explicit call's; an untuned call is the 'float32' one."""
    rng = np.random.default_rng(5)
    ns, Bq, K, rho, k = (90, 300, 150), 2, 6, 2, 4
    Q = tuple(torch.from_numpy(rng.standard_normal((n, rho, k), dtype=np.float32)) for n in ns)
    a = tuple(torch.from_numpy(rng.standard_normal(n, dtype=np.float32)) for n in ns)
    e = torch.from_numpy(rng.random((3, rho), dtype=np.float32) + 0.5)
    P = torch.from_numpy(rng.standard_normal((3, Bq, rho, k), dtype=np.float32))
    aC = torch.from_numpy(rng.standard_normal((3, Bq), dtype=np.float32))
    def call(**kw):
        return ops.dplr_corpus_score_multi(Q, a, None, e, P, aC, topk=K, **kw)
    f32, acc16 = call(acc_dtype="float32"), call(acc_dtype="bfloat16")
    assert not torch.equal(f32[0], acc16[0])
    for got, want in zip(call(), f32):
        assert torch.equal(got, want)
    blocks.register_tuned_tile(blocks.tile_cell(300, rho, k, Bq, K, "float32", CPU), 96,
                               "bfloat16")
    for got, want in zip(call(), acc16):
        assert torch.equal(got, want)


def test_runtime_and_engine_thread_block_n():
    """``ScorerRuntime(block_n=)`` reaches every corpus call: a valid one
    serves the default's results (no tiles on the CPU), an invalid one
    raises from ops; ``CorpusState`` passes it to the runtime it builds."""
    jcfg, cfg, _, q, ctx = _setup()
    _, params = _params(jcfg, 0)
    item_ids = q["item_ids"][0]
    base = CorpusState(cfg, item_ids, device=CPU)
    base.refresh(params)
    tuned = CorpusState(cfg, item_ids, device=CPU, block_n=64)
    tuned.refresh(params)
    assert tuned.runtime.block_n == 64
    for got, want in zip(tuned.topk(ctx, 5), base.topk(ctx, 5)):
        assert torch.equal(got, want)
    assert torch.equal(tuned.score(ctx), base.score(ctx))
    bad = CorpusState(cfg, item_ids, runtime=ScorerRuntime(cfg, device=CPU, block_n=0))
    bad.refresh(params)
    with pytest.raises(ValueError, match="block_n"):
        bad.topk(ctx, 5)
    with pytest.raises(ValueError, match="runtime property"):
        CorpusState(cfg, item_ids, runtime=base.runtime, block_n=64)


def test_hw_profiles_are_the_cards_and_a_rough_cpu():
    assert set(autotune.HW_PROFILES) == {"H200", "H100 PCIe", "H100 NVL", "H100", "cpu"}
    for prof in autotune.HW_PROFILES.values():
        assert set(prof) == {"hbm_bw", "f32_flops", "bf16_flops", "link_bw"}
    assert autotune.hw_for(CPU) == "cpu" and autotune.DEFAULT_HW in autotune.HW_PROFILES
    tuned = _tune()
    assert tuned.hw == "cpu" and tuned.roofline_frac > 0 and tuned.speedup >= 1.0


# -- parity with the JAX package -------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mk_inputs_gives_the_references_arrays(dtype):
    got = autotune._mk_inputs(300, 3, 4, 5, dtype, seed=11)
    want = jautotune._mk_inputs(300, 3, 4, 5, jnp.dtype(dtype), seed=11)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        assert np.array_equal(g, np.asarray(w, g.dtype))


_PARITY_CASES = {
    "f32 pass": ([[5.0, 4.99]], [[0, 1]], "float32"),
    "f32 indices": ([[5.0, 4.0]], [[0, 2]], "float32"),
    "f32 values": ([[5.0, 3.9]], [[0, 1]], "float32"),
    "bf16 pass (near tie swapped)": ([[4.98, 5.01]], [[1, 0]], "bfloat16"),
    "bf16 items": ([[5.0, 3.0]], [[0, 2]], "bfloat16"),
    "bf16 values": ([[5.0, 4.8]], [[0, 1]], "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(_PARITY_CASES))
def test_check_parity_gives_the_references_verdict(case):
    vals, idx, acc = _PARITY_CASES[case]
    args = dict(ref_scores=np.array([[5.0, 4.99, 3.0, 2.0, 1.0]]),
                ref_vals=np.array([[5.0, 4.99]]), ref_idx=np.array([[0, 1]]),
                acc_dtype=acc, bf16_tol=5e-2)
    got = autotune._check_parity(np.array(vals), np.array(idx), **args)
    assert got == jautotune._check_parity(np.array(vals), np.array(idx), **args)
    assert (got is None) == case.endswith(("pass", "swapped)"))


def test_the_same_registrations_resolve_alike_in_both_registries():
    backend = jax.default_backend()
    regs = [((200, 2, 4, 2, 4, "float32"), 64, "float32"),
            ((200, 2, 4, 8, 16, "float32"), 128, "float32"),     # newer family winner
            ((512, 3, 8, 1, 10, "bfloat16"), 256, "bfloat16")]
    for cell, bn, acc in regs:
        blocks.register_tuned_tile(blocks.tile_cell(*cell, CPU), bn, acc)
        jblocks.register_tuned_tile(jblocks.tile_cell(*cell, backend), bn, acc)
    # in a registration's launch class (family, query group, mode): the same
    # (block_n, acc_dtype); elsewhere the same acc_dtype, the default geometry
    same_class = [(200, 2, 4, 2, 4, "float32"), (200, 2, 4, 8, 16, "float32"),
                  (200, 2, 4, 6, 9, "float32"), (512, 3, 8, 1, 10, "bfloat16"),
                  (512, 3, 8, 1, 3, "bfloat16")]
    for q in same_class:
        assert blocks.corpus_tile(*q, CPU)[:2] == jblocks.corpus_tile(*q, backend), q
    for q in [(200, 2, 4, 3, None, "float32"), (200, 2, 4, 16, 4, "float32"),
              (512, 3, 8, 16, 10, "bfloat16")]:
        got = blocks.corpus_tile(*q, CPU)
        assert got.acc_dtype == jblocks.corpus_tile(*q, backend)[1], q
        assert got == blocks.default_tile(*q[3:5])._replace(acc_dtype=got.acc_dtype), q
    # unregistered families: each package's own default
    assert blocks.corpus_tile(201, 2, 4, 2, 4, "float32", CPU) == blocks.default_tile(2, 4)
    assert jblocks.corpus_tile(201, 2, 4, 2, 4, "float32", backend) == (
        jblocks.CORPUS_TILE_N, "float32")


def test_each_packages_cache_file_loads_in_the_other(tmp_path):
    backend = jax.default_backend()
    assert backend == CPU
    # the reference writes, the port reads
    jt = jautotune.tune_corpus_score(**CELL, candidates=(64,), repeats=1)
    jpath = tmp_path / "jax_tiles.json"
    assert jautotune.save_cache(jpath) == 1
    assert autotune.load_cache(jpath) == 1
    assert _cell_tile()[:2] == (jt.block_n, jt.acc_dtype)
    # the port writes (with its extra geometry keys), the reference reads
    blocks.clear_tuned_tiles()
    jblocks.clear_tuned_tiles()
    pt = _tune(n=300, candidates=({"block_n": 96, "threads": 64},))
    ppath = tmp_path / "port_tiles.json"
    assert autotune.save_cache(ppath) == 1
    assert jautotune.load_cache(ppath) == 1
    assert jblocks.corpus_tile(300, CELL["rho"], CELL["k"], CELL["Bq"], CELL["K"], "float32",
                               backend) == (pt.block_n, pt.acc_dtype)


def test_a_bf16_winner_in_both_registries_resolves_alike_in_ops():
    """A 'bfloat16' winner registered for a bf16 cell in both packages: the
    port's ``block_n=None`` call matches the reference's ``ops`` call within
    the reference's bf16 tolerance (the items each selects, judged by their
    f32 scores, within 5e-2 of each other; values within 5e-2 or one bf16
    rounding, as the two packages round a bf16 sum in different orders), and
    is bitwise the port's explicit ``acc_dtype='bfloat16'`` call (and
    differs from the 'float32' one)."""
    n, rho, k, Bq, K = 200, 3, 4, 3, 8
    cell = (n, rho, k, Bq, K, "bfloat16")
    blocks.register_tuned_tile(blocks.tile_cell(*cell, CPU), 64, "bfloat16")
    jblocks.register_tuned_tile(jblocks.tile_cell(*cell, jax.default_backend()), 64,
                                "bfloat16")
    Q, a, e, P, aC, valid = autotune._mk_inputs(n, rho, k, Bq, "bfloat16", seed=7)
    jQ, ja, je, jP, jaC, jv = jautotune._mk_inputs(n, rho, k, Bq, jnp.bfloat16, seed=7)
    vals, ids = ops.dplr_corpus_score(Q, a, e, P, aC, valid=valid, topk=K)
    wv, wi = jops.dplr_corpus_score(jQ, ja, je, jP, jaC, valid=jv, topk=K)
    f32 = ops.dplr_corpus_score(Q, a, e, P, aC, valid=valid, acc_dtype="float32").numpy()
    picked = [-np.sort(-np.take_along_axis(f32, np.asarray(i, np.int64), axis=1), axis=1)
              for i in (ids, wi)]
    np.testing.assert_allclose(picked[0], picked[1], rtol=0, atol=5e-2)
    np.testing.assert_allclose(vals.numpy(), np.asarray(wv, np.float32), rtol=2**-7, atol=5e-2)
    ev, ei = ops.dplr_corpus_score(Q, a, e, P, aC, valid=valid, topk=K, block_n=64,
                                   acc_dtype="bfloat16")
    assert torch.equal(vals, ev) and torch.equal(ids, ei)
    fv, _ = ops.dplr_corpus_score(Q, a, e, P, aC, valid=valid, topk=K, acc_dtype="float32")
    assert not torch.equal(vals, fv)


def test_the_ports_autotune_has_no_krn_tune_offender(tmp_path):
    sys.path.insert(0, str(REPO / "tools" / "analyze"))
    import core
    import kernel_contract
    path = REPO / "src" / "repro_torch" / "kernels" / "autotune.py"
    assert list(kernel_contract._tune_offenders(core.SourceFile(path, REPO))) == []
    # the rule is not vacuous here: without its oracles the tuner offends
    ungated = tmp_path / "autotune.py"
    ungated.write_text(path.read_text().replace("_ref(", "_oracle(").replace("_ref\n", "\n")
                       .replace("_ref,", ","))
    names = [f.name for f in kernel_contract._tune_offenders(core.SourceFile(ungated, tmp_path))]
    assert names == ["tune_corpus_score"]


# -- bf16 accumulation at the served cell (ROADMAP §3) ---------------------------

def _acc_cell(n: int, acc: str):
    """Both packages' top-16 of the tuner's cell (rho 3, k 16, Bq 1, a bf16
    slab, seed 0) under ``acc_dtype=acc``, each from its own ``_mk_inputs``
    and ``ops`` (the JAX Pallas kernel in interpret mode, the port's plain
    version on the CPU), and each one's own ``_check_parity`` verdict
    against its own f32 oracle."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref

    out = {}
    jQ, ja, je, jP, jaC, jvalid = jautotune._mk_inputs(n, 3, 16, 1, jnp.bfloat16, 0)
    Q32, P32 = jnp.asarray(jQ, jnp.float32), jnp.asarray(jP, jnp.float32)
    jscores = np.asarray(jref.dplr_corpus_score_ref(Q32, ja, je, P32, jaC, jvalid))
    jrv, jri = jref.dplr_corpus_topk_ref(Q32, ja, je, P32, jaC, 16, jvalid)
    vals, ids = jops.dplr_corpus_score(jQ, ja, je, jP, jaC, valid=jvalid, topk=16,
                                       acc_dtype=acc, interpret=True)
    out["jax"] = jautotune._check_parity(vals, ids, jscores, np.asarray(jrv), acc,
                                         np.asarray(jri), 5e-2)
    Q, a, e, P, aC, valid = autotune._mk_inputs(n, 3, 16, 1, "bfloat16", 0)
    scores = ref.dplr_corpus_score_ref(Q, a, e, P, aC, valid)
    rv, ri = ref.dplr_corpus_topk_ref(Q, a, e, P, aC, 16, valid)
    vals, ids = ops.dplr_corpus_score(Q, a, e, P, aC, valid, topk=16, acc_dtype=acc)
    out["port"] = autotune._check_parity(vals, ids, scores, rv, acc, ri, 5e-2)
    return out


@pytest.mark.parametrize("n", [1 << 16, 1 << 20])
def test_bf16_accumulation_fails_the_gate_in_both_packages(n):
    """The tuner's 5e-2 gate on the served cell at n = 65,536 and at full
    width (2^20, the served cell): f32 accumulation passes in both packages,
    bf16 accumulation fails in both.  A score of tens rounded to bf16 is
    off by up to half a unit: the reference's own behaviour, not a fault of
    the port's accumulation (ROADMAP §3)."""
    f32 = _acc_cell(n, "float32")
    assert f32 == {"jax": None, "port": None}
    bf16 = _acc_cell(n, "bfloat16")
    assert bf16["jax"] is not None and bf16["port"] is not None, bf16


def test_bf16_accumulation_scores_match_the_reference():
    """At n = 65,536 (rho 3, k 16, Bq 1, the tuner's seed 0), every live
    slot's bf16-accumulated score of the port's plain version within
    ``(2 rho + 1) 2^-8 size`` of the JAX Pallas kernel's (interpret mode),
    ``size = 0.5 sum_r |e_r| ||P_C + Q_I,r||^2``.  The port rounds each
    square, each e_r and the sum to bf16; the reference also rounds each
    r's sum over k and the adds of its bf16 dot over r (XLA's
    ``reduce_sum`` and ``dot_general`` in bf16): each rounding moves a score
    by at most 2^-8 of ``size``."""
    n, rho = 1 << 16, 3
    jQ, ja, je, jP, jaC, jvalid = jautotune._mk_inputs(n, rho, 16, 1, jnp.bfloat16, 0)
    want = np.asarray(jops.dplr_corpus_score(jQ, ja, je, jP, jaC, valid=jvalid,
                                             acc_dtype="bfloat16", interpret=True), np.float64)
    Q, a, e, P, aC, valid = autotune._mk_inputs(n, rho, 16, 1, "bfloat16", 0)
    got = ops.dplr_corpus_score(Q, a, e, P, aC, valid, acc_dtype="bfloat16").double().numpy()
    Pq = P.float()[:, None] + Q.float()[None]
    size = 0.5 * torch.einsum("qnrk,r->qn", Pq * Pq, e.abs()).double().numpy()
    live = valid.numpy()
    err = np.abs(got - want)[:, live]
    bound = (2 * rho + 1) * 2.0**-8 * size[:, live] + 1e-5
    assert (err <= bound).all(), f"max {float((err / bound).max()):.3g} of the bound"
    assert np.array_equal(got[:, ~live], want[:, ~live])

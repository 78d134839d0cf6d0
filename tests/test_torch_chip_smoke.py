"""``chip_smoke.py`` rehearsed on the CPU: its kernel, serving, serve-bf16,
tenants, shard, data, wire, eval, train, models, lm, lm-train, gnn, timing, autotune and
profile phases run at a tiny size with the plain versions (the
timer stubbed, since CUDA events need a card), its exact top-K check (C1)
catches what is not kernel 1's scores sorted, and without a card the
script exits non-zero and prints nothing, in the repo and alone in a
directory."""
import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

SMALL = dict(n=8192, live=6000, bqs=(1, 3), ks=(1, 5, 64), rho=3, k=16, n3=512, m3=38,
             bq3s=(1, 2), edge_n=1000, items=3000, capacity=4096, queries=3, batch=4,
             churn=(20, 20, 5), percall_n=512, topk=5,
             multi=(4, 2, 2048, 16), ragged=((300, 1000, 700), 2, 256),
             tenants=4, tenant_items=700, tenant_capacity=1024, tenant_bq=4,
             waves=3, warm_waves=1, profile_waves=1,
             shards=4, shard_bqs=(1, 3), shard_reps=2, shard_churn=(20, 20, 5, 1200),
             mp_items=40,
             strain_dims={"batch": 64}, strain_serve_dims={"batch": 128}, strain_steps=2,
             strain_lm_dims={"batch": 4, "seq": 16}, strain_lm_steps=2,
             strain_gnn_dims={"n_nodes": 64, "n_edges": 256, "d_feat": 12, "n_classes": 5},
             strain_gnn_steps=2, strain_seconds=120,
             wire_requests=40, wire_conns=2, wire_window=3,
             bag_rows=(3, 500, 64), bag_ragged=33, pairs=((64, 12), (300, 12), (1, 39)),
             pair_small_b=5, pair_tiles=2, items_tiles=3, items_many=300,
             eval_n=600, eval_batch=256, parity=(3, 64), pruned_q=(2, 16),
             big_ks=(4097, 6500), adv=(8192, 6000, 3, (16, 1024, 4097)), large=(7000, 2),
             full_runs=(1, 257, 4096), full_c1=(2000, 17),
             big_topk=2000,
             tune_candidates=(256, {"block_n": 1024, "threads": 128, "group": 4, "part": 4096},
                              {"block_n": 8192, "group": 16}),
             tune_repeats=2, tune_cells=((1, "float32"), (3, "float32"), (1, "bfloat16")),
             topk_times=((3, 5, "random"), (1, 5, "random"), (3, 64, "random"),
                         (1, 64, "random"), (1, 300, "random"), (3, 300, "random"),
                         (3, 4097, "random"), (3, 5, "rising"), (3, 64, "rising")),
             flash=((2, 70, 4, 1, 16, None), (2, 70, 4, 1, 16, 8)),
             flash_small=((1, 33, 2, 2, 8, None), (1, 50, 9, 1, 4, 5)),
             flash_heads=((1, 40, 9, 1, 8, None), (1, 40, 8, 1, 8, None),
                          (2, 40, 4, 2, 8, None), (1, 48, 8, 2, 8, 16)),
             flash_moe=((2, 40, 4, 2, 8, None), (1, 48, 8, 2, 8, 16)),
             pair_bf16=((300, 12), (37, 12)),
             lm_batch=2, lm_prompt=21, lm_cache=24, lm_steps=3,
             lm_model_prompt=12, lm_model_steps=2, moe_impl_layer=1,
             lm_train_batch=2, lm_train_seq=16, lm_train_steps=2, lm_train_lr=0.05,
             lm_resume_layers=2, lm_resume_steps=3, lm_resume_save=1,
             gnn_shapes=("minibatch_lg", "molecule", "full_graph_sm"), gnn_steps=2,
             gnn_lr=1e-3, gnn_graph=(2000, 10), gnn_minibatch=(16, (3, 2)), gnn_seed=0,
             train_batch=64, train_steps=4, train_save=2, train_lr=0.05, base_steps=2,
             posthoc_rank=2, train_serve_bqs=(1, 3), truncate_bytes=1024,
             models=("wide-deep", "autoint", "bst", "mind"), model_make="make_smoke",
             model_batch=64, model_steps=2, model_lr=0.05, model_queries=3,
             model_ranks={"wide-deep": (40,), "autoint": (40,), "bst": (40,),
                          "mind": (40, 300)}, model_apply_chunk=128)


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    return chip_smoke


def test_phases_run_on_the_cpu_at_a_tiny_size(chip_smoke, monkeypatch, capsys):
    from repro_torch.configs import (dplr_fwfm, gemma3_1b, granite_moe_1b_a400m,
                                     mixtral_8x7b, pna, starcoder2_7b, yi_9b)

    sz = SimpleNamespace(
        make_config=dplr_fwfm.make_smoke, make_lm=gemma3_1b.make_smoke,
        lm_models=(starcoder2_7b.make_smoke, yi_9b.make_smoke), gnn_make=pna.make_smoke,
        # B S whole groups of the smoke configs' 16; mixtral's prompt past its window of 8
        lm_moe=((granite_moe_1b_a400m.make_smoke, 2, 16, 19, 3),
                (mixtral_8x7b.make_smoke, 1, 16, 18, 2)),
        lm_train_models=(gemma3_1b.make_smoke, granite_moe_1b_a400m.make_smoke),
        make_fwfm=lambda: dataclasses.replace(dplr_fwfm.make_smoke(), interaction="fwfm"),
        # gemma3-1b's smoke widths with its full config's 4 microbatches
        strain_lm=lambda: dataclasses.replace(gemma3_1b.make_smoke(), micro_batches=4),
        **SMALL)
    cpu = torch.device("cpu")
    errs = chip_smoke.kernel_checks(cpu, sz)
    bf16 = {"dplr_corpus_score", "dplr_corpus_topk", "dplr_score_items",
            "dplr_corpus_score_multi", "embedding_bag", "fwfm_pairwise"}
    assert set(errs) == bf16 | {f"{name}_bf16" for name in bf16} | {
        "embedding_bag_backward", "bag_rows_sort", "flash_attention"}
    serve = chip_smoke.serving_phase(cpu, sz)
    assert sum(serve.launches.values()) == 0    # the CPU runs no kernel
    assert "embedding_bag_kernel" in serve.launches
    launches = chip_smoke.serve_bf16_phase(cpu, sz, serve)
    assert sum(launches.values()) == 0
    assert {"embedding_bag_kernel_bf16", "corpus_topk_chunks_bf16",
            "dplr_score_items_kernel_bf16", "corpus_multi_topk_chunks_bf16"} <= set(launches)
    launches, tenants = chip_smoke.tenants_phase(cpu, sz, serve)
    assert sum(launches.values()) == 0
    f32, bf16 = chip_smoke.shard_phase(cpu, sz, serve)
    assert sum(f32.values()) == sum(bf16.values()) == 0
    assert {"corpus_score_full", "corpus_topk_chunks", "corpus_multi_topk_chunks",
            "embedding_bag_kernel", "topk_merge", "multi_topk_merge"} <= set(f32)
    assert {"corpus_score_full_bf16", "corpus_topk_chunks_bf16",
            "corpus_multi_topk_chunks_bf16", "embedding_bag_kernel_bf16"} <= set(bf16)
    launches = chip_smoke.shard_train_phase(cpu, sz)
    assert set(launches) == {"embedding_bag_kernel", "bag_rows_radix_histogram",
                             "bag_rows_radix_sort", "embedding_bag_backward_kernel"}
    assert sum(launches.values()) == 0
    launches = chip_smoke.wire_phase(cpu, sz, serve, tenants)
    assert sum(launches.values()) == 0
    launches = chip_smoke.eval_phase(cpu, sz, serve)
    assert set(launches) == {"embedding_bag_kernel", "fwfm_pairwise_kernel",
                             "embedding_bag_kernel_bf16", "fwfm_pairwise_kernel_bf16"}
    assert sum(launches.values()) == 0
    launches = chip_smoke.train_phase(cpu, sz, serve)
    assert {"embedding_bag_kernel", "embedding_bag_backward_kernel", "fwfm_pairwise_kernel",
            "corpus_topk_chunks", "dplr_score_items_kernel"} <= set(launches)
    assert sum(launches.values()) == 0
    batches = chip_smoke.models_data(sz.models, sz.model_make, sz.model_batch,
                                     sz.model_steps)
    launches = chip_smoke.models_phase(cpu, sz, batches)
    assert launches == {"embedding_bag_kernel": 0, "bag_rows_radix_histogram": 0,
                        "bag_rows_radix_sort": 0, "embedding_bag_backward_kernel": 0}
    launches = chip_smoke.lm_phase(cpu, sz)
    assert set(launches) == {"flash_attention_kernel", "flash_attention_wgmma"}
    assert sum(launches.values()) == 0
    chip_smoke.lm_train_phase(cpu, sz)
    chip_smoke.gnn_phase(cpu, sz)
    monkeypatch.setattr(chip_smoke, "device_ms", lambda fn, *a: (fn(), 1.0)[1])
    rows = chip_smoke.timing_phase(cpu, sz, (3.35e12, 67e12, 989e12))
    assert set(rows) == set(errs)
    for row in rows.values():
        assert row["bound_by"] == "bytes" and row["bound_ms"] > 0
    assert rows["flash_attention"]["windowed"]["bound_ms"] > 0
    for name in ("dplr_score_items", "fwfm_pairwise"):
        assert all(row["host_issue_ms"] > 0 for row in rows[name]["shapes"])
    chip_smoke.autotune_phase(cpu, sz, (3.35e12, 67e12, 989e12), serve, tenants, rows)
    for name in ("dplr_corpus_score", "dplr_corpus_topk", "dplr_corpus_score_multi"):
        for suffix in ("", "_bf16"):
            assert rows[name + suffix]["tuned_ms"] > 0 and rows[name + suffix]["tuned_tile"]
    from repro_torch.kernels import blocks
    assert blocks._TUNED_TILES == {}        # the registry is cleared after the phase
    chip_smoke.profile_phase(cpu, sz, serve.engine, serve.ctxs)
    out = capsys.readouterr().out
    assert "2 adagrad steps at D=4 bitwise D=1" in out and "logits at D=4 bitwise D=1's" in out
    assert "means and errors bitwise the plain formula" in out
    assert "4 microbatches of 1 against one batch" in out and "pna/full_graph_sm+part [" in out
    assert "the blocks bitwise one launch over the arena" in out
    assert "every leaf of params and accumulator within" in out
    assert "each step's loss and parameters bitwise adamw of its gradient" in out
    for phase in ("kernels", "serve", "serve-bf16", "tenants", "shard", "shard-train", "eval",
                  "train",
                  "models", "lm", "lm-train", "gnn", "timing", "autotune", "profile"):
        assert f"phase {phase}:" in out
    assert "phase shard: 4 shards on cpu, cpu, cpu, cpu, 3000 items in a 4096-slot slab" in out
    assert out.count("4 packed tenants bitwise the single-device engine") == 2
    assert "rank_items_mp over 4 arena blocks" in out
    assert "fwfm_pairwise bf16 V bitwise its f32 launch" in out and "fwfm in bf16: AUC" in out
    assert "36/4x128" not in out and "1x40x9/1x8" in out     # the head-group cases ran
    for name in ("gemma3-1b-smoke", "starcoder2-7b-smoke", "yi-9b-smoke", "granite-moe-smoke",
                 "mixtral-smoke"):
        assert f"phase lm: {name} " in out and "= n_params()" in out
    assert out.count("the plain prefills and the one-pass decode check ran under the kernel "
                     "path's routes") == 2
    assert out.count("MoE implementations on layer 1's prefill input ((2, 16, 32))") == 1
    assert out.count("the timed steps' logits bitwise the recorded steps'") == 2
    for name in ("gemma3-1b-smoke", "granite-moe-smoke"):
        assert f"phase lm-train: {name} " in out
    assert out.count("run B from step 1: losses and step 3's params and adamw state "
                     "bitwise") == 2
    assert out.count("the f32 loss under the bf16 loss's routes") == 1
    assert [row["shape"] for row in rows["flash_attention"]["moe"]] == [
        list(s) for s in sz.flash_moe]
    for shape in ("minibatch_lg", "molecule", "full_graph_sm"):
        assert f"{shape} (d_feat" in out
    assert rows["fwfm_pairwise_bf16"]["library_ms"] > 0
    assert "packed = unpacked bitwise" in out and "rows bitwise = single" in out
    assert "n=2 m_I=38 Bq=300" in out and "Bq=3 misaligned" in out
    assert "pruned R" in out and "m=12 misaligned" in out and "alone bitwise" in out
    assert "bitwise run A's" in out and "raised RefreshFailed once" in out
    assert out.count("adagrad steps at B=64 lr=0.05 bitwise equal") == 4
    assert "rank_items at 1 x 300" in out
    assert "bf16 slab: kernels 1-2 bitwise" in out and "installed as bf16 by maybe_refresh" in out
    assert "dplr_score_items bf16 n=512" in out and "embedding_bag bf16 corpus" in out
    assert rows["fwfm_pairwise"]["backward_plain_ms"] > 0
    assert out.count("phase autotune: served") == 3 and "phase autotune: tenants" in out
    assert "bitwise their untuned answers" in out and "clamped visibly" in out
    assert "a Bq=1 chunk-4096 record left Bq=16 at the default" in out


def test_checks_catch_a_wrong_top_k(chip_smoke):
    full = torch.tensor([[3.0, 5.0, 5.0, 1.0]])
    vals = torch.tensor([[5.0, 5.0]])
    chip_smoke.check_topk(vals, torch.tensor([[1, 2]], dtype=torch.int32), full, 2, "ok",
                          planted=[(1, 2)])
    with pytest.raises(AssertionError, match="higher slot"):
        chip_smoke.check_topk(vals, torch.tensor([[2, 1]], dtype=torch.int32), full, 2,
                              "swapped", planted=[(1, 2)])
    with pytest.raises(AssertionError, match="id scores"):
        chip_smoke.check_topk(vals, torch.tensor([[1, 0]], dtype=torch.int32), full, 2,
                              "wrong id")


def test_exact_check_catches_what_is_not_kernel_1_sorted(chip_smoke):
    """C1 passes kernel 1's scores sorted, relabeled, and raises on a pair of
    tied slots swapped, on a value one ulp off and on a dead slot ranked
    above a live one."""
    from repro_torch.kernels.dplr_corpus_score import NEG_INF

    scores = torch.tensor([[3.0, 5.0, 5.0, NEG_INF, 1.0]])
    ids = lambda *x: torch.tensor([x], dtype=torch.int32)  # noqa: E731
    vals = torch.tensor([[5.0, 5.0, 3.0]])
    chip_smoke.check_exact(vals, ids(1, 2, 0), scores, 3, "sorted")
    chip_smoke.check_exact(vals, ids(7, 9, 5), scores, 3, "relabeled", offset=5, stride=2)
    chip_smoke.check_exact(vals, ids(1, 2, 0), chip_smoke.ranked(scores), 3, "ranked")
    with pytest.raises(AssertionError, match="C1"):
        chip_smoke.check_exact(vals, ids(2, 1, 0), scores, 3, "tied slots swapped")
    ulp = torch.nextafter(torch.tensor(5.0), torch.tensor(6.0))
    with pytest.raises(AssertionError, match="C1"):
        chip_smoke.check_exact(torch.stack([ulp, torch.tensor(5.0), torch.tensor(3.0)])[None],
                               ids(1, 2, 0), scores, 3, "one ulp")
    with pytest.raises(AssertionError, match="C1"):
        chip_smoke.check_exact(torch.tensor([[5.0, 5.0, 3.0, NEG_INF, 1.0]]),
                               ids(1, 2, 0, 3, 4), scores, 5, "dead above live")
    chip_smoke.check_exact(torch.tensor([[5.0, 5.0, 3.0, 1.0, NEG_INF]]),
                           ids(1, 2, 0, 4, 3), scores, 5, "dead last")


def _run_without_card(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_exits_nonzero_and_prints_no_result():
    out = _run_without_card(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_alone_in_a_directory_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    out = _run_without_card(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def _ptxas_log(mangled: str, spill: int) -> str:
    return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {mangled}\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
            f"ptxas info    : Used 128 registers, used 1 barriers\n")


def test_build_gate_refuses_a_spill_in_the_gated_sources(chip_smoke):
    """Every kernel of the corpus, item-scoring, embedding-bag and FwFM
    sources and ``flash_attention_wgmma``: a spill there fails the build
    phase; a spill elsewhere is reported, not refused."""
    anon = "_ZN12_GLOBAL__N_1"
    for stem, name in (("fwfm_interaction", "fwfm_pairwise_kernel"),
                       ("dplr_score", "dplr_score_items_kernel"),
                       ("dplr_corpus_score", "topk_merge"),
                       ("embedding_bag", "embedding_bag_backward_kernel")):
        mangled = f"{anon}{len(name)}{name}EPKfS1_xiiiiPf"
        assert [fn["kernel"] for fn in chip_smoke.spilled(stem, _ptxas_log(mangled, 8))] == [name]
        assert chip_smoke.spilled(stem, _ptxas_log(mangled, 0)) == []
    wgmma = f"{anon}21flash_attention_wgmmaILi256EEEvPK13__nv_bfloat16"
    assert [fn["kernel"] for fn in chip_smoke.spilled("flash_attention", _ptxas_log(wgmma, 4))
            ] == ["flash_attention_wgmma<256>"]
    name = "flash_attention_kernel"
    assert chip_smoke.spilled("flash_attention", _ptxas_log(f"{anon}{len(name)}{name}Ev", 48)
                              ) == []


def test_tiles_at_the_served_shapes(chip_smoke, monkeypatch):
    """The kernel phase's tile edges sit one below and one above a multiple
    of the tile that the kernels' libraries report (``dplr_score.tile``,
    ``fwfm_interaction.tile``: CUDA only, so stubbed here at the served
    shapes' 8 items and 16 examples); the CPU's plain versions have no
    tiles (1).  Kernel 3's rho k = 128 and m_I = 200 cases report their
    distance from an f64 plain version."""
    asked = []
    monkeypatch.setattr(chip_smoke.items_kernel, "tile",
                        lambda *shape: asked.append(("items", shape)) or 8)
    monkeypatch.setattr(chip_smoke.pair_kernel, "tile",
                        lambda *shape: asked.append(("pairs", shape)) or 16)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert chip_smoke.items_tile(cuda, 38, 3, 16) == 8
    assert chip_smoke.pair_tile(cuda, 82, 16) == 16
    assert asked == [("items", (38, 3, 16)), ("pairs", (82, 16))]
    assert chip_smoke.items_tile(cpu, 38, 3, 16) == chip_smoke.pair_tile(cpu, 82, 16) == 1

    monkeypatch.setattr(chip_smoke, "items_tile", lambda dev, *shape: 8)
    monkeypatch.setattr(chip_smoke, "pair_tile", lambda dev, *shape: 16)
    sz = SimpleNamespace(**SMALL)
    _, notes = chip_smoke.items_edge_checks(cpu, sz, 0.0)
    edges = [8 * sz.items_tiles - 1, 8 * sz.items_tiles + 1]
    assert all(f"n={n} m_I={sz.m3} k={sz.k} " in notes[0] for n in edges)
    assert notes[0].count("against f64: kernel") == 3
    _, notes = chip_smoke.pair_checks(cpu, sz, torch.Generator().manual_seed(0))
    assert all(f"B={16 * sz.pair_tiles + d} m=" in notes[0] for d in (-1, 1))


def test_attention_pairs_counts_the_causal_and_window_spans(chip_smoke):
    assert chip_smoke.attention_pairs(4, None) == 1 + 2 + 3 + 4
    assert chip_smoke.attention_pairs(5, 2) == 1 + 2 + 2 + 2 + 2
    # gemma3-1b's global layer at S = 32,752: ~2.2 TFLOP a sequence
    flops = 4 * 256 * 4 * chip_smoke.attention_pairs(32_752, None)
    assert 2.19e12 < flops < 2.20e12


# the bounds of PERF.md's kernel table (ms, on an H100 SXM's rates), each at
# the timing phase's shapes: (row, kernel, tensor rate, dims, bound)
_FULL_SLAB = dict(n=1 << 20, live=1_000_000, rho=3, k=16)
TIMING_BOUNDS = [
    ("1", "dplr_corpus_score", False, dict(_FULL_SLAB, Bq=16, K=None, itemsize=4), 0.0789),
    ("1 Bq=1", "dplr_corpus_score", False, dict(_FULL_SLAB, Bq=1, K=None, itemsize=4), 0.0601),
    ("2", "dplr_corpus_topk", False, dict(_FULL_SLAB, Bq=16, K=16, itemsize=4), 0.0588),
    ("3", "dplr_score_items", False, dict(n=65_536, Bq=4, m_I=38, rho=3, k=16, itemsize=4),
     0.1906),
    ("4", "dplr_corpus_score_multi", False,
     dict(n=65_536, live=62_500, Bq=4, K=16, rho=3, k=16, segments=16, itemsize=4), 0.0588),
    ("5", "embedding_bag", False,
     dict(slots=38_000_000, B=1_000_000, n_bags=38, k=16, itemsize=4, id_size=4), 1.5427),
    ("5'", "embedding_bag_backward", False,
     dict(slots=4096 * 82, B=4096, n_bags=82, k=16, rows=None, id_size=4), 0.6384),
    ("6", "fwfm_pairwise", False, dict(B=262_144, m=82, k=16, itemsize=4), 0.4527),
    ("7", "flash_attention", True,
     dict(B=2, S=32_752, H=4, KV=1, hd=256, window=None, itemsize=2), 4.4428),
    ("7 window", "flash_attention", True,
     dict(B=2, S=32_752, H=4, KV=1, hd=256, window=1024, itemsize=2), 0.2735),
    ("7 granite", "flash_attention", True,
     dict(B=2, S=32_256, H=16, KV=8, hd=64, window=None, itemsize=2), 4.3092),
    ("7 mixtral", "flash_attention", True,
     dict(B=1, S=8192, H=32, KV=8, hd=128, window=4096, itemsize=2), 0.4169),
    ("1 bf16", "dplr_corpus_score_bf16", False, dict(_FULL_SLAB, Bq=16, K=None, itemsize=2),
     0.0496),
    ("1 bf16 Bq=1", "dplr_corpus_score_bf16", False,
     dict(_FULL_SLAB, Bq=1, K=None, itemsize=2), 0.0308),
    ("2 bf16", "dplr_corpus_topk_bf16", False, dict(_FULL_SLAB, Bq=16, K=16, itemsize=2),
     0.0365),
    ("3 bf16", "dplr_score_items_bf16", False,
     dict(n=65_536, Bq=4, m_I=38, rho=3, k=16, itemsize=2), 0.0955),
    ("4 bf16", "dplr_corpus_score_multi_bf16", False,
     dict(n=65_536, live=62_500, Bq=4, K=16, rho=3, k=16, segments=16, itemsize=2), 0.0296),
    ("5 bf16", "embedding_bag_bf16", False,
     dict(slots=38_000_000, B=1_000_000, n_bags=38, k=16, itemsize=2, id_size=4), 0.7940),
    ("6 bf16", "fwfm_pairwise_bf16", True, dict(B=262_144, m=82, k=16, itemsize=2), 0.2057),
]


@pytest.mark.parametrize("row,name,tensor,dims,want", TIMING_BOUNDS,
                         ids=[r[0] for r in TIMING_BOUNDS])
def test_timing_bounds_come_from_the_cost_model_unchanged(chip_smoke, row, name, tensor, dims,
                                                          want):
    """The timing phase takes each kernel's flops and bytes from
    ``work.kernel_work``: at the phase's shapes (the full config's slab,
    arena and batches) and an H100 SXM's rates every bound of PERF.md's
    table is what the phase's inline formulas gave."""
    from repro_torch.embedding.bag import padded_rows

    full = chip_smoke.FULL
    cfg = full.make_config()
    if name == "embedding_bag_backward":
        dims = dict(dims, rows=padded_rows(cfg.layout.total_vocab))
    assert len(cfg.layout.slots_of("item")) == 38 and cfg.layout.n_slots == 82
    peaks = next(rates for key, *rates in chip_smoke.PEAKS if key == "H100")
    assert round(chip_smoke.work_bound(name, peaks, tensor, **dims)[0], 4) == want, row


def test_examples_and_dryrun_phases_run_on_the_cpu_at_a_tiny_size(chip_smoke, capsys):
    """The examples phase (quickstart, train_e2e on a narrow layout, the
    ranking server twice, the second with path 1 and the tenants cut as
    the full run cuts them; each held against its plain path, the packed
    frontends' replies too) and the dry run's phase (its process over the
    pna cells, then two cuts counted on meta beside two steps on the CPU,
    whose peak the CPU cannot measure)."""
    from repro_torch.configs import gemma3_1b, pna
    from repro_torch.core.fields import uniform_layout

    sz = SimpleNamespace(
        qs_steps=2, qs_rank_steps=1, qs_rows=400,
        e2e_layout=lambda: uniform_layout(3, 4, [300, 200, 50, 40, 30, 20, 10]), e2e_steps=4,
        e2e_batch=64, e2e_ckpt_every=2, e2e_plain_steps=2,
        server_runs=(["--items", "256", "--queries", "6", "--churn", "2"],
                     ["--items", "300", "--queries", "6", "--topk", "5",
                      "--percall-queries", "3", "--tenant-items", "100"]),
        dryrun_args=("--arch", "pna"), dryrun_timeout=600, dryrun_steps=2,
        dryrun_cuts=(("gemma3-1b", "train_4k", {"batch": 2, "seq": 32}, gemma3_1b.make_smoke),
                     ("pna", "molecule", None, pna.make_smoke)))
    cpu = torch.device("cpu")
    out_dir = chip_smoke.BUILD / "dryrun_torch_rehearsal"
    proc = chip_smoke.start_dryrun(cpu, list(sz.dryrun_args), out_dir)
    try:
        launches = chip_smoke.examples_phase(cpu, sz)
        assert sum(launches.values()) == 0                     # the CPU runs no kernel
        chip_smoke.dryrun_phase(cpu, sz, proc, out_dir)
    finally:
        if proc.poll() is None:
            proc.kill()
        shutil.rmtree(out_dir, ignore_errors=True)
    out = capsys.readouterr().out
    assert "phase examples: quickstart (2 steps a model" in out
    assert "phase examples: train_e2e (7 fields, 650 arena rows, 4 steps" in out
    assert "['step_00000002', 'step_00000004'] (keep 2)" in out
    assert out.count("phase examples: ranking_server --items ") == 2
    # paths 6-7: tenants 1 and 2 of path 6 (4 of its 6 replies), all 6 of path 7
    assert out.count("replies (4 of multi_tenant's 6, 6 of rpc's 6;") == 2
    assert out.count("per-call Alg. 1 :") == 2 and "(6 pipelined requests" in out
    assert out.count("phase dryrun: [ok] pna") == 4
    assert "4 cells counted on meta (4 fit one card" not in out      # ogb_products does not
    assert "3 fit one card" in out
    assert out.count("phase dryrun: cut ") == 2 and "peak not measured" in out
    assert out.count("2 steps on the cpu after a warm one: median") == 2


def test_plain_kernels_swaps_the_entry_points_back(chip_smoke):
    from repro_torch.kernels import ops

    saved = (ops.embedding_bag, ops.fwfm_pairwise, ops.dplr_score_items)
    with chip_smoke.plain_kernels():
        assert ops.fwfm_pairwise is not saved[1]
        V = torch.randn(3, 4, 2)
        assert ops.dplr_score_items(torch.randn(5, 2, 2), torch.randn(1, 2), torch.ones(1),
                                    torch.zeros(2), torch.randn(1, 2),
                                    torch.tensor(0.0)).shape == (5,)
        assert ops.fwfm_pairwise(V, torch.eye(4)).shape == (3,)
    assert (ops.embedding_bag, ops.fwfm_pairwise, ops.dplr_score_items) == saved


def test_kernel_1_edge_checks_run_on_the_plain_versions(chip_smoke):
    """Kernel 1's edge checks (``full_checks``) pass the CPU's plain
    versions at every edge shape, with kernel 2 at K = n."""
    errs = {"dplr_corpus_score": 0.0, "dplr_corpus_score_bf16": 0.0}
    notes = []
    chip_smoke.full_checks(torch.device("cpu"), SimpleNamespace(**SMALL), errs, notes)
    assert "kernel 2 at K=n=2000 Bq=17 bitwise kernel 1 sorted" in notes[0]
    assert all(f"{n}x{Bq}/{rho}x{k}" in notes[0] for n, Bq, rho, k in chip_smoke.FULL_EDGES)


@pytest.mark.parametrize("where,match", [
    ("every full call", "C1"),
    ("bf16 slab", "not bitwise the float32"),
    ("another run", "not bitwise the default geometry"),
])
def test_kernel_1_edge_checks_reject_one_ulp(chip_smoke, monkeypatch, where, match):
    """One score one ulp off in kernel 1's output fails ``full_checks``:
    in every full-mode call (kernel 2 at K = n is then not kernel 1
    sorted), in the bf16 slab's calls alone (not the upcast f32 call), or
    in every call at a run the caller asked for (not the default's)."""
    from repro_torch.kernels import ops

    real = ops._corpus_score

    def bumped(Q_I, a_I, e, P_C, a_C, valid, topk, index_offset, index_stride, asked):
        out = real(Q_I, a_I, e, P_C, a_C, valid, topk, index_offset, index_stride, asked)
        hit = topk is None and {"every full call": True,
                                "bf16 slab": Q_I.dtype == torch.bfloat16,
                                "another run": asked.block_n is not None}[where]
        if hit:
            i = int(valid.nonzero()[0, 0])          # a live slot's score
            out = out.clone()
            out[0, i] = torch.nextafter(out[0, i], torch.tensor(float("inf")))
        return out

    monkeypatch.setattr(ops, "_corpus_score", bumped)
    monkeypatch.setattr(chip_smoke, "FULL_EDGES", ((1, 1, 3, 16), (773, 16, 3, 16)))
    errs = {"dplr_corpus_score": 0.0, "dplr_corpus_score_bf16": 0.0}
    with pytest.raises(AssertionError, match=match):
        chip_smoke.full_checks(torch.device("cpu"), SimpleNamespace(**SMALL), errs, [])


# the data phase at the smoke widths: B and the bulk rows the least that split
# over two replicas (auto_leaf_spec's min_shard of 1,024 a dim), 4,096 items
DATA = dict(shards=4, data_dims={"batch": 2048}, data_serve_dims={"batch": 2048},
            data_retrieval_dims={"n_items": 4096}, data_steps=2)


def _data_sz():
    from repro_torch.configs import dplr_fwfm
    return SimpleNamespace(make_config=dplr_fwfm.make_smoke, **DATA)


def test_data_phase_runs_on_the_cpu_at_a_tiny_size(chip_smoke, capsys):
    """The data phase on a (2, 2) mesh of the CPU: step 1's gradients, the
    steps against the unsharded ones, a second run bitwise, (1, 4) bitwise
    the step before the data axis, the bulk and retrieval cells; and the
    production-mesh dry run's check on ``dplr-fwfm``'s records."""
    cpu = torch.device("cpu")
    launches = chip_smoke.data_phase(cpu, _data_sz())
    assert set(launches) == {"embedding_bag_kernel", "bag_rows_radix_histogram",
                             "bag_rows_radix_sort", "embedding_bag_backward_kernel"}
    assert sum(launches.values()) == 0                      # the CPU runs no kernel
    out = capsys.readouterr().out
    assert "phase data: (2, 2) mesh, 4 positions on cpu; (a) dplr-fwfm/train_batch B=2048 " \
        "(1024 rows a replica)" in out
    for part in ("against the plain path on the replicas' rows", "a second run at (2, 2) "
                 "bitwise the first", "(1, 4) bitwise the step before the data axis after every "
                 "step", "serve_bulk (2048,) bitwise", "retrieval_cand (1, 4096) bitwise"):
        assert part in out, part
    sz = SimpleNamespace(dryrun_timeout=600, dryrun_mesh_args=("--mesh", "both", "--arch",
                                                                "dplr-fwfm"))
    out_dir = chip_smoke.BUILD / "dryrun_torch_mesh_rehearsal"
    proc = chip_smoke.start_dryrun(cpu, list(sz.dryrun_mesh_args), out_dir)
    try:
        recs = chip_smoke.dryrun_records(proc, out_dir, sz.dryrun_timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
        shutil.rmtree(out_dir, ignore_errors=True)
    chip_smoke.dryrun_mesh_check(recs, 8)
    bad = [dict(r, param_bytes=r["param_bytes"] + 4) if r["shape"] == "train_batch" else r
           for r in recs]
    with pytest.raises(AssertionError, match="the rules give"):
        chip_smoke.dryrun_mesh_check(bad, 8)
    with pytest.raises(AssertionError, match="8 records, want 40"):
        chip_smoke.dryrun_mesh_check(recs, 40)
    out = capsys.readouterr().out
    assert out.count("coll=") == 8 and "8 recsys cells counted a device" in out


def _sum_for_mean(real):
    def all_reduce(xs, positions, op="sum", out=None):
        return real(xs, positions, "sum", out)
    return all_reduce


def _scaled_block(real):
    def block_grads(grad, table, ids, weights, bags, mesh):
        d = real(grad, table, ids, weights, bags, mesh)
        rows = table.shape[0] // len(mesh.devices)
        d[:rows] *= 1.001                      # the first block of each replica
        return d
    return block_grads


def _one_ulp_at_one_replica(real):
    def step(*args, mesh, **kwargs):
        loss, params, state = real(*args, mesh=mesh, **kwargs)
        if mesh.dp == 1:
            loss = torch.nextafter(loss, torch.tensor(float("inf")))
        return loss, params, state
    return step


def _cold_accumulator(real):
    def step(*args, mesh, **kwargs):
        loss, params, state = real(*args, mesh=mesh, **kwargs)
        if mesh.dp > 1:
            state["acc"]["embedding"][-1, 0] += 1e-6       # a padding row no slot names
        return loss, params, state
    return step


@pytest.mark.parametrize("target,plant,match", [
    ("collectives.all_reduce", _sum_for_mean, "step 1's loss on the mesh"),
    ("train.data_parallel_step", _cold_accumulator,
     r"elements of embedding or its accumulator at \(2, 2\) past the bound"),
    ("sharded._block_grads", _scaled_block, "step 1's d_embedding on the mesh"),
    ("train.data_parallel_step", _one_ulp_at_one_replica,
     "not bitwise the step before the data axis")])
def test_data_phase_catches_a_planted_difference(chip_smoke, monkeypatch, target, plant,
                                                  match):
    """A sum over the data axis where the mean belongs, a cold row's
    accumulator off by 1e-6 (within 1e-5 x max(1, max|leaf|)), one arena
    block's gradient off by 0.1%, a one-ulp change of the (1, 4) step's
    loss: each fails the phase."""
    from repro_torch.embedding import sharded
    from repro_torch.launch import train
    from repro_torch.sharding import collectives
    owner, name = target.split(".")
    mod = {"collectives": collectives, "sharded": sharded, "train": train}[owner]
    monkeypatch.setattr(mod, name, plant(getattr(mod, name)))
    with pytest.raises(AssertionError, match=match):
        chip_smoke.data_phase(torch.device("cpu"), _data_sz())



def _gradient_nudged(loss_partitioned):
    """The partitioned loss with its value unchanged and 1e-3 added to
    every entry of the first parameter leaf's gradient."""
    from repro_torch import optim

    def planted(params, cfg, batch, mesh=None):
        leaf = optim.optimizers.tree_leaves(params)[0]
        tilt = 1e-3 * (leaf.sum() - leaf.sum().detach())
        return loss_partitioned(params, cfg, batch, mesh=mesh) + tilt
    return planted


@pytest.mark.parametrize("plant", [None, _gradient_nudged])
def test_partitioned_pna_check_repeats_and_catches_a_planted_difference(chip_smoke, monkeypatch,
                                                                        plant):
    """The shard-train phase's partitioned-PNA check: its three f32 runs
    (the whole graph, the whole graph one ulp up, the partitioned graph)
    run under deterministic algorithms, so that its verdict repeats on the
    card; a gradient leaf off by 1e-3 an entry fails it."""
    from repro_torch.configs import pna as pna_cfg
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.gnn import pna

    seen = []

    def watch(fn):
        def call(*a, **kw):
            seen.append(torch.are_deterministic_algorithms_enabled())
            return fn(*a, **kw)
        return call
    if plant is not None:
        monkeypatch.setattr(pna, "loss_partitioned", plant(pna.loss_partitioned))
    monkeypatch.setattr(pna, "loss", watch(pna.loss))
    monkeypatch.setattr(pna, "loss_partitioned", watch(pna.loss_partitioned))
    sz = SimpleNamespace(gnn_make=pna_cfg.make_smoke, **SMALL)
    cpu = torch.device("cpu")
    mesh = make_host_mesh(sz.shards, device=cpu)
    if plant is not None:
        with pytest.raises(AssertionError, match="partitioned PNA gradient off by"):
            chip_smoke.part_gnn_check(cpu, sz, mesh)
        assert seen == [True] * 3
        return
    line = chip_smoke.part_gnn_check(cpu, sz, mesh)
    assert seen[:3] == [True] * 3 and not any(seen[3:])     # the bf16 steps as before
    assert "of their bounds (deterministic algorithms)" in line
    assert not torch.are_deterministic_algorithms_enabled()

def _lm_mesh_sz(train=True, serve=True):
    """The lm-mesh phase at the smoke widths: gemma3-1b's train and prefill
    (with a decode step) on (2, 2), granite's on (2, 2) with routes held,
    yi-9b's FSDP step with two microbatches, mixtral's prefill with 3
    experts (tensor parallelism inside them) on (1, 4); head widths the
    kernel takes (16)."""
    from repro_torch.configs.registry import REGISTRY

    def smoke(arch, **kw):
        return lambda: dataclasses.replace(REGISTRY[arch].make_smoke(), **kw)

    return SimpleNamespace(
        lm_mesh_train=(("gemma3-1b", smoke("gemma3-1b"), {"batch": 4, "seq": 16}, (2, 2)),
                       ("granite-moe-1b-a400m", smoke("granite-moe-1b-a400m", head_dim=16),
                        {"batch": 4, "seq": 16}, (2, 2)),
                       ("yi-9b", smoke("yi-9b", fsdp=True, micro_batches=2),
                        {"batch": 4, "seq": 16}, (2, 2))) if train else (),
        lm_mesh_steps=2,
        lm_mesh_serve=(("gemma3-1b", smoke("gemma3-1b"), {"batch": 2, "seq": 20}, (2, 2), 24),
                       ("granite-moe-1b-a400m", smoke("granite-moe-1b-a400m", head_dim=16),
                        {"batch": 2, "seq": 16}, (2, 2), None),
                       ("mixtral-8x7b", smoke("mixtral-8x7b", n_experts=3, head_dim=16),
                        {"batch": 1, "seq": 16}, (1, 4), None),
                       ("gemma3-1b", smoke("gemma3-1b"), {"batch": 1, "seq": 16}, (1, 8),
                        None)) if serve else (),
        lm_mesh_calls=2)


def test_lm_mesh_phase_runs_on_the_cpu_at_a_tiny_size(chip_smoke, capsys):
    """The lm-mesh phase on the CPU: train steps against the one-device
    steps (gradients and losses), a second run bitwise, prefills and a
    decode step against the one-device calls by the f32 yardstick, routes
    held and counted, each cut's collectives counted on meta."""
    launches = chip_smoke.lm_mesh_phase(torch.device("cpu"), _lm_mesh_sz())
    assert launches == {"flash_attention_kernel": 0, "flash_attention_wgmma": 0}
    out = capsys.readouterr().out
    assert out.startswith("phase lm-mesh: every position on cpu; gemma3-1b train_4k 4 x 16 "
                          "on (2, 2)")
    for part in ("2 heads a position, the kv heads they read gathered",
                 "4 experts a position", "(under the one device's routes; the mesh's own "
                 "against them: experts", "yi-9b train_4k 4 x 16 on (2, 2) (2 layers, "
                 "fsdp=True, 2 microbatch(es) a replica", "a second run bitwise the first",
                 "one decode_32k step at slot 20 of 24", "d_ff 16 of every expert a position",
                 "mixtral-8x7b prefill_32k 1 x 16 on (1, 4)", "counted a device: all-gather",
                 "gemma3-1b prefill_32k 1 x 16 on (1, 8) (8 layers; query rows a position)",
                 "gradients leaf by leaf (mesh / one device's bf16 gap"):
        assert part in out, part


def _drops_last_part(real):
    def reduce_to_all(xs, positions):
        return real(list(xs[:-1]) + [torch.zeros_like(xs[-1])], positions)
    return reduce_to_all


def _noisy_loss(real):
    calls = []

    def step(*args, **kwargs):
        loss, params, state = real(*args, **kwargs)
        calls.append(1)
        if len(calls) > 2:                 # the second run's
            loss = torch.nextafter(loss, torch.tensor(float("inf")))
        return loss, params, state
    return step


def _scaled_logits(real):
    def join(plan, parts, rows_split):
        return real(plan, parts, rows_split) * 1.1
    return join


def _halved_leaf(real):
    """The first leaf's gradient (``embed``) halved in half its rows."""
    def grads(plan, params, batch, n_micro):
        loss, flat = real(plan, params, batch, n_micro)
        for f in flat:
            f[0] = torch.cat([f[0][:len(f[0]) // 2] * 0.5, f[0][len(f[0]) // 2:]])
        return loss, flat
    return grads


def _rows_at_zero(real):
    """Kernel 7 at every position's rows as if they were the first rows."""
    def flash_attention(q, k, v, *, window=None, q_offset=0):
        return real(q, k, v, window=window)
    return flash_attention


@pytest.mark.parametrize("target,plant,train,match", [
    ("collectives.reduce_to_all", _drops_last_part, True, "step 1's gradient on"),
    ("train.lm_data_parallel_grads", _halved_leaf, True, "step 1's gradient on .* leaf embed"),
    ("train.lm_data_parallel_step", _noisy_loss, True, "not bitwise the first"),
    ("parallel.join", _scaled_logits, False, "prefill logits on"),
    ("ops.flash_attention", _rows_at_zero, False, "prefill logits on (1, 8)")])
def test_lm_mesh_phase_catches_a_planted_difference(chip_smoke, monkeypatch, target, plant,
                                                    train, match):
    """A model-axis sum that drops a position's part, one leaf's gradient
    halved in half its rows, a second run's loss one ulp off, the joined
    logits scaled by 1.1, kernel 7 at the query rows of a model axis whose
    heads do not split taken at offset 0 (the (1, 8) prefill): each fails
    the phase."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.models.transformer import parallel
    from repro_torch.sharding import collectives
    owner, name = target.split(".")
    mod = {"collectives": collectives, "train": train_mod, "parallel": parallel,
           "ops": ops}[owner]
    monkeypatch.setattr(mod, name, plant(getattr(mod, name)))
    sz = _lm_mesh_sz(train=train, serve=not train)
    cell = 3 if owner == "ops" else 0
    sz.lm_mesh_train, sz.lm_mesh_serve = sz.lm_mesh_train[:1], sz.lm_mesh_serve[cell:cell + 1]
    with pytest.raises(AssertionError, match=re.escape(match).replace(r"\.\*", ".*")):
        chip_smoke.lm_mesh_phase(torch.device("cpu"), sz)

"""``chip_smoke.py`` rehearsed on the CPU: its kernel, serving, tenants,
eval, lm, timing and profile phases run at a tiny size with the plain versions (the
timer stubbed, since CUDA events need a card), its exact top-K check (C1)
catches what is not kernel 1's scores sorted, and without a card the
script exits non-zero and prints nothing, in the repo and alone in a
directory."""
import dataclasses
import os
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
             bag_rows=(3, 500, 64), bag_ragged=33, pairs=((64, 12), (300, 12), (1, 39)),
             eval_n=600, eval_batch=256, parity=(3, 64), pruned_q=(2, 16),
             big_ks=(4097, 6500), adv=(8192, 6000, 3, (16, 1024, 4097)), large=(7000, 2),
             big_topk=2000,
             topk_times=((3, 5, "random"), (1, 5, "random"), (3, 64, "random"),
                         (1, 64, "random"), (1, 300, "random"), (3, 300, "random"),
                         (3, 4097, "random"), (3, 5, "rising"), (3, 64, "rising")),
             flash=((2, 70, 4, 1, 16, None), (2, 70, 4, 1, 16, 8)),
             flash_small=((1, 33, 2, 2, 8, None), (1, 50, 9, 1, 4, 5)),
             lm_batch=2, lm_prompt=21, lm_cache=24, lm_steps=3)


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    return chip_smoke


def test_phases_run_on_the_cpu_at_a_tiny_size(chip_smoke, monkeypatch, capsys):
    from repro_torch.configs import dplr_fwfm, gemma3_1b

    sz = SimpleNamespace(
        make_config=dplr_fwfm.make_smoke, make_lm=gemma3_1b.make_smoke,
        make_fwfm=lambda: dataclasses.replace(dplr_fwfm.make_smoke(), interaction="fwfm"),
        **SMALL)
    cpu = torch.device("cpu")
    errs = chip_smoke.kernel_checks(cpu, sz)
    assert set(errs) == {"dplr_corpus_score", "dplr_corpus_topk", "dplr_score_items",
                         "dplr_corpus_score_multi", "embedding_bag", "fwfm_pairwise",
                         "flash_attention"}
    serve = chip_smoke.serving_phase(cpu, sz)
    assert sum(serve.launches.values()) == 0    # the CPU runs no kernel
    assert "embedding_bag_kernel" in serve.launches
    launches = chip_smoke.tenants_phase(cpu, sz, serve)
    assert sum(launches.values()) == 0
    launches = chip_smoke.eval_phase(cpu, sz, serve)
    assert set(launches) == {"embedding_bag_kernel", "fwfm_pairwise_kernel"}
    assert sum(launches.values()) == 0
    launches = chip_smoke.lm_phase(cpu, sz)
    assert set(launches) == {"flash_attention_kernel", "flash_attention_wgmma"}
    assert sum(launches.values()) == 0
    monkeypatch.setattr(chip_smoke, "device_ms", lambda fn, *a: (fn(), 1.0)[1])
    rows = chip_smoke.timing_phase(cpu, sz, (3.35e12, 67e12, 989e12))
    assert set(rows) == set(errs)
    for row in rows.values():
        assert row["bound_by"] == "bytes" and row["bound_ms"] > 0
    assert rows["flash_attention"]["windowed"]["bound_ms"] > 0
    chip_smoke.profile_phase(cpu, sz, serve.engine, serve.ctxs)
    out = capsys.readouterr().out
    for phase in ("kernels", "serve", "tenants", "eval", "lm", "timing", "profile"):
        assert f"phase {phase}:" in out
    assert "packed = unpacked bitwise" in out and "rows bitwise = single" in out


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


def test_attention_pairs_counts_the_causal_and_window_spans(chip_smoke):
    assert chip_smoke.attention_pairs(4, None) == 1 + 2 + 3 + 4
    assert chip_smoke.attention_pairs(5, 2) == 1 + 2 + 2 + 2 + 2
    # gemma3-1b's global layer at S = 32,752: ~2.2 TFLOP a sequence
    flops = 4 * 256 * 4 * chip_smoke.attention_pairs(32_752, None)
    assert 2.19e12 < flops < 2.20e12

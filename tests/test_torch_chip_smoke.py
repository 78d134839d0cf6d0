"""``chip_smoke.py`` rehearsed on the CPU: its kernel, serving and timing
phases run at a tiny size with the plain versions (the timer stubbed,
since CUDA events need a card), and without a card the script exits
non-zero and prints nothing, in the repo and alone in a directory."""
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
             churn=(20, 20, 5), percall_n=512, topk=5)


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    return chip_smoke


def test_phases_run_on_the_cpu_at_a_tiny_size(chip_smoke, monkeypatch, capsys):
    from repro_torch.configs import dplr_fwfm

    sz = SimpleNamespace(make_config=dplr_fwfm.make_smoke, **SMALL)
    cpu = torch.device("cpu")
    errs = chip_smoke.kernel_checks(cpu, sz)
    assert set(errs) == {"dplr_corpus_score", "dplr_corpus_topk", "dplr_score_items"}
    launches, engine, ctxs = chip_smoke.serving_phase(cpu, sz)
    assert sum(launches.values()) == 0          # the CPU runs no kernel
    monkeypatch.setattr(chip_smoke, "device_ms", lambda fn, *a: (fn(), 1.0)[1])
    rows = chip_smoke.timing_phase(cpu, sz, (3.35e12, 67e12))
    for row in rows.values():
        assert row["bound_by"] == "bytes" and row["bound_ms"] > 0
    chip_smoke.profile_phase(cpu, sz, engine, ctxs)
    out = capsys.readouterr().out
    for phase in ("kernels", "serve", "timing", "profile"):
        assert f"phase {phase}:" in out


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

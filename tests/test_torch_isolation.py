"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import no JAX
and nothing of the JAX package, every module imports with JAX blocked, and
asking for the card where there is none raises."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import dplr_fwfm  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import CorpusState  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)", re.M)

_BLOCKED_RUN = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
import torch
from repro_torch.configs import dplr_fwfm
from repro_torch.data.synthetic_ctr import SyntheticCTR
from repro_torch.models.recsys import fwfm
from repro_torch.serving.engine import CorpusState
cfg = dplr_fwfm.make_smoke()
data = SyntheticCTR(cfg.layout, seed=0)
q = data.ranking_query(50, 0)
engine = CorpusState(cfg, q["item_ids"][0], device="cpu")
engine.refresh(fwfm.init(torch.Generator().manual_seed(0), cfg))
vals, ids = engine.topk(q["context_ids"], 5)
assert vals.shape == (1, 5) and engine.is_live(ids.numpy()).all()
print("ok")
"""


def test_port_sources_import_no_jax_and_no_reference():
    offending = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in PORT_FILES for m in FORBIDDEN.finditer(p.read_text())]
    assert not offending, offending


def test_every_module_imports_and_serves_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_asking_for_the_card_without_one_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"bias": np.zeros(())})
    cfg = dplr_fwfm.make_smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CorpusState(cfg, np.zeros((4, cfg.layout.n_item), np.int32))

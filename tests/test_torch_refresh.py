"""Serving a training checkpoint: the port's ``CorpusState.maybe_refresh``
against the JAX package's on one checkpoint directory (the same swaps, the
same ``RefreshFailed`` sequence, scores within 1e-5), the frontend's
``maybe_refresh`` for a tenant, and ``launch.serve``'s refresh demo."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.configs import dplr_fwfm as jconfig  # noqa: E402
from repro.models.recsys import fwfm as jfwfm  # noqa: E402
from repro.serving.engine import CorpusRankingEngine as JEngine  # noqa: E402
from repro.serving.errors import RefreshFailed as JRefreshFailed  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import dplr_fwfm  # noqa: E402
from repro_torch.data.synthetic_ctr import SyntheticCTR  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import CorpusState  # noqa: E402
from repro_torch.serving.errors import RefreshFailed  # noqa: E402
from repro_torch.serving.frontend import QueryFrontend  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _corrupt(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}", "arrays.npz"), "wb") as f:
        f.write(b"torn")


def _poll(engine, mgr, template, select):
    try:
        return engine.maybe_refresh(mgr, template, select=select)
    except (RefreshFailed, JRefreshFailed) as e:
        return ("failed", e.step)


def test_maybe_refresh_matches_jax_on_one_directory(tmp_path):
    """Both engines poll a directory the JAX trainer's manager writes:
    step 1, nothing new, step 2, a corrupt step 3 (raises once, then
    silent), step 4, then a valid step 5 under a corrupt step 6 (installs
    5 and records the bad push)."""
    jcfg, cfg = jconfig.make_smoke(), dplr_fwfm.make_smoke()
    data = SyntheticCTR(cfg.layout, seed=0)
    corpus = data.ranking_query(300, 0)
    ctx = np.concatenate([data.context_query(s)["context_ids"] for s in range(3)])
    jengine = JEngine(jcfg, corpus["item_ids"][0], corpus["item_weights"][0], capacity=512)
    engine = CorpusState(cfg, corpus["item_ids"][0], corpus["item_weights"][0],
                         capacity=512, device="cpu")
    base = jfwfm.init(jax.random.PRNGKey(0), jcfg)
    writer = JManager(str(tmp_path), keep=10)
    jmgr, mgr = JManager(str(tmp_path)), CheckpointManager(str(tmp_path))
    jtemplate = {"params": base}
    template = {"params": params_from_numpy(jax.tree.map(np.asarray, base), "cpu")}
    pick = lambda t: t["params"]  # noqa: E731

    def save(step, bias, corrupt=False):
        writer.save({"params": dict(base, bias=base["bias"] + bias)}, step, blocking=True)
        if corrupt:
            _corrupt(str(tmp_path), step)

    def both():
        got = (_poll(jengine, jmgr, jtemplate, pick), _poll(engine, mgr, template, pick))
        assert got[0] == got[1], got
        assert jengine.model_step == engine.model_step
        assert jengine.last_refresh_error == engine.last_refresh_error
        if engine.cache is not None:
            np.testing.assert_allclose(engine.score(ctx).numpy(),
                                       np.asarray(jengine.score(ctx)), atol=1e-5, rtol=1e-5)
        return got[1]

    assert both() is False                        # nothing written yet
    save(1, 0.0)
    assert both() is True and engine.model_step == 1
    assert both() is False
    save(2, 1.0)
    assert both() is True and engine.model_step == 2
    save(3, 2.0, corrupt=True)
    assert both() == ("failed", 3) and engine.model_step == 2
    assert "step 3 failed validation" in engine.last_refresh_error
    assert both() is False                        # poison-safe: silent now
    save(4, 3.0)
    assert both() is True and engine.model_step == 4 and engine.last_refresh_error is None
    save(5, 4.0)
    save(6, 5.0, corrupt=True)
    assert both() is True and engine.model_step == 5
    assert engine.last_refresh_error == ("checkpoint step 6 failed validation; installed "
                                         "fallback step 5")
    assert torch.equal(engine.params["bias"], torch.tensor(np.asarray(base["bias"]) + 4.0))


def test_frontend_maybe_refresh_for_a_tenant(tmp_path):
    cfg = dplr_fwfm.make_smoke()
    data = SyntheticCTR(cfg.layout, seed=1)
    from repro_torch.models.recsys import fwfm

    params = fwfm.init(torch.Generator().manual_seed(0), cfg)
    states = {}
    for i, name in enumerate(("a", "b")):
        c = data.ranking_query(100, i)
        states[name] = CorpusState(cfg, c["item_ids"][0], device="cpu")
        states[name].refresh(params, step=0)
    fe = QueryFrontend(states, max_batch=2, max_k=4, auto_pump=False)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"params": dict(params, bias=params["bias"] + 1.0)}, 3, blocking=True)
    assert fe.maybe_refresh(mgr, {"params": params}, select=lambda t: t["params"], tenant="b")
    assert states["b"].model_step == 3 and states["a"].model_step == 0
    assert float(states["b"].params["bias"]) == float(params["bias"]) + 1.0
    assert not fe.maybe_refresh(mgr, {"params": params}, select=lambda t: t["params"],
                                tenant="b")
    health = fe.health()
    assert health["tenants"]["b"]["model_step"] == 3 and not health["degraded"]
    _corrupt(str(tmp_path), 3)
    mgr.save({"params": params}, 4, blocking=True)
    _corrupt(str(tmp_path), 4)
    with pytest.raises(RefreshFailed):
        fe.maybe_refresh(mgr, {"params": params}, select=lambda t: t["params"], tenant="a")
    health = fe.health()
    assert health["degraded"] and "step 4" in health["tenants"]["a"]["last_refresh_error"]
    pend = fe.submit(data.context_query(0)["context_ids"], k=4, tenant="a")
    fe.pump()
    fe.drain()
    assert pend.result()[0].shape == (4,)         # the last-good snapshot still serves
    fe.close()


def test_serve_refresh_demo_prints_round_trip_ok():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
                          "--refresh-demo", "--items", "200", "--queries", "12"],
                         env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "refreshed to checkpoint step 1" in out.stdout
    assert "refresh round-trip OK: 1 refresh(es)" in out.stdout

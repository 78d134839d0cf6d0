"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import no JAX
and nothing of the JAX package, every module imports (and serves, trains,
serves a sharded corpus, ranks through ``rank_items_mp``, trains through
the row-blocked lookup of ``embedding.sharded``, reduces through
``optim.compression`` and ``sharding.collectives``, trains on two data
replicas, runs an MoE LM's train, prefill and decode cells on a (2, 2)
mesh through ``models.transformer.parallel``, counts a device of the
production mesh on ``meta`` (mixtral-8x7b's train step among them), and
answers over the RPC server under an injected fault) with JAX blocked,
and asking for the card where there is none raises."""
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
from repro_torch.configs import gemma3_1b  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import model as tm  # noqa: E402
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
from repro_torch.serving.frontend import QueryFrontend
from repro_torch.serving.runtime import ScorerRuntime
rt = ScorerRuntime(cfg, device="cpu")
states = {}
for t in ("a", "b"):
    states[t] = CorpusState(None, q["item_ids"][0], runtime=rt)
    states[t].refresh(engine.params)
fe = QueryFrontend(states, max_batch=1, max_k=5, auto_pump=False, pack=True)
pend = [fe.submit(q["context_ids"], k=5, tenant=t) for t in states]
fe.pump()
fe.drain()
assert fe.stats["fused_dispatches"] == 1
assert all((p.result()[1] == ids.numpy()[0]).all() for p in pend)
from repro_torch.serving import FaultInjector, RpcClient, serve_in_thread
inj = FaultInjector(seed=0)
fe = QueryFrontend(states, max_batch=1, max_k=5, auto_pump=False, fault_injector=inj)
server = serve_in_thread(fe)
inj.arm("dispatch", count=1)
with RpcClient("127.0.0.1", server.port, timeout=30.0) as cli:
    sc, sl = cli.rank(q["context_ids"], k=5, tenant="a")
server.stop(timeout=30.0)
assert (sl == ids.numpy()[0]).all() and inj.fired("dispatch") == 1
import dataclasses
from repro_torch.core.pruning import prune_matched
from repro_torch.eval import harness
fcfg = dataclasses.replace(cfg, interaction="fwfm")
fparams = fwfm.init(torch.Generator().manual_seed(1), fcfg)
pr = prune_matched(fwfm.field_matrix(fparams, fcfg), fcfg.n_fields, 2)
for p_, c_, mask in ((engine.params, cfg, None), (fparams, fcfg, pr.mask)):
    got = harness.evaluate_pointwise(p_, c_, data, n=300, batch_size=128, pruned_mask=mask)
    assert 0.0 <= got["auc"] <= 1.0
es = harness.ranking_eval_set(data, n_queries=2, n_items=16)
assert harness.serving_parity(engine.params, cfg, es, k=3)["max_abs_diff"]["engine"] < 1e-4
from repro_torch.configs import gemma3_1b
from repro_torch.models.transformer import model as tm
lcfg = gemma3_1b.make_smoke()
lp = tm.init(torch.Generator().manual_seed(0), lcfg)
toks = torch.randint(0, lcfg.vocab, (2, 9))
lg, cache = tm.prefill(lp, lcfg, toks, 12, device="cpu")
lg, cache = tm.decode_step(lp, lcfg, lg[:, :, :lcfg.vocab].argmax(-1), cache, 9, device="cpu")
assert lg.shape == (2, 1, lcfg.vocab_padded) and torch.isfinite(lg[..., :lcfg.vocab]).all()
import contextlib, io, tempfile
import numpy as np
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.dplr import posthoc_dplr
from repro_torch.launch import train
ckpt = tempfile.mkdtemp()
with contextlib.redirect_stdout(io.StringIO()):
    losses = train.main(["--device", "cpu", "--steps", "4", "--batch", "32", "--ckpt-dir", ckpt,
                         "--ckpt-every", "2", "--quiet"])
assert len(losses) == 4 and all(np.isfinite(losses))
st = CorpusState(cfg, q["item_ids"][0], device="cpu")
assert st.maybe_refresh(CheckpointManager(ckpt), {"params": engine.params},
                        select=lambda t: t["params"]) and st.model_step == 4
R = np.ones((6, 6)) - np.eye(6)
U, e, d = posthoc_dplr(R, 1, polish_steps=3, device="cpu")
assert U.shape == (1, 6) and np.isfinite(d).all()
assert optim.warmup_cosine(0.1, 2, 10)(5) > 0
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding import corpus_cache_specs
sh = CorpusState(cfg, q["item_ids"][0], mesh=make_host_mesh(4, device="cpu"))
sh.refresh(engine.params)
svals, sids = sh.topk(q["context_ids"], 5)
assert torch.equal(svals, vals) and torch.equal(sids, ids) and sh.n_shards == 4
assert corpus_cache_specs(None).Q_I == (None, "model", None, None)
qt = {k: torch.as_tensor(v) for k, v in q.items()}
mp = fwfm.rank_items_mp(engine.params, cfg, qt, mesh=make_host_mesh(2, device="cpu"))
assert torch.allclose(mp, fwfm.rank_items(engine.params, cfg, qt), atol=1e-5, rtol=1e-5)
from repro_torch.embedding.sharded import make_sharded_take, sharded_lookup_field_embeddings
from repro_torch.optim.compression import compressed_psum
from repro_torch.launch import steps
tb = {k: torch.as_tensor(v) for k, v in data.batch(32, 0).items()}
take = make_sharded_take(make_host_mesh(4, device="cpu"))
l4, g4 = optim.value_and_grad(lambda p, c, b: fwfm.loss(p, c, b, take_fn=take))(
    engine.params, cfg, tb)
l1, g1 = optim.value_and_grad(fwfm.loss)(engine.params, cfg, tb)
assert torch.allclose(l4, l1, atol=1e-6) and torch.allclose(g4["embedding"], g1["embedding"],
                                                             atol=1e-6)
V = sharded_lookup_field_embeddings(engine.params["embedding"], cfg.layout, tb["ids"],
                                    tb["weights"], mesh=make_host_mesh(2, device="cpu"))
assert V.shape == (32, cfg.layout.n_fields, cfg.embed_dim)
outs, errs = compressed_psum([g1["embedding"]] * 2, [torch.zeros_like(g1["embedding"])] * 2)
assert torch.allclose(outs[0] + errs[0], g1["embedding"], atol=1e-6)
cell = steps.build("dplr-fwfm", "train_batch", device="cpu", cfg=cfg, dims={"batch": 16},
                   mesh=make_host_mesh(4, device="cpu"))
assert torch.isfinite(cell.fn(*cell.args)[0])
from repro_torch.launch import cost
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.sharding import collectives
m22 = Mesh(("data", "model"), (2, 2), ("cpu",) * 4)
xs = [torch.ones(3), torch.full((3,), 2.0)]
assert torch.equal(collectives.all_reduce(xs, m22.groups("data")[0], "mean")[1],
                   torch.full((3,), 1.5))
cell = steps.build("dplr-fwfm", "train_batch", device="cpu", cfg=cfg, dims={"batch": 2048},
                   mesh=m22)
assert torch.isfinite(cell.fn(*cell.args)[0])
pod = make_production_mesh(device="meta")
cell = steps.build("dplr-fwfm", "serve_p99", mesh=pod)
got = cost.analyze(cell.fn, *cell.args, mesh=pod, specs=cell.arg_specs())
assert got["n_devices"] == 256 and got["collective_bytes"]["all-reduce"]["count"] > 0
from repro_torch.configs import granite_moe_1b_a400m
from repro_torch.models.transformer import parallel
for shape, dims in (("train_4k", {"batch": 4, "seq": 16}), ("prefill_32k", {"batch": 2, "seq": 16}),
                    ("decode_32k", {"batch": 2, "seq": 16})):
    cell = steps.build("granite-moe-1b-a400m", shape, device="cpu", dims=dims, mesh=m22,
                       cfg=granite_moe_1b_a400m.make_smoke())
    assert isinstance(cell.plan, parallel.Plan) and torch.isfinite(cell.fn(*cell.args)[0]).all()
cell = steps.build("mixtral-8x7b", "train_4k", mesh=pod)
got = cost.analyze(cell.fn, *cell.args, mesh=pod, specs=cell.arg_specs())
assert got["collective_bytes"]["reduce-scatter"]["count"] > 0
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


def test_asking_for_the_card_without_one_raises(monkeypatch, tmp_path):
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
    lcfg = gemma3_1b.make_smoke()
    params = tm.init(torch.Generator().manual_seed(0), lcfg)
    toks = np.zeros((1, 4), np.int64)
    for call in (lambda: tm.prefill(params, lcfg, toks, 8), lambda: tm.forward(params, lcfg, toks),
                 lambda: tm.init_cache(lcfg, 1, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.dplr import posthoc_dplr
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1", "--batch", "8", "--quiet"])
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"bias": torch.zeros(())}, 1, blocking=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore({"bias": None})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        posthoc_dplr(np.ones((4, 4)) - np.eye(4), 1, polish_steps=1)
    # the lm family trains (through the plain attention) on the card by default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "gemma3-1b", "--steps", "1", "--batch", "1", "--seq", "8"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.lm_loss(params, lcfg, {"tokens": toks, "labels": toks})
    from repro_torch.examples import gnn_train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        gnn_train.main(["--steps", "1"])


_TOOLS_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import contextlib, io, json, sys, tempfile
from repro_torch.launch import cost, dryrun, steps
cell = steps.build("granite-moe-1b-a400m", "train_4k", device="meta")
got = cost.analyze(cell.fn, *cell.args)
assert got["flops"] > 0 and got["peak_bytes"] > 0
out = tempfile.mkdtemp()
with contextlib.redirect_stdout(io.StringIO()):
    assert dryrun.main(["--arch", "dplr-fwfm", "--shape", "serve_p99", "--out", out]) == 0
rec = json.load(open(out + "/dplr-fwfm__serve_p99.json"))
assert rec["ok"] and "dplr_score_items" in rec["kernels"]
from repro_torch.examples import quickstart, ranking_server, train_e2e
from repro_torch.core.fields import uniform_layout
with contextlib.redirect_stdout(io.StringIO()):
    qs = quickstart.run(1, 1, "cpu")
    e2e = train_e2e.run(uniform_layout(2, 2, 30), 2, 16, tempfile.mkdtemp(), device="cpu",
                        ckpt_every=1)
    rs = ranking_server.main(["--device", "cpu", "--items", "64", "--queries", "3",
                              "--churn", "1"])
assert len(qs["top5"]) == 5 and sorted(e2e["losses"]) == [1, 2]
assert rs["counts"]["submitted"] == rs["counts"]["completed"] == 9
print("ok")
"""


def test_the_launch_tools_and_drivers_run_with_jax_blocked():
    """``launch/{steps,cost,dryrun}`` count a cell on meta and write a
    record, and the three examples run on the CPU, with JAX blocked."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _TOOLS_BLOCKED], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("example", ["quickstart", "train_e2e", "ranking_server"])
def test_each_driver_asks_for_the_card_by_default(example, monkeypatch):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.examples.{example}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--device", "cuda"])

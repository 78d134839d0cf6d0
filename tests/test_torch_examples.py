"""The port's drivers against the JAX package's ``examples/``: quickstart
and train_e2e train from the reference example's own initial weights
(carried through numpy) on the same batches, within the train parity
bounds of ``tests/test_torch_train.py``; ranking_server runs its seven
paths on the CPU, its per-call and corpus-engine scores match the
reference's on the same weights, and a SIGTERM mid-run closes its
frontends with nothing dropped."""
import importlib.util
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.core.fields import uniform_layout as j_uniform_layout  # noqa: E402
from repro.data.synthetic_ctr import SyntheticCTR as JSyntheticCTR  # noqa: E402
from repro.models.recsys import fwfm as jfwfm  # noqa: E402
from repro.serving import CorpusRankingEngine as JEngine  # noqa: E402
from repro.serving.corpus import next_pow2  # noqa: E402
from repro_torch.core.fields import uniform_layout  # noqa: E402
from repro_torch.examples import quickstart, ranking_server, train_e2e  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _reference(name: str):
    """The JAX package's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"ref_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close_loss(got: float, want: float, what: str) -> None:
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (what, got, want)


def _close_scores(got, want, what: str) -> None:
    """Scores within ``1e-5 max(1, |s|)`` of the reference's."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    assert (err <= 1e-5 * np.maximum(1.0, np.abs(want))).all(), (what, err.max())


def _close_params(got: dict, want: dict) -> None:
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().cpu().numpy(), np.asarray(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def _jax_cfg(cfg, layout):
    return jfwfm.FwFMConfig(layout=layout, embed_dim=cfg.embed_dim,
                            interaction=cfg.interaction, rank=cfg.rank)


@pytest.fixture
def recorded_losses(monkeypatch):
    """Each ``repro`` fwfm loss the reference's jitted steps compute, in
    order (a callback inside the traced loss)."""
    seen = []
    inner = jfwfm.loss

    def loss(params, cfg, batch, **kw):
        value = inner(params, cfg, batch, **kw)
        jax.debug.callback(lambda v: seen.append(float(v)), value)
        return value

    monkeypatch.setattr(jfwfm, "loss", loss)
    return seen


def test_quickstart_matches_the_reference(recorded_losses):
    """The reference's own flow, composed from its ``train`` and ``auc``,
    and the port's ``run`` from the same initial weights (each training's
    ``fwfm.init(PRNGKey(0), cfg)``), 3 steps a model and 2 for Algorithm
    1's: losses, params, the four AUCs on 20,000 rows, and Algorithm 1's
    scores and top-5 over 1,000 candidates."""
    ref = _reference("quickstart")
    steps, rank_steps = 3, 2
    jlayout = j_uniform_layout(10, 9, 500)
    jdata = JSyntheticCTR(jlayout, embed_dim=4, teacher_rank=2, noise_scale=0.3, seed=0)
    ev = jdata.batch(20000, 10**6)
    jev = {k: jnp.asarray(v) for k, v in ev.items()}

    def init(cfg):
        p = jfwfm.init(jax.random.PRNGKey(0), _jax_cfg(cfg, jlayout))
        return params_from_numpy(jax.tree.map(np.asarray, p), "cpu")

    losses = {}
    got = quickstart.run(steps, rank_steps, "cpu", init=init, losses=losses)

    want_auc, trained = {}, {}
    for name, cfg in quickstart.configs(uniform_layout(10, 9, 500)):
        jcfg = _jax_cfg(cfg, jlayout)
        del recorded_losses[:]
        trained[name] = ref.train(jcfg, jdata, steps=steps)
        for s, (g, w) in enumerate(zip(losses[name], recorded_losses, strict=True)):
            _close_loss(g, w, f"{name} step {s}")
        _close_params(got["params"][name], trained[name])
        want_auc[name] = ref.auc(ev["label"], np.asarray(jfwfm.apply(trained[name], jcfg, jev)))
    jcfg = _jax_cfg(quickstart.configs(uniform_layout(10, 9, 500))[1][1], jlayout)
    R = jfwfm.field_matrix(trained["fwfm"], jcfg)
    from repro.core.pruning import prune_matched
    pruned = prune_matched(R, jlayout.n_fields, rank=2)
    want_auc["pruned(r=2-eq)"] = ref.auc(ev["label"], np.asarray(
        jfwfm.apply(trained["fwfm"], jcfg, jev, pruned_mask=pruned.mask)))
    assert set(got["auc"]) == set(want_auc)
    for name, value in want_auc.items():
        assert abs(got["auc"][name] - value) <= 1e-4, (name, got["auc"][name], value)

    jcfg = _jax_cfg(quickstart.configs(uniform_layout(10, 9, 500))[-1][1], jlayout)
    del recorded_losses[:]
    params = ref.train(jcfg, jdata, steps=rank_steps)
    for g, w in zip(losses["rank"], recorded_losses, strict=True):
        _close_loss(g, w, "Algorithm 1's model")
    q = {k: jnp.asarray(v) for k, v in jdata.ranking_query(1000, 0).items()}
    want = np.asarray(jfwfm.rank_items(params, jcfg, q))[0]
    scores = got["scores"][0].numpy()
    _close_scores(scores, want, "Algorithm 1's scores")
    top = np.argsort(-want, kind="stable")[:5]
    tied = np.abs(want - want[top[-1]]) <= 1e-5 * max(1.0, abs(want[top[-1]]))
    assert (got["top5"] == top).all() or set(got["top5"]) - set(top) <= set(np.flatnonzero(tied))


NARROW = [300, 200, 50, 40, 30, 20, 10]          # 3 context + 4 item fields


def _e2e_reference(layout, steps: int, batch: int):
    """The reference example's loop on ``layout``: its init, data, adagrad
    at lr 0.05 and eval."""
    cfg = jfwfm.FwFMConfig(layout=layout, embed_dim=16, interaction="dplr", rank=3)
    params = jfwfm.init(jax.random.PRNGKey(0), cfg)
    data = JSyntheticCTR(layout, embed_dim=4, teacher_rank=3, noise_scale=0.3, zipf_alpha=1.3,
                         seed=0)
    opt = joptim.adagrad()
    state = opt.init(params)

    @jax.jit
    def step_fn(params, state, b):
        loss, g = jax.value_and_grad(jfwfm.loss)(params, cfg, b)
        params, state = opt.update(g, state, params, 0.05)
        return params, state, loss

    losses = []
    for s in range(steps):
        b = {k: jnp.asarray(v) for k, v in data.batch(batch, s).items()}
        params, state, loss = step_fn(params, state, b)
        losses.append(float(loss))
    ev = data.batch(20000, 10**6)
    logits = np.asarray(jfwfm.apply(params, cfg, {k: jnp.asarray(v) for k, v in ev.items()}))
    return params, losses, _reference("quickstart").auc(ev["label"], logits), logits


def test_train_e2e_matches_the_reference_and_resumes_bitwise(tmp_path):
    """On a narrow layout (7 fields, 650 rows), B = 256, 6 steps with a
    checkpoint every 3: losses, params and the eval AUC against the
    reference's loop from its own init; then a run stopped at step 3 and
    resumed to 6 is bitwise the uninterrupted one (losses and params)."""
    steps, batch = 6, 256
    jlayout, layout = j_uniform_layout(3, 4, NARROW), uniform_layout(3, 4, NARROW)
    jparams, jlosses, jauc, jlogits = _e2e_reference(jlayout, steps, batch)
    init = jfwfm.init(jax.random.PRNGKey(0), jfwfm.FwFMConfig(
        layout=jlayout, embed_dim=16, interaction="dplr", rank=3))

    def carried():
        return params_from_numpy(jax.tree.map(np.asarray, init), "cpu")

    a = train_e2e.run(layout, steps, batch, tmp_path / "a", device="cpu", params=carried(),
                      ckpt_every=3)
    assert a["start"] == 0 and sorted(a["losses"]) == list(range(1, steps + 1))
    for s, want in enumerate(jlosses, 1):
        _close_loss(a["losses"][s], want, f"step {s}")
    _close_params(a["params"], jparams)
    np.testing.assert_allclose(a["logits"], jlogits, rtol=1e-4, atol=1e-5)
    assert abs(a["auc"] - jauc) <= 1e-4

    train_e2e.run(layout, 3, batch, tmp_path / "b", device="cpu", params=carried(),
                  ckpt_every=3)
    b = train_e2e.run(layout, steps, batch, tmp_path / "b", resume=True, device="cpu",
                      params=carried(), ckpt_every=3)
    assert b["start"] == 3 and sorted(b["losses"]) == [4, 5, 6]
    assert all(b["losses"][s] == a["losses"][s] for s in (4, 5, 6))
    for k, v in a["params"].items():
        assert torch.equal(b["params"][k], v), k
    assert b["auc"] == a["auc"]


def test_train_e2e_layout_is_the_references():
    ref = _reference("train_e2e")
    src = Path(ref.__file__).read_text()
    assert "uniform_layout(44, 38, vocabs)" in src
    layout = train_e2e.make_layout()
    assert layout.n_fields == 82 and layout.total_vocab == sum(train_e2e.VOCABS)
    # the reference's docstring says 5.9M rows; its vocabularies sum to 5.44M
    assert layout.total_vocab == 5_437_400


def _server_reference(params_np, items: int, topk: int):
    """The reference's paths 1 and 2 on the example's geometry: Algorithm
    1 for query 0, and its corpus engine's answer to context 0."""
    layout = j_uniform_layout(25, 38, 1000)
    cfg = jfwfm.FwFMConfig(layout=layout, embed_dim=16, interaction="dplr", rank=3)
    params = jax.tree.map(jnp.asarray, params_np)
    data = JSyntheticCTR(layout, embed_dim=8, seed=0)
    q = {k: jnp.asarray(v) for k, v in data.ranking_query(items, 0).items()}
    percall = np.asarray(jfwfm.rank_items(params, cfg, q))
    corpus = data.ranking_query(items, 0)
    engine = JEngine(cfg, corpus["item_ids"][0], corpus["item_weights"][0],
                     capacity=next_pow2(items))
    engine.refresh(params, step=0)
    qn = data.context_query(0)
    ctx, w = jnp.asarray(qn["context_ids"]), jnp.asarray(qn["context_weights"])
    out = engine.topk(ctx, topk, w) if topk else engine.score(ctx, w)
    return percall, jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("extra", [[], ["--topk", "5", "--use-pallas"]],
                         ids=["score", "topk-packed"])
def test_ranking_server_paths_match_the_reference(extra, capsys):
    """``--device cpu --items 256 --queries 10``: every path prints its
    line; path 1's scores and path 2's (full scores, or the top-K with its
    ids equal but where scores tie) match the reference's on the same
    weights within 1e-5 max(1, |s|)."""
    layout = j_uniform_layout(25, 38, 1000)
    jparams = jfwfm.init(jax.random.PRNGKey(0), jfwfm.FwFMConfig(
        layout=layout, embed_dim=16, interaction="dplr", rank=3))
    params_np = jax.tree.map(np.asarray, jparams)
    out = ranking_server.main(["--device", "cpu", "--items", "256", "--queries", "10", *extra],
                              params=params_from_numpy(params_np, "cpu"))
    printed = capsys.readouterr().out
    tag = "corpus+pallas :" if "--use-pallas" in extra else "corpus engine :"
    for line in ("per-call Alg. 1 :", tag, "catalog churn  :", "frontend       :",
                 "multi-tenant   :", "rpc            :", "shutdown       :"):
        assert printed.count(line) == 1, line
    topk = int(extra[1]) if extra else 0
    percall, corpus = _server_reference(params_np, 256, topk)
    _close_scores(out["percall"]["scores"], percall, "path 1")
    if topk:
        vals, ids = out["corpus"]["result"]
        _close_scores(vals, corpus[0], "path 2's top-K")
        tie = np.abs(corpus[0][0] - corpus[0][0][-1]) <= 1e-5 * max(1.0, abs(corpus[0][0][-1]))
        assert (ids == corpus[1])[0][~tie].all()
    else:
        scores = out["corpus"]["result"]
        _close_scores(scores, corpus, "path 2's scores")
    # paths 6-7 report their fused rounds (how many depends on the timing of
    # the submissions: the card run requires kernel 4 among their launches)
    fused = [ln for ln in printed.splitlines()
             if ln.startswith(("multi-tenant", "rpc ")) and " fused launches" in ln]
    assert len(fused) == 2, printed
    c = out["counts"]
    assert c["submitted"] == c["completed"] == 30 and c["failed"] == 0
    # the handlers are the caller's again
    assert signal.getsignal(signal.SIGTERM) is not ranking_server._graceful_exit


def test_ranking_server_sigterm_closes_the_frontends_and_drops_nothing():
    """A SIGTERM once the frontends serve: the process closes every live
    frontend, exits 128 + 15, and its counts add up (every accepted
    request completed or failed typed)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.examples.ranking_server", "--device", "cpu",
         "--items", "256", "--queries", "600", "--churn", "2"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("frontend"):
                proc.send_signal(signal.SIGTERM)
                break
        rest, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    out = "".join(lines) + rest
    assert proc.returncode == 128 + signal.SIGTERM, (out, err[-2000:])
    closing = [ln for ln in out.splitlines() if ln.startswith("signal 15: frontends closed")]
    assert len(closing) == 1, out
    nums = [int(x) for x in closing[0].split("(submitted ")[1].rstrip(")").replace(
        "= completed", "").replace("+ failed", "").replace("+ expired", "").replace(
        "+ shed", "").split()]
    submitted, completed, failed, expired, shed = nums
    assert submitted == completed + failed + expired + shed and submitted >= 600
    assert "shutdown       :" not in out          # it stopped mid-run

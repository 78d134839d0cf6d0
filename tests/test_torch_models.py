"""The rest of the recsys family (Wide&Deep, AutoInt, BST, MIND) and the
shared layers, port against the JAX package on the CPU: the same numpy
inputs and the same weights (the JAX ``init``'s, carried over through
``params_from_numpy``) go through both.

Tolerance: ``1e-5 * max(1, |x|)`` for logits, scores and losses, and
``1e-5 * max(1, max|g|)`` per gradient leaf.  Also: ``rank_items``
against ``apply`` on the same (context, item) rows (the reference's own
identity, ``tests/test_ranking.py``, at its 1e-4), two train steps
against ``jax.value_and_grad`` + adagrad, and the two drivers."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import REGISTRY as JREGISTRY  # noqa: E402
from repro.data.synthetic_ctr import SyntheticCTR as JSyntheticCTR  # noqa: E402
from repro.launch.train import build_recsys_trainer as jbuild  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.recsys import autoint as jautoint  # noqa: E402
from repro.models.recsys import bst as jbst  # noqa: E402
from repro.models.recsys import mind as jmind  # noqa: E402
from repro.models.recsys import wide_deep as jwide_deep  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs.registry import REGISTRY  # noqa: E402
from repro_torch.embedding.bag import gather_rows  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.recsys import autoint, bst, mind, wide_deep  # noqa: E402

JMODULES = {"wide-deep": jwide_deep, "autoint": jautoint, "bst": jbst, "mind": jmind}
MODULES = {"wide-deep": wide_deep, "autoint": autoint, "bst": bst, "mind": mind}

# (arch, DPLR head): the smoke configs of Wide&Deep and AutoInt carry the head
CASES = [("wide-deep", True), ("wide-deep", False), ("autoint", True), ("autoint", False),
         ("bst", False), ("mind", False)]
IDS = [f"{a}{'-dplr' if h else ''}" for a, h in CASES]


def _close(got, want, what=""):
    got = np.asarray(got.detach() if hasattr(got, "detach") else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    bound = 1e-5 * np.maximum(1.0, np.abs(want))
    err = np.abs(got - want)
    assert (err <= bound).all(), f"{what}: max |diff| {err.max():.3g}"


def _close_leaf(got, want, what):
    got = np.asarray(got.detach(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max(initial=0.0)
    assert err <= 1e-5 * max(1.0, np.abs(want).max(initial=0.0)), f"{what}: {err:.3g}"


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _configs(arch, head):
    jcfg, cfg = JREGISTRY[arch].make_smoke(), REGISTRY[arch].make_smoke()
    if hasattr(cfg, "use_dplr_head"):
        jcfg = dataclasses.replace(jcfg, use_dplr_head=head)
        cfg = dataclasses.replace(cfg, use_dplr_head=head)
    return jcfg, cfg


def _params(arch, jcfg, seed=0):
    jparams = JMODULES[arch].init(jax.random.PRNGKey(seed), jcfg)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _both(batch):
    return (jax.tree.map(jnp.asarray, batch),
            {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()})


# -- layers -------------------------------------------------------------------

def _layer_case(name, rng):
    """(JAX output, port output) of one layer on the same numpy inputs."""
    x = rng.standard_normal((3, 6, 8)).astype(np.float32)
    tx = torch.from_numpy(x)
    if name.startswith("mlp"):
        p = jax.tree.map(np.asarray, jlayers.init_mlp(jax.random.PRNGKey(1), [8, 16, 4]))
        leaky = name == "mlp-leaky"
        kw = dict(activation=jax.nn.leaky_relu, final_activation=jnp.tanh) if leaky else {}
        tkw = dict(activation=torch.nn.functional.leaky_relu,
                   final_activation=torch.tanh) if leaky else {}
        return (jlayers.apply_mlp(p, x, **kw),
                layers.apply_mlp(params_from_numpy(p, "cpu"), tx, **tkw))
    if name in ("layer-norm", "rms-norm"):
        p = {"scale": rng.standard_normal(8).astype(np.float32),
             "bias": rng.standard_normal(8).astype(np.float32)}
        if name == "rms-norm":
            p.pop("bias")
            return (jlayers.apply_rms_norm(p, x),
                    layers.apply_rms_norm(params_from_numpy(p, "cpu"), tx))
        return (jlayers.apply_layer_norm(p, x),
                layers.apply_layer_norm(params_from_numpy(p, "cpu"), tx))
    p = jax.tree.map(np.asarray, jlayers.init_mha(jax.random.PRNGKey(2), 8, 4, 2, d_out=6))
    mask = None
    if name == "mha-masked":
        m1 = (rng.random((3, 6)) > 0.3).astype(np.float32)
        m1[:, -1] = 1.0
        mask = m1[:, None, :] * m1[:, :, None]
    scaled = name != "mha-unscaled"
    return (jlayers.apply_mha(p, x, n_heads=2, mask=mask, scaled=scaled),
            layers.apply_mha(params_from_numpy(p, "cpu"), tx, n_heads=2, scaled=scaled,
                             mask=None if mask is None else torch.from_numpy(mask)))


@pytest.mark.parametrize("name", ["mlp", "mlp-leaky", "layer-norm", "rms-norm", "mha",
                                  "mha-unscaled", "mha-masked"])
def test_layers_match_jax(name):
    want, got = _layer_case(name, np.random.default_rng(0))
    _close(got, want, name)


def test_inits_have_the_jax_trees():
    """Every model's ``init`` gives the JAX ``init``'s keys, shapes and
    dtypes (the values differ: the two random streams differ)."""
    for arch, head in CASES:
        jcfg, cfg = _configs(arch, head)
        jparams = JMODULES[arch].init(jax.random.PRNGKey(0), jcfg)
        got = dict(_flat(MODULES[arch].init(torch.Generator().manual_seed(0), cfg)))
        want = dict(_flat(jax.tree.map(np.asarray, jparams)))
        assert sorted(got) == sorted(want), arch
        for k, v in want.items():
            assert tuple(got[k].shape) == v.shape and got[k].dtype == torch.float32, (arch, k)


def test_gather_rows_is_the_rows_and_sums_its_gradient():
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((20, 4)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 20, (3, 5)).astype(np.int32))
    assert torch.equal(gather_rows(table, ids), table[ids.long()])
    t = table.clone().requires_grad_()
    g = torch.from_numpy(rng.standard_normal((3, 5, 4)).astype(np.float32))
    (gather_rows(t, ids) * g).sum().backward()
    want = torch.zeros_like(table).index_add_(0, ids.reshape(-1).long(), g.reshape(-1, 4))
    torch.testing.assert_close(t.grad, want, rtol=1e-6, atol=1e-6)


# -- the models ---------------------------------------------------------------

@pytest.mark.parametrize("arch,head", CASES, ids=IDS)
def test_apply_loss_and_gradients_match_jax(arch, head):
    """``apply``, ``loss`` and every gradient leaf on the JAX trainer's
    batch; the port's trainer makes that batch bitwise."""
    jcfg, cfg = _configs(arch, head)
    jparams, params = _params(arch, jcfg)
    jmod, mod = JMODULES[arch], MODULES[arch]
    _, jmake = jbuild(arch, jcfg, 64, 0)
    _, make = train.build_recsys_trainer(arch, cfg, 64, 0)
    batch = jmake(0)
    for k, v in make(0).items():
        np.testing.assert_array_equal(v, batch[k], err_msg=k)
    assert sorted(make(0)) == sorted(batch)
    jb, tb = _both(batch)
    _close(mod.apply(params, cfg, tb), jmod.apply(jparams, jcfg, jb), f"{arch} apply")
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, b: jmod.loss(p, jcfg, b)))(
        jparams, jb)
    loss, grads = optim.value_and_grad(mod.loss)(params, cfg, tb)
    _close(loss, jloss, f"{arch} loss")
    want = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    got = dict(_flat(grads))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        _close_leaf(got[k], v, f"{arch} d{k}")
    if arch == "mind":
        assert not got["b_init"].any()            # frozen routing logits


def _query(arch, cfg, n, seed):
    """A ranking query as numpy: ``SyntheticCTR.ranking_query``'s context
    and items, plus for BST and MIND a history with some slots masked
    (MIND's query has no context fields, as ``launch/steps.py`` shapes
    it)."""
    rng = np.random.default_rng((seed, 11))
    q = JSyntheticCTR(cfg.layout, embed_dim=4, seed=seed).ranking_query(n, seed)
    if arch in ("bst", "mind"):
        item_vocab = cfg.layout.fields[-1].vocab_size
        q["hist_ids"] = rng.integers(0, item_vocab, (1, cfg.seq_len)).astype(np.int32)
        q["hist_mask"] = (rng.random((1, cfg.seq_len)) > 0.25).astype(np.float32)
    if arch == "mind":
        q = {k: q[k] for k in ("hist_ids", "hist_mask", "item_ids")}
    return q


def _pointwise_rows(arch, q):
    """The (context, item) rows of a query, as ``apply`` takes them."""
    n = q["item_ids"].shape[1]
    if arch == "mind":
        return {"hist_ids": np.repeat(q["hist_ids"], n, 0),
                "hist_mask": np.repeat(q["hist_mask"], n, 0),
                "target_id": q["item_ids"][0, :, 0]}
    ctx = np.repeat(q["context_ids"], n, 0)
    ids = np.concatenate([ctx, q["item_ids"][0]], axis=-1)
    rows = {"ids": ids, "weights": np.ones(ids.shape, np.float32)}
    if arch == "bst":
        rows["hist_ids"] = np.repeat(q["hist_ids"], n, 0)
        rows["hist_mask"] = np.repeat(q["hist_mask"], n, 0)
    return rows


@pytest.mark.parametrize("arch,head", CASES, ids=IDS)
def test_rank_items_matches_jax_and_apply(arch, head):
    jcfg, cfg = _configs(arch, head)
    jparams, params = _params(arch, jcfg, seed=1)
    q = _query(arch, cfg, 48, seed=2)
    jq, tq = _both(q)
    got = MODULES[arch].rank_items(params, cfg, tq)
    assert got.shape == (1, 48)
    _close(got, JMODULES[arch].rank_items(jparams, jcfg, jq), f"{arch} rank_items")
    _, rows = _both(_pointwise_rows(arch, q))
    np.testing.assert_allclose(got[0].numpy(), MODULES[arch].apply(params, cfg, rows).numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch,head", CASES, ids=IDS)
def test_two_train_steps_match_jax(arch, head):
    """Two adagrad steps at lr 0.05 through ``launch.train.train_step``
    against the JAX driver's step (``value_and_grad`` + ``adagrad``)."""
    jcfg, cfg = _configs(arch, head)
    jparams, params = _params(arch, jcfg, seed=2)
    jmod, mod = JMODULES[arch], MODULES[arch]
    _, make = train.build_recsys_trainer(arch, cfg, 64, 0)
    jopt, opt = joptim.adagrad(), optim.adagrad()
    jstate, state = jopt.init(jparams), opt.init(params)

    @jax.jit
    def jstep(p, s, b):
        loss, g = jax.value_and_grad(lambda p_, b_: jmod.loss(p_, jcfg, b_))(p, b)
        p, s = jopt.update(g, s, p, 0.05)
        return loss, p, s

    for step in range(2):
        jb, tb = _both(make(step))
        jloss, jparams, jstate = jstep(jparams, jstate, jb)
        loss, params, state = train.train_step(mod, cfg, opt, params, state, tb, 0.05)
        _close(loss, jloss, f"{arch} step {step} loss")
    for tree, jtree in ((params, jparams), (state["acc"], jstate["acc"])):
        want = dict(_flat(jax.tree.map(np.asarray, jtree)))
        got = dict(_flat(tree))
        for k, v in want.items():
            _close_leaf(got[k], v, f"{arch} {k}")


# -- the drivers --------------------------------------------------------------

@pytest.mark.parametrize("arch", ["wide-deep", "autoint", "bst", "mind"])
def test_train_driver_runs_each_arch(arch, capsys):
    losses = train.main(["--arch", arch, "--device", "cpu", "--steps", "2", "--batch", "32",
                         "--log-every", "1"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "final loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["wide-deep", "autoint"])
def test_serve_driver_ranks_per_call(arch, capsys):
    serve.main(["--arch", arch, "--engine", "percall", "--device", "cpu", "--items", "40",
                "--queries", "4"])
    out = capsys.readouterr().out
    assert "query 0: top-3 of 40 candidates" in out
    assert f"4 queries x 40 items (percall, {arch}, cpu)" in out


@pytest.mark.parametrize("arch", ["bst", "mind"])
def test_serve_driver_refuses_archs_that_need_a_history(arch):
    with pytest.raises(ValueError, match="hist_ids"):
        serve.main(["--arch", arch, "--device", "cpu", "--items", "40", "--queries", "2"])


def test_serve_driver_keeps_the_corpus_engine_for_dplr():
    with pytest.raises(SystemExit):
        serve.main(["--arch", "wide-deep", "--engine", "corpus", "--device", "cpu"])

"""The port's optimizers, schedules and gradient accumulation against the
JAX package's (``repro.optim``), on the same numpy params and grads.
Tolerance: 1e-6 relative (atol 1e-6 of the largest entry)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro_torch import optim  # noqa: E402


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-30))


def _tree(rng, scale=1.0):
    return {"embedding": (rng.standard_normal((50, 8)) * scale).astype(np.float32),
            "U": (rng.standard_normal((2, 12)) * scale).astype(np.float32),
            "bias": np.asarray(rng.standard_normal() * scale, np.float32)}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


OPTIMIZERS = {
    "sgd": (lambda m: m.sgd(), 0.05),
    "sgd-momentum": (lambda m: m.sgd(momentum=0.9), 0.05),
    "adamw": (lambda m: m.adamw(), 1e-2),
    "adamw-decay-noclip": (lambda m: m.adamw(weight_decay=0.1, clip_norm=None), 1e-2),
    "adagrad": (lambda m: m.adagrad(), 0.1),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax_over_20_updates(name):
    make, lr = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jopt, opt = make(joptim), make(optim)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    jupdate = jax.jit(lambda g, s, p: jopt.update(g, s, p, lr))
    for _ in range(20):
        grads = _tree(rng, 0.5)
        jp, js = jupdate(jax.tree.map(jnp.asarray, grads), js, jp)
        tp_out, ts = opt.update({k: torch.from_numpy(v) for k, v in grads.items()}, ts, tp, lr)
        assert tp_out is tp                       # in place
    for k in params:
        _close(tp[k].numpy(), jp[k])
    jstate = dict(_leaves(jax.tree.map(np.asarray, js)))
    tstate = dict(_leaves(ts))
    assert sorted(jstate) == sorted(tstate)
    for key, v in jstate.items():
        assert tstate[key].dtype == torch.from_numpy(np.array(v)).dtype, key
        _close(tstate[key].numpy(), v)


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(1)
    grads = _tree(rng, 3.0)
    for max_norm in (0.5, 1e6):
        jg, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), max_norm)
        tg, tn = optim.clip_by_global_norm({k: torch.from_numpy(v) for k, v in grads.items()},
                                           max_norm)
        _close(tn.numpy(), jn)
        for k in grads:
            _close(tg[k].numpy(), jg[k])


@pytest.mark.parametrize("step", [0, 10, 100])
def test_warmup_cosine_and_constant_match_jax(step):
    args = (0.3, 20, 80)
    _close(optim.warmup_cosine(*args)(step).numpy(),
           joptim.warmup_cosine(*args)(jnp.asarray(step, jnp.int32)))
    _close(optim.constant(0.05)(step).numpy(), joptim.constant(0.05)(step))


def test_gradient_accumulation_matches_the_full_batch_and_jax():
    """The mean over 4 microbatches of a mean loss is the full batch's
    gradient; both packages split (B, ...) as (B/n, n, ...)."""
    rng = np.random.default_rng(2)
    params = {"w": rng.standard_normal((6, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    batch = {"x": rng.standard_normal((16, 6)).astype(np.float32),
             "y": rng.standard_normal((16, 3)).astype(np.float32)}

    def tloss(p, b):
        return ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean()

    def jloss(p, b):
        return ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean()

    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = optim.gradient_accumulation(tloss, 4)(tparams, tbatch)
    full_loss, full = optim.value_and_grad(tloss)(tparams, tbatch)
    jl, jg = joptim.gradient_accumulation(jloss, 4)(jax.tree.map(jnp.asarray, params),
                                                    jax.tree.map(jnp.asarray, batch))
    _close(loss.numpy(), full_loss.numpy())
    _close(loss.numpy(), jl)
    for k in params:
        _close(grads[k].numpy(), full[k].numpy())
        _close(grads[k].numpy(), jg[k])
    assert all(torch.equal(tparams[k], torch.from_numpy(params[k])) for k in params)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_blocked_update_is_bitwise_the_whole_leaf_update(name, monkeypatch):
    """A leaf larger than one block (``BLOCK`` cut to 4,096 elements, the
    leaf 12,345 x 7, not a multiple of it) updated block by block: params
    and state bitwise the whole-leaf update's, over 3 updates."""
    from repro_torch.optim import optimizers

    make, lr = OPTIMIZERS[name]
    rng = np.random.default_rng(4)
    params = {"embedding": rng.standard_normal((12_345, 7)).astype(np.float32),
              "bias": np.asarray(0.3, np.float32)}
    grads = [{k: np.asarray(rng.standard_normal(np.shape(v)) * 0.5, np.float32)
              for k, v in params.items()} for _ in range(3)]
    runs = []
    for block in (1 << 26, 4096):
        monkeypatch.setattr(optimizers, "BLOCK", block)
        opt = make(optim)
        tp = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
        ts = opt.init(tp)
        for g in grads:
            tp, ts = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp, lr)
        runs.append(dict(_leaves({"params": tp, "state": ts})))
    assert params["embedding"].size > 3 * 4096
    whole, blocked = runs
    assert sorted(whole) == sorted(blocked)
    for key in whole:
        assert torch.equal(whole[key], blocked[key]), key

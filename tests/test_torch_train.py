"""The port's training path against the JAX package's: the train step
(``value_and_grad(loss)`` + adagrad) from a shared init, the data
pipeline's determinism and resume, and the post-hoc DPLR factorization."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import dplr_fwfm as jconfig  # noqa: E402
from repro.core import dplr as jdplr  # noqa: E402
from repro.launch.train import build_recsys_trainer as jbuild  # noqa: E402
from repro.models.recsys import fwfm as jfwfm  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.core import dplr  # noqa: E402
from repro_torch.core.fields import uniform_layout  # noqa: E402
from repro_torch.data.pipeline import ShardedPipeline, host_shard_seed  # noqa: E402
from repro_torch.data.synthetic_ctr import SyntheticCTR  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.configs import dplr_fwfm  # noqa: E402
from repro_torch.launch import train  # noqa: E402


@pytest.mark.parametrize("interaction", ["dplr", "fwfm"])
def test_train_steps_match_jax_from_a_shared_init(interaction):
    """10 adagrad steps at ``make_smoke()``, B = 256, lr 0.1: the port's
    ``train_step`` against ``jax.value_and_grad(loss)`` + ``adagrad``, on
    the same batches (each package's own ``SyntheticCTR``, equal by
    construction), losses within 1e-5 * max(1, |loss|)."""
    jcfg = dataclasses.replace(jconfig.make_smoke(), interaction=interaction)
    cfg = dataclasses.replace(dplr_fwfm.make_smoke(), interaction=interaction)
    jparams = jfwfm.init(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    _, jbatch = jbuild("dplr-fwfm", jcfg, 256, 0)
    mod, make_batch = train.build_recsys_trainer("dplr-fwfm", cfg, 256, 0)
    jopt, opt = joptim.adagrad(), optim.adagrad()
    jstate, state = jopt.init(jparams), opt.init(params)

    @jax.jit
    def jstep(p, s, b):
        loss, g = jax.value_and_grad(jfwfm.loss)(p, jcfg, b)
        p, s = jopt.update(g, s, p, 0.1)
        return loss, p, s

    for step in range(10):
        b = make_batch(step)
        for k, v in jbatch(step).items():
            np.testing.assert_array_equal(v, b[k])
        jloss, jparams, jstate = jstep(jparams, jstate, jax.tree.map(jnp.asarray, b))
        loss, params, state = train.train_step(mod, cfg, opt, params, state,
                                               train.to_device(b, "cpu"), 0.1)
        assert abs(float(loss) - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss))), step
    for k, v in jparams.items():
        np.testing.assert_allclose(params[k].numpy(), np.asarray(v), rtol=1e-4, atol=1e-5)


def test_train_step_marks_its_parts_and_updates_in_place():
    cfg = dplr_fwfm.make_smoke()
    mod, make_batch = train.build_recsys_trainer("dplr-fwfm", cfg, 32, 0)
    params = mod.init(torch.Generator().manual_seed(0), cfg)
    before = {k: v.clone() for k, v in params.items()}
    opt = optim.adagrad()
    state = opt.init(params)
    seen = []
    loss, out, _ = train.train_step(mod, cfg, opt, params, state,
                                    train.to_device(make_batch(0), "cpu"), 0.1, mark=seen.append)
    assert seen == ["forward", "backward", "update"] and out is params
    assert not loss.requires_grad and torch.isfinite(loss)
    assert not torch.equal(params["embedding"], before["embedding"])


def test_pipeline_determinism_and_resume():
    """As ``tests/test_substrate.py``'s: batches are a pure function of
    (seed, step), and a pipeline started at step 3 serves step 3's batch."""
    data = SyntheticCTR(uniform_layout(3, 2, 50), embed_dim=4, seed=1)
    a = [data.batch(16, s)["ids"] for s in range(5)]
    b = [data.batch(16, s)["ids"] for s in range(5)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    pipe = ShardedPipeline(lambda step: data.batch(16, step)).start(from_step=3)
    got = [pipe.get() for _ in range(2)]
    pipe.stop()
    assert [s for s, _ in got] == [3, 4]
    np.testing.assert_array_equal(got[0][1]["ids"], a[3])
    np.testing.assert_array_equal(got[1][1]["ids"], a[4])
    assert len({host_shard_seed(0, h, 7) for h in range(64)}) == 64


def _planted(m=14, seed=5):
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((3, m))
    R = (U.T * np.array([1.4, -0.8, 0.5])) @ U + 0.02 * rng.standard_normal((m, m))
    R = 0.5 * (R + R.T)
    np.fill_diagonal(R, 0.0)
    return R


def test_posthoc_dplr_matches_jax():
    """The alternating stage (numpy) bitwise the JAX function's; the
    polished fit's Frobenius error within 1e-3 relative of JAX's; the
    error spectrum equal."""
    R = _planted()
    for a, b in zip(dplr.posthoc_dplr(R, 2, polish_steps=0),
                    jdplr.posthoc_dplr(R, 2, polish_steps=0)):
        np.testing.assert_array_equal(a, b)

    def fro(fit):
        U, e, d = fit
        return np.linalg.norm((U.T * e) @ U + np.diag(d) - R), (U.T * e) @ U + np.diag(d)

    got_err, got_approx = fro(dplr.posthoc_dplr(R, 2, polish_steps=200, device="cpu"))
    want_err, want_approx = fro(jdplr.posthoc_dplr(R, 2, polish_steps=200))
    assert abs(got_err - want_err) <= 1e-3 * want_err
    np.testing.assert_array_equal(dplr.posthoc_error_spectrum(R, want_approx),
                                  jdplr.posthoc_error_spectrum(R, want_approx))
    np.testing.assert_allclose(dplr.posthoc_error_spectrum(R, got_approx),
                               jdplr.posthoc_error_spectrum(R, want_approx), rtol=1e-3,
                               atol=1e-3 * want_err)

"""LM training in the port (``model.lm_loss``, the lm branch of
``launch/train.py``, ``configs/{starcoder2_7b,yi_9b}.py``) against the JAX
package's, on the CPU.

Both packages get one set of weights (the JAX ``init``, through
``interop``) and the same numpy tokens.  Bounds, f32 compute:
``lm_loss`` within ``1e-5 * max(1, |loss|)``, each gradient leaf within
``1e-4 *`` its largest ``|g|``; ``forward`` within 2e-4 (the bound of
``test_torch_transformer.py``: the port's forward attends through the
flash-attention kernel's plain version, the JAX package's through
``gqa_attention``).  bf16 compute: the loss within ``3e-2 * max(1,
|loss|)``.  Sizes: ``gemma3_1b.make_smoke()``, ``starcoder2_7b`` and
``yi_9b``'s ``make_smoke()``, and ``test_transformer.py``'s tiny configs
(4 and 5 layers, d 32, vocab 97; q_chunk and loss_chunk 4).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs import REGISTRY as JREGISTRY  # noqa: E402
from repro.launch.train import build_lm_trainer as jbuild  # noqa: E402
from repro.models.transformer import model as jtm  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch.configs.registry import REGISTRY  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.transformer import model as tm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

# tests/test_transformer.py's _tiny, and its decode variant (windows, GeGLU,
# tied embeddings), in both packages' field names
TINY = dict(name="t", n_layers=4, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=97,
            mlp_type="swiglu", layer_pattern=(None,), q_chunk=4, remat=True, loss_chunk=4)
TINY_DECODE = dict(TINY, layer_pattern=(4, None), mlp_type="geglu", tie_embeddings=True,
                   n_layers=5)
SEQ = 16


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _configs(which: str, dtype: str):
    """(JAX config, port config) of one model at one compute dtype."""
    jdt, tdt = DTYPES[dtype]
    if which in ("tiny", "tiny-decode"):
        fields = {"tiny": TINY, "tiny-decode": TINY_DECODE}[which]
        return (jtm.TransformerConfig(**fields, compute_dtype=jdt),
                tm.TransformerConfig(**fields, compute_dtype=tdt))
    jcfg, cfg = JREGISTRY[which].make_smoke(), REGISTRY[which].make_smoke()
    for f in ("remat", "q_chunk", "loss_chunk"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    return (dataclasses.replace(jcfg, compute_dtype=jdt),
            dataclasses.replace(cfg, compute_dtype=tdt))


def _weights(jcfg, seed=0):
    jparams = jtm.init(jax.random.PRNGKey(seed), jcfg)
    return jparams, interop.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _batch(vocab: int, B=2, S=SEQ, seed=1):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _loss(params, cfg, batch):
    return tm.lm_loss(params, cfg, batch, device="cpu")


@pytest.mark.parametrize("which", ["gemma3-1b", "starcoder2-7b", "yi-9b", "tiny",
                                   "tiny-decode"])
def test_lm_loss_and_gradients_match_jax(which):
    jcfg, cfg = _configs(which, "f32")
    jparams, params = _weights(jcfg)
    nb = _batch(cfg.vocab)
    jloss, jgrads = jax.value_and_grad(jtm.lm_loss)(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in nb.items()})
    loss, grads = optim.value_and_grad(_loss)(params, cfg, nb)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss))), \
        (float(loss), float(jloss))
    want = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    got = dict(_flat(grads))
    assert sorted(got) == sorted(want)
    for k, g in want.items():
        err = np.abs(got[k].numpy() - g).max(initial=0.0)
        assert err <= 1e-4 * np.abs(g).max(initial=0.0) + 1e-12, f"d {k}: {err:.3g}"


@pytest.mark.parametrize("which", ["gemma3-1b", "tiny-decode"])
def test_lm_loss_bf16_compute_matches_jax(which):
    jcfg, cfg = _configs(which, "bf16")
    jparams, params = _weights(jcfg)
    nb = _batch(cfg.vocab)
    jloss = float(jtm.lm_loss(jparams, jcfg, {k: jnp.asarray(v) for k, v in nb.items()}))
    loss = float(_loss(params, cfg, nb))
    assert np.isfinite(loss) and abs(loss - jloss) <= 3e-2 * max(1.0, abs(jloss)), (loss, jloss)


def test_remat_and_chunks_change_no_bit():
    """Checkpointing each layer and each loss chunk recomputes the same
    operations: loss and gradients bitwise the unchunked, unrematerialised
    ones."""
    _, cfg = _configs("tiny-decode", "f32")
    _, params = _weights(jtm.TransformerConfig(**TINY_DECODE, compute_dtype=jnp.float32))
    nb = _batch(cfg.vocab)
    loss, grads = optim.value_and_grad(_loss)(params, cfg, nb)
    plain = dataclasses.replace(cfg, remat=False, loss_chunk=SEQ)
    loss_p, grads_p = optim.value_and_grad(_loss)(params, plain, nb)
    assert abs(float(loss) - float(loss_p)) <= 1e-6 * abs(float(loss_p))
    same = dataclasses.replace(cfg, remat=False)
    loss_s, grads_s = optim.value_and_grad(_loss)(params, same, nb)
    assert torch.equal(loss, loss_s)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(_flat(grads), _flat(grads_s)))
    for (_, a), (_, b) in zip(_flat(grads), _flat(grads_p)):
        assert (a - b).abs().max() <= 1e-5 * max(b.abs().max(), 1e-30)


@pytest.mark.parametrize("which", ["starcoder2-7b", "yi-9b"])
def test_dense_lm_configs_forward_and_counts_match_jax(which):
    jcfg, cfg = _configs(which, "f32")
    jparams, params = _weights(jcfg)
    toks = _batch(cfg.vocab)["tokens"]
    want = np.asarray(jtm.forward(jparams, jcfg, jnp.asarray(toks)), np.float32)
    got = tm.forward(params, cfg, toks, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    full, jfull = REGISTRY[which].make_config(), JREGISTRY[which].make_config()
    fields = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "hd",
              "mlp_type", "rope_theta", "layer_pattern", "tie_embeddings", "remat", "q_chunk",
              "loss_chunk")
    assert [getattr(full, f) for f in fields] == [getattr(jfull, f) for f in fields]
    assert full.n_params() == jfull.n_params()
    assert full.n_heads // full.n_kv_heads == {"starcoder2-7b": 9, "yi-9b": 8}[which]
    spec, jspec = REGISTRY[which], JREGISTRY[which]
    assert spec.family == jspec.family == "lm"
    assert [(s.name, s.kind, s.dims, s.skip) for s in spec.shapes] == \
        [(s.name, s.kind, s.dims, s.skip) for s in jspec.shapes]


def test_lm_batches_are_the_jax_trainers():
    cfg = REGISTRY["gemma3-1b"].make_smoke()
    _, make = jbuild("gemma3-1b", JREGISTRY["gemma3-1b"].make_smoke(), 3, 32, 7)
    mod, mine = train.build_lm_trainer("gemma3-1b", cfg, 3, 32, 7, torch.device("cpu"))
    for step in (0, 5):
        want, got = make(step), mine(step)
        assert sorted(want) == sorted(got)
        for k in want:
            assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), k
    # the module's loss is lm_loss on the device it was built for
    params = mod.init(torch.Generator().manual_seed(0), cfg)
    assert torch.isfinite(mod.loss(params, cfg, mine(0)))


def _train(ckpt, *extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
           "--arch", "gemma3-1b", "--steps", "6", "--batch", "2", "--seq", "16",
           "--ckpt-every", "2", "--quiet", "--ckpt-dir", str(ckpt), *extra]
    return subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)


def _npz(ckpt, step):
    return np.load(Path(ckpt) / f"step_{step:08d}" / "arrays.npz")


def test_lm_trainer_resumes_bitwise_and_its_checkpoint_is_the_jax_format(tmp_path):
    """Run A: 6 adamw steps straight.  Run B: hard-exits (rc 42) after step
    3, then resumes from its newest valid checkpoint.  Their step-6
    checkpoints hold the same arrays, bitwise; the JAX package's manager
    restores run A's into the JAX trainer's (params, adamw state) tree."""
    a = _train(tmp_path / "a")
    assert a.returncode == 0, a.stderr
    b = _train(tmp_path / "b", "--fail-at", "3")
    assert b.returncode == 42, b.stderr
    assert "simulated preemption at step 3" in b.stdout
    b = _train(tmp_path / "b", "--resume")
    assert b.returncode == 0 and "resumed from step 2" in b.stdout, b.stdout + b.stderr
    za, zb = _npz(tmp_path / "a", 6), _npz(tmp_path / "b", 6)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    jcfg = JREGISTRY["gemma3-1b"].make_smoke()
    jparams = jtm.init(jax.random.PRNGKey(0), jcfg)
    template = {"params": jparams, "opt": joptim.adamw().init(jparams)}
    restored, step = JManager(str(tmp_path / "a")).restore(template)
    assert step == 6
    leaves = jax.tree_util.tree_flatten_with_path(restored)[0]
    assert len(leaves) == len(za.files)
    for path, leaf in leaves:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path)
        np.testing.assert_array_equal(np.asarray(leaf), za[key], err_msg=key)


def test_lm_trainer_step_runs_in_fixed_order_and_restores_the_mode(monkeypatch):
    """The lm trainer's module, not its caller, puts the step under
    ``train.deterministic()`` (with the cuBLAS workspace torch asks for);
    a recsys step stays out of it, and both restore the mode after."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    cfg = REGISTRY["gemma3-1b"].make_smoke()
    mod, make = train.build_lm_trainer("gemma3-1b", cfg, 2, 8, 0, torch.device("cpu"))
    params = mod.init(torch.Generator().manual_seed(0), cfg)
    opt = optim.adamw()
    state = opt.init(params)
    seen = []

    def mark(_):
        seen.append((torch.are_deterministic_algorithms_enabled(),
                     os.environ.get("CUBLAS_WORKSPACE_CONFIG")))

    was = torch.are_deterministic_algorithms_enabled()
    loss, params, state = train.train_step(
        mod, cfg, opt, params, state, train.to_device(make(0), "cpu"), 0.05, mark=mark)
    inside = (True, train.CUBLAS_WORKSPACE)
    assert seen == [inside, inside, (was, None)] and torch.isfinite(loss)
    assert torch.are_deterministic_algorithms_enabled() == was
    seen.clear()
    rcfg = REGISTRY["dplr-fwfm"].make_smoke()
    rmod, rmake = train.build_recsys_trainer("dplr-fwfm", rcfg, 8, 0)
    rparams = rmod.init(torch.Generator().manual_seed(0), rcfg)
    ropt = optim.adagrad()
    train.train_step(rmod, rcfg, ropt, rparams, ropt.init(rparams),
                     train.to_device(rmake(0), "cpu"), 0.05, mark=mark)
    assert seen == [(was, None)] * 3

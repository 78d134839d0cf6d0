"""The port's checkpoints: atomic save and restore, corrupt and partial
steps, keep-k, the JAX package's format in both directions, and a killed
training run resumed bitwise."""
import glob
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.configs import dplr_fwfm as jconfig  # noqa: E402
from repro.models.recsys import fwfm as jfwfm  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, list_checkpoints  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def test_atomic_save_and_restore_keep_k(tmp_path):
    tree = {"a": torch.arange(5), "b": {"c": torch.ones((2, 3))}}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save({"a": tree["a"] + s, "b": {"c": tree["b"]["c"] + s}}, s, blocking=True)
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [2, 3]
    restored, step = mgr.restore(tree, device="cpu")
    assert step == 3 and mgr.latest_step() == 3 == mgr.latest_step(validate=False)
    assert torch.equal(restored["a"], tree["a"] + 3)
    assert torch.equal(restored["b"]["c"], tree["b"]["c"] + 3)
    assert mgr.restore(tree, step=1, device="cpu") == (None, None)
    assert mgr.last_save["step"] == 3 and mgr.last_save["bytes"] > 0


def test_async_save_keeps_the_values_at_the_save(tmp_path):
    """The device-to-host copy is taken at ``save``: a CPU tensor updated in
    place while the writer runs is written as it was."""
    t = torch.zeros(1 << 16)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"t": t}, 1)
    t.add_(1.0)
    mgr.wait()
    assert float(mgr.restore({"t": None}, device="cpu")[0]["t"].abs().max()) == 0.0


def test_corrupt_checkpoint_skipped(tmp_path):
    tree = {"a": torch.arange(4)}
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(tree, 1, blocking=True)
    mgr.save({"a": tree["a"] + 1}, 2, blocking=True)
    newest = sorted(glob.glob(os.path.join(str(tmp_path), "step_*")))[-1]
    with open(os.path.join(newest, "arrays.npz"), "wb") as f:
        f.write(b"garbage")            # a partial or corrupt write
    restored, step = mgr.restore(tree, device="cpu")
    assert step == 1 and torch.equal(restored["a"], tree["a"])
    assert mgr.latest_step(validate=False) == 2 and mgr.latest_step() == 1
    assert not mgr.step_valid(2) and mgr.step_valid(1)


def test_partial_tmp_dir_garbage_collected(tmp_path):
    os.makedirs(tmp_path / "step_00000005.tmp")
    CheckpointManager(str(tmp_path))
    assert not os.path.exists(tmp_path / "step_00000005.tmp")


def _jax_tree(opt_name):
    cfg = jconfig.make_smoke()
    params = jfwfm.init(jax.random.PRNGKey(0), cfg)
    opt = joptim.adagrad() if opt_name == "adagrad" else joptim.adamw()
    state = opt.init(params)
    # one update, so that every state leaf (adamw's t too) holds a value
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.25), params)
    params, state = opt.update(grads, state, params, 0.1)
    return {"params": params, "opt": state}


def _npz(directory, step):
    return np.load(os.path.join(directory, f"step_{step:08d}", "arrays.npz"))


def _same_npz(a, b):
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("opt_name", ["adagrad", "adamw"])
def test_checkpoints_cross_between_the_packages(tmp_path, opt_name):
    """A JAX checkpoint (params and optimizer state) restored by the port,
    and the port's restored by JAX: keys, shapes, dtypes and values
    bitwise, both on disk and in memory."""
    jtree = _jax_tree(opt_name)
    JManager(str(tmp_path / "jax")).save(jtree, 7, blocking=True)

    host = jax.tree.map(np.asarray, jtree)
    params = params_from_numpy(host["params"], "cpu")
    opt = optim.adagrad() if opt_name == "adagrad" else optim.adamw()
    template = {"params": params, "opt": opt.init(params)}
    restored, step = CheckpointManager(str(tmp_path / "jax")).restore(template, device="cpu")
    assert step == 7
    flat = dict(_flat(restored))
    want = dict(_flat(host))
    assert sorted(flat) == sorted(want)
    for k, v in want.items():
        got = flat[k].numpy()
        assert got.dtype == np.asarray(v).dtype and got.shape == np.shape(v), k
        np.testing.assert_array_equal(got, v, err_msg=k)

    CheckpointManager(str(tmp_path / "port")).save(restored, 7, blocking=True)
    _same_npz(_npz(tmp_path / "port", 7), _npz(tmp_path / "jax", 7))
    back, step = JManager(str(tmp_path / "port")).restore(jtree)
    assert step == 7
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                jax.tree_util.tree_flatten_with_path(jtree)[0]):
        assert pa == pb and np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _train(ckpt, *extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
           "--arch", "dplr-fwfm", "--steps", "20", "--batch", "64", "--lr", "0.1",
           "--ckpt-every", "5", "--quiet", "--ckpt-dir", str(ckpt), *extra]
    return subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)


def test_killed_run_resumes_bitwise(tmp_path):
    """Run A: 20 steps straight.  Run B: hard-exits (rc 42) after step 12,
    then resumes from its newest valid checkpoint.  Their step-20
    checkpoints hold the same arrays, bitwise."""
    a = _train(tmp_path / "a")
    assert a.returncode == 0, a.stderr
    b = _train(tmp_path / "b", "--fail-at", "12")
    assert b.returncode == 42, b.stderr
    assert "simulated preemption at step 12" in b.stdout
    b = _train(tmp_path / "b", "--resume")
    assert b.returncode == 0 and "resumed from step" in b.stdout, b.stderr
    _same_npz(_npz(tmp_path / "a", 20), _npz(tmp_path / "b", 20))


@pytest.mark.parametrize("arch", ["wide-deep", "mind"])
def test_nested_model_checkpoints_cross_between_the_packages(tmp_path, arch):
    """A smoke Wide&Deep (``deep/layer_i/{w,b}``) and a MIND (``b_init``),
    each with its adagrad state after one update: the JAX manager's
    checkpoint restored by the port's, and the port's (from its own
    params and state) by the JAX one's, leaf for leaf, bitwise."""
    from repro.configs import REGISTRY as JREGISTRY
    from repro.models.recsys import mind as jmind
    from repro.models.recsys import wide_deep as jwide_deep
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.launch.train import recsys_module

    jmod = {"wide-deep": jwide_deep, "mind": jmind}[arch]
    jparams = jmod.init(jax.random.PRNGKey(3), JREGISTRY[arch].make_smoke())
    jopt = joptim.adagrad()
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.25), jparams)
    jparams, jstate = jopt.update(grads, jopt.init(jparams), jparams, 0.1)
    jtree = {"params": jparams, "opt": jstate}
    JManager(str(tmp_path / "jax")).save(jtree, 3, blocking=True)

    mod, cfg = recsys_module(arch), REGISTRY[arch].make_smoke()
    params = mod.init(torch.Generator().manual_seed(0), cfg)
    template = {"params": params, "opt": optim.adagrad().init(params)}
    restored, step = CheckpointManager(str(tmp_path / "jax")).restore(template, device="cpu")
    assert step == 3
    want = dict(_flat(jax.tree.map(np.asarray, jtree)))
    got = dict(_flat(restored))
    assert sorted(got) == sorted(want)
    assert {"wide-deep": "params/deep/layer_0/w", "mind": "params/b_init"}[arch] in want
    assert {"wide-deep": "opt/acc/deep/layer_0/w", "mind": "opt/acc/b_init"}[arch] in want
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)

    ours = {"params": params, "opt": template["opt"]}
    CheckpointManager(str(tmp_path / "port")).save(ours, 5, blocking=True)
    back, step = JManager(str(tmp_path / "port")).restore(jtree)
    assert step == 5
    mine = dict(_flat(ours))
    for path, leaf in jax.tree_util.tree_flatten_with_path(back)[0]:
        key = "/".join(p.key for p in path)
        np.testing.assert_array_equal(np.asarray(leaf), mine[key].numpy(), err_msg=key)
    assert len(jax.tree_util.tree_leaves(back)) == len(mine)

"""The LM family on the mesh, on the CPU: the per-position program of
``models.transformer.parallel`` (tensor, vocabulary and expert
parallelism on the model axis, FSDP and data replicas on the data axes,
the sequence-split KV cache) held to the reference's sharded run, to the
port's unsharded cells, and through its collectives.

The reference runs its cells (``repro.launch.steps.build_lm``) on
``jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) *
2)`` in one subprocess with four forced host devices (with the default
axis types its train and prefill cells raise in ``kv_constraint`` under
this container's jax), from the same numpy weights and inputs, at
``make_smoke()`` widths in f32 compute (``dims`` batch 4, or 2 for
serving, and seq 64).  Bounds, port against reference:

  * train: the loss within ``1e-5 max(1, |loss|)``; adamw's moments,
    ``m`` (0.1 of the clipped gradient) and ``v``, within ``1e-5`` and
    ``2e-5`` of each leaf's largest entry; each parameter within what a
    gradient off by that much can move adamw's first step,
    ``lr min(2, 2 d / (|g| + eps))`` (``d``: the ``m`` bound, ``g``:
    the reference's ``m / 0.1``), plus two of its float32 ulps;
  * prefill and decode: the logits within ``1e-5 max(1, max|logits|)``;
    each cache element (bf16) within one bf16 ulp of the reference's
    (``2^-7 max(|a|, |b|)``: the k and v before the cast may differ in
    their last f32 bits) plus ``1e-6`` of the cache's largest entry (an
    entry that cancels to near zero keeps its terms' f32 error); decode's
    cache bitwise but the slot it writes.

The sharded sums add in other orders than the reference's (GSPMD's
partial sums), so nothing here is bitwise but where no sum is involved.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import REGISTRY  # noqa: E402
from repro_torch.launch import cost, steps  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.transformer import model as tm  # noqa: E402
from repro_torch.models.transformer import parallel  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from repro_torch.sharding import collectives, rules  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# (case, arch, config fields replaced): the four LMs, yi-9b with FSDP and two
# microbatches, and mixtral with 3 experts (tensor parallelism inside them at m = 2)
CASES = [("gemma3", "gemma3-1b", {}), ("granite", "granite-moe-1b-a400m", {}),
         ("mixtral", "mixtral-8x7b", {}), ("yi", "yi-9b", {}),
         ("yi_fsdp", "yi-9b", {"fsdp": True, "micro_batches": 2}),
         ("mixtral_tp", "mixtral-8x7b", {"n_experts": 3})]
SHAPES = {"train_4k": {"batch": 4, "seq": 64}, "prefill_32k": {"batch": 2, "seq": 64},
          "decode_32k": {"batch": 2, "seq": 64}}
# decode at batch 1: the cache's sequence over every axis, the tokens replicated
LONG = {"batch": 1, "seq": 64}
LR, INDEX = 1e-3, 40

_REFERENCE = r'''
import dataclasses, json, os, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import REGISTRY
from repro.launch import steps
from repro.launch.dryrun import collective_bytes


def tree(z, pre):
    out = {}
    for k in z.files:
        if k.startswith(pre):
            node, parts = out, k[len(pre):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[k]
    return out


def flat(x, pre, out):
    if isinstance(x, dict):
        for k, v in x.items():
            flat(v, f"{pre}/{k}", out)
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            flat(v, f"{pre}/{i}", out)
    else:
        out[pre] = np.asarray(x, np.float32)


d = sys.argv[1]
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
meta = {}
for key, c in json.load(open(os.path.join(d, "cases.json"))).items():
    arch = REGISTRY[c["arch"]]
    cfg = dataclasses.replace(arch.make_smoke(), compute_dtype=jnp.float32, **c["over"])
    shape = next(s for s in arch.shapes if s.name == c["shape"])
    shape = dataclasses.replace(shape, dims={**shape.dims, **c["dims"]})
    cell = steps.build_lm(arch, shape, mesh, cfg=cfg)
    z = np.load(os.path.join(d, key + ".in.npz"))
    params = tree(z, "params/")
    if c["shape"] == "train_4k":
        opt = {**tree(z, "opt/"), "t": np.int32(0)}
        args = (params, opt, {"tokens": z["tokens"], "labels": z["labels"]}, np.float32(z["lr"]))
    else:
        params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
        args = ((params, z["tokens"]) if c["shape"] == "prefill_32k" else
                (params, z["cache"].astype(jnp.bfloat16), z["tokens"], np.int32(z["index"])))
    fn = cell.jitted()
    hlo = fn.lower(*args).compile().as_text()
    out = {}
    flat(fn(*args), "out", out)
    np.savez(os.path.join(d, key + ".out.npz"), **out)
    meta[key] = {k: v for k, v in collective_bytes(hlo).items() if k != "count"}
json.dump(meta, open(os.path.join(d, "meta.json"), "w"))
print("ok")
'''


def _cfg(arch, over):
    return dataclasses.replace(REGISTRY[arch].make_smoke(), compute_dtype=torch.float32,
                               **over)


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _tree(z, pre, dtype=None):
    out = {}
    for k in z.files:
        if k.startswith(pre):
            node, parts = out, k[len(pre):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            t = torch.from_numpy(np.array(z[k]))
            node[parts[-1]] = t if dtype is None else t.to(dtype)
    return out


def _inputs(arch, over, shape, dims) -> dict:
    """The case's numpy inputs: the port's init from seed 0 (both packages
    take them), adamw's zero moments, tokens from numpy's seed 0, a cache
    of bf16 values."""
    cfg = _cfg(arch, over)
    z = {f"params/{k}": v.numpy() for k, v in _flat(tm.init(torch.Generator().manual_seed(0),
                                                             cfg))}
    rng = np.random.default_rng(0)
    B, S = dims["batch"], dims["seq"]
    if shape == "train_4k":
        for k in [k for k in z if k.startswith("params/")]:
            for m in ("m", "v"):
                z[f"opt/{m}/{k[7:]}"] = np.zeros_like(z[k])
        z["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        z["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        z["lr"] = np.float32(LR)
    elif shape == "prefill_32k":
        z["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    else:
        cache = rng.standard_normal((cfg.n_layers, 2, B, S, cfg.n_kv_heads, cfg.hd))
        z["cache"] = torch.from_numpy(cache).to(torch.bfloat16).float().numpy()
        z["tokens"] = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        z["index"] = np.int32(INDEX)
    return z


def _keys():
    keys = {f"{name}-{shape}": (arch, over, shape, dims) for name, arch, over in CASES
            for shape, dims in SHAPES.items()}
    for name, arch, over in (CASES[0], CASES[2]):
        keys[f"{name}-long"] = (arch, over, "decode_32k", LONG)
    return keys


KEYS = _keys()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's reference outputs and compiled per-device collective
    bytes: one subprocess, four forced host devices."""
    d = tmp_path_factory.mktemp("lm_mesh_reference")
    cases = {}
    for key, (arch, over, shape, dims) in KEYS.items():
        cases[key] = {"arch": arch, "over": over, "shape": shape, "dims": dims}
        np.savez(d / f"{key}.in.npz", **_inputs(arch, over, shape, dims))
    (d / "cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", _REFERENCE, str(d)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert run.returncode == 0 and run.stdout.strip().endswith("ok"), run.stderr[-3000:]
    return d, json.loads((d / "meta.json").read_text())


def _mesh22():
    return Mesh(("data", "model"), (2, 2), ("cpu",) * 4)


def _port(key, mesh=None):
    """The port's cell of a case on ``mesh`` (default (2, 2)) run on the
    case's inputs: its outputs as a dict of tensors like the reference's."""
    arch, over, shape, dims = KEYS[key]
    cfg = _cfg(arch, over)
    cell = steps.build(arch, shape, device="cpu", cfg=cfg, dims=dims,
                       mesh=_mesh22() if mesh is None else mesh)
    z = _Npz(_inputs(arch, over, shape, dims))
    if shape == "train_4k":
        params, opt = _tree(z, "params/"), _tree(z, "opt/")
        opt["t"] = torch.zeros((), dtype=torch.int32)
        batch = {k: torch.from_numpy(z[k]) for k in ("tokens", "labels")}
        loss, params, opt = cell.fn(params, opt, batch, torch.tensor(LR))
        return cfg, {"loss": loss, "params": params, "opt": opt}
    params = _tree(z, "params/", torch.bfloat16)
    if shape == "prefill_32k":
        logits, cache = cell.fn(params, torch.from_numpy(z["tokens"]))
        return cfg, {"logits": logits, "cache": cache}
    cache = torch.from_numpy(z["cache"]).to(torch.bfloat16)
    logits, cache = cell.fn(params, cache, torch.from_numpy(z["tokens"]),
                            torch.tensor(INDEX, dtype=torch.int32))
    return cfg, {"logits": logits, "cache": cache}


class _Npz(dict):
    @property
    def files(self):
        return list(self)


def _ref(reference, key):
    return np.load(reference[0] / f"{key}.out.npz")


def _bf16_ulp_ok(got, want) -> float:
    """Largest ``|got - want|`` over one bf16 ulp of the larger plus 1e-6 of
    the largest entry (an entry that cancels to near zero carries the f32
    error of its terms' sum)."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    bound = 2.0**-7 * np.maximum(np.abs(got), np.abs(want)) + 1e-6 * float(np.abs(want).max())
    return float((diff / bound).max()) if diff.any() else 0.0


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_train_step_matches_the_reference_sharded_run(reference, name):
    """The (2, 2) train step's loss, moments and parameters against the
    reference's Auto-axis (2, 2) step (module docstring's bounds)."""
    key = f"{name}-train_4k"
    cfg, got = _port(key)
    want = _ref(reference, key)
    ref_loss = float(want["out/0"])
    assert abs(float(got["loss"]) - ref_loss) <= 1e-5 * max(1.0, abs(ref_loss))
    assert int(got["opt"]["t"]) == 1 and int(want["out/2/t"]) == 1
    _assert_step_close(got["params"], got["opt"], lambda path: want[f"out/1/{path}"],
                       lambda path: want[f"out/2/m/{path}"], lambda path: want[f"out/2/v/{path}"])


def _at(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _assert_step_close(params, opt, ref_p, ref_m, ref_v):
    """One adamw step's moments and parameters against another's, each
    ``ref_*`` a leaf's path to its numpy array (module docstring's train
    bounds): ``m`` is 0.1 of the clipped gradient, so its bound holds each
    leaf's gradient to 1e-4 of the leaf's largest entry."""
    for path, p in _flat(params):
        m_ref, v_ref = ref_m(path), ref_v(path)
        m, v = _at(opt["m"], path), _at(opt["v"], path)
        d = 1e-5 * float(np.abs(m_ref).max())
        assert np.abs(m.numpy() - m_ref).max() <= d, path
        assert np.abs(v.numpy() - v_ref).max() <= 2e-5 * float(np.abs(v_ref).max()), path
        g = np.abs(m_ref) / 0.1
        p_ref = ref_p(path)
        tol = LR * np.minimum(2.0, 2 * (d / 0.1) / (g + 1e-8)) + 2 * np.spacing(
            np.abs(p_ref).astype(np.float32))
        assert (np.abs(p.numpy() - p_ref) <= tol).all(), path


@pytest.mark.parametrize("name", [c[0] for c in CASES])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_serving_cells_match_the_reference_sharded_run(reference, name, shape):
    """(2, 2) prefill and decode: the logits (each position's vocabulary
    columns, each replica's rows, joined) and the cache (the prefill's
    born in the layout, by an all-to-all; the decode step's slot written
    by its owner) against the reference's."""
    key = f"{name}-{shape}"
    cfg, got = _port(key)
    want = _ref(reference, key)
    V = cfg.vocab
    ref_logits = want["out/0"][..., :V]
    assert got["logits"].shape == (KEYS[key][3]["batch"], 1, cfg.vocab_padded)
    assert np.abs(got["logits"][..., :V].float().numpy() - ref_logits).max() <= \
        1e-5 * max(1.0, float(np.abs(ref_logits).max()))
    assert _bf16_ulp_ok(got["cache"], want["out/1"]) <= 1.0
    if shape == "decode_32k":
        other = np.ones(got["cache"].shape[3], bool)
        other[INDEX] = False
        assert np.array_equal(got["cache"].float().numpy()[:, :, :, other],
                              want["out/1"][:, :, :, other])


@pytest.mark.parametrize("name", ["gemma3", "mixtral"])
def test_decode_at_batch_one_splits_the_sequence_over_every_axis(reference, name):
    """Batch 1 on (2, 2) (``long_500k``'s layout): the tokens replicate,
    the cache's sequence splits over all four positions, the split-K
    combine runs over every axis, and the slot's owner writes it."""
    key = f"{name}-long"
    arch, over, shape, dims = KEYS[key]
    assert rules.lm_cache_spec(_mesh22(), 1) == (None, None, None, ("data", "model"), None,
                                                 None)
    cfg, got = _port(key)
    want = _ref(reference, key)
    V = cfg.vocab
    assert np.abs(got["logits"][..., :V].float().numpy() - want["out/0"][..., :V]).max() <= \
        1e-5 * max(1.0, float(np.abs(want["out/0"][..., :V]).max()))
    assert _bf16_ulp_ok(got["cache"], want["out/1"]) <= 1.0


def test_collective_bytes_beside_the_reference_compiled_program(reference, capsys):
    """The port's counted per-device collective bytes of each (2, 2) smoke
    cell, printed beside the reference's compiled HLO's (``dryrun``'s
    ``collective_bytes``): not a gate, GSPMD's choices are not the
    port's plan (it all-gathers a decode's cache where the port moves
    split-K partial sums)."""
    rows = []
    meta = Mesh(("data", "model"), (2, 2), ("meta",) * 4)
    for key, (arch, over, shape, dims) in KEYS.items():
        cell = steps.build(arch, shape, device="meta", cfg=_cfg(arch, over), dims=dims,
                           mesh=meta)
        got = cost.analyze(cell.fn, *cell.args, mesh=meta, specs=cell.arg_specs())
        mine = {k: v["total_bytes"] for k, v in got["collective_bytes"].items()}
        theirs = reference[1][key]
        assert got["n_devices"] == 4 and sum(mine.values()) > 0
        rows.append(f"{key:22s} port " + " ".join(f"{k}={mine[k]}" for k in mine)
                    + " | reference " + " ".join(f"{k}={int(theirs[k])}" for k in mine))
    with capsys.disabled():
        print("\nper-device collective bytes, (2, 2) smoke cells:\n" + "\n".join(rows))


# -- the port against itself ------------------------------------------------------

def _cells_equal(a, b):
    ta, tb = (tree_leaves(x) if isinstance(x, dict) else [x] for x in (a, b))
    return all(torch.equal(x, y) for x, y in zip(ta, tb))


@pytest.mark.parametrize("shape,dims", list(SHAPES.items()))
def test_one_position_meshes_are_bitwise_the_unsharded_cells(shape, dims):
    """``mesh=None`` and a (1, 1) mesh build today's one-device cell,
    bitwise (gemma3-1b and granite's smoke configs)."""
    for arch in ("gemma3-1b", "granite-moe-1b-a400m"):
        cfg = _cfg(arch, {})
        outs = []
        for mesh in (None, Mesh(("data", "model"), (1, 1), ("cpu",))):
            cell = steps.build(arch, shape, device="cpu", cfg=cfg, dims=dims, mesh=mesh)
            assert cell.plan is None
            outs.append(cell.fn(*cell.args))
        for a, b in zip(*outs):
            assert _cells_equal(a, b), (arch, shape)


@pytest.mark.parametrize("arch", ["gemma3-1b", "granite-moe-1b-a400m", "mixtral-8x7b"])
def test_model_axis_alone_runs_the_plan(arch):
    """A (1, 4) cell runs the per-position plan, never one device's
    program: its count shows collectives and a position's blocks; its
    step (loss, moments, so the gradients, and parameters) and calls
    agree with the unsharded cells (f32 compute, the bounds against the
    reference).  On (1, 8) gemma3-1b's 4 heads do not split: the query
    rows do, and prefill attends through kernel 7's plain version at each
    position's row offset."""
    cfg = _cfg(arch, {})
    for sizes in ((1, 4), (1, 8)) if arch == "gemma3-1b" else ((1, 4),):
        m = Mesh(("data", "model"), sizes, ("cpu",) * sizes[1])
        meta = Mesh(("data", "model"), sizes, ("meta",) * sizes[1])
        plan = parallel.Plan(cfg, m, "cpu")
        assert plan.heads == (cfg.n_heads % sizes[1] == 0)
        for shape, dims in SHAPES.items():
            counted = steps.build(arch, shape, device="meta", cfg=cfg, dims=dims, mesh=meta)
            got = cost.analyze(counted.fn, *counted.args, mesh=meta, specs=counted.arg_specs())
            assert got["collective_bytes"]["all-reduce"]["count"] > 0
            assert got["arg_bytes"] < cost.analyze(counted.fn, *counted.args)["arg_bytes"]
            a = steps.build(arch, shape, device="cpu", cfg=cfg, dims=dims, mesh=m)
            b = steps.build(arch, shape, device="cpu", cfg=cfg, dims=dims)
            if shape == "train_4k":
                (la, pa, oa), (lb, pb, ob) = a.fn(*a.args), b.fn(*b.args)
                assert abs(float(la) - float(lb)) <= 1e-5 * max(1.0, abs(float(lb)))
                assert int(oa["t"]) == int(ob["t"]) == 1
                _assert_step_close(pa, oa, lambda path: _at(pb, path).numpy(),
                                   lambda path: _at(ob["m"], path).numpy(),
                                   lambda path: _at(ob["v"], path).numpy())
                continue
            if shape == "decode_32k":
                cache = torch.randn(a.args[1].shape, generator=torch.Generator().manual_seed(3))
                ca, cb = (cache.to(torch.bfloat16) for _ in range(2))
                (ga, ca), (gb, cb) = (c.fn(c.args[0], cc, c.args[2], torch.tensor(INDEX))
                                      for c, cc in ((a, ca), (b, cb)))
            else:
                (ga, ca), (gb, cb) = a.fn(*a.args), b.fn(*b.args)
            V = cfg.vocab
            assert float((ga[..., :V] - gb[..., :V]).abs().max()) <= \
                1e-5 * max(1.0, float(gb[..., :V].abs().max()))
            assert _bf16_ulp_ok(ca, cb.float().numpy()) <= 1.0


def test_every_lm_cell_builds_on_every_mesh_and_pna_still_waits():
    """``steps.build`` builds every LM cell on (2, 2), (1, D) and both
    production meshes (on ``meta``) without naming ROADMAP 3c-ii; PNA on a
    mesh with data replicas raises naming 3c-iii."""
    from repro_torch.launch.mesh import make_production_mesh
    meshes = [Mesh(("data", "model"), (2, 2), ("meta",) * 4),
              Mesh(("data", "model"), (1, 16), ("meta",) * 16),
              make_production_mesh(device="meta"), make_production_mesh(multi_pod=True,
                                                                        device="meta")]
    n = 0
    for arch, shape, _ in steps.all_cells():
        if REGISTRY[arch].family != "lm":
            continue
        for mesh in meshes:
            cell = steps.build(arch, shape, device="meta", mesh=mesh)
            assert cell.plan is not None and cell.arg_specs() is not None
            assert not any(re.search(r"3c-ii(?!i)", note) for note in cell.notes)
            n += 1
    assert n == 17 * len(meshes)
    with pytest.raises(NotImplementedError, match="ROADMAP item 3c-iii"):
        steps.build("pna", "molecule", mesh=meshes[2])


# -- collectives ----------------------------------------------------------------------

class _Count:
    """A stand-in counter: each collective's (kind, position, bytes)."""

    def __init__(self):
        self.seen = []

    def add_collective(self, kind, position, nbytes):
        self.seen.append((kind, position, nbytes))

    def hold(self, *args):
        pass

    def add_kernel(self, *args):
        pass


def _counting(fn):
    from repro_torch.kernels import work
    counter = _Count()
    work.COUNTERS.append(counter)
    try:
        out = fn()
    finally:
        work.COUNTERS.pop()
    return out, counter.seen


def test_autograd_collectives_report_their_backward_and_repeat_bitwise():
    """Megatron's f and g, the gather and the all-to-all: forward values,
    the conjugate backward (g hands each input its own output's
    cotangent, f each the sum of theirs, so each x's gradient is its w plus
    one shared sum), each backward reported with its kind and each
    position's bytes, two runs bitwise."""
    pos = [(0, 0), (0, 1)]

    def run():
        gen = torch.Generator().manual_seed(0)
        xs = [torch.randn(3, 4, generator=gen).requires_grad_() for _ in pos]
        w = [torch.randn(3, 4, generator=gen) for _ in pos]
        y = collectives.reduce_to_all(xs, pos)                    # g: sum; backward identity
        z = collectives.copy_to_all(y, pos)                       # f: identity; backward sum
        a = collectives.all_to_all(z, pos, split_dim=0, cat_dim=1, sizes=(1, 2))
        b = collectives.gather(z, pos, dim=1, need=[(0, 5), (3, 8)])
        loss = sum((t * t).sum() for t in a + b) + sum((t * u).sum() for t, u in zip(y, w))
        return xs, w, y, z, a, b, torch.autograd.grad(loss, xs)

    (xs, w, y, z, a, b, grads), seen = _counting(run)
    assert torch.equal(y[0], xs[0] + xs[1]) and torch.equal(y[0], y[1])
    assert y[0].data_ptr() != y[1].data_ptr()                 # a distinct copy a position
    assert a[0].shape == (1, 8) and a[1].shape == (2, 8)
    assert torch.equal(a[0], torch.cat([z[0][:1], z[1][:1]], 1))
    whole = torch.cat(z, 1)
    assert torch.equal(b[0], whole[:, :5]) and torch.equal(b[1], whole[:, 3:])
    assert torch.allclose(grads[0] - w[0], grads[1] - w[1], rtol=0, atol=1e-5)
    by_kind = {}
    for kind, p, n in seen:
        by_kind.setdefault(kind, []).append((p, n))
    # forward: g, the all-to-all, the gather; backward: the gather's
    # reduce-scatter, the all-to-all back, f's all-reduce
    assert by_kind["all-reduce"] == [((0, 0), 48), ((0, 1), 48)] * 2
    assert by_kind["all-gather"] == [((0, 0), 3 * 5 * 4), ((0, 1), 3 * 5 * 4)]
    assert by_kind["reduce-scatter"] == [((0, 0), 48), ((0, 1), 48)]
    assert by_kind["all-to-all"] == [((0, 0), 1 * 8 * 4), ((0, 1), 2 * 8 * 4),
                                     ((0, 0), 48), ((0, 1), 48)]
    again = run()[-1]
    assert all(torch.equal(p, q) for p, q in zip(grads, again))


def test_meta_collectives_give_shapes_and_report_alike():
    """On ``meta`` the collectives make outputs of the right shapes and
    report the bytes they report on the CPU."""
    pos = [(0, 0), (0, 1), (0, 2)]
    for dev in ("cpu", "meta"):
        xs = [torch.ones(6, 3, device=dev) for _ in pos]
        (outs, seen) = _counting(lambda: (
            collectives.all_to_all(xs, pos, split_dim=0, cat_dim=1),
            collectives.gather(xs, pos, dim=1, need=[(0, 3), (2, 5), (0, 9)]),
            collectives.reduce_to_all(xs, pos)))
        assert [t.shape for t in outs[0]] == [(2, 9)] * 3
        assert [t.shape for t in outs[1]] == [(6, 3), (6, 3), (6, 9)]
        if dev == "cpu":
            cpu_seen = seen
        else:
            assert seen == cpu_seen

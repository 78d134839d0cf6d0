"""The mesh's data axis for the recsys family, on the CPU: the one-process
mesh over every position (``launch.mesh``), its collectives
(``sharding.collectives``), the partition rules' local blocks, the
row-blocked lookup on one replica's model axis (``embedding.sharded``),
the data-parallel step (``launch.train.data_parallel_step``), the cells on a
mesh with data replicas (``launch.steps``), the per-position count
(``launch.cost.analyze(mesh=)``) and the production-mesh dry run on
``meta`` (``launch.dryrun --mesh``).

A (2, 2) mesh is ``Mesh(("data", "model"), (2, 2), ("cpu",) * 4)``, the
counterpart of ``jax.make_mesh`` in the reference's tests.  The
reference cannot build its recsys cells on a forced (2, 2) mesh under
this container's jax (``ShardingTypeError`` on the bag's scatter), so
the port's (2, 2) step is held to the port's unsharded step and to the
reference's step on its one-device host mesh (``tests/conftest.py``'s),
from the same numpy weights.  Bounds: the losses within ``1e-5 * max(1,
|loss|)``, each gradient and updated leaf within ``1e-5 * max(1,
max|leaf|)`` (``test_torch_models.py``'s bounds: the replicas' partial
sums add in another order); the pointwise and rank cells bitwise the
unsharded port (each row's arithmetic is its own on the CPU: the
lookups' fixed-order sums, ``torch.matmul`` row by row at these sizes),
and the (1, D) step bitwise the step before the data axis.  The
per-device figures of ``dplr-fwfm/train_batch`` on the production meshes
are derived here from the rules and the shapes.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import REGISTRY as JREGISTRY  # noqa: E402
from repro.embedding.sharded import make_sharded_take as jmake_sharded_take  # noqa: E402
from repro.launch.train import build_recsys_trainer as jbuild  # noqa: E402
from repro.models.recsys import autoint as jautoint  # noqa: E402
from repro.models.recsys import bst as jbst  # noqa: E402
from repro.models.recsys import fwfm as jfwfm  # noqa: E402
from repro.models.recsys import mind as jmind  # noqa: E402
from repro.models.recsys import wide_deep as jwide_deep  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs.registry import REGISTRY  # noqa: E402
from repro_torch.embedding import bag, sharded  # noqa: E402
from repro_torch.embedding.bag import padded_rows  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import cost, dryrun, steps, train  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from repro_torch.sharding import collectives, rules  # noqa: E402

JMODULES = {"dplr-fwfm": jfwfm, "wide-deep": jwide_deep, "autoint": jautoint, "bst": jbst,
            "mind": jmind}
ARCHS = list(JMODULES)
B = 2048          # the smallest batch auto_leaf_spec splits over two replicas (min_shard 1024)


def _mesh22(dev="cpu"):
    return Mesh(("data", "model"), (2, 2), (dev,) * 4)


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _np(x):
    return np.asarray(x.detach() if hasattr(x, "detach") else x, np.float64)


def _close(got, want, what, tol=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * max(1.0, np.abs(want).max(initial=0.0)), f"{what}: {err:.3g}"


def _same_tree(a, b):
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(_flat(a), _flat(b)))


# -- the mesh ---------------------------------------------------------------------------

def test_a_mesh_holds_a_device_for_every_position():
    m = _mesh22()
    assert m.size == 4 and m.dp == 2 and m.devices == (torch.device("cpu"),) * 2
    assert m.positions() == ((0, 0), (0, 1), (1, 0), (1, 1)) and m.coords(2) == (1, 0)
    assert m.replica(1).positions() == ((1, 0), (1, 1)) and m.replica(1).shape == {
        "data": 1, "model": 2}
    assert m.groups("model") == [[(0, 0), (0, 1)], [(1, 0), (1, 1)]]
    assert m.groups(("pod", "data")) == [[(0, 0), (1, 0)], [(0, 1), (1, 1)]]
    three = Mesh(("pod", "data", "model"), (2, 2, 2), ["cpu"] * 8)
    assert three.dp == 4 and three.replica(3).positions() == ((1, 1, 0), (1, 1, 1))
    assert three.groups(rules.dp_axes(three))[1] == [(0, 0, 1), (0, 1, 1), (1, 0, 1),
                                                     (1, 1, 1)]
    with pytest.raises(ValueError, match="3 devices for 4 positions"):
        Mesh(("data", "model"), (2, 2), ["cpu"] * 3)
    host = make_host_mesh(4, device="cpu")
    assert host.shape == {"data": 1, "model": 4} and host.dp == 1 and host.size == 4


@pytest.mark.parametrize("multi_pod,n", [(False, 256), (True, 512)])
def test_production_meshes_on_meta(multi_pod, n):
    m = make_production_mesh(multi_pod=multi_pod, device="meta")
    assert m.size == n and m.shape["model"] == 16 and m.dp == n // 16
    assert all(d.type == "meta" for d in m.grid) and len(m.positions()) == n
    with pytest.raises(ValueError, match=f"needs {n} cpu devices; 1 visible"):
        make_production_mesh(multi_pod=multi_pod, device="cpu")


# -- the rules ----------------------------------------------------------------------------

class _Stand:
    """A mesh as the reference's rules read it (axis names, sizes)."""

    def __init__(self, names, sizes):
        self.axis_names, self.shape = names, dict(zip(names, sizes))


@pytest.mark.parametrize("names,sizes", [(("data", "model"), (16, 16)),
                                         (("pod", "data", "model"), (2, 16, 16))])
def test_recsys_rules_on_two_and_three_axes(names, sizes):
    """``dp_axes``, ``recsys_param_specs`` and ``opt_state_specs`` are the
    reference's on both production meshes."""
    mesh, jmesh = Mesh(names, sizes, ["meta"] * math.prod(sizes)), _Stand(names, sizes)
    assert rules.dp_axes(mesh) == jrules.dp_axes(jmesh)
    cfg = REGISTRY["wide-deep"].make_smoke()
    params = train.recsys_module("wide-deep").init(torch.Generator().manual_seed(0), cfg,
                                                   device="meta")
    got = rules.recsys_param_specs(params, mesh)
    jparams = jwide_deep.init(jax.random.PRNGKey(0), JREGISTRY["wide-deep"].make_smoke())
    want = jrules.recsys_param_specs(jparams, jmesh)
    assert dict(_flat(got)) == {k: tuple(v) for k, v in _flat(want)}
    opt = optim.adagrad().init(params)
    assert rules.opt_state_specs(got, opt) == {"acc": got}


def test_local_blocks_follow_the_rules():
    mesh = Mesh(("pod", "data", "model"), (2, 2, 2), ["cpu"] * 8)
    t = torch.arange(8 * 6).reshape(8, 6)
    spec = (("pod", "data"), "model")
    assert rules.local_shape((8, 6), spec, mesh) == (2, 3)
    assert torch.equal(rules.local_block(t, spec, mesh, (1, 0, 1)), t[4:6, 3:6])
    assert torch.equal(rules.local_block(t, (None, None), mesh, (1, 1, 1)), t)
    assert rules.local_bytes({"a": t, "b": {"c": t[:, 0]}},
                             {"a": spec, "b": {"c": ("model",)}}, mesh) == 2 * 3 * 8 + 4 * 8
    with pytest.raises(ValueError, match="does not split"):
        rules.local_shape((7, 6), spec, mesh)


# -- the collectives ----------------------------------------------------------------------

def _counted(fn, mesh):
    out = {}
    got = cost.analyze(lambda: out.setdefault("v", fn()), mesh=mesh)
    return out["v"], got


def test_collectives_add_in_position_order_and_report_each_positions_bytes(rng):
    mesh = Mesh(("data", "model"), (4, 1), ["cpu"] * 4)
    group = [c for c in mesh.positions()]
    xs = [torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32)) for _ in group]
    outs, counted = _counted(lambda: collectives.all_reduce(xs, group), mesh)
    want = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    assert all(torch.equal(o, want) for o in outs)
    assert torch.equal(collectives.all_reduce(xs, group, "mean")[0], want / 4)
    assert counted["collective_bytes"]["all-reduce"] == {"count": 1, "total_bytes": 96}
    again = collectives.all_reduce([x.clone() for x in xs], group)
    assert torch.equal(again[0], outs[0])                        # bitwise repeatable
    out = torch.empty(8, 3)
    collectives.all_reduce(xs, group, out=out)
    assert torch.equal(out, want)
    gathered, counted = _counted(lambda: collectives.all_gather(xs, group), mesh)
    assert torch.equal(gathered[3], torch.cat(xs)) and \
        counted["collective_bytes"]["all-gather"]["total_bytes"] == 4 * 96
    scattered, counted = _counted(lambda: collectives.reduce_scatter(xs, group), mesh)
    assert torch.equal(scattered[1], want[2:4]) and \
        counted["collective_bytes"]["reduce-scatter"]["total_bytes"] == 24
    sent, counted = _counted(lambda: collectives.broadcast(xs[0], group, mesh.grid), mesh)
    assert all(s is xs[0] for s in sent)
    # the source receives nothing; each other position the tensor
    assert counted["collective_bytes"]["collective-permute"]["count"] == 0
    assert counted["sum"]["collective_bytes"] == 3 * 96
    assert collectives.all_reduce(xs[:1], group[:1]) == xs[:1]      # a group of one: no move
    with pytest.raises(ValueError, match="unknown collective kind"):
        collectives.report("psum", group, 4)


def test_compressed_psum_reports_int8_data_and_its_scale(rng):
    mesh = Mesh(("data", "model"), (2, 1), ["cpu"] * 2)
    xs = [torch.from_numpy(rng.standard_normal(100).astype(np.float32)) for _ in range(2)]
    errs = [torch.zeros(100) for _ in range(2)]
    (outs, _), counted = _counted(
        lambda: compression.compressed_psum(xs, errs, positions=mesh.positions()), mesh)
    assert torch.equal(outs[0], compression.compressed_psum(xs, errs)[0][0])
    assert counted["collective_bytes"]["all-reduce"] == {"count": 2, "total_bytes": 100 + 4}


# -- the lookup on one replica's model axis ----------------------------------------------

@pytest.mark.parametrize("mesh", [_mesh22(), Mesh(("pod", "data", "model"), (2, 2, 2),
                                                  ["cpu"] * 8)], ids=["2x2", "2x2x2"])
def test_the_lookup_runs_on_one_replicas_model_axis(mesh, rng):
    """On each replica's model axis the lookup is bitwise ``gather_rows``
    and the field bags bitwise the unsharded ones; the whole mesh, or a
    rule that splits the ids over its data axes, is refused: the data
    split belongs to the step (``train.data_parallel_step``)."""
    table = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 64, (8, 5)))
    layout = REGISTRY["dplr-fwfm"].make_smoke().layout
    arena = torch.from_numpy(rng.standard_normal((padded_rows(layout.total_vocab), 4))
                             .astype(np.float32))
    fids = torch.from_numpy(np.stack([rng.integers(0, f.vocab_size, 8) for f in layout.fields],
                                     1).astype(np.int32))
    w = torch.ones(fids.shape)
    for r in range(mesh.dp):
        sub = mesh.replica(r)
        assert torch.equal(sharded.make_sharded_take(sub, {2: (rules.dp_axes(mesh), None)})(
            table, ids), bag.gather_rows(table, ids))
        got = sharded.sharded_lookup_field_embeddings(arena, layout, fids, w, mesh=sub,
                                                      data_axes=rules.dp_axes(mesh))
        assert torch.equal(got, bag.lookup_field_embeddings(arena, layout, fids, w))
    with pytest.raises(ValueError, match="one data replica"):
        sharded.make_sharded_take(mesh)(table, ids)
    with pytest.raises(ValueError, match="one data replica"):
        sharded.make_sharded_take(mesh, {2: (rules.dp_axes(mesh), None)})(table, ids)
    with pytest.raises(ValueError, match="one data replica"):
        sharded.sharded_lookup_field_embeddings(arena, layout, fids, w, mesh=mesh,
                                                data_axes=rules.dp_axes(mesh))


def test_one_replica_is_bitwise_the_single_replica_lookup(rng):
    """A replica of (2, 2), its positions keeping their coordinates, is
    today's (1, D) lookup, bitwise: values and gradients."""
    table = torch.from_numpy(rng.standard_normal((64, 4)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 64, (6, 3)))
    g = torch.from_numpy(rng.standard_normal((6, 3, 4)).astype(np.float32))
    grads = []
    for mesh in (make_host_mesh(2, device="cpu"), _mesh22().replica(1)):
        tg = table.clone().requires_grad_()
        (sharded.make_sharded_take(mesh, {2: (None, None)})(tg, ids) * g).sum().backward()
        grads.append(tg.grad)
    assert torch.equal(grads[0], grads[1])


# -- the data-parallel step against the unsharded ones -----------------------------------

def _setup(arch):
    jcfg, cfg = JREGISTRY[arch].make_smoke(), REGISTRY[arch].make_smoke()
    jparams = JMODULES[arch].init(jax.random.PRNGKey(0), jcfg)
    arrays = jax.tree.map(np.asarray, jparams)
    _, jmake = jbuild(arch, jcfg, B, 0)
    batch = jmake(0)
    return jcfg, cfg, jparams, arrays, batch


def _tbatch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_two_by_two_matches_the_unsharded_steps(arch):
    """Loss, every gradient leaf and every updated leaf of one adagrad step
    on (2, 2) against the port's unsharded step and the reference's step on
    its one-device host mesh, from the same numpy weights and batch."""
    jcfg, cfg, jparams, arrays, batch = _setup(arch)
    mod, jmod = train.recsys_module(arch), JMODULES[arch]
    tb = _tbatch(batch)
    mesh = _mesh22()
    specs = steps.auto_batch_specs(tb, mesh)
    assert all(spec[0] == "data" for spec in specs.values())       # every leaf splits
    loss, grads, ran = train.data_parallel_grads(mod, cfg, params_from_numpy(arrays, "cpu"),
                                                 tb, mesh=mesh, batch_specs=specs)
    assert ran == 2
    ploss, pgrads = optim.value_and_grad(mod.loss)(params_from_numpy(arrays, "cpu"), cfg, tb)
    jtake = jmake_sharded_take(jax.make_mesh((1, 1), ("data", "model")),
                               {1: P(None), 2: P(None, None), 3: P(None, None, None)})
    jb = jax.tree.map(jnp.asarray, batch)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmod.loss(p, jcfg, b, take_fn=jtake)))(jparams, jb)
    _close(loss, ploss, f"{arch} loss against the port")
    _close(loss, jloss, f"{arch} loss against the reference")
    jflat = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    for k, g in _flat(grads):
        _close(g, dict(_flat(pgrads))[k], f"{arch} d{k} against the port")
        _close(g, jflat[k], f"{arch} d{k} against the reference")
    lr = torch.tensor(0.05)
    params, state = params_from_numpy(arrays, "cpu"), None
    state = optim.adagrad().init(params)
    loss2, params, state = train.data_parallel_step(mod, cfg, optim.adagrad(), params, state,
                                                    tb, lr, mesh=mesh, batch_specs=specs)
    assert torch.equal(loss2, loss)
    jopt = joptim.adagrad()
    jnew, jstate = jopt.update(jgrads, jopt.init(jparams), jparams, jnp.float32(0.05))
    punsharded = params_from_numpy(arrays, "cpu")
    pnew, _ = optim.adagrad().update(pgrads, optim.adagrad().init(punsharded), punsharded, lr)
    for k, v in _flat(jax.tree.map(np.asarray, jnew)):
        _close(dict(_flat(params))[k], v, f"{arch} updated {k} against the reference")
        _close(dict(_flat(params))[k], dict(_flat(pnew))[k], f"{arch} updated {k}")
    for k, v in _flat(jax.tree.map(np.asarray, jstate["acc"])):
        _close(dict(_flat(state["acc"]))[k], v, f"{arch} accumulator {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_one_replica_step_is_bitwise_the_step_before_the_data_axis(arch):
    """Two steps of the (1, 4) cell (``data_parallel_step``) bitwise
    ``train.train_step`` with ``make_auto_take``, as the cell ran before the
    data axis: losses, parameters, accumulator."""
    cfg = REGISTRY[arch].make_smoke()
    mesh = make_host_mesh(4, device="cpu")
    ours, theirs = (steps.build(arch, "train_batch", device="cpu", cfg=cfg,
                                dims={"batch": 64}, mesh=mesh) for _ in range(2))
    mod = train.recsys_module(arch)
    take_mod = type("M", (), {"loss": staticmethod(
        lambda p, c, b: mod.loss(p, c, b, take_fn=steps.make_auto_take(mesh)))})
    mine, other = list(ours.args[:2]), list(theirs.args[:2])
    for _ in range(2):
        loss, *mine = ours.fn(*mine, ours.args[2], ours.args[3])
        want, *other = train.train_step(take_mod, cfg, optim.adagrad(), *other, theirs.args[2],
                                        theirs.args[3])
        assert torch.equal(loss, want)
        assert _same_tree(mine[0], other[0]) and _same_tree(mine[1], other[1])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape,dims", [("serve_bulk", {"batch": B}),
                                        ("serve_p99", None),
                                        ("retrieval_cand", {"n_items": 4096})])
def test_pointwise_and_rank_cells_on_two_by_two_are_the_unsharded_cells(arch, shape, dims):
    """Each replica scores its rows (or its items): bitwise the unsharded
    cell on the CPU.  ``serve_p99``'s 512 items stay whole (512 <
    ``min_shard``), so the first replica scores them for all."""
    cfg = REGISTRY[arch].make_smoke()
    cells = [steps.build(arch, shape, device="cpu", cfg=cfg, dims=dims, mesh=m)
             for m in (_mesh22(), None)]
    with torch.no_grad():
        got, want = (c.fn(*c.args) for c in cells)
    assert torch.equal(got, want)
    split = shape != "serve_p99"
    assert any(e is not None for spec in cells[0].specs["batch"].values() for e in spec) == split


def test_every_replica_runs_on_a_real_device_and_the_first_on_meta(monkeypatch):
    """On the CPU both replicas run (their rows' kernel calls); on ``meta``
    the first runs for both (``collectives.mirror``), and the counts of
    the busiest position and the sums over the mesh equal a count that
    runs both (once the layout's maps are made)."""
    cfg = REGISTRY["dplr-fwfm"].make_smoke()
    mesh = _mesh22("meta")
    cell = steps.build("dplr-fwfm", "train_batch", cfg=cfg, dims={"batch": B}, mesh=mesh)
    assert train._mirrored(cell.args[2]) and not train._mirrored({"x": torch.zeros(1)})
    cost.analyze(cell.fn, *cell.args, mesh=mesh, specs=cell.arg_specs())     # warm
    ran = {True: cost.analyze(cell.fn, *cell.args, mesh=mesh, specs=cell.arg_specs())}
    monkeypatch.setattr(train, "_mirrored", lambda inputs: False)
    ran[False] = cost.analyze(cell.fn, *cell.args, mesh=mesh, specs=cell.arg_specs())
    assert ran[True]["positions_counted"] == 2 and ran[False]["positions_counted"] == 4
    for key in ("flops", "bytes", "peak_bytes", "arg_bytes", "kernels", "collective_bytes",
                "sum"):
        assert ran[True][key] == ran[False][key], key
    assert ran[True]["sum"]["kernel_calls"] == {"embedding_bag": 10,
                                               "embedding_bag_backward": 10}


# -- the production meshes on meta --------------------------------------------------------

def _figures(mesh_name):
    """``dplr-fwfm/train_batch``'s bytes a device of a production mesh, from
    the rules by hand: arena and first-order table by rows over the 16
    model positions, the dense leaves whole; the batch over the data
    replicas."""
    cfg = REGISTRY["dplr-fwfm"].make_config()
    rows, D, k = padded_rows(cfg.layout.total_vocab), 16, cfg.embed_dim
    dp = 32 if mesh_name == "multi" else 16
    b = 65_536 // dp
    n_slots, m = cfg.layout.n_slots, cfg.layout.n_fields
    emb, lin = rows // D * k * 4, rows // D * 4
    dense = {"bias": 4, "U": cfg.rank * m * 4, "e": cfg.rank * 4}
    return dict(emb=emb, lin=lin, dense=dense, rows=b, k=k, n_slots=n_slots, D=D, dp=dp,
                params=emb + lin + sum(dense.values()),
                inputs=b * n_slots * 4 * 2 + b * 4 + 4)


@pytest.mark.parametrize("mesh_name,n", [("single", 256), ("multi", 512)])
def test_dry_run_counts_dplr_fwfm_train_batch_a_device(mesh_name, n):
    """Per-device parameter, state and input bytes equal the rules' figures
    (the 33,040,384 x 16 arena is 132,161,536 B a device); the busiest
    position's collectives are the plan's: all-reduces of the gathered rows
    over the model axis (the embedding's and the first-order table's), of
    the arena blocks' and every dense leaf's gradient and of the loss over
    the data axes, and nothing else; ``n_devices`` the mesh's."""
    f = _figures(mesh_name)
    assert f["emb"] == 132_161_536 and f["lin"] == 8_260_096
    rec = dryrun.count_cell("dplr-fwfm", "train_batch", dryrun.H100_BYTES, "test",
                            mesh_name=mesh_name)
    assert rec["ok"], rec.get("error")
    assert rec["n_devices"] == n and rec["param_bytes"] == f["params"] == 140_422_632
    assert rec["opt_state_bytes"] == f["params"] and rec["input_bytes"] == f["inputs"]
    assert rec["arg_bytes"] == 2 * f["params"] + f["inputs"] and rec["fits_one_card"]
    rows_fwd = f["rows"] * f["n_slots"] * f["k"] * 4 + f["rows"] * f["n_slots"] * 4
    assert f["rows"] * f["n_slots"] * f["k"] * 4 == {"single": 21_495_808,
                                                    "multi": 10_747_904}[mesh_name]
    want = rows_fwd + f["emb"] + f["lin"] + sum(f["dense"].values()) + 4
    coll = rec["collective_bytes"]
    assert coll["all-reduce"] == {"count": 2 + 2 + len(f["dense"]) + 1, "total_bytes": want}
    assert all(coll[k] == {"count": 0, "total_bytes": 0} for k in collectives.KINDS
               if k != "all-reduce")
    assert rec["sum"]["kernel_calls"] == {"embedding_bag": 33 * f["dp"],
                                          "embedding_bag_backward": 33 * f["dp"]}


def test_dry_run_on_the_meshes_names_its_records_and_refuses_lm_and_pna(tmp_path, capsys):
    """``--mesh both`` writes ``<arch>__<shape>__<mesh>.json``, prints
    ``coll=`` beside ``peak``; a PNA cell fails naming its ROADMAP item,
    and is never counted as one device; an LM cell (ROADMAP item 3c-ii,
    done) counts a device of the mesh, its collectives and its blocks."""
    rc = dryrun.main(["--mesh", "both", "--arch", "dplr-fwfm", "--shape", "serve_p99",
                      "--out", str(tmp_path)])
    assert rc == 0
    assert sorted(p.name for p in tmp_path.glob("*.json")) == [
        "dplr-fwfm__serve_p99__multi.json", "dplr-fwfm__serve_p99__single.json"]
    assert capsys.readouterr().out.count("coll=") == 2
    with pytest.raises(NotImplementedError, match="ROADMAP item 3c-iii"):
        steps.build("pna", "molecule", mesh=make_production_mesh(device="meta"))
    rec = dryrun.count_cell("pna", "molecule", dryrun.H100_BYTES, "test", mesh_name="multi")
    assert not rec["ok"] and "ROADMAP item 3c-iii" in rec["error"]
    assert "flops" not in rec and "param_bytes" not in rec
    rec = dryrun.count_cell("gemma3-1b", "decode_32k", dryrun.H100_BYTES, "test",
                            mesh_name="multi")
    assert rec["ok"] and rec["n_devices"] == 512
    assert rec["collective_bytes"]["all-reduce"]["count"] > 0
    assert rec["param_bytes"] == 250_182_144 // 2 and rec["cache_bytes"] == 218_103_808
    # without --mesh, today's one-card record
    rec = dryrun.count_cell("dplr-fwfm", "serve_p99", dryrun.H100_BYTES, "test")
    assert rec["collective_bytes"] is None and "n_devices" not in rec

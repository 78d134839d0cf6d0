"""The training half of sharding on the port's one-process mesh, against
the JAX package on the CPU: the row-blocked arena lookup
(``embedding.sharded``), the recsys models through its ``take_fn``, the
int8 gradient compression (``optim.compression``), the LMs'
``micro_batches`` and ``fsdp``, PNA's partitioned forward, and
``launch.steps.build(..., mesh=)``.

D shards are ``launch.mesh.make_host_mesh(D, device="cpu")``, all on the
CPU.  The reference runs on its one-device host mesh (``shard_map`` over
four forced host devices fails under jax 0.9 in ``compressed_psum``, as
it does in its sharded engine), so at D > 1 the port is held to its own
single-device path and, for ``compressed_psum``, to a numpy statement of
the reference's formula.  Bounds: a sharded take
bitwise the whole table's rows; a sharded bag within ``1e-5 * max(1,
size)`` (``size`` the bag's summed ``|w row|``: the shards' partial bags
add in another order); the models' logits, scores and losses within
``1e-5 * max(1, |x|)`` and each gradient leaf within ``1e-5 * max(1,
max|g|)`` (``test_torch_models.py``'s bounds); the partitioned PNA loss
within 1e-6 (``tests/test_perf_variants.py``'s case), its gradients within
``1e-6 * max(1, max|g|)`` of the port's whole-graph ones, and its logits
within ``1e-5 * max(1, |x|)`` plus twice the reference's own one-ulp
spread of the reference's (``test_torch_gnn.py``'s bound).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import REGISTRY as JREGISTRY  # noqa: E402
from repro.data.synthetic_ctr import SyntheticCTR as JSyntheticCTR  # noqa: E402
from repro.embedding.sharded import make_sharded_take as jmake_sharded_take  # noqa: E402
from repro.embedding.sharded import sharded_lookup_field_embeddings as jsharded_lookup  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.train import build_recsys_trainer as jbuild  # noqa: E402
from repro.models.gnn import pna as jpna  # noqa: E402
from repro.models.recsys import autoint as jautoint  # noqa: E402
from repro.models.recsys import bst as jbst  # noqa: E402
from repro.models.recsys import fwfm as jfwfm  # noqa: E402
from repro.models.recsys import mind as jmind  # noqa: E402
from repro.models.recsys import wide_deep as jwide_deep  # noqa: E402
from repro.models.transformer import model as jtm  # noqa: E402
from repro.optim.compression import compressed_psum as jcompressed_psum  # noqa: E402
from repro.sharding import shard_map  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs.registry import REGISTRY  # noqa: E402
from repro_torch.embedding import bag, sharded  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_host_mesh  # noqa: E402
from repro_torch.models.gnn import pna, sampler  # noqa: E402
from repro_torch.models.recsys import autoint, bst, fwfm, mind, wide_deep  # noqa: E402
from repro_torch.optim import compression  # noqa: E402

JMODULES = {"dplr-fwfm": jfwfm, "wide-deep": jwide_deep, "autoint": jautoint, "bst": jbst,
            "mind": jmind}
MODULES = {"dplr-fwfm": fwfm, "wide-deep": wide_deep, "autoint": autoint, "bst": bst,
           "mind": mind}
LM_ARCHS = ("gemma3-1b", "starcoder2-7b", "yi-9b", "granite-moe-1b-a400m", "mixtral-8x7b")
SHARDS = (1, 2, 4)


def _mesh(D):
    return make_host_mesh(D, device="cpu")


def _jmesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def _close(got, want, what="", size=None):
    got = np.asarray(got.detach() if hasattr(got, "detach") else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    size = np.abs(want) if size is None else np.asarray(size, np.float64)
    err = np.abs(got - want)
    assert (err <= 1e-5 * np.maximum(1.0, size)).all(), f"{what}: max |diff| {err.max():.3g}"


def _close_leaf(got, want, what, tol=1e-5):
    got = np.asarray(got.detach() if hasattr(got, "detach") else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * max(1.0, np.abs(want).max(initial=0.0)), f"{what}: {err:.3g}"


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _both(batch):
    return (jax.tree.map(jnp.asarray, batch),
            {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()})


# -- the row-blocked lookup -----------------------------------------------------

@pytest.mark.parametrize("D", SHARDS)
def test_sharded_take_is_the_whole_tables_rows(D, rng):
    """Bitwise ``gather_rows`` on the whole table and the reference's
    sharded take; its gradient is the plain gather's."""
    table = rng.standard_normal((64, 8)).astype(np.float32)
    ids = rng.integers(0, 64, (6, 5)).astype(np.int32)
    take = sharded.make_sharded_take(_mesh(D), {2: (None, None)})
    t = torch.from_numpy(table)
    got = take(t, torch.from_numpy(ids))
    assert torch.equal(got, bag.gather_rows(t, torch.from_numpy(ids)))
    want = jmake_sharded_take(_jmesh(), {2: P(None, None)})(jnp.asarray(table),
                                                            jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    g = torch.from_numpy(rng.standard_normal((6, 5, 8)).astype(np.float32))
    tg = t.clone().requires_grad_()
    (take(tg, torch.from_numpy(ids)) * g).sum().backward()
    want_g = torch.zeros_like(t).index_add_(0, torch.from_numpy(ids).reshape(-1).long(),
                                            g.reshape(-1, 8))
    assert torch.equal(tg.grad, want_g)


def test_sharded_take_refuses_a_split_it_cannot_make(rng):
    t = torch.zeros((64, 4))
    ids = torch.zeros((3,), dtype=torch.int64)
    with pytest.raises(ValueError, match="cannot split over 'model'"):
        sharded.make_sharded_take(_mesh(2), {1: ("model",)})(t, ids)
    two_replicas = Mesh(("data", "model"), (2, 2), ("cpu", "cpu"))
    with pytest.raises(ValueError, match="one data replica"):
        sharded.make_sharded_take(two_replicas, {1: ("data",)})(t, ids)
    with pytest.raises(ValueError, match="one data replica"):
        sharded.sharded_lookup_field_embeddings(t, REGISTRY["dplr-fwfm"].make_smoke().layout,
                                                ids[None], ids[None].float(),
                                                mesh=two_replicas)
    with pytest.raises(ValueError, match="does not split"):
        sharded.make_sharded_take(_mesh(3))(t, ids)
    with pytest.raises(ValueError, match="model"):
        sharded.make_sharded_take(_mesh(2), model_axis="data")


@pytest.mark.parametrize("D", SHARDS)
def test_sharded_bags_match_the_reference_and_the_whole_table(D, rng):
    """``sharded_lookup_field_embeddings`` on a multi-hot layout against
    the reference's and the port's unsharded lookup, and its table gradient
    against the unsharded one's."""
    from repro.core.fields import FeatureLayout as JLayout, FieldSpec as JSpec
    from repro_torch.core.fields import FeatureLayout, FieldSpec

    spec = [("a", 40, "context", 2), ("b", 30, "context", 1), ("c", 50, "item", 3)]
    layout = FeatureLayout(tuple(FieldSpec(*f) for f in spec))
    jlayout = JLayout(tuple(JSpec(*f) for f in spec))
    rows = bag.padded_rows(layout.total_vocab, 8)
    table = rng.standard_normal((rows, 4)).astype(np.float32)
    ids = np.concatenate([rng.integers(0, f.vocab_size, (5, f.multiplicity))
                          for f in layout.fields], axis=1).astype(np.int32)
    w = rng.random(ids.shape).astype(np.float32)
    t, tid, tw = (torch.from_numpy(a) for a in (table, ids, w))
    got = sharded.sharded_lookup_field_embeddings(t, layout, tid, tw, mesh=_mesh(D))
    size = bag.lookup_field_embeddings(t.abs(), layout, tid, tw.abs())
    want = jsharded_lookup(jnp.asarray(table), jlayout, jnp.asarray(ids), jnp.asarray(w),
                           mesh=_jmesh())
    _close(got, np.asarray(want), "against the reference", size=size)
    _close(got, bag.lookup_field_embeddings(t, layout, tid, tw), "against the port", size=size)
    g = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32))
    tg, tp = t.clone().requires_grad_(), t.clone().requires_grad_()
    (sharded.sharded_lookup_field_embeddings(tg, layout, tid, tw, mesh=_mesh(D)) * g).sum() \
        .backward()
    (bag.lookup_field_embeddings(tp, layout, tid, tw) * g).sum().backward()
    torch.testing.assert_close(tg.grad, tp.grad, rtol=1e-6, atol=1e-6)


def test_a_foreign_slot_adds_to_no_row_of_a_block():
    """Every slot names row 0 of block 0: the other blocks' gradients are
    exactly zero (a foreign slot clipped to their row 0 would land there)."""
    t = torch.ones((16, 2), requires_grad=True)
    take = sharded.make_sharded_take(_mesh(4))
    take(t, torch.zeros((7,), dtype=torch.int64)).sum().backward()
    assert t.grad[0].tolist() == [7.0, 7.0]
    assert not t.grad[1:].any()


# -- the recsys models through take_fn ---------------------------------------------

def _recsys(arch):
    jcfg, cfg = JREGISTRY[arch].make_smoke(), REGISTRY[arch].make_smoke()
    jparams = JMODULES[arch].init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _query(arch, cfg, n, seed):
    rng = np.random.default_rng((seed, 11))
    q = JSyntheticCTR(cfg.layout, embed_dim=4, seed=seed).ranking_query(n, seed)
    if arch in ("bst", "mind"):
        item_vocab = cfg.layout.fields[-1].vocab_size
        q["hist_ids"] = rng.integers(0, item_vocab, (1, cfg.seq_len)).astype(np.int32)
        q["hist_mask"] = (rng.random((1, cfg.seq_len)) > 0.25).astype(np.float32)
    if arch == "mind":
        q = {k: q[k] for k in ("hist_ids", "hist_mask", "item_ids")}
    return q


@pytest.mark.parametrize("D", (1, 4))
@pytest.mark.parametrize("arch", list(MODULES))
def test_models_through_take_fn_match_the_reference(arch, D):
    """``loss``, every gradient leaf, ``apply`` and ``rank_items`` with the
    port's sharded take at D shards against the reference's with its
    ``make_sharded_take``, on the JAX trainer's batch."""
    jcfg, cfg, jparams, params = _recsys(arch)
    jmod, mod = JMODULES[arch], MODULES[arch]
    jtake = jmake_sharded_take(_jmesh(), {1: P(None), 2: P(None, None), 3: P(None, None, None)})
    take = sharded.make_sharded_take(_mesh(D))
    _, jmake = jbuild(arch, jcfg, 32, 0)
    jb, tb = _both(jmake(0))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmod.loss(p, jcfg, b, take_fn=jtake)))(jparams, jb)
    loss, grads = optim.value_and_grad(lambda p, c, b: mod.loss(p, c, b, take_fn=take))(
        params, cfg, tb)
    _close(loss, jloss, f"{arch} loss")
    want = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    got = dict(_flat(grads))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        _close_leaf(got[k], v, f"{arch} d{k}")
    if arch != "mind":
        jb.pop("label")
        tb.pop("label")
        _close(mod.apply(params, cfg, tb, take_fn=take),
               jax.jit(lambda p, b: jmod.apply(p, jcfg, b, take_fn=jtake))(jparams, jb),
               f"{arch} apply")
    jq, tq = _both(_query(arch, cfg, 24, seed=2))
    _close(mod.rank_items(params, cfg, tq, take_fn=take),
           jax.jit(lambda p, q: jmod.rank_items(p, jcfg, q, take_fn=jtake))(jparams, jq),
           f"{arch} rank_items")


def _smoke_fwfm():
    return dataclasses.replace(REGISTRY["dplr-fwfm"].make_smoke())


def _run_cell(cell, n_steps=2):
    params, state, batch, lr = cell.args
    losses = []
    for _ in range(n_steps):
        loss, params, state = cell.fn(params, state, batch, lr)
        losses.append(loss)
    return torch.stack(losses), params, state


def test_dplr_fwfm_train_cell_at_four_shards_is_one_shards():
    """Two adagrad steps of the ``train_batch`` cell (smoke widths, B = 64)
    at D = 4 bitwise D = 1 (losses, parameters, accumulator), and within
    the models' bound of the cell without a mesh."""
    cfg, dims = _smoke_fwfm(), {"batch": 64}
    runs = {D: _run_cell(steps.build("dplr-fwfm", "train_batch", device="cpu", cfg=cfg,
                                     dims=dims, mesh=_mesh(D))) for D in (1, 4)}
    (l1, p1, s1), (l4, p4, s4) = runs[1], runs[4]
    assert torch.equal(l1, l4)
    for (k, a), (_, b) in zip(_flat(p1), _flat(p4)):
        assert torch.equal(a, b), k
    for (k, a), (_, b) in zip(_flat(s1), _flat(s4)):
        assert torch.equal(a, b), k
    lp, pp, _ = _run_cell(steps.build("dplr-fwfm", "train_batch", device="cpu", cfg=cfg,
                                      dims=dims))
    _close(l4, lp, "the cell without a mesh")
    for (k, a), (_, b) in zip(_flat(p4), _flat(pp)):
        _close_leaf(a, b, k)


@pytest.mark.parametrize("arch,shape", [("dplr-fwfm", "train_batch"),
                                        ("dplr-fwfm", "serve_bulk"),
                                        ("wide-deep", "serve_p99"),
                                        ("mind", "train_batch")])
def test_mesh_cells_carry_the_references_rules(arch, shape):
    """On a mesh a recsys cell's ``specs`` are the reference's shardings of
    its parameters and inputs, rule for rule, and ``auto_leaf_spec`` is the
    reference's on every input."""
    jcell = jsteps.build(arch, shape, _jmesh())
    mesh = make_host_mesh(4, device="meta")
    cell = steps.build(arch, shape, device="meta", mesh=mesh)
    at = 2 if cell.kind == "train" else 1
    jparams, jbatch = jcell.in_shardings[0], jcell.in_shardings[at]
    assert _spec_leaves(cell.specs["params"]) == {
        k: tuple(v.spec) for k, v in _spec_leaves(jparams).items()}
    assert cell.specs["batch"] == {k: tuple(v.spec) for k, v in jbatch.items()}
    for k, t in cell.args[at].items():
        assert steps.auto_leaf_spec(tuple(t.shape), mesh) == \
            tuple(jsteps.auto_leaf_spec(t.shape, _jmesh())), k


def _spec_leaves(tree, prefix=""):
    """``{path: leaf}`` through dicts and lists (a rule's tuple is a leaf)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    return {k: v for key, sub in items for k, v in _spec_leaves(sub, f"{prefix}/{key}").items()}


@pytest.mark.parametrize("shape", ["molecule", "full_graph_sm"])
def test_gnn_batch_pads_to_the_mesh(shape):
    """On a mesh of 3 the batch's nodes and edges pad to a multiple of 3,
    as the reference's ``_gnn_batch`` pads them on a stand-in mesh of that
    shape, the padded edges masked and the padded nodes unlabelled."""
    from types import SimpleNamespace

    spec = next(s for s in JREGISTRY["pna"].shapes if s.name == shape)
    stand_in = SimpleNamespace(axis_names=("data", "model"), shape={"data": 1, "model": 3})
    want, _ = jsteps._gnn_batch(spec, stand_in)
    batch = steps.build("pna", shape, device="cpu", mesh=_mesh(3)).args[2]
    assert {k: tuple(v.shape) for k, v in batch.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    n_nodes, n_edges = steps.gnn_sizes(spec)
    assert float(batch["edge_mask"].sum()) == n_edges
    if spec.dims["task"] == "node":
        assert float(batch["label_mask"].sum()) == n_nodes


# -- int8 compression ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["normal", "tiny", "zeros", "ties"])
def test_int8_compress_is_the_references(case, rng):
    x = {"normal": rng.standard_normal((40, 7)).astype(np.float32),
         "tiny": (rng.standard_normal(300) * 1e-20).astype(np.float32),
         "zeros": np.zeros((5, 3), np.float32),
         "ties": (np.arange(-254, 255, dtype=np.float32) / 2.0)}[case]
    q, scale = compression.int8_compress(torch.from_numpy(x))
    jq, jscale = joptim.int8_compress(jnp.asarray(x))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert scale.item() == float(jscale)
    np.testing.assert_array_equal(optim.int8_decompress(q, scale).numpy(),
                                  np.asarray(joptim.int8_decompress(jq, jscale)))
    assert float((torch.from_numpy(x) - optim.int8_decompress(q, scale)).abs().max()) <= \
        0.51 * scale.item() + 1e-7


def test_compressed_psum_on_one_position_is_the_references(rng):
    x = rng.standard_normal((8, 4)).astype(np.float32)
    err0 = (rng.standard_normal((8, 4)) * 0.01).astype(np.float32)
    fn = shard_map(lambda a, b: jcompressed_psum(a, "data", b), mesh=_jmesh(),
                   in_specs=(P(), P()), out_specs=(P(), P()))
    jout, jerr = fn(jnp.asarray(x), jnp.asarray(err0))
    (out,), (err,) = compression.compressed_psum([torch.from_numpy(x)],
                                                 [torch.from_numpy(err0)])
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
    np.testing.assert_allclose(out + err, x + err0, atol=1e-6)


def _psum_formula(xs, errs):
    """The reference's ``compressed_psum`` over len(xs) positions, in numpy:
    one scale from the largest |x + e| of all, int8 grids summed in int32."""
    corr = [x + e for x, e in zip(xs, errs)]
    amax = np.float32(max(np.abs(c).max() for c in corr))
    scale = np.float32(np.maximum(amax, np.float32(1e-12)) / np.float32(127.0))
    qs = [np.clip(np.round(c / scale), -127, 127).astype(np.int8) for c in corr]
    errors = [c - q.astype(np.float32) * scale for c, q in zip(corr, qs)]
    total = np.sum([q.astype(np.int32) for q in qs], axis=0, dtype=np.int32)
    mean = (total.astype(np.float32) * scale / np.float32(len(xs))).astype(np.float32)
    return mean, errors, scale


def test_compressed_psum_over_four_positions_is_the_formula(rng):
    """At D = 4 (the reference's ``shard_map`` over four forced host
    devices fails under jax 0.9, in ``compressed_psum`` itself): bitwise the numpy
    statement of its formula; each error within half a grid step."""
    xs = [rng.standard_normal((33, 5)).astype(np.float32) * (s + 1) for s in range(4)]
    errs = [(rng.standard_normal((33, 5)) * 0.01).astype(np.float32) for _ in range(4)]
    outs, new = compression.compressed_psum([torch.from_numpy(x) for x in xs],
                                            [torch.from_numpy(e) for e in errs])
    mean, want_err, scale = _psum_formula(xs, errs)
    for s in range(4):
        np.testing.assert_array_equal(outs[s].numpy(), mean)
        np.testing.assert_array_equal(new[s].numpy(), want_err[s])
        assert np.abs(new[s].numpy()).max() <= 0.51 * scale
    exact = np.mean([x + e for x, e in zip(xs, errs)], axis=0)
    assert np.abs(mean - exact).max() <= 0.51 * scale


# -- the LMs' micro_batches and fsdp -------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_configs_carry_the_references_micro_batches_and_fsdp(arch):
    for make, jmake in ((REGISTRY[arch].make_config, JREGISTRY[arch].make_config),
                        (REGISTRY[arch].make_smoke, JREGISTRY[arch].make_smoke)):
        cfg, jcfg = make(), jmake()
        assert (cfg.micro_batches, cfg.fsdp) == (jcfg.micro_batches, jcfg.fsdp)


def test_micro_batched_lm_step_matches_the_references_accumulation():
    """The ``train_4k`` cell at gemma3-1b's smoke widths with gemma3-1b's
    ``micro_batches`` = 4, B = 4 x 16 tokens, f32 compute: against the
    reference's ``gradient_accumulation`` and adamw on the same weights and
    tokens (loss within 1e-5 x max(1, |loss|), parameters within 1e-5 of
    each leaf's largest entry), and against the one-batch cell within the
    same bounds."""
    jcfg = dataclasses.replace(JREGISTRY["gemma3-1b"].make_smoke(), compute_dtype=jnp.float32,
                               micro_batches=4)
    cfg = dataclasses.replace(REGISTRY["gemma3-1b"].make_smoke(), compute_dtype=torch.float32,
                              micro_batches=4)
    dims = {"batch": 4, "seq": 16}
    cell = steps.build("gemma3-1b", "train_4k", device="cpu", cfg=cfg, dims=dims, seed=3)
    assert any("4 microbatches of 1" in n for n in cell.notes)
    params, state, batch, lr = cell.args
    jparams = jax.tree.map(jnp.asarray, _np_tree(params))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jopt = joptim.adamw(weight_decay=0.1)
    jl, jg = joptim.gradient_accumulation(lambda p, b: jtm.lm_loss(p, jcfg, b), 4)(
        jparams, jbatch)
    jp, _ = jopt.update(jg, jopt.init(jparams), jparams, float(lr))
    one = steps.build("gemma3-1b", "train_4k", device="cpu",
                      cfg=dataclasses.replace(cfg, micro_batches=1), dims=dims, seed=3)
    lo, po, _ = one.fn(*one.args)
    loss, new, _ = cell.fn(params, state, batch, lr)
    _close(loss, float(jl), "loss against the reference")
    _close(loss, lo, "loss against the one-batch step")
    want = dict(_flat(jax.tree.map(np.asarray, jp)))
    for k, v in _flat(new):
        _close_leaf(v, want[k], f"{k} against the reference")
    for (k, a), (_, b) in zip(_flat(new), _flat(po)):
        _close_leaf(a, b, f"{k} against the one-batch step")


def _np_tree(tree):
    out = {}
    for k, v in tree.items():
        out[k] = _np_tree(v) if isinstance(v, dict) else v.detach().numpy().copy()
    return out


# -- PNA's partitioned forward -------------------------------------------------------

def _pna_case(rng, N_p=32, E=100, F=10, C=5):
    jcfg = jpna.PNAConfig(d_feat=F, d_hidden=12, n_layers=2, n_classes=C)
    cfg = pna.PNAConfig(d_feat=F, d_hidden=12, n_layers=2, n_classes=C)
    jparams = jpna.init(jax.random.PRNGKey(0), jcfg)
    src = rng.integers(0, N_p, E).astype(np.int32)
    dst = rng.integers(0, N_p, E).astype(np.int32)
    batch = {"node_feat": rng.standard_normal((N_p, F), dtype=np.float32),
             "edge_src": src, "edge_dst": dst,
             "labels": rng.integers(0, C, N_p).astype(np.int32),
             "label_mask": (rng.random(N_p) > 0.2).astype(np.float32)}
    return jcfg, cfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"), \
        batch


def _partitioned(batch, N_p, D):
    part, _ = sampler.partition_graph(batch["edge_src"], batch["edge_dst"], N_p, D)
    return {"node_feat": batch["node_feat"], **part, "labels": batch["labels"],
            "label_mask": batch["label_mask"]}


def test_partitioned_pna_on_one_shard_is_the_references(rng):
    jcfg, cfg, jparams, params, batch = _pna_case(rng)
    pb = _partitioned(batch, 32, 1)
    jpb, tpb = _both(pb)
    want = jax.jit(lambda p, b: jpna.loss_partitioned(p, jcfg, b, mesh=_jmesh(),
                                                      axes=("data", "model")))(jparams, jpb)
    got = pna.loss_partitioned(params, cfg, tpb, mesh=_mesh(1))
    assert abs(float(got) - float(want)) <= 1e-6 * max(1.0, abs(float(want)))
    logits = pna.forward_partitioned(params, cfg, tpb, mesh=_mesh(1)).detach().numpy()
    want, spread = _partitioned_logits(jcfg, jparams, jpb)
    err = np.abs(logits - want)
    assert (err <= 1e-5 * np.maximum(1.0, np.abs(want)) + 2 * spread).all(), err.max()


def _partitioned_logits(jcfg, jparams, jpb):
    """The reference's partitioned logits, and the most they move when its
    node features or weights move by one ulp up or down: on a graph where
    a node takes identical messages (an (src, dst) pair drawn twice) the
    std aggregator's ``E[m^2] - E[m]^2`` cancels and magnifies a last-bit
    difference (``test_torch_gnn.py``'s spread)."""
    jfwd = jax.jit(lambda p, b: jpna.forward_partitioned(p, jcfg, b, mesh=_jmesh(),
                                                         axes=("data", "model")))

    def fwd(p, b):
        return np.asarray(jfwd(p, b), np.float64)

    base, most = fwd(jparams, jpb), 0.0
    for to in (jnp.inf, -jnp.inf):
        nudged = dict(jpb, node_feat=jnp.nextafter(jpb["node_feat"], to))
        for p, b in ((jparams, nudged), (jax.tree.map(lambda a: jnp.nextafter(a, to), jparams),
                                         jpb)):
            most = max(most, float(np.abs(fwd(p, b) - base).max()))
    return base, most


@pytest.mark.parametrize("D", (2, 4))
def test_partitioned_pna_at_several_shards_is_the_whole_graphs(D, rng):
    """``loss_partitioned`` and its gradients at D shards against the
    port's ``loss`` on the whole graph, at 1e-6."""
    _, cfg, _, params, batch = _pna_case(rng)
    _, tb = _both(batch)
    _, tpb = _both(_partitioned(batch, 32, D))
    want, gw = optim.value_and_grad(pna.loss)(params, cfg, tb)
    got, gg = optim.value_and_grad(
        lambda p, c, b: pna.loss_partitioned(p, c, b, mesh=_mesh(D)))(params, cfg, tpb)
    assert abs(float(got) - float(want)) <= 1e-6 * max(1.0, abs(float(want)))
    for (k, a), (_, b) in zip(_flat(gg), _flat(gw)):
        _close_leaf(a, b, f"d{k}", tol=1e-6)


def test_node_constraint_is_applied_at_each_layer_boundary(rng):
    _, cfg, _, params, batch = _pna_case(rng)
    seen = []
    ccfg = dataclasses.replace(cfg, node_constraint=lambda h: seen.append(h.shape) or h)
    _, tb = _both(batch)
    assert torch.equal(pna.loss(params, ccfg, tb), pna.loss(params, cfg, tb))
    assert seen == [(32, 12)] * (cfg.n_layers + 1)


@pytest.mark.parametrize("shape", ["full_graph_sm", "ogb_products"])
def test_part_cells_are_the_references(shape):
    """``pna/<shape>+part``: the reference's name and argument shapes and
    types, on one shard and on a mesh of 4."""
    jcell = jsteps.build("pna", shape, _jmesh(), opts={"partitioned": True})
    cell = steps.build("pna", shape, opts={"partitioned": True})
    assert cell.name == jcell.name == f"pna/{shape}+part"
    want = {k: (tuple(v.shape), np.dtype(v.dtype).name) for k, v in jcell.args[2].items()}
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in cell.args[2].items()} == want
    four = steps.build("pna", shape, opts={"partitioned": True},
                       mesh=make_host_mesh(4, device="meta"))
    n_edges = steps.gnn_sizes(next(s for s in REGISTRY["pna"].shapes if s.name == shape))[1]
    e_loc = -(-int(-(-n_edges // 4) * 4 * 1.25) // 4)
    assert four.args[2]["src_global"].shape == (4 * e_loc,)

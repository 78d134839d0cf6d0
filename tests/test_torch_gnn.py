"""The port's GNN family (``repro_torch.models.gnn``, ``configs/pna.py``,
``examples/gnn_train.py``) against the JAX package's, on the CPU.

Both packages get the same numpy graphs and one set of weights (the JAX
``init``, through ``interop``).  Bounds:

  * the sampler (and ``partition_graph``): bitwise, for the same
    ``np.random.Generator`` seed;
  * PNA with f32 compute: logits and loss within ``1e-5 * max(1, |x|)``
    plus twice the reference's own spread (the most its logits move when
    its node features, or its weights, move by one ulp up or down), each
    gradient leaf within ``1e-4 *`` its largest ``|g|``.  The spread is
    largest on the sampled smoke graph, where nodes take several identical
    messages (neighbours are drawn with replacement) and the std
    aggregator's ``E[m^2] - E[m]^2`` cancels: at var = 0 a last-bit change
    of the variance moves ``sqrt(var + 1e-5)`` by ``1 / (2 sqrt(1e-5))``
    ~ 158 times as much, and the two packages' matmuls round differently
    in the last bit;
  * PNA with bf16 compute: the loss within ``3e-2 * max(1, |loss|)`` of the
    reference's, and the logits within ``3e-2 * max(1, |x|)`` of the
    reference's bf16 logits on the masked-edges and graph cases.  One
    operation rounds differently: a bf16 segment sum.  XLA on the CPU
    rounds each add to bf16 (in edge order); torch's CPU ``index_add_``
    adds in f32 and rounds once.  Where many edges meet a node, the std
    aggregator's ``E[m^2] - E[m]^2`` cancels and magnifies that, so the
    smoke graph (sampled with replacement) and the isolated case (all 12
    edges into node 0) get bounds from measured readings: 0.21 and 0.045,
    about 1.25 times the port's 0.1621 and 0.03571.  With that one
    operation aligned (the reference's segment sums fed f32 and rounded
    back to bf16), the port's bf16 logits are bitwise the reference's in
    every case, and an f32-compute port fails that check in every case.

Sizes: ``make_smoke()``, and ``tests/test_gnn_and_hlo.py``'s (d_feat 8,
d_hidden 12, 2 layers, 3 classes; 30 nodes and 80 edges plus 20 masked
ones; 10 nodes with every edge into node 0), node and graph tasks.
"""
import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as JREGISTRY  # noqa: E402
from repro.configs import pna as jpna_cfg  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.gnn import pna as jpna  # noqa: E402
from repro.models.gnn import sampler as jsampler  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch.configs import pna as pna_cfg  # noqa: E402
from repro_torch.configs.registry import REGISTRY  # noqa: E402
from repro_torch.examples import gnn_train  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.gnn import pna, sampler  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


# -- the sampler ----------------------------------------------------------------

@pytest.mark.parametrize("n_nodes,avg_degree,d_feat,n_classes,batch,fanouts", [
    (500, 6, 8, 4, 32, (5, 3)),
    (2000, 10, 32, 8, 128, (10, 5)),
    (300, 1, 3, 2, 7, (4,)),
])
def test_sampler_is_bitwise_the_reference(n_nodes, avg_degree, d_feat, n_classes, batch,
                                          fanouts):
    gj = jsampler.random_graph(np.random.default_rng(5), n_nodes, avg_degree, d_feat,
                               n_classes)
    gt = sampler.random_graph(np.random.default_rng(5), n_nodes, avg_degree, d_feat,
                              n_classes)
    for name in ("indptr", "indices", "node_feat", "labels"):
        a, b = getattr(gj, name), getattr(gt, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert gt.n_nodes == gj.n_nodes == n_nodes
    rj, rt = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        seeds_j, seeds_t = rj.integers(0, n_nodes, batch), rt.integers(0, n_nodes, batch)
        sj = jsampler.sample_subgraph(gj, seeds_j, fanouts, rj)
        st = sampler.sample_subgraph(gt, seeds_t, fanouts, rt)
        assert sorted(sj) == sorted(st)
        for k in sj:
            assert sj[k].dtype == st[k].dtype and np.array_equal(sj[k], st[k]), k
    assert (sampler.subgraph_shapes(batch, fanouts, d_feat)
            == jsampler.subgraph_shapes(batch, fanouts, d_feat))
    # the destination partition of the reference's sharded PNA (numpy)
    n_pad = -(-n_nodes // 4) * 4
    pj, ej = jpna.partition_graph(sj["edge_src"], sj["edge_dst"] % n_pad, n_pad, 4)
    pt, et = sampler.partition_graph(st["edge_src"], st["edge_dst"] % n_pad, n_pad, 4)
    assert ej == et and all(np.array_equal(pj[k], pt[k]) for k in pj)


# -- PNA against the JAX package -------------------------------------------------

def _graph_batch(rng, N, E, d, n_classes):
    """``tests/test_gnn_and_hlo.py``'s batch, in numpy."""
    return {
        "node_feat": rng.standard_normal((N, d), dtype=np.float32),
        "edge_src": rng.integers(0, N, E).astype(np.int32),
        "edge_dst": rng.integers(0, N, E).astype(np.int32),
        "labels": rng.integers(0, n_classes, N).astype(np.int32),
    }


def _case(name: str):
    """(config, numpy batch) of one named case."""
    rng = np.random.default_rng(0)
    small = pna.PNAConfig(d_feat=8, d_hidden=12, n_layers=2, n_classes=3)
    if name == "smoke":
        cfg = pna_cfg.make_smoke()
        g = sampler.random_graph(rng, 400, 5, cfg.d_feat, cfg.n_classes)
        return cfg, sampler.sample_subgraph(g, rng.integers(0, 400, 16), (4, 3), rng)
    if name == "masked-edges":
        b = _graph_batch(rng, 30, 80, 8, 3)
        b["edge_src"] = np.concatenate([b["edge_src"], np.zeros(20, np.int32)])
        b["edge_dst"] = np.concatenate([b["edge_dst"], np.zeros(20, np.int32)])
        b["edge_mask"] = np.concatenate([np.ones(80), np.zeros(20)]).astype(np.float32)
        b["label_mask"] = (rng.random(30) > 0.3).astype(np.float32)
        return small, b
    if name == "isolated":
        b = _graph_batch(rng, 10, 12, 8, 3)
        b["edge_dst"] = np.zeros(12, np.int32)   # the other nodes have degree 0
        return small, b
    if name == "graph":   # 6 molecules of 7 nodes, 12 edges each, one padded node
        G, n, e = 6, 7, 12
        N = G * n + 1
        b = _graph_batch(rng, N, G * e, 8, 2)
        off = np.repeat(np.arange(G) * n, e)
        b["edge_src"] = (rng.integers(0, n, G * e) + off).astype(np.int32)
        b["edge_dst"] = (rng.integers(0, n, G * e) + off).astype(np.int32)
        b["graph_ids"] = np.concatenate([np.repeat(np.arange(G), n), [G - 1]]).astype(np.int32)
        b["n_graphs"] = G
        b["labels"] = rng.integers(0, 2, G).astype(np.int32)
        return dataclasses.replace(small, task="graph", n_classes=2), b
    raise ValueError(name)


CASES = ("smoke", "masked-edges", "isolated", "graph")


def _both(name: str, dtype: str, remat: bool = False):
    cfg, nb = _case(name)
    jdt, tdt = DTYPES[dtype]
    jcfg = jpna.PNAConfig(d_feat=cfg.d_feat, d_hidden=cfg.d_hidden, n_layers=cfg.n_layers,
                          n_classes=cfg.n_classes, task=cfg.task, compute_dtype=jdt,
                          remat=remat)
    cfg = dataclasses.replace(cfg, compute_dtype=tdt, remat=remat)
    jparams = jpna.init(jax.random.PRNGKey(3), jcfg)
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jbatch = {k: v if k == "n_graphs" else jnp.asarray(v) for k, v in nb.items()}
    batch = {k: v if k == "n_graphs" else torch.from_numpy(np.asarray(v))
             for k, v in nb.items()}
    return jcfg, jparams, jbatch, cfg, params, batch


def _close(got, want, tol, what):
    got = np.asarray(got.detach().float() if hasattr(got, "detach") else got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want)
    assert (err <= tol * np.maximum(1.0, np.abs(want))).all(), f"{what}: max |diff| {err.max():.3g}"


def _spread(jcfg, jparams, jbatch) -> float:
    """The most the reference's logits move when its node features, or its
    weights, move by one ulp up or down: its own conditioning here."""
    base = np.asarray(jpna.forward(jparams, jcfg, jbatch), np.float64)
    most = 0.0
    for to in (jnp.inf, -jnp.inf):
        nudged = dict(jbatch, node_feat=jnp.nextafter(jbatch["node_feat"], to))
        for p, b in ((jparams, nudged), (jax.tree.map(lambda a: jnp.nextafter(a, to), jparams),
                                         jbatch)):
            most = max(most, float(np.abs(np.asarray(jpna.forward(p, jcfg, b)) - base).max()))
    return most


@pytest.mark.parametrize("name", CASES)
def test_pna_forward_loss_and_gradients_match_jax(name):
    jcfg, jparams, jbatch, cfg, params, batch = _both(name, "f32")
    logits = pna.forward(params, cfg, batch)
    want = np.asarray(jpna.forward(jparams, jcfg, jbatch), np.float64)
    err = np.abs(logits.detach().numpy() - want)
    bound = 1e-5 * np.maximum(1.0, np.abs(want)) + 2 * _spread(jcfg, jparams, jbatch)
    assert (err <= bound).all(), f"logits: max |diff| {err.max():.3g}"
    jloss, jgrads = jax.value_and_grad(jpna.loss)(jparams, jcfg, jbatch)
    loss, grads = optim.value_and_grad(pna.loss)(params, cfg, batch)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss))) + err.max()
    want = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    got = dict(_flat(grads))
    assert sorted(got) == sorted(want)
    for k, g in want.items():
        err = np.abs(got[k].numpy() - g).max(initial=0.0)
        assert err <= 1e-4 * np.abs(g).max(initial=0.0) + 1e-12, f"d {k}: {err:.3g}"


# logits against the reference's bf16 logits, x max(1, |x|): the issue's
# 3e-2 where edges are uniform, measured readings where a node takes many
# (the module docstring)
BF16_LOGIT_BOUND = {"smoke": 0.21, "masked-edges": 3e-2, "isolated": 0.045, "graph": 3e-2}


def _segment_sums_in_f32():
    """The reference's ``jax.ops.segment_sum`` summing in f32 and rounding
    once to the input's type, as torch's CPU ``index_add_`` does, while
    the context is open."""
    segment_sum = jax.ops.segment_sum

    def summed_in_f32(x, seg, num_segments):
        return segment_sum(x.astype(jnp.float32), seg,
                           num_segments=num_segments).astype(x.dtype)

    return mock.patch.object(jax.ops, "segment_sum", summed_in_f32)


def _bf16_readings(name: str) -> dict:
    """One case in bf16 compute: the port's logits and losses, the
    reference's as it is and with its segment sums in f32, and the
    control, an f32-compute port with its logits rounded to bf16."""
    jcfg, jparams, jbatch, cfg, params, batch = _both(name, "bf16")
    as64 = lambda x: np.asarray(np.asarray(x, np.float32), np.float64)  # noqa: E731
    logits = pna.forward(params, cfg, batch)
    f32 = pna.forward(params, dataclasses.replace(cfg, compute_dtype=torch.float32), batch)
    with _segment_sums_in_f32():
        aligned = as64(jpna.forward(jparams, jcfg, jbatch))
    return dict(dtype=logits.dtype, port=as64(logits.float()), control=as64(f32.to(
        torch.bfloat16).float()), reference=as64(jpna.forward(jparams, jcfg, jbatch)),
        aligned=aligned, loss=float(pna.loss(params, cfg, batch)),
        jloss=float(jpna.loss(jparams, jcfg, jbatch)))


def _rel(got, want) -> float:
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


@pytest.mark.parametrize("name", CASES)
def test_pna_bf16_compute_matches_jax(name):
    r = _bf16_readings(name)
    assert r["dtype"] == torch.bfloat16 and np.isfinite(r["port"]).all()
    assert abs(r["loss"] - r["jloss"]) <= 3e-2 * max(1.0, abs(r["jloss"])), (r["loss"], r["jloss"])
    assert _rel(r["port"], r["reference"]) <= BF16_LOGIT_BOUND[name], _rel(r["port"],
                                                                         r["reference"])
    # the one operation aligned: bitwise, and an f32-compute port is not
    assert np.array_equal(r["port"], r["aligned"]), _rel(r["port"], r["aligned"])
    assert not np.array_equal(r["control"], r["aligned"])


@pytest.mark.parametrize("name", ["smoke", "graph"])
def test_pna_remat_gives_the_same_loss_and_gradients(name):
    *_, cfg, params, batch = _both(name, "f32", remat=False)
    loss, grads = optim.value_and_grad(pna.loss)(params, cfg, batch)
    loss_r, grads_r = optim.value_and_grad(pna.loss)(
        params, dataclasses.replace(cfg, remat=True), batch)
    assert torch.equal(loss, loss_r)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(_flat(grads), _flat(grads_r)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pna_masked_edges_change_nothing_and_isolated_nodes_stay_finite(dtype):
    """The port's own ``test_gnn_and_hlo.py`` cases: padded (masked) edges
    leave the output as it is; zero-degree nodes get zero aggregates, and
    the 1e30 sentinel stays finite in bf16."""
    *_, cfg, params, batch = _both("masked-edges", dtype)
    E = 80
    plain = {k: (v[:E] if k.startswith("edge_") else v) for k, v in batch.items()}
    plain["edge_mask"] = torch.ones(E)
    tol = 1e-5 if dtype == "f32" else 3e-2
    _close(pna.forward(params, cfg, batch), pna.forward(params, cfg, plain).float().numpy(),
           tol, "masked edges")
    *_, cfg, params, batch = _both("isolated", dtype)
    h = torch.randn(10, cfg.d_hidden).to(cfg.compute_dtype)
    m = torch.relu(h[batch["edge_src"].long()])
    agg, deg = pna._segment_agg(m, batch["edge_dst"].long(), 10, torch.ones(12))
    assert torch.isfinite(agg.float()).all() and (agg[1:] == 0)[:, :3 * cfg.d_hidden].all()
    assert torch.isfinite(pna.forward(params, cfg, batch).float()).all()


# -- configs, registry, interop, drivers ---------------------------------------------

def test_configs_and_registry_mirror_the_reference():
    spec, jspec = REGISTRY["pna"], JREGISTRY["pna"]
    assert spec.family == jspec.family == "gnn"
    assert [(s.name, s.kind, s.dims, s.skip) for s in spec.shapes] == \
        [(s.name, s.kind, s.dims, s.skip) for s in jspec.shapes]
    fields = ("d_feat", "d_hidden", "n_layers", "n_classes", "task", "remat")
    for make in ("make_config", "make_smoke"):
        base, jbase = getattr(pna_cfg, make)(), getattr(jpna_cfg, make)()
        assert [getattr(base, f) for f in fields] == [getattr(jbase, f) for f in fields]
        for shape, jshape in zip(pna_cfg.SHAPES, jpna_cfg.SHAPES):
            got = pna_cfg.shape_config(base, shape)
            want = jpna_cfg.shape_config(jbase, jshape)
            assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
    with pytest.raises(SystemExit, match="repro_torch.examples.gnn_train"):
        train.main(["--arch", "pna", "--device", "cpu"])


def test_interop_carries_the_pna_tree_and_the_mlp_keys_match():
    cfg = pna_cfg.make_smoke()
    jcfg = jpna_cfg.make_smoke()
    jparams = jax.tree.map(np.asarray, jpna.init(jax.random.PRNGKey(0), jcfg))
    params = interop.params_from_numpy(jparams, "cpu")
    want = {k: (v.shape, str(v.dtype)) for k, v in _flat(jparams)}
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in _flat(params)} \
        == {k: (tuple(s), d) for k, (s, d) in want.items()}
    back = interop.params_to_numpy(params)
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(_flat(back), _flat(jparams)))
    own = pna.init(torch.Generator().manual_seed(0), cfg)
    assert sorted(k for k, _ in _flat(own)) == sorted(want)
    dims = [cfg.d_hidden, cfg.d_hidden, cfg.n_classes]
    mlp = layers.init_mlp(torch.Generator().manual_seed(0), dims)
    jmlp = jlayers.init_mlp(jax.random.PRNGKey(0), dims)
    assert sorted(k for k, _ in _flat(mlp)) == sorted(k for k, _ in _flat(jmlp)) \
        == sorted(k.split("/", 1)[1] for k in want if k.startswith("decoder/"))


def test_gnn_example_trains_on_the_cpu(capsys):
    losses = gnn_train.main(["--device", "cpu", "--steps", "20"])
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert "step   20  loss" in capsys.readouterr().out


if __name__ == "__main__":
    # the bf16 readings behind BF16_LOGIT_BOUND, x max(1, |x|):
    #   JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_gnn.py
    for case in CASES:
        r = _bf16_readings(case)
        print(f"{case}: port {_rel(r['port'], r['reference']):.4g}, control "
              f"{_rel(r['control'], r['reference']):.4g} against the reference; with its "
              f"segment sums in f32: port {_rel(r['port'], r['aligned']):.4g}, control "
              f"{_rel(r['control'], r['aligned']):.4g}; loss |diff| "
              f"{abs(r['loss'] - r['jloss']):.4g}")

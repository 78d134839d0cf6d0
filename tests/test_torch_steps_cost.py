"""The port's launch tools against the JAX package's: ``launch.steps``
builds every registry cell on ``meta`` with the reference's arguments,
``launch.cost`` counts hand-counted cases exactly and the reference's
smoke cells as its HLO walk does (or exactly at a difference derived from
the shapes), each kernel's ``meta`` call returns its CPU call's shapes and
types, and ``launch.dryrun`` writes and resumes its records."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import REGISTRY as JREG  # noqa: E402
from repro.configs.pna import shape_config as j_shape_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.hlo_cost import analyze as hlo_analyze  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models.gnn import pna as jpna  # noqa: E402
from repro.models.recsys import fwfm as jfwfm  # noqa: E402
from repro.models.transformer import model as jtm  # noqa: E402
from repro_torch.configs.registry import REGISTRY  # noqa: E402
from repro_torch.kernels import ops, work  # noqa: E402
from repro_torch.launch import cost, dryrun, steps  # noqa: E402
from repro_torch.models.transformer import model as tm  # noqa: E402

CELLS = [(a, s) for a, s, _ in jsteps.all_cells()]
SDS = jax.ShapeDtypeStruct


def _jax_specs(tree) -> dict:
    """``{checkpoint key: (shape, dtype name)}`` of a JAX tree of shapes."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            (tuple(leaf.shape), np.dtype(leaf.dtype).name) for path, leaf in flat}


def _torch_specs(tree, path=()) -> dict:
    """The same for a tree of tensors (dict keys and sequence indices)."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _torch_specs(tree[key], path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, item in enumerate(tree)
                for k, v in _torch_specs(item, path + (i,)).items()}
    return {"/".join(map(str, path)): (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}


def test_all_cells_are_the_references():
    ours = [(a, s) for a, s, _ in steps.all_cells()]
    assert sorted(ours) == sorted(CELLS) and len(CELLS) == 41
    assert len(list(steps.all_cells(include_skipped=True))) == 44


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_arguments_match_the_reference(arch, shape):
    """Names, shapes and types of every argument leaf; building on meta
    allocates nothing.  No argument is left out for what waits for more
    than one data replica (FSDP across replicas, the production meshes):
    that is in the cell's notes, under its ROADMAP item, not in its
    arguments."""
    want = _jax_specs(jsteps.build(arch, shape, make_host_mesh()).args)
    cell = steps.build(arch, shape, device="meta")
    assert _torch_specs(cell.args) == want
    assert all(t.is_meta for t in jax.tree_util.tree_leaves(
        cell.args, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert any("ROADMAP item 3c" in note for note in cell.notes)


def test_cells_build_with_the_references_options():
    cfg = steps.build("mixtral-8x7b", "train_4k", opts={"moe_scatter": True, "moe_fused": True})
    notes = " ".join(cfg.notes)
    # the reference's n_micro = min(micro_batches, B // dp): 16 of 16 rows each
    assert "16 microbatches of 16 (micro_batches=16)" in notes
    assert "fsdp=True changes no computation with one data replica" in notes
    # the +part cell: the reference's name and arguments, on one shard
    part = steps.build("pna", "ogb_products", opts={"partitioned": True})
    jpart = jsteps.build("pna", "ogb_products", make_host_mesh(), opts={"partitioned": True})
    assert part.name == jpart.name == "pna/ogb_products+part"
    assert _torch_specs(part.args) == _jax_specs(jpart.args)
    # the +mp rank cells: rank_items_mp on a one-device mesh, the reference's
    # name and arguments; for the other recsys archs the option changes nothing
    for shape in ("serve_p99", "retrieval_cand"):
        mp = steps.build("dplr-fwfm", shape, opts={"mp_scoring": True})
        want = jsteps.build("dplr-fwfm", shape, make_host_mesh(), opts={"mp_scoring": True})
        assert mp.name == want.name == f"dplr-fwfm/{shape}+mp"
        assert _torch_specs(mp.args) == _jax_specs(want.args)
        assert not any("rank_items_mp" in note for note in mp.notes)
    assert steps.build("wide-deep", "serve_p99", opts={"mp_scoring": True}).name == \
        "wide-deep/serve_p99"
    cell = steps.build("dplr-fwfm", "serve_bulk", opts={"serve_bf16": True})
    assert cell.args[0]["embedding"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="N/A"):
        steps.build("yi-9b", "long_500k")


# -- hand-counted cases ------------------------------------------------------------


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


@pytest.mark.parametrize("n,trips", [(64, (10,)), (32, (4, 5))])
def test_loops_count_every_trip(n, trips):
    """``test_gnn_and_hlo.py``'s scan cases: 10 trips of a 64^2 product,
    and 4 x 5 nested trips of a 32^2 one."""
    def chain(x, w):
        for _ in range(int(np.prod(trips))):
            x = x @ w
        return x

    got = cost.analyze(chain, _meta(n, n), _meta(n, n))
    assert got["flops"] == 2 * n**3 * int(np.prod(trips))
    # each product reads two n^2 operands and writes one; one output lives at a time
    assert got["bytes"] == 3 * n * n * 4 * int(np.prod(trips))
    assert got["peak_bytes"] == 2 * n * n * 4 + 2 * n * n * 4
    assert got["kernels"] == {} and got["collective_bytes"] is None


def test_peak_bytes_of_a_chain_with_its_backward():
    """Four (n, n) products with tanh, w needing a gradient: the forward
    keeps each tanh output for the backward (the transient product dies
    at its tanh); the backward adds w's gradient, the scalar loss and its
    seed.  11 products: 4 forward, 4 for w's gradient, 3 for the inputs'
    (the first input needs none)."""
    n, f = 256, 4

    def fwd(x, w):
        for _ in range(4):
            x = torch.tanh(x @ w)
        return x

    def step(x, w):
        fwd(x, w).sum().backward()

    args = (_meta(n, n), _meta(n, n, grad=True))
    arg_bytes = 2 * n * n * f
    got = cost.analyze(fwd, *args)
    assert got["flops"] == 4 * 2 * n**3
    assert got["peak_bytes"] == arg_bytes + 5 * n * n * f          # 4 kept + 1 transient
    got = cost.analyze(step, *args)
    assert got["flops"] == 11 * 2 * n**3
    # at the first backward product: 4 kept outputs, the seed grad of the
    # last (n, n), tanh's gradient, the loss and its seed (4 bytes each)
    assert got["peak_bytes"] == arg_bytes + 6 * n * n * f + 2 * f


def test_a_checkpointed_recompute_is_counted():
    from torch.utils.checkpoint import checkpoint
    n = 64
    w = _meta(n, n, grad=True)

    def step(x, w, remat):
        f = (lambda a: torch.tanh(a @ w))
        y = checkpoint(f, x, use_reentrant=False) if remat else f(x)
        (y @ w).sum().backward()

    plain = cost.analyze(step, _meta(n, n), w, False)["flops"]
    remat = cost.analyze(step, _meta(n, n), w, True)["flops"]
    assert remat - plain == 2 * n**3


# -- against the reference's HLO walk -------------------------------------------


def _ref_flops(fn, *args) -> float:
    return hlo_analyze(jax.jit(fn).lower(*args).compile().as_text())["flops"]


def test_forward_of_yi_9b_counts_causal_pairs_only():
    """``test_hlo_cost_against_analytic_transformer``'s cell.  The port's
    forward attends through kernel 7, counted by its formula over the
    causal (query, key) pairs; the reference's attention multiplies full
    S x S score blocks and masks them.  The rest is the same products."""
    jcfg, cfg = JREG["yi-9b"].make_smoke(), REGISTRY["yi-9b"].make_smoke()
    B, S = 2, 32
    params = jax.eval_shape(lambda: jtm.init(jax.random.PRNGKey(0), jcfg))
    want = _ref_flops(lambda p, t: jtm.forward(p, jcfg, t), params, SDS((B, S), jnp.int32))
    tp = tm.init(torch.Generator().manual_seed(0), cfg, device="meta")
    got = cost.analyze(lambda p, t: tm.forward(p, cfg, t, device="meta"), tp,
                       _meta(B, S, dtype=torch.int32))
    skipped = 4 * cfg.hd * B * cfg.n_heads * cfg.n_layers * (S * S - work.attention_pairs(S, None))
    assert got["flops"] == want - skipped
    assert got["kernels"]["flash_attention"]["calls"] == cfg.n_layers
    analytic = 2 * cfg.n_params() * B * S
    assert analytic * 0.5 <= got["flops"] <= analytic * 3.0


def _lm_step_flops(arch, B, S):
    jcfg = JREG[arch].make_smoke()
    opt = joptim.adamw(weight_decay=0.1)
    params = jax.eval_shape(lambda: jtm.init(jax.random.PRNGKey(0), jcfg))
    state = jax.eval_shape(opt.init, params)

    def step(p, s, b, lr):
        loss, g = jax.value_and_grad(jtm.lm_loss)(p, jcfg, b)
        p, s = opt.update(g, s, p, lr)
        return loss, p, s

    batch = {"tokens": SDS((B, S), jnp.int32), "labels": SDS((B, S), jnp.int32)}
    return _ref_flops(step, params, state, batch, SDS((), jnp.float32))


@pytest.mark.parametrize("arch", ["gemma3-1b", "yi-9b", "granite-moe-1b-a400m"])
def test_lm_train_step_against_the_reference(arch):
    """One adamw step of ``lm_loss`` at the smoke config, B x S = 2 x 64
    (q_chunk 8).  The reference's chunked attention rematerializes each
    chunk's scores inside its scan (``jax.checkpoint`` of the chunk body),
    so its backward multiplies q k^T a second time, 2 hd flops a (query,
    key) pair of each chunk's key span; the port's keeps them."""
    B, S = 2, 64
    cfg = REGISTRY[arch].make_smoke()
    want = _lm_step_flops(arch, B, S)
    cell = steps.build(arch, "train_4k", cfg=cfg, dims={"batch": B, "seq": S})
    got = cost.analyze(cell.fn, *cell.args)
    recompute = 0
    for i in range(cfg.n_layers):
        w = cfg.window(i)
        span = S if w is None or w + cfg.q_chunk >= S else w + cfg.q_chunk
        recompute += 2 * cfg.hd * B * cfg.n_heads * S * span
    assert got["flops"] == want - recompute
    assert got["flops"] == pytest.approx(want, rel=0.05)


def test_dplr_fwfm_train_step_against_the_reference():
    """The adagrad step at the smoke config, B = 64.  The port's lookups
    are kernels 5 and 5', each counted at 2 B slots k flops; the
    reference's are jnp gathers and segment sums, which hold no product.
    Without them the two counts agree within 5% (XLA turns the tiny
    products of the DPLR diagonal into elementwise work)."""
    B = 64
    jcfg, cfg = JREG["dplr-fwfm"].make_smoke(), REGISTRY["dplr-fwfm"].make_smoke()
    opt = joptim.adagrad()
    params = jax.eval_shape(lambda: jfwfm.init(jax.random.PRNGKey(0), jcfg))
    state = jax.eval_shape(opt.init, params)

    def step(p, s, b, lr):
        loss, g = jax.value_and_grad(jfwfm.loss)(p, jcfg, b)
        p, s = opt.update(g, s, p, lr)
        return loss, p, s

    want = _ref_flops(step, params, state, jsteps._recsys_train_batch("dplr-fwfm", jcfg, B),
                      SDS((), jnp.float32))
    cell = steps.build("dplr-fwfm", "train_batch", cfg=cfg, dims={"batch": B})
    got = cost.analyze(cell.fn, *cell.args)
    lookups = 2 * B * cfg.layout.n_slots * cfg.embed_dim
    assert {k: v["flops"] for k, v in got["kernels"].items()} == {
        "embedding_bag": lookups, "embedding_bag_backward": lookups}
    assert got["flops"] - 2 * lookups == pytest.approx(want, rel=0.05)


@pytest.mark.parametrize("shape", ["molecule", "full_graph_sm", "minibatch_lg"])
def test_pna_train_step_against_the_reference(shape):
    """PNA's adamw step at the smoke widths and the shape's batch, bf16
    compute, as ``repro.launch.steps.build_gnn`` (without its mesh)."""
    jarch = JREG["pna"]
    spec = next(s for s in jarch.shapes if s.name == shape)
    jcfg = dataclasses.replace(j_shape_config(jarch.make_smoke(), spec), remat=False,
                               compute_dtype=jnp.bfloat16)
    batch, _ = jsteps._gnn_batch(spec, make_host_mesh())
    opt = joptim.adamw()
    params = jax.eval_shape(lambda: jpna.init(jax.random.PRNGKey(0), jcfg))
    state = jax.eval_shape(opt.init, params)

    def loss(p, b):
        if spec.dims["task"] == "graph":
            b = dict(b, n_graphs=spec.dims["n_graphs"])
        return jpna.loss(p, jcfg, b)

    def step(p, s, b, lr):
        value, g = jax.value_and_grad(loss)(p, b)
        p, s = opt.update(g, s, p, lr)
        return value, p, s

    want = _ref_flops(step, params, state, batch, SDS((), jnp.float32))
    cell = steps.build("pna", shape, cfg=REGISTRY["pna"].make_smoke())
    got = cost.analyze(cell.fn, *cell.args)
    assert got["flops"] == pytest.approx(want, rel=0.05)


# -- the kernels on meta ----------------------------------------------------------------


def _kernel_calls(dev, dtype):
    gen = torch.Generator().manual_seed(0)

    def t(*shape, dt=dtype):
        x = torch.randn(shape, generator=gen).to(dt)
        return x.to(dev) if dev != "meta" else torch.empty(shape, dtype=dt, device="meta")

    def ids(*shape, high):
        x = torch.randint(0, high, shape, generator=gen, dtype=torch.int32)
        return x.to(dev) if dev != "meta" else torch.empty(shape, dtype=torch.int32,
                                                           device="meta")

    f32 = torch.float32
    valid = (torch.ones(300, dtype=torch.bool) if dev != "meta"
             else torch.empty(300, dtype=torch.bool, device="meta"))
    corpus = (t(300, 3, 16), t(300), t(3, dt=f32), t(2, 3, 16, dt=f32), t(2, dt=f32), valid)
    bags = ops.bag_map(np.repeat(np.arange(4), 2), 4, dev)
    table, bag_ids, w = t(50, 8), ids(6, 8, high=50), t(6, 8)
    return {
        "dplr_corpus_score": lambda: ops.dplr_corpus_score(*corpus),
        "dplr_corpus_topk": lambda: ops.dplr_corpus_score(*corpus, topk=7),
        "dplr_corpus_score_multi": lambda: ops.dplr_corpus_score_multi(
            [t(64, 3, 16), t(128, 3, 16)], [t(64), t(128)], None, t(2, 3, dt=f32),
            t(2, 4, 3, 16, dt=f32), t(2, 4, dt=f32), topk=5),
        "dplr_score_items": lambda: ops.dplr_score_items(
            t(2, 40, 5, 16), t(3, 5, dt=f32), t(3, dt=f32), t(5, dt=f32), t(2, 3, 16, dt=f32),
            t(2, dt=f32)),
        "embedding_bag": lambda: ops.embedding_bag(table, bag_ids, w, bags),
        "embedding_bag_backward": lambda: ops.embedding_bag_backward(
            t(6, 4, 8, dt=f32), table.float(), bag_ids, w.float(), bags),
        "bag_rows_sort": lambda: ops.bag_rows_sort(bag_ids, 50),
        "fwfm_pairwise": lambda: ops.fwfm_pairwise(t(10, 6, 4), t(6, 6, dt=f32)),
        "flash_attention": lambda: ops.flash_attention(t(1, 24, 4, 16), t(1, 24, 2, 16),
                                                       t(1, 24, 2, 16), window=8),
    }


def _specs(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(o.shape), o.dtype) for o in outs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(work.FORMULAS))
def test_kernel_meta_call_returns_the_cpu_shapes_and_reports_its_work(name, dtype):
    cpu = _kernel_calls("cpu", dtype)[name]()
    calls = _kernel_calls("meta", dtype)
    ops.reset_launches()
    got = cost.analyze(calls[name])
    meta = calls[name]()
    assert _specs(meta) == _specs(cpu)
    assert all(o.is_meta for o in (meta if isinstance(meta, tuple) else (meta,)))
    assert sum(ops.LAUNCHES.values()) == 0
    bf16_entry = f"{name}_bf16" in ops.KERNELS
    want = f"{name}_bf16" if dtype == torch.bfloat16 and bf16_entry else name
    calls_of = {"dplr_corpus_score_multi": 2}.get(name, 1)
    assert set(got["kernels"]) == {want} and got["kernels"][want]["calls"] == calls_of


def test_kernel_work_is_what_the_kernels_report():
    """A kernel's reported work is ``kernel_work`` at its call's shapes:
    every slot of a meta slab counts as live (nothing can be read)."""
    got = cost.analyze(_kernel_calls("meta", torch.float32)["dplr_corpus_topk"])["kernels"]
    want = work.kernel_work("dplr_corpus_topk", n=300, live=300, Bq=2, K=7, rho=3, k=16,
                            itemsize=4, masked=True)
    assert (got["dplr_corpus_topk"]["flops"], got["dplr_corpus_topk"]["bytes"]) == want
    f16, b16 = work.kernel_work("embedding_bag_bf16", slots=10, B=2, n_bags=3, k=8,
                                itemsize=2, id_size=4)
    assert (f16, b16) == (2 * 10 * 8, 10 * (8 * 2 + 4 + 2) + 2 * 3 * 8 * 2)


def test_a_meta_training_step_counts_the_backward_kernel():
    cfg = REGISTRY["dplr-fwfm"].make_smoke()
    cell = steps.build("dplr-fwfm", "train_batch", cfg=cfg, dims={"batch": 32})
    got = cost.analyze(cell.fn, *cell.args)
    assert set(got["kernels"]) == {"embedding_bag", "embedding_bag_backward"}
    rows = cell.args[0]["embedding"].shape[0]
    assert got["kernels"]["embedding_bag_backward"]["bytes"] == (
        32 * cfg.layout.n_fields * cfg.embed_dim * 4 + 32 * cfg.layout.n_slots * 8
        + rows * cfg.embed_dim * 4)


# -- the dry run ----------------------------------------------------------------------------


def test_dryrun_writes_and_resumes_its_records(tmp_path, capsys):
    args = ["--arch", "dplr-fwfm", "--shape", "serve_p99", "--out", str(tmp_path),
            "--card-bytes", str(80 * 10**9)]
    assert dryrun.main(args) == 0
    assert dryrun.main(["--arch", "pna", "--shape", "molecule", "--out", str(tmp_path)]) == 0
    files = sorted(p.name for p in tmp_path.glob("*.json"))
    assert files == ["dplr-fwfm__serve_p99.json", "pna__molecule.json"]
    rec = json.loads((tmp_path / "dplr-fwfm__serve_p99.json").read_text())
    assert rec["ok"] and rec["fits_one_card"] and rec["card_bytes"] == 80 * 10**9
    assert rec["opt_state_bytes"] == 0 and rec["param_bytes"] > rec["input_bytes"] > 0
    assert set(rec["kernels"]) == {"embedding_bag", "dplr_score_items"}
    assert rec["peak_bytes"] >= rec["param_bytes"] + rec["input_bytes"]
    pna_rec = json.loads((tmp_path / "pna__molecule.json").read_text())
    assert pna_rec["opt_state_bytes"] == 2 * pna_rec["param_bytes"] + 4   # m, v and t
    out = capsys.readouterr().out
    assert out.count("[ok] ") == 2 and "failures: 0" in out
    # a second run reads the records back: a marked record is not recounted
    rec["flops"] = -1
    (tmp_path / "dplr-fwfm__serve_p99.json").write_text(json.dumps(rec))
    assert dryrun.run_cell("dplr-fwfm", "serve_p99", out=tmp_path)["flops"] == -1
    assert dryrun.run_cell("dplr-fwfm", "serve_p99", out=tmp_path, force=True)["flops"] > 0


def test_dryrun_records_a_cell_that_cannot_build(tmp_path):
    # a skipped cell (yi-9b's long_500k: full attention) cannot build
    rec = dryrun.run_cell("yi-9b", "long_500k", out=tmp_path, opts={"partitioned": True})
    assert not rec["ok"] and "ValueError" in rec["error"] and "N/A" in rec["error"]
    assert (tmp_path / "yi-9b__long_500k+partitioned.json").exists()
    assert dryrun.line(rec).startswith("[FAIL]")

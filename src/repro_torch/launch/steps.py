"""Every (architecture x shape) cell of the registry as a callable and its
arguments on one device: the one-card counterpart of
``repro.launch.steps``, which the dry run (``launch.dryrun``), the cost
model (``launch.cost``) and chip_smoke's dry-run phase share.

    cell = steps.build("gemma3-1b", "train_4k", device="meta")
    cost.analyze(cell.fn, *cell.args)
    cell = steps.build("dplr-fwfm", "train_batch", device="cuda", mesh=make_host_mesh(4))
    pod = make_production_mesh(device="meta")
    cell = steps.build("dplr-fwfm", "train_batch", mesh=pod)
    cost.analyze(cell.fn, *cell.args, mesh=pod, specs=cell.arg_specs())

A cell's arguments keep the reference's names, shapes and types: the
parameter and optimizer-state trees carry the checkpoint format's keys
(``params/...``, ``opt/acc/...``), batches the keys of
``_recsys_train_batch``, ``_recsys_rank_query`` and ``_gnn_batch``, and
the learning rate is a 0-d float32 tensor.  On ``device="meta"`` building
allocates nothing: parameters come from the ``init`` functions on
``meta`` (a CPU generator, ``device="meta"``), inputs are empty tensors.
On a real device the parameters are random from ``seed`` and the inputs
random within their ranges (ids below the smallest vocabulary, masks of
ones), so that a cut can be run and measured beside its count.

The families:
  * lm: the train step (``adamw(weight_decay=0.1)`` on ``lm_loss``, over
    ``n_micro = min(cfg.micro_batches, max(B // dp, 1))`` microbatches
    through ``optim.gradient_accumulation`` where that is more than one,
    under ``train.deterministic()`` as a one-batch LM step runs),
    ``prefill`` of the shape's prompt, one ``decode_step`` into the
    shape's cache, the serving cells on bf16 weights;
  * recsys: the adagrad train step, ``rank_items`` (Algorithm 1) and
    pointwise ``apply``; ``opts={"serve_bf16": True}`` serves bf16 tables;
  * gnn: PNA's adamw train step on the shape's batch, in bf16 compute;
    ``opts={"partitioned": True}`` builds a node-task shape's
    ``name+part`` cell, ``pna.loss_partitioned`` on a
    destination-partitioned batch (25% slack over an even split of the
    edges, as the reference sizes it).

``mesh`` (``launch.mesh.Mesh``): the cells as the reference builds them
on a mesh, on the port's one-process mesh, ``cell.specs`` holding the
rules the reference shards by (``sharding.rules``, ``auto_batch_specs``)
as data.  The recsys cells run data-parallel: the train step is
``train.data_parallel_step`` (each data replica's rows, the mean over
the data axes, each position's update), the pointwise and rank cells
score each replica's rows (``on_replicas``), and every arena gather is
the row-blocked lookup on the replica's model axis
(``make_auto_take``, ``embedding.sharded``).  An LM cell on a mesh of
more than one position runs the per-position program of
``models.transformer.parallel`` (``cell.plan``): its train step is
``train.lm_data_parallel_step``, its prefill and decode return the
logits joined for the caller (uncounted) and the cache in
``lm_cache_spec``'s blocks; a (1, 1) mesh builds the one-device cell.
``cell.arg_specs()`` gives ``cost.analyze(mesh=, specs=)`` a position's
blocks of the arguments (a decode cell's cache too).  The GNN batch pads
its nodes and edges to a multiple of the mesh's size.  A PNA cell on a
mesh with data replicas raises ``NotImplementedError`` naming its
ROADMAP item (``DATA_AXIS_WAITS``): it is not counted as one device.
Without a mesh every cell is one device's; ``dp`` is then 1 and
``partitioned`` and ``mp_scoring`` use a one-shard mesh.  Each cell's
``notes`` name what still waits (``SHARDING``).  The opts ``moe_scatter``
and ``moe_fused`` map onto ``moe_impl="scatter"`` and
``moe_fused_combine``; ``mp_scoring`` builds
``dplr-fwfm``'s rank cells through ``fwfm.rank_items_mp`` (``name+mp``),
as the reference does.
"""
from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Callable

import torch

from repro_torch import optim
from repro_torch.configs import registry as reg
from repro_torch.configs.pna import shape_config
from repro_torch.embedding.sharded import make_sharded_take
from repro_torch.launch import train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.gnn import pna
from repro_torch.models.gnn.sampler import subgraph_shapes
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer import parallel
from repro_torch.sharding import collectives, rules

__all__ = ["Cell", "all_cells", "auto_batch_specs", "auto_leaf_spec", "build",
           "make_auto_take", "on_replicas"]

SHARDING = ("the data axis of PNA (its node_constraint; ROADMAP item 3c-iii) waits; the recsys "
            "and LM families run on it")

# what a cell of each waiting family raises on a mesh with data replicas
DATA_AXIS_WAITS = {"gnn": "waits for ROADMAP item 3c-iii (PNA's data axis: its node_constraint)"}


@dataclasses.dataclass
class Cell:
    """One cell: ``fn(*args)`` is its step, ``kind`` the shape's kind,
    ``notes`` what the one-card build leaves out, ``specs`` the rules of
    its parameters and inputs on a mesh (empty without one)."""

    name: str
    fn: Callable
    args: tuple
    kind: str
    notes: tuple = ()
    specs: dict = dataclasses.field(default_factory=dict)
    cache: tuple | None = None      # an LM serving cell's (L, 2, B, S, KV, hd) cache
    plan: object = None             # an LM cell's per-position plan on a mesh

    def arg_specs(self) -> tuple | None:
        """The rules of ``args``, one a positional argument (``None`` for
        a scalar), as ``cost.analyze(specs=)`` takes them; None without a
        mesh."""
        if "params" not in self.specs or "batch" not in self.specs:
            return None
        if self.kind == "train":
            return (self.specs["params"], self.specs["opt_state"], self.specs["batch"], ())
        if self.kind == "decode":
            return self.specs["params"], self.specs["cache"], self.specs["batch"], ()
        return self.specs["params"], self.specs["batch"]


def _dp_size(mesh) -> int:
    return 1 if mesh is None else math.prod(mesh.shape[a] for a in rules.dp_axes(mesh))


def auto_leaf_spec(shape, mesh, min_shard: int = 1024) -> tuple:
    """The reference's rule for an input of ``shape``: its largest dim that
    the data extent divides and that is at least ``min_shard`` splits over
    the data axes; the others are not split."""
    n_dp = _dp_size(mesh)
    best, best_dim = None, min_shard - 1
    for i, d in enumerate(shape):
        if d >= max(min_shard, n_dp) and d % n_dp == 0 and d > best_dim:
            best, best_dim = i, d
    spec = [None] * len(shape)
    if best is not None:
        spec[best] = rules.dp_axes(mesh)
    return rules._spec(*spec)


def auto_batch_specs(batch: dict, mesh) -> dict:
    """``auto_leaf_spec`` of every tensor of ``batch``."""
    return {k: auto_leaf_spec(tuple(v.shape), mesh) for k, v in batch.items()}


def on_replicas(fn, mesh, inputs: dict, specs: dict, join: str):
    """``fn(rows, replica_mesh)`` on each data replica's rows of ``inputs``
    (``train.each_replica``), the outputs joined along the dim that
    ``inputs[join]`` splits (the one process's join: the reference's
    output stays split over the data axes)."""
    outs, _ = train.each_replica(fn, mesh, inputs, specs)
    if len(outs) == 1:
        return outs[0]
    dim = next((i for i, e in enumerate(specs[join]) if e is not None), None)
    if dim is None:
        raise ValueError(f"{join!r} splits over no data axis; the outputs cannot join")
    with collectives.at(collectives.OFF):
        return torch.cat(outs, dim)


def make_auto_take(mesh):
    """``take_fn`` for an arena row-blocked over ``mesh``'s model axis
    (``embedding.sharded.make_sharded_take``), the ids' rule from
    ``auto_leaf_spec`` of their shape."""

    def take_fn(table, ids):
        spec = auto_leaf_spec(tuple(ids.shape), mesh)
        return make_sharded_take(mesh, {ids.ndim: spec})(table, ids)

    return take_fn


class _Inputs:
    """Input tensors on one device: empty on ``meta``, else random from a
    seeded generator (ids uniform below ``high``, masks and weights ones,
    features normal)."""

    def __init__(self, device: torch.device, seed: int):
        self.dev = device
        self.gen = None if device.type == "meta" else torch.Generator(device).manual_seed(seed)

    def ids(self, shape, high: int, dtype=torch.int32):
        if self.gen is None:
            return torch.empty(shape, dtype=dtype, device=self.dev)
        return torch.randint(0, high, shape, generator=self.gen, device=self.dev, dtype=dtype)

    def ones(self, shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=self.dev) if self.gen is None else \
            torch.ones(shape, dtype=dtype, device=self.dev)

    def normal(self, shape, dtype=torch.float32):
        if self.gen is None:
            return torch.empty(shape, dtype=dtype, device=self.dev)
        return torch.randn(shape, generator=self.gen, device=self.dev).to(dtype)

    def scalar(self, value, dtype=torch.float32):
        if self.gen is None:
            return torch.empty((), dtype=dtype, device=self.dev)
        return torch.tensor(value, dtype=dtype, device=self.dev)


def _params(init, cfg, device: torch.device, seed: int) -> dict:
    gen = torch.Generator(device="cpu" if device.type == "meta" else device).manual_seed(seed)
    return init(gen, cfg, device=device)


def _cast(tree: dict, dtype) -> dict:
    """``tree``'s float32 leaves cast to ``dtype``."""
    return {k: _cast(v, dtype) if isinstance(v, dict) else
            v.to(dtype) if v.dtype == torch.float32 else v for k, v in tree.items()}


# -- lm ------------------------------------------------------------------------

def _refuse_data_axis(arch, shape, mesh) -> None:
    if mesh is not None and mesh.dp > 1 and arch.family in DATA_AXIS_WAITS:
        raise NotImplementedError(f"{arch.name}/{shape.name} on {mesh.dp} data replicas "
                                  f"{DATA_AXIS_WAITS[arch.family]}")


def build_lm(arch, shape, device, cfg=None, opts=None, seed=0, mesh=None) -> Cell:
    cfg = cfg or arch.make_config()
    opts = opts or {}
    if opts.get("moe_scatter") and cfg.is_moe:
        cfg = dataclasses.replace(cfg, moe_impl="scatter")
    if opts.get("moe_fused") and cfg.is_moe:
        cfg = dataclasses.replace(cfg, moe_fused_combine=True)
    if mesh is not None and mesh.size > 1:
        return _build_lm_mesh(arch, shape, device, cfg, seed, mesh)
    B, S = shape.dims["batch"], shape.dims["seq"]
    inp = _Inputs(device, seed)
    name = f"{arch.name}/{shape.name}"
    notes = (f"shardings: {SHARDING}",)
    specs = {} if mesh is None else {"params": rules.lm_param_specs(cfg, mesh)}

    if shape.kind == "train":
        optimizer = optim.adamw(weight_decay=0.1)
        params = _params(tm.init, cfg, device, seed)
        opt_state = optimizer.init(params)
        mod = train.build_lm_trainer(arch.name, cfg, B, S, seed, device)[0]
        # microbatches that each still divide the data extent, as the reference caps them
        n_micro = min(cfg.micro_batches, max(B // _dp_size(mesh), 1))

        if n_micro > 1:
            grad_fn = optim.gradient_accumulation(lambda p, b: mod.loss(p, cfg, b), n_micro)

            def train_step(params, opt_state, batch, lr):
                with train.deterministic():
                    loss, grads = grad_fn(params, batch)
                    params, opt_state = optimizer.update(grads, opt_state, params, lr)
                return loss, params, opt_state
        else:
            def train_step(params, opt_state, batch, lr):
                return train.train_step(mod, cfg, optimizer, params, opt_state, batch, lr)

        batch = {"tokens": inp.ids((B, S), cfg.vocab), "labels": inp.ids((B, S), cfg.vocab)}
        notes += (f"{n_micro} microbatch{'es' if n_micro > 1 else ''} of {B // n_micro} "
                  f"(micro_batches={cfg.micro_batches}); fsdp={cfg.fsdp} changes no "
                  f"computation with one data replica",)
        return Cell(name, train_step, (params, opt_state, batch, inp.scalar(1e-4)),
                    shape.kind, notes, specs)

    # serving carries bf16 weights (the production serving checkpoint)
    params = _cast(_params(tm.init, cfg, device, seed), torch.bfloat16)
    if shape.kind == "prefill":
        def serve_prefill(params, tokens):
            return tm.prefill(params, cfg, tokens, S, device=device)

        return Cell(name, serve_prefill, (params, inp.ids((B, S), cfg.vocab)), shape.kind,
                    notes, specs)

    cache = inp.ones((cfg.n_layers, 2, B, S, cfg.n_kv_heads, cfg.hd), torch.bfloat16)

    def serve_decode(params, cache, tokens, cache_index):
        # a meta index has no value: write the last slot (a step's work is
        # the same at every slot; its attention spans the whole cache)
        index = S - 1 if cache_index.is_meta else int(cache_index)
        return tm.decode_step(params, cfg, tokens, cache, index, device=device)

    return Cell(name, serve_decode,
                (params, cache, inp.ids((B, 1), cfg.vocab), inp.scalar(S - 1, torch.int32)),
                shape.kind, notes, specs)


def _build_lm_mesh(arch, shape, device, cfg, seed, mesh) -> Cell:
    """An LM cell on a mesh of more than one position: the per-position
    program of ``models.transformer.parallel`` (the train step
    ``train.lm_data_parallel_step``), ``cell.specs`` the reference's rules
    (``lm_param_specs``, ``lm_batch_spec`` or its tokens' rule, and
    ``lm_cache_spec``)."""
    B, S = shape.dims["batch"], shape.dims["seq"]
    inp = _Inputs(device, seed)
    dp = _dp_size(mesh)
    plan = parallel.Plan(cfg, mesh, device)
    name = f"{arch.name}/{shape.name}"
    where = ("heads" if plan.heads else "query rows") + " over model"
    kv = "" if plan.kv_whole else ", the kv heads its query heads read gathered"
    moe = "" if not cfg.is_moe else (
        ", experts over model" if rules.expert_parallel(cfg, mesh) else
        ", d_ff of every expert over model")
    notes = (f"shardings: {SHARDING}",
             f"plan on {dict(mesh.shape)}: attention {where}{kv}{moe}, vocabulary over model"
             + (", FSDP over data" if cfg.fsdp and mesh.shape.get("data", 1) > 1 else ""))
    specs = {"params": rules.lm_param_specs(cfg, mesh)}
    rows = rules.lm_batch_spec(mesh)

    if shape.kind == "train":
        params = _params(tm.init, cfg, device, seed)
        opt_state = optim.adamw(weight_decay=0.1).init(params)
        specs["opt_state"] = rules.opt_state_specs(specs["params"], opt_state)
        specs["batch"] = {"tokens": rows, "labels": rows}
        n_micro = min(cfg.micro_batches, max(B // dp, 1))
        optimizer = optim.adamw(weight_decay=0.1, clip_norm=None)

        def train_step(params, opt_state, batch, lr):
            return train.lm_data_parallel_step(plan, optimizer, params, opt_state, batch, lr,
                                               n_micro)

        batch = {"tokens": inp.ids((B, S), cfg.vocab), "labels": inp.ids((B, S), cfg.vocab)}
        notes += (f"{n_micro} microbatch{'es' if n_micro > 1 else ''} of {B // dp // n_micro} "
                  f"rows a replica (micro_batches={cfg.micro_batches})",)
        return Cell(name, train_step, (params, opt_state, batch, inp.scalar(1e-4)),
                    shape.kind, notes, specs, plan=plan)

    params = _cast(_params(tm.init, cfg, device, seed), torch.bfloat16)
    rows_split = B % dp == 0
    tok = rows if rows_split else (None, None)
    specs["batch"], specs["cache"] = tok, rules.lm_cache_spec(mesh, B)
    shape_of_cache = (cfg.n_layers, 2, B, S, cfg.n_kv_heads, cfg.hd)

    def blocks_of(cache):
        return [rules.local_block(cache, specs["cache"], mesh, p) for p in plan.pos]

    def rows_of(tokens):
        return [rules.local_block(tokens, tok, mesh, p) for p in plan.pos]

    if shape.kind == "prefill":
        if not rows_split:
            raise ValueError(f"{name}: a prefill on a mesh takes a batch that splits over "
                             f"its {dp} data replicas, not {B}")

        def serve_prefill(params, tokens):
            plan.mirror()
            with collectives.at(collectives.OFF):
                cache = torch.empty(shape_of_cache, dtype=torch.bfloat16, device=device)
            collectives.hold(cache, mesh.positions(), split=True)
            blocks = blocks_of(cache)
            plan.each(lambda i, b: b.zero_(), blocks)
            logits = plan.prefill(params, rows_of(tokens), blocks, (B, S))
            return parallel.join(plan, logits, True), cache

        return Cell(name, serve_prefill, (params, inp.ids((B, S), cfg.vocab)), shape.kind,
                    notes, specs, shape_of_cache, plan)

    cache = inp.ones(shape_of_cache, torch.bfloat16)

    def serve_decode(params, cache, tokens, cache_index):
        plan.mirror()
        index = S - 1 if cache_index.is_meta else int(cache_index)
        logits = plan.decode(params, rows_of(tokens), blocks_of(cache), index, (B, S), rows_split)
        return parallel.join(plan, logits, rows_split), cache

    return Cell(name, serve_decode,
                (params, cache, inp.ids((B, 1), cfg.vocab), inp.scalar(S - 1, torch.int32)),
                shape.kind, notes, specs, shape_of_cache, plan)


# -- recsys --------------------------------------------------------------------

def _recsys_train_batch(arch_name, cfg, B, inp: _Inputs) -> dict:
    lay = cfg.layout
    item_vocab = lay.fields[-1].vocab_size
    if arch_name == "mind":
        return {"hist_ids": inp.ids((B, cfg.seq_len), item_vocab),
                "hist_mask": inp.ones((B, cfg.seq_len)),
                "target_id": inp.ids((B,), item_vocab),
                "neg_ids": inp.ids((B, cfg.n_neg), item_vocab)}
    vocab = min(f.vocab_size for f in lay.fields)
    batch = {"ids": inp.ids((B, lay.n_slots), vocab),
             "weights": inp.ones((B, lay.n_slots)),
             "label": inp.ids((B,), 2, torch.float32)}
    if arch_name == "bst":
        batch["hist_ids"] = inp.ids((B, cfg.seq_len), item_vocab)
        batch["hist_mask"] = inp.ones((B, cfg.seq_len))
    return batch


def _recsys_rank_query(arch_name, cfg, n_queries, n_items, inp: _Inputs) -> dict:
    lay = cfg.layout
    ctx, item = lay.subset("context"), lay.subset("item")
    vocab = min(f.vocab_size for f in lay.fields)
    item_vocab = lay.fields[-1].vocab_size
    q = {"context_ids": inp.ids((n_queries, ctx.n_slots), vocab),
         "context_weights": inp.ones((n_queries, ctx.n_slots)),
         "item_ids": inp.ids((n_queries, n_items, item.n_slots), vocab),
         "item_weights": inp.ones((n_queries, n_items, item.n_slots))}
    if arch_name in ("bst", "mind"):
        q["hist_ids"] = inp.ids((n_queries, cfg.seq_len), item_vocab)
        q["hist_mask"] = inp.ones((n_queries, cfg.seq_len))
    if arch_name == "mind":
        q.pop("context_ids"), q.pop("context_weights")
        q.pop("item_weights")
    return q


def build_recsys(arch, shape, device, cfg=None, opts=None, seed=0, mesh=None) -> Cell:
    opts = opts or {}
    mod = train.recsys_module(arch.name)
    cfg = cfg or arch.make_config()
    params = _params(mod.init, cfg, device, seed)
    inp = _Inputs(device, seed)
    name = f"{arch.name}/{shape.name}"
    notes = (f"shardings: {SHARDING}",)
    if opts.get("serve_bf16") and shape.kind in ("rank", "pointwise"):
        params = _cast(params, torch.bfloat16)
    # without a mesh, one device's cell; on one, the data-parallel cell whose
    # arena gathers are the row-blocked lookup (embedding.sharded)
    specs = {} if mesh is None else {"params": rules.recsys_param_specs(params, mesh)}

    if shape.kind == "train":
        optimizer = optim.adagrad()
        opt_state = optimizer.init(params)
        batch = _recsys_train_batch(arch.name, cfg, shape.dims["batch"], inp)
        if mesh is None:
            def train_step(params, opt_state, batch, lr):
                return train.train_step(mod, cfg, optimizer, params, opt_state, batch, lr)
        else:
            specs["opt_state"] = rules.opt_state_specs(specs["params"], opt_state)
            specs["batch"] = auto_batch_specs(batch, mesh)

            def train_step(params, opt_state, batch, lr):
                return train.data_parallel_step(mod, cfg, optimizer, params, opt_state, batch,
                                                lr, mesh=mesh, batch_specs=specs["batch"])

        return Cell(name, train_step, (params, opt_state, batch, inp.scalar(0.05)),
                    shape.kind, notes, specs)

    if shape.kind == "pointwise":
        batch = _recsys_train_batch(arch.name, cfg, shape.dims["batch"], inp)
        batch.pop("label", None)
        if arch.name == "mind":
            batch.pop("neg_ids")
        if mesh is None:
            def serve_pointwise(params, batch):
                return mod.apply(params, cfg, batch)
        else:
            specs["batch"] = auto_batch_specs(batch, mesh)

            def apply_rows(params, rows, sub):
                # MIND's apply takes no take_fn, in the reference either
                take = {} if arch.name == "mind" else {"take_fn": make_auto_take(sub)}
                return mod.apply(params, cfg, rows, **take)

            def serve_pointwise(params, batch):
                return on_replicas(lambda rows, sub: apply_rows(params, rows, sub), mesh,
                                   batch, specs["batch"], next(iter(batch)))

        return Cell(name, serve_pointwise, (params, batch), shape.kind, notes, specs)

    query = _recsys_rank_query(arch.name, cfg, shape.dims["n_queries"],
                               shape.dims["n_items"], inp)
    if mesh is not None:
        specs["batch"] = auto_batch_specs(query, mesh)
    if opts.get("mp_scoring") and arch.name == "dplr-fwfm":
        # the rank-rho projection inside each arena block's lookup: the
        # partials summed over the model axis are (rho k + 2) floats an item
        if mesh is None:
            def serve_rank_mp(params, query):
                return mod.rank_items_mp(params, cfg, query,
                                         mesh=make_host_mesh(1, device=device))
        else:
            def serve_rank_mp(params, query):
                return on_replicas(lambda q, sub: mod.rank_items_mp(params, cfg, q, mesh=sub),
                                   mesh, query, specs["batch"], "item_ids")

        return Cell(f"{name}+mp", serve_rank_mp, (params, query), shape.kind, notes, specs)

    if mesh is None:
        def serve_rank(params, query):
            return mod.rank_items(params, cfg, query)
    else:
        def serve_rank(params, query):
            return on_replicas(lambda q, sub: mod.rank_items(params, cfg, q,
                                                             take_fn=make_auto_take(sub)),
                               mesh, query, specs["batch"], "item_ids")

    return Cell(name, serve_rank, (params, query), shape.kind, notes, specs)


# -- gnn -----------------------------------------------------------------------

def gnn_sizes(shape) -> tuple[int, int]:
    """(nodes, edges) of a shape's batch on one card (no mesh padding)."""
    d = shape.dims
    if shape.name == "minibatch_lg":
        return subgraph_shapes(d["batch_nodes"], tuple(d["fanouts"]), d["d_feat"])
    if shape.name == "molecule":
        return d["n_graphs"] * d["nodes_per_graph"], d["n_graphs"] * d["edges_per_graph"]
    return d["n_nodes"], d["n_edges"]


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _gnn_batch(shape, inp: _Inputs, total: int = 1) -> dict:
    """The shape's batch, nodes and edges padded to a multiple of ``total``
    (a mesh's size): padded edges masked, padded nodes unlabelled."""
    d = shape.dims
    n_nodes, n_edges = gnn_sizes(shape)
    n_nodes_p, n_edges_p = _pad_to(n_nodes, total), _pad_to(n_edges, total)
    graph = d["task"] == "graph"
    n_labels = d["n_graphs"] if graph else n_nodes_p
    batch = {"node_feat": inp.normal((n_nodes_p, d["d_feat"])),
             "edge_src": inp.ids((n_edges_p,), n_nodes),
             "edge_dst": inp.ids((n_edges_p,), n_nodes),
             "edge_mask": inp.ones((n_edges_p,)),
             "labels": inp.ids((n_labels,), d["n_classes"]),
             "label_mask": inp.ones((n_labels,))}
    if graph:
        batch["graph_ids"] = inp.ids((n_nodes_p,), d["n_graphs"])
    if inp.gen is not None:
        batch["edge_mask"][n_edges:] = 0
        if not graph:
            batch["label_mask"][n_nodes:] = 0
    return batch


def _part_batch(shape, inp: _Inputs, total: int) -> dict:
    """A destination-partitioned node-task batch over ``total`` shards:
    ``e_loc`` edges a shard, 25% over an even split (the reference's
    slack for skew), each pointing into its shard's nodes."""
    d = shape.dims
    n_nodes, n_edges = gnn_sizes(shape)
    n_nodes_p, n_edges_p = _pad_to(n_nodes, total), _pad_to(n_edges, total)
    e_loc = -(-int(n_edges_p * 1.25) // total)
    return {"node_feat": inp.normal((n_nodes_p, d["d_feat"])),
            "src_global": inp.ids((total * e_loc,), n_nodes),
            "dst_local": inp.ids((total * e_loc,), n_nodes_p // total),
            "edge_mask": inp.ones((total * e_loc,)),
            "labels": inp.ids((n_nodes_p,), d["n_classes"]),
            "label_mask": inp.ones((n_nodes_p,))}


def build_gnn(arch, shape, device, cfg=None, opts=None, seed=0, mesh=None) -> Cell:
    _refuse_data_axis(arch, shape, mesh)
    base = cfg or arch.make_config()
    # node_constraint stays None: the one-process mesh keeps each tensor whole
    cfg = dataclasses.replace(shape_config(base, shape), remat=False,
                              compute_dtype=torch.bfloat16)
    optimizer = optim.adamw()
    params = _params(pna.init, cfg, device, seed)
    opt_state = optimizer.init(params)
    inp = _Inputs(device, seed)
    total = 1 if mesh is None else math.prod(mesh.shape.values())
    notes = (f"shardings: {SHARDING}",)
    specs = {} if mesh is None else {"params": rules.gnn_param_specs(params, mesh)}

    if (opts or {}).get("partitioned") and shape.dims["task"] == "node":
        part_mesh = mesh or make_host_mesh(1, device=device)
        axes = tuple(part_mesh.axis_names)
        batch = _part_batch(shape, inp, math.prod(part_mesh.shape.values()))

        def loss(params, cfg, batch):
            return pna.loss_partitioned(params, cfg, batch, mesh=part_mesh, axes=axes)

        name = f"{arch.name}/{shape.name}+part"
    else:
        batch = _gnn_batch(shape, inp, total)
        graphs = shape.dims.get("n_graphs") if shape.dims["task"] == "graph" else None

        def loss(params, cfg, batch):
            return pna.loss(params, cfg,
                            batch if graphs is None else dict(batch, n_graphs=graphs))

        name = f"{arch.name}/{shape.name}"
    mod = SimpleNamespace(loss=loss)

    def train_step(params, opt_state, batch, lr):
        return train.train_step(mod, cfg, optimizer, params, opt_state, batch, lr)

    return Cell(name, train_step, (params, opt_state, batch, inp.scalar(1e-3)), shape.kind,
                notes, specs)


# -- dispatch ------------------------------------------------------------------

_BUILDERS = {"lm": build_lm, "recsys": build_recsys, "gnn": build_gnn}


def build(arch_name: str, shape_name: str, device="meta", cfg=None, opts=None,
          dims: dict | None = None, seed: int = 0, mesh=None) -> Cell:
    """The cell ``arch_name/shape_name`` on ``device`` (``meta`` by
    default: nothing allocated).  ``cfg``: a config in place of the
    architecture's (a cut in depth); ``dims``: entries of the shape's
    ``dims`` replaced (a cut in batch or length), named in the cell's
    name and notes; ``seed``: the parameters' and inputs' draws on a real
    device; ``mesh``: the one-process mesh the cell runs on (module
    docstring), whose first device should be ``device``."""
    arch = reg.get(arch_name)
    shape = next(s for s in arch.shapes if s.name == shape_name)
    if shape.skip:
        raise ValueError(f"{arch_name}/{shape_name} is N/A: {shape.skip}")
    if dims:
        shape = dataclasses.replace(shape, dims={**shape.dims, **dims})
    cell = _BUILDERS[arch.family](arch, shape, torch.device(device), cfg=cfg, opts=opts,
                                  seed=seed, mesh=mesh)
    if dims:
        cut = ", ".join(f"{k}={v}" for k, v in dims.items())
        cell.name += f" [{cut}]"
        cell.notes += (f"cut: {cut}",)
    return cell


def all_cells(include_skipped: bool = False):
    """(arch, shape name, shape) of every registry cell, skipped ones only
    when asked."""
    for arch in reg.REGISTRY.values():
        for shape in arch.shapes:
            if shape.skip and not include_skipped:
                continue
            yield arch.name, shape.name, shape

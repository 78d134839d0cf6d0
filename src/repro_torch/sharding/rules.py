"""Per-family parameter and activation partition rules.  Port of
``repro.sharding.rules``.

A rule is a plain tuple with one entry per tensor axis, the port's
counterpart of ``jax.sharding.PartitionSpec``: ``None`` for an axis that
is not split, a mesh axis name for one that is split over it, and a
tuple of names for one split over several (one name alone stands bare,
no names is ``None``, as ``PartitionSpec`` normalizes them).
``tuple(P(...))`` of the reference's spec is the port's rule, entry for
entry.

Mesh axes: ``("data", "model")`` on one pod, ``("pod", "data", "model")``
across pods (``launch.mesh``).  ``pod`` and ``data`` are data
parallelism; ``model`` carries tensor, expert, vocabulary and
embedding-row parallelism, and the item corpus's slots
(``serving.sharded``).

Conventions, as in the reference: LM params are stacked (L, ...) and dim
0 is never split; column-parallel matmuls feed row-parallel ones; the
optimizer state mirrors the parameters; in the recsys family only the
embedding arenas are split (by rows), the dense parts replicate.
"""
from __future__ import annotations

import math


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_size(mesh) -> int:
    return mesh.shape["model"]


def _spec(*entries) -> tuple:
    """A rule from its entries, normalized as ``PartitionSpec`` does: a
    tuple of one axis name becomes the name, an empty tuple ``None``."""
    def norm(e):
        if isinstance(e, tuple):
            return None if not e else e[0] if len(e) == 1 else e
        return e
    return tuple(norm(e) for e in entries)


def _replicated(ndim: int) -> tuple:
    return (None,) * ndim


def entry_axes(entry) -> tuple:
    """The mesh axes a rule's entry names (none for ``None``)."""
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one position's block of a tensor of ``shape`` under the
    rule ``spec``: each dim divided by the product of the sizes of the
    axes its entry names (axes the mesh lacks count 1).  A dim they do not
    divide raises ``ValueError``."""
    out = []
    for d, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        n = 1
        for a in entry_axes(entry):
            n *= mesh.shape.get(a, 1)
        if d % n:
            raise ValueError(f"a dim of {d} does not split over {entry!r} ({n} positions)")
        out.append(d // n)
    return tuple(out)


def block_index(entry, mesh, position: tuple) -> tuple[int, int]:
    """(index, count) of ``position``'s block along a dim whose rule entry
    is ``entry``: its row-major index over the entry's axes, and their
    positions (axes the mesh lacks count 1)."""
    index, n = 0, 1
    for a in entry_axes(entry):
        if a in mesh.shape:
            index = index * mesh.shape[a] + position[mesh.axis_names.index(a)]
            n *= mesh.shape[a]
    return index, n


def block_range(length: int, entry, mesh, position: tuple) -> tuple[int, int]:
    """(start, stop) of ``position``'s block of a dim of ``length`` under
    ``entry``."""
    index, n = block_index(entry, mesh, position)
    size = length // n
    return index * size, (index + 1) * size


def local_block(t, spec, mesh, position: tuple):
    """The view of ``t`` that ``position`` (a mesh position's coordinates)
    holds under ``spec``: along each split dim the block whose index is the
    position's row-major index over that entry's axes."""
    for dim, entry in enumerate(spec):
        lo, hi = block_range(t.shape[dim], entry, mesh, position)
        if hi - lo != t.shape[dim]:
            t = t.narrow(dim, lo, hi - lo)
    return t


def _zip_leaves(tree, specs):
    """(leaf, rule) of a tree of dicts and lists and its rules, nested alike."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _zip_leaves(tree[k], specs[k])
    elif isinstance(tree, list):
        for t, s in zip(tree, specs):
            yield from _zip_leaves(t, s)
    else:
        yield tree, specs


def local_bytes(tree, specs, mesh) -> int:
    """Bytes of one position's blocks of every tensor of ``tree`` under its
    rules ``specs`` (nested as the tree; the blocks of an even split are
    alike at every position)."""
    total = 0
    for leaf, spec in _zip_leaves(tree, specs):
        if hasattr(leaf, "shape"):
            total += math.prod(local_shape(tuple(leaf.shape), spec, mesh)) * \
                leaf.element_size()
    return total


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def lm_param_specs(cfg, mesh) -> dict:
    """The LM's parameter rules; with ``cfg.fsdp`` the non-TP dim of each
    large weight also splits over ``data``."""
    m = model_size(mesh)
    fs = "data" if getattr(cfg, "fsdp", False) else None
    layers = {
        "ln_attn": (None, None),
        "wq": (None, fs, "model"),
        "wk": (None, fs, "model"),
        "wv": (None, fs, "model"),
        "wo": (None, "model", fs),
        "ln_mlp": (None, None),
    }
    if cfg.is_moe:
        layers["router"] = (None, None, None)
        if cfg.n_experts % m == 0:
            # expert parallelism: each device owns E/m whole experts
            layers["w_gate"] = (None, "model", fs, None)
            layers["w_in"] = (None, "model", fs, None)
            layers["w_out"] = (None, "model", None, fs)
        else:
            # tensor parallelism inside each expert
            layers["w_gate"] = (None, None, fs, "model")
            layers["w_in"] = (None, None, fs, "model")
            layers["w_out"] = (None, None, "model", fs)
    else:
        if cfg.mlp_type in ("swiglu", "geglu"):
            layers["w_gate"] = (None, fs, "model")
        layers["w_in"] = (None, fs, "model")
        layers["w_out"] = (None, "model", fs)
    specs = {"embed": ("model", fs), "layers": layers, "final_ln": (None,)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (fs, "model")
    return specs


def lm_batch_spec(mesh) -> tuple:
    return _spec(dp_axes(mesh), None)


def lm_cache_spec(mesh, batch: int) -> tuple:
    """KV cache (L, 2, B, S, KV, hd): the batch splits over the data axes
    when it divides; otherwise (batch 1, long context) the sequence splits
    over every mesh axis."""
    dp = dp_axes(mesh)
    n_dp = 1
    for a in dp:
        n_dp *= mesh.shape[a]
    if batch % n_dp == 0 and batch >= n_dp:
        return _spec(None, None, dp, "model", None, None)
    return _spec(None, None, None, tuple(mesh.axis_names), None, None)


# The LM plan on the model axis (``models.transformer.parallel``): data, not
# compute.

def heads_split(cfg, mesh) -> bool:
    """Whether the query heads split whole over the model axis (else the
    attention of a train or prefill cell splits its query rows)."""
    return cfg.n_heads % model_size(mesh) == 0


def position_heads(cfg, mesh, j: int) -> tuple[int, int]:
    """(first, stop) of the query heads that model position ``j`` owns when
    they split whole: the heads of its block of ``wq``'s columns."""
    n = cfg.n_heads // model_size(mesh)
    return j * n, (j + 1) * n


def kv_heads_read(cfg, heads: tuple[int, int]) -> tuple[int, int]:
    """(first, stop) of the kv heads that the query heads ``heads`` read:
    head ``h`` reads kv head ``h // (H // KV)``."""
    group = cfg.n_heads // cfg.n_kv_heads
    return heads[0] // group, (heads[1] - 1) // group + 1


def kv_split(cfg, mesh) -> bool:
    """Whether each position's block of ``wk``/``wv``'s columns is whole kv
    heads, the ones its query heads read (else it gathers those)."""
    return heads_split(cfg, mesh) and cfg.n_kv_heads % model_size(mesh) == 0


def expert_parallel(cfg, mesh) -> bool:
    """Whether each model position owns whole experts (``E % m == 0``);
    else every position holds ``d_ff / m`` of every expert."""
    return cfg.n_experts % model_size(mesh) == 0


def position_experts(cfg, mesh, j: int) -> tuple[int, int]:
    """(first, stop) of the experts that model position ``j`` owns."""
    n = cfg.n_experts // model_size(mesh)
    return j * n, (j + 1) * n


def cache_block(mesh, batch: int, max_seq: int, position: tuple) -> dict:
    """``position``'s block of an (L, 2, B, S, KV, hd) cache under
    ``lm_cache_spec``: ``rows`` and ``seq``, each (start, stop)."""
    spec = lm_cache_spec(mesh, batch)
    return {"rows": block_range(batch, spec[2], mesh, position),
            "seq": block_range(max_seq, spec[3], mesh, position)}


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

def _map_named(fn, tree, name=None):
    """``fn(name, leaf)`` over nested dicts and lists; ``name`` is the
    leaf's last key (``"[i]"`` for a list entry, as the reference's path
    prints it)."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, f"[{i}]") for i, v in enumerate(tree))
    return fn(name, tree)


def recsys_param_specs(params_shape: dict, mesh) -> dict:
    """Arena tensors (``embedding``, ``linear``, ``wide``) split by rows;
    everything else replicated.  ``params_shape``: a param tree (tensors,
    ``meta`` tensors included, or anything with ``ndim``)."""

    def spec_for(name, leaf):
        if name == "embedding":
            return ("model", None)
        if name in ("linear", "wide"):
            return ("model",)
        return _replicated(leaf.ndim)

    return _map_named(spec_for, params_shape)


# ---------------------------------------------------------------------------
# Serving corpus (the mutable item slab)
# ---------------------------------------------------------------------------

def corpus_slab_axis() -> str:
    """The mesh axis that carries the corpus slab's shards: ``model``.
    Replicas scale over ``data``/``pod``; ``model`` scales the capacity,
    each shard holding capacity/D slots."""
    return "model"


def corpus_cache_specs(mesh):
    """Rules for a sharded ``ItemCorpusCache`` in the physical
    ``(local, D, ...)`` view of ``serving.sharded``: axis 0 the
    shard-local slot, axis 1 the owning shard (split over the model
    axis).  Global slot ``g`` lives at ``(g // D, g % D)``."""
    from repro_torch.serving.corpus import ItemCorpusCache
    ax = corpus_slab_axis()
    return ItemCorpusCache(
        Q_I=(None, ax, None, None),     # (local, D, rho, k)
        t_I=(None, ax),                 # (local, D)
        lin_I=(None, ax),               # (local, D)
        valid=(None, ax),               # (local, D)
        a_I=(None, ax),                 # (local, D)
    )


def corpus_slab_spec(mesh) -> tuple:
    """Rule for the physical id/weight slabs ``(local, D, n_slots)``."""
    return (None, corpus_slab_axis(), None)


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

def gnn_param_specs(params_shape: dict, mesh) -> dict:
    return _map_named(lambda _, leaf: _replicated(leaf.ndim), params_shape)


# ---------------------------------------------------------------------------
# Optimizer state
# ---------------------------------------------------------------------------

def opt_state_specs(param_specs, opt_state_shape) -> dict:
    """The parameter rules mirrored onto ``m``/``v``/``acc``/``mom``; any
    other entry (a step count) replicated, ``()`` for each leaf."""
    out = {}
    for key, val in opt_state_shape.items():
        if key in ("m", "v", "acc", "mom"):
            out[key] = param_specs
        else:
            out[key] = _map_named(lambda _, leaf: (), val)
    return out

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

"""Principal Neighbourhood Aggregation (Corso et al. 2020, arXiv:2004.05718).
Port of ``repro.models.gnn.pna``.

Assigned config: 4 layers, d_hidden=75, aggregators {mean, max, min, std},
scalers {identity, amplification, attenuation}.

The gather -> message -> segment-reduce pipeline, as in the JAX package:

    h_src, h_dst = h[edge_src], h[edge_dst]            # gather
    m = relu(W_pre [h_src || h_dst])                   # per-edge message
    agg = [segment_mean, segment_min, segment_max, segment_std]  # reduce
    out = W_post [h || scalers (x) aggs]               # 1 + 3*4 blocks

The segment sums are ``index_add_`` and the segment maxima
``scatter_reduce_(..., "amax")`` into a tensor of -inf; a node without an
unmasked edge ends at 0 on every aggregator.  On the card ``index_add_``
adds with float atomics, so two runs may differ in the last bits: no
result here is bitwise repeatable on the card (the reference's example
keeps no checkpoints either).  No Pallas kernel sits on this path in the
reference, so none here: the products are ``torch.matmul``.

Scalers use log(deg+1) normalised by delta, the mean log-degree over the
batch's nodes, padded nodes included.

Batch dict (block-diagonal batching for multi-graph inputs), tensors on
the parameters' device:
    node_feat (N, F)  edge_src (E,)  edge_dst (E,)
    labels (N,) or (G,)   label_mask   graph_ids (N,) and n_graphs [graph task]
Padding convention: padded edges point at node 0 with edge_mask 0; padded
nodes have label_mask 0.

``remat`` checkpoints each layer through ``torch.utils.checkpoint``;
``node_constraint`` is applied to the node states at the layer
boundaries, as in the JAX package (which passes a sharding constraint
there).

``forward_partitioned``/``loss_partitioned`` run PNA over a
destination-partitioned graph (``sampler.partition_graph``) on a
one-process mesh (``launch.mesh``): shard s owns a contiguous block of
nodes and the edges that point into it, and works on ``mesh.devices[s]``.
Every scatter is then local to its shard; each layer's one cross-shard
step is the all-gather of the node states (their concatenation, moved to
each shard's device), and the scalers' mean log-degree is the sum of the
shards' partial sums over the global node count.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import init_device
from repro_torch.models.layers import apply_mlp, glorot, init_mlp


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    d_feat: int
    d_hidden: int = 75
    n_layers: int = 4
    n_classes: int = 7
    task: str = "node"            # node | graph
    dtype: Any = torch.float32
    # checkpoint each PNA layer: the backward recomputes a layer's
    # internals instead of keeping its (E, d) and (N, d) buffers alive
    remat: bool = False
    # node_constraint(h) -> h: applied to the (N, ...) node states at the
    # layer boundaries (the JAX package's sharding-constraint hook)
    node_constraint: Any = None
    # activation dtype (params and the loss stay f32)
    compute_dtype: Any = torch.float32

    @property
    def n_agg_blocks(self) -> int:
        return 4 * 3              # aggregators x scalers


def init(generator: torch.Generator, cfg: PNAConfig, device=None) -> dict:
    """Random parameters on ``device`` (default: the generator's), in the
    JAX package's tree: ``encoder``, ``decoder/layer_i/{w,b}``,
    ``layer_i/{w_pre, b_pre, w_post, b_post}``."""
    d, dev = cfg.d_hidden, init_device(generator, device)
    layers = {}
    for i in range(cfg.n_layers):
        layers[f"layer_{i}"] = {
            "w_pre": glorot(generator, (2 * d, d), cfg.dtype, dev),
            "b_pre": torch.zeros((d,), dtype=cfg.dtype, device=dev),
            "w_post": glorot(generator, ((1 + cfg.n_agg_blocks) * d, d), cfg.dtype, dev),
            "b_post": torch.zeros((d,), dtype=cfg.dtype, device=dev),
        }
    return {
        "encoder": glorot(generator, (cfg.d_feat, d), cfg.dtype, dev),
        "decoder": init_mlp(generator, [d, d, cfg.n_classes], cfg.dtype, dev),
        **layers,
    }


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    return x.new_zeros((n, *x.shape[1:])).index_add_(0, seg, x)


def _segment_max(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Per-segment maximum of ``x (E, d)``; -inf where a segment is empty
    (``jax.ops.segment_max``'s identity).  Ties share the gradient evenly,
    as in JAX."""
    out = torch.full((n, *x.shape[1:]), float("-inf"), dtype=x.dtype, device=x.device)
    return out.scatter_reduce(0, seg[:, None].expand_as(x), x, "amax", include_self=True)


def _segment_agg(m: torch.Tensor, dst: torch.Tensor, n_nodes: int, edge_mask):
    """mean/min/max/std per destination node.  m: (E, d)."""
    w = edge_mask[:, None].to(m.dtype)
    mw = m * w
    deg = _segment_sum(edge_mask.to(m.dtype), dst, n_nodes)
    denom = torch.clamp_min(deg, 1.0)[:, None]
    s1 = _segment_sum(mw, dst, n_nodes)
    s2 = _segment_sum(mw * m, dst, n_nodes)
    mean = s1 / denom
    # torch.maximum splits the gradient of a tie (a one-edge node's 0
    # variance) as jnp.maximum does; clamp_min would pass all of it
    var = torch.maximum(s2 / denom - mean * mean, torch.zeros((), dtype=m.dtype,
                                                              device=m.device))
    std = torch.sqrt(var + 1e-5)
    big = torch.tensor(1e30, dtype=m.dtype, device=m.device)   # bf16 keeps it finite
    mmax = _segment_max(torch.where(w > 0, m, -big), dst, n_nodes)
    mmin = -_segment_max(torch.where(w > 0, -m, -big), dst, n_nodes)
    has_edge = (deg > 0)[:, None]
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    mmax = torch.where(has_edge, mmax, zero)
    mmin = torch.where(has_edge, mmin, zero)
    return torch.cat([mean, mmax, mmin, std], dim=-1), deg


def _pna_layer(lp: dict, cfg: PNAConfig, h, edge_src, edge_dst, edge_mask):
    cdt = cfg.compute_dtype
    lp = {name: p.to(cdt) for name, p in lp.items()}
    n_nodes = h.shape[0]
    h_s = h[edge_src]
    h_d = h[edge_dst]
    m = F.relu(torch.cat([h_s, h_d], -1) @ lp["w_pre"] + lp["b_pre"])
    agg, deg = _segment_agg(m, edge_dst, n_nodes, edge_mask)        # (N, 4d)
    logd = torch.log1p(deg)
    floor = torch.tensor(1e-2, dtype=logd.dtype, device=logd.device)
    delta = torch.maximum(logd.mean(), floor)
    amp = (logd / delta)[:, None]
    att = (delta / torch.maximum(logd, floor))[:, None]
    scaled = torch.cat([agg, agg * amp.to(agg.dtype), agg * att.to(agg.dtype)], dim=-1)
    out = torch.cat([h, scaled.to(cdt)], -1) @ lp["w_post"] + lp["b_post"]
    return h + F.relu(out)     # residual (PNA uses skip connections)


def forward(params: dict, cfg: PNAConfig, batch: dict) -> torch.Tensor:
    """Logits ``(N, n_classes)`` (node task) or ``(n_graphs, n_classes)``
    (graph task) in the compute dtype."""
    cdt = cfg.compute_dtype
    h = batch["node_feat"].to(cdt) @ params["encoder"].to(cdt)
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    edge_mask = batch.get("edge_mask")
    if edge_mask is None:
        edge_mask = torch.ones(src.shape, dtype=torch.float32, device=src.device)
    constrain = cfg.node_constraint or (lambda x: x)
    h = constrain(h)
    for i in range(cfg.n_layers):
        lp = params[f"layer_{i}"]
        if cfg.remat and torch.is_grad_enabled():
            h = checkpoint(_pna_layer, lp, cfg, h, src, dst, edge_mask, use_reentrant=False)
        else:
            h = _pna_layer(lp, cfg, h, src, dst, edge_mask)
        h = constrain(h)
    if cfg.task == "graph":
        n_graphs = int(batch["n_graphs"])
        gid = batch["graph_ids"].long()
        cnt = _segment_sum(torch.ones(h.shape[0], dtype=h.dtype, device=h.device), gid,
                           n_graphs)
        pooled = _segment_sum(h, gid, n_graphs)
        h = pooled / torch.clamp_min(cnt, 1.0)[:, None].to(h.dtype)
    dec = {name: {k: p.to(cdt) for k, p in layer.items()}
           for name, layer in params["decoder"].items()}
    return apply_mlp(dec, h)


def loss(params: dict, cfg: PNAConfig, batch: dict) -> torch.Tensor:
    """Masked mean cross-entropy over the labelled nodes (or graphs), f32."""
    return _cross_entropy(forward(params, cfg, batch).float(), batch)


def _cross_entropy(logits, batch: dict) -> torch.Tensor:
    labels = batch["labels"].long()
    mask = batch.get("label_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    per = (logz - gold) * mask
    return per.sum() / torch.clamp_min(mask.sum(), 1.0)


# -- destination-partitioned message passing -----------------------------------

def forward_partitioned(params: dict, cfg: PNAConfig, batch: dict, *, mesh,
                        axes: tuple = ("data", "model")) -> torch.Tensor:
    """Node logits ``(N_p, n_classes)`` on ``mesh.devices[0]`` for a
    destination-partitioned graph over ``mesh``'s D shards (node task).

    batch: ``node_feat (N_p, F)``, ``src_global``/``dst_local``/``edge_mask``
    ``(D * e_loc,)`` laid out shard-major by ``sampler.partition_graph``
    (shard s's edges point into its nodes ``[s N_p/D, (s+1) N_p/D)``,
    ``dst_local`` counted from the block's first node), ``labels`` and
    ``label_mask``.  ``axes``: the mesh axes the nodes split over (the
    reference's), whose sizes multiply to D.  Each layer, shard s gathers
    its edges' sources from the concatenated node states of all shards on
    its device, sums its messages into its own nodes, and takes the global
    mean log-degree from the shards' partial sums (added in shard order on
    the first device)."""
    D = math.prod(mesh.shape[a] for a in axes)
    devs = mesh.devices
    if D != len(devs):
        raise ValueError(f"axes {axes} hold {D} positions, the mesh places {len(devs)}")
    N = batch["node_feat"].shape[0]
    E = batch["src_global"].shape[0]
    if N % D or E % D:
        raise ValueError(f"{N} nodes and {E} edges do not split into {D} shards")
    n_loc, e_loc = N // D, E // D
    cdt, first = cfg.compute_dtype, devs[0]
    enc = params["encoder"]
    hs, edges = [], []
    for s, dev in enumerate(devs):
        part = slice(s * e_loc, (s + 1) * e_loc)
        edges.append((batch["src_global"][part].to(dev).long(),
                      batch["dst_local"][part].to(dev).long(),
                      batch["edge_mask"][part].to(dev)))
        hs.append(batch["node_feat"][s * n_loc:(s + 1) * n_loc].to(dev).to(cdt)
                  @ enc.to(device=dev, dtype=cdt))
    for i in range(cfg.n_layers):
        lps = [{k: p.to(device=dev, dtype=cdt) for k, p in params[f"layer_{i}"].items()}
               for dev in devs]
        msgs = []
        for s, dev in enumerate(devs):
            src, dst, emask = edges[s]
            h_full = torch.cat([h.to(dev) for h in hs])            # the all-gather
            h_s, h_d = h_full[src], hs[s][dst]                       # dst is local by layout
            lp = lps[s]
            m = F.relu(torch.cat([h_s, h_d], -1) @ lp["w_pre"] + lp["b_pre"])
            msgs.append(_segment_agg(m, dst, n_loc, emask))
        logds = [torch.log1p(deg) for _, deg in msgs]
        # the mean log-degree over the global graph: the shards' partial sums
        # (in float32, as the reference divides by its float32 node count)
        dsum = functools.reduce(torch.add, (ld.sum().to(first) for ld in logds))
        delta = torch.clamp_min(dsum.float() / N, 1e-2)
        new = []
        for s, dev in enumerate(devs):
            (agg, _), logd, lp = msgs[s], logds[s], lps[s]
            dl = delta.to(dev)
            floor = torch.tensor(1e-2, dtype=logd.dtype, device=dev)
            amp = (logd.float() / dl)[:, None]
            att = (dl / torch.maximum(logd, floor).float())[:, None]
            scaled = torch.cat([agg, agg * amp.to(agg.dtype), agg * att.to(agg.dtype)], dim=-1)
            out = torch.cat([hs[s], scaled.to(cdt)], -1) @ lp["w_post"] + lp["b_post"]
            new.append(hs[s] + F.relu(out))
        hs = new
    logits = []
    for h, dev in zip(hs, devs):
        dec = {name: {k: p.to(device=dev, dtype=cdt) for k, p in layer.items()}
               for name, layer in params["decoder"].items()}
        logits.append(apply_mlp(dec, h).to(first))
    return torch.cat(logits)


def loss_partitioned(params: dict, cfg: PNAConfig, batch: dict, *, mesh,
                     axes: tuple = ("data", "model")) -> torch.Tensor:
    """``loss`` over a destination-partitioned graph (``forward_partitioned``)."""
    logits = forward_partitioned(params, cfg, batch, mesh=mesh, axes=axes).float()
    return _cross_entropy(logits, {k: batch[k].to(logits.device) for k in
                                   ("labels", "label_mask") if k in batch})

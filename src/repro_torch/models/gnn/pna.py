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

Not ported: ``forward_partitioned``/``loss_partitioned`` and the config's
``node_constraint`` (ROADMAP: sharding).  ``remat`` checkpoints each
layer through ``torch.utils.checkpoint``.
"""
from __future__ import annotations

import dataclasses
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
    for i in range(cfg.n_layers):
        lp = params[f"layer_{i}"]
        if cfg.remat and torch.is_grad_enabled():
            h = checkpoint(_pna_layer, lp, cfg, h, src, dst, edge_mask, use_reentrant=False)
        else:
            h = _pna_layer(lp, cfg, h, src, dst, edge_mask)
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
    logits = forward(params, cfg, batch).float()
    labels = batch["labels"].long()
    mask = batch.get("label_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    per = (logz - gold) * mask
    return per.sum() / torch.clamp_min(mask.sum(), 1.0)

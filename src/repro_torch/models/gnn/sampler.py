"""Layer-wise neighbour sampling (GraphSAGE-style) for minibatch GNN
training.  Port of ``repro.models.gnn.sampler``: numpy only, a copy of
the JAX package's functions (and of ``partition_graph`` from its
``models/gnn/pna.py``), so for the same ``np.random.Generator`` every
output is bitwise the reference's.

The full graph lives host-side as numpy CSR; each step samples a fixed
fanout per hop around a seed batch and emits a PADDED, static-shape
subgraph (static for the reference's jit; the port keeps them).  Fanout
``(15, 10)`` with ``batch_nodes=1024`` gives static shapes:

    nodes <= 1024 * (1 + 15 + 150)   edges <= 1024 * (15 + 150)

Padded edges point at node 0 with edge_mask=0; only seed nodes carry
label_mask=1 (loss is computed on seeds, standard for sampled training).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray     # (N+1,)
    indices: np.ndarray    # (E,)
    node_feat: np.ndarray  # (N, F)
    labels: np.ndarray     # (N,)

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1


def random_graph(rng: np.random.Generator, n_nodes: int, avg_degree: int,
                 d_feat: int, n_classes: int) -> CSRGraph:
    """Synthetic power-law-ish graph for tests/benchmarks."""
    deg = np.minimum(
        rng.zipf(1.7, n_nodes).astype(np.int64), 10 * avg_degree
    )
    deg = np.maximum((deg * avg_degree / max(deg.mean(), 1)).astype(np.int64), 1)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    indices = rng.integers(0, n_nodes, indptr[-1]).astype(np.int32)
    feat = rng.standard_normal((n_nodes, d_feat), dtype=np.float32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    return CSRGraph(indptr.astype(np.int64), indices, feat, labels)


def sample_subgraph(g: CSRGraph, seeds: np.ndarray, fanouts: tuple[int, ...],
                    rng: np.random.Generator) -> dict:
    """Sample a fixed-fanout neighborhood; return padded static arrays.

    Edge direction: sampled neighbor -> frontier node (messages flow toward
    seeds), matching PNA's dst-aggregation.
    """
    b = len(seeds)
    # static capacities
    caps = [b]
    for f in fanouts:
        caps.append(caps[-1] * f)
    max_nodes = sum(caps)
    max_edges = sum(caps[1:])

    node_ids = np.zeros(max_nodes, np.int64)
    node_ids[:b] = seeds
    n_nodes = b
    src_buf = np.zeros(max_edges, np.int32)
    dst_buf = np.zeros(max_edges, np.int32)
    mask_buf = np.zeros(max_edges, np.float32)
    n_edges = 0

    frontier_start, frontier_len = 0, b
    for hop, f in enumerate(fanouts):
        frontier = node_ids[frontier_start : frontier_start + frontier_len]
        starts = g.indptr[frontier]
        degs = g.indptr[frontier + 1] - starts
        # sample f neighbors per frontier node (with replacement; deg 0 skipped)
        offs = (rng.random((frontier_len, f)) * np.maximum(degs, 1)[:, None]).astype(np.int64)
        nbrs = g.indices[starts[:, None] + offs]          # (flen, f)
        valid = (degs > 0)[:, None] & np.ones((1, f), bool)
        flat_nbrs = nbrs.reshape(-1)
        flat_valid = valid.reshape(-1)
        cnt = frontier_len * f
        new_start = n_nodes
        node_ids[new_start : new_start + cnt] = flat_nbrs
        # edges: neighbor (local new idx) -> frontier node (local idx)
        src_local = np.arange(new_start, new_start + cnt, dtype=np.int32)
        dst_local = np.repeat(
            np.arange(frontier_start, frontier_start + frontier_len, dtype=np.int32), f)
        src_buf[n_edges : n_edges + cnt] = src_local
        dst_buf[n_edges : n_edges + cnt] = dst_local
        mask_buf[n_edges : n_edges + cnt] = flat_valid.astype(np.float32)
        n_edges += cnt
        frontier_start, frontier_len = new_start, cnt
        n_nodes = new_start + cnt

    feat = g.node_feat[node_ids]
    labels = g.labels[node_ids].astype(np.int32)
    label_mask = np.zeros(max_nodes, np.float32)
    label_mask[:b] = 1.0
    return {
        "node_feat": feat,
        "edge_src": src_buf,
        "edge_dst": dst_buf,
        "edge_mask": mask_buf,
        "labels": labels,
        "label_mask": label_mask,
    }


def subgraph_shapes(batch_nodes: int, fanouts: tuple[int, ...], d_feat: int):
    """Static (n_nodes, n_edges) of the padded subgraph."""
    caps = [batch_nodes]
    for f in fanouts:
        caps.append(caps[-1] * f)
    return sum(caps), sum(caps[1:])


def partition_graph(edge_src, edge_dst, n_nodes_padded: int, n_shards: int):
    """Sort edges by owner(dst); pad per-shard to the max count (the
    host-side step of the reference's destination-partitioned PNA).

    Returns dict with (n_shards * e_loc,) flat arrays laid out shard-major:
    ``src_global``, ``dst_local``, ``edge_mask`` and the static e_loc.
    """
    rows_per = n_nodes_padded // n_shards
    owner = edge_dst // rows_per
    order = np.argsort(owner, kind="stable")
    src_s, dst_s, owner_s = edge_src[order], edge_dst[order], owner[order]
    counts = np.bincount(owner_s, minlength=n_shards)
    e_loc = int(counts.max())
    src_out = np.zeros((n_shards, e_loc), np.int32)
    dst_out = np.zeros((n_shards, e_loc), np.int32)
    mask_out = np.zeros((n_shards, e_loc), np.float32)
    start = 0
    for s in range(n_shards):
        c = counts[s]
        src_out[s, :c] = src_s[start:start + c]
        dst_out[s, :c] = dst_s[start:start + c] - s * rows_per
        mask_out[s, :c] = 1.0
        start += c
    return {"src_global": src_out.reshape(-1),
            "dst_local": dst_out.reshape(-1),
            "edge_mask": mask_out.reshape(-1)}, e_loc

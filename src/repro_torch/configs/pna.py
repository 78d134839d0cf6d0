"""pna [arXiv:2004.05718] (``repro.configs.pna``): 4 layers, d_hidden=75,
aggregators mean/max/min/std, scalers identity/amplification/attenuation.

The four shapes change d_feat / n_classes / task, so the config is
specialised per shape via ``shape_config`` (base hyperparameters fixed).
Shapes (pad nodes/edges are masked):

  full_graph_sm  Cora:        2,708 nodes /    10,556 edges / d=1433 / 7 cls
  minibatch_lg   Reddit:    232,965 nodes / 114.6M edges - sampled subgraph
                 (1024 seeds, fanout 15-10) / d=602 / 41 cls
  ogb_products   2,449,029 nodes / 61.86M edges / d=100 / 47 cls (full batch;
                 the reference runs it over a mesh: ROADMAP, sharding)
  molecule       128 graphs x 30 nodes / 64 edges, graph classification
"""
import dataclasses

from repro_torch.configs.spec import ShapeSpec
from repro_torch.models.gnn.pna import PNAConfig

SHAPES = (
    ShapeSpec("full_graph_sm", "graph",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
               "n_classes": 7, "task": "node"}),
    ShapeSpec("minibatch_lg", "graph",
              {"batch_nodes": 1024, "fanouts": (15, 10), "d_feat": 602,
               "n_classes": 41, "task": "node",
               "global_nodes": 232_965, "global_edges": 114_615_892}),
    ShapeSpec("ogb_products", "graph",
              {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100,
               "n_classes": 47, "task": "node"}),
    ShapeSpec("molecule", "graph",
              {"n_graphs": 128, "nodes_per_graph": 30, "edges_per_graph": 64,
               "d_feat": 16, "n_classes": 2, "task": "graph"}),
)


def make_config() -> PNAConfig:
    return PNAConfig(d_feat=100, d_hidden=75, n_layers=4, n_classes=47)


def make_smoke() -> PNAConfig:
    return PNAConfig(d_feat=12, d_hidden=16, n_layers=2, n_classes=5)


def shape_config(base: PNAConfig, shape: ShapeSpec) -> PNAConfig:
    return dataclasses.replace(
        base, d_feat=shape.dims["d_feat"], n_classes=shape.dims["n_classes"],
        task=shape.dims["task"])

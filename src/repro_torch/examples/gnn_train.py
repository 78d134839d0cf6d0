"""PNA minibatch training with the neighbour sampler (GraphSAGE-style
fanout sampling) on a synthetic power-law graph.  Port of the JAX
package's ``examples/gnn_train.py``: the same arguments, graph, planted
signal and numpy draws, adamw at lr 1e-3, plus ``--device``.

    PYTHONPATH=src python -m repro_torch.examples.gnn_train [--steps 100] [--device cpu]

Runs on the card unless ``--device`` names another device.  The JAX
package's trainer sends the gnn family here (``launch.train --arch pna``).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import optim
from repro_torch.device import resolve_device
from repro_torch.launch.train import to_device
from repro_torch.models.gnn import pna, sampler


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--nodes", type=int, default=20000)
    ap.add_argument("--batch-nodes", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    rng = np.random.default_rng(0)
    g = sampler.random_graph(rng, args.nodes, avg_degree=10, d_feat=32, n_classes=8)
    # plant signal: label = argmax of a linear map of features
    W = rng.standard_normal((32, 8)).astype(np.float32)
    g.labels = (g.node_feat @ W).argmax(1).astype(np.int32)

    cfg = pna.PNAConfig(d_feat=32, d_hidden=48, n_layers=2, n_classes=8)
    params = pna.init(torch.Generator(device=dev).manual_seed(0), cfg)
    opt = optim.adamw()
    state = opt.init(params)
    grad_fn = optim.value_and_grad(pna.loss)

    losses = []
    for s in range(args.steps):
        seeds = rng.integers(0, args.nodes, args.batch_nodes)
        batch = to_device(sampler.sample_subgraph(g, seeds, (10, 5), rng), dev)
        loss, grads = grad_fn(params, cfg, batch)
        params, state = opt.update(grads, state, params, 1e-3)
        losses.append(float(loss))
        if (s + 1) % 20 == 0:
            with torch.no_grad():
                logits = pna.forward(params, cfg, batch)
            seed = batch["label_mask"] > 0
            acc = float((logits.argmax(-1) == batch["labels"])[seed].float().mean())
            print(f"step {s+1:4d}  loss {losses[-1]:.4f}  seed-acc {acc:.3f}", flush=True)
    return losses


if __name__ == "__main__":
    main()

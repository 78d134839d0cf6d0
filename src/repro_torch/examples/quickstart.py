"""Quickstart: train a DPLR-FwFM on synthetic CTR data, compare it with the
baselines (FM, full FwFM, pruned FwFM), then rank an auction with the
paper's Algorithm 1.  Port of the JAX package's ``examples/quickstart.py``
at its widths: ``uniform_layout(10, 9, 500)``, k = 8, rank 2, 300 adagrad
steps of B = 1,024 at lr 0.1 a model, 20,000 held-out rows, 1,000
candidates.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Runs on the card unless ``--device`` names another device.  There every
field lookup is the embedding-bag kernel (its backward the bag-backward
kernel in training), the full and pruned FwFM's pairwise term the
``fwfm_pairwise`` kernel, and Algorithm 1's item step the
``dplr_score_items`` kernel.  ``--steps`` and ``--rank-steps`` set the
training lengths (the reference's 300 and 100).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools

import numpy as np
import torch

from repro_torch import optim
from repro_torch.core.fields import uniform_layout
from repro_torch.core.pruning import prune_matched
from repro_torch.data.synthetic_ctr import SyntheticCTR
from repro_torch.device import resolve_device
from repro_torch.launch.train import to_device, train_step
from repro_torch.models.recsys import fwfm


def train(cfg, data, steps=300, batch=1024, lr=0.1, params=None, device=None, losses=None):
    """``steps`` adagrad steps on ``data.batch(batch, step)`` from
    ``params`` (default: ``fwfm.init`` from seed 0 on ``device``); each
    step's loss is appended to ``losses`` where a list is given.  Returns
    the trained params."""
    dev = resolve_device(device)
    if params is None:
        params = fwfm.init(torch.Generator(device=dev).manual_seed(0), cfg)
    opt = optim.adagrad()
    state = opt.init(params)
    for s in range(steps):
        loss, params, state = train_step(fwfm, cfg, opt, params, state,
                                         to_device(data.batch(batch, s), dev), lr)
        if losses is not None:
            losses.append(float(loss))
        if (s + 1) % 100 == 0:
            print(f"  step {s+1}: loss {float(loss):.4f}", flush=True)
    return params


def auc(labels, scores):
    order = np.argsort(scores)
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels > 0
    n_pos, n_neg = pos.sum(), (~pos).sum()
    return (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def make_layout():
    return uniform_layout(10, 9, 500)        # 10 context + 9 item fields


def configs(layout) -> list:
    """(name, config) of the three trained models, as the reference."""
    base = fwfm.FwFMConfig(layout=layout, embed_dim=8, interaction="dplr", rank=2)
    return [("fm", dataclasses.replace(base, interaction="fm")),
            ("fwfm", dataclasses.replace(base, interaction="fwfm")),
            ("dplr(r=2)", base)]


def make_data(layout):
    return SyntheticCTR(layout, embed_dim=4, teacher_rank=2, noise_scale=0.3, seed=0)


def run(steps=300, rank_steps=100, device=None, init=None, losses=None) -> dict:
    """The reference's ``main`` as a function: ``init(cfg)`` gives each
    training's starting params (default ``fwfm.init`` from seed 0, as the
    reference draws each from ``PRNGKey(0)``); ``losses``, a dict, gets
    each training's losses under its name (``"rank"`` for Algorithm 1's
    model).  Returns ``{"auc": {name: AUC}, "top5": ids, "scores": the
    auction's (1, 1000) scores, "params": {name: params}}``."""
    dev = resolve_device(device)
    if init is None:
        init = lambda cfg: fwfm.init(torch.Generator(device=dev).manual_seed(0), cfg)  # noqa: E731
    layout = make_layout()
    data = make_data(layout)
    # the four trainings draw the same seeds: each batch is drawn once
    data.batch = functools.cache(data.batch)
    ev = to_device(data.batch(20000, 10**6), dev)
    losses = {} if losses is None else losses

    results, trained = {}, {}
    for name, cfg in configs(layout):
        print(f"training {name} ...", flush=True)
        params = train(cfg, data, steps=steps, params=init(cfg), device=dev,
                       losses=losses.setdefault(name, []))
        with torch.no_grad():
            scores = fwfm.apply(params, cfg, ev)
        results[name] = auc(ev["label"].cpu().numpy(), scores.cpu().numpy())
        trained[name] = params
        if name == "fwfm":
            fwfm_params, fwfm_cfg = params, cfg

    # pruned FwFM at the rank-2-equivalent parameter budget (Table 1 protocol)
    R = fwfm.field_matrix(fwfm_params, fwfm_cfg)
    pruned = prune_matched(R, layout.n_fields, rank=2)
    with torch.no_grad():
        scores = fwfm.apply(fwfm_params, fwfm_cfg, ev, pruned_mask=pruned.mask)
    results["pruned(r=2-eq)"] = auc(ev["label"].cpu().numpy(), scores.cpu().numpy())

    print("\nAUC:")
    for k, v in results.items():
        print(f"  {k:15s} {v:.4f}")

    # --- Algorithm 1: rank one auction of 1000 items ------------------------
    cfg = configs(layout)[-1][1]
    params = train(cfg, data, steps=rank_steps, params=init(cfg), device=dev,
                   losses=losses.setdefault("rank", []))
    q = to_device(data.ranking_query(1000, 0), dev)
    with torch.no_grad():
        scores = fwfm.rank_items(params, cfg, q)
    top = np.argsort(-scores[0].cpu().numpy(), kind="stable")[:5]
    print(f"\ntop-5 of 1000 candidates (context cached once): {top}", flush=True)
    trained["rank"] = params
    return {"auc": results, "top5": top, "scores": scores, "params": trained}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300, help="adagrad steps a model")
    ap.add_argument("--rank-steps", type=int, default=100,
                    help="steps of the model Algorithm 1 ranks with")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    return run(args.steps, args.rank_steps, dev)


if __name__ == "__main__":
    main()

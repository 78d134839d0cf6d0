"""Serving driver of the port: a ranking service answering "score the
corpus (or these N candidates) for this context" queries.

    PYTHONPATH=src python -m repro_torch.launch.serve --config full \
        --engine corpus|percall --items N --queries Q [--topk K] [--device cuda]

``--engine corpus`` (the default) serves through ``CorpusRankingEngine``:
the item side is precomputed once into a capacity-padded slab, and each
query costs its context cache plus O(rho k) per item, through the
``dplr_corpus_score`` kernel (``--topk K``: only the (1, K) winners leave
it).  ``--engine percall`` is Algorithm 1 per query (``fwfm.rank_items``
through the ``dplr_score_items`` kernel), the baseline that gathers and
projects every candidate on every query.  Weights are random, from
``--seed``; items and contexts come from ``SyntheticCTR``.  Prints the
same latency line as ``repro.launch.serve``; the first two queries are
dropped as warm-up.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import dplr_fwfm
from repro_torch.data.synthetic_ctr import SyntheticCTR
from repro_torch.device import resolve_device
from repro_torch.models.recsys import fwfm
from repro_torch.serving.corpus import next_pow2
from repro_torch.serving.engine import CorpusRankingEngine


def _report(tag: str, lat: np.ndarray, queries: int, items: int) -> None:
    if lat.size == 0:   # fewer queries than the 2 warm-up drops
        print(f"{queries} queries x {items} items ({tag}): "
              f"too few queries for latency percentiles")
        return
    print(f"{queries} queries x {items} items ({tag}): "
          f"avg {lat.mean():.2f} ms  P95 {np.percentile(lat, 95):.2f} ms  "
          f"P99 {np.percentile(lat, 99):.2f} ms")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--engine", default="corpus", choices=["corpus", "percall"],
                    help="corpus = precomputed item slab; percall = Algorithm 1 "
                         "per query")
    ap.add_argument("--items", type=int, default=512)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--topk", type=int, default=0,
                    help="corpus engine: fused top-K, only (1, K) leaves the scorer")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.topk and args.engine != "corpus":
        ap.error("--topk requires --engine corpus")

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = dplr_fwfm.make_smoke() if args.config == "smoke" else dplr_fwfm.make_config()
    params = fwfm.init(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    data = SyntheticCTR(cfg.layout, embed_dim=4, seed=args.seed)

    lat = []
    if args.engine == "corpus":
        corpus = data.ranking_query(args.items, 0)
        engine = CorpusRankingEngine(cfg, corpus["item_ids"][0], corpus["item_weights"][0],
                                     capacity=next_pow2(args.items), device=dev)
        engine.refresh(params)
        for s in range(args.queries):
            q = data.context_query(s)
            ctx = torch.as_tensor(q["context_ids"], device=dev)
            ctx_w = torch.as_tensor(q["context_weights"], device=dev)
            t0 = time.perf_counter()
            if args.topk:
                out = engine.topk(ctx, args.topk, ctx_w)
            else:
                out = engine.score(ctx, ctx_w)
            _sync(dev)
            lat.append((time.perf_counter() - t0) * 1e3)
            if s == 0:
                top = (out[1][0][:3] if args.topk
                       else torch.argsort(out[0], descending=True, stable=True)[:3])
                print(f"query 0: top-3 of {args.items} candidates -> "
                      f"{top.cpu().numpy()}")
        tag = f"corpus{f', top{args.topk}' if args.topk else ''}, {dev.type}"
    else:
        for s in range(args.queries):
            q = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.ranking_query(args.items, s).items()}
            t0 = time.perf_counter()
            scores = fwfm.rank_items(params, cfg, q)
            _sync(dev)
            lat.append((time.perf_counter() - t0) * 1e3)
            if s == 0:
                top = torch.argsort(scores[0], descending=True, stable=True)[:3]
                print(f"query 0: top-3 of {args.items} candidates -> {top.cpu().numpy()}")
        tag = f"percall, {dev.type}"
    _report(tag, np.asarray(lat[2:]), args.queries, args.items)


if __name__ == "__main__":
    main()

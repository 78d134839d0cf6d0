"""Offline ranking-quality harness: one quality code path for the
pointwise graph and the serving graph.  Port of ``repro.eval.harness``.

Two workloads, mirroring the model's two scoring entry points
(``fwfm.apply`` pointwise, ``fwfm.rank_items`` and serving per query):

* **Pointwise**: held-out ``SyntheticCTR`` rows scored through
  ``fwfm.apply`` (on the card: the ``embedding_bag`` kernel, and for
  full or pruned FwFM the ``fwfm_pairwise`` kernel); ``evaluate_pointwise``
  reports exact AUC / log-loss / calibration, ``evaluate_streaming`` the
  bounded-memory variant through ``MetricAccumulator``.  Inputs are
  validated and cast once (ids -> int32, weights -> ``cfg.dtype``, labels
  checked binary).

* **Ranking**: a fixed candidate corpus and Q query contexts with
  teacher-derived relevance (``ranking_eval_set``), scored three ways:
  ``model_scores`` (Algorithm 1 through ``fwfm.rank_items``),
  ``engine_scores`` (``CorpusState.score``) and ``frontend_scores``
  (full-depth ``QueryFrontend`` top-K).  ``serving_parity`` runs all
  paths on identical queries and reports per-path metrics, the largest
  score difference and whether the scores are bitwise equal.

Everything runs on the device of the parameters (``cuda`` for a model on
the card); results come back as numpy, as in the JAX package.  Nothing is
traced, so nothing here counts retraces.

Relevance labels are deterministic functions of the generator's teacher:
graded relevance is the teacher CTR ``sigmoid(phi*(x)/T)``; binary
relevance marks the items above the per-query median teacher logit
(exactly n/2 positives per query, never degenerate).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data.synthetic_ctr import SyntheticCTR
from repro_torch.eval import metrics as M
from repro_torch.models.recsys import fwfm
from repro_torch.serving.engine import CorpusState
from repro_torch.serving.frontend import QueryFrontend


def _validate_labels(labels: np.ndarray) -> np.ndarray:
    y = np.asarray(labels)
    bad = ~((y == 0) | (y == 1))
    if bad.any():
        raise ValueError(f"labels must be binary 0/1; found {y[bad].ravel()[:5]}")
    return y.astype(np.int32)


# -- pointwise evaluation ----------------------------------------------------

def score_split(params, cfg, data: SyntheticCTR, *, n: int = 20000,
                seed: int = 10**6, batch_size: int = 4096,
                pruned_mask=None) -> tuple[np.ndarray, np.ndarray]:
    """(labels int32 (n,), logits f32 (n,)) for the held-out split: the
    deterministic ``data.batch(n, seed)`` draw, scored through
    ``fwfm.apply`` ``batch_size`` rows at a time on the parameters'
    device.  Nothing is traced, so the last chunk is scored at its own
    size (the JAX package pads it to one shape)."""
    b = data.batch(n, seed)
    labels = _validate_labels(b["label"])
    dev = params["embedding"].device
    ids = torch.as_tensor(np.asarray(b["ids"], np.int32), device=dev)
    w = torch.as_tensor(np.asarray(b["weights"], np.float32), dtype=cfg.dtype, device=dev)
    outs = [fwfm.apply(params, cfg, {"ids": ids[i:i + batch_size],
                                     "weights": w[i:i + batch_size]},
                       pruned_mask=pruned_mask)
            for i in range(0, n, batch_size)]
    logits = (torch.cat(outs).to(torch.float32).cpu().numpy() if outs
              else np.zeros(0, np.float32))
    return labels, logits


def evaluate_pointwise(params, cfg, data: SyntheticCTR, *, n: int = 20000,
                       seed: int = 10**6, batch_size: int = 4096,
                       pruned_mask=None) -> dict:
    """Exact pointwise metrics on the held-out split, computed on the
    parameters' device: {n, auc, logloss, calibration_ratio}."""
    labels, logits = score_split(params, cfg, data, n=n, seed=seed,
                                 batch_size=batch_size, pruned_mask=pruned_mask)
    dev = params["embedding"].device
    y, z = torch.as_tensor(labels, device=dev), torch.as_tensor(logits, device=dev)
    return {
        "n": int(n),
        "auc": float(M.auc(y, z)),
        "logloss": float(M.logloss(y, z)),
        "calibration_ratio": float(M.calibration_ratio(y, z)),
    }


def evaluate_streaming(params, cfg, data: SyntheticCTR, *, n: int = 20000,
                       seed: int = 10**6, batch_size: int = 4096,
                       pruned_mask=None, n_bins: int = M.DEFAULT_BINS) -> dict:
    """Bounded-memory pointwise evaluation: per-chunk partials folded by
    ``MetricAccumulator`` (AUC is the order-invariant binned stream)."""
    labels, logits = score_split(params, cfg, data, n=n, seed=seed,
                                 batch_size=batch_size, pruned_mask=pruned_mask)
    dev = params["embedding"].device
    acc = M.MetricAccumulator(n_bins=n_bins)
    for i in range(0, n, batch_size):
        acc.update(torch.as_tensor(labels[i:i + batch_size], device=dev),
                   torch.as_tensor(logits[i:i + batch_size], device=dev))
    return acc.result()


# -- ranking evaluation (model graph vs serving graph) -----------------------

@dataclasses.dataclass(frozen=True)
class RankingEvalSet:
    """Q query contexts against one fixed n-item candidate corpus, with
    deterministic teacher relevance (graded + per-query-median binary)."""
    context_ids: np.ndarray       # (Q, n_ctx_slots) int32
    context_weights: np.ndarray   # (Q, n_ctx_slots) f32
    item_ids: np.ndarray          # (n, n_item_slots) int32
    item_weights: np.ndarray      # (n, n_item_slots) f32
    rel: np.ndarray               # (Q, n) f32 graded (teacher CTR)
    rel01: np.ndarray             # (Q, n) f32 binary (above-median logit)

    @property
    def n_queries(self) -> int:
        return self.context_ids.shape[0]

    @property
    def n_items(self) -> int:
        return self.item_ids.shape[0]

    def query(self, device="cpu", dtype=torch.float32) -> dict:
        """The (Q, n) batched query dict ``fwfm.rank_items`` takes, as
        tensors on ``device`` (the items broadcast over the queries)."""
        Q, n = self.n_queries, self.n_items
        item_ids = torch.as_tensor(self.item_ids, device=device)
        item_w = torch.as_tensor(self.item_weights, dtype=dtype, device=device)
        return {
            "context_ids": torch.as_tensor(self.context_ids, device=device),
            "context_weights": torch.as_tensor(self.context_weights, dtype=dtype,
                                               device=device),
            "item_ids": item_ids.expand(Q, n, -1),
            "item_weights": item_w.expand(Q, n, -1),
        }


def ranking_eval_set(data: SyntheticCTR, *, n_queries: int = 8,
                     n_items: int = 64, seed: int = 0) -> RankingEvalSet:
    """Build the held-out ranking workload from the generator's teacher."""
    rq = data.ranking_query(n_items, seed)
    item_ids = np.asarray(rq["item_ids"][0], np.int32)        # (n, mI)
    item_w = np.asarray(rq["item_weights"][0], np.float32)
    ctxs = [data.context_query(seed + 1 + i) for i in range(n_queries)]
    ctx_ids = np.concatenate([c["context_ids"] for c in ctxs]).astype(np.int32)
    ctx_w = np.concatenate([c["context_weights"] for c in ctxs])

    # teacher logits for every (context, item) pair, as full rows in
    # layout slot order (context slots first, as fwfm.rank_items requires)
    Q, n = n_queries, n_items
    full_ids = np.concatenate(
        [np.broadcast_to(ctx_ids[:, None], (Q, n, ctx_ids.shape[1])),
         np.broadcast_to(item_ids[None], (Q, n, item_ids.shape[1]))],
        axis=-1).reshape(Q * n, -1)
    full_w = np.ones_like(full_ids, np.float32)
    z = (data.logits(full_ids, full_w) / data.temperature).reshape(Q, n)
    rel = (1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    med = np.median(z, axis=-1, keepdims=True)
    rel01 = (z > med).astype(np.float32)
    return RankingEvalSet(ctx_ids, ctx_w, item_ids, item_w, rel, rel01)


def model_scores(params, cfg, eval_set: RankingEvalSet, pruned=None) -> np.ndarray:
    """(Q, n) f32 scores through ``fwfm.rank_items`` (Algorithm 1; for
    ``pruned``, the pruned FwFM's cached form) on the parameters' device."""
    q = eval_set.query(params["embedding"].device, cfg.dtype)
    return fwfm.rank_items(params, cfg, q, pruned=pruned).to(torch.float32).cpu().numpy()


def engine_scores(engine, eval_set: RankingEvalSet) -> np.ndarray:
    """(Q, n) f32 scores through the corpus engine (slots are insertion-
    ordered, so the leading n slab columns ARE the eval-set items)."""
    out = engine.score(eval_set.context_ids, eval_set.context_weights)
    return out.to(torch.float32).cpu().numpy()[:, :eval_set.n_items]


def frontend_scores(frontend, eval_set: RankingEvalSet) -> np.ndarray:
    """(Q, n) f32 scores reassembled from full-depth frontend top-K
    replies (k = n, so every slot's score comes back exactly once)."""
    n = eval_set.n_items
    pending = [frontend.submit(eval_set.context_ids[i], eval_set.context_weights[i], k=n)
               for i in range(eval_set.n_queries)]
    out = np.zeros((eval_set.n_queries, n), np.float32)
    for i, p in enumerate(pending):
        scores, slots = p.result()
        out[i, np.asarray(slots)] = np.asarray(scores, np.float32)
    return out


def ranking_metrics(scores: np.ndarray, eval_set: RankingEvalSet, *, k: int = 10) -> dict:
    """Ranking metrics of a (Q, n) score matrix against the eval set:
    graded nDCG, binary precision/recall/MRR."""
    s = torch.as_tensor(np.asarray(scores, np.float32))
    rel = torch.as_tensor(eval_set.rel)
    rel01 = torch.as_tensor(eval_set.rel01)
    return {
        f"ndcg@{k}": float(M.ndcg_at_k(rel, s, k=k)),
        f"precision@{k}": float(M.precision_at_k(rel01, s, k=k)),
        f"recall@{k}": float(M.recall_at_k(rel01, s, k=k)),
        "mrr": float(M.mrr(rel01, s)),
    }


def serving_parity(params, cfg, eval_set: RankingEvalSet, *, k: int = 10, mesh=None,
                   use_frontend: bool = True, max_batch: int = 8) -> dict:
    """Score the eval set through every serving path and report parity.

    Returns per-path metrics plus score-level divergence:
        paths           {"model": metrics, "engine": metrics, ...}
        max_abs_diff    {"engine": float, "frontend": float}  (vs model)
        bit_exact       {"engine": bool, "frontend": bool}
        scores          {"model": (Q, n) f32, "engine": ..., "frontend": ...}

    The paths run on the parameters' device; with ``mesh`` the engine's
    slab is sharded over it (``serving.sharded``; the mesh's first device
    is the parameters').  Unlike the JAX package's
    report there is no ``retraces`` entry and no ``assert_no_retrace``:
    nothing is traced.  ``bit_exact`` is a report, not a promise: on the
    card the model path (``embedding_bag`` + ``dplr_score_items``) and the
    engine path (``embedding_bag`` + the corpus kernel on the cached slab)
    sum the same score in different orders.  The frontend's ``k = n``
    reply goes through the top-K entry point, which takes any ``n`` on
    either device."""
    n = eval_set.n_items
    engine = CorpusState(cfg, eval_set.item_ids, eval_set.item_weights, mesh=mesh,
                         device=params["embedding"].device if mesh is None else None)
    engine.refresh(params)
    frontend = None
    if use_frontend:
        frontend = QueryFrontend(engine, max_batch=max_batch, max_k=n, max_wait=1e9,
                                 auto_pump=False)
        frontend.warmup(eval_set.context_ids[0], eval_set.context_weights[0])

    m = model_scores(params, cfg, eval_set)
    e = engine_scores(engine, eval_set)
    f = frontend_scores(frontend, eval_set) if use_frontend else None
    if frontend is not None:
        frontend.close()

    report = {
        "paths": {"model": ranking_metrics(m, eval_set, k=k),
                  "engine": ranking_metrics(e, eval_set, k=k)},
        "max_abs_diff": {"engine": float(np.abs(m - e).max())},
        "bit_exact": {"engine": bool(np.array_equal(m, e))},
        "scores": {"model": m, "engine": e},
    }
    if f is not None:
        report["paths"]["frontend"] = ranking_metrics(f, eval_set, k=k)
        report["max_abs_diff"]["frontend"] = float(np.abs(m - f).max())
        report["bit_exact"]["frontend"] = bool(np.array_equal(m, f))
        report["scores"]["frontend"] = f
    return report

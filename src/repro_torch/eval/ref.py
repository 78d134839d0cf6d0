"""Pure-numpy float64 oracles for ``repro_torch.eval.metrics``: the port's
own copy of ``repro.eval.ref`` (numpy only, so copied, not imported).

One oracle per metric entry point, declared in ``ORACLES`` below, the
same convention as ``kernels/ref.py``.

Shared conventions (both sides implement EXACTLY these):

* a positive is ``label > 0``; labels may arrive as float 0/1 or int;
* ranking inputs are ``(B, n)`` — B queries over n candidates; ties are
  broken by a STABLE descending sort (lowest index wins), which
  ``torch.sort(descending=True, stable=True)`` and
  ``np.argsort(-s, kind="stable")`` agree on;
* degenerate inputs are defined, not errors: empty -> AUC 0.5,
  logloss 0.0, calibration 1.0, ranking metrics 0.0; single-class AUC
  is 0.5; a zero-relevance query contributes 0 to nDCG/recall/MRR;
* ``precision@k``/``recall@k``/``nDCG@k`` rank the top ``min(k, n)``;
* the streaming-AUC histograms bin FLOAT32 sigmoid probabilities (the
  dtype the torch side computes in); a 1-ulp sigmoid difference between
  torch and numpy can move a count to an adjacent bin, so histogram
  parity is exact on counts/sums and tolerance-bounded on the binned AUC.

Oracles compute in float64 (numpy default); the torch side computes in
float32, with exact integer counts — parity is bounded by f32 rounding,
within 1e-6 (see tests/test_torch_eval.py).
"""
from __future__ import annotations

import numpy as np

DEFAULT_BINS = 2048


def _ranks_avg(scores: np.ndarray) -> np.ndarray:
    """1-based ranks with ties averaged (vectorized midrank)."""
    s = np.asarray(scores, np.float64).reshape(-1)
    ss = np.sort(s)
    lo = np.searchsorted(ss, s, side="left")
    hi = np.searchsorted(ss, s, side="right")
    return 0.5 * (lo + hi + 1)


def auc_ref(labels, scores) -> float:
    """Mann-Whitney AUC with average-rank tie handling."""
    y = np.asarray(labels).reshape(-1) > 0
    n = y.size
    n_pos = int(y.sum())
    n_neg = n - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    r = _ranks_avg(np.asarray(scores, np.float32))
    return float((r[y].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def logloss_ref(labels, logits) -> float:
    """Mean binary cross-entropy on logits (numerically stable)."""
    z = np.asarray(logits, np.float64).reshape(-1)
    if z.size == 0:
        return 0.0
    y = (np.asarray(labels).reshape(-1) > 0).astype(np.float64)
    per = np.maximum(z, 0) - z * y + np.log1p(np.exp(-np.abs(z)))
    return float(per.mean())


def calibration_ratio_ref(labels, logits) -> float:
    """sum(sigmoid(logits)) / sum(positives) — 1.0 is calibrated.

    No positives but mass predicted -> inf; empty -> 1.0."""
    z = np.asarray(logits, np.float64).reshape(-1)
    y = np.asarray(labels).reshape(-1) > 0
    p_sum = float((1.0 / (1.0 + np.exp(-z))).sum())
    y_sum = float(y.sum())
    if y_sum > 0:
        return p_sum / y_sum
    return float("inf") if p_sum > 0 else 1.0


def _descending(scores: np.ndarray) -> np.ndarray:
    """(B, n) stable descending order (ties -> lowest index first)."""
    return np.argsort(-np.asarray(scores, np.float32), axis=-1,
                      kind="stable")


def _per_query_ref(rels, scores, k: int):
    """Per-query (ndcg, precision, recall, rr) in float64."""
    r = np.asarray(rels, np.float64)
    if r.ndim != 2:
        raise ValueError(f"ranking inputs must be (B, n), got {r.shape}")
    B, n = r.shape
    keff = min(int(k), n)
    if B == 0 or keff == 0:
        z = np.zeros(B, np.float64)
        return z, z.copy(), z.copy(), z.copy()
    order = _descending(scores)
    r_sorted = np.take_along_axis(r, order, axis=-1)
    disc = 1.0 / np.log2(np.arange(2, keff + 2, dtype=np.float64))
    dcg = (r_sorted[:, :keff] * disc).sum(-1)
    ideal = -np.sort(-r, axis=-1)
    idcg = (ideal[:, :keff] * disc).sum(-1)
    ndcg = np.where(idcg > 0, dcg / np.where(idcg > 0, idcg, 1.0), 0.0)
    hits = r_sorted > 0
    n_pos = (r > 0).sum(-1)
    prec = hits[:, :keff].sum(-1) / keff
    rec = np.where(n_pos > 0,
                   hits[:, :keff].sum(-1) / np.maximum(n_pos, 1), 0.0)
    anyhit = hits.any(-1)
    first = hits.argmax(-1)
    rr = np.where(anyhit, 1.0 / (first + 1.0), 0.0)
    return ndcg, prec, rec, rr


def ndcg_at_k_ref(rels, scores, k: int) -> float:
    ndcg, _, _, _ = _per_query_ref(rels, scores, k)
    return float(ndcg.mean()) if ndcg.size else 0.0


def precision_at_k_ref(rels, scores, k: int) -> float:
    _, prec, _, _ = _per_query_ref(rels, scores, k)
    return float(prec.mean()) if prec.size else 0.0


def recall_at_k_ref(rels, scores, k: int) -> float:
    _, _, rec, _ = _per_query_ref(rels, scores, k)
    return float(rec.mean()) if rec.size else 0.0


def mrr_ref(rels, scores) -> float:
    r = np.asarray(rels)
    _, _, _, rr = _per_query_ref(r, scores, max(r.shape[-1], 1)
                                 if r.ndim == 2 else 1)
    return float(rr.mean()) if rr.size else 0.0


def pointwise_partials_ref(labels, logits, n_bins: int = DEFAULT_BINS) -> dict:
    """Streaming sufficient statistics for one pointwise batch.

    Value sums in float64; the histograms bin the FLOAT32 probability
    (matching the torch side's compute dtype, see module docstring)."""
    z = np.asarray(logits, np.float64).reshape(-1)
    y = np.asarray(labels).reshape(-1) > 0
    p32 = (1.0 / (1.0 + np.exp(-z.astype(np.float32)))).astype(np.float32)
    idx = np.clip((p32 * n_bins).astype(np.int64), 0, n_bins - 1)
    pos_hist = np.bincount(idx[y], minlength=n_bins)
    neg_hist = np.bincount(idx[~y], minlength=n_bins)
    per = np.maximum(z, 0) - z * y + np.log1p(np.exp(-np.abs(z)))
    return {
        "n": int(z.size),
        "n_pos": int(y.sum()),
        "bce_sum": float(per.sum()),
        "p_sum": float((1.0 / (1.0 + np.exp(-z))).sum()),
        "pos_hist": pos_hist.astype(np.int64),
        "neg_hist": neg_hist.astype(np.int64),
    }


def ranking_partials_ref(rels, scores, k: int) -> dict:
    """Streaming sufficient statistics for one (B, n) query batch."""
    ndcg, prec, rec, rr = _per_query_ref(rels, scores, k)
    return {
        "n_queries": int(ndcg.size),
        "ndcg_sum": float(ndcg.sum()),
        "prec_sum": float(prec.sum()),
        "rec_sum": float(rec.sum()),
        "mrr_sum": float(rr.sum()),
    }


def binned_auc(pos_hist, neg_hist) -> float:
    """AUC of histogram-binned scores with within-bin midrank ties.

    This is EXACTLY the AUC of the scores quantized to their bin — the
    order-invariant streaming approximation ``MetricAccumulator`` folds
    (error <= the probability mass of co-binned discordant pairs; with
    the default 2048 bins that is ~1e-3 for smooth score distributions).
    """
    pos = np.asarray(pos_hist, np.float64)
    neg = np.asarray(neg_hist, np.float64)
    P, N = pos.sum(), neg.sum()
    if P == 0 or N == 0:
        return 0.5
    neg_below = np.concatenate(([0.0], np.cumsum(neg)[:-1]))
    wins = (pos * neg_below).sum() + 0.5 * (pos * neg).sum()
    return float(wins / (P * N))


# -- the declared oracle map -------------------------------------------------
# metric entry point in eval/metrics.py -> reference implementations;
# tests/test_torch_eval.py holds each pair to 1e-6.
ORACLES = {
    "auc": (auc_ref,),
    "logloss": (logloss_ref,),
    "calibration_ratio": (calibration_ratio_ref,),
    "ndcg_at_k": (ndcg_at_k_ref,),
    "precision_at_k": (precision_at_k_ref,),
    "recall_at_k": (recall_at_k_ref,),
    "mrr": (mrr_ref,),
    "pointwise_partials": (pointwise_partials_ref,),
    "ranking_partials": (ranking_partials_ref,),
}

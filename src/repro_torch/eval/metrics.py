"""Batch-streaming ranking-quality metrics.  Port of ``repro.eval.metrics``.

Plain PyTorch functions that compute on their inputs' device in float32,
each with a float64 numpy oracle in ``eval/ref.py`` (declared in
``ref.ORACLES``; tests/test_torch_eval.py holds each pair to 1e-6).  The
conventions (positives, ties, degenerate inputs) are defined once, in the
``ref`` module docstring.  No kernel: the JAX package's metrics are jnp.

Numerics worth naming:

* ``auc`` is exact: midranks come from two ``searchsorted`` passes, and
  the doubled centered rank ``lo + hi - n`` is an int64 whose
  positive-class sum is exact for any n; the one rounding is the final
  divide (in float64, then cast to float32);
* ties in the ranking metrics go to a stable descending sort
  (``torch.sort(stable=True)``): the lowest index first;
* integer counts (hits, positives, histogram bins) are int64 sums;
* ``pointwise_partials``/``ranking_partials`` are the streaming halves:
  per-batch sufficient statistics that ``MetricAccumulator`` folds on
  the host in exact arithmetic (integer counts + ``math.fsum``), so the
  folded result is independent of batch order and merge shape.

Every function returns tensors without reading them back, so a caller on
the card pays one blocking read when it takes the numbers.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.eval import ref as _ref

DEFAULT_BINS = _ref.DEFAULT_BINS


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def auc(labels, scores) -> torch.Tensor:
    """Mann-Whitney AUC with average-rank tie handling (exact)."""
    s = scores.to(torch.float32).reshape(-1)
    y = labels.reshape(-1) > 0
    n = s.numel()
    if n == 0:
        return _f32(0.5, s)
    ss = torch.sort(s).values
    lo = torch.searchsorted(ss, s, right=False)
    hi = torch.searchsorted(ss, s, right=True)
    # doubled centered rank: 2*midrank - (n+1) = lo + hi - n, an exact
    # integer; summing over positives gives AUC = 1/2 + sum / (2 P N)
    csum = torch.where(y, lo + hi - n, 0).sum()
    n_pos = y.sum()
    n_neg = n - n_pos
    val = 0.5 + csum.to(torch.float64) / (2 * n_pos * n_neg).to(torch.float64)
    return torch.where((n_pos == 0) | (n_neg == 0), 0.5, val).to(torch.float32)


def _bce(z, y):
    return torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-torch.abs(z)))


def logloss(labels, logits) -> torch.Tensor:
    """Mean binary cross-entropy on logits (numerically stable)."""
    z = logits.to(torch.float32).reshape(-1)
    if z.numel() == 0:
        return _f32(0.0, z)
    y = (labels.reshape(-1) > 0).to(torch.float32)
    return _bce(z, y).mean()


def calibration_ratio(labels, logits) -> torch.Tensor:
    """sum(sigmoid(logits)) / sum(positives); see ref conventions."""
    z = logits.to(torch.float32).reshape(-1)
    y = labels.reshape(-1) > 0
    p_sum = torch.sigmoid(z).sum()
    y_sum = y.sum().to(torch.float32)
    degenerate = torch.where(p_sum > 0, math.inf, 1.0)
    return torch.where(y_sum > 0, p_sum / torch.clamp(y_sum, min=1.0), degenerate)


def _per_query(rels, scores, keff: int):
    """Per-query (ndcg, precision, recall, rr), float32.  ``keff`` is the
    already-clamped cutoff min(k, n) >= 1."""
    s = scores.to(torch.float32)
    r = rels.to(torch.float32)
    order = torch.sort(s, dim=-1, descending=True, stable=True).indices
    r_sorted = torch.gather(r, -1, order)
    disc = 1.0 / torch.log2(torch.arange(2, keff + 2, dtype=torch.float32, device=s.device))
    dcg = (r_sorted[:, :keff] * disc).sum(-1)
    ideal = torch.sort(r, dim=-1, descending=True).values
    idcg = (ideal[:, :keff] * disc).sum(-1)
    ndcg = torch.where(idcg > 0, dcg / torch.where(idcg > 0, idcg, 1.0), 0.0)
    hits = r_sorted > 0
    n_pos = (r > 0).sum(-1)
    topk_hits = hits[:, :keff].sum(-1).to(torch.float32)
    prec = topk_hits / keff
    rec = torch.where(n_pos > 0, topk_hits / torch.clamp(n_pos, min=1), 0.0)
    first = torch.argmax(hits.to(torch.uint8), dim=-1)   # the first hit
    rr = torch.where(hits.any(-1), 1.0 / (first + 1.0), 0.0)
    return ndcg, prec, rec, rr


def _ranking_shape(rels) -> tuple[int, int]:
    if rels.ndim != 2:
        raise ValueError(f"ranking inputs must be (B, n), got {tuple(rels.shape)}")
    return tuple(rels.shape)


def _ranking_mean(rels, scores, keff: int, which: int) -> torch.Tensor:
    B, n = _ranking_shape(rels)
    if B == 0 or keff == 0:
        return _f32(0.0, scores)
    return _per_query(rels, scores, keff)[which].mean()


def ndcg_at_k(rels, scores, *, k: int) -> torch.Tensor:
    """Mean nDCG@min(k, n) over B queries of graded (B, n) relevance."""
    return _ranking_mean(rels, scores, min(k, _ranking_shape(rels)[1]), 0)


def precision_at_k(rels, scores, *, k: int) -> torch.Tensor:
    """Mean precision@min(k, n): hit fraction of the retrieved cutoff."""
    return _ranking_mean(rels, scores, min(k, _ranking_shape(rels)[1]), 1)


def recall_at_k(rels, scores, *, k: int) -> torch.Tensor:
    """Mean recall@min(k, n); zero-positive queries contribute 0."""
    return _ranking_mean(rels, scores, min(k, _ranking_shape(rels)[1]), 2)


def mrr(rels, scores) -> torch.Tensor:
    """Mean reciprocal rank of the first positive (0 when none)."""
    return _ranking_mean(rels, scores, _ranking_shape(rels)[1], 3)


# -- streaming partials ------------------------------------------------------

def pointwise_partials(labels, logits, *, n_bins: int = DEFAULT_BINS) -> dict:
    """Per-batch sufficient statistics for the pointwise metrics: int64
    counts and probability histograms (binned on the f32 sigmoid, see the
    ref module docstring for the boundary caveat) plus f32 value sums;
    additive across batches, folded exactly by ``MetricAccumulator``."""
    z = logits.to(torch.float32).reshape(-1)
    y = labels.reshape(-1) > 0
    p = torch.sigmoid(z)
    idx = torch.clamp((p * n_bins).to(torch.int64), 0, n_bins - 1)
    zeros = torch.zeros(n_bins, dtype=torch.int64, device=z.device)
    yi = y.to(torch.int64)
    return {
        "n": torch.tensor(z.numel(), dtype=torch.int64, device=z.device),
        "n_pos": yi.sum(),
        "bce_sum": _bce(z, y.to(torch.float32)).sum(),
        "p_sum": p.sum(),
        "pos_hist": zeros.index_add(0, idx, yi),
        "neg_hist": zeros.index_add(0, idx, 1 - yi),
    }


def ranking_partials(rels, scores, *, k: int) -> dict:
    """Per-batch sufficient statistics for the ranking metrics."""
    B, n = _ranking_shape(rels)
    dev = scores.device
    if B == 0 or min(k, n) == 0:
        zero = _f32(0.0, scores)
        return {"n_queries": torch.tensor(B, device=dev), "ndcg_sum": zero,
                "prec_sum": zero, "rec_sum": zero, "mrr_sum": zero}
    ndcg, prec, rec, _ = _per_query(rels, scores, min(k, n))
    rr = _per_query(rels, scores, n)[3]
    return {
        "n_queries": torch.tensor(B, device=dev),
        "ndcg_sum": ndcg.sum(),
        "prec_sum": prec.sum(),
        "rec_sum": rec.sum(),
        "mrr_sum": rr.sum(),
    }


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


class MetricAccumulator:
    """Folds per-batch partials into split-level metrics, order-invariantly.

    Each batch's partials are computed on its device
    (``pointwise_partials`` / ``ranking_partials``) and folded on the host
    in exact arithmetic (python-int counts, int64 histogram adds,
    ``math.fsum`` over the per-batch float partials), so ``result()`` is
    bit-identical under any permutation of ``update`` calls and any
    ``merge`` tree.  State is O(n_bins), independent of split size.  The
    streamed AUC is the histogram-binned approximation
    (``ref.binned_auc``)."""

    def __init__(self, *, k: int = 10, n_bins: int = DEFAULT_BINS):
        self.k = int(k)
        self.n_bins = int(n_bins)
        self.n = 0
        self.n_pos = 0
        self.n_queries = 0
        self._bce: list[float] = []
        self._p: list[float] = []
        self._ndcg: list[float] = []
        self._prec: list[float] = []
        self._rec: list[float] = []
        self._mrr: list[float] = []
        self.pos_hist = np.zeros(self.n_bins, np.int64)
        self.neg_hist = np.zeros(self.n_bins, np.int64)

    def update(self, labels, logits) -> None:
        """Fold one pointwise batch (any shape, flattened)."""
        part = pointwise_partials(_tensor(labels), _tensor(logits), n_bins=self.n_bins)
        self.n += int(part["n"])
        self.n_pos += int(part["n_pos"])
        self._bce.append(float(part["bce_sum"]))
        self._p.append(float(part["p_sum"]))
        self.pos_hist += part["pos_hist"].cpu().numpy()
        self.neg_hist += part["neg_hist"].cpu().numpy()

    def update_ranking(self, rels, scores) -> None:
        """Fold one (B, n) batch of ranked queries."""
        part = ranking_partials(_tensor(rels), _tensor(scores), k=self.k)
        self.n_queries += int(part["n_queries"])
        self._ndcg.append(float(part["ndcg_sum"]))
        self._prec.append(float(part["prec_sum"]))
        self._rec.append(float(part["rec_sum"]))
        self._mrr.append(float(part["mrr_sum"]))

    def merge(self, other: "MetricAccumulator") -> "MetricAccumulator":
        """Fold another accumulator in (distributed eval shards)."""
        if (other.k, other.n_bins) != (self.k, self.n_bins):
            raise ValueError("merging accumulators with different k/n_bins")
        self.n += other.n
        self.n_pos += other.n_pos
        self.n_queries += other.n_queries
        for mine, theirs in ((self._bce, other._bce), (self._p, other._p),
                             (self._ndcg, other._ndcg), (self._prec, other._prec),
                             (self._rec, other._rec), (self._mrr, other._mrr)):
            mine.extend(theirs)
        self.pos_hist += other.pos_hist
        self.neg_hist += other.neg_hist
        return self

    def result(self) -> dict:
        """Split-level metrics from the folded partials."""
        out = {"n": self.n, "n_pos": self.n_pos, "n_queries": self.n_queries}
        p_sum = math.fsum(self._p)
        out["auc"] = _ref.binned_auc(self.pos_hist, self.neg_hist)
        out["logloss"] = math.fsum(self._bce) / self.n if self.n else 0.0
        if self.n_pos > 0:
            out["calibration_ratio"] = p_sum / self.n_pos
        else:
            out["calibration_ratio"] = float("inf") if p_sum > 0 else 1.0
        q = self.n_queries
        out[f"ndcg@{self.k}"] = math.fsum(self._ndcg) / q if q else 0.0
        out[f"precision@{self.k}"] = math.fsum(self._prec) / q if q else 0.0
        out[f"recall@{self.k}"] = math.fsum(self._rec) / q if q else 0.0
        out["mrr"] = math.fsum(self._mrr) / q if q else 0.0
        return out

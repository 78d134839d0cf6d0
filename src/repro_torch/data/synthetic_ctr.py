"""Synthetic CTR data with PLANTED low-rank field-interaction structure.

The paper's public datasets (Criteo/Avazu/MovieLens) are not available
offline, so benchmarks draw from a generator whose ground truth is itself an
FwFM with field matrix  R* = U*^T diag(e*) U* + diag(d*)  of rank r* plus
optional dense noise:

    ids_f  ~ Zipf(alpha) per field           (realistic head-heavy traffic)
    $phi(x) = b0 + <b, x> + sum_{i<j} <v_i, v_j> R*_ij$
    label  ~ Bernoulli(sigmoid(phi / temperature))

This makes the paper's claims *testable* offline: a DPLR model with rank >=
r* can match the teacher; magnitude pruning at the equivalent parameter
count cannot represent R* and loses accuracy (Table 1's ordering).  The
noise_rank knob interpolates toward a full-rank teacher where both
approximations degrade.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.fields import FeatureLayout


@dataclasses.dataclass
class SyntheticCTR:
    layout: FeatureLayout
    embed_dim: int = 8
    teacher_rank: int = 2
    noise_scale: float = 0.0      # dense full-rank perturbation of R*
    zipf_alpha: float = 1.3
    temperature: float = 1.0
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        m = self.layout.n_fields
        k = self.embed_dim
        # teacher DPLR field matrix with BLOCK-HETEROGENEOUS factors — the
        # paper's motivating observation is that real field matrices show
        # block structure from field groups.  A homogeneous rank-1 teacher
        # (all entries ~1) would make magnitude pruning a mere RESCALING of
        # the pairwise term, which AUC cannot see; mixed-sign, mixed-scale
        # factors make the pruned-away entries carry ranking signal.
        U = (rng.choice([-1.2, -0.4, 0.4, 1.2], (self.teacher_rank, m))
             * (1.0 + 0.3 * rng.standard_normal((self.teacher_rank, m))))
        e = rng.choice([-1.0, 1.0], self.teacher_rank) * \
            (1.0 + 0.5 * rng.random(self.teacher_rank))
        low = (U.T * e) @ U / np.sqrt(m)
        R = low + self.noise_scale * rng.standard_normal((m, m)) / m
        R = 0.5 * (R + R.T)
        np.fill_diagonal(R, 0.0)
        self.R_true = R.astype(np.float32)
        self.emb_true = (rng.standard_normal(
            (self.layout.total_vocab, k)) / np.sqrt(k)).astype(np.float32)
        self.lin_true = (rng.standard_normal(self.layout.total_vocab)
                         * 0.05).astype(np.float32)
        self.b0 = float(rng.standard_normal() * 0.1)
        # per-field Zipf id distribution (resampled into [0, vocab))
        self._rng = rng

    def _sample_ids(self, rng, batch: int) -> np.ndarray:
        cols = []
        for f in self.layout.fields:
            for _ in range(f.multiplicity):
                raw = rng.zipf(self.zipf_alpha, batch)
                cols.append((raw - 1) % f.vocab_size)
        return np.stack(cols, axis=1).astype(np.int32)

    def logits(self, ids: np.ndarray, weights: np.ndarray) -> np.ndarray:
        """Teacher score for encoded rows (numpy reference)."""
        offs = self.layout.slot_offsets
        rows = ids + offs
        emb = self.emb_true[rows] * weights[..., None]      # (B, slots, k)
        m = self.layout.n_fields
        V = np.zeros((ids.shape[0], m, self.embed_dim), np.float32)
        np.add.at(V, (slice(None), self.layout.slot_to_field), emb)
        G = np.einsum("bik,bjk->bij", V, V)
        pair = 0.5 * np.einsum("bij,ij->b", G, self.R_true)
        lin = (self.lin_true[rows] * weights).sum(1)
        return self.b0 + lin + pair

    def batch(self, batch_size: int, seed: int) -> dict:
        """Deterministic batch keyed by seed (host-shardable, replayable)."""
        rng = np.random.default_rng((self.seed, seed))
        ids = self._sample_ids(rng, batch_size)
        weights = np.ones_like(ids, np.float32)
        z = self.logits(ids, weights) / self.temperature
        p = 1.0 / (1.0 + np.exp(-z))
        labels = (rng.random(batch_size) < p).astype(np.float32)
        return {"ids": ids, "weights": weights, "label": labels}

    def context_query(self, seed: int) -> dict:
        """One query context, no candidates — the corpus-engine serving
        workload, where the item side is the engine's static corpus."""
        rng = np.random.default_rng((self.seed, 7, seed))
        ctx_slots = self.layout.slots_of("context")
        ctx_ids = self._sample_ids(rng, 1)[:, ctx_slots]
        return {
            "context_ids": ctx_ids,
            "context_weights": np.ones_like(ctx_ids, np.float32),
        }

    def ranking_query(self, n_items: int, seed: int) -> dict:
        """One context + n candidate items (the serving workload)."""
        rng = np.random.default_rng((self.seed, 7, seed))
        ctx_slots = self.layout.slots_of("context")
        item_slots = self.layout.slots_of("item")
        ids = self._sample_ids(rng, n_items)
        ctx_ids = ids[:1, ctx_slots]
        item_ids = ids[None, :, item_slots]
        return {
            "context_ids": ctx_ids,
            "context_weights": np.ones_like(ctx_ids, np.float32),
            "item_ids": item_ids,
            "item_weights": np.ones_like(item_ids, np.float32),
        }

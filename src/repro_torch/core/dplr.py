"""Diagonal-plus-low-rank (DPLR) parameterization of the FwFM field matrix.

Port of ``repro.core.dplr``.  The field matrix is never learned directly:

    R = U^T diag(e) U + diag(d),   d = -diag_of(U^T diag(e) U)      (Eq. 10)

so diag(R) = 0 by construction, and Proposition 1 reduces the pairwise
interaction to ``sum_i d_i ||v_i||^2 + sum_r e_r ||P_r||^2`` with
``P = U V``.  ``posthoc_dplr`` fits the form to a trained full FwFM's R
after the fact (Section 5.4).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import init_device, resolve_device


class DPLRParams(NamedTuple):
    """Learned DPLR factors.  U: (rho, m);  e: (rho,)."""

    U: torch.Tensor
    e: torch.Tensor

    @property
    def rank(self) -> int:
        return self.U.shape[0]

    @property
    def n_fields(self) -> int:
        return self.U.shape[1]


def init_dplr(generator: torch.Generator, n_fields: int, rank: int, *,
              scale: float | None = None, dtype=torch.float32, device=None) -> DPLRParams:
    """Rank-1 ``U = 1^T, e = 1`` is a plain FM (R = 11^T - I); the init
    starts there, with small noise on every row.  Tensors are made on
    ``device`` (default: the generator's)."""
    if scale is None:
        scale = 1.0 / np.sqrt(n_fields)
    dev = init_device(generator, device)
    U = torch.randn((rank, n_fields), generator=generator, device=dev) * scale
    if rank >= 1:
        U[0] += 1.0
    e = torch.ones((rank,), device=dev)
    return DPLRParams(U.to(dtype), e.to(dtype))


def dplr_diagonal(p: DPLRParams) -> torch.Tensor:
    """d = -diag_of(U^T diag(e) U); d_m = -sum_r e_r U_{r,m}^2.  O(rho*m)."""
    return -torch.einsum("r,rm,rm->m", p.e, p.U, p.U)


def materialize_R(p: DPLRParams) -> torch.Tensor:
    """(m, m) full field matrix; for tests and analysis, never the hot path."""
    low = torch.einsum("rm,r,rn->mn", p.U, p.e, p.U)
    return low + torch.diag(dplr_diagonal(p))


# ---------------------------------------------------------------------------
# Post-hoc factorization (Section 5.4): approximate a trained FwFM's R with a
# DPLR form after the fact.  The paper shows this is dominated by training
# the DPLR form directly (fig2 benchmark).
# ---------------------------------------------------------------------------

def posthoc_dplr(R: np.ndarray, rank: int, n_iters: int = 50, polish_steps: int = 500,
                 device=None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Best-effort DPLR fit of a symmetric zero-diagonal R.

    Stage 1, alternating minimization (numpy, f64, the JAX function's
    code): given the diagonal shift d, take the top-``rank`` |eigenvalue|
    eigenpairs of (R - diag(d)); given the low-rank part L, set
    d = diag(R) - diag(L).  It stalls at local fixed points, so stage 2
    polishes (U, e, d) with the port's adamw on the Frobenius error, by
    autograd on ``device`` (default cuda), from the JAX function's two
    inits (``default_rng(0)``), and keeps the better fit.
    Returns (U (rank, m), e (rank,), d (m,)) in f64."""
    R = np.asarray(R, dtype=np.float64)
    m = R.shape[0]
    d = np.zeros(m)
    U = np.zeros((rank, m))
    e = np.zeros(rank)
    for _ in range(n_iters):
        w, Q = np.linalg.eigh(R - np.diag(d))
        idx = np.argsort(-np.abs(w))[:rank]
        e = w[idx]
        U = Q[:, idx].T
        L = (U.T * e) @ U
        d = np.diag(R) - np.diag(L)

    if polish_steps:
        from repro_torch.optim import adamw, value_and_grad

        dev = resolve_device(device)
        Rt = torch.as_tensor(R, dtype=torch.float32, device=dev)

        def err(p):
            approx = torch.einsum("rm,r,rn->mn", p["U"], p["e"], p["U"]) + torch.diag(p["d"])
            return ((approx - Rt) ** 2).sum()

        opt = adamw(weight_decay=0.0, clip_norm=None)
        grad = value_and_grad(err)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731

        # the alternating solution is often a symmetric saddle: polish from
        # it (noised) and from a random init, keep the better fit
        rng = np.random.default_rng(0)
        inits = [
            {"U": f32(U + 0.05 * rng.standard_normal(U.shape)), "e": f32(e), "d": f32(d)},
            {"U": f32(0.3 * rng.standard_normal((rank, m))),
             "e": torch.ones((rank,), device=dev), "d": torch.zeros((m,), device=dev)},
        ]
        best, best_err = None, np.inf
        for params in inits:
            state = opt.init(params)
            for _ in range(polish_steps):
                opt.update(grad(params)[1], state, params, 1e-2)
            with torch.no_grad():
                f = float(err(params))
            if f < best_err:
                best, best_err = params, f
        U, e, d = (best[k].cpu().numpy().astype(np.float64) for k in ("U", "e", "d"))
    return U, e, d


def posthoc_error_spectrum(R: np.ndarray, approx: np.ndarray) -> np.ndarray:
    """Singular values of the approximation error (Fig. 2's y-axis)."""
    return np.linalg.svd(np.asarray(R) - np.asarray(approx), compute_uv=False)

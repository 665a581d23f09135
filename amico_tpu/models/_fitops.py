"""Shared on-device pieces of the model fit functions."""
from __future__ import annotations

import jax
import jax.numpy as jnp

_PREC = jax.lax.Precision.HIGHEST


def predict(A: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """y_est = A x per tile: A (C, nS, na), x (C, M, na) -> (C, M, nS)."""
    return jnp.einsum('csa,cma->cms', A, x, precision=_PREC)


def project(A: jnp.ndarray, Y: jnp.ndarray) -> jnp.ndarray:
    """b = A'y per tile: A (C, nS, na), Y (C, M, nS) -> (C, M, na)."""
    return jnp.einsum('csa,cms->cma', A, Y, precision=_PREC)


def error_maps(A, x, Y, compute_rmse: bool, compute_nrmse: bool) -> dict:
    """RMSE / NRMSE maps exactly as the reference kernels
    (/root/reference/amico/models.pyx:47-71)."""
    out = {}
    if not (compute_rmse or compute_nrmse):
        return out
    y_est = predict(A, x)
    sq = jnp.sum((Y - y_est) ** 2, axis=-1)
    if compute_rmse:
        out['rmse'] = jnp.sqrt(sq / Y.shape[-1])
    if compute_nrmse:
        den = jnp.sum(Y ** 2, axis=-1)
        out['nrmse'] = jnp.where(den > 1e-16, jnp.sqrt(sq / jnp.maximum(den, 1e-16)), 0.0)
    return out


def solve_tiles(G, b, L, lam1, lam2, mask=None, solver_kw=None,
                m0=None, x0=None):
    """Per-tile QP solve through ops.solvers.nneg_qp_batch: G (C,n,n),
    b (C,M,n), L (C,).  ``m0``/``x0`` warm-start the active-set rounds
    (skipping FISTA)."""
    from ..ops.solvers import nneg_qp_batch
    return nneg_qp_batch(G[:, None], b, lam1, lam2, mask=mask,
                         L=L[:, None], m0=m0, x0=x0, **(solver_kw or {}))

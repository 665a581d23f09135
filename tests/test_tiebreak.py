"""Stage-2 degenerate-vertex objective tie-break (round 5).

Root cause under test (PARITY.md 'error tail'): on near-degenerate voxels
the NODDI stage-2 non-negative lasso has several vertices within ~0.1%
relative objective whose supports differ by adjacent kappa-grid atoms; a
greedy active-set path can land one cell off the exact (LARS) vertex.
The tie-break swaps the dominant WM atom to its kappa neighbours and keeps
the lowest objective (ops.solvers.noddi_stage2_tiebreak)."""
import numpy as np

import jax.numpy as jnp

from amico_tpu.models.noddi import _kappa_neighbours
from amico_tpu.ops.solvers import noddi_stage2_tiebreak


def test_kappa_neighbours_default_grid():
    """Default 12x12 grid, od-major atom order (generate() loops kappa
    outer, icvf inner): the same-ICVF kappa neighbours sit +-12 away."""
    IC_VFs = np.linspace(0.1, 0.99, 12)
    IC_ODs = np.hstack(([0.03, 0.06], np.linspace(0.09, 0.99, 10)))
    kappas = 1 / np.tan(IC_ODs * np.pi / 2)
    icvf = np.tile(IC_VFs, len(IC_ODs)).astype(np.float32)
    kappa = np.repeat(kappas, len(IC_VFs)).astype(np.float32)
    nbm, nbp = _kappa_neighbours(icvf, kappa)
    n_vf = len(IC_VFs)
    for j in range(len(icvf)):
        od, vf = divmod(j, n_vf)
        # kappa DECREASES with od index (kappa = 1/tan(od*pi/2)), so the
        # ascending-kappa neighbour layout flips: nbp steps od-1
        expect_p = j - n_vf if od > 0 else -1
        expect_m = j + n_vf if od < len(IC_ODs) - 1 else -1
        assert nbp[j] == expect_p, (j, nbp[j], expect_p)
        assert nbm[j] == expect_m, (j, nbm[j], expect_m)


def _objective(G, b, x, lam1, lam2):
    return (0.5 * np.einsum('...i,ij,...j->...', x, G, x)
            + 0.5 * lam2 * np.sum(x * x, -1)
            - np.sum(b * x, -1) + lam1 * np.sum(x, -1))


def _degenerate_problem():
    """4-atom dictionary where atoms 1 and 2 are kappa neighbours and
    nearly identical, with the signal slightly preferring atom 2: a greedy
    path seeded on atom 1 sits on the worse vertex."""
    rng = np.random.RandomState(3)
    m = 24
    base = rng.randn(m)
    A = np.stack([rng.randn(m),
                  base + 1e-3 * rng.randn(m),
                  base + 1e-3 * rng.randn(m),
                  rng.randn(m)], axis=1)
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    y = 2.0 * A[:, 2] + 0.05 * rng.randn(m)
    icvf = np.array([0.5, 0.5, 0.5, 0.5], np.float32)
    kappa = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    lam1, lam2 = 0.05, 1e-3
    G = A.T @ A + 0 * np.eye(4)
    b = A.T @ y
    return A, G, b, icvf, kappa, lam1, lam2


def test_tiebreak_switches_to_lower_objective_vertex():
    A, G, b, icvf, kappa, lam1, lam2 = _degenerate_problem()
    nbm, nbp = _kappa_neighbours(icvf, kappa)
    # incumbent: vertex restricted to the WRONG near-duplicate atom (1)
    G11 = G[1, 1] + lam2
    x1 = max((b[1] - lam1) / G11, 0.0)
    x_bad = np.zeros(4)
    x_bad[1] = x1
    # tie-break must discover atom 2's vertex (lower objective)
    x_fix = np.asarray(noddi_stage2_tiebreak(
        jnp.asarray(G[None], jnp.float32), jnp.asarray(b[None, None], jnp.float32),
        jnp.asarray(x_bad[None, None], jnp.float32), lam1, lam2, nbm, nbp))
    F_bad = _objective(G, b, x_bad, lam1, lam2)
    F_fix = _objective(G, b, x_fix[0, 0], lam1, lam2)
    assert F_fix < F_bad - 1e-6, (F_fix, F_bad)
    assert x_fix[0, 0, 2] > 0 and x_fix[0, 0, 1] == 0


def test_tiebreak_never_worsens_objective():
    """On random voxels (non-degenerate) the tie-break is conservative:
    it only replaces the incumbent on a strict objective decrease."""
    rng = np.random.RandomState(0)
    n, M = 12, 32
    icvf = np.tile(np.array([0.3, 0.6, 0.9]), 4).astype(np.float32)
    kappa = np.repeat(np.array([0.5, 1.0, 2.0, 4.0]), 3).astype(np.float32)
    nbm, nbp = _kappa_neighbours(icvf, kappa)
    A = rng.randn(40, n)
    G = (A.T @ A).astype(np.float32)
    b = rng.rand(1, M, n).astype(np.float32)
    lam1, lam2 = 0.1, 1e-3
    # incumbent: exact solve per voxel via the native oracle
    from amico_tpu.ops import native
    x0 = np.zeros((1, M, n), np.float32)
    for v in range(M):
        x0[0, v] = native.qp_nonneg(
            G + lam2 * np.eye(n), b[0, v] - lam1)
    x_tb = np.asarray(noddi_stage2_tiebreak(
        jnp.asarray(G[None]), jnp.asarray(b), jnp.asarray(x0),
        lam1, lam2, nbm, nbp))
    F0 = _objective(G, b[0], x0[0], lam1, lam2)
    F1 = _objective(G, b[0], x_tb[0], lam1, lam2)
    assert (F1 <= F0 + 1e-5).all()
    # the incumbent is the exact optimum here, so nearly all voxels keep it
    assert np.median(np.abs(F1 - F0)) < 1e-5

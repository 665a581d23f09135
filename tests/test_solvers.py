"""Batched solver tests vs the exact native oracle and scipy
(SURVEY.md section 4: solver tests on random (nS x natoms) problems,
including NODDI-like ill-conditioned dictionaries)."""
import numpy as np
import pytest
from scipy.optimize import nnls as scipy_nnls

import jax
import jax.numpy as jnp

from amico_tpu.ops import native
from amico_tpu.ops.solvers import nneg_lasso_from_A, nneg_qp_batch, nnls_from_A, power_iteration_L

jax.config.update('jax_enable_x64', True)


def _random_problems(B=16, m=60, n=24, seed=0, correlated=False):
    rng = np.random.RandomState(seed)
    if correlated:
        # NODDI-like: smooth, highly correlated columns
        t = np.linspace(0, 1, m)
        A = np.stack([np.exp(-t * (1 + 8 * j / n)) for j in range(n)], axis=1)
        A += 0.01 * rng.randn(m, n)
    else:
        A = rng.randn(m, n)
    Y = rng.rand(B, m)
    return A, Y


def test_power_iteration():
    rng = np.random.RandomState(1)
    A = rng.randn(40, 20)
    G = A.T @ A
    L = float(power_iteration_L(jnp.asarray(G)))
    assert L == pytest.approx(np.linalg.eigvalsh(G).max(), rel=1e-3)


@pytest.mark.parametrize('correlated', [False, True])
def test_nnls_batch_vs_scipy(correlated):
    A, Y = _random_problems(B=12, correlated=correlated)
    X = np.asarray(nnls_from_A(jnp.asarray(A), jnp.asarray(Y),
                               fista_iters=300, cd_sweeps=60))
    for i in range(Y.shape[0]):
        x_ref, _ = scipy_nnls(A, Y[i])
        obj = lambda x: 0.5 * np.sum((Y[i] - A @ x) ** 2)
        # objective-level parity (solutions may be non-unique)
        assert obj(X[i]) <= obj(x_ref) * (1 + 1e-6) + 1e-10
        np.testing.assert_allclose(X[i], x_ref, atol=5e-5)


@pytest.mark.parametrize('lam1,lam2', [(0.0, 4.0), (0.5, 1e-3), (0.0, 1e-3),
                                       (0.0, 5e-3)])
def test_lasso_batch_vs_native_oracle(lam1, lam2):
    """The four (lam1, lam2) pairs are exactly the reference model defaults:
    CylinderZeppelinBall (models.pyx:439-442), NODDI (721-724),
    FreeWater (1077-1080), SANDI (1405-1408)."""
    A, Y = _random_problems(B=10, m=80, n=30, seed=3, correlated=True)
    X = np.asarray(nneg_lasso_from_A(jnp.asarray(A), jnp.asarray(Y),
                                     lam1, lam2, fista_iters=400, cd_sweeps=80))
    for i in range(Y.shape[0]):
        x_ref = native.lasso(A, Y[i], lam1, lam2)
        np.testing.assert_allclose(X[i], x_ref, atol=2e-5,
                                   err_msg=f'problem {i}')


def test_masked_solve_equals_submatrix_solve():
    """mask-pinning must reproduce NNLS on the column submatrix -- the
    reference's debias stage (models.pyx:929-942)."""
    A, Y = _random_problems(B=6, m=50, n=20, seed=4)
    rng = np.random.RandomState(5)
    mask = (rng.rand(6, 20) > 0.4).astype(float)
    mask[:, -1] = 1.0
    G = jnp.asarray(A.T @ A)
    b = jnp.einsum('mi,bm->bi', jnp.asarray(A), jnp.asarray(Y))
    X = np.asarray(nneg_qp_batch(G, b, mask=jnp.asarray(mask),
                                 fista_iters=300, cd_sweeps=60))
    for i in range(6):
        cols = np.where(mask[i] > 0)[0]
        x_sub, _ = scipy_nnls(A[:, cols], Y[i])
        full = np.zeros(20)
        full[cols] = x_sub
        np.testing.assert_allclose(X[i], full, atol=5e-5)


def test_shared_vs_batched_G_agree():
    A, Y = _random_problems(B=8, m=40, n=16, seed=6)
    G = A.T @ A
    b = Y @ A
    Xs = np.asarray(nneg_qp_batch(jnp.asarray(G), jnp.asarray(b),
                                  lam1=0.1, lam2=0.01,
                                  fista_iters=200, cd_sweeps=40))
    Gb = np.broadcast_to(G, (8,) + G.shape)
    Xb = np.asarray(nneg_qp_batch(jnp.asarray(Gb), jnp.asarray(b),
                                  lam1=0.1, lam2=0.01,
                                  fista_iters=200, cd_sweeps=40))
    np.testing.assert_allclose(Xs, Xb, atol=1e-10)


def test_exact_zeros_for_support_detection():
    A, Y = _random_problems(B=8, m=60, n=25, seed=7, correlated=True)
    X = np.asarray(nneg_lasso_from_A(jnp.asarray(A), jnp.asarray(Y),
                                     0.5, 1e-3, fista_iters=200, cd_sweeps=40))
    # CD polish must produce exact zeros (not denormals) outside the support
    for i in range(8):
        x_ref = native.lasso(A, Y[i], 0.5, 1e-3)
        assert set(np.where(X[i] > 0)[0]) == set(np.where(x_ref > 1e-12)[0])


def test_float32_accuracy_noddi_like():
    """f32 path (the device dtype) must stay close to the f64 oracle at map level."""
    A, Y = _random_problems(B=10, m=100, n=40, seed=8, correlated=True)
    X32 = np.asarray(nneg_lasso_from_A(jnp.asarray(A, jnp.float32),
                                       jnp.asarray(Y, jnp.float32),
                                       0.5, 1e-3, fista_iters=400, cd_sweeps=80))
    for i in range(10):
        x_ref = native.lasso(A, Y[i], 0.5, 1e-3)
        denom = max(np.abs(x_ref).max(), 1e-6)
        assert np.abs(X32[i] - x_ref).max() / denom < 5e-3


def test_add_k_oracle_parity_both_backends():
    """Top-k atom adds (add_k=2,3) must reach the same oracle vertex as
    classic single adds: wrongly co-added atoms are pruned by the
    line-search (which excludes entering x==0 atoms from the ratio test --
    the livelock regression this guards, see nneg_qp_batch inner_solve),
    both on the flat batch and through the per-tile wrapper the fit
    chunks call."""
    from amico_tpu.models._fitops import solve_tiles
    from amico_tpu.ops.solvers import gram, nneg_qp_batch

    rng = np.random.RandomState(0)
    m, n, B = 40, 20, 16
    A = np.abs(rng.randn(m, n)).astype(np.float32)
    Xt = (rng.rand(B, n) * (rng.rand(B, n) < 0.4)).astype(np.float32)
    Y = Xt @ A.T + 0.01 * rng.randn(B, m).astype(np.float32)
    G = np.asarray(gram(jnp.asarray(A)))
    b = Y @ A
    kw = dict(fista_iters=0, cd_sweeps=0, refine_rounds=6,
              cg_iters=(4, 6, 8, 10, 12, 12), converge=True)
    x_or = np.stack([native.nnls(A, Y[i])[0] for i in range(B)])
    for k in (2, 3):
        xk = np.asarray(nneg_qp_batch(jnp.asarray(G), jnp.asarray(b),
                                      add_k=k, **kw))
        assert np.abs(xk - x_or).max() < 5e-4, (k, np.abs(xk - x_or).max())
    xp = np.asarray(solve_tiles(
        jnp.asarray(np.broadcast_to(G, (2, n, n)).copy()),
        jnp.asarray(b.reshape(2, 8, n).copy()), jnp.ones(2), 0.0, 0.0,
        solver_kw=dict(add_k=2, **kw)))
    assert np.abs(xp.reshape(B, n) - x_or).max() < 5e-4

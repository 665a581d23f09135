"""Regression tests for the solver/model-layer review findings.

Each test pins one fixed defect: the active-set working-set cap silently
truncating large optimal supports (the CylinderZeppelinBall lambda2=4
failure mode), NODDI inferring the merged-b0 layout from the signal shape
instead of the doMergeB0 config, and SANDI's _solver_kwargs crashing on
the per-round cg_iters tuple that base.set_solver documents.
"""
import os

import numpy as np
import pytest

from amico_tpu.models.base import DEFAULT_AS_SOLVER_KW
from amico_tpu.ops import native
from amico_tpu.ops.solvers import gram, nneg_qp_batch


def _dense_support_problem(n=25, m=60, seed=0, lam2=4.0):
    """A correlated non-negative dictionary whose elastic-net solution has
    a dense optimal support (the ridge spreads weight over all atoms) --
    the shape of the CylinderZeppelinBall fit (models.pyx:439-442)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(m, 4))
    A = np.abs(base @ rng.normal(size=(4, n)) + 0.15 * rng.normal(size=(m, n)))
    A /= np.linalg.norm(A, axis=0)
    y = A @ np.abs(rng.normal(size=n))
    G = np.asarray(gram(A))
    b = A.T @ y
    x_oracle = native.qp_nonneg(
        np.asarray(G + lam2 * np.eye(n), np.float64),
        np.asarray(b, np.float64))
    return G, b, x_oracle, lam2


def test_default_solver_reaches_supports_beyond_round_count():
    """DEFAULT_AS_SOLVER_KW schedules 12 active-set rounds; each round adds
    at most one atom, so without the `converge` continuation any voxel
    whose optimal support exceeds 12 atoms was silently truncated (0.59
    max-abs coefficient error on this problem)."""
    G, b, x_oracle, lam2 = _dense_support_problem()
    assert (x_oracle > 1e-9).sum() > 12   # the regression's precondition
    x = np.asarray(nneg_qp_batch(G, b, 0.0, lam2, **DEFAULT_AS_SOLVER_KW))
    assert (x > 1e-9).sum() == (x_oracle > 1e-9).sum()
    np.testing.assert_allclose(x, x_oracle, atol=5e-6)


def test_converge_costs_nothing_when_schedule_suffices():
    """Sparse-support problems (the common case) must return the identical
    solution with and without the continuation -- it only engages when the
    scheduled rounds exit unstable."""
    rng = np.random.default_rng(3)
    m, n = 40, 20
    A = np.abs(rng.normal(size=(m, n)))
    A /= np.linalg.norm(A, axis=0)
    xt = np.zeros(n)
    xt[rng.choice(n, 4, replace=False)] = np.abs(rng.normal(size=4))
    y = A @ xt
    G, b = np.asarray(gram(A)), A.T @ y
    kw = dict(DEFAULT_AS_SOLVER_KW)
    x_on = np.asarray(nneg_qp_batch(G, b, 0.0, 0.0, **kw))
    kw['converge'] = False
    x_off = np.asarray(nneg_qp_batch(G, b, 0.0, 0.0, **kw))
    np.testing.assert_array_equal(x_on, x_off)


def test_sandi_solver_kwargs_accepts_cg_tuple():
    """set_solver(cg_iters=(4, 8, 12)) is the documented per-round-budget
    form (base._set_solver_common); SANDI's override called int() on it."""
    from amico_tpu.models import SANDI

    m = SANDI()
    m.set_solver(cg_iters=(4, 8, 12))
    kw = m._solver_kwargs()
    assert kw['cg_iters'] == (4, 8, 12)
    m.set_solver(cg_iters=24)
    assert m._solver_kwargs()['cg_iters'] == 24


def test_noddi_rows_from_scheme_not_shape(tmp_path):
    """A scheme with exactly ONE b0 that is NOT the first volume satisfies
    nS == 1 + dwi_count, which the old shape-based inference mistook for
    the merged-b0 layout (rows_dwi = arange(1, nS)) -- stage 2 then
    treated the real b0 as a DWI and dropped DWI column 0.  The fit must
    be invariant to where the single b0 sits in the scheme."""
    os.environ.setdefault('AMICO_TPU_HOME', str(tmp_path / 'home'))
    from amico_tpu.testing import demo_noddi, demo_scheme, demo_voxels
    from amico_tpu.io.scheme import Scheme
    from tests.test_models import EvalStub

    scheme = demo_scheme(nb0=1, shells=(700.0, 2000.0), ndir=12)
    assert scheme.nS == 1 + scheme.dwi_count
    model, kernels, htable = demo_noddi(scheme,
                                        kernels_dir=str(tmp_path / 'k'))
    y, DIRs, _ = demo_voxels(64, kernels, htable, seed=11)
    res_first = model.fit(EvalStub(y, DIRs, htable, kernels))

    # move the b0 (column 0) to position 5: same protocol, permuted order
    perm = np.r_[1:6, 0, 6:scheme.nS]
    scheme_perm = Scheme(np.asarray(scheme.raw)[perm])
    assert scheme_perm.b0_idx[0] == 5
    k_perm = dict(kernels)
    k_perm['wm'] = np.ascontiguousarray(kernels['wm'][:, :, perm])
    k_perm['iso'] = np.ascontiguousarray(kernels['iso'][perm])
    model.scheme = scheme_perm
    model._prep_cache = None
    try:
        res_perm = model.fit(EvalStub(y[:, perm], DIRs, htable, k_perm))
    finally:
        model.scheme = scheme
        model._prep_cache = None
    # f32 reductions run in a different column order after the permutation,
    # which can flip the active-set support on a couple of degenerate
    # noise voxels; the old shape-based inference was off across the board
    # (median 9e-3, p95 0.13, max 0.24 on this exact problem)
    err = np.abs(np.asarray(res_perm['estimates'])
                 - np.asarray(res_first['estimates']))
    assert np.median(err) < 1e-4
    assert np.quantile(err, 0.95) < 1e-2
    assert err.max() < 5e-2


def test_sandi_error_maps_shared_helper():
    """SANDI's RMSE/NRMSE now flow through models._fitops.error_maps; the
    normalized-dictionary prediction A@x equals the un-normalized one."""
    pytest.importorskip('jax')
    from amico_tpu.models import _fitops
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    A = jnp.asarray(np.abs(rng.normal(size=(9, 4))), jnp.float32)
    x = jnp.asarray(np.abs(rng.normal(size=(7, 4))), jnp.float32)
    Y = jnp.asarray(np.abs(rng.normal(size=(7, 9))), jnp.float32)
    out = _fitops.error_maps(A[None], x[None], Y[None], True, True)
    y_est = np.asarray(A) @ np.asarray(x).T
    sq = ((np.asarray(Y) - y_est.T) ** 2).sum(-1)
    np.testing.assert_allclose(np.asarray(out['rmse'])[0],
                               np.sqrt(sq / 9), rtol=1e-5)


def test_czb_full_grid_oracle_parity(tmp_path):
    """CylinderZeppelinBall at the DEFAULT 21-radius grid (26 atoms,
    models.pyx:400-405): the lambda2=4 ridge gives optimal supports well
    past the old 12-round cap, which skewed v/a/d on exactly this
    configuration while the reduced-grid test stayed green."""
    os.environ.setdefault('AMICO_TPU_HOME', str(tmp_path / 'home'))
    from amico_tpu.models import CylinderZeppelinBall
    from tests.test_models import (EvalStub, _prepare, _rand_voxels,
                                   _scheme_v1)

    scheme = _scheme_v1()
    model = CylinderZeppelinBall()
    model.set()            # default Rs: 21 radii
    model.set_solver()
    kernels, htable = _prepare(model, scheme, tmp_path)
    n_rs = len(model.Rs)
    n_perp = len(model.d_perps)

    def A_of(d):
        return np.column_stack([kernels['wmr'][:, d, :].T,
                                kernels['wmh'][:, d, :].T,
                                kernels['iso'].T])

    y, DIRs, lut_idx = _rand_voxels(80, A_of, htable, seed=4)
    res = model.fit(EvalStub(y, DIRs, htable, kernels))
    est = np.asarray(res['estimates'])

    ests_ref = np.zeros((80, 3))
    supports = []
    for i in range(80):
        A = A_of(lut_idx[i])
        x = native.lasso(A, y[i], 0.0, 4.0)
        supports.append(int((x > 1e-9).sum()))
        f1 = x[:n_rs].sum()
        f2 = x[n_rs:n_rs + n_perp].sum() + 1e-16
        v = f1 / (f1 + f2 + 1e-16)
        a = 1e6 * 2 * np.sum(model.Rs * x[:n_rs]) / (f1 + 1e-16)
        d = 4 * v / (np.pi * a ** 2 + 1e-16)
        ests_ref[i] = [v, a, d]
    assert max(supports) > 12          # the regression's precondition
    err = np.abs(est - ests_ref)
    assert np.median(err[:, 0]) < 2e-3      # v (ICVF)
    assert np.percentile(err[:, 0], 95) < 2e-2
    assert np.median(err[:, 1]) < 2e-2      # a (diameter, micrometers)


@pytest.mark.parametrize('seed', range(6))
def test_converge_matches_oracle_randomized(seed):
    """Property sweep: DEFAULT_AS_SOLVER_KW must match the exact native
    oracle on random problems across the regimes the models produce --
    sparse and dense supports, with and without ridge."""
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(8, 30))
    m = int(rng.integers(n, 3 * n))
    A = np.abs(rng.normal(size=(m, n)) + (0.5 if seed % 2 else 0.0))
    A /= np.linalg.norm(A, axis=0)
    y = A @ np.abs(rng.normal(size=n) * (rng.random(n) < 0.6))
    lam2 = [0.0, 1e-3, 4.0][seed % 3]
    G = np.asarray(gram(A))
    b = A.T @ y
    xo = native.qp_nonneg(np.asarray(G + lam2 * np.eye(n), np.float64),
                          np.asarray(b, np.float64))
    x = np.asarray(nneg_qp_batch(G, b, 0.0, lam2, **DEFAULT_AS_SOLVER_KW))
    scale = np.abs(b).max() + 1e-30
    np.testing.assert_allclose(x / scale, xo / scale, atol=3e-5)


def test_solver_kw_presets_accepted_by_both_backends():
    """API contract: every key in the model solver presets must be
    accepted by the solver entry points the models call -- the batched
    solver itself and the per-tile wrapper the fit chunks go through
    (_fitops.solve_tiles forwards them verbatim) -- and both must agree
    with the oracle on the CZB-shaped preset too."""
    from amico_tpu.models._fitops import solve_tiles
    from amico_tpu.models.base import DENSE_AS_SOLVER_KW
    import jax.numpy as jnp

    G, b, x_oracle, lam2 = _dense_support_problem(seed=7)
    Gt = jnp.asarray(G, jnp.float32)[None]
    bt = jnp.asarray(b, jnp.float32)[None, None]
    L = jnp.ones((1,), jnp.float32)
    for kw in (DEFAULT_AS_SOLVER_KW, DENSE_AS_SOLVER_KW):
        x1 = np.asarray(nneg_qp_batch(G, b, 0.0, lam2, **kw))
        x2 = np.asarray(solve_tiles(Gt, bt, L, 0.0, lam2,
                                    solver_kw=kw))[0, 0]
        np.testing.assert_allclose(x1, x_oracle, atol=5e-5)
        np.testing.assert_allclose(x2, x_oracle, atol=5e-5)

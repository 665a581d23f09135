"""Rician-debias parity vs a scipy L-BFGS-B oracle.

The oracle transcribes the reference functional and analytic gradient
(/root/reference/amico/preproc.py:8-21) and minimizes it per voxel with
L-BFGS-B exactly as debiasRician does (preproc.py:23-36).  Our vectorized
Newton inversion of the (separable) Rician mean must land on the same
per-sample solutions.
"""
import numpy as np
import pytest
import scipy.special
from scipy.optimize import minimize

from amico_tpu.io.scheme import Scheme
from amico_tpu.preproc import debiasRician, debias_rician_batch


def _oracle_F(E0, Signal, sigma_diff):
    sig2 = sigma_diff ** 2.0
    lag = scipy.special.eval_laguerre(0.5, -(E0 ** 2.0) / (2.0 * sig2))
    return np.sum((Signal - np.sqrt(np.pi * sig2 / 2.0) * lag) ** 2.0)


def _oracle_jac(E0, Signal, sigma_diff):
    E0 = np.array(E0)
    sig2 = sigma_diff ** 2.0
    k1 = np.sqrt(np.pi * sig2 / 2.0)
    ET = -(E0 ** 2.0) / (2.0 * sig2)
    der1 = 2.0 * (Signal - k1 * scipy.special.eval_laguerre(0.5, ET))
    der2 = k1 * scipy.special.hyp1f1(0.5, 2.0, ET) * (-0.5 / (2.0 * sig2)) * E0
    return der1 * der2


def _oracle_debias(vox, sigma):
    out = np.empty_like(vox)
    for i in range(vox.shape[0]):
        res = minimize(_oracle_F, vox[i].copy(), args=(vox[i], sigma[i]),
                       method='L-BFGS-B', jac=_oracle_jac)
        out[i] = res.x
    return out


def test_rician_mean_matches_laguerre():
    """Our stable Bessel form of sqrt(pi/2) sigma L_{1/2}(-x) must equal the
    reference's eval_laguerre expression over a wide E/sigma range."""
    from amico_tpu.preproc import _rician_mean
    rng = np.random.RandomState(0)
    E = np.abs(rng.rand(500)) * 50.0
    sigma = 0.5 + rng.rand(500) * 5.0
    ours = np.asarray(_rician_mean(E, sigma))
    ref = np.sqrt(np.pi * sigma ** 2 / 2.0) * scipy.special.eval_laguerre(
        0.5, -(E ** 2) / (2.0 * sigma ** 2))
    np.testing.assert_allclose(ours, ref, rtol=2e-5)


def test_newton_inversion_matches_lbfgsb_oracle():
    rng = np.random.RandomState(1)
    n, nS = 40, 20
    E_true = np.abs(rng.rand(n, nS)) * 3.0 + 0.2   # true magnitudes
    sigma = 0.15 + rng.rand(n) * 0.2
    # measured = Rician-biased magnitude (the mean, i.e. exactly invertible)
    from amico_tpu.preproc import _rician_mean
    S = np.asarray(_rician_mean(E_true, sigma[:, None]))

    ours = np.asarray(debias_rician_batch(S.astype(np.float32),
                                          sigma[:, None].astype(np.float32)))
    oracle = _oracle_debias(S, sigma)

    # both must recover E_true; compare them to each other per sample
    delta = np.abs(ours - oracle)
    assert np.max(delta) < 5e-3, np.max(delta)
    assert np.median(delta) < 5e-4
    np.testing.assert_allclose(ours, E_true, atol=5e-3)


def test_debias_pipeline_entry_matches_oracle():
    """Full debiasRician entry point (sigma = mean b0 / SNR, mask handling,
    reference preproc.py:23-36) vs the per-voxel oracle."""
    rng = np.random.RandomState(2)
    tab = np.vstack([np.zeros((2, 4)),
                     np.c_[rng.randn(10, 3), np.full(10, 1000.0)]])
    tab[2:, :3] /= np.linalg.norm(tab[2:, :3], axis=1, keepdims=True)
    scheme = Scheme(tab)
    dim = (3, 3, 2)
    nvox = int(np.prod(dim))
    SNR = 20.0
    vol = np.abs(100.0 * (0.4 + 0.6 * rng.rand(nvox, scheme.nS)))
    vol[:, scheme.b0_idx] = 100.0 + rng.randn(nvox, 2)
    mask = np.ones(dim, np.uint8)
    mask[0, 0, 0] = 0

    DWI = vol.reshape(dim + (scheme.nS,))
    ours = debiasRician(DWI, SNR, mask, scheme)
    assert ours.shape == DWI.shape
    assert np.all(ours[0, 0, 0] == 0)            # outside mask -> zeros

    vox = DWI[mask > 0]
    sigma = vox[:, scheme.b0_idx].mean(axis=1) / SNR
    oracle = _oracle_debias(vox, sigma)
    delta = np.abs(ours[mask > 0] - oracle)
    # bound the max-abs per-voxel difference
    assert np.max(delta) < 1e-2, np.max(delta)
    assert np.median(delta) < 1e-3

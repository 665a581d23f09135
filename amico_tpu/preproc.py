"""Preprocessing: Rician-bias removal.

The reference debiases each voxel by L-BFGS-B minimization of Kaden's SMT
functional over the whole signal vector (/root/reference/amico/preproc.py:
8-36) in a triple-nested Python loop.  The functional is *separable per
sample*: each measurement S contributes (S - g(E))^2 with

    g(E) = sigma sqrt(pi/2) L_{1/2}(-E^2/(2 sigma^2))

the Rician mean.  This build therefore inverts g directly with a
vectorized, fixed-iteration Newton solve over all (voxel, sample) pairs at
once, using the stable Bessel form

    L_{1/2}(-x) = e^{-x/2} ((1+x) I0(x/2) + x I1(x/2)).

Semantics match the reference: sigma = mean(b0)/SNR per voxel
(preproc.py:30-31); voxels outside the mask are returned as 0
(debiased_DWI initialized to zeros, preproc.py:24).
"""
from __future__ import annotations

import numpy as np


def _rician_mean(E, sigma):
    """g(E) = E[Rician(E, sigma)], vectorized (JAX)."""
    import jax.numpy as jnp
    from jax.scipy.special import i0e, i1e
    x = E * E / (2.0 * sigma * sigma + 1e-30)
    half = x / 2.0
    lag = (1.0 + x) * i0e(half) + x * i1e(half)   # e^{-x/2} L_{1/2}(-x)
    return sigma * jnp.sqrt(jnp.pi / 2.0) * lag


def debias_rician_batch(signal, sigma, iters: int = 50):
    """Invert the Rician mean per sample: find E >= 0 with g(E) = S.

    signal: (..., ) array of measured magnitudes; sigma broadcastable.
    Samples below the Rician noise floor g(0) = sigma sqrt(pi/2) map to 0.

    Newton runs in the variable x = E^2 / (2 sigma^2): dg/dE vanishes at
    E = 0 (g is quadratic there), which makes Newton-in-E blow up for
    signals just above the noise floor, while dg/dx -> floor/2 > 0 stays
    bounded away from zero (caught by
    tests/test_preproc_oracle.py::test_newton_inversion_matches_lbfgsb_oracle).
    """
    import jax
    import jax.numpy as jnp
    from jax.scipy.special import i0e, i1e

    S = jnp.asarray(signal)
    sigma = jnp.broadcast_to(jnp.asarray(sigma, S.dtype), S.shape)
    k = sigma * jnp.sqrt(jnp.pi / 2.0)                 # = g(0), noise floor

    def g_of_x(x, k):
        half = x / 2.0
        return k * ((1.0 + x) * i0e(half) + x * i1e(half))

    dg = jax.grad(lambda x, k: g_of_x(x, k).sum(), argnums=0)

    # sigma == 0 means no noise: the Rician mean IS the signal.  Guarding
    # here also keeps x0 = S^2/(2 sigma^2) from overflowing f32 to inf
    # (E = 0 * inf would poison the output with NaNs)
    sig2 = 2.0 * sigma * sigma
    noisy = sig2 > 0.0
    x0 = jnp.where(noisy, jnp.maximum(S * S - sig2, 0.0)
                   / jnp.where(noisy, sig2, 1.0), 0.0)

    def body(_, x):
        r = g_of_x(x, k) - S
        d = jnp.clip(dg(x, k), 1e-12, None)
        return jnp.clip(x - r / d, 0.0, None)

    x = jax.lax.fori_loop(0, iters, body, x0)
    E = sigma * jnp.sqrt(2.0 * x)
    return jnp.where(noisy, jnp.where(S <= k, 0.0, E), S)


def debiasRician(DWI, SNR, mask, scheme):
    """Reference-compatible entry point (preproc.py:23-36): 4-D DWI volume,
    scalar SNR, 3-D mask, Scheme.  Returns the debiased volume (zeros
    outside the mask)."""
    import jax.numpy as jnp

    DWI = np.asarray(DWI)
    mask = np.asarray(mask) > 0
    vox = DWI[mask]                                     # (N, nS)
    b0 = vox[:, scheme.b0_idx].mean(axis=1)
    sigma = (b0 / SNR)[:, None]

    # float32 output: the solve is f32 anyway and the caller casts to f32
    # -- a full-brain f64 buffer would transiently triple host memory
    out = np.zeros(DWI.shape, dtype=np.float32)
    debiased = np.asarray(debias_rician_batch(
        jnp.asarray(vox, jnp.float32), jnp.asarray(sigma, jnp.float32)))
    out[mask] = debiased
    return out

"""Real spherical-harmonics basis (even orders).

In-framework replacement for the reference's dipy dependency
(``real_sh_descoteaux``, /root/reference/amico/lut.pyx:11,117-126).  The
reference only needs a *real, orthonormal, symmetric (even-l)* SH basis: it
fits kernels in SH space, rotates them with the zonal-harmonic trick
(lut.pyx:129-138,258-264) and projects back (lut.pyx:196-224).  Every one of
those steps is basis-convention independent as long as the basis is real,
orthonormal, and its ``m=0`` columns are the standard zonal harmonics --
the addition theorem ``sum_m Y_lm(u) Y_lm(v) = (2l+1)/(4 pi) P_l(u.v)`` is
what makes the rotation exact.  We therefore use the textbook real basis:

* ``m = 0``:  ``N_l0 P_l(cos theta)``
* ``m > 0``:  ``sqrt(2) N_lm  P_l^m(cos theta) cos(m phi)``
* ``m < 0``:  ``sqrt(2) N_l|m| P_l^|m|(cos theta) sin(|m| phi)``

with ``N_lm = sqrt((2l+1)/(4 pi) (l-m)!/(l+m)!)``, columns ordered by
``(l, m)`` with ``l = 0,2,...,lmax`` and ``m = -l..l`` (matching the
reference's column count ``nSH = (lmax+1)(lmax+2)/2``, lut.pyx:187).

Pure NumPy: the SH machinery only runs during one-time LUT precompute (host
side), never in the fit hot path.
"""
from __future__ import annotations

import numpy as np


def cart2sphere(x, y, z):
    """Cartesian -> (r, theta, phi); theta polar from +z, phi azimuth.

    Mirrors dipy's ``cart2sphere`` used at reference lut.pyx:117,124,220.
    """
    x, y, z = np.asarray(x, float), np.asarray(y, float), np.asarray(z, float)
    r = np.sqrt(x * x + y * y + z * z)
    theta = np.arccos(np.clip(np.divide(z, r, out=np.zeros_like(r + z), where=r > 0), -1, 1))
    phi = np.arctan2(y, x)
    return r, theta, phi


def num_sh_coeff(lmax: int) -> int:
    """Number of even-order SH coefficients: (lmax+1)(lmax+2)/2 (lut.pyx:187).

    Only valid for even lmax -- the basis uses even degrees only (axially
    symmetric kernels), and for odd lmax this count disagrees with the
    columns real_sh_basis produces, surfacing later as an opaque shape
    mismatch deep in LUT assembly.  The reference chain errors the same
    way (dipy's sph_harm_ind_list rejects odd sh_order)."""
    if lmax % 2 or lmax < 0:
        raise ValueError(f'lmax must be even and >= 0 (got {lmax}): the SH '
                         'basis uses even degrees only')
    return (lmax + 1) * (lmax + 2) // 2


def sh_degree_info(lmax: int):
    """Per-column (l, m, idx_m0, const) arrays.

    ``idx_m0[c]`` is the column index of the ``m=0`` coefficient of the same
    degree l as column c, and ``const[c] = sqrt(4 pi/(2 l_c + 1))`` -- the
    zonal-rotation constants of reference lut.pyx:129-138.
    """
    ls, ms, idx_m0, const = [], [], [], []
    for l in range(0, lmax + 1, 2):
        # column of (l, m=0) given even-l packing: previous even degrees
        # contribute sum_{k<l/2}(4k+1) = (l/2)(l-1) columns, then +l to m=0
        c_m0 = (l // 2) * (l - 1) + l
        for m in range(-l, l + 1):
            ls.append(l)
            ms.append(m)
            idx_m0.append(c_m0)
            const.append(np.sqrt(4.0 * np.pi / (2.0 * l + 1.0)))
    return (np.array(ls, np.int32), np.array(ms, np.int32),
            np.array(idx_m0, np.int32), np.array(const, np.float64))


def _assoc_legendre_all(lmax: int, x: np.ndarray) -> np.ndarray:
    """All associated Legendre P_l^m(x) for 0<=m<=l<=lmax via stable upward
    recurrence.  Returns array of shape (lmax+1, lmax+1, ...) indexed [l, m].
    """
    x = np.asarray(x, np.float64)
    P = np.zeros((lmax + 1, lmax + 1) + x.shape, dtype=np.float64)
    P[0, 0] = 1.0
    somx2 = np.sqrt(np.clip(1.0 - x * x, 0.0, None))
    # diagonal: P_m^m = (2m-1)!! (-1)^m (1-x^2)^{m/2}; use Condon-Shortley
    for m in range(1, lmax + 1):
        P[m, m] = -(2 * m - 1) * somx2 * P[m - 1, m - 1]
    # first off-diagonal: P_{m+1}^m = (2m+1) x P_m^m
    for m in range(0, lmax):
        P[m + 1, m] = (2 * m + 1) * x * P[m, m]
    # upward in l
    for m in range(0, lmax + 1):
        for l in range(m + 2, lmax + 1):
            P[l, m] = ((2 * l - 1) * x * P[l - 1, m] - (l + m - 1) * P[l - 2, m]) / (l - m)
    return P


def real_sh_basis(lmax: int, theta, phi) -> np.ndarray:
    """Evaluate the real even-order SH basis at (theta, phi).

    Returns (N, nSH) design matrix, the analog of the
    reference's ``real_sh_descoteaux(lmax, theta, phi)[0]`` (lut.pyx:118).
    """
    theta = np.atleast_1d(np.asarray(theta, np.float64))
    phi = np.atleast_1d(np.asarray(phi, np.float64))
    ct = np.cos(theta)
    P = _assoc_legendre_all(lmax, ct)  # (lmax+1, lmax+1, N)

    cols = []
    from math import factorial
    for l in range(0, lmax + 1, 2):
        for m in range(-l, l + 1):
            am = abs(m)
            N_lm = np.sqrt((2 * l + 1) / (4.0 * np.pi)
                           * factorial(l - am) / factorial(l + am))
            if m == 0:
                cols.append(N_lm * P[l, 0])
            elif m > 0:
                cols.append(np.sqrt(2.0) * N_lm * P[l, am] * np.cos(am * phi))
            else:
                cols.append(np.sqrt(2.0) * N_lm * P[l, am] * np.sin(am * phi))
    return np.stack(cols, axis=-1)


def sh_fit_matrix(lmax: int, theta, phi) -> np.ndarray:
    """Least-squares SH fit operator ``pinv(B^T B) B^T`` (lut.pyx:119)."""
    B = real_sh_basis(lmax, theta, phi)
    return np.linalg.pinv(B.T @ B) @ B.T

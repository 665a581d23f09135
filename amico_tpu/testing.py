"""Synthetic-data helpers shared by tests, bench.py and __graft_entry__.py."""
from __future__ import annotations

import os
import tempfile

import numpy as np

from . import lut as _lut
from .utils.jaxcfg import enable_compilation_cache

enable_compilation_cache()
from .io.scheme import Scheme
from .ops.sphere import fibonacci_hemisphere

LMAX = 12
NDIRS = 500


def demo_scheme(nb0: int = 2, shells=(700.0, 2000.0), ndir: int = 24) -> Scheme:
    rows = [np.zeros((nb0, 4))]
    for i, b in enumerate(shells):
        g = fibonacci_hemisphere(ndir)
        rows.append(np.c_[g, np.full(ndir, b)])
    return Scheme(np.vstack(rows))


def demo_noddi(scheme: Scheme | None = None, small: bool = True,
               kernels_dir: str | None = None):
    """Build a NODDI model + resampled KERNELS + hash table in a temp dir.

    ``small=True`` shrinks the atom grid (12 coupled + 1 iso) for fast
    compile; ``small=False`` uses the full reference grid (144 + 1 atoms,
    models.pyx:675-680).
    """
    from .models import NODDI
    scheme = scheme or demo_scheme()
    model = NODDI()
    if small:
        model.set(IC_VFs=np.linspace(0.3, 0.99, 4),
                  IC_ODs=np.array([0.06, 0.3, 0.8]))
    model.set_solver()
    model.scheme = scheme

    out = kernels_dir or tempfile.mkdtemp(prefix='amico_tpu_demo_')
    os.makedirs(out, exist_ok=True)
    from .ops.sphere import resolve_source
    src = resolve_source(NDIRS)
    # the marker keys everything the generated atoms depend on: direction
    # source, the scheme table, and the model's atom grid -- a persistent
    # kernels_dir must never silently resample kernels built for a
    # different protocol or grid
    import hashlib
    sig = hashlib.sha1(repr((
        np.asarray(scheme.raw).tobytes(),
        sorted((k, v.tolist() if isinstance(v, np.ndarray) else v)
               for k, v in model.get_params().items()),
        LMAX, NDIRS)).encode()).hexdigest()[:16]
    marker = os.path.join(out, f'source={src}_sig={sig}')
    # exclusive lock: two concurrent processes sharing a kernels_dir (bench
    # + tests on one AMICO_TPU_HOME) must not race the check-wipe-generate
    # sequence -- a reader mid-resample would see a half-regenerated set
    import fcntl
    with open(os.path.join(out, '.lock'), 'w') as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if not (os.path.isfile(os.path.join(out, 'A_001.npy'))
                and os.path.isfile(marker)):
            # wipe ONLY files this helper owns (atom files + markers):
            # kernels_dir is caller-supplied and may contain unrelated data
            for f in os.listdir(out):
                if (f.startswith('A_') and f.endswith('.npy')) \
                        or f.startswith('source='):
                    os.remove(os.path.join(out, f))
            aux = _lut.load_precomputed_rotation_matrices(LMAX, NDIRS)
            idx_in, idx_out = _lut.aux_structures_generate(scheme, LMAX)
            model.generate(out, aux, idx_in, idx_out, NDIRS)
            open(marker, 'w').close()
    ridx, Ylm = _lut.aux_structures_resample(scheme, LMAX)
    kernels = model.resample(out, ridx, Ylm, False, NDIRS)
    htable = _lut.load_precomputed_hash_table(NDIRS)
    return model, kernels, htable


def demo_voxels(n: int, kernels: dict, htable: np.ndarray, seed: int = 0):
    """Random NODDI mixtures through the actual dictionary + noise."""
    rng = np.random.RandomState(seed)
    n_wm = kernels['wm'].shape[0]
    DIRs = rng.randn(n, 3)
    DIRs /= np.linalg.norm(DIRs, axis=1, keepdims=True)
    lut_idx = _lut.dir_to_lut_idx(DIRs, htable)
    W = rng.rand(n, n_wm + 1) * (rng.rand(n, n_wm + 1) < 0.3)
    W[np.arange(n), rng.randint(n_wm + 1, size=n)] += 0.5
    W /= np.maximum(W.sum(1, keepdims=True), 1e-9)
    K = np.transpose(kernels['wm'], (1, 2, 0))          # (ndirs, nS, n_wm)
    y = np.empty((n, kernels['wm'].shape[2]), np.float64)
    step = 8192
    for i in range(0, n, step):
        sl = slice(i, min(i + step, n))
        Asl = K[lut_idx[sl]]                            # (B, nS, n_wm)
        y[sl] = np.einsum('bsa,ba->bs', Asl, W[sl, :n_wm]) \
            + W[sl, n_wm:] * kernels['iso'][None, :]
    y = np.clip(y + 0.002 * rng.randn(*y.shape), 0, None)
    return y, DIRs, lut_idx


def noddi_oracle_voxel(kernels, dwi_idx, y_i, lut_i, lam1=0.5, lam2=1e-3,
                       algorithm=None, return_x=False, is_exvivo=False):
    """Exact per-voxel NODDI 3-stage reference solve -- the SHARED oracle
    used by the bench's and chip_smoke.py's accuracy audits and the tests
    (one definition so a recipe change cannot desynchronize an audit's
    'oracle' from another's).  Mirrors reference models.pyx:900-981:
    (1) NNLS on the full dictionary for the CSF fraction; (2) non-negative
    lasso (LARS by default, the algorithm SPAMS runs) on the norm-scaled
    DWI subproblem with the iso (and ex-vivo dot) prediction subtracted,
    clipped >= 0; (3) debias re-NNLS on the positive support with iso
    (and dot) forced in.  Returns the (NDI, ODI, FWF[, dot]) vector; with
    ``return_x``, the tuple ``(maps, x, x2)`` where ``x`` is the debiased
    coefficient vector and ``x2`` the raw stage-2 solution."""
    from .ops import native
    n_wm = kernels['wm'].shape[0]
    n_tail = 2 if is_exvivo else 1            # [dot,] iso after the WM atoms
    cols = [kernels['wm'][:, lut_i, :].T]
    if is_exvivo:
        cols.append(np.ones(kernels['iso'].shape[0]))
    A = np.column_stack(cols + [kernels['iso']])
    x1, _ = native.nnls(A, y_i)
    y2 = y_i[dwi_idx] - x1[-1] * kernels['iso'][dwi_idx]
    if is_exvivo:
        y2 = y2 - x1[n_wm]
    y2 = np.clip(y2, 0, None)
    A2 = A[dwi_idx][:, :n_wm] * kernels['norms'][None, :]
    kw = {} if algorithm is None else {'algorithm': algorithm}
    x2 = native.lasso(A2, y2, lam1, lam2, **kw)
    x = np.zeros(n_wm + n_tail)
    x[:n_wm] = x2
    x[n_wm:] = 1.0
    sup = np.where(x > 0)[0]
    x3, _ = native.nnls(A[:, sup], y_i)
    x[:] = 0.0
    x[sup] = x3
    sa = x.sum() + 1e-16
    xn = x[:n_wm] / sa
    sw = xn.sum() + 1e-16
    f1 = np.sum(kernels['icvf'] * xn) / sw
    f2 = np.sum((1 - kernels['icvf']) * xn) / sw
    k1 = np.sum(kernels['kappa'] * xn) / sw
    maps = [f1 / (f1 + f2 + 1e-16), 2 / np.pi * np.arctan2(1.0, k1),
            x[-1] / sa]
    if is_exvivo:
        maps.append(x[n_wm] / sa)
    maps = np.array(maps)
    return (maps, x, x2) if return_x else maps

"""Direction sets and the direction-quantization hash table.

The reference ships 45 binary files with precomputed hemisphere direction
sets and 181x181 nearest-direction hash tables
(/root/reference/amico/directions/, loaded at lut.pyx:47-91).  This build
*generates* both deterministically instead of shipping binaries
(SURVEY.md section 7 step 3):

* direction sets: spherical-Fibonacci points on the y>=0 hemisphere (the
  hemisphere the whole pipeline canonicalizes into, scheme.py:91-92,
  lut.pyx:335-338);
* ``ndirs=32761``: the 181x181 (theta, phi) 1-degree grid itself
  (the grid indexed by ``dir_to_lut_idx``, lut.pyx:349-356);
* ``ndirs=1``: the single +z axis;
* hash table: for each of the 181x181 grid points, the index of the nearest
  direction by axial distance (|dot|), stored int16 like the reference.

Results are cached on disk under ``~/.amico_tpu/directions`` keyed by ndirs
(same resume-by-existence semantics as the reference's dipy_home pickles,
SURVEY.md section 5.4).
"""
from __future__ import annotations

import os

import numpy as np

_GOLDEN = (1.0 + np.sqrt(5.0)) / 2.0


def amico_home() -> str:
    path = os.environ.get('AMICO_TPU_HOME',
                          os.path.join(os.path.expanduser('~'), '.amico_tpu'))
    os.makedirs(path, exist_ok=True)
    return path


def _atomic_save(fn: str, arr: np.ndarray) -> None:
    """np.save via tmp-file + rename: concurrent processes (multi-host
    setup racing on a shared home, lut/rotation.py:96-101 scenario) must
    never np.load a torn file, and a crash must not leave a truncated
    cache that poisons every later run."""
    tmp = f'{fn}.{os.getpid()}.tmp.npy'   # .npy suffix: np.save appends none
    np.save(tmp, arr)
    os.replace(tmp, fn)


def valid_dirs() -> list[int]:
    """Supported ndirs values; same set as the reference (lut.pyx:18-25)."""
    return np.arange(start=500, stop=10500, step=500).tolist() + [1, 32761]


def is_valid(ndirs: int) -> bool:
    return ndirs in valid_dirs()


def resolve_source(ndirs: int, source: str | None = None) -> str:
    """Resolve the direction-data source for ``ndirs``.

    'reference' uses upstream AMICO's shipped binary data (vendored for the
    default ndirs=500, loadable from an AMICO install for the rest; see
    amico_tpu.lut.refdata) so LUT indices and maps are bit-compatible with
    upstream.  'generated' uses the deterministic in-framework sets below.
    'auto' (default, or via AMICO_TPU_DIRECTION_SOURCE) picks 'reference'
    whenever that data is obtainable.
    """
    src = source or os.environ.get('AMICO_TPU_DIRECTION_SOURCE', 'auto')
    if src == 'auto':
        from ..lut import refdata
        src = ('reference' if refdata.has_reference_directions(ndirs)
               else 'generated')
    if src not in ('reference', 'generated'):
        raise ValueError(f'direction source must be "reference", "generated" '
                         f'or "auto", got "{src}"')
    return src


def fibonacci_hemisphere(n: int) -> np.ndarray:
    """n spherical-Fibonacci points on the y>=0 hemisphere, unit vectors.

    Construction: Fibonacci lattice on the z>=0 hemisphere, then rotate
    +z -> +y (x, y, z) -> (x, z, -y) so the set lives in the same hemisphere
    the pipeline canonicalizes into.
    """
    i = np.arange(n, dtype=np.float64)
    z = (i + 0.5) / n                     # uniform in (0, 1): z>=0 hemisphere
    phi = 2.0 * np.pi * i / _GOLDEN
    r = np.sqrt(1.0 - z * z)
    x, y = r * np.cos(phi), r * np.sin(phi)
    dirs = np.stack([x, z, -y], axis=1)   # rotate +z -> +y
    return dirs


def grid_directions() -> np.ndarray:
    """The 181x181 1-degree (theta, phi) grid as unit vectors (ndirs=32761).

    theta in [0, 180] deg from +z, phi in [0, 180] deg -> y >= 0, matching
    the index layout of ``dir_to_lut_idx`` (lut.pyx:349-356).
    """
    t = np.deg2rad(np.arange(181, dtype=np.float64))
    th, ph = np.meshgrid(t, t, indexing='ij')
    st = np.sin(th)
    return np.stack([st * np.cos(ph), st * np.sin(ph), np.cos(th)],
                    axis=-1).reshape(-1, 3)


def load_directions(ndirs: int, source: str | None = None) -> np.ndarray:
    """Return the (ndirs, 3) float64 direction set (reference lut.pyx:47-68).

    ``source``: 'reference' | 'generated' | None (= 'auto', prefer
    reference data when obtainable; see :func:`resolve_source`).
    """
    if resolve_source(ndirs, source) == 'reference':
        from ..lut import refdata
        return refdata.load_reference_directions(ndirs)
    if ndirs == 1:
        return np.array([[0.0, 0.0, 1.0]])
    if ndirs == 32761:
        return grid_directions()
    cache = os.path.join(amico_home(), 'directions')
    os.makedirs(cache, exist_ok=True)
    fn = os.path.join(cache, f'ndirs={ndirs}.npy')
    if os.path.isfile(fn):
        return np.load(fn)
    dirs = fibonacci_hemisphere(ndirs)
    _atomic_save(fn, dirs)
    return dirs


def build_hash_table(directions: np.ndarray) -> np.ndarray:
    """(181*181,) int16 nearest-direction index per 1-degree grid point.

    Nearest by axial metric |dot| since directions represent axes (the
    kernels are antipodally symmetric).  Replaces the shipped
    ``htable_ndirs=N.bin`` files (lut.pyx:71-91).
    """
    grid = grid_directions().astype(np.float32)    # (32761, 3)
    dirsT = np.ascontiguousarray(directions.T, dtype=np.float32)
    # chunk to bound memory for large ndirs
    out = np.empty(grid.shape[0], dtype=np.int16)
    step = 4096
    for i in range(0, grid.shape[0], step):
        dots = np.abs(grid[i:i + step] @ dirsT)
        out[i:i + step] = np.argmax(dots, axis=1).astype(np.int16)
    return out


def load_precomputed_hash_table(ndirs: int,
                                source: str | None = None) -> np.ndarray:
    """Disk-cached hash table (reference lut.pyx:71-91 semantics).

    The builder reproduces the shipped tables: bit-identical for the
    default ndirs=500 set (tests/test_refdata.py) -- residual differences
    at other counts are argmax ties between equidistant directions.
    """
    if resolve_source(ndirs, source) == 'reference':
        from ..lut import refdata
        return refdata.load_reference_hash_table(ndirs)
    if ndirs == 32761:
        # the grid's nearest grid direction is itself; the shipped
        # htable_ndirs=32761.bin is exactly this identity map
        return np.arange(32761, dtype=np.int16)
    cache = os.path.join(amico_home(), 'directions')
    os.makedirs(cache, exist_ok=True)
    fn = os.path.join(cache, f'htable_ndirs={ndirs}.npy')
    if os.path.isfile(fn):
        return np.load(fn)
    ht = build_hash_table(load_directions(ndirs, source='generated'))
    _atomic_save(fn, ht)
    return ht

"""Reference-data parity harness.

Validates bit-compatibility with the data upstream AMICO ships: the binary
loaders (lut.pyx:47-91 formats), the vendored default direction set + hash
table + embedded 500-dir grad table (lut.pyx:390-891), our regenerators
against the shipped tables, and the LUT semantics (quantize -> gather ->
rotate -> resample) on the reference's own direction data.
"""
import os
import re

import numpy as np
import pytest

from amico_tpu.io.scheme import Scheme
from amico_tpu.lut import refdata
from amico_tpu.lut import rotation as rot
from amico_tpu.ops import sh as shmod
from amico_tpu.ops import sphere as sph

REF_DIRS = '/root/reference/amico/directions'
REF_LUT_PYX = '/root/reference/amico/lut.pyx'
have_ref = os.path.isdir(REF_DIRS)
needs_ref = pytest.mark.skipif(not have_ref,
                               reason='reference AMICO data not present')


# ------------------------------------------------------------ vendored data
def test_vendored_dirs500_format():
    d = refdata.load_reference_directions(500)
    assert d.shape == (500, 3) and d.dtype == np.float64
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-6)
    assert (d[:, 1] >= 0).all()          # y>=0 hemisphere (lut.pyx:335-338)


def test_vendored_htable500_format():
    ht = refdata.load_reference_hash_table(500)
    assert ht.shape == (refdata.N_GRID,) and ht.dtype == np.int16
    assert ht.min() >= 0 and ht.max() <= 499


def test_vendored_grad_format():
    g = refdata.reference_grad()
    assert g.shape == (500, 3)
    np.testing.assert_allclose(np.linalg.norm(g, axis=1), 1.0, atol=1e-6)
    assert (g[:, 1] > 0).all()


# ----------------------------------------------- loaders vs shipped binaries
@needs_ref
def test_vendored_matches_shipped_binaries():
    d = np.fromfile(os.path.join(REF_DIRS, 'ndirs=500.bin'),
                    np.float64).reshape(500, 3)
    np.testing.assert_array_equal(refdata.load_reference_directions(500), d)
    ht = np.fromfile(os.path.join(REF_DIRS, 'htable_ndirs=500.bin'), np.int16)
    np.testing.assert_array_equal(refdata.load_reference_hash_table(500), ht)


@needs_ref
def test_bundle_matches_shipped_binaries_all_ndirs():
    """The vendored npz bundle is bit-identical to every shipped binary
    (out-of-box parity at every valid ndirs)."""
    import re as _re
    shipped = sorted(int(m.group(1)) for f in os.listdir(REF_DIRS)
                     if (m := _re.fullmatch(r'ndirs=(\d+)\.bin', f)))
    assert set(shipped) == set(sph.valid_dirs())
    for n in shipped:
        d = np.fromfile(os.path.join(REF_DIRS, f'ndirs={n}.bin'),
                        np.float64).reshape(n, 3)
        np.testing.assert_array_equal(refdata.load_reference_directions(n), d)
        ht = np.fromfile(os.path.join(REF_DIRS, f'htable_ndirs={n}.bin'),
                         np.int16)
        np.testing.assert_array_equal(refdata.load_reference_hash_table(n),
                                      ht)
        assert refdata.has_reference_directions(n)


@needs_ref
def test_loader_reads_amico_directions_folder(monkeypatch):
    monkeypatch.setenv('AMICO_TPU_REFERENCE_DIRECTIONS', REF_DIRS)
    for n in (1, 1000, 32761):
        d = refdata.load_reference_directions(n)
        assert d.shape == (n, 3)
        ht = refdata.load_reference_hash_table(n)
        assert ht.shape == (refdata.N_GRID,)
    assert refdata.has_reference_directions(1000)


@needs_ref
def test_vendored_grad_matches_embedded_table():
    src = open(REF_LUT_PYX).read()
    body = re.search(r'grad = np\.array\(\[(.*?)\]\)', src, re.S).group(1)
    rows = re.findall(
        r'\[\s*([-\d.eE+]+),\s*([-\d.eE+]+),\s*([-\d.eE+]+)\s*\]', body)
    np.testing.assert_array_equal(refdata.reference_grad(),
                                  np.array(rows, dtype=np.float64))


# ------------------------------------------- regenerators vs shipped tables
def test_hash_builder_reproduces_shipped_500():
    """Our nearest-axis builder reproduces htable_ndirs=500.bin exactly."""
    mine = sph.build_hash_table(refdata.load_reference_directions(500))
    np.testing.assert_array_equal(mine, refdata.load_reference_hash_table(500))


@needs_ref
def test_grid_is_the_reference_32761_set():
    d = np.fromfile(os.path.join(REF_DIRS, 'ndirs=32761.bin'),
                    np.float64).reshape(-1, 3)
    np.testing.assert_allclose(sph.grid_directions(), d, atol=1e-14)
    ht = np.fromfile(os.path.join(REF_DIRS, 'htable_ndirs=32761.bin'),
                     np.int16)
    np.testing.assert_array_equal(ht, np.arange(32761, dtype=np.int16))
    np.testing.assert_array_equal(sph.load_precomputed_hash_table(
        32761, source='generated'), ht)


@needs_ref
def test_hash_builder_near_parity_other_ndirs(monkeypatch):
    """At other direction counts residual differences are argmax ties
    between (anti)parallel-equidistant candidates; bound them."""
    for n, floor in ((1000, 0.999), (2500, 0.999)):
        d = np.fromfile(os.path.join(REF_DIRS, f'ndirs={n}.bin'),
                        np.float64).reshape(n, 3)
        ht = np.fromfile(os.path.join(REF_DIRS, f'htable_ndirs={n}.bin'),
                         np.int16)
        assert (sph.build_hash_table(d) == ht).mean() >= floor


# ------------------------------------------------------- source selection
def test_source_selection(tmp_path, monkeypatch):
    monkeypatch.setenv('AMICO_TPU_HOME', str(tmp_path))
    # every upstream-shipped count is vendored, so 'auto' = 'reference'
    assert sph.resolve_source(500) == 'reference'
    assert sph.resolve_source(1000) == 'reference'
    assert sph.resolve_source(700) == 'generated'       # never shipped
    ref = sph.load_directions(500)
    gen = sph.load_directions(500, source='generated')
    np.testing.assert_array_equal(ref, refdata.load_reference_directions(500))
    assert not np.allclose(ref, gen)
    monkeypatch.setenv('AMICO_TPU_DIRECTION_SOURCE', 'generated')
    np.testing.assert_array_equal(sph.load_directions(500), gen)


def test_aux_cache_keyed_by_source(tmp_path, monkeypatch):
    monkeypatch.setenv('AMICO_TPU_HOME', str(tmp_path))
    aux_ref = rot.load_precomputed_rotation_matrices(4, 500)
    aux_gen = rot.load_precomputed_rotation_matrices(4, 500,
                                                     source='generated')
    assert aux_ref['source'] == 'reference'
    assert aux_gen['source'] == 'generated'
    assert not np.allclose(aux_ref['Ylm_rot'], aux_gen['Ylm_rot'])
    np.testing.assert_array_equal(aux_ref['grad'], refdata.reference_grad())


def test_stale_aux_cache_self_heals(tmp_path, monkeypatch):
    """An AUX pickle written by an older build (no source tag) under the
    reference-source filename must be rebuilt, not trusted."""
    import pickle
    monkeypatch.setenv('AMICO_TPU_HOME', str(tmp_path))
    fn = rot._aux_filename(4, 500, 'reference')
    with open(fn, 'wb') as fid:
        pickle.dump({'lmax': 4, 'ndirs': 500}, fid)
    aux = rot.load_precomputed_rotation_matrices(4, 500)
    assert aux['source'] == 'reference' and 'fit' in aux


# ------------------------------------- LUT semantics on reference data
def _zeppelin(g, b, d_par, d_perp, axis):
    cos2 = (g @ axis) ** 2
    return np.exp(-b * (d_perp + (d_par - d_perp) * cos2))


def test_quantizer_on_reference_htable():
    """Each reference direction, quantized through the shipped hash table,
    must land back on (a direction indistinguishable from) itself."""
    dirs = refdata.load_reference_directions(500)
    ht = refdata.load_reference_hash_table(500)
    idx = rot.dir_to_lut_idx(dirs, ht)
    dots = np.abs(np.sum(dirs[idx] * dirs, axis=1))
    assert np.min(dots) > np.cos(np.deg2rad(3.0))
    assert (idx == np.arange(500)).mean() > 0.9


def test_rotation_chain_on_reference_data(tmp_path, monkeypatch):
    """generate->rotate->resample on the reference grad + direction set:
    the kernel rotated to reference direction u must equal direct synthesis
    along u on the subject scheme (reference LUT semantics,
    lut.pyx:227-311)."""
    monkeypatch.setenv('AMICO_TPU_HOME', str(tmp_path))
    lmax, ndirs = 12, 500
    aux = rot.load_precomputed_rotation_matrices(lmax, ndirs)
    assert aux['source'] == 'reference'
    dirs = refdata.load_reference_directions(ndirs)

    rng = np.random.RandomState(7)
    g = rng.randn(40, 3)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    tab = np.vstack([np.zeros((1, 4)), np.c_[g, np.full(40, 1200.0)]])
    scheme = Scheme(tab)

    hs = rot.create_high_resolution_scheme(scheme, grad=aux['grad'])
    np.testing.assert_array_equal(hs.raw[:500, :3], refdata.reference_grad())
    K = _zeppelin(hs.raw[:, :3], hs.b, 1.7e-3, 0.4e-3, np.array([0, 0, 1.0]))

    idx_in, idx_out = rot.aux_structures_generate(scheme, lmax)
    KRlm = rot.rotate_kernel(K, aux, idx_in, idx_out, False, ndirs)
    ridx, Ylm_out = rot.aux_structures_resample(scheme, lmax)
    KR = rot.resample_kernel(KRlm, scheme.nS, ridx, Ylm_out, False, ndirs)

    for i in [3, 99, 250, 499]:
        direct = _zeppelin(scheme.raw[:, :3], scheme.b, 1.7e-3, 0.4e-3,
                           dirs[i])
        direct[scheme.b0_idx] = 1.0
        np.testing.assert_allclose(KR[i], direct, atol=2e-3)


def test_sh_fit_conditioning_on_reference_grad():
    g = refdata.reference_grad()
    _, theta, phi = shmod.cart2sphere(g[:, 0], g[:, 1], g[:, 2])
    B = shmod.real_sh_basis(12, theta, phi)
    s = np.linalg.svd(B, compute_uv=False)
    assert s[0] / s[-1] < 20.0


# --------------------------- map-level delta: reference vs generated source
def test_noddi_map_delta_reference_vs_generated(tmp_path, monkeypatch):
    """Quantify what switching direction sources does to NODDI maps.

    Both pipelines fit the same signals (synthesized through the
    reference-source dictionary); the generated-source fit sees them through
    its own dictionary + LUT.  The delta bounds the direction-set
    discretization effect, recorded in PARITY.md.
    """
    monkeypatch.setenv('AMICO_TPU_HOME', str(tmp_path / 'home'))
    from amico_tpu.models import NODDI
    from amico_tpu import lut as _lut

    def build(source, kdir):
        model = NODDI()
        model.set(IC_VFs=np.linspace(0.3, 0.99, 4),
                  IC_ODs=np.array([0.06, 0.3, 0.8]))
        model.set_solver()
        g = sph.fibonacci_hemisphere(24)
        tab = np.vstack([np.zeros((2, 4)), np.c_[g, np.full(24, 700.0)],
                         np.c_[g, np.full(24, 2000.0)]])
        model.scheme = Scheme(tab)
        os.makedirs(kdir, exist_ok=True)
        aux = rot.load_precomputed_rotation_matrices(12, 500, source=source)
        idx_in, idx_out = rot.aux_structures_generate(model.scheme, 12)
        model.generate(kdir, aux, idx_in, idx_out, 500)
        ridx, Ylm = rot.aux_structures_resample(model.scheme, 12)
        kernels = model.resample(kdir, ridx, Ylm, False, 500)
        htable = sph.load_precomputed_hash_table(500, source=source)
        return model, kernels, htable

    m_ref, k_ref, ht_ref = build('reference', str(tmp_path / 'kref'))
    m_gen, k_gen, ht_gen = build('generated', str(tmp_path / 'kgen'))

    rng = np.random.RandomState(11)
    n = 128
    DIRs = rng.randn(n, 3)
    DIRs /= np.linalg.norm(DIRs, axis=1, keepdims=True)
    lut_idx = _lut.dir_to_lut_idx(DIRs, ht_ref)
    n_wm = k_ref['wm'].shape[0]
    W = rng.rand(n, n_wm + 1) * (rng.rand(n, n_wm + 1) < 0.3)
    W[np.arange(n), rng.randint(n_wm + 1, size=n)] += 0.5
    W /= W.sum(1, keepdims=True)
    y = np.stack([
        np.column_stack([k_ref['wm'][:, lut_idx[i], :].T,
                         k_ref['iso']]) @ W[i] for i in range(n)])
    y = np.clip(y + 0.002 * rng.randn(*y.shape), 0, None)

    class Ctx:
        def __init__(s, ht, K):
            s.y, s.DIRs, s.htable, s.KERNELS = y, DIRs, ht, K

        def get_config(s, key):
            return {'tile_size': 32, 'voxels_per_chunk': 4096}.get(key)

    est_ref = m_ref.fit(Ctx(ht_ref, k_ref))['estimates']
    est_gen = m_gen.fit(Ctx(ht_gen, k_gen))['estimates']
    delta = np.abs(est_ref - est_gen)
    med, p95 = np.median(delta), np.percentile(delta, 95)
    print(f'\nNODDI map delta reference-vs-generated source: '
          f'median={med:.2e} p95={p95:.2e} max={delta.max():.2e}')
    # the two discretizations must agree to map precision
    assert med < 5e-3
    assert p95 < 5e-2

"""Regression tests for the round-2 self-review findings.

Each test pins one fixed defect: labeled/0-255 masks, stale staged device
chunks after a DIRs swap, partial reference-directions folders, the lmax
cache-staleness guard, and the ``python -m`` entry-point import guard.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import amico_tpu
from amico_tpu.io import nifti
from amico_tpu.ops.sphere import fibonacci_hemisphere


def _write_subject(subj, mask_values):
    g = fibonacci_hemisphere(24)
    tab = np.vstack([np.zeros((2, 4)), np.c_[g, np.full(24, 1000.0)],
                     np.c_[g, np.full(24, 2500.0)]])
    np.savetxt(subj / 'DWI.scheme', tab, fmt='%.6f',
               header='VERSION: BVECTOR', comments='')
    rng = np.random.RandomState(0)
    vol = np.abs(300 * (0.3 + 0.5 * rng.rand(4, 4, 2, 50))).astype(np.float32)
    vol[..., :2] = 300.0
    nifti.save(nifti.Nifti1Image(vol), str(subj / 'DWI.nii.gz'))
    nifti.save(nifti.Nifti1Image(mask_values.astype(np.uint8)),
               str(subj / 'mask.nii.gz'))


def test_labeled_mask_only_fits_ones(tmp_path):
    """Masks are selected on ``mask == 1`` exactly (reference core.py:451):
    a labeled volume (values 0/1/2) must fit only the 1-voxels and scatter
    zeros elsewhere -- the voxel-count bookkeeping used count_nonzero and
    crashed or misaligned on such masks."""
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    amico_tpu.set_verbose(0)
    subj = tmp_path / 's'
    subj.mkdir()
    mask = np.zeros((4, 4, 2), np.uint8)
    mask[:2] = 1
    mask[2] = 2          # labeled region that must NOT be fit
    _write_subject(subj, mask)
    ev = amico_tpu.Evaluation(str(tmp_path), 's')
    ev.set_config('tile_size', 32)
    ev.load_data('DWI.nii.gz', 'DWI.scheme', mask_filename='mask.nii.gz')
    ev.set_model('FreeWater')
    ev.generate_kernels(regenerate=True)
    ev.load_kernels()
    ev.fit()
    maps = ev.RESULTS['MAPs']
    assert maps.shape[:3] == mask.shape
    assert np.isfinite(maps).all()
    assert (maps[mask != 1] == 0).all()
    assert np.abs(maps[mask == 1]).sum() > 0


def test_stage_cache_invalidated_by_new_dirs(tmp_path):
    """Re-fitting the same y with different DIRs must re-tile: the staged
    device chunks were keyed only on y and the tile count, so a DIRs swap
    with a coincidentally equal tile count reused stale buckets."""
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    from amico_tpu.testing import demo_noddi, demo_voxels
    model, kernels, htable = demo_noddi(kernels_dir=str(tmp_path / 'k'))
    y, DIRs_a, _ = demo_voxels(64, kernels, htable, seed=0)
    rng = np.random.RandomState(99)
    DIRs_b = rng.randn(64, 3)
    DIRs_b /= np.linalg.norm(DIRs_b, axis=1, keepdims=True)

    class Ctx:
        def __init__(s, dirs):
            s.y, s.DIRs, s.htable, s.KERNELS = y, dirs, htable, kernels

        def get_config(s, k):
            return {'tile_size': 32, 'voxels_per_chunk': 4096}.get(k)

    est_a = model.fit(Ctx(DIRs_a))['estimates']
    est_b_warm = model.fit(Ctx(DIRs_b))['estimates']     # same y object
    fresh = type(model)()
    fresh.set(IC_VFs=model.IC_VFs, IC_ODs=model.IC_ODs)
    fresh.set_solver()
    fresh.scheme = model.scheme
    est_b_fresh = fresh.fit(Ctx(DIRs_b))['estimates']
    assert not np.allclose(est_a, est_b_warm)            # DIRs changed maps
    np.testing.assert_allclose(est_b_warm, est_b_fresh, atol=1e-6)


def test_refdata_partial_folder_falls_back_to_vendored(tmp_path, monkeypatch):
    """A configured AMICO directions folder holding only some ndirs files
    must not shadow the vendored bundle (which covers every shipped count)."""
    from amico_tpu.lut import refdata
    monkeypatch.setenv('AMICO_TPU_REFERENCE_DIRECTIONS', str(tmp_path))
    for n in (500, 1000):
        assert refdata.has_reference_directions(n)
        dirs = refdata.load_reference_directions(n)
        assert dirs.shape == (n, 3)
        ht = refdata.load_reference_hash_table(n)
        assert ht.shape == (refdata.N_GRID,)
    # counts upstream never shipped stay unavailable
    assert not refdata.has_reference_directions(700)
    with pytest.raises(FileNotFoundError):
        refdata.load_reference_directions(700)


def test_lmax_mismatch_detected(tmp_path):
    """Cached kernels generated at one lmax must refuse to load at another
    (same failure class as the existing ndirs staleness guard)."""
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    amico_tpu.set_verbose(0)
    subj = tmp_path / 's'
    subj.mkdir()
    mask = np.ones((4, 4, 2), np.uint8)
    _write_subject(subj, mask)
    ev = amico_tpu.Evaluation(str(tmp_path), 's')
    ev.load_data('DWI.nii.gz', 'DWI.scheme', mask_filename='mask.nii.gz')
    ev.set_model('FreeWater')
    ev.generate_kernels(regenerate=True, lmax=12)
    ev2 = amico_tpu.Evaluation(str(tmp_path), 's')
    ev2.load_data('DWI.nii.gz', 'DWI.scheme', mask_filename='mask.nii.gz')
    ev2.set_model('FreeWater')
    ev2.generate_kernels(lmax=8)          # cached -> early return
    from amico_tpu.utils.logging import AmicoError
    with pytest.raises(AmicoError, match='lmax'):
        ev2.load_kernels()


def test_main_module_import_does_not_exit():
    """Importing amico_tpu.__main__ (pydoc, coverage, multiprocessing spawn)
    must not run the CLI or exit the process."""
    code = ('import importlib; m = importlib.import_module("amico_tpu.__main__"); '
            'print("imported", hasattr(m, "main"))')
    out = subprocess.run([sys.executable, '-c', code],
                         capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    assert 'imported True' in out.stdout


# ------------------------------------------------ review batch 5 findings

def test_interrupted_lut_generation_is_rebuilt(tmp_path):
    """A_*.npy files without the lut_meta.pickle completion marker are an
    interrupted generation, not a cache: generate_kernels must rebuild
    instead of logging 'cached LUT found' and leaving load_kernels to die
    on the missing atoms."""
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    amico_tpu.set_verbose(0)
    subj = tmp_path / 's'
    subj.mkdir()
    _write_subject(subj, np.ones((4, 4, 2), np.uint8))
    ev = amico_tpu.Evaluation(str(tmp_path), 's')
    ev.load_data('DWI.nii.gz', 'DWI.scheme')
    ev.set_model('FreeWater')
    ev.generate_kernels(regenerate=True)
    atoms = ev.get_config('ATOMS_path')
    names = sorted(os.listdir(atoms))
    assert 'lut_meta.pickle' in names
    # simulate a crash mid-generation: marker missing, one atom missing
    os.remove(os.path.join(atoms, 'lut_meta.pickle'))
    os.remove(os.path.join(atoms, names[-2]))
    ev.generate_kernels()                      # must rebuild, not skip
    names2 = sorted(os.listdir(atoms))
    assert names2 == names
    ev.load_kernels()                          # and the LUT is complete


def test_merge_b0_with_directional_average_is_consistent(tmp_path):
    """doMergeB0 + doDirectionalAverage: the merge is skipped (the shell
    average already collapses the b0s) instead of desynchronizing the
    image layout from the scheme indices -- the reference silently mixes
    columns here (core.py:225-268)."""
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    amico_tpu.set_verbose(0)
    subj = tmp_path / 's'
    subj.mkdir()
    # directional averaging needs a STEJSKALTANNER scheme (the derived
    # per-shell table carries G/Delta/delta, reference core.py:241-252)
    from amico_tpu.io.scheme import GAMMA
    Delta, delta = 0.035, 0.015
    rows = [np.array([[0, 0, 0, 0, Delta, delta, Delta + delta]])] * 2
    for b in (1000.0, 2500.0):
        g = fibonacci_hemisphere(20)
        G = np.sqrt(b * 1e6 / (GAMMA ** 2 * delta ** 2 * (Delta - delta / 3)))
        rows.append(np.c_[g, np.full(20, G), np.full(20, Delta),
                          np.full(20, delta), np.full(20, Delta + delta)])
    np.savetxt(subj / 'DWI.scheme', np.vstack(rows), fmt='%.6f',
               header='VERSION: 1', comments='')
    vol = np.abs(100 * (0.3 + 0.7 * np.random.RandomState(0)
                        .rand(4, 4, 2, 42))).astype(np.float32)
    vol[..., :2] = 100.0
    nifti.save(nifti.Nifti1Image(vol), str(subj / 'DWI.nii.gz'))
    ev = amico_tpu.Evaluation(str(tmp_path), 's')
    ev.set_config('doMergeB0', True)
    ev.set_config('doDirectionalAverage', True)
    ev.load_data('DWI.nii.gz', 'DWI.scheme')
    # 2 shells -> 1 mean b0 + 2 shell means, matching the derived scheme
    assert ev.niiDWI_img.shape[3] == 3
    assert ev.scheme.nS == 3
    assert np.isfinite(ev.niiDWI_img).all()

    # the averages must equal the plain directional-average run
    ev2 = amico_tpu.Evaluation(str(tmp_path), 's')
    ev2.set_config('doDirectionalAverage', True)
    ev2.load_data('DWI.nii.gz', 'DWI.scheme')
    np.testing.assert_array_equal(ev.niiDWI_img, ev2.niiDWI_img)


def test_no_b0_guards(tmp_path):
    """doMergeB0 / doDebiasSignal on a scheme without b0 volumes fail with
    a clear error instead of NaN-merging or silently no-op debiasing."""
    from amico_tpu.utils.logging import AmicoError
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    amico_tpu.set_verbose(0)
    subj = tmp_path / 's'
    subj.mkdir()
    g = fibonacci_hemisphere(24)
    tab = np.c_[g, np.full(24, 1000.0)]       # no b0 rows at all
    np.savetxt(subj / 'DWI.scheme', tab, fmt='%.6f',
               header='VERSION: BVECTOR', comments='')
    vol = np.abs(np.random.RandomState(0).rand(4, 4, 2, 24) * 100 + 50
                 ).astype(np.float32)
    nifti.save(nifti.Nifti1Image(vol), str(subj / 'DWI.nii.gz'))

    for cfg in ({'doMergeB0': True}, {'doDebiasSignal': True, 'DWI-SNR': 20}):
        ev = amico_tpu.Evaluation(str(tmp_path), 's')
        ev.set_config('doNormalizeSignal', False)
        for k, v in cfg.items():
            ev.set_config(k, v)
        with pytest.raises(AmicoError, match='[Nn]o b0'):
            ev.load_data('DWI.nii.gz', 'DWI.scheme')


def test_peaks_file_validation(tmp_path):
    """A 3-D peaks file fails with a clear error (not a %-format
    TypeError); NaN peak rows inside the mask are treated as
    direction-free instead of crashing the LUT quantizer mid-fit."""
    from amico_tpu.utils.logging import AmicoError
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    amico_tpu.set_verbose(0)
    subj = tmp_path / 's'
    subj.mkdir()
    _write_subject(subj, np.ones((4, 4, 2), np.uint8))

    # 3-D peaks: rejected cleanly
    nifti.save(nifti.Nifti1Image(np.zeros((4, 4, 2), np.float32)),
               str(subj / 'peaks3d.nii.gz'))
    ev = amico_tpu.Evaluation(str(tmp_path), 's')
    ev.set_config('peaks_filename', 'peaks3d.nii.gz')
    ev.load_data('DWI.nii.gz', 'DWI.scheme')
    ev.set_model('FreeWater')
    ev.generate_kernels(regenerate=True)
    ev.load_kernels()
    with pytest.raises(AmicoError, match='4D'):
        ev.fit()

    # NaN rows: fit completes, affected voxels get the pole direction
    peaks = np.random.RandomState(1).randn(4, 4, 2, 3).astype(np.float32)
    peaks[0, 0, 0] = np.nan
    nifti.save(nifti.Nifti1Image(peaks), str(subj / 'peaks.nii.gz'))
    ev2 = amico_tpu.Evaluation(str(tmp_path), 's')
    ev2.set_config('peaks_filename', 'peaks.nii.gz')
    ev2.load_data('DWI.nii.gz', 'DWI.scheme')
    ev2.set_model('FreeWater')
    ev2.generate_kernels()
    ev2.load_kernels()
    ev2.fit()
    assert np.isfinite(ev2.RESULTS['MAPs']).all()


def test_2d_mask_rejected_cleanly(tmp_path):
    from amico_tpu.utils.logging import AmicoError
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    amico_tpu.set_verbose(0)
    subj = tmp_path / 's'
    subj.mkdir()
    _write_subject(subj, np.ones((4, 4, 2), np.uint8))
    nifti.save(nifti.Nifti1Image(np.ones((4, 4), np.uint8)),
               str(subj / 'mask2d.nii.gz'))
    ev = amico_tpu.Evaluation(str(tmp_path), 's')
    with pytest.raises(AmicoError, match='not a 3D image'):
        ev.load_data('DWI.nii.gz', 'DWI.scheme', mask_filename='mask2d.nii.gz')


def test_fit_dti_rejects_unknown_method():
    """fit_dti silently degraded typo'd method names to a WLS fit; the
    public op now validates (pipeline.resolve_dti_method only gates the
    Evaluation path)."""
    from amico_tpu.ops.dti import fit_dti
    y = np.abs(np.random.RandomState(0).rand(4, 10)).astype(np.float32)
    b = np.r_[0.0, np.full(9, 1000.0)]
    g = np.random.RandomState(1).randn(10, 3)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    with pytest.raises(ValueError, match='NLS'):
        fit_dti(y, b, g, method='NLS')


def test_direction_cache_written_atomically(tmp_path):
    """Direction/hash-table caches use tmp+rename so concurrent processes
    never np.load a torn file (the lut/rotation.py AUX-cache guarantee)."""
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    from amico_tpu.ops import sphere
    d = sphere.load_directions(1000, source='generated')
    h = sphere.load_precomputed_hash_table(1000, source='generated')
    cache = tmp_path / 'home' / 'directions'
    names = sorted(p.name for p in cache.iterdir())
    assert names == ['htable_ndirs=1000.npy', 'ndirs=1000.npy']  # no .tmp
    np.testing.assert_array_equal(np.load(cache / 'ndirs=1000.npy'), d)
    np.testing.assert_array_equal(np.load(cache / 'htable_ndirs=1000.npy'), h)


def test_sandi2scheme_accepts_per_sample_arrays(tmp_path):
    """Delta_data/smalldel_data as numpy arrays (a documented reference
    use case, util.py:117-146) crashed on the scalar-only 'data > 0.1'
    check."""
    from amico_tpu.io.scheme import sandi2scheme
    n = 7
    bvals = np.r_[0.0, np.full(n - 1, 3000.0)]
    bvecs = np.random.RandomState(2).randn(3, n)
    bvecs /= np.linalg.norm(bvecs, axis=0, keepdims=True)
    bvalsf = tmp_path / 'bvals'; bvecsf = tmp_path / 'bvecs'
    np.savetxt(bvalsf, bvals[None], fmt='%.1f')
    np.savetxt(bvecsf, bvecs, fmt='%.6f')
    out = sandi2scheme(str(bvalsf), str(bvecsf),
                       Delta_data=np.full(n, 0.035),
                       smalldel_data=0.015,
                       schemeFilename=str(tmp_path / 'o.scheme'))
    tab = np.loadtxt(out, skiprows=1)
    assert tab.shape == (n, 7)
    np.testing.assert_allclose(tab[:, 4], 0.035)
    # length mismatch errors cleanly
    from amico_tpu.utils.logging import AmicoError
    with pytest.raises(AmicoError, match='matching bvals'):
        sandi2scheme(str(bvalsf), str(bvecsf),
                     Delta_data=np.full(n + 2, 0.035),
                     smalldel_data=0.015,
                     schemeFilename=str(tmp_path / 'o2.scheme'))


def test_odd_lmax_rejected_up_front(tmp_path):
    """Odd lmax used to surface as an opaque shape mismatch deep in LUT
    assembly (num_sh_coeff's formula only matches the even-degree basis
    for even lmax)."""
    from amico_tpu.ops.sh import num_sh_coeff
    with pytest.raises(ValueError, match='even'):
        num_sh_coeff(5)
    assert num_sh_coeff(12) == 91


def test_every_get_config_key_is_declared_or_stage_set():
    """Every key the package reads via get_config must either be a
    declared default (_default_config) or be set by a pipeline stage via
    set_config -- otherwise a typo'd set_config('fit_checkpont', ...)
    fails silently (round-3 review: mesh / fit_checkpoint /
    checkpoint_every / max_device_bytes were read but undeclared)."""
    import re
    import amico_tpu
    from amico_tpu.core import _default_config

    pkg = os.path.dirname(os.path.abspath(amico_tpu.__file__))
    reads, writes = set(), set()
    for root, _dirs, files in os.walk(pkg):
        for fn in files:
            if not fn.endswith('.py'):
                continue
            src = open(os.path.join(root, fn)).read()
            reads |= set(re.findall(r"get_config\(['\"]([^'\"]+)['\"]", src))
            writes |= set(re.findall(r"set_config\(['\"]([^'\"]+)['\"]", src))
    declared = set(_default_config('.', '.', None))
    undeclared = reads - declared - writes
    assert not undeclared, (
        f'config keys read but neither declared in _default_config nor '
        f'set by any stage: {sorted(undeclared)}')
    # the four round-3 offenders stay declared
    assert {'mesh', 'fit_checkpoint', 'checkpoint_every',
            'max_device_bytes'} <= declared


def test_persistent_cache_strips_location_tracebacks():
    """Cache-key stability: whenever the persistent compilation cache is
    enabled (the test suite enables it via amico_tpu.testing), Python
    tracebacks must be stripped from MLIR locations -- a custom-call
    payload embeds them beyond the reach of the cache key's
    strip-debuginfo pass, so leaving them in re-keys such an executable
    per CALL SITE (warmup/cache-bundle/cross-process warm starts).
    Opt-out is AMICO_TPU_FULL_LOCATIONS=1 (not set in the suite)."""
    import jax

    from amico_tpu.utils import jaxcfg
    jaxcfg.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir, 'persistent cache off'
    assert jax.config.jax_include_full_tracebacks_in_locations is False
    assert jax.config.jax_traceback_in_locations_limit == 0

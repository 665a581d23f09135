"""Orchestration facade.

``Evaluation`` here is a thin stateful wrapper that wires together the pure
stage functions of :mod:`amico_tpu.pipeline` -- it owns the config dict, the
loaded arrays, and the disk-cache bookkeeping, and nothing else.  The public
surface (method names, config keys, call order) matches the reference
(/root/reference/amico/core.py:42-648) so existing user scripts port
unchanged:

    amico_tpu.setup()
    ev = amico_tpu.Evaluation(study_path, subject)
    ev.load_data(...); ev.set_model('NODDI')
    ev.generate_kernels(); ev.load_kernels(); ev.fit(); ev.save_results()

Design deltas vs the reference (SURVEY.md section 7):
  * numerics live in pipeline/stage functions, not in the facade;
  * nibabel -> built-in NIfTI-1 I/O (amico_tpu.io.nifti);
  * dipy TensorModel -> batched in-framework DTI (amico_tpu.ops.dti);
  * per-voxel Cython/SPAMS loops -> direction-bucketed accelerator tiles
    (amico_tpu.models.engine + ops.solvers);
  * ``nthreads``/``BLAS_nthreads`` are accepted for compatibility -- XLA owns
    device parallelism; BLAS_nthreads still caps host BLAS (threadpoolctl)
    during the NumPy precompute stages.
"""
from __future__ import annotations

import glob
import pickle
import time
from os import cpu_count, makedirs, remove, replace
from os.path import exists, isfile, join as pjoin

import numpy as np

from . import lut as _lut
from . import models as _models
from .models.base import default_device_budget
from . import pipeline as _pl
from .io import nifti
from .io.scheme import Scheme
from .preproc import debiasRician
from .utils.logging import ERROR, LOG, NOTE, PRINT, WARNING, get_verbose
from .utils.progress import ProgressBar
from .utils.timers import StageTimers

try:
    from threadpoolctl import ThreadpoolController
except ImportError:  # pragma: no cover
    ThreadpoolController = None


def setup(lmax: int = 12) -> None:
    """One-time precompute of every (lmax, ndirs) rotation structure,
    disk-cached; safe to call repeatedly (reference core.py:23-38)."""
    LOG('\n-> Precomputing rotation matrices:')
    dirs = _lut.valid_dirs()
    with ProgressBar(total=len(dirs), disable=get_verbose() < 3) as pbar:
        for ndirs in dirs:
            _lut.precompute_rotation_matrices(lmax, ndirs)
            pbar.update()
    LOG('   [ DONE ]')


def _default_config(study_path, subject, output_path) -> dict:
    """Initial config dict.  Keys are reference-compatible
    (core.py:76-96); the last block is this build's additions."""
    from . import __version__
    cfg = dict(
        version=__version__,
        study_path=study_path,
        subject=subject,
        DATA_path=pjoin(study_path, subject),
        OUTPUT_path=output_path,
        peaks_filename=None,
        doNormalizeSignal=True,
        doKeepb0Intact=False,
        doComputeRMSE=False,
        doComputeNRMSE=False,
        doSaveModulatedMaps=False,
        doSaveCorrectedDWI=False,
        doMergeB0=False,
        doDebiasSignal=False,
        doDirectionalAverage=False,
        nthreads=-1,
        DTI_fit_method='OLS',
        BLAS_nthreads=1,
        # this build's extras
        tile_size='auto',
        voxels_per_chunk='auto',
        # 'auto' | 'reference' | 'generated': where direction sets and the
        # high-res gradient table come from (amico_tpu.ops.sphere.resolve_source)
        direction_source='auto',
        # multi-host: fit only this host's voxel slab, all-gather the maps
        # (amico_tpu.parallel.dist; call dist.initialize() first)
        distributed=False,
        # directory for a full jax.profiler capture of the fit
        # (TensorBoard/Perfetto trace); None disables
        profile_dir=None,
        # explicit jax.sharding.Mesh for the tiled fit; None = the fit
        # driver builds a 1-axis ('data',) mesh over jax.devices()
        # (models/base.py mesh resolution)
        mesh=None,
        # mid-fit chunk checkpointing: path of the checkpoint file (None
        # disables) + flush cadence in chunks (models/base.py; resumes a
        # killed full-brain fit at the last completed chunk)
        fit_checkpoint=None,
        checkpoint_every=4,
        # cap on bytes the fit stages on the device at once; above it the
        # driver streams host-tiled chunks instead of device-gathering
        # the whole volume.  None = a fixed share of the device's memory
        # limit (models/base.default_device_budget)
        max_device_bytes=None,
        # SubjectSweep only: overlap the next subject's NIfTI load +
        # preprocessing with the current subject's fit on a background
        # thread (sweep.py; auto-off for distributed / doDebiasSignal;
        # peak host memory holds two subject volumes while on)
        prefetch=True,
    )
    cfg['DWI-SNR'] = None
    return cfg


# solver knobs that selected the removed Pallas tile kernels
_REMOVED_SOLVER_PARAMS = frozenset({'backend', 'precision', 'tiles_per_step',
                                    'use_fused'})


class Evaluation:
    """State holder + stage sequencer for one subject fit
    (public contract per reference core.py:42-648)."""

    def __init__(self, study_path='.', subject='.', output_path=None):
        self.niiDWI = None
        self.niiDWI_img = None
        self.scheme = None
        self.niiMASK = None
        self.niiMASK_img = None
        self.model = None
        self.KERNELS = None
        self.y = None
        self.DIRs = None
        self.nthreads = None
        self.BLAS_nthreads = None
        self.RESULTS = None
        self.mean_b0s = None
        self.htable = None
        self.timers = StageTimers()
        self.CONFIG = _default_config(study_path, subject, output_path)
        self._controller = (ThreadpoolController()
                            if ThreadpoolController is not None else None)

        from .utils.jaxcfg import enable_compilation_cache
        enable_compilation_cache()

    def set_config(self, key, value):
        self.CONFIG[key] = value

    def get_config(self, key):
        return self.CONFIG.get(key)

    def _blas_limit(self):
        import contextlib
        if self._controller is None:
            return contextlib.nullcontext()
        return self._controller.limit(limits=self.BLAS_nthreads or 1,
                                      user_api='blas')

    def _resolve_threads(self, key):
        v = self.get_config(key)
        if v is None:
            return 1
        if v > 0:
            return v
        if v == -1:
            return cpu_count()
        ERROR(f'"{key}" must be a positive count or -1 (= all cores)')

    # ------------------------------------------------------------ load_data
    def load_data(self, dwi_filename='DWI.nii', scheme_filename='DWI.scheme',
                  mask_filename=None, b0_thr=0, b0_min_signal=0,
                  replace_bad_voxels=None):
        """Load DWI/scheme/mask, then run the preprocessing stages
        (reference core.py:107-278)."""
        LOG('\n-> Loading data:')
        tic = time.time()
        data_path = self.get_config('DATA_path')
        self.set_config('dwi_filename', dwi_filename)
        self.set_config('scheme_filename', scheme_filename)
        self.set_config('mask_filename', mask_filename)
        self.set_config('b0_thr', b0_thr)
        self.set_config('b0_min_signal', b0_min_signal)
        self.set_config('replace_bad_voxels', replace_bad_voxels)

        PRINT('\t* DWI signal')
        if not isfile(pjoin(data_path, dwi_filename)):
            ERROR('DWI file not found')
        # raw (unscaled, possibly mmapped read-only) view: the rescale /
        # finite-check / normalize stages run fused in one native pass
        # inside _preprocess (where the scheme's b0 indices are known);
        # the staged fallback copies there instead
        self.niiDWI = nifti.load(pjoin(data_path, dwi_filename))
        img = self.niiDWI.dataobj
        if img.ndim != 4:
            ERROR('DWI file is not a 4D image')
        hdr = self.niiDWI.header
        self.set_config('dim', img.shape[:3])
        self.set_config('pixdim', tuple(hdr.get_zooms()[:3]))
        PRINT('\t\t- dim    = %d x %d x %d x %d' % img.shape)
        PRINT('\t\t- pixdim = %.3f x %.3f x %.3f' % self.get_config('pixdim'))
        rescaled = _pl.rescale_meaningful(hdr.scl_slope, hdr.scl_inter)
        if rescaled:
            PRINT('\t\t- rescaling data  [OK]')

        PRINT('\t* Acquisition scheme')
        if not isfile(pjoin(data_path, scheme_filename)):
            ERROR('SCHEME file not found')
        self.scheme = Scheme(pjoin(data_path, scheme_filename), b0_thr)
        self._print_scheme_summary()
        if self.scheme.nS != img.shape[3]:
            ERROR('Scheme does not match with DWI data')

        PRINT('\t* Binary mask')
        if mask_filename is not None:
            if not isfile(pjoin(data_path, mask_filename)):
                ERROR('MASK file not found')
            self.niiMASK = nifti.load(pjoin(data_path, mask_filename))
            self.niiMASK_img = self.niiMASK.get_fdata().astype(np.uint8)
            if self.niiMASK.ndim != 3:       # before the dim print: a 2-D
                ERROR('MASK file is not a 3D image')  # mask breaks its fmt
            PRINT('\t\t- dim    = %d x %d x %d' % self.niiMASK_img.shape[:3])
            if self.get_config('dim') != self.niiMASK_img.shape[:3]:
                ERROR('MASK geometry does not match with DWI data')
        else:
            self.niiMASK = None
            self.niiMASK_img = np.ones(self.get_config('dim'), dtype=np.uint8)
            PRINT('\t\t- not specified')
        PRINT(f'\t\t- voxels = {np.count_nonzero(self.niiMASK_img)}')
        LOG(f'   [ {time.time() - tic:.1f} seconds ]')

        self.niiDWI_img = self._preprocess(img, b0_thr, b0_min_signal,
                                           replace_bad_voxels)

    def _print_scheme_summary(self):
        sch = self.scheme
        PRINT(f'\t\t- {sch.nS} samples, {len(sch.shells)} shells')
        parts = [f'{sch.b0_count} @ b=0'] + \
            [f'{len(s["idx"])} @ b={s["b"]:.1f}' for s in sch.shells]
        PRINT('\t\t- ' + ' , '.join(parts))

    def _preprocess(self, img, b0_thr, b0_min_signal, replace_bad_voxels):
        """Run the enabled preprocessing stages in reference order:
        rescale/finite-guard -> debias -> b0-normalize -> merge-b0 ->
        directional average.

        ``img`` arrives as the RAW (unscaled, possibly mmapped read-only)
        volume.  On the default path (no debias) the rescale + raw finite
        guard + b0 normalization + stats run as ONE threaded native pass
        (ops.native.preprocess_dwi) straight out of the file mapping --
        the staged NumPy path below is the exact semantic fallback
        (equivalence: tests/test_pipeline.py)."""
        LOG('\n-> Preprocessing:')
        tic = time.time()
        hdr = self.niiDWI.header
        normalize = bool(self.get_config('doNormalizeSignal'))
        rescale = _pl.rescale_meaningful(hdr.scl_slope, hdr.scl_inter)
        if normalize and self.scheme.b0_count == 0:
            ERROR('No b0 volume to normalize signal with')

        fused = None
        if not self.get_config('doDebiasSignal'):
            from .ops import native
            fused = native.preprocess_dwi(
                np.asarray(img), self.scheme.b0_idx, hdr.scl_slope,
                hdr.scl_inter, rescale, b0_min_signal, replace_bad_voxels,
                normalize)
        if fused is not None:
            img, mean_b0, info = fused
            _pl.finite_report(info['raw_bad'], replace_bad_voxels, 'raw')
            if normalize:
                PRINT('\t* Normalizing to b0... ', end='')
                self.mean_b0s = mean_b0
                PRINT(f'[ min={info["min"]:.2f},  mean={info["mean"]:.2f}, '
                      f'max={info["max"]:.2f} ]')
                _pl.finite_report(info['out_bad'], replace_bad_voxels,
                                  'preprocessed')
            return self._preprocess_tail(img, b0_thr, replace_bad_voxels,
                                         tic, finite_checked=True)

        img = np.array(img, dtype=np.float32)
        img, _ = _pl.intensity_rescale(img, hdr.scl_slope, hdr.scl_inter)
        img = _pl.ensure_finite(img, replace_bad_voxels, 'raw')

        if self.get_config('doDebiasSignal'):
            PRINT('\t* Debiasing signal... ', end='')
            if self.get_config('DWI-SNR') is None:
                ERROR('Rician debias needs the acquisition SNR: '
                      "set_config('DWI-SNR', value) before load_data()")
            if self.scheme.b0_count == 0:
                # sigma is estimated from the b0 volumes; without any the
                # stage would silently no-op on NaN sigmas
                ERROR('No b0 volume to estimate the noise level '
                      'for the Rician debias')
            img = debiasRician(img, self.get_config('DWI-SNR'),
                               self.niiMASK_img, self.scheme).astype(np.float32)
            PRINT(' [OK]')

        if normalize:
            PRINT('\t* Normalizing to b0... ', end='')
            img, self.mean_b0s = _pl.b0_normalize(img, self.scheme.b0_idx,
                                                  b0_min_signal)
            PRINT(f'[ min={img.min():.2f},  mean={img.mean():.2f}, '
                  f'max={img.max():.2f} ]')
        return self._preprocess_tail(img, b0_thr, replace_bad_voxels, tic,
                                     finite_checked=False)

    def _preprocess_tail(self, img, b0_thr, replace_bad_voxels, tic,
                         finite_checked):

        if self.get_config('doMergeB0'):
            if self.scheme.b0_count == 0:
                ERROR('No b0 volume to merge')
            if self.get_config('doDirectionalAverage'):
                # the directional average already collapses all b0s into a
                # single mean column; merging first would desynchronize the
                # image layout from the scheme's sample indices (the
                # reference silently mixes columns here, core.py:225-268)
                NOTE('doMergeB0 is redundant with doDirectionalAverage '
                     '(the shell average already merges the b0s); skipping '
                     'the merge')
            else:
                PRINT('\t* Merging multiple b0 volume(s)')
                img = _pl.collapse_b0(img, self.scheme.b0_idx,
                                      self.scheme.dwi_idx)
        else:
            PRINT('\t* Keeping all b0 volume(s)')

        if self.get_config('doDirectionalAverage'):
            PRINT('\t* Directional average over each shell...')
            img, self.scheme = _pl.spherical_mean(img, self.scheme, b0_thr)
            self.set_config('dim', img.shape[:3])
            PRINT('\t\t- dim    = %d x %d x %d x %d' % img.shape)
            PRINT('\t* Acquisition scheme')
            self._print_scheme_summary()
            if self.scheme.nS != img.shape[3]:
                ERROR('Scheme does not match with DWI data')

        if not finite_checked:
            img = _pl.ensure_finite(img, replace_bad_voxels, 'preprocessed')
        # (the fused pass already checked the normalized values; merge /
        # directional averaging only take means of finite data)
        LOG(f'   [ {time.time() - tic:.1f} seconds ]')
        return img

    # ------------------------------------------------------------ set_model
    def set_model(self, model_name: str):
        """Instantiate a model class by name (reference core.py:281-298)."""
        if not hasattr(_models, model_name):
            ERROR(f'Model "{model_name}" not recognized')
        self.model = getattr(_models, model_name)()
        self.set_config('ATOMS_path', pjoin(self.get_config('study_path'),
                                            'kernels', self.model.id))
        self.set_solver()

    def set_solver(self, **params):
        """Pass solver knobs through to the model, dropping (with a warning)
        any the model's set_solver signature does not accept
        (reference core.py:301-325).  Knobs this build once had and
        removed raise instead: dropping them would silently run another
        configuration than the caller asked for."""
        import inspect
        if self.model is None:
            ERROR('Model not set; call "set_model()" method first')
        removed = sorted(params.keys() & _REMOVED_SOLVER_PARAMS)
        if removed:
            ERROR(f'solver parameter(s) {removed} no longer exist: every '
                  'model fits through one compiled XLA path '
                  '(ops.solvers.nneg_qp_batch) on every device')
        accepted = set(inspect.signature(self.model.set_solver).parameters)
        known = {k: v for k, v in params.items() if k in accepted}
        for k in params.keys() - known.keys():
            WARNING(f'solver parameter "{k}" is not used by '
                    f'{self.model.name}; ignoring it')
        self.model.set_solver(**known)
        self.set_config('solver_params', known)

    # ----------------------------------------------------- generate_kernels
    def generate_kernels(self, regenerate=False, lmax=12, ndirs=500):
        """Build the high-resolution response-function LUT, unless a cached
        one already exists (reference core.py:328-377)."""
        if self.scheme is None:
            ERROR('Scheme not loaded; call "load_data()" first')
        if self.model is None:
            ERROR('Model not set; call "set_model()" method first')
        if not _lut.is_valid(ndirs):
            ERROR(f'ndirs={ndirs} is not a precomputable direction count; '
                  f'valid values: {_lut.valid_dirs()}')
        if lmax % 2 or lmax < 0:
            ERROR(f'lmax={lmax} is invalid: the SH basis uses even degrees '
                  'only (axially symmetric kernels); pass an even lmax')
        self.BLAS_nthreads = self._resolve_threads('BLAS_nthreads')
        self.set_config('lmax', lmax)
        self.set_config('ndirs', ndirs)
        self.model.scheme = self.scheme
        atoms_path = self.get_config('ATOMS_path')
        LOG(f'\n-> Creating LUT for "{self.model.name}" model:')

        # SPMD coordination: a concurrent wipe+rebuild of a shared
        # ATOMS_path is not safe, so under a distributed run the
        # coordinator generates FIRST and everyone else waits at a
        # barrier.  Afterwards each non-coordinator re-checks its own
        # path: on a shared filesystem the coordinator's completed LUT is
        # now visible and is reused (even under regenerate=True -- it was
        # just built); on per-host study copies nothing appeared and the
        # host builds its own copy, now race-free (no other writer of
        # that path remains).  (Replaces the round-2 docs-only caveat.)
        from .parallel import dist
        spmd = bool(self.get_config('distributed')) \
            and dist.process_count() > 1
        if spmd and not dist.is_coordinator():
            dist.barrier('generate_kernels')
            if regenerate and self._lut_is_current(atoms_path):
                regenerate = False
        try:
            self._generate_kernels_body(regenerate, lmax, ndirs, atoms_path)
        finally:
            # the coordinator (or a failed coordinator: the others then
            # build for themselves) releases the waiters exactly once
            if spmd and dist.is_coordinator():
                dist.barrier('generate_kernels')

    def _lut_is_current(self, atoms_path: str) -> bool:
        """A completed LUT with a matching generation signature exists."""
        meta_path = pjoin(atoms_path, 'lut_meta.pickle')
        if not (glob.glob(pjoin(atoms_path, 'A_*.npy'))
                and isfile(meta_path)):
            return False
        with open(meta_path, 'rb') as fid:
            meta = pickle.load(fid)
        return meta.get('gen_sig') == self._kernel_signature()

    def _generate_kernels_body(self, regenerate, lmax, ndirs, atoms_path):
        meta_path = pjoin(atoms_path, 'lut_meta.pickle')
        if glob.glob(pjoin(atoms_path, 'A_*.npy')) and not regenerate:
            # the generated atoms depend on the shell parameters and the
            # model configuration (not on subject directions); a cached
            # LUT built for a different protocol or atom grid must not be
            # silently reused across a sweep.  lut_meta.pickle doubles as
            # the completion marker (written atomically, after the last
            # atom): A_*.npy files without it are an interrupted
            # generation, not a cache
            if isfile(meta_path):
                with open(meta_path, 'rb') as fid:
                    meta = pickle.load(fid)
                want = self._kernel_signature()
                if meta.get('gen_sig', want) != want:
                    ERROR('Cached LUT was generated for a different '
                          'scheme/model configuration; call '
                          '"generate_kernels(regenerate=True)"')
                LOG('   [ cached LUT found on disk -- pass regenerate=True '
                    'to rebuild it ]')
                return
            WARNING('Found LUT atoms without a completion marker '
                    '(interrupted generation?); rebuilding')
        if not exists(atoms_path):
            makedirs(atoms_path)
        else:
            for f in glob.glob(pjoin(atoms_path, '*')):
                remove(f)

        aux = _lut.load_precomputed_rotation_matrices(
            lmax, ndirs, self.get_config('direction_source'))
        idx_IN, idx_OUT = _lut.aux_structures_generate(self.scheme, lmax)
        tic = time.time()
        with self.timers.stage('generate_kernels'), self._blas_limit():
            self.model.generate(atoms_path, aux, idx_IN, idx_OUT, ndirs)
        with open(meta_path + '.tmp', 'wb') as fid:
            pickle.dump({'lmax': lmax, 'ndirs': ndirs,
                         'source': aux.get('source'),
                         'gen_sig': self._kernel_signature()}, fid)
        replace(meta_path + '.tmp', meta_path)  # completion marker, atomic
        LOG(f'   [ {time.time() - tic:.1f} seconds ]')

    def _kernel_signature(self) -> str:
        """Hash of everything the generated atoms depend on: the shell
        parameters (the high-res scheme replicates the grad table per
        shell) and the model's atom-grid parameters."""
        import hashlib
        shells = [(s['b'], s['G'], s['Delta'], s['delta'], s['TE'])
                  for s in self.scheme.shells]
        params = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                  for k, v in self.model.get_params().items()}
        text = repr((self.scheme.version, shells, sorted(params.items())))
        return hashlib.sha1(text.encode()).hexdigest()

    # --------------------------------------------------------- load_kernels
    def load_kernels(self):
        """Project the SH-space LUT onto this subject's gradient scheme
        (reference core.py:380-404)."""
        if self.model is None:
            ERROR('Model not set; call "set_model()" method first')
        if self.scheme is None:
            ERROR('Scheme not loaded; call "load_data()" first')
        self.BLAS_nthreads = self._resolve_threads('BLAS_nthreads')
        tic = time.time()
        LOG(f'\n-> Resampling LUT for subject "{self.get_config("subject")}":')
        idx_OUT, Ylm_OUT = _lut.aux_structures_resample(
            self.scheme, self.get_config('lmax'))
        # the on-disk kernels record which direction source built them; the
        # hash table must come from the same set or LUT indices are garbage
        source = self.get_config('direction_source')
        meta_path = pjoin(self.get_config('ATOMS_path'), 'lut_meta.pickle')
        if isfile(meta_path):
            with open(meta_path, 'rb') as fid:
                meta = pickle.load(fid)
            source = meta.get('source', source)
            if meta.get('ndirs') != self.get_config('ndirs'):
                ERROR(f'Cached kernels were built with ndirs={meta.get("ndirs")}'
                      f' but this session uses ndirs={self.get_config("ndirs")};'
                      ' call generate_kernels(regenerate=True)')
            if meta.get('lmax') != self.get_config('lmax'):
                ERROR(f'Cached kernels were built with lmax={meta.get("lmax")}'
                      f' but this session uses lmax={self.get_config("lmax")};'
                      ' call generate_kernels(regenerate=True)')
        self.htable = _lut.load_precomputed_hash_table(
            self.get_config('ndirs'), source)
        with self.timers.stage('load_kernels'), self._blas_limit():
            self.KERNELS = self.model.resample(
                self.get_config('ATOMS_path'), idx_OUT, Ylm_OUT,
                self.get_config('doMergeB0'), self.get_config('ndirs'))
        LOG(f'   [ {time.time() - tic:.1f} seconds ]')

    # ------------------------------------------------------------------ fit
    def fit(self):
        """Directions + model fit + scatter back to volumes
        (reference core.py:407-498)."""
        if self.niiDWI is None:
            ERROR('Data not loaded; call "load_data()" first')
        if self.model is None:
            ERROR('Model not set; call "set_model()" first')
        if self.KERNELS is None:
            ERROR('Response functions not generated; call "generate_kernels()" '
                  'and "load_kernels()" first')
        if self.KERNELS['model'] != self.model.id:
            ERROR('Response functions were not created with the same model')
        method = _pl.resolve_dti_method(self.get_config('DTI_fit_method'))
        self.nthreads = self._resolve_threads('nthreads')
        self.BLAS_nthreads = self._resolve_threads('BLAS_nthreads')
        self.set_config('fit_time', None)
        mask = self.niiMASK_img
        # count mask == 1 exactly: masked_voxels()/scatter() select on == 1
        # (reference core.py:451), so a 0/255 or labeled mask must use the
        # same criterion or slab/scatter shapes diverge from self.y
        mask_sel = np.ascontiguousarray(mask == 1)
        n_vox = int(mask_sel.sum())

        # facade phase timers: every second of Evaluation.fit() outside the
        # model's own engine timers is attributed here (voxel staging /
        # directions / model fit / scatter) -- stored as
        # _last_fit_facade_timers and surfaced by bench.py
        tf = {}
        t_enter = time.time()
        t = time.time()
        # warm re-fit cache: repeated fit() calls on the same loaded data
        # (multi-model runs, parameter sweeps) must hand the model the
        # SAME y array object -- the model's device staging cache keys on
        # identity, and a fresh masked_voxels allocation forced a full
        # signal re-upload per fit.  Keyed by array identity + strided content
        # fingerprint (in-place edits of the loaded volume invalidate)
        # + n_vox (an in-place mask edit changes the voxel selection
        # without changing array identity -- serving the stale y would
        # silently produce wrong maps).  ravel(order='K') keeps this a
        # view for any contiguous layout (C-order ravel of the F-ordered
        # DWI volume copied ~160MB per fit).
        stride = max(1, self.niiDWI_img.size // 65536)
        # the mask term is an EXACT positional digest (not just the count):
        # an in-place edit that moves the ROI while preserving its size
        # must invalidate too, or the cached y's signals get scattered at
        # the new mask's positions (~1ms/fit for a full-brain mask)
        img_fp = (float(np.sum(self.niiDWI_img.ravel(order='K')[::stride],
                               dtype=np.float64)),
                  n_vox, hash(mask_sel.tobytes()))
        from .parallel import dist
        dist_on = bool(self.get_config('distributed')) \
            and dist.process_count() > 1
        # will this fit use the shared device staging? (single-host,
        # single-device, direction-full model, within the device budget)
        budget = int(self.get_config('max_device_bytes')
                     or default_device_budget())
        want_stage = (not dist_on and self.get_config('mesh') is None
                      and not self.get_config('doDirectionalAverage')
                      and n_vox * int(self.niiDWI_img.shape[3]) * 4 <= budget)
        yc = getattr(self, '_fit_y_cache', None)
        if yc is not None and yc[0] is self.niiDWI_img \
                and yc[1] is self.niiMASK_img and yc[2] == img_fp:
            self.y = yc[3]
            slab_cache = yc[4]
        else:
            # fused native extraction (gather + clip + zero pad row in one
            # threaded pass, ops.native.masked_gather_padded); the padded
            # buffer doubles as the device staging layout.  When the fit
            # will stage on device, the gather runs in blocks with each
            # block's H2D transfer starting while the next block gathers
            # (extraction and upload pipeline instead of serializing).
            # Falls back to the 3-pass NumPy path off the production layout.
            from .ops import native as _native
            dev_blocks = []
            cb = None
            if want_stage:
                import jax

                def cb(view):
                    dev_blocks.append(jax.device_put(view))
            padded = _native.masked_gather_padded(
                self.niiDWI_img, mask, blocks=4 if cb else 1, block_cb=cb)
            if padded is not None:
                self.y = padded[:-1]
            else:
                self.y = _pl.masked_voxels(self.niiDWI_img, mask)
            slab_cache = {}
            if padded is not None:
                slab_cache['__y_ext_host__'] = padded
                if dev_blocks:
                    import jax.numpy as jnp
                    slab_cache['__y_ext_dev__'] = (
                        dev_blocks[0] if len(dev_blocks) == 1
                        else jnp.concatenate(dev_blocks, axis=0))
            self._fit_y_cache = (self.niiDWI_img, self.niiMASK_img,
                                 img_fp, self.y, slab_cache)
            self._fit_dirs_cache = None

        # multi-host: fit only this host's voxel slab (bulk voxel data never
        # crosses DCN; maps are gathered after the fit)
        y_full = self.y
        if dist_on:
            slab = dist.host_slab(n_vox)
            # cache the slab view: a fresh y_full[slab] object per fit()
            # would miss the model's identity-keyed staging/DIRs caches,
            # re-uploading the signal on every warm multi-host re-fit
            sl = slab_cache.get((slab.start, slab.stop))
            if sl is None:
                sl = slab_cache[(slab.start, slab.stop)] = y_full[slab]
            self.y = sl
            LOG(f'\n-> Distributed fit: host {dist.process_index()}/'
                f'{dist.process_count()} takes voxels '
                f'[{slab.start}:{slab.stop}) of {n_vox}')

        # single shared H2D upload (round-5): stage the padded f32 signal
        # (y + one zero row, the tile engine's gather layout) on the device
        # ONCE and hand it to BOTH the DTI direction fit and the model's
        # tile engine.  Without this the full-brain signal crossed the
        # host-device link twice per cold fit -- once inside fit_dti's
        # jnp.asarray, once in the engine's staging.
        # Skipped when distributed (slab views) / mesh-sharded / beyond the
        # device budget: those paths own their staging.
        self._staged_y_ext_dev = None
        if want_stage:
            cached = slab_cache.get('__y_ext_dev__')
            if cached is None:
                import jax.numpy as jnp
                y_ext = slab_cache.get('__y_ext_host__')
                if y_ext is None:
                    y_ext = np.concatenate(
                        [self.y.astype(np.float32, copy=False),
                         np.zeros((1, self.y.shape[1]), np.float32)],
                        axis=0)
                cached = slab_cache['__y_ext_dev__'] = jnp.asarray(y_ext)
            self._staged_y_ext_dev = (self.y, cached)

        tf['stage_voxels_s'] = time.time() - t_enter
        LOG(f"\n-> Estimating principal directions "
            f"({self.get_config('DTI_fit_method')}):")
        peaks_filename = self.get_config('peaks_filename')
        if peaks_filename is not None:
            self.DIRs = self._load_peaks(peaks_filename, mask)
            if dist_on:
                self.DIRs = self.DIRs[slab]
        elif not self.get_config('doDirectionalAverage'):
            # DIRs depend only on (y, scheme, method, doMergeB0); on a
            # warm re-fit with the cached y they are identical -- reuse
            # them (same rationale as the y cache above; the model's
            # plan cache also keys on DIRs identity)
            dkey = (self.y, self.scheme, method,
                    bool(self.get_config('doMergeB0')))
            dc = getattr(self, '_fit_dirs_cache', None)
            if dc is not None and dc[0] is dkey[0] and dc[1] is dkey[1] \
                    and dc[2:4] == dkey[2:4]:
                self.DIRs = dc[4]
            else:
                # run the DTI fit on the already-staged device signal when
                # available (drops its separate H2D upload)
                y_dti = (self._staged_y_ext_dev[1][:-1]
                         if self._staged_y_ext_dev is not None else self.y)
                with self.timers.stage('directions'):
                    self.DIRs = _pl.principal_directions(
                        y_dti, *dkey[1:])
                self._fit_dirs_cache = dkey + (self.DIRs,)
        self.set_config('dirs_precomputing_time', time.time() - t)
        tf['directions_s'] = time.time() - t_enter - tf['stage_voxels_s']
        LOG('   [ %s ]' % time.strftime(
            '%Hh %Mm %Ss',
            time.gmtime(self.get_config('dirs_precomputing_time'))))

        t = time.time()
        LOG(f"\n-> Fitting '{self.model.name}' model to {n_vox} voxels:")
        # optional full profiler capture (TensorBoard/Perfetto trace of the
        # whole fit -- XLA ops, kernels, transfers); the reference
        # has no profiler hooks at all (SURVEY.md section 5.1)
        import contextlib
        prof_dir = self.get_config('profile_dir')
        if prof_dir:
            import jax
            prof_ctx = jax.profiler.trace(prof_dir)
        else:
            prof_ctx = contextlib.nullcontext()
        with prof_ctx, self.timers.stage('fit', profile=True):
            results = self.model.fit(self)
        self.set_config('fit_time', time.time() - t)
        tf['model_fit_s'] = time.time() - t
        LOG('   [ %s ]' % time.strftime(
            '%Hh %Mm %Ss', time.gmtime(self.get_config('fit_time'))))

        t = time.time()
        if dist_on:
            results = {k: dist.allgather_rows(np.asarray(v), n_vox)
                       for k, v in results.items()}
            if self.DIRs is not None:
                self.DIRs = dist.allgather_rows(
                    np.asarray(self.DIRs, np.float32), n_vox)
            self.y = y_full
        self.RESULTS = self._scatter_results(results, mask)
        tf['scatter_s'] = time.time() - t
        tf['total_s'] = time.time() - t_enter
        tf['unattributed_s'] = tf['total_s'] - sum(
            v for k, v in tf.items() if k.endswith('_s')
            and k not in ('total_s', 'unattributed_s'))
        self._last_fit_facade_timers = tf

    def _load_peaks(self, peaks_filename, mask):
        """Alternative direction source: a precomputed peaks NIfTI
        (reference core.py:437-445)."""
        path = pjoin(self.get_config('DATA_path'), peaks_filename)
        if not isfile(path):
            ERROR('PEAKS file not found')
        peaks = nifti.load(path).get_fdata().astype(np.float32)
        if peaks.ndim != 4 or peaks.shape[3] < 3:
            ERROR('PEAKS file must be a 4D image with at least 3 '
                  'components (x, y, z of the principal direction)')
        PRINT('\t* peaks dim = %d x %d x %d x %d' % peaks.shape[:4])
        if peaks.shape[:3] != mask.shape[:3]:
            ERROR('PEAKS geometry does not match with DWI data')
        dirs = peaks[mask == 1, :3]
        # non-finite peak rows (common fill outside the tractography FOV
        # but inside a loose mask) would crash the LUT quantizer mid-fit;
        # zero rows are legal (quantizer maps them to the pole)
        bad = ~np.isfinite(dirs).all(axis=1)
        if bad.any():
            WARNING(f'{int(bad.sum())} voxels have non-finite peaks; '
                    'treating them as direction-free')
            dirs[bad] = 0.0
        return dirs

    def _scatter_results(self, results, mask):
        """Expand per-voxel fit outputs into full volumes via the scatter
        stage (reference core.py:472-498)."""
        dim = self.get_config('dim')
        out = {'MAPs': _pl.scatter(np.asarray(results['estimates'],
                                              np.float32), mask, dim)}
        dirs = (np.asarray(self.DIRs, np.float32) if self.DIRs is not None
                else np.zeros((int(np.sum(mask == 1)), 3), np.float32))
        out['DIRs'] = _pl.scatter(dirs, mask, dim)
        if self.get_config('doComputeRMSE'):
            out['RMSE'] = _pl.scatter(results['rmse'], mask, dim)
        if self.get_config('doComputeNRMSE'):
            out['NRMSE'] = _pl.scatter(results['nrmse'], mask, dim)
        if self.model.name == 'NODDI' and self.get_config('doSaveModulatedMaps'):
            out['MAPs_mod'] = _pl.scatter(
                np.asarray(results['estimates_mod'], np.float32), mask, dim)
        if self.model.name == 'Free-Water' and self.get_config('doSaveCorrectedDWI'):
            mean_b0_masked = (self.mean_b0s[mask == 1]
                              if self.mean_b0s is not None else None)
            # under doMergeB0 the fitted signal has one merged b0 at
            # column 0 -- the pre-merge scheme.b0_idx would overwrite DWI
            # columns (an upstream AMICO flaw, core.py:495-496, fixed here)
            b0_cols = (np.array([0]) if self.get_config('doMergeB0')
                       else self.scheme.b0_idx)
            yc = _pl.reinstate_corrected_dwi(
                results['y_corrected'], self.y, mean_b0_masked,
                b0_cols,
                bool(self.get_config('doNormalizeSignal'))
                and self.scheme.b0_count > 0,
                bool(self.get_config('doKeepb0Intact'))
                and self.scheme.b0_count > 0)
            out['DWI_corrected'] = _pl.scatter(
                yc.astype(np.float32), mask,
                self.niiDWI.shape[:3] + (yc.shape[1],))
        return out

    # --------------------------------------------------------- save_results
    def save_results(self, path_suffix=None, save_dir_avg=False):
        """Write parameter maps + metadata (reference core.py:501-648).
        In distributed runs only the coordinator writes (every host holds
        the gathered maps); all hosts synchronize before returning."""
        if self.RESULTS is None:
            ERROR('Model not fitted to the data; call "fit()" first')
        from .parallel import dist
        dist_on = bool(self.get_config('distributed')) \
            and dist.process_count() > 1
        if dist_on and not dist.is_coordinator():
            LOG(f'\n-> Host {dist.process_index()}: coordinator writes the '
                'results; waiting at barrier')
            dist.barrier('save_results')
            return
        suffix = f'_{path_suffix}' if path_suffix else ''
        if self.get_config('OUTPUT_path') is None:
            rel = pjoin('AMICO', self.model.id) + suffix
            self.RESULTS['RESULTS_path'] = rel
            out_dir = pjoin(self.get_config('DATA_path'), rel)
        else:
            out_dir = self.get_config('OUTPUT_path') + suffix
            self.RESULTS['RESULTS_path'] = out_dir
        LOG(f'\n-> Saving output to "{pjoin(self.RESULTS["RESULTS_path"], "*")}":')

        if not exists(out_dir):
            makedirs(out_dir)
        else:
            for f in glob.glob(pjoin(out_dir, '*')):
                remove(f)

        tag = f' (amico_tpu v{self.get_config("version")})'

        # map writes are queued and compressed in parallel (zlib releases
        # the GIL, so gzip of the ~7 map volumes scales with cores); the
        # flush below completes them all BEFORE config.pickle -- the
        # resume marker must never precede a map on disk
        _write_jobs = []

        def emit(data, fname, descrip=None, cal=(None, None)):
            _write_jobs.append((data, fname, descrip, cal))

        def flush_writes():
            if not _write_jobs:
                return
            from concurrent.futures import ThreadPoolExecutor
            nw = min(len(_write_jobs), max(2, cpu_count() or 2))
            with ThreadPoolExecutor(max_workers=nw) as ex:
                futs = [(fname, ex.submit(
                    _pl.write_map, data, pjoin(out_dir, fname), self.niiDWI,
                    descrip=descrip, cal=cal))
                    for data, fname, descrip, cal in _write_jobs]
                for fname, fut in futs:
                    PRINT(f'\t- {fname}', end=' ')
                    fut.result()
                    PRINT(' [OK]')
            _write_jobs.clear()

        if not self.get_config('doDirectionalAverage'):
            emit(self.RESULTS['DIRs'], 'fit_dir.nii.gz', cal=(-1, 1))
        if self.get_config('doComputeRMSE'):
            emit(self.RESULTS['RMSE'], 'fit_RMSE.nii.gz', cal=(0, 1))
        if self.get_config('doComputeNRMSE'):
            emit(self.RESULTS['NRMSE'], 'fit_NRMSE.nii.gz', cal=(0, 1))

        if self.get_config('doSaveCorrectedDWI'):
            if self.model.name == 'Free-Water':
                emit(self.RESULTS['DWI_corrected'], 'DWI_corrected.nii.gz',
                     cal=(0, 1))
            else:
                WARNING(f'"doSaveCorrectedDWI" is only meaningful for the '
                        f'Free-Water model, not "{self.model.name}"')

        for i, name in enumerate(self.model.maps_name):
            emit(self.RESULTS['MAPs'][:, :, :, i], f'fit_{name}.nii.gz',
                 descrip=self.model.maps_descr[i] + tag)

        if self.get_config('doSaveModulatedMaps'):
            if self.model.name == 'NODDI':
                for i in range(2):
                    emit(self.RESULTS['MAPs_mod'][:, :, :, i],
                         f'fit_{self.model.maps_name[i]}_modulated.nii.gz',
                         descrip=self.model.maps_descr[i] + ' modulated' + tag)
            else:
                WARNING(f'"doSaveModulatedMaps" is only meaningful for NODDI, '
                        f'not "{self.model.name}"')

        if save_dir_avg:
            if self.get_config('doDirectionalAverage'):
                emit(self.niiDWI_img, 'dir_avg_signal.nii.gz',
                     descrip='Directional average signal of each shell' + tag)
                PRINT('\t- dir_avg.scheme', end=' ')
                np.savetxt(pjoin(out_dir, 'dir_avg.scheme'),
                           self.scheme.get_table(), fmt='%.06f',
                           delimiter='\t',
                           header=f'VERSION: {self.scheme.version}',
                           comments='')
                PRINT(' [OK]')
            else:
                WARNING('No directional-average signal to save: enable '
                        'doDirectionalAverage before load_data()')

        flush_writes()

        # config.pickle is written LAST and atomically: it is the
        # resume-by-existence marker (sweep.py), so it must only appear
        # once every map above is on disk.  Runtime-only config values
        # (e.g. the live device mesh) are recorded by repr rather than
        # failing the dump.
        PRINT('\t- configuration', end=' ')
        cfg = {}
        for k, v in self.CONFIG.items():
            try:
                pickle.dumps(v, protocol=2)
                cfg[k] = v
            except Exception:
                cfg[k] = repr(v)
        tmp_cfg = pjoin(out_dir, 'config.pickle.tmp')
        with open(tmp_cfg, 'wb') as fid:
            pickle.dump(cfg, fid, protocol=2)
        replace(tmp_cfg, pjoin(out_dir, 'config.pickle'))
        PRINT(' [OK]')

        if dist_on:
            dist.barrier('save_results')
        LOG('   [ DONE ]')

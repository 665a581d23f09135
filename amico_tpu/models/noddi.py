"""NODDI model -- the flagship fit.

Parity with /root/reference/amico/models.pyx:656-991.  The three-stage
per-voxel solve (models.pyx:910-942) becomes three batched tile solves:

1. NNLS on the full dictionary for the CSF fraction (911);
2. non-negative lasso on the norm-scaled DWI-only subproblem with the
   isotropic (and exvivo dot) prediction subtracted and clipped >= 0
   (914-926), defaults lambda1=5e-1 lambda2=1e-3 (721-724);
3. debias: masked NNLS restricted to the positive support with the
   isotropic (and dot) atoms forced in (928-942) -- the mask-pinned solve is
   mathematically identical to the reference's column-subset re-fit
   (verified in tests/test_solvers.py::test_masked_solve_equals_submatrix_solve).

Maps: NDI/ODI/FWF (+dot if exvivo) per models.pyx:944-967, modulated maps
per 976-979.

References
----------
Zhang et al. (2012) NeuroImage 61: 1000-16.
"""
from __future__ import annotations

import numpy as np

from .. import lut as _lut
from ..synthesis import NODDIExtraCellular, NODDIIntraCellular, NODDIIsotropic
from ..utils.logging import get_verbose
from ..utils.progress import ProgressBar
from ._fitops import error_maps, project, solve_tiles
from .base import BaseModel


def _kappa_neighbours(icvf: np.ndarray, kappa: np.ndarray):
    """Per-atom index of the same-ICVF adjacent-kappa atom on the
    (IC_OD, IC_VF) grid, ascending-kappa order; -1 at the grid edges.
    Drives the stage-2 degenerate-vertex tie-break (the near-tied vertices
    differ by adjacent kappa-grid atoms, PARITY.md 'error tail')."""
    n = icvf.shape[0]
    nbm = np.full(n, -1, np.int32)
    nbp = np.full(n, -1, np.int32)
    for j in range(n):
        same = np.where(np.isclose(icvf, icvf[j], rtol=1e-6, atol=1e-9))[0]
        order = same[np.argsort(kappa[same], kind='stable')]
        pos = int(np.nonzero(order == j)[0][0])
        if pos > 0:
            nbm[j] = order[pos - 1]
        if pos + 1 < order.size:
            nbp[j] = order[pos + 1]
    return nbm, nbp


class NODDI(BaseModel):
    def __init__(self):
        self.id = 'NODDI'
        self.name = 'NODDI'
        self.maps_name = ['NDI', 'ODI', 'FWF']
        self.maps_descr = ['Neurite Density Index',
                           'Orientation Dispersion Index',
                           'Free Water Fraction']
        self.scheme = None
        self.set()

    def set(self, dPar=1.7e-3, dIso=3.0e-3,
            IC_VFs=np.linspace(0.1, 0.99, 12),
            IC_ODs=np.hstack((np.array([0.03, 0.06]), np.linspace(0.09, 0.99, 10))),
            isExvivo=False):
        """Defaults per reference models.pyx:675-703."""
        self.dPar = dPar
        self.dIso = dIso
        self.IC_VFs = np.array(IC_VFs)
        self.IC_ODs = np.array(IC_ODs)
        self.isExvivo = isExvivo
        if isExvivo and 'dot' not in self.maps_name:
            self.maps_name = self.maps_name + ['dot']
            self.maps_descr = self.maps_descr + ['Dot volume fraction']

    def get_params(self):
        return {'id': self.id, 'name': self.name, 'dPar': self.dPar,
                'dIso': self.dIso, 'IC_VFs': self.IC_VFs,
                'IC_ODs': self.IC_ODs, 'isExvivo': self.isExvivo}

    def set_solver(self, lambda1=5e-1, lambda2=1e-3, fista_iters=None,
                   cd_sweeps=None, refine_rounds=None, cg_iters=None,
                   stage_iters=None, tiebreak=None):
        """Defaults per reference models.pyx:721-724.  ``stage_iters``
        overrides the per-stage solver schedule
        ((fista, rounds, cg, inner) x2, (rounds, cg, inner)); a ``cg``
        entry may be a per-round tuple (rounds unroll), an ``inner``
        entry may be a per-round tuple (the solver runs its maximum), and
        each stage tuple may carry up to two trailing entries:
        ``converge`` (False | True | int continuation-CG budget --
        stability continuation rounds after the schedule) and ``add_k``
        (top-k violated-atom adds per round).  The default
        (base.DEFAULT_NODDI_STAGE_ITERS) is a pure active-set schedule
        validated against the exact oracle on the full dictionary."""
        self._set_solver_common(lambda1, lambda2, fista_iters, cd_sweeps,
                                refine_rounds, cg_iters)
        if stage_iters is not None:
            stage_iters = tuple(tuple(t) for t in stage_iters)
        self.solver_params['stage_iters'] = stage_iters
        # ``tiebreak``: stage-2 degenerate-vertex objective tie-break.
        # None/False = off (the shipped default; the round-5 campaign
        # measured -5% throughput with the tail unchanged), True = on
        # with the validated default CG budget
        # (base.DEFAULT_NODDI_TIEBREAK_CG), int = custom per-candidate
        # CG budget.  Reset on every call like the other solver params
        # (a sticky value would survive a later plain set_solver()).
        self.solver_params['tiebreak'] = (
            False if tiebreak is None
            else tiebreak if isinstance(tiebreak, bool)
            else int(tiebreak))

    def generate(self, out_path, aux, idx_in, idx_out, ndirs):
        """Coupled IC+EC atoms over the (IC_OD, IC_VF) grid + isotropic atom
        (reference models.pyx:727-751)."""
        scheme_high = _lut.create_high_resolution_scheme(self.scheme,
                                                         grad=aux.get('grad'))
        noddi_ic = NODDIIntraCellular(scheme_high)
        noddi_ec = NODDIExtraCellular(scheme_high)
        noddi_iso = NODDIIsotropic(scheme_high)

        nATOMS = len(self.IC_ODs) * len(self.IC_VFs) + 1
        idx = 0
        with ProgressBar(total=nATOMS, disable=get_verbose() < 3) as pbar:
            IC_KAPPAs = 1 / np.tan(self.IC_ODs * np.pi / 2)
            for kappa in IC_KAPPAs:
                signal_ic = noddi_ic.get_signal(self.dPar, kappa)
                for v_ic in self.IC_VFs:
                    signal_ec = noddi_ec.get_signal(self.dPar, kappa, v_ic)
                    signal = v_ic * signal_ic + (1 - v_ic) * signal_ec
                    lm = _lut.rotate_kernel(signal, aux, idx_in, idx_out, False, ndirs)
                    self._save_atom(out_path, idx + 1, lm)
                    idx += 1
                    pbar.update()
            signal = noddi_iso.get_signal(self.dIso)
            lm = _lut.rotate_kernel(signal, aux, idx_in, idx_out, True, ndirs)
            self._save_atom(out_path, nATOMS, lm)
            pbar.update()

    def resample(self, in_path, idx_out, Ylm_out, doMergeB0, ndirs):
        """KERNELS layout per reference models.pyx:754-792; 'norms' is stored
        as a per-atom vector (the reference's (dwi_count, n_wm) matrix has
        constant columns, models.pyx:782-784)."""
        nATOMS = len(self.IC_ODs) * len(self.IC_VFs) + 1
        nS, merge_idx = self._merge_idx(doMergeB0)
        n_wm = nATOMS - 1
        KERNELS = {'model': self.id}
        KERNELS['wm'] = np.zeros((n_wm, ndirs, nS), dtype=np.float32)
        KERNELS['iso'] = np.zeros(nS, dtype=np.float32)
        KERNELS['kappa'] = np.zeros(n_wm, dtype=np.float32)
        KERNELS['icvf'] = np.zeros(n_wm, dtype=np.float32)
        KERNELS['norms'] = np.zeros(n_wm, dtype=np.float64)

        idx = 0
        with ProgressBar(total=nATOMS, disable=get_verbose() < 3) as pbar:
            for i in range(len(self.IC_ODs)):
                for j in range(len(self.IC_VFs)):
                    lm = self._load_atom(in_path, idx + 1, ndirs)
                    KERNELS['wm'][idx] = _lut.resample_kernel(
                        lm, self.scheme.nS, idx_out, Ylm_out, False, ndirs)[:, merge_idx]
                    KERNELS['kappa'][idx] = 1.0 / np.tan(self.IC_ODs[i] * np.pi / 2.0)
                    KERNELS['icvf'][idx] = self.IC_VFs[j]
                    if doMergeB0:
                        dwi_part = KERNELS['wm'][idx, 0, 1:]
                    else:
                        dwi_part = KERNELS['wm'][idx, 0, self.scheme.dwi_idx]
                    KERNELS['norms'][idx] = 1.0 / np.linalg.norm(dwi_part)
                    idx += 1
                    pbar.update()
            lm = self._load_atom(in_path, nATOMS, ndirs, isotropic=True)
            KERNELS['iso'] = _lut.resample_kernel(
                lm, self.scheme.nS, idx_out, Ylm_out, True, ndirs)[merge_idx]
            pbar.update()
        return KERNELS

    def fit(self, evaluation):
        fit_chunk, shapes, cache_key, consts = self.chunk_program(evaluation)
        return self._run_tiled_fit(evaluation, fit_chunk, shapes,
                                   cache_key=cache_key, consts=consts)

    def chunk_program(self, evaluation):
        """The per-chunk device program of :meth:`fit` and what the tile
        driver needs to run it: ``(fit_chunk, output_shapes, cache_key,
        consts)``, where ``fit_chunk(Y (C,M,nS), dirs (C,), valid (C,M),
        *consts)`` returns the chunk's output dict.  Exposed so the
        benchmark and the compile check run exactly what ``fit`` runs."""
        import jax.numpy as jnp

        configs = self._common_configs(evaluation)
        configs['compute_modulated_maps'] = bool(
            evaluation.get_config('doSaveModulatedMaps'))
        kernels = evaluation.KERNELS
        solver_kw = self._solver_kwargs()
        lam1 = float(self.solver_params['lambda1'])
        lam2 = float(self.solver_params['lambda2'])
        # per-stage schedule: explicit stage_iters > legacy iteration knobs
        # (users who set fista_iters etc. keep the old uniform behavior) >
        # the validated active-set default
        stage_iters = self.solver_params.get('stage_iters')
        if stage_iters is None:
            if self.solver_params.get('custom_iters'):
                fi, rr = solver_kw['fista_iters'], solver_kw['refine_rounds']
                cg, ip = solver_kw['cg_iters'], 2
                stage_iters = ((fi, rr, cg, ip), (fi, rr, cg, ip),
                               (rr, cg, ip))
            else:
                from .base import DEFAULT_NODDI_STAGE_ITERS
                stage_iters = DEFAULT_NODDI_STAGE_ITERS
        _s1, _s2, _s3 = stage_iters
        for _t, _base in ((_s1, 4), (_s2, 4), (_s3, 3)):
            if len(_t) > _base + 2:
                raise ValueError(
                    f'stage tuple {_t} has {len(_t)} entries; at most '
                    f'{_base + 2} are meaningful (base {_base} + converge '
                    f'+ add_k)')
        (s1f, s1r, s1cg, s1i) = _s1[:4]
        (s2f, s2r, s2cg, s2i) = _s2[:4]
        (s3r, s3cg, s3i) = _s3[:3]
        # optional trailing per-stage entries: ``converge`` (False|True|int
        # CG budget -- continuation rounds after the schedule until the
        # working sets are stable) and ``add_k`` (top-k atom adds per
        # round); see ops/solvers.nneg_qp_batch
        s1cv = _s1[4] if len(_s1) > 4 else False
        s2cv = _s2[4] if len(_s2) > 4 else False
        s3cv = _s3[3] if len(_s3) > 3 else False
        s1ak = int(_s1[5]) if len(_s1) > 5 else 1
        s2ak = int(_s2[5]) if len(_s2) > 5 else 1
        s3ak = int(_s3[4]) if len(_s3) > 4 else 1
        # per-round inner-pass tuples run at their cap (ops/solvers has one
        # inner count per solve)
        s1i, s2i, s3i = (max(v) if isinstance(v, tuple) else v
                         for v in (s1i, s2i, s3i))

        n_wm = kernels['wm'].shape[0]
        is_exvivo = bool(self.isExvivo)
        n_atoms = n_wm + 1 + (1 if is_exvivo else 0)
        nS = kernels['wm'].shape[2]
        ndirs = kernels['wm'].shape[1]
        # merged-b0 layout (mean b0 in column 0, DWIs after) iff the
        # doMergeB0 preprocessing ran -- the same decision resample() made
        # when building KERNELS (reference models.pyx:914-921 keys this
        # off the scheme's layout after core.py:225-228 collapsed it).
        # Inferring it from y.shape would misfire on schemes with exactly
        # one b0 that is not the first volume.
        single_b0 = bool(evaluation.get_config('doMergeB0'))
        if single_b0:
            rows_dwi = np.arange(1, nS)
        else:
            rows_dwi = np.asarray(self.scheme.dwi_idx, np.int64)

        from ..ops.solvers import gram, power_iteration_L

        import jax

        # per-direction dictionaries, Gram matrices and Lipschitz constants,
        # computed ONCE and cached across fit() calls on the same KERNELS
        # (the reference re-copies the dictionary per voxel,
        # models.pyx:905-908); one compiled dispatch and no host re-uploads
        # NB: cache holds a reference to the keyed array and compares with
        # `is` -- id() alone can be recycled after garbage collection
        prep_key = (kernels['wm'], is_exvivo, single_b0)
        cached = getattr(self, '_prep_cache', None)
        if cached is not None and cached[0][0] is prep_key[0] \
                and cached[0][1:] == prep_key[1:]:
            (A_all, G1_all, L1_all, G2_all, L2_all, A2_all,
             iso_dwi, K_iso, norms, icvf, kappa) = cached[1]
        else:
            K_wm = jnp.asarray(np.ascontiguousarray(
                np.transpose(kernels['wm'], (1, 2, 0))), jnp.float32)
            K_iso = jnp.asarray(kernels['iso'], jnp.float32)
            norms = jnp.asarray(kernels['norms'], jnp.float32)
            icvf = jnp.asarray(kernels['icvf'], jnp.float32)
            kappa = jnp.asarray(kernels['kappa'], jnp.float32)
            # rows_dwi enters _prep as a CLOSED-OVER numpy constant, not a
            # traced argument: a traced index array turns every axis-1
            # slice into a dynamic gather in the per-chunk program, where
            # the constant-index form folds into static slices
            rows_c = np.asarray(rows_dwi, np.int32)

            @jax.jit
            def _prep(K_wm, K_iso, norms):
                cols = [K_wm]
                if is_exvivo:
                    cols.append(jnp.ones((ndirs, nS, 1), jnp.float32))
                cols.append(jnp.broadcast_to(K_iso[None, :, None],
                                             (ndirs, nS, 1)))
                A_all = jnp.concatenate(cols, axis=-1)  # (ndirs, nS, na)
                G1_all = gram(A_all)
                L1_all = power_iteration_L(G1_all)
                A2_all = A_all[:, rows_c, :n_wm] * norms[None, None, :]
                G2_all = gram(A2_all)
                L2_all = power_iteration_L(G2_all)
                return (A_all, G1_all, L1_all, G2_all, L2_all, A2_all,
                        K_iso[rows_c])

            (A_all, G1_all, L1_all, G2_all, L2_all, A2_all,
             iso_dwi) = _prep(K_wm, K_iso, norms)
            self._prep_cache = (prep_key,
                                (A_all, G1_all, L1_all, G2_all, L2_all,
                                 A2_all, iso_dwi,
                                 K_iso, norms, icvf, kappa))

        # static DWI-row index for the chunk programs (see _prep note)
        rows_c = np.asarray(rows_dwi, np.int32)

        # stage-2 degenerate-vertex tie-break (round 5, PARITY.md 'error
        # tail'): CG budget per swapped-support candidate; the neighbour
        # tables map each WM atom to its same-ICVF adjacent-kappa atoms.
        # Default OFF -- measured ~5% cost with no tail improvement (the
        # tail is sub-f32-resolution vertex degeneracy, PARITY.md 'error
        # tail'); set_solver(tiebreak=True) enables it for experiments.
        from .base import DEFAULT_NODDI_TIEBREAK_CG
        tb = self.solver_params.get('tiebreak', False)
        tb_cg = DEFAULT_NODDI_TIEBREAK_CG if tb is True else int(tb or 0)
        nb_m, nb_p = _kappa_neighbours(np.asarray(kernels['icvf']),
                                       np.asarray(kernels['kappa']))

        def fit_chunk(Y, dirs, valid, A_all, G1_all, L1_all, G2_all, L2_all,
                      A2_all, iso_dwi, icvf, kappa, nb_m, nb_p):
            A_full = A_all[dirs]                        # (C, nS, na)
            G1 = G1_all[dirs]
            L1 = L1_all[dirs]
            b1 = project(A_full, Y)

            # ---- stage 1: NNLS for the CSF fraction (models.pyx:911)
            x1 = solve_tiles(G1, b1, L1, 0.0, 0.0,
                             solver_kw=dict(fista_iters=s1f, cd_sweeps=0,
                                            refine_rounds=s1r, cg_iters=s1cg,
                                            inner_passes=s1i, converge=s1cv,
                                            add_k=s1ak))
            x_iso1 = x1[..., -1]

            # ---- stage 2: scaled DWI-only lasso (models.pyx:914-926)
            Y2 = Y[..., rows_c] - x_iso1[..., None] * iso_dwi
            if is_exvivo:
                Y2 = Y2 - x1[..., n_atoms - 2][..., None]
            Y2 = jnp.maximum(Y2, 0.0)
            A2 = A2_all[dirs]
            b2 = project(A2, Y2)
            x2 = solve_tiles(G2_all[dirs], b2, L2_all[dirs], lam1, lam2,
                             solver_kw=dict(fista_iters=s2f, cd_sweeps=0,
                                            refine_rounds=s2r, cg_iters=s2cg,
                                            inner_passes=s2i, converge=s2cv,
                                            add_k=s2ak))
            if tb_cg:
                # degenerate-vertex objective tie-break
                # (ops.solvers.noddi_stage2_tiebreak)
                from ..ops.solvers import noddi_stage2_tiebreak
                x2 = noddi_stage2_tiebreak(G2_all[dirs], b2, x2, lam1,
                                           lam2, nb_m, nb_p,
                                           cg_iters=tb_cg)

            # ---- stage 3: debias on the positive support (models.pyx:928-942)
            mask_wm = (x2 > 0.0).astype(Y.dtype)
            ones_tail = jnp.ones(Y.shape[:2] + (n_atoms - n_wm,), Y.dtype)
            mask = jnp.concatenate([mask_wm, ones_tail], axis=-1)
            # warm start: seed the working set with the (small) allowed
            # support and start CG from the stage-1 solution on it
            x = solve_tiles(G1, b1, L1, 0.0, 0.0, mask=mask,
                            m0=mask, x0=x1 * mask,
                            solver_kw=dict(fista_iters=0, cd_sweeps=0,
                                           refine_rounds=s3r, cg_iters=s3cg,
                                           inner_passes=s3i, converge=s3cv,
                                           add_k=s3ak))

            # ---- estimates (models.pyx:944-967)
            sum_atoms = jnp.sum(x, axis=-1) + 1e-16
            xn_wm = x[..., :n_wm] / sum_atoms[..., None]
            sum_wm = jnp.sum(xn_wm, axis=-1) + 1e-16
            f1 = jnp.sum(icvf * xn_wm, axis=-1) / sum_wm
            f2 = jnp.sum((1.0 - icvf) * xn_wm, axis=-1) / sum_wm
            k1 = jnp.sum(kappa * xn_wm, axis=-1) / sum_wm
            ndi = f1 / (f1 + f2 + 1e-16)
            odi = 2.0 / jnp.pi * jnp.arctan2(1.0, k1)
            fwf = x[..., -1] / sum_atoms
            maps = [ndi, odi, fwf]
            if is_exvivo:
                maps.append(x[..., n_atoms - 2] / sum_atoms)
            est = jnp.stack(maps, axis=-1) * valid[..., None]

            out = {'estimates': est}
            out.update(error_maps(A_full, x, Y, configs['compute_rmse'],
                                  configs['compute_nrmse']))
            if configs['compute_modulated_maps']:
                tf = 1.0 - fwf
                out['estimates_mod'] = jnp.stack([ndi * tf, odi * tf], -1) \
                    * valid[..., None]
            return out

        shapes = {'estimates': (len(self.maps_name),)}
        if configs['compute_rmse']:
            shapes['rmse'] = ()
        if configs['compute_nrmse']:
            shapes['nrmse'] = ()
        if configs['compute_modulated_maps']:
            shapes['estimates_mod'] = (2,)
        # rows_c is BAKED into the chunk program (static index -- see the
        # _prep note), so the compiled-fn cache must key on its content:
        # two schemes with identical shapes but different DWI-row layouts
        # (e.g. a permuted protocol) would otherwise share an executable
        # built for the wrong rows (caught by
        # tests/test_solver_review.py::test_noddi_rows_from_scheme_not_shape)
        cache_key = ('noddi', stage_iters,
                     lam1, lam2, is_exvivo, single_b0, n_wm, nS, tb_cg,
                     tuple(rows_c.tolist()),
                     tuple(sorted(configs.items())))
        consts = (A_all, G1_all, L1_all, G2_all, L2_all, A2_all, iso_dwi,
                  icvf, kappa, nb_m, nb_p)
        return fit_chunk, shapes, cache_key, consts

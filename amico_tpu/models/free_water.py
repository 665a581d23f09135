"""Free-Water elimination model.

Parity with /root/reference/amico/models.pyx:995-1286: Human (10 zeppelins +
1 iso) and Mouse (10 zeppelins + 2 iso) variants, single non-negative lasso
with lambda1=0 lambda2=1e-3 (1077-1080), maps FiberVolume/FW (+FW_blood/
FW_csf for Mouse, 1240-1255), optional free-water-corrected DWI
(1264-1274).
"""
from __future__ import annotations

import numpy as np

from .. import lut as _lut
from ..synthesis import Ball, Zeppelin
from ..utils.logging import PRINT, get_verbose
from ..utils.progress import ProgressBar
from ._fitops import error_maps, predict, project, solve_tiles
from .base import BaseModel


class FreeWater(BaseModel):
    def __init__(self):
        self.id = 'FreeWater'
        self.name = 'Free-Water'
        self.maps_name = []
        self.maps_descr = []
        self.scheme = None
        self.set()

    def set(self, d_par=None, d_perps=None, d_isos=None, type='Human'):
        """Defaults per reference models.pyx:1004-1058."""
        self.type = type
        if self.type == 'Mouse':
            self.maps_name = ['FiberVolume', 'FW', 'FW_blood', 'FW_csf']
            self.maps_descr = ['fiber volume fraction',
                               'Isotropic free-water volume fraction',
                               'FW blood', 'FW csf']
            self.d_par = 1.0e-3 if d_par is None else d_par
            self.d_perps = np.linspace(0.15, 0.55, 10) * 1e-3 if d_perps is None \
                else np.asarray(d_perps)
            self.d_isos = [1.5e-3, 3e-3] if d_isos is None else d_isos
        else:
            self.maps_name = ['FiberVolume', 'FW']
            self.maps_descr = ['fiber volume fraction',
                               'Isotropic free-water volume fraction']
            self.d_par = 1.0e-3 if d_par is None else d_par
            self.d_perps = np.linspace(0.1, 1.0, 10) * 1e-3 if d_perps is None \
                else np.asarray(d_perps)
            self.d_isos = [2.5e-3] if d_isos is None else d_isos

        PRINT('      %s settings for Freewater elimination... ' % self.type)
        PRINT('             -iso  compartments: ', self.d_isos)
        PRINT('             -perp compartments: ', self.d_perps)
        PRINT('             -para compartments: ', self.d_par)

    def get_params(self):
        return {'id': self.id, 'name': self.name, 'd_par': self.d_par,
                'd_perps': self.d_perps, 'd_isos': self.d_isos,
                'type': self.type}

    def set_solver(self, lambda1=0.0, lambda2=1e-3, fista_iters=None,
                   cd_sweeps=None, refine_rounds=None, cg_iters=None):
        """Defaults per reference models.pyx:1077-1080.  (The reference notes
        'need more regul for mouse data' lambda2=0.25 but the assignment is
        dead code, models.pyx:1082-1085 -- we keep the live behavior.)"""
        self._set_solver_common(lambda1, lambda2, fista_iters, cd_sweeps,
                                refine_rounds, cg_iters)

    def generate(self, out_path, aux, idx_in, idx_out, ndirs):
        """Reference models.pyx:1088-1110."""
        scheme_high = _lut.create_high_resolution_scheme(self.scheme,
                                                         grad=aux.get('grad'))
        zeppelin = Zeppelin(scheme_high)
        ball = Ball(scheme_high)

        nATOMS = len(self.d_perps) + len(self.d_isos)
        idx = 0
        with ProgressBar(total=nATOMS, disable=get_verbose() < 3) as pbar:
            for d in self.d_perps:
                signal = zeppelin.get_signal(self.d_par, d)
                self._save_atom(out_path, idx + 1,
                                _lut.rotate_kernel(signal, aux, idx_in, idx_out, False, ndirs))
                idx += 1
                pbar.update()
            for d in self.d_isos:
                signal = ball.get_signal(d)
                self._save_atom(out_path, idx + 1,
                                _lut.rotate_kernel(signal, aux, idx_in, idx_out, True, ndirs))
                idx += 1
                pbar.update()

    def resample(self, in_path, idx_out, Ylm_out, doMergeB0, ndirs):
        """KERNELS layout D/CSF per reference models.pyx:1113-1144."""
        nS, merge_idx = self._merge_idx(doMergeB0)
        KERNELS = {'model': self.id}
        KERNELS['D'] = np.zeros((len(self.d_perps), ndirs, nS), dtype=np.float32)
        KERNELS['CSF'] = np.zeros((len(self.d_isos), nS), dtype=np.float32)

        nATOMS = len(self.d_perps) + len(self.d_isos)
        idx = 0
        with ProgressBar(total=nATOMS, disable=get_verbose() < 3) as pbar:
            for i in range(len(self.d_perps)):
                lm = self._load_atom(in_path, idx + 1, ndirs)
                KERNELS['D'][i] = _lut.resample_kernel(
                    lm, self.scheme.nS, idx_out, Ylm_out, False, ndirs)[:, merge_idx]
                idx += 1
                pbar.update()
            for i in range(len(self.d_isos)):
                lm = self._load_atom(in_path, idx + 1, ndirs, isotropic=True)
                KERNELS['CSF'][i] = _lut.resample_kernel(
                    lm, self.scheme.nS, idx_out, Ylm_out, True, ndirs)[merge_idx]
                idx += 1
                pbar.update()
        return KERNELS

    def fit(self, evaluation):
        import jax.numpy as jnp

        configs = self._common_configs(evaluation)
        configs['save_corrected_DWI'] = bool(
            evaluation.get_config('doSaveCorrectedDWI'))
        kernels = evaluation.KERNELS
        solver_kw = self._solver_kwargs()
        lam1 = float(self.solver_params['lambda1'])
        lam2 = float(self.solver_params['lambda2'])

        n_perp = kernels['D'].shape[0]
        n_iso = kernels['CSF'].shape[0]
        is_mouse = self.type == 'Mouse'
        nS = kernels['D'].shape[2]
        ndirs = kernels['D'].shape[1]

        from ..ops.solvers import gram, power_iteration_L

        import jax

        prep_key = (kernels['D'],)   # held by reference; compared with `is`
        cached = getattr(self, '_prep_cache', None)
        if cached is not None and cached[0][0] is prep_key[0]:
            A_all, G_all, L_all = cached[1]
        else:
            K_D = jnp.asarray(np.ascontiguousarray(
                np.transpose(kernels['D'], (1, 2, 0))), jnp.float32)
            K_CSF = jnp.asarray(kernels['CSF'].T, jnp.float32)

            @jax.jit
            def _prep(K_D, K_CSF):
                A_all = jnp.concatenate(
                    [K_D, jnp.broadcast_to(K_CSF[None], (ndirs, nS, n_iso))],
                    axis=-1)
                G_all = gram(A_all)
                return A_all, G_all, power_iteration_L(G_all)

            A_all, G_all, L_all = _prep(K_D, K_CSF)
            self._prep_cache = (prep_key, (A_all, G_all, L_all))

        def fit_chunk(Y, dirs, valid, A_all, G_all, L_all):
            A = A_all[dirs]
            b = project(A, Y)
            x = solve_tiles(G_all[dirs], b, L_all[dirs], lam1, lam2,
                            solver_kw=solver_kw)

            # estimates (models.pyx:1240-1255)
            x_sum = jnp.sum(x, axis=-1) + 1e-16
            v = jnp.sum(x[..., :n_perp], axis=-1) / x_sum
            maps = [v, 1.0 - v]
            if is_mouse:
                maps.append(x[..., n_perp] / x_sum)
                maps.append(x[..., n_perp + 1] / x_sum)
            est = jnp.stack(maps, axis=-1) * valid[..., None]

            out = {'estimates': est}
            out.update(error_maps(A, x, Y, configs['compute_rmse'],
                                  configs['compute_nrmse']))
            if configs['save_corrected_DWI']:
                # zero fiber coefficients, subtract the iso prediction,
                # clip >= 0 (models.pyx:1264-1274)
                x_iso_only = x.at[..., :n_perp].set(0.0)
                y_fw = predict(A, x_iso_only)
                out['y_corrected'] = jnp.maximum(Y - y_fw, 0.0) \
                    * valid[..., None]
            return out

        shapes = {'estimates': (len(self.maps_name),)}
        if configs['compute_rmse']:
            shapes['rmse'] = ()
        if configs['compute_nrmse']:
            shapes['nrmse'] = ()
        if configs['save_corrected_DWI']:
            shapes['y_corrected'] = (nS,)
        cache_key = ('freewater', tuple(sorted(solver_kw.items())),
                     lam1, lam2, is_mouse, n_perp, n_iso, nS,
                     tuple(sorted(configs.items())))
        return self._run_tiled_fit(evaluation, fit_chunk, shapes,
                                   cache_key=cache_key,
                                   consts=(A_all, G_all, L_all))

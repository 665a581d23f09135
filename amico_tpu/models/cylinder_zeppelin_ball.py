"""Cylinder-Zeppelin-Ball (ACTIVEAX) model.

Parity with /root/reference/amico/models.pyx:375-652: 21 cylinder radii +
4 zeppelins + 1 ball, single non-negative lasso with lambda1=0 lambda2=4
(439-442), maps v/a/d (617-636).  Requires a STEJSKALTANNER scheme
(446-447).

References
----------
Panagiotaki et al. (2012) NeuroImage 59: 2241-54.
"""
from __future__ import annotations

import numpy as np

from .. import lut as _lut
from ..synthesis import Ball, CylinderGPD, Zeppelin
from ..utils.logging import ERROR, get_verbose
from ..utils.progress import ProgressBar
from ._fitops import error_maps, project, solve_tiles
from .base import BaseModel


class CylinderZeppelinBall(BaseModel):
    def __init__(self):
        self.id = 'CylinderZeppelinBall'
        self.name = 'Cylinder-Zeppelin-Ball'
        self.maps_name = ['v', 'a', 'd']
        self.maps_descr = ['Intra-cellular volume fraction',
                           'Mean axonal diameter', 'Axonal density']
        self.scheme = None
        self.isExvivo = False  # NOTE: the reference reads this attribute but
        # never initializes it (models.pyx:435,549); we default it to False
        self.set()

    def set(self, d_par=0.6e-3,
            Rs=np.concatenate(([0.01], np.linspace(0.5, 8.0, 20))) * 1e-6,
            d_perps=np.array([1.19e-3, 0.85e-3, 0.51e-3, 0.17e-3]),
            d_isos=np.array([2.0e-3])):
        """Defaults per reference models.pyx:400-405."""
        self.d_par = d_par
        self.Rs = np.array(Rs)
        self.d_perps = np.array(d_perps)
        self.d_isos = np.array(d_isos)

    def get_params(self):
        return {'id': self.id, 'name': self.name, 'd_par': self.d_par,
                'Rs': self.Rs, 'd_perps': self.d_perps,
                'd_isos': self.d_isos, 'isExvivo': self.isExvivo}

    def set_solver(self, lambda1=0.0, lambda2=4.0, fista_iters=None,
                   cd_sweeps=None, refine_rounds=None, cg_iters=None):
        """Defaults per reference models.pyx:439-442."""
        self._set_solver_common(lambda1, lambda2, fista_iters, cd_sweeps,
                                refine_rounds, cg_iters)

    def _solver_kwargs(self) -> dict:
        """The lambda2=4 ridge makes this model's QP dense-support and
        well-conditioned -- use the FISTA-warm-started default
        (base.DENSE_AS_SOLVER_KW) instead of from-empty Lawson-Hanson."""
        if not getattr(self, 'solver_params', {}).get('custom_iters'):
            from .base import DENSE_AS_SOLVER_KW
            return dict(DENSE_AS_SOLVER_KW)
        return super()._solver_kwargs()

    def generate(self, out_path, aux, idx_in, idx_out, ndirs):
        """Reference models.pyx:445-479."""
        if self.scheme.version != 1:
            ERROR('This model requires a "VERSION: STEJSKALTANNER" scheme')
        scheme_high = _lut.create_high_resolution_scheme(self.scheme,
                                                         grad=aux.get('grad'))
        cylinder = CylinderGPD(scheme_high)
        zeppelin = Zeppelin(scheme_high)
        ball = Ball(scheme_high)

        nATOMS = len(self.Rs) + len(self.d_perps) + len(self.d_isos)
        idx = 0
        with ProgressBar(total=nATOMS, disable=get_verbose() < 3) as pbar:
            for R in self.Rs:
                signal = cylinder.get_signal(self.d_par, R)
                self._save_atom(out_path, idx + 1,
                                _lut.rotate_kernel(signal, aux, idx_in, idx_out, False, ndirs))
                idx += 1
                pbar.update()
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
        """KERNELS layout wmr/wmh/iso per reference models.pyx:482-523."""
        nS, merge_idx = self._merge_idx(doMergeB0)
        KERNELS = {'model': self.id}
        KERNELS['wmr'] = np.zeros((len(self.Rs), ndirs, nS), dtype=np.float32)
        KERNELS['wmh'] = np.zeros((len(self.d_perps), ndirs, nS), dtype=np.float32)
        KERNELS['iso'] = np.zeros((len(self.d_isos), nS), dtype=np.float32)

        nATOMS = len(self.Rs) + len(self.d_perps) + len(self.d_isos)
        idx = 0
        with ProgressBar(total=nATOMS, disable=get_verbose() < 3) as pbar:
            for i in range(len(self.Rs)):
                lm = self._load_atom(in_path, idx + 1, ndirs)
                KERNELS['wmr'][i] = _lut.resample_kernel(
                    lm, self.scheme.nS, idx_out, Ylm_out, False, ndirs)[:, merge_idx]
                idx += 1
                pbar.update()
            for i in range(len(self.d_perps)):
                lm = self._load_atom(in_path, idx + 1, ndirs)
                KERNELS['wmh'][i] = _lut.resample_kernel(
                    lm, self.scheme.nS, idx_out, Ylm_out, False, ndirs)[:, merge_idx]
                idx += 1
                pbar.update()
            for i in range(len(self.d_isos)):
                lm = self._load_atom(in_path, idx + 1, ndirs, isotropic=True)
                KERNELS['iso'][i] = _lut.resample_kernel(
                    lm, self.scheme.nS, idx_out, Ylm_out, True, ndirs)[merge_idx]
                idx += 1
                pbar.update()
        return KERNELS

    def fit(self, evaluation):
        import jax.numpy as jnp

        configs = self._common_configs(evaluation)
        kernels = evaluation.KERNELS
        solver_kw = self._solver_kwargs()
        lam1 = float(self.solver_params['lambda1'])
        lam2 = float(self.solver_params['lambda2'])

        n_rs = len(self.Rs)
        n_perp = len(self.d_perps)
        n_iso = len(self.d_isos)
        nS = kernels['wmr'].shape[2]
        ndirs = kernels['wmr'].shape[1]

        from ..ops.solvers import gram, power_iteration_L

        import jax

        Rs = jnp.asarray(self.Rs, jnp.float32)
        prep_key = (kernels['wmr'],)  # held by reference; compared with `is`
        cached = getattr(self, '_prep_cache', None)
        if cached is not None and cached[0][0] is prep_key[0]:
            A_all, G_all, L_all = cached[1]
        else:
            K_wm = jnp.asarray(np.ascontiguousarray(np.transpose(
                np.concatenate([kernels['wmr'], kernels['wmh']], axis=0),
                (1, 2, 0))), jnp.float32)         # (ndirs, nS, n_rs+n_perp)
            K_iso = jnp.asarray(kernels['iso'].T, jnp.float32)  # (nS, n_iso)

            @jax.jit
            def _prep(K_wm, K_iso):
                A_all = jnp.concatenate(
                    [K_wm, jnp.broadcast_to(K_iso[None], (ndirs, nS, n_iso))],
                    axis=-1)
                G_all = gram(A_all)
                return A_all, G_all, power_iteration_L(G_all)

            A_all, G_all, L_all = _prep(K_wm, K_iso)
            self._prep_cache = (prep_key, (A_all, G_all, L_all))

        def fit_chunk(Y, dirs, valid, A_all, G_all, L_all, Rs):
            A = A_all[dirs]
            b = project(A, Y)
            x = solve_tiles(G_all[dirs], b, L_all[dirs], lam1, lam2,
                            solver_kw=solver_kw)

            # estimates (models.pyx:617-636)
            f1 = jnp.sum(x[..., :n_rs], axis=-1)
            f2 = jnp.sum(x[..., n_rs:n_rs + n_perp], axis=-1) + 1e-16
            v = f1 / (f1 + f2 + 1e-16)
            f1 = f1 + 1e-16
            a = 1e6 * 2.0 * jnp.sum(Rs * x[..., :n_rs], axis=-1) / f1
            d = (4.0 * v) / (jnp.pi * a ** 2 + 1e-16)
            est = jnp.stack([v, a, d], axis=-1) * valid[..., None]

            out = {'estimates': est}
            out.update(error_maps(A, x, Y, configs['compute_rmse'],
                                  configs['compute_nrmse']))
            return out

        shapes = {'estimates': (len(self.maps_name),)}
        if configs['compute_rmse']:
            shapes['rmse'] = ()
        if configs['compute_nrmse']:
            shapes['nrmse'] = ()
        cache_key = ('czb', tuple(sorted(solver_kw.items())),
                     lam1, lam2, n_rs, n_perp, n_iso, nS,
                     tuple(sorted(configs.items())))
        return self._run_tiled_fit(evaluation, fit_chunk, shapes,
                                   cache_key=cache_key,
                                   consts=(A_all, G_all, L_all, Rs))

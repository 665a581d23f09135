"""SANDI (soma and neurite density imaging) model.

Parity with /root/reference/amico/models.pyx:1344-1627: 5 SphereGPD radii
(fixed d_is) + 5 Astrosticks + 5 Balls, all direction-averaged (isotropic),
atoms L2-normalized at resample (1446-1486), single non-negative lasso with
lambda1=0 lambda2=5e-3 (1405-1408), solution un-normalized by the stored
norms (1570-1571), maps fsoma/fneurite/fextra/Rsoma/Din/De (1573-1611).
Requires STEJSKALTANNER scheme + ``doDirectionalAverage`` preprocessing
(models.pyx:1412-1413, core.py:232-268).

References
----------
Palombo et al. (2020) NeuroImage 215: 116835.
"""
from __future__ import annotations

import numpy as np

from .. import lut as _lut
from ..synthesis import Astrosticks, Ball, SphereGPD
from ..utils.logging import ERROR, get_verbose
from ..utils.progress import ProgressBar
from ._fitops import error_maps
from .base import BaseModel


class SANDI(BaseModel):
    def __init__(self):
        self.id = 'SANDI'
        self.name = 'SANDI'
        self.maps_name = ['fsoma', 'fneurite', 'fextra', 'Rsoma', 'Din', 'De']
        self.maps_descr = ['Intra-soma volume fraction',
                           'Intra-neurite volume fraction',
                           'Extra-cellular volume fraction',
                           'Apparent soma radius',
                           'Neurite axial diffusivity',
                           'Extra-cellular mean diffusivity']
        self.scheme = None
        self.set()

    def set(self, d_is=3.0e-3, Rs=np.linspace(1.0, 12.0, 5) * 1e-6,
            d_in=np.linspace(0.25, 3.0, 5) * 1e-3,
            d_isos=np.linspace(0.25, 3.0, 5) * 1e-3):
        """Defaults per reference models.pyx:1367-1391."""
        self.d_is = d_is
        self.Rs = np.array(Rs)
        self.d_in = np.array(d_in)
        self.d_isos = np.array(d_isos)

    def get_params(self):
        return {'id': self.id, 'name': self.name, 'd_is': self.d_is,
                'Rs': self.Rs, 'd_in': self.d_in, 'd_isos': self.d_isos}

    def set_solver(self, lambda1=0.0, lambda2=5.0e-3, fista_iters=None,
                   cd_sweeps=None, refine_rounds=None, cg_iters=None):
        """Defaults per reference models.pyx:1405-1408."""
        self._set_solver_common(lambda1, lambda2, fista_iters, cd_sweeps,
                                refine_rounds, cg_iters)

    def _solver_kwargs(self) -> dict:
        """SANDI's directional-average system is rank-(nshells+1) with only
        a small ridge, so masked-CG convergence is set by conditioning, not
        working-set size -- the progressive active-set default of the other
        models under-converges here.  Keep the FISTA+CD warm start with the
        flat CG budget (cheap anyway: one shared 15-atom dictionary)."""
        sp = getattr(self, 'solver_params', {})
        from .base import (DEFAULT_CD_SWEEPS, DEFAULT_CG_ITERS,
                           DEFAULT_FISTA_ITERS, DEFAULT_REFINE_ROUNDS)
        cg = sp.get('cg_iters', DEFAULT_CG_ITERS)
        return {
            'fista_iters': int(sp.get('fista_iters', DEFAULT_FISTA_ITERS)),
            'cd_sweeps': int(sp.get('cd_sweeps', DEFAULT_CD_SWEEPS)),
            'refine_rounds': int(sp.get('refine_rounds', DEFAULT_REFINE_ROUNDS)),
            # cg_iters accepts a per-round tuple (see base._set_solver_common)
            'cg_iters': (tuple(int(v) for v in cg)
                         if isinstance(cg, (tuple, list)) else int(cg)),
        }

    def generate(self, out_path, aux, idx_in, idx_out, ndirs):
        """Reference models.pyx:1411-1443; all atoms treated isotropic."""
        if self.scheme.version != 1:
            ERROR('This model requires a "VERSION: STEJSKALTANNER" scheme')
        scheme_high = _lut.create_high_resolution_scheme(self.scheme,
                                                         grad=aux.get('grad'))
        sphere = SphereGPD(scheme_high)
        astrosticks = Astrosticks(scheme_high)
        ball = Ball(scheme_high)

        nATOMS = len(self.Rs) + len(self.d_in) + len(self.d_isos)
        idx = 0
        with ProgressBar(total=nATOMS, disable=get_verbose() < 3) as pbar:
            for R in self.Rs:
                signal = sphere.get_signal(self.d_is, R)
                self._save_atom(out_path, idx + 1,
                                _lut.rotate_kernel(signal, aux, idx_in, idx_out, True, ndirs))
                idx += 1
                pbar.update()
            for d in self.d_in:
                signal = astrosticks.get_signal(d)
                self._save_atom(out_path, idx + 1,
                                _lut.rotate_kernel(signal, aux, idx_in, idx_out, True, ndirs))
                idx += 1
                pbar.update()
            for d in self.d_isos:
                signal = ball.get_signal(d)
                self._save_atom(out_path, idx + 1,
                                _lut.rotate_kernel(signal, aux, idx_in, idx_out, True, ndirs))
                idx += 1
                pbar.update()

    def resample(self, in_path, idx_out, Ylm_out, doMergeB0, ndirs):
        """Normalized signal dictionary per reference models.pyx:1446-1486."""
        nATOMS = len(self.Rs) + len(self.d_in) + len(self.d_isos)
        nS, merge_idx = self._merge_idx(doMergeB0)
        KERNELS = {'model': self.id}
        KERNELS['signal'] = np.zeros((nS, nATOMS), dtype=np.float64, order='F')
        KERNELS['norms'] = np.zeros(nATOMS, dtype=np.float64)

        with ProgressBar(total=nATOMS, disable=get_verbose() < 3) as pbar:
            for idx in range(nATOMS):
                lm = self._load_atom(in_path, idx + 1, ndirs, isotropic=True)
                signal = _lut.resample_kernel(
                    lm, self.scheme.nS, idx_out, Ylm_out, True, ndirs)[merge_idx].T
                KERNELS['norms'][idx] = 1.0 / np.linalg.norm(signal)
                KERNELS['signal'][:, idx] = signal * KERNELS['norms'][idx]
                pbar.update()
        return KERNELS

    def fit(self, evaluation):
        """Direction-free fit: one shared dictionary for all voxels
        (reference models.pyx:1489-1627)."""
        import jax
        import jax.numpy as jnp

        configs = self._common_configs(evaluation)
        kernels = evaluation.KERNELS
        solver_kw = self._solver_kwargs()
        lam1 = float(self.solver_params['lambda1'])
        lam2 = float(self.solver_params['lambda2'])

        n_rs = len(self.Rs)
        n_in = len(self.d_in)

        from ..ops.solvers import gram, nneg_qp_batch, power_iteration_L

        # kernel tensors as jit *arguments* (not closure constants) and the
        # prep computed once per KERNELS -- mirrors the tiled driver; a
        # fresh jit per fit() call would retrace and recompile every time
        prep_key = (kernels['signal'],)
        cached = getattr(self, '_prep_cache', None)
        if cached is not None and cached[0][0] is prep_key[0]:
            A, G, Lc, norms = cached[1]
        else:
            A = jnp.asarray(kernels['signal'], jnp.float32)    # (nS, na)
            norms = jnp.asarray(kernels['norms'], jnp.float32)
            G = gram(A)
            Lc = power_iteration_L(G)
            self._prep_cache = (prep_key, (A, G, Lc, norms))
        Rs = jnp.asarray(self.Rs, jnp.float32)
        d_in = jnp.asarray(self.d_in, jnp.float32)
        d_isos = jnp.asarray(self.d_isos, jnp.float32)

        def fit_chunk(Y, A, G, Lc, norms, Rs, d_in, d_isos):
            prec = jax.lax.Precision.HIGHEST
            b = jnp.einsum('sa,ms->ma', A, Y, precision=prec)
            x = nneg_qp_batch(G, b, lam1, lam2, L=Lc,
                              **solver_kw)
            # un-normalize (models.pyx:1570-1571)
            xu = x * norms[None, :]

            # estimates (models.pyx:1573-1611)
            x_sum = jnp.sum(xu, axis=-1) + 1e-16
            xsph = jnp.sum(xu[..., :n_rs], axis=-1)
            xstk = jnp.sum(xu[..., n_rs:n_rs + n_in], axis=-1)
            xiso = jnp.sum(xu[..., n_rs + n_in:], axis=-1)
            fsoma = xsph / x_sum
            fneurite = xstk / x_sum
            fextra = xiso / x_sum
            Rsoma = 1e6 * jnp.sum(Rs * xu[..., :n_rs], axis=-1) / (xsph + 1e-16)
            Din = 1e3 * jnp.sum(d_in * xu[..., n_rs:n_rs + n_in], axis=-1) / (xstk + 1e-16)
            De = 1e3 * jnp.sum(d_isos * xu[..., n_rs + n_in:], axis=-1) / (xiso + 1e-16)
            est = jnp.stack([fsoma, fneurite, fextra, Rsoma, Din, De], axis=-1)

            out = {'estimates': est}
            # shared-dictionary adapter: error_maps is tiled (C, ...); lift
            # the single shared A/chunk to a 1-tile batch.  A@x equals the
            # un-normalized prediction (A_unnorm @ xu) exactly.
            out.update({k: v[0] for k, v in error_maps(
                A[None], x[None], Y[None],
                configs['compute_rmse'], configs['compute_nrmse']).items()})
            return out

        # chunked direction-free driver (no tiling needed); jit memoized
        # across fit() calls, chunks all dispatched before any result pull
        cache_key = ('sandi', lam1, lam2,
                     tuple(sorted(solver_kw.items())),
                     tuple(sorted(configs.items())))
        cache = getattr(self, '_fit_fn_cache', None)
        if cache is None:
            cache = self._fit_fn_cache = {}
        fit_jit = cache.get(cache_key)
        if fit_jit is None:
            fit_jit = cache[cache_key] = jax.jit(fit_chunk)

        y = np.asarray(evaluation.y, np.float32)
        N = y.shape[0]
        vpc = evaluation.get_config('voxels_per_chunk') or 'auto'
        if vpc == 'auto':
            # direction-free fit: equal-split into <=4 chunks, quantized
            # so nearby volume sizes share one compiled chunk shape (see
            # base.py).  Chunks run serially on device and this tiny
            # 15-atom solve is sequential-step bound, so few chunks mean
            # few serial windows while the async D2H still overlaps
            nchunks = max(1, min(4, -(-N // 51200)))
            per_chunk = -(-N // nchunks)
            chunk = -(-per_chunk // 4096) * 4096
        else:
            chunk = int(vpc)
        # device staging cache (the tiled driver's warm re-fit semantics,
        # base._run_tiled_fit): a re-fit of the SAME signal array skips the
        # per-chunk uploads of this tiny direction-averaged problem (the
        # solve itself is ~15 atoms x nshells+1 samples).  Keyed by array
        # identity + chunking.
        stage_key = (evaluation.y, chunk)
        staged = getattr(self, '_stage_cache', None)
        if staged is not None and staged[0][0] is stage_key[0] \
                and staged[0][1] == stage_key[1]:
            chunks_dev = staged[1]
        else:
            chunks_dev = {}
            self._stage_cache = (stage_key, chunks_dev)
        import time as _time
        timers = {}
        _t0 = _time.time()
        pending = []
        for start in range(0, N, chunk):
            Yc_dev = chunks_dev.get(start)
            if Yc_dev is None:
                Yc = y[start:start + chunk]
                # auto mode pads even a lone chunk to the quantized size so
                # nearby volume sizes share one compiled shape; explicit
                # chunk sizes keep the historical no-pad single-chunk shape
                pad = chunk - Yc.shape[0] \
                    if Yc.shape[0] < chunk and (vpc == 'auto' or N > chunk) \
                    else 0
                if pad:
                    Yc = np.concatenate(
                        [Yc, np.zeros((pad, y.shape[1]), y.dtype)])
                Yc_dev = chunks_dev[start] = jnp.asarray(Yc)
            res = fit_jit(Yc_dev, A, G, Lc, norms, Rs, d_in, d_isos)
            # start D2H as soon as this chunk's solve finishes so result
            # transfers overlap the remaining chunks' compute instead of
            # pulling SANDI's 6 full-brain maps serially after the solve
            for arr in res.values():
                try:
                    arr.copy_to_host_async()
                except AttributeError:
                    pass
            pending.append((min(chunk, N - start), res))
        # phase timers, same contract as base._run_tiled_fit (the bench's
        # per-model fit_breakdown)
        timers['n_chunks'] = len(pending)
        timers['dispatch_s'] = _time.time() - _t0
        if pending:
            for arr in pending[-1][1].values():
                arr.block_until_ready()
        timers['device_s'] = _time.time() - _t0 - timers['dispatch_s']
        _t1 = _time.time()
        outs: dict[str, list] = {}
        for take, res in pending:
            for k, v in res.items():
                outs.setdefault(k, []).append(np.asarray(v, np.float32)[:take])
        out = {k: np.concatenate(v) for k, v in outs.items()}
        timers['pull_s'] = _time.time() - _t1
        self._last_fit_timers = timers
        return out

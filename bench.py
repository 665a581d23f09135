#!/usr/bin/env python
"""Benchmark: full-scale NODDI fit throughput (voxels/sec).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}, with
the device it ran on (platform, device_kind, device count) in its detail.

Setup mirrors the reference's headline workload (BASELINE.md): the full
NODDI dictionary (12 IC_VFs x 12 IC_ODs + 1 iso = 145 atoms,
/root/reference/amico/models.pyx:675-680) on a 2-shell protocol, fit over
synthetic voxels through the production tile engine (3-stage batched solve).

``vs_baseline`` is measured in-process: the reference's per-voxel solver
path (exact active-set NNLS/lasso in C++, the same algorithm class as
SPAMS) is timed on a voxel sample single-threaded and scaled by the host
core count (the reference fit uses one solver thread per core,
models.pyx:529-541, BLAS_nthreads=1 core.py:96).

Env knobs: BENCH_VOXELS (default 409600 -- a full-brain masked voxel count,
SURVEY.md section 5.7), BENCH_SMALL=1 for a quick run,
BENCH_ALL=1 to also measure FreeWater / CylinderZeppelinBall / SANDI
throughputs (BASELINE.md configs 2-4) into the detail dict.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

_T0 = time.time()


def _trace(msg):
    """Stage progress on stderr (stdout carries only the JSON line), so a
    hung/timed-out bench run is diagnosable from its partial output."""
    print(f'[bench +{time.time() - _T0:7.1f}s] {msg}', file=sys.stderr,
          flush=True)


def main():
    small = os.environ.get('BENCH_SMALL') == '1'
    n_vox = int(os.environ.get('BENCH_VOXELS', 8000 if small else 409600))

    os.environ.setdefault('AMICO_TPU_HOME',
                          os.path.join(os.path.expanduser('~'), '.amico_tpu'))

    import jax
    from amico_tpu.testing import demo_noddi, demo_voxels
    from amico_tpu import set_verbose
    set_verbose(1)

    # reference-scale protocol: 9 b0 + 30 @ b=700 + 60 @ b=2000
    from amico_tpu.io.scheme import Scheme
    from amico_tpu.ops.sphere import fibonacci_hemisphere
    rows = [np.zeros((9, 4)),
            np.c_[fibonacci_hemisphere(30), np.full(30, 700.0)],
            np.c_[fibonacci_hemisphere(60), np.full(60, 2000.0)]]
    scheme = Scheme(np.vstack(rows))

    kdir = os.path.join(os.environ['AMICO_TPU_HOME'],
                        'bench_kernels_small' if small else 'bench_kernels')
    _trace(f'setup: n_vox={n_vox} device={jax.devices()[0]}')
    t0 = time.time()
    model, kernels, htable = demo_noddi(scheme, small=small, kernels_dir=kdir)
    t_kernels = time.time() - t0
    _trace(f'kernels ready ({t_kernels:.1f}s)')

    y, DIRs, lut_idx = demo_voxels(n_vox, kernels, htable, seed=0)
    _trace('voxels synthesized')

    class Ctx:
        def __init__(self, **cfg):
            self.y, self.DIRs, self.htable, self.KERNELS = y, DIRs, htable, kernels
            tile = os.environ.get('BENCH_TILE', 'auto')
            self._cfg = {'doComputeRMSE': False, 'doComputeNRMSE': False,
                         'doSaveModulatedMaps': False,
                         'tile_size': tile if tile == 'auto' else int(tile),
                         'voxels_per_chunk': 'auto'}
            self._cfg.update(cfg)

        def get_config(self, k):
            return self._cfg.get(k)

    # warm-up: full-shape run (compiles are cached per chunk shape), then
    # measure steady-state throughput (best of 3).  The headline is the
    # steady-state staged fit, which re-runs all host work but reuses
    # staged device data.
    ctx = Ctx()

    # first fit: separate true XLA compile time (monitoring events;
    # near-zero on a warm persistent cache) from the cold-start wall clock
    compile_secs = [0.0]
    compile_known = True
    try:
        # private jax API: a rename must degrade to 'compile time unknown'
        # (reported as null), never abort the bench or fake a warm cache
        def _on_event(event, dur, **kw):
            if event == '/jax/core/compile/backend_compile_duration':
                compile_secs[0] += dur
        from jax._src import monitoring as _mon
        _mon.register_event_duration_secs_listener(_on_event)
    except Exception:
        compile_known = False
    t0 = time.time()
    model.fit(ctx)
    t_cold = time.time() - t0
    t_compile = compile_secs[0]
    _trace(f'first fit done (wall {t_cold:.1f}s, compile {t_compile:.1f}s)')

    # steady-state fit on already-loaded data: host tiling + device solve +
    # map download each rep; the device staging cache skips the re-upload
    # (the multi-model / warm re-fit path)
    t_staged = float('inf')
    for _ in range(3):
        t0 = time.time()
        res = model.fit(ctx)
        t_staged = min(t_staged, time.time() - t0)
    staged_voxps = n_vox / t_staged
    # phase breakdown of the staged fit (models/base.py timers): where
    # the staged-vs-solver-only gap goes (dispatch enqueue / device wall /
    # result pull / host untile)
    fit_breakdown = {k: round(v, 4) if isinstance(v, float) else v
                     for k, v in
                     getattr(model, '_last_fit_timers', {}).items()}
    # cold-data reps: a fresh y identity forces the signal re-upload
    t_reup = float('inf')
    for _ in range(3):
        ctx.y = y.copy()
        t0 = time.time()
        model.fit(ctx)
        t_reup = min(t_reup, time.time() - t0)
    voxps = staged_voxps
    _trace(f'steady-state fits done (staged {t_staged:.2f}s, '
           f'reup {t_reup:.2f}s)')

    # device-solve-only throughput: the production NODDI chunk program
    # (NODDI.chunk_program, what fit() dispatches) on pre-staged tiles of
    # all voxels in one dispatch -- no host tiling or transfers
    import jax.numpy as jnp
    from amico_tpu.models.engine import build_tile_plan, tile_voxels
    fit_chunk, _, _, consts = model.chunk_program(ctx)
    plan = build_tile_plan(lut_idx, 128)
    Yt_d = jnp.asarray(tile_voxels(plan, y.astype(np.float32)))
    dirs_d = jnp.asarray(plan.tile_dirs)
    valid_d = jnp.asarray(plan.valid)
    solve = jax.jit(lambda *a: fit_chunk(*a)['estimates'])
    run = lambda: solve(Yt_d, dirs_d, valid_d, *consts)
    run().block_until_ready()
    t_sol = float('inf')
    for _ in range(3):
        t0 = time.time()
        run().block_until_ready()
        t_sol = min(t_sol, time.time() - t0)
    solver_voxps = n_vox / t_sol
    _trace(f'solver-only bench done ({solver_voxps:,.0f} vox/s)')

    # sanity on outputs
    est = res['estimates']
    assert np.isfinite(est).all()

    # ---- CPU reference baseline: exact per-voxel solves running the
    # reference's OWN algorithms -- Lawson-Hanson active set for the nnls
    # calls (SPAMS nnls) and LARS/homotopy for the lasso call (SPAMS
    # lasso, models.pyx:926; native.lasso defaults to 'lars').  The same
    # pass doubles as the accuracy audit: the oracle's maps on this
    # sample bound the device fit's solver error per run, reported as
    # oracle_map_err_* in the detail dict -- measured vs LARS since
    # round 4 (the round-3 review's missing item 1).
    from amico_tpu.ops import native

    def oracle_maps_sample(algorithm):
        # the recipe lives ONCE in testing.noddi_oracle_voxel (shared with
        # the tail-analysis tools so they audit the judged oracle)
        from amico_tpu.testing import noddi_oracle_voxel
        return np.stack([
            noddi_oracle_voxel(kernels, dwi, y[i], int(lut_idx[i]),
                               algorithm=algorithm)
            for i in range(sample)])

    n_wm = kernels['wm'].shape[0]
    dwi = scheme.dwi_idx
    sample = min(100 if small else 1000, n_vox)
    t0 = time.time()
    est_oracle = oracle_maps_sample('lars')
    cpu_voxps_1t = sample / (time.time() - t0)
    # pivot-order cross-check (untimed -- the baseline clock must carry
    # only the reference path): the two algorithms minimize the same
    # strictly-convex objective, so any map gap flags a vertex-selection
    # difference on degenerate voxels (10k-voxel audit found none)
    lars_vs_as = float(np.abs(
        est_oracle - oracle_maps_sample('activeset')).max())
    _trace(f'cpu oracle audit done (LARS vs active-set max {lars_vs_as:.2e})')
    cpu_voxps = cpu_voxps_1t * (os.cpu_count() or 1)
    map_err = np.abs(np.asarray(est[:sample, :3], np.float64) - est_oracle)

    def emit(extra):
        out = {
            'metric': 'voxels/sec NODDI full-dictionary 3-stage fit',
            'value': round(voxps, 1),
            'unit': 'voxels/sec',
            'vs_baseline': round(voxps / cpu_voxps, 2),
            'detail': {
                'n_voxels': n_vox,
                'n_atoms': n_wm + 1,
                'nS': scheme.nS,
                'staged_fit_seconds': round(t_staged, 2),
                'staged_voxps': round(staged_voxps, 1),
                'reupload_fit_seconds': round(t_reup, 2),
                'solver_only_voxps': round(solver_voxps, 1),
                'solver_only_ms': round(t_sol * 1000, 1),
                # THIS process's first fit: compile (cold or from the
                # persistent cache, whichever this machine holds) and the
                # first fit's wall clock
                'compile_seconds': round(t_compile, 1) if compile_known
                else None,
                'cold_start_seconds': round(t_cold, 1),
                'kernel_gen_seconds': round(t_kernels, 1),
                'cpu_baseline_voxps_per_core': round(cpu_voxps_1t, 1),
                'cpu_baseline_voxps_allcores': round(cpu_voxps, 1),
                'cpu_cores': os.cpu_count(),
                'oracle_map_err_med': float(np.median(map_err)),
                'oracle_map_err_p95': float(np.percentile(map_err, 95)),
                'oracle_map_err_max': float(map_err.max()),
                # per-map maxima back the per-map bounds documented in
                # PARITY.md (the tail is ODI: adjacent kappa-grid vertices)
                'oracle_err_max_ndi': float(map_err[:, 0].max()),
                'oracle_err_max_odi': float(map_err[:, 1].max()),
                'oracle_err_max_fwf': float(map_err[:, 2].max()),
                'oracle_sample_voxels': sample,
                'oracle_algorithm': 'lars',
                'oracle_lars_vs_activeset_max': lars_vs_as,
                'fit_breakdown': fit_breakdown,
                'platform': jax.devices()[0].platform,
                'device_kind': jax.devices()[0].device_kind,
                'device_count': len(jax.devices()),
                **extra,
            },
        }
        print(json.dumps(out), flush=True)

    extra = {}
    # The PIPELINE bench runs FIRST (before the per-model benches): it is
    # the end-to-end number.
    if os.environ.get('BENCH_PIPELINE', '0' if small else '1') == '1':
        emit({'pipeline_bench': 'pending'})
        extra.update(bench_pipeline(n_vox, y, np.vstack(rows), _trace))
        _trace(f'pipeline bench done ({extra.get("pipeline_voxps", 0):,.0f}'
               f' / warm-refit {extra.get("pipeline_voxps_warmrefit", 0):,.0f})')

    # BASELINE.md configs 2-4 are part of the default output; BENCH_ALL=0
    # or BENCH_SMALL skips them.  The headline is emitted BEFORE them and
    # re-emitted (one line, superseding) after: a reader that takes the
    # LAST stdout line still gets a complete result if a run is cut
    # mid-extras.
    if os.environ.get('BENCH_ALL', '0' if small else '1') == '1':
        emit({'multi_model_benches': 'pending'})
        import jax.numpy as jnp
        from amico_tpu import lut as _lut
        from amico_tpu.models import CylinderZeppelinBall, FreeWater, SANDI
        from amico_tpu.io.scheme import GAMMA

        def bench_model(name, model, scheme_m, n=None, oracle=None,
                        oracle_cols=None):
            # full-brain volumes: per-voxel cost amortizes the
            # sequential-step latency of the small models, so
            # small-volume numbers understate them
            # ``oracle(K, model, y_i, lut_i) -> map vector`` enables a
            # 200-voxel exact-solver audit (the NODDI audit's analog for
            # the other models; LARS oracle = the reference's algorithm)
            n = n or int(os.environ.get('BENCH_ALL_VOXELS', 409600))
            kd = os.path.join(os.environ['AMICO_TPU_HOME'], f'bench_{name}')
            os.makedirs(kd, exist_ok=True)
            model.scheme = scheme_m
            model.set_solver()
            aux = _lut.load_precomputed_rotation_matrices(12, 500)
            i_in, i_out = _lut.aux_structures_generate(scheme_m, 12)
            if not os.path.isfile(os.path.join(kd, 'A_001.npy')):
                model.generate(kd, aux, i_in, i_out, 500)
            ridx, Ylm = _lut.aux_structures_resample(scheme_m, 12)
            K = model.resample(kd, ridx, Ylm, False, 500)
            rng2 = np.random.RandomState(1)
            yb = np.abs(rng2.rand(n, scheme_m.nS))
            Db = rng2.randn(n, 3)
            Db /= np.linalg.norm(Db, axis=1, keepdims=True)

            class C2:
                y, DIRs, KERNELS = yb, Db, K

                def get_config(self, k):
                    return {'tile_size': 'auto',
                            'voxels_per_chunk': 'auto'}.get(k)
            c2 = C2()
            c2.htable = htable
            model.fit(c2)
            best = float('inf')
            for _ in range(2):
                t1 = time.time()
                model.fit(c2)
                best = min(best, time.time() - t1)
            # per-model phase breakdown (the round-3 "small-model floor"
            # question: launch latency vs prep vs solve vs transfer)
            extra[f'{name}_breakdown'] = {
                k: round(v, 4) if isinstance(v, float) else v
                for k, v in getattr(model, '_last_fit_timers', {}).items()}
            extra[f'{name}_n_voxels'] = n
            if oracle is not None:
                from amico_tpu import lut as _lutm
                res = model.fit(c2)
                est_m = np.asarray(res['estimates'], np.float64)
                ns = min(200, n)
                lut_m = (None if Db is None else
                         _lutm.dir_to_lut_idx(Db[:ns].astype(np.float64),
                                              htable))
                ref_m = np.stack([
                    oracle(K, model, yb[i],
                           None if lut_m is None else lut_m[i])
                    for i in range(ns)])
                err_m = np.abs(est_m[:ns] - ref_m)
                if oracle_cols is not None:
                    # e.g. CZB's density d = 4v/(pi a^2) amplifies a
                    # near-zero-diameter difference into huge absolute
                    # deltas on noise voxels -- audit the stable columns
                    err_m = err_m[:, list(oracle_cols)]
                extra[f'{name}_oracle_err_med'] = float(np.median(err_m))
                extra[f'{name}_oracle_err_p95'] = float(
                    np.percentile(err_m, 95))
            return round(n / best, 1)

        def fw_oracle(K, model, y_i, lut_i):
            n_perp = K['D'].shape[0]
            A = np.column_stack([K['D'][:, lut_i, :].T, K['CSF'].T])
            x = native.lasso(A, y_i, 0.0, 1e-3)
            v = x[:n_perp].sum() / (x.sum() + 1e-16)
            return np.array([v, 1.0 - v])

        extra['freewater_voxps'] = bench_model('fw', FreeWater(), scheme,
                                               oracle=fw_oracle)
        _trace(f'freewater bench done ({extra["freewater_voxps"]:,.0f})')

        Delta, delta = 0.035, 0.015
        from amico_tpu.ops.sphere import fibonacci_hemisphere as fh
        rows_v1 = [np.array([[0, 0, 0, 0, Delta, delta, Delta + delta]])]
        for bb in (3000.0, 6000.0):
            Gv = np.sqrt(bb * 1e6 / (GAMMA ** 2 * delta ** 2 * (Delta - delta / 3)))
            g30 = fh(30)
            rows_v1.append(np.c_[g30, np.full(30, Gv), np.full(30, Delta),
                                 np.full(30, delta), np.full(30, Delta + delta)])
        scheme_v1 = Scheme(np.vstack(rows_v1))
        def czb_oracle(K, model, y_i, lut_i):
            n_rs, n_perp = len(model.Rs), len(model.d_perps)
            A = np.column_stack([K['wmr'][:, lut_i, :].T,
                                 K['wmh'][:, lut_i, :].T, K['iso'].T])
            x = native.lasso(A, y_i, 0.0, 4.0)
            f1 = x[:n_rs].sum()
            f2 = x[n_rs:n_rs + n_perp].sum() + 1e-16
            v = f1 / (f1 + f2 + 1e-16)
            a = 1e6 * 2 * np.sum(model.Rs * x[:n_rs]) / (f1 + 1e-16)
            return np.array([v, a, 4 * v / (np.pi * a ** 2 + 1e-16)])

        extra['activeax_voxps'] = bench_model('czb', CylinderZeppelinBall(),
                                              scheme_v1, oracle=czb_oracle,
                                              oracle_cols=(0, 1))
        _trace(f'activeax bench done ({extra["activeax_voxps"]:,.0f})')

        # SANDI: direction-averaged signal (b0 + 2 shells)
        rows_sa = [np.array([[1, 0, 0, 0, 0, 0, 0]])]
        for bb in (3000.0, 6000.0):
            Gv = np.sqrt(bb * 1e6 / (GAMMA ** 2 * delta ** 2 * (Delta - delta / 3)))
            rows_sa.append(np.array([[1, 0, 0, Gv, Delta, delta, Delta + delta]]))
        scheme_sa = Scheme(np.vstack(rows_sa))
        def sandi_oracle(K, model, y_i, lut_i):
            n_rs, n_in = len(model.Rs), len(model.d_in)
            x = native.lasso(K['signal'], y_i, 0.0, 5e-3) * K['norms']
            xs = x.sum() + 1e-16
            xsph = x[:n_rs].sum()
            xstk = x[n_rs:n_rs + n_in].sum()
            xiso = x[n_rs + n_in:].sum()
            return np.array([
                xsph / xs, xstk / xs, xiso / xs,
                1e6 * np.sum(model.Rs * x[:n_rs]) / (xsph + 1e-16),
                1e3 * np.sum(model.d_in * x[n_rs:n_rs + n_in])
                / (xstk + 1e-16),
                1e3 * np.sum(model.d_isos * x[n_rs + n_in:])
                / (xiso + 1e-16)])

        extra['sandi_voxps'] = bench_model('sandi', SANDI(), scheme_sa,
                                           oracle=sandi_oracle,
                                           oracle_cols=(0, 1, 2, 3))
        _trace(f'sandi bench done ({extra["sandi_voxps"]:,.0f})')

    emit(extra)


def bench_pipeline(n_vox, y, scheme_tab, trace, reps=2):
    """The reference's de-facto workload end-to-end (core.py:107-648):
    NIfTI load -> preprocessing -> DTI directions -> NODDI fit ->
    NIfTI map save, through the production ``Evaluation`` facade.

    The synthetic study (DWI volume + mask + scheme on disk) is built
    once and reused across rounds; its synthesis/write time is not a
    user-workload stage and is excluded.  ``pipeline_voxps`` counts
    every stage a user pays per subject with a warm kernel LUT:
    load_data + load_kernels + fit (incl. direction estimation) +
    save_results.  Kernel *generation* is the reference's one-time
    per-study cache (core.py:357-360, regenerate=False default) and is
    reported separately."""
    from amico_tpu import Evaluation
    from amico_tpu.io import nifti

    study = os.path.join(os.environ['AMICO_TPU_HOME'], 'bench_study')
    os.makedirs(study, exist_ok=True)
    nS = y.shape[1]
    nx = ny = 64
    nz = -(-n_vox // (nx * ny))
    dwi_path = os.path.join(study, 'DWI.nii')
    mask_path = os.path.join(study, 'mask.nii')
    scheme_path = os.path.join(study, 'DWI.scheme')
    marker = os.path.join(study, f'.shape_{nx}x{ny}x{nz}x{nS}_{n_vox}')
    # the marker must be the ONLY shape marker: a BENCH_SMALL run shares
    # this directory and overwrites DWI.nii with its small volume while
    # the full-size marker file survives -- matching on marker existence
    # alone then feeds the small volume to the full-size bench and
    # inflates pipeline_voxps ~50x (caught in round 5)
    import glob as _glob
    stale = [m for m in _glob.glob(
                 os.path.join(_glob.escape(study), '.shape_*'))
             if m != marker]
    if stale or not (os.path.isfile(marker) and os.path.isfile(dwi_path)):
        for m in stale:
            os.remove(m)
        vol = np.zeros((nx * ny * nz, nS), np.float32)
        vol[:n_vox] = y
        nifti.save(nifti.Nifti1Image(vol.reshape(nx, ny, nz, nS),
                                     np.eye(4)), dwi_path)
        mask = np.zeros(nx * ny * nz, np.uint8)
        mask[:n_vox] = 1
        nifti.save(nifti.Nifti1Image(mask.reshape(nx, ny, nz),
                                     np.eye(4)), mask_path)
        with open(scheme_path, 'w') as f:
            f.write('VERSION: BVECTOR\n')
            np.savetxt(f, scheme_tab, fmt='%.9f')
        open(marker, 'w').close()
        trace('pipeline study written')

    ev = Evaluation(study, '.')
    t0 = time.time()
    ev.load_data(dwi_path, scheme_path, mask_filename=mask_path)
    t_load = time.time() - t0
    ev.set_model('NODDI')
    t0 = time.time()
    ev.generate_kernels()          # no-op when the study LUT is warm
    t_gen = time.time() - t0
    t0 = time.time()
    ev.load_kernels()
    t_resample = time.time() - t0
    trace(f'pipeline load/kernels done (load {t_load:.2f}s, '
          f'gen {t_gen:.2f}s, resample {t_resample:.2f}s)')
    # first fit pays this plan's chunk-shape compiles (or their load from
    # the persistent cache); the steady-state rep is the per-subject cost
    # in a sweep and includes re-estimating DTI directions
    t0 = time.time()
    ev.fit()
    t_fit_first = time.time() - t0
    # warm-refit steady state: same loaded subject, all per-subject caches
    # hot (multi-model runs / parameter sweeps on one subject)
    t_fit_warm = float('inf')
    for _ in range(reps):
        t0 = time.time()
        ev.fit()
        t_fit_warm = min(t_fit_warm, time.time() - t0)
    # per-SUBJECT steady state (the honest sweep cost): a new subject pays
    # voxel extraction, the H2D signal upload, and direction estimation
    # again -- drop the per-subject caches before each rep so the measured
    # fit includes them (round-4 review: the steady rep must not hide the
    # dirs stage behind a warm cache)
    t_fit = float('inf')
    facade = {}
    for _ in range(reps):
        ev._fit_y_cache = None
        ev._fit_dirs_cache = None
        if hasattr(ev.model, '_stage_cache'):
            ev.model._stage_cache = None
        t0 = time.time()
        ev.fit()
        dt = time.time() - t0
        if dt < t_fit:
            t_fit = dt
            facade = {k: round(v, 4) for k, v in
                      getattr(ev, '_last_fit_facade_timers', {}).items()}
    t0 = time.time()
    ev.save_results()
    t_save = time.time() - t0
    out_dir = os.path.join(study, 'AMICO', 'NODDI')
    maps = [f for f in os.listdir(out_dir) if f.endswith('.nii.gz')]
    assert maps, 'pipeline bench produced no maps'
    for f in maps:
        img = nifti.load(os.path.join(out_dir, f))
        assert np.isfinite(np.asarray(img._data)).all(), f
    # full per-stage attribution of the steady-state fit: facade phases (from the best per-subject
    # rep, so the dirs stage is included) + the engine's own breakdown
    engine = {k: round(v, 4) if isinstance(v, float) else v
              for k, v in getattr(ev.model, '_last_fit_timers', {}).items()}
    t_total = t_load + t_resample + t_fit + t_save
    t_total_warm = t_load + t_resample + t_fit_warm + t_save
    return {
        'pipeline_voxps': round(n_vox / t_total, 1),
        'pipeline_voxps_warmrefit': round(n_vox / t_total_warm, 1),
        'pipeline_total_seconds': round(t_total, 2),
        'pipeline_load_seconds': round(t_load, 2),
        'pipeline_kernel_gen_seconds': round(t_gen, 2),
        'pipeline_resample_seconds': round(t_resample, 2),
        'pipeline_fit_first_seconds': round(t_fit_first, 2),
        'pipeline_fit_seconds': round(t_fit, 2),
        'pipeline_fit_warmrefit_seconds': round(t_fit_warm, 2),
        'pipeline_dirs_seconds': round(
            float(ev.get_config('dirs_precomputing_time') or 0), 2),
        'pipeline_save_seconds': round(t_save, 2),
        'pipeline_fit_breakdown': facade,
        'pipeline_fit_engine': engine,
        'pipeline_maps': len(maps),
    }


if __name__ == '__main__':
    main()

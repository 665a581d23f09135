#!/usr/bin/env python
"""Smoke test of the main path on a GPU, through the entry points users call.

    python chip_smoke.py [--seed N]     # phases a-d, one GPU
    python chip_smoke.py --four         # phase e only, four GPUs

Phases:

a. device: JAX's first device must be a GPU (no CPU fallback); prints the
   card's name and power limit as nvidia-smi reports them;
b. main path: a synthetic 64x64x100 study (409,600 masked voxels, 9 b0 +
   30 directions at b=700 + 60 at b=2000) made from ``--seed`` through
   ``Evaluation`` -> ``load_data`` -> ``set_model('NODDI')`` ->
   ``generate_kernels(ndirs=500)`` -> ``load_kernels`` -> ``fit`` (twice:
   cold, warm) -> ``save_results`` with the full 145-atom dictionary; the
   saved NDI/ODI/FWF maps are re-loaded and checked;
c. correctness: 1,000 seeded voxels against the exact per-voxel oracle
   (``testing.noddi_oracle_voxel``, f64 LARS/active set on the host) under
   the PARITY.md bounds, and ``principal_eigenvector`` on the card against
   ``numpy.linalg.eigh`` in f64 (same LUT bucket for >= 99.9% of voxels);
d. the other five models, each through ``Evaluation`` on its own scheme
   type at 20,480 voxels;
e. (``--four`` only) the phase-b subject fitted on a 4-device mesh: every
   chunk argument tile-sharded over all four devices, the maps within the
   oracle bounds, timed against one device; one device running the mesh's
   per-device chunk shape reproduces the mesh maps (within 1e-6 on
   >= 99.9% of voxels).

Any failed check exits non-zero before the last line.  The last line of
stdout is ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

NODDI_VOLUME = (64, 64, 100)          # 409,600 voxels, all in the mask
OTHER_VOLUME = (32, 32, 20)           # 20,480 voxels per other model
N_AUDIT = 1000
# oracle map-error bounds (PARITY.md, "error tail")
ORACLE_MED = 1e-4
ORACLE_P95 = 5e-3
ORACLE_MAX = {'NDI': 4.5e-2, 'ODI': 4.5e-2, 'FWF': 2.5e-2}
LUT_AGREEMENT = 0.999
MESH_TOL = 1e-6
MESH_AGREEMENT = 0.999


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f'check failed: {msg}')


# ------------------------------------------------------------------ a. device
def phase_device(min_count: int) -> dict:
    """The GPU JAX will run on; exits non-zero (no CPU fallback) without."""
    import jax
    devs = jax.devices()
    if devs[0].platform != 'gpu':
        print(f'chip_smoke: JAX found no GPU (first device: {devs[0]}); '
              'this smoke test runs on the card only', file=sys.stderr)
        raise SystemExit(2)
    check(len(devs) >= min_count,
          f'need {min_count} GPUs, JAX sees {len(devs)}')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        say(f'[a] nvidia-smi: {line.strip()}')
    dev = {'platform': devs[0].platform, 'kind': devs[0].device_kind,
           'count': len(devs)}
    say(f'[a] jax devices: {len(devs)} x {devs[0].device_kind}')
    return dev


# ----------------------------------------------------------- synthetic data
def noddi_scheme_table() -> np.ndarray:
    """9 b0 + 30 directions at b=700 + 60 at b=2000 (BVECTOR rows)."""
    from amico_tpu.ops.sphere import fibonacci_hemisphere
    return np.vstack([np.zeros((9, 4)),
                      np.c_[fibonacci_hemisphere(30), np.full(30, 700.0)],
                      np.c_[fibonacci_hemisphere(60), np.full(60, 2000.0)]])


def v1_scheme_table(n_b0: int, ndir: int) -> np.ndarray:
    """STEJSKALTANNER rows: b0s + b=3000 and b=6000 shells at
    Delta/delta = 35/15 ms (the ActiveAx and SANDI protocol)."""
    from amico_tpu.io.scheme import GAMMA
    from amico_tpu.ops.sphere import fibonacci_hemisphere
    Delta, delta = 0.035, 0.015
    rows = [np.tile([0, 0, 0, 0, Delta, delta, Delta + delta], (n_b0, 1))]
    for b in (3000.0, 6000.0):
        G = np.sqrt(b * 1e6 / (GAMMA ** 2 * delta ** 2 * (Delta - delta / 3)))
        rows.append(np.c_[fibonacci_hemisphere(ndir), np.full(ndir, G),
                          np.full(ndir, Delta), np.full(ndir, delta),
                          np.full(ndir, Delta + delta)])
    return np.vstack(rows)


def write_subject(subj_dir: str, vol: np.ndarray, table: np.ndarray,
                  version: str) -> None:
    """DWI.nii + mask.nii (every voxel) + DWI.scheme."""
    from amico_tpu.io import nifti
    os.makedirs(subj_dir, exist_ok=True)
    nifti.save(nifti.Nifti1Image(vol.astype(np.float32), np.eye(4)),
               os.path.join(subj_dir, 'DWI.nii'))
    nifti.save(nifti.Nifti1Image(np.ones(vol.shape[:3], np.uint8), np.eye(4)),
               os.path.join(subj_dir, 'mask.nii'))
    with open(os.path.join(subj_dir, 'DWI.scheme'), 'w') as f:
        f.write(f'VERSION: {version}\n')
        np.savetxt(f, table, fmt='%.9f')


def noddi_subject(workdir: str, seed: int, volume=NODDI_VOLUME,
                  small_grid: bool = False) -> str:
    """Write the NODDI study: ``testing.demo_voxels`` mixtures over the
    model's own dictionary (full 145 atoms unless ``small_grid``)."""
    from amico_tpu.io.scheme import Scheme
    from amico_tpu.testing import demo_noddi, demo_voxels
    table = noddi_scheme_table()
    _, kernels, htable = demo_noddi(Scheme(table), small=small_grid,
                                    kernels_dir=os.path.join(workdir,
                                                             'synth_kernels'))
    n = int(np.prod(volume))
    y, _, _ = demo_voxels(n, kernels, htable, seed=seed)
    subj = os.path.join(workdir, 'study', 'subj')
    write_subject(subj, y.reshape(volume + (table.shape[0],)), table,
                  'BVECTOR')
    return os.path.join(workdir, 'study')


def tensor_signals(table: np.ndarray, version: str, n: int,
                   rng) -> np.ndarray:
    """Two-compartment signals (anisotropic tensor + free water) over any
    scheme: b0-normalized, random fibre directions and fractions."""
    from amico_tpu.io.scheme import Scheme
    sch = Scheme(table)
    b = sch.b * 1e-6 if version == '1' else sch.b       # s/mm^2
    g = table[:, :3] / np.maximum(
        np.linalg.norm(table[:, :3], axis=1, keepdims=True), 1e-12)
    u = rng.randn(n, 3)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    f_iso = 0.05 + 0.4 * rng.rand(n, 1)
    d_par = 1.5e-3 + 0.6e-3 * rng.rand(n, 1)
    d_perp = 0.2e-3 + 0.5e-3 * rng.rand(n, 1)
    cos2 = (u @ g.T) ** 2
    s_wm = np.exp(-b[None] * (d_perp + (d_par - d_perp) * cos2))
    s = f_iso * np.exp(-b[None] * 3.0e-3) + (1.0 - f_iso) * s_wm
    return np.clip(s + 0.005 * rng.randn(*s.shape), 0.0, None)


# -------------------------------------------------------------- b. main path
def run_noddi_pipeline(study: str, small_grid: bool = False):
    """Evaluation -> load_data -> NODDI -> kernels; returns the facade."""
    import amico_tpu
    ev = amico_tpu.Evaluation(study, 'subj')
    ev.load_data('DWI.nii', 'DWI.scheme', mask_filename='mask.nii')
    ev.set_model('NODDI')
    if small_grid:
        ev.model.set(IC_VFs=np.linspace(0.3, 0.99, 4),
                     IC_ODs=np.array([0.06, 0.3, 0.8]))
    ev.generate_kernels(ndirs=500)
    ev.load_kernels()
    return ev


def timed_fit(ev) -> float:
    t0 = time.time()
    ev.fit()
    return time.time() - t0


def fitted_maps(ev) -> np.ndarray:
    """(N, n_maps) maps of the masked voxels, in the facade's voxel order."""
    return np.asarray(ev.RESULTS['MAPs'][ev.niiMASK_img == 1], np.float64)


def phase_main_path(workdir: str, seed: int, volume=NODDI_VOLUME,
                    small_grid: bool = False):
    from amico_tpu.io import nifti
    study = noddi_subject(workdir, seed, volume, small_grid)
    ev = run_noddi_pipeline(study, small_grid)
    n = int(np.count_nonzero(ev.niiMASK_img == 1))
    n_atoms = ev.KERNELS['wm'].shape[0] + 1
    say(f'[b] NODDI: {n} voxels, {n_atoms} atoms, nS={ev.scheme.nS}')
    t_cold = timed_fit(ev)
    t_warm = timed_fit(ev)
    say(f'[b] fit cold {t_cold:.3f} s ({n / t_cold:,.0f} voxels/s), '
        f'warm {t_warm:.3f} s ({n / t_warm:,.0f} voxels/s)')
    say(f'[b] engine timers: {json.dumps(_rounded(ev.model._last_fit_timers))}')
    say(f'[b] facade timers: {json.dumps(_rounded(ev._last_fit_facade_timers))}')
    t0 = time.time()
    ev.save_results()
    say(f'[b] save_results {time.time() - t0:.3f} s')
    out = os.path.join(study, 'subj', ev.RESULTS['RESULTS_path'])
    inside = ev.niiMASK_img == 1
    for name in ('NDI', 'ODI', 'FWF'):
        m = nifti.load(os.path.join(out, f'fit_{name}.nii.gz')).get_fdata()
        vals = m[inside]
        check(np.isfinite(vals).all(), f'{name} map has non-finite values')
        check(vals.min() >= 0.0 and vals.max() <= 1.0,
              f'{name} map outside [0, 1]: [{vals.min()}, {vals.max()}]')
        say(f'[b] fit_{name}: finite, in [0, 1], mean {vals.mean():.4f}')
    return ev, {'t_cold': t_cold, 't_warm': t_warm, 'n_voxels': n}


def _rounded(d: dict) -> dict:
    return {k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in d.items()}


# ------------------------------------------------------------ c. correctness
def oracle_errors(ev, idx: np.ndarray) -> np.ndarray:
    """|device maps - exact oracle maps| for voxels ``idx``: (len, 3)."""
    from amico_tpu import lut as _lut
    from amico_tpu.testing import noddi_oracle_voxel
    y = np.asarray(ev.y, np.float64)
    dirs = np.asarray(ev.DIRs, np.float64)
    lut_idx = _lut.dir_to_lut_idx(dirs[idx], ev.htable)
    ref = np.stack([noddi_oracle_voxel(ev.KERNELS, ev.scheme.dwi_idx, y[i],
                                       int(li))
                    for i, li in zip(idx, lut_idx)])
    return np.abs(fitted_maps(ev)[idx, :3] - ref)


def eigvec_lut_agreement(ev) -> float:
    """Share of voxels whose ``principal_eigenvector`` on the device lands
    in the same LUT bucket as ``numpy.linalg.eigh`` in f64, on f64 OLS
    tensors of the fitted signals."""
    import jax
    import jax.numpy as jnp
    from amico_tpu import lut as _lut
    from amico_tpu.ops.dti import (MIN_SIGNAL, design_matrix,
                                   principal_eigenvector)
    sch = ev.scheme
    B = design_matrix(sch.b, sch.raw[:, :3])
    logy = np.log(np.maximum(np.asarray(ev.y, np.float64), MIN_SIGNAL))
    params = logy @ np.linalg.pinv(B).T         # Dxx Dyy Dzz Dxy Dxz Dyz
    D = params[:, [[0, 3, 4], [3, 1, 5], [4, 5, 2]]]
    v_ref = np.linalg.eigh(D)[1][..., -1]
    v_dev = np.asarray(jax.jit(principal_eigenvector)(
        jnp.asarray(D, jnp.float32)), np.float64)
    same = (_lut.dir_to_lut_idx(v_ref, ev.htable)
            == _lut.dir_to_lut_idx(v_dev, ev.htable))
    return float(same.mean())


def check_oracle(ev, seed: int, tag: str, n_audit: int = N_AUDIT) -> dict:
    """Audit the facade's current maps on ``n_audit`` seeded voxels against
    the exact oracle under the PARITY.md bounds."""
    from amico_tpu.ops import native
    n = fitted_maps(ev).shape[0]
    idx = np.sort(np.random.RandomState(seed).choice(
        n, min(n_audit, n), replace=False))
    try:
        native._load()
        solver = 'native C++'
    except RuntimeError as e:
        solver = f'NumPy fallback ({e})'
    t0 = time.time()
    err = oracle_errors(ev, idx)
    med, p95 = float(np.median(err)), float(np.percentile(err, 95))
    mx = {name: float(err[:, k].max()) for k, name in enumerate(ORACLE_MAX)}
    say(f'[{tag}] oracle audit ({len(idx)} voxels, {solver}, '
        f'{time.time() - t0:.1f} s): median {med:.3e}, p95 {p95:.3e}, '
        + ', '.join(f'max {k} {v:.3e}' for k, v in mx.items()))
    check(med <= ORACLE_MED, f'oracle median {med} > {ORACLE_MED}')
    check(p95 <= ORACLE_P95, f'oracle p95 {p95} > {ORACLE_P95}')
    for k, v in mx.items():
        check(v <= ORACLE_MAX[k], f'oracle max {k} {v} > {ORACLE_MAX[k]}')
    return {'med': med, 'p95': p95, 'max': mx}


def phase_correctness(ev, seed: int, n_audit: int = N_AUDIT) -> dict:
    out = check_oracle(ev, seed, 'c', n_audit)
    n = fitted_maps(ev).shape[0]
    agree = eigvec_lut_agreement(ev)
    say(f'[c] principal_eigenvector vs eigh(f64): same LUT index for '
        f'{agree:.5f} of {n} voxels')
    check(agree >= LUT_AGREEMENT,
          f'LUT agreement {agree} < {LUT_AGREEMENT}')
    return dict(out, lut_agreement=agree)


# ---------------------------------------------------------- d. other models
OTHER_MODELS = (
    # (model, scheme version, fits: the reference implements no fit for
    #  StickZeppelinBall and VolumeFractions)
    ('FreeWater', 'BVECTOR', True),
    ('StickZeppelinBall', 'BVECTOR', False),
    ('VolumeFractions', 'BVECTOR', False),
    ('CylinderZeppelinBall', '1', True),
    ('SANDI', '1', True),
)


def phase_other_models(workdir: str, seed: int, volume=OTHER_VOLUME) -> dict:
    import amico_tpu
    rng = np.random.RandomState(seed)
    n = int(np.prod(volume))
    out = {}
    for name, version, fits in OTHER_MODELS:
        table = (noddi_scheme_table() if version == 'BVECTOR'
                 else v1_scheme_table(2 if name == 'SANDI' else 1, 30))
        y = tensor_signals(table, version, n, rng)
        study = os.path.join(workdir, f'study_{name}')
        write_subject(os.path.join(study, 'subj'),
                      y.reshape(volume + (table.shape[0],)), table, version)
        ev = amico_tpu.Evaluation(study, 'subj')
        if name == 'SANDI':
            ev.set_config('doDirectionalAverage', True)
        ev.load_data('DWI.nii', 'DWI.scheme', mask_filename='mask.nii')
        if not fits:
            say(f'[d] {name}: {kernel_only_model(ev, name)}')
            continue
        ev.set_model(name)
        ev.generate_kernels(ndirs=500)
        ev.load_kernels()
        t_cold = timed_fit(ev)
        t_warm = timed_fit(ev)
        maps = fitted_maps(ev)
        check(np.isfinite(maps).all(), f'{name} maps not finite')
        say(f'[d] {name}: {n} voxels, {len(ev.model.maps_name)} maps '
            f'finite; fit cold {t_cold:.3f} s, warm {t_warm:.3f} s '
            f'({n / t_warm:,.0f} voxels/s)')
        out[name] = {'t_cold': t_cold, 't_warm': t_warm, 'n_voxels': n}
    return out


def kernel_only_model(ev, name: str) -> str:
    """Drive a model the reference implements no fit for (its set_solver or
    fit raises 'Not implemented') as far as it goes; returns what it did."""
    from amico_tpu.utils.logging import AmicoError
    step = 'set_model'
    try:
        ev.set_model(name)
        step = 'kernels'
        ev.generate_kernels(ndirs=500)
        ev.load_kernels()
        for key, k in ev.KERNELS.items():
            if isinstance(k, np.ndarray):
                check(np.isfinite(k).all(), f'{name} kernel {key} not finite')
        step = 'fit'
        ev.fit()
    except AmicoError as e:
        check('Not implemented' in str(e), f'{name} {step}: {e}')
        done = 'kernels finite; ' if step == 'fit' else ''
        return f'{done}{step}() raises "Not implemented" as in the reference'
    raise RuntimeError(f'{name} was expected to raise "Not implemented"')


# ------------------------------------------------------------- e. four cards
def compare_maps(a: np.ndarray, b: np.ndarray, tol: float = MESH_TOL):
    """(max |a-b|, share of voxels whose every map is within ``tol``)."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    d = d.reshape(d.shape[0], -1).max(axis=1)
    return float(d.max()), float((d <= tol).mean())


def check_mesh_shardings(model, mesh) -> None:
    """Every chunk argument of the last fit carried the tile sharding, on
    every device of the mesh (the production dispatch's own record)."""
    from amico_tpu.parallel.mesh import tile_sharding
    rec = model._last_fit_shardings
    check(rec is not None, 'the fit recorded no shardings')
    want = tile_sharding(mesh)
    for i, sh in enumerate(rec['args']):
        check(sh.is_equivalent_to(want, 3),
              f'chunk argument {i} lost its tile sharding: {sh}')
        check(len(sh.device_set) == mesh.devices.size,
              f'chunk argument {i} spans {len(sh.device_set)} devices')
    for k, sh in rec['out'].items():
        spec = getattr(sh, 'spec', None)
        check(spec is not None and spec[0] == 'data',
              f'output {k!r} not voxel-sharded: {sh}')


def phase_four(workdir: str, seed: int, n_devices: int = 4,
               volume=NODDI_VOLUME, small_grid: bool = False,
               n_audit: int = N_AUDIT) -> dict:
    """The phase-b subject on an ``n_devices`` mesh (the user's config),
    audited against the oracle and timed against one device; then one
    device running the mesh's per-device chunk shape on the same streamed
    path, which must reproduce the mesh maps.  (With different chunk
    shapes XLA may pick other reduction orders, and the f32 solve
    amplifies those rounding differences -- PARITY.md, error tail.)"""
    from amico_tpu.parallel.mesh import make_mesh
    study = noddi_subject(workdir, seed, volume, small_grid)
    ev = run_noddi_pipeline(study, small_grid)
    n = int(np.count_nonzero(ev.niiMASK_img == 1))
    mesh = make_mesh(n_devices)
    ev.set_config('mesh', mesh)
    t_mesh_cold = timed_fit(ev)
    t_mesh = timed_fit(ev)
    check_mesh_shardings(ev.model, mesh)
    maps_mesh = fitted_maps(ev)
    timers = dict(ev.model._last_fit_timers)
    if n_audit:
        check_oracle(ev, seed, 'e', n_audit)
    ev.set_config('mesh', None)
    t_one_cold = timed_fit(ev)
    t_one = timed_fit(ev)
    d_max, d_within = compare_maps(maps_mesh, fitted_maps(ev))
    say(f'[e] fit warm: {n_devices}-device mesh {t_mesh:.3f} s '
        f'({n / t_mesh:,.0f} voxels/s), one device {t_one:.3f} s '
        f'({n / t_one:,.0f} voxels/s), scaling {t_one / t_mesh:.2f}x; '
        f'cold: mesh {t_mesh_cold:.3f} s, one device {t_one_cold:.3f} s')
    say(f'[e] mesh vs one device, default configs ({n} voxels): max map '
        f'difference {d_max:.3e}, {d_within:.5f} of voxels within '
        f'{MESH_TOL:g}')
    # one device, the mesh's per-device chunk shape, host-tiled streaming
    # (a 1-byte staging budget turns the device-side gather off, as the
    # mesh path does)
    ev.set_config('voxels_per_chunk',
                  timers['chunk_tiles'] // n_devices * timers['tile_size'])
    ev.set_config('max_device_bytes', 1)
    timed_fit(ev)
    max_diff, within = compare_maps(maps_mesh, fitted_maps(ev))
    say(f'[e] mesh vs one device at the per-device chunk shape: max map '
        f'difference {max_diff:.3e}, {within:.5f} of voxels within '
        f'{MESH_TOL:g}')
    check(within >= MESH_AGREEMENT,
          f'only {within} of voxels agree within {MESH_TOL}')
    return {'max_diff': max_diff, 'within': within,
            'default_max_diff': d_max, 'default_within': d_within,
            'scaling': t_one / t_mesh}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--four', action='store_true',
                   help='run only the four-device mesh comparison (e)')
    args = p.parse_args(argv)

    dev = phase_device(4 if args.four else 1)
    import amico_tpu
    amico_tpu.set_verbose(1)
    workdir = tempfile.mkdtemp(prefix='amico_smoke_')
    os.environ['AMICO_TPU_HOME'] = os.path.join(workdir, 'home')
    try:
        t0 = time.time()
        if args.four:
            phase_four(workdir, args.seed)
            dev['count'] = 4
        else:
            ev, _ = phase_main_path(workdir, args.seed)
            phase_correctness(ev, args.seed)
            del ev
            phase_other_models(workdir, args.seed)
        say(f'all phases passed in {time.time() - t0:.1f} s')
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({'ok': True, 'device': dev}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

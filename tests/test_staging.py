"""Staging-strategy equivalence: the tiled fit driver has three input
paths (device-side gather from a staged flat signal, cached host-tiled
chunks, and uncached streaming beyond the device budget -- see
``BaseModel._run_tiled_fit``).  All three must produce identical maps;
only the transfer strategy may differ (reference analog: one code path,
thread chunking at models.pyx:204-211).
"""
import os

import numpy as np

from amico_tpu.testing import demo_noddi, demo_voxels


class _Ctx:
    def __init__(self, y, dirs, htable, kernels, **cfg):
        self.y, self.DIRs, self.htable, self.KERNELS = y, dirs, htable, kernels
        self._cfg = dict({'tile_size': 32, 'voxels_per_chunk': 1024}, **cfg)

    def get_config(self, k):
        return self._cfg.get(k)


def test_gather_stream_and_cached_paths_agree(tmp_path):
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    model, kernels, htable = demo_noddi(kernels_dir=str(tmp_path / 'k'))
    y, DIRs, _ = demo_voxels(300, kernels, htable, seed=7)

    def fresh():
        m = type(model)()
        m.set(IC_VFs=model.IC_VFs, IC_ODs=model.IC_ODs)
        m.set_solver()
        m.scheme = model.scheme
        return m

    # default: single device under budget -> device-side gather
    est_gather = fresh().fit(_Ctx(y, DIRs, htable, kernels))['estimates']

    # 1-byte budget: forces host tiling AND uncached streaming dispatch
    est_stream = fresh().fit(
        _Ctx(y, DIRs, htable, kernels, max_device_bytes=1))['estimates']

    np.testing.assert_array_equal(est_gather, est_stream)
    assert np.abs(est_gather).sum() > 0


def test_budget_flip_between_fits_invalidates_mode_cache(tmp_path):
    """Lowering max_device_bytes between fits on one model instance flips
    the staging mode (gather -> host-tiled streaming); the chunk cache is
    mode-specific and must not hand gather-format indices to the
    host-tiled dispatch."""
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    model, kernels, htable = demo_noddi(kernels_dir=str(tmp_path / 'k'))
    y, DIRs, _ = demo_voxels(200, kernels, htable, seed=5)

    ctx = _Ctx(y, DIRs, htable, kernels)
    est_gather = model.fit(ctx)['estimates']
    ctx._cfg['max_device_bytes'] = 1            # same y object, new mode
    est_stream = model.fit(ctx)['estimates']
    np.testing.assert_array_equal(est_gather, est_stream)


def test_gather_warm_refit_reuses_staged_signal(tmp_path):
    """Second fit on the same y object must hit the staged flat signal
    (the ``__y_ext__`` cache entry) and return identical maps."""
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    model, kernels, htable = demo_noddi(kernels_dir=str(tmp_path / 'k'))
    y, DIRs, _ = demo_voxels(200, kernels, htable, seed=3)

    ctx = _Ctx(y, DIRs, htable, kernels)
    est_cold = model.fit(ctx)['estimates']
    staged = getattr(model, '_stage_cache', None)
    assert staged is not None and '__y_ext__' in staged[1]
    y_ext_id = id(staged[1]['__y_ext__'])
    est_warm = model.fit(ctx)['estimates']
    assert id(model._stage_cache[1]['__y_ext__']) == y_ext_id
    np.testing.assert_array_equal(est_cold, est_warm)


def test_non_power_of_two_tile_width_bit_stable(tmp_path):
    """``tile_size`` is a free config value; the tile plan, padding, and
    solve must be bit-stable across power-of-two and non-power-of-two
    widths (per-lane math is lane-count independent)."""
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    model, kernels, htable = demo_noddi(kernels_dir=str(tmp_path / 'k'))
    y, DIRs, _ = demo_voxels(300, kernels, htable, seed=9)

    def fit_at(ts):
        m = type(model)()
        m.set(IC_VFs=model.IC_VFs, IC_ODs=model.IC_ODs)
        m.set_solver()
        m.scheme = model.scheme
        return m.fit(_Ctx(y, DIRs, htable, kernels,
                          tile_size=ts))['estimates']

    base = fit_at(32)
    for ts in (24, 48):          # non-power-of-two widths
        np.testing.assert_array_equal(base, fit_at(ts))

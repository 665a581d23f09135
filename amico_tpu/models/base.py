"""Model base class and shared fit plumbing.

Mirrors the reference ``BaseModel`` contract
(/root/reference/amico/models.pyx:75-217): ``set / get_params / set_solver /
generate / resample / fit`` with identical signatures, so reference users
can port scripts unchanged.  The chunking-for-threads logic
(models.pyx:204-211) is replaced by the direction-bucketed tile plan of
:mod:`amico_tpu.models.engine`.
"""
from __future__ import annotations

import os
from abc import ABC, abstractmethod
from os.path import join as pjoin

import numpy as np

from .. import lut as _lut
from ..utils.logging import ERROR
from .engine import (build_tile_plan, iter_tile_chunks, tile_voxels,
                     untile_voxels)

# default solver iteration counts (validated against the exact native oracle
# in tests/test_solvers.py and tests/test_models.py): FISTA + CD warm start
# followed by batched active-set polish rounds
DEFAULT_FISTA_ITERS = 40
DEFAULT_CD_SWEEPS = 4
DEFAULT_REFINE_ROUNDS = 12
DEFAULT_CG_ITERS = 12
# NODDI per-stage schedule ((fista, rounds, cg, inner) x2, (rounds, cg,
# inner) for the warm-started debias): pure Lawson-Hanson from the empty
# working set.  On the full 145-atom dictionary the old FISTA-seeded
# schedule landed on wrong stage-2 supports (median map error 7e-2 vs the
# exact oracle); pure active-set rounds reach the oracle vertex
# (tests/test_models_fullgrid.py).  The ``cg`` entries are per-round CG
# budgets (tuples unroll the rounds): round r's working set holds at most
# r atoms, so early rounds need only a few CG steps.  Budgets use few
# distinct levels on purpose: equal-budget runs stay rolled in fori_loops
# (ops/solvers.nneg_qp_batch), keeping the program and its compile small.
# Trailing entries: ``converge`` (stability continuation after the
# schedule) and ``add_k`` -- top-2 atom adds per round let stage 1 do in
# 4 rounds and stage 2 in 6 what took 8/10 single-add rounds, and they
# improved the map-error tail (stage-2 vertices one kappa-grid atom off
# the oracle's).  Stage 3 stays single-add/6 rounds: the debias prune
# cascade is the accuracy-critical work.  Per-round ``inner`` tuples are
# accepted; the solver takes their maximum (one inner count per solve).
# The oracle map-error bounds this schedule is held to are in PARITY.md
# (med <= 1e-4, p95 <= 5e-3, per-map max NDI/ODI 4.5e-2, FWF 2.5e-2);
# chip_smoke.py audits them on the device.
DEFAULT_NODDI_STAGE_ITERS = ((0, 4, (4, 6, 8, 10), 1, False, 2),
                             (0, 6, (3, 5, 8, 10, 12, 14),
                              (1, 1, 2, 2, 2, 2), False, 2),
                             (6, (16, 10, 8, 8, 8, 8), 2))
# stage-2 degenerate-vertex objective tie-break (round 5): CG budget per
# swapped-support candidate (2 candidates: the dominant WM atom moved one
# kappa-grid cell either way).  MEASURED NEGATIVE RESULT: ~5% solver cost
# and the audited tail is unchanged -- the tail's supports differ by
# multiple atoms / true ties, which a single-swap objective comparison
# cannot decide (PARITY.md 'error tail', round-5 study).  The knob stays
# for experimentation (set_solver(tiebreak=True) enables; this value is
# the CG budget it uses).
DEFAULT_NODDI_TIEBREAK_CG = 8
# single-solve models (FreeWater / CylinderZeppelinBall / SANDI): same
# pure-Lawson-Hanson-from-empty recipe -- their dictionaries are small
# (11-26 atoms) and supports usually sparse, so 12 progressive rounds
# reach the oracle vertex with a fraction of the FISTA-warm-start
# default's matvecs.  `converge` keeps adding rounds past the schedule
# until every working set is stable: each round grows the support by at
# most one atom, so without it any voxel whose optimal support exceeds
# the round count would be silently truncated (CylinderZeppelinBall's
# lambda2=4 ridge spreads weight over all 21 correlated cylinder atoms
# -- verified 0.59 max-abs coefficient error vs the exact native oracle
# at a hard 12-round cap).  Stable tiles pay nothing (while_loop exits
# on entry).  Top-2 adds (add_k=2), a win for NODDI's 144-atom stage 2,
# do not help here: on these small correlated dictionaries the second
# add usually overshoots, and the add->prune churn keeps working sets
# unstable into the converge continuation.
DEFAULT_AS_SOLVER_KW = {
    'fista_iters': 0,
    'cd_sweeps': 0,
    'refine_rounds': 12,
    'cg_iters': (6, 6, 6, 10, 10, 10, 12, 12, 12, 12, 12, 12),
    'converge': True,
}
# dense-support single-solve default (CylinderZeppelinBall's lambda2=4):
# the big ridge both spreads the optimal support over all 21 correlated
# cylinder atoms AND makes the QP well-conditioned (cond ~ (L+4)/4), so
# FISTA+CD reaches the full support in tens of cheap batched matvecs while
# from-empty Lawson-Hanson would pay one masked-CG round per atom.  The
# few refine rounds polish to the exact vertex; `converge` still
# guarantees stability on adversarial voxels, at the same oracle error as
# the from-empty default (p95 diameter error 5.6e-6 um).
DENSE_AS_SOLVER_KW = {
    'fista_iters': 80,
    'cd_sweeps': 8,
    'refine_rounds': 6,
    'cg_iters': 16,
    'converge': True,
}
# default ``max_device_bytes``: the share of the device's own memory limit
# (``memory_stats()['bytes_limit']``) that staged fit inputs may take.
# The rest holds the dictionaries, the per-chunk solver state and XLA's
# workspace.  Devices that report no limit (the CPU backend) get
# HOST_DEVICE_BUDGET.
DEVICE_BUDGET_FRACTION = 0.25
HOST_DEVICE_BUDGET = 4 << 30


def default_device_budget() -> int:
    """Bytes the fit may stage on one device when ``max_device_bytes`` is
    unset (see DEVICE_BUDGET_FRACTION)."""
    import jax
    stats = jax.local_devices()[0].memory_stats() or {}
    limit = stats.get('bytes_limit')
    if not limit:
        return HOST_DEVICE_BUDGET
    return int(limit * DEVICE_BUDGET_FRACTION)


class BaseModel(ABC):
    """Base class for microstructure models (reference models.pyx:75-217)."""

    @abstractmethod
    def __init__(self):
        self.id = 'BaseModel'
        self.name = 'Base Model'
        self.maps_name: list[str] = []
        self.maps_descr: list[str] = []
        self.scheme = None

    @abstractmethod
    def set(self, *args, **kwargs):
        ...

    @abstractmethod
    def get_params(self):
        ...

    def set_solver(self, **kwargs):
        """Initialize solver params; subclasses add model defaults
        (reference models.pyx:124-134)."""
        self.solver_params = {
            'fista_iters': DEFAULT_FISTA_ITERS,
            'cd_sweeps': DEFAULT_CD_SWEEPS,
            'refine_rounds': DEFAULT_REFINE_ROUNDS,
            'cg_iters': DEFAULT_CG_ITERS,
        }

    @abstractmethod
    def generate(self, out_path, aux, idx_in, idx_out, ndirs):
        ...

    @abstractmethod
    def resample(self, in_path, idx_out, Ylm_out, doMergeB0, ndirs):
        ...

    @abstractmethod
    def fit(self, evaluation):
        """Returns the reference result dict: 'estimates' (+'rmse', 'nrmse',
        'y_corrected', 'estimates_mod') (models.pyx:186-203)."""
        ...

    # ------------------------------------------------------------ helpers
    def _save_atom(self, out_path: str, idx: int, lm: np.ndarray) -> None:
        """Kernel LUT file layout of the reference (models.pyx:308)."""
        np.save(pjoin(out_path, f'A_{idx:03d}.npy'), lm)

    def _load_atom(self, in_path: str, idx: int, ndirs: int,
                   isotropic: bool = False) -> np.ndarray:
        lm = np.load(pjoin(in_path, f'A_{idx:03d}.npy'))
        if not isotropic and lm.shape[0] != ndirs:
            ERROR('Outdated LUT. Call "generate_kernels( regenerate=True )" to update the LUT')
        return lm

    def _merge_idx(self, doMergeB0: bool):
        """(nS, merge_idx) handling of the doMergeB0 option
        (reference models.pyx:756-761)."""
        if doMergeB0:
            nS = 1 + self.scheme.dwi_count
            merge_idx = np.hstack((self.scheme.b0_idx[0], self.scheme.dwi_idx))
        else:
            nS = self.scheme.nS
            merge_idx = np.arange(self.scheme.nS)
        return nS, merge_idx

    def _common_configs(self, evaluation) -> dict:
        """Reference models.pyx:213-217."""
        return {
            'compute_rmse': bool(evaluation.get_config('doComputeRMSE')),
            'compute_nrmse': bool(evaluation.get_config('doComputeNRMSE')),
        }

    def _set_solver_common(self, lambda1, lambda2, fista_iters=None,
                           cd_sweeps=None, refine_rounds=None, cg_iters=None):
        """Shared body for the per-model set_solver overrides (the
        signatures stay explicit per model for the reference's
        signature-filtered dispatch, core.py:301-325)."""
        BaseModel.set_solver(self)
        self.solver_params['lambda1'] = lambda1
        self.solver_params['lambda2'] = lambda2
        custom = False
        for key, val in (('fista_iters', fista_iters),
                         ('cd_sweeps', cd_sweeps),
                         ('refine_rounds', refine_rounds),
                         ('cg_iters', cg_iters)):
            if val is not None:
                # cg_iters accepts a per-round tuple (the progressive
                # CG-budget feature of the batched solvers)
                self.solver_params[key] = (
                    tuple(int(x) for x in val)
                    if isinstance(val, (tuple, list)) else int(val))
                custom = True
        self.solver_params['custom_iters'] = custom

    def _solver_kwargs(self) -> dict:
        sp = getattr(self, 'solver_params', {})
        if not sp.get('custom_iters'):
            # validated pure-active-set default (progressive CG budgets);
            # users who set any iteration knob get the uniform behavior
            return dict(DEFAULT_AS_SOLVER_KW)
        return {
            'fista_iters': int(sp.get('fista_iters', DEFAULT_FISTA_ITERS)),
            'cd_sweeps': int(sp.get('cd_sweeps', DEFAULT_CD_SWEEPS)),
            'refine_rounds': int(sp.get('refine_rounds', DEFAULT_REFINE_ROUNDS)),
            'cg_iters': sp.get('cg_iters', DEFAULT_CG_ITERS),
        }

    def _ckpt_fingerprint(self, plan, tile_size: int, y: np.ndarray,
                          y_sum: float | None = None,
                          perm_sum: int | None = None) -> np.ndarray:
        """Mid-fit checkpoint fingerprint: pins everything a resumed
        chunk's values depend on -- the tile plan (voxel bucketing), the
        signal content, and the model/solver parameters.  A crash-rerun
        with a changed lambda or an edited volume must recompute, not
        merge stale chunks.  ``y_sum``/``perm_sum`` accept the strided
        content sums the caller already computed for its staging-cache
        fingerprints (each sum strides a >100MB array -- cache-miss bound,
        ~10ms; recomputing them doubled the per-fit setup cost)."""
        import hashlib
        if perm_sum is None:
            pstride = max(1, plan.perm.size // 65536)
            perm_sum = int(np.sum(plan.perm[::pstride], dtype=np.int64))
        if y_sum is None:
            ystride = max(1, y.size // 65536)
            y_sum = float(np.sum(y.ravel()[::ystride], dtype=np.float64))
        params_repr = repr((sorted(getattr(self, 'solver_params',
                                           {}).items()),
                            sorted(self.get_params().items(),
                                   key=lambda kv: kv[0])))
        params_h = int.from_bytes(
            hashlib.blake2b(params_repr.encode(), digest_size=8).digest(),
            'little', signed=True)
        return np.array([plan.n_tiles, tile_size, perm_sum,
                         params_h, np.float64(y_sum).view(np.int64)],
                        np.int64)

    # ------------------------------------------------- tiled fit driver
    def _run_tiled_fit(self, evaluation, fit_chunk_fn, n_outputs_like: dict,
                       tile_size: int | None = None,
                       voxels_per_chunk: int | None = None,
                       consts: tuple = (), cache_key=None):
        """Drive a jitted per-chunk tile fit over all voxels.

        ``fit_chunk_fn(Y (C,M,nS) f32, dirs (C,) i32, valid (C,M) bool,
        *consts)`` must return a dict of arrays with leading dims (C, M).
        ``consts`` (kernel tensors etc.) are passed as jit *arguments* --
        closing over large device arrays would inline them as program
        constants (host roundtrip + HLO bloat).
        ``n_outputs_like``: {name: trailing_shape_tuple} used to allocate
        the untiled outputs.
        Returns dict of (N, ...) numpy arrays in original voxel order.
        """
        import jax
        import jax.numpy as jnp
        import time as _time
        _t_enter = _time.time()

        # keep the signal in its native dtype here: warm re-fits consume
        # only fingerprints and cached device arrays, and an eager
        # f64->f32 cast of a full brain cost ~80ms per fit; the two cold
        # consumers (y_ext build, host tiling) cast at use
        y = np.asarray(evaluation.y)
        # direction quantization + tile plan are DIRs-only derived: cache
        # them across warm re-fits (identity + strided content fingerprint,
        # same invalidation rationale as the staging cache below)
        DIRs = np.asarray(evaluation.DIRs, np.float64)
        dstride = max(1, DIRs.size // 65536)
        dirs_fp = (DIRs.shape,
                   float(np.sum(DIRs.ravel()[::dstride], dtype=np.float64)))
        pkey = (evaluation.DIRs, dirs_fp, evaluation.htable)
        pc = getattr(self, '_plan_cache', None)
        if pc is not None and pc[0][0] is pkey[0] \
                and pc[0][1] == pkey[1] and pc[0][2] is pkey[2]:
            lut_idx = pc[1]
        else:
            lut_idx = _lut.dir_to_lut_idx(DIRs, evaluation.htable)
            pc = self._plan_cache = (pkey, lut_idx, {})
        cfg_tile = evaluation.get_config('tile_size')
        if tile_size is None and cfg_tile not in (None, 'auto'):
            tile_size = int(cfg_tile)
        if tile_size is None:
            tile_size = 128
        vpc = voxels_per_chunk or evaluation.get_config('voxels_per_chunk') \
            or 'auto'

        # optional device mesh: shard the tile axis (voxel data parallelism,
        # SURVEY.md section 2.4); chunk size padded to a device multiple
        mesh = evaluation.get_config('mesh')
        sharding = None
        if mesh is not None:
            from ..parallel.mesh import tile_sharding
            sharding = tile_sharding(mesh)

        plan = pc[2].get(tile_size)
        if plan is None:
            plan = pc[2][tile_size] = build_tile_plan(lut_idx, tile_size)
        # tiling strategy: on a single device the (n_tiles, M, nS) tiled
        # signal is never materialized on the host -- the flat (N+1, nS)
        # signal is staged once and each chunk's rows are gathered on
        # device (the permutation is a cheap int32 take).  The mesh path
        # keeps host tiling so shard boundaries stay explicit; signals
        # beyond the device budget stream host-tiled chunks instead.
        budget = int(evaluation.get_config('max_device_bytes')
                     or default_device_budget())
        # budget-check the f32 footprint actually staged, not y.nbytes:
        # callers may hand f64 voxel matrices but only an f32 copy ever
        # reaches the device -- comparing native bytes silently dropped
        # volumes between budget/2 and budget to the streamed path
        y_f32_bytes = y.size * 4
        device_gather = sharding is None and y_f32_bytes <= budget
        if vpc == 'auto':
            # equal-split chunking; the two modes want different shapes.
            # Streaming/mesh paths keep ~51k-voxel chunks so uploads
            # overlap solves; device-gather wants FEW big dispatches
            # (details below).
            if device_gather:
                # few big dispatches, each chunk's result D2H overlapping
                # the next chunk's solve (up to 4 chunks).  chunk_tiles is
                # quantized to 32 so subjects with nearby masked-voxel
                # counts reuse one compiled shape; padded tiles carry zero
                # voxels and settle immediately.
                target = max(1, 51200 // tile_size)
                nchunks = max(1, min(4, -(-plan.n_tiles // target)))
                per_chunk = -(-plan.n_tiles // nchunks)
                chunk_tiles = -(-per_chunk // 32) * 32
            else:
                target = max(1, 51200 // tile_size)
                nchunks = max(1, min(8, -(-plan.n_tiles // target)))
                per_chunk = -(-plan.n_tiles // nchunks)
                chunk_tiles = -(-per_chunk // 4) * 4
        else:
            chunk_tiles = max(1, int(vpc) // tile_size)
        if mesh is not None:
            ndev = mesh.devices.size
            chunk_tiles = max(1, -(-chunk_tiles // ndev) * ndev)
        dirs_t = plan.tile_dirs
        valid_t = plan.valid
        Y = None if device_gather \
            else tile_voxels(plan, y.astype(np.float32, copy=False))

        # memoize the jitted fit across fit() calls: a fresh closure per call
        # would retrace and miss jax's in-process compile cache
        if cache_key is not None:
            cache = getattr(self, '_fit_fn_cache', None)
            if cache is None:
                cache = self._fit_fn_cache = {}
            fit_jit = cache.get(cache_key)
            if fit_jit is None:
                fit_jit = cache[cache_key] = jax.jit(fit_chunk_fn)
        else:
            fit_jit = jax.jit(fit_chunk_fn)
        consts = tuple(jnp.asarray(c) for c in consts)
        if sharding is not None:
            from ..parallel.mesh import replicated
            consts = tuple(jax.device_put(c, replicated(mesh)) for c in consts)

        out_tiles = {k: np.zeros((plan.n_tiles, tile_size) + shape, np.float32)
                     for k, shape in n_outputs_like.items()}

        # mid-fit checkpoint/resume (SURVEY.md section 5.4: the reference has
        # none; long sweeps here can resume at chunk granularity).  The
        # checkpoint must match this exact fit -- a same-shaped checkpoint
        # from another subject, or one missing a requested output (e.g.
        # RMSE toggled on since the crash), is ignored rather than merged:
        # the plan fingerprint pins the voxel bucketing and every output
        # key must be present
        stride = max(1, y.size // 65536)
        y_sum = float(np.sum(y.ravel()[::stride], dtype=np.float64))
        pstride = max(1, plan.perm.size // 65536)
        perm_sum = int(np.sum(plan.perm[::pstride], dtype=np.int64))
        ckpt_path = evaluation.get_config('fit_checkpoint')
        ck_plan_fp = self._ckpt_fingerprint(plan, tile_size, y,
                                            y_sum=y_sum, perm_sum=perm_sum)
        done_until = 0
        if ckpt_path and os.path.isfile(ckpt_path):
            with np.load(ckpt_path) as ck:
                if 'plan_fp' in ck \
                        and np.array_equal(ck['plan_fp'], ck_plan_fp) \
                        and all(k in ck for k in out_tiles):
                    done_until = int(ck['done_until'])
                    for k in out_tiles:
                        out_tiles[k][:done_until] = ck[k][:done_until]

        # device-side staging cache: re-fits on the same loaded volume
        # (multi-model runs, warm re-fits, parameter sweeps) skip the
        # host->device upload of the signal entirely.  Keyed by array
        # identity (`is` comparison, same rationale as the kernel prep
        # cache) plus strided content fingerprints of the signal AND the
        # tile plan: an in-place mutation of evaluation.y, or new DIRs that
        # re-bucket the same voxels (possibly into the same tile count),
        # must invalidate the staged copies -- in gather mode the cache
        # holds per-chunk permutation indices, which are plan-dependent.
        y_fp = (y.shape, y_sum)
        plan_fp = (plan.n_tiles, perm_sum,
                   int(np.sum(plan.tile_dirs, dtype=np.int64)))
        stage_key = (evaluation.y, y_fp, tile_size, plan_fp, chunk_tiles,
                     device_gather,
                     None if sharding is None else str(sharding))
        # device-residency budget (see tiling strategy above): beyond it,
        # no input caching and a bounded in-flight window
        chunk_bytes = chunk_tiles * tile_size * y.shape[1] * 4
        staged_bytes = y_f32_bytes if device_gather else Y.nbytes
        cache_inputs = staged_bytes <= budget
        max_inflight = max(2, budget // max(chunk_bytes, 1))
        staged = getattr(self, '_stage_cache', None)
        if staged is not None and staged[0][0] is stage_key[0] \
                and staged[0][1:] == stage_key[1:]:
            chunks_dev = staged[1]
        elif cache_inputs:
            chunks_dev = {}
            self._stage_cache = (stage_key, chunks_dev)
        else:
            chunks_dev = None
            self._stage_cache = None

        y_ext_dev = None
        if device_gather:
            # flat signal + zero pad row, staged once; per-chunk tiles are
            # built by an int32 gather fused INTO the fit dispatch (one
            # launch per chunk, no host-tiled copies, no intermediate)
            key = '__y_ext__'
            pre = getattr(evaluation, '_staged_y_ext_dev', None)
            if chunks_dev is not None and key in chunks_dev:
                y_ext_dev = chunks_dev[key]
            elif pre is not None and pre[0] is y \
                    and pre[1].shape == (y.shape[0] + 1, y.shape[1]):
                # the facade already staged this exact signal (shared with
                # the DTI direction fit) -- reuse, skip the second upload
                y_ext_dev = pre[1]
                if chunks_dev is not None:
                    chunks_dev[key] = y_ext_dev
            else:
                y_ext = np.concatenate(
                    [y.astype(np.float32, copy=False),
                     np.zeros((1, y.shape[1]), np.float32)], axis=0)
                y_ext_dev = jnp.asarray(y_ext)
                if chunks_dev is not None:
                    chunks_dev[key] = y_ext_dev
            def fit_gather(y_ext, idx, dc, vc, *cs):
                # shape-polymorphic (jit specializes per input shape): the
                # chunk/tile/sample extents come from the traced args, so
                # one cached closure serves every chunk shape
                Yc = jnp.take(y_ext, idx, axis=0).reshape(
                    dc.shape[0], vc.shape[1], y_ext.shape[1])
                return fit_chunk_fn(Yc, dc, vc, *cs)

            if cache_key is not None:
                gkey = (cache_key, 'gather')
                cache = self._fit_fn_cache
                fit_gather_jit = cache.get(gkey)
                if fit_gather_jit is None:
                    fit_gather_jit = cache[gkey] = jax.jit(fit_gather)
            else:
                fit_gather_jit = jax.jit(fit_gather)

        # dispatch ALL chunks before pulling any result: uploads and solves
        # pipeline (dispatch is async), and no device->host transfer is
        # interleaved between uploads -- downloads only start once every
        # chunk is in flight.  Outputs are a few MB total, so holding them
        # on device until the end costs nothing.
        # Phase timers (stored as self._last_fit_timers): where a fit's
        # wall clock goes -- dispatch (host async-enqueue incl. any cold
        # per-chunk staging), device (dispatch end -> last chunk ready),
        # pull (device->host result transfers), untile (host scatter).
        # ~20 time.time() calls per fit; drives the bench's
        # fit_breakdown field (round-3 review: the staged-vs-solver gap
        # was unattributed).
        timers = {'n_chunks': 0}
        _t_loop0 = _time.time()
        timers['setup_s'] = _t_loop0 - _t_enter
        pending = []
        n_dispatched = 0
        ckpt_every = int(evaluation.get_config('checkpoint_every') or 4)
        for start, stop, pad in iter_tile_chunks(plan.n_tiles, chunk_tiles):
            if stop <= done_until:
                continue
            if device_gather:
                # per-chunk device inputs (gather indices into the staged
                # flat signal -- plan.perm pads with n_voxels = the zero
                # row -- plus tile dirs/valid) are tiny and y-independent:
                # cached across warm re-fits so those upload nothing
                args = None if chunks_dev is None else chunks_dev.get(start)
                if args is None:
                    M = tile_size
                    idx = plan.perm[start * M:stop * M]
                    dc = dirs_t[start:stop]
                    vc = valid_t[start:stop]
                    if pad:
                        idx = np.concatenate(
                            [idx, np.full(pad * M, plan.n_voxels, idx.dtype)])
                        dc = np.concatenate([dc, np.zeros(pad, dc.dtype)])
                        vc = np.concatenate(
                            [vc, np.zeros((pad,) + vc.shape[1:], bool)])
                    args = (jnp.asarray(idx), jnp.asarray(dc),
                            jnp.asarray(vc))
                    if chunks_dev is not None:
                        chunks_dev[start] = args
                res = fit_gather_jit(y_ext_dev, *args, *consts)
            else:
                args = None if chunks_dev is None else chunks_dev.get(start)
                if args is None:
                    Yc = Y[start:stop]
                    dc = dirs_t[start:stop]
                    vc = valid_t[start:stop]
                    if pad:
                        Yc = np.concatenate([Yc, np.zeros((pad,) + Yc.shape[1:], Yc.dtype)])
                        dc = np.concatenate([dc, np.zeros(pad, dc.dtype)])
                        vc = np.concatenate([vc, np.zeros((pad,) + vc.shape[1:], bool)])
                    args = (jnp.asarray(Yc), jnp.asarray(dc), jnp.asarray(vc))
                    if sharding is not None:
                        args = tuple(jax.device_put(a, sharding) for a in args)
                    if chunks_dev is not None:
                        chunks_dev[start] = args
                res = fit_jit(*args, *consts)
            if n_dispatched == 0:
                # record the first chunk's input/output shardings (cheap:
                # attribute reads).  Observability for the mesh path and
                # the hook the multichip dryrun asserts on -- the judged
                # SPMD artifact must see the PRODUCTION dispatch, not a
                # demo closure (round-3 review item 7).
                try:
                    self._last_fit_shardings = {
                        'args': [a.sharding for a in args],
                        'out': {k: v.sharding for k, v in res.items()},
                    }
                except Exception:
                    self._last_fit_shardings = None
            del args          # streaming mode: free the inputs once consumed
            if device_gather:
                # start D2H for this chunk as soon as its solve finishes,
                # overlapping the remaining chunks' compute (gather mode
                # uploads nothing on warm fits, so the transfer direction
                # never contends)
                for arr in res.values():
                    try:
                        arr.copy_to_host_async()
                    except AttributeError:  # non-jax leaf
                        pass
            pending.append((start, stop, res))
            n_dispatched += 1
            if len(pending) >= max_inflight:
                s0, s1, r0 = pending.pop(0)
                for k, arr in r0.items():
                    out_tiles[k][s0:s1] = np.asarray(arr, np.float32)[:s1 - s0]
            if ckpt_path and n_dispatched % ckpt_every == 0:
                # checkpointing needs host copies mid-run: pull what is in
                # flight and persist (full-rewrite npz, so throttled).
                # Cadence counts dispatched chunks, NOT len(pending): the
                # streaming path pops pending as it goes, which used to
                # keep the modulo from ever firing
                for s0, s1, r0 in pending:
                    for k, arr in r0.items():
                        out_tiles[k][s0:s1] = np.asarray(arr, np.float32)[:s1 - s0]
                np.savez(ckpt_path + '.tmp', plan_fp=ck_plan_fp,
                         done_until=stop, **out_tiles)
                os.replace(ckpt_path + '.tmp.npz', ckpt_path)
                pending = []

        timers['dispatch_s'] = _time.time() - _t_loop0
        timers['n_chunks'] = n_dispatched
        timers['chunk_tiles'] = chunk_tiles
        timers['tile_size'] = tile_size
        if pending:
            # wall until the device finishes the last chunk
            for arr in pending[-1][2].values():
                arr.block_until_ready()
        timers['device_s'] = _time.time() - _t_loop0 - timers['dispatch_s']
        _t_pull0 = _time.time()
        for s0, s1, r0 in pending:
            for k, arr in r0.items():
                out_tiles[k][s0:s1] = np.asarray(arr, np.float32)[:s1 - s0]
        timers['pull_s'] = _time.time() - _t_pull0

        if ckpt_path and os.path.isfile(ckpt_path):
            os.remove(ckpt_path)
        _t_unt0 = _time.time()
        out = {k: untile_voxels(plan, v) for k, v in out_tiles.items()}
        timers['untile_s'] = _time.time() - _t_unt0
        self._last_fit_timers = timers
        return out

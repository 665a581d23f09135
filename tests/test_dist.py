"""Multi-host distributed execution tests (SURVEY.md sections 2.4/5.8).

A real 2-process CPU cluster (jax.distributed + gloo collectives) runs the
full Evaluation pipeline with per-host voxel slabs; the coordinator's
written maps must match a single-process run bit-for-bit (the slab split
must not change any result).  Slab/allgather unit tests run in-process.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from amico_tpu.parallel import dist


def make_study(study_dir, subject='subj', seed=3):
    """Deterministic tiny NODDI subject (same bytes on every call)."""
    from amico_tpu.io import nifti
    from amico_tpu.io.scheme import Scheme
    from amico_tpu.ops.sphere import fibonacci_hemisphere
    from amico_tpu.synthesis import (NODDIExtraCellular, NODDIIntraCellular,
                                     NODDIIsotropic)
    subj = os.path.join(study_dir, subject)
    os.makedirs(subj, exist_ok=True)
    rows = [np.zeros((2, 4))]
    for b in (700.0, 2000.0):
        rows.append(np.c_[fibonacci_hemisphere(24), np.full(24, b)])
    np.savetxt(os.path.join(subj, 'DWI.scheme'), np.vstack(rows), fmt='%.6f',
               header='VERSION: BVECTOR', comments='')
    scheme = Scheme(os.path.join(subj, 'DWI.scheme'))
    rng = np.random.RandomState(seed)
    kappa = 1 / np.tan(0.25 * np.pi / 2)
    base = 0.55 * NODDIIntraCellular(scheme).get_signal(1.7e-3, kappa) + \
        0.45 * NODDIExtraCellular(scheme).get_signal(1.7e-3, kappa, 0.55)
    iso = NODDIIsotropic(scheme).get_signal(3.0e-3)
    dim = (5, 5, 3)
    nvox = int(np.prod(dim))
    fwf = rng.uniform(0, 0.4, nvox)[:, None]
    vol = np.abs(700 * ((1 - fwf) * base + fwf * iso)
                 * (1 + 0.01 * rng.randn(nvox, scheme.nS))).astype(np.float32)
    vol[:, scheme.b0_idx] = 700.0
    nifti.save(nifti.Nifti1Image(vol.reshape(dim + (scheme.nS,)),
                                 np.diag([2.0, 2.0, 2.0, 1.0])),
               os.path.join(subj, 'DWI.nii.gz'))
    return subj


# ------------------------------------------------------------- unit tests
def test_host_slab_partition():
    for n, k in [(10, 3), (7, 2), (5, 5), (3, 4), (100, 8)]:
        slabs = [dist.host_slab(n, i, k) for i in range(k)]
        # contiguous, ordered, covering, balanced
        assert slabs[0].start == 0 and slabs[-1].stop == n
        for a, b in zip(slabs, slabs[1:]):
            assert a.stop == b.start
        sizes = [s.stop - s.start for s in slabs]
        assert max(sizes) - min(sizes) <= 1


def test_allgather_rows_single_process():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(dist.allgather_rows(x, 4), x)


def test_initialize_single_process_noop():
    dist.initialize(num_processes=1)   # must not raise or spawn anything
    assert dist.process_count() >= 1


# --------------------------------------------------- 2-process integration
def _free_port():
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sweep_resume_and_shared_atoms(tmp_path):
    """Distributed SubjectSweep: collective resume after a simulated
    restart, coordinator-only writes, fail-fast on a corrupt subject, and
    the shared-ATOMS_path generation guard.  All
    assertions live in tests/dist_sweep_worker.py and run on both ranks."""
    workdir = str(tmp_path)
    port = _free_port()
    env = dict(os.environ)
    env.pop('JAX_PLATFORMS', None)
    worker = os.path.join(os.path.dirname(__file__), 'dist_sweep_worker.py')
    procs = [subprocess.Popen(
        [sys.executable, worker, str(rank), '2', str(port), workdir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        outs.append(out.decode())
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {rank} failed:\n{out}'
        assert f'rank {rank}: OK' in out


def test_two_process_pipeline_matches_single(tmp_path):
    workdir = str(tmp_path)
    port = _free_port()
    env = dict(os.environ)
    env.pop('JAX_PLATFORMS', None)
    worker = os.path.join(os.path.dirname(__file__), 'dist_worker.py')
    procs = [subprocess.Popen(
        [sys.executable, worker, str(rank), '2', str(port), workdir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        outs.append(out.decode())
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {rank} failed:\n{out}'

    # single-process reference on the same deterministic subject
    import amico_tpu
    os.environ['AMICO_TPU_HOME'] = os.path.join(workdir, 'home_sp')
    study = os.path.join(workdir, 'study_sp')
    make_study(study)
    ev = amico_tpu.Evaluation(study, 'subj')
    ev.load_data(dwi_filename='DWI.nii.gz', scheme_filename='DWI.scheme')
    ev.set_model('NODDI')
    ev.model.set(IC_VFs=np.linspace(0.3, 0.99, 4),
                 IC_ODs=np.array([0.06, 0.3, 0.8]))
    ev.generate_kernels(ndirs=500)
    ev.load_kernels()
    ev.fit()

    from amico_tpu.io import nifti
    out0 = os.path.join(workdir, 'study0', 'subj', 'AMICO', 'NODDI')
    # rank 1 must NOT have written anything
    assert not os.path.isdir(
        os.path.join(workdir, 'study1', 'subj', 'AMICO', 'NODDI'))
    for i, name in enumerate(ev.model.maps_name):
        got = nifti.load(os.path.join(out0, f'fit_{name}.nii.gz')).get_fdata()
        want = ev.RESULTS['MAPs'][..., i]
        np.testing.assert_allclose(got, want, atol=2e-5,
                                   err_msg=f'map {name} differs')

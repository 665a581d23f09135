#!/usr/bin/env python
"""Multi-subject sweep over a device mesh.

The pod-scale AMICO workload (SURVEY.md section 7 step 7): one model fitted
over many subjects, voxel tiles sharded across every local device, resume at
subject granularity.  The reference scales this with one CPU thread per
core per subject (amico/models.pyx:529-541); here the same sweep rides a
``jax.sharding.Mesh`` and fits each full brain in one pass.

Runs anywhere: on a multi-GPU host it uses the real cards; elsewhere
emulate several devices with virtual CPU devices:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/sweep_multichip_demo.py [study_dir]
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))

from noddi_demo import make_subject  # noqa: E402 (same-dir import)

import amico_tpu  # noqa: E402
from amico_tpu.parallel.mesh import make_mesh  # noqa: E402
from amico_tpu.sweep import SubjectSweep  # noqa: E402


def main():
    study = sys.argv[1] if len(sys.argv) > 1 else \
        tempfile.mkdtemp(prefix='amico_tpu_sweep_')
    subjects = [make_subject(study, f'subject{i}', dim=(12, 12, 6), seed=i)
                for i in range(3)]

    amico_tpu.set_verbose(2)
    mesh = make_mesh()          # all local devices on the ('data',) axis
    print(f'Mesh: {mesh.devices.size} x {mesh.devices.flat[0].platform}')

    sweep = SubjectSweep(
        study, subjects, 'NODDI',
        dwi_filename='DWI.nii.gz',
        mesh=mesh,
        # chunk-level mid-fit checkpointing: a killed sweep resumes
        # mid-subject (the reference has no fit-level resume at all)
        config={'fit_checkpoint': os.path.join(study, 'fit_ckpt.npz')},
    )
    results = sweep.run(resume=True)
    for subject, path in results.items():
        print(f'  {subject}: {path}')

    # re-running is a no-op thanks to resume-by-existence
    again = SubjectSweep(study, subjects, 'NODDI',
                         dwi_filename='DWI.nii.gz',
                         mesh=mesh).run(resume=True)
    assert again.keys() == results.keys()


if __name__ == '__main__':
    main()

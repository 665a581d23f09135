"""Test configuration: force an 8-device virtual CPU mesh.

SURVEY.md section 4: distributed tests without a cluster use JAX's standard
trick of a CPU mesh via ``--xla_force_host_platform_device_count`` so
``shard_map``/collectives are exercised without accelerator hardware.

Tests that need the GPU carry the ``gpu`` marker (registered in
pyproject.toml) and take the ``gpu_device`` fixture, which skips them
when JAX has no GPU.  The decision is made inside the fixture, never at
import or collection time, so every xdist worker collects the same tests.
The suite runs on the CPU unless ``JAX_PLATFORMS`` says otherwise; run
the gpu tests on the card with
``JAX_PLATFORMS=cuda python -m pytest tests -m gpu -p no:xdist``.
"""
import os

import pytest

flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (flags + ' --xla_force_host_platform_device_count=8').strip()

os.environ.setdefault('JAX_PLATFORMS', 'cpu')

import jax  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    gpus = [d for d in jax.devices() if d.platform == 'gpu']
    if not gpus:
        pytest.skip('needs a GPU (run on the card: see tests/conftest.py)')
    return gpus[0]

"""amico_tpu — JAX-native microstructure-imaging framework.

A from-scratch JAX/XLA re-design of the capabilities of AMICO
(Accelerated Microstructure Imaging via Convex Optimization): per-voxel
dictionary fits of diffusion-MRI microstructure models as massively batched
non-negative least-squares / elastic-net solves on an accelerator.

Public API mirrors the reference package surface
(/root/reference/amico/__init__.py:1-9): ``Evaluation``, ``setup``,
``set_verbose``/``get_verbose``, plus the scheme converters and the model zoo.
"""
from .utils.logging import AmicoError, get_verbose, set_verbose
from .io.scheme import Scheme, fsl2scheme, sandi2scheme

__version__ = '0.5.0'

__all__ = [
    'Evaluation', 'setup', 'set_verbose', 'get_verbose', 'AmicoError',
    'Scheme', 'fsl2scheme', 'sandi2scheme', 'core', 'models', '__version__',
]


def __getattr__(name):
    # lazy imports keep `import amico_tpu` light (no jax import) for tools
    # that only need the scheme/logging layers.  NB: importlib, not
    # `from . import ...` -- the latter re-enters this __getattr__.
    import importlib
    if name in ('Evaluation', 'setup', 'core'):
        core = importlib.import_module('.core', __name__)
        if name == 'core':
            return core
        return getattr(core, name)
    if name in ('models', 'util', 'scheme', 'synthesis', 'lut', 'preproc'):
        # reference scripts address these as attribute submodules
        # (`amico.util.fsl2scheme(...)`, `amico.scheme.Scheme`, ...);
        # the reference package gets this for free because its eager
        # imports pull them in (/root/reference/amico/__init__.py:1-9)
        return importlib.import_module(f'.{name}', __name__)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')

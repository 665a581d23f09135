"""JAX runtime configuration helpers."""
from __future__ import annotations

import hashlib
import os
import platform

_cache_enabled = False

# default persistent-cache root: a fixed directory inside the checkout (the
# directory holding the package), listed in .gitignore.  A fixed path keeps
# cache hits across processes; JAX_COMPILATION_CACHE_DIR overrides it.
DEFAULT_CACHE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), '.jax_cache')


def _machine_fingerprint() -> str:
    """Short tag identifying the compile target well enough to keep
    executables from one machine type out of another's cache.

    XLA:CPU executables embed host-ISA-specific code, so a cache directory
    shared between machine types (e.g. an NFS home) could serve a SIGILL.
    The fingerprint folds in the arch, the CPU model/flags, and the JAX
    version; device executables are additionally keyed by backend and
    device kind inside JAX's own cache key.
    """
    import jax
    # NB: deliberately neither jax.default_backend() (initializes the
    # runtime -- this fingerprint runs at Evaluation construction, which
    # must stay legal before jax.distributed.initialize()) nor the
    # JAX_PLATFORMS env var: the compile target is already part of jax's
    # own per-entry cache key, and keying the *directory* on the env var
    # would split one machine's cache into per-setting siblings.
    parts = [platform.machine(), platform.system(), jax.__version__]
    try:
        wanted = {'model name', 'flags'}
        with open('/proc/cpuinfo') as fid:
            for line in fid:
                key = line.split(':', 1)[0].strip()
                if key in wanted:
                    parts.append(line.strip())
                    wanted.discard(key)
                    if not wanted:
                        break
    except OSError:
        pass
    return hashlib.sha1('|'.join(parts).encode()).hexdigest()[:12]


def compilation_cache_dir() -> str:
    """Where the persistent compilation cache lives: the directory named by
    ``JAX_COMPILATION_CACHE_DIR`` when that is set, else
    ``<checkout>/.jax_cache/<machine fingerprint>``."""
    env = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env:
        return env
    return os.path.join(DEFAULT_CACHE_ROOT, _machine_fingerprint())


def enable_compilation_cache() -> None:
    """Enable JAX's persistent compilation cache (see
    :func:`compilation_cache_dir`).  A warm cache drops a new process's
    compiles of the fit programs to deserialization time.  Idempotent;
    a cache directory that cannot be created is reported and the run goes
    on without a persistent cache."""
    global _cache_enabled
    if _cache_enabled:
        return
    import jax
    cache_dir = compilation_cache_dir()
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError as e:
        from .logging import WARNING
        WARNING(f'persistent compilation cache disabled: cannot create '
                f'{cache_dir} ({e})')
        _cache_enabled = True
        return
    jax.config.update('jax_compilation_cache_dir', cache_dir)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 1.0)
    # Strip Python tracebacks from MLIR locations.  Custom-call payloads
    # (a Pallas or FFI kernel's serialized module) carry their locations
    # beyond the reach of the cache key's strip-debuginfo pass, so with
    # tracebacks on every distinct CALL SITE of fit() would re-key such an
    # executable.  Cost: compiler error messages lose Python source
    # locations; opt out via AMICO_TPU_FULL_LOCATIONS=1 when debugging a
    # lowering.
    if os.environ.get('AMICO_TPU_FULL_LOCATIONS') != '1':
        jax.config.update('jax_include_full_tracebacks_in_locations', False)
        jax.config.update('jax_traceback_in_locations_limit', 0)
    _cache_enabled = True

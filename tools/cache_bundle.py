#!/usr/bin/env python
"""Pack / unpack the persistent compilation cache for fleet deployment.

`amico_tpu warmup` compiles the production fit executables into the
per-machine persistent cache (docs/PERFORMANCE.md "Cold start / shipping
the warmth").  For a fleet of identical machines (same image, same
backend configuration), one machine can run warmup and ship the
resulting executables to the rest:

    python tools/cache_bundle.py pack bundle.tar         # on the warm machine
    python tools/cache_bundle.py unpack bundle.tar       # on each cold machine

The cache directory is the one the package itself uses
(amico_tpu.utils.jaxcfg.compilation_cache_dir): ``JAX_COMPILATION_CACHE_DIR``
when set, else ``<checkout>/.jax_cache/<machine fingerprint>``.
Only production-fit entries are packed (jitted fit/gather/prep programs),
not the full experiment history, so bundles stay tens of MB.  Unpacking
never overwrites existing entries.  NB the cache key covers the backend,
device kind and compile options -- a bundle is valid per (amico_tpu
version x jax version x device configuration); mismatched entries are
simply never hit and cost only disk.
"""
from __future__ import annotations

import os
import sys
import tarfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))

# executables the production pipeline compiles (names are jax's
# jit_<function> cache-entry prefixes)
_PREFIXES = ('jit_fit_gather', 'jit_fit_chunk', 'jit__prep',
             'jit__fit_dti_device', 'jit_convert_element_type')


def _cache_dir() -> str:
    from amico_tpu.utils.jaxcfg import compilation_cache_dir
    d = compilation_cache_dir()
    os.makedirs(d, exist_ok=True)
    return d


def pack(out_path: str) -> int:
    d = _cache_dir()
    entries = [f for f in sorted(os.listdir(d))
               if f.startswith(_PREFIXES)]
    if not entries:
        raise SystemExit(f'no production-fit cache entries under {d}; '
                         'run `python -m amico_tpu warmup` first')
    total = 0
    with tarfile.open(out_path, 'w') as tar:
        for f in entries:
            p = os.path.join(d, f)
            tar.add(p, arcname=f)
            total += os.path.getsize(p)
    print(f'packed {len(entries)} entries ({total / 1e6:.1f} MB) '
          f'from {d} -> {out_path}')
    return 0


def unpack(in_path: str) -> int:
    d = _cache_dir()
    n_new = n_skip = 0
    with tarfile.open(in_path) as tar:
        for m in tar.getmembers():
            if not m.isfile() or os.path.sep in m.name or m.name.startswith('.'):
                continue            # defensive: flat archive only
            dest = os.path.join(d, m.name)
            if os.path.exists(dest):
                n_skip += 1
                continue
            src = tar.extractfile(m)
            tmp = dest + f'.tmp{os.getpid()}'
            with open(tmp, 'wb') as out:
                out.write(src.read())
            os.replace(tmp, dest)   # atomic: concurrent fits see whole files
            n_new += 1
    print(f'unpacked {n_new} entries into {d} ({n_skip} already present)')
    return 0


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2 or argv[0] not in ('pack', 'unpack'):
        print(__doc__)
        return 2
    t0 = time.time()
    rc = pack(argv[1]) if argv[0] == 'pack' else unpack(argv[1])
    print(f'[{time.time() - t0:.1f}s]')
    return rc


if __name__ == '__main__':
    raise SystemExit(main())

"""Verbosity-gated logging.

Re-design of the reference logging utilities
(/root/reference/amico/util.py:5-49).  Functional parity:

* global verbosity level 0-3 with ``set_verbose``/``get_verbose``
  (util.py:7-24)
* ANSI-colored ``PRINT/LOG/NOTE/WARNING/ERROR`` gates (util.py:26-49)

Design delta: the reference's ``ERROR`` prints and *exits the process*
(util.py:42-49).  In a framework that may be driving a multi-host device job,
killing the interpreter from library code is hostile, so ``ERROR`` raises
:class:`AmicoError` instead (still printing the same colored message).
"""
from __future__ import annotations

__VERBOSE_LEVEL__ = 3


class AmicoError(RuntimeError):
    """Raised by :func:`ERROR`; replaces the reference's sys.exit (util.py:42-49)."""


def set_verbose(verbose: int) -> None:
    """Set the verbosity of all functions (reference util.py:7-21).

    3 = show everything, 2 = messages but no progress bars,
    1 = only warnings/errors, 0 = hide everything.
    """
    global __VERBOSE_LEVEL__
    if type(verbose) is not int or verbose not in (0, 1, 2, 3):
        raise TypeError('"verbose" must be either 0, 1, 2 or 3')
    __VERBOSE_LEVEL__ = verbose


def get_verbose() -> int:
    return __VERBOSE_LEVEL__


def PRINT(*args, **kwargs) -> None:
    if __VERBOSE_LEVEL__ >= 2:
        print(*args, **kwargs, flush=True)


def LOG(msg: str, prefix: str = '') -> None:
    if __VERBOSE_LEVEL__ >= 2:
        print(prefix + "\033[0;32m%s\033[0m" % msg, flush=True)


def NOTE(msg: str, prefix: str = '') -> None:
    if __VERBOSE_LEVEL__ == 2:
        print(prefix + "\033[0;30;44m[ NOTE ]\033[0;34m %s\033[0m" % msg, flush=True)


def WARNING(msg: str, prefix: str = '') -> None:
    if __VERBOSE_LEVEL__ >= 1:
        print(prefix + "\033[0;30;43m[ WARNING ]\033[0;33m %s\033[0m" % msg, flush=True)


def ERROR(msg: str, prefix: str = '') -> None:
    if __VERBOSE_LEVEL__ >= 1:
        print(prefix + "\033[0;30;41m[ ERROR ]\033[0;31m %s\033[0m\n" % msg, flush=True)
    raise AmicoError(msg)

"""Leveled, named loggers for every subsystem.

TPU-native counterpart of the reference's ``log/logger.go:30-84`` (named,
leveled, colored loggers with a configurable sink). We build on the stdlib
``logging`` module instead of wrapping a third-party package.
"""

from __future__ import annotations

import logging
import sys
import time

_FORMAT = "%(asctime)s %(levelname)-7s %(name)s: %(message)s"
_configured = False
_level = logging.WARNING


def set_level(verbosity: int) -> None:
    """Map CLI -v/-vv flags to log levels (reference: cmd/logging.go:10-18)."""
    global _level
    if verbosity >= 2:
        _level = logging.DEBUG
    elif verbosity == 1:
        _level = logging.INFO
    else:
        _level = logging.WARNING
    logging.getLogger("polaris").setLevel(_level)


def get_logger(name: str) -> logging.Logger:
    """Return a named logger under the ``polaris`` hierarchy."""
    global _configured
    root = logging.getLogger("polaris")
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root.addHandler(handler)
        root.setLevel(_level)
        root.propagate = False
        _configured = True
    return root.getChild(name)


class Timer:
    """Context manager measuring wall time in milliseconds.

    Mirrors the reference's habit of threading wall-clock durations through
    every layer (device/kernel.go:107-129, tracer.go:150).
    """

    def __init__(self) -> None:
        self.ms = 0.0

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.ms = (time.perf_counter() - self._t0) * 1e3

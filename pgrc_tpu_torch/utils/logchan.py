"""Logging channels and timing checkpoints.

Mirrors the reference's three ostream channels appout/devout/logout
(utils/helper.cpp:5-12; release builds null out logout, PgRC.cpp:34-38) and
the chrono checkpoint helpers time_checkpoint/time_millis
(utils/helper.cpp:33-47). Channels are plain writable file-like objects so
callers can route them to stderr, files, or swallow them.
"""
from __future__ import annotations

import io
import sys
import time


class _Null(io.TextIOBase):
    def write(self, s: str) -> int:  # pragma: no cover - trivial
        return len(s)


NULL = _Null()

appout = sys.stderr     # user-facing progress
devout = NULL           # developer diagnostics (per-stream compression logs)
logout = NULL           # verbose trace


def set_verbosity(level: int) -> None:
    """0: app only (release default), 1: +dev stream logs, 2: +trace."""
    global devout, logout
    devout = sys.stderr if level >= 1 else NULL
    logout = sys.stderr if level >= 2 else NULL


_checkpoint = time.monotonic()


def time_checkpoint() -> None:
    global _checkpoint
    _checkpoint = time.monotonic()


def time_millis() -> int:
    return int((time.monotonic() - _checkpoint) * 1000)

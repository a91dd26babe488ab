"""Category-gated logging with relative-ms timestamps.

Reference: include/ultra/logging.hpp:20-142 — 5 levels, per-category gates
(DEMOD/MODEM/LDPC/SYNC/CHAN), runtime level, file redirect, compile-out.
The ULTRA_LOG_DISABLE env var is the compile-out equivalent.

The port's copy of the JAX package's module, pinned to it by
``tests/test_torch_aux.py``.
"""

from __future__ import annotations

import enum
import os
import sys
import time
from typing import TextIO


class LogLevel(enum.IntEnum):
    NONE = 0
    ERROR = 1
    WARN = 2
    INFO = 3
    DEBUG = 4
    TRACE = 5


CATEGORIES = ("DEMOD", "MODEM", "LDPC", "SYNC", "CHAN", "PROTO", "SWEEP")

_start = time.monotonic()
_level = LogLevel.WARN
_gates = {c: True for c in CATEGORIES}
_sink: TextIO = sys.stderr
_disabled = os.environ.get("ULTRA_LOG_DISABLE") == "1"


def set_level(level: LogLevel | str):
    global _level
    _level = LogLevel[level] if isinstance(level, str) else LogLevel(level)


def get_level() -> LogLevel:
    return _level


def enable_category(cat: str, enabled: bool = True):
    _gates[cat] = enabled


def redirect(sink: TextIO):
    global _sink
    _sink = sink


def redirect_to_file(path: str):
    redirect(open(path, "a"))


def log(level: LogLevel, category: str, fmt: str, *args):
    if _disabled or level > _level or not _gates.get(category, True):
        return
    ms = (time.monotonic() - _start) * 1000.0
    msg = fmt % args if args else fmt
    _sink.write(f"[{ms:9.3f}][{level.name:<5}][{category}] {msg}\n")


def error(cat, fmt, *a): log(LogLevel.ERROR, cat, fmt, *a)
def warn(cat, fmt, *a): log(LogLevel.WARN, cat, fmt, *a)
def info(cat, fmt, *a): log(LogLevel.INFO, cat, fmt, *a)
def debug(cat, fmt, *a): log(LogLevel.DEBUG, cat, fmt, *a)
def trace(cat, fmt, *a): log(LogLevel.TRACE, cat, fmt, *a)

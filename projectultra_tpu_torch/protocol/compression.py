"""Payload compression (miniz-compatible zlib deflate).

Reference: src/protocol/compression.{hpp,cpp} wrapping vendored miniz
(`mz_compress2`/`mz_uncompress` use the standard zlib container, so Python's
zlib is wire-compatible).

The port's copy of the JAX package's module, pinned to it by
``tests/test_torch_protocol_stack.py``.
"""

from __future__ import annotations

import zlib


def compress(data: bytes, level: int = 9) -> bytes | None:
    """Returns None on failure (Compression::compress semantics)."""
    try:
        return zlib.compress(data, level)
    except Exception:
        return None


def decompress(data: bytes, expected_size: int | None = None) -> bytes | None:
    try:
        out = zlib.decompress(data)
    except Exception:
        return None
    if expected_size is not None and len(out) != expected_size:
        return None
    return out


def maybe_compress(data: bytes) -> tuple[bytes, bool]:
    """Compress only when it helps (file_transfer.cpp:103-115)."""
    c = compress(data)
    if c is not None and len(c) < len(data):
        return c, True
    return data, False

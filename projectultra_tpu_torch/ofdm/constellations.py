"""Constellation mapping tables (Gray-coded, unit average power).

Reference: src/ofdm/modulator.cpp:10-106.  Each modulation gets a complex64
lookup table indexed by the bit word; TX mapping is then a single gather.
The port's copy of the JAX package's tables, pinned array-equal to them by
``tests/test_torch_host.py``.
"""

from __future__ import annotations

import functools

import numpy as np

from ..config import Modulation

QPSK_SCALE = 0.7071067811865476          # 1/sqrt(2)
QAM16_SCALE = 0.3162277660168379         # 1/sqrt(10)
QAM32_SCALE = 0.1961161351381840         # 1/sqrt(26)
QAM64_SCALE = 0.1543033499620919         # 1/sqrt(42)
QAM256_SCALE = 0.0645497224367903        # 1/sqrt(170)

# Gray decode tables for 32-QAM (modulator.cpp:53-72).
_I_LEVELS32 = np.array([-3, -1, 1, 3], np.float32)
_I_GRAY32 = [0, 1, 3, 2]
_Q_LEVELS32 = np.array([-7, -5, -3, -1, 1, 3, 5, 7], np.float32)
_Q_GRAY32 = [0, 1, 3, 2, 6, 7, 5, 4]


@functools.lru_cache(maxsize=None)
def table(mod: Modulation) -> np.ndarray:
    """[2^bits] complex64 constellation points indexed by the bit word."""
    if mod == Modulation.BPSK:
        return np.array([-1, 1], np.complex64)
    if mod == Modulation.QPSK:
        s = QPSK_SCALE
        return np.array([complex(-s, -s), complex(-s, s),
                         complex(s, -s), complex(s, s)], np.complex64)
    if mod == Modulation.QAM16:
        levels = np.array([-3, -1, 3, 1], np.float32)
        out = np.empty(16, np.complex64)
        for b in range(16):
            out[b] = complex(levels[(b >> 2) & 3] * QAM16_SCALE,
                             levels[b & 3] * QAM16_SCALE)
        return out
    if mod == Modulation.QAM32:
        out = np.empty(32, np.complex64)
        for b in range(32):
            qb, ib = (b >> 2) & 7, b & 3
            i_idx = _I_GRAY32.index(ib)
            q_idx = _Q_GRAY32.index(qb)
            out[b] = complex(_I_LEVELS32[i_idx] * QAM32_SCALE,
                             _Q_LEVELS32[q_idx] * QAM32_SCALE)
        return out
    if mod == Modulation.QAM64:
        levels = np.array([-7, -5, -1, -3, 7, 5, 1, 3], np.float32)
        out = np.empty(64, np.complex64)
        for b in range(64):
            out[b] = complex(levels[(b >> 3) & 7] * QAM64_SCALE,
                             levels[b & 7] * QAM64_SCALE)
        return out
    if mod == Modulation.QAM256:
        levels = np.array([-15, -13, -9, -11, -1, -3, -7, -5,
                           15, 13, 9, 11, 1, 3, 7, 5], np.float32)
        out = np.empty(256, np.complex64)
        for b in range(256):
            out[b] = complex(levels[(b >> 4) & 0xF] * QAM256_SCALE,
                             levels[b & 0xF] * QAM256_SCALE)
        return out
    # Default falls back to QPSK like mapBits' default arm.
    return table(Modulation.QPSK)


@functools.lru_cache(maxsize=None)
def qam32_points_and_bits() -> tuple[np.ndarray, np.ndarray]:
    """All 32 points with their bit words, for max-log-MAP demapping
    (soft_demap.hpp:77-95)."""
    pts = np.empty(32, np.complex64)
    bits = np.empty(32, np.int32)
    for qi in range(8):
        for ii in range(4):
            idx = qi * 4 + ii
            pts[idx] = complex(_I_LEVELS32[ii] * QAM32_SCALE,
                               _Q_LEVELS32[qi] * QAM32_SCALE)
            bits[idx] = (_Q_GRAY32[qi] << 2) | _I_GRAY32[ii]
    return pts, bits


# Differential phase-change tables (modulator.cpp:407-445).
DQPSK_PHASES = np.array([1, 1j, -1, -1j], np.complex64)  # 00/01/10/11


def d8psk_phase(bits: np.ndarray) -> np.ndarray:
    """45-degree steps with a 22.5-degree offset so sin()-based LLRs never sit
    exactly on a zero of the metric."""
    ang = (np.asarray(bits) & 7) * (np.pi / 4.0) + np.pi / 8.0
    return (np.cos(ang) + 1j * np.sin(ang)).astype(np.complex64)

"""Soft demapping: equalized symbols -> LLRs (port of
projectultra_tpu/ops/demap.py, reference src/ofdm/soft_demap.hpp).

All functions broadcast over leading axes (frames x symbols x carriers);
per-bit LLRs go on a new trailing axis in the reference's bit order (MSB
first).  LLR convention: positive = bit 0.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import Modulation
from ..ofdm import constellations as con

MAX_LLR = 10.0
MIN_LLR_MAG = 0.5

# Channel-estimation error margins (demodulator_constants.hpp:102-107).
CE_MARGIN = {
    Modulation.DBPSK: 1.0, Modulation.DQPSK: 1.0, Modulation.BPSK: 1.0,
    Modulation.QPSK: 1.0, Modulation.D8PSK: 1.1, Modulation.QAM8: 1.1,
    Modulation.QAM16: 1.2, Modulation.QAM32: 1.5, Modulation.QAM64: 1.8,
    Modulation.QAM256: 2.5,
}

QAM16_THRESHOLD = 0.6324555320336759   # 2/sqrt(10)
QAM64_D2 = 0.3086067
QAM64_D4 = 0.6172134
QAM256_D2 = 0.1290994
QAM256_D4 = 0.2581989
QAM256_D8 = 0.5163978

_WEAK = 1e-6


@functools.lru_cache(maxsize=None)
def _points_on(mod: Modulation, device: torch.device) -> torch.Tensor:
    """The constellation of ``mod`` on ``device``, made once per device: a
    host-to-device copy on every call would synchronise the stream."""
    return torch.as_tensor(con.table(mod), device=device)


@functools.lru_cache(maxsize=None)
def _qam32_on(device: torch.device):
    """(points [32] c64, bit masks [5, 32] bool) of the QAM32 demapper on
    ``device``."""
    pts, bits = con.qam32_points_and_bits()
    masks = [(bits & (1 << (4 - b))) != 0 for b in range(5)]
    return (torch.as_tensor(pts, device=device),
            torch.as_tensor(np.stack(masks), device=device))


def clip_llr(llr: torch.Tensor) -> torch.Tensor:
    """Clip to +-10 and enforce minimum magnitude 0.5 preserving sign
    (soft_demap.hpp:22-29)."""
    c = torch.clamp(llr, -MAX_LLR, MAX_LLR)
    small = c.abs() < MIN_LLR_MAG
    floor = torch.where(c >= 0, MIN_LLR_MAG, -MIN_LLR_MAG).to(c.dtype)
    return torch.where(small, floor, c)


def hard_decision(mod: Modulation, sym: torch.Tensor) -> torch.Tensor:
    """Nearest constellation point per symbol."""
    pts = _points_on(mod, sym.device)
    d2 = (torch.square(sym.real[..., None] - pts.real)
          + torch.square(sym.imag[..., None] - pts.imag))
    return pts[torch.argmin(d2, dim=-1)]


# ---------------------------------------------------------------------------
# Coherent demappers
# ---------------------------------------------------------------------------

def demap_bpsk(sym, nv):
    return clip_llr(-2.0 * sym.real / nv)[..., None]


def demap_qpsk(sym, nv):
    scale = -2.0 * con.QPSK_SCALE / nv
    return clip_llr(torch.stack([sym.real * scale, sym.imag * scale], dim=-1))


def demap_qam16(sym, nv):
    I, Q = sym.real, sym.imag
    s = 2.0 / nv
    return clip_llr(torch.stack([
        -s * I, s * (I.abs() - QAM16_THRESHOLD),
        -s * Q, s * (Q.abs() - QAM16_THRESHOLD)], dim=-1))


def demap_qam32(sym, nv):
    """Brute-force max-log-MAP over the 32-point constellation
    (soft_demap.hpp:68-121)."""
    pts, masks = _qam32_on(sym.device)
    d2 = (sym[..., None] - pts).abs() ** 2                    # [..., 32]
    s = 2.0 / nv
    inf = torch.full((), math.inf, dtype=d2.dtype, device=d2.device)
    llrs = []
    for b in range(5):
        mask = masks[b]
        d1 = torch.where(mask, d2, inf).amin(-1)
        d0 = torch.where(mask, inf, d2).amin(-1)
        llrs.append(s * (d1 - d0))
    return clip_llr(torch.stack(llrs, dim=-1))


def demap_qam64(sym, nv):
    I, Q = sym.real, sym.imag
    s = 2.0 / nv
    return clip_llr(torch.stack([
        -s * I,
        s * (I.abs() - QAM64_D4),
        s * ((I.abs() - QAM64_D4).abs() - QAM64_D2),
        -s * Q,
        s * (Q.abs() - QAM64_D4),
        s * ((Q.abs() - QAM64_D4).abs() - QAM64_D2)], dim=-1))


def demap_qam256(sym, nv):
    I, Q = sym.real, sym.imag
    s = 2.0 / nv

    def chain(x):
        a1 = x.abs() - QAM256_D8
        a2 = a1.abs() - QAM256_D4
        a3 = a2.abs() - QAM256_D2
        return [-s * x, s * a1, s * a2, s * a3]

    return clip_llr(torch.stack(chain(I) + chain(Q), dim=-1))


# ---------------------------------------------------------------------------
# Differential demappers (prev-symbol comparisons)
# ---------------------------------------------------------------------------

def demap_dbpsk(sym, prev, nv):
    diff = sym * prev.conj()
    sp = sym.abs() * prev.abs()
    phase = torch.atan2(diff.imag, diff.real)
    llr = clip_llr(2.0 * sp * torch.cos(phase) / nv)
    return torch.where(sp < _WEAK, 0.0, llr)[..., None]


def demap_dqpsk(sym, prev, nv):
    """2 LLRs: sin(phase+pi/4) and cos(2*phase) metrics
    (soft_demap.hpp:192-213)."""
    diff = sym * prev.conj()
    phase = torch.atan2(diff.imag, diff.real)
    sp = sym.abs() * prev.abs()
    scale = 2.0 * sp / nv
    llrs = torch.stack([clip_llr(scale * torch.sin(phase + math.pi / 4)),
                        clip_llr(scale * torch.cos(2 * phase))], dim=-1)
    return torch.where((sp < _WEAK)[..., None], 0.0, llrs)


def demap_d8psk(sym, prev, nv):
    diff = sym * prev.conj()
    phase = torch.atan2(diff.imag, diff.real)
    sp = sym.abs() * prev.abs()
    conf = sp / nv
    llrs = torch.stack([clip_llr(conf * torch.sin(phase)),
                        clip_llr(conf * torch.sin(2.0 * phase)),
                        clip_llr(conf * torch.sin(4.0 * phase))], dim=-1)
    return torch.where((sp < _WEAK)[..., None], 0.0, llrs)


_COHERENT = {
    Modulation.BPSK: demap_bpsk,
    Modulation.QPSK: demap_qpsk,
    Modulation.QAM16: demap_qam16,
    Modulation.QAM32: demap_qam32,
    Modulation.QAM64: demap_qam64,
    Modulation.QAM256: demap_qam256,
}

_DIFFERENTIAL = {
    Modulation.DBPSK: demap_dbpsk,
    Modulation.DQPSK: demap_dqpsk,
    Modulation.D8PSK: demap_d8psk,
}


def demap(mod: Modulation, sym, nv, prev=None):
    """Dispatch: [..., C] symbols -> [..., C, bits] LLRs."""
    if mod in _DIFFERENTIAL:
        return _DIFFERENTIAL[mod](sym, prev, nv)
    return _COHERENT.get(mod, demap_qpsk)(sym, nv)

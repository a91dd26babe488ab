"""Delay-domain channel-model retry for coherent pilot plans (port of
projectultra_tpu/ofdm/delay_fit.py; no reference counterpart).

The pilot-tracked estimator interpolates the channel linearly between
pilots, which mis-fits the notches of a frequency-selective (Watterson)
channel.  This second pass fits the physical model instead: per-symbol
pilot LS estimates, common-phase derotated and smoothed over 5 symbols;
matching pursuit of K = 3 path delays on a 1-sample grid of -60..120
samples against the frame-averaged pilot response, refit jointly after
each pick; a ridge LS projection of every symbol's smoothed pilots onto
the K-tap subspace; MMSE equalization and demap with the production
fade-erasure and clipping rules.  The engine runs it only after a failed
decode.

The 1x1/2x2/3x3 Hermitian solves are closed Cramer/adjugate forms, as in
the JAX module (no batched linear-algebra call).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import ModemConfig, Modulation, bits_per_symbol
from ..device import host_table
from . import carriers as carriers_mod
from . import demodulator as demod_mod
from ..ops import demap as demap_ops

TAU_GRID = np.arange(-60.0, 121.0, 1.0)   # delay grid, samples at fs
K_TAPS = 3                                # matching-pursuit model order
RIDGE = 0.1                               # absolute ridge (Gram diag = Np)
SMOOTH_W = 5                              # pilot time-smoothing window
TAU_EXCLUDE = 2                           # min tau separation, samples


@functools.lru_cache(maxsize=None)
def _host_tables(config: ModemConfig):
    """(FG real, FG imag [Np, G], pilot bins [Np], data bins [Cd]) f32:
    the delay grid's pilot responses exp(-2j pi k tau / N)."""
    cm = carriers_mod.carrier_map(config)
    kp = np.asarray(cm.pilot_k, np.float64)
    N = config.fft_size
    FG = np.exp(-2j * np.pi * kp[:, None] * TAU_GRID[None, :] / N)
    return (FG.real.astype(np.float32), FG.imag.astype(np.float32),
            kp.astype(np.float32), np.asarray(cm.data_k, np.float32))


@functools.lru_cache(maxsize=None)
def _smooth_matrix(S: int) -> np.ndarray:
    """[S, S] moving-average operator with exact edge normalization."""
    sm = np.zeros((S, S), np.float32)
    half = SMOOTH_W // 2
    for s in range(S):
        lo, hi = max(0, s - half), min(S, s + half + 1)
        sm[s, lo:hi] = 1.0 / (hi - lo)
    return sm


def _tau_grid() -> np.ndarray:
    return TAU_GRID.astype(np.float32)


def _solve_herm(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for Hermitian positive-definite A of size 1-3.

    A: [B, k, k] complex, b: [B, k, M] complex -> [B, k, M], by the
    explicit Cramer/adjugate forms of the JAX module."""
    k = A.shape[-1]
    if k == 1:
        return b / A[:, 0:1, 0:1]
    if k == 2:
        a, bb = A[:, 0, 0], A[:, 0, 1]
        c, d = A[:, 1, 0], A[:, 1, 1]
        det = (a * d - bb * c)[:, None]
        x0 = (d[:, None] * b[:, 0] - bb[:, None] * b[:, 1]) / det
        x1 = (-c[:, None] * b[:, 0] + a[:, None] * b[:, 1]) / det
        return torch.stack([x0, x1], dim=1)
    a00, a01, a02 = A[:, 0, 0], A[:, 0, 1], A[:, 0, 2]
    a10, a11, a12 = A[:, 1, 0], A[:, 1, 1], A[:, 1, 2]
    a20, a21, a22 = A[:, 2, 0], A[:, 2, 1], A[:, 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = (a00 * c00 + a01 * c10 + a02 * c20)[:, None]
    x0 = (c00[:, None] * b[:, 0] + c01[:, None] * b[:, 1]
          + c02[:, None] * b[:, 2]) / det
    x1 = (c10[:, None] * b[:, 0] + c11[:, None] * b[:, 1]
          + c12[:, None] * b[:, 2]) / det
    x2 = (c20[:, None] * b[:, 0] + c21[:, None] * b[:, 1]
          + c22[:, None] * b[:, 2]) / det
    return torch.stack([x0, x1, x2], dim=1)


def _taps(kb: torch.Tensor, t: torch.Tensor, N: int) -> torch.Tensor:
    """exp(-2j pi k tau / N) for bins kb [K] and delays t [B, k] ->
    [B, K, k]."""
    ph = (-2.0 * math.pi / N) * kb[None, :, None] * t[:, None, :]
    return torch.complex(torch.cos(ph), torch.sin(ph))


def demod_delayfit(config: ModemConfig, mod: Modulation, fd: torch.Tensor,
                   n_bits: int) -> torch.Tensor:
    """Second-pass demod from raw used bins: [B, S, Cu] -> LLRs
    [B, n_bits]."""
    cm = carriers_mod.carrier_map(config)
    Cd, Np = len(cm.data_idx), len(cm.pilot_idx)
    B, S, _ = fd.shape
    N = config.fft_size
    dev = fd.device
    FGr, FGi, kp, kd = host_table(dev, _host_tables, config)
    FG = torch.complex(FGr, FGi)                              # [Np, G]
    grid = host_table(dev, _tau_grid)
    pilot_seq = demod_mod._carrier_consts(config, dev)[3]

    h_ls = fd[:, :, Cd:] / pilot_seq[None, None, :]           # [B, S, Np]

    # Common-phase derotation against symbol 0 (a residual CFO would bias
    # a time average of complex estimates).
    rot_raw = (h_ls * h_ls[:, :1].conj()).sum(-1)             # [B, S]
    rot = rot_raw / torch.clamp(rot_raw.abs(), min=1e-30)
    hd = h_ls * rot.conj()[..., None]

    SM = host_table(dev, _smooth_matrix, S).to(torch.complex64)
    Hp = torch.einsum("st,btp->bsp", SM, hd)                  # smoothed
    hbar = hd.mean(1)                                         # [B, Np]

    # Matching pursuit over the delay grid (K_TAPS unrolled picks).
    G = FG.shape[1]
    FGc = FG.conj()
    r = hbar
    taus = []
    banned = torch.zeros((B, G), dtype=torch.bool, device=dev)
    F = A = t = None
    for _ in range(K_TAPS):
        c = (r @ FGc) / Np                                    # [B, G]
        score = torch.where(banned, -1.0, c.abs())
        idx = torch.argmax(score, dim=-1)                     # [B]
        tau = grid[idx]
        taus.append(tau)
        banned = banned | ((grid[None, :] - tau[:, None]).abs()
                           <= TAU_EXCLUDE)
        t = torch.stack(taus, dim=-1)                         # [B, k]
        F = _taps(kp, t, N)                                   # [B, Np, k]
        eye = torch.eye(len(taus), dtype=torch.complex64, device=dev)
        A = torch.einsum("bpj,bpk->bjk", F.conj(), F) + RIDGE * eye[None]
        rhs = torch.einsum("bpk,bp->bk", F.conj(), hbar)[..., None]
        a = _solve_herm(A, rhs)[..., 0]                       # [B, k]
        r = hbar - torch.einsum("bpk,bk->bp", F, a)

    # Per-symbol ridge projection onto the fitted tap subspace.
    Ainv_rhs = torch.einsum("bpk,bsp->bsk", F.conj(), Hp)     # [B, S, K]
    a_s = _solve_herm(A, Ainv_rhs.transpose(1, 2))            # [B, K, S]
    Fd = _taps(kd, t, N)                                      # [B, Cd, K]
    Hd_m = torch.einsum("bdk,bks->bsd", Fd, a_s)              # [B, S, Cd]
    Hp_m = torch.einsum("bpk,bks->bsp", F, a_s)               # [B, S, Np]

    # Noise per symbol from the model residual at the pilots.
    nv_t = torch.clamp(((hd - Hp_m).abs() ** 2).mean(-1), min=1e-6)

    # Re-rotate the model and MMSE-equalize with the production rules.
    Hd_m = Hd_m * rot[..., None]
    hp = Hd_m.abs() ** 2
    nv = nv_t[..., None]
    eq = Hd_m.conj() * fd[:, :, :Cd] / torch.clamp(hp + nv, min=1e-30)
    cnv = torch.clamp(nv / (hp + 1e-6), demod_mod.MIN_CARRIER_NOISE_VAR,
                      demod_mod.MAX_CARRIER_NOISE_VAR)
    avg_hp = hp.mean(-1, keepdim=True)
    cnv = torch.where(hp < demod_mod.FADE_THRESHOLD_RATIO * avg_hp,
                      demod_mod.MAX_CARRIER_NOISE_VAR, cnv)
    cnv = cnv * demap_ops.CE_MARGIN.get(mod, 1.0)
    llrs = demap_ops.demap(mod, eq.reshape(B, -1), cnv.reshape(B, -1))
    return llrs.reshape(B, -1)[:, :n_bits]


def span_fd(config: ModemConfig, mod: Modulation, span: torch.Tensor,
            cfo_hz, initial_phase, n_lts: int, S: int, lead: int = 0,
            tail: int = 0, front: str = "analytic") -> torch.Tensor:
    """Raw per-symbol used bins of a Cox span: [B, T] real -> [B, S, Cu].

    The conversion, slicing and mixer bookkeeping of ``demodulate_span``,
    rect window, with the per-symbol pilot tracking on so that the CFO and
    timing corrections in fd are the first pass's."""
    lts, data = demod_mod._span_segments(config, mod, span, n_lts, S, lead,
                                         tail, front)
    plen = config.fft_size + config.cyclic_prefix
    d0 = n_lts * plen
    L = config.symbol_duration
    state = demod_mod.init_state(config, span.shape[0], cfo_hz,
                                 initial_phase, span.device)
    state = demod_mod.estimate_channel_from_lts(config, state, lts,
                                                t0_base=plen, t0_stride=0)
    has_pilots = len(carriers_mod.carrier_map(config).pilot_idx) > 0
    fds = []
    for s in range(S):
        fd, state = demod_mod.to_baseband_fd(config, state, data[:, s],
                                             d0 + s * L)
        if has_pilots:
            state = demod_mod.update_channel_estimate(config, state, fd)
        fds.append(fd)
    return torch.stack(fds, dim=1)


def demodulate_span_delayfit(config: ModemConfig, mod: Modulation,
                             span: torch.Tensor, cfo_hz, initial_phase,
                             n_lts: int, S: int, lead: int = 0,
                             tail: int = 0, front: str = "analytic",
                             n_bits: int | None = None) -> torch.Tensor:
    """Full delay-model second pass over a span -> LLRs [B, n_bits]."""
    if n_bits is None:
        cm = carriers_mod.carrier_map(config)
        n_bits = S * len(cm.data_idx) * bits_per_symbol(mod)
    fd = span_fd(config, mod, span, cfo_hz, initial_phase, n_lts, S,
                 lead=lead, tail=tail, front=front)
    return demod_delayfit(config, mod, fd, n_bits)

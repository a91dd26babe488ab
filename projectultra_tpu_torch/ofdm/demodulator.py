"""Batched OFDM demodulator (port of projectultra_tpu/ofdm/demodulator.py;
reference src/ofdm/{demodulator.cpp, channel_equalizer.cpp}).

Three receivers over the same per-symbol blocks:

* the differential no-pilot fast path: with no pilots the demodulator
  state never changes over the data symbols, so all of them are analysed
  at once by one constant [S, L, C] contraction (NCO downmix x DFT rows of
  the data bins) and demapped against the previous symbol;
* the pilot-tracking scan: the reference's streaming state machine, a
  Python loop over the data symbols whose carried state is exactly the
  reference's tracked state (``DemodState``): LS pilot estimates, EMA
  channel smoothing, residual-CFO and timing-slope tracking, pilot
  interpolation, temporal noise estimation, equalize, demap.  QAM64 and
  QAM256 on a pilot plan re-demap the whole frame with per-carrier noise
  from three estimators (decision residual, interpolated pilot diffs,
  instantaneous residual).  On a card the loop runs as one replay of a
  CUDA graph captured once per shape (from the shape's second call on),
  not as ~280 launches a symbol, and DQPSK's tracking, equalization and
  demap are one hand-written kernel a symbol (``ops/cuda_track.py``);
* the coherent refined path of no-pilot plans (``_demod_coherent_refined``):
  every symbol's used bins, a dual decision-directed PLL (common phase and
  timing slope, a Python loop over the symbols), three alternating rank-1
  LS refits of the channel, and per-carrier residual noise.  On a card it
  too runs as one replay of a CUDA graph captured once per shape, not as
  ~1,500 launches a call.

Coherent modulations run on the half-scaled analytic signal
(``maybe_analytic``); QAM64/QAM256 use the folded-Tukey analysis window,
and with ``QAM256_RX = "real"`` QAM256 keeps the real passband and cancels
its conjugate image in closed form (``cancel_conjugate_image``).
``demodulate_presynced`` and ``demodulate_with_lts`` route as the JAX
functions do, quirks included (ROADMAP's reference behaviours);
``demodulate_span`` is the Schmidl-Cox receivers' entry on a span cut at
the first LTS.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..config import ModemConfig, Modulation, bits_per_symbol, is_differential
from ..device import host_table
from . import carriers as carriers_mod
from ..ops import cuda_graphs
from ..ops import demap as demap_ops
from ..ops import mixer as mixer_ops
from ..utils import metrics

# Constants from demodulator_constants.hpp / demodulator_impl.hpp.
DEFAULT_NOISE_VAR = 0.1
DEFAULT_SNR_LINEAR_FALLBACK = 31.6   # first-symbol 15 dB assumption
SNR_ALPHA = 0.3
FREQ_OFFSET_ALPHA = 0.3
CFO_ACQUISITION_SYMBOLS = 10
MAX_CFO_HZ = 90.0
TIMING_ALPHA = 0.3
PHASE_INTERP_THRESHOLD = 1.5708      # pi/2
FADE_THRESHOLD_RATIO = 0.1
MIN_CARRIER_NOISE_VAR = 1e-6
MAX_CARRIER_NOISE_VAR = 100.0

# 256QAM RX flavour: "analytic" (Hilbert front end + folded-Tukey window, no
# conjugate image by construction) or "real" (real passband + Tukey +
# closed-form image cancellation).  Read at call time, like the JAX module's
# switch of the same name, so a test can set it in both packages.
QAM256_RX = "analytic"


def _hi_order(mod: Modulation) -> bool:
    """Modulations dense enough for the folded-Tukey window and the
    high-order noise estimators; <=32QAM keeps the rect window."""
    return mod in (Modulation.QAM64, Modulation.QAM256)


class DemodState(NamedTuple):
    """OFDMDemodulator::Impl tracked state, batched on [B]."""
    freq_offset_hz: torch.Tensor          # [B] f32
    freq_offset_filtered: torch.Tensor    # [B] f32
    freq_phase: torch.Tensor              # [B] f32 CFO-correction phase accum
    channel_estimate: torch.Tensor        # [B, N] c64
    dbpsk_prev: torch.Tensor              # [B, C] c64
    pilot_phase_correction: torch.Tensor  # [B] c64
    prev_pilot_phases: torch.Tensor       # [B, Np] c64
    have_prev_pilots: torch.Tensor        # [B] bool
    carrier_phase_correction: torch.Tensor  # [B] c64
    carrier_phase_initialized: torch.Tensor  # [B] bool
    noise_variance: torch.Tensor          # [B] f32
    estimated_snr_linear: torch.Tensor    # [B] f32
    snr_symbol_count: torch.Tensor        # [B] i32
    symbols_since_sync: torch.Tensor      # [B] i32
    timing_offset_samples: torch.Tensor   # [B] f32
    eq_weights: torch.Tensor              # [B, C] c64
    rls_P: torch.Tensor                   # [B, C] f32


def init_state(config: ModemConfig, B: int, cfo_hz, initial_phase,
               device: torch.device) -> DemodState:
    """processPresynced reset (demodulator.cpp:869-905): unity channel,
    nv=0.1, CFO/phase preserved from external (chirp) estimation."""
    cm = carriers_mod.carrier_map(config)
    N, C, Np = config.fft_size, len(cm.data_idx), max(len(cm.pilot_idx), 1)
    f32, c64 = torch.float32, torch.complex64

    def full(x, shape, dtype):
        if isinstance(x, (int, float)):  # a fill, not a synchronising copy
            return torch.full(shape, x, dtype=dtype, device=device)
        t = torch.as_tensor(x, device=device).to(dtype)
        return t.expand(shape).clone()

    cfo = full(cfo_hz, (B,), f32)
    return DemodState(
        freq_offset_hz=cfo,
        freq_offset_filtered=cfo.clone(),
        freq_phase=full(initial_phase, (B,), f32),
        channel_estimate=torch.ones((B, N), dtype=c64, device=device),
        dbpsk_prev=torch.ones((B, C), dtype=c64, device=device),
        pilot_phase_correction=torch.ones((B,), dtype=c64, device=device),
        prev_pilot_phases=torch.zeros((B, Np), dtype=c64, device=device),
        have_prev_pilots=torch.zeros((B,), dtype=torch.bool, device=device),
        carrier_phase_correction=torch.ones((B,), dtype=c64, device=device),
        carrier_phase_initialized=torch.zeros((B,), dtype=torch.bool,
                                              device=device),
        noise_variance=torch.full((B,), DEFAULT_NOISE_VAR, dtype=f32,
                                  device=device),
        estimated_snr_linear=torch.ones((B,), dtype=f32, device=device),
        snr_symbol_count=torch.zeros((B,), dtype=torch.int32, device=device),
        symbols_since_sync=torch.zeros((B,), dtype=torch.int32, device=device),
        timing_offset_samples=torch.zeros((B,), dtype=f32, device=device),
        eq_weights=torch.ones((B, C), dtype=c64, device=device),
        rls_P=torch.ones((B, C), dtype=f32, device=device),
    )


# ---------------------------------------------------------------------------
# Host constant tables (numpy), re-homed from the JAX module
# ---------------------------------------------------------------------------

def _fold_ramp(config: ModemConfig, L: int) -> int:
    """Ramp length of the folded-Tukey analysis window: the usable cyclic
    slack, bounded by the CP."""
    return max(0, min(config.cyclic_prefix, L - config.fft_size))


@functools.lru_cache(maxsize=None)
def _used_bins_w(config: ModemConfig, L: int, window: str = "rect"):
    """DFT rows of the USED bins ([data..., pilot...]) as real/imag f32
    [L, Cu].  ``window="rect"`` zeroes the CP/guard region; ``"tukey"``
    is the folded Tukey window over [0, N+R) (ramps R = min(cp, L-N),
    w[n] + w[n+N] = 1), which gives the same bins for cyclic content but
    de-weights the symbol-boundary samples where Hilbert ringing lives."""
    cm = carriers_mod.carrier_map(config)
    N, cp = config.fft_size, config.cyclic_prefix
    bins = np.concatenate([np.asarray(cm.data_idx),
                           np.asarray(cm.pilot_idx)]).astype(np.float64)
    n = np.arange(L)
    if window == "tukey":
        R = _fold_ramp(config, L)
        w = np.zeros(L)
        if R > 0:
            up = np.sin(np.pi * (np.arange(R) + 0.5) / (2 * R)) ** 2
            w[:R] = up
            w[R:N] = 1.0
            w[N:N + R] = 1.0 - up
        else:
            w[:N] = 1.0
        W = w[:, None] * np.exp(-2j * np.pi
                                * np.outer((n - cp) % N, bins) / N)
    else:
        n_idx = n - cp
        live = (n_idx >= 0) & (n_idx < N)
        W = np.exp(-2j * np.pi * np.outer(n_idx % N, bins) / N)
        W = np.where(live[:, None], W, 0.0)
    return W.real.astype(np.float32), W.imag.astype(np.float32)


def n_data_bins(config: ModemConfig) -> int:
    return len(carriers_mod.carrier_map(config).data_idx)


@functools.lru_cache(maxsize=None)
def _pilot_to_data_interp(config: ModemConfig) -> np.ndarray:
    """[Cd, Np] row-stochastic linear-interpolation weights mapping
    per-PILOT noise measurements onto the data carriers by signed bin
    number (nearest-pilot clamp at the band edges)."""
    cm = carriers_mod.carrier_map(config)
    dk = np.asarray(cm.data_k, np.float64)
    pk = np.asarray(cm.pilot_k, np.float64)
    order = np.argsort(pk)
    pks = pk[order]
    W = np.zeros((len(dk), len(pk)), np.float32)
    for i, k in enumerate(dk):
        j = np.searchsorted(pks, k)
        if j == 0:
            W[i, order[0]] = 1.0
        elif j >= len(pks):
            W[i, order[-1]] = 1.0
        else:
            lo, up = pks[j - 1], pks[j]
            a = (k - lo) / (up - lo) if up > lo else 0.5
            W[i, order[j - 1]] = 1.0 - a
            W[i, order[j]] = a
    return W


@functools.lru_cache(maxsize=None)
def _used_bins_k(config: ModemConfig) -> np.ndarray:
    """Signed bin numbers of the USED bins in to_baseband_fd's
    [data..., pilot...] layout."""
    cm = carriers_mod.carrier_map(config)
    return np.concatenate([np.asarray(cm.data_k),
                           np.asarray(cm.pilot_k)]).astype(np.float32)


def _live_carrier_mask(mod: Modulation, S: int, Cd: int,
                       n_bits: int | None) -> np.ndarray:
    """[S, Cd] f32: 1 where the TX filled the carrier.  The modulator
    leaves carriers whose bits lie entirely past the input empty; their
    hard decisions (noise snapped to inner points) must not feed the
    refits or the residual noise estimates."""
    if n_bits is None:
        return np.ones((S, Cd), np.float32)
    first_bit = np.arange(S * Cd).reshape(S, Cd) * bits_per_symbol(mod)
    return (first_bit < n_bits).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _analysis_tensor(config: ModemConfig, t0_base: int, S: int):
    """conj(NCO downmix) x DFT rows of the data bins (CP region zeroed), so
    rx[b,s,c] = sum_l data[b,s,l] * corr * M[s,l,c]; real/imag f32
    [S, L, C]."""
    cm = carriers_mod.carrier_map(config)
    N, cp = config.fft_size, config.cyclic_prefix
    L = config.symbol_duration
    osc = mixer_ops.osc_fixed(config.center_freq, config.sample_rate,
                              S * L, offset=t0_base).reshape(S, L)
    n_idx = np.arange(L) - cp
    live = (n_idx >= 0) & (n_idx < N)
    W = np.exp(-2j * np.pi * np.outer(n_idx % N,
                                      np.asarray(cm.data_idx, np.float64)) / N)
    W = np.where(live[:, None], W, 0.0)                    # [L, C]
    M = np.conj(osc)[:, :, None] * W[None, :, :]
    return M.real.astype(np.float32), M.imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _bins_w_on(config: ModemConfig, L: int, device: torch.device,
               window: str = "rect"):
    Wr, Wi = _used_bins_w(config, L, window)
    return torch.from_numpy(Wr).to(device), torch.from_numpy(Wi).to(device)


@functools.lru_cache(maxsize=None)
def _carrier_consts(config: ModemConfig, device: torch.device):
    """(data_idx, pilot_idx, LTS data symbols, pilot_seq) on ``device``,
    made once per device: a host-to-device copy on every call would
    synchronise the stream."""
    cm = carriers_mod.carrier_map(config)
    Cd = len(cm.data_idx)
    return (torch.as_tensor(cm.data_idx, dtype=torch.long, device=device),
            torch.as_tensor(cm.pilot_idx, dtype=torch.long, device=device),
            torch.as_tensor(cm.sync_seq[np.arange(Cd) % len(cm.sync_seq)],
                            device=device),
            torch.as_tensor(cm.pilot_seq, device=device))


@functools.lru_cache(maxsize=None)
def _interp_arrays(config: ModemConfig):
    """Static interpolation table (demodulator.cpp:137-193): per data carrier
    the neighbouring pilot bins and blend factor.  Missing neighbours are
    encoded by clamping to the existing one with alpha forced to 0/1."""
    neg = config.num_carriers // 2
    pos = (config.num_carriers + 1) // 2
    carriers = []
    count = 0
    for i in range(-neg, pos + 1):
        if i == 0:
            continue
        fft_i = (i + config.fft_size) % config.fft_size
        carriers.append((fft_i, count % config.pilot_spacing == 0))
        count += 1
    data_bins, lower, upper, alphas, has_l, has_u = [], [], [], [], [], []
    for ci, (bin_i, is_p) in enumerate(carriers):
        if is_p:
            continue
        lo = next(((j, carriers[j][0]) for j in range(ci - 1, -1, -1)
                   if carriers[j][1]), None)
        up = next(((j, carriers[j][0]) for j in range(ci + 1, len(carriers))
                   if carriers[j][1]), None)
        a = 0.5
        if lo and up and up[0] != lo[0]:
            a = (ci - lo[0]) / (up[0] - lo[0])
        data_bins.append(bin_i)
        lower.append(lo[1] if lo else (up[1] if up else bin_i))
        upper.append(up[1] if up else (lo[1] if lo else bin_i))
        alphas.append(a)
        has_l.append(lo is not None)
        has_u.append(up is not None)
    return (np.asarray(data_bins, np.int32), np.asarray(lower, np.int32),
            np.asarray(upper, np.int32), np.asarray(alphas, np.float32),
            np.asarray(has_l), np.asarray(has_u))


class _PilotTables(NamedTuple):
    """Per-device constants of the pilot-tracking scan."""
    pilot_k: torch.Tensor          # [Np] f32 signed pilot bins
    two_pi_pilot_k: torch.Tensor   # [Np] f32 2*pi*k, rounded as the JAX f32
    two_pi_data_k: torch.Tensor    # [Cd] f32
    interp_bins: torch.Tensor      # [Ci] long
    interp_lo: torch.Tensor        # [Ci] long
    interp_up: torch.Tensor        # [Ci] long
    interp_a: torch.Tensor         # [1, Ci] f32
    interp_both: torch.Tensor      # [1, Ci] bool
    interp_only_l: torch.Tensor    # [1, Ci] bool


@functools.lru_cache(maxsize=None)
def _pilot_tables(config: ModemConfig, device: torch.device) -> _PilotTables:
    """The scan's constant tables on ``device``, made once per device (a
    host-to-device copy on every symbol would synchronise the stream)."""
    cm = carriers_mod.carrier_map(config)
    two_pi = np.float32(2.0 * np.pi)
    bins, lo, up, a, has_l, has_u = _interp_arrays(config)

    def on(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return _PilotTables(
        pilot_k=on(np.asarray(cm.pilot_k, np.float32)),
        two_pi_pilot_k=on(two_pi * np.asarray(cm.pilot_k, np.float32)),
        two_pi_data_k=on(two_pi * np.asarray(cm.data_k, np.float32)),
        interp_bins=on(bins, torch.long), interp_lo=on(lo, torch.long),
        interp_up=on(up, torch.long), interp_a=on(a[None]),
        interp_both=on((has_l & has_u)[None]),
        interp_only_l=on((has_l & ~has_u)[None]))


# ---------------------------------------------------------------------------
# Analytic front end
# ---------------------------------------------------------------------------

def analytic_half(samples: torch.Tensor) -> torch.Tensor:
    """Positive-frequency part of a real passband signal (analytic/2): the
    same amplitude as the real signal's +f content, image-free.  No-op for
    complex input."""
    if samples.is_complex():
        return samples
    from ..sync.schmidl_cox import analytic_signal  # imports this module
    return (0.5 * analytic_signal(samples)).to(torch.complex64)


def maybe_analytic(mod: Modulation, samples: torch.Tensor,
                   front: str = "analytic") -> torch.Tensor:
    """``analytic_half`` for COHERENT modulations, whose decision
    boundaries cannot absorb the ICI a real passband's negative-frequency
    image leaks under CFO; differential modes, ``front="real"`` and QAM256
    with ``QAM256_RX == "real"`` keep the real passband."""
    if front == "real" or is_differential(mod) or (
            mod == Modulation.QAM256 and QAM256_RX == "real"):
        return samples
    return analytic_half(samples)


@functools.lru_cache(maxsize=None)
def _edge_taper(T: int, lead: int, tail: int,
                device: torch.device) -> torch.Tensor:
    w = np.ones(T, np.float32)
    if lead > 0:
        w[:lead] = np.sin(np.pi * (np.arange(lead) + 0.5) / (2 * lead)) ** 2
    if tail > 0:
        w[T - tail:] = np.sin(
            np.pi * (np.arange(tail)[::-1] + 0.5) / (2 * tail)) ** 2
    return torch.from_numpy(w).to(device)


def _edge_tapered(mod: Modulation, span: torch.Tensor, lead: int,
                  tail: int) -> torch.Tensor:
    """Raised-cosine taper over the lead/tail MARGIN samples of a real span
    before the Hilbert FFT, which treats the span as circular: the taper
    removes the wrap discontinuity whose ringing would reach the first LTS.
    Differential modes never convert and are left untouched."""
    if is_differential(mod) or (lead == 0 and tail == 0):
        return span
    return span * _edge_taper(span.shape[-1], lead, tail, span.device)[None, :]


# ---------------------------------------------------------------------------
# Per-symbol front end and LTS channel estimate
# ---------------------------------------------------------------------------

def _cfo_active(freq_offset_hz: torch.Tensor) -> torch.Tensor:
    return freq_offset_hz.abs() > 0.01


def _dirichlet(x: torch.Tensor, R: int, N: int) -> torch.Tensor:
    """D_R(x) = sum_{n=0}^{R-1} e^{-j*2pi*n*x/N}, safe at x = 0 (-> R)."""
    mag = R * torch.sinc(R * x / N) / torch.sinc(x / N)
    ang = -(math.pi * (R - 1) / N) * x
    return torch.complex(mag * torch.cos(ang), mag * torch.sin(ang))


def cancel_conjugate_image(config: ModemConfig, state: DemodState,
                           fd: torch.Tensor, t0: int, L: int) -> torch.Tensor:
    """Closed-form cancellation of a REAL passband's conjugate image in
    the [B, Cu] used bins of one folded-Tukey window (demodulator.py:259-329
    of the JAX package, which derives it): fd = clean + K conj(clean) with
    K[b,k,m] = e^{j Gamma_b} / N e^{j 2pi cp (k_k + k_m)/N} E_w(nu[b,m] + k_k),
    inverted to second order, w = fd - K conj(fd), clean ~ w + K conj(K w)."""
    N, cp = config.fft_size, config.cyclic_prefix
    fs, fc = config.sample_rate, config.center_freq
    R = _fold_ramp(config, L)
    k = host_table(fd.device, _used_bins_k, config)                 # [Cu]

    active = _cfo_active(state.freq_offset_hz)
    d_hat = torch.where(active, state.freq_offset_hz, 0.0)        # [B]
    fp = torch.where(active, state.freq_phase, 0.0)               # [B]

    # Exact 2*pi*fc*t0/fs mod 2*pi by integer-modular arithmetic, rounded
    # as the JAX float32 product.
    num = (fc * (int(t0) % fs)) % fs
    phi0 = float(np.float32(2.0 * np.pi / fs) * np.float32(num))

    nu = (2.0 * fc + 2.0 * d_hat[:, None]) * (N / fs) + k[None, :]  # [B, Cu]
    x = nu[:, None, :] + k[None, :, None]                         # [B, k, m]
    gamma = 2.0 * fp - 2.0 * phi0                                 # [B]

    EN = _dirichlet(x, N, N)
    if R > 0:
        half = N / (2.0 * R)
        rot = complex(np.complex64(np.exp(1j * np.pi / (2.0 * R))))
        G = (0.5 * _dirichlet(x, R, N)
             + 0.25 * (rot * _dirichlet(x - half, R, N)
                       + rot.conjugate() * _dirichlet(x + half, R, N)))
        tx2pi = 2.0 * math.pi * x
        one_m = 1.0 - torch.complex(torch.cos(tx2pi), -torch.sin(tx2pi))
        Ew = EN - one_m * G
    else:
        Ew = EN

    ang = (gamma[:, None, None]
           + (2.0 * math.pi * cp / N) * (k[None, :, None] + k[None, None, :]))
    K = (1.0 / N) * torch.complex(torch.cos(ang), torch.sin(ang)) * Ew

    def mv(A, v):
        return torch.einsum("bkm,bm->bk", A, v)

    w = fd - mv(K, fd.conj())
    return w + mv(K, mv(K, w.conj()).conj())


def to_baseband_fd(config: ModemConfig, state: DemodState,
                   sym_samples: torch.Tensor, t0: int,
                   image_cancel: bool = False, taper: bool = False,
                   bins_w=None, osc: torch.Tensor | None = None):
    """toBaseband + extractSymbol (channel_equalizer.cpp:19-71) for one
    symbol: [B, L] real or analytic passband -> [B, Cu] USED bins laid out
    [data..., pilot...].  ``t0`` is the window's sample index since the
    last mixer reset.  Advances the CFO-correction phase by L samples (only
    when |cfo| > 0.01, like the C++).  ``taper`` or ``image_cancel`` selects
    the folded-Tukey window, ``image_cancel`` also cancels the conjugate
    image.  ``bins_w`` are the rectangular window's ``_used_bins_w``
    tensors when the caller holds them (otherwise they, and always the
    Tukey rows, are looked up by device); ``osc`` is the mixer's [L]
    oscillator at ``t0`` when the caller already has it."""
    L = sym_samples.shape[-1]
    dev = sym_samples.device
    if osc is None:
        t = t0 + torch.arange(L, dtype=torch.int32, device=dev)
        osc = mixer_ops.osc_int(config.center_freq, config.sample_rate, t)

    phase_inc = float(np.float32(-2.0 * np.pi / config.sample_rate)) \
        * state.freq_offset_hz
    i = torch.arange(L, dtype=torch.float32, device=dev)
    corr_phase = state.freq_phase[:, None] + phase_inc[:, None] * i
    corr = torch.polar(torch.ones_like(corr_phase), corr_phase)
    active = _cfo_active(state.freq_offset_hz)[:, None]
    corr = torch.where(active, corr, torch.ones((), dtype=torch.complex64,
                                                device=dev))

    z = sym_samples.to(torch.complex64) * osc.conj()[None, :] * corr
    tukey = image_cancel or taper
    if bins_w is None or tukey:
        bins_w = _bins_w_on(config, int(L), dev,
                            "tukey" if tukey else "rect")
    Wr, Wi = bins_w
    fd = torch.complex(z.real @ Wr - z.imag @ Wi, z.real @ Wi + z.imag @ Wr)
    if image_cancel:
        fd = cancel_conjugate_image(config, state, fd, t0, int(L))

    new_phase = torch.where(
        active[:, 0],
        torch.remainder(state.freq_phase + phase_inc * L + math.pi,
                        2 * math.pi) - math.pi,
        state.freq_phase)
    return fd, state._replace(freq_phase=new_phase)


def estimate_channel_from_lts(config: ModemConfig, state: DemodState,
                              training: torch.Tensor, t0_base: int = 0,
                              t0_stride: int | None = None,
                              image_cancel: bool = False,
                              taper: bool = False,
                              bins_w=None) -> DemodState:
    """(channel_equalizer.cpp:77-328): LS estimates from each training
    symbol; data carriers take the LAST symbol's H, pilots the average;
    SNR seeded from |H|avg^2 / noise_variance.

    training: [B, n_sym, L] (L may be N+CP for the guard-less preamble
    LTS).  Symbol s demixes at mixer time t0_base + s * t0_stride; the
    default stride L is contiguously mixed training (the chirp path's).
    The Cox preamble mixed ONE LTS at [plen, 2*plen) and repeated it, so
    its symbols demix at t0_base=plen with stride 0: otherwise the two
    estimates differ by 2*pi*fc*plen/fs (pi at the default plan) and the
    pilot average cancels.  ``image_cancel`` and ``taper`` choose the
    window as in ``to_baseband_fd``."""
    cm = carriers_mod.carrier_map(config)
    B, n_sym, L = training.shape
    stride = L if t0_stride is None else t0_stride
    dev = training.device
    Cd = len(cm.data_idx)
    data_idx, pilot_idx, tx_data, pilot_seq = _carrier_consts(config, dev)

    h_data_last = None
    h_pilot_sum = torch.zeros((B, max(len(cm.pilot_idx), 1)),
                              dtype=torch.complex64, device=dev)
    for s in range(n_sym):
        fd, state = to_baseband_fd(config, state, training[:, s],
                                   t0_base + s * stride,
                                   image_cancel=image_cancel, taper=taper,
                                   bins_w=bins_w)
        h_data_last = fd[:, :Cd] / tx_data[None, :]
        if len(cm.pilot_idx):
            h_pilot_sum = h_pilot_sum + fd[:, Cd:] / pilot_seq[None, :]

    ce = state.channel_estimate.clone()
    ce[:, data_idx] = h_data_last
    if len(cm.pilot_idx):
        ce[:, pilot_idx] = h_pilot_sum / n_sym

    h_mag_avg = h_data_last.abs().mean(-1)
    snr = torch.clamp(h_mag_avg ** 2 / torch.clamp(state.noise_variance,
                                                   min=1e-10),
                      0.1, 10000.0)
    ok = (h_mag_avg > 1e-6) & (state.noise_variance > 1e-10)
    snr = torch.where(ok, snr, state.estimated_snr_linear)

    return state._replace(
        channel_estimate=ce,
        estimated_snr_linear=snr,
        snr_symbol_count=torch.full_like(state.snr_symbol_count, n_sym),
        eq_weights=h_data_last,
    )


# ---------------------------------------------------------------------------
# All-symbols-at-once differential demod (no pilots)
# ---------------------------------------------------------------------------

def any_cfo(cfo_hz) -> bool:
    """Host decision whether any lane needs the CFO correction: the Python
    value itself for a scalar, one device read for a tensor."""
    if isinstance(cfo_hz, (int, float)):
        return abs(cfo_hz) > 0.01
    return bool((torch.as_tensor(cfo_hz).abs() > 0.01).any().item())


def _demod_differential_parallel(config: ModemConfig, mod: Modulation,
                                 state: DemodState, data: torch.Tensor,
                                 analysis, with_cfo: bool) -> torch.Tensor:
    """[B, S, L] real passband or analytic data symbols -> [B, S*C*bits]
    LLRs.

    ``analysis`` is the (Mr, Mi) [S, L, C] pair of ``_analysis_tensor`` at
    the data's mixer offset; ``with_cfo`` selects the per-sample CFO
    rotation (decided on the host, see ``any_cfo``)."""
    B, S, L = data.shape
    dev = data.device
    Mr, Mi = analysis

    def ee(x, M):
        return torch.einsum("bsl,slc->bsc", x, M)

    dr, di = (data.real, data.imag) if data.is_complex() else (data, None)
    if with_cfo:
        cfo = state.freq_offset_hz
        phase_inc = float(np.float32(-2.0 * np.pi / config.sample_rate)) * cfo
        i_all = torch.arange(S * L, dtype=torch.float32,
                             device=dev).reshape(S, L)
        corr_phase = (state.freq_phase[:, None, None]
                      + phase_inc[:, None, None] * i_all[None])
        act = _cfo_active(cfo)[:, None, None]
        corr_phase = torch.where(act, corr_phase, 0.0)
        c_ph, s_ph = torch.cos(corr_phase), torch.sin(corr_phase)
        zr = dr * c_ph if di is None else dr * c_ph - di * s_ph
        zi = dr * s_ph if di is None else dr * s_ph + di * c_ph
        rx = torch.complex(ee(zr, Mr) - ee(zi, Mi), ee(zr, Mi) + ee(zi, Mr))
    elif di is None:
        rx = torch.complex(ee(dr, Mr), ee(dr, Mi))            # [B, S, C]
    else:
        rx = torch.complex(ee(dr, Mr) - ee(di, Mi), ee(dr, Mi) + ee(di, Mr))

    didx = _carrier_consts(config, dev)[0]
    h = state.channel_estimate[:, None, didx]
    hp = h.abs() ** 2
    good = hp > 1e-6
    ppc = state.pilot_phase_correction[:, None, None]
    eq = torch.where(good, rx * h.conj() / torch.clamp(hp, min=1e-30),
                     rx) * ppc
    nv = state.noise_variance[:, None, None]
    cnv = torch.where(good, nv / torch.clamp(hp, min=1e-30),
                      MAX_CARRIER_NOISE_VAR)
    cnv = torch.clamp(cnv, MIN_CARRIER_NOISE_VAR, MAX_CARRIER_NOISE_VAR)

    prev = torch.cat([state.dbpsk_prev[:, None, :], eq[:, :-1, :]], dim=1)
    nv_eff = cnv * demap_ops.CE_MARGIN.get(mod, 1.0)
    llrs = demap_ops.demap(mod, eq, nv_eff, prev=prev)
    return llrs.reshape(B, -1)


# ---------------------------------------------------------------------------
# Pilot tracking, equalization and demapping of one symbol
# ---------------------------------------------------------------------------

def _unit(B: int, dev: torch.device) -> torch.Tensor:
    return torch.ones((B, 1), dtype=torch.complex64, device=dev)


def _interpolate_channel(config: ModemConfig,
                         ce: torch.Tensor) -> torch.Tensor:
    """interpolateChannel (channel_equalizer.cpp:601-631): linear between
    pilots, nearest-pilot when the inter-pilot phase jump exceeds pi/2.
    Returns a new [B, N] estimate; ``ce`` is not written."""
    pt = _pilot_tables(config, ce.device)
    if pt.interp_bins.numel() == 0:
        return ce
    H1 = ce[:, pt.interp_lo]
    H2 = ce[:, pt.interp_up]
    pd = H2 * H1.conj()
    phase_diff = torch.atan2(pd.imag, pd.real).abs()
    a = pt.interp_a
    lin = (1.0 - a) * H1 + a * H2
    nearest = torch.where(a < 0.5, H1, H2)
    interp = torch.where(phase_diff > PHASE_INTERP_THRESHOLD, nearest, lin)
    val = torch.where(pt.interp_both, interp,
                      torch.where(pt.interp_only_l, H1, H2))
    out = ce.clone()
    out[:, pt.interp_bins] = val
    return out


def update_channel_estimate(config: ModemConfig, state: DemodState,
                            fd: torch.Tensor) -> DemodState:
    """Pilot-based per-symbol tracking (channel_equalizer.cpp:330-595): LS
    pilot estimates, EMA channel smoothing, temporal noise estimation,
    residual-CFO and timing-slope tracking, pilot interpolation.  ``fd`` is
    the [B, Cu] used-bins layout of ``to_baseband_fd``.

    The carrier phase correction stays 1 (the JAX package's deliberate
    deviation from channel_equalizer.cpp:348-363).  The coherent timing fix
    reads ``config.modulation``, not the modulation being demodulated, as
    the JAX function does (the default plan's QPSK applies it to DQPSK
    too).  Every branch is a tensor select: nothing is read to the host."""
    cm = carriers_mod.carrier_map(config)
    if len(cm.pilot_idx) == 0:
        return state
    dev = fd.device
    B = fd.shape[0]
    data_idx, pilot_idx, _, pilot_seq = _carrier_consts(config, dev)
    pt = _pilot_tables(config, dev)
    N = config.fft_size

    alpha = torch.where(state.snr_symbol_count == 0, 1.0, 0.9)[:, None]
    h_ls = fd[:, len(cm.data_idx):] / pilot_seq[None, :]          # [B, Np]
    hl2 = h_ls.abs() ** 2
    signal_power = hl2.mean(-1)

    # Temporal noise estimate against the previous symbol's pilots.
    prev = state.prev_pilot_phases
    pv2 = prev.abs() ** 2
    have_prev = state.have_prev_pilots[:, None]
    valid = (pv2 > 1e-6) & (hl2 > 1e-6) & have_prev
    diff2 = torch.where(valid, (h_ls - prev).abs() ** 2, 0.0)
    noise_sum = diff2.sum(-1)
    noise_count = valid.sum(-1)
    noise_sum = torch.where(noise_count == 0,
                            signal_power / DEFAULT_SNR_LINEAR_FALLBACK,
                            noise_sum)
    noise_count = torch.clamp(noise_count, min=1)

    # Smoothed channel estimate at the pilots (a new tensor: the state's
    # own estimate is never written).
    ce = state.channel_estimate.clone()
    ce[:, pilot_idx] = alpha * h_ls + (1.0 - alpha) * ce[:, pilot_idx]

    # Residual CFO from the pilot phase rotation.
    d = h_ls * prev.conj()
    dmag = d.abs()
    unit_ok = (pv2 > 1e-6) & (hl2 > 1e-6) & (dmag > 1e-6) & have_prev
    unit = torch.where(unit_ok, d / torch.clamp(dmag, min=1e-30), 0.0)
    vcount = unit_ok.sum(-1)
    have_cfo = vcount > 0
    avg_diff = unit.sum(-1) / torch.clamp(vcount, min=1)
    avg_phase = torch.atan2(avg_diff.imag, avg_diff.real)
    ppc = torch.where(have_cfo,
                      torch.polar(torch.ones_like(avg_phase), -avg_phase),
                      _unit(B, dev)[:, 0])

    sym_dur = config.symbol_duration / config.sample_rate
    residual = avg_phase / (2 * np.pi * sym_dur)
    total_cfo = state.freq_offset_hz + residual
    progress = torch.clamp(state.symbols_since_sync / CFO_ACQUISITION_SYMBOLS,
                           0, 1)
    ad_alpha = 0.9 * (1 - progress) + FREQ_OFFSET_ALPHA * progress
    ad_alpha = torch.where(residual.abs() > 10.0,
                           torch.clamp(ad_alpha, min=0.9), ad_alpha)
    fof = torch.where(have_cfo,
                      ad_alpha * total_cfo
                      + (1 - ad_alpha) * state.freq_offset_filtered,
                      state.freq_offset_filtered)
    foh = torch.where(have_cfo, torch.clamp(fof, -MAX_CFO_HZ, MAX_CFO_HZ),
                      state.freq_offset_hz)
    ssc = state.symbols_since_sync + have_cfo.to(torch.int32)

    # Timing recovery: LS fit of the pilot phase slope against the bin.
    tmask = hl2 >= 1e-6
    k = pt.pilot_k[None, :]
    ph = torch.angle(h_ls)
    nvalid = tmask.sum(-1)
    sum_k = (k * tmask).sum(-1)
    sum_k2 = (k * k * tmask).sum(-1)
    sum_p = (ph * tmask).sum(-1)
    sum_kp = (k * ph * tmask).sum(-1)
    denom = nvalid * sum_k2 - sum_k * sum_k
    can_fit = (state.snr_symbol_count >= 3) & (nvalid >= 3) \
        & (denom.abs() > 1e-6)
    slope = (nvalid * sum_kp - sum_k * sum_p) \
        / torch.where(can_fit, denom, 1.0)
    inst = slope * N / (2 * np.pi)
    tos = TIMING_ALPHA * inst \
        + (1 - TIMING_ALPHA) * state.timing_offset_samples
    max_t = 50.0 * (N / 512.0)
    tos = torch.clamp(tos, -max_t, max_t)
    tos = torch.where(can_fit, tos, state.timing_offset_samples)

    # Coherent timing fix: de-rotate pilots, interpolate, re-rotate all bins.
    coherent = not is_differential(config.modulation)
    if coherent:
        tfix = (tos.abs() > 0.1)[:, None]

        def rot(two_pi_k, sign):
            kph = two_pi_k[None, :] * tos[:, None] / N
            return torch.where(tfix, torch.polar(torch.ones_like(kph),
                                                 sign * kph), _unit(B, dev))

        ce[:, pilot_idx] = ce[:, pilot_idx] * rot(pt.two_pi_pilot_k, -1.0)
    ce = _interpolate_channel(config, ce)
    if coherent:
        ce[:, pilot_idx] = ce[:, pilot_idx] * rot(pt.two_pi_pilot_k, 1.0)
        ce[:, data_idx] = ce[:, data_idx] * rot(pt.two_pi_data_k, 1.0)

    # Noise variance and SNR EMA.
    upd = (noise_count > 1) & (noise_sum > 0)
    nv = torch.where(upd, torch.clamp(noise_sum / torch.clamp(noise_count - 1,
                                                              min=1),
                                      min=1e-6),
                     state.noise_variance)
    inst_snr = torch.clamp(signal_power / torch.clamp(nv, min=1e-30),
                           0.1, 10000.0)
    snr = torch.where(upd, SNR_ALPHA * inst_snr
                      + (1 - SNR_ALPHA) * state.estimated_snr_linear,
                      state.estimated_snr_linear)

    return state._replace(
        channel_estimate=ce,
        pilot_phase_correction=ppc,
        prev_pilot_phases=h_ls,
        have_prev_pilots=torch.ones_like(state.have_prev_pilots),
        noise_variance=nv,
        estimated_snr_linear=snr,
        snr_symbol_count=state.snr_symbol_count + 1,
        symbols_since_sync=ssc,
        freq_offset_hz=foh,
        freq_offset_filtered=fof,
        timing_offset_samples=tos,
    )


def equalize(config: ModemConfig, mod: Modulation, state: DemodState,
             fd: torch.Tensor):
    """(channel_equalizer.cpp:728-855) -> (equalized [B, C] c64,
    noise_var [B, C] f32)."""
    dev = fd.device
    didx = _carrier_consts(config, dev)[0]
    rx = fd[:, :didx.shape[0]]  # the used-bins layout of to_baseband_fd
    h = state.channel_estimate[:, didx]
    hp = h.abs() ** 2
    nv = state.noise_variance[:, None]

    if is_differential(mod):
        kph = _pilot_tables(config, dev).two_pi_data_k[None, :] \
            * state.timing_offset_samples[:, None] / config.fft_size
        tc = torch.polar(torch.ones_like(kph), kph)
        ppc = state.pilot_phase_correction[:, None]
        good = hp > 1e-6
        eq = torch.where(good, rx * h.conj() / torch.clamp(hp, min=1e-30),
                         rx) * ppc * tc
        cnv = torch.where(good, nv / torch.clamp(hp, min=1e-30),
                          MAX_CARRIER_NOISE_VAR)
        return eq, torch.clamp(cnv, MIN_CARRIER_NOISE_VAR,
                               MAX_CARRIER_NOISE_VAR)

    # Coherent MMSE with deep-fade soft erasure.  With the adaptive
    # equalizer on, the LMS/RLS weights replace the pilot-tracked estimate
    # for equalization, but fades are still detected on the pilot-tracked
    # estimate (channel_equalizer.cpp:773-791).
    hp_fade = hp
    if config.adaptive_eq_enabled:
        h = state.eq_weights
        hp = h.abs() ** 2
    denom = hp + nv
    good = denom >= 1e-10
    eq = torch.where(good, h.conj() * rx / torch.clamp(denom, min=1e-30), 0.0)
    cnv = torch.where(good, torch.clamp(nv / (hp + 1e-6),
                                        MIN_CARRIER_NOISE_VAR,
                                        MAX_CARRIER_NOISE_VAR),
                      MAX_CARRIER_NOISE_VAR)
    avg_hp = hp_fade.mean(-1, keepdim=True)
    cnv = torch.where(hp_fade < FADE_THRESHOLD_RATIO * avg_hp,
                      MAX_CARRIER_NOISE_VAR, cnv)
    return eq, cnv


def dd_update(config: ModemConfig, mod: Modulation, state: DemodState,
              rx: torch.Tensor, eq: torch.Tensor) -> DemodState:
    """Decision-directed LMS/RLS weight update (channel_equalizer.cpp:705-727
    rules, :794-801 call site); ``rx`` is the un-equalized [B, C] data-bin
    spectrum."""
    if not config.decision_directed:
        return state
    d = demap_ops.hard_decision(mod, eq)
    w = state.eq_weights
    err = rx - w * d
    if config.adaptive_eq_use_rls:
        P, dn = state.rls_P, d.abs() ** 2
        lam = float(np.float32(config.rls_lambda))
        k = P / (lam + P * dn)
        w = w + k * d.conj() * err
        P = torch.clamp((P - k * dn * P) / lam, 1e-3, 1e3)
        return state._replace(eq_weights=w, rls_P=P)
    w = w + float(np.float32(config.lms_mu)) * d.conj() * err
    return state._replace(eq_weights=w)


def demodulate_symbol(config: ModemConfig, mod: Modulation, state: DemodState,
                      eq: torch.Tensor, cnv: torch.Tensor):
    """(demodulator.cpp:199-435) -> (llrs [B, C*bits], state).  The
    reference's decision-directed tracking block is inert (it reads the
    previous symbol after overwriting it), so it is omitted, as in JAX."""
    nv = cnv * demap_ops.CE_MARGIN.get(mod, 1.0)
    if is_differential(mod):
        llrs = demap_ops.demap(mod, eq, nv, prev=state.dbpsk_prev)
        state = state._replace(dbpsk_prev=eq)
    else:
        llrs = demap_ops.demap(mod, eq, nv)
    return llrs.reshape(eq.shape[0], -1), state


def _scan_windows(mod: Modulation, front: str) -> tuple[bool, bool]:
    """(image_cancel, taper) of the scan and of ``demodulate_with_lts``:
    the Tukey window for QAM64/QAM256, image cancellation for QAM256 with
    ``QAM256_RX == "real"``, neither on the real front end."""
    hi, real = _hi_order(mod), front == "real"
    return (hi and QAM256_RX == "real" and not real), (hi and not real)


#: Captures and replays of the scan's CUDA graphs (``_scan_data_symbols``
#: on a card), counted as ``cuda_ldpc.launches`` counts its kernel.
scan_captures = 0
scan_replays = 0
#: Scan graphs kept, the least recently used dropped first: a caller at
#: B = 1 (the engine) brings several shapes.
SCAN_GRAPHS = 8
#: Shapes seen once, the oldest dropped first.
SCAN_SEEN = 64
_scan_graphs = cuda_graphs.Cache(SCAN_GRAPHS, SCAN_SEEN)


def _scan_data_symbols(config: ModemConfig, mod: Modulation,
                       state: DemodState, data: torch.Tensor, t0_base: int,
                       front: str = "analytic", n_bits: int | None = None,
                       bins_w=None):
    """The symbol-by-symbol receiver over [B, S, L] data symbols starting
    at mixer time ``t0_base`` (the JAX ``lax.scan``): returns (final
    state, llrs [B, S*C*bits]).  On the CPU it is the Python loop
    ``_scan_eager``.  On a card, from the second call of a shape on, it is
    one replay of that loop captured as a CUDA graph
    (``ops/cuda_graphs.py``), which runs the same kernels in the same
    order, so its outputs are the loop's bit for bit; the state, the data
    and the caller's window rows are copied into the graph's inputs, and
    its outputs cloned out, so one call's results outlive the next.  A
    shape's first call runs the loop, so a shape met once (a station's
    frame of a new length) costs no capture.  Nothing is read to the host.
    ``bins_w`` are the rectangular window's rows when the caller holds
    them."""
    with metrics.span("ofdm.scan", data):
        if data.device.type != "cuda":
            return _scan_eager(config, mod, state, data, t0_base, front,
                               n_bits, bins_w)
        global scan_replays
        ic, taper = _scan_windows(mod, front)
        B, S, L = data.shape
        key = (config, mod, front, ic, taper, n_bits, B, S, L, int(t0_base),
               bins_w is not None, data.dtype, data.device)
        n = len(state)

        def run(*x):
            return _scan_eager(config, mod, DemodState(*x[:n]), x[n],
                               t0_base, front, n_bits, x[n + 1:] or None)

        inputs = (*state, data, *(bins_w or ()))

        def capture():
            global scan_captures
            scan_captures += 1
            return cuda_graphs.Captured(run, inputs)

        graph = _scan_graphs.get(key, capture)
        if graph is None:
            return _scan_eager(config, mod, state, data, t0_base, front,
                               n_bits, bins_w)
        scan_replays += 1
        out_state, llrs = graph(inputs)
        if _fused_tracking(config, mod, data):
            # The replay ran the tracking kernel once a symbol.
            from ..ops import cuda_track
            cuda_track.launches += S
        return DemodState(*(x.clone() for x in out_state)), llrs.clone()


def _fused_tracking(config: ModemConfig, mod: Modulation,
                    data: torch.Tensor) -> bool:
    """Whether the scan's step after ``to_baseband_fd`` runs as the
    hand-written kernel (``ops/cuda_track.py``): DQPSK on a pilot plan, on
    a card.  Its PyTorch operations are the kernel's oracle."""
    return (data.device.type == "cuda" and mod == Modulation.DQPSK
            and len(carriers_mod.carrier_map(config).pilot_idx) > 0)


def _scan_eager(config: ModemConfig, mod: Modulation, state: DemodState,
                data: torch.Tensor, t0_base: int, front: str = "analytic",
                n_bits: int | None = None, bins_w=None):
    """The scan as a Python loop over the symbols, each a fixed sequence of
    tensor operations (``_scan_data_symbols`` on the CPU, and what its CUDA
    graph captures).  DQPSK on a pilot plan on a card tracks, equalizes and
    demaps each symbol in one launch of the pilot-tracking kernel.

    QAM64/QAM256 on a pilot plan demap the whole frame again afterwards
    with per-carrier noise, the max of the scan's own, the frame's decision
    residual, the pilots' temporal diffs interpolated onto the data
    carriers, and half the instantaneous residual: the plan's DC-adjacent
    carriers carry a deterministic ICI floor that the scalar pilot noise
    averages away (demodulator.py:1258-1318 of the JAX package)."""
    B, S, L = data.shape
    dev = data.device
    has_pilots = len(carriers_mod.carrier_map(config).pilot_idx) > 0
    adaptive = config.adaptive_eq_enabled and not is_differential(mod)
    data_idx, _, _, pilot_seq = _carrier_consts(config, dev)
    Cd = data_idx.shape[0]
    ic, taper = _scan_windows(mod, front)
    hi_pilots = _hi_order(mod) and has_pilots
    t = t0_base + torch.arange(S * L, dtype=torch.int32, device=dev)
    osc = mixer_ops.osc_int(config.center_freq, config.sample_rate,
                            t).reshape(S, L)
    fused = _fused_tracking(config, mod, data)
    llrs, eqs, cnvs, h_lss, hp_ds = [], [], [], [], []
    for s in range(S):
        fd, state = to_baseband_fd(config, state, data[:, s], t0_base + s * L,
                                   image_cancel=ic, taper=taper,
                                   bins_w=bins_w, osc=osc[s])
        if fused:
            from ..ops import cuda_track
            state, sym_llrs = cuda_track.track_dqpsk_cuda(config, state, fd)
            llrs.append(sym_llrs)
            continue
        if has_pilots:
            state = update_channel_estimate(config, state, fd)
        eq, cnv = equalize(config, mod, state, fd)
        if adaptive:
            state = dd_update(config, mod, state, fd[:, :Cd], eq)
        if hi_pilots:
            # The coherent per-symbol LLRs are replaced below, and
            # demodulate_symbol changes no state for a coherent mod.
            eqs.append(eq)
            cnvs.append(cnv)
            h_lss.append(fd[:, Cd:] / pilot_seq[None, :])
            hp_ds.append(state.channel_estimate[:, data_idx].abs() ** 2)
        else:
            sym_llrs, state = demodulate_symbol(config, mod, state, eq, cnv)
            llrs.append(sym_llrs)
    if not hi_pilots:
        return state, torch.stack(llrs, dim=1).reshape(B, -1)

    eq = torch.stack(eqs, dim=1)                          # [B, S, Cd]
    cnv = torch.stack(cnvs, dim=1)
    d = demap_ops.hard_decision(mod, eq)
    live = host_table(dev, _live_carrier_mask, mod, S, Cd, n_bits)[None]
    cnt = torch.clamp(live.sum(1, keepdim=True), min=1.0)
    r = ((eq - d).abs() ** 2 * live).sum(1, keepdim=True) / cnt

    h_ls = torch.stack(h_lss, dim=1)                      # [B, S, Np]
    pd = (torch.diff(h_ls, dim=1).abs() ** 2).mean(1)     # [B, Np]
    Wn = host_table(dev, _pilot_to_data_interp, config)     # [Cd, Np]
    pn_d = pd @ Wn.T                                      # [B, Cd]
    hp = torch.clamp(torch.stack(hp_ds, dim=1).mean(1), min=1e-12)
    pcnv = (pn_d / hp)[:, None, :]

    inst = 0.5 * (eq - d).abs() ** 2
    nv_eff = torch.clamp(
        torch.maximum(torch.maximum(torch.maximum(r, pcnv), cnv), inst),
        MIN_CARRIER_NOISE_VAR, MAX_CARRIER_NOISE_VAR) \
        * demap_ops.CE_MARGIN.get(mod, 1.0)
    return state, demap_ops.demap(mod, eq, nv_eff).reshape(B, -1)


#: Captures and replays of the refined path's CUDA graphs
#: (``_demod_coherent_refined`` on a card), counted as the scan's are.
refined_captures = 0
refined_replays = 0
#: Refined graphs kept, the least recently used dropped first, and shapes
#: seen once, the oldest dropped first (as the scan's).
REFINED_GRAPHS, REFINED_SEEN = 8, 64
_refined_graphs = cuda_graphs.Cache(REFINED_GRAPHS, REFINED_SEEN)


def _refined_windows(mod: Modulation, front: str,
                     taper: bool | None) -> tuple[bool, bool]:
    """(image_cancel, taper) of the refined path: ``taper`` as the caller
    chose it (default: Tukey unless ``front == "real"``), image
    cancellation for QAM64/QAM256 with ``QAM256_RX == "real"``."""
    if taper is None:
        taper = front != "real"
    return _hi_order(mod) and QAM256_RX == "real" and front != "real", taper


def _refined_key(config: ModemConfig, mod: Modulation, data: torch.Tensor,
                 t0_base: int, front: str, n_bits: int | None,
                 taper: bool | None, bins_w) -> tuple:
    """The key of the refined path's graph: everything that fixes its
    operation sequence (the windows as resolved, the data's shape, dtype
    and device, whether the caller holds the window rows)."""
    ic, taper = _refined_windows(mod, front, taper)
    B, S, L = data.shape
    return (config, mod, front, ic, taper, n_bits, B, S, L, int(t0_base),
            bins_w is not None, data.dtype, data.device)


def _demod_coherent_refined(config: ModemConfig, mod: Modulation,
                            state: DemodState, data: torch.Tensor,
                            t0_base: int, front: str = "analytic",
                            n_bits: int | None = None,
                            taper: bool | None = None,
                            bins_w=None) -> torch.Tensor:
    """The refined path over [B, S, L] data symbols starting at mixer time
    ``t0_base``: LLRs [B, S*Cd*bits].  On the CPU it is the Python loops of
    ``_refined_eager``.  On a card, from the second call of a shape on, it
    is one replay of those loops captured as a CUDA graph
    (``ops/cuda_graphs.py``), which runs the same kernels in the same
    order, so its LLRs are the loops' bit for bit; the state, the data and
    the caller's window rows are copied into the graph's inputs, and its
    LLRs cloned out.  A shape's first call runs the loops.  Nothing is
    read to the host."""
    with metrics.span("ofdm.refined", data):
        if data.device.type != "cuda":
            return _refined_eager(config, mod, state, data, t0_base, front,
                                  n_bits, taper, bins_w)
        global refined_replays
        key = _refined_key(config, mod, data, t0_base, front, n_bits, taper,
                           bins_w)
        n = len(state)

        def run(*x):
            return _refined_eager(config, mod, DemodState(*x[:n]), x[n],
                                  t0_base, front, n_bits, taper,
                                  x[n + 1:] or None)

        inputs = (*state, data, *(bins_w or ()))

        def capture():
            global refined_captures
            refined_captures += 1
            return cuda_graphs.Captured(run, inputs)

        graph = _refined_graphs.get(key, capture)
        if graph is None:
            return _refined_eager(config, mod, state, data, t0_base, front,
                                  n_bits, taper, bins_w)
        refined_replays += 1
        return graph(inputs).clone()


def _refined_eager(config: ModemConfig, mod: Modulation, state: DemodState,
                   data: torch.Tensor, t0_base: int, front: str = "analytic",
                   n_bits: int | None = None, taper: bool | None = None,
                   bins_w=None) -> torch.Tensor:
    """Two-pass no-pilot coherent demod with decision-directed channel
    refinement (demodulator.py:787-940 of the JAX package): [B, S, L] data
    symbols -> LLRs [B, S*Cd*bits], each step a fixed sequence of tensor
    operations (``_demod_coherent_refined`` on the CPU, and what its CUDA
    graph captures).

    Every symbol's used bins (per-symbol ``to_baseband_fd``, a Python loop
    carrying the CFO phase), then a dual second-order decision-directed
    PLL over the symbols (common phase and per-bin timing slope, a Python
    loop), the tracked slope taken out of the bins, and three alternating
    rank-1 LS fits fd ~ g[s] h[c] d[s,c] against hard decisions (ZF for
    the decisions).  The LLRs are MMSE with per-carrier noise from the
    decision residual over the frame.  Carriers the TX left empty
    (``n_bits``) feed none of the fits.  ``taper`` follows the caller's
    window choice (default: Tukey unless ``front == "real"``)."""
    B, S, L = data.shape
    dev = data.device
    data_idx = _carrier_consts(config, dev)[0]
    Cd = data_idx.shape[0]
    ic, taper = _refined_windows(mod, front, taper)

    t = t0_base + torch.arange(S * L, dtype=torch.int32, device=dev)
    osc = mixer_ops.osc_int(config.center_freq, config.sample_rate,
                            t).reshape(S, L)
    h = state.channel_estimate[:, data_idx][:, None, :]   # [B, 1, Cd]
    nv = state.noise_variance[:, None, None]
    fds = []
    for s in range(S):
        fd, state = to_baseband_fd(config, state, data[:, s], t0_base + s * L,
                                   image_cancel=ic, taper=taper,
                                   bins_w=bins_w, osc=osc[s])
        fds.append(fd[:, :Cd])
    fd = torch.stack(fds, dim=1)                          # [B, S, Cd]
    live = host_table(dev, _live_carrier_mask, mod, S, Cd, n_bits)[None]

    # Dual decision-directed PLL: common phase (CFO residual) and per-bin
    # phase slope (symbol-timing drift from a sample-clock offset), both
    # second order, seeding the per-symbol gain g.
    h2 = h[:, 0, :]                                       # [B, Cd]
    hp2 = torch.clamp(h2.abs() ** 2, min=1e-12)
    kbin = host_table(dev, _used_bins_k, config)[:Cd]       # signed bins
    phi = torch.zeros((B,), dtype=torch.float32, device=dev)
    om, psi, ups = phi, phi, phi
    phis, psis = [], []
    for s in range(S):
        fd_s, m_s = fd[:, s], live[:, s]                  # [B, Cd], [1, Cd]
        ang = phi[:, None] + psi[:, None] * kbin[None, :]
        z = fd_s * torch.polar(torch.ones_like(ang), -ang)
        d_s = demap_ops.hard_decision(mod, z * h2.conj() / hp2)
        e = z * (h2 * d_s).conj() * m_s
        ec = e.sum(-1)
        err = torch.atan2(ec.imag, ec.real)
        th = e * torch.polar(torch.ones_like(err), -err)[:, None]
        resid_ph = torch.atan2(th.imag, th.real)
        w = e.abs()
        err_s = ((w * resid_ph * kbin[None, :]).sum(-1)
                 / torch.clamp((w * kbin[None, :] ** 2).sum(-1), min=1e-12))
        om = om + 0.05 * err
        phis.append(phi + err)                            # best phase for s
        phi = phi + om + 0.3 * err
        ups = ups + 0.05 * err_s
        psis.append(psi + err_s)                          # best slope for s
        psi = psi + ups + 0.3 * err_s
    slope = torch.stack(psis, dim=1)[:, :, None] * kbin[None, None, :]
    fd = fd * torch.polar(torch.ones_like(slope), -slope)
    phis = torch.stack(phis, dim=1)
    g = torch.polar(torch.ones_like(phis), phis)[:, :, None]  # [B, S, 1]

    d = None
    for _ in range(3):
        G = g * h
        Gp = torch.clamp(G.abs() ** 2, min=1e-12)
        d = demap_ops.hard_decision(mod, fd * G.conj() / Gp) * live
        hd = h * d
        g = ((fd * hd.conj()).sum(-1, keepdim=True)
             / torch.clamp((hd.abs() ** 2).sum(-1, keepdim=True), min=1e-30))
        gd = g * d
        h = ((fd * gd.conj()).sum(1, keepdim=True)
             / torch.clamp((gd.abs() ** 2).sum(1, keepdim=True), min=1e-30))

    # Honest per-carrier noise from the decision residual: the lowest
    # carriers carry far more residual image and ringing than the median,
    # and their LLRs must deflate to their true reliability.
    G = g * h
    resid = (fd - G * d) * live
    cnt = torch.clamp(live.sum(1, keepdim=True), min=1.0)
    r = (resid.abs() ** 2).sum(1, keepdim=True) / cnt     # [B, 1, Cd]
    r = torch.maximum(r, 0.25 * nv)

    hp = G.abs() ** 2
    eq = G.conj() * fd / torch.clamp(hp + nv, min=1e-30)
    cnv = torch.clamp(r / (hp + 1e-6), MIN_CARRIER_NOISE_VAR,
                      MAX_CARRIER_NOISE_VAR)
    nv_eff = cnv * demap_ops.CE_MARGIN.get(mod, 1.0)
    return demap_ops.demap(mod, eq, nv_eff).reshape(B, -1)


# ---------------------------------------------------------------------------
# Routing and entry points
# ---------------------------------------------------------------------------

def _refined_path(config: ModemConfig, mod: Modulation) -> bool:
    """Every coherent mod on a no-pilot plan takes the refined path, unless
    the adaptive equalizer is on (then the scan, as in JAX)."""
    return (not is_differential(mod)
            and len(carriers_mod.carrier_map(config).pilot_idx) == 0
            and not config.adaptive_eq_enabled)


def _fast_path(config: ModemConfig, mod: Modulation) -> bool:
    return (is_differential(mod)
            and len(carriers_mod.carrier_map(config).pilot_idx) == 0)


def demodulate_with_lts(config: ModemConfig, mod: Modulation,
                        lts: torch.Tensor, data: torch.Tensor, cfo_hz,
                        initial_phase, t0_lts: int = 0, t0_data: int = 0,
                        t0_lts_stride: int | None = None,
                        front: str = "analytic", n_bits: int | None = None):
    """LTS channel estimate + data demodulation for pre-sliced segments
    (the Cox receivers): lts [B, n_sym, L], data [B, S, sym_len], both cut
    from the same ``maybe_analytic``-converted span.  QAM64 and QAM256 use
    the Tukey window for the LTS and the data (image cancellation at
    QAM256 with ``QAM256_RX == "real"``); ``front="real"`` keeps the rect
    window.  Coherent mods on no-pilot plans take the refined path, the
    rest the scan.  Returns (llrs, state)."""
    ic, taper = _scan_windows(mod, front)
    state = init_state(config, lts.shape[0], cfo_hz, initial_phase,
                       lts.device)
    state = estimate_channel_from_lts(config, state, lts, t0_base=t0_lts,
                                      t0_stride=t0_lts_stride,
                                      image_cancel=ic, taper=taper)
    if _refined_path(config, mod):
        llrs = _demod_coherent_refined(config, mod, state, data,
                                       t0_base=t0_data, front=front,
                                       n_bits=n_bits, taper=taper)
        return llrs, state
    state, llrs = _scan_data_symbols(config, mod, state, data,
                                     t0_base=t0_data, front=front,
                                     n_bits=n_bits)
    return llrs, state


def _span_segments(config: ModemConfig, mod: Modulation, span: torch.Tensor,
                   n_lts: int, S: int, lead: int, tail: int, front: str):
    """(lts [B, n_lts, plen], data [B, S, symbol]) of a [B, T] real span
    that starts ``lead`` samples before the first LTS, after the analytic
    conversion of coherent mods (margins tapered first)."""
    if front == "real":
        span = span.to(torch.complex64)
    else:
        span = maybe_analytic(mod, _edge_tapered(mod, span, lead, tail))
    plen = config.fft_size + config.cyclic_prefix
    B = span.shape[0]
    lts = span[:, lead:lead + n_lts * plen].reshape(B, n_lts, plen)
    d0 = n_lts * plen
    data = span[:, lead + d0:lead + d0 + S * config.symbol_duration].reshape(
        B, S, config.symbol_duration)
    return lts, data


def demodulate_span(config: ModemConfig, mod: Modulation, span: torch.Tensor,
                    cfo_hz, initial_phase, n_lts: int, S: int, lead: int = 0,
                    tail: int = 0, front: str = "analytic",
                    n_bits: int | None = None):
    """[B, T] real span starting ``lead`` samples BEFORE the first LTS and
    reaching ``tail`` samples past the data end -> (llrs, state).

    Coherent modulations convert to the analytic signal after the margins
    are tapered (``_edge_tapered``); ``front="real"`` keeps the real
    passband.  The Cox preamble mixed ONE LTS at [plen, 2*plen) and
    repeated it, so every LTS demixes at t0 = plen (stride 0) and the data
    at 2*plen.  ``n_bits`` (the frame's coded bits) masks the carriers the
    TX left empty out of the refits and noise estimates."""
    lts, data = _span_segments(config, mod, span, n_lts, S, lead, tail, front)
    plen = config.fft_size + config.cyclic_prefix
    return demodulate_with_lts(config, mod, lts, data, cfo_hz, initial_phase,
                               t0_lts=plen, t0_data=n_lts * plen,
                               t0_lts_stride=0, front=front, n_bits=n_bits)


def equalized_symbols(config: ModemConfig, mod: Modulation,
                      lts: torch.Tensor, data: torch.Tensor, cfo_hz,
                      initial_phase, t0_lts: int = 0, t0_data: int = 0,
                      t0_lts_stride: int | None = None,
                      front: str = "analytic") -> torch.Tensor:
    """Equalized constellation points [B, S, C] complex64 for observability
    (OFDMDemodulator::getConstellationSymbols): the scan of
    ``demodulate_with_lts``, returning the equalizer output instead of
    LLRs (the scan on every plan, as in JAX)."""
    ic, taper = _scan_windows(mod, front)
    L = data.shape[-1]
    state = init_state(config, lts.shape[0], cfo_hz, initial_phase,
                       lts.device)
    state = estimate_channel_from_lts(config, state, lts, t0_base=t0_lts,
                                      t0_stride=t0_lts_stride,
                                      image_cancel=ic, taper=taper)
    has_pilots = len(carriers_mod.carrier_map(config).pilot_idx) > 0
    adaptive = config.adaptive_eq_enabled and not is_differential(mod)
    Cd = n_data_bins(config)
    eqs = []
    for s in range(data.shape[1]):
        fd, state = to_baseband_fd(config, state, data[:, s], t0_data + s * L,
                                   image_cancel=ic, taper=taper)
        if has_pilots:
            state = update_channel_estimate(config, state, fd)
        eq, cnv = equalize(config, mod, state, fd)
        if adaptive:
            state = dd_update(config, mod, state, fd[:, :Cd], eq)
        _, state = demodulate_symbol(config, mod, state, eq, cnv)
        eqs.append(eq)
    return torch.stack(eqs, dim=1)


def equalized_symbols_span(config: ModemConfig, mod: Modulation,
                           span: torch.Tensor, cfo_hz, initial_phase,
                           n_lts: int, S: int, lead: int = 0, tail: int = 0,
                           front: str = "analytic") -> torch.Tensor:
    """Constellation variant of ``demodulate_span`` -> [B, S, C, 2] f32
    (real, imag), the JAX function's layout."""
    lts, data = _span_segments(config, mod, span, n_lts, S, lead, tail, front)
    plen = config.fft_size + config.cyclic_prefix
    eq = equalized_symbols(config, mod, lts, data, cfo_hz, initial_phase,
                           t0_lts=plen, t0_data=n_lts * plen,
                           t0_lts_stride=0, front=front)
    return torch.stack([eq.real, eq.imag], dim=-1)


class Demodulator(nn.Module):
    """Presynced demodulator for frames of ``training_symbols`` LTS symbols
    and ``num_data_symbols`` data symbols, routed as the JAX
    ``demodulate_presynced``: differential modulations on no-pilot plans
    take the all-symbols-at-once fast path, coherent ones the refined path
    (unless the adaptive equalizer is on), everything else the
    pilot-tracking scan.  As in JAX, the LTS and the refined path use the
    Tukey window only at QAM256, the scan at QAM64 and QAM256.  Buffers:
    ``lts_wr``/``lts_wi`` [L, Cu] (the rectangular analysis rows of the
    LTS and the data symbols; the Tukey rows are looked up by device) and
    ``analysis_r``/``analysis_i`` [S, L, C] (the fast path's data analysis
    tensor)."""

    def __init__(self, config: ModemConfig, mod: Modulation,
                 training_symbols: int, num_data_symbols: int,
                 bins_w=None, analysis=None):
        super().__init__()
        self.config, self.mod = config, mod
        self.training_symbols = training_symbols
        self.num_data_symbols = num_data_symbols
        self.fast = _fast_path(config, mod)
        self.refined = _refined_path(config, mod)
        L = config.symbol_duration
        Wr, Wi = bins_w if bins_w is not None else _used_bins_w(config, L)
        Mr, Mi = analysis if analysis is not None else _analysis_tensor(
            config, training_symbols * L, num_data_symbols)
        self.register_buffer("lts_wr", torch.from_numpy(np.asarray(Wr)))
        self.register_buffer("lts_wi", torch.from_numpy(np.asarray(Wi)))
        self.register_buffer("analysis_r", torch.from_numpy(np.asarray(Mr)))
        self.register_buffer("analysis_i", torch.from_numpy(np.asarray(Mi)))

    def forward(self, samples: torch.Tensor, cfo_hz=0.0, initial_phase=0.0):
        """[B, T] passband aligned at training start (float32, or the
        analytic signal) -> (llrs [B, S*C*bits], DemodState)."""
        with metrics.span("ofdm.demodulate", samples):
            B = samples.shape[0]
            L = self.config.symbol_duration
            Tr, S = self.training_symbols, self.num_data_symbols
            q256 = self.mod == Modulation.QAM256
            samples = maybe_analytic(self.mod, samples)
            state = init_state(self.config, B, cfo_hz, initial_phase,
                               samples.device)
            bins_w = (self.lts_wr, self.lts_wi)
            if Tr > 0:
                tr = samples[:, :Tr * L].reshape(B, Tr, L)
                state = estimate_channel_from_lts(
                    self.config, state, tr,
                    image_cancel=q256 and QAM256_RX == "real", taper=q256,
                    bins_w=bins_w)
            data = samples[:, Tr * L:(Tr + S) * L].reshape(B, S, L)
            if self.fast:
                llrs = _demod_differential_parallel(
                    self.config, self.mod, state, data,
                    (self.analysis_r, self.analysis_i), any_cfo(cfo_hz))
                return llrs, state
            if self.refined:
                llrs = _demod_coherent_refined(self.config, self.mod, state,
                                               data, t0_base=Tr * L,
                                               taper=q256, bins_w=bins_w)
                return llrs, state
            state, llrs = _scan_data_symbols(self.config, self.mod, state,
                                             data, t0_base=Tr * L,
                                             bins_w=bins_w)
            return llrs, state


@functools.lru_cache(maxsize=None)
def _demodulator_for(config: ModemConfig, mod: Modulation,
                     training_symbols: int, num_data_symbols: int,
                     device: torch.device) -> Demodulator:
    return Demodulator(config, mod, training_symbols,
                       num_data_symbols).to(device)


def demodulate_presynced(config: ModemConfig, mod: Modulation,
                         samples: torch.Tensor, cfo_hz, initial_phase,
                         training_symbols: int, num_data_symbols: int):
    """Full presynced RX for a batch of frames.

    Args:
      samples: [B, T] float32 passband, aligned at training start;
               T >= (training_symbols + num_data_symbols) * symbol_duration.
      cfo_hz, initial_phase: scalar or [B] external CFO estimate and
               accumulated phase.
    Returns:
      (llrs [B, num_data_symbols * bits_per_ofdm_symbol], DemodState)
    """
    demod = _demodulator_for(config, mod, training_symbols, num_data_symbols,
                             samples.device)
    return demod(samples, cfo_hz, initial_phase)


def num_symbols_for_bits(config: ModemConfig, mod: Modulation,
                         nbits: int) -> int:
    per_sym = n_data_bins(config) * bits_per_symbol(mod)
    return -(-nbits // per_sym)

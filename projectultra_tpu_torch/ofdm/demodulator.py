"""Batched OFDM demodulator, presynced differential no-pilot branch (port of
projectultra_tpu/ofdm/demodulator.py; reference processPresynced,
demodulator.cpp:854-985).

Samples arrive aligned at the training start with the CFO given as data.
The LTS symbols give the channel estimate; with no pilots the demodulator
state never changes over the data symbols, so all of them are analysed at
once by one constant [S, L, C] contraction (NCO downmix x DFT rows of the
data bins) and demapped against the previous symbol.

The pilot-tracking scan path and the coherent refined path are not ported
yet: ``demodulate_presynced`` raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from projectultra_tpu.config import ModemConfig, Modulation, is_differential
from projectultra_tpu.ofdm import carriers as carriers_mod

from ..ops import demap as demap_ops
from ..ops import mixer as mixer_ops

# Constants from demodulator_constants.hpp / demodulator_impl.hpp.
DEFAULT_NOISE_VAR = 0.1
MIN_CARRIER_NOISE_VAR = 1e-6
MAX_CARRIER_NOISE_VAR = 100.0

_LATER = ("only the presynced differential no-pilot branch is ported; the "
          "pilot scan and coherent paths come with the port's later slices")


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

@functools.lru_cache(maxsize=None)
def _used_bins_w(config: ModemConfig, L: int):
    """DFT rows of the USED bins ([data..., pilot...]) with the CP/guard
    region zeroed (rectangular window), as real/imag f32 [L, Cu]."""
    cm = carriers_mod.carrier_map(config)
    N, cp = config.fft_size, config.cyclic_prefix
    bins = np.concatenate([np.asarray(cm.data_idx),
                           np.asarray(cm.pilot_idx)]).astype(np.float64)
    n_idx = np.arange(L) - cp
    live = (n_idx >= 0) & (n_idx < N)
    W = np.exp(-2j * np.pi * np.outer(n_idx % N, bins) / N)
    W = np.where(live[:, None], W, 0.0)
    return W.real.astype(np.float32), W.imag.astype(np.float32)


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
def _bins_w_on(config: ModemConfig, L: int, device: torch.device):
    Wr, Wi = _used_bins_w(config, L)
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


# ---------------------------------------------------------------------------
# Per-symbol front end and LTS channel estimate
# ---------------------------------------------------------------------------

def _cfo_active(freq_offset_hz: torch.Tensor) -> torch.Tensor:
    return freq_offset_hz.abs() > 0.01


def to_baseband_fd(config: ModemConfig, state: DemodState,
                   sym_samples: torch.Tensor, t0: int, bins_w=None):
    """toBaseband + extractSymbol (channel_equalizer.cpp:19-71) for one
    symbol, rectangular window: [B, L] passband -> [B, Cu] USED bins laid
    out [data..., pilot...].  ``t0`` is the window's sample index since the
    last mixer reset.  Advances the CFO-correction phase by L samples
    (only when |cfo| > 0.01, like the C++).  ``bins_w`` are the
    ``_used_bins_w`` tensors (looked up by device when not given)."""
    L = sym_samples.shape[-1]
    dev = sym_samples.device
    t = t0 + torch.arange(L, dtype=torch.int32, device=dev)
    osc = mixer_ops.osc_int(config.center_freq, config.sample_rate, t)  # [L]

    phase_inc = float(np.float32(-2.0 * np.pi / config.sample_rate)) \
        * state.freq_offset_hz
    i = torch.arange(L, dtype=torch.float32, device=dev)
    corr_phase = state.freq_phase[:, None] + phase_inc[:, None] * i
    corr = torch.polar(torch.ones_like(corr_phase), corr_phase)
    active = _cfo_active(state.freq_offset_hz)[:, None]
    corr = torch.where(active, corr, torch.ones((), dtype=torch.complex64,
                                                device=dev))

    z = sym_samples.to(torch.complex64) * osc.conj()[None, :] * corr
    Wr, Wi = bins_w if bins_w is not None else _bins_w_on(config, int(L), dev)
    fd = torch.complex(z.real @ Wr - z.imag @ Wi, z.real @ Wi + z.imag @ Wr)

    new_phase = torch.where(
        active[:, 0],
        torch.remainder(state.freq_phase + phase_inc * L + math.pi,
                        2 * math.pi) - math.pi,
        state.freq_phase)
    return fd, state._replace(freq_phase=new_phase)


def estimate_channel_from_lts(config: ModemConfig, state: DemodState,
                              training: torch.Tensor,
                              bins_w=None) -> DemodState:
    """(channel_equalizer.cpp:77-328): LS estimates from each training
    symbol; data carriers take the LAST symbol's H, pilots the average;
    SNR seeded from |H|avg^2 / noise_variance.

    training: [B, n_sym, L], mixed contiguously from mixer time 0 (the
    chirp path's training symbols); symbol s demixes at time s * L."""
    cm = carriers_mod.carrier_map(config)
    B, n_sym, L = training.shape
    dev = training.device
    Cd = len(cm.data_idx)
    data_idx, pilot_idx, tx_data, pilot_seq = _carrier_consts(config, dev)

    h_data_last = None
    h_pilot_sum = torch.zeros((B, max(len(cm.pilot_idx), 1)),
                              dtype=torch.complex64, device=dev)
    for s in range(n_sym):
        fd, state = to_baseband_fd(config, state, training[:, s], s * L,
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
    """[B, S, L] real passband data symbols -> [B, S*C*bits] LLRs.

    ``analysis`` is the (Mr, Mi) [S, L, C] pair of ``_analysis_tensor`` at
    the data's mixer offset; ``with_cfo`` selects the per-sample CFO
    rotation (decided on the host, see ``any_cfo``)."""
    cm = carriers_mod.carrier_map(config)
    B, S, L = data.shape
    dev = data.device
    Mr, Mi = analysis

    def ee(x, M):
        return torch.einsum("bsl,slc->bsc", x, M)

    dr = data
    if with_cfo:
        cfo = state.freq_offset_hz
        phase_inc = float(np.float32(-2.0 * np.pi / config.sample_rate)) * cfo
        i_all = torch.arange(S * L, dtype=torch.float32,
                             device=dev).reshape(S, L)
        corr_phase = (state.freq_phase[:, None, None]
                      + phase_inc[:, None, None] * i_all[None])
        act = _cfo_active(cfo)[:, None, None]
        corr_phase = torch.where(act, corr_phase, 0.0)
        zr = dr * torch.cos(corr_phase)
        zi = dr * torch.sin(corr_phase)
        rx = torch.complex(ee(zr, Mr) - ee(zi, Mi), ee(zr, Mi) + ee(zi, Mr))
    else:
        rx = torch.complex(ee(dr, Mr), ee(dr, Mi))            # [B, S, C]

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


def _check_branch(config: ModemConfig, mod: Modulation) -> None:
    if not is_differential(mod) or len(carriers_mod.carrier_map(config)
                                       .pilot_idx):
        raise NotImplementedError(_LATER)


class Demodulator(nn.Module):
    """Presynced demodulator for frames of ``training_symbols`` LTS symbols
    and ``num_data_symbols`` data symbols.  Buffers: ``lts_wr``/``lts_wi``
    [L, Cu] (LTS analysis rows) and ``analysis_r``/``analysis_i``
    [S, L, C] (data analysis tensor)."""

    def __init__(self, config: ModemConfig, mod: Modulation,
                 training_symbols: int, num_data_symbols: int,
                 bins_w=None, analysis=None):
        super().__init__()
        _check_branch(config, mod)
        self.config, self.mod = config, mod
        self.training_symbols = training_symbols
        self.num_data_symbols = num_data_symbols
        L = config.symbol_duration
        Wr, Wi = bins_w if bins_w is not None else _used_bins_w(config, L)
        Mr, Mi = analysis if analysis is not None else _analysis_tensor(
            config, training_symbols * L, num_data_symbols)
        self.register_buffer("lts_wr", torch.from_numpy(np.asarray(Wr)))
        self.register_buffer("lts_wi", torch.from_numpy(np.asarray(Wi)))
        self.register_buffer("analysis_r", torch.from_numpy(np.asarray(Mr)))
        self.register_buffer("analysis_i", torch.from_numpy(np.asarray(Mi)))

    def forward(self, samples: torch.Tensor, cfo_hz=0.0, initial_phase=0.0):
        """[B, T] float32 passband aligned at training start ->
        (llrs [B, S*C*bits], DemodState)."""
        B = samples.shape[0]
        L = self.config.symbol_duration
        Tr, S = self.training_symbols, self.num_data_symbols
        if samples.is_complex():
            raise NotImplementedError("complex (analytic) input: " + _LATER)
        state = init_state(self.config, B, cfo_hz, initial_phase,
                           samples.device)
        if Tr > 0:
            tr = samples[:, :Tr * L].reshape(B, Tr, L)
            state = estimate_channel_from_lts(
                self.config, state, tr, bins_w=(self.lts_wr, self.lts_wi))
        data = samples[:, Tr * L:(Tr + S) * L].reshape(B, S, L)
        llrs = _demod_differential_parallel(
            self.config, self.mod, state, data,
            (self.analysis_r, self.analysis_i), any_cfo(cfo_hz))
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
    """Full presynced RX for a batch of frames (differential modulations
    on no-pilot plans).

    Args:
      samples: [B, T] float32 passband, aligned at training start;
               T >= (training_symbols + num_data_symbols) * symbol_duration.
      cfo_hz, initial_phase: scalar or [B] external CFO estimate and
               accumulated phase.
    Returns:
      (llrs [B, num_data_symbols * bits_per_ofdm_symbol], DemodState)
    """
    _check_branch(config, mod)
    demod = _demodulator_for(config, mod, training_symbols, num_data_symbols,
                             samples.device)
    return demod(samples, cfo_hz, initial_phase)

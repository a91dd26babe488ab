"""Batched OFDM modulator: coded bits -> 48 kHz passband audio (port of
projectultra_tpu/ofdm/modulator.py; reference src/ofdm/modulator.cpp).

Per symbol the output is [CP | IFFT(N) | guard zeros] mixed up to the
carrier by a continuous NCO.  Only the used carriers are non-zero, so
IFFT + CP + guard + upmix are one constant [S, C, L] synthesis tensor
applied as a float32 contraction.  Differential encoding is a cumulative
phase-index sum over the symbol axis (exact on the {1, j, -1, -j} grid).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..config import ModemConfig, Modulation, bits_per_symbol
from . import carriers as carriers_mod
from . import constellations as con
from ..ops import mixer as mixer_ops


def map_bits_to_symbols(config: ModemConfig, mod: Modulation,
                        bits: torch.Tensor) -> torch.Tensor:
    """[B, nbits] {0,1} -> [B, S, C] complex64 constellation symbols.

    Bit consumption order matches modulator.cpp:374-451: bc bits per carrier
    MSB-first, carriers in order, then next symbol; trailing bits padded with
    zeros.  Carriers whose bits lie entirely past the input stay empty."""
    cm = carriers_mod.carrier_map(config)
    C = len(cm.data_idx)
    bc = bits_per_symbol(mod)
    B, nbits = bits.shape
    dev = bits.device
    per_sym = C * bc
    S = -(-nbits // per_sym)
    pad = S * per_sym - nbits
    words = torch.nn.functional.pad(bits.to(torch.int32), (0, pad))
    words = words.reshape(B, S, C, bc)
    weights = 1 << torch.arange(bc - 1, -1, -1, dtype=torch.int32, device=dev)
    words = (words * weights).sum(-1)                       # [B, S, C]

    filled, points = _symbol_consts(config, mod, nbits, dev)

    if mod == Modulation.DBPSK:
        cum = torch.cumsum(words, dim=1) % 2
        syms = torch.where(cum == 0, 1.0, -1.0).to(torch.complex64)
    elif mod == Modulation.DQPSK:
        syms = points[torch.cumsum(words, dim=1) % 4]
    elif mod == Modulation.D8PSK:
        ang = words.to(torch.float32) * float(np.pi / 4) + float(np.pi / 8)
        cum = torch.cumsum(ang, dim=1)
        syms = torch.polar(torch.ones_like(cum), cum)
    else:
        syms = points[words]
    return torch.where(filled, syms, torch.zeros((), dtype=torch.complex64,
                                                 device=dev))


@functools.lru_cache(maxsize=None)
def _symbol_consts(config: ModemConfig, mod: Modulation, nbits: int,
                   device: torch.device):
    """(filled [1, S, C] bool, constellation or DQPSK phase table) on
    ``device``, made once per device: a host-to-device copy on every call
    would synchronise the stream.  ``filled`` marks the carriers that get
    at least one input bit."""
    C = len(carriers_mod.carrier_map(config).data_idx)
    bc = bits_per_symbol(mod)
    S = -(-nbits // (C * bc))
    first_bit = np.arange(S * C).reshape(S, C) * bc
    filled = torch.as_tensor(first_bit < nbits, device=device)[None]
    points = con.DQPSK_PHASES if mod == Modulation.DQPSK else con.table(mod)
    return filled, torch.as_tensor(points, device=device)


@functools.lru_cache(maxsize=None)
def _synthesis_tensors(config: ModemConfig, t_offset: int, S: int):
    """Host-constant OFDM synthesis: carrier symbols -> passband.

    Returns (Ar, Ai [S, C, L] f32, pilot_wave [S, L] f32 or None);
    out = sr@Ar - si@Ai + pilot_wave."""
    cm = carriers_mod.carrier_map(config)
    N, cp = config.fft_size, config.cyclic_prefix
    sym_len = config.symbol_duration
    L = sym_len
    n_idx = (np.arange(L) - cp) % N
    live = np.arange(L) < cp + N                          # guard -> zeros

    def carrier_rows(idx) -> np.ndarray:                  # [len(idx), L]
        rows = np.exp(2j * np.pi * np.outer(np.asarray(idx, np.float64),
                                            n_idx) / N) / N
        return np.where(live[None, :], rows, 0.0)

    osc = mixer_ops.osc_fixed(
        config.center_freq + config.tx_cfo_hz, config.sample_rate,
        S * sym_len, offset=t_offset).reshape(S, sym_len)

    A = carrier_rows(cm.data_idx)[None, :, :] * osc[:, None, :] \
        * config.output_scale                              # [S, C, L]
    pilot_wave = None
    if config.use_pilots and len(cm.pilot_idx):
        p = (np.asarray(cm.pilot_seq)[:, None]
             * carrier_rows(cm.pilot_idx)).sum(0)          # [L]
        pilot_wave = (p[None, :] * osc).real.astype(np.float32) \
            * config.output_scale
    return (A.real.astype(np.float32), A.imag.astype(np.float32),
            pilot_wave)


@functools.lru_cache(maxsize=None)
def _training_np(config: ModemConfig, count: int) -> np.ndarray:
    """LTS training block (modulator.cpp:534-580): count x [CP | LTS |
    guard], mixer reset at start."""
    lts_fd = carriers_mod.lts_freq_domain(config)
    td = np.fft.ifft(lts_fd).astype(np.complex64)
    cp = config.cyclic_prefix
    one = np.concatenate([td[-cp:], td])
    sym_len = config.symbol_duration
    out = np.zeros(count * sym_len, dtype=np.float32)
    for c in range(count):
        t0 = c * sym_len
        osc = mixer_ops.osc_fixed(config.center_freq + config.tx_cfo_hz,
                                  config.sample_rate, len(one), offset=t0)
        out[t0:t0 + len(one)] = (one * osc).real * config.output_scale
    return out


def generate_training(config: ModemConfig, count: int) -> np.ndarray:
    """Training symbols for chirp-based acquisition (numpy); data
    modulation then continues at t_offset = count * symbol_duration."""
    return _training_np(config, count)


@functools.lru_cache(maxsize=None)
def generate_preamble(config: ModemConfig) -> np.ndarray:
    """Schmidl-Cox preamble (modulator.cpp:479-531), numpy:
    silence(N+CP) + 4x STS + 2x LTS; constant per config.

    Quirk kept from the reference: the STS is mixed ONCE (t in [0, N+CP))
    and the identical buffer is repeated 4x; the LTS is mixed once at
    t in [N+CP, 2(N+CP)) and repeated 2x.  The mixer therefore advances
    only 2 symbol lengths over the whole preamble, and ``modulate``
    continues from there (``preamble_data_t_offset``)."""
    N, cp = config.fft_size, config.cyclic_prefix
    plen = N + cp
    scale = config.output_scale
    fc = config.center_freq + config.tx_cfo_hz

    def sym_to_real(fd: np.ndarray, t0: int) -> np.ndarray:
        td = np.fft.ifft(fd).astype(np.complex64)
        one = np.concatenate([td[-cp:], td])
        osc = mixer_ops.osc_fixed(fc, config.sample_rate, plen, offset=t0)
        return ((one * osc).real * scale).astype(np.float32)

    sts = sym_to_real(carriers_mod.sts_freq_domain(config), 0)
    lts = sym_to_real(carriers_mod.lts_freq_domain(config), plen)
    return np.concatenate([np.zeros(plen, np.float32)] + [sts] * 4 + [lts] * 2)


def preamble_data_t_offset(config: ModemConfig) -> int:
    """Mixer sample index at which ``modulate`` continues after the
    preamble (the mixer advances only one STS and one LTS; see
    ``generate_preamble``)."""
    return 2 * (config.fft_size + config.cyclic_prefix)


class Modulator(nn.Module):
    """Data-symbol modulator for S symbols starting at mixer time
    ``t_offset``.  Buffers: ``synth_r``/``synth_i`` [S, C, L] and, for
    pilot plans, ``pilot_wave`` [S, L]."""

    def __init__(self, config: ModemConfig, mod: Modulation, S: int,
                 t_offset: int = 0, synthesis=None):
        super().__init__()
        self.config, self.mod, self.S = config, mod, S
        Ar, Ai, pilot_wave = (synthesis if synthesis is not None
                              else _synthesis_tensors(config, t_offset, S))
        self.register_buffer("synth_r", torch.from_numpy(np.asarray(Ar)))
        self.register_buffer("synth_i", torch.from_numpy(np.asarray(Ai)))
        self.register_buffer(
            "pilot_wave", None if pilot_wave is None
            else torch.from_numpy(np.asarray(pilot_wave)))

    def symbols_to_passband(self, syms: torch.Tensor) -> torch.Tensor:
        """[B, S, C] symbols -> [B, S*L] float32 passband, mixer phase
        continuous from the module's t_offset."""
        B, S, C = syms.shape
        if S != self.S:
            raise ValueError(f"modulator built for {self.S} symbols, got {S}")
        out = torch.einsum("bsc,scl->bsl", syms.real, self.synth_r) \
            - torch.einsum("bsc,scl->bsl", syms.imag, self.synth_i)
        if self.pilot_wave is not None:
            out = out + self.pilot_wave[None]
        return out.reshape(B, S * self.config.symbol_duration)

    def forward(self, bits: torch.Tensor) -> torch.Tensor:
        """[B, nbits] -> [B, S*L] passband."""
        return self.symbols_to_passband(
            map_bits_to_symbols(self.config, self.mod, bits))


@functools.lru_cache(maxsize=None)
def _modulator_for(config: ModemConfig, mod: Modulation, S: int,
                   t_offset: int, device: torch.device) -> Modulator:
    return Modulator(config, mod, S, t_offset).to(device)


def modulate(config: ModemConfig, mod: Modulation, bits: torch.Tensor,
             t_offset: int = 0) -> torch.Tensor:
    """Batched OFDMModulator::modulate — [B, nbits] -> [B, samples]."""
    cm = carriers_mod.carrier_map(config)
    S = -(-bits.shape[1] // (len(cm.data_idx) * bits_per_symbol(mod)))
    return _modulator_for(config, mod, S, t_offset, bits.device)(bits)

"""Waveform abstraction layer: capabilities, factory, SNR recommendations.

Reference: src/waveform/{waveform_interface.hpp, waveform_factory.cpp,
mc_dpsk_waveform.cpp, ofdm_chirp_waveform.cpp, ofdm_cox_waveform.cpp}.

The reference's IWaveform virtual interface (detectSync / setFrequencyOffset
/ modulate / process / getSoftBits) becomes a small adapter class over the
batched device kernels, preserving the call-order invariants
(docs/INVARIANTS.md:178-226): reset -> detect_sync -> demodulate(span
starting at the TRAINING start, with CFO/phase from detection).

The port of the JAX package's adapters: each adapter holds a device (the
first CUDA device when none is given; raises without one), moves what it
is handed there and runs the port's modules on it; detection results come
back to the host as numpy arrays, as in the original.  ``create``,
``recommend_mode`` and ``recommend_mc_dpsk_carriers`` are copies.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import ModemConfig, Modulation, CodeRate
from ..device import resolve as resolve_device
from ..modem.acquisition.base import to_device, to_host
from ..protocol.frame_v2 import WaveformMode
from ..psk import mc_dpsk as MC
from ..sync import chirp as chirp_mod
from ..ofdm import modulator as ofdm_mod
from ..ofdm import demodulator as ofdm_demod
from ..ofdm import pipeline as ofdm_pipeline
from ..sync import schmidl_cox as sc

# Host arrays go to the device at 32 bits, as jnp.asarray takes them.
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.complex128): np.complex64}


def on_device(x, device: torch.device) -> torch.Tensor:
    """A tensor, host array or scalar as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.asarray(x)
    return to_device(x.astype(_NARROW.get(x.dtype, x.dtype), copy=False),
                     device)


@dataclasses.dataclass
class WaveformCapabilities:
    """(waveform_interface.hpp:20-45)"""
    supports_cfo_correction: bool = True
    supports_doppler_correction: bool = False
    requires_pilots: bool = False
    supports_differential: bool = True
    min_snr_db: float = 0.0
    max_snr_db: float = 40.0
    preamble_duration_ms: float = 0.0


@dataclasses.dataclass
class SyncResult:
    """(waveform_interface.hpp:47-60): start_sample points at TRAINING start."""
    detected: np.ndarray
    start_sample: np.ndarray
    cfo_hz: np.ndarray
    correlation: np.ndarray
    has_training: bool = True


class MCDPSKWaveform:
    """MC-DPSK + dual-chirp sync (mc_dpsk_waveform.cpp)."""

    mode = WaveformMode.MC_DPSK

    def __init__(self, num_carriers: int = 8, device=None):
        self.device = resolve_device(device)
        self.config = MC.MCDPSKConfig(
            num_carriers=max(3, min(20, num_carriers)))
        self.chirp = self.config.chirp_config()

    def capabilities(self) -> WaveformCapabilities:
        return WaveformCapabilities(
            supports_doppler_correction=True, min_snr_db=-3.0, max_snr_db=10.0,
            preamble_duration_ms=self.chirp.total_samples / 48.0)

    def generate_preamble(self) -> np.ndarray:
        return MC.preamble(self.config)

    def modulate(self, bits) -> torch.Tensor:
        return MC.modulate(self.config, on_device(bits, self.device))

    def detect_sync(self, samples, threshold: float = 0.15) -> SyncResult:
        det = chirp_mod.detect_dual_chirp(
            self.chirp, on_device(samples, self.device), threshold)
        start = chirp_mod.training_start(self.chirp, det["down_chirp_start"])
        return SyncResult(to_host(det["success"]), to_host(start),
                          to_host(det["cfo_hz"]),
                          to_host(torch.maximum(det["up_correlation"],
                                                det["down_correlation"])))

    def demodulate(self, span, cfo_hz, train_start_abs,
                   num_data_symbols: int) -> torch.Tensor:
        d = self.device
        return MC.demodulate_presynced(
            self.config, on_device(span, d), on_device(cfo_hz, d),
            on_device(train_start_abs, d), num_data_symbols)


class DPSKWaveform:
    """Single-carrier DPSK with Barker-13x3 sync — the operating mode the
    reference constructs but never wires (modem_engine.cpp:55-56); an
    engine-local extension here (see frame_v2.WaveformMode.DPSK)."""

    mode = WaveformMode.DPSK

    def __init__(self, preset: str = "medium", device=None):
        from ..psk import dpsk as DP
        self.device = resolve_device(device)
        self._DP = DP
        self.config = getattr(DP, preset)()

    def capabilities(self) -> WaveformCapabilities:
        return WaveformCapabilities(
            supports_doppler_correction=True, min_snr_db=-11.0, max_snr_db=5.0,
            preamble_duration_ms=self.config.preamble_samples / 48.0)

    def generate_preamble(self) -> np.ndarray:
        return self._DP.generate_preamble(self.config)

    def modulate(self, bits) -> torch.Tensor:
        return self._DP.modulate(self.config, on_device(bits, self.device))

    def detect_sync(self, samples, threshold: float = 0.0) -> SyncResult:
        found, ds, cfo, ipo, prev = self._DP.find_preamble(
            self.config, on_device(samples, self.device))
        self._last = (cfo, ipo, prev)
        # start_sample is the DATA start: single-carrier DPSK has no
        # training segment (the Barker preamble itself seeds CFO/phase/
        # reference), so has_training=False per the SyncResult contract.
        return SyncResult(to_host(found), to_host(ds), to_host(cfo),
                          to_host(found).astype(np.float32),
                          has_training=False)

    def demodulate(self, span, cfo_hz, train_start_abs,
                   num_data_symbols: int) -> torch.Tensor:
        _, ipo, prev = self._last
        return self._DP.demodulate_soft(
            self.config, on_device(span, self.device), prev,
            on_device(cfo_hz, self.device), ipo)


class OFDMChirpWaveform:
    """OFDM-DQPSK with chirp sync, 30 carriers, no pilots
    (ofdm_chirp_waveform.cpp:10-31)."""

    mode = WaveformMode.OFDM_CHIRP
    TRAINING_SYMBOLS = 2

    def __init__(self, modulation: Modulation = Modulation.DQPSK,
                 rate: CodeRate = CodeRate.R1_2, device=None):
        self.device = resolve_device(device)
        if modulation not in (Modulation.DBPSK, Modulation.DQPSK,
                              Modulation.D8PSK):
            modulation = Modulation.DQPSK
        self.config = ofdm_pipeline.chirp_ofdm_config(modulation, rate)
        self.chirp = chirp_mod.ChirpConfig()

    def capabilities(self) -> WaveformCapabilities:
        return WaveformCapabilities(
            supports_doppler_correction=True, min_snr_db=10.0, max_snr_db=20.0,
            preamble_duration_ms=self.chirp.total_samples / 48.0)

    def generate_preamble(self) -> np.ndarray:
        return np.concatenate([
            chirp_mod.generate(self.chirp),
            ofdm_mod.generate_training(self.config, self.TRAINING_SYMBOLS)])

    def modulate(self, bits) -> torch.Tensor:
        return ofdm_mod.modulate(
            self.config, self.config.modulation, on_device(bits, self.device),
            t_offset=self.TRAINING_SYMBOLS * self.config.symbol_duration)

    def detect_sync(self, samples, threshold: float = 0.15) -> SyncResult:
        det = chirp_mod.detect_dual_chirp(
            self.chirp, on_device(samples, self.device), threshold)
        start = chirp_mod.training_start(self.chirp, det["down_chirp_start"])
        return SyncResult(to_host(det["success"]), to_host(start),
                          to_host(det["cfo_hz"]),
                          to_host(torch.maximum(det["up_correlation"],
                                                det["down_correlation"])))

    def demodulate(self, span, cfo_hz, train_start_abs,
                   num_data_symbols: int) -> torch.Tensor:
        d = self.device
        cfo = on_device(cfo_hz, d)
        phase = chirp_mod.initial_cfo_phase(
            self.chirp, cfo, on_device(train_start_abs, d).to(torch.int32))
        llrs, _ = ofdm_demod.demodulate_presynced(
            self.config, self.config.modulation, on_device(span, d), cfo,
            phase, training_symbols=self.TRAINING_SYMBOLS,
            num_data_symbols=num_data_symbols)
        return llrs


class OFDMCoxWaveform:
    """Schmidl-Cox OFDM, coherent or differential, NVIS 1024-FFT capable
    (ofdm_cox_waveform.cpp)."""

    mode = WaveformMode.OFDM_COX

    def __init__(self, config: ModemConfig | None = None, device=None):
        self.device = resolve_device(device)
        self.config = config or ModemConfig()

    def capabilities(self) -> WaveformCapabilities:
        return WaveformCapabilities(
            requires_pilots=self.config.use_pilots,
            supports_differential=True, min_snr_db=17.0, max_snr_db=40.0,
            preamble_duration_ms=7 * (self.config.fft_size
                                      + self.config.cyclic_prefix) / 48.0)

    def generate_preamble(self) -> np.ndarray:
        return ofdm_mod.generate_preamble(self.config)

    def modulate(self, bits) -> torch.Tensor:
        return ofdm_mod.modulate(
            self.config, self.config.modulation, on_device(bits, self.device),
            t_offset=ofdm_mod.preamble_data_t_offset(self.config))

    def detect_sync(self, samples, threshold: float = 0.80) -> SyncResult:
        det = sc.detect_preamble(self.config, on_device(samples, self.device),
                                 threshold)
        return SyncResult(to_host(det["found"]), to_host(det["lts_start"]),
                          to_host(det["cfo_hz"]), to_host(det["peak_corr"]))

    def decode(self, samples, n_codewords: int = 1):
        return sc.decode_ofdm_cox(self.config, self.config.modulation,
                                  on_device(samples, self.device),
                                  n_codewords)


# ---------------------------------------------------------------------------
# Factory + SNR recommendations (waveform_factory.cpp)
# ---------------------------------------------------------------------------

def create(mode: WaveformMode, device=None, **kw):
    """WaveformFactory::create — MFSK/OTFS map per the reference's fallbacks
    (waveform_factory.cpp:11-50: MFSK -> MC_DPSK).  The adapter runs on
    ``device`` (the first CUDA device when None)."""
    device = resolve_device(device)
    if mode in (WaveformMode.MC_DPSK, WaveformMode.MFSK):
        return MCDPSKWaveform(device=device, **kw)
    if mode == WaveformMode.DPSK:
        return DPSKWaveform(device=device, **kw)
    if mode == WaveformMode.OFDM_CHIRP:
        return OFDMChirpWaveform(device=device, **kw)
    if mode in (WaveformMode.OTFS_EQ, WaveformMode.OTFS_RAW):
        from ..otfs.otfs import OTFSConfig
        from . import otfs_adapter
        return otfs_adapter.OTFSWaveform(
            OTFSConfig(tf_equalization=(mode == WaveformMode.OTFS_EQ)),
            device=device)
    return OFDMCoxWaveform(device=device, **kw)


def recommend_mode(snr_db: float) -> WaveformMode:
    """(waveform_factory.cpp recommendMode)"""
    if snr_db < 10.0:
        return WaveformMode.MC_DPSK
    if snr_db < 17.0:
        return WaveformMode.OFDM_CHIRP
    return WaveformMode.OFDM_COX


def recommend_mc_dpsk_carriers(snr_db: float) -> int:
    """(waveform_factory.cpp:179-197)"""
    if snr_db < 3.0:
        return 5
    if snr_db < 8.0:
        return 8
    if snr_db < 10.0:
        return 10
    if snr_db < 15.0:
        return 13
    return 20

"""OFDM carrier mapping and reference sequences.

Reference: src/ofdm/modulator.cpp:143-215 and src/ofdm/demodulator.cpp:45-135.
All outputs are host numpy constants.  The port's copy of the JAX package's
module, pinned array-equal to it by ``tests/test_torch_host.py``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..config import ModemConfig
from ..utils.mt19937 import MT19937

PILOT_RNG_SEED = 0x50494C54  # "PILT" (modulator.cpp:39)


@dataclasses.dataclass(frozen=True)
class CarrierMap:
    """Static carrier layout for one ModemConfig."""
    fft_size: int
    data_idx: np.ndarray          # [Nd] FFT bin index per data carrier
    pilot_idx: np.ndarray         # [Np] FFT bin index per pilot carrier
    pilot_seq: np.ndarray         # [Np] complex64 BPSK pilot values
    sync_seq: np.ndarray          # [num_carriers] complex64 Zadoff-Chu u=1
    data_k: np.ndarray            # [Nd] signed bin number (idx>N/2 -> idx-N)
    pilot_k: np.ndarray           # [Np] signed bin number

    def __hash__(self):
        return hash((self.fft_size, self.data_idx.tobytes(),
                     self.pilot_idx.tobytes()))

    def __eq__(self, other):
        return (isinstance(other, CarrierMap)
                and self.fft_size == other.fft_size
                and np.array_equal(self.data_idx, other.data_idx)
                and np.array_equal(self.pilot_idx, other.pilot_idx))


def _signed_bins(idx: np.ndarray, fft_size: int) -> np.ndarray:
    k = idx.astype(np.int64).copy()
    k[k > fft_size // 2] -= fft_size
    return k


@functools.lru_cache(maxsize=None)
def carrier_map(config: ModemConfig) -> CarrierMap:
    """Carriers placed symmetrically around DC, skipping DC; every
    pilot_spacing-th slot is a pilot when use_pilots (modulator.cpp:143-181)."""
    neg = config.num_carriers // 2
    pos = (config.num_carriers + 1) // 2

    data_idx, pilot_idx = [], []
    count = 0
    for i in range(-neg, pos + 1):
        if i == 0:
            continue
        fft_i = (i + config.fft_size) % config.fft_size
        if not config.use_pilots:
            data_idx.append(fft_i)
        elif count % config.pilot_spacing == 0:
            pilot_idx.append(fft_i)
        else:
            data_idx.append(fft_i)
        count += 1

    data_idx = np.asarray(data_idx, dtype=np.int32)
    pilot_idx = np.asarray(pilot_idx, dtype=np.int32)

    # Zadoff-Chu u=1 over num_carriers (modulator.cpp:186-195): float32
    # cos/sin of -pi*n(n+1)/N, matching the reference's float arithmetic.
    N = config.num_carriers
    n = np.arange(N, dtype=np.float32)
    phase = (-np.pi * n * (n + 1) / N).astype(np.float32)
    sync_seq = (np.cos(phase) + 1j * np.sin(phase)).astype(np.complex64)

    # Pilot BPSK from mt19937("PILT") & 1 (modulator.cpp:197-203).
    rng = MT19937(PILOT_RNG_SEED)
    raw = rng.raw(len(pilot_idx)) if len(pilot_idx) else np.zeros(0, np.uint32)
    pilot_seq = np.where((raw & 1).astype(bool), 1.0, -1.0).astype(np.complex64)

    return CarrierMap(
        fft_size=config.fft_size,
        data_idx=data_idx, pilot_idx=pilot_idx,
        pilot_seq=pilot_seq, sync_seq=sync_seq,
        data_k=_signed_bins(data_idx, config.fft_size),
        pilot_k=_signed_bins(pilot_idx, config.fft_size),
    )


def lts_freq_domain(config: ModemConfig) -> np.ndarray:
    """Frequency-domain LTS: sync_seq on data carriers (cyclically reused) and
    pilot_seq on pilots (demodulator.cpp:100-108). [fft_size] complex64."""
    cm = carrier_map(config)
    fd = np.zeros(config.fft_size, dtype=np.complex64)
    nd = len(cm.data_idx)
    fd[cm.data_idx] = cm.sync_seq[np.arange(nd) % len(cm.sync_seq)]
    if len(cm.pilot_idx):
        fd[cm.pilot_idx] = cm.pilot_seq
    return fd


def sts_freq_domain(config: ModemConfig) -> np.ndarray:
    """Schmidl-Cox STS: sync_seq on EVEN data-carrier bins only, producing two
    identical time-domain halves (modulator.cpp:298-310).  Note the reference
    advances the sequence index for every data carrier, even skipped odd ones.
    """
    cm = carrier_map(config)
    fd = np.zeros(config.fft_size, dtype=np.complex64)
    seq_idx = 0
    for idx in cm.data_idx:
        if idx % 2 == 0:
            fd[idx] = cm.sync_seq[seq_idx % len(cm.sync_seq)]
        seq_idx += 1
    return fd

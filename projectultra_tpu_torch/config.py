"""Modem configuration: enums and ModemConfig.

The port's own copy of the JAX package's config layer (reference:
include/ultra/types.hpp:27-367), pinned field for field and property for
property to the original by ``tests/test_torch_host.py``, with
``FrameType`` and the speed-profile presets (types.hpp:262-367).
``ModemConfig`` is a frozen dataclass, so it keys
the port's per-config table caches; every derived quantity is a plain
Python int (a shape).
"""

from __future__ import annotations

import dataclasses
import enum


class Modulation(enum.IntEnum):
    """Modulation schemes (reference: include/ultra/types.hpp:27-39)."""
    DBPSK = 0
    BPSK = 1
    DQPSK = 2
    QPSK = 3
    D8PSK = 4
    QAM8 = 5
    QAM16 = 6
    QAM32 = 7
    QAM64 = 8
    QAM256 = 10
    AUTO = 0xFF


def bits_per_symbol(mod: Modulation) -> int:
    """Bits carried per constellation symbol (types.hpp:42-56)."""
    return {
        Modulation.DBPSK: 1, Modulation.BPSK: 1,
        Modulation.DQPSK: 2, Modulation.QPSK: 2,
        Modulation.D8PSK: 3, Modulation.QAM8: 3,
        Modulation.QAM16: 4, Modulation.QAM32: 5,
        Modulation.QAM64: 6, Modulation.QAM256: 8,
    }.get(mod, 1)


def is_differential(mod: Modulation) -> bool:
    return mod in (Modulation.DBPSK, Modulation.DQPSK, Modulation.D8PSK)


class CyclicPrefixMode(enum.IntEnum):
    """(types.hpp:76-80)"""
    SHORT = 0   # 32 samples @512 FFT
    MEDIUM = 1  # 48
    LONG = 2    # 64


class SpeedProfile(enum.IntEnum):
    CONSERVATIVE = 0
    BALANCED = 1
    TURBO = 2
    ADAPTIVE = 3


class CodeRate(enum.IntEnum):
    """FEC code rates.  Integer values matter: the LDPC H-matrix RNG seed is
    ``0x12345678 + int(rate)`` (reference: src/fec/ldpc_encoder.cpp:77)."""
    R1_4 = 0
    R1_3 = 1
    R1_2 = 2
    R2_3 = 3
    R3_4 = 4
    R5_6 = 5
    R7_8 = 6
    AUTO = 0xFF


def code_rate_value(rate: CodeRate) -> float:
    """(types.hpp:103-114)"""
    return {
        CodeRate.R1_4: 0.25, CodeRate.R1_3: 0.333, CodeRate.R1_2: 0.5,
        CodeRate.R2_3: 0.667, CodeRate.R3_4: 0.75, CodeRate.R5_6: 0.833,
        CodeRate.R7_8: 0.875,
    }.get(rate, 0.5)


class FrameType(enum.IntEnum):
    """(types.hpp:237-245)"""
    DATA = 0x00
    ACK = 0x01
    NACK = 0x02
    SYNC = 0x03
    PROBE = 0x04
    CONNECT = 0x05
    DISCONNECT = 0x06


@dataclasses.dataclass(frozen=True)
class ModemConfig:
    """Master DSP config (reference: include/ultra/types.hpp:139-234).

    Frozen/hashable so it can key the per-config caches.  All derived
    quantities are plain Python ints: shapes of the pipelines.
    """
    sample_rate: int = 48000
    center_freq: int = 1500

    fft_size: int = 512
    num_carriers: int = 30

    cp_mode: CyclicPrefixMode = CyclicPrefixMode.MEDIUM
    symbol_guard: int = 4

    pilot_spacing: int = 2
    use_pilots: bool = True
    scattered_pilots: bool = True

    modulation: Modulation = Modulation.QPSK
    code_rate: CodeRate = CodeRate.R1_2
    speed_profile: SpeedProfile = SpeedProfile.BALANCED

    adaptive_eq_enabled: bool = False
    adaptive_eq_use_rls: bool = False
    lms_mu: float = 0.05
    rls_lambda: float = 0.99
    decision_directed: bool = True

    output_scale: float = 40.0
    tx_cfo_hz: float = 0.0
    sync_threshold: float = 0.80

    frame_size: int = 256
    max_retries: int = 8
    arq_timeout_ms: int = 2000

    def replace(self, **kw) -> "ModemConfig":
        return dataclasses.replace(self, **kw)

    @property
    def cyclic_prefix(self) -> int:
        """CP length scales with FFT size (types.hpp:197-208)."""
        base = {CyclicPrefixMode.SHORT: 32, CyclicPrefixMode.MEDIUM: 48,
                CyclicPrefixMode.LONG: 64}.get(self.cp_mode, 48)
        return base * (self.fft_size // 512)

    @property
    def symbol_duration(self) -> int:
        return self.fft_size + self.cyclic_prefix + self.symbol_guard

    @property
    def symbol_rate(self) -> float:
        return self.sample_rate / self.symbol_duration

    @property
    def num_pilots(self) -> int:
        if not self.use_pilots:
            return 0
        return (self.num_carriers + self.pilot_spacing - 1) // self.pilot_spacing

    @property
    def data_carriers(self) -> int:
        return self.num_carriers - self.num_pilots

    def theoretical_throughput(self, mod: Modulation, rate: CodeRate) -> float:
        return (self.data_carriers * bits_per_symbol(mod)
                * code_rate_value(rate) * self.symbol_rate)


# ---------------------------------------------------------------------------
# Speed-profile presets (types.hpp:262-367)
# ---------------------------------------------------------------------------

def conservative() -> ModemConfig:
    return ModemConfig(cp_mode=CyclicPrefixMode.LONG, symbol_guard=8,
                       pilot_spacing=2, modulation=Modulation.QPSK,
                       code_rate=CodeRate.R1_2,
                       speed_profile=SpeedProfile.CONSERVATIVE)


def balanced() -> ModemConfig:
    return ModemConfig(cp_mode=CyclicPrefixMode.MEDIUM, symbol_guard=4,
                       pilot_spacing=2, modulation=Modulation.QAM64,
                       code_rate=CodeRate.R3_4,
                       speed_profile=SpeedProfile.BALANCED)


def turbo() -> ModemConfig:
    return ModemConfig(cp_mode=CyclicPrefixMode.SHORT, symbol_guard=0,
                       pilot_spacing=2, modulation=Modulation.QAM256,
                       code_rate=CodeRate.R5_6,
                       speed_profile=SpeedProfile.TURBO)


def high_throughput() -> ModemConfig:
    return ModemConfig(fft_size=1024, num_carriers=59,
                       cp_mode=CyclicPrefixMode.MEDIUM, symbol_guard=0,
                       pilot_spacing=4, modulation=Modulation.QAM16,
                       code_rate=CodeRate.R2_3,
                       speed_profile=SpeedProfile.BALANCED,
                       rls_lambda=0.97)


def nvis_mode() -> ModemConfig:
    return ModemConfig(fft_size=1024, num_carriers=59,
                       cp_mode=CyclicPrefixMode.MEDIUM, symbol_guard=0,
                       use_pilots=False, pilot_spacing=2,
                       modulation=Modulation.DQPSK, code_rate=CodeRate.R3_4,
                       speed_profile=SpeedProfile.TURBO)


def for_profile(profile: SpeedProfile) -> ModemConfig:
    return {SpeedProfile.CONSERVATIVE: conservative,
            SpeedProfile.BALANCED: balanced,
            SpeedProfile.TURBO: turbo}.get(profile, balanced)()

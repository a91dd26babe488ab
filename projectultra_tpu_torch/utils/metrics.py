"""Modem/link statistics, the stage timer and the device trace helper.

Reference: include/ultra/types.hpp:248-260 (ModemStats).  The port's copies
of the JAX package's ``ModemStats``, ``BatchMetrics`` and ``stage_timer``
(pinned field for field and by behaviour by ``tests/test_torch_host.py``);
its device trace uses ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

from ..config import Modulation, CodeRate


@dataclasses.dataclass
class ModemStats:
    """(types.hpp:248-260)"""
    bytes_sent: int = 0
    bytes_received: int = 0
    frames_sent: int = 0
    frames_received: int = 0
    frames_retransmitted: int = 0
    frames_failed: int = 0
    throughput_bps: float = 0.0
    current_snr_db: float = 0.0
    # TRUE wideband SNR (frame power vs min-statistics noise floor), the
    # calibrated_snr negotiation input; current_snr_db keeps the
    # reference's inflated per-carrier/training scale.
    wideband_snr_db: float = 0.0
    # Fade-spread companion to wideband_snr_db (90/10 dB spread of the
    # smoothed in-frame envelope; -1.0 = unmeasured).
    fade_spread_db: float = -1.0
    # Frames whose parity-free info bits were repaired by CRC syndrome
    # search (fec/crc_recover.py).
    frames_crc_recovered: int = 0
    # Frames rescued by re-demodulating with the OTHER front end
    # (real <-> analytic) after a failed decode.
    frames_front_retried: int = 0
    # Frames rescued by the sample-clock-skew resample retry
    # (modem/acquisition/cox.py).
    frames_sro_retried: int = 0
    # Frames improved by the delay-domain channel-model retry
    # (ofdm/delay_fit.py).
    frames_delayfit_retried: int = 0
    current_modulation: Modulation = Modulation.QPSK
    current_code_rate: CodeRate = CodeRate.R1_2


@dataclasses.dataclass
class BatchMetrics:
    """Per-batch device pipeline metrics (the rebuild's replacement for the
    per-decode callbacks)."""
    frames: int = 0
    decoded: int = 0
    bit_errors: int = 0
    total_bits: int = 0
    ldpc_iterations_mean: float = 0.0
    snr_estimate_db: float = 0.0
    cfo_error_hz: float = 0.0
    pipelines_per_sec: float = 0.0

    @property
    def fer(self) -> float:
        return 1.0 - self.decoded / self.frames if self.frames else 0.0

    @property
    def ber(self) -> float:
        return self.bit_errors / self.total_bits if self.total_bits else 0.0


@contextlib.contextmanager
def stage_timer(name: str, results: dict | None = None):
    """Per-stage wall-clock timer (profile_acquisition.cpp equivalent): adds
    the seconds spent in the block to ``results[name]``.  Host clock only;
    a caller timing device work synchronises inside the block."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if results is not None:
        results[name] = results.get(name, 0.0) + dt


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` trace of the CPU and, where there is one, the
    CUDA device, written to ``logdir`` as a Chrome trace."""
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

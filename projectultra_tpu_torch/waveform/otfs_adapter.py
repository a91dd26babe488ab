"""IWaveform adapter for the OTFS modem (OTFS_EQ / OTFS_RAW modes).

The port of the JAX package's adapter, on the port's ``otfs/otfs.py``;
it runs on its device (the first CUDA device when none is given).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve as resolve_device
from ..modem.acquisition.base import to_host
from ..protocol.frame_v2 import WaveformMode
from ..otfs import otfs as O
from .factory import WaveformCapabilities, SyncResult, on_device


class OTFSWaveform:
    def __init__(self, config: O.OTFSConfig | None = None, device=None):
        self.device = resolve_device(device)
        self.config = config or O.OTFSConfig()

    @property
    def mode(self) -> WaveformMode:
        return (WaveformMode.OTFS_EQ if self.config.tf_equalization
                else WaveformMode.OTFS_RAW)

    def capabilities(self) -> WaveformCapabilities:
        return WaveformCapabilities(
            supports_doppler_correction=True,
            min_snr_db=10.0, max_snr_db=35.0,
            preamble_duration_ms=self.config.preamble_len / 48.0)

    def generate_preamble(self) -> np.ndarray:
        return O.generate_preamble(self.config)

    def modulate(self, bits) -> torch.Tensor:
        return O.modulate(self.config, self.config.modulation,
                          on_device(bits, self.device))

    def detect_sync(self, samples, threshold: float = 0.7) -> SyncResult:
        samples = on_device(samples, self.device)
        found, start = O.detect_frame(self.config, samples, threshold)
        B = samples.shape[0]
        # start_sample is the PREAMBLE start (demodulate() wants the whole
        # frame span from there); OTFS has no separate training segment.
        return SyncResult(to_host(found), to_host(start),
                          np.zeros(B, np.float32), np.ones(B, np.float32),
                          has_training=False)

    def demodulate(self, frame_span) -> torch.Tensor:
        """frame_span aligned at PREAMBLE start, length >= frame_len."""
        return O.demodulate_frame(self.config, self.config.modulation,
                                  on_device(frame_span, self.device))

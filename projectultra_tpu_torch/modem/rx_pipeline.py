"""RxPipeline: streaming detect -> demodulate -> decode over one waveform.

Reference: src/gui/modem/rx_pipeline.{hpp,cpp}.  The reference implementation
is documented as known-buggy (docs/KNOWN_BUGS.md BUG-002) and production uses
the ModemEngine legacy paths; this is a WORKING equivalent built on the
waveform adapters: feed audio chunks, poll for complete frames.

The port's copy of the JAX package's pipeline: its adapter and its engine
run on the device it is given (the first CUDA device when none is; raises
without one).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import CodeRate
from ..protocol import frame_v2 as F
from ..protocol.frame_v2 import WaveformMode
from ..waveform import factory as WF


class RxPipeline:
    """One PERSISTENT ModemEngine drives acquisition+decode across feeds
    (rx_pipeline.cpp keeps its demodulator/decoder members for the pipeline's
    lifetime too): per-chunk construction would redo waveform setup every
    20 ms chunk and drop any cross-chunk acquisition state (_dpsk_pending,
    _dpsk_searched_until, Cox wait status)."""

    def __init__(self, mode: WaveformMode = WaveformMode.MC_DPSK,
                 rate: CodeRate = CodeRate.R1_4,
                 device: torch.device | None = None, **kw):
        from ..modem.engine import ModemEngine
        self.waveform = WF.create(mode, device=device, **kw)
        self.rate = rate
        self._frames: list[bytes] = []
        self._engine = ModemEngine(device=self.waveform.device)
        # Follow the adapter's EFFECTIVE mode (create() maps MFSK->MC_DPSK,
        # waveform_factory.cpp:33-36) so engine and adapter agree.
        self._engine.set_waveform_mode(self.waveform.mode)
        # Honor the pipeline's configured rate on the probe path: the engine
        # tries [R1/4, data_code_rate] for CW0 (modem_engine decode order),
        # so a non-default `rate` must land in data_code_rate with
        # `connected` set, or it would never be attempted.
        self._engine.data_code_rate = rate
        if rate != CodeRate.R1_4:
            self._engine.connected = True
        if mode == WaveformMode.DPSK:
            self._engine.connect_waveform = mode
        # Propagate EXPLICIT waveform kwargs (e.g. num_carriers) to the
        # engine so adapter and decode path agree; with no kwargs keep the
        # engine's own default (level10 / 13 carriers, modem_engine.cpp:73 —
        # the adapter's 8-carrier default is the IWaveform ctor default and
        # would desync from an engine-driven TX).
        mc = getattr(self.waveform, "config", None)
        if kw and self.waveform.mode == WaveformMode.MC_DPSK and mc is not None:
            self._engine.mc_config = mc
            self._engine.chirp_config = mc.chirp_config()
        if self.waveform.mode == WaveformMode.DPSK and mc is not None:
            self._engine.dpsk_config = mc
        if (kw and self.waveform.mode == WaveformMode.OFDM_COX
                and mc is not None):
            # e.g. RxPipeline(mode=OFDM_COX, config=nvis_mode()): the
            # engine's Cox acquisition/decode must use the adapter's
            # ModemConfig or an NVIS (1024-FFT) peer never decodes.
            self._engine.config = mc
        self._engine.on_frame = \
            lambda fr: self._frames.append(fr.frame_bytes)
        self._engine.on_ping = lambda snr: None

    def feed_audio(self, samples: np.ndarray) -> bool:
        """Append audio; returns True when at least one frame is ready."""
        self._engine.feed_audio(np.asarray(samples, np.float32))
        self._engine.poll()
        return self.has_frame()

    def has_frame(self) -> bool:
        return bool(self._frames)

    def get_frame(self) -> Optional[bytes]:
        return self._frames.pop(0) if self._frames else None

    def reset(self):
        """Drop buffered audio AND all acquisition state via the engine's
        own reset_rx() (which owns the full list of acquisition fields —
        no reaching into engine internals from here)."""
        self._engine.reset_rx()
        self._frames.clear()

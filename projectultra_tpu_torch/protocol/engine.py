"""ProtocolEngine: facade wiring Connection + ARQ to a ModemEngine.

Reference: src/protocol/protocol_engine.{hpp,cpp}.  Bridges the host-side
protocol FSMs to the modem's audio-level TX/RX:

  Connection.on_transmit -> ModemEngine.transmit (waveform per state)
  ModemEngine.on_frame   -> Connection.on_frame_received
  Connection.on_ping_tx  -> ModemEngine.transmit_ping
  ModemEngine.on_ping    -> Connection.on_pong_received / incoming ping

The port's copy of the JAX package's engine, which drives the port's
``ModemEngine`` on the device it is given (the first CUDA device when
none is; raises without one): on a card every frame of a session decodes
through the LDPC kernel and every OFDM_COX search runs the Schmidl-Cox
window kernel.  The TX drain queue, the ARQ-stall fallback and the
calibrated-SNR paths read line for line like the original.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import Modulation, CodeRate
from ..modem.engine import ModemEngine, DecodedFrame
from .connection import Connection, ConnectionConfig, ConnectionState
from .frame_v2 import WaveformMode


class ProtocolEngine:
    # Retransmission margin (beyond one full window burst) with zero
    # ACK progress before the ARQ-stall fallback steps the data mode
    # down (see tick()): a single lost SACK times out every in-flight
    # slot at once (+window_size retransmissions in one tick), which is
    # routine and must not downgrade a healthy session — the threshold
    # is window_size + STALL_MARGIN so it takes a SECOND timeout round.
    STALL_MARGIN = 2

    def __init__(self, modem: ModemEngine | None = None,
                 config: ConnectionConfig | None = None,
                 device: torch.device | None = None):
        self.modem = modem or ModemEngine(device=device)
        self.connection = Connection(config)

        # SNR-driven (modulation, rate) adaptation with hysteresis
        # (src/gui/adaptive_mode.cpp — the GUI drives this per decoded frame).
        from ..modem.adaptive import AdaptiveModeController
        self.adaptive = AdaptiveModeController()
        self.adaptive_enabled = True

        # Audio sink: application supplies how TX audio leaves the station
        # (AudioEngine / channel sim / file).
        self.on_tx_audio: Optional[Callable[[np.ndarray], None]] = None
        self._tx_queue: list = []
        self._tx_draining = False
        # ARQ-stall fallback state: (acks_received, retransmissions)
        # snapshot at the last ACK progress or mode step-down (see tick).
        self._stall_base: tuple | None = None

        self.connection.on_transmit = self._tx_frame
        self.connection.on_ping_tx = self._tx_ping
        self.connection.on_mode_negotiated = self._apply_mode
        self.connection.on_data_mode_changed = self._apply_data_mode
        self.connection.on_connected = self._on_connected
        self.connection.on_disconnected = self._on_disconnected

        self.modem.on_frame = self._on_modem_frame
        self.modem.on_ping = self._on_modem_ping

    # --- outgoing ---------------------------------------------------------
    #
    # TX rides a drain queue: protocol callbacks can request transmissions
    # from inside RX processing (ACKs, mode changes, the next ARQ frame),
    # and with a synchronous audio link each nested transmit would recurse
    # one level deeper per exchanged frame.  The queue flattens that — the
    # reference gets the same effect from its threaded audio TX queue.

    def _tx_frame(self, frame_bytes: bytes):
        self._enqueue_tx(("frame", frame_bytes))

    def _tx_ping(self):
        self._enqueue_tx(("ping", None))

    def _enqueue_tx(self, item):
        # Snapshot the data mode at ENQUEUE time: a MODE_CHANGE applied
        # between enqueue and drain must not re-modulate frames that the
        # protocol requested under the old mode (the announcement itself
        # must leave at the old mode or the peer cannot demodulate it).
        self._tx_queue.append(item + (self.modem.data_modulation,
                                      self.modem.data_code_rate))
        if self._tx_draining:
            return
        self._tx_draining = True
        try:
            while self._tx_queue:
                kind, payload, mod, rate = self._tx_queue.pop(0)
                cur = (self.modem.data_modulation, self.modem.data_code_rate)
                self.modem.data_modulation = mod
                self.modem.data_code_rate = rate
                try:
                    audio = (self.modem.transmit(payload) if kind == "frame"
                             else self.modem.transmit_ping())
                finally:
                    (self.modem.data_modulation,
                     self.modem.data_code_rate) = cur
                if self.on_tx_audio is not None and len(audio):
                    self.on_tx_audio(audio)
        finally:
            self._tx_draining = False

    # --- incoming ----------------------------------------------------------

    def feed_audio(self, samples: np.ndarray):
        self.modem.feed_audio(samples)
        self.modem.poll()

    def _on_modem_frame(self, frame: DecodedFrame):
        # Feed the per-frame SNR estimate into mode negotiation
        # (ModemEngine::getCurrentSNR -> Connection::setMeasuredSNR).
        # calibrated_snr consumes the engine's TRUE wideband estimate;
        # the default keeps the reference's inflated estimator scale.
        #
        # Calibrated mode skips MID-SESSION Cox CONTROL frames (ACK /
        # KEEPALIVE / MODE_CHANGE): the reference's constellation scales
        # put their DBPSK R1/4 modulation ~4 dB hotter than QAM data
        # symbols, and the harness noise normalization (INV-TEST-001,
        # active-average per transmission) then makes a power-vs-floor
        # estimate read those frames +4-6 dB above the data-frame scale
        # the mode tables were calibrated on — measured: a 34 dB NVIS
        # session's ACKs read 37-40 while its data frames read ~34,
        # scattering the flat-evidence window and blocking the high-order
        # climb.  Data frames are plentiful in any session that has
        # something to adapt for; pre-connect CONNECT/CONNECT_ACK (chirp-
        # led MC-DPSK, all-DBPSK scale) still feed accept-time
        # negotiation.
        calibrated = self.connection.config.calibrated_snr
        skip_reading = (calibrated and frame.header.is_control
                        and frame.waveform == WaveformMode.OFDM_COX)
        meas = frame.wideband_snr_db if calibrated else frame.snr_db
        if meas and not skip_reading:
            self.connection.set_measured_snr(meas, frame.fade_spread_db)
        # Mid-session adaptation: the default controller's thresholds are
        # calibrated for OFDM pilot SNR (adaptive_mode.cpp:21-31) — MC-DPSK
        # training estimates live on a different scale and must not drive
        # mode changes.  In calibrated mode the hysteresis machinery runs
        # on the wideband estimate with the measured-envelope table
        # (CalibratedAdaptiveController), which is meaningful for EVERY
        # waveform.  Adapt only: (a) on the session INITIATOR — two
        # independent controllers cross MODE_CHANGE requests and diverge
        # the ends; (b) while the ARQ is idle — a change straddling
        # in-flight data frames demodulates them at the wrong mode and
        # costs a retry round per frame.
        if self.connection.config.calibrated_snr:
            from ..modem.adaptive import (CalibratedAdaptiveController,
                                          high_order_table,
                                          exact_order_table)
            if not isinstance(self.adaptive, CalibratedAdaptiveController):
                # Profile-aware ladders: NVIS climbs its own R5/6 rows;
                # pilot plans get the flat-gated R2/3 ladder plus the
                # low-CFO EXACT ladder (real-front R5/6 rows).
                self.adaptive = CalibratedAdaptiveController(
                    high_table=high_order_table(self.modem.config),
                    exact_table=exact_order_table(self.modem.config))
            ctrl_snr = frame.wideband_snr_db
            wf_ok = True
        else:
            ctrl_snr = frame.snr_db
            wf_ok = frame.waveform == WaveformMode.OFDM_COX
        if skip_reading and frame.wideband_snr_db:
            # One-way sessions (file transfer: the sender receives only
            # ACKs) must not go feedback-blind: control-frame readings
            # feed a DOWNGRADE-ONLY path (used uncorrected as an UPPER
            # bound — adaptive.observe_control) so a fading channel can
            # still close an open high-order mode mid-transfer.
            if (self.adaptive_enabled and self.connection.is_connected
                    and self.connection.is_initiator
                    and hasattr(self.adaptive, "observe_control")
                    and self.adaptive.observe_control(
                        frame.wideband_snr_db, frame.fade_spread_db)):
                self.connection.request_mode_change(
                    self.adaptive.current_mod, self.adaptive.current_rate)
        if ctrl_snr and not skip_reading:
            arq_idle = getattr(self.connection.arq, "in_flight", 0) == 0
            if self.connection.config.calibrated_snr:
                # Outage-aware update: the calibrated controller penalizes
                # the reading by the frame's measured fade spread; the
                # detected CFO feeds the exact-ladder low-CFO gate.
                def _upd():
                    return self.adaptive.update(ctrl_snr,
                                                frame.fade_spread_db,
                                                cfo_hz=frame.cfo_hz)
            else:
                def _upd():
                    return self.adaptive.update(ctrl_snr)
            if (self.adaptive_enabled and self.connection.is_connected
                    and self.connection.is_initiator and arq_idle
                    and wf_ok and _upd()):
                self.connection.request_mode_change(
                    self.adaptive.current_mod, self.adaptive.current_rate)
        self.modem.last_rx_waveform = frame.waveform
        self.connection.on_frame_received(frame.frame_bytes)
        # Re-sync modem state: handshake confirmation flips on the first
        # frame received while CONNECTED (modem_engine's
        # handshake_complete_ tracks it continuously in the reference).
        self.modem.connected = self.connection.is_connected
        self.modem.handshake_complete = self.connection.handshake_confirmed

    def _on_modem_ping(self, snr_db: float):
        if self.connection.state == ConnectionState.PROBING:
            self.connection.on_pong_received()
        else:
            # Someone is calling us: respond with PONG (chirp).
            if self.connection.state == ConnectionState.DISCONNECTED:
                self._tx_ping()

    # --- mode plumbing ------------------------------------------------------

    def _apply_mode(self, mode: WaveformMode):
        self.modem.set_waveform_mode(mode)

    def _apply_data_mode(self, mod: Modulation, rate: CodeRate, snr: float):
        # Remember the outgoing mode: frames already in flight were
        # modulated with it (RX fallback in _decode_frame_cox).
        self.modem.prev_data_modulation = self.modem.data_modulation
        self.modem.prev_data_code_rate = self.modem.data_code_rate
        self.modem.data_modulation = mod
        self.modem.data_code_rate = rate
        # Keep the adaptive controller in sync with externally negotiated
        # modes so its hysteresis starts from reality.
        self.adaptive.current_mod = mod
        self.adaptive.current_rate = rate
        self.adaptive.frames_at_current = 0

    def _on_connected(self):
        self.modem.connected = True
        self.modem.handshake_complete = self.connection.handshake_confirmed

    def _on_disconnected(self, reason: str):
        self.modem.disconnect_waveform = self.modem.waveform_mode
        self.modem.connected = False
        self.modem.handshake_complete = False

    # --- passthroughs ---------------------------------------------------

    def connect(self, remote: str) -> bool:
        return self.connection.connect(remote)

    def disconnect(self):
        self.connection.disconnect()

    def send_message(self, text: str) -> bool:
        return self.connection.send_message(text)

    def tick(self, elapsed_ms: int):
        self.connection.tick(elapsed_ms)
        # ARQ-stall mode fallback (calibrated sessions): when the channel
        # degrades below the current mode's envelope mid-transfer, the
        # peer decodes nothing, sends no ACKs, and NO reading ever
        # arrives to drive adaptation — the session would retry at the
        # dead mode until exhaustion.  The retry pattern itself is the
        # evidence: window_size + STALL_MARGIN retransmissions with zero
        # ACK progress step the data mode down to the next always-safe
        # main-table row.  Resets on any ACK.
        if (self.connection.config.calibrated_snr and self.adaptive_enabled
                and self.connection.is_connected
                and self.connection.is_initiator
                and hasattr(self.adaptive, "step_down")):
            st = getattr(self.connection.arq, "stats", None)
            if st is not None:
                acks = st.acks_received
                retx = st.retransmissions
                thresh = getattr(self.connection.arq.config,
                                 "window_size", 4) + self.STALL_MARGIN
                if self._stall_base is None or acks != self._stall_base[0]:
                    self._stall_base = (acks, retx)
                elif retx - self._stall_base[1] >= thresh:
                    if self.adaptive.step_down():
                        self.connection.request_mode_change(
                            self.adaptive.current_mod,
                            self.adaptive.current_rate)
                    self._stall_base = (acks, retx)

"""Connection manager: PING probe -> CONNECT handshake -> ARQ data -> teardown.

Reference: src/protocol/{connection.hpp, connection.cpp,
connection_handlers.cpp}.  Host-side FSM:

  DISCONNECTED -> PROBING (PING x5) -> CONNECTING (CONNECT x retries)
               -> CONNECTED (ARQ data, keepalives) -> DISCONNECTING

Mode negotiation (connection_handlers.cpp:negotiateMode): capability
bitmap intersection, preference honoring, SNR-threshold AUTO selection
(<0 dB MFSK, <17 dB MC_DPSK, else OFDM_COX).  Data mode from the SNR table
(recommendDataMode, :13-46), carried in CONNECT_ACK.

The port's copy of the JAX package's module, pinned to it by
``tests/test_torch_protocol_stack.py``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

from ..config import Modulation, CodeRate
from . import frame_v2 as F
from .arq import ARQConfig, ARQMode, SelectiveRepeatARQ, create_arq
from .file_transfer import FileTransferController, PayloadType
from .frame_v2 import WaveformMode, ModeCapabilities


def _wire_waveform(value: int, fallback):
    """Parse a WaveformMode byte FROM THE WIRE.  DPSK (0x06) is an
    engine-local extension with no ModeCapabilities bit — the reference's
    wire enum tops out at 0x05, so accepting 0x06 from a peer would switch
    the session onto a waveform the peer cannot demodulate (frame_v2.py
    WaveformMode docstring: "never negotiated ... never appears on the
    wire").  Unknown or local-only values degrade to the fallback."""
    if value in WaveformMode._value2member_map_ \
            and WaveformMode(value) != WaveformMode.DPSK:
        return WaveformMode(value)
    return fallback


class ConnectionState(enum.IntEnum):
    DISCONNECTED = 0
    PROBING = 1
    CONNECTING = 2
    CONNECTED = 3
    DISCONNECTING = 4


DPSK_ATTEMPTS = 5
KEEPALIVE_INTERVAL_MS = 60000
KEEPALIVE_MAX_MISSED = 3


@dataclasses.dataclass
class ConnectionConfig:
    """(connection.hpp:25-41)"""
    arq: ARQConfig = dataclasses.field(default_factory=ARQConfig)
    connect_timeout_ms: int = 60000
    disconnect_timeout_ms: int = 30000
    connect_retries: int = 10
    auto_accept: bool = True
    mode_capabilities: int = int(ModeCapabilities.ALL)
    preferred_mode: WaveformMode = WaveformMode.AUTO
    forced_modulation: Modulation = Modulation.AUTO
    forced_code_rate: CodeRate = CodeRate.AUTO
    arq_mode: ARQMode = ARQMode.SELECTIVE_REPEAT
    # Round-3 opt-in: negotiate from TRUE wideband SNR (the engine's
    # frame-power-vs-noise-floor estimate) against tables calibrated on
    # measured decode envelopes, instead of the reference's inflated
    # per-carrier/training scale (default keeps reference parity, whose
    # auto-picks exceed the channel envelope below ~12 dB true SNR).
    calibrated_snr: bool = False


def recommend_data_mode(snr_db: float) -> tuple[Modulation, CodeRate]:
    """SNR -> (modulation, rate) table (connection_handlers.cpp:13-46).
    Thresholds live on the reference's INFLATED frame/pilot SNR scale."""
    if snr_db >= 30.0:
        return Modulation.QAM16, CodeRate.R3_4
    if snr_db >= 25.0:
        return Modulation.QAM16, CodeRate.R2_3
    if snr_db >= 20.0:
        return Modulation.DQPSK, CodeRate.R2_3
    if snr_db >= 16.0:
        return Modulation.DQPSK, CodeRate.R1_2
    if snr_db >= 12.0:
        return Modulation.DQPSK, CodeRate.R1_4
    return Modulation.DBPSK, CodeRate.R1_4


def recommend_data_mode_calibrated(true_snr_db: float
                                   ) -> tuple[Modulation, CodeRate]:
    """TRUE-wideband-SNR -> (modulation, rate), calibrated on MEASURED
    decode envelopes (tools/calibrate_mode_table.py, 2026-08-17 run:
    engine loopback decode rates over AWGN and moderate-fading Watterson).
    Key measured facts: Schmidl-Cox ACQUISITION floors OFDM_COX at ~14 dB
    wideband AWGN regardless of data mode (faithful to the reference's
    plateau gate), single AWGN envelopes are QAM16 R2/3 @17, DQPSK R2/3
    @15, DQPSK R1/2 @15; below the Cox floor the waveform pick
    (negotiate_mode) routes to MC_DPSK where R1/4 holds to ~2 dB on
    moderate fading with ARQ covering residual fade losses.  Thresholds
    carry ~2-3 dB margin for fading.  No R3/4 ceiling row: its parity-free
    info bits corrupt LONG frames at any SNR on the 512 plan's ICI floor
    (see CalibratedAdaptiveController.TABLE) — QAM16 R2/3 is the non-flat
    ceiling and the flat-gated ladder climbs past it mid-session.  Used
    when ConnectionConfig.calibrated_snr is on; the default table above
    keeps reference parity."""
    if true_snr_db >= 20.0:
        return Modulation.QAM16, CodeRate.R2_3
    if true_snr_db >= 17.0:
        return Modulation.DQPSK, CodeRate.R2_3
    if true_snr_db >= 15.0:
        return Modulation.DQPSK, CodeRate.R1_2
    if true_snr_db >= 11.0:
        return Modulation.DQPSK, CodeRate.R1_4
    return Modulation.DBPSK, CodeRate.R1_4


_MODE_BITS = {
    WaveformMode.OFDM_COX: ModeCapabilities.OFDM_COX,
    WaveformMode.OTFS_EQ: ModeCapabilities.OTFS_EQ,
    WaveformMode.OTFS_RAW: ModeCapabilities.OTFS_RAW,
    WaveformMode.MFSK: ModeCapabilities.MFSK,
    WaveformMode.MC_DPSK: ModeCapabilities.MC_DPSK,
    WaveformMode.OFDM_CHIRP: ModeCapabilities.OFDM_CHIRP,
}


class Connection:
    def __init__(self, config: ConnectionConfig | None = None):
        self.config = config or ConnectionConfig()
        self.state = ConnectionState.DISCONNECTED
        self.local_call = ""
        self.remote_call = ""
        self.remote_hash = 0
        self.negotiated_mode = WaveformMode.OFDM_COX
        self.data_modulation = Modulation.QPSK
        self.data_code_rate = CodeRate.R1_2
        self.measured_snr_db = 15.0
        # Decaying max of recent frames' fade-spread readings (engine
        # fade_spread_db: ~0-1 dB AWGN, ~5-9 dB Watterson; -1 unknown).
        # A single high reading is hard evidence of fading and disquali-
        # fies the benign relaxation for a while; benign needs sustained
        # low readings.  Starts unknown = no relaxation.
        self.measured_fade_spread_db = -1.0
        self.is_initiator = False
        self.handshake_confirmed = False

        self.arq = create_arq(self.config.arq_mode, self.config.arq)
        self.file_transfer = FileTransferController()

        # Callbacks (connection.hpp:62-140).
        self.on_transmit: Optional[Callable[[bytes], None]] = None
        self.on_connected: Optional[Callable[[], None]] = None
        self.on_disconnected: Optional[Callable[[str], None]] = None
        self.on_message_received: Optional[Callable[[str], None]] = None
        self.on_message_sent: Optional[Callable[[bool], None]] = None
        self.on_incoming_call: Optional[Callable[[str], None]] = None
        self.on_data_received: Optional[Callable[[bytes, bool], None]] = None
        self.on_ping_tx: Optional[Callable[[], None]] = None
        self.on_ping_received: Optional[Callable[[], None]] = None
        self.on_state_changed: Optional[Callable[[ConnectionState, str], None]] = None
        self.on_mode_negotiated: Optional[Callable[[WaveformMode], None]] = None
        self.on_data_mode_changed: Optional[Callable[[Modulation, CodeRate, float], None]] = None

        self.arq.on_transmit = self._transmit
        self.arq.on_data_received = self._on_arq_data
        self.arq.on_send_complete = self._on_arq_send_complete
        # FIFO of in-flight ARQ payload kinds ("msg"/"file"), one per
        # accepted send_data: completions pop in the same order.
        from collections import deque
        self._send_kinds: "deque[str]" = deque()

        self._timer_ms = 0
        self._retry_count = 0
        self._keepalive_timer = 0
        self._keepalives_missed = 0
        self._pending_remote = ""
        self._pending_hash = 0
        self._disconnect_resends = 0
        self._disconnect_resend_at = 0
        self._pending_forced_mod = Modulation.AUTO
        self._pending_forced_rate = CodeRate.AUTO
        self.stats_connects_initiated = 0
        self.stats_connects_received = 0
        self.stats_connects_failed = 0
        self.stats_disconnects = 0

    # ------------------------------------------------------------------

    def set_local_callsign(self, call: str):
        self.local_call = F.sanitize_callsign(call)

    def set_measured_snr(self, snr_db: float,
                         fade_spread_db: float | None = None):
        self.measured_snr_db = snr_db
        if fade_spread_db is not None and fade_spread_db >= 0.0:
            self.measured_fade_spread_db = max(
                fade_spread_db, 0.7 * self.measured_fade_spread_db)

    def _set_state(self, state: ConnectionState, info: str = ""):
        self.state = state
        if self.on_state_changed:
            self.on_state_changed(state, info)

    def _transmit(self, data: bytes):
        if self.on_transmit:
            self.on_transmit(data)

    # --- Connect / disconnect -----------------------------------------

    def connect(self, remote_call: str) -> bool:
        if self.state != ConnectionState.DISCONNECTED or not self.local_call:
            return False
        self.remote_call = F.sanitize_callsign(remote_call)
        self.is_initiator = True
        self.stats_connects_initiated += 1
        self._retry_count = 0
        self._timer_ms = self.config.connect_timeout_ms
        self._set_state(ConnectionState.PROBING, self.remote_call)
        if self.on_ping_tx:
            self.on_ping_tx()
        return True

    def on_pong_received(self):
        """(connection_handlers.cpp:52-96): PONG during PROBING -> CONNECTING."""
        if self.state != ConnectionState.PROBING:
            if self.state == ConnectionState.DISCONNECTED and self.on_ping_received:
                self.on_ping_received()
            return
        self._set_state(ConnectionState.CONNECTING, self.remote_call)
        self._timer_ms = self.config.connect_timeout_ms
        self._send_connect()

    def _send_connect(self):
        frame = F.ConnectFrame.make_connect(
            self.local_call, self.remote_call,
            self.config.mode_capabilities, int(self.config.preferred_mode),
            int(self.config.forced_modulation), int(self.config.forced_code_rate))
        self._transmit(frame.serialize())

    def disconnect(self):
        if self.state not in (ConnectionState.CONNECTED,
                              ConnectionState.CONNECTING):
            return
        self._set_state(ConnectionState.DISCONNECTING)
        self._timer_ms = self.config.disconnect_timeout_ms
        # Retransmit schedule (beyond-reference, wire-compatible): the
        # reference sends DISCONNECT exactly once and relies on the remote's
        # keepalive timeout (3 x 60 s) when it is lost — measured ~20%
        # per-frame loss for a 3-CW OTFS frame inside a Watterson-good flat
        # fade makes that a 3-minute hang.  Duplicates are idempotent at
        # the peer (_handle_disconnect in CONNECTED acks + disconnects, in
        # DISCONNECTED it is ignored), so resend up to twice at 1/3 and 2/3
        # of the timeout window.
        self._disconnect_resends = 2
        self._disconnect_resend_at = self._timer_ms - \
            self.config.disconnect_timeout_ms // 3
        frame = F.ConnectFrame.make_disconnect(self.local_call, self.remote_call)
        self._transmit(frame.serialize())

    def accept_call(self):
        if not self._pending_remote:
            return
        self._accept(self._pending_remote, self._pending_hash,
                     self._pending_forced_mod, self._pending_forced_rate)

    def reject_call(self):
        if self._pending_hash:
            nak = F.ConnectFrame.make_connect_nak(
                self.local_call, self._pending_remote)
            self._transmit(nak.serialize())
            self._pending_remote = ""
            self._pending_hash = 0

    # --- Data ----------------------------------------------------------

    def send_message(self, text: str) -> bool:
        if self.state != ConnectionState.CONNECTED:
            return False
        payload = bytes([int(PayloadType.TEXT_MESSAGE)]) + text.encode()
        if self.arq.send_data(payload):
            self._send_kinds.append("msg")
            return True
        return False

    def is_ready_to_send(self) -> bool:
        return (self.state == ConnectionState.CONNECTED
                and self.arq.is_ready_to_send())

    def send_file(self, filepath: str) -> bool:
        if self.state != ConnectionState.CONNECTED:
            return False
        if not self.file_transfer.start_send(filepath):
            return False
        self._pump_file()
        return True

    def _pump_file(self):
        while (self.file_transfer.has_more_chunks()
               and self.arq.is_ready_to_send()):
            chunk = self.file_transfer.get_next_chunk()
            if not chunk:
                break
            flags = int(F.Flags.VERSION_V2)
            if self.file_transfer.has_more_chunks():
                flags |= int(F.Flags.MORE_FRAG)
            if self.arq.send_data_with_flags(chunk, flags):
                self._send_kinds.append("file")

    # --- Mode negotiation -----------------------------------------------

    def negotiate_mode(self, remote_caps: int,
                       remote_pref: WaveformMode) -> WaveformMode:
        """(connection_handlers.cpp negotiateMode)"""
        common = self.config.mode_capabilities & remote_caps
        if common == 0:
            return WaveformMode.OFDM_COX
        if remote_pref != WaveformMode.AUTO and \
                common & int(_MODE_BITS.get(remote_pref, 0)):
            return remote_pref
        if self.config.preferred_mode != WaveformMode.AUTO and \
                common & int(_MODE_BITS.get(self.config.preferred_mode, 0)):
            return self.config.preferred_mode
        snr = self.measured_snr_db
        # Waveform pick: reference thresholds (<0 MFSK, <17 MC_DPSK) live
        # on the inflated scale; the calibrated variants are on TRUE
        # wideband SNR.  Measured (tools/calibrate_mode_table.py): the
        # Schmidl-Cox plateau gate floors OFDM_COX acquisition at ~14 dB
        # wideband AWGN regardless of data mode, while MC_DPSK R1/4 holds
        # to ~2 dB on moderate fading — so everything below 15 dB true
        # routes to MC_DPSK.
        # mc_below sits ABOVE the 15 dB Cox floor: a single short frame
        # under fading reads near-peak SNR (no fade dip fits inside one
        # coherence time), and Cox under moderate fading needs ~19+ true —
        # the ambiguous 15-17 band routes to the robust waveform, where
        # MC_DPSK R1/4 still delivers (measured envelope).
        mfsk_below, mc_below = (-4.0, 17.0) if self.config.calibrated_snr \
            else (0.0, 17.0)
        # Fade-aware routing (calibrated mode only).  The engine's fade
        # detector (engine._wideband_snr_db fade_spread_db: AWGN reads
        # ~0-1 dB, every Watterson preset >=3.4 dB over >=1 s of pooled
        # active signal) splits the one-size 17 dB guard band three ways:
        # - channel PROVEN FLAT (sustained spread <2.5): deep Cox
        #   acquisition (PARITY.md deviation 9, streaming floor ~8 dB)
        #   carries OFDM_COX down to the DQPSK R1/4 envelope; 11 dB keeps
        #   ~3 dB margin over the measured 6/6-at-8-9-dB floor.
        # - channel PROVEN FADING (spread >=2.5): Cox acquisition under
        #   moderate fading needs ~19 dB true — 21 adds margin for the
        #   estimator's +-2.5 dB single-frame scatter under fades.  (The
        #   old 17 threshold was calibrated against the body-only
        #   estimator scale, which read chirp-led frames ~3 dB low.)
        # - spread UNKNOWN (short frames only): keep 17, the mixed-case
        #   compromise.
        if self.config.calibrated_snr and self.measured_fade_spread_db >= 0:
            mc_below = 11.0 if self.measured_fade_spread_db < 2.5 else 21.0
        if snr < mfsk_below and common & ModeCapabilities.MFSK:
            return WaveformMode.MFSK
        if snr < mc_below and common & ModeCapabilities.MC_DPSK:
            return WaveformMode.MC_DPSK
        for mode, bit in ((WaveformMode.OFDM_COX, ModeCapabilities.OFDM_COX),
                          (WaveformMode.OTFS_EQ, ModeCapabilities.OTFS_EQ),
                          (WaveformMode.OTFS_RAW, ModeCapabilities.OTFS_RAW),
                          (WaveformMode.MC_DPSK, ModeCapabilities.MC_DPSK),
                          (WaveformMode.MFSK, ModeCapabilities.MFSK)):
            if common & bit:
                return mode
        return WaveformMode.OFDM_COX

    # --- RX frame dispatch ----------------------------------------------

    def on_frame_received(self, frame_data: bytes):
        if len(frame_data) < 3:
            return
        ftype = frame_data[2]
        if ftype in (int(F.FrameType.CONNECT), int(F.FrameType.CONNECT_ACK),
                     int(F.FrameType.CONNECT_NAK), int(F.FrameType.DISCONNECT)):
            cf = F.ConnectFrame.deserialize(frame_data)
            if cf is None:
                return
            if cf.type == F.FrameType.CONNECT:
                self._handle_connect(cf)
            elif cf.type == F.FrameType.CONNECT_ACK:
                self._handle_connect_ack(cf)
            elif cf.type == F.FrameType.CONNECT_NAK:
                self._handle_connect_nak(cf)
            elif cf.type == F.FrameType.DISCONNECT:
                self._handle_disconnect(cf)
            return
        if self.state == ConnectionState.CONNECTED:
            if not self.handshake_confirmed:
                self.handshake_confirmed = True
            self._keepalives_missed = 0
            if ftype == int(F.FrameType.MODE_CHANGE):
                ctrl = F.ControlFrame.deserialize(frame_data)
                if ctrl:
                    self._handle_mode_change(ctrl)
                return
            if ftype == int(F.FrameType.KEEPALIVE):
                return
            self.arq.on_frame_received(frame_data)

    def request_mode_change(self, mod: Modulation, rate: CodeRate,
                            reason: int = 2) -> bool:
        """Mid-session data-mode change (MODE_CHANGE control frame,
        PROTOCOL_V2.md MODE_CHANGE payload: mod, rate, SNR, reason)."""
        if self.state != ConnectionState.CONNECTED:
            return False
        frame = F.ControlFrame.make_mode_change(
            self.local_call, self.remote_call, 0, mod, rate,
            self.measured_snr_db, reason)
        # Transmit FIRST, at the CURRENT mode: applying before transmitting
        # would modulate the announcement at the new mode, which the peer
        # cannot demodulate yet — the ends diverge permanently.
        self._transmit(frame.serialize())
        self.data_modulation, self.data_code_rate = mod, rate
        if self.on_data_mode_changed:
            self.on_data_mode_changed(mod, rate, self.measured_snr_db)
        return True

    def _handle_mode_change(self, ctrl: F.ControlFrame):
        mod, rate, snr, reason = ctrl.mode_change_info()
        # ACK goes out BEFORE applying: the requester is still listening at
        # the old mode until it hears this (see request_mode_change).
        ack = F.ControlFrame.make_ack(self.local_call, self.remote_call,
                                      ctrl.seq)
        self._transmit(ack.serialize())
        if mod != Modulation.AUTO:
            self.data_modulation = mod
        if rate != CodeRate.AUTO:
            self.data_code_rate = rate
        if self.on_data_mode_changed:
            self.on_data_mode_changed(self.data_modulation,
                                      self.data_code_rate, snr)

    def _handle_connect(self, frame: F.ConnectFrame):
        src = frame.src_callsign
        self.stats_connects_received += 1
        if self.config.auto_accept:
            self._accept(src or "REMOTE", frame.src_hash,
                         Modulation(frame.initial_modulation)
                         if frame.initial_modulation in Modulation._value2member_map_
                         else Modulation.AUTO,
                         CodeRate(frame.initial_code_rate)
                         if frame.initial_code_rate in CodeRate._value2member_map_
                         else CodeRate.AUTO,
                         remote_caps=frame.mode_capabilities,
                         remote_pref=_wire_waveform(frame.negotiated_mode,
                                                    WaveformMode.AUTO))
        else:
            self._pending_remote = src or "REMOTE"
            self._pending_hash = frame.src_hash
            self._pending_forced_mod = Modulation(frame.initial_modulation) \
                if frame.initial_modulation in Modulation._value2member_map_ \
                else Modulation.AUTO
            self._pending_forced_rate = CodeRate(frame.initial_code_rate) \
                if frame.initial_code_rate in CodeRate._value2member_map_ \
                else CodeRate.AUTO
            if self.on_incoming_call:
                self.on_incoming_call(self._pending_remote)

    def _accept(self, remote: str, remote_hash: int,
                forced_mod: Modulation, forced_rate: CodeRate,
                remote_caps: int = int(ModeCapabilities.ALL),
                remote_pref: WaveformMode = WaveformMode.AUTO):
        self.remote_call = remote
        self.remote_hash = remote_hash
        self.is_initiator = False
        self.handshake_confirmed = False
        self.negotiated_mode = self.negotiate_mode(remote_caps, remote_pref)
        snr = self.measured_snr_db
        if self.config.calibrated_snr:
            # Start CONSERVATIVE (at most DQPSK R1/2): one short frame's
            # SNR reading under fading sees no fade dip, so the initial
            # pick must not commit beyond the all-channels envelope; the
            # CalibratedAdaptiveController walks the mode UP once
            # sustained readings justify it.  When the fade detector has
            # evidence, charge the measured envelope spread (minus the
            # ~1 dB AWGN baseline) so the initial pick targets the fade
            # TROUGHS like the mid-session controller does.
            outage_snr = snr
            if self.measured_fade_spread_db > 0.0:
                outage_snr -= max(0.0, self.measured_fade_spread_db - 1.0)
            rec_mod, rec_rate = recommend_data_mode_calibrated(
                min(outage_snr, 16.0))
        else:
            rec_mod, rec_rate = recommend_data_mode(snr)
        if forced_mod != Modulation.AUTO:
            rec_mod = forced_mod
        if forced_rate != CodeRate.AUTO:
            rec_rate = forced_rate
        self.data_modulation, self.data_code_rate = rec_mod, rec_rate
        ack = F.ConnectFrame.make_connect_ack_by_hash(
            self.local_call, remote_hash, int(self.negotiated_mode),
            rec_mod, rec_rate, snr)
        self._transmit(ack.serialize())
        self._enter_connected()
        if self.on_data_mode_changed:
            self.on_data_mode_changed(rec_mod, rec_rate, snr)

    def _handle_connect_ack(self, frame: F.ConnectFrame):
        if self.state != ConnectionState.CONNECTING:
            return
        self.negotiated_mode = _wire_waveform(frame.negotiated_mode,
                                              WaveformMode.OFDM_COX)
        if frame.initial_modulation in Modulation._value2member_map_:
            self.data_modulation = Modulation(frame.initial_modulation)
        if frame.initial_code_rate in CodeRate._value2member_map_:
            self.data_code_rate = CodeRate(frame.initial_code_rate)
        if frame.src_callsign and self.remote_call in ("", "REMOTE"):
            self.remote_call = frame.src_callsign
        self.handshake_confirmed = True
        self._enter_connected()
        if self.on_data_mode_changed:
            self.on_data_mode_changed(self.data_modulation, self.data_code_rate,
                                      F.decode_snr(frame.measured_snr))

    def _handle_connect_nak(self, frame: F.ConnectFrame):
        if self.state == ConnectionState.CONNECTING:
            self.stats_connects_failed += 1
            self._set_state(ConnectionState.DISCONNECTED, "rejected")
            if self.on_disconnected:
                self.on_disconnected("rejected")

    def _handle_disconnect(self, frame: F.ConnectFrame):
        if self.state in (ConnectionState.CONNECTED,
                          ConnectionState.DISCONNECTING):
            self.stats_disconnects += 1
            # ACK the disconnect with our own DISCONNECT (simplified teardown).
            if self.state == ConnectionState.CONNECTED:
                ack = F.ConnectFrame.make_disconnect(self.local_call,
                                                     self.remote_call)
                self._transmit(ack.serialize())
            self._set_state(ConnectionState.DISCONNECTED, "remote disconnect")
            if self.on_disconnected:
                self.on_disconnected("remote disconnect")

    def _enter_connected(self):
        self.arq.set_callsigns(self.local_call, self.remote_call)
        self.arq.reset()
        self._send_kinds.clear()
        self._keepalive_timer = KEEPALIVE_INTERVAL_MS
        self._keepalives_missed = 0
        self._set_state(ConnectionState.CONNECTED, self.remote_call)
        if self.on_mode_negotiated:
            self.on_mode_negotiated(self.negotiated_mode)
        if self.on_connected:
            self.on_connected()

    # --- ARQ plumbing -----------------------------------------------------

    def _on_arq_data(self, payload: bytes):
        if self.file_transfer.process_payload(payload):
            return
        if payload and payload[0] == int(PayloadType.TEXT_MESSAGE):
            text = payload[1:].decode(errors="replace")
        else:
            text = payload.decode(errors="replace")
        if self.on_message_received:
            self.on_message_received(text)
        if self.on_data_received:
            self.on_data_received(payload, self.arq.last_rx_more_data)

    def _on_arq_send_complete(self, success: bool):
        # Route by the SEND ORDER, not by is_in_progress(): successful
        # ARQ completions fire in sequence order, and with the PIPELINED
        # chunker a text message interleaved with in-flight file chunks
        # would otherwise be miscounted as a chunk ACK — the transfer
        # could report COMPLETE while its last chunk was still
        # unacknowledged (and a later chunk failure would then be
        # misrouted to on_message_sent).
        if not success:
            # Retry-exhaustion failures can fire OUT of order (per-slot
            # timeout).  Match the pre-pipelining semantics: any failure
            # during an active transfer aborts the transfer; drop one
            # matching kind entry to keep the FIFO counts aligned.
            if self.file_transfer.is_in_progress():
                try:
                    self._send_kinds.remove("file")
                except ValueError:
                    pass
                self.file_transfer.on_chunk_acked(False)
                return
            try:
                self._send_kinds.remove("msg")
            except ValueError:
                if self._send_kinds:
                    self._send_kinds.popleft()
            if self.on_message_sent:
                self.on_message_sent(False)
            return
        kind = self._send_kinds.popleft() if self._send_kinds else (
            "file" if self.file_transfer.is_in_progress() else "msg")
        if kind == "file":
            self.file_transfer.on_chunk_acked(True)
            self._pump_file()
            return
        if self.on_message_sent:
            self.on_message_sent(True)

    # --- Timing ------------------------------------------------------------

    def tick(self, elapsed_ms: int):
        if self.state == ConnectionState.PROBING:
            self._timer_ms -= elapsed_ms
            if self._timer_ms <= 0:
                self._retry_count += 1
                if self._retry_count >= self.config.connect_retries:
                    self.stats_connects_failed += 1
                    self._set_state(ConnectionState.DISCONNECTED, "timeout")
                    if self.on_disconnected:
                        self.on_disconnected("connect timeout")
                    return
                self._timer_ms = self.config.connect_timeout_ms
                if self.on_ping_tx:
                    self.on_ping_tx()
        elif self.state == ConnectionState.CONNECTING:
            self._timer_ms -= elapsed_ms
            if self._timer_ms <= 0:
                self._retry_count += 1
                if self._retry_count >= self.config.connect_retries:
                    self.stats_connects_failed += 1
                    self._set_state(ConnectionState.DISCONNECTED, "timeout")
                    if self.on_disconnected:
                        self.on_disconnected("connect timeout")
                    return
                self._timer_ms = self.config.connect_timeout_ms
                self._send_connect()
        elif self.state == ConnectionState.CONNECTED:
            self.arq.tick(elapsed_ms)
            self._keepalive_timer -= elapsed_ms
            if self._keepalive_timer <= 0:
                self._keepalive_timer = KEEPALIVE_INTERVAL_MS
                self._keepalives_missed += 1
                if self._keepalives_missed > KEEPALIVE_MAX_MISSED:
                    self._set_state(ConnectionState.DISCONNECTED, "keepalive")
                    if self.on_disconnected:
                        self.on_disconnected("keepalive timeout")
                    return
                ka = F.ControlFrame.make_keepalive(self.local_call,
                                                   self.remote_call)
                self._transmit(ka.serialize())
        elif self.state == ConnectionState.DISCONNECTING:
            self._timer_ms -= elapsed_ms
            if self._disconnect_resends > 0 \
                    and self._timer_ms <= self._disconnect_resend_at:
                self._disconnect_resends -= 1
                self._disconnect_resend_at -= \
                    self.config.disconnect_timeout_ms // 3
                frame = F.ConnectFrame.make_disconnect(self.local_call,
                                                       self.remote_call)
                self._transmit(frame.serialize())
            if self._timer_ms <= 0:
                self.stats_disconnects += 1
                self._set_state(ConnectionState.DISCONNECTED, "local disconnect")
                if self.on_disconnected:
                    self.on_disconnected("local disconnect")

    @property
    def is_connected(self) -> bool:
        return self.state == ConnectionState.CONNECTED

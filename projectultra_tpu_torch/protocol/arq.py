"""ARQ controllers: Stop-and-Wait and Selective-Repeat.

Reference: src/protocol/{arq_interface.hpp, arq.cpp, selective_repeat_arq.cpp}.
Pure host-side state machines driven by ``on_frame_received`` + ``tick``;
frames travel as serialized v2 bytes through the transmit callback.

The port's copy of the JAX package's module, pinned to it by
``tests/test_torch_protocol_stack.py``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

from . import frame_v2 as F


class ARQMode(enum.IntEnum):
    STOP_AND_WAIT = 0
    SELECTIVE_REPEAT = 1


@dataclasses.dataclass
class ARQConfig:
    """(arq_interface.hpp:19-28)"""
    ack_timeout_ms: int = 45000
    turnaround_ms: int = 500
    max_retries: int = 3
    window_size: int = 4
    rx_buffer_size: int = 8


@dataclasses.dataclass
class ARQStats:
    frames_sent: int = 0
    frames_received: int = 0
    acks_sent: int = 0
    acks_received: int = 0
    retransmissions: int = 0
    timeouts: int = 0
    failed: int = 0
    out_of_order: int = 0
    sacks_sent: int = 0
    sacks_received: int = 0


class _ARQBase:
    def __init__(self, config: ARQConfig | None = None):
        self.config = config or ARQConfig()
        self.local_call = ""
        self.remote_call = ""
        self.stats = ARQStats()
        self.on_transmit: Optional[Callable[[bytes], None]] = None
        self.on_data_received: Optional[Callable[[bytes], None]] = None
        self.on_send_complete: Optional[Callable[[bool], None]] = None
        self.last_rx_flags = 0

    @property
    def last_rx_more_data(self) -> bool:
        return bool(self.last_rx_flags & F.Flags.MORE_FRAG)

    def set_callsigns(self, local: str, remote: str):
        self.local_call, self.remote_call = local, remote

    def _tx(self, data: bytes):
        if self.on_transmit:
            self.on_transmit(data)

    def send_data(self, data: bytes | str) -> bool:
        if isinstance(data, str):
            data = data.encode()
        return self.send_data_with_flags(data, int(F.Flags.VERSION_V2))


class StopAndWaitARQ(_ARQBase):
    """One frame in flight (arq.cpp)."""

    mode = ARQMode.STOP_AND_WAIT

    def __init__(self, config: ARQConfig | None = None):
        super().__init__(config)
        self.reset()

    def reset(self):
        self._pending: bytes | None = None
        self._pending_seq = 0
        self._timeout = 0
        self._retries = 0
        self._tx_seq = 0
        self._rx_expected = 0

    def is_ready_to_send(self) -> bool:
        return self._pending is None

    def available_slots(self) -> int:
        return 0 if self._pending is not None else 1

    def send_data_with_flags(self, data: bytes, flags: int) -> bool:
        if not self.is_ready_to_send() or not self.local_call or not self.remote_call:
            return False
        frame = F.DataFrame.make_data(self.local_call, self.remote_call,
                                      self._tx_seq, data)
        frame.flags = flags
        self._pending = frame.serialize()
        self._pending_seq = self._tx_seq
        self._timeout = self.config.ack_timeout_ms
        self._retries = 0
        self.stats.frames_sent += 1
        self._tx(self._pending)
        self._tx_seq = (self._tx_seq + 1) & 0xFFFF
        return True

    def on_frame_received(self, frame_data: bytes):
        if len(frame_data) >= 3 and F.is_data_frame(frame_data[2]):
            frame = F.DataFrame.deserialize(frame_data)
            if frame is None:
                return
            self.last_rx_flags = frame.flags
            if frame.seq == self._rx_expected:
                self.stats.frames_received += 1
                self._rx_expected = (self._rx_expected + 1) & 0xFFFF
                if self.on_data_received:
                    self.on_data_received(frame.payload)
            ack = F.ControlFrame.make_ack(self.local_call, self.remote_call,
                                          frame.seq)
            self.stats.acks_sent += 1
            self._tx(ack.serialize())
            return
        ctrl = F.ControlFrame.deserialize(frame_data)
        if ctrl is None:
            return
        if ctrl.type == F.FrameType.ACK and self._pending is not None \
                and ctrl.seq == self._pending_seq:
            self._pending = None
            self.stats.acks_received += 1
            if self.on_send_complete:
                self.on_send_complete(True)
        elif ctrl.type == F.FrameType.NACK and self._pending is not None:
            self._retransmit()

    def _retransmit(self):
        if self._retries >= self.config.max_retries:
            self.stats.failed += 1
            pending = self._pending
            self._pending = None
            if self.on_send_complete and pending is not None:
                self.on_send_complete(False)
            return
        self._retries += 1
        self.stats.retransmissions += 1
        self._timeout = self.config.ack_timeout_ms
        self._tx(self._pending)

    def tick(self, elapsed_ms: int):
        if self._pending is None:
            return
        if elapsed_ms >= self._timeout:
            self.stats.timeouts += 1
            self._retransmit()
        else:
            self._timeout -= elapsed_ms


class SelectiveRepeatARQ(_ARQBase):
    """Sliding-window ARQ with SACK (selective_repeat_arq.cpp).

    SACK = ACK frame with seq = rx_base-1 (cumulative) and payload[2] = an
    8-bit bitmap of received frames at rx_base+i (sendSack, :278-295).

    Beyond-reference deviation (wire-identical): ``sack_every`` > 1
    coalesces SACKs — every SACK frame is a full preamble + codeword of
    return audio, and with the pipelined file chunker one per data frame
    is ~30% of channel time at high-order modes.  The cumulative base +
    bitmap already acknowledges everything received, so the receiver may
    send one SACK per N in-order arrivals; a GAP in the window (out-of-
    order arrival) still SACKs immediately (that SACK is the sender's
    fast-retransmit signal), and tick() flushes a pending SACK after
    ``sack_holdoff_ms`` so the final frames of a burst are never
    starved.  Default 1 = reference-exact per-frame SACKs."""

    sack_every = 1
    sack_holdoff_ms = 4000

    mode = ARQMode.SELECTIVE_REPEAT
    MAX_WINDOW = 8

    def __init__(self, config: ARQConfig | None = None):
        super().__init__(config)
        self.reset()

    def reset(self):
        W = self.MAX_WINDOW
        self.tx_window = [dict(active=False, frame=b"", seq=0, timeout=0,
                               retries=0, acked=False) for _ in range(W)]
        self._sack_pending = 0
        self._sack_timer = self.sack_holdoff_ms
        self.rx_window = [dict(received=False, seq=0, payload=b"", flags=0)
                          for _ in range(W)]
        self.tx_base = 0
        self.tx_next = 0
        self.in_flight = 0
        self.rx_base = 0

    def _slot(self, seq: int) -> int:
        return seq % self.MAX_WINDOW

    def _in_tx_window(self, seq: int) -> bool:
        off = (seq - self.tx_base) & 0xFFFF
        return off < self.config.window_size

    def _in_rx_window(self, seq: int) -> bool:
        off = (seq - self.rx_base) & 0xFFFF
        return off < self.config.window_size

    def is_ready_to_send(self) -> bool:
        return self.in_flight < self.config.window_size

    def available_slots(self) -> int:
        return self.config.window_size - self.in_flight

    def send_data_with_flags(self, data: bytes, flags: int) -> bool:
        if not self.is_ready_to_send() or not self.local_call or not self.remote_call:
            return False
        slot = self._slot(self.tx_next)
        frame = F.DataFrame.make_data(self.local_call, self.remote_call,
                                      self.tx_next, data)
        frame.flags = flags
        s = self.tx_window[slot]
        s.update(active=True, frame=frame.serialize(), seq=self.tx_next,
                 timeout=self.config.ack_timeout_ms, retries=0, acked=False)
        # Update window state BEFORE transmitting: with a synchronous link the
        # SACK can arrive inside _tx_frame (the C++ transmit is async so its
        # post-increment ordering is safe there).
        self.stats.frames_sent += 1
        self.tx_next = (self.tx_next + 1) & 0xFFFF
        self.in_flight += 1
        self._tx_frame(s["frame"])
        return True

    def _tx_frame(self, data: bytes):
        if self.on_transmit:
            self.on_transmit(data)

    def on_frame_received(self, frame_data: bytes):
        if len(frame_data) >= 3 and F.is_data_frame(frame_data[2]):
            frame = F.DataFrame.deserialize(frame_data)
            if frame:
                self._handle_data(frame)
            return
        ctrl = F.ControlFrame.deserialize(frame_data)
        if ctrl is None:
            return
        if ctrl.type == F.FrameType.ACK:
            self.stats.sacks_received += 1
            self._handle_ack(ctrl)
        elif ctrl.type == F.FrameType.NACK:
            self._handle_nack(ctrl)

    def _handle_data(self, frame: F.DataFrame):
        self.last_rx_flags = frame.flags
        seq = frame.seq
        fresh = False
        if self._in_rx_window(seq):
            slot = self._slot(seq)
            s = self.rx_window[slot]
            if not s["received"]:
                fresh = True
                s.update(received=True, seq=seq, payload=frame.payload,
                         flags=frame.flags)
                self.stats.frames_received += 1
                if seq == self.rx_base:
                    self._advance_rx()
                else:
                    self.stats.out_of_order += 1
        if not fresh:
            # A DUPLICATE (already delivered or already buffered) means
            # the sender missed our SACK — re-SACK immediately rather
            # than letting coalescing hold the answer for a holdoff.
            self._send_sack()
            return
        self._sack_pending += 1
        # A non-empty bitmap = a hole in the window (the sender's fast-
        # retransmit signal); rx_base jumping past seq+1 = a hole just
        # healed.  Both SACK immediately regardless of coalescing.
        gap = self._build_rx_bitmap() != 0 or self.rx_base != (
            (frame.seq + 1) & 0xFFFF)
        if self.sack_every <= 1 or self._sack_pending >= self.sack_every \
                or gap:
            self._send_sack()

    def _advance_rx(self):
        while True:
            slot = self._slot(self.rx_base)
            s = self.rx_window[slot]
            if not s["received"] or s["seq"] != self.rx_base:
                break
            if self.on_data_received:
                self.on_data_received(s["payload"])
            s["received"] = False
            self.rx_base = (self.rx_base + 1) & 0xFFFF

    def _build_rx_bitmap(self) -> int:
        bitmap = 0
        for i in range(min(8, self.config.window_size)):
            slot = self._slot((self.rx_base + i) & 0xFFFF)
            if self.rx_window[slot]["received"]:
                bitmap |= 1 << i
        return bitmap

    def _send_sack(self):
        self._sack_pending = 0
        self._sack_timer = self.sack_holdoff_ms
        bitmap = self._build_rx_bitmap()
        sack = F.ControlFrame.make_nack(self.local_call, self.remote_call,
                                        (self.rx_base - 1) & 0xFFFF, bitmap)
        sack.type = F.FrameType.ACK
        p = bytearray(sack.payload)
        p[2] = bitmap & 0xFF
        sack.payload = bytes(p)
        self.stats.sacks_sent += 1
        self.stats.acks_sent += 1
        self._tx_frame(sack.serialize())

    def _handle_ack(self, ctrl: F.ControlFrame):
        seq = ctrl.seq
        # Cumulative-window guard: only advance for seq within the TX
        # window [tx_base, tx_base + in_flight).  An ACK with a STALE or
        # foreign seq (e.g. the mode-change acknowledgment, which uses
        # seq=0 on the wire) must not walk tx_base — without this guard a
        # mid-transfer MODE_CHANGE's seq-0 ACK marked every in-flight
        # chunk delivered and the transfer "completed" with holes.
        if ((seq + 1 - self.tx_base) & 0xFFFF) > self.in_flight:
            return
        while self.in_flight > 0 and self.tx_base != ((seq + 1) & 0xFFFF):
            slot = self._slot(self.tx_base)
            s = self.tx_window[slot]
            if s["active"]:
                s["active"] = False
                s["acked"] = True
                self.in_flight -= 1
                self.stats.acks_received += 1
                if self.on_send_complete:
                    self.on_send_complete(True)
            self.tx_base = (self.tx_base + 1) & 0xFFFF

    def _handle_nack(self, ctrl: F.ControlFrame):
        if self._in_tx_window(ctrl.seq):
            slot = self._slot(ctrl.seq)
            s = self.tx_window[slot]
            if s["active"] and not s["acked"]:
                self._retransmit(slot)

    def _retransmit(self, slot: int):
        s = self.tx_window[slot]
        if s["retries"] >= self.config.max_retries:
            s["active"] = False
            self.in_flight -= 1
            self.stats.failed += 1
            if self.on_send_complete:
                self.on_send_complete(False)
            return
        s["retries"] += 1
        s["timeout"] = self.config.ack_timeout_ms
        self.stats.retransmissions += 1
        self._tx_frame(s["frame"])

    def tick(self, elapsed_ms: int):
        for i in range(self.config.window_size):
            slot = self._slot((self.tx_base + i) & 0xFFFF)
            s = self.tx_window[slot]
            if s["active"] and not s["acked"]:
                if elapsed_ms >= s["timeout"]:
                    self.stats.timeouts += 1
                    self._retransmit(slot)
                else:
                    s["timeout"] -= elapsed_ms
        # Coalesced-SACK holdoff flush (no-op at sack_every=1: _send_sack
        # always zeroed the counter on the receive path).
        if self._sack_pending > 0:
            if elapsed_ms >= self._sack_timer:
                self._send_sack()
            else:
                self._sack_timer -= elapsed_ms


def create_arq(mode: ARQMode, config: ARQConfig | None = None) -> _ARQBase:
    if mode == ARQMode.SELECTIVE_REPEAT:
        return SelectiveRepeatARQ(config)
    return StopAndWaitARQ(config)

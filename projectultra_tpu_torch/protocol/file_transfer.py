"""File transfer over DATA frames: chunking, CRC32, optional deflate.

Reference: src/protocol/file_transfer.{hpp,cpp}.  Payload wire format:
  FILE_START: [0x01][flags][size u32][crc32 u32][filename...]
  FILE_DATA:  [0x02][offset u32][chunk <=250 B]
The reference deflates with vendored miniz; we use zlib (same format).

The port's copy of the JAX package's module, pinned to it by
``tests/test_torch_protocol_stack.py``.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import zlib
from typing import Callable, Optional


class PayloadType(enum.IntEnum):
    TEXT_MESSAGE = 0x00
    FILE_START = 0x01
    FILE_DATA = 0x02


class FileFlags(enum.IntFlag):
    NONE = 0x00
    COMPRESSED = 0x01


class FileTransferState(enum.IntEnum):
    IDLE = 0
    SENDING = 1
    RECEIVING = 2
    COMPLETE = 3
    ERROR = 4


CHUNK_SIZE = 250


@dataclasses.dataclass
class FileTransferProgress:
    filename: str = ""
    total_bytes: int = 0
    transferred_bytes: int = 0
    is_sending: bool = False

    @property
    def percentage(self) -> float:
        return 100.0 * self.transferred_bytes / self.total_bytes \
            if self.total_bytes else 0.0


def compress(data: bytes) -> bytes | None:
    """miniz mz_compress2-compatible deflate (zlib container)."""
    try:
        return zlib.compress(data, 9)
    except Exception:
        return None


def decompress(data: bytes, expected_size: int) -> bytes | None:
    try:
        out = zlib.decompress(data)
        if expected_size != 0 and len(out) != expected_size:
            return None
        return out
    except Exception:
        return None


class FileTransferController:
    """(file_transfer.cpp) — host-side chunker/reassembler riding the ARQ.

    Beyond-reference deviation: ``pipelined`` (default on) keeps up to an
    ARQ window of chunks in flight instead of the reference's
    stop-and-wait ``tx_waiting_ack_`` gate (file_transfer.cpp:119-158) —
    wire-identical frames (same FILE_START/FILE_DATA payloads through the
    same SR-ARQ), only the sender's pacing changes, so interop is
    unaffected: the receiver reassembles by offset and the reference's
    receiver keys its chunk map the same way.  Measured: ~3x session file
    throughput at window 4 (tools/test_session_throughput.py).  Set
    pipelined=False for reference-exact one-chunk-per-RTT pacing."""

    def __init__(self, pipelined: bool = True, chunk_size: int = CHUNK_SIZE):
        self.state = FileTransferState.IDLE
        self.on_progress: Optional[Callable[[FileTransferProgress], None]] = None
        self.on_received: Optional[Callable[[str, bool], None]] = None
        self.on_sent: Optional[Callable[[bool, str], None]] = None
        self.receive_dir = "."
        self.pipelined = pipelined
        # Wire-legal up to MAX_PAYLOAD_V2 - 5 (clamped: an oversized
        # chunk builds frames the RX engine silently drops via its
        # total_cw bound, and the ARQ then retries to exhaustion with no
        # hint of the cause).  The reference's 250 stays the default.
        # Larger chunks amortize the per-frame preamble + per-chunk ACK
        # audio that dominate session file throughput at high-order modes
        # (each DATA frame costs a full Cox preamble and earns a full ACK
        # frame of return audio regardless of size).
        from .frame_v2 import MAX_PAYLOAD_V2
        self.chunk_size = max(1, min(chunk_size, MAX_PAYLOAD_V2 - 5))
        self._reset_tx()
        self._reset_rx()

    def _reset_tx(self):
        self._tx_filename = ""
        self._tx_data = b""
        self._tx_original_size = 0
        self._tx_crc = 0
        self._tx_flags = 0
        self._tx_offset = 0
        self._tx_metadata_sent = False
        self._tx_waiting_ack = False
        self._tx_outstanding = 0

    def _reset_rx(self):
        self._rx_filename = ""
        self._rx_expected_size = 0
        self._rx_crc = 0
        self._rx_flags = 0
        self._rx_chunks: dict[int, bytes] = {}

    # --- TX ---

    def start_send(self, filepath: str) -> bool:
        if self.state != FileTransferState.IDLE:
            return False
        try:
            with open(filepath, "rb") as f:
                data = f.read()
        except OSError:
            return False
        self._reset_tx()
        self._tx_filename = os.path.basename(filepath)
        self._tx_original_size = len(data)
        self._tx_crc = zlib.crc32(data) & 0xFFFFFFFF
        comp = compress(data)
        if comp is not None and len(comp) < len(data):
            self._tx_data = comp
            self._tx_flags = int(FileFlags.COMPRESSED)
        else:
            self._tx_data = data
        self.state = FileTransferState.SENDING
        return True

    def has_more_chunks(self) -> bool:
        return (self.state == FileTransferState.SENDING
                and (not self._tx_metadata_sent
                     or self._tx_offset < len(self._tx_data)))

    def get_next_chunk(self) -> bytes:
        if self.state != FileTransferState.SENDING:
            return b""
        if not self.pipelined and self._tx_waiting_ack:
            return b""
        if not self._tx_metadata_sent:
            payload = self._metadata_payload()
            # Generation state advances at HANDOFF (the pipelined sender
            # must know what to produce next before the first ACK returns);
            # completion still waits for every outstanding ACK below.
            self._tx_metadata_sent = True
        else:
            payload = self._data_payload()
        if payload:
            self._tx_waiting_ack = True
            self._tx_outstanding += 1
        return payload

    def on_chunk_acked(self, success: bool = True):
        self._tx_waiting_ack = False
        self._tx_outstanding = max(0, self._tx_outstanding - 1)
        if not success:
            self.state = FileTransferState.ERROR
            if self.on_sent:
                self.on_sent(False, "transmission failed")
            return
        if self.on_progress:
            self.on_progress(FileTransferProgress(
                self._tx_filename, len(self._tx_data), self._tx_offset, True))
        if not self.has_more_chunks() and self._tx_outstanding == 0:
            self.state = FileTransferState.COMPLETE
            if self.on_sent:
                self.on_sent(True, "")
            self.state = FileTransferState.IDLE

    def _metadata_payload(self) -> bytes:
        out = bytearray([int(PayloadType.FILE_START), self._tx_flags])
        out += self._tx_original_size.to_bytes(4, "big")
        out += self._tx_crc.to_bytes(4, "big")
        out += self._tx_filename.encode()[:246]
        return bytes(out)

    def _data_payload(self) -> bytes:
        from .frame_v2 import MAX_PAYLOAD_V2
        # Re-clamp at use: chunk_size is a public attribute and direct
        # assignment bypasses the constructor clamp.
        n = max(1, min(self.chunk_size, MAX_PAYLOAD_V2 - 5))
        out = bytearray([int(PayloadType.FILE_DATA)])
        out += self._tx_offset.to_bytes(4, "big")
        chunk = self._tx_data[self._tx_offset:self._tx_offset + n]
        out += chunk
        self._tx_offset += len(chunk)
        return bytes(out)

    # --- RX ---

    def process_payload(self, payload: bytes) -> bool:
        """Returns True if the payload belonged to a file transfer."""
        if not payload:
            return False
        ptype = payload[0]
        if ptype == int(PayloadType.FILE_START):
            self._handle_start(payload)
            return True
        if ptype == int(PayloadType.FILE_DATA):
            self._handle_data(payload)
            return True
        return False

    def _handle_start(self, payload: bytes):
        if len(payload) < 11:
            return
        self._reset_rx()
        self._rx_flags = payload[1]
        self._rx_expected_size = int.from_bytes(payload[2:6], "big")
        self._rx_crc = int.from_bytes(payload[6:10], "big")
        self._rx_filename = payload[10:].decode(errors="replace") or "received.bin"
        self.state = FileTransferState.RECEIVING

    def _handle_data(self, payload: bytes):
        if self.state != FileTransferState.RECEIVING or len(payload) < 5:
            return
        offset = int.from_bytes(payload[1:5], "big")
        self._rx_chunks[offset] = payload[5:]
        received = sum(len(c) for c in self._rx_chunks.values())
        if self.on_progress:
            self.on_progress(FileTransferProgress(
                self._rx_filename, self._rx_expected_size, received, False))
        # Completion: contiguous reassembly succeeds and CRC matches.
        data = self._try_reassemble()
        if data is None:
            return
        if self._rx_flags & FileFlags.COMPRESSED:
            data = decompress(data, self._rx_expected_size)
            if data is None:
                return
        if len(data) < self._rx_expected_size:
            return
        ok = (zlib.crc32(data) & 0xFFFFFFFF) == self._rx_crc
        path = os.path.join(self.receive_dir, os.path.basename(self._rx_filename))
        if ok:
            with open(path, "wb") as f:
                f.write(data)
        self.state = FileTransferState.IDLE
        if self.on_received:
            self.on_received(path, ok)
        self._reset_rx()

    def _try_reassemble(self) -> bytes | None:
        out = bytearray()
        offset = 0
        while offset in self._rx_chunks:
            chunk = self._rx_chunks[offset]
            out += chunk
            offset += len(chunk)
        return bytes(out) if out else None

    def is_in_progress(self) -> bool:
        return self.state in (FileTransferState.SENDING,
                              FileTransferState.RECEIVING)

    def progress(self) -> FileTransferProgress:
        if self.state == FileTransferState.SENDING:
            return FileTransferProgress(self._tx_filename, len(self._tx_data),
                                        self._tx_offset, True)
        received = sum(len(c) for c in self._rx_chunks.values())
        return FileTransferProgress(self._rx_filename, self._rx_expected_size,
                                    received, False)

    def cancel(self):
        self._reset_tx()
        self._reset_rx()
        self.state = FileTransferState.IDLE

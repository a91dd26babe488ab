"""``ultra`` CLI: frame-level TX/RX preserving the reference's commands.

Reference: src/main.cpp (ultra ptx|prx|info).  Same flags, same stdout f32
audio framing, same stderr reporting — a drop-in for `ultra ptx | ultra prx`
pipelines.

The port's CLI: the JAX package's commands, flags and output, on the
port's ``ModemEngine``.  ``main(argv, device)`` runs on ``device``, the
first CUDA device when it is None (it raises without one), as every
entry point of the port does; the JAX CLI's CPU pin (``ULTRA_TPU``) has
no counterpart here.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


USAGE = """ProjectUltra-TPU - High-Speed HF Sound Modem

Usage: ultra [options] <command>

Commands:
  ptx [msg]       Protocol TX - send v2 frame:
                    ptx ping         -> PING probe (chirp)
                    ptx connect      -> CONNECT (with callsigns)
                    ptx disconnect   -> DISCONNECT (end session)
                    ptx "Hello"      -> DATA (text message)
  prx [file]      Protocol RX - decode v2 frames (from file or stdin)
  info            Show modem capabilities

Options:
  -s <call>       Source callsign (default: N0CALL)
  -d <call>       Destination callsign (default: CQ)
  -o <file>       Output to file instead of stdout
  -w <waveform>   Waveform: ofdm, dpsk (single-carrier), mcdpsk
                  (default: ofdm)
  -p <profile>    OFDM config profile: conservative, balanced, turbo,
                  high_throughput, nvis (1024-FFT skywave)
                  (default: balanced)
"""

INFO = """=== ProjectUltra-TPU HF Modem ===

Signal Parameters:
  Sample rate:    48000 Hz
  Center freq:    1500 Hz
  Bandwidth:      ~2.8 kHz
  OFDM carriers:  30
  LDPC codeword:  648 bits

Waveforms:
  OFDM    High throughput, good SNR (>17 dB)
  DPSK    Single-carrier, low SNR (-11 to 17 dB)

Code Rates:
  R1/4    20 info bytes, most robust
  R1/2    40 info bytes
  R2/3    54 info bytes
  R3/4    60 info bytes
  R5/6    67 info bytes, highest throughput
"""


def _waveform_mode(name: str):
    """CLI waveform names.  Deviation from the reference CLI (main.cpp:94
    maps dpsk->MC_DPSK because its engine has no single-carrier RX path):
    here ``dpsk`` selects the actual single-carrier DPSK operating mode
    (BASELINE config #1); ``mcdpsk`` keeps the reference's mapping."""
    from .protocol.frame_v2 import WaveformMode
    return {"dpsk": WaveformMode.DPSK,
            "mcdpsk": WaveformMode.MC_DPSK}.get(name, WaveformMode.OFDM_COX)


def _profile_config(name: str):
    """CLI config profiles — the reference exposes the same preset set
    through its settings system (types.hpp speed profiles + the NVIS
    preset), not CLI flags; surfacing them on ptx/prx is a documented
    deviation so two CLI instances can run the 1024-FFT skywave profile
    without a settings file.  Unknown names exit with an error."""
    from . import config as C
    # "balanced" maps to the engine's default config (what the CLI has
    # always run), NOT config.balanced(), whose initial mod/rate fields
    # differ from ModemConfig() defaults.
    table = {"conservative": C.conservative, "balanced": lambda: None,
             "turbo": C.turbo, "high_throughput": C.high_throughput,
             "nvis": C.nvis_mode}
    if name not in table:
        # A typo'd profile silently running the default config would
        # decode 0 frames from perfectly good audio — fail loudly.
        print(f"Unknown profile: {name} "
              f"(use {', '.join(sorted(table))})", file=sys.stderr)
        raise SystemExit(1)
    return table[name]()


def _make_engine(profile: str, device: torch.device):
    from .modem.engine import ModemEngine
    cfg = _profile_config(profile)
    return ModemEngine(config=cfg, device=device)


def _apply_waveform(modem, name: str):
    mode = _waveform_mode(name)
    modem.set_waveform_mode(mode)
    from .protocol.frame_v2 import WaveformMode
    if mode == WaveformMode.DPSK:
        # Pre-negotiation TX rides connect_waveform (modem_engine.cpp:372-397);
        # point it at single-carrier DPSK so `ptx -w dpsk` actually emits it.
        modem.connect_waveform = WaveformMode.DPSK


def run_ptx(message, output_file, src, dst, waveform, profile="balanced",
            device: torch.device | None = None):
    from .protocol import frame_v2 as F

    print(f"Protocol TX: {src} -> {dst}", file=sys.stderr)
    modem = _make_engine(profile, device)
    _apply_waveform(modem, waveform)

    if not message or message == "ping":
        frame_type, samples = "PING", modem.transmit_ping()
    elif message == "connect":
        frame_type = "CONNECT"
        samples = modem.transmit(
            F.ConnectFrame.make_connect(src, dst, 0xFF, 0x00).serialize())
    elif message == "disconnect":
        frame_type = "DISCONNECT"
        samples = modem.transmit(
            F.ConnectFrame.make_disconnect(src, dst).serialize())
    else:
        frame_type = "DATA"
        samples = modem.transmit(
            F.DataFrame.make_data(src, dst, 1, message).serialize())

    print(f"  Frame: {frame_type}", file=sys.stderr)
    print(f"  Samples: {len(samples)} ({len(samples) / 48000.0} sec)",
          file=sys.stderr)

    raw = samples.astype(np.float32).tobytes()
    if output_file:
        with open(output_file, "wb") as f:
            f.write(raw)
        print(f"  Written to: {output_file}", file=sys.stderr)
    else:
        sys.stdout.buffer.write(raw)
    return 0


def run_prx(input_file, waveform, profile="balanced",
            device: torch.device | None = None):
    from .protocol import frame_v2 as F

    print(f"Protocol RX{' from ' + input_file if input_file else ''}",
          file=sys.stderr)
    modem = _make_engine(profile, device)
    _apply_waveform(modem, waveform)

    def on_ping(snr):
        print(f"  [PING] Detected! (SNR={snr} dB)", file=sys.stderr)

    def on_frame(frame):
        h = frame.header
        print(f"  [{h.type.name}] ", end="", file=sys.stderr)
        if h.total_cw == 1:
            ctrl = F.ControlFrame.deserialize(frame.frame_bytes)
            print(f"seq={ctrl.seq}" if ctrl else "", file=sys.stderr)
        else:
            print(f"codewords={h.total_cw}", file=sys.stderr)
        cf = F.ConnectFrame.deserialize(frame.frame_bytes)
        if cf:
            print(f"    {cf.src_callsign} -> {cf.dst_callsign}", file=sys.stderr)
            return
        df = F.DataFrame.deserialize(frame.frame_bytes)
        if df:
            print(f'    Message: "{df.payload_as_text()}"', file=sys.stderr)

    modem.on_ping = on_ping
    modem.on_frame = on_frame

    src = open(input_file, "rb") if input_file else sys.stdin.buffer
    total = 0
    try:
        while True:
            chunk = src.read(960 * 4)
            if not chunk:
                break
            samples = np.frombuffer(chunk, dtype=np.float32)
            modem.feed_audio(samples)
            total += len(samples)
            # Poll on the reference RX thread's ~100 ms cadence while
            # feeding: the bounded DPSK preamble search (262k samples per
            # pass) only advances between polls, so a frame deep inside a
            # long recording is unreachable from one post-EOF poll.
            if total % 4800 < 960:
                modem.poll()
    finally:
        if input_file:
            src.close()

    # EOF flush: a live receiver keeps hearing (noise) after the signal
    # ends; a file can end exactly at the last signal sample, which would
    # starve the post-chirp ping/frame classifier and the minimum-buffer
    # gates forever.  Pad with enough silence to let every pending
    # detection resolve (the reference's RX threads get the same effect
    # from its 5 s idle timeout, modem_rx.cpp).
    modem.feed_audio(np.zeros(8000, np.float32))
    modem.poll()

    print("\n=== RX Statistics ===", file=sys.stderr)
    print(f"  Audio: {total} samples ({total / 48000.0} sec)", file=sys.stderr)
    print(f"  Frames: {modem.frames_received}", file=sys.stderr)
    print(f"  PINGs: {modem.pings_received}", file=sys.stderr)
    return 0


def main(argv=None, device: torch.device | None = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    output_file = None
    command = None
    positional = None
    src, dst = "N0CALL", "CQ"
    waveform = "ofdm"
    profile = "balanced"

    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-o" and i + 1 < len(argv):
            output_file = argv[i + 1]; i += 2
        elif a == "-s" and i + 1 < len(argv):
            src = argv[i + 1]; i += 2
        elif a == "-d" and i + 1 < len(argv):
            dst = argv[i + 1]; i += 2
        elif a == "-w" and i + 1 < len(argv):
            waveform = argv[i + 1]; i += 2
        elif a == "-p" and i + 1 < len(argv):
            profile = argv[i + 1]; i += 2
        elif a in ("-h", "--help"):
            print(USAGE, file=sys.stderr)
            return 0
        elif not a.startswith("-"):
            if command is None:
                command = a
            elif positional is None:
                positional = a
            i += 1
        else:
            i += 1

    if command is None:
        print(USAGE, file=sys.stderr)
        return 1
    if command == "info":
        print(INFO, end="")
        return 0
    if command == "ptx":
        return run_ptx(positional, output_file, src, dst, waveform,
                       profile, device)
    if command == "prx":
        return run_prx(positional, waveform, profile, device)
    print(f"Unknown command: {command}", file=sys.stderr)
    print(USAGE, file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())

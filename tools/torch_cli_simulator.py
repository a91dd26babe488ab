#!/usr/bin/env python3
"""Two-station protocol simulator over a simulated HF channel on the
PyTorch/CUDA port (``tools/cli_simulator.py`` runs the same session on the
JAX package; reference tools/cli_simulator.cpp).

Two ``ProtocolEngine`` stations (each with its ``ModemEngine``) in one
process, each transmission handed to the other station through the port's
channel on the run's device (2,000 samples of lead, 4,000 of tail, the
harness CFO, then AWGN or a Watterson preset from a ``torch.Generator``
seeded per transmission): PING/PONG probe, CONNECT handshake with mode
negotiation, a message each way, DISCONNECT.  The last line is the result
as one JSON object.  Runs on the card unless ``--cpu``.

    python3 tools/torch_cli_simulator.py [--snr 15]
        [--channel clean|awgn|good|moderate|poor] [--cfo 0]
        [--message "..."] [--seed 42] [--cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--snr", type=float, default=15.0)
    ap.add_argument("--channel", default="awgn",
                    choices=["clean", "awgn", "good", "moderate", "poor"])
    ap.add_argument("--cfo", type=float, default=0.0)
    ap.add_argument("--message", default="Hello from the TPU modem!")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from projectultra_tpu_torch.device import card_line, resolve
    from projectultra_tpu_torch.protocol.engine import ProtocolEngine
    from projectultra_tpu_torch.sim import watterson as W

    device = resolve("cpu" if args.cpu else None)

    card = card_line(device)
    counter = [0]
    audio_s = [0.0]

    def channel(audio: np.ndarray) -> np.ndarray:
        counter[0] += 1
        audio_s[0] += len(audio) / 48000.0
        # The 2,000-sample lead models the receiver hearing the band before
        # the transmission (a CFO-shifted up-chirp peak can land up to
        # cfo*10 samples BEFORE the chirp itself).
        a = torch.from_numpy(np.concatenate(
            [np.zeros(2000, np.float32), audio,
             np.zeros(4000, np.float32)])[None, :]).to(device)
        if args.cfo:
            a = W.apply_cfo_hilbert(a, args.cfo)
        g = torch.Generator(device=device).manual_seed(
            args.seed * 100003 + counter[0])
        if args.channel == "awgn":
            a = W.add_noise_active(a, args.snr, g)
        elif args.channel != "clean":
            a = W.watterson(a, W.PRESETS[args.channel](args.snr), g)
        return a[0].cpu().numpy()

    a, b = ProtocolEngine(device=device), ProtocolEngine(device=device)
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(args.snr)

    a.on_tx_audio = lambda audio: (
        print(f"  [A->B] {len(audio)} samples ({len(audio) / 48000:.2f}s)"),
        b.feed_audio(channel(audio)))
    b.on_tx_audio = lambda audio: (
        print(f"  [B->A] {len(audio)} samples ({len(audio) / 48000:.2f}s)"),
        a.feed_audio(channel(audio)))

    got = {"a": [], "b": []}
    b.connection.on_message_received = lambda t: (
        got["b"].append(t), print(f'  [B] received: "{t}"'))
    a.connection.on_message_received = lambda t: (
        got["a"].append(t), print(f'  [A] received: "{t}"'))
    a.connection.on_connected = lambda: print("  [A] CONNECTED")
    b.connection.on_connected = lambda: print("  [B] CONNECTED")
    a.connection.on_disconnected = lambda r: print(f"  [A] disconnected: {r}")
    b.connection.on_disconnected = lambda r: print(f"  [B] disconnected: {r}")

    t0 = time.perf_counter()
    print(f"=== channel: {args.channel} SNR={args.snr} dB CFO={args.cfo} Hz "
          f"on {card} ===")
    print("[1] A connects to B (PING -> PONG -> CONNECT -> ACK)")
    a.connect("VE3ABC")
    connected = a.connection.is_connected and b.connection.is_connected
    if connected:
        print(f"    negotiated waveform: {b.connection.negotiated_mode.name}, "
              f"data mode: {a.connection.data_modulation.name} "
              f"{a.connection.data_code_rate.name}")
        print("[2] A -> B message")
        a.send_message(args.message)
        print("[3] B -> A message")
        b.send_message("QSL, copy 100%. 73!")
        print("[4] A disconnects")
        a.disconnect()
        a.tick(60000)
    else:
        print("CONNECT FAILED")
    wall = time.perf_counter() - t0

    sa, sb = a.modem.stats, b.modem.stats
    print("\n=== stats ===")
    print(f"  A: sent {sa.frames_sent} frames / {sa.bytes_sent} B, "
          f"received {sa.frames_received}")
    print(f"  B: sent {sb.frames_sent} frames / {sb.bytes_sent} B, "
          f"received {sb.frames_received}")
    print(f"  ARQ A: {a.connection.arq.stats}")
    ok = connected and sa.frames_received > 0 and sb.frames_received > 0
    print("RESULT:", "PASS" if ok else "FAIL")
    print(json.dumps({
        "ok": ok, "connected": connected, "messages": got,
        "transmissions": counter[0], "audio_seconds": audio_s[0],
        "wall_seconds": wall,
        "frames_received": [sa.frames_received, sb.frames_received],
        "frames_sent": [sa.frames_sent, sb.frames_sent],
        "retransmissions": [a.connection.arq.stats.retransmissions,
                            b.connection.arq.stats.retransmissions],
        "device": card}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

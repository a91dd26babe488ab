#!/usr/bin/env python3
"""Session-level (ARQ-inclusive) over-the-air throughput on the
PyTorch/CUDA port (``tools/test_session_throughput.py`` runs the same
sessions on the JAX package).

What a user gets from a whole two-``ProtocolEngine`` session: chirp ping,
CONNECT negotiation, the calibrated adaptive climb (``warm_msgs`` short
messages each way), then one file of incompressible bytes, with every
protocol cost included (ACKs, mode changes, ARQ retries, chunk headers).
Per row:

  steady kbps  = file bits / audio seconds exchanged during the transfer
                 (both directions: data and ACK audio);
  session kbps = file bits / all audio from the first ping.

``channel`` adds AWGN to each transmission from a ``torch.Generator``
seeded with (int(17 * SNR) + len(profile), transmission count), the JAX
tool's ``fold_in(key, counter)``; ``--sro-ppm`` resamples A->B audio by
+ppm and B->A by -ppm with ``torch_test_sro.apply_sro``.  Gate: every row
delivers its file byte-exact (RESULT: PASS, exit 0).  The last line is
the result as one JSON object.  Runs on the card unless ``--cpu``.

    python3 tools/torch_test_session_throughput.py [--rows 512_26,nvis_34]
        [--bytes 6000] [--chunk 4000] [--sro-ppm 0] [--cpu]
"""

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def channel(audio, snr_db, seed, counter, device):
    """One transmission's air: 2,000 zeros before, 4,000 after, and
    harness AWGN at ``snr_db`` from a generator seeded (seed, counter)."""
    import numpy as np
    import torch
    from projectultra_tpu_torch.sim import watterson as W
    a = torch.from_numpy(np.concatenate(
        [np.zeros(2000, np.float32), audio,
         np.zeros(4000, np.float32)])[None, :]).to(device)
    g = W.seeded_generator(device, seed, counter)
    return W.add_noise_active(a, snr_db, g)[0].cpu().numpy()


def _sro_tool():
    """tools/torch_test_sro.py, loaded by path."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_test_sro.py")
    spec = importlib.util.spec_from_file_location("torch_sro_tool", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_session(profile, true_snr, n_bytes, warm_msgs=16, chunk=4000,
                sro_ppm=0.0, device=None):
    """One row on ``device`` (the card when None).  Returns (final data
    mode, steady kbps, session kbps), or None when the session failed.

    warm_msgs >= 16: the flat-evidence gate needs STABLE_WINDOW (6)
    readings plus FLAT_FRAMES (3) before the high-order ladder opens, and
    the upgrade debounce then wants 4 consecutive recommendations.
    chunk = 4000 (the reference's is 250) with the pipelined chunker: at
    high-order modes each DATA frame pays a whole Cox preamble and earns a
    whole ACK frame of return audio, so larger chunks mean fewer overhead
    frames."""
    import numpy as np
    from projectultra_tpu_torch.config import nvis_mode
    from projectultra_tpu_torch.device import resolve
    from projectultra_tpu_torch.modem.engine import ModemEngine
    from projectultra_tpu_torch.protocol.engine import ProtocolEngine

    device = resolve(device)
    seed = int(true_snr * 17) + len(profile)
    counter = [0]
    audio_samples = [0]
    # TX/RX sample-clock skew: A's DAC/ADC run sro_ppm fast relative to
    # B's, so A->B audio resamples by +ppm and B->A by -ppm.
    apply_sro = _sro_tool().apply_sro if sro_ppm else None

    def air(audio, ppm=0.0):
        counter[0] += 1
        audio_samples[0] += len(audio)
        if apply_sro is not None and ppm:
            audio = apply_sro(audio, ppm)
        return channel(audio, true_snr, seed, counter[0], device)

    def modem():
        return ModemEngine(config=nvis_mode() if profile == "nvis" else None,
                           device=device)

    a, b = ProtocolEngine(modem()), ProtocolEngine(modem())
    for e in (a, b):
        e.connection.config.calibrated_snr = True
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(true_snr)
    a.on_tx_audio = lambda audio: b.feed_audio(air(audio, sro_ppm))
    b.on_tx_audio = lambda audio: a.feed_audio(air(audio, -sro_ppm))
    got_b = []
    b.connection.on_message_received = got_b.append

    if not a.connect("VE3ABC"):
        return None

    # Adaptive climb: short messages both ways -- the initiator's
    # controller reads SNR from frames it receives, so b must talk too.
    got_a = []
    a.connection.on_message_received = got_a.append
    ia = ib = 0
    for _ in range(200):
        if ia < warm_msgs and a.send_message(f"w{ia:02d}"):
            ia += 1
        if ib < warm_msgs and b.send_message(f"v{ib:02d}"):
            ib += 1
        a.tick(5000)
        b.tick(5000)
        if (ia >= warm_msgs and ib >= warm_msgs
                and len(got_b) >= warm_msgs and len(got_a) >= warm_msgs):
            break
    climb_samples = audio_samples[0]

    # Timed region: one file of incompressible bytes a -> b.
    a.connection.file_transfer.chunk_size = chunk
    # Receiver-side SACK coalescing: one SACK per 3 in-order chunks.
    b.connection.arq.sack_every = 3
    rng = np.random.default_rng(7)
    with tempfile.TemporaryDirectory() as tmpdir:
        src = os.path.join(tmpdir, "payload.bin")
        payload = rng.integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
        with open(src, "wb") as f:
            f.write(payload)
        received = []
        # A separate receive directory: delivery into tmpdir under the
        # same name would overwrite src and make the comparison vacuous.
        rxdir = os.path.join(tmpdir, "rx")
        os.makedirs(rxdir)
        b.connection.file_transfer.receive_dir = rxdir
        b.connection.file_transfer.on_received = \
            lambda path, ok: received.append((path, ok))
        if not a.connection.send_file(src):
            return None
        for _ in range(600):
            if received:
                break
            a.tick(5000)
            b.tick(5000)
        if not received or not received[0][1]:
            return None
        with open(received[0][0], "rb") as f:
            if f.read() != payload:
                return None
    transfer_samples = audio_samples[0] - climb_samples
    bits = n_bytes * 8
    steady = bits / (transfer_samples / 48000.0) / 1000.0
    session = bits / (audio_samples[0] / 48000.0) / 1000.0
    mode = f"{a.modem.data_modulation.name}/{a.modem.data_code_rate.name}"
    return mode, steady, session


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="512_26,512_32,nvis_34",
                    help="comma list of profile_snr rows")
    ap.add_argument("--bytes", type=int, default=6000)
    ap.add_argument("--chunk", type=int, default=4000)
    ap.add_argument("--sro-ppm", type=float, default=0.0,
                    help="TX/RX sample-clock skew in ppm (A fast, B slow)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from projectultra_tpu_torch.device import card_line, resolve

    device = resolve("cpu" if args.cpu else None)
    card = card_line(device)
    t0 = time.perf_counter()
    print(f"=== session throughput (ARQ-inclusive over-the-air), on {card} "
          f"===")
    print(f"  file: {args.bytes} incompressible bytes; "
          f"reference headline: 7.2 kbps frame-level", flush=True)
    all_ok, out = True, []
    for row in args.rows.split(","):
        profile, snr = row.rsplit("_", 1)
        r0 = time.perf_counter()
        r = run_session(profile, float(snr), args.bytes, chunk=args.chunk,
                        sro_ppm=args.sro_ppm, device=device)
        if r is None:
            print(f"  {row:10s}: FAIL", flush=True)
            all_ok = False
            out.append({"row": row, "ok": False})
            continue
        mode, steady, session = r
        out.append({"row": row, "ok": True, "mode": mode,
                    "steady_kbps": steady, "session_kbps": session,
                    "seconds": time.perf_counter() - r0})
        print(f"  {row:10s}: mode={mode:13s} steady={steady:6.2f} kbps "
              f"session={session:6.2f} kbps", flush=True)
    print("RESULT:", "PASS" if all_ok else "FAIL")
    print(json.dumps({"gate": all_ok, "bytes": args.bytes, "rows": out,
                      "wall_seconds": time.perf_counter() - t0,
                      "device": card}))
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())

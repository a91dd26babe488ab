#!/usr/bin/env python3
"""HF reality soak on the PyTorch/CUDA port: realistic receiver audio
through ONE engine (``tools/test_hf_reality.py`` runs the same stream
through the JAX package's engine; reference tools/test_hf_reality.cpp).

The stream is built from numpy exactly as the JAX tool builds it (the same
seeds, draws and order): OFDM_COX data frames (DQPSK R1/2) and chirp-led
MC-DPSK data frames from the port's transmitters, a chirp PING, each with
a 25 ms cosine TX ramp, random 0.7-1.3x inter-frame gaps, 2-4 s of leading
noise-only audio and a continuous noise floor at ``--snr`` (against the
mean in-frame power).  ONE ``ModemEngine`` per phase receives it in
960-sample chunks with a poll every 100 ms and no position oracle.  The
five gates, as the JAX tool's:

1. frames: every frame and the ping decoded, nothing else;
2. soak: a pure-noise soak gives no event;
3. torture: static crashes in the gaps, one mid-frame and 85% clipping
   lose no frame but the sacrificial one; +15 dB crashes in every frame
   are blanked and lose nothing;
4. tone: a CW interferer at SIR 5 dB (alone, then with the crashes and
   clipping) is notched and loses nothing;
5. AGC: +-6 dB of gain pumping at 0.3 Hz loses nothing and engages
   neither mitigation.

The last line is the result as one JSON object.  Runs on the card unless
``--cpu``.

    python3 tools/torch_test_hf_reality.py [--snr 25] [--frames 12]
        [--duration 60] [--soak-minutes 10] [--sro-ppm 0] [--quick] [--cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def tx_ramp(audio, n=1200):
    """25 ms cosine ramp on both edges (test_hf_reality.cpp applyTxRamp)."""
    import numpy as np
    if len(audio) < 2 * n:
        return audio
    w = 0.5 * (1.0 - np.cos(np.pi * np.arange(n) / n))
    out = audio.copy()
    out[:n] *= w
    out[-n:] *= w[::-1]
    return out


def _sro_tool():
    """tools/torch_test_sro.py, loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_sro_tool", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "torch_test_sro.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _engine(device, waveform="OFDM_COX"):
    """A connected station of ``waveform`` sending DQPSK R1/2 data."""
    from projectultra_tpu_torch.config import CodeRate, Modulation
    from projectultra_tpu_torch.modem.engine import ModemEngine
    from projectultra_tpu_torch.protocol.frame_v2 import WaveformMode
    e = ModemEngine(device=device)
    wf = WaveformMode[waveform]
    e.set_waveform_mode(wf)
    e.connect_waveform = wf
    e.connected = True
    e.handshake_complete = True
    e.data_modulation = Modulation.DQPSK
    e.data_code_rate = CodeRate.R1_2
    return e


def _receive(stream, chunk, device):
    """``stream`` through one fresh engine in ``chunk``-sample callbacks,
    a poll every 100 ms, then 8,000 zeros and a last poll.  Returns (the
    engine, the decoded payload texts, the pings)."""
    import numpy as np
    from projectultra_tpu_torch.protocol import frame_v2 as F
    rx = _engine(device)
    got, pings = [], []
    rx.on_frame = got.append
    rx.on_ping = pings.append
    fed = 0
    for i in range(0, len(stream), chunk):
        rx.feed_audio(stream[i:i + chunk])
        fed += chunk
        if fed % 4800 < chunk:
            rx.poll()
    rx.feed_audio(np.zeros(8000, np.float32))
    rx.poll()
    texts = []
    for fr in got:
        df = F.DataFrame.deserialize(fr.frame_bytes)
        if df:
            texts.append(df.payload_as_text())
    return rx, texts, pings


def run(snr_db=25.0, num_frames=12, duration_sec=60.0, soak_minutes=10.0,
        chunk=960, verbose=True, sro_ppm=0.0, device=None):
    """The five gates (frames, soak, torture, tone, AGC) on ``device`` (the
    card when None); returns them as five bools."""
    import numpy as np
    from projectultra_tpu_torch.device import resolve
    from projectultra_tpu_torch.protocol import frame_v2 as F

    device = resolve(device)
    rng = np.random.default_rng(42)
    tx_cox = _engine(device)
    tx_mc = _engine(device, "MC_DPSK")

    # --- the stream: frames at random positions over continuous noise
    msgs = [f"MSG{i}_HF_TEST" for i in range(num_frames)]
    frame_audio = []
    for i, msg in enumerate(msgs):
        tx = tx_cox if i % 2 == 0 else tx_mc
        fb = F.DataFrame.make_data("W1AW", "VE3ABC", i, msg).serialize()
        frame_audio.append(tx_ramp(tx.transmit(fb)))
    ping_audio = tx_ramp(tx_mc.transmit_ping())

    total = int(duration_sec * 48000)
    stream = np.zeros(total, np.float32)
    avg_gap = duration_sec / (num_frames + 2)
    t = float(rng.uniform(2.0, 4.0))  # leading noise-only audio
    positions = []
    placed = list(frame_audio) + [ping_audio]
    for audio in placed:
        pos = int(t * 48000)
        if pos + len(audio) > total:
            stream = np.concatenate(
                [stream, np.zeros(pos + len(audio) + 48000 - total,
                                  np.float32)])
            total = len(stream)
        stream[pos:pos + len(audio)] += audio
        positions.append(pos)
        t += len(audio) / 48000.0 + avg_gap * float(rng.uniform(0.7, 1.3))

    if sro_ppm:
        # The RX clock's skew (torch_test_sro.apply_sro) applies before the
        # noise (the receiver's ADC samples channel noise at its own clock).
        stream = _sro_tool().apply_sro(stream, sro_ppm)

    sig_power = float(np.mean(np.concatenate(placed) ** 2))
    noise_std = float(np.sqrt(sig_power / 10 ** (snr_db / 10.0)))
    stream = stream + rng.normal(0, noise_std, len(stream)).astype(np.float32)

    def log(msg):
        if verbose:
            print(msg, flush=True)

    # --- phase 1: the stream through ONE engine, no oracle
    _, texts, pings = _receive(stream, chunk, device)
    missing = [m for m in msgs if m not in texts]
    extra = [x for x in texts if x not in msgs]
    log(f"frames decoded: {len(texts)}/{num_frames}  pings: {len(pings)}/1")
    for m in missing:
        log(f"  MISSING: {m}")
    for x in extra:
        log(f"  UNEXPECTED: {x!r}")
    phase1 = not missing and not extra and len(pings) == 1

    # --- phase 2: pure-noise false-decode soak (48,000-sample chunks: the
    # soak gates false events, not callback cadence)
    rx2 = _engine(device)
    events = []
    rx2.on_frame = events.append
    rx2.on_ping = events.append
    left = int(soak_minutes * 60 * 48000)
    while left > 0:
        n = min(48000, left)
        rx2.feed_audio(rng.normal(0, noise_std, n).astype(np.float32))
        rx2.poll()
        left -= n
    log(f"noise soak: {soak_minutes:.1f} min, false events: {len(events)}")
    phase2 = len(events) == 0

    # --- phase 3: static crashes of 10-40 ms at 15x the noise std in every
    # gap, one on the sacrificial frame, and 85%-of-peak clipping
    rng3 = np.random.default_rng(1234)
    tortured = stream.copy()
    crash_events = 0
    for k in range(len(positions) - 1):
        end_k = positions[k] + len(placed[k])
        gap = positions[k + 1] - end_k
        if gap < 24000:
            continue
        n = int(rng3.uniform(0.010, 0.040) * 48000)
        at = end_k + int(rng3.uniform(0.2, 0.7) * (gap - n))
        tortured[at:at + n] += rng3.normal(
            0, 15 * noise_std, n).astype(np.float32)
        crash_events += 1
    sacrifice = num_frames // 2
    mid = positions[sacrifice] + len(placed[sacrifice]) // 2
    n = int(0.030 * 48000)
    tortured[mid:mid + n] += rng3.normal(
        0, 15 * noise_std, n).astype(np.float32)
    clip = 0.85 * float(np.abs(tortured).max())
    tortured = np.clip(tortured, -clip, clip)
    _, texts3, _ = _receive(tortured, chunk, device)
    extra3 = [x for x in texts3 if x not in msgs]
    required = [m for i, m in enumerate(msgs) if i != sacrifice]
    missing3 = [m for m in required if m not in texts3]
    log(f"impulse torture: {crash_events} gap crashes + 1 mid-frame "
        f"+ clip@85%: decoded {len(texts3)}/{num_frames} (sacrificial "
        f"#{sacrifice} {'survived' if msgs[sacrifice] in texts3 else 'lost, ok'}"
        f"), false={len(extra3)}")
    for m in missing3:
        log(f"  MISSING (non-sacrificial): {m}")
    phase3 = not missing3 and not extra3

    # --- phase 3b: a 30 ms crash at +15 dB over the power of the frame it
    # hits in every data frame, plus the gap crashes; the blanker must
    # carry every frame and the ping
    rng3b = np.random.default_rng(4321)
    tough = stream.copy()
    for k, audio in enumerate(placed[:-1]):  # data frames, not the ping
        mid = positions[k] + int(0.5 * len(audio))
        n = 1440
        crash_std = float(np.sqrt(np.mean(audio ** 2) * 10 ** (15.0 / 10.0)))
        tough[mid:mid + n] += rng3b.normal(0, crash_std, n).astype(np.float32)
    for k in range(len(positions) - 1):
        end_k = positions[k] + len(placed[k])
        gap = positions[k + 1] - end_k
        if gap < 24000:
            continue
        n = int(rng3b.uniform(0.010, 0.040) * 48000)
        at = end_k + int(rng3b.uniform(0.2, 0.7) * (gap - n))
        tough[at:at + n] += rng3b.normal(0, 15 * noise_std, n).astype(np.float32)
    rx3b, texts3b, pings3b = _receive(tough, chunk, device)
    missing3b = [m for m in msgs if m not in texts3b]
    extra3b = [x for x in texts3b if x not in msgs]
    log(f"strong crashes (+15 dB over frame, every frame): decoded "
        f"{len(texts3b)}/{num_frames}, pings {len(pings3b)}/1, blanked "
        f"{rx3b.blanker.blanked_runs} runs, false={len(extra3b)}")
    for m in missing3b:
        log(f"  MISSING under crashes: {m}")
    phase3b = (not missing3b and not extra3b and len(pings3b) == 1
               and rx3b.blanker.blanked_runs >= num_frames)

    # --- phase 4: a co-channel CW interferer at SIR 5 dB over the whole
    # stream; the exciser must notch it
    tone_hz = 1234.5
    tone_p = sig_power / 10 ** (5.0 / 10.0)
    tphase = 2.0 * np.pi * tone_hz * np.arange(len(stream)) / 48000.0
    toned = stream + np.sqrt(2 * tone_p) * np.sin(tphase).astype(np.float32)
    rx4, texts4, pings4 = _receive(toned, chunk, device)
    missing4 = [m for m in msgs if m not in texts4]
    extra4 = [x for x in texts4 if x not in msgs]
    tones = rx4.exciser.active_tones
    log(f"CW interferer @ {tone_hz} Hz SIR=5dB: decoded {len(texts4)}/"
        f"{num_frames}, pings {len(pings4)}/1, false={len(extra4)}, "
        f"notched={[round(t, 1) for t in tones]}")
    for m in missing4:
        log(f"  MISSING under tone: {m}")
    phase4 = (not missing4 and not extra4 and len(pings4) == 1
              and any(abs(t - tone_hz) < 15 for t in tones))

    # --- phase 5: the tone, phase 3b's crashes and 85% clipping at once
    chaos = tough.copy()
    chaos = chaos + np.sqrt(2 * tone_p) * np.sin(tphase).astype(np.float32)
    clip5 = 0.85 * float(np.abs(chaos).max())
    chaos = np.clip(chaos, -clip5, clip5)
    rx5, texts5, pings5 = _receive(chaos, chunk, device)
    missing5 = [m for m in msgs if m not in texts5]
    extra5 = [x for x in texts5 if x not in msgs]
    tones5 = rx5.exciser.active_tones
    log(f"COMPOUND (tone SIR5 + crashes + clip@85%): decoded {len(texts5)}/"
        f"{num_frames}, pings {len(pings5)}/1, blanked "
        f"{rx5.blanker.blanked_runs} runs, notched="
        f"{[round(t, 1) for t in tones5]}, false={len(extra5)}")
    for m in missing5:
        log(f"  MISSING under compound: {m}")
    phase5 = (not missing5 and not extra5 and len(pings5) == 1
              and any(abs(t - tone_hz) < 15 for t in tones5))

    # --- phase 6: receiver AGC pumping, +-6 dB at 0.3 Hz on signal and
    # noise together; no mitigation may engage
    t6 = np.arange(len(stream), dtype=np.float32) / 48000.0
    gain_db = 6.0 * np.sin(2 * np.pi * 0.3 * t6, dtype=np.float32)
    pumped = stream * (10.0 ** (gain_db / 20.0)).astype(np.float32)
    rx6, texts6, pings6 = _receive(pumped, chunk, device)
    missing6 = [m for m in msgs if m not in texts6]
    extra6 = [x for x in texts6 if x not in msgs]
    log(f"AGC pumping (+-6 dB @ 0.3 Hz): decoded {len(texts6)}/{num_frames}, "
        f"pings {len(pings6)}/1, blanked {rx6.blanker.blanked_runs} runs, "
        f"notched={[round(t, 1) for t in rx6.exciser.active_tones]}, "
        f"false={len(extra6)}")
    for m in missing6:
        log(f"  MISSING under AGC pumping: {m}")
    phase6 = (not missing6 and not extra6 and len(pings6) == 1
              and not rx6.exciser.active_tones
              and rx6.blanker.blanked_runs == 0)
    return phase1, phase2, phase3 and phase3b, phase4 and phase5, phase6


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--snr", type=float, default=25.0)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--soak-minutes", type=float, default=10.0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--sro-ppm", type=float, default=0.0)
    ap.add_argument("--quick", action="store_true",
                    help="6 frames / 30 s / 1 min soak (test-suite scale)")
    args = ap.parse_args(argv)
    if args.quick:
        args.frames, args.duration, args.soak_minutes = 6, 30.0, 1.0

    from projectultra_tpu_torch.device import card_line, resolve
    device = resolve("cpu" if args.cpu else None)
    t0 = time.perf_counter()
    gates = run(args.snr, args.frames, args.duration, args.soak_minutes,
                sro_ppm=args.sro_ppm, device=device)
    wall = time.perf_counter() - t0
    names = ("frames+ping", "false-decode soak", "impulse torture",
             "CW interferer", "AGC pumping")
    print("   ".join(f"{n}: {'PASS' if g else 'FAIL'}"
                     for n, g in zip(names, gates)))
    print(json.dumps({"gates": dict(zip(
        ("frames", "soak", "torture", "tone", "agc"), gates)),
        "frames": args.frames, "duration_s": args.duration,
        "soak_minutes": args.soak_minutes, "wall_seconds": wall,
        "device": card_line(device)}))
    return 0 if all(gates) else 1


if __name__ == "__main__":
    sys.exit(main())

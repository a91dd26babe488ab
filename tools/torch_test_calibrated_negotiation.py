#!/usr/bin/env python3
"""Auto-negotiation envelope sweep on the PyTorch/CUDA port
(``tools/test_calibrated_negotiation.py`` runs the same grid on the JAX
package).

For true wideband SNRs across 5-20 dB on AWGN and Watterson ``moderate``
fading, a whole two-``ProtocolEngine`` session with calibrated_snr on:
connect (the waveform and data mode negotiated from the measured SNR),
messages both ways, and the negotiated mode with the delivery verdict.
The 26 and 32 dB AWGN points must also climb mid-session into the
flat-gated high-order ladder (a final mode of throughput rank >= 3.9 and
5.2 bits per symbol times code rate).  ``channel`` takes each
transmission's air from a ``torch.Generator`` seeded with
(int(13 * SNR) + 7 on fading, transmission count), the JAX tool's
``fold_in(key, counter)``.  PASS (exit 0) when every point connects,
delivers every message in order and climbs where it must.  ``--parity``
sweeps the reference-parity inflated scale instead.  The last line is
the result as one JSON object.  Runs on the card unless ``--cpu``.

    python3 tools/torch_test_calibrated_negotiation.py [--messages 6]
        [--points i,j] [--parity] [--cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def channel(audio, chan, true_snr, seed, counter, device):
    """One transmission's air: 2,000 zeros before, 4,000 after, then
    harness AWGN (``awgn``) or Watterson ``moderate`` at ``true_snr``,
    drawn from a generator seeded (seed, counter)."""
    import numpy as np
    import torch
    from projectultra_tpu_torch.sim import watterson as W
    a = torch.from_numpy(np.concatenate(
        [np.zeros(2000, np.float32), audio,
         np.zeros(4000, np.float32)])[None, :]).to(device)
    g = W.seeded_generator(device, seed, counter)
    if chan == "awgn":
        a = W.add_noise_active(a, true_snr, g)
    else:
        a = W.watterson(a, W.PRESETS["moderate"](true_snr), g)
    return a[0].cpu().numpy()


def run_session(true_snr, chan, n_msgs, calibrated, device=None):
    """One grid point on ``device`` (the card when None).  Returns
    (negotiated waveform, initial data mode, delivered all, final data
    mode), or None when the connect failed."""
    from projectultra_tpu_torch.device import resolve
    from projectultra_tpu_torch.protocol.engine import ProtocolEngine

    device = resolve(device)
    seed = int(true_snr * 13) + (7 if chan == "fade" else 0)
    counter = [0]

    def air(audio):
        counter[0] += 1
        return channel(audio, chan, true_snr, seed, counter[0], device)

    a = ProtocolEngine(device=device)
    b = ProtocolEngine(device=device)
    for e in (a, b):
        e.connection.config.calibrated_snr = calibrated
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(true_snr)
    a.on_tx_audio = lambda audio: b.feed_audio(air(audio))
    b.on_tx_audio = lambda audio: a.feed_audio(air(audio))
    got_a, got_b = [], []
    a.connection.on_message_received = got_a.append
    b.connection.on_message_received = got_b.append

    if not a.connect("VE3ABC"):
        return None
    mode = b.connection.negotiated_mode.name
    dmode = f"{b.connection.data_modulation.name}/" \
            f"{b.connection.data_code_rate.name}"

    ia = ib = 0
    for _ in range(1500):
        if ia < n_msgs and a.send_message(f"a{ia:02d}"):
            ia += 1
        if ib < n_msgs and b.send_message(f"b{ib:02d}"):
            ib += 1
        a.tick(5000)
        b.tick(5000)
        if (ia >= n_msgs and ib >= n_msgs
                and len(got_a) >= n_msgs and len(got_b) >= n_msgs):
            break
    ok = (got_b == [f"a{i:02d}" for i in range(n_msgs)]
          and got_a == [f"b{i:02d}" for i in range(n_msgs)])
    final = f"{a.modem.data_modulation.name}/" \
            f"{a.modem.data_code_rate.name}"
    return mode, dmode, ok, final


def grid(calibrated):
    """(channel, SNR dB, least final-mode throughput rank) per point."""
    points = [("awgn", s, None) for s in (5.0, 8.0, 12.0, 16.0, 20.0)]
    points += [("fade", s, None) for s in (5.0, 8.0, 12.0, 16.0, 20.0)]
    if calibrated:
        # The climb rows: QAM64 R2/3 (rank 4) and QAM256 R2/3 (5.33).
        points += [("awgn", 26.0, 3.9), ("awgn", 32.0, 5.2)]
    return points


def rank(dmode: str) -> float:
    """Bits per symbol times code rate of a "MOD/RATE" data mode."""
    from projectultra_tpu_torch.config import (CodeRate, Modulation,
                                               bits_per_symbol,
                                               code_rate_value)
    m, r = dmode.split("/")
    return bits_per_symbol(Modulation[m]) * code_rate_value(CodeRate[r])


def messages_for(min_rank, n):
    """Climb rows need >= 14 data frames each way: control-frame readings
    are excluded from calibrated negotiation, so the flat gate (6-reading
    window + 3 flat frames) plus the 4-pending upgrade debounce takes ~13
    DATA readings."""
    return n if min_rank is None else max(n, 14)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--messages", type=int, default=6)
    ap.add_argument("--parity", action="store_true",
                    help="sweep the reference-parity inflated scale instead")
    ap.add_argument("--points", default=None,
                    help="comma list of grid indices (default: all)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from projectultra_tpu_torch.device import card_line, resolve

    device = resolve("cpu" if args.cpu else None)
    card = card_line(device)
    calibrated = not args.parity
    points = grid(calibrated)
    sel = ([int(i) for i in args.points.split(",")] if args.points
           else range(len(points)))
    t0 = time.perf_counter()
    print(f"=== auto-negotiation envelope sweep "
          f"({'calibrated' if calibrated else 'reference-parity'} scale), "
          f"on {card} ===", flush=True)
    all_ok, out = True, []
    for i in sel:
        chan, snr, min_rank = points[i]
        n = messages_for(min_rank, args.messages)
        p0 = time.perf_counter()
        r = run_session(snr, chan, n, calibrated, device=device)
        if r is None:
            print(f"  {chan:5s} {snr:5.1f} dB: CONNECT FAILED", flush=True)
            all_ok = False
            out.append({"channel": chan, "snr_db": snr, "connected": False,
                        "pass": False})
            continue
        mode, dmode, ok, final = r
        climbed = min_rank is None or rank(final) >= min_rank
        print(f"  {chan:5s} {snr:5.1f} dB: {mode:9s} init={dmode:13s} "
              f"final={final:13s} "
              f"{'PASS' if ok and climbed else 'FAIL'}", flush=True)
        all_ok = all_ok and ok and climbed
        out.append({"channel": chan, "snr_db": snr, "connected": True,
                    "waveform": mode, "initial": dmode, "final": final,
                    "delivered": ok, "climbed": climbed,
                    "pass": ok and climbed,
                    "seconds": time.perf_counter() - p0})
    print("RESULT:", "PASS" if all_ok else "FAIL")
    print(json.dumps({"gate": all_ok, "calibrated": calibrated,
                      "points": out, "wall_seconds": time.perf_counter() - t0,
                      "device": card}))
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())

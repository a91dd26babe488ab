#!/usr/bin/env python3
"""The frame-SNR estimators' scales against true wideband SNR, measured on
the PyTorch/CUDA port (``tools/calibrate_snr.py`` measures them on the JAX
package).

The reference's frame/pilot SNR estimates (MC-DPSK training, OFDM pilots,
DPSK preamble) read 10-20 dB above the true wideband channel SNR.  Per
(waveform, channel) pair the full engine TX -> channel -> RX path runs
over a grid of true SNRs: an R1/4 ACK frame, 2,000 zeros before and 4,000
after, harness AWGN or Watterson ``moderate`` from ``channel`` (a
``torch.Generator`` seeded (17, 1000 * trial + int(7 * SNR) +
hash(waveform) % 97), the JAX tool's ``fold_in(PRNGKey(17), ...)``).  It
prints the legacy estimator's mean and spread, the wideband estimate
(``ModemEngine._wideband_snr_db``, which calibrated negotiation reads)
beside it, and a least-squares fit est = a * true + b of the legacy
reading per pair.  The last line is the result as one JSON object, fits
included; the exit code is 0, as the JAX tool's.  Runs on the card unless
``--cpu``.

    python3 tools/torch_calibrate_snr.py [--trials 6] [--cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

GRID = [0.0, 4.0, 8.0, 12.0, 16.0, 20.0, 24.0]


def channel(audio, chan, true_snr, seed, device):
    """2,000 zeros, the frame, 4,000 zeros; harness AWGN (``awgn``) or
    Watterson ``moderate`` at ``true_snr`` from a generator seeded
    ``seed`` (a tuple of integers)."""
    import numpy as np
    import torch
    from projectultra_tpu_torch.sim import watterson as W
    a = torch.from_numpy(np.concatenate(
        [np.zeros(2000, np.float32), audio,
         np.zeros(4000, np.float32)])[None, :]).to(device)
    g = W.seeded_generator(device, *seed)
    if chan == "awgn":
        a = W.add_noise_active(a, true_snr, g)
    else:
        a = W.watterson(a, W.PRESETS["moderate"](true_snr), g)
    return a[0].cpu().numpy()


def run_point(wf, chan, true_snr, trial, device):
    """(legacy SNR estimate, wideband estimate) of the decoded ACK frame,
    or None when nothing decoded."""
    from projectultra_tpu_torch.config import CodeRate
    from projectultra_tpu_torch.modem.engine import ModemEngine
    from projectultra_tpu_torch.protocol import frame_v2 as F
    tx, rx = ModemEngine(device=device), ModemEngine(device=device)
    for m in (tx, rx):
        m.set_waveform_mode(wf)
        m.connect_waveform = wf
        # OFDM_COX carries frames only as the connected data waveform.
        m.connected = True
        m.handshake_complete = True
        m.data_code_rate = CodeRate.R1_4
    frame = F.ControlFrame.make_ack("AA1AA", "BB2BB", trial).serialize()
    seed = (17, 1000 * trial + int(true_snr * 7) + hash(wf) % 97)
    noisy = channel(tx.transmit(frame), chan, true_snr, seed, device)
    got = []
    rx.on_frame = got.append
    rx.feed_audio(noisy)
    rx.poll()
    if not got:
        return None
    return got[0].snr_db, got[0].wideband_snr_db


def fit(xs, ys):
    """Least-squares (slope, offset) of ys = slope * xs + offset."""
    import numpy as np
    A = np.stack([np.asarray(xs), np.ones(len(xs))], 1)
    coef, *_ = np.linalg.lstsq(A, np.asarray(ys), rcond=None)
    return float(coef[0]), float(coef[1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    import numpy as np
    from projectultra_tpu_torch.device import card_line, resolve
    from projectultra_tpu_torch.protocol.frame_v2 import WaveformMode

    device = resolve("cpu" if args.cpu else None)
    card = card_line(device)
    t0 = time.perf_counter()
    print(f"frame-SNR estimator scales on {card}", flush=True)
    fits, pairs = {}, []
    for wf in (WaveformMode.MC_DPSK, WaveformMode.OFDM_COX,
               WaveformMode.DPSK):
        for chan in ("awgn", "fade"):
            xs, ys, points = [], [], []
            print(f"\n=== {wf.name} / {chan} ===")
            for s in GRID:
                vals = [v for t in range(args.trials)
                        if (v := run_point(wf, chan, s, t, device))
                        is not None]
                if vals:
                    est = [v[0] for v in vals]
                    wb = [v[1] for v in vals]
                    m = float(np.mean(est))
                    print(f"  true {s:5.1f} dB -> est {m:6.2f} dB "
                          f"(n={len(vals)}, sd={np.std(est):.2f})  "
                          f"wideband {np.mean(wb):6.2f} dB "
                          f"(sd={np.std(wb):.2f})", flush=True)
                    xs.extend([s] * len(vals))
                    ys.extend(est)
                    points.append({"true_db": s, "est": est, "wideband": wb})
                else:
                    print(f"  true {s:5.1f} dB -> no decode", flush=True)
                    points.append({"true_db": s, "est": [], "wideband": []})
            pair = {"waveform": wf.name, "channel": chan, "points": points,
                    "fit": None}
            if len(set(xs)) >= 3:
                pair["fit"] = fits[(wf.name, chan)] = fit(xs, ys)
                print(f"  fit: est = {pair['fit'][0]:.3f} * true + "
                      f"{pair['fit'][1]:.2f}")
            pairs.append(pair)

    print("\n=== legacy-estimator inflation fits (est = a*true + b) ===")
    for k, (a, b) in fits.items():
        print(f"  {k}: slope={a:.3f} offset={b:.2f}")
    print(json.dumps({"trials": args.trials, "pairs": pairs,
                      "wall_seconds": time.perf_counter() - t0,
                      "device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

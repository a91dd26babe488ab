#!/usr/bin/env python3
"""Decode envelopes for the calibrated negotiation tables, measured on the
PyTorch/CUDA port (``tools/calibrate_mode_table.py`` measures them on the
JAX package).

For each (modulation, rate) data mode over OFDM_COX -- plus the MC_DPSK
and DPSK floors -- connected-engine DATA-frame loopbacks across a grid of
true wideband SNRs on AWGN and Watterson ``moderate`` fading, one point
per (row, channel, SNR, trial): an 80-byte random payload from
``numpy.random.default_rng(91000 + 37 * trial)``, one TX and one RX
``ModemEngine``, the air from ``channel`` (a ``torch.Generator`` seeded
(29, 10000 * trial + int(7 * SNR) + hash((waveform, mod, rate)) % 997),
the JAX tool's ``fold_in(PRNGKey(29), ...)``; the enums hash as their
integer values, so the seed is the same in every process).  A point
passes when the RX engine delivers the frame byte for byte.  The
calibrated thresholds (protocol/connection.py
recommend_data_mode_calibrated, modem/adaptive.py
CalibratedAdaptiveController.TABLE) are pinned from these envelopes.  The
last line is the result as one JSON object; the exit code is 0, as the
JAX tool's.  Runs on the card unless ``--cpu``.

    python3 tools/torch_calibrate_mode_table.py [--trials 6] [--only STR]
        [--cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def channel(audio, chan, true_snr, seed, device):
    """2,400 zeros, the frame, 4,000 zeros; harness AWGN (``awgn``) or
    Watterson ``moderate`` at ``true_snr`` from a generator seeded
    ``seed`` (a tuple of integers)."""
    import numpy as np
    import torch
    from projectultra_tpu_torch.sim import watterson as W
    a = torch.from_numpy(np.concatenate(
        [np.zeros(2400, np.float32), audio,
         np.zeros(4000, np.float32)])[None, :]).to(device)
    g = W.seeded_generator(device, *seed)
    if chan == "awgn":
        a = W.add_noise_active(a, true_snr, g)
    else:
        a = W.watterson(a, W.PRESETS["moderate"](true_snr), g)
    return a[0].cpu().numpy()


def run_point(wf, mod, rate, chan, true_snr, trial, device):
    """True when the RX engine delivers the trial's DATA frame exactly."""
    import numpy as np
    from projectultra_tpu_torch.modem.engine import ModemEngine
    from projectultra_tpu_torch.protocol import frame_v2 as F
    tx, rx = ModemEngine(device=device), ModemEngine(device=device)
    for m in (tx, rx):
        m.set_waveform_mode(wf)
        m.connect_waveform = wf
        m.connected = True
        m.handshake_complete = True
        m.data_modulation = mod
        m.data_code_rate = rate
    # Random payloads: a fixed payload hid silent corruption of
    # parity-free bits at QAM64 R3/4.
    prng = np.random.default_rng(91000 + 37 * trial)
    payload = bytes(prng.integers(0, 256, 80, dtype=np.uint8))
    frame = F.DataFrame.make_data("AA1AA", "BB2BB", trial,
                                  payload).serialize()
    seed = (29, 10000 * trial + int(true_snr * 7)
            + (hash((wf, mod, rate)) % 997))
    noisy = channel(tx.transmit(frame), chan, true_snr, seed, device)
    got = []
    rx.on_frame = got.append
    rx.feed_audio(noisy)
    rx.poll()
    return bool(got) and got[0].frame_bytes == frame


def rows():
    from projectultra_tpu_torch.config import CodeRate, Modulation
    from projectultra_tpu_torch.protocol.frame_v2 import WaveformMode
    cox, M, R = WaveformMode.OFDM_COX, Modulation, CodeRate
    return [
        (cox, M.DBPSK, R.R1_4, [4, 6, 8, 10, 12]),
        (cox, M.DQPSK, R.R1_4, [6, 8, 10, 12, 14]),
        (cox, M.DQPSK, R.R1_2, [9, 11, 13, 15, 17]),
        (cox, M.DQPSK, R.R2_3, [13, 15, 17, 19, 21]),
        (cox, M.QAM16, R.R2_3, [17, 19, 21, 23, 25]),
        (cox, M.QAM16, R.R3_4, [20, 22, 24, 26, 28]),
        # High-order modes beyond the reference (the fade rows collapse
        # at every SNR; negotiation routes them only on a proven-flat
        # reading).  No R5/6 rows: parity-free info bits on the 512 plan's
        # ICI-floor carriers flip with cw_ok still set.
        (cox, M.QAM64, R.R2_3, [22, 24, 26, 28, 30]),
        (cox, M.QAM64, R.R3_4, [24, 26, 28, 30, 32]),
        (cox, M.QAM256, R.R2_3, [28, 30, 32, 34, 36]),
        (WaveformMode.MC_DPSK, M.DQPSK, R.R1_4, [-2, 0, 2, 4, 6, 8]),
        (WaveformMode.DPSK, M.DQPSK, R.R1_4, [-6, -4, -2, 0, 2]),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--only", default="",
                    help="substring filter on 'WAVEFORM MOD RATE' row names")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from projectultra_tpu_torch.device import card_line, resolve

    device = resolve("cpu" if args.cpu else None)
    card = card_line(device)
    t0 = time.perf_counter()
    print(f"decode envelopes on {card}", flush=True)
    out = []
    for wf, mod, rate, snrs in rows():
        name = f"{wf.name} {mod.name} {rate.name}"
        if args.only and args.only not in name:
            continue
        for chan in ("awgn", "fade"):
            line = [f"{wf.name:9s} {mod.name:6s} {rate.name:5s} {chan:5s}:"]
            decoded = []
            for s in snrs:
                oks = [run_point(wf, mod, rate, chan, float(s), t, device)
                       for t in range(args.trials)]
                decoded.append(sum(oks))
                line.append(f"{s:+3d}dB={sum(oks)}/{len(oks)}")
            out.append({"row": name, "channel": chan, "snrs": snrs,
                        "decoded": decoded})
            print("  ".join(line), flush=True)
    print(json.dumps({"trials": args.trials, "rows": out,
                      "wall_seconds": time.perf_counter() - t0,
                      "device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Flag-for-flag twin of the reference's primary harness
(tools/test_iwaveform.cpp) on the PyTorch/CUDA port
(``tools/test_iwaveform.py`` runs it on the JAX package): N frames of one
waveform through one receiver at a given SNR, CFO and channel, reporting
the decode rate.

Two disciplines:
  default  -- the batched sweep (``parallel/sweep.run_point``);
  --stream -- N frames as ONE continuous stream through ONE ModemEngine in
              960-sample chunks (the reference's own anti-cheat rules,
              test_iwaveform.cpp:340-600; ``run_point_stream``).

The last line is the result as one JSON object.  Runs on the card unless
``--cpu``.

    python3 tools/torch_test_iwaveform.py --snr 15 -w mc_dpsk \\
        --channel awgn --cfo 30 --rate r1_4 --frames 5 [--stream] [--cpu]
        [--seed N]
Waveforms: mc_dpsk, ofdm_chirp, dpsk (single-carrier; --preset selects the
speed preset, default robust).
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
    ap.add_argument("--cfo", type=float, default=0.0)
    ap.add_argument("--channel", default="awgn",
                    choices=["awgn", "good", "moderate", "poor", "flutter"])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("-w", "--waveform", default="mc_dpsk",
                    choices=["mc_dpsk", "ofdm_chirp", "dpsk"])
    ap.add_argument("--rate", default="r1_2",
                    choices=["r1_4", "r1_3", "r1_2", "r2_3", "r3_4", "r5_6"])
    ap.add_argument("--preset", default="robust",
                    help="single-carrier DPSK preset (psk/dpsk.py factories)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--stream", action="store_true",
                    help="single-stream discipline through one ModemEngine")
    ap.add_argument("--chunk", type=int, default=960)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from projectultra_tpu_torch.config import CodeRate
    from projectultra_tpu_torch.device import card_line, resolve
    from projectultra_tpu_torch.parallel.sweep import (SweepPoint, run_point,
                                                       run_point_stream)

    device = resolve("cpu" if args.cpu else None)

    card = card_line(device)
    wf = {"mc_dpsk": "MC_DPSK", "ofdm_chirp": "OFDM_CHIRP",
          "dpsk": "DPSK"}[args.waveform]
    rate = CodeRate[args.rate.upper()]
    # MC-DPSK always rides R1/4 per protocol (test_iwaveform.cpp usage).
    if wf == "MC_DPSK":
        rate = CodeRate.R1_4
    point = SweepPoint(wf, args.snr, args.cfo, args.channel, rate=rate,
                       frames=args.frames,
                       preset=args.preset if wf == "DPSK" else "")

    t0 = time.perf_counter()
    res = (run_point_stream(point, seed=args.seed, chunk=args.chunk,
                            device=device)
           if args.stream else run_point(point, seed=args.seed,
                                         device=device))
    wall = time.perf_counter() - t0
    print(f"{wf} {args.channel} SNR={args.snr:+.1f} CFO={args.cfo:+.0f} "
          f"rate={rate.name} frames={args.frames}"
          f"{' [stream]' if args.stream else ''} on {card}")
    print(f"  decode {res.decode_rate:.0%}  detect {res.detected_rate:.0%}"
          + ("" if args.stream else f"  BER {res.ber:.4f}"))
    print(json.dumps({"waveform": wf, "stream": args.stream,
                      "frames": args.frames, "rate": rate.name,
                      "decode_rate": res.decode_rate,
                      "detected_rate": res.detected_rate,
                      "ber": None if args.stream else res.ber,
                      "cfo_err_hz": res.cfo_err_hz, "wall_seconds": wall,
                      "device": card}))
    return 0 if res.decode_rate > 0 else 1


if __name__ == "__main__":
    sys.exit(main())

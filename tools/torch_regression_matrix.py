#!/usr/bin/env python3
"""Regression matrix runner on the PyTorch/CUDA port
(tests/regression_matrix.sh equivalent; ``tools/regression_matrix.py``
runs the same rows on the JAX package).

Runs every (waveform, SNR, CFO, channel) row of the reference's regression
matrix as batched frames through ``projectultra_tpu_torch.parallel.sweep``
and checks the minimum decode rates.  Runs on the card unless ``--cpu``.

    python3 tools/torch_regression_matrix.py [--full] [--frames N]
        [--stream] [--chunk 960] [--seed 42] [--cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="include --full rows")
    ap.add_argument("--frames", type=int, default=None,
                    help="override frames per point")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--stream", action="store_true",
                    help="single-stream discipline: N frames as ONE "
                         "continuous stream through ONE ModemEngine in "
                         "960-sample chunks (test_iwaveform.cpp rules)")
    ap.add_argument("--chunk", type=int, default=960,
                    help="stream chunk size in samples (with --stream)")
    args = ap.parse_args()

    from projectultra_tpu_torch.parallel.sweep import (
        REGRESSION_MATRIX, FULL_EXTRA, run_matrix, run_matrix_stream)

    device = "cpu" if args.cpu else None
    rows = list(REGRESSION_MATRIX) + (list(FULL_EXTRA) if args.full else [])
    t0 = time.perf_counter()
    if args.stream:
        results = run_matrix_stream(rows, seed=args.seed, frames=args.frames,
                                    chunk=args.chunk, device=device)
    else:
        results = run_matrix(rows, seed=args.seed, frames=args.frames,
                             device=device)
    dt = time.perf_counter() - t0

    print(f"{'waveform':<11} {'chan':<9} {'SNR':>5} {'CFO':>5} "
          f"{'decode':>7} {'min':>5} {'det':>5} {'BER':>7}  result")
    failures = 0
    for res, min_rate, passed in results:
        p = res.point
        print(f"{p.waveform:<11} {p.channel:<9} {p.snr_db:>5.1f} {p.cfo_hz:>5.0f} "
              f"{res.decode_rate:>6.0%} {min_rate:>5.0%} {res.detected_rate:>4.0%} "
              f"{res.ber:>7.4f}  {'PASS' if passed else 'FAIL'}")
        failures += not passed
    total_frames = sum(r.point.frames for r, _, _ in results)
    print(f"\n{len(results) - failures}/{len(results)} rows passed, "
          f"{total_frames} frames in {dt:.1f}s "
          f"({total_frames / dt:.1f} frames/s incl. set-up)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

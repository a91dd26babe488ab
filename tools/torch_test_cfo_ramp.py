#!/usr/bin/env python3
"""Doppler-ramp robustness on the PyTorch/CUDA port: decode rate against a
time-varying CFO in Hz/s (``tools/test_cfo_ramp.py`` runs the same rows on
the JAX package).

Ionospheric paths drift (mid-latitude NVIS ~0.01-0.1 Hz/s, disturbed
paths several times that), while acquisition estimates one CFO per frame,
so a ramp leaves a residual that grows through the frame.  The ramp
multiplies the analytic stream by exp(j*2*pi*integral of rate*t) -- a pure
frequency ramp from 0 Hz over the whole stream, preamble included, in
float64 on the host (``apply_cfo_ramp``) -- before the noise, through
``torch_test_sro.run_row``'s engine-level, no-oracle harness.

Gate: every frame decoded at |rate| <= 0.2 Hz/s (the disturbed-path
class).  The last line is the result as one JSON object.  Runs on the
card unless ``--cpu``.

    python3 tools/torch_test_cfo_ramp.py [--rows r1,r2]
        [--rates 0,0.1,-0.1,0.2,-0.2,0.5] [--frames 3] [--cpu]
"""

import argparse
import importlib.util
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

_SRO = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "torch_test_sro.py")


def _sro_tool():
    spec = importlib.util.spec_from_file_location("torch_sro_tool", _SRO)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def apply_cfo_ramp(audio, rate_hz_per_s, fs=48000.0):
    """Frequency-shift the real passband by f(t) = rate * t Hz."""
    import numpy as np
    import scipy.signal as sig
    if rate_hz_per_s == 0:
        return audio
    n = len(audio)
    t = np.arange(n, dtype=np.float64) / fs
    phase = 2.0 * np.pi * 0.5 * rate_hz_per_s * t * t  # integral of rate*t
    z = sig.hilbert(audio.astype(np.float64))
    return np.real(z * np.exp(1j * phase)).astype(np.float32)


ROWS = ("cox_dqpsk", "cox_qam16", "mc_dpsk", "nvis_qam64", "nvis_qam256")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default=",".join(ROWS))
    ap.add_argument("--rates", default="0,0.1,-0.1,0.2,-0.2,0.5")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from projectultra_tpu_torch.device import card_line, resolve

    device = resolve("cpu" if args.cpu else None)
    card = card_line(device)
    tool = _sro_tool()
    table = {k: v for k, v in tool.rows(device).items() if k in ROWS}
    rates = [float(r) for r in args.rates.split(",")]

    t0 = time.perf_counter()
    print(f"{'row':<36} {'Hz/s':>10} {'decoded'}  on {card}", flush=True)
    out, all_ok = tool.run_matrix(table, args.rows.split(","), rates,
                                  args.frames, 0.2, "Hz/s",
                                  distort=apply_cfo_ramp)
    print("CFO-ramp gate (|rate| <= 0.2 Hz/s):", "PASS" if all_ok else "FAIL")
    print(json.dumps({"gate": all_ok, "rows": out, "frames": args.frames,
                      "wall_seconds": time.perf_counter() - t0,
                      "device": card}))
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())

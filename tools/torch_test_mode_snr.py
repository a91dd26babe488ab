#!/usr/bin/env python3
"""OFDM D8PSK against DQPSK decode rate across the SNR range (AWGN) on the
PyTorch/CUDA port (``tools/test_mode_snr.py`` runs the same rows on the
JAX package; reference tools/test_mode_snr.cpp).

Decode rate per (modulation, rate, SNR) and the lowest SNR reaching 90%.
Each row's trials and SNR points ride one batch axis: one presynced
``tx_frame`` -> ``channel`` -> ``rx_frame`` over [7 * trials] frames.
``channel`` draws the AWGN from a ``torch.Generator`` seeded 11 (the JAX
tool's key 11); the info bits come from ``numpy.random.default_rng(5)``.
The last line is the result as one JSON object; the exit code is 0, as
the JAX tool's.  Runs on the card unless ``--cpu``.

    python3 tools/torch_test_mode_snr.py [--trials 20] [--cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def rows():
    from projectultra_tpu_torch.config import CodeRate, Modulation
    low = [15.0, 17.0, 20.0, 23.0, 25.0, 28.0, 30.0]
    high = [20.0, 23.0, 25.0, 28.0, 30.0, 33.0, 35.0]
    return [("D8PSK R1/2", Modulation.D8PSK, CodeRate.R1_2, low),
            ("D8PSK R2/3", Modulation.D8PSK, CodeRate.R2_3, high),
            ("DQPSK R1/2", Modulation.DQPSK, CodeRate.R1_2, low),
            ("DQPSK R2/3", Modulation.DQPSK, CodeRate.R2_3, high)]


def channel(tx, snr_vec):
    """Harness AWGN at a per-frame SNR, from a generator seeded 11."""
    import torch
    from projectultra_tpu_torch.sim import watterson as W
    return W.add_noise_active(
        tx, snr_vec, torch.Generator(device=tx.device).manual_seed(11))


def run_row(row, trials, device):
    """One row as one batch; returns its per-SNR rates and per-frame ok."""
    import numpy as np
    import torch
    from projectultra_tpu_torch.fec import ldpc
    from projectultra_tpu_torch.ofdm import pipeline as P

    label, mod, rate, snrs = row
    cfg = P.chirp_ofdm_config()
    code = ldpc.get_code(rate)
    rng = np.random.default_rng(5)
    n = len(snrs) * trials
    info = torch.from_numpy(
        rng.integers(0, 2, (n, code.k)).astype(np.float32)).to(device)
    snr_vec = torch.from_numpy(
        np.repeat(np.asarray(snrs, np.float32), trials)).to(device)
    tx = P.tx_frame(cfg, mod, rate, info)
    _, ok, _ = P.rx_frame(cfg, mod, rate, channel(tx, snr_vec))
    ok = ok.cpu().numpy()
    rates = ok.reshape(len(snrs), trials).mean(-1)
    min90 = next((s for s, r in zip(snrs, rates) if r >= 0.9), None)
    return {"label": label, "snrs": snrs, "rates": rates.tolist(),
            "min_snr_90": min90, "ok": ok.tolist(),
            "theory_bps": cfg.theoretical_throughput(mod, rate)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from projectultra_tpu_torch.device import card_line, resolve

    device = resolve("cpu" if args.cpu else None)
    card = card_line(device)
    t0 = time.perf_counter()
    print(f"=== OFDM D8PSK vs DQPSK, full SNR range (AWGN), on {card} ===\n")
    out = []
    for row in rows():
        r = run_row(row, args.trials, device)
        out.append(r)
        print(f"--- {r['label']} ---")
        print("SNR:   " + "  ".join(f"{s:4.0f}dB" for s in r["snrs"]))
        print("Result:" + "  ".join(f"{x:5.0%}" for x in r["rates"]))
        print(flush=True)
    print("=== Summary ===")
    print(f"{'Mode':<12} {'Theory bps':>10}  Min SNR for 90%+")
    for r in out:
        m = r["min_snr_90"]
        print(f"{r['label']:<12} {r['theory_bps']:>10.0f}  "
              f"{('%.0f dB' % m) if m is not None else '>range'}")
    print(json.dumps({"trials": args.trials, "rows": out,
                      "wall_seconds": time.perf_counter() - t0,
                      "device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

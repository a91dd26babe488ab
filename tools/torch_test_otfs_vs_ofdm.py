#!/usr/bin/env python3
"""OTFS against OFDM across ITU-R F.1487 Watterson conditions on the
PyTorch/CUDA port (``tools/test_otfs_vs_ofdm.py`` runs the same cells on
the JAX package; reference tools/test_otfs_vs_ofdm.cpp).

Decode rate per channel condition of OFDM-DQPSK R1/2 (the presynced
``ofdm/pipeline``) and of OTFS-QPSK R1/2 with and without TF equalization
(``otfs/otfs``), aligned decode, ``--trials`` independent channel
realizations per cell on one batch axis.  ``channel`` takes one seed per
condition (the JAX tool's key 100 + index): the fading from a
``torch.Generator`` seeded with it, the AWGN from one seeded with
(seed, 1) (the JAX tool's ``fold_in(key, 1)``); the three waveforms of a
condition share them.  The last line is the result as one JSON object;
the exit code is 0, as the JAX tool's.  Runs on the card unless
``--cpu``.

    python3 tools/torch_test_otfs_vs_ofdm.py [--snr 20] [--trials 20]
        [--cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CONDITIONS = [("AWGN", None), ("Good", "good"), ("Moderate", "moderate"),
              ("Poor", "poor"), ("Flutter", "flutter")]


def channel(tx, preset, seed, snr_db):
    """Watterson ``preset`` (none for AWGN) from a generator seeded
    ``seed``, then harness AWGN from one seeded (seed, 1)."""
    import torch
    from projectultra_tpu_torch.sim import watterson as W
    dev = tx.device
    if preset is not None:
        tx = W.watterson(tx, W.PRESETS[preset](),
                         torch.Generator(device=dev).manual_seed(seed))
    return W.add_noise_active(tx, snr_db, W.seeded_generator(dev, seed, 1))


def run_condition(preset, seed, info, snr_db):
    """(OFDM ok, OTFS-EQ ok, OTFS-RAW ok) per trial on one condition."""
    import torch
    from projectultra_tpu_torch.config import CodeRate, Modulation
    from projectultra_tpu_torch.fec import ldpc
    from projectultra_tpu_torch.ofdm import pipeline as P
    from projectultra_tpu_torch.ops import ldpc as ldpc_ops
    from projectultra_tpu_torch.otfs import otfs as O

    rate = CodeRate.R1_2
    code = ldpc.get_code(rate)
    cfg = P.chirp_ofdm_config()
    tx = P.tx_frame(cfg, Modulation.DQPSK, rate, info)
    _, ok_ofdm, _ = P.rx_frame(cfg, Modulation.DQPSK, rate,
                               channel(tx, preset, seed, snr_db))
    cw = ldpc_ops.encode(code, info)
    oks = [ok_ofdm]
    for ocfg in (O.OTFSConfig(), O.OTFSConfig(tf_equalization=False)):
        tx = O.frame_tx(ocfg, Modulation.QPSK, cw)
        llrs = O.demodulate_frame(ocfg, Modulation.QPSK,
                                  channel(tx, preset, seed, snr_db))
        _, ok, _ = ldpc_ops.decode(code, llrs[:, :code.n].contiguous())
        oks.append(ok)
    return [torch.as_tensor(o).cpu().numpy() for o in oks]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--snr", type=float, default=20.0)
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from projectultra_tpu_torch.device import card_line, resolve
    from projectultra_tpu_torch.fec import ldpc
    from projectultra_tpu_torch.config import CodeRate

    device = resolve("cpu" if args.cpu else None)
    card = card_line(device)
    B = args.trials
    t0 = time.perf_counter()
    code = ldpc.get_code(CodeRate.R1_2)
    rng = np.random.default_rng(7)
    info = torch.from_numpy(
        rng.integers(0, 2, (B, code.k)).astype(np.float32)).to(device)
    print(f"OTFS vs OFDM, ITU-R F.1487 comparison (SNR {args.snr:.0f} dB, "
          f"{B} trials/cell, aligned decode), on {card}\n")
    print(f"{'Channel':<10} {'OFDM-DQPSK':>11} {'OTFS-EQ':>9} {'OTFS-RAW':>9}"
          f"  winner", flush=True)
    wins = {"OFDM": 0, "OTFS": 0, "TIE": 0}
    out = []
    for i, (name, preset) in enumerate(CONDITIONS):
        oks = run_condition(preset, 100 + i, info, args.snr)
        ofdm, otfs_eq, otfs_raw = (float(o.mean()) for o in oks)
        best_otfs = max(otfs_eq, otfs_raw)
        winner = ("OTFS" if best_otfs > ofdm + 0.05
                  else "OFDM" if ofdm > best_otfs + 0.05 else "TIE")
        wins[winner] += 1
        out.append({"channel": name, "ofdm": ofdm, "otfs_eq": otfs_eq,
                    "otfs_raw": otfs_raw, "winner": winner,
                    "ok": [o.tolist() for o in oks]})
        print(f"{name:<10} {ofdm:>10.0%} {otfs_eq:>9.0%} {otfs_raw:>9.0%}"
              f"  {winner}", flush=True)
    print(f"\nOFDM wins: {wins['OFDM']}  OTFS wins: {wins['OTFS']} "
          f" ties: {wins['TIE']}")
    print(json.dumps({"snr_db": args.snr, "trials": B, "conditions": out,
                      "wins": wins, "wall_seconds": time.perf_counter() - t0,
                      "device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

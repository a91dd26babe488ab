#!/usr/bin/env python3
"""Single-carrier DPSK decode rate against SNR (AWGN) on the PyTorch/CUDA
port (``tools/test_dpsk_snr.py`` runs the same rows on the JAX package;
reference tools/test_dpsk_snr.cpp).

R1/4 at very low SNR and R1/2 at low SNR for the DBPSK/DQPSK/D8PSK
presets, with the real Barker-13x3 preamble search (``psk/dpsk``) in the
loop.  Each (preset, rate) row's trials and SNR points ride one batch
axis; ``channel`` draws the AWGN from a ``torch.Generator`` seeded 13
(the JAX tool's key 13) and the info bits come from
``numpy.random.default_rng(9)``.  The last line is the result as one JSON
object; the exit code is 0, as the JAX tool's.  Runs on the card unless
``--cpu``.

    python3 tools/torch_test_dpsk_snr.py [--trials 10] [--cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def rows():
    from projectultra_tpu_torch.config import CodeRate
    from projectultra_tpu_torch.psk import dpsk as D
    return [
        ("DBPSK 31.25bd (robust)", D.robust(), CodeRate.R1_4,
         [-12.0, -11.0, -10.0, -8.0, -5.0]),
        ("DBPSK 62.5bd (low_snr)", D.low_snr(), CodeRate.R1_4,
         [-8.0, -5.0, -3.0, 0.0, 3.0]),
        ("DQPSK 62.5bd (medium)", D.medium(), CodeRate.R1_4,
         [-5.0, -3.0, 0.0, 3.0, 5.0]),
        ("DQPSK 125bd (fast)", D.fast(), CodeRate.R1_2,
         [0.0, 3.0, 5.0, 8.0, 10.0]),
        ("D8PSK 125bd (turbo)", D.turbo(), CodeRate.R1_2,
         [3.0, 5.0, 8.0, 10.0, 13.0]),
    ]


def channel(tx, snr_vec):
    """Harness AWGN at a per-frame SNR, from a generator seeded 13."""
    import torch
    from projectultra_tpu_torch.sim import watterson as W
    return W.add_noise_active(
        tx, snr_vec, torch.Generator(device=tx.device).manual_seed(13))


def run_row(row, trials, device):
    """One row as one batch: TX, channel, preamble search at a shared
    start (the batch is aligned), soft demodulation, decode."""
    import numpy as np
    import torch
    from projectultra_tpu_torch.fec import ldpc
    from projectultra_tpu_torch.ops import ldpc as ldpc_ops
    from projectultra_tpu_torch.psk import dpsk as D

    label, cfg, rate, snrs = row
    code = ldpc.get_code(rate)
    rng = np.random.default_rng(9)
    n = len(snrs) * trials
    info = rng.integers(0, 2, (n, code.k)).astype(np.float32)
    cw = ldpc_ops.encode(code, torch.from_numpy(info).to(device))
    pre = torch.from_numpy(D.generate_preamble(cfg)).to(device)
    data = D.modulate(cfg, cw)
    tx = torch.cat([pre[None].expand(n, -1), data,
                    torch.zeros((n, 4000), device=device)], dim=-1)
    snr_vec = torch.from_numpy(
        np.repeat(np.asarray(snrs, np.float32), trials)).to(device)
    noisy = channel(tx, snr_vec)
    found, ds, cfo, ipo, prev = D.find_preamble(cfg, noisy)
    start = int(ds[0])
    llrs = D.demodulate_soft(cfg, noisy[:, start:start + data.shape[-1]],
                             prev, cfo, ipo)
    _, ok, _ = ldpc_ops.decode(code, llrs[:, :648].contiguous())
    ok = (ok & found).cpu().numpy()
    return {"label": label, "rate": rate.name, "snrs": snrs,
            "rates": ok.reshape(len(snrs), trials).mean(-1).tolist(),
            "ok": ok.tolist()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from projectultra_tpu_torch.device import card_line, resolve

    device = resolve("cpu" if args.cpu else None)
    card = card_line(device)
    t0 = time.perf_counter()
    print(f"=== Single-carrier DPSK vs SNR (AWGN, {args.trials} trials/point, "
          f"preamble search in the loop), on {card} ===\n")
    out = []
    for row in rows():
        r = run_row(row, args.trials, device)
        out.append(r)
        print(f"--- {r['label']} R{r['rate'][1:].replace('_', '/')} ---")
        print("SNR:   " + "  ".join(f"{s:5.0f}dB" for s in r["snrs"]))
        print("Result:" + "  ".join(f"{x:6.0%}" for x in r["rates"]))
        print(flush=True)
    print(json.dumps({"trials": args.trials, "rows": out,
                      "wall_seconds": time.perf_counter() - t0,
                      "device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

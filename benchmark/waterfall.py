#!/usr/bin/env python3
"""Pin the waterfall SNR of the presynced waterfall cell, on the CPU.

    python3 benchmark/waterfall.py [--config ofdm_chirp_dqpsk_r12]
        [--frames 4096] [--seed 0] [--step 0.5] [--max 10]

From 0 dB upwards in steps of ``--step`` dB, runs ``--frames`` frames of
``--seed`` (the benchmark's traffic generator, window stream, step 0)
through the port's presynced path on the CPU (the plain decoder, which the
card's float32 kernel equals lane for lane) and prints each point's
frame-ok rate; stops at the first point whose rate reaches 0.5 and prints
it last as JSON.  That point is the waterfall traffic file's ``snr_db``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="ofdm_chirp_dqpsk_r12")
    ap.add_argument("--frames", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--step", type=float, default=0.5)
    ap.add_argument("--max", type=float, default=10.0)
    args = ap.parse_args(argv)

    import torch
    from benchmark import traffic as traffic_mod
    from benchmark.entries import presynced

    config = json.loads((ROOT / "benchmark" / "configs"
                         / f"{args.config}.json").read_text())
    cpu = torch.device("cpu")
    base = traffic_mod.Traffic("waterfall", args.frames, 0.0, 0, 0, 1,
                               args.frames)
    snr = 0.0
    while snr <= args.max:
        mix = dataclasses.replace(base, snr_db=snr)
        entry = presynced.Entry(config, mix, cpu)
        info, noise = traffic_mod.inputs(mix, entry.k, entry.T, args.seed, 0,
                                         cpu)
        with entry.precision():
            out = entry.step(info, noise, lambda _name: None)
        rate = float(out["ok"].float().mean())
        print(f"snr {snr:.1f} dB: ok rate {rate!r} over {args.frames} "
              f"frames, mean iterations "
              f"{float(entry.passes(out)) / args.frames!r}", flush=True)
        if rate >= 0.5:
            print(json.dumps({"snr_db": snr, "cpu_ok_rate": rate,
                              "frames": args.frames, "seed": args.seed}))
            return 0
        snr += args.step
    return 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Reference-vs-ours decode-rate overlay on the PyTorch/CUDA port: the
port's half of ``tools/parity_curves.py`` (BASELINE.md's north-star
clause: decode parity with the C++ reference at every tabulated point).

The JAX tool runs two harnesses over the same points, frame counts and
seeds: the compiled reference's ``test_iwaveform`` (built from the
reference's C++ sources) and the JAX package's single-stream harness.
The reference's sources are not part of this repository, so this twin
does not run the reference: it reads each point's ``ref_decoded`` /
``ref_total`` from the committed ``PARITY_CURVES.json`` (written by the
JAX tool; 23 points, seeds 42, 43 and 44) and runs only ``run_ours``, the
port's single-stream discipline (``parallel/sweep``: one TX engine, one
continuous noisy stream, one RX engine fed 960-sample chunks) on the
run's device: ``stream_tx``, then ``channel`` (the point's CFO and AWGN
or Watterson fading from a ``torch.Generator`` seeded from the seed the
JAX tool gives ``jax.random.PRNGKey``), then ``receive_stream``.

Gate (the JAX tool's): ours >= ref at every point run, over the JSON's
seeds and frame counts.  ``--points`` picks points by index (every seed
still runs, so each total stays comparable with the reference's); the
frames of every short point's noisy streams can be saved (``--streams``)
to replay through another receiver.  Prints a table and, last, one JSON
object: each point's ours/ref and the verdict.  Exit 0 when every point
is at or above the reference, else 1.  Writes a file only where ``--out``
says, never ``PARITY_CURVES.json`` itself.  Runs on the card unless
``--cpu``.

    python3 tools/torch_parity_curves.py [--points 0,3,20] [--quick]
        [--out FILE] [--streams DIR] [--cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REF_JSON = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "PARITY_CURVES.json")

# (waveform, snr, cfo, channel, rate, frames) -- the JAX tool's points:
# regression_matrix.sh rows first (basic tier :134-191, then --full tier
# :193-238), then the OFDM_COX BASELINE link-table rows the reference
# harness accepts.
POINTS = [
    ("MC_DPSK", 5.0, 0.0, "awgn", "r1_4", 5),
    ("MC_DPSK", 5.0, 30.0, "awgn", "r1_4", 5),
    ("MC_DPSK", 0.0, 30.0, "awgn", "r1_4", 5),
    ("MC_DPSK", 5.0, 0.0, "moderate", "r1_4", 5),
    ("MC_DPSK", 5.0, 30.0, "moderate", "r1_4", 5),
    ("MC_DPSK", 15.0, 30.0, "poor", "r1_4", 5),
    ("OFDM_CHIRP", 17.0, 0.0, "awgn", "r1_2", 5),
    ("OFDM_CHIRP", 17.0, 30.0, "awgn", "r1_2", 5),
    ("OFDM_CHIRP", 17.0, 50.0, "awgn", "r1_2", 5),
    ("OFDM_CHIRP", 15.0, 0.0, "moderate", "r1_4", 5),
    ("OFDM_CHIRP", 15.0, 30.0, "moderate", "r1_4", 5),
    # --full tier
    ("MC_DPSK", -3.0, 0.0, "awgn", "r1_4", 10),
    ("MC_DPSK", 10.0, 50.0, "awgn", "r1_4", 10),
    ("MC_DPSK", 10.0, 0.0, "poor", "r1_4", 10),
    ("MC_DPSK", 10.0, 30.0, "poor", "r1_4", 10),
    ("OFDM_CHIRP", 10.0, 30.0, "awgn", "r1_2", 10),
    ("OFDM_CHIRP", 15.0, 30.0, "good", "r1_4", 10),
    ("MC_DPSK", 5.0, -30.0, "awgn", "r1_4", 5),
    ("OFDM_CHIRP", 17.0, -50.0, "awgn", "r1_2", 5),
    ("OFDM_CHIRP", 15.0, 0.0, "poor", "r1_4", 10),
    # OFDM_COX (BASELINE link-table rows within the harness's flag set;
    # the reference's own streaming Cox RX decodes none of these frames).
    ("OFDM_COX", 17.0, 0.0, "awgn", "r1_2", 5),
    ("OFDM_COX", 25.0, 10.0, "awgn", "r1_2", 5),
    ("OFDM_COX", 15.0, 0.0, "moderate", "r1_4", 5),
]

QUICK_POINTS = POINTS[:6] + POINTS[6:11:2] + POINTS[-3:]


def sweep_point(wf, snr, cfo, chan, rate, frames):
    from projectultra_tpu_torch.config import CodeRate
    from projectultra_tpu_torch.parallel.sweep import SweepPoint
    return SweepPoint(wf, snr, cfo, chan, rate=CodeRate[rate.upper()],
                      frames=frames)


def channel(point, stream, seed):
    """The point's channel (``sweep._apply_channel``) over the clean
    ``stream`` ([1, T] on the run's device), noise from a generator seeded
    from ``seed``; returns the noisy stream as numpy."""
    from projectultra_tpu_torch.parallel import sweep as SW
    from projectultra_tpu_torch.sim import watterson as W
    g = W.seeded_generator(stream.device, seed)
    return SW._apply_channel(point, stream, g)[0].cpu().numpy()


def run_ours(wf, snr, cfo, chan, rate, frames, seed, device):
    """One seed of one point through the port's single-stream harness:
    (frames decoded, frames sent, the noisy stream)."""
    import torch
    from projectultra_tpu_torch.parallel import sweep as SW
    point = sweep_point(wf, snr, cfo, chan, rate, frames)
    stream = torch.from_numpy(SW.stream_tx(point, device)).to(device)
    noisy = channel(point, stream[None, :], seed)
    res, _ = SW.receive_stream(point, noisy, device)
    return round(res.decode_rate * frames), frames, noisy


def reference_counts(path):
    """{point tuple: (ref_decoded, ref_total, seeds)} from a
    PARITY_CURVES.json written by the JAX tool."""
    with open(path) as f:
        curves = json.load(f)
    return {(p["waveform"], p["snr_db"], p["cfo_hz"], p["channel"],
             p["rate"], p["frames_per_seed"]):
            (p["ref_decoded"], p["ref_total"], p["seeds"])
            for p in curves["points"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", default=None,
                    help="comma-separated indices into POINTS (default all)")
    ap.add_argument("--quick", action="store_true",
                    help="the JAX tool's reduced point set (QUICK_POINTS), "
                         "at every seed")
    ap.add_argument("--out", default=None,
                    help="also write the JSON result here")
    ap.add_argument("--streams", default=None,
                    help="save the noisy streams of points below the "
                         "reference into this directory")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    if args.out is not None and \
            os.path.realpath(args.out) == os.path.realpath(REF_JSON):
        ap.error("--out must not overwrite PARITY_CURVES.json "
                 "(the JAX tool's artifact, read by tests)")

    import numpy as np
    from projectultra_tpu_torch.device import card_line, resolve
    from projectultra_tpu_torch.ops import cuda_ldpc, cuda_sc

    device = resolve("cpu" if args.cpu else None)
    card = card_line(device)
    ref = reference_counts(REF_JSON)
    if args.points is not None:
        points = [POINTS[int(i)] for i in args.points.split(",")]
    else:
        points = QUICK_POINTS if args.quick else POINTS
    launches0 = (cuda_ldpc.launches, cuda_sc.launches)
    t0 = time.perf_counter()

    rows = []
    print(f"{'waveform':<11} {'chan':<9} {'SNR':>5} {'CFO':>5} {'rate':<5} "
          f"{'ref':>7} {'ours':>7}   on {card}")
    for pt in points:
        wf, snr, cfo, chan, rate, frames = pt
        ref_ok, ref_n, seeds = ref[pt]
        t1 = time.perf_counter()
        our_ok = our_n = 0
        noisy = {}
        for seed in seeds:
            ok, n, noisy[seed] = run_ours(*pt, seed, device)
            our_ok += ok
            our_n += n
        row = {"waveform": wf, "snr_db": snr, "cfo_hz": cfo,
               "channel": chan, "rate": rate, "frames_per_seed": frames,
               "seeds": seeds,
               "ref_decoded": ref_ok, "ref_total": ref_n,
               "our_decoded": our_ok, "our_total": our_n,
               "ref_fer": round(1 - ref_ok / ref_n, 4),
               "our_fer": round(1 - our_ok / our_n, 4),
               "wall_seconds": time.perf_counter() - t1}
        rows.append(row)
        if our_ok < ref_ok and args.streams:
            os.makedirs(args.streams, exist_ok=True)
            for seed, x in noisy.items():
                np.save(os.path.join(args.streams, f"point{POINTS.index(pt)}"
                                     f"_seed{seed}.npy"), x)
        print(f"{wf:<11} {chan:<9} {snr:>5.1f} {cfo:>5.0f} {rate:<5} "
              f"{ref_ok:>3}/{ref_n:<3} {our_ok:>3}/{our_n:<3}"
              f"  {'OK' if our_ok >= ref_ok else '** BELOW REF **'}"
              f"  [{row['wall_seconds']:.1f} s]", flush=True)

    out = {
        "description": "Reference-vs-ours decode-rate overlay: the port's "
                       "single-stream harness against the reference's "
                       "counts in PARITY_CURVES.json, at the reference's "
                       "own frame counts over the same seed list.",
        "ref_counts": os.path.basename(REF_JSON),
        "our_harness": "projectultra_tpu_torch.parallel.sweep "
                       "(stream_tx, receive_stream)",
        "points": rows,
        "all_points_at_or_above_reference":
            all(r["our_decoded"] >= r["ref_decoded"] for r in rows),
        "wall_seconds": time.perf_counter() - t0,
        "launches": {"ldpc_minsum": cuda_ldpc.launches - launches0[0],
                     "sc_windows": cuda_sc.launches - launches0[1]},
        "device": card,
    }
    if args.out is not None:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(f"\nours >= ref at every point: "
          f"{out['all_points_at_or_above_reference']}")
    print(json.dumps(out))
    return 0 if out["all_points_at_or_above_reference"] else 1


if __name__ == "__main__":
    sys.exit(main())

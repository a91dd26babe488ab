#!/usr/bin/env python3
"""BER/FER against SNR per (modulation, rate) on the PyTorch/CUDA port
(``tools/ber_curves.py`` runs the same rows on the JAX package).

Every (SNR point x frame) pair rides one batch axis, so a curve of 7 SNR
points x 2,048 noise realisations is one batch of 14,336 encode -> channel
-> decode pipelines per row (OFDM_CHIRP, presynced).  Noise comes from a
seeded ``torch.Generator`` on the run's device.  ``--bf16`` decodes with
bfloat16 LDPC edge messages (``ULTRA_LDPC_BF16=1``): overlaid on the
default float32 run it shows whether the fast mode shifts the waterfall.
Writes a JSON artifact (the JAX tool's keys, plus the device and each
row's seconds), prints it as the last line, and runs on the card unless
``--cpu``.

    python3 tools/torch_ber_curves.py [--frames 2048] [--bf16] [--cpu]
        [--channel awgn|good|moderate|poor|flutter] [--seed 7] [--json PATH]
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

ROWS = [  # (label, modulation, rate, SNR points in dB): tools/ber_curves.py
    ("OFDM DQPSK R1/4", "DQPSK", "R1_4", [-8.0, -6.0, -4.0, -2.0, 0.0, 2.0, 4.0]),
    ("OFDM DQPSK R1/2", "DQPSK", "R1_2", [0.0, 2.0, 4.0, 6.0, 8.0, 10.0, 12.0]),
    ("OFDM DQPSK R2/3", "DQPSK", "R2_3", [-2.0, 0.0, 2.0, 4.0, 6.0, 8.0, 10.0]),
    ("OFDM D8PSK R1/2", "D8PSK", "R1_2", [2.0, 4.0, 6.0, 8.0, 10.0, 12.0, 14.0]),
]


@contextlib.contextmanager
def ldpc_messages(bf16: bool):
    """The run's LDPC edge messages: ``ULTRA_LDPC_BF16=1`` for a first
    import of the port, and the port's default set for the run when it is
    imported already (an in-process caller); both restored after."""
    saved = os.environ.get("ULTRA_LDPC_BF16")
    if bf16:
        os.environ["ULTRA_LDPC_BF16"] = "1"
    try:
        import torch
        from projectultra_tpu_torch.ops import ldpc
        with ldpc.default_msg_dtype(torch.bfloat16 if bf16
                                    else torch.float32):
            yield
    finally:
        if saved is None:
            os.environ.pop("ULTRA_LDPC_BF16", None)
        else:
            os.environ["ULTRA_LDPC_BF16"] = saved


def run(frames: int, channel: str, seed: int, device) -> dict:
    """Every row's curve on ``device``: the artifact without its header."""
    import numpy as np
    import torch
    from projectultra_tpu_torch.config import CodeRate, Modulation
    from projectultra_tpu_torch.fec import ldpc
    from projectultra_tpu_torch.ofdm import pipeline as P
    from projectultra_tpu_torch.sim import watterson as W

    preset = None if channel == "awgn" else W.PRESETS[channel]
    rows, total = [], 0
    t_all = time.perf_counter()
    for label, mod, rate, snrs in ROWS:
        mod, rate = Modulation[mod], CodeRate[rate]
        cfg = P.chirp_ofdm_config()
        code = ldpc.get_code(rate)
        n = len(snrs) * frames
        rng = np.random.default_rng(42)
        info = torch.from_numpy(
            rng.integers(0, 2, (n, code.k)).astype(np.uint8)).to(device)
        snr_vec = torch.from_numpy(
            np.repeat(np.asarray(snrs, np.float32), frames)).to(device)
        g = torch.Generator(device=device).manual_seed(seed)
        t0 = time.perf_counter()
        tx = P.tx_frame(cfg, mod, rate, info)
        if preset is not None:
            tx = W.watterson(tx, preset(), g)
        rx = W.add_noise_active(tx, snr_vec, g)
        out, ok, _ = P.rx_frame(cfg, mod, rate, rx)
        bits_err = (out != info).reshape(len(snrs), frames, -1).cpu().numpy()
        oks = ok.reshape(len(snrs), frames).cpu().numpy()
        dt = time.perf_counter() - t0
        total += n
        ber = bits_err.mean((1, 2))
        fer = 1.0 - oks.mean(1)
        print(f"--- {label} [{channel}]  ({n} pipelines in {dt:.2f}s, "
              f"{n / dt:.0f} pipelines/s) ---")
        print("SNR:  " + "  ".join(f"{s:6.0f}" for s in snrs))
        print("FER:  " + "  ".join(f"{v:6.4f}" for v in fer))
        print("BER:  " + "  ".join(f"{v:6.4f}" for v in ber))
        print()
        rows.append({"label": label, "snrs": snrs, "fer": fer.tolist(),
                     "ber": ber.tolist(), "seconds": dt})
    return {"rows": rows, "total_pipelines": total,
            "wall_seconds": round(time.perf_counter() - t_all, 2)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--frames", type=int, default=2048,
                    help="frames per SNR point")
    ap.add_argument("--json", default=os.path.join(tempfile.gettempdir(),
                                                   "torch_ber_curves.json"))
    ap.add_argument("--channel", default="awgn",
                    choices=["awgn", "good", "moderate", "poor", "flutter"])
    ap.add_argument("--seed", type=int, default=7,
                    help="seed of the noise generator")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 LDPC edge messages (overlay against the "
                         "default f32 run to verify no waterfall shift)")
    args = ap.parse_args(argv)

    with ldpc_messages(args.bf16):
        from projectultra_tpu_torch.device import card_line, resolve
        device = resolve("cpu" if args.cpu else None)
        artifact = {"frames_per_point": args.frames, "channel": args.channel,
                    "ldpc_msg_dtype": "bf16" if args.bf16 else "f32",
                    "device": card_line(device)}
        artifact.update(run(args.frames, args.channel, args.seed, device))
    with open(args.json, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"{artifact['total_pipelines']} pipelines in "
          f"{artifact['wall_seconds']:.1f}s on {artifact['device']} "
          f"-> {args.json}")
    print(json.dumps(artifact))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Chirp-acquisition throughput on the PyTorch/CUDA port
(``tools/profile_acquisition.py`` runs the same measurement on the JAX
package; reference tools/profile_acquisition.cpp).

Times batched dual-chirp detection (``sync.chirp.detect_dual_chirp``: the
decimated FFT search and the full-rate refine) over B buffers of
``--seconds`` of 5 dB audio, each holding one chirp at a numpy-seeded
offset, and reports buffers/s and samples/s searched; each timed
iteration ends in ``torch.cuda.synchronize()``.  ``--bf16`` runs the
acquisition's bf16 mode (``ULTRA_CHIRP_BF16=1``).  The last line is the
result as one JSON object.  Runs on the card unless ``--cpu``.  A buffer
must hold the 1.2 s dual chirp and 1,000 samples more.

    python3 tools/torch_profile_acquisition.py [--batch 64] [--seconds 4]
        [--iters 8] [--bf16] [--cpu]
"""

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


@contextlib.contextmanager
def chirp_mode(bf16: bool):
    """The acquisition's bf16 mode for the run: ``ULTRA_CHIRP_BF16=1`` for
    a first import of the port, and the port's flag set for the run when it
    is imported already; both restored after."""
    saved = os.environ.get("ULTRA_CHIRP_BF16")
    if bf16:
        os.environ["ULTRA_CHIRP_BF16"] = "1"
    try:
        from projectultra_tpu_torch.sync import chirp
        with chirp.bf16_mode(bf16):
            yield
    finally:
        if saved is None:
            os.environ.pop("ULTRA_CHIRP_BF16", None)
        else:
            os.environ["ULTRA_CHIRP_BF16"] = saved


def measure(batch: int, seconds: float, iters: int, device) -> dict:
    """Detection quality and throughput of ``batch`` buffers on ``device``."""
    import numpy as np
    import torch
    from projectultra_tpu_torch.sim import watterson as W
    from projectultra_tpu_torch.sync import chirp as CS

    cc = CS.ChirpConfig()
    T = int(seconds * 48000)
    rng = np.random.default_rng(0)
    sig = np.zeros((batch, T), np.float32)
    c = CS.generate(cc)
    offs = rng.integers(0, T - len(c) - 1000, batch)
    for b, off in enumerate(offs):
        sig[b, off:off + len(c)] = c
    noisy = W.add_noise_active(torch.from_numpy(sig).to(device), 5.0,
                               torch.Generator(device=device).manual_seed(0))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    det = CS.detect_dual_chirp(cc, noisy)
    sync()
    found = det["success"].cpu().numpy()
    err = np.abs(det["up_chirp_start"].cpu().numpy() - offs)
    t0 = time.perf_counter()
    for _ in range(iters):
        det = CS.detect_dual_chirp(cc, noisy)
        sync()
    dt = (time.perf_counter() - t0) / iters
    return {"found": float(found.mean()),
            "pos_err_p50": float(np.percentile(err, 50)),
            "pos_err_p95": float(np.percentile(err, 95)),
            "ms": dt * 1e3, "buffers_per_s": batch / dt,
            "samples_per_s": batch * T / dt}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=4.0,
                    help="audio seconds per buffer")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--bf16", action="store_true",
                    help="the acquisition's bf16 mode")
    args = ap.parse_args(argv)

    with chirp_mode(args.bf16):
        from projectultra_tpu_torch.device import card_line, resolve
        device = resolve("cpu" if args.cpu else None)
        card = card_line(device)
        r = measure(args.batch, args.seconds, args.iters, device)
    mode = "bf16" if args.bf16 else "f32"
    print(f"detection ({mode}): {r['found']:.0%} found, pos err "
          f"p50={r['pos_err_p50']:.0f} p95={r['pos_err_p95']:.0f} samples")
    print(f"acquisition ({mode}): {args.batch} x {args.seconds:g}s buffers in "
          f"{r['ms']:.2f} ms -> {r['buffers_per_s']:.0f} buffers/s, "
          f"{r['samples_per_s'] / 1e9:.3f} Gsamples/s searched on "
          f"{card}")
    print(json.dumps({"mode": mode, "batch": args.batch,
                      "seconds": args.seconds, **r,
                      "device": card}))
    return 0 if r["found"] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())

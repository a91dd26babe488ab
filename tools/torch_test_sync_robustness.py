#!/usr/bin/env python3
"""OFDM Schmidl-Cox sync and decode under front-end impairments on the
PyTorch/CUDA port (``tools/test_sync_robustness.py`` runs the same
conditions on the JAX package; reference tools/test_sync_robustness.cpp).

PTT noise bursts, CFO up to +-50 Hz, a static multipath echo, an amplitude
ramp (AGC settling), a DC offset and the combined case, each on a batch of
``--trials`` copies of one QPSK R1/4 two-codeword frame of the default
512-FFT pilot plan, through ``decode_ofdm_cox`` (the window kernel on the
card) and a bit-exact decode.  The CFO goes through
``sim/watterson.apply_cfo_hilbert`` (FFT at the next power of two);
``channel`` draws the AWGN from a ``torch.Generator`` seeded 100 + the
condition's index (the JAX tool's keys); the PTT bursts come from
``numpy.random.default_rng(7 + index)``.  Target: every trial of every
condition (ALL PASS; exit 1 otherwise).  The last line is the result as
one JSON object.  Runs on the card unless ``--cpu``.

    python3 tools/torch_test_sync_robustness.py [--snr 20] [--trials 10]
        [--cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

FS = 48000
LEAD, TAIL = 7200, 4000
NCW = 2

CONDITIONS = [
    ("Clean", {}),
    ("PTT noise 250ms", dict(ptt_ms=250)),
    ("PTT noise 500ms", dict(ptt_ms=500)),
    ("CFO +25 Hz", dict(ptt_ms=250, cfo=25.0)),
    ("CFO -25 Hz", dict(ptt_ms=250, cfo=-25.0)),
    ("CFO +50 Hz", dict(ptt_ms=250, cfo=50.0)),
    ("CFO -50 Hz", dict(ptt_ms=250, cfo=-50.0)),
    ("Multipath 0.5ms g0.3", dict(ptt_ms=250, mp_delay_ms=0.5, mp_gain=0.3)),
    ("Multipath 1.0ms g0.3", dict(ptt_ms=250, mp_delay_ms=1.0, mp_gain=0.3)),
    ("Multipath 2.0ms g0.2", dict(ptt_ms=250, mp_delay_ms=2.0, mp_gain=0.2)),
    ("Amplitude ramp 50ms", dict(ptt_ms=250, ramp_ms=50.0)),
    ("Amplitude ramp 100ms", dict(ptt_ms=250, ramp_ms=100.0)),
    ("DC offset +0.05", dict(ptt_ms=250, dc=0.05)),
    ("DC offset -0.05", dict(ptt_ms=250, dc=-0.05)),
    ("Combined CFO+mp+ramp+DC", dict(ptt_ms=250, cfo=30.0, mp_delay_ms=1.0,
                                     mp_gain=0.25, ramp_ms=50.0, dc=0.02)),
]


def channel(y, snr_db, seed):
    """Harness AWGN on the impaired batch, from a generator seeded
    100 + ``seed``."""
    import torch
    from projectultra_tpu_torch.sim import watterson as W
    return W.add_noise_active(
        y, snr_db, torch.Generator(device=y.device).manual_seed(100 + seed))


class Frame:
    """The frame every condition carries: info bits from
    ``numpy.random.default_rng(3)``, the channel interleave, the Cox
    preamble and QPSK data between LEAD and TAIL zeros."""

    def __init__(self, device):
        import numpy as np
        import torch
        from projectultra_tpu_torch.config import (CodeRate, ModemConfig,
                                                   Modulation,
                                                   bits_per_symbol)
        from projectultra_tpu_torch.fec import ldpc
        from projectultra_tpu_torch.fec.interleave import channel_interleaver
        from projectultra_tpu_torch.ofdm import carriers as C
        from projectultra_tpu_torch.ofdm import modulator as M
        from projectultra_tpu_torch.ops import ldpc as ldpc_ops

        self.device = device
        self.cfg = ModemConfig()
        self.mod = Modulation.QPSK
        self.code = ldpc.get_code(CodeRate.R1_4)
        rng = np.random.default_rng(3)
        self.info = rng.integers(0, 2, (NCW, self.code.k)).astype(np.float32)
        cw = ldpc_ops.encode(self.code, torch.from_numpy(self.info).to(
            device)).cpu().numpy()
        cm = C.carrier_map(self.cfg)
        self.ci = channel_interleaver(
            len(cm.data_idx) * bits_per_symbol(self.mod), self.code.n)
        inter = cw[:, self.ci.inv].reshape(1, -1)
        pre = M.generate_preamble(self.cfg)
        data = M.modulate(self.cfg, self.mod, torch.from_numpy(inter).to(
            device), t_offset=M.preamble_data_t_offset(self.cfg))[0]
        self.tx = np.concatenate([np.zeros(LEAD, np.float32), pre,
                                  data.cpu().numpy(),
                                  np.zeros(TAIL, np.float32)])

    def impair(self, B, snr, ptt_ms=0, cfo=0.0, mp_delay_ms=0.0, mp_gain=0.0,
               ramp_ms=0.0, dc=0.0, seed=0):
        """The JAX tool's ``impair``: echo and ramp on the host, the CFO and
        the noise on the device, then the PTT burst and the DC offset."""
        import numpy as np
        import torch
        from projectultra_tpu_torch.sim import watterson as W
        tx = self.tx
        x = np.broadcast_to(tx, (B, len(tx))).copy()
        if mp_gain > 0:
            d = int(mp_delay_ms * FS / 1000)
            x[:, d:] += mp_gain * x[:, :len(tx) - d]
        if ramp_ms > 0:
            r = int(ramp_ms * FS / 1000)
            x[:, :r] *= np.linspace(0.0, 1.0, r, dtype=np.float32)[None, :]
        y = torch.from_numpy(x).to(self.device)
        if cfo:
            y = W.apply_cfo_hilbert(y, torch.full(
                (B,), cfo, dtype=torch.float32, device=self.device))
        out = channel(y, snr, seed).cpu().numpy()
        if ptt_ms:
            n = int(ptt_ms * FS / 1000)
            burst = 0.3 * np.random.default_rng(7 + seed).standard_normal(
                (B, n)).astype(np.float32)
            out = np.concatenate([burst, out], axis=-1)
        if dc:
            out = out + np.float32(dc)
        return torch.from_numpy(out).to(self.device)

    def receive(self, rx):
        """Per-trial verdict: found, every codeword ok and bit-exact."""
        import numpy as np
        import torch
        from projectultra_tpu_torch.ops import ldpc as ldpc_ops
        from projectultra_tpu_torch.sync import schmidl_cox as SC
        B = rx.shape[0]
        n = self.code.n
        llrs, det = SC.decode_ofdm_cox(self.cfg, self.mod, rx, NCW)
        blocks = llrs.cpu().numpy()[:, :NCW * n].reshape(B * NCW, n)
        out, ok, _ = ldpc_ops.decode(self.code, torch.from_numpy(
            np.ascontiguousarray(blocks[:, self.ci.perm])).to(self.device))
        out = out.cpu().numpy().reshape(B, NCW, self.code.k)
        return (ok.cpu().numpy().reshape(B, NCW).all(-1)
                & det["found"].cpu().numpy()
                & (out == self.info[None].astype(np.uint8)).all((-1, -2)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--snr", type=float, default=20.0)
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from projectultra_tpu_torch.device import card_line, resolve

    device = resolve("cpu" if args.cpu else None)
    card = card_line(device)
    B = args.trials
    t0 = time.perf_counter()
    frame = Frame(device)
    print(f"OFDM sync robustness: {frame.mod.name} R1/4, SNR {args.snr:.0f} "
          f"dB, {B} trials/condition, on {card}\n", flush=True)
    passed, out = 0, []
    for i, (name, kw) in enumerate(CONDITIONS):
        good = frame.receive(frame.impair(B, args.snr, seed=i, **kw))
        n_ok = int(good.sum())
        passed += n_ok == B
        out.append({"condition": name, "ok": good.tolist(), "passed": n_ok})
        print(f"  {name:<28} {n_ok:>2}/{B} {'PASS' if n_ok == B else 'FAIL'}",
              flush=True)
    all_pass = passed == len(CONDITIONS)
    print(f"\n{passed}/{len(CONDITIONS)} categories at {B}/{B} — "
          f"{'ALL PASS' if all_pass else 'FAILURES'}")
    print(json.dumps({"gate": all_pass, "trials": B, "conditions": out,
                      "wall_seconds": time.perf_counter() - t0,
                      "device": card}))
    return 0 if all_pass else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Sample-rate-offset (SRO) robustness on the PyTorch/CUDA port: decode
rate against TX/RX clock skew (``tools/test_sro.py`` runs the same rows
on the JAX package).

TX and RX soundcards run on independent crystals tens of ppm apart, so
the RX stream is a fractionally resampled copy of the TX audio: symbol
timing drifts through the frame and every tone scales by (1 + eps).  The
skew is injected by Catmull-Rom cubic fractional resampling in float64
(``apply_sro``), before the noise, and the stream goes through the real
streaming path: one ``ModemEngine`` per variant, 960-sample feeds, a poll
every 4,800 samples, no position oracle.  Payloads, gaps and noise come
from ``numpy.random.default_rng(11)``, so the port and the JAX tool see
the same stream.  ``run_row`` is the shared harness of this tool,
``torch_test_cfo_ramp.py`` and ``torch_test_session_throughput.py``.

Gate: every frame decoded at |ppm| <= 100 (the +100 ppm 512-plan edge is
closed by the engine's failed-decode clock-skew retry,
``modem/acquisition/cox.py``; ``frames_sro_retried`` counts it).  The last
line is the result as one JSON object.  Runs on the card unless ``--cpu``.

    python3 tools/torch_test_sro.py [--quick] [--rows r1,r2]
        [--ppm 0,20,-20,50,-50,100,-100] [--frames 3] [--cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def apply_sro(audio, ppm):
    """Resample by (1 + ppm*1e-6): RX clock slower/faster than TX.

    Catmull-Rom cubic interpolation at fractional positions
    t_n = n * (1 + eps); ~18x oversampling puts the cubic's interpolation
    error far below -80 dB in the 300-2700 Hz band.
    """
    import numpy as np
    eps = ppm * 1e-6
    n_out = int(len(audio) / (1.0 + eps)) - 4
    t = np.arange(n_out, dtype=np.float64) * (1.0 + eps)
    i = np.floor(t).astype(np.int64)
    f = (t - i).astype(np.float64)
    x = np.pad(audio.astype(np.float64), (1, 3))
    xm1, x0, x1, x2 = x[i], x[i + 1], x[i + 2], x[i + 3]
    # Catmull-Rom basis
    a = -0.5 * xm1 + 1.5 * x0 - 1.5 * x1 + 0.5 * x2
    b = xm1 - 2.5 * x0 + 2.0 * x1 - 0.5 * x2
    c = -0.5 * xm1 + 0.5 * x1
    return (((a * f + b) * f + c) * f + x0).astype(np.float32)


def _connected(engine, waveform, mod, rate):
    engine.set_waveform_mode(waveform)
    engine.connect_waveform = waveform
    engine.connected = True
    engine.handshake_complete = True
    engine.data_modulation = mod
    engine.data_code_rate = rate
    return engine


def run_row(label, mk_engine, waveform, mod, rate, snr_db, payload, ppm_list,
            frames, chunk=960, verbose=True, distort=None, unit="ppm"):
    """Streams ``frames`` random-payload frames through one RX engine per
    variant value in ``ppm_list``, applying ``distort(stream, value)``
    (default: ``apply_sro``) before the noise.  ``mk_engine()`` makes each
    engine (the TX one first, then one RX engine per value, in order), so
    a caller can keep them and read their stats.  Returns
    {value: (frames decoded, frames)}."""
    import numpy as np
    from projectultra_tpu_torch.protocol import frame_v2 as F

    if distort is None:
        distort = apply_sro

    rng = np.random.default_rng(11)
    tx = _connected(mk_engine(), waveform, mod, rate)
    # Random payloads: fixed ones hide payload-dependent corruption at
    # high-order modes.
    payloads = [rng.integers(0, 256, payload).astype(np.uint8).tobytes()
                for _ in range(frames)]
    frame_audio = [tx.transmit(F.DataFrame.make_data(
        "W1AW", "VE3ABC", i, pb).serialize()) for i, pb in enumerate(payloads)]

    results = {}
    for ppm in ppm_list:
        stream_parts = [np.zeros(int(rng.uniform(1.0, 2.0) * 48000),
                                 np.float32)]
        for fa in frame_audio:
            stream_parts.append(fa)
            stream_parts.append(np.zeros(int(rng.uniform(0.5, 1.0) * 48000),
                                         np.float32))
        stream_parts.append(np.zeros(48000, np.float32))
        stream = np.concatenate(stream_parts)
        stream = distort(stream, ppm)
        sig_power = float(np.mean(np.concatenate(frame_audio) ** 2))
        noise = rng.normal(0, np.sqrt(sig_power / 10 ** (snr_db / 10.0)),
                           len(stream)).astype(np.float32)
        stream = stream + noise

        rx = _connected(mk_engine(), waveform, mod, rate)
        got = []
        rx.on_frame = got.append
        fed = 0
        for i in range(0, len(stream), chunk):
            rx.feed_audio(stream[i:i + chunk])
            fed += chunk
            if fed % 4800 < chunk:
                rx.poll()
        rx.feed_audio(np.zeros(16000, np.float32))
        rx.poll()

        decoded = []
        for fr in got:
            df = F.DataFrame.deserialize(fr.frame_bytes)
            if df:
                decoded.append(bytes(df.payload))
        n_ok = sum(1 for pb in payloads if pb in decoded)
        results[ppm] = (n_ok, frames)
        if verbose:
            print(f"  {label:<34} {ppm:>+6} {unit}  {n_ok}/{frames}",
                  flush=True)
    return results


def rows(device):
    """The tool's rows: key -> (label, engine factory, waveform, modulation,
    rate, SNR dB, payload bytes), as tools/test_sro.py's."""
    from projectultra_tpu_torch.config import CodeRate, Modulation, nvis_mode
    from projectultra_tpu_torch.modem.engine import ModemEngine
    from projectultra_tpu_torch.protocol.frame_v2 import WaveformMode

    def plan512():
        return ModemEngine(device=device)

    def nvis():
        return ModemEngine(config=nvis_mode(), device=device)

    cox, chirp = WaveformMode.OFDM_COX, WaveformMode.OFDM_CHIRP
    return {
        "cox_dqpsk": ("512 COX DQPSK R1/2 @25dB", plan512, cox,
                      Modulation.DQPSK, CodeRate.R1_2, 25.0, 200),
        "cox_qam16": ("512 COX QAM16 R2/3 @25dB", plan512, cox,
                      Modulation.QAM16, CodeRate.R2_3, 25.0, 400),
        "chirp_dqpsk": ("512 CHIRP DQPSK R1/2 @17dB", plan512, chirp,
                        Modulation.DQPSK, CodeRate.R1_2, 17.0, 200),
        "mc_dpsk": ("MC-DPSK DQPSK R1/2 @10dB", plan512,
                    WaveformMode.MC_DPSK, Modulation.DQPSK, CodeRate.R1_2,
                    10.0, 120),
        "otfs": ("OTFS_EQ QPSK R1/2 @20dB", plan512, WaveformMode.OTFS_EQ,
                 Modulation.QPSK, CodeRate.R1_2, 20.0, 150),
        # 33 dB wideband: the reference's "30+" is on its inflated pilot
        # scale; 432 B matches the throughput row's frame shape.
        "nvis_qam32": ("NVIS QAM32 R3/4 @33dB", nvis, cox, Modulation.QAM32,
                       CodeRate.R3_4, 33.0, 432),
        "nvis_qam64": ("NVIS QAM64 R3/4 @33dB", nvis, cox, Modulation.QAM64,
                       CodeRate.R3_4, 33.0, 1500),
        "nvis_qam256": ("NVIS QAM256 R5/6 @42dB", nvis, cox,
                        Modulation.QAM256, CodeRate.R5_6, 42.0, 4000),
    }


def run_matrix(table, selected, values, frames, gate, unit, distort=None):
    """Each selected row through ``run_row`` over ``values``.  Returns
    (per row {"label", "decoded": {value: [ok, n]}, "retried": {value:
    frames_sro_retried of that value's RX engine}}, the gate's verdict):
    the gate fails when a value with |value| <= gate misses a frame."""
    out, all_ok = {}, True
    for key in selected:
        label, mk, wf, mod, rate, snr, payload = table[key]
        engines = []

        def recording():
            engines.append(mk())
            return engines[-1]

        res = run_row(label, recording, wf, mod, rate, snr, payload, values,
                      frames, distort=distort, unit=unit)
        out[key] = {"label": label,
                    "decoded": {str(v): list(r) for v, r in res.items()},
                    "retried": {str(v): e.stats.frames_sro_retried
                                for v, e in zip(values, engines[1:])}}
        for v, (n_ok, n) in res.items():
            if abs(v) <= gate and n_ok < n:
                all_ok = False
    return out, all_ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="rows cox_dqpsk, cox_qam16, nvis_qam256")
    ap.add_argument("--rows", default=None)
    ap.add_argument("--ppm", default="0,20,-20,50,-50,100,-100")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from projectultra_tpu_torch.device import card_line, resolve

    device = resolve("cpu" if args.cpu else None)
    card = card_line(device)
    table = rows(device)
    sel = (args.rows.split(",") if args.rows
           else ["cox_dqpsk", "cox_qam16", "nvis_qam256"] if args.quick
           else list(table))
    ppm_list = [int(p) for p in args.ppm.split(",")]

    t0 = time.perf_counter()
    print(f"{'row':<36} {'ppm':>8} {'decoded'}  on {card}", flush=True)
    out, all_ok = run_matrix(table, sel, ppm_list, args.frames, 100, "ppm")
    print("SRO gate (|ppm| <= 100):", "PASS" if all_ok else "FAIL")
    print(json.dumps({"gate": all_ok, "rows": out, "frames": args.frames,
                      "wall_seconds": time.perf_counter() - t0,
                      "device": card}))
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())

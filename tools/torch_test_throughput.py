#!/usr/bin/env python3
"""Over-the-air throughput per (waveform, modulation, rate) on the
PyTorch/CUDA port (``tools/test_throughput.py`` runs the same 15 rows on
the JAX package; reference tools/test_throughput.cpp).

bps = payload bits / audio seconds for a representative multi-codeword
frame (``--codewords``, default 8), beside the theoretical symbol-rate
throughput.  Each row's decode is verified at its SNR through the real
sync path: the chirp rows through ``sync/chirp`` and the presynced
demodulator, the Schmidl-Cox rows through ``decode_ofdm_cox`` one lane
at a time (each a B = 1 window-kernel launch on the card); fading rows
average 8 Watterson realizations (``good``) and take the per-codeword
union of the standard pass and the delay-domain model pass
(``ofdm/delay_fit.py``), like the engine's failed-decode ladder.  Decode
is bit-exact per codeword (ok and every info bit right): R3/4 and R5/6
leave info bits parity-free, so an ok flag alone can pass wrong bits.

The channel is one function, ``channel``: Watterson fading from a
``torch.Generator`` seeded 3, then AWGN from one seeded 2 (the JAX tool's
keys 3 and 2).  The last line is the result as one JSON object; the exit
code is 0, as the JAX tool's.  Runs on the card unless ``--cpu``.

    python3 tools/torch_test_throughput.py [--codewords 8] [--cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

LEAD, TAIL = 7200, 1152


def rows():
    """(label, config, modulation, rate, SNR dB, sync[, channel]) per row:
    BASELINE.md's link-throughput table row for row, then the rows beyond
    the reference's table."""
    from projectultra_tpu_torch.config import (CodeRate, ModemConfig,
                                               Modulation, high_throughput,
                                               nvis_mode)
    from projectultra_tpu_torch.ofdm import pipeline as P
    M, R = Modulation, CodeRate
    return [
        ("OFDM 512 DQPSK R1/4", P.chirp_ofdm_config(), M.DQPSK, R.R1_4, 17.0, "chirp"),
        ("OFDM 512 DQPSK R1/2", P.chirp_ofdm_config(), M.DQPSK, R.R1_2, 25.0, "chirp"),
        ("OFDM 512 DQPSK R2/3", P.chirp_ofdm_config(), M.DQPSK, R.R2_3, 30.0, "chirp"),
        ("OFDM 512 16QAM R2/3 (pilots)", ModemConfig(), M.QAM16, R.R2_3, 25.0, "cox"),
        ("OFDM 512 16QAM R3/4 (pilots)", ModemConfig(), M.QAM16, R.R3_4, 25.0, "cox"),
        ("OFDM 512 16QAM R5/6 (pilots)", ModemConfig(), M.QAM16, R.R5_6, 28.0, "cox"),
        ("NVIS 1024 DQPSK R3/4", nvis_mode(), M.DQPSK, R.R3_4, 25.0, "cox"),
        ("NVIS 1024 D8PSK R3/4", nvis_mode(), M.D8PSK, R.R3_4, 25.0, "cox"),
        ("NVIS 1024 16QAM R3/4", nvis_mode(), M.QAM16, R.R3_4, 30.0, "cox"),
        ("NVIS 1024 32QAM R3/4", nvis_mode(), M.QAM32, R.R3_4, 30.0, "cox"),
        ("high_throughput 64QAM R3/4 AWGN25", high_throughput(), M.QAM64, R.R3_4, 25.0, "cox"),
        ("high_throughput 16QAM R2/3 Good20", high_throughput(), M.QAM16, R.R2_3, 20.0, "cox", "good"),
        ("NVIS 1024 64QAM R3/4 (beyond-ref)", nvis_mode(), M.QAM64, R.R3_4, 33.0, "cox"),
        ("NVIS 1024 64QAM R5/6 (beyond-ref)", nvis_mode(), M.QAM64, R.R5_6, 36.0, "cox"),
        ("NVIS 1024 256QAM R5/6 (beyond-ref)", nvis_mode(), M.QAM256, R.R5_6, 42.0, "cox"),
    ]


def channel(tx, chan, snr_db):
    """The row's channel on [reps, T] TX samples: ``good`` Watterson fading
    (generator seeded 3) for the fading row, then harness AWGN at
    ``snr_db`` (generator seeded 2)."""
    import torch
    from projectultra_tpu_torch.sim import watterson as W
    dev = tx.device
    if chan == "good":
        tx = W.watterson(tx, W.good(),
                         torch.Generator(device=dev).manual_seed(3))
    return W.add_noise_active(tx, snr_db,
                              torch.Generator(device=dev).manual_seed(2))


def _delayfit_llrs(cfg, mod, rx, lanes, S, n_bits, front):
    """The delay-domain model pass over each lane's detected span."""
    import torch
    from projectultra_tpu_torch.ofdm import delay_fit as DF
    plen = cfg.fft_size + cfg.cyclic_prefix
    out = []
    for i, (_, det) in enumerate(lanes):
        start_lts = int(det["lts_start"][0])
        end = start_lts + 2 * plen + S * cfg.symbol_duration
        avail_l, avail_t = start_lts, rx.shape[-1] - end
        lead = (2 * plen if avail_l >= 2 * plen
                else plen if avail_l >= plen else 0)
        tail = (2 * plen if avail_t >= 2 * plen
                else plen if avail_t >= plen else 0)
        sp = rx[i:i + 1, start_lts - lead:end + tail]
        out.append(DF.demodulate_span_delayfit(
            cfg, mod, sp, det["cfo_hz"], 0.0, n_lts=2, S=S, lead=lead,
            tail=tail, front=front, n_bits=n_bits))
    return torch.cat(out)


def run_row(row, ncw, device):
    """One row: the frame built from ``numpy.random.default_rng(1)``, its
    channel, sync, demodulation and bit-exact decode.  Returns a dict with
    the table's numbers and the per-codeword verdicts ``ok``."""
    import numpy as np
    import torch
    from projectultra_tpu_torch.config import bits_per_symbol
    from projectultra_tpu_torch.fec import ldpc
    from projectultra_tpu_torch.fec.interleave import channel_interleaver
    from projectultra_tpu_torch.ofdm import carriers as C
    from projectultra_tpu_torch.ofdm import demodulator as D
    from projectultra_tpu_torch.ofdm import modulator as M
    from projectultra_tpu_torch.ofdm import pipeline as P
    from projectultra_tpu_torch.ops import ldpc as ldpc_ops
    from projectultra_tpu_torch.sync import chirp as chirp_mod
    from projectultra_tpu_torch.sync import schmidl_cox as SC

    label, cfg, mod, rate, snr, sync = row[:6]
    chan = row[6] if len(row) > 6 else "awgn"
    t0 = time.perf_counter()
    code = ldpc.get_code(rate)
    payload_bits = code.k * ncw
    rng = np.random.default_rng(1)
    info = rng.integers(0, 2, (1, ncw, code.k)).astype(np.float32)
    cw = ldpc_ops.encode(code, torch.from_numpy(
        info.reshape(ncw, -1)).to(device)).cpu().numpy()
    cm = C.carrier_map(cfg)
    ci = channel_interleaver(len(cm.data_idx) * bits_per_symbol(mod), code.n)
    inter = cw[:, ci.inv].reshape(1, -1)

    if sync == "chirp":
        cc = chirp_mod.ChirpConfig()
        pre = np.concatenate([chirp_mod.generate(cc),
                              M.generate_training(cfg, 2)])
        t_off = 2 * cfg.symbol_duration
    else:
        pre = M.generate_preamble(cfg)
        t_off = M.preamble_data_t_offset(cfg)
    data = M.modulate(cfg, mod, torch.from_numpy(inter).to(device),
                      t_offset=t_off)[0].cpu().numpy()
    audio_len = LEAD + len(pre) + len(data) + TAIL
    audio_s = audio_len / cfg.sample_rate
    bps = payload_bits / audio_s

    tx = np.zeros(audio_len, np.float32)
    tx[LEAD:LEAD + len(pre)] = pre
    tx[LEAD + len(pre):LEAD + len(pre) + len(data)] = data
    # Fading rows average 8 realizations (the batch axis).
    reps = 8 if chan != "awgn" else 1
    rx = channel(torch.from_numpy(tx).to(device)[None].expand(
        reps, -1).contiguous(), chan, snr)
    S = P.num_data_symbols(cfg, mod, ncw)
    llrs_df = None
    if sync == "chirp":
        det = chirp_mod.detect_dual_chirp(cc, rx, 0.15)
        start = int(chirp_mod.training_start(cc, det["down_chirp_start"])[0])
        span = rx[:, start:start + (2 + S) * cfg.symbol_duration]
        phase = chirp_mod.initial_cfo_phase(
            cc, det["cfo_hz"], torch.tensor([start], dtype=torch.int32,
                                            device=device))
        llrs, _ = D.demodulate_presynced(cfg, mod, span, det["cfo_hz"],
                                         phase, 2, S)
    else:
        # Per-realization sync: fading shifts each lane's fine timing, and
        # decode_ofdm_cox shares one data start, so one lane at a time.
        # Pilot plans use the real front at the rows' zero CFO (the
        # engine's front pick).
        front = "real" if len(cm.pilot_idx) else "analytic"
        lanes = [SC.decode_ofdm_cox(cfg, mod, rx[i:i + 1], ncw, front=front)
                 for i in range(rx.shape[0])]
        llrs = torch.cat([l for l, _ in lanes])
        if chan != "awgn" and len(cm.pilot_idx):
            llrs_df = _delayfit_llrs(cfg, mod, rx, lanes, S, ncw * code.n,
                                     front)
    exp = np.broadcast_to(info.reshape(1, ncw, code.k),
                          (reps, ncw, code.k)).reshape(-1, code.k)

    def exact(l):
        blocks = l.cpu().numpy()[:, :ncw * code.n].reshape(reps * ncw, code.n)
        out, ok, _ = ldpc_ops.decode(code, torch.from_numpy(
            np.ascontiguousarray(blocks[:, ci.perm])).to(device),
            trap_escape=True)
        return ok.cpu().numpy() & (out.cpu().numpy()
                                   == exp.astype(np.uint8)).all(-1)

    okv = exact(llrs)
    if llrs_df is not None:
        okv |= exact(llrs_df)
    return {"label": label, "payload_bytes": payload_bits // 8,
            "audio_s": audio_s, "bps": bps,
            "theory": cfg.theoretical_throughput(mod, rate),
            "decode": float(okv.mean()), "ok": okv.tolist(),
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--codewords", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from projectultra_tpu_torch.device import card_line, resolve

    device = resolve("cpu" if args.cpu else None)
    card = card_line(device)
    t0 = time.perf_counter()
    print(f"{'mode':<32} {'payload':>8} {'audio_s':>8} {'bps':>7} "
          f"{'theory':>7} {'decode':>7}  on {card}", flush=True)
    out = []
    for i, row in enumerate(rows()):
        r = run_row(row, args.codewords, device)
        out.append(r | {"index": i})
        print(f"{r['label']:<32} {r['payload_bytes']:>7}B "
              f"{r['audio_s']:>7.2f}s {r['bps']:>7.0f} {r['theory']:>7.0f} "
              f"{r['decode']:>6.0%}", flush=True)
    print(json.dumps({"codewords": args.codewords, "rows": out,
                      "wall_seconds": time.perf_counter() - t0,
                      "device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

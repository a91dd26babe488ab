#!/usr/bin/env python3
"""Mid-session interferer onset on the PyTorch/CUDA port: time-to-notch
and message cost (``tools/test_interferer_onset.py`` runs the same trial
on the JAX package).

A CW interferer switches ON in the middle of an active ARQ transfer, so
every post-onset window reads above the exciser's stale pre-onset floor
and its quiet gate blocks learning until the floor re-anchors.  The
exciser's bounded floor step-up (``modem/excision.py`` FLOOR_STEP_*) and
its comb-rejection gate (>= 3 simultaneous lines are the frames' own
spectrum, never learned) bound the reaction.

Two ``ProtocolEngine`` stations on the run's device keep the audio and
protocol clocks aligned (0.1 s of fed air per 100 ms tick) and hear
continuous inter-burst band noise (plus the tone once ON), drawn from
``numpy.random.default_rng(seed)`` as the JAX tool draws it.

Gate at SIR >= 3 dB: the notch within 10 s of interferer-lit air, every
message delivered in order, no false tones, the session connected.  The
last line is the result as one JSON object.  Runs on the card unless
``--cpu``.

    python3 tools/torch_test_interferer_onset.py [--sir 10,5,0]
        [--tone 1850] [--msgs 10] [--cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def run_onset(sir_db: float, tone_hz: float = 1850.0, n_msgs: int = 10,
              seed: int = 17, max_iters: int = 1500, verbose: bool = True,
              device=None):
    """One mid-session onset trial on ``device`` (the card when None).
    Returns (react_s, delivered, n_msgs, retransmissions, false_tones,
    connected)."""
    import numpy as np
    from projectultra_tpu_torch.device import resolve
    from projectultra_tpu_torch.protocol.engine import ProtocolEngine

    device = resolve(device)
    rng = np.random.default_rng(seed)
    state = {"on": False, "sig_p": None, "n_a": 0, "n_b": 0, "fed_b": 0,
             "notch_at": None}

    def air(n, key):
        noise_p = (state["sig_p"] or 1e-4) / 10 ** (20.0 / 10.0)
        x = rng.normal(0, np.sqrt(noise_p), n).astype(np.float32)
        if state["on"]:
            tone_p = state["sig_p"] / 10 ** (sir_db / 10.0)
            t = (state[key] + np.arange(n)) / 48000.0
            x += np.sqrt(2 * tone_p) * np.sin(
                2 * np.pi * tone_hz * t).astype(np.float32)
        state[key] += n
        return x

    def channel(audio, key):
        if state["sig_p"] is None:
            state["sig_p"] = float(np.mean(audio ** 2))
        return np.concatenate([audio + air(len(audio), key),
                               air(4000, key)])

    a = ProtocolEngine(device=device)
    b = ProtocolEngine(device=device)
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(20.0)

    def feed_b(x):
        state["fed_b"] += len(x)
        if state["on"] and state["notch_at"] is None \
                and b.modem.exciser.active_tones:
            state["notch_at"] = state["fed_b"]
        b.feed_audio(x)

    a.on_tx_audio = lambda audio: feed_b(channel(audio, "n_b"))
    b.on_tx_audio = lambda audio: a.feed_audio(channel(audio, "n_a"))
    got_b = []
    b.connection.on_message_received = got_b.append

    if not a.connect("VE3ABC"):
        return None, 0, n_msgs, 0, [], False
    a.connection.arq.config.ack_timeout_ms = 8000

    sent, onset_fed = 0, None
    false_tones = set()
    for _ in range(max_iters):
        if sent < n_msgs and a.send_message(f"onset-{sent:02d}"):
            sent += 1
        feed_b(air(4800, "n_b"))
        a.feed_audio(air(4800, "n_a"))
        a.tick(100)
        b.tick(100)
        for f0 in b.modem.exciser.active_tones:
            if abs(f0 - tone_hz) > 15.0:
                false_tones.add(round(f0, 1))
        if not state["on"] and len(got_b) >= min(4, n_msgs // 2):
            state["on"] = True
            onset_fed = state["fed_b"]
        if sent >= n_msgs and len(got_b) >= n_msgs:
            break

    react = ((state["notch_at"] - onset_fed) / 48000.0
             if state["notch_at"] is not None and onset_fed is not None
             else None)
    ok = got_b == [f"onset-{i:02d}" for i in range(n_msgs)]
    retx = a.connection.arq.stats.retransmissions
    conn = a.connection.is_connected and b.connection.is_connected
    if verbose:
        rs = f"{react:.1f}s" if react is not None else "never"
        print(f"  SIR {sir_db:>4.0f} dB @ {tone_hz:.0f} Hz: "
              f"time-to-notch {rs:>6}, delivered {len(got_b)}/{n_msgs} "
              f"(in order: {ok}), retx {retx}, "
              f"false tones {sorted(false_tones) or 'none'}, "
              f"connected {conn}", flush=True)
    return react, len(got_b) if ok else 0, n_msgs, retx, \
        sorted(false_tones), conn


def onset_ok(react, got, n, false_tones, conn) -> bool:
    """The gate of one SIR >= 3 dB trial (tools/test_interferer_onset.py)."""
    return (got == n and react is not None and react <= 10.0
            and not false_tones and conn)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sir", default="10,5,0")
    ap.add_argument("--tone", type=float, default=1850.0)
    ap.add_argument("--msgs", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from projectultra_tpu_torch.device import card_line, resolve

    device = resolve("cpu" if args.cpu else None)
    card = card_line(device)
    t0 = time.perf_counter()
    print(f"mid-session CW onset during an active ARQ transfer, on {card}:",
          flush=True)
    all_ok, trials = True, []
    for sir in [float(s) for s in args.sir.split(",")]:
        react, got, n, retx, false_tones, conn = run_onset(
            sir, args.tone, args.msgs, device=device)
        # Gate at SIR >= 3; SIR 0 (the interferer as loud as the signal)
        # stays an informational row, as in the JAX tool.
        if sir >= 3.0 and not onset_ok(react, got, n, false_tones, conn):
            all_ok = False
        trials.append({"sir_db": sir, "react_s": react, "delivered": got,
                       "messages": n, "retransmissions": retx,
                       "false_tones": false_tones, "connected": conn})
    print("onset gate (SIR >= 3: notch <= 10 s, all messages, "
          "no false tones):", "PASS" if all_ok else "FAIL")
    print(json.dumps({"gate": all_ok, "trials": trials,
                      "wall_seconds": time.perf_counter() - t0,
                      "device": card}))
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())

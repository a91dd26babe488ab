#!/usr/bin/env python3
"""Threaded two-station protocol simulator on the PyTorch/CUDA port
(``tools/threaded_simulator.py`` runs the same session on the JAX package;
reference tools/threaded_simulator.cpp).

Two full stations with the audio path and decoding on separate threads,
the concurrency the GUI runs (audio callback thread against decode
threads):

  * each station is a ``ProtocolEngine`` with an ``AudioEngine`` over the
    native lock-free ring (``LoopbackBackend``);
  * one air thread pumps both audio engines (A's speaker -> channel -> B's
    mic and back, in 1,024-sample buffers), the channel's AWGN drawn on the
    run's device from a ``torch.Generator``;
  * one decode thread per station polls its modem and ticks its protocol;
  * the main thread drives connect, a message each way and disconnect,
    each with a timeout.

Polls run on the decode threads themselves, on PyTorch's current stream of
the device.  Every call into a station -- the air thread's ``feed_audio``,
its decode thread's poll and tick, the main thread's connect, send and
disconnect -- holds that station's lock.  The engine locks only its RX
buffer: a poll also updates the exciser (``_excision_rx_hints``) that
``feed_audio`` runs on the air thread, and unserialised runs lost frames
to ARQ timeouts; the main and decode threads both transmit through the
station's ``AudioEngine`` ring, which takes one producer at a time.  An
exception on any thread stops the run, is printed with its traceback, and
the tool exits 1.  The last line is the result as one JSON
object.  Runs on the card unless ``--cpu``.

    python3 tools/torch_threaded_simulator.py [--snr 15] [--timeout 600]
        [--cpu]
"""

import argparse
import json
import os
import sys
import threading
import time
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--snr", type=float, default=15.0)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from projectultra_tpu_torch.device import card_line, resolve
    from projectultra_tpu_torch.modem.audio import AudioEngine, LoopbackBackend
    from projectultra_tpu_torch.protocol.engine import ProtocolEngine
    from projectultra_tpu_torch.sim import watterson as W

    device = resolve("cpu" if args.cpu else None)

    card = card_line(device)
    if device.type == "cuda":
        torch.cuda.init()  # from the main thread, before any worker runs

    def channel(audio: np.ndarray) -> np.ndarray:
        a = torch.from_numpy(np.concatenate(
            [np.zeros(2000, np.float32), audio,
             np.zeros(4000, np.float32)])[None, :]).to(device)
        g = torch.Generator(device=device).manual_seed(len(audio) & 0xFFFF)
        return W.add_noise_active(a, args.snr, g)[0].cpu().numpy()

    a = ProtocolEngine(device=device)
    b = ProtocolEngine(device=device)
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(args.snr)

    station_lock = {"a": threading.Lock(), "b": threading.Lock()}

    def mic(name, engine):
        def feed(chunk):
            with station_lock[name]:
                engine.modem.feed_audio(chunk)
        return feed

    # A's speaker is B's mic and vice versa.
    a_air = AudioEngine(LoopbackBackend(channel=channel))
    b_air = AudioEngine(LoopbackBackend(channel=channel))
    a.on_tx_audio = a_air.play
    b.on_tx_audio = b_air.play
    a_air.set_rx_callback(mic("b", b))
    b_air.set_rx_callback(mic("a", a))

    stop = threading.Event()
    errors: list[str] = []
    got_b, got_a = [], []
    b.connection.on_message_received = got_b.append
    a.connection.on_message_received = got_a.append
    polls = {"a": 0, "b": 0}

    def guarded(body):
        """Run body until stop; an exception is recorded and stops all."""
        def loop():
            try:
                while not stop.is_set():
                    body()
            except Exception:
                errors.append(f"{threading.current_thread().name}:\n"
                              f"{traceback.format_exc()}")
                stop.set()
        return loop

    def air():
        a_air.pump()
        b_air.pump()
        time.sleep(0.005)

    def decoder(name, engine):
        def body():
            with station_lock[name]:
                engine.modem.poll()
                engine.tick(20)
            polls[name] += 1
            time.sleep(0.02)
        return body

    threads = [threading.Thread(target=guarded(air), name="air", daemon=True),
               threading.Thread(target=guarded(decoder("a", a)),
                                name="decode-a", daemon=True),
               threading.Thread(target=guarded(decoder("b", b)),
                                name="decode-b", daemon=True)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()

    def wait_for(cond, what, timeout):
        t0 = time.time()
        while time.time() - t0 < timeout and not stop.is_set():
            time.sleep(0.05)
            if cond():
                print(f"  [ok] {what} ({time.time() - t0:.1f}s)", flush=True)
                return True
        print(f"  [{'ERROR' if errors else 'TIMEOUT'}] {what}", flush=True)
        return False

    ok = True
    print(f"threaded two-station simulator: SNR {args.snr:.0f} dB on "
          f"{card}", flush=True)
    try:
        print("[1] A connects to B", flush=True)
        with station_lock["a"]:
            a.connect("VE3ABC")
        ok &= wait_for(lambda: a.connection.is_connected
                       and b.connection.is_connected, "connected",
                       args.timeout / 2)
        if ok:
            print("[2] messages both ways", flush=True)
            with station_lock["a"]:
                a.send_message("hello from A")
            ok &= wait_for(lambda: "hello from A" in got_b, "A->B message",
                           args.timeout / 4)
            with station_lock["b"]:
                b.send_message("hello from B")
            ok &= wait_for(lambda: "hello from B" in got_a, "B->A message",
                           args.timeout / 4)
        if ok:
            print("[3] disconnect", flush=True)
            with station_lock["a"]:
                a.disconnect()
            ok &= wait_for(lambda: not b.connection.is_connected,
                           "B saw disconnect", args.timeout / 4)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    wall = time.perf_counter() - t_start
    alive = [t.name for t in threads if t.is_alive()]
    for err in errors:
        print(f"thread failed: {err}", flush=True)
    if alive:
        print(f"threads still running after the join: {alive}", flush=True)
    ok = ok and not errors and not alive
    print(f"RESULT: {'PASS' if ok else 'FAIL'}", flush=True)
    arq = {k: {"retransmissions": e.connection.arq.stats.retransmissions,
               "timeouts": e.connection.arq.stats.timeouts}
           for k, e in (("a", a), ("b", b))}
    print(json.dumps({"ok": ok, "messages": {"a": got_a, "b": got_b},
                      "errors": len(errors), "polls": polls, "arq": arq,
                      "frames_received": [a.modem.stats.frames_received,
                                          b.modem.stats.frames_received],
                      "wall_seconds": wall, "device": card}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

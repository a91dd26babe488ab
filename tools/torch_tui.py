#!/usr/bin/env python3
"""Terminal UI on the PyTorch/CUDA port: the reference GUI's panels
rendered as ANSI text (``tools/tui.py`` renders the same panels from the
JAX package; reference src/gui/, the ImGui App's waterfall,
constellation, status bar, message console and ``-sim`` virtual remote
station).

The panels render from the port's data products
(``utils/observability``): the waterfall (2048-point FFT, 0-3 kHz, an
ASCII intensity ramp; the FFT runs on the audio's device), the status
(connection state, negotiated waveform, data mode, SNR, frames sent and
received) and the console (messages received and sent).

``--sim`` runs the GUI's virtual-remote-station mode: two port
``ProtocolEngine`` stations, W1AW and VE3ABC, on the run's device, each
transmission handed to the other through ``channel`` (2,000 samples of
lead, 4,000 of tail, then ``add_noise_active`` at ``--snr`` from a
``torch.Generator`` seeded from the transmission's length, as the JAX
tool keys its noise); scripted connect -> chat both ways -> disconnect,
the dashboard printed after each step, then ``RESULT: PASS|FAIL`` and one
JSON object (result, wall seconds, each kernel's launches).  Exit 0 on
PASS, 1 on FAIL; without ``--sim`` it prints why and returns 2.  Runs on
the card unless ``--cpu``.

    python3 tools/torch_tui.py --sim [--cpu] [--snr DB]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

RAMP = " .:-=+*#%@"
LEAD, TAIL = 2000, 4000


def render_waterfall(audio, width=64, lines=12):
    """The last ``lines`` waterfall rows of ``audio`` (numpy or a tensor)
    over 0-3 kHz, normalized over the window, as ``RAMP`` characters."""
    import numpy as np
    from projectultra_tpu_torch.utils.observability import waterfall
    if audio is None or len(audio) < 4096:
        return ["(no audio yet)"]
    db, freqs = waterfall(audio)
    keep = freqs <= 3000.0
    db = db[-lines:, keep]
    lo, hi = db.min(), max(db.max(), db.min() + 1e-6)
    norm = (db - lo) / (hi - lo)
    cols = np.linspace(0, norm.shape[1] - 1, width).astype(int)
    out = []
    for row in norm[:, cols]:
        out.append("".join(RAMP[int(v * (len(RAMP) - 1))] for v in row))
    return out


def render_constellation(points, size=17):
    import numpy as np
    if points is None or len(points) == 0:
        return []
    from projectultra_tpu_torch.utils.observability import constellation
    iq = constellation(points)
    lim = max(1e-6, float(np.abs(iq).max())) * 1.1
    grid = [[" "] * (2 * size + 1) for _ in range(size + 1)]
    for re, im in iq:
        x = int((re / lim + 1) * size)
        y = int((1 - im / lim) * size / 2)
        if 0 <= y <= size and 0 <= x <= 2 * size:
            grid[y][x] = "o"
    mid = size // 2
    for y in range(size + 1):
        if grid[y][size] == " ":
            grid[y][size] = "|" if y != mid else "+"
    return ["".join(row) for row in grid]


def render_dashboard(title, station, last_audio, messages):
    c = station.connection
    m = station.modem
    lines = [f"== {title} " + "=" * max(0, 60 - len(title)),
             f" state: {c.state.name:<13} remote: {c.remote_call or '-':<10}"
             f" waveform: {c.negotiated_mode.name if c.is_connected else '-'}",
             f" mode: {m.data_modulation.name} "
             f"{m.data_code_rate.name[1:].replace('_', '/')}"
             f"   snr: {m.stats.current_snr_db:5.1f} dB"
             f"   tx/rx frames: {m.stats.frames_sent}/{m.stats.frames_received}"
             f"   pings: {m.pings_received}",
             " waterfall (0-3 kHz):"]
    lines += ["   " + w for w in render_waterfall(last_audio)]
    cpts = render_constellation(m.last_constellation)
    if cpts:
        lines.append(" constellation (equalized):")
        lines += ["   " + c for c in cpts]
    lines.append(" console:")
    lines += [f"   {t}" for t in messages[-4:]] or ["   (empty)"]
    return "\n".join(lines)


def channel(audio, snr_db, device):
    """The air between the stations: ``audio`` (numpy) with its lead and
    tail, through ``add_noise_active`` on ``device``; returns numpy."""
    import numpy as np
    import torch
    from projectultra_tpu_torch.sim import watterson as W
    x = torch.from_numpy(np.concatenate(
        [np.zeros(LEAD, np.float32), audio,
         np.zeros(TAIL, np.float32)])[None, :]).to(device)
    g = W.seeded_generator(device, len(audio) & 0xFFFF)
    return W.add_noise_active(x, snr_db, g)[0].cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sim", action="store_true",
                    help="virtual remote station (GUI -sim mode)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--snr", type=float, default=15.0)
    args = ap.parse_args(argv)
    if not args.sim:
        print("interactive radio mode needs audio hardware; run with --sim")
        return 2

    import torch
    from projectultra_tpu_torch.device import card_line, resolve
    from projectultra_tpu_torch.ops import cuda_ldpc, cuda_sc
    from projectultra_tpu_torch.protocol.engine import ProtocolEngine

    device = resolve("cpu" if args.cpu else None)
    card = card_line(device)
    launches0 = (cuda_ldpc.launches, cuda_sc.launches)
    t0 = time.perf_counter()

    a, b = ProtocolEngine(device=device), ProtocolEngine(device=device)
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(args.snr)
    a.modem.collect_constellation = True
    b.modem.collect_constellation = True

    last_rx = {"a": None, "b": None}
    console = []

    def a_to_b(audio):
        rx = channel(audio, args.snr, device)
        last_rx["b"] = rx
        b.feed_audio(rx)

    def b_to_a(audio):
        rx = channel(audio, args.snr, device)
        # The waterfall of what the local station heard, on the run's device.
        last_rx["a"] = torch.from_numpy(rx).to(device)
        a.feed_audio(rx)

    a.on_tx_audio = a_to_b
    b.on_tx_audio = b_to_a
    a.connection.on_message_received = \
        lambda t: console.append(f"VE3ABC> {t}")
    b_console = []
    b.connection.on_message_received = \
        lambda t: b_console.append(f"W1AW> {t}")

    def show(step):
        print(f"\n--- {step} " + "-" * max(0, 50 - len(step)))
        print(render_dashboard("W1AW (local)", a, last_rx["a"], console))

    ok = True
    show("startup")
    ok &= a.connect("VE3ABC")
    ok &= a.connection.is_connected and b.connection.is_connected
    show("connected")
    console.append("me> hello remote")
    ok &= a.send_message("hello remote")
    ok &= b.send_message("hello local") if ok else False
    show("chat")
    a.disconnect()
    show("disconnected")
    good = ok and "VE3ABC> hello local" in console \
        and "W1AW> hello remote" in b_console \
        and not b.connection.is_connected
    result = "PASS" if good else "FAIL"
    print(f"\nRESULT: {result}")
    print(json.dumps({
        "result": result, "wall_seconds": time.perf_counter() - t0,
        "launches": {"ldpc_minsum": cuda_ldpc.launches - launches0[0],
                     "sc_windows": cuda_sc.launches - launches0[1]},
        "device": card}))
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())

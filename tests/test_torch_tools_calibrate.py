"""The port's calibration tools against the JAX tools on the CPU, on the
air JAX drew: ``tools/torch_calibrate_snr.py`` and
``tools/torch_calibrate_mode_table.py`` against ``tools/calibrate_snr.py``
and ``tools/calibrate_mode_table.py``, at one trial a point.

Each JAX tool's ``main`` runs first (it pins JAX to the CPU itself) with
its channel recorded and every RX engine's decoded frames recorded per
poll; the twin's ``main`` then runs with its ``channel`` replaying JAX's
air (tests/test_torch_tools_session.py's ``replay_air``: the twin's TX
audio within 2e-4 of JAX's; a single-carrier DPSK DATA frame, 32 s long,
within 0.8 * 2**-10, one float32 ulp of its accumulated symbol phase,
which passes 8,192 rad, at the 0.8 peak -- both packages accumulate it
in float32 in different orders, and the gap grows along the frame in
those ulp steps) and its frames recorded alike.  Held: the
frames of every poll byte for byte, each frame's legacy and wideband SNR
estimates within 1e-3 dB, the printed decode counts, and each
(waveform, channel) pair's least-squares fit within 1e-3 of the fit of
JAX's estimates.  ``calibrate_snr`` runs its whole grid (3 waveforms x 2
channels x 7 SNRs); ``calibrate_mode_table`` the MC_DPSK and DPSK floors
and the OFDM_COX DQPSK R1/2 row (``--only``), a row per waveform.
"""

import os

for _flag in ("ULTRA_CHIRP_BF16", "ULTRA_LDPC_BF16", "ULTRA_EXCISION",
              "ULTRA_BLANKER"):
    os.environ.pop(_flag, None)

import json  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

import jax  # noqa: E402,F401

from projectultra_tpu.modem import engine as JE  # noqa: E402

from projectultra_tpu_torch.modem import engine as TE  # noqa: E402

from test_torch_tools_batch import run_jax, tool  # noqa: E402
from test_torch_tools_session import TX_TOL, replay_air  # noqa: E402

SNR_TOL = 1e-3
DPSK_DATA_TX_TOL = 0.8 * 2.0 ** -10
LONG_FRAME = 10 * 48000     # only single-carrier DPSK frames are longer


def tx_tol(audio):
    return DPSK_DATA_TX_TOL if len(audio) > LONG_FRAME else TX_TOL


def record_frames(monkeypatch, module):
    """Replace ``module.ModemEngine`` by a subclass whose every poll
    records the frames it delivers; returns the list of per-poll lists."""
    polls = []
    base = module.ModemEngine

    class Recording(base):
        def poll(self):
            user, got = self.on_frame, []

            def deliver(frame):
                got.append(frame)
                if user is not None:
                    user(frame)

            self.on_frame = deliver
            try:
                return super().poll()
            finally:
                self.on_frame = user
                polls.append(got)

    monkeypatch.setattr(module, "ModemEngine", Recording)
    return polls


def same_polls(ours, ref):
    assert len(ours) == len(ref) > 0
    for got, want in zip(ours, ref):
        assert [f.frame_bytes for f in got] == [f.frame_bytes for f in want]
        for f, j in zip(got, want):
            assert abs(f.snr_db - j.snr_db) <= SNR_TOL
            assert abs(f.wideband_snr_db - j.wideband_snr_db) <= SNR_TOL


def _run_both(name, argv, monkeypatch, capsys):
    jpolls = record_frames(monkeypatch, JE)
    rc, jout, rec = run_jax(name, argv, monkeypatch, capsys, cpu=False)
    assert rc in (0, None)
    twin = tool(f"torch_{name}")
    polls = record_frames(monkeypatch, TE)
    left = replay_air(twin, rec, tx_tol)
    assert twin.main(["--cpu", *argv]) == 0
    out = capsys.readouterr().out
    assert left == []
    same_polls(polls, jpolls)
    return jout, out, json.loads(out.strip().splitlines()[-1]), jpolls


def test_calibrate_snr_matches_jax(monkeypatch, capsys):
    jout, out, res, jpolls = _run_both("calibrate_snr", ["--trials", "1"],
                                       monkeypatch, capsys)
    twin = tool("torch_calibrate_snr")
    # One RX poll a point, in the JAX tool's order (waveform, channel, SNR).
    points = iter(jpolls)
    for pair in res["pairs"]:
        xs, ys = [], []
        for p in pair["points"]:
            frames = next(points)
            assert len(p["est"]) == len(frames)
            for est, wb, f in zip(p["est"], p["wideband"], frames):
                assert abs(est - f.snr_db) <= SNR_TOL
                assert abs(wb - f.wideband_snr_db) <= SNR_TOL
                xs.append(p["true_db"])
                ys.append(f.snr_db)
        if len(set(xs)) >= 3:
            np.testing.assert_allclose(pair["fit"], twin.fit(xs, ys),
                                       rtol=0, atol=SNR_TOL)
        else:
            assert pair["fit"] is None
    assert len(res["pairs"]) == 6
    # Which points decoded: the "no decode" lines and the fits' pairs.
    def marks(text):
        return [l for l in text.splitlines() if "no decode" in l or "===" in l]

    assert marks(out) == marks(jout)


@pytest.mark.parametrize("only", ["DPSK DQPSK R1_4", "OFDM_COX DQPSK R1_2"])
def test_calibrate_mode_table_matches_jax(only, monkeypatch, capsys):
    argv = ["--trials", "1", "--only", only]
    jout, out, res, _ = _run_both("calibrate_mode_table", argv, monkeypatch,
                                  capsys)
    rows = [l for l in out.splitlines() if "dB=" in l]
    assert rows == [l for l in jout.splitlines() if "dB=" in l]
    assert len(rows) == len(res["rows"]) == (4 if only.startswith("DPSK")
                                             else 2)

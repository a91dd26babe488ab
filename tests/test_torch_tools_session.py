"""The port's session-level tools against the JAX tools on the CPU, on the
air JAX drew: ``tools/torch_test_session_throughput.py`` and
``tools/torch_test_calibrated_negotiation.py`` against
``tools/test_session_throughput.py`` and
``tools/test_calibrated_negotiation.py`` (the calibration tools are in
tests/test_torch_tools_calibrate.py).

Each JAX ``run_session`` runs first with
``projectultra_tpu.sim.watterson.add_noise_active`` and ``watterson``
recorded; the twin's ``channel`` then replays JAX's air transmission by
transmission, holding the twin's audio within 2e-4 of JAX's (the golden
TX tolerance).  Modes, deliveries and the kbps (from sample counts) must
be exact.  Sizes: the 512-plan 26 dB session row with a 300-byte file and
11 warm messages each way -- the fewest with which the row still climbs
into the high-order ladder (9 and 10 stay at QAM16 R2/3 on the port's
own noise, 11 reach QAM64 R5/6) -- and the negotiation grid's AWGN 20 dB
point at its default six messages.
"""

import os

for _flag in ("ULTRA_CHIRP_BF16", "ULTRA_LDPC_BF16", "ULTRA_EXCISION",
              "ULTRA_BLANKER"):
    os.environ.pop(_flag, None)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

import jax  # noqa: E402,F401

from projectultra_tpu import config as JC  # noqa: E402
from projectultra_tpu.sim import watterson as JW  # noqa: E402

from test_torch_tools_batch import Recorder, tool  # noqa: E402

CPU = torch.device("cpu")
TX_TOL = 2e-4
TAIL = 4000     # zeros after each transmission in every engine tool


def record_air(monkeypatch):
    rec = Recorder(monkeypatch)
    rec.wrap(JW, "add_noise_active")
    rec.wrap(JW, "watterson")
    return rec


def replay_air(twin, rec, tol=lambda audio: TX_TOL):
    """Replace ``twin.channel`` (audio first, numpy in and out) by JAX's
    recorded air in order, holding the twin's audio to JAX's between the
    leading zeros and the 4,000-sample tail within ``tol(audio)``.
    Returns the records left."""
    queue = list(rec.calls)

    def channel(audio, *args):
        _, inputs, out = queue.pop(0)
        padded = inputs[1][0]
        lead = len(padded) - len(audio) - TAIL
        assert lead in (2000, 2400)
        np.testing.assert_allclose(audio, padded[lead:lead + len(audio)],
                                   rtol=0, atol=tol(audio))
        return np.array(out[0])

    twin.channel = channel
    return queue


def test_session_throughput_row_matches_jax(monkeypatch):
    rec = record_air(monkeypatch)
    ref = tool("test_session_throughput").run_session(
        "512", 26.0, 300, warm_msgs=11)
    twin = tool("torch_test_session_throughput")
    left = replay_air(twin, rec)
    ours = twin.run_session("512", 26.0, 300, warm_msgs=11, device=CPU)
    assert left == []
    assert ours == ref
    mode, steady, session = ours
    assert mode == "QAM64/R5_6"       # climbed past QAM16 R2/3
    assert steady > session > 0


def test_negotiation_point_matches_jax(monkeypatch):
    rec = record_air(monkeypatch)
    JN = tool("test_calibrated_negotiation")
    twin = tool("torch_test_calibrated_negotiation")
    chan, snr, min_rank = twin.grid(True)[4]
    assert (chan, snr, min_rank) == ("awgn", 20.0, None)
    n = twin.messages_for(min_rank, 6)
    ref = JN.run_session(snr, chan, n, True)
    left = replay_air(twin, rec)
    ours = twin.run_session(snr, chan, n, True, device=CPU)
    assert left == []
    assert ours == ref
    assert ours[2], "a message was lost"


def test_negotiation_grid_matches_jax():
    """The twin's 12-point grid, its rank and its climb-row message count
    are the JAX tool's (tools/test_calibrated_negotiation.py:113-125)."""
    twin = tool("torch_test_calibrated_negotiation")
    assert twin.grid(True) == (
        [("awgn", s, None) for s in (5.0, 8.0, 12.0, 16.0, 20.0)]
        + [("fade", s, None) for s in (5.0, 8.0, 12.0, 16.0, 20.0)]
        + [("awgn", 26.0, 3.9), ("awgn", 32.0, 5.2)])
    assert len(twin.grid(False)) == 10
    for m, r in (("QAM64", "R2_3"), ("QAM256", "R2_3"), ("DBPSK", "R1_4"),
                 ("QAM16", "R5_6")):
        assert twin.rank(f"{m}/{r}") == JC.bits_per_symbol(
            JC.Modulation[m]) * JC.code_rate_value(JC.CodeRate[r])
    assert [twin.messages_for(r, 6) for r in (None, 3.9)] == [6, 14]

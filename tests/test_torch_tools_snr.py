"""The port's SNR sweeps and the OTFS comparison against the JAX tools on
the CPU, on the noise JAX drew: ``tools/torch_test_mode_snr.py``,
``torch_test_dpsk_snr.py`` and ``torch_test_otfs_vs_ofdm.py`` against
``tools/test_mode_snr.py``, ``test_dpsk_snr.py`` and
``test_otfs_vs_ofdm.py``, each at one trial a point (the OTFS table at 2)
with every row.  The harness is tests/test_torch_tools_batch.py's: the
JAX tool's ``main`` with its channel recorded, then the twin's ``main``
with its ``channel`` replaying JAX's noisy arrays.  Held:

* each channel's clean input within 2e-4 of JAX's (DPSK 5e-4: the port's
  DPSK modulator accumulates float32 symbol phases in another order, as
  tests/test_torch_dpsk.py states);
* every receive the tools make, in order, lane for lane: the ok flags of
  ``rx_frame`` and of the LDPC decodes with the info bits of every
  decoded lane, and the DPSK preamble search's found flags and data
  starts;
* the printed rates, character for character.
"""

import os

for _flag in ("ULTRA_CHIRP_BF16", "ULTRA_LDPC_BF16", "ULTRA_EXCISION",
              "ULTRA_BLANKER"):
    os.environ.pop(_flag, None)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

import jax  # noqa: E402,F401

from projectultra_tpu.ofdm import pipeline as JP  # noqa: E402
from projectultra_tpu.ops import ldpc as JL  # noqa: E402
from projectultra_tpu.psk import dpsk as JD  # noqa: E402

from projectultra_tpu_torch.ofdm import pipeline as TP  # noqa: E402
from projectultra_tpu_torch.ops import ldpc as TL  # noqa: E402
from projectultra_tpu_torch.psk import dpsk as TD  # noqa: E402

from test_torch_tools_batch import (Recorder, replay, run_jax,  # noqa: E402
                                    run_twin, same_decodes, tool)


def _result_lines(out):
    return [l for l in out.splitlines()
            if l.startswith(("Result:", "SNR:", "---"))]


def test_mode_snr_matches_jax(monkeypatch, capsys):
    rc, jout, rec = run_jax("test_mode_snr", ["--trials", "1"], monkeypatch,
                            capsys, wrap=[(JP, "rx_frame")])
    assert rc == 0
    twin = tool("torch_test_mode_snr")
    ours = Recorder(monkeypatch)
    ours.wrap(TP, "rx_frame")
    left, clean = replay(twin, rec.of("add_noise_active"))
    rc, out, res = run_twin(twin, ["--trials", "1"], capsys)
    assert rc == 0 and left == [] and len(clean) == 4
    same_decodes(ours.of("rx_frame"), rec.of("rx_frame"))
    assert _result_lines(out) == _result_lines(jout)
    for r, (_, _, (_, jok, _)) in zip(res["rows"], rec.of("rx_frame")):
        assert r["ok"] == np.asarray(jok).tolist()
    jsummary = jout.split("=== Summary ===")[1].splitlines()[1:]
    assert out.split("=== Summary ===")[1].splitlines()[1:-1] == jsummary


def test_dpsk_snr_matches_jax(monkeypatch, capsys):
    rc, jout, rec = run_jax("test_dpsk_snr", ["--trials", "1"], monkeypatch,
                            capsys, wrap=[(JL, "decode"),
                                          (JD, "find_preamble")])
    assert rc == 0
    twin = tool("torch_test_dpsk_snr")
    ours = Recorder(monkeypatch)
    ours.wrap(TL, "decode")
    ours.wrap(TD, "find_preamble")
    left, clean = replay(twin, rec.of("add_noise_active"), tol=5e-4)
    rc, out, res = run_twin(twin, ["--trials", "1"], capsys)
    assert rc == 0 and left == [] and len(clean) == 5
    same_decodes(ours.of("decode"), rec.of("decode"))
    for (_, _, o), (_, _, j) in zip(ours.of("find_preamble"),
                                    rec.of("find_preamble"), strict=True):
        np.testing.assert_array_equal(o[0], j[0])      # found
        np.testing.assert_array_equal(o[1], j[1])      # data start
    assert _result_lines(out) == _result_lines(jout)


def test_otfs_vs_ofdm_matches_jax(monkeypatch, capsys):
    rc, jout, rec = run_jax("test_otfs_vs_ofdm", ["--trials", "2"],
                            monkeypatch, capsys,
                            wrap=[(JP, "rx_frame"), (JL, "decode")])
    assert rc == 0
    twin = tool("torch_test_otfs_vs_ofdm")
    ours = Recorder(monkeypatch)
    ours.wrap(TP, "rx_frame")
    ours.wrap(TL, "decode")
    air = [c for c in rec.calls if c[0] in ("add_noise_active", "watterson")]
    left, clean = replay(twin, air)
    rc, out, res = run_twin(twin, ["--trials", "2"], capsys)
    assert rc == 0 and left == [] and len(clean) == 15
    # Per condition: OFDM's rx_frame, then the OTFS-EQ and OTFS-RAW decodes
    # (JAX's rx_frame decodes inside itself, unrecorded).
    decodes = [c for c in ours.calls if c[0] in ("rx_frame", "decode")]
    assert [c[0] for c in decodes] == \
        [c[0] for c in rec.calls if c[0] in ("rx_frame", "decode")]
    same_decodes(decodes, [c for c in rec.calls
                           if c[0] in ("rx_frame", "decode")])
    rows = [l for l in out.splitlines()
            if l.split(" ")[0] in ("AWGN", "Good", "Moderate", "Poor",
                                   "Flutter")]
    assert rows == [l for l in jout.splitlines()
                    if l.split(" ")[0] in ("AWGN", "Good", "Moderate", "Poor",
                                           "Flutter")]
    assert out.splitlines()[-2] == jout.splitlines()[-1]
    assert len(res["conditions"]) == 5

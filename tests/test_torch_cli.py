"""The port's CLI (``projectultra_tpu_torch.cli``) against the JAX
package's (twins of tests/test_cli_modem.py:250-300).

* ``ptx``: for PING, CONNECT, DISCONNECT and a text, each waveform
  (``-w ofdm``, ``dpsk``, ``mcdpsk``) and profile (``-p balanced``,
  ``nvis``), the port's f32 audio within 2e-4 of JAX's (the golden TX
  tolerance; 5e-4 for ``dpsk``, whose float32 symbol phases accumulate in
  another order, as tests/test_torch_dpsk.py and test_torch_engine.py hold
  the same modulator) and the same stderr report;
* ``prx``: of JAX's ``ptx`` output and of the reference binary's own
  files (tests/data/golden/ref_cli_tx_*.f32), the same stderr lines as
  JAX's ``prx``;
* ``info`` and the usage text: the same output;
* without a device the CLI takes the card, so it raises where there is
  none.

The port's CLI runs with ``device=cpu``.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from projectultra_tpu import cli as JCLI  # noqa: E402

from projectultra_tpu_torch import cli as TCLI  # noqa: E402

CPU = torch.device("cpu")
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden")
MESSAGES = ["ping", "connect", "disconnect", "Hello CLI"]


def run(side, argv):
    """(return code, stdout, stderr) of one package's ``main``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = (JCLI.main(argv) if side == "jax"
              else TCLI.main(argv, device=CPU))
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("profile", ["balanced", "nvis"])
@pytest.mark.parametrize("waveform", ["ofdm", "dpsk", "mcdpsk"])
def test_ptx_matches_jax(waveform, profile, tmp_path):
    tol = 5e-4 if waveform == "dpsk" else 2e-4
    for msg in MESSAGES:
        audio, errs = {}, {}
        for side in ("jax", "port"):
            path = tmp_path / f"{side}.f32"
            rc, _, err = run(side, ["ptx", msg, "-s", "W1AW", "-d", "VE3ABC",
                                    "-w", waveform, "-p", profile,
                                    "-o", str(path)])
            assert rc == 0
            audio[side] = np.fromfile(path, dtype=np.float32)
            errs[side] = err.replace(str(path), "<out>")
        assert errs["port"] == errs["jax"], msg
        assert audio["port"].shape == audio["jax"].shape, msg
        np.testing.assert_allclose(audio["port"], audio["jax"], rtol=0,
                                   atol=tol, err_msg=msg)


@pytest.mark.parametrize("msg,waveform,profile", [
    ("Hello CLI", "ofdm", "balanced"),          # test_cli_modem.py:250
    ("skywave profile", "ofdm", "nvis"),        # test_cli_modem.py:268
    ("connect", "mcdpsk", "balanced"),
    ("ping", "dpsk", "balanced"),
])
def test_prx_of_jax_ptx(msg, waveform, profile, tmp_path):
    tx = tmp_path / "tx.f32"
    assert run("jax", ["ptx", msg, "-s", "W1AW", "-d", "VE3ABC", "-w",
                       waveform, "-p", profile, "-o", str(tx)])[0] == 0
    rx = tmp_path / "rx.f32"
    np.concatenate([np.fromfile(tx, dtype=np.float32),
                    np.zeros(4000, np.float32)]).tofile(rx)
    argv = ["prx", str(rx), "-w", waveform, "-p", profile]
    (rj, oj, ej), (rt, ot, et) = run("jax", argv), run("port", argv)
    assert (rt, ot, et) == (rj, oj, ej)
    assert rt == 0 and ("Frames: 1" in et or "PINGs: 1" in et), et
    if msg not in ("ping", "connect"):
        assert msg in et


@pytest.mark.parametrize("name,waveform", [
    ("ref_cli_tx_ping.f32", "ofdm"), ("ref_cli_tx_connect.f32", "ofdm"),
    ("ref_cli_tx_disconnect.f32", "ofdm"), ("ref_cli_tx_ofdm.f32", "ofdm"),
    ("ref_cli_tx_dpsk_mapped.f32", "mcdpsk")])
def test_prx_of_reference_files(name, waveform):
    argv = ["prx", os.path.join(GOLDEN, name), "-w", waveform]
    (rj, oj, ej), (rt, ot, et) = run("jax", argv), run("port", argv)
    assert (rt, ot, et) == (rj, oj, ej)
    assert "Frames: 1" in et or "PINGs: 1" in et, et


@pytest.mark.parametrize("argv", [["info"], ["-h"], [], ["bogus"],
                                  ["ptx", "x", "-p", "no_such_profile"]])
def test_info_usage_and_errors_match_jax(argv):
    def outcome(side):
        try:
            return run(side, argv)
        except SystemExit as e:
            return ("exit", e.code)
    assert outcome("port") == outcome("jax")
    if argv == ["info"]:
        assert "48000 Hz" in run("port", argv)[1]


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA card is present: the CLI would run on it")
def test_cli_without_device_needs_a_card(tmp_path):
    with pytest.raises(RuntimeError):
        TCLI.main(["ptx", "ping", "-o", str(tmp_path / "x.f32")])
    with pytest.raises(RuntimeError):
        TCLI.main(["prx", os.path.join(GOLDEN, "ref_cli_tx_ping.f32")])

"""The port's SRO and CFO-ramp engine harnesses (``tools/torch_test_sro.py``,
``tools/torch_test_cfo_ramp.py``) against the JAX tools
(``tools/test_sro.py``, ``tools/test_cfo_ramp.py``) on the CPU.

Both harnesses build their stream from ``numpy.random.default_rng(11)``
(payloads, gaps, noise), so the JAX engine and the port's engine see the
same audio.  Held exactly: the resampled and ramped arrays, ``run_row``'s
results (frames decoded per skew or ramp) and every RX engine's
``frames_sro_retried``; the 512-plan QAM16 row at +100 ppm must fire the
engine's clock-skew retry (tests/test_sro.py's pin) in both packages, and
the Cox DQPSK row's one-frame miss at -0.1 Hz/s is JAX's too.
The JAX tools run as tests/test_sro.py runs them, with JAX on the CPU.
"""

import os

for _flag in ("ULTRA_CHIRP_BF16", "ULTRA_LDPC_BF16", "ULTRA_EXCISION",
              "ULTRA_BLANKER"):
    os.environ.pop(_flag, None)

import importlib.util  # noqa: E402
import pathlib  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

import jax  # noqa: E402,F401

from projectultra_tpu import config as JC  # noqa: E402
from projectultra_tpu.modem.engine import ModemEngine as JEngine  # noqa: E402
from projectultra_tpu.protocol import frame_v2 as JF  # noqa: E402

from projectultra_tpu_torch import config as TC  # noqa: E402
from projectultra_tpu_torch.modem.engine import ModemEngine  # noqa: E402
from projectultra_tpu_torch.protocol import frame_v2 as TF  # noqa: E402

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"
CPU = torch.device("cpu")


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JSRO, TSRO = _tool("test_sro"), _tool("torch_test_sro")
JRAMP, TRAMP = _tool("test_cfo_ramp"), _tool("torch_test_cfo_ramp")


@pytest.mark.parametrize("ppm", [0, 20, -50, 100, -100])
def test_apply_sro_matches_jax(ppm):
    x = np.random.default_rng(ppm + 200).normal(0, 0.3, 48000).astype(
        np.float32)
    ours, ref = TSRO.apply_sro(x, ppm), JSRO.apply_sro(x, ppm)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_apply_sro_passthrough():
    """tests/test_sro.py::test_sro_resampler_passthrough on the port's
    resampler."""
    x = np.random.default_rng(0).normal(0, 0.3, 48000).astype(np.float32)
    y = TSRO.apply_sro(x, 0)
    assert len(y) >= 48000 - 8
    assert np.max(np.abs(y - x[:len(y)])) < 1e-6


@pytest.mark.parametrize("rate", [0.0, 0.2, -0.5])
def test_apply_cfo_ramp_matches_jax(rate):
    x = np.random.default_rng(7).normal(0, 0.3, 30000).astype(np.float32)
    np.testing.assert_array_equal(TRAMP.apply_cfo_ramp(x, rate),
                                  JRAMP.apply_cfo_ramp(x, rate))


def test_rows_match_jax():
    """The port's rows are the JAX tool's (label, waveform, modulation,
    rate, SNR, payload), by name; the ramp tool keeps its five."""
    want = {
        "cox_dqpsk": ("OFDM_COX", "DQPSK", "R1_2", 25.0, 200),
        "cox_qam16": ("OFDM_COX", "QAM16", "R2_3", 25.0, 400),
        "chirp_dqpsk": ("OFDM_CHIRP", "DQPSK", "R1_2", 17.0, 200),
        "mc_dpsk": ("MC_DPSK", "DQPSK", "R1_2", 10.0, 120),
        "otfs": ("OTFS_EQ", "QPSK", "R1_2", 20.0, 150),
        "nvis_qam32": ("OFDM_COX", "QAM32", "R3_4", 33.0, 432),
        "nvis_qam64": ("OFDM_COX", "QAM64", "R3_4", 33.0, 1500),
        "nvis_qam256": ("OFDM_COX", "QAM256", "R5_6", 42.0, 4000)}
    table = TSRO.rows(CPU)
    assert list(table) == list(want)
    for key, (label, mk, wf, mod, rate, snr, payload) in table.items():
        assert (wf.name, mod.name, rate.name, snr, payload) == want[key]
        assert isinstance(mk(), ModemEngine)
    assert TRAMP.ROWS == ("cox_dqpsk", "cox_qam16", "mc_dpsk", "nvis_qam64",
                          "nvis_qam256")


def _twin_rows(label, wf, mod, rate, snr, payload, values, ramp=False):
    """run_row at one frame on both packages (with each package's
    ``apply_cfo_ramp`` as ``distort`` when ``ramp``); returns
    [(results, frames_sro_retried of each RX engine in value order)] for
    the JAX engines, then the port's."""
    out = []
    for side, engine, F, C, tool, ramp_tool in (
            ("jax", JEngine, JF, JC, JSRO, JRAMP),
            ("port", ModemEngine, TF, TC, TSRO, TRAMP)):
        engines = []

        def mk():
            e = engine() if side == "jax" else engine(device=CPU)
            engines.append(e)
            return e

        kw = dict(distort=ramp_tool.apply_cfo_ramp, unit="Hz/s") if ramp \
            else {}
        res = tool.run_row(label, mk, F.WaveformMode[wf], C.Modulation[mod],
                           C.CodeRate[rate], snr, payload, values, frames=1,
                           **kw)
        out.append((res, [e.stats.frames_sro_retried for e in engines[1:]]))
    return out


def test_run_row_sro_100ppm_qam16_matches_jax():
    (ref, ref_retry), (ours, our_retry) = _twin_rows(
        "512 COX QAM16 R2/3 @25dB", "OFDM_COX", "QAM16", "R2_3", 25.0, 400,
        [100, -100])
    assert ours == ref
    assert our_retry == ref_retry
    assert our_retry[0] > 0  # +100 ppm needs the clock-skew retry
    for ppm, (n_ok, n) in ours.items():
        assert n_ok == n, f"{ppm:+} ppm: {n_ok}/{n}"


def test_run_row_cfo_ramp_0p2_matches_jax():
    (ref, ref_retry), (ours, our_retry) = _twin_rows(
        "512 COX DQPSK R1/2 @25dB", "OFDM_COX", "DQPSK", "R1_2", 25.0, 200,
        [0.2, -0.2], ramp=True)
    assert ours == ref
    assert our_retry == ref_retry
    for r, (n_ok, n) in ours.items():
        assert n_ok == n, f"{r:+} Hz/s: {n_ok}/{n}"


def test_run_row_cfo_ramp_one_frame_miss_matches_jax():
    """At one frame the Cox DQPSK row misses its -0.1 Hz/s cell in both
    packages (the JAX tool's gate fails at ``--frames 1``; at its default
    three frames every cell decodes): the same stream, the same miss."""
    (ref, ref_retry), (ours, our_retry) = _twin_rows(
        "512 COX DQPSK R1/2 @25dB", "OFDM_COX", "DQPSK", "R1_2", 25.0, 200,
        [0.0, 0.1, -0.1], ramp=True)
    assert ours == ref == {0.0: (1, 1), 0.1: (1, 1), -0.1: (0, 1)}
    assert our_retry == ref_retry

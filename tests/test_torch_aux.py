"""The port's small utilities against the JAX package's: logging and
settings (copies), observability, ``ops/dsp`` and the LDPC stream helpers
(``ops/ldpc.decode_hard``, ``decode_soft_stream``, ``decode_hard_stream``).

Tolerances: the copies' source equal to the originals' (docstrings
aside) and the same output on the same calls; the waterfall within rtol
1e-5 of itself across batch shapes (as tests/test_aux.py holds JAX), and
within rtol 1e-5 plus 1e-3 dB of JAX's (float32 FFTs that round in
another order); FIR, resampler, Hilbert, RMS/peak within 1e-6 of JAX's;
``biquad_apply`` and ``agc`` within rtol 1e-4, atol 1e-5 of JAX's at
T = 4,096, B = 4 (the port's blocked biquad scan runs in float64 and is
also held within 1e-6 of a float64 sample loop); LDPC outputs exact (the
golden files of all five rates, as tests/test_ldpc.py holds JAX).
"""

import io
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from projectultra_tpu.config import CodeRate  # noqa: E402
from projectultra_tpu.fec import ldpc as JL  # noqa: E402
from projectultra_tpu.ops import dsp as JD  # noqa: E402
from projectultra_tpu.ops import ldpc as JLO  # noqa: E402
from projectultra_tpu.utils import logging as JLOG  # noqa: E402
from projectultra_tpu.utils import observability as JOBS  # noqa: E402
from projectultra_tpu.utils.settings import AppSettings as JSettings  # noqa: E402

from projectultra_tpu_torch.fec import ldpc as TL  # noqa: E402
from projectultra_tpu_torch.ops import dsp as TD  # noqa: E402
from projectultra_tpu_torch.ops import ldpc as TLO  # noqa: E402
from projectultra_tpu_torch.utils import logging as TLOG  # noqa: E402
from projectultra_tpu_torch.utils import observability as TOBS  # noqa: E402
from projectultra_tpu_torch.utils.settings import AppSettings as TSettings  # noqa: E402

from test_torch_protocol_stack import assert_copy  # noqa: E402

CPU = torch.device("cpu")
RATES = [CodeRate.R1_4, CodeRate.R1_2, CodeRate.R2_3, CodeRate.R3_4,
         CodeRate.R5_6]
NAMES = {CodeRate.R1_4: "R1_4", CodeRate.R1_2: "R1_2",
         CodeRate.R2_3: "R2_3", CodeRate.R3_4: "R3_4",
         CodeRate.R5_6: "R5_6"}


@pytest.mark.parametrize("rel", ["utils/logging.py", "utils/settings.py"])
def test_copy_matches_original(rel):
    assert_copy(rel)


# ---------------------------------------------------------------------------
# Logging and settings (tests/test_aux.py:13-52)
# ---------------------------------------------------------------------------

def log_script(L):
    buf = io.StringIO()
    L.redirect(buf)
    L.set_level("INFO")
    L.info("DEMOD", "hello %d", 42)
    L.debug("DEMOD", "not shown")
    L.enable_category("SYNC", False)
    L.info("SYNC", "gated")
    L.enable_category("SYNC", True)
    L.warn("PROTO", "%s and %s", "a", "b")
    L.redirect(sys.stderr)
    L.set_level("WARN")
    # Lines open with a time stamp: compare from the level tag on.
    return [ln[ln.index("]") + 1:] for ln in buf.getvalue().splitlines()]


def test_logging_levels_and_categories():
    lines = log_script(TLOG)
    assert lines == log_script(JLOG)
    out = "\n".join(lines)
    assert "hello 42" in out and "not shown" not in out and "gated" not in out
    assert "[INFO " in out


def test_settings_roundtrip(tmp_path):
    kw = dict(callsign="W1AW", auto_accept=False, forced_waveform=0x05,
              log_level="DEBUG")
    TSettings(**kw).save(str(tmp_path / "port.ini"))
    JSettings(**kw).save(str(tmp_path / "jax.ini"))
    assert (tmp_path / "port.ini").read_text() == \
        (tmp_path / "jax.ini").read_text()
    t = TSettings.load(str(tmp_path / "jax.ini"))
    assert vars(t) == vars(JSettings.load(str(tmp_path / "port.ini")))
    assert t.callsign == "W1AW"
    assert t.auto_accept is False
    assert t.forced_waveform == 0x05
    assert t.forced_modulation == 0xFF
    assert t.log_level == "DEBUG"


# ---------------------------------------------------------------------------
# Observability (tests/test_aux.py:54-79)
# ---------------------------------------------------------------------------

def test_waterfall_and_constellation():
    t = np.arange(48000) / 48000.0
    sig = np.sin(2 * np.pi * 1500.0 * t).astype(np.float32)
    power, freqs = TOBS.waterfall(sig)
    pj, fj = JOBS.waterfall(sig)
    np.testing.assert_array_equal(freqs, fj)
    assert power.shape == pj.shape and power.shape[1] == 1025
    peak = freqs[np.argmax(power, axis=1)]
    assert np.abs(peak - 1500.0).max() < 50
    np.testing.assert_array_equal(np.argmax(power, 1), np.argmax(pj, 1))
    # Bins within 60 dB of each line's peak (below that float32 FFT
    # rounding is the floor).
    live = pj >= pj.max(1, keepdims=True) - 60.0
    np.testing.assert_allclose(power[live], pj[live], rtol=1e-5, atol=1e-3)

    sym = np.exp(1j * np.linspace(0, 6, 1000))
    pts = TOBS.constellation(sym)
    np.testing.assert_array_equal(pts, JOBS.constellation(sym))
    np.testing.assert_array_equal(
        TOBS.constellation(torch.from_numpy(sym.astype(np.complex64))),
        JOBS.constellation(sym.astype(np.complex64)))
    assert pts.shape == (500, 2)
    assert np.abs(np.hypot(pts[:, 0], pts[:, 1]) - 1).max() < 1e-5


def test_waterfall_batch_and_short_inputs():
    x = np.random.default_rng(0).normal(0, 1, (3, 4096)).astype(np.float32)
    p2, _ = TOBS.waterfall(x, fft_size=2048)
    pflat, _ = TOBS.waterfall(x.reshape(-1), fft_size=2048)
    assert p2.shape == pflat.shape
    np.testing.assert_allclose(p2, pflat, rtol=1e-5)
    np.testing.assert_allclose(p2, JOBS.waterfall(x, fft_size=2048)[0],
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(
        TOBS.waterfall(torch.from_numpy(x), fft_size=2048, hop=512)[0],
        JOBS.waterfall(x, fft_size=2048, hop=512)[0], rtol=1e-5, atol=1e-3)
    p1, freqs = TOBS.waterfall(np.ones(500, np.float32), fft_size=2048)
    assert p1.shape == (1, 1025) and np.isfinite(p1).all()
    np.testing.assert_allclose(
        p1, JOBS.waterfall(np.ones(500, np.float32), fft_size=2048)[0],
        rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# LDPC stream helpers (tests/test_ldpc.py:65)
# ---------------------------------------------------------------------------

def golden(golden_dir, rate):
    out = {}
    with open(os.path.join(golden_dir,
                           f"golden_ldpc_{NAMES[rate]}.txt")) as f:
        for line in f:
            toks = line.split()
            out.update(zip(toks[::2], toks[1::2]))
    return out


@pytest.mark.parametrize("rate", RATES, ids=lambda r: NAMES[r])
def test_hard_decode_roundtrip(golden_dir, rate):
    g = golden(golden_dir, rate)
    for key in ("coded", "coded2"):
        data = bytes.fromhex(g[key])
        dec, ok, iters = TLO.decode_hard_stream(TL.get_code(rate), data,
                                                device=CPU)
        jdec, jok, jiters = JLO.decode_hard_stream(JL.get_code(rate), data)
        assert (dec, ok) == (jdec, jok)
        np.testing.assert_array_equal(iters, np.asarray(jiters))
    dec, ok, iters = TLO.decode_hard_stream(TL.get_code(rate),
                                            bytes.fromhex(g["coded"]),
                                            device=CPU)
    assert ok
    assert int(iters[-1]) == int(g["iters"])
    assert dec.hex() == g["decoded"]


def test_decode_hard_and_soft_stream_match_jax():
    rng = np.random.default_rng(4)
    code_t, code_j = TL.get_code(CodeRate.R1_2), JL.get_code(CodeRate.R1_2)
    info = rng.integers(0, 2, (6, code_t.k)).astype(np.float32)
    cw = TLO.encode(code_t, torch.from_numpy(info)).numpy()
    flips = rng.random(cw.shape) < 0.01
    bits = np.where(flips, 1 - cw, cw).astype(np.float32)
    ours = TLO.decode_hard(code_t, torch.from_numpy(bits))
    ref = JLO.decode_hard(code_j, jnp.asarray(bits))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    llrs = (1.0 - 2.0 * cw.reshape(-1)) * 4.0 \
        + rng.normal(0, 2.5, cw.size).astype(np.float32)
    llrs = llrs[:-100]                  # a trailing partial block
    dec, ok, iters = TLO.decode_soft_stream(code_t, llrs, device=CPU)
    jdec, jok, jiters = JLO.decode_soft_stream(code_j, llrs)
    assert (dec, ok) == (jdec, jok)
    np.testing.assert_array_equal(iters, np.asarray(jiters))
    assert TLO.decode_soft_stream(code_t, np.zeros(0), device=CPU)[:2] == \
        (b"", False)


def test_stream_decode_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TLO.decode_hard_stream(TL.get_code(CodeRate.R1_2), b"\x00" * 81)


# ---------------------------------------------------------------------------
# ops/dsp (tests/test_nvis_waveforms.py:184)
# ---------------------------------------------------------------------------

def test_dsp_primitives():
    t = np.arange(4096) / 48000.0
    sig = (np.sin(2 * np.pi * 500 * t) + np.sin(2 * np.pi * 8000 * t)
           ).astype(np.float32)[None, :]
    h = TD.fir_lowpass(101, 2000.0, 48000.0)
    np.testing.assert_array_equal(h, JD.fir_lowpass(101, 2000.0, 48000.0))
    out = TD.fir_apply(torch.from_numpy(sig), h).numpy()[0]
    np.testing.assert_allclose(
        out, np.asarray(JD.fir_apply(jnp.asarray(sig), h))[0], rtol=0,
        atol=1e-6)
    f = np.abs(np.fft.rfft(out[200:]))
    freqs = np.fft.rfftfreq(len(out) - 200, 1 / 48000)
    assert f[np.argmin(np.abs(freqs - 500))] > \
        50 * f[np.argmin(np.abs(freqs - 8000))]
    bq = TD.biquad_lowpass(1000.0, 0.707, 48000.0)
    out2 = TD.biquad_apply(torch.from_numpy(sig), bq).numpy()[0]
    f2 = np.abs(np.fft.rfft(out2[200:]))
    assert f2[np.argmin(np.abs(freqs - 500))] > \
        20 * f2[np.argmin(np.abs(freqs - 8000))]


def test_designers_equal():
    for kind in ("hann", "hamming", "blackman", "kaiser"):
        np.testing.assert_array_equal(TD.window(257, kind),
                                      JD.window(257, kind))
    for fn, args in (("fir_highpass", (64, 300.0, 48000.0)),
                     ("fir_bandpass", (101, 300.0, 2700.0, 48000.0)),
                     ("biquad_lowpass", (1000.0, 0.707, 48000.0)),
                     ("biquad_highpass", (300.0, 0.707, 48000.0))):
        np.testing.assert_array_equal(getattr(TD, fn)(*args),
                                      getattr(JD, fn)(*args))


def noise_rows():
    return np.random.default_rng(11).standard_normal((4, 4096)) \
        .astype(np.float32) * np.float32(0.3)


def biquad_float64(x, coeffs):
    """The reference's transposed direct form II, sample by sample, in
    float64."""
    b0, b1, b2, a1, a2 = [float(c) for c in coeffs]
    y = np.zeros(x.shape)
    for r in range(x.shape[0]):
        z1 = z2 = 0.0
        for n, xn in enumerate(x[r].astype(np.float64)):
            y[r, n] = b0 * xn + z1
            z1 = b1 * xn - a1 * y[r, n] + z2
            z2 = b2 * xn - a2 * y[r, n]
    return y


@pytest.mark.parametrize("coeffs", [
    TD.biquad_lowpass(1000.0, 0.707, 48000.0),
    TD.biquad_highpass(300.0, 0.707, 48000.0)], ids=["lowpass", "highpass"])
def test_biquad_matches_jax(coeffs):
    x = noise_rows()
    ours = TD.biquad_apply(torch.from_numpy(x), coeffs).numpy()
    ref = np.asarray(JD.biquad_apply(jnp.asarray(x), coeffs))
    assert ours.dtype == np.float32 and ours.shape == x.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ours, biquad_float64(x, coeffs), rtol=0,
                               atol=1e-6)
    # Leading batch axes and a length under one block.
    y3 = TD.biquad_apply(torch.from_numpy(x.reshape(2, 2, -1)[..., :100]),
                         coeffs).numpy()
    np.testing.assert_allclose(y3.reshape(4, 100), ours[:, :100], rtol=0,
                               atol=1e-6)


def test_biquad_pole_near_unit_circle_against_float64():
    """A 60 Hz, Q = 2 lowpass (poles at radius 0.9980): the float64
    blocked scan stays within 1e-6 of the float64 sample loop."""
    x = noise_rows()[:2, :2048]
    coeffs = TD.biquad_lowpass(60.0, 2.0, 48000.0)
    np.testing.assert_allclose(TD.biquad_apply(torch.from_numpy(x),
                                               coeffs).numpy(),
                               biquad_float64(x, coeffs), rtol=0, atol=1e-6)


def test_agc_matches_jax():
    x = noise_rows()
    x[1] *= 4.0                       # one row above the target
    ours = TD.agc(torch.from_numpy(x)).numpy()
    ref = np.asarray(JD.agc(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)
    ours = TD.agc(torch.from_numpy(x[:2]), target=0.2, attack=0.05,
                  decay=0.002).numpy()
    ref = np.asarray(JD.agc(jnp.asarray(x[:2]), target=0.2, attack=0.05,
                            decay=0.002))
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


def test_resample_hilbert_and_levels():
    x = noise_rows()
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for rates in ((48000, 8000), (8000, 12000), (48000, 48000)):
        np.testing.assert_allclose(TD.resample(xt, *rates).numpy(),
                                   np.asarray(JD.resample(xj, *rates)),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(TD.hilbert_analytic(xt).numpy(),
                               np.asarray(JD.hilbert_analytic(xj)), rtol=0,
                               atol=1e-6)
    for fn in ("rms", "peak", "normalize"):
        np.testing.assert_allclose(getattr(TD, fn)(xt).numpy(),
                                   np.asarray(getattr(JD, fn)(xj)), rtol=0,
                                   atol=1e-6)
    assert abs(float(TD.to_db(0.5)) - float(JD.to_db(0.5))) < 1e-5
    assert TD.from_db(6.0) == JD.from_db(6.0)
    np.testing.assert_array_equal(
        TD.normalize(torch.zeros(2, 8)).numpy(), np.zeros((2, 8)))

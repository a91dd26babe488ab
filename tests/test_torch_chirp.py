"""Dual-chirp acquisition of the PyTorch port against the JAX package.

Both sides get the same numpy buffers (made with numpy or with JAX's own
noise).  Tolerances:

* host tables (chirp, templates, decimation taps, decimated templates and
  kappas, refine matrices): array-equal;
* ``_decimate`` and ``_window_sum_dec``: max abs
  difference <= 1e-5 of the output's peak;
* detection: success, every position, ``first_strong_up`` and
  ``next_up_start`` exact; ``cfo_hz`` exact (it is the integer gap error
  over 20); up/down correlations rtol 1e-4;
* ``training_start`` and ``initial_cfo_phase``: exact;
* OFDM_CHIRP behind a detected chirp: bits, ok flags and iterations exact.

JAX reads ULTRA_CHIRP_BF16 and ULTRA_LDPC_BF16 at import; the reference
here is its float32 path, so both are removed before the JAX package is
imported, and every test checks that JAX runs float32.
"""

import os

for _flag in ("ULTRA_CHIRP_BF16", "ULTRA_LDPC_BF16"):
    os.environ.pop(_flag, None)

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from projectultra_tpu.config import CodeRate, Modulation  # noqa: E402
from projectultra_tpu.fec import ldpc  # noqa: E402
from projectultra_tpu.ofdm import pipeline as JP  # noqa: E402
from projectultra_tpu.ops import ldpc as JL  # noqa: E402
from projectultra_tpu.sim import watterson as JW  # noqa: E402
from projectultra_tpu.sync import chirp as JC  # noqa: E402

from projectultra_tpu_torch.ofdm import pipeline as TP  # noqa: E402
from projectultra_tpu_torch.sync import chirp as TC  # noqa: E402

# The default 500 ms chirp, a 100 ms one, and a 100.1 ms one whose
# 4,804-sample length is no multiple of the decimation (the full-rate
# window-energy fallback).
CONFIGS = {"default": {}, "short": {"duration_ms": 100.0},
           "ragged": {"duration_ms": 100.1}}


def _cfgs(name, **extra):
    kw = {**CONFIGS[name], **extra}
    return JC.ChirpConfig(**kw), TC.ChirpConfig(**kw)


@pytest.fixture(autouse=True)
def _float32_reference():
    assert "ULTRA_CHIRP_BF16" not in os.environ
    assert "ULTRA_LDPC_BF16" not in os.environ
    assert JC._BF16 is False
    assert JL._DEFAULT_MSG_DTYPE == jnp.float32


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# Config and host tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_chirp_config_matches_jax(name):
    jc, tc = _cfgs(name, tx_cfo_hz=17.0)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for prop in ("chirp_samples", "gap_samples", "total_samples",
                 "chirp_rate", "cfo_to_samples"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    assert dataclasses.asdict(TC.ChirpConfig(use_dual_chirp=False)) == \
        dataclasses.asdict(JC.ChirpConfig(use_dual_chirp=False))
    assert (TC.MAX_REASONABLE_CFO_HZ, TC.DECIM, TC.DECIM_TAPS, TC.GRID_LOSS,
            TC.REFINE_HALF) == (JC.MAX_REASONABLE_CFO_HZ, JC.DECIM,
                                JC.DECIM_TAPS, JC.GRID_LOSS, JC.REFINE_HALF)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_host_tables_equal_jax(name):
    jc, tc = _cfgs(name)
    for extra in ({}, {"tx_cfo_hz": -23.0}, {"use_dual_chirp": False}):
        np.testing.assert_array_equal(
            TC.generate(dataclasses.replace(tc, **extra)),
            JC.generate(dataclasses.replace(jc, **extra)))
    for fn in ("_templates", "_decim_filter", "_templates_dec",
               "_refine_mats"):
        ours, ref = getattr(TC, fn)(tc), getattr(JC, fn)(jc)
        if isinstance(ref, np.ndarray):
            ours, ref = (ours,), (ref,)
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            assert np.asarray(a).dtype == np.asarray(b).dtype, fn
            np.testing.assert_array_equal(a, b, err_msg=fn)


# ---------------------------------------------------------------------------
# Decimation and window energies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [20000, 20003, 83808])
def test_decimate_matches_jax(T):
    jc, tc = _cfgs("default")
    x = np.random.default_rng(T).standard_normal((3, T)).astype(np.float32)
    ref = np.asarray(JC._decimate(jc, jnp.asarray(x)))
    ours = TC._decimate(tc, _t(x)).numpy()
    assert ours.shape == ref.shape == (3, -(-T // 8))
    assert ours.dtype == np.complex64
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()


def test_decimate_is_full_float32_under_the_pins():
    """The conv runs in float32 with cuDNN's TF32 off (the pins of the
    package import); against a float64 sum its error is float32-sized."""
    import projectultra_tpu_torch  # noqa: F401
    assert torch.backends.cudnn.allow_tf32 is False
    tc = TC.ChirpConfig()
    x = np.random.default_rng(5).standard_normal((2, 4001)).astype(np.float32)
    w = TC._decim_filter(tc).astype(np.float64)
    xp = np.concatenate([np.zeros((2, 64)), x, np.zeros((2, 127))], axis=1)
    idx = np.arange(501)[:, None] * 8 + np.arange(128)[None, :]
    exact = (xp[:, idx] * (w[0] + 1j * w[1])).sum(-1)
    ours = TC._decimate(tc, _t(x)).numpy()
    assert np.abs(ours - exact).max() <= 1e-6 * np.abs(exact).max()


@pytest.mark.parametrize("L", [4800, 4804])
def test_window_sum_dec_matches_jax(L):
    x = np.random.default_rng(L).standard_normal((2, 30001)).astype(np.float32)
    n_pos_d = (30001 - L + 1 + 7) // 8
    ref = np.asarray(JC._window_sum_dec(jnp.asarray(x), L, n_pos_d))
    ours = TC._window_sum_dec(_t(x), L, n_pos_d).numpy()
    assert ours.shape == ref.shape == (2, n_pos_d)
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------

def _assert_detection_equal(ours, ref):
    assert ours.keys() == ref.keys()
    for key in ("success", "up_chirp_start", "down_chirp_start",
                "first_strong_up", "next_up_start", "cfo_hz"):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
        assert ours[key].numpy().dtype == np.asarray(ref[key]).dtype, key
    for key in ("up_correlation", "down_correlation"):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-4, atol=0, err_msg=key)


def _detect_both(name, x, threshold=0.15):
    jc, tc = _cfgs(name)
    ref = JC.detect_dual_chirp(jc, jnp.asarray(x), threshold=threshold)
    ours = TC.detect_dual_chirp(tc, _t(x), threshold=threshold)
    _assert_detection_equal(ours, ref)
    return {k: v.numpy() for k, v in ours.items()}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_detect_matches_jax_at_three_offsets_and_cfos(name):
    """The scenarios of tests/test_chirp_fast_parity.py:34-56: chirps at
    3,000, 11,111 and 30,005 with 0, 17 and -40 Hz of TX CFO in 0.05
    noise."""
    jc, _ = _cfgs(name)
    rng = np.random.default_rng(42)
    T = jc.total_samples + 40000
    rows = []
    for off, cfo in zip([3000, 11111, 30005], [0.0, 17.0, -40.0]):
        c = JC.generate(dataclasses.replace(jc, tx_cfo_hz=cfo))
        sig = np.zeros(T, np.float32)
        sig[off:off + len(c)] = c
        rows.append(sig + rng.normal(0, 0.05, T).astype(np.float32))
    det = _detect_both(name, np.stack(rows))
    assert det["success"].all()
    assert np.abs(det["up_chirp_start"] - [3000, 11111, 30005]).max() <= 3
    assert np.abs(det["cfo_hz"] - [0.0, 17.0, -40.0]).max() < 1.5


def test_detect_matches_jax_on_noise_only():
    """tests/test_chirp_fast_parity.py:59-63."""
    jc, _ = _cfgs("short")
    x = np.random.default_rng(1).normal(
        0, 0.3, (4, jc.total_samples + 30000)).astype(np.float32)
    det = _detect_both("short", x)
    assert not det["success"].any()


def test_detect_matches_jax_at_minus_20_db_weak_threshold():
    """The weak second pass (threshold 0.08) at -20 dB wideband SNR, on
    JAX's noise (tests/test_chirp_fast_parity.py:66-77, 4 of its 8 rows)."""
    jc, _ = _cfgs("default")
    c = JC.generate(jc)
    sig = np.zeros((4, jc.total_samples + 30000), np.float32)
    sig[:, 5000:5000 + len(c)] = c
    x = np.asarray(JW.add_noise_active(jax.random.PRNGKey(3),
                                       jnp.asarray(sig), -20.0))
    det = _detect_both("default", x, threshold=0.08)
    assert det["success"].all()
    assert np.abs(det["up_chirp_start"] - 5000).max() <= 24


def test_detect_matches_jax_earliest_weak_beats_later_strong():
    """tests/test_chirp_sync.py:66-89: a 0.2x chirp ahead of a full one is
    the detection, and the strong one is next_up_start."""
    jc, _ = _cfgs("default")
    ch = JC.generate(jc)
    buf = np.zeros(200000, np.float32)
    buf[5000:5000 + len(ch)] = 0.2 * ch
    buf[120000:120000 + len(ch)] = ch
    x = np.asarray(JW.add_noise_active(jax.random.PRNGKey(0),
                                       jnp.asarray(buf[None, :]), 10.0))
    det = _detect_both("default", x)
    assert det["success"][0]
    assert abs(int(det["up_chirp_start"][0]) - 5000) < 100
    assert abs(int(det["next_up_start"][0]) - 120000) < 200


@pytest.mark.parametrize("name", ["short", "ragged"])
def test_detect_matches_jax_with_hilbert_cfo_and_noise(name):
    """A 30 Hz harness CFO and 5 dB of JAX's noise
    (tests/test_chirp_sync.py:43-55) on the short chirps, one frame per
    row at two offsets, and a row of silence."""
    jc, _ = _cfgs(name)
    c = JC.generate(jc)
    sig = np.zeros((3, jc.total_samples + 20000), np.float32)
    sig[0, 9000:9000 + len(c)] = c
    sig[1, 2345:2345 + len(c)] = c
    shifted = JW.apply_cfo_hilbert(jnp.asarray(sig), jnp.full((3,), 30.0))
    x = np.asarray(JW.add_noise_active(jax.random.PRNGKey(0), shifted, 5.0))
    det = _detect_both(name, x)
    assert det["success"][:2].all() and not det["success"][2]
    assert np.abs(det["cfo_hz"][:2] - 30.0).max() < 2.5


def test_training_start_and_initial_cfo_phase_match_jax():
    jc, tc = _cfgs("default")
    rng = np.random.default_rng(3)
    ds = rng.integers(-5000, 300000, 64).astype(np.int32)
    cfo = rng.uniform(-100, 100, 64).astype(np.float32)
    tr_ref = JC.training_start(jc, jnp.asarray(ds))
    tr = TC.training_start(tc, _t(ds))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(tr_ref))
    assert tr.dtype == torch.int32
    ph = TC.initial_cfo_phase(tc, _t(cfo), tr).numpy()
    np.testing.assert_array_equal(
        ph, np.asarray(JC.initial_cfo_phase(jc, jnp.asarray(cfo), tr_ref)))
    assert ph.dtype == np.float32 and (np.abs(ph) <= np.pi).all()


# ---------------------------------------------------------------------------
# OFDM_CHIRP behind a detected chirp
# ---------------------------------------------------------------------------

OFDM = JP.chirp_ofdm_config()
LEAD, TAIL = 4800, 4000


def _ofdm_chirp_tx(B, seed):
    """[lead][chirp][tx_frame][tail] from JAX (T = 73,732)."""
    code = ldpc.get_code(CodeRate.R1_2)
    info = np.random.default_rng(seed).integers(
        0, 2, size=(B, code.k)).astype(np.float32)
    frame = JP.tx_frame(OFDM, Modulation.DQPSK, CodeRate.R1_2,
                        jnp.asarray(info))
    chirp = JC.generate(JC.ChirpConfig())
    tx = jnp.concatenate([jnp.zeros((B, LEAD)),
                          jnp.broadcast_to(jnp.asarray(chirp), (B, len(chirp))),
                          frame, jnp.zeros((B, TAIL))], axis=-1)
    return info, tx


def _port_ofdm_chirp_tx(info):
    """The same frames from the port's chirp and ``tx_frame``."""
    chirp = torch.from_numpy(TC.generate(TC.ChirpConfig()))
    B = info.shape[0]
    return torch.cat([torch.zeros((B, LEAD)), chirp.expand(B, len(chirp)),
                      TP.tx_frame(OFDM, Modulation.DQPSK, CodeRate.R1_2, info),
                      torch.zeros((B, TAIL))], dim=-1)


def _port_ofdm_after_chirp(x):
    """detect -> training start -> CFO phase -> per-row frame gather ->
    rx_frame, composed from the port's functions."""
    cc = TC.ChirpConfig()
    det = TC.detect_dual_chirp(cc, x)
    tr = TC.training_start(cc, det["down_chirp_start"])
    phase = TC.initial_cfo_phase(cc, det["cfo_hz"], tr)
    span = TC.frame_spans(x, tr, TP.frame_samples(OFDM, Modulation.DQPSK))
    out, ok, iters = TP.rx_frame(OFDM, Modulation.DQPSK, CodeRate.R1_2, span,
                                 det["cfo_hz"], phase)
    return out, ok & det["success"], iters, det


def test_tx_chirp_frame_matches_the_jax_construction():
    info, tx = _ofdm_chirp_tx(3, seed=4)
    ours = _port_ofdm_chirp_tx(_t(info)).numpy()
    tx = np.asarray(tx)
    assert ours.shape == tx.shape == (3, 73732)
    assert np.abs(ours - tx).max() <= 1e-5 * np.abs(tx).max()


@pytest.mark.parametrize("cfo", [0.0, 30.0])
def test_ofdm_after_chirp_matches_jax(cfo):
    """detect -> training start -> CFO phase -> rx_frame at the detected
    CFO and phase (modem/acquisition/chirp.py:336-351), composed from JAX
    functions, against the same chain of the port's functions on JAX's
    17 dB buffers."""
    B = 3
    info, tx = _ofdm_chirp_tx(B, seed=5)
    if cfo:
        tx = JW.apply_cfo_hilbert(tx, jnp.full((B,), cfo))
    x = JW.add_noise_active(jax.random.PRNGKey(6), tx, 17.0)
    cc = JC.ChirpConfig()
    det = JC.detect_dual_chirp(cc, x)
    tr = JC.training_start(cc, det["down_chirp_start"])
    phase = JC.initial_cfo_phase(cc, det["cfo_hz"], tr)
    n = JP.frame_samples(OFDM, Modulation.DQPSK)
    span = jax.vmap(lambda b, s: jax.lax.dynamic_slice(b, (s,), (n,)))(x, tr)
    ref = JP.rx_frame(OFDM, Modulation.DQPSK, CodeRate.R1_2, span,
                      det["cfo_hz"], phase)
    out, ok, iters, ours_det = _port_ofdm_after_chirp(_t(x))
    _assert_detection_equal(ours_det, det)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(ok.numpy(),
                                  np.asarray(ref[1] & det["success"]))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(ref[2]))
    assert ok.all()
    np.testing.assert_array_equal(out.numpy(), info.astype(np.uint8))
    assert np.abs(ours_det["cfo_hz"].numpy() - cfo).max() < 2.0


"""The pilot-tracking scan receiver of the PyTorch port against JAX.

JAX's frames and noise go through the JAX function and the port's on the
same arrays.  LLRs atol 2e-4, the tolerance of
test_fast_path_matches_scan_path (float32 transcendentals and complex
divisions differ by ulps between XLA and PyTorch, and the scan carries
them through 22 symbols of EMA state); channel estimates and phasors atol
1e-4; tracked CFO atol 1e-3 Hz and timing offset atol 1e-3 samples (EMA
states of Hz and sample scale, fed by atan2 of float32 pilots); decoded
bits, ok flags and iteration counts exact.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from projectultra_tpu.config import CodeRate, ModemConfig, Modulation  # noqa: E402
from projectultra_tpu.fec import ldpc  # noqa: E402
from projectultra_tpu.ofdm import demodulator as JD  # noqa: E402
from projectultra_tpu.ofdm import pipeline as JP  # noqa: E402
from projectultra_tpu.sim import watterson as JW  # noqa: E402

from projectultra_tpu_torch.ofdm import demodulator as TD  # noqa: E402
from projectultra_tpu_torch.ofdm import pipeline as TP  # noqa: E402

from test_torch_sync import noisy_tx  # noqa: E402

PILOT_CFG = ModemConfig()
CHIRP_CFG = JP.chirp_ofdm_config()
PLEN = PILOT_CFG.fft_size + PILOT_CFG.cyclic_prefix
CPU = torch.device("cpu")

# Tolerances per DemodState field (see the module docstring).
STATE_ATOL = {"freq_offset_hz": 1e-3, "freq_offset_filtered": 1e-3,
              "timing_offset_samples": 1e-3, "noise_variance": 1e-4,
              "estimated_snr_linear": 1e-2}


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_llrs_close(ours, ref, atol=2e-4, n_live=648, rtol=0.0):
    """The LLRs the decoder reads (the first ``n_live`` bits, which the TX
    filled) at ``atol``.  The tail of the last symbol sits on carriers the
    TX left empty: there the equalized symbol is noise of magnitude ~0.02,
    so ulp-level differences of the tracked state move its LLRs by up to
    ~1e-4 of their value (measured up to 1.2e-3); they are held at atol
    5e-3.  Nothing downstream reads them: the deinterleave keeps the first
    648."""
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours[:, :n_live], ref[:, :n_live], rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(ours[:, n_live:], ref[:, n_live:], rtol=0,
                               atol=5e-3)


def _assert_state_equal(ours, ref):
    for name in ref._fields:
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        if b.dtype in (np.bool_, np.int32):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4,
                                       atol=STATE_ATOL.get(name, 1e-4),
                                       err_msg=name)


@pytest.mark.parametrize("mod,rate,snr,cfo", [
    (Modulation.DQPSK, CodeRate.R1_2, 17.0, 0.0),
    (Modulation.QPSK, CodeRate.R1_2, 17.0, 0.0),
    (Modulation.QAM16, CodeRate.R2_3, 25.0, 0.0),
    (Modulation.QPSK, CodeRate.R1_2, 20.0, 30.0)])
def test_demodulate_span_matches_jax(mod, rate, snr, cfo):
    """Spans cut at the true first LTS of JAX's noisy Cox buffers, with
    plen margins and the true CFO per lane."""
    _, buf = noisy_tx(mod, rate, snr, cfo=cfo, B=3, seed=4)
    S = JP.num_data_symbols(PILOT_CFG, mod, 1)
    lts = 3000 + 5 * PLEN
    span = buf[:, lts - PLEN:lts + 2 * PLEN + S * PILOT_CFG.symbol_duration
               + PLEN]
    cfo_lanes = np.full(3, cfo, np.float32)
    ref, ref_state = JD.demodulate_span(PILOT_CFG, mod, jnp.asarray(span),
                                        jnp.asarray(cfo_lanes), 0.0, n_lts=2,
                                        S=S, lead=PLEN, tail=PLEN, n_bits=648)
    ours, state = TD.demodulate_span(PILOT_CFG, mod, _t(span),
                                     _t(cfo_lanes), 0.0, n_lts=2, S=S,
                                     lead=PLEN, tail=PLEN, n_bits=648)
    _assert_llrs_close(ours, ref)
    _assert_state_equal(state, ref_state)


@pytest.mark.parametrize("mod", [Modulation.BPSK, Modulation.QPSK,
                                 Modulation.DBPSK, Modulation.D8PSK,
                                 Modulation.QAM8, Modulation.QAM32])
def test_demodulate_presynced_pilot_plan_matches_jax(mod):
    """Presynced frames on the pilot plan (training + data) at 20 dB with
    a known per-lane CFO: the scan path for every modulation it serves.
    D8PSK's third LLR is conf * sin(4 * phase) with conf = |eq||prev|/nv
    ~ 100 at 20 dB and no clip below 10, so a phase difference of 1e-6 rad
    (a few float32 ulps) moves it by ~4e-4: atol 5e-4 there (measured
    2.6e-4), 2e-4 elsewhere."""
    info = np.random.default_rng(int(mod)).integers(
        0, 2, size=(2, 324)).astype(np.float32)
    tx = JP.tx_frame(PILOT_CFG, mod, CodeRate.R1_2, jnp.asarray(info))
    cfo = jnp.asarray([6.0, -11.0])
    rx = JW.add_noise_active(jax.random.PRNGKey(int(mod)),
                             JW.apply_cfo_hilbert(tx, cfo), 20.0)
    S = JP.num_data_symbols(PILOT_CFG, mod, 1)
    ref, ref_state = JD.demodulate_presynced(PILOT_CFG, mod, rx, cfo, 0.0,
                                             training_symbols=2,
                                             num_data_symbols=S)
    ours, state = TD.demodulate_presynced(PILOT_CFG, mod, _t(rx),
                                          _t(cfo), 0.0, training_symbols=2,
                                          num_data_symbols=S)
    _assert_llrs_close(ours, ref, 5e-4 if mod == Modulation.D8PSK else 2e-4)
    _assert_state_equal(state, ref_state)


@pytest.mark.parametrize("rls", [False, True])
def test_adaptive_equalizer_scan_matches_jax(rls):
    """Coherent QPSK with the LMS/RLS decision-directed equalizer on
    (dd_update), on the pilot plan and on the no-pilot plan."""
    for base in (PILOT_CFG, CHIRP_CFG):
        cfg = base.replace(adaptive_eq_enabled=True, adaptive_eq_use_rls=rls)
        info = np.random.default_rng(5).integers(0, 2, size=(2, 324)) \
            .astype(np.float32)
        tx = JP.tx_frame(cfg, Modulation.QPSK, CodeRate.R1_2,
                         jnp.asarray(info))
        rx = JW.add_noise_active(jax.random.PRNGKey(2), tx, 18.0)
        S = JP.num_data_symbols(cfg, Modulation.QPSK, 1)
        ref, ref_state = JD.demodulate_presynced(
            cfg, Modulation.QPSK, rx, 0.0, 0.0, training_symbols=2,
            num_data_symbols=S)
        ours, state = TD.demodulate_presynced(
            cfg, Modulation.QPSK, _t(rx), 0.0, 0.0, training_symbols=2,
            num_data_symbols=S)
        _assert_llrs_close(ours, ref)
        _assert_state_equal(state, ref_state)


@pytest.mark.parametrize("config_mod", [Modulation.QPSK, Modulation.DQPSK])
def test_update_channel_estimate_matches_jax(config_mod):
    """Five symbols of tracking on random used bins; the coherent timing
    fix follows config.modulation (the reference behaviour), so both
    settings are held."""
    cfg = PILOT_CFG.replace(modulation=config_mod)
    rng = np.random.default_rng(3)
    B, Cu = 4, 30
    cfo = np.array([0.0, 3.0, -40.0, 12.0], np.float32)
    ref = JD.init_state(cfg, B, jnp.asarray(cfo), 0.0)
    ours = TD.init_state(cfg, B, _t(cfo), 0.0, CPU)
    slope = np.exp(1j * 0.05 * np.arange(Cu))
    for s in range(5):
        fd = ((rng.standard_normal((B, Cu)) + 1j * rng.standard_normal((B, Cu)))
              * 0.2 + slope * (1 + 0.1 * s)).astype(np.complex64)
        ref = JD.update_channel_estimate(cfg, ref, jnp.asarray(fd))
        ours = TD.update_channel_estimate(cfg, ours, _t(fd))
        _assert_state_equal(ours, ref)
        for mod in (Modulation.QPSK, Modulation.DQPSK):
            eq, cnv = TD.equalize(cfg, mod, ours, _t(fd))
            ref_eq, ref_cnv = JD.equalize(cfg, mod, ref, jnp.asarray(fd))
            np.testing.assert_allclose(eq.numpy(), np.asarray(ref_eq),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(cnv.numpy(), np.asarray(ref_cnv),
                                       rtol=1e-4, atol=1e-5)


def test_scan_path_equals_fast_path():
    """The port's scan path against its own differential fast path on the
    no-pilot plan (test_ofdm_loopback.py:140-168 in JAX): 12 dB, known CFO
    of 15 and -20 Hz."""
    code = ldpc.get_code(CodeRate.R1_2)
    info = np.random.default_rng(17).integers(0, 2, size=(2, code.k)) \
        .astype(np.float32)
    tx = JP.tx_frame(CHIRP_CFG, Modulation.DQPSK, CodeRate.R1_2,
                     jnp.asarray(info))
    rx = JW.add_noise_active(jax.random.PRNGKey(3), tx, 12.0)
    rx = _t(JW.apply_cfo_hilbert(rx, jnp.asarray([15.0, -20.0])))
    cfo = torch.tensor([15.0, -20.0])
    S = JP.num_data_symbols(CHIRP_CFG, Modulation.DQPSK, 1)
    fast, _ = TD.demodulate_presynced(CHIRP_CFG, Modulation.DQPSK, rx, cfo,
                                      0.0, training_symbols=2,
                                      num_data_symbols=S)
    L = CHIRP_CFG.symbol_duration
    st = TD.init_state(CHIRP_CFG, 2, cfo, 0.0, CPU)
    st = TD.estimate_channel_from_lts(CHIRP_CFG, st,
                                      rx[:, :2 * L].reshape(2, 2, L))
    data = rx[:, 2 * L:(2 + S) * L].reshape(2, S, L)
    _, scan = TD._scan_data_symbols(CHIRP_CFG, Modulation.DQPSK, st, data,
                                    t0_base=2 * L)
    np.testing.assert_allclose(fast.numpy(), scan.numpy(), rtol=0, atol=2e-4)


def test_fast_path_on_analytic_input_matches_jax():
    """Complex (analytic) samples through the no-pilot differential fast
    path at 12 dB, with and without CFO, against JAX's fast path and JAX's
    scan path on the same samples.  Without CFO all four agree exactly.
    At 9 Hz JAX's own two paths differ by up to 4.4e-3 on one unclipped
    LLR (7.74 at symbol 0, measured), and the port lies between them
    (8.7e-4 from JAX's fast path, 3.5e-3 from its scan path), so the bound
    is 5e-3 there."""
    code = ldpc.get_code(CodeRate.R1_2)
    info = np.random.default_rng(2).integers(0, 2, size=(2, code.k)) \
        .astype(np.float32)
    tx = JP.tx_frame(CHIRP_CFG, Modulation.DQPSK, CodeRate.R1_2,
                     jnp.asarray(info))
    rx = JD.analytic_half(JW.add_noise_active(jax.random.PRNGKey(3), tx, 12.0))
    L = CHIRP_CFG.symbol_duration
    S = JP.num_data_symbols(CHIRP_CFG, Modulation.DQPSK, 1)
    for cfo in (0.0, 9.0):
        fast, _ = JD.demodulate_presynced(CHIRP_CFG, Modulation.DQPSK, rx,
                                          cfo, 0.0, 2, S)
        st = JD.estimate_channel_from_lts(
            CHIRP_CFG, JD.init_state(CHIRP_CFG, 2, cfo, 0.0),
            rx[:, :2 * L].reshape(2, 2, L))
        _, scan = JD._scan_data_symbols(
            CHIRP_CFG, Modulation.DQPSK, st,
            rx[:, 2 * L:(2 + S) * L].reshape(2, S, L), t0_base=2 * L)
        ours, _ = TD.demodulate_presynced(CHIRP_CFG, Modulation.DQPSK,
                                          _t(rx), cfo, 0.0, 2, S)
        atol = 2e-4 if cfo == 0.0 else 5e-3
        _assert_llrs_close(ours, scan, atol)
        _assert_llrs_close(ours, fast, atol)


def test_analytic_front_end_matches_jax():
    x = np.random.default_rng(6).standard_normal((2, 7000)).astype(np.float32)
    ref = np.asarray(JD.analytic_half(jnp.asarray(x)))
    ours = TD.analytic_half(_t(x)).numpy()
    assert ours.dtype == np.complex64
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()
    for mod in (Modulation.QPSK, Modulation.DQPSK):
        np.testing.assert_array_equal(
            TD._edge_tapered(mod, _t(x), 560, 1120).numpy(),
            np.asarray(JD._edge_tapered(mod, jnp.asarray(x), 560, 1120)))
    assert TD.maybe_analytic(Modulation.DQPSK, _t(x)).dtype == torch.float32
    assert TD.maybe_analytic(Modulation.QPSK, _t(x), "real").dtype \
        == torch.float32


def test_rx_frame_qam16_pilot_plan_matches_jax():
    """ModemConfig() with QAM16 R2/3 at 25 dB (test_ofdm_loopback.py:124-137
    in JAX): the port's rx_frame on JAX's noisy frames equals JAX's
    rx_frame in bits, ok flags and iteration counts."""
    code = ldpc.get_code(CodeRate.R2_3)
    info = np.random.default_rng(5).integers(0, 2, size=(2, code.k)) \
        .astype(np.float32)
    tx = JP.tx_frame(PILOT_CFG, Modulation.QAM16, CodeRate.R2_3,
                     jnp.asarray(info))
    rx = JW.add_noise_active(jax.random.PRNGKey(7), tx, 25.0)
    ref = JP.rx_frame(PILOT_CFG, Modulation.QAM16, CodeRate.R2_3, rx)
    ours = TP.rx_frame(PILOT_CFG, Modulation.QAM16, CodeRate.R2_3, _t(rx))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ours[1].all()
    np.testing.assert_array_equal(ours[0].numpy(), info.astype(np.uint8))
    # The port's own TX of the same bits equals JAX's.
    tx_ours = TP.tx_frame(PILOT_CFG, Modulation.QAM16, CodeRate.R2_3,
                          _t(info)).numpy()
    assert np.abs(tx_ours - np.asarray(tx)).max() <= 1e-5 * np.abs(tx).max()


@pytest.mark.parametrize("config,mod", [(PILOT_CFG, Modulation.QAM64),
                                        (PILOT_CFG, Modulation.QAM256),
                                        (CHIRP_CFG, Modulation.QPSK),
                                        (CHIRP_CFG, Modulation.QAM16)])
def test_unported_branches_raise(config, mod):
    """The branches earlier slices left out (they raised) now run through
    both entry points and equal JAX: presynced frames at 34 dB, and a span
    of the same frame with an L-sample tail through ``demodulate_span``.
    LLRs atol 2e-4 on the filled carriers (see _assert_llrs_close), plus
    rtol 1e-4: QAM256's s = 2/nv makes unclipped LLRs of a few units carry
    the per-carrier noise's ulp differences relatively (measured 5.7e-5)."""
    rate = CodeRate.R2_3
    info = np.random.default_rng(int(mod)).integers(
        0, 2, size=(2, 432)).astype(np.float32)
    tx = JP.tx_frame(config, mod, rate, jnp.asarray(info))
    rx = JW.add_noise_active(jax.random.PRNGKey(int(mod)), tx, 34.0)
    S = JP.num_data_symbols(config, mod, 1)
    ref, _ = JD.demodulate_presynced(config, mod, rx, 0.0, 0.0, 2, S)
    ours, _ = TD.demodulate_presynced(config, mod, _t(rx), 0.0, 0.0, 2, S)
    _assert_llrs_close(ours, ref, rtol=1e-4)
    L = config.symbol_duration
    span = np.asarray(rx)[:, :(2 + S) * L + L]
    ref, _ = JD.demodulate_span(config, mod, jnp.asarray(span), 0.0, 0.0,
                                n_lts=2, S=S - 1, tail=L, n_bits=648)
    ours, _ = TD.demodulate_span(config, mod, _t(span), 0.0, 0.0, n_lts=2,
                                 S=S - 1, tail=L, n_bits=648)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=2e-4)

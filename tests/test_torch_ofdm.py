"""Mixer, demapper, modulator, AWGN and demodulator of the PyTorch port
against the JAX package, on numpy-seeded inputs.

Tolerances: LLRs and phasors atol 1e-5 (float32 transcendentals differ by
ulps between XLA and PyTorch; the random demapper inputs have unit-scale
symbols and noise variances in [0.5, 2]); osc_int phases exact
(integer-modular);
TX against the golden waveform as tests/test_ofdm_loopback.py:34,40; TX
against JAX 1e-5 of the peak; the AWGN core rtol 1e-5 on the noise JAX
drew; demodulated LLRs atol 2e-4, the tolerance of
test_fast_path_matches_scan_path.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from projectultra_tpu.config import CodeRate, ModemConfig, Modulation  # noqa: E402
from projectultra_tpu.fec import ldpc  # noqa: E402
from projectultra_tpu.ofdm import demodulator as JD  # noqa: E402
from projectultra_tpu.ofdm import modulator as JM  # noqa: E402
from projectultra_tpu.ofdm import pipeline as JP  # noqa: E402
from projectultra_tpu.ops import demap as JDM  # noqa: E402
from projectultra_tpu.ops import mixer as JMX  # noqa: E402
from projectultra_tpu.sim import watterson as JW  # noqa: E402

from projectultra_tpu_torch.ofdm import demodulator as TD  # noqa: E402
from projectultra_tpu_torch.ofdm import modulator as TM  # noqa: E402
from projectultra_tpu_torch.ofdm import pipeline as TP  # noqa: E402
from projectultra_tpu_torch.ops import demap as TDM  # noqa: E402
from projectultra_tpu_torch.ops import mixer as TMX  # noqa: E402
from projectultra_tpu_torch.sim import watterson as TW  # noqa: E402

CHIRP_CFG = JP.chirp_ofdm_config()
PILOT_CFG = ModemConfig()
DQPSK, R12 = Modulation.DQPSK, CodeRate.R1_2


def _c64(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _tx_jax(B, seed):
    code = ldpc.get_code(R12)
    info = np.random.default_rng(seed).integers(
        0, 2, size=(B, code.k)).astype(np.float32)
    return info, JP.tx_frame(CHIRP_CFG, DQPSK, R12, jnp.asarray(info))


# ---------------------------------------------------------------------------
# Mixer and demappers
# ---------------------------------------------------------------------------

def test_osc_int_matches_jax():
    t = np.concatenate([np.arange(0, 3000), np.arange(47990, 48010),
                        np.arange(2 ** 20, 2 ** 20 + 700)]).astype(np.int32)
    ours = TMX.osc_int(1500, 48000, torch.from_numpy(t))
    np.testing.assert_allclose(ours.numpy(),
                               np.asarray(JMX.osc_int(1500, 48000, t)),
                               rtol=0, atol=1e-5)
    # The phases themselves are exact: mixer.py:33-35 in jnp.
    tj = jnp.asarray(t)
    num = jnp.mod(1500 * jnp.mod(tj, 48000), 48000)
    ref_phase = JMX.TWO_PI * num.astype(jnp.float32) / np.float32(48000)
    np.testing.assert_array_equal(
        TMX.osc_int_phase(1500, 48000, torch.from_numpy(t)).numpy(),
        np.asarray(ref_phase))


def test_clip_llr_matches_jax():
    x = np.random.default_rng(0).uniform(-20, 20, 4000).astype(np.float32)
    x[:4] = [0.0, -0.0, 0.49, -0.3]
    np.testing.assert_array_equal(TDM.clip_llr(torch.from_numpy(x)).numpy(),
                                  np.asarray(JDM.clip_llr(jnp.asarray(x))))


@pytest.mark.parametrize("mod", [Modulation.DBPSK, Modulation.DQPSK,
                                 Modulation.D8PSK])
def test_differential_demap_matches_jax(mod):
    rng = np.random.default_rng(int(mod))
    sym, prev = _c64(rng, (6, 11, 30), 0.7), _c64(rng, (6, 11, 30), 0.7)
    sym[0, 0, :3] = 0.0  # the weak-symbol branch
    nv = rng.uniform(0.5, 2.0, (6, 11, 30)).astype(np.float32)
    ours = TDM.demap(mod, torch.from_numpy(sym), torch.from_numpy(nv),
                     prev=torch.from_numpy(prev))
    ref = JDM.demap(mod, jnp.asarray(sym), jnp.asarray(nv),
                    prev=jnp.asarray(prev))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("mod", [Modulation.BPSK, Modulation.QPSK,
                                 Modulation.QAM16, Modulation.QAM32,
                                 Modulation.QAM64, Modulation.QAM256])
def test_coherent_demap_matches_jax(mod):
    rng = np.random.default_rng(int(mod))
    sym = _c64(rng, (4, 5, 30), 0.7)
    nv = rng.uniform(0.5, 2.0, (4, 5, 30)).astype(np.float32)
    ours = TDM.demap(mod, torch.from_numpy(sym), torch.from_numpy(nv))
    ref = JDM.demap(mod, jnp.asarray(sym), jnp.asarray(nv))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(
        TDM.hard_decision(mod, torch.from_numpy(sym)).numpy(),
        np.asarray(JDM.hard_decision(mod, jnp.asarray(sym))))


# ---------------------------------------------------------------------------
# Modulator and AWGN
# ---------------------------------------------------------------------------

def test_tx_matches_reference_golden(golden_dir):
    payload = bytes.fromhex(open(os.path.join(
        golden_dir, "golden_ofdm_tx_meta.txt")).read().split()[1])
    golden = np.fromfile(os.path.join(golden_dir, "golden_ofdm_tx.f32"),
                         dtype=np.float32)
    gt, gd = golden[:1128], golden[1128:]
    assert np.abs(TM.generate_training(CHIRP_CFG, 2) - gt).max() < 1e-4
    bits = np.unpackbits(np.frombuffer(payload, np.uint8))[None]
    dat = TM.modulate(CHIRP_CFG, DQPSK, torch.from_numpy(bits.astype(np.float32)),
                      t_offset=2 * CHIRP_CFG.symbol_duration).numpy()[0]
    assert dat.shape == gd.shape
    assert np.abs(dat - gd).max() < 2e-3 * np.abs(gd).max()


@pytest.mark.parametrize("mod", [Modulation.DBPSK, Modulation.DQPSK,
                                 Modulation.D8PSK, Modulation.QAM16])
def test_map_bits_to_symbols_matches_jax(mod):
    bits = np.random.default_rng(3).integers(0, 2, size=(3, 700)) \
        .astype(np.float32)
    ours = TM.map_bits_to_symbols(CHIRP_CFG, mod, torch.from_numpy(bits))
    ref = JM.map_bits_to_symbols(CHIRP_CFG, mod, jnp.asarray(bits))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_modulate_with_pilots_matches_jax():
    bits = np.random.default_rng(4).integers(0, 2, size=(2, 300)) \
        .astype(np.float32)
    ours = TM.modulate(PILOT_CFG, Modulation.QPSK, torch.from_numpy(bits),
                       t_offset=100).numpy()
    ref = np.asarray(JM.modulate(PILOT_CFG, Modulation.QPSK,
                                 jnp.asarray(bits), t_offset=100))
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()


def test_tx_frame_matches_jax():
    info, tx = _tx_jax(8, 0)
    tx = np.asarray(tx)
    ours = TP.tx_frame(CHIRP_CFG, DQPSK, R12, torch.from_numpy(info)).numpy()
    assert ours.shape == tx.shape == (8, TP.frame_samples(CHIRP_CFG, DQPSK))
    assert np.abs(ours - tx).max() <= 1e-5 * np.abs(tx).max()


def test_add_noise_with_matches_jax():
    _, tx = _tx_jax(8, 0)
    key = jax.random.PRNGKey(1)
    noise = np.asarray(jax.random.normal(key, tx.shape, jnp.float32))
    ref = np.asarray(JW.add_noise_active(key, tx, 17.0))
    ours = TW.add_noise_with(torch.from_numpy(np.asarray(tx)), 17.0,
                             torch.from_numpy(noise)).numpy()
    # rtol 1e-5, with a floor of one float32 ulp at the signal's peak for
    # the samples where signal and noise cancel to near zero.
    np.testing.assert_allclose(
        ours, ref, rtol=1e-5, atol=np.finfo(np.float32).eps * np.abs(ref).max())


def test_add_noise_active_draws_from_the_generator():
    _, tx = _tx_jax(8, 0)
    x = torch.from_numpy(np.asarray(tx))
    a = TW.add_noise_active(x, 17.0, torch.Generator().manual_seed(5))
    b = TW.add_noise_active(x, 17.0, torch.Generator().manual_seed(5))
    c = TW.add_noise_active(x, 17.0, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # Measured SNR over active samples is 17 dB within sampling error.
    act = x.abs() > 1e-6
    p_sig = (x * x)[act].mean()
    p_noise = ((a - x) ** 2).mean()
    assert abs(10 * np.log10(float(p_sig / p_noise)) - 17.0) < 0.2


# ---------------------------------------------------------------------------
# Demodulator
# ---------------------------------------------------------------------------

def _noisy_frames(cfo):
    """JAX's noisy frames of test_fast_path_matches_scan_path."""
    code = ldpc.get_code(R12)
    info = np.random.default_rng(17).integers(
        0, 2, size=(2, code.k)).astype(np.float32)
    tx = JP.tx_frame(CHIRP_CFG, DQPSK, R12, jnp.asarray(info))
    rx = JW.add_noise_active(jax.random.PRNGKey(3), tx, 12.0)
    if cfo is not None:
        rx = JW.apply_cfo_hilbert(rx, jnp.asarray(cfo))
    return rx


@pytest.mark.parametrize("cfo", [None, [15.0, -20.0]])
def test_demodulate_presynced_matches_jax(cfo):
    rx = _noisy_frames(cfo)
    cfo_j = 0.0 if cfo is None else jnp.asarray(cfo)
    cfo_t = 0.0 if cfo is None else torch.tensor(cfo)
    S = JP.num_data_symbols(CHIRP_CFG, DQPSK, 1)
    ref, ref_state = JD.demodulate_presynced(
        CHIRP_CFG, DQPSK, rx, cfo_j, 0.0, training_symbols=2,
        num_data_symbols=S)
    ours, state = TD.demodulate_presynced(
        CHIRP_CFG, DQPSK, torch.from_numpy(np.asarray(rx)), cfo_t, 0.0,
        training_symbols=2, num_data_symbols=S)
    assert ours.shape == ref.shape == (2, S * 60)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(state.channel_estimate.numpy(),
                               np.asarray(ref_state.channel_estimate),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(state.freq_phase.numpy(),
                               np.asarray(ref_state.freq_phase), rtol=0,
                               atol=1e-4)


def test_lts_channel_estimate_with_pilots_matches_jax():
    rng = np.random.default_rng(8)
    L = PILOT_CFG.symbol_duration
    tr = (40 * rng.standard_normal((3, 2, L))).astype(np.float32)
    cfo = np.array([0.0, 7.5, -30.0], np.float32)
    ref = JD.estimate_channel_from_lts(
        PILOT_CFG, JD.init_state(PILOT_CFG, 3, jnp.asarray(cfo), 0.25),
        jnp.asarray(tr))
    ours = TD.estimate_channel_from_lts(
        PILOT_CFG, TD.init_state(PILOT_CFG, 3, torch.from_numpy(cfo), 0.25,
                                 torch.device("cpu")),
        torch.from_numpy(tr))
    for name in ("channel_estimate", "freq_phase", "estimated_snr_linear",
                 "eq_weights"):
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(ref, name))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)
    assert ours.snr_symbol_count.tolist() == [2, 2, 2]


def test_unported_branches_raise():
    """The branches earlier slices left out now run and equal JAX: QAM64
    on the pilot plan (Tukey scan + high-order noise pass) and QAM16 on
    the no-pilot plan (the coherent refined path), presynced, 30 dB, a
    known 4 Hz CFO.  LLRs atol 2e-4 on the filled carriers, decoded bits
    and ok flags exact."""
    for cfg, mod, rate in ((PILOT_CFG, Modulation.QAM64, CodeRate.R2_3),
                           (CHIRP_CFG, Modulation.QAM16, CodeRate.R1_2)):
        code = ldpc.get_code(rate)
        info = np.random.default_rng(3).integers(
            0, 2, size=(2, code.k)).astype(np.float32)
        tx = JP.tx_frame(cfg, mod, rate, jnp.asarray(info))
        rx = JW.add_noise_active(jax.random.PRNGKey(4),
                                 JW.apply_cfo_hilbert(tx, jnp.full((2,), 4.0)),
                                 30.0)
        S = JP.num_data_symbols(cfg, mod, 1)
        ref, _ = JD.demodulate_presynced(cfg, mod, rx, 4.0, 0.0, 2, S)
        ours, _ = TD.demodulate_presynced(cfg, mod, torch.from_numpy(
            np.asarray(rx)), 4.0, 0.0, 2, S)
        np.testing.assert_allclose(ours.numpy()[:, :648],
                                   np.asarray(ref)[:, :648], rtol=0,
                                   atol=2e-4)
        ref_rx = JP.rx_frame(cfg, mod, rate, rx, 4.0)
        ours_rx = TP.rx_frame(cfg, mod, rate, torch.from_numpy(
            np.asarray(rx)), 4.0)
        for a, b in zip(ours_rx, ref_rx):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert ours_rx[1].all()

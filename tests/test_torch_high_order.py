"""The port's high-order and refined OFDM branches against the JAX package.

NVIS (1024-FFT, 59 carriers, no pilots) frames go through the coherent
refined path, the 512-FFT pilot plan's QAM256 through the scan's
high-order noise pass, both behind Schmidl-Cox acquisition
(``decode_ofdm_cox``) on JAX's noisy buffers, laid out as
tests/test_nvis_waveforms.py:26-49 lays them out.

Tolerances: the host tables (Tukey rows, pilot-to-data weights, signed
bins, live-carrier mask) array-equal; ``cancel_conjugate_image`` rtol 1e-4,
atol 1e-5 of the bins' scale (float32 Dirichlet kernels and complex
matmuls differ by ulps); demodulated LLRs atol 2e-4 plus rtol 1e-4 on the
filled carriers (QAM256's unclipped LLRs are ~2/nv times a distance, so
the per-carrier noise's ulp differences show relatively); detection
exact; decoded bits, ok flags and iteration counts exact.  The SNRs are
the JAX tests' own, where no symbol sits near a decision boundary, so the
hard decisions of the PLL and the LS refits agree.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from projectultra_tpu import config as JC  # noqa: E402
from projectultra_tpu.config import CodeRate, Modulation, bits_per_symbol  # noqa: E402
from projectultra_tpu.fec import ldpc  # noqa: E402
from projectultra_tpu.fec.interleave import channel_interleaver  # noqa: E402
from projectultra_tpu.ofdm import carriers as C  # noqa: E402
from projectultra_tpu.ofdm import demodulator as JD  # noqa: E402
from projectultra_tpu.ofdm import modulator as JM  # noqa: E402
from projectultra_tpu.ofdm import pipeline as JP  # noqa: E402
from projectultra_tpu.ops import ldpc as JL  # noqa: E402
from projectultra_tpu.sim import watterson as JW  # noqa: E402
from projectultra_tpu.sync import schmidl_cox as JSC  # noqa: E402

from projectultra_tpu_torch import config as TC  # noqa: E402
from projectultra_tpu_torch.fec import ldpc as TLC  # noqa: E402
from projectultra_tpu_torch.ofdm import demodulator as TD  # noqa: E402
from projectultra_tpu_torch.ofdm import pipeline as TP  # noqa: E402
from projectultra_tpu_torch.ops import ldpc as TL  # noqa: E402
from projectultra_tpu_torch.sync import schmidl_cox as TSC  # noqa: E402

# (JAX config, the port's own) of the three plans.
PLANS = {"nvis": (JC.nvis_mode(), TC.nvis_mode()),
         "default": (JC.ModemConfig(), TC.ModemConfig()),
         "high_throughput": (JC.high_throughput(), TC.high_throughput())}


def cox_buffers(cfg, mod, rate, snr_db, cfo=0.0, B=2, seed=7, ncw=1):
    """JAX's noisy Cox buffers (tests/test_nvis_waveforms.py:26-43) with
    ``ncw`` codewords per frame -> (info [B, ncw*k], rx [B, T] numpy)."""
    code = ldpc.get_code(rate)
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, size=(B * ncw, code.k)).astype(np.float32)
    cw = np.asarray(JL.encode(code, jnp.asarray(info)))
    cm = C.carrier_map(cfg)
    ci = channel_interleaver(len(cm.data_idx) * bits_per_symbol(mod), code.n)
    inter = cw[:, ci.inv].reshape(B, ncw * code.n)
    pre = JM.generate_preamble(cfg)
    data = JM.modulate(cfg, mod, jnp.asarray(inter),
                       t_offset=JM.preamble_data_t_offset(cfg))
    tx = jnp.concatenate([
        jnp.zeros((B, 3000)),
        jnp.broadcast_to(jnp.asarray(pre), (B, len(pre))),
        data, jnp.zeros((B, 2000))], axis=-1).astype(jnp.float32)
    if cfo:
        tx = JW.apply_cfo_hilbert(tx, jnp.full((B,), cfo))
    rx = JW.add_noise_active(jax.random.PRNGKey(seed), tx, snr_db)
    return info.reshape(B, ncw * code.k), np.asarray(rx)


def assert_llrs_close(ours, ref, n_live):
    np.testing.assert_allclose(ours[:, :n_live], ref[:, :n_live], rtol=1e-4,
                               atol=2e-4)


def decode_both(cfg_j, mod, rate, llr_j, llr_t, ncw):
    """Deinterleave each package's LLRs and decode them with its own
    decoder; the two results must be identical.  Returns (info, ok)."""
    code = ldpc.get_code(rate)
    cm = C.carrier_map(cfg_j)
    ci = channel_interleaver(len(cm.data_idx) * bits_per_symbol(mod), code.n)
    blocks_j = np.asarray(llr_j)[:, :ncw * code.n].reshape(-1, code.n)
    out_j, ok_j, it_j = JL.decode(code, jnp.asarray(blocks_j[:, ci.perm]))
    blocks_t = llr_t[:, :ncw * code.n].reshape(-1, code.n)
    out_t, ok_t, it_t = TL.decode(TLC.get_code(TC.CodeRate(int(rate))),
                                  blocks_t[:, torch.as_tensor(ci.perm)])
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(it_t.numpy(), np.asarray(it_j))
    return out_t.numpy(), ok_t.numpy()


# ---------------------------------------------------------------------------
# Host tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", list(PLANS))
def test_host_tables_match(plan):
    cfg_j, cfg_t = PLANS[plan]
    plen = cfg_t.fft_size + cfg_t.cyclic_prefix
    for L in (cfg_t.symbol_duration, plen, cfg_t.fft_size):
        assert TD._fold_ramp(cfg_t, L) == JD._fold_ramp(cfg_j, L)
        for window in ("rect", "tukey"):
            for a, b in zip(TD._used_bins_w(cfg_t, L, window),
                            JD._used_bins_w(cfg_j, L, window)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TD._used_bins_k(cfg_t),
                                  JD._used_bins_k(cfg_j))
    assert TD.n_data_bins(cfg_t) == JD.n_data_bins(cfg_j)
    if cfg_t.use_pilots:
        np.testing.assert_array_equal(TD._pilot_to_data_interp(cfg_t),
                                      JD._pilot_to_data_interp(cfg_j))
    Cd = TD.n_data_bins(cfg_t)
    for mod in (Modulation.QAM32, Modulation.QAM256):
        for n_bits in (None, 648, 648 * 32):
            S = JD.num_symbols_for_bits(cfg_j, mod, n_bits or 648)
            assert TD.num_symbols_for_bits(cfg_t, mod, n_bits or 648) == S
            np.testing.assert_array_equal(
                TD._live_carrier_mask(mod, S, Cd, n_bits),
                JD._live_carrier_mask(mod, S, Cd, n_bits))


# ---------------------------------------------------------------------------
# Conjugate-image cancellation (QAM256_RX = "real")
# ---------------------------------------------------------------------------

def test_cancel_conjugate_image_matches_jax():
    cfg_j, cfg_t = PLANS["nvis"]
    rng = np.random.default_rng(2)
    B = 3
    Cu = len(JD._used_bins_k(cfg_j))
    fd = ((rng.standard_normal((B, Cu)) + 1j * rng.standard_normal((B, Cu)))
          * 0.3).astype(np.complex64)
    cfo = np.array([0.0, 4.5, -9.0], np.float32)
    phase = np.array([0.1, -2.0, 2.9], np.float32)
    L = cfg_t.symbol_duration
    for t0 in (0, 2 * (cfg_t.fft_size + cfg_t.cyclic_prefix), 123457):
        st_j = JD.init_state(cfg_j, B, jnp.asarray(cfo), jnp.asarray(phase))
        st_t = TD.init_state(cfg_t, B, torch.from_numpy(cfo),
                             torch.from_numpy(phase), torch.device("cpu"))
        ref = np.asarray(JD.cancel_conjugate_image(cfg_j, st_j,
                                                   jnp.asarray(fd), t0, L))
        ours = TD.cancel_conjugate_image(cfg_t, st_t, torch.from_numpy(fd),
                                         t0, L).numpy()
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)
        assert np.abs(ours - fd).max() > 1e-4  # it did cancel something


def test_qam256_real_front_end_matches_jax(monkeypatch):
    """NVIS QAM256 R5/6 at 42 dB and 3 Hz with QAM256_RX = "real" in both
    packages (tests/test_nvis_waveforms.py:113-125): real passband, Tukey
    window and image cancellation on the LTS and every data symbol.  JAX
    reads the switch while tracing, so its compiled functions are dropped
    before and after: a trace of either flavour would serve the other."""
    jax.clear_caches()
    monkeypatch.setattr(JD, "QAM256_RX", "real")
    monkeypatch.setattr(TD, "QAM256_RX", "real")
    try:
        _real_front_case()
    finally:
        jax.clear_caches()


def _real_front_case():
    cfg_j, cfg_t = PLANS["nvis"]
    mod, rate = Modulation.QAM256, CodeRate.R5_6
    info, rx = cox_buffers(cfg_j, mod, rate, 42.0, cfo=3.0, seed=5)
    llr_j, det_j = JSC.decode_ofdm_cox(cfg_j, mod, jnp.asarray(rx), 1)
    llr_t, det_t = TSC.decode_ofdm_cox(cfg_t, mod, torch.from_numpy(rx), 1)
    np.testing.assert_array_equal(det_t["lts_start"].numpy(),
                                  np.asarray(det_j["lts_start"]))
    assert_llrs_close(llr_t.numpy(), np.asarray(llr_j), 648)
    out, ok = decode_both(cfg_j, mod, rate, llr_j, llr_t, 1)
    assert ok.all() and (out == info).all()


# ---------------------------------------------------------------------------
# The refined path (NVIS) and the high-order scan (512 pilot plan)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod,rate,snr,cfo,ncw", [
    (Modulation.QAM32, CodeRate.R3_4, 30.0, 10.0, 1),   # BASELINE #4
    (Modulation.QAM64, CodeRate.R5_6, 36.0, 5.0, 1),
    (Modulation.QAM256, CodeRate.R5_6, 42.0, 10.0, 1),
    (Modulation.QAM256, CodeRate.R5_6, 42.0, 10.0, 32),
])
def test_nvis_refined_path_matches_jax(mod, rate, snr, cfo, ncw):
    """decode_ofdm_cox on NVIS frames, the points of
    tests/test_nvis_waveforms.py, one 32-codeword frame (44 symbols, the
    engine's long frame) among them: detection, LLRs on the filled
    carriers, and each package's decode of its own LLRs."""
    cfg_j, cfg_t = PLANS["nvis"]
    B = 1 if ncw > 1 else 2
    info, rx = cox_buffers(cfg_j, mod, rate, snr, cfo=cfo, B=B, ncw=ncw)
    llr_j, det_j = JSC.decode_ofdm_cox(cfg_j, mod, jnp.asarray(rx), ncw)
    llr_t, det_t = TSC.decode_ofdm_cox(cfg_t, mod, torch.from_numpy(rx), ncw)
    for key in ("found", "lts_start", "data_start"):
        np.testing.assert_array_equal(det_t[key].numpy(),
                                      np.asarray(det_j[key]), err_msg=key)
    assert llr_t.shape == tuple(np.asarray(llr_j).shape)
    assert_llrs_close(llr_t.numpy(), np.asarray(llr_j), 648 * ncw)
    out, ok = decode_both(cfg_j, mod, rate, llr_j, llr_t, ncw)
    k = ldpc.get_code(rate).k
    exact = (out.reshape(B, ncw, k) == info.reshape(B, ncw, k)).all(-1)
    assert (ok.reshape(B, ncw) & exact).mean() >= (0.9 if ncw > 1 else 1.0)


def test_default_plan_qam256_scan_matches_jax():
    """The 512-FFT pilot plan's QAM256 R2/3 at 30 dB
    (tests/test_high_order.py:54-63): the scan's high-order noise pass
    (decision residual, interpolated pilot diffs, instantaneous
    residual)."""
    cfg_j, cfg_t = PLANS["default"]
    mod, rate = Modulation.QAM256, CodeRate.R2_3
    info, rx = cox_buffers(cfg_j, mod, rate, 30.0, B=3, seed=11)
    llr_j, det_j = JSC.decode_ofdm_cox(cfg_j, mod, jnp.asarray(rx), 1)
    llr_t, det_t = TSC.decode_ofdm_cox(cfg_t, mod, torch.from_numpy(rx), 1)
    np.testing.assert_array_equal(det_t["lts_start"].numpy(),
                                  np.asarray(det_j["lts_start"]))
    assert_llrs_close(llr_t.numpy(), np.asarray(llr_j), 648)
    out, ok = decode_both(cfg_j, mod, rate, llr_j, llr_t, 1)
    assert ok.all() and (out == info).all()


def test_turbo_and_balanced_presynced_match_jax():
    """The turbo (QAM256 R5/6) and balanced (QAM64 R3/4) presets' own
    plans, presynced at 40 dB with a 2 Hz CFO: demodulate_presynced's
    window choice (Tukey LTS only at QAM256, Tukey scan at both)."""
    for name in ("turbo", "balanced"):
        cfg_j, cfg_t = getattr(JC, name)(), getattr(TC, name)()
        mod = cfg_j.modulation
        code = ldpc.get_code(cfg_j.code_rate)
        info = np.random.default_rng(9).integers(
            0, 2, size=(2, code.k)).astype(np.float32)
        tx = JP.tx_frame(cfg_j, mod, cfg_j.code_rate, jnp.asarray(info))
        rx = JW.add_noise_active(jax.random.PRNGKey(9),
                                 JW.apply_cfo_hilbert(tx, jnp.full((2,), 2.0)),
                                 40.0)
        S = JP.num_data_symbols(cfg_j, mod, 1)
        ref, _ = JD.demodulate_presynced(cfg_j, mod, rx, 2.0, 0.0, 2, S)
        ours, _ = TD.demodulate_presynced(cfg_t, mod, torch.from_numpy(
            np.array(rx)), 2.0, 0.0, 2, S)
        assert_llrs_close(ours.numpy(), np.asarray(ref), 648)


def test_equalized_symbols_span_matches_jax():
    """The constellation export on an NVIS QAM32 span and a default-plan
    QAM64 span (plen margins)."""
    for plan, mod in (("nvis", Modulation.QAM32),
                      ("default", Modulation.QAM64)):
        cfg_j, cfg_t = PLANS[plan]
        _, rx = cox_buffers(cfg_j, mod, CodeRate.R3_4, 34.0, B=2, seed=3)
        plen = cfg_j.fft_size + cfg_j.cyclic_prefix
        lts = 3000 + 5 * plen
        S = JD.num_symbols_for_bits(cfg_j, mod, 648)
        span = rx[:, lts - plen:lts + 2 * plen + S * cfg_j.symbol_duration
                  + plen]
        ref = np.asarray(JD.equalized_symbols_span(
            cfg_j, mod, jnp.asarray(span), 0.0, 0.0, n_lts=2, S=S, lead=plen,
            tail=plen))
        ours = TD.equalized_symbols_span(cfg_t, mod, torch.from_numpy(span),
                                         0.0, 0.0, n_lts=2, S=S, lead=plen,
                                         tail=plen).numpy()
        assert ours.shape == ref.shape and ours.dtype == np.float32
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def test_decode_cox_batch_on_nvis_matches_jax():
    """The bench's acquisition-inclusive step on NVIS QAM32 R3/4 frames of
    two codewords: decode_cox_batch (detect, cut each lane at its own LTS
    with no margins, demodulate with n_bits, decode) against JAX's
    detect_preamble + demodulate_span over the same cut."""
    cfg_j, cfg_t = PLANS["nvis"]
    mod, rate, ncw = Modulation.QAM32, CodeRate.R3_4, 2
    info, rx = cox_buffers(cfg_j, mod, rate, 30.0, cfo=10.0, B=2, ncw=ncw)
    out, ok, iters, det = TSC.decode_cox_batch(cfg_t, mod, TC.CodeRate.R3_4,
                                               torch.from_numpy(rx), ncw)
    det_j = JSC.detect_preamble(cfg_j, jnp.asarray(rx))
    np.testing.assert_array_equal(det["lts_start"].numpy(),
                                  np.asarray(det_j["lts_start"]))
    plen = cfg_j.fft_size + cfg_j.cyclic_prefix
    S = JD.num_symbols_for_bits(cfg_j, mod, 648 * ncw)
    start = int(np.asarray(det_j["lts_start"])[0])
    assert (np.asarray(det_j["lts_start"]) == start).all()
    span = rx[:, start:start + 2 * plen + S * cfg_j.symbol_duration]
    llr_j, _ = JD.demodulate_span(cfg_j, mod, jnp.asarray(span),
                                  det_j["cfo_hz"], 0.0, n_lts=2, S=S,
                                  n_bits=648 * ncw)
    llr_t = TSC.demodulate_detected(cfg_t, mod, torch.from_numpy(rx), det,
                                    ncw)
    assert_llrs_close(llr_t.numpy(), np.asarray(llr_j), 648 * ncw)
    ref_out, ref_ok = decode_both(cfg_j, mod, rate, llr_j, llr_t, ncw)
    np.testing.assert_array_equal(out.numpy(), ref_out.reshape(2, -1))
    np.testing.assert_array_equal(ok.numpy(), ref_ok.reshape(2, ncw).all(-1))
    assert ok.all() and (out.numpy() == info).all()


def test_tx_cox_frame_of_several_codewords_matches_jax():
    """The port's multi-codeword Cox TX (the layout of cox_buffers, before
    the channel) against JAX's construction: NVIS QAM256 R5/6 at 3
    codewords, within 1e-5 of the peak."""
    cfg_j, cfg_t = PLANS["nvis"]
    mod, rate, ncw = Modulation.QAM256, CodeRate.R5_6, 3
    code = ldpc.get_code(rate)
    info = np.random.default_rng(4).integers(
        0, 2, size=(2 * ncw, code.k)).astype(np.float32)
    cw = np.asarray(JL.encode(code, jnp.asarray(info)))
    ci = channel_interleaver(59 * bits_per_symbol(mod), code.n)
    data = JM.modulate(cfg_j, mod, jnp.asarray(cw[:, ci.inv].reshape(2, -1)),
                       t_offset=JM.preamble_data_t_offset(cfg_j))
    pre = JM.generate_preamble(cfg_j)
    ref = np.concatenate([np.zeros((2, 3000), np.float32),
                          np.tile(pre, (2, 1)), np.asarray(data),
                          np.zeros((2, 2000), np.float32)], axis=-1)
    ours = TP.tx_cox_frame(cfg_t, mod, TC.CodeRate(int(rate)),
                           torch.from_numpy(info.reshape(2, -1)), lead=3000,
                           tail=2000, n_codewords=ncw).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("mod,rate,snr,lane", [
    (Modulation.QAM32, CodeRate.R3_4, 30.0, 24),
    (Modulation.QAM256, CodeRate.R5_6, 42.0, 53)])
def test_parity_free_false_ok_lanes_match_jax(mod, rate, snr, lane):
    """R3/4 and R5/6 leave info bits parity-free (fec/ldpc.build_h_rows
    saturates the check slots early), so an NVIS lane can converge to a
    valid codeword with wrong info bits.  Lane ``lane`` of JAX's 64-lane
    buffer (seed 8, 10 Hz) does so in the JAX package; the port decodes it
    to the same ok flag and the same wrong bits (chip_smoke.py gates such
    points on the ok rate and holds the card's wrong lanes to the CPU)."""
    cfg_j, cfg_t = PLANS["nvis"]
    info, rx = cox_buffers(cfg_j, mod, rate, snr, cfo=10.0, B=64, seed=8)
    rows = [0, lane]
    llr_j, _ = JSC.decode_ofdm_cox(cfg_j, mod, jnp.asarray(rx[rows]), 1)
    llr_t, _ = TSC.decode_ofdm_cox(cfg_t, mod, torch.from_numpy(rx[rows]), 1)
    assert_llrs_close(llr_t.numpy(), np.asarray(llr_j), 648)
    out, ok = decode_both(cfg_j, mod, rate, llr_j, llr_t, 1)
    assert ok.all()
    exact = (out == info[rows]).all(-1)
    assert exact[0] and not exact[1]


@pytest.mark.parametrize("mod", [Modulation.BPSK, Modulation.QPSK,
                                 Modulation.QAM8, Modulation.QAM16,
                                 Modulation.QAM64, Modulation.QAM256])
def test_nvis_presynced_every_coherent_mod_matches_jax(mod):
    """demodulate_presynced on the NVIS plan routes every coherent
    modulation to the refined path (Tukey only at QAM256): presynced
    frames at 36 dB with a known 3 Hz CFO, one lane."""
    cfg_j, cfg_t = PLANS["nvis"]
    code = ldpc.get_code(CodeRate.R1_2)
    info = np.random.default_rng(int(mod)).integers(
        0, 2, size=(1, code.k)).astype(np.float32)
    tx = JP.tx_frame(cfg_j, mod, CodeRate.R1_2, jnp.asarray(info))
    rx = JW.add_noise_active(jax.random.PRNGKey(int(mod)),
                             JW.apply_cfo_hilbert(tx, jnp.full((1,), 3.0)),
                             36.0)
    S = JP.num_data_symbols(cfg_j, mod, 1)
    ref, _ = JD.demodulate_presynced(cfg_j, mod, rx, 3.0, 0.0, 2, S)
    ours, _ = TD.demodulate_presynced(cfg_t, mod, torch.from_numpy(
        np.array(rx)), 3.0, 0.0, 2, S)
    assert_llrs_close(ours.numpy(), np.asarray(ref), 648)

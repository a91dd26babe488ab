"""Multi-carrier DPSK of the PyTorch port against the JAX package and the
reference's goldens, and the bench's chirp-acquisition step.

The noisy arrays are JAX's (its PRNG), fed to both sides as numpy.
Tolerances:

* configs: ``dataclasses.asdict`` equal for every preset; carrier tables
  array-equal; training and reference symbols within 1e-6 of JAX's;
* TX against ``golden_mcdpsk_tx.f32``: 2e-4 (training, reference), 2e-3
  (data); soft bits against ``golden_mcdpsk_meta.txt``: 0.05
  (tests/test_mc_dpsk.py:32-60); ``modulate`` within 1e-4 of JAX's (the
  cumulative phase sums round in another order; they reach ~300 rad,
  where a float32 ulp is 3e-5);
* ``apply_cfo_segment`` (both modes): within 1e-5 of the input's peak;
  the estimators: score 1e-5, SNR 1e-3 dB, residual CFO 1e-3 Hz,
  reference symbols 1e-5; ``demodulate_presynced`` (both modes): LLRs
  within atol 1e-4;
* loopbacks and the chirp step: info bits, ok flags and iterations equal
  lane for lane.

JAX reads ULTRA_CHIRP_BF16 and ULTRA_LDPC_BF16 at import; both are removed
before the JAX package is imported, and every test checks that JAX runs
float32.
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

from projectultra_tpu.config import CodeRate  # noqa: E402
from projectultra_tpu.fec import ldpc  # noqa: E402
from projectultra_tpu.ops import ldpc as JL  # noqa: E402
from projectultra_tpu.psk import mc_dpsk as JMC  # noqa: E402
from projectultra_tpu.sim import watterson as JW  # noqa: E402
from projectultra_tpu.sync import chirp as JC  # noqa: E402
from projectultra_tpu.utils.bits import bytes_to_bits  # noqa: E402

from projectultra_tpu_torch.ops import cuda_ldpc  # noqa: E402
from projectultra_tpu_torch.ops import ldpc as TL  # noqa: E402
from projectultra_tpu_torch.psk import mc_dpsk as TMC  # noqa: E402
from projectultra_tpu_torch.sim import watterson as TW  # noqa: E402

PRESETS = ["level5", "level6", "level7", "level8", "level9", "level10",
           "level11_ultra", "level12_ultra"]
J_CFG, T_CFG = JMC.MCDPSKConfig(), TMC.MCDPSKConfig()
J10, T10 = JMC.level10(), TMC.level10()
R14 = CodeRate.R1_4


@pytest.fixture(autouse=True)
def _float32_reference():
    assert "ULTRA_CHIRP_BF16" not in os.environ
    assert "ULTRA_LDPC_BF16" not in os.environ
    assert JC._BF16 is False
    assert JL._DEFAULT_MSG_DTYPE == jnp.float32


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# Config, tables, TX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS + ["MCDPSKConfig"])
def test_config_matches_jax(preset):
    jc, tc = getattr(JMC, preset)(), getattr(TMC, preset)()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.chirp_config()) == \
        dataclasses.asdict(jc.chirp_config())
    np.testing.assert_array_equal(tc.carrier_freqs(), jc.carrier_freqs())
    for prop in ("bits_per_mc_symbol", "training_samples", "ref_samples"):
        assert getattr(tc, prop) == getattr(jc, prop)
    assert TMC.num_symbols_for_bits(tc, 648) == JMC.num_symbols_for_bits(jc, 648)
    one = dataclasses.replace(tc, num_carriers=1)
    np.testing.assert_array_equal(
        one.carrier_freqs(),
        dataclasses.replace(jc, num_carriers=1).carrier_freqs())


@pytest.mark.parametrize("preset", ["level5", "level10", "level12_ultra",
                                    "MCDPSKConfig"])
def test_host_tables_match_jax(preset):
    jc, tc = getattr(JMC, preset)(), getattr(TMC, preset)()
    np.testing.assert_array_equal(TMC.DQPSK_PHASES, JMC.DQPSK_PHASES)
    for a, b in zip(TMC._carrier_tables(tc), JMC._carrier_tables(jc)):
        np.testing.assert_array_equal(a, b)
    for fn in ("generate_training", "generate_reference"):
        ours, ref = getattr(TMC, fn)(tc), getattr(JMC, fn)(jc)
        assert ours.dtype == ref.dtype == np.float32 and ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6, err_msg=fn)
    for a, b in zip(TMC._clean_training_corr(tc), JMC._clean_training_corr(jc)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    ours, ref = TMC.preamble(tc), JMC.preamble(jc)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def _meta(golden_dir):
    lines = open(os.path.join(golden_dir,
                              "golden_mcdpsk_meta.txt")).read().split("\n")
    payload = bytes.fromhex(lines[0].split()[1])
    hdr = lines[1].split()
    sizes = dict(zip(hdr[::2], hdr[1::2]))
    soft = np.array([float(x) for x in lines[2].split()[1:]], np.float32)
    golden = np.fromfile(os.path.join(golden_dir, "golden_mcdpsk_tx.f32"),
                         dtype=np.float32)
    return payload, sizes, soft, golden


def test_tx_matches_golden(golden_dir):
    """tests/test_mc_dpsk.py:32-48 on the port."""
    payload, sizes, _, golden = _meta(golden_dir)
    tr_n, ref_n = int(sizes["training"]), int(sizes["ref"])
    gt, gr, gd = golden[:tr_n], golden[tr_n:tr_n + ref_n], golden[tr_n + ref_n:]
    assert np.abs(TMC.generate_training(T_CFG) - gt).max() < 2e-4
    assert np.abs(TMC.generate_reference(T_CFG) - gr).max() < 2e-4
    bits = _t(bytes_to_bits(payload)[None, :].astype(np.float32))
    dat = TMC.modulate(T_CFG, bits).numpy()[0]
    assert dat.shape == gd.shape
    assert np.abs(dat - gd).max() < 2e-3


def test_soft_bits_match_golden(golden_dir):
    """tests/test_mc_dpsk.py:51-60 on the port."""
    payload, _, gsoft, golden = _meta(golden_dir)
    n_sym = TMC.num_symbols_for_bits(T_CFG, len(payload) * 8)
    llrs = TMC.demodulate_presynced(T_CFG, _t(golden[None, :]), 0.0, 0.0,
                                    n_sym).numpy()[0]
    assert llrs.shape == gsoft.shape
    assert np.abs(llrs - gsoft).max() < 0.05


@pytest.mark.parametrize("preset,nbits", [("level10", 648), ("level5", 301),
                                          ("MCDPSKConfig", 648)])
def test_modulate_matches_jax(preset, nbits):
    jc, tc = getattr(JMC, preset)(), getattr(TMC, preset)()
    bits = np.random.default_rng(nbits).integers(0, 2, (3, nbits)).astype(
        np.float32)
    ref = np.asarray(JMC.modulate(jc, jnp.asarray(bits)))
    ours = TMC.modulate(tc, _t(bits)).numpy()
    assert ours.shape == ref.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    dbpsk_j = dataclasses.replace(jc, bits_per_symbol=1)
    dbpsk_t = dataclasses.replace(tc, bits_per_symbol=1)
    np.testing.assert_allclose(
        TMC.modulate(dbpsk_t, _t(bits)).numpy(),
        np.asarray(JMC.modulate(dbpsk_j, jnp.asarray(bits))), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# RX building blocks against JAX
# ---------------------------------------------------------------------------

def _noisy_frames(B=4, lead=777, snr=8.0, cfo=0.0, seed=11):
    """tests/test_mc_dpsk.py:137-155: level10 R1/4 frames at an unaligned
    lead, JAX's noise -> (info, rx numpy, n_sym, span_len)."""
    code = ldpc.get_code(R14)
    info = np.random.default_rng(seed).integers(0, 2, (B, code.k)).astype(
        np.float32)
    cw = JL.encode(code, jnp.asarray(info))
    n_sym = JMC.num_symbols_for_bits(J10, code.n)
    pre = np.concatenate([JMC.generate_training(J10),
                          JMC.generate_reference(J10)])
    tx = jnp.concatenate([jnp.zeros((B, lead)),
                          jnp.broadcast_to(jnp.asarray(pre), (B, len(pre))),
                          JMC.modulate(J10, cw), jnp.zeros((B, 900))],
                         axis=-1).astype(jnp.float32)
    if cfo:
        tx = JW.apply_cfo_hilbert(tx, jnp.full((B,), cfo))
    rx = np.asarray(JW.add_noise_active(jax.random.PRNGKey(5), tx, snr))
    span_len = (J10.training_samples + J10.ref_samples
                + n_sym * J10.samples_per_symbol)
    return info, rx, n_sym, span_len


def test_correlate_symbols_matches_jax():
    _, rx, _, _ = _noisy_frames()
    ref = np.asarray(JMC.correlate_symbols(J10, jnp.asarray(rx)))
    ours = TMC.correlate_symbols(T10, _t(rx)).numpy()
    assert ours.shape == ref.shape and ours.dtype == np.complex64
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("cfo", [0.0, 2.5, [30.0, -7.0, 0.05, 88.0]])
def test_apply_cfo_segment_default_mode_matches_jax(cfo):
    _, rx, _, _ = _noisy_frames()
    seg = rx[:, 1000:1000 + 12800]
    cfo_a = np.broadcast_to(np.asarray(cfo, np.float32), (4,)).copy()
    phase = np.array([0.3, -2.0, 3.1, 0.0], np.float32)
    ref = np.asarray(JMC.apply_cfo_segment(jnp.asarray(seg),
                                           jnp.asarray(cfo_a),
                                           jnp.asarray(phase)))
    ours = TMC.apply_cfo_segment(_t(seg), _t(cfo_a), _t(phase)).numpy()
    assert ours.shape == ref.shape == seg.shape
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(seg).max()
    np.testing.assert_array_equal(ours[np.abs(cfo_a) <= 0.1],
                                  seg[np.abs(cfo_a) <= 0.1])


@pytest.mark.parametrize("cfo", [0.0, [30.0, -7.0, 0.05, 88.0]])
def test_apply_cfo_segment_intra_offset_mode_matches_jax(cfo):
    _, rx, _, _ = _noisy_frames()
    seg = rx[:, 640:640 + 13056]
    cfo_a = np.broadcast_to(np.asarray(cfo, np.float32), (4,)).copy()
    phase = np.array([0.3, -2.0, 3.1, 0.0], np.float32)
    r = np.array([0, 137, 255, 9], np.int32)
    ref = np.asarray(JMC.apply_cfo_segment(
        jnp.asarray(seg), jnp.asarray(cfo_a), jnp.asarray(phase),
        intra_offset=jnp.asarray(r), out_len=12800))
    ours = TMC.apply_cfo_segment(_t(seg), _t(cfo_a), _t(phase),
                                 intra_offset=_t(r), out_len=12800).numpy()
    assert ours.shape == ref.shape == (4, 12800)
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(seg).max()


def test_estimators_match_jax():
    """training_score, estimate_snr_db, estimate_residual_cfo and
    reference_symbols on training at several SNRs and a 3 Hz offset."""
    tr = np.broadcast_to(JMC.generate_training(J_CFG),
                         (3, J_CFG.training_samples))
    shifted = JW.apply_cfo_hilbert(jnp.asarray(tr), jnp.asarray([0.0, 3.0, -3.0]))
    for snr in (-5.0, 10.0, 30.0):
        x = np.asarray(JW.add_noise_active(jax.random.PRNGKey(7), shifted, snr))
        np.testing.assert_allclose(
            TMC.training_score(T_CFG, _t(x)).numpy(),
            np.asarray(JMC.training_score(J_CFG, jnp.asarray(x))),
            rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            TMC.estimate_snr_db(T_CFG, _t(x)).numpy(),
            np.asarray(JMC.estimate_snr_db(J_CFG, jnp.asarray(x))),
            rtol=0, atol=1e-3)
        np.testing.assert_allclose(
            TMC.estimate_residual_cfo(T_CFG, _t(x)).numpy(),
            np.asarray(JMC.estimate_residual_cfo(J_CFG, jnp.asarray(x))),
            rtol=0, atol=1e-3)
        ref = x[:, :J_CFG.samples_per_symbol]
        np.testing.assert_allclose(
            TMC.reference_symbols(T_CFG, _t(ref)).numpy(),
            np.asarray(JMC.reference_symbols(J_CFG, jnp.asarray(ref))),
            rtol=0, atol=1e-5)
    silent = np.zeros((2, 512), np.float32)
    np.testing.assert_array_equal(TMC.reference_symbols(T_CFG, _t(silent)).numpy(),
                                  np.ones((2, 8), np.complex64))


@pytest.mark.parametrize("cfo", [0.0, 2.5, 30.0])
def test_demodulate_presynced_both_modes_match_jax(cfo):
    """The exact-slice (golden) route and the aligned over-slice with
    intra_offset (tests/test_mc_dpsk.py:137-184), on the same buffers."""
    info, rx, n_sym, span_len = _noisy_frames(cfo=cfo)
    B, T = rx.shape
    tr = np.full(B, 777, np.int32)
    cfo_a = np.full(B, cfo, np.float32)
    exact = rx[:, 777:777 + span_len]
    ref = np.asarray(JMC.demodulate_presynced(
        J10, jnp.asarray(exact), jnp.asarray(cfo_a),
        jnp.asarray(tr, jnp.float32), n_sym))
    ours = TMC.demodulate_presynced(T10, _t(exact), _t(cfo_a),
                                    _t(tr.astype(np.float32)), n_sym).numpy()
    assert ours.shape == ref.shape == (B, n_sym * T10.bits_per_mc_symbol)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)

    # The bench's 128-aligned over-slice (bench.py:200-218).
    s0 = 777 // 128 * 128
    span_pad = -(-(span_len + 256) // 128) * 128
    span, r = rx[:, s0:s0 + span_pad], (tr - s0).astype(np.int32)
    ref_fast = np.asarray(JMC.demodulate_presynced(
        J10, jnp.asarray(span), jnp.asarray(cfo_a),
        jnp.asarray(tr, jnp.float32), n_sym, intra_offset=jnp.asarray(r)))
    fast = TMC.demodulate_presynced(T10, _t(span), _t(cfo_a),
                                    _t(tr.astype(np.float32)), n_sym,
                                    intra_offset=_t(r)).numpy()
    np.testing.assert_allclose(fast, ref_fast, rtol=0, atol=1e-4)
    code = ldpc.get_code(R14)
    for llrs in (ours, fast):
        out, ok, _ = TL.decode(code, _t(llrs[:, :code.n]))
        assert ok.all() and np.array_equal(out.numpy(), info.astype(np.uint8))


# ---------------------------------------------------------------------------
# Loopbacks and the chirp step against JAX
# ---------------------------------------------------------------------------

def _loopback_both(channel, cfo_for_rx=0.0, B=8, seed=0):
    """tests/test_mc_dpsk.py:63-79 on both sides: JAX's TX through JAX's
    channel, then each side's demodulator and decoder."""
    code = ldpc.get_code(R14)
    info = np.random.default_rng(seed).integers(0, 2, (B, code.k)).astype(
        np.float32)
    cw = JL.encode(code, jnp.asarray(info))
    pre = np.concatenate([JMC.generate_training(J_CFG),
                          JMC.generate_reference(J_CFG)])
    tx = jnp.concatenate([jnp.broadcast_to(jnp.asarray(pre), (B, len(pre))),
                          JMC.modulate(J_CFG, cw)], axis=-1)
    rx = np.asarray(channel(tx))
    n_sym = JMC.num_symbols_for_bits(J_CFG, 648)
    cfo = np.full(B, cfo_for_rx, np.float32)
    llr_j = JMC.demodulate_presynced(J_CFG, jnp.asarray(rx), jnp.asarray(cfo),
                                     jnp.zeros(B), n_sym)
    ref = JL.decode(code, llr_j[:, :648])
    llr_t = TMC.demodulate_presynced(T_CFG, _t(rx), _t(cfo), torch.zeros(B),
                                     n_sym)
    np.testing.assert_allclose(llr_t.numpy(), np.asarray(llr_j), rtol=0,
                               atol=1e-4)
    ours = TL.decode(code, llr_t[:, :648])
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ours[1].all()
    np.testing.assert_array_equal(ours[0].numpy(), info.astype(np.uint8))


def test_loopback_awgn_5db_matches_jax():
    key = jax.random.PRNGKey(3)
    _loopback_both(lambda tx: JW.add_noise_active(key, tx, 5.0))


def test_loopback_awgn_5db_cfo30_matches_jax():
    key = jax.random.PRNGKey(4)

    def chan(tx):
        shifted = JW.apply_cfo_hilbert(tx, jnp.full((tx.shape[0],), 30.0))
        return JW.add_noise_active(key, shifted, 5.0)

    _loopback_both(chan, cfo_for_rx=30.0)


def _bench_tx(B, seed=7):
    """The bench's frames (bench.py:178-192) from JAX -> (info, tx)."""
    code = ldpc.get_code(R14)
    info = np.random.default_rng(seed).integers(0, 2, (B, code.k)).astype(
        np.float32)
    cw = JL.encode(code, jnp.asarray(info))
    pre = np.concatenate([JC.generate(J10.chirp_config()),
                          JMC.generate_training(J10),
                          JMC.generate_reference(J10)])
    tx = jnp.concatenate([jnp.zeros((B, 4800)),
                          jnp.broadcast_to(jnp.asarray(pre), (B, len(pre))),
                          JMC.modulate(J10, cw), jnp.zeros((B, 4000))],
                         axis=-1).astype(jnp.float32)
    return info, tx


def test_tx_chirp_frame_matches_the_bench_construction():
    info, tx = _bench_tx(3)
    ours = TMC.tx_chirp_frame(T10, R14, _t(info)).numpy()
    tx = np.asarray(tx)
    assert ours.shape == tx.shape == (3, 83808)
    assert TMC.frame_samples(T10, R14) == 83808
    np.testing.assert_allclose(ours, tx, rtol=0, atol=1e-5)


def _jax_chirp_step(rx, align):
    """bench.py:207-223 composed from JAX functions; ``align=None`` is the
    same chain with an exact per-row dynamic slice and no intra_offset."""
    cc = J10.chirp_config()
    code = ldpc.get_code(R14)
    n_sym = JMC.num_symbols_for_bits(J10, code.n)
    span_len = J10.training_samples + J10.ref_samples + n_sym * 512
    B, T = rx.shape
    det = JC.detect_dual_chirp(cc, rx, threshold=J10.chirp_threshold)
    tr = JC.training_start(cc, det["down_chirp_start"])
    if align is None:
        span = jax.vmap(lambda b, s: jax.lax.dynamic_slice(
            b, (s,), (span_len,)))(rx, tr)
        r = None
    else:
        span_pad = -(-(span_len + 2 * align) // align) * align
        Tb = T // align
        rxb = rx[:, :Tb * align].reshape(B, Tb, align)
        s0 = jnp.clip((tr // align) * align, 0, Tb * align - span_pad)
        r = jnp.clip(tr - s0, 0, span_pad - span_len - 1)
        span = jax.vmap(lambda b, s: jax.lax.dynamic_slice(
            b, (s, 0), (span_pad // align, align)))(rxb, s0 // align) \
            .reshape(B, span_pad)
    llrs = JMC.demodulate_presynced(J10, span, det["cfo_hz"],
                                    tr.astype(jnp.float32), n_sym,
                                    intra_offset=r)
    out, ok, iters = JL.decode(code, llrs[:, :code.n])
    return out, ok & det["success"], iters, det


@pytest.mark.parametrize("align", [128, None])
def test_chirp_step_matches_jax(align):
    """decode_chirp_batch (an exact per-row gather) at B = 4 on JAX's 5 dB
    bench buffers (T = 83,808; the first lane also carries a 30 Hz CFO)
    against the bench's step composed from JAX functions, with its aligned
    gather and with an exact one."""
    info, tx = _bench_tx(4, seed=8)
    tx = tx.at[0].set(JW.apply_cfo_hilbert(tx[0], 30.0))
    rx = JW.add_noise_active(jax.random.PRNGKey(3), tx, 5.0)
    ref = _jax_chirp_step(rx, align)
    before = cuda_ldpc.launches
    out, ok, iters, det = TMC.decode_chirp_batch(T10, R14, _t(rx))
    assert cuda_ldpc.launches == before
    for key in ("success", "up_chirp_start", "down_chirp_start", "cfo_hz"):
        np.testing.assert_array_equal(det[key].numpy(), np.asarray(ref[3][key]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(ref[2]))
    assert ok.all()
    np.testing.assert_array_equal(out.numpy(), info.astype(np.uint8))
    assert abs(float(det["cfo_hz"][0]) - 30.0) < 2.0


def test_chirp_step_on_a_fading_buffer_matches_jax():
    """One JAX-made harness_moderate 5 dB buffer of the bench's frames
    (B = 16, key 2): detection, info bits, ok flags and iterations equal
    lane for lane.  Lane 7 is deeply faded: both packages decode it to
    another codeword and flag it ok (the LDPC code's undetected error), so
    on fading a false ok is the reference's own behaviour."""
    info, tx = _bench_tx(16, seed=2)
    rx = JW.watterson(jax.random.PRNGKey(2), tx, JW.harness_moderate(5.0))
    ref = _jax_chirp_step(rx, None)
    out, ok, iters, det = TMC.decode_chirp_batch(T10, R14, _t(rx))
    for key in ("success", "up_chirp_start", "down_chirp_start", "cfo_hz"):
        np.testing.assert_array_equal(det[key].numpy(), np.asarray(ref[3][key]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(ref[2]))
    exact = (out.numpy() == info.astype(np.uint8)).all(-1)
    assert ok.all()
    assert np.flatnonzero(~exact).tolist() == [7]


def test_port_chirp_loopback_5db_decodes_all_frames():
    """The port's own bench frames, 5 dB noise from a torch.Generator."""
    g = torch.Generator().manual_seed(21)
    info = torch.randint(0, 2, (6, ldpc.get_code(R14).k), generator=g,
                         dtype=torch.uint8)
    rx = TW.add_noise_active(TMC.tx_chirp_frame(T10, R14, info), 5.0, g)
    out, ok, iters, det = TMC.decode_chirp_batch(T10, R14, rx)
    assert ok.all() and torch.equal(out, info)
    tr_true = 4800 + len(JC.generate(J10.chirp_config()))
    tr = det["down_chirp_start"] + 24000 + 4800
    assert int((tr - tr_true).abs().max()) <= 24

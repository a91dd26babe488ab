"""The port's single-carrier DPSK (psk/dpsk.py) against the JAX package.

Frames as the JAX sweep's DPSK point lays them out
(parallel/sweep.py:172-199: 4,800 lead samples, preamble, one R1/4
codeword, 4,000 tail samples), with JAX's AWGN, at the regression
matrix's two rows: ``medium`` (DQPSK 62.5 baud) at 0 dB and ``robust``
(DBPSK, 1,536 samples a symbol) at -11 dB, one frame of the latter.

Tolerances: TX against the reference golden as tests/test_dpsk.py holds
JAX (1.5e-3 preamble, 2e-2 data: the reference's float32 NCO drifts) and
against JAX at 5e-4 (the float32 cumulative phase reaches ~2,000 rad over
``robust``'s 648 symbols, where one ulp is 1.2e-4 rad); symbol
correlations rtol 1e-4; preamble search: found and data_start exact, CFO
within 1e-3 Hz, initial phase within 1e-4 rad, reference symbol rtol 1e-4;
soft LLRs atol 1e-4 (confidence <= 5 times a sine); decoded bits, ok flags
and iteration counts exact.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from projectultra_tpu.config import CodeRate  # noqa: E402
from projectultra_tpu.fec import ldpc  # noqa: E402
from projectultra_tpu.ops import ldpc as JL  # noqa: E402
from projectultra_tpu.psk import dpsk as JD  # noqa: E402
from projectultra_tpu.sim import watterson as JW  # noqa: E402
from projectultra_tpu.utils.bits import bytes_to_bits  # noqa: E402

from projectultra_tpu_torch import config as TC  # noqa: E402
from projectultra_tpu_torch.psk import dpsk as TD  # noqa: E402

LEAD, TAIL = 4800, 4000
PRESETS = ["robust", "low_snr", "medium", "fast", "turbo", "high_speed",
           "speed1", "speed2", "speed3", "speed4", "max_speed"]


def _t(x):
    return torch.from_numpy(np.array(x))


def sweep_frames(preset, snr_db, B, seed=42):
    """(info [B, k], rx [B, T]) of run_point_dpsk's frames."""
    cfg = getattr(JD, preset)()
    code = ldpc.get_code(CodeRate.R1_4)
    info = np.random.default_rng(seed).integers(
        0, 2, size=(B, code.k)).astype(np.float32)
    cw = JL.encode(code, jnp.asarray(info))
    pre = JD.generate_preamble(cfg)
    tx = jnp.concatenate([
        jnp.zeros((B, LEAD)), jnp.broadcast_to(jnp.asarray(pre), (B, len(pre))),
        JD.modulate(cfg, cw), jnp.zeros((B, TAIL))], axis=-1).astype(
            jnp.float32)
    rx = JW.add_noise_active(jax.random.PRNGKey(seed), tx, snr_db)
    return info, np.asarray(rx)


def assert_detection_equal(ours, ref):
    found, ds, cfo, ipo, prev = (x.numpy() for x in ours)
    r_found, r_ds, r_cfo, r_ipo, r_prev = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(found, r_found)
    np.testing.assert_array_equal(ds, r_ds)
    assert ds.dtype == np.int32
    np.testing.assert_allclose(cfo, r_cfo, rtol=0, atol=1e-3)
    np.testing.assert_allclose(ipo, r_ipo, rtol=0, atol=1e-4)
    np.testing.assert_allclose(prev, r_prev, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_and_tables_match(preset):
    ours, ref = getattr(TD, preset)(), getattr(JD, preset)()
    for f in ("sample_rate", "carrier_freq", "samples_per_symbol", "rolloff",
              "use_pulse_shaping"):
        assert getattr(ours, f) == getattr(ref, f), f
    assert int(ours.modulation) == int(ref.modulation)
    for p in ("bits_per_symbol", "symbol_rate", "preamble_symbols",
              "preamble_samples"):
        assert getattr(ours, p) == getattr(ref, p), p
    v = np.arange(8)
    np.testing.assert_array_equal(ours.phase_increment(v),
                                  ref.phase_increment(v))
    for name in ("generate_preamble", "generate_training",
                 "generate_reference", "_pulse_shape"):
        np.testing.assert_array_equal(getattr(TD, name)(ours),
                                      getattr(JD, name)(ref), err_msg=name)


def _meta(golden_dir):
    lines = open(os.path.join(golden_dir, "golden_dpsk_meta.txt")).read() \
        .split("\n")
    payload = bytes.fromhex(lines[0].split()[1])
    hdr = lines[1].split()
    return payload, dict(zip(hdr[::2], hdr[1::2]))


def test_tx_matches_golden_and_jax(golden_dir):
    """``fast`` (DQPSK 125 baud), the golden's preset
    (tests/test_dpsk.py:31-56)."""
    payload, meta = _meta(golden_dir)
    golden = np.fromfile(os.path.join(golden_dir, "golden_dpsk_tx.f32"),
                         dtype=np.float32)
    pre_n = int(meta["pre"])
    cfg = TD.fast()
    assert np.abs(TD.generate_preamble(cfg) - golden[:pre_n]).max() < 1.5e-3
    bits = bytes_to_bits(payload)[None, :].astype(np.float32)
    ours = TD.modulate(cfg, torch.from_numpy(bits)).numpy()[0]
    assert ours.shape == golden[pre_n:].shape
    assert np.abs(ours - golden[pre_n:]).max() < 2e-2
    for preset in ("robust", "fast", "turbo"):
        info = np.random.default_rng(1).integers(0, 2, (2, 648)) \
            .astype(np.float32)
        ref = np.asarray(JD.modulate(getattr(JD, preset)(),
                                     jnp.asarray(info), 0.5))
        ours = TD.modulate(getattr(TD, preset)(), torch.from_numpy(info),
                           0.5).numpy()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=5e-4)


def test_find_preamble_and_soft_match_golden(golden_dir):
    """The reference's own TX in silence (tests/test_dpsk.py:59-76)."""
    payload, meta = _meta(golden_dir)
    golden = np.fromfile(os.path.join(golden_dir, "golden_dpsk_tx.f32"),
                         dtype=np.float32)
    full = np.concatenate([np.zeros(2000, np.float32), golden,
                           np.zeros(8000, np.float32)])[None]
    ref = JD.find_preamble(JD.fast(), jnp.asarray(full))
    ours = TD.find_preamble(TD.fast(), torch.from_numpy(full))
    assert_detection_equal(ours, ref)
    ds = int(ours[1][0])
    data = full[:, ds:ds + int(meta["dat"])]
    ref_llr = JD.demodulate_soft(JD.fast(), jnp.asarray(data), ref[4],
                                 ref[2], ref[3])
    llr = TD.demodulate_soft(TD.fast(), torch.from_numpy(data), ours[4],
                             ours[2], ours[3])
    np.testing.assert_allclose(llr.numpy(), np.asarray(ref_llr), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("preset,snr,B", [("medium", 0.0, 2),
                                          ("robust", -11.0, 1)])
def test_decode_dpsk_batch_matches_jax(preset, snr, B):
    """run_point_dpsk's device path in both packages on JAX's buffers:
    the preamble search, the per-row span, the soft LLRs, the decode."""
    info, rx = sweep_frames(preset, snr, B)
    cfg_j, cfg_t = getattr(JD, preset)(), getattr(TD, preset)()
    ref = JD.find_preamble(cfg_j, jnp.asarray(rx))
    out, ok, iters, det = TD.decode_dpsk_batch(cfg_t, TC.CodeRate.R1_4,
                                               torch.from_numpy(rx))
    assert_detection_equal((det["found"], det["data_start"], det["cfo_hz"],
                            det["initial_phase_offset"], det["prev_symbol"]),
                           ref)
    code = ldpc.get_code(CodeRate.R1_4)
    n = -(-code.n // cfg_j.bits_per_symbol) * cfg_j.samples_per_symbol
    ds = np.asarray(ref[1])
    span = np.stack([rx[b, ds[b]:ds[b] + n] for b in range(B)])
    ref_llr = JD.demodulate_soft(cfg_j, jnp.asarray(span), ref[4], ref[2],
                                 ref[3])
    llr = TD.demodulate_soft(cfg_t, torch.from_numpy(span), det["prev_symbol"],
                             det["cfo_hz"], det["initial_phase_offset"])
    np.testing.assert_allclose(llr.numpy(), np.asarray(ref_llr), rtol=0,
                               atol=1e-4)
    r_out, r_ok, r_it = JL.decode(code, ref_llr[:, :code.n])
    np.testing.assert_array_equal(out.numpy(), np.asarray(r_out))
    np.testing.assert_array_equal(ok.numpy(),
                                  np.asarray(r_ok) & np.asarray(ref[0]))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(r_it))
    assert ok.all() and (out.numpy() == info).all()


def test_preamble_search_with_valid_len_and_cfo_matches_jax():
    """A 12 Hz CFO (the matched-filter refine is off) and a streaming
    buffer whose valid length stops inside the second of two frames."""
    cfg_j, cfg_t = JD.fast(), TD.fast()
    pre = JD.generate_preamble(cfg_j)
    info = np.random.default_rng(5).integers(0, 2, (1, 648)) \
        .astype(np.float32)
    frame = np.concatenate([pre, np.asarray(JD.modulate(cfg_j,
                                                        jnp.asarray(info)))[0]])
    buf = np.zeros((2, 3000 + 2 * len(frame) + 1000), np.float32)
    buf[:, 3000:3000 + len(frame)] = frame
    buf[1, 3000 + len(frame):3000 + 2 * len(frame)] = frame
    x = JW.add_noise_active(jax.random.PRNGKey(3),
                            JW.apply_cfo_hilbert(jnp.asarray(buf),
                                                 jnp.asarray([12.0, -7.0])),
                            6.0)
    valid = np.array([buf.shape[1], 3000 + len(frame) + len(pre) // 2],
                     np.int32)
    for vl in (None, valid):
        ref = JD.find_preamble(cfg_j, x, valid_len=None if vl is None
                               else jnp.asarray(vl))
        ours = TD.find_preamble(cfg_t, _t(x), valid_len=None if vl is None
                                else torch.from_numpy(vl))
        assert_detection_equal(ours, ref)
        assert ours[0].all()


def test_training_and_snr_estimators_match_jax():
    cfg_j, cfg_t = JD.medium(), TD.medium()
    tr = np.tile(JD.generate_training(cfg_j), (3, 1))
    ref_sym = np.tile(JD.generate_reference(cfg_j), (3, 1))
    x = JW.add_noise_active(jax.random.PRNGKey(1), JW.apply_cfo_hilbert(
        jnp.asarray(tr), jnp.asarray([0.0, 3.0, -6.0])), 8.0)
    np.testing.assert_allclose(
        TD.correlate_symbols(cfg_t, _t(x)).numpy(),
        np.asarray(JD.correlate_symbols(cfg_j, x)), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(
        TD.estimate_cfo_from_training(cfg_t, _t(x)).numpy(),
        np.asarray(JD.estimate_cfo_from_training(cfg_j, x)), atol=1e-3)
    ref = JD.set_reference_with_training(cfg_j, x, jnp.asarray(ref_sym))
    ours = TD.set_reference_with_training(cfg_t, _t(x), _t(ref_sym))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-3)
    pre = np.tile(JD.generate_preamble(cfg_j), (3, 1))
    xp = JW.add_noise_active(jax.random.PRNGKey(2), JW.apply_cfo_hilbert(
        jnp.asarray(pre), jnp.asarray([0.0, 2.0, -4.0])), 5.0)
    cfo = jnp.asarray([0.0, 1.9, -4.1])
    np.testing.assert_allclose(
        TD.estimate_preamble_snr_db(cfg_t, _t(xp), _t(cfo)).numpy(),
        np.asarray(JD.estimate_preamble_snr_db(cfg_j, xp, cfo)), atol=1e-3)

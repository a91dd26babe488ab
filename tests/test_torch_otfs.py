"""The port's OTFS modem (otfs/otfs.py) against the JAX package.

Frames and channels are JAX's (tests/test_otfs.py): the default
OTFSConfig, QPSK, one R1/4 codeword per frame, 20 dB AWGN, Watterson
good(25), and detection on zero-padded buffers (4,000 lead, 2,000 tail
samples) at 12 dB.

Tolerances: the preamble and host tables array-equal; the transforms and
TX rtol 1e-5 of the signal's peak (float32 FFTs and contractions differ by
ulps); LLRs atol 1e-3 (DD symbols normalized to unit power, demapped at
nv = 0.1, so an LLR is ~28 times a symbol and a symbol's 1e-5 is 3e-4);
detection found and start exact; ok flags and iteration counts exact,
decoded bits exact on the lanes that decode (a lane that never converges
ends 50 iterations of oscillation on bits that ulp-level LLR differences
move).  The DD cells a frame leaves empty demap to +-0.001, the clip
floor, with the sign of ulp-level noise: they are held by magnitude.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from projectultra_tpu.config import CodeRate, Modulation  # noqa: E402
from projectultra_tpu.fec import ldpc  # noqa: E402
from projectultra_tpu.ops import ldpc as JL  # noqa: E402
from projectultra_tpu.otfs import otfs as JO  # noqa: E402
from projectultra_tpu.sim import watterson as JW  # noqa: E402
from projectultra_tpu.utils.bits import bytes_to_bits  # noqa: E402

from projectultra_tpu_torch import config as TC  # noqa: E402
from projectultra_tpu_torch.otfs import otfs as TO  # noqa: E402

CFG_J, CFG_T = JO.OTFSConfig(), TO.OTFSConfig()
CODE = ldpc.get_code(CodeRate.R1_4)


def _t(x):
    return torch.from_numpy(np.array(x))


def frames(B, seed):
    info = np.random.default_rng(seed).integers(
        0, 2, size=(B, CODE.k)).astype(np.float32)
    cw = JL.encode(CODE, jnp.asarray(info))
    return info, cw, JO.frame_tx(CFG_J, Modulation.QPSK, cw)


def test_tables_and_transforms_match():
    for f in ("sym_len", "preamble_len", "frame_len"):
        assert getattr(CFG_T, f) == getattr(CFG_J, f)
    assert CFG_T.bits_per_frame() == CFG_J.bits_per_frame()
    np.testing.assert_array_equal(TO.sync_sequence(CFG_T),
                                  JO.sync_sequence(CFG_J))
    np.testing.assert_array_equal(TO.generate_preamble(CFG_T),
                                  JO.generate_preamble(CFG_J))
    for fn in ("_synthesis_ri", "_analysis_ri"):
        for a, b in zip(getattr(TO, fn)(CFG_T, 0, 3),
                        getattr(JO, fn)(CFG_J, 0, 3)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    dd = (rng.standard_normal((2, 32, 16))
          + 1j * rng.standard_normal((2, 32, 16))).astype(np.complex64)
    tf_ref = np.asarray(JO.isfft(jnp.asarray(dd)))
    tf = TO.isfft(torch.from_numpy(dd)).numpy()
    np.testing.assert_allclose(tf, tf_ref, rtol=0,
                               atol=1e-5 * np.abs(tf_ref).max())
    back = TO.sfft(torch.from_numpy(tf)).numpy()
    np.testing.assert_allclose(back, np.asarray(JO.sfft(jnp.asarray(tf))),
                               rtol=0, atol=1e-5 * np.abs(back).max())
    np.testing.assert_allclose(back, dd, atol=1e-4)


def test_tx_matches_golden_and_jax(golden_dir):
    """Preamble + one QPSK frame against the reference golden
    (tests/test_otfs.py:20-42) and JAX's TX; the golden's RX interop."""
    import os
    lines = open(os.path.join(golden_dir, "golden_otfs_meta.txt")).read() \
        .split("\n")
    payload = bytes.fromhex(lines[0].split()[1])
    golden = np.fromfile(os.path.join(golden_dir, "golden_otfs_tx.f32"),
                         dtype=np.float32)
    bits = bytes_to_bits(payload)[None, :].astype(np.float32)
    tx = TO.frame_tx(CFG_T, Modulation.QPSK, torch.from_numpy(bits)).numpy()
    assert tx.shape == (1, golden.shape[0])
    assert np.abs(tx[0] - golden).max() < 2e-3
    ref = np.asarray(JO.frame_tx(CFG_J, Modulation.QPSK, jnp.asarray(bits)))
    np.testing.assert_allclose(tx, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(
        TO.map_bits_to_dd(CFG_T, Modulation.QPSK, torch.from_numpy(bits))
        .numpy(), np.asarray(JO.map_bits_to_dd(CFG_J, Modulation.QPSK,
                                               jnp.asarray(bits))))
    llr = TO.demodulate_frame(CFG_T, Modulation.QPSK,
                              torch.from_numpy(golden[None])).numpy()
    ref = np.asarray(JO.demodulate_frame(CFG_J, Modulation.QPSK,
                                         jnp.asarray(golden[None])))
    n = bits.shape[1]
    np.testing.assert_allclose(llr[:, :n], ref[:, :n], rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.abs(llr[:, n:]), np.abs(ref[:, n:]),
                               rtol=0, atol=1e-3)
    assert ((llr[0, :bits.shape[1]] < 0) == bits[0].astype(bool)).all()


def assert_decodes_equal(ours, ref):
    """(info, ok, iters) of both packages: ok and iters exact, bits on the
    lanes that decode."""
    (out, ok, it), (r_out, r_ok, r_it) = ours, ref
    np.testing.assert_array_equal(ok.numpy(), np.asarray(r_ok))
    np.testing.assert_array_equal(it.numpy(), np.asarray(r_it))
    good = ok.numpy()
    np.testing.assert_array_equal(out.numpy()[good], np.asarray(r_out)[good])


@pytest.mark.parametrize("channel,tf_eq", [("awgn", True), ("good", True),
                                           ("good", False)])
def test_demodulate_frame_matches_jax(channel, tf_eq):
    """tests/test_otfs.py's loopbacks: 20 dB AWGN, and Watterson good(25)
    with and without TF equalization (OTFS_EQ / OTFS_RAW)."""
    cfg_j = JO.OTFSConfig(tf_equalization=tf_eq)
    cfg_t = TO.OTFSConfig(tf_equalization=tf_eq)
    info, cw, tx = frames(4, 0)
    if channel == "awgn":
        rx = JW.add_noise_active(jax.random.PRNGKey(1), tx, 20.0)
    else:
        rx = JW.watterson(jax.random.PRNGKey(2), tx, JW.good(25.0))
    ref = JO.demodulate_frame(cfg_j, Modulation.QPSK, rx)
    ours = TO.demodulate_frame(cfg_t, Modulation.QPSK, _t(rx))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-3)
    out, ok, it = TO.ldpc_ops.decode(
        TO.ldpc_codes.get_code(TC.CodeRate.R1_4), ours[:, :648].contiguous())
    assert_decodes_equal((out, ok, it), JL.decode(CODE, ref[:, :648]))
    if channel == "awgn":
        assert ok.all() and (out.numpy() == info).all()


def test_detect_and_decode_otfs_batch_match_jax():
    """detect_frame on zero-padded 12 dB buffers (tests/test_otfs.py:
    126-146) and the port's detect -> cut -> demodulate -> decode step on
    them against JAX's detect_frame and demodulate_frame."""
    info, _, tx = frames(3, 5)
    sig = np.concatenate([np.zeros((3, 4000), np.float32), np.asarray(tx),
                          np.zeros((3, 2000), np.float32)], axis=-1)
    noisy = np.asarray(JW.add_noise_active(jax.random.PRNGKey(2),
                                           jnp.asarray(sig), 12.0))
    found_j, start_j = JO.detect_frame(CFG_J, jnp.asarray(noisy))
    out, ok, it, found, start = TO.decode_otfs_batch(
        CFG_T, Modulation.QPSK, TC.CodeRate.R1_4, torch.from_numpy(noisy))
    np.testing.assert_array_equal(found.numpy(), np.asarray(found_j))
    np.testing.assert_array_equal(start.numpy(), np.asarray(start_j))
    assert start.dtype == torch.int32
    st = np.asarray(start_j)
    span = np.stack([noisy[b, s:s + CFG_J.frame_len] for b, s in enumerate(st)])
    ref = JO.demodulate_frame(CFG_J, Modulation.QPSK, jnp.asarray(span))
    r_out, r_ok, r_it = JL.decode(CODE, ref[:, :648])
    assert_decodes_equal((out, ok, it), (r_out, np.asarray(r_ok)
                                         & np.asarray(found_j), r_it))
    clean = np.concatenate([np.zeros((1, 4000), np.float32),
                            np.asarray(tx)[:1],
                            np.zeros((1, 2000), np.float32)], axis=-1)
    for a, b in zip(TO.detect_frame(CFG_T, torch.from_numpy(clean)),
                    JO.detect_frame(CFG_J, jnp.asarray(clean))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_late_fine_timing_lanes_match_jax():
    """detect_frame -> demodulate_frame at 20 dB on padded buffers: the
    0.98 rule's first crossing inside the preamble plateau lands lanes 1
    and 7 of seed 1 150 and 96 samples late, past the CP, and they fail
    in the JAX package; the port lands them alike and fails them alike."""
    B = 8
    info = np.random.default_rng(1).integers(
        0, 2, size=(B, CODE.k)).astype(np.float32)
    tx = np.asarray(JO.frame_tx(CFG_J, Modulation.QPSK,
                                JL.encode(CODE, jnp.asarray(info))))
    sig = np.concatenate([np.zeros((B, 4000), np.float32), tx,
                          np.zeros((B, 2000), np.float32)], axis=-1)
    noisy = np.asarray(JW.add_noise_active(jax.random.PRNGKey(1),
                                           jnp.asarray(sig), 20.0))
    found_j, start_j = JO.detect_frame(CFG_J, jnp.asarray(noisy))
    out, ok, it, found, start = TO.decode_otfs_batch(
        CFG_T, Modulation.QPSK, TC.CodeRate.R1_4, torch.from_numpy(noisy))
    np.testing.assert_array_equal(start.numpy(), np.asarray(start_j))
    assert (start.numpy()[[1, 7]] - 4000).tolist() == [150, 96]
    span = np.stack([noisy[b, s:s + CFG_J.frame_len]
                     for b, s in enumerate(np.asarray(start_j))])
    r_out, r_ok, r_it = JL.decode(CODE, JO.demodulate_frame(
        CFG_J, Modulation.QPSK, jnp.asarray(span))[:, :648])
    assert_decodes_equal((out, ok, it), (r_out, np.asarray(r_ok)
                                         & np.asarray(found_j), r_it))
    assert np.nonzero(~ok.numpy())[0].tolist() == [1, 7]

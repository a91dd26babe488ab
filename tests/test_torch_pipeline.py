"""The slice as a whole: the PyTorch port's frame pipeline against JAX.

JAX's tx_frame -> JAX's add_noise_active (key 1, 17 dB, B=8) -> the
port's rx_frame must give exactly JAX rx_frame's bits, ok flags and
iteration counts, both with the port's own constant tables and with
tables built by the JAX package's numpy builders.  A clean 3-codeword
frame decodes exactly, and the port's own loopback with a torch.Generator
decodes 8 of 8 frames at 17 dB.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from projectultra_tpu.config import CodeRate, Modulation  # noqa: E402
from projectultra_tpu.fec import ldpc  # noqa: E402
from projectultra_tpu.ofdm import pipeline as JP  # noqa: E402
from projectultra_tpu.sim import watterson as JW  # noqa: E402

from projectultra_tpu_torch.ofdm import pipeline as TP  # noqa: E402
from projectultra_tpu_torch.sim import watterson as TW  # noqa: E402

from test_torch_tables import jax_tables  # noqa: E402

CHIRP_CFG = JP.chirp_ofdm_config()
DQPSK, R12 = Modulation.DQPSK, CodeRate.R1_2


def _pipeline(tables: str, n_codewords: int = 1) -> TP.FramePipeline:
    if tables == "port":
        return TP.pipeline_for(CHIRP_CFG, DQPSK, R12, n_codewords,
                               torch.device("cpu"))
    return TP.FramePipeline(
        CHIRP_CFG, DQPSK, R12, n_codewords,
        tables=jax_tables(CHIRP_CFG, DQPSK, R12, n_codewords))


@pytest.mark.parametrize("tables", ["port", "jax"])
def test_rx_on_jax_noisy_frames_matches_jax(tables):
    code = ldpc.get_code(R12)
    info = np.random.default_rng(0).integers(
        0, 2, size=(8, code.k)).astype(np.float32)
    tx = JP.tx_frame(CHIRP_CFG, DQPSK, R12, jnp.asarray(info))
    rx = JW.add_noise_active(jax.random.PRNGKey(1), tx, 17.0)
    ref = JP.rx_frame(CHIRP_CFG, DQPSK, R12, rx)
    out, ok, iters = _pipeline(tables).rx(torch.from_numpy(np.array(rx)))
    assert out.dtype == torch.uint8 and ok.dtype == torch.bool
    assert iters.dtype == torch.int32 and tuple(iters.shape) == (8, 1)
    for a, b in zip((out, ok, iters), ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ok.all() and (out.numpy() == info.astype(np.uint8)).all()


def test_rx_frame_function_matches_jax_at_12db_with_cfo():
    """Harder frames (12 dB, [15, -20] Hz known CFO): multi-iteration
    decodes, still lane-exact against JAX."""
    code = ldpc.get_code(R12)
    info = np.random.default_rng(17).integers(
        0, 2, size=(2, code.k)).astype(np.float32)
    tx = JP.tx_frame(CHIRP_CFG, DQPSK, R12, jnp.asarray(info))
    rx = JW.add_noise_active(jax.random.PRNGKey(3), tx, 12.0)
    cfo = [15.0, -20.0]
    rx = JW.apply_cfo_hilbert(rx, jnp.asarray(cfo))
    ref = JP.rx_frame(CHIRP_CFG, DQPSK, R12, rx, cfo_hz=jnp.asarray(cfo))
    ours = TP.rx_frame(CHIRP_CFG, DQPSK, R12, torch.from_numpy(np.array(rx)),
                       cfo_hz=torch.tensor(cfo))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("tables", ["port", "jax"])
def test_clean_three_codeword_frame_decodes_exactly(tables):
    code = ldpc.get_code(R12)
    B, ncw = 2, 3
    info = np.random.default_rng(3).integers(
        0, 2, size=(B, ncw * code.k)).astype(np.float32)
    pipe = _pipeline(tables, ncw)
    tx = pipe.tx(torch.from_numpy(info))
    assert tuple(tx.shape) == (B, TP.frame_samples(CHIRP_CFG, DQPSK, ncw))
    out, ok, iters = TP.rx_frame(CHIRP_CFG, DQPSK, R12, tx, n_codewords=ncw)
    assert ok.all() and tuple(iters.shape) == (B, ncw)
    np.testing.assert_array_equal(out.numpy(), info.astype(np.uint8))
    out2, ok2, iters2 = pipe.rx(tx)
    assert torch.equal(out, out2) and torch.equal(ok, ok2)
    assert torch.equal(iters, iters2)


def test_three_codeword_tx_matches_the_jax_construction():
    """The port's multi-codeword TX equals the frame
    tests/test_ofdm_loopback.py builds from JAX pieces."""
    from projectultra_tpu.fec.interleave import channel_interleaver
    from projectultra_tpu.ofdm import modulator as JM
    from projectultra_tpu.ops import ldpc as J

    code = ldpc.get_code(R12)
    B, ncw = 2, 3
    info = np.random.default_rng(3).integers(
        0, 2, size=(B, ncw, code.k)).astype(np.float32)
    cw = np.asarray(J.encode(code, jnp.asarray(info.reshape(B * ncw, -1))))
    inter = cw[:, channel_interleaver(60, 648).inv].reshape(B, ncw * 648)
    data = JM.modulate(CHIRP_CFG, DQPSK, jnp.asarray(inter),
                       t_offset=2 * CHIRP_CFG.symbol_duration)
    tr = np.broadcast_to(JM.generate_training(CHIRP_CFG, 2), (B, 1128))
    ref = np.concatenate([tr, np.asarray(data)], axis=-1)
    ours = _pipeline("port", ncw).tx(
        torch.from_numpy(info.reshape(B, -1))).numpy()
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()


def test_port_loopback_17db_decodes_all_frames():
    code = ldpc.get_code(R12)
    g = torch.Generator().manual_seed(11)
    info = torch.randint(0, 2, (8, code.k), generator=g, dtype=torch.uint8)
    tx = TP.tx_frame(CHIRP_CFG, DQPSK, R12, info)
    rx = TW.add_noise_active(tx, 17.0, g)
    out, ok, _ = TP.rx_frame(CHIRP_CFG, DQPSK, R12, rx)
    assert int(ok.sum()) == 8
    assert torch.equal(out, info)

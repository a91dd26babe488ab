"""The sweep harness of the PyTorch port (``parallel/sweep.py``) against
the JAX package's (``projectultra_tpu/parallel/sweep.py``).

JAX's PRNG cannot be reproduced in torch, so the parity cases run the JAX
``run_point`` with its ``_apply_channel`` wrapped to record the TX batch
and the noisy batch it made, and feed that noisy batch to the port's
``receive_*``.  Tolerances:

* the port's TX batch within 2e-4 of JAX's (DPSK 5e-4: the port's DPSK
  modulator accumulates float32 symbol phases in another order, as
  tests/test_torch_dpsk.py states);
* decode rate, detected rate and BER exactly JAX's; the CFO error within
  1e-3 Hz (NaN where JAX's is NaN);
* the stream row: the same delivered payloads and the same number of
  delivered frames as the JAX engine on the JAX-made noisy stream, and
  the port's clean stream within 2e-4 of JAX's.

The rate twins hold the port's own RNG (a CPU ``torch.Generator``) to
the rates tests/test_sweep_adaptive.py holds JAX's to.

JAX reads ULTRA_CHIRP_BF16 and ULTRA_LDPC_BF16 at import (both removed
before it is imported); both packages' stream engines read ULTRA_EXCISION
and ULTRA_BLANKER when built, and neither is set for either.
"""

import os

for _flag in ("ULTRA_CHIRP_BF16", "ULTRA_LDPC_BF16", "ULTRA_EXCISION",
              "ULTRA_BLANKER"):
    os.environ.pop(_flag, None)

import dataclasses  # noqa: E402
import math  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

import jax  # noqa: E402

from projectultra_tpu.parallel import sweep as JS  # noqa: E402
from projectultra_tpu.protocol import frame_v2 as JF  # noqa: E402

from projectultra_tpu_torch.parallel import sweep as TS  # noqa: E402
from projectultra_tpu_torch.sim import watterson as TW  # noqa: E402

CPU = torch.device("cpu")
FRAMES = 4
SNR = {"MC_DPSK": 5.0, "OFDM_CHIRP": 17.0, "DPSK": 0.0}
TX_TOL = {"MC_DPSK": 2e-4, "OFDM_CHIRP": 2e-4, "DPSK": 5e-4}
CHANNELS = [(0.0, "awgn"), (30.0, "awgn"), (0.0, "moderate")]


def _points(waveform, cfo, channel, frames=FRAMES, **kw):
    preset = "medium" if waveform == "DPSK" else ""
    args = (waveform, SNR[waveform], cfo, channel)
    return (JS.SweepPoint(*args, frames=frames, preset=preset, **kw),
            TS.SweepPoint(*args, frames=frames, preset=preset, **kw))


def _rows(rows):
    return [(dataclasses.asdict(p) | {"rate": int(p.rate)}, m)
            for p, m in rows]


@pytest.mark.parametrize("name", ["REGRESSION_MATRIX", "FULL_EXTRA"])
def test_rows_match_jax(name):
    """13 + 11 rows, field for field, with their minimum rates."""
    assert _rows(getattr(TS, name)) == _rows(getattr(JS, name))
    assert len(getattr(TS, name)) == {"REGRESSION_MATRIX": 13,
                                      "FULL_EXTRA": 11}[name]


@pytest.fixture
def jax_channel(monkeypatch):
    """Records the TX and noisy batches of every JAX ``_apply_channel``."""
    seen = []
    apply = JS._apply_channel

    def recording(key, tx, point):
        rx = apply(key, tx, point)
        seen.append((np.asarray(tx), np.asarray(rx)))
        return rx

    monkeypatch.setattr(JS, "_apply_channel", recording)
    return seen


def _same_result(port, ref):
    assert port.decode_rate == ref.decode_rate
    assert port.detected_rate == ref.detected_rate
    assert port.ber == ref.ber
    if math.isnan(ref.cfo_err_hz):
        assert math.isnan(port.cfo_err_hz)
    else:
        assert abs(port.cfo_err_hz - ref.cfo_err_hz) < 1e-3


@pytest.mark.parametrize("cfo,channel", CHANNELS)
@pytest.mark.parametrize("waveform", ["MC_DPSK", "OFDM_CHIRP", "DPSK"])
def test_receive_on_jax_rx_matches_jax(waveform, cfo, channel, jax_channel):
    jp, tp = _points(waveform, cfo, channel)
    ref = JS.run_point(jp)
    (tx, rx), = jax_channel
    batch = TS.BUILD[waveform](tp, seed=42, device=CPU)
    assert batch.tx.shape == tx.shape
    np.testing.assert_allclose(batch.tx.numpy(), tx, rtol=0,
                               atol=TX_TOL[waveform])
    port = TS.RECEIVE[waveform](tp, torch.from_numpy(rx.copy()), batch)
    assert port.point == tp
    _same_result(port, ref)


# tests/test_sweep_adaptive.py:21-39 on the port's own RNG.
@pytest.mark.parametrize("point,gate,cfo_max", [
    (TS.SweepPoint("MC_DPSK", 5.0, 0.0, "awgn", frames=4), 1.0, None),
    (TS.SweepPoint("OFDM_CHIRP", 17.0, 50.0, "awgn", frames=4), 1.0, 3.0),
    (TS.SweepPoint("MC_DPSK", 5.0, 0.0, "moderate", frames=5), 0.6, None),
])
def test_rate_twins_on_the_port_rng(point, gate, cfo_max):
    res = TS.run_point(point, device=CPU)
    assert res.decode_rate >= gate
    if gate == 1.0:
        assert res.detected_rate == 1.0
    if cfo_max is not None:
        assert res.cfo_err_hz < cfo_max


def test_channel_from_numpy_normals_is_device_independent():
    """A numpy generator gives the channel the same normals on any device:
    AWGN is add_noise_active's arithmetic on them, and a Watterson row
    draws its fading normals before its noise."""
    _, tp = _points("MC_DPSK", 0.0, "awgn", frames=2)
    tx = TS.build_mc_dpsk(tp, device=CPU).tx
    got = TS._apply_channel(tp, tx, np.random.default_rng(5))
    normals = np.random.default_rng(5).standard_normal(tx.shape,
                                                       dtype=np.float32)
    active = tx.abs() > 1e-6
    power = (torch.where(active, tx * tx, 0.0).sum(-1)
             / active.sum(-1)).numpy()
    want = tx.numpy() + np.sqrt(power / 10 ** 0.5)[:, None] * normals
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    _, tm = _points("MC_DPSK", 0.0, "moderate", frames=2)
    rng = np.random.default_rng(6)
    fade = torch.from_numpy(rng.standard_normal((2, 2, 2, tx.shape[1]),
                                                dtype=np.float32))
    noise = torch.from_numpy(rng.standard_normal(tx.shape, dtype=np.float32))
    want = TW.watterson_with(tx, TW.harness_moderate(5.0), fade, noise)
    got = TS._apply_channel(tm, tx, np.random.default_rng(6))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# Single-stream discipline
# ---------------------------------------------------------------------------

def _jax_stream(point, seed=42):
    """JAX's run_point_stream up to its noisy stream: the clean stream
    from its TX engine, then its channel."""
    import jax.numpy as jnp
    tx, _ = JS._stream_engines(point)
    pieces = [np.zeros(4800, np.float32)]
    for i in range(point.frames):
        frame = JF.DataFrame.make_data("W1AW", "VE3ABC", i + 1,
                                       f"stream frame {i:02d}")
        pieces += [tx.transmit(frame.serialize()), np.zeros(4800, np.float32)]
    stream = np.concatenate(pieces + [np.zeros(8000, np.float32)])
    noisy = np.asarray(JS._apply_channel(
        jax.random.PRNGKey(seed), jnp.asarray(stream[None, :]), point))[0]
    return stream, noisy.astype(np.float32)


def _jax_receive(point, noisy, chunk=960, polls_every=5):
    """JAX's run_point_stream receiver loop (sweep.py:316-336) on
    ``noisy``: (delivered payloads, number of frames delivered)."""
    _, rx = JS._stream_engines(point)
    got = []
    rx.on_frame = got.append
    rx.on_ping = lambda snr: None
    for n, i in enumerate(range(0, len(noisy), chunk)):
        rx.feed_audio(noisy[i:i + chunk])
        if n % polls_every == 0:
            rx.poll()
    for _ in range(rx.COX_MAX_IDLE_POLLS + 2):
        rx.poll()
    payloads = [f"stream frame {i:02d}" for i in range(point.frames)]
    decoded = set()
    for fr in got:
        df = JF.DataFrame.deserialize(fr.frame_bytes)
        if df is not None and all(fr.cw_ok) \
                and df.payload_as_text() in payloads:
            decoded.add(df.payload_as_text())
    return decoded, len(got)


def test_stream_row_on_jax_noise_matches_jax():
    jp, tp = _points("MC_DPSK", 0.0, "awgn", frames=2)
    stream, noisy = _jax_stream(jp)
    port_stream = TS.stream_tx(tp, CPU)
    assert port_stream.shape == stream.shape
    np.testing.assert_allclose(port_stream, stream, rtol=0, atol=2e-4)
    decoded, n_got = _jax_receive(jp, noisy)
    res, port_decoded = TS.receive_stream(tp, noisy, CPU)
    assert port_decoded == decoded == {"stream frame 00", "stream frame 01"}
    assert res.detected_rate == n_got / tp.frames
    assert res.decode_rate == len(decoded) / tp.frames

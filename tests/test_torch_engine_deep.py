"""The port's engine against the JAX engine on deep Schmidl-Cox
acquisition and the impulse blanker: twins of tests/test_deep_acquisition.py
and of tests/test_blanker.py.

The engine rows drive a JAX ``ModemEngine`` and a port
``ModemEngine(device=cpu)`` through one script of feeds and polls
(``test_torch_engine.twin``: ``_rx_consumed`` and the events delivered
so far equal after every poll, the frames exact, float fields within the
tolerances stated there) on JAX's TX audio plus ``np.random.default_rng``
noise, built exactly as the JAX files build it.  Then the JAX test's own
gate runs on the port's run.  The blanker's host rows run the port's
``ImpulseBlanker`` on the port's TX audio, its output array-equal to the
JAX blanker's on the same input, and the JAX test's gate on it.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from projectultra_tpu.modem import blanker as JB  # noqa: E402

from projectultra_tpu_torch.modem.blanker import BLOCK, ImpulseBlanker  # noqa: E402

from test_torch_engine import (data_frame, feeds, make_engine,  # noqa: E402
                               text_of, twin, tx_audio)

MSG = "deep acquisition extends the cox floor below the plateau"
DEEP_PAIR = dict(waveform="OFDM_COX", connected=True, rate="R1_2")
BLANKER_ENGINE = dict(waveform="OFDM_COX", connect_waveform="OFDM_COX",
                      connected=True, mod="DQPSK", rate="R1_2")


# ---------------------------------------------------------------------------
# tests/test_deep_acquisition.py
# ---------------------------------------------------------------------------

def _noisy_stream(seed: int, snr_db: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    audio = tx_audio(data_frame("W1AW", "VE3ABC", 1, MSG), **DEEP_PAIR)
    ps = float((audio ** 2).mean())
    sigma = np.sqrt(ps / 10 ** (snr_db / 10.0))
    sig = np.zeros(12000 + len(audio) + 9000, np.float32)
    sig[12000:12000 + len(audio)] = audio
    sig += rng.normal(0, sigma, len(sig)).astype(np.float32)
    return sig


def _delivered_msg(run) -> bool:
    return any(MSG.encode() in f.frame_bytes for f in run.frames)


@pytest.mark.parametrize("deep", [True, False])
def test_deep_acquisition_at_9db_wideband(deep):
    """Deep on: at least 2 of 3 streams decode 6 dB below the plateau
    floor; the ablation (deep off) decodes none of the same streams."""
    hits = 0
    for seed in (11, 12, 13):
        run = twin(feeds(_noisy_stream(seed, 9.0), chunk=960),
                   attrs={"deep_acquisition": deep}, **DEEP_PAIR)
        if deep:
            hits += _delivered_msg(run)
        else:
            assert not run.frames, "faithful gates decoded at 9 dB"
    if deep:
        assert hits >= 2, f"deep acquisition decoded only {hits}/3 at 9 dB"


def test_deep_candidate_on_noise_never_wedges_or_decodes():
    """Eight seconds of pure noise: no frame, and the retained buffer stays
    bounded under the speculative deep candidates."""
    sig = np.random.default_rng(99).normal(0, 1.0, 48000 * 8) \
        .astype(np.float32)
    run = twin(feeds(sig, chunk=960), **DEEP_PAIR)
    assert not run.frames and run.engine.frames_received == 0
    assert len(run.engine._rx_buffer) < 6 * 48000


def test_deep_frame_cut_mid_stream_releases_receiver():
    """A deep candidate whose stream dies mid-frame times out and does not
    block a later, complete frame."""
    rng = np.random.default_rng(5)
    cut = tx_audio(data_frame("W1AW", "VE3ABC", 1, "x" * 80),
                   **DEEP_PAIR)[:26000]
    full = tx_audio(data_frame("W1AW", "VE3ABC", 2, MSG), **DEEP_PAIR)
    ps = float((full ** 2).mean())
    sigma = np.sqrt(ps / 10 ** (10.0 / 10.0))
    sig = np.concatenate([
        np.zeros(6000, np.float32), cut,
        np.zeros(30000, np.float32), full, np.zeros(9000, np.float32)])
    sig += rng.normal(0, sigma, len(sig)).astype(np.float32)
    run = twin(feeds(sig, chunk=960), **DEEP_PAIR)
    assert _delivered_msg(run), \
        "complete frame after a cut deep candidate was not decoded"


# ---------------------------------------------------------------------------
# tests/test_blanker.py
# ---------------------------------------------------------------------------

BLANKER_MSG = "BLANKER_TEST_" + "x" * 60


def _frame_audio(side="jax"):
    frame = data_frame("W1AW", "VE3ABC", 0, BLANKER_MSG)
    return make_engine(side, **BLANKER_ENGINE).transmit(frame)


def _crash_steps(a, blanker_on, seed=0):
    """test_midframe_crash_decode_through's stream: the frame at 20 dB
    with a 30 ms crash at +15 dB over frame power at 55% of it, fed in
    960-sample chunks with a poll every fifth, then 8,000 zeros."""
    sp = float(np.mean(a ** 2))
    ns = float(np.sqrt(sp / 10 ** 2.0))
    r = np.random.default_rng(seed)
    x = np.concatenate([np.zeros(96000, np.float32), a,
                        np.zeros(48000, np.float32)]).copy()
    x += r.normal(0, ns, len(x)).astype(np.float32)
    mid = 96000 + int(0.55 * len(a))
    x[mid:mid + 1440] += r.normal(
        0, np.sqrt(sp * 10 ** 1.5), 1440).astype(np.float32)
    steps = [("call", lambda e: setattr(e.blanker, "enabled", blanker_on))]
    for i in range(0, len(x), 960):
        steps.append(("feed", x[i:i + 960]))
        if i % 4800 == 0:
            steps.append(("poll",))
    return steps + [("feed", np.zeros(8000, np.float32)), ("poll",)]


@pytest.mark.parametrize("blanker_on", [False, True])
def test_midframe_crash_decode_through(blanker_on):
    """The crash kills the unblanked decode (the premise) and the blanker
    recovers it, erasing one run; the blanked runs equal JAX's."""
    run, rj = twin(_crash_steps(_frame_audio(), blanker_on), with_jax=True,
                   **BLANKER_ENGINE)
    assert run.engine.blanker.blanked_runs == rj.engine.blanker.blanked_runs
    texts = [text_of(fr) for fr in run.frames if text_of(fr) is not None]
    ok = any(t.startswith("BLANKER_TEST") for t in texts)
    if blanker_on:
        assert ok and run.engine.blanker.blanked_runs == 1
    else:
        assert not ok


def _run_chunks(blanker, x, chunk=960):
    return np.concatenate([blanker.process(x[i:i + chunk])
                           for i in range(0, len(x), chunk)])


def _both_blankers(x, enabled=True):
    """The port's blanker over ``x`` in 960-sample chunks, its output held
    array-equal to the JAX blanker's; returns (port blanker, output)."""
    b, bj = ImpulseBlanker(enabled=enabled), JB.ImpulseBlanker(enabled=enabled)
    y = _run_chunks(b, x)
    np.testing.assert_array_equal(y, _run_chunks(bj, x))
    assert (b.blanked_runs, b.held_samples) == (bj.blanked_runs,
                                                bj.held_samples)
    return b, y


def test_clean_stream_exact_passthrough():
    a = _frame_audio("port")
    x = np.concatenate([np.zeros(48000, np.float32), a,
                        np.zeros(48000, np.float32)])
    x = x[:len(x) // BLOCK * BLOCK]
    b, y = _both_blankers(x)
    assert b.blanked_runs == 0
    assert b.held_samples == 0
    np.testing.assert_array_equal(y, x)


def test_noisy_frame_identical_and_unblanked():
    rng = np.random.default_rng(0)
    a = _frame_audio("port")
    x = np.concatenate([np.zeros(96000, np.float32), a,
                        np.zeros(48000, np.float32)])
    sp = float(np.mean(a ** 2))
    x = x + rng.normal(0, np.sqrt(sp / 10 ** 2.5), len(x)).astype(np.float32)
    x = x[:len(x) // BLOCK * BLOCK]
    b, y = _both_blankers(x)
    assert b.blanked_runs == 0
    np.testing.assert_array_equal(y, x[:len(y)])
    assert len(x) - len(y) == b.held_samples


def test_gap_burst_blanked_noise_untouched():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 0.01, 48000 * 4).astype(np.float32)
    at = 48000 * 2 + 96  # block-aligned for a crisp span check
    n = 1440
    x[at:at + n] += rng.normal(0, 0.15, n).astype(np.float32)
    b, y = _both_blankers(np.concatenate([x, np.zeros(4800, np.float32)]))
    assert b.blanked_runs == 1
    z = y[at:at + n]
    assert float(np.mean(z ** 2)) < 1e-8  # erased (edge blocks may remain)
    np.testing.assert_array_equal(y[:at - BLOCK], x[:at - BLOCK])
    np.testing.assert_array_equal(y[at + n + 2 * BLOCK:len(x)],
                                  x[at + n + 2 * BLOCK:len(x)])


def test_disabled_is_identity():
    b = ImpulseBlanker(enabled=False)
    x = np.ones(1000, np.float32)
    np.testing.assert_array_equal(b.process(x), x)
    np.testing.assert_array_equal(JB.ImpulseBlanker(enabled=False).process(x),
                                  x)

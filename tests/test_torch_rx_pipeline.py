"""The port's waveform adapters (``waveform/factory``, ``otfs_adapter``)
and ``RxPipeline`` against the JAX package's.

* The factory (twin of tests/test_nvis_waveforms.py:136-170): the SNR
  recommendations and the mode mapping equal; each adapter's preamble
  equal, its TX within 2e-4 of JAX's (5e-4 for DPSK, whose float32 symbol
  phases accumulate in another order: tests/test_torch_dpsk.py); on the
  same buffer (JAX's TX in 3,000 + 2,000 zeros) ``detect_sync`` gives the
  same detection and start, CFO within 1e-3 Hz and correlation within
  1e-4; the demodulated LLRs of the codeword within 1e-3 of JAX's (as
  tests/test_torch_otfs.py holds OTFS), and the port's LDPC decodes them.
* ``RxPipeline`` (twins of tests/test_audio_pipeline.py:57-138): both
  packages' pipelines (the port's with ``device=cpu``) fed the same audio
  in the same chunks return the same frames, and the JAX test's
  assertions hold on the port's.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from projectultra_tpu import config as JC  # noqa: E402
from projectultra_tpu.fec import ldpc as jldpc  # noqa: E402
from projectultra_tpu.modem.engine import ModemEngine as JEngine  # noqa: E402
from projectultra_tpu.modem.rx_pipeline import RxPipeline as JRx  # noqa: E402
from projectultra_tpu.ops import ldpc as jldpc_ops  # noqa: E402
from projectultra_tpu.protocol import frame_v2 as JF  # noqa: E402
from projectultra_tpu.waveform import factory as JWF  # noqa: E402

from projectultra_tpu_torch import config as TC  # noqa: E402
from projectultra_tpu_torch.fec import ldpc as tldpc  # noqa: E402
from projectultra_tpu_torch.modem.rx_pipeline import RxPipeline as TRx  # noqa: E402
from projectultra_tpu_torch.ops import ldpc as tldpc_ops  # noqa: E402
from projectultra_tpu_torch.protocol import frame_v2 as TF  # noqa: E402
from projectultra_tpu_torch.waveform import factory as TWF  # noqa: E402

CPU = torch.device("cpu")
LLR_TOL = 1e-3


def test_recommendations_and_mode_map():
    for snr in np.arange(-10.0, 40.0, 0.5):
        assert TWF.recommend_mode(float(snr)) == JWF.recommend_mode(float(snr))
        assert TWF.recommend_mc_dpsk_carriers(float(snr)) == \
            JWF.recommend_mc_dpsk_carriers(float(snr))
    assert TWF.recommend_mode(5.0) == TF.WaveformMode.MC_DPSK
    assert TWF.recommend_mode(15.0) == TF.WaveformMode.OFDM_CHIRP
    assert TWF.recommend_mode(25.0) == TF.WaveformMode.OFDM_COX
    assert TWF.recommend_mc_dpsk_carriers(5.0) == 8
    assert TWF.recommend_mc_dpsk_carriers(20.0) == 20
    for mode in TF.WaveformMode:
        if mode == TF.WaveformMode.AUTO:
            continue
        t = TWF.create(mode, device=CPU)
        j = JWF.create(JF.WaveformMode(int(mode)))
        assert int(t.mode) == int(j.mode), mode
        assert vars(t.capabilities()) == vars(j.capabilities()), mode
    assert TWF.create(TF.WaveformMode.MFSK, device=CPU).mode == \
        TF.WaveformMode.MC_DPSK
    assert TWF.create(TF.WaveformMode.OTFS_RAW, device=CPU).mode == \
        TF.WaveformMode.OTFS_RAW


def test_create_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TWF.create(TF.WaveformMode.MC_DPSK)
    with pytest.raises(RuntimeError):
        TRx()


def codeword(seed=0):
    code = jldpc.get_code(JC.CodeRate.R1_4)
    info = np.random.default_rng(seed).integers(0, 2, size=(1, code.k)) \
        .astype(np.float32)
    cw = np.asarray(jldpc_ops.encode(code, jnp.asarray(info)))
    return info, cw


def sync_fields(s):
    return (s.detected.astype(bool).tolist(),
            s.start_sample.astype(np.int64).tolist(), s.has_training)


def assert_same_sync(st, sj):
    assert sync_fields(st) == sync_fields(sj)
    np.testing.assert_allclose(st.cfo_hz, sj.cfo_hz, rtol=0, atol=1e-3)
    np.testing.assert_allclose(st.correlation, sj.correlation, rtol=0,
                               atol=1e-4)


def decode_port(llrs, info):
    code = tldpc.get_code(TC.CodeRate.R1_4)
    out, ok, _ = tldpc_ops.decode(code, llrs[:, :code.n].to(torch.float32))
    assert bool(ok[0])
    np.testing.assert_array_equal(out.numpy(), info.astype(np.uint8))


@pytest.mark.parametrize("mode", ["MC_DPSK", "DPSK", "OFDM_CHIRP",
                                  "OFDM_COX", "OTFS_EQ"])
def test_adapter_matches_jax(mode):
    """test_nvis_waveforms.py:136's end-to-end run through the adapter
    API, for each adapter."""
    wj = JWF.create(JF.WaveformMode[mode])
    wt = TWF.create(TF.WaveformMode[mode], device=CPU)
    info, cw = codeword()
    pre = wj.generate_preamble()
    np.testing.assert_array_equal(wt.generate_preamble(), pre)
    tx_j = np.asarray(wj.modulate(jnp.asarray(cw)))[0]
    tx_t = wt.modulate(cw).numpy()[0]
    assert tx_t.shape == tx_j.shape
    np.testing.assert_allclose(tx_t, tx_j, rtol=0,
                               atol=5e-4 if mode == "DPSK" else 2e-4)
    buf = np.concatenate([np.zeros(3000, np.float32), pre, tx_j,
                          np.zeros(2000, np.float32)])[None, :]

    if mode == "OFDM_COX":
        lj, dj = wj.decode(jnp.asarray(buf))
        lt, dt = wt.decode(buf)
        for k in ("found", "lts_start"):
            np.testing.assert_array_equal(dt[k].numpy(), np.asarray(dj[k]))
        np.testing.assert_allclose(lt.numpy()[:, :648],
                                   np.asarray(lj)[:, :648], rtol=0,
                                   atol=LLR_TOL)
        decode_port(lt, info)
        return

    sj, st = wj.detect_sync(jnp.asarray(buf)), wt.detect_sync(buf)
    assert_same_sync(st, sj)
    assert bool(st.detected[0])
    start = int(st.start_sample[0])
    if mode == "OTFS_EQ":
        lj = wj.demodulate(jnp.asarray(buf[:, start:]))
        lt = wt.demodulate(buf[:, start:])
    else:
        if mode == "MC_DPSK":
            from projectultra_tpu_torch.psk import mc_dpsk as MC
            n_sym = MC.num_symbols_for_bits(wt.config, 648)
        elif mode == "DPSK":
            n_sym = -(-648 // wt.config.bits_per_symbol)
        else:
            from projectultra_tpu_torch.ofdm import demodulator as D
            n_sym = D.num_symbols_for_bits(wt.config, wt.config.modulation,
                                           648)
        span = buf[:, start:]
        lj = wj.demodulate(jnp.asarray(span), jnp.asarray(sj.cfo_hz),
                           jnp.asarray(sj.start_sample, jnp.float32), n_sym)
        lt = wt.demodulate(span, st.cfo_hz, st.start_sample.astype(
            np.float32), n_sym)
    np.testing.assert_allclose(lt.numpy()[:, :648], np.asarray(lj)[:, :648],
                               rtol=0, atol=LLR_TOL)
    decode_port(lt, info)


# ---------------------------------------------------------------------------
# RxPipeline (tests/test_audio_pipeline.py:57-138)
# ---------------------------------------------------------------------------

def pipelines(**kw):
    """Both packages' pipelines, set up alike (enum arguments by name)."""
    def args(C, F):
        return {k: (C.CodeRate[v] if k == "rate" else F.WaveformMode[v])
                for k, v in kw.items()}
    return JRx(**args(JC, JF)), TRx(device=CPU, **args(TC, TF))


def feed_both(pj, pt, audio, chunk=4800):
    ready = []
    for i in range(0, len(audio), chunk):
        rj = pj.feed_audio(audio[i:i + chunk])
        rt = pt.feed_audio(audio[i:i + chunk])
        assert rt == rj
        ready.append(rt)
    return any(ready)


def drain(pj, pt):
    fj, ft = [], []
    while pj.has_frame():
        fj.append(pj.get_frame())
    while pt.has_frame():
        ft.append(pt.get_frame())
    assert ft == fj
    return ft


def test_rx_pipeline_persistent_engine_mixed_traffic():
    tx = JEngine()
    tx.connected = tx.handshake_complete = True
    tx.set_waveform_mode(JF.WaveformMode.MC_DPSK)
    tx.data_code_rate = JC.CodeRate.R1_2
    frame = JF.DataFrame.make_data("W1AW", "VE3ABC", 2, "after ping")
    audio = np.concatenate([
        tx.transmit_ping(), np.zeros(2000, np.float32),
        tx.transmit(frame.serialize()), np.zeros(4000, np.float32)])
    pj, pt = pipelines(rate="R1_2")
    eng0 = pt._engine
    feed_both(pj, pt, audio)
    assert pt._engine is eng0
    assert pt._engine.data_code_rate == TC.CodeRate.R1_2
    frames = drain(pj, pt)
    df = TF.DataFrame.deserialize(frames[0])
    assert df and df.payload_as_text() == "after ping"


def test_rx_pipeline_streaming():
    frame = JF.DataFrame.make_data("W1AW", "VE3ABC", 9, "pipeline frame")
    audio = np.concatenate([JEngine().transmit(frame.serialize()),
                            np.zeros(4000, np.float32)])
    pj, pt = pipelines()
    assert feed_both(pj, pt, audio)
    frames = drain(pj, pt)
    df = TF.DataFrame.deserialize(frames[0])
    assert df and df.payload_as_text() == "pipeline frame"


def test_rx_pipeline_dpsk_mode():
    tx = JEngine()
    tx.set_waveform_mode(JF.WaveformMode.DPSK)
    tx.connect_waveform = JF.WaveformMode.DPSK
    frame = JF.ControlFrame.make_ack("W1AW", "VE3ABC", 4).serialize()
    audio = np.concatenate([tx.transmit(frame), np.zeros(8000, np.float32)])
    pj, pt = pipelines(mode="DPSK")
    assert pt._engine.waveform_mode == TF.WaveformMode.DPSK
    feed_both(pj, pt, audio)
    frames = drain(pj, pt)
    ctrl = TF.ControlFrame.deserialize(frames[0])
    assert ctrl is not None and ctrl.seq == 4


def test_rx_pipeline_reset_then_fresh_stream():
    tx = JEngine()
    f1 = JF.DataFrame.make_data("W1AW", "VE3ABC", 1, "before reset")
    f2 = JF.DataFrame.make_data("W1AW", "VE3ABC", 2, "after reset")
    pj, pt = pipelines()
    a1 = tx.transmit(f1.serialize())
    feed_both(pj, pt, a1[:len(a1) // 2], chunk=len(a1))
    pj.reset()
    pt.reset()
    assert not pt.has_frame()
    a2 = np.concatenate([tx.transmit(f2.serialize()),
                         np.zeros(4000, np.float32)])
    feed_both(pj, pt, a2)
    frames = drain(pj, pt)
    df = TF.DataFrame.deserialize(frames[0])
    assert df and df.payload_as_text() == "after reset"

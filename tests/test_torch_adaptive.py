"""The port's adaptive controller and channel characterizer against the
JAX package's (``modem/adaptive.py``, a host-only copy).

The copy's source equals the original's apart from its docstring and the
original's unused ``jax.numpy`` import.  Each scenario below -- twins of
tests/test_sweep_adaptive.py:49-268 and tests/test_protocol.py:560-640 --
runs on both packages and holds the two to each other: the controllers'
(modulation, rate, switched) after every update exactly, the
characterizer's estimates exactly (the same numpy code on the same
preamble), the engines' SNR readings within the engine twins' 1e-3 dB.
Then the JAX test's own assertions run on the port's side.
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from projectultra_tpu import config as JC  # noqa: E402
from projectultra_tpu.modem import adaptive as JAD  # noqa: E402
from projectultra_tpu.otfs import otfs as JO  # noqa: E402
from projectultra_tpu.protocol import connection as JCONN  # noqa: E402
from projectultra_tpu.sim import watterson as JW  # noqa: E402

from projectultra_tpu_torch import config as TC  # noqa: E402
from projectultra_tpu_torch.modem import adaptive as TAD  # noqa: E402
from projectultra_tpu_torch.otfs import otfs as TO  # noqa: E402
from projectultra_tpu_torch.protocol import connection as TCONN  # noqa: E402
from projectultra_tpu_torch.protocol import frame_v2 as TF  # noqa: E402

from test_torch_host import port_config  # noqa: E402
from test_torch_protocol_stack import assert_copy  # noqa: E402

CPU = torch.device("cpu")
PKG = {"jax": types.SimpleNamespace(C=JC, AD=JAD, O=JO, CONN=JCONN),
       "port": types.SimpleNamespace(C=TC, AD=TAD, O=TO, CONN=TCONN)}
M, R = TC.Modulation, TC.CodeRate


def test_copy_matches_original():
    assert_copy("modem/adaptive.py")


def both(scenario, *args):
    logs = {side: scenario(PKG[side], *args) for side in ("jax", "port")}
    assert logs["port"] == logs["jax"]
    return logs["port"]


# ---------------------------------------------------------------------------
# Channel characterizer (test_sweep_adaptive.py:49-70)
# ---------------------------------------------------------------------------

def preamble_through(chan):
    pre = JO.generate_preamble(JO.OTFSConfig())
    np.testing.assert_array_equal(pre, TO.generate_preamble(TO.OTFSConfig()))
    if chan is None:
        return pre
    out = JW.watterson(jax.random.PRNGKey(0), jnp.asarray(pre[None, :]), chan)
    return np.asarray(out)[0]


def estimate(P, pre):
    mode, est = P.AD.select_mode(pre)
    ch = P.AD.ChannelCharacterizer(P.O.OTFSConfig()).characterize(pre)
    return (int(mode), dataclasses.asdict(est), dataclasses.asdict(ch),
            int(ch.recommended_mode()), ch.condition)


def test_adaptive_good_channel_selects_otfs_eq():
    """test_sweep_adaptive.py:49"""
    mode, est, *_ = both(estimate, preamble_through(JW.good(30.0)))
    assert est["doppler_spread_hz"] < 2.0
    assert mode in (TAD.ModulationMode.OTFS_EQ, TAD.ModulationMode.OFDM)


def test_adaptive_flutter_selects_ofdm():
    """test_sweep_adaptive.py:55"""
    mode, est, *_ = both(estimate, preamble_through(JW.flutter(25.0)))
    assert est["doppler_spread_hz"] > 1.0
    assert mode in (TAD.ModulationMode.OFDM, TAD.ModulationMode.OTFS_RAW)


def test_characterizer_clean_channel():
    """test_sweep_adaptive.py:62"""
    pre = preamble_through(None)
    both(estimate, pre)
    est = TAD.ChannelCharacterizer(TO.OTFSConfig()).characterize(pre)
    assert est.doppler_spread_hz < 0.3
    assert est.delay_spread_ms < 0.75
    assert est.is_good
    assert est.recommended_mode() == TAD.ModulationMode.OTFS_EQ


# ---------------------------------------------------------------------------
# Controllers (test_sweep_adaptive.py:72-93, :129-268)
# ---------------------------------------------------------------------------

def trace(ctl, readings, method="update"):
    """(mod, rate, switched) after every reading."""
    out = []
    for r in readings:
        sw = getattr(ctl, method)(*r)
        out.append((int(ctl.current_mod), int(ctl.current_rate), bool(sw)))
    return out


def s_hysteresis(P):
    """test_sweep_adaptive.py:72"""
    c = P.AD.AdaptiveModeController()
    recs = [c.recommend(s) for s in (40.0, 31.0, 10.0)]
    assert recs == [(M.QAM64, R.R5_6), (M.QAM16, R.R3_4), (M.BPSK, R.R1_4)]
    t = trace(c, [(20.0,), (18.4,), (18.3,), (18.6,), (12.0,)])
    assert [s for *_, s in t] == [True, False, False, False, True]
    assert t[0][:2] == (M.BPSK, R.R1_2)
    assert t[-1][:2] == (M.BPSK, R.R1_4)
    return recs, t


def s_truth_table(P):
    """test_sweep_adaptive.py:129: the 400-step LCG walk against the
    reference controller's golden trace."""
    path = os.path.join(os.path.dirname(__file__), "data", "golden",
                        "golden_adaptive_mode_trace.txt")
    ctl = P.AD.AdaptiveModeController()
    s, snr, out = 12345, 25.0, []
    with open(path) as fh:
        for ln, line in enumerate(fh):
            g_snr, g_mod, g_rate, g_sw = line.split()
            s = (s * 1664525 + 1013904223) & 0xFFFFFFFF
            u = (s >> 8) / 16777216.0
            snr = min(45.0, max(10.0, snr + (u - 0.5) * 6.0))
            assert abs(snr - float(g_snr)) < 5e-4, ln
            switched = ctl.update(np.float32(snr))
            out.append((int(ctl.current_mod), int(ctl.current_rate),
                        int(switched)))
            assert out[-1] == (int(g_mod), int(g_rate), int(g_sw)), ln
    return out


def s_control_reading_downgrade_only(P):
    """test_sweep_adaptive.py:157"""
    c = P.AD.CalibratedAdaptiveController()
    t = trace(c, [(22.0, 0.2)] * 10)
    assert t[-1][:2] == (M.QAM16, R.R2_3)
    up = trace(c, [(40.0, 0.2)] * 10, "observe_control")
    assert not any(s for *_, s in up)
    assert up[-1][:2] == (M.QAM16, R.R2_3)
    down = trace(c, [(18.0, 5.0)] * 3, "observe_control")
    assert any(s for *_, s in down)
    rank = P.C.bits_per_symbol(c.current_mod) * P.C.code_rate_value(
        c.current_rate)
    assert rank < P.C.bits_per_symbol(M.QAM16) * P.C.code_rate_value(R.R2_3)
    return t, up, down


def s_flat_evidence_decays(P):
    """test_sweep_adaptive.py:190"""
    c = P.AD.CalibratedAdaptiveController()
    t = trace(c, [(35.0, -1.0)] * 12)
    assert c._flat_frames >= 3
    t += trace(c, [(33.0 + 2.0 * (i % 2), -1.0) for i in range(16)])
    assert c._flat_frames == 0
    return t


def s_calibrated_high_order_flat_gate(P):
    """test_sweep_adaptive.py:206"""
    runs = []

    def run(readings):
        c = P.AD.CalibratedAdaptiveController()
        runs.append(trace(c, readings))
        return c

    c = run([(33.0 + 4.0 * (i % 2), -1.0) for i in range(24)])
    assert c.current_mod not in (M.QAM64, M.QAM256)
    c = run([(35.0, -1.0)] * 20)
    assert (c.current_mod, c.current_rate) == (M.QAM256, R.R2_3)
    c = run([(35.0, 5.0)] * 20)
    assert c.current_mod not in (M.QAM64, M.QAM256)
    c = run([(35.0, 0.2)] * 20)
    assert (c.current_mod, c.current_rate) == (M.QAM256, R.R2_3)
    c = run([(27.0, 0.2)] * 20)
    assert (c.current_mod, c.current_rate) == (M.QAM64, R.R2_3)
    runs.append(trace(c, [(27.0, 6.0)] * 10))
    assert c.current_mod not in (M.QAM64, M.QAM256)
    # The step-down ladder of the ARQ-stall fallback, from the top.
    steps = []
    while c.step_down():
        steps.append((int(c.current_mod), int(c.current_rate)))
    return runs, steps, [tuple(map(float, r[:1])) + tuple(map(int, r[1:]))
                         for r in P.AD.CalibratedAdaptiveController.HIGH_TABLE]


@pytest.mark.parametrize("scenario", [
    s_hysteresis, s_truth_table, s_control_reading_downgrade_only,
    s_flat_evidence_decays, s_calibrated_high_order_flat_gate],
    ids=lambda s: s.__name__[2:])
def test_controller_twin(scenario):
    both(scenario)


@pytest.mark.parametrize("name", ["ModemConfig", "nvis_mode",
                                  "high_throughput", "turbo"])
def test_profile_tables_equal(name):
    """high_order_table / exact_order_table per profile (the ladders the
    ProtocolEngine installs under calibrated_snr)."""
    jcfg = getattr(JC, name)()
    tcfg = port_config(jcfg)
    for fn in ("high_order_table", "exact_order_table"):
        assert getattr(TAD, fn)(tcfg) == getattr(JAD, fn)(jcfg), fn


# ---------------------------------------------------------------------------
# The controller inside a session (test_sweep_adaptive.py:95)
# ---------------------------------------------------------------------------

def test_adaptive_mode_over_the_air():
    """Per-frame SNR readings drive MODE_CHANGE through a live session
    (the two Connections wired frame-wise), on both packages."""
    from projectultra_tpu.modem.engine import DecodedFrame as JFrame
    from projectultra_tpu.protocol import frame_v2 as JF
    from projectultra_tpu.protocol.engine import ProtocolEngine as JPE
    from projectultra_tpu_torch.modem.engine import DecodedFrame as TFrame
    from projectultra_tpu_torch.protocol.engine import ProtocolEngine as TPE

    out = {}
    for side, (PE, F, Frame) in {"jax": (JPE, JF, JFrame),
                                 "port": (TPE, TF, TFrame)}.items():
        kw = {} if side == "jax" else {"device": CPU}
        a, b = PE(**kw), PE(**kw)
        a.connection.set_local_callsign("W1AW")
        b.connection.set_local_callsign("VE3ABC")
        b.connection.set_measured_snr(21.0)
        a.connection.on_transmit = b.connection.on_frame_received
        b.connection.on_transmit = a.connection.on_frame_received
        a.connection.connect("VE3ABC")
        a.connection.on_pong_received()
        assert a.connection.is_connected and b.connection.is_connected
        ka = F.ControlFrame.make_keepalive("VE3ABC", "W1AW")
        hdr = F.parse_header(ka.serialize().ljust(F.BYTES_PER_CODEWORD,
                                                  b"\0"))
        seen = []
        for snr, wf in ((39.0, F.WaveformMode.OFDM_COX),
                        (16.0, F.WaveformMode.MC_DPSK)):
            a._on_modem_frame(Frame(frame_bytes=ka.serialize(), header=hdr,
                                    cw_ok=[True], snr_db=snr, waveform=wf))
            seen.append((int(a.modem.data_modulation),
                         int(a.modem.data_code_rate),
                         int(b.modem.data_modulation),
                         int(b.modem.data_code_rate)))
        out[side] = seen
    assert out["port"] == out["jax"]
    assert out["port"][-1][0] == M.QAM64 and out["port"][-1][2] == M.QAM64


# ---------------------------------------------------------------------------
# Calibrated negotiation (tests/test_protocol.py:560-640)
# ---------------------------------------------------------------------------

def s_calibrated_tables_and_waveform_pick(P):
    """test_protocol.py:560"""
    WM = TF.WaveformMode
    f = P.CONN.recommend_data_mode_calibrated
    assert f(8.0) == (M.DBPSK, R.R1_4)
    assert f(12.0) == (M.DQPSK, R.R1_4)
    assert f(16.0) == (M.DQPSK, R.R1_2)
    assert f(21.0) == (M.QAM16, R.R2_3)
    picks = []
    for cal, snrs in ((True, (8.0, 16.0, 18.0, -6.0)), (False, (8.0, 18.0))):
        c = P.CONN.Connection(P.CONN.ConnectionConfig(calibrated_snr=cal))
        for snr in snrs:
            c.set_measured_snr(snr)
            picks.append(int(c.negotiate_mode(0xFF, WM.AUTO)))
    assert picks == [WM.MC_DPSK, WM.MC_DPSK, WM.OFDM_COX, WM.MFSK,
                     WM.MC_DPSK, WM.OFDM_COX]
    return picks


def test_calibrated_tables_and_waveform_pick():
    both(s_calibrated_tables_and_waveform_pick)


@pytest.mark.parametrize("wf,true_snr,band", [
    ("MC_DPSK", 6.0, (-5.0, 1.0)), ("MC_DPSK", 14.0, (-5.0, 1.0)),
    ("DPSK", 8.0, (-2.0, 1.0))])
def test_wideband_snr_estimator_tracks_truth(wf, true_snr, band):
    """test_protocol.py:596: an ACK through JAX's AWGN, decoded by both
    packages' engines (held to each other by the engine twin); the port's
    wideband estimate is conservative and never optimistic."""
    from test_torch_engine import feeds, twin, tx_audio
    frame = TF.ControlFrame.make_ack("AA1AA", "BB2BB", 1).serialize()
    setup = dict(waveform=wf, connect_waveform=wf)
    audio = tx_audio(frame, **setup)
    a = jnp.asarray(np.concatenate([np.zeros(2400, np.float32), audio,
                                    np.zeros(4000, np.float32)])[None, :])
    noisy = np.asarray(JW.add_noise_active(jax.random.PRNGKey(31), a,
                                           true_snr))[0]
    frames = twin(feeds(noisy), **setup).frames
    assert frames, f"no decode at {true_snr} dB"
    err = frames[0].wideband_snr_db - true_snr
    assert band[0] <= err <= band[1], frames[0].wideband_snr_db

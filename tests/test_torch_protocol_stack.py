"""The port's protocol stack against the JAX package's: compression, ARQ,
file transfer and the connection manager.

These modules are host-only, and the port keeps copies of them.  Each
copy is pinned two ways: its source equals the original's apart from the
module docstring (``test_copy_matches_original``), and every scenario
below runs the same script on both packages and holds the two logs to
each other -- every frame on the wire, byte for byte, and every callback,
in order -- before the JAX test's own assertions run on the port's side.
Scenarios are twins of tests/test_protocol.py (the line of each JAX test
stands in its docstring).
"""

import ast
import pathlib
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from projectultra_tpu import config as JC  # noqa: E402
from projectultra_tpu.protocol import arq as JARQ  # noqa: E402
from projectultra_tpu.protocol import compression as JZ  # noqa: E402
from projectultra_tpu.protocol import connection as JCONN  # noqa: E402
from projectultra_tpu.protocol import frame_v2 as JF  # noqa: E402

from projectultra_tpu_torch import config as TC  # noqa: E402
from projectultra_tpu_torch.protocol import arq as TARQ  # noqa: E402
from projectultra_tpu_torch.protocol import compression as TZ  # noqa: E402
from projectultra_tpu_torch.protocol import connection as TCONN  # noqa: E402
from projectultra_tpu_torch.protocol import frame_v2 as TF  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent

PKG = {"jax": types.SimpleNamespace(C=JC, F=JF, ARQ=JARQ, CONN=JCONN, Z=JZ),
       "port": types.SimpleNamespace(C=TC, F=TF, ARQ=TARQ, CONN=TCONN, Z=TZ)}


# ---------------------------------------------------------------------------
# Source pins of the copies
# ---------------------------------------------------------------------------

def module_body(path: pathlib.Path) -> str:
    """The module's AST without its docstring and without imports of jax
    (the JAX adaptive module imports jax.numpy and never uses it)."""
    tree = ast.parse(path.read_text())
    body = tree.body
    if body and isinstance(body[0], ast.Expr) \
            and isinstance(body[0].value, ast.Constant):
        body = body[1:]
    body = [n for n in body if not (
        isinstance(n, ast.Import)
        and all(a.name.split(".")[0] == "jax" for a in n.names))]
    return ast.dump(ast.Module(body=body, type_ignores=[]))


def assert_copy(rel: str):
    assert module_body(ROOT / "projectultra_tpu_torch" / rel) \
        == module_body(ROOT / "projectultra_tpu" / rel), rel


@pytest.mark.parametrize("rel", ["protocol/compression.py",
                                 "protocol/arq.py",
                                 "protocol/file_transfer.py",
                                 "protocol/connection.py"])
def test_copy_matches_original(rel):
    assert_copy(rel)


# ---------------------------------------------------------------------------
# Twin harness
# ---------------------------------------------------------------------------

def both(scenario, *args):
    """Runs ``scenario(P, *args)`` on each package (``P`` its modules) and
    holds the returned logs equal; returns the port's."""
    logs = {side: scenario(PKG[side], *args) for side in ("jax", "port")}
    assert logs["port"] == logs["jax"]
    return logs["port"]


def wire(log, name, deliver):
    """A transmit callback that records ("tx", name, frame bytes) and then
    hands the frame on."""
    def tx(frame):
        log.append(("tx", name, bytes(frame)))
        deliver(frame)
    return tx


def recorder(log, name):
    return lambda *a: log.append((name, *a))


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------

def test_compression_round_trip_equals_jax():
    rng = np.random.default_rng(0)
    texts = [b"", b"The quick brown fox jumps over the lazy dog. " * 40,
             bytes(rng.integers(0, 256, 600, dtype=np.uint8)),
             bytes(rng.integers(0, 4, 2000, dtype=np.uint8))]
    for data in texts:
        c = TZ.compress(data)
        assert c == JZ.compress(data)
        assert TZ.decompress(c, len(data)) == data
        assert TZ.maybe_compress(data) == JZ.maybe_compress(data)
    assert TZ.decompress(b"not deflate") is None
    assert TZ.decompress(TZ.compress(b"abc"), 4) is None


# ---------------------------------------------------------------------------
# ARQ (tests/test_protocol.py:27-100, :150-240)
# ---------------------------------------------------------------------------

def s_stop_and_wait_roundtrip(P):
    """test_protocol.py:27"""
    log = []
    a, b = P.ARQ.StopAndWaitARQ(), P.ARQ.StopAndWaitARQ()
    a.set_callsigns("W1AW", "VE3ABC")
    b.set_callsigns("VE3ABC", "W1AW")
    a.on_transmit = wire(log, "a", lambda f: b.on_frame_received(f))
    b.on_transmit = wire(log, "b", lambda f: a.on_frame_received(f))
    got, done = [], []
    b.on_data_received = lambda d: (got.append(d), log.append(("data", d)))
    a.on_send_complete = lambda ok: (done.append(ok), log.append(("done", ok)))
    assert a.send_data(b"hello")
    assert got == [b"hello"]
    assert done == [True]
    assert a.is_ready_to_send()
    return log


def s_stop_and_wait_retry_then_fail(P):
    """test_protocol.py:42"""
    log = []
    a = P.ARQ.StopAndWaitARQ(P.ARQ.ARQConfig(ack_timeout_ms=100,
                                             max_retries=2))
    a.set_callsigns("W1AW", "VE3ABC")
    sent = []
    a.on_transmit = wire(log, "a", sent.append)
    done = []
    a.on_send_complete = lambda ok: (done.append(ok), log.append(("done", ok)))
    a.send_data(b"x")
    assert len(sent) == 1
    for _ in range(3):
        a.tick(150)
    assert len(sent) == 3
    assert done == [False]
    assert a.stats.failed == 1
    return log + [("stats", a.stats.failed, a.stats.retransmissions)]


def s_selective_repeat_window_and_sack(P):
    """test_protocol.py:59"""
    log = []
    cfg = P.ARQ.ARQConfig(window_size=4)
    a, b = P.ARQ.SelectiveRepeatARQ(cfg), P.ARQ.SelectiveRepeatARQ(cfg)
    a.set_callsigns("W1AW", "VE3ABC")
    b.set_callsigns("VE3ABC", "W1AW")
    got = []
    b.on_data_received = lambda d: (got.append(d), log.append(("data", d)))
    a_frames = []
    a.on_transmit = wire(log, "a", a_frames.append)
    b.on_transmit = wire(log, "b", lambda f: a.on_frame_received(f))
    for i in range(4):
        assert a.send_data(f"msg{i}".encode())
    assert not a.is_ready_to_send()
    assert len(a_frames) == 4
    for idx in (1, 0, 3, 2):
        b.on_frame_received(a_frames[idx])
    assert got == [b"msg0", b"msg1", b"msg2", b"msg3"]
    assert b.stats.out_of_order > 0
    assert a.in_flight == 0
    assert a.is_ready_to_send()
    return log + [("ooo", b.stats.out_of_order)]


def s_selective_repeat_nack_retransmit(P):
    """test_protocol.py:87"""
    log = []
    a = P.ARQ.SelectiveRepeatARQ(P.ARQ.ARQConfig(window_size=4))
    a.set_callsigns("W1AW", "VE3ABC")
    sent = []
    a.on_transmit = wire(log, "a", sent.append)
    a.send_data(b"payload")
    nack = P.F.ControlFrame.make_nack("VE3ABC", "W1AW", 0, 0x01)
    a.on_frame_received(nack.serialize())
    assert len(sent) == 2
    assert a.stats.retransmissions == 1
    return log


def s_stale_ack_does_not_ack_window(P):
    """test_protocol.py:150"""
    log = []
    cfg = P.ARQ.ARQConfig(window_size=4)
    tx, rx = P.ARQ.SelectiveRepeatARQ(cfg), P.ARQ.SelectiveRepeatARQ(cfg)
    tx.set_callsigns("W1AW", "VE3ABC")
    rx.set_callsigns("VE3ABC", "W1AW")
    sent = []
    tx.on_transmit = wire(log, "tx", sent.append)
    rx.on_transmit = wire(log, "rx", lambda f: tx.on_frame_received(f))
    rx.on_data_received = recorder(log, "data")
    for i in range(3):
        assert tx.send_data(bytes([i]))
    for f in list(sent):
        rx.on_frame_received(f)
    assert tx.in_flight == 0 and tx.tx_base == 3
    sent.clear()
    assert tx.send_data(b"x")
    assert tx.send_data(b"y")
    assert tx.in_flight == 2
    stale = P.F.ControlFrame.make_ack("VE3ABC", "W1AW", 0)
    tx.on_frame_received(stale.serialize())
    assert tx.in_flight == 2
    assert tx.tx_base == 3
    return log


def s_sack_coalescing_counts_and_gap_flush(P):
    """test_protocol.py:184"""
    log = []
    cfg = P.ARQ.ARQConfig(window_size=4)
    tx, rx = P.ARQ.SelectiveRepeatARQ(cfg), P.ARQ.SelectiveRepeatARQ(cfg)
    rx.sack_every = 3
    tx.set_callsigns("W1AW", "VE3ABC")
    rx.set_callsigns("VE3ABC", "W1AW")
    sent, delivered = [], []
    tx.on_transmit = wire(log, "tx", sent.append)
    rx.on_transmit = wire(log, "rx", lambda f: tx.on_frame_received(f))
    rx.on_data_received = lambda d: (delivered.append(d),
                                     log.append(("data", d)))
    for i in range(3):
        assert tx.send_data(bytes([i]))
    assert len(sent) == 3
    s0 = rx.stats.sacks_sent
    for f in sent[:3]:
        rx.on_frame_received(f)
    assert rx.stats.sacks_sent - s0 == 1
    assert delivered == [bytes([0]), bytes([1]), bytes([2])]
    assert tx.in_flight == 0
    sent.clear()
    for i in range(3, 6):
        assert tx.send_data(bytes([i]))
    dropped = sent[0]
    s1 = rx.stats.sacks_sent
    rx.on_frame_received(sent[1])
    assert rx.stats.sacks_sent - s1 == 1
    rx.on_frame_received(sent[2])
    assert rx.stats.sacks_sent - s1 == 2
    rx.on_frame_received(dropped)
    assert delivered[-3:] == [bytes([3]), bytes([4]), bytes([5])]
    assert tx.in_flight == 0
    sent.clear()
    for i in range(6, 8):
        assert tx.send_data(bytes([i]))
    s2 = rx.stats.sacks_sent
    for f in sent:
        rx.on_frame_received(f)
    assert rx.stats.sacks_sent - s2 == 0
    rx.tick(rx.sack_holdoff_ms + 1)
    assert rx.stats.sacks_sent - s2 == 1
    assert tx.in_flight == 0
    return log + [("sacks", rx.stats.sacks_sent)]


@pytest.mark.parametrize("scenario", [
    s_stop_and_wait_roundtrip, s_stop_and_wait_retry_then_fail,
    s_selective_repeat_window_and_sack, s_selective_repeat_nack_retransmit,
    s_stale_ack_does_not_ack_window, s_sack_coalescing_counts_and_gap_flush],
    ids=lambda s: s.__name__[2:])
def test_arq_twin(scenario):
    log = both(scenario)
    assert any(k == "tx" for k, *_ in log)


def test_create_arq_modes():
    for mode in TARQ.ARQMode:
        t = TARQ.create_arq(mode)
        j = JARQ.create_arq(JARQ.ARQMode(int(mode)))
        assert type(t).__name__ == type(j).__name__
        assert t.config == TARQ.ARQConfig(**vars(j.config))


# ---------------------------------------------------------------------------
# Connection (tests/test_protocol.py:100-150, :397-449, :694-766)
# ---------------------------------------------------------------------------

def test_recommend_data_mode_table():
    """test_protocol.py:100, on every SNR from -10 to 45 dB in 0.25 dB."""
    for snr in np.arange(-10.0, 45.0, 0.25):
        for fn in ("recommend_data_mode", "recommend_data_mode_calibrated"):
            assert getattr(TCONN, fn)(float(snr)) == \
                getattr(JCONN, fn)(float(snr)), (fn, snr)
    M, R = TC.Modulation, TC.CodeRate
    assert TCONN.recommend_data_mode(31) == (M.QAM16, R.R3_4)
    assert TCONN.recommend_data_mode(26) == (M.QAM16, R.R2_3)
    assert TCONN.recommend_data_mode(21) == (M.DQPSK, R.R2_3)
    assert TCONN.recommend_data_mode(17) == (M.DQPSK, R.R1_2)
    assert TCONN.recommend_data_mode(13) == (M.DQPSK, R.R1_4)
    assert TCONN.recommend_data_mode(5) == (M.DBPSK, R.R1_4)


def connected_pair(P, log, **cfg):
    """Two Connections wired frame-wise (every frame recorded), connected
    through PING / PONG / CONNECT / CONNECT_ACK."""
    a = P.CONN.Connection(P.CONN.ConnectionConfig(**cfg))
    b = P.CONN.Connection(P.CONN.ConnectionConfig(**cfg))
    a.set_local_callsign("W1AW")
    b.set_local_callsign("VE3ABC")
    a.on_transmit = wire(log, "a", lambda f: b.on_frame_received(f))
    b.on_transmit = wire(log, "b", lambda f: a.on_frame_received(f))
    return a, b


def s_connection_handshake(P):
    """test_protocol.py:109"""
    log = []
    a, b = connected_pair(P, log)
    b.set_measured_snr(21.0)
    pings = []
    a.on_ping_tx = lambda: (pings.append(1), log.append(("ping",)))
    assert a.connect("VE3ABC")
    assert a.state == P.CONN.ConnectionState.PROBING
    assert pings == [1]
    a.on_pong_received()
    assert b.state == P.CONN.ConnectionState.CONNECTED
    assert a.state == P.CONN.ConnectionState.CONNECTED
    assert b.remote_call == "W1AW" and a.remote_call == "VE3ABC"
    assert b.negotiated_mode == P.F.WaveformMode.OFDM_COX
    assert a.data_modulation == P.C.Modulation.DQPSK
    assert a.data_code_rate == P.C.CodeRate.R2_3
    got_b, got_a = [], []
    b.on_message_received = got_b.append
    a.on_message_received = got_a.append
    assert a.send_message("hello b")
    assert got_b == ["hello b"]
    assert b.send_message("hello a")
    assert got_a == ["hello a"]
    a.disconnect()
    assert b.state == P.CONN.ConnectionState.DISCONNECTED
    a.tick(60000)
    assert a.state == P.CONN.ConnectionState.DISCONNECTED
    return log + [("states", int(a.state), int(b.state))]


def s_mode_change_mid_session(P):
    """test_protocol.py:397"""
    log = []
    a, b = connected_pair(P, log)
    a.connect("VE3ABC")
    a.on_pong_received()
    assert a.is_connected and b.is_connected
    changes = []
    b.on_data_mode_changed = lambda m, r, s: (changes.append((m, r)),
                                              log.append(("mode", m, r, s)))
    M, R = P.C.Modulation, P.C.CodeRate
    assert a.request_mode_change(M.QAM16, R.R2_3)
    assert a.data_modulation == M.QAM16
    assert b.data_modulation == M.QAM16
    assert b.data_code_rate == R.R2_3
    assert changes and changes[-1] == (M.QAM16, R.R2_3)
    got = []
    b.on_message_received = got.append
    assert a.send_message("post-change")
    assert got == ["post-change"]
    return log


def s_many_messages_soak(P):
    """test_protocol.py:423"""
    log = []
    a, b = connected_pair(P, log)
    a.connect("VE3ABC")
    a.on_pong_received()
    assert a.is_connected and b.is_connected
    got_b, got_a = [], []
    b.on_message_received = got_b.append
    a.on_message_received = got_a.append
    for i in range(200):
        assert a.send_message(f"a{i}")
        assert b.send_message(f"b{i}")
        if i % 25 == 0:
            a.tick(1000)
            b.tick(1000)
    assert got_b == [f"a{i}" for i in range(200)]
    assert got_a == [f"b{i}" for i in range(200)]
    assert a.is_connected and b.is_connected
    return log


@pytest.mark.parametrize("scenario", [
    s_connection_handshake, s_mode_change_mid_session, s_many_messages_soak],
    ids=lambda s: s.__name__[2:])
def test_connection_twin(scenario):
    both(scenario)


def s_fade_spread_benign_relaxation(P):
    """test_protocol.py:694"""
    WM = P.F.WaveformMode
    c = P.CONN.Connection(P.CONN.ConnectionConfig(calibrated_snr=True))
    picks = []

    def pick(snr, spread=None):
        if spread is None:
            c.set_measured_snr(snr)
        else:
            c.set_measured_snr(snr, spread)
        picks.append((int(c.negotiate_mode(0xFF, WM.AUTO)),
                      c.measured_fade_spread_db))
        return c.negotiate_mode(0xFF, WM.AUTO)

    assert pick(12.0) == WM.MC_DPSK
    assert pick(12.0, 0.2) == WM.OFDM_COX
    assert pick(10.0, 0.2) == WM.MC_DPSK
    assert pick(12.0, 6.0) == WM.MC_DPSK
    assert pick(12.0, 0.2) == WM.MC_DPSK
    c.set_measured_snr(12.0, -1.0)
    assert c.measured_fade_spread_db > 2.5
    d = P.CONN.Connection(P.CONN.ConnectionConfig())
    d.set_measured_snr(12.0, 0.2)
    assert d.negotiate_mode(0xFF, WM.AUTO) == WM.MC_DPSK
    return picks + [c.measured_fade_spread_db]


def test_fade_spread_benign_relaxation_twin():
    both(s_fade_spread_benign_relaxation)


def test_fade_spread_metric_separation():
    """test_protocol.py:724: one CONNECT frame through JAX's AWGN and
    Watterson ``moderate`` at 12 dB, decoded by both packages' engines
    (the engine twin's tolerances); the fade-spread metric separates the
    two channels on the port's frames."""
    import jax
    import jax.numpy as jnp
    from projectultra_tpu.sim import watterson as JW
    from test_torch_engine import feeds, twin, tx_audio

    cf = TF.ConnectFrame.make_connect(
        "W1AW", "VE3ABC", int(TF.ModeCapabilities.ALL), 0, 0xFF, 0xFF)
    audio = tx_audio(cf.serialize())
    a = jnp.asarray(np.concatenate([np.zeros(2000, np.float32), audio,
                                    np.zeros(4000, np.float32)])[None, :])
    key = jax.random.PRNGKey(156)
    awgn = np.asarray(JW.add_noise_active(key, a, 12.0))[0]
    fading = np.asarray(JW.watterson(key, a, JW.PRESETS["moderate"](12.0)))[0]
    fa = twin(feeds(awgn)).frames
    fm = twin(feeds(fading)).frames
    assert len(fa) == 1 and len(fm) == 1
    assert 0.0 <= fa[0].fade_spread_db < 1.5, fa[0].fade_spread_db
    assert abs(fa[0].wideband_snr_db - 12.0) <= 1.5, fa[0].wideband_snr_db
    assert fm[0].fade_spread_db >= 2.5, fm[0].fade_spread_db


# ---------------------------------------------------------------------------
# File transfer (tests/test_protocol.py:240-328)
# ---------------------------------------------------------------------------

def s_pipelined_transfer_message_ack(P, tmp):
    """test_protocol.py:240"""
    log = []
    a, b = P.CONN.Connection(), P.CONN.Connection()
    a.set_local_callsign("W1AW")
    b.set_local_callsign("VE3ABC")
    a_out, b_out = [], []
    a.on_transmit = wire(log, "a", a_out.append)
    b.on_transmit = wire(log, "b", b_out.append)
    (tmp / "rx").mkdir()
    b.file_transfer.receive_dir = str(tmp / "rx")
    a.connect("VE3ABC")
    for _ in range(6):
        while a_out:
            b.on_frame_received(a_out.pop(0))
        while b_out:
            a.on_frame_received(b_out.pop(0))
        if a.is_connected and b.is_connected:
            break
        a.on_pong_received()
    assert a.is_connected and b.is_connected
    a_out.clear(), b_out.clear()
    src = tmp / "payload.bin"
    content = bytes(np.random.default_rng(3).integers(
        0, 256, 480, dtype=np.uint8))
    src.write_bytes(content)
    sent_events, msg_events, received = [], [], []
    a.file_transfer.on_sent = lambda ok, msg: sent_events.append(ok)
    a.on_message_sent = msg_events.append
    b.file_transfer.on_received = lambda path, ok: received.append((path, ok))
    assert a.send_message("before-transfer")
    assert a.send_file(str(src))
    assert len(a_out) >= 4
    held_last = a_out.pop()
    while a_out:
        b.on_frame_received(a_out.pop(0))
    while b_out:
        a.on_frame_received(b_out.pop(0))
    assert msg_events == [True]
    assert not sent_events
    assert a.file_transfer.is_in_progress()
    assert not received
    b.on_frame_received(held_last)
    while b_out:
        a.on_frame_received(b_out.pop(0))
    assert sent_events == [True]
    assert received and received[0][1]
    with open(received[0][0], "rb") as f:
        assert f.read() == content
    return log + [("events", sent_events, msg_events,
                   pathlib.Path(received[0][0]).name)]


def s_file_transfer_roundtrip(P, tmp):
    """test_protocol.py:308"""
    log = []
    a, b = connected_pair(P, log)
    b.file_transfer.receive_dir = str(tmp)
    a.connect("VE3ABC")
    a.on_pong_received()
    assert a.is_connected and b.is_connected
    src = tmp / "payload.txt"
    content = b"The quick brown fox jumps over the lazy dog. " * 40
    src.write_bytes(content)
    received = []
    b.file_transfer.on_received = lambda path, ok: received.append((path, ok))
    assert a.send_file(str(src))
    assert received and received[0][1]
    assert open(received[0][0], "rb").read() == content
    return log + [("file", pathlib.Path(received[0][0]).name)]


@pytest.mark.parametrize("scenario", [s_pipelined_transfer_message_ack,
                                      s_file_transfer_roundtrip],
                         ids=lambda s: s.__name__[2:])
def test_file_transfer_twin(scenario, tmp_path):
    logs = {}
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        logs[side] = scenario(PKG[side], tmp_path / side)
    assert logs["port"] == logs["jax"]

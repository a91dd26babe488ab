"""The port's GUI front-ends against the JAX tools on the CPU:
``tools/torch_tui.py`` against ``tools/tui.py`` and
``tools/torch_webui.py`` against ``tools/webui.py``.

* The tui renderers (waterfall, constellation, dashboard) give the JAX
  tool's text for the same audio, points and station state.  A waterfall
  cell may only differ where its normalized level sits within float32
  error of an ASCII-ramp boundary (the two packages' STFTs differ in the
  last bits).
* ``--sim --cpu`` runs on JAX's recorded air: the JAX tool's ``main`` runs
  first with ``projectultra_tpu.sim.watterson.add_noise_active`` recorded,
  then the twin's ``channel`` replays it transmission by transmission
  (the twin's audio within 2e-4 of JAX's, the golden TX tolerance); the
  dashboards at all four steps equal JAX's, and RESULT: PASS.
* The webui twin's scripted session (``--cpu --script --port 0``: its own
  free port, never the 8761 of tests/test_aux.py) exits 0 and prints
  PASS; ``Station.state()``'s status and console equal the JAX
  ``Station``'s after connect and send on JAX's replayed air; every engine
  access of an action served on an HTTP worker thread holds
  ``Station.lock``.
"""

import os

for _flag in ("ULTRA_CHIRP_BF16", "ULTRA_LDPC_BF16", "ULTRA_EXCISION",
              "ULTRA_BLANKER"):
    os.environ.pop(_flag, None)

import json  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import types  # noqa: E402
import urllib.request  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

import jax  # noqa: E402,F401

from projectultra_tpu.utils import observability as JO  # noqa: E402

from projectultra_tpu_torch.config import CodeRate, Modulation  # noqa: E402
from projectultra_tpu_torch.protocol.connection import ConnectionState  # noqa: E402
from projectultra_tpu_torch.protocol.frame_v2 import WaveformMode  # noqa: E402

from test_torch_tools_batch import TOOLS, tool  # noqa: E402
from test_torch_tools_session import record_air, replay_air  # noqa: E402

CPU = torch.device("cpu")
# Float32 error of a normalized waterfall level, scaled to the ramp's
# nine steps: the dB values span ~100 dB, so one ulp of a dB value moves
# the level by ~1e-7 of a step.
RAMP_EDGE_TOL = 1e-4


def _jax_webui():
    """tools/webui.py imports ``threaded_simulator`` from its own
    directory, as it does when run as a script."""
    sys.path.insert(0, str(TOOLS))
    try:
        return tool("webui")
    finally:
        sys.path.remove(str(TOOLS))


def _ramp_levels(audio, width=64, lines=12):
    """The waterfall render's levels (``v * (len(RAMP) - 1)``) from the JAX
    package's waterfall."""
    db, freqs = JO.waterfall(audio)
    db = db[-lines:, freqs <= 3000.0]
    lo, hi = db.min(), max(db.max(), db.min() + 1e-6)
    norm = (db - lo) / (hi - lo)
    cols = np.linspace(0, norm.shape[1] - 1, width).astype(int)
    return norm[:, cols] * 9


def assert_same_waterfall(port_rows, jax_rows, audio):
    """Rows equal, but for cells whose level sits within float32 error of
    a ramp boundary (one step apart)."""
    assert len(port_rows) == len(jax_rows)
    levels = None
    for r, (pr, jr) in enumerate(zip(port_rows, jax_rows)):
        assert len(pr) == len(jr)
        for c, (pc, jc) in enumerate(zip(pr, jr)):
            if pc == jc:
                continue
            if levels is None:
                levels = _ramp_levels(audio)
            v = float(levels[r, c])
            ramp = tool("torch_tui").RAMP
            assert abs(ramp.index(pc) - ramp.index(jc)) == 1, (r, c, pc, jc)
            assert abs(v - round(v)) <= RAMP_EDGE_TOL, (r, c, v)


def assert_same_dashboard(port, ref, audio):
    """Dashboards equal line for line; waterfall lines as above."""
    pl, jl = port.splitlines(), ref.splitlines()
    assert len(pl) == len(jl), (port, ref)
    i0 = jl.index(" waterfall (0-3 kHz):") + 1
    i1 = next(i for i in range(i0, len(jl)) if not jl[i].startswith("   "))
    assert pl[:i0] == jl[:i0]
    assert pl[i1:] == jl[i1:]
    if audio is None:
        assert pl[i0:i1] == jl[i0:i1]
    else:
        assert_same_waterfall([x[3:] for x in pl[i0:i1]],
                              [x[3:] for x in jl[i0:i1]], audio)


# ---------------------------------------------------------------------------
# tui
# ---------------------------------------------------------------------------

def _station(pts):
    """A station's state as render_dashboard reads it."""
    stats = types.SimpleNamespace(current_snr_db=14.26, frames_sent=5,
                                  frames_received=4)
    modem = types.SimpleNamespace(
        data_modulation=Modulation.QPSK, data_code_rate=CodeRate.R2_3,
        stats=stats, pings_received=1, last_constellation=pts)
    conn = types.SimpleNamespace(
        state=ConnectionState.CONNECTED, remote_call="VE3ABC",
        negotiated_mode=WaveformMode.OFDM_CHIRP, is_connected=True)
    return types.SimpleNamespace(connection=conn, modem=modem)


def test_tui_renderers_match_jax():
    rng = np.random.default_rng(21)
    t = np.arange(48000 * 2) / 48000.0
    audio = (np.sin(2 * np.pi * 1500.0 * t) * (t > 0.5)
             + rng.normal(0, 0.3, len(t))).astype(np.float32)
    pts = (rng.choice([-1, 1], 700) + 1j * rng.choice([-1, 1], 700)) \
        / np.sqrt(2) + rng.normal(0, 0.08, 700) + 1j * rng.normal(0, 0.08, 700)
    ref, twin = tool("tui"), tool("torch_tui")
    assert twin.RAMP == ref.RAMP
    assert_same_waterfall(twin.render_waterfall(audio),
                          ref.render_waterfall(audio), audio)
    assert twin.render_waterfall(torch.from_numpy(audio)) \
        == twin.render_waterfall(audio)
    assert twin.render_waterfall(audio[:4000]) \
        == ref.render_waterfall(audio[:4000]) == ["(no audio yet)"]
    assert twin.render_constellation(pts) == ref.render_constellation(pts)
    assert twin.render_constellation(None) == ref.render_constellation(None)
    for points, sound in ((pts, audio), (None, None)):
        station = _station(points)
        msgs = ["me> hi", "VE3ABC> a", "VE3ABC> b", "me> c", "VE3ABC> d"]
        assert_same_dashboard(
            twin.render_dashboard("W1AW (local)", station, sound, msgs),
            ref.render_dashboard("W1AW (local)", station, sound, msgs), sound)
    assert twin.render_dashboard("t", _station(None), None, []).endswith(
        " console:\n   (empty)")


def _dashboards(out):
    """{step: dashboard text} from a tui --sim run's output."""
    steps, cur = {}, None
    for line in out.splitlines():
        if line.startswith("--- "):
            cur = line.split()[1]
            steps[cur] = []
        elif line.startswith("RESULT:"):
            cur = None
        elif cur is not None and line:
            steps[cur].append(line)
    return {k: "\n".join(v) for k, v in steps.items()}


def test_tui_sim_matches_jax(monkeypatch, capsys):
    rec = record_air(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["tui.py", "--sim", "--cpu"])
    assert tool("tui").main() == 0
    jout = capsys.readouterr().out
    twin = tool("torch_tui")
    left = replay_air(twin, rec)
    heard = []      # the audio each of the twin's dashboards rendered
    render = twin.render_dashboard

    def recording(title, station, last_audio, messages):
        heard.append(None if last_audio is None
                     else np.asarray(last_audio.cpu()))
        return render(title, station, last_audio, messages)

    twin.render_dashboard = recording
    assert twin.main(["--sim", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert left == []
    assert "RESULT: PASS" in out and "RESULT: PASS" in jout
    res = json.loads(out.strip().splitlines()[-1])
    assert res["result"] == "PASS" and res["device"] == "cpu"
    ours, ref = _dashboards(out), _dashboards(jout)
    assert list(ours) == list(ref) == ["startup", "connected", "chat",
                                       "disconnected"]
    # The replayed air is JAX's, so both dashboards render the same audio.
    for step, audio in zip(ref, heard):
        assert_same_dashboard(ours[step], ref[step], audio)


def test_tui_without_sim_returns_2(capsys):
    assert tool("torch_tui").main(["--cpu"]) == 2
    assert "run with --sim" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# webui
# ---------------------------------------------------------------------------

def test_webui_script_passes(capsys):
    rc = tool("torch_webui").main(["--cpu", "--script", "--port", "0"])
    out = capsys.readouterr().out
    assert rc == 0, out[-3000:]
    assert "webui scripted session: PASS" in out
    res = json.loads(out.strip().splitlines()[-1])
    assert res["result"] == "PASS" and res["device"] == "cpu"
    assert res["port"] not in (0, 8761, 8752)


def test_webui_state_matches_jax(monkeypatch):
    rec = record_air(monkeypatch)
    ref = _jax_webui().Station(15.0)
    ref.connect()
    ref.send("hello from browser")
    want = ref.state()
    twin = tool("torch_webui")
    left = replay_air(twin, rec)
    st = twin.Station(15.0, CPU)
    st.connect()
    st.send("hello from browser")
    got = st.state()
    assert left == []
    assert got["status"] == want["status"]
    assert got["console"] == want["console"]
    assert any("rx ok: hello from browser" in ln for ln in got["console"])


class _Guarded:
    """An engine whose every attribute read records whether the station's
    lock was held, and on which thread."""

    def __init__(self, engine, lock, log):
        self.__dict__.update(_engine=engine, _lock=lock, _log=log)

    def __getattr__(self, name):
        self._log.append((name, self._lock.locked(),
                          threading.current_thread() is threading.main_thread()))
        return getattr(self._engine, name)


def test_webui_actions_hold_the_lock():
    """Settings, a send while disconnected (refused, then 20 ticks of each
    station), a disconnect and the state, each served on a worker thread:
    every engine access holds the lock."""
    twin = tool("torch_webui")
    st = twin.Station(15.0, CPU)
    log = []
    st.a, st.b = _Guarded(st.a, st.lock, log), _Guarded(st.b, st.lock, log)
    srv = twin.make_server(st, 0)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{port}"
        for path, body in (("/api/settings", json.dumps(
                {"callsign": "K1ABC", "forced_modulation": "QPSK"})),
                ("/api/send", "hello"), ("/api/disconnect", "")):
            urllib.request.urlopen(base + path, data=body.encode(),
                                   timeout=120).read()
        with urllib.request.urlopen(base + "/api/state", timeout=120) as r:
            state = json.loads(r.read())
        with urllib.request.urlopen(base + "/api/settings", timeout=120) as r:
            settings = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=60)
    assert not t.is_alive()
    assert settings["callsign"] == "K1ABC"
    assert state["console"][-2:] == ["* send failed", "* disconnected"]
    names = {name for name, _, _ in log}
    assert {"connection", "modem", "send_message", "tick",
            "disconnect"} <= names
    assert all(held and not main for _, held, main in log), log
    assert not st.lock.locked()


@pytest.mark.parametrize("name", ["torch_tui", "torch_webui"])
def test_frontend_has_no_main_thread_executor(name):
    src = (TOOLS / f"{name}.py").read_text()
    assert "MainThreadExecutor" not in src and "threaded_simulator" not in src

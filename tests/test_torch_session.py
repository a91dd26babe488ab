"""Two-station sessions over the air: the port's ProtocolEngine against
the JAX package's.

Each scenario runs once with two JAX stations and once with two port
stations (``ProtocolEngine(device=cpu)``), each pair linked acoustically:
every TX audio goes through the channel into the other station's
``feed_audio``.  The two runs are held to each other turn by turn:

* every transmission: the same sender, the port's audio within 2e-4 of
  JAX's (the golden TX tolerance) -- the port's own audio is what its
  peer hears;
* after every ``feed_audio``: both stations' connection states equal;
* the delivered messages and files equal (files byte-exact).

Then the JAX test's own assertions run on the port's side.  This file
holds the clean sessions (twins of tests/test_protocol.py:330-395 and a
mode change over the air); ``test_torch_session_mixed.py`` pairs a port
station with a JAX one and ``test_torch_session_noisy.py`` runs a noisy
leg.  The harness lives here.
"""

import dataclasses

import numpy as np
import torch

torch.set_num_threads(2)

from projectultra_tpu import config as JC  # noqa: E402
from projectultra_tpu.protocol.engine import ProtocolEngine as JPE  # noqa: E402

from projectultra_tpu_torch import config as TC  # noqa: E402
from projectultra_tpu_torch.protocol.engine import ProtocolEngine as TPE  # noqa: E402

CPU = torch.device("cpu")
TX_TOL = 2e-4
PKG = {"jax": (JPE, JC), "port": (TPE, TC)}
GAP = 4000


def station(side, call, measured_snr=None):
    """One package's station: ``ProtocolEngine`` (the port's on the CPU)
    with its callsign and an optional measured SNR."""
    PE = PKG[side][0]
    e = PE() if side == "jax" else PE(device=CPU)
    e.connection.set_local_callsign(call)
    if measured_snr is not None:
        e.connection.set_measured_snr(measured_snr)
    return e


def pad(audio: np.ndarray, n: int) -> np.ndarray:
    """The clean link of tests/test_protocol.py: GAP zeros after each TX."""
    return np.concatenate([audio, np.zeros(GAP, np.float32)])


@dataclasses.dataclass
class Link:
    """An acoustic link between stations ``a`` and ``b``: each TX is
    recorded, passed through ``channel(audio, n)`` (n counts the link's
    transmissions from 1) into the other station, and both connection
    states are recorded after the peer's ``feed_audio``."""
    a: object
    b: object
    channel: object = pad
    tx: list = dataclasses.field(default_factory=list)
    states: list = dataclasses.field(default_factory=list)
    got_a: list = dataclasses.field(default_factory=list)
    got_b: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.a.on_tx_audio = lambda audio: self._carry("a", audio, self.b)
        self.b.on_tx_audio = lambda audio: self._carry("b", audio, self.a)
        self.a.connection.on_message_received = self.got_a.append
        self.b.connection.on_message_received = self.got_b.append

    def _carry(self, name, audio, dst):
        self.tx.append((name, np.array(audio, np.float32)))
        dst.feed_audio(self.channel(audio, len(self.tx)))
        self.states.append((name, int(self.a.connection.state),
                            int(self.b.connection.state)))

    def tick(self, ms):
        self.a.tick(ms)
        self.b.tick(ms)

    def retransmissions(self):
        return (self.a.connection.arq.stats.retransmissions,
                self.b.connection.arq.stats.retransmissions)


def assert_same_link(lj: Link, lt: Link):
    assert [n for n, _ in lt.tx] == [n for n, _ in lj.tx]
    for k, ((_, xj), (_, xt)) in enumerate(zip(lj.tx, lt.tx)):
        assert xt.shape == xj.shape, k
        err = float(np.abs(xt - xj).max()) if len(xj) else 0.0
        assert err <= TX_TOL, (k, err)
    assert lt.states == lj.states
    assert lt.got_a == lj.got_a and lt.got_b == lj.got_b


def run_twin(scenario, *args):
    """``scenario(side, *args)`` returns (Link, result) for one package;
    runs it on both, holds the links and results to each other and
    returns the port's."""
    lj, rj = scenario("jax", *args)
    lt, rt = scenario("port", *args)
    assert_same_link(lj, lt)
    assert rt == rj
    return lt, rt


# ---------------------------------------------------------------------------
# Clean sessions
# ---------------------------------------------------------------------------

def s_two_station(side):
    """tests/test_protocol.py:330: chirp PING/PONG, CONNECT over MC-DPSK,
    one message at the negotiated mode."""
    a = station(side, "W1AW")
    b = station(side, "VE3ABC", measured_snr=15.0)
    link = Link(a, b)
    assert a.connect("VE3ABC")
    assert a.connection.is_connected, a.connection.state
    assert b.connection.is_connected, b.connection.state
    assert b.connection.remote_call == "W1AW"
    assert a.send_message("over the air!")
    return link, (int(a.modem.waveform_mode), int(a.modem.data_modulation),
                  int(a.modem.data_code_rate))


def test_two_station_over_the_air():
    link, _ = run_twin(s_two_station)
    assert link.got_b == ["over the air!"]
    kinds = [n for n, _ in link.tx]
    assert kinds[:2] == ["a", "b"]        # PING, then PONG


def s_file_transfer(side, tmp):
    """tests/test_protocol.py:361: FILE_START/FILE_DATA chunking,
    compression, SR-ARQ and reassembly over modulated audio."""
    a = station(side, "W1AW")
    b = station(side, "VE3ABC", measured_snr=15.0)
    (tmp / side / "rx").mkdir(parents=True)
    b.connection.file_transfer.receive_dir = str(tmp / side / "rx")
    link = Link(a, b)
    assert a.connect("VE3ABC")
    assert a.connection.is_connected and b.connection.is_connected
    src = tmp / side / "otaf.txt"
    content = b"HF file transfer exercises chunking + ARQ over audio. " * 12
    src.write_bytes(content)
    received = []
    b.connection.file_transfer.on_received = \
        lambda path, ok: received.append((path, ok))
    assert a.connection.send_file(str(src))
    for _ in range(30):
        if received:
            break
        link.tick(1000)
    assert received and received[0][1]
    data = open(received[0][0], "rb").read()
    assert data == content
    return link, (data, link.retransmissions())


def test_file_transfer_over_the_air(tmp_path):
    run_twin(s_file_transfer, tmp_path)


def s_mode_change(side):
    """A MODE_CHANGE over the air mid-session (the frame-level
    tests/test_protocol.py:397, here through the modems; the SNR-driven
    controller is off, so only the requested change happens): the
    announcement leaves at the old mode, both ends switch, and messages
    flow both ways at the new one."""
    C = PKG[side][1]
    a = station(side, "W1AW")
    b = station(side, "VE3ABC", measured_snr=15.0)
    for e in (a, b):
        e.adaptive_enabled = False
    link = Link(a, b)
    assert a.connect("VE3ABC")
    assert a.send_message("before")
    before = (int(a.modem.data_modulation), int(a.modem.data_code_rate))
    assert a.connection.request_mode_change(C.Modulation.QAM16,
                                            C.CodeRate.R2_3)
    for e in (a, b):
        assert e.modem.data_modulation == C.Modulation.QAM16
        assert e.modem.data_code_rate == C.CodeRate.R2_3
    assert a.send_message("after the change")
    assert b.send_message("and back")
    assert link.got_b == ["before", "after the change"]
    assert link.got_a == ["and back"]
    return link, before


def test_mode_change_over_the_air():
    link, before = run_twin(s_mode_change)
    assert before != (int(TC.Modulation.QAM16), int(TC.CodeRate.R2_3))

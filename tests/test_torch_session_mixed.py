"""Mixed sessions: a port station talks to a JAX station over the air.

One station is the port's ``ProtocolEngine(device=cpu)``, the other the
JAX package's; each hears the other's TX audio (with the clean link's
4,000 zeros after it).  In both directions the initiator connects (chirp
PING/PONG, MC-DPSK CONNECT), sends one message and the file of
tests/test_protocol.py:361-395: the message and the file's bytes arrive
exactly, so the two packages speak the same protocol on the air.
"""

import pytest

from test_torch_session import Link, station


@pytest.mark.parametrize("initiator,responder", [("port", "jax"),
                                                 ("jax", "port")])
def test_mixed_session(initiator, responder, tmp_path):
    a = station(initiator, "W1AW")
    b = station(responder, "VE3ABC", measured_snr=15.0)
    b.connection.file_transfer.receive_dir = str(tmp_path)
    link = Link(a, b)
    assert a.connect("VE3ABC")
    assert a.connection.is_connected and b.connection.is_connected
    assert b.connection.remote_call == "W1AW"
    assert a.connection.negotiated_mode == b.connection.negotiated_mode

    assert a.send_message(f"from {initiator} to {responder}")
    assert b.send_message(f"from {responder} to {initiator}")
    assert link.got_b == [f"from {initiator} to {responder}"]
    assert link.got_a == [f"from {responder} to {initiator}"]

    src = tmp_path / "otaf.txt"
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
    assert open(received[0][0], "rb").read() == content
    assert a.connection.is_connected and b.connection.is_connected
    assert link.retransmissions() == (0, 0)

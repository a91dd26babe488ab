"""A noisy leg: a two-station session over an AWGN channel, on both
packages.

JAX's PRNG cannot be reproduced in torch, so the channel is numpy: 2,000
zeros before and 4,000 after each transmission, then white Gaussian noise
at 8 dB below the active-sample power (the harness AWGN of
``sim/watterson.add_noise_active``), drawn from a numpy generator seeded
with (7, the link's transmission count).  Each package's stations hear
their own peer's TX audio through it, so the two sessions see the same
noise on audio within 2e-4.  After connecting, each station sends its
messages while both tick 5 s at a time; frames are lost, and the ARQ's
timeouts retransmit them.  The sessions are held to each other turn by
turn (``test_torch_session.run_twin``): the same transmissions, states,
deliveries and retransmission counts.  With three messages each way
every message arrives; with four, one of the initiator's frames exhausts
its three retries and both packages drop the session at the same turn.
"""

import numpy as np

from test_torch_session import Link, run_twin, station

SNR_DB = 8.0
SEED = 7


def awgn(audio: np.ndarray, n: int) -> np.ndarray:
    x = np.concatenate([np.zeros(2000, np.float32), audio,
                        np.zeros(4000, np.float32)])
    active = np.abs(x) > 1e-6
    power = float((x[active].astype(np.float64) ** 2).mean())
    std = np.float32(np.sqrt(power / 10.0 ** (SNR_DB / 10.0)))
    noise = np.random.default_rng([SEED, n]).standard_normal(
        len(x), dtype=np.float32)
    return x + std * noise


def s_noisy(side, messages):
    a = station(side, "W1AW")
    b = station(side, "VE3ABC", measured_snr=SNR_DB)
    link = Link(a, b, awgn)
    assert a.connect("VE3ABC")
    assert a.connection.is_connected and b.connection.is_connected
    ia = ib = 0
    for _ in range(200):
        if ia < messages and a.send_message(f"noisy-a-{ia}"):
            ia += 1
        if ib < messages and b.send_message(f"noisy-b-{ib}"):
            ib += 1
        link.tick(5000)
        if min(ia, ib, len(link.got_a), len(link.got_b)) >= messages \
                or not (a.connection.is_connected
                        or b.connection.is_connected):
            break
    return link, (link.retransmissions(), a.connection.arq.stats.failed,
                  a.connection.is_connected, b.connection.is_connected)


def test_noisy_session_delivers():
    link, (retx, failed, up_a, up_b) = run_twin(s_noisy, 3)
    assert link.got_b == [f"noisy-a-{i}" for i in range(3)]
    assert link.got_a == [f"noisy-b-{i}" for i in range(3)]
    assert sum(retx) > 0          # the channel really lost frames
    assert failed == 0 and up_a and up_b


def test_noisy_session_exhausts_retries():
    link, (retx, failed, up_a, up_b) = run_twin(s_noisy, 4)
    assert failed == 1 and not up_a and not up_b
    assert sum(retx) > 0
    assert link.got_a == [f"noisy-b-{i}" for i in range(4)]
    assert link.got_b == [f"noisy-a-{i}" for i in range(3)]

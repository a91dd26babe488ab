"""``correct`` comes out false for the control and for each fault the
cells can have, with the rest of a run driven as the benchmark drives it
(the look for a card skipped: the CPU, at a test's batch).

The control: the program's own bfloat16 paths (LDPC messages; the chirp
refine) with its TX and channel outputs kept in bfloat16.  The faults,
planted in the program underneath the harness: half of the batch left out
(the other half's answers copied over it), an answer altered where it is
produced (one info bit, one detection), and a channel step that returns
its input unchanged.  One chip, so no exchange between chips to leave out.
"""

import pytest
import torch

from projectultra_tpu_torch.ofdm import pipeline as P
from projectultra_tpu_torch.psk import mc_dpsk as MC
from projectultra_tpu_torch.sim import watterson as W

from bench_cases import ACQUIRED, PRESYNCED, run_tiny, tiny_cell

CELLS = PRESYNCED + ACQUIRED


def receiver(name):
    return (P, "rx_frame") if name in PRESYNCED else (MC, "decode_chirp_batch")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    assert run_tiny(tiny_cell(name), seconds=0.05)["correct"] is True


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    line = run_tiny(tiny_cell(name), seconds=0.05, control=True)
    assert line["correct"] is False
    failed = [k for k, c in line["checks"].items() if c["value"] > c["limit"]]
    assert failed


@pytest.mark.parametrize("name", CELLS)
def test_half_of_the_batch_left_out(name, monkeypatch):
    module, attr = receiver(name)
    real = getattr(module, attr)

    def half(*args):
        *head, samples = args
        b = samples.shape[0] // 2
        out = real(*head, samples[:b])

        def twice(x):
            return torch.cat([x, x]) if isinstance(x, torch.Tensor) else \
                {k: twice(v) for k, v in x.items()}
        return tuple(twice(x) for x in out)

    monkeypatch.setattr(module, attr, half)
    assert run_tiny(tiny_cell(name), seconds=0.05)["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered_where_it_is_produced(name, monkeypatch):
    module, attr = receiver(name)
    real = getattr(module, attr)

    def altered(*args):
        out = real(*args)
        bits = out[0].clone()
        bits[0, 0] ^= 1
        return (bits, *out[1:])

    monkeypatch.setattr(module, attr, altered)
    line = run_tiny(tiny_cell(name), seconds=0.05)
    assert line["correct"] is False
    assert line["checks"]["bits_differ"]["value"] > 0


@pytest.mark.parametrize("name", ACQUIRED)
def test_a_detection_altered_where_it_is_produced(name, monkeypatch):
    real = MC.decode_chirp_batch

    def altered(*args):
        bits, ok, iters, det = real(*args)
        det = dict(det)
        det["down_chirp_start"] = det["down_chirp_start"].clone()
        det["down_chirp_start"][0] += 1
        return bits, ok, iters, det

    monkeypatch.setattr(MC, "decode_chirp_batch", altered)
    line = run_tiny(tiny_cell(name), seconds=0.05)
    assert line["correct"] is False
    assert line["checks"]["lanes_differ"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_a_channel_that_returns_its_input(name, monkeypatch):
    monkeypatch.setattr(W, "add_noise_with", lambda s, snr, noise: s)
    line = run_tiny(tiny_cell(name), seconds=0.05)
    assert line["correct"] is False
    assert line["checks"]["rx_err"]["value"] > line["checks"]["rx_err"][
        "limit"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card_at_the_cells_size(name, card):
    """The control at the cell's own batch on the card: not correct; the
    program as configured: correct (``benchmark/calibrate.py`` reads the
    numbers over many seeds)."""
    import dataclasses
    import time
    from benchmark import harness
    cell = harness.load_cell(name)
    cell.traffic = dataclasses.replace(cell.traffic, compare_span=10)
    for control, expect in ((False, True), (True, False)):
        line = harness.run(cell, 2**31 + 99, 1.5, False, card,
                           time.perf_counter(), lambda _m: None,
                           control=control)
        assert line["correct"] is expect

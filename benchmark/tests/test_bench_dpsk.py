"""The DPSK ``medium`` cell run tiny on the CPU as the benchmark runs it:
``correct`` is true for the program as configured and false for the
control and for each fault planted in the program underneath the harness
(half of the batch left out, a detection or an answer altered where it is
produced, the LLRs scaled or off by a hair where they are made, a channel
that returns its input).  Its traced run reads the cell's span metric; the
two new readers are checked by hand."""

import types

import pytest
import torch

from projectultra_tpu_torch.psk import dpsk as DP
from projectultra_tpu_torch.sim import watterson as W

from bench_cases import run_tiny, tiny_cell

CELL = "dpsk_medium-acquire-0db-b256"


def test_sound_run_is_correct():
    line = run_tiny(tiny_cell(CELL), seconds=0.05)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"acquired_frames_per_s",
                                    "acquired_batch_ms_p95", "setup_s"}


def test_control_is_not_correct():
    """The control breaks limits of the receiver too, not only the TX's
    and the channel's: it stores the detection's estimates and the LLRs in
    bfloat16 where the receiver makes them."""
    line = run_tiny(tiny_cell(CELL), seconds=0.05, control=True)
    assert line["correct"] is False
    broken = {k for k, c in line["checks"].items() if c["value"] > c["limit"]}
    assert {"tx_err", "rx_err"} <= broken
    assert {"corr_err", "cfo_err", "phase_err"} <= broken
    assert broken & {"llr_err", "llr_lanes"}


def test_half_of_the_batch_left_out(monkeypatch):
    real = DP.decode_dpsk_batch

    def half(cfg, rate, samples, **kw):
        out = real(cfg, rate, samples[:samples.shape[0] // 2], **kw)

        def twice(x):
            return torch.cat([x, x]) if isinstance(x, torch.Tensor) else \
                {k: twice(v) for k, v in x.items()}
        return tuple(twice(x) for x in out)

    monkeypatch.setattr(DP, "decode_dpsk_batch", half)
    assert run_tiny(tiny_cell(CELL), seconds=0.05)["correct"] is False


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    real = DP.decode_dpsk_batch

    def altered(*args, **kw):
        bits, *rest = real(*args, **kw)
        bits = bits.clone()
        bits[0, 0] ^= 1
        return (bits, *rest)

    monkeypatch.setattr(DP, "decode_dpsk_batch", altered)
    line = run_tiny(tiny_cell(CELL), seconds=0.05)
    assert line["correct"] is False
    assert line["checks"]["bits_differ"]["value"] > 0


@pytest.mark.parametrize("index", [0, 1])
def test_a_detection_altered_where_it_is_produced(monkeypatch, index):
    """found flipped, or the data start moved by 8 samples, on one lane."""
    real = DP.find_preamble

    def altered(*args, **kwargs):
        out = list(real(*args, **kwargs))
        out[index] = out[index].clone()
        if index == 0:
            out[0][0] = ~out[0][0]
        else:
            out[1][0] += 8
        return tuple(out)

    monkeypatch.setattr(DP, "find_preamble", altered)
    line = run_tiny(tiny_cell(CELL), seconds=0.05)
    assert line["correct"] is False
    assert line["checks"]["lanes_differ"]["value"] > 0


@pytest.mark.parametrize("scale", [1.05, 0.95])
def test_llrs_scaled_where_they_are_made(monkeypatch, scale):
    """Soft decisions a few percent off (a wrong confidence scale would do
    that): the decode is the same, the LLRs are not."""
    real = DP.demodulate_soft
    monkeypatch.setattr(DP, "demodulate_soft",
                        lambda *a, **k: real(*a, **k) * scale)
    line = run_tiny(tiny_cell(CELL), seconds=0.05)
    assert line["correct"] is False
    assert line["checks"]["llr_lanes"]["value"] == 1.0
    assert line["checks"]["bits_differ"]["value"] == 0


def test_llrs_a_hair_off_where_they_are_made(monkeypatch):
    """LLRs off by less than a lane's tolerance everywhere: no lane apart,
    and llr_err over its limit."""
    real = DP.demodulate_soft
    monkeypatch.setattr(DP, "demodulate_soft",
                        lambda *a, **k: real(*a, **k) * (1 + 1e-3))
    line = run_tiny(tiny_cell(CELL), seconds=0.05)
    assert line["correct"] is False
    assert line["checks"]["llr_lanes"]["value"] == 0
    assert line["checks"]["llr_err"]["value"] > line["checks"]["llr_err"][
        "limit"]


def test_a_channel_that_returns_its_input(monkeypatch):
    monkeypatch.setattr(W, "add_noise_with", lambda s, snr, noise: s)
    line = run_tiny(tiny_cell(CELL), seconds=0.05)
    assert line["correct"] is False
    assert line["checks"]["rx_err"]["value"] > line["checks"]["rx_err"][
        "limit"]


def test_traced_run_reads_the_cells_span_metric():
    line = run_tiny(tiny_cell(CELL), seconds=0.3, trace=True)
    assert line["correct"] is True
    # No device on the CPU: no score kernel for the roofline to read.
    assert set(line["metrics"]) == {"rx_ms.dpsk"}


def _reader(name):
    from benchmark import harness
    return harness.reader(harness.ROOT / "benchmark" / "metrics"
                          / f"{name}.py")


def test_rx_ms_reader_by_hand():
    read = _reader("rx_ms.dpsk")
    assert read(types.SimpleNamespace(path="acquired",
                                      span_ms={"tx": [1.0], "rx": [14.0,
                                                                   16.0]})) \
        == pytest.approx(15.0)
    assert read(types.SimpleNamespace(path="acquired", span_ms={})) is None
    assert read(types.SimpleNamespace(path="presynced",
                                      span_ms={"rx": [1.0]})) is None


def test_score_roofline_reader_by_hand():
    from benchmark import yardstick as Y
    # The cell's search: O = min(156 x 768, 287,584 - 39 x 768) = 119,808
    # offsets of L = 768; two launches at B = 256 took 0.4 ms each.
    bound_ms = Y.dpsk_bound(256, 768, 119_808)[0]
    assert bound_ms == pytest.approx(0.1277, rel=1e-3)
    events = [("dpsk_score_kernel(Params)", 0, 400_000),
              ("void vector_fft<...>", 0, 5_000_000),
              ("dpsk_score_kernel(Params)", 10**6, 10**6 + 400_000)]
    trace = types.SimpleNamespace(path="acquired", device_events=events,
                                  code={"lanes": 256})
    read = _reader("dpsk_score_roofline.dpsk")
    assert read(trace) == pytest.approx(100.0 * bound_ms / 0.4)
    assert read(types.SimpleNamespace(**{**vars(trace),
                                         "device_events": events[1:2]})) \
        is None

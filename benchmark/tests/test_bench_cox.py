"""The OFDM_COX cell run tiny on the CPU as the benchmark runs it:
``correct`` is true for the program as configured and false for the
control and for each fault planted in the program underneath the harness
(half of the batch left out, one info bit or one detection altered where
it is produced, the scan's LLRs scaled where they are made, a channel step
that returns its input).  Its traced run
reads the cell's per-layer metrics that a CPU run can read."""

import pytest
import torch

from projectultra_tpu_torch.sim import watterson as W
from projectultra_tpu_torch.sync import schmidl_cox as SC

from bench_cases import run_tiny, tiny_cell

CELL = "ofdm_cox-acquire-17db-b2048"


def test_sound_run_is_correct():
    line = run_tiny(tiny_cell(CELL), seconds=0.05)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"acquired_frames_per_s",
                                    "acquired_batch_ms_p95", "setup_s"}


def test_control_is_not_correct():
    line = run_tiny(tiny_cell(CELL), seconds=0.05, control=True)
    assert line["correct"] is False
    assert [k for k, c in line["checks"].items() if c["value"] > c["limit"]]


def test_half_of_the_batch_left_out(monkeypatch):
    real = SC.decode_cox_batch

    def half(config, mod, rate, samples, **kw):
        out = real(config, mod, rate, samples[:samples.shape[0] // 2], **kw)

        def twice(x):
            return torch.cat([x, x]) if isinstance(x, torch.Tensor) else \
                {k: twice(v) for k, v in x.items()}
        return tuple(twice(x) for x in out)

    monkeypatch.setattr(SC, "decode_cox_batch", half)
    assert run_tiny(tiny_cell(CELL), seconds=0.05)["correct"] is False


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    real = SC.decode_cox_batch

    def altered(*args, **kw):
        bits, *rest = real(*args, **kw)
        bits = bits.clone()
        bits[0, 0] ^= 1
        return (bits, *rest)

    monkeypatch.setattr(SC, "decode_cox_batch", altered)
    line = run_tiny(tiny_cell(CELL), seconds=0.05)
    assert line["correct"] is False
    assert line["checks"]["bits_differ"]["value"] > 0


@pytest.mark.parametrize("key", ["lts_start", "sync_off"])
def test_a_detection_altered_where_it_is_produced(monkeypatch, key):
    real = SC.detect_preamble

    def altered(*args, **kwargs):
        det = dict(real(*args, **kwargs))
        det[key] = det[key].clone()
        det[key][0] += 8
        return det

    monkeypatch.setattr(SC, "detect_preamble", altered)
    line = run_tiny(tiny_cell(CELL), seconds=0.05)
    assert line["correct"] is False
    assert line["checks"]["lanes_differ"]["value"] > 0


@pytest.mark.parametrize("scale", [1.05, 0.95])
def test_llrs_scaled_where_they_are_made(monkeypatch, scale):
    """A tracking step whose LLRs are a few percent off (a wrong noise
    variance would do that): the decode is the same, the LLRs are not."""
    real = SC.demodulate_detected
    monkeypatch.setattr(SC, "demodulate_detected",
                        lambda *a, **k: real(*a, **k) * scale)
    line = run_tiny(tiny_cell(CELL), seconds=0.05)
    assert line["correct"] is False
    assert line["checks"]["llr_lanes"]["value"] == 1.0
    assert line["checks"]["bits_differ"]["value"] == 0


def test_llrs_a_hair_off_where_they_are_made(monkeypatch):
    """LLRs off by less than a lane's tolerance everywhere: no lane apart,
    and llr_err over its limit."""
    real = SC.demodulate_detected
    monkeypatch.setattr(SC, "demodulate_detected",
                        lambda *a, **k: real(*a, **k) * (1 + 4e-4))
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


def test_traced_run_reads_the_cells_span_metrics():
    line = run_tiny(tiny_cell(CELL), seconds=0.3, trace=True)
    assert line["correct"] is True
    assert "rx_ms.acquired" in set(line["metrics"])
    # No device on the CPU: nothing for the device's operations and shares.
    assert not {"device_ops.acquired", "device_idle.cox",
                "sc_windows_roofline.cox"} & set(line["metrics"])


def _reader(name):
    from benchmark import harness
    return harness.reader(harness.ROOT / "benchmark" / "metrics"
                          / f"{name}.py")


def test_device_idle_reader_by_hand():
    import types
    # Steps before the profiler: 10 + 20 ms and 12 + 18 ms of harness
    # spans, 30 ms a step; 2 profiled steps busy 48 ms in all, 24 a step.
    trace = types.SimpleNamespace(
        path="acquired", profiled_steps=2, busy_ns=48_000_000,
        span_ms={"tx": [10.0, 12.0], "rx": [20.0, 18.0]})
    assert _reader("device_idle.cox")(trace) == pytest.approx(20.0)
    assert _reader("device_idle.cox")(
        types.SimpleNamespace(**{**vars(trace), "busy_ns": 0})) is None


def test_window_roofline_reader_by_hand():
    import types
    from benchmark import yardstick as Y
    # The cell's buffer: G = 2,288 grid points of half 256 at stride 8;
    # two launches at B = 2,048 took 0.2 ms each.
    bound_ms = Y.sc_bound(2048, 256, 8, 2288)[0]
    events = [("sc_windows_kernel(...)", 0, 200_000),
              ("other", 0, 5_000_000),
              ("sc_windows_kernel(...)", 10**6, 10**6 + 200_000)]
    trace = types.SimpleNamespace(path="acquired", device_events=events,
                                  code={"lanes": 2048})
    read = _reader("sc_windows_roofline.cox")
    assert read(trace) == pytest.approx(100.0 * bound_ms / 0.2)
    assert read(types.SimpleNamespace(**{**vars(trace),
                                         "device_events": events[1:2]})) \
        is None

"""The NVIS cell and the MC-DPSK cell at B = 4,096 run tiny on the CPU as
the benchmark runs them: the cells' files load; ``correct`` is true for
the program as configured and false for the control and for each fault
planted in the program underneath the harness (the refined path's LLRs
scaled where they are made, the detected CFO or the channel's offset off
by 1 Hz, one codeword's bits flipped, half of the batch left out, a
detection moved); a program without the refined path's graph counters
fails at the entry's construction.  The traced run reads the NVIS cell's
per-layer metrics that a CPU run can read, and the readers by hand."""

import json
import types

import pytest
import torch

from benchmark import harness
from projectultra_tpu_torch.ofdm import demodulator as D
from projectultra_tpu_torch.sim import watterson as W
from projectultra_tpu_torch.sync import schmidl_cox as SC

from bench_cases import CPU, run_tiny, tiny_cell

CELL = "nvis_qam32-acquire-30db-cfo10-b2048"
B4096 = "mcdpsk_l10-chirp-acquire-5db-b4096"


def test_the_cells_files_load():
    cell = harness.load_cell(CELL)
    assert cell.entry.PATH == "acquired" and cell.chips == 1
    assert cell.traffic.batch == 2048 and cell.traffic.snr_db == 30.0
    assert json.loads((harness.ROOT / "benchmark" / "traffic"
                       / "awgn-30db-cfo10-b2048.json").read_text())[
        "cfo_hz"] == 10.0
    assert cell.config["frame_samples"] == 33000
    assert cell.config["codewords"] == 8 and cell.config["reduced"] == []
    assert {m["name"] for m in cell.per_layer} == {
        "rx_ms.nvis", "device_idle.nvis", "sc_windows_roofline.nvis"}
    entry = cell.entry.Entry(cell.config, cell.traffic, CPU)
    assert (entry.T, entry.k, entry.cfo_hz) == (33000, 3888, 10.0)
    big = harness.load_cell(B4096)
    assert big.traffic.batch == 4096 and big.traffic.snr_db == 5.0
    assert big.entry is harness.load_cell(
        "mcdpsk_l10-chirp-acquire-5db-b2048").entry
    assert {m["name"] for m in big.per_layer} == {
        "rx_ms.acquired", "device_ops.acquired", "device_idle.acquired"}


def test_a_program_without_the_refined_counters_fails_at_once(monkeypatch):
    """The parent of this cell has no refined path graph: its entry fails
    before any step."""
    monkeypatch.delattr(D, "refined_replays")
    cell = harness.load_cell(CELL)
    with pytest.raises(AttributeError):
        cell.entry.Entry(cell.config, cell.traffic, CPU)


def test_sound_run_is_correct():
    line = run_tiny(tiny_cell(CELL), seconds=0.05)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"acquired_frames_per_s",
                                    "acquired_batch_ms_p95", "setup_s"}
    assert set(line["checks"]) == {"tx_err", "rx_err", "corr_err", "cfo_err",
                                   "llr_lanes", "llr_err", "lanes_differ",
                                   "bits_differ"}


def test_control_is_not_correct():
    line = run_tiny(tiny_cell(CELL), seconds=0.05, control=True)
    assert line["correct"] is False
    over = {k for k, c in line["checks"].items() if c["value"] > c["limit"]}
    assert {"tx_err", "rx_err", "corr_err", "cfo_err"} <= over


@pytest.mark.parametrize("scale", [1.05, 0.95])
def test_llrs_scaled_where_they_are_made(monkeypatch, scale):
    """A refined path whose LLRs are 5% off (a wrong noise variance would
    do that): the decode is the same, the LLRs are not."""
    real = D._demod_coherent_refined
    monkeypatch.setattr(D, "_demod_coherent_refined",
                        lambda *a, **k: real(*a, **k) * scale)
    line = run_tiny(tiny_cell(CELL), seconds=0.05)
    assert line["correct"] is False
    assert line["checks"]["llr_lanes"]["value"] == 1.0
    assert line["checks"]["bits_differ"]["value"] == 0


def test_detected_cfo_off_by_1_hz(monkeypatch):
    real = SC.detect_preamble

    def off(*args, **kwargs):
        det = dict(real(*args, **kwargs))
        det["cfo_hz"] = det["cfo_hz"] + 1.0
        return det

    monkeypatch.setattr(SC, "detect_preamble", off)
    line = run_tiny(tiny_cell(CELL), seconds=0.05)
    assert line["correct"] is False
    assert line["checks"]["cfo_err"]["value"] > 0.05


def test_channel_offset_off_by_1_hz(monkeypatch):
    real = W.apply_cfo_hilbert
    monkeypatch.setattr(W, "apply_cfo_hilbert",
                        lambda s, cfo, *a: real(s, cfo + 1.0, *a))
    line = run_tiny(tiny_cell(CELL), seconds=0.05)
    assert line["correct"] is False
    assert line["checks"]["rx_err"]["value"] > line["checks"]["rx_err"][
        "limit"]


def test_one_codewords_bits_flipped(monkeypatch):
    real = SC.decode_cox_batch

    def flipped(*args, **kw):
        bits, *rest = real(*args, **kw)
        bits = bits.clone()
        bits[1, 486:972] ^= 1
        return (bits, *rest)

    monkeypatch.setattr(SC, "decode_cox_batch", flipped)
    line = run_tiny(tiny_cell(CELL), seconds=0.05)
    assert line["correct"] is False
    assert line["checks"]["bits_differ"]["value"] > 0


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


def test_a_detection_moved_where_it_is_produced(monkeypatch):
    real = SC.detect_preamble

    def moved(*args, **kwargs):
        det = dict(real(*args, **kwargs))
        det["lts_start"] = det["lts_start"].clone()
        det["lts_start"][0] += 8
        return det

    monkeypatch.setattr(SC, "detect_preamble", moved)
    line = run_tiny(tiny_cell(CELL), seconds=0.05)
    assert line["correct"] is False
    assert line["checks"]["lanes_differ"]["value"] > 0


def test_traced_run_reads_the_cells_span_metric():
    line = run_tiny(tiny_cell(CELL), seconds=0.3, trace=True)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"rx_ms.nvis"}
    assert line["metrics"]["rx_ms.nvis"]["value"] > 0


def _reader(name):
    return harness.reader(harness.ROOT / "benchmark" / "metrics"
                          / f"{name}.py")


def test_device_idle_reader_by_hand():
    # Steps before the profiler: 10 + 20 ms and 12 + 18 ms of harness
    # spans, 30 ms a step; 2 profiled steps busy 48 ms in all, 24 a step.
    trace = types.SimpleNamespace(
        path="acquired", profiled_steps=2, busy_ns=48_000_000,
        span_ms={"tx": [10.0, 12.0], "rx": [20.0, 18.0]})
    assert _reader("device_idle.nvis")(trace) == pytest.approx(20.0)
    assert _reader("device_idle.nvis")(
        types.SimpleNamespace(**{**vars(trace), "busy_ns": 0})) is None


def test_window_roofline_reader_by_hand():
    from benchmark import yardstick as Y
    from projectultra_tpu_torch.config import nvis_mode
    # The cell's buffer: G = 3,986 grid points of half 512 at stride 8;
    # two launches at B = 2,048 took 0.3 ms each.
    assert SC.search_grid_size(nvis_mode(), 33000) == 3986
    bound_ms = Y.sc_bound(2048, 512, 8, 3986)[0]
    events = [("sc_windows_kernel(...)", 0, 300_000),
              ("other", 0, 5_000_000),
              ("sc_windows_kernel(...)", 10**6, 10**6 + 300_000)]
    trace = types.SimpleNamespace(path="acquired", device_events=events,
                                  code={"lanes": 2048})
    read = _reader("sc_windows_roofline.nvis")
    assert read(trace) == pytest.approx(100.0 * bound_ms / 0.3)
    assert read(types.SimpleNamespace(**{**vars(trace),
                                         "device_events": events[1:2]})) \
        is None


def test_rx_reader_by_hand():
    trace = types.SimpleNamespace(path="acquired",
                                  span_ms={"rx": [4.0, 6.0], "tx": [1.0]})
    assert _reader("rx_ms.nvis")(trace) == pytest.approx(5.0)
    assert _reader("rx_ms.nvis")(
        types.SimpleNamespace(path="acquired", span_ms={})) is None

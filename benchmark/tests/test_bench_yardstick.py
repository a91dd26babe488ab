"""The benchmark's arithmetic against cases worked by hand."""

import statistics

import pytest
import torch

from benchmark import yardstick as Y


def test_bound_picks_the_larger_time():
    # 3.35 GB at 3.35 TB/s is 1 ms; 67 GFLOP at 67 TFLOP/s is 1 ms.
    assert Y.bound(3.35e9, 0.0) == (pytest.approx(1.0), "bytes")
    assert Y.bound(0.0, 67e9) == (pytest.approx(1.0), "operations")
    assert Y.bound(3.35e9, 2 * 67e9)[1] == "operations"


def test_ldpc_bound_by_hand():
    # 16,384 lanes of 648 LLRs: read 4 B and write 4 B each, ok 1 B and
    # iters 4 B a lane: 16384 * (648 * 8 + 5) = 85,016,576 B -> 0.025378 ms.
    ms, basis = Y.ldpc_bound(16384, 648, 1296, 16384)
    assert basis == "bytes"
    assert ms == pytest.approx(16384 * (648 * 8 + 5) / 3.35e12 * 1e3)
    # 50 passes a lane: 14 ops an edge -> 16384*50*1296*14/67e12 s.
    ms, basis = Y.ldpc_bound(16384, 648, 1296, 16384 * 50)
    assert basis == "operations"
    assert ms == pytest.approx(16384 * 50 * 1296 * 14 / 67e12 * 1e3)


def test_passes_of_a_lane():
    # Converged at the 0-based iterations 0, 9 and 49; never (reads 50).
    iters = torch.tensor([0, 9, 49, 50], dtype=torch.int32)
    assert Y.ldpc_passes(iters).tolist() == [1, 10, 50, 50]
    assert Y.ldpc_passes(torch.tensor([3]), max_iters=3).tolist() == [3]


def test_roofline_reader_by_hand():
    # Two profiled batches of 2 lanes, R1/2 (n 648, 1,296 edges... any):
    # passes 1 + 1 and 50 + 3; the kernel took 1 ms in all.
    import types
    from benchmark import harness
    read = harness.reader(harness.HERE / "metrics"
                          / "ldpc_roofline.presynced.py")
    code = {"lanes": 2, "n": 648, "edges": 2376}
    outs = [{"iters": torch.tensor([0, 0])}, {"iters": torch.tensor([50, 2])}]
    trace = types.SimpleNamespace(
        path="presynced", code=code, outputs=outs,
        device_events=[("ldpc_minsum_kernel<f>", 0, 400_000),
                       ("add", 400_000, 900_000),
                       ("ldpc_minsum_kernel<f>", 900_000, 1_500_000)])
    want = Y.ldpc_bound(2, 648, 2376, 2)[0] + Y.ldpc_bound(2, 648, 2376, 53)[0]
    assert read(trace) == pytest.approx(100.0 * want / 1.0)
    trace.device_events = trace.device_events[1:2]
    assert read(trace) is None


def test_sc_and_dpsk_bounds_by_hand():
    # One lane, half 8, stride 8, G 2: span 8 + 16 = 24 samples.
    ms, _ = Y.sc_bound(1, 8, 8, 2)
    n_bytes = 24 * 8 + 2 * 16
    n_ops = 24 * 12 + 2 * 4 * 1
    assert ms == pytest.approx(max(n_bytes / 3.35e12, n_ops / 67e12) * 1e3)
    ms, _ = Y.dpsk_bound(1, 1, 10)
    span = 10 + 38
    assert ms == pytest.approx(max((span * 8 + 40) / 3.35e12,
                                   (span * 23 + 10 * 120) / 67e12) * 1e3)


def test_union_and_gaps_by_hand():
    iv = [(10, 20), (15, 30), (40, 50), (45, 47), (60, 70)]
    assert Y.merged(iv) == [(10, 30), (40, 50), (60, 70)]
    assert Y.busy_ns(iv, 0, 100) == 40
    assert Y.busy_ns(iv, 25, 65) == 5 + 10 + 5
    assert Y.idle_gaps(iv, 0, 100) == [(0, 10), (30, 40), (50, 60),
                                       (70, 100)]
    assert Y.idle_gaps(iv, 12, 48) == [(30, 40)]
    assert Y.busy_ns([], 0, 10) == 0
    assert Y.idle_gaps([], 0, 10) == [(0, 10)]


def test_idle_share_of_a_trace():
    # Device busy 40 of a 100 ns window: 60% idle.
    busy = Y.busy_ns([(10, 30), (40, 50), (60, 70)], 0, 100)
    assert 100.0 * (1 - busy / 100) == pytest.approx(60.0)


def test_kernel_time_by_name():
    events = [("void ldpc_minsum_kernel<256, false>(...)", 0, 5),
              ("elementwise", 5, 9), ("ldpc_minsum_kernel<1024, true>", 9, 12)]
    assert Y.kernel_ns(events, "ldpc_minsum") == 8
    assert Y.kernel_ns(events, "sc_windows") == 0


@pytest.mark.parametrize("values", [[5.0], [1.0, 2.0], list(range(1, 101)),
                                    [3.0, 1.0, 2.0, 10.0, 4.0]])
def test_percentile(values):
    if len(values) == 1:
        assert Y.percentile(values, 95) == values[0]
    else:
        q = statistics.quantiles(values, n=100, method="inclusive")[94]
        assert Y.percentile(values, 95) == q
    assert min(values) <= Y.percentile(values, 95) <= max(values)

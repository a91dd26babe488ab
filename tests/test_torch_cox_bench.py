"""The OFDM_COX cell of the port's benchmark on the CPU: its plain
reference (``benchmark/reference/ofdm_cox.py``) against the port at the
tests' batch of 4 buffers, and the Cox receiver's program spans.

The reference copies the port's plain path, so on the CPU, where the port
runs that path too (the window sums by cumulative sums, the scan as its
eager loop), every output is equal: the TX audio, the noisy buffer, the
detection, the bits, ok flags and LDPC iterations.
"""

import pytest
import torch

from benchmark import traffic as BT
from benchmark.reference import channel as ref_channel
from benchmark.tests.bench_cases import CPU, tiny_cell
from projectultra_tpu_torch.ofdm import demodulator as TDM
from projectultra_tpu_torch.ofdm import pipeline as TP
from projectultra_tpu_torch.sync import schmidl_cox as TSC
from projectultra_tpu_torch.utils import metrics as TME

CELL = "ofdm_cox-acquire-17db-b2048"
#: The Cox step's program spans in the order they open, with the parent
#: of each.
SPAN_TREE = [("cox.tx", None), ("noise.awgn", None), ("cox.rx", None),
             ("cox.detect", "cox.rx"), ("cox.lts", "cox.detect"),
             ("ofdm.scan", "cox.rx"), ("ldpc.decode", "cox.rx")]


def _entry(seed, step=0):
    cell = tiny_cell(CELL)
    entry = cell.entry.Entry(cell.config, cell.traffic, CPU)
    info, noise = BT.inputs(cell.traffic, entry.k, entry.T, seed, step, CPU)
    return entry, info, noise


def _step(entry, info, noise, mark=lambda _name: None):
    with entry.precision():
        return entry.step(info, noise, mark)


@pytest.mark.parametrize("seed", [7, 2**31 + 17, 3_000_000_019])
def test_cox_reference_equals_the_port(seed):
    entry, info, noise = _entry(seed)
    out = _step(entry, info, noise)
    ref = entry.reference()
    tx = ref.tx(info)
    rx = ref_channel.add_noise_with(tx, entry.traffic.snr_db, noise)
    bits, ok, iters, det, llrs = ref.rx(rx)
    assert tx.shape == (4, entry.T) == (4, 18856)
    assert torch.equal(out["tx"], tx) and torch.equal(out["rx"], rx)
    for key, value in det.items():
        assert torch.equal(out["det"][key], value), key
    assert llrs.shape == (4, 660) and torch.equal(out["llrs"], llrs)
    assert torch.equal(out["bits"], bits) and torch.equal(out["ok"], ok)
    assert torch.equal(out["iters"], iters)
    assert bool(ok.all()) and bool(det["found"].all())


def test_cox_cell_compares_nothing_but_equal_numbers_on_the_cpu():
    entry, info, noise = _entry(11, 1)
    out = _step(entry, info, noise)
    numbers = entry.compare(entry.reference(), info, noise, out).numbers()
    assert list(numbers) == ["tx_err", "rx_err", "corr_err", "cfo_err",
                             "llr_lanes", "llr_err", "lanes_differ",
                             "bits_differ"]
    assert all(v == 0.0 for v in numbers.values())


def test_cox_span_tree_of_a_step():
    """One step drains exactly the Cox spans: names, parents, one batch
    id, each host interval inside its parent's; no CUDA event on the
    CPU."""
    entry, info, noise = _entry(5)
    with TME.tracing() as rec:
        batch = rec.next_batch()
        _step(entry, info, noise)
        spans = rec.drain()
    assert TME._recorder is None
    names = {s.id: s.name for s in spans}
    assert [(s.name, names.get(s.parent)) for s in spans] == SPAN_TREE
    assert {s.batch for s in spans} == {batch}
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.start is None and s.device_ms() is None
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.host_start_ns <= s.host_start_ns <= s.host_end_ns \
                <= p.host_end_ns


def test_cox_spans_record_nothing_outside_tracing(monkeypatch):
    def boom(*_a, **_k):
        raise AssertionError("made while tracing is off")
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    entry, info, noise = _entry(5)
    off = _step(entry, info, noise)
    assert TME._recorder is None
    with TME.tracing():
        monkeypatch.undo()
        on = _step(entry, info, noise)
    for key in ("tx", "rx", "bits", "ok", "iters"):
        assert torch.equal(off[key], on[key]), key


def _graph_counts():
    return (TDM.scan_captures, TDM.scan_replays, len(TDM._scan_graphs),
            len(TDM._scan_graphs.seen), TP.tx_captures, TP.tx_replays,
            len(TP._tx_graphs), len(TP._tx_graphs.seen))


def test_cpu_scan_is_the_eager_loop():
    """On the CPU neither the scan nor the TX captures or replays a graph,
    or counts a shape as seen."""
    counts = _graph_counts()
    entry, info, noise = _entry(9)
    for _ in range(3):
        _step(entry, info, noise)
    assert _graph_counts() == counts


def test_receiver_hands_out_the_llrs_it_decodes():
    """``decode_cox_batch(..., with_llrs=True)``: the same four outputs as
    without, and the LLRs ``demodulate_detected`` gives on its
    detection."""
    entry, info, noise = _entry(13)
    rx = _step(entry, info, noise)["rx"]
    args = (entry.cfg, entry.mod, entry.rate, rx)
    with entry.precision():
        *out, llrs = TSC.decode_cox_batch(*args, with_llrs=True)
        plain = TSC.decode_cox_batch(*args)
    for a, b in zip(out[:3], plain[:3]):
        assert torch.equal(a, b)
    assert torch.equal(llrs, TSC.demodulate_detected(entry.cfg, entry.mod,
                                                     rx, plain[3]))


def test_graph_cache_captures_a_key_at_its_second_call():
    """``ops/cuda_graphs.Cache``: nothing at a key's first call, a capture
    at its second, the kept capture after; the least recently used
    capture and the oldest key seen once are dropped first."""
    from projectultra_tpu_torch.ops import cuda_graphs
    cache = cuda_graphs.Cache(graphs=2, seen=3)
    made = []

    def capture(key):
        return lambda: made.append(key) or f"graph {key}"

    assert cache.get("a", capture("a")) is None
    assert cache.get("a", capture("a")) == "graph a"
    assert cache.get("a", capture("a")) == "graph a"
    assert made == ["a"]
    for key in "bc":
        cache.get(key, capture(key))
        cache.get(key, capture(key))
    assert list(cache) == ["b", "c"] and len(cache) == 2
    assert list(cache.seen) == ["a", "b", "c"]
    cache.get("d", capture("d"))
    assert list(cache.seen) == ["b", "c", "d"]
    assert cache.get("a", capture("a")) is None
    cache.get("b", capture("b"))
    cache.get("c", capture("c"))
    assert list(cache) == ["b", "c"] and made == ["a", "b", "c"]
    cache.clear()
    assert len(cache) == 0 and not cache.seen


def test_pilot_track_tables_follow_the_carrier_map():
    """The tracking kernel's tables (built on the CPU here): the plan's
    data and pilot bins, the pilots' +-1, and the interpolation's bins."""
    import numpy as np
    from projectultra_tpu_torch.config import ModemConfig
    from projectultra_tpu_torch.ofdm import carriers as TCM
    from projectultra_tpu_torch.ops import cuda_track
    cfg = ModemConfig()
    t = cuda_track._tables(cfg, CPU)
    cm = TCM.carrier_map(cfg)
    assert t[0].dtype == t[1].dtype == torch.int32
    assert t[0].tolist() == cm.data_idx.tolist()
    assert t[1].tolist() == cm.pilot_idx.tolist()
    assert t[2].tolist() == np.real(cm.pilot_seq).tolist()
    assert set(t[2].tolist()) <= {-1.0, 1.0}
    assert sorted(t[6].tolist()) == sorted(cm.data_idx.tolist())
    assert set(t[7].tolist()) | set(t[8].tolist()) <= set(cm.pilot_idx.tolist())


def test_pilot_track_rejects_a_wrong_symbol():
    from projectultra_tpu_torch.config import ModemConfig
    from projectultra_tpu_torch.ops import cuda_track
    with pytest.raises(ValueError):
        cuda_track.track_dqpsk_cuda(ModemConfig(), None,
                                    torch.zeros((2, 29), dtype=torch.complex64))

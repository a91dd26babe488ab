"""The NVIS cell of the port's benchmark on the CPU: its plain reference
(``benchmark/reference/nvis.py``) against the port at the tests' batch of
4 buffers, 8 codewords a frame at a 10 Hz offset, and the refined path's
graph cache, counters and span.

The reference copies the port's plain path, so on the CPU, where the port
runs that path too (the window sums by cumulative sums, the LTS timing by
the FFT matched filter, the refined path as its eager loops), every output
is equal: the TX audio, the offset and noisy buffers, the detection and
its CFO, the refined path's LLRs, the bits, ok flags and every codeword's
LDPC iterations.
"""

import pytest
import torch

from benchmark import traffic as BT
from benchmark.reference import channel as ref_channel
from benchmark.reference import nvis as ref_nvis
from benchmark.tests.bench_cases import CPU, tiny_cell
from projectultra_tpu_torch.config import Modulation, nvis_mode
from projectultra_tpu_torch.ofdm import demodulator as TDM
from projectultra_tpu_torch.ofdm import pipeline as TP
from projectultra_tpu_torch.sim import watterson as TW
from projectultra_tpu_torch.sync import schmidl_cox as TSC
from projectultra_tpu_torch.utils import metrics as TME

CELL = "nvis_qam32-acquire-30db-cfo10-b2048"
#: The NVIS step's program spans in the order they open, with the parent
#: of each (the harness CFO has no span).
SPAN_TREE = [("cox.tx", None), ("noise.awgn", None), ("cox.rx", None),
             ("cox.detect", "cox.rx"), ("cox.lts", "cox.detect"),
             ("ofdm.refined", "cox.rx"), ("ldpc.decode", "cox.rx")]


def _entry(seed, step=0):
    cell = tiny_cell(CELL)
    entry = cell.entry.Entry(cell.config, cell.traffic, CPU)
    info, noise = BT.inputs(cell.traffic, entry.k, entry.T, seed, step, CPU)
    return entry, info, noise


def _step(entry, info, noise, mark=lambda _name: None):
    with entry.precision():
        return entry.step(info, noise, mark)


def test_the_cell_is_the_nvis_plan():
    """The configuration's plan is ``nvis_mode()``'s but for the plan
    fields that no step reads; a frame is 8 codewords in 18 symbols."""
    entry, info, noise = _entry(3)
    ref = nvis_mode()
    for field in ("fft_size", "num_carriers", "cp_mode", "symbol_guard",
                  "use_pilots", "adaptive_eq_enabled", "modulation",
                  "sample_rate", "center_freq", "output_scale"):
        assert getattr(entry.cfg, field) == getattr(ref, field), field
    assert entry.mod == Modulation.QAM32 and entry.ncw == 8
    assert entry.cfo_hz == 10.0 and entry.traffic.snr_db == 30.0
    assert TP.num_data_symbols(entry.cfg, entry.mod, 8) == 18
    assert info.shape == (4, 3888) and noise.shape == (4, 33000)


@pytest.mark.parametrize("seed", [7, 2**31 + 17, 3_000_000_019])
def test_nvis_reference_equals_the_port(seed):
    entry, info, noise = _entry(seed)
    out = _step(entry, info, noise)
    ref = entry.reference()
    tx = ref.tx(info)
    shifted = ref_nvis.apply_cfo(tx, 10.0)
    rx = ref_channel.add_noise_with(shifted, entry.traffic.snr_db, noise)
    bits, ok, iters, det, llrs = ref.rx(rx)
    assert tx.shape == (4, entry.T) == (4, 33000)
    assert torch.equal(out["tx"], tx)
    assert torch.equal(TW.apply_cfo_hilbert(tx, 10.0), shifted)
    assert torch.equal(out["rx"], rx)
    for key, value in det.items():
        assert torch.equal(out["det"][key], value), key
    assert llrs.shape == (4, 18 * 59 * 5) and torch.equal(out["llrs"], llrs)
    assert torch.equal(out["bits"], bits) and torch.equal(out["ok"], ok)
    assert out["iters"].shape == (4, 8) and torch.equal(out["iters"], iters)
    assert bool(ok.all()) and bool(det["found"].all())
    assert torch.equal(bits, info.to(torch.uint8))
    # The 10 Hz offset is found (the coarse estimate, within 0.2 Hz).
    assert float((det["cfo_hz"] - 10.0).abs().max()) < 0.2


def test_nvis_cell_compares_nothing_but_equal_numbers_on_the_cpu():
    entry, info, noise = _entry(11, 1)
    out = _step(entry, info, noise)
    numbers = entry.compare(entry.reference(), info, noise, out).numbers()
    assert list(numbers) == ["tx_err", "rx_err", "corr_err", "cfo_err",
                             "llr_lanes", "llr_err", "lanes_differ",
                             "bits_differ"]
    assert all(v == 0.0 for v in numbers.values())


def test_reference_takes_the_preferred_plateau_point_only_at_a_tie():
    """The reference's detection with another receiver's sync offsets: its
    own offsets leave it as it was; a point one grid step away is taken
    (and the CFO read there) where the tie admits every point of the
    window, never where it admits none; a point outside the plateau
    window is never taken."""
    from benchmark.entries.nvis_acquire import SYNC_TIE
    entry, info, noise = _entry(5)
    rx = _step(entry, info, noise)["rx"]
    ref = entry.reference()
    own = ref.detect(rx)
    for key, value in ref.detect(rx, own["sync_off"], SYNC_TIE).items():
        assert torch.equal(value, own[key]), key
    step = own["sync_off"] + 8
    taken = ref.detect(rx, step, 1.0)
    assert torch.equal(taken["sync_off"], step)
    assert not torch.equal(taken["cfo_hz"], own["cfo_hz"])
    assert torch.equal(taken["lts_start"], own["lts_start"])
    assert torch.equal(ref.detect(rx, step, -1.0)["sync_off"],
                       own["sync_off"])
    far = ref.detect(rx, own["sync_off"] + 8 * 400, 1.0)
    assert torch.equal(far["sync_off"], own["sync_off"])


def test_a_sync_offset_off_its_plateau_differs():
    """The program's sync offsets moved 64 samples, past the plateau's
    flat top: those lanes differ from the reference."""
    entry, info, noise = _entry(13)
    out = _step(entry, info, noise)
    out["det"] = dict(out["det"])
    out["det"]["sync_off"] = out["det"]["sync_off"] + 64
    numbers = entry.compare(entry.reference(), info, noise, out).numbers()
    assert numbers["lanes_differ"] == 1.0


def test_packed_iterations_differ_where_one_codeword_does():
    from benchmark.entries.nvis_acquire import packed_iters
    iters = torch.tensor([[0, 1, 50, 3, 0, 0, 0, 49]] * 3, dtype=torch.int32)
    other = iters.clone()
    other[1, 7] = 48
    other[2, 0] = 50
    a, b = packed_iters(iters), packed_iters(other)
    assert a.shape == (3,) and a.dtype == torch.int64
    assert (a == b).tolist() == [True, False, False]


def _refined_counts():
    return (TDM.refined_captures, TDM.refined_replays,
            len(TDM._refined_graphs), len(TDM._refined_graphs.seen))


def test_cpu_refined_path_is_the_eager_loop():
    """On the CPU the refined path captures and replays nothing, counts no
    shape as seen, and gives the eager loops' LLRs."""
    counts = _refined_counts()
    entry, info, noise = _entry(9)
    for _ in range(3):
        out = _step(entry, info, noise)
    assert _refined_counts() == counts
    cfg, mod = entry.cfg, entry.mod
    plen = cfg.fft_size + cfg.cyclic_prefix
    S = TP.num_data_symbols(cfg, mod, 8)
    span = out["rx"][:, 4000:4000 + 2 * plen + S * cfg.symbol_duration]
    lts, data = TDM._span_segments(cfg, mod, span, 2, S, 0, 0, "analytic")
    state = TDM.init_state(cfg, 4, out["det"]["cfo_hz"], 0.0, CPU)
    state = TDM.estimate_channel_from_lts(cfg, state, lts, t0_base=plen,
                                          t0_stride=0)
    args = (cfg, mod, state, data, 2 * plen, "analytic", 648 * 8, False)
    assert torch.equal(TDM._demod_coherent_refined(*args),
                       TDM._refined_eager(*args))
    assert _refined_counts() == counts


def _key(B=4, S=18, t0=2240, front="analytic", n_bits=5184, taper=False,
         bins_w=None, mod=Modulation.QAM32, dtype=torch.complex64):
    data = torch.zeros((B, S, 1120), dtype=dtype)
    return TDM._refined_key(nvis_mode(), mod, data, t0, front, n_bits,
                            taper, bins_w)


def test_refined_key_fixes_the_operation_sequence(monkeypatch):
    """One key a shape and window choice: equal for the same call, apart
    for another batch, symbol count, mixer offset, carrier fill, window,
    front end, modulation, dtype, or with the caller's window rows;
    ``taper=None`` resolves as the path resolves it, and the QAM256 front
    switch, read at call time, moves a QAM256 key."""
    base = _key()
    assert _key() == base and hash(_key()) == hash(base)
    others = [_key(B=5), _key(S=17), _key(t0=0), _key(n_bits=None),
              _key(taper=True), _key(front="real"),
              _key(mod=Modulation.QAM64), _key(dtype=torch.complex128),
              _key(bins_w=(None, None))]
    assert len({base, *others}) == len(others) + 1
    assert _key(taper=None) == _key(taper=True)
    assert _key(front="real", taper=None) == _key(front="real", taper=False)
    q256 = _key(mod=Modulation.QAM256)
    monkeypatch.setattr(TDM, "QAM256_RX", "real")
    assert _key(mod=Modulation.QAM256) != q256
    assert _key() == base


def test_refined_cache_keeps_the_most_recent_graphs():
    """The refined path's cache: no capture at a key's first call, one at
    its second, the REFINED_GRAPHS most recently used kept, a dropped one
    captured again; apart from the scan's."""
    cache = TDM._refined_graphs
    assert cache is not TDM._scan_graphs
    assert (cache.size, cache.seen_size) == (TDM.REFINED_GRAPHS,
                                             TDM.REFINED_SEEN)
    saved = (dict(cache.graphs), dict(cache.seen))
    cache.clear()
    try:
        made = []
        keys = [_key(B=b) for b in range(1, TDM.REFINED_GRAPHS + 4)]
        for k in keys:
            assert cache.get(k, lambda k=k: made.append(k) or k) is None
            assert cache.get(k, lambda k=k: made.append(k) or k) == k
        assert made == keys
        assert list(cache) == keys[-TDM.REFINED_GRAPHS:]
        assert cache.get(keys[-1], lambda: made.append(None)) == keys[-1]
        # A dropped graph whose key is still among those seen is captured
        # again at its next call.
        assert cache.get(keys[0], lambda: made.append(keys[0]) or 0) == 0
        assert made == keys + keys[:1]
        assert len(cache) == TDM.REFINED_GRAPHS
    finally:
        cache.clear()
        cache.graphs.update(saved[0])
        cache.seen.update(saved[1])


def test_nvis_span_tree_of_a_step():
    """One step drains exactly the NVIS spans: names, parents, one batch
    id, each host interval inside its parent's."""
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


def test_presynced_refined_branch_opens_its_span():
    """``Demodulator.forward`` on a coherent no-pilot plan runs the
    refined path inside ``ofdm.demodulate``, under ``ofdm.refined``."""
    cfg = nvis_mode()
    g = torch.Generator().manual_seed(4)
    info = torch.randint(0, 2, (2, 486), generator=g).to(torch.float32)
    from projectultra_tpu_torch.config import CodeRate
    tx = TP.tx_frame(cfg.replace(modulation=Modulation.QAM32),
                     Modulation.QAM32, CodeRate.R3_4, info)
    with TME.tracing() as rec:
        rec.next_batch()
        TDM.demodulate_presynced(cfg, Modulation.QAM32, tx, 0.0, 0.0, 2,
                                 TP.num_data_symbols(cfg, Modulation.QAM32))
        spans = rec.drain()
    names = {s.id: s.name for s in spans}
    assert [(s.name, names.get(s.parent)) for s in spans] == [
        ("ofdm.demodulate", None), ("ofdm.refined", "ofdm.demodulate")]


def test_receiver_hands_out_the_llrs_it_decodes():
    """``decode_cox_batch(..., n_codewords=8, with_llrs=True)``: the same
    outputs as without, and the LLRs ``demodulate_detected`` gives."""
    entry, info, noise = _entry(13)
    rx = _step(entry, info, noise)["rx"]
    args = (entry.cfg, entry.mod, entry.rate, rx)
    with entry.precision():
        *out, llrs = TSC.decode_cox_batch(*args, n_codewords=8,
                                          with_llrs=True)
        plain = TSC.decode_cox_batch(*args, n_codewords=8)
    for a, b in zip(out[:3], plain[:3]):
        assert torch.equal(a, b)
    assert torch.equal(llrs, TSC.demodulate_detected(entry.cfg, entry.mod,
                                                     rx, plain[3], 8))

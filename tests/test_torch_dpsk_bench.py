"""The DPSK ``medium`` cell of the port's benchmark on the CPU: its plain
reference (``benchmark/reference/dpsk.py``) against the port at the tests'
batch of 4 buffers and against the JAX package's receiver on the same
buffers, ``tx_dpsk_frame`` against the sweep's frame composition, and the
DPSK chain's program spans.

The reference computes the search by direct sums where the port runs a
2^19-point FFT matched filter, so the two meet within float32 rounding:
the TX and the noisy buffer bit for bit (the same float32 operations),
found and data_start exact, the reference symbol within 1e-5 of its
~0.5 magnitude, the CFO within 1e-5 Hz, the initial phase within 1e-4 rad,
the LLRs (|LLR| <= 5) within 1e-4, and the decode (bits, ok flags, LDPC
iterations) exact.  Against JAX the same tolerances hold, with the CFO
within 1e-3 Hz at a 5 Hz offset (where the refine is skipped and the CFO
is the angle of a sum).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402

from benchmark import traffic as BT
from benchmark.reference import channel as ref_channel
from benchmark.reference import dpsk as ref_dpsk
from benchmark.tests.bench_cases import CPU, tiny_cell
from projectultra_tpu.psk import dpsk as JD
from projectultra_tpu_torch import CodeRate
from projectultra_tpu_torch.fec import ldpc as TL
from projectultra_tpu_torch.ops import ldpc as TLO
from projectultra_tpu_torch.parallel import sweep as TS
from projectultra_tpu_torch.psk import dpsk as TD
from projectultra_tpu_torch.sim import watterson as TW
from projectultra_tpu_torch.sync.chirp import frame_spans
from projectultra_tpu_torch.utils import metrics as TME

CELL = "dpsk_medium-acquire-0db-b256"
#: The DPSK step's program spans in the order they open, with the parent
#: of each.
SPAN_TREE = [("dpsk.tx", None), ("noise.awgn", None), ("dpsk.rx", None),
             ("dpsk.find", "dpsk.rx"), ("dpsk.demodulate", "dpsk.rx"),
             ("ldpc.decode", "dpsk.rx")]
DET_TOL = {"prev_symbol": 1e-5, "cfo_hz": 1e-5, "initial_phase_offset": 1e-4}
LLR_ATOL = 1e-4


def _entry(seed, step=0):
    cell = tiny_cell(CELL)
    entry = cell.entry.Entry(cell.config, cell.traffic, CPU)
    info, noise = BT.inputs(cell.traffic, entry.k, entry.T, seed, step, CPU)
    return entry, info, noise


def _step(entry, info, noise, mark=lambda _name: None):
    with entry.precision():
        return entry.step(info, noise, mark)


def _close(a, b, atol):
    return float((a - b).abs().max()) <= atol


@pytest.mark.parametrize("seed", [7, 2**31 + 17, 3_000_000_019])
def test_dpsk_reference_against_the_port(seed):
    entry, info, noise = _entry(seed)
    out = _step(entry, info, noise)
    tx = ref_dpsk.tx(entry.ref_cfg, entry.ref_rate, info, entry.lead,
                     entry.tail)
    rx = ref_channel.add_noise_with(tx, entry.traffic.snr_db, noise)
    bits, ok, iters, det, llrs = ref_dpsk.rx(entry.ref_cfg, entry.ref_rate,
                                             rx)
    assert tx.shape == (4, entry.T) == (4, 287_584)
    assert torch.equal(out["tx"], tx) and torch.equal(out["rx"], rx)
    for key in ("found", "data_start"):
        assert torch.equal(out["det"][key], det[key]), key
    for key, tol in DET_TOL.items():
        assert _close(out["det"][key], det[key], tol), key
    assert llrs.shape == (4, 648) and _close(out["llrs"], llrs, LLR_ATOL)
    assert torch.equal(out["bits"], bits) and torch.equal(out["ok"], ok)
    assert torch.equal(out["iters"], iters)
    assert bool(ok.all()) and bool(det["found"].all())
    assert det["data_start"].tolist() == [4800 + 39 * 768] * 4


def test_dpsk_cell_compares_within_its_limits_on_the_cpu():
    entry, info, noise = _entry(11, 1)
    out = _step(entry, info, noise)
    tally = entry.compare(entry.reference(), info, noise, out)
    numbers = tally.numbers()
    assert list(numbers) == ["tx_err", "rx_err", "corr_err", "cfo_err",
                             "phase_err", "llr_lanes", "llr_err",
                             "lanes_differ", "bits_differ"]
    limits = tiny_cell(CELL).limits
    assert all(numbers[k] <= limits[k] for k in numbers), numbers
    for key in ("tx_err", "rx_err", "llr_lanes", "lanes_differ",
                "bits_differ"):
        assert numbers[key] == 0.0, key


def _cfo(x: torch.Tensor, hz: float) -> torch.Tensor:
    return TW.apply_cfo_hilbert(x, hz) if hz else x


@pytest.mark.parametrize("cfo_hz", [0.0, 5.0])
def test_reference_detection_and_llrs_against_jax(cfo_hz):
    """The reference's preamble search and soft demodulation against JAX's
    ``find_preamble`` and ``demodulate_soft`` on the same noisy buffers
    (the reference's TX at 0 dB, shifted by ``cfo_hz``)."""
    cfg = ref_dpsk.DPSKConfig(48000.0, 1500.0, 768)
    jcfg = JD.medium()
    rate = ref_dpsk.CodeRate.R1_4
    g = torch.Generator().manual_seed(23)
    info = torch.randint(0, 2, (2, 162), generator=g).to(torch.float32)
    tx = _cfo(ref_dpsk.tx(cfg, rate, info, 4800, 4000), cfo_hz)
    rx = ref_channel.add_noise_with(
        tx, 0.0, torch.randn(tx.shape, generator=g))
    bits, ok, _, det, llrs = ref_dpsk.rx(cfg, rate, rx)
    found, ds, cfo, ipo, prev = (torch.from_numpy(np.array(x)) for x in
                                 JD.find_preamble(jcfg, jnp.asarray(
                                     rx.numpy())))
    assert torch.equal(det["found"], found) and bool(found.all())
    assert torch.equal(det["data_start"], ds.to(torch.int32))
    assert _close(det["cfo_hz"], cfo, 1e-3 if cfo_hz else 1e-5)
    # The estimate's magnitude: both packages report the offset with the
    # symbol correlation's sign.
    assert abs(abs(float(cfo.mean())) - cfo_hz) < 0.5
    assert _close(det["initial_phase_offset"], ipo, 1e-4)
    assert _close(det["prev_symbol"], prev, 1e-5)
    span = frame_spans(rx, det["data_start"], 324 * 768)
    jllrs = np.array(JD.demodulate_soft(
        jcfg, jnp.asarray(span.numpy()), jnp.asarray(det["prev_symbol"]
                                                     .numpy()),
        jnp.asarray(det["cfo_hz"].numpy()),
        jnp.asarray(det["initial_phase_offset"].numpy())))[:, :648]
    assert _close(llrs, torch.from_numpy(jllrs), LLR_ATOL)
    assert bool(ok.all()) and torch.equal(bits, info.to(torch.uint8))


@pytest.mark.parametrize("preset", ["medium", "robust", "max_speed"])
def test_tx_dpsk_frame_is_the_sweep_frame(preset):
    """``tx_dpsk_frame`` bit for bit the frame the sweep composed by hand
    ([4,800 zeros][preamble][modulate(encode(info))][4,000 zeros]), and
    the sweep's DPSK batch carries it."""
    cfg = getattr(TD, preset)()
    point = TS.SweepPoint("DPSK", 0.0, frames=3, preset=preset)
    batch = TS.build_dpsk(point, seed=5, device="cpu")
    cw = TLO.encode(TL.get_code(CodeRate.R1_4), batch.info)
    pre = torch.from_numpy(TD.generate_preamble(cfg))
    hand = torch.cat([torch.zeros((3, 4800)), pre.expand(3, -1),
                      TD.modulate(cfg, cw), torch.zeros((3, 4000))], dim=-1)
    frame = TD.tx_dpsk_frame(cfg, CodeRate.R1_4, batch.info)
    assert frame.shape == (3, TD.frame_samples(cfg, CodeRate.R1_4))
    assert torch.equal(frame, hand) and torch.equal(batch.tx, hand)
    assert torch.equal(batch.cw, cw)


def test_receiver_hands_out_the_llrs_it_decodes():
    """``decode_dpsk_batch(..., with_llrs=True)``: the same four outputs as
    without, and the LLRs ``demodulate_soft`` gives on its detection."""
    entry, info, noise = _entry(13)
    rx = _step(entry, info, noise)["rx"]
    with entry.precision():
        *out, llrs = TD.decode_dpsk_batch(entry.cfg, entry.rate, rx,
                                          with_llrs=True)
        plain = TD.decode_dpsk_batch(entry.cfg, entry.rate, rx)
    for a, b in zip(out[:3], plain[:3]):
        assert torch.equal(a, b)
    det = plain[3]
    span = frame_spans(rx, det["data_start"], 324 * 768)
    assert torch.equal(det["data_start"], torch.full((4,), 34752,
                                                     dtype=torch.int32))
    want = TD.demodulate_soft(entry.cfg, span, det["prev_symbol"],
                              det["cfo_hz"], det["initial_phase_offset"])
    assert torch.equal(llrs, want[:, :648])


def test_dpsk_span_tree_of_a_step():
    """One step drains exactly the DPSK spans: names, parents, one batch
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


def test_dpsk_spans_record_nothing_outside_tracing(monkeypatch):
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
    for key in ("tx", "rx", "bits", "ok", "iters", "llrs"):
        assert torch.equal(off[key], on[key]), key

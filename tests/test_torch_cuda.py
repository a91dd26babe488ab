"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need a CUDA card (Hopper: the kernels are built for sm_90a)
and skip without one.  On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py -q

LDPC: bits, ok flags, iteration counts and total LLRs must be equal on
every lane: golden codewords of all five rates, noisy batches of
B in {1, 3, 131, 256, 513, 4,096} at all five rates, both block sizes,
lanes whose channel decisions already satisfy every check beside lanes
that iterate, max_iters {0, 1, 2, 50}, trap_escape, a misaligned view,
and the whole frame pipeline on the card against the same pipeline on
the CPU.  Both instantiations on LLRs with +-inf and NaN (R1/2 and R1/4,
both block sizes, with and without trap_escape): decisions equal on every
lane and totals equal, NaN to NaN.

The bf16-message instantiation of the LDPC kernel against the plain
decoder with ``msg_dtype=torch.bfloat16``: bits, ok flags, iteration
counts and total LLRs equal on every lane at every rate, across the
block-size rule, at max_iters {0, 1, 2}, with trap_escape, and on the
lanes where bf16 messages change a lane's outcome and at LLRs near +-3e38
and +-1e-40; each launch counted by
``cuda_ldpc.launches_bf16`` and none by the float32 counter, also when a
decode takes bf16 from the module default.

Schmidl-Cox windows: P, R1 and R2 within rtol 2e-4, atol 2e-3 (the
tolerance of tests/test_pallas_sync.py; the kernel sums in another order)
at strides 1, 2 and 8, G below one work item and ragged last items, odd B,
odd offsets, lda > T and odd contiguous rows, a Cox buffer's B = 512, a
B = 1 row long enough that every block walks several items through its
ring, one 600,000-sample row within 1e-4 of float64 sums; at one +inf or NaN
sample (Cox- and engine-shaped buffers, strides 1 and 8, half 256 and 512)
non-finite exactly where the plain version is, of the same kind; and
detection through the kernel identical to detection through the plain
version.  The acquisition-
inclusive Cox step goes through both kernels and never synchronises.

Chirp acquisition's decimation kernel against the plain conv path on the
same card tensor, within 1e-6 of the peak (the two sum the 128 products in
other orders): B = 64 x T = 83,808, ragged rows of T = 20,003 with
unaligned starts, the engine's B = 1 view of 262,144 samples, rows shorter
than the filter, chirp buffers and strided views; its bf16 instantiation
against the plain bf16 path within 1e-5; at one NaN or +-inf sample
non-finite exactly where the plain path is; one launch per
``detect_dual_chirp``; its launch plan as the library computes it.

Chirp acquisition, MC-DPSK and the Watterson channel (plain PyTorch on
the card but for the decimation): detection on the card equals the CPU
path (success and positions identical, cfo within 1e-3 Hz); the bench's
chirp step goes through the LDPC kernel and never synchronises;
OFDM_CHIRP decodes behind a detected chirp; ``watterson_with`` on the
card equals the CPU on the same normals.

The rest of the PHY: the window kernel at half = 512 (the 1,024-FFT
plans); the LDPC kernel lane-exact at R3/4 and R5/6 (with and without
trap_escape), on NVIS R5/6 LLRs and on DPSK ``robust``'s -11 dB R1/4
LLRs; the NVIS, DPSK, MFSK and OTFS receiver steps through the kernels and
equal to the CPU path lane for lane; the delay fit's LLRs on the card
within rtol 1e-3, atol 2e-3 of the CPU.

DPSK's differential-score kernel against ``dpsk_score_plain`` on the
card: scores within 2e-6 (scores lie in [0, 1]; the kernel rounds each
differential's complex product as this PyTorch's build does, bit-equal
where measured, but another build may fuse it otherwise), zeros and
non-finite values exactly where the plain version has them, at the CPU
tests' shapes, a strided view, the DPSK path's shapes (``medium`` B = 256,
``robust`` B = 64), the engine's B = 1 search view and a B = 1 row of
262,144 offsets, and at one NaN or +inf correlation; ``find_preamble`` on
the card through one launch, found and data_start equal to the CPU port,
every output bit-equal to the card's plain path, and no synchronisation;
launches counted on ``find_preamble``, ``decode_dpsk_batch`` and the
engine's DPSK search; the DPSK cell's step (``tx_dpsk_frame``, the
channel, ``decode_dpsk_batch``) with one score, one LDPC and one AWGN
launch and no synchronisation, and its entry's six spans on the card.

The streaming engine: ``ModemEngine()`` takes the card; the reference
CLI's five files streamed through it give the CPU engine's events and
consumed positions, through both kernels.

The protocol slice: ``ProtocolEngine``, ``RxPipeline`` and the waveform
adapters take the card; ``decode_hard_stream`` goes through the LDPC
kernel and gives the golden bytes; ``ops/dsp`` and the waterfall on the
card within rtol 1e-4, atol 1e-5 (waterfall: rtol 1e-5 plus 1e-3 dB) of
the CPU; two stations on the card connect and exchange a message each
way through both kernels.

The program's spans (``utils/metrics.span``): one step of each benchmark
entry kind with the spans on records every span's CUDA events without a
synchronisation, each child's device ms within its parent's.

The pilot-tracking scan's CUDA graph (``ops/cuda_graphs.py``)
against its eager loop on the same card tensors, with ``torch.equal`` on
the LLRs and every state field, at B = 1, 7 and 2,048 on DQPSK over the
default pilot plan, QAM64's whole-frame re-demap and the adaptive
equalizer (a shape's first call runs the loop, its second captures);
two replays in a row on different inputs; the cache's bound; no capture
inside a benchmark window of the Cox cell.

The Cox TX's CUDA graph (``ofdm/pipeline.tx_cox_frame``) against its
eager run, bit for bit, at B = 1, 7 and 2,048, and two replays in a row;
the tracking kernel's launches counted at each replay of the scan.

The refined path's CUDA graph (``ofdm/demodulator._demod_coherent_refined``
on NVIS frames) against its eager loops, the LLRs bit for bit, at B = 1, 7
and 2,048 on QAM32 R3/4 (8 codewords) and QAM256 R5/6 (the Tukey window);
two replays in a row on different inputs; ``decode_cox_batch`` replaying
it without a synchronisation; no capture inside a benchmark window of the
NVIS cell, one replay a step; the NVIS entry's spans on the card; the LTS
timing kernel at that cell's B = 2,048 x T = 33,000.

The pilot-tracking kernel (``csrc/pilot_track.cu``) against the scan's
PyTorch step on the same card tensors (DQPSK on the default pilot plan,
B = 1, 7, 2,048): LLRs within 2e-3 and of the same sign, the tracked
state within rtol 1e-3, atol 1e-4 (the kernel sums over carriers in
another order); one launch a symbol; the Cox step's bits, ok flags and
iterations equal through either.

The LTS timing kernel (``csrc/lts_timing.cu``) against the plain FFT
matched filter (``sync/schmidl_cox.lts_timing_plain``) on the same card
tensors: ``detect_preamble``'s every output equal but ``lts_corr``, within
1e-5, at the Cox cell's B = 2,048 x T = 18,856, the engine's B = 1 view
of 262,144 samples with the deep gates, NVIS (plen 1,120) and lanes with
a NaN, +inf or -inf sample or all zeros (NaN where the plain version has
NaN); at given sync_offs whose windows are clipped or empty; on strided
and one-row views; one launch a gate set and none on the CPU; its launch
plan as the library computes it; its wrapper's checks.  The Cox step goes
through it without a synchronisation.

The AWGN channel kernel (``csrc/awgn_active.cu``) against
``sim/watterson.add_noise_with_plain`` on the same card tensors: NaN, +inf
and -inf exactly where the plain version has them, every finite output
within 1e-5 of std * |n| plus one ulp of the output (the two sum a frame's
power in other orders), two runs bitwise equal, one launch a call, at the
cells' shapes (16,384 x 7,332, 2,048 x 18,856, 2,048 x 83,808 and the
DPSK cell's 256 x 287,584, the stream regime on a timed path), 1-D
buffers of 262,144 and 2,000,000 samples, T = 1 (bit for bit) and 7,
empty batches, leading axes, row- and column-strided views, per-frame SNRs
on the card, zero and sub-threshold rows, NaN and infinite samples and an
infinite noise value in each regime; the regimes against each other at a
shape all can take; its launch plan as the library computes it; no
synchronisation; its wrapper's checks.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from projectultra_tpu_torch.config import (CodeRate, ModemConfig,  # noqa: E402
                                           Modulation)
from projectultra_tpu_torch.fec import ldpc  # noqa: E402
from projectultra_tpu_torch.ofdm import pipeline as TP  # noqa: E402
from projectultra_tpu_torch.ops import (cuda_awgn, cuda_build,  # noqa: E402
                                        cuda_decimate, cuda_dpsk, cuda_ldpc,
                                        cuda_lts, cuda_sc)
from projectultra_tpu_torch.ops import dpsk_score as TDS  # noqa: E402
from projectultra_tpu_torch.ops import ldpc as T  # noqa: E402
from projectultra_tpu_torch.ops import sc_windows as TSW  # noqa: E402
from projectultra_tpu_torch.psk import dpsk as TD  # noqa: E402
from projectultra_tpu_torch.psk import mc_dpsk as TMC  # noqa: E402
from projectultra_tpu_torch.sim import watterson as TW  # noqa: E402
from projectultra_tpu_torch.sync import chirp as TC  # noqa: E402
from projectultra_tpu_torch.sync import schmidl_cox as TSC  # noqa: E402

pytestmark = pytest.mark.cuda

NAMES = {CodeRate.R1_4: "R1_4", CodeRate.R1_2: "R1_2", CodeRate.R2_3: "R2_3",
         CodeRate.R3_4: "R3_4", CodeRate.R5_6: "R5_6"}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _golden_llr(golden_dir, rate):
    fields = {}
    with open(os.path.join(golden_dir, f"golden_ldpc_{NAMES[rate]}.txt")) as f:
        for line in f:
            toks = line.split()
            fields.update(zip(toks[::2], toks[1::2]))
    coded = np.unpackbits(np.frombuffer(bytes.fromhex(fields["coded"]),
                                        np.uint8))[:648]
    return (4.0 * (1.0 - 2.0 * coded.astype(np.float32)))[None]


def _noisy_llr(rate, sigma, B):
    code = ldpc.get_code(rate)
    rng = np.random.default_rng(1234)
    info = rng.integers(0, 2, size=(B, code.k)).astype(np.int64)
    cw = np.concatenate([info, (info @ code.h_dense.T.astype(np.int64)) & 1], 1)
    y = (1.0 - 2.0 * cw.astype(np.float32)) \
        + sigma * rng.standard_normal(cw.shape).astype(np.float32)
    return (2.0 * y / (sigma * sigma)).astype(np.float32)


def _assert_kernel_equals_plain(rate, llr, dev, **kw):
    graph = T.graph_for(ldpc.get_code(rate), dev)
    x = torch.from_numpy(llr).to(dev)
    before = cuda_ldpc.launches
    got = cuda_ldpc.decode_cuda(graph, x, **kw)
    assert cuda_ldpc.launches > before
    want = T.decode_plain(graph, x, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return got


@pytest.mark.parametrize("rate", list(NAMES))
def test_kernel_equals_plain_on_golden(dev, golden_dir, rate):
    _, ok, iters = _assert_kernel_equals_plain(
        rate, _golden_llr(golden_dir, rate), dev)
    assert bool(ok.all())


@pytest.mark.parametrize("rate,sigma", [(CodeRate.R1_2, 0.62),
                                        (CodeRate.R1_4, 1.1),
                                        (CodeRate.R5_6, 0.5)])
def test_kernel_equals_plain_under_noise(dev, rate, sigma):
    _, ok, iters = _assert_kernel_equals_plain(
        rate, _noisy_llr(rate, sigma, 512), dev)
    assert 0.0 < float(ok.float().mean()) < 1.0
    assert int(iters.max()) == 50


@pytest.mark.parametrize("max_iters", [0, 1, 2])
def test_kernel_equals_plain_at_few_iterations(dev, max_iters):
    _assert_kernel_equals_plain(CodeRate.R1_2,
                                _noisy_llr(CodeRate.R1_2, 0.62, 256), dev,
                                max_iters=max_iters)


def test_kernel_trap_escape_equals_plain(dev):
    _assert_kernel_equals_plain(CodeRate.R1_2,
                                _noisy_llr(CodeRate.R1_2, 0.62, 256), dev,
                                max_iters=6, trap_escape=True)


SIGMA = {CodeRate.R1_4: 1.1, CodeRate.R1_2: 0.62, CodeRate.R2_3: 0.55,
         CodeRate.R3_4: 0.5, CodeRate.R5_6: 0.5}


@pytest.mark.parametrize("rate", list(NAMES))
@pytest.mark.parametrize("B", [1, 3, 131, 256, 513, 4096])
def test_kernel_equals_plain_at_every_launch_shape(dev, rate, B):
    """Batches across the block-size rule (1,024 threads per codeword at
    small B, 256 at large B)."""
    _assert_kernel_equals_plain(rate, _noisy_llr(rate, SIGMA[rate], B), dev)


@pytest.mark.parametrize("rate", list(NAMES))
@pytest.mark.parametrize("threads", [256, 1024])
def test_kernel_equals_plain_at_every_block_size(dev, monkeypatch, rate,
                                                 threads):
    monkeypatch.setattr(cuda_ldpc, "block_threads_for", lambda B, sms: threads)
    _assert_kernel_equals_plain(rate, _noisy_llr(rate, SIGMA[rate], 131), dev)


def test_kernel_equals_plain_on_clean_and_noisy_lanes(dev):
    """A batch where some lanes' channel decisions satisfy every check (the
    kernel runs their first syndrome without the next update) and others do
    not (fused)."""
    rate = CodeRate.R1_2
    llr = _noisy_llr(rate, 0.35, 512)
    graph = T.graph_for(ldpc.get_code(rate), dev)
    noisy = T._syndrome(graph, torch.from_numpy(llr).to(dev)).any(-1)
    assert 0 < int(noisy.sum()) < 512
    _, ok, iters = _assert_kernel_equals_plain(rate, llr, dev)
    assert bool((iters[noisy & ok] > 0).any())


@pytest.mark.parametrize("max_iters", [0, 1, 2, 50])
@pytest.mark.parametrize("B", [3, 513, 4096])
def test_kernel_equals_plain_at_max_iters(dev, max_iters, B):
    _assert_kernel_equals_plain(CodeRate.R1_2,
                                _noisy_llr(CodeRate.R1_2, 0.62, B), dev,
                                max_iters=max_iters)


@pytest.mark.parametrize("B", [131, 4096])
def test_kernel_trap_escape_equals_plain_at_width(dev, B):
    _assert_kernel_equals_plain(CodeRate.R1_4,
                                _noisy_llr(CodeRate.R1_4, 1.1, B), dev,
                                trap_escape=True)


def _assert_bf16_kernel_equals_plain(rate, llr, dev, **kw):
    graph = T.graph_for(ldpc.get_code(rate), dev)
    x = torch.from_numpy(llr).to(dev)
    before, before32 = cuda_ldpc.launches_bf16, cuda_ldpc.launches
    got = cuda_ldpc.decode_cuda(graph, x, msg_dtype=torch.bfloat16, **kw)
    assert cuda_ldpc.launches_bf16 > before
    assert cuda_ldpc.launches == before32
    want = T.decode_plain(graph, x, msg_dtype=torch.bfloat16, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return got


@pytest.mark.parametrize("rate", list(NAMES))
@pytest.mark.parametrize("B", [3, 513, 4096])
def test_bf16_kernel_equals_plain(dev, rate, B):
    _assert_bf16_kernel_equals_plain(rate, _noisy_llr(rate, SIGMA[rate], B),
                                     dev)


@pytest.mark.parametrize("max_iters", [0, 1, 2])
def test_bf16_kernel_equals_plain_at_few_iterations(dev, max_iters):
    _assert_bf16_kernel_equals_plain(CodeRate.R1_2,
                                     _noisy_llr(CodeRate.R1_2, 0.62, 256),
                                     dev, max_iters=max_iters)


@pytest.mark.parametrize("rate", [CodeRate.R1_2, CodeRate.R1_4])
def test_bf16_kernel_trap_escape_equals_plain(dev, rate):
    _assert_bf16_kernel_equals_plain(rate, _noisy_llr(rate, SIGMA[rate], 513),
                                     dev, trap_escape=True)


def test_bf16_kernel_where_bf16_changes_the_outcome(dev):
    """A waterfall batch on which bf16 and float32 messages end some lanes
    differently: the kernel follows the bf16 decoder there."""
    llr = _noisy_llr(CodeRate.R1_2, 0.72, 4096)
    graph = T.graph_for(ldpc.get_code(CodeRate.R1_2), torch.device("cpu"))
    f32 = T.decode_plain(graph, torch.from_numpy(llr))
    _, ok, iters = _assert_bf16_kernel_equals_plain(CodeRate.R1_2, llr, dev)
    assert not torch.equal(iters.cpu(), f32[2])


def test_bf16_kernel_at_extreme_llrs(dev):
    """LLRs near +-3e38 (their bf16 c2v near 2.25e38, totals that overflow
    to +-inf) and near +-1e-40 (bf16 subnormals, the smallest rounding to
    +-0): whole lanes of each, lanes mixing both with ordinary LLRs, and
    ordinary lanes; lane-exact against the plain bf16 decoder."""
    rng = np.random.default_rng(77)
    llr = _noisy_llr(CodeRate.R1_2, 0.62, 512)
    sign = np.where(llr < 0, -1.0, 1.0)
    huge = sign * rng.uniform(2.9e38, 3.0e38, llr.shape)
    tiny = sign * rng.uniform(0.0, 2e-40, llr.shape)
    pick = rng.integers(0, 3, llr.shape)
    mixed = np.where(pick == 1, huge, np.where(pick == 2, tiny, llr))
    x = np.concatenate([huge[:128], tiny[128:256], mixed[256:384],
                        llr[384:]]).astype(np.float32)
    assert np.isfinite(x).all() and (np.abs(x[128:256]) < 2e-40).all()
    _, ok, iters = _assert_bf16_kernel_equals_plain(CodeRate.R1_2, x, dev,
                                                    max_iters=8)
    assert bool((iters > 0).any())


#: The batches of ``nonfinite_llrs``: the waterfall points of R1/2 and R1/4.
NONFINITE = [(CodeRate.R1_2, 0.62), (CodeRate.R1_4, 1.1)]
#: NaN bit patterns a poisoned LLR takes: quiet NaNs of both signs, the
#: all-ones one and a signalling one whose payload lies in the low 16 bits
#: only (a bf16 rounding that truncated it would make it inf).
NAN_BITS = np.array([0x7FC00000, 0xFFC00000, 0xFFFFFFFF, 0x7F800001],
                    np.uint32)


def nonfinite_llrs(rate, sigma, B, kind, seed=99):
    """The waterfall batch ``_noisy_llr(rate, sigma, B)`` with 1-3 LLRs of
    every even lane set to +-inf (``kind`` "inf": +inf and -inf can meet
    in a variable's total, which is then NaN) or to NaN (``kind`` "nan",
    each of a pattern of ``NAN_BITS``); odd lanes as drawn."""
    x = _noisy_llr(rate, sigma, B)
    rng = np.random.default_rng(seed)
    for b in range(0, B, 2):
        k = int(rng.integers(1, 4))
        pos = rng.choice(x.shape[1], k, replace=False)
        if kind == "inf":
            x[b, pos] = np.where(rng.integers(0, 2, k) == 1, np.inf, -np.inf)
        else:
            x[b, pos] = NAN_BITS[rng.integers(0, len(NAN_BITS), k)] \
                .view(np.float32)
    return x


def lanes_that_differ(k, got, want):
    """(lanes whose bits, ok flag or iterations differ, lanes whose
    totals differ), each a bool [B]; a NaN total equals a NaN total."""
    (ta, oa, ia), (tb, ob, ib) = got, want
    decisions = (((ta[:, :k] < 0) != (tb[:, :k] < 0)).any(1) | (oa != ob)
                 | (ia != ib))
    same = (ta == tb) | (torch.isnan(ta) & torch.isnan(tb))
    return decisions, ~same.all(1)


@pytest.mark.parametrize("trap_escape", [False, True])
@pytest.mark.parametrize("threads", [256, 1024])
@pytest.mark.parametrize("msg", ["f32", "bf16"])
def test_kernels_at_nonfinite_llrs(dev, monkeypatch, msg, threads,
                                   trap_escape):
    """Both instantiations on LLRs with +-inf and NaN (``nonfinite_llrs``,
    B = 256 and 4,096 at R1/2 and R1/4): bits, ok flags and iterations
    equal to the plain decoder on every lane, and the totals equal, NaN to
    NaN -- the v2c clamp and min2 keep a NaN, as jnp.clip/jnp.minimum
    do."""
    monkeypatch.setattr(cuda_ldpc, "block_threads_for", lambda B, sms: threads)
    dtype = torch.bfloat16 if msg == "bf16" else torch.float32
    counter = "launches_bf16" if msg == "bf16" else "launches"
    report, nan_totals = {}, 0
    for rate, sigma in NONFINITE:
        graph = T.graph_for(ldpc.get_code(rate), dev)
        for kind, B in ((k, B) for k in ("inf", "nan") for B in (256, 4096)):
            x = torch.from_numpy(nonfinite_llrs(rate, sigma, B, kind)).to(dev)
            before = getattr(cuda_ldpc, counter)
            got = cuda_ldpc.decode_cuda(graph, x, trap_escape=trap_escape,
                                        msg_dtype=dtype)
            assert getattr(cuda_ldpc, counter) > before
            want = T.decode_plain(graph, x, trap_escape=trap_escape,
                                  msg_dtype=dtype)
            decisions, totals = lanes_that_differ(graph.k, got, want)
            report[f"{NAMES[rate]} {kind} B={B}"] = (int(decisions.sum()),
                                                     int(totals.sum()))
            nan_totals += int(torch.isnan(want[0]).any(1).sum())
    assert nan_totals > 0
    assert all(v == (0, 0) for v in report.values()), (
        f"lanes that differ from the plain decoder (decisions, totals): "
        f"{report}")


def test_bf16_default_decode_goes_through_the_bf16_kernel(dev):
    code = ldpc.get_code(CodeRate.R1_2)
    x = torch.from_numpy(_noisy_llr(CodeRate.R1_2, 0.62, 64)).to(dev)
    before, before32 = cuda_ldpc.launches_bf16, cuda_ldpc.launches
    with T.default_msg_dtype(torch.bfloat16):
        got = T.decode(code, x)
    assert cuda_ldpc.launches_bf16 == before + 1
    assert cuda_ldpc.launches == before32
    want = T.decode(code, x.cpu(), msg_dtype=torch.bfloat16)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_kernel_takes_a_misaligned_view(dev):
    """Rows at a 4-byte (not 16-byte) offset are copied aligned and decode
    like plain."""
    llr = _noisy_llr(CodeRate.R1_2, 0.62, 66)
    x = torch.from_numpy(llr).to(dev).reshape(-1)[648 + 1:].reshape(-1)
    x = x[:64 * 648].reshape(64, 648)
    assert x.data_ptr() % 16
    graph = T.graph_for(ldpc.get_code(CodeRate.R1_2), dev)
    for a, b in zip(cuda_ldpc.decode_cuda(graph, x), T.decode_plain(graph, x)):
        assert torch.equal(a, b)


def test_decode_on_cuda_goes_through_the_kernel(dev):
    code = ldpc.get_code(CodeRate.R1_2)
    x = torch.from_numpy(_noisy_llr(CodeRate.R1_2, 0.62, 64)).to(dev)
    before = cuda_ldpc.launches
    bits, ok, iters = T.decode(code, x)
    assert cuda_ldpc.launches == before + 1
    ref = T.decode(code, x.cpu())
    for a, b in zip((bits, ok, iters), ref):
        assert torch.equal(a.cpu(), b)


def test_kernel_wrapper_checks_its_inputs(dev):
    graph = T.graph_for(ldpc.get_code(CodeRate.R1_2), dev)
    with pytest.raises(ValueError):
        cuda_ldpc.launch(graph, torch.zeros((4, 648), dtype=torch.float64,
                                            device=dev), 50)
    with pytest.raises(ValueError):
        cuda_ldpc.launch(graph, torch.zeros((4, 640), device=dev), 50)
    with pytest.raises(ValueError):
        cuda_ldpc.launch(graph, torch.zeros((648, 4), device=dev).T, 50)


def test_pipeline_on_the_card_equals_the_cpu(dev):
    cfg = TP.chirp_ofdm_config()
    code = ldpc.get_code(CodeRate.R1_2)
    g = torch.Generator().manual_seed(7)
    info = torch.randint(0, 2, (64, code.k), generator=g, dtype=torch.uint8)
    tx = TP.tx_frame(cfg, Modulation.DQPSK, CodeRate.R1_2, info)
    rx = TW.add_noise_active(tx, 3.0, g)
    cpu = TP.rx_frame(cfg, Modulation.DQPSK, CodeRate.R1_2, rx)
    gpu = TP.rx_frame(cfg, Modulation.DQPSK, CodeRate.R1_2, rx.to(dev))
    # The demodulator's float32 products differ by ulps between the two
    # devices; at 3 dB (some lanes need a second iteration) a lane could
    # flip, so compare decoded frames.
    both = cpu[1] & gpu[1].cpu()
    assert float(both.float().mean()) > 0.9
    assert torch.equal(cpu[0][both], gpu[0].cpu()[both])
    assert torch.equal(gpu[0].cpu()[gpu[1].cpu()], info[gpu[1].cpu()])


def test_main_path_never_synchronises(dev):
    """tx_frame -> add_noise_active -> rx_frame enqueue without a single
    host-device synchronisation once the per-device tables exist."""
    cfg = TP.chirp_ofdm_config()
    code = ldpc.get_code(CodeRate.R1_2)
    g = torch.Generator(device=dev).manual_seed(3)
    info = torch.randint(0, 2, (256, code.k), generator=g, device=dev,
                         dtype=torch.uint8)

    def step():
        tx = TP.tx_frame(cfg, Modulation.DQPSK, CodeRate.R1_2, info)
        rx = TW.add_noise_active(tx, 17.0, g)
        return TP.rx_frame(cfg, Modulation.DQPSK, CodeRate.R1_2, rx)

    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, ok, _ = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(ok.all()) and torch.equal(out, info)


# ---------------------------------------------------------------------------
# Schmidl-Cox window kernel and the Cox path
# ---------------------------------------------------------------------------

COX_CFG = ModemConfig()


def _analytic_on(dev, B, T, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, T), generator=g, device=dev)
    return TSC.analytic_signal(x)  # a row-strided view of [B, n_fft]


def _assert_windows_close(a, half, stride, offset, G):
    before = cuda_sc.launches
    got = cuda_sc.sc_windows_cuda(a, half, stride, offset, G)
    assert cuda_sc.launches == before + 1
    want = TSW.sc_windows_plain(a, half, stride, offset, G)
    for x, y in zip(got, want):
        assert x.shape == y.shape == (a.shape[0], G)
        torch.testing.assert_close(x, y, rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("T", [18856, 9001, 600])
@pytest.mark.parametrize("stride,offset", [(1, 0), (1, 48), (8, 48)])
def test_window_kernel_equals_plain(dev, T, stride, offset):
    """B = 16, and B = 512 (a Cox buffer's batch: tiles of 460 at its
    T = 18,856, stride 8)."""
    for B, seed in ((16, T), (512, T + 1)):
        a = _analytic_on(dev, B, T, seed=seed)
        assert not a.is_contiguous()
        G = (T - 2 * 256 - offset) // stride + 1
        _assert_windows_close(a, 256, stride, offset, G)
        _assert_windows_close(a, 256, stride, offset, min(G, 5))


def test_window_sums_hold_float64_on_a_long_buffer(dev):
    """One 600,000-sample buffer of positive samples at stride 1, w = 512
    (tests/test_long_buffer_precision.py:20-36): P, R1 and R2 of the
    kernel and of the plain version within a relative 1e-4 of float64
    sums."""
    T, half = 600_000, 256
    x = (np.random.default_rng(1).standard_normal(T).astype(np.float32)
         + 0.5) ** 2
    x64 = x.astype(np.float64)
    ones = np.ones(half)
    e = np.convolve(x64 * x64, ones, mode="valid")
    refs = (np.convolve(x64[:-half] * x64[half:], ones, mode="valid"),
            e[:T - 2 * half + 1], e[half:])
    a = torch.from_numpy(x).to(dev).to(torch.complex64)[None]
    for fn in (cuda_sc.sc_windows_cuda, TSW.sc_windows_plain):
        outs = fn(a, half, 1, 0, T - 2 * half + 1)
        for o, r in zip(outs, refs):
            rel = np.abs(o[0].real.double().cpu().numpy() - r) / r
            assert float(rel.max()) < 1e-4, fn.__name__


@pytest.mark.parametrize("B", [1, 7])
@pytest.mark.parametrize("stride", [1, 2, 8])
@pytest.mark.parametrize("G", [5, 512, 1000, 2049])
def test_window_kernel_tiles(dev, B, stride, G):
    """G below one work item, about one, ragged last items, odd B, an odd
    offset at stride 1, and a row stride (lda) above T."""
    offset = 48 if stride > 1 else 47
    T = offset + stride * (G - 1) + 2 * 256 + 3
    a = _analytic_on(dev, B, T, seed=G + stride)
    assert a.stride(0) > T
    _assert_windows_close(a, 256, stride, offset, G)


@pytest.mark.parametrize("stride", [1, 8])
def test_window_kernel_blocks_walk_many_items(dev, stride):
    """One 83 s row at 48 kHz (B = 1, T = 4,000,000): at least twice as
    many work items as resident blocks, so every block walks several
    through its ring of stages (the mbarrier phases of later rounds)."""
    T = 4_000_000
    a = _analytic_on(dev, 1, T, seed=stride)
    G = (T - 2 * 256 - 48) // stride + 1
    plan = cuda_sc.launch_plan(1, T, 256, stride, 48, G, dev)
    assert plan["stages"] == 2 and plan["items"] >= 2 * plan["blocks"]
    _assert_windows_close(a, 256, stride, 48, G)


@pytest.mark.parametrize("half,stride", [(6000, 1), (7000, 8)])
def test_window_kernel_one_stage_ring(dev, half, stride):
    """Halves whose two stages do not fit a block's shared memory, so the
    ring has one (at stride 8, 875 partials a window: the scalar window
    loop too)."""
    T = 20000
    a = _analytic_on(dev, 2, T, seed=stride)
    G = (T - 2 * half) // stride + 1
    assert cuda_sc.launch_plan(2, T, half, stride, 0, G, dev)["stages"] == 1
    _assert_windows_close(a, half, stride, 0, G)


@pytest.mark.parametrize("half,stride", [(6, 1), (6, 2), (200, 8),
                                         (300, 2), (300, 4), (24, 2),
                                         (200, 2)])
def test_window_kernel_at_other_halves(dev, half, stride):
    """Halves other than the plans' 256 and 512: 6, 3, 25, 150 and 75
    partials a window (not a multiple of 4: the scalar window loop), 12
    and 100 (the float4 loop)."""
    T = 3001
    a = _analytic_on(dev, 3, T, seed=half + stride)
    for offset in (0, 2 * stride):
        G = (T - 2 * half - offset) // stride + 1
        _assert_windows_close(a, half, stride, offset, G)


def test_window_kernel_plan(dev):
    """The launch plan at the Cox buffer: tiles of 460 outputs, five a row,
    a two-stage ring, blocks fewer than items."""
    G = TSC.search_grid_size(COX_CFG, 18856)
    plan = cuda_sc.launch_plan(512, 18856, 256, 8, 48, G, dev)
    assert plan["tile"] == 460 and plan["items"] == 512 * 5
    assert plan["stages"] == 2 and 0 < plan["blocks"] < plan["items"]
    assert plan["shared_bytes"] > 2 * 8 * cuda_sc.stage_samples(460, 256, 8)


def test_window_kernel_reads_odd_rows(dev):
    """Odd T in contiguous rows (odd lda): the wrapper copies the rows into
    an even row stride for the kernel's 16-byte loads."""
    a = _analytic_on(dev, 3, 3001).contiguous()
    assert a.stride(0) % 2 == 1
    _assert_windows_close(a, 256, 1, 1, 3001 - 512 - 1 + 1)
    _assert_windows_close(a, 256, 8, 8, (3001 - 512 - 8) // 8 + 1)


NONFINITE_BUFFERS = {  # B, T, the lane and the sample made non-finite
    "cox": (512, 18856, 300, 3828),
    "engine": (1, 262144, 0, 100000),
}
NONFINITE_VALUES = {"inf": complex(float("inf"), 0.0),
                    "nan": complex(float("nan"), 0.0)}


def _assert_same_nonfinite(got, want):
    """Each real part of P, R1 and R2 non-finite exactly where the plain
    version's is, of the same kind (NaN, +inf, -inf), and within rtol
    2e-4, atol 2e-3 elsewhere."""
    for x, y, name in zip(got, want, ("P", "R1", "R2")):
        parts = ((x.real, y.real, name + ".real"), (x.imag, y.imag,
                                                     name + ".imag")) \
            if y.is_complex() else ((x, y, name),)
        for xp, yp, label in parts:
            bad = ~torch.isfinite(yp)
            assert bool(bad.any()), f"{label}: the sample reached no output"
            for test in (torch.isnan, torch.isposinf, torch.isneginf):
                assert torch.equal(test(xp), test(yp)), \
                    f"{label}: {test.__name__} differs at " \
                    f"{torch.nonzero(test(xp) != test(yp))[:5].tolist()}"
            torch.testing.assert_close(xp[~bad], yp[~bad], rtol=2e-4,
                                       atol=2e-3)


@pytest.mark.parametrize("kind", sorted(NONFINITE_VALUES))
@pytest.mark.parametrize("half,offset", [(256, 48), (512, 96)])
@pytest.mark.parametrize("stride", [1, 8])
@pytest.mark.parametrize("buffer", sorted(NONFINITE_BUFFERS))
def test_window_kernel_at_a_nonfinite_sample(dev, buffer, stride, half,
                                             offset, kind):
    """One +inf (or NaN) sample straight into the kernel, in a Cox-shaped
    and an engine-shaped buffer: non-finite at the plain version's outputs,
    of the same kind, and the usual tolerance elsewhere."""
    B, T, lane, t = NONFINITE_BUFFERS[buffer]
    a = _analytic_on(dev, B, T, seed=stride + half)
    a[lane, t] = NONFINITE_VALUES[kind]
    G = (T - 2 * half - offset) // stride + 1
    got = cuda_sc.sc_windows_cuda(a, half, stride, offset, G)
    _assert_same_nonfinite(got, TSW.sc_windows_plain(a, half, stride, offset,
                                                     G))


def test_window_kernel_wrapper_checks_its_inputs(dev):
    a = _analytic_on(dev, 2, 4000)
    with pytest.raises(ValueError):
        cuda_sc.sc_windows_cuda(a.to(torch.complex128), 256, 8, 48, 10)
    with pytest.raises(ValueError):
        cuda_sc.sc_windows_cuda(a[0], 256, 8, 48, 10)
    with pytest.raises(ValueError):
        cuda_sc.sc_windows_cuda(a.T, 256, 8, 48, 10)
    with pytest.raises(ValueError):
        cuda_sc.sc_windows_cuda(a, 256, 8, 48, 500)
    with pytest.raises(ValueError):
        cuda_sc.sc_windows_cuda(a, 256, 128, 0, 10)  # stride/2 > a warp


def _cox_buffers(dev, B, snr_db=17.0, cfo=0.0, seed=5):
    """The port's own Cox frames at the bench's shape: lead 1,504,
    preamble, 22 DQPSK symbols, tail 1,024 (T = 18,856)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    info = torch.randint(0, 2, (B, ldpc.get_code(CodeRate.R1_2).k),
                         generator=g, device=dev, dtype=torch.uint8)
    tx = TP.tx_cox_frame(COX_CFG, Modulation.DQPSK, CodeRate.R1_2, info,
                         lead=1504, tail=1024)
    if cfo:
        tx = TW.apply_cfo_hilbert(tx, cfo)
    return info, TW.add_noise_active(tx, snr_db, g)


def test_detection_through_the_kernel_equals_plain(dev, monkeypatch):
    _, rx = _cox_buffers(dev, 512)
    before = cuda_sc.launches
    det = TSC.detect_preamble(COX_CFG, rx, with_deep=True)
    assert cuda_sc.launches == before + 1
    monkeypatch.setattr(TSC, "sc_windows", TSW.sc_windows_plain)
    ref = TSC.detect_preamble(COX_CFG, rx, with_deep=True)
    assert cuda_sc.launches == before + 1
    for key in ref:
        if ref[key].dtype in (torch.bool, torch.int32):
            assert torch.equal(det[key], ref[key]), key
        else:
            torch.testing.assert_close(det[key], ref[key], rtol=0,
                                       atol=0.01 if "cfo" in key else 1e-4)
    assert det["found"].all()


def test_sc_metric_through_the_kernel(dev):
    _, rx = _cox_buffers(dev, 4)
    before = cuda_sc.launches
    corr, P = TSC.sc_metric(COX_CFG, rx)
    assert cuda_sc.launches == before + 1
    ref_corr, ref_P = TSC.sc_metric(COX_CFG, rx.cpu())
    torch.testing.assert_close(P.cpu(), ref_P, rtol=2e-4, atol=2e-3)
    torch.testing.assert_close(corr.cpu(), ref_corr, rtol=0, atol=1e-3)


def test_cox_step_goes_through_both_kernels(dev):
    info, rx = _cox_buffers(dev, 128)
    sc0, ldpc0 = cuda_sc.launches, cuda_ldpc.launches
    out, ok, _, det = TSC.decode_cox_batch(COX_CFG, Modulation.DQPSK,
                                           CodeRate.R1_2, rx)
    assert cuda_sc.launches > sc0 and cuda_ldpc.launches > ldpc0
    assert float(ok.float().mean()) >= 0.99
    assert torch.equal(out[ok], info[ok])
    cpu = TSC.decode_cox_batch(COX_CFG, Modulation.DQPSK, CodeRate.R1_2,
                               rx.cpu())
    both = ok.cpu() & cpu[1]
    assert torch.equal(out.cpu()[both], cpu[0][both])


def test_cox_step_decodes_under_cfo(dev):
    info, rx = _cox_buffers(dev, 64, snr_db=20.0, cfo=30.0, seed=8)
    out, ok, _, det = TSC.decode_cox_batch(COX_CFG, Modulation.DQPSK,
                                           CodeRate.R1_2, rx)
    assert float(ok.float().mean()) >= 0.99
    assert torch.equal(out[ok], info[ok])
    assert float((det["cfo_hz"] - 30.0).abs().max()) < 8.0


def test_cox_step_never_synchronises(dev):
    """detect -> gather -> demodulate_span -> deinterleave -> decode
    enqueue without a host-device synchronisation once the per-device
    tables exist."""
    info, rx = _cox_buffers(dev, 128)

    def step():
        return TSC.decode_cox_batch(COX_CFG, Modulation.DQPSK,
                                    CodeRate.R1_2, rx)

    step()
    torch.cuda.synchronize()
    lts = cuda_lts.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, ok, _, _ = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(ok.all()) and torch.equal(out, info)
    assert cuda_lts.launches == lts + 1


# ---------------------------------------------------------------------------
# Chirp acquisition, MC-DPSK, OFDM behind a chirp, the Watterson channel
# ---------------------------------------------------------------------------

MC10 = TMC.level10()
CC = MC10.chirp_config()
DET_KEYS = ("success", "up_chirp_start", "down_chirp_start",
            "first_strong_up", "next_up_start")


def _chirp_buffers(dev, B, snr_db=5.0, cfo=0.0, seed=9):
    """The bench's chirp frames (T = 83,808) through AWGN on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    info = torch.randint(0, 2, (B, ldpc.get_code(CodeRate.R1_4).k),
                         generator=g, device=dev, dtype=torch.uint8)
    tx = TMC.tx_chirp_frame(MC10, CodeRate.R1_4, info)
    if cfo:
        tx = TW.apply_cfo_hilbert(tx, cfo)
    return info, TW.add_noise_active(tx, snr_db, g)


def test_decimation_on_the_card_is_float32(dev):
    """cuDNN convolutions default to TF32 (~1e-3 relative); with the
    package's pins the card's decimation stays within 1e-5 of the CPU's."""
    assert torch.backends.cudnn.allow_tf32 is False
    x = torch.randn((16, 83808), generator=torch.Generator().manual_seed(2))
    got = TC._decimate(CC, x.to(dev)).cpu()
    ref = TC._decimate(CC, x)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


DECIMATE_SHAPES = [(2048, 83808), (64, 83808), (3, 20003), (1, 262144),
                   (2, 100)]


def _decimate_both(x):
    """(kernel, plain) decimation of the card tensor x; the kernel's call
    through ``_decimate`` launches once."""
    before = cuda_decimate.launches
    got = TC._decimate(CC, x)
    assert cuda_decimate.launches == before + 1
    return got, TC._decimate_plain(CC, x)


def _normals(dev, B, T, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((B, T), generator=g, device=dev)


@pytest.mark.parametrize("B,T", DECIMATE_SHAPES)
def test_decimation_kernel_equals_plain(dev, B, T):
    """The kernel against cuDNN's conv path on the same card tensor: the
    acquired cell's batch and rows, ragged rows with unaligned starts, the
    engine's B = 1 view and rows shorter than the filter; float32 rounding
    apart (the two sum the 128 products in other orders)."""
    got, want = _decimate_both(_normals(dev, B, T, B + T))
    assert got.dtype == torch.complex64
    assert got.shape == want.shape == (B, -(-T // 8))
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_decimation_kernel_on_chirp_buffers_and_views(dev):
    _, rx = _chirp_buffers(dev, 64)
    got, want = _decimate_both(rx)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    wide = _normals(dev, 5, 20011, 4)
    for view in (wide[:, 3:20003], wide[2:3, 5:], wide[1:, 8:16008]):
        got, want = _decimate_both(view)
        assert float((got - want).abs().max()) \
            <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("B,T", [(2048, 83808), (64, 83808), (3, 20003)])
def test_decimation_kernel_bf16_equals_plain_bf16(dev, B, T):
    x = _normals(dev, B, T, 7 * T)
    with TC.bf16_mode():
        got, want = _decimate_both(x)
    peak = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * peak
    # the mode rounds: the float32 path differs from it by more
    assert float((TC._decimate_plain(CC, x) - want).abs().max()) > 1e-5 * peak


@pytest.mark.parametrize("kind", ["nan", "inf", "-inf"])
@pytest.mark.parametrize("where", [0, 4000, 20002])
def test_decimation_kernel_at_a_nonfinite_sample(dev, kind, where):
    x = _normals(dev, 3, 20003, 11)
    x[1, where] = float(kind)
    got, want = _decimate_both(x)
    for part in (torch.real, torch.imag):
        g, w = part(got).cpu(), part(want).cpu()
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(torch.isinf(g), torch.isinf(w))
        assert torch.equal(g[torch.isinf(g)], w[torch.isinf(w)])
    assert not bool(torch.isfinite(want[1]).all())
    assert bool(torch.isfinite(want[0]).all() & torch.isfinite(got[0]).all())


def test_detection_launches_the_decimation_kernel_once(dev):
    info, rx = _chirp_buffers(dev, 16)
    before = cuda_decimate.launches
    TC.detect_dual_chirp(CC, rx)
    assert cuda_decimate.launches == before + 1
    TMC.decode_chirp_batch(MC10, CodeRate.R1_4, rx)
    assert cuda_decimate.launches == before + 2


@pytest.mark.parametrize("B,T", DECIMATE_SHAPES)
def test_decimation_kernel_plan(dev, B, T):
    plan = cuda_decimate.card_plan(B, T, dev)
    assert plan["library"] == {"blocks": plan["blocks"],
                               "threads": plan["threads"],
                               "shared_bytes": plan["shared_bytes"]}
    assert plan["blocks_per_sm"] >= 4


def test_chirp_detection_on_the_card_equals_the_cpu(dev):
    _, rx = _chirp_buffers(dev, 64, cfo=20.0)
    det = TC.detect_dual_chirp(CC, rx)
    ref = TC.detect_dual_chirp(CC, rx.cpu())
    for key in DET_KEYS:
        assert torch.equal(det[key].cpu(), ref[key]), key
    torch.testing.assert_close(det["cfo_hz"].cpu(), ref["cfo_hz"], rtol=0,
                               atol=1e-3)
    assert det["success"].all()
    assert float((det["cfo_hz"] - 20.0).abs().max()) < 2.0


def test_chirp_step_goes_through_the_ldpc_kernel(dev):
    info, rx = _chirp_buffers(dev, 64)
    before = cuda_ldpc.launches
    out, ok, _, det = TMC.decode_chirp_batch(MC10, CodeRate.R1_4, rx)
    assert cuda_ldpc.launches == before + 1
    assert float(ok.float().mean()) >= 0.99
    assert torch.equal(out[ok], info[ok])
    cpu = TMC.decode_chirp_batch(MC10, CodeRate.R1_4, rx.cpu())
    both = ok.cpu() & cpu[1]
    assert torch.equal(out.cpu()[both], cpu[0][both])


def test_chirp_step_never_synchronises(dev):
    """detect -> gather -> CFO-corrected demodulation -> decode enqueue
    without a host-device synchronisation once the per-device tables
    exist."""
    info, rx = _chirp_buffers(dev, 64, cfo=12.0)

    def step():
        return TMC.decode_chirp_batch(MC10, CodeRate.R1_4, rx)

    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, ok, _, _ = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(ok.all()) and torch.equal(out, info)


def test_ofdm_after_chirp_on_the_card(dev):
    cfg = TP.chirp_ofdm_config()
    g = torch.Generator(device=dev).manual_seed(12)
    info = torch.randint(0, 2, (32, ldpc.get_code(CodeRate.R1_2).k),
                         generator=g, device=dev, dtype=torch.uint8)
    chirp = torch.from_numpy(TC.generate(CC)).to(dev)
    tx = torch.cat([torch.zeros((32, TMC.LEAD), device=dev),
                    chirp.expand(32, chirp.shape[0]),
                    TP.tx_frame(cfg, Modulation.DQPSK, CodeRate.R1_2, info),
                    torch.zeros((32, TMC.TAIL), device=dev)], dim=-1)
    rx = TW.add_noise_active(TW.apply_cfo_hilbert(tx, 30.0), 17.0, g)
    before = cuda_ldpc.launches
    det = TC.detect_dual_chirp(CC, rx)
    tr = TC.training_start(CC, det["down_chirp_start"])
    phase = TC.initial_cfo_phase(CC, det["cfo_hz"], tr)
    span = TC.frame_spans(rx, tr, TP.frame_samples(cfg, Modulation.DQPSK))
    out, ok, _ = TP.rx_frame(cfg, Modulation.DQPSK, CodeRate.R1_2, span,
                             det["cfo_hz"], phase)
    assert cuda_ldpc.launches > before
    assert bool((ok & det["success"]).all()) and torch.equal(out, info)
    assert float((det["cfo_hz"] - 30.0).abs().max()) < 2.0


@pytest.mark.parametrize("preset", ["moderate", "flutter"])
def test_watterson_with_on_the_card_equals_the_cpu(dev, preset):
    cfg = TW.HARNESS_PRESETS[preset](10.0)
    B, T = 8, 83808
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((B, T), generator=g, device=dev)
    fade = torch.randn((2, B, 2, T), generator=g, device=dev)
    awgn = torch.randn((B, T), generator=g, device=dev)
    taps = TW.rayleigh_taps_with(cfg, fade)
    ref_taps = TW.rayleigh_taps_with(cfg, fade.cpu())
    assert bool(torch.isfinite(taps).all())
    rms = float(ref_taps.abs().pow(2).mean().sqrt())
    torch.testing.assert_close(taps.cpu(), ref_taps, rtol=1e-4,
                               atol=1e-4 * rms)
    out = TW.watterson_with(x, cfg, fade, awgn)
    ref = TW.watterson_with(x.cpu(), cfg, fade.cpu(), awgn.cpu())
    assert float((out.cpu() - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


# ---------------------------------------------------------------------------
# The rest of the PHY: NVIS coherent, DPSK, delay fit, MFSK, OTFS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride,offset", [(1, 0), (1, 96), (8, 96)])
def test_window_kernel_equals_plain_at_half_512(dev, stride, offset):
    """The 1,024-FFT plans' half = 512 (nvis_mode, high_throughput), at
    B = 9 and at an NVIS buffer's B = 512."""
    for B, seed in ((9, stride), (512, stride + 100)):
        a = _analytic_on(dev, B, 15080, seed=seed)
        G = (15080 - 2 * 512 - offset) // stride + 1
        _assert_windows_close(a, 512, stride, offset, G)
        _assert_windows_close(a, 512, stride, offset, min(G, 700))


@pytest.mark.parametrize("rate,sigma", [(CodeRate.R3_4, 0.5),
                                        (CodeRate.R5_6, 0.45)])
def test_kernel_equals_plain_at_high_rates(dev, rate, sigma):
    _assert_kernel_equals_plain(rate, _noisy_llr(rate, sigma, 513), dev)
    _assert_kernel_equals_plain(rate, _noisy_llr(rate, sigma, 513), dev,
                                trap_escape=True)


def _nvis_buffers(dev, mod, rate, snr_db, B, ncw=1, seed=6):
    from projectultra_tpu_torch.config import nvis_mode
    cfg = nvis_mode()
    g = torch.Generator(device=dev).manual_seed(seed)
    info = torch.randint(0, 2, (B, ncw * ldpc.get_code(rate).k),
                         generator=g, device=dev, dtype=torch.uint8)
    tx = TP.tx_cox_frame(cfg, mod, rate, info, lead=3000, tail=2000,
                         n_codewords=ncw)
    rx = TW.add_noise_active(TW.apply_cfo_hilbert(tx, 10.0), snr_db, g)
    return cfg, info, rx


@pytest.mark.parametrize("mod,rate,snr,ncw", [
    (Modulation.QAM32, CodeRate.R3_4, 30.0, 1),
    (Modulation.QAM256, CodeRate.R5_6, 42.0, 1),
    (Modulation.QAM256, CodeRate.R5_6, 42.0, 4)])
def test_nvis_step_on_the_card_equals_the_cpu(dev, mod, rate, snr, ncw):
    """decode_cox_batch on NVIS frames goes through both kernels (the
    windows at half = 512) and equals the CPU path lane for lane."""
    cfg, info, rx = _nvis_buffers(dev, mod, rate, snr, 16, ncw)
    sc0, ldpc0 = cuda_sc.launches, cuda_ldpc.launches
    out, ok, iters, det = TSC.decode_cox_batch(cfg, mod, rate, rx, ncw)
    assert cuda_sc.launches > sc0 and cuda_ldpc.launches > ldpc0
    cpu = TSC.decode_cox_batch(cfg, mod, rate, rx.cpu(), ncw)
    assert torch.equal(det["lts_start"].cpu(), cpu[3]["lts_start"])
    assert torch.equal(iters.cpu() < 50, cpu[2] < 50)
    both = ok.cpu() & cpu[1]
    assert torch.equal(out.cpu()[both], cpu[0][both])
    assert torch.equal(out[ok], info[ok])
    if ncw == 1:
        assert ok.all()


def test_kernel_equals_plain_on_nvis_llrs(dev):
    cfg, _, rx = _nvis_buffers(dev, Modulation.QAM256, CodeRate.R5_6, 42.0,
                               32)
    det = TSC.detect_preamble(cfg, rx)
    pipe = TP.pipeline_for(cfg, Modulation.QAM256, CodeRate.R5_6, 1, dev)
    llrs = pipe.deinterleave(TSC.demodulate_detected(
        cfg, Modulation.QAM256, rx, det)).cpu().numpy()
    _assert_kernel_equals_plain(CodeRate.R5_6, llrs, dev)


def test_dpsk_robust_step_on_the_card(dev):
    """decode_dpsk_batch at -11 dB (robust) through the LDPC kernel, the
    kernel equal to plain on its LLRs, and the card equal to the CPU."""
    from projectultra_tpu_torch.psk import dpsk as TD
    cfg = TD.robust()
    g = torch.Generator(device=dev).manual_seed(3)
    info = torch.randint(0, 2, (4, 162), generator=g, device=dev,
                         dtype=torch.uint8)
    cw = T.encode(ldpc.get_code(CodeRate.R1_4), info)
    pre = torch.from_numpy(TD.generate_preamble(cfg)).to(dev)
    tx = torch.cat([torch.zeros((4, 4800), device=dev), pre.expand(4, -1),
                    TD.modulate(cfg, cw), torch.zeros((4, 4000), device=dev)],
                   dim=-1)
    rx = TW.add_noise_active(tx, -11.0, g)
    before = cuda_ldpc.launches
    out, ok, _, det = TD.decode_dpsk_batch(cfg, CodeRate.R1_4, rx)
    assert cuda_ldpc.launches > before
    cpu = TD.decode_dpsk_batch(cfg, CodeRate.R1_4, rx.cpu())
    assert torch.equal(det["data_start"].cpu(), cpu[3]["data_start"])
    assert torch.equal(ok.cpu(), cpu[1])
    assert torch.equal(out[ok], info[ok])
    found, ds, cfo, ipo, prev = TD.find_preamble(cfg, rx)
    span = TC.frame_spans(rx, ds, 648 * 1536)
    llrs = TD.demodulate_soft(cfg, span, prev, cfo, ipo)[:, :648]
    _assert_kernel_equals_plain(CodeRate.R1_4, llrs.cpu().numpy(), dev)


def test_mfsk_and_otfs_steps_on_the_card(dev):
    """decode_mfsk_batch (medium, -4 dB) and decode_otfs_batch (20 dB)
    through the LDPC kernel, equal to the CPU path."""
    from projectultra_tpu_torch.otfs import otfs as TO
    from projectultra_tpu_torch.psk import fsk as TF
    g = torch.Generator(device=dev).manual_seed(4)
    code = ldpc.get_code(CodeRate.R1_4)
    info = torch.randint(0, 2, (8, code.k), generator=g, device=dev,
                         dtype=torch.uint8)
    cw = T.encode(code, info)
    cfg = TF.mfsk_medium()
    pre = torch.from_numpy(TF.mfsk_generate_preamble(cfg)).to(dev)
    rx = TW.add_noise_active(torch.cat([
        torch.zeros((8, 5000), device=dev), pre.expand(8, -1),
        TF.mfsk_modulate(cfg, cw), torch.zeros((8, 4000), device=dev)],
        dim=-1), -4.0, g)
    before = cuda_ldpc.launches
    out, ok, _, found, ds = TF.decode_mfsk_batch(cfg, CodeRate.R1_4, rx)
    assert cuda_ldpc.launches > before
    cpu = TF.decode_mfsk_batch(cfg, CodeRate.R1_4, rx.cpu())
    assert torch.equal(ds.cpu(), cpu[4]) and torch.equal(ok.cpu(), cpu[1])
    assert ok.all() and torch.equal(out, info)

    ocfg = TO.OTFSConfig()
    tx = TO.frame_tx(ocfg, Modulation.QPSK, cw)
    rx = TW.add_noise_active(torch.cat([
        torch.zeros((8, 4000), device=dev), tx,
        torch.zeros((8, 2000), device=dev)], dim=-1), 20.0, g)
    before = cuda_ldpc.launches
    out, ok, _, found, start = TO.decode_otfs_batch(ocfg, Modulation.QPSK,
                                                    CodeRate.R1_4, rx)
    assert cuda_ldpc.launches > before
    cpu = TO.decode_otfs_batch(ocfg, Modulation.QPSK, CodeRate.R1_4, rx.cpu())
    assert torch.equal(start.cpu(), cpu[4]) and torch.equal(ok.cpu(), cpu[1])
    # Frames whose fine timing lands past the CP fail, in JAX alike
    # (test_torch_otfs.py::test_late_fine_timing_lanes_match_jax).
    assert torch.equal(out[ok], info[ok])


def test_delayfit_on_the_card_equals_the_cpu(dev):
    """The delay-fit second pass on a Watterson good() high_throughput
    span: LLRs on the card within 2e-3 of the CPU."""
    from projectultra_tpu_torch.config import high_throughput
    from projectultra_tpu_torch.ofdm import delay_fit as TDF
    cfg, mod = high_throughput(), Modulation.QAM16
    g = torch.Generator(device=dev).manual_seed(5)
    info = torch.randint(0, 2, (8, 8 * ldpc.get_code(CodeRate.R2_3).k),
                         generator=g, device=dev, dtype=torch.uint8)
    tx = TP.tx_cox_frame(cfg, mod, CodeRate.R2_3, info, lead=7200,
                         tail=1152, n_codewords=8)
    rx = TW.add_noise_active(TW.watterson(tx, TW.good(), g), 20.0, g)
    det = TSC.detect_preamble(cfg, rx)
    plen = cfg.fft_size + cfg.cyclic_prefix
    S = TP.num_data_symbols(cfg, mod, 8)
    span = TC.frame_spans(rx, det["lts_start"] - 2 * plen,
                          5 * plen + S * cfg.symbol_duration)
    args = dict(n_lts=2, S=S, lead=2 * plen, tail=plen, front="real",
                n_bits=8 * 648)
    got = TDF.demodulate_span_delayfit(cfg, mod, span, det["cfo_hz"], 0.0,
                                       **args)
    want = TDF.demodulate_span_delayfit(cfg, mod, span.cpu(),
                                        det["cfo_hz"].cpu(), 0.0, **args)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# The streaming engine (slice 6)
# ---------------------------------------------------------------------------

REF_FILES = [("ref_cli_tx_ping.f32", None), ("ref_cli_tx_connect.f32", None),
             ("ref_cli_tx_disconnect.f32", None), ("ref_cli_tx_ofdm.f32",
                                                   "OFDM_COX"),
             ("ref_cli_tx_dpsk_mapped.f32", None)]


def _engine_stream(device, audio, mode):
    from projectultra_tpu_torch.modem.engine import ModemEngine
    from projectultra_tpu_torch.protocol.frame_v2 import WaveformMode
    e = ModemEngine(device=device)
    if mode is not None:
        e.set_waveform_mode(WaveformMode[mode])
    events, consumed = [], []
    e.on_frame = lambda fr: events.append(fr)
    e.on_ping = lambda snr: events.append(round(snr, 1))
    for i in range(0, len(audio), 960):
        e.feed_audio(audio[i:i + 960])
        e.poll()
        consumed.append(e._rx_consumed)
    return events, consumed


@pytest.mark.parametrize("name,mode", REF_FILES)
def test_engine_on_the_card_equals_the_cpu(dev, golden_dir, name, mode):
    """The reference CLI's audio streamed through ModemEngine in 960-sample
    chunks with a poll after each: the card's events (frame bytes, header,
    codeword flags, waveform exact; SNR within 0.05 dB, CFO within 1e-3 Hz)
    and consumed positions equal the CPU engine's, through both kernels."""
    audio = np.concatenate([np.fromfile(os.path.join(golden_dir, name),
                                        dtype=np.float32),
                            np.zeros(8000, np.float32)])
    before = (cuda_ldpc.launches, cuda_sc.launches)
    got, cons = _engine_stream(dev, audio, mode)
    assert cuda_ldpc.launches > before[0] and cuda_sc.launches > before[1]
    want, cons_c = _engine_stream(torch.device("cpu"), audio, mode)
    assert cons == cons_c and len(got) == len(want) == 1
    for a, b in zip(got, want):
        if isinstance(b, float):
            assert abs(a - b) <= 0.11
            continue
        assert (a.frame_bytes, a.header, a.cw_ok, a.waveform) == \
            (b.frame_bytes, b.header, b.cw_ok, b.waveform)
        assert abs(a.snr_db - b.snr_db) <= 0.05
        assert abs(a.cfo_hz - b.cfo_hz) <= 1e-3
        assert abs(a.wideband_snr_db - b.wideband_snr_db) <= 1e-3


def test_engine_without_a_device_runs_on_the_card(dev):
    from projectultra_tpu_torch.modem.engine import ModemEngine
    assert ModemEngine().device == dev


# ---------------------------------------------------------------------------
# The protocol slice: entry points, the LDPC stream helpers, ops/dsp and a
# two-station session on the card
# ---------------------------------------------------------------------------

def test_protocol_entry_points_take_the_card(dev):
    from projectultra_tpu_torch.modem.rx_pipeline import RxPipeline
    from projectultra_tpu_torch.protocol.engine import ProtocolEngine
    from projectultra_tpu_torch.protocol.frame_v2 import WaveformMode
    from projectultra_tpu_torch.waveform import factory
    assert ProtocolEngine().modem.device == dev
    assert RxPipeline()._engine.device == dev
    for mode in (WaveformMode.MC_DPSK, WaveformMode.DPSK,
                 WaveformMode.OFDM_CHIRP, WaveformMode.OFDM_COX,
                 WaveformMode.OTFS_EQ):
        assert factory.create(mode).device == dev


@pytest.mark.parametrize("rate", list(NAMES), ids=list(NAMES.values()))
def test_hard_stream_decode_on_the_card(dev, golden_dir, rate):
    """decode_hard_stream of the reference's golden coded bytes goes
    through the LDPC kernel and gives the golden decoded bytes and
    iteration count, as on the CPU."""
    fields = {}
    with open(os.path.join(golden_dir, f"golden_ldpc_{NAMES[rate]}.txt")) as f:
        for line in f:
            toks = line.split()
            fields.update(zip(toks[::2], toks[1::2]))
    code = ldpc.get_code(rate)
    before = cuda_ldpc.launches
    dec, ok, iters = T.decode_hard_stream(code, bytes.fromhex(fields["coded"]))
    assert cuda_ldpc.launches > before
    assert ok and dec.hex() == fields["decoded"]
    assert int(iters[-1]) == int(fields["iters"])
    cpu = T.decode_hard_stream(code, bytes.fromhex(fields["coded2"]),
                               device=torch.device("cpu"))
    card = T.decode_hard_stream(code, bytes.fromhex(fields["coded2"]))
    assert card[:2] == cpu[:2]
    np.testing.assert_array_equal(card[2], cpu[2])


def test_dsp_on_the_card_equals_the_cpu(dev):
    from projectultra_tpu_torch.ops import dsp as D
    from projectultra_tpu_torch.utils import observability as O
    x = np.random.default_rng(11).standard_normal((4, 4096)) \
        .astype(np.float32) * np.float32(0.3)
    xc, xg = torch.from_numpy(x), torch.from_numpy(x).to(dev)
    bq = D.biquad_highpass(300.0, 0.707, 48000.0)
    h = D.fir_lowpass(101, 2000.0, 48000.0)
    for name, fn in (("biquad", lambda s: D.biquad_apply(s, bq)),
                     ("agc", D.agc), ("fir", lambda s: D.fir_apply(s, h)),
                     ("resample", lambda s: D.resample(s, 48000, 8000))):
        got = fn(xg)
        assert got.device == dev, name
        np.testing.assert_allclose(got.cpu().numpy(), fn(xc).numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(O.waterfall(xg)[0], O.waterfall(xc)[0],
                               rtol=1e-5, atol=1e-3)


def test_two_station_session_on_the_card(dev):
    """Two ProtocolEngine stations on the card: connect and one message
    each way, through both kernels."""
    from projectultra_tpu_torch.protocol.engine import ProtocolEngine
    a, b = ProtocolEngine(device=dev), ProtocolEngine(device=dev)
    a.connection.set_local_callsign("W1AW")
    b.connection.set_local_callsign("VE3ABC")
    b.connection.set_measured_snr(15.0)
    a.on_tx_audio = lambda x: b.feed_audio(np.pad(x, (0, 4000)))
    b.on_tx_audio = lambda x: a.feed_audio(np.pad(x, (0, 4000)))
    got_a, got_b = [], []
    a.connection.on_message_received = got_a.append
    b.connection.on_message_received = got_b.append
    before = (cuda_ldpc.launches, cuda_sc.launches)
    assert a.connect("VE3ABC")
    assert a.connection.is_connected and b.connection.is_connected
    assert a.send_message("to b") and b.send_message("to a")
    assert got_b == ["to b"] and got_a == ["to a"]
    assert cuda_ldpc.launches > before[0] and cuda_sc.launches > before[1]


# ---------------------------------------------------------------------------
# DPSK's differential-score kernel
# ---------------------------------------------------------------------------

DPSK_N_SYM = 39
DPSK_ATOL = 2e-6
# (L, B, O): the CPU tests' shapes, the DPSK path's (medium's and robust's
# buffers of chip_smoke.py), the engine's search view at medium (B = 1,
# 341 symbols of 768) and a B = 1 row of 4,096 symbols of 64.
DPSK_SHAPES = [(64, 1, 100), (64, 3, 1000), (384, 3, 5000), (384, 1, 127),
               (768, 3, 2 * 768 + 5), (768, 1, 121_000), (64, 3, 12_797),
               (768, 256, 119_808), (1536, 64, 239_616), (768, 1, 261_888),
               (64, 1, 262_144)]


def _dpsk_corr(dev, L, B, O, seed=0):
    """[B, O + 38 L + 7] complex64 correlations made with numpy: normals,
    the preamble's symbols at O // 3, faint samples from O // 2 and silence
    from 2 O // 3 (offsets there score 0 by the energy threshold)."""
    rng = np.random.default_rng(seed)
    n = O + (DPSK_N_SYM - 1) * L + 7
    c = (rng.standard_normal((B, n), np.float32)
         + 1j * rng.standard_normal((B, n), np.float32)).astype(np.complex64)
    c[:, O // 2:] *= np.float32(1e-3)
    c[:, 2 * O // 3:] = 0
    phases = np.cumsum(np.where(np.concatenate([[1.0], TD.EXPECTED_SIGNS])
                                < 0, np.pi, 0.0)) + 0.3 * np.arange(DPSK_N_SYM)
    c[:, O // 3 + np.arange(DPSK_N_SYM) * L] = 2.0 * np.exp(1j * phases)
    return torch.from_numpy(c).to(dev)


def _dpsk_scores(corr, L, O):
    """(kernel, plain) scores of one correlation, one launch counted."""
    before = cuda_dpsk.launches
    got = TDS.dpsk_score(corr, L, DPSK_N_SYM, O, TD.EXPECTED_SIGNS,
                         TD.MIN_SYMBOL_ENERGY)
    assert cuda_dpsk.launches == before + 1
    want = TDS.dpsk_score_plain(corr, L, DPSK_N_SYM, O, TD.EXPECTED_SIGNS,
                                TD.MIN_SYMBOL_ENERGY)
    torch.cuda.synchronize()
    return got, want


def _assert_scores_close(got, want):
    """NaN, +inf, zeros exactly where the plain version has them; within
    DPSK_ATOL elsewhere."""
    assert got.shape == want.shape and got.dtype == torch.float32
    for test in (torch.isnan, torch.isposinf, lambda x: x == 0):
        assert torch.equal(test(got), test(want))
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) \
        else 0.0
    assert err <= DPSK_ATOL, err
    return err


@pytest.mark.parametrize("L,B,O", DPSK_SHAPES)
def test_dpsk_score_kernel_equals_plain(dev, L, B, O):
    corr = _dpsk_corr(dev, L, B, O, seed=L + B)
    got, want = _dpsk_scores(corr, L, O)
    err = _assert_scores_close(got, want)
    assert bool((want == 0).any()) and bool((want > 0.99).any())
    print(f"dpsk_score L={L} B={B} O={O}: max |kernel - plain| = {err!r}")


def test_dpsk_score_kernel_reads_a_strided_view(dev):
    """A column slice of wider rows: row stride above n_corr, an odd
    storage offset."""
    L, B, O = 384, 3, 5000
    corr = _dpsk_corr(dev, L, B, O, seed=4)
    wide = torch.zeros((B, corr.shape[1] + 13), dtype=torch.complex64,
                       device=dev)
    wide[:, 5:5 + corr.shape[1]] = corr
    view = wide[:, 5:5 + corr.shape[1]]
    assert view.stride(0) > view.shape[1]
    got, want = _dpsk_scores(view, L, O)
    _assert_scores_close(got, want)
    torch.testing.assert_close(got, _dpsk_scores(corr, L, O)[0], rtol=0,
                               atol=0)


# (L, B, O, row, sample), as tests/test_torch_dpsk_score.py's, and at the
# DPSK ``medium`` path's batch.
DPSK_NONFINITE = {"batch": (384, 3, 16_000, 1, 15_000),
                  "engine": (768, 1, 40_000, 0, 35_000),
                  "medium": (768, 256, 119_808, 3, 50_000)}


@pytest.mark.parametrize("kind", ["nan", "inf"])
@pytest.mark.parametrize("case", sorted(DPSK_NONFINITE))
def test_dpsk_score_kernel_at_a_nonfinite_correlation(dev, case, kind):
    """One NaN (zeros) or +inf (NaNs) correlation: the kernel's zeros and
    NaNs where the plain version's are, the 39 offsets whose symbols hold
    the sample."""
    L, B, O, row, m = DPSK_NONFINITE[case]
    rng = np.random.default_rng(11)
    n = O + (DPSK_N_SYM - 1) * L + 7
    c = (rng.standard_normal((B, n)) + 1j * rng.standard_normal((B, n))) \
        .astype(np.complex64)
    c[row, m] = complex(float(kind), 0.0)
    got, want = _dpsk_scores(torch.from_numpy(c).to(dev), L, O)
    _assert_scores_close(got, want)
    hit = torch.isnan(want) if kind == "inf" else want == 0
    assert int(hit.sum()) == DPSK_N_SYM


def test_dpsk_score_kernel_plan(dev):
    plan = cuda_dpsk.launch_plan(256, 148_992 + 7, 768, 119_808, dev)
    assert plan["tile"] == 156 and plan["tiles"] == 1
    assert plan["blocks"] == 256 * 24
    assert plan["shared_bytes"] == (160 + 38) * 32 * 12
    assert plan["blocks_per_sm"] >= 2
    # B = 1, 4,096 symbol indices of 64 samples: tiles of 32 on two
    # residue groups fill the card
    plan = cuda_dpsk.launch_plan(1, 262_144 + 38 * 64 + 7, 64, 262_144, dev)
    assert plan["tile"] == 32 and plan["blocks"] == 256


def test_dpsk_score_kernel_wrapper_checks_its_inputs(dev):
    corr = _dpsk_corr(dev, 64, 2, 300)
    args = (64, DPSK_N_SYM, 300, TD.EXPECTED_SIGNS, TD.MIN_SYMBOL_ENERGY)
    for bad in (corr.to(torch.complex128), corr[0], corr.T):
        with pytest.raises(ValueError):
            cuda_dpsk.dpsk_score_cuda(bad, *args)
    with pytest.raises(ValueError):
        cuda_dpsk.dpsk_score_cuda(corr, 64, 14, 300, TD.EXPECTED_SIGNS[:13],
                                  TD.MIN_SYMBOL_ENERGY)
    with pytest.raises(ValueError):
        cuda_dpsk.dpsk_score_cuda(corr, 64, DPSK_N_SYM, corr.shape[1],
                                  TD.EXPECTED_SIGNS, TD.MIN_SYMBOL_ENERGY)


def _dpsk_buffers(dev, preset, snr_db, B, seed=3):
    """run_point_dpsk's frames on the card: lead 4,800, preamble, one R1/4
    codeword, tail 4,000, AWGN at snr_db."""
    cfg = getattr(TD, preset)()
    g = torch.Generator(device=dev).manual_seed(seed)
    info = torch.randint(0, 2, (B, 162), generator=g, device=dev,
                         dtype=torch.uint8)
    tx = TD.tx_dpsk_frame(cfg, CodeRate.R1_4, info)
    return cfg, info, TW.add_noise_active(tx, snr_db, g)


@pytest.mark.parametrize("preset,snr,B", [("medium", 0.0, 8),
                                          ("robust", -11.0, 4),
                                          ("fast", 0.0, 8),
                                          ("max_speed", 6.0, 8)])
def test_find_preamble_through_the_dpsk_kernel(dev, monkeypatch, preset, snr,
                                               B):
    """One kernel launch a search; found and data_start equal to the CPU
    port; every output bit-equal to the same search on the card through
    the plain score (the rest of find_preamble is the same torch code)."""
    cfg, _, rx = _dpsk_buffers(dev, preset, snr, B)
    vl = torch.tensor([rx.shape[1]] * (B - 1) + [4800 + cfg.preamble_samples
                                                 // 2], device=dev)
    for valid in (None, vl):
        before = cuda_dpsk.launches
        got = TD.find_preamble(cfg, rx, valid_len=valid)
        assert cuda_dpsk.launches == before + 1
        cpu = TD.find_preamble(cfg, rx.cpu(), valid_len=None if valid is None
                               else valid.cpu())
        assert torch.equal(got[0].cpu(), cpu[0])
        assert torch.equal(got[1].cpu(), cpu[1])
        with monkeypatch.context() as m:
            m.setattr(TD, "dpsk_score", TDS.dpsk_score_plain)
            ref = TD.find_preamble(cfg, rx, valid_len=valid)
        assert cuda_dpsk.launches == before + 1
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert bool(got[0][:B - 1].all())


def test_decode_dpsk_batch_goes_through_both_kernels(dev):
    cfg, info, rx = _dpsk_buffers(dev, "medium", 0.0, 16)
    before = (cuda_dpsk.launches, cuda_ldpc.launches)
    out, ok, _, _ = TD.decode_dpsk_batch(cfg, CodeRate.R1_4, rx)
    assert cuda_dpsk.launches == before[0] + 1
    assert cuda_ldpc.launches > before[1]
    assert bool(ok.all()) and torch.equal(out, info)


def test_dpsk_step_never_synchronises(dev):
    """tx_dpsk_frame -> add_noise_with -> decode_dpsk_batch, the DPSK
    cell's step, enqueue without a host-device synchronisation once the
    per-device tables exist: one score, one LDPC and one AWGN launch a
    step, and every frame decoded."""
    cfg, B = TD.medium(), 16
    g = torch.Generator(device=dev).manual_seed(41)
    info = torch.randint(0, 2, (B, 162), generator=g, device=dev,
                         dtype=torch.float32)
    noise = torch.randn((B, TD.frame_samples(cfg, CodeRate.R1_4)),
                        generator=g, device=dev)

    def step():
        tx = TD.tx_dpsk_frame(cfg, CodeRate.R1_4, info)
        rx = TW.add_noise_with(tx, 0.0, noise)
        return TD.decode_dpsk_batch(cfg, CodeRate.R1_4, rx)

    step()
    torch.cuda.synchronize()
    before = (cuda_dpsk.launches, cuda_ldpc.launches, cuda_awgn.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, ok, _, _ = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (cuda_dpsk.launches, cuda_ldpc.launches, cuda_awgn.launches) \
        == tuple(n + 1 for n in before)
    assert bool(ok.all()) and torch.equal(out, info.to(torch.uint8))


def test_find_preamble_never_synchronises(dev):
    """The FFT matched filter, the score kernel, both rules, the CFO and
    phase estimates and the timing refinement enqueue without a
    host-device synchronisation once the per-device tables exist."""
    cfg, _, rx = _dpsk_buffers(dev, "medium", 0.0, 8)
    vl = torch.full((8,), rx.shape[1], device=dev)
    TD.find_preamble(cfg, rx, valid_len=vl)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        found = TD.find_preamble(cfg, rx, valid_len=vl)[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(found.all())


def test_engine_dpsk_search_goes_through_the_kernel(dev):
    """A DPSK data frame streamed through ModemEngine in the DPSK mode:
    the card's events and consumed positions equal the CPU engine's, and
    its searches launch the score kernel."""
    from projectultra_tpu_torch.modem.engine import ModemEngine
    from projectultra_tpu_torch.protocol import frame_v2 as F

    def engine(device):
        e = ModemEngine(device=device)
        e.set_waveform_mode(F.WaveformMode.DPSK)
        e.connect_waveform = F.WaveformMode.DPSK
        return e

    def stream(device, audio):
        e, events, consumed = engine(device), [], []
        e.on_frame = events.append
        for i in range(0, len(audio), 960):
            e.feed_audio(audio[i:i + 960])
            e.poll()
            consumed.append(e._rx_consumed)
        return events, consumed

    frame = F.DataFrame.make_data("AA1AA", "BB2BB", 1, "dpsk card").serialize()
    audio = np.concatenate([np.zeros(3000, np.float32),
                            engine("cpu").transmit(frame),
                            np.zeros(8000, np.float32)])
    before = cuda_dpsk.launches
    got, cons = stream(dev, audio)
    assert cuda_dpsk.launches > before
    want, cons_c = stream(torch.device("cpu"), audio)
    assert cons == cons_c and len(got) == len(want) == 1
    assert got[0].frame_bytes == want[0].frame_bytes == frame
    assert got[0].waveform == F.WaveformMode.DPSK


TRACED_ENTRIES = {"presynced": ("ofdm_chirp-presynced-17db", 256, 4),
                  "acquired": ("mcdpsk_l10-chirp-acquire-5db-b2048", 64, 7),
                  "dpsk": ("dpsk_medium-acquire-0db-b256", 16, 6)}


@pytest.mark.parametrize("path", sorted(TRACED_ENTRIES))
def test_traced_step_on_the_card(dev, path):
    """One step of each benchmark entry kind at a small batch with the
    program's spans on: every span records its CUDA events without a
    synchronisation, and no child's device ms exceed its parent's."""
    import dataclasses
    from benchmark import harness, traffic as BT
    from projectultra_tpu_torch.utils import metrics
    name, batch, n_spans = TRACED_ENTRIES[path]
    cell = harness.load_cell(name)
    mix = dataclasses.replace(cell.traffic, batch=batch)
    entry = cell.entry.Entry(cell.config, mix, dev)
    info, noise = BT.inputs(mix, entry.k, entry.T, 2**31 + 19, 0, dev)
    with entry.precision():
        entry.step(info, noise, harness.no_mark)
        torch.cuda.synchronize()
        with metrics.tracing() as rec:
            rec.next_batch()
            torch.cuda.set_sync_debug_mode("error")
            try:
                entry.step(info, noise, harness.no_mark)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            spans = rec.drain()
    torch.cuda.synchronize()
    assert len(spans) == n_spans
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.device_ms() > 0, s.name
        if s.parent is not None:
            assert s.device_ms() <= by_id[s.parent].device_ms(), s.name



# ---------------------------------------------------------------------------
# The pilot-tracking scan as one CUDA graph replay
# ---------------------------------------------------------------------------

#: (config, data modulation, rate) of each branch of the scan: DQPSK on
#: the default pilot plan, QAM64's whole-frame re-demap (``hi_pilots``),
#: and the decision-directed adaptive equalizer.
SCAN_CASES = {
    "dqpsk": (COX_CFG, Modulation.DQPSK, CodeRate.R1_2),
    "qam64_hi_pilots": (COX_CFG, Modulation.QAM64, CodeRate.R2_3),
    "adaptive_eq": (ModemConfig(adaptive_eq_enabled=True), Modulation.QPSK,
                    CodeRate.R1_2),
}


def _scan_inputs(dev, case, B, seed):
    """The scan's arguments on Cox frames of ``case`` at 20 dB, cut at
    their first LTS as ``demodulate_span`` cuts them: (config, mod, state
    after the LTS estimate, data [B, S, L], t0, front, n_bits)."""
    from projectultra_tpu_torch.ofdm import demodulator as TDM
    cfg, mod, rate = SCAN_CASES[case]
    g = torch.Generator(device=dev).manual_seed(seed)
    info = torch.randint(0, 2, (B, ldpc.get_code(rate).k), generator=g,
                         device=dev, dtype=torch.uint8)
    plen = cfg.fft_size + cfg.cyclic_prefix
    lead = 2 * plen
    tx = TP.tx_cox_frame(cfg, mod, rate, info, lead=lead, tail=2 * plen)
    rx = TW.add_noise_active(tx, 20.0, g)
    S = TP.num_data_symbols(cfg, mod)
    first = lead + 5 * plen
    span = rx[:, first - lead:first + 2 * plen + S * cfg.symbol_duration
              + lead]
    lts, data = TDM._span_segments(cfg, mod, span, 2, S, lead, lead,
                                   "analytic")
    ic, taper = TDM._scan_windows(mod, "analytic")
    state = TDM.init_state(cfg, B, 0.3, 0.0, dev)
    state = TDM.estimate_channel_from_lts(cfg, state, lts, t0_base=plen,
                                          t0_stride=0, image_cancel=ic,
                                          taper=taper)
    return cfg, mod, state, data, 2 * plen, "analytic", ldpc.BLOCK_LENGTH


def _assert_scan_equal(got, want):
    (g_state, g_llrs), (w_state, w_llrs) = got, want
    assert torch.equal(g_llrs, w_llrs)
    for field, a, b in zip(w_state._fields, g_state, w_state):
        assert a.dtype == b.dtype and torch.equal(a, b), field


def _fresh_scan_caches():
    from projectultra_tpu_torch.ofdm import demodulator as TDM
    TDM._scan_graphs.clear()
    return TDM


@pytest.mark.parametrize("B", [1, 7, 2048])
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_graph_replay_is_the_eager_loop(dev, case, B):
    """A shape's first call runs the eager loop; its second captures the
    graph and replays it, its third replays it: each equal to the eager
    loop on the same card tensors, the LLRs and every field of the final
    state bit for bit."""
    TDM = _fresh_scan_caches()
    args = _scan_inputs(dev, case, B, seed=B + 3)
    want = TDM._scan_eager(*args)
    captures, replays = TDM.scan_captures, TDM.scan_replays
    _assert_scan_equal(TDM._scan_data_symbols(*args), want)
    assert (TDM.scan_captures, TDM.scan_replays) == (captures, replays)
    for n in (1, 2):
        _assert_scan_equal(TDM._scan_data_symbols(*args), want)
        assert TDM.scan_replays == replays + n
    assert TDM.scan_captures == captures + 1


def test_scan_replays_in_a_row_keep_their_own_results(dev):
    """Two replays of one graph on different inputs: each equals its own
    eager result, and the second leaves the first's outputs as they
    were."""
    TDM = _fresh_scan_caches()
    a = _scan_inputs(dev, "dqpsk", 64, seed=1)
    b = _scan_inputs(dev, "dqpsk", 64, seed=2)
    want_a, want_b = TDM._scan_eager(*a), TDM._scan_eager(*b)
    TDM._scan_data_symbols(*a)
    replays = TDM.scan_replays
    got_a = TDM._scan_data_symbols(*a)
    got_b = TDM._scan_data_symbols(*b)
    assert TDM.scan_replays == replays + 2
    _assert_scan_equal(got_a, want_a)
    _assert_scan_equal(got_b, want_b)
    assert not torch.equal(got_a[1], got_b[1])


def test_scan_graph_cache_is_bounded(dev):
    """More shapes than the cache holds, each called twice: it keeps the
    SCAN_GRAPHS most recently used graphs; a shape it dropped is captured
    again at its next call."""
    TDM = _fresh_scan_caches()
    n = TDM.SCAN_GRAPHS + 3
    inputs = [_scan_inputs(dev, "dqpsk", B, seed=B) for B in range(1, n + 1)]
    captures = TDM.scan_captures
    for args in inputs:
        TDM._scan_data_symbols(*args)
        TDM._scan_data_symbols(*args)
    assert TDM.scan_captures == captures + n
    assert len(TDM._scan_graphs) == TDM.SCAN_GRAPHS
    assert sorted(key[6] for key in TDM._scan_graphs) == list(
        range(4, n + 1))
    TDM._scan_data_symbols(*inputs[-1])
    assert TDM.scan_captures == captures + n
    _assert_scan_equal(TDM._scan_data_symbols(*inputs[0]),
                       TDM._scan_eager(*inputs[0]))
    assert TDM.scan_captures == captures + n + 1
    assert len(TDM._scan_graphs) == TDM.SCAN_GRAPHS


def test_no_scan_capture_in_a_benchmark_window(dev):
    """The Cox cell at a small batch as the benchmark runs it: the warm-up
    captures the scan and the TX, the window only replays them (each
    replay of the scan runs the tracking kernel once a symbol, and counts
    it), and the run is correct."""
    import ast
    import dataclasses
    import time
    from benchmark import harness
    cell = harness.load_cell("ofdm_cox-acquire-17db-b2048")
    cell.traffic = dataclasses.replace(cell.traffic, batch=128,
                                       reference_rows=64, compare_span=5)
    logs = []
    line = harness.run(cell, 2**31 + 23, 1.0, False, dev, time.perf_counter(),
                       logs.append)
    window = next(m for m in logs if m.startswith("window:"))
    launches = ast.literal_eval(window.split("kernel launches ", 1)[1])
    steps = int(window.split()[1])
    S = TP.num_data_symbols(COX_CFG, Modulation.DQPSK)
    assert launches["scan_captures"] == launches["tx_captures"] == 0
    assert launches["scan_replays"] == launches["tx_replays"] == steps
    assert launches["sc_windows"] == steps
    assert launches["pilot_track"] == steps * S
    assert line["correct"] is True


def test_cox_entry_spans_on_the_card(dev):
    """One step of the Cox entry at a small batch with the program's spans
    on, after the scan's first call and its capture: every span records
    its CUDA events, no child's device ms exceed its parent's, and the
    step (TX, channel, receive chain) never synchronises."""
    import dataclasses
    from benchmark import harness, traffic as BT
    from projectultra_tpu_torch.utils import metrics
    cell = harness.load_cell("ofdm_cox-acquire-17db-b2048")
    mix = dataclasses.replace(cell.traffic, batch=64)
    entry = cell.entry.Entry(cell.config, mix, dev)
    info, noise = BT.inputs(mix, entry.k, entry.T, 2**31 + 19, 0, dev)
    with entry.precision():
        for _ in range(2):
            out = entry.step(info, noise, harness.no_mark)
        torch.cuda.synchronize()
        with metrics.tracing() as rec:
            rec.next_batch()
            torch.cuda.set_sync_debug_mode("error")
            try:
                again = entry.step(info, noise, harness.no_mark)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            spans = rec.drain()
    torch.cuda.synchronize()
    assert torch.equal(again["bits"], out["bits"])
    assert torch.equal(again["tx"], out["tx"])
    assert [s.name for s in spans] == ["cox.tx", "noise.awgn", "cox.rx",
                                       "cox.detect", "cox.lts", "ofdm.scan",
                                       "ldpc.decode"]
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.device_ms() > 0, s.name
        if s.parent is not None:
            assert s.device_ms() <= by_id[s.parent].device_ms(), s.name


def test_scan_replays_count_the_tracking_kernel(dev):
    """``cuda_track.launches`` counts the kernel's runs: S at the eager
    call, none at the capture (its warm-up runs S), S at each replay."""
    from projectultra_tpu_torch.ops import cuda_track
    TDM = _fresh_scan_caches()
    args = _scan_inputs(dev, "dqpsk", 16, seed=4)
    S = args[3].shape[1]
    counts = []
    for _ in range(4):
        before = cuda_track.launches
        TDM._scan_data_symbols(*args)
        counts.append(cuda_track.launches - before)
    assert counts == [S, 2 * S, S, S]


@pytest.mark.parametrize("B", [1, 7, 2048])
def test_cox_tx_graph_replay_is_the_eager_tx(dev, B):
    """``tx_cox_frame``: a shape's first call runs eagerly, its second
    captures the encode, interleave and modulation and replays them, its
    third replays them: every frame equal to the eager one bit for bit."""
    TP._tx_graphs.clear()
    g = torch.Generator(device=dev).manual_seed(B + 29)
    info = torch.randint(0, 2, (B, ldpc.get_code(CodeRate.R1_2).k),
                         generator=g, device=dev).to(torch.float32)

    def tx():
        return TP.tx_cox_frame(COX_CFG, Modulation.DQPSK, CodeRate.R1_2,
                               info, lead=1504, tail=1024)

    captures, replays = TP.tx_captures, TP.tx_replays
    want = tx()
    assert (TP.tx_captures, TP.tx_replays) == (captures, replays)
    for n in (1, 2):
        assert torch.equal(tx(), want)
        assert TP.tx_replays == replays + n
    assert TP.tx_captures == captures + 1
    assert want.shape == (B, 18856)


def test_cox_tx_replays_in_a_row_keep_their_own_frames(dev):
    """Two replays of the TX graph on different bits: each frame equals
    its own eager one, and the second leaves the first as it was."""
    TP._tx_graphs.clear()
    g = torch.Generator(device=dev).manual_seed(31)
    k = ldpc.get_code(CodeRate.R1_2).k
    a, b = (torch.randint(0, 2, (64, k), generator=g, device=dev)
            .to(torch.float32) for _ in range(2))

    def tx(info):
        return TP.tx_cox_frame(COX_CFG, Modulation.DQPSK, CodeRate.R1_2,
                               info, lead=1504, tail=1024)

    want_a, want_b = tx(a), tx(b)
    replays = TP.tx_replays
    got_a, got_b = tx(a), tx(b)
    assert TP.tx_replays == replays + 2
    assert torch.equal(got_a, want_a) and torch.equal(got_b, want_b)
    assert not torch.equal(got_a, got_b)


# ---------------------------------------------------------------------------
# The pilot-tracking kernel (csrc/pilot_track.cu)
# ---------------------------------------------------------------------------

#: The kernel against the scan's PyTorch step on the same card tensors:
#: LLRs (which lie in [-10, 10]) and the tracked state.  The kernel sums
#: over carriers in another order than PyTorch's reductions, and the
#: difference is carried by the state from symbol to symbol.
TRACK_LLR_ATOL = 2e-3
TRACK_RTOL, TRACK_ATOL = 1e-3, 1e-4


@pytest.mark.parametrize("B", [1, 7, 2048])
def test_pilot_track_kernel_against_the_plain_step(dev, B, monkeypatch):
    """The DQPSK scan through the kernel (one launch a symbol) against the
    same scan through PyTorch's operations on the same card tensors: the
    LLRs within TRACK_LLR_ATOL and of the same sign wherever the plain
    LLR's magnitude passes it, and every tracked state field close."""
    from projectultra_tpu_torch.ofdm import demodulator as TDM
    from projectultra_tpu_torch.ops import cuda_track
    args = _scan_inputs(dev, "dqpsk", B, seed=B + 11)
    S = args[3].shape[1]
    before = cuda_track.launches
    state, llrs = TDM._scan_eager(*args)
    assert cuda_track.launches == before + S
    monkeypatch.setattr(TDM, "_fused_tracking", lambda *_a: False)
    plain_state, plain = TDM._scan_eager(*args)
    assert cuda_track.launches == before + S
    assert float((llrs - plain).abs().max()) <= TRACK_LLR_ATOL
    sure = plain.abs() > TRACK_LLR_ATOL
    assert torch.equal(llrs[sure] > 0, plain[sure] > 0)
    for field in cuda_track.FIELDS:
        a, b = getattr(state, field), getattr(plain_state, field)
        assert a.dtype == b.dtype, field
        if a.dtype in (torch.bool, torch.int32):
            assert torch.equal(a, b), field
        else:
            assert torch.allclose(a, b, rtol=TRACK_RTOL, atol=TRACK_ATOL), \
                field


def test_pilot_track_kernel_on_the_cox_step(dev, monkeypatch):
    """The Cox receiver at the cell's shape through the kernel and through
    the plain step: the same bits, ok flags and iterations on every
    lane."""
    from projectultra_tpu_torch.ofdm import demodulator as TDM
    _, rx = _cox_buffers(dev, 2048, seed=13)
    out = TSC.decode_cox_batch(COX_CFG, Modulation.DQPSK, CodeRate.R1_2, rx)
    monkeypatch.setattr(TDM, "_fused_tracking", lambda *_a: False)
    TDM._scan_graphs.clear()
    plain = TSC.decode_cox_batch(COX_CFG, Modulation.DQPSK, CodeRate.R1_2,
                                 rx)
    for a, b in zip(out[:3], plain[:3]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The LTS timing kernel (csrc/lts_timing.cu)
# ---------------------------------------------------------------------------

#: lts_corr (a normalised correlation in [0, 1]) through the kernel against
#: the plain FFT matched filter: the kernel sums the window directly, the
#: plain version through float32 FFTs and cumulative sums.
LTS_CORR_ATOL = 1e-5


def _plain_lts(monkeypatch):
    """Route ``detect_preamble``'s LTS timing through the plain version
    (the kernel's oracle) on the card."""
    monkeypatch.setattr(TSC, "lts_timing",
                        lambda c, s, X, so: TSC.lts_timing_plain(c, s, X, so))


def _assert_same_timing(got, want):
    """(lts_start, data_start, lts_corr) of the kernel against the plain
    version's: positions equal, correlations within LTS_CORR_ATOL and NaN
    exactly where the plain version has NaN."""
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype == torch.int32
        assert torch.equal(a, b)
    a, b = got[2], want[2]
    assert a.dtype == b.dtype == torch.float32
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    keep = ~torch.isnan(b)
    assert float((a[keep] - b[keep]).abs().max()) <= LTS_CORR_ATOL


def _assert_same_detection(det, ref):
    assert det.keys() == ref.keys()
    for key in ref:
        if ref[key].dtype in (torch.bool, torch.int32):
            assert torch.equal(det[key], ref[key]), key
        elif key.endswith("lts_corr"):
            assert torch.equal(torch.isnan(det[key]), torch.isnan(ref[key]))
            keep = ~torch.isnan(ref[key])
            assert float((det[key][keep] - ref[key][keep]).abs().max()) \
                <= LTS_CORR_ATOL, key
        else:
            torch.testing.assert_close(det[key], ref[key], rtol=0, atol=0,
                                       equal_nan=True, msg=key)


def _engine_view(dev):
    """The engine's Cox search view: one row of ACQ_VIEW_CAP = 262,144
    samples holding the cell's frames end to end, zeros after."""
    _, rx = _cox_buffers(dev, 13, seed=21)
    row = torch.zeros((1, 262144), device=dev)
    row[0, :rx.numel()] = rx.reshape(-1)
    return row


def _lts_case(dev, case):
    """(config, samples, with_deep) of a named case."""
    if case == "cell":
        return COX_CFG, _cox_buffers(dev, 2048, seed=23)[1], False
    if case == "engine":
        return COX_CFG, _engine_view(dev), True
    if case == "nvis":
        cfg, _, rx = _nvis_buffers(dev, Modulation.QAM32, CodeRate.R3_4,
                                   30.0, 64)
        return cfg, rx, True
    _, rx = _cox_buffers(dev, 16, seed=24)
    rx = rx.clone()
    rx[3, 5000], rx[7, 9000], rx[11, 100] = (float("nan"), float("inf"),
                                             float("-inf"))
    rx[13] = 0.0
    return COX_CFG, rx, True


@pytest.mark.parametrize("case", ["cell", "engine", "nvis", "nonfinite"])
def test_lts_kernel_detection_equals_plain(dev, monkeypatch, case):
    """detect_preamble through the kernel against detect_preamble with the
    plain LTS timing on the same card tensors: every output equal but
    lts_corr, within LTS_CORR_ATOL (NaN where the plain has NaN); one
    launch a gate set."""
    cfg, rx, deep = _lts_case(dev, case)
    before = cuda_lts.launches
    det = TSC.detect_preamble(cfg, rx, with_deep=deep)
    assert cuda_lts.launches == before + (2 if deep else 1)
    _plain_lts(monkeypatch)
    ref = TSC.detect_preamble(cfg, rx, with_deep=deep)
    assert cuda_lts.launches == before + (2 if deep else 1)
    _assert_same_detection(det, ref)
    if case in ("cell", "nvis"):
        assert det["found"].all()
    if case == "nonfinite":
        assert not det["found"][[3, 7, 11, 13]].any()
        assert torch.isnan(det["lts_corr"][[3, 7, 11]]).all()


def test_lts_kernel_at_clipped_and_empty_windows(dev):
    """lts_timing_cuda at given sync_offs: windows clipped at the buffer's
    start (negative offsets) and end, windows past the end (empty: position
    0), a lane of zeros and one with a NaN sample, against the plain
    version at the same offsets."""
    _, rx = _cox_buffers(dev, 12, seed=25)
    rx = rx.clone()
    rx[9] = 0.0
    rx[10, 7000] = float("nan")
    T = rx.shape[1]
    plen = COX_CFG.fft_size + COX_CFG.cyclic_prefix
    offs = torch.tensor([0, -4 * plen, -4 * plen - 100, -10 ** 9,
                         T - 5 * plen, T - 4 * plen, T, 10 ** 12, 1504,
                         3000, 1504, 1504], device=dev)
    X = torch.fft.fft(rx.to(torch.complex64), n=TSC._n_fft(T), dim=-1)
    got = cuda_lts.lts_timing_cuda(COX_CFG, rx, offs, X[:, 0])
    want = TSC.lts_timing_plain(COX_CFG, rx, X, [offs])[0]
    _assert_same_timing(got, want)
    assert int(got[0][7]) == 0 and int(got[0][6]) == 0


def test_lts_kernel_reads_views(dev):
    """A row-strided view of wider buffers and a one-row view: the same
    timing as the contiguous copy."""
    _, rx = _cox_buffers(dev, 8, seed=26)
    wide = torch.zeros((8, rx.shape[1] + 37), device=dev)
    wide[:, 5:5 + rx.shape[1]] = rx
    view = wide[:, 5:5 + rx.shape[1]]
    T = rx.shape[1]
    X = torch.fft.fft(rx.to(torch.complex64), n=TSC._n_fft(T), dim=-1)
    offs = torch.full((8,), 1504, device=dev)
    want = cuda_lts.lts_timing_cuda(COX_CFG, rx, offs, X[:, 0])
    got = cuda_lts.lts_timing_cuda(COX_CFG, view, offs, X[:, 0])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    one = cuda_lts.lts_timing_cuda(COX_CFG, view[2:3], offs[:1], X[2:3, 0])
    for a, b in zip(one, want):
        assert torch.equal(a, b[2:3])


def test_lts_kernel_launches_counted(dev):
    """One launch a detect_preamble on the card, two with_deep, none on
    the CPU."""
    _, rx = _cox_buffers(dev, 4, seed=27)
    before = cuda_lts.launches
    TSC.detect_preamble(COX_CFG, rx)
    assert cuda_lts.launches == before + 1
    TSC.detect_preamble(COX_CFG, rx, with_deep=True)
    assert cuda_lts.launches == before + 3
    TSC.detect_preamble(COX_CFG, rx.cpu(), with_deep=True)
    assert cuda_lts.launches == before + 3


def test_lts_kernel_plan(dev):
    """The launch plan as the library computes it: one block a lane,
    the shared bytes of ``launch_plan``, blocks resident on every SM."""
    from projectultra_tpu_torch.config import nvis_mode
    for cfg, B, T in ((COX_CFG, 2048, 18856), (COX_CFG, 1, 262144),
                      (nvis_mode(), 64, 40000)):
        plen = cfg.fft_size + cfg.cyclic_prefix
        plan = cuda_lts.card_plan(B, plen, plen, T, dev)
        assert plan["library"] == {"blocks": B, "threads": plan["threads"],
                                   "shared_bytes": plan["shared_bytes"]}
        assert plan["blocks_per_sm"] >= 2


def test_lts_kernel_wrapper_checks_its_inputs(dev):
    _, rx = _cox_buffers(dev, 2, seed=28)
    X = torch.fft.fft(rx.to(torch.complex64), n=TSC._n_fft(rx.shape[1]),
                      dim=-1)
    offs = torch.full((2,), 1504, device=dev)
    with pytest.raises(ValueError):
        cuda_lts.lts_timing_cuda(COX_CFG, rx.double(), offs, X[:, 0])
    with pytest.raises(ValueError):
        cuda_lts.lts_timing_cuda(COX_CFG, rx, offs.int(), X[:, 0])
    with pytest.raises(ValueError):
        cuda_lts.lts_timing_cuda(COX_CFG, rx, offs[:1], X[:, 0])
    with pytest.raises(ValueError):
        cuda_lts.lts_timing_cuda(COX_CFG, rx[:, :500], offs, X[:, 0])
    with pytest.raises(ValueError):
        cuda_lts.lts_timing_cuda(COX_CFG, rx, offs, X[:1, 0])


# ---------------------------------------------------------------------------
# The AWGN channel kernel (csrc/awgn_active.cu)
# ---------------------------------------------------------------------------

#: A finite output of the kernel against the plain version's: the two sum a
#: frame's power in other orders, so its `std` may differ in the last bits,
#: which moves std * |n| by far less than 1e-5 of itself; and the output's
#: own rounding (s + std * n) may then land one ulp of |y| apart.
AWGN_STD_RTOL = 1e-5
AWGN_ULP = 2.0 ** -23


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _awgn_inputs(dev, shape, seed, lead=0, tail=0):
    """Samples of 0.3 sigma (zero for ``lead`` and ``tail`` samples of each
    row, as a frame's buffer) and standard normals, on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = 0.3 * torch.randn(shape, generator=g, device=dev)
    x[..., :lead] = 0.0
    x[..., x.shape[-1] - tail:] = 0.0
    return x, torch.randn(shape, generator=g, device=dev)


def _assert_awgn_equals_plain(x, snr_db, z):
    """The kernel (through ``add_noise_with``) twice and the plain version
    once on the same card tensors: the two runs bitwise equal; NaN, +inf and
    -inf exactly where the plain version has them; each finite output
    within AWGN_STD_RTOL * |want - x| (the plain noise std * |n|, up to
    rounding) plus one ulp of the plain output; one launch a call (none for
    an empty batch)."""
    before = cuda_awgn.launches
    runs = [TW.add_noise_with(x, snr_db, z) for _ in range(2)]
    assert cuda_awgn.launches == before + (2 if x.numel() else 0)
    want = TW.add_noise_with_plain(x, snr_db, z)
    got = runs[0]
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(runs[1]))
    for kind in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(kind(got), kind(want))
    fin = torch.isfinite(want)
    limit = AWGN_STD_RTOL * (want - x).abs() + AWGN_ULP * want.abs()
    assert bool(((got - want).abs()[fin] <= limit[fin]).all())
    return got, want


@pytest.mark.parametrize("B,T,lead,tail", [
    (16384, 7332, 0, 0),       # the presynced cells
    (2048, 18856, 1504, 1024),  # the Cox cell: zeros before and after
    (2048, 83808, 0, 0),       # the acquired cell
    (256, 287584, 4800, 4000),  # the DPSK cell: the stream regime
])
def test_awgn_kernel_at_the_cells(dev, B, T, lead, tail):
    x, z = _awgn_inputs(dev, (B, T), B + T, lead, tail)
    _assert_awgn_equals_plain(x, 17.0, z)


@pytest.mark.parametrize("shape", [(262144,), (2000000,), (64, 1), (64, 7),
                                   (0, 7332), (5, 0), (3, 4, 7332),
                                   (3, 24577), (2, 196612)])
def test_awgn_kernel_at_edge_shapes(dev, shape):
    """1-D engine and tool buffers (the stream regime), one and seven
    samples a row, empty batches, leading axes, the first cluster shape
    and the first stream shape past a cluster."""
    x, z = _awgn_inputs(dev, shape, 31)
    got, want = _assert_awgn_equals_plain(x, 5.0, z)
    if shape[-1] == 1:  # no sum order to differ: bit for bit
        assert torch.equal(_bits(got), _bits(want))


def test_awgn_kernel_reads_views(dev):
    """Row-strided views of wider buffers (noise at another offset and
    stride), a one-row view and a column-strided view (copied first)."""
    wide, zw = _awgn_inputs(dev, (6, 7400), 32)
    x, z = wide[:, 5:5 + 7332], zw[:, 3:3 + 7332]
    _assert_awgn_equals_plain(x, 17.0, z)
    _assert_awgn_equals_plain(x[2:3], 17.0, z[2:3])
    t, zt = _awgn_inputs(dev, (7332, 6), 33)
    _assert_awgn_equals_plain(t.T, 17.0, zt.T)


@pytest.mark.parametrize("snr", ["vector", "column", "device scalar"])
def test_awgn_kernel_at_a_per_frame_snr(dev, snr):
    """SNR tensors on the card (the sweeps' and tools' per-point SNRs),
    broadcast to the frames."""
    x, z = _awgn_inputs(dev, (2, 8, 7332), 34)
    if snr == "vector":
        snr_db = torch.linspace(-5.0, 20.0, 8, device=dev)
    elif snr == "column":
        snr_db = torch.tensor([[3.0], [11.0]], device=dev)
    else:
        snr_db = torch.tensor(7.5, device=dev)
    _assert_awgn_equals_plain(x, snr_db, z)


@pytest.mark.parametrize("regime", ["row", "cluster", "stream"])
def test_awgn_kernel_at_odd_rows(dev, regime):
    """Zero rows, rows of sub-threshold samples only, NaN, +inf and -inf
    samples and an infinite noise value, at the cells' row lengths (one
    per regime): non-finite exactly where the plain version is."""
    T = {"row": 7332, "cluster": 83808, "stream": 262144}[regime]
    x, z = _awgn_inputs(dev, (8, T), 35)
    x[0] = 0.0
    x[1] = 1e-6 * torch.sign(x[1])
    x[2, 100] = float("nan")
    x[3, T - 1] = float("inf")
    x[4, T // 2] = float("-inf")
    z[5, 17] = float("inf")
    z[0, 3] = float("-inf")
    assert cuda_awgn.launch_plan(8, T)["regime"] == regime
    got, _ = _assert_awgn_equals_plain(x, 17.0, z)
    assert torch.equal(got[1], x[1])
    assert torch.isnan(got[0, 3]) and torch.equal(got[0, 4:], x[0, 4:])


@pytest.mark.parametrize("T", [20000, 98305])
def test_awgn_kernel_regimes_agree(dev, monkeypatch, T):
    """Each regime that can take a row length (``launch_plan`` replaced by
    its ``regime_plan``) against the plain version."""
    x, z = _awgn_inputs(dev, (64, T), 36)
    for regime in ("row", "cluster", "stream"):
        plan = cuda_awgn.regime_plan(regime, 64, T)
        if plan["slice"] > cuda_awgn.MAX_SLICE:
            continue
        monkeypatch.setattr(cuda_awgn, "launch_plan",
                            lambda B, T, plan=plan: plan)
        _assert_awgn_equals_plain(x, 9.0, z)


def test_awgn_kernel_plan(dev):
    """The launch plan as the library computes it: the plan's blocks (the
    resident grid for the stream regime), threads and shared bytes, and
    blocks resident on every SM."""
    for B, T in ((16384, 7332), (2048, 18856), (2048, 83808),
                 (1, 262144), (1, 2000000), (3, 1)):
        plan = cuda_awgn.card_plan(B, T, dev)
        lib = plan["library"]
        assert lib["threads"] == plan["threads"]
        assert lib["shared_bytes"] == plan["shared_bytes"]
        if plan["regime"] == "stream":
            assert lib["blocks"] == min(plan["items"], plan["blocks_per_sm"]
                                        * cuda_build.sm_count(dev))
        else:
            assert lib["blocks"] == plan["blocks"]
        assert plan["blocks_per_sm"] >= 1


def test_awgn_kernel_never_synchronises(dev):
    """add_noise_with on the card enqueues without a host-device
    synchronisation, at a host SNR and at per-frame SNRs on the card, in
    each regime."""
    snr_vec = torch.linspace(0.0, 10.0, 4, device=dev)
    g = torch.Generator(device=dev).manual_seed(37)
    cases = [_awgn_inputs(dev, (4, T), 37) for T in (7332, 83808, 262144)]
    for x, z in cases:
        TW.add_noise_with(x, 17.0, z)
        TW.add_noise_with(x, snr_vec, z)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for x, z in cases:
            TW.add_noise_with(x, 17.0, z)
            TW.add_noise_with(x, snr_vec, z)
            TW.add_noise_active(x, 17.0, g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_awgn_kernel_wrapper_checks_its_inputs(dev):
    x, z = _awgn_inputs(dev, (3, 100), 38)
    for args in ((x.double(), 17.0, z.double()),
                 (x.to(torch.complex64), 17.0, z.to(torch.complex64)),
                 (x, 17.0, z.cpu()), (x, 17.0, z[:, :99]),
                 (x, torch.tensor([1.0, 2.0, 3.0]), z)):
        with pytest.raises(ValueError):
            cuda_awgn.add_noise_cuda(*args)


# ---------------------------------------------------------------------------
# The refined path (NVIS) as one CUDA graph replay
# ---------------------------------------------------------------------------

NVIS_CELL = "nvis_qam32-acquire-30db-cfo10-b2048"


def _refined_inputs(dev, B, seed, mod=Modulation.QAM32, rate=CodeRate.R3_4,
                    snr=30.0, ncw=8):
    """The refined path's arguments on NVIS frames of ``ncw`` codewords at
    a 10 Hz offset, cut at their detected first LTS as ``demodulate_span``
    cuts them: (config, mod, state after the LTS estimate, data
    [B, S, L], t0, front, n_bits, taper)."""
    from projectultra_tpu_torch.ofdm import demodulator as TDM
    cfg, _, rx = _nvis_buffers(dev, mod, rate, snr, B, ncw, seed=seed)
    det = TSC.detect_preamble(cfg, rx)
    plen = cfg.fft_size + cfg.cyclic_prefix
    S = TP.num_data_symbols(cfg, mod, ncw)
    span_len = 2 * plen + S * cfg.symbol_duration
    starts = torch.clamp(det["lts_start"].to(torch.int64), 0,
                         rx.shape[1] - span_len)
    span = rx.gather(1, starts[:, None] + torch.arange(span_len, device=dev))
    lts, data = TDM._span_segments(cfg, mod, span, 2, S, 0, 0, "analytic")
    ic, taper = TDM._scan_windows(mod, "analytic")
    state = TDM.init_state(cfg, B, det["cfo_hz"], 0.0, dev)
    state = TDM.estimate_channel_from_lts(cfg, state, lts, t0_base=plen,
                                          t0_stride=0, image_cancel=ic,
                                          taper=taper)
    return (cfg, mod, state, data, 2 * plen, "analytic",
            ldpc.BLOCK_LENGTH * ncw, taper)


def _fresh_refined_cache():
    from projectultra_tpu_torch.ofdm import demodulator as TDM
    TDM._refined_graphs.clear()
    return TDM


@pytest.mark.parametrize("B", [1, 7, 2048])
@pytest.mark.parametrize("mod", [Modulation.QAM32, Modulation.QAM256])
def test_refined_graph_replay_is_the_eager_loop(dev, mod, B):
    """A shape's first call runs the eager loops; its second captures the
    graph and replays it, its third replays it: each bit for bit the eager
    loops' LLRs on the same card tensors (QAM32 R3/4 at 30 dB, the cell's
    8 codewords; QAM256 R5/6 at 42 dB, the Tukey window)."""
    if mod == Modulation.QAM32:
        args = _refined_inputs(dev, B, seed=B + 3)
    else:
        args = _refined_inputs(dev, B, seed=B + 3, mod=mod,
                               rate=CodeRate.R5_6, snr=42.0, ncw=1)
    TDM = _fresh_refined_cache()
    want = TDM._refined_eager(*args)
    captures, replays = TDM.refined_captures, TDM.refined_replays
    assert torch.equal(TDM._demod_coherent_refined(*args), want)
    assert (TDM.refined_captures, TDM.refined_replays) == (captures, replays)
    for n in (1, 2):
        assert torch.equal(TDM._demod_coherent_refined(*args), want)
        assert TDM.refined_replays == replays + n
    assert TDM.refined_captures == captures + 1


def test_refined_replays_in_a_row_keep_their_own_results(dev):
    """Two replays of one graph on different inputs: each equals its own
    eager result, and the second leaves the first's LLRs as they were."""
    a = _refined_inputs(dev, 64, seed=1)
    b = _refined_inputs(dev, 64, seed=2)
    TDM = _fresh_refined_cache()
    want_a, want_b = TDM._refined_eager(*a), TDM._refined_eager(*b)
    TDM._demod_coherent_refined(*a)
    replays = TDM.refined_replays
    got_a = TDM._demod_coherent_refined(*a)
    got_b = TDM._demod_coherent_refined(*b)
    assert TDM.refined_replays == replays + 2
    assert torch.equal(got_a, want_a) and torch.equal(got_b, want_b)
    assert not torch.equal(got_a, got_b)


def test_decode_cox_batch_replays_the_refined_graph(dev):
    """decode_cox_batch on NVIS frames: the third call replays the refined
    graph and gives the first call's bits, ok flags, iterations and LLRs
    bit for bit, without a synchronisation."""
    cfg, info, rx = _nvis_buffers(dev, Modulation.QAM32, CodeRate.R3_4, 30.0,
                                  256, 8)
    TDM = _fresh_refined_cache()

    def step():
        return TSC.decode_cox_batch(cfg, Modulation.QAM32, CodeRate.R3_4, rx,
                                    n_codewords=8, with_llrs=True)

    first = step()
    step()
    torch.cuda.synchronize()
    replays = TDM.refined_replays
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert TDM.refined_replays == replays + 1
    for a, b in zip(first[:3] + first[4:], again[:3] + again[4:]):
        assert torch.equal(a, b)
    assert bool(first[1].all()) and torch.equal(first[0], info)


def test_no_refined_capture_in_a_benchmark_window(dev):
    """The NVIS cell at a small batch as the benchmark runs it: the warm-up
    captures the refined path and the TX, the window only replays them,
    each kernel runs once a step, and the run is correct."""
    import ast
    import dataclasses
    import time
    from benchmark import harness
    cell = harness.load_cell(NVIS_CELL)
    cell.traffic = dataclasses.replace(cell.traffic, batch=128,
                                       reference_rows=64, compare_span=5)
    logs = []
    line = harness.run(cell, 2**31 + 29, 1.0, False, dev, time.perf_counter(),
                       logs.append)
    window = next(m for m in logs if m.startswith("window:"))
    launches = ast.literal_eval(window.split("kernel launches ", 1)[1])
    steps = int(window.split()[1])
    assert launches["refined_captures"] == launches["tx_captures"] == 0
    assert launches["refined_replays"] == launches["tx_replays"] == steps
    for kernel in ("sc_windows", "lts_timing", "awgn_active", "ldpc_minsum"):
        assert launches[kernel] == steps, kernel
    assert launches["ldpc_minsum_bf16"] == 0
    assert line["correct"] is True


def test_nvis_entry_spans_on_the_card(dev):
    """One step of the NVIS entry at a small batch with the program's spans
    on, after the refined path's first call and its capture: every span
    records its CUDA events, no child's device ms exceed its parent's, and
    the step (TX, CFO, channel, receive chain) never synchronises."""
    import dataclasses
    from benchmark import harness, traffic as BT
    from projectultra_tpu_torch.utils import metrics
    cell = harness.load_cell(NVIS_CELL)
    mix = dataclasses.replace(cell.traffic, batch=64)
    entry = cell.entry.Entry(cell.config, mix, dev)
    info, noise = BT.inputs(mix, entry.k, entry.T, 2**31 + 19, 0, dev)
    with entry.precision():
        for _ in range(2):
            out = entry.step(info, noise, harness.no_mark)
        torch.cuda.synchronize()
        with metrics.tracing() as rec:
            rec.next_batch()
            torch.cuda.set_sync_debug_mode("error")
            try:
                again = entry.step(info, noise, harness.no_mark)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            spans = rec.drain()
    torch.cuda.synchronize()
    for key in ("tx", "rx", "bits", "ok", "iters", "llrs"):
        assert torch.equal(again[key], out[key]), key
    assert [s.name for s in spans] == ["cox.tx", "noise.awgn", "cox.rx",
                                       "cox.detect", "cox.lts",
                                       "ofdm.refined", "ldpc.decode"]
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.device_ms() > 0, s.name
        if s.parent is not None:
            assert s.device_ms() <= by_id[s.parent].device_ms(), s.name


def test_lts_kernel_at_the_nvis_cell(dev, monkeypatch):
    """The LTS timing kernel on the 1,120-sample template at the NVIS
    cell's B = 2,048 x T = 33,000 against the plain FFT matched filter on
    the same card tensors: every detection output equal but lts_corr,
    within LTS_CORR_ATOL; every frame found."""
    cfg, _, rx = _nvis_buffers(dev, Modulation.QAM32, CodeRate.R3_4, 30.0,
                               2048, 8)
    assert rx.shape == (2048, 33000)
    before = cuda_lts.launches
    det = TSC.detect_preamble(cfg, rx)
    assert cuda_lts.launches == before + 1
    _plain_lts(monkeypatch)
    ref = TSC.detect_preamble(cfg, rx)
    _assert_same_detection(det, ref)
    assert det["found"].all()

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
odd offsets, lda > T and odd contiguous rows, a B = 1 row long enough
that every block walks several items through its ring; at one +inf or NaN
sample (Cox- and engine-shaped buffers, strides 1 and 8, half 256 and 512)
non-finite exactly where the plain version is, of the same kind; and
detection through the kernel identical to detection through the plain
version.  The acquisition-
inclusive Cox step goes through both kernels and never synchronises.

Chirp acquisition, MC-DPSK and the Watterson channel (plain PyTorch on the
card): detection on the card equals the CPU path (success and positions
identical, cfo within 1e-3 Hz); the bench's chirp step goes through the
LDPC kernel and never synchronises; OFDM_CHIRP decodes behind a detected
chirp; ``watterson_with`` on the card equals the CPU on the same normals.

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
engine's DPSK search.

The streaming engine: ``ModemEngine()`` takes the card; the reference
CLI's five files streamed through it give the CPU engine's events and
consumed positions, through both kernels.

The protocol slice: ``ProtocolEngine``, ``RxPipeline`` and the waveform
adapters take the card; ``decode_hard_stream`` goes through the LDPC
kernel and gives the golden bytes; ``ops/dsp`` and the waterfall on the
card within rtol 1e-4, atol 1e-5 (waterfall: rtol 1e-5 plus 1e-3 dB) of
the CPU; two stations on the card connect and exchange a message each
way through both kernels.
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
from projectultra_tpu_torch.ops import cuda_dpsk, cuda_ldpc, cuda_sc  # noqa: E402
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
    B = 256 at R1/2 and R1/4): bits, ok flags and iterations equal to the
    plain decoder on every lane, and the totals equal, NaN to NaN -- the
    v2c clamp and min2 keep a NaN, as jnp.clip/jnp.minimum do."""
    monkeypatch.setattr(cuda_ldpc, "block_threads_for", lambda B, sms: threads)
    dtype = torch.bfloat16 if msg == "bf16" else torch.float32
    counter = "launches_bf16" if msg == "bf16" else "launches"
    report, nan_totals = {}, 0
    for rate, sigma in NONFINITE:
        graph = T.graph_for(ldpc.get_code(rate), dev)
        for kind in ("inf", "nan"):
            x = torch.from_numpy(nonfinite_llrs(rate, sigma, 256, kind)).to(dev)
            before = getattr(cuda_ldpc, counter)
            got = cuda_ldpc.decode_cuda(graph, x, trap_escape=trap_escape,
                                        msg_dtype=dtype)
            assert getattr(cuda_ldpc, counter) > before
            want = T.decode_plain(graph, x, trap_escape=trap_escape,
                                  msg_dtype=dtype)
            decisions, totals = lanes_that_differ(graph.k, got, want)
            report[f"{NAMES[rate]} {kind}"] = (int(decisions.sum()),
                                               int(totals.sum()))
            nan_totals += int(torch.isnan(want[0]).any(1).sum())
    assert nan_totals > 0
    assert all(v == (0, 0) for v in report.values()), (
        f"lanes of 256 that differ from the plain decoder (decisions, "
        f"totals): {report}")


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
    a = _analytic_on(dev, 16, T, seed=T)
    assert not a.is_contiguous()
    G = (T - 2 * 256 - offset) // stride + 1
    _assert_windows_close(a, 256, stride, offset, G)
    _assert_windows_close(a, 256, stride, offset, min(G, 5))


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
    _, rx = _cox_buffers(dev, 64)
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
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, ok, _, _ = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(ok.all()) and torch.equal(out, info)


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


def test_chirp_detection_on_the_card_equals_the_cpu(dev):
    _, rx = _chirp_buffers(dev, 16, cfo=20.0)
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
    """The 1,024-FFT plans' half = 512 (nvis_mode, high_throughput)."""
    a = _analytic_on(dev, 9, 15080, seed=stride)
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


# (L, B, O, row, sample), as tests/test_torch_dpsk_score.py's.
DPSK_NONFINITE = {"batch": (384, 3, 16_000, 1, 15_000),
                  "engine": (768, 1, 40_000, 0, 35_000)}


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
    cw = T.encode(ldpc.get_code(CodeRate.R1_4), info)
    pre = torch.from_numpy(TD.generate_preamble(cfg)).to(dev)
    tx = torch.cat([torch.zeros((B, 4800), device=dev), pre.expand(B, -1),
                    TD.modulate(cfg, cw), torch.zeros((B, 4000), device=dev)],
                   dim=-1)
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

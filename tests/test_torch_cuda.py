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
the CPU.

Schmidl-Cox windows: P, R1 and R2 within rtol 2e-4, atol 2e-3 (the
tolerance of tests/test_pallas_sync.py; the kernel sums in another order)
at strides 1, 2 and 8, G below one tile and ragged last tiles, odd B, odd offsets, lda > T and odd contiguous rows, and detection
through the kernel identical to detection through the plain version.  The acquisition-
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
from projectultra_tpu_torch.ops import cuda_ldpc, cuda_sc  # noqa: E402
from projectultra_tpu_torch.ops import ldpc as T  # noqa: E402
from projectultra_tpu_torch.ops import sc_windows as TSW  # noqa: E402
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
    """Tiles of 512 outputs: G below one tile, exactly one, ragged last
    tiles, odd B, an odd offset at stride 1, and a row stride (lda) above
    T."""
    offset = 48 if stride > 1 else 47
    T = offset + stride * (G - 1) + 2 * 256 + 3
    a = _analytic_on(dev, B, T, seed=G + stride)
    assert a.stride(0) > T
    _assert_windows_close(a, 256, stride, offset, G)


def test_window_kernel_reads_odd_rows(dev):
    """Odd T in contiguous rows (odd lda): the wrapper copies the rows into
    an even row stride for the kernel's 16-byte loads."""
    a = _analytic_on(dev, 3, 3001).contiguous()
    assert a.stride(0) % 2 == 1
    _assert_windows_close(a, 256, 1, 1, 3001 - 512 - 1 + 1)
    _assert_windows_close(a, 256, 8, 8, (3001 - 512 - 8) // 8 + 1)


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

"""Schmidl-Cox acquisition of the PyTorch port against the JAX package.

The buffers are JAX's, built as tests/test_schmidl_cox.py builds them
(lead + generate_preamble + modulate at preamble_data_t_offset + tail),
with JAX's noise and CFO.  Tolerances:

* analytic signal and harness CFO: max abs difference <= 1e-5 of the peak
  (float32 FFTs of pocketfft and PyTorch's CPU FFT differ by ulps);
  osc_traced atol 1e-6;
* window sums: rtol 1e-5 against JAX's _window_sum; the plain
  sc_windows against the Pallas kernel in interpret mode and the
  _window_sum references at rtol 2e-4, atol 2e-3, the tolerance of
  tests/test_pallas_sync.py;
* detection: found, lts_start, data_start and sync_off exact, cfo_hz
  within 0.01 Hz (a P error of 1e-6 moves the CFO by ~3e-5 Hz),
  peak_corr and lts_corr atol 1e-4;
* the Cox receivers: bits, ok flags and iteration counts exact.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from projectultra_tpu.config import (CodeRate, ModemConfig, Modulation,  # noqa: E402
                                     bits_per_symbol)
from projectultra_tpu.fec import ldpc  # noqa: E402
from projectultra_tpu.fec.interleave import channel_interleaver  # noqa: E402
from projectultra_tpu.ofdm import carriers as C  # noqa: E402
from projectultra_tpu.ofdm import demodulator as JD  # noqa: E402
from projectultra_tpu.ofdm import modulator as JM  # noqa: E402
from projectultra_tpu.ops import ldpc as JL  # noqa: E402
from projectultra_tpu.ops import mixer as JMX  # noqa: E402
from projectultra_tpu.ops.pallas_sync import sc_windows_pallas  # noqa: E402
from projectultra_tpu.sim import watterson as JW  # noqa: E402
from projectultra_tpu.sync import schmidl_cox as JSC  # noqa: E402

from projectultra_tpu_torch.ops import cuda_sc  # noqa: E402
from projectultra_tpu_torch.ops import ldpc as TL  # noqa: E402
from projectultra_tpu_torch.ops import mixer as TMX  # noqa: E402
from projectultra_tpu_torch.ops import sc_windows as TSW  # noqa: E402
from projectultra_tpu_torch.sim import watterson as TW  # noqa: E402
from projectultra_tpu_torch.sync import schmidl_cox as TSC  # noqa: E402

CFG = ModemConfig()  # 512-FFT, 30 carriers, pilots: the OFDM_COX plan
PLEN = CFG.fft_size + CFG.cyclic_prefix


def make_tx(mod, rate, B, seed=0, lead=3000, tail=2000):
    """JAX's Cox frames of tests/test_schmidl_cox.py:24-41 -> (info, tx)."""
    code = ldpc.get_code(rate)
    info = np.random.default_rng(seed).integers(
        0, 2, size=(B, code.k)).astype(np.float32)
    cw = np.asarray(JL.encode(code, jnp.asarray(info)))
    cm = C.carrier_map(CFG)
    ci = channel_interleaver(len(cm.data_idx) * bits_per_symbol(mod), 648)
    cw = cw[:, ci.inv]
    pre = JM.generate_preamble(CFG)
    data = JM.modulate(CFG, mod, jnp.asarray(cw),
                       t_offset=JM.preamble_data_t_offset(CFG))
    head = np.concatenate([np.zeros(lead, np.float32), pre])
    tx = jnp.concatenate([jnp.broadcast_to(jnp.asarray(head), (B, len(head))),
                          data, jnp.zeros((B, tail))], axis=-1)
    return info, tx


def noisy_tx(mod, rate, snr_db, cfo=0.0, B=4, seed=1, **kw):
    """The noisy buffers of _cox_e2e (tests/test_schmidl_cox.py:69-74)."""
    info, tx = make_tx(mod, rate, B, seed=seed, **kw)
    if cfo:
        tx = JW.apply_cfo_hilbert(tx, jnp.full((B,), cfo))
    return info, np.asarray(JW.add_noise_active(jax.random.PRNGKey(seed),
                                                tx, snr_db))


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# Analytic signal, split-index oscillator, harness CFO
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [6000, 8192, 9001])
def test_analytic_signal_matches_jax(T):
    x = np.random.default_rng(T).standard_normal((3, T)).astype(np.float32)
    ref = np.asarray(JSC.analytic_signal(jnp.asarray(x)))
    ours = TSC.analytic_signal(_t(x)).numpy()
    assert ours.shape == ref.shape == (3, T)
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()


def test_osc_traced_matches_jax():
    t = np.concatenate([np.arange(0, 2000), np.arange(47990, 48010),
                        np.arange(600_000, 600_500)]).astype(np.int32)
    for f in (30.0, -12.345, 0.0071):
        np.testing.assert_allclose(
            TMX.osc_traced(f, 48000, torch.from_numpy(t)).numpy(),
            np.asarray(JMX.osc_traced(f, 48000, jnp.asarray(t))),
            rtol=0, atol=1e-6)
    f = np.array([[15.0], [-20.0], [89.5]], np.float32)
    np.testing.assert_allclose(
        TMX.osc_traced(torch.from_numpy(f), 48000, torch.from_numpy(t)).numpy(),
        np.asarray(JMX.osc_traced(jnp.asarray(f), 48000, jnp.asarray(t))),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("cfo", [30.0, [15.0, -20.0, 0.0]])
def test_apply_cfo_hilbert_matches_jax(cfo):
    _, tx = make_tx(Modulation.QPSK, CodeRate.R1_2, 3, lead=500, tail=300)
    tx = np.asarray(tx)
    ref = np.asarray(JW.apply_cfo_hilbert(jnp.asarray(tx), jnp.asarray(cfo)))
    arg = cfo if isinstance(cfo, float) else torch.tensor(cfo)
    ours = TW.apply_cfo_hilbert(_t(tx), arg).numpy()
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(tx).max()
    if not isinstance(cfo, float):  # a zero-CFO frame passes unchanged
        np.testing.assert_array_equal(ours[2], tx[2])


# ---------------------------------------------------------------------------
# Window sums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,w", [(np.float32, 38), (np.float32, 64),
                                     (np.complex64, 256), (np.complex64, 32)])
def test_window_sum_matches_jax(dtype, w):
    rng = np.random.default_rng(w)
    x = rng.standard_normal((3, 5003)).astype(np.float32)
    if dtype == np.complex64:
        x = (x + 1j * rng.standard_normal((3, 5003))).astype(np.complex64)
    ref = np.asarray(JSC._window_sum(jnp.asarray(x), w))
    ours = TSC._window_sum(_t(x), w).numpy()
    assert ours.shape == ref.shape == (3, 5003 - w + 1)
    np.testing.assert_allclose(ours, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_window_sum_long_buffer_precision():
    """The port of tests/test_long_buffer_precision.py:20-33: the
    block-stable window sum stays exact against float64 where
    cumsum differences drift."""
    rng = np.random.default_rng(1)
    T, w = 600_000, 1536
    x = (rng.standard_normal(T).astype(np.float32) + 0.5) ** 2
    exact = np.convolve(x.astype(np.float64), np.ones(w), mode="valid")
    ws = TSC._window_sum(torch.from_numpy(x[None, :]), w).numpy()[0]
    rel = np.abs(ws - exact) / np.maximum(exact, 1e-9)
    assert rel.max() < 1e-4, f"block-stable window sum drifted: {rel.max()}"
    c = np.cumsum(np.pad(x, (1, 0)), dtype=np.float32)
    bad = (c[w:] - c[:T - w + 1]).astype(np.float64)
    bad_rel = np.abs(bad - exact) / np.maximum(exact, 1e-9)
    assert bad_rel.max() > rel.max() * 10


def _analytic(T, seed=0):
    sig = np.random.default_rng(seed).standard_normal(T).astype(np.float32)
    return JSC.analytic_signal(jnp.asarray(sig[None, :]))[0]


def test_sc_windows_plain_stride1_matches_pallas_and_window_sums():
    """As tests/test_pallas_sync.py builds it: T = 6000, half = 256."""
    T, half = 6000, 256
    a = _analytic(T)
    n = T - 2 * half + 1
    P, R1, R2 = TSW.sc_windows_plain(_t(a)[None], half, 1, 0, n)
    kP, kR1, kR2 = sc_windows_pallas(a, half, interpret=True)
    u = jnp.conj(a[:-half]) * a[half:]
    e = jnp.abs(a) ** 2
    refs = (JSC._window_sum(u[None], half)[0][:n],
            JSC._window_sum(e[None, :-half], half)[0][:n],
            JSC._window_sum(e[None, half:], half)[0][:n])
    for ours, kern, ref in zip((P, R1, R2), (kP, kR1, kR2), refs):
        assert tuple(ours.shape) == (1, n)
        np.testing.assert_allclose(ours.numpy()[0], np.asarray(kern),
                                   rtol=2e-4, atol=2e-3)
        np.testing.assert_allclose(ours.numpy()[0], np.asarray(ref),
                                   rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("T", [18856, 9001])
def test_sc_windows_plain_stride8_is_the_block_grid(T):
    """Stride 8 at offset cp equals gP, gR1 and gR2 of detect_preamble,
    rebuilt here from schmidl_cox.py:200-219 in JAX (T = 9001 is ragged)."""
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T)).astype(np.float32)
    a = JSC.analytic_signal(jnp.asarray(x))
    N, cp, st = CFG.fft_size, CFG.cyclic_prefix, 8
    half, hb, cpb, nb = N // 2, N // 2 // st, cp // st, T // st
    ab = a[:, :nb * st].reshape(2, nb, st)
    eb = (ab.real * ab.real + ab.imag * ab.imag).sum(-1)
    ub = (jnp.conj(ab[:, :nb - hb]) * ab[:, hb:]).sum(-1)
    Pb, Eb = JSC._window_sum(ub, hb), JSC._window_sum(eb, hb)
    G = min(-(-(T - N - cp + 1) // st), Pb.shape[-1] - cpb)
    refs = (Pb[:, cpb:cpb + G], Eb[:, cpb:cpb + G],
            Eb[:, cpb + hb:cpb + hb + G])
    outs = TSW.sc_windows(_t(a), half, st, cp, G)
    for ours, ref in zip(outs, refs):
        assert tuple(ours.shape) == (2, G)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   rtol=2e-4, atol=2e-3)


def test_sc_windows_refuses_windows_past_the_buffer():
    a = torch.zeros((1, 1000), dtype=torch.complex64)
    TSW.sc_windows(a, 256, 8, 48, 56)  # 48 + 8*55 + 512 = 1000
    with pytest.raises(ValueError):
        TSW.sc_windows(a, 256, 8, 48, 57)
    with pytest.raises(ValueError):
        TSW.sc_windows(a, 256, 8, 44, 10)   # offset off the stride grid
    with pytest.raises(ValueError):
        TSW.sc_windows(a, 100, 8, 0, 10)    # half not a multiple of stride


def test_sc_metric_matches_jax():
    _, buf = noisy_tx(Modulation.QPSK, CodeRate.R1_2, 17.0, B=2)
    corr, P = JSC.sc_metric(CFG, jnp.asarray(buf))
    ours_corr, ours_P = TSC.sc_metric(CFG, _t(buf))
    np.testing.assert_allclose(ours_P.numpy(), np.asarray(P), rtol=2e-4,
                               atol=2e-3)
    np.testing.assert_allclose(ours_corr.numpy(), np.asarray(corr), rtol=0,
                               atol=1e-4)


def test_cpu_windows_run_the_plain_version():
    a = _t(_analytic(3000))[None]
    before = cuda_sc.launches
    got = TSW.sc_windows(a, 256, 1, 48, 100)
    assert cuda_sc.launches == before
    for x, y in zip(got, TSW.sc_windows_plain(a, 256, 1, 48, 100)):
        assert torch.equal(x, y)


def test_window_kernel_wrapper_refuses_cpu_tensors():
    a = torch.zeros((2, 2000), dtype=torch.complex64)
    with pytest.raises(ValueError):
        cuda_sc.sc_windows_cuda(a, 256, 8, 48, 10)


def test_window_kernel_nvcc_command_targets_hopper():
    cmd = cuda_sc.nvcc_command("nvcc", cuda_sc.SOURCE, cuda_sc.cuda_build
                               .BUILD_DIR / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cuda_sc.SOURCE.is_file() and cuda_sc.SOURCE.name == "sc_windows.cu"


@pytest.mark.parametrize("T,view", [(3000, False), (3001, False),
                                    (3001, True), (2999, True)])
def test_window_kernel_row_layout(T, view):
    """The rows the kernel reads as 16-byte pairs: a view of wider rows is
    taken as it is; odd contiguous rows are copied into even rows."""
    base = torch.randn((3, 4096 if view else T), dtype=torch.complex64)
    a = base[:, :T]
    rows = cuda_sc._float4_rows(a)
    assert torch.equal(rows, a)
    assert rows.stride(0) % 2 == 0
    assert (rows.data_ptr() == a.data_ptr()) == (view or T % 2 == 0)


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------

def _buffer(kind):
    if kind == "noise":
        return np.asarray(jax.random.normal(jax.random.PRNGKey(9), (2, 40000)),
                          np.float32) * 0.1
    if kind == "clean":
        return np.asarray(make_tx(Modulation.QPSK, CodeRate.R1_2, 2)[1])
    if kind == "17dB":
        return noisy_tx(Modulation.QPSK, CodeRate.R1_2, 17.0, B=2)[1]
    _, tx = make_tx(Modulation.QPSK, CodeRate.R1_2, 2)       # 40 Hz + 17 dB
    shifted = JW.apply_cfo_hilbert(tx, jnp.full((2,), 40.0))
    return np.asarray(JW.add_noise_active(jax.random.PRNGKey(0), shifted,
                                          17.0))


def _assert_detection_equal(ours, ref):
    for prefix in {k[:-len("found")] for k in ref if k.endswith("found")}:
        for key in ("found", "lts_start", "data_start", "sync_off"):
            np.testing.assert_array_equal(ours[prefix + key].numpy(),
                                          np.asarray(ref[prefix + key]),
                                          err_msg=prefix + key)
        np.testing.assert_allclose(ours[prefix + "cfo_hz"].numpy(),
                                   np.asarray(ref[prefix + "cfo_hz"]),
                                   rtol=0, atol=0.01)
        for key in ("peak_corr", "lts_corr"):
            np.testing.assert_allclose(ours[prefix + key].numpy(),
                                       np.asarray(ref[prefix + key]),
                                       rtol=0, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("with_deep", [False, True])
@pytest.mark.parametrize("kind", ["clean", "17dB", "cfo40_17dB", "noise"])
def test_detect_preamble_matches_jax(kind, with_deep):
    buf = _buffer(kind)
    ref = JSC.detect_preamble(CFG, jnp.asarray(buf), with_deep=with_deep)
    ours = TSC.detect_preamble(CFG, _t(buf), with_deep=with_deep)
    assert ours.keys() == ref.keys()
    _assert_detection_equal(ours, ref)
    assert ours["lts_start"].dtype == torch.int32
    if kind == "noise":
        assert not ours["found"].any()
    else:
        assert ours["found"].all()


# ---------------------------------------------------------------------------
# The Cox receivers
# ---------------------------------------------------------------------------

def _deinterleave(mod, rate, llrs):
    cm = C.carrier_map(CFG)
    ci = channel_interleaver(len(cm.data_idx) * bits_per_symbol(mod), 648)
    return llrs[:, :648][:, ci.perm]


@pytest.mark.parametrize("mod,rate,snr,cfo", [
    (Modulation.QPSK, CodeRate.R1_2, 17.0, 0.0),
    (Modulation.QAM16, CodeRate.R2_3, 25.0, 0.0),
    (Modulation.QPSK, CodeRate.R1_2, 20.0, 30.0)])
def test_decode_ofdm_cox_matches_jax(mod, rate, snr, cfo):
    """The three _cox_e2e points of tests/test_schmidl_cox.py:86-100."""
    info, buf = noisy_tx(mod, rate, snr, cfo=cfo)
    ref_llrs, ref_det = JSC.decode_ofdm_cox(CFG, mod, jnp.asarray(buf), 1)
    llrs, det = TSC.decode_ofdm_cox(CFG, mod, _t(buf), 1)
    _assert_detection_equal(det, ref_det)
    np.testing.assert_allclose(llrs.numpy(), np.asarray(ref_llrs), rtol=0,
                               atol=2e-4)
    code = ldpc.get_code(rate)
    ref = JL.decode(code, jnp.asarray(_deinterleave(mod, rate,
                                                    np.asarray(ref_llrs))))
    ours = TL.decode(code, _deinterleave(mod, rate, llrs))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ours[1].all()
    np.testing.assert_array_equal(ours[0].numpy(), info.astype(np.uint8))


def _hunt_signal():
    """The v2-looking R1/4 codeword of test_hunt_for_codeword_recovers_timing."""
    from projectultra_tpu.protocol import frame_v2 as F
    from projectultra_tpu.utils.bits import bytes_to_bits
    code = ldpc.get_code(CodeRate.R1_4)
    hdr = F.ControlFrame.make_ack("W1AW", "VE3ABC", 1).serialize()
    info_bits = np.zeros((1, code.k), np.float32)
    raw = bytes_to_bits(hdr)[:code.k]
    info_bits[0, :len(raw)] = raw
    cw = np.asarray(JL.encode(code, jnp.asarray(info_bits)))
    ci = channel_interleaver(len(C.carrier_map(CFG).data_idx) * 2, 648)
    data = np.asarray(JM.modulate(CFG, Modulation.QPSK,
                                  jnp.asarray(cw[:, ci.inv])))[0]
    return np.concatenate([np.zeros(5000, np.float32), data,
                           np.zeros(2000, np.float32)])


@pytest.mark.parametrize("nominal", [5000, 4900])
def test_hunt_for_codeword_matches_jax(nominal):
    sig = _hunt_signal()
    ref = JSC.hunt_for_codeword(CFG, Modulation.QPSK, jnp.asarray(sig),
                                nominal)
    ours = TSC.hunt_for_codeword(CFG, Modulation.QPSK, torch.from_numpy(sig),
                                 nominal)
    assert ours == ref
    assert ours[0] and (ours[1] == 0 if nominal == 5000 else
                        ours[1] in (50, 100))


def test_bench_shaped_cox_step_matches_jax():
    """detect -> clip -> per-lane gather -> demodulate_span -> deinterleave
    -> decode (bench.py:330-342) on JAX's 17 dB DQPSK buffers, B = 8, lead
    1,504: bits, ok and iterations equal the same chain run in JAX."""
    mod, rate = Modulation.DQPSK, CodeRate.R1_2
    info, buf = noisy_tx(mod, rate, 17.0, B=8, seed=13, lead=1504, tail=1024)
    S = 22
    span_len = 2 * PLEN + S * CFG.symbol_duration
    x = jnp.asarray(buf)
    det = JSC.detect_preamble(CFG, x)
    starts = jnp.clip(det["lts_start"], 0, buf.shape[-1] - span_len)
    span = jax.vmap(lambda b, s: jax.lax.dynamic_slice(b, (s,), (span_len,)))(
        x, starts)
    llrs, _ = JD.demodulate_span(CFG, mod, span, det["cfo_hz"], 0.0,
                                 n_lts=2, S=S, n_bits=648)
    ref = JL.decode(ldpc.get_code(rate),
                    jnp.asarray(_deinterleave(mod, rate, np.asarray(llrs))))
    ours_info, ours_ok, ours_iters, ours_det = TSC.decode_cox_batch(
        CFG, mod, rate, _t(buf))
    _assert_detection_equal(ours_det, det)
    np.testing.assert_array_equal(ours_info.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(ours_ok.numpy(),
                                  np.asarray(ref[1] & det["found"]))
    np.testing.assert_array_equal(ours_iters.numpy()[:, 0], np.asarray(ref[2]))
    assert ours_ok.all()
    np.testing.assert_array_equal(ours_info.numpy(), info.astype(np.uint8))


def test_tx_cox_frame_matches_the_jax_construction():
    """The port's Cox TX equals the JAX frames of
    tests/test_schmidl_cox.py:24-41 (and bench.py:304-321)."""
    from projectultra_tpu_torch.ofdm import pipeline as TP
    for mod, rate in ((Modulation.DQPSK, CodeRate.R1_2),
                      (Modulation.QAM16, CodeRate.R2_3)):
        info, tx = make_tx(mod, rate, 3, seed=2, lead=1504, tail=1024)
        ours = TP.tx_cox_frame(CFG, mod, rate, torch.from_numpy(info),
                               lead=1504, tail=1024).numpy()
        tx = np.asarray(tx)
        assert ours.shape == tx.shape
        assert np.abs(ours - tx).max() <= 1e-5 * np.abs(tx).max()


def test_port_cox_loopback_17db_decodes_all_frames():
    """The port's own Cox TX at the bench's shape (T = 18,856) and 17 dB
    noise from a torch.Generator."""
    from projectultra_tpu_torch.ofdm import pipeline as TP
    mod, rate = Modulation.DQPSK, CodeRate.R1_2
    code = ldpc.get_code(rate)
    g = torch.Generator().manual_seed(21)
    info = torch.randint(0, 2, (8, code.k), generator=g, dtype=torch.uint8)
    tx = TP.tx_cox_frame(CFG, mod, rate, info, lead=1504, tail=1024)
    assert tx.shape[-1] == 18856
    rx = TW.add_noise_active(tx, 17.0, g)
    out, ok, _, det = TSC.decode_cox_batch(CFG, mod, rate, rx)
    assert int(ok.sum()) == 8 and torch.equal(out, info)
    true_lts = 1504 + 5 * PLEN  # lead, silence symbol, 4 STS
    assert int((det["lts_start"] - true_lts).abs().max()) <= 2

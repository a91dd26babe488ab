"""The port's delay-fit retry (ofdm/delay_fit.py) against the JAX package.

The frames are tests/test_delay_fit.py's: high_throughput() (1024-FFT, 59
carriers, pilot spacing 4), QAM16 R2/3, 8 codewords, JAX's Watterson
good() channel (seed 3, lanes 2 and 7) then 20 dB AWGN, received with the
real front end.

Tolerances: host tables array-equal; the Cramer/adjugate solves rtol 1e-4;
the raw used bins of ``span_fd`` rtol 1e-4, atol 1e-4 of their unit scale
(the per-symbol pilot tracking of the scan, as in test_torch_scan.py);
delay-fit LLRs atol 2e-4 plus rtol 1e-4 (float32 einsums and the 3x3
adjugate differ by ulps), with the matching pursuit's chosen delays
exact; decoded codewords (with ``trap_escape``) exact.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from projectultra_tpu import config as JC  # noqa: E402
from projectultra_tpu.config import CodeRate, Modulation, bits_per_symbol  # noqa: E402
from projectultra_tpu.fec import ldpc  # noqa: E402
from projectultra_tpu.fec.interleave import channel_interleaver  # noqa: E402
from projectultra_tpu.ofdm import carriers as C  # noqa: E402
from projectultra_tpu.ofdm import delay_fit as JDF  # noqa: E402
from projectultra_tpu.ofdm import modulator as JM  # noqa: E402
from projectultra_tpu.ofdm import pipeline as JP  # noqa: E402
from projectultra_tpu.ops import ldpc as JL  # noqa: E402
from projectultra_tpu.sim import watterson as JW  # noqa: E402
from projectultra_tpu.sync import schmidl_cox as JSC  # noqa: E402

from projectultra_tpu_torch import config as TC  # noqa: E402
from projectultra_tpu_torch.fec import ldpc as TLC  # noqa: E402
from projectultra_tpu_torch.ofdm import delay_fit as TDF  # noqa: E402
from projectultra_tpu_torch.ops import ldpc as TL  # noqa: E402
from projectultra_tpu_torch.sync import schmidl_cox as TSC  # noqa: E402

CFG_J, CFG_T = JC.high_throughput(), TC.high_throughput()
MOD, RATE, NCW = Modulation.QAM16, CodeRate.R2_3, 8
LEAD, TAIL = 7200, 1152
PLEN = CFG_J.fft_size + CFG_J.cyclic_prefix


@pytest.fixture(scope="module")
def good_lanes():
    """(info [8, k], rx [2, T]): lanes 2 and 7 of tests/test_delay_fit.py's
    Good-channel buffer."""
    code = ldpc.get_code(RATE)
    info = np.random.default_rng(1).integers(
        0, 2, (NCW, code.k)).astype(np.float32)
    cw = np.asarray(JL.encode(code, jnp.asarray(info)))
    cm = C.carrier_map(CFG_J)
    ci = channel_interleaver(len(cm.data_idx) * bits_per_symbol(MOD), code.n)
    inter = cw[:, ci.inv].reshape(1, -1)
    pre = JM.generate_preamble(CFG_J)
    data = np.asarray(JM.modulate(CFG_J, MOD, jnp.asarray(inter),
                                  t_offset=JM.preamble_data_t_offset(CFG_J)))[0]
    tx = np.zeros(LEAD + len(pre) + len(data) + TAIL, np.float32)
    tx[LEAD:LEAD + len(pre)] = pre
    tx[LEAD + len(pre):LEAD + len(pre) + len(data)] = data
    rx = jnp.broadcast_to(jnp.asarray(tx[None]), (8, len(tx)))
    rx = JW.watterson(jax.random.PRNGKey(3), rx, JW.good())
    rx = JW.add_noise_active(jax.random.PRNGKey(2), rx, 20.0)
    return info, np.asarray(rx)[[2, 7]]


def _span(rx):
    """The span decode_ofdm_cox cuts at lane 0's LTS (both lanes share the
    frame position), with its margins, and the detected CFO."""
    det = JSC.detect_preamble(CFG_J, jnp.asarray(rx))
    start = int(np.asarray(det["lts_start"])[0])
    S = JP.num_data_symbols(CFG_J, MOD, NCW)
    end = start + 2 * PLEN + S * CFG_J.symbol_duration
    lead = 2 * PLEN if start >= 2 * PLEN else PLEN if start >= PLEN else 0
    avail = rx.shape[-1] - end
    tail = 2 * PLEN if avail >= 2 * PLEN else PLEN if avail >= PLEN else 0
    return (rx[:, start - lead:end + tail], np.asarray(det["cfo_hz"]), S,
            lead, tail)


def test_host_tables_match():
    for a, b in zip(TDF._host_tables(CFG_T), JDF._host_tables(CFG_J)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for S in (1, 3, 5, 9, 44):
        np.testing.assert_array_equal(TDF._smooth_matrix(S),
                                      JDF._smooth_matrix(S))
    np.testing.assert_array_equal(TDF.TAU_GRID, JDF.TAU_GRID)
    assert (TDF.K_TAPS, TDF.RIDGE, TDF.SMOOTH_W, TDF.TAU_EXCLUDE) == \
        (JDF.K_TAPS, JDF.RIDGE, JDF.SMOOTH_W, JDF.TAU_EXCLUDE)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_solve_herm_matches_jax(k):
    rng = np.random.default_rng(k)
    X = (rng.standard_normal((4, 6, k)) + 1j * rng.standard_normal((4, 6, k)))
    A = (np.conj(X.transpose(0, 2, 1)) @ X + 0.1 * np.eye(k)).astype(
        np.complex64)
    b = (rng.standard_normal((4, k, 5))
         + 1j * rng.standard_normal((4, k, 5))).astype(np.complex64)
    ref = np.asarray(JDF._solve_herm(jnp.asarray(A), jnp.asarray(b)))
    ours = TDF._solve_herm(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(A @ ours, b, rtol=1e-3, atol=1e-4)


def test_span_fd_and_delayfit_match_jax(good_lanes):
    """span_fd on the Good-channel span, then demod_delayfit on JAX's own
    bins in both packages (so the second pass is held alone)."""
    _, rx = good_lanes
    span, cfo, S, lead, tail = _span(rx)
    ref_fd = JDF.span_fd(CFG_J, MOD, jnp.asarray(span), jnp.asarray(cfo), 0.0,
                         n_lts=2, S=S, lead=lead, tail=tail, front="real")
    fd = TDF.span_fd(CFG_T, MOD, torch.from_numpy(span), torch.from_numpy(cfo),
                     0.0, n_lts=2, S=S, lead=lead, tail=tail, front="real")
    np.testing.assert_allclose(fd.numpy(), np.asarray(ref_fd), rtol=1e-4,
                               atol=1e-4)
    n_bits = NCW * 648
    ref = np.asarray(JDF.demod_delayfit(CFG_J, MOD, ref_fd, n_bits))
    ours = TDF.demod_delayfit(CFG_T, MOD, torch.from_numpy(
        np.asarray(ref_fd)), n_bits).numpy()
    assert ours.shape == ref.shape == (2, n_bits)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=2e-4)


def test_delayfit_retry_recovers_codewords_as_jax(good_lanes):
    """The retry end to end (tests/test_delay_fit.py:77-97): the standard
    real-front pass and the delay-fit pass of each package, every
    codeword decoded with trap_escape by that package's decoder; ok flags
    and bits identical, and the retry recovers codewords the standard pass
    loses."""
    info, rx = good_lanes
    code = ldpc.get_code(RATE)
    cm = C.carrier_map(CFG_J)
    perm = channel_interleaver(len(cm.data_idx) * bits_per_symbol(MOD),
                               code.n).perm
    tcode = TLC.get_code(TC.CodeRate(int(RATE)))

    def oks(llr_j, llr_t):
        bj = np.asarray(llr_j)[:, :NCW * code.n].reshape(-1, code.n)[:, perm]
        out_j, ok_j, _ = JL.decode(code, jnp.asarray(bj), trap_escape=True)
        bt = llr_t[:, :NCW * code.n].reshape(-1, code.n)[:, perm]
        out_t, ok_t, _ = TL.decode(tcode, bt.contiguous(), trap_escape=True)
        np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        exact = (out_t.numpy().reshape(2, NCW, -1)
                 == info.astype(np.uint8)[None]).all(-1)
        return ok_t.numpy().reshape(2, NCW) & exact

    std_j, _ = JSC.decode_ofdm_cox(CFG_J, MOD, jnp.asarray(rx), NCW,
                                   front="real")
    std_t, _ = TSC.decode_ofdm_cox(CFG_T, MOD, torch.from_numpy(rx), NCW,
                                   front="real")
    np.testing.assert_allclose(std_t.numpy()[:, :NCW * 648],
                               np.asarray(std_j)[:, :NCW * 648], rtol=1e-4,
                               atol=2e-4)
    ok_std = oks(std_j, std_t)

    span, cfo, S, lead, tail = _span(rx)
    df_j = JDF.demodulate_span_delayfit(CFG_J, MOD, jnp.asarray(span),
                                        jnp.asarray(cfo), 0.0, n_lts=2, S=S,
                                        lead=lead, tail=tail, front="real",
                                        n_bits=NCW * 648)
    df_t = TDF.demodulate_span_delayfit(CFG_T, MOD, torch.from_numpy(span),
                                        torch.from_numpy(cfo), 0.0, n_lts=2,
                                        S=S, lead=lead, tail=tail,
                                        front="real", n_bits=NCW * 648)
    np.testing.assert_allclose(df_t.numpy(), np.asarray(df_j), rtol=1e-4,
                               atol=2e-4)
    ok_df = oks(df_j, df_t)
    base, uni = int(ok_std.sum()), int((ok_std | ok_df).sum())
    assert uni - base >= 4 and uni >= 8, (base, uni)

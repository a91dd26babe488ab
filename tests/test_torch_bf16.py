"""The bf16 fast modes of the PyTorch port against the JAX package, and the
last PHY helpers.

* LDPC bf16 edge messages: the port's plain decoder with
  ``msg_dtype=torch.bfloat16`` against JAX ``decode(msg_dtype=
  jnp.bfloat16)`` on the same numpy BPSK LLRs: info bits, ok flags and
  iteration counts equal on every lane (R1/2 at sigma 0.5 and 0.72, an
  R1/2 waterfall batch with ``trap_escape``, one batch each of R1/4,
  R2/3, R3/4 and R5/6); tests/test_ldpc.py's two rate gates run on the
  port; the module default follows ``ULTRA_LDPC_BF16`` and
  ``default_msg_dtype``.
* Chirp acquisition in the bf16 mode on JAX-made buffers (the scenarios
  of tests/test_torch_chirp.py): ``found``, every position, ``cfo_hz``
  exact, refined correlations within rtol 1e-4 (float32 sums of the same
  rounded products in another order); the bf16 decimation within 1e-5 of
  the peak; one chirp-cell decode (MC-DPSK level10, R1/4, 5 dB, B = 32)
  with both modes on: every frame decoded with exact bits.
* ``ofdm/modulator.samples_per_symbol`` and ``bits_per_ofdm_symbol``
  equal to JAX's for every preset config and modulation.

JAX reads ULTRA_CHIRP_BF16 and ULTRA_LDPC_BF16 at import, so both are
removed before it is imported.  JAX's chirp flag is a module global read
while ``detect_dual_chirp`` is traced, so the chirp fixture sets it,
clears JAX's compilation caches before and after, and restores it: no
bf16 trace reaches another test's float32 parity check in the same
worker.  LDPC needs none of this (``msg_dtype`` is an argument of JAX's
``decode``).
"""

import os

for _flag in ("ULTRA_CHIRP_BF16", "ULTRA_LDPC_BF16"):
    os.environ.pop(_flag, None)

import dataclasses  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from projectultra_tpu import config as JCFG  # noqa: E402
from projectultra_tpu.fec import ldpc as JF  # noqa: E402
from projectultra_tpu.ofdm import modulator as JM  # noqa: E402
from projectultra_tpu.ofdm import pipeline as JP  # noqa: E402
from projectultra_tpu.ops import ldpc as JL  # noqa: E402
from projectultra_tpu.sim import watterson as JW  # noqa: E402
from projectultra_tpu.sync import chirp as JC  # noqa: E402

from projectultra_tpu_torch import config as TCFG  # noqa: E402
from projectultra_tpu_torch.fec import ldpc as TF  # noqa: E402
from projectultra_tpu_torch.ofdm import modulator as TM  # noqa: E402
from projectultra_tpu_torch.ofdm import pipeline as TP  # noqa: E402
from projectultra_tpu_torch.ops import ldpc as TL  # noqa: E402
from projectultra_tpu_torch.psk import mc_dpsk as TMC  # noqa: E402
from projectultra_tpu_torch.sim import watterson as TW  # noqa: E402
from projectultra_tpu_torch.sync import chirp as TC  # noqa: E402

R = JCFG.CodeRate


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# LDPC: bf16 edge messages
# ---------------------------------------------------------------------------

def _bpsk_llrs(rate, sigma, B, seed):
    """LLRs 2y/sigma^2 of B random codewords over BPSK AWGN (numpy)."""
    code = JF.get_code(rate)
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (B, code.k)).astype(np.uint8)
    parity = (info.astype(np.int64) @ code.h_dense.T.astype(np.int64)) & 1
    cw = np.concatenate([info, parity.astype(np.uint8)], axis=1)
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)
    return info, (2.0 * y / sigma ** 2).astype(np.float32)


# (rate, sigma, B, seed, trap_escape, extra lanes): R1/2 at test_ldpc.py's
# two sigmas, its waterfall with the retry, and one batch of every other
# rate in its own waterfall (some lanes converge at once, some iterate,
# some never do).  bf16 rounding seldom changes a lane's outcome, so the
# waterfall batches are B lanes of a larger numpy batch plus the lanes of
# it where JAX's bf16 and float32 decodes differ (found by decoding the
# whole batch both ways with JAX; the test checks they still differ).
LDPC_CASES = [
    (R.R1_2, 0.5, 96, (250, 96), False, ()),
    (R.R1_2, 0.72, 64, (7, 1024), False, (53, 68, 85, 105, 306, 327, 330, 362)),
    (R.R1_2, 0.62, 58, (7, 2048), True, (358, 444, 1010, 1037, 1237, 2045)),
    (R.R1_4, 1.1, 56, (7, 1024), False, (184, 194, 269, 377, 412, 495, 521,
                                         626)),
    (R.R2_3, 0.55, 64, (365, 64), False, ()),
    (R.R3_4, 0.5, 64, (450, 64), False, ()),
    (R.R5_6, 0.45, 64, (545, 64), False, ())]


@pytest.mark.parametrize("rate,sigma,B,batch,trap,extra", LDPC_CASES,
                         ids=[f"{c[0].name}-{c[1]}{'-trap' if c[4] else ''}"
                              for c in LDPC_CASES])
def test_bf16_decode_equals_jax_lane_for_lane(rate, sigma, B, batch, trap,
                                              extra):
    """``batch`` = (numpy seed, lanes drawn); the test decodes the first B
    of them and the ``extra`` ones."""
    seed, drawn = batch
    _, llrs = _bpsk_llrs(rate, sigma, drawn, seed)
    llrs = llrs[list(range(B)) + list(extra)]
    ref = JL.decode(JF.get_code(rate), jnp.asarray(llrs),
                    msg_dtype=jnp.bfloat16, trap_escape=trap)
    ours = TL.decode(TF.get_code(rate), _t(llrs), msg_dtype=torch.bfloat16,
                     trap_escape=trap)
    for name, a, b in zip(("bits", "ok", "iters"), ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    iters = ours[2].numpy()
    assert (iters > 1).any(), "the batch must iterate"
    if extra:
        f32 = JL.decode(JF.get_code(rate), jnp.asarray(llrs),
                        msg_dtype=jnp.float32, trap_escape=trap)
        differ = (np.asarray(f32[2]) != iters) \
            | (np.asarray(f32[0]) != ours[0].numpy()).any(1)
        assert differ[B:].any(), "no lane where bf16 changes the outcome"


def test_bf16_decode_rounds_the_messages():
    """bf16 and float32 messages give different totals on a batch that
    iterates, and the bf16 run of the plain decoder is what decode gives
    through the module default set by ``default_msg_dtype``."""
    _, llrs = _bpsk_llrs(R.R1_2, 0.72, 32, seed=3)
    code = TF.get_code(R.R1_2)
    graph = TL.graph_for(code, torch.device("cpu"))
    f32 = TL.decode_plain(graph, _t(llrs))
    b16 = TL.decode_plain(graph, _t(llrs), msg_dtype=torch.bfloat16)
    assert not torch.equal(f32[0], b16[0])
    assert TL._DEFAULT_MSG_DTYPE == torch.float32
    with TL.default_msg_dtype(torch.bfloat16):
        dflt = TL.decode_totals(graph, _t(llrs))
    assert TL._DEFAULT_MSG_DTYPE == torch.float32
    for a, b in zip(dflt, b16):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        TL.decode_plain(graph, _t(llrs), msg_dtype=torch.float16)


def test_ldpc_bf16_switch_is_read_at_import():
    code = ("import torch\n"
            "from projectultra_tpu_torch.ops import ldpc\n"
            "print(ldpc._DEFAULT_MSG_DTYPE == torch.bfloat16)\n")
    for value, want in (("1", "True"), ("0", "False")):
        env = {**os.environ, "ULTRA_LDPC_BF16": value}
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120,
                             cwd=os.path.dirname(os.path.dirname(
                                 os.path.abspath(__file__))))
        assert out.stdout.strip() == want, out.stderr


def _rate_gate_batch(sigma, rng, cw):
    noise = rng.normal(0, sigma, cw.shape)
    return _t((2.0 / sigma ** 2) * ((1.0 - 2.0 * cw) + noise)).to(torch.float32)


def test_bf16_rate_gates_of_test_ldpc_on_the_port():
    """tests/test_ldpc.py:124-162 on the port: at sigma 0.5 bf16 decodes
    within 0.02 of float32 with equal bits where both decode; at sigma
    0.72 the two rates are within 0.04."""
    code = TF.get_code(R.R1_2)
    rng = np.random.default_rng(9)
    B = 256
    info = _t(rng.integers(0, 2, (B, code.k)).astype(np.float32))
    cw = TL.encode(code, info).numpy()
    llrs = _rate_gate_batch(0.5, rng, cw)
    out32, ok32, _ = TL.decode(code, llrs, msg_dtype=torch.float32)
    out16, ok16, _ = TL.decode(code, llrs, msg_dtype=torch.bfloat16)
    assert float(ok32.float().mean()) >= 0.97
    assert float(ok16.float().mean()) >= float(ok32.float().mean()) - 0.02
    both = ok32 & ok16
    assert torch.equal(out16[both], out32[both])

    llrs = _rate_gate_batch(0.72, rng, cw)
    _, ok32, _ = TL.decode(code, llrs, msg_dtype=torch.float32)
    _, ok16, _ = TL.decode(code, llrs, msg_dtype=torch.bfloat16)
    r32, r16 = float(ok32.float().mean()), float(ok16.float().mean())
    assert abs(r32 - r16) <= 0.04, (r32, r16)


# ---------------------------------------------------------------------------
# Chirp acquisition: the bf16 mode
# ---------------------------------------------------------------------------

@pytest.fixture
def chirp_bf16():
    """JAX's and the port's chirp bf16 mode on for one test."""
    assert JC._BF16 is False and TC._BF16 is False
    jax.clear_caches()
    JC._BF16 = True
    try:
        with TC.bf16_mode():
            yield
    finally:
        JC._BF16 = False
        jax.clear_caches()
    assert TC._BF16 is False


CHIRP_CONFIGS = {"default": {}, "short": {"duration_ms": 100.0}}


def _cfgs(name):
    kw = CHIRP_CONFIGS[name]
    return JC.ChirpConfig(**kw), TC.ChirpConfig(**kw)


def _detect_both(name, x, threshold=0.15):
    jc, tc = _cfgs(name)
    ref = JC.detect_dual_chirp(jc, jnp.asarray(x), threshold=threshold)
    ours = TC.detect_dual_chirp(tc, _t(x), threshold=threshold)
    assert ours.keys() == ref.keys()
    for key in ("success", "up_chirp_start", "down_chirp_start",
                "first_strong_up", "next_up_start", "cfo_hz"):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
        assert ours[key].numpy().dtype == np.asarray(ref[key]).dtype, key
    for key in ("up_correlation", "down_correlation"):
        assert ours[key].dtype == torch.float32
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-4, atol=0, err_msg=key)
    return {k: v.numpy() for k, v in ours.items()}


def test_bf16_decimate_matches_jax(chirp_bf16):
    jc, tc = _cfgs("default")
    x = np.random.default_rng(11).standard_normal((3, 20003)).astype(np.float32)
    ref = np.asarray(JC._decimate(jc, jnp.asarray(x)))
    ours = TC._decimate(tc, _t(x)).numpy()
    assert ours.dtype == np.complex64 and ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()
    with TC.bf16_mode(False):
        f32 = TC._decimate(tc, _t(x)).numpy()
    assert np.abs(f32 - ours).max() > 1e-4 * np.abs(ref).max()


def test_bf16_detect_matches_jax_at_three_offsets_and_cfos(chirp_bf16):
    """Chirps at 3,000, 11,111 and 30,005 with 0, 17 and -40 Hz of TX CFO
    in 0.05 noise (tests/test_chirp_fast_parity.py:34-56)."""
    for name in CHIRP_CONFIGS:
        jc, _ = _cfgs(name)
        rng = np.random.default_rng(42)
        T = jc.total_samples + 40000
        rows = []
        for off, cfo in zip([3000, 11111, 30005], [0.0, 17.0, -40.0]):
            c = JC.generate(dataclasses.replace(jc, tx_cfo_hz=cfo))
            sig = np.zeros(T, np.float32)
            sig[off:off + len(c)] = c
            rows.append(sig + rng.normal(0, 0.05, T).astype(np.float32))
        det = _detect_both(name, np.stack(rows))
        assert det["success"].all()
        assert np.abs(det["up_chirp_start"] - [3000, 11111, 30005]).max() <= 3


def test_bf16_detect_matches_jax_on_noise_and_weak_chirps(chirp_bf16):
    """Noise only; the weak threshold 0.08 at -20 dB on JAX's noise; an
    early 0.2x chirp ahead of a full one (tests/test_chirp_sync.py:66-89),
    whose bf16 coarse correlations tie often."""
    jc, _ = _cfgs("short")
    x = np.random.default_rng(1).normal(
        0, 0.3, (3, jc.total_samples + 30000)).astype(np.float32)
    assert not _detect_both("short", x)["success"].any()

    jc, _ = _cfgs("default")
    c = JC.generate(jc)
    sig = np.zeros((3, jc.total_samples + 30000), np.float32)
    sig[:, 5000:5000 + len(c)] = c
    x = np.asarray(JW.add_noise_active(jax.random.PRNGKey(3),
                                       jnp.asarray(sig), -20.0))
    det = _detect_both("default", x, threshold=0.08)
    assert det["success"].all()

    buf = np.zeros(200000, np.float32)
    buf[5000:5000 + len(c)] = 0.2 * c
    buf[120000:120000 + len(c)] = c
    x = np.asarray(JW.add_noise_active(jax.random.PRNGKey(0),
                                       jnp.asarray(buf[None, :]), 10.0))
    det = _detect_both("default", x)
    assert det["success"][0]
    assert abs(int(det["next_up_start"][0]) - 120000) < 200


def test_bf16_detect_matches_jax_with_hilbert_cfo(chirp_bf16):
    """30 Hz of harness CFO and 5 dB of JAX's noise, two frames and a row
    of silence (tests/test_chirp_sync.py:43-55)."""
    jc, _ = _cfgs("short")
    c = JC.generate(jc)
    sig = np.zeros((3, jc.total_samples + 20000), np.float32)
    sig[0, 9000:9000 + len(c)] = c
    sig[1, 2345:2345 + len(c)] = c
    shifted = JW.apply_cfo_hilbert(jnp.asarray(sig), jnp.full((3,), 30.0))
    x = np.asarray(JW.add_noise_active(jax.random.PRNGKey(0), shifted, 5.0))
    det = _detect_both("short", x)
    assert det["success"][:2].all() and not det["success"][2]


def test_bf16_refine_rounds_like_jax(chirp_bf16):
    """The refine's normalised correlations against JAX's block-aligned
    ones at the same window starts (the 128-aligned gather picks the same
    rounded products)."""
    jc, tc = _cfgs("default")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 60000)).astype(np.float32)
    start = np.array([[0, 131], [4097, 60000 - 24024]], np.int32)
    _, _, e_up, _ = JC._templates(jc)
    ref = np.asarray(JC._corr_aligned(jc, jnp.asarray(x), jnp.asarray(start),
                                      "up", e_up))
    kc_up, _, ke = TC._refine_on(tc, torch.device("cpu"), True)
    ours = TC._corr_bf16(tc, _t(x), _t(start).to(torch.int64), kc_up, ke,
                         e_up).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-7)


def test_bf16_chirp_cell_decodes_exactly():
    """The chirp cell (MC-DPSK level10, R1/4, 5 dB) at B = 32 with both
    bf16 modes on: every frame decoded, exact bits."""
    mc = TMC.level10()
    code = TF.get_code(R.R1_4)
    g = torch.Generator().manual_seed(31)
    info = torch.randint(0, 2, (32, code.k), generator=g, dtype=torch.uint8)
    tx = TMC.tx_chirp_frame(mc, R.R1_4, info)
    rx = TW.add_noise_active(tx, 5.0, torch.Generator().manual_seed(33))
    with TC.bf16_mode(), TL.default_msg_dtype(torch.bfloat16):
        out, ok, _, det = TMC.decode_chirp_batch(mc, R.R1_4, rx)
    assert TC._BF16 is False and TL._DEFAULT_MSG_DTYPE == torch.float32
    assert float(ok.float().mean()) >= 0.99
    assert bool(det["success"].all())
    assert torch.equal(out[ok], info[ok])


# ---------------------------------------------------------------------------
# ofdm/modulator helpers
# ---------------------------------------------------------------------------

PRESETS = ["ModemConfig", "conservative", "balanced", "turbo",
           "high_throughput", "nvis_mode"]


def _preset_pairs():
    pairs = [(getattr(JCFG, p)(), getattr(TCFG, p)()) for p in PRESETS]
    pairs += [(JCFG.for_profile(p), TCFG.for_profile(TCFG.SpeedProfile(int(p))))
              for p in JCFG.SpeedProfile]
    pairs.append((JP.chirp_ofdm_config(), TP.chirp_ofdm_config()))
    return pairs


def test_modulator_helpers_equal_jax():
    for jcfg, tcfg in _preset_pairs():
        assert TM.samples_per_symbol(tcfg) == JM.samples_per_symbol(jcfg)
        for mod in JCFG.Modulation:
            assert TM.bits_per_ofdm_symbol(tcfg, TCFG.Modulation(int(mod))) \
                == JM.bits_per_ofdm_symbol(jcfg, mod), (jcfg, mod)

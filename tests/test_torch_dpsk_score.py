"""DPSK's differential pattern score (ops/dpsk_score.py) on the CPU.

The CUDA kernel (csrc/dpsk_score.cu) runs only on the card
(tests/test_torch_cuda.py holds it to the plain version there); here:

* ``dpsk_score_plain`` against a float64 numpy evaluation of the JAX
  package's formula (projectultra_tpu/psk/dpsk.py:305-317: the [B, O, 39]
  gather summed over its last axis) on seeded correlations, within 2e-6
  (scores lie in [0, 1]; float32 sums of 38 unit terms), with zeros
  exactly where the reference has them;
* ``find_preamble`` on the CPU equal to the JAX function on ``fast``,
  ``medium`` and ``robust`` buffers, with and without ``valid_len``
  (found and data_start exact; the tolerances of test_torch_dpsk.py);
* a torch model of the kernel's order -- every differential and energy
  computed once per sample, in the kernel's tiles of residues and symbol
  indices and its chunks of eight offsets, the signs applied as negations
  -- bit-equal to ``dpsk_score_plain``;
* one NaN and one +inf correlation: zeros and NaNs at the offsets whose
  symbols hold the sample, in the plain version and in the model;
* dispatch: a CPU tensor takes the plain version and never loads the
  kernel's library; other devices and malformed arguments raise.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from projectultra_tpu.psk import dpsk as JD  # noqa: E402

from projectultra_tpu_torch.ops import cuda_dpsk  # noqa: E402
from projectultra_tpu_torch.ops import dpsk_score as DS  # noqa: E402
from projectultra_tpu_torch.psk import dpsk as TD  # noqa: E402

from test_torch_dpsk import assert_detection_equal, sweep_frames  # noqa: E402

N_SYM = 39
SIGNS = TD.EXPECTED_SIGNS
MIN_E = TD.MIN_SYMBOL_ENERGY
SCORE_ATOL = 2e-6
# (L, B, O): the kernel's presets' symbol lengths, one and three rows, O
# ragged against every tile and below one 128-offset block.
SHAPES = [(64, 1, 100), (64, 3, 1000), (384, 3, 5000), (384, 1, 127),
          (768, 3, 2 * 768 + 5), (768, 1, 121_000)]


def correlations(L, B, O, seed=0, quiet=True):
    """[B, O + 38 L + 7] complex64 symbol correlations: unit-scale normals
    with exact zeros in single samples (zero differentials) and the
    preamble's 39 symbols (rotated by a CFO) at offset O // 3; with
    ``quiet`` the samples from O // 2 on are faint (1e-3) and those from
    2 O // 3 on silent, so that the offsets there score 0 by the energy
    threshold (the faint ones with differentials of full magnitude)."""
    rng = np.random.default_rng(seed)
    n = O + (N_SYM - 1) * L + 7
    c = (rng.standard_normal((B, n)) + 1j * rng.standard_normal((B, n))) \
        .astype(np.complex64)
    if quiet:
        c[:, O // 2:] *= np.float32(1e-3)
        c[:, 2 * O // 3:] = 0
    c[:, rng.integers(0, n, 5)] = 0
    phases = np.cumsum(np.where(np.concatenate([[1.0], SIGNS]) < 0, np.pi,
                                0.0)) + 0.3 * np.arange(N_SYM)
    c[:, O // 3 + np.arange(N_SYM) * L] = 2.0 * np.exp(1j * phases)
    return c


def jax_formula(c, L, O):
    """The JAX package's score in float64 numpy."""
    c = c.astype(np.complex128)
    idx = np.arange(O)[:, None] + np.arange(N_SYM)[None, :] * L
    syms = c[:, idx]                                    # [B, O, 39]
    diff = syms[..., 1:] * np.conj(syms[..., :-1])
    mag = np.abs(diff)
    dn = np.where(mag > 1e-10, diff / np.maximum(mag, 1e-30), 0.0)
    score = np.abs((dn * SIGNS.astype(np.float64)).sum(-1)) / (N_SYM - 1)
    energy = (np.abs(syms) ** 2).sum(-1)
    return np.where(energy >= MIN_E * N_SYM, score, 0.0)


def plain(c, L, O):
    return DS.dpsk_score_plain(torch.from_numpy(c), L, N_SYM, O, SIGNS, MIN_E)


@pytest.mark.parametrize("L,B,O", SHAPES)
def test_plain_score_matches_the_jax_formula(L, B, O):
    c = correlations(L, B, O, seed=L + B)
    got = plain(c, L, O).numpy()
    want = jax_formula(c, L, O)
    assert got.shape == (B, O) and got.dtype == np.float32
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
    assert (want == 0.0).any() and (want > 0.5).any()
    err = float(np.abs(got - want).max())
    print(f"L={L} B={B} O={O}: max |plain - float64 JAX formula| = {err!r}")
    assert err <= SCORE_ATOL


# ---------------------------------------------------------------------------
# find_preamble through the dispatcher against the JAX function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset,snr,B", [("fast", 0.0, 2),
                                          ("medium", 0.0, 2),
                                          ("robust", -11.0, 1)])
def test_find_preamble_matches_jax(preset, snr, B):
    """run_point_dpsk's buffers (JAX-made), the whole buffer valid and a
    valid length that ends inside the last row's preamble."""
    _, rx = sweep_frames(preset, snr, B, seed=17)
    cfg_j, cfg_t = getattr(JD, preset)(), getattr(TD, preset)()
    cut = 4800 + cfg_t.preamble_samples // 2
    valid = np.array([rx.shape[1]] * (B - 1) + [cut], np.int32)
    for vl in (None, valid):
        ref = JD.find_preamble(cfg_j, jnp.asarray(rx), valid_len=None
                               if vl is None else jnp.asarray(vl))
        ours = TD.find_preamble(cfg_t, torch.from_numpy(rx), valid_len=None
                                if vl is None else torch.from_numpy(vl))
        assert_detection_equal(ours, ref)
        if vl is None:
            assert bool(ours[0].all())
        else:
            assert bool(ours[0][:B - 1].all()) and not bool(ours[0][B - 1])


# ---------------------------------------------------------------------------
# The kernel's order, modelled in torch on the CPU
# ---------------------------------------------------------------------------

CHUNK = 8  # kChunk in csrc/dpsk_score.cu


def differentials(cur, prev):
    """The plain version's dn for cur * conj(prev), elementwise."""
    diff = cur * prev.conj()
    mag = diff.abs()
    return torch.where(mag > 1e-10, diff / torch.clamp(mag, min=1e-30), 0.0)


def kernel_model(corr, L, O, sms=132):
    """csrc/dpsk_score.cu's walk on the CPU: blocks of 32 residues and
    ``cuda_dpsk.tile_for`` symbol indices, each computing D and E of its
    rows once (zeros past the row) and summing chunks of eight offsets, a
    term at a time in the plain version's order, the signs applied as
    negations.  Returns the score and how often each offset was written."""
    B, n_corr = corr.shape
    K = -(-O // L)
    tile = cuda_dpsk.tile_for(B, L, O, sms)
    assert 1 <= tile <= cuda_dpsk.MAX_TILE
    rows = -(-tile // CHUNK) * CHUNK + cuda_dpsk.PAIRS
    score = torch.full((B, O), -1.0)
    writes = torch.zeros((B, O), dtype=torch.int64)
    for b in range(B):
        for r0 in range(0, L, cuda_dpsk.LANES):
            r = torch.arange(r0, r0 + cuda_dpsk.LANES)
            for k0 in range(0, K, tile):
                m = r[None, :] + (k0 + torch.arange(rows))[:, None] * L
                ok = (r[None, :] < L) & (m < n_corr)
                c = torch.where(ok, corr[b, m.clamp(max=n_corr - 1)], 0)
                E = c.abs() ** 2                            # [rows, 32]
                D = differentials(c[1:], c[:-1])            # [rows - 1, 32]
                kb = min(tile, K - k0)
                for q in range(0, kb, CHUNK):
                    for k in range(CHUNK):
                        acc = torch.zeros(cuda_dpsk.LANES,
                                          dtype=torch.complex64)
                        for j in range(cuda_dpsk.PAIRS):
                            d = D[q + k + j]
                            acc = acc + (d if SIGNS[j] > 0 else -d)
                        en = E[q + k]
                        for j in range(1, N_SYM):
                            en = en + E[q + k + j]
                        s = torch.where(en >= MIN_E * N_SYM,
                                        acc.abs() / cuda_dpsk.PAIRS, 0.0)
                        o = r + (k0 + q + k) * L
                        keep = (q + k < kb) & (r < L) & (o < O)
                        score[b, o[keep]] = s[keep]
                        writes[b, o[keep]] += 1
    return score, writes


@pytest.fixture
def one_thread():
    """PyTorch's CPU loops compute each run of a row in vectors (16
    complex64 values on AVX-512) and what is left of the run -- the last
    O % 16 offsets, or the values before a split of the work between
    threads -- with scalar code, whose complex division rounds otherwise
    in the last bit.  So on the CPU the plain version's differential of
    one sample can differ between the offsets that use it (on the card
    every element runs the same code).  One thread and rows of whole
    vectors keep every value of both versions on the vector path."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("L,B,O", [(64, 1, 96), (64, 3, 1024),
                                   (384, 3, 4992), (768, 2, 1536)])
def test_kernel_order_model_is_bit_equal_to_plain(one_thread, L, B, O):
    c = correlations(L, B, O, seed=3 * L + B)
    got, writes = kernel_model(torch.from_numpy(c), L, O)
    assert bool((writes == 1).all())
    torch.testing.assert_close(got, plain(c, L, O), rtol=0, atol=0)


@pytest.mark.parametrize("L,B,O,sms", [
    (64, 1, 100, 132), (384, 1, 127, 132),
    # 200 symbol indices of 64 samples: two tiles a row at three rows on
    # one SM, seven at B = 1 (tile_for fills the card)
    (64, 3, 200 * 64 - 3, 1), (64, 1, 200 * 64 - 3, 132)])
def test_kernel_order_model_on_ragged_rows(L, B, O, sms):
    """Ragged rows, several tiles a row, the default threads: every offset
    written once, zeros where the plain version's are, the rest within the
    kernel's tolerance (the plain version's scalar tails, above)."""
    c = correlations(L, B, O, seed=B + L)
    got, writes = kernel_model(torch.from_numpy(c), L, O, sms=sms)
    want = plain(c, L, O)
    assert bool((writes == 1).all())
    assert torch.equal(got == 0, want == 0)
    err = float((got - want).abs().max())
    print(f"L={L} B={B} O={O}: max |model - plain| = {err!r}")
    assert err <= SCORE_ATOL


# ---------------------------------------------------------------------------
# Non-finite correlations
# ---------------------------------------------------------------------------

# (L, B, O, row, sample): a Cox-like batch of short rows and an engine-like
# single long row, the sample inside the searched span.
NONFINITE_CASES = {"batch": (384, 3, 16_000, 1, 15_000),
                   "engine": (768, 1, 40_000, 0, 35_000)}


@pytest.mark.parametrize("kind", ["nan", "inf"])
@pytest.mark.parametrize("case", sorted(NONFINITE_CASES))
def test_nonfinite_correlation(case, kind):
    """A NaN sample zeroes the offsets whose 39 symbols hold it (its
    differentials are 0, its energy NaN); a +inf sample makes them NaN
    (its differentials inf/inf, its energy +inf).  Elsewhere finite; the
    kernel's model gives the same array."""
    L, B, O, row, m = NONFINITE_CASES[case]
    c = correlations(L, B, O, seed=11, quiet=False)
    c[row, m] = complex(float(kind), 0.0)
    got = plain(c, L, O)
    hit = torch.zeros((B, O), dtype=torch.bool)
    for j in range(N_SYM):
        if 0 <= m - j * L < O:
            hit[row, m - j * L] = True
    assert int(hit.sum()) == N_SYM
    if kind == "nan":
        assert bool((got[hit] == 0).all())
    else:
        assert bool(torch.isnan(got[hit]).all())
    assert bool(torch.isfinite(got[~hit]).all())
    if case == "batch":
        model, _ = kernel_model(torch.from_numpy(c), L, O)
        torch.testing.assert_close(model, got, rtol=0, atol=0,
                                   equal_nan=True)


# ---------------------------------------------------------------------------
# Dispatch and arguments
# ---------------------------------------------------------------------------

def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was loaded for a CPU "
                             "tensor")

    monkeypatch.setattr(cuda_dpsk.LIBRARY, "load", refuse)
    before = cuda_dpsk.launches
    c = correlations(64, 2, 300)
    got = DS.dpsk_score(torch.from_numpy(c), 64, N_SYM, 300, SIGNS, MIN_E)
    torch.testing.assert_close(got, plain(c, 64, 300), rtol=0, atol=0)
    assert cuda_dpsk.launches == before


def test_dispatch_refuses_other_devices():
    c = torch.zeros((1, 64 * 40), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError):
        DS.dpsk_score(c, 64, N_SYM, 10, SIGNS, MIN_E)


def test_arguments_are_checked_before_any_launch():
    c = torch.from_numpy(correlations(64, 1, 100))
    n = c.shape[1]
    for bad in (dict(O=n), dict(expected=SIGNS[:-1]),
                dict(expected=2 * SIGNS), dict(L=0)):
        args = dict(L=64, O=100, expected=SIGNS) | bad
        with pytest.raises(ValueError):
            DS.dpsk_score_plain(c, args["L"], N_SYM, args["O"],
                                args["expected"], MIN_E)
    with pytest.raises(ValueError):
        DS.dpsk_score_plain(c[0], 64, N_SYM, 100, SIGNS, MIN_E)
    # The kernel's wrapper refuses a CPU tensor before loading anything.
    with pytest.raises(ValueError):
        cuda_dpsk.dpsk_score_cuda(c, 64, N_SYM, 100, SIGNS, MIN_E)


@pytest.mark.parametrize("B,L,O,tile", [
    (256, 768, 156 * 768, 156),      # medium's buffers: one tile a row
    (64, 1536, 156 * 1536, 156),     # robust's
    (1, 768, 341 * 768, 31),         # the engine's search view (medium)
    (1, 64, 262_144, 32),            # a B = 1 row of 4,096 symbol indices
    (2, 384, 127, 1),
])
def test_tile_for(B, L, O, tile):
    assert cuda_dpsk.tile_for(B, L, O, 132) == tile
    K = -(-O // L)
    tiles = -(-K // tile)
    assert tile <= cuda_dpsk.MAX_TILE and (tiles - 1) * tile < K

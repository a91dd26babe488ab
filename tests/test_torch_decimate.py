"""Chirp acquisition's decimation kernel (ops/cuda_decimate.py,
csrc/chirp_decimate.cu) on the CPU.

The kernel runs only on the card (tests/test_torch_cuda.py holds it to the
plain version there); here:

* ``launch_plan`` at the shapes the port runs (the acquired cell's
  B = 2,048 x T = 83,808, B = 256 and 64 at that T, ragged rows of
  T = 20,003, the engine's B = 1 search view of 262,144 samples, rows
  shorter than the filter): every output of a row in exactly one tile,
  every tile's outputs in its block's threads, at most MAX_TILE outputs
  and MAX_THREADS threads a block, at least FILL blocks an SM where the
  rows hold that many tiles of one warp, and the shared memory within the
  48 KB a block gets without opting in;
* a numpy model of the kernel's walk -- each block staging its samples
  (zeros outside [0, T) and past its own outputs' windows), each thread's
  PER_THREAD outputs summed as float32 fused multiply-add chains over the taps
  in order -- writes every output once and stays within float32 rounding
  of ``_decimate_plain`` (1e-6 of the peak; the plain version sums the
  same products in another order), in float32 and in the bf16 mode
  (1e-5 of the peak);
* at one NaN, +inf or -inf sample the model is non-finite exactly where
  the plain version is, and of the same kind (the imaginary row's middle
  tap is exactly 0, so an infinite sample makes NaN there in both);
* dispatch: a CPU tensor takes ``_decimate_plain`` and never loads the
  kernel's library, in ``_decimate`` and in ``detect_dual_chirp``; the
  wrapper refuses a CPU tensor and malformed taps before loading anything;
* the source's fixed sizes match the wrapper's (the build's command:
  tests/test_torch_cuda_build.py).
"""

import re

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from projectultra_tpu_torch.ops import cuda_decimate as CD  # noqa: E402
from projectultra_tpu_torch.sync import chirp as TC  # noqa: E402

CFG = TC.ChirpConfig()
SMS = 132  # an H100's SMs


def plain(x: np.ndarray, bf16: bool = False) -> np.ndarray:
    with TC.bf16_mode(bf16):
        return TC._decimate_plain(CFG, torch.from_numpy(x)).numpy()


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16) \
        .to(torch.float32).numpy()


def fma32(a, b, c):
    """float32 fused multiply-add: the exact a * b + c rounded once (the
    float64 product of two float32 values is exact)."""
    return (np.float64(a) * b.astype(np.float64) + c).astype(np.float32)


def kernel_model(x: np.ndarray, bf16: bool = False, sms: int = SMS):
    """csrc/chirp_decimate.cu's walk: block (b, t) stages samples
    8*m0 - 64 + s for s < 64 * threads + 120, zero outside [0, T) and past
    the 8 * n_out + 120 its outputs read; thread i's output r
    (m0 + PER_THREAD * i + r) chains taps k = 0..127 over staged sample
    8 * (PER_THREAD * i + r) + k.  Returns
    (y [B, Tb] complex64, writes [B, Tb])."""
    B, T = x.shape
    plan = CD.launch_plan(B, T, sms)
    tile, tiles, threads = plan["tile"], plan["tiles"], plan["threads"]
    taps = TC._decim_filter(CFG)
    if bf16:
        x, taps = _bf16(x), _bf16(taps)
    Tb = -(-T // CD.DECIM)
    staged = CD.DECIM * CD.PER_THREAD * threads + CD.TAPS - CD.DECIM
    m0 = np.arange(tiles) * tile
    n_out = np.minimum(tile, Tb - m0)
    s = np.arange(staged)
    n = (CD.DECIM * m0 - CD.TAPS // 2)[:, None] + s[None, :]
    valid = (s[None, :] < (CD.DECIM * n_out + CD.TAPS - CD.DECIM)[:, None]) \
        & (n >= 0) & (n < T)
    stage = np.where(valid[None], x[:, np.clip(n, 0, T - 1)], 0.0) \
        .astype(np.float32)                          # [B, tiles, staged]
    outs = np.arange(threads * CD.PER_THREAD)        # PER_THREAD*i + r
    win = (CD.DECIM * outs)[:, None] + np.arange(CD.TAPS)[None, :]
    seg = stage[:, :, win]                           # [B, tiles, outs, K]
    acc_re = np.zeros(seg.shape[:-1], np.float32)
    acc_im = np.zeros(seg.shape[:-1], np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for k in range(CD.TAPS):
            acc_re = fma32(taps[0, k], seg[..., k], acc_re)
            acc_im = fma32(taps[1, k], seg[..., k], acc_im)
    y = np.zeros((B, Tb, 2), np.float32)  # interleaved, as the kernel writes
    writes = np.zeros((B, Tb), np.int64)
    for t in range(tiles):
        keep = outs[outs < n_out[t]]
        y[:, m0[t] + keep, 0] = acc_re[:, t, keep]
        y[:, m0[t] + keep, 1] = acc_im[:, t, keep]
        writes[:, m0[t] + keep] += 1
    return y.view(np.complex64)[..., 0], writes


def samples(B: int, T: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((B, T)) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# The launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T", [
    (2048, 83808),    # the acquired cell
    (256, 83808),     # bench_torch.py, the sweeps, chip_smoke.py
    (64, 83808),
    (3, 20003),       # ragged rows, unaligned starts
    (1, 262144),      # the engine's search view (ACQ_VIEW_CAP)
    (1, 4800),
    (2, 100),         # shorter than the filter
    (5, 8),
    (1, 1),
])
def test_launch_plan_covers_every_output_once(B, T):
    plan = CD.launch_plan(B, T, SMS)
    Tb = -(-T // CD.DECIM)
    tile, tiles, threads = plan["tile"], plan["tiles"], plan["threads"]
    assert tile % CD.PER_THREAD == 0 and 0 < tile <= CD.MAX_TILE
    assert threads % CD.WARP == 0 and 0 < threads <= CD.MAX_THREADS
    assert threads * CD.PER_THREAD >= tile > (threads - CD.WARP) \
        * CD.PER_THREAD
    covered = np.zeros(Tb, np.int64)
    for t in range(tiles):
        covered[t * tile:min((t + 1) * tile, Tb)] += 1
    assert (covered == 1).all()
    assert plan["blocks"] == B * tiles
    assert plan["blocks"] >= min(CD.FILL * SMS, B * -(-Tb // CD.MIN_TILE))
    assert plan["shared_bytes"] <= 48 * 1024


def test_launch_plan_at_the_cell_and_the_engine_view():
    """The shapes the source's note names."""
    cell = CD.launch_plan(2048, 83808, SMS)
    assert (cell["tile"], cell["tiles"], cell["threads"], cell["blocks"],
            cell["shared_bytes"]) == (500, 21, 128, 43008, 18976)
    view = CD.launch_plan(1, 262144, SMS)
    assert (view["tile"], view["tiles"], view["threads"]) == (128, 256, 32)


# ---------------------------------------------------------------------------
# The kernel's walk against the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T,sms", [
    (2, 100, SMS),
    (3, 20003, SMS),
    (1, 33000, SMS),     # a B = 1 row of one-warp tiles
    (2, 20000, 1),       # tiles of 512 and a ragged last tile
    (1, 7, SMS),
])
def test_kernel_model_equals_plain(B, T, sms):
    x = samples(B, T, T + B)
    got, writes = kernel_model(x, sms=sms)
    want = plain(x)
    assert got.shape == want.shape == (B, -(-T // 8))
    assert (writes == 1).all()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("B,T", [(3, 20003), (2, 100)])
def test_kernel_model_equals_plain_in_the_bf16_mode(B, T):
    x = samples(B, T, 7 * T)
    got, _ = kernel_model(x, bf16=True)
    want = plain(x, bf16=True)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # and the mode rounds: the float32 outputs differ by more
    assert np.abs(plain(x) - want).max() > 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("kind", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("where", [0, 5, 4000, 20002])
def test_kernel_model_at_a_nonfinite_sample(kind, where):
    x = samples(2, 20003, 11)
    x[1, where] = kind
    got, _ = kernel_model(x)
    want = plain(x)
    for part in (np.real, np.imag):
        g, w = part(got), part(want)
        assert (np.isfinite(g) == np.isfinite(w)).all()
        assert (np.isnan(g) == np.isnan(w)).all()
        assert (np.isinf(g) == np.isinf(w)).all()
        assert (np.sign(g[np.isinf(g)]) == np.sign(w[np.isinf(w)])).all()
    bad = ~np.isfinite(want[1])
    m = np.arange(want.shape[1])
    # exactly the outputs whose windows [8m - 64, 8m + 64) hold the sample
    assert (bad == ((8 * m - 64 <= where) & (where < 8 * m + 64))).all()
    assert np.isfinite(want[0]).all()


# ---------------------------------------------------------------------------
# Dispatch and arguments
# ---------------------------------------------------------------------------

def _refuse_library(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was loaded for a CPU "
                             "tensor")

    monkeypatch.setattr(CD.LIBRARY, "load", refuse)


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    _refuse_library(monkeypatch)
    before = CD.launches
    x = samples(2, 4001, 3)
    got = TC._decimate(CFG, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, plain(x))
    assert CD.launches == before


def test_cpu_detection_never_reaches_the_library(monkeypatch):
    _refuse_library(monkeypatch)
    before = CD.launches
    chirp = TC.generate(CFG)
    x = np.zeros((2, 2 * len(chirp)), np.float32)
    x[:, 3000:3000 + len(chirp)] = chirp
    det = TC.detect_dual_chirp(CFG, torch.from_numpy(x))
    assert bool(det["success"].all())
    assert CD.launches == before


def test_wrapper_refuses_before_loading_anything(monkeypatch):
    _refuse_library(monkeypatch)
    taps = TC._decim_filter(CFG)
    x = torch.zeros((2, 100))
    for bad, match in ((x.double(), "float32"), (x[0], r"\[B, T\]"),
                       (x[:, ::2], "column stride"),
                       (x[:1].expand(2, 100), "overlap"), (x, "CUDA")):
        with pytest.raises(ValueError, match=match):
            CD.decimate_cuda(bad, taps)
    for bad in (taps[:, :64], taps.astype(np.float64), taps[0]):
        with pytest.raises(ValueError, match="taps"):
            CD.decimate_cuda(x, bad)


def test_source_sizes_match_the_wrapper():
    src = CD.SOURCE.read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("kDecim")) == CD.DECIM
    assert int(const("kTaps")) == CD.TAPS
    assert int(const("kPerThread")) == CD.PER_THREAD
    assert int(const("kWarp")) == CD.WARP
    assert const("kMaxThreads") == f"{CD.MAX_THREADS // CD.WARP} * kWarp"

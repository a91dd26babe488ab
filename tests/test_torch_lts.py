"""Schmidl-Cox LTS fine timing (ops/cuda_lts.py, csrc/lts_timing.cu) on the
CPU.

The kernel runs only on the card (tests/test_torch_cuda.py holds it to the
plain version there); here:

* a numpy model of what the kernel computes -- for each lane the search
  window around sync_off + 4 plen clipped to the matched filter's
  positions (position 0 alone when that is empty), at each position the
  direct correlation with the passband LTS template and the sum of the
  window's own squares (float64), NaN for a lane holding a non-finite
  sample, the float32 normalisation, the first argmax with NaN largest and
  the one-symbol rule -- put in place of ``lts_timing`` gives
  ``detect_preamble``'s plain path: found, lts_start and data_start equal,
  lts_corr within 1e-5 (NaN where the plain version has NaN), on JAX's
  Cox buffers at the bench's shape, lanes of zeros, lanes with a NaN,
  +inf or -inf sample, the NVIS plan (plen 1,120) and the engine's B = 1
  view of 262,144 samples with the deep gates;
* at given sync_offs the model equals ``lts_timing_plain``: windows
  clipped at either end of the buffer, windows past its end (empty), and
  offsets one symbol late, where the window holds both LTS peaks and the
  one-symbol rule takes the earlier;
* the wrapper's host parts: ``window`` is the extent of the plain
  version's mask; ``launch_plan``'s shared memory holds every sample a
  thread reads and fits the 48 KB a block gets without opting in at both
  plans' symbol lengths; the source's fixed sizes match the wrapper's; a
  CPU tensor is refused before the library loads, and the CPU path never
  loads it (the build's command: tests/test_torch_cuda_build.py).
"""

import re

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from projectultra_tpu.config import CodeRate, Modulation  # noqa: E402
from projectultra_tpu.config import ModemConfig as JaxModemConfig  # noqa: E402
from projectultra_tpu.config import nvis_mode as jax_nvis_mode  # noqa: E402
from projectultra_tpu.sync import schmidl_cox as JSC  # noqa: E402

from projectultra_tpu_torch import config as TC  # noqa: E402
from projectultra_tpu_torch.ops import cuda_lts as CL  # noqa: E402
from projectultra_tpu_torch.sync import schmidl_cox as TSC  # noqa: E402

from test_torch_high_order import cox_buffers  # noqa: E402
from test_torch_sync import noisy_tx  # noqa: E402

CFG = TC.ModemConfig()
NVIS = TC.nvis_mode()
CORR_ATOL = 1e-5
F32 = np.float32


def model_nmf(config, row: np.ndarray, positions: np.ndarray) -> np.ndarray:
    """The normalised matched filter of one lane at ``positions``: direct
    float64 sums over the L samples from each, NaN throughout where the
    lane holds a non-finite sample, the plain version's float32 rule."""
    tmpl = TSC.lts_passband_template(config).astype(np.complex128)
    L = len(tmpl)
    seg = row.astype(np.float64)[positions[:, None] + np.arange(L)]
    with np.errstate(invalid="ignore", over="ignore"):
        mf = np.abs(seg @ tmpl) if np.isfinite(row).all() \
            else np.full(len(positions), np.nan)
        energy = (seg * seg).sum(-1).astype(F32)
        ee = energy * F32(TSC.lts_energy_ref(config))
        return np.where(ee > F32(1e-12),
                        (mf / np.sqrt(np.maximum(ee, F32(1e-30)))), 0.0) \
            .astype(F32)


def first_argmax(v: np.ndarray) -> int:
    nan = np.flatnonzero(np.isnan(v))
    return int(nan[0]) if len(nan) else int(np.argmax(v))


def model_lane(config, row: np.ndarray, sync_off: int):
    """(lts_start, data_start, lts_corr, took the earlier symbol) of one
    lane at ``sync_off``."""
    plen = config.fft_size + config.cyclic_prefix
    n_mf = len(row) - plen + 1
    coarse = sync_off + 4 * plen
    lo, hi = max(coarse - 3 * plen, 0), min(coarse + plen // 2, n_mf - 1)
    positions = np.arange(lo, hi + 1) if lo <= hi else np.array([0])
    nmf = model_nmf(config, row, positions)
    i = first_argmax(nmf)
    lts, corr = int(positions[i]), nmf[i]
    prev = lts - plen
    took = False
    if prev >= coarse - 3 * plen:
        pp = min(max(prev, 0), n_mf - 1)
        pc = model_nmf(config, row, np.array([pp]))[0]
        if pc >= F32(0.85) * corr:
            lts, corr, took = pp, pc, True
    return lts, lts + 2 * plen, corr, took


def model_timing(config, samples: np.ndarray, sync_offs):
    """The model over every lane and gate set: one (lts_start int32,
    data_start int32, lts_corr float32, took) of [B] arrays a gate set."""
    out = []
    for offs in sync_offs:
        lanes = [model_lane(config, samples[b], int(offs[b]))
                 for b in range(samples.shape[0])]
        cols = list(zip(*lanes))
        out.append((np.array(cols[0], np.int32), np.array(cols[1], np.int32),
                    np.array(cols[2], F32), np.array(cols[3])))
    return out


def model_lts(config, samples, X, sync_offs):
    """``lts_timing``'s interface over the model."""
    return [tuple(torch.from_numpy(a) for a in got[:3])
            for got in model_timing(config, samples.numpy(),
                                    [s.numpy() for s in sync_offs])]


def assert_corr_close(got: np.ndarray, want: np.ndarray) -> None:
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=CORR_ATOL)


def assert_detection_equal(det: dict, ref: dict) -> None:
    assert det.keys() == ref.keys()
    for key in ref:
        if key.endswith("lts_corr"):
            assert_corr_close(det[key].numpy(), ref[key].numpy())
        else:
            assert det[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(det[key].numpy(), ref[key].numpy(),
                                          err_msg=key)


def bench_buffers(B: int = 8, seed: int = 13) -> np.ndarray:
    """JAX's 17 dB DQPSK Cox buffers at the bench's shape (lead 1,504,
    tail 1,024: T = 18,856)."""
    return np.array(noisy_tx(Modulation.DQPSK, CodeRate.R1_2, 17.0, B=B,
                             seed=seed, lead=1504, tail=1024)[1])


def case(name: str):
    """(port config, [B, T] float32 samples, with_deep) of a named case."""
    if name == "bench":
        return CFG, bench_buffers(), False
    if name == "zero_and_nonfinite":
        buf = bench_buffers()
        buf[1] = 0.0
        buf[2, 5000], buf[5, 6000], buf[6, 40] = np.nan, np.inf, -np.inf
        return CFG, buf, True
    if name == "nvis":
        return NVIS, np.array(cox_buffers(jax_nvis_mode(), Modulation.QAM32,
                                          CodeRate.R3_4, 30.0, cfo=10.0,
                                          B=2)[1]), True
    # The engine's search view: one row of 262,144 samples holding the
    # frames end to end, zeros after.
    row = np.zeros((1, 262144), F32)
    buf = bench_buffers(B=4, seed=17)
    row[0, :buf.size] = buf.reshape(-1)
    return CFG, row, True


@pytest.mark.parametrize("name", ["bench", "zero_and_nonfinite", "nvis",
                                  "engine_view"])
def test_model_in_detection_equals_the_plain_path(monkeypatch, name):
    config, buf, deep = case(name)
    x = torch.from_numpy(buf)
    ref = TSC.detect_preamble(config, x, with_deep=deep)
    monkeypatch.setattr(TSC, "lts_timing", model_lts)
    det = TSC.detect_preamble(config, x, with_deep=deep)
    assert_detection_equal(det, ref)
    if name == "zero_and_nonfinite":
        assert not det["found"][[1, 2, 5, 6]].any()
        assert torch.isnan(det["lts_corr"][[2, 5, 6]]).all()
        assert det["found"][[0, 3, 4, 7]].all()
    else:
        assert det["found"].all()


def given_offsets(config, T: int, detected: np.ndarray) -> np.ndarray:
    """sync_offs of every kind of window, one a lane: clipped at the
    start, at the end, empty past the end, far before the buffer, and the
    detected offsets late by half and by one symbol."""
    plen = config.fft_size + config.cyclic_prefix
    edge = np.array([0, -4 * plen, -4 * plen - 100, -10 ** 9, T - 5 * plen,
                     T - 4 * plen, T, 10 ** 12])
    late = np.concatenate([detected + plen // 2, detected + plen,
                           detected + plen + 40])
    return np.concatenate([edge, late]).astype(np.int64)


def test_model_at_given_offsets_equals_the_plain_version():
    buf = bench_buffers()
    x = torch.from_numpy(buf)
    det = TSC.detect_preamble(CFG, x)
    offs = given_offsets(CFG, buf.shape[1],
                         det["sync_off"].numpy().astype(np.int64))
    rows = np.concatenate([buf] * 4)
    xs = torch.from_numpy(np.ascontiguousarray(rows))
    X = torch.fft.fft(xs.to(torch.complex64), n=TSC._n_fft(xs.shape[1]),
                      dim=-1)
    want = TSC.lts_timing_plain(CFG, xs, X, [torch.from_numpy(offs)])[0]
    got = model_timing(CFG, rows, [offs])[0]
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b.numpy())
    assert_corr_close(got[2], want[2].numpy())
    # Windows past the end hold position 0 alone; the late windows hold
    # both LTS peaks, and the rule takes the earlier one.
    assert (got[0][[6, 7]] == 0).all()
    assert got[3][8:].any()
    assert (got[0][8:] == np.tile(det["lts_start"].numpy(), 3)).all()


@pytest.mark.parametrize("config", [CFG, NVIS], ids=["default", "nvis"])
def test_window_is_the_plain_masks_extent(config):
    plen = config.fft_size + config.cyclic_prefix
    T = 40000
    n_mf = T - plen + 1
    pos = np.arange(n_mf)
    for off in [0, 1504, 2048, -4 * plen, -4 * plen - 7, -3 * plen, T - 6 *
                plen, T - 5 * plen + 3, T - 4 * plen, T, 10 ** 12, -10 ** 12]:
        coarse = off + 4 * plen
        mask = (pos >= coarse - 3 * plen) & (pos <= coarse + plen // 2)
        lo, hi = CL.window(off, plen, n_mf)
        if mask.any():
            assert (lo, hi) == (pos[mask][0], pos[mask][-1])
        else:
            assert (lo, hi) == (0, 0)
        assert hi - lo + 1 <= CL.max_positions(plen)


@pytest.mark.parametrize("config,B", [(CFG, 2048), (CFG, 1), (NVIS, 512)],
                         ids=["cell", "engine", "nvis"])
def test_launch_plan(config, B):
    """One block a lane; the staged samples cover the last word a thread
    reads (its run of PER_THREAD positions from the last run's start, the
    template's L and PER_THREAD - 1 more); whole runs of 32 words (the swizzle's unit); the shared
    memory within the default 48 KB."""
    plen = config.fft_size + config.cyclic_prefix
    plan = CL.launch_plan(B, plen, plen)
    assert plan["blocks"] == B and plan["threads"] == CL.THREADS
    P = CL.max_positions(plen)
    last_run = (-(-P // CL.PER_THREAD) - 1) * CL.PER_THREAD
    assert last_run + plen + CL.PER_THREAD - 1 < plan["staged_words"]
    assert plan["staged_words"] % CL.WARP == 0
    assert plan["position_words"] >= P
    assert plan["passes"] * CL.PER_THREAD * CL.THREADS >= P
    assert plan["shared_bytes"] <= 48 * 1024
    if config is CFG:
        assert plan["shared_bytes"] == 22496 and plan["passes"] == 1


def test_source_sizes_match_the_wrapper():
    src = CL.SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kPer"]) == CL.PER_THREAD
    assert int(consts["kThreads"]) == CL.THREADS
    assert int(consts["kWarp"]) == CL.WARP


def test_cpu_tensors_take_the_plain_path_and_never_load_the_kernel(
        monkeypatch):
    monkeypatch.setattr(CL.LIBRARY, "_lib", None)
    x = torch.from_numpy(bench_buffers(B=2))
    before = CL.launches
    TSC.detect_preamble(CFG, x, with_deep=True)
    assert CL.launches == before and CL.LIBRARY._lib is None
    X = torch.fft.fft(x.to(torch.complex64), n=TSC._n_fft(x.shape[1]),
                      dim=-1)
    with pytest.raises(ValueError, match="CUDA"):
        CL.lts_timing_cuda(CFG, x, torch.zeros(2, dtype=torch.int64),
                           X[:, 0])
    assert CL.LIBRARY._lib is None


def test_jax_twin_sees_the_same_windows():
    """The JAX package's detection on the bench buffers lands in the
    windows the wrapper computes from its sync_off (the kernel's positions
    hold JAX's answer)."""
    buf = bench_buffers()
    ref = JSC.detect_preamble(JaxModemConfig(), jnp.asarray(buf))
    plen = CFG.fft_size + CFG.cyclic_prefix
    n_mf = buf.shape[1] - plen + 1
    for off, lts in zip(np.asarray(ref["sync_off"]),
                        np.asarray(ref["lts_start"])):
        lo, hi = CL.window(int(off), plen, n_mf)
        assert lo <= lts <= hi

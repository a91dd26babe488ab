#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths through the entry points a user calls, and
checks them:

* slice 1, the presynced path -- OFDM_CHIRP (512-FFT, 30 carriers, no
  pilots), DQPSK, LDPC R1/2, 17 dB AWGN -- at a batch of 16,384 frames
  (``tx_frame``, ``add_noise_active``, ``rx_frame``);
* slice 2, Schmidl-Cox acquisition -- the default 512-FFT pilot plan,
  DQPSK, LDPC R1/2, 17 dB AWGN, each frame at an unknown position in an
  18,856-sample buffer -- at 32 buffers of 512 frames (``tx_cox_frame``,
  ``add_noise_active``, ``decode_cox_batch``: detect, cut at the detected
  LTS, pilot-tracked demodulation at the detected CFO, decode);
* slice 3, dual-chirp acquisition -- MC-DPSK level10 (13 carriers,
  DQPSK, 512 samples per symbol), LDPC R1/4, 5 dB AWGN, each frame at an
  unknown position in an 83,808-sample buffer -- at 32 buffers of 256
  frames (``tx_chirp_frame``, ``add_noise_active``, ``decode_chirp_batch``:
  detect, cut at the detected training start, CFO-corrected MC-DPSK
  demodulation, decode); OFDM_CHIRP behind a detected chirp
  (``detect_dual_chirp``, ``training_start``, ``initial_cfo_phase``,
  ``frame_spans``, slice 1's ``rx_frame``; T = 73,732) at 0 and 30 Hz of
  CFO; and one buffer through the Watterson ``harness_moderate`` channel.

Phases:

1. prints the card's name and power limit; no CUDA device -> exit 1;
2. builds both kernels from ``projectultra_tpu_torch/csrc`` (one nvcc per
   source, started together);
3. holds the LDPC kernel against the plain PyTorch decoder on the card
   (bits, ok flags and iteration counts equal on every lane) on the golden
   codewords of all five rates and on noisy waterfall batches;
4. holds TX on the card against the reference golden waveform;
5. runs the slice-1 path: decode rate >= 0.99 with exact info bits on
   every decoded frame, the LDPC kernel's launch counter grown, and the
   kernel equal to the plain decoder on the same LLRs; times it (per step,
   per stage, the device's idle share under ``torch.profiler``) and the
   kernel against the plain decoder;
6. holds the Schmidl-Cox window kernel against its plain version at
   stride 1 and 8 (rtol 2e-4, atol 2e-3) on random analytic signals and on
   Cox buffers, and on one 600,000-sample buffer against float64 (relative
   error < 1e-4); detection through the kernel against detection through
   the plain version (found and lts_start identical on every lane);
7. runs the Cox path: ok rate >= 0.99 with exact info bits on ok lanes
   over 32 buffers, both kernels' launch counters grown, a 30 Hz CFO
   buffer at 20 dB by the same gate, and 64 lanes equal to the CPU path;
   times it (frames/s, per stage, idle share) and the window kernel
   against its plain version;
8. chirp detection on the card against the CPU path on 64 lanes of a
   5 dB chirp-cell buffer (success and every position identical, cfo
   within 1e-3 Hz);
9. runs the chirp cell: ok rate >= 0.99 with exact info bits on ok lanes
   over 32 buffers, the LDPC kernel's launch counter grown, 64 lanes equal
   to the CPU path; times it (frames/s best of 2 repeats with noise
   untimed, per stage, idle share);
10. holds the LDPC kernel against the plain decoder on the chirp cell's
    R1/4 5 dB LLRs (every lane equal) and times both;
11. runs OFDM_CHIRP behind a detected chirp at 0 and 30 Hz of CFO, 17 dB,
    256 frames each: ok rate >= 0.99 with exact bits;
12. one ``harness_moderate`` Watterson buffer of the chirp cell at 5 dB:
    fading taps on the card against the CPU from the same normals (and a
    finite flutter run over the whole buffer), the channel output against
    the CPU, and the MC-DPSK ok rate through it (printed, not gated).

Any failure raises and the script exits non-zero.  The last line of its
output is one JSON object naming the device.  It imports nothing of jax.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from projectultra_tpu_torch import (CodeRate, ModemConfig, Modulation,
                                    get_code, require_cuda)
from projectultra_tpu_torch.ofdm import modulator as M
from projectultra_tpu_torch.ofdm import pipeline as P
from projectultra_tpu_torch.ops import cuda_build, cuda_ldpc, cuda_sc
from projectultra_tpu_torch.ops import ldpc as ldpc_ops
from projectultra_tpu_torch.ops.sc_windows import sc_windows_plain
from projectultra_tpu_torch.psk import mc_dpsk as MCP
from projectultra_tpu_torch.sim import watterson as W
from projectultra_tpu_torch.sync import chirp as CH
from projectultra_tpu_torch.sync import schmidl_cox as SC

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "golden"

CFG = P.chirp_ofdm_config()
MOD = Modulation.DQPSK
RATE = CodeRate.R1_2
BATCH = 16384          # frames per step, as the JAX bench runs the main path
SNR_DB = 17.0
DECODE_GATE = 0.99     # decode-rate gate of the JAX bench
TIMED_STEPS = 5
WATERFALL = [(CodeRate.R1_2, 0.62), (CodeRate.R1_4, 1.1)]
WATERFALL_BATCH = 4096
GOLDEN_NAMES = {CodeRate.R1_4: "R1_4", CodeRate.R1_2: "R1_2",
                CodeRate.R2_3: "R2_3", CodeRate.R3_4: "R3_4",
                CodeRate.R5_6: "R5_6"}
KERNELS = {  # name -> (wrapper module, TPU kernel it replaces)
    "ldpc_minsum": (cuda_ldpc, "projectultra_tpu/ops/pallas_ldpc.py:102"),
    "sc_windows": (cuda_sc, "projectultra_tpu/ops/pallas_sync.py:44"),
}

COX_CFG = ModemConfig()  # the default 512-FFT pilot plan (OFDM_COX)
COX_BATCH = 512          # frames per buffer, as the JAX bench runs Cox
COX_BUFFERS = 32
COX_LEAD, COX_TAIL = 1504, 1024
COX_T = 18856
COX_CFO_HZ, COX_CFO_SNR_DB = 30.0, 20.0
HALF = COX_CFG.fft_size // 2
CP = COX_CFG.cyclic_prefix
WINDOW_RTOL, WINDOW_ATOL = 2e-4, 2e-3   # tests/test_pallas_sync.py

MC = MCP.level10()       # the ModemEngine default, as the JAX bench runs
CC = MC.chirp_config()
CHIRP_RATE = CodeRate.R1_4
CHIRP_BATCH = 256        # frames per buffer, as the JAX bench runs chirps
CHIRP_BUFFERS = 32
CHIRP_SNR_DB = 5.0
CHIRP_T = 83808
CPU_LANES = 64
OFDM_CHIRP_T = 73732
OFDM_CHIRP_CFOS = (0.0, 30.0)
FADING = W.harness_moderate(CHIRP_SNR_DB)
FADING_CPU_LANES = 16
DET_KEYS = ("success", "up_chirp_start", "down_chirp_start",
            "first_strong_up", "next_up_start")


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


# ---------------------------------------------------------------------------
# Decoder inputs
# ---------------------------------------------------------------------------

def golden_llrs(rate: CodeRate) -> np.ndarray:
    """[1, n] +-4 LLRs of the reference's golden coded block."""
    fields = {}
    with open(GOLDEN / f"golden_ldpc_{GOLDEN_NAMES[rate]}.txt") as f:
        for line in f:
            toks = line.split()
            fields.update(zip(toks[::2], toks[1::2]))
    code = get_code(rate)
    coded = np.unpackbits(np.frombuffer(bytes.fromhex(fields["coded"]),
                                        np.uint8))[:code.n]
    return (4.0 * (1.0 - 2.0 * coded.astype(np.float32)))[None]


def waterfall_llrs(rate: CodeRate, sigma: float, B: int,
                   seed: int = 1234) -> np.ndarray:
    """BPSK-over-AWGN LLRs of B random codewords at noise std sigma."""
    code = get_code(rate)
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, size=(B, code.k)).astype(np.uint8)
    parity = (info.astype(np.int64) @ code.h_dense.T.astype(np.int64)) & 1
    cw = np.concatenate([info, parity.astype(np.uint8)], axis=1)
    y = (1.0 - 2.0 * cw.astype(np.float32)) \
        + sigma * rng.standard_normal(cw.shape).astype(np.float32)
    return (2.0 * y / (sigma * sigma)).astype(np.float32)


def compare_decoders(rate: CodeRate, llrs: torch.Tensor, label: str) -> float:
    """Kernel vs plain decoder on the same LLRs; returns the max abs
    difference of the total LLRs (bits, ok and iters must be equal)."""
    graph = ldpc_ops.graph_for(get_code(rate), llrs.device)
    llr_k, ok_k, it_k = cuda_ldpc.decode_cuda(graph, llrs)
    llr_p, ok_p, it_p = ldpc_ops.decode_plain(graph, llrs)
    torch.cuda.synchronize()
    k = graph.k
    bits_eq = bool(((llr_k[:, :k] < 0) == (llr_p[:, :k] < 0)).all())
    ok_eq = bool((ok_k == ok_p).all())
    it_eq = bool((it_k == it_p).all())
    err = float((llr_k - llr_p).abs().max())
    print(f"kernel vs plain [{label}] B={llrs.shape[0]}: bits_equal={bits_eq} "
          f"ok_equal={ok_eq} iters_equal={it_eq} max_abs_err={err!r} "
          f"ok_rate={float(ok_k.float().mean())!r} "
          f"max_iters_seen={int(it_k.max())}", flush=True)
    require(bits_eq and ok_eq and it_eq,
            f"kernel disagrees with the plain decoder on {label}")
    return err


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn over reps calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(kernel, plain, kernel_reps: int,
              plain_reps: int) -> tuple[float, float]:
    """(kernel ms, plain ms), measured in turns plain, kernel, kernel,
    plain; each the mean of its two turns."""
    p1 = time_ms(plain, plain_reps)
    k1 = time_ms(kernel, kernel_reps)
    k2 = time_ms(kernel, kernel_reps)
    p2 = time_ms(plain, plain_reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def time_decoders(graph, llrs: torch.Tensor, kernel_reps: int,
                  plain_reps: int) -> tuple[float, float]:
    return time_pair(lambda: cuda_ldpc.decode_cuda(graph, llrs),
                     lambda: ldpc_ops.decode_plain(graph, llrs),
                     kernel_reps, plain_reps)


def profile_busy_ms(fn, reps: int) -> float:
    """Device busy milliseconds per call of fn over reps calls under
    ``torch.profiler``: the length of the union of the device kernels'
    time intervals.  Prints the device time by operator."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15), flush=True)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, cur_start, cur_end = 0.0, None, None
    for a, b in spans:
        if cur_end is None or a > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = a, b
        else:
            cur_end = max(cur_end, b)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    return busy_us / 1000.0 / reps


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def source_of(name: str) -> str:
    return str(KERNELS[name][0].SOURCE.relative_to(ROOT))


def phase_build() -> None:
    """Both kernel libraries, one nvcc each, started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        for job in [pool.submit(mod.load_library)
                    for mod, _ in KERNELS.values()]:
            job.result()
    for name, (mod, _) in KERNELS.items():
        print(f"kernel build {name}: {mod.LIBRARY.build_seconds!r} s "
              f"({source_of(name)}, nvcc sm_90a)", flush=True)
    print(f"kernel builds, wall: {time.perf_counter() - t0!r} s", flush=True)
    for report in sorted(cuda_build.BUILD_DIR.glob("*.ptxas.txt")):
        print(f"ptxas ({report.name}):\n{report.read_text().strip()}",
              flush=True)


def phase_kernel_parity(dev: torch.device) -> None:
    for rate in GOLDEN_NAMES:
        llrs = torch.from_numpy(golden_llrs(rate)).to(dev)
        compare_decoders(rate, llrs, f"golden {GOLDEN_NAMES[rate]}")
    for rate, sigma in WATERFALL:
        llrs = torch.from_numpy(
            waterfall_llrs(rate, sigma, WATERFALL_BATCH)).to(dev)
        compare_decoders(rate, llrs,
                         f"waterfall {GOLDEN_NAMES[rate]} sigma={sigma}")


def phase_tx_golden(dev: torch.device) -> None:
    meta = (GOLDEN / "golden_ofdm_tx_meta.txt").read_text().split()
    payload = bytes.fromhex(meta[1])
    golden = np.fromfile(GOLDEN / "golden_ofdm_tx.f32", dtype=np.float32)
    gt, gd = golden[:1128], golden[1128:]
    pipe = P.pipeline_for(CFG, MOD, RATE, 1, dev)
    tr = pipe.training_wave.cpu().numpy()
    bits = torch.from_numpy(
        np.unpackbits(np.frombuffer(payload, np.uint8))[None].astype(
            np.float32)).to(dev)
    dat = M.modulate(CFG, MOD, bits, t_offset=2 * CFG.symbol_duration)
    dat = dat.cpu().numpy()[0]
    tr_err = float(np.abs(tr - gt).max())
    dat_err = float(np.abs(dat - gd).max())
    print(f"TX vs golden: training max_abs_err={tr_err!r} (limit 1e-4), "
          f"data max_abs_err={dat_err!r} (limit "
          f"{2e-3 * float(np.abs(gd).max())!r})", flush=True)
    require(dat.shape == gd.shape, "TX data length differs from the golden")
    require(tr_err < 1e-4, "TX training differs from the golden")
    require(dat_err < 2e-3 * np.abs(gd).max(), "TX data differs from the golden")


def phase_main_path(dev: torch.device):
    """The main path at BATCH frames; returns (kernel launches in the run,
    deinterleaved LLRs of its noisy frames, max abs difference of the
    kernel's and the plain decoder's total LLRs on them)."""
    code = get_code(RATE)
    g_info = torch.Generator(device=dev).manual_seed(0)
    g_noise = torch.Generator(device=dev).manual_seed(1)
    info = torch.randint(0, 2, (BATCH, code.k), generator=g_info, device=dev,
                         dtype=torch.uint8)
    torch.cuda.synchronize()

    cuda_ldpc.launches = 0
    tx = P.tx_frame(CFG, MOD, RATE, info)
    rx_in = W.add_noise_active(tx, SNR_DB, g_noise)
    out, ok, iters = P.rx_frame(CFG, MOD, RATE, rx_in)
    torch.cuda.synchronize()
    launches = cuda_ldpc.launches

    T = P.frame_samples(CFG, MOD)
    require(tuple(tx.shape) == (BATCH, T) and tx.dtype == torch.float32,
            f"tx has shape {tuple(tx.shape)}, expected {(BATCH, T)}")
    require(bool(torch.isfinite(rx_in).all()), "non-finite received samples")
    require(tuple(out.shape) == (BATCH, code.k) and out.dtype == torch.uint8,
            "decoded bits have the wrong shape or type")
    ok_rate = float(ok.float().mean())
    bits_exact = bool((out == info)[ok].all())
    print(f"main path B={BATCH} T={T} {SNR_DB} dB: ok_rate={ok_rate!r} "
          f"bits_exact_on_ok={bits_exact} "
          f"mean_iters={float(iters.float().mean())!r} "
          f"kernel_launches={launches}", flush=True)
    require(launches > 0, "the main path did not launch the LDPC kernel")
    require(ok_rate >= DECODE_GATE, f"decode rate {ok_rate} < {DECODE_GATE}")
    require(bits_exact, "decoded info bits differ on a decoded frame")

    pipe = P.pipeline_for(CFG, MOD, RATE, 1, dev)
    deint = pipe.deinterleaved_llrs(rx_in)
    err = compare_decoders(RATE, deint, "main path 17 dB LLRs")
    _, ok_k, _ = cuda_ldpc.decode_cuda(pipe.code, deint)
    require(bool((ok_k == ok).all()), "rx_frame ok flags differ from a "
            "second decode of its own LLRs")
    return launches, deint, err


def stage_breakdown(dev: torch.device, info: torch.Tensor,
                    g_noise: torch.Generator) -> dict:
    """Stream time of each stage of the main path, ms per step."""
    pipe = P.pipeline_for(CFG, MOD, RATE, 1, dev)
    names = ["tx", "noise", "demod", "decode"]
    totals = dict.fromkeys(names, 0.0)
    for _ in range(TIMED_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        tx = pipe.tx(info)
        ev[1].record()
        rx_in = W.add_noise_active(tx, SNR_DB, g_noise)
        ev[2].record()
        deint = pipe.deinterleaved_llrs(rx_in)
        ev[3].record()
        ldpc_ops.decode_totals(pipe.code, deint)
        ev[4].record()
        torch.cuda.synchronize()
        for i, name in enumerate(names):
            totals[name] += ev[i].elapsed_time(ev[i + 1])
    return {name: t / TIMED_STEPS for name, t in totals.items()}


def phase_timing(dev: torch.device, card: str, deint: torch.Tensor):
    code = get_code(RATE)
    g_info = torch.Generator(device=dev).manual_seed(2)
    g_noise = torch.Generator(device=dev).manual_seed(3)
    info = torch.randint(0, 2, (BATCH, code.k), generator=g_info, device=dev,
                         dtype=torch.uint8)

    def step():
        tx = P.tx_frame(CFG, MOD, RATE, info)
        rx_in = W.add_noise_active(tx, SNR_DB, g_noise)
        return P.rx_frame(CFG, MOD, RATE, rx_in)

    ms = time_ms(step, TIMED_STEPS)
    pps = BATCH / (ms / 1000.0)
    print(f"main path: {pps!r} pipelines/s ({ms!r} ms per step of {BATCH} "
          f"frames, {TIMED_STEPS} steps, fresh noise each step) on {card}",
          flush=True)
    print(f"main path stages: {stage_breakdown(dev, info, g_noise)} "
          f"(ms per step of {BATCH} frames, CUDA events) on {card}",
          flush=True)
    busy = profile_busy_ms(step, TIMED_STEPS)
    print(f"main path device busy {busy!r} ms per step (union of kernel "
          f"intervals, profiled) of {ms!r} ms unprofiled: idle share "
          f"{1.0 - busy / ms!r} on {card}", flush=True)

    graph = ldpc_ops.graph_for(code, dev)
    k_ms, p_ms = time_decoders(graph, deint, kernel_reps=20, plain_reps=5)
    print(f"decode at 17 dB LLRs B={deint.shape[0]}: kernel {k_ms!r} ms, "
          f"plain {p_ms!r} ms on {card}", flush=True)
    wf = torch.from_numpy(waterfall_llrs(RATE, 0.62, BATCH)).to(dev)
    wk_ms, wp_ms = time_decoders(graph, wf, kernel_reps=5, plain_reps=2)
    print(f"decode at waterfall R1_2 sigma=0.62 B={BATCH}: kernel "
          f"{wk_ms!r} ms, plain {wp_ms!r} ms on {card}", flush=True)
    return k_ms, p_ms


# ---------------------------------------------------------------------------
# Slice 2: Schmidl-Cox acquisition
# ---------------------------------------------------------------------------

def cox_tx(dev: torch.device, seed: int):
    """(info [B, k] uint8, tx [B, 18,856]) of the bench's Cox frames."""
    g = torch.Generator(device=dev).manual_seed(seed)
    info = torch.randint(0, 2, (COX_BATCH, get_code(RATE).k), generator=g,
                         device=dev, dtype=torch.uint8)
    tx = P.tx_cox_frame(COX_CFG, MOD, RATE, info, lead=COX_LEAD,
                        tail=COX_TAIL)
    require(tuple(tx.shape) == (COX_BATCH, COX_T),
            f"Cox frames have shape {tuple(tx.shape)}")
    return info, tx


def noisy_buffers(tx: torch.Tensor, g: torch.Generator, n: int,
                  snr_db: float = SNR_DB) -> list:
    return [W.add_noise_active(tx, snr_db, g) for _ in range(n)]


def window_shapes(T: int) -> dict:
    """(stride, offset, G) of the two windowed forms the Cox path runs:
    detect_preamble's stride-8 grid and sc_metric's every offset."""
    return {8: (8, CP, SC.search_grid_size(COX_CFG, T)),
            1: (1, CP, T - COX_CFG.fft_size - CP + 1)}


def compare_windows(a: torch.Tensor, stride: int, offset: int, G: int,
                    label: str) -> float:
    """Kernel vs plain window sums on the same analytic signal; returns the
    max abs error (raises unless within rtol 2e-4, atol 2e-3)."""
    got = cuda_sc.sc_windows_cuda(a, HALF, stride, offset, G)
    want = sc_windows_plain(a, HALF, stride, offset, G)
    torch.cuda.synchronize()
    errs, rels = [], []
    for x, y, name in zip(got, want, ("P", "R1", "R2")):
        d = (x - y).abs()
        big = y.abs() >= 1e-3 * float(y.abs().max())
        errs.append(float(d.max()))
        rels.append(float((d[big] / y.abs()[big]).max()))
        require(bool(torch.isclose(x, y, rtol=WINDOW_RTOL,
                                   atol=WINDOW_ATOL).all()),
                f"window kernel {name} disagrees with plain on {label}")
    print(f"window kernel vs plain [{label}] B={a.shape[0]} T={a.shape[1]} "
          f"stride={stride} G={G}: max_abs_err P/R1/R2={errs!r} "
          f"max_rel_err={rels!r} (rtol {WINDOW_RTOL}, atol {WINDOW_ATOL})",
          flush=True)
    return max(errs)


def phase_window_parity(dev: torch.device, rx: torch.Tensor) -> float:
    """Returns the max abs error on the Cox buffers at stride 8 (the shape
    detect_preamble gives the kernel)."""
    g = torch.Generator(device=dev).manual_seed(21)
    noise = torch.randn((64, COX_T), generator=g, device=dev)
    cox = SC.analytic_signal(rx)
    err8 = 0.0
    for name, a in (("random", SC.analytic_signal(noise)), ("Cox 17 dB", cox)):
        for stride, (st, off, G) in window_shapes(COX_T).items():
            err = compare_windows(a, st, off, G, name)
            if name != "random" and stride == 8:
                err8 = err
    compare_windows(SC.analytic_signal(noise[:, :9001]), 8, CP,
                    SC.search_grid_size(COX_CFG, 9001), "random, ragged T")

    # Block stability: one 600,000-sample buffer of positive samples
    # against float64 sums (tests/test_long_buffer_precision.py:20-36).
    T = 600_000
    x = (np.random.default_rng(1).standard_normal(T).astype(np.float32)
         + 0.5) ** 2
    x64 = x.astype(np.float64)
    ones = np.ones(HALF)
    e = np.convolve(x64 * x64, ones, mode="valid")
    refs = (np.convolve(x64[:-HALF] * x64[HALF:], ones, mode="valid"),
            e[:T - 2 * HALF + 1], e[HALF:])
    a = torch.from_numpy(x).to(dev).to(torch.complex64)[None]
    for label, fn in (("kernel", cuda_sc.sc_windows_cuda),
                      ("plain", sc_windows_plain)):
        outs = fn(a, HALF, 1, 0, T - 2 * HALF + 1)
        rel = [float(np.max(np.abs(o[0].real.double().cpu().numpy() - r)
                            / r)) for o, r in zip(outs, refs)]
        print(f"long buffer T={T} stride 1 w=2*{HALF} [{label}]: relative "
              f"error vs float64 P/R1/R2={rel!r} (limit 1e-4)", flush=True)
        require(max(rel) < 1e-4, f"{label} window sums drift on a long buffer")
    return err8


def phase_detection_parity(dev: torch.device, rx: torch.Tensor) -> None:
    """detect_preamble through the kernel against detect_preamble through
    the plain window sums on the same buffers."""
    det_k = SC.detect_preamble(COX_CFG, rx)
    with mock.patch.object(SC, "sc_windows", sc_windows_plain):
        det_p = SC.detect_preamble(COX_CFG, rx)
    torch.cuda.synchronize()
    found_eq = bool(torch.equal(det_k["found"], det_p["found"]))
    lts_eq = bool(torch.equal(det_k["lts_start"], det_p["lts_start"]))
    sync_diff = int((det_k["sync_off"] != det_p["sync_off"]).sum())
    cfo_diff = float((det_k["cfo_hz"] - det_p["cfo_hz"]).abs().max())
    print(f"detection kernel vs plain B={rx.shape[0]} {SNR_DB} dB: "
          f"found_equal={found_eq} lts_start_equal={lts_eq} "
          f"sync_off_lanes_differing={sync_diff} max_cfo_diff_hz={cfo_diff!r} "
          f"found_rate={float(det_k['found'].float().mean())!r}", flush=True)
    require(found_eq and lts_eq,
            "detection through the kernel differs from the plain version")


def check_cox(outs: list, info: torch.Tensor, label: str) -> None:
    """The bench's gate over the buffers' decode_cox_batch results."""
    oks = torch.stack([ok for _, ok, _, _ in outs])
    ok_rate = float(oks.float().mean())
    worst = float(oks.float().mean(-1).min())
    bits_exact = all(bool((out == info)[ok].all()) for out, ok, _, _ in outs)
    shapes_ok = all(tuple(out.shape) == tuple(info.shape)
                    and out.dtype == torch.uint8 for out, _, _, _ in outs)
    finite = all(bool(torch.isfinite(det["cfo_hz"]).all())
                 for _, _, _, det in outs)
    print(f"Cox path [{label}] {len(outs)} x B={info.shape[0]}: "
          f"ok_rate={ok_rate!r} worst_buffer={worst!r} "
          f"bits_exact_on_ok={bits_exact}", flush=True)
    require(shapes_ok and finite, f"Cox outputs malformed on {label}")
    require(ok_rate >= DECODE_GATE, f"Cox ok rate {ok_rate} < {DECODE_GATE}")
    require(bits_exact, f"decoded info bits differ on an ok lane ({label})")


def decode_cox(rx: torch.Tensor):
    return SC.decode_cox_batch(COX_CFG, MOD, RATE, rx)


def phase_cox_path(dev: torch.device) -> dict:
    """The Cox path over COX_BUFFERS fresh 17 dB buffers; returns each
    kernel's launches in that run."""
    info, tx = cox_tx(dev, 11)
    rx_all = noisy_buffers(tx, torch.Generator(device=dev).manual_seed(13),
                           COX_BUFFERS)
    torch.cuda.synchronize()

    cuda_sc.launches = cuda_ldpc.launches = 0
    outs = [decode_cox(rx) for rx in rx_all]
    torch.cuda.synchronize()
    launches = {"sc_windows": cuda_sc.launches,
                "ldpc_minsum": cuda_ldpc.launches}
    print(f"Cox path kernel launches: {launches}", flush=True)
    require(all(n > 0 for n in launches.values()),
            "the Cox path did not launch both kernels")
    check_cox(outs, info, f"{SNR_DB} dB")

    # 64 lanes of the first buffer through the CPU path: equal bits on the
    # lanes both decode, and the same detections.
    cpu = decode_cox(rx_all[0][:64].cpu())
    out, ok, _, det = outs[0]
    both = ok[:64].cpu() & cpu[1]
    same_lts = bool(torch.equal(det["lts_start"][:64].cpu(),
                                cpu[3]["lts_start"]))
    print(f"Cox path card vs CPU on 64 lanes: decoded_both="
          f"{int(both.sum())} lts_start_equal={same_lts}", flush=True)
    require(same_lts and bool(torch.equal(out[:64].cpu()[both],
                                          cpu[0][both])),
            "the Cox path on the card differs from the CPU path")

    # A true 30 Hz CFO at 20 dB.
    g = torch.Generator(device=dev).manual_seed(17)
    rx = W.add_noise_active(W.apply_cfo_hilbert(tx, COX_CFO_HZ),
                            COX_CFO_SNR_DB, g)
    res = decode_cox(rx)
    cfo = res[3]["cfo_hz"]
    print(f"Cox path with {COX_CFO_HZ} Hz CFO: detected cfo mean "
          f"{float(cfo.mean())!r} Hz, min {float(cfo.min())!r}, max "
          f"{float(cfo.max())!r}", flush=True)
    check_cox([res], info, f"{COX_CFO_HZ} Hz CFO, {COX_CFO_SNR_DB} dB")
    return launches


def cox_stages(rx_all: list) -> dict:
    """Stream time of each stage of the Cox step, ms per buffer."""
    names = ["detect", "slice+demod", "deinterleave+decode"]
    totals = dict.fromkeys(names, 0.0)
    pipe = P.pipeline_for(COX_CFG, MOD, RATE, 1, rx_all[0].device)
    for rx in rx_all:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        det = SC.detect_preamble(COX_CFG, rx)
        ev[1].record()
        llrs = SC.demodulate_detected(COX_CFG, MOD, rx, det)
        ev[2].record()
        pipe.decode(llrs)
        ev[3].record()
        torch.cuda.synchronize()
        for i, name in enumerate(names):
            totals[name] += ev[i].elapsed_time(ev[i + 1])
    return {name: t / len(rx_all) for name, t in totals.items()}


def phase_cox_timing(dev: torch.device, card: str):
    """Cox frames/s (noise untimed, as the bench), stages, idle share, and
    the window kernel against its plain version; returns the kernel's and
    the plain version's ms at stride 8."""
    info, tx = cox_tx(dev, 12)
    g = torch.Generator(device=dev).manual_seed(14)
    decode_cox(tx)  # warm-up: per-device tables
    ms = float("inf")
    for rep in range(2):
        rx_all = noisy_buffers(tx, g, COX_BUFFERS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        oks = torch.stack([decode_cox(rx)[1] for rx in rx_all]).cpu()
        rep_ms = (time.perf_counter() - t0) / COX_BUFFERS * 1e3
        ms = min(ms, rep_ms)
        print(f"Cox path repeat {rep}: {COX_BATCH / rep_ms * 1e3!r} frames/s "
              f"({rep_ms!r} ms per buffer of {COX_BATCH}, {COX_BUFFERS} "
              f"buffers, ok_rate {float(oks.float().mean())!r}) on {card}",
              flush=True)
    print(f"Cox path: best {COX_BATCH / ms * 1e3!r} frames/s ({ms!r} ms per "
          f"buffer) on {card}", flush=True)
    print(f"Cox path stages: {cox_stages(rx_all[:8])} (ms per buffer of "
          f"{COX_BATCH}, CUDA events, 8 buffers) on {card}", flush=True)
    busy = profile_busy_ms(lambda: decode_cox(rx_all[0]), 5)
    print(f"Cox path device busy {busy!r} ms per buffer (union of kernel "
          f"intervals, profiled) of {ms!r} ms unprofiled: idle share "
          f"{1.0 - busy / ms!r} on {card}", flush=True)

    a = SC.analytic_signal(rx_all[0])
    times = {}
    for stride, (st, off, G) in window_shapes(COX_T).items():
        def kernel():
            cuda_sc.sc_windows_cuda(a, HALF, st, off, G)

        def plain():
            sc_windows_plain(a, HALF, st, off, G)

        times[stride] = time_pair(kernel, plain, 50, 10)
        print(f"window sums B={COX_BATCH} T={COX_T} stride {stride} G={G}: "
              f"kernel {times[stride][0]!r} ms, plain {times[stride][1]!r} ms "
              f"on {card}", flush=True)
    return times[8]


# ---------------------------------------------------------------------------
# Slice 3: chirp acquisition, MC-DPSK, OFDM behind a chirp, fading
# ---------------------------------------------------------------------------

def chirp_tx(dev: torch.device, seed: int):
    """(info [B, k] uint8, tx [B, 83,808]) of the bench's chirp frames."""
    g = torch.Generator(device=dev).manual_seed(seed)
    info = torch.randint(0, 2, (CHIRP_BATCH, get_code(CHIRP_RATE).k),
                         generator=g, device=dev, dtype=torch.uint8)
    tx = MCP.tx_chirp_frame(MC, CHIRP_RATE, info)
    require(tuple(tx.shape) == (CHIRP_BATCH, CHIRP_T),
            f"chirp frames have shape {tuple(tx.shape)}")
    return info, tx


def decode_chirp(rx: torch.Tensor):
    return MCP.decode_chirp_batch(MC, CHIRP_RATE, rx)


def chirp_llrs(rx: torch.Tensor) -> torch.Tensor:
    """The chirp step's decoder input [B, 648] for the buffers rx."""
    det = CH.detect_dual_chirp(CC, rx, MC.chirp_threshold)
    n_sym = MCP.num_symbols_for_bits(MC, get_code(CHIRP_RATE).n)
    llrs = MCP.demodulate_detected(MC, rx, det, n_sym)
    return llrs[:, :get_code(CHIRP_RATE).n].contiguous()


def phase_chirp_detection(rx: torch.Tensor) -> None:
    """detect_dual_chirp on the card against the CPU path, same lanes."""
    det = CH.detect_dual_chirp(CC, rx[:CPU_LANES], MC.chirp_threshold)
    ref = CH.detect_dual_chirp(CC, rx[:CPU_LANES].cpu(), MC.chirp_threshold)
    torch.cuda.synchronize()
    equal = {k: bool(torch.equal(det[k].cpu(), ref[k])) for k in DET_KEYS}
    cfo_diff = float((det["cfo_hz"].cpu() - ref["cfo_hz"]).abs().max())
    corr_diff = max(float((det[k].cpu() - ref[k]).abs().max())
                    for k in ("up_correlation", "down_correlation"))
    print(f"chirp detection card vs CPU B={CPU_LANES} T={rx.shape[1]} "
          f"{CHIRP_SNR_DB} dB: equal={equal} max_cfo_diff_hz={cfo_diff!r} "
          f"max_corr_diff={corr_diff!r} success_rate="
          f"{float(det['success'].float().mean())!r}", flush=True)
    require(all(equal.values()) and cfo_diff <= 1e-3,
            "chirp detection on the card differs from the CPU path")


def check_chirp(outs: list, info: torch.Tensor, label: str) -> float:
    """The bench's gate over decode_chirp_batch results; returns the ok
    rate."""
    oks = torch.stack([ok for _, ok, _, _ in outs])
    ok_rate = float(oks.float().mean())
    bits_exact = all(bool((out == info)[ok].all()) for out, ok, _, _ in outs)
    shapes_ok = all(tuple(out.shape) == tuple(info.shape)
                    and out.dtype == torch.uint8 for out, _, _, _ in outs)
    finite = all(bool(torch.isfinite(det["cfo_hz"]).all())
                 for _, _, _, det in outs)
    iters = torch.cat([it.float() for _, _, it, _ in outs])
    print(f"chirp path [{label}] {len(outs)} x B={info.shape[0]}: "
          f"ok_rate={ok_rate!r} worst_buffer="
          f"{float(oks.float().mean(-1).min())!r} bits_exact_on_ok="
          f"{bits_exact} mean_iters={float(iters.mean())!r} "
          f"max_iters={int(iters.max())}", flush=True)
    require(shapes_ok and finite, f"chirp outputs malformed on {label}")
    require(ok_rate >= DECODE_GATE, f"chirp ok rate {ok_rate} < {DECODE_GATE}")
    require(bits_exact, f"decoded info bits differ on an ok lane ({label})")
    return ok_rate


def phase_chirp_path(dev: torch.device) -> torch.Tensor:
    """The chirp cell over CHIRP_BUFFERS fresh 5 dB buffers; returns the
    first buffer."""
    info, tx = chirp_tx(dev, 31)
    rx_all = noisy_buffers(tx, torch.Generator(device=dev).manual_seed(33),
                           CHIRP_BUFFERS, CHIRP_SNR_DB)
    torch.cuda.synchronize()

    cuda_ldpc.launches = 0
    outs = [decode_chirp(rx) for rx in rx_all]
    torch.cuda.synchronize()
    launches = cuda_ldpc.launches
    print(f"chirp path kernel launches: {{'ldpc_minsum': {launches}}}",
          flush=True)
    require(launches > 0, "the chirp path did not launch the LDPC kernel")
    check_chirp(outs, info, f"{CHIRP_SNR_DB} dB")

    # 64 lanes of the first buffer through the CPU path.
    cpu = decode_chirp(rx_all[0][:CPU_LANES].cpu())
    out, ok, _, det = outs[0]
    both = ok[:CPU_LANES].cpu() & cpu[1]
    same_det = all(bool(torch.equal(det[k][:CPU_LANES].cpu(), cpu[3][k]))
                   for k in DET_KEYS)
    print(f"chirp path card vs CPU on {CPU_LANES} lanes: decoded_both="
          f"{int(both.sum())} detections_equal={same_det}", flush=True)
    require(same_det and bool(torch.equal(out[:CPU_LANES].cpu()[both],
                                          cpu[0][both])),
            "the chirp path on the card differs from the CPU path")
    return rx_all[0]


def chirp_stages(rx_all: list) -> dict:
    """Stream time of each stage of the chirp step, ms per buffer."""
    names = ["detect", "gather+CFO+demod", "decode"]
    totals = dict.fromkeys(names, 0.0)
    code = get_code(CHIRP_RATE)
    graph = ldpc_ops.graph_for(code, rx_all[0].device)
    n_sym = MCP.num_symbols_for_bits(MC, code.n)
    for rx in rx_all:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        det = CH.detect_dual_chirp(CC, rx, MC.chirp_threshold)
        ev[1].record()
        llrs = MCP.demodulate_detected(MC, rx, det, n_sym)
        ev[2].record()
        ldpc_ops.decode_totals(graph, llrs[:, :code.n])
        ev[3].record()
        torch.cuda.synchronize()
        for i, name in enumerate(names):
            totals[name] += ev[i].elapsed_time(ev[i + 1])
    return {name: t / len(rx_all) for name, t in totals.items()}


def phase_chirp_timing(dev: torch.device, card: str) -> None:
    """Chirp frames/s (noise untimed, as the bench), stages, idle share."""
    _, tx = chirp_tx(dev, 32)
    g = torch.Generator(device=dev).manual_seed(34)
    decode_chirp(tx)  # warm-up: per-device tables
    ms = float("inf")
    for rep in range(2):
        rx_all = noisy_buffers(tx, g, CHIRP_BUFFERS, CHIRP_SNR_DB)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        oks = torch.stack([decode_chirp(rx)[1] for rx in rx_all]).cpu()
        rep_ms = (time.perf_counter() - t0) / CHIRP_BUFFERS * 1e3
        ms = min(ms, rep_ms)
        ok_rate = float(oks.float().mean())
        print(f"chirp path repeat {rep}: {CHIRP_BATCH / rep_ms * 1e3!r} "
              f"frames/s ({rep_ms!r} ms per buffer of {CHIRP_BATCH}, "
              f"{CHIRP_BUFFERS} buffers, ok_rate {ok_rate!r}) on {card}",
              flush=True)
        require(ok_rate >= DECODE_GATE, f"timed chirp ok rate {ok_rate}")
    print(f"chirp path: best {CHIRP_BATCH / ms * 1e3!r} frames/s ({ms!r} ms "
          f"per buffer) on {card}", flush=True)
    print(f"chirp path stages: {chirp_stages(rx_all[:8])} (ms per buffer of "
          f"{CHIRP_BATCH}, CUDA events, 8 buffers) on {card}", flush=True)
    busy = profile_busy_ms(lambda: decode_chirp(rx_all[0]), 5)
    print(f"chirp path device busy {busy!r} ms per buffer (union of kernel "
          f"intervals, profiled) of {ms!r} ms unprofiled: idle share "
          f"{1.0 - busy / ms!r} on {card}", flush=True)


def phase_chirp_ldpc(dev: torch.device, card: str, rx: torch.Tensor):
    """The LDPC kernel against the plain decoder on the chirp cell's R1/4
    5 dB LLRs; returns (max abs error, kernel ms, plain ms)."""
    llrs = chirp_llrs(rx)
    err = compare_decoders(CHIRP_RATE, llrs, "chirp cell R1/4 5 dB LLRs")
    graph = ldpc_ops.graph_for(get_code(CHIRP_RATE), dev)
    k_ms, p_ms = time_decoders(graph, llrs, kernel_reps=20, plain_reps=5)
    print(f"decode at the chirp cell's R1/4 5 dB LLRs B={llrs.shape[0]}: "
          f"kernel {k_ms!r} ms, plain {p_ms!r} ms on {card}", flush=True)
    return err, k_ms, p_ms


def ofdm_chirp_tx(info: torch.Tensor) -> torch.Tensor:
    """[B, k] info bits -> [lead][dual chirp][tx_frame][tail] (T = 73,732)."""
    B, dev = info.shape[0], info.device
    chirp = torch.from_numpy(CH.generate(CC)).to(dev)
    return torch.cat([torch.zeros((B, MCP.LEAD), device=dev),
                      chirp.expand(B, chirp.shape[0]),
                      P.tx_frame(CFG, MOD, RATE, info),
                      torch.zeros((B, MCP.TAIL), device=dev)], dim=-1)


def decode_ofdm_after_chirp(rx: torch.Tensor):
    """detect_dual_chirp -> training start -> CFO phase there -> per-row
    frame gather -> rx_frame at the detected CFO and phase
    (modem/acquisition/chirp.py:336-351, batched).  Returns (info, ok
    (decoded and detected), iters, det)."""
    det = CH.detect_dual_chirp(CC, rx)
    tr = CH.training_start(CC, det["down_chirp_start"])
    phase = CH.initial_cfo_phase(CC, det["cfo_hz"], tr)
    span = CH.frame_spans(rx, tr, P.frame_samples(CFG, MOD))
    out, ok, iters = P.rx_frame(CFG, MOD, RATE, span, det["cfo_hz"], phase)
    return out, ok & det["success"], iters, det


def phase_ofdm_after_chirp(dev: torch.device) -> None:
    """OFDM_CHIRP frames behind a dual chirp, received at the detected
    training start, CFO and phase."""
    code = get_code(RATE)
    for i, cfo in enumerate(OFDM_CHIRP_CFOS):
        g = torch.Generator(device=dev).manual_seed(41 + i)
        info = torch.randint(0, 2, (CHIRP_BATCH, code.k), generator=g,
                             device=dev, dtype=torch.uint8)
        tx = ofdm_chirp_tx(info)
        require(tuple(tx.shape) == (CHIRP_BATCH, OFDM_CHIRP_T),
                f"OFDM chirp frames have shape {tuple(tx.shape)}")
        if cfo:
            tx = W.apply_cfo_hilbert(tx, cfo)
        rx = W.add_noise_active(tx, SNR_DB, g)
        torch.cuda.synchronize()
        cuda_ldpc.launches = 0
        out, ok, iters, det = decode_ofdm_after_chirp(rx)
        torch.cuda.synchronize()
        launches = cuda_ldpc.launches
        ok_rate = float(ok.float().mean())
        bits_exact = bool((out == info)[ok].all())
        c = det["cfo_hz"]
        print(f"OFDM after chirp, {cfo} Hz CFO, {SNR_DB} dB, B={CHIRP_BATCH} "
              f"T={OFDM_CHIRP_T}: ok_rate={ok_rate!r} bits_exact_on_ok="
              f"{bits_exact} detected cfo mean {float(c.mean())!r} min "
              f"{float(c.min())!r} max {float(c.max())!r} Hz, "
              f"mean_iters={float(iters.float().mean())!r} "
              f"kernel_launches={launches}", flush=True)
        require(launches > 0, "OFDM after chirp did not launch the LDPC kernel")
        require(ok_rate >= DECODE_GATE,
                f"OFDM after chirp ok rate {ok_rate} < {DECODE_GATE}")
        require(bits_exact, "OFDM after chirp: info bits differ on an ok lane")


def phase_fading(dev: torch.device) -> None:
    """One harness_moderate Watterson buffer of the chirp cell."""
    info, tx = chirp_tx(dev, 51)
    g = torch.Generator(device=dev).manual_seed(52)
    fade = torch.randn((2, CHIRP_BATCH, 2, CHIRP_T), generator=g, device=dev)
    awgn = torch.randn((CHIRP_BATCH, CHIRP_T), generator=g, device=dev)
    n = FADING_CPU_LANES
    for cfg, name in ((FADING, "harness_moderate"), (W.flutter(), "flutter")):
        taps = W.rayleigh_taps_with(cfg, fade[:, :n])
        ref = W.rayleigh_taps_with(cfg, fade[:, :n].cpu())
        rms = float(ref.abs().pow(2).mean().sqrt())
        err = float((taps.cpu() - ref).abs().max())
        close = bool(torch.isclose(taps.cpu(), ref, rtol=1e-4,
                                   atol=1e-4 * rms).all())
        print(f"fading taps [{name}] card vs CPU {n} lanes x 2 paths x "
              f"{CHIRP_T}: max_abs_err={err!r} rms={rms!r} close={close} "
              f"finite={bool(torch.isfinite(taps).all())}", flush=True)
        require(close and bool(torch.isfinite(taps).all()),
                f"{name} fading taps on the card differ from the CPU")
    rx = W.watterson_with(tx, FADING, fade, awgn)
    ref = W.watterson_with(tx[:n].cpu(), FADING, fade[:, :n].cpu(),
                           awgn[:n].cpu())
    err = float((rx[:n].cpu() - ref).abs().max())
    peak = float(ref.abs().max())
    print(f"Watterson harness_moderate {CHIRP_SNR_DB} dB output card vs CPU: "
          f"max_abs_err={err!r} of peak {peak!r}", flush=True)
    require(err <= 1e-4 * peak, "the Watterson channel on the card differs "
            "from the CPU")
    # Printed, not gated: a deeply faded lane can converge to another
    # codeword, in the JAX package as in the port, so the sweep scores
    # ok & exact bits against a pass rate of 0.60 for this point.
    out, ok, _, det = decode_chirp(rx)
    exact = ok & (out == info).all(-1)
    print(f"chirp path through harness_moderate at {CHIRP_SNR_DB} dB "
          f"B={CHIRP_BATCH}: ok_rate={float(ok.float().mean())!r} "
          f"ok_and_exact_rate={float(exact.float().mean())!r} "
          f"detect_rate={float(det['success'].float().mean())!r}",
          flush=True)


def main() -> None:
    t0 = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    dev = require_cuda()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(dev)}", flush=True)

    phase_build()
    phase_kernel_parity(dev)
    phase_tx_golden(dev)
    ldpc_launches, deint, ldpc_err = phase_main_path(dev)
    ldpc_ms, ldpc_plain_ms = phase_timing(dev, card, deint)

    _, tx = cox_tx(dev, 10)
    rx = noisy_buffers(tx, torch.Generator(device=dev).manual_seed(20), 1)[0]
    sc_err = phase_window_parity(dev, rx)
    phase_detection_parity(dev, rx)
    cox_launches = phase_cox_path(dev)
    sc_ms, sc_plain_ms = phase_cox_timing(dev, card)

    _, tx = chirp_tx(dev, 30)
    phase_chirp_detection(noisy_buffers(
        tx, torch.Generator(device=dev).manual_seed(35), 1, CHIRP_SNR_DB)[0])
    rx = phase_chirp_path(dev)
    phase_chirp_timing(dev, card)
    phase_chirp_ldpc(dev, card, rx)
    phase_ofdm_after_chirp(dev)
    phase_fading(dev)

    require("jax" not in sys.modules, "the run imported jax")
    print(f"total: {time.perf_counter() - t0!r} s", flush=True)
    print(card, flush=True)
    # launches: each kernel's count in the run of its own slice's path
    # (the LDPC kernel's in the slice-1 path; the counts of the Cox and
    # chirp paths are printed above).
    rows = [("ldpc_minsum", ldpc_launches, ldpc_err, ldpc_ms, ldpc_plain_ms),
            ("sc_windows", cox_launches["sc_windows"], sc_err, sc_ms,
             sc_plain_ms)]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source_of(name),
         "replaces": KERNELS[name][1], "launches": launches,
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        for name, launches, err, ms, plain_ms in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path -- OFDM_CHIRP (512-FFT, 30 carriers, no
pilots), DQPSK, LDPC R1/2, 17 dB AWGN, presynced receiver -- at a batch of
16,384 frames, through the entry points a user calls (``tx_frame``,
``add_noise_active``, ``rx_frame``), and checks it:

1. prints the card's name and power limit; no CUDA device -> exit 1;
2. builds the LDPC min-sum kernel from ``projectultra_tpu_torch/csrc``;
3. holds the kernel against the plain PyTorch decoder on the card (bits,
   ok flags and iteration counts equal on every lane) on the golden
   codewords of all five rates and on noisy waterfall batches;
4. holds TX on the card against the reference golden waveform;
5. runs the main path: decode rate >= 0.99 with exact info bits on every
   decoded frame, the kernel's launch counter grown, and the kernel equal
   to the plain decoder on the same LLRs;
6. times the main path (per step, per stage, and the device's idle share
   under ``torch.profiler``) and the kernel against the plain decoder.

Any failure raises and the script exits non-zero.  The last line of its
output is one JSON object naming the device.  It imports nothing of jax.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from projectultra_tpu_torch import CodeRate, Modulation, get_code, require_cuda
from projectultra_tpu_torch.ofdm import modulator as M
from projectultra_tpu_torch.ofdm import pipeline as P
from projectultra_tpu_torch.ops import cuda_ldpc
from projectultra_tpu_torch.ops import ldpc as ldpc_ops
from projectultra_tpu_torch.sim import watterson as W

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
KERNEL_SOURCE = "projectultra_tpu_torch/csrc/ldpc_minsum.cu"
KERNEL_REPLACES = "projectultra_tpu/ops/pallas_ldpc.py:102"


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


def time_decoders(graph, llrs: torch.Tensor, kernel_reps: int,
                  plain_reps: int) -> tuple[float, float]:
    """(kernel ms, plain ms), measured in turns plain, kernel, kernel,
    plain; each the mean of its two turns."""
    def kernel():
        cuda_ldpc.decode_cuda(graph, llrs)

    def plain():
        ldpc_ops.decode_plain(graph, llrs)

    p1 = time_ms(plain, plain_reps)
    k1 = time_ms(kernel, kernel_reps)
    k2 = time_ms(kernel, kernel_reps)
    p2 = time_ms(plain, plain_reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


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

def phase_build() -> None:
    cuda_ldpc.load_library()
    print(f"kernel build: {cuda_ldpc.build_seconds!r} s "
          f"({KERNEL_SOURCE}, nvcc sm_90a)", flush=True)
    for report in sorted(cuda_ldpc.BUILD_DIR.glob("*.ptxas.txt")):
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
    launches, deint, err = phase_main_path(dev)
    k_ms, p_ms = phase_timing(dev, card, deint)

    require("jax" not in sys.modules, "the run imported jax")
    print(f"total: {time.perf_counter() - t0!r} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "ldpc_minsum", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

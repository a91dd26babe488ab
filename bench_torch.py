#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: bench.py's three
correctness-gated workloads through ``projectultra_tpu_torch``.

    python3 bench_torch.py          # on the card (one rank per visible card)
    python3 bench_torch.py --cpu    # bench.py's sanity sizes on the CPU

1. The presynced frame pipeline (BASELINE.json config #2): LDPC encode
   (R1/2, 648 bits) -> channel interleave -> OFDM modulate (OFDM_CHIRP:
   512-FFT, 30 carriers, DQPSK, 2 LTS training) -> AWGN at 17 dB ->
   presynced demodulate -> deinterleave -> LDPC min-sum decode.  One step
   is ``tx_frame`` -> ``add_noise_active`` -> ``rx_frame`` on 16,384
   frames; a repeat times 256 steps, each on fresh noise.
2. Chirp acquisition (BASELINE config #5): MC-DPSK ``level10()``, R1/4,
   5 dB, every frame at an unknown position in an 83,808-sample buffer;
   ``decode_chirp_batch`` (dual-chirp detection over the whole buffer ->
   cut at the detected training start -> demodulate at the detected CFO
   -> decode) on 32 buffers of 256 frames a repeat.
3. Schmidl-Cox acquisition, the reference's other hard sync:
   ``ModemConfig()`` (the 512-FFT pilot plan), DQPSK, R1/2, 17 dB,
   T = 18,856; ``decode_cox_batch`` (STS plateau search -> LTS fine timing
   -> cut at the detected LTS -> pilot-tracked demodulation at the
   detected CFO -> deinterleave -> decode) on 32 buffers of 512 frames a
   repeat.

Each metric is the best of three repeats and carries bench.py's gate: the
ok rate (decoded, and detected) of the untimed warm-up step and of every
repeat is at least 0.99, and the info bits are exact -- on every lane of
the main path's warm-up step, on the ok lanes of an acquisition's first
buffer -- else the metric is 0: a fast but wrong pipeline is worthless.

The fast modes are bench.py's: bf16 LDPC edge messages in every decode
and the chirp acquisition's bf16 refine and decimation, each on unless
``ULTRA_LDPC_BF16`` / ``ULTRA_CHIRP_BF16`` is set to something other than
"1" (bench.py's ``os.environ.setdefault``).  They run inside the port's
scoped switches, restored on exit; nothing here writes ``os.environ``.

Without a card the script raises unless ``--cpu`` is given; no kernel or
device failure falls back to the CPU or to the plain decoder.  Prints
ONE JSON line last, with bench.py's keys.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from projectultra_tpu_torch import CodeRate, ModemConfig, Modulation, get_code
from projectultra_tpu_torch.device import card_line, resolve
from projectultra_tpu_torch.ofdm import pipeline as P
from projectultra_tpu_torch.ops import cuda_ldpc, cuda_sc
from projectultra_tpu_torch.ops import ldpc as ldpc_ops
from projectultra_tpu_torch.parallel import mesh as PM
from projectultra_tpu_torch.psk import mc_dpsk as MC
from projectultra_tpu_torch.sim import watterson as W
from projectultra_tpu_torch.sync import chirp as CH
from projectultra_tpu_torch.sync import schmidl_cox as SC

TARGET_PIPELINES_PER_SEC = 10_000.0  # BASELINE.md north star
DECODE_GATE = 0.99
FAST_MODES = ("ULTRA_LDPC_BF16", "ULTRA_CHIRP_BF16")

CFG = P.chirp_ofdm_config()
MOD = Modulation.DQPSK
RATE = CodeRate.R1_2
SNR_DB = 17.0

ACQ_MC = MC.level10()
ACQ_RATE = CodeRate.R1_4
ACQ_SNR_DB = 5.0

COX_CFG = ModemConfig()  # the default 512-FFT pilot plan (OFDM_COX)
COX_LEAD, COX_TAIL = 1504, 1024
COX_SNR_DB = 17.0


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Frames and steps of each workload.  The defaults are bench.py's,
    so the two benches time the same work (its batch was chosen on the
    TPU; the card's best batch is not measured yet)."""
    batch: int = 16384      # main-path frames a step
    iters: int = 256        # main-path steps a repeat
    acq_batch: int = 256    # chirp frames a buffer
    acq_iters: int = 32     # chirp buffers a repeat
    cox_batch: int = 512    # Schmidl-Cox frames a buffer
    cox_iters: int = 32     # Schmidl-Cox buffers a repeat
    # Best of three: a repeat can run slow for reasons that are not the
    # workload's (host-bound steps spread between runs), and every repeat
    # is a full, fresh-input, gated run, so the best inflates nothing.
    repeats: int = 3


FULL = Sizes()
SANITY = Sizes(512, 4, 16, 2, 16, 2, 1)  # bench.py's ULTRA_BENCH_CPU=1 sizes


@dataclasses.dataclass(frozen=True)
class Result:
    value: float       # items/s of the best repeat; 0 when the gate fails
    ok_rate: float     # the lowest ok rate of the warm-up and the repeats
    seconds: tuple     # each repeat's time (the slowest rank's)
    ok_counts: tuple   # ok lanes of the warm-up step, then of each repeat


def fast_modes(environ=os.environ) -> tuple[bool, bool]:
    """(bf16 LDPC messages, bf16 chirp acquisition) as bench.py's
    ``os.environ.setdefault(name, "1")`` leaves them: unset or "1" is on,
    any other value off (the port reads ``== "1"``, as JAX does)."""
    return tuple(environ.get(name, "1") == "1" for name in FAST_MODES)


@contextlib.contextmanager
def switched(modes: tuple[bool, bool]):
    """Both fast modes set as ``modes`` inside the block, restored after."""
    ldpc_bf16, chirp_bf16 = modes
    msg = torch.bfloat16 if ldpc_bf16 else torch.float32
    with ldpc_ops.default_msg_dtype(msg), CH.bf16_mode(chirp_bf16):
        yield


def generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launches() -> dict:
    """Kernel launches so far in this process, by kernel."""
    return {"ldpc_minsum": cuda_ldpc.launches,
            "ldpc_minsum_bf16": cuda_ldpc.launches_bf16,
            "sc_windows": cuda_sc.launches}


def gate(rate: float, ok_rates: list, bits_exact: bool) -> tuple:
    """bench.py's guard: (rate, or 0 when the lowest ok rate is under
    DECODE_GATE or a checked lane's bits are wrong; the lowest ok rate)."""
    ok_rate = min(ok_rates)
    return (rate if ok_rate >= DECODE_GATE and bits_exact else 0.0), ok_rate


def timed_loop(step, inputs, device: torch.device):
    """(seconds, ok flags [n, B] on the host) of ``step`` over each input in
    turn: the host clock around the steps, one read of every step's ok
    flags and of the first bit of its output, then a synchronize."""
    synchronize(device)
    t0 = time.perf_counter()
    probes, oks = [], []
    for x in inputs:
        out, ok = step(x)
        probes.append(out[0, 0])
        oks.append(ok)
    oks = torch.stack(oks).cpu()
    torch.stack(probes).cpu()
    synchronize(device)
    return time.perf_counter() - t0, oks


# ---------------------------------------------------------------------------
# 1. The presynced frame pipeline
# ---------------------------------------------------------------------------

def main_info(batch: int) -> np.ndarray:
    """bench.py's info bits of the main path: numpy seed 0, float32."""
    k = get_code(RATE).k
    return np.random.default_rng(0).integers(
        0, 2, size=(batch, k)).astype(np.float32)


def noisy(tx: torch.Tensor, g: torch.Generator, rank: int = 0,
          world: int = 1) -> torch.Tensor:
    """The harness AWGN at SNR_DB on this rank's rows ``tx`` [b, T].  A
    rank of a larger world draws the normals of all ``b * world`` rows
    and keeps its own, so each frame's noise does not depend on the world
    size (as JAX's noise on a sharded batch)."""
    if world == 1:
        return W.add_noise_active(tx, SNR_DB, g)
    b = tx.shape[0]
    noise = torch.randn((b * world, tx.shape[1]), generator=g,
                        device=tx.device)
    return W.add_noise_with(tx, SNR_DB, noise[rank * b:(rank + 1) * b])


def main_step(info: torch.Tensor, g: torch.Generator, rank: int = 0,
              world: int = 1):
    """One main-path step, the noise inside it as in bench.py's ``_step``:
    (decoded bits [b, k] uint8, ok [b] bool)."""
    tx = P.tx_frame(CFG, MOD, RATE, info)
    out, ok, _ = P.rx_frame(CFG, MOD, RATE, noisy(tx, g, rank, world))
    return out, ok


def time_main(info: torch.Tensor, sizes: Sizes, rank: int = 0,
              world: int = 1):
    """The main path on this rank's rows ``info`` [b, k]: the untimed
    warm-up step (noise seed 0; it also builds the kernels on first use),
    then ``sizes.repeats`` timed runs of ``sizes.iters`` steps (seed
    1 + repeat).  Returns (each repeat's seconds, [warm-up ok lanes, lanes
    of the warm-up with any wrong bit, each repeat's ok lanes])."""
    dev = info.device
    out, ok = main_step(info, generator(dev, 0), rank, world)
    counts = [int(ok.sum()), int((out != info.to(torch.uint8)).any(-1).sum())]
    seconds = []
    for rep in range(sizes.repeats):
        g = generator(dev, 1 + rep)
        dt, oks = timed_loop(lambda _: main_step(info, g, rank, world),
                             range(sizes.iters), dev)
        seconds.append(dt)
        counts.append(int(oks.sum()))
    return seconds, counts


def _main_rank(mesh: PM.FrameMesh, sizes: Sizes, modes: tuple):
    """One rank of the sharded main path (spawned by ``PM.run_ranks``):
    (its seconds a repeat, the counts summed over the group)."""
    info = PM.shard_frames(mesh, main_info(sizes.batch))
    with switched(modes):
        seconds, counts = time_main(info, sizes, mesh.rank, mesh.world)
    return seconds, PM.all_sum(mesh, torch.tensor(counts)).tolist()


def bench_main(sizes: Sizes, device: torch.device, modes: tuple,
               world: int = 1) -> Result:
    """Pipelines/s of the main path, gated.  With ``world`` > 1 the frame
    batch is split over that many ranks (frames never communicate), each
    times its own rows, and the rate is over the slowest rank's time."""
    if world == 1:
        info = torch.from_numpy(main_info(sizes.batch)).to(device)
        with switched(modes):
            seconds, counts = time_main(info, sizes)
        per_rank = [seconds]
    else:
        ranks = PM.run_ranks(_main_rank, world, device, sizes, modes)
        per_rank = [seconds for seconds, _ in ranks]
        counts = ranks[0][1]
    slowest = tuple(max(s) for s in zip(*per_rank))
    pps = max(sizes.batch * sizes.iters / s for s in slowest)
    warm_ok, warm_wrong, *rep_ok = counts
    ok_rates = [warm_ok / sizes.batch] \
        + [c / (sizes.batch * sizes.iters) for c in rep_ok]
    value, ok_rate = gate(pps, ok_rates, warm_wrong == 0)
    return Result(value, ok_rate, slowest, (warm_ok, *rep_ok))


# ---------------------------------------------------------------------------
# 2-3. The acquisition workloads
# ---------------------------------------------------------------------------

def chirp_info(batch: int) -> np.ndarray:
    """bench.py's info bits of the chirp workload: numpy seed 7."""
    k = get_code(ACQ_RATE).k
    return np.random.default_rng(7).integers(
        0, 2, size=(batch, k)).astype(np.float32)


def chirp_tx(info: torch.Tensor) -> torch.Tensor:
    """[LEAD zeros][chirp][training][reference][codeword][TAIL zeros]."""
    return MC.tx_chirp_frame(ACQ_MC, ACQ_RATE, info)


def chirp_step(rx: torch.Tensor):
    out, ok, _, _ = MC.decode_chirp_batch(ACQ_MC, ACQ_RATE, rx)
    return out, ok


def cox_info(batch: int) -> np.ndarray:
    """bench.py's info bits of the Schmidl-Cox workload: numpy seed 11."""
    k = get_code(RATE).k
    return np.random.default_rng(11).integers(
        0, 2, size=(batch, k)).astype(np.float32)


def cox_tx(info: torch.Tensor) -> torch.Tensor:
    """[1,504 zeros][preamble][interleaved codeword][1,024 zeros]."""
    return P.tx_cox_frame(COX_CFG, MOD, RATE, info, lead=COX_LEAD,
                          tail=COX_TAIL)


def cox_step(rx: torch.Tensor):
    out, ok, _, _ = SC.decode_cox_batch(COX_CFG, MOD, RATE, rx)
    return out, ok


def time_acquisition(step, info: torch.Tensor, tx: torch.Tensor,
                     iters: int, repeats: int, snr_db: float,
                     seed: int) -> Result:
    """Frames/s of an acquisition step, gated (bench.py's ``_bench_acq``).

    Only the step is timed: the channel noise is harness set-up and says
    nothing about acquisition speed, so each repeat's ``iters`` noisy
    buffers are made untimed beforehand, each a fresh input (seed
    ``seed + 1 + repeat``).  The untimed warm-up step runs on a buffer of
    seed ``seed``; its ok lanes must carry exact bits."""
    dev = tx.device
    truth = info.to(torch.uint8)
    out, ok = step(W.add_noise_active(tx, snr_db, generator(dev, seed)))
    ok_counts = [int(ok.sum())]
    bits_exact = bool((out[ok] == truth[ok]).all())
    best, seconds = 0.0, []
    for rep in range(repeats):
        # Free the last set before making the next: two sets of
        # iters x B x T float32 buffers need not fit at once.
        rx_all = None
        g = generator(dev, seed + 1 + rep)
        rx_all = [W.add_noise_active(tx, snr_db, g) for _ in range(iters)]
        dt, oks = timed_loop(step, rx_all, dev)
        seconds.append(dt)
        ok_counts.append(int(oks.sum()))
        best = max(best, tx.shape[0] * iters / dt)
    B = tx.shape[0]
    ok_rates = [ok_counts[0] / B] + [c / (B * iters) for c in ok_counts[1:]]
    value, ok_rate = gate(best, ok_rates, bits_exact)
    return Result(value, ok_rate, tuple(seconds), tuple(ok_counts))


def bench_chirp(sizes: Sizes, device: torch.device, modes: tuple) -> Result:
    info = torch.from_numpy(chirp_info(sizes.acq_batch)).to(device)
    with switched(modes):
        return time_acquisition(chirp_step, info, chirp_tx(info),
                                sizes.acq_iters, sizes.repeats, ACQ_SNR_DB,
                                seed=3)


def bench_cox(sizes: Sizes, device: torch.device, modes: tuple) -> Result:
    info = torch.from_numpy(cox_info(sizes.cox_batch)).to(device)
    with switched(modes):
        return time_acquisition(cox_step, info, cox_tx(info),
                                sizes.cox_iters, sizes.repeats, COX_SNR_DB,
                                seed=13)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def _run(label: str, fn, card: str) -> Result:
    """fn's Result, printed with its kernel launches in this process."""
    before = launches()
    t0 = time.perf_counter()
    r = fn()
    wall = time.perf_counter() - t0
    used = {k: v - before[k] for k, v in launches().items()}
    print(f"{label}: {r.value!r}/s (gated), ok rate {r.ok_rate!r}, repeats "
          f"{list(r.seconds)!r} s, ok lanes {list(r.ok_counts)}, wall "
          f"{wall!r} s, kernel launches {used} on {card}", flush=True)
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="bench.py's three workloads on the PyTorch/CUDA port")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU at bench.py's sanity sizes "
                         "(its ULTRA_BENCH_CPU=1)")
    args = ap.parse_args(argv)
    device = resolve("cpu" if args.cpu else None)
    sizes = SANITY if args.cpu else FULL
    modes = fast_modes()
    # Several cards: shard the main path's frames over all of them, one
    # rank each (pure data parallelism).  One card runs in this process.
    world = torch.cuda.device_count() if device.type == "cuda" else 1
    if sizes.batch % world:
        world = 1
    card = card_line(device)
    print(f"device {device}, {world} rank(s): {card}", flush=True)
    print(f"fast modes: bf16 LDPC messages {'on' if modes[0] else 'off'}, "
          f"bf16 chirp acquisition {'on' if modes[1] else 'off'}",
          flush=True)
    t0 = time.perf_counter()
    main_r = _run(f"main path ({sizes.batch} frames x {sizes.iters} steps)",
                  lambda: bench_main(sizes, device, modes, world), card)
    acq = _run(f"chirp ({sizes.acq_iters} buffers of {sizes.acq_batch})",
               lambda: bench_chirp(sizes, device, modes), card)
    cox = _run(f"Schmidl-Cox ({sizes.cox_iters} buffers of "
               f"{sizes.cox_batch})", lambda: bench_cox(sizes, device, modes),
               card)
    per = "cpu-sanity" if args.cpu else "gpu"
    result = {
        "metric": "ofdm_dqpsk_r12_frame_pipelines_per_sec",
        "value": round(main_r.value, 1),
        "unit": f"pipelines/s/{per}",
        "vs_baseline": round(main_r.value / TARGET_PIPELINES_PER_SEC, 3),
    }
    if main_r.value == 0.0:
        result["decode_ok_rate"] = main_r.ok_rate
    result.update({
        "acq_metric": "mcdpsk_chirp_acquisition_frames_per_sec",
        "acq_value": round(acq.value, 1),
        "acq_unit": f"frames/s/{per}",
        "acq_decode_ok_rate": round(acq.ok_rate, 4),
        "cox_metric": "ofdm_cox_acquisition_frames_per_sec",
        "cox_value": round(cox.value, 1),
        "cox_unit": f"frames/s/{per}",
        "cox_decode_ok_rate": round(cox.ok_rate, 4),
    })
    print(f"wall: {time.perf_counter() - t0!r} s", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
  CFO; and one buffer through the Watterson ``harness_moderate`` channel;
* slice 5, the rest of the PHY, each at the batch of the repo's bench
  cells with fresh noise from a ``torch.Generator``: NVIS coherent
  (``nvis_mode()``, 1,024-FFT, 59 carriers, no pilots; BASELINE config
  #4) through ``decode_cox_batch`` at QAM32 R3/4 30 dB and QAM256 R5/6
  42 dB, 10 Hz, B = 512, and 32-codeword QAM256 R5/6 frames at B = 64;
  QAM256 R2/3 on the 512-FFT pilot plan, 30 dB, B = 512; single-carrier
  DPSK (BASELINE config #1) through ``decode_dpsk_batch`` at ``medium``
  0 dB B = 256 and ``robust`` -11 dB B = 64 (its preamble search through
  the hand-written score kernel, ``csrc/dpsk_score.cu``, held to the
  plain score on each path's correlations, at one NaN and one +inf
  correlation and on the engine's B = 1 search view, and timed beside the
  path with the plain score it replaced); the delay-fit retry
  (``high_throughput()``, QAM16 R2/3, 8 codewords, Watterson ``good()``
  then 20 dB, B = 256); the five MFSK presets at their operating points
  through ``decode_mfsk_batch``, B = 256; OTFS through
  ``decode_otfs_batch`` at 20 dB and through Watterson ``good(25)``,
  B = 256;
* slice 6, the streaming modem engine -- ``ModemEngine(device=cuda)``'s
  ``feed_audio``/``poll``: the reference CLI's five TX files, and a
  minute of a station's received traffic (MC-DPSK control frames, 11
  OFDM_COX QPSK R1/2 data frames of 100-1,000 bytes) built from a numpy
  seed;
* slice 7, the protocol stack and the CLI -- ``cli.main(argv,
  device=cuda)``'s ``ptx`` and ``prx``, and two
  ``ProtocolEngine(device=cuda)`` stations holding a session over the
  air (connect, messages, a file, a mode change, disconnect) and a
  second one over the Watterson channel;
* slice 8, the sweep harness and frame-axis data parallelism --
  ``parallel.sweep.run_point(point, device=cuda)`` over the 13 rows of the
  regression matrix and ``run_point_stream`` over two single-stream
  rows; ``parallel.dcn.acq_sweep_counts`` (MC-DPSK level10 acquisition,
  256 frames at 5 dB) at world 1 over NCCL and at world 2 in two
  processes over gloo; ``parallel.dryrun.dryrun_multichip(2)``;
* slice 9, the bf16 fast modes and the tool twins -- the LDPC kernel's
  bf16-message instantiation, the main path and the chirp cell with
  ``ops.ldpc.default_msg_dtype(torch.bfloat16)`` and
  ``sync.chirp.bf16_mode()`` on, and the ``main`` of
  ``tools/torch_{ber_curves,test_hf_reality,cli_simulator,
  threaded_simulator,test_iwaveform,profile_acquisition}.py``;
* slice 10, the measurement tools -- the ``main`` of
  ``tools/torch_{test_throughput,test_mode_snr,test_dpsk_snr,
  test_otfs_vs_ofdm,test_sync_robustness,test_sro,test_cfo_ramp,
  test_interferer_onset,test_session_throughput,
  test_calibrated_negotiation,calibrate_mode_table,calibrate_snr}.py``:
  frame-level sweeps at their default sizes, the streaming-engine
  harnesses (clock skew, Doppler ramp, interferer onset) and two-station
  sessions at cut sizes (``MEASUREMENT_TOOLS``);
* slice 11, the front-ends and the parity overlay -- the ``main`` of
  ``tools/torch_{tui,webui,parity_curves}.py``: the tui's ``--sim``
  session, the web console's scripted HTTP session and the overlay
  against the reference's counts at a cut (``PARITY_CUT``);
* slice 12, the port's bench -- ``bench_torch.py``, bench.py's twin: its
  three workloads (presynced pipelines/s, chirp and Schmidl-Cox
  acquisition frames/s) at bench.py's sizes with both bf16 modes on.

Phases:

1. prints the card's name and power limit; no CUDA device -> exit 1;
2. builds both kernels from ``projectultra_tpu_torch/csrc`` (one nvcc per
   source, started together);
3. holds the LDPC kernel against the plain PyTorch decoder on the card
   (bits, ok flags and iteration counts equal on every lane) on the golden
   codewords of all five rates and on noisy waterfall batches, and on
   those batches with +-inf or NaN LLRs in every other lane
   (``nonfinite_llrs``; totals equal too, NaN to NaN);
4. holds TX on the card against the reference golden waveform;
5. runs the slice-1 path: decode rate >= 0.99 with exact info bits on
   every decoded frame, the LDPC kernel's launch counter grown, and the
   kernel equal to the plain decoder on the same LLRs; times it (per step,
   per stage, the device's idle share under ``torch.profiler``) and the
   kernel against the plain decoder;
6. holds the Schmidl-Cox window kernel against its plain version at
   stride 1 and 8 (rtol 2e-4, atol 2e-3) on random analytic signals and on
   Cox buffers, and on one 600,000-sample buffer against float64 (relative
   error < 1e-4); at one +inf or NaN sample in the Cox buffer and in an
   engine-shaped B = 1 view (strides 1 and 8, half 256 and 512: non-finite
   at exactly the plain version's outputs, of the same kind); on a B = 1
   row of 4,000,000 samples, where every block walks several work items
   (each comparison prints the launch's plan: tile, items, blocks, ring
   stages, shared bytes); detection through the kernel against detection
   through the plain version (found and lts_start identical on every
   lane);
7. runs the Cox path: ok rate >= 0.99 with exact info bits on ok lanes
   over 32 buffers, both kernels' launch counters grown, a 30 Hz CFO
   buffer at 20 dB by the same gate, and 64 lanes equal to the CPU path;
   times it (frames/s, per stage, idle share), the window kernel
   against its plain version and the LDPC kernel against the plain
   decoder on a Cox buffer's LLRs (lane-exact, both timed);
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
    the CPU, and the MC-DPSK ok rate through it (printed, not gated);
13. slice 5's paths: each asserts the launch counters of the kernels it
    runs grew (the window kernel's on the Cox paths), gates decode rate
    >= 0.99 with exact info bits on every ok lane, holds 8-16 lanes to the
    port's CPU path, and prints ms per buffer, stages and the idle share
    (``path_timing``).  Where the JAX package misses the same lanes (a
    CPU test runs such lanes through both), the point is gated on card =
    CPU and its rate printed: NVIS R3/4 and R5/6 lanes that decode ok with
    wrong bits (parity-free info bits; their ok rate stays gated), the
    32-codeword frames, MFSK ``robust``'s early preamble search and OTFS's
    late fine timing.  The delay fit must recover >= 4 codewords the
    standard pass loses, its LLRs within rtol 1e-3, atol 2e-3 of the CPU
    on 16 lanes.  The LDPC kernel is held lane-exact to the plain decoder
    on the NVIS LLRs (R3/4, R5/6 at B = 512 and 64 x 32) and DPSK
    ``robust``'s -11 dB R1/4 LLRs, the window kernel to its plain version
    at half = 512 (strides 8 and 1) on an NVIS buffer; all are timed.
    The 512-plan QAM256 point draws its info bits and noise with numpy
    (``pilot_high_order_buffers``) and prints the lanes it misses, held to
    the CPU path (tests/test_torch_high_order.py rebuilds them for JAX);
    the delay fit's LDPC decode (2,048 codewords, trap_escape) is timed;
14. ``phase_engine``: the five ``ref_cli_tx_*.f32`` files (each followed
    by 8,000 zeros) streamed through ModemEngine on the card and on the
    CPU in 960-sample chunks with a poll after each: the frames
    tests/test_ref_interop.py asserts, and the card's events and consumed
    position after every poll equal to the CPU's; 60 s of traffic through
    one connected OFDM_COX station on the card, a poll every 100 ms: every
    frame delivered once, in order, with exact bytes, nothing else, and
    the real-time factor, poll ms, ms of the poll that delivered each
    frame by waveform, the device's idle share over a profiled 10 s of
    audio and the launches of both kernels printed; both kernels at the
    engine's shapes (windows over one 262,144-sample search view, B = 1;
    LDPC at the stream's B = 1 and largest decodes, trap_escape) against
    their plain versions and timed.  Both kernels' launch counters must
    grow in each run of the engine;
15. ``phase_protocol``: the port CLI's ``ptx`` of PING, CONNECT,
    DISCONNECT and a text with ``-w ofdm``, ``dpsk`` and ``mcdpsk`` on the
    card against the CPU port (audio within 2e-4, DPSK 5e-4; the same
    report), and ``prx`` of the reference's five files (the same stderr);
    then two ``ProtocolEngine`` stations on the card, each TX queued and
    handed to the other station in order: a clean session (chirp
    PING/PONG, MC-DPSK CONNECT, three messages each way, a 2,048-byte
    numpy-seeded file, a requested MODE_CHANGE and a message after it, a
    disconnect) and a lossy one (the Watterson ``moderate`` channel at
    8 dB on the card from numpy normals, ten messages each way), each
    under ``torch.profiler`` for the device's idle share.  Gates: the file byte-exact, every
    message once and in order, the data modes of both ends equal after
    the change, the clean session closed and the lossy one up, both
    kernels launched in the clean session and the LDPC kernel in the
    lossy one (counters set to 0 just before each session, read just
    after).  Printed per session: wall seconds, seconds of audio
    exchanged, transmissions each way, frames decoded, retransmissions,
    transmit and receiving-poll ms; then the LDPC kernel at the sessions'
    largest decode against the plain decoder and its bound;
16. ``phase_sweep``: every REGRESSION_MATRIX row through ``run_point`` on
    the card with its own generator, at the batch the earlier phases run
    its waveform at (MC-DPSK and OFDM_CHIRP 256, DPSK ``medium`` 256 and
    ``robust`` 64): decode rate >= the row's minimum and the LDPC kernel
    launched; a row that misses is rebuilt from numpy-seeded noise and,
    if it misses again, gated on the CPU port missing the same lanes
    (a CPU test can hand the same numpy noise to JAX).  Printed per row:
    decode, detected, BER, CFO error, ms a point and frames/s (best of
    2), the idle share and the LDPC launches.  Then ``run_point_stream``
    at 3 frames for MC-DPSK 5 dB and OFDM_COX 17 dB R1/2 (every frame
    delivered, else the CPU engine delivers the same ones from the same
    noisy stream), wall time and launches; the Cox row must launch the
    window kernel;
17. ``phase_parallel``: ``acq_sweep_counts`` at world 1 over NCCL (all 256
    frames decoded exactly, the LDPC kernel launched) and at world 2 in
    two spawned processes over gloo sharing the card (counts identical,
    each rank launching the LDPC kernel), the all-reduce's ms; then
    ``dryrun_multichip(2)`` on the card (every step of both ranks
    decodes every frame, each rank launches both kernels);
18. ``phase_bf16`` (run right after phase 5, on its LLRs): the LDPC
    kernel's bf16 instantiation against the plain
    decoder with bf16 messages, lane-exact (bits, ok, iterations) on the
    main path's 17 dB LLRs (B = 16,384), the sigma 0.62 waterfall batch of
    16,384, an R1/4 sigma 1.1 batch with trap_escape, a batch of LLRs
    near +-3e38 and +-1e-40 (``extreme_llrs``) and phase 3's batches with
    +-inf and NaN LLRs (``nonfinite_llrs``, totals NaN-equal), and its
    shared bytes per
    block beside the float32 one's (check-row records); its call ms
    beside the float32 kernel's at the first two (CUDA events, turns f32,
    bf16, bf16, f32) and its device ms against its bound at all three
    (the same LLR bytes); tests/test_ldpc.py's two bf16-vs-f32 rate
    gates on the card; the main path with bf16
    messages as the default (the bench's gate; only the bf16 kernel
    launched: its count is the ``kernels`` line's) and the chirp cell
    (32 buffers of 256, 5 dB) with both bf16 modes on (the bench's gate,
    detection equal to the CPU's bf16 mode on 64 lanes, frames/s and
    device busy beside the float32 path's on the same buffers); both
    switches restored;
19. ``phase_tools``: each tool twin's ``main`` on the card, exit 0 and its
    JSON result printed with its kernel launches: ``ber_curves --frames
    256`` with float32 and with bf16 messages (every point's FER within
    0.04 of the other; each run through its own kernel only),
    ``test_hf_reality --quick`` (all five gates), ``cli_simulator``,
    ``threaded_simulator``, ``test_iwaveform --frames 5`` batched and
    ``--stream`` (every frame decoded), ``profile_acquisition --seconds
    2`` (the 1.2 s dual chirp needs more than 1 s) in float32 and bf16;
    then slice 10's measurement tools (``measurement_tools``), each
    timed: ``test_throughput`` (15 rows, 8 codewords; each row held to the
    JAX tool's table), ``test_mode_snr``, ``test_dpsk_snr``,
    ``test_otfs_vs_ofdm`` and ``test_sync_robustness`` (ALL PASS) at their
    default trials, ``test_sro --quick --frames 1`` at 0 and +-100 ppm
    (the clock-skew retry fired at +100 ppm), ``test_cfo_ramp`` on the
    Cox DQPSK and MC-DPSK
    rows at three frames, ``test_interferer_onset --sir 5``,
    ``test_session_throughput`` on the 512-plan 26 dB row,
    ``test_calibrated_negotiation`` on three points (AWGN and fading
    20 dB, the 26 dB climb), ``calibrate_mode_table`` on its three
    OFDM_COX DQPSK rows and ``calibrate_snr``, both at one trial;
    each exits 0 (its own gate), launching the LDPC kernel, and the
    window kernel where it searches for a Schmidl-Cox preamble; the five
    frame-level tools' kernel launches are recorded and both kernels
    timed against their bounds on each tool's smallest and largest
    batch;
20. ``phase_frontends``: ``tui --sim`` (RESULT: PASS, the LDPC kernel
    launched), ``webui --script --port 0`` (PASS, both kernels launched)
    and ``parity_curves --points 5,19,20,21,22`` (MC-DPSK 15 dB poor,
    OFDM_CHIRP 15 dB poor and the three OFDM_COX points over seeds 42-44:
    ours >= the reference's count at every point, the Cox points >= 80%),
    each timed with its kernel launches;
21. ``phase_bench``: ``python3 bench_torch.py`` as a fresh process (exit
    0; bench.py's keys, three values > 0, both acquisition ok rates >=
    0.99, no main-path failure), then one step of each of its workloads
    in this process with its fast modes on: the bf16 LDPC kernel launched
    in all three and the float32 one in none, the window kernel in the
    Schmidl-Cox step, the bench's gate on each; the bf16 kernel
    lane-exact with the plain bf16 decoder and timed at the chirp and
    Schmidl-Cox buffers.

Beside the timings, every kernel is timed at each shape its paths give it
(LDPC: R1/2 17 dB B = 16,384, the R1/2 sigma 0.62 waterfall batch of
16,384 with its mean iterations, a Cox buffer B = 512, the chirp cell's
R1/4 B = 256, slice 5's R3/4, R5/6 and -11 dB R1/4 LLRs; window sums:
strides 8 and 1 on a Cox buffer, stride 8 at half = 512; the engine's
B = 1 shapes; the bf16 instantiation at the bench's chirp and Cox
buffers) and printed
with its bound -- the larger of its bytes over 3.35 TB/s and its float32
operations over 67 TFLOP/s, counted on the run's own data -- the bound's
basis and the share of the bound the kernel reaches.  There a kernel's
time is its device time per launch under ``torch.profiler`` (without the
wrapper's host overhead, which dominates a small batch's call time); the
call time is printed beside it.  The ``kernels`` line's ``ms`` and
``plain_ms`` are both call times (CUDA events around back-to-back calls,
wrapper included), at the main path's shape of each kernel.

Any failure raises and the script exits non-zero.  The last line of its
output is one JSON object naming the device.  It imports nothing of jax.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import inspect
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import bench_torch as BT
from projectultra_tpu_torch import (CodeRate, ModemConfig, Modulation,
                                    get_code, require_cuda)
from projectultra_tpu_torch.config import high_throughput, nvis_mode
from projectultra_tpu_torch.device import card_line as device_card_line
from projectultra_tpu_torch import cli, native
from projectultra_tpu_torch.fec.ldpc import DEFAULT_MAX_ITERS
from projectultra_tpu_torch.modem.engine import ModemEngine
from projectultra_tpu_torch.ofdm import delay_fit as DF
from projectultra_tpu_torch.ofdm import demodulator as D
from projectultra_tpu_torch.ofdm import modulator as M
from projectultra_tpu_torch.ofdm import pipeline as P
from projectultra_tpu_torch.ops import (cuda_build, cuda_dpsk, cuda_ldpc,
                                        cuda_sc)
from projectultra_tpu_torch.ops import dpsk_score as DS
from projectultra_tpu_torch.ops import ldpc as ldpc_ops
from projectultra_tpu_torch.ops.sc_windows import sc_windows_plain
from projectultra_tpu_torch.otfs import otfs as OT
from projectultra_tpu_torch.parallel import dcn, dryrun
from projectultra_tpu_torch.parallel import mesh as PM
from projectultra_tpu_torch.parallel import sweep as SW
from projectultra_tpu_torch.protocol import frame_v2 as F
from projectultra_tpu_torch.protocol.engine import ProtocolEngine as PE
from projectultra_tpu_torch.psk import dpsk as DP
from projectultra_tpu_torch.psk import fsk as FS
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
# The card's published peaks (H100 SXM, 700 W): the bound of a kernel is
# the larger of its bytes over the memory rate and its operations over the
# float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# float32 operations per edge and iteration of the min-sum decoder: v2c
# (sub, 2 clamps), two-minima update (abs, 2 compares, 3 selects), c2v
# (select, sign, scale), the variable sum's add and the syndrome's
# compare and xor.
LDPC_OPS_PER_EDGE = 14
# float32 operations per sample of the window pre-reduction: energy (2 mul,
# add, accumulate) and correlation (4 mul, 2 add, 2 accumulate).
SC_OPS_PER_SAMPLE = 12
# float32 operations of DPSK's score: per sample its energy (hypot: 2 mul,
# add, sqrt; the square) and its differential (complex product 6, hypot 4,
# the > 1e-10 compare, the reciprocal, the division's 2 products with 0,
# 2 adds and 2 scalings); per offset 38 signed complex adds, 38 energy
# adds, |acc| (4), the scaling and the threshold compare.
DPSK_OPS_PER_SAMPLE = 5 + 18
DPSK_OPS_PER_OFFSET = 76 + 38 + 4 + 2
KERNELS = {  # name -> (wrapper module, TPU kernel it replaces)
    "ldpc_minsum": (cuda_ldpc, "projectultra_tpu/ops/pallas_ldpc.py:102"),
    "sc_windows": (cuda_sc, "projectultra_tpu/ops/pallas_sync.py:44"),
    # The bf16-message instantiation of ldpc_minsum.cu: the card's form of
    # the JAX decoder's msg_dtype=bfloat16 fast mode (an XLA decode there).
    "ldpc_minsum_bf16": (cuda_ldpc,
                         "projectultra_tpu/ops/ldpc.py::decode "
                         "(msg_dtype=bfloat16)"),
    # DPSK's preamble search score: one XLA fusion in the JAX package, a
    # loop of 38 steps of about a dozen eager operators in the plain version.
    "dpsk_score": (cuda_dpsk,
                   "projectultra_tpu/psk/dpsk.py:305-317 find_preamble's "
                   "differential score (an XLA fusion)"),
}
BF16 = torch.bfloat16

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
    """The card's name and power limit, as nvidia-smi gives them."""
    return device_card_line(torch.device("cuda", 0))


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


def compare_decoders(rate: CodeRate, llrs: torch.Tensor, label: str,
                     trap_escape: bool = False,
                     msg_dtype: torch.dtype = torch.float32) -> float:
    """Kernel vs plain decoder on the same LLRs, both with ``msg_dtype``
    edge messages; returns the max abs difference of the total LLRs (bits,
    ok and iters must be equal)."""
    graph = ldpc_ops.graph_for(get_code(rate), llrs.device)
    kw = {"trap_escape": True} if trap_escape else {}
    kw["msg_dtype"] = msg_dtype
    llr_k, ok_k, it_k = cuda_ldpc.decode_cuda(graph, llrs, **kw)
    llr_p, ok_p, it_p = ldpc_ops.decode_plain(graph, llrs, **kw)
    torch.cuda.synchronize()
    if msg_dtype == BF16:
        label = "bf16 messages, " + label
    k = graph.k
    bits_eq = bool(((llr_k[:, :k] < 0) == (llr_p[:, :k] < 0)).all())
    ok_eq = bool((ok_k == ok_p).all())
    it_eq = bool((it_k == it_p).all())
    same = (llr_k == llr_p) | (torch.isnan(llr_k) & torch.isnan(llr_p))
    err = float(torch.where(same, 0.0, (llr_k - llr_p).abs()).max())
    # (equal infs and two NaNs: 0; a NaN against a number: NaN)
    if trap_escape:
        label += ", trap_escape"
    print(f"kernel vs plain [{label}] B={llrs.shape[0]}: bits_equal={bits_eq} "
          f"ok_equal={ok_eq} iters_equal={it_eq} max_abs_err={err!r} "
          f"ok_rate={float(ok_k.float().mean())!r} "
          f"max_iters_seen={int(it_k.max())}", flush=True)
    require(bits_eq and ok_eq and it_eq,
            f"kernel disagrees with the plain decoder on {label}")
    return err


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for a kernel's work
# ---------------------------------------------------------------------------

def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ldpc_passes(graph, llrs: torch.Tensor, trap_escape: bool = False,
                msg_dtype: torch.dtype = torch.float32):
    """Iterations each lane of this run's data needs: iters + 1 for a lane
    that converges, max_iters for one that does not; with ``trap_escape``
    a lane that fails the first pass adds the retry's."""
    _, ok1, it1 = cuda_ldpc.decode_cuda(graph, llrs, msg_dtype=msg_dtype)
    passes = torch.where(ok1, it1 + 1, it1).double()
    if trap_escape and not bool(ok1.all()):
        _, ok, it = cuda_ldpc.decode_cuda(graph, llrs, trap_escape=True,
                                          msg_dtype=msg_dtype)
        retry = torch.where(ok, it + 1, it).double()
        passes = passes + torch.where(ok1, 0.0, retry)
    return passes


def ldpc_bound(graph, passes: torch.Tensor):
    """The decoder's bound on this run's data: LLRs read once, totals, ok
    and iters written once; LDPC_OPS_PER_EDGE per edge for every iteration
    each lane ran (``ldpc_passes``).  The same for bf16 messages: the
    messages live in shared memory, so the bytes are the LLRs' either way.
    Returns (ms, basis, mean iterations run)."""
    B = passes.shape[0]
    edges = int(graph.row_mask.sum())
    n_bytes = B * graph.n * 4 * 2 + B * (1 + 4)
    ms, by = bound(n_bytes, float(passes.sum()) * edges * LDPC_OPS_PER_EDGE)
    return ms, by, float(passes.mean())


def sc_bound(B: int, half: int, stride: int, G: int):
    """The window sums' bound: the span of samples the G outputs need, read
    once, P, R1 and R2 written once; SC_OPS_PER_SAMPLE per sample and
    4 * half/stride adds per output (the block-grid sums)."""
    span = stride * (G - 1) + 2 * half
    n_bytes = B * span * 8 + B * G * (8 + 4 + 4)
    n_ops = B * (span * SC_OPS_PER_SAMPLE + G * 4 * (half // stride))
    return bound(n_bytes, n_ops)


def dpsk_bound(B: int, L: int, O: int):
    """The score's bound: the O + 38 L samples of each row read once, the
    O scores written once; DPSK_OPS_PER_SAMPLE a sample and
    DPSK_OPS_PER_OFFSET an offset."""
    span = O + (cuda_dpsk.PAIRS * L)
    return bound(B * span * 8 + B * O * 4,
                 B * span * DPSK_OPS_PER_SAMPLE + B * O * DPSK_OPS_PER_OFFSET)


#: (kernel, shape, kernel ms, bound ms, basis) of every timed shape.
SHAPES: list = []


#: The name a kernel's device events carry (both LDPC instantiations are
#: ldpc_minsum_kernel<threads, bf16>).
KERNEL_EVENT = {"ldpc_minsum": "ldpc_minsum_kernel",
                "ldpc_minsum_bf16": "ldpc_minsum_kernel",
                "sc_windows": "sc_windows_kernel",
                "dpsk_score": "dpsk_score_kernel"}


def report_shape(name: str, shape: str, fn, reps: int, bound_ms: float,
                 by: str, card: str) -> float:
    """Times fn's kernel on the device (profiler) and its whole call
    (CUDA events), prints both beside the bound; returns the kernel ms."""
    ms = device_ms(fn, reps, KERNEL_EVENT[name])
    call_ms = time_ms(fn, reps)
    SHAPES.append((name, shape, ms, bound_ms, by))
    print(f"kernel {name} [{shape}]: {ms!r} ms on the device ({call_ms!r} ms "
          f"a call with the wrapper), bound {bound_ms!r} ms (by {by}), share "
          f"of bound {bound_ms / ms!r} on {card}", flush=True)
    return ms


def time_ldpc_shape(label: str, rate: CodeRate, llrs: torch.Tensor,
                    card: str, reps: int = 20, trap_escape: bool = False,
                    msg_dtype: torch.dtype = torch.float32
                    ) -> tuple[float, float, str]:
    """Times the kernel (the instantiation of ``msg_dtype``) on llrs and
    reports it against its bound; returns (kernel ms, bound ms, basis)."""
    graph = ldpc_ops.graph_for(get_code(rate), llrs.device)
    kw = {"trap_escape": trap_escape, "msg_dtype": msg_dtype}
    _, ok, _ = cuda_ldpc.decode_cuda(graph, llrs, **kw)
    bound_ms, by, passes = ldpc_bound(graph, ldpc_passes(graph, llrs,
                                                         **kw))
    trap = ", trap_escape" if trap_escape else ""
    name = "ldpc_minsum_bf16" if msg_dtype == BF16 else "ldpc_minsum"
    ms = report_shape(name, f"{label}{trap}, B={llrs.shape[0]}, "
                      f"{passes!r} iterations run per lane on average, "
                      f"{float((~ok).float().mean())!r} of the lanes "
                      f"unconverged after {DEFAULT_MAX_ITERS}",
                      lambda: cuda_ldpc.decode_cuda(graph, llrs, **kw),
                      reps, bound_ms, by, card)
    return ms, bound_ms, by


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


def device_ms(fn, reps: int, kernel: str, tries: int = 5) -> float:
    """Device milliseconds per launch of the kernels whose names hold
    ``kernel``, under ``torch.profiler`` over reps calls of fn (the kernel's
    own time, without the host's launch overhead): the mean over the
    launches the profiler recorded.  It can miss some of a run's device
    events, or all of them (seen for 20 launches of a 5 us kernel); a run
    with none is repeated with twice the calls."""
    fn()
    torch.cuda.synchronize()
    for t in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps << t):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        if us:
            return sum(us) / len(us) / 1000.0
    raise SmokeFailure(f"the profiler saw no {kernel} on the device in "
                       f"{tries} runs")


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
                  plain_reps: int, trap_escape: bool = False,
                  msg_dtype: torch.dtype = torch.float32
                  ) -> tuple[float, float]:
    kw = {"trap_escape": trap_escape, "msg_dtype": msg_dtype}
    return time_pair(
        lambda: cuda_ldpc.decode_cuda(graph, llrs, **kw),
        lambda: ldpc_ops.decode_plain(graph, llrs, **kw),
        kernel_reps, plain_reps)


def profile_busy_ms(fn, reps: int, rows: int = 15) -> float:
    """Device busy milliseconds per call of fn over reps calls under
    ``torch.profiler``: the length of the union of the device kernels'
    time intervals.  Prints the device time by operator (``rows`` rows;
    none when 0)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    if rows:
        print(prof.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=rows), flush=True)
    return busy_ms(prof) / reps


def busy_ms(prof) -> float:
    """Length of the union of the device activities' intervals, ms, read
    from the profiler's raw device events (building its per-operator
    events for a long window costs minutes of host time)."""
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    busy_ns, cur_start, cur_end = 0, None, None
    for a, b in spans:
        if cur_end is None or a > cur_end:
            if cur_end is not None:
                busy_ns += cur_end - cur_start
            cur_start, cur_end = a, b
        else:
            cur_end = max(cur_end, b)
    if cur_end is not None:
        busy_ns += cur_end - cur_start
    return busy_ns / 1e6


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def source_of(name: str) -> str:
    return str(KERNELS[name][0].SOURCE.relative_to(ROOT))


def phase_build() -> None:
    """Both kernel libraries (the LDPC one holds both of its
    instantiations), one nvcc each, started together."""
    t0 = time.perf_counter()
    mods = {mod for mod, _ in KERNELS.values()}
    with ThreadPoolExecutor(len(mods)) as pool:
        for job in [pool.submit(mod.load_library) for mod in mods]:
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
    compare_nonfinite(dev, torch.float32)


def compare_nonfinite(dev: torch.device, msg_dtype: torch.dtype) -> None:
    """The kernel instantiation of ``msg_dtype`` against the plain decoder
    on ``nonfinite_llrs`` at both waterfall points: decisions equal on
    every lane and the totals equal, NaN to NaN."""
    for rate, sigma in WATERFALL:
        for kind in ("inf", "nan"):
            llrs = torch.from_numpy(nonfinite_llrs(
                rate, sigma, WATERFALL_BATCH, kind)).to(dev)
            label = f"{kind} LLRs, waterfall {GOLDEN_NAMES[rate]} sigma={sigma}"
            err = compare_decoders(rate, llrs, label, msg_dtype=msg_dtype)
            require(err == 0.0, f"kernel totals differ from the plain "
                    f"decoder's on {label}: {err!r}")


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
          f"plain {p_ms!r} ms (calls, CUDA events) on {card}", flush=True)
    _, bound_ms, by = time_ldpc_shape("R1/2 17 dB main path", RATE, deint,
                                      card)
    wf = torch.from_numpy(waterfall_llrs(RATE, 0.62, BATCH)).to(dev)
    wk_ms, wp_ms = time_decoders(graph, wf, kernel_reps=5, plain_reps=2)
    print(f"decode at waterfall R1_2 sigma=0.62 B={BATCH}: kernel "
          f"{wk_ms!r} ms, plain {wp_ms!r} ms (calls, CUDA events) on {card}",
          flush=True)
    time_ldpc_shape("R1/2 waterfall sigma=0.62", RATE, wf, card, reps=5)
    return k_ms, p_ms, bound_ms, by


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
                    label: str, half: int = HALF) -> float:
    """Kernel vs plain window sums on the same analytic signal; returns the
    max abs error (raises unless within rtol 2e-4, atol 2e-3)."""
    got = cuda_sc.sc_windows_cuda(a, half, stride, offset, G)
    want = sc_windows_plain(a, half, stride, offset, G)
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
          f"half={half} stride={stride} G={G}: max_abs_err P/R1/R2={errs!r} "
          f"max_rel_err={rels!r} (rtol {WINDOW_RTOL}, atol {WINDOW_ATOL}); "
          f"launch {plan_line(a, half, stride, offset, G)}", flush=True)
    return max(errs)


def plan_line(a: torch.Tensor, half: int, stride: int, offset: int,
              G: int) -> str:
    """The window kernel's launch at these sizes, as a line."""
    plan = cuda_sc.launch_plan(a.shape[0], a.shape[1], half, stride, offset,
                               G, a.device)
    return ("{tile} outputs an item, {items} items on {blocks} blocks, "
            "{stages} stages, {shared_bytes} shared B a block".format(**plan))


# One non-finite sample (lane, sample) in the buffers of
# tests/test_torch_cuda.py::test_window_kernel_at_a_nonfinite_sample.
NONFINITE_SAMPLES = {"cox": (300, 3828), "engine": (0, 100000)}
NONFINITE_VALUES = {"inf": complex(float("inf"), 0.0),
                    "nan": complex(float("nan"), 0.0)}


def compare_nonfinite_windows(a: torch.Tensor, half: int, stride: int,
                              offset: int, G: int, label: str) -> None:
    """Kernel vs plain window sums on a signal holding a non-finite sample:
    each real part of P, R1 and R2 NaN, +inf and -inf at exactly the plain
    version's outputs, within rtol 2e-4, atol 2e-3 elsewhere."""
    got = cuda_sc.sc_windows_cuda(a, half, stride, offset, G)
    want = sc_windows_plain(a, half, stride, offset, G)
    torch.cuda.synchronize()
    counts, errs = [], []
    for x, y, name in zip(got, want, ("P", "R1", "R2")):
        for xp, yp, part in (((x.real, y.real, name + ".re"),
                              (x.imag, y.imag, name + ".im"))
                             if y.is_complex() else ((x, y, name),)):
            bad = ~torch.isfinite(yp)
            require(bool(bad.any()), f"{label}: the sample reached no {part}")
            for test in (torch.isnan, torch.isposinf, torch.isneginf):
                require(torch.equal(test(xp), test(yp)),
                        f"window kernel {part} differs from plain in "
                        f"{test.__name__} on {label}")
            require(bool(torch.isclose(xp[~bad], yp[~bad], rtol=WINDOW_RTOL,
                                       atol=WINDOW_ATOL).all()),
                    f"window kernel {part} disagrees with plain on {label}")
            counts.append(int(bad.sum()))
            errs.append(float((xp[~bad] - yp[~bad]).abs().max()))
    print(f"window kernel vs plain [{label}] half={half} stride={stride} "
          f"G={G}: non-finite outputs P.re/P.im/R1/R2={counts} (same places "
          f"and kinds), max_abs_err elsewhere={errs!r}", flush=True)


def phase_window_nonfinite(dev: torch.device, rx: torch.Tensor) -> None:
    """The window kernel against its plain version at one +inf or NaN
    sample, in the Cox buffer's analytic signal (B = 512, T = 18,856) and
    in an engine-shaped search view of noise (B = 1, T = 262,144), at
    strides 1 and 8 and half 256 and 512; then B = 1 rows long enough that
    every block walks several work items through its ring."""
    g = torch.Generator(device=dev).manual_seed(23)
    view = torch.randn((1, ModemEngine.ACQ_VIEW_CAP), generator=g,
                       device=dev)
    for name, buf in (("cox", rx), ("engine", view)):
        lane, t = NONFINITE_SAMPLES[name]
        for kind, value in NONFINITE_VALUES.items():
            a = SC.analytic_signal(buf)
            a[lane, t] = value
            T = a.shape[1]
            for half, offset in ((256, CP), (512, NVIS_CFG.cyclic_prefix)):
                for stride in (1, 8):
                    G = (T - 2 * half - offset) // stride + 1
                    compare_nonfinite_windows(
                        a, half, stride, offset, G,
                        f"{name} B={a.shape[0]} T={T}, {kind} at lane "
                        f"{lane} sample {t}")
    T = 4_000_000
    a = SC.analytic_signal(torch.randn((1, T), generator=g, device=dev))
    for stride in (8, 1):
        G = (T - 2 * HALF - CP) // stride + 1
        plan = cuda_sc.launch_plan(1, T, HALF, stride, CP, G, dev)
        require(plan["items"] >= 2 * plan["blocks"],
                f"a B = 1 row of {T} gives {plan} (blocks walk one item)")
        compare_windows(a, stride, CP, G, "B = 1 83 s row, many items a "
                        "block")


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
    """Cox frames/s (noise untimed, as the bench), stages, idle share, the
    window kernel against its plain version and its bound at strides 8 and
    1, and the LDPC kernel on a Cox buffer's LLRs (against the plain
    decoder, both timed); returns (kernel ms, plain ms, bound ms, basis) of
    the window kernel at stride 8."""
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
              f"(calls, CUDA events) on {card}", flush=True)
        bound_ms, by = sc_bound(COX_BATCH, HALF, st, G)
        report_shape("sc_windows", f"Cox buffer, B={COX_BATCH}, T={COX_T}, "
                     f"stride {stride}, G={G}", kernel,
                     50 if stride == 8 else 10, bound_ms, by, card)
        if stride == 8:
            sc8 = (*times[8], bound_ms, by)

    pipe = P.pipeline_for(COX_CFG, MOD, RATE, 1, dev)
    det = SC.detect_preamble(COX_CFG, rx_all[0])
    llrs = pipe.deinterleave(SC.demodulate_detected(COX_CFG, MOD, rx_all[0],
                                                    det))
    ldpc_at_new_shape("R1/2 17 dB Cox buffer", RATE, llrs.contiguous(), card)
    return sc8


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
          f"kernel {k_ms!r} ms, plain {p_ms!r} ms (calls, CUDA events) on "
          f"{card}", flush=True)
    time_ldpc_shape("R1/4 5 dB chirp cell", CHIRP_RATE, llrs, card)
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


# ---------------------------------------------------------------------------
# Slice 5: NVIS coherent, 512-plan QAM256, DPSK, delay fit, MFSK, OTFS
# ---------------------------------------------------------------------------

NVIS_CFG = nvis_mode()   # 1024-FFT, 59 carriers, no pilots (BASELINE #4)
NVIS_LEAD, NVIS_TAIL = 3000, 2000    # tests/test_nvis_waveforms.py:26-49
NVIS_CFO_HZ = 10.0
# (name, mod, rate, SNR dB, codewords per frame, frames per buffer)
NVIS_CASES = [
    ("a QAM32 R3/4", Modulation.QAM32, CodeRate.R3_4, 30.0, 1, 512),
    ("b QAM256 R5/6", Modulation.QAM256, CodeRate.R5_6, 42.0, 1, 512),
    ("c QAM256 R5/6 long", Modulation.QAM256, CodeRate.R5_6, 42.0, 32, 64),
]
NVIS_LONG_CPU_LANES = 8
HI_MOD, HI_RATE, HI_SNR_DB = Modulation.QAM256, CodeRate.R2_3, 30.0
HI_SEED = 70
DPSK_LEAD, DPSK_TAIL = 4800, 4000    # parallel/sweep.py:184-190
DPSK_RATE = CodeRate.R1_4
DPSK_CASES = [("medium", 0.0, 256), ("robust", -11.0, 64)]  # sweep.py:238-239
DF_CFG = high_throughput()
DF_MOD, DF_RATE, DF_NCW = Modulation.QAM16, CodeRate.R2_3, 8
DF_LEAD, DF_TAIL = 7200, 1152        # tests/test_delay_fit.py:28
DF_SNR_DB, DF_BATCH = 20.0, 256
MFSK_RATE = CodeRate.R1_4
MFSK_LEAD, MFSK_TAIL = 5000, 4000    # tests/test_mfsk.py:31-33
MFSK_POINTS = [("mfsk_robust", -12.0), ("mfsk_low_snr", -8.0),
               ("mfsk_medium", -4.0), ("mfsk_fast", 0.0),
               ("mfsk_turbo", 3.0)]  # tests/test_mfsk.py:55-56
MFSK_BATCH = 256
OTFS_CFG = OT.OTFSConfig()
OTFS_RATE = CodeRate.R1_4
OTFS_LEAD, OTFS_TAIL = 4000, 2000    # tests/test_otfs.py:139-140
OTFS_SNR_DB, OTFS_BATCH = 20.0, 256
PATH_CPU_LANES = 16


def noop(_stage: str) -> None:
    pass


def path_timing(label: str, run, rx_list: list, batch: int,
                card: str) -> float:
    """ms per buffer of run(rx, mark) over rx_list (host clock, best of 2
    repeats), its stages (CUDA events between mark calls) and the device's
    idle share (profiled); returns the ms per buffer."""
    run(rx_list[0], noop)
    torch.cuda.synchronize()
    ms = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for rx in rx_list:
            run(rx, noop)
        torch.cuda.synchronize()
        ms = min(ms, (time.perf_counter() - t0) / len(rx_list) * 1e3)
    totals: dict = {}
    for rx in rx_list:
        events = [("start", torch.cuda.Event(enable_timing=True))]
        events[0][1].record()

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((stage, ev))

        run(rx, mark)
        torch.cuda.synchronize()
        for (_, e0), (stage, e1) in zip(events, events[1:]):
            totals[stage] = totals.get(stage, 0.0) + e0.elapsed_time(e1)
    stages = {k: v / len(rx_list) for k, v in totals.items()}
    busy = profile_busy_ms(lambda: run(rx_list[0], noop), 2, rows=6)
    print(f"{label}: {ms!r} ms per buffer of {batch} frames "
          f"({batch / ms * 1e3!r} frames/s, {len(rx_list)} buffers, best of "
          f"2), stages {stages} (ms per buffer, CUDA events), device busy "
          f"{busy!r} ms per buffer: idle share {1.0 - busy / ms!r} on {card}",
          flush=True)
    return ms


def gate_decode(label: str, out: torch.Tensor, ok: torch.Tensor,
                info: torch.Tensor, gate: float | None = DECODE_GATE) -> float:
    """ok rate and exact info bits on every ok lane; the rate is gated
    unless ``gate`` is None.  Returns the ok rate."""
    ok_rate = float(ok.float().mean())
    exact = bool((out == info)[ok].all())
    print(f"{label}: ok_rate={ok_rate!r} bits_exact_on_ok={exact}",
          flush=True)
    require(tuple(out.shape) == tuple(info.shape) and out.dtype == torch.uint8,
            f"{label}: decoded bits malformed")
    require(exact, f"{label}: info bits differ on an ok lane")
    if gate is not None:
        require(ok_rate >= gate, f"{label}: ok rate {ok_rate} < {gate}")
    return ok_rate


def check_false_ok(label: str, rx: torch.Tensor, out: torch.Tensor,
                   ok: torch.Tensor, info: torch.Tensor, cpu_step) -> None:
    """The gate of a point whose code leaves info bits parity-free (R3/4,
    R5/6: fec/ldpc.build_h_rows saturates the check slots early), where a
    lane can converge to a valid codeword with wrong info bits, in the JAX
    package as in the port (tests/test_torch_high_order.py::
    test_parity_free_false_ok_lanes_match_jax): ok rate >= 0.99, the
    ok-and-exact rate printed, and every lane with wrong bits decoded alike
    by the CPU path (``cpu_step`` on CPU rows -> (out, ok))."""
    wrong = ok & ~(out == info).all(-1)
    ok_rate = float(ok.float().mean())
    rate = float((ok & ~wrong).float().mean())
    lanes = torch.nonzero(wrong).flatten().tolist()
    print(f"{label}: ok_rate={ok_rate!r} ok_and_exact_rate={rate!r} "
          f"ok_with_wrong_bits_lanes={lanes}", flush=True)
    require(tuple(out.shape) == tuple(info.shape) and out.dtype == torch.uint8,
            f"{label}: decoded bits malformed")
    require(ok_rate >= DECODE_GATE, f"{label}: ok rate {ok_rate} < "
            f"{DECODE_GATE}")
    if lanes:
        cpu_out, cpu_ok = cpu_step(rx[wrong].cpu())
        same = bool(torch.equal(cpu_ok, ok[wrong].cpu())
                    and torch.equal(cpu_out, out[wrong].cpu()))
        print(f"{label}: the lanes with wrong bits on the CPU path: "
              f"identical={same}", flush=True)
        require(same, f"{label}: the card's wrong-bit lanes differ from the "
                "CPU path")


def launches_of(fn):
    """(fn's result, {kernel: launches during fn})."""
    torch.cuda.synchronize()
    cuda_sc.launches = cuda_ldpc.launches = cuda_ldpc.launches_bf16 = 0
    cuda_dpsk.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {"sc_windows": cuda_sc.launches,
                 "ldpc_minsum": cuda_ldpc.launches,
                 "ldpc_minsum_bf16": cuda_ldpc.launches_bf16,
                 "dpsk_score": cuda_dpsk.launches}


def require_launched(label: str, launches: dict, names) -> None:
    print(f"{label} kernel launches: {launches}", flush=True)
    for name in names:
        require(launches[name] > 0, f"{label} did not launch {name}")


def same_on_cpu(label: str, card: tuple, cpu: tuple) -> None:
    """(out, ok) of the card and of the CPU path on the same lanes: equal
    ok flags, equal bits where both decode."""
    out, ok = card[0].cpu(), card[1].cpu()
    both = ok & cpu[1]
    print(f"{label} card vs CPU on {ok.shape[0]} lanes: ok_equal="
          f"{bool(torch.equal(ok, cpu[1]))} decoded_both={int(both.sum())}",
          flush=True)
    require(bool(torch.equal(ok, cpu[1]))
            and bool(torch.equal(out[both], cpu[0][both])),
            f"{label}: the card differs from the CPU path")


def random_info(g: torch.Generator, B: int, n: int) -> torch.Tensor:
    return torch.randint(0, 2, (B, n), generator=g, device=g.device,
                         dtype=torch.uint8)


def ldpc_at_new_shape(label: str, rate: CodeRate, llrs: torch.Tensor,
                      card: str, trap_escape: bool = False) -> None:
    """The LDPC kernel on a path's own LLRs: lane-exact against the plain
    decoder, both timed (calls), and its device time beside its bound."""
    compare_decoders(rate, llrs, f"{label} LLRs", trap_escape)
    graph = ldpc_ops.graph_for(get_code(rate), llrs.device)
    k_ms, p_ms = time_decoders(graph, llrs, kernel_reps=20, plain_reps=3,
                               trap_escape=trap_escape)
    trap = ", trap_escape" if trap_escape else ""
    print(f"decode at {label}{trap} B={llrs.shape[0]}: kernel {k_ms!r} ms, "
          f"plain {p_ms!r} ms (calls, CUDA events) on {card}", flush=True)
    time_ldpc_shape(label, rate, llrs, card, trap_escape=trap_escape)


def cox_run(cfg, mod, rate, ncw):
    """decode_cox_batch's stages (detect, cut at each lane's LTS and
    demodulate, deinterleave and decode) with marks between them."""
    def run(rx, mark):
        det = SC.detect_preamble(cfg, rx)
        mark("detect")
        llrs = SC.demodulate_detected(cfg, mod, rx, det, ncw)
        mark("slice+demod")
        out = P.pipeline_for(cfg, mod, rate, ncw, rx.device).decode(llrs)
        mark("deinterleave+decode")
        return out
    return run


def cox_llrs(cfg, mod, rate, ncw, rx) -> torch.Tensor:
    """The deinterleaved [B*ncw, 648] decoder input of a Cox buffer."""
    det = SC.detect_preamble(cfg, rx)
    pipe = P.pipeline_for(cfg, mod, rate, ncw, rx.device)
    return pipe.deinterleave(SC.demodulate_detected(cfg, mod, rx, det, ncw))


def phase_nvis(dev: torch.device, card: str) -> None:
    """NVIS coherent cases (a)-(c) through decode_cox_batch, the LDPC
    kernel against plain on their LLRs, the window kernel at half = 512."""
    for i, (name, mod, rate, snr, ncw, B) in enumerate(NVIS_CASES):
        k = get_code(rate).k
        g = torch.Generator(device=dev).manual_seed(60 + i)
        info = random_info(g, B, ncw * k)
        tx = P.tx_cox_frame(NVIS_CFG, mod, rate, info, lead=NVIS_LEAD,
                            tail=NVIS_TAIL, n_codewords=ncw)
        rx_all = [W.add_noise_active(W.apply_cfo_hilbert(tx, NVIS_CFO_HZ),
                                     snr, g) for _ in range(2)]
        label = (f"NVIS ({name}) {snr} dB {NVIS_CFO_HZ} Hz B={B} "
                 f"T={tx.shape[1]} codewords={ncw}")
        (out, ok, iters, det), launches = launches_of(
            lambda: SC.decode_cox_batch(NVIS_CFG, mod, rate, rx_all[0], ncw))
        require_launched(label, launches, ("sc_windows", "ldpc_minsum"))
        cw_ok = iters < DEFAULT_MAX_ITERS
        cw_exact = cw_ok & (out.reshape(B, ncw, k)
                            == info.reshape(B, ncw, k)).all(-1)
        cfo = det["cfo_hz"]
        print(f"{label}: found_rate={float(det['found'].float().mean())!r} "
              f"codeword_ok_rate={float(cw_ok.float().mean())!r} "
              f"codeword_ok_and_exact_rate={float(cw_exact.float().mean())!r}"
              f" detected cfo mean {float(cfo.mean())!r} Hz", flush=True)
        n = PATH_CPU_LANES if ncw == 1 else NVIS_LONG_CPU_LANES
        cpu = SC.decode_cox_batch(NVIS_CFG, mod, rate, rx_all[0][:n].cpu(),
                                  ncw)
        require(bool(torch.equal(det["lts_start"][:n].cpu(),
                                 cpu[3]["lts_start"])),
                f"{label}: detection on the card differs from the CPU")
        if ncw == 1:
            check_false_ok(label, rx_all[0], out, ok, info,
                           lambda x: SC.decode_cox_batch(NVIS_CFG, mod, rate,
                                                         x)[:2])
            same_on_cpu(label, (out[:n], ok[:n]), cpu[:2])
        else:
            # A ~10% long-frame residual (tests/test_high_order.py:80-82),
            # recovered by ARQ: the rate is printed; the card is held to
            # the CPU path codeword for codeword.
            wrong = (cw_ok & ~cw_exact).any(-1)
            print(f"{label}: frame ok_rate={float(ok.float().mean())!r}, "
                  f"lanes with an ok codeword of wrong bits: "
                  f"{torch.nonzero(wrong).flatten().tolist()}", flush=True)
            if bool(wrong.any()):
                w_out, _, w_iters, _ = SC.decode_cox_batch(
                    NVIS_CFG, mod, rate, rx_all[0][wrong].cpu(), ncw)
                same = bool(torch.equal(w_out, out[wrong].cpu())
                            and torch.equal(w_iters, iters[wrong].cpu()))
                print(f"{label}: those lanes on the CPU path: identical="
                      f"{same}", flush=True)
                require(same, f"{label}: the card's wrong-bit lanes differ "
                        "from the CPU path")
            cpu_cw = cpu[2] < DEFAULT_MAX_ITERS
            same = bool(torch.equal(cw_ok[:n].cpu(), cpu_cw))
            both = cw_ok[:n].cpu() & cpu_cw
            bits_same = bool(torch.equal(
                out[:n].cpu().reshape(n, ncw, k)[both],
                cpu[0].reshape(n, ncw, k)[both]))
            print(f"{label} card vs CPU on {n} lanes: codeword_ok_equal="
                  f"{same} bits_equal_on_ok={bits_same}", flush=True)
            require(same and bits_same,
                    f"{label}: the card differs from the CPU path")
        llrs = cox_llrs(NVIS_CFG, mod, rate, ncw, rx_all[0])
        ldpc_at_new_shape(f"NVIS ({name}) {GOLDEN_NAMES[rate]} {snr} dB",
                          rate, llrs, card)
        path_timing(f"NVIS ({name}) path", cox_run(NVIS_CFG, mod, rate, ncw),
                    rx_all, B, card)
        if i == 1:
            phase_windows_half512(rx_all[0], card)


def phase_windows_half512(rx: torch.Tensor, card: str) -> None:
    """The window kernel at the NVIS plan's half = 512 against its plain
    version (strides 8 and 1), and at stride 8 (the detection grid) timed
    beside its bound."""
    half, cp = NVIS_CFG.fft_size // 2, NVIS_CFG.cyclic_prefix
    a = SC.analytic_signal(rx)
    B, T = a.shape
    G = SC.search_grid_size(NVIS_CFG, T)
    compare_windows(a, 8, cp, G, "NVIS buffer", half=half)
    compare_windows(a, 1, cp, T - NVIS_CFG.fft_size - cp + 1,
                    "NVIS buffer", half=half)

    def kernel():
        cuda_sc.sc_windows_cuda(a, half, 8, cp, G)

    def plain():
        sc_windows_plain(a, half, 8, cp, G)

    k_ms, p_ms = time_pair(kernel, plain, 50, 10)
    print(f"window sums NVIS B={B} T={T} half={half} stride 8 G={G}: kernel "
          f"{k_ms!r} ms, plain {p_ms!r} ms (calls, CUDA events) on {card}",
          flush=True)
    bound_ms, by = sc_bound(B, half, 8, G)
    report_shape("sc_windows", f"NVIS buffer, B={B}, T={T}, half={half}, "
                 f"stride 8, G={G}", kernel, 50, bound_ms, by, card)


def pilot_high_order_buffers(seed: int = HI_SEED, n: int = 2):
    """(info [B, k] uint8, tx [B, T], [n] unit-variance noise [B, T]) of
    the 512-plan QAM256 R2/3 point, all drawn with numpy from ``seed`` (on
    the host, so a CPU test can rebuild any lane): rx = add_noise_with(tx,
    HI_SNR_DB, noise), add_noise_active's scaling."""
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (COX_BATCH, get_code(HI_RATE).k),
                        dtype=np.uint8)
    tx = P.tx_cox_frame(COX_CFG, HI_MOD, HI_RATE, torch.from_numpy(info),
                        lead=COX_LEAD, tail=COX_TAIL)
    noise = [rng.standard_normal(tuple(tx.shape), dtype=np.float32)
             for _ in range(n)]
    return info, tx, noise


def phase_pilot_high_order(dev: torch.device, card: str) -> None:
    """QAM256 R2/3 on the default 512-FFT pilot plan at 30 dB, 0 Hz
    (tests/test_high_order.py:54-63): the scan's high-order noise pass.
    Info bits and noise come from numpy; the lanes that miss (not ok, or
    ok with wrong bits) are printed and held to the CPU path."""
    info_np, tx_cpu, noise = pilot_high_order_buffers()
    info = torch.from_numpy(info_np).to(dev)
    tx = tx_cpu.to(dev)
    rx_all = [W.add_noise_with(tx, HI_SNR_DB, torch.from_numpy(z).to(dev))
              for z in noise]
    label = (f"512 pilot plan QAM256 R2/3 {HI_SNR_DB} dB B={COX_BATCH} "
             f"T={tx.shape[1]}")
    (out, ok, _, det), launches = launches_of(
        lambda: SC.decode_cox_batch(COX_CFG, HI_MOD, HI_RATE, rx_all[0]))
    require_launched(label, launches, ("sc_windows", "ldpc_minsum"))
    gate_decode(label, out, ok, info)
    missed = torch.nonzero(~(ok & (out == info).all(-1))).flatten()
    print(f"{label}: lanes missed on the card (numpy seed {HI_SEED}): "
          f"{missed.tolist()}", flush=True)
    n = PATH_CPU_LANES
    cpu = SC.decode_cox_batch(COX_CFG, HI_MOD, HI_RATE, rx_all[0][:n].cpu())
    same_on_cpu(label, (out[:n], ok[:n]), cpu[:2])
    if missed.numel():
        cpu = SC.decode_cox_batch(COX_CFG, HI_MOD, HI_RATE,
                                  rx_all[0][missed].cpu())
        same_on_cpu(f"{label}, the missed lanes", (out[missed], ok[missed]),
                    cpu[:2])
    path_timing("512 pilot plan QAM256 R2/3 path",
                cox_run(COX_CFG, HI_MOD, HI_RATE, 1), rx_all, COX_BATCH, card)


def dpsk_tx(cfg, info: torch.Tensor) -> torch.Tensor:
    """run_point_dpsk's frames: lead zeros, preamble, one codeword, tail."""
    B, dev = info.shape[0], info.device
    cw = ldpc_ops.encode(get_code(DPSK_RATE), info)
    pre = torch.from_numpy(DP.generate_preamble(cfg)).to(dev)
    return torch.cat([torch.zeros((B, DPSK_LEAD), device=dev),
                      pre.expand(B, pre.shape[0]), DP.modulate(cfg, cw),
                      torch.zeros((B, DPSK_TAIL), device=dev)], dim=-1)


def dpsk_run(cfg):
    """decode_dpsk_batch's stages with marks between them."""
    code = get_code(DPSK_RATE)

    def run(rx, mark):
        found, ds, cfo, ipo, prev = DP.find_preamble(cfg, rx)
        mark("find")
        span = CH.frame_spans(rx, ds, -(-code.n // cfg.bits_per_symbol)
                              * cfg.samples_per_symbol)
        llrs = DP.demodulate_soft(cfg, span, prev, cfo, ipo)
        mark("slice+soft")
        out = ldpc_ops.decode_totals(ldpc_ops.graph_for(code, rx.device),
                                     llrs[:, :code.n].contiguous())
        mark("decode")
        return llrs[:, :code.n].contiguous(), out
    return run


DPSK_SCORE_ATOL = 2e-6   # tests/test_torch_cuda.py: scores lie in [0, 1]


def score_inputs(cfg, rx: torch.Tensor, **kw) -> tuple:
    """(corr, L, n_sym, O): what find_preamble hands dpsk_score for rx
    (recorded from a search through the plain score)."""
    seen = []

    def record(corr, L, n_sym, O, expected, min_energy):
        seen.append((corr, L, n_sym, O))
        return DS.dpsk_score_plain(corr, L, n_sym, O, expected, min_energy)

    with mock.patch.object(DP, "dpsk_score", record):
        DP.find_preamble(cfg, rx, **kw)
    return seen[0]


def plain_score(run):
    """run with find_preamble's score taken by the plain version (the loop
    that the kernel replaced), on the same device."""
    def wrapped(*args, **kw):
        with mock.patch.object(DP, "dpsk_score", DS.dpsk_score_plain):
            return run(*args, **kw)
    return wrapped


def compare_dpsk_scores(corr: torch.Tensor, L: int, n_sym: int, O: int,
                        label: str) -> float:
    """The score kernel against the plain version on one correlation:
    NaN, +inf and zeros exactly where the plain version has them, within
    DPSK_SCORE_ATOL elsewhere; returns the max abs difference."""
    args = (corr, L, n_sym, O, DP.EXPECTED_SIGNS, DP.MIN_SYMBOL_ENERGY)
    got = cuda_dpsk.dpsk_score_cuda(*args)
    want = DS.dpsk_score_plain(*args)
    torch.cuda.synchronize()
    same = {name: bool(torch.equal(test(got), test(want))) for name, test in
            (("nan", torch.isnan), ("posinf", torch.isposinf),
             ("zero", lambda x: x == 0))}
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max())
    print(f"dpsk_score kernel vs plain [{label}] B={corr.shape[0]} L={L} "
          f"O={O}: max_abs_err={err!r} (tolerance {DPSK_SCORE_ATOL!r}), same "
          f"places {same}, plain NaNs {int(torch.isnan(want).sum())}, zeros "
          f"{int((want == 0).sum())}", flush=True)
    require(all(same.values()) and err <= DPSK_SCORE_ATOL,
            f"dpsk_score kernel disagrees with the plain version on {label}")
    return err


def same_decisions(label: str, cfg, rx: torch.Tensor, **kw) -> None:
    """find_preamble through the kernel and through the plain score on the
    card: found and data_start identical."""
    got = DP.find_preamble(cfg, rx, **kw)
    ref = plain_score(DP.find_preamble)(cfg, rx, **kw)
    eq = [bool(torch.equal(a, b)) for a, b in zip(got, ref)]
    print(f"{label}: find_preamble through the kernel vs the plain score: "
          f"found, data_start, cfo, ipo, prev identical {eq}; found "
          f"{int(got[0].sum())} of {rx.shape[0]}", flush=True)
    require(eq[0] and eq[1], f"{label}: the kernel moves a detection")


def engine_dpsk_view(cfg, row: torch.Tensor):
    """(buffer [1, T], find_preamble keywords) of the engine's DPSK search
    view over one received buffer (modem/acquisition/dpsk.py:66-78): the
    first DPSK_MAX_SEARCH_OFFSETS + pre_n + L samples zero-padded to a
    STREAM_BUCKET multiple, the search span capped there."""
    L, pre_n = cfg.samples_per_symbol, cfg.preamble_samples
    cap = ModemEngine.DPSK_MAX_SEARCH_OFFSETS
    bucket = ModemEngine.STREAM_BUCKET
    view = row[:cap + pre_n + L]
    T = -(-view.shape[0] // bucket) * bucket
    padded = torch.zeros((1, T), device=row.device)
    padded[0, :view.shape[0]] = view
    return padded, {"max_search_symbols": min(-(-(T - pre_n) // L), cap // L),
                    "valid_len": torch.tensor([view.shape[0]],
                                              dtype=torch.int32,
                                              device=row.device)}


def time_dpsk_shape(label: str, inputs: tuple, card: str) -> tuple:
    """The score kernel's call and the plain version's (CUDA events, in
    turns), and its device time against its bound; returns (call ms,
    plain ms, bound ms, basis)."""
    corr, L, n_sym, O = inputs
    args = (corr, L, n_sym, O, DP.EXPECTED_SIGNS, DP.MIN_SYMBOL_ENERGY)
    B = corr.shape[0]
    k_ms, p_ms = time_pair(lambda: cuda_dpsk.dpsk_score_cuda(*args),
                           lambda: DS.dpsk_score_plain(*args), 20, 3)
    plan = cuda_dpsk.launch_plan(B, corr.shape[1], L, O, corr.device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        DS.dpsk_score_plain(*args)
        torch.cuda.synchronize()
    plain_ops = sum(1 for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA)
    print(f"dpsk_score at {label} B={B} L={L} O={O}: kernel {k_ms!r} ms, "
          f"plain {p_ms!r} ms (calls, CUDA events; the plain call ran "
          f"{plain_ops} device operations under torch.profiler, the kernel "
          f"1) on {card}; launch plan {plan}", flush=True)
    bound_ms, by = dpsk_bound(B, L, O)
    report_shape("dpsk_score", f"{label}, B={B}, L={L}, O={O}",
                 lambda: cuda_dpsk.dpsk_score_cuda(*args), 20, bound_ms, by,
                 card)
    return k_ms, p_ms, bound_ms, by


def phase_dpsk_score(card: str, cfg, rx: torch.Tensor, preset: str) -> tuple:
    """The score kernel on the path's own correlations: against the plain
    version (and, at ``medium``, at one NaN and one +inf sample and on the
    engine's B = 1 search view through find_preamble), the decisions
    through both, and timed.  Returns (max abs error, call ms, plain ms,
    bound ms, basis) at the path's shape."""
    inputs = score_inputs(cfg, rx)
    err = compare_dpsk_scores(*inputs, f"DPSK {preset} buffer")
    same_decisions(f"DPSK {preset}", cfg, rx)
    timed = time_dpsk_shape(f"DPSK {preset} buffer", inputs, card)
    if preset != "medium":
        return (err, *timed)
    corr, L, n_sym, O = inputs
    for kind, (row, m) in (("nan", (3, 50_000)), ("inf", (5, 90_000))):
        bad = corr.clone()
        bad[row, m] = complex(float(kind), 0.0)
        err = max(err, compare_dpsk_scores(bad, L, n_sym, O,
                                           f"DPSK {preset} buffer, one "
                                           f"{kind} correlation"))
    view, kw = engine_dpsk_view(cfg, rx[0])
    _, launches = launches_of(lambda: DP.find_preamble(cfg, view, **kw))
    require_launched("DPSK engine search view", launches, ("dpsk_score",))
    require(launches["dpsk_score"] == 1, "the engine's search view made "
            f"{launches['dpsk_score']} score launches")
    same_decisions("DPSK engine search view", cfg, view, **kw)
    inputs = score_inputs(cfg, view, **kw)
    err = max(err, compare_dpsk_scores(*inputs, "engine search view"))
    time_dpsk_shape("engine search view", inputs, card)
    return (err, *timed)


def phase_dpsk(dev: torch.device, card: str) -> tuple:
    """Single-carrier DPSK (BASELINE #1) at the regression matrix's rows
    through decode_dpsk_batch (one score and one LDPC launch a buffer),
    timed with the score kernel and with the plain score it replaced; the
    score kernel held to the plain version on each path's correlations;
    the LDPC kernel on robust's -11 dB LLRs.  Returns medium's row of the
    kernels line (launches, max abs error, call ms, plain ms, bound ms,
    basis)."""
    k = get_code(DPSK_RATE).k
    row = None
    for i, (preset, snr, B) in enumerate(DPSK_CASES):
        cfg = getattr(DP, preset)()
        g = torch.Generator(device=dev).manual_seed(80 + i)
        info = random_info(g, B, k)
        tx = dpsk_tx(cfg, info)
        rx_all = [W.add_noise_active(tx, snr, g) for _ in range(2)]
        label = f"DPSK {preset} {snr} dB B={B} T={tx.shape[1]}"
        (out, ok, iters, det), launches = launches_of(
            lambda: DP.decode_dpsk_batch(cfg, DPSK_RATE, rx_all[0]))
        require_launched(label, launches, ("dpsk_score", "ldpc_minsum"))
        print(f"{label}: found_rate="
              f"{float(det['found'].float().mean())!r} mean_iters="
              f"{float(iters.float().mean())!r} cfo max |.| "
              f"{float(det['cfo_hz'].abs().max())!r} Hz", flush=True)
        gate_decode(label, out, ok, info)
        n = PATH_CPU_LANES
        cpu = DP.decode_dpsk_batch(cfg, DPSK_RATE, rx_all[0][:n].cpu())
        require(bool(torch.equal(det["data_start"][:n].cpu(),
                                 cpu[3]["data_start"])
                      and torch.equal(det["found"][:n].cpu(),
                                      cpu[3]["found"])),
                f"{label}: preamble search on the card differs from the CPU")
        same_on_cpu(label, (out[:n], ok[:n]), cpu[:2])
        scored = phase_dpsk_score(card, cfg, rx_all[0], preset)
        if preset == "medium":
            row = (launches["dpsk_score"], *scored)
        run = dpsk_run(cfg)
        path_timing(f"DPSK {preset} path, the plain score (before the "
                    "kernel)", plain_score(run), rx_all, B, card)
        path_timing(f"DPSK {preset} path", run, rx_all, B, card)
        if preset == "robust":
            llrs = run(rx_all[0], noop)[0]
            ldpc_at_new_shape(f"R1/4 DPSK robust {snr} dB", DPSK_RATE, llrs,
                              card)
    return row


def delayfit_decode(rx: torch.Tensor, info: torch.Tensor, mark=noop):
    """The standard real-front pass and the delay-fit pass on each lane's
    own span, each codeword decoded with trap_escape; returns
    (std ok&exact [B, ncw], delay-fit ok&exact [B, ncw], delay-fit LLRs,
    spans, detection)."""
    plen = DF_CFG.fft_size + DF_CFG.cyclic_prefix
    S = P.num_data_symbols(DF_CFG, DF_MOD, DF_NCW)
    lead, tail = 2 * plen, plen          # what the layout leaves room for
    det = SC.detect_preamble(DF_CFG, rx)
    span = CH.frame_spans(rx, det["lts_start"] - lead,
                          lead + 2 * plen + S * DF_CFG.symbol_duration + tail)
    mark("detect+slice")
    n_bits = DF_NCW * get_code(DF_RATE).n
    std, _ = D.demodulate_span(DF_CFG, DF_MOD, span, det["cfo_hz"], 0.0,
                               n_lts=2, S=S, lead=lead, tail=tail,
                               front="real", n_bits=n_bits)
    mark("standard demod")
    pipe = P.pipeline_for(DF_CFG, DF_MOD, DF_RATE, DF_NCW, rx.device)
    B, k = rx.shape[0], get_code(DF_RATE).k

    def exact(llrs):
        total, ok, _ = ldpc_ops.decode_totals(pipe.code, pipe.deinterleave(
            llrs), trap_escape=True)
        bits = (total[:, :k] < 0).to(torch.uint8).reshape(B, DF_NCW, k)
        return ok.reshape(B, DF_NCW) & (bits == info.reshape(
            B, DF_NCW, k)).all(-1)

    ok_std = exact(std)
    mark("standard decode")
    dfl = DF.demodulate_span_delayfit(DF_CFG, DF_MOD, span, det["cfo_hz"],
                                      0.0, n_lts=2, S=S, lead=lead,
                                      tail=tail, front="real", n_bits=n_bits)
    mark("delay-fit demod")
    ok_df = exact(dfl)
    mark("delay-fit decode")
    return ok_std, ok_df, dfl, span, det


def phase_delayfit(dev: torch.device, card: str) -> None:
    """high_throughput() QAM16 R2/3, 8 codewords, Watterson good() then
    20 dB (tests/test_delay_fit.py:77-97) at B = 256: the delay fit
    recovers codewords the standard pass loses; its LLRs on the card match
    the CPU on 16 lanes."""
    g = torch.Generator(device=dev).manual_seed(90)
    info = random_info(g, DF_BATCH, DF_NCW * get_code(DF_RATE).k)
    tx = P.tx_cox_frame(DF_CFG, DF_MOD, DF_RATE, info, lead=DF_LEAD,
                        tail=DF_TAIL, n_codewords=DF_NCW)
    rx_all = [W.add_noise_active(W.watterson(tx, W.good(), g), DF_SNR_DB, g)
              for _ in range(2)]
    label = (f"delay-fit retry, Watterson good then {DF_SNR_DB} dB, "
             f"B={DF_BATCH} T={tx.shape[1]} codewords={DF_NCW}")
    (ok_std, ok_df, dfl, span, det), launches = launches_of(
        lambda: delayfit_decode(rx_all[0], info))
    require_launched(label, launches, ("sc_windows", "ldpc_minsum"))
    base, uni = int(ok_std.sum()), int((ok_std | ok_df).sum())
    print(f"{label}: standard {base} of {ok_std.numel()} codewords ok and "
          f"exact, delay fit {int(ok_df.sum())}, union {uni} (recovered "
          f"{uni - base})", flush=True)
    require(uni - base >= 4, f"{label}: the delay fit recovered {uni - base} "
            "codewords")
    n = PATH_CPU_LANES
    S = P.num_data_symbols(DF_CFG, DF_MOD, DF_NCW)
    plen = DF_CFG.fft_size + DF_CFG.cyclic_prefix
    cpu = DF.demodulate_span_delayfit(
        DF_CFG, DF_MOD, span[:n].cpu(), det["cfo_hz"][:n].cpu(), 0.0,
        n_lts=2, S=S, lead=2 * plen, tail=plen, front="real",
        n_bits=DF_NCW * get_code(DF_RATE).n)
    diff = (dfl[:n].cpu() - cpu).abs()
    close = bool(torch.isclose(dfl[:n].cpu(), cpu, rtol=1e-3, atol=2e-3)
                 .all())
    print(f"{label}: delay-fit LLRs card vs CPU on {n} lanes: max_abs_diff="
          f"{float(diff.max())!r} within rtol 1e-3 atol 2e-3: {close}",
          flush=True)
    require(close, f"{label}: delay-fit LLRs on the card differ from the CPU")
    pipe = P.pipeline_for(DF_CFG, DF_MOD, DF_RATE, DF_NCW, dev)
    ldpc_at_new_shape(f"delay fit R2/3 {DF_SNR_DB} dB, {DF_BATCH} x "
                      f"{DF_NCW} codewords", DF_RATE,
                      pipe.deinterleave(dfl).contiguous(), card,
                      trap_escape=True)
    path_timing("delay-fit path", lambda rx, mark: delayfit_decode(
        rx, info, mark), rx_all, DF_BATCH, card)


def mfsk_run(cfg):
    """decode_mfsk_batch's stages with marks between them."""
    code = get_code(MFSK_RATE)

    def run(x, mark):
        found, ds = FS.mfsk_find_preamble(cfg, x)
        mark("find")
        n_sym = -(-code.n // cfg.bits_per_symbol) * cfg.repetition
        llrs = FS.mfsk_demodulate_soft(cfg, CH.frame_spans(
            x, ds, n_sym * cfg.samples_per_symbol))
        mark("slice+soft")
        out = ldpc_ops.decode_totals(ldpc_ops.graph_for(code, x.device),
                                     llrs[:, :code.n].contiguous())
        mark("decode")
        return out
    return run


def phase_mfsk(dev: torch.device, card: str) -> None:
    """The five MFSK presets at their operating points through
    decode_mfsk_batch, B = 256 each."""
    for i, (preset, snr) in enumerate(MFSK_POINTS):
        cfg = getattr(FS, preset)()
        g = torch.Generator(device=dev).manual_seed(100 + i)
        info = random_info(g, MFSK_BATCH, get_code(MFSK_RATE).k)
        cw = ldpc_ops.encode(get_code(MFSK_RATE), info)
        pre = torch.from_numpy(FS.mfsk_generate_preamble(cfg)).to(dev)
        tx = torch.cat([torch.zeros((MFSK_BATCH, MFSK_LEAD), device=dev),
                        pre.expand(MFSK_BATCH, pre.shape[0]),
                        FS.mfsk_modulate(cfg, cw),
                        torch.zeros((MFSK_BATCH, MFSK_TAIL), device=dev)],
                       dim=-1)
        rx = W.add_noise_active(tx, snr, g)
        del tx
        label = f"MFSK {preset} {snr} dB B={MFSK_BATCH} T={rx.shape[1]}"
        (out, ok, _, found, ds), launches = launches_of(
            lambda: FS.decode_mfsk_batch(cfg, MFSK_RATE, rx))
        require_launched(label, launches, ("ldpc_minsum",))
        true_ds = MFSK_LEAD + cfg.preamble_samples(2)
        print(f"{label}: found_rate={float(found.float().mean())!r} "
              f"data_start minus the true one: min {int((ds - true_ds).min())}"
              f" max {int((ds - true_ds).max())}", flush=True)
        # mfsk_robust's two-tone sweep scores noise windows of the lead as
        # matches, so the earliest full score lands up to 10 hops early
        # and ~16% of frames fail, in the JAX package alike
        # (tests/test_torch_mfsk.py::test_robust_early_search_matches_jax):
        # its rate is printed and the card held to the CPU path.
        gate_decode(label, out, ok, info,
                    gate=None if preset == "mfsk_robust" else DECODE_GATE)
        n = PATH_CPU_LANES
        cpu = FS.decode_mfsk_batch(cfg, MFSK_RATE, rx[:n].cpu())
        require(bool(torch.equal(ds[:n].cpu(), cpu[4])),
                f"{label}: preamble search on the card differs from the CPU")
        same_on_cpu(label, (out[:n], ok[:n]), cpu[:2])
        path_timing(f"MFSK {preset} path", mfsk_run(cfg), [rx], MFSK_BATCH,
                    card)
        del rx


def otfs_buffers(info: torch.Tensor) -> torch.Tensor:
    """[lead zeros][preamble + one codeword][tail zeros] OTFS frames."""
    B, dev = info.shape[0], info.device
    tx = OT.frame_tx(OTFS_CFG, Modulation.QPSK,
                     ldpc_ops.encode(get_code(OTFS_RATE), info))
    return torch.cat([torch.zeros((B, OTFS_LEAD), device=dev), tx,
                      torch.zeros((B, OTFS_TAIL), device=dev)], dim=-1)


def otfs_run(rx, mark):
    """decode_otfs_batch's stages with marks between them."""
    code = get_code(OTFS_RATE)
    found, start = OT.detect_frame(OTFS_CFG, rx)
    mark("detect")
    llrs = OT.demodulate_frame(OTFS_CFG, Modulation.QPSK, CH.frame_spans(
        rx, start, OTFS_CFG.frame_len))
    mark("slice+demod")
    out = ldpc_ops.decode_totals(ldpc_ops.graph_for(code, rx.device),
                                 llrs[:, :code.n].contiguous())
    mark("decode")
    return out


def phase_otfs(dev: torch.device, card: str) -> None:
    """OTFS QPSK R1/4 through decode_otfs_batch (detect_frame on padded
    buffers, then demodulate_frame): 20 dB AWGN gated, Watterson good(25)
    printed (tests/test_otfs.py:92-106)."""
    g = torch.Generator(device=dev).manual_seed(110)
    info = random_info(g, OTFS_BATCH, get_code(OTFS_RATE).k)
    tx = otfs_buffers(info)
    rx_all = [W.add_noise_active(tx, OTFS_SNR_DB, g) for _ in range(2)]
    label = f"OTFS {OTFS_SNR_DB} dB B={OTFS_BATCH} T={tx.shape[1]}"
    (out, ok, _, found, start), launches = launches_of(
        lambda: OT.decode_otfs_batch(OTFS_CFG, Modulation.QPSK, OTFS_RATE,
                                     rx_all[0]))
    require_launched(label, launches, ("ldpc_minsum",))
    print(f"{label}: found_rate={float(found.float().mean())!r} start "
          f"offsets from the true {OTFS_LEAD}: min "
          f"{int((start - OTFS_LEAD).min())} max "
          f"{int((start - OTFS_LEAD).max())}", flush=True)
    # detect_frame's fine timing lands up to ~700 samples late on ~20% of
    # the frames at 20 dB (the 0.98 rule's first crossing inside the
    # preamble plateau), and those frames fail, in the JAX package alike
    # (tests/test_torch_otfs.py::test_late_fine_timing_lanes_match_jax;
    # the engine refines the start before decoding): the rate is printed
    # and the card held to the CPU path.
    gate_decode(label, out, ok, info, gate=None)
    n = PATH_CPU_LANES
    cpu = OT.decode_otfs_batch(OTFS_CFG, Modulation.QPSK, OTFS_RATE,
                               rx_all[0][:n].cpu())
    require(bool(torch.equal(start[:n].cpu(), cpu[4])),
            f"{label}: detection on the card differs from the CPU")
    same_on_cpu(label, (out[:n], ok[:n]), cpu[:2])
    path_timing("OTFS path", otfs_run, rx_all, OTFS_BATCH, card)

    # Printed, not gated: a deep fade can converge to another codeword.
    fading = W.watterson(tx, W.good(25.0), g)
    out, ok, _, found, _ = OT.decode_otfs_batch(
        OTFS_CFG, Modulation.QPSK, OTFS_RATE, fading)
    exact = ok & (out == info).all(-1)
    print(f"OTFS through Watterson good(25) B={OTFS_BATCH}: found_rate="
          f"{float(found.float().mean())!r} ok_rate="
          f"{float(ok.float().mean())!r} ok_and_exact_rate="
          f"{float(exact.float().mean())!r}", flush=True)


# ---------------------------------------------------------------------------
# Slice 6: the streaming modem engine
# ---------------------------------------------------------------------------

ENGINE_CHUNK = 960          # 20 ms: one audio callback
REF_PAD = 8000              # tests/test_ref_interop.py:41
REF_FILES = [  # (file, waveform mode set, what tests/test_ref_interop.py asserts)
    ("ref_cli_tx_ping.f32", None, "one ping"),
    ("ref_cli_tx_connect.f32", None, "CONNECT AA1AA -> BB2BB"),
    ("ref_cli_tx_disconnect.f32", None, "DISCONNECT"),
    ("ref_cli_tx_ofdm.f32", F.WaveformMode.OFDM_COX, "interop payload 123"),
    ("ref_cli_tx_dpsk_mapped.f32", None, "dpsk interop"),
]
# Float fields of a frame read back from float32 device math (the CPU
# engine's against the card's): dB and Hz.
FRAME_TOL = {"snr_db": 0.05, "cfo_hz": 1e-3, "wideband_snr_db": 1e-3,
             "fade_spread_db": 1e-3}
TRAFFIC_SECONDS = 60
TRAFFIC_SEED = 120
# The station polls every 100 ms of audio (five 20 ms chunks): the
# acquisition cadence of the reference's receiver (modem_rx.cpp) and of
# the CLI's prx.  A poll after every chunk re-runs a pending Cox frame's
# CW0 probe five times as often (PERF.md, PR 6).
TRAFFIC_POLL_CHUNKS = 5
CONTROL_SNR_DB, CONTROL_CFO_HZ = 10.0, 20.0   # tests/test_cli_modem.py:65-80
DATA_SNR_DB, DATA_CFO_HZ = 22.0, 12.0         # tests/test_cli_modem.py:174-186
PROFILE_WINDOW_S = 10


def stream_through(engine, audio: np.ndarray, poll_every: int = 1):
    """Feeds audio in ENGINE_CHUNK-sample pieces with a poll after every
    ``poll_every`` pieces and after the last.  Returns (events in order:
    ("ping", snr) or ("frame", DecodedFrame), the consumed position after
    every poll, each poll's seconds, the index of the poll that delivered
    each event)."""
    events, consumed, poll_s, at = [], [], [], []
    engine.on_frame = lambda fr: events.append(("frame", fr))
    engine.on_ping = lambda snr: events.append(("ping", snr))
    chunk = ENGINE_CHUNK
    for k, i in enumerate(range(0, len(audio), chunk)):
        engine.feed_audio(audio[i:i + chunk])
        if (k + 1) % poll_every and i + chunk < len(audio):
            continue
        n = len(events)
        t0 = time.perf_counter()
        engine.poll()
        poll_s.append(time.perf_counter() - t0)
        consumed.append(engine._rx_consumed)
        at += [len(poll_s) - 1] * (len(events) - n)
    return events, consumed, poll_s, at


def same_events(label: str, card: list, cpu: list) -> None:
    """The card engine's events against the CPU engine's: kinds, frame
    bytes, header, codeword flags and waveform exact, float fields within
    FRAME_TOL (pings within 0.05 dB)."""
    require([k for k, _ in card] == [k for k, _ in cpu],
            f"{label}: the card's events differ from the CPU's")
    for (kind, a), (_, b) in zip(card, cpu):
        if kind == "ping":
            require(abs(a - b) <= 0.05, f"{label}: ping SNR {a} vs {b}")
            continue
        require(a.frame_bytes == b.frame_bytes and a.header == b.header
                and list(a.cw_ok) == list(b.cw_ok)
                and a.waveform == b.waveform,
                f"{label}: a frame on the card differs from the CPU's")
        for key, tol in FRAME_TOL.items():
            require(abs(getattr(a, key) - getattr(b, key)) <= tol,
                    f"{label}: {key} {getattr(a, key)} vs {getattr(b, key)}")


def check_ref_frames(name: str, events: list) -> None:
    """tests/test_ref_interop.py's assertions."""
    frames = [x for k, x in events if k == "frame"]
    pings = [x for k, x in events if k == "ping"]
    if name == "ref_cli_tx_ping.f32":
        require(len(pings) == 1 and not frames, f"{name}: {events}")
        return
    require(len(frames) == 1 and not pings, f"{name}: {len(frames)} frames, "
            f"{len(pings)} pings")
    fr = frames[0]
    if name == "ref_cli_tx_connect.f32":
        cf = F.ConnectFrame.deserialize(fr.frame_bytes)
        require(cf is not None and cf.src_callsign == "AA1AA"
                and cf.dst_callsign == "BB2BB", f"{name}: {cf}")
    elif name == "ref_cli_tx_disconnect.f32":
        require(fr.header.type == F.FrameType.DISCONNECT, f"{name}")
    else:
        want = ("interop payload 123" if "ofdm" in name else "dpsk interop")
        df = F.DataFrame.deserialize(fr.frame_bytes)
        require(df is not None and df.payload_as_text() == want, f"{name}")
        if "dpsk" in name:
            require(fr.waveform == F.WaveformMode.MC_DPSK, f"{name}")


def phase_engine_reference(dev: torch.device, card: str) -> None:
    """The reference CLI's five files through ModemEngine on the card and
    on the CPU, 960-sample feeds, a poll after each."""
    torch.cuda.synchronize()
    cuda_ldpc.launches = cuda_sc.launches = 0
    runs = {}
    for name, mode, _ in REF_FILES:
        audio = np.concatenate([np.fromfile(GOLDEN / name, dtype=np.float32),
                                np.zeros(REF_PAD, np.float32)])
        for where in ("card", "cpu"):
            engine = ModemEngine(device=dev if where == "card" else "cpu")
            if mode is not None:
                engine.set_waveform_mode(mode)
            t0 = time.perf_counter()
            runs[name, where] = (*stream_through(engine, audio)[:2],
                                 time.perf_counter() - t0)
        torch.cuda.synchronize()
    launches = {"sc_windows": cuda_sc.launches,
                "ldpc_minsum": cuda_ldpc.launches}
    for name, _, want in REF_FILES:
        (ev, cons, wall), (ev_c, cons_c, wall_c) = (runs[name, "card"],
                                                   runs[name, "cpu"])
        check_ref_frames(name, ev)
        same_events(name, ev, ev_c)
        require(cons == cons_c, f"{name}: consumed positions differ between "
                "the card and the CPU")
        print(f"engine, reference CLI audio {name} ({want}): "
              f"{len(cons)} polls, events {[k for k, _ in ev]}, the same "
              f"events and consumed positions on the CPU; wall {wall!r} s on "
              f"the card, {wall_c!r} s on the CPU ({card})", flush=True)
    require_launched("engine, reference CLI audio", launches,
                     ("sc_windows", "ldpc_minsum"))


def traffic_audio(seed: int, seconds: float):
    """A minute of a station's received audio, built on the host from a
    numpy seed: a CONNECT and a closing DISCONNECT over MC-DPSK (a
    disconnected sender: DQPSK R1/4) at 10 dB and 20 Hz, and between them
    connected OFDM_COX data frames at the engine's data mode (QPSK R1/2)
    carrying 100-1,000 random bytes, the second of them 1,000 bytes, at
    22 dB and 12 Hz; 0.2-1 s of noise before each frame.  Returns (audio,
    [(frame bytes, waveform)] in order, each frame's TX samples)."""
    cpu = torch.device("cpu")
    rng = np.random.default_rng(seed)
    control = ModemEngine(device=cpu)
    data = ModemEngine(device=cpu)
    data.connected = data.handshake_complete = True
    total = int(seconds * 48000)
    pieces, expected, spans, used = [], [], [], 0

    def add(frame: bytes, engine, wf, snr_db, cfo_hz):
        nonlocal used
        tx = engine.transmit(frame)
        spans.append(len(tx))
        gap = np.zeros(int(rng.uniform(0.2, 1.0) * 48000), np.float32)
        seg = torch.from_numpy(np.concatenate([gap, tx]))[None]
        seg = W.apply_cfo_hilbert(seg, cfo_hz)
        noise = torch.from_numpy(rng.standard_normal(seg.shape,
                                                     dtype=np.float32))
        pieces.append(W.add_noise_with(seg, snr_db, noise)[0].numpy())
        expected.append((frame, wf))
        used += pieces[-1].shape[0]

    connect = F.ConnectFrame.make_connect(
        "AA1AA", "BB2BB", 0x3F, int(F.WaveformMode.OFDM_COX)).serialize()
    add(connect, control, F.WaveformMode.MC_DPSK, CONTROL_SNR_DB,
        CONTROL_CFO_HZ)
    disconnect = F.ConnectFrame.make_disconnect("AA1AA", "BB2BB").serialize()
    reserve = len(control.transmit(disconnect)) + 48000 + 24000
    seq = 0
    while True:
        n = 1000 if seq == 1 else int(rng.integers(100, 1001))
        frame = F.DataFrame.make_data(
            "AA1AA", "BB2BB", seq,
            bytes(rng.integers(0, 256, n, dtype=np.uint8))).serialize()
        if used + len(data.transmit(frame)) + 48000 + reserve > total:
            break
        add(frame, data, F.WaveformMode.OFDM_COX, DATA_SNR_DB, DATA_CFO_HZ)
        seq += 1
    noise_std = float(np.std(pieces[-1][:9600]))
    add(disconnect, control, F.WaveformMode.MC_DPSK, CONTROL_SNR_DB,
        CONTROL_CFO_HZ)
    pieces.append(rng.standard_normal(total - used, dtype=np.float32)
                  * np.float32(noise_std))
    return np.concatenate(pieces), expected, spans


def recorded_decodes(decodes: list):
    """A stand-in for ``frame_v2.decode_codewords_with_ldpc`` that records
    each decode's (rate, LLR blocks) in ``decodes``."""
    real = F.decode_codewords_with_ldpc

    def recording(blocks, rate=CodeRate.R1_4, *, device):
        decodes.append((rate, np.stack([np.asarray(b, np.float32)[:648]
                                        for b in blocks])))
        return real(blocks, rate, device=device)
    return recording


def phase_engine_traffic(dev: torch.device, card: str):
    """A minute of traffic through one receiving station (connected,
    handshake complete, OFDM_COX) on the card; returns ((rate, LLR
    blocks) of the engine's first B = 1 and its largest LDPC decode, the
    audio)."""
    t0 = time.perf_counter()
    audio, expected, spans = traffic_audio(TRAFFIC_SEED, TRAFFIC_SECONDS)
    build_s = time.perf_counter() - t0
    require(len(audio) == TRAFFIC_SECONDS * 48000
            and max(spans) > ModemEngine.ACQ_VIEW_CAP,
            f"traffic: {len(audio)} samples, frame spans {spans}")
    engine = ModemEngine(device=dev)
    engine.connected = engine.handshake_complete = True
    engine.set_waveform_mode(F.WaveformMode.OFDM_COX)
    decodes = []
    split = ENGINE_CHUNK * (20 * 48000 // ENGINE_CHUNK)
    window = ENGINE_CHUNK * (PROFILE_WINDOW_S * 48000 // ENGINE_CHUNK)
    torch.cuda.synchronize()
    cuda_ldpc.launches = cuda_sc.launches = 0
    with mock.patch.object(F, "decode_codewords_with_ldpc",
                           recorded_decodes(decodes)):
        t0 = time.perf_counter()
        parts = [stream_through(engine, audio[:split], TRAFFIC_POLL_CHUNKS)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tp = time.perf_counter()
            parts.append(stream_through(engine, audio[split:split + window],
                                        TRAFFIC_POLL_CHUNKS))
            torch.cuda.synchronize()
            window_s = time.perf_counter() - tp
        parts.append(stream_through(engine, audio[split + window:],
                                    TRAFFIC_POLL_CHUNKS))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"sc_windows": cuda_sc.launches,
                "ldpc_minsum": cuda_ldpc.launches}
    events = [e for part in parts for e in part[0]]
    poll_s = np.concatenate([part[2] for part in parts])
    offsets = np.cumsum([0] + [len(part[2]) for part in parts])
    at = [o + i for o, part in zip(offsets, parts) for i in part[3]]

    got = [(fr.frame_bytes, fr.waveform) for k, fr in events if k == "frame"]
    delivered = len(got) == len(expected) and all(
        a == b for a, b in zip(got, expected))
    pings = sum(1 for k, _ in events if k == "ping")
    sizes = [len(f) - F.HEADER_SIZE - F.CRC_SIZE for f, w in expected
             if w == F.WaveformMode.OFDM_COX]
    print(f"engine traffic: {len(expected)} frames sent ({len(sizes)} "
          f"OFDM_COX data of {sizes} payload bytes, 2 MC-DPSK control; TX "
          f"spans {spans} samples); {len(got)} delivered, {pings} pings; "
          f"every frame once, in order, exact: {delivered} (audio built in "
          f"{build_s!r} s)", flush=True)
    require(delivered and pings == 0,
            "engine traffic: the delivered frames differ from those sent")
    audio_s = len(audio) / 48000.0
    busy = busy_ms(prof) / 1000.0
    print(f"engine traffic on {card}: audio {audio_s!r} s, wall {wall!r} s, "
          f"real-time factor {audio_s / wall!r}", flush=True)
    print(f"engine traffic on {card}: a poll every {TRAFFIC_POLL_CHUNKS} "
          f"chunks of {ENGINE_CHUNK} samples; poll ms median "
          f"{float(np.median(poll_s)) * 1e3!r}, p99 "
          f"{float(np.percentile(poll_s, 99)) * 1e3!r}, max "
          f"{float(poll_s.max()) * 1e3!r} over {len(poll_s)} polls",
          flush=True)
    for wf in (F.WaveformMode.MC_DPSK, F.WaveformMode.OFDM_COX):
        ms = [poll_s[i] * 1e3 for i, (k, fr) in zip(at, events)
              if k == "frame" and fr.waveform == wf]
        print(f"engine traffic on {card}: {wf.name} frames, ms of the poll "
              f"that delivered each: median {float(np.median(ms))!r}, max "
              f"{float(max(ms))!r} ({len(ms)} frames)", flush=True)
    print(f"engine traffic on {card}: profiled {PROFILE_WINDOW_S} s of audio "
          f"in {window_s!r} s wall, device busy {busy!r} s: idle share "
          f"{1.0 - busy / window_s!r}", flush=True)
    print(f"engine traffic kernel launches in {audio_s!r} s of audio on "
          f"{card}: {launches}", flush=True)
    lib = native._load()
    print(f"engine traffic on {card}: native library built and loaded: "
          f"{bool(lib)} ({Path(lib._name).name if lib else 'pure-Python '
                         'fallback'})", flush=True)
    require_launched("engine traffic", launches, ("sc_windows",
                                                  "ldpc_minsum"))
    one = next(d for d in decodes if d[1].shape[0] == 1)
    largest = max(decodes, key=lambda d: d[1].shape[0])
    return one, largest, audio


def phase_engine_kernels(dev: torch.device, card: str, one, largest,
                         audio: np.ndarray) -> None:
    """Both kernels at the engine's shapes: the window sums over one
    search view (B = 1, T = ACQ_VIEW_CAP) and the LDPC decodes the stream
    made (B = 1 and the largest, trap_escape as the engine runs them)."""
    T = ModemEngine.ACQ_VIEW_CAP
    view = torch.from_numpy(audio[:T].copy()).to(dev)[None]
    a = SC.analytic_signal(view)
    G = SC.search_grid_size(COX_CFG, T)
    compare_windows(a, 8, CP, G, "engine search view")

    def kernel():
        cuda_sc.sc_windows_cuda(a, HALF, 8, CP, G)

    def plain():
        sc_windows_plain(a, HALF, 8, CP, G)

    k_ms, p_ms = time_pair(kernel, plain, 50, 10)
    print(f"window sums engine view B=1 T={T} stride 8 G={G}: kernel "
          f"{k_ms!r} ms, plain {p_ms!r} ms (calls, CUDA events) on {card}",
          flush=True)
    bound_ms, by = sc_bound(1, HALF, 8, G)
    report_shape("sc_windows", f"engine search view, B=1, T={T}, stride 8, "
                 f"G={G}", kernel, 50, bound_ms, by, card)
    for label, (rate, blocks) in (("engine CW0 probe", one),
                                  ("engine largest decode", largest)):
        llrs = torch.from_numpy(blocks).to(dev)
        ldpc_at_new_shape(f"{label} {GOLDEN_NAMES[CodeRate(int(rate))]}",
                          CodeRate(int(rate)), llrs, card, trap_escape=True)


def phase_engine(dev: torch.device, card: str) -> None:
    t0 = time.perf_counter()
    phase_engine_reference(dev, card)
    one, largest, audio = phase_engine_traffic(dev, card)
    phase_engine_kernels(dev, card, one, largest, audio)
    print(f"phase_engine: {time.perf_counter() - t0!r} s", flush=True)



# ---------------------------------------------------------------------------
# Slice 7: the protocol stack and the CLI
# ---------------------------------------------------------------------------

CLI_MESSAGES = ["ping", "connect", "disconnect", "Hello CLI"]
CLI_WAVEFORMS = ["ofdm", "dpsk", "mcdpsk"]
# TX audio of the card against the CPU port: the golden TX tolerance, and
# tests/test_torch_dpsk.py's for DPSK, whose float32 symbol phases
# accumulate in another order.
CLI_TX_TOL = {"ofdm": 2e-4, "dpsk": 5e-4, "mcdpsk": 2e-4}
SESSION_GAP = 4000          # zeros after each TX (tests/test_protocol.py:336)
SESSION_SNR_DB = 15.0       # the responder's measured SNR (test_protocol.py:335)
SESSION_MESSAGES = 3
SESSION_FILE_BYTES = 2048
SESSION_SEED = 140
LOSSY_SNR_DB = 8.0          # tests/test_protocol.py:449-500
LOSSY_MESSAGES = 10
LOSSY_SEED = 150
LOSSY_TICK_MS = 5000


def run_cli(argv: list, device: torch.device) -> tuple[int, str]:
    """(return code, stderr) of the port's CLI on ``device``."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv, device=device)
    return rc, err.getvalue()


def phase_cli(dev: torch.device, card: str) -> None:
    """``ptx`` of the four messages with the three waveforms on the card
    against the CPU port (audio within CLI_TX_TOL, the same report), and
    ``prx`` of the reference's five files on both (the same stderr)."""
    cpu = torch.device("cpu")
    with tempfile.TemporaryDirectory() as tmp:
        for waveform in CLI_WAVEFORMS:
            for msg in CLI_MESSAGES:
                audio, report = {}, {}
                for where, d in (("card", dev), ("cpu", cpu)):
                    path = Path(tmp) / f"{where}.f32"
                    rc, err = run_cli(["ptx", msg, "-s", "W1AW", "-d",
                                       "VE3ABC", "-w", waveform, "-o",
                                       str(path)], d)
                    require(rc == 0, f"cli ptx {msg} -w {waveform}: rc {rc}")
                    audio[where] = np.fromfile(path, dtype=np.float32)
                    report[where] = err.replace(str(path), "<out>")
                a, b = audio["card"], audio["cpu"]
                err = float(np.abs(a - b).max()) if a.shape == b.shape \
                    else float("inf")
                print(f"cli ptx {msg!r} -w {waveform} on {card}: "
                      f"{a.shape[0]} samples, max |card - cpu| {err!r}, "
                      f"report equal {report['card'] == report['cpu']}",
                      flush=True)
                require(err <= CLI_TX_TOL[waveform]
                        and report["card"] == report["cpu"],
                        f"cli ptx {msg} -w {waveform}: the card differs "
                        "from the CPU")
    for name, _, want in REF_FILES:
        argv = ["prx", str(GOLDEN / name), "-w",
                "mcdpsk" if "dpsk" in name else "ofdm"]
        t0 = time.perf_counter()
        rc, err = run_cli(argv, dev)
        wall = time.perf_counter() - t0
        rc_c, err_c = run_cli(argv, cpu)
        lines = [ln.strip() for ln in err.splitlines() if ln.strip()]
        print(f"cli prx {name} ({want}) on {card} in {wall!r} s: {lines}",
              flush=True)
        require(rc == rc_c == 0 and err == err_c,
                f"cli prx {name}: the card's report differs from the CPU's")
        require("Frames: 1" in err or "PINGs: 1" in err,
                f"cli prx {name}: nothing decoded")


class Session:
    """Two port stations on ``dev`` and the air between them: each TX is
    queued, and ``pump`` hands the queue on in order, each TX through
    ``channel(audio, n)`` (n counts the session's transmissions from 1)
    into the other station's ``feed_audio``, so no station's poll runs
    inside another's.  Records every TX, every frame each station
    decodes, and the time of each ``transmit`` and of each receiving
    ``poll`` (without the transmissions it triggers)."""

    def __init__(self, dev: torch.device, channel, measured_snr: float):
        self.a, self.b = PE(device=dev), PE(device=dev)
        self.a.connection.set_local_callsign("W1AW")
        self.b.connection.set_local_callsign("VE3ABC")
        self.b.connection.set_measured_snr(measured_snr)
        self.channel = channel
        self.queue, self.tx = [], []
        self.got = {"a": [], "b": []}
        self.decoded = {"a": [], "b": []}
        self.transmit_s, self.poll_s = [], []
        for name, me, peer in (("a", self.a, self.b), ("b", self.b, self.a)):
            me.on_tx_audio = (lambda audio, name=name, peer=peer:
                              self.queue.append((name, peer, audio)))
            me.connection.on_message_received = self.got[name].append
            self._instrument(name, me)

    def _instrument(self, name: str, station) -> None:
        modem, inner = station.modem, [0.0]
        on_frame = modem.on_frame

        def frame(fr):
            self.decoded[name].append(fr.header.type)
            on_frame(fr)

        def timed_tx(fn):
            def call(*args):
                t0 = time.perf_counter()
                out = fn(*args)
                dt = time.perf_counter() - t0
                self.transmit_s.append(dt)
                inner[0] += dt
                return out
            return call

        poll = modem.poll

        def timed_poll():
            inner[0] = 0.0
            t0 = time.perf_counter()
            out = poll()
            self.poll_s.append(time.perf_counter() - t0 - inner[0])
            return out

        modem.on_frame = frame
        modem.transmit = timed_tx(modem.transmit)
        modem.transmit_ping = timed_tx(modem.transmit_ping)
        modem.poll = timed_poll

    def pump(self) -> None:
        while self.queue:
            name, peer, audio = self.queue.pop(0)
            self.tx.append((name, len(audio)))
            peer.feed_audio(self.channel(audio, len(self.tx)))

    def tick(self, ms: int) -> None:
        self.a.tick(ms)
        self.b.tick(ms)
        self.pump()

    def report(self, label: str, wall: float, card: str) -> None:
        audio_s = sum(n for _, n in self.tx) / 48000.0
        frames = {k: sum(1 for n, _ in self.tx if n == k) for k in "ab"}
        retx = {k: s.connection.arq.stats.retransmissions
                for k, s in (("a", self.a), ("b", self.b))}
        kinds = {k: dict(Counter(F.FrameType(int(t)).name for t in v))
                 for k, v in self.decoded.items()}
        print(f"{label} on {card}: wall {wall!r} s, audio exchanged "
              f"{audio_s!r} s, transmissions a->b {frames['a']}, b->a "
              f"{frames['b']}; frames decoded by a {kinds['a']}, by b "
              f"{kinds['b']}; retransmissions {retx}", flush=True)
        print(f"{label} on {card}: transmit ms median "
              f"{float(np.median(self.transmit_s)) * 1e3!r} "
              f"({len(self.transmit_s)} calls), receiving poll ms median "
              f"{float(np.median(self.poll_s)) * 1e3!r}, max "
              f"{float(max(self.poll_s)) * 1e3!r} ({len(self.poll_s)} polls)",
              flush=True)


def clean_air(audio: np.ndarray, n: int) -> np.ndarray:
    return np.concatenate([audio, np.zeros(SESSION_GAP, np.float32)])


def watterson_air(dev: torch.device):
    """The port's Watterson ``moderate`` channel at LOSSY_SNR_DB on the
    card, 2,000 zeros before and 4,000 after each TX (test_protocol.py:
    457-466), its normals drawn with numpy from (LOSSY_SEED, n)."""
    cfg = W.moderate(LOSSY_SNR_DB)
    paths = 2 if cfg.multipath_enabled and cfg.delay_spread_ms > 0 else 1

    def channel(audio: np.ndarray, n: int) -> np.ndarray:
        x = np.concatenate([np.zeros(2000, np.float32), audio,
                            np.zeros(4000, np.float32)])
        rng = np.random.default_rng([LOSSY_SEED, n])
        fade = rng.standard_normal((2, 1, paths, len(x)), dtype=np.float32)
        noise = rng.standard_normal((1, len(x)), dtype=np.float32)
        out = W.watterson_with(torch.from_numpy(x).to(dev)[None], cfg,
                               torch.from_numpy(fade).to(dev),
                               torch.from_numpy(noise).to(dev))
        return out[0].cpu().numpy()
    return channel


def clean_session(dev: torch.device, tmp: Path) -> tuple:
    """Connect, SESSION_MESSAGES messages each way, a SESSION_FILE_BYTES
    file of random bytes, a MODE_CHANGE and a message after it, then a
    disconnect.  Returns (session, file bytes sent, file bytes received,
    data modes (a, b) after the change)."""
    s = Session(dev, clean_air, SESSION_SNR_DB)
    (tmp / "rx").mkdir()
    s.b.connection.file_transfer.receive_dir = str(tmp / "rx")
    received = []
    s.b.connection.file_transfer.on_received = \
        lambda path, ok: received.append((path, ok))
    require(s.a.connect("VE3ABC"), "session: connect refused")
    s.pump()
    require(s.a.connection.is_connected and s.b.connection.is_connected,
            f"session: not connected ({s.a.connection.state}, "
            f"{s.b.connection.state})")
    for i in range(SESSION_MESSAGES):
        require(s.a.send_message(f"clean-a-{i}"), "session: send refused")
        require(s.b.send_message(f"clean-b-{i}"), "session: send refused")
        s.pump()
    content = np.random.default_rng(SESSION_SEED).integers(
        0, 256, SESSION_FILE_BYTES, dtype=np.uint8).tobytes()
    (tmp / "random.bin").write_bytes(content)
    require(s.a.connection.send_file(str(tmp / "random.bin")),
            "session: send_file refused")
    s.pump()
    for _ in range(60):
        if received:
            break
        s.tick(1000)
    got = Path(received[0][0]).read_bytes() if received and received[0][1] \
        else b""
    require(s.a.connection.request_mode_change(Modulation.DQPSK,
                                               CodeRate.R1_2),
            "session: mode change refused")
    s.pump()
    modes = tuple(f"{e.modem.data_modulation.name} "
                  f"{e.modem.data_code_rate.name}" for e in (s.a, s.b))
    require(s.a.send_message("after-mode-change"), "session: send refused")
    s.pump()
    s.a.disconnect()
    s.pump()
    for _ in range(40):
        if not (s.a.connection.is_connected or s.b.connection.is_connected):
            break
        s.tick(500)
    return s, content, got, modes


def lossy_session(dev: torch.device) -> Session:
    """LOSSY_MESSAGES messages each way over the Watterson channel, both
    stations ticking LOSSY_TICK_MS at a time (the ARQ's 45 s timeouts
    retransmit what the channel loses)."""
    s = Session(dev, watterson_air(dev), LOSSY_SNR_DB)
    require(s.a.connect("VE3ABC"), "lossy session: connect refused")
    s.pump()
    require(s.a.connection.is_connected and s.b.connection.is_connected,
            "lossy session: not connected")
    ia = ib = 0
    for _ in range(400):
        if ia < LOSSY_MESSAGES and s.a.send_message(f"lossy-a-{ia:02d}"):
            ia += 1
        if ib < LOSSY_MESSAGES and s.b.send_message(f"lossy-b-{ib:02d}"):
            ib += 1
        s.pump()
        s.tick(LOSSY_TICK_MS)
        if min(ia, ib, len(s.got["a"]), len(s.got["b"])) >= LOSSY_MESSAGES \
                or not s.a.connection.is_connected:
            break
    return s


def drive_session(label: str, run, card: str):
    """Runs ``run()`` (a session; returns its Session first) with both
    kernels' launch counters set to 0 just before it and read just after,
    under ``torch.profiler``; prints its report and the device's idle
    share.  Returns (run's result, launches)."""
    torch.cuda.synchronize()
    cuda_ldpc.launches = cuda_sc.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"sc_windows": cuda_sc.launches,
                "ldpc_minsum": cuda_ldpc.launches}
    out[0].report(label, wall, card)
    busy = busy_ms(prof) / 1000.0
    print(f"{label} on {card}: device busy {busy!r} s of {wall!r} s "
          f"(profiled): idle share {1.0 - busy / wall!r}", flush=True)
    return out, launches


def phase_protocol(dev: torch.device, card: str) -> None:
    """The CLI on the card, then two ProtocolEngine stations on the card:
    a clean session and a lossy one (``drive_session``); then the LDPC
    kernel at the sessions' largest decode."""
    t0 = time.perf_counter()
    phase_cli(dev, card)
    print(f"phase_protocol, CLI: {time.perf_counter() - t0!r} s", flush=True)
    decodes = []
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(F, "decode_codewords_with_ldpc",
                              recorded_decodes(decodes)):
        (s, content, got, modes), launches = drive_session(
            "protocol clean session", lambda: clean_session(dev, Path(tmp)),
            card)
        want_a = [f"clean-b-{i}" for i in range(SESSION_MESSAGES)]
        want_b = [f"clean-a-{i}" for i in range(SESSION_MESSAGES)] \
            + ["after-mode-change"]
        print(f"protocol clean session: file {len(content)} bytes sent, "
              f"{len(got)} received, exact {got == content}; messages at a "
              f"{s.got['a']}, at b {s.got['b']}; data modes after the change: "
              f"a {modes[0]}, b {modes[1]}; connected at the end a "
              f"{s.a.connection.is_connected} b {s.b.connection.is_connected}",
              flush=True)
        require(got == content, "protocol clean session: the file differs")
        require(s.got["a"] == want_a and s.got["b"] == want_b,
                "protocol clean session: messages lost, repeated or out of "
                "order")
        require(modes[0] == modes[1],
                "protocol clean session: the stations' data modes differ")
        require(not (s.a.connection.is_connected
                     or s.b.connection.is_connected),
                "protocol clean session: the disconnect did not complete")
        require_launched("protocol clean session", launches,
                         ("sc_windows", "ldpc_minsum"))

        (s,), launches = drive_session(
            "protocol lossy session", lambda: (lossy_session(dev),), card)
        want = {k: [f"lossy-{o}-{i:02d}" for i in range(LOSSY_MESSAGES)]
                for k, o in (("a", "b"), ("b", "a"))}
        print(f"protocol lossy session: messages at a {s.got['a']}, at b "
              f"{s.got['b']}; connected a {s.a.connection.is_connected} b "
              f"{s.b.connection.is_connected}; waveform "
              f"{F.WaveformMode(int(s.a.modem.waveform_mode)).name}",
              flush=True)
        require(s.got == want, "protocol lossy session: messages lost, "
                "repeated or out of order")
        require(s.a.connection.is_connected and s.b.connection.is_connected,
                "protocol lossy session: the connection dropped")
        require_launched("protocol lossy session", launches, ("ldpc_minsum",))
    rate, blocks = max(decodes, key=lambda d: d[1].shape[0])
    ldpc_at_new_shape(f"protocol session largest decode "
                      f"{GOLDEN_NAMES[CodeRate(int(rate))]}",
                      CodeRate(int(rate)), torch.from_numpy(blocks).to(dev),
                      card, trap_escape=True)
    print(f"phase_protocol: {time.perf_counter() - t0!r} s", flush=True)

# ---------------------------------------------------------------------------
# Slice 8: the sweep harness and frame-axis data parallelism
# ---------------------------------------------------------------------------

SWEEP_SEED = 42             # the harness's seed (parallel/sweep.py)
SWEEP_NP_SEED = 160         # numpy noise of a row rebuilt after a miss
STREAM_ROWS = [             # 3 frames each: the engine's polls are host-bound
    (SW.SweepPoint("MC_DPSK", 5.0, 0.0, "awgn", frames=3), 1.0),
    # tools/parity_curves.py:77 (the JAX engine decodes 15 of 15 there).
    (SW.SweepPoint("OFDM_COX", 17.0, 0.0, "awgn", rate=CodeRate.R1_2,
                   frames=3), 1.0),
]
PARALLEL_FRAMES = CHIRP_BATCH


def sweep_batch(point) -> int:
    """The batch the earlier phases run the row's waveform at: the chirp
    cell's for MC-DPSK and OFDM_CHIRP, phase_dpsk's per DPSK preset."""
    if point.waveform == "DPSK":
        return {p: B for p, _, B in DPSK_CASES}[point.preset]
    return CHIRP_BATCH


def sweep_label(point) -> str:
    preset = f" {point.preset}" if point.preset else ""
    return (f"sweep {point.waveform}{preset} {point.snr_db} dB "
            f"{point.cfo_hz} Hz {point.channel} B={point.frames}")


def sweep_missed_row(point, min_rate: float, dev: torch.device) -> None:
    """A row under its minimum rate, rebuilt with numpy-seeded noise (the
    same normals on every device, so a CPU test can hand them to JAX):
    gated on its rate, or else on the CPU port missing the same lanes."""
    label = sweep_label(point) + " (numpy noise)"
    build, lanes_of = SW.BUILD[point.waveform], SW.LANES[point.waveform]
    batch = build(point, seed=SWEEP_SEED, device=dev)
    card = lanes_of(point, SW._apply_channel(
        point, batch.tx, np.random.default_rng(SWEEP_NP_SEED)), batch)
    res = SW.score(point, card)
    missed = torch.nonzero(~card.decoded).flatten().cpu()
    print(f"{label}: decode {res.decode_rate!r} (min {min_rate}), "
          f"detected {res.detected_rate!r}; missed lanes {missed.tolist()}",
          flush=True)
    if res.decode_rate >= min_rate:
        return
    cpu_batch = build(point, seed=SWEEP_SEED, device=torch.device("cpu"))
    rx = SW._apply_channel(point, cpu_batch.tx,
                           np.random.default_rng(SWEEP_NP_SEED))[missed]
    cpu = lanes_of(point, rx, SW.Batch(*(t[missed] for t in cpu_batch)))
    same = bool(torch.equal(cpu.decoded, card.decoded[missed].cpu())
                and torch.equal(cpu.found, card.found[missed].cpu()))
    print(f"{label}: the missed lanes on the CPU port: identical={same}",
          flush=True)
    require(same, f"{label}: the card's missed lanes differ from the CPU")


def sweep_row(point, min_rate: float, dev: torch.device, card: str) -> None:
    """One regression row at its batch: gate, time (host clock, best of 2
    after the gated run), idle share (profiled) and LDPC launches."""
    label = sweep_label(point)

    def run():
        return SW.run_point(point, SWEEP_SEED, device=dev)

    res, launches = launches_of(run)
    ms = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms = min(ms, (time.perf_counter() - t0) * 1e3)
    busy = profile_busy_ms(run, 1, rows=0)
    ok = res.decode_rate >= min_rate
    print(f"{label}: decode {res.decode_rate!r} (min {min_rate}) "
          f"{'PASS' if ok else 'MISS'}, detected {res.detected_rate!r}, "
          f"BER {res.ber!r}, CFO error {res.cfo_err_hz!r} Hz; {ms!r} ms a "
          f"point ({point.frames / ms * 1e3!r} frames/s: TX, channel, "
          f"receive and the host read), device busy {busy!r} ms: idle share "
          f"{1.0 - busy / ms!r}; LDPC launches {launches['ldpc_minsum']} on "
          f"{card}", flush=True)
    require_launched(label, launches, ("ldpc_minsum",))
    if not ok:
        sweep_missed_row(point, min_rate, dev)


def sweep_stream_row(point, min_rate: float, dev: torch.device,
                     card: str) -> None:
    """One single-stream row through the card's ModemEngine; a miss is
    gated on the CPU engine delivering the same payloads from the same
    noisy stream."""
    label = f"sweep stream {point.waveform} {point.snr_db} dB {point.channel}"
    t0 = time.perf_counter()
    res, launches = launches_of(
        lambda: SW.run_point_stream(point, SWEEP_SEED, device=dev))
    wall = time.perf_counter() - t0
    stream = SW.stream_tx(point, dev)
    audio_s = len(stream) / 48000.0
    print(f"{label}: {point.frames} frames, decode {res.decode_rate!r} (min "
          f"{min_rate}), detected {res.detected_rate!r}, CFO error "
          f"{res.cfo_err_hz!r} Hz; {wall!r} s wall for {audio_s!r} s of audio "
          f"(real-time factor {audio_s / wall!r}) on {card}", flush=True)
    require_launched(label, launches, ("ldpc_minsum",)
                     + (("sc_windows",) if point.waveform == "OFDM_COX"
                        else ()))
    if res.decode_rate >= min_rate:
        return
    g = torch.Generator(device=dev).manual_seed(SWEEP_SEED)
    noisy = SW._apply_channel(point, torch.from_numpy(stream).to(dev)[None],
                              g)[0].cpu().numpy()
    _, on_card = SW.receive_stream(point, noisy, dev)
    _, on_cpu = SW.receive_stream(point, noisy, torch.device("cpu"))
    print(f"{label}: delivered on the card {sorted(on_card)}, on the CPU "
          f"{sorted(on_cpu)}", flush=True)
    require(on_card == on_cpu, f"{label}: the card's frames differ from "
            "the CPU engine's")


def phase_sweep(dev: torch.device, card: str) -> None:
    """Every REGRESSION_MATRIX row through run_point on the card at the
    earlier phases' batches, then the two stream rows."""
    t0 = time.perf_counter()
    for point, min_rate in SW.REGRESSION_MATRIX:
        point = dataclasses.replace(point, frames=sweep_batch(point))
        sweep_row(point, min_rate, dev, card)
    print(f"phase_sweep, matrix: {time.perf_counter() - t0!r} s", flush=True)
    for point, min_rate in STREAM_ROWS:
        sweep_stream_row(point, min_rate, dev, card)
    print(f"phase_sweep: {time.perf_counter() - t0!r} s", flush=True)


def parallel_rank(mesh, B: int):
    """One rank of the acquisition sweep (spawned by PM.run_ranks):
    (counts, backend, this rank's LDPC launches)."""
    counts = dcn.acq_sweep_counts(B, CHIRP_SNR_DB, mesh=mesh)
    return counts, mesh.backend, cuda_ldpc.launches


def phase_parallel(dev: torch.device, card: str) -> None:
    """The acquisition sweep at world 1 over NCCL in this process, then at
    world 2 over gloo in two processes sharing the card (NCCL refuses two
    ranks on one GPU): identical counts, every frame decoded; then the
    two-rank dry run on the card."""
    t0 = time.perf_counter()
    B = PARALLEL_FRAMES
    with PM.frame_mesh(device=dev) as mesh:
        require(mesh.backend == "nccl", f"world 1 on the card runs "
                f"{mesh.backend}, not nccl")
        t1 = time.perf_counter()
        ref, launches = launches_of(
            lambda: dcn.acq_sweep_counts(B, CHIRP_SNR_DB, mesh=mesh))
        sweep_s = time.perf_counter() - t1
        ar_ms = PM.all_sum_ms(mesh)
    print(f"parallel world 1 (nccl): {ref} in {sweep_s!r} s (inputs built on "
          f"the host included); all-reduce of the counts {ar_ms!r} ms "
          f"(median of 20, host read included) on {card}", flush=True)
    require(ref == {"decoded": B, "found": B, "bit_errors": 0},
            f"parallel world 1: {ref}, not {B} frames decoded exactly")
    require_launched("parallel world 1", launches, ("ldpc_minsum",))

    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks = PM.run_ranks(parallel_rank, 2, dev, B)
    print(f"parallel world 2: {ranks} in {time.perf_counter() - t1!r} s "
          f"(two spawned processes, start-up included)", flush=True)
    for counts, backend, ldpc_launches in ranks:
        require(backend == "gloo", f"world 2 on one card runs {backend}")
        require(counts == ref, f"parallel world 2: {counts} != world 1 {ref}")
        require(ldpc_launches > 0, "a world-2 rank launched no LDPC kernel")

    t1 = time.perf_counter()
    reports = dryrun.dryrun_multichip(2, dev)
    for r in reports:
        print(f"dryrun_multichip rank {r['rank']} of {r['world']} "
              f"({r['backend']}, {r['device']}): failures {r['failures']}, "
              f"all-reduce {r['allreduce_ms']!r} ms (median of 20, host read "
              f"included), kernel launches {r['launches']} on {card}",
              flush=True)
        require(r["backend"] == "gloo" and not any(r["failures"].values()),
                f"dryrun_multichip rank {r['rank']}: {r}")
        require(r["launches"]["ldpc_minsum"] > 0
                and r["launches"]["sc_windows"] > 0,
                f"dryrun_multichip rank {r['rank']} skipped a kernel")
    print(f"dryrun_multichip(2): {time.perf_counter() - t1!r} s; "
          f"phase_parallel: {time.perf_counter() - t0!r} s", flush=True)


# ---------------------------------------------------------------------------
# Slice 9: the bf16 fast modes and the tools
# ---------------------------------------------------------------------------

BF16_GATE_SEED = 9          # tests/test_ldpc.py:131
BF16_TRAP = (CodeRate.R1_4, 1.1)   # the trap-escape batch: R1/4 waterfall


def bf16_rate_gates(dev: torch.device) -> None:
    """tests/test_ldpc.py:124-162's two points on the card: at sigma 0.5
    bf16 decodes within 0.02 of float32, bits equal where both decode; at
    sigma 0.72 the rates are within 0.04."""
    code = get_code(RATE)
    rng = np.random.default_rng(BF16_GATE_SEED)
    info = torch.from_numpy(
        rng.integers(0, 2, (256, code.k)).astype(np.float32)).to(dev)
    cw = ldpc_ops.encode(code, info).cpu().numpy()
    for sigma, gate in ((0.5, 0.02), (0.72, 0.04)):
        noise = rng.normal(0, sigma, cw.shape)
        llrs = torch.from_numpy((2.0 / sigma ** 2) * ((1.0 - 2.0 * cw) + noise)) \
            .to(torch.float32).to(dev)
        out32, ok32, _ = ldpc_ops.decode(code, llrs, msg_dtype=torch.float32)
        out16, ok16, _ = ldpc_ops.decode(code, llrs, msg_dtype=BF16)
        r32, r16 = float(ok32.float().mean()), float(ok16.float().mean())
        both = ok32 & ok16
        same = bool(torch.equal(out16[both], out32[both]))
        print(f"bf16 rate gate sigma={sigma} B=256: ok rate f32 {r32!r}, "
              f"bf16 {r16!r}, bits equal where both decode {same}",
              flush=True)
        if sigma == 0.5:
            require(r32 >= 0.97 and r16 >= r32 - gate and same,
                    f"bf16 rate gate at sigma {sigma}")
        else:
            require(abs(r32 - r16) <= gate, f"bf16 rate gate at sigma {sigma}")


def extreme_llrs(B: int) -> np.ndarray:
    """R1/2 sigma 0.62 waterfall LLRs of B lanes with their magnitudes
    replaced, signs kept: a quarter near 3e38 (bf16 c2v near 2.25e38,
    totals that overflow to +-inf), a quarter near 1e-40 (bf16 subnormals,
    the smallest rounding to +-0), a quarter mixing both with the noisy
    LLRs element by element, a quarter as drawn."""
    llr = waterfall_llrs(RATE, 0.62, B)
    rng = np.random.default_rng(77)
    sign = np.where(llr < 0, -1.0, 1.0)
    huge = sign * rng.uniform(2.9e38, 3.0e38, llr.shape)
    tiny = sign * rng.uniform(0.0, 2e-40, llr.shape)
    pick = rng.integers(0, 3, llr.shape)
    mixed = np.where(pick == 1, huge, np.where(pick == 2, tiny, llr))
    q = B // 4
    return np.concatenate([huge[:q], tiny[q:2 * q], mixed[2 * q:3 * q],
                           llr[3 * q:]]).astype(np.float32)


NAN_BITS = np.array([0x7FC00000, 0xFFC00000, 0xFFFFFFFF, 0x7F800001],
                    np.uint32)  # quiet NaNs, all ones, a low-payload one


def nonfinite_llrs(rate: CodeRate, sigma: float, B: int, kind: str,
                   seed: int = 99) -> np.ndarray:
    """``waterfall_llrs(rate, sigma, B)`` with 1-3 LLRs of every even lane
    set to +-inf (``kind`` "inf"; +inf and -inf meeting in a total make a
    NaN) or to NaN of the ``NAN_BITS`` patterns (``kind`` "nan"), as
    tests/test_torch_cuda.py::nonfinite_llrs builds them."""
    x = waterfall_llrs(rate, sigma, B)
    rng = np.random.default_rng(seed)
    for b in range(0, B, 2):
        k = int(rng.integers(1, 4))
        pos = rng.choice(x.shape[1], k, replace=False)
        if kind == "inf":
            x[b, pos] = np.where(rng.integers(0, 2, k) == 1, np.inf, -np.inf)
        else:
            x[b, pos] = NAN_BITS[rng.integers(0, len(NAN_BITS), k)] \
                .view(np.float32)
    return x


def bf16_vs_f32_shape(label: str, llrs: torch.Tensor, card: str,
                      reps: int):
    """The two instantiations' call ms at one shape (CUDA events around
    back-to-back calls, in turns f32, bf16, bf16, f32), and the bf16 one's
    device ms against its bound; returns (bf16 device ms, bound ms,
    basis)."""
    graph = ldpc_ops.graph_for(get_code(RATE), llrs.device)
    ms = {}
    for dtype in (torch.float32, BF16, BF16, torch.float32):
        ms.setdefault(dtype, []).append(time_ms(
            lambda: cuda_ldpc.decode_cuda(graph, llrs, msg_dtype=dtype), reps))
    f32_ms, b16_ms = (sum(ms[d]) / 2 for d in (torch.float32, BF16))
    print(f"kernel bf16 vs f32 messages [{label}, B={llrs.shape[0]}]: "
          f"{b16_ms!r} vs {f32_ms!r} ms a call (CUDA events, turns f32 "
          f"{ms[torch.float32]!r}, bf16 {ms[BF16]!r}), ratio "
          f"{b16_ms / f32_ms!r} on {card}", flush=True)
    _, bound_ms, by = time_ldpc_shape(label, RATE, llrs, card, reps,
                                      msg_dtype=BF16)
    return b16_ms, bound_ms, by


def bf16_main_path(dev: torch.device) -> int:
    """The presynced main path (B = 16,384, 17 dB) with bf16 LDPC messages
    as the module default: the bench's gate, every decode through the bf16
    kernel; returns its launches."""
    code = get_code(RATE)
    g_info = torch.Generator(device=dev).manual_seed(0)
    info = torch.randint(0, 2, (BATCH, code.k), generator=g_info, device=dev,
                         dtype=torch.uint8)

    def run():
        tx = P.tx_frame(CFG, MOD, RATE, info)
        rx_in = W.add_noise_active(
            tx, SNR_DB, torch.Generator(device=dev).manual_seed(1))
        return P.rx_frame(CFG, MOD, RATE, rx_in)

    with ldpc_ops.default_msg_dtype(BF16):
        (out, ok, _), launches = launches_of(run)
    require_launched("bf16 main path", launches, ("ldpc_minsum_bf16",))
    require(launches["ldpc_minsum"] == 0,
            "the bf16 main path launched the float32 kernel")
    gate_decode(f"bf16 main path B={BATCH} {SNR_DB} dB", out, ok, info)
    return launches["ldpc_minsum_bf16"]


def bf16_chirp_cell(dev: torch.device, card: str) -> None:
    """The chirp cell (level10, R1/4, 5 dB, 32 buffers of 256) with both bf16
    modes on: the bench's gate, detection against the CPU's bf16 mode on 64
    lanes, and frames/s and device busy beside the float32 path's on the
    same buffers, in turns f32, bf16, bf16, f32."""
    info, tx = chirp_tx(dev, 36)
    rx_all = noisy_buffers(tx, torch.Generator(device=dev).manual_seed(37),
                           CHIRP_BUFFERS, CHIRP_SNR_DB)
    modes = {"f32": (False, torch.float32), "bf16": (True, BF16)}

    def decode_all(mode):
        chirp_bf16, msg = modes[mode]
        with CH.bf16_mode(chirp_bf16), ldpc_ops.default_msg_dtype(msg):
            return [decode_chirp(rx) for rx in rx_all]

    outs, launches = launches_of(lambda: decode_all("bf16"))
    require_launched("bf16 chirp cell", launches, ("ldpc_minsum_bf16",))
    require(launches["ldpc_minsum"] == 0,
            "the bf16 chirp cell launched the float32 kernel")
    check_chirp(outs, info, f"bf16 modes, {CHIRP_SNR_DB} dB")

    with CH.bf16_mode():
        det = CH.detect_dual_chirp(CC, rx_all[0][:CPU_LANES],
                                   MC.chirp_threshold)
        ref = CH.detect_dual_chirp(CC, rx_all[0][:CPU_LANES].cpu(),
                                   MC.chirp_threshold)
    equal = {k: bool(torch.equal(det[k].cpu(), ref[k])) for k in DET_KEYS}
    cfo_diff = float((det["cfo_hz"].cpu() - ref["cfo_hz"]).abs().max())
    print(f"bf16 chirp detection card vs CPU B={CPU_LANES}: equal={equal} "
          f"max_cfo_diff_hz={cfo_diff!r}", flush=True)
    require(all(equal.values()) and cfo_diff <= 1e-3,
            "bf16 chirp detection on the card differs from the CPU")

    ms = {}
    for mode in ("f32", "bf16", "bf16", "f32"):
        decode_all(mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        oks = torch.stack([out[1] for out in decode_all(mode)]).cpu()
        ms.setdefault(mode, []).append(
            (time.perf_counter() - t0) / CHIRP_BUFFERS * 1e3)
        require(float(oks.float().mean()) >= DECODE_GATE,
                f"timed chirp cell ({mode}) ok rate")
    for mode, (chirp_bf16, msg) in modes.items():
        best = min(ms[mode])
        with CH.bf16_mode(chirp_bf16), ldpc_ops.default_msg_dtype(msg):
            busy = profile_busy_ms(lambda: decode_chirp(rx_all[0]), 5,
                                   rows=0)
        print(f"chirp cell {mode}: {CHIRP_BATCH / best * 1e3!r} frames/s "
              f"(best {best!r} ms per buffer of {CHIRP_BATCH}, turns "
              f"{ms[mode]!r}), device busy {busy!r} ms per buffer: idle "
              f"share {1.0 - busy / best!r} on {card}", flush=True)


def phase_bf16(dev: torch.device, card: str, deint: torch.Tensor):
    """The bf16 fast modes: the bf16 kernel lane-exact against the plain
    bf16 decoder (the main path's 17 dB LLRs, the sigma 0.62 waterfall at
    B = 16,384, an R1/4 trap-escape batch), its time beside the float32
    kernel's and its bound, test_ldpc.py's rate gates, the main
    path and the chirp cell with the modes on.  Returns the kernels line's
    row values (launches, max abs error, ms, plain ms, bound ms, basis)."""
    t0 = time.perf_counter()
    graph = ldpc_ops.graph_for(get_code(RATE), dev)
    err = compare_decoders(RATE, deint, "main path 17 dB LLRs",
                           msg_dtype=BF16)
    wf = torch.from_numpy(waterfall_llrs(RATE, 0.62, BATCH)).to(dev)
    compare_decoders(RATE, wf, "waterfall R1_2 sigma=0.62", msg_dtype=BF16)
    rate, sigma = BF16_TRAP
    trap = torch.from_numpy(waterfall_llrs(rate, sigma, WATERFALL_BATCH)) \
        .to(dev)
    compare_decoders(rate, trap, f"waterfall {GOLDEN_NAMES[rate]} "
                     f"sigma={sigma}", trap_escape=True, msg_dtype=BF16)
    compare_decoders(RATE, torch.from_numpy(extreme_llrs(
        WATERFALL_BATCH)).to(dev), "LLRs near +-3e38 and +-1e-40",
        msg_dtype=BF16)
    compare_nonfinite(dev, BF16)
    print(f"LDPC shared bytes per block (R1/2): bf16 "
          f"{cuda_ldpc.shared_bytes(graph, BF16)}, float32 "
          f"{cuda_ldpc.shared_bytes(graph, torch.float32)}", flush=True)

    k_ms, p_ms = time_decoders(graph, deint, kernel_reps=20, plain_reps=5,
                               msg_dtype=BF16)
    print(f"bf16 decode at 17 dB LLRs B={deint.shape[0]}: kernel {k_ms!r} "
          f"ms, plain {p_ms!r} ms (calls, CUDA events) on {card}", flush=True)
    _, bound_ms, by = bf16_vs_f32_shape("R1/2 17 dB main path", deint, card,
                                        reps=20)
    bf16_vs_f32_shape("R1/2 waterfall sigma=0.62", wf, card, reps=5)
    time_ldpc_shape(f"{GOLDEN_NAMES[rate]} waterfall sigma={sigma}", rate,
                    trap, card, reps=5, trap_escape=True, msg_dtype=BF16)
    for label, g, llrs, trap_escape in (
            ("R1_2 waterfall sigma=0.62", graph, wf, False),
            (f"{GOLDEN_NAMES[rate]} waterfall sigma={sigma}, trap_escape",
             ldpc_ops.graph_for(get_code(rate), dev), trap, True)):
        k_w, p_w = time_decoders(g, llrs, kernel_reps=5, plain_reps=2,
                                 trap_escape=trap_escape, msg_dtype=BF16)
        print(f"bf16 decode at {label} B={llrs.shape[0]}: kernel {k_w!r} "
              f"ms, plain {p_w!r} ms (calls, CUDA events) on {card}",
              flush=True)

    bf16_rate_gates(dev)
    launches = bf16_main_path(dev)
    bf16_chirp_cell(dev, card)
    require(ldpc_ops._DEFAULT_MSG_DTYPE == torch.float32 and not CH._BF16,
            "phase_bf16 left a bf16 mode on")
    print(f"phase_bf16: {time.perf_counter() - t0!r} s", flush=True)
    return launches, err, k_ms, p_ms, bound_ms, by


TOOLS_DIR = ROOT / "tools"
BER_FRAMES = 256
BER_FER_GAP = 0.04          # tools/ber_curves.py --bf16's overlay


def run_tool(name: str, argv: list) -> tuple[dict, dict]:
    """tools/<name>.py's main(argv) in this process, its output printed;
    requires exit 0 and returns (the JSON object of its last line, the
    kernel launches during the run)."""
    spec = importlib.util.spec_from_file_location(name, TOOLS_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc, launches = launches_of(lambda: mod.main(argv))
    wall = time.perf_counter() - t0
    out = buf.getvalue().strip()
    print(f"--- tools/{name}.py {' '.join(argv)}: exit {rc}, {wall!r} s, "
          f"kernel launches {launches}\n{out}", flush=True)
    require(rc == 0, f"tools/{name}.py {argv} exited {rc}")
    return json.loads(out.splitlines()[-1]), launches


def phase_tools(dev: torch.device, card: str) -> None:
    """Each tool twin's main on the card at a small size: exit 0 and its
    result printed; the ber_curves f32 and bf16 overlays within 0.04 FER
    at every point, the bf16 run through the bf16 kernel only."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        curves = {}
        for mode in ("f32", "bf16"):
            argv = ["--frames", str(BER_FRAMES), "--json",
                    str(Path(tmp) / f"ber_{mode}.json")]
            curves[mode], launches = run_tool(
                "torch_ber_curves", argv + (["--bf16"] if mode == "bf16"
                                            else []))
            want = "ldpc_minsum_bf16" if mode == "bf16" else "ldpc_minsum"
            other = "ldpc_minsum" if mode == "bf16" else "ldpc_minsum_bf16"
            require(launches[want] > 0 and launches[other] == 0,
                    f"ber_curves {mode} ran the wrong LDPC kernel")
    gap = max(abs(a - b) for r32, r16 in zip(curves["f32"]["rows"],
                                             curves["bf16"]["rows"])
              for a, b in zip(r32["fer"], r16["fer"]))
    for mode, c in curves.items():
        print(f"ber_curves {mode}: {c['total_pipelines'] / c['wall_seconds']!r}"
              f" pipelines/s ({c['total_pipelines']} in {c['wall_seconds']!r}"
              f" s, set-up included) on {card}", flush=True)
    print(f"ber_curves bf16 vs f32: largest FER gap {gap!r} (limit "
          f"{BER_FER_GAP})", flush=True)
    require(gap <= BER_FER_GAP, f"ber_curves bf16 overlay: FER gap {gap}")

    res, _ = run_tool("torch_test_hf_reality", ["--quick"])
    require(all(res["gates"].values()), f"test_hf_reality gates {res}")
    res, _ = run_tool("torch_cli_simulator", [])
    require(res["ok"], "cli_simulator session failed")
    res, _ = run_tool("torch_threaded_simulator", ["--timeout", "240"])
    require(res["ok"], "threaded_simulator session failed")
    for extra in ([], ["--stream"]):
        res, _ = run_tool("torch_test_iwaveform", ["--frames", "5", *extra])
        require(res["decode_rate"] == 1.0,
                f"test_iwaveform {extra}: decode {res['decode_rate']}")
    for extra in ([], ["--bf16"]):
        res, _ = run_tool("torch_profile_acquisition",
                          ["--seconds", "2", *extra])
        require(res["found"] == 1.0, f"profile_acquisition {extra}: {res}")
    measurement_tools(card)
    print(f"phase_tools: {time.perf_counter() - t0!r} s", flush=True)


# tools/test_throughput.py --cpu (8 codewords, the JAX package's noise):
# every row decodes 1.0 but the Good-channel row, 47 of 64 codewords.
JAX_THROUGHPUT = {11: 47 / 64}
THROUGHPUT_FRAME = 8 / 64   # one frame's worth of the Good row's codewords
# (tool, argv, runs a Schmidl-Cox search): each tool's size on the card;
# the first FRAME_LEVEL_TOOLS decode whole batches of frames.
FRAME_LEVEL_TOOLS = 5
MEASUREMENT_TOOLS = [
    ("torch_test_throughput", [], True),
    ("torch_test_mode_snr", [], False),
    ("torch_test_dpsk_snr", [], False),
    ("torch_test_otfs_vs_ofdm", [], False),
    ("torch_test_sync_robustness", [], True),
    # Three rows at one frame and three of the seven skews (+100 ppm
    # fires the clock-skew retry), cut for the script's time limit.
    ("torch_test_sro", ["--quick", "--frames", "1", "--ppm", "0,100,-100"],
     True),
    # Three frames (the tool's default): at one frame the JAX tool too
    # misses the Cox row's -0.1 Hz/s cell, so its gate fails at that size.
    ("torch_test_cfo_ramp", ["--rows", "cox_dqpsk,mc_dpsk"], True),
    ("torch_test_interferer_onset", ["--sir", "5"], True),
    ("torch_test_session_throughput", ["--rows", "512_26"], True),
    ("torch_test_calibrated_negotiation", ["--points", "4,9,10"], True),
    # The three OFDM_COX DQPSK rows of the table's eleven, one trial.
    ("torch_calibrate_mode_table", ["--trials", "1", "--only",
                                    "OFDM_COX DQPSK"], True),
    ("torch_calibrate_snr", ["--trials", "1"], True),
]


def throughput_gate(rows: list) -> None:
    """Each row against JAX's table: 1.0 where JAX decodes 1.0, else JAX's
    rate less one frame's worth of codewords."""
    for r in rows:
        want = JAX_THROUGHPUT.get(r["index"], 1.0)
        floor = want if want == 1.0 else want - THROUGHPUT_FRAME
        require(r["decode"] >= floor,
                f"test_throughput {r['label']}: decode {r['decode']} < "
                f"{floor} (JAX {want})")


class KernelCalls:
    """The arguments of every kernel launch made through the two wrappers
    (``cuda_ldpc.decode_cuda``, ``cuda_sc.sc_windows_cuda``) while
    ``recording`` is active, by name: ``ldpc`` and ``sc``."""

    def __init__(self):
        self.ldpc: list = []
        self.sc: list = []

    @contextlib.contextmanager
    def recording(self):
        def recorder(calls, fn):
            sig = inspect.signature(fn)

            def call(*args, **kw):
                calls.append(sig.bind(*args, **kw).arguments)
                return fn(*args, **kw)
            return call

        with mock.patch.object(cuda_ldpc, "decode_cuda",
                               recorder(self.ldpc, cuda_ldpc.decode_cuda)), \
                mock.patch.object(cuda_sc, "sc_windows_cuda",
                                  recorder(self.sc, cuda_sc.sc_windows_cuda)):
            yield self


def extreme_batches(calls: list, tensor: str) -> list:
    """The calls with the smallest and the largest batch (first of each);
    none without calls."""
    by_b = {}
    for c in calls:
        by_b.setdefault(c[tensor].shape[0], c)
    return [by_b[b] for b in sorted({min(by_b), max(by_b)})] if by_b else []


def time_recorded_shapes(tool: str, calls: KernelCalls, card: str) -> None:
    """Both kernels on the arguments a tool's run gave them, at its
    smallest and largest batch: device ms against the bound, as
    ``report_shape`` prints them, and the plain version's call ms."""
    for c in extreme_batches(calls.ldpc, "llrs"):
        graph, llrs = c["graph"], c["llrs"]
        trap = bool(c.get("trap_escape", False))
        kw = {"max_iters": c.get("max_iters", DEFAULT_MAX_ITERS),
              "trap_escape": trap, "msg_dtype": c.get("msg_dtype")}
        _, ok, _ = cuda_ldpc.decode_cuda(graph, llrs, **kw)
        bound_ms, by, passes = ldpc_bound(graph, ldpc_passes(
            graph, llrs, trap_escape=trap))
        shape = (f"{tool}, n={graph.n} k={graph.k}"
                 f"{', trap_escape' if trap else ''}, B={llrs.shape[0]}, "
                 f"{passes!r} iterations run per lane on average, "
                 f"{float((~ok).float().mean())!r} of the lanes unconverged")
        report_shape("ldpc_minsum", shape, lambda: cuda_ldpc.decode_cuda(
            graph, llrs, **kw), 20, bound_ms, by, card)
        plain = time_ms(lambda: ldpc_ops.decode_plain(graph, llrs, **kw), 3)
        print(f"plain decoder [{shape}]: {plain!r} ms a call on {card}",
              flush=True)
    for c in extreme_batches(calls.sc, "a"):
        args = (c["a"], c["half"], c["stride"], c["offset"], c["G"])
        a, half, stride, _, G = args
        bound_ms, by = sc_bound(a.shape[0], half, stride, G)
        shape = (f"{tool}, B={a.shape[0]}, T={a.shape[-1]}, half={half}, "
                 f"stride={stride}, G={G}")
        report_shape("sc_windows", shape,
                     lambda: cuda_sc.sc_windows_cuda(*args), 20, bound_ms,
                     by, card)
        plain = time_ms(lambda: sc_windows_plain(*args), 3)
        print(f"plain window sums [{shape}]: {plain!r} ms a call on {card}",
              flush=True)


def measurement_tools(card: str) -> None:
    """The measurement tools on the card (``MEASUREMENT_TOOLS``): each
    exits 0, which holds its own gate where it has one (SRO, CFO ramp,
    sync robustness ALL PASS, onset, session RESULT: PASS, negotiation
    PASS); the LDPC kernel launches in every run and the window kernel in
    every run with a Schmidl-Cox search; the throughput rows against
    JAX's table; the clock-skew retry fires on the 512-plan QAM16 row at
    +100 ppm.  The frame-level tools' (the first ``FRAME_LEVEL_TOOLS``)
    kernel launches are recorded and both kernels timed on their
    smallest and largest batches."""
    walls = {}
    for i, (name, argv, cox) in enumerate(MEASUREMENT_TOOLS):
        t0 = time.perf_counter()
        calls = KernelCalls()
        with (calls.recording() if i < FRAME_LEVEL_TOOLS
              else contextlib.nullcontext()):
            res, launches = run_tool(name, argv)
        walls[name] = time.perf_counter() - t0
        require(launches["ldpc_minsum"] > 0, f"{name}: no LDPC launch")
        require(not cox or launches["sc_windows"] > 0,
                f"{name}: no window-kernel launch")
        if name == "torch_test_throughput":
            throughput_gate(res["rows"])
        if name == "torch_test_sro":
            retried = res["rows"]["cox_qam16"]["retried"]["100"]
            print(f"test_sro cox_qam16 +100 ppm: frames_sro_retried "
                  f"{retried}", flush=True)
            require(retried > 0, "test_sro: no clock-skew retry at +100 ppm")
        if i < FRAME_LEVEL_TOOLS:
            print(f"{name}: LDPC batches "
                  f"{sorted(Counter(c['llrs'].shape[0] for c in calls.ldpc).items())}"
                  f", window batches "
                  f"{sorted(Counter(c['a'].shape[0] for c in calls.sc).items())}"
                  " (batch: launches)", flush=True)
            time_recorded_shapes(name, calls, card)
    for name, wall in walls.items():
        print(f"measurement tool {name}: {wall!r} s", flush=True)


PARITY_CUT = [5, 19, 20, 21, 22]  # tools/torch_parity_curves.py POINTS
PARITY_COX_FLOOR = 0.8          # tests/test_parity_curves.py's Cox rows


def phase_frontends(dev: torch.device, card: str) -> None:
    """The front-ends and the parity overlay on the card, each timed:
    ``torch_tui --sim`` (RESULT: PASS, the LDPC kernel launched),
    ``torch_webui --script --port 0`` (PASS, both kernels launched: its
    forced OFDM_COX session searches through the window kernel) and
    ``torch_parity_curves`` on ``PARITY_CUT`` -- the two fading points
    where the reference loses the most frames (MC-DPSK 15 dB poor 30 Hz,
    OFDM_CHIRP 15 dB poor) and the three OFDM_COX points, each over the
    three seeds: ours >= ref at every point (the tool's exit 0) and the
    Cox points at >= 80%.  The overlay's noise is seeded, so a point below
    the reference is replayed by running the tool again on that point
    with ``--streams DIR`` and then ``tests/replay_parity_streams.py DIR``
    (JAX's receiver and the port's on the CPU)."""
    t0 = time.perf_counter()
    runs = {}
    for name, argv in (("torch_tui", ["--sim"]),
                       ("torch_webui", ["--script", "--port", "0"]),
                       ("torch_parity_curves",
                        ["--points", ",".join(map(str, PARITY_CUT))])):
        t1 = time.perf_counter()
        res, launches = run_tool(name, argv)
        runs[name] = (res, launches, time.perf_counter() - t1)
    res, launches, _ = runs["torch_tui"]
    require(res["result"] == "PASS", "tui --sim failed")
    require(launches["ldpc_minsum"] > 0, "tui: no LDPC launch")
    res, launches, _ = runs["torch_webui"]
    require(res["result"] == "PASS", "webui scripted session failed")
    require(launches["ldpc_minsum"] > 0 and launches["sc_windows"] > 0,
            f"webui: kernel launches {launches}")
    res, launches, _ = runs["torch_parity_curves"]
    require(res["all_points_at_or_above_reference"], "parity: below ref")
    require(launches["ldpc_minsum"] > 0 and launches["sc_windows"] > 0,
            f"parity: kernel launches {launches}")
    for p in res["points"]:
        print(f"parity {p['waveform']} {p['channel']} {p['snr_db']} dB "
              f"{p['cfo_hz']} Hz {p['rate']}: ours {p['our_decoded']}/"
              f"{p['our_total']}, ref {p['ref_decoded']}/{p['ref_total']}, "
              f"{p['wall_seconds']!r} s on {card}", flush=True)
        require(p["waveform"] != "OFDM_COX" or p["our_decoded"]
                >= PARITY_COX_FLOOR * p["our_total"],
                f"parity: Cox point below 80%: {p}")
    for name, (_, launches, wall) in runs.items():
        print(f"front-end {name}: {wall!r} s, kernel launches {launches}",
              flush=True)
    print(f"phase_frontends: {time.perf_counter() - t0!r} s", flush=True)


# ---------------------------------------------------------------------------
# Slice 12: the port's bench
# ---------------------------------------------------------------------------

BENCH_TIMEOUT_S = 600
# The keys of bench.py's line when every gate passes (BENCH_r05.json).
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "acq_metric",
              "acq_value", "acq_unit", "acq_decode_ok_rate", "cox_metric",
              "cox_value", "cox_unit", "cox_decode_ok_rate"}


def run_bench() -> dict:
    """``python3 bench_torch.py`` as a fresh process with the fast modes
    at bench.py's default (neither switch set), its output printed;
    requires exit 0 and returns its last line."""
    env = {k: v for k, v in os.environ.items()
           if k not in BT.FAST_MODES}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "bench_torch.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    print(f"--- python3 bench_torch.py: exit {proc.returncode}, "
          f"{time.perf_counter() - t0!r} s\n{proc.stdout.strip()}",
          flush=True)
    require(proc.returncode == 0,
            f"bench_torch.py exited {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def bench_bf16_shape(label: str, rate: CodeRate, llrs: torch.Tensor,
                     card: str) -> None:
    """The bf16 kernel on a bench workload's own LLRs: lane-exact against
    the plain bf16 decoder, both timed (calls), and its device time beside
    its bound."""
    compare_decoders(rate, llrs, f"{label} LLRs", msg_dtype=BF16)
    graph = ldpc_ops.graph_for(get_code(rate), llrs.device)
    k_ms, p_ms = time_decoders(graph, llrs, kernel_reps=20, plain_reps=3,
                               msg_dtype=BF16)
    print(f"bf16 decode at {label} B={llrs.shape[0]}: kernel {k_ms!r} ms, "
          f"plain {p_ms!r} ms (calls, CUDA events) on {card}", flush=True)
    time_ldpc_shape(label, rate, llrs, card, msg_dtype=BF16)


def phase_bench(dev: torch.device, card: str) -> None:
    """``bench_torch.py`` (bench.py's twin) as the next benchmark runs it:
    bench.py's keys, three values > 0, both acquisition ok rates >= 0.99
    and no main-path failure.  Then one step of each of its workloads at
    full size in this process, with its fast modes: the bf16 LDPC kernel
    launched in all three (the float32 one in none), the window kernel in
    the Schmidl-Cox step, the bench's gate on each; and the bf16 kernel at
    the chirp and Schmidl-Cox steps' shapes."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    res = run_bench()
    require(set(res) == BENCH_KEYS, f"bench_torch.py keys {sorted(res)}")
    require(res["unit"] == "pipelines/s/gpu"
            and res["acq_unit"] == res["cox_unit"] == "frames/s/gpu",
            f"bench_torch.py units {res}")
    require(min(res["value"], res["acq_value"], res["cox_value"]) > 0,
            f"bench_torch.py zeroed a metric: {res}")
    require(min(res["acq_decode_ok_rate"], res["cox_decode_ok_rate"])
            >= DECODE_GATE, f"bench_torch.py ok rates: {res}")
    for key, rate, ok in (("value", "pipelines/s", "main path gate passed"),
                          ("acq_value", "frames/s",
                           f"ok rate {res['acq_decode_ok_rate']!r}"),
                          ("cox_value", "frames/s",
                           f"ok rate {res['cox_decode_ok_rate']!r}")):
        print(f"bench_torch {res[key.replace('value', 'metric')]}: "
              f"{res[key]!r} {rate}, {ok} on {card}", flush=True)

    sizes = BT.FULL
    info = torch.from_numpy(BT.main_info(sizes.batch)).to(dev)
    acq_info = torch.from_numpy(BT.chirp_info(sizes.acq_batch)).to(dev)
    acq_rx = W.add_noise_active(BT.chirp_tx(acq_info), BT.ACQ_SNR_DB,
                                BT.generator(dev, 3))
    cox_info = torch.from_numpy(BT.cox_info(sizes.cox_batch)).to(dev)
    cox_rx = W.add_noise_active(BT.cox_tx(cox_info), BT.COX_SNR_DB,
                                BT.generator(dev, 13))
    # (label, step, info, kernels it must launch, bits checked on every
    # lane: the main path's warm-up gate; an acquisition's on its ok lanes)
    steps = (("main path", lambda: BT.main_step(info, BT.generator(dev, 0)),
              info, ("ldpc_minsum_bf16",), True),
             ("chirp", lambda: BT.chirp_step(acq_rx), acq_info,
              ("ldpc_minsum_bf16",), False),
             ("Schmidl-Cox", lambda: BT.cox_step(cox_rx), cox_info,
              ("ldpc_minsum_bf16", "sc_windows"), False))
    with BT.switched(BT.fast_modes({})):
        for label, step, truth, kernels, every_lane in steps:
            (out, ok), launches = launches_of(step)
            label = f"bench_torch {label} step, fast modes on"
            require_launched(label, launches, kernels)
            require(launches["ldpc_minsum"] == 0,
                    f"{label} launched the float32 LDPC kernel")
            truth = truth.to(torch.uint8)
            gate_decode(label, out, ok, truth)
            require(not every_lane or bool((out == truth).all()),
                    f"{label}: a lane's bits differ")
        bench_bf16_shape("R1/4 5 dB chirp bench buffer", CHIRP_RATE,
                         chirp_llrs(acq_rx), card)
        bench_bf16_shape("R1/2 17 dB Schmidl-Cox bench buffer", RATE,
                         cox_llrs(COX_CFG, MOD, RATE, 1, cox_rx), card)
    require(ldpc_ops._DEFAULT_MSG_DTYPE == torch.float32 and not CH._BF16,
            "phase_bench left a fast mode on")
    print(f"phase_bench: {time.perf_counter() - t0!r} s", flush=True)


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
    ldpc_ms, ldpc_plain_ms, ldpc_bound_ms, ldpc_by = phase_timing(dev, card,
                                                                  deint)
    bf16_row = phase_bf16(dev, card, deint)

    _, tx = cox_tx(dev, 10)
    rx = noisy_buffers(tx, torch.Generator(device=dev).manual_seed(20), 1)[0]
    sc_err = phase_window_parity(dev, rx)
    phase_window_nonfinite(dev, rx)
    phase_detection_parity(dev, rx)
    cox_launches = phase_cox_path(dev)
    sc_ms, sc_plain_ms, sc_bound_ms, sc_by = phase_cox_timing(dev, card)

    _, tx = chirp_tx(dev, 30)
    phase_chirp_detection(noisy_buffers(
        tx, torch.Generator(device=dev).manual_seed(35), 1, CHIRP_SNR_DB)[0])
    rx = phase_chirp_path(dev)
    phase_chirp_timing(dev, card)
    phase_chirp_ldpc(dev, card, rx)
    phase_ofdm_after_chirp(dev)
    phase_fading(dev)

    phase_nvis(dev, card)
    phase_pilot_high_order(dev, card)
    dpsk_row = phase_dpsk(dev, card)
    phase_delayfit(dev, card)
    phase_mfsk(dev, card)
    phase_otfs(dev, card)
    phase_engine(dev, card)
    phase_protocol(dev, card)
    phase_sweep(dev, card)
    phase_parallel(dev, card)
    phase_tools(dev, card)
    phase_frontends(dev, card)
    phase_bench(dev, card)

    require(not any(m == "jax" or m.startswith("jax.")
                    or m == "projectultra_tpu"
                    or m.startswith("projectultra_tpu.") for m in sys.modules),
            "the run imported jax or the JAX package")
    print(f"total: {time.perf_counter() - t0!r} s", flush=True)
    print("kernel shapes (kernel ms, bound ms, basis, share of bound):",
          flush=True)
    for name, shape, ms, bound_ms, by in SHAPES:
        print(f"  {name} [{shape}]: {ms!r} ms, bound {bound_ms!r} ms ({by}), "
              f"share {bound_ms / ms!r}", flush=True)
    print(card, flush=True)
    # launches: each kernel's count in the run of its own slice's path
    # (the LDPC kernel's in the slice-1 path, its bf16 instantiation's in
    # that path with bf16 messages; the counts of the Cox and chirp paths
    # are printed above; the DPSK score kernel's in the DPSK medium path).
    # ms and bound_ms at that path's shape; no single PyTorch call computes
    # any of the four (library_ms null).
    rows = [("ldpc_minsum", ldpc_launches, ldpc_err, ldpc_ms, ldpc_plain_ms,
             ldpc_bound_ms, ldpc_by),
            ("sc_windows", cox_launches["sc_windows"], sc_err, sc_ms,
             sc_plain_ms, sc_bound_ms, sc_by),
            ("ldpc_minsum_bf16", *bf16_row), ("dpsk_score", *dpsk_row)]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source_of(name),
         "replaces": KERNELS[name][1], "launches": launches,
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bound_ms, "bound_by": by, "library_ms": None}
        for name, launches, err, ms, plain_ms, bound_ms, by in rows]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""Wrapper of the hand-written Hopper kernel of chirp acquisition's
decimation (``csrc/chirp_decimate.cu``), the card's form of
``sync/chirp._decimate``: the 128-tap complex band-select FIR at every 8th
sample, y[b, m] = sum_k w[k] x[b, 8m + k - 64] (zero outside [0, T)).  In
the JAX package it is XLA's convolution (projectultra_tpu/sync/chirp.py:
174-200); ``sync/chirp._decimate_plain`` is the plain PyTorch version, the
CPU path and the kernel's oracle.

The kernel reads the samples in place, with their row stride, and takes
the 2 x 128 taps by value from the host (no device read); the bf16 mode
rounds the samples and the taps to bfloat16 before its float32 products.
``launches`` counts the kernel launches made through ``decimate_cuda``.

A block covers ``tile_for`` consecutive outputs of one row, PER_THREAD a
thread; ``launch_plan`` says what a launch at given sizes runs.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_build

SOURCE = cuda_build.CSRC_DIR / "chirp_decimate.cu"
FLAGS: tuple[str, ...] = ()

#: Kernel launches made through decimate_cuda (a run resets it to 0 to show
#: that its path went through the kernel).
launches = 0

#: The kernel's fixed sizes (``kDecim``, ``kTaps``, ``kPerThread``,
#: ``kMaxThreads`` in the source): outputs a thread sums, threads a block at
#: most, so tiles of MIN_TILE (one warp) to MAX_TILE outputs.
DECIM = 8
TAPS = 128
PER_THREAD = 4
WARP = 32
MAX_THREADS = 128
MIN_TILE = WARP * PER_THREAD
MAX_TILE = MAX_THREADS * PER_THREAD
#: Blocks an SM that a small batch's tiles are cut down to give.
FILL = 4


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.chirp_decimate_launch.argtypes = [vp, cll, ci, ci, ci,
                                          ctypes.POINTER(ctypes.c_float), ci,
                                          vp, vp]
    lib.chirp_decimate_launch.restype = ci
    lib.chirp_decimate_plan.argtypes = [ci, ci, ci, ctypes.POINTER(cll)]
    lib.chirp_decimate_plan.restype = ci
    for name in ("taps", "per_thread", "max_threads"):
        getattr(lib, f"chirp_decimate_{name}").argtypes = []
        getattr(lib, f"chirp_decimate_{name}").restype = ci
    if (lib.chirp_decimate_taps(), lib.chirp_decimate_per_thread(),
            lib.chirp_decimate_max_threads()) \
            != (TAPS, PER_THREAD, MAX_THREADS):
        raise RuntimeError("csrc/chirp_decimate.cu and ops/cuda_decimate.py "
                           "disagree on the kernel's sizes")


LIBRARY = cuda_build.KernelLibrary("chirp_decimate", SOURCE, FLAGS, _bind)


def tile_for(B: int, Tb: int, sms: int) -> int:
    """Outputs a block covers for B rows of Tb outputs on a card of ``sms``
    SMs: as few tiles a row as MAX_TILE allows, more (down to MIN_TILE)
    while the grid would give fewer than FILL blocks an SM, and the tiles
    of a row as equal as multiples of PER_THREAD allow."""
    tiles = max(1, -(-Tb // MAX_TILE))
    want = -(-FILL * sms // max(1, B))
    tiles = max(tiles, min(want, -(-Tb // MIN_TILE)))
    per = -(-max(Tb, 1) // tiles)
    return -(-per // PER_THREAD) * PER_THREAD


def launch_plan(B: int, T: int, sms: int) -> dict:
    """What ``decimate_cuda`` launches for B rows of T samples on a card of
    ``sms`` SMs: tile, tiles a row, threads a block, blocks, and dynamic
    shared bytes a block (the source's ``shared_bytes``)."""
    Tb = -(-T // DECIM)
    tile = tile_for(B, Tb, sms)
    threads = -(-(tile // PER_THREAD) // WARP) * WARP
    staged = DECIM * PER_THREAD * threads + TAPS - DECIM
    words = staged + 4 * -(-staged // (DECIM * PER_THREAD))
    tiles = -(-Tb // tile)
    return {"tile": tile, "tiles": tiles, "threads": threads,
            "blocks": B * tiles, "shared_bytes": 4 * words}


def card_plan(B: int, T: int, device: torch.device) -> dict:
    """``launch_plan`` on ``device``, with the blocks an SM holds and the
    blocks, threads and shared bytes as the library computes them."""
    plan = launch_plan(B, T, cuda_build.sm_count(device))
    out = (ctypes.c_longlong * 4)()
    with torch.cuda.device(device):
        LIBRARY.run("chirp_decimate_plan", B, T, plan["tile"], out)
    return plan | {"library": {"blocks": int(out[0]), "threads": int(out[1]),
                               "shared_bytes": int(out[2])},
                   "blocks_per_sm": int(out[3])}


@functools.lru_cache(maxsize=8)
def _taps_arg(raw: bytes):
    return (ctypes.c_float * (2 * TAPS)).from_buffer_copy(raw)


def _check(samples: torch.Tensor, taps: np.ndarray) -> None:
    if taps.shape != (2, TAPS) or taps.dtype != np.float32:
        raise ValueError(f"taps must be [2, {TAPS}] float32, got "
                         f"{taps.shape} {taps.dtype}")
    cuda_build.check_tensor("samples", samples, torch.float32, ("B", "T"),
                            "disjoint rows", None)
    if samples.shape[1] >= 2**31 - 256:
        raise ValueError(f"samples has too many columns: {samples.shape[1]}")


def decimate_cuda(samples: torch.Tensor, taps: np.ndarray,
                  bf16: bool = False) -> torch.Tensor:
    """One kernel launch over [B, T] float32 CUDA samples (unit column
    stride, any row stride) with the host taps [2, 128] float32 (the real
    row, then the imaginary) -> [B, ceil(T/8)] complex64; the bf16 mode
    when ``bf16``.  The counterpart of ``sync/chirp._decimate_plain``."""
    global launches
    _check(samples, taps)
    B, T = samples.shape
    dev = samples.device
    LIBRARY.load()  # built at the first call, an empty one too
    out = torch.empty((B, -(-T // DECIM)), dtype=torch.complex64, device=dev)
    if B == 0 or T == 0:
        return out
    # (a one-row view may carry any row stride)
    ldx = samples.stride(0) if B > 1 else T
    tile = tile_for(B, out.shape[1], cuda_build.sm_count(dev))
    with torch.cuda.device(dev):
        LIBRARY.run(
            "chirp_decimate_launch", samples.data_ptr(), ldx, B, T, tile,
            _taps_arg(np.ascontiguousarray(taps).tobytes()), int(bool(bf16)),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return out

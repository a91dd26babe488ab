"""Wrapper of the hand-written Hopper kernel of DPSK's differential pattern
score (``csrc/dpsk_score.cu``), the card's form of the score inside
``psk/dpsk.py::find_preamble`` (an XLA fusion in the JAX package,
projectultra_tpu/psk/dpsk.py:305-317).

Built (by ``cuda_build``) with ``--fmad=false`` so that the kernel's
products and sums round as separate operations.  The kernel reads the
correlations in place, with their row stride, and takes the 38 expected
signs by value from the host (no device read).  ``launches`` counts the
kernel launches made through ``dpsk_score_cuda``.

A block covers 32 consecutive residues r of one row and up to
``MAX_TILE`` consecutive symbol indices k of the offsets o = r + k*L
(``tile_for``); ``launch_plan`` says what a launch at given sizes runs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build
from .dpsk_score import check_args

SOURCE = cuda_build.CSRC_DIR / "dpsk_score.cu"
FLAGS = ("--fmad=false",)

#: Kernel launches made through dpsk_score_cuda (a run resets it to 0 to
#: show that its path went through the kernel).
launches = 0

#: The kernel's fixed sizes (``kPairs``, ``kMaxTile`` in the source): the
#: differentials an offset sums (a preamble of 39 symbols) and the most
#: symbol indices a block covers; tiles of fewer than MIN_TILE are not
#: made to fill the card.
PAIRS = 38
MAX_TILE = 156
MIN_TILE = 32
LANES = 32


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    cf = ctypes.c_float
    lib.dpsk_score_launch.argtypes = [vp, cll, ci, cll, ci, ci, ci,
                                      ctypes.POINTER(cf), cf, cf, vp, vp]
    lib.dpsk_score_launch.restype = ci
    lib.dpsk_score_plan.argtypes = [ci, cll, ci, ci, ci,
                                    ctypes.POINTER(cll)]
    lib.dpsk_score_plan.restype = ci
    lib.dpsk_score_pairs.argtypes = []
    lib.dpsk_score_pairs.restype = ci
    lib.dpsk_score_max_tile.argtypes = []
    lib.dpsk_score_max_tile.restype = ci
    if (lib.dpsk_score_pairs(), lib.dpsk_score_max_tile()) \
            != (PAIRS, MAX_TILE):
        raise RuntimeError("csrc/dpsk_score.cu and ops/cuda_dpsk.py disagree "
                           "on the kernel's sizes")


LIBRARY = cuda_build.KernelLibrary("dpsk_score", SOURCE, FLAGS, _bind)


def tile_for(B: int, L: int, O: int, sms: int) -> int:
    """Symbol indices k a block covers for B rows of O offsets on a card
    of ``sms`` SMs: as few tiles a row as MAX_TILE allows, more (down to
    MIN_TILE) while the grid would give fewer than two blocks an SM."""
    K = -(-O // L)
    if K == 0:
        return 1
    tiles = -(-K // MAX_TILE)
    groups = -(-L // LANES)
    want = -(-2 * sms // max(1, B * groups))
    tiles = max(tiles, min(want, -(-K // MIN_TILE)))
    return -(-K // tiles)


def _check(corr: torch.Tensor, L: int, n_sym: int, O: int, expected):
    cuda_build.check_tensor("corr", corr, torch.complex64, ("B", "n_corr"),
                            "rows", None)
    signs = check_args(corr, L, n_sym, O, expected)
    if n_sym - 1 != PAIRS:
        raise ValueError(f"the score kernel sums {PAIRS} differentials, got "
                         f"n_sym={n_sym}")
    if corr.shape[0] > 65535:
        raise ValueError(f"corr has too many rows for the kernel's grid: "
                         f"{corr.shape[0]}")
    return signs


def launch_plan(B: int, n_corr: int, L: int, O: int,
                device: torch.device) -> dict:
    """What ``dpsk_score_cuda`` launches at these sizes on ``device``:
    tile, tiles a row, blocks, dynamic shared bytes a block and blocks an
    SM holds."""
    tile = tile_for(B, L, O, cuda_build.sm_count(device))
    out = (ctypes.c_longlong * 4)()
    with torch.cuda.device(device):
        LIBRARY.run("dpsk_score_plan", B, n_corr, L, O, tile, out)
    return {"tile": tile, "tiles": int(out[3]), "blocks": int(out[0]),
            "shared_bytes": int(out[1]), "blocks_per_sm": int(out[2])}


def dpsk_score_cuda(corr: torch.Tensor, L: int, n_sym: int, O: int,
                    expected, min_energy: float) -> torch.Tensor:
    """One kernel launch over a [B, n_corr] complex64 CUDA correlation
    (unit column stride, any row stride) -> score [B, O] float32; the
    counterpart of ``dpsk_score_plain``."""
    global launches
    signs = _check(corr, L, n_sym, O, expected)
    B, n_corr = corr.shape
    # (a one-row view may carry any row stride)
    lda = corr.stride(0) if B > 1 else n_corr
    dev = corr.device
    LIBRARY.load()  # built at the first call, an empty one too
    score = torch.empty((B, O), dtype=torch.float32, device=dev)
    if B == 0 or O == 0:
        return score
    # The plain version compares with the float32 of min_energy * n_sym and
    # divides by n_sym - 1 as a product with its float32 reciprocal.
    threshold = float(np.float32(min_energy * n_sym))
    inv_pairs = float(np.float32(1.0) / np.float32(n_sym - 1))
    host_signs = (ctypes.c_float * PAIRS)(*signs.tolist())
    tile = tile_for(B, L, O, cuda_build.sm_count(dev))
    with torch.cuda.device(dev):
        LIBRARY.run("dpsk_score_launch", corr.data_ptr(), lda, B, n_corr, L,
                    O, tile, host_signs, threshold, inv_pairs,
                    score.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return score

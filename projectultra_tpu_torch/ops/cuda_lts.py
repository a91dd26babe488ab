"""Wrapper of the hand-written Hopper kernel of Schmidl-Cox LTS fine timing
(``csrc/lts_timing.cu``), the card's form of ``sync/schmidl_cox.
lts_timing_plain``: for each lane, the matched filter against the passband
LTS template, its energy normalisation, the first argmax over the lane's
search window around ``sync_off + 4 plen`` and the one-symbol rule, at the
window's positions only.  In the JAX package it is XLA's FFT matched filter
and masked argmax (projectultra_tpu/sync/schmidl_cox.py::detect_preamble);
``lts_timing_plain`` is the plain PyTorch version, the CPU path and the
kernel's oracle on the card.

The kernel reads the samples in place, with their row stride, the
template from a per-device copy made once, ``sync_off`` and the lanes' DC
bins of the signal FFT (a lane whose DC bin is not finite held a NaN or
infinite sample, and the plain matched filter is NaN there throughout).
``launches`` counts the kernel runs made through ``lts_timing_cuda``.

One block a lane; ``launch_plan`` says what a launch at given sizes runs.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_build

SOURCE = cuda_build.CSRC_DIR / "lts_timing.cu"
FLAGS: tuple[str, ...] = ()

#: Kernel launches made through lts_timing_cuda (a run resets it to 0 to
#: show that its path went through the kernel).
launches = 0

#: The kernel's fixed sizes (``kPer``, ``kThreads``, ``kWarp`` in the
#: source): window positions a thread, threads a block.
PER_THREAD = 16
THREADS = 128
WARP = 32


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lts_timing_launch.argtypes = [vp, cll, ci, ci, vp, ci, ci,
                                      ctypes.c_float, vp, vp, cll, vp, vp,
                                      vp, vp]
    lib.lts_timing_launch.restype = ci
    lib.lts_timing_plan.argtypes = [ci, ci, ci, ci, ctypes.POINTER(cll)]
    lib.lts_timing_plan.restype = ci
    for name in ("per_thread", "threads"):
        getattr(lib, f"lts_timing_{name}").argtypes = []
        getattr(lib, f"lts_timing_{name}").restype = ci
    if (lib.lts_timing_per_thread(), lib.lts_timing_threads()) \
            != (PER_THREAD, THREADS):
        raise RuntimeError("csrc/lts_timing.cu and ops/cuda_lts.py disagree "
                           "on the kernel's sizes")


LIBRARY = cuda_build.KernelLibrary("lts_timing", SOURCE, FLAGS, _bind)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def max_positions(plen: int) -> int:
    """Positions of the widest window, [coarse - 3 plen, coarse + plen/2]."""
    return 3 * plen + plen // 2 + 1


def window(sync_off: int, plen: int, n_mf: int) -> tuple[int, int]:
    """The positions [lo, hi] the kernel evaluates for a lane at
    ``sync_off``: the search window clipped to [0, n_mf), or position 0
    alone when that is empty (where the plain argmax of an all -1 row
    lands)."""
    coarse = sync_off + 4 * plen
    lo, hi = max(coarse - 3 * plen, 0), min(coarse + plen // 2, n_mf - 1)
    return (lo, hi) if lo <= hi else (0, 0)


def launch_plan(B: int, L: int, plen: int) -> dict:
    """What ``lts_timing_cuda`` launches for B lanes, a template of L
    samples and symbols of plen: blocks, threads a block, passes of the
    threads over the widest window, and the shared words of its parts and
    bytes a block (the source's ``shared_bytes``)."""
    positions = _round_up(max_positions(plen), PER_THREAD)
    staged = _round_up(positions + L, WARP)
    words = staged + 2 * L + positions + 2 * (THREADS // WARP)
    return {"blocks": B, "threads": THREADS,
            "passes": -(-positions // (PER_THREAD * THREADS)),
            "staged_words": staged, "position_words": positions,
            "shared_bytes": 4 * words}


def card_plan(B: int, L: int, plen: int, T: int,
              device: torch.device) -> dict:
    """``launch_plan`` with the blocks, threads and shared bytes as the
    library computes them and the blocks an SM holds, on ``device``."""
    plan = launch_plan(B, L, plen)
    out = (ctypes.c_longlong * 4)()
    with torch.cuda.device(device):
        LIBRARY.run("lts_timing_plan", B, T, L, plen, out)
    return plan | {"library": {"blocks": int(out[0]), "threads": int(out[1]),
                               "shared_bytes": int(out[2])},
                   "blocks_per_sm": int(out[3])}


@functools.lru_cache(maxsize=None)
def _template(config, device: torch.device) -> tuple[torch.Tensor, float]:
    """(the passband LTS template [L] complex64 on ``device``, half its
    energy rounded to float32 as the plain version's product rounds it),
    made once per device."""
    from ..sync import schmidl_cox
    tmpl = schmidl_cox.lts_passband_template(config)
    return (torch.from_numpy(tmpl).to(device),
            float(np.float32(schmidl_cox.lts_energy_ref(config))))


def _check(samples: torch.Tensor, sync_off: torch.Tensor, dc: torch.Tensor,
           L: int) -> None:
    check = cuda_build.check_tensor
    check("samples", samples, torch.float32, ("B", "T"), "disjoint rows",
          None)
    B, T = samples.shape
    if not L <= T < 2**31 - 1:
        raise ValueError(f"a buffer of {T} samples and a template of {L}")
    if L % 8 or L < 2 * PER_THREAD:
        raise ValueError(f"the template's length {L} must be a multiple of "
                         f"8, at least {2 * PER_THREAD}")
    check("sync_off", sync_off, torch.int64, (B,), "any", samples.device)
    check("dc", dc, torch.complex64, (B,), "any", samples.device)


def lts_timing_cuda(config, samples: torch.Tensor, sync_off: torch.Tensor,
                    dc: torch.Tensor):
    """One kernel launch over [B, T] float32 CUDA samples (unit column
    stride, any row stride) at the lanes' ``sync_off`` [B] int64, with
    ``dc`` [B] complex64 the DC bins of their signal FFT (any stride) ->
    (lts_start [B] int32, data_start [B] int32, lts_corr [B] float32).
    The counterpart of ``sync/schmidl_cox.lts_timing_plain`` for one
    gate set."""
    global launches
    tmpl, e_ref = _template(config, samples.device)
    L = int(tmpl.shape[0])
    _check(samples, sync_off, dc, L)
    B, T = samples.shape
    dev = samples.device
    plen = config.fft_size + config.cyclic_prefix
    LIBRARY.load()  # built at the first call, an empty one too
    lts_start = torch.empty(B, dtype=torch.int32, device=dev)
    data_start = torch.empty(B, dtype=torch.int32, device=dev)
    lts_corr = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return lts_start, data_start, lts_corr
    sync_off = sync_off.contiguous()
    ldx = samples.stride(0) if B > 1 else T
    ld_dc = dc.stride(0) if B > 1 else 0
    with torch.cuda.device(dev):
        LIBRARY.run(
            "lts_timing_launch", samples.data_ptr(), ldx, B, T,
            tmpl.data_ptr(), L, plen, e_ref, sync_off.data_ptr(),
            dc.data_ptr(), ld_dc, lts_start.data_ptr(), data_start.data_ptr(),
            lts_corr.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return lts_start, data_start, lts_corr


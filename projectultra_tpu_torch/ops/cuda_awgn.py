"""Wrapper of the hand-written Hopper kernel of the harness AWGN channel
(``csrc/awgn_active.cu``), the card's form of ``sim/watterson.
add_noise_with_plain``: each frame's power over its active samples
(|s| > 1e-6), the noise scaled to ``snr_db`` below it, added, in one pass
over the samples and the noise.  In the JAX package it is one XLA fusion
(projectultra_tpu/sim/watterson.py::add_noise_active); the plain PyTorch
version is the CPU path and the kernel's oracle on the card.

The kernel reads the samples and the noise in place, with their row
strides, and takes the SNR as the plain version makes it: a Python number
or a CPU scalar by value (its float32 reciprocal, as PyTorch's division of
a CUDA tensor by a CPU scalar takes it), a tensor on the card through a
pointer, broadcast to the frames.  ``launches`` counts the kernel runs made
through ``add_noise_cuda``.

``launch_plan`` picks the regime from the shape alone: a row in one block's
shared memory, a row over a thread-block cluster, or rows streamed twice by
a cooperative grid.
"""

from __future__ import annotations

import ctypes
import functools
import math
import numbers

import numpy as np
import torch

from . import cuda_build

SOURCE = cuda_build.CSRC_DIR / "awgn_active.cu"
FLAGS: tuple[str, ...] = ()

#: Kernel launches made through add_noise_cuda (a run resets it to 0 to
#: show that its path went through the kernel).
launches = 0

#: The kernel's fixed sizes (``kMaxSlice``, ``kMaxParts``, ``kMaxThreads``,
#: ``kStreamThreads`` in the source): samples a row block stages, blocks a
#: cluster, threads a row block, threads a stream block.
MAX_SLICE = 24576
MAX_PARTS = 8
MAX_THREADS = 1024
STREAM_THREADS = 256
WARP = 32
#: The plan's aims: 16-byte copies a row block's thread stages, at least
#: (the block is the next power of two in threads, so that whole blocks
#: fill an SM's 2,048 thread slots), samples a stream work item at most.
VEC_PER_THREAD = 6
STREAM_SLICE = 8192


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.awgn_active_launch.argtypes = [vp, cll, vp, cll, vp, cll, vp, cll,
                                       ctypes.c_float, ci, ci, ci, ci, ci,
                                       ci, vp, vp]
    lib.awgn_active_launch.restype = ci
    lib.awgn_active_plan.argtypes = [ci, ci, ci, ci, ci, ci,
                                     ctypes.POINTER(cll)]
    lib.awgn_active_plan.restype = ci
    for name in ("max_slice", "max_parts", "max_threads", "stream_threads"):
        getattr(lib, f"awgn_active_{name}").argtypes = []
        getattr(lib, f"awgn_active_{name}").restype = ci
    if (lib.awgn_active_max_slice(), lib.awgn_active_max_parts(),
            lib.awgn_active_max_threads(), lib.awgn_active_stream_threads()) \
            != (MAX_SLICE, MAX_PARTS, MAX_THREADS, STREAM_THREADS):
        raise RuntimeError("csrc/awgn_active.cu and ops/cuda_awgn.py "
                           "disagree on the kernel's sizes")


LIBRARY = cuda_build.KernelLibrary("awgn_active", SOURCE, FLAGS, _bind)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def launch_plan(B: int, T: int) -> dict:
    """What ``add_noise_cuda`` launches for B rows of T samples: a row in
    one block where one block holds it, over a cluster where a cluster
    does, streamed twice beyond (``regime_plan``)."""
    if T <= MAX_SLICE:
        return regime_plan("row", B, T)
    if T <= MAX_PARTS * MAX_SLICE:
        return regime_plan("cluster", B, T)
    return regime_plan("stream", B, T)


def regime_plan(regime: str, B: int, T: int) -> dict:
    """The launch of ``regime`` for B rows of T samples ("row": one block
    holds a row; "cluster": a cluster of MAX_PARTS blocks holds it;
    "stream": ``parts`` work items a row, read twice): the samples a block
    or an item holds (``slice``), threads a block, blocks (the stream
    regime's grid is the card's resident blocks, at most ``items``) and
    dynamic shared bytes a block.  ``launch_plan`` picks the regime;
    measurements that compare regimes take another."""
    parts = {"row": 1, "cluster": MAX_PARTS}.get(regime) \
        or _ceil(T, STREAM_SLICE)
    slice_ = max(4, 4 * _ceil(_ceil(T, parts), 4))
    if regime == "stream":
        return {"regime": regime, "parts": parts, "slice": slice_,
                "threads": STREAM_THREADS, "items": B * parts,
                "shared_bytes": 0, "passes": 4}
    vecs = _ceil(slice_ // 4, VEC_PER_THREAD)
    threads = min(MAX_THREADS, max(WARP, 1 << (vecs - 1).bit_length()))
    return {"regime": regime, "parts": parts, "slice": slice_,
            "threads": threads, "blocks": B * parts,
            "shared_bytes": 4 * slice_, "passes": 3}


def card_plan(B: int, T: int, device: torch.device) -> dict:
    """``launch_plan`` with the blocks, threads and shared bytes as the
    library computes them and the blocks an SM holds, on ``device``."""
    plan = launch_plan(B, T)
    out = (ctypes.c_longlong * 4)()
    with torch.cuda.device(device):
        LIBRARY.run("awgn_active_plan", B, T, int(plan["regime"] == "stream"),
                    plan["slice"], plan["parts"], plan["threads"], out)
    return plan | {"library": {"blocks": int(out[0]), "threads": int(out[1]),
                               "shared_bytes": int(out[2])},
                   "blocks_per_sm": int(out[3])}


@functools.lru_cache(maxsize=64)
def _host_inv(snr_db: float) -> float:
    """float32(1 / snr_lin) of a host SNR, snr_lin by the plain version's
    own expression."""
    snr_lin = 10.0 ** (torch.as_tensor(snr_db, dtype=torch.float32) / 10.0)
    return float(np.float32(1.0) / np.float32(snr_lin.item()))


def _snr_arg(snr_db, lead: torch.Size, device: torch.device):
    """(device SNRs or None, their step a row, the host reciprocal): a
    number or a CPU scalar by value, a tensor on ``device`` (the linear SNR
    by the plain version's own expression) broadcast to the ``lead``
    frames."""
    if isinstance(snr_db, numbers.Real):
        return None, 0, _host_inv(float(snr_db))
    snr_lin = 10.0 ** (torch.as_tensor(snr_db, dtype=torch.float32) / 10.0)
    if snr_lin.device.type == "cpu" and snr_lin.dim() == 0:
        return None, 0, float(np.float32(1.0) / np.float32(snr_lin.item()))
    if snr_lin.device != device:
        raise ValueError(f"a per-frame SNR must be on {device}, got one on "
                         f"{snr_lin.device}")
    per_row = snr_lin.expand(lead).reshape(-1)
    return per_row, (per_row.stride(0) if per_row.numel() > 1 else 0), 1.0


def add_noise_cuda(samples: torch.Tensor, snr_db,
                   noise: torch.Tensor) -> torch.Tensor:
    """One kernel launch over [..., T] float32 CUDA samples and standard
    normals of the same shape (unit column stride, any row stride; others
    are copied contiguous) at ``snr_db`` (a number, or a tensor broadcasting
    to the frames) -> the noisy [..., T] float32 samples, contiguous.  The
    counterpart of ``sim/watterson.add_noise_with_plain``."""
    global launches
    if samples.dim() == 0:
        raise ValueError("samples must have a sample axis")
    shape, T = samples.shape, samples.shape[-1]
    if noise.shape != shape:
        raise ValueError(f"noise must be {tuple(shape)}, got "
                         f"{tuple(noise.shape)}")
    B = math.prod(shape[:-1])
    x = (samples if samples.stride(-1) == 1 else samples.contiguous()
         ).reshape(B, T)
    z = (noise if noise.stride(-1) == 1 else noise.contiguous()
         ).reshape(B, T)
    check = cuda_build.check_tensor
    check("samples", x, torch.float32, ("B", "T"), "rows", None)
    check("noise", z, torch.float32, (B, T), "rows", x.device)
    dev = x.device
    if T >= 2**31 - 4:
        raise ValueError(f"samples has too many columns: {T}")
    snr, snr_step, inv_snr = _snr_arg(snr_db, shape[:-1], dev)
    LIBRARY.load()  # built at the first call, an empty one too
    y = torch.empty((B, T), dtype=torch.float32, device=dev)
    if B == 0 or T == 0:
        return y.reshape(shape)
    plan = launch_plan(B, T)
    stream = plan["regime"] == "stream"
    part = (torch.empty(2 * B * plan["parts"], dtype=torch.float32,
                        device=dev) if stream else None)
    with torch.cuda.device(dev):
        LIBRARY.run(
            "awgn_active_launch", x.data_ptr(), x.stride(0), z.data_ptr(),
            z.stride(0), y.data_ptr(), T,
            None if snr is None else snr.data_ptr(), snr_step, inv_snr, B, T,
            int(stream), plan["slice"], plan["parts"], plan["threads"],
            None if part is None else part.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return y.reshape(shape)

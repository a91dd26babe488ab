"""Wrapper of the hand-written Hopper Schmidl-Cox window kernel
(``csrc/sc_windows.cu``), the port of ``ops/pallas_sync.py::_sc_kernel``.

The kernel reads the analytic signal in place, with its row stride (the
signal is a column slice of the Hilbert transform's [B, n_fft] output, and
a contiguous copy would cost one more pass over it).  ``launches`` counts
the kernel launches made through ``sc_windows_cuda``.  Rows the kernel
cannot read as 16-byte pairs of samples (an odd row stride, an unaligned
base) are first copied into rows of even length.

The kernel's blocks are persistent: each walks work items of ``tile``
outputs of one row (``tile_for``), staging each item's samples in shared
memory; ``launch_plan`` says what a launch at given sizes runs (tile,
items, blocks, ring stages, shared bytes a block).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .sc_windows import check_args

SOURCE = cuda_build.CSRC_DIR / "sc_windows.cu"
FLAGS: tuple[str, ...] = ()

#: Kernel launches made through sc_windows_cuda (a run resets it to 0 to
#: show that its path went through the kernel).
launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sc_windows_launch.argtypes = [vp, ctypes.c_longlong] + [ci] * 8 \
        + [vp] * 4
    lib.sc_windows_launch.restype = ci
    lib.sc_windows_plan.argtypes = [ci] * 8 + [ctypes.POINTER(
        ctypes.c_longlong)]
    lib.sc_windows_plan.restype = ci


LIBRARY = cuda_build.KernelLibrary("sc_windows", SOURCE, FLAGS, _bind)


#: Strides the kernel supports: 1, or an even power of two whose stride/2
#: threads per block partial fit in a warp.
STRIDES = (1, 2, 4, 8, 16, 32, 64)


#: Outputs a work item covers: up to MAX_TILE when B rows of such tiles
#: give two items an SM, else up to MIN_TILE; never so many that a stage
#: of samples passes STAGE_BYTES (three blocks of two stages an SM).
MAX_TILE, MIN_TILE = 512, 128
STAGE_BYTES = 34 * 1024


def stage_samples(tile: int, half: int, stride: int) -> int:
    """Samples one stage of the kernel's ring holds for a tile: the span
    stride * (tile - 1) + 2 * half from an even sample at or below its
    first, rounded to pairs, and one spare pair (``layout`` in the
    source)."""
    return (1 + stride * (tile - 1) + 2 * half + 1) // 2 * 2 + 2


def tile_for(B: int, G: int, half: int, stride: int, sms: int) -> int:
    """Outputs per work item for B rows of G outputs on a card of ``sms``
    SMs: tiles of up to MAX_TILE outputs if the B rows of them give two
    items an SM, else of up to MIN_TILE; at most as many as keep a stage
    within STAGE_BYTES (at least 4); the tiles of a row as equal as
    multiples of 4 allow."""
    limit = MAX_TILE if B * -(-G // MAX_TILE) >= 2 * sms else MIN_TILE
    # stage_samples(t) <= stride * (t - 1) + 2 * half + 4
    fits = (STAGE_BYTES // 8 - 2 * half - 4) // stride + 1
    limit = max(4, min(limit, fits // 4 * 4))
    per_row = -(-G // limit)
    return min(limit, 4 * -(-G // (4 * per_row)))


def launch_plan(B: int, T: int, half: int, stride: int, offset: int, G: int,
                device: torch.device) -> dict:
    """What ``sc_windows_cuda`` launches at these sizes on ``device``:
    tile, work items, blocks, ring stages and dynamic shared bytes a
    block."""
    sms = cuda_build.sm_count(device)
    tile = tile_for(B, G, half, stride, sms)
    out = (ctypes.c_longlong * 4)()
    with torch.cuda.device(device):
        LIBRARY.run("sc_windows_plan", B, T, half, stride, offset, G, tile,
                    sms, out)
    return {"tile": tile, "items": int(out[3]), "blocks": int(out[1]),
            "stages": int(out[0]), "shared_bytes": int(out[2])}


def _float4_rows(a: torch.Tensor) -> torch.Tensor:
    """``a`` itself when the kernel can read it as 16-byte pairs of samples
    (aligned base, even row stride, a readable pair past the last sample of
    every row); else a copy into rows of even length that is."""
    B, T = a.shape
    lda = a.stride(0)
    end = a.storage_offset() + (B - 1) * lda + T + T % 2
    if (a.data_ptr() % 16 == 0 and lda % 2 == 0
            and end * a.element_size() <= a.untyped_storage().nbytes()):
        return a
    buf = torch.zeros((B, T + T % 2), dtype=a.dtype, device=a.device)
    buf[:, :T] = a
    return buf[:, :T]


def sc_windows_cuda(a: torch.Tensor, half: int, stride: int, offset: int,
                    G: int):
    """One kernel launch over a [B, T] complex64 CUDA analytic signal (unit
    column stride, any row stride) -> (P [B, G] complex64, R1 [B, G] f32,
    R2 [B, G] f32); the counterpart of ``sc_windows_plain``."""
    global launches
    cuda_build.check_tensor("a", a, torch.complex64, ("B", "T"), "rows",
                            None)
    B, T = a.shape
    if T >= 2 ** 31 or B > 65535:
        raise ValueError(f"a is too large for the kernel's grid: "
                         f"{tuple(a.shape)}")
    check_args(T, half, stride, offset, G)
    if stride not in STRIDES or half % 2:
        raise ValueError(f"the window kernel takes strides {STRIDES} and an "
                         f"even half, got stride={stride}, half={half}")
    a = _float4_rows(a)
    dev = a.device
    LIBRARY.load()  # built at the first call, an empty one too
    P = torch.empty((B, G), dtype=torch.complex64, device=dev)
    R1 = torch.empty((B, G), dtype=torch.float32, device=dev)
    R2 = torch.empty((B, G), dtype=torch.float32, device=dev)
    if B == 0 or G == 0:
        return P, R1, R2
    sms = cuda_build.sm_count(dev)
    with torch.cuda.device(dev):
        LIBRARY.run(
            "sc_windows_launch", a.data_ptr(), a.stride(0), B, T, half,
            stride, offset, G, tile_for(B, G, half, stride, sms), sms,
            P.data_ptr(), R1.data_ptr(), R2.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return P, R1, R2

"""Wrapper of the hand-written Hopper Schmidl-Cox window kernel
(``csrc/sc_windows.cu``), the port of ``ops/pallas_sync.py::_sc_kernel``.

The source is built at first use by ``cuda_build``:
``nvcc`` for ``sm_90a`` into a plain-C shared library loaded with
``ctypes``.  A failed build raises; nothing falls back to the plain
PyTorch version.

The kernel reads the analytic signal in place, with its row stride (the
signal is a column slice of the Hilbert transform's [B, n_fft] output, and
a contiguous copy would cost one more pass over it).  It launches on
PyTorch's current stream, does not synchronise and allocates nothing: this
wrapper allocates the outputs with ``torch.empty``.  ``launches`` counts
the kernel launches made through ``sc_windows_cuda``.  Rows the kernel
cannot read as 16-byte pairs of samples (an odd row stride, an unaligned
base) are first copied into rows of even length.  Each block computes
512 outputs of one row.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

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
    lib.sc_windows_launch.argtypes = [vp, ctypes.c_longlong] + [ci] * 6 \
        + [vp] * 4
    lib.sc_windows_launch.restype = ci
    lib.sc_windows_error_string.argtypes = [ci]
    lib.sc_windows_error_string.restype = ctypes.c_char_p


LIBRARY = cuda_build.KernelLibrary(SOURCE, FLAGS, _bind)


def nvcc_command(nvcc: str, source: Path, output: Path) -> list[str]:
    """The compiler command for the kernel library."""
    return cuda_build.nvcc_command(nvcc, source, output, FLAGS)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    return LIBRARY.load()


#: Strides the kernel supports: 1, or an even power of two whose stride/2
#: threads per block partial fit in a warp.
STRIDES = (1, 2, 4, 8, 16, 32, 64)


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
    if a.device.type != "cuda":
        raise ValueError(f"the window kernel needs a CUDA tensor, got {a.device}")
    if a.dtype != torch.complex64:
        raise ValueError(f"the window kernel takes complex64, got {a.dtype}")
    if a.dim() != 2:
        raise ValueError(f"a must be [B, T], got shape {tuple(a.shape)}")
    if a.stride(1) != 1:
        raise ValueError(f"a must have unit column stride, got {a.stride()}")
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
    lib = load_library()
    P = torch.empty((B, G), dtype=torch.complex64, device=dev)
    R1 = torch.empty((B, G), dtype=torch.float32, device=dev)
    R2 = torch.empty((B, G), dtype=torch.float32, device=dev)
    if B == 0 or G == 0:
        return P, R1, R2
    with torch.cuda.device(dev):
        err = lib.sc_windows_launch(
            a.data_ptr(), a.stride(0), B, T, half, stride, offset, G,
            P.data_ptr(), R1.data_ptr(), R2.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.sc_windows_error_string(err).decode()
        raise RuntimeError(f"sc_windows_launch failed: {msg} ({err})")
    launches += 1
    return P, R1, R2

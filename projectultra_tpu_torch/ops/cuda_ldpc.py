"""Wrapper of the hand-written Hopper LDPC min-sum kernel
(``csrc/ldpc_minsum.cu``), the port of ``ops/pallas_ldpc.py::_kernel``.

The source is built at first use by ``cuda_build``:
``nvcc`` for ``sm_90a`` into a plain-C shared library loaded with
``ctypes``, compiled with ``--fmad=false`` so that the kernel's additions
round exactly as the plain decoder's; its clamp and min2 keep a NaN as the
plain decoder's do.  A failed build raises; nothing falls back to the
plain PyTorch decoder.

The kernel launches on PyTorch's current stream, does not synchronise and
allocates nothing: this wrapper allocates the outputs with ``torch.empty``.
The library holds two instantiations of the kernel, one per edge-message
dtype (``ldpc_minsum_decode`` with float32 messages,
``ldpc_minsum_decode_bf16`` with bfloat16 ones; the LLRs in and out are
float32 in both; the bfloat16 one keeps one 8-byte record per check row
instead of D float32 messages).  ``launches`` counts the float32 kernel's
launches made through ``decode_cuda``, ``launches_bf16`` the bfloat16
kernel's.

Launch shape: one block per codeword, of ``block_threads_for(B, SMs)``
threads: 256 at large batches, 1,024 at small ones, where the few blocks'
own latency is the kernel's time.  The kernel reads the graph with its
check rows sorted by degree (``LDPCGraph.sorted_*``; the bfloat16 one its
variable table as ``sorted_var_slots``) and the variables' degrees
(``LDPCGraph.var_deg``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..fec.ldpc import DEFAULT_MAX_ITERS
from . import cuda_build
from .ldpc import msg_dtype_of, trap_escape_llrs

SOURCE = cuda_build.CSRC_DIR / "ldpc_minsum.cu"
BUILD_DIR = cuda_build.BUILD_DIR
FLAGS = ("--fmad=false",)

#: Float32-message kernel launches made through decode_cuda (a run resets
#: it to 0 to show that its path went through the kernel).
launches = 0
#: Bfloat16-message kernel launches made through decode_cuda.
launches_bf16 = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for entry in (lib.ldpc_minsum_decode, lib.ldpc_minsum_decode_bf16):
        entry.argtypes = [vp] * 8 + [ci] * 7 + [vp]
        entry.restype = ci
    lib.ldpc_minsum_shared_bytes.argtypes = [ci] * 4
    lib.ldpc_minsum_shared_bytes.restype = ctypes.c_longlong
    lib.ldpc_minsum_error_string.argtypes = [ci]
    lib.ldpc_minsum_error_string.restype = ctypes.c_char_p


#: Codewords per SM from which blocks of 256 threads (8 fit an SM) keep
#: every SM full; below it each codeword gets 1,024 threads.
WIDE_BELOW = 8


def block_threads_for(B: int, sms: int) -> int:
    """Threads per codeword (one block each): 256 when every SM gets at
    least WIDE_BELOW codewords, else 1,024, so that a small batch's few
    blocks each finish their codeword sooner."""
    return 256 if B >= WIDE_BELOW * max(sms, 1) else 1024


LIBRARY = cuda_build.KernelLibrary(SOURCE, FLAGS, _bind)


def nvcc_command(nvcc: str, source: Path, output: Path) -> list[str]:
    """The compiler command for the kernel library."""
    return cuda_build.nvcc_command(nvcc, source, output, FLAGS)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    return LIBRARY.load()


def shared_bytes(graph, msg_dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the instantiation of
    ``msg_dtype`` on ``graph``'s code, as the kernel library counts it."""
    bf16 = msg_dtype_of(msg_dtype) == torch.bfloat16
    return int(load_library().ldpc_minsum_shared_bytes(graph.n, graph.m,
                                                       graph.D, int(bf16)))


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def launch(graph, llrs: torch.Tensor, max_iters: int,
           msg_dtype: torch.dtype = torch.float32):
    """One kernel launch over a [B, n] float32 CUDA batch, with edge
    messages of ``msg_dtype`` (float32 or bfloat16).

    Returns (llr_total [B, n] f32, ok [B] bool, iters [B] int32)."""
    global launches, launches_bf16
    if llrs.device.type != "cuda":
        raise ValueError(f"the LDPC kernel needs a CUDA tensor, got {llrs.device}")
    if llrs.dtype != torch.float32:
        raise ValueError(f"the LDPC kernel takes float32 LLRs, got {llrs.dtype}")
    bf16 = msg_dtype_of(msg_dtype) == torch.bfloat16
    if llrs.dim() != 2:
        raise ValueError(f"llrs must be [B, n], got shape {tuple(llrs.shape)}")
    B = llrs.shape[0]
    n, m, D, Dv = graph.n, graph.m, graph.D, graph.Dv
    dev = llrs.device
    _check("llrs", llrs, torch.float32, (B, n), dev)
    _check("sorted_row_vars", graph.sorted_row_vars, torch.int32, (m, D), dev)
    _check("sorted_row_deg", graph.sorted_row_deg, torch.int32, (m,), dev)
    table = "sorted_var_slots" if bf16 else "sorted_var_edges"
    var_table = getattr(graph, table)
    _check(table, var_table, torch.int32, (n, Dv), dev)
    _check("var_deg", graph.var_deg, torch.int32, (n,), dev)
    if n % 4:
        raise ValueError(f"the kernel copies rows in 16-byte chunks: n={n}")
    if not 0 <= max_iters < 2 ** 31:
        raise ValueError(f"max_iters out of range: {max_iters}")
    if llrs.data_ptr() % 16:
        raise ValueError("llrs must be 16-byte aligned (the kernel copies "
                         "rows in 16-byte chunks)")
    llr_out = torch.empty((B, n), dtype=torch.float32, device=dev)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return llr_out, ok, iters
    lib = load_library()
    threads = block_threads_for(B, cuda_build.sm_count(dev))
    entry = lib.ldpc_minsum_decode_bf16 if bf16 else lib.ldpc_minsum_decode
    with torch.cuda.device(dev):
        err = entry(
            llrs.data_ptr(), graph.sorted_row_vars.data_ptr(),
            graph.sorted_row_deg.data_ptr(), var_table.data_ptr(),
            graph.var_deg.data_ptr(),
            llr_out.data_ptr(), ok.data_ptr(), iters.data_ptr(), B, n, m, D,
            Dv, max_iters, threads,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.ldpc_minsum_error_string(err).decode()
        raise RuntimeError(f"ldpc_minsum_decode{'_bf16' if bf16 else ''} "
                           f"launch failed: {msg} ({err})")
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return llr_out, ok, iters


def decode_cuda(graph, llrs: torch.Tensor,
                max_iters: int = DEFAULT_MAX_ITERS,
                trap_escape: bool = False, msg_dtype=None):
    """The kernel's counterpart of ``ops.ldpc.decode_plain``: returns
    (llr_total [B, n] f32, ok [B] bool, iters [B] int32).

    ``msg_dtype`` (None: the module default of ``ops.ldpc``) picks the
    kernel's instantiation.  ``trap_escape`` is a second launch over the
    failed lanes only, on their channel LLRs with the bits of unsatisfied
    checks erased."""
    msg_dtype = msg_dtype_of(msg_dtype)
    llr_in = llrs.contiguous()
    if llr_in.data_ptr() % 16:  # a view at an odd offset: copy it aligned
        llr_in = llr_in.clone()
    llr_total, ok, iters = launch(graph, llr_in, max_iters, msg_dtype)
    if trap_escape:
        failed = torch.nonzero(~ok).squeeze(1)
        if failed.numel():
            llr2 = trap_escape_llrs(graph, llr_in[failed], llr_total[failed])
            llr_t2, ok2, iters2 = launch(graph, llr2.contiguous(), max_iters,
                                         msg_dtype)
            rescued = failed[ok2]
            llr_total[rescued] = llr_t2[ok2]
            iters[rescued] = iters2[ok2]
            ok[rescued] = True
    return llr_total, ok, iters

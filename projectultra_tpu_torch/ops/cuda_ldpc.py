"""Wrapper of the hand-written Hopper LDPC min-sum kernel
(``csrc/ldpc_minsum.cu``), the port of ``ops/pallas_ldpc.py::_kernel``.

Built (by ``cuda_build``) with ``--fmad=false`` so that the kernel's
additions round exactly as the plain decoder's; its clamp and min2 keep a
NaN as the plain decoder's do.  The library holds two instantiations of
the kernel, one per edge-message dtype (``ldpc_minsum_decode`` with
float32 messages, ``ldpc_minsum_decode_bf16`` with bfloat16 ones; the LLRs
in and out are float32 in both; the bfloat16 one keeps one 8-byte record
per check row instead of D float32 messages).  ``launches`` counts the
float32 kernel's launches made through ``decode_cuda``, ``launches_bf16``
the bfloat16 kernel's.

Launch shape: one block per codeword, of ``block_threads_for(B, SMs)``
threads: 256 at large batches, 1,024 at small ones, where the few blocks'
own latency is the kernel's time.  The kernel reads the graph with its
check rows sorted by degree (``LDPCGraph.sorted_*``; the bfloat16 one its
variable table as ``sorted_var_slots``) and the variables' degrees
(``LDPCGraph.var_deg``).
"""

from __future__ import annotations

import ctypes

import torch

from ..fec.ldpc import DEFAULT_MAX_ITERS
from . import cuda_build
from .ldpc import msg_dtype_of, trap_escape_llrs

SOURCE = cuda_build.CSRC_DIR / "ldpc_minsum.cu"
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


#: Codewords per SM from which blocks of 256 threads (8 fit an SM) keep
#: every SM full; below it each codeword gets 1,024 threads.
WIDE_BELOW = 8


def block_threads_for(B: int, sms: int) -> int:
    """Threads per codeword (one block each): 256 when every SM gets at
    least WIDE_BELOW codewords, else 1,024, so that a small batch's few
    blocks each finish their codeword sooner."""
    return 256 if B >= WIDE_BELOW * max(sms, 1) else 1024


LIBRARY = cuda_build.KernelLibrary("ldpc_minsum", SOURCE, FLAGS, _bind)


def shared_bytes(graph, msg_dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the instantiation of
    ``msg_dtype`` on ``graph``'s code, as the kernel library counts it."""
    bf16 = msg_dtype_of(msg_dtype) == torch.bfloat16
    return int(LIBRARY.load().ldpc_minsum_shared_bytes(graph.n, graph.m,
                                                       graph.D, int(bf16)))


def launch(graph, llrs: torch.Tensor, max_iters: int,
           msg_dtype: torch.dtype = torch.float32):
    """One kernel launch over a [B, n] float32 CUDA batch, with edge
    messages of ``msg_dtype`` (float32 or bfloat16).

    Returns (llr_total [B, n] f32, ok [B] bool, iters [B] int32)."""
    global launches, launches_bf16
    bf16 = msg_dtype_of(msg_dtype) == torch.bfloat16
    n, m, D, Dv = graph.n, graph.m, graph.D, graph.Dv
    check = cuda_build.check_tensor
    check("llrs", llrs, torch.float32, ("B", n), "aligned", None)
    dev = llrs.device
    check("sorted_row_vars", graph.sorted_row_vars, torch.int32, (m, D),
          "contiguous", dev)
    check("sorted_row_deg", graph.sorted_row_deg, torch.int32, (m,),
          "contiguous", dev)
    table = "sorted_var_slots" if bf16 else "sorted_var_edges"
    var_table = getattr(graph, table)
    check(table, var_table, torch.int32, (n, Dv), "contiguous", dev)
    check("var_deg", graph.var_deg, torch.int32, (n,), "contiguous", dev)
    if n % 4:
        raise ValueError(f"the kernel copies rows in 16-byte chunks: n={n}")
    if not 0 <= max_iters < 2 ** 31:
        raise ValueError(f"max_iters out of range: {max_iters}")
    B = llrs.shape[0]
    llr_out = torch.empty((B, n), dtype=torch.float32, device=dev)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return llr_out, ok, iters
    threads = block_threads_for(B, cuda_build.sm_count(dev))
    with torch.cuda.device(dev):
        LIBRARY.run(
            "ldpc_minsum_decode_bf16" if bf16 else "ldpc_minsum_decode",
            llrs.data_ptr(), graph.sorted_row_vars.data_ptr(),
            graph.sorted_row_deg.data_ptr(), var_table.data_ptr(),
            graph.var_deg.data_ptr(),
            llr_out.data_ptr(), ok.data_ptr(), iters.data_ptr(), B, n, m, D,
            Dv, max_iters, threads,
            torch.cuda.current_stream(dev).cuda_stream)
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

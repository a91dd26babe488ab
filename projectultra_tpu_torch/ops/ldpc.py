"""Batched LDPC encode and min-sum decode (port of
projectultra_tpu/ops/ldpc.py; reference src/fec/ldpc_decoder.cpp:151-236).

The code graph is built on the host by the port's ``fec.ldpc`` and held
on the device by ``LDPCGraph`` as buffers.  ``decode`` runs the
hand-written CUDA kernel (``ops/cuda_ldpc.py``) for CUDA tensors and the
plain PyTorch version
``decode_plain`` for CPU tensors.  The plain version is also the oracle the
kernel is tested against on the card.  ``decode_hard`` and the stream
helpers ``decode_soft_stream``/``decode_hard_stream`` wrap ``decode``.

Arithmetic contract (identical to the JAX decoder, so bits, ok flags and
iteration counts agree lane for lane):

* two-minima min-sum per check row, first-occurrence argmin over the row's
  edges in their stored order, c2v = (sign * min_excl) * 0.75;
* v2c = clamp(llr_total[var] - c2v, -50, 50), except iteration 0 whose v2c
  is the unclamped channel LLR;
* llr_total = llr_in + c2v[e0] + c2v[e1] + ..., summed left to right over a
  variable's edges in ascending check order (``_var_edge_table``);
* iteration counts: 0-based iteration of convergence, else ``max_iters``;
  converged lanes are frozen;
* NaN and infinity as the JAX decoder computes them op by op: the clamp
  and min2 keep a NaN (``torch.clamp``, ``torch.minimum``), +-inf clamps
  to +-50, and a NaN is neither negative nor a new min1;
* ``msg_dtype=torch.bfloat16`` (the fast mode): every v2c message is
  rounded to bfloat16 (nearest, ties to even) where it is made -- the
  channel LLRs of iteration 0 and each clamped later message -- and read
  back as float32 before any arithmetic; c2v, the totals, the channel
  LLRs, the syndrome and the trap-escape retry stay float32.  The default
  is float32, or bfloat16 when ``ULTRA_LDPC_BF16=1`` was set when this
  module was imported (as the JAX package reads it), for every caller that
  passes no ``msg_dtype``.
"""

from __future__ import annotations

import contextlib
import functools
import os

import numpy as np
import torch
from torch import nn

from ..device import resolve
from ..fec.ldpc import (DEFAULT_MAX_ITERS, HARD_LLR, LDPCCode,
                        MIN_SUM_SCALE, V2C_CLAMP)
from ..utils import metrics
from ..utils.bits import bits_to_bytes, bytes_to_bits

MSG_DTYPES = (torch.float32, torch.bfloat16)
_DEFAULT_MSG_DTYPE = (torch.bfloat16 if os.environ.get("ULTRA_LDPC_BF16") == "1"
                      else torch.float32)


@contextlib.contextmanager
def default_msg_dtype(dtype: torch.dtype):
    """Every decode that passes no ``msg_dtype`` uses ``dtype`` inside the
    block (what ``ULTRA_LDPC_BF16=1`` sets at import); restored after."""
    global _DEFAULT_MSG_DTYPE
    saved, _DEFAULT_MSG_DTYPE = _DEFAULT_MSG_DTYPE, msg_dtype_of(dtype)
    try:
        yield
    finally:
        _DEFAULT_MSG_DTYPE = saved


def msg_dtype_of(msg_dtype) -> torch.dtype:
    """The edge-message dtype a decode runs with: ``msg_dtype``, or the
    module default when it is None; raises on any other dtype."""
    dtype = _DEFAULT_MSG_DTYPE if msg_dtype is None else msg_dtype
    if dtype not in MSG_DTYPES:
        raise ValueError(f"LDPC edge messages are float32 or bfloat16, "
                         f"not {dtype}")
    return dtype


@functools.lru_cache(maxsize=None)
def _var_edge_table(code: LDPCCode):
    """Per-variable incoming-edge lists in ascending CHECK order, as indices
    into the d-major flat c2v space (e = d*m + i); entries beyond a
    variable's degree point at a trailing zero edge (index D*m)."""
    m, n, D = code.m, code.n, code.max_degree
    lists: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for i in range(m):
        for d in range(D):
            if code.row_mask[i, d]:
                lists[int(code.row_vars[i, d])].append((i, d))
    Dv = max(len(l) for l in lists)
    tab = np.full((n, Dv), D * m, np.int32)
    for v, l in enumerate(lists):
        for j, (i, d) in enumerate(sorted(l)):
            tab[v, j] = d * m + i
    return tab, Dv


def _sorted_rows(code: LDPCCode, var_edges: np.ndarray):
    """The graph with its check rows sorted by degree, descending (stable):
    (row_vars [m, D], row_deg [m], var_edges [n, Dv]) int32, where each
    variable's edge list names the same edges in the same order (ascending
    ORIGINAL check order) at their sorted rows, e = d*m + sorted row.  The
    CUDA kernel reads these, so that the rows of one warp share a degree;
    every c2v, sum and syndrome is the same as on the original tables."""
    m, D = code.m, code.max_degree
    deg = code.row_mask.sum(1).astype(np.int32)
    order = np.argsort(-deg, kind="stable")
    pos = np.empty(m, np.int64)
    pos[order] = np.arange(m)
    e = var_edges.astype(np.int64)
    pad = e >= D * m
    e = np.where(pad, D * m, (e // m) * m + pos[np.where(pad, 0, e % m)])
    return (np.ascontiguousarray(code.row_vars[order], np.int32),
            np.ascontiguousarray(deg[order]),
            np.ascontiguousarray(e, np.int32))


def _slot_table(sorted_var_edges: np.ndarray, m: int, D: int) -> np.ndarray:
    """The bf16 kernel's variable table: the edges of ``sorted_var_edges``
    (e = d*m + sorted row) in the same order as (sorted row << 3 | d), the
    byte offset of the row's 8-byte record plus its slot; -1 beyond each
    variable's degree."""
    e = sorted_var_edges.astype(np.int64)
    return np.where(e < D * m, ((e % m) << 3) | (e // m), -1).astype(np.int32)


class LDPCGraph(nn.Module):
    """One code rate's Tanner graph as device buffers.

    Buffers: ``h_t`` [k, m] f32 (H_data transposed, for encoding),
    ``row_vars`` [m, D] int32 and ``row_mask`` [m, D] bool (per-check edge
    lists, valid edges first), ``row_deg`` [m] int32, ``var_edges``
    [n, Dv] int32 (see ``_var_edge_table``); for the CUDA kernel, the same
    graph with its check rows sorted by degree (``sorted_row_vars``,
    ``sorted_row_deg``, ``sorted_var_edges``; see ``_sorted_rows``),
    ``var_deg`` [n] int32, each variable's number of edges, and for the
    bf16 kernel ``sorted_var_slots`` [n, Dv] int32 (``_slot_table``)."""

    def __init__(self, code: LDPCCode, var_edges: np.ndarray | None = None):
        super().__init__()
        self.code = code
        self.k, self.m, self.n, self.D = code.k, code.m, code.n, code.max_degree
        if var_edges is None:
            var_edges, _ = _var_edge_table(code)
        self.Dv = int(var_edges.shape[1])
        self.register_buffer("h_t", torch.from_numpy(
            np.ascontiguousarray(code.h_dense.T, np.float32)))
        self.register_buffer("row_vars", torch.from_numpy(
            np.ascontiguousarray(code.row_vars, np.int32)))
        self.register_buffer("row_mask", torch.from_numpy(
            np.ascontiguousarray(code.row_mask)))
        self.register_buffer("row_deg", torch.from_numpy(
            code.row_mask.sum(1).astype(np.int32)))
        self.register_buffer("var_edges", torch.from_numpy(
            np.ascontiguousarray(var_edges, np.int32)))
        for name, table in zip(("sorted_row_vars", "sorted_row_deg",
                                "sorted_var_edges"),
                               _sorted_rows(code, var_edges)):
            self.register_buffer(name, torch.from_numpy(table))
        self.register_buffer("var_deg", torch.from_numpy(
            (var_edges < self.D * self.m).sum(1).astype(np.int32)))
        self.register_buffer("sorted_var_slots", torch.from_numpy(_slot_table(
            self.sorted_var_edges.numpy(), self.m, self.D)))


@functools.lru_cache(maxsize=None)
def graph_for(code: LDPCCode, device: torch.device) -> LDPCGraph:
    """Per-(rate, device) graph cache behind the plain functions."""
    return LDPCGraph(code).to(device)


def encode(code: LDPCCode, info_bits: torch.Tensor) -> torch.Tensor:
    """[..., k] {0,1} -> [..., n] {0,1} (float32 out)."""
    g = graph_for(code, info_bits.device)
    return encode_with(g, info_bits)


def encode_with(graph: LDPCGraph, info_bits: torch.Tensor) -> torch.Tensor:
    info = info_bits.to(torch.float32)
    parity = torch.remainder(info @ graph.h_t, 2.0)
    return torch.cat([info, parity], dim=-1)


# ---------------------------------------------------------------------------
# Plain PyTorch decoder (CPU path and test oracle for the CUDA kernel)
# ---------------------------------------------------------------------------

def _two_minima(graph: LDPCGraph, v2c: torch.Tensor):
    """[B, D, m] v2c -> each row's (min1, min2, first-occurrence argmin,
    sign parity, list of D negative flags), all [B, m] (masked edges
    neither minima nor negative)."""
    mask = graph.row_mask.T                                  # [D, m]
    inf = torch.full((), float("inf"), dtype=torch.float32, device=v2c.device)
    B, D, m = v2c.shape
    min1 = inf.expand(B, m)
    min2 = inf.expand(B, m)
    amin = torch.zeros((B, m), dtype=torch.int32, device=v2c.device)
    par = torch.zeros((B, m), dtype=torch.int32, device=v2c.device)
    negs = []
    for d in range(D):
        a = torch.where(mask[d], v2c[:, d].abs(), inf)
        neg = (mask[d] & (v2c[:, d] < 0)).to(torch.int32)
        negs.append(neg)
        par = par ^ neg
        is_new = a < min1
        min2 = torch.where(is_new, min1, torch.minimum(min2, a))
        amin = torch.where(is_new, d, amin)
        min1 = torch.where(is_new, a, min1)
    return min1, min2, amin, par, negs


def _c2v(graph: LDPCGraph, v2c: torch.Tensor) -> torch.Tensor:
    """[B, D, m] v2c -> [B, D, m] c2v (masked edges 0)."""
    mask = graph.row_mask.T                                  # [D, m]
    D = v2c.shape[1]
    min1, min2, amin, par, negs = _two_minima(graph, v2c)
    out = []
    for d in range(D):
        sign = 1.0 - 2.0 * ((par ^ negs[d]) & 1).to(torch.float32)
        min_excl = torch.where(amin == d, min2, min1)
        out.append(torch.where(mask[d], sign * min_excl * MIN_SUM_SCALE, 0.0))
    return torch.stack(out, dim=1)


# The bf16 kernel's check-row record, modelled in plain PyTorch for the
# tests (no decode runs it): two int64 words per row holding the record's
# 32-bit words, x = min1's bf16 bits << 16 | min2's, y = bit 31 - d set
# where the row's c2v on slot d is negative and bit 24 - amin set, amin the
# slot of min1.  min1 is never NaN; a NaN min2 is stored as the kernel
# stores it, 0x7fff, and rebuilds to a NaN c2v.

def pack_records(graph: LDPCGraph, v2c: torch.Tensor) -> torch.Tensor:
    """[B, D, m] bf16-valued v2c (bf16 messages read back as float32) ->
    [B, m, 2] int64 records, as the bf16 kernel's row pass stores them."""
    min1, min2, amin, par, negs = _two_minima(graph, v2c)
    sign = torch.zeros_like(par, dtype=torch.int64)
    for d, neg in enumerate(negs):                 # c2v's sign: par ^ neg_d
        sign |= (graph.row_mask[:, d] & ((par ^ neg) == 1)).long() << (31 - d)

    def bits(x):
        b = x.to(torch.bfloat16).view(torch.int16).long() & 0xFFFF
        return torch.where(torch.isnan(x), 0x7FFF, b)

    return torch.stack([(bits(min1) << 16) | bits(min2),
                        sign | (0x01000000 >> amin.long())], dim=-1)


def rebuild_c2v(records: torch.Tensor, slot) -> torch.Tensor:
    """The c2v of [..., 2] records on ``slot`` (an int or a tensor that
    broadcasts), float32: (sign * (slot == argmin ? min2 : min1)) * 0.75,
    as the kernel rebuilds it: min_excl * (sign * 0.75)."""
    mins, t = records[..., 0], records[..., 1] << slot
    mag = torch.where((t & 0x01000000) != 0, (mins << 16) & 0xFFFF0000,
                      mins & 0xFFFF0000)
    scale = torch.where((t & 0x80000000) != 0, -MIN_SUM_SCALE, MIN_SUM_SCALE)
    return mag.to(torch.int32).view(torch.float32) * scale   # mag < 2**31


def records_c2v(graph: LDPCGraph, records: torch.Tensor) -> torch.Tensor:
    """[B, m, 2] records -> [B, D, m] c2v (masked edges 0), as ``_c2v``."""
    return torch.stack([torch.where(graph.row_mask[:, d],
                                    rebuild_c2v(records, d), 0.0)
                        for d in range(graph.row_mask.shape[1])], dim=1)


def _syndrome(graph: LDPCGraph, llr_total: torch.Tensor) -> torch.Tensor:
    """[B, n] totals -> [B, m] bool, True where a check is unsatisfied."""
    hard = (llr_total < 0)[:, graph.row_vars] & graph.row_mask   # [B, m, D]
    return (hard.to(torch.int32).sum(-1) & 1) == 1


def _llr_ok(graph: LDPCGraph, llr_in: torch.Tensor, c2v: torch.Tensor):
    """Total LLR (per-variable sums in ascending check order) + parity."""
    B = llr_in.shape[0]
    ce = torch.cat([c2v.reshape(B, -1),
                    torch.zeros((B, 1), dtype=torch.float32,
                                device=llr_in.device)], dim=1)
    llr_total = llr_in
    for j in range(graph.Dv):
        llr_total = llr_total + ce[:, graph.var_edges[:, j]]
    ok = ~_syndrome(graph, llr_total).any(-1)
    return llr_total, ok


def _stored(v2c: torch.Tensor, msg_dtype: torch.dtype) -> torch.Tensor:
    """v2c as the decoder stores it: rounded to ``msg_dtype`` and read back
    as float32 (the identity for float32 messages)."""
    if msg_dtype == torch.float32:
        return v2c
    return v2c.to(msg_dtype).to(torch.float32)


def _next_v2c(graph: LDPCGraph, llr_total: torch.Tensor, c2v: torch.Tensor,
              msg_dtype: torch.dtype = torch.float32):
    v = torch.clamp(llr_total[:, graph.row_vars.T] - c2v, -V2C_CLAMP, V2C_CLAMP)
    return _stored(torch.where(graph.row_mask.T, v, 0.0), msg_dtype)


def _run_plain(graph: LDPCGraph, llr_in: torch.Tensor, max_iters: int,
               msg_dtype: torch.dtype = torch.float32):
    B = llr_in.shape[0]
    dev = llr_in.device
    if max_iters == 0:
        return (llr_in, torch.zeros(B, dtype=torch.bool, device=dev),
                torch.zeros(B, dtype=torch.int32, device=dev))
    # Iteration 0 is stateless: v2c is the (unclamped) channel LLR.
    v2c0 = _stored(torch.where(graph.row_mask.T, llr_in[:, graph.row_vars.T],
                               0.0), msg_dtype)
    c2v = _c2v(graph, v2c0)
    llr_total, done = _llr_ok(graph, llr_in, c2v)
    iters = torch.where(done, 0, max_iters).to(torch.int32)
    if max_iters <= 1 or bool(done.all()):
        return llr_total, done, iters
    v2c = _next_v2c(graph, llr_total, c2v, msg_dtype)
    it = 1
    while it < max_iters and not bool(done.all()):
        c2v = _c2v(graph, v2c)
        llr_new, ok = _llr_ok(graph, llr_in, c2v)
        v2c_new = _next_v2c(graph, llr_new, c2v, msg_dtype)
        # Freeze converged lanes.
        v2c = torch.where(done[:, None, None], v2c, v2c_new)
        llr_total = torch.where(done[:, None], llr_total, llr_new)
        newly = ~done & ok
        iters = torch.where(newly, it, iters).to(torch.int32)
        done = done | ok
        it += 1
    return llr_total, done, iters


def trap_escape_llrs(graph: LDPCGraph, llr_in: torch.Tensor,
                     llr_total: torch.Tensor) -> torch.Tensor:
    """Channel LLRs with every bit that touches an unsatisfied check of
    the hard decision of ``llr_total`` erased to 0 (the trap-escape retry
    input, ops/ldpc.py:248-260)."""
    B = llr_in.shape[0]
    unsat = _syndrome(graph, llr_total)                           # [B, m]
    sus = (unsat[:, :, None] & graph.row_mask).reshape(B, -1)     # [B, m*D]
    hits = torch.zeros((B, graph.n), dtype=torch.int32, device=llr_in.device)
    hits.index_add_(1, graph.row_vars.reshape(-1), sus.to(torch.int32))
    return torch.where(hits > 0, 0.0, llr_in)


def decode_plain(graph: LDPCGraph, llrs: torch.Tensor,
                 max_iters: int = DEFAULT_MAX_ITERS,
                 trap_escape: bool = False, msg_dtype=None):
    """Plain PyTorch flooding min-sum on any device.

    Returns (llr_total [B, n] f32, ok [B] bool, iters [B] int32)."""
    msg_dtype = msg_dtype_of(msg_dtype)
    llr_in = llrs.to(torch.float32)
    llr_total, done, iters = _run_plain(graph, llr_in, max_iters, msg_dtype)
    if trap_escape and not bool(done.all()):
        llr2 = trap_escape_llrs(graph, llr_in, llr_total)
        llr_t2, done2, iters2 = _run_plain(graph, llr2, max_iters, msg_dtype)
        take = ~done & done2
        llr_total = torch.where(take[:, None], llr_t2, llr_total)
        iters = torch.where(take, iters2, iters)
        done = done | done2
    return llr_total, done, iters


def decode_totals(graph: LDPCGraph, llrs: torch.Tensor,
                  max_iters: int = DEFAULT_MAX_ITERS,
                  trap_escape: bool = False, msg_dtype=None):
    """Device dispatch: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns (llr_total, ok, iters)."""
    with metrics.span("ldpc.decode", llrs):
        msg_dtype = msg_dtype_of(msg_dtype)
        if llrs.device.type == "cuda":
            from . import cuda_ldpc  # imports this module
            return cuda_ldpc.decode_cuda(graph, llrs, max_iters, trap_escape,
                                         msg_dtype)
        if llrs.device.type != "cpu":
            raise ValueError(
                f"LDPC decode runs on cuda or cpu, not {llrs.device}")
        return decode_plain(graph, llrs, max_iters, trap_escape, msg_dtype)


def decode(code: LDPCCode, llrs: torch.Tensor,
           max_iters: int = DEFAULT_MAX_ITERS, trap_escape: bool = False,
           msg_dtype=None):
    """Flooding min-sum decode of [B, n] float32 LLRs (positive = bit 0).

    Returns info_bits [B, k] uint8, success [B] bool, iters [B] int32 with
    the JAX decoder's semantics (``msg_dtype`` None, float32 or bfloat16;
    see the module docstring).
    """
    graph = graph_for(code, llrs.device)
    llr_total, ok, iters = decode_totals(graph, llrs, max_iters, trap_escape,
                                         msg_dtype)
    return (llr_total[:, :code.k] < 0).to(torch.uint8), ok, iters


def decode_hard(code: LDPCCode, bits: torch.Tensor,
                max_iters: int = DEFAULT_MAX_ITERS):
    """Hard-input decode: bit b -> LLR -6/+6 (ldpc_decoder.cpp:267-281),
    on the device of ``bits``."""
    llrs = torch.where(bits > 0, -HARD_LLR, HARD_LLR).to(torch.float32)
    return decode(code, llrs, max_iters)


def decode_soft_stream(code: LDPCCode, llrs: np.ndarray,
                       max_iters: int = DEFAULT_MAX_ITERS,
                       device: torch.device | None = None):
    """Multi-block decode of a 1-D LLR stream (ldpc_decoder.cpp:283-428).

    Chunks the stream into n-bit codewords (zero-padding a trailing partial
    block), decodes them as one batch on ``device`` (the first CUDA device
    when None), and returns the concatenated info BITS packed into bytes
    only once at the very end — exactly the reference's bit-level
    multi-block semantics.

    Returns (decoded_bytes, success, per_block_iters).
    """
    device = resolve(device)
    llrs = np.asarray(llrs, dtype=np.float32).reshape(-1)
    if llrs.size == 0:
        return b"", False, np.zeros(0, np.int32)
    n = code.n
    nb = (llrs.size + n - 1) // n
    padded = np.zeros(nb * n, dtype=np.float32)
    padded[:llrs.size] = llrs
    blocks = torch.from_numpy(padded.reshape(nb, n)).to(device)
    info, ok, iters = decode(code, blocks, max_iters)
    info = info.cpu().numpy().reshape(-1)
    return (bits_to_bytes(info), bool(ok.all().item()),
            iters.cpu().numpy())


def decode_hard_stream(code: LDPCCode, data: bytes,
                       max_iters: int = DEFAULT_MAX_ITERS,
                       device: torch.device | None = None):
    """Byte-stream hard decode (LDPCDecoder::decode) on ``device``."""
    bits = bytes_to_bits(data).astype(np.float32)
    llrs = np.where(bits > 0, -HARD_LLR, HARD_LLR).astype(np.float32)
    return decode_soft_stream(code, llrs, max_iters, device)

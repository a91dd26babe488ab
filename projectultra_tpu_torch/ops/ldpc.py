"""Batched LDPC encode and min-sum decode (port of
projectultra_tpu/ops/ldpc.py; reference src/fec/ldpc_decoder.cpp:151-236).

The code graph is built on the host by the port's ``fec.ldpc`` and held
on the device by ``LDPCGraph`` as buffers.  ``decode`` runs the
hand-written CUDA kernel (``ops/cuda_ldpc.py``) for CUDA tensors and the
plain PyTorch version
``decode_plain`` for CPU tensors.  The plain version is also the oracle the
kernel is tested against on the card.

Arithmetic contract (identical to the JAX decoder in float32 messages, so
bits, ok flags and iteration counts agree lane for lane):

* two-minima min-sum per check row, first-occurrence argmin over the row's
  edges in their stored order, c2v = (sign * min_excl) * 0.75;
* v2c = clamp(llr_total[var] - c2v, -50, 50), except iteration 0 whose v2c
  is the unclamped channel LLR;
* llr_total = llr_in + c2v[e0] + c2v[e1] + ..., summed left to right over a
  variable's edges in ascending check order (``_var_edge_table``);
* iteration counts: 0-based iteration of convergence, else ``max_iters``;
  converged lanes are frozen.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..fec.ldpc import (DEFAULT_MAX_ITERS, LDPCCode, MIN_SUM_SCALE,
                        V2C_CLAMP)


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


class LDPCGraph(nn.Module):
    """One code rate's Tanner graph as device buffers.

    Buffers: ``h_t`` [k, m] f32 (H_data transposed, for encoding),
    ``row_vars`` [m, D] int32 and ``row_mask`` [m, D] bool (per-check edge
    lists, valid edges first), ``row_deg`` [m] int32, ``var_edges``
    [n, Dv] int32 (see ``_var_edge_table``); for the CUDA kernel, the same
    graph with its check rows sorted by degree (``sorted_row_vars``,
    ``sorted_row_deg``, ``sorted_var_edges``; see ``_sorted_rows``) and
    ``var_deg`` [n] int32, each variable's number of edges."""

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

def _c2v(graph: LDPCGraph, v2c: torch.Tensor) -> torch.Tensor:
    """[B, D, m] v2c -> [B, D, m] c2v (masked edges 0)."""
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
    out = []
    for d in range(D):
        sign = 1.0 - 2.0 * ((par ^ negs[d]) & 1).to(torch.float32)
        min_excl = torch.where(amin == d, min2, min1)
        out.append(torch.where(mask[d], sign * min_excl * MIN_SUM_SCALE, 0.0))
    return torch.stack(out, dim=1)


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


def _next_v2c(graph: LDPCGraph, llr_total: torch.Tensor, c2v: torch.Tensor):
    v = torch.clamp(llr_total[:, graph.row_vars.T] - c2v, -V2C_CLAMP, V2C_CLAMP)
    return torch.where(graph.row_mask.T, v, 0.0)


def _run_plain(graph: LDPCGraph, llr_in: torch.Tensor, max_iters: int):
    B = llr_in.shape[0]
    dev = llr_in.device
    if max_iters == 0:
        return (llr_in, torch.zeros(B, dtype=torch.bool, device=dev),
                torch.zeros(B, dtype=torch.int32, device=dev))
    # Iteration 0 is stateless: v2c is the (unclamped) channel LLR.
    v2c0 = torch.where(graph.row_mask.T, llr_in[:, graph.row_vars.T], 0.0)
    c2v = _c2v(graph, v2c0)
    llr_total, done = _llr_ok(graph, llr_in, c2v)
    iters = torch.where(done, 0, max_iters).to(torch.int32)
    if max_iters <= 1 or bool(done.all()):
        return llr_total, done, iters
    v2c = _next_v2c(graph, llr_total, c2v)
    it = 1
    while it < max_iters and not bool(done.all()):
        c2v = _c2v(graph, v2c)
        llr_new, ok = _llr_ok(graph, llr_in, c2v)
        v2c_new = _next_v2c(graph, llr_new, c2v)
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
                 trap_escape: bool = False):
    """Plain PyTorch flooding min-sum on any device.

    Returns (llr_total [B, n] f32, ok [B] bool, iters [B] int32)."""
    llr_in = llrs.to(torch.float32)
    llr_total, done, iters = _run_plain(graph, llr_in, max_iters)
    if trap_escape and not bool(done.all()):
        llr2 = trap_escape_llrs(graph, llr_in, llr_total)
        llr_t2, done2, iters2 = _run_plain(graph, llr2, max_iters)
        take = ~done & done2
        llr_total = torch.where(take[:, None], llr_t2, llr_total)
        iters = torch.where(take, iters2, iters)
        done = done | done2
    return llr_total, done, iters


def decode_totals(graph: LDPCGraph, llrs: torch.Tensor,
                  max_iters: int = DEFAULT_MAX_ITERS,
                  trap_escape: bool = False):
    """Device dispatch: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns (llr_total, ok, iters)."""
    if llrs.device.type == "cuda":
        from . import cuda_ldpc  # imports this module
        return cuda_ldpc.decode_cuda(graph, llrs, max_iters, trap_escape)
    if llrs.device.type != "cpu":
        raise ValueError(f"LDPC decode runs on cuda or cpu, not {llrs.device}")
    return decode_plain(graph, llrs, max_iters, trap_escape)


def decode(code: LDPCCode, llrs: torch.Tensor,
           max_iters: int = DEFAULT_MAX_ITERS, trap_escape: bool = False):
    """Flooding min-sum decode of [B, n] float32 LLRs (positive = bit 0).

    Returns info_bits [B, k] uint8, success [B] bool, iters [B] int32 with
    the JAX decoder's semantics (f32 messages; see the module docstring).
    """
    graph = graph_for(code, llrs.device)
    llr_total, ok, iters = decode_totals(graph, llrs, max_iters, trap_escape)
    return (llr_total[:, :code.k] < 0).to(torch.uint8), ok, iters


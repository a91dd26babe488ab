"""LDPC code tables, encoder and plain min-sum decoder of the reference.

Frozen copies (commit eda5b68) of ``projectultra_tpu_torch/fec/ldpc.py``
(the n = 648 code family H = [H_data | I], built from
``std::mt19937(0x12345678 + rate)`` with a manual Fisher-Yates shuffle) and
of the plain decoder of ``projectultra_tpu_torch/ops/ldpc.py``
(``decode_plain`` with float32 messages): flooding min-sum, 0.75 scaling,
v2c clamp +-50, hard-decision parity check each iteration, converged lanes
frozen, at most 50 iterations.  The iteration count is the 0-based
iteration of convergence, else 50.  Plain PyTorch on any device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .config import CodeRate
from .mt19937 import MT19937, fisher_yates_inplace

BLOCK_LENGTH = 648
CODE_PARAMS = {
    CodeRate.R1_4: (162, 486),
    CodeRate.R1_2: (324, 324),
    CodeRate.R2_3: (432, 216),
    CodeRate.R3_4: (486, 162),
    CodeRate.R5_6: (540, 108),
}
H_SEED_BASE = 0x12345678
MIN_SUM_SCALE = 0.75
V2C_CLAMP = 50.0
MAX_ITERS = 50


@functools.lru_cache(maxsize=None)
def build_h_rows(rate: CodeRate) -> tuple[tuple[int, ...], ...]:
    """Info-bit connections per check, in the reference's insertion order."""
    k, m = CODE_PARAMS[rate]
    rng = MT19937(H_SEED_BASE + int(rate))
    h_rows: list[list[int]] = [[] for _ in range(m)]
    check_deg = [0] * m
    target_check_degree = 4
    target_var_degree = max(3, (target_check_degree * m) // k)
    target_var_degree = min(target_var_degree, m // 2)
    max_check_degree = target_check_degree + 2
    for j in range(k):
        avail = [i for i in range(m) if check_deg[i] < max_check_degree]
        fisher_yates_inplace(rng, avail)
        for d in range(min(target_var_degree, len(avail))):
            c = avail[d]
            h_rows[c].append(j)
            check_deg[c] += 1
    for i in range(m):
        if not h_rows[i]:
            h_rows[i].append(rng() % k)
    return tuple(tuple(r) for r in h_rows)


@dataclasses.dataclass(frozen=True)
class Code:
    """One rate's tables: ``h_dense`` [m, k] float32, ``row_vars``/``row_mask``
    [m, D] (info edges in insertion order, then the identity edge) and
    ``var_edges`` [n, Dv] (each variable's edges in ascending check order,
    as indices d*m + i into the flat c2v space; D*m pads)."""
    rate: CodeRate
    k: int
    m: int
    n: int
    h_dense: np.ndarray
    row_vars: np.ndarray
    row_mask: np.ndarray
    var_edges: np.ndarray

    def __hash__(self):
        return hash(self.rate)

    def __eq__(self, other):
        return isinstance(other, Code) and self.rate == other.rate

    @property
    def edges(self) -> int:
        return int(self.row_mask.sum())


@functools.lru_cache(maxsize=None)
def get_code(rate: CodeRate) -> Code:
    k, m = CODE_PARAMS[rate]
    n = k + m
    rows = build_h_rows(rate)
    h_dense = np.zeros((m, k), dtype=np.float32)
    for i, r in enumerate(rows):
        for j in r:
            h_dense[i, j] = 1.0
    full_rows = [list(r) + [k + i] for i, r in enumerate(rows)]
    D = max(len(r) for r in full_rows)
    row_vars = np.zeros((m, D), dtype=np.int64)
    row_mask = np.zeros((m, D), dtype=bool)
    for i, r in enumerate(full_rows):
        row_vars[i, :len(r)] = r
        row_mask[i, :len(r)] = True
    lists: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for i in range(m):
        for d in range(D):
            if row_mask[i, d]:
                lists[int(row_vars[i, d])].append((i, d))
    Dv = max(len(l) for l in lists)
    var_edges = np.full((n, Dv), D * m, np.int64)
    for v, l in enumerate(lists):
        for j, (i, d) in enumerate(sorted(l)):
            var_edges[v, j] = d * m + i
    return Code(rate, k, m, n, h_dense, row_vars, row_mask, var_edges)


class Graph:
    """A code's tables as tensors on one device."""

    def __init__(self, code: Code, device: torch.device):
        self.code = code
        self.k, self.m, self.n = code.k, code.m, code.n
        self.h_t = torch.from_numpy(np.ascontiguousarray(code.h_dense.T)) \
            .to(device)
        self.row_vars = torch.from_numpy(code.row_vars).to(device)
        self.row_mask = torch.from_numpy(code.row_mask).to(device)
        self.var_edges = torch.from_numpy(code.var_edges).to(device)


def encode(graph: Graph, info_bits: torch.Tensor) -> torch.Tensor:
    """[B, k] {0,1} -> [B, n] codewords, float32."""
    info = info_bits.to(torch.float32)
    parity = torch.remainder(info @ graph.h_t, 2.0)
    return torch.cat([info, parity], dim=-1)


def _c2v(graph: Graph, v2c: torch.Tensor) -> torch.Tensor:
    """[B, D, m] v2c -> [B, D, m] c2v: two minima with a first-occurrence
    argmin, sign parity, (sign * min_excl) * 0.75; masked edges 0."""
    mask = graph.row_mask.T
    B, D, m = v2c.shape
    inf = torch.full((), float("inf"), dtype=torch.float32, device=v2c.device)
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


def _totals(graph: Graph, llr_in: torch.Tensor, c2v: torch.Tensor):
    """(llr_total [B, n], parity ok [B]): per-variable sums in ascending
    check order, then the syndrome of the hard decision."""
    B = llr_in.shape[0]
    ce = torch.cat([c2v.reshape(B, -1),
                    torch.zeros((B, 1), dtype=torch.float32,
                                device=llr_in.device)], dim=1)
    total = llr_in
    for j in range(graph.var_edges.shape[1]):
        total = total + ce[:, graph.var_edges[:, j]]
    hard = (total < 0)[:, graph.row_vars] & graph.row_mask
    ok = ~((hard.to(torch.int32).sum(-1) & 1) == 1).any(-1)
    return total, ok


def _next_v2c(graph: Graph, total: torch.Tensor, c2v: torch.Tensor):
    v = torch.clamp(total[:, graph.row_vars.T] - c2v, -V2C_CLAMP, V2C_CLAMP)
    return torch.where(graph.row_mask.T, v, 0.0)


def decode(graph: Graph, llrs: torch.Tensor, max_iters: int = MAX_ITERS):
    """[B, n] channel LLRs (positive = bit 0) -> (llr_total [B, n] float32,
    ok [B] bool, iters [B] int32)."""
    llr_in = llrs.to(torch.float32)
    v2c = torch.where(graph.row_mask.T, llr_in[:, graph.row_vars.T], 0.0)
    c2v = _c2v(graph, v2c)
    total, done = _totals(graph, llr_in, c2v)
    iters = torch.where(done, 0, max_iters).to(torch.int32)
    if bool(done.all()):
        return total, done, iters
    v2c = _next_v2c(graph, total, c2v)
    it = 1
    while it < max_iters and not bool(done.all()):
        c2v = _c2v(graph, v2c)
        new_total, ok = _totals(graph, llr_in, c2v)
        new_v2c = _next_v2c(graph, new_total, c2v)
        v2c = torch.where(done[:, None, None], v2c, new_v2c)
        total = torch.where(done[:, None], total, new_total)
        iters = torch.where(~done & ok, it, iters).to(torch.int32)
        done = done | ok
        it += 1
    return total, done, iters

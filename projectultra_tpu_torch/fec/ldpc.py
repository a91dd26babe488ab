"""LDPC code construction (host tables of the port's encoder and decoder).

Reproduces the reference's n=648 systematic LDPC family H = [H_data | I]
bit-exactly (reference: src/fec/ldpc_encoder.cpp:38-128,
src/fec/ldpc_decoder.cpp:64-137):

* rates R1/4..R5/6 with k = 162/324/432/486/540 info bits,
* H_data built by a seeded pseudo-random construction driven by
  ``std::mt19937(0x12345678 + rate)`` with a manual Fisher-Yates shuffle
  (deliberately not std::shuffle, for cross-compiler determinism),
* parity bits = XOR of connected info bits.

The graph is built once on the host (numpy + exact MT19937) and held on
the device by ``ops/ldpc.LDPCGraph``:

* ``h_dense``       [m, k]  — batched encoding (parity = info @ h_dense.T
                               mod 2),
* ``row_vars/mask`` [m, D]  — padded per-check edge lists (info edges in
                               insertion order, then the identity edge) for
                               the flooding min-sum decoder in ops/ldpc.py.

Decode semantics match src/fec/ldpc_decoder.cpp:153-259: min-sum with 0.75
scaling, v->c clamp +-50, hard-decision parity check each iteration, early
exit, max 50 iterations.

The port's copy of the JAX package's code tables and numpy encoders,
pinned equal to them for every rate by ``tests/test_torch_host.py`` and
``tests/test_torch_protocol.py``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..config import CodeRate
from ..utils.mt19937 import MT19937, fisher_yates_inplace

BLOCK_LENGTH = 648  # n for every rate

#: rate -> (info_bits k, parity_bits m)  (ldpc_encoder.cpp:38-53)
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
DEFAULT_MAX_ITERS = 50
HARD_LLR = 6.0  # LLR magnitude for hard-decision decode input


def _params(rate: CodeRate) -> tuple[int, int]:
    # Unknown rates fall back to R1/2, matching getCodeParams' default.
    return CODE_PARAMS.get(rate, CODE_PARAMS[CodeRate.R1_2])


@functools.lru_cache(maxsize=None)
def build_h_rows(rate: CodeRate) -> tuple[tuple[int, ...], ...]:
    """Info-bit connections per check, in the exact insertion order the
    reference produces (order matters only for edge-array layout; the code
    itself is order-independent)."""
    k, m = _params(rate)
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
        connections = min(target_var_degree, len(avail))
        for d in range(connections):
            c = avail[d]
            h_rows[c].append(j)
            check_deg[c] += 1

    for i in range(m):
        if not h_rows[i]:
            h_rows[i].append(rng() % k)

    return tuple(tuple(r) for r in h_rows)


@dataclasses.dataclass(frozen=True)
class LDPCCode:
    """Host-side constant bundle for one code rate."""
    rate: CodeRate
    k: int
    m: int
    n: int
    h_dense: np.ndarray    # [m, k] float32 0/1 (H_data part only)
    row_vars: np.ndarray   # [m, D] int32 variable index per edge (pad: 0)
    row_mask: np.ndarray   # [m, D] bool
    max_degree: int

    def __hash__(self):
        return hash((self.rate, self.k, self.m))

    def __eq__(self, other):
        return isinstance(other, LDPCCode) and self.rate == other.rate


@functools.lru_cache(maxsize=None)
def get_code(rate: CodeRate) -> LDPCCode:
    k, m = _params(rate)
    n = k + m
    rows = build_h_rows(rate)

    h_dense = np.zeros((m, k), dtype=np.float32)
    for i, r in enumerate(rows):
        for j in r:
            h_dense[i, j] = 1.0

    # Full graph rows: info edges then the identity edge (parity var k+i),
    # matching the decoder's H_rows layout (ldpc_decoder.cpp:124-128).
    full_rows = [list(r) + [k + i] for i, r in enumerate(rows)]
    max_deg = max(len(r) for r in full_rows)
    row_vars = np.zeros((m, max_deg), dtype=np.int32)
    row_mask = np.zeros((m, max_deg), dtype=bool)
    for i, r in enumerate(full_rows):
        row_vars[i, :len(r)] = r
        row_mask[i, :len(r)] = True

    return LDPCCode(rate=rate, k=k, m=m, n=n, h_dense=h_dense,
                    row_vars=row_vars, row_mask=row_mask, max_degree=max_deg)


# ---------------------------------------------------------------------------
# Host encoders (numpy, non-batched): the engine's non-frame TX path.
# ---------------------------------------------------------------------------

def encode_block_np(code: LDPCCode, info_bits: np.ndarray) -> np.ndarray:
    """One codeword: [k] bits -> [n] bits."""
    info = np.asarray(info_bits, dtype=np.uint8)
    parity = (code.h_dense.astype(np.uint8) @ info) & 1
    return np.concatenate([info, parity])


def encode_bytes_np(code: LDPCCode, data: bytes) -> bytes:
    """Multi-block bit-level encode (ldpc_encoder.cpp:193-257): input bits are
    consumed k at a time (zero-padded at the end); each n-bit codeword is
    emitted MSB-first and the final partial byte is left-shifted."""
    from ..utils.bits import bytes_to_bits, bits_to_bytes
    all_bits = bytes_to_bits(data)
    out_bits = []
    off = 0
    while off < len(all_bits):
        blk = np.zeros(code.k, dtype=np.uint8)
        take = min(code.k, len(all_bits) - off)
        blk[:take] = all_bits[off:off + take]
        out_bits.append(encode_block_np(code, blk))
        # n = 648 is a multiple of 8 for every rate, so concatenating the
        # codewords equals the reference's per-codeword byte packing.
        off += code.k
    return bits_to_bytes(np.concatenate(out_bits)) if out_bits else b""


def coded_size(code: LDPCCode, input_size: int) -> int:
    """(ldpc_encoder.cpp:259-268)"""
    input_bits = input_size * 8
    num_blocks = (input_bits + code.k - 1) // code.k
    return (num_blocks * code.n + 7) // 8


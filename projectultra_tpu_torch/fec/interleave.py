"""Channel-interleaver permutations (numpy), re-homed from the JAX package.

``projectultra_tpu.fec.interleave`` imports ``utils.bits``, which tries to
import jax, so the port carries its own copy of the permutation builder
(ldpc_decoder.cpp:547-672).  Tests pin it array-equal to the original and
to the reference golden dump.
"""

from __future__ import annotations

import functools
import math

import numpy as np


def find_coprime_step(n: int, total: int) -> int:
    """Smallest step >= 3n (or total/2 fallback) coprime with total."""
    target = n * 3
    if target >= total:
        target = total // 2
    for step in range(target, total):
        if math.gcd(step, total) == 1:
            return step
    for step in range(n + 1, total):
        if math.gcd(step, total) == 1:
            return step
    return n + 1


class ChannelInterleaver:
    """Coprime-stride time-frequency interleaver: interleave writes
    ``out[perm[i]] = in[i]``; ``inv`` is the inverse permutation."""

    def __init__(self, bits_per_symbol: int, total_bits: int = 648):
        self.bits_per_symbol = bits_per_symbol
        self.total_bits = total_bits
        step = find_coprime_step(bits_per_symbol, total_bits)
        self.symbol_separation = max(1, step // bits_per_symbol)
        i = np.arange(total_bits, dtype=np.int64)
        self.perm = (i * step) % total_bits
        self.inv = np.empty(total_bits, dtype=np.int64)
        self.inv[self.perm] = i


@functools.lru_cache(maxsize=None)
def channel_interleaver(bits_per_symbol: int,
                        total_bits: int = 648) -> ChannelInterleaver:
    return ChannelInterleaver(bits_per_symbol, total_bits)

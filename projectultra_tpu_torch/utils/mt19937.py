"""Exact MT19937 (32-bit Mersenne Twister), vectorized with numpy.

The reference framework derives its LDPC parity-check matrices and OFDM pilot
sequences from ``std::mt19937`` streams with fixed seeds (reference:
src/fec/ldpc_encoder.cpp:77, src/ofdm/modulator.cpp:39,197).  Bit-exact
reproduction of those streams is required for interoperability and BER/FER
parity, so we implement the generator directly instead of relying on any
library RNG whose seeding/extraction order might differ.

Host-side only: this feeds *constant* tables (H matrices, pilot signs) that
the port holds on the device as buffers.  The port's copy of the JAX
package's generator, pinned to it by ``tests/test_torch_host.py``.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = np.uint32(0x9908B0DF)
_UPPER = np.uint32(0x80000000)
_LOWER = np.uint32(0x7FFFFFFF)


class MT19937:
    """Drop-in equivalent of ``std::mt19937`` seeded with a single uint32."""

    def __init__(self, seed: int):
        mt = np.empty(_N, dtype=np.uint64)
        mt[0] = seed & 0xFFFFFFFF
        for i in range(1, _N):
            prev = mt[i - 1]
            mt[i] = (np.uint64(1812433253) * (prev ^ (prev >> np.uint64(30)))
                     + np.uint64(i)) & np.uint64(0xFFFFFFFF)
        self._mt = mt.astype(np.uint32)
        self._buf = np.empty(0, dtype=np.uint32)
        self._pos = 0

    def _twist(self) -> None:
        old = self._mt
        new = np.empty_like(old)

        def f(hi, lo):
            y = (hi & _UPPER) | (lo & _LOWER)
            mag = np.where((y & np.uint32(1)).astype(bool), _MATRIX_A, np.uint32(0))
            return (y >> np.uint32(1)) ^ mag

        # i in [0, 227): mt[i+M] not yet rewritten this round.
        new[0:227] = old[397:624] ^ f(old[0:227], old[1:228])
        # i in [227, 454): depends on new[0:227].
        new[227:454] = new[0:227] ^ f(old[227:454], old[228:455])
        # i in [454, 623): depends on new[227:396].
        new[454:623] = new[227:396] ^ f(old[454:623], old[455:624])
        # i = 623 wraps to new[0].
        new[623] = new[396] ^ f(old[623:624], new[0:1])[0]

        self._mt = new
        # Tempering for the whole block at once.
        y = new.copy()
        y ^= y >> np.uint32(11)
        y ^= (y << np.uint32(7)) & np.uint32(0x9D2C5680)
        y ^= (y << np.uint32(15)) & np.uint32(0xEFC60000)
        y ^= y >> np.uint32(18)
        self._buf = y
        self._pos = 0

    def __call__(self) -> int:
        if self._pos >= self._buf.shape[0]:
            self._twist()
        v = int(self._buf[self._pos])
        self._pos += 1
        return v

    def raw(self, n: int) -> np.ndarray:
        """Return the next ``n`` raw 32-bit outputs as a uint32 array."""
        out = np.empty(n, dtype=np.uint32)
        filled = 0
        while filled < n:
            if self._pos >= self._buf.shape[0]:
                self._twist()
            take = min(n - filled, self._buf.shape[0] - self._pos)
            out[filled:filled + take] = self._buf[self._pos:self._pos + take]
            self._pos += take
            filled += take
        return out


def fisher_yates_inplace(rng: MT19937, arr: list) -> None:
    """The reference's manual Fisher-Yates shuffle (ldpc_encoder.cpp:108-111).

    Deliberately uses ``rng() % i`` draws (not std::shuffle) for
    cross-implementation determinism; we reproduce it exactly.
    """
    for i in range(len(arr), 1, -1):
        j = rng() % i
        arr[i - 1], arr[j] = arr[j], arr[i - 1]

"""The benchmark's arithmetic: the card's peaks, the kernels' bounds, and
the readings of a profiler trace.

Frozen copies (commit eda5b68) of ``chip_smoke.py``'s yardstick, so that a
later change to the program cannot move it:

* ``PEAK_BYTES_PER_S``, ``PEAK_F32_OPS_PER_S`` (chip_smoke.py:350-351),
  ``LDPC_OPS_PER_EDGE`` (:356), ``SC_OPS_PER_SAMPLE`` (:359),
  ``DPSK_OPS_PER_SAMPLE`` and ``DPSK_OPS_PER_OFFSET`` (:365-366);
* ``bound`` (:489), ``ldpc_bound`` (:511), ``sc_bound`` (:524) and
  ``dpsk_bound`` (:534); ``ldpc_bound`` takes the iterations each lane ran
  (``ldpc_passes``) from the timed batches' own decoder output, where
  ``chip_smoke.ldpc_passes`` decoded a second time to count them;
* ``busy_ns``, the union of the device intervals, from ``busy_ms``
  (:668, behind ``profile_busy_ms``, :652); ``kernel_ns``, the device time
  of the kernels whose names hold a kernel's event name (``device_ms``,
  :608, with ``KERNEL_EVENT``, :549), summed instead of averaged.

Every function here is plain Python on numbers (``ldpc_passes``: on a
tensor), so the tests check it by hand.
"""

from __future__ import annotations

import statistics

import torch

# The card's published peaks (H100 SXM, 700 W): a kernel's bound is the
# larger of its bytes over the memory rate and its operations over the
# float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# float32 operations per edge and iteration of the min-sum decoder: v2c
# (sub, 2 clamps), two-minima update (abs, 2 compares, 3 selects), c2v
# (select, sign, scale), the variable sum's add and the syndrome's
# compare and xor.
LDPC_OPS_PER_EDGE = 14
# float32 operations per sample of the Schmidl-Cox window pre-reduction.
SC_OPS_PER_SAMPLE = 12
# float32 operations of DPSK's preamble score, per sample and per offset.
DPSK_OPS_PER_SAMPLE = 5 + 18
DPSK_OPS_PER_OFFSET = 76 + 38 + 4 + 2
DPSK_PAIRS = 38

#: The name a kernel's device events carry.
KERNEL_EVENT = {"ldpc_minsum": "ldpc_minsum_kernel",
                "sc_windows": "sc_windows_kernel",
                "dpsk_score": "dpsk_score_kernel"}


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ldpc_passes(iters, max_iters: int = 50):
    """Iterations each lane ran, from the decoder's iteration counts (a
    tensor): iters + 1 for a lane that converged (iters is the 0-based
    iteration of convergence), max_iters for one that did not (its count
    reads max_iters).  A lane whose chirp was not found still ran the
    decoder, so its own count, and not the frame's ok flag, decides."""
    return torch.where(iters < max_iters, iters + 1, max_iters)


def ldpc_bound(lanes: int, n: int, edges: int, passes: float):
    """The decoder's bound on one batch: ``lanes`` lanes of ``n`` LLRs read
    once, totals, ok and iters written once; LDPC_OPS_PER_EDGE per edge for
    each of the ``passes`` iterations the batch's lanes ran in all.
    Returns (ms, basis)."""
    n_bytes = lanes * n * 4 * 2 + lanes * (1 + 4)
    return bound(n_bytes, float(passes) * edges * LDPC_OPS_PER_EDGE)


def sc_bound(B: int, half: int, stride: int, G: int):
    """The window sums' bound (not on a path of this benchmark's cells)."""
    span = stride * (G - 1) + 2 * half
    n_bytes = B * span * 8 + B * G * (8 + 4 + 4)
    n_ops = B * (span * SC_OPS_PER_SAMPLE + G * 4 * (half // stride))
    return bound(n_bytes, n_ops)


def dpsk_bound(B: int, L: int, O: int):
    """DPSK's score bound (not on a path of this benchmark's cells)."""
    span = O + DPSK_PAIRS * L
    return bound(B * span * 8 + B * O * 4,
                 B * span * DPSK_OPS_PER_SAMPLE + B * O * DPSK_OPS_PER_OFFSET)


def merged(intervals) -> list[tuple[int, int]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clipped(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """Each interval cut to [lo, hi]; those outside dropped."""
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def busy_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of the device intervals inside [lo, hi]."""
    return sum(b - a for a, b in merged(clipped(intervals, lo, hi)))


def idle_gaps(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The stretches of [lo, hi] that no device interval covers."""
    gaps, cur = [], lo
    for a, b in merged(clipped(intervals, lo, hi)):
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if cur < hi:
        gaps.append((cur, hi))
    return gaps


def kernel_ns(events, kernel: str) -> int:
    """Device time of the (name, start, end) events whose names hold the
    kernel's event name."""
    return sum(b - a for name, a, b in events if KERNEL_EVENT[kernel] in name)


def percentile(values, q: int) -> float:
    """The q-th percentile of ``values`` (Python's inclusive method, as
    ``statistics.quantiles(values, n=100, method="inclusive")``)."""
    vals = list(values)
    if len(vals) == 1:
        return float(vals[0])
    return statistics.quantiles(vals, n=100, method="inclusive")[q - 1]

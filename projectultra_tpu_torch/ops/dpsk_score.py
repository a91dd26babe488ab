"""The differential pattern score of DPSK's preamble search
(computeDifferentialScore, dpsk.hpp:487-546), the inner part of
``psk/dpsk.py::find_preamble``.

For row b of the per-offset symbol correlations ``corr`` [B, n_corr] and
offset o < O, symbol j of offset o is corr[b, o + j*L] (j < n_sym), and

* dn_j  = d / |d| for the differential d = c_j * conj(c_{j-1}) where
  |d| > 1e-10, else 0 (j = 1 .. n_sym - 1);
* score = |sum_j expected[j-1] * dn_j| / (n_sym - 1), summed from j = 1
  upward, where the energy sum_j |c_j|^2 (from j = 0 upward) is at least
  ``min_energy * n_sym``, else 0.

The JAX package computes it as one XLA fusion over a gathered
[B, O, n_sym] grid (projectultra_tpu/psk/dpsk.py:305-317).
``dpsk_score`` runs the hand-written CUDA kernel (``ops/cuda_dpsk.py``,
``csrc/dpsk_score.cu``) for CUDA tensors and the plain PyTorch version
``dpsk_score_plain`` for CPU tensors; the plain version is also the
oracle the kernel is held to on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import host_table


def check_args(corr: torch.Tensor, L: int, n_sym: int, O: int,
               expected) -> np.ndarray:
    """Raise ValueError unless every symbol of the O offsets lies in
    corr's rows and ``expected`` holds n_sym - 1 signs (+-1: a sign flip
    is exact, which the kernel's signed sums rely on); returns the signs
    as float32."""
    if corr.dim() != 2:
        raise ValueError(f"corr must be [B, n_corr], got {tuple(corr.shape)}")
    signs = np.asarray(expected, dtype=np.float32)
    if L < 1 or n_sym < 2 or signs.shape != (n_sym - 1,):
        raise ValueError(f"L={L} and n_sym={n_sym} need n_sym - 1 signs, got "
                         f"shape {signs.shape}")
    if not np.all(np.abs(signs) == 1.0):
        raise ValueError(f"expected must hold +-1 signs, got {signs}")
    if O < 0 or (O and O - 1 + (n_sym - 1) * L >= corr.shape[1]):
        raise ValueError(f"O={O} offsets of {n_sym} symbols of {L} samples "
                         f"overrun n_corr={corr.shape[1]}")
    return signs


def _signs(values: tuple) -> np.ndarray:
    return np.asarray(values, dtype=np.float32)


def dpsk_score_plain(corr: torch.Tensor, L: int, n_sym: int, O: int,
                     expected, min_energy: float) -> torch.Tensor:
    """Plain PyTorch score of a [B, n_corr] complex correlation -> [B, O]
    float32: every term is one shifted [B, O] slice, accumulated symbol
    by symbol."""
    signs = check_args(corr, L, n_sym, O, expected)
    B, dev = corr.shape[0], corr.device
    exp_t = host_table(dev, _signs, tuple(signs.tolist()))
    acc = torch.zeros((B, O), dtype=torch.complex64, device=dev)
    prev = corr[:, :O]
    energy = prev.abs() ** 2
    for j in range(1, n_sym):
        cur = corr[:, j * L:j * L + O]
        diff = cur * prev.conj()
        mag = diff.abs()
        dn = torch.where(mag > 1e-10, diff / torch.clamp(mag, min=1e-30),
                         0.0)
        acc = acc + dn * exp_t[j - 1]
        energy = energy + cur.abs() ** 2
        prev = cur
    score = acc.abs() / (n_sym - 1)
    return torch.where(energy >= min_energy * n_sym, score, 0.0)


def dpsk_score(corr: torch.Tensor, L: int, n_sym: int, O: int, expected,
               min_energy: float) -> torch.Tensor:
    """Device dispatch: the CUDA kernel for CUDA tensors ([B, n_corr]
    complex64), the plain version for CPU tensors.  ``expected`` is a
    host sequence of the n_sym - 1 signs.  Returns score [B, O]."""
    if corr.device.type == "cuda":
        from . import cuda_dpsk  # imports this module
        return cuda_dpsk.dpsk_score_cuda(corr, L, n_sym, O, expected,
                                         min_energy)
    if corr.device.type != "cpu":
        raise ValueError(f"dpsk_score runs on cuda or cpu, not {corr.device}")
    return dpsk_score_plain(corr, L, n_sym, O, expected, min_energy)

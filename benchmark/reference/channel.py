"""The harness AWGN channel of the reference: a frozen copy (commit eda5b68)
of ``projectultra_tpu_torch/sim/watterson.add_noise_with`` and
``analytic_mult``."""

from __future__ import annotations

import functools

import numpy as np
import torch


def add_noise_with(samples: torch.Tensor, snr_db: float,
                   noise: torch.Tensor) -> torch.Tensor:
    """samples + noise_std * noise, the signal power measured per frame
    over its active samples (|s| > 1e-6)."""
    active = samples.abs() > 1e-6
    power = torch.where(active, samples * samples, 0.0).sum(-1) \
        / torch.clamp(active.sum(-1), min=1)
    snr_lin = 10.0 ** (torch.as_tensor(snr_db, dtype=torch.float32) / 10.0)
    noise_std = torch.sqrt(power / snr_lin)
    return samples + noise_std[..., None] * noise


@functools.lru_cache(maxsize=None)
def analytic_mult(n_fft: int, device: torch.device) -> torch.Tensor:
    """The analytic-signal mask: DC kept, positive frequencies doubled,
    negative ones zeroed (float32 [n_fft])."""
    mult = np.ones(n_fft, np.float32)
    mult[1:n_fft // 2] = 2.0
    mult[n_fft // 2 + 1:] = 0.0
    return torch.from_numpy(mult).to(device)

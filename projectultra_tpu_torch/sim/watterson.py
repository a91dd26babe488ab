"""Harness AWGN of the channel simulator (port of
projectultra_tpu/sim/watterson.py::add_noise_active; reference
tools/test_iwaveform.cpp:42-63).

The noise draw is split from the arithmetic: ``add_noise_with`` is the
deterministic core that takes the unit-variance noise as an argument (the
tests feed it the exact array ``jax.random`` drew), and
``add_noise_active`` draws that noise with ``torch.randn`` from an explicit
generator on the samples' device.
"""

from __future__ import annotations

import torch


def add_noise_with(samples: torch.Tensor, snr_db,
                   noise: torch.Tensor) -> torch.Tensor:
    """samples + noise_std * noise, with the signal power measured over
    active samples only (|s| > 1e-6), per frame along the last axis."""
    active = samples.abs() > 1e-6
    power = torch.where(active, samples * samples, 0.0).sum(-1) \
        / torch.clamp(active.sum(-1), min=1)
    # A scalar SNR stays a host scalar: copying it to the device would
    # synchronise the stream.
    snr_lin = 10.0 ** (torch.as_tensor(snr_db, dtype=torch.float32) / 10.0)
    noise_std = torch.sqrt(power / snr_lin)
    return samples + noise_std[..., None] * noise


def add_noise_active(samples: torch.Tensor, snr_db,
                     generator: torch.Generator) -> torch.Tensor:
    """Harness AWGN at ``snr_db`` with standard-normal noise drawn from
    ``generator`` (which must live on the samples' device)."""
    noise = torch.randn(samples.shape, generator=generator,
                        dtype=torch.float32, device=samples.device)
    return add_noise_with(samples, snr_db, noise)

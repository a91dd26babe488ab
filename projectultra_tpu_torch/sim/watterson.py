"""Harness AWGN and CFO of the channel simulator (port of
projectultra_tpu/sim/watterson.py::add_noise_active and
apply_cfo_hilbert; reference tools/test_iwaveform.cpp:42-112).

The noise draw is split from the arithmetic: ``add_noise_with`` is the
deterministic core that takes the unit-variance noise as an argument (the
tests feed it the exact array ``jax.random`` drew), and
``add_noise_active`` draws that noise with ``torch.randn`` from an explicit
generator on the samples' device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import mixer as mixer_ops


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


@functools.lru_cache(maxsize=None)
def _analytic_mult(n_fft: int, device: torch.device) -> torch.Tensor:
    """The harness's analytic-signal mask: DC kept, positive frequencies
    doubled, negative ones zeroed; made once per device."""
    mult = np.ones(n_fft, np.float32)
    mult[1:n_fft // 2] = 2.0
    mult[n_fft // 2 + 1:] = 0.0
    return torch.from_numpy(mult).to(device)


def apply_cfo_hilbert(samples: torch.Tensor, cfo_hz,
                      sample_rate: float = 48000.0) -> torch.Tensor:
    """Test-harness CFO: FFT at the next power of two -> analytic signal ->
    rotate by exp(j*2*pi*cfo*t/fs) -> real part.  Batched over leading
    axes; ``cfo_hz`` is a Python number or a per-frame float tensor, and a
    frame whose |cfo| <= 0.001 Hz is returned unchanged."""
    T = samples.shape[-1]
    n_fft = 1 << (T - 1).bit_length()
    dev = samples.device
    # A Python number becomes a device fill, not a synchronising copy.
    cfo = (cfo_hz.to(torch.float32) if isinstance(cfo_hz, torch.Tensor)
           else torch.full((), float(np.float32(cfo_hz)), device=dev))
    x = torch.fft.fft(samples.to(torch.complex64), n=n_fft, dim=-1)
    analytic = torch.fft.ifft(x * _analytic_mult(n_fft, dev), dim=-1)[..., :T]
    rot = mixer_ops.osc_traced(cfo[..., None], int(sample_rate),
                               torch.arange(T, dtype=torch.int32, device=dev))
    out = (analytic * rot).real
    return torch.where(cfo.abs()[..., None] > 0.001, out, samples)

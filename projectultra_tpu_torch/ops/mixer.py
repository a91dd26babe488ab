"""NCO phase ramps (port of projectultra_tpu/ops/mixer.py).

* ``osc_fixed``: host constant table, float64 phase, complex64 out — the
  TX and analysis oscillators are baked into constant tensors.
* ``osc_int``: exp(+j*2*pi*fc*t/fs) for integer fc, fs with the phase
  numerator computed in int32-modular arithmetic, so every phase is exact
  (requires fc*fs < 2^31).
* ``osc_traced``: exp(+j*2*pi*f*t/fs) for a float (possibly per-frame)
  frequency with the split-index float32 phase t = q*fs + r,
  frac(f*t/fs) = frac(f*q) + f*r/fs, which keeps every intermediate small.
"""

from __future__ import annotations

import numpy as np
import torch

TWO_PI = np.float32(2.0 * np.pi)


def osc_fixed(freq_hz: float, sample_rate: float, n: int,
              offset: int = 0) -> np.ndarray:
    """Host-side constant oscillator table (float64 phase, complex64 out)."""
    t = np.arange(offset, offset + n, dtype=np.float64)
    phase = np.mod(2.0 * np.pi * freq_hz * t / sample_rate, 2.0 * np.pi)
    return np.exp(1j * phase).astype(np.complex64)


def osc_int_phase(freq_hz: int, sample_rate: int,
                  t: torch.Tensor) -> torch.Tensor:
    """float32 phase 2*pi*((fc * (t mod fs)) mod fs)/fs of int32 indices t."""
    t = t.to(torch.int32)
    tm = torch.remainder(t, sample_rate)
    num = torch.remainder(freq_hz * tm, sample_rate)
    return float(TWO_PI) * num.to(torch.float32) / float(np.float32(sample_rate))


def osc_int(freq_hz: int, sample_rate: int, t: torch.Tensor) -> torch.Tensor:
    """exp(+j*2*pi*fc*t/fs) as complex64 for integer fc, fs and int32 t."""
    phase = osc_int_phase(freq_hz, sample_rate, t)
    return torch.polar(torch.ones_like(phase), phase)


def osc_traced(freq_hz, sample_rate: int, t: torch.Tensor) -> torch.Tensor:
    """exp(+j*2*pi*f*t/fs) as complex64 for a float frequency (a Python
    number or a float32 tensor broadcasting against t) and int32 t."""
    t = t.to(torch.int32)
    q = torch.div(t, sample_rate, rounding_mode="floor").to(torch.float32)
    r = torch.remainder(t, sample_rate).to(torch.float32)
    f = (freq_hz.to(torch.float32) if isinstance(freq_hz, torch.Tensor)
         else float(np.float32(freq_hz)))
    cycles = torch.remainder(f * q, 1.0) + f * r / float(np.float32(sample_rate))
    phase = float(TWO_PI) * torch.remainder(cycles, 1.0)
    return torch.polar(torch.ones_like(phase), phase)

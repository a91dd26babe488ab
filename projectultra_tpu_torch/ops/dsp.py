"""L1 DSP primitives: FIR/biquad filters, resampler, AGC, Hilbert, windows.

Reference: include/ultra/dsp.hpp + src/dsp/{filters.cpp, resampler.cpp}.
Design: filter DESIGN runs on host (numpy constants); filter APPLICATION is
batched device convolution/scan.  The reference's stateful sample-at-a-time
classes become stateless array transforms (state in, state out).

The port of the JAX package's module: the designers are numpy copies; the
transforms run on the device of their input tensor.  The biquad is linear,
so it runs as a blocked scan (contractions against powers of its state
matrix, in float64: a pole near the unit circle makes the zero-start block
sums cancel); the AGC's clipped gain update is not, so it stays a loop
over time, vectorised over rows.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Window functions (dsp.hpp:196-198, filters.cpp createWindow)
# ---------------------------------------------------------------------------

def window(size: int, kind: str = "hann") -> np.ndarray:
    n = np.arange(size, dtype=np.float64)
    if kind == "hann":
        w = 0.5 * (1 - np.cos(2 * np.pi * n / (size - 1)))
    elif kind == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * n / (size - 1))
    elif kind == "blackman":
        w = (0.42 - 0.5 * np.cos(2 * np.pi * n / (size - 1))
             + 0.08 * np.cos(4 * np.pi * n / (size - 1)))
    elif kind == "kaiser":
        w = np.kaiser(size, 8.6)
    else:
        raise ValueError(kind)
    return w.astype(np.float32)


# ---------------------------------------------------------------------------
# FIR design (windowed sinc, FIRFilter::lowpass/highpass/bandpass)
# ---------------------------------------------------------------------------

def fir_lowpass(taps: int, cutoff: float, sample_rate: float) -> np.ndarray:
    if taps % 2 == 0:
        taps += 1
    M = taps - 1
    fc = cutoff / sample_rate
    n = np.arange(taps, dtype=np.float64) - M / 2
    h = 2 * fc * np.sinc(2 * fc * n)
    h *= np.hamming(taps)
    return (h / h.sum()).astype(np.float32)


def fir_highpass(taps: int, cutoff: float, sample_rate: float) -> np.ndarray:
    if taps % 2 == 0:
        taps += 1
    lp = fir_lowpass(taps, cutoff, sample_rate)
    h = -lp
    h[(taps - 1) // 2] += 1.0
    return h.astype(np.float32)


def fir_bandpass(taps: int, low: float, high: float,
                 sample_rate: float) -> np.ndarray:
    if taps % 2 == 0:
        taps += 1
    lp_hi = fir_lowpass(taps, high, sample_rate)
    lp_lo = fir_lowpass(taps, low, sample_rate)
    return (lp_hi - lp_lo).astype(np.float32)


def fir_apply(samples: torch.Tensor, coeffs: np.ndarray) -> torch.Tensor:
    """Causal FIR along the last axis (same semantics as the reference's
    delay-line loop: y[n] = sum_k h[k] x[n-k]); batched FFT convolution."""
    T = samples.shape[-1]
    L = len(coeffs)
    n_fft = 1 << int(T + L - 2).bit_length()
    X = torch.fft.rfft(samples, n=n_fft, dim=-1)
    H = torch.fft.rfft(torch.from_numpy(np.asarray(coeffs, np.float32)).to(
        samples.device), n=n_fft)
    return torch.fft.irfft(X * H, n=n_fft, dim=-1)[..., :T].to(samples.dtype)


# ---------------------------------------------------------------------------
# Biquad (BiquadFilter, filters.cpp:120-190) — linear recurrence, blocked
# ---------------------------------------------------------------------------

def biquad_lowpass(freq: float, q: float, sample_rate: float):
    w0 = 2 * math.pi * freq / sample_rate
    alpha = math.sin(w0) / (2 * q)
    cw = math.cos(w0)
    b0, b1, b2 = (1 - cw) / 2, 1 - cw, (1 - cw) / 2
    a0, a1, a2 = 1 + alpha, -2 * cw, 1 - alpha
    return np.array([b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0], np.float32)


def biquad_highpass(freq: float, q: float, sample_rate: float):
    w0 = 2 * math.pi * freq / sample_rate
    alpha = math.sin(w0) / (2 * q)
    cw = math.cos(w0)
    b0, b1, b2 = (1 + cw) / 2, -(1 + cw), (1 + cw) / 2
    a0, a1, a2 = 1 + alpha, -2 * cw, 1 - alpha
    return np.array([b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0], np.float32)


SCAN_BLOCK = 128


@functools.lru_cache(maxsize=None)
def _powers(A: tuple, n: int, device: torch.device):
    """(M [n, n, 2, 2], P [n + 1, 2, 2]) float64 with P[k] = A^k and
    M[j, i] = A^(j-i) for i <= j (else 0)."""
    A = np.asarray(A, np.float64).reshape(2, 2)
    P = np.empty((n + 1, 2, 2))
    P[0] = np.eye(2)
    for k in range(n):
        P[k + 1] = A @ P[k]
    e = np.arange(n)[:, None] - np.arange(n)[None, :]
    M = np.where((e >= 0)[..., None, None], P[np.maximum(e, 0)], 0.0)
    return torch.from_numpy(M).to(device), torch.from_numpy(P).to(device)


def _matrix_scan(A: np.ndarray, e: torch.Tensor,
                 s0: torch.Tensor) -> torch.Tensor:
    """s[t] = A s[t-1] + e[t] with s[-1] = s0, for a 2 x 2 matrix A, real
    float64 e [R, T, 2] and s0 [R, 2].  Blocked: per block of SCAN_BLOCK
    samples a zero-start contraction against the powers of A, then the
    block-end states (the same recurrence with A^SCAN_BLOCK) carried across
    blocks recursively."""
    R, T, _ = e.shape
    n = min(T, SCAN_BLOCK)
    M, P = _powers(tuple(A.reshape(-1)), n, e.device)
    if T <= n:
        return (torch.einsum("jiab,rib->rja", M, e)
                + torch.einsum("jab,rb->rja", P[1:], s0))
    nb = -(-T // n)
    e = torch.nn.functional.pad(e, (0, 0, 0, nb * n - T)).reshape(R, nb, n, 2)
    local = torch.einsum("jiab,rkib->rkja", M, e)                # [R, nb, n, 2]
    ends = _matrix_scan(np.linalg.matrix_power(A, n), local[:, :, -1],
                        s0)                                      # [R, nb, 2]
    before = torch.cat([s0[:, None], ends[:, :-1]], dim=1)       # s entering
    s = local + torch.einsum("jab,rkb->rkja", P[1:], before)
    return s.reshape(R, nb * n, 2)[:, :T]


def biquad_apply(samples: torch.Tensor, coeffs: np.ndarray) -> torch.Tensor:
    """Biquad along the last axis from zero state, y[n] = b0 x[n] +
    b1 x[n-1] + b2 x[n-2] - a1 y[n-1] - a2 y[n-2] (the transposed direct
    form II of the reference computes the same recurrence): the feed-forward
    part as shifted sums, the feedback on the state (y[n], y[n-1])."""
    b0, b1, b2, a1, a2 = [float(c) for c in coeffs]
    flat = samples.reshape(-1, samples.shape[-1]).to(torch.float64)
    x1 = torch.nn.functional.pad(flat, (1, 0))[:, :-1]
    x2 = torch.nn.functional.pad(flat, (2, 0))[:, :-2]
    u = b0 * flat + b1 * x1 + b2 * x2
    e = torch.stack([u, torch.zeros_like(u)], dim=-1)
    A = np.array([[-a1, -a2], [1.0, 0.0]])
    y = _matrix_scan(A, e, torch.zeros(flat.shape[0], 2, dtype=torch.float64,
                                       device=flat.device))[..., 0]
    return y.to(samples.dtype).reshape(samples.shape)


# ---------------------------------------------------------------------------
# Resampler (src/dsp/resampler.cpp): GCD up/down with anti-alias FIR
# ---------------------------------------------------------------------------

def resample(samples: torch.Tensor, input_rate: int, output_rate: int,
             taps: int = 127) -> torch.Tensor:
    g = math.gcd(input_rate, output_rate)
    up, down = output_rate // g, input_rate // g
    if up == 1 and down == 1:
        return samples
    T = samples.shape[-1]
    # Zero-stuff upsample.
    stuffed = torch.zeros(*samples.shape[:-1], T, up, dtype=samples.dtype,
                          device=samples.device)
    stuffed[..., 0] = samples * up
    x = stuffed.reshape(*samples.shape[:-1], T * up)
    cutoff = 0.45 * min(input_rate, output_rate)
    h = fir_lowpass(taps, cutoff, input_rate * up)
    y = fir_apply(x, h)
    return y[..., ::down]


# ---------------------------------------------------------------------------
# AGC (filters.cpp:196-224) — per-sample envelope, a loop over time
# ---------------------------------------------------------------------------

def agc(samples: torch.Tensor, target: float = 0.5, attack: float = 0.01,
        decay: float = 0.001) -> torch.Tensor:
    flat = samples.reshape(-1, samples.shape[-1])
    out = torch.empty_like(flat)
    gain = torch.ones(flat.shape[0], dtype=torch.float32, device=flat.device)
    for t in range(flat.shape[-1]):
        x = flat[:, t]
        level = x.abs() * gain
        err = target - level
        rate = torch.where(level > target, attack, decay)
        gain = torch.clamp(gain + rate * err, 0.01, 100.0)
        out[:, t] = x * gain
    return out.reshape(samples.shape)


# ---------------------------------------------------------------------------
# Analytic signal / Hilbert (shared with sync), RMS / peak / dB utils
# ---------------------------------------------------------------------------

def hilbert_analytic(samples: torch.Tensor) -> torch.Tensor:
    from ..sync.schmidl_cox import analytic_signal
    return analytic_signal(samples)


def rms(samples: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(samples * samples, dim=-1))


def peak(samples: torch.Tensor) -> torch.Tensor:
    return torch.amax(samples.abs(), dim=-1)


def normalize(samples: torch.Tensor, target: float = 1.0) -> torch.Tensor:
    p = peak(samples)[..., None]
    return torch.where(p > 0, samples * (target / torch.clamp(p, min=1e-30)),
                       samples)


def to_db(linear):
    return 20.0 * torch.log10(torch.as_tensor(linear) + 1e-10)


def from_db(db):
    return 10.0 ** (db / 20.0)

"""Watterson / ITU-R F.1487 HF channel simulator, batched (port of
projectultra_tpu/sim/watterson.py; reference src/sim/hf_channel.hpp and the
test-harness channel helpers of tools/test_iwaveform.cpp:42-112).

* Rayleigh tap fading: the AR(1) recurrence f[n] = (1-a) f[n-1] + a w[n]
  (an IIR-lowpass-shaped Gaussian Doppler spectrum) runs as a blocked scan:
  inside each 128-sample block one matmul against the block's decay matrix
  (1-a)^(j-i), then the block-end values are carried across blocks by the
  same scan one level up.  Every power is at most 1, so no scale overflows
  float32 at any Doppler or length;
* multipath: a second tap delayed by delay_spread_ms + 1 sample;
* AWGN: noise std from the input RMS (whole buffer for ``watterson``,
  active samples only for the harness's ``add_noise_active``);
* CFO: FFT-Hilbert single-sideband shift of the whole buffer.

Every random draw is split from the arithmetic: the ``*_with`` functions
take their standard-normal draws as arguments (the tests feed them the
arrays ``jax.random`` drew), and the wrappers draw them with
``torch.randn`` from an explicit generator on the samples' device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import mixer as mixer_ops


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """(hf_channel.hpp:37-67)"""
    snr_db: float = 15.0
    delay_spread_ms: float = 2.0
    doppler_spread_hz: float = 1.0
    cfo_hz: float = 0.0
    path1_gain: float = 0.707
    path2_gain: float = 0.707
    sample_rate: int = 48000
    fading_enabled: bool = True
    multipath_enabled: bool = True
    noise_enabled: bool = True
    cfo_enabled: bool = True


# ITU-R F.1487 presets (hf_channel.hpp:303-492).
def awgn(snr_db: float) -> ChannelConfig:
    return ChannelConfig(snr_db=snr_db, fading_enabled=False,
                         multipath_enabled=False, cfo_enabled=False)


def good(snr_db: float = 25.0) -> ChannelConfig:
    return ChannelConfig(snr_db=snr_db, delay_spread_ms=0.5, doppler_spread_hz=0.1)


def moderate(snr_db: float = 15.0) -> ChannelConfig:
    return ChannelConfig(snr_db=snr_db, delay_spread_ms=1.0, doppler_spread_hz=0.5)


def poor(snr_db: float = 10.0) -> ChannelConfig:
    return ChannelConfig(snr_db=snr_db, delay_spread_ms=2.0, doppler_spread_hz=1.0)


def flutter(snr_db: float = 15.0) -> ChannelConfig:
    return ChannelConfig(snr_db=snr_db, delay_spread_ms=0.5, doppler_spread_hz=10.0)


PRESETS = {"awgn": awgn, "good": good, "moderate": moderate,
           "poor": poor, "flutter": flutter}


# The reference's primary harness channels (test_iwaveform.cpp:530-555):
# good fades faster with asymmetric 0.9/0.4 paths, poor is echo-dominant
# (0.6/0.8).  The regression thresholds were derived on these.
def harness_good(snr_db: float) -> ChannelConfig:
    return ChannelConfig(snr_db=snr_db, delay_spread_ms=0.5,
                         doppler_spread_hz=0.2, path1_gain=0.9,
                         path2_gain=0.4, cfo_enabled=False)


def harness_moderate(snr_db: float) -> ChannelConfig:
    return ChannelConfig(snr_db=snr_db, delay_spread_ms=1.0,
                         doppler_spread_hz=0.5, cfo_enabled=False)


def harness_poor(snr_db: float) -> ChannelConfig:
    return ChannelConfig(snr_db=snr_db, delay_spread_ms=2.0,
                         doppler_spread_hz=1.0, path1_gain=0.6,
                         path2_gain=0.8, cfo_enabled=False)


HARNESS_PRESETS = {"awgn": awgn, "good": harness_good,
                   "moderate": harness_moderate, "poor": harness_poor,
                   "flutter": flutter}


# ---------------------------------------------------------------------------
# AR(1) fading
# ---------------------------------------------------------------------------

SCAN_BLOCK = 128


@functools.lru_cache(maxsize=None)
def _decay(c: float, n: int, device: torch.device):
    """(M [n, n], p [n]) float32 with M[j, i] = c^(j-i) for i <= j (else 0)
    and p[j] = c^(j+1), from float64 powers."""
    j = np.arange(n)
    e = j[:, None] - j[None, :]
    M = np.where(e >= 0, float(c) ** np.maximum(e, 0).astype(np.float64), 0.0)
    p = float(c) ** (j + 1).astype(np.float64)
    return (torch.from_numpy(M.astype(np.float32)).to(device),
            torch.from_numpy(p.astype(np.float32)).to(device))


def _linear_scan(c: float, b: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """y[t] = c * y[t-1] + b[t] with y[-1] = y0, for real b [R, T] and
    y0 [R].  Blocked: per block of SCAN_BLOCK samples a zero-start matmul
    against the decay matrix, then the block-end values (the same
    recurrence with c^SCAN_BLOCK) carried across blocks recursively."""
    R, T = b.shape
    n = SCAN_BLOCK
    M, p = _decay(c, min(T, n), b.device)
    if T <= n:
        return b @ M.T + y0[:, None] * p
    nb = -(-T // n)
    local = F.pad(b, (0, nb * n - T)).reshape(R, nb, n) @ M.T   # [R, nb, n]
    ends = _linear_scan(c ** n, local[..., -1], y0)             # [R, nb]
    before = torch.cat([y0[:, None], ends[:, :-1]], dim=-1)      # y entering
    return (local + before[..., None] * p).reshape(R, nb * n)[:, :T]


def _ar1_scan(a: float, x: torch.Tensor, y0) -> torch.Tensor:
    """y[n] = (1-a) * y[n-1] + a * x[n] with y[-1] = y0, along the last
    axis of complex64 x; y0 is a Python complex or a tensor broadcasting
    against x[..., 0]."""
    lead, T = x.shape[:-1], x.shape[-1]
    c = float(np.float32(1.0 - a))
    b = float(np.float32(a)) * x
    if not isinstance(y0, torch.Tensor):
        y0 = torch.full((), complex(y0), dtype=torch.complex64, device=x.device)
    y0 = y0.to(torch.complex64).expand(lead)
    # Real and imaginary parts as separate rows of one real scan.
    br = torch.view_as_real(b).movedim(-1, -2).reshape(-1, T)
    y0r = torch.view_as_real(y0).reshape(-1)
    y = _linear_scan(c, br, y0r).reshape(*lead, 2, T).movedim(-2, -1)
    return torch.view_as_complex(y.contiguous())


def _alpha(cfg: ChannelConfig) -> float:
    return 1.0 - np.exp(-2.0 * np.pi * cfg.doppler_spread_hz / cfg.sample_rate)


def rayleigh_taps_with(cfg: ChannelConfig,
                       normals: torch.Tensor) -> torch.Tensor:
    """Complex AR(1)-filtered Gaussian fading of unit mean power
    (hf_channel.hpp:258-275) from standard normals [2, *shape, T] (real
    and imaginary draws): input std per component sqrt(1/alpha).
    Returns [*shape, T] complex64."""
    alpha = _alpha(cfg)
    scale = float(np.float32(np.sqrt(1.0 / alpha)))
    noise = torch.complex(scale * normals[0], scale * normals[1])
    return _ar1_scan(alpha, noise, 1.0 + 0j)


def rayleigh_taps(cfg: ChannelConfig, shape: tuple, T: int,
                  generator: torch.Generator) -> torch.Tensor:
    """``rayleigh_taps_with`` on normals drawn from ``generator``, on the
    generator's device."""
    normals = torch.randn((2, *shape, T), generator=generator,
                          device=generator.device)
    return rayleigh_taps_with(cfg, normals)


def _paths(cfg: ChannelConfig) -> int:
    """Fading taps per frame: two with multipath, else one."""
    delay = int(cfg.delay_spread_ms * cfg.sample_rate / 1000.0)
    return 2 if cfg.multipath_enabled and delay > 0 else 1


def watterson_with(samples: torch.Tensor, cfg: ChannelConfig,
                   fade_normals: torch.Tensor | None = None,
                   awgn_normals: torch.Tensor | None = None) -> torch.Tensor:
    """WattersonChannel::process for a [B, T] batch (hf_channel.hpp:108-168):
    the Rayleigh envelope applied to the real passband signal, a second tap
    delayed by delay_spread_ms + 1 sample, AWGN scaled to the whole-buffer
    input RMS, then the harness CFO.

    ``fade_normals`` [2, B, paths, T] (paths 2 with multipath, else 1) are
    used when fading is enabled, ``awgn_normals`` [B, T] when noise is."""
    B, T = samples.shape
    delay = int(cfg.delay_spread_ms * cfg.sample_rate / 1000.0)
    if cfg.fading_enabled:
        h = rayleigh_taps_with(cfg, fade_normals).abs()          # [B, paths, T]
    if cfg.multipath_enabled and delay > 0:
        h1, h2 = (h[:, 0], h[:, 1]) if cfg.fading_enabled else (1.0, 1.0)
        delayed = F.pad(samples, (delay + 1, 0))[:, :T]
        out = samples * cfg.path1_gain * h1 + delayed * cfg.path2_gain * h2
    else:
        out = samples * h[:, 0] if cfg.fading_enabled else samples * 1.0
    if cfg.noise_enabled:
        rms = torch.sqrt((samples * samples).mean(-1))
        noise_std = rms * 10.0 ** (-cfg.snr_db / 20.0)
        out = out + noise_std[:, None] * awgn_normals
    if cfg.cfo_enabled and abs(cfg.cfo_hz) > 0.001:
        out = apply_cfo_hilbert(out, cfg.cfo_hz)
    return out


def watterson(samples: torch.Tensor, cfg: ChannelConfig,
              generator: torch.Generator) -> torch.Tensor:
    """``watterson_with`` on normals drawn from ``generator`` (on the
    samples' device): the fading draws first, then the noise."""
    B, T = samples.shape
    dev = samples.device
    fade = (torch.randn((2, B, _paths(cfg), T), generator=generator,
                        device=dev) if cfg.fading_enabled else None)
    noise = (torch.randn((B, T), generator=generator, device=dev)
             if cfg.noise_enabled else None)
    return watterson_with(samples, cfg, fade, noise)


def seeded_generator(device, *ints: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from a sequence of
    integers (numpy's ``SeedSequence`` hashes them into one seed): the
    harness's stand-in for ``jax.random.fold_in(PRNGKey(a), b)``, one
    independent stream per (a, b, ...)."""
    seed = int(np.random.SeedSequence(list(ints)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


# ---------------------------------------------------------------------------
# Harness AWGN and CFO
# ---------------------------------------------------------------------------

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
def analytic_mult(n_fft: int, device: torch.device) -> torch.Tensor:
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
    analytic = torch.fft.ifft(x * analytic_mult(n_fft, dev), dim=-1)[..., :T]
    rot = mixer_ops.osc_traced(cfo[..., None], int(sample_rate),
                               torch.arange(T, dtype=torch.int32, device=dev))
    out = (analytic * rot).real
    return torch.where(cfo.abs()[..., None] > 0.001, out, samples)

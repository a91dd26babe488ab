"""Dual-chirp acquisition: generation and batched matched-filter detection
(port of projectultra_tpu/sync/chirp.py; reference src/sync/chirp_sync.hpp).

The chirp occupies ~2.4 kHz of the 48 kHz sample rate, so the matched
filter searches a DECIMATED complex-baseband signal (mix to the chirp's
centre, 128-tap band-select FIR, keep every 8th sample: one FFT ~10x
smaller than a full-rate one), and every candidate is then REFINED at full
rate by a direct windowed correlation at each offset of [pos-12, pos+12],
so reported positions and correlations keep full-rate exactness:

* decimated correlation magnitudes are rescaled to the full-rate numerator
  scale (kappa) and normalised by the full-rate sliding window energy;
  grid sampling can read a peak ~7% low, so candidate masks use
  0.93 * threshold and the accept gate re-tests the refined peak against
  the caller's threshold;
* candidates: the EARLIEST up-chirp crossing wins (two rules, A: absolute
  threshold, B: max(threshold, 0.7 * global max), refined together as one
  K = 2 batch), validated by the down chirp and the CFO it implies;
* a CFO shifts the up-chirp peak by -CFO*fs/k samples and the down-chirp
  peak by +CFO*fs/k (k = chirp rate), so CFO = gap error / (2*fs/k).

Everything is plain PyTorch (``torch.fft``, ``F.conv1d``, ``torch.matmul``,
indexing) in float32 with TF32 off, and no branch reads the device: every
decision is a tensor select.  Host tables are numpy functions, pinned
array-equal to the JAX package's, and are cached per device.

The bf16 mode (``ULTRA_CHIRP_BF16=1`` when this module is imported, as the
JAX package reads it; ``bf16_mode`` sets it for a block) rounds where the
JAX package's does: the decimation conv's and the refine matmuls' operands
to bfloat16 with float32 products and sums (rounded operands multiplied
in float32: a product of two bfloat16 values is exact in float32), the
refine's squared samples to a bfloat16 product, and the coarse
correlations to bfloat16 for the candidate selection, whose masks, maxima
and comparisons then run in bfloat16 as JAX's do.  The coarse FFT and the
window energies stay float32, and every accept gate re-tests the refined
float32 peak.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.sc_windows import window_sum

_BF16 = os.environ.get("ULTRA_CHIRP_BF16") == "1"


@contextlib.contextmanager
def bf16_mode(on: bool = True):
    """The acquisition's bf16 mode on (or off) inside the block, restored
    after it."""
    global _BF16
    saved, _BF16 = _BF16, bool(on)
    try:
        yield
    finally:
        _BF16 = saved


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (nearest, ties to even), as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _mxu_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in float32; in the bf16 mode both operands are rounded to
    bfloat16 first (float32 products and sums)."""
    if _BF16:
        return _bf16(a) @ _bf16(b)
    return a @ b


@dataclasses.dataclass(frozen=True)
class ChirpConfig:
    """(chirp_sync.hpp:26-36)"""
    sample_rate: float = 48000.0
    f_start: float = 300.0
    f_end: float = 2700.0
    duration_ms: float = 500.0
    gap_ms: float = 100.0
    amplitude: float = 0.5
    tx_cfo_hz: float = 0.0
    use_dual_chirp: bool = True

    @property
    def chirp_samples(self) -> int:
        return int(self.sample_rate * self.duration_ms / 1000.0)

    @property
    def gap_samples(self) -> int:
        return int(self.sample_rate * self.gap_ms / 1000.0)

    @property
    def total_samples(self) -> int:
        if self.use_dual_chirp:
            return 2 * self.chirp_samples + 2 * self.gap_samples
        return self.chirp_samples + self.gap_samples

    @property
    def chirp_rate(self) -> float:
        return (self.f_end - self.f_start) / (self.duration_ms / 1000.0)

    @property
    def cfo_to_samples(self) -> float:
        """Peak shift per Hz of CFO: fs / k = 10 samples/Hz."""
        return self.sample_rate / self.chirp_rate


MAX_REASONABLE_CFO_HZ = 100.0
DECIM = 8          # decimation of the coarse search (fs/8 = 6 kHz baseband)
DECIM_TAPS = 128
GRID_LOSS = 0.93   # worst-case grid sampling loss of the candidate masks
REFINE_HALF = 12   # full-rate refine window half-width (> D + parabolic slop)


def _phase_up(cfg: ChirpConfig, t: np.ndarray, cfo: float = 0.0) -> np.ndarray:
    return 2.0 * np.pi * ((cfg.f_start + cfo) * t + 0.5 * cfg.chirp_rate * t * t)


def _phase_down(cfg: ChirpConfig, t: np.ndarray, cfo: float = 0.0) -> np.ndarray:
    return 2.0 * np.pi * ((cfg.f_end + cfo) * t - 0.5 * cfg.chirp_rate * t * t)


@functools.lru_cache(maxsize=None)
def generate(cfg: ChirpConfig) -> np.ndarray:
    """TX chirp sequence: [up][gap][down][gap] (chirp_sync.hpp:59-105)."""
    t = np.arange(cfg.chirp_samples, dtype=np.float64) / cfg.sample_rate
    out = np.zeros(cfg.total_samples, dtype=np.float32)
    out[:cfg.chirp_samples] = cfg.amplitude * np.sin(
        _phase_up(cfg, t, cfg.tx_cfo_hz))
    if cfg.use_dual_chirp:
        d0 = cfg.chirp_samples + cfg.gap_samples
        out[d0:d0 + cfg.chirp_samples] = cfg.amplitude * np.sin(
            _phase_down(cfg, t, cfg.tx_cfo_hz))
    return out


@functools.lru_cache(maxsize=None)
def _templates(cfg: ChirpConfig):
    """Analytic (cos + j*sin) templates and their energies."""
    t = np.arange(cfg.chirp_samples, dtype=np.float64) / cfg.sample_rate
    pu = _phase_up(cfg, t)
    pd = _phase_down(cfg, t)
    up = (np.cos(pu) + 1j * np.sin(pu)).astype(np.complex64)
    down = (np.cos(pd) + 1j * np.sin(pd)).astype(np.complex64)
    e_up = float((np.sin(pu).astype(np.float32) ** 2).sum())
    e_down = float((np.sin(pd).astype(np.float32) ** 2).sum())
    return up, down, e_up, e_down


@functools.lru_cache(maxsize=None)
def _decim_filter(cfg: ChirpConfig):
    """Complex band-select decimation taps as two real rows [2, K]:
    w[k] = h[k] * e^{-j 2 pi fc (k - K//2) / fs}, h a Kaiser lowpass with
    unity DC gain.  The residual per-output rotation cancels in the
    signal-vs-template correlation, so it is never applied; the stopband
    only has to cover what folds onto the template band."""
    fs = cfg.sample_rate
    fc = 0.5 * (cfg.f_start + cfg.f_end)
    bw = 0.5 * (cfg.f_end - cfg.f_start) + MAX_REASONABLE_CFO_HZ
    assert fs / DECIM >= 4.0 * bw / 1.8, "decimated rate too low for band"
    K = DECIM_TAPS
    k = np.arange(K, dtype=np.float64)
    m = k - (K - 1) / 2.0
    cut = (bw + (fs / DECIM - 2 * bw) * 0.5) / (fs / 2.0)  # mid transition
    h = np.sinc(cut * m) * cut * np.kaiser(K, 9.0)
    h /= h.sum()
    ph = -2.0 * np.pi * fc * (k - K // 2) / fs
    return np.stack([h * np.cos(ph), h * np.sin(ph)]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _templates_dec(cfg: ChirpConfig):
    """Decimated complex-baseband templates (the signal path's filter) and
    the kappa scales that map decimated correlation magnitudes onto the
    full-rate numerator scale."""
    _, _, e_up, e_down = _templates(cfg)
    t = np.arange(cfg.chirp_samples, dtype=np.float64) / cfg.sample_rate
    w = _decim_filter(cfg).astype(np.float64)
    wk = w[0] + 1j * w[1]
    K = len(wk)
    P = K // 2

    def dec(x):
        xp = np.concatenate([np.zeros(P), x, np.zeros(P - 1 + (-len(x)) % DECIM)])
        n_out = (len(xp) - K) // DECIM + 1
        idx = np.arange(n_out)[:, None] * DECIM + np.arange(K)[None, :]
        return (xp[idx] * wk[None, :]).sum(-1)

    up_d = dec(np.sin(_phase_up(cfg, t)))
    dn_d = dec(np.sin(_phase_down(cfg, t)))
    # A clean unit chirp's decimated self-correlation reads as the
    # full-rate numerator e_up (resp. e_down).
    k_up = e_up / float(np.abs((up_d * np.conj(up_d)).sum()))
    k_dn = e_down / float(np.abs((dn_d * np.conj(dn_d)).sum()))
    return (up_d.real.astype(np.float32), up_d.imag.astype(np.float32), k_up,
            dn_d.real.astype(np.float32), dn_d.imag.astype(np.float32), k_dn)


@functools.lru_cache(maxsize=None)
def _refine_mats(cfg: ChirpConfig):
    """Shifted-template matrices of the full-rate refine, W = L + 2R rows.

    Kc [W, 2*(2R+1)]: column j holds cos(template) shifted j rows down,
    column (2R+1)+j holds -sin(template) shifted j, so seg @ Kc gives the
    real and -imaginary parts of sum s[p+i]*conj(tmpl[i]) at the 2R+1
    offsets.  Ke [W, 2R+1]: shifted ones, so (seg*seg) @ Ke gives the
    window energies."""
    up, down, _, _ = _templates(cfg)
    L = cfg.chirp_samples
    R = REFINE_HALF
    W = L + 2 * R
    n_off = 2 * R + 1

    def shifts(vec):
        m = np.zeros((W, n_off), np.float32)
        for j in range(n_off):
            m[j:j + L, j] = vec
        return m

    kc_up = np.concatenate([shifts(up.real.astype(np.float32)),
                            shifts(-up.imag.astype(np.float32))], 1)
    kc_dn = np.concatenate([shifts(down.real.astype(np.float32)),
                            shifts(-down.imag.astype(np.float32))], 1)
    ke = shifts(np.ones(L, np.float32))
    return kc_up, kc_dn, ke


# ---------------------------------------------------------------------------
# Per-device constants
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _decim_kernel(cfg: ChirpConfig, device: torch.device) -> torch.Tensor:
    """The polyphase conv weight [2, D, K/D]: kern[o, ph, j] = w[o, D*j+ph]."""
    w = _decim_filter(cfg)
    kw = w.shape[1] // DECIM
    kern = np.ascontiguousarray(w.reshape(2, kw, DECIM).transpose(0, 2, 1))
    return torch.from_numpy(kern).to(device)


@functools.lru_cache(maxsize=None)
def _template_filter(cfg: ChirpConfig, n_fft: int,
                     device: torch.device) -> torch.Tensor:
    """conj(fft([t_up, t_dn], n_fft)) [2, n_fft] of the decimated
    templates: both ride one batched inverse FFT."""
    up_re, up_im, _, dn_re, dn_im, _ = _templates_dec(cfg)
    t = torch.complex(torch.from_numpy(np.stack([up_re, dn_re])),
                      torch.from_numpy(np.stack([up_im, dn_im]))).to(device)
    return torch.fft.fft(t, n=n_fft, dim=-1).conj()


@functools.lru_cache(maxsize=None)
def _refine_on(cfg: ChirpConfig, device: torch.device, bf16: bool = False):
    """(kc_up, kc_dn, ke) of ``_refine_mats`` on the device; rounded to
    bfloat16 (as float32) for the bf16 mode."""
    mats = tuple(torch.from_numpy(m).to(device) for m in _refine_mats(cfg))
    return tuple(_bf16(m) for m in mats) if bf16 else mats


# ---------------------------------------------------------------------------
# Decimation and window energies
# ---------------------------------------------------------------------------

def _decimate(cfg: ChirpConfig, samples: torch.Tensor) -> torch.Tensor:
    """[B, T] real -> [B, ceil(T/D)] complex baseband at fs/D:
    y[m] = sum_k w[k] x[D*m + k - K/2] (zero outside [0, T)).

    The JAX package's polyphase form: a stride-1 cross-correlation
    (``F.conv1d``, taps not flipped) over x reshaped to [B, D(phase), T/D]
    with K/D taps and the asymmetric padding (K/D//2, K/D - 1 - K/D//2).
    (An unfold + matmul over 8-strided 128-sample windows computes the same
    sum; on the H100 it was the slower of the two, PERF.md.)"""
    D = DECIM
    B, T = samples.shape
    Tb = -(-T // D)
    kern = _decim_kernel(cfg, samples.device)
    kw = kern.shape[-1]
    if _BF16:
        samples, kern = _bf16(samples), _bf16(kern)
    xp = F.pad(samples, (0, Tb * D - T))
    xb = xp.reshape(B, Tb, D).transpose(1, 2)                # [B, D, Tb]
    out = F.conv1d(F.pad(xb, (kw // 2, kw - 1 - kw // 2)), kern)
    return torch.complex(out[:, 0], out[:, 1])


def _window_sum_dec(samples: torch.Tensor, L: int, n_pos_d: int) -> torch.Tensor:
    """Full-rate L-sample sliding energy on the D grid only.  When L is a
    multiple of D, the grid-aligned sums are exact sums of D-sample block
    energies, so the block-stable window sum runs on the 8x shorter block
    array; otherwise the full-rate sums are subsampled."""
    D = DECIM
    if L % D:
        return window_sum(samples * samples, L)[:, ::D][:, :n_pos_d]
    B, T = samples.shape
    Tb = T // D
    blocks = (samples[:, :Tb * D].reshape(B, Tb, D) ** 2).sum(-1)
    return window_sum(blocks, L // D)[:, :n_pos_d]


# ---------------------------------------------------------------------------
# Full-rate refine
# ---------------------------------------------------------------------------

def _corr_dense(cfg: ChirpConfig, samples: torch.Tensor, start: torch.Tensor,
                kc: torch.Tensor, ke: torch.Tensor, e_t: float) -> torch.Tensor:
    """Normalised correlation [B*K, 2R+1] of the [W]-windows at ``start``
    [B, K]: the windows are read from an unfolded view by index
    arithmetic, then two dense matmuls."""
    B, T = samples.shape
    W = cfg.chirp_samples + 2 * REFINE_HALF
    n_off = 2 * REFINE_HALF + 1
    rows = torch.arange(B, device=samples.device)[:, None]
    seg = samples.unfold(-1, W, 1)[rows, start].reshape(-1, W)   # [B*K, W]
    num = _mxu_dot(seg, kc)                                      # [B*K, 2n]
    mag = torch.sqrt(num[:, :n_off] ** 2 + num[:, n_off:] ** 2)
    en = _mxu_dot(seg * seg, ke)                                 # [B*K, n]
    denom = torch.sqrt(torch.clamp(en * e_t, min=0.0))
    return torch.where(denom > 1e-10, mag / denom, 0.0)


def _corr_bf16(cfg: ChirpConfig, samples: torch.Tensor, start: torch.Tensor,
               kc: torch.Tensor, ke: torch.Tensor, e_t: float) -> torch.Tensor:
    """The bf16 mode's refine (the JAX package's ``_corr_aligned``): the
    samples rounded to bfloat16 before the gather, the squares a bfloat16
    product rounded to bfloat16, ``kc``/``ke`` already bfloat16-valued.
    JAX gathers 128-aligned blocks (a TPU gather-speed measure) and picks
    each window's 2R+1 columns of a wider product; gathering each window
    directly sums the same rounded products in every picked column."""
    B, T = samples.shape
    W = cfg.chirp_samples + 2 * REFINE_HALF
    n_off = 2 * REFINE_HALF + 1
    rows = torch.arange(B, device=samples.device)[:, None]
    seg = samples.to(torch.bfloat16).unfold(-1, W, 1)[rows, start] \
        .reshape(-1, W)                                          # [B*K, W]
    num = seg.to(torch.float32) @ kc                             # [B*K, 2n]
    mag = torch.sqrt(num[:, :n_off] ** 2 + num[:, n_off:] ** 2)
    en = (seg * seg).to(torch.float32) @ ke                      # [B*K, n]
    denom = torch.sqrt(torch.clamp(en * e_t, min=0.0))
    return torch.where(denom > 1e-10, mag / denom, 0.0)


def _refine_full(cfg: ChirpConfig, samples: torch.Tensor, pos: torch.Tensor,
                 kc: torch.Tensor, ke: torch.Tensor, e_t: float):
    """Exact normalised correlation at every full-rate offset of
    [pos-R, pos+R], argmax (first occurrence), parabolic sub-sample
    interpolation rounded half-to-even back to an integer
    (chirp_sync.hpp:607-620).  ``pos`` is [B] or [B, K]; returns
    (pos int32, corr float32) of pos's shape."""
    B, T = samples.shape
    R = REFINE_HALF
    W = cfg.chirp_samples + 2 * R
    squeeze = pos.dim() == 1
    posk = pos[:, None] if squeeze else pos
    start = torch.clamp(posk - R, 0, max(T - W, 0)).to(torch.int64)
    corr_fn = _corr_bf16 if _BF16 and T >= W else _corr_dense
    corr = corr_fn(cfg, samples, start, kc, ke, e_t)             # [B*K, 2R+1]

    j = torch.argmax(corr, dim=-1, keepdim=True)
    c1 = corr.gather(1, j)
    c0 = corr.gather(1, torch.clamp(j - 1, 0, 2 * R))
    c2 = corr.gather(1, torch.clamp(j + 1, 0, 2 * R))
    den = 2.0 * (c0 - 2.0 * c1 + c2)
    big = den.abs() > 1e-10
    delta = torch.where(big, torch.clamp((c0 - c2) / torch.where(big, den, 1.0),
                                         -1.0, 1.0), 0.0)
    interior = (j >= 1) & (j <= 2 * R - 1)
    jr = torch.where(interior, torch.round(j.to(torch.float32) + delta)
                     .to(torch.int64), j)
    outp = (start.reshape(-1, 1) + jr).to(torch.int32).reshape(posk.shape)
    outc = c1.reshape(posk.shape)
    if squeeze:
        return outp[:, 0], outc[:, 0]
    return outp, outc


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------

def detect_dual_chirp(cfg: ChirpConfig, samples: torch.Tensor,
                      threshold: float = 0.15) -> dict:
    """Batched detectDualChirp (chirp_sync.hpp:349-505) on [B, T] float32
    samples.

    Returns a dict of [B] tensors: success (bool), first_strong_up,
    up_chirp_start, down_chirp_start, next_up_start (int32), cfo_hz,
    up_correlation, down_correlation (float32).  Nothing is read to the
    host."""
    B, T = samples.shape
    dev = samples.device
    L = cfg.chirp_samples
    gap = cfg.gap_samples
    D = DECIM
    _, _, k_up, _, _, k_dn = _templates_dec(cfg)
    _, _, e_up, e_down = _templates(cfg)
    kc_up, kc_dn, ke = _refine_on(cfg, dev, _BF16)

    # Coarse search on the decimated grid: one FFT of the decimated signal,
    # both templates through one batched inverse FFT.
    xd = _decimate(cfg, samples)                                # [B, Td]
    Td = xd.shape[-1]
    n_pos = T - L + 1
    n_pos_d = (n_pos + D - 1) // D
    n_fft = 1 << int(Td - 1).bit_length()
    S = torch.fft.fft(xd, n=n_fft, dim=-1)
    c2 = torch.fft.ifft(S[:, None, :] * _template_filter(cfg, n_fft, dev),
                        dim=-1)                                  # [B, 2, n_fft]
    num_up = c2[:, 0, :n_pos_d].abs() * k_up
    num_dn = c2[:, 1, :n_pos_d].abs() * k_dn
    energy = _window_sum_dec(samples, L, n_pos_d)
    den_up = torch.sqrt(torch.clamp(energy * e_up, min=0.0))
    den_dn = torch.sqrt(torch.clamp(energy * e_down, min=0.0))
    corr_up = torch.where(den_up > 1e-10, num_up / den_up, 0.0)  # [B, n_pos_d]
    corr_dn = torch.where(den_dn > 1e-10, num_dn / den_dn, 0.0)
    if _BF16:
        # Threshold-margin quantities only: the selection below (masks,
        # maxima, comparisons with Python floats, which torch rounds to the
        # tensor's dtype as JAX does) runs in bfloat16.
        corr_up = corr_up.to(torch.bfloat16)
        corr_dn = corr_dn.to(torch.bfloat16)

    pos_d = torch.arange(n_pos_d, device=dev)
    # The reference searches pos < T - L (exclusive of the last).
    search_mask = pos_d * D < (T - L)
    cu = torch.where(search_mask[None, :], corr_up, -1.0)
    c2s = cfg.cfo_to_samples
    thr_grid = GRID_LOSS * threshold
    rel = torch.arange(-512 // D, 512 // D + 1, device=dev)

    def up_candidate(strong):
        """Earliest strong crossing -> local grid peak (+-512 full-rate)."""
        first = _first_true(strong)
        widx = torch.clamp(first[:, None] + rel[None, :], 0, n_pos_d - 1)
        peak = torch.argmax(cu.gather(1, widx), dim=-1, keepdim=True)
        return widx.gather(1, peak)[:, 0]

    def down_candidate(up_pos):
        """The down-chirp search window (chirp_sync.hpp:420-438) in
        full-rate arithmetic, masked onto the D grid."""
        start = up_pos + L // 2
        expected = up_pos + L + gap
        end = torch.clamp(expected + 2 * L, max=T)
        end = torch.where(end <= start + L, torch.clamp(start + 2 * L, max=T),
                          end)
        pfull = pos_d[None, :] * D
        dn_mask = (pfull >= start[:, None]) & (pfull + L <= end[:, None]) \
            & (pfull < (T - L))
        cd = torch.where(dn_mask, corr_dn, -1.0)
        down_pos_d = torch.argmax(cd, dim=-1, keepdim=True)
        return down_pos_d[:, 0], cd.gather(1, down_pos_d)[:, 0]

    # The EARLIEST chirp wins, not the globally strongest.  Rule A: the
    # earliest crossing of the absolute threshold (keeps a faded early
    # frame); rule B: of max(threshold, 0.7 * global max) (robust to a
    # noise spike).  A wins when it fully validates.
    gmax = cu.amax(-1)
    strong_a = cu >= thr_grid
    # 0.7 in cu's dtype: torch multiplies by an unrounded Python float,
    # JAX by the constant rounded to the array's dtype.
    rel_b = float(torch.tensor(0.7, dtype=cu.dtype))
    strong_b = cu >= torch.clamp(rel_b * gmax[:, None], min=thr_grid)
    upd2 = torch.stack([up_candidate(strong_a), up_candidate(strong_b)], 1)
    up_pos2, up_corr2 = _refine_full(cfg, samples, upd2 * D, kc_up, ke, e_up)
    any2 = torch.stack([strong_a.any(-1), strong_b.any(-1)], 1)
    up_found2 = any2 & (up_corr2 >= threshold)

    dnd_a, dng_a = down_candidate(up_pos2[:, 0])
    dnd_b, dng_b = down_candidate(up_pos2[:, 1])
    down_pos2, down_corr2 = _refine_full(
        cfg, samples, torch.stack([dnd_a, dnd_b], 1) * D, kc_dn, ke, e_down)
    down_grid2 = torch.stack([dng_a, dng_b], 1)
    down_found2 = (down_grid2 >= thr_grid) & (down_corr2 >= threshold)

    # CFO from the gap error (fs/k samples per Hz on each chirp), times
    # the float32 reciprocal: the reference's compiled division by this
    # constant rounds so, and a CUDA division by a host scalar does too.
    gap_error2 = (down_pos2 - up_pos2 - (L + gap)).to(torch.float32)
    cfo_hz2 = gap_error2 * float(np.float32(1.0) / np.float32(2.0 * c2s))
    cfo_ok2 = cfo_hz2.abs() <= MAX_REASONABLE_CFO_HZ
    success2 = up_found2 & down_found2 & cfo_ok2

    use_a = success2[:, 0]
    sel = torch.where(use_a, 0, 1)[:, None]

    def pick2(arr2):
        return arr2.gather(1, sel)[:, 0]

    success = pick2(success2)
    up_pos = pick2(up_pos2)
    up_corr = pick2(up_corr2)
    down_pos = pick2(down_pos2)
    down_corr = pick2(down_corr2)
    down_found = pick2(down_found2)
    cfo_hz = pick2(cfo_hz2)
    strong = torch.where(use_a[:, None], strong_a, strong_b)

    # The first strong crossing AFTER the chosen chirp (the next frame's):
    # consumers cap consumption there.  The D-grid crossing can read up to
    # D-1 samples late, so the cap is biased early.
    later = strong & (pos_d[None, :] * D >= (up_pos + L)[:, None])
    i32 = torch.int32
    next_up = torch.where(later.any(-1),
                          torch.clamp(_first_true(later) * D - (D - 1), min=0),
                          -1).to(i32)

    up_start = torch.round(up_pos + cfo_hz * c2s).to(i32)
    down_start = torch.round(down_pos - cfo_hz * c2s).to(i32)

    # The earliest strong up-template crossing regardless of validation (a
    # partially arrived chirp), biased early like next_up.
    above = cu >= thr_grid
    first_strong = torch.where(
        above.any(-1), torch.clamp(_first_true(above) * D - (D - 1), min=0),
        -1).to(i32)

    return {
        "success": success,
        "first_strong_up": first_strong,
        "cfo_hz": torch.where(success, cfo_hz, 0.0),
        "up_chirp_start": up_start,
        "down_chirp_start": down_start,
        "up_correlation": up_corr,
        "down_correlation": torch.where(down_found, down_corr, 0.0),
        "next_up_start": next_up,
    }


def training_start(cfg: ChirpConfig, down_chirp_start):
    """Training begins after [down chirp][gap] (ofdm_chirp_waveform.cpp:155-160),
    computed from the down-chirp position, the more accurate under CFO."""
    return down_chirp_start + cfg.chirp_samples + cfg.gap_samples


def frame_spans(samples: torch.Tensor, train_start: torch.Tensor,
                span_len: int) -> torch.Tensor:
    """Each row's [span_len] frame at its training start, the start clipped
    into the buffer: one index gather from an unfolded view, no host read.
    [B, T] -> [B, span_len]."""
    B, T = samples.shape
    start = torch.clamp(train_start.to(torch.int64), 0, T - span_len)
    rows = torch.arange(B, device=samples.device)
    return samples.unfold(-1, span_len, 1)[rows, start]


def initial_cfo_phase(cfg: ChirpConfig, cfo_hz: torch.Tensor,
                      train_start: torch.Tensor) -> torch.Tensor:
    """Accumulated CFO-correction phase at the training start
    (ofdm_chirp_waveform.cpp:180-190), wrapped to [-pi, pi)."""
    phase = -2.0 * np.pi * cfo_hz * train_start.to(torch.float32) \
        / cfg.sample_rate
    return torch.remainder(phase + np.pi, 2.0 * np.pi) - np.pi

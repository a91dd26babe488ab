"""OTFS (Orthogonal Time Frequency Space) modem, batched (port of
projectultra_tpu/otfs/otfs.py; reference src/otfs/otfs.cpp and
include/ultra/otfs.hpp).

The delay-Doppler <-> time-frequency transforms are two batched FFTs:

  ISFFT: tf[n,m] = FFT_M_k( unscaled-IFFT_N_l( dd[k,l] ) )
  SFFT:  dd[k,l] = unscaled-IFFT_M_m( FFT_N_n( tf[n,m] ) ) / (M*N)

Frame layout per codeword (modem_engine.cpp:421-455): [preamble: 4x sync
OFDM symbol, RMS-normalized to 0.1][N data OFDM symbols], carriers on FFT
bins 1..M, CP 64, mixer reset at the preamble start and at the data
start.  The sparse OFDM synthesis and analysis (only bins 1..M live) are
constant [S, M, L] contractions, as in the JAX module.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..config import CodeRate, Modulation, bits_per_symbol
from ..device import host_table
from ..fec import ldpc as ldpc_codes
from ..ofdm import constellations as con
from ..ops import ldpc as ldpc_ops
from ..ops import mixer as mixer_ops
from ..ops.sc_windows import window_sum
from ..sync.chirp import frame_spans

REAL_TO_COMPLEX_SCALE = 2.4     # single-sideband extraction gain (otfs.cpp:150)
PREAMBLE_TARGET_RMS = 0.1
MAX_LLR = 30.0
MIN_LLR_MAG = 0.001
QAM16_THRESHOLD = 0.6324555320336759
FIXED_DD_NOISE_VAR = 0.1        # post-normalization LLR scale (otfs.cpp:728-733)
INTER_FRAME_GAP = 480           # between codeword frames (modem_engine.cpp:433)


@dataclasses.dataclass(frozen=True)
class OTFSConfig:
    """(otfs.hpp:32-58)"""
    M: int = 32               # delay bins (subcarriers)
    N: int = 16               # Doppler bins (OFDM symbols per frame)
    fft_size: int = 512
    cp_length: int = 64
    sample_rate: int = 48000
    center_freq: float = 1500.0
    modulation: Modulation = Modulation.QPSK
    tf_equalization: bool = True

    @property
    def sym_len(self) -> int:
        return self.fft_size + self.cp_length

    @property
    def preamble_len(self) -> int:
        return 4 * self.sym_len

    @property
    def frame_len(self) -> int:
        return self.preamble_len + self.N * self.sym_len

    def bits_per_frame(self, mod: Modulation | None = None) -> int:
        return self.M * self.N * bits_per_symbol(mod or self.modulation)


def isfft(dd: torch.Tensor) -> torch.Tensor:
    """[..., M, N] delay-Doppler -> [..., N, M] time-frequency
    (otfs.cpp:55-88): unscaled inverse along Doppler, forward along
    delay."""
    temp = torch.fft.ifft(dd, dim=-1) * dd.shape[-1]
    return torch.fft.fft(temp.transpose(-1, -2), dim=-1)


def sfft(tf: torch.Tensor) -> torch.Tensor:
    """[..., N, M] -> [..., M, N] with the reference's 1/(M*N) roundtrip
    scale (otfs.cpp:91-130)."""
    N, M = tf.shape[-2], tf.shape[-1]
    temp = torch.fft.fft(tf, dim=-2)
    dd = torch.fft.ifft(temp, dim=-1) * M
    return dd.transpose(-1, -2) / (M * N)


@functools.lru_cache(maxsize=None)
def sync_sequence(cfg: OTFSConfig) -> np.ndarray:
    n = np.arange(cfg.M, dtype=np.float32)
    ph = (-np.pi * n * (n + 1) / cfg.M).astype(np.float32)
    return (np.cos(ph) + 1j * np.sin(ph)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _synthesis_ri(cfg: OTFSConfig, t_offset: int, S: int):
    """IFFT of bins 1..M + CP + NCO upmix as one [S, M, L] real/imag f32
    pair."""
    N, cp, L = cfg.fft_size, cfg.cp_length, cfg.sym_len
    n_idx = (np.arange(L) - cp) % N
    k = np.arange(1, cfg.M + 1, dtype=np.float64)
    base = np.exp(2j * np.pi * np.outer(k, n_idx) / N) / N
    osc = mixer_ops.osc_fixed(cfg.center_freq, cfg.sample_rate,
                              S * L, offset=t_offset).reshape(S, L)
    A = base[None, :, :] * osc[:, None, :]
    return A.real.astype(np.float32), A.imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _analysis_ri(cfg: OTFSConfig, t_offset: int, S: int):
    """conj(NCO) x DFT rows of bins 1..M (CP zeroed) x 2.4, as a real/imag
    f32 [S, L, M] pair: the analysis dual of _synthesis_ri."""
    N, cp, L = cfg.fft_size, cfg.cp_length, cfg.sym_len
    n_idx = np.arange(L) - cp
    live = n_idx >= 0
    k = np.arange(1, cfg.M + 1, dtype=np.float64)
    W = np.exp(-2j * np.pi * np.outer(n_idx % N, k) / N)
    W = np.where(live[:, None], W, 0.0) * REAL_TO_COMPLEX_SCALE
    osc = mixer_ops.osc_fixed(cfg.center_freq, cfg.sample_rate,
                              S * L, offset=t_offset).reshape(S, L)
    M_ = np.conj(osc)[:, :, None] * W[None, :, :]
    return M_.real.astype(np.float32), M_.imag.astype(np.float32)


def _ofdm_symbols(cfg: OTFSConfig, rows: torch.Tensor,
                  t_offset: int = 0) -> torch.Tensor:
    """[..., S, M] TF rows -> [..., S*sym_len] real passband (bins 1..M,
    CP, mixer continuous from t_offset)."""
    S = rows.shape[-2]
    Ar, Ai = host_table(rows.device, _synthesis_ri, cfg, t_offset, S)
    out = torch.einsum("...sm,sml->...sl", rows.real, Ar) \
        - torch.einsum("...sm,sml->...sl", rows.imag, Ai)
    return out.reshape(*rows.shape[:-2], S * cfg.sym_len)


@functools.lru_cache(maxsize=None)
def generate_preamble(cfg: OTFSConfig) -> np.ndarray:
    """4x identical sync symbol, RMS-normalized to 0.1 (otfs.cpp:372-394),
    on the host."""
    seq = sync_sequence(cfg)
    Ar, Ai = _synthesis_ri(cfg, 0, 1)
    one = (seq.real @ Ar[0] - seq.imag @ Ai[0]).astype(np.float32)
    rms = np.sqrt((one ** 2).mean())
    if rms > 0:
        one = one * (PREAMBLE_TARGET_RMS / rms)
    return np.tile(one.astype(np.float32), 4)


def map_bits_to_dd(cfg: OTFSConfig, mod: Modulation,
                   bits: torch.Tensor) -> torch.Tensor:
    """[B, nbits] -> [B, M, N] DD grid, filled k-major (otfs.cpp:307-343);
    cells past the data stay empty (complex zero)."""
    B, nbits = bits.shape
    dev = bits.device
    bc = bits_per_symbol(mod)
    total = cfg.M * cfg.N
    pad = total * bc - nbits
    if pad < 0:
        raise ValueError("too many bits for one OTFS frame")
    b = torch.nn.functional.pad(bits.to(torch.int32), (0, pad))
    weights = 1 << torch.arange(bc - 1, -1, -1, dtype=torch.int32, device=dev)
    words = (b.reshape(B, total, bc) * weights).sum(-1)
    tbl = host_table(dev, _dd_table, mod)
    filled = host_table(dev, _filled, total, bc, nbits)
    syms = torch.where(filled[None, :], tbl[words.to(torch.int64)], 0.0)
    return syms.reshape(B, cfg.M, cfg.N)


def _dd_table(mod: Modulation) -> np.ndarray:
    return (con.table(mod) if mod != Modulation.BPSK
            else np.array([-1, 1], np.complex64))


def _filled(total: int, bc: int, nbits: int) -> np.ndarray:
    return np.arange(total) * bc < nbits


def modulate(cfg: OTFSConfig, mod: Modulation,
             bits: torch.Tensor) -> torch.Tensor:
    """[B, nbits] -> [B, N*sym_len] data samples (mixer reset at data
    start)."""
    return _ofdm_symbols(cfg, isfft(map_bits_to_dd(cfg, mod, bits)))


def frame_tx(cfg: OTFSConfig, mod: Modulation,
             bits: torch.Tensor) -> torch.Tensor:
    """Preamble + data for a batch of single-codeword frames."""
    pre = host_table(bits.device, generate_preamble, cfg)
    data = modulate(cfg, mod, bits)
    return torch.cat([pre.expand(bits.shape[0], pre.shape[0]), data], dim=-1)


def _rx_tf(cfg: OTFSConfig, samples: torch.Tensor,
           t_offset: int = 0) -> torch.Tensor:
    """[B, S*sym_len] passband -> [B, S, M] TF rows (demodulateSymbol,
    otfs.cpp:505-524): conj-mix, drop CP, FFT, bins 1..M, x2.4."""
    B = samples.shape[0]
    S = samples.shape[-1] // cfg.sym_len
    x = samples[:, :S * cfg.sym_len].reshape(B, S, cfg.sym_len)
    Mr, Mi = host_table(samples.device, _analysis_ri, cfg, t_offset, S)
    return torch.complex(torch.einsum("bsl,slm->bsm", x, Mr),
                         torch.einsum("bsl,slm->bsm", x, Mi))


def estimate_channel(cfg: OTFSConfig, preamble: torch.Tensor) -> torch.Tensor:
    """[B, 4*sym_len] -> [B, M] averaged LS channel estimate
    (otfs.cpp:528-588); weak bins fall back to unity."""
    rows = _rx_tf(cfg, preamble, t_offset=0)
    seq = host_table(preamble.device, sync_sequence, cfg)
    h = (rows * seq.conj()[None, None, :]).mean(-2)
    return torch.where(h.abs() ** 2 < 0.01,
                       torch.ones((), dtype=torch.complex64,
                                  device=h.device), h)


def _clip_llr(x: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(x, -MAX_LLR, MAX_LLR)
    small = c.abs() < MIN_LLR_MAG
    return torch.where(small, torch.where(c >= 0, MIN_LLR_MAG, -MIN_LLR_MAG),
                       c)


def _soft_demap(mod: Modulation, sym: torch.Tensor, nv: float) -> torch.Tensor:
    """(otfs.cpp:186-226)"""
    nv = max(0.001, nv)
    if mod == Modulation.BPSK:
        return _clip_llr(-2.0 * sym.real / nv)[..., None]
    if mod == Modulation.QAM16:
        I, Q = sym.real, sym.imag
        s = 2.0 / nv
        return _clip_llr(torch.stack([
            -s * I, s * (I.abs() - QAM16_THRESHOLD),
            -s * Q, s * (Q.abs() - QAM16_THRESHOLD)], dim=-1))
    s = -2.0 * con.QPSK_SCALE / nv
    return _clip_llr(torch.stack([sym.real * s, sym.imag * s], dim=-1))


def demodulate_frame(cfg: OTFSConfig, mod: Modulation,
                     samples: torch.Tensor) -> torch.Tensor:
    """[B, frame_len] aligned at the PREAMBLE start -> LLRs [B, M*N*bits].

    OTFS_EQ: ZF TF equalization with the preamble channel estimate;
    OTFS_RAW: the raw TF grid straight into the SFFT (otfs.cpp:694-708).
    DD symbols power-normalized, fixed nv = 0.1 for demapping."""
    B = samples.shape[0]
    pre = samples[:, :cfg.preamble_len]
    data = samples[:, cfg.preamble_len:cfg.preamble_len
                   + cfg.N * cfg.sym_len]
    tf = _rx_tf(cfg, data, t_offset=0)                     # [B, N, M]
    if cfg.tf_equalization:
        h = estimate_channel(cfg, pre)                     # [B, M]
        hp = h.abs() ** 2
        eq = torch.where((hp > 0.01)[:, None, :],
                         tf * h.conj()[:, None, :]
                         / torch.clamp(hp, min=1e-30)[:, None, :], tf)
    else:
        eq = tf
    flat = sfft(eq).reshape(B, -1)
    p = flat.abs() ** 2
    nz = p > 1e-8
    avg = torch.where(nz, p, 0.0).sum(-1) / torch.clamp(nz.sum(-1), min=1)
    scale = torch.where(avg > 1e-6, 1.0 / torch.sqrt(torch.clamp(
        avg, min=1e-30)), 1.0)
    return _soft_demap(mod, flat * scale[:, None],
                       FIXED_DD_NOISE_VAR).reshape(B, -1)


def detect_frame(cfg: OTFSConfig, samples: torch.Tensor,
                 threshold: float = 0.7):
    """Repeated-symbol sync, batched (detectSyncReal + fineSyncPreamble,
    otfs.cpp:456-502): detection gates on ``threshold`` (the metric
    converges to SNR/(1+SNR)); the 0.98 rule is only fine timing, with the
    leading edge of the coarse crossing's plateau (the first point within
    95% of its peak over 2 symbols) as the fallback.  The window sums are
    block-stable.  Returns (found [B], start [B] int32)."""
    L = cfg.sym_len
    B, T = samples.shape
    dev = samples.device
    tail = samples[:, L:]
    P = window_sum(samples[:, :-L] * tail, L)
    R = window_sum(tail * tail, L)
    metric = P.abs() / (R + 1e-10)
    metric = torch.where(R / L > 1e-6, metric, 0.0)

    coarse = metric > threshold
    found = coarse.any(-1)
    fine = metric > 0.98
    start_fine = torch.argmax(fine.to(torch.uint8), dim=-1)
    first_c = torch.argmax(coarse.to(torch.uint8), dim=-1)
    widx = torch.clamp(first_c[:, None] + torch.arange(2 * L, device=dev),
                       0, metric.shape[-1] - 1)
    wmet = metric.gather(1, widx)
    pv = wmet.amax(-1, keepdim=True)
    lead = torch.argmax((wmet >= 0.95 * pv).to(torch.uint8), dim=-1)
    start_coarse = widx.gather(1, lead[:, None])[:, 0]
    start = torch.where(fine.any(-1), start_fine, start_coarse)
    return found, start.to(torch.int32)


def decode_otfs_batch(cfg: OTFSConfig, mod: Modulation, rate: CodeRate,
                      samples: torch.Tensor):
    """The OTFS receiver step on [B, T] buffers that each hold one frame at
    an unknown position: ``detect_frame`` -> each row cut at its detected
    preamble start (clipped into the buffer) -> ``demodulate_frame`` ->
    LDPC decode of the first codeword.  Nothing is read to the host.

    Returns (info [B, k] uint8, ok [B] bool (decoded AND found),
    iters [B] int32, found [B], start [B])."""
    code = ldpc_codes.get_code(rate)
    found, start = detect_frame(cfg, samples)
    llrs = demodulate_frame(cfg, mod, frame_spans(samples, start,
                                                  cfg.frame_len))
    graph = ldpc_ops.graph_for(code, samples.device)
    llr_total, ok, iters = ldpc_ops.decode_totals(
        graph, llrs[:, :code.n].contiguous())
    info = (llr_total[:, :code.k] < 0).to(torch.uint8)
    return info, ok & found, iters, found, start

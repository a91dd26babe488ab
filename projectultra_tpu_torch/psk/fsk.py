"""BFSK and adaptive 2-32-tone MFSK, the very-low-SNR fallback waveforms
(port of projectultra_tpu/psk/fsk.py; reference src/fsk/fsk.hpp and
src/fsk/mfsk.hpp).

The reference's per-sample Goertzel loops are one [..., L] x [L, tones]
tone-basis matmul per batch of symbols (the same unscaled |DFT|^2
powers).  The preamble search scores every L/4-strided candidate offset
at once from the tone powers of the strided windows, computed only for
the windows a candidate can read (the JAX module computes them for the
whole buffer; a ``robust`` frame is ~4 M samples, of which the search
reads the first ~3 preambles).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..config import CodeRate
from ..device import host_table
from ..fec import ldpc as ldpc_codes
from ..ops import ldpc as ldpc_ops
from ..sync.chirp import frame_spans


@dataclasses.dataclass(frozen=True)
class FSKConfig:
    """(fsk.hpp:21-33)"""
    sample_rate: float = 48000.0
    center_freq: float = 1500.0
    freq_separation: float = 50.0
    samples_per_symbol: int = 1536
    repetition: int = 4

    @property
    def mark_freq(self) -> float:
        return self.center_freq + self.freq_separation / 2

    @property
    def space_freq(self) -> float:
        return self.center_freq - self.freq_separation / 2


@functools.lru_cache(maxsize=None)
def _tone_tables(cfg: FSKConfig):
    i = np.arange(cfg.samples_per_symbol, dtype=np.float64) / cfg.sample_rate
    mark = np.cos(2 * np.pi * cfg.mark_freq * i).astype(np.float32)
    space = np.cos(2 * np.pi * cfg.space_freq * i).astype(np.float32)
    mark_iq = np.exp(-2j * np.pi * cfg.mark_freq * i).astype(np.complex64)
    space_iq = np.exp(-2j * np.pi * cfg.space_freq * i).astype(np.complex64)
    return mark, space, mark_iq, space_iq


def generate_preamble(cfg: FSKConfig, num_symbols: int = 16) -> np.ndarray:
    """Alternating space/mark tones (fsk.hpp:42-51)."""
    mark, space, _, _ = _tone_tables(cfg)
    return np.concatenate([mark if (i % 2 == 1) else space
                           for i in range(num_symbols)])


def modulate(cfg: FSKConfig, bits: torch.Tensor) -> torch.Tensor:
    """[B, nbits] -> [B, nbits*rep*sps]: each bit repeated ``repetition``
    times, mark = 1, space = 0."""
    mark, space, _, _ = host_table(bits.device, _tone_tables, cfg)
    rep = torch.repeat_interleave(bits.to(torch.float32), cfg.repetition,
                                  dim=-1)[..., None]
    out = rep * mark + (1.0 - rep) * space
    return out.reshape(bits.shape[0], -1)


def demodulate_soft(cfg: FSKConfig, samples: torch.Tensor) -> torch.Tensor:
    """Noncoherent tone discrimination + repetition combining: LLR > 0 =>
    bit 0 (space)."""
    _, _, mark_iq, space_iq = host_table(samples.device, _tone_tables, cfg)
    L = cfg.samples_per_symbol
    S = samples.shape[-1] // L
    x = samples[..., :S * L].reshape(*samples.shape[:-1], S, L).to(
        torch.complex64)
    e_mark = (x @ mark_iq).abs() / L
    e_space = (x @ space_iq).abs() / L
    per_sym = (e_space - e_mark) * 40.0
    nbits = S // cfg.repetition
    comb = per_sym[..., :nbits * cfg.repetition].reshape(
        *per_sym.shape[:-1], nbits, cfg.repetition).sum(-1)
    return torch.clamp(comb, -10.0, 10.0)


# ---------------------------------------------------------------------------
# Adaptive MFSK (mfsk.hpp): 2/4/8/16/32 tones, tone-sweep preamble,
# noncoherent Goertzel-power detection, repetition combining.
# ---------------------------------------------------------------------------

MFSK_MIN_ENERGY = 1.0            # mfsk.hpp:187 (coarse gate; *0.5 in fine)
MFSK_MIN_DOMINANCE = 0.2         # mfsk.hpp:190
MFSK_SCORE_THRESHOLD = 0.6       # mfsk.hpp:268
MFSK_VALID_FRACTION = 0.3        # mfsk.hpp:258 (>= 30% symbols with energy)


@dataclasses.dataclass(frozen=True)
class MFSKConfig:
    """(mfsk.hpp:25-58)"""
    sample_rate: float = 48000.0
    center_freq: float = 1500.0
    tone_spacing: float = 50.0
    num_tones: int = 8           # 2, 4, 8, 16, or 32
    samples_per_symbol: int = 1536
    repetition: int = 2

    @property
    def bits_per_symbol(self) -> int:
        return int(np.log2(self.num_tones))

    @property
    def symbol_rate(self) -> float:
        return self.sample_rate / self.samples_per_symbol

    @property
    def raw_bps(self) -> float:
        return self.symbol_rate * self.bits_per_symbol

    @property
    def effective_bps(self) -> float:
        return self.raw_bps / self.repetition

    def tone_freq(self, tone_idx: int) -> float:
        off = (tone_idx - (self.num_tones - 1) / 2.0) * self.tone_spacing
        return self.center_freq + off

    def preamble_samples(self, cycles: int = 2) -> int:
        return cycles * self.num_tones * self.samples_per_symbol


# SNR presets (mfsk_presets, mfsk.hpp:545-582).
def mfsk_robust():  return MFSKConfig(num_tones=2, repetition=4)   # ~30 bps
def mfsk_low_snr(): return MFSKConfig(num_tones=4, repetition=3)   # ~45 bps
def mfsk_medium():  return MFSKConfig(num_tones=8, repetition=2)   # ~62 bps
def mfsk_fast():    return MFSKConfig(num_tones=16, repetition=2)  # ~94 bps
def mfsk_turbo():   return MFSKConfig(num_tones=32, repetition=1)  # ~156 bps


@functools.lru_cache(maxsize=None)
def _mfsk_tables(cfg: MFSKConfig):
    """(tone frequencies [T], tone DFT basis cos/sin [L, T], per-tone
    per-symbol phase steps [T]), f32."""
    L, T = cfg.samples_per_symbol, cfg.num_tones
    freqs = np.array([cfg.tone_freq(t) for t in range(T)], np.float64)
    n = np.arange(L, dtype=np.float64)[:, None] / cfg.sample_rate
    w = 2 * np.pi * freqs[None, :] * n
    basis_c = np.cos(w).astype(np.float32)
    basis_s = np.sin(w).astype(np.float32)
    dphi = (2 * np.pi * freqs * L / cfg.sample_rate).astype(np.float32)
    return freqs.astype(np.float32), basis_c, basis_s, dphi


def _bit_masks(cfg: MFSKConfig) -> np.ndarray:
    """[bits, T] bool: tone t has bit b (MSB first) set."""
    bps = cfg.bits_per_symbol
    tones = np.arange(cfg.num_tones)
    return np.stack([(tones & (1 << (bps - 1 - b))) != 0 for b in range(bps)])


@functools.lru_cache(maxsize=None)
def _cfo_bases(cfg: MFSKConfig, cycles: int):
    """The [L, n_sym] cos and sin bases of mfsk_estimate_cfo, at each
    preamble symbol's tone offset by -spacing/2, 0, +spacing/2 (cos, sin,
    cos, sin, cos, sin)."""
    L = cfg.samples_per_symbol
    freqs = np.array([cfg.tone_freq(t) for t in mfsk_preamble_tones(
        cfg, cycles)], np.float64)
    half = cfg.tone_spacing * 0.5
    n = np.arange(L, dtype=np.float64)[:, None] / cfg.sample_rate
    out = []
    for df in (-half, 0.0, half):
        w = 2 * np.pi * (freqs[None, :] + df) * n
        out += [np.cos(w).astype(np.float32), np.sin(w).astype(np.float32)]
    return tuple(out)


def mfsk_tone_powers(cfg: MFSKConfig, syms: torch.Tensor) -> torch.Tensor:
    """[..., L] -> [..., T] unscaled |DFT|^2 at the tone bins, the Goertzel
    power of mfsk.hpp:523-538."""
    _, bc, bs, _ = host_table(syms.device, _mfsk_tables, cfg)
    c = syms @ bc
    s = syms @ bs
    return c * c + s * s


def mfsk_preamble_tones(cfg: MFSKConfig, cycles: int = 2) -> np.ndarray:
    """Tone sweep 0..T-1 repeated ``cycles`` times (generatePreamble)."""
    return np.tile(np.arange(cfg.num_tones, dtype=np.int32), cycles)


def mfsk_modulate_tones(cfg: MFSKConfig, tones: torch.Tensor) -> torch.Tensor:
    """[B, S] tone indices -> [B, S*L] float32 passband with CONTINUOUS
    phase across symbol boundaries (modulateTone's running phase,
    mfsk.hpp:123-135)."""
    freqs, _, _, dphi = host_table(tones.device, _mfsk_tables, cfg)
    L = cfg.samples_per_symbol
    tones = tones.to(torch.int64)
    f = freqs[tones]
    step = dphi[tones]
    phase0 = torch.cumsum(step, dim=-1) - step
    t = torch.arange(L, dtype=torch.float32, device=tones.device) \
        / cfg.sample_rate
    ph = phase0[..., None] + 2 * math.pi * f[..., None] * t
    return torch.sin(ph).reshape(tones.shape[0], -1)


def mfsk_generate_preamble(cfg: MFSKConfig, cycles: int = 2) -> np.ndarray:
    tones = torch.from_numpy(mfsk_preamble_tones(cfg, cycles))[None]
    return mfsk_modulate_tones(cfg, tones).numpy()[0]


def mfsk_bits_to_tones(cfg: MFSKConfig, bits: torch.Tensor) -> torch.Tensor:
    """[B, nbits] -> [B, S] tone indices, MSB first, each symbol repeated
    ``repetition`` times (mfsk.hpp:84-120)."""
    bps = cfg.bits_per_symbol
    B, nbits = bits.shape
    n_sym = -(-nbits // bps)
    padded = torch.nn.functional.pad(bits.to(torch.int32),
                                     (0, n_sym * bps - nbits))
    weights = 1 << torch.arange(bps - 1, -1, -1, dtype=torch.int32,
                                device=bits.device)
    tones = (padded.reshape(B, n_sym, bps) * weights).sum(-1)
    return torch.repeat_interleave(tones, cfg.repetition, dim=-1)


def mfsk_modulate(cfg: MFSKConfig, bits: torch.Tensor) -> torch.Tensor:
    return mfsk_modulate_tones(cfg, mfsk_bits_to_tones(cfg, bits))


def mfsk_find_preamble(cfg: MFSKConfig, samples: torch.Tensor,
                       cycles: int = 2, valid_len=None):
    """Batched tone-sweep preamble search (findPreamble, mfsk.hpp:173-283).

    Tone powers of the L/4-strided windows (a strided view, no copy) that
    candidate offsets read; every candidate then scores its expected sweep
    from them.  The gates: per-symbol energy > MIN_ENERGY*0.5 to count as
    valid, >= 30% valid symbols, tone-error kernel 1/0.5/0.25, final score
    >= 0.6.  ``valid_len`` ([B] or scalar) masks offsets whose preamble
    would run past the real samples of a zero-padded buffer.

    Returns (found [B] bool, data_start [B] int32): data_start is the
    first sample after the preamble."""
    B, T = samples.shape
    dev = samples.device
    L = cfg.samples_per_symbol
    step = L // 4
    n_sym = cycles * cfg.num_tones
    pre_len = n_sym * L
    max_search = min(T - pre_len, 2 * pre_len)
    if max_search < 0:
        return (torch.zeros((B,), dtype=torch.bool, device=dev),
                torch.zeros((B,), dtype=torch.int32, device=dev))
    K = (T - L) // step + 1
    n_off = max_search // step + 1
    K_read = min(K, n_off + 4 * (n_sym - 1))      # windows a candidate reads
    wins = samples.unfold(-1, L, step)[:, :K_read]                # [B, K, L]
    powers = mfsk_tone_powers(cfg, wins)                          # [B, K, T]

    offs = torch.arange(n_off, device=dev)
    sym_win = torch.clamp(offs[:, None] + 4 * torch.arange(
        n_sym, device=dev)[None, :], max=K - 1)                   # [O, n_sym]
    p = powers[:, sym_win, :]                                     # [B,O,n,T]
    total = p.sum(-1)
    best = torch.argmax(p, dim=-1)
    expected = host_table(dev, mfsk_preamble_tones, cfg, cycles)
    err = (best - expected).abs()
    kernel = torch.where(err == 0, 1.0, torch.where(
        err == 1, 0.5, torch.where(err == 2, 0.25, 0.0)))
    valid = total > MFSK_MIN_ENERGY * 0.5
    score = torch.where(valid, kernel, 0.0).sum(-1) / n_sym       # [B, O]
    enough = valid.sum(-1) >= int(np.ceil(n_sym * MFSK_VALID_FRACTION))
    score = torch.where(enough, score, 0.0)
    if valid_len is not None:
        vl = torch.as_tensor(valid_len, device=dev).to(torch.int64) \
            .reshape(-1, 1)
        score = torch.where(offs[None, :] * step + pre_len <= vl, score, 0.0)

    best_o = torch.argmax(score, dim=-1)
    found = score.gather(1, best_o[:, None])[:, 0] >= MFSK_SCORE_THRESHOLD
    return found, (best_o * step + pre_len).to(torch.int32)


def mfsk_demodulate_soft(cfg: MFSKConfig, samples: torch.Tensor,
                         cfo_hz=None) -> torch.Tensor:
    """[B, n_sym*rep*L] aligned at data start -> [B, n_sym*bits] LLRs.
    Repetition powers combine by SUM before the power-ratio LLR
    (demodulateSoft + tonePowersToLLR, mfsk.hpp:318-520); positive LLR =
    bit 0.  ``cfo_hz`` ([B]) shifts the received tones down by the CFO
    before the tone basis (updateGoertzelForCFO's shifted detection)."""
    B, T = samples.shape
    dev = samples.device
    L, rep = cfg.samples_per_symbol, cfg.repetition
    n_sym = T // (rep * L)
    x = samples[:, :n_sym * rep * L]
    if cfo_hz is not None:
        t = torch.arange(x.shape[-1], dtype=torch.float32, device=dev) \
            / cfg.sample_rate
        cfo = torch.as_tensor(cfo_hz, device=dev).to(torch.float32)
        w = 2 * math.pi * cfo[:, None] * t[None, :]
        xr = (x * torch.cos(w)).reshape(B, n_sym, rep, L)
        xi = (-(x * torch.sin(w))).reshape(B, n_sym, rep, L)
        _, bc, bs, _ = host_table(dev, _mfsk_tables, cfg)
        c = xr @ bc + xi @ bs
        s = -(xr @ bs) + xi @ bc
        p = (c * c + s * s).sum(2)
    else:
        p = mfsk_tone_powers(cfg, x.reshape(B, n_sym, rep, L)).sum(2)

    llrs = []
    for m1 in host_table(dev, _bit_masks, cfg):
        p1 = torch.where(m1, p, 0.0).sum(-1)
        p0 = torch.where(m1, 0.0, p).sum(-1)
        llrs.append(torch.log((p0 + 1e-10) / (p1 + 1e-10)))
    return torch.clamp(torch.stack(llrs, dim=-1).reshape(B, -1), -10.0, 10.0)


def mfsk_estimate_cfo(cfg: MFSKConfig, samples: torch.Tensor,
                      preamble_start: torch.Tensor,
                      cycles: int = 2) -> torch.Tensor:
    """Parabolic-interpolated CFO from the preamble sweep (estimateCFO,
    mfsk.hpp:415-470): power at f and f +- spacing/2 per expected tone
    symbol, log-domain parabolic peak, mean over confident symbols."""
    B, T = samples.shape
    dev = samples.device
    L = cfg.samples_per_symbol
    n_sym = cycles * cfg.num_tones
    half = cfg.tone_spacing * 0.5
    idx = (preamble_start.to(torch.int64)[:, None, None]
           + L * torch.arange(n_sym, device=dev)[None, :, None]
           + torch.arange(L, device=dev)[None, None, :])
    idx = torch.clamp(idx, 0, T - 1)
    syms = samples.gather(1, idx.reshape(B, -1)).reshape(B, n_sym, L)
    out = []
    bases = host_table(dev, _cfo_bases, cfg, cycles)
    for bc, bs in zip(bases[::2], bases[1::2]):
        c = torch.einsum("bsl,ls->bs", syms, bc)
        s = torch.einsum("bsl,ls->bs", syms, bs)
        out.append(c * c + s * s)
    p_lo, p_c, p_hi = out
    db_lo, db_c, db_hi = (torch.log(torch.clamp(q, min=1e-12)) for q in out)
    denom = db_lo - 2 * db_c + db_hi
    x = 0.5 * (db_lo - db_hi) / torch.where(denom.abs() > 1e-3, denom, 1e9)
    ferr = x * half
    okmask = ((torch.maximum(torch.maximum(p_lo, p_c), p_hi) >= 0.01)
              & (ferr.abs() < half) & (denom.abs() > 1e-3))
    cnt = okmask.sum(-1)
    return torch.where(cnt >= 3, torch.where(okmask, ferr, 0.0).sum(-1)
                       / torch.clamp(cnt, min=1), 0.0).to(torch.float32)


def decode_mfsk_batch(cfg: MFSKConfig, rate: CodeRate,
                      samples: torch.Tensor):
    """The MFSK receiver step on [B, T] buffers that each hold one frame of
    one codeword at an unknown position (tests/test_mfsk.py:39-49):
    ``mfsk_find_preamble`` -> each row cut at its data start (clipped into
    the buffer) -> ``mfsk_demodulate_soft`` -> LDPC decode.  Nothing is
    read to the host.

    Returns (info [B, k] uint8, ok [B] bool (decoded AND found),
    iters [B] int32, found [B], data_start [B])."""
    code = ldpc_codes.get_code(rate)
    found, ds = mfsk_find_preamble(cfg, samples)
    n_sym = -(-code.n // cfg.bits_per_symbol) * cfg.repetition
    span = frame_spans(samples, ds, n_sym * cfg.samples_per_symbol)
    llrs = mfsk_demodulate_soft(cfg, span)
    graph = ldpc_ops.graph_for(code, samples.device)
    llr_total, ok, iters = ldpc_ops.decode_totals(
        graph, llrs[:, :code.n].contiguous())
    info = (llr_total[:, :code.k] < 0).to(torch.uint8)
    return info, ok & found, iters, found, ds

"""Single-carrier DPSK, the low-SNR floor waveform (port of
projectultra_tpu/psk/dpsk.py; reference src/psk/dpsk.hpp).

* symbol correlation at every offset is one FFT matched filter against the
  single-carrier analytic template (FFT length: the next power of two);
* the Barker-13x3 differential preamble search scores every coarse offset
  at once from 39 shifted slices of that correlation (the JAX module
  gathers an [offsets, 39] grid, which for the 1,536-sample preset is
  239,616 x 39 symbols a frame; the slices hold one [B, offsets] array at a
  time);
* ``demodulate_soft`` is a shifted-multiply differential chain.

Preserved semantics: DQPSK steps (2v+1)*45 deg (dpsk.hpp:80-84), D8PSK
v*45+22.5 deg, raised-cosine pulse shaping on data symbols only, preamble
at full amplitude with continuous carrier phase, confidence =
min(10*|diff|, 5), sin-based LLRs (dpsk.hpp:1000-1053).

``tx_dpsk_frame`` builds the sweep's DPSK frames on the device (encode,
preamble, ``modulate``, lead and tail zeros); ``decode_dpsk_batch`` is the
device part of the JAX sweep's DPSK point (parallel/sweep.py:172-209):
find, cut each row at its data start, soft demodulate, LDPC decode.  Their
stages are program spans (``utils/metrics.span``): ``dpsk.tx``,
``dpsk.rx``, and inside it ``dpsk.find`` and ``dpsk.demodulate``.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import math

import numpy as np
import torch

from ..config import CodeRate
from ..fec import ldpc as ldpc_codes
from ..ops import ldpc as ldpc_ops
from ..ops.dpsk_score import dpsk_score
from ..ops.sc_windows import window_sum
from ..sync.chirp import frame_spans
from ..utils import metrics

BARKER13 = np.array([1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1, 1], np.int32)
PREAMBLE_REPEATS = 3
DPSK_TRAINING_SYMBOLS = 8
DETECTION_THRESHOLD = 0.80
GLOBAL_OUTLIER_RATIO = 1.3
MIN_SYMBOL_ENERGY = 0.001
REFINE_SYMBOLS = 6
# The signs of the preamble's 38 symbol-to-symbol differentials.
EXPECTED_SIGNS = np.tile(BARKER13, PREAMBLE_REPEATS)[1:].astype(np.float32)

TWO_PI = 2.0 * math.pi


class DPSKModulation(enum.IntEnum):
    DBPSK = 0
    DQPSK = 1
    D8PSK = 2


@dataclasses.dataclass(frozen=True)
class DPSKConfig:
    """(dpsk.hpp:42-99)"""
    sample_rate: float = 48000.0
    carrier_freq: float = 1500.0
    samples_per_symbol: int = 1536
    modulation: DPSKModulation = DPSKModulation.DQPSK
    rolloff: float = 0.35
    use_pulse_shaping: bool = True

    @property
    def bits_per_symbol(self) -> int:
        return {DPSKModulation.DBPSK: 1, DPSKModulation.DQPSK: 2,
                DPSKModulation.D8PSK: 3}[self.modulation]

    @property
    def symbol_rate(self) -> float:
        return self.sample_rate / self.samples_per_symbol

    @property
    def preamble_symbols(self) -> int:
        return len(BARKER13) * PREAMBLE_REPEATS

    @property
    def preamble_samples(self) -> int:
        return self.preamble_symbols * self.samples_per_symbol

    def phase_increment(self, v: np.ndarray) -> np.ndarray:
        """Differential phase step per symbol value (dpsk.hpp:75-89)."""
        v = np.asarray(v)
        if self.modulation == DPSKModulation.DBPSK:
            return np.where(v > 0, np.pi, 0.0).astype(np.float32)
        if self.modulation == DPSKModulation.DQPSK:
            return ((v * 2 + 1) * np.pi / 4.0).astype(np.float32)
        return ((v & 7) * np.pi / 4.0 + np.pi / 8.0).astype(np.float32)


# Presets (dpsk.hpp:1064-1169).
def robust(): return DPSKConfig(modulation=DPSKModulation.DBPSK, samples_per_symbol=1536)
def low_snr(): return DPSKConfig(modulation=DPSKModulation.DBPSK, samples_per_symbol=768)
def medium(): return DPSKConfig(modulation=DPSKModulation.DQPSK, samples_per_symbol=768)
def fast(): return DPSKConfig(modulation=DPSKModulation.DQPSK, samples_per_symbol=384)
def turbo(): return DPSKConfig(modulation=DPSKModulation.D8PSK, samples_per_symbol=384)
def high_speed(): return DPSKConfig(modulation=DPSKModulation.DQPSK, samples_per_symbol=192)
def speed1(): return DPSKConfig(modulation=DPSKModulation.DQPSK, samples_per_symbol=160)
def speed2(): return DPSKConfig(modulation=DPSKModulation.DQPSK, samples_per_symbol=128)
def speed3(): return DPSKConfig(modulation=DPSKModulation.DQPSK, samples_per_symbol=96)
def speed4(): return DPSKConfig(modulation=DPSKModulation.D8PSK, samples_per_symbol=128)
def max_speed(): return DPSKConfig(modulation=DPSKModulation.D8PSK, samples_per_symbol=64)


# ---------------------------------------------------------------------------
# Host tables (numpy) and their per-device copies
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _carrier(cfg: DPSKConfig):
    """cos / sin tables for one symbol (carrier phase restarts each symbol:
    every preset has an integer number of carrier cycles per symbol)."""
    i = np.arange(cfg.samples_per_symbol, dtype=np.float64)
    ph = 2.0 * np.pi * cfg.carrier_freq * i / cfg.sample_rate
    return np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pulse_shape(cfg: DPSKConfig) -> np.ndarray:
    """Raised-cosine envelope 0.5*(1 - cos(2*pi*t/N)) (dpsk.hpp:281-293)."""
    if not cfg.use_pulse_shaping:
        return np.ones(cfg.samples_per_symbol, np.float32)
    t = np.arange(cfg.samples_per_symbol, dtype=np.float64) \
        / cfg.samples_per_symbol
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * t))).astype(np.float32)


def _barker_phases() -> np.ndarray:
    return np.cumsum(np.where(np.tile(BARKER13, PREAMBLE_REPEATS) < 0,
                              np.pi, 0.0))


@functools.lru_cache(maxsize=None)
def generate_preamble(cfg: DPSKConfig) -> np.ndarray:
    """Barker-13 x3 DBPSK at full amplitude, continuous carrier
    (dpsk.hpp:108-149)."""
    i = np.arange(cfg.samples_per_symbol, dtype=np.float64)
    ph = 2.0 * np.pi * cfg.carrier_freq * i / cfg.sample_rate
    out = np.cos(ph[None, :] + _barker_phases()[:, None]).astype(np.float32)
    return out.reshape(-1)


@functools.lru_cache(maxsize=None)
def generate_training(cfg: DPSKConfig) -> np.ndarray:
    """8 alternating 0/180-deg DBPSK symbols (dpsk.hpp:175-200)."""
    sym_phase = np.where(np.arange(DPSK_TRAINING_SYMBOLS) % 2 == 0, 0.0, np.pi)
    i = np.arange(cfg.samples_per_symbol, dtype=np.float64)
    ph = 2.0 * np.pi * cfg.carrier_freq * i / cfg.sample_rate
    return np.cos(ph[None, :] + sym_phase[:, None]).astype(
        np.float32).reshape(-1)


@functools.lru_cache(maxsize=None)
def generate_reference(cfg: DPSKConfig) -> np.ndarray:
    """Single 0-deg reference symbol (dpsk.hpp:155-172)."""
    i = np.arange(cfg.samples_per_symbol, dtype=np.float64)
    return np.cos(2.0 * np.pi * cfg.carrier_freq * i / cfg.sample_rate
                  ).astype(np.float32)


class _Tables:
    """The per-config tables on one device."""

    def __init__(self, cfg: DPSKConfig, device: torch.device):
        cos_t, sin_t = _carrier(cfg)
        i = np.arange(cfg.samples_per_symbol, dtype=np.float64)
        ph = (2.0 * np.pi * cfg.carrier_freq * i
              / cfg.sample_rate).astype(np.float32)
        bc = cfg.bits_per_symbol

        def on(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        self.cos, self.sin = on(cos_t), on(sin_t)
        self.phase = on(ph)
        self.env = on(_pulse_shape(cfg))
        self.steps = on(cfg.phase_increment(np.arange(2 ** bc)))
        self.weights = on((1 << np.arange(bc - 1, -1, -1)).astype(np.int32))
        expected = np.tile(BARKER13, PREAMBLE_REPEATS)[1:]
        self.expected = on(expected.astype(np.float32))           # [38]
        self.barker = on(np.exp(1j * _barker_phases().astype(np.float32))
                         .astype(np.complex64))
        k = min(10, len(expected))
        self.exp_ph = on(np.where(expected[:k] > 0, 0.0, np.pi)
                         .astype(np.float32))
        self.preamble = on(generate_preamble(cfg))
        self.tmpl6 = self.preamble[:REFINE_SYMBOLS * cfg.samples_per_symbol]


@functools.lru_cache(maxsize=None)
def _tables_on(cfg: DPSKConfig, device: torch.device) -> _Tables:
    return _Tables(cfg, device)


@functools.lru_cache(maxsize=None)
def _t6_energy(cfg: DPSKConfig) -> float:
    tmpl6 = generate_preamble(cfg)[:REFINE_SYMBOLS * cfg.samples_per_symbol]
    return float((tmpl6 ** 2).sum())


@functools.lru_cache(maxsize=None)
def _filters_on(cfg: DPSKConfig, n_fft: int, device: torch.device):
    """conj(fft(conj(template))) of the symbol matched filter and
    conj(fft(first 6 preamble symbols)) at n_fft, made once per device."""
    tb = _tables_on(cfg, device)
    tmpl_conj = torch.complex(tb.cos, tb.sin)         # conj(e^{-j w i})
    Tf = torch.fft.fft(tmpl_conj, n=n_fft).conj()
    T6 = torch.fft.fft(tb.tmpl6.to(torch.complex64), n=n_fft).conj()
    return Tf, T6


def _as_f32(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """(x + pi) mod 2*pi - pi, with jnp.mod's sign rule."""
    return torch.remainder(x + math.pi, TWO_PI) - math.pi


# ---------------------------------------------------------------------------
# TX
# ---------------------------------------------------------------------------

def modulate(cfg: DPSKConfig, bits: torch.Tensor,
             initial_symbol_phase: float = 0.0) -> torch.Tensor:
    """[B, nbits] -> [B, S*L] pulse-shaped differential PSK.

    initial_symbol_phase: symbol phase carried over from the preamble
    (after Barker x3 the accumulated phase is 6 pi = 0 mod 2 pi; after
    training it is pi)."""
    B, nbits = bits.shape
    bc = cfg.bits_per_symbol
    S = -(-nbits // bc)
    tb = _tables_on(cfg, bits.device)
    b = torch.nn.functional.pad(bits.to(torch.int32), (0, S * bc - nbits))
    w = (b.reshape(B, S, bc) * tb.weights).sum(-1)
    theta = initial_symbol_phase + torch.cumsum(tb.steps[w], dim=1)  # [B, S]
    out = tb.env[None, None, :] * torch.cos(tb.phase[None, None, :]
                                            + theta[:, :, None])
    return out.reshape(B, S * cfg.samples_per_symbol)


def frame_samples(cfg: DPSKConfig, rate: CodeRate, lead: int = 4800,
                  tail: int = 4000) -> int:
    """T of ``tx_dpsk_frame``: 287,584 for ``medium`` at R1/4."""
    n_sym = -(-ldpc_codes.get_code(rate).n // cfg.bits_per_symbol)
    return lead + cfg.preamble_samples + n_sym * cfg.samples_per_symbol \
        + tail


def tx_dpsk_frame(cfg: DPSKConfig, rate: CodeRate, info: torch.Tensor,
                  lead: int = 4800, tail: int = 4000,
                  with_codeword: bool = False):
    """[B, k] info bits -> [B, T] float32 frames as the sweep's DPSK point
    lays them out: [lead zeros][Barker-13x3 preamble][one LDPC codeword,
    ``modulate``d][tail zeros], on the info bits' device.  With
    ``with_codeword`` the [B, n] float32 codewords follow the frames."""
    with metrics.span("dpsk.tx", info):
        B, dev = info.shape[0], info.device
        code = ldpc_codes.get_code(rate)
        cw = ldpc_ops.encode_with(ldpc_ops.graph_for(code, dev), info)
        pre = _tables_on(cfg, dev).preamble
        frame = torch.cat([torch.zeros((B, lead), device=dev),
                           pre.expand(B, pre.shape[0]), modulate(cfg, cw),
                           torch.zeros((B, tail), device=dev)], dim=-1)
        return (frame, cw) if with_codeword else frame


# ---------------------------------------------------------------------------
# RX
# ---------------------------------------------------------------------------

def correlate_symbols(cfg: DPSKConfig, samples: torch.Tensor) -> torch.Tensor:
    """[..., S*L] -> [..., S] complex symbol correlations (correlateSymbol,
    dpsk.hpp:777-789: I = mean s*cos, Q = -mean s*sin)."""
    tb = _tables_on(cfg, samples.device)
    L = cfg.samples_per_symbol
    S = samples.shape[-1] // L
    x = samples[..., :S * L].reshape(*samples.shape[:-1], S, L)
    return torch.complex(x @ tb.cos / L, -(x @ tb.sin) / L)


def demodulate_soft(cfg: DPSKConfig, data: torch.Tensor, prev: torch.Tensor,
                    cfo_hz=0.0, initial_phase_offset=0.0) -> torch.Tensor:
    """demodulateSoft (dpsk.hpp:822-878): differential decode with CFO and
    initial-phase compensation; confidence = min(10*|diff|, 5); sin-based
    LLRs.  [..., S*L] -> [..., S*bits]."""
    dev = data.device
    corr = correlate_symbols(cfg, data)                  # [..., S]
    prev_chain = torch.cat([prev[..., None], corr[..., :-1]], dim=-1)
    diff = corr * prev_chain.conj()
    mag = diff.abs()
    phase = torch.angle(diff)

    cfo = _as_f32(cfo_hz, dev)
    ipo = _as_f32(initial_phase_offset, dev)
    compensate = (cfo.abs() > 0.5) | (ipo.abs() > 0.01)
    cfo_phase = TWO_PI * cfo * cfg.samples_per_symbol / cfg.sample_rate
    comp = _wrap(phase - cfo_phase[..., None] - ipo[..., None])
    phase = torch.where(compensate[..., None], comp, phase)

    conf = torch.clamp(mag * 10.0, max=5.0)
    phase = torch.where(phase < 0, phase + TWO_PI, phase)

    if cfg.modulation == DPSKModulation.DBPSK:
        llrs = (conf * torch.cos(phase))[..., None]
    elif cfg.modulation == DPSKModulation.DQPSK:
        llrs = torch.stack([conf * torch.sin(phase),
                            conf * torch.sin(2.0 * phase)], dim=-1)
    else:
        llrs = torch.stack([conf * torch.sin(phase),
                            conf * torch.sin(2.0 * phase),
                            conf * torch.sin(4.0 * phase)], dim=-1)
    return llrs.reshape(*llrs.shape[:-2], -1)


def estimate_cfo_from_training(cfg: DPSKConfig,
                               training: torch.Tensor) -> torch.Tensor:
    """(dpsk.hpp:902-950): average deviation of the +pi alternating
    pattern."""
    corr = correlate_symbols(cfg, training)
    d = corr[..., 1:] * corr[..., :-1].conj()
    valid = (corr[..., 1:].abs() >= 0.01) & (corr[..., :-1].abs() >= 0.01)
    err = _wrap(torch.angle(d) - math.pi)
    n = valid.sum(-1)
    avg = torch.where(valid, err, 0.0).sum(-1) / torch.clamp(n, min=1)
    avg = torch.where(n > 0, avg, 0.0)
    sym_dur = cfg.samples_per_symbol / cfg.sample_rate
    return avg / (TWO_PI * sym_dur)


def set_reference_with_training(cfg: DPSKConfig, training: torch.Tensor,
                                ref: torch.Tensor):
    """(dpsk.hpp:955-1000) -> (prev_symbol, cfo_hz, initial_phase_offset)."""
    cfo = estimate_cfo_from_training(cfg, training)
    corr = correlate_symbols(cfg, training)
    last, prev = corr[..., -1], corr[..., -2]
    measured = torch.angle(last * prev.conj())
    cfo_phase = TWO_PI * cfo * cfg.samples_per_symbol / cfg.sample_rate
    ipo = _wrap(measured - cfo_phase - math.pi)
    ok = (prev.abs() > 0.01) & (last.abs() > 0.01)
    ipo = torch.where(ok, ipo, 0.0)
    return correlate_symbols(cfg, ref)[..., 0], cfo, ipo


def estimate_preamble_snr_db(cfg: DPSKConfig, preamble_samples: torch.Tensor,
                             cfo_hz) -> torch.Tensor:
    """Post-correlation SNR from the Barker preamble symbols: LS fit of one
    complex gain against the known 0/pi pattern (CFO-derotated with the
    caller's estimate, then by its own measured residual rotation),
    residual = noise (channel_equalizer.cpp:221 semantics)."""
    dev = preamble_samples.device
    tb = _tables_on(cfg, dev)
    corr = correlate_symbols(cfg, preamble_samples)
    n = cfg.preamble_symbols
    i = torch.arange(n, dtype=torch.float32, device=dev)
    w = (TWO_PI * _as_f32(cfo_hz, dev)[..., None]
         * cfg.samples_per_symbol / cfg.sample_rate)
    wi = w * i
    z = corr[..., :n] * torch.polar(torch.ones_like(wi), -wi) \
        * tb.barker.conj()
    d = z[..., 1:] * z[..., :-1].conj()
    w_res = torch.angle(d.mean(-1))
    wr = w_res[..., None] * i
    z = z * torch.polar(torch.ones_like(wr), -wr)
    h = z.mean(-1)
    resid = z - h[..., None]
    snr = h.abs() ** 2 / torch.clamp((resid.abs() ** 2).mean(-1), min=1e-12)
    return 10.0 * torch.log10(torch.clamp(snr, 1e-3, 1e5))


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def find_preamble(cfg: DPSKConfig, samples: torch.Tensor,
                  max_search_symbols: int = 156, valid_len=None):
    """Batched CFO-tolerant Barker-13x3 differential preamble search
    (findPreamble, dpsk.hpp:339-480) at every sample offset in
    [0, max_search), from an FFT matched filter's per-offset symbol
    correlations.

    ``valid_len`` ([B] or scalar): the number of real samples in a
    zero-padded streaming buffer; offsets whose preamble would run past it
    are masked out.  Rule A (the earliest offset above the threshold that
    dominates its own 13/26-symbol-shift sidelobes) wins when it validates,
    else rule B (the earliest within 85% of the global maximum).  Near zero
    CFO the offset is refined by a normalized matched filter over the first
    6 preamble symbols within +-1 symbol.  Nothing is read to the host.

    Returns (found [B] bool, data_start [B] int32, cfo_hz [B] f32,
    initial_phase_offset [B] f32, prev_symbol [B] complex64)."""
    with metrics.span("dpsk.find", samples):
        B, T = samples.shape
        dev = samples.device
        L = cfg.samples_per_symbol
        n_sym = cfg.preamble_symbols
        pre_n = cfg.preamble_samples
        tb = _tables_on(cfg, dev)
        n_fft = 1 << (T - 1).bit_length()
        Tf, T6 = _filters_on(cfg, n_fft, dev)

        X = torch.fft.fft(samples.to(torch.complex64), n=n_fft, dim=-1)
        corr_all = torch.fft.ifft(X * Tf, dim=-1)[:, :T - L + 1] / L
        n_corr = corr_all.shape[-1]

        # Differential pattern score (computeDifferentialScore,
        # dpsk.hpp:487-546) at offsets o < O: symbol j of offset o is
        # corr_all[o + j*L] (ops/dpsk_score.py; a kernel on the card).
        O = min(max_search_symbols * L, T - pre_n)
        score = dpsk_score(corr_all, L, n_sym, O, EXPECTED_SIGNS,
                           MIN_SYMBOL_ENERGY)
        offs = torch.arange(O, device=dev)
        vl = None
        if valid_len is not None:
            vl = torch.as_tensor(valid_len, device=dev).to(torch.int64) \
                .reshape(-1, 1)
            score = torch.where(offs[None, :] + pre_n <= vl, score, 0.0)

        gmax = score.amax(-1)
        global_avg = score[:, ::L].mean(-1)
        rel = torch.arange(-L, L + 1, device=dev)

        def pick(x, idx):
            return x.gather(1, idx[:, None])[:, 0]

        def resolve(strong):
            first = _first_true(strong)
            widx = torch.clamp(first[:, None] + rel[None, :], 0, O - 1)
            b = pick(widx, torch.argmax(score.gather(1, widx), dim=-1))
            bs = pick(score, b)
            f = strong.any(-1) & (bs >= DETECTION_THRESHOLD) \
                & (bs >= global_avg * GLOBAL_OUTLIER_RATIO)
            return f, b

        def shifted(k):
            # score at offset o+k; out of range reads -1 (never dominates).
            return torch.cat([score[:, k:], torch.full((B, min(k, O)), -1.0,
                                                       device=dev)], dim=-1)[:, :O]

        n13 = 13 * L
        dominated = (score < shifted(n13)) | (score < shifted(2 * n13))
        found_a, best_a = resolve((score >= DETECTION_THRESHOLD) & ~dominated)
        found_b, best_b = resolve(
            score >= torch.clamp(0.85 * gmax[:, None], min=DETECTION_THRESHOLD))
        best = torch.where(found_a, best_a, best_b)
        found = found_a | found_b

        # CFO estimate from the matched differentials (estimateCFOTolerant).
        sy = corr_all.gather(1, best[:, None]
                             + L * torch.arange(n_sym, device=dev)[None, :])
        d = sy[:, 1:] * sy[:, :-1].conj()
        dmag = d.abs()
        dn = torch.where(dmag > 1e-30, d / torch.clamp(dmag, min=1e-30), 0.0)
        csum = (dn * tb.expected).sum(-1)
        cfo = -torch.angle(csum) / (TWO_PI * (L / cfg.sample_rate))

        # Initial phase offset from the first 10 differentials.
        k = tb.exp_ph.shape[0]
        cfo_phase = (TWO_PI * cfo * L / cfg.sample_rate)[:, None]
        ipo = _wrap(torch.angle(dn[:, :k]) - cfo_phase - tb.exp_ph).mean(-1)

        # Matched-filter timing refinement near zero CFO
        # (refineTimingWithMatchedFilter, dpsk.hpp:709-770): normalized real
        # correlation against the first 6 preamble symbols within +-1 symbol
        # of the coarse peak; block-stable window energies.
        n6 = REFINE_SYMBOLS * L
        t6 = _t6_energy(cfg)
        e6 = window_sum(samples * samples, n6)               # [B, T-n6+1]
        pos = best[:, None] + rel[None, :]                   # [B, 2L+1]
        ok = (pos >= 0) & (pos < e6.shape[-1])
        if vl is not None:
            ok = ok & (pos + pre_n <= vl)
        posc = torch.clamp(pos, 0, e6.shape[-1] - 1)
        mf = torch.fft.ifft(X * T6, dim=-1).real.gather(1, posc)
        ew = e6.gather(1, posc) * t6
        nmf = torch.where(ew > 1e-20, mf.abs() / torch.sqrt(
            torch.clamp(ew, min=1e-30)), 0.0)
        nmf = torch.where(ok, nmf, -1.0)
        refined = torch.where(ok.any(-1),
                              pick(posc, torch.argmax(nmf, dim=-1)), 0)
        best = torch.where(cfo.abs() < 0.5, refined, best)

        # Re-gather the reference symbol (last preamble symbol) at the refined
        # position (findPreamble sets prev_symbol_ there, dpsk.hpp:466-472).
        prev_symbol = pick(corr_all, torch.clamp(best + (n_sym - 1) * L, 0,
                                                 n_corr - 1))
        return (found, (best + pre_n).to(torch.int32), cfo, ipo, prev_symbol)


def demodulate_detected(cfg: DPSKConfig, rate: CodeRate,
                        samples: torch.Tensor, data_start: torch.Tensor,
                        prev: torch.Tensor, cfo_hz: torch.Tensor,
                        initial_phase_offset: torch.Tensor) -> torch.Tensor:
    """[B, T] buffers -> the decoder's input LLRs [B, n]: each row cut at
    its detected data start (clipped into the buffer), then
    ``demodulate_soft`` at its detected CFO and phase."""
    with metrics.span("dpsk.demodulate", samples):
        n = ldpc_codes.get_code(rate).n
        n_sym = -(-n // cfg.bits_per_symbol)
        span = frame_spans(samples, data_start, n_sym * cfg.samples_per_symbol)
        return demodulate_soft(cfg, span, prev, cfo_hz,
                               initial_phase_offset)[:, :n].contiguous()


def decode_dpsk_batch(cfg: DPSKConfig, rate: CodeRate,
                      samples: torch.Tensor, with_llrs: bool = False):
    """The DPSK receiver step on [B, T] buffers that each hold one frame
    of one codeword at an unknown position (parallel/sweep.py:194-199):
    ``find_preamble`` -> each row cut at its own data start (clipped into
    the buffer) -> ``demodulate_soft`` at the detected CFO and phase ->
    LDPC decode.  Nothing is read to the host.

    Returns (info [B, k] uint8, ok [B] bool (decoded AND found),
    iters [B] int32, det dict of find_preamble's outputs), and with
    ``with_llrs`` the decoder's input LLRs [B, n] last."""
    with metrics.span("dpsk.rx", samples):
        code = ldpc_codes.get_code(rate)
        found, ds, cfo, ipo, prev = find_preamble(cfg, samples)
        llrs = demodulate_detected(cfg, rate, samples, ds, prev, cfo, ipo)
        graph = ldpc_ops.graph_for(code, samples.device)
        llr_total, ok, iters = ldpc_ops.decode_totals(graph, llrs)
        info = (llr_total[:, :code.k] < 0).to(torch.uint8)
        det = {"found": found, "data_start": ds, "cfo_hz": cfo,
               "initial_phase_offset": ipo, "prev_symbol": prev}
        out = (info, ok & found, iters, det)
        return (*out, llrs) if with_llrs else out

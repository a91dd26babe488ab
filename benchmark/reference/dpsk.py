"""Single-carrier DPSK of the reference: the Barker-13x3 preamble search
and the soft differential receiver, DQPSK, at CFO 0.

Written from the upstream modem's description of ``src/psk/dpsk.hpp``
(the presets :1064-1169, ``findPreamble`` :339-480,
``computeDifferentialScore`` :487-546, ``refineTimingWithMatchedFilter``
:709-770, ``correlateSymbol`` :777-789, ``demodulateSoft`` :822-878),
each step as a direct sum where the program uses an FFT or a kernel:

* TX: 39 preamble symbols at full amplitude, symbol j the carrier at the
  phase pi x (the -1 chips of the tiled Barker-13 up to j); then one LDPC
  codeword, two bits (MSB first) a symbol value w, each symbol the carrier
  advanced by (2w + 1) pi / 4 from the last (the phase accumulated in
  float32, starting at 0) under a raised-cosine envelope
  0.5 (1 - cos(2 pi i / L));
* the symbol correlation at every sample offset o, correlateSymbol's
  c(o) = (1/L) sum_i s[o+i] e^{-j w i}, as e^{j w o} times a direct sum of
  L mixed samples s[t] e^{-j w t} (no FFT);
* the differential score at each offset o < O = min(156 L, T - 39 L): the
  38 differentials d_j = c(o + jL) conj(c(o + (j-1)L)) normalised (0 where
  |d_j| <= 1e-10), signed by chip j and summed directly, |sum| / 38; 0
  where the 39 symbols' energy is below 0.001 a symbol;
* rule A (the earliest offset at or above 0.8 that no offset 13 or 26
  symbols later outscores), else rule B (the earliest within 85% of the
  largest score, and at least 0.8): the best score within one symbol of
  it, found if that score is at least 0.8 and 1.3 times the mean score of
  the offsets 0, L, 2L, ...;
* the CFO from the angle of the signed sum of the normalised differentials
  at the found offset, the initial phase from the first 10 of them; the
  same at each offset within one symbol whose score ties the found one's
  within 1e-5 (the score reads ~0.9996 over ~100 offsets about the
  frame's start, and 1-5 of them lie within 1e-5 of the peak: the found
  offset is a float32 near-tie, and the comparison takes the tie nearest
  the program's estimate);
* near zero CFO (|cfo| < 0.5 Hz) the offset refined within +-L by the
  largest |sum_i s[p+i] t6[i]| / sqrt(sum_i s[p+i]^2 x sum_i t6[i]^2) over
  the first 6 preamble symbols t6 (direct sums over each window);
* the reference symbol c(best + 38 L); each frame cut at best + 39 L
  (clipped into the buffer), demodulateSoft on its symbols;
* the plain min-sum decoder of ``ldpc.py``.

Departures from the upstream C++ that the program makes and that are kept
here: every sample offset is scored (the C++ searches a coarse grid, then
a fine one); rule A's sidelobe check and the choice between A and B; the
carrier restarts its phase each symbol (the C++ runs a float32 oscillator
across the frame, which drifts by up to 2e-2 over a long frame).  Plain
PyTorch on any device, float32; ``tx`` and ``rx`` turn TF32 off.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import ldpc
from .config import CodeRate

BARKER13 = (1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1, 1)
REPEATS = 3
THRESHOLD = 0.80
OUTLIER_RATIO = 1.3
NEAR_MAX = 0.85
MIN_ENERGY = 0.001
PHASE_DIFFS = 10
REFINE_SYMBOLS = 6
SEARCH_SYMBOLS = 156
#: Scores closer than this to the coarse peak's are ties of it: the search
#: in float32 through an FFT and through direct sums differs by ~1e-7.
TIE = 1e-5
#: demodulateSoft compensates the phase above these CFO and phase offsets.
CFO_GATE_HZ, PHASE_GATE = 0.5, 0.01
TWO_PI = 2.0 * math.pi


@dataclasses.dataclass(frozen=True)
class DPSKConfig:
    """A DQPSK preset: ``medium`` is 48 kHz, 1,500 Hz, 768 samples a
    symbol, raised-cosine data symbols."""
    sample_rate: float
    carrier_freq: float
    samples_per_symbol: int
    use_pulse_shaping: bool = True
    bits_per_symbol: int = 2

    @property
    def preamble_symbols(self) -> int:
        return len(BARKER13) * REPEATS


def chips() -> np.ndarray:
    return np.tile(np.asarray(BARKER13, np.int64), REPEATS)


def data_symbols(rate: CodeRate, cfg: DPSKConfig) -> int:
    return -(-ldpc.get_code(rate).n // cfg.bits_per_symbol)


def frame_samples(cfg: DPSKConfig, rate: CodeRate, lead: int,
                  tail: int) -> int:
    L = cfg.samples_per_symbol
    return lead + (cfg.preamble_symbols + data_symbols(rate, cfg)) * L + tail


def _carrier_phase(cfg: DPSKConfig, n: int) -> np.ndarray:
    """w t for t < n, float64."""
    return TWO_PI * cfg.carrier_freq * np.arange(n, dtype=np.float64) \
        / cfg.sample_rate


@functools.lru_cache(maxsize=None)
def preamble(cfg: DPSKConfig) -> np.ndarray:
    L = cfg.samples_per_symbol
    theta = math.pi * np.cumsum(chips() < 0)
    return np.cos(_carrier_phase(cfg, L)[None, :] + theta[:, None]) \
        .astype(np.float32).reshape(-1)


class Tables:
    """The preset's tables on one device."""

    def __init__(self, cfg: DPSKConfig, device: torch.device):
        L = cfg.samples_per_symbol

        def on(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        ph = _carrier_phase(cfg, L)
        self.phase = on(ph.astype(np.float32))
        self.cos = on(np.cos(ph).astype(np.float32))
        self.sin = on(np.sin(ph).astype(np.float32))
        if cfg.use_pulse_shaping:
            env = 0.5 * (1.0 - np.cos(TWO_PI * np.arange(L) / L))
        else:
            env = np.ones(L)
        self.env = on(env.astype(np.float32))
        # The phase advance of each symbol value w: (2w + 1) pi / 4.
        self.steps = on(((2 * np.arange(4) + 1) * math.pi / 4.0)
                        .astype(np.float32))
        self.preamble = on(preamble(cfg))
        self.t6 = self.preamble[:REFINE_SYMBOLS * L]
        self.t6_energy = float((preamble(cfg)[:REFINE_SYMBOLS * L]
                                .astype(np.float64) ** 2).sum())
        # The expected sign of differential j (1..38) is chip j's.
        self.signs = on(chips()[1:].astype(np.float32))
        self.sign_phase = on(np.where(chips()[1:PHASE_DIFFS + 1] > 0, 0.0,
                                      math.pi).astype(np.float32))


@functools.lru_cache(maxsize=None)
def tables(cfg: DPSKConfig, device: torch.device) -> Tables:
    return Tables(cfg, device)


@functools.lru_cache(maxsize=8)
def mixer(cfg: DPSKConfig, n: int, device: torch.device):
    """(cos w t, sin w t) for t < n, float32, from float64 phases."""
    ph = _carrier_phase(cfg, n)
    return (torch.from_numpy(np.cos(ph).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(ph).astype(np.float32)).to(device))


def _float32() -> None:
    """Float32 matrix products and convolutions on the card, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """x wrapped into [-pi, pi) (a floored modulo)."""
    return torch.remainder(x + math.pi, TWO_PI) - math.pi


# ---------------------------------------------------------------------------
# TX
# ---------------------------------------------------------------------------

def modulate(cfg: DPSKConfig, bits: torch.Tensor) -> torch.Tensor:
    """[B, nbits] {0,1} -> [B, S L] DQPSK symbols, the phase carried from
    the preamble's last symbol (0 mod 2 pi)."""
    tb = tables(cfg, bits.device)
    B, nbits = bits.shape
    S = -(-nbits // 2)
    b = torch.zeros((B, 2 * S), dtype=torch.int64, device=bits.device)
    b[:, :nbits] = bits.to(torch.int64)
    w = 2 * b[:, 0::2] + b[:, 1::2]
    theta = torch.cumsum(tb.steps[w], dim=1)
    sym = tb.env * torch.cos(tb.phase + theta[:, :, None])
    return sym.reshape(B, S * cfg.samples_per_symbol)


def tx(cfg: DPSKConfig, rate: CodeRate, info: torch.Tensor, lead: int,
       tail: int) -> torch.Tensor:
    """[B, k] info bits -> [B, T] frames: [lead zeros][preamble][one
    codeword][tail zeros]."""
    _float32()
    B, dev = info.shape[0], info.device
    graph = ldpc.Graph(ldpc.get_code(rate), dev)
    data = modulate(cfg, ldpc.encode(graph, info))
    pre = tables(cfg, dev).preamble
    return torch.cat([torch.zeros((B, lead), device=dev),
                      pre.expand(B, pre.shape[0]), data,
                      torch.zeros((B, tail), device=dev)], dim=-1)


# ---------------------------------------------------------------------------
# RX
# ---------------------------------------------------------------------------

def offset_correlations(cfg: DPSKConfig, samples: torch.Tensor,
                        n: int) -> torch.Tensor:
    """c(o) for o < n, [B, n] complex64: each window's sum of L mixed
    samples, rotated back to the window's own carrier phase."""
    L = cfg.samples_per_symbol
    x = samples[:, :n + L - 1]
    cos_t, sin_t = mixer(cfg, n + L - 1, samples.device)
    re = (x * cos_t).unfold(-1, L, 1).sum(-1)          # sum s cos(w t)
    im = -(x * sin_t).unfold(-1, L, 1).sum(-1)         # -sum s sin(w t)
    c, s = cos_t[:n], sin_t[:n]                        # e^{j w o}
    return torch.complex((re * c - im * s) / L, (re * s + im * c) / L)


def symbol_correlations(cfg: DPSKConfig, x: torch.Tensor) -> torch.Tensor:
    """[B, S L] -> [B, S]: correlateSymbol of each symbol."""
    tb = tables(cfg, x.device)
    L = cfg.samples_per_symbol
    sym = x.reshape(x.shape[0], -1, L)
    return torch.complex((sym * tb.cos).sum(-1) / L,
                         -(sym * tb.sin).sum(-1) / L)


def differential_score(cfg: DPSKConfig, corr: torch.Tensor,
                       O: int) -> torch.Tensor:
    """[B, O] score of offsets o < O from c [B, >= O + 38 L]."""
    tb = tables(cfg, corr.device)
    L, n_sym = cfg.samples_per_symbol, cfg.preamble_symbols
    total = torch.zeros((corr.shape[0], O), dtype=torch.complex64,
                        device=corr.device)
    energy = corr[:, :O].abs() ** 2
    for j in range(1, n_sym):
        cur, prev = corr[:, j * L:j * L + O], corr[:, (j - 1) * L:
                                                   (j - 1) * L + O]
        d = cur * prev.conj()
        mag = d.abs()
        unit = torch.where(mag > 1e-10, d / torch.clamp(mag, min=1e-30), 0.0)
        total = total + tb.signs[j - 1] * unit
        energy = energy + cur.abs() ** 2
    score = total.abs() / (n_sym - 1)
    return torch.where(energy >= MIN_ENERGY * n_sym, score, 0.0)


def _earliest_best(score: torch.Tensor, candidates: torch.Tensor,
                   L: int, floor: torch.Tensor):
    """(found, offset) of the rule whose candidates are ``candidates``:
    the earliest candidate, the best score within L of it (the earliest
    such), found when it passes the threshold and the outlier floor."""
    O = score.shape[-1]
    idx = torch.arange(O, device=score.device)
    first = torch.where(candidates, idx, O).amin(-1)
    first = torch.where(first == O, 0, first)
    near = (idx[None, :] - first[:, None]).abs() <= L
    best = torch.where(near, score, -math.inf).argmax(-1)
    top = score.gather(1, best[:, None])[:, 0]
    found = candidates.any(-1) & (top >= THRESHOLD) & (top >= floor)
    return found, best


def refine(cfg: DPSKConfig, samples: torch.Tensor,
           best: torch.Tensor) -> torch.Tensor:
    """The offset within +-L of ``best`` whose 6-symbol window matches the
    preamble's first 6 symbols best (normalised |correlation|); 0 where no
    window fits the buffer."""
    tb = tables(cfg, samples.device)
    L = cfg.samples_per_symbol
    B, T = samples.shape
    n6 = REFINE_SYMBOLS * L
    rel = torch.arange(-L, L + n6, device=samples.device)
    pos = best[:, None] + torch.arange(-L, L + 1, device=samples.device)
    fits = (pos >= 0) & (pos <= T - n6)
    idx = torch.clamp(best[:, None] + rel[None, :], 0, T - 1)
    seg = samples.gather(1, idx)                       # [B, 2L + n6]
    out = []
    for r in range(0, B, 8):
        win = seg[r:r + 8].unfold(-1, n6, 1)           # [b, 2L + 1, n6]
        mf = (win * tb.t6).sum(-1)
        energy = (win * win).sum(-1) * tb.t6_energy
        out.append(torch.where(energy > 1e-20, mf.abs() / torch.sqrt(
            torch.clamp(energy, min=1e-30)), 0.0))
    nmf = torch.where(fits, torch.cat(out), -1.0)
    pick = pos.gather(1, nmf.argmax(-1, keepdim=True))[:, 0]
    return torch.where(fits.any(-1), pick, 0)


def find_preamble(cfg: DPSKConfig, samples: torch.Tensor) -> dict:
    """The preamble search on [B, T] buffers: found [B] bool, data_start
    [B] int32, cfo_hz and initial_phase_offset [B] float32, prev_symbol [B]
    complex64; cfo_ties and phase_ties [B, 2L + 1], the estimates at the
    offsets within L of the coarse peak whose score ties it (NaN at the
    others)."""
    B, T = samples.shape
    L, n_sym = cfg.samples_per_symbol, cfg.preamble_symbols
    O = min(SEARCH_SYMBOLS * L, T - n_sym * L)
    n = min(T - L + 1, O + (n_sym + 1) * L)
    corr = offset_correlations(cfg, samples, n)
    score = differential_score(cfg, corr, O)

    floor = OUTLIER_RATIO * score[:, ::L].mean(-1)
    outscored = torch.zeros_like(score, dtype=torch.bool)
    for k in (13 * L, 26 * L):
        if k < O:
            outscored[:, :O - k] |= score[:, :O - k] < score[:, k:]
    found_a, best_a = _earliest_best(
        score, (score >= THRESHOLD) & ~outscored, L, floor)
    near_max = torch.clamp(NEAR_MAX * score.amax(-1, keepdim=True),
                           min=THRESHOLD)
    found_b, best_b = _earliest_best(score, score >= near_max, L, floor)
    best = torch.where(found_a, best_a, best_b)
    found = found_a | found_b

    symbols = L * torch.arange(n_sym, device=samples.device)
    cfo, phase = estimates(cfg, corr.gather(1, best[:, None] + symbols))
    # The same estimates at every offset within one symbol whose score ties
    # the chosen one's within TIE: a sum in another order may pick any of
    # them.
    near = torch.clamp(best[:, None] + torch.arange(
        -L, L + 1, device=samples.device), 0, O - 1)       # [B, 2L + 1]
    ties = score.gather(1, near) >= score.gather(1, best[:, None]) - TIE
    cfo_near, phase_near = estimates(cfg, corr.gather(
        1, (near[:, :, None] + symbols).reshape(B, -1))
        .reshape(B, -1, n_sym))

    best = torch.where(cfo.abs() < CFO_GATE_HZ, refine(cfg, samples, best),
                       best)
    prev = corr.gather(1, torch.clamp(best + (n_sym - 1) * L, 0, n - 1)
                       [:, None])[:, 0]
    return {"found": found, "data_start": (best + n_sym * L)
            .to(torch.int32), "cfo_hz": cfo, "initial_phase_offset": phase,
            "prev_symbol": prev,
            "cfo_ties": torch.where(ties, cfo_near, math.nan),
            "phase_ties": torch.where(ties, phase_near, math.nan)}


def estimates(cfg: DPSKConfig, sym: torch.Tensor):
    """(cfo_hz, initial phase) of the 39 preamble symbols' correlations
    [..., 39]: the CFO from the angle of the chip-signed sum of the
    normalised differentials, the phase from the first 10 of them."""
    tb = tables(cfg, sym.device)
    d = sym[..., 1:] * sym[..., :-1].conj()
    mag = d.abs()
    unit = torch.where(mag > 1e-30, d / torch.clamp(mag, min=1e-30), 0.0)
    per_symbol = TWO_PI * cfg.samples_per_symbol / cfg.sample_rate
    cfo = -torch.angle((tb.signs * unit).sum(-1)) / per_symbol
    phase = _wrap(torch.angle(unit[..., :PHASE_DIFFS])
                  - (cfo * per_symbol)[..., None] - tb.sign_phase).mean(-1)
    return cfo, phase


def demodulate_soft(cfg: DPSKConfig, data: torch.Tensor, prev: torch.Tensor,
                    cfo: torch.Tensor, phase0: torch.Tensor) -> torch.Tensor:
    """demodulateSoft: each symbol against the one before (the first
    against ``prev``), its phase corrected for the CFO and the initial
    phase where either exceeds its gate; confidence min(10 |d|, 5); DQPSK
    LLRs (conf sin p, conf sin 2p), p in [0, 2 pi).  [B, S L] -> [B, 2S]."""
    c = symbol_correlations(cfg, data)
    d = c * torch.cat([prev[:, None], c[:, :-1]], dim=-1).conj()
    p = torch.angle(d)
    gate = (cfo.abs() > CFO_GATE_HZ) | (phase0.abs() > PHASE_GATE)
    per_symbol = TWO_PI * cfg.samples_per_symbol / cfg.sample_rate
    p = torch.where(gate[:, None],
                    _wrap(p - (cfo * per_symbol)[:, None] - phase0[:, None]),
                    p)
    p = torch.where(p < 0, p + TWO_PI, p)
    conf = torch.clamp(10.0 * d.abs(), max=5.0)
    llrs = torch.stack([conf * torch.sin(p), conf * torch.sin(2.0 * p)],
                       dim=-1)
    return llrs.reshape(data.shape[0], -1)


def rx(cfg: DPSKConfig, rate: CodeRate, samples: torch.Tensor):
    """(info [B, k] uint8, ok [B] bool (decoded and found), iters [B]
    int32, the detection, the decoder's input LLRs [B, n])."""
    _float32()
    det = find_preamble(cfg, samples)
    code = ldpc.get_code(rate)
    span = data_symbols(rate, cfg) * cfg.samples_per_symbol
    start = torch.clamp(det["data_start"].to(torch.int64), 0,
                        samples.shape[1] - span)
    idx = start[:, None] + torch.arange(span, device=samples.device)
    data = samples.gather(1, idx)
    llrs = demodulate_soft(cfg, data, det["prev_symbol"], det["cfo_hz"],
                           det["initial_phase_offset"])[:, :code.n] \
        .contiguous()
    total, ok, iters = ldpc.decode(ldpc.Graph(code, samples.device), llrs)
    info = (total[:, :code.k] < 0).to(torch.uint8)
    return info, ok & det["found"], iters, det, llrs

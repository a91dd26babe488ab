"""The OFDM_COX frame of the reference: Schmidl-Cox acquisition and the
pilot-tracking receiver, DQPSK on the default pilot plan, CFO 0.

Frozen copies (commit b6fdfa3) of the port's plain PyTorch path behind
``ofdm/pipeline.tx_cox_frame`` and ``sync/schmidl_cox.decode_cox_batch``
on such a plan, cut to what DQPSK runs:

* TX: the carrier map with every ``pilot_spacing``-th slot a pilot, the
  pilot BPSK of mt19937("PILT") (``ofdm/carriers``), the Schmidl-Cox
  preamble (silence, 4 STS, 2 LTS; ``ofdm/modulator.generate_preamble``),
  the interleaved codeword modulated with the pilots from the preamble's
  mixer offset (``preamble_data_t_offset``);
* detection (``detect_preamble``): the Hilbert FFT, the stride-8 window
  sums by block-stable cumulative sums (``ops/sc_windows.sc_windows_plain``,
  not the card's kernel), the energy gate, the plateau count, the coarse
  CFO and the LTS matched filter;
* ``demodulate_detected``: each frame cut at its detected first LTS, the
  LTS channel estimate and the pilot-tracking scan (``ofdm/demodulator``:
  ``to_baseband_fd``, ``update_channel_estimate``, ``equalize``, the
  DQPSK demap) as the eager loop over the symbols;
* the deinterleave and the plain min-sum decoder of ``ldpc.py``.

Departures from the upstream C++ that the port makes, kept here: the
plateau gate is 0.85, not 0.90 (``PLATEAU_THRESHOLD``), and the carrier
phase correction stays 1 (``update_channel_estimate``); the demodulator
state that decides no output of this path (the SNR estimate, the
adaptive equalizer's weights) is left out.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import ldpc
from .chirp import window_sum
from .config import ModemConfig, Modulation, bits_per_symbol
from .mixer import osc_fixed, osc_int
from .mt19937 import MT19937
from .ofdm import DQPSK_PHASES, demap_dqpsk, find_coprime_step, sync_seq

PILOT_RNG_SEED = 0x50494C54                  # "PILT"
# The port's 0.85, not the upstream 0.90 (demodulator_constants.hpp:51).
PLATEAU_THRESHOLD = 0.85
PLATEAU_SEARCH_WINDOW = 300
MIN_PLATEAU_SAMPLES = 15
SEARCH_STEP = 8
DEFAULT_NOISE_VAR = 0.1
DEFAULT_SNR_LINEAR_FALLBACK = 31.6
SNR_ALPHA = 0.3
FREQ_OFFSET_ALPHA = 0.3
CFO_ACQUISITION_SYMBOLS = 10
MAX_CFO_HZ = 90.0
TIMING_ALPHA = 0.3
PHASE_INTERP_THRESHOLD = 1.5708
MIN_CARRIER_NOISE_VAR = 1e-6
MAX_CARRIER_NOISE_VAR = 100.0


def check(config: ModemConfig, mod: Modulation) -> None:
    """Raise unless (config, mod) is a case this reference computes."""
    if mod != Modulation.DQPSK or not config.use_pilots \
            or config.adaptive_eq_enabled or config.tx_cfo_hz:
        raise ValueError("the Cox reference computes DQPSK on a pilot plan "
                         "without the adaptive equalizer, at TX CFO 0")


# ---------------------------------------------------------------------------
# Tables (numpy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Carriers:
    data_idx: np.ndarray          # [Cd] FFT bins of the data carriers
    pilot_idx: np.ndarray         # [Np] FFT bins of the pilots
    pilot_seq: np.ndarray         # [Np] complex64 BPSK
    data_k: np.ndarray            # [Cd] signed bins
    pilot_k: np.ndarray           # [Np] signed bins


@functools.lru_cache(maxsize=None)
def carriers(config: ModemConfig) -> Carriers:
    """Carriers symmetric around DC, DC skipped, every pilot_spacing-th
    slot a pilot (modulator.cpp:143-181); pilots mt19937("PILT") & 1."""
    neg, pos = config.num_carriers // 2, (config.num_carriers + 1) // 2
    data, pilot = [], []
    count = 0
    for i in range(-neg, pos + 1):
        if i == 0:
            continue
        (pilot if count % config.pilot_spacing == 0 else data).append(
            (i + config.fft_size) % config.fft_size)
        count += 1
    data = np.asarray(data, np.int32)
    pilot = np.asarray(pilot, np.int32)
    raw = MT19937(PILOT_RNG_SEED).raw(len(pilot))
    seq = np.where((raw & 1).astype(bool), 1.0, -1.0).astype(np.complex64)

    def signed(idx):
        k = idx.astype(np.int64).copy()
        k[k > config.fft_size // 2] -= config.fft_size
        return k

    return Carriers(data, pilot, seq, signed(data), signed(pilot))


def lts_freq_domain(config: ModemConfig) -> np.ndarray:
    cm = carriers(config)
    zc = sync_seq(config)
    fd = np.zeros(config.fft_size, np.complex64)
    fd[cm.data_idx] = zc[np.arange(len(cm.data_idx)) % len(zc)]
    fd[cm.pilot_idx] = cm.pilot_seq
    return fd


def sts_freq_domain(config: ModemConfig) -> np.ndarray:
    """The sequence on the even data bins only (two equal halves); its
    index advances on every data carrier (modulator.cpp:298-310)."""
    cm = carriers(config)
    zc = sync_seq(config)
    fd = np.zeros(config.fft_size, np.complex64)
    for j, idx in enumerate(cm.data_idx):
        if idx % 2 == 0:
            fd[idx] = zc[j % len(zc)]
    return fd


@functools.lru_cache(maxsize=None)
def preamble(config: ModemConfig) -> np.ndarray:
    """Silence (N+CP), 4 x STS, 2 x LTS; the STS mixed once at [0, plen)
    and the LTS once at [plen, 2 plen), each buffer repeated."""
    N, cp = config.fft_size, config.cyclic_prefix
    plen = N + cp

    def sym(fd, t0):
        td = np.fft.ifft(fd).astype(np.complex64)
        one = np.concatenate([td[-cp:], td])
        osc = osc_fixed(config.center_freq, config.sample_rate, plen,
                        offset=t0)
        return ((one * osc).real * config.output_scale).astype(np.float32)

    sts = sym(sts_freq_domain(config), 0)
    lts = sym(lts_freq_domain(config), plen)
    return np.concatenate([np.zeros(plen, np.float32)] + [sts] * 4
                          + [lts] * 2)


def data_t_offset(config: ModemConfig) -> int:
    """The mixer's sample index where the data continues the preamble."""
    return 2 * (config.fft_size + config.cyclic_prefix)


def num_data_symbols(config: ModemConfig, mod: Modulation) -> int:
    per_sym = len(carriers(config).data_idx) * bits_per_symbol(mod)
    return -(-ldpc.BLOCK_LENGTH // per_sym)


@functools.lru_cache(maxsize=None)
def interleaver(config: ModemConfig, mod: Modulation):
    """(inv, perm): interleave writes out[perm[i]] = in[i]."""
    total = ldpc.BLOCK_LENGTH
    step = find_coprime_step(len(carriers(config).data_idx)
                             * bits_per_symbol(mod), total)
    i = np.arange(total, dtype=np.int64)
    perm = (i * step) % total
    inv = np.empty(total, dtype=np.int64)
    inv[perm] = i
    return inv, perm


@functools.lru_cache(maxsize=None)
def synthesis(config: ModemConfig, t_offset: int, S: int):
    """(Ar, Ai [S, Cd, L], pilot_wave [S, L]) float32:
    out = sr @ Ar - si @ Ai + pilot_wave."""
    cm = carriers(config)
    N, cp = config.fft_size, config.cyclic_prefix
    L = config.symbol_duration
    n_idx = (np.arange(L) - cp) % N
    live = np.arange(L) < cp + N

    def rows(idx):
        r = np.exp(2j * np.pi * np.outer(np.asarray(idx, np.float64),
                                         n_idx) / N) / N
        return np.where(live[None, :], r, 0.0)

    osc = osc_fixed(config.center_freq, config.sample_rate, S * L,
                    offset=t_offset).reshape(S, L)
    A = rows(cm.data_idx)[None, :, :] * osc[:, None, :] * config.output_scale
    p = (np.asarray(cm.pilot_seq)[:, None] * rows(cm.pilot_idx)).sum(0)
    pilot_wave = (p[None, :] * osc).real.astype(np.float32) \
        * config.output_scale
    return A.real.astype(np.float32), A.imag.astype(np.float32), pilot_wave


@functools.lru_cache(maxsize=None)
def used_bins(config: ModemConfig, L: int):
    """(Wr, Wi) [L, Cd + Np]: DFT rows of the data, then the pilot bins;
    the CP (and the guard) zeroed."""
    cm = carriers(config)
    N, cp = config.fft_size, config.cyclic_prefix
    bins = np.concatenate([cm.data_idx, cm.pilot_idx]).astype(np.float64)
    n_idx = np.arange(L) - cp
    live = (n_idx >= 0) & (n_idx < N)
    W = np.exp(-2j * np.pi * np.outer(n_idx % N, bins) / N)
    W = np.where(live[:, None], W, 0.0)
    return W.real.astype(np.float32), W.imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def interp_arrays(config: ModemConfig):
    """Per data carrier its neighbouring pilot bins and blend factor
    (demodulator.cpp:137-193); a missing neighbour clamps to the other."""
    neg, pos = config.num_carriers // 2, (config.num_carriers + 1) // 2
    slots = []
    count = 0
    for i in range(-neg, pos + 1):
        if i == 0:
            continue
        slots.append(((i + config.fft_size) % config.fft_size,
                      count % config.pilot_spacing == 0))
        count += 1
    bins, lower, upper, alphas, has_l, has_u = [], [], [], [], [], []
    for ci, (b, is_p) in enumerate(slots):
        if is_p:
            continue
        lo = next(((j, slots[j][0]) for j in range(ci - 1, -1, -1)
                   if slots[j][1]), None)
        up = next(((j, slots[j][0]) for j in range(ci + 1, len(slots))
                   if slots[j][1]), None)
        a = 0.5
        if lo and up and up[0] != lo[0]:
            a = (ci - lo[0]) / (up[0] - lo[0])
        bins.append(b)
        lower.append(lo[1] if lo else (up[1] if up else b))
        upper.append(up[1] if up else (lo[1] if lo else b))
        alphas.append(a)
        has_l.append(lo is not None)
        has_u.append(up is not None)
    return (np.asarray(bins, np.int32), np.asarray(lower, np.int32),
            np.asarray(upper, np.int32), np.asarray(alphas, np.float32),
            np.asarray(has_l), np.asarray(has_u))


@functools.lru_cache(maxsize=None)
def lts_template(config: ModemConfig) -> np.ndarray:
    """[CP | LTS] mixed at fc (demodulator.cpp:100-134), complex."""
    td = np.fft.ifft(lts_freq_domain(config)).astype(np.complex64)
    cp = config.cyclic_prefix
    bb = np.concatenate([td[-cp:], td])
    osc = osc_fixed(config.center_freq, config.sample_rate, len(bb))
    return (bb * osc).astype(np.complex64)


def n_fft_of(T: int) -> int:
    return 1 << (T - 1).bit_length()


def search_grid_size(config: ModemConfig, T: int) -> int:
    N, cp, st = config.fft_size, config.cyclic_prefix, SEARCH_STEP
    n_off = T - N - cp + 1
    return min(-(-n_off // st), T // st - 2 * (N // 2 // st) + 1 - cp // st)


# ---------------------------------------------------------------------------
# The demodulator's state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class State:
    """The tracked state that decides the LLRs, [B] unless noted."""
    cfo: torch.Tensor               # freq_offset_hz
    cfo_filtered: torch.Tensor
    phase: torch.Tensor             # the CFO correction's phase
    ce: torch.Tensor                # [B, N] channel estimate
    prev_eq: torch.Tensor           # [B, Cd] the previous equalized symbol
    ppc: torch.Tensor               # pilot phase correction
    prev_pilots: torch.Tensor       # [B, Np]
    have_prev: torch.Tensor
    nv: torch.Tensor                # noise variance
    count: torch.Tensor             # symbols seen (snr_symbol_count)
    since_sync: torch.Tensor
    tos: torch.Tensor               # timing offset, samples


class Cox:
    """The reference's Cox TX and receiver for one (config, mod, rate) on
    one device; every table built here from the configuration."""

    def __init__(self, config: ModemConfig, mod: Modulation, rate,
                 lead: int, tail: int, device: torch.device):
        check(config, mod)
        self.config, self.mod, self.device = config, mod, device
        self.lead, self.tail = lead, tail
        self.graph = ldpc.Graph(ldpc.get_code(rate), device)
        self.S = num_data_symbols(config, mod)
        cm = carriers(config)

        def on(x, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                   device=device)

        inv, perm = interleaver(config, mod)
        self.inv, self.perm = on(inv), on(perm)
        Ar, Ai, pw = synthesis(config, data_t_offset(config), self.S)
        self.synth_r, self.synth_i, self.pilot_wave = on(Ar), on(Ai), on(pw)
        self.points = on(DQPSK_PHASES)
        Cd = len(cm.data_idx)
        bc = bits_per_symbol(mod)
        first_bit = np.arange(self.S * Cd).reshape(self.S, Cd) * bc
        self.filled = on(first_bit < ldpc.BLOCK_LENGTH)[None]
        self.preamble = on(preamble(config))
        self.data_idx = on(cm.data_idx, torch.long)
        self.pilot_idx = on(cm.pilot_idx, torch.long)
        zc = sync_seq(config)
        self.lts_data = on(zc[np.arange(Cd) % len(zc)])
        self.pilot_seq = on(cm.pilot_seq)
        two_pi = np.float32(2.0 * np.pi)
        self.pilot_k = on(np.asarray(cm.pilot_k, np.float32))
        self.two_pi_pilot_k = on(two_pi * np.asarray(cm.pilot_k, np.float32))
        self.two_pi_data_k = on(two_pi * np.asarray(cm.data_k, np.float32))
        bins, lo, up, a, has_l, has_u = interp_arrays(config)
        self.interp_bins = on(bins, torch.long)
        self.interp_lo, self.interp_up = on(lo, torch.long), on(up, torch.long)
        self.interp_a = on(a[None])
        self.interp_both = on((has_l & has_u)[None])
        self.interp_only_l = on((has_l & ~has_u)[None])
        plen = config.fft_size + config.cyclic_prefix
        self.bins = {L: tuple(map(on, used_bins(config, L)))
                     for L in (plen, config.symbol_duration)}
        tmpl = lts_template(config)
        self.tmpl_len = len(tmpl)
        self.e_ref = float((np.abs(tmpl) ** 2).sum()) * 0.5
        self.tmpl_conj = on(np.conj(tmpl))

    # -- TX ---------------------------------------------------------------

    def tx(self, info: torch.Tensor) -> torch.Tensor:
        """[B, k] info bits -> [B, lead + preamble + S symbols + tail]."""
        B = info.shape[0]
        Cd = self.data_idx.shape[0]
        bc = bits_per_symbol(self.mod)
        cw = ldpc.encode(self.graph, info)[:, self.inv]
        pad = self.S * Cd * bc - cw.shape[1]
        words = torch.nn.functional.pad(cw.to(torch.int32), (0, pad))
        words = words.reshape(B, self.S, Cd, bc)
        weights = 1 << torch.arange(bc - 1, -1, -1, dtype=torch.int32,
                                    device=self.device)
        words = (words * weights).sum(-1)
        syms = self.points[torch.cumsum(words, dim=1) % 4]
        syms = torch.where(self.filled, syms,
                           torch.zeros((), dtype=torch.complex64,
                                       device=self.device))
        data = torch.einsum("bsc,scl->bsl", syms.real, self.synth_r) \
            - torch.einsum("bsc,scl->bsl", syms.imag, self.synth_i)
        data = (data + self.pilot_wave[None]).reshape(B, -1)
        return torch.cat([torch.zeros((B, self.lead), device=self.device),
                          self.preamble.expand(B, -1), data,
                          torch.zeros((B, self.tail), device=self.device)],
                         dim=-1)

    # -- detection --------------------------------------------------------

    def detect(self, samples: torch.Tensor) -> dict:
        """Schmidl-Cox plateau, coarse CFO and LTS fine timing of [B, T]
        buffers (demodulator.cpp:474-599): found, lts_start, sync_off,
        cfo_hz, peak_corr, lts_corr."""
        cfg, dev = self.config, self.device
        B, T = samples.shape
        N, cp = cfg.fft_size, cfg.cyclic_prefix
        plen = N + cp
        n_fft = n_fft_of(T)
        X = torch.fft.fft(samples.to(torch.complex64), n=n_fft, dim=-1)
        n_off = T - N - cp + 1
        st, half = SEARCH_STEP, N // 2
        mult = np.ones(n_fft, np.float32)
        mult[0] = 0.0
        mult[1:n_fft // 2] = 2.0
        mult[n_fft // 2 + 1:] = 0.0
        a = torch.fft.ifft(X * torch.from_numpy(mult).to(dev),
                           dim=-1)[..., :T]
        nb, cpb = T // st, cp // st
        G = search_grid_size(cfg, T)

        # Window sums on the stride-8 grid from 8-sample blocks.
        hb = half // st
        ab = a[:, :nb * st].reshape(B, nb, st)
        eb = (ab.real * ab.real + ab.imag * ab.imag).sum(-1)
        ub = (ab[:, :nb - hb, :].conj() * ab[:, hb:, :]).sum(-1)
        Pb, Eb = window_sum(ub, hb), window_sum(eb, hb)
        gP, gR1, gR2 = Pb[:, cpb:cpb + G], Eb[:, cpb:cpb + G], \
            Eb[:, cpb + hb:cpb + hb + G]
        denom = torch.sqrt(torch.clamp(gR1 * gR2, min=0.0))
        gcorr = torch.where(denom > 1e-10,
                            gP.abs() / torch.clamp(denom, min=1e-30), 0.0)

        # Energy gate over the FFT window [d+cp, d+cp+N).
        sb = (samples * samples)[:, :nb * st].reshape(B, nb, st).sum(-1)
        Ew = window_sum(sb, N // st)
        e_all = Ew[:, cpb:cpb + G] / N
        floor = torch.clamp(torch.minimum(0.1 * e_all[:, :1],
                                          e_all.amin(-1, keepdim=True)),
                            min=1e-10)
        energy_ok = (e_all >= 4.0 * floor) \
            & (e_all >= 1e-4 * e_all.amax(-1, keepdim=True))
        gcorr = torch.where(energy_ok, gcorr, 0.0)

        grid = torch.arange(G, device=dev) * st
        win_pts = PLATEAU_SEARCH_WINDOW // SEARCH_STEP + 1
        max_start = n_off - 6 * plen - 2 * plen
        rel = torch.arange(win_pts, device=dev)

        L = self.tmpl_len
        flt = torch.fft.fft(self.tmpl_conj, n=n_fft).conj()
        mf = torch.fft.ifft(X * flt, dim=-1)[:, :T - L + 1].abs()
        energy = window_sum(samples * samples, L)
        nmf = torch.where(energy * self.e_ref > 1e-12,
                          mf / torch.sqrt(torch.clamp(energy * self.e_ref,
                                                      min=1e-30)), 0.0)
        n_mf = nmf.shape[-1]
        pos = torch.arange(n_mf, device=dev)[None, :]

        def pick(x, idx):
            return x.gather(1, idx[:, None])[:, 0]

        above = (gcorr >= PLATEAU_THRESHOLD).to(torch.float32)
        counts = window_sum(above, win_pts)
        Gc = counts.shape[-1]
        cand = (gcorr[:, :Gc] > cfg.sync_threshold) \
            & (counts >= MIN_PLATEAU_SAMPLES) \
            & (grid[None, :Gc] < max(max_start, 1))
        found_sc = cand.any(-1)
        first = torch.argmax(cand.to(torch.int32), dim=-1)
        win_idx = torch.clamp(first[:, None] + rel[None, :], 0, G - 1)
        wcorr = gcorr.gather(1, win_idx)
        peak_rel = torch.argmax(wcorr, dim=-1)
        gidx = torch.clamp(first + peak_rel, 0, G - 1)
        sync_off = grid[gidx]
        peak_corr = pick(wcorr, peak_rel)

        phase = torch.angle(pick(gP, gidx))
        cfo = phase * cfg.sample_rate / (math.pi * N)
        max_cfo = cfg.sample_rate / N
        cfo = torch.clamp(cfo, -max_cfo, max_cfo)

        coarse = sync_off + 4 * plen
        win = (pos >= (coarse - 3 * plen)[:, None]) \
            & (pos <= (coarse + plen // 2)[:, None])
        lts_start = torch.argmax(torch.where(win, nmf, -1.0), dim=-1)
        lts_corr = pick(nmf, lts_start)
        # The two LTS are equal: a comparable peak one symbol earlier
        # (still in the window) is the first.
        prev_pos = torch.clamp(lts_start - plen, 0, n_mf - 1)
        prev_corr = pick(nmf, prev_pos)
        take_prev = ((lts_start - plen) >= (coarse - 3 * plen)) \
            & (prev_corr >= 0.85 * lts_corr)
        lts_start = torch.where(take_prev, prev_pos, lts_start)
        lts_corr = torch.where(take_prev, prev_corr, lts_corr)
        lts_t = 0.05 if N >= 1024 else 0.35
        i32 = torch.int32
        return {"found": found_sc & (lts_corr >= lts_t), "cfo_hz": cfo,
                "peak_corr": peak_corr, "lts_corr": lts_corr,
                "lts_start": lts_start.to(i32), "sync_off": sync_off.to(i32)}

    # -- demodulation -----------------------------------------------------

    def _to_fd(self, st: State, sym: torch.Tensor, t0: int, osc=None):
        """One symbol's used bins [B, Cd + Np], data then pilots, and the
        CFO correction's phase advanced by L (where |cfo| > 0.01)."""
        cfg, dev = self.config, self.device
        L = sym.shape[-1]
        if osc is None:
            t = t0 + torch.arange(L, dtype=torch.int32, device=dev)
            osc = osc_int(cfg.center_freq, cfg.sample_rate, t)
        phase_inc = float(np.float32(-2.0 * np.pi / cfg.sample_rate)) \
            * st.cfo
        i = torch.arange(L, dtype=torch.float32, device=dev)
        corr_phase = st.phase[:, None] + phase_inc[:, None] * i
        corr = torch.polar(torch.ones_like(corr_phase), corr_phase)
        active = (st.cfo.abs() > 0.01)[:, None]
        corr = torch.where(active, corr, torch.ones((), dtype=torch.complex64,
                                                    device=dev))
        z = sym.to(torch.complex64) * osc.conj()[None, :] * corr
        Wr, Wi = self.bins[L]
        fd = torch.complex(z.real @ Wr - z.imag @ Wi,
                           z.real @ Wi + z.imag @ Wr)
        st.phase = torch.where(
            active[:, 0],
            torch.remainder(st.phase + phase_inc * L + math.pi, 2 * math.pi)
            - math.pi, st.phase)
        return fd

    def _init(self, B: int, cfo: torch.Tensor) -> State:
        dev = self.device
        f32, c64 = torch.float32, torch.complex64
        Cd, Np = self.data_idx.shape[0], self.pilot_idx.shape[0]
        cfo = torch.as_tensor(cfo, device=dev).to(f32).expand(B).clone()
        return State(
            cfo=cfo, cfo_filtered=cfo.clone(),
            phase=torch.full((B,), 0.0, dtype=f32, device=dev),
            ce=torch.ones((B, self.config.fft_size), dtype=c64, device=dev),
            prev_eq=torch.ones((B, Cd), dtype=c64, device=dev),
            ppc=torch.ones((B,), dtype=c64, device=dev),
            prev_pilots=torch.zeros((B, Np), dtype=c64, device=dev),
            have_prev=torch.zeros((B,), dtype=torch.bool, device=dev),
            nv=torch.full((B,), DEFAULT_NOISE_VAR, dtype=f32, device=dev),
            count=torch.zeros((B,), dtype=torch.int32, device=dev),
            since_sync=torch.zeros((B,), dtype=torch.int32, device=dev),
            tos=torch.zeros((B,), dtype=f32, device=dev))

    def _lts_estimate(self, st: State, lts: torch.Tensor) -> None:
        """LS estimate of both LTS (channel_equalizer.cpp:77-328), each
        demixed at t0 = plen: data carriers take the last, pilots the
        mean."""
        B, n_sym, L = lts.shape
        Cd = self.data_idx.shape[0]
        h_data = None
        h_pilot = torch.zeros((B, self.pilot_idx.shape[0]),
                              dtype=torch.complex64, device=self.device)
        plen = self.config.fft_size + self.config.cyclic_prefix
        for s in range(n_sym):
            fd = self._to_fd(st, lts[:, s], plen)
            h_data = fd[:, :Cd] / self.lts_data[None, :]
            h_pilot = h_pilot + fd[:, Cd:] / self.pilot_seq[None, :]
        ce = st.ce.clone()
        ce[:, self.data_idx] = h_data
        ce[:, self.pilot_idx] = h_pilot / n_sym
        st.ce = ce
        st.count = torch.full_like(st.count, n_sym)

    def _interpolate(self, ce: torch.Tensor) -> torch.Tensor:
        H1, H2 = ce[:, self.interp_lo], ce[:, self.interp_up]
        pd = H2 * H1.conj()
        phase_diff = torch.atan2(pd.imag, pd.real).abs()
        a = self.interp_a
        lin = (1.0 - a) * H1 + a * H2
        nearest = torch.where(a < 0.5, H1, H2)
        interp = torch.where(phase_diff > PHASE_INTERP_THRESHOLD, nearest,
                             lin)
        val = torch.where(self.interp_both, interp,
                          torch.where(self.interp_only_l, H1, H2))
        out = ce.clone()
        out[:, self.interp_bins] = val
        return out

    def _track(self, st: State, fd: torch.Tensor) -> None:
        """Pilot tracking of one symbol (channel_equalizer.cpp:330-595):
        LS pilots, EMA smoothing, temporal noise, residual CFO, timing
        slope with the coherent timing fix (the plan's modulation is
        coherent), interpolation.  The carrier phase correction stays 1."""
        cfg, dev = self.config, self.device
        B = fd.shape[0]
        N = cfg.fft_size
        Cd = self.data_idx.shape[0]
        unit1 = torch.ones((B, 1), dtype=torch.complex64, device=dev)
        alpha = torch.where(st.count == 0, 1.0, 0.9)[:, None]
        h_ls = fd[:, Cd:] / self.pilot_seq[None, :]
        hl2 = h_ls.abs() ** 2
        signal_power = hl2.mean(-1)

        prev = st.prev_pilots
        pv2 = prev.abs() ** 2
        have_prev = st.have_prev[:, None]
        valid = (pv2 > 1e-6) & (hl2 > 1e-6) & have_prev
        diff2 = torch.where(valid, (h_ls - prev).abs() ** 2, 0.0)
        noise_sum = diff2.sum(-1)
        noise_count = valid.sum(-1)
        noise_sum = torch.where(noise_count == 0,
                                signal_power / DEFAULT_SNR_LINEAR_FALLBACK,
                                noise_sum)
        noise_count = torch.clamp(noise_count, min=1)

        ce = st.ce.clone()
        pidx, didx = self.pilot_idx, self.data_idx
        ce[:, pidx] = alpha * h_ls + (1.0 - alpha) * ce[:, pidx]

        d = h_ls * prev.conj()
        dmag = d.abs()
        unit_ok = (pv2 > 1e-6) & (hl2 > 1e-6) & (dmag > 1e-6) & have_prev
        unit = torch.where(unit_ok, d / torch.clamp(dmag, min=1e-30), 0.0)
        vcount = unit_ok.sum(-1)
        have_cfo = vcount > 0
        avg_diff = unit.sum(-1) / torch.clamp(vcount, min=1)
        avg_phase = torch.atan2(avg_diff.imag, avg_diff.real)
        ppc = torch.where(have_cfo,
                          torch.polar(torch.ones_like(avg_phase), -avg_phase),
                          unit1[:, 0])

        sym_dur = cfg.symbol_duration / cfg.sample_rate
        residual = avg_phase / (2 * np.pi * sym_dur)
        total_cfo = st.cfo + residual
        progress = torch.clamp(st.since_sync / CFO_ACQUISITION_SYMBOLS, 0, 1)
        ad_alpha = 0.9 * (1 - progress) + FREQ_OFFSET_ALPHA * progress
        ad_alpha = torch.where(residual.abs() > 10.0,
                               torch.clamp(ad_alpha, min=0.9), ad_alpha)
        fof = torch.where(have_cfo,
                          ad_alpha * total_cfo
                          + (1 - ad_alpha) * st.cfo_filtered,
                          st.cfo_filtered)
        foh = torch.where(have_cfo, torch.clamp(fof, -MAX_CFO_HZ, MAX_CFO_HZ),
                          st.cfo)
        ssc = st.since_sync + have_cfo.to(torch.int32)

        tmask = hl2 >= 1e-6
        k = self.pilot_k[None, :]
        ph = torch.angle(h_ls)
        nvalid = tmask.sum(-1)
        sum_k = (k * tmask).sum(-1)
        sum_k2 = (k * k * tmask).sum(-1)
        sum_p = (ph * tmask).sum(-1)
        sum_kp = (k * ph * tmask).sum(-1)
        denom = nvalid * sum_k2 - sum_k * sum_k
        can_fit = (st.count >= 3) & (nvalid >= 3) & (denom.abs() > 1e-6)
        slope = (nvalid * sum_kp - sum_k * sum_p) \
            / torch.where(can_fit, denom, 1.0)
        inst = slope * N / (2 * np.pi)
        tos = TIMING_ALPHA * inst + (1 - TIMING_ALPHA) * st.tos
        max_t = 50.0 * (N / 512.0)
        tos = torch.clamp(tos, -max_t, max_t)
        tos = torch.where(can_fit, tos, st.tos)

        tfix = (tos.abs() > 0.1)[:, None]

        def rot(two_pi_k, sign):
            kph = two_pi_k[None, :] * tos[:, None] / N
            return torch.where(tfix, torch.polar(torch.ones_like(kph),
                                                 sign * kph), unit1)

        ce[:, pidx] = ce[:, pidx] * rot(self.two_pi_pilot_k, -1.0)
        ce = self._interpolate(ce)
        ce[:, pidx] = ce[:, pidx] * rot(self.two_pi_pilot_k, 1.0)
        ce[:, didx] = ce[:, didx] * rot(self.two_pi_data_k, 1.0)

        upd = (noise_count > 1) & (noise_sum > 0)
        nv = torch.where(upd, torch.clamp(
            noise_sum / torch.clamp(noise_count - 1, min=1), min=1e-6), st.nv)

        st.ce, st.ppc, st.prev_pilots = ce, ppc, h_ls
        st.have_prev = torch.ones_like(st.have_prev)
        st.nv, st.count, st.since_sync = nv, st.count + 1, ssc
        st.cfo, st.cfo_filtered, st.tos = foh, fof, tos

    def _symbol_llrs(self, st: State, fd: torch.Tensor) -> torch.Tensor:
        """Equalize (channel_equalizer.cpp:728-855, the differential
        branch) and demap one symbol against the previous one."""
        Cd = self.data_idx.shape[0]
        rx = fd[:, :Cd]
        h = st.ce[:, self.data_idx]
        hp = h.abs() ** 2
        nv = st.nv[:, None]
        kph = self.two_pi_data_k[None, :] * st.tos[:, None] \
            / self.config.fft_size
        tc = torch.polar(torch.ones_like(kph), kph)
        good = hp > 1e-6
        eq = torch.where(good, rx * h.conj() / torch.clamp(hp, min=1e-30),
                         rx) * st.ppc[:, None] * tc
        cnv = torch.where(good, nv / torch.clamp(hp, min=1e-30),
                          MAX_CARRIER_NOISE_VAR)
        cnv = torch.clamp(cnv, MIN_CARRIER_NOISE_VAR, MAX_CARRIER_NOISE_VAR)
        llrs = demap_dqpsk(eq, st.prev_eq, cnv * 1.0)
        st.prev_eq = eq
        return llrs.reshape(eq.shape[0], -1)

    def llrs(self, samples: torch.Tensor, det: dict) -> torch.Tensor:
        """Each frame cut at its detected first LTS, the LTS estimate, then
        the pilot-tracking loop over the data symbols -> [B, S*Cd*2]."""
        cfg = self.config
        B, T = samples.shape
        plen = cfg.fft_size + cfg.cyclic_prefix
        L, S = cfg.symbol_duration, self.S
        span_len = 2 * plen + S * L
        starts = torch.clamp(det["lts_start"].to(torch.int64), 0,
                             T - span_len)
        idx = starts[:, None] + torch.arange(span_len, device=self.device)
        span = samples.gather(1, idx)
        lts = span[:, :2 * plen].reshape(B, 2, plen)
        data = span[:, 2 * plen:2 * plen + S * L].reshape(B, S, L)
        st = self._init(B, det["cfo_hz"])
        self._lts_estimate(st, lts)
        t0 = 2 * plen
        t = t0 + torch.arange(S * L, dtype=torch.int32, device=self.device)
        osc = osc_int(cfg.center_freq, cfg.sample_rate, t).reshape(S, L)
        out = []
        for s in range(S):
            fd = self._to_fd(st, data[:, s], t0 + s * L, osc=osc[s])
            self._track(st, fd)
            out.append(self._symbol_llrs(st, fd))
        return torch.stack(out, dim=1).reshape(B, -1)

    def rx(self, samples: torch.Tensor):
        """[B, T] buffers -> (info [B, k] uint8, ok [B] (decoded and
        found), iters [B], detection, the demodulated LLRs
        [B, S*Cd*2])."""
        det = self.detect(samples)
        n = ldpc.BLOCK_LENGTH
        demod = self.llrs(samples, det)
        total, ok, iters = ldpc.decode(
            self.graph, demod[:, :n][:, self.perm].contiguous())
        info = (total[:, :self.graph.k] < 0).to(torch.uint8)
        return info, ok & det["found"], iters, det, demod

"""The NVIS frame of the reference: OFDM_COX on the no-pilot 1,024-FFT plan
(``nvis_mode``: 59 carriers, CP 96, no guard), QAM32, several interleaved
codewords a frame, Schmidl-Cox acquisition at a carrier offset, and the
coherent refined receiver.

Copies of the port's plain PyTorch path behind ``ofdm/pipeline.tx_cox_frame``,
``sim/watterson.apply_cfo_hilbert`` and ``sync/schmidl_cox.decode_cox_batch``
on such a plan, cut to what QAM32 runs:

* TX: the carrier map of a plan without pilots (every slot a data
  carrier, DC skipped), the Schmidl-Cox preamble (silence, 4 STS, 2 LTS;
  ``ofdm/modulator.generate_preamble``), each codeword encoded and
  interleaved, the frame's bits mapped to QAM32 (``constellations.table``,
  the carriers past the last bit left empty) and modulated from the
  preamble's mixer offset;
* the harness CFO (``apply_cfo_hilbert``): the analytic signal by an FFT
  at the next power of two, rotated by exp(j 2 pi f t / fs), its real part;
* detection: the Schmidl-Cox plateau on the stride-8 grid by block-stable
  cumulative sums (not the card's window kernel), the energy gate, the
  coarse CFO, the LTS matched filter by FFT (not the card's timing kernel),
  as ``reference/ofdm_cox.Cox.detect`` computes them from this plan's
  templates;
* each frame cut at its detected first LTS, the span's analytic half
  (``analytic_half``, no margin taper), the LTS estimate at the detected
  CFO (both LTS demixed at t0 = plen, data carriers from the last);
* the refined path as its eager loops (``_demod_coherent_refined``): each
  symbol's bins through the rectangular window, the dual decision-directed
  PLL (common phase and timing slope), three alternating rank-1 LS refits
  of gain and channel against hard decisions, per-carrier residual noise,
  the MMSE equalizer and the QAM32 max-log demap;
* the deinterleave over the frame's codewords and the plain min-sum
  decoder of ``ldpc.py``.

Departures from the upstream C++ that the port makes, kept here: the
plateau gate is 0.85, not 0.90 (``PLATEAU_THRESHOLD``); the LTS gate is
0.05 at N >= 1,024 (the port's, 0.35 below); coherent data are
demodulated from the analytic signal of the cut span, not the real
passband; the upstream equalizes a no-pilot frame with the LTS estimate
alone, where the refined path tracks phase and timing slope over the data
symbols and refits the channel from them; the CFO correction's phase runs
on through the two LTS into the data.  Demodulator state that decides no
output of this path (the SNR estimate, the adaptive equalizer) is left
out.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import ldpc
from .channel import analytic_mult
from .chirp import window_sum
from .config import ModemConfig, Modulation, bits_per_symbol
from .mixer import osc_fixed, osc_int, osc_traced
from .ofdm import clip_llr, data_idx, find_coprime_step, sync_seq
from .ofdm_cox import (MIN_PLATEAU_SAMPLES, PLATEAU_SEARCH_WINDOW,
                       PLATEAU_THRESHOLD, SEARCH_STEP, n_fft_of,
                       search_grid_size)

DEFAULT_NOISE_VAR = 0.1
MIN_CARRIER_NOISE_VAR = 1e-6
MAX_CARRIER_NOISE_VAR = 100.0
#: The QAM32 demapper's channel-estimation margin
#: (demodulator_constants.hpp:102-107).
QAM32_CE_MARGIN = 1.5
QAM32_SCALE = 0.1961161351381840            # 1/sqrt(26)
# Gray decode tables of 32-QAM (modulator.cpp:53-72).
I_LEVELS = np.array([-3, -1, 1, 3], np.float32)
I_GRAY = [0, 1, 3, 2]
Q_LEVELS = np.array([-7, -5, -3, -1, 1, 3, 5, 7], np.float32)
Q_GRAY = [0, 1, 3, 2, 6, 7, 5, 4]


def check(config: ModemConfig, mod: Modulation) -> None:
    """Raise unless (config, mod) is a case this reference computes."""
    if mod != Modulation.QAM32 or config.use_pilots \
            or config.adaptive_eq_enabled or config.tx_cfo_hz \
            or config.symbol_guard:
        raise ValueError("the NVIS reference computes QAM32 on a plan "
                         "without pilots, guard or adaptive equalizer, at "
                         "TX CFO 0")


# ---------------------------------------------------------------------------
# Tables (numpy)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def qam32_table() -> np.ndarray:
    """[32] complex64 points indexed by the bit word."""
    out = np.empty(32, np.complex64)
    for b in range(32):
        qb, ib = (b >> 2) & 7, b & 3
        out[b] = complex(I_LEVELS[I_GRAY.index(ib)] * QAM32_SCALE,
                         Q_LEVELS[Q_GRAY.index(qb)] * QAM32_SCALE)
    return out


@functools.lru_cache(maxsize=None)
def qam32_masks() -> tuple[np.ndarray, np.ndarray]:
    """(points [32], masks [5, 32]): each point and whether bit b (MSB
    first) of its word is 1 (soft_demap.hpp:77-95)."""
    pts = np.empty(32, np.complex64)
    words = np.empty(32, np.int64)
    for qi in range(8):
        for ii in range(4):
            pts[qi * 4 + ii] = complex(I_LEVELS[ii] * QAM32_SCALE,
                                       Q_LEVELS[qi] * QAM32_SCALE)
            words[qi * 4 + ii] = (Q_GRAY[qi] << 2) | I_GRAY[ii]
    return pts, np.stack([(words & (1 << (4 - b))) != 0 for b in range(5)])


def signed_bins(config: ModemConfig) -> np.ndarray:
    k = data_idx(config).astype(np.int64)
    k[k > config.fft_size // 2] -= config.fft_size
    return k.astype(np.float32)


def lts_freq_domain(config: ModemConfig) -> np.ndarray:
    idx = data_idx(config)
    zc = sync_seq(config)
    fd = np.zeros(config.fft_size, np.complex64)
    fd[idx] = zc[np.arange(len(idx)) % len(zc)]
    return fd


def sts_freq_domain(config: ModemConfig) -> np.ndarray:
    """The sequence on the even data bins only; its index advances on
    every data carrier (modulator.cpp:298-310)."""
    zc = sync_seq(config)
    fd = np.zeros(config.fft_size, np.complex64)
    for j, idx in enumerate(data_idx(config)):
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


def num_data_symbols(config: ModemConfig, mod: Modulation,
                     n_codewords: int) -> int:
    per_sym = len(data_idx(config)) * bits_per_symbol(mod)
    return -(-(ldpc.BLOCK_LENGTH * n_codewords) // per_sym)


@functools.lru_cache(maxsize=None)
def interleaver(config: ModemConfig, mod: Modulation):
    """(inv, perm) of one codeword: interleave writes out[perm[i]] = in[i]."""
    total = ldpc.BLOCK_LENGTH
    step = find_coprime_step(len(data_idx(config)) * bits_per_symbol(mod),
                             total)
    i = np.arange(total, dtype=np.int64)
    perm = (i * step) % total
    inv = np.empty(total, dtype=np.int64)
    inv[perm] = i
    return inv, perm


@functools.lru_cache(maxsize=None)
def synthesis(config: ModemConfig, t_offset: int, S: int):
    """(Ar, Ai) [S, Cd, L] float32: out = sr @ Ar - si @ Ai."""
    idx = data_idx(config)
    N, cp = config.fft_size, config.cyclic_prefix
    L = config.symbol_duration
    n_idx = (np.arange(L) - cp) % N
    live = np.arange(L) < cp + N
    rows = np.exp(2j * np.pi * np.outer(np.asarray(idx, np.float64),
                                        n_idx) / N) / N
    rows = np.where(live[None, :], rows, 0.0)
    osc = osc_fixed(config.center_freq, config.sample_rate, S * L,
                    offset=t_offset).reshape(S, L)
    A = rows[None, :, :] * osc[:, None, :] * config.output_scale
    return A.real.astype(np.float32), A.imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def used_bins(config: ModemConfig, L: int):
    """(Wr, Wi) [L, Cd]: DFT rows of the data bins, the CP zeroed."""
    N, cp = config.fft_size, config.cyclic_prefix
    bins = data_idx(config).astype(np.float64)
    n_idx = np.arange(L) - cp
    live = (n_idx >= 0) & (n_idx < N)
    W = np.exp(-2j * np.pi * np.outer(n_idx % N, bins) / N)
    W = np.where(live[:, None], W, 0.0)
    return W.real.astype(np.float32), W.imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def lts_template(config: ModemConfig) -> np.ndarray:
    """[CP | LTS] mixed at fc (demodulator.cpp:100-134), complex."""
    td = np.fft.ifft(lts_freq_domain(config)).astype(np.complex64)
    cp = config.cyclic_prefix
    bb = np.concatenate([td[-cp:], td])
    osc = osc_fixed(config.center_freq, config.sample_rate, len(bb))
    return (bb * osc).astype(np.complex64)


def apply_cfo(samples: torch.Tensor, cfo_hz: float,
              sample_rate: int = 48000) -> torch.Tensor:
    """The harness CFO: the analytic signal by an FFT at the next power of
    two, rotated by exp(j 2 pi cfo t / fs), its real part; a frame is left
    as it was where |cfo| <= 0.001 Hz."""
    T = samples.shape[-1]
    n_fft = n_fft_of(T)
    dev = samples.device
    cfo = torch.full((), float(np.float32(cfo_hz)), device=dev)
    x = torch.fft.fft(samples.to(torch.complex64), n=n_fft, dim=-1)
    a = torch.fft.ifft(x * analytic_mult(n_fft, dev), dim=-1)[..., :T]
    rot = osc_traced(cfo[..., None], sample_rate,
                     torch.arange(T, dtype=torch.int32, device=dev))
    return torch.where(cfo.abs()[..., None] > 0.001, (a * rot).real,
                       samples)


class Nvis:
    """The reference's NVIS TX and receiver for one (config, mod, rate,
    codewords a frame) on one device; every table built here from the
    configuration."""

    def __init__(self, config: ModemConfig, mod: Modulation, rate,
                 n_codewords: int, lead: int, tail: int,
                 device: torch.device):
        check(config, mod)
        self.config, self.mod, self.device = config, mod, device
        self.ncw, self.lead, self.tail = n_codewords, lead, tail
        self.graph = ldpc.Graph(ldpc.get_code(rate), device)
        self.S = num_data_symbols(config, mod, n_codewords)

        def on(x, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                   device=device)

        inv, perm = interleaver(config, mod)
        self.inv, self.perm = on(inv), on(perm)
        plen = config.fft_size + config.cyclic_prefix
        self.synth_r, self.synth_i = map(on, synthesis(config, 2 * plen,
                                                       self.S))
        self.points = on(qam32_table())
        pts, masks = qam32_masks()
        self.demap_points, self.demap_masks = on(pts), on(masks)
        Cd = len(data_idx(config))
        first_bit = np.arange(self.S * Cd).reshape(self.S, Cd) \
            * bits_per_symbol(mod)
        self.n_bits = ldpc.BLOCK_LENGTH * n_codewords
        self.filled = on(first_bit < self.n_bits)[None]
        self.live = on((first_bit < self.n_bits).astype(np.float32))[None]
        self.preamble = on(preamble(config))
        zc = sync_seq(config)
        self.lts_data = on(zc[np.arange(Cd) % len(zc)])
        self.kbin = on(signed_bins(config))
        self.Wr, self.Wi = map(on, used_bins(config, config.symbol_duration))
        tmpl = lts_template(config)
        self.tmpl_len = len(tmpl)
        self.e_ref = float((np.abs(tmpl) ** 2).sum()) * 0.5
        self.tmpl_conj = on(np.conj(tmpl))

    # -- TX ---------------------------------------------------------------

    def tx(self, info: torch.Tensor) -> torch.Tensor:
        """[B, ncw*k] info bits -> [B, lead + preamble + S symbols + tail]."""
        B = info.shape[0]
        Cd = self.kbin.shape[0]
        bc = bits_per_symbol(self.mod)
        cw = ldpc.encode(self.graph, info.reshape(B * self.ncw, -1))
        bits = cw[:, self.inv].reshape(B, -1)
        pad = self.S * Cd * bc - bits.shape[1]
        words = torch.nn.functional.pad(bits.to(torch.int32), (0, pad))
        words = words.reshape(B, self.S, Cd, bc)
        weights = 1 << torch.arange(bc - 1, -1, -1, dtype=torch.int32,
                                    device=self.device)
        syms = self.points[(words * weights).sum(-1)]
        syms = torch.where(self.filled, syms,
                           torch.zeros((), dtype=torch.complex64,
                                       device=self.device))
        data = torch.einsum("bsc,scl->bsl", syms.real, self.synth_r) \
            - torch.einsum("bsc,scl->bsl", syms.imag, self.synth_i)
        return torch.cat([torch.zeros((B, self.lead), device=self.device),
                          self.preamble.expand(B, -1), data.reshape(B, -1),
                          torch.zeros((B, self.tail), device=self.device)],
                         dim=-1)

    # -- detection --------------------------------------------------------

    def detect(self, samples: torch.Tensor, prefer=None,
               tie: float = 0.0) -> dict:
        """Schmidl-Cox plateau, coarse CFO and LTS fine timing of [B, T]
        buffers (demodulator.cpp:474-599): found, lts_start, sync_off,
        cfo_hz, peak_corr, lts_corr.

        ``prefer`` [B] (sync offsets found by another receiver) resolves
        the plateau's near-ties: where a lane's preferred grid point lies
        in its plateau window and its metric is within ``tie`` of the
        window's peak, that point is the peak (and the CFO is read
        there)."""
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
        if prefer is not None:
            want = torch.as_tensor(prefer, device=dev).to(torch.int64)
            rel_want = want // st - first
            usable = (want % st == 0) & (rel_want >= 0) \
                & (rel_want < win_pts)
            rel_want = torch.clamp(rel_want, 0, win_pts - 1)
            near = pick(wcorr, rel_want) >= pick(wcorr, peak_rel) - tie
            peak_rel = torch.where(usable & near, rel_want, peak_rel)
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

    def _to_fd(self, cfo: torch.Tensor, phase: torch.Tensor,
               sym: torch.Tensor, osc: torch.Tensor):
        """One symbol's data bins [B, Cd] and the CFO correction's phase
        advanced by L (where |cfo| > 0.01)."""
        cfg, dev = self.config, self.device
        L = sym.shape[-1]
        phase_inc = float(np.float32(-2.0 * np.pi / cfg.sample_rate)) * cfo
        i = torch.arange(L, dtype=torch.float32, device=dev)
        corr_phase = phase[:, None] + phase_inc[:, None] * i
        corr = torch.polar(torch.ones_like(corr_phase), corr_phase)
        active = (cfo.abs() > 0.01)[:, None]
        corr = torch.where(active, corr, torch.ones((), dtype=torch.complex64,
                                                    device=dev))
        z = sym.to(torch.complex64) * osc.conj()[None, :] * corr
        fd = torch.complex(z.real @ self.Wr - z.imag @ self.Wi,
                           z.real @ self.Wi + z.imag @ self.Wr)
        phase = torch.where(
            active[:, 0],
            torch.remainder(phase + phase_inc * L + math.pi, 2 * math.pi)
            - math.pi, phase)
        return fd, phase

    def _osc(self, t0: int, n: int) -> torch.Tensor:
        t = t0 + torch.arange(n, dtype=torch.int32, device=self.device)
        return osc_int(self.config.center_freq, self.config.sample_rate, t)

    def _hard(self, sym: torch.Tensor) -> torch.Tensor:
        pts = self.points
        d2 = (torch.square(sym.real[..., None] - pts.real)
              + torch.square(sym.imag[..., None] - pts.imag))
        return pts[torch.argmin(d2, dim=-1)]

    def _demap(self, sym: torch.Tensor, nv: torch.Tensor) -> torch.Tensor:
        """Max-log-MAP over the 32 points (soft_demap.hpp:68-121)."""
        d2 = (sym[..., None] - self.demap_points).abs() ** 2
        s = 2.0 / nv
        inf = torch.full((), math.inf, dtype=d2.dtype, device=d2.device)
        out = []
        for b in range(5):
            mask = self.demap_masks[b]
            d1 = torch.where(mask, d2, inf).amin(-1)
            d0 = torch.where(mask, inf, d2).amin(-1)
            out.append(s * (d1 - d0))
        return clip_llr(torch.stack(out, dim=-1))

    def refined(self, h: torch.Tensor, nv0: torch.Tensor, cfo: torch.Tensor,
                phase: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
        """The refined path over [B, S, L] data symbols from mixer time
        2 plen: the LTS channel ``h`` [B, Cd], noise variance ``nv0`` [B],
        CFO and phase [B] -> LLRs [B, S*Cd*5]."""
        B, S, L = data.shape
        dev = self.device
        plen = self.config.fft_size + self.config.cyclic_prefix
        osc = self._osc(2 * plen, S * L).reshape(S, L)
        h = h[:, None, :]                                 # [B, 1, Cd]
        nv = nv0[:, None, None]
        fds = []
        for s in range(S):
            fd, phase = self._to_fd(cfo, phase, data[:, s], osc[s])
            fds.append(fd)
        fd = torch.stack(fds, dim=1)                      # [B, S, Cd]
        live = self.live

        # Dual decision-directed PLL: common phase and per-bin phase slope.
        h2 = h[:, 0, :]
        hp2 = torch.clamp(h2.abs() ** 2, min=1e-12)
        kbin = self.kbin
        phi = torch.zeros((B,), dtype=torch.float32, device=dev)
        om, psi, ups = phi, phi, phi
        phis, psis = [], []
        for s in range(S):
            fd_s, m_s = fd[:, s], live[:, s]
            ang = phi[:, None] + psi[:, None] * kbin[None, :]
            z = fd_s * torch.polar(torch.ones_like(ang), -ang)
            d_s = self._hard(z * h2.conj() / hp2)
            e = z * (h2 * d_s).conj() * m_s
            ec = e.sum(-1)
            err = torch.atan2(ec.imag, ec.real)
            th = e * torch.polar(torch.ones_like(err), -err)[:, None]
            resid_ph = torch.atan2(th.imag, th.real)
            w = e.abs()
            err_s = ((w * resid_ph * kbin[None, :]).sum(-1)
                     / torch.clamp((w * kbin[None, :] ** 2).sum(-1),
                                   min=1e-12))
            om = om + 0.05 * err
            phis.append(phi + err)
            phi = phi + om + 0.3 * err
            ups = ups + 0.05 * err_s
            psis.append(psi + err_s)
            psi = psi + ups + 0.3 * err_s
        slope = torch.stack(psis, dim=1)[:, :, None] * kbin[None, None, :]
        fd = fd * torch.polar(torch.ones_like(slope), -slope)
        phis = torch.stack(phis, dim=1)
        g = torch.polar(torch.ones_like(phis), phis)[:, :, None]

        # Three alternating rank-1 LS fits fd ~ g[s] h[c] d[s, c].
        d = None
        for _ in range(3):
            G = g * h
            Gp = torch.clamp(G.abs() ** 2, min=1e-12)
            d = self._hard(fd * G.conj() / Gp) * live
            hd = h * d
            g = ((fd * hd.conj()).sum(-1, keepdim=True)
                 / torch.clamp((hd.abs() ** 2).sum(-1, keepdim=True),
                               min=1e-30))
            gd = g * d
            h = ((fd * gd.conj()).sum(1, keepdim=True)
                 / torch.clamp((gd.abs() ** 2).sum(1, keepdim=True),
                               min=1e-30))

        # Per-carrier noise from the decision residual, then MMSE.
        G = g * h
        resid = (fd - G * d) * live
        cnt = torch.clamp(live.sum(1, keepdim=True), min=1.0)
        r = (resid.abs() ** 2).sum(1, keepdim=True) / cnt
        r = torch.maximum(r, 0.25 * nv)
        hp = G.abs() ** 2
        eq = G.conj() * fd / torch.clamp(hp + nv, min=1e-30)
        cnv = torch.clamp(r / (hp + 1e-6), MIN_CARRIER_NOISE_VAR,
                          MAX_CARRIER_NOISE_VAR)
        return self._demap(eq, cnv * QAM32_CE_MARGIN).reshape(B, -1)

    def llrs(self, samples: torch.Tensor, det: dict) -> torch.Tensor:
        """Each frame cut at its detected first LTS, the span's analytic
        half, the LTS estimate at the detected CFO, then the refined path
        -> [B, S*Cd*5]."""
        cfg, dev = self.config, self.device
        B, T = samples.shape
        plen = cfg.fft_size + cfg.cyclic_prefix
        L, S = cfg.symbol_duration, self.S
        span_len = 2 * plen + S * L
        starts = torch.clamp(det["lts_start"].to(torch.int64), 0,
                             T - span_len)
        idx = starts[:, None] + torch.arange(span_len, device=dev)
        span = samples.gather(1, idx)
        # The analytic half: DC dropped, positive frequencies doubled.
        n_fft = n_fft_of(span_len)
        mult = np.ones(n_fft, np.float32)
        mult[0] = 0.0
        mult[1:n_fft // 2] = 2.0
        mult[n_fft // 2 + 1:] = 0.0
        X = torch.fft.fft(span.to(torch.complex64), n=n_fft, dim=-1)
        span = (0.5 * torch.fft.ifft(X * torch.from_numpy(mult).to(dev),
                                     dim=-1)[..., :span_len]) \
            .to(torch.complex64)
        lts = span[:, :2 * plen].reshape(B, 2, plen)
        data = span[:, 2 * plen:2 * plen + S * L].reshape(B, S, L)
        cfo = torch.as_tensor(det["cfo_hz"], device=dev).to(torch.float32) \
            .expand(B).clone()
        phase = torch.full((B,), 0.0, dtype=torch.float32, device=dev)
        osc = self._osc(plen, plen)
        h = None
        for s in range(2):
            fd, phase = self._to_fd(cfo, phase, lts[:, s], osc)
            h = fd / self.lts_data[None, :]
        nv = torch.full((B,), DEFAULT_NOISE_VAR, dtype=torch.float32,
                        device=dev)
        return self.refined(h, nv, cfo, phase, data)

    def rx(self, samples: torch.Tensor, prefer=None, tie: float = 0.0):
        """[B, T] buffers -> (info [B, ncw*k] uint8, ok [B] (every codeword
        decoded, and found), iters [B, ncw], detection, the demodulated
        LLRs [B, S*Cd*5]); ``prefer`` and ``tie`` as ``detect``'s."""
        B = samples.shape[0]
        det = self.detect(samples, prefer, tie)
        n = ldpc.BLOCK_LENGTH
        demod = self.llrs(samples, det)
        blocks = demod[:, :self.ncw * n].reshape(-1, n)
        total, ok, iters = ldpc.decode(self.graph,
                                       blocks[:, self.perm].contiguous())
        info = (total[:, :self.graph.k] < 0).to(torch.uint8) \
            .reshape(B, -1)
        return (info, ok.reshape(B, self.ncw).all(-1) & det["found"],
                iters.reshape(B, self.ncw), det, demod)

"""The presynced OFDM frame pipeline of the reference: differential modes
(DQPSK) on a plan without pilots, CFO 0.

Frozen copies (commit eda5b68) of the port's plain PyTorch path behind
``ofdm/pipeline.tx_frame`` and ``rx_frame`` on such a plan:
``ofdm/carriers.carrier_map`` and ``lts_freq_domain``,
``fec/interleave.channel_interleaver``, ``ofdm/modulator`` (the DQPSK
symbol map, the synthesis tensors, the LTS training), and the
demodulator's fast path (``estimate_channel_from_lts`` over the training,
then all data symbols at once through the analysis tensor,
``_demod_differential_parallel``, and ``ops/demap.demap_dqpsk``), then the
deinterleave and the plain min-sum decoder of ``ldpc.py``.

Frame: [2 LTS training symbols][S data symbols], each symbol
[CP | N | guard]; the mixer runs from sample 0 of the training.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import ldpc
from .config import ModemConfig, Modulation
from .mixer import osc_fixed, osc_int

TRAINING_SYMBOLS = 2
DQPSK_PHASES = np.array([1, 1j, -1, -1j], np.complex64)   # 00/01/10/11
BITS = 2                      # DQPSK bits per carrier
DEFAULT_NOISE_VAR = 0.1
MIN_CARRIER_NOISE_VAR = 1e-6
MAX_CARRIER_NOISE_VAR = 100.0
MAX_LLR = 10.0
MIN_LLR_MAG = 0.5
WEAK = 1e-6


def check(config: ModemConfig, mod: Modulation) -> None:
    """Raise unless (config, mod) is a case this reference computes."""
    if mod != Modulation.DQPSK or config.use_pilots:
        raise ValueError("the OFDM reference computes DQPSK on a plan "
                         "without pilots only")


@functools.lru_cache(maxsize=None)
def data_idx(config: ModemConfig) -> np.ndarray:
    """FFT bins of the data carriers, symmetric around DC, DC skipped."""
    neg = config.num_carriers // 2
    pos = (config.num_carriers + 1) // 2
    out = [(i + config.fft_size) % config.fft_size
           for i in range(-neg, pos + 1) if i != 0]
    return np.asarray(out, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def sync_seq(config: ModemConfig) -> np.ndarray:
    """Zadoff-Chu u=1 over num_carriers: float32 cos/sin of -pi n(n+1)/N."""
    N = config.num_carriers
    n = np.arange(N, dtype=np.float32)
    phase = (-np.pi * n * (n + 1) / N).astype(np.float32)
    return (np.cos(phase) + 1j * np.sin(phase)).astype(np.complex64)


def lts_data(config: ModemConfig) -> np.ndarray:
    """The LTS's symbol on each data carrier."""
    Cd = len(data_idx(config))
    seq = sync_seq(config)
    return seq[np.arange(Cd) % len(seq)]


def find_coprime_step(n: int, total: int) -> int:
    target = n * 3
    if target >= total:
        target = total // 2
    for step in range(target, total):
        if math.gcd(step, total) == 1:
            return step
    for step in range(n + 1, total):
        if math.gcd(step, total) == 1:
            return step
    return n + 1


@functools.lru_cache(maxsize=None)
def interleaver(config: ModemConfig) -> tuple[np.ndarray, np.ndarray]:
    """(inv, perm) of the coprime-stride channel interleaver:
    interleave writes out[perm[i]] = in[i]."""
    total = ldpc.BLOCK_LENGTH
    step = find_coprime_step(len(data_idx(config)) * BITS, total)
    i = np.arange(total, dtype=np.int64)
    perm = (i * step) % total
    inv = np.empty(total, dtype=np.int64)
    inv[perm] = i
    return inv, perm


def num_data_symbols(config: ModemConfig) -> int:
    per_sym = len(data_idx(config)) * BITS
    return -(-ldpc.BLOCK_LENGTH // per_sym)


def frame_samples(config: ModemConfig) -> int:
    return (TRAINING_SYMBOLS + num_data_symbols(config)) \
        * config.symbol_duration


@functools.lru_cache(maxsize=None)
def synthesis(config: ModemConfig, t_offset: int, S: int):
    """(Ar, Ai) [S, C, L] float32: out = sr @ Ar - si @ Ai."""
    N, cp = config.fft_size, config.cyclic_prefix
    L = config.symbol_duration
    n_idx = (np.arange(L) - cp) % N
    live = np.arange(L) < cp + N
    rows = np.exp(2j * np.pi * np.outer(data_idx(config).astype(np.float64),
                                        n_idx) / N) / N
    rows = np.where(live[None, :], rows, 0.0)
    osc = osc_fixed(config.center_freq + config.tx_cfo_hz,
                    config.sample_rate, S * L, offset=t_offset).reshape(S, L)
    A = rows[None, :, :] * osc[:, None, :] * config.output_scale
    return A.real.astype(np.float32), A.imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def training(config: ModemConfig) -> np.ndarray:
    """TRAINING_SYMBOLS x [CP | LTS | guard], mixer from sample 0."""
    fd = np.zeros(config.fft_size, dtype=np.complex64)
    fd[data_idx(config)] = lts_data(config)
    td = np.fft.ifft(fd).astype(np.complex64)
    cp = config.cyclic_prefix
    one = np.concatenate([td[-cp:], td])
    L = config.symbol_duration
    out = np.zeros(TRAINING_SYMBOLS * L, dtype=np.float32)
    for c in range(TRAINING_SYMBOLS):
        t0 = c * L
        osc = osc_fixed(config.center_freq + config.tx_cfo_hz,
                        config.sample_rate, len(one), offset=t0)
        out[t0:t0 + len(one)] = (one * osc).real * config.output_scale
    return out


@functools.lru_cache(maxsize=None)
def lts_bins(config: ModemConfig):
    """(Wr, Wi) [L, C]: DFT rows of the data bins, CP and guard zeroed."""
    N, cp = config.fft_size, config.cyclic_prefix
    L = config.symbol_duration
    n_idx = np.arange(L) - cp
    live = (n_idx >= 0) & (n_idx < N)
    W = np.exp(-2j * np.pi * np.outer(n_idx % N, data_idx(config)
                                      .astype(np.float64)) / N)
    W = np.where(live[:, None], W, 0.0)
    return W.real.astype(np.float32), W.imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def analysis(config: ModemConfig, t0_base: int, S: int):
    """(Mr, Mi) [S, L, C]: conj(mixer) x DFT rows of the data bins."""
    N, cp = config.fft_size, config.cyclic_prefix
    L = config.symbol_duration
    osc = osc_fixed(config.center_freq, config.sample_rate, S * L,
                    offset=t0_base).reshape(S, L)
    n_idx = np.arange(L) - cp
    live = (n_idx >= 0) & (n_idx < N)
    W = np.exp(-2j * np.pi * np.outer(n_idx % N, data_idx(config)
                                      .astype(np.float64)) / N)
    W = np.where(live[:, None], W, 0.0)
    M = np.conj(osc)[:, :, None] * W[None, :, :]
    return M.real.astype(np.float32), M.imag.astype(np.float32)


def clip_llr(llr: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(llr, -MAX_LLR, MAX_LLR)
    small = c.abs() < MIN_LLR_MAG
    floor = torch.where(c >= 0, MIN_LLR_MAG, -MIN_LLR_MAG).to(c.dtype)
    return torch.where(small, floor, c)


def demap_dqpsk(sym, prev, nv):
    diff = sym * prev.conj()
    phase = torch.atan2(diff.imag, diff.real)
    sp = sym.abs() * prev.abs()
    scale = 2.0 * sp / nv
    llrs = torch.stack([clip_llr(scale * torch.sin(phase + math.pi / 4)),
                        clip_llr(scale * torch.cos(2 * phase))], dim=-1)
    return torch.where((sp < WEAK)[..., None], 0.0, llrs)


class Pipeline:
    """The reference's presynced pipeline for one (config, rate) on one
    device; every table built here from the configuration."""

    def __init__(self, config: ModemConfig, mod: Modulation, rate,
                 device: torch.device):
        check(config, mod)
        self.config, self.device = config, device
        self.graph = ldpc.Graph(ldpc.get_code(rate), device)
        L = config.symbol_duration
        self.S = num_data_symbols(config)
        S, Tr = self.S, TRAINING_SYMBOLS

        def on(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        inv, perm = interleaver(config)
        self.inv, self.perm = on(inv), on(perm)
        self.synth_r, self.synth_i = map(on, synthesis(config, Tr * L, S))
        self.training = on(training(config))
        self.lts_wr, self.lts_wi = map(on, lts_bins(config))
        self.analysis_r, self.analysis_i = map(on, analysis(config, Tr * L, S))
        self.points = on(DQPSK_PHASES)
        self.lts_data = on(lts_data(config))
        self.didx = torch.as_tensor(data_idx(config), dtype=torch.long,
                                    device=device)
        C = len(data_idx(config))
        first_bit = np.arange(S * C).reshape(S, C) * BITS
        self.filled = on(first_bit < ldpc.BLOCK_LENGTH)[None]

    # -- TX ---------------------------------------------------------------

    def tx(self, info: torch.Tensor) -> torch.Tensor:
        """[B, k] info bits -> [B, T] passband."""
        B = info.shape[0]
        cw = ldpc.encode(self.graph, info)[:, self.inv]
        C = self.didx.shape[0]
        pad = self.S * C * BITS - cw.shape[1]
        words = torch.nn.functional.pad(cw.to(torch.int32), (0, pad))
        words = words.reshape(B, self.S, C, BITS)
        words = words[..., 0] * 2 + words[..., 1]
        syms = self.points[torch.cumsum(words, dim=1) % 4]
        syms = torch.where(self.filled, syms,
                           torch.zeros((), dtype=torch.complex64,
                                       device=self.device))
        data = torch.einsum("bsc,scl->bsl", syms.real, self.synth_r) \
            - torch.einsum("bsc,scl->bsl", syms.imag, self.synth_i)
        data = data.reshape(B, -1)
        return torch.cat([self.training.expand(B, -1), data], dim=-1)

    # -- RX ---------------------------------------------------------------

    def llrs(self, samples: torch.Tensor) -> torch.Tensor:
        """[B, T] aligned passband -> [B, S*C*2] demodulated LLRs."""
        cfg = self.config
        B = samples.shape[0]
        L = cfg.symbol_duration
        Tr, S = TRAINING_SYMBOLS, self.S
        tr = samples[:, :Tr * L].reshape(B, Tr, L)
        h_last = None
        for s in range(Tr):
            t = s * L + torch.arange(L, dtype=torch.int32, device=self.device)
            osc = osc_int(cfg.center_freq, cfg.sample_rate, t)
            z = tr[:, s].to(torch.complex64) * osc.conj()[None, :]
            fd = torch.complex(z.real @ self.lts_wr - z.imag @ self.lts_wi,
                               z.real @ self.lts_wi + z.imag @ self.lts_wr)
            h_last = fd / self.lts_data[None, :]
        data = samples[:, Tr * L:(Tr + S) * L].reshape(B, S, L)
        rx = torch.complex(torch.einsum("bsl,slc->bsc", data, self.analysis_r),
                           torch.einsum("bsl,slc->bsc", data, self.analysis_i))
        h = h_last[:, None, :]
        hp = h.abs() ** 2
        good = hp > 1e-6
        eq = torch.where(good, rx * h.conj() / torch.clamp(hp, min=1e-30), rx)
        nv = torch.full((B, 1, 1), DEFAULT_NOISE_VAR, device=self.device)
        cnv = torch.where(good, nv / torch.clamp(hp, min=1e-30),
                          MAX_CARRIER_NOISE_VAR)
        cnv = torch.clamp(cnv, MIN_CARRIER_NOISE_VAR, MAX_CARRIER_NOISE_VAR)
        first = torch.ones((B, 1, eq.shape[-1]), dtype=torch.complex64,
                           device=self.device)
        prev = torch.cat([first, eq[:, :-1, :]], dim=1)
        return demap_dqpsk(eq, prev, cnv).reshape(B, -1)

    def rx(self, samples: torch.Tensor):
        """[B, T] -> (info [B, k] uint8, ok [B], iters [B])."""
        llrs = self.llrs(samples)[:, :ldpc.BLOCK_LENGTH][:, self.perm]
        total, ok, iters = ldpc.decode(self.graph, llrs.contiguous())
        info = (total[:, :self.graph.k] < 0).to(torch.uint8)
        return info, ok, iters

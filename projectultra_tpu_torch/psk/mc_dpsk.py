"""Multi-carrier DPSK, batched (port of projectultra_tpu/psk/mc_dpsk.py;
reference src/psk/multi_carrier_dpsk.hpp).

The per-carrier, per-sample loops of the reference are matmuls against
constant [C, L] carrier tables:

  TX: sample[s, i] = (cos(theta) @ COS - sin(theta) @ SIN)[s, i] / C
  RX: corr[s, c]   = (x @ COS^T - j x @ SIN^T)[s, c] / L

Semantics kept from the reference: each symbol's carrier phase restarts at
0; DQPSK steps {45, 135, -135, -45} degrees by the 2-bit word; training
phases (c * s) * 90 degrees, a reference symbol at 0; soft bits
conf = |corr| * C * 4, llr0 = conf * sin(phase), llr1 = conf * sin(2 phase),
clipped to +-10; CFO corrected per segment as a rotation of the zero-delay
FFT analytic signal with a per-segment initial phase; no channel
interleaving.

``tx_chirp_frame`` and ``decode_chirp_batch`` are the chirp-acquisition
step of the JAX bench (bench.py:173-223): the frame
[LEAD zeros][chirp][training][reference][data][TAIL zeros] on the TX side;
``detect_dual_chirp`` -> training start -> per-row span gather ->
``demodulate_presynced`` at the detected CFO -> LDPC decode on the RX side,
with no host synchronisation.  Host tables are cached per device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..config import CodeRate
from ..fec import ldpc as ldpc_codes
from ..ops import ldpc as ldpc_ops
from ..sim.watterson import analytic_mult
from ..sync import chirp as chirp_mod
from ..sync.chirp import ChirpConfig
from ..utils import metrics


@dataclasses.dataclass(frozen=True)
class MCDPSKConfig:
    """(multi_carrier_dpsk.hpp:26-92)"""
    sample_rate: float = 48000.0
    num_carriers: int = 8
    freq_low: float = 500.0
    freq_high: float = 2500.0
    samples_per_symbol: int = 512
    bits_per_symbol: int = 2           # 2 = DQPSK, 1 = DBPSK
    training_symbols: int = 8
    chirp_f_start: float = 300.0
    chirp_f_end: float = 2700.0
    chirp_duration_ms: float = 500.0
    use_dual_chirp: bool = True
    chirp_threshold: float = 0.15
    tx_cfo_hz: float = 0.0

    def carrier_freqs(self) -> np.ndarray:
        n = self.num_carriers
        if n == 1:
            return np.array([(self.freq_low + self.freq_high) / 2.0], np.float64)
        spacing = (self.freq_high - self.freq_low) / (n - 1)
        return self.freq_low + spacing * np.arange(n, dtype=np.float64)

    def chirp_config(self) -> ChirpConfig:
        return ChirpConfig(sample_rate=self.sample_rate,
                           f_start=self.chirp_f_start, f_end=self.chirp_f_end,
                           duration_ms=self.chirp_duration_ms, gap_ms=100.0,
                           use_dual_chirp=self.use_dual_chirp,
                           tx_cfo_hz=self.tx_cfo_hz)

    @property
    def bits_per_mc_symbol(self) -> int:
        return self.num_carriers * self.bits_per_symbol

    @property
    def training_samples(self) -> int:
        return self.training_symbols * self.samples_per_symbol

    @property
    def ref_samples(self) -> int:
        return self.samples_per_symbol


# DQPSK phase-change table indexed by the 2-bit word (hpp:207-210).
DQPSK_PHASES = np.array([np.pi / 4, 3 * np.pi / 4, -3 * np.pi / 4, -np.pi / 4],
                        np.float32)


def _level(n: int) -> MCDPSKConfig:
    return MCDPSKConfig(num_carriers=n)


# Speed-level presets (multi_carrier_dpsk.hpp:704-785).
def level5(): return _level(3)
def level6(): return _level(4)
def level7(): return _level(6)
def level8(): return _level(8)
def level9(): return _level(10)
def level10(): return _level(13)     # ModemEngine default (modem_engine.cpp:73)
def level11_ultra(): return _level(20)
def level12_ultra(): return _level(30)


@functools.lru_cache(maxsize=None)
def _carrier_tables(cfg: MCDPSKConfig):
    """COS/SIN [C, L] tables: cos/sin(i * 2*pi*f_c/fs), float32."""
    freqs = cfg.carrier_freqs()
    i = np.arange(cfg.samples_per_symbol, dtype=np.float64)
    ph = 2.0 * np.pi * freqs[:, None] * i[None, :] / cfg.sample_rate
    return (np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _tables_on(cfg: MCDPSKConfig, device: torch.device):
    """(COS, SIN, COS^T, SIN^T, DQPSK steps) on the device."""
    COS, SIN = _carrier_tables(cfg)
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                 for t in (COS, SIN, COS.T, SIN.T, DQPSK_PHASES))


def _synth(cfg: MCDPSKConfig, theta: torch.Tensor) -> torch.Tensor:
    """[..., S, C] absolute symbol phases -> [..., S*L] passband samples."""
    COS, SIN = _tables_on(cfg, theta.device)[:2]
    out = (torch.cos(theta) @ COS - torch.sin(theta) @ SIN) / cfg.num_carriers
    return out.reshape(*theta.shape[:-2],
                       theta.shape[-2] * cfg.samples_per_symbol)


def _synth_host(cfg: MCDPSKConfig, theta: np.ndarray) -> np.ndarray:
    """``_synth`` in float32 numpy for the host constants."""
    COS, SIN = _carrier_tables(cfg)
    out = (np.cos(theta) @ COS - np.sin(theta) @ SIN) / np.float32(
        cfg.num_carriers)
    return out.reshape(-1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def generate_training(cfg: MCDPSKConfig) -> np.ndarray:
    """Training: theta[sym, c] = (c*sym)*90deg (hpp:121-150)."""
    s = np.arange(cfg.training_symbols)[:, None]
    c = np.arange(cfg.num_carriers)[None, :]
    theta = ((c * s) % 4).astype(np.float32) * np.float32(np.pi / 2)
    return _synth_host(cfg, theta)


@functools.lru_cache(maxsize=None)
def generate_reference(cfg: MCDPSKConfig) -> np.ndarray:
    """Reference symbol: all carriers at phase 0 (hpp:154-174)."""
    return _synth_host(cfg, np.zeros((1, cfg.num_carriers), np.float32))


def preamble(cfg: MCDPSKConfig) -> np.ndarray:
    """[CHIRP][TRAINING][REF] (hpp:105-117)."""
    return np.concatenate([chirp_mod.generate(cfg.chirp_config()),
                           generate_training(cfg), generate_reference(cfg)])


def modulate(cfg: MCDPSKConfig, bits: torch.Tensor) -> torch.Tensor:
    """[B, nbits] {0,1} -> [B, S*L] passband data samples.  Differential
    phases accumulate from the reference symbol (phase 0) by a cumulative
    sum over the symbols."""
    B, nbits = bits.shape
    bc = cfg.bits_per_symbol
    per_sym = cfg.bits_per_mc_symbol
    S = -(-nbits // per_sym)
    b = torch.nn.functional.pad(bits.to(torch.int32),
                                (0, S * per_sym - nbits))
    words = b.reshape(B, S, cfg.num_carriers, bc)
    weights = 1 << torch.arange(bc - 1, -1, -1, dtype=torch.int32,
                                device=bits.device)
    words = (words * weights).sum(-1)                      # [B, S, C]
    if bc == 2:
        steps = _tables_on(cfg, bits.device)[4][words]
    else:
        steps = torch.where(words > 0, float(np.float32(np.pi)), 0.0)
    return _synth(cfg, torch.cumsum(steps, dim=1))


def num_symbols_for_bits(cfg: MCDPSKConfig, nbits: int) -> int:
    return -(-nbits // cfg.bits_per_mc_symbol)


# ---------------------------------------------------------------------------
# RX building blocks
# ---------------------------------------------------------------------------

def correlate_symbols(cfg: MCDPSKConfig, samples: torch.Tensor) -> torch.Tensor:
    """demodulateOneSymbol batched (hpp:737-753): [..., S*L] -> [..., S, C]
    complex correlations (mean of s * exp(-j i w_c))."""
    COS_T, SIN_T = _tables_on(cfg, samples.device)[2:4]
    L = cfg.samples_per_symbol
    S = samples.shape[-1] // L
    x = samples[..., :S * L].reshape(*samples.shape[:-1], S, L)
    return torch.complex(x @ COS_T / L, -(x @ SIN_T) / L)


def _as_f32(x, device: torch.device) -> torch.Tensor:
    """A float32 tensor of x; a Python number becomes a device fill, not a
    synchronising host-to-device copy."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(np.float32(x)), device=device)


def _rotation(cfo: torch.Tensor, initial_phase: torch.Tensor, n: int,
              sample_rate: float, active: torch.Tensor | None = None):
    """exp(j*(initial_phase - 2*pi*cfo*i/fs)) for i < n, [..., n]."""
    i = torch.arange(n, dtype=torch.float32, device=cfo.device)
    ph = initial_phase[..., None] \
        - 2.0 * np.pi * cfo[..., None] * i / float(np.float32(sample_rate))
    if active is not None:
        ph = torch.where(active, ph, 0.0)
    return torch.polar(torch.ones_like(ph), ph)


def apply_cfo_segment(samples: torch.Tensor, cfo_hz, initial_phase,
                      sample_rate: float = 48000.0, intra_offset=None,
                      out_len: int = 0) -> torch.Tensor:
    """CFO-correct one segment: the analytic signal (FFT at the next power
    of two) rotated by exp(j*(initial_phase - 2*pi*cfo*i/fs)), real part
    (applyCFOCorrection, hpp:632-659).  Lanes with |cfo| <= 0.1 Hz are
    returned unchanged.

    ``intra_offset`` (a per-row integer tensor, with ``out_len``): the
    segment arrives over-sliced, its true start ``intra_offset`` samples
    in; the shift rides the Hilbert FFT as the phase ramp
    e^{+j 2 pi k r / N} and [0, out_len) is kept.  In this mode an
    inactive lane is the analytic real part (equal to the input up to the
    FFT round trip).  The default mode is the golden-parity route."""
    T = samples.shape[-1]
    dev = samples.device
    n_fft = 1 << (T - 1).bit_length()
    cfo = _as_f32(cfo_hz, dev)
    phase0 = _as_f32(initial_phase, dev)
    active = (cfo.abs() > 0.1)[..., None]
    spec = torch.fft.fft(samples.to(torch.complex64), n=n_fft, dim=-1) \
        * analytic_mult(n_fft, dev)
    if intra_offset is None:
        analytic = torch.fft.ifft(spec, dim=-1)[..., :T]
        out = (analytic * _rotation(cfo, phase0, T, sample_rate)).real
        return torch.where(active, out, samples)
    k = torch.arange(n_fft, dtype=torch.float32, device=dev)
    r = intra_offset.to(torch.float32)
    ramp_ph = (float(np.float32(2.0 * np.pi / n_fft)) * r)[..., None] * k
    ramp = torch.polar(torch.ones_like(ramp_ph), ramp_ph)
    analytic = torch.fft.ifft(spec * ramp, dim=-1)[..., :out_len]
    return (analytic * _rotation(cfo, phase0, out_len, sample_rate,
                                 active)).real


@functools.lru_cache(maxsize=None)
def _expected_steps(cfg: MCDPSKConfig, device: torch.device) -> torch.Tensor:
    """exp(j*c*90deg) [C]: the training's expected symbol-to-symbol step."""
    c = np.arange(cfg.num_carriers, dtype=np.float32) * np.float32(np.pi / 2)
    return torch.polar(torch.ones(c.shape), torch.from_numpy(c)).to(device)


def training_score(cfg: MCDPSKConfig, training: torch.Tensor) -> torch.Tensor:
    """Correlation of the received training against the known (c*s)*90deg
    pattern, in [0, 1] (a PING has no structured training)."""
    corr = correlate_symbols(cfg, training[..., :cfg.training_samples])
    d = corr[..., 1:, :] * corr[..., :-1, :].conj()
    mag = d.abs()
    dn = torch.where(mag > 1e-12, d / torch.clamp(mag, min=1e-30), 0.0)
    s = (dn * _expected_steps(cfg, training.device).conj()) \
        .reshape(*dn.shape[:-2], -1)
    return s.mean(-1).abs()


@functools.lru_cache(maxsize=None)
def _clean_training_corr(cfg: MCDPSKConfig):
    """Noise-free per-symbol training correlations [S, C] (real and
    imaginary float32 parts, computed in float64): they include the
    inter-carrier leakage of the non-bin-aligned carriers, so the SNR
    estimator's residual is noise only."""
    tr = generate_training(cfg)
    COS, SIN = _carrier_tables(cfg)
    L = cfg.samples_per_symbol
    x = tr.reshape(-1, L).astype(np.float64)
    I = x @ COS.T.astype(np.float64) / L
    Q = -(x @ SIN.T.astype(np.float64)) / L
    return I.astype(np.float32), Q.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _clean_on(cfg: MCDPSKConfig, device: torch.device) -> torch.Tensor:
    cr, ci = _clean_training_corr(cfg)
    return torch.complex(torch.from_numpy(cr), torch.from_numpy(ci)).to(device)


def estimate_snr_db(cfg: MCDPSKConfig, training: torch.Tensor) -> torch.Tensor:
    """Per-carrier post-correlation SNR from the training symbols
    (channel_equalizer.cpp:221 semantics: |H|^2 over the per-carrier noise
    variance), by a least-squares per-carrier gain against the known
    noise-free training correlations."""
    corr = correlate_symbols(cfg, training[..., :cfg.training_samples])
    clean = _clean_on(cfg, training.device)[:corr.shape[-2]]
    denom = (clean.abs() ** 2).sum(-2)
    h = (corr * clean.conj()).sum(-2) / torch.clamp(denom, min=1e-12)
    resid = corr - h[..., None, :] * clean
    sig = ((h[..., None, :] * clean).abs() ** 2).mean((-1, -2))
    noise = (resid.abs() ** 2).mean((-1, -2))
    snr = sig / torch.clamp(noise, min=1e-12)
    return 10.0 * torch.log10(torch.clamp(snr, 1e-3, 1e5))


def estimate_residual_cfo(cfg: MCDPSKConfig,
                          training: torch.Tensor) -> torch.Tensor:
    """processTraining (hpp:392-422): residual CFO from the phase error
    between the first two training symbols against the expected c*90deg
    step."""
    corr = correlate_symbols(cfg, training[..., :2 * cfg.samples_per_symbol])
    err = corr[..., 1, :] * corr[..., 0, :].conj() \
        * _expected_steps(cfg, training.device).conj()
    sym_dur = cfg.samples_per_symbol / cfg.sample_rate
    return torch.angle(err).mean(-1) / (2.0 * np.pi * sym_dur)


def reference_symbols(cfg: MCDPSKConfig, ref: torch.Tensor) -> torch.Tensor:
    """setReference (hpp:424-435): normalised per-carrier correlation."""
    corr = correlate_symbols(cfg, ref[..., :cfg.samples_per_symbol])[..., 0, :]
    mag = corr.abs()
    one = torch.ones((), dtype=torch.complex64, device=ref.device)
    return torch.where(mag > 0.001, corr / torch.clamp(mag, min=1e-30), one)


def demodulate_soft(cfg: MCDPSKConfig, data: torch.Tensor,
                    prev: torch.Tensor) -> torch.Tensor:
    """demodulateSoft (hpp:437-470): [..., S*L] + prev [..., C] ->
    LLRs [..., S*C*bits]."""
    corr = correlate_symbols(cfg, data)                    # [..., S, C]
    mag = corr.abs()
    one = torch.ones((), dtype=torch.complex64, device=data.device)
    normed = torch.where(mag > 0.0001, corr / torch.clamp(mag, min=1e-30), one)
    prev_chain = torch.cat([prev[..., None, :], normed[..., :-1, :]], dim=-2)
    phase = torch.angle(normed * prev_chain.conj())
    phase = torch.where(phase < 0, phase + 2 * np.pi, phase)
    conf = mag * cfg.num_carriers * 4.0
    if cfg.bits_per_symbol == 2:
        llrs = torch.stack([conf * torch.sin(phase),
                            conf * torch.sin(2.0 * phase)], dim=-1)
    else:
        llrs = (conf * torch.cos(phase))[..., None]
    llrs = torch.clamp(llrs, -10.0, 10.0)
    return llrs.reshape(*llrs.shape[:-3], -1)


def demodulate_presynced(cfg: MCDPSKConfig, samples: torch.Tensor, cfo_hz,
                         train_start_abs, num_data_symbols: int,
                         intra_offset=None) -> torch.Tensor:
    """Presynced MC-DPSK RX for a batch of frames.

    Args:
      samples: [B, T] aligned at the TRAINING start ([TRAINING][REF][DATA]);
        with ``intra_offset``, an over-slice whose true training start lies
        intra_offset[b] samples in (its tail must reach past the data end
        by at least max(intra_offset)).
      cfo_hz: [B] (or scalar) dual-chirp CFO estimate.
      train_start_abs: [B] (or scalar) absolute sample index of the
        training start in the original stream; the per-segment CFO phases
        derive from it.
      intra_offset: optional [B] integer residue of an aligned gather.
    Returns LLRs [B, num_data_symbols * bits_per_mc_symbol]."""
    L = cfg.samples_per_symbol
    tr_n, ref_n = cfg.training_samples, cfg.ref_samples
    fs = cfg.sample_rate
    dev = samples.device
    cfo = _as_f32(cfo_hz, dev)
    t0 = _as_f32(train_start_abs, dev)

    def phase_at(abs_pos):
        ph = -2.0 * np.pi * cfo * abs_pos / float(np.float32(fs))
        return torch.remainder(ph + np.pi, 2 * np.pi) - np.pi

    d0 = tr_n + ref_n
    n_data = num_data_symbols * L
    if intra_offset is None:
        ref_seg = apply_cfo_segment(samples[:, tr_n:tr_n + ref_n], cfo,
                                    phase_at(t0 + tr_n), fs)
        data = apply_cfo_segment(samples[:, d0:d0 + n_data], cfo,
                                 phase_at(t0 + d0), fs)
    else:
        pad = samples.shape[-1] - tr_n - ref_n - n_data
        ref_seg = apply_cfo_segment(samples[:, tr_n:tr_n + ref_n + pad], cfo,
                                    phase_at(t0 + tr_n), fs,
                                    intra_offset=intra_offset, out_len=ref_n)
        data = apply_cfo_segment(samples[:, d0:d0 + n_data + pad], cfo,
                                 phase_at(t0 + d0), fs,
                                 intra_offset=intra_offset, out_len=n_data)
    prev = reference_symbols(cfg, ref_seg)
    return demodulate_soft(cfg, data, prev)


# ---------------------------------------------------------------------------
# The chirp-acquisition step (bench.py:173-223)
# ---------------------------------------------------------------------------

LEAD, TAIL = 4800, 4000   # the bench frame's zeros before and after


@functools.lru_cache(maxsize=None)
def _preamble_on(cfg: MCDPSKConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(preamble(cfg)).to(device)


def frame_samples(cfg: MCDPSKConfig, rate: CodeRate) -> int:
    """T of ``tx_chirp_frame``: 83,808 for level10 at R1/4."""
    n_sym = num_symbols_for_bits(cfg, ldpc_codes.get_code(rate).n)
    return (LEAD + len(preamble(cfg)) + n_sym * cfg.samples_per_symbol
            + TAIL)


def tx_chirp_frame(cfg: MCDPSKConfig, rate: CodeRate,
                   info_bits: torch.Tensor) -> torch.Tensor:
    """[B, k] info bits -> [B, T] float32 frames as the bench builds them:
    [LEAD zeros][chirp][training][reference][one codeword][TAIL zeros]."""
    with metrics.span("mcdpsk.tx", info_bits):
        B, dev = info_bits.shape[0], info_bits.device
        graph = ldpc_ops.graph_for(ldpc_codes.get_code(rate), dev)
        data = modulate(cfg, ldpc_ops.encode_with(graph, info_bits))
        pre = _preamble_on(cfg, dev)
        return torch.cat([torch.zeros((B, LEAD), device=dev),
                          pre.expand(B, pre.shape[0]), data,
                          torch.zeros((B, TAIL), device=dev)], dim=-1)


def demodulate_detected(cfg: MCDPSKConfig, samples: torch.Tensor,
                        det: dict, num_data_symbols: int) -> torch.Tensor:
    """Cut every frame at the training start of its detected down chirp
    (an exact per-row gather; the bench's 128-aligned over-slice with
    ``intra_offset`` avoids a TPU gather penalty and timed the same on the
    H100, PERF.md) and demodulate it at the detected CFO.  Returns LLRs
    [B, nbits]."""
    with metrics.span("mcdpsk.demodulate", samples):
        tr = chirp_mod.training_start(cfg.chirp_config(),
                                      det["down_chirp_start"])
        span_len = (cfg.training_samples + cfg.ref_samples
                    + num_data_symbols * cfg.samples_per_symbol)
        span = chirp_mod.frame_spans(samples, tr, span_len)
        return demodulate_presynced(cfg, span, det["cfo_hz"],
                                    tr.to(torch.float32), num_data_symbols)


def decode_chirp_batch(cfg: MCDPSKConfig, rate: CodeRate,
                       samples: torch.Tensor):
    """The acquisition-inclusive receiver step of the bench on [B, T]
    buffers that each hold one frame at an unknown position:
    ``detect_dual_chirp`` -> ``demodulate_detected`` -> LDPC decode of the
    first codeword (no channel interleaver).  Nothing is read to the host.

    Returns (info [B, k] uint8, ok [B] bool (decoded AND detected),
    iters [B] int32, det dict)."""
    with metrics.span("mcdpsk.rx", samples):
        code = ldpc_codes.get_code(rate)
        det = chirp_mod.detect_dual_chirp(cfg.chirp_config(), samples,
                                          threshold=cfg.chirp_threshold)
        llrs = demodulate_detected(cfg, samples, det,
                                   num_symbols_for_bits(cfg, code.n))
        graph = ldpc_ops.graph_for(code, samples.device)
        llr_total, ok, iters = ldpc_ops.decode_totals(graph, llrs[:, :code.n])
        info = (llr_total[:, :code.k] < 0).to(torch.uint8)
        return info, ok & det["success"], iters, det

"""Schmidl-Cox preamble acquisition, batched (port of
projectultra_tpu/sync/schmidl_cox.py; reference src/ofdm/ofdm_sync.cpp and
the SEARCHING state of src/ofdm/demodulator.cpp:462-600).

* ONE global FFT-Hilbert transform gives the analytic signal; the
  half-symbol correlation P and the window energies R1, R2 come from
  ``ops.sc_windows`` (the hand-written CUDA kernel on the card) at every
  offset (``sc_metric``) or on the stride-8 candidate grid
  (``detect_preamble``);
* plateau confirmation (>= 15 of the 8-strided offsets in a 300-sample
  window above the plateau gate) becomes windowed counts over that grid;
* LTS fine timing is a matched filter against the passband LTS template
  with a masked argmax around each lane's coarse position
  (``lts_timing``): on the card one hand-written kernel that evaluates
  only each lane's search window (``ops/cuda_lts.py``); elsewhere
  ``lts_timing_plain``, an FFT matched filter over the whole buffer that
  shares the signal FFT with the Hilbert transform.

``decode_ofdm_cox`` and ``hunt_for_codeword`` are the JAX package's two Cox
receivers; ``demodulate_detected`` and ``decode_cox_batch`` are the
acquisition-inclusive step of its bench (bench.py:330-342): detect, cut
each frame at its own detected LTS, demodulate with pilot tracking at the
detected CFO, deinterleave, decode.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import CodeRate, ModemConfig, bits_per_symbol
from ..fec import ldpc as ldpc_codes
from ..ofdm import carriers as carriers_mod
from ..fec.interleave import channel_interleaver
from ..ofdm import demodulator as demod_mod
from ..ofdm import pipeline as ofdm_pipeline
from ..ops import cuda_lts
from ..ops import ldpc as ldpc_ops
from ..ops import mixer as mixer_ops
from ..ops.sc_windows import sc_windows
from ..ops.sc_windows import window_sum as _window_sum
from ..utils import metrics

# The plateau gate is 0.85, not the reference's 0.90
# (demodulator_constants.hpp:51), as in the JAX package: 0.90 caps coherent
# OFDM acquisition near 18 dB wideband SNR.
PLATEAU_THRESHOLD = 0.85
PLATEAU_SEARCH_WINDOW = 300
MIN_PLATEAU_SAMPLES = 15
SEARCH_STEP = 8

# Deep-acquisition gates (a capability extension of the JAX package, not
# reference behaviour): candidates down to ~7-8 dB wideband, believed only
# after an LDPC-magic check downstream.
DEEP_SYNC_THRESHOLD = 0.60
DEEP_PLATEAU_THRESHOLD = 0.62
DEEP_MIN_PLATEAU = 12
DEEP_LTS_THRESHOLD = 0.22

MAGIC = bytes([0x55, 0x4C])  # first two info bytes of a v2 frame


def _n_fft(T: int) -> int:
    return 1 << (T - 1).bit_length()


@functools.lru_cache(maxsize=None)
def _hilbert_mult(n_fft: int, device: torch.device) -> torch.Tensor:
    """DC dropped, positive frequencies doubled, negative ones zeroed;
    made once per device."""
    mult = np.ones(n_fft, np.float32)
    mult[0] = 0.0
    mult[1:n_fft // 2] = 2.0
    mult[n_fft // 2 + 1:] = 0.0
    return torch.from_numpy(mult).to(device)


def analytic_signal(samples: torch.Tensor,
                    X: torch.Tensor | None = None) -> torch.Tensor:
    """FFT Hilbert transform over the whole buffer (ofdm_sync.cpp:56-84)
    at n_fft = the next power of two of T.  ``X`` is an optional
    precomputed fft(samples, n_fft), shared with the LTS matched filter.
    Returns the first T columns of the [..., n_fft] inverse transform (a
    view, not a copy)."""
    T = samples.shape[-1]
    n_fft = _n_fft(T)
    if X is None:
        X = torch.fft.fft(samples.to(torch.complex64), n=n_fft, dim=-1)
    return torch.fft.ifft(X * _hilbert_mult(n_fft, X.device), dim=-1)[..., :T]


def _gated_corr(P: torch.Tensor, R1: torch.Tensor,
                R2: torch.Tensor) -> torch.Tensor:
    denom = torch.sqrt(torch.clamp(R1 * R2, min=0.0))
    return torch.where(denom > 1e-10,
                       P.abs() / torch.clamp(denom, min=1e-30), 0.0)


def sc_metric(config: ModemConfig, samples: torch.Tensor,
              X: torch.Tensor | None = None):
    """Schmidl-Cox |P|/sqrt(R1 R2) and P at every offset of [B, T] samples.

    Returns (corr [B, n_off], P [B, n_off]); offset d is a candidate STS
    start (the FFT window begins at d + CP)."""
    N, cp = config.fft_size, config.cyclic_prefix
    a = analytic_signal(samples, X)
    n_off = samples.shape[-1] - N - cp + 1
    P, R1, R2 = sc_windows(a, N // 2, 1, cp, n_off)
    return _gated_corr(P, R1, R2), P


@functools.lru_cache(maxsize=None)
def lts_passband_template(config: ModemConfig) -> np.ndarray:
    """Passband LTS template [CP | LTS] mixed at fc (demodulator.cpp:100-134),
    complex (I + jQ) for a phase-invariant magnitude correlation."""
    fd = carriers_mod.lts_freq_domain(config)
    td = np.fft.ifft(fd).astype(np.complex64)
    cp = config.cyclic_prefix
    bb = np.concatenate([td[-cp:], td])
    osc = mixer_ops.osc_fixed(config.center_freq, config.sample_rate, len(bb))
    return (bb * osc).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _lts_filter(config: ModemConfig, n_fft: int,
                device: torch.device) -> torch.Tensor:
    """conj(fft(conj(template), n_fft)): the matched filter's spectrum,
    made once per device."""
    tmpl = torch.from_numpy(np.conj(lts_passband_template(config))).to(device)
    return torch.fft.fft(tmpl, n=n_fft).conj()


@functools.lru_cache(maxsize=None)
def lts_energy_ref(config: ModemConfig) -> float:
    """Half the LTS template's energy, the matched filter's normaliser."""
    return float((np.abs(lts_passband_template(config)) ** 2).sum()) * 0.5


def _pick(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.gather(1, idx[:, None])[:, 0]


def lts_timing_plain(config: ModemConfig, samples: torch.Tensor,
                     X: torch.Tensor, sync_offs: list) -> list:
    """LTS fine timing (ofdm_sync.cpp:386-466) of [B, T] samples, whose
    signal FFT is ``X``, at each of ``sync_offs`` ([B] int64 coarse
    positions, one a gate set): the normalised matched filter over the
    whole buffer, made once, and for each gate set its first argmax in the
    search window [-3*plen, +plen/2] around sync_off + 4*plen and the
    one-symbol rule.  Returns one (lts_start, data_start, lts_corr) of [B]
    tensors (int32, int32, float32) a gate set.  The CPU path, and the
    LTS timing kernel's oracle on the card."""
    B, T = samples.shape
    plen = config.fft_size + config.cyclic_prefix
    dev = samples.device
    L = len(lts_passband_template(config))
    e_ref = lts_energy_ref(config)
    mf = torch.fft.ifft(X * _lts_filter(config, X.shape[-1], dev),
                        dim=-1)[:, :T - L + 1].abs()
    energy = _window_sum(samples * samples, L)
    nmf = torch.where(energy * e_ref > 1e-12,
                      mf / torch.sqrt(torch.clamp(energy * e_ref,
                                                  min=1e-30)),
                      0.0)
    n_mf = nmf.shape[-1]
    pos = torch.arange(n_mf, device=dev)[None, :]
    out = []
    for sync_off in sync_offs:
        coarse_lts = sync_off + 4 * plen
        win = (pos >= (coarse_lts - 3 * plen)[:, None]) \
            & (pos <= (coarse_lts + plen // 2)[:, None])
        lts_start = torch.argmax(torch.where(win, nmf, -1.0), dim=-1)
        lts_corr = _pick(nmf, lts_start)
        # The two LTS symbols are identical, so the matched filter has a
        # one-symbol ambiguity: if a comparable peak lies one symbol
        # EARLIER (still in the window), prefer it.
        prev_pos = torch.clamp(lts_start - plen, 0, n_mf - 1)
        prev_corr = _pick(nmf, prev_pos)
        prev_in_win = (lts_start - plen) >= (coarse_lts - 3 * plen)
        take_prev = prev_in_win & (prev_corr >= 0.85 * lts_corr)
        lts_start = torch.where(take_prev, prev_pos, lts_start)
        lts_corr = torch.where(take_prev, prev_corr, lts_corr)
        # The first data sample follows the two LTS.
        out.append((lts_start.to(torch.int32),
                    (lts_start + 2 * plen).to(torch.int32), lts_corr))
    return out


def lts_timing(config: ModemConfig, samples: torch.Tensor, X: torch.Tensor,
               sync_offs: list) -> list:
    """Device dispatch of LTS fine timing: on a CUDA tensor one launch of
    the LTS timing kernel a gate set (``ops/cuda_lts.py``: the window's
    positions only, the non-finite lanes read from X's DC bin), on any
    other ``lts_timing_plain``.  Arguments and result as
    ``lts_timing_plain``'s."""
    with metrics.span("cox.lts", samples):
        if samples.device.type == "cuda":
            return [cuda_lts.lts_timing_cuda(config, samples, s, X[:, 0])
                    for s in sync_offs]
        return lts_timing_plain(config, samples, X, sync_offs)


def search_grid_size(config: ModemConfig, T: int) -> int:
    """Points G of ``detect_preamble``'s stride-8 candidate grid on a
    buffer of T samples: every correlation window must end inside the
    stride blocks of the first (T // 8) * 8 samples; for a stride-divisible
    T this is ceil(n_off / 8), the full grid (schmidl_cox.py:213-216)."""
    N, cp, st = config.fft_size, config.cyclic_prefix, SEARCH_STEP
    n_off = T - N - cp + 1
    return min(-(-n_off // st), T // st - 2 * (N // 2 // st) + 1 - cp // st)


def detect_preamble(config: ModemConfig, samples: torch.Tensor,
                    sync_threshold: float = 0.80,
                    plateau_threshold: float = PLATEAU_THRESHOLD,
                    min_plateau: int = MIN_PLATEAU_SAMPLES,
                    lts_threshold: float | None = None,
                    with_deep: bool = False) -> dict:
    """Batched SEARCHING logic on [B, T] float32 samples: Schmidl-Cox
    plateau -> coarse CFO -> LTS fine timing (demodulator.cpp:474-599).

    ``with_deep`` also evaluates the DEEP_* gate set on the same metric,
    with its own LTS timing (``lts_timing``: one more kernel launch on the
    card), and returns it under "deep_"-prefixed keys.

    Returns a dict of [B] tensors: found (bool), data_start (first data
    sample), cfo_hz, peak_corr, lts_corr, lts_start, sync_off (int32 but
    for the float32 cfo and correlations).  Nothing is read to the host."""
    with metrics.span("cox.detect", samples):
        B, T = samples.shape
        N, cp = config.fft_size, config.cyclic_prefix
        plen = N + cp
        dev = samples.device

        # ONE signal FFT shared by the analytic transform and the LTS filter.
        n_fft = _n_fft(T)
        X = torch.fft.fft(samples.to(torch.complex64), n=n_fft, dim=-1)
        n_off = T - N - cp + 1

        # Schmidl-Cox metric and energy gate on the stride-8 candidate grid
        # (the reference's coarse loop also steps 8).  Grid point g is the
        # candidate d = 8*g whose correlation window starts at d + cp.
        st = SEARCH_STEP
        half = N // 2
        if cp % st or half % st:
            raise ValueError(f"cp={cp} and N/2={half} must be multiples "
                             f"of {st}")
        a = analytic_signal(samples, X)
        nb, cpb = T // st, cp // st
        G = search_grid_size(config, T)
        gP, gR1, gR2 = sc_windows(a, half, st, cp, G)
        gcorr = _gated_corr(gP, gR1, gR2)

        # Energy gate (hasMinimumEnergy, ofdm_sync.cpp:20-50) on the exact FFT
        # window [d+cp, d+cp+N): the noise floor is min(0.1 x first-window
        # energy, least window energy), and windows 40 dB below the buffer's
        # peak are rejected (true silence carries only Hilbert ringing).
        sb = (samples * samples)[:, :nb * st].reshape(B, nb, st).sum(-1)
        Ew = _window_sum(sb, N // st)
        e_all = Ew[:, cpb:cpb + G] / N
        floor = torch.clamp(torch.minimum(0.1 * e_all[:, :1],
                                          e_all.amin(-1, keepdim=True)),
                            min=1e-10)
        energy_ok = (e_all >= 4.0 * floor) \
            & (e_all >= 1e-4 * e_all.amax(-1, keepdim=True))
        gcorr = torch.where(energy_ok, gcorr, 0.0)                # [B, G]

        grid = torch.arange(G, device=dev) * st               # sample units
        win_pts = PLATEAU_SEARCH_WINDOW // SEARCH_STEP + 1
        # Leave room for the full preamble and LTS search beyond a candidate.
        max_start = n_off - 6 * plen - 2 * plen
        rel = torch.arange(win_pts, device=dev)

        def coarse(sync_t, plat_t, min_plat) -> dict:
            # Plateau count in [g, g+300] on the grid: 38 points.
            above = (gcorr >= plat_t).to(torch.float32)
            counts = _window_sum(above, win_pts)              # [B, G-win+1]
            Gc = counts.shape[-1]
            cand = (gcorr[:, :Gc] > sync_t) & (counts >= min_plat) \
                & (grid[None, :Gc] < max(max_start, 1))
            found_sc = cand.any(-1)
            # The first candidate.
            first = torch.argmax(cand.to(torch.int32), dim=-1)

            # Peak within the plateau window after the first candidate.
            win_idx = torch.clamp(first[:, None] + rel[None, :], 0, G - 1)
            wcorr = gcorr.gather(1, win_idx)
            peak_rel = torch.argmax(wcorr, dim=-1)
            gidx = torch.clamp(first + peak_rel, 0, G - 1)

            # Coarse CFO from P at the sync offset (ofdm_sync.cpp:230-258).
            phase = torch.angle(_pick(gP, gidx))
            cfo = phase * config.sample_rate / (math.pi * N)
            max_cfo = config.sample_rate / N
            cfo = torch.clamp(cfo, -max_cfo, max_cfo)
            return {"found_sc": found_sc, "sync_off": grid[gidx],
                    "cfo_hz": cfo, "peak_corr": _pick(wcorr, peak_rel)}

        if lts_threshold is None:
            lts_threshold = 0.05 if config.fft_size >= 1024 else 0.35
        gates = {"": (sync_threshold, plateau_threshold, min_plateau,
                      lts_threshold)}
        if with_deep:
            gates["deep_"] = (DEEP_SYNC_THRESHOLD, DEEP_PLATEAU_THRESHOLD,
                              DEEP_MIN_PLATEAU,
                              min(DEEP_LTS_THRESHOLD, lts_threshold))
        sets = {prefix: coarse(*g[:3]) for prefix, g in gates.items()}
        # LTS fine timing around each gate set's sync_off + 4*plen.
        timing = lts_timing(config, samples, X,
                            [c["sync_off"] for c in sets.values()])
        out = {}
        for (prefix, c), (lts_start, data_start, lts_corr) in zip(
                sets.items(), timing):
            found = c["found_sc"] & (lts_corr >= gates[prefix][3])
            det = {"found": found, "data_start": data_start,
                   "cfo_hz": c["cfo_hz"], "peak_corr": c["peak_corr"],
                   "lts_corr": lts_corr, "lts_start": lts_start,
                   "sync_off": c["sync_off"].to(torch.int32)}
            out.update({prefix + k: v for k, v in det.items()})
        return out


def hunt_for_codeword(config: ModemConfig, mod, samples: torch.Tensor,
                      data_start: int, rate: CodeRate | None = None,
                      cfo_hz: float = 0.0, interleaved: bool = True,
                      offsets=(0, -50, 50, -100, 100, -150, 150)):
    """LDPC-validated timing hunt (huntForCodeword, ofdm_sync.cpp:469-643).

    Every candidate offset of the nominal first data sample demodulates as
    one batch (offset = batch row) with pilot tracking and no training, one
    LDPC batch (rate R1/4 by default) validates them, and the first offset
    in the given priority order whose CW0 decodes and starts with the
    0x554C magic wins.  ``samples`` is [T] or [1, T].  The decoded bits are
    read to the host once.  Returns (found, offset or None)."""
    rate = CodeRate.R1_4 if rate is None else rate
    code = ldpc_codes.get_code(rate)
    x = samples.reshape(-1)
    S = ofdm_pipeline.num_data_symbols(config, mod, 1)
    span_len = S * config.symbol_duration

    valid = [o for o in offsets if 0 <= data_start + o
             and data_start + o + span_len <= x.shape[-1]]
    if not valid:
        return False, None
    spans = torch.stack([x[data_start + o:data_start + o + span_len]
                         for o in valid])
    llrs, _ = demod_mod.demodulate_presynced(
        config, mod, spans, float(cfo_hz), 0.0, training_symbols=0,
        num_data_symbols=S)
    deint = llrs[:, :code.n]
    if interleaved:
        cm = carriers_mod.carrier_map(config)
        ci = channel_interleaver(len(cm.data_idx) * bits_per_symbol(mod),
                                 code.n)
        deint = deint[:, torch.as_tensor(ci.perm, device=deint.device)]
    info, ok, _ = ldpc_ops.decode(code, deint)
    info, ok = info.cpu().numpy(), ok.cpu().numpy()
    for i, o in enumerate(valid):
        if ok[i] and np.packbits(info[i, :16]).tobytes() == MAGIC:
            return True, o
    return False, None


def decode_ofdm_cox(config: ModemConfig, mod, samples: torch.Tensor,
                    n_codewords: int, sync_threshold: float = 0.80,
                    front: str = "analytic"):
    """Streaming OFDM_COX RX for a batch of frames that share one
    data_start: detect the preamble, then demodulate from the FIRST LTS
    with both LTS symbols as training and pilot tracking.  Lane 0's
    ``lts_start`` is read to the host (one synchronisation by design) and
    fixes the span for every lane; lead/tail margins of {0, plen, 2*plen}
    keep the Hilbert FFT's wrap away from the used symbols.

    Returns (llrs [B, nbits], det dict)."""
    det = detect_preamble(config, samples, sync_threshold)
    start_lts = int(det["lts_start"][0])
    plen = config.fft_size + config.cyclic_prefix
    S = ofdm_pipeline.num_data_symbols(config, mod, n_codewords)
    end = start_lts + 2 * plen + S * config.symbol_duration
    avail_l, avail_t = start_lts, samples.shape[-1] - end
    lead = 2 * plen if avail_l >= 2 * plen else plen if avail_l >= plen else 0
    tail = 2 * plen if avail_t >= 2 * plen else plen if avail_t >= plen else 0
    span = samples[:, start_lts - lead:end + tail]
    llrs, _ = demod_mod.demodulate_span(
        config, mod, span, det["cfo_hz"], 0.0, n_lts=2, S=S, lead=lead,
        tail=tail, front=front, n_bits=ldpc_codes.BLOCK_LENGTH * n_codewords)
    return llrs, det


def demodulate_detected(config: ModemConfig, mod, samples: torch.Tensor,
                        det: dict, n_codewords: int = 1) -> torch.Tensor:
    """Cut every frame at its own detected first LTS (clipped into the
    buffer) by one index gather, and demodulate the spans with both LTS
    symbols as training, pilot tracking and the detected CFO
    (bench.py:333-338).  Returns the LLRs [B, nbits]."""
    plen = config.fft_size + config.cyclic_prefix
    S = ofdm_pipeline.num_data_symbols(config, mod, n_codewords)
    span_len = 2 * plen + S * config.symbol_duration
    T = samples.shape[-1]
    starts = torch.clamp(det["lts_start"].to(torch.int64), 0, T - span_len)
    idx = starts[:, None] + torch.arange(span_len, device=samples.device)
    span = samples.gather(1, idx)
    llrs, _ = demod_mod.demodulate_span(
        config, mod, span, det["cfo_hz"], 0.0, n_lts=2, S=S,
        n_bits=ldpc_codes.BLOCK_LENGTH * n_codewords)
    return llrs


def decode_cox_batch(config: ModemConfig, mod, rate: CodeRate,
                     samples: torch.Tensor, n_codewords: int = 1,
                     with_llrs: bool = False):
    """The acquisition-inclusive receiver step of the bench
    (bench.py:330-342) on [B, T] buffers that each hold one frame at an
    unknown position: ``detect_preamble`` -> ``demodulate_detected`` ->
    deinterleave -> LDPC decode.  Nothing is read to the host.

    Returns (info [B, ncw*k] uint8, ok [B] bool (decoded AND detected),
    iters [B, ncw] int32, det dict), and with ``with_llrs`` the
    demodulated LLRs [B, S*C*bits] before the deinterleave last."""
    with metrics.span("cox.rx", samples):
        det = detect_preamble(config, samples)
        llrs = demodulate_detected(config, mod, samples, det, n_codewords)
        pipe = ofdm_pipeline.pipeline_for(config, mod, rate, n_codewords,
                                          samples.device)
        info, ok, iters = pipe.decode(llrs)
        out = (info, ok & det["found"], iters, det)
        return (*out, llrs) if with_llrs else out

"""Batched decode-rate sweep harness: the regression_matrix workload on the
port (port of projectultra_tpu/parallel/sweep.py; reference
tests/regression_matrix.sh + tools/test_iwaveform.cpp).

Every point's frame batch runs TX -> harness CFO -> channel -> chirp or
Barker DETECTION on the full noisy buffer (no oracle positions) -> per-frame
slice at the detected position -> demodulation at the detected CFO -> LDPC
-> per-frame success, with the anti-cheating rules of
docs/TESTING_METHODOLOGY.md:252-292 (one continuous receiver path per
frame, reproducible seeds).

Each point is split in three:

* ``build_*``: info bits from the numpy seed, the codewords and the TX
  batch, as the JAX harness makes them, on one device;
* ``_apply_channel``: the harness channel, its normals drawn from a
  ``torch.Generator`` on that device (or from a numpy generator, which
  every device reproduces);
* ``receive_*``: the noisy batch -> ``SweepResult`` (``score`` of the
  per-frame ``Lanes`` that ``lanes_*`` gives).  JAX's PRNG cannot be
  reproduced in torch, so the tests feed it the noisy arrays JAX made.

The single-stream rows (``run_point_stream``) drive two ``ModemEngine``\\ s
on the given device.  Entry points take ``device=None``: the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import CodeRate, Modulation
from ..device import resolve
from ..fec import ldpc
from ..ofdm import pipeline as ofdm_pipeline
from ..ops import ldpc as ldpc_ops
from ..psk import dpsk as DP
from ..psk import mc_dpsk as MC
from ..sim import watterson as W
from ..sync import chirp as chirp_mod


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    waveform: str              # "MC_DPSK" | "OFDM_CHIRP" | "DPSK" | "OFDM_COX"
    snr_db: float
    cfo_hz: float = 0.0
    channel: str = "awgn"      # awgn|good|moderate|poor|flutter
    rate: CodeRate = CodeRate.R1_4
    frames: int = 5
    preset: str = ""           # DPSK preset name (psk/dpsk.py factories)


@dataclasses.dataclass
class SweepResult:
    point: SweepPoint
    decode_rate: float
    ber: float
    detected_rate: float
    cfo_err_hz: float


class Batch(NamedTuple):
    """One point's frames on one device: info bits [B, k] and codewords
    [B, n] (float32 0/1) and the TX [B, T]."""
    info: torch.Tensor
    cw: torch.Tensor
    tx: torch.Tensor


LEAD, TAIL = 4800, 4000   # zeros before and after every harness frame


def _normals(generator, shape: tuple, device: torch.device) -> torch.Tensor:
    """Standard normals of ``shape`` on ``device`` from a torch.Generator
    (on that device) or a numpy Generator (the same on every device)."""
    if isinstance(generator, np.random.Generator):
        return torch.from_numpy(
            generator.standard_normal(shape, dtype=np.float32)).to(device)
    return torch.randn(shape, generator=generator, device=device)


def _apply_channel(point: SweepPoint, tx: torch.Tensor,
                   generator) -> torch.Tensor:
    """Harness order (test_iwaveform.cpp:505-560): CFO first (Hilbert SSB),
    then AWGN (active samples) or a harness Watterson channel, whose fading
    normals are drawn before its noise (``W.watterson``'s order)."""
    B, T = tx.shape
    dev = tx.device
    if abs(point.cfo_hz) > 1e-3:
        tx = W.apply_cfo_hilbert(tx, point.cfo_hz)
    if point.channel == "awgn":
        return W.add_noise_with(tx, point.snr_db,
                                _normals(generator, (B, T), dev))
    # test_iwaveform.cpp:530-555 channel parameters, NOT the hf_channel.hpp
    # presets: the matrix thresholds were derived on the harness channels
    # (poor is echo-dominant 0.6/0.8 there).
    cfg = W.HARNESS_PRESETS[point.channel](point.snr_db)
    fade = (_normals(generator, (2, B, W._paths(cfg), T), dev)
            if cfg.fading_enabled else None)
    noise = _normals(generator, (B, T), dev) if cfg.noise_enabled else None
    return W.watterson_with(tx, cfg, fade, noise)


def _info(point: SweepPoint, seed: int, device: torch.device) -> torch.Tensor:
    """[frames, k] float32 info bits from the numpy seed (as JAX draws them)."""
    k = ldpc.get_code(point.rate).k
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, size=(point.frames, k)).astype(np.float32)
    return torch.from_numpy(info).to(device)


def _framed(pre: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """[LEAD zeros][pre][data][TAIL zeros] for every frame of ``data``."""
    B, dev = data.shape[0], data.device
    p = torch.from_numpy(np.asarray(pre, np.float32)).to(dev)
    return torch.cat([torch.zeros((B, LEAD), device=dev),
                      p.expand(B, p.shape[0]), data,
                      torch.zeros((B, TAIL), device=dev)], dim=-1)


class Lanes(NamedTuple):
    """One point's outcome per frame: found [B] and decoded [B] (found, the
    LDPC converged and the info bits exact), bit_errors [B] of the LLRs'
    hard decisions against the codeword, and the detected cfo_hz [B]."""
    found: torch.Tensor
    decoded: torch.Tensor
    bit_errors: torch.Tensor
    cfo_hz: torch.Tensor


def _lanes(code, llrs: torch.Tensor, batch: Batch, found: torch.Tensor,
           cfo_hz: torch.Tensor) -> Lanes:
    """LDPC-decode [B, n] LLRs and score every frame."""
    out, ok, _ = ldpc_ops.decode(code, llrs)
    decoded = ok & found & (out == batch.info.to(torch.uint8)).all(-1)
    errors = ((llrs < 0).to(torch.float32) != batch.cw).sum(-1)
    return Lanes(found, decoded, errors, cfo_hz)


def score(point: SweepPoint, lanes: Lanes) -> SweepResult:
    """The point's rates: decoded and found shares, the BER over every
    coded bit, and the CFO error averaged over the found frames (NaN if
    none).  Reads the lanes to the host."""
    found = lanes.found.cpu().numpy()
    cfo = lanes.cfo_hz.cpu().numpy()
    cfo_err = (float(np.abs(cfo - point.cfo_hz)[found].mean())
               if found.any() else float("nan"))
    n_bits = found.shape[0] * ldpc.get_code(point.rate).n
    return SweepResult(point, float(lanes.decoded.cpu().numpy().mean()),
                       int(lanes.bit_errors.sum()) / n_bits,
                       float(found.mean()), cfo_err)


# ---------------------------------------------------------------------------
# MC-DPSK behind a dual chirp
# ---------------------------------------------------------------------------

def build_mc_dpsk(point: SweepPoint, mc_cfg: MC.MCDPSKConfig | None = None,
                  seed: int = 42, device=None) -> Batch:
    cfg = mc_cfg or MC.MCDPSKConfig()
    info = _info(point, seed, resolve(device))
    cw = ldpc_ops.encode(ldpc.get_code(point.rate), info)
    return Batch(info, cw, _framed(MC.preamble(cfg), MC.modulate(cfg, cw)))


def lanes_mc_dpsk(point: SweepPoint, rx: torch.Tensor, batch: Batch,
                  mc_cfg: MC.MCDPSKConfig | None = None) -> Lanes:
    """Dual-chirp detection at ``cfg.chirp_threshold`` -> each frame cut at
    its detected training start -> MC-DPSK at the detected CFO -> LDPC."""
    cfg = mc_cfg or MC.MCDPSKConfig()
    code = ldpc.get_code(point.rate)
    det = chirp_mod.detect_dual_chirp(cfg.chirp_config(), rx,
                                      threshold=cfg.chirp_threshold)
    llrs = MC.demodulate_detected(cfg, rx, det,
                                  MC.num_symbols_for_bits(cfg, code.n))
    return _lanes(code, llrs[:, :code.n].contiguous(), batch,
                  det["success"], det["cfo_hz"])


def receive_mc_dpsk(point: SweepPoint, rx: torch.Tensor, batch: Batch,
                    mc_cfg: MC.MCDPSKConfig | None = None) -> SweepResult:
    return score(point, lanes_mc_dpsk(point, rx, batch, mc_cfg))


def run_point_mc_dpsk(point: SweepPoint,
                      mc_cfg: MC.MCDPSKConfig | None = None, seed: int = 42,
                      device=None) -> SweepResult:
    """MC-DPSK frame sweep with real chirp acquisition per frame."""
    batch = build_mc_dpsk(point, mc_cfg, seed, device)
    return receive_mc_dpsk(point, _noisy(point, batch, seed), batch, mc_cfg)


# ---------------------------------------------------------------------------
# OFDM_CHIRP
# ---------------------------------------------------------------------------

def _ofdm_pipeline(point: SweepPoint, device: torch.device):
    cfg = ofdm_pipeline.chirp_ofdm_config(rate=point.rate)
    return ofdm_pipeline.pipeline_for(cfg, Modulation.DQPSK, point.rate, 1,
                                      device)


def build_ofdm_chirp(point: SweepPoint, seed: int = 42, device=None) -> Batch:
    """[chirp][2 LTS][DQPSK data of the channel-interleaved codeword]."""
    info = _info(point, seed, resolve(device))
    pipe = _ofdm_pipeline(point, info.device)
    cw = ldpc_ops.encode_with(pipe.code, info)
    pre = chirp_mod.generate(chirp_mod.ChirpConfig())
    return Batch(info, cw, _framed(pre, pipe.tx(info)))


def lanes_ofdm_chirp(point: SweepPoint, rx: torch.Tensor,
                     batch: Batch) -> Lanes:
    """Dual-chirp detection (default ChirpConfig, threshold 0.15) -> each
    frame cut at its training start -> OFDM at the detected CFO and the
    accumulated phase there -> deinterleave -> LDPC."""
    cc = chirp_mod.ChirpConfig()
    pipe = _ofdm_pipeline(point, rx.device)
    det = chirp_mod.detect_dual_chirp(cc, rx, threshold=0.15)
    tr = chirp_mod.training_start(cc, det["down_chirp_start"])
    span = chirp_mod.frame_spans(rx, tr, ofdm_pipeline.frame_samples(
        pipe.config, Modulation.DQPSK))
    phase = chirp_mod.initial_cfo_phase(cc, det["cfo_hz"], tr)
    deint = pipe.deinterleaved_llrs(span, det["cfo_hz"], phase)
    return _lanes(ldpc.get_code(point.rate), deint, batch, det["success"],
                  det["cfo_hz"])


def receive_ofdm_chirp(point: SweepPoint, rx: torch.Tensor,
                       batch: Batch) -> SweepResult:
    return score(point, lanes_ofdm_chirp(point, rx, batch))


def run_point_ofdm_chirp(point: SweepPoint, seed: int = 42,
                         device=None) -> SweepResult:
    """OFDM_CHIRP frame sweep with real chirp acquisition per frame."""
    batch = build_ofdm_chirp(point, seed, device)
    return receive_ofdm_chirp(point, _noisy(point, batch, seed), batch)


# ---------------------------------------------------------------------------
# Single-carrier DPSK
# ---------------------------------------------------------------------------

def _dpsk_config(point: SweepPoint) -> DP.DPSKConfig:
    return getattr(DP, point.preset or "robust")()


def build_dpsk(point: SweepPoint, seed: int = 42, device=None) -> Batch:
    cfg = _dpsk_config(point)
    info = _info(point, seed, resolve(device))
    frame, cw = DP.tx_dpsk_frame(cfg, point.rate, info, LEAD, TAIL,
                                 with_codeword=True)
    return Batch(info, cw, frame)


def lanes_dpsk(point: SweepPoint, rx: torch.Tensor, batch: Batch) -> Lanes:
    """The Barker-13x3 preamble search -> each frame cut at its data start
    -> soft differential demodulation at the detected CFO and phase ->
    LDPC."""
    cfg = _dpsk_config(point)
    code = ldpc.get_code(point.rate)
    found, ds, cfo, ipo, prev = DP.find_preamble(cfg, rx)
    llrs = DP.demodulate_detected(cfg, point.rate, rx, ds, prev, cfo, ipo)
    return _lanes(code, llrs, batch, found, cfo)


def receive_dpsk(point: SweepPoint, rx: torch.Tensor,
                 batch: Batch) -> SweepResult:
    return score(point, lanes_dpsk(point, rx, batch))


def run_point_dpsk(point: SweepPoint, seed: int = 42,
                   device=None) -> SweepResult:
    """Single-carrier DPSK frame sweep with the real Barker-13x3 preamble
    search in the loop (BASELINE config #1; the reference has no
    regression_matrix.sh DPSK rows because its engine never wired the
    single-carrier RX path)."""
    batch = build_dpsk(point, seed, device)
    return receive_dpsk(point, _noisy(point, batch, seed), batch)


# ---------------------------------------------------------------------------
# Points and the matrix
# ---------------------------------------------------------------------------

def _noisy(point: SweepPoint, batch: Batch, seed: int) -> torch.Tensor:
    g = torch.Generator(device=batch.tx.device).manual_seed(seed)
    return _apply_channel(point, batch.tx, g)


BUILD = {"MC_DPSK": build_mc_dpsk, "OFDM_CHIRP": build_ofdm_chirp,
         "DPSK": build_dpsk}
RECEIVE = {"MC_DPSK": receive_mc_dpsk, "OFDM_CHIRP": receive_ofdm_chirp,
           "DPSK": receive_dpsk}
LANES = {"MC_DPSK": lanes_mc_dpsk, "OFDM_CHIRP": lanes_ofdm_chirp,
         "DPSK": lanes_dpsk}


def run_point(point: SweepPoint, seed: int = 42, device=None,
              **kw) -> SweepResult:
    if point.waveform == "MC_DPSK":
        return run_point_mc_dpsk(point, seed=seed, device=device, **kw)
    if point.waveform == "OFDM_CHIRP":
        return run_point_ofdm_chirp(point, seed=seed, device=device)
    if point.waveform == "DPSK":
        return run_point_dpsk(point, seed=seed, device=device)
    raise ValueError(f"unknown waveform {point.waveform}")


# Regression matrix rows (tests/regression_matrix.sh:134-238) with the
# reference's minimum pass rates.
REGRESSION_MATRIX = [
    (SweepPoint("MC_DPSK", 5.0, 0.0, "awgn"), 1.00),
    (SweepPoint("MC_DPSK", 5.0, 30.0, "awgn"), 1.00),
    (SweepPoint("MC_DPSK", 0.0, 30.0, "awgn"), 0.60),
    (SweepPoint("MC_DPSK", 5.0, 0.0, "moderate"), 0.60),
    (SweepPoint("MC_DPSK", 5.0, 30.0, "moderate"), 0.60),
    (SweepPoint("MC_DPSK", 15.0, 30.0, "poor"), 0.60),
    (SweepPoint("OFDM_CHIRP", 17.0, 0.0, "awgn"), 1.00),
    (SweepPoint("OFDM_CHIRP", 17.0, 30.0, "awgn"), 1.00),
    (SweepPoint("OFDM_CHIRP", 17.0, 50.0, "awgn"), 1.00),
    (SweepPoint("OFDM_CHIRP", 15.0, 0.0, "moderate"), 0.80),
    (SweepPoint("OFDM_CHIRP", 15.0, 30.0, "moderate"), 0.60),
    # Single-carrier DPSK (BASELINE config #1): the -11 dB floor preset and
    # the 125 bps (DQPSK 62.5 bd) preset (README.md:38,75 claims).
    (SweepPoint("DPSK", -11.0, 0.0, "awgn", preset="robust"), 1.00),
    (SweepPoint("DPSK", 0.0, 0.0, "awgn", preset="medium"), 1.00),
]

FULL_EXTRA = [
    # Reference --full tier, row-for-row (regression_matrix.sh:193-238).
    (SweepPoint("MC_DPSK", -3.0, 0.0, "awgn", frames=10), 0.80),
    (SweepPoint("MC_DPSK", 10.0, 50.0, "awgn", frames=10), 1.00),
    (SweepPoint("MC_DPSK", 10.0, 0.0, "poor", frames=10), 0.80),
    (SweepPoint("MC_DPSK", 10.0, 30.0, "poor", frames=10), 0.60),
    (SweepPoint("OFDM_CHIRP", 10.0, 30.0, "awgn", frames=10), 1.00),
    (SweepPoint("OFDM_CHIRP", 15.0, 30.0, "good", frames=10), 0.80),
    # Negative-CFO rows: the derotation SIGN paths (regression_matrix.sh:225-233).
    (SweepPoint("MC_DPSK", 5.0, -30.0, "awgn"), 1.00),
    (SweepPoint("OFDM_CHIRP", 17.0, -50.0, "awgn"), 1.00),
    (SweepPoint("OFDM_CHIRP", 15.0, 0.0, "poor", frames=10), 0.40),
    (SweepPoint("DPSK", -12.0, 0.0, "awgn", preset="robust", frames=10), 0.80),
    (SweepPoint("DPSK", -3.0, 0.0, "awgn", preset="medium", frames=10), 0.60),
]


def run_matrix(rows=None, seed: int = 42, frames: int | None = None,
               device=None):
    """Run regression rows; returns list of (SweepResult, min_rate, passed)."""
    rows = rows if rows is not None else REGRESSION_MATRIX
    out = []
    for point, min_rate in rows:
        if frames is not None:
            point = dataclasses.replace(point, frames=frames)
        res = run_point(point, seed=seed, device=device)
        out.append((res, min_rate, res.decode_rate >= min_rate))
    return out


# ---------------------------------------------------------------------------
# Single-stream discipline: N frames as ONE continuous stream through ONE
# receiver (test_iwaveform.cpp:340-600: one TX modem builds
# [silence][frame1][silence][frame2]... and a single receiver consumes it in
# 960-sample chunks with a 100 ms poll cadence).  This exercises the real
# product surface (ModemEngine acquisition/decode), including back-to-back
# frame interference that the batched harness cannot see.
# ---------------------------------------------------------------------------

def _stream_engine(point: SweepPoint, device: torch.device):
    """A connected ModemEngine in the point's waveform and rate, as the
    JAX harness sets up both of its engines."""
    from ..modem.engine import ModemEngine
    from ..protocol.frame_v2 import WaveformMode
    wf = WaveformMode[point.waveform]
    m = ModemEngine(device=device)
    m.set_waveform_mode(wf)
    m.connected = True
    m.handshake_complete = True
    m.data_code_rate = point.rate
    if wf == WaveformMode.OFDM_COX:
        # The reference harness runs cox DATA frames at DQPSK
        # (test_iwaveform.cpp:392 setDataMode(Modulation::DQPSK, rate)).
        m.data_modulation = Modulation.DQPSK
    if wf == WaveformMode.DPSK and point.preset:
        m.dpsk_config = getattr(DP, point.preset)()
    return m


def _payloads(point: SweepPoint) -> list[str]:
    return [f"stream frame {i:02d}" for i in range(point.frames)]


def stream_tx(point: SweepPoint, device=None) -> np.ndarray:
    """The clean stream: 4,800 zeros, then each v2 DATA frame followed by
    4,800 zeros, then 8,000 zeros (float32 audio)."""
    from ..protocol import frame_v2 as F
    tx = _stream_engine(point, resolve(device))
    pieces = [np.zeros(4800, np.float32)]
    for i, text in enumerate(_payloads(point)):
        frame = F.DataFrame.make_data("W1AW", "VE3ABC", i + 1, text)
        pieces += [tx.transmit(frame.serialize()), np.zeros(4800, np.float32)]
    return np.concatenate(pieces + [np.zeros(8000, np.float32)])


def receive_stream(point: SweepPoint, noisy: np.ndarray, device=None,
                   chunk: int = 960, polls_every: int = 5):
    """The noisy stream through one receiving ModemEngine, fed in
    ``chunk``-sample pieces with a poll every ``polls_every`` chunks (the
    reference's ~100 ms acquisition cadence), then polled until the Cox
    wait gives up.  Returns (SweepResult, the set of payloads delivered
    with every codeword ok)."""
    from ..protocol import frame_v2 as F
    rx = _stream_engine(point, resolve(device))
    got = []
    rx.on_frame = got.append
    rx.on_ping = lambda snr: None
    for n, i in enumerate(range(0, len(noisy), chunk)):
        rx.feed_audio(noisy[i:i + chunk])
        if n % polls_every == 0:
            rx.poll()
    for _ in range(rx.COX_MAX_IDLE_POLLS + 2):
        rx.poll()

    payloads = _payloads(point)
    decoded = set()
    cfo_errs = []
    for fr in got:
        df = F.DataFrame.deserialize(fr.frame_bytes)
        if df is not None and all(fr.cw_ok) and df.payload_as_text() in payloads:
            decoded.add(df.payload_as_text())
            cfo_errs.append(abs(fr.cfo_hz - point.cfo_hz))
    n = point.frames
    cfo_err = float(np.mean(cfo_errs)) if cfo_errs else float("nan")
    return (SweepResult(point, len(decoded) / n, float("nan"), len(got) / n,
                        cfo_err), decoded)


def run_point_stream(point: SweepPoint, seed: int = 42, chunk: int = 960,
                     polls_every: int = 5, device=None) -> SweepResult:
    """One continuous noisy stream of ``point.frames`` v2 DATA frames
    through one ModemEngine (``stream_tx`` -> ``_apply_channel`` ->
    ``receive_stream``)."""
    dev = resolve(device)
    stream = torch.from_numpy(stream_tx(point, dev)).to(dev)[None, :]
    g = torch.Generator(device=dev).manual_seed(seed)
    noisy = _apply_channel(point, stream, g)[0].cpu().numpy()
    return receive_stream(point, noisy, dev, chunk, polls_every)[0]


def run_matrix_stream(rows=None, seed: int = 42, frames: int | None = None,
                      chunk: int = 960, device=None):
    """Regression rows under single-stream discipline."""
    rows = rows if rows is not None else REGRESSION_MATRIX
    out = []
    for point, min_rate in rows:
        if frames is not None:
            point = dataclasses.replace(point, frames=frames)
        t0 = time.perf_counter()
        res = run_point_stream(point, seed=seed, chunk=chunk, device=device)
        ok = res.decode_rate >= min_rate
        print(f"  [stream] {point.waveform:<11} {point.channel:<9} "
              f"{point.snr_db:>5.1f} dB: {res.decode_rate:.0%} "
              f"(min {min_rate:.0%}) {'PASS' if ok else 'FAIL'} "
              f"[{time.perf_counter() - t0:.0f}s]", flush=True)
        out.append((res, min_rate, ok))
    return out

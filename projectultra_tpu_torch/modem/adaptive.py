"""Adaptive OFDM<->OTFS mode selection from preamble channel characterization.

Reference: include/ultra/adaptive_modem.hpp + src/ofdm/adaptive_modem.cpp.
Pipeline: preamble symbols -> per-symbol LS channel snapshots -> RMS delay
spread (IFFT of averaged H) + Doppler spread (snapshot variation) -> ITU-R
F.1487 classification -> mode:

  Flutter (fD >= 5 Hz)              -> OFDM
  Poor (tau >= 1.5 ms or fD >= 2)   -> OTFS_RAW
  Moderate                          -> OFDM
  Good (tau < 0.75 ms, fD < 0.3)    -> OTFS_EQ

The port's copy of the JAX package's module, pinned to it by
``tests/test_torch_adaptive.py``.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from ..config import Modulation, CodeRate
from ..otfs.otfs import OTFSConfig, sync_sequence, REAL_TO_COMPLEX_SCALE
from ..ops import mixer as mixer_ops


class ModulationMode(enum.IntEnum):
    OFDM = 0
    OTFS_EQ = 1
    OTFS_RAW = 2
    AUTO = 3


@dataclasses.dataclass
class PreambleChannelEstimate:
    """(adaptive_modem.hpp:35-84)"""
    delay_spread_ms: float = 0.0
    doppler_spread_hz: float = 0.0
    snr_db: float = 0.0
    coherence_time_ms: float = 0.0

    @property
    def is_good(self) -> bool:
        return self.delay_spread_ms < 0.75 and self.doppler_spread_hz < 0.3

    @property
    def is_moderate(self) -> bool:
        return (0.75 <= self.delay_spread_ms < 1.5
                and 0.3 <= self.doppler_spread_hz < 2.0)

    @property
    def is_poor(self) -> bool:
        return self.delay_spread_ms >= 1.5 or self.doppler_spread_hz >= 2.0

    @property
    def is_flutter(self) -> bool:
        return self.doppler_spread_hz >= 5.0

    @property
    def condition(self) -> str:
        if self.is_flutter:
            return "Flutter"
        if self.is_poor:
            return "Poor"
        if self.is_moderate:
            return "Moderate"
        if self.is_good:
            return "Good"
        return "Unknown"

    def recommended_mode(self) -> ModulationMode:
        """(adaptive_modem.hpp:60-74)"""
        if self.is_flutter:
            return ModulationMode.OFDM
        if self.is_poor:
            return ModulationMode.OTFS_RAW
        if self.is_moderate:
            return ModulationMode.OFDM
        return ModulationMode.OTFS_EQ


class ChannelCharacterizer:
    """Preamble-based characterizer (adaptive_modem.cpp:80-276), batched."""

    def __init__(self, cfg: OTFSConfig | None = None):
        self.cfg = cfg or OTFSConfig()

    def characterize(self, preamble: np.ndarray) -> PreambleChannelEstimate:
        """[T] or [1, T] preamble samples (>=2 sync symbols)."""
        cfg = self.cfg
        x = np.asarray(preamble, np.float32).reshape(-1)
        sym_len = cfg.sym_len
        n_sym = min(4, len(x) // sym_len)
        if n_sym < 2:
            return PreambleChannelEstimate()
        seq = sync_sequence(cfg)

        H = np.zeros((n_sym, cfg.M), np.complex64)
        sig_p = noise_p = 0.0
        count = 0
        for s in range(n_sym):
            seg = x[s * sym_len:(s + 1) * sym_len]
            osc = mixer_ops.osc_fixed(cfg.center_freq, cfg.sample_rate,
                                      sym_len, offset=s * sym_len)
            bb = seg * np.conj(osc)
            fd = np.fft.fft(bb[cfg.cp_length:cfg.cp_length + cfg.fft_size])
            rx = fd[1:cfg.M + 1] * REAL_TO_COMPLEX_SCALE
            H[s] = rx * np.conj(seq)   # |seq| = 1
            sig_p += float((np.abs(rx) ** 2).sum())
            count += cfg.M

        # SNR from snapshot variation (the reference's residual formula
        # degenerates to zero for unit-modulus sequences; use the temporal
        # noise estimate instead — same estimator the OFDM tracker uses).
        diffs = np.abs(np.diff(H, axis=0)) ** 2
        noise_p = float(diffs.mean()) / 2.0 if diffs.size else 0.0
        sig_mean = float((np.abs(H) ** 2).mean())
        snr_db = 10.0 * np.log10(max(sig_mean, 1e-12)
                                 / max(noise_p, 1e-12))
        snr_db = float(np.clip(snr_db, 0.0, 50.0))

        est = PreambleChannelEstimate(snr_db=snr_db)
        est.delay_spread_ms = self.estimate_delay_spread(H.mean(0))
        sym_ms = sym_len / cfg.sample_rate * 1000.0
        est.doppler_spread_hz = self.estimate_doppler(H, sym_ms)
        est.coherence_time_ms = (500.0 / est.doppler_spread_hz
                                 if est.doppler_spread_hz > 0.01 else 10000.0)
        return est

    def estimate_delay_spread(self, H_freq: np.ndarray) -> float:
        """RMS delay spread from IFFT of H(f) (adaptive_modem.cpp:183-227)."""
        cfg = self.cfg
        if len(H_freq) < 4:
            return 0.0
        Hp = np.zeros(cfg.fft_size, np.complex64)
        Hp[:min(len(H_freq), cfg.fft_size // 2)] = \
            H_freq[:cfg.fft_size // 2]
        h = np.fft.ifft(Hp)
        dt_ms = 1000.0 / cfg.sample_rate
        max_d = min(int(5.0 / dt_ms), len(h) // 2)
        p = np.abs(h[:max_d]) ** 2
        tot = p.sum()
        if tot < 1e-10:
            return 0.0
        d = np.arange(max_d) * dt_ms
        mean = (p * d).sum() / tot
        var = (p * d * d).sum() / tot - mean * mean
        return float(np.sqrt(max(0.0, var)))

    def estimate_doppler(self, H: np.ndarray, sym_ms: float) -> float:
        """Doppler from snapshot-to-snapshot variation
        (adaptive_modem.cpp:229-276): fD ~ rms(|dH|)/|H| / (2 pi T)."""
        if H.shape[0] < 2:
            return 0.0
        h1 = H[:-1]
        h2 = H[1:]
        mask = np.abs(h1) > 0.1
        if not mask.any():
            return 0.0
        var = (np.abs(h2 - h1) ** 2)[mask].sum()
        pwr = (np.abs(h1) ** 2)[mask].sum()
        if pwr < 1e-10:
            return 0.0
        rms = np.sqrt(var / pwr)
        fd = rms / (2.0 * np.pi * (sym_ms / 1000.0))
        return float(np.clip(fd, 0.0, 20.0))


def select_mode(preamble: np.ndarray,
                cfg: OTFSConfig | None = None) -> tuple[ModulationMode,
                                                        PreambleChannelEstimate]:
    """One-call adaptive mode selection (AdaptiveModem::selectMode)."""
    c = ChannelCharacterizer(cfg)
    est = c.characterize(preamble)
    return est.recommended_mode(), est


class AdaptiveModeController:
    """SNR-driven (modulation, rate) tracking with hysteresis
    (src/gui/adaptive_mode.cpp).  Thresholds are calibrated for the
    pilot-based SNR measurement (higher than channel SNR); 2 dB hysteresis
    plus a 3-frame stability requirement prevents mode flapping."""

    HYSTERESIS_DB = 2.0
    MIN_FRAMES_BEFORE_SWITCH = 3

    # (min pilot SNR dB, modulation, rate) — adaptive_mode.cpp:33-57.
    TABLE = [(38.0, Modulation.QAM64, CodeRate.R5_6),
             (34.0, Modulation.QAM64, CodeRate.R3_4),
             (30.0, Modulation.QAM16, CodeRate.R3_4),
             (26.0, Modulation.QAM16, CodeRate.R2_3),
             (24.0, Modulation.QPSK, CodeRate.R2_3),
             (22.0, Modulation.QPSK, CodeRate.R1_2),
             (18.0, Modulation.BPSK, CodeRate.R1_2)]

    def __init__(self):
        self.reset()

    def reset(self):
        self.current_mod = Modulation.QAM64
        self.current_rate = CodeRate.R3_4
        self.last_switch_snr = 0.0
        self.frames_at_current = 0

    @classmethod
    def recommend(cls, snr_db: float) -> tuple[Modulation, CodeRate]:
        for thresh, mod, rate in cls.TABLE:
            if snr_db > thresh:
                return mod, rate
        return Modulation.BPSK, CodeRate.R1_4

    def update(self, snr_db: float) -> bool:
        """Feed a per-frame SNR estimate; True when the mode switched."""
        rec_mod, rec_rate = self.recommend(snr_db)
        if rec_mod == self.current_mod and rec_rate == self.current_rate:
            self.frames_at_current += 1
            return False
        snr_change = abs(snr_db - self.last_switch_snr)
        if (snr_change < self.HYSTERESIS_DB
                and self.frames_at_current < self.MIN_FRAMES_BEFORE_SWITCH * 10):
            self.frames_at_current += 1
            return False
        if (snr_change >= self.HYSTERESIS_DB
                or self.frames_at_current >= self.MIN_FRAMES_BEFORE_SWITCH):
            self.current_mod, self.current_rate = rec_mod, rec_rate
            self.last_switch_snr = snr_db
            self.frames_at_current = 0
            return True
        self.frames_at_current += 1
        return False

    @property
    def mode_string(self) -> str:
        return f"{self.current_mod.name} {self.current_rate.name[1:].replace('_', '/')}"


class CalibratedAdaptiveController(AdaptiveModeController):
    """Round-3: the same hysteresis machinery driven by the engine's TRUE
    wideband SNR estimate, with the measured-envelope table (matching
    connection.recommend_data_mode_calibrated — thresholds from
    tools/calibrate_mode_table.py decode-rate sweeps, AWGN + moderate
    fading, ~2 dB margin).  The parent keeps the reference's pilot-scale
    table for parity."""

    # No R3/4 row: the reference H construction leaves info bits 325-485
    # parity-free at R3/4, and on LONG frames (file chunks — hundreds of
    # exposed bits) a single ICI-floor excursion flips one with the
    # syndrome still satisfied: measured 6-7/10 corrupted 400-byte QAM16
    # R3/4 frames at EVERY SNR incl. 80 dB (the 80-byte calibration
    # frames hid it).  cw_ok=True + frame-CRC fail -> the ARQ retransmits
    # the SAME payload into the SAME deterministic floor: a livelock, not
    # a loss rate.  QAM16 R2/3 (fully protected, 0/40 corruption on long
    # frames) is the non-flat ceiling; flat channels climb past it
    # through the gated high-order ladder instead.
    TABLE = [(20.0, Modulation.QAM16, CodeRate.R2_3),
             (17.0, Modulation.DQPSK, CodeRate.R2_3),
             (15.0, Modulation.DQPSK, CodeRate.R1_2),
             (11.0, Modulation.DQPSK, CodeRate.R1_4)]

    # Beyond-reference high-order ladder, reachable only with PROVEN-FLAT
    # fade evidence (sustained fade_spread_db < FLAT_SPREAD_DB; AWGN reads
    # ~0.2 dB, every Watterson preset >= 3.4): the measured fade envelopes
    # of these modes collapse at ALL SNRs (tools/calibrate_mode_table.py —
    # 0/6 decode to +36 dB moderate fading), so unlike the main table no
    # outage margin can make them fade-safe; they are flat-channel-only by
    # construction.  Thresholds = measured AWGN envelope (clean from
    # 22/28 dB, 20/20 random payloads) + ~2 dB margin.  R3/4 and R5/6
    # rows are deliberately absent on this profile: the reference's
    # seeded H construction saturates all check-edge slots early at high
    # rates, leaving info bits 325-485 (R3/4) / 217-539 (R5/6) with ZERO
    # parity connections — an unprotected bit mapped onto the 512-FFT
    # carrier plan's DC-adjacent ICI floor (~-25 dB EVM) flips with the
    # syndrome still satisfied, which no SNR fixes (measured: QAM64 R3/4
    # corrupts 4/20 random payloads identically at 26 and 30 dB; R5/6
    # flips the same single bit from 28-36 dB).  R2/3 and below are fully
    # protected (432 info x 3 edges exactly fills 216 checks x 6).
    # 256QAM R5/6 throughput belongs to the NVIS 1024 profile, whose
    # carriers clear the ICI floor.
    HIGH_TABLE = [(30.0, Modulation.QAM256, CodeRate.R2_3),
                  (24.0, Modulation.QAM64, CodeRate.R2_3)]
    FLAT_SPREAD_DB = 2.0
    FLAT_FRAMES = 3

    # Reading-stability fallback for flat evidence: short in-session data
    # frames (<1 s active audio) cannot measure fade spread at all, so a
    # busy high-SNR session would never open the high-order gate on spread
    # readings alone.  Per-frame TRUE wideband SNR readings are the
    # complementary signal — under every Watterson preset consecutive
    # 0.3-0.5 s frames decorrelate through the fade envelope and scatter
    # +-3 dB, while AWGN readings sit sub-dB — so a window of readings
    # whose span stays <= STABLE_SPAN_DB counts as flat evidence, and a
    # span >= SCATTER_SPAN_DB destroys it.  A slow (<0.2 Hz) fade can sit
    # still across the window; the downgrade debounce + ARQ bound that
    # exposure like any other channel turn.
    STABLE_WINDOW = 6
    STABLE_SPAN_DB = 1.5
    SCATTER_SPAN_DB = 3.0

    # Flat-gated ladder for the NVIS 1024-FFT no-pilot profile
    # (config.nvis_mode), whose DD-refinement RX (ofdm/demodulator.py
    # "256QAM ICI ladder") reaches ~-32 dB EVM where the 512 pilot
    # profile floors at ~-25.  Thresholds from random-payload streaming
    # engine loopbacks at BOTH 80-byte and 400-byte (file-chunk class)
    # frame sizes — long frames expose ~5x the parity-free info bits and
    # move the R5/6 envelopes up several dB (10/10 at each listed
    # threshold on 400-byte frames).  The R5/6 rows are safe here ONLY
    # because the protocol detects the reference H construction's
    # parity-free info bits: a flipped unprotected bit passes the LDPC
    # syndrome (cw_ok=True) but fails the frame CRC16, so the frame
    # drops and ARQ retransmits under fresh noise (noise-driven on this
    # profile, unlike the 512 plan's deterministic floor — retries make
    # progress).  QAM64 R3/4 is absent: dominated by QAM64 R5/6 (higher
    # rank, same 20 dB long-frame envelope).  QAM256 R5/6 keeps a
    # measured ~10% long-frame residual loss near 30 dB — included
    # because 8 x 5/6 x 0.9 = 6.0 still beats R2/3's 5.33 and the loss
    # is ARQ-recovered, never silent.  Fade rows collapse at all SNRs
    # (0/6 to +42 dB moderate), hence the same flat gate as HIGH_TABLE.
    NVIS_HIGH_TABLE = [(30.0, Modulation.QAM256, CodeRate.R5_6),
                       (26.0, Modulation.QAM256, CodeRate.R2_3),
                       (20.0, Modulation.QAM64, CodeRate.R5_6)]

    # EXACT ladder for the 512 pilot profile, gated on flat evidence AND
    # sustained low-CFO evidence: the engine's real-passband front is
    # bit-exact at |cfo| <= 2 Hz (docs/PERF.md "Real passband
    # front-end"), which clears the analytic ICI floor that kept R5/6
    # off this plan — measured 400-byte random-payload envelopes through
    # the full streaming engine: QAM64 R5/6 clean from 24 dB (20/20),
    # QAM256 R5/6 from 28 (20/20 at 30).  Above the front crossover the
    # analytic fallback re-exposes the parity-free bits, so these rows
    # demand LOWCFO_FRAMES consecutive detections at |cfo| <=
    # LOWCFO_MAX_HZ (margin under the 2 Hz crossover); drift past it
    # tears the gate down and the flat-gated R2/3 ladder resumes.
    EXACT_TABLE = [(30.0, Modulation.QAM256, CodeRate.R5_6),
                   (24.0, Modulation.QAM64, CodeRate.R5_6)]
    LOWCFO_MAX_HZ = 1.5
    LOWCFO_FRAMES = 3

    def __init__(self, high_table: list | None = None,
                 exact_table: list | None = None):
        """``high_table`` selects the flat-gated ladder (profile-aware:
        see ``high_order_table``); defaults to the engine 512-profile
        HIGH_TABLE.  ``exact_table`` adds the low-CFO exact ladder on
        top (see EXACT_TABLE; empty by default — ProtocolEngine enables
        it for pilot plans via ``exact_order_table``)."""
        self._high_table = self.HIGH_TABLE if high_table is None \
            else high_table
        self._exact_table = [] if exact_table is None else exact_table
        super().__init__()

    def reset(self):
        super().reset()
        self.current_mod = Modulation.DQPSK
        self.current_rate = CodeRate.R1_2
        self._ema_snr = None
        self._pending: tuple | None = None
        self._pending_count = 0
        self._flat_frames = 0
        self._recent_snr: list[float] = []
        self._ctrl_pending: tuple | None = None
        self._ctrl_pending_count = 0
        self._lowcfo_frames = 0

    @classmethod
    def recommend(cls, snr_db: float):
        for thresh, mod, rate in cls.TABLE:
            if snr_db > thresh:
                return mod, rate
        return Modulation.DBPSK, CodeRate.R1_4

    def _update_flat_evidence(self, snr_db: float, fade_spread_db: float):
        """Spread measurements rule when available; reading stability is
        the fallback for short frames (see STABLE_* above)."""
        if fade_spread_db is not None and fade_spread_db >= 0.0:
            self._flat_frames = (self._flat_frames + 1
                                 if fade_spread_db < self.FLAT_SPREAD_DB
                                 else 0)
            return
        self._recent_snr.append(float(snr_db))
        if len(self._recent_snr) > self.STABLE_WINDOW:
            self._recent_snr.pop(0)
        if len(self._recent_snr) >= self.STABLE_WINDOW:
            # TRIMMED span (drop the window's single high and low): one
            # outlier reading — e.g. an ACK frame whose noise window
            # landed in dead air reads several dB high — must not destroy
            # flat evidence that five consistent readings support, while
            # true fading scatters EVERY reading +-3 dB so its trimmed
            # span still clears SCATTER_SPAN_DB.
            s = sorted(self._recent_snr)
            span = s[-2] - s[1]
            if span <= self.STABLE_SPAN_DB:
                self._flat_frames += 1
            elif span >= self.SCATTER_SPAN_DB:
                self._flat_frames = 0
            else:
                # Ambiguous zone (1.5-3 dB trimmed span): DECAY rather
                # than freeze — developing mild fading can sit here for
                # the rest of a session, and a frozen open gate would
                # keep a collapsed high-order mode forever (failed
                # frames produce no readings to close it).  Decay gives
                # hysteresis: one ambiguous window dents confidence,
                # a sustained run closes the gate.
                self._flat_frames = max(0, self._flat_frames - 1)

    # Control-frame readings read up to ~6 dB HOT on the calibrated
    # scale (DBPSK constellation power + per-transmission PAPR
    # normalization — payload-dependent, so not correctable by a
    # constant); they are excluded from normal updates.  But in a
    # ONE-WAY session (file transfer: the sender receives only ACKs)
    # they are the only feedback, and with them fully ignored a fading
    # channel could never close an open high-order mode.  The reading
    # is therefore used UNCORRECTED as an UPPER bound: a biased-HIGH
    # reading that STILL recommends below the current mode is
    # unambiguous downgrade evidence.  (A haircut was tried and made
    # the path trigger-happy: the ladder rungs sit 4-6 dB apart, inside
    # the bias uncertainty, and healthy 34 dB transfers got walked down
    # two rungs by borderline ACK readings.)

    def observe_control(self, snr_db: float,
                        fade_spread_db: float = -1.0) -> bool:
        """Downgrade-only update from a control-frame reading.  Returns
        True when the downgrade debounce fires (mode switched)."""
        eff = snr_db
        if fade_spread_db is not None and fade_spread_db > 0.0:
            eff -= max(0.0, fade_spread_db - 1.0)
            if fade_spread_db >= self.FLAT_SPREAD_DB:
                self._flat_frames = 0   # hard fading evidence still counts
        # Gated recommendation: a session legitimately sitting in the
        # flat-gated high-order ladder must not be "downgraded" by every
        # healthy control reading just because the MAIN table tops out
        # at QAM16 — while flat evidence stands, judge against the same
        # ladder update() uses.  Fading evidence above closed the gate
        # already, so the main table takes over exactly when it should.
        rec = self._recommend_gated(eff)
        cur_rank = self._throughput_rank(self.current_mod, self.current_rate)
        if self._throughput_rank(*rec) >= cur_rank:
            self._ctrl_pending, self._ctrl_pending_count = None, 0
            return False                # never upgrade on a hot reading
        # OWN debounce state: sharing update()'s _pending would let a
        # single low control reading clobber a data-reading upgrade in
        # progress (observed: the NVIS climb stalled at QAM16 because an
        # ACK reading reset the 4-count QAM256 pending every few frames).
        if self._ctrl_pending == rec:
            self._ctrl_pending_count += 1
        else:
            self._ctrl_pending, self._ctrl_pending_count = rec, 1
        if self._ctrl_pending_count >= 2:   # downgrade debounce, as update()
            self.current_mod, self.current_rate = rec
            self.frames_at_current = 0
            self._ctrl_pending, self._ctrl_pending_count = None, 0
            self._pending, self._pending_count = None, 0
            return True
        return False

    def step_down(self) -> bool:
        """Drop to the next-lower ALWAYS-SAFE row (ARQ-stall evidence:
        the sender's frames are being retransmitted with no ACKs at all,
        so no reading will ever arrive to drive update()/
        observe_control — the retry pattern itself is the downgrade
        signal).  Candidates come from the MAIN table only: the stall
        means the channel degraded, which is exactly when the flat/
        low-CFO gates behind the high-order and exact ladders can no
        longer be trusted (stepping from QAM256 R2/3 into an EXACT R5/6
        row at unknown CFO would land on parity-free bits over the
        analytic front — worse than where we were).  Returns False when
        already at the bottom."""
        rows = {(m, r) for _, m, r in self.TABLE}
        rows.add((Modulation.DBPSK, CodeRate.R1_4))
        cur = self._throughput_rank(self.current_mod, self.current_rate)
        below = [(self._throughput_rank(m, r), m, r)
                 for m, r in rows if self._throughput_rank(m, r) < cur]
        if not below:
            return False
        _, m, r = max(below)
        self.current_mod, self.current_rate = m, r
        self.frames_at_current = 0
        self._pending, self._pending_count = None, 0
        self._ctrl_pending, self._ctrl_pending_count = None, 0
        return True

    def _recommend_gated(self, snr_db: float):
        """Exact ladder (flat + low-CFO evidence), then high-order ladder
        (flat evidence), then the main table."""
        if self._flat_frames >= self.FLAT_FRAMES:
            if self._exact_table and self._lowcfo_frames >= self.LOWCFO_FRAMES:
                for thresh, mod, rate in self._exact_table:
                    if snr_db > thresh:
                        return mod, rate
            for thresh, mod, rate in self._high_table:
                if snr_db > thresh:
                    return mod, rate
        return self.recommend(snr_db)

    @staticmethod
    def _throughput_rank(mod: Modulation, rate: CodeRate) -> float:
        from ..config import bits_per_symbol, code_rate_value
        return bits_per_symbol(mod) * code_rate_value(rate)

    def update(self, snr_db: float, fade_spread_db: float = -1.0,
               cfo_hz: float | None = None) -> bool:
        """Outage-SNR tracking with asymmetric debounce.

        On the TRUE wideband scale, per-frame readings under fading
        scatter +-3 dB (engine fade detector measurements) — enough to
        cross a table boundary every frame, and the parent's
        frames_at_current escape hatch then fires a MODE_CHANGE every ~3
        frames (observed at 16 dB moderate fading: R1/4<->R1/2<->R2/3
        thrash stalling the ARQ; each change is a transmit-then-apply
        round trip that a fade dip can desynchronize).  Three defenses:
        (1) the fade-spread penalty retargets the controller at the fade
        TROUGHS (spread - 1 dB: the 90/10 envelope spread minus the ~1 dB
        AWGN baseline), which is the level the decode envelope actually
        cares about; (2) an EMA removes single-frame scatter; (3) the
        switch itself is debounced — DOWNGRADES (safety) need 2
        consecutive recommendations, UPGRADES (throughput-optional) 4.
        Flat channels (spread ~0, stable readings) settle in <=4 frames
        and never thrash."""
        eff = snr_db
        if fade_spread_db is not None and fade_spread_db > 0.0:
            eff = snr_db - max(0.0, fade_spread_db - 1.0)
        self._update_flat_evidence(snr_db, fade_spread_db)
        if cfo_hz is not None:
            self._lowcfo_frames = (self._lowcfo_frames + 1
                                   if abs(cfo_hz) <= self.LOWCFO_MAX_HZ
                                   else 0)
        self._ema_snr = eff if self._ema_snr is None \
            else 0.7 * self._ema_snr + 0.3 * eff
        rec = self._recommend_gated(self._ema_snr)
        if rec == (self.current_mod, self.current_rate):
            self._pending, self._pending_count = None, 0
            self.frames_at_current += 1
            return False
        if self._pending == rec:
            self._pending_count += 1
        else:
            self._pending, self._pending_count = rec, 1
        going_up = self._throughput_rank(*rec) \
            > self._throughput_rank(self.current_mod, self.current_rate)
        if self._pending_count >= (4 if going_up else 2):
            self.current_mod, self.current_rate = rec
            self.last_switch_snr = self._ema_snr
            self.frames_at_current = 0
            self._pending, self._pending_count = None, 0
            return True
        return False


def high_order_table(config) -> list:
    """Profile-aware flat-gated ladder for CalibratedAdaptiveController.

    The NVIS 1024-FFT no-pilot profile decodes through the DD-refinement
    ladder (~-32 dB EVM) and its measured high-order envelopes sit
    6-12 dB below the 512 pilot profile's, with R3/4+R5/6 usable; any
    pilot-tracking profile keeps the conservative HIGH_TABLE (the 512
    plan's DC-adjacent ICI floor binds there, and 1024-with-pilots —
    config.high_throughput — is unmeasured, so it inherits the
    conservative ladder too)."""
    if config.fft_size >= 1024 and not config.use_pilots:
        return CalibratedAdaptiveController.NVIS_HIGH_TABLE
    return CalibratedAdaptiveController.HIGH_TABLE


def exact_order_table(config) -> list:
    """Low-CFO exact ladder (CalibratedAdaptiveController.EXACT_TABLE):
    the 512 pilot plan ONLY — its thresholds were measured there, the
    real-passband front that makes the rows bit-exact is an engine pick
    for pilot plans at small CFO, and the 1024-with-pilots
    high_throughput profile is unmeasured (it inherits the conservative
    ladders, same policy as high_order_table).  The NVIS no-pilot
    profile keeps its own R5/6 rows in NVIS_HIGH_TABLE."""
    if config.fft_size == 512 and len(_carrier_pilots(config)) > 0:
        return CalibratedAdaptiveController.EXACT_TABLE
    return []


def _carrier_pilots(config):
    from ..ofdm import carriers as carriers_mod
    return carriers_mod.carrier_map(config).pilot_idx

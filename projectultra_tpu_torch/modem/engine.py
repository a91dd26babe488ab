"""ModemEngine: host-side TX/RX orchestration around the device kernels.

Reference: src/gui/modem/{modem_engine.cpp, modem_rx.cpp, modem_rx_decode.cpp}.

The reference runs 3 POSIX threads (audio feed / acquisition / decode) around
one streaming buffer.  Here the host keeps the same roles without threads:
``feed_audio`` appends to the RX buffer and ``poll`` runs one acquisition +
decode pass (the CLI and tests drive it synchronously; a real-time deployment
would call ``poll`` from its audio callback cadence).  All hot math — chirp
matched filters, waveform demodulation, LDPC — runs as PyTorch operations
on the engine's device, with the Schmidl-Cox window sums and the LDPC
min-sum decode in the two hand-written CUDA kernels on a card.

The engine is single-threaded unless the caller locks: its lock guards
only the RX buffer's swap, while ``poll`` also updates state that
``feed_audio`` reads (the exciser hints of ``_excision_rx_hints``, among
others).  With ``feed_audio`` on one thread and ``poll`` on another and no
lock of the caller's, frames are lost -- the JAX package's engine loses
them the same way (``tools/threaded_simulator.py --cpu --direct-threads``
on the CPU).  A threaded caller holds one lock around every call into the
engine, as ``tools/torch_threaded_simulator.py`` does.

The port of the JAX package's engine: ``ModemEngine(device=...)`` holds
the device every device step of a poll runs on (the first CUDA device
when none is given; raises without one).  On a CUDA device the Cox
searches run the Schmidl-Cox window kernel and every frame decode the
LDPC kernel.  Host state machine, buffer bookkeeping and TX framing read
line for line like the original.

TX frame assembly parity (modem_engine.cpp:233-587):
  v2 frame -> per-CW LDPC (DATA at negotiated rate, else R1/4) ->
  per-CW channel interleave (OFDM waveforms only) -> waveform preamble +
  modulate -> 150 ms lead-in + 2x576 tail -> peak-normalize to 0.8.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config import ModemConfig, Modulation, CodeRate
from ..device import resolve
from ..fec import ldpc
from ..fec.interleave import channel_interleaver
from ..ofdm import carriers as carriers_mod
from ..ofdm import modulator as ofdm_mod
from ..ofdm import pipeline as ofdm_pipeline
from ..protocol import frame_v2 as F
from ..protocol.frame_v2 import WaveformMode
from ..psk import dpsk as DP
from ..psk import mc_dpsk as MC
from ..sync import chirp as chirp_mod
from ..utils.bits import bytes_to_bits

LEAD_IN_SAMPLES = 48000 * 150 // 1000
TAIL_SAMPLES = 576 * 2
PEAK_SCALE = 0.8

from .types import DecodedFrame  # re-export (protocol/engine, tests import here)
from .acquisition import ChirpPath, CoxPath, DpskPath, OtfsPath
from .acquisition.base import to_device, to_host
from .acquisition.chirp import PING_RMS_THRESHOLD, WEAK_CHIRP_THRESHOLD  # noqa: F401 (compat re-export)
from . import wideband_snr as _wideband

class ModemEngine:
    def __init__(self, config: ModemConfig | None = None,
                 mc_config: MC.MCDPSKConfig | None = None,
                 device: torch.device | None = None):
        self.device = resolve(device)
        self.config = config or ModemConfig()
        # ModemEngine uses the level-10 MC-DPSK preset: 13 carriers
        # (modem_engine.cpp:73).
        self.mc_config = mc_config or MC.level10()
        self.chirp_config = self.mc_config.chirp_config()
        # Single-carrier DPSK data mode: the medium preset (DQPSK 62.5 baud,
        # raw 125 bps) matches the reference's "DPSK connect mode"
        # (modem_mode.cpp:114-119); reconfigure via set_dpsk_mode /
        # set_dpsk_speed_level (setDPSKMode, modem_mode.cpp:294-315).
        self.dpsk_config = DP.medium()

        # Waveform/mode state (modem_engine.hpp:171-181).
        self.waveform_mode = WaveformMode.OFDM_COX
        self.connect_waveform = WaveformMode.MC_DPSK
        self.last_rx_waveform = WaveformMode.MC_DPSK
        self.disconnect_waveform = WaveformMode.MC_DPSK
        self.connected = False
        self.handshake_complete = False
        self.use_connected_waveform_once = False
        self.data_modulation = Modulation.QPSK
        self.data_code_rate = CodeRate.R1_2
        self.interleaving_enabled = True

        # RX state.  The lock guards _rx_buffer swaps between an audio
        # thread calling feed_audio and a decode thread calling poll
        # (INV-THREAD-001 / the reference's rx_buffer_mutex_); single-thread
        # callers pay one uncontended acquire.
        import threading
        self._rx_buffer = np.zeros(0, np.float32)
        self._rx_consumed = 0  # absolute sample index of buffer[0]
        self._buf_lock = threading.Lock()
        # Adaptive narrowband excision (beyond-reference, modem/excision.py):
        # persistent CW/het interferers are notched ahead of the buffer.
        # Clean streams never trigger it (quiet-gated, narrowness-gated,
        # persistence-gated), so golden/lane parity is unaffected.
        from .excision import ToneExciser
        self.exciser = ToneExciser()
        self._excision_pending_prev = False
        # Impulse blanker (beyond-reference, modem/blanker.py): short
        # broadband crashes >= ~10 dB over the local envelope are erased
        # ahead of the exciser and the buffer.  Quiet/clean streams pass
        # byte-identical (zero-floor guard), so parity is unaffected.
        from .blanker import ImpulseBlanker
        self.blanker = ImpulseBlanker()
        self.on_ping: Optional[Callable[[float], None]] = None
        self.on_frame: Optional[Callable[[DecodedFrame], None]] = None
        self.frames_received = 0
        self.pings_received = 0

        # Carrier sense (modem_carrier_sense.cpp:10-45): RMS EMA vs threshold
        # (modem_engine.hpp:330).
        self._channel_energy = 0.0
        self.carrier_sense_threshold = 0.02
        self._energy_smoothing = 0.3
        # Half-duplex turnaround (modem_carrier_sense.cpp:48-60): no TX for
        # turnaround_delay_ms after the last completed RX.
        self.turnaround_delay_ms = 0
        self._last_rx_complete_time = 0.0
        # Observability (getConstellationSymbols): opt-in, costs one extra
        # demod pass per decoded Cox frame.
        self.collect_constellation = False
        self.last_constellation: Optional[np.ndarray] = None
        # Previous data mode: RX fallback when a MODE_CHANGE crossed a frame
        # in flight (the frame was modulated at the mode before the switch).
        self.prev_data_modulation: Optional[Modulation] = None
        self.prev_data_code_rate: Optional[CodeRate] = None
        # Per-waveform acquisition paths (round-4 split): each owns its
        # cross-poll state (pending caches, wait trackers) behind the
        # shared contract in acquisition/base.py.
        self.chirp = ChirpPath(self)
        self.cox = CoxPath(self)
        self.dpsk = DpskPath(self)
        self.otfs = OtfsPath(self)
        # DEEP Cox acquisition (below the faithful ~14 dB plateau floor,
        # sync/schmidl_cox.py DEEP_* gates) — see CoxPath._deep_candidate.
        self.deep_acquisition = True
        # Per-path (consumed, buflen) of the last full acquisition search:
        # _search_due rate-limits searches to the reference's ~100 ms
        # new-audio cadence (modem_rx.cpp).
        self._acq_searched = {}

        from ..utils.metrics import ModemStats
        self.stats = ModemStats()

    # ------------------------------------------------------------------ TX

    # Speed-level presets for the single-carrier DPSK data mode (the GUI's
    # speed table; dpsk.hpp:1064-1169 preset family).
    DPSK_SPEED_PRESETS = {
        0: DP.robust,      # DBPSK 31.25 bd — the -11 dB floor
        1: DP.low_snr,     # DBPSK 62.5 bd
        2: DP.medium,      # DQPSK 62.5 bd (125 bps; default)
        3: DP.fast,        # DQPSK 125 bd
        4: DP.turbo,       # D8PSK 125 bd
        5: DP.high_speed,  # DQPSK 250 bd
        6: DP.speed1, 7: DP.speed2, 8: DP.speed3, 9: DP.speed4,
        10: DP.max_speed,  # D8PSK 750 bd
    }

    def set_dpsk_mode(self, modulation: DP.DPSKModulation,
                      samples_per_symbol: int):
        """setDPSKMode (modem_mode.cpp:294-315): reconfigure the
        single-carrier DPSK data mode."""
        self.dpsk_config = dataclasses.replace(
            self.dpsk_config, modulation=modulation,
            samples_per_symbol=samples_per_symbol)
        self.chirp.last_key = None  # preamble length feeds the tail trim

    def set_dpsk_speed_level(self, level: int):
        """Preset selection by speed level (GUI speed table semantics)."""
        self.dpsk_config = self.DPSK_SPEED_PRESETS[level]()
        self.chirp.last_key = None  # preamble length feeds the tail trim

    def set_waveform_mode(self, mode: WaveformMode):
        self.waveform_mode = mode
        self.chirp.last_key = None  # re-arm detection over the same buffer

    def reset_rx(self):
        """Clear ALL acquisition state and the RX buffer (public so
        consumers like RxPipeline never reach into engine internals).
        TX/connection/negotiated-mode state is deliberately untouched."""
        with self._buf_lock:
            self._rx_buffer = np.zeros(0, np.float32)
            self._rx_consumed = 0
        for path in (self.chirp, self.cox, self.dpsk, self.otfs):
            path.reset()
        self._acq_searched = {}

    # Read-only views of path state (kept for tests/tools that predate
    # the acquisition split — state now lives on the path objects).
    @property
    def _dpsk_pending(self):
        return self.dpsk.pending

    @property
    def _dpsk_wait(self):
        return self.dpsk.wait

    @property
    def _dpsk_searched_until(self):
        return self.dpsk.searched_until

    @property
    def _dpsk_clean_until(self):
        return self.dpsk.clean_until

    @property
    def _chirp_last_key(self):
        return self.chirp.last_key

    @property
    def _chirp_pending(self):
        return self.chirp.pending

    @property
    def _cox_wait(self):
        return self.cox.wait

    @property
    def _cox_pending(self):
        return self.cox.pending

    @property
    def _otfs_waiting(self):
        return self.otfs.waiting

    def _active_tx_waveform(self) -> WaveformMode:
        """4-way priority (modem_engine.cpp:372-397)."""
        if self.use_connected_waveform_once:
            return self.disconnect_waveform
        if not self.connected:
            return self.connect_waveform
        if not self.handshake_complete:
            return self.last_rx_waveform
        return self.waveform_mode

    def transmit(self, data: bytes) -> np.ndarray:
        """Frame bytes -> float32 audio (modem_engine.cpp:233-587)."""
        if not data:
            return np.zeros(0, np.float32)
        is_v2 = len(data) >= 2 and data[0] == 0x55 and data[1] == 0x4C
        is_data = is_v2 and len(data) >= 3 and self.connected and \
            0x30 <= data[2] <= 0x33

        active = self._active_tx_waveform()
        if self.use_connected_waveform_once:
            self.use_connected_waveform_once = False

        tx_mod = self.data_modulation if (self.connected or is_data) \
            else Modulation.DQPSK

        tx_rate = self.data_code_rate if is_data else CodeRate.R1_4
        if is_v2:
            cws = F.encode_frame_with_ldpc(data, tx_rate, device=self.device)
            to_modulate = self._maybe_interleave(cws, active, tx_mod)
        else:
            rate = self.data_code_rate if self.connected else CodeRate.R1_4
            code = ldpc.get_code(rate if rate in ldpc.CODE_PARAMS else CodeRate.R1_2)
            encoded = ldpc.encode_bytes_np(code, data)
            n = F.LDPC_CODEWORD_BYTES
            cws = [encoded[i:i + n] for i in range(0, len(encoded), n)]
            to_modulate = self._maybe_interleave(cws, active, tx_mod)

        preamble, modulated = self._modulate_waveform(active, to_modulate, tx_mod)

        out = np.concatenate([
            np.zeros(LEAD_IN_SAMPLES, np.float32), preamble, modulated,
            np.zeros(TAIL_SAMPLES, np.float32)])
        peak = np.abs(out).max()
        if peak > 0:
            out = out * (PEAK_SCALE / peak)
        self.stats.frames_sent += 1
        self.stats.bytes_sent += len(data)
        return out.astype(np.float32)

    def _maybe_interleave(self, cws: list[bytes], wf: WaveformMode,
                          tx_mod: Modulation | None = None) -> bytes:
        """Per-codeword channel interleave for OFDM waveforms only
        (modem_engine.cpp:292-310; DPSK never interleaves)."""
        use = self.interleaving_enabled and wf in (WaveformMode.OFDM_COX,
                                                   WaveformMode.OFDM_CHIRP)
        if not use:
            return b"".join(cws)
        bps = self._ofdm_bits_per_symbol(wf, tx_mod)
        ci = channel_interleaver(bps, F.LDPC_CODEWORD_BITS)
        return b"".join(ci.interleave(cw) for cw in cws)

    def _ofdm_bits_per_symbol(self, wf: WaveformMode | None = None,
                              tx_mod: Modulation | None = None) -> int:
        """Interleaver row width = data carriers x bits of the modulation
        the TX will ACTUALLY use: always DQPSK on the pilot-less chirp
        config (its modulator hardcodes it), the frame's tx_mod on Cox.
        (Round-1 ADVICE: inferring DQPSK from use_pilots alone would
        mis-size the interleaver for a pilot-less coherent Cox config.)"""
        from ..config import bits_per_symbol as bps_of
        wf = wf if wf is not None else self._active_tx_waveform()
        if wf == WaveformMode.OFDM_CHIRP:
            cfg, mod = self._chirp_ofdm_config(), Modulation.DQPSK
        else:
            cfg = self.config
            mod = tx_mod if tx_mod is not None else self.data_modulation
        cm = carriers_mod.carrier_map(cfg)
        return len(cm.data_idx) * bps_of(mod)

    def _chirp_ofdm_config(self) -> ModemConfig:
        cfg = self.config.replace(modulation=Modulation.DQPSK, use_pilots=False)
        return cfg

    def _otfs_config(self, wf: WaveformMode):
        from ..otfs.otfs import OTFSConfig
        return OTFSConfig(tf_equalization=(wf == WaveformMode.OTFS_EQ))

    def _otfs_mod(self, tx_mod: Modulation) -> Modulation:
        """OTFS carries coherent constellations only; the reference defaults
        to QPSK (modem_engine.cpp:48)."""
        if tx_mod in (Modulation.BPSK, Modulation.QPSK, Modulation.QAM16):
            return tx_mod
        return Modulation.QPSK

    OTFS_INTER_FRAME_GAP = 480  # samples (modem_engine.cpp:430)

    def _modulate_waveform(self, wf: WaveformMode, payload: bytes,
                           tx_mod: Modulation):
        if wf == WaveformMode.MFSK:
            # Factory maps MFSK -> MC-DPSK (waveform_factory.cpp:33-36).
            wf = WaveformMode.MC_DPSK
        if wf in (WaveformMode.OTFS_EQ, WaveformMode.OTFS_RAW):
            # One LDPC codeword per OTFS frame, 480-sample inter-frame gaps
            # (modem_engine.cpp:418-451).
            from ..otfs import otfs as O
            ocfg = self._otfs_config(wf)
            n = F.LDPC_CODEWORD_BYTES
            chunks = [payload[i:i + n].ljust(n, b"\0")
                      for i in range(0, len(payload), n)]
            cw_bits = np.stack([bytes_to_bits(c) for c in chunks]).astype(
                np.float32)
            frames = to_host(O.frame_tx(ocfg, self._otfs_mod(tx_mod),
                                        to_device(cw_bits, self.device)))
            gap = np.zeros(self.OTFS_INTER_FRAME_GAP, np.float32)
            pieces = []
            for i in range(len(chunks)):
                pieces.append(frames[i])
                if i + 1 < len(chunks):
                    pieces.append(gap)
            return np.zeros(0, np.float32), np.concatenate(pieces)
        bits = to_device(bytes_to_bits(payload)[None, :].astype(np.float32),
                         self.device)
        if wf == WaveformMode.DPSK:
            # Single-carrier DPSK frame: [Barker-13x3 preamble][data].
            # find_preamble estimates CFO/phase/reference from the Barker
            # symbols themselves, so no training/ref segment is sent (the
            # preamble ends at accumulated symbol phase 0 mod 2pi and
            # modulate() continues differentially from there).  DPSK modes
            # never channel-interleave (docs/INVARIANTS.md).
            cfg = self.dpsk_config
            pre = DP.generate_preamble(cfg)
            data = to_host(DP.modulate(cfg, bits))[0]
            return pre.astype(np.float32), data
        if wf == WaveformMode.MC_DPSK:
            pre = np.concatenate([
                chirp_mod.generate(self.chirp_config),
                MC.generate_training(self.mc_config),
                MC.generate_reference(self.mc_config)])
            data = to_host(MC.modulate(self.mc_config, bits))[0]
            return pre.astype(np.float32), data
        if wf == WaveformMode.OFDM_CHIRP:
            cfg = self._chirp_ofdm_config()
            pre = np.concatenate([
                chirp_mod.generate(self.chirp_config),
                ofdm_mod.generate_training(cfg, 2)])
            data = to_host(ofdm_mod.modulate(
                cfg, Modulation.DQPSK, bits,
                t_offset=2 * cfg.symbol_duration))[0]
            return pre.astype(np.float32), data
        # OFDM_COX (Schmidl-Cox)
        pre = ofdm_mod.generate_preamble(self.config)
        data = to_host(ofdm_mod.modulate(
            self.config, tx_mod, bits,
            t_offset=ofdm_mod.preamble_data_t_offset(self.config)))[0]
        return pre.astype(np.float32), data

    def transmit_ping(self) -> np.ndarray:
        """PING = bare chirp, peak-scaled (modem_engine.cpp:550-575)."""
        out = chirp_mod.generate(self.chirp_config).copy()
        peak = np.abs(out).max()
        if peak > 0:
            out = out * (PEAK_SCALE / peak)
        return out.astype(np.float32)

    # ------------------------------------------------------------------ RX

    def feed_audio(self, samples: np.ndarray):
        samples = np.asarray(samples, np.float32)
        # Exciser BEFORE blanker: a blank hole upstream of the notch IIRs
        # interrupts a steady tone mid-frame — the notch re-converges over
        # several ms after the hole and leaks tone onto the straddled
        # carriers (measured: 1/3 OFDM decodes with blanker-first vs 3/3
        # exciser-first under tone SIR 5 + a +15 dB mid-frame crash).
        # Downstream, the blanker's median also sees a tone-free floor.
        samples = self.exciser.process(samples)
        samples = self.blanker.process(samples)
        if len(samples):
            rms = float(np.sqrt((samples * samples).mean()))
            self._channel_energy = (self._energy_smoothing * rms
                                    + (1 - self._energy_smoothing)
                                    * self._channel_energy)
        with self._buf_lock:
            self._rx_buffer = np.concatenate([self._rx_buffer, samples])

    def is_channel_busy(self) -> bool:
        """Listen-before-talk carrier sense (modem_carrier_sense.cpp:26-33)."""
        return self._channel_energy > self.carrier_sense_threshold

    def is_turnaround_active(self) -> bool:
        """Half-duplex turnaround guard (modem_carrier_sense.cpp:48-60)."""
        if self.turnaround_delay_ms == 0:
            return False
        import time
        return (time.monotonic() - self._last_rx_complete_time) * 1000.0 \
            < self.turnaround_delay_ms

    @property
    def channel_energy(self) -> float:
        return self._channel_energy

    def poll(self) -> int:
        """Acquisition+decode passes over the buffered audio until no more
        progress is made (no event delivered AND no samples consumed — a
        failed decode consumes its chirp and the next pass must still run);
        returns the number of events (frames + pings) delivered."""
        events = 0
        while True:
            consumed_before = self._rx_consumed
            n = self._acquire_and_decode_once()
            events += n
            if n == 0 and self._rx_consumed == consumed_before:
                break
        self._excision_rx_hints()
        return events

    def _excision_rx_hints(self):
        """Feed the exciser the demodulator's frame-in-the-air knowledge
        (see ToneExciser.suppress_activation/frame_detected): spectral
        gates alone cannot always tell our own waveform from a het."""
        plen = self.config.fft_size + self.config.cyclic_prefix
        starts = []
        if self.dpsk.pending is not None:  # pending[0] is the DATA start
            starts.append(self.dpsk.pending[0]
                          - self.dpsk_config.preamble_samples)
        if self.cox.pending is not None:   # pending[0] is the LTS start
            starts.append(self.cox.pending[0] - 5 * plen)
        if self.chirp.pending is not None:  # pending[0] is the chirp head
            starts.append(self.chirp.pending[0])
        starts = [max(0, s) for s in starts]
        pend = bool(starts) or self.otfs.waiting
        if pend:
            self.exciser.suppress_activation(1.5)
            if not self._excision_pending_prev and starts:
                self.exciser.frame_detected(min(starts))
        self._excision_pending_prev = pend

    def _acquire_and_decode_once(self) -> int:
        # When the negotiated waveform is OFDM_COX/OTFS/DPSK, incoming
        # frames carry that waveform's preamble instead of a chirp — try
        # its sync first (modem_rx.cpp runs the active waveform's
        # acquisition alongside the chirp detector).  Chirp PINGs still
        # fall through: a chirp's LTS matched-filter / repeated-symbol
        # metrics are below the gates.  A "wait" (preamble found but frame
        # incomplete) must NOT short-circuit the chirp path: a false
        # preamble near the buffer end would otherwise block PING
        # detection forever.
        waveform_waiting = False
        if self.waveform_mode == WaveformMode.OFDM_COX:
            handled = self.cox.try_once()
            if isinstance(handled, int):
                return handled
            waveform_waiting = handled == "wait"
        if self.waveform_mode in (WaveformMode.OTFS_EQ, WaveformMode.OTFS_RAW):
            handled = self.otfs.try_once()
            if isinstance(handled, int):
                return handled
            waveform_waiting = handled == "wait"
        if self.waveform_mode == WaveformMode.DPSK:
            handled = self.dpsk.try_once()
            if isinstance(handled, int):
                return handled
            waveform_waiting = handled == "wait"
        return self.chirp.acquire_once(waveform_waiting)

    def _deliver(self, frame: DecodedFrame) -> int:
        """Event delivery bookkeeping shared by every path: frame counter,
        half-duplex turnaround timestamp, user callback."""
        self.frames_received += 1
        import time as _t
        self._last_rx_complete_time = _t.monotonic()
        if self.on_frame:
            self.on_frame(frame)
        return 1

    def _consume(self, n: int):
        with self._buf_lock:
            n = max(0, min(n, len(self._rx_buffer)))
            self._rx_buffer = self._rx_buffer[n:]
            self._rx_consumed += n

    ACQ_SEARCH_CADENCE = 4800  # re-search only after 100 ms of new audio
    # Coherent Cox front-end crossover: REAL passband (exact, no Hilbert)
    # at/below this detected |CFO|, analytic (CFO-robust, ~-25 dB mask
    # floor) above it.  Measured: real front holds protected rates clean
    # through 5 Hz; 2 Hz keeps wide margin while covering the detector's
    # typical sub-Hz corrections.
    REAL_FRONT_CFO_MAX_HZ = 2.0
    # Cap every full-buffer search VIEW: a backlogged buffer (slow consumer,
    # batch feeds) must slide through bounded-shape searches instead of
    # compiling one detector per 65536-sample bucket of an unbounded
    # buffer.  The no-detect trim is capped to the searched span so a
    # frame beyond the view is never trimmed unsearched.
    ACQ_VIEW_CAP = 4 * (1 << 16)  # 262144

    def _search_due(self, path) -> bool:
        """Rate-limit full-buffer acquisition searches to the reference's
        ~100 ms poll cadence (modem_rx.cpp): re-run only when the buffer
        was consumed from (positions shifted) or >= ACQ_SEARCH_CADENCE new
        samples arrived since the last search on this path.  Keyed per
        path so the Cox/OTFS/chirp searches pace independently."""
        key = (self._rx_consumed, len(self._rx_buffer))
        last = self._acq_searched.get(path)
        if last is not None and last[0] == key[0] \
                and key[1] - last[1] < self.ACQ_SEARCH_CADENCE:
            return False
        self._acq_searched[path] = key
        return True

    def _wideband_snr_db(self, buf: np.ndarray, start: int, end: int,
                         noise_before: int | None = None,
                         segments: list[tuple[int, int]] | None = None
                         ) -> float:
        """TRUE wideband SNR for a frame occupying buf[start:end) — see
        modem/wideband_snr.py (round-4 extraction).  Stores the companion
        fade-spread estimate in stats as a side effect."""
        snr, spread = _wideband.wideband_snr_db(buf, start, end,
                                                noise_before, segments)
        self.stats.fade_spread_db = spread
        return snr

    # Streaming-resilience limits (demodulator_constants.hpp:36-38 spirit):
    # a frame that makes no progress for 10 polls with no new audio is
    # abandoned.  The reference's blanket 250-symbol cap would kill
    # LEGITIMATE long frames here (its comment sizes 250 for ~1KB at 43
    # data carriers; the default config has 15, so a connected ~440-byte
    # R1/2 frame already exceeds it) — the cap is instead derived from the
    # protocol's real bound (MAX_PAYLOAD_V2 at the most symbol-hungry
    # mode), see _cox_max_symbols.
    COX_MAX_IDLE_POLLS = 10

    # Bound the per-call preamble search to ~256k candidate offsets and
    # bucket the buffer length as the JAX engine does (its jit caches
    # motivated the buckets; here the searched length sets the FFT sizes
    # and the DPSK search span, so the port pads the same way).
    DPSK_MAX_SEARCH_OFFSETS = 1 << 18
    STREAM_BUCKET = 1 << 16

    def _bucketed(self, buf: np.ndarray) -> np.ndarray:
        """Zero-pad a streaming buffer up to a STREAM_BUCKET multiple, as the
        JAX engine does (one shape per bucket instead of one per 960-sample
        chunk).  Zeros carry no energy, so they can neither create
        detections nor shift real ones; all returned positions index the
        real prefix."""
        T = -(-len(buf) // self.STREAM_BUCKET) * self.STREAM_BUCKET
        padded = np.zeros(T, np.float32)
        padded[:len(buf)] = buf
        return padded

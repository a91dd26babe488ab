"""Modem/link statistics, the stage timer, program spans and the device
trace helper.

Reference: include/ultra/types.hpp:248-260 (ModemStats).  The port's copies
of the JAX package's ``ModemStats``, ``BatchMetrics`` and ``stage_timer``
(pinned field for field and by behaviour by ``tests/test_torch_host.py``);
its device trace uses ``torch.profiler``.

``span(name, on)`` marks a stage of the receive chains where the stage's
function does its work (``noise.awgn``, ``ofdm.rx``, ``ofdm.demodulate``,
``ofdm.scan``, ``ofdm.refined``, ``ldpc.decode``, ``mcdpsk.tx``,
``mcdpsk.rx``, ``chirp.detect``, ``chirp.decimate``, ``mcdpsk.demodulate``,
``cox.tx``, ``cox.rx``, ``cox.detect``, ``dpsk.tx``, ``dpsk.rx``,
``dpsk.find``, ``dpsk.demodulate``).  Outside ``tracing()`` a span
does nothing but test one module flag: no CUDA event, no profiler range,
no record.  Inside it a span records its name, its parent, the batch id,
its host interval and, for work on a card, a CUDA event at each end (on
the current stream; nothing synchronises), and opens a
``torch.profiler.record_function`` range, so a profile puts each device
operation's launch inside the innermost stage the host was in.  Spans
nest by a stack of one thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

from ..config import Modulation, CodeRate


@dataclasses.dataclass
class ModemStats:
    """(types.hpp:248-260)"""
    bytes_sent: int = 0
    bytes_received: int = 0
    frames_sent: int = 0
    frames_received: int = 0
    frames_retransmitted: int = 0
    frames_failed: int = 0
    throughput_bps: float = 0.0
    current_snr_db: float = 0.0
    # TRUE wideband SNR (frame power vs min-statistics noise floor), the
    # calibrated_snr negotiation input; current_snr_db keeps the
    # reference's inflated per-carrier/training scale.
    wideband_snr_db: float = 0.0
    # Fade-spread companion to wideband_snr_db (90/10 dB spread of the
    # smoothed in-frame envelope; -1.0 = unmeasured).
    fade_spread_db: float = -1.0
    # Frames whose parity-free info bits were repaired by CRC syndrome
    # search (fec/crc_recover.py).
    frames_crc_recovered: int = 0
    # Frames rescued by re-demodulating with the OTHER front end
    # (real <-> analytic) after a failed decode.
    frames_front_retried: int = 0
    # Frames rescued by the sample-clock-skew resample retry
    # (modem/acquisition/cox.py).
    frames_sro_retried: int = 0
    # Frames improved by the delay-domain channel-model retry
    # (ofdm/delay_fit.py).
    frames_delayfit_retried: int = 0
    current_modulation: Modulation = Modulation.QPSK
    current_code_rate: CodeRate = CodeRate.R1_2


@dataclasses.dataclass
class BatchMetrics:
    """Per-batch device pipeline metrics (the rebuild's replacement for the
    per-decode callbacks)."""
    frames: int = 0
    decoded: int = 0
    bit_errors: int = 0
    total_bits: int = 0
    ldpc_iterations_mean: float = 0.0
    snr_estimate_db: float = 0.0
    cfo_error_hz: float = 0.0
    pipelines_per_sec: float = 0.0

    @property
    def fer(self) -> float:
        return 1.0 - self.decoded / self.frames if self.frames else 0.0

    @property
    def ber(self) -> float:
        return self.bit_errors / self.total_bits if self.total_bits else 0.0


@contextlib.contextmanager
def stage_timer(name: str, results: dict | None = None):
    """Per-stage wall-clock timer (profile_acquisition.cpp equivalent): adds
    the seconds spent in the block to ``results[name]``.  Host clock only;
    a caller timing device work synchronises inside the block."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if results is not None:
        results[name] = results.get(name, 0.0) + dt


@dataclasses.dataclass
class Span:
    """One finished span.  ``parent`` is the ``id`` of the span it ran
    inside (None at the top); ``start``/``end`` are CUDA events where the
    stage's tensor lived on a card, else None."""
    name: str
    id: int
    parent: int | None
    batch: int
    host_start_ns: int
    host_end_ns: int = 0
    start: object = None
    end: object = None

    def host_ms(self) -> float:
        """Host milliseconds from the span's start to its end: for a chain
        that never synchronises, the time to enqueue its work."""
        return (self.host_end_ns - self.host_start_ns) / 1e6

    def device_ms(self) -> float | None:
        """Device milliseconds between the span's CUDA events (once the
        device has passed the end event); None off the card."""
        return None if self.start is None else self.start.elapsed_time(
            self.end)


class Recorder:
    """The spans of one ``tracing()`` extent, kept in memory until
    ``drain``."""

    def __init__(self):
        self.batch = 0
        self._ids = 0
        self._stack: list[Span] = []
        self._done: list[Span] = []

    def next_batch(self) -> int:
        """Starts a batch: the spans opened from now on carry its id."""
        self.batch += 1
        return self.batch

    def drain(self) -> list[Span]:
        """The finished spans in the order they opened; clears them."""
        done, self._done = sorted(self._done, key=lambda s: s.id), []
        return done

    @contextlib.contextmanager
    def span(self, name: str, on):
        import torch
        parent = self._stack[-1].id if self._stack else None
        rec = Span(name, self._ids, parent, self.batch,
                   time.perf_counter_ns())
        self._ids += 1
        self._stack.append(rec)
        stream = torch.cuda.current_stream(on.device) \
            if on is not None and on.is_cuda else None
        try:
            with torch.profiler.record_function(name):
                rec.start = _event(stream)
                try:
                    yield rec
                finally:
                    rec.end = _event(stream)
        finally:
            rec.host_end_ns = time.perf_counter_ns()
            self._stack.pop()
            self._done.append(rec)


def _event(stream):
    """A timing CUDA event recorded on ``stream``; None without one."""
    if stream is None:
        return None
    import torch
    event = torch.cuda.Event(enable_timing=True)
    event.record(stream)
    return event


#: The recorder of the ``tracing()`` extent the program is in, or None.
_recorder: Recorder | None = None
_OFF = contextlib.nullcontext()


def span(name: str, on=None):
    """The stage ``name`` of the program, around the work of its function;
    ``on`` is a tensor the stage works on (CUDA events where it lives on a
    card).  Records only inside ``tracing()``."""
    if _recorder is None:
        return _OFF
    return _recorder.span(name, on)


@contextlib.contextmanager
def tracing():
    """Turns spans on for its extent and yields their ``Recorder``; inside
    another ``tracing()`` it yields that one's."""
    global _recorder
    if _recorder is not None:
        yield _recorder
        return
    _recorder = Recorder()
    try:
        yield _recorder
    finally:
        _recorder = None


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` trace of the CPU and, where there is one, the
    CUDA device, written to ``logdir`` as a Chrome trace, with the
    program's spans on: each stage a range of the host's timeline and its
    device operations launched inside it."""
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with tracing(), profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

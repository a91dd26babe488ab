"""The program's spans beside the harness: they leave what the harness
reads as it was, and ``benchmark/stages.py`` reads them stage by stage."""

import contextlib
import types

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import harness, stages
from projectultra_tpu_torch.utils import metrics

from bench_cases import ACQUIRED, PRESYNCED, tiny_cell

#: Each path's program spans, and the parent of each.
TREES = {
    "presynced": {"noise.awgn": None, "ofdm.rx": None,
                  "ofdm.demodulate": "ofdm.rx", "ldpc.decode": "ofdm.rx"},
    "acquired": {"mcdpsk.tx": None, "noise.awgn": None, "mcdpsk.rx": None,
                 "chirp.detect": "mcdpsk.rx",
                 "chirp.decimate": "chirp.detect",
                 "mcdpsk.demodulate": "mcdpsk.rx",
                 "ldpc.decode": "mcdpsk.rx"},
}
HARNESS_SPANS = {"inputs", "tx", "channel", "rx", "tally"}


class _Event:
    def __init__(self, name, kind, a, b, corr=0):
        self._name, self._kind, self._a, self._b = name, kind, a, b
        self._corr = corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def correlation_id(self):
        return self._corr

    def device_type(self):
        on_device = self._kind in ("kernel", "gpu_memcpy",
                                   "gpu_user_annotation")
        return DeviceType.CUDA if on_device else DeviceType.CPU

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")


def _profile(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


# A step of the acquired path: the harness's spans, the program's inside
# "rx" (decimation inside detection), launches in each, and the device's
# operations with their mirrored ranges.
HARNESS_EVENTS = [
    _Event("tx", "user_annotation", 0, 100),
    _Event("rx", "user_annotation", 100, 400),
    _Event("tally", "user_annotation", 400, 450),
    _Event("cudaLaunchKernel", "cuda_runtime", 50, 55, corr=1),
    _Event("cudaLaunchKernel", "cuda_runtime", 125, 128, corr=2),
    _Event("cudaLaunchKernel", "cuda_runtime", 150, 155, corr=3),
    _Event("cudaLaunchKernel", "cuda_runtime", 190, 195, corr=4),
    _Event("cudaLaunchKernel", "cuda_runtime", 250, 255, corr=5),
    _Event("cudaMemcpyAsync", "cuda_runtime", 390, 395, corr=6),
    _Event("cudaLaunchKernel", "cuda_runtime", 410, 415, corr=7),
    _Event("rx", "gpu_user_annotation", 130, 600),
    _Event("tx_kernel", "kernel", 60, 90, corr=1),
    _Event("pad_kernel", "kernel", 130, 140, corr=2),
    _Event("conv_kernel", "kernel", 160, 300, corr=3),
    _Event("fft_kernel", "kernel", 300, 320, corr=4),
    _Event("ldpc_kernel", "kernel", 320, 400, corr=5),
    _Event("Memcpy DtoH", "gpu_memcpy", 400, 410, corr=6),
    _Event("sum_kernel", "kernel", 420, 430, corr=7),
]
PROGRAM_EVENTS = [
    _Event("mcdpsk.rx", "user_annotation", 110, 390),
    _Event("chirp.detect", "user_annotation", 120, 200),
    _Event("chirp.decimate", "user_annotation", 140, 180),
    _Event("ldpc.decode", "user_annotation", 240, 260),
    _Event("chirp.detect", "gpu_user_annotation", 130, 320),
    _Event("mcdpsk.tx", "user_annotation", 10, 90),
]


def test_program_spans_leave_the_harness_readings():
    """With the program's ranges in the profile, ``trace_events`` gives the
    harness's own spans, device events and launching spans as without
    them, so ``device_ops.acquired`` and ``breakdown`` read as before."""
    without = harness.trace_events(_profile(HARNESS_EVENTS), HARNESS_SPANS)
    with_spans = harness.trace_events(
        _profile(HARNESS_EVENTS + PROGRAM_EVENTS), HARNESS_SPANS)
    assert with_spans == without
    assert without[2] == ["tx", "rx", "rx", "rx", "rx", "rx", "tally"]


def test_launches_by_innermost_program_span():
    launched = stages.launched_in(
        _profile(HARNESS_EVENTS + PROGRAM_EVENTS),
        set(TREES["acquired"]))
    assert launched == ["mcdpsk.tx", "chirp.detect", "chirp.decimate",
                        "chirp.detect", "ldpc.decode", None, None]
    assert stages.per_step(launched, 1) == {
        "chirp.decimate": 1.0, "chirp.detect": 2.0, "ldpc.decode": 1.0,
        "mcdpsk.tx": 1.0}


def test_nesting_and_innermost():
    ranges = [("a", 0, 100), ("b", 10, 20), ("c", 30, 60), ("d", 40, 50),
              ("e", 200, 300)]
    parent = stages.nesting(ranges)
    assert parent == [-1, 0, 0, 2, -1]
    starts = [r[1] for r in ranges]
    got = [stages.innermost(ranges, parent, starts, t)
           for t in (-1, 5, 15, 25, 45, 55, 70, 150, 250, 300)]
    assert got == [None, "a", "b", "a", "d", "c", "a", None, "e", None]


@pytest.mark.parametrize("name", [PRESYNCED[0], ACQUIRED[0]])
def test_program_spans_in_the_harness_profile(name):
    """A CPU profile of a harness step holds the harness's spans alike with
    the program's spans off and on."""
    cell = tiny_cell(name)
    device = torch.device("cpu")
    entry = cell.entry.Entry(cell.config, cell.traffic, device)
    from benchmark import traffic as T
    info, noise = T.inputs(cell.traffic, entry.k, entry.T, 2**33 + 3, 0,
                           device)
    seen = {}
    for on in (False, True):
        marks = harness.Marks(device)
        with (metrics.tracing() if on else contextlib.nullcontext()), \
                torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            marks.begin()
            with entry.precision():
                out = entry.step(info, noise, marks)
            marks("tally")
            entry.tally(out, info)
            marks.end()
        _, host, _ = harness.trace_events(prof, marks.names)
        seen[on] = [h[0] for h in host]
        program = stages.launched_in(prof, set(TREES[entry.path]))
        assert program == []            # no device operations on the CPU
    assert seen[False] == seen[True] == ["inputs", "tx", "channel", "rx",
                                         "tally"]


@pytest.mark.parametrize("name", [PRESYNCED[0], ACQUIRED[0]])
def test_stages_on_the_cpu(name):
    """``stages.measure`` at a tiny batch reads every span of the path on
    the host clock, each child within its parent, the program's receive
    stages within the harness's "rx"; the CPU launches nothing."""
    cell = tiny_cell(name)
    r = stages.measure(cell, 2**31 + 41, torch.device("cpu"), blocks=2,
                       block_steps=2, profile_steps=1)
    tree = TREES[cell.entry.PATH]
    ms = r["span_device_ms"]
    assert set(ms) == set(r["span_host_ms"]) == set(tree)
    assert r["steps_off"] == r["steps_on"] == 2
    assert r["step_ms_off"] > 0 and r["step_ms_on"] > 0
    for span, parent in tree.items():
        assert ms[span] > 0
        if parent is not None:
            assert ms[span] <= ms[parent]
    children = sum(ms[s] for s, p in tree.items()
                   if p in ("ofdm.rx", "mcdpsk.rx"))
    top = "ofdm.rx" if cell.entry.PATH == "presynced" else "mcdpsk.rx"
    assert children <= ms[top] <= r["harness_ms"]["on"]["rx"]
    assert set(r["harness_ms"]["on"]) == HARNESS_SPANS
    assert r["span_ops"] == {} and r["harness_ops"] == {}

"""The benchmark's harness: one cell, one seed, one run.

Everything a cell needs is found by name from ``BENCHMARK.json``:

* the cell (``workloads``) names a configuration and a traffic mix;
* ``benchmark/configs/<config>.json`` holds the configuration and names
  its entry kind, ``benchmark/entries/<entry>.py``;
* ``benchmark/traffic/<traffic>.json`` holds the mix (``traffic.py``);
* ``benchmark/limits/<cell>.json`` holds the limit of each number
  ``correct`` compares, with the readings it was set from;
* each per-layer metric is read by ``benchmark/metrics/<metric>.py``.

A run: set-up (the program's import, the card, the kernel libraries, the
cell's warm-up steps), the measured window (steps back to back for
``seconds``; the last step started finishes; a compared step's outputs
go to the host on a stopped clock), then, with the window closed and the
peak memory read, the reference on the compared steps.
With ``trace`` the steps record CUDA events at the span boundaries and
``torch.profiler`` covers a steady part of the window; the line then
carries the per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import bisect
import dataclasses
import gc
import importlib
import importlib.util
import json
import re
import statistics
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

from . import compare, traffic as traffic_mod, yardstick

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "projectultra_tpu")
#: The outputs of a profiled step that the per-layer readers get.
TRACED_OUTPUTS = ("iters",)
#: The names of the host's CUDA runtime and driver calls in a profile
#: (cudaLaunchKernel, cuLaunchKernelEx, cudaMemcpyAsync, ...): those that
#: put work on the device carry its correlation id.
LAUNCH_CALL = re.compile(r"cu(da)?[A-Z]")
#: Where in the window the profiler runs (``Profiling``): from this share
#: of the seconds, each stretch as many steps as the window ran in
#: PROFILE_SECONDS so far, at least PROFILE_MIN_STEPS.
PROFILE_FROM, PROFILE_SECONDS, PROFILE_MIN_STEPS = 0.3, 1.0, 10


# ---------------------------------------------------------------------------
# The cell, from its names
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: traffic_mod.Traffic
    limits: dict
    entry: object           # the entry kind's module
    end_to_end: list        # BENCHMARK.json's metrics this cell reports
    per_layer: list


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, its files read from
    ``root/benchmark``; an entry kind is code of this package."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    data = root / "benchmark"
    config = json.loads((data / "configs" / f"{w['config']}.json")
                        .read_text())
    mix = traffic_mod.Traffic.load(data / "traffic" / f"{w['traffic']}.json")
    limits = {k: float(v["limit"]) for k, v in json.loads(
        (data / "limits" / f"{name}.json").read_text())["numbers"].items()}
    entry = importlib.import_module(f"benchmark.entries.{config['entry']}")
    per_layer = [dict(m, reader=data / "metrics" / f"{m['name']}.py")
                 for m in bench["per_layer"] if reports(m, name)]
    return Cell(name, w["chips"], config, mix, limits, entry,
                [m for m in bench["end_to_end"] if reports(m, name)],
                per_layer)


def reader(path: Path):
    """``read(trace)`` of a per-layer metric's reader file."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

class Marks:
    """Span boundaries of the traced loop: at each mark a CUDA event (the
    host clock on the CPU) and a profiler range named after the span the
    host enters.  Nothing synchronises."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.steps: list[list] = []
        self.names: set[str] = set()
        self._range = None

    def _stamp(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def __call__(self, name: str) -> None:
        self.names.add(name)
        self.steps[-1].append((name, self._stamp()))
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self._range = torch.profiler.record_function(name)
        self._range.__enter__()

    def begin(self) -> None:
        self.steps.append([])
        self("inputs")

    def end(self) -> None:
        self.steps[-1].append(("end", self._stamp()))
        self._range.__exit__(None, None, None)
        self._range = None

    def span_ms(self, until: int | None = None) -> dict[str, list[float]]:
        """Each span's milliseconds in each step before step ``until``
        (after a synchronise)."""
        out: dict[str, list[float]] = {}
        for marks in self.steps[:until]:
            for (name, a), (_, b) in zip(marks, marks[1:]):
                ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
                out.setdefault(name, []).append(ms)
        return out


def no_mark(_name: str) -> None:
    pass


# ---------------------------------------------------------------------------
# The trace's readings
# ---------------------------------------------------------------------------

class Profiling:
    """The traced window's two profiled stretches, back to back from
    PROFILE_FROM of the window: first the device alone (CUDA activity: what
    the device ran, its busy union, the LDPC kernel's time), then the host
    beside it (CPU and CUDA activity: the span the host was in at each
    idle gap).  Recording the host's operators slows its enqueue, so the
    device's readings come from the stretch without it; each stretch runs
    as many steps as the window ran in PROFILE_SECONDS so far.  The
    profiler's first start costs seconds (CUPTI's) and every launch stays
    slower after it, so the spans are read from the steps before it."""

    STAGES = ("device", "host")

    def __init__(self, device: torch.device, seconds: float,
                 not_before: int):
        self.device = device
        self.p_from = PROFILE_FROM * seconds
        # Not on a compared step: its copy to the host is no device work.
        self.not_before = not_before
        self.stage, self.prof, self.n = 0, None, 0
        self.steps = {name: [] for name in self.STAGES}
        self.done: dict = {}

    def activities(self, stage: str):
        from torch.profiler import ProfilerActivity
        cuda = [ProfilerActivity.CUDA] if self.device.type == "cuda" else []
        if stage == "device" and cuda:
            return cuda
        return [ProfilerActivity.CPU] + cuda

    def profiler(self, stage: str):
        from torch.profiler import profile
        return profile(activities=self.activities(stage))

    def before(self, i: int, elapsed: float) -> None:
        """At step ``i``'s start, ``elapsed`` seconds into the window."""
        if self.prof is not None or self.stage == len(self.STAGES) \
                or i < max(1, self.not_before) or elapsed < self.p_from:
            return
        self.n = max(PROFILE_MIN_STEPS, round(i / elapsed * PROFILE_SECONDS))
        self.prof = self.profiler(self.STAGES[self.stage])
        self.prof.__enter__()

    def after(self, i: int) -> bool:
        """At step ``i``'s end; True when the step was profiled."""
        if self.prof is None:
            return False
        steps = self.steps[self.STAGES[self.stage]]
        steps.append(i)
        if len(steps) == self.n:
            self.close()
        return True

    def close(self) -> None:
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.done[self.STAGES[self.stage]] = self.prof
            self.prof = None
            self.stage += 1

    def finished(self) -> bool:
        return self.stage == len(self.STAGES)

    def first(self) -> int | None:
        """The first profiled step."""
        return self.steps["device"][0] if self.steps["device"] else None


@dataclasses.dataclass
class Trace:
    """What a traced run hands the per-layer metrics' readers."""
    path: str                     # the entry kind's path
    span_ms: dict                 # span -> its ms in each step before
    #                               the profiler's first start
    profiled_steps: int           # steps of the device stretch
    window_ns: int                # the device stretch, trace clock
    busy_ns: int                  # union of device intervals in it
    device_events: list           # (name, start ns, end ns), device stretch
    outputs: list                 # TRACED_OUTPUTS of its steps, on the host
    code: dict                    # the entry's LDPC code: lanes, n, edges
    host_steps: int               # steps of the host stretch
    host_spans: list              # (span, start ns, end ns), host stretch
    host_events: list             # device events of the host stretch
    launched_in: list             # the span that launched each of them


def trace_events(prof, spans):
    """(device events, host spans, the span that launched each device
    event) of a profile.  Device events are the device's operations; the
    profiler's copies of host ranges on the device's timeline
    ("gpu_user_annotation") are no device work.  Host spans are the
    harness's own ranges (names in ``spans``) on the host.  A device event
    was launched in the host span that holds the host call carrying its
    correlation id; None where the profile has no host calls."""
    device, host, calls = [], [], {}
    if prof is None:
        return device, host, []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.name(), a, b, e.correlation_id()))
        elif e.is_user_annotation():
            if e.name() in spans:
                host.append((e.name(), a, b))
        elif LAUNCH_CALL.match(e.name()):
            calls[e.correlation_id()] = a
    host.sort(key=lambda s: s[1])
    starts = [s[1] for s in host]

    def span_at(t):
        j = bisect.bisect_right(starts, t) - 1
        return host[j][0] if j >= 0 and t < host[j][2] else None

    launched = [span_at(calls[c]) if c in calls else None
                for *_, c in device]
    return [ev[:3] for ev in device], host, launched


def read_profiles(p: Profiling, outputs: dict, code: dict, path: str,
                  span_ms: dict, spans) -> Trace:
    device, device_host, _ = trace_events(p.done.get("device"), spans)
    host_events, host, launched = trace_events(p.done.get("host"), spans)
    # Without a card (the tests) the device stretch records host spans
    # only: its window is theirs.
    ends = [(a, b) for _, a, b in device] or [(a, b) for _, a, b in
                                              device_host]
    lo = min((a for a, _ in ends), default=0)
    hi = max((b for _, b in ends), default=0)
    busy = yardstick.busy_ns([(a, b) for _, a, b in device], lo, hi)
    return Trace(path, span_ms, len(p.steps["device"]), hi - lo, busy,
                 device, [outputs[i] for i in p.steps["device"]], code,
                 len(p.steps["host"]), host, host_events, launched)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the span the host was in when it began."""
    by_name: dict[str, int] = {}
    for name, a, b in trace.device_events:
        by_name[name] = by_name.get(name, 0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    if trace.host_spans:
        lo, hi = trace.host_spans[0][1], trace.host_spans[-1][2]
        gaps = yardstick.idle_gaps([(a, b) for _, a, b in trace.host_events],
                                   lo, hi)

    def host_at(t: int) -> str:
        for name, a, b in trace.host_spans:
            if a <= t < b:
                return name
        return "between steps"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
            "idle_gaps": [[host_at(a), (b - a) / 1e9] for a, b in longest]}


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Window:
    latencies: list               # seconds of each step
    seconds: float                # first step's start to last step's end,
    #                               less the copies of the compared steps
    totals: list                  # [ok frames, bit errors] over the steps
    kept: dict                    # step -> its outputs on the host
    marks: Marks | None
    profiling: Profiling | None
    outputs: dict                 # profiled step -> its TRACED_OUTPUTS


def to_host(out):
    """A step's outputs (tensors, dicts of them) copied to the host."""
    if isinstance(out, dict):
        return {k: to_host(v) for k, v in out.items()}
    return out.cpu()


def run_window(entry, mix, seed: int, seconds: float, device,
               profiling: Profiling | None, keep: set[int]) -> Window:
    """The steps back to back.  A compared step's outputs go to the host
    between steps, on a stopped clock: held on the card they would raise
    its memory peak and make the next steps allocate anew."""
    trace = profiling is not None
    marks = Marks(device) if trace else None
    mark = marks if trace else no_mark
    g = torch.Generator(device=device)
    outputs = {}
    lat, totals, kept = [], [0, 0], {}
    start = time.perf_counter()
    i, paused = 0, 0.0
    while True:
        t0 = time.perf_counter()
        if trace:
            profiling.before(i, t0 - start - paused)
            marks.begin()
        info, noise = traffic_mod.inputs(mix, entry.k, entry.T, seed, i,
                                         device, generator=g)
        out = entry.step(info, noise, mark)
        mark("tally")
        host = entry.tally(out, info).tolist()
        if trace:
            marks.end()
            if profiling.after(i):
                # Read after the window, so profiled steps do no more work.
                outputs[i] = {k: out[k] for k in TRACED_OUTPUTS}
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        totals[0] += host[0]
        totals[1] += host[1]
        # A traced window runs on until both stretches are profiled: the
        # profiler's first start alone can take longer than the window.
        more = t1 - start - paused < seconds \
            or (trace and not profiling.finished())
        if i in keep or not (more or kept):
            kept[i] = to_host(out)
            paused += time.perf_counter() - t1
        # Nothing of this step is held while the next one runs.
        del info, noise, out
        i += 1
        if not more:
            break
    if trace:
        profiling.close()
    return Window(lat, t1 - start - paused, totals, kept, marks, profiling,
                  outputs)


def per_second(latencies, batch: int) -> list[float]:
    """Frames a second in each whole second of the steps' summed time."""
    rates, t, n = [], 0.0, 0
    for lat in latencies:
        t, n = t + lat, n + 1
        if t >= 1.0:
            rates.append(round(n * batch / t))
            t, n = 0.0, 0
    return rates


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_process: float, log=print,
        control: bool = False) -> dict:
    """One run of ``cell``; returns the result line's object.  ``t_process``
    is the perf_counter reading at the process's start.  ``control`` runs
    the control of ``correct`` instead of the program as configured
    (``benchmark/calibrate.py``; never a benchmark run)."""
    mix = cell.traffic
    t_setup = [time.perf_counter()]
    entry = cell.entry.Entry(cell.config, mix, device)
    entry.control = control
    with entry.precision():
        for w in range(mix.warmup_steps):
            info, noise = traffic_mod.inputs(mix, entry.k, entry.T, seed, w,
                                             device,
                                             stream=traffic_mod.WARMUP)
            entry.tally(entry.step(info, noise, no_mark), info).cpu()
            del info, noise
            t_setup.append(time.perf_counter())
        keep = traffic_mod.compared_steps(mix, seed)
        profiling = Profiling(device, seconds, max(keep) + 1) \
            if trace else None
        if device.type == "cuda":
            torch.cuda.synchronize()
        # Everything set-up made stays: the collector no longer walks it,
        # so a full collection in the window is short.
        gc.freeze()
        launches0 = entry.counters()
        setup_s = time.perf_counter() - t_process
        log(f"set-up: {t_setup[0] - t_process!r} s to the cell (imports, "
            f"the card), warm-up steps "
            f"{[b - a for a, b in zip(t_setup, t_setup[1:])]!r} s")
        win = run_window(entry, mix, seed, seconds, device, profiling, keep)
        if device.type == "cuda":
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else 0
        launches = {k: v - launches0[k] for k, v in entry.counters().items()}
    steps = len(win.latencies)
    frames = steps * mix.batch
    log(f"window: {steps} steps of {mix.batch} frames in {win.seconds!r} s; "
        f"ok frames {win.totals[0]} of {frames}, bit errors {win.totals[1]}; "
        f"kernel launches {launches}")

    metrics = {}
    if trace:
        trace_obj = traced_readings(entry, win)
        log(f"trace: {trace_obj.profiled_steps} profiled steps, "
            f"{len(trace_obj.device_events)} device operations, "
            f"{len(trace_obj.host_spans)} host spans, device window "
            f"{trace_obj.window_ns / 1e9!r} s, busy "
            f"{trace_obj.busy_ns / 1e9!r} s")
        for m in cell.per_layer:
            value = reader(m["reader"])(trace_obj)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {f"{entry.path}_frames_per_s": frames / win.seconds,
               f"{entry.path}_batch_ms_p95":
                   yardstick.percentile(win.latencies, 95) * 1e3,
               "setup_s": setup_s}
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
        log(f"batch ms: median {statistics.median(win.latencies) * 1e3!r}, "
            f"p95 {e2e[f'{entry.path}_batch_ms_p95']!r}, "
            f"max {max(win.latencies) * 1e3!r}; setup_s {setup_s!r}")
        log(f"frames/s in each second of the window's steps: "
            f"{per_second(win.latencies, mix.batch)!r}")

    # The window is closed and the peak read: free the program's state
    # but the compared outputs, then run the reference.
    kept = win.kept
    win.kept, win.profiling, win.outputs = {}, None, {}
    numbers, lanes = check(entry, mix, seed, kept, device)
    log(f"compared {lanes} lanes of steps {sorted(kept)}")
    correct = compare.verdict(numbers, cell.limits, lanes)
    result = {"correct": correct, "attempted": frames, "failed": 0,
              "metrics": metrics,
              "device": device_block(device, peak)}
    if trace:
        result["breakdown"] = breakdown(trace_obj)
        result["device"]["busy_s"] = trace_obj.busy_ns / 1e9
        result["device"]["window_s"] = trace_obj.window_ns / 1e9
    result["checks"] = {k: {"value": numbers.get(k),
                            "limit": cell.limits.get(k)}
                        for k in dict.fromkeys([*numbers, *cell.limits])}
    return result


def traced_readings(entry, win: Window) -> Trace:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    p = win.profiling
    outputs = {i: {k: v.cpu() for k, v in o.items()}
               for i, o in win.outputs.items()}
    code = {"lanes": entry.traffic.batch, "n": entry.n, "edges": entry.edges}
    return read_profiles(p, outputs, code, entry.path,
                         win.marks.span_ms(until=p.first()), win.marks.names)


def on_device(out, rows: slice, device):
    """Rows of a step's outputs held on the host, on ``device``."""
    if isinstance(out, dict):
        return {k: on_device(v, rows, device) for k, v in out.items()}
    return out[rows].to(device)


def check(entry, mix, seed: int, kept: dict, device) -> tuple[dict, int]:
    """The reference on every compared step, in blocks of rows."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = entry.reference()
    tally = compare.Tally()
    for i in sorted(kept):
        for r0 in range(0, mix.batch, mix.reference_rows):
            rows = slice(r0, min(mix.batch, r0 + mix.reference_rows))
            info, noise = traffic_mod.inputs(mix, entry.k, entry.T, seed, i,
                                             device, rows=rows)
            tally.merge(entry.compare(ref, info, noise,
                                      on_device(kept[i], rows, device)))
        kept[i] = None
    return tally.numbers(), tally.lanes


def device_block(device: torch.device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}

#!/usr/bin/env python3
"""Where a cell's batch spends its time, stage by stage: the program's own
spans (``projectultra_tpu_torch/utils/metrics.span``) in the cell's steps.

    python3 benchmark/stages.py --workload <cell> --seed <n> \\
        [--blocks 6] [--block-steps 10] [--profile-steps 10]

Builds the cell as ``harness.run`` does (the entry, its precision, its
warm-up steps) and runs the steps of ``harness.run_window`` with the
harness's spans marked in every step:

* ``--blocks`` blocks of ``--block-steps`` steps, alternately with the
  program's spans off and on (``metrics.tracing``): each span's mean
  device ms a batch (its CUDA events; the host clock on the CPU, as
  ``harness.Marks``) and host ms a batch (its enqueue), the harness's
  spans beside them, and the mean step ms off and on (the spans' cost);
* then ``--profile-steps`` steps under ``torch.profiler`` (CPU and CUDA),
  spans on: the device operations a batch whose launching call (by its
  correlation id) lies innermost in each program span, and in each
  harness span.  The profiler's first start slows every later launch, so
  it runs last.

Prints one JSON object on standard output.  Nothing here decides
``correct``; the benchmark's own runs are ``benchmark/run.py``'s.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from benchmark import harness, traffic as traffic_mod  # noqa: E402
from projectultra_tpu_torch.utils import metrics  # noqa: E402


def span_ms(spans) -> tuple[dict, dict]:
    """(device ms, host ms) of each span name in one batch's drained
    spans, summed over its spans of that name; device ms are the host's
    off the card."""
    device, host = {}, {}
    for s in spans:
        ms = s.device_ms()
        device[s.name] = device.get(s.name, 0.0) + (
            s.host_ms() if ms is None else ms)
        host[s.name] = host.get(s.name, 0.0) + s.host_ms()
    return device, host


def nesting(ranges) -> list[int]:
    """The index of the range each of ``ranges`` (name, start, end),
    sorted by start and nested, lies directly inside; -1 at the top."""
    parent, open_ = [], []
    for i, (_, a, _b) in enumerate(ranges):
        while open_ and ranges[open_[-1]][2] <= a:
            open_.pop()
        parent.append(open_[-1] if open_ else -1)
        open_.append(i)
    return parent


def innermost(ranges, parent, starts, t: int):
    """The name of the innermost of the nested ``ranges`` holding ``t``,
    or None."""
    j = bisect.bisect_right(starts, t) - 1
    while j >= 0 and not t < ranges[j][2]:
        j = parent[j]
    return ranges[j][0] if j >= 0 else None


def launched_in(prof, names) -> list:
    """For each device operation of a profile (the profiler's copies of
    host ranges left out), the innermost host range named in ``names``
    that holds the host call carrying its correlation id; None where no
    such range or call was recorded."""
    ranges, calls, device = [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append(e.correlation_id())
        elif e.is_user_annotation():
            if e.name() in names:
                a = e.start_ns()
                ranges.append((e.name(), a, a + e.duration_ns()))
        elif harness.LAUNCH_CALL.match(e.name()):
            calls[e.correlation_id()] = e.start_ns()
    ranges.sort(key=lambda r: r[1])
    parent = nesting(ranges)
    starts = [r[1] for r in ranges]
    return [innermost(ranges, parent, starts, calls[c]) if c in calls
            else None for c in device]


def per_step(values: list, steps: int) -> dict:
    """How many of ``values`` name each span, a step (None left out)."""
    counts = collections.Counter(v for v in values if v is not None)
    return {name: n / steps for name, n in sorted(counts.items())}


def means(rows: list[dict]) -> dict:
    """Each key's mean over ``rows``, 0 where a row lacks it."""
    names = sorted({k for r in rows for k in r})
    return {k: statistics.fmean(r.get(k, 0.0) for r in rows) for k in names}


def measure(cell: harness.Cell, seed: int, device: torch.device,
            blocks: int = 6, block_steps: int = 10,
            profile_steps: int = 10) -> dict:
    mix = cell.traffic
    entry = cell.entry.Entry(cell.config, mix, device)
    g = torch.Generator(device=device)
    cuda = device.type == "cuda"
    i = 0

    def step(mark):
        nonlocal i
        info, noise = traffic_mod.inputs(mix, entry.k, entry.T, seed, i,
                                         device, generator=g)
        i += 1
        out = entry.step(info, noise, mark)
        mark("tally")
        entry.tally(out, info).tolist()

    with entry.precision():
        for w in range(mix.warmup_steps):
            info, noise = traffic_mod.inputs(mix, entry.k, entry.T, seed, w,
                                             device,
                                             stream=traffic_mod.WARMUP)
            entry.tally(entry.step(info, noise, harness.no_mark),
                        info).cpu()
        with metrics.tracing():
            step(harness.no_mark)
        if cuda:
            torch.cuda.synchronize()

        # Spans off, then on, in alternate blocks.
        marks = {on: harness.Marks(device) for on in (False, True)}
        step_s = {False: [], True: []}
        drained = []
        for b in range(blocks):
            on = b % 2 == 1
            with (metrics.tracing() if on
                  else contextlib.nullcontext()) as rec:
                for _ in range(block_steps):
                    if on:
                        rec.next_batch()
                    t0 = time.perf_counter()
                    marks[on].begin()
                    step(marks[on])
                    marks[on].end()
                    step_s[on].append(time.perf_counter() - t0)
                    if on:
                        drained.append(rec.drain())
        if cuda:
            torch.cuda.synchronize()
        program = [span_ms(spans) for spans in drained]
        harness_ms = {("on" if on else "off"):
                      {k: statistics.fmean(v)
                       for k, v in m.span_ms().items()}
                      for on, m in marks.items()}

        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        pmarks = harness.Marks(device)
        with metrics.tracing() as rec, profile(activities=acts) as prof:
            for _ in range(profile_steps):
                rec.next_batch()
                pmarks.begin()
                step(pmarks)
                pmarks.end()
                rec.drain()
        if cuda:
            torch.cuda.synchronize()
    names = {s.name for spans in drained for s in spans}
    return {
        "workload": cell.name, "seed": seed, "batch": mix.batch,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "steps_off": len(step_s[False]), "steps_on": len(step_s[True]),
        "step_ms_off": statistics.fmean(step_s[False]) * 1e3,
        "step_ms_on": statistics.fmean(step_s[True]) * 1e3,
        "span_device_ms": means([d for d, _ in program]),
        "span_host_ms": means([h for _, h in program]),
        "harness_ms": harness_ms,
        "profiled_steps": profile_steps,
        "span_ops": per_step(launched_in(prof, names), profile_steps),
        "harness_ops": per_step(launched_in(prof, pmarks.names),
                                profile_steps),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--blocks", type=int, default=6)
    ap.add_argument("--block-steps", type=int, default=10)
    ap.add_argument("--profile-steps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    result = measure(harness.load_cell(args.workload), args.seed,
                     torch.device("cuda", 0), args.blocks, args.block_steps,
                     args.profile_steps)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

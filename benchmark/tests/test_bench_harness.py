"""The result line's keys, the check for JAX and the JAX package, and the
command line without a card."""

import json
import subprocess
import sys
import types

import pytest
import torch

from benchmark import harness

from bench_cases import ACQUIRED, PRESYNCED, run_tiny, tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", PRESYNCED + ACQUIRED)
def test_untraced_line(name):
    cell = tiny_cell(name)
    line = run_tiny(cell, seconds=0.1)
    json.dumps(line)
    assert list(line) == KEYS                 # checks last
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] % cell.traffic.batch == 0
    path = cell.entry.PATH
    assert set(line["metrics"]) == {f"{path}_frames_per_s",
                                    f"{path}_batch_ms_p95", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


@pytest.mark.parametrize("name", PRESYNCED[:1] + ACQUIRED)
def test_traced_line(name):
    cell = tiny_cell(name)
    line = run_tiny(cell, seconds=0.6, trace=True)
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for key in ("device_ops", "idle_gaps"):
        assert len(line["breakdown"][key]) <= 10
    names = {m["name"] for m in cell.per_layer}
    # The CPU has no device trace: only the span readers find something.
    assert set(line["metrics"]) <= names
    assert f"rx_ms.{cell.entry.PATH}" in line["metrics"]
    for value in line["metrics"].values():
        assert value["value"] > 0


def test_no_jax_after_a_run():
    run_tiny(tiny_cell(PRESYNCED[0]), seconds=0.05)
    run_tiny(tiny_cell(ACQUIRED[0]), seconds=0.05)
    assert harness.forbidden_modules() == []
    assert "projectultra_tpu_torch" in sys.modules


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("jax.numpy", "jaxlib", "flax.linen", "projectultra_tpu",
                 "projectultra_tpu.ops.ldpc"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "jaxtyping_like",
                        types.ModuleType("jaxtyping_like"))
    assert harness.forbidden_modules() == sorted(
        ["jax.numpy", "jaxlib", "flax.linen", "projectultra_tpu",
         "projectultra_tpu.ops.ldpc"])


def test_command_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, str(harness.ROOT / "benchmark" / "run.py"),
         "--workload", PRESYNCED[0], "--seed", str(2**31 + 5),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_command_with_only_the_benchmark_fails(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files the
    program is missing: the command fails and prints no result."""
    import shutil
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", PRESYNCED[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_seeds_give_the_same_inputs():
    from benchmark import traffic as T
    cell = tiny_cell(PRESYNCED[0])
    a = T.inputs(cell.traffic, 324, 7332, 2**33 + 1, 5, torch.device("cpu"))
    b = T.inputs(cell.traffic, 324, 7332, 2**33 + 1, 5, torch.device("cpu"))
    c = T.inputs(cell.traffic, 324, 7332, 2**33 + 1, 6, torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    assert T.compared_steps(cell.traffic, 9) == T.compared_steps(
        cell.traffic, 9)


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
        from torch.autograd import DeviceType
        on_device = self._kind in ("kernel", "gpu_memcpy",
                                   "gpu_user_annotation")
        return DeviceType.CUDA if on_device else DeviceType.CPU

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")


def test_trace_events_by_kind_and_launch():
    """Device events exclude the host ranges mirrored on the device's
    timeline whatever their names; each is tied, by its correlation id, to
    the host span its launching call lies in."""
    events = [
        _Event("tx", "user_annotation", 0, 100),
        _Event("rx", "user_annotation", 100, 300),
        _Event("my_new_span", "user_annotation", 300, 350),
        _Event("aten::add", "cpu_op", 110, 120, corr=7),   # another space
        _Event("cudaLaunchKernel", "cuda_runtime", 50, 55, corr=1),
        _Event("cudaLaunchKernel", "cuda_runtime", 150, 155, corr=7),
        _Event("cudaMemcpyAsync", "cuda_runtime", 310, 315, corr=9),
        _Event("tx", "gpu_user_annotation", 60, 200),
        _Event("my_new_span", "gpu_user_annotation", 400, 500),
        _Event("fft_kernel", "kernel", 60, 90, corr=1),
        _Event("add_kernel", "kernel", 160, 200, corr=7),
        _Event("Memcpy DtoH", "gpu_memcpy", 400, 500, corr=9),
        _Event("orphan_kernel", "kernel", 600, 610, corr=42),
    ]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    device, host, launched = harness.trace_events(
        prof, {"tx", "rx", "my_new_span"})
    assert [d[0] for d in device] == ["fft_kernel", "add_kernel",
                                      "Memcpy DtoH", "orphan_kernel"]
    assert host == [("tx", 0, 100), ("rx", 100, 300),
                    ("my_new_span", 300, 350)]
    assert launched == ["tx", "rx", "my_new_span", None]
    read = harness.reader(harness.HERE / "metrics" / "device_ops.acquired.py")
    trace = types.SimpleNamespace(path="acquired", host_steps=1,
                                  launched_in=launched)
    assert read(trace) == 1
    trace.launched_in = [None, "tx"]
    assert read(trace) is None

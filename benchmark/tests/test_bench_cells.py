"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, limit file and per-layer reader loads and names a known
entry; the file keeps the benchmark contract's shape; a cell is added by
new files alone."""

import json
import re
import shutil

import pytest

from benchmark import harness

from bench_cases import CPU, run_tiny, tiny_cell

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(
            "benchmark/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in BENCH[group]:
            assert NAME.match(item["name"]), item["name"]
            assert item["name"] not in seen
            seen.add(item["name"])
            for key in ("why", "layer", "source"):
                if key in item:
                    assert 1 <= len(item[key]) <= 200 and "\n" not in \
                        item[key] and "\t" not in item[key], item["name"]
            if "unit" in item:
                assert UNIT.match(item["unit"])
                assert item["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_and_names_a_known_entry(name):
    cell = harness.load_cell(name)
    assert cell.entry.PATH in ("presynced", "acquired")
    assert cell.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert cell.traffic.batch > 0 and cell.traffic.compare_steps > 0
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported
    assert {f"{cell.entry.PATH}_frames_per_s",
            f"{cell.entry.PATH}_batch_ms_p95"} <= reported
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.reader(m["reader"]))


@pytest.mark.parametrize("name", CELLS)
def test_limits_name_every_number_compared(name):
    cell = tiny_cell(name)
    result = run_tiny(cell, seconds=0.05)
    assert set(result["checks"]) == set(cell.limits)
    assert result["correct"] is True


def test_configuration_files_state_their_sources():
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"] == []
        assert conf["source"].startswith("https://")
        assert conf["precision"]["ldpc_messages"] == "float32"


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    """A new cell: an existing configuration under a new traffic mix, by a
    BENCHMARK.json entry, a traffic file and a limit file; no code."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ofdm_chirp-presynced-8db",
                               "config": "ofdm_chirp_dqpsk_r12",
                               "traffic": "awgn-8db-b16", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "presynced" in m["name"]:
            m["workloads"].append("ofdm_chirp-presynced-8db")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((ROOT / "benchmark" / "traffic"
                      / "awgn-17db-b16384.json").read_text())
    mix.update(batch=16, snr_db=8.0, reference_rows=8, compare_span=2,
               warmup_steps=1)
    (tmp_path / "benchmark" / "traffic" / "awgn-8db-b16.json").write_text(
        json.dumps(mix))
    shutil.copy(ROOT / "benchmark" / "limits"
                / "ofdm_chirp-presynced-17db.json",
                tmp_path / "benchmark" / "limits"
                / "ofdm_chirp-presynced-8db.json")
    cell = harness.load_cell("ofdm_chirp-presynced-8db", tmp_path)
    assert cell.traffic.snr_db == 8.0 and cell.traffic.batch == 16
    result = run_tiny(cell, seconds=0.05)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"presynced_frames_per_s",
                                      "presynced_batch_ms_p95", "setup_s"}
    traced = run_tiny(cell, seconds=0.3, trace=True)
    assert {"tx_ms.presynced", "rx_ms.presynced"} <= set(traced["metrics"])
    assert CPU.type == "cpu"

"""The port's twins of the JAX package's tools, on the CPU at tiny sizes.

Each tool's ``main(["--cpu", ...])`` must exit 0 and print its result as
one JSON object on its last line, with the keys the tool promises; the
bf16 switches a tool sets are restored after it.  The HF reality twin's
``run`` must meet the five gates of tests/test_hf_reality.py (frames and
ping, noise soak, impulse torture, CW interferer, AGC pumping) on the
CPU; its test size is cut from that test's 6 frames over 30 s with a
30 s soak to 4 frames over 15 s with a 15 s soak, which keeps it near a
minute in one worker.
"""

import importlib.util
import json
import os
import pathlib

import pytest
import torch

torch.set_num_threads(2)

from projectultra_tpu_torch.ops import ldpc as TL  # noqa: E402
from projectultra_tpu_torch.sync import chirp as TC  # noqa: E402

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, argv, capsys):
    rc = _tool(name).main(["--cpu", *argv])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0, "\n".join(lines[-20:])
    result = json.loads(lines[-1])
    assert result["device"] == "cpu"
    return result


@pytest.fixture(autouse=True)
def _flags_restored():
    yield
    assert TL._DEFAULT_MSG_DTYPE == torch.float32
    assert TC._BF16 is False
    assert "ULTRA_LDPC_BF16" not in os.environ
    assert "ULTRA_CHIRP_BF16" not in os.environ


@pytest.mark.parametrize("bf16", [False, True])
def test_ber_curves(bf16, capsys, tmp_path):
    path = tmp_path / "ber.json"
    res = _run("torch_ber_curves", ["--frames", "4", "--json", str(path)]
               + (["--bf16"] if bf16 else []), capsys)
    assert res == json.loads(path.read_text())
    assert {"frames_per_point", "channel", "ldpc_msg_dtype", "rows",
            "total_pipelines", "wall_seconds"} <= res.keys()
    assert res["ldpc_msg_dtype"] == ("bf16" if bf16 else "f32")
    assert res["total_pipelines"] == 4 * 7 * 4
    for row in res["rows"]:
        assert len(row["snrs"]) == len(row["fer"]) == len(row["ber"]) == 7
        assert row["fer"][-1] == 0.0  # the top of every curve decodes


def test_ber_curves_bf16_reaches_the_decoder(monkeypatch, capsys, tmp_path):
    """--bf16 makes every decode of the run use bf16 messages."""
    seen = []
    plain = TL.decode_plain

    def spy(*args, **kw):
        seen.append(TL.msg_dtype_of(kw.get("msg_dtype", args[4]
                                           if len(args) > 4 else None)))
        return plain(*args, **kw)

    monkeypatch.setattr(TL, "decode_plain", spy)
    _run("torch_ber_curves", ["--frames", "1", "--bf16", "--json",
                              str(tmp_path / "b.json")], capsys)
    assert seen and set(seen) == {torch.bfloat16}


@pytest.mark.parametrize("bf16", [False, True])
def test_profile_acquisition(bf16, capsys):
    res = _run("torch_profile_acquisition",
               ["--batch", "2", "--seconds", "2", "--iters", "1"]
               + (["--bf16"] if bf16 else []), capsys)
    assert res["mode"] == ("bf16" if bf16 else "f32")
    assert res["found"] == 1.0 and res["pos_err_p95"] <= 3
    assert res["buffers_per_s"] > 0 and res["samples_per_s"] > 0


def test_cli_simulator(capsys):
    res = _run("torch_cli_simulator", [], capsys)
    assert res["ok"] and res["connected"]
    assert res["messages"] == {"a": ["QSL, copy 100%. 73!"],
                               "b": ["Hello from the TPU modem!"]}
    assert min(res["frames_received"]) > 0


def test_threaded_simulator(capsys):
    res = _run("torch_threaded_simulator", ["--timeout", "240"], capsys)
    assert res["ok"] and res["errors"] == 0
    assert res["messages"] == {"a": ["hello from B"], "b": ["hello from A"]}


def test_threaded_simulator_reports_a_thread_error(monkeypatch, capsys):
    """An exception on a decode thread fails the run (exit 1)."""
    from projectultra_tpu_torch.modem import engine as E

    def broken(self):
        raise RuntimeError("poll failed")

    monkeypatch.setattr(E.ModemEngine, "poll", broken)
    rc = _tool("torch_threaded_simulator").main(["--cpu", "--timeout", "20"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "poll failed" in out
    assert json.loads(out.strip().splitlines()[-1])["errors"] >= 1


@pytest.mark.parametrize("stream", [False, True])
def test_iwaveform(stream, capsys):
    res = _run("torch_test_iwaveform", ["--frames", "3"]
               + (["--stream"] if stream else []), capsys)
    assert res["stream"] is stream and res["waveform"] == "MC_DPSK"
    assert res["decode_rate"] == 1.0 and res["detected_rate"] == 1.0


def test_hf_reality_five_gates():
    frames_ok, soak_ok, torture_ok, tone_ok, agc_ok = \
        _tool("torch_test_hf_reality").run(
            snr_db=25.0, num_frames=4, duration_sec=15.0, soak_minutes=0.25,
            verbose=True, device="cpu")
    assert frames_ok, "mixed-waveform stream: frames/ping missing or extra"
    assert soak_ok, "false decodes on pure noise"
    assert torture_ok, "impulse/clipping torture: lost adjacent frames " \
                       "or produced false decodes"
    assert tone_ok, "CW interferer: frames lost, false decodes, or the " \
                    "exciser never locked the tone"
    assert agc_ok, "AGC pumping: frames lost, false decodes, or a " \
                   "mitigation engaged on the gain wobble"



# The measurement tools (slice 10) at tiny sizes; the tests/test_torch_
# tools_{sro,onset,batch,snr,session,calibrate}.py files hold them to the
# JAX tools on JAX's noise.
@pytest.mark.parametrize("name,argv,keys", [
    ("torch_test_sro", ["--rows", "cox_dqpsk", "--ppm", "0", "--frames", "1"],
     {"gate", "rows", "frames"}),
    ("torch_test_cfo_ramp", ["--rows", "cox_dqpsk", "--rates", "0.1",
                             "--frames", "1"], {"gate", "rows", "frames"}),
    ("torch_test_throughput", ["--codewords", "1"], {"codewords", "rows"}),
    ("torch_test_mode_snr", ["--trials", "1"], {"trials", "rows"}),
    ("torch_test_dpsk_snr", ["--trials", "1"], {"trials", "rows"}),
    ("torch_test_sync_robustness", ["--trials", "1"],
     {"gate", "trials", "conditions"}),
    ("torch_test_otfs_vs_ofdm", ["--trials", "1"],
     {"snr_db", "trials", "conditions", "wins"}),
    ("torch_test_session_throughput", ["--rows", "512_26", "--bytes", "300"],
     {"gate", "bytes", "rows"}),
    ("torch_test_calibrated_negotiation", ["--points", "4", "--messages", "2"],
     {"gate", "calibrated", "points"}),
    ("torch_test_interferer_onset", ["--sir", "5", "--msgs", "4"],
     {"gate", "trials"}),
    ("torch_calibrate_mode_table", ["--trials", "1", "--only",
                                    "OFDM_COX DQPSK R1_2"], {"trials", "rows"}),
    ("torch_calibrate_snr", ["--trials", "1"], {"trials", "pairs"}),
])
def test_measurement_tool_main(name, argv, keys, capsys):
    res = _run(name, argv, capsys)
    assert keys | {"wall_seconds", "device"} <= res.keys()
    if "gate" in res:
        assert res["gate"] is True

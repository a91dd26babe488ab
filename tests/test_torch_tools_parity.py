"""The port's reference-parity overlay (``tools/torch_parity_curves.py``)
against the JAX tool (``tools/parity_curves.py``) on the CPU.

* ``POINTS`` and ``QUICK_POINTS`` are the JAX tool's, and the committed
  artifact that tests/test_parity_curves.py gates holds the reference's
  counts for every point.
* ``run_ours`` on a JAX-made noisy stream gives JAX's count: the JAX
  ``run_ours`` runs with ``projectultra_tpu.parallel.sweep._apply_channel``
  recorded, then the twin's ``channel`` returns JAX's noisy stream (the
  twin's clean stream within 2e-4 of JAX's, the golden TX tolerance).
* The gate and the reading of the reference's counts, on small JSON files
  in ``tmp_path`` (the twin's ``REF_JSON`` pointed at them): a point below the reference fails the run (exit 1,
  verdict false, its noisy streams saved where ``--streams`` says); a
  real one-seed run of an OFDM_COX point passes.
* ``--out PARITY_CURVES.json`` is refused and the file left as it was.
"""

import os

for _flag in ("ULTRA_CHIRP_BF16", "ULTRA_LDPC_BF16", "ULTRA_EXCISION",
              "ULTRA_BLANKER"):
    os.environ.pop(_flag, None)

import json  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

import jax  # noqa: E402,F401

from projectultra_tpu.parallel import sweep as JS  # noqa: E402

from test_torch_tools_batch import TOOLS, Recorder, tool  # noqa: E402

CPU = torch.device("cpu")
TX_TOL = 2e-4
REF_JSON = TOOLS.parent / "PARITY_CURVES.json"


def test_points_match_jax():
    ref, twin = tool("parity_curves"), tool("torch_parity_curves")
    assert twin.POINTS == ref.POINTS
    assert twin.QUICK_POINTS == ref.QUICK_POINTS
    assert len(twin.POINTS) == 23
    # Every point has the reference's counts in the committed artifact.
    counts = twin.reference_counts(REF_JSON)
    assert set(counts) == set(twin.POINTS)
    for decoded, total, seeds in counts.values():
        assert seeds == [42, 43, 44] and 0 <= decoded <= total


@pytest.mark.parametrize("pt", [("MC_DPSK", 5.0, 0.0, "moderate", "r1_4", 2),
                                ("OFDM_COX", 15.0, 0.0, "moderate", "r1_4",
                                 2)])
def test_run_ours_on_jax_noise_matches_jax(pt, monkeypatch):
    rec = Recorder(monkeypatch)
    rec.wrap(JS, "_apply_channel")
    want = tool("parity_curves").run_ours(*pt, seed=42)
    (_, (_, clean, _), noisy), = rec.calls
    twin = tool("torch_parity_curves")
    calls = []

    def channel(point, stream, seed):
        np.testing.assert_allclose(stream.numpy(), clean, rtol=0, atol=TX_TOL)
        calls.append((point.waveform, point.frames, seed))
        return noisy[0].astype(np.float32)

    twin.channel = channel
    ok, n, got = twin.run_ours(*pt, 42, CPU)
    assert calls == [(pt[0], pt[5], 42)]
    assert (ok, n) == want, (ok, n, want)
    np.testing.assert_array_equal(got, noisy[0])


def _curves(tmp_path, rows):
    """A PARITY_CURVES.json with ``rows``: (point, ref_decoded, seeds)."""
    path = tmp_path / "curves.json"
    path.write_text(json.dumps({"points": [
        {"waveform": wf, "snr_db": snr, "cfo_hz": cfo, "channel": chan,
         "rate": rate, "frames_per_seed": frames, "seeds": seeds,
         "ref_decoded": dec, "ref_total": frames * len(seeds)}
        for (wf, snr, cfo, chan, rate, frames), dec, seeds in rows]}))
    return path


def test_gate_fails_a_point_below_the_reference(tmp_path, monkeypatch,
                                                capsys):
    twin = tool("torch_parity_curves")
    p_ok, p_short = twin.POINTS[20], twin.POINTS[3]
    ref = _curves(tmp_path, [(p_ok, 0, [42, 43]), (p_short, 9, [42, 43])])
    decoded = {p_ok[0]: 5, p_short[0]: 4}   # per seed: 10 >= 0, 8 < 9

    def run_ours(wf, snr, cfo, chan, rate, frames, seed, device):
        return decoded[wf], frames, np.full(8, seed, np.float32)

    monkeypatch.setattr(twin, "run_ours", run_ours)
    monkeypatch.setattr(twin, "REF_JSON", str(ref))
    streams = tmp_path / "streams"
    rc = twin.main(["--cpu", "--points", "20,3",
                    "--streams", str(streams), "--out",
                    str(tmp_path / "out.json")])
    out = capsys.readouterr().out
    res = json.loads(out.strip().splitlines()[-1])
    assert rc == 1
    assert res == json.loads((tmp_path / "out.json").read_text())
    assert res["all_points_at_or_above_reference"] is False
    rows = {r["waveform"]: r for r in res["points"]}
    assert (rows["OFDM_COX"]["our_decoded"], rows["OFDM_COX"]["our_total"],
            rows["OFDM_COX"]["ref_decoded"]) == (10, 10, 0)
    assert (rows["MC_DPSK"]["our_decoded"], rows["MC_DPSK"]["ref_decoded"],
            rows["MC_DPSK"]["ref_total"]) == (8, 9, 10)
    assert "** BELOW REF **" in out
    assert sorted(os.listdir(streams)) == ["point3_seed42.npy",
                                           "point3_seed43.npy"]
    np.testing.assert_array_equal(np.load(streams / "point3_seed43.npy"),
                                  np.full(8, 43, np.float32))


def test_one_seed_cox_point_passes(tmp_path, capsys):
    twin = tool("torch_parity_curves")
    twin.REF_JSON = str(_curves(tmp_path, [(twin.POINTS[20], 0, [42])]))
    rc = twin.main(["--cpu", "--points", "20"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["all_points_at_or_above_reference"] is True
    (row,) = res["points"]
    assert row["our_total"] == 5 and row["our_decoded"] >= 4
    assert res["device"] == "cpu" and "wall_seconds" in res


def test_out_refuses_the_committed_artifact(capsys):
    before = REF_JSON.read_bytes()
    twin = tool("torch_parity_curves")
    for out in (str(REF_JSON), str(TOOLS / ".." / "PARITY_CURVES.json")):
        with pytest.raises(SystemExit) as e:
            twin.main(["--cpu", "--points", "20", "--out", out])
        assert e.value.code == 2
        assert "must not overwrite PARITY_CURVES.json" in \
            capsys.readouterr().err
    assert REF_JSON.read_bytes() == before

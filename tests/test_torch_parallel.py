"""Frame-axis data parallelism of the PyTorch port (``parallel/mesh.py``,
``parallel/dcn.py``, ``parallel/dryrun.py`` and
``tools/torch_dcn_sweep.py``) over ``torch.distributed``'s gloo backend on
the CPU, two ranks in spawned processes (``mesh.run_ranks``).

* ``test_mesh_twin``: tests/test_mesh.py's sharded pipeline at world 2
  (B = 16, 0.02 x numpy noise): every frame decodes to its info bits and
  the summed bit and frame errors are 0 on both ranks;
* the acquisition sweep's counts are identical at world 1 and world 2
  (the noise of every frame does not depend on the topology);
* ``dryrun_multichip(2, device="cpu")`` passes its five steps;
* ``tools/torch_dcn_sweep.py --frames 8 --cpu`` prints ``RESULT: PASS``.

The ranks run two threads each (``OMP_NUM_THREADS``).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from projectultra_tpu_torch import CodeRate, Modulation, get_code  # noqa: E402
from projectultra_tpu_torch.ofdm import pipeline as P  # noqa: E402
from projectultra_tpu_torch.parallel import dcn, dryrun  # noqa: E402
from projectultra_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FRAMES = 8


@pytest.fixture(autouse=True)
def _two_threads_a_rank(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


def _mesh_rank(mesh):
    """tests/test_mesh.py's step on this rank's shard."""
    cfg = P.chirp_ofdm_config()
    code = get_code(CodeRate.R1_2)
    B = 16
    rng = np.random.default_rng(0)
    info = rng.integers(0, 2, (B, code.k)).astype(np.float32)
    T = P.frame_samples(cfg, Modulation.DQPSK)
    noise = (0.02 * rng.standard_normal((B, T))).astype(np.float32)
    info_l, noise_l = mesh_mod.shard_frames(mesh, info, noise)
    step = mesh_mod.sharded_pipeline_step(cfg, Modulation.DQPSK,
                                          CodeRate.R1_2, mesh)
    out, ok, totals = step(info_l, noise_l)
    return (mesh.backend, bool(ok.all()),
            bool(torch.equal(out, info_l.to(torch.uint8))),
            tuple(out.shape), totals.tolist())


def test_mesh_twin():
    got = mesh_mod.run_ranks(_mesh_rank, 2, "cpu")
    k = get_code(CodeRate.R1_2).k
    assert got == [("gloo", True, True, (8, k), [0, 0])] * 2


def test_shard_frames_needs_a_divisible_batch():
    mesh = mesh_mod.FrameMesh(1, 2, torch.device("cpu"), "gloo")
    a = np.arange(12).reshape(6, 2)
    assert torch.equal(mesh_mod.shard_frames(mesh, a),
                       torch.from_numpy(a[3:]))
    with pytest.raises(ValueError):
        mesh_mod.shard_frames(mesh, a[:5])


def _acq_rank(mesh, B):
    return dcn.acq_sweep_counts(B, 5.0, mesh=mesh)


def test_acq_sweep_counts_do_not_depend_on_the_world():
    ref = dcn.acq_sweep_counts(FRAMES, 5.0, device="cpu")
    assert ref == {"decoded": FRAMES, "found": FRAMES, "bit_errors": 0}
    assert mesh_mod.run_ranks(_acq_rank, 2, "cpu", FRAMES) == [ref, ref]


def test_dryrun_multichip_on_two_ranks():
    reports = dryrun.dryrun_multichip(2, device="cpu")
    assert [r["rank"] for r in reports] == [0, 1]
    for r in reports:
        assert r["world"] == 2 and r["backend"] == "gloo"
        assert r["failures"] == {"ofdm": 0, "dpsk": 0, "mfsk": 0,
                                 "chirp": 0, "cox": 0}


def _failing_rank(mesh):
    raise ValueError(f"rank {mesh.rank} fails")


def test_run_ranks_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="fails"):
        mesh_mod.run_ranks(_failing_rank, 2, "cpu")


def test_entry_runs_one_step():
    fn, args = dryrun.entry("cpu")
    out, ok = fn(*args)
    assert bool(ok.all())
    assert torch.equal(out, args[0].to(torch.uint8))


def test_dcn_sweep_tool_two_ranks_match_one():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "torch_dcn_sweep.py"),
         "--frames", str(FRAMES), "--cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "RESULT: PASS" in r.stdout

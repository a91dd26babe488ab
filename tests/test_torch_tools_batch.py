"""The port's frame-level batch tools against the JAX tools on the CPU, on
the noise JAX drew: ``tools/torch_test_throughput.py`` against
``tools/test_throughput.py`` and ``tools/torch_test_sync_robustness.py``
against ``tools/test_sync_robustness.py`` (tests/test_torch_tools_snr.py
holds the SNR sweeps and OTFS).

JAX's PRNG cannot be reproduced in torch, so each JAX tool's ``main`` runs
first with ``projectultra_tpu.sim.watterson.add_noise_active`` and
``watterson`` wrapped to record their inputs and outputs; then the twin's
``channel`` is replaced by a replay of JAX's noisy arrays, in order, and
the twin's ``main`` runs.  Held:

* the twin's clean input to each channel within 2e-4 of JAX's (the golden
  TX tolerance);
* every LDPC decode the tools make, in order: ok flags lane for lane and
  the info bits of every decoded lane (hence per-codeword ok and
  bit-exactness);
* the printed table rows, character for character, and for the
  throughput rows ``theoretical_throughput`` and bps exactly.

The throughput table runs all 15 rows at one codeword a frame (the Good
row still carries 8 fading realizations and the delay-fit union); the
sync table all 15 conditions (the CFO ones through ``apply_cfo_hilbert``)
at 2 trials.
"""

import os

for _flag in ("ULTRA_CHIRP_BF16", "ULTRA_LDPC_BF16", "ULTRA_EXCISION",
              "ULTRA_BLANKER"):
    os.environ.pop(_flag, None)

import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

import jax  # noqa: E402,F401

from projectultra_tpu import config as JC  # noqa: E402
from projectultra_tpu.fec import ldpc as JFL  # noqa: E402
from projectultra_tpu.ofdm import pipeline as JP  # noqa: E402
from projectultra_tpu.ops import ldpc as JL  # noqa: E402
from projectultra_tpu.sim import watterson as JW  # noqa: E402

from projectultra_tpu_torch.ops import ldpc as TL  # noqa: E402

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"
TX_TOL = 2e-4


def tool(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Recorder:
    """Records the outermost calls of wrapped functions: (name, inputs,
    output), arrays as numpy."""

    def __init__(self, monkeypatch):
        self.monkeypatch = monkeypatch
        self.calls = []
        self._depth = 0

    def wrap(self, module, name):
        fn = getattr(module, name)

        def recording(*args, **kw):
            self._depth += 1
            try:
                out = fn(*args, **kw)
            finally:
                self._depth -= 1
            if self._depth == 0:
                self.calls.append((name, [_np(a) for a in args], _np(out)))
            return out

        self.monkeypatch.setattr(module, name, recording)

    def of(self, name):
        return [c for c in self.calls if c[0] == name]


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "__array__") and not isinstance(x, (int, float)):
        return np.asarray(x)
    return x


def run_jax(name, argv, monkeypatch, capsys, wrap=(), cpu=True):
    """tools/<name>.py's main (argparse reads sys.argv; ``--cpu`` first
    where the tool takes it) with JAX's channel functions and ``wrap``
    ((module, function) pairs) recorded."""
    rec = Recorder(monkeypatch)
    for fn in ("add_noise_active", "watterson"):
        rec.wrap(JW, fn)
    for module, fn in wrap:
        rec.wrap(module, fn)
    monkeypatch.setattr(sys, "argv",
                        [f"{name}.py", *(["--cpu"] if cpu else []), *argv])
    rc = tool(name).main()
    return rc, capsys.readouterr().out, rec


def replay(twin, air, tol=TX_TOL):
    """Replace ``twin.channel`` by JAX's recorded channel outputs: each call
    takes the next records up to the next ``add_noise_active`` one (a
    Watterson record before it is the same call's fading), holds the twin's
    clean input to the first record's, and returns the last output.
    Returns (the records left, each call's clean input)."""
    queue = list(air)
    clean_inputs = []

    def channel(x, *args):
        name, inputs, out = queue.pop(0)
        clean = inputs[1]
        while name == "watterson":
            name, _, out = queue.pop(0)
        np.testing.assert_allclose(_np(x), clean, rtol=0, atol=tol)
        clean_inputs.append(clean)
        return torch.from_numpy(np.array(out)).to(x.device)

    twin.channel = channel
    return queue, clean_inputs


def run_twin(twin, argv, capsys):
    rc = twin.main(["--cpu", *argv])
    out = capsys.readouterr().out
    return rc, out, json.loads(out.strip().splitlines()[-1])


def same_decodes(port, ref):
    """Every decode in order: ok flags lane for lane, and info bits on every
    lane that decoded (a lane that never converges ends on oscillating
    bits in either package), which makes per-codeword bit-exactness
    equal."""
    assert len(port) == len(ref) > 0
    for (_, _, (bits, ok, _)), (_, _, (jbits, jok, _)) in zip(port, ref):
        np.testing.assert_array_equal(ok, jok)
        np.testing.assert_array_equal(bits[jok], jbits[jok])


def table_lines(out, first):
    """The printed table: the lines from the one starting with ``first``
    up to the JSON line (the twin's header names the device)."""
    lines = out.splitlines()
    start = next(i for i, l in enumerate(lines) if l.startswith(first))
    return [l for l in lines[start:] if not l.startswith("{")]


def test_throughput_matches_jax(monkeypatch, capsys):
    rc, jout, rec = run_jax("test_throughput", ["--codewords", "1"],
                            monkeypatch, capsys, wrap=[(JL, "decode")])
    assert rc == 0
    twin = tool("torch_test_throughput")
    ours_rec = Recorder(monkeypatch)
    ours_rec.wrap(TL, "decode")
    left, clean = replay(twin, [c for c in rec.calls if c[0] in
                                ("add_noise_active", "watterson")])
    rc, out, res = run_twin(twin, ["--codewords", "1"], capsys)
    assert rc == 0 and left == [] and len(clean) == 15
    same_decodes(ours_rec.of("decode"), rec.of("decode"))
    assert table_lines(out, "OFDM 512") == table_lines(jout, "OFDM 512")
    # The theoretical rate and bps exactly: JAX's configs of the rows, and
    # the frame lengths JAX built (the replay held each shape).
    jcfgs = ([JP.chirp_ofdm_config()] * 3 + [JC.ModemConfig()] * 3
             + [JC.nvis_mode()] * 4 + [JC.high_throughput()] * 2
             + [JC.nvis_mode()] * 3)
    for row, r, jcfg, tx in zip(twin.rows(), res["rows"], jcfgs, clean):
        mod, rate = JC.Modulation[row[2].name], JC.CodeRate[row[3].name]
        assert r["theory"] == jcfg.theoretical_throughput(mod, rate)
        audio_s = tx.shape[-1] / jcfg.sample_rate
        assert r["audio_s"] == audio_s
        assert r["bps"] == JFL.get_code(rate).k / audio_s
    good = res["rows"][11]
    assert good["label"].endswith("Good20") and len(good["ok"]) == 8


def test_sync_robustness_matches_jax(monkeypatch, capsys):
    rc, jout, rec = run_jax("test_sync_robustness", ["--trials", "2"],
                            monkeypatch, capsys, wrap=[(JL, "decode")])
    twin = tool("torch_test_sync_robustness")
    ours_rec = Recorder(monkeypatch)
    ours_rec.wrap(TL, "decode")
    left, clean = replay(twin, rec.of("add_noise_active"))
    rc_twin, out, res = run_twin(twin, ["--trials", "2"], capsys)
    assert left == [] and len(clean) == len(twin.CONDITIONS) == 15
    assert rc_twin == rc
    same_decodes(ours_rec.of("decode"), rec.of("decode"))
    assert [l for l in out.splitlines() if l.startswith("  ")] == \
        [l for l in jout.splitlines() if l.startswith("  ")]
    assert out.splitlines()[-2] == jout.splitlines()[-1]
    assert [c["condition"] for c in res["conditions"]] == \
        [name for name, _ in twin.CONDITIONS]

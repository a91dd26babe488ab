"""The port's mid-session interferer-onset harness
(``tools/torch_test_interferer_onset.py``) against the JAX tool
(``tools/test_interferer_onset.py``) on the CPU.

Two ``ProtocolEngine`` stations per package hold an ARQ transfer over air
drawn from ``numpy.random.default_rng(17)``, and a CW tone at SIR 5 dB
switches on mid-transfer.  ``run_onset(5.0)``'s tuple -- seconds to the
notch, messages delivered in order, messages, retransmissions, false
tones, connected -- must equal JAX's exactly, and meet
tests/test_excision.py::test_mid_session_interferer_onset's gate.  The
JAX tool runs as that test runs it, with JAX on the CPU.
"""

import os

for _flag in ("ULTRA_CHIRP_BF16", "ULTRA_LDPC_BF16", "ULTRA_EXCISION",
              "ULTRA_BLANKER"):
    os.environ.pop(_flag, None)

import importlib.util  # noqa: E402
import pathlib  # noqa: E402

import torch  # noqa: E402

torch.set_num_threads(2)

import jax  # noqa: E402,F401

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_onset_sir5_matches_jax():
    ref = _tool("test_interferer_onset").run_onset(5.0)
    tool = _tool("torch_test_interferer_onset")
    ours = tool.run_onset(5.0, device=torch.device("cpu"))
    assert ours == ref
    react, got, n, retx, false_tones, conn = ours
    assert got == n, f"delivered {got}/{n}"
    assert conn
    assert react is not None and react <= 10.0, f"time-to-notch {react}"
    assert false_tones == [], false_tones
    assert tool.onset_ok(react, got, n, false_tones, conn)

"""The PyTorch port imports neither jax nor the JAX package.

Importing ``projectultra_tpu_torch`` and every one of its modules in a fresh
interpreter must leave ``jax`` and ``projectultra_tpu`` out of
``sys.modules``, and no port source, and not ``chip_smoke.py``, may name
either in an import.  The host modules the port needs are its own copies
(pinned to the originals by ``tests/test_torch_host.py``).
"""

import ast
import importlib.util
import pathlib
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "projectultra_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_modules_found():
    mods = _port_modules()
    for name in ("projectultra_tpu_torch", "projectultra_tpu_torch.ops.ldpc",
                 "projectultra_tpu_torch.ops.cuda_ldpc",
                 "projectultra_tpu_torch.ofdm.pipeline",
                 "projectultra_tpu_torch.sim.watterson",
                 "projectultra_tpu_torch.sync",
                 "projectultra_tpu_torch.sync.schmidl_cox",
                 "projectultra_tpu_torch.ops.sc_windows",
                 "projectultra_tpu_torch.ops.cuda_sc",
                 "projectultra_tpu_torch.ops.cuda_build",
                 "projectultra_tpu_torch.ops.dpsk_score",
                 "projectultra_tpu_torch.ops.cuda_dpsk",
                 "projectultra_tpu_torch.sync.chirp",
                 "projectultra_tpu_torch.psk",
                 "projectultra_tpu_torch.psk.mc_dpsk",
                 "projectultra_tpu_torch.psk.dpsk",
                 "projectultra_tpu_torch.psk.fsk",
                 "projectultra_tpu_torch.otfs.otfs",
                 "projectultra_tpu_torch.ofdm.delay_fit",
                 "projectultra_tpu_torch.config",
                 "projectultra_tpu_torch.fec.ldpc",
                 "projectultra_tpu_torch.ofdm.carriers",
                 "projectultra_tpu_torch.ofdm.constellations",
                 "projectultra_tpu_torch.utils.mt19937",
                 "projectultra_tpu_torch.utils.bits",
                 "projectultra_tpu_torch.utils.metrics",
                 "projectultra_tpu_torch.fec.interleave",
                 "projectultra_tpu_torch.fec.crc_recover",
                 "projectultra_tpu_torch.protocol",
                 "projectultra_tpu_torch.protocol.frame_v2",
                 "projectultra_tpu_torch.native",
                 "projectultra_tpu_torch.modem",
                 "projectultra_tpu_torch.modem.types",
                 "projectultra_tpu_torch.modem.wideband_snr",
                 "projectultra_tpu_torch.modem.excision",
                 "projectultra_tpu_torch.modem.blanker",
                 "projectultra_tpu_torch.modem.audio",
                 "projectultra_tpu_torch.modem.engine",
                 "projectultra_tpu_torch.modem.acquisition",
                 "projectultra_tpu_torch.modem.acquisition.base",
                 "projectultra_tpu_torch.modem.acquisition.chirp",
                 "projectultra_tpu_torch.modem.acquisition.cox",
                 "projectultra_tpu_torch.modem.acquisition.dpsk",
                 "projectultra_tpu_torch.modem.acquisition.otfs",
                 "projectultra_tpu_torch.utils.logging",
                 "projectultra_tpu_torch.utils.settings",
                 "projectultra_tpu_torch.utils.observability",
                 "projectultra_tpu_torch.protocol.compression",
                 "projectultra_tpu_torch.protocol.arq",
                 "projectultra_tpu_torch.protocol.file_transfer",
                 "projectultra_tpu_torch.protocol.connection",
                 "projectultra_tpu_torch.protocol.engine",
                 "projectultra_tpu_torch.modem.adaptive",
                 "projectultra_tpu_torch.modem.rx_pipeline",
                 "projectultra_tpu_torch.waveform",
                 "projectultra_tpu_torch.waveform.factory",
                 "projectultra_tpu_torch.waveform.otfs_adapter",
                 "projectultra_tpu_torch.ops.dsp",
                 "projectultra_tpu_torch.cli",
                 "projectultra_tpu_torch.parallel",
                 "projectultra_tpu_torch.parallel.sweep",
                 "projectultra_tpu_torch.parallel.mesh",
                 "projectultra_tpu_torch.parallel.dcn",
                 "projectultra_tpu_torch.parallel.dryrun"):
        assert name in mods


FORBIDDEN = ("jax", "projectultra_tpu")


def _forbidden(name: str) -> bool:
    return any(name == top or name.startswith(top + ".") for top in FORBIDDEN)


def test_import_leaves_jax_out():
    code = ("import importlib, sys\n"
            f"mods = {_port_modules()!r}\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            f"bad = sorted(k for k in sys.modules if any(k == t or "
            f"k.startswith(t + '.') for t in {FORBIDDEN!r}))\n"
            "print('FORBIDDEN_MODULES', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_modules(path):
    """Every module an import names in the file: import statements (for
    ``from m import a`` both ``m`` and ``m.a``) and string arguments of
    ``importlib.import_module`` and ``__import__``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__"):
            yield node.args[0].value


def test_no_jax_import_in_port_sources():
    """No port module imports jax or anything of the JAX package."""
    sources = sorted(PORT.rglob("*.py"))
    assert len(sources) > 20
    for path in sources:
        for name in _imported_modules(path):
            assert not _forbidden(name), (path, name)


TOOLS = [ROOT / "tools" / f"torch_{name}.py"
         for name in ("dcn_sweep", "regression_matrix", "ber_curves",
                      "profile_acquisition", "cli_simulator",
                      "test_hf_reality", "threaded_simulator",
                      "test_iwaveform", "test_sro", "test_cfo_ramp",
                      "test_interferer_onset", "test_throughput",
                      "test_mode_snr", "test_dpsk_snr",
                      "test_sync_robustness", "test_otfs_vs_ofdm",
                      "test_session_throughput",
                      "test_calibrated_negotiation", "calibrate_mode_table",
                      "calibrate_snr", "tui", "webui", "parity_curves")]

# JAX tools without a tools/torch_<name>.py twin, each with its reason.
# (tools/ref_oracle/ regenerates reference fixtures from the C++ reference,
# which is not part of the repo; it is not a tools/*.py module.)
UNTWINNED_TOOLS: set = set()


def test_every_jax_tool_has_a_twin():
    """Every tools/*.py of the JAX package has a tools/torch_<name>.py
    twin, except the listed ones."""
    jax_tools = {p.stem for p in (ROOT / "tools").glob("*.py")
                 if not p.stem.startswith("torch_")}
    assert "parity_curves" in jax_tools and "webui" in jax_tools
    missing = {name for name in jax_tools
               if not (ROOT / "tools" / f"torch_{name}.py").exists()}
    assert missing == UNTWINNED_TOOLS
    assert {p.stem for p in TOOLS} == {f"torch_{n}" for n in jax_tools}


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_tools_import_only_the_port():
    """The port's tools name no jax and nothing of the JAX package, and
    loading them with the port modules they import leaves both out of
    ``sys.modules``."""
    imported = set()
    for path in TOOLS:
        names = set(_imported_modules(path))
        assert any(n.startswith("projectultra_tpu_torch.") for n in names), \
            path
        for name in names:
            assert not _forbidden(name), (path, name)
        imported |= {n for n in names
                     if n.startswith("projectultra_tpu_torch.")}
    modules = sorted(n for n in imported if n in set(_port_modules()))
    code = ("import importlib, runpy, sys\n"
            f"for path in {[str(p) for p in TOOLS]!r}:\n"
            "    runpy.run_path(path, run_name='tool')\n"
            f"for name in {modules!r}:\n"
            "    importlib.import_module(name)\n"
            f"bad = sorted(k for k in sys.modules if any(k == t or "
            f"k.startswith(t + '.') for t in {FORBIDDEN!r}))\n"
            "print('FORBIDDEN_MODULES', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches everything through the port and imports
    nothing of jax or of the JAX package."""
    names = set(_imported_modules(ROOT / "chip_smoke.py"))
    assert "projectultra_tpu_torch" in names
    for name in names:
        assert not _forbidden(name), name


def test_bench_torch_imports_only_the_port():
    """bench_torch.py, bench.py's twin, imports nothing of jax, of the JAX
    package or of bench.py."""
    names = set(_imported_modules(ROOT / "bench_torch.py"))
    assert "projectultra_tpu_torch" in names
    for name in names:
        assert not _forbidden(name) and name != "bench", name


def test_bench_torch_import_leaves_jax_out():
    code = ("import sys, bench_torch\n"
            f"bad = sorted(k for k in sys.modules if any(k == t or "
            f"k.startswith(t + '.') for t in {FORBIDDEN!r} + ('bench',)))\n"
            "print('FORBIDDEN_MODULES', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# Root scripts of the JAX package and the port's twin of each: bench.py's
# workloads run in bench_torch.py, __graft_entry__.py's entry and
# multi-chip dry run in parallel/dryrun.py.
ROOT_TWINS = {"bench.py": "bench_torch.py",
              "__graft_entry__.py": "projectultra_tpu_torch/parallel/dryrun.py"}


def test_every_jax_root_script_has_a_twin():
    """Every root *.py that imports jax or the JAX package has its twin."""
    jax_scripts = {p.name for p in ROOT.glob("*.py")
                   if any(_forbidden(n) for n in _imported_modules(p))}
    assert jax_scripts == set(ROOT_TWINS)
    for twin in ROOT_TWINS.values():
        assert (ROOT / twin).is_file(), twin


def test_import_pins_float32():
    import projectultra_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_require_cuda_raises_without_a_card(monkeypatch):
    from projectultra_tpu_torch import require_cuda
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        require_cuda()


@pytest.mark.parametrize("entry", ["ProtocolEngine", "RxPipeline",
                                   "waveform.create", "cli.main",
                                   "sweep.run_point", "sweep.run_point_stream",
                                   "dcn.acq_sweep_counts", "dryrun.entry",
                                   "dryrun.dryrun_multichip", "tui.main",
                                   "webui.main", "parity_curves.main",
                                   "bench_torch.main"])
def test_entry_points_take_the_card(entry, monkeypatch, tmp_path):
    """Without a device each entry point of the protocol and parallel
    slices, and each front-end tool and the bench without ``--cpu``, asks
    for the first CUDA device, so it raises where there is none."""
    from projectultra_tpu_torch import cli
    from projectultra_tpu_torch.modem.rx_pipeline import RxPipeline
    from projectultra_tpu_torch.parallel import dcn, dryrun, sweep
    from projectultra_tpu_torch.protocol.engine import ProtocolEngine
    from projectultra_tpu_torch.protocol.frame_v2 import WaveformMode
    from projectultra_tpu_torch.waveform import factory
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    point = sweep.SweepPoint("MC_DPSK", 5.0, frames=2)
    call = {"ProtocolEngine": ProtocolEngine, "RxPipeline": RxPipeline,
            "waveform.create": lambda: factory.create(WaveformMode.OFDM_COX),
            "cli.main": lambda: cli.main(["ptx", "hello", "-o",
                                          str(tmp_path / "tx.f32")]),
            "sweep.run_point": lambda: sweep.run_point(point),
            "sweep.run_point_stream": lambda: sweep.run_point_stream(point),
            "dcn.acq_sweep_counts": lambda: dcn.acq_sweep_counts(2),
            "dryrun.entry": dryrun.entry,
            "dryrun.dryrun_multichip":
                lambda: dryrun.dryrun_multichip(2),
            "tui.main": lambda: _tool("torch_tui").main(["--sim"]),
            "webui.main": lambda: _tool("torch_webui").main(
                ["--script", "--port", "0"]),
            "parity_curves.main": lambda: _tool("torch_parity_curves").main(
                ["--points", "20"]),
            "bench_torch.main": lambda: importlib.import_module(
                "bench_torch").main([])}[entry]
    with pytest.raises(RuntimeError):
        call()


# Top-level names of the JAX package that the port does not define under
# the same module and name, each on purpose (ROADMAP Queue 1 lists them).
NAME_DIFF = {
    # The two Pallas TPU kernels and the dead ULTRA_PALLAS_SYNC switch:
    # replaced by csrc/*.cu behind ops/cuda_ldpc.py and ops/cuda_sc.py.
    ("ops.pallas_ldpc", "_edge_constants"), ("ops.pallas_ldpc", "_kernel"),
    ("ops.pallas_ldpc", "decode_pallas"), ("ops.pallas_sync", "_sc_kernel"),
    ("ops.pallas_sync", "_wsum"), ("ops.pallas_sync", "enabled"),
    ("ops.pallas_sync", "sc_windows_pallas"),
    # JAX-only helpers: the JAX backend switch of the CLI, the 128-aligned
    # bf16 refine gather (a TPU layout motive), vmap'd dynamic slices and
    # jnp bit packing.
    ("cli", "_configure_backend"), ("sync.chirp", "_corr_aligned"),
    ("sync.chirp", "_refine_mats_aligned"), ("parallel.sweep", "_vslice"),
    ("utils.bits", "jnp_packbits"), ("utils.bits", "jnp_unpackbits"),
    # Private names that moved or were folded: _window_sum is
    # ops/sc_windows.window_sum, _ifft_cp/symbols_to_passband live in the
    # port's modulator, _gcd is math.gcd, _stream_engines is
    # _stream_engine (one engine per call, on a device).
    ("sync.schmidl_cox", "_window_sum"), ("ofdm.modulator", "_ifft_cp"),
    ("ofdm.modulator", "symbols_to_passband"), ("fec.interleave", "_gcd"),
    ("parallel.sweep", "_stream_engines"),
}


def _top_level_names(root: pathlib.Path) -> set:
    out = set()
    for path in root.rglob("*.py"):
        mod = ".".join(path.relative_to(root).with_suffix("").parts)
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                out.add((mod, node.name))
    return out


def test_top_level_name_diff_is_the_listed_one():
    """Every top-level def/class of the JAX package has a port twin of the
    same module and name, except the listed ones."""
    missing = (_top_level_names(ROOT / "projectultra_tpu")
               - _top_level_names(PORT))
    assert missing == NAME_DIFF

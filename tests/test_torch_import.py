"""The PyTorch port imports neither jax nor the JAX package.

Importing ``projectultra_tpu_torch`` and every one of its modules in a fresh
interpreter must leave ``jax`` and ``projectultra_tpu`` out of
``sys.modules``, and no port source, and not ``chip_smoke.py``, may name
either in an import.  The host modules the port needs are its own copies
(pinned to the originals by ``tests/test_torch_host.py``).
"""

import ast
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
                 "projectultra_tpu_torch.utils.mt19937"):
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


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches everything through the port and imports
    nothing of jax or of the JAX package."""
    names = set(_imported_modules(ROOT / "chip_smoke.py"))
    assert "projectultra_tpu_torch" in names
    for name in names:
        assert not _forbidden(name), name


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

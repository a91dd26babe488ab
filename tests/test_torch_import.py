"""The PyTorch port imports without jax.

Importing ``projectultra_tpu_torch`` and every one of its modules in a fresh
interpreter must leave ``jax`` out of ``sys.modules``, and no port source
may contain a jax import.
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
                 "projectultra_tpu_torch.psk.mc_dpsk"):
        assert name in mods


def test_import_leaves_jax_out():
    code = ("import importlib, sys\n"
            f"mods = {_port_modules()!r}\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' "
            "or k.startswith('jax.'))\n"
            "print('JAX_MODULES', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


SHARED = {"projectultra_tpu.config", "projectultra_tpu.fec.ldpc",
          "projectultra_tpu.ofdm.carriers",
          "projectultra_tpu.ofdm.constellations",
          "projectultra_tpu.utils.mt19937"}


def _imported_modules(path):
    """Every module an import statement of the file names (for ``from m
    import a`` both ``m`` and ``m.a``, whichever is a module)."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            subs = [f"{node.module}.{a.name}" for a in node.names]
            yield from (subs if all(x in SHARED for x in subs)
                        else [node.module])


def test_no_jax_import_in_port_sources():
    """No jax, and of the JAX package only its jax-free host modules."""
    for path in PORT.rglob("*.py"):
        for name in _imported_modules(path):
            assert name != "jax" and not name.startswith("jax."), (path, name)
            if name.split(".")[0] == "projectultra_tpu":
                assert name in SHARED, (path, name)


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the shared host modules through the port and
    imports nothing of jax or of the JAX package itself."""
    names = set(_imported_modules(ROOT / "chip_smoke.py"))
    assert "projectultra_tpu_torch" in names
    for name in names:
        assert name.split(".")[0] not in ("jax", "projectultra_tpu"), name


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

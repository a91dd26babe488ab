"""Build and load of the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``.  The build runs at first use, into ``projectultra_tpu_torch/
build/``, named by a hash of the source and the compiler command, so an
edited source is rebuilt and an unchanged one is reused.  The compiler's
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside the
library.  A failed build raises; nothing falls back to a plain PyTorch
version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

HOPPER = ("-gencode", "arch=compute_90a,code=sm_90a")


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def nvcc_command(nvcc: str, source: Path, output: Path,
                 flags: tuple[str, ...] = ()) -> list[str]:
    """The compiler command for one kernel library; ``flags`` are the
    kernel's own (for example ``--fmad=false``)."""
    return [nvcc, *HOPPER, "-std=c++17", "-O3", *flags, "-Xptxas", "-v",
            "-shared", "-Xcompiler", "-fPIC", "-o", str(output), str(source)]


def build(source: Path, flags: tuple[str, ...] = ()) -> Path:
    """Compile ``source`` (if its hash-named library is not built yet) and
    return the library's path; raises with nvcc's output on failure."""
    nvcc = find_nvcc()
    probe = nvcc_command("nvcc", source, Path("lib.so"), flags)
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(probe).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(nvcc, source, Path(tmp), flags),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{source}:\n{proc.stdout}\n{proc.stderr}")
        (BUILD_DIR / f"{out.stem}.ptxas.txt").write_text(proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


class KernelLibrary:
    """One kernel source's library, built and loaded once per process.

    ``bind`` sets the ctypes signatures of the library's C entry points.
    ``build_seconds`` is what the first ``load`` took (build or cache
    lookup, plus the load)."""

    def __init__(self, source: Path, flags: tuple[str, ...],
                 bind: Callable[[ctypes.CDLL], None]):
        self.source, self.flags, self._bind = source, flags, bind
        self.build_seconds = 0.0
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library; raises on failure."""
        with self._lock:
            if self._lib is None:
                t0 = time.perf_counter()
                lib = ctypes.CDLL(str(build(self.source, self.flags)))
                self._bind(lib)
                self.build_seconds = time.perf_counter() - t0
                self._lib = lib
            return self._lib


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _sm_count(index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count

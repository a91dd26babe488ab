"""Build, load and launch plumbing of the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes`` (``KernelLibrary``).  The build runs at a library's first use,
into ``projectultra_tpu_torch/build/``, named by a hash of the source and
the compiler command, so an edited source is rebuilt and an unchanged one
is reused.  The compiler's ``-Xptxas -v`` report (registers, shared memory,
spills) is kept beside the library.  A failed build raises; nothing falls
back to a plain PyTorch version.

Every library's C entry points return 0 or an error code that
``<prefix>_error_string`` names, and launch on the stream they are given:
the wrappers (``ops/cuda_*.py``) pass PyTorch's current stream, allocate
the outputs with ``torch.empty`` and never synchronise.  A wrapper checks
its tensor arguments with ``check_tensor`` before anything is loaded.
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

    ``prefix`` names its C entry points (``<prefix>_error_string`` among
    them); ``bind`` sets the ctypes signatures of the others.
    ``build_seconds`` is what the first ``load`` took (build or cache
    lookup, plus the load)."""

    def __init__(self, prefix: str, source: Path, flags: tuple[str, ...],
                 bind: Callable[[ctypes.CDLL], None]):
        self.prefix, self.source, self.flags = prefix, source, flags
        self._bind = bind
        self.build_seconds = 0.0
        self._lib = None
        self._lock = threading.Lock()

    def command(self, nvcc: str, output: Path) -> list[str]:
        """The compiler command that builds the library at ``output``."""
        return nvcc_command(nvcc, self.source, output, self.flags)

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library; raises on failure."""
        lib = self._lib
        if lib is not None:
            return lib
        with self._lock:
            if self._lib is None:
                t0 = time.perf_counter()
                lib = ctypes.CDLL(str(build(self.source, self.flags)))
                error_string = getattr(lib, f"{self.prefix}_error_string")
                error_string.argtypes = [ctypes.c_int]
                error_string.restype = ctypes.c_char_p
                self._bind(lib)
                self.build_seconds = time.perf_counter() - t0
                self._lib = lib
            return self._lib

    def run(self, entry: str, *args) -> None:
        """Calls the C entry point ``entry`` with ``args``; a nonzero return
        raises RuntimeError("<entry> failed: <message> (<code>)")."""
        lib = self.load()
        err = getattr(lib, entry)(*args)
        if err != 0:
            msg = getattr(lib, f"{self.prefix}_error_string")(err).decode()
            raise RuntimeError(f"{entry} failed: {msg} ({err})")


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple, layout: str,
                 device: torch.device | None) -> None:
    """Raises ValueError unless the kernel argument ``name`` is a
    ``dtype`` tensor of ``shape`` (an int per axis, or a name for any
    size) on ``device`` (None: on any CUDA device), laid out as
    ``layout``: "contiguous"; "aligned" (contiguous, 16-byte aligned);
    "rows" (unit column stride, any row stride); "disjoint rows" (unit
    column stride where there is more than one column, rows that do not
    overlap); "any"."""
    size = t.shape
    bad = t.dtype != dtype
    if size != shape:  # (always so where shape names an axis)
        bad = bad or len(size) != len(shape)
        for want, got in zip(shape, size):
            bad = bad or (want != got and want.__class__ is int)
    if bad:
        raise ValueError(f"{name} must be [{', '.join(map(str, shape))}] "
                         f"{dtype}, got {tuple(size)} {t.dtype}")
    if layout == "contiguous" or layout == "aligned":
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous: strides "
                             f"{t.stride()}")
        if layout == "aligned" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"copies rows in 16-byte chunks)")
    elif layout == "rows" or layout == "disjoint rows":
        (B, T), (ld, step) = size, t.stride()
        if step != 1 and (T > 1 or layout == "rows"):
            raise ValueError(f"{name} must have unit column stride, got "
                             f"strides {(ld, step)}")
        if layout == "disjoint rows" and B > 1 and ld < T:
            raise ValueError(f"{name}'s rows overlap: strides {(ld, step)}")
    if device is None:
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got one on "
                             f"{t.device}")
    elif t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _sm_count(index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count

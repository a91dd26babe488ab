"""Wrapper of the hand-written Hopper LDPC min-sum kernel
(``csrc/ldpc_minsum.cu``), the port of ``ops/pallas_ldpc.py::_kernel``.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``.  The build runs at
first use, into ``projectultra_tpu_torch/build/``, named by a hash of the
source and the compiler command, so an edited source is rebuilt and an
unchanged one is reused.  A failed build raises; nothing falls back to
the plain PyTorch decoder.

The kernel launches on PyTorch's current stream, does not synchronise and
allocates nothing: this wrapper allocates the outputs with ``torch.empty``.
``launches`` counts the kernel launches made through ``decode_cuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from projectultra_tpu.fec.ldpc import DEFAULT_MAX_ITERS

from .ldpc import trap_escape_llrs

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "ldpc_minsum.cu"
BUILD_DIR = PACKAGE_DIR / "build"

#: Kernel launches made through decode_cuda (a run resets it to 0 to show
#: that its path went through the kernel).
launches = 0
#: Seconds the last build (or cache lookup) of the library took.
build_seconds = 0.0

_lib = None
_lib_lock = threading.Lock()


def _find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the LDPC kernel "
                           "is built from csrc/ldpc_minsum.cu at first use")
    return found


def nvcc_command(nvcc: str, source: Path, output: Path) -> list[str]:
    """The compiler command for the kernel library."""
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
            "-shared", "-Xcompiler", "-fPIC",
            "-o", str(output), str(source)]


def _build() -> Path:
    nvcc = _find_nvcc()
    probe = nvcc_command("nvcc", SOURCE, Path("lib.so"))
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(probe).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libldpc_minsum_{digest}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(nvcc, SOURCE, Path(tmp)),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{SOURCE}:\n{proc.stdout}\n{proc.stderr}")
        (BUILD_DIR / f"{out.stem}.ptxas.txt").write_text(proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    global _lib, build_seconds
    with _lib_lock:
        if _lib is None:
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(_build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.ldpc_minsum_decode.argtypes = [vp] * 7 + [ci] * 6 + [vp]
            lib.ldpc_minsum_decode.restype = ci
            lib.ldpc_minsum_error_string.argtypes = [ci]
            lib.ldpc_minsum_error_string.restype = ctypes.c_char_p
            build_seconds = time.perf_counter() - t0
            _lib = lib
        return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def launch(graph, llrs: torch.Tensor, max_iters: int):
    """One kernel launch over a [B, n] float32 CUDA batch.

    Returns (llr_total [B, n] f32, ok [B] bool, iters [B] int32)."""
    global launches
    if llrs.device.type != "cuda":
        raise ValueError(f"the LDPC kernel needs a CUDA tensor, got {llrs.device}")
    if llrs.dtype != torch.float32:
        raise ValueError(f"the LDPC kernel takes float32 LLRs, got {llrs.dtype} "
                         "(bf16 messages are not implemented)")
    if llrs.dim() != 2:
        raise ValueError(f"llrs must be [B, n], got shape {tuple(llrs.shape)}")
    B = llrs.shape[0]
    n, m, D, Dv = graph.n, graph.m, graph.D, graph.Dv
    dev = llrs.device
    _check("llrs", llrs, torch.float32, (B, n), dev)
    _check("row_vars", graph.row_vars, torch.int32, (m, D), dev)
    _check("row_deg", graph.row_deg, torch.int32, (m,), dev)
    _check("var_edges", graph.var_edges, torch.int32, (n, Dv), dev)
    if not 0 <= max_iters < 2 ** 31:
        raise ValueError(f"max_iters out of range: {max_iters}")
    lib = load_library()
    llr_out = torch.empty((B, n), dtype=torch.float32, device=dev)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return llr_out, ok, iters
    with torch.cuda.device(dev):
        err = lib.ldpc_minsum_decode(
            llrs.data_ptr(), graph.row_vars.data_ptr(),
            graph.row_deg.data_ptr(), graph.var_edges.data_ptr(),
            llr_out.data_ptr(), ok.data_ptr(), iters.data_ptr(),
            B, n, m, D, Dv, max_iters,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.ldpc_minsum_error_string(err).decode()
        raise RuntimeError(f"ldpc_minsum_decode launch failed: {msg} ({err})")
    launches += 1
    return llr_out, ok, iters


def decode_cuda(graph, llrs: torch.Tensor,
                max_iters: int = DEFAULT_MAX_ITERS,
                trap_escape: bool = False):
    """The kernel's counterpart of ``ops.ldpc.decode_plain``: returns
    (llr_total [B, n] f32, ok [B] bool, iters [B] int32).

    ``trap_escape`` is a second launch over the failed lanes only, on their
    channel LLRs with the bits of unsatisfied checks erased."""
    llr_in = llrs.contiguous()
    llr_total, ok, iters = launch(graph, llr_in, max_iters)
    if trap_escape:
        failed = torch.nonzero(~ok).squeeze(1)
        if failed.numel():
            llr2 = trap_escape_llrs(graph, llr_in[failed], llr_total[failed])
            llr_t2, ok2, iters2 = launch(graph, llr2.contiguous(), max_iters)
            rescued = failed[ok2]
            llr_total[rescued] = llr_t2[ok2]
            iters[rescued] = iters2[ok2]
            ok[rescued] = True
    return llr_total, ok, iters

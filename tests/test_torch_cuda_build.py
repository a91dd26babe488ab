"""The hand-kernel libraries' shared plumbing (ops/cuda_build.py) on the CPU.

* every kernel wrapper's library compiles its own source under ``csrc/``
  for sm_90a into a shared library, with that kernel's own flags
  (``--fmad=false`` where the kernel must round as PyTorch's separate
  operations) and never ``--use_fast_math``;
* ``KernelLibrary.run`` turns an entry point's nonzero return code into
  ``RuntimeError("<entry> failed: <message> (<code>)")`` with the
  library's own ``<prefix>_error_string``;
* ``check_tensor`` refuses each malformed argument with a ValueError that
  names what is wrong, and a CPU tensor last.
"""

import types

import pytest
import torch

from projectultra_tpu_torch.ops import (cuda_awgn, cuda_build,
                                        cuda_decimate, cuda_dpsk, cuda_ldpc,
                                        cuda_lts, cuda_sc, cuda_track)

torch.set_num_threads(2)

#: (wrapper, its source's name, the kernel's own compiler flags)
KERNELS = {
    "ldpc": (cuda_ldpc, "ldpc_minsum.cu", ("--fmad=false",)),
    "windows": (cuda_sc, "sc_windows.cu", ()),
    "dpsk": (cuda_dpsk, "dpsk_score.cu", ("--fmad=false",)),
    "decimate": (cuda_decimate, "chirp_decimate.cu", ()),
    "lts": (cuda_lts, "lts_timing.cu", ()),
    "track": (cuda_track, "pilot_track.cu", ()),
    "awgn": (cuda_awgn, "awgn_active.cu", ()),
}


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_compiler_command_targets_hopper(kernel, tmp_path):
    mod, source, flags = KERNELS[kernel]
    cmd = mod.LIBRARY.command("nvcc", tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert all(flag in cmd for flag in flags)
    assert ("--fmad=false" in cmd) == ("--fmad=false" in flags)
    assert "--use_fast_math" not in cmd
    assert mod.SOURCE == mod.LIBRARY.source == cuda_build.CSRC_DIR / source
    assert mod.SOURCE.is_file() and str(mod.SOURCE) in cmd
    assert mod.LIBRARY.prefix == mod.SOURCE.stem


def test_a_failed_entry_raises_with_the_library_message(monkeypatch):
    calls = []

    def entry(*args):
        calls.append(args)
        return 7

    fake = types.SimpleNamespace(
        sc_windows_launch=entry, sc_windows_plan=lambda *args: 0,
        sc_windows_error_string=lambda err: b"no blocks fit")
    monkeypatch.setattr(cuda_sc.LIBRARY, "_lib", fake)
    cuda_sc.LIBRARY.run("sc_windows_plan", 1, 2)
    with pytest.raises(RuntimeError, match=r"^sc_windows_launch failed: "
                       r"no blocks fit \(7\)$"):
        cuda_sc.LIBRARY.run("sc_windows_launch", 1, 2, 3)
    assert calls == [(1, 2, 3)]


@pytest.mark.parametrize("bad,match", [
    (lambda x: x.double(), r"float32"),
    (lambda x: x[0], r"\[B, 8\]"),
    (lambda x: x[:, :4], r"\[B, 8\]"),
    (lambda x: x.T.contiguous().T, "not contiguous"),
    (lambda x: x.reshape(-1)[1:9].reshape(1, 8), "16-byte aligned"),
    (lambda x: x, "CUDA"),
])
def test_check_tensor_names_what_is_wrong(bad, match):
    x = torch.zeros((3, 8))
    with pytest.raises(ValueError, match=match):
        cuda_build.check_tensor("llrs", bad(x), torch.float32, ("B", 8),
                                "aligned", None)


@pytest.mark.parametrize("bad,match", [
    (lambda x: x[:, ::2], "column stride"),
    (lambda x: x[:1].expand(3, 100), "overlap"),
    (lambda x: x, "expected meta"),
])
def test_check_tensor_row_layouts(bad, match):
    x = torch.zeros((3, 100))
    with pytest.raises(ValueError, match=match):
        cuda_build.check_tensor("samples", bad(x), torch.float32,
                                ("B", "T"), "disjoint rows",
                                torch.device("meta"))
    # a row stride above T and one column of any stride are disjoint rows
    wide = torch.zeros((3, 120))[:, 10:110]
    cuda_build.check_tensor("samples", wide, torch.float32, ("B", "T"),
                            "disjoint rows", torch.device("cpu"))
    column = torch.zeros((5, 3)).T[:, :1]
    cuda_build.check_tensor("samples", column, torch.float32, ("B", "T"),
                            "disjoint rows", torch.device("cpu"))
    with pytest.raises(ValueError, match="column stride"):
        cuda_build.check_tensor("samples", column, torch.float32,
                                ("B", "T"), "rows", torch.device("cpu"))


@pytest.mark.parametrize("kernel", ["windows", "dpsk"])
def test_one_column_needs_unit_stride(kernel):
    """The window and score kernels refuse a one-column view whose column
    stride is not 1, as the decimation and LTS kernels do not."""
    column = torch.zeros((5, 3), dtype=torch.complex64).T[:, :1]
    with pytest.raises(ValueError, match="column stride"):
        if kernel == "windows":
            cuda_sc.sc_windows_cuda(column, 2, 1, 0, 1)
        else:
            cuda_dpsk.dpsk_score_cuda(column, 1, cuda_dpsk.PAIRS + 1, 1,
                                      [1.0] * cuda_dpsk.PAIRS, 0.0)

"""Device and precision policy of the PyTorch port.

The JAX package runs every contraction at ``precision=HIGHEST``; the port
keeps float32 products in full float32 on the card.  PyTorch's matmul
default is already full float32, but cuDNN convolutions default to TF32,
so both switches are set explicitly when the package is imported.

Functions of the port run on the device of their input tensors.  Nothing
here picks a device: a caller that needs the card calls ``require_cuda``
(or ``resolve``, for an entry point's ``device=None``), which raises
instead of carrying on on the CPU.  ``host_table`` keeps one
copy per device of a constant table built on the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def pin_float32() -> None:
    """Full float32 for matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def require_cuda() -> torch.device:
    """The first CUDA device; raises RuntimeError when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def resolve(device) -> torch.device:
    """The device an entry point runs on: ``device`` as given, or the
    first CUDA device when it is None (``require_cuda``)."""
    return require_cuda() if device is None else torch.device(device)


@functools.lru_cache(maxsize=None)
def host_table(device: torch.device, fn, *args):
    """The numpy table ``fn(*args)`` (or each table of a tuple of them) as a
    tensor on ``device``, made once per device: a host-to-device copy on
    every call would synchronise the stream."""
    out = fn(*args)
    if isinstance(out, tuple):
        return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                     for x in out)
    return torch.from_numpy(np.ascontiguousarray(out)).to(device)

"""Device and precision policy of the PyTorch port.

The JAX package runs every contraction at ``precision=HIGHEST``; the port
keeps float32 products in full float32 on the card.  PyTorch's matmul
default is already full float32, but cuDNN convolutions default to TF32,
so both switches are set explicitly when the package is imported.

Functions of the port run on the device of their input tensors.  Nothing
here picks a device: a caller that needs the card calls ``require_cuda``,
which raises instead of carrying on on the CPU.
"""

from __future__ import annotations

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

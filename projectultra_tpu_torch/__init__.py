"""projectultra_tpu_torch — the PyTorch/CUDA port of the modem.

The port keeps the layout and names of the JAX package ``projectultra_tpu``
(``ops/ldpc.py``, ``ofdm/pipeline.py``, ...), which stays the reference it
is tested against.  Host-side numpy modules that never import jax
(``config``, ``fec.ldpc``, ``ofdm.carriers``, ``ofdm.constellations``,
``utils.mt19937``) are shared with the JAX package, not copied.  The port
never imports jax.

The LDPC min-sum decoder runs as a hand-written CUDA kernel for Hopper
(``csrc/ldpc_minsum.cu``) on CUDA tensors; the plain PyTorch versions beside
each kernel are test oracles and the CPU path.

The shared enums ``CodeRate`` and ``Modulation`` and the code table lookup
``get_code`` are re-exported here, so a caller of the port needs no import
of the JAX package.
"""

from projectultra_tpu.config import CodeRate, Modulation
from projectultra_tpu.fec.ldpc import get_code

from .device import pin_float32, require_cuda

pin_float32()

__all__ = ["CodeRate", "Modulation", "get_code", "pin_float32",
           "require_cuda"]
